"""Field-type descriptor (the JAX package's ``fields/base.py``).

Voxel payload is two f32 channels (x, y):
  TSDF:    x = signed distance in [-1, 1],  y = fusion weight
  OFusion: x = log-odds occupancy in [-1000, 1000], y = last update time
"""

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Static description of a voxel field type."""

    name: str
    # Value a freshly allocated voxel holds (ref initValue()).
    init: Tuple[float, float]
    # Value reported for *unallocated* space by stencil gathers (ref empty()).
    empty: Tuple[float, float]
    # Whether integration marches the full camera->surface ray and fuses at
    # multiple octree scales (OFusion) or only a band around the surface (TSDF).
    multiscale_alloc: bool
    # Whether raycast surface normals point opposite the field gradient.
    invert_normals: bool
