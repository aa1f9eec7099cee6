"""Whole-map and box-scoped voxel transforms, on torch tensors.

Port of ``supereight_tpu/core/functor.py`` (25-62; behavioral reference:
se::functor::axis_aligned,
se_core/include/se/functors/axis_aligned_functor.hpp:118-131): apply a
function to every allocated voxel, and optionally every existing coarse
octant value, inside an axis-aligned box (the whole map by default). The
function takes (x, y, voxel_coords) and returns (x, y). As JAX's, it
evaluates the whole pool ([capacity, 512]) and every mip level and keeps
the masked entries.
"""

import torch

from supereight_tpu_torch.constants import BLOCK_SIDE, BLOCK_VOXELS
from supereight_tpu_torch.core.map import MapState


def _local(dev):
    lin = torch.arange(BLOCK_VOXELS, dtype=torch.int32, device=dev)
    return torch.stack([lin % 8, (lin // 8) % 8, lin // 64], -1)


def axis_aligned_map(geom, state: MapState, fn, bbox_min=None,
                     bbox_max=None, include_nodes=True) -> MapState:
    """Apply ``fn(x, y, vox_coords) -> (x, y)`` to all allocated voxels in
    the box [bbox_min, bbox_max) (the whole map by default) and, with
    ``include_nodes``, to the existing coarse octant values of every mip
    level whose origin lies in the box (the reference's node pass).
    Returns a new state; the input's tensors are left as they were."""
    dev = state.data_x.device
    lo = torch.as_tensor((0, 0, 0) if bbox_min is None else bbox_min,
                         dtype=torch.int32, device=dev)
    hi = torch.as_tensor((geom.size,) * 3 if bbox_max is None else bbox_max,
                         dtype=torch.int32, device=dev)
    slot_ids = torch.arange(geom.capacity, device=dev)[:, None]
    allocated = slot_ids < state.n_blocks               # [cap, 1]
    vox = state.block_coord[:, None, :] * BLOCK_SIDE + _local(dev)[None]
    mask = allocated & ((vox >= lo) & (vox < hi)).all(-1)
    nx, ny = fn(state.data_x, state.data_y, vox)
    state = state._replace(data_x=torch.where(mask, nx, state.data_x),
                           data_y=torch.where(mask, ny, state.data_y))
    if include_nodes:
        new_x, new_y = [], []
        for lvl in range(geom.num_levels):
            g = torch.arange(geom.blocks_per_side >> lvl, dtype=torch.int32,
                             device=dev)
            coords = torch.stack(torch.meshgrid(g, g, g, indexing="ij"),
                                 -1) * (BLOCK_SIDE << lvl)
            mask = state.mip_alloc[lvl] \
                & ((coords >= lo) & (coords < hi)).all(-1)
            nx, ny = fn(state.mip_x[lvl], state.mip_y[lvl], coords)
            new_x.append(torch.where(mask, nx, state.mip_x[lvl]))
            new_y.append(torch.where(mask, ny, state.mip_y[lvl]))
        state = state._replace(mip_x=tuple(new_x), mip_y=tuple(new_y))
    return state
