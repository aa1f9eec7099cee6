"""Metric-space volume facade, on torch tensors.

Port of ``supereight_tpu/core/volume.py`` (behavioral reference:
VolumeTemplate, se_denseslam/include/se/continuous/volume_template.hpp:
49-115): scales between meters and voxel coordinates for get, interp and
grad, so that callers never touch discrete indices.
"""

import dataclasses

import torch

from supereight_tpu_torch.core import interp as interp_mod
from supereight_tpu_torch.core import map as m
from supereight_tpu_torch.fields.base import FieldSpec


@dataclasses.dataclass
class Volume:
    """Continuous view over (geom, state, field)."""
    geom: m.MapGeometry
    state: m.MapState
    field: FieldSpec

    @property
    def size(self) -> int:
        return self.geom.size

    @property
    def dim(self) -> float:
        return self.geom.dim

    def _metric(self, pos_m):
        return torch.as_tensor(pos_m, dtype=torch.float32,
                               device=self.state.data_x.device)

    def pos(self, voxel):
        """Voxel coords -> metric position (ref volume_template.hpp:63-66)."""
        return self._metric(voxel) * self.geom.voxel_size

    def get(self, pos_m):
        """Nearest-voxel fetch at metric positions [..., 3] (ref get ->
        get_fine, volume_template.hpp:76-83); the voxel index truncates
        toward zero, as JAX's ``astype(int32)``."""
        v = (self._metric(pos_m) * self.geom.inv_voxel_size).to(torch.int32)
        return m.get_voxel(self.geom, self.state, self.field, v)

    def interp(self, pos_m, channel=0):
        """Trilinear sample at metric positions (ref :88-93)."""
        p = self._metric(pos_m) * self.geom.inv_voxel_size
        return interp_mod.interp(self.geom, self.state, self.field, p,
                                 channel)

    def grad(self, pos_m, channel=0):
        """Field gradient at metric positions (ref :95-101)."""
        p = self._metric(pos_m) * self.geom.inv_voxel_size
        return interp_mod.grad(self.geom, self.state, self.field, p,
                               channel)
