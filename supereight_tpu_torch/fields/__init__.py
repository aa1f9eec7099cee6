"""Field-type registry: TSDF and OFusion."""

from supereight_tpu_torch.fields.base import FieldSpec  # noqa: F401
from supereight_tpu_torch.fields.ofusion import OFUSION  # noqa: F401
from supereight_tpu_torch.fields.tsdf import TSDF  # noqa: F401


def get_field(name: str) -> FieldSpec:
    name = name.lower()
    if name in ("tsdf", "sdf"):
        return TSDF
    if name in ("ofusion", "occupancy"):
        return OFUSION
    raise ValueError(f"unknown field type {name!r}; expected 'tsdf' or "
                     "'ofusion'")
