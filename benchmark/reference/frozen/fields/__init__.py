"""Field-type registry: TSDF and OFusion."""

from benchmark.reference.frozen.fields.base import FieldSpec  # noqa: F401
from benchmark.reference.frozen.fields.ofusion import OFUSION  # noqa: F401
from benchmark.reference.frozen.fields.tsdf import TSDF  # noqa: F401


def get_field(name: str) -> FieldSpec:
    name = name.lower()
    if name in ("tsdf", "sdf"):
        return TSDF
    if name in ("ofusion", "occupancy"):
        return OFUSION
    raise ValueError(f"unknown field type {name!r}; expected 'tsdf' or "
                     "'ofusion'")
