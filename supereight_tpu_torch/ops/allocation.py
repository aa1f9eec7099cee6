"""Voxel-block allocation from depth frames, both fields.

Port of ``supereight_tpu/ops/allocation.py:allocate_tsdf`` (217-230) and
``allocate_ofusion`` (233-246). The marches are kernel K5
(``kernels/alloc.py``: one thread per sub-sampled pixel ray writing
touched-octant grids) and ``core/map.allocate_blocks`` turns the level-0
grid into pool slots with a cumsum; OFusion's level-1 and level-2 grids
become coarse octants through ``core/map.refresh_mip_alloc``.
"""

from supereight_tpu_torch.core import map as m
from supereight_tpu_torch.kernels.alloc import touched_mask, touched_masks_of


def allocate_tsdf(geom, state, depth, pose, k, mu: float,
                  with_stats: bool = False, when=None, budget: int = None):
    """Full TSDF allocation step: band march -> block pool update (in
    place). ``when`` (optional bool[] tensor) masks the whole step: with
    it False the touched set is empty and the pool is unchanged."""
    touched = touched_mask(geom, depth, pose, k, mu)
    if when is not None:
        touched = touched & when
    return m.allocate_blocks(geom, state, touched, with_stats=with_stats,
                             budget=budget)


def allocate_ofusion(geom, state, depth, pose, k, mu: float,
                     with_stats: bool = False, when=None,
                     budget: int = None):
    """Full occupancy allocation step (in place): multi-scale march ->
    block pool update, then the coarse octants touched at levels 1 and 2
    are ORed into the mip pyramid. ``when`` masks every grid."""
    masks = touched_masks_of(geom, depth, pose, k, mu)
    if when is not None:
        masks = tuple(t & when for t in masks)
    extra = [None] * geom.num_levels
    for lvl in (1, 2):
        if lvl < geom.num_levels:
            extra[lvl] = masks[lvl]
    out = m.allocate_blocks(geom, state, masks[0], with_stats=with_stats,
                            budget=budget)
    state, stats = out if with_stats else (out, None)
    m.refresh_mip_alloc(geom, state, state.slot >= 0, extra_levels=extra)
    return (state, stats) if with_stats else state
