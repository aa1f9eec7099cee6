"""Voxel-block allocation from depth frames, both fields.

Port of ``supereight_tpu/ops/allocation.py:allocate_tsdf`` (217-230) and
``allocate_ofusion`` (233-246), as two launches of kernel K5
(``kernels/alloc.py``): the march (one thread per sub-sampled pixel ray
writing touched-octant grids), then ``alloc_assign``, which turns the
level-0 grid into pool slots and ORs the new blocks and OFusion's level-1
and level-2 octants into the mip pyramid. The march writes into the map's
touched buffer (``MapState.touched``) and ``alloc_assign`` clears it as it
reads, so the buffer is all zero between frames and the step allocates
and fills nothing. The march's ``pose @ invK`` is the frame's pose
prologue's (``kernels/frame.py``).
"""

from supereight_tpu_torch.kernels.alloc import (alloc_assign, touched_mask,
                                                touched_masks_of)
from supereight_tpu_torch.kernels.frame import frame_mats


def allocate_tsdf(geom, state, depth, pose, k, mu: float,
                  with_stats: bool = False, when=None, budget: int = None,
                  mats=None):
    """Full TSDF allocation step: band march -> block pool update (in
    place). ``when`` (optional bool[] tensor) masks the whole step: with
    it False the touched set is empty and the pool is unchanged. ``mats``
    is the frame's pose prologue of ``pose`` and ``k``
    (kernels/frame.frame_mats), run here when not given."""
    if mats is None:
        mats = frame_mats(k, pose)
    touched = touched_mask(geom, depth, pose, mats.kpose, mu,
                           out=state.touched)
    overflow = alloc_assign(geom, state, touched, when, budget)
    return (state, {"alloc_overflow": overflow}) if with_stats else state


def allocate_ofusion(geom, state, depth, pose, k, mu: float,
                     with_stats: bool = False, when=None,
                     budget: int = None, mats=None):
    """Full occupancy allocation step (in place): multi-scale march ->
    block pool update, with the coarse octants touched at levels 1 and 2
    ORed into the mip pyramid. ``when`` masks every grid; ``mats`` as for
    :func:`allocate_tsdf`."""
    if mats is None:
        mats = frame_mats(k, pose)
    masks = touched_masks_of(geom, depth, pose, mats.kpose, mu,
                             out=state.touched)
    overflow = alloc_assign(geom, state, masks[0], when, budget, masks[1:])
    return (state, {"alloc_overflow": overflow}) if with_stats else state
