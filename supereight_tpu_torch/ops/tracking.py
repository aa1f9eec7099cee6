"""Projective-ICP camera tracking (ref se_denseslam/src/tracking.cpp).

Port of ``supereight_tpu/ops/tracking.py:track``. The whole coarse-to-fine
Gauss-Newton of a frame (residuals, reduction, 6x6 solve, SE(3) update,
the per-level early break once ||x|| < threshold, and the divergence
rollback) is kernel K6's ``icp_track`` (``kernels/icp.py``), one launch a
frame on a CUDA device; CPU tensors take its plain twin, which runs the
full trip counts with the freeze applied by ``torch.where``. Either way no
value is read back to the host. Its ``view`` comes from the frame's pose
prologue (``kernels/frame.py``) of the raycast pose.

With a process group (the sharded step, ``parallel/dist_step.py``) each
rank takes its column slice of every level against the full reference
maps, and each Gauss-Newton iteration is K6's ``icp_reduce`` over the
slice (f64 sums), one ``all_reduce`` of the 32 f64 sums, and K6's
``icp_update`` (the sum rounded once to f32, the solve, the update and the
freeze), at the full trip counts: JAX's ``axis_name`` mode
(``ops/tracking.py:241-327``), which skips the early exit so that every
device issues the same collectives.
"""

from typing import Sequence

from supereight_tpu_torch.constants import DIST_THRESHOLD
from supereight_tpu_torch.kernels.frame import frame_mats
from supereight_tpu_torch.kernels.icp import (icp_reduce64, icp_track,
                                              icp_update)


def track(pose, raycast_pose, k_full, pyr_vertex, pyr_normal, pyr_valid,
          ref_vertex, ref_normal, ref_valid, iterations: Sequence[int],
          icp_threshold, dist_threshold=DIST_THRESHOLD, group=None):
    """Full coarse-to-fine ICP (DenseSLAMSystem::tracking, 143-189).

    pyr_*: tuples of per-level maps, finest first. Returns
    (new_pose, tracked, final_reduction, result_map_finest).

    ``group`` (a :class:`parallel.distributed.Collectives`) runs the
    sharded mode: this rank's columns of each level (its width divided by
    the world size; the caller checks that it divides), the reduction
    summed over the ranks; its result map is None (the sharded step
    reports none).
    """
    view = frame_mats(k_full, raycast_pose).view  # K @ raycast_pose^-1
    if group is not None:
        return _track_sharded(pose, view, pyr_vertex, pyr_normal, pyr_valid,
                              ref_vertex, ref_normal, ref_valid, iterations,
                              icp_threshold, dist_threshold, group)
    return icp_track(pose, view, pyr_vertex, pyr_normal, pyr_valid,
                     ref_vertex, ref_normal, ref_valid, iterations,
                     icp_threshold, dist_threshold=dist_threshold)


def _track_sharded(pose, view, pyr_vertex, pyr_normal, pyr_valid,
                   ref_vertex, ref_normal, ref_valid, iterations,
                   icp_threshold, dist_threshold, group):
    """:func:`track` over a process group: every rank runs the same
    iterations and collectives, whatever its data."""
    if min(iterations) < 1:
        raise ValueError("sharded tracking runs at least one iteration a "
                         "level")
    d, r = group.world, group.rank
    carry = None
    for level in range(len(iterations) - 1, -1, -1):
        w_loc = pyr_vertex[level].shape[1] // d
        for it in range(iterations[level]):
            _, red64 = icp_reduce64(
                pyr_vertex[level], pyr_normal[level], pyr_valid[level],
                ref_vertex, ref_normal, ref_valid,
                pose if carry is None else carry.pose, view, dist_threshold,
                x0=r * w_loc, width=w_loc)
            group.all_reduce_sum(red64)
            last = level == 0 and it == iterations[0] - 1
            new, checked = icp_update(
                red64, pose if carry is None else carry.pose, carry,
                first_of_level=it == 0, icp_threshold=icp_threshold,
                old_pose=pose if last else None,
                image_size=tuple(ref_vertex.shape[:2]))
            carry = new
    new_pose, tracked = checked
    return new_pose, tracked, carry.reduction, None
