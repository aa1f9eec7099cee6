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
maps, and each Gauss-Newton iteration is one launch of K6's
``icp_reduce`` over the slice (f64 sums into the tensor the ranks
all-reduce), with the previous iteration's update (the sum rounded once
to f32, the solve, the update and the freeze) folded in front of it
(``icp_reduce_step``), and one ``all_reduce`` of the 32 f64 sums; the
frame's last update, with ``check_pose``, is K6's ``icp_update``. It runs
the full trip counts, JAX's ``axis_name`` mode
(``ops/tracking.py:241-327``), which skips the early exit so that every
device issues the same collectives; an iteration of a converged level
skips its pixel pass (its sums are never read).
"""

from typing import Sequence

import torch

from supereight_tpu_torch.constants import DIST_THRESHOLD
from supereight_tpu_torch.kernels.frame import frame_mats
from supereight_tpu_torch.kernels.icp import (Carry, icp_reduce64,
                                              icp_reduce_step, icp_track,
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
    dev = pose.device
    # (level, first of its level) of each iteration, coarsest level first
    sched = [(lvl, it == 0) for lvl in range(len(iterations) - 1, -1, -1)
             for it in range(iterations[lvl])]
    # each iteration's sums and carry, alternating between two buffers:
    # a launch reads the one the launch before it wrote
    sums = torch.empty((2, 32), dtype=torch.float64, device=dev).unbind(0)
    carries = [Carry(*c) for c in zip(
        torch.empty((2, 4, 4), dtype=torch.float32, device=dev).unbind(0),
        torch.empty((2, 32), dtype=torch.float32, device=dev).unbind(0),
        torch.empty(2, dtype=torch.bool, device=dev).unbind(0))]
    carry = None
    for i, (level, first) in enumerate(sched):
        lvl = (pyr_vertex[level], pyr_normal[level], pyr_valid[level])
        w_loc = lvl[0].shape[1] // d
        win = dict(x0=r * w_loc, width=w_loc, out=sums[i % 2])
        if i == 0:
            icp_reduce64(*lvl, ref_vertex, ref_normal, ref_valid, pose, view,
                         dist_threshold, with_result=False, **win)
        else:
            carry, _ = icp_reduce_step(
                sums[1 - i % 2], pose if carry is None else carry.pose,
                carry, sched[i - 1][1], first, icp_threshold, *lvl,
                ref_vertex, ref_normal, ref_valid, view, dist_threshold,
                carry_out=carries[i % 2], **win)
        group.all_reduce_sum(sums[i % 2])
    carry, (new_pose, tracked) = icp_update(
        sums[(len(sched) - 1) % 2], pose if carry is None else carry.pose,
        carry, first_of_level=sched[-1][1], icp_threshold=icp_threshold,
        old_pose=pose, image_size=tuple(ref_vertex.shape[:2]))
    return new_pose, tracked, carry.reduction, None
