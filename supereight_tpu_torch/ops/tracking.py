"""Projective-ICP camera tracking (ref se_denseslam/src/tracking.cpp).

Port of ``supereight_tpu/ops/tracking.py:track``. The whole coarse-to-fine
Gauss-Newton of a frame (residuals, reduction, 6x6 solve, SE(3) update,
the per-level early break once ||x|| < threshold, and the divergence
rollback) is kernel K6's ``icp_track`` (``kernels/icp.py``), one launch a
frame on a CUDA device; CPU tensors take its plain twin, which runs the
full trip counts with the freeze applied by ``torch.where``. Either way no
value is read back to the host. Its ``view`` comes from the frame's pose
prologue (``kernels/frame.py``) of the raycast pose.
"""

from typing import Sequence

from supereight_tpu_torch.constants import DIST_THRESHOLD
from supereight_tpu_torch.kernels.frame import frame_mats
from supereight_tpu_torch.kernels.icp import icp_track


def track(pose, raycast_pose, k_full, pyr_vertex, pyr_normal, pyr_valid,
          ref_vertex, ref_normal, ref_valid, iterations: Sequence[int],
          icp_threshold, dist_threshold=DIST_THRESHOLD):
    """Full coarse-to-fine ICP (DenseSLAMSystem::tracking, 143-189).

    pyr_*: tuples of per-level maps, finest first. Returns
    (new_pose, tracked, final_reduction, result_map_finest).
    """
    view = frame_mats(k_full, raycast_pose).view  # K @ raycast_pose^-1
    return icp_track(pose, view, pyr_vertex, pyr_normal, pyr_valid,
                     ref_vertex, ref_normal, ref_valid, iterations,
                     icp_threshold, dist_threshold=dist_threshold)
