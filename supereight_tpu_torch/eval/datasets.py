"""Dataset registry for evaluation sweeps (a copy of
``supereight_tpu/eval/datasets.py``).

Behavioral reference: se_apps/scripts/datasets.py — per-sequence camera
intrinsics, initial-pose factors, and ground-truth paths for the ICL-NUIM
and TUM RGB-D sequences the reference sweeps (run_kf.py:33-50).
Paths are resolved relative to a datasets root directory.
"""

import dataclasses
import os
from typing import Tuple


@dataclasses.dataclass
class Dataset:
    name: str
    raw: str                      # .raw file relative to the root
    groundtruth: str              # TUM-format trajectory
    camera: Tuple[float, float, float, float]
    init_pose_factor: Tuple[float, float, float] = (0.5, 0.5, 0.0)
    volume_size: float = 4.8
    volume_resolution: int = 512
    descr: str = ""

    def resolve(self, root):
        return (os.path.join(root, self.raw),
                os.path.join(root, self.groundtruth))


ICL_K = (481.2, -480.0, 320.0, 240.0)
TUM_FR1_K = (517.3, 516.5, 318.6, 255.3)
TUM_FR2_K = (520.9, 521.0, 325.1, 249.7)
TUM_FR3_K = (535.4, 539.2, 320.1, 247.6)

DATASETS = {
    f"icl-traj{i}": Dataset(
        name=f"icl-traj{i}",
        raw=f"living_room_traj{i}_loop.raw",
        groundtruth=f"livingRoom{i}.gt.freiburg",
        camera=ICL_K,
        init_pose_factor=(0.34, 0.5, 0.24),
        descr=f"ICL-NUIM living room trajectory {i}")
    for i in range(4)
}
DATASETS.update({
    "tum-fr1-desk": Dataset(
        name="tum-fr1-desk", raw="rgbd_dataset_freiburg1_desk.raw",
        groundtruth="rgbd_dataset_freiburg1_desk-groundtruth.txt",
        camera=TUM_FR1_K, descr="TUM fr1/desk"),
    "tum-fr2-desk": Dataset(
        name="tum-fr2-desk", raw="rgbd_dataset_freiburg2_desk.raw",
        groundtruth="rgbd_dataset_freiburg2_desk-groundtruth.txt",
        camera=TUM_FR2_K, descr="TUM fr2/desk"),
    "tum-fr3-desk": Dataset(
        name="tum-fr3-desk",
        raw="rgbd_dataset_freiburg3_long_office_household.raw",
        groundtruth="rgbd_dataset_freiburg3_long_office_household-"
                    "groundtruth.txt",
        camera=TUM_FR3_K, descr="TUM fr3/long office"),
})
