"""Relative pose error (RPE) (a copy of ``supereight_tpu/eval/rpe.py``).

Python-3 re-implementation of the reference's evaluate_rpe.py (the TUM
RGB-D benchmark tool): error of the relative motion over a fixed frame
delta, translational and rotational parts.
"""

import numpy as np


def _to_matrix(xyz, quat):
    """(xyz, qx qy qz qw) -> 4x4."""
    x, y, z, w = quat
    n = x * x + y * y + z * z + w * w
    s = 0.0 if n == 0 else 2.0 / n
    R = np.array([
        [1 - s * (y * y + z * z), s * (x * y - w * z), s * (x * z + w * y)],
        [s * (x * y + w * z), 1 - s * (x * x + z * z), s * (y * z - w * x)],
        [s * (x * z - w * y), s * (y * z + w * x), 1 - s * (x * x + y * y)],
    ])
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = xyz
    return T


def trajectory_matrices(xyz, quat):
    return [_to_matrix(p, q) for p, q in zip(xyz, quat)]


def rpe_statistics(gt_mats, est_mats, delta=1):
    """RPE over frame-index delta (ref evaluate_rpe.py with --fixed_delta).

    Returns dict of translational and rotational error stats.
    """
    n = min(len(gt_mats), len(est_mats))
    terrs, rerrs = [], []
    for i in range(n - delta):
        gt_rel = np.linalg.inv(gt_mats[i]) @ gt_mats[i + delta]
        est_rel = np.linalg.inv(est_mats[i]) @ est_mats[i + delta]
        err = np.linalg.inv(gt_rel) @ est_rel
        terrs.append(np.linalg.norm(err[:3, 3]))
        angle = np.arccos(np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1))
        rerrs.append(angle)
    terrs = np.asarray(terrs)
    rerrs = np.asarray(rerrs)
    return {
        "trans_rmse": float(np.sqrt(np.mean(terrs ** 2))),
        "trans_mean": float(np.mean(terrs)),
        "trans_median": float(np.median(terrs)),
        "trans_max": float(np.max(terrs)),
        "rot_rmse_deg": float(np.degrees(np.sqrt(np.mean(rerrs ** 2)))),
        "rot_mean_deg": float(np.degrees(np.mean(rerrs))),
        "pairs": int(terrs.size),
    }
