"""What the keyframe pose graph does to the closed loop: one BA run of the
CLI, then its graph replayed offline.

    python -m supereight_tpu_torch.tools.ba_loop [--frames 250] \\
        [--workdir DIR] [--graph-out GRAPH.npz]

Renders the closed loop as ``tools/longseq.py`` does (or reuses
``DIR/loop.raw``), runs the ``tsdf icp+BA`` row's CLI in this process on
the card, and reads its keyframe graph: the keyframes' as-tracked poses
and odometry weights, and each accepted loop closure's measured relative
pose and weight. It prints one JSON object a line:

- ``run``: the post-BA ATE the CLI printed, and the ATE of the as-tracked
  trajectory, which is the no-BA row's (the keyframe step leaves tracking
  alone unless re-anchoring is on);
- ``closure``: for each closure, how far its measured relative pose is
  from the ground truth's (m, degrees), and how far the as-tracked
  relative pose is: the loop's drift, which BA spreads over the window;
- ``replay``: the graph replayed offline through ``KeyframeManager`` on
  the CPU (``replay``), whose ATE must equal the run's;
- ``counterfactual``: the replay's ATE with the closure's measurement
  replaced by the ground truth's, and with its translation moved by 5-50
  mm along each axis of the revisited keyframe's camera.

``--graph-out`` writes the graph, the as-tracked and ground-truth
positions and the run's ATE to a ``.npz`` that ``replay`` reads back.
"""

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile

import numpy as np

from supereight_tpu_torch.config import build_parser, config_from_args
from supereight_tpu_torch.eval.ate import ate_statistics
from supereight_tpu_torch.io import dataset

SHIFTS_M = (0.005, 0.01, 0.02, 0.05)
AXES = ("x", "y", "z")


def graph_of(km, ba_every):
    """The keyframe graph of a live ``KeyframeManager`` as arrays. The
    replay needs every keyframe, so a window that trimmed is refused."""
    n = len(km.frames)
    if n >= km.window or any(km.frozen):
        raise SystemExit("the window trimmed: the replay needs every "
                         "keyframe")
    odo = {j: w for i, j, _, w in km.edges if j == i + 1}
    lc = [(i, j, t, w) for i, j, t, w in km.edges if j != i + 1]
    return dict(
        every=km.keyframe_every, window=km.window, ba_every=ba_every,
        kf_frames=np.asarray(km.frames, np.int64),
        kf_poses=np.stack(km.orig_poses).astype(np.float32),
        # the reduction's inlier count back from its weight, sqrt(count)
        kf_inliers=np.asarray([0.0] + [round(odo[j] ** 2)
                                       for j in range(1, n)], np.float32),
        closure_ij=np.asarray([(i, j) for i, j, _, _ in lc],
                              np.int64).reshape(-1, 2),
        closure_t=np.asarray([t for _, _, t, _ in lc],
                             np.float32).reshape(-1, 4, 4),
        closure_w=np.asarray([w for _, _, _, w in lc], np.float64))


def replay(g, manager):
    """Replay the graph ``g`` through ``manager`` (a fresh manager with
    ``KeyframeManager``'s interface, made with ``g``'s cadence and window)
    as the pipeline's keyframe step builds it: each keyframe with its
    as-tracked pose and inlier count, its loop closure, and an optimize
    after a closure or every ``ba_every`` keyframes. Returns
    ``manager``."""
    closures = {int(j): (int(i), t, float(w)) for (i, j), t, w in
                zip(g["closure_ij"], g["closure_t"], g["closure_w"])}
    red = np.zeros(32, np.float32)
    pending = False
    for k, (f, pose) in enumerate(zip(g["kf_frames"], g["kf_poses"])):
        red[28] = g["kf_inliers"][k]
        manager.maybe_add(int(f), pose, red)
        if k in closures:
            i, t, w = closures[k]
            manager.add_loop_closure(i, k, t, w)
            pending = True
        if pending or (len(manager.poses) % int(g["ba_every"]) == 0
                       and manager.edges):
            manager.optimize()
            pending = False
    return manager


def corrected(manager, frames, xyz):
    """The final trajectory's positions, as the CLI makes it: each frame's
    as-tracked position under its nearest keyframe's BA correction."""
    corr = manager.frame_corrections()
    kf = np.asarray([c[0] for c in corr])
    out = np.empty_like(xyz)
    for n, (f, p) in enumerate(zip(frames, xyz)):
        c = corr[int(np.argmin(np.abs(kf - f)))][1].astype(np.float64)
        out[n] = c[:3, :3] @ p + c[:3, 3]
    return out


def _rmse(gt_xyz, xyz):
    return ate_statistics(gt_xyz, xyz)["rmse"]


def _relative_error(a, b):
    """Translation (m) and rotation (degrees) between two poses."""
    d = np.linalg.inv(a.astype(np.float64)) @ b.astype(np.float64)
    cos = np.clip((np.trace(d[:3, :3]) - 1) / 2, -1.0, 1.0)
    return float(np.linalg.norm(d[:3, 3])), float(np.degrees(np.arccos(cos)))


def analyse(g, frames, xyz, gt_poses, make_manager, shifts=SHIFTS_M):
    """The ``closure``, ``replay`` and ``counterfactual`` reports of the
    graph ``g`` over the as-tracked positions ``xyz`` of ``frames``
    against the ground truth ``gt_poses`` (4x4 a frame, in the CLI's
    world frame); ``make_manager(g)`` makes a fresh manager, and each
    closure's translation is moved by each of ``shifts`` (m)."""
    gt_xyz = np.asarray([gt_poses[f][:3, 3] for f in frames], np.float64)
    kf_frames, kf_poses = g["kf_frames"], g["kf_poses"]

    def ate(graph):
        return _rmse(gt_xyz, corrected(replay(graph, make_manager(graph)),
                                       frames, xyz))

    closures, counterfactual = [], []
    for c, ((i, j), t) in enumerate(zip(g["closure_ij"], g["closure_t"])):
        fi, fj = int(kf_frames[i]), int(kf_frames[j])
        truth = np.linalg.inv(gt_poses[fi].astype(np.float64)) \
            @ gt_poses[fj].astype(np.float64)
        tracked = np.linalg.inv(kf_poses[i].astype(np.float64)) \
            @ kf_poses[j].astype(np.float64)
        m_t, m_r = _relative_error(truth, t)
        d_t, d_r = _relative_error(truth, tracked)
        closures.append(dict(
            keyframes=[int(i), int(j)], frames=[fi, fj],
            weight=float(g["closure_w"][c]),
            measured_err_m=m_t, measured_err_deg=m_r,
            drift_err_m=d_t, drift_err_deg=d_r))
        ideal = dict(g, closure_t=g["closure_t"].copy())
        ideal["closure_t"][c] = truth.astype(np.float32)
        row = dict(closure=c, ideal_ate=ate(ideal), shifted={})
        for axis, name in enumerate(AXES):
            for sign in (1, -1):
                for s in shifts:
                    moved = dict(g, closure_t=g["closure_t"].copy())
                    moved["closure_t"][c, axis, 3] += sign * s
                    row["shifted"][f"{'+' if sign > 0 else '-'}{name} "
                                   f"{s * 1e3:g} mm"] = ate(moved)
        counterfactual.append(row)
    return dict(closure=closures, replay=dict(ate=ate(g)),
                counterfactual=counterfactual)


def cpu_manager(g):
    """A fresh port ``KeyframeManager`` on the CPU with ``g``'s cadence
    and window."""
    from supereight_tpu_torch.posegraph.keyframes import KeyframeManager
    return KeyframeManager(window=int(g["window"]),
                           keyframe_every=int(g["every"]), device="cpu")


def run_cli(argv):
    """The CLI in this process; returns the pipeline, the frames and
    their as-tracked positions (the frame log's), the ground truth (4x4 a
    frame, in the CLI's world frame, as ``cli.run`` makes it) and the ATE
    the CLI printed. ``argv`` must name ``-i``, ``-g`` and ``-o``."""
    from supereight_tpu_torch import cli
    from supereight_tpu_torch.eval.sweep import parse_frame_log
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        pipe = cli.run(argv)
    ate = next(float(line.split("ATE RMSE")[1].split()[0])
               for line in err.getvalue().splitlines() if "ATE RMSE" in line)
    cfg = config_from_args(build_parser().parse_known_args(argv)[0])
    poses = dataset.RawDepthReader(cfg.input_file,
                                   cfg.groundtruth_file).poses
    t = dataset.first_pose_transform(
        poses[0], np.asarray(cfg.initial_pos_factor) * cfg.volume_size)
    rows = parse_frame_log(cfg.log_file)
    frames = np.asarray([r["frame"] for r in rows], np.int64)
    xyz = np.asarray([(r["X"], r["Y"], r["Z"]) for r in rows], np.float64)
    return pipe, frames, xyz, [t @ p for p in poses], ate


def main(argv=None):
    from supereight_tpu_torch.io.convert import synthetic2raw
    from supereight_tpu_torch.tools.longseq import BASE_ARGS, VARIANTS
    ap = argparse.ArgumentParser(prog="supereight-tpu-torch-ba-loop")
    ap.add_argument("--frames", type=int, default=250)
    ap.add_argument("--workdir", default="")
    ap.add_argument("--graph-out", default="")
    args = ap.parse_args(argv)
    wd = args.workdir or tempfile.mkdtemp(prefix="ba_loop_")
    os.makedirs(wd, exist_ok=True)
    raw = os.path.join(wd, "loop.raw")
    if not os.path.exists(raw):
        synthetic2raw(raw, args.frames, scene="loop",
                      workers=os.cpu_count() or 1)
    row = dict(VARIANTS)["tsdf icp+BA"]
    cli_argv = ["-i", raw, "-g", raw + ".gt.txt", "-o",
                os.path.join(wd, "ba.log"), *BASE_ARGS, "--max-frames",
                str(args.frames), *row]
    pipe, frames, xyz, gt, ate = run_cli(cli_argv)
    g = graph_of(pipe.keyframes, pipe._ba_every)
    gt_xyz = np.asarray([gt[f][:3, 3] for f in frames], np.float64)
    report = analyse(g, frames, xyz, gt, cpu_manager)
    print(json.dumps(dict(run=dict(
        ate=ate, as_tracked_ate=_rmse(gt_xyz, xyz), args=list(row),
        keyframes=[int(f) for f in g["kf_frames"]]))))
    for key in ("closure", "replay", "counterfactual"):
        print(json.dumps({key: report[key]}))
    if args.graph_out:
        np.savez_compressed(
            args.graph_out, frames=frames, xyz=xyz, run_ate=ate,
            gt_poses=np.stack(gt).astype(np.float32), **g)
    return 0


if __name__ == "__main__":
    sys.exit(main())
