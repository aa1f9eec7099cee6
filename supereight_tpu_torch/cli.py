"""Headless benchmark front-end of the PyTorch port.

Port of ``supereight_tpu/cli.py`` (behavioral reference:
se_apps/src/benchmark.cpp, a frame loop with the tab-separated per-stage
timing log of benchmark.cpp:110-177, plus trajectory output for ATE). It
drives :class:`~supereight_tpu_torch.pipeline.DenseSLAMSystem` stage by
stage as JAX's CLI does, on the card unless ``--platform cpu`` asks for
the CPU. With stage syncs on (the default) each stage ends with
``torch.cuda.synchronize()``, so the log's stage columns are device time;
``--no-stage-sync`` leaves only the frame's one read of the pose and the
drop counters. ``--keyframe-rate`` turns on the keyframe pose graph with
loop closure and windowed BA, and the trajectory written and scored at
the end is the post-BA one. ``--serve PORT`` serves the live view
(``webviewer.LiveViewer`` on the loopback interface: the 2x2 composite as
an MJPEG stream, the frame's stats, and pause, resume, reset and the
static view as controls the frame loop polls); it needs Pillow.
``--plot-out`` draws the run's stage times, fps and trajectory into a
PNG (``plots.plot_run``) every rendered frame and at exit; it needs
matplotlib. A flag whose package does not import exits before the
pipeline is built, naming the package.

Usage:
  python -m supereight_tpu_torch.cli -i seq.raw -g seq.raw.gt.txt -s 4.8 ...
  python -m supereight_tpu_torch.cli --synthetic 64   # no dataset needed
"""

import importlib
import os
import sys
import time

import numpy as np
import torch

from supereight_tpu_torch import plots, viewer
from supereight_tpu_torch.config import (build_parser, config_from_args,
                                         device_from_platform)
from supereight_tpu_torch.eval.ate import ate_statistics
from supereight_tpu_torch.io import dataset, synthetic
from supereight_tpu_torch.io.serialise import save_map
from supereight_tpu_torch.pipeline import DenseSLAMSystem
from supereight_tpu_torch.utils.perfstats import PerfStats, StatType

LOG_HEADER = ("frame\tacquisition\tpreprocessing\ttracking\tintegration\t"
              "raycasting\trendering\tcomputation\ttotal\tX\tY\tZ\t"
              "tracked\tintegrated")


def require_package(module: str, package: str, flag: str):
    """Exit naming ``package`` when ``module``, which ``flag`` needs, does
    not import."""
    try:
        importlib.import_module(module)
    except ImportError:
        raise SystemExit(f"{flag} needs {package} ({module}), which does "
                         "not import here") from None


def served_stats(pipe, frame: int, tracked: bool) -> dict:
    """The live view's stats of a frame: the block count and the drop
    counters in one read from the device."""
    names = list(pipe.stats)
    host = torch.stack([t.reshape(()).to(torch.float64) for t in
                        [pipe.map.n_blocks] + [pipe.stats[n] for n in names]
                        ]).tolist()
    return {"frame": frame, "tracked": int(tracked), "blocks": int(host[0]),
            **dict(zip(names, host[1:]))}


def rotation_to_quaternion(R):
    """Shepperd's method: stable for every trace sign."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] >= R[1, 1] and R[0, 0] >= R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] >= R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return x, y, z, w


def run(argv=None):
    """Run the CLI on ``argv`` (default: the process's arguments) and
    return the :class:`DenseSLAMSystem` as the last frame left it."""
    parser = build_parser()
    parser.add_argument("--synthetic", type=int, default=0,
                        help="run N synthetic frames instead of a dataset")
    parser.add_argument("--trajectory-out", type=str, default="",
                        help="write estimated trajectory (TUM format)")
    parser.add_argument("--groundtruth-mode", action="store_true",
                        help="bypass tracking, use ground-truth poses")
    parser.add_argument("--plot-out", type=str, default="",
                        help="write live perf/trajectory plots to this "
                             "PNG, refreshed every rendering_rate frames "
                             "(headless equivalent of the reference Qt "
                             "GUI stat plots, QtGUI.cpp:201-313; needs "
                             "matplotlib)")
    parser.add_argument("--dump-renders", type=str, default="",
                        help="directory for 2x2 composite snapshots at "
                             "every render (viewer.composite_views' "
                             "layout)")
    parser.add_argument("--no-stage-sync", action="store_true",
                        help="skip the per-stage device syncs: the stage "
                             "log columns then show enqueue time, "
                             "`computation`/`total` and ATE stay correct")
    parser.add_argument("--serve", type=int, default=0, metavar="PORT",
                        help="serve a live interactive view on this HTTP "
                             "port of the loopback interface: MJPEG "
                             "stream of the 2x2 composite + pause/resume/"
                             "reset/view-toggle controls (the equivalent "
                             "of the reference Qt GUI, QtGUI.cpp:84-258 / "
                             "mainQt.cpp:201-313; needs Pillow)")
    parser.add_argument("--keyframe-rate", type=int, default=0,
                        help="enable windowed pose-graph BA: a keyframe "
                             "every N frames (0 = off)")
    parser.add_argument("--ba-window", type=int, default=32)
    parser.add_argument("--ba-every", type=int, default=4,
                        help="optimize the window every N keyframes")
    args = parser.parse_args(argv)
    if args.serve:
        require_package("PIL", "Pillow", "--serve")
    if args.plot_out:
        require_package("matplotlib", "matplotlib", "--plot-out")
    device = torch.device(device_from_platform(args.platform))
    cfg = config_from_args(args)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    gt_poses = None
    if args.synthetic:
        k = (120.0, 120.0, 80.0, 60.0)
        w, h = 160, 120
        cfg.camera = cfg.camera or k
        room = ((0.15, 0.15, 0.15),
                (cfg.volume_size - 0.15,) * 3)
        center = (cfg.volume_size / 2,) * 3
        # keep the sphere beyond the near plane and the walls inside far
        depths, gt_poses = synthetic.orbit_sequence(
            args.synthetic, cfg.camera, width=w, height=h,
            radius=0.4 * cfg.volume_size,
            center=center, sphere_radius=0.15 * cfg.volume_size,
            angle_span=0.6, room=room)
        frames = [(d, None) for d in depths]
        reader = None
        is_mm = False
        input_size = (w, h)
        init_pose = gt_poses[0]
    else:
        if not cfg.input_file:
            parser.error("need -i/--input-file or --synthetic N")
        reader = dataset.RawDepthReader(cfg.input_file,
                                        cfg.groundtruth_file)
        input_size = (reader.width, reader.height)
        cfg.camera = cfg.camera or reader.get_k()
        frames = None
        is_mm = True
        init_pose = None
        if reader.poses is not None:
            t = dataset.first_pose_transform(
                reader.poses[0],
                np.asarray(cfg.initial_pos_factor) * cfg.volume_size)
            gt_poses = [t @ p for p in reader.poses]
            init_pose = gt_poses[0]

    def new_pipeline():
        pipe = DenseSLAMSystem(input_size, cfg, init_pose=init_pose,
                               device=device)
        if args.keyframe_rate:
            pipe.enable_keyframes(every=args.keyframe_rate,
                                  window=args.ba_window,
                                  ba_every=args.ba_every)
        return pipe

    pipe = new_pipeline()
    live = None
    if args.serve:
        from supereight_tpu_torch.webviewer import LiveViewer
        live = LiveViewer(args.serve)
        port = live.start()
        print(f"# live view: http://localhost:{port}/", file=sys.stderr)
    try:
        static_view_pose = None
        stats = PerfStats()
        out = sys.stdout
        log = open(cfg.log_file, "w") if cfg.log_file else out
        print(LOG_HEADER, file=log)

        est_traj = []
        raw_traj = []   # (frame, pose as tracked): the post-BA trajectory
        log_rows = []   # the log's rows as parse_frame_log reads them
        frame = 0
        t_start = time.perf_counter()
        while True:
            if args.max_frames is not None and frame >= args.max_frames:
                break
            if live is not None:
                # frame-pump controls (ref mainQt.cpp qtIdle loop + QtGUI
                # reset/pause): pause blocks acquisition; reset rebuilds the
                # pipeline (newDenseSLAMSystem, QtGUI.cpp:84) keeping the
                # input stream position
                while live.paused and not live.reset_pending:
                    time.sleep(0.05)
                if live.take_reset():
                    pipe = None   # free the old map before the new one's
                    pipe = new_pipeline()
                    static_view_pose = None
            t0 = time.perf_counter()
            if frames is not None:
                if frame >= len(frames):
                    break
                depth = frames[frame][0]
            else:
                depth, _, _ = reader.read_next()
                if depth is None:
                    break
            t_acq = time.perf_counter()

            stage_sync = not args.no_stage_sync
            pipe.preprocessing(depth, is_mm=is_mm)
            if stage_sync:
                sync()
            t_pre = time.perf_counter()

            if args.groundtruth_mode and gt_poses is not None \
                    and frame < len(gt_poses):
                pipe.set_pose(gt_poses[frame])
                tracked = True
            else:
                tracked = pipe.tracking(frame)
            if stage_sync:
                sync()
            t_track = time.perf_counter()

            integrated = pipe.integration(frame) if (tracked or frame <= 3) \
                else False
            if stage_sync:
                sync()
            t_int = time.perf_counter()

            pipe.raycasting(frame)
            # keyframe recording, loop closure and windowed BA (the CLI drives
            # the stages itself, so it calls the step process_frame calls)
            if pipe.keyframes is not None and tracked \
                    and not args.groundtruth_mode and frame > 2:
                pipe._keyframe_step(frame)
            if stage_sync:
                sync()
            t_ray = time.perf_counter()

            # render views every rendering_rate frames (ref benchmark.cpp's
            # loop renders depth/track/volume each rendering_rate; timed into
            # the `rendering` log column)
            if cfg.rendering_rate > 0 and frame % cfg.rendering_rate == 0 \
                    and frame > 2:
                # model/camera view toggle (ref QtGUI setCameraView): static
                # mode pins the volume render to the pose captured at the
                # moment of the switch (K1's unprimed march)
                if live is not None and live.view_mode == "static":
                    if static_view_pose is None:
                        # a copy: the class rewrites its pose in place
                        static_view_pose = pipe.raycast_pose.to(
                            "cpu", copy=True).numpy()
                else:
                    static_view_pose = None
                # the 2x2 composite in one launch and one read
                composite = pipe.render_views(view_pose=static_view_pose)[0]
                if live is not None:
                    live.push(composite,
                              stats=served_stats(pipe, frame, tracked))
                if args.dump_renders:
                    os.makedirs(args.dump_renders, exist_ok=True)
                    viewer.write_ppm(
                        os.path.join(args.dump_renders,
                                     f"frame{frame:05d}.ppm"), composite)
            t_render = time.perf_counter()

            # ONE read of the frame's pose and drop counters (counts are exact
            # in f32)
            names = list(pipe.stats)
            packed = [pipe.pose.reshape(16)]
            if names:
                packed.append(torch.stack([pipe.stats[n].reshape(())
                                           .to(torch.float32) for n in names]))
            host = torch.cat(packed).cpu().numpy()
            pose_np = host[:16].reshape(4, 4)
            for name, v in zip(names, host[16:]):
                stats.sample(name, float(v), StatType.COUNT)

            pos = pose_np[:3, 3]
            row = (f"{frame}\t{t_acq - t0:.6f}\t{t_pre - t_acq:.6f}\t"
                   f"{t_track - t_pre:.6f}\t{t_int - t_track:.6f}\t"
                   f"{t_ray - t_int:.6f}\t{t_render - t_ray:.6f}\t"
                   f"{t_ray - t_pre:.6f}\t{t_render - t0:.6f}\t"
                   f"{pos[0]:.6f}\t{pos[1]:.6f}\t{pos[2]:.6f}\t"
                   f"{int(tracked)}\t{int(integrated)}")
            print(row, file=log)
            log_rows.append({"frame": frame, "preprocessing": t_pre - t_acq,
                             "tracking": t_track - t_pre,
                             "integration": t_int - t_track,
                             "raycasting": t_ray - t_int,
                             "rendering": t_render - t_ray,
                             "computation": t_ray - t_pre,
                             "X": pos[0], "Y": pos[1], "Z": pos[2]})
            stats.sample("computation", t_ray - t_pre, StatType.TIME)
            if args.plot_out and cfg.rendering_rate > 0 \
                    and frame % cfg.rendering_rate == 0 and frame > 2:
                plots.plot_run(
                    log_rows, args.plot_out,
                    gt_xyz=None if gt_poses is None else
                    np.asarray([p[:3, 3] for p in gt_poses[:frame + 1]]),
                    est_xyz=np.asarray([r[1:4] for r in est_traj]))

            # BA corrections (identity with keyframes off) apply to the
            # published trajectory
            P = pipe.trajectory_correction @ pose_np
            q = rotation_to_quaternion(P[:3, :3])
            est_traj.append((frame / 30.0, *P[:3, 3], *q))
            raw_traj.append((frame, pose_np))
            frame += 1

        wall = time.perf_counter() - t_start
        fps = frame / wall if wall > 0 else 0.0
        print(f"# frames={frame} wall={wall:.2f}s fps={fps:.2f}",
              file=sys.stderr)
        drops = {n: int(stats.sum(n)) for n in
                 ("alloc_overflow", "blocks_truncated", "patch_skipped",
                  "mip_skipped", "ray_overflow", "pool_bucket_overflow")
                 if stats.has(n)}
        if drops:
            print("# drop counters (should be 0; nonzero = budgets too small "
                  f"for this scene): {drops}", file=sys.stderr)

        if args.plot_out and log_rows:
            plots.plot_run(
                log_rows, args.plot_out,
                gt_xyz=None if gt_poses is None else
                np.asarray([p[:3, 3] for p in gt_poses[:frame]]),
                est_xyz=np.asarray([r[1:4] for r in est_traj]))
            print(f"# stats plot: {args.plot_out}", file=sys.stderr)

        if pipe.keyframes is not None and raw_traj:
            # the final post-BA trajectory (what offline evaluation scores):
            # each frame takes its nearest keyframe's BA correction, as JAX's
            # CLI does; the online rows above carry corrections forward only
            corr = pipe.keyframes.frame_corrections()
            if corr:
                kf_frames = np.asarray([c[0] for c in corr])
                final = []
                for f, P0 in raw_traj:
                    P = corr[int(np.argmin(np.abs(kf_frames - f)))][1] @ P0
                    q = rotation_to_quaternion(P[:3, :3])
                    final.append((f / 30.0, *P[:3, 3], *q))
                est_traj = final

        if args.trajectory_out:
            with open(args.trajectory_out, "w") as f:
                for row in est_traj:
                    f.write(" ".join(f"{v:.6f}" for v in row) + "\n")

        if gt_poses is not None and not args.groundtruth_mode:
            n = min(len(est_traj), len(gt_poses))
            est_xyz = np.asarray([r[1:4] for r in est_traj[:n]])
            gt_xyz = np.asarray([p[:3, 3] for p in gt_poses[:n]])
            st = ate_statistics(gt_xyz, est_xyz)
            print(f"# ATE RMSE {st['rmse']:.6f} m (mean {st['mean']:.6f}, "
                  f"median {st['median']:.6f})", file=sys.stderr)

        if cfg.dump_volume_file:
            save_map(cfg.dump_volume_file, pipe.geom, pipe.map, pipe.field)

        if log is not out:
            log.close()
        return pipe
    finally:
        if live is not None:
            live.stop()


def main(argv=None):
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
