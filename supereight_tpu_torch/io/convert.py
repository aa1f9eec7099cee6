"""Dataset conversion tools (the se_tools layer).

Port of ``supereight_tpu/io/convert.py`` (behavioral reference:
se_tools/scene2raw.cpp, ICL-NUIM scene -> .raw, and se_tools/oni2raw.cpp,
OpenNI recording -> .raw, which needs the OpenNI SDK and raises with
guidance). ``scene2raw`` prefers the native converter (``io/native.py``),
as JAX's does, and falls back to the Python reader
(``io/dataset.SceneDepthReader``); the two paths write JAX's bytes of the
same path (the native one rounds millimetres, the Python one
truncates). ``synthetic2raw`` renders the orbit or the closed loop with
``io/synthetic`` (numpy) and writes the same bytes as JAX's; ``workers``
> 1 renders the frames in that many processes.

Usage:
  python -m supereight_tpu_torch.io.convert scene2raw <scene_dir> <out.raw>
  python -m supereight_tpu_torch.io.convert synthetic <out.raw> --frames 64
"""

import argparse
import functools
import multiprocessing
import sys

import numpy as np

from supereight_tpu_torch.io import dataset, native, synthetic


def scene2raw(scene_dir: str, out_path: str) -> int:
    """ICL-NUIM scene directory -> .raw; returns the frames written.
    Prefers the native converter; falls back to the Python reader."""
    if native.available():
        return native.scene2raw(scene_dir, out_path)
    reader = dataset.SceneDepthReader(scene_dir)
    depths = []
    while True:
        d = reader.read_next()
        if d is None:
            break
        depths.append((d * 1000.0).astype(np.uint16))
    if depths:
        dataset.write_raw(out_path, np.stack(depths))
    return len(depths)


def oni2raw(*_args, **_kw):
    raise NotImplementedError(
        "oni2raw needs the OpenNI SDK and a live/recorded camera; convert "
        "the .oni on a workstation with the reference tool and feed the "
        ".raw here (the format is identical).")


def synthetic2raw(out_path: str, frames: int = 64, scene: str = "orbit",
                  noise_factor: float = 0.0, workers: int = 1):
    """Render a synthetic scene into a .raw sequence + TUM gt file
    (``out_path + ".gt.txt"``); returns the frames written.

    scene="orbit": the simple sphere-in-a-room test scene.
    scene="loop": the traj2-class benchmark: multi-object room
    (occlusions, pillar, table, spheres), full closed-loop trajectory at
    640x480, optional Kinect-model depth noise (synthetic.loop_sequence).
    ``workers`` > 1 renders the loop's frames in that many processes: the
    same frames, in the same order.
    """
    k = (481.2, 480.0, 320.0, 240.0)
    dim = 4.8
    if scene == "loop":
        if workers > 1:
            render = functools.partial(synthetic.loop_frame, n_frames=frames,
                                       k=k, width=640, height=480, dim=dim,
                                       noise_factor=noise_factor)
            ctx = multiprocessing.get_context("spawn")
            with ctx.Pool(workers) as pool:
                out = pool.map(render, range(frames))
            depths = np.stack([d for d, _ in out])
            poses = np.stack([p for _, p in out])
        else:
            depths, poses = synthetic.loop_sequence(
                frames, k, width=640, height=480, dim=dim,
                noise_factor=noise_factor)
    else:
        depths, poses = synthetic.orbit_sequence(
            frames, k, width=640, height=480, radius=0.3 * dim,
            center=(dim / 2,) * 3, sphere_radius=0.15 * dim,
            angle_span=0.6, room=((0.55,) * 3, (dim - 0.55,) * 3))
    dataset.write_raw(out_path, np.round(depths * 1000.0).astype(np.uint16))
    gt_path = out_path + ".gt.txt"
    from supereight_tpu_torch.cli import rotation_to_quaternion
    with open(gt_path, "w") as f:
        for i, p in enumerate(poses):
            q = rotation_to_quaternion(p[:3, :3])
            f.write(f"{i/30.0:.6f} {p[0,3]:.6f} {p[1,3]:.6f} {p[2,3]:.6f} "
                    f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")
    return frames


def main(argv=None):
    p = argparse.ArgumentParser(prog="supereight-tpu-torch-convert")
    sub = p.add_subparsers(dest="cmd", required=True)
    s1 = sub.add_parser("scene2raw")
    s1.add_argument("scene_dir")
    s1.add_argument("out")
    s2 = sub.add_parser("synthetic")
    s2.add_argument("out")
    s2.add_argument("--frames", type=int, default=64)
    s2.add_argument("--scene", choices=["orbit", "loop"], default="orbit")
    s2.add_argument("--noise-factor", type=float, default=0.0)
    s2.add_argument("--workers", type=int, default=1,
                    help="processes rendering the loop's frames")
    args = p.parse_args(argv)
    if args.cmd == "scene2raw":
        n = scene2raw(args.scene_dir, args.out)
    else:
        n = synthetic2raw(args.out, args.frames, scene=args.scene,
                          noise_factor=args.noise_factor,
                          workers=args.workers)
    print(f"wrote {n} frames", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
