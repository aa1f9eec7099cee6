"""The CLI's ``rendering`` column on the closed loop, split, and a digest
of its PPM renders.

    python3 -m supereight_tpu_torch.io.convert synthetic RAW \\
        --frames 250 --scene loop --workers 8
    python3 -m supereight_tpu_torch.tools.render_loop --raw RAW \\
        [--workdir DIR]

On the card only (exit 2 without one). Runs the port's CLI (``cli.run``,
in this process) over the loop with ``tools/longseq.py``'s ``tsdf icp``
row (the eval's arguments, ``-z 4``: 62 rendered frames of 250) and
``--dump-renders``, the class on its stage graphs, then the same run with
the class's ``eager=True`` and no PPMs, and prints one JSON line: each
run's mean and median ``rendering`` column over the rendered frames (ms;
the log's column holds the class's composite, one launch and one read to
a host array, and the PPM write), the split of that column on the graph
run's last frame (:func:`split`: host ms, medians of :data:`REPS`), K10's
device us on that frame (:func:`device_us`), the ATE and the SHA-256 of
the PPMs in frame order (:func:`ppm_digest`). To take
a parent's numbers on the same card, unpack it (``git archive <commit> |
tar -x -C build/parent``) and run this file by path with
``PYTHONPATH=build/parent``: it uses the package it imports, and needs
of it only the CLI, ``tools/longseq.py`` and the class's renders (a
package whose class has no ``render_views`` is split into its three
renders, the composite and the write: :data:`PARENT_PARTS`).
"""

import argparse
import contextlib
import functools
import hashlib
import io
import json
import os
import statistics
import sys
import time

import torch

from supereight_tpu_torch import cli, viewer
from supereight_tpu_torch.eval.sweep import parse_frame_log
from supereight_tpu_torch.pipeline import DenseSLAMSystem
from supereight_tpu_torch.tools import longseq
from supereight_tpu_torch.tools.ba_windows import card

FRAMES = 250
ARGS = longseq.BASE_ARGS + longseq.VARIANTS[0][1]  # the "tsdf icp" row
# a rendered frame's parts: the class's call (one launch, one read), its
# read alone (into a fresh array, or through a reused pinned buffer and a
# host copy), the PPM write; a package without render_views: its three
# renders (each to a host array), the composite of their images, the write
PARTS = ("render_views", "read", "read_pinned", "ppm")
PARENT_PARTS = ("render_depth", "render_track", "render_volume",
                "composite", "ppm")
REPS = 20  # host-timed reps of each part of a rendered frame


def rendered(rows, rate):
    """The log's rows of the frames the CLI renders (every ``rate``-th
    from frame 4)."""
    return [r for r in rows if rate and int(r["frame"]) % rate == 0
            and r["frame"] > 2]


def column_ms(rows, rate):
    """Mean and median ms of the ``rendering`` column over the rendered
    frames, and how many there are."""
    ms = [1e3 * r["rendering"] for r in rendered(rows, rate)]
    return dict(mean=statistics.mean(ms), median=statistics.median(ms),
                frames=len(ms))


def split(pipe, path, reps=REPS):
    """Host ms (median, min) of each part of a rendered frame's
    ``rendering`` column on ``pipe``'s current state, each timed ``reps``
    times alone: :data:`PARTS`, or :data:`PARENT_PARTS` where the class
    has no ``render_views``."""
    if hasattr(pipe, "render_views"):
        comp = pipe._composite()
        image = pipe.render_views()[0]
        pinned = torch.empty(tuple(comp.shape), dtype=comp.dtype,
                             pin_memory=comp.is_cuda)

        def read_pinned():
            pinned.copy_(comp)
            return pinned.numpy().copy()
        calls = dict(zip(PARTS, (
            pipe.render_views,
            lambda: comp.to("cpu", copy=True).numpy(), read_pinned,
            lambda: viewer.write_ppm(path, image))))
    else:
        views = (pipe.render_depth(), pipe.render_track(),
                 pipe.render_volume())
        image = viewer.composite_views(*views)
        calls = dict(zip(PARENT_PARTS, (
            pipe.render_depth, pipe.render_track, pipe.render_volume,
            lambda: viewer.composite_views(*views),
            lambda: viewer.write_ppm(path, image))))
    out = {}
    for name, fn in calls.items():
        fn()
        t = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            t.append(1e3 * (time.perf_counter() - t0))
        out[name] = dict(median=statistics.median(t), min=min(t))
    return out


def device_us(pipe):
    """Device us (median of ``tools/sharded_kernels.REPS`` launches,
    ``kernel_us``) of each K10 launch on ``pipe``'s current state: the
    three single renders and, where the package has it,
    ``render_views``; and the launch floor."""
    from supereight_tpu_torch.kernels import render
    from supereight_tpu_torch.tools.sharded_kernels import (kernel_us,
                                                            launch_floor_us)
    args = {"render_depth": (pipe.float_depth,),
            "render_track": (pipe.track_result,),
            "render_volume": (pipe.vertex, pipe.normal, pipe.valid,
                              pipe.raycast_pose)}
    if hasattr(render, "render_views"):
        args["render_views"] = (args["render_depth"] + args["render_track"]
                                + args["render_volume"])
    out = {name: kernel_us(functools.partial(getattr(render, name), *a),
                           name + "_kernel")[0] for name, a in args.items()}
    out["launch_floor"] = launch_floor_us()
    return out


def ppm_digest(directory):
    """SHA-256 of the PPM files in ``directory``, in name (frame) order,
    and their count."""
    h = hashlib.sha256()
    names = sorted(n for n in os.listdir(directory) if n.endswith(".ppm"))
    for name in names:
        with open(os.path.join(directory, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest(), len(names)


def run_cli(argv, eager=False):
    """``cli.run(argv)`` in this process with its stderr captured; with
    ``eager``, the class with ``eager=True`` (every stage eager, the stage
    graphs' reference). Returns the pipeline and the stderr text."""
    err = io.StringIO()
    with eager_cli(eager), contextlib.redirect_stderr(err):
        pipe = cli.run(argv)
    return pipe, err.getvalue()


@contextlib.contextmanager
def eager_cli(eager=True):
    """Within, with ``eager``: the CLI builds the class with ``eager=True``
    (its ``DenseSLAMSystem`` swapped, and restored on the way out)."""
    real = cli.DenseSLAMSystem
    if eager:
        cli.DenseSLAMSystem = functools.partial(DenseSLAMSystem, eager=True)
    try:
        yield
    finally:
        cli.DenseSLAMSystem = real


def main(argv=None):
    ap = argparse.ArgumentParser(prog="supereight-tpu-torch-render-loop")
    ap.add_argument("--raw", required=True,
                    help="the loop's .raw (with its .gt.txt beside it)")
    ap.add_argument("--workdir", default="build/render_loop")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("render_loop: needs a CUDA device", file=sys.stderr)
        return 2
    os.makedirs(args.workdir, exist_ok=True)
    rate = int(ARGS[ARGS.index("-z") + 1])
    renders = os.path.join(args.workdir, "renders")

    def loop(name, *extra, eager=False):
        log = os.path.join(args.workdir, name + ".log")
        pipe, err = run_cli(["-i", args.raw, "-g", args.raw + ".gt.txt",
                             "-o", log, "--max-frames", str(FRAMES), *ARGS,
                             *extra], eager)
        ate = next(float(line.split("ATE RMSE")[1].split()[0])
                   for line in err.splitlines() if "ATE RMSE" in line)
        return pipe, column_ms(parse_frame_log(log), rate), ate

    out = dict(package=os.path.dirname(os.path.abspath(cli.__file__)),
               card=card())
    pipe, graphs, out["ate"] = loop("graphs", "--dump-renders", renders)
    out["ppm_sha256"], out["ppm_count"] = ppm_digest(renders)
    out["split_ms"] = split(pipe, os.path.join(args.workdir, "split.ppm"))
    out["device_us"] = device_us(pipe)
    del pipe
    torch.cuda.empty_cache()
    _, eager, out["eager_ate"] = loop("eager", eager=True)
    out["rendering_ms"] = dict(graphs=graphs, eager=eager)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
