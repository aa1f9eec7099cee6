"""K1's gated raycast and K7's median2 timed on the card on the two noise
maps, with the gated raycast's probe statistics.

    python3 -m supereight_tpu_torch.tools.noise_kernels [--workdir DIR]
    python3 -m supereight_tpu_torch.tools.noise_kernels --bilateral [--split]
    python3 -m supereight_tpu_torch.tools.noise_kernels --render RAW

The two maps:

* ``slice``: the ``tsdf-noise`` slice's, the bench orbit
  (``tools/bench.config``) with frame i noised by
  ``add_depth_noise(d, 0.002, seed=i)``, through ``frame_step`` for its 43
  frames with the options of the ``noise=0.002+levers`` row (median2,
  ``fuse_filtered``, ``min_ref_weight`` 4, ``noise_weighted``, pool,
  budget and bucket 49,152). The trajectory is lost there (JAX's too);
* ``tracked``: the first 60 frames of the 250-frame loop with
  Kinect-model range noise 0.002 (``io/synthetic.loop_frame``, rendered
  in worker processes into ``DIR/noisy_loop.raw``, kept for the next
  run), through the CLI (``cli.run``, in this process) with
  ``tools/longseq.py``'s arguments and the ``noise=0.002+levers`` row's
  options, where tracking holds.

On each map's last frame: the gated raycast's twin
(``kernels/raycast.raycast_plain(..., with_probes=True)``) gives the
march's probes a ray (mean, p50, p90, p99, max, and the sum over the
kernel's 8 x 4 pixel warps of each warp's largest count) and the
longest ray's probes by kind (known steps above the crawl floor, steps
at the floor, jumps, nav entries read); the kernel is then timed as the
path launches it and with its probe bound cut to the p50, p90, p99 and
max of the counts (``raycast_rays(..., max_steps=...)``, outputs
discarded), and a least-squares line through those times gives the
device us a probe of the longest chain and the rest (the epilogue, the
gate and the launch). median2 is timed on the frame's raw depth, the
filter's input. Device microseconds a launch: the kernels' device time
under ``torch.profiler`` over 20 launches divided by the launches the
trace shows (``tools/k3_bucket.device_us``). Then K1's other instances
on the bench orbit's last frame of each field (:func:`k1_instances`).
Last, K7's bilateral filter (:func:`bilateral`) on two depths: the
slice's last raw frame (320x240, the bench's ``-c 2``) and frame
BILATERAL_FRAME of the noisy loop at 640x480 (the ``-c 1`` compute
size, from its millimetres as the CLI reads them); a launch's device
time is the median of 20
(``tools/sharded_kernels.kernel_us``), and each output is printed with
its max error against the twin and the first 16 hex digits of the
SHA-256 of its bytes, so that two checkouts' outputs compare bit for
bit across runs. One line a map, one of the other instances and one a
bilateral input on stdout, then one JSON line of them all with the
card's name and power limit.

``--bilateral`` times the bilateral filter alone; with ``--split`` also
``tools/sharded_kernels``'s side builds of it (:data:`BILATERAL_SIDE`):
on these sources tiles of 14 output rows, every tap weighed by its own
pixel, equal depths' zero divided too, the range weight replaced by 1,
and the division's fast approximation; on commit 58e8608's the range
weight replaced by 1 and the edge clamps moved from the taps to the
tile's load.

``--render RAW`` only renders the tracked map's noisy frames into RAW
(no card needed; ``chip_smoke.py`` renders them so).

The script imports its kernels from whichever ``supereight_tpu_torch``
comes first on the path, so it can time another checkout's kernels on
the same card: ``PYTHONPATH=<checkout> python3
supereight_tpu_torch/tools/noise_kernels.py``. It runs on the card only:
without a CUDA device it exits 2.
"""

import argparse
import contextlib
import functools
import hashlib
import io
import json
import multiprocessing
import os
import sys
import tempfile
from typing import NamedTuple

import numpy as np
import torch

# the noise=0.002+levers row (tools/run_longseq_eval.py:127-131): the
# range noise, the pool (--block-capacity), the integration budget and
# pool bucket (--preset-budget) and the frame step's options
NOISE_FACTOR = 0.002
NOISE_CAPACITY = NOISE_BUDGET = 49152
NOISE_OPTIONS = dict(filter_input="median2", fuse_filtered=True,
                     min_ref_weight=4, noise_weighted=True)
# the tracked noise map: the first TRACKED_FRAMES frames of the
# LOOP_FRAMES-frame loop, rendered in LOOP_WORKERS processes
LOOP_FRAMES = 250
TRACKED_FRAMES = 60
LOOP_WORKERS = 4
LOOP_K = (481.2, 480.0, 320.0, 240.0)
LOOP_DIM = 4.8
WARP_TILE = (4, 8)  # K1's warp: 8 x 4 pixels (rows, columns)
BILATERAL_FRAME = TRACKED_FRAMES - 1  # the loop frame the filter takes
BILATERAL_SIDE = ("bilateral_unit_weight", "bilateral_no_clamp",
                  "bilateral_fast_div", "bilateral_zero_div",
                  "bilateral_tile14", "bilateral_no_sharing")


class GateInputs(NamedTuple):
    """The gated raycast's inputs as the path launches it: the map and its
    nav grid at the path's bucket, the view (pose @ invK), the raw depth
    that primes it, the intrinsics, mu, the frame's size (w, h), the gate's
    weight and the frame step's select (None for the class pipeline)."""
    geom: object
    field: object
    map: object
    nav: torch.Tensor
    view: torch.Tensor
    depth: torch.Tensor
    k: torch.Tensor
    mu: float
    frame_size: tuple
    weight: float
    prev: object = None


def slice_config(dev):
    """The tsdf-noise slice's bench (``tools/bench.Bench``): the TSDF
    bench orbit with frame i noised with seed i, the row's pool, budget
    and options."""
    from supereight_tpu_torch.io import synthetic
    from supereight_tpu_torch.parallel import step as pstep
    from supereight_tpu_torch.tools import bench
    b = bench.config("tsdf", dev, capacity=NOISE_CAPACITY)
    depths = np.stack([synthetic.add_depth_noise(d, NOISE_FACTOR, seed=i)
                       for i, d in enumerate(b.depths)])
    return b._replace(
        depths=depths, frames=[torch.from_numpy(d).to(dev) for d in depths],
        kw={**b.kw, **NOISE_OPTIONS,
            "budget": pstep.integration_budget(b.geom, NOISE_BUDGET)})


def slice_inputs(b, state):
    """The gated raycast of the slice's last frame: the map and pose that
    frame left, primed by its raw depth, with the frame step's select."""
    from supereight_tpu_torch.kernels import frame, nav, raycast
    view = frame.frame_mats(b.k, state.pose).kpose
    nv = nav.nav_grid(b.geom, state.map, b.field, bucket=b.kw["budget"])
    prev = raycast.Previous(
        torch.ones((), dtype=torch.bool, device=b.k.device), state.pose,
        state.raycast_pose, state.vertex, state.normal, state.valid)
    return GateInputs(b.geom, b.field, state.map, nv, view, b.frames[-1],
                      b.k, b.kw["mu"], b.kw["frame_size"],
                      b.kw["min_ref_weight"], prev)


def pipeline_inputs(pipe):
    """The gated raycast of the class pipeline's last frame (its
    ``raycasting``): the map, the raycast pose, the raw depth, the
    bucket."""
    from supereight_tpu_torch.kernels import frame, nav
    view = frame.frame_mats(pipe.k, pipe.raycast_pose).kpose
    nv = nav.nav_grid(pipe.geom, pipe.map, pipe.field,
                      bucket=pipe._budget_bucket())
    return GateInputs(pipe.geom, pipe.field, pipe.map, nv, view,
                      pipe.float_depth, pipe.k, pipe.config.mu,
                      tuple(pipe.computation_size),
                      pipe.config.min_ref_weight)


def gated(inp, max_steps=None):
    """The kernel's launch on ``inp`` (its probe bound cut to
    ``max_steps`` + 96 where given)."""
    from supereight_tpu_torch.kernels import raycast
    return raycast.raycast_rays(inp.geom, inp.map, inp.field, inp.nav,
                                inp.view, inp.depth, inp.k, inp.mu,
                                inp.frame_size, max_steps=max_steps,
                                prev=inp.prev, min_ref_weight=inp.weight)


def gated_plain(inp, with_probes=False):
    """The twin on ``inp``; with ``with_probes`` (rays, Probes)."""
    from supereight_tpu_torch.kernels import raycast
    return raycast.raycast_plain(
        inp.geom, inp.field, inp.map.data_x, inp.map.data_y, inp.nav,
        inp.view, inp.depth, inp.k, inp.mu, inp.frame_size,
        prev=inp.prev, with_probes=with_probes, slot=inp.map.slot,
        min_ref_weight=inp.weight)


def probe_stats(probes):
    """The march's probes a ray from the twin's ``Probes``: mean, p50,
    p90, p99 and max, the sum over the kernel's warps of each warp's
    largest count, and the longest ray's pixel and its probes by kind
    (where the twin records kinds; a parent checkout's may not)."""
    p = probes.per_ray
    h, w = p.shape
    f = p.reshape(-1).to(torch.float64)
    q = torch.quantile(f, torch.tensor([0.5, 0.9, 0.99], dtype=f.dtype,
                                       device=f.device)).tolist()
    th, tw = WARP_TILE
    hp, wp = -(-h // th) * th, -(-w // tw) * tw
    padded = torch.nn.functional.pad(p, (0, wp - w, 0, hp - h))
    warp_max = padded.reshape(hp // th, th, wp // tw, tw).amax(dim=(1, 3))
    i = int(torch.argmax(p.reshape(-1)))
    st = dict(mean=f.mean().item(), p50=q[0], p90=q[1], p99=q[2],
              max=int(p.max()), total=int(p.sum()),
              warp_max=int(warp_max.sum()), warps=warp_max.numel(),
              longest=(i // w, i % w))
    kinds = ("known", "crawl", "jump", "new_nav")
    if getattr(probes, "known", None) is not None:
        st["longest_split"] = {k: int(getattr(probes, k).reshape(-1)[i])
                               for k in kinds}
        st["split"] = {k: int(getattr(probes, k).sum()) for k in kinds}
    return st


def bound_line(inp, st, timer):
    """The launch's device us with its probe bound cut to the p50, p90,
    p99 and max of the probe counts (at least one probe), and the
    least-squares line through them: us a probe of the longest chain
    (slope) and the rest (intercept); and with no march probe at all
    (``zero_us``: the start, the epilogue, the gate and the launch)."""
    from supereight_tpu_torch.kernels.raycast import EXTRA_PROBES
    bounds = [max(1, int(round(st[k]))) for k in ("p50", "p90", "p99")]
    bounds.append(st["max"])
    times = [timer(lambda: gated(inp, n - EXTRA_PROBES)) for n in bounds]
    slope, intercept = np.polyfit(np.asarray(bounds, np.float64),
                                  np.asarray(times, np.float64), 1) \
        if len(set(bounds)) > 1 else (0.0, times[0])
    return dict(bounds=bounds, us=times, us_per_probe=float(slope),
                intercept_us=float(intercept),
                zero_us=timer(lambda: gated(inp, -EXTRA_PROBES)))


def measure(inp, timer, name=""):
    """On one map: the twin's probe statistics, the gated launch's and
    median2's device us (``timer(fn)``) and the time-versus-probe-bound
    line. Prints one line; returns the numbers."""
    from supereight_tpu_torch.kernels import preprocess
    rays, probes = gated_plain(inp, with_probes=True)
    st = probe_stats(probes)
    out = dict(probes=st, hits=int(rays.valid.sum()),
               overflow=int(rays.overflow),
               gated_us=timer(lambda: gated(inp)),
               median2_us=timer(lambda: preprocess.median_filter3(
                   inp.depth, 2)))
    out["line"] = bound_line(inp, st, timer)
    split = st.get("longest_split")
    line_us = [round(t, 2) for t in out["line"]["us"]]
    print(f"{name}: {out['hits']} valid hits, overflow {out['overflow']}; "
          f"probes a ray mean {st['mean']:.3f}, p50 {st['p50']:.0f}, p90 "
          f"{st['p90']:.0f}, p99 {st['p99']:.0f}, max {st['max']}; sum of "
          f"the {st['warps']} warps' largest counts {st['warp_max']}; the "
          f"longest ray (row, column) {st['longest']}"
          + (f": {split['known']} known above the floor, {split['crawl']} "
             f"at the crawl floor, {split['jump']} jumps, "
             f"{split['new_nav']} nav entries read; all rays: "
             f"{st['split']}" if split else "")
          + f"; raycast_gated {out['gated_us']:.2f} us, median2 "
          f"{out['median2_us']:.2f} us; with the probe bound cut to "
          f"{out['line']['bounds']}: {line_us} us, "
          f"{out['line']['us_per_probe']:.4f} us a probe + "
          f"{out['line']['intercept_us']:.2f} us; with no march probe "
          f"{out['line']['zero_us']:.2f} us", flush=True)
    return out


def k1_instances(dev, timer):
    """Device us a launch (``timer(fn)``) of K1's other instances on the
    bench orbit's last frame (``tools/bench.config``, 43 frames a field):
    ``raycast`` / ``raycast_of`` as the frame step launches them (primed
    by the frame's depth, the bench's bucket), ``raycast_cold`` /
    ``raycast_cold_of`` from the pose moved 0.5 m back along its optical
    axis to 8 m (a fresh view's render), ``raycast_cols`` /
    ``raycast_cols_of`` over the image columns 80 to 159 (the sharded
    step's second rank of four; here on the whole map)."""
    from supereight_tpu_torch.constants import FAR_PLANE
    from supereight_tpu_torch.kernels import frame, nav, raycast
    from supereight_tpu_torch.tools import bench
    out = {}
    for field in ("tsdf", "ofusion"):
        b = bench.config(field, dev)
        state = b.init()
        for i in range(len(b.frames)):
            state, _ = b.frame(state, i)
        m, mu, size = state.map, b.kw["mu"], b.kw["frame_size"]
        nv = nav.nav_grid(b.geom, m, b.field, bucket=b.kw["budget"])
        nv_all = nav.nav_grid(b.geom, m, b.field)
        view = frame.frame_mats(b.k, state.pose).kpose
        back = state.pose.clone()
        back[:3, 3] -= 0.5 * back[:3, 2]
        cold = frame.frame_mats(b.k, back).kpose
        of = "_of" if field == "ofusion" else ""
        calls = {
            "raycast" + of: lambda: raycast.raycast_rays(
                b.geom, m, b.field, nv, view, b.frames[-1], b.k, mu, size),
            "raycast_cold" + of: lambda: raycast.raycast_rays(
                b.geom, m, b.field, nv_all, cold, None, None, mu, size,
                far=2.0 * FAR_PLANE),
            "raycast_cols" + of: lambda: raycast.raycast_rays(
                b.geom, m, b.field, nv, view, b.frames[-1], b.k, mu, size,
                x0=size[0] // 4, width=size[0] // 4)}
        out.update((name, timer(fn)) for name, fn in calls.items())
    print("K1's other instances, device us a launch: "
          + ", ".join(f"{k} {v:.2f}" for k, v in out.items()), flush=True)
    return out


def digest(t):
    """The first 16 hex digits of the SHA-256 of a tensor's bytes."""
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def loop_depth(dev, i=BILATERAL_FRAME):
    """Frame ``i`` of the noisy loop at 640x480 on ``dev``, rounded to
    millimetres and read back as ``ops/preprocess.mm2meters`` reads a
    .raw frame."""
    from supereight_tpu_torch.io import synthetic
    from supereight_tpu_torch.ops.preprocess import mm2meters
    d, _ = synthetic.loop_frame(i, LOOP_FRAMES, LOOP_K, width=640,
                                height=480, dim=LOOP_DIM,
                                noise_factor=NOISE_FACTOR)
    mm = np.round(d * 1000.0).astype(np.uint16)
    return mm2meters(mm, (480, 640), dev)


def bilateral_inputs(dev):
    """The bilateral filter's depths on ``dev``: ``slice_320x240``, the
    tsdf-noise slice's last raw frame, and ``loop_640x480``
    (:func:`loop_depth`)."""
    return {"slice_320x240": slice_config(dev).frames[-1],
            "loop_640x480": loop_depth(dev)}


def bilateral(inputs, side=None, timer=None):
    """K7's bilateral filter on each of ``inputs`` (name -> depth): with
    the library's kernel (``whole``) and each side build of ``side``
    (name -> library, or None where it does not fit the sources), the
    output's max error against the twin and :func:`digest`, and the
    device us a launch by ``timer(fn)`` (default
    ``tools/sharded_kernels.kernel_us``: median, fastest, slowest).
    Prints one line a build; returns the numbers."""
    from supereight_tpu_torch.kernels import preprocess
    from supereight_tpu_torch.tools import sharded_kernels as sk
    timer = timer or (lambda fn: sk.kernel_us(fn, "bilateral_kernel"))
    out = {}
    for name, depth in inputs.items():
        h, w = depth.shape
        twin = preprocess.bilateral_filter_plain(depth)
        r = dict(size=[w, h], zeros=int((depth == 0).sum()))
        for build, lib in (("whole", None),) + tuple((side or {}).items()):
            if build != "whole" and lib is None:
                print(f"bilateral {name} {build}: no such side build of "
                      f"these sources", flush=True)
                r[build] = None
                continue
            with sk.using(lib) if lib is not None \
                    else contextlib.nullcontext():
                got = preprocess.bilateral_filter(depth)
                med, lo, hi = timer(
                    lambda: preprocess.bilateral_filter(depth))
            r[build] = dict(us=med, fastest=lo, slowest=hi,
                            max_err=float((got - twin).abs().max()),
                            sha256=digest(got))
            print(f"bilateral {name} {build}: {w}x{h}, {r['zeros']} zero "
                  f"pixels; {med:.2f} device us a launch (median; "
                  f"{lo:.2f}-{hi:.2f}); max err against the twin "
                  f"{r[build]['max_err']:.3e}; sha256 "
                  f"{r[build]['sha256']}", flush=True)
        out[name] = r
    return out


def _write_gt(path, poses):
    """The TUM ground truth ``io/convert.synthetic2raw`` writes beside a
    .raw (kept here: the script also runs against checkouts whose
    ``io/convert`` exposes no writer of its own)."""
    from supereight_tpu_torch.cli import rotation_to_quaternion
    with open(path, "w") as f:
        for i, p in enumerate(poses):
            q = rotation_to_quaternion(p[:3, :3])
            f.write(f"{i/30.0:.6f} {p[0,3]:.6f} {p[1,3]:.6f} {p[2,3]:.6f} "
                    f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")


def render_noisy_loop(path, frames=TRACKED_FRAMES, workers=LOOP_WORKERS):
    """Frames 0 to ``frames`` - 1 of the LOOP_FRAMES-frame loop with
    Kinect-model range noise NOISE_FACTOR at 640x480 (as
    ``io/convert.synthetic2raw(scene="loop", noise_factor=...)`` renders
    them), in ``workers`` processes, into the .raw ``path`` and its
    ground truth ``path + ".gt.txt"``."""
    from supereight_tpu_torch.io import dataset, synthetic
    render = functools.partial(synthetic.loop_frame, n_frames=LOOP_FRAMES,
                               k=LOOP_K, width=640, height=480, dim=LOOP_DIM,
                               noise_factor=NOISE_FACTOR)
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        out = pool.map(render, range(frames))
    depths = np.stack([d for d, _ in out])
    dataset.write_raw(path, np.round(depths * 1000.0).astype(np.uint16))
    _write_gt(path + ".gt.txt", [p for _, p in out])


def tracked_argv(raw, log, frames=TRACKED_FRAMES):
    """The CLI's arguments for the tracked noise map: tools/longseq.py's
    base arguments and its noise=0.002+levers row."""
    from supereight_tpu_torch.tools import longseq
    levers = dict(longseq.noise_variants(NOISE_FACTOR))[
        f"tsdf icp noise={NOISE_FACTOR}+levers"]
    return (["-i", raw, "-g", raw + ".gt.txt", "-o", log, "--max-frames",
             str(frames)] + list(longseq.BASE_ARGS) + list(levers))


def run_tracked(raw, log, frames=TRACKED_FRAMES):
    """The CLI over the noisy loop, in this process: (the pipeline as its
    last frame left it, the CLI's stderr)."""
    from supereight_tpu_torch import cli
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        pipe = cli.run(tracked_argv(raw, log, frames))
    return pipe, err.getvalue()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workdir", default=None,
                   help="directory of the noisy loop .raw (kept)")
    p.add_argument("--render", metavar="RAW", default=None,
                   help="only render the noisy loop's frames into RAW")
    p.add_argument("--bilateral", action="store_true",
                   help="only time the bilateral filter")
    p.add_argument("--split", action="store_true",
                   help="with --bilateral: also its side builds")
    args = p.parse_args(argv)
    if args.render:
        render_noisy_loop(args.render)
        return 0
    if not torch.cuda.is_available():
        print("noise_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    import supereight_tpu_torch
    from supereight_tpu_torch.tools.bench import card
    from supereight_tpu_torch.tools.k3_bucket import device_us
    print(f"# {card()}; kernels of {supereight_tpu_torch.__file__}",
          flush=True)
    dev = torch.device("cuda", 0)
    if args.bilateral:
        from supereight_tpu_torch.tools import sharded_kernels as sk
        side = sk.build_side(BILATERAL_SIDE) if args.split else None
        res = bilateral(bilateral_inputs(dev), side)
        print(json.dumps({"card": card(), "bilateral": res}))
        return 0
    b = slice_config(dev)
    state = b.init()
    for i in range(len(b.frames)):
        state, _ = b.frame(state, i)
    torch.cuda.synchronize()
    res = {"slice": measure(slice_inputs(b, state), device_us,
                            f"slice, frame {len(b.frames) - 1}")}
    wd = args.workdir or tempfile.mkdtemp(prefix="noise_kernels_")
    os.makedirs(wd, exist_ok=True)
    raw = os.path.join(wd, "noisy_loop.raw")
    if not os.path.exists(raw + ".gt.txt"):
        render_noisy_loop(raw)
    pipe, _ = run_tracked(raw, os.path.join(wd, "tracked.log"))
    torch.cuda.synchronize()
    res["tracked"] = measure(pipeline_inputs(pipe), device_us,
                             f"tracked, frame {TRACKED_FRAMES - 1}")
    del pipe
    res["k1"] = k1_instances(dev, device_us)
    res["bilateral"] = bilateral(bilateral_inputs(dev))
    print(json.dumps({"card": card(), "noise_kernels": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
