"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload traj2-tsdf.live --seed 7 \
        --seconds 10 --trace 0

A cell (``BENCHMARK.json``'s ``workloads``) is a configuration file
(``configs/<config>.json``: the deployment's settings) under a traffic
mix (``traffic/<traffic>.json``: the frames and what the loop does with
them); its per-layer metrics are the readers ``metrics/<name>.py`` and
its limits ``limits/<cell>.json``. Nothing here is particular to a cell.

The run drives ``supereight_tpu_torch.pipeline.DenseSLAMSystem`` as the
CLI's frame loop does: each frame ``process_frame`` on the host's u16
millimetres, ``render_views`` on the traffic's rendered frames, and one
read of the pose and the drop counters. The loop is closed, one frame at
a time. Set-up renders the traffic's loop on the card from ``--seed``,
builds the pipeline and runs one whole loop, so that every stage graph is
captured before the window. The window then runs frames for ``--seconds``
and reports the rate, the tails of the frames' latency (CUDA events from
the frame's hand-over to its read's completion) and the set-up time. With
``--trace 1`` a stretch of the window runs under ``torch.profiler`` and
the line carries the per-layer metrics. After the window the program is
freed and the frames sampled from it are computed again by the plain
reference (``reference/``) from the program's own state before each, and
the gaps decide ``correct``.

It exits 2, printing no result, without a CUDA device, and 3 if the
process holds JAX or the JAX package when the window has closed.
"""

import argparse
import contextlib
import gc
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import time

T_START = time.perf_counter()

ROOT = pathlib.Path(__file__).resolve().parent.parent
# one process with few threads: the frame loop's host work is one Python
# thread, and idle pools only take cores from it
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import loop  # noqa: E402
from benchmark.reference import compare, step  # noqa: E402
from benchmark.reference.frozen.core.map import MapState  # noqa: E402

torch.set_num_threads(1)

# top-level module names the process may not hold when the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "supereight_tpu")
# set-up frames also sampled: the empty map's first fusion and the first
# tracked (and, where the traffic renders, rendered) frame
START_SAMPLES = (0, 4)
TRACE_TRIES = 5


def load_cell(name, root=ROOT):
    """(benchmark, cell, configuration, traffic, limits) of the cell
    ``name``, each a dict read from its file."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / conf["file"]).read_text())
    data = root / "benchmark"
    traffic = json.loads(
        (data / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((data / "limits" / f"{name}.json").read_text())
    return bench, cell, config, traffic, limits


def cell_metrics(bench, cell, kind):
    """The cell's metrics of ``kind`` (``end_to_end`` or ``per_layer``):
    those that name the cell, or name no cells and move an end-to-end
    metric that the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    if kind == "end_to_end":
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell["name"] in m.get("workloads", [cell["name"]])
            and ("workloads" in m or m["moves"] in moved)]


def reader(name, root=ROOT):
    """The per-layer metric ``name``'s reader: ``metrics/<name>.py``'s
    ``read(ctx)``, which returns a number or None (nothing to read)."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def settings(config, traffic):
    """The pipeline's settings: the configuration's, then the traffic's
    own options over them."""
    s = dict(config["pipeline"])
    s.update(traffic.get("pipeline", {}))
    return s


def seed_rng(seed):
    """numpy's generator of ``seed``, any whole number."""
    return np.random.default_rng(seed & (2 ** 64 - 1))


class Frames:
    """The traffic's frames: u16 millimetres on the host ([n, H, W],
    ``bank`` loops of them, one after another) and the ground-truth poses
    of one loop, from the seed."""

    def __init__(self, s, traffic, seed, device):
        rng = seed_rng(seed)
        self.start = float(rng.uniform(0.0, 2.0 * math.pi))
        n = self.n = traffic["loop_frames"] - 1  # the last is frame 0 again
        self.poses = loop.loop_poses(n, traffic["loop_frames"],
                                     s["volume_size"], self.start)
        w, h = s["input_size"]
        scene = loop.loop_scene(s["volume_size"], traffic.get("omit", ()))
        depth = loop.render_depths(self.poses, s["camera"], w, h, scene,
                                   device=device,
                                   min_depth=traffic.get("min_depth"))
        noise = traffic.get("noise_factor", 0.0)
        banks = []
        gen = torch.Generator(device=device)
        gen.manual_seed(seed & (2 ** 63 - 1))
        for _ in range(traffic.get("noise_loops", 1) if noise else 1):
            d = loop.add_noise(depth, noise, gen) if noise else depth
            banks.append(loop.to_mm(d).cpu().numpy().view(np.uint16))
        self.mm = np.concatenate(banks)

    def depth(self, i):
        return self.mm[i % len(self.mm)]

    def pose(self, i):
        return self.poses[i % self.n]


def configuration(s):
    """The port's ``Configuration`` of the settings ``s``."""
    from supereight_tpu_torch.config import Configuration
    return Configuration(
        compute_size_ratio=s["compute_size_ratio"],
        tracking_rate=s["tracking_rate"],
        integration_rate=s["integration_rate"],
        rendering_rate=s["rendering_rate"],
        volume_resolution=s["volume_resolution"],
        volume_size=s["volume_size"], pyramid=tuple(s["pyramid"]),
        mu=s["mu"], icp_threshold=s["icp_threshold"],
        filter_input=s.get("filter_input") or False,
        camera=tuple(s["camera"]), field=s["field"],
        depth_interp=s.get("depth_interp", False),
        noise_weighted=s.get("noise_weighted", False),
        fuse_filtered=s.get("fuse_filtered", False),
        min_ref_weight=s.get("min_ref_weight", 0.0),
        block_capacity=s["block_capacity"],
        preset_budget=s.get("preset_budget", 0))


def clone_map(m):
    """A device copy of a map (the port's ``MapState`` or the reference's)
    as the reference's ``MapState``."""
    return MapState(*[tuple(t.clone() for t in v) if isinstance(v, tuple)
                      else v.clone() for v in m])


def snapshot(pipe):
    """A copy of the pipeline's state between frames (device clones)."""
    return dict(pose=pipe.pose.clone(), raycast_pose=pipe.raycast_pose.clone(),
                vertex=pipe.vertex.clone(), normal=pipe.normal.clone(),
                valid=pipe.valid.clone(), map=clone_map(pipe.map),
                alloc_budget=pipe._alloc_budget)


def sampled(lp, i, dev):
    """Run frame ``i`` between two snapshots of the state: (frame, state
    before, state after, composite), and the frame's tracked verdict.
    The copies are waited for outside the frame's latency."""
    def wait():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    before = snapshot(lp.pipe)
    wait()
    tracked, comp = lp.frame(i)
    after = snapshot(lp.pipe)
    after.update(tracked=tracked)
    wait()
    return (i, before, after, comp), tracked


class Loop:
    """The frame loop of one pipeline: :meth:`frame` runs frame ``i`` as
    the CLI does and returns (tracked, composite or None); the frame's
    latency (ms) and its read land in ``last``. On the card the latency is
    CUDA events' from the frame's hand-over to its read's completion; the
    CPU (the harness's own tests) takes the host's clock. ``span`` wraps
    each frame in the harness's profiler span."""

    def __init__(self, pipe, frames, traffic, device):
        self.pipe, self.frames = pipe, frames
        self.gt = traffic["poses"] == "groundtruth"
        self.render = traffic.get("render_every", 0)
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
        self.host = torch.empty(64, dtype=torch.float32,
                                pin_memory=self.cuda)
        self.span = False

    def rendered(self, i):
        return self.render > 0 and i % self.render == 0 and i > 2

    def frame(self, i):
        pipe = self.pipe
        depth = self.frames.depth(i)
        gt = self.frames.pose(i) if self.gt else None
        span = torch.profiler.record_function("bench.frame") if self.span \
            else contextlib.nullcontext()
        t0 = time.perf_counter()
        if self.cuda:
            self.start.record()
        with span:
            out = pipe.process_frame(depth, i, is_mm=True, gt_pose=gt)
            comp = None
            if self.rendered(i):
                comp = pipe.render_views()[0]
            names = list(pipe.stats)
            packed = torch.cat([pipe.pose.reshape(16)] + [
                pipe.stats[n].reshape(1).to(torch.float32) for n in names])
            n = packed.numel()
            self.host[:n].copy_(packed, non_blocking=self.cuda)
            if self.cuda:
                self.end.record()
                self.end.synchronize()
        ms = self.start.elapsed_time(self.end) if self.cuda \
            else (time.perf_counter() - t0) * 1e3
        h = self.host[:n].numpy()
        self.last = dict(ms=ms, pose=h[:16].reshape(4, 4).copy(),
                         drops=dict(zip(names, h[16:].tolist())))
        return out["tracked"], comp


def card_lines(device):
    """The card's name, power limit and clocks, from nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,clocks.mem,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi failed: {e}"
    return [f"# card: {torch.cuda.get_device_name(device)}",
            f"# nvidia-smi name, power limit, sm clock, max sm clock, "
            f"memory clock, temperature: {out}"]


def percentile(values, p):
    """The ``p``-th percentile (0-100) of all ``values``, nearest rank."""
    v = np.sort(np.asarray(values))
    return float(v[min(len(v) - 1, max(0, math.ceil(p / 100 * len(v)) - 1))])


def run(workload, seed, seconds, trace, device="cuda", root=ROOT, log=None,
        control=False):
    """One run of the cell ``workload``: the result line's dict, its
    ``checks`` last. ``control`` also judges the same sampled frames with
    the reference in bfloat16 (the control, ``control.py``) into
    ``result["control"]``."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    bench, cell, config, traffic, limits = load_cell(workload, root)
    s = settings(config, traffic)
    dev = torch.device(device)
    from supereight_tpu_torch.kernels import _lib
    from supereight_tpu_torch.pipeline import DenseSLAMSystem

    frames = Frames(s, traffic, seed, dev)
    log(f"# {workload}: seed {seed} starts the loop "
        f"{frames.start:.6f} rad along its path; {frames.n} frames a loop, "
        f"{len(frames.mm) // frames.n} loop(s) of depth")
    pipe = DenseSLAMSystem(tuple(s["input_size"]), configuration(s),
                           init_pose=frames.poses[0], device=dev)
    lp = Loop(pipe, frames, traffic, dev)
    samples = []   # (frame, before, after, composite)
    for i in range(frames.n):  # set-up: one whole loop
        if i in START_SAMPLES:
            samples.append(sampled(lp, i, dev)[0])
        else:
            lp.frame(i)
    captured = pipe.graph_stats()["graphs"]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    # set-up's objects out of the collector's way in the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - T_START

    rng = seed_rng(seed + 1)
    n_sample = traffic["sample_frames"]
    sample_at = sorted(rng.uniform(0.1, 0.45, n_sample) * seconds)
    trace_at = 0.55 * seconds if trace else math.inf
    lat, poses, index = [], [], []
    failed = 0
    traced = None
    i = frames.n
    with _lib.host_calls() as calls:
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter() - t0
            if now >= seconds:
                break
            take = sample_at and now >= sample_at[0] and (
                not lp.render or lp.rendered(i))
            if now >= trace_at:
                traced = trace_stretch(lp, i, traffic, _lib)
                i += traffic["trace_frames"] * traced["tries"]
                trace_at = math.inf
                continue
            if take:
                sample, tracked = sampled(lp, i, dev)
                samples.append(sample)
                sample_at.pop(0)
            else:
                tracked, _ = lp.frame(i)
            lat.append(lp.last["ms"])
            poses.append(lp.last["pose"])
            index.append(i)
            if (i > 3 and not tracked) or any(
                    v > 0 for v in lp.last["drops"].values()):
                failed += 1
            i += 1
        window_s = time.perf_counter() - t0
    n_frames = len(lat)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    new_graphs = pipe.graph_stats()["graphs"] - captured
    if new_graphs:
        log(f"# WARNING: {new_graphs} stage graph(s) captured inside the "
            "window")
    run_frames = n_frames + (traced["frames"] * traced["tries"] if traced
                             else 0)
    host_calls = (calls["launch"] + calls["replay"]) / max(run_frames, 1)
    rendered = [lp.rendered(k) for k in index]
    del lp, pipe
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    held = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if held:
        log(f"# the process holds {held} after the window")
        raise SystemExit(3)

    if traffic["poses"] != "groundtruth":
        gt = np.stack([frames.pose(i) for i in index])
        log(f"# ATE RMSE over the window {compare.ate_rmse(poses, gt)!r} m "
            "(not compared: see PERF.md)")
    checks = judge(s, traffic, frames, samples, limits, dev)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    low = judge(s, traffic, frames, samples, limits, dev, step.bf16) \
        if control else None

    result = {"correct": correct, "attempted": n_frames, "failed": failed}
    if trace:
        ctx = dict(frames=traced["frames"], timeline=traced["timeline"],
                   launches=traced["launches"], host_calls=host_calls,
                   latency_ms=lat, rendered=rendered,
                   icp=icp_work(s, frames, traced, dev),
                   settings=s, traffic=traffic)
        metrics = {}
        for m in cell_metrics(bench, cell, "per_layer"):
            v = reader(m["name"], root)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        tl = traced["timeline"]
        device_info = dict(busy_s=tl.busy_us() / 1e6,
                           window_s=tl.window_us() / 1e6)
        result["breakdown"] = {"device_ops": tl.device_ops(),
                               "idle_gaps": tl.idle_gaps()}
    else:
        e2e = {"frames_per_s": n_frames / window_s,
               "frame_p95_ms": percentile(lat, 95), "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(bench, cell, "end_to_end")}
        device_info = {}
    result["metrics"] = metrics
    result["device"] = dict(
        platform="gpu" if dev.type == "cuda" else dev.type,
        kind=torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu", count=1, memory_peak_bytes=peak, **device_info)
    log(f"# window {window_s:.6f} s, {n_frames} frames, failed {failed}, "
        f"set-up {setup_s:.6f} s, {captured} stage graphs captured in it, "
        f"median frame {percentile(lat, 50):.6f} ms")
    if low is not None:
        result["control"] = low
    result["checks"] = checks
    return result


def trace_stretch(lp, first, traffic, _lib):
    """Run ``trace_frames`` frames from ``first`` under torch.profiler,
    copying each one's tracking inputs first; again, on the next frames,
    while the trace holds fewer of the port's kernels than were launched
    (traces have dropped launches), up to :data:`TRACE_TRIES` times."""
    from benchmark.trace import Timeline
    n = traffic["trace_frames"]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    lp.span = True
    for attempt in range(TRACE_TRIES):
        start = first + attempt * n
        inputs = []
        before = dict(_lib.LAUNCHES)
        with torch.profiler.profile(activities=acts) as prof:
            for i in range(start, start + n):
                with torch.profiler.record_function("bench.capture"):
                    p = lp.pipe
                    inputs.append((i, p.pose.clone(),
                                   p.raycast_pose.clone(), p.vertex.clone(),
                                   p.normal.clone(), p.valid.clone()))
                lp.frame(i)
        launched = {k: v - before[k] for k, v in _lib.LAUNCHES.items()
                    if v != before[k]}
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            tl = Timeline(path)
        seen = sum(1 for name, _ in tl.kernels() if name in _lib.LAUNCHES)
        want = sum(launched.values())
        if seen >= want:
            break
        print(f"# the trace holds {seen} of the port's kernels, {want} "
              f"were launched (try {attempt + 1} of {TRACE_TRIES})",
              file=sys.stderr)
    lp.span = False
    return dict(timeline=tl, frames=n, launches=launched, inputs=inputs,
                tries=attempt + 1)


def icp_work(s, frames, traced, dev):
    """The Gauss-Newton iterations each traced frame's tracking ran at each
    level, by the reference's ICP from the frame's own inputs (its depth,
    and the pose, raycast pose and raycast maps before it), and the
    pixels of each level: what ``icp_track``'s bound counts. None where
    the traffic does not track."""
    if s.get("tracking_rate", 1) != 1 or \
            traced["launches"].get("icp_track", 0) == 0:
        return None
    from benchmark.reference.frozen.kernels.frame import frame_mats_plain
    from benchmark.reference.frozen.kernels.icp import _icp_track_plain
    from benchmark.reference.frozen.constants import (
        DIST_THRESHOLD, NORMAL_THRESHOLD, TRACK_THRESHOLD)
    su = step.setup(s, dev)
    runs = []
    for i, pose, rpose, vertex, normal, valid in traced["inputs"]:
        _, pyr = step.preprocess(su, frames.depth(i))
        view = frame_mats_plain(su.k, rpose).view
        run = _icp_track_plain(pose, view, pyr[1], pyr[2], pyr[3], vertex,
                               normal, valid, su.pyramid, su.icp_threshold,
                               DIST_THRESHOLD, NORMAL_THRESHOLD,
                               TRACK_THRESHOLD)[4]
        runs.append([int(x) for x in run.tolist()])
    pixels = [int(v.shape[0] * v.shape[1]) for v in pyr[1]]
    return dict(runs=runs, pixels=pixels,
                ref_pixels=int(vertex.shape[0] * vertex.shape[1]))


def judge(s, traffic, frames, samples, limits, dev, quantise=step.identity):
    """The numbers that decide ``correct``, each with its limit: the
    sampled frames computed again by the reference (``quantise``: its
    precision) from the program's state before each, against what the
    program left after it; each number is the worst frame's."""
    su = step.setup(s, dev)
    got = {"pose_gap": 0.0, "map_off_pct": 0.0, "ray_off_pct": 0.0}
    render = traffic.get("render_every", 0) > 0
    if render:
        got["render_off_pct"] = 0.0
    gt_mode = traffic["poses"] == "groundtruth"
    for i, before, after, comp in samples:
        st = step.State(before["pose"], before["raycast_pose"],
                        before["vertex"], before["normal"], before["valid"],
                        clone_map(before["map"]), before["alloc_budget"])
        ref = step.frame(su, st, frames.depth(i), i,
                         gt_pose=frames.pose(i) if gt_mode else None,
                         render=comp is not None, quantise=quantise)
        if not gt_mode:
            got["pose_gap"] = max(got["pose_gap"], compare.pose_gap(
                after["pose"].cpu(), after["tracked"], ref["pose"],
                ref["tracked"]))
        got["map_off_pct"] = max(got["map_off_pct"], compare.map_off_pct(
            before["map"], after["map"], ref["map"]))
        got["ray_off_pct"] = max(got["ray_off_pct"], compare.ray_off_pct(
            (after["vertex"].cpu(), after["normal"].cpu(),
             after["valid"].cpu()),
            (ref["vertex"], ref["normal"], ref["valid"])))
        if comp is not None:
            got["render_off_pct"] = max(got["render_off_pct"],
                                        compare.render_off_pct(
                                            comp, ref["composite"]))
        del ref, st
    if gt_mode:
        del got["pose_gap"]
    return {k: {"value": v, "limit": limits[k]} for k, v in got.items()}


def check_lines(checks):
    return [f"check {k}: {c['value']!r} (limit {c['limit']!r})"
            for k, c in checks.items()]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    _, cell, _, _, _ = load_cell(args.workload)
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    for line in card_lines(0):
        print(line, file=sys.stderr, flush=True)
    result = run(args.workload, args.seed, args.seconds, args.trace)
    for line in check_lines(result["checks"]):
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
