"""Headline benchmark of the port: frames a second of the fused frame step
on the card.

    python -m supereight_tpu_torch.tools.bench [--field tsdf|ofusion]

The counterpart of the JAX package's root ``bench.py``, at its
configuration (the reference's ICL-NUIM traj2 setup: 640x480 input at
compute ratio 2, so 320x240 with halved intrinsics, 512^3 voxels over
4.8 m, pool 36,864 blocks, worklist budget 8,192, ICP 10/5/4, every frame
tracked and integrated; TSDF at mu 0.1, OFusion at mu 0.008) on its
synthetic orbit: 3 warm-up frames (the first builds the kernels and
captures the frame's CUDA graph), 20 sequence frames, then the timed
window of the 20 distinct frames 23-42.

The frames run as JAX's do, one program a frame: ``parallel/step.
FrameProgram``, the frame step captured once as a CUDA graph and replayed
(a frame's depth and index copied into its buffers first). The value is
stream time: N_TIMED over the seconds between a CUDA event recorded on
the stream at the start of frame 23 and one after frame 42. JAX's bench
divides by the device time of its one compiled program a frame; a frame
that waits on the host is slower than its kernels, so the port's metric
(``gpu`` where JAX's says ``chip``) times the stream, host gaps included.
The device's busy time comes from a replay of the timed frames, from a
copy of the state before them, under ``torch.profiler``
(``utils/deviceprof.py``), and goes to stderr with the run's blocks,
final position error, drop counters, launches a frame, the split of a
replayed frame (busy, idle inside it, gaps between frames) and the
host's time a call. Then the same 43 frames through the
eager ``frame_step`` (13 launches a frame from the host), from a fresh
state in the same process: its fps by the same events, and whether its
final pose and blocks equal the graph's, go to stderr.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": "fps", "vs_baseline": N}
vs_baseline is against 30 fps, the real-time rate the reference claims.

The bench times the card and nothing else: without a CUDA device it
exits non-zero and prints no JSON line, and a kernel that fails to build
or launch fails the run.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

from supereight_tpu_torch.core.map import MapGeometry
from supereight_tpu_torch.fields import get_field
from supereight_tpu_torch.parallel import step
from supereight_tpu_torch.tools import dist_run

# ---- the configuration of the JAX bench (bench.py:33-40,50,60-81) -----
W, H = 320, 240
SIZE = 512           # voxels per side
DIM = 4.8            # meters
CAPACITY = 36864     # voxel blocks
N_WARMUP = 3
N_FRAMES = 20
N_TIMED = 20         # distinct frames in the timed window
N_TOTAL = N_WARMUP + N_FRAMES + N_TIMED
BASELINE_FPS = 30.0
MU = {"tsdf": 0.1, "ofusion": 0.008}
# traj2's intrinsics (481.2, -480, 320, 240) at compute ratio 2; the
# synthetic scene is +y-down, so fy > 0
K = (240.6, 240.0, 160.0, 120.0)
BUDGET = 8192        # integration worklist and raycast pool bucket
ITERATIONS = (10, 5, 4)
ICP_THRESHOLD = 1e-5
# the orbit about the volume's centre: its radius and the sphere's as
# fractions of the volume's side, its angle span in radians, and the
# room's walls this many meters inside the volume
RADIUS, SPHERE_RADIUS, ANGLE_SPAN, ROOM_MARGIN = 0.3, 0.15, 0.5, 0.55
FIELDS = tuple(MU)
PROFILE_TRIES = 3    # profiled replays before a short trace is reported
DROPS = ("alloc_overflow", "blocks_truncated", "patch_skipped",
         "mip_skipped", "ray_overflow", "pool_bucket_overflow")


def scene(*, size=SIZE, dim=DIM, capacity=CAPACITY, frame_size=(W, H),
          n_frames=N_TOTAL):
    """The bench scene (orbit, map and tracking) as the dict
    ``tools/dist_run.py`` takes. The overrides shrink it for CPU tests;
    the intrinsics scale with the frame's width."""
    w, h = frame_size
    return dict(width=w, height=h, k=tuple(c * (w / W) for c in K),
                size=size, dim=dim, capacity=capacity,
                iterations=ITERATIONS, frames=n_frames,
                radius=RADIUS * dim, center=dim / 2,
                sphere_radius=SPHERE_RADIUS * dim, angle_span=ANGLE_SPAN,
                room=(ROOM_MARGIN, dim - ROOM_MARGIN))


class Bench(NamedTuple):
    """One field's bench run: the map's geometry, the field, the orbit's
    depths (numpy and on the device) and poses, the intrinsics on the
    device and ``frame_step``'s keywords (``mu`` among them)."""

    geom: MapGeometry
    field: object
    depths: np.ndarray   # f32[N, H, W] meters
    poses: np.ndarray    # f32[N, 4, 4] camera-to-world, ground truth
    frames: list         # the depths as tensors on the device
    k: torch.Tensor
    kw: dict

    def init(self):
        """The state before frame 0, on the bench's device."""
        return step.init_frame_state(self.geom, self.field,
                                     self.kw["frame_size"], self.poses[0],
                                     self.k.device)

    def frame(self, state, i):
        """Frame ``i`` of the orbit through the eager step: (new state,
        aux). The map is updated in place."""
        return step.frame_step(self.geom, self.field, state, self.frames[i],
                               self.k, i, **self.kw)

    def program(self):
        """A frame program (``step.FrameProgram``) that owns a fresh
        state before frame 0."""
        return step.FrameProgram(self.geom, self.field, self.init())

    def graph_frame(self, prog, i):
        """Frame ``i`` of the orbit through ``prog``: (its state, aux),
        both rewritten by its next call."""
        return prog(self.frames[i], self.k, i, **self.kw)


def config(field_name="tsdf", device="cuda", **overrides):
    """The bench of ``field_name`` on ``device``; ``overrides`` are
    :func:`scene`'s (the CLI has none)."""
    s = scene(**overrides)
    geom = MapGeometry(size=s["size"], dim=s["dim"], capacity=s["capacity"])
    depths, poses = dist_run.scene_frames(s)
    kw = dict(frame_size=(s["width"], s["height"]), iterations=ITERATIONS,
              mu=MU[field_name], icp_threshold=ICP_THRESHOLD, neg_y=False,
              filter_input=False, use_gt_pose=False, integration_rate=1,
              tracking_rate=1,
              budget=step.integration_budget(geom, BUDGET))
    return Bench(geom, get_field(field_name), depths, poses,
                 [torch.from_numpy(d).to(device) for d in depths],
                 torch.tensor(s["k"], dtype=torch.float32, device=device),
                 kw)


def clone_map(m):
    return type(m)(*(tuple(x.clone() for x in v) if isinstance(v, tuple)
                     else v.clone() for v in m))


def clone_state(s):
    """A copy of a frame state that the next frame leaves alone: the map
    updates in place, and a frame program rewrites every leaf."""
    return type(s)(clone_map(s.map), *(x.clone() for x in s[1:]))


def card():
    """``nvidia-smi``'s name and power limit of the card, else its name."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(0)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def profile_window(frame, first, last):
    """Run frames ``first``..``last`` - 1 (``frame(i)``, from the state
    the caller set up) under torch.profiler (CPU and CUDA), the first as
    the profiler's warm-up step (the device trace drops the first
    launches after it starts); returns the device events of the others
    (``deviceprof.device_events``)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from supereight_tpu_torch.utils import deviceprof
    fd, trace = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1,
                                       active=last - first - 1, repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(trace)
                     ) as prof:
            for i in range(first, last):
                frame(i)
                if i in (first, last - 1):
                    torch.cuda.synchronize()
                prof.step()
        return deviceprof.device_events(trace)
    finally:
        os.remove(trace)


def timed_window(run_frame, first, last):
    """Frames ``first``..``last`` - 1 through ``run_frame(i)`` between
    CUDA events, one at each frame's start and one after the last (the
    device reaches them in stream order): (window ms, the frames' ms
    sorted, the host's seconds inside each call, sorted)."""
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(last - first + 1)]
    host = []
    for i in range(first, last):
        marks[i - first].record()
        t0 = time.perf_counter()
        run_frame(i)
        host.append(time.perf_counter() - t0)
    marks[-1].record()
    torch.cuda.synchronize()
    frame_ms = sorted(a.elapsed_time(c) for a, c in zip(marks, marks[1:]))
    return marks[0].elapsed_time(marks[-1]), frame_ms, sorted(host)


def spread(frame_ms):
    return (f"per frame median {statistics.median(frame_ms):.3f} ms, min "
            f"{frame_ms[0]:.3f}, max {frame_ms[-1]:.3f} (max / median "
            f"{frame_ms[-1] / statistics.median(frame_ms):.2f})")


def run(field_name, device):
    """The bench of one field on a CUDA ``device``; returns its JSON
    dict and prints the rest on stderr."""
    from supereight_tpu_torch.kernels import _lib
    from supereight_tpu_torch.utils import deviceprof
    log(f"# card: {card()}")
    log("generating synthetic sequence...")
    b = config(field_name, device)
    first = N_WARMUP + N_FRAMES
    prog = b.program()
    torch.cuda.synchronize()
    _lib.reset_launches()

    log("warmup/build/capture...")
    for i in range(N_WARMUP):
        t0 = time.perf_counter()
        state, aux = b.graph_frame(prog, i)
        torch.cuda.synchronize()
        log(f"  warmup frame {i}: {time.perf_counter() - t0:.3f}s")
        if i == 0:
            log(f"  kernel build: nvcc "
                f"{_lib.build_info.get('seconds', 0.0):.1f} s, "
                f"cached={_lib.build_info.get('cached')}")

    log("sequence...")
    t0 = time.perf_counter()
    for i in range(N_WARMUP, first):
        if i == first - 1:
            snapshot = clone_state(state)  # for the profiled replay
        state, aux = b.graph_frame(prog, i)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0

    log(f"timing (CUDA events, {N_TIMED} distinct frames, one graph replay "
        f"each)...")
    window_ms, frame_ms, host = timed_window(
        lambda i: b.graph_frame(prog, i), first, N_TOTAL)
    launches = {k: v for k, v in _lib.LAUNCHES.items() if v}
    fps = N_TIMED / (window_ms / 1e3)
    log(f"# event timing: {N_TIMED} frames in {window_ms:.3f} ms, "
        f"{window_ms / N_TIMED:.3f} ms/frame; {spread(frame_ms)}; host "
        f"{statistics.median(host) * 1e6:.1f} us a call (median)")

    aux = {k: int(v) for k, v in zip(step.AUX_SCALARS,
                                     aux["scalars"].tolist())}
    tracked = bool(aux["tracked"])
    n_blocks = int(state.map.n_blocks)
    pose = state.pose.cpu().numpy()
    pos_err = float(np.linalg.norm(pose[:3, 3] - b.poses[-1][:3, 3]))
    drops = {c: aux[c] for c in DROPS}
    log(f"# {N_FRAMES} frames in {dt:.3f}s, blocks={n_blocks}, "
        f"tracked={tracked}, final pos err={pos_err:.4f} m, "
        f"drops={drops}")
    per_frame = sum(launches.values()) / N_TOTAL
    log("# launches " + json.dumps({"frames": N_TOTAL, "total": launches,
                                    "per_frame": per_frame}))

    # a trace that missed events (the device trace can drop a window's
    # first ones) is taken again, up to PROFILE_TRIES times; a frame is
    # its kernels and the program's own copies
    key = step.static_key(**b.kw)
    want = N_TIMED * (per_frame + prog.ops(key))
    for attempt in range(PROFILE_TRIES):
        prog.load(snapshot)
        events = profile_window(lambda i: b.graph_frame(prog, i), first - 1,
                                N_TOTAL)
        if len(events) >= want:
            break
        log(f"# the device trace holds {len(events)} kernels and copies, "
            f"{want:g} were run (try {attempt + 1} of {PROFILE_TRIES})")
    busy_ms = sum(d for _, d in events) / 1e3 / N_TIMED
    log(f"# device trace: busy {busy_ms:.3f} ms/frame in "
        f"{len(events) / N_TIMED:.2f} kernels and copies a frame "
        f"({per_frame:g} launches and {prog.ops(key)} of the program's "
        f"own); busy share of the event-timed "
        f"{window_ms / N_TIMED:.3f} ms/frame: "
        f"{busy_ms / (window_ms / N_TIMED):.4f}")
    split = deviceprof.frame_split(events, N_TIMED)
    if split:
        log(f"# replayed frame split: busy {split['busy_us']:.2f} us, "
            f"span {split['span_us']:.2f} us (idle inside it "
            f"{split['inside_us']:.2f}: the gaps between the graph's "
            f"nodes, and any wait for the host after the input copies), "
            f"between frames {split['between_us']:.2f} us, "
            f"{split['events']} events")
    if len(events) < want:
        log(f"# WARNING: the device trace holds {len(events)} kernels and "
            f"copies, fewer than the {want:g} run: the busy time above is "
            f"short of the window's")

    # the eager step over the same frames, in this process
    log("eager frame_step over the same frames...")
    eager = [b.init()]

    def eager_frame(i):
        eager[0], _ = b.frame(eager[0], i)
    for i in range(first):
        eager_frame(i)
    ewin, eframe, ehost = timed_window(eager_frame, first, N_TOTAL)
    estate = eager[0]
    same = (int(estate.map.n_blocks) == n_blocks
            and torch.equal(estate.pose, state.pose))
    log(f"# eager step: {N_TIMED / (ewin / 1e3):.3f} fps, "
        f"{ewin / N_TIMED:.3f} ms/frame; {spread(eframe)}; host "
        f"{statistics.median(ehost) * 1e6:.1f} us a call (median); its "
        f"final pose and blocks equal to the graph's: {same}")
    value = round(fps, 3)
    return {"metric": f"frames_per_sec_gpu_traj2cfg_c2_512v_{field_name}_icp",
            "value": value, "unit": "fps",
            "vs_baseline": round(value / BASELINE_FPS, 3)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--field", choices=FIELDS, default="tsdf")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("bench: no CUDA device; the bench times the card and runs "
            "nowhere else")
        return 2
    print(json.dumps(run(args.field, torch.device("cuda", 0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
