"""Headline benchmark of the port: frames a second of the fused frame step
on the card.

    python -m supereight_tpu_torch.tools.bench [--field tsdf|ofusion]

The counterpart of the JAX package's root ``bench.py``, at its
configuration (the reference's ICL-NUIM traj2 setup: 640x480 input at
compute ratio 2, so 320x240 with halved intrinsics, 512^3 voxels over
4.8 m, pool 36,864 blocks, worklist budget 8,192, ICP 10/5/4, every frame
tracked and integrated; TSDF at mu 0.1, OFusion at mu 0.008) on its
synthetic orbit: 3 warm-up frames (the first builds the kernels), 20
sequence frames, then the timed window of the 20 distinct frames 23-42.

The value is stream time: N_TIMED over the seconds between a CUDA event
recorded on the stream at the start of frame 23 and one after frame 42.
JAX's bench divides by the device time of its one compiled program a
frame; the port launches 13 kernels a frame from the host, and a frame
that waits on the host is slower than its kernels, so the port's metric
(``gpu`` where JAX's says ``chip``) times the stream, host gaps included.
The device's busy time comes from a replay of the timed frames, from a
copy of the state before them, under ``torch.profiler``
(``utils/deviceprof.py``), and goes to stderr with the run's blocks,
final position error, drop counters and launches a frame.

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
        """Frame ``i`` of the orbit: (new state, aux). The map is updated
        in place."""
        return step.frame_step(self.geom, self.field, state, self.frames[i],
                               self.k, i, **self.kw)


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
    """A copy of a frame state that the next frame's in-place update of
    the map leaves alone."""
    return s._replace(map=clone_map(s.map), pose=s.pose.clone(),
                      raycast_pose=s.raycast_pose.clone())


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


def profile_window(b, snapshot, first):
    """Replay frames ``first``..end from ``snapshot`` under torch.profiler
    (CPU and CUDA), the frame before them as the profiler's warm-up step
    (the device trace drops the first launches after it starts); returns
    the device's (seconds, events) over the replayed window."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from supereight_tpu_torch.utils import deviceprof
    fd, trace = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        replay = clone_state(snapshot)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1,
                                       active=len(b.frames) - first,
                                       repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(trace)
                     ) as prof:
            for i in range(first - 1, len(b.frames)):
                replay, _ = b.frame(replay, i)
                if i in (first - 1, len(b.frames) - 1):
                    torch.cuda.synchronize()
                prof.step()
        return deviceprof.device_seconds(trace)
    finally:
        os.remove(trace)


def run(field_name, device):
    """The bench of one field on a CUDA ``device``; returns its JSON
    dict and prints the rest on stderr."""
    from supereight_tpu_torch.kernels import _lib
    log(f"# card: {card()}")
    log("generating synthetic sequence...")
    b = config(field_name, device)
    first = N_WARMUP + N_FRAMES
    state = b.init()
    torch.cuda.synchronize()
    _lib.reset_launches()

    log("warmup/build...")
    for i in range(N_WARMUP):
        t0 = time.perf_counter()
        state, aux = b.frame(state, i)
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
        state, aux = b.frame(state, i)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0

    # the timed window: an event at each frame's start and one after the
    # last; the device reaches them in stream order
    log(f"timing (CUDA events, {N_TIMED} distinct frames)...")
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(N_TIMED + 1)]
    for i in range(first, N_TOTAL):
        marks[i - first].record()
        state, aux = b.frame(state, i)
    marks[-1].record()
    torch.cuda.synchronize()
    launches = {k: v for k, v in _lib.LAUNCHES.items() if v}
    window_ms = marks[0].elapsed_time(marks[-1])
    fps = N_TIMED / (window_ms / 1e3)
    frame_ms = sorted(a.elapsed_time(c) for a, c in zip(marks, marks[1:]))
    log(f"# event timing: {N_TIMED} frames in {window_ms:.3f} ms, "
        f"{window_ms / N_TIMED:.3f} ms/frame; per frame median "
        f"{statistics.median(frame_ms):.3f} ms, min {frame_ms[0]:.3f}, "
        f"max {frame_ms[-1]:.3f}")

    tracked = bool(aux["tracked"])
    n_blocks = int(state.map.n_blocks)
    pos_err = float(np.linalg.norm(
        state.pose.cpu().numpy()[:3, 3] - b.poses[-1][:3, 3]))
    drops = {c: int(aux[c]) for c in DROPS}
    log(f"# {N_FRAMES} frames in {dt:.3f}s, blocks={n_blocks}, "
        f"tracked={tracked}, final pos err={pos_err:.4f} m, "
        f"drops={drops}")
    per_frame = sum(launches.values()) / N_TOTAL
    log("# launches " + json.dumps({"frames": N_TOTAL, "total": launches,
                                    "per_frame": per_frame}))

    # a trace that missed launches (the device trace can drop a window's
    # first ones) is taken again, up to PROFILE_TRIES times
    for attempt in range(PROFILE_TRIES):
        busy_s, n_events = profile_window(b, snapshot, first)
        if n_events >= N_TIMED * per_frame:
            break
        log(f"# the device trace holds {n_events} kernels and copies, "
            f"{N_TIMED} x {per_frame:g} were launched (try {attempt + 1} "
            f"of {PROFILE_TRIES})")
    busy_ms = busy_s * 1e3 / N_TIMED
    log(f"# device trace: busy {busy_ms:.3f} ms/frame in "
        f"{n_events / N_TIMED:.2f} kernels and copies a frame; busy share "
        f"of the event-timed {window_ms / N_TIMED:.3f} ms/frame: "
        f"{busy_ms / (window_ms / N_TIMED):.4f}")
    if n_events < N_TIMED * per_frame:
        log(f"# WARNING: the device trace holds {n_events} kernels and "
            f"copies, fewer than the {N_TIMED} x {per_frame:g} launched: "
            f"the busy time above is short of the window's")
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
