"""K9 ``ba_solve`` against its twin on synthetic pose-graph windows.

    python -m supereight_tpu_torch.tools.ba_windows [--nodes 4 17 ... 512] \\
        [--reps 10] [--iters 10]
    python -m supereight_tpu_torch.tools.ba_windows --timeline --nodes 17 64
    python -m supereight_tpu_torch.tools.ba_windows --split [--reps 20]
    python -m supereight_tpu_torch.tools.ba_windows --tier-l [--split] ...

For each window size n it builds :func:`window` (n nodes, 2n edge slots,
at least 128), runs ``kernels/ba.ba_solve`` once to build and warm it,
then times ``reps`` calls between CUDA events (one launch each: the
kernel's device time) and one call of the twin ``ba_solve_plain`` (after a
warm call), and prints one JSON object a line: n, the kernel's tier, the
slots, the valid edges, the kernel's and the twin's ms, their ratio, the
largest pose difference, and the yardstick of the factor and
substitution phases: ``torch.linalg.cholesky_ex`` and ``cholesky_solve``
on an SPD f32 matrix of the window's 6n rows, ``iters`` times (a library
call K9 never makes). The card's name and power limit come first. It
runs only on the card, and exits 2 without one.

``--timeline`` splits the kernel's device time at each window of
``--nodes`` by phase (:func:`timeline`: a :func:`side_build` of
``csrc/ba.cu`` with time marks). ``--tier-l`` runs any of these with a
side build that puts every window in Tier L, so that Tier L can be timed
beside Tier S at Tier S's windows.

``--split`` times where the keyframe manager's host time goes around one
solve (:func:`host_split`) at the BA loop's windows (n = 4, 8, 12, 16 of
128 slots). It uses only what the keyframe manager, ``ba._check`` and
``_lib.launch`` have had since K9 was first ported, so it also runs over
an older checkout: ``PYTHONPATH=<checkout> python3
supereight_tpu_torch/tools/ba_windows.py --split`` by path.

``chip_smoke.py`` and ``tests/test_torch_ba.py`` take their windows from
:func:`window`, :func:`gaugeless` and :func:`nan_slot`.
"""

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from supereight_tpu_torch.core import se3
from supereight_tpu_torch.posegraph.graph import PoseGraph

# the default sweep: the loop's windows, the CLI's default (32), both
# sides of Tier S's edge on the H100 (39, 40), then Tier L
NODES = (4, 17, 32, 39, 40, 64, 128, 160, 256, 512)
# the BA loop's windows (chip_smoke.py's pipeline-tsdf-ba: 4 solves)
SPLIT_NODES = (4, 8, 12, 16)
SPLIT_SLOTS = 128  # posegraph/keyframes.KeyframeManager's max_edges


def _to(device, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def _window_arrays(n, cap, seed):
    """:func:`window`'s arrays on the host (numpy)."""
    rng = np.random.default_rng(seed)

    def rand_poses(k, scale):
        tw = (rng.normal(size=(k, 6)) * scale).astype(np.float32)
        return se3.exp(torch.from_numpy(tw)).numpy()

    steps = rand_poses(n, 0.1)
    gt = [np.eye(4, dtype=np.float32)]
    for k in range(1, n):
        gt.append(gt[-1] @ steps[k])
    noise = rand_poses(n, 0.02)
    est = np.stack([g @ noise[k] for k, g in enumerate(gt)])
    edges = [(k, k + 1, rng.uniform(1, 20)) for k in range(n - 1)]
    for _ in range(n // 4 if n > 2 else 0):
        a = int(rng.integers(0, n - 2))
        edges.append((a, int(rng.integers(a + 2, n)), rng.uniform(1, 50)))
    if len(edges) > cap:
        raise ValueError(f"window: {len(edges)} edges over the cap {cap}")
    i = rng.integers(0, n, cap).astype(np.int32)
    j = rng.integers(0, n, cap).astype(np.int32)
    t_meas = rand_poses(cap, 1.0)
    w = rng.uniform(0, 100, cap).astype(np.float32)
    valid = np.zeros(cap, bool)
    for k, (a, b, wt) in enumerate(edges):
        i[k], j[k], w[k], valid[k] = a, b, wt, True
        t_meas[k] = np.linalg.inv(gt[a]) @ gt[b]
    fixed = np.zeros(n, bool)
    fixed[5::8] = True
    return (est.astype(np.float32), i, j, t_meas.astype(np.float32), w,
            valid, fixed)


def window(n, cap, seed, device):
    """A synthetic pose-graph window: a ground-truth random walk of n
    keyframes, estimates with drift, odometry edges weighted 1 to 20,
    n // 4 loop closures between non-consecutive nodes weighted 1 to 50,
    every 8th node from node 5 on frozen, and the edges padded to cap
    with garbage (random measurements, nodes and weights, valid False).
    Returns (poses f32[n, 4, 4], PoseGraph, fixed bool[n]) on device."""
    poses, i, j, t_meas, w, valid, fixed = _to(
        device, *_window_arrays(n, cap, seed))
    return poses, PoseGraph(i, j, t_meas, w, valid), fixed


def nan_slot(n, cap, seed, device, slot=None):
    """:func:`window` with a NaN in the measurement of one padded slot
    (the last one unless ``slot``): JAX scales the slot's residual and
    Jacobian by ``where(valid, w, 0)``, and 0 times NaN is NaN, so H and
    every pose become NaN in JAX, the twin and the kernel."""
    poses, graph, fixed = window(n, cap, seed, device)
    slot = cap - 1 if slot is None else slot
    if bool(graph.valid[slot]):
        raise ValueError(f"nan_slot: slot {slot} holds a valid edge")
    t_meas = graph.t_meas.clone()
    t_meas[slot, 1, 3] = float("nan")
    return poses, graph._replace(t_meas=t_meas), fixed


def gaugeless(device):
    """tests/test_torch_posegraph.py's window whose free nodes have lost
    every edge to a fixed one (6 nodes, edges among nodes 1-5, 8 slots):
    singular but for the damping, so the factorisation fails and every
    pose is NaN in JAX, the twin and the kernel."""
    rng = np.random.default_rng(2)
    tw = (rng.normal(size=(6, 6)) * 0.3).astype(np.float32)
    poses = se3.exp(torch.from_numpy(tw)).numpy()
    cap = 8
    i = np.zeros(cap, np.int32)
    j = np.zeros(cap, np.int32)
    t_meas = np.tile(np.eye(4, dtype=np.float32), (cap, 1, 1))
    w = np.zeros(cap, np.float32)
    valid = np.zeros(cap, bool)
    for k, (a, b, wt) in enumerate(((1, 2, 22.0), (2, 3, 44.0), (3, 4, 69.3),
                                    (4, 5, 50.6), (2, 5, 3.0))):
        i[k], j[k], w[k], valid[k] = a, b, wt, True
        t_meas[k] = np.linalg.inv(poses[a]) @ poses[b]
    poses, i, j, t_meas, w, valid = _to(device, poses, i, j, t_meas, w,
                                        valid)
    return poses, PoseGraph(i, j, t_meas, w, valid), None


def _ms(fn, reps):
    """Mean ms a call of fn() over reps calls between CUDA events, after
    one call to build and warm it."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cholesky_ms(n6, iters, seed=0):
    """ms of ``iters`` rounds of ``torch.linalg.cholesky_ex`` and
    ``cholesky_solve`` on an SPD f32 matrix of n6 rows (X X^T / n6 + I)
    on the card, TF32 off: the library's time for the factor and
    substitution phases of a solve, a yardstick K9 never calls."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n6, n6, device="cuda", generator=g)
    h = x @ x.T / n6 + torch.eye(n6, device="cuda")
    b = torch.randn(n6, 1, device="cuda", generator=g)

    def solve():
        for _ in range(iters):
            L, _ = torch.linalg.cholesky_ex(h)
            torch.cholesky_solve(b, L)
    return _ms(solve, 3)


def time_window(n, reps, iters, seed=0):
    """One window's row: the kernel's tier and ms (mean of ``reps``
    calls), the twin's (one call), the largest pose difference and the
    factor's library yardstick (:func:`cholesky_ms`)."""
    from supereight_tpu_torch.kernels import ba
    poses, graph, fixed = window(n, max(128, 2 * n), seed, "cuda")
    args = (poses, graph, n, iters, 1e-6, fixed)
    ms = _ms(lambda: ba.ba_solve(*args), reps)
    plain_ms = _ms(lambda: ba.ba_solve_plain(*args), 1)
    err = float((ba.ba_solve(*args) - ba.ba_solve_plain(*args)).abs().max())
    return dict(n=n, tier=ba.plan(n, graph.i.shape[0], poses.device).tier,
                slots=graph.i.shape[0], edges=int(graph.valid.sum()),
                iters=iters, ms=ms, plain_ms=plain_ms,
                kernel_over_twin=ms / plain_ms, max_abs_err=err,
                cholesky_ms=cholesky_ms(6 * n, iters))


# --timeline: the phase of each SE_MARK(k) in csrc/ba.cu, which a side
# build with SE_BA_TIMELINE turns into a read of the device's global timer
# by CTA 0's thread 0: the time from the mark before to mark k is PHASES[k]'s.
# Tier S has no "L ..." marks, Tier L no "S ..." one; "L wait" is the lead
# CTA's wait for the trailing tiles.
PHASES = ("set-up", "lists", "lists", "lists", "dual pass",
          "normal equations", "first diagonal block", "column solve",
          "L lead's block update", "L lead's diagonal block", "L wait",
          "S update and diagonal block", "backward step", "poses")
_MARKS = 1 << 16  # csrc/ba.cu's kMarks


def side_build(timeline=False, tier_l=False):
    """csrc/ba.cu built on its own (``sharded_kernels.build_sources``)
    with the time marks (``SE_BA_TIMELINE``) and with Tier L for every
    window (``SE_BA_TIER_L``), as asked; the wrappers use it within
    ``sharded_kernels.using``."""
    from supereight_tpu_torch.kernels import _lib
    from supereight_tpu_torch.tools import sharded_kernels as sk
    text = "".join(f"#define {name}\n" for name, on in (
        ("SE_BA_TIMELINE", timeline), ("SE_BA_TIER_L", tier_l)) if on)
    text += (_lib.CSRC / "ba.cu").read_text()
    return sk.build_sources({"ba_side": ("ba.cu", text)})["ba_side"]


def timeline(lib, ns, iters):
    """Where a solve's device time goes, per window of ``ns``: one solve
    with ``lib`` (a :func:`side_build` with the marks, in use) after a warm
    one; per phase (:data:`PHASES`) the µs summed over the solve, the marks
    and the µs a mark."""
    import ctypes
    from supereight_tpu_torch.kernels import ba
    lib.se_ba_timeline.argtypes = [ctypes.c_void_p] * 3
    t = (ctypes.c_ulonglong * _MARKS)()
    k = (ctypes.c_int * _MARKS)()
    m = ctypes.c_int()
    rows = []
    for n in ns:
        poses, graph, fixed = window(n, max(128, 2 * n), 0, "cuda")
        for _ in range(2):  # the first builds and warms
            ba.ba_solve(poses, graph, n, iters, 1e-6, fixed)
            torch.cuda.synchronize()
            err = lib.se_ba_timeline(ctypes.addressof(t),
                                     ctypes.addressof(k),
                                     ctypes.addressof(m))
            if err != 0:
                raise RuntimeError(f"se_ba_timeline: error {err}")
        phases = {}
        for x in range(1, m.value):
            us, count = phases.get(PHASES[k[x]], (0.0, 0))
            phases[PHASES[k[x]]] = (us + (t[x] - t[x - 1]) / 1e3, count + 1)
        rows.append(dict(
            n=n, tier=ba.plan(n, graph.i.shape[0], poses.device).tier,
            iters=iters, us=(t[m.value - 1] - t[0]) / 1e3,
            phases={p: dict(us=us, marks=c, us_a_mark=us / c)
                    for p, (us, c) in phases.items()}))
    return rows


def manager(n, cap, seed, device):
    """A ``KeyframeManager`` on ``device`` holding :func:`window`'s n
    keyframes and its valid edges, ``max_edges`` = cap."""
    from supereight_tpu_torch.posegraph.keyframes import KeyframeManager
    poses, i, j, t_meas, w, valid, fixed = _window_arrays(n, cap, seed)
    km = KeyframeManager(window=max(n, 32), max_edges=cap, device=device)
    km.poses = list(poses)
    km.orig_poses = [p.copy() for p in poses]
    km.frames = list(range(n))
    km.pinned = [False] * n
    km.frozen = [bool(f) for f in fixed]
    km.edges = [(int(i[k]), int(j[k]), t_meas[k], float(w[k]))
                for k in np.flatnonzero(valid)]
    return km


def host_split(n, cap, reps, seed=0):
    """Where ``KeyframeManager.optimize``'s host time goes around one
    solve, median ms over ``reps`` calls: ``uploads`` (the manager's
    arrays built and copied to the card, up to ``ba._check``), ``range``
    (``ba._check``: the edge nodes' range read back to the host),
    ``launch`` (the scratch and the launch, up to ``_lib.launch``'s
    return), ``read`` (from there to the poses on the host: the kernel's
    device time and the copy back) and ``total``; ``device`` is the
    kernel's time between CUDA events around the launch."""
    from supereight_tpu_torch.kernels import _lib, ba
    km = manager(n, cap, seed, "cuda")
    marks = {}
    check, launch = ba._check, _lib.launch

    def timed_check(*a, **kw):
        marks["check0"] = time.perf_counter()
        out = check(*a, **kw)
        marks["check1"] = time.perf_counter()
        return out

    def timed_launch(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch(*a, **kw)
        end.record()
        marks["events"] = (start, end)
        marks["launch1"] = time.perf_counter()

    poses0 = [p.copy() for p in km.poses]
    rows = []
    ba._check, _lib.launch = timed_check, timed_launch
    try:
        for rep in range(reps + 1):
            km.poses = [p.copy() for p in poses0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            km.optimize()
            t1 = time.perf_counter()
            start, end = marks["events"]
            if rep:  # the first call builds and warms
                rows.append(dict(
                    uploads=marks["check0"] - t0,
                    range=marks["check1"] - marks["check0"],
                    launch=marks["launch1"] - marks["check1"],
                    read=t1 - marks["launch1"], total=t1 - t0,
                    device=start.elapsed_time(end) / 1e3))
    finally:
        ba._check, _lib.launch = check, launch
    return dict(n=n, slots=cap, edges=len(km.edges), reps=reps,
                **{k: 1e3 * statistics.median(r[k] for r in rows)
                   for k in rows[0]})


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="supereight-tpu-torch-ba-windows")
    ap.add_argument("--nodes", type=int, nargs="+", default=list(NODES))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--split", action="store_true",
                    help="the keyframe manager's host split at the BA "
                         "loop's windows")
    ap.add_argument("--timeline", action="store_true",
                    help="the kernel's device time by phase (a side build "
                         "with time marks)")
    ap.add_argument("--tier-l", action="store_true",
                    help="every window in Tier L (a side build), to time it "
                         "beside Tier S")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ba_windows: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    lib = None
    if args.timeline or args.tier_l:
        lib = side_build(args.timeline, args.tier_l)
    from supereight_tpu_torch.tools import sharded_kernels as sk
    with sk.using(lib) if lib else contextlib.nullcontext():
        if args.split:
            rows = (host_split(n, SPLIT_SLOTS, max(args.reps, 5))
                    for n in SPLIT_NODES)
        elif args.timeline:
            rows = timeline(lib, args.nodes, args.iters)
        else:
            rows = (time_window(n, args.reps, args.iters)
                    for n in args.nodes)
        for row in rows:
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
