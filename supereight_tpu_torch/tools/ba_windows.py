"""K9 ``ba_solve`` against its twin on synthetic pose-graph windows.

    python -m supereight_tpu_torch.tools.ba_windows [--nodes 64 128 256] \\
        [--reps 3] [--iters 10]

For each window size n it builds :func:`window` (n nodes, 2n edge slots,
at least 128), runs ``kernels/ba.ba_solve`` once to build and warm it,
then times ``reps`` calls between CUDA events (one launch each: the
kernel's device time) and one call of the twin ``ba_solve_plain`` (after a
warm call), and prints one JSON object a line: n, the slots, the valid
edges, the kernel's and the twin's ms, their ratio and the largest pose
difference. The card's name and power limit come first. It runs only on
the card, and exits 2 without one.

``chip_smoke.py`` and ``tests/test_torch_ba.py`` take their windows from
:func:`window` and :func:`gaugeless`.
"""

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from supereight_tpu_torch.core import se3
from supereight_tpu_torch.posegraph.graph import PoseGraph


def _to(device, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def window(n, cap, seed, device):
    """A synthetic pose-graph window: a ground-truth random walk of n
    keyframes, estimates with drift, odometry edges weighted 1 to 20,
    n // 4 loop closures between non-consecutive nodes weighted 1 to 50,
    every 8th node from node 5 on frozen, and the edges padded to cap
    with garbage (random measurements, nodes and weights, valid False).
    Returns (poses f32[n, 4, 4], PoseGraph, fixed bool[n]) on device."""
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
    poses, i, j, t_meas, w, valid, fixed = _to(
        device, est.astype(np.float32), i, j, t_meas.astype(np.float32), w,
        valid, fixed)
    return poses, PoseGraph(i, j, t_meas, w, valid), fixed


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


def time_window(n, reps, iters, seed=0):
    """One window's row: the kernel's ms (mean of ``reps`` calls), the
    twin's (one call) and the largest pose difference."""
    from supereight_tpu_torch.kernels import ba
    poses, graph, fixed = window(n, max(128, 2 * n), seed, "cuda")
    args = (poses, graph, n, iters, 1e-6, fixed)
    ms = _ms(lambda: ba.ba_solve(*args), reps)
    plain_ms = _ms(lambda: ba.ba_solve_plain(*args), 1)
    err = float((ba.ba_solve(*args) - ba.ba_solve_plain(*args)).abs().max())
    return dict(n=n, slots=graph.i.shape[0], edges=int(graph.valid.sum()),
                iters=iters, ms=ms, plain_ms=plain_ms,
                kernel_over_twin=ms / plain_ms, max_abs_err=err)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="supereight-tpu-torch-ba-windows")
    ap.add_argument("--nodes", type=int, nargs="+", default=[64, 128, 256])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ba_windows: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    for n in args.nodes:
        print(json.dumps(time_window(n, args.reps, args.iters)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
