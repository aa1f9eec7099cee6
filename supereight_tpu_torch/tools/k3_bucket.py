"""K3's fused pass and fallback timed on the card at the bench budget and
at the class pipeline's bucket.

    python3 -m supereight_tpu_torch.tools.k3_bucket [--field tsdf|ofusion]

For each field: the bench orbit (``tools/bench.config``) through
``frame_step`` for all its 43 frames, then, on the map and pose it ended
with and its last depth, K3's worklist at 8,192 entries (the bench's
budget) and at 49,152 (the class pipeline's bucket and the noise row's
budget), and on each the fused pass and the fallback, on copies of the
map, over the whole worklist and over its listed entries alone
(:func:`k3_times`): device microseconds a launch, the sum of the
kernels' device time under ``torch.profiler`` over 20 launches divided by
the launches the trace shows. One line a worklist on stdout, then one
JSON line of them all, with the card's name and power limit.

The script imports its kernels from whichever ``supereight_tpu_torch``
comes first on the path, so it can time another checkout's kernels on
the same card: ``PYTHONPATH=<checkout> python3
supereight_tpu_torch/tools/k3_bucket.py``. It runs on the card only:
without a CUDA device it exits 2.
"""

import argparse
import json
import sys

import torch

BUDGETS = (8192, 49152)
REPS = 20


def device_us(fn):
    """Device microseconds a call of fn(), over REPS calls under
    torch.profiler; the trace misses the first launches after it starts,
    so the sum is divided by the launches it shows (fn launches one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    seen = sum(e.count for e in events)
    if not seen:
        raise RuntimeError("the trace showed no device work")
    return sum(e.self_device_time_total for e in events) / seen


def k3_times(geom, field, m, pose, k, depth, mu, ts, budget, noise=False,
             timer=device_us):
    """K3 on copies of the map ``m``, fusing ``depth`` at ``pose`` (the
    intrinsics ``k``, stamped ``ts``): the worklist at ``budget`` entries,
    then the fused pass and the fallback over it and over its listed
    entries alone, each timed by ``timer(fn)`` (device us a launch).
    Returns the entries, the listed and need blocks and the four times."""
    from supereight_tpu_torch.core import se3
    from supereight_tpu_torch.kernels import integrate as ki
    from supereight_tpu_torch.tools.bench import clone_map
    h, w = depth.shape
    t_cw, kmat = se3.inverse(pose), se3.camera_matrix(k)
    when = torch.ones((), dtype=torch.bool, device=depth.device)
    wl = ki.integrate_worklist(geom, m, t_cw, kmat, (w, h), budget, when)[0]
    listed = int((wl < geom.capacity).sum())
    out = dict(entries=budget, listed=listed)
    for tag, entries in (("", wl), ("_listed", wl[:listed].clone())):
        args = (geom, clone_map(m), field, entries, depth, t_cw, kmat, mu)
        fused = ki.integrate_fused(*args, ts, noise)
        out["need"] = int(fused[2].sum())
        out["fused_us" + tag] = timer(
            lambda: ki.integrate_fused(*args, ts, noise))
        out["fallback_us" + tag] = timer(
            lambda: ki.integrate_fallback(*args, *fused, ts, noise))
    return out


def measure(field_name):
    """The field's bench orbit, then K3 timed on its last frame at each
    of BUDGETS; returns the measurements as a dict."""
    from supereight_tpu_torch.tools import bench
    b = bench.config(field_name, torch.device("cuda", 0))
    state = b.init()
    for i in range(len(b.frames)):
        state, _ = b.frame(state, i)
    torch.cuda.synchronize()
    ts = torch.full((), (len(b.frames) - 1) / 30.0, device=b.k.device)
    out = {"blocks": int(state.map.n_blocks)}
    for budget in BUDGETS:
        r = k3_times(b.geom, b.field, state.map, state.pose, b.k,
                     b.frames[-1], b.kw["mu"], ts, budget)
        out[str(budget)] = r
        print(f"{field_name} {budget}: {r['listed']} listed, {r['need']} "
              f"need; integrate_fused {r['fused_us']:.2f} us (listed alone "
              f"{r['fused_us_listed']:.2f}), integrate_fallback "
              f"{r['fallback_us']:.2f} us (listed alone "
              f"{r['fallback_us_listed']:.2f})", flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--field", choices=("tsdf", "ofusion"), action="append")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3_bucket: needs a CUDA device", file=sys.stderr)
        return 2
    import supereight_tpu_torch
    from supereight_tpu_torch.tools.bench import card
    print(f"# {card()}; kernels of {supereight_tpu_torch.__file__}",
          flush=True)
    res = {f: measure(f) for f in args.field or ("tsdf", "ofusion")}
    print(json.dumps({"card": card(), "k3": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
