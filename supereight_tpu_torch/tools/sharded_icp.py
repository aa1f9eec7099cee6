"""K6's sharded pair timed on the card: one rank's Gauss-Newton iterations
of a frame, replayed without their collectives.

    python3 -m supereight_tpu_torch.tools.sharded_icp [--field tsdf|ofusion]
        [--frame N ...]

For each field: the bench orbit (``tools/bench.config``) through
``frame_step`` for all its 43 frames, with the arguments of every frame's
``ops/tracking.track`` call copied (single-device poses equal the sharded
step's bit for bit, so these are the inputs every rank of the four-rank
step tracks with). Then, on each ``--frame`` (default 4, the frame the
dist phase of ``chip_smoke.py`` captures, and 42, the last), rank 1 of
four: ``ops/tracking._track_sharded`` replayed REPS times with a stand-in
group (:class:`StandIn`) whose ``all_reduce_sum`` communicates nothing.
It puts the sum of the four ranks' reductions that a recording pass
(:func:`record`) computed for that iteration into the tensor, one
256-byte device copy, so the replay takes the real run's steps and
freezes; the copy is left out of every time below.

Per level (10 / 5 / 4 iterations at levels 0 / 1 / 2): the device
microseconds of each ``icp_reduce*`` launch, of the other kernels of an
iteration that are not K6's (the torch ops: the f64 sum of CTA partials
where the kernels leave one), of each ``icp_update`` launch, and how
many of the level's iterations were frozen (their level had converged
before them). Per frame: a frozen iteration's ``icp_reduce*`` launch,
the rank's ICP device microseconds and launches (every device event of
one replay but the stand-in's copies) and the torch ops a replay runs on
the host (the stand-in's copies among them), and over frames 4-42 the
frozen iterations a frame. The launch floor is a one-element
``zero_()``. Device times come from a chrome trace of ``torch.profiler``
(``utils/deviceprof.DEVICE_CATEGORIES``), each replay followed by a
synchronise and a pause so that replays part on the device's timeline; a
replay whose trace lacks any of its launches is dropped. One line a
level and a frame on stdout, then one JSON line of them all with the
card's name and power limit.

The script imports its kernels from whichever ``supereight_tpu_torch``
comes first on the path, so it can time another checkout's kernels on
the same card: ``PYTHONPATH=<checkout> python3
supereight_tpu_torch/tools/sharded_icp.py``. It runs on the card only:
without a CUDA device it exits 2.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import torch

WORLD, RANK = 4, 1
FRAMES = (4, 42)
REPS = 20
PAUSE_S = 2e-3    # host pause after each replay
GAP_US = 500.0    # an idle gap this long on the device parts two replays


class StandIn:
    """Rank ``rank`` of a group of ``world`` that communicates nothing:
    call k of ``all_reduce_sum`` copies ``sums[k % len(sums)]`` into its
    tensor (the ranks' summed reduction of iteration k)."""

    def __init__(self, sums, world=WORLD, rank=RANK):
        self.world, self.rank, self.sums, self.calls = world, rank, sums, 0

    def all_reduce_sum(self, t):
        t.copy_(self.sums[self.calls % len(self.sums)])
        self.calls += 1


def capture_tracks(b):
    """Run the bench ``b`` through all its frames; returns each frame's
    ``track`` arguments (copies) and the final state."""
    from supereight_tpu_torch.ops import tracking
    from supereight_tpu_torch.tools.dist_run import _copy
    calls, track = [], tracking.track

    def wrapped(*args, **kwargs):
        calls.append(_copy(args))
        return track(*args, **kwargs)

    tracking.track = wrapped
    try:
        state = b.init()
        for i in range(len(b.frames)):
            state, _ = b.frame(state, i)
    finally:
        tracking.track = track
    return calls, state


def sharded_args(track_args):
    """``_track_sharded``'s leading arguments from a ``track`` call's:
    (pose, view, pyramid vertex, normal, valid, reference vertex, normal,
    valid), and the call's iterations and threshold."""
    from supereight_tpu_torch.kernels.frame import frame_mats
    (pose, raycast_pose, k, verts, norms, valids, rv, rn, ro, iterations,
     icp_threshold) = track_args[:11]
    view = frame_mats(k, raycast_pose).view
    return (pose, view, verts, norms, valids, rv, rn, ro), \
        tuple(iterations), icp_threshold


def record(args, iterations, icp_threshold, world=WORLD):
    """The sharded frame's iterations as every rank sees them: each
    iteration's f64 reduction summed over the ``world`` ranks' column
    windows in rank order, and whether it was frozen (not the first of
    its level, and the level converged before it). Returns (f64[n, 32],
    [frozen])."""
    from supereight_tpu_torch.kernels import icp
    pose, view, verts, norms, valids, rv, rn, ro = args
    sums, frozen, carry = [], [], None
    for level in range(len(iterations) - 1, -1, -1):
        wl = verts[level].shape[1] // world
        for it in range(iterations[level]):
            at = pose if carry is None else carry.pose
            red = torch.zeros(32, dtype=torch.float64, device=pose.device)
            for r in range(world):
                red += icp.icp_reduce64(verts[level], norms[level],
                                        valids[level], rv, rn, ro, at, view,
                                        x0=r * wl, width=wl)[1]
            frozen.append(it > 0 and bool(carry.done))
            carry, _ = icp.icp_update(red, at, carry, first_of_level=it == 0,
                                      icp_threshold=icp_threshold)
            sums.append(red)
    return torch.stack(sums), frozen


def replay(args, iterations, icp_threshold, sums):
    """One rank's ``_track_sharded`` over ``args`` with a :class:`StandIn`
    group that hands it ``sums``; returns its outputs."""
    from supereight_tpu_torch.constants import DIST_THRESHOLD
    from supereight_tpu_torch.ops import tracking
    return tracking._track_sharded(*args, iterations, icp_threshold,
                                   DIST_THRESHOLD, StandIn(sums))


def device_events(fn, reps=REPS, pause_s=PAUSE_S):
    """The device events (name, category, start us, duration us) of
    ``reps`` calls of ``fn`` under ``torch.profiler``, read from its
    chrome trace, each call followed by a synchronise and a host pause.
    """
    from torch.profiler import ProfilerActivity, profile

    from supereight_tpu_torch.utils.deviceprof import DEVICE_CATEGORIES
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
            time.sleep(pause_s)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    return [(e["name"], str(e.get("cat", "")).lower(), float(e["ts"]),
             float(e.get("dur", 0.0))) for e in trace["traceEvents"]
            if e.get("ph") == "X"
            and str(e.get("cat", "")).lower() in DEVICE_CATEGORIES]


def kind(event):
    """An event's part of a sharded iteration: ``reduce`` (a K6
    ``icp_reduce`` launch, with any update folded into it), ``update``,
    ``stand-in`` (the stand-in's copy, a memcpy) or ``other``."""
    name, cat = event[0], event[1]
    if "icp_reduce" in name:
        return "reduce"
    if "icp_update" in name:
        return "update"
    if cat == "gpu_memcpy":
        return "stand-in"
    return "other"


def split_replays(events, n_iter, gap_us=GAP_US):
    """``events`` (:func:`device_events`) cut into replays where the
    device idled over ``gap_us``, each replay cut into its ``n_iter``
    iterations: from each ``reduce`` event to the next. A replay the
    trace shows only in part (not ``n_iter`` reduces and stand-in copies)
    is dropped. Returns [replay] -> [iteration] -> [event]."""
    events = sorted(events, key=lambda e: e[2])
    replays, cur, end = [], [], None
    for e in events:
        if cur and e[2] - end > gap_us:
            replays.append(cur)
            cur = []
        cur.append(e)
        end = e[2] + e[3] if end is None else max(end, e[2] + e[3])
    if cur:
        replays.append(cur)
    out = []
    for rep in replays:
        kinds = [kind(e) for e in rep]
        if kinds.count("reduce") != n_iter or \
                kinds.count("stand-in") != n_iter or kinds[0] != "reduce":
            continue
        its = []
        for e, k in zip(rep, kinds):
            if k == "reduce":
                its.append([])
            its[-1].append(e)
        out.append(its)
    return out


def summarize(replays, iterations, frozen):
    """Per level (finest first): the mean device us of a reduce launch, of
    an iteration's other events and of an update launch, the updates an
    iteration, the frozen iterations; the mean device us of a frozen
    iteration's reduce launch (None where none froze); and per replay the
    ICP device us and launches (means over the replays)."""
    sched = [lvl for lvl in range(len(iterations) - 1, -1, -1)
             for _ in range(iterations[lvl])]
    levels = []
    for lvl in range(len(iterations)):
        idx = [i for i, s in enumerate(sched) if s == lvl]
        acc = {"reduce": [], "other": [], "update": []}
        for rep in replays:
            for i in idx:
                for k in acc:
                    d = [e[3] for e in rep[i] if kind(e) == k]
                    if k == "reduce" or d:
                        acc[k].append(sum(d) if k == "other" else d[0])
                    if k == "update" and len(d) > 1:
                        acc[k].extend(d[1:])
        n_it = len(idx) * len(replays)
        levels.append(dict(
            level=lvl, iterations=len(idx),
            frozen=sum(frozen[i] for i in idx),
            reduce_us=sum(acc["reduce"]) / len(acc["reduce"]),
            other_us=sum(acc["other"]) / n_it,
            update_us=(sum(acc["update"]) / len(acc["update"])
                       if acc["update"] else 0.0),
            updates_an_iteration=len(acc["update"]) / n_it))
    frozen_d = [rep[i][0][3] for rep in replays
                for i, f in enumerate(frozen) if f]
    per = [[e for it in rep for e in it if kind(e) != "stand-in"]
           for rep in replays]
    return dict(levels=levels, replays=len(replays),
                frozen_us=(sum(frozen_d) / len(frozen_d) if frozen_d
                           else None),
                icp_us=sum(sum(e[3] for e in p) for p in per) / len(per),
                launches=sum(len(p) for p in per) / len(per))


def host_ops(fn):
    """The torch ops one call of ``fn`` runs on the host, by name and
    count, from ``torch.profiler`` (the stand-in's ``copy_`` among
    them)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.key: e.count for e in prof.key_averages()
            if e.key.startswith("aten::")}


def launch_floor_us():
    """Device us of a one-element ``zero_()``."""
    from supereight_tpu_torch.tools.k3_bucket import device_us
    x = torch.zeros(1, device="cuda")
    return device_us(lambda: x.zero_())


def measure(field_name, frames=FRAMES):
    """The field's bench orbit, then the sharded replay on each of
    ``frames`` and the frozen iterations of every frame from 4 on."""
    from supereight_tpu_torch.tools import bench
    b = bench.config(field_name, torch.device("cuda", 0))
    tracks, state = capture_tracks(b)
    inputs = {f: sharded_args(tracks[f]) for f in range(4, len(tracks))}
    torch.cuda.synchronize()
    out = {"blocks": int(state.map.n_blocks)}
    out[field_name] = replays_of(field_name, inputs, frames)
    return out


def replays_of(tag, inputs, frames):
    """:func:`measure`'s replays of ``inputs`` (frame -> the
    :func:`sharded_args` of its ``track`` call) with the kernels in use
    (K6's only), printed under ``tag``."""
    out = {"frames": {}}
    frozen_all = []
    for f, (args, iterations, thr) in inputs.items():
        sums, frozen = record(args, iterations, thr)
        frozen_all.append(sum(frozen))
        if f not in frames:
            continue
        replays = split_replays(
            device_events(lambda: replay(args, iterations, thr, sums)),
            len(sums))
        if not replays:
            raise RuntimeError("sharded_icp: no replay showed all its "
                               "launches in the trace")
        s = summarize(replays, iterations, frozen)
        s["host_ops"] = host_ops(lambda: replay(args, iterations, thr,
                                                sums))
        out["frames"][f] = s
        for lv in s["levels"]:
            print(f"{tag} frame {f} level {lv['level']} "
                  f"({lv['iterations']} iterations, {lv['frozen']} frozen): "
                  f"icp_reduce {lv['reduce_us']:.2f} us a launch, other "
                  f"{lv['other_us']:.2f} us an iteration, icp_update "
                  f"{lv['update_us']:.2f} us a launch "
                  f"({lv['updates_an_iteration']:.2f} an iteration)",
                  flush=True)
        if s["frozen_us"] is not None:
            print(f"{tag} frame {f}: a frozen iteration's icp_reduce "
                  f"{s['frozen_us']:.2f} us a launch", flush=True)
        print(f"{tag} frame {f}: rank {RANK}'s ICP {s['icp_us']:.2f} "
              f"device us in {s['launches']:.1f} launches a frame "
              f"({s['replays']} of {REPS} replays seen whole); its torch "
              f"ops {s['host_ops']}", flush=True)
    out["frozen_a_frame"] = frozen_all
    print(f"{tag}: frozen iterations a frame over frames 4-{max(inputs)}: "
          f"{frozen_all}", flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--field", choices=("tsdf", "ofusion"), action="append")
    p.add_argument("--frame", type=int, action="append")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("sharded_icp: needs a CUDA device", file=sys.stderr)
        return 2
    import supereight_tpu_torch
    from supereight_tpu_torch.tools.bench import card
    print(f"# {card()}; kernels of {supereight_tpu_torch.__file__}",
          flush=True)
    floor = launch_floor_us()
    print(f"launch floor (a one-element zero_()): {floor:.2f} device us",
          flush=True)
    res = {f: measure(f, tuple(args.frame or FRAMES))
           for f in args.field or ("tsdf", "ofusion")}
    print(json.dumps({"card": card(), "launch_floor_us": floor,
                      "sharded_icp": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
