"""The port's profiler spans (``supereight_tpu_torch/utils/spans.py``).

Under ``torch.profiler`` (CPU activity) the class pipeline records each
stage method's span once a frame (``pipeline/preprocessing``,
``pipeline/tracking``, ``pipeline/integration``, ``pipeline/raycasting``,
``pipeline/render_views``), and inside them one ``pipeline/wait/<what>``
span around each call at which its host waits for the device, as many as
the class's rules read: the depth's upload every frame, the tracking
verdict on a tracked frame or the ground-truth pose's copy, the block
count once a frame that integrates or raycasts, the overflow poll on a
frame that integrates with ``frame % 8 == 0``, the composite on a rendered
frame. Frames 0-8 of the test orbit (64^3 voxels over 2 m, 64x48 pixels,
u16 millimetres as the CLI reads them) hold every kind: frames 0 and 8
poll, frames 4 and 8 render. With no profiler active neither the class
nor ``frame_step`` builds a ``record_function``; under one, ``frame_step``
records its five ``frame_step/<stage>`` spans, which ``chip_smoke.py``
reads.
"""

import collections

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from supereight_tpu_torch.config import Configuration
from supereight_tpu_torch.parallel import step
from supereight_tpu_torch.pipeline import DenseSLAMSystem
from supereight_tpu_torch.utils import spans
from test_torch_step import (DIM, FIELDS, MU, H, K, W, k_torch, make_scene,
                             step_kw, torch_geometry)

N = 9
STAGES = ("preprocessing", "tracking", "integration", "raycasting",
          "render_views")
FRAME = "test.frame"


@pytest.fixture(scope="module")
def scene():
    depths, poses = make_scene(N)
    return np.round(depths * 1000.0).astype(np.uint16), poses


def system(poses, field="tsdf"):
    cfg = Configuration(volume_resolution=64, volume_size=DIM,
                        mu=MU[field], camera=K, compute_size_ratio=1,
                        integration_rate=1, pyramid=(3, 2),
                        block_capacity=1024, field=field)
    return DenseSLAMSystem((W, H), cfg, init_pose=poses[0], device="cpu")


def rendered(i):
    # the CLI's rule at rendering rate 4
    return i % 4 == 0 and i > 2


def run_frames(pipe, mm, poses, frames, gt, render):
    """Each frame's result (the counters as ints) and whether it
    rendered."""
    out = []
    for i in frames:
        with spans.span(FRAME):
            r = pipe.process_frame(mm[i], i, is_mm=True,
                                   gt_pose=poses[i] if gt else None)
            shown = render and rendered(i)
            if shown:
                pipe.render_views()
        out.append(dict(frame=i, integrated=bool(r["integrated"]),
                        rendered=shown))
    return out


def expected(f, gt):
    """The spans the class's rules open on frame ``f``: {name: count}
    and the stage each wait lies in."""
    i, integrated = f["frame"], f["integrated"]
    stages = {"preprocessing": 1, "tracking": 1,
              "integration": int(integrated), "raycasting": 1,
              "render_views": int(f["rendered"])}
    waits = {"depth": ("preprocessing", 1),
             "gt_pose": ("tracking", int(gt)),
             "tracked": ("tracking", int(not gt)),
             # the integration reads the count and keeps its bucket for
             # the raycast; without one the raycast reads it from frame 3
             "n_blocks": ("integration" if integrated else "raycasting",
                          int(integrated or i > 2)),
             "alloc_overflow": ("integration",
                                int(integrated and i % 8 == 0)),
             "composite": ("render_views", int(f["rendered"]))}
    return stages, waits


def recorded(prof, prefixes):
    """(name, start ns, end ns) of the recorded events whose names start
    with ``prefixes``, in start order. (The profiler's raw events: its
    event tree over the CPU twins' ~600k ops takes half a minute.)"""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(prefixes)]
    return sorted(out, key=lambda e: e[1])


def by_frame(prof):
    """[(span name, innermost enclosing span of the class or None)] of the
    class's spans inside each of the test's frame spans."""
    evs = recorded(prof, (FRAME, "pipeline/"))
    frames = [e for e in evs if e[0] == FRAME]
    ours = [e for e in evs if e[0] != FRAME]
    out = []
    for _, a, b in frames:
        inside = [e for e in ours if a <= e[1] and e[2] <= b]
        got = []
        for name, s, t in inside:
            around = [o for o in inside if o[1] <= s and t <= o[2]
                      and (o[1], o[2]) != (s, t)]
            parent = min(around, key=lambda o: o[2] - o[1])[0] \
                if around else None
            got.append((name, parent))
        out.append(got)
    return out


@pytest.mark.parametrize("gt", [False, True], ids=["tracked", "groundtruth"])
def test_class_records_its_stage_and_wait_spans(scene, gt):
    torch.set_num_threads(1)
    mm, poses = scene
    pipe = system(poses)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        frames = run_frames(pipe, mm, poses, range(N), gt, render=not gt)
    seen = by_frame(prof)
    assert len(seen) == N
    totals = collections.Counter()
    for f, got in zip(frames, seen):
        stages, waits = expected(f, gt)
        names = collections.Counter(name for name, _ in got)
        for s in STAGES:
            assert names["pipeline/" + s] == stages[s], (f, s, got)
        for w, (stage, n) in waits.items():
            inside = [p for name, p in got if name == "pipeline/wait/" + w]
            assert len(inside) == n, (f, w, got)
            # each wait lies in its stage's span, and in no other
            assert all(p == "pipeline/" + stage for p in inside), (f, w, got)
            totals[w] += n
        assert sum(names.values()) == sum(stages.values()) + \
            sum(n for _, n in waits.values()), (f, got)
        # stage spans nest in no other span of the class
        assert all(p is None or not p.startswith("pipeline/")
                   for name, p in got if name.count("/") == 1), got
    # every kind of wait the traffic has was seen
    kinds = {"depth", "n_blocks", "alloc_overflow"} | (
        {"gt_pose"} if gt else {"tracked", "composite"})
    assert {w for w, n in totals.items() if n} == kinds
    if not gt:
        assert [f["frame"] for f in frames if f["rendered"]] == [4, 8]
    assert frames[8]["integrated"] and frames[0]["integrated"]


def test_no_record_function_without_a_profiler(scene, monkeypatch):
    """With no profiler active the spans build nothing: the class's frames
    (a poll, a render, a ground-truth pose) and ``frame_step`` run with
    ``record_function`` made to raise."""
    torch.set_num_threads(1)
    mm, poses = scene

    def refuse(self, *args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(autograd_profiler.record_function, "__init__",
                        refuse)
    assert not autograd_profiler._is_profiler_enabled
    with spans.span("pipeline/test"):
        pass
    pipe = system(poses)
    run_frames(pipe, mm, poses, range(5), gt=False, render=True)
    run_frames(pipe, mm, poses, [5], gt=True, render=False)
    geom = torch_geometry()
    state = step.init_frame_state(geom, FIELDS["tsdf"], (W, H), poses[0],
                                  device="cpu")
    step.frame_step(geom, FIELDS["tsdf"], state,
                    torch.from_numpy(mm[0].astype(np.float32) / 1000.0),
                    k_torch(), 0, **step_kw())


def test_frame_step_records_its_five_spans(scene):
    torch.set_num_threads(1)
    mm, poses = scene
    geom = torch_geometry()
    state = step.init_frame_state(geom, FIELDS["tsdf"], (W, H), poses[0],
                                  device="cpu")
    depth = torch.from_numpy(mm[0].astype(np.float32) / 1000.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step.frame_step(geom, FIELDS["tsdf"], state, depth, k_torch(), 0,
                        **step_kw())
    names = collections.Counter(
        e[0] for e in recorded(prof, ("frame_step/",)))
    assert names == {f"frame_step/{s}": 1 for s in
                     ("preprocess", "track", "allocate", "integrate",
                      "raycast")}


def test_spans_follow_the_profiler():
    assert spans.span("x") is spans.span("y")  # the shared no-op
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert isinstance(spans.span("pipeline/test"),
                          autograd_profiler.record_function)
        with spans.span("pipeline/test"):
            pass
        spans.spanned("pipeline/decorated")(lambda: None)()
    names = [e[0] for e in recorded(prof, ("pipeline/",))]
    assert names.count("pipeline/test") == 1
    assert names.count("pipeline/decorated") == 1
