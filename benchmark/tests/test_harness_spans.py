"""The readers of the program's stage and wait spans (``spans.py`` and
``metrics/*.device_idle_us_per_frame.py``,
``metrics/pipeline.host_waits_per_frame.py``) on a made-up chrome trace:
the device's idle time under each stage span, a wait's credited to its
stage, the six summing to the frames' idle time, nothing read from a
trace without the spans, and no import of the port."""

import json
import subprocess
import sys

import pytest

from benchmark import run, spans
from benchmark.trace import Timeline
from test_harness_metrics import _reader, _x, made_up_trace

IDLE = ("preprocess", "tracking", "integration", "raycast", "render",
        "pipeline")
READERS = tuple(f"{m}.device_idle_us_per_frame" for m in IDLE) + (
    "pipeline.host_waits_per_frame",)


def _span(name, a, b):
    return _x(name, a, b - a, "user_annotation")


def _kernel(a, b, n):
    return _x("integrate_fused_kernel<true>(int)", a, b - a, "kernel",
              tid=7, correlation=n)


def staged_trace(tmp_path):
    """Two frames of 100 us with the class's spans. Frame 1 (0-100):
    preprocessing 2-20 (its wait 5-12), tracking 20-45 (40-45), integration
    45-80 (the poll 50-52, the block count 60-64), raycasting 80-90; the
    device busy 10-14, 25-40, 55-70, 82-86. Frame 2 (200-300):
    preprocessing 200-215 (205-210), tracking 215-230 (226-230),
    integration 230-260 (245-249), raycasting 260-275, render_views
    275-295 (its composite 285-295); busy 207-209, 220-228, 240-250,
    265-270, 280-284. Between them the harness's capture, under a stage
    and a wait span of its own that the readers must not count."""
    w = spans.WAIT
    ev = [
        _span("bench.frame", 0, 100), _span("bench.frame", 200, 300),
        _span(spans.PREPROCESS, 2, 20), _span(w + "depth", 5, 12),
        _span(spans.TRACKING, 20, 45), _span(w + "tracked", 40, 45),
        _span(spans.INTEGRATION, 45, 80), _span(w + "alloc_overflow", 50, 52),
        _span(w + "n_blocks", 60, 64), _span(spans.RAYCAST, 80, 90),
        _span(spans.PREPROCESS, 200, 215), _span(w + "depth", 205, 210),
        _span(spans.TRACKING, 215, 230), _span(w + "tracked", 226, 230),
        _span(spans.INTEGRATION, 230, 260), _span(w + "n_blocks", 245, 249),
        _span(spans.RAYCAST, 260, 275), _span(spans.RENDER, 275, 295),
        _span(w + "composite", 285, 295),
        _span(spans.PREPROCESS, 150, 160), _span(w + "depth", 150, 152),
    ]
    busy = [(10, 14), (25, 40), (55, 70), (82, 86), (207, 209), (220, 228),
            (240, 250), (265, 270), (280, 284)]
    ev += [_kernel(a, b, n) for n, (a, b) in enumerate(busy)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return Timeline(path)


def test_idle_under_each_stage(tmp_path):
    tl = staged_trace(tmp_path)
    # frame 1's idle 0-10, 14-25, 40-55, 70-82, 86-100 and frame 2's
    # 200-207, 209-220, 228-240, 250-265, 270-280, 284-300, cut by each
    # stage's spans
    assert spans.idle_us(tl, (spans.PREPROCESS,)) == 8 + 6 + 7 + 6
    assert spans.idle_us(tl, (spans.TRACKING,)) == 5 + 5 + 5 + 2
    assert spans.idle_us(tl, (spans.INTEGRATION,)) == 10 + 10 + 10 + 10
    assert spans.idle_us(tl, (spans.RAYCAST,)) == 2 + 4 + 5 + 5
    assert spans.idle_us(tl, (spans.RENDER,)) == 5 + 11
    # a wait's idle lies inside its stage's and is counted there once
    assert spans.idle_us(tl, (spans.WAIT + "depth",)) == 5 + 2 + 1
    assert spans.idle_us(tl, (spans.PREPROCESS, spans.WAIT + "depth")) == \
        spans.idle_us(tl, (spans.PREPROCESS,))
    assert spans.idle_us(tl, (spans.WAIT + "composite",)) == 10
    assert spans.idle_us(tl, ("pipeline/none",)) is None


def test_readers_sum_to_the_idle_share(tmp_path):
    tl = staged_trace(tmp_path)
    ctx = dict(frames=2, timeline=tl)
    got = {m: _reader(m).read(ctx) for m in READERS}
    assert got == pytest.approx({
        "preprocess.device_idle_us_per_frame": 27 / 2,
        "tracking.device_idle_us_per_frame": 17 / 2,
        "integration.device_idle_us_per_frame": 40 / 2,
        "raycast.device_idle_us_per_frame": 16 / 2,
        "render.device_idle_us_per_frame": 16 / 2,
        # frame 1's 0-2 and 90-100, frame 2's 295-300
        "pipeline.device_idle_us_per_frame": 17 / 2,
        # 4 waits a frame; the capture's is outside the frames
        "pipeline.host_waits_per_frame": 4.0})
    share = _reader("device.idle_share").read(ctx)
    idle = sum(got[f"{m}.device_idle_us_per_frame"] for m in IDLE)
    assert idle == pytest.approx(share / 100 * tl.window_us() / 2)


def test_a_trace_without_the_spans_reads_nothing(tmp_path):
    tl = made_up_trace(tmp_path)
    ctx = dict(frames=2, timeline=tl)
    for m in READERS:
        assert _reader(m).read(ctx) is None, m


def test_cells_read_the_new_metrics():
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    live = {m["name"] for m in run.cell_metrics(
        bench, cells["traj2-tsdf.live"], "per_layer")}
    mapping = {m["name"] for m in run.cell_metrics(
        bench, cells["traj2-ofusion.mapping"], "per_layer")}
    assert set(READERS) <= live
    assert set(READERS) - mapping == {"render.device_idle_us_per_frame"}


def test_readers_import_nothing_of_the_port():
    blocked = run.FORBIDDEN + ("supereight_tpu_torch",)
    code = f"""
import importlib.abc, importlib.util, sys
BLOCKED = {blocked!r}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
import benchmark.spans, benchmark.trace
for name in {READERS!r}:
    path = "benchmark/metrics/" + name + ".py"
    spec = importlib.util.spec_from_file_location(name, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(sorted({{m.split(".")[0] for m in sys.modules}} & set(BLOCKED)))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"
