"""The metric arithmetic: tails over every frame, the trace's busy and
idle time, the per-layer readers."""

import importlib.util
import json
import pathlib

import numpy as np
import pytest

from benchmark import run
from benchmark.trace import Timeline, kernel_name

REPO = pathlib.Path(__file__).resolve().parents[2]


def test_percentile_is_over_every_frame():
    lat = [1.0] * 94 + [5.0] * 6  # 6 slow frames of 100
    assert run.percentile(lat, 95) == 5.0
    assert run.percentile(lat, 94) == 1.0
    assert run.percentile(lat, 99) == 5.0
    assert run.percentile(list(range(1, 201)), 99) == 198
    # in any order
    assert run.percentile(np.random.default_rng(0).permutation(
        np.arange(1, 101)), 95) == 95


def _x(name, ts, dur, cat, tid=1, **args):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
            "tid": tid, "args": args}


def made_up_trace(tmp_path):
    """Two frames of 100 us, 40 and 30 us busy, and the harness's capture
    copy between them, which is left out."""
    ev = [
        _x("bench.frame", 0, 100, "user_annotation"),
        _x("bench.frame", 200, 100, "user_annotation"),
        _x("bench.capture", 150, 20, "user_annotation"),
        _x("cudaMemcpyAsync", 155, 5, "cuda_runtime", correlation=9),
        _x("Memcpy DtoD", 160, 30, "gpu_memcpy", tid=7, correlation=9),
        _x("cudaGraphLaunch", 5, 3, "cuda_runtime", correlation=1),
        _x("icp_track_kernel(Pyramid, float const*)", 10, 20, "kernel",
           tid=7, correlation=1),
        _x("integrate_fused_kernel<true>(int)", 25, 15, "kernel", tid=7,
           correlation=1),   # overlaps the first: busy 10-40
        _x("aten::_local_scalar_dense", 45, 50, "cpu_op"),
        _x("Memcpy HtoD (Pageable -> Device)", 210, 10, "gpu_memcpy",
           tid=7, correlation=2, bytes=307200),
        _x("raycast_kernel<false, false, true>(float)", 250, 20, "kernel",
           tid=7, correlation=3),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return Timeline(path)


def test_timeline_busy_idle_and_gaps(tmp_path):
    tl = made_up_trace(tmp_path)
    assert tl.window_us() == 200
    assert tl.busy_us() == 30 + 10 + 20
    assert not any("DtoD" in e[2] for e in tl.events)  # the capture's copy
    gaps = dict(tl.idle_gaps())
    # frame 1: idle 0-10 (the launch covers its middle), 40-100 (the read:
    # the op covers 45-95, the middle 70 falls in it); frame 2: 200-210,
    # 220-250, 270-300 (only the frame's span)
    assert gaps["cudaGraphLaunch"] == pytest.approx(10e-6)
    assert gaps["aten::_local_scalar_dense"] == pytest.approx(60e-6)
    assert gaps["bench.frame"] == pytest.approx(70e-6)
    ops = dict(tl.device_ops())
    assert ops["icp_track"] == pytest.approx(20e-6)
    assert ops["raycast"] == pytest.approx(20e-6)


def test_kernel_names():
    assert kernel_name("icp_track_kernel(Pyramid)") == "icp_track"
    assert kernel_name("raycast_kernel<true, false, false>(f)") == \
        "raycast_cold"
    assert kernel_name("raycast_kernel<true, false, true>(f)") == "raycast"
    assert kernel_name("Memcpy HtoD (Pageable -> Device)") == \
        "Memcpy HtoD (Pageable -> Device)"


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "benchmark" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_readers_on_the_made_up_trace(tmp_path):
    tl = made_up_trace(tmp_path)
    ctx = dict(frames=2, timeline=tl, host_calls=7.0, icp=None,
               latency_ms=[1.0, 1.0], rendered=[False, False])
    assert _reader("device.idle_share").read(ctx) == \
        pytest.approx(100 * (1 - 60 / 200))
    assert _reader("tracking.device_us_per_frame").read(ctx) == 10.0
    assert _reader("integration.device_us_per_frame").read(ctx) == 7.5
    assert _reader("raycast.device_us_per_frame").read(ctx) == 10.0
    # no K7 kernel in the trace: nothing to read, not 0
    assert _reader("preprocess.device_us_per_frame").read(ctx) is None
    assert _reader("render.ms_per_rendered_frame").read(ctx) is None
    assert _reader("icp_track_roofline").read(ctx) is None
    assert _reader("pipeline.host_calls_per_frame").read(ctx) == 7.0
    assert _reader("pipeline.frame_p99_ms").read(ctx) == 1.0
    ctx.update(latency_ms=[0.5, 0.7, 1.1, 0.6, 1.3],
               rendered=[False, False, True, False, True])
    assert _reader("render.ms_per_rendered_frame").read(ctx) == \
        pytest.approx(1.2 - 0.6)
    assert _reader("pipeline.frame_p99_ms").read(ctx) == 1.3


def test_icp_roofline_arithmetic(tmp_path):
    roof = _reader("icp_track_roofline")
    pixels = [76800, 19200, 4800]
    t, kind = roof.bound_s([3, 2, 4], pixels, 76800)
    ops = (3 * 76800 + 2 * 19200 + 4 * 4800) * 143 + 9 * 347
    by = ((sum(pixels) + 76800) * 25 + 76800 * 4 + 256 + 128 + 1 + 12)
    assert t == pytest.approx(max(ops / 67e12, by / 3.35e12))
    assert kind == ("bytes" if by / 3.35e12 >= ops / 67e12
                    else "operations")
    tl = made_up_trace(tmp_path)
    ctx = dict(frames=2, timeline=tl, icp=dict(
        runs=[[3, 2, 4], [3, 2, 4]], pixels=pixels, ref_pixels=76800))
    # 2 frames' bound over the 20 us of icp_track in the trace
    assert roof.read(ctx) == pytest.approx(100 * 2 * t / 20e-6)
