"""The benchmark's own tests, run from the repository's root:

    python -m pytest benchmark/tests -q

They run on the CPU. A test that needs the card is marked ``cuda`` and
decides in a fixture whether there is one (none needs it yet)."""

import json
import pathlib
import shutil

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA device (skips without one)")


def shrink(root: pathlib.Path):
    """Cut the cells' sizes under ``root`` to what a CPU test holds: 64^3
    voxels, 160x120 frames, a loop of 12 frames."""
    for c in root.glob("benchmark/configs/*.json"):
        d = json.loads(c.read_text())
        d["pipeline"].update(volume_resolution=64, block_capacity=4096,
                             preset_budget=1024, input_size=[160, 120],
                             camera=[481.2 / 4, 480.0 / 4, 80.0, 60.0])
        c.write_text(json.dumps(d))
    for t in root.glob("benchmark/traffic/*.json"):
        d = json.loads(t.read_text())
        d.update(loop_frames=13, trace_frames=3, noise_loops=2)
        if "pipeline" in d:
            d["pipeline"].update(block_capacity=4096, preset_budget=1024)
        t.write_text(json.dumps(d))


# a cell whose files the benchmark keeps, out of BENCHMARK.json (PERF.md)
KEPT = {"name": "traj2-tsdf.noisy", "config": "traj2-tsdf",
        "traffic": "noisy", "chips": 1, "why": "kept for a later PR"}


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A copy of the benchmark's data files (``BENCHMARK.json``, with the
    kept cell, configs, traffic, limits, metric readers) at a size the CPU
    runs in seconds."""
    root = tmp_path_factory.mktemp("bench")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"].append(KEPT)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(REPO / "benchmark" / sub, root / "benchmark" / sub)
    shrink(root)
    return root
