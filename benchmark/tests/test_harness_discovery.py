"""A cell, a mix or a metric is added by adding files: the harness finds
each by the name ``BENCHMARK.json`` gives it."""

import json
import shutil

from benchmark import run


def test_new_config_traffic_and_metric_are_found(tiny_root, tmp_path):
    root = tmp_path / "root"
    shutil.copytree(tiny_root, root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    # a new configuration, a new mix and a new metric, as files
    conf = json.loads(
        (root / "benchmark/configs/traj2-tsdf.json").read_text())
    conf["name"] = "traj2-tsdf-fine"
    conf["pipeline"]["mu"] = 0.05
    (root / "benchmark/configs/traj2-tsdf-fine.json").write_text(
        json.dumps(conf))
    mix = json.loads((root / "benchmark/traffic/live.json").read_text())
    mix["render_every"] = 8
    (root / "benchmark/traffic/sparse-views.json").write_text(
        json.dumps(mix))
    (root / "benchmark/limits/traj2-tsdf-fine.sparse-views.json") \
        .write_text(json.dumps({"pose_gap": 1.0}))
    (root / "benchmark/metrics/frames.seen.py").write_text(
        "def read(ctx):\n    return float(ctx['frames'])\n")
    bench["configs"].append({"name": "traj2-tsdf-fine", "source": "x",
                             "file": "benchmark/configs/"
                                     "traj2-tsdf-fine.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "traj2-tsdf-fine.sparse-views",
                               "config": "traj2-tsdf-fine",
                               "traffic": "sparse-views", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "frames.seen", "unit": "count",
                               "better": "higher",
                               "source": "program_counter", "layer": "x",
                               "moves": "frames_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    _, cell, config, traffic, limits = run.load_cell(
        "traj2-tsdf-fine.sparse-views", root)
    assert config["pipeline"]["mu"] == 0.05
    assert traffic["render_every"] == 8
    assert limits == {"pose_gap": 1.0}
    assert run.settings(config, traffic)["mu"] == 0.05
    names = [m["name"] for m in run.cell_metrics(bench, cell, "per_layer")]
    # a metric without workloads is read in every cell that reports the
    # end-to-end metric it moves; one with workloads only in those
    assert "frames.seen" in names
    assert "render.ms_per_rendered_frame" not in names
    assert run.reader("frames.seen", root)({"frames": 3}) == 3.0
    e2e = [m["name"] for m in run.cell_metrics(bench, cell, "end_to_end")]
    assert e2e == ["frames_per_s", "frame_p95_ms", "setup_s"]


def test_every_cell_of_the_benchmark_has_its_files():
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        _, _, config, traffic, limits = run.load_cell(cell["name"])
        assert config["reduced"] == []
        assert traffic["poses"] in ("icp", "groundtruth")
        assert limits
    for m in bench["per_layer"]:
        assert callable(run.reader(m["name"]))
