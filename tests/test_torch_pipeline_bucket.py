"""The class pipeline keeps the integration's budget bucket for the
raycast of the same frame.

``DenseSLAMSystem._budget_bucket`` reads the live block count to the
host. JAX's class reads it for the integration and again for the raycast;
only allocation changes the count, so the port reads it once a frame that
integrates and keeps the value, and reads it afresh where the frame did
not integrate or the map was replaced. Held here on the CPU against the
rule of two reads: the CLI's frame log (every column but the timings)
and every budget the integration and the raycast were handed are equal,
with one read a frame instead of two; and over the class's stages with a
frame that skips its integration and a checkpoint loaded between two
frames, where the raycast must read the count again.
"""

import numpy as np
import pytest
import torch

from supereight_tpu_torch import cli, pipeline
from supereight_tpu_torch.config import Configuration
from supereight_tpu_torch.pipeline import DenseSLAMSystem
from test_torch_step import MU, H, K, W, make_scene

# the frame log's columns that are not timings: frame, X, Y, Z, tracked,
# integrated (cli.LOG_HEADER)
LOG_COLUMNS = (0, 9, 10, 11, 12, 13)


@pytest.fixture
def recorded(monkeypatch):
    """Record the budget each integration and raycast is handed, the
    rule of two reads' value at that moment, and the block count reads
    (``_budget_bucket`` calls) of the pipeline; ``two_reads()`` switches
    to that rule (the raycast reads the count again)."""
    rec = dict(budgets=[], fresh=[], reads=0)
    bucket = DenseSLAMSystem._budget_bucket

    def counted(self):
        rec["reads"] += 1
        return bucket(self)

    def wrap(name, fn, key):
        def call(geom, state, *args, **kw):
            budget = kw[key] if key in kw else args[7]
            rec["budgets"].append((name, budget))
            n = max(int(state.n_blocks), 1)  # no preset budget here
            want = 1024
            while want < n:
                want *= 2
            rec["fresh"].append((name, min(want, geom.capacity)))
            return fn(geom, state, *args, **kw)
        return call

    monkeypatch.setattr(DenseSLAMSystem, "_budget_bucket", counted)
    monkeypatch.setattr(pipeline.integration, "integrate",
                        wrap("integrate", pipeline.integration.integrate,
                             "budget"))
    monkeypatch.setattr(pipeline.raycast, "raycast",
                        wrap("raycast", pipeline.raycast.raycast,
                             "pool_bucket"))

    raycasting = DenseSLAMSystem.raycasting

    def two_reads():
        def again(self, frame):
            self._bucket = None
            return raycasting(self, frame)
        monkeypatch.setattr(DenseSLAMSystem, "raycasting", again)

    rec["two_reads"] = two_reads
    return rec


def test_cli_log_and_budgets_equal_the_rule_of_two_reads(tmp_path,
                                                         recorded):
    torch.set_num_threads(1)
    argv = ["--synthetic", "6", "-v", "64", "--platform", "cpu"]
    runs = []
    for name in ("kept", "two reads"):
        if name == "two reads":
            recorded["two_reads"]()
        recorded.update(budgets=[], fresh=[], reads=0)
        log = str(tmp_path / f"{name}.log")
        pipe = cli.run(argv + ["-o", log])
        lines = open(log).read().splitlines()[1:]
        rows = np.array([[float(v) for v in ln.split("\t")] for ln in lines])
        runs.append((rows[:, LOG_COLUMNS], list(recorded["budgets"]),
                     list(recorded["fresh"]), recorded["reads"],
                     pipe.block_count()))
    (rows, budgets, fresh, reads, blocks), (rows2, budgets2, fresh2, reads2,
                                            blocks2) = runs
    np.testing.assert_array_equal(rows, rows2)
    assert budgets == budgets2 == fresh == fresh2
    assert blocks == blocks2
    n_int = sum(1 for name, _ in budgets if name == "integrate")
    n_ray = sum(1 for name, _ in budgets if name == "raycast")
    assert n_int == int(rows[:, 5].sum()) and n_ray == len(rows) - 3
    # one read a frame that integrates or raycasts, not one a stage; a
    # frame that raycasts without integrating reads once
    frames = sum(1 for r in rows if r[5] or r[0] > 2)
    assert reads == frames < reads2 == n_int + n_ray


def test_class_rereads_where_the_map_changed_without_integrating(
        tmp_path, recorded):
    """Frame 5 skips its integration (as the CLI skips it for a frame
    that did not track), and frame 6 loads frame 5's checkpoint between
    its integration and its raycast: both raycasts read the block count
    again, and every budget equals the rule of two reads'."""
    torch.set_num_threads(1)
    depths, poses = make_scene(7)
    cfg = Configuration(volume_resolution=64, volume_size=2.0,
                        mu=MU["tsdf"], camera=K, compute_size_ratio=1,
                        integration_rate=1, pyramid=(3, 2),
                        block_capacity=1024, field="tsdf")
    pipe = DenseSLAMSystem((W, H), cfg, init_pose=poses[0], device="cpu")
    ckpt = str(tmp_path / "ckpt.npz")
    reads = []
    for i, d in enumerate(depths):
        before = recorded["reads"]
        pipe.preprocessing(d, is_mm=False)
        if i < 2:
            pipe.set_pose(poses[i])
        else:
            pipe.tracking(i)
        if i != 5:
            pipe.integration(i)
        if i == 5:
            pipe.save_checkpoint(ckpt)
        if i == 6:  # the map replaced after the frame's integration
            pipe.load_checkpoint(ckpt)
        pipe.raycasting(i)
        reads.append(recorded["reads"] - before)
    assert recorded["budgets"] == recorded["fresh"]
    names = [name for name, _ in recorded["budgets"]]
    assert names.count("integrate") == 6 and names.count("raycast") == 4
    assert reads == [1, 1, 1, 1, 1, 1, 2]
