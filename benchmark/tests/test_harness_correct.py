"""``correct`` at a size the CPU holds: a sound run passes, and the run
with the timed path broken underneath, or with the control in the
program's place, does not. The check for a CUDA device is skipped: the
program runs its CPU path (its kernels' plain twins) through the same
class and frame loop."""

import pytest
import torch

from benchmark import run
from supereight_tpu_torch import pipeline
from supereight_tpu_torch.ops import integration, raycast, tracking


def _run(root, cell, **kw):
    return run.run(cell, 2000000011, 0.5, 0, device="cpu", root=root,
                   log=lambda m: None, **kw)


@pytest.mark.parametrize("cell", ["traj2-tsdf.live",
                                  "traj2-ofusion.mapping"])
def test_sound_run_is_correct(tiny_root, cell):
    r = _run(tiny_root, cell)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert r["attempted"] > 0


def unchanged(monkeypatch):
    """A frame step that returns its state unchanged."""
    def frame(self, depth, frame, is_mm=True, gt_pose=None):
        self.preprocessing(depth, is_mm=is_mm)
        return {"tracked": True, "integrated": False, "raycasted": False,
                **self.stats}
    monkeypatch.setattr(pipeline.DenseSLAMSystem, "process_frame", frame)


def half_left_out(monkeypatch):
    """Half of the batch left out: every second entry of the fusion's
    worklist emptied (the rest fused as ever)."""
    blocks = integration.integrate_blocks

    def half(geom, state, field, worklist, *args, **kw):
        wl = worklist.clone()
        wl[1::2] = geom.capacity
        return blocks(geom, state, field, wl, *args, **kw)
    monkeypatch.setattr(integration, "integrate_blocks", half)


def ray_altered(monkeypatch):
    """An answer altered where it is produced: the raycast's vertex map
    moved by 2 mm."""
    cast = raycast.raycast

    def moved(*args, **kw):
        out = cast(*args, **kw)
        return (out[0] + 0.002,) + tuple(out[1:])
    monkeypatch.setattr(raycast, "raycast", moved)


def pose_altered(monkeypatch):
    """An answer altered where it is produced: the tracked pose moved by
    1 mm."""
    track = tracking.track

    def moved(*args, **kw):
        pose, *rest = track(*args, **kw)
        shift = torch.zeros_like(pose)
        shift[0, 3] = 0.001
        return (pose + shift, *rest)
    monkeypatch.setattr(tracking, "track", moved)


# the exchange between chips has no fault here: every cell runs on one
@pytest.mark.parametrize("cell,fault", [
    ("traj2-tsdf.live", unchanged), ("traj2-ofusion.mapping", unchanged),
    ("traj2-tsdf.live", half_left_out),
    ("traj2-ofusion.mapping", half_left_out),
    ("traj2-tsdf.live", ray_altered), ("traj2-ofusion.mapping", ray_altered),
    ("traj2-tsdf.live", pose_altered)])
def test_a_broken_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    r = _run(tiny_root, cell)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", ["traj2-tsdf.live",
                                  "traj2-ofusion.mapping",
                                  "traj2-tsdf.noisy"])
def test_the_control_is_not_correct(tiny_root, cell):
    r = _run(tiny_root, cell, control=True)
    assert r["correct"], r["checks"]
    assert any(c["value"] > c["limit"] for c in r["control"].values()), \
        r["control"]
