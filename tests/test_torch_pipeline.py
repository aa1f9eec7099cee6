"""The port's class pipeline (``pipeline.DenseSLAMSystem``) against the
JAX package's, frame by frame.

Both run the test orbit (64^3 voxels over 2 m, 64x48 pixels, ICP 3/2)
through ``process_frame`` with the ground-truth bypass on frames 0-1 and
ICP after: eight TSDF frames at mu 0.1 and six OFusion frames at mu 0.008.
Every frame's result (tracked, integrated, raycasted and each drop
counter) and block count must be equal, and the poses agree to 2e-3.
The class's own rules are held too: the self-sizing allocation budget,
started at 2 blocks so that frame 0 overflows and the budget doubles at
frames 0 and 8 in both; a JAX checkpoint taken at frame 4 resumed by the
port, which then follows JAX's poses; and the checkpoint resume test of
``tests/test_checkpoint.py`` run on the port, where the resumed run must
equal the uninterrupted one bit for bit.
"""

import numpy as np
import pytest
import torch

from supereight_tpu.config import Configuration as JaxConfiguration
from supereight_tpu.pipeline import DenseSLAMSystem as JaxSystem
from supereight_tpu_torch.config import Configuration
from supereight_tpu_torch.pipeline import DenseSLAMSystem
from test_torch_step import COUNTERS, K, MU, N_FRAMES, N_FRAMES_OF, H, W, \
    make_scene

N_GT = 2          # frames given their ground-truth pose
RESUME_AT = 4     # the JAX checkpoint's last frame


def configs(field, **kw):
    base = dict(volume_resolution=64, volume_size=2.0, mu=MU[field],
                camera=K, compute_size_ratio=1, integration_rate=1,
                pyramid=(3, 2), block_capacity=1024, field=field)
    base.update(kw)
    return JaxConfiguration(**base), Configuration(**base)


def result(r):
    return {k: int(v) for k, v in r.items()}


@pytest.fixture(scope="module", params=["tsdf", "ofusion"])
def runs(request, tmp_path_factory):
    """Both pipelines over the orbit: per frame (result, pose, blocks),
    and the JAX checkpoint after frame RESUME_AT."""
    torch.set_num_threads(1)
    field = request.param
    n = N_FRAMES if field == "tsdf" else N_FRAMES_OF
    depths, poses = make_scene(n)
    jcfg, tcfg = configs(field)
    j = JaxSystem((W, H), jcfg, init_pose=poses[0])
    t = DenseSLAMSystem((W, H), tcfg, init_pose=poses[0], device="cpu")
    ckpt = str(tmp_path_factory.mktemp("ckpt") / f"{field}.npz")
    out = {"jax": [], "torch": []}
    for i, d in enumerate(depths):
        gt = poses[i] if i < N_GT else None
        for name, p in (("jax", j), ("torch", t)):
            r = p.process_frame(d, i, is_mm=False, gt_pose=gt)
            out[name].append((result(r), p.get_pose(), p.block_count()))
        if i == RESUME_AT:
            j.save_checkpoint(ckpt)
    return field, depths, poses, out, ckpt


def test_class_pipeline_matches_jax(runs):
    field, _, _, out, _ = runs
    # frames 2-3 cannot track (no raycast before frame 3), the rest do
    assert all(r["tracked"] for r, _, _ in out["jax"][4:])
    for i, ((rj, pj, bj), (rt, pt, bt)) in enumerate(zip(out["jax"],
                                                         out["torch"])):
        for c in COUNTERS:
            assert rj.get(c, 0) == 0, (i, c)
        assert rt == rj, i
        assert bt == bj, i
        np.testing.assert_allclose(pt, pj, atol=2e-3,
                                   err_msg=f"frame {i} diverged")


def test_port_resumes_a_jax_checkpoint(runs):
    """The port loads JAX's checkpoint of frame RESUME_AT and follows
    JAX's run from there."""
    field, depths, poses, out, ckpt = runs
    _, tcfg = configs(field)
    t = DenseSLAMSystem((W, H), tcfg, init_pose=poses[0], device="cpu")
    t.load_checkpoint(ckpt)
    assert t.block_count() == out["jax"][RESUME_AT][2]
    for i in range(RESUME_AT + 1, len(depths)):
        r = t.process_frame(depths[i], i, is_mm=False)
        rj, pj, bj = out["jax"][i]
        assert r["tracked"] == rj["tracked"] and t.block_count() == bj, i
        np.testing.assert_allclose(t.get_pose(), pj, atol=2e-3)


def test_allocation_budget_doubles_as_jax():
    """The self-sizing allocation budget (JAX pipeline.py:100-103,
    177-182), started at 2, on ground-truth poses (every frame fuses):
    frame 0 overflows and the budget doubles there and at frame 8; the
    overflow counts, block counts and results equal JAX's every frame."""
    torch.set_num_threads(1)
    depths, poses = make_scene(9)
    jcfg, tcfg = configs("tsdf")
    j = JaxSystem((W, H), jcfg, init_pose=poses[0])
    t = DenseSLAMSystem((W, H), tcfg, init_pose=poses[0], device="cpu")
    j._alloc_budget = t._alloc_budget = 2
    budgets, overflow = [], []
    for i, d in enumerate(depths):
        gt = poses[i]
        rj = result(j.process_frame(d, i, is_mm=False, gt_pose=gt))
        rt = result(t.process_frame(d, i, is_mm=False, gt_pose=gt))
        assert rt == rj, i
        assert t.block_count() == j.block_count(), i
        np.testing.assert_allclose(t.get_pose(), j.get_pose(), atol=2e-3)
        assert t._alloc_budget == j._alloc_budget, i
        budgets.append(t._alloc_budget)
        overflow.append(rt["alloc_overflow"])
    assert budgets == [4] * 8 + [8]
    assert overflow[0] > 0 and overflow[8] > 0


def test_resume_matches_uninterrupted(tmp_path):
    """tests/test_checkpoint.py on the port, on the test scene: ten orbit
    frames with the ground truth on frames 0-3, interrupted after frame 5,
    checkpointed and resumed in a fresh pipeline; the run ends where the
    uninterrupted one does, bit for bit."""
    torch.set_num_threads(1)
    depths, poses = make_scene(10)
    _, cfg = configs("tsdf")

    def system():
        return DenseSLAMSystem((W, H), cfg, init_pose=poses[0], device="cpu")

    a = system()
    for i, d in enumerate(depths):
        a.process_frame(d, i, is_mm=False,
                        gt_pose=poses[i] if i <= 3 else None)
    b = system()
    for i in range(6):
        b.process_frame(depths[i], i, is_mm=False,
                        gt_pose=poses[i] if i <= 3 else None)
    ckpt = str(tmp_path / "run.npz")
    b.save_checkpoint(ckpt)
    c = system()
    c.load_checkpoint(ckpt)
    assert c.block_count() == b.block_count()
    for i in range(6, len(depths)):
        assert c.process_frame(depths[i], i, is_mm=False)["tracked"]
    np.testing.assert_array_equal(c.get_pose(), a.get_pose())
    assert c.block_count() == a.block_count()
    np.testing.assert_array_equal(c.render_volume(), a.render_volume())


def test_unported_layers_raise():
    _, tcfg = configs("tsdf")
    t = DenseSLAMSystem((W, H), tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        t.enable_keyframes(every=10)
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        t.dump_mesh("mesh.obj")
    np.testing.assert_array_equal(t.get_position(), [1.0, 1.0, 0.0])
    assert t.get_depth().shape == (H, W) and t.block_count() == 0
