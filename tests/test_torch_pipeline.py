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
equal the uninterrupted one bit for bit. With ``enable_keyframes`` the
class runs beside JAX's over an orbit that goes out and comes back (at
``-c 2 -v 128``, where the two packages' trackers agree), so that a loop
closure is tried against a revisited keyframe and accepted in both:
poses agree to 2e-3, the closure edges are equal and the trajectory
correction agrees to 2e-3.
"""

import numpy as np
import pytest
import torch

from supereight_tpu import config as jax_config
from supereight_tpu.config import Configuration as JaxConfiguration
from supereight_tpu.io import dataset as jax_dataset
from supereight_tpu.pipeline import DenseSLAMSystem as JaxSystem
from supereight_tpu_torch import config as port_config
from supereight_tpu_torch.config import Configuration
from supereight_tpu_torch.io import dataset as port_dataset
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


def test_unported_layers_raise(tmp_path):
    """The layers that raised until they were ported, the keyframe pose
    graph and the mesh export, now run on a fresh pipeline:
    ``enable_keyframes`` sets up the manager on the pipeline's device and
    ``dump_mesh`` of the empty map writes an empty mesh."""
    _, tcfg = configs("tsdf")
    t = DenseSLAMSystem((W, H), tcfg, device="cpu")
    t.enable_keyframes(every=10)
    assert t.keyframes.keyframe_every == 10
    assert t.keyframes.device == t.device
    path = str(tmp_path / "mesh.obj")
    assert t.dump_mesh(path).shape == (0, 3, 3)
    assert open(path).read().startswith("# OBJ")
    np.testing.assert_array_equal(t.get_position(), [1.0, 1.0, 0.0])
    assert t.get_depth().shape == (H, W) and t.block_count() == 0


# the orbit of convert.synthetic2raw(scene="orbit") over 8 frames, out to
# its end and back: frame 10 sees what frame 4 saw
THERE_AND_BACK = list(range(8)) + [6, 5, 4]


def write_there_and_back(raw):
    """Write the out-and-back orbit .raw (640x480) and its TUM ground
    truth."""
    from supereight_tpu_torch.cli import rotation_to_quaternion
    from supereight_tpu_torch.io import dataset, synthetic
    dim = 4.8
    depths, poses = synthetic.orbit_sequence(
        8, (481.2, 480.0, 320.0, 240.0), width=640, height=480,
        radius=0.3 * dim, center=(dim / 2,) * 3, sphere_radius=0.15 * dim,
        angle_span=0.6, room=((0.55,) * 3, (dim - 0.55,) * 3))
    dataset.write_raw(raw, np.round(depths[THERE_AND_BACK] * 1000.0)
                      .astype(np.uint16))
    with open(raw + ".gt.txt", "w") as f:
        for i, p in enumerate(poses[THERE_AND_BACK]):
            q = rotation_to_quaternion(p[:3, :3])
            f.write(f"{i / 30.0:.6f} {p[0, 3]:.6f} {p[1, 3]:.6f} "
                    f"{p[2, 3]:.6f} {q[0]:.6f} {q[1]:.6f} {q[2]:.6f} "
                    f"{q[3]:.6f}\n")
    return raw


@pytest.fixture(scope="module")
def there_and_back(tmp_path_factory):
    return write_there_and_back(str(tmp_path_factory.mktemp("raw")
                                    / "orbit.raw"))


def test_class_keyframes_match_jax(there_and_back):
    """The class pipeline with keyframes every 2nd frame beside JAX's:
    keyframes at frames 4, 6, 8 and 10, the last a revisit of the first,
    where both try a closure, accept it and optimize the window."""
    raw = there_and_back
    torch.set_num_threads(1)
    argv = ["-i", raw, "-g", raw + ".gt.txt", "-c", "2", "-v", "128", "-s",
            "4.8", "-p", "0.5,0.4583,0.18", "-r", "1"]

    def build(cfg_mod, ds_mod, system, **kw):
        cfg = cfg_mod.config_from_args(cfg_mod.build_parser().parse_args(
            argv))
        reader = ds_mod.RawDepthReader(raw, raw + ".gt.txt")
        cfg.camera = reader.get_k()
        to = ds_mod.first_pose_transform(
            reader.poses[0],
            np.asarray(cfg.initial_pos_factor) * cfg.volume_size)
        s = system((reader.width, reader.height), cfg,
                   init_pose=to @ reader.poses[0], **kw)
        s.enable_keyframes(every=2)
        return s, reader
    j, jr = build(jax_config, jax_dataset, JaxSystem)
    p, pr = build(port_config, port_dataset, DenseSLAMSystem, device="cpu")
    for i in range(len(THERE_AND_BACK)):
        d = pr.read_next()[0]
        rj = j.process_frame(jr.read_next()[0], i)
        rp = p.process_frame(d, i)
        assert rp["tracked"] == rj["tracked"]
        np.testing.assert_allclose(p.get_pose(), np.asarray(j.pose),
                                   atol=2e-3)
    edges = [(a, b) for a, b, _, _ in p.keyframes.edges]
    assert edges == [(a, b) for a, b, _, _ in j.keyframes.edges]
    assert (0, 3) in edges and p.keyframes.pinned[0]
    assert p.keyframes.frames == j.keyframes.frames == [4, 6, 8, 10]
    assert not np.allclose(p.trajectory_correction, np.eye(4), atol=1e-6)
    np.testing.assert_allclose(p.trajectory_correction,
                               j.trajectory_correction, atol=2e-3)
