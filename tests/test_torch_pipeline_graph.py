"""The class pipeline's stages through the class's own tensors
(``pipeline.DenseSLAMSystem``), against the eager class and JAX's.

On the card each stage of the class is one CUDA graph for each set of its
static arguments, and the stages read and write tensors the class owns,
at fixed addresses. On the CPU the same stages run eagerly through the
same tensors and copies; ``eager=True`` takes each stage's results as
they come. Both run the test orbit of ``tests/test_torch_pipeline.py``
(64^3 voxels over 2 m, 64x48 pixels, ICP 3/2, the ground truth on frames
0-1): TSDF over eight frames, OFusion over six, and TSDF over eight noisy
frames with the noise options of ``tests/test_torch_noise.py``. Every
frame must be bit-equal between the two (pose, old pose, raycast pose,
reference maps, reduction, track result, float depth, pyramid, every
counter, and the map at the end); against JAX's class the poses agree to
2e-3 and the results and blocks are equal, JAX's drop counters zero. The
owned tensors keep their addresses across frames, through ``set_pose``,
the ground-truth pose, the keyframe re-anchor and ``load_checkpoint``;
and each new allocation budget and budget bucket adds one stage key.
The ``cuda`` cases (``python -m pytest tests/test_torch_pipeline_graph.py
-m cuda --noconftest`` on a machine with the card; they skip elsewhere)
hold the graphs to the eager class over the bench orbit of both fields,
bit for bit and launch for launch, and a capture that fails raising.
This file imports JAX only inside the CPU fixture that compares with it.
"""

import numpy as np
import pytest
import torch

from supereight_tpu_torch import pipeline
from supereight_tpu_torch.config import Configuration
from supereight_tpu_torch.kernels import _lib
from supereight_tpu_torch.pipeline import DenseSLAMSystem
from test_torch_graph import CASES, MU, H, K, W
from test_torch_graph import scene as orbit

N_GT = 2          # frames given their ground-truth pose
COUNTERS = ("alloc_overflow", "blocks_truncated", "patch_skipped",
            "mip_skipped", "ray_overflow", "pool_bucket_overflow")
# the class's own tensors, which keep their addresses
OWNED = ("pose", "old_pose", "raycast_pose", "vertex", "normal", "valid",
         "reduction", "track_result", "float_depth", "pyr", "map",
         "_tracked", "_depth_in", "_timestamp", "_mats")


def leaves(x):
    return pipeline._leaves(x)


def snapshot(p, r):
    """A pipeline's outputs after a frame, copied: its result and every
    tensor of its state."""
    out = {"result": {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                      for k, v in r.items()}}
    for name in OWNED[:11]:
        out[name] = [t.clone() for t in leaves(getattr(p, name))]
    return out


def addresses(p):
    out = {name: [t.data_ptr() for t in leaves(getattr(p, name))]
           for name in OWNED}
    out["stats"] = {k: v.data_ptr() for k, v in p.stats.items()}
    return out


def assert_same(a, b, what):
    assert a.keys() == b.keys(), what
    ra, rb = a["result"], b["result"]
    assert ra.keys() == rb.keys(), what
    for k in ra:
        if isinstance(ra[k], torch.Tensor):
            assert torch.equal(ra[k].to(torch.int64), rb[k].to(torch.int64)), \
                (what, k)
        else:
            assert ra[k] == rb[k], (what, k)
    for name in OWNED[:11]:
        assert len(a[name]) == len(b[name]), (what, name)
        for x, y in zip(a[name], b[name]):
            assert x.dtype == y.dtype and torch.equal(x, y), (what, name)


def scene(case, n=None):
    field, frames, noise, options = CASES[case]
    depths, poses = orbit(frames if n is None else n, noise)
    return field, options, depths, poses


def settings(field, **kw):
    """``tests/test_torch_pipeline.py``'s class configuration."""
    base = dict(volume_resolution=64, volume_size=2.0, mu=MU[field],
                camera=K, compute_size_ratio=1, integration_rate=1,
                pyramid=(3, 2), block_capacity=1024, field=field)
    return {**base, **kw}


def result(r):
    return {k: int(v) for k, v in r.items()}


def run(system, depths, poses, n_gt=N_GT, first=0):
    """Frames ``first``.. of the orbit through ``system``: each frame's
    snapshot."""
    out = []
    for i in range(first, len(depths)):
        gt = poses[i] if i < n_gt else None
        r = system.process_frame(depths[i], i, is_mm=False, gt_pose=gt)
        out.append(snapshot(system, r))
    return out


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    """The buffered class, the eager class and JAX's class over a case's
    frames: the snapshots, the JAX results, poses and blocks, and the
    buffered class's addresses after each frame."""
    from supereight_tpu.config import Configuration as JaxConfiguration
    from supereight_tpu.pipeline import DenseSLAMSystem as JaxSystem
    torch.set_num_threads(1)
    case = request.param
    field, options, depths, poses = scene(case)
    cfg = settings(field, **options)
    systems = {name: DenseSLAMSystem((W, H), Configuration(**cfg),
                                     init_pose=poses[0], device="cpu",
                                     eager=name == "eager")
               for name in ("buffered", "eager")}
    j = JaxSystem((W, H), JaxConfiguration(**cfg), init_pose=poses[0])
    out = {"buffered": [], "eager": [], "jax": [], "addresses": []}
    for i, d in enumerate(depths):
        gt = poses[i] if i < N_GT else None
        for name, p in systems.items():
            r = p.process_frame(d, i, is_mm=False, gt_pose=gt)
            out[name].append(snapshot(p, r))
        out["addresses"].append(addresses(systems["buffered"]))
        rj = j.process_frame(d, i, is_mm=False, gt_pose=gt)
        out["jax"].append((result(rj), j.get_pose(), j.block_count()))
    return case, systems, out


def test_buffered_class_equals_eager_every_frame(runs):
    case, systems, out = runs
    for i, (a, b) in enumerate(zip(out["buffered"], out["eager"])):
        assert_same(a, b, f"{case} frame {i}")
    assert systems["buffered"].block_count() > 0
    assert systems["eager"]._graphs is None
    assert systems["buffered"].graph_stats() == {"graphs": 0,
                                                 "pool_bytes": 0}


def test_buffered_class_matches_jax(runs):
    case, systems, out = runs
    assert all(r["tracked"] for r, _, _ in out["jax"][4:])
    for i, (snap, (rj, pj, bj)) in enumerate(zip(out["buffered"],
                                                 out["jax"])):
        for c in COUNTERS:
            assert rj.get(c, 0) == 0, (case, i, c)
        assert result(snap["result"]) == rj, (case, i)
        n_blocks = int(snap["map"][5])
        assert n_blocks == bj, (case, i)
        np.testing.assert_allclose(snap["pose"][0].numpy(), pj, atol=2e-3,
                                   err_msg=f"{case} frame {i} diverged")


def test_owned_tensors_keep_their_addresses(runs):
    """Every owned tensor, stats included once written, at one address
    on every frame; the stats are those tensors."""
    case, systems, out = runs
    first = out["addresses"][0]
    for i, addr in enumerate(out["addresses"]):
        for name in OWNED:
            assert addr[name] == first[name], (case, i, name)
        for k, v in addr["stats"].items():
            assert v == out["addresses"][-1]["stats"][k], (case, i, k)
    p = systems["buffered"]
    assert all(p.stats[k] is p._stats[k] for k in p.stats)
    assert set(p.stats) == set(pipeline.STATS)


def test_old_pose_is_the_pose_before_tracking(runs):
    """After a tracked frame that moved, ``old_pose`` holds the frame's
    pose before tracking (the last frame's pose), not the new one."""
    case, _, out = runs
    snaps = out["buffered"]
    for i in range(4, len(snaps)):
        assert snaps[i]["result"]["tracked"]
        assert torch.equal(snaps[i]["old_pose"][0], snaps[i - 1]["pose"][0])
        assert not torch.equal(snaps[i]["old_pose"][0], snaps[i]["pose"][0])


def test_set_pose_and_gt_pose_write_into_the_owned_pose():
    """``set_pose`` and ``process_frame``'s ``gt_pose`` copy into the
    pose tensor the stages read; the run equals the eager class's."""
    torch.set_num_threads(1)
    _, _, depths, poses = scene("tsdf", 6)
    cfg = Configuration(**settings("tsdf"))
    snaps = {}
    for eager in (False, True):
        p = DenseSLAMSystem((W, H), cfg, init_pose=poses[0], device="cpu",
                            eager=eager)
        ptr = p.pose.data_ptr()
        got = []
        for i, d in enumerate(depths):
            if i % 2:
                p.set_pose(poses[i])
                r = p.process_frame(d, i, is_mm=False, gt_pose=poses[i])
            else:
                r = p.process_frame(d, i, is_mm=False)
            got.append(snapshot(p, r))
            if i % 2:
                np.testing.assert_array_equal(p.get_pose(), poses[i])
        if not eager:
            assert p.pose.data_ptr() == ptr
            p.set_pose(poses[0])
            assert p.pose.data_ptr() == ptr
            np.testing.assert_array_equal(p.get_pose(), poses[0])
        snaps[eager] = got
    for i, (a, b) in enumerate(zip(snaps[False], snaps[True])):
        assert_same(a, b, f"frame {i}")


def test_reanchor_writes_into_the_owned_pose(monkeypatch):
    """The keyframe step's re-anchor (``enable_keyframes(reanchor=True)``)
    copies the corrected pose into the pose tensor; the run equals the
    eager class's. The correction is a fixed small motion, so that the
    copy is seen."""
    torch.set_num_threads(1)
    from supereight_tpu_torch.posegraph.keyframes import KeyframeManager
    corr = np.eye(4, dtype=np.float32)
    corr[:3, 3] = (1e-3, -2e-3, 5e-4)
    monkeypatch.setattr(KeyframeManager, "correction_for_latest",
                        lambda self: corr)
    _, _, depths, poses = scene("tsdf", 8)
    cfg = Configuration(**settings("tsdf"))
    snaps, moved = {}, {}
    for eager in (False, True):
        p = DenseSLAMSystem((W, H), cfg, init_pose=poses[0], device="cpu",
                            eager=eager)
        p.enable_keyframes(every=2, ba_every=1, loop_closure=False,
                           reanchor=True)
        ptr = p.pose.data_ptr()
        snaps[eager] = run(p, depths, poses)
        moved[eager] = p.trajectory_correction
        if not eager:
            assert p.pose.data_ptr() == ptr
            assert len(p.keyframes.poses) >= 2
    np.testing.assert_array_equal(moved[False], corr)
    for i, (a, b) in enumerate(zip(snaps[False], snaps[True])):
        assert_same(a, b, f"frame {i}")


def test_load_checkpoint_after_frames_resumes_in_place(tmp_path):
    """``load_checkpoint`` into a pipeline that has run frames copies the
    map and the poses and maps into its own tensors; the resumed frames
    equal the uninterrupted run bit for bit (the
    ``test_resume_matches_uninterrupted`` idiom)."""
    torch.set_num_threads(1)
    _, _, depths, poses = scene("tsdf", 10)
    cfg = Configuration(**settings("tsdf"))

    def system():
        return DenseSLAMSystem((W, H), cfg, init_pose=poses[0], device="cpu")

    a = system()
    whole = run(a, depths, poses, n_gt=4)
    b = system()
    run(b, depths[:6], poses, n_gt=4)
    ckpt = str(tmp_path / "run.npz")
    b.save_checkpoint(ckpt)
    c = system()
    run(c, depths[:4], poses, n_gt=4)   # frames before the load
    before = addresses(c)
    c.load_checkpoint(ckpt)
    assert addresses(c) == before
    assert c.block_count() == b.block_count()
    resumed = run(c, depths, poses, n_gt=4, first=6)
    for i, (x, y) in enumerate(zip(resumed, whole[6:])):
        # the counters a frame does not write carry over from earlier
        # frames, which the checkpoint does not hold
        x["result"] = y["result"] = {k: v for k, v in x["result"].items()
                                     if k in ("tracked", "integrated",
                                              "raycasted")}
        assert_same(x, y, f"frame {6 + i}")
    assert addresses(c) == before


def test_new_budgets_add_one_key_each(monkeypatch):
    """The allocation budget, started at 2, doubles after frames 0 and 8
    (JAX's poll), each doubling one new ``allocate`` key; a budget bucket
    that doubles between two frames adds one ``fuse`` and one
    ``raycast`` key. The run equals the eager class's."""
    torch.set_num_threads(1)
    _, _, depths, poses = scene("tsdf", 10)
    cfg = Configuration(**settings("tsdf", block_capacity=2048))
    bucket = DenseSLAMSystem._budget_bucket

    def doubled(self):
        # the rule's own value, doubled from frame 5 on
        return bucket(self) * (2 if self._frame >= 5 else 1)

    monkeypatch.setattr(DenseSLAMSystem, "_budget_bucket", doubled)
    snaps, keys = {}, None
    for eager in (False, True):
        p = DenseSLAMSystem((W, H), cfg, init_pose=poses[0], device="cpu",
                            eager=eager)
        p._alloc_budget = 2
        got = []
        for i, d in enumerate(depths):
            p._frame = i
            r = p.process_frame(d, i, is_mm=False, gt_pose=poses[i])
            got.append(snapshot(p, r))
        snaps[eager] = got
        if not eager:
            keys = list(p._graphs.entries)
    assert [k[2] for k in keys if k[0] == "allocate"] == [2, 4, 8]
    assert [k[2] for k in keys if k[0] == "fuse"] == [1024, 2048]
    assert [k[2] for k in keys if k[0] == "raycast"] == [1024, 2048]
    assert sum(k[0] == "preprocess" for k in keys) == 1
    assert not any(k[0] == "track" for k in keys)   # ground truth only
    for i, (a, b) in enumerate(zip(snaps[False], snaps[True])):
        assert_same(a, b, f"frame {i}")


# ---- on the card ---------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda", 0)


def card_run(field, eager, n=12, system=None):
    """The bench orbit of ``field`` (320x240 at 512^3 over 4.8 m, ICP
    10/5/4) through the class on the card, the ground truth on frames
    0-1: each frame's snapshot and the launches."""
    from supereight_tpu_torch.tools import bench
    b = bench.config(field, "cpu", n_frames=n)
    cfg = Configuration(volume_resolution=b.geom.size,
                        volume_size=b.geom.dim, mu=b.kw["mu"],
                        camera=tuple(float(c) for c in b.k),
                        compute_size_ratio=1, pyramid=bench.ITERATIONS,
                        block_capacity=b.geom.capacity, field=field)
    p = system or DenseSLAMSystem(b.kw["frame_size"], cfg,
                                  init_pose=b.poses[0], device="cuda",
                                  eager=eager)
    torch.cuda.synchronize()
    _lib.reset_launches()
    out = run(p, b.depths, b.poses)
    torch.cuda.synchronize()
    return p, out, dict(_lib.LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("field", ["tsdf", "ofusion"])
def test_graphs_equal_eager_on_cuda(cuda, field):
    """Every frame of the orbit through the stage graphs bit-equal to the
    eager class, the map too, and the launches the replays count equal
    to the eager class's."""
    _, want, eager_launches = card_run(field, True)
    p, got, launches = card_run(field, False)
    for i, (a, b) in enumerate(zip(got, want)):
        assert_same(a, b, f"frame {i}")
    assert launches == eager_launches
    assert eager_launches["icp_track"] == len(got) - N_GT
    # one graph a stage and set of static arguments: the budget bucket
    # grows with the map, and each new one is a new fuse graph and, once
    # the frames raycast (frame 3 on), a new raycast graph
    keys = list(p._graphs.entries)
    stages = [k[0] for k in keys]
    assert stages.count("preprocess") == stages.count("track") == 1
    assert stages.count("allocate") == 1
    fused = [k[2] for k in keys if k[0] == "fuse"]
    cast = [k[2] for k in keys if k[0] == "raycast"]
    assert cast and set(cast) <= set(fused) and fused == sorted(set(fused))
    assert p.graph_stats()["graphs"] == len(keys)
    assert p.graph_stats()["pool_bytes"] > 0


@pytest.mark.cuda
def test_a_failed_stage_capture_raises_on_cuda(cuda, monkeypatch):
    """A host read inside a captured stage fails its capture: the frame
    raises, no graph of that stage is kept, and the stream is usable
    after it."""
    real = pipeline.tracking.track

    def reads_back(*args, **kw):
        out = real(*args, **kw)
        if torch.cuda.is_current_stream_capturing():
            bool(out[1])
        return out

    monkeypatch.setattr(pipeline.tracking, "track", reads_back)
    with pytest.raises(RuntimeError):
        card_run("tsdf", False, n=4)
    monkeypatch.setattr(pipeline.tracking, "track", real)
    assert int(torch.ones(1, device=cuda).sum()) == 1
