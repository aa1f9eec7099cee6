"""The frame program (``parallel/step.FrameProgram``): the fused frame step
as one CUDA graph for each set of static arguments, replayed once a
frame, the counterpart of JAX's jit of ``frame_step``.

On the CPU (the caller asks for it, as here) the program runs
``frame_step`` eagerly through its own buffers, copies back and packed
row, so these tests hold that plumbing at ``tests/test_torch_step.py``'s
sizes (64^3 voxels over 2 m, 64x48 pixels, ICP (3, 2)):

* every frame bit-equal to the eager ``frame_step`` (pose, raycast pose,
  reference maps, every aux entry and the map at the end), and to JAX's
  ``frame_step`` poses to 2e-3 and the block count and counters exactly,
  JAX's drop counters zero first: TSDF (8 frames), OFusion (6) and TSDF
  with the noise options of ``tests/test_torch_noise.py`` (8);
* every state leaf keeps its address across frames;
* a snapshot loaded and replayed gives the same frames;
* a second budget is a second key; the ground-truth path runs through
  the program's static ``gt_pose`` input and is refused without one;
* the launch counts of a capture and its replays (``kernels/_lib.py``).

The ``cuda`` tests (``python -m pytest tests/test_torch_graph.py -m cuda
--noconftest`` on a machine with the card; they skip elsewhere) replay
the captured graph on the card: bit-equal to the eager step over the
bench orbit of both fields, launches counted by replays equal to the
eager step's, two budget buckets, an aux row copied at frame i intact
after frame i + 1, and a capture that fails raising. This file imports
JAX only inside the CPU tests that compare with it.
"""

import numpy as np
import pytest
import torch

from supereight_tpu_torch.core.map import MapGeometry
from supereight_tpu_torch.fields import OFUSION, TSDF
from supereight_tpu_torch.io import synthetic
from supereight_tpu_torch.kernels import _lib
from supereight_tpu_torch.parallel import step
from supereight_tpu_torch.tools import bench

# tests/test_torch_step.py's scene (that module imports JAX)
W, H = 64, 48
K = (48.0, 48.0, 32.0, 24.0)
DIM = 2.0
CAPACITY = 1024
FIELDS = {"tsdf": TSDF, "ofusion": OFUSION}
STEP_KW = dict(frame_size=(W, H), iterations=(3, 2), icp_threshold=1e-5,
               neg_y=False, filter_input=False, use_gt_pose=False,
               integration_rate=1, tracking_rate=1, budget=CAPACITY)
MU = {"tsdf": 0.1, "ofusion": 0.008}
NOISE = 0.002
CASES = {  # name -> (field, frames, noise, frame-step options)
    "tsdf": ("tsdf", 8, False, {}),
    "ofusion": ("ofusion", 6, False, {}),
    "tsdf-noise": ("tsdf", 8, True, dict(filter_input="median2",
                                        fuse_filtered=True, min_ref_weight=4,
                                        noise_weighted=True)),
}
OUTPUTS = ("pose", "raycast_pose", "vertex", "normal", "valid")


def scene(n, noise=False):
    """(depths [n, H, W], poses) of the test orbit, numpy; with ``noise``
    frame i noised as ``add_depth_noise(d, 0.002, seed=i)``."""
    depths, poses = synthetic.orbit_sequence(
        n, K, width=W, height=H, radius=0.4 * DIM, center=(DIM / 2,) * 3,
        sphere_radius=0.15 * DIM, angle_span=0.3,
        room=((0.15,) * 3, (DIM - 0.15,) * 3))
    if noise:
        depths = np.stack([synthetic.add_depth_noise(d, NOISE, seed=i)
                           for i, d in enumerate(depths)])
    return depths, poses


def geometry():
    return MapGeometry(size=64, dim=DIM, capacity=CAPACITY)


def step_kw(field, **options):
    return {**STEP_KW, "mu": MU[field], **options}


def init(field, poses, device="cpu"):
    return step.init_frame_state(geometry(), FIELDS[field], (W, H),
                                 poses[0], device)


def outputs(state, aux):
    """Host copies of a frame's outputs: the state's pose, raycast pose
    and reference maps and every aux entry."""
    out = {name: getattr(state, name).cpu().clone() for name in OUTPUTS}
    out.update((k, v.cpu().clone()) for k, v in aux.items())
    return out


def assert_equal(got, want, where):
    for k, v in want.items():
        assert torch.equal(got[k], v), (where, k)


def packed(aux):
    return torch.stack([aux[k].reshape(()).to(torch.int32)
                        for k in step.AUX_SCALARS])


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    """One case through the eager step and the program on the CPU: per
    frame both's outputs and the program's leaf addresses, and the final
    states."""
    torch.set_num_threads(1)
    field, n, noise, options = CASES[request.param]
    depths, poses = scene(n, noise)
    kw = step_kw(field, **options)
    k = torch.tensor(K)
    geom = geometry()
    eager = init(field, poses)
    prog = step.FrameProgram(geom, FIELDS[field], init(field, poses))
    frames = []
    for i in range(n):
        d = torch.from_numpy(depths[i])
        eager, eaux = step.frame_step(geom, FIELDS[field], eager, d, k, i,
                                      **kw)
        state, aux = prog(d, k, i, **kw)
        frames.append((outputs(eager, eaux), outputs(state, aux),
                       [t.data_ptr() for t in step.state_leaves(state)]))
    return request.param, depths, poses, frames, eager, prog


def test_program_equals_the_eager_step_bit_for_bit(runs):
    _, _, _, frames, eager, prog = runs
    for i, (want, got, _) in enumerate(frames):
        assert_equal(got, want, f"frame {i}")
        assert torch.equal(got["scalars"], packed(want))
    for a, b in zip(step.state_leaves(prog.state),
                    step.state_leaves(eager)):
        assert torch.equal(a, b)
    assert len(prog.graphs) == 1


def test_program_follows_jax(runs):
    """Against JAX's frame_step over the same frames: poses to 2e-3, the
    block count and every counter exactly, JAX's drop counters zero."""
    import test_torch_step as ts  # imports JAX: the CPU tests only
    name, depths, poses, frames, _, _ = runs
    field, n, _, options = CASES[name]
    # this file's scene and keywords are that module's
    np.testing.assert_array_equal(scene(2)[0], ts.make_scene(2)[0])
    assert step_kw(field) == ts.step_kw(field)
    jstates, jaux = ts.jax_frames(depths, poses, n, field, **options)
    for a in jaux:
        ts.assert_no_drops(a)
    assert sum(bool(a["tracked"]) for a in jaux) >= n - 4
    for i, (js, a, (_, got, _)) in enumerate(zip(jstates, jaux, frames)):
        np.testing.assert_allclose(got["pose"].numpy(), js.pose, atol=2e-3,
                                   err_msg=f"frame {i} diverged")
        for key in ("n_blocks", "tracked", "integrated") + ts.COUNTERS:
            assert int(got[key]) == int(a[key]), (i, key)


def test_state_leaves_keep_their_addresses(runs):
    _, _, _, frames, _, prog = runs
    first = [t.data_ptr() for t in step.state_leaves(prog.state)]
    assert all(ptrs == first for _, _, ptrs in frames)
    assert len(first) == len(set(first))


def test_a_loaded_snapshot_replays_the_same_frames():
    torch.set_num_threads(1)
    depths, poses = scene(6)
    kw = step_kw("tsdf")
    k = torch.tensor(K)
    prog = step.FrameProgram(geometry(), TSDF, init("tsdf", poses))
    ptrs = [t.data_ptr() for t in step.state_leaves(prog.state)]
    seen = {}
    for i in range(6):
        if i == 3:
            snapshot = bench.clone_state(prog.state)
        seen[i] = outputs(*prog(torch.from_numpy(depths[i]), k, i, **kw))
    end = [t.clone() for t in step.state_leaves(prog.state)]
    prog.load(snapshot)
    for i in range(3, 6):
        got = outputs(*prog(torch.from_numpy(depths[i]), k, i, **kw))
        assert_equal(got, seen[i], f"replayed frame {i}")
    for a, b in zip(step.state_leaves(prog.state), end):
        assert torch.equal(a, b)
    assert [t.data_ptr() for t in step.state_leaves(prog.state)] == ptrs
    with pytest.raises(ValueError, match="load"):
        prog.load(init("ofusion", poses)._replace(
            vertex=torch.zeros((H, W + 1, 3))))


def test_a_second_budget_is_a_second_key():
    """A budget bucket is a static argument: a new one is a new key (a
    new graph on the card, as JAX recompiles), an old one finds its key;
    every frame equals the eager step at the same budgets."""
    torch.set_num_threads(1)
    depths, poses = scene(5)
    k = torch.tensor(K)
    geom = geometry()
    prog = step.FrameProgram(geom, TSDF, init("tsdf", poses))
    eager = init("tsdf", poses)
    budgets = (1024, 512, 1024, 512, 512)
    for i, budget in enumerate(budgets):
        kw = step_kw("tsdf", budget=budget)
        d = torch.from_numpy(depths[i])
        eager, eaux = step.frame_step(geom, TSDF, eager, d, k, i, **kw)
        got = outputs(*prog(d, k, i, **kw))
        assert_equal(got, outputs(eager, eaux), f"frame {i}")
    keys = list(prog.graphs)
    assert keys == [step.static_key(**step_kw("tsdf", budget=b))
                    for b in (1024, 512)]
    assert dict(keys[1])["budget"] == 512
    assert dict(keys[0])["alloc_budget"] is None  # the default filled in


def test_ground_truth_poses_go_through_a_static_input():
    """``use_gt_pose``: the frame's ground-truth pose is copied into the
    program's own [4, 4] input, which frame_step reads; the frames equal
    the eager step's with the same poses. Without a pose the program
    refuses, naming the option."""
    torch.set_num_threads(1)
    depths, poses = scene(4)
    kw = step_kw("tsdf", use_gt_pose=True)
    k = torch.tensor(K)
    geom = geometry()
    prog = step.FrameProgram(geom, TSDF, init("tsdf", poses))
    eager = init("tsdf", poses)
    addr = prog.gt_pose.data_ptr()
    for i in range(4):
        d = torch.from_numpy(depths[i])
        eager, eaux = step.frame_step(geom, TSDF, eager, d, k, i, poses[i],
                                      **kw)
        got = outputs(*prog(d, k, i, poses[i], **kw))
        assert_equal(got, outputs(eager, eaux), f"frame {i}")
        assert torch.equal(prog.gt_pose, torch.from_numpy(poses[i]))
        assert torch.equal(got["pose"], torch.from_numpy(poses[i]))
    assert prog.gt_pose.data_ptr() == addr
    with pytest.raises(ValueError, match="use_gt_pose"):
        prog(torch.from_numpy(depths[0]), k, 0, **kw)


def test_static_key_and_refused_inputs():
    kw = step_kw("tsdf")
    key = dict(step.static_key(**{**kw, "iterations": [3, 2]}))
    assert key["iterations"] == (3, 2) and key["min_ref_weight"] == 0
    assert [name for name, _ in step.static_key(**kw)] == [
        name for name, _ in step.STATIC]
    with pytest.raises(TypeError, match="geom"):
        step.static_key(geom=geometry(), **kw)
    with pytest.raises(TypeError, match="'mu'"):
        step.static_key(**{k: v for k, v in kw.items() if k != "mu"})
    depths, poses = scene(1)
    prog = step.FrameProgram(geometry(), TSDF, init("tsdf", poses))
    k = torch.tensor(K)
    with pytest.raises(ValueError, match="depth_m"):
        prog(torch.zeros((H, W + 1)), k, 0, **kw)
    with pytest.raises(ValueError, match="frame"):
        prog(torch.from_numpy(depths[0]), k, -1, **kw)
    # a frame index as a tensor goes into the program's i32[] input
    prog(torch.from_numpy(depths[0]), k, torch.tensor(0), **kw)
    assert prog.frame.dtype == torch.int32 and int(prog.frame) == 0
    assert prog.input_ops == 3


def test_capture_records_launches_and_replays_add_them():
    """``_lib.capturing`` takes the launches of a capture as the graph's
    table and leaves the counts as they were; ``replayed`` adds the table
    once a replay; ``reset_launches`` zeroes them all."""
    saved = dict(_lib.LAUNCHES)
    try:
        _lib.reset_launches()
        _lib.LAUNCHES["pyramid"] = 5
        with _lib.capturing() as table:
            _lib.LAUNCHES["pyramid"] += 1
            _lib.LAUNCHES["frame_mats"] += 2
        assert table == {"pyramid": 1, "frame_mats": 2}
        assert _lib.LAUNCHES["pyramid"] == 5
        assert _lib.LAUNCHES["frame_mats"] == 0
        for _ in range(3):
            _lib.replayed(table)
        assert _lib.LAUNCHES["pyramid"] == 8
        assert _lib.LAUNCHES["frame_mats"] == 6
        with pytest.raises(RuntimeError):
            with _lib.capturing() as failed:
                _lib.LAUNCHES["nav_grid"] += 1
                raise RuntimeError("capture failed")
        assert failed == {"nav_grid": 1} and _lib.LAUNCHES["nav_grid"] == 0
        _lib.reset_launches()
        assert not any(_lib.LAUNCHES.values())
    finally:
        _lib.LAUNCHES.update(saved)


def test_frame_split_of_a_replayed_trace():
    """``deviceprof.frame_split`` on two frames of three device events
    (start, duration in us): busy, span, idle inside, gap between."""
    from supereight_tpu_torch.utils import deviceprof
    events = [(0.0, 2.0), (3.0, 4.0), (8.0, 1.0),
              (10.0, 1.0), (11.5, 2.0), (14.0, 3.0)]
    split = deviceprof.frame_split(events, 2)
    assert split == dict(busy_us=6.5, span_us=8.0, inside_us=1.5,
                         between_us=1.0, events=3)
    assert deviceprof.frame_split(events[:5], 2) is None
    assert deviceprof.frame_split([], 0) is None


# ---- on the card ---------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda", 0)


def card_bench(field, device, n=12):
    """The bench orbit of ``field`` on the card, cut to ``n`` frames."""
    return bench.config(field, device, n_frames=n)


def eager_run(b, n, budgets=None):
    """The eager step over ``n`` frames of ``b``: each frame's outputs,
    and the launches."""
    state = b.init()
    torch.cuda.synchronize()
    _lib.reset_launches()
    out = []
    for i in range(n):
        kw = dict(b.kw, budget=budgets[i]) if budgets else b.kw
        state, aux = step.frame_step(b.geom, b.field, state, b.frames[i],
                                     b.k, i, **kw)
        out.append(outputs(state, aux))
    return out, dict(_lib.LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("field", ["tsdf", "ofusion"])
def test_replay_equals_eager_on_cuda(cuda, field):
    """Every frame of the orbit replayed (frame 0 is the capture's
    eager warm-up) bit-equal to the eager step, and the launches counted
    by the replays equal the eager step's."""
    n = 12
    b = card_bench(field, cuda, n)
    want, eager_launches = eager_run(b, n)
    prog = b.program()
    torch.cuda.synchronize()
    _lib.reset_launches()
    for i in range(n):
        got = outputs(*b.graph_frame(prog, i))
        assert_equal(got, want[i], f"frame {i}")
        assert torch.equal(got["scalars"], packed(want[i]))
    assert dict(_lib.LAUNCHES) == eager_launches
    assert eager_launches["icp_track"] == n
    assert len(prog.graphs) == 1


@pytest.mark.cuda
def test_two_buckets_on_cuda(cuda):
    n = 8
    budgets = [8192] * 4 + [16384] * 2 + [8192] * 2
    b = card_bench("tsdf", cuda, n)
    want, eager_launches = eager_run(b, n, budgets)
    prog = b.program()
    torch.cuda.synchronize()
    _lib.reset_launches()
    for i in range(n):
        got = outputs(*prog(b.frames[i], b.k, i,
                            **dict(b.kw, budget=budgets[i])))
        assert_equal(got, want[i], f"frame {i}")
    assert dict(_lib.LAUNCHES) == eager_launches
    assert [dict(key)["budget"] for key in prog.graphs] == [8192, 16384]


@pytest.mark.cuda
def test_a_copied_aux_outlives_the_next_replay_on_cuda(cuda):
    """A replay rewrites its aux in place; the row copied at frame i is
    frame i's after frame i + 1."""
    b = card_bench("tsdf", cuda, 6)
    want, _ = eager_run(b, 6)
    prog = b.program()
    kept = []
    for i in range(6):
        _, aux = b.graph_frame(prog, i)
        kept.append((aux, aux["scalars"].clone()))
    for i in range(6):
        assert torch.equal(kept[i][1].cpu(), packed(want[i]))
    # frame 0's aux is the capture's eager warm-up's; the replays of
    # frames 1-5 share one, which holds the last frame's values
    assert all(kept[i][0] is kept[5][0] for i in range(1, 5))
    assert torch.equal(kept[1][0]["scalars"].cpu(), packed(want[5]))


@pytest.mark.cuda
def test_a_failed_capture_raises_on_cuda(cuda, monkeypatch):
    """A host read inside the captured frame fails the capture: the call
    raises, keeps no graph, and the stream is usable after it."""
    b = card_bench("tsdf", cuda, 2)
    prog = b.program()
    real = step.frame_step

    def reads_back(*args, **kw):
        out = real(*args, **kw)
        if torch.cuda.is_current_stream_capturing():
            int(out[1]["n_blocks"])
        return out

    monkeypatch.setattr(step, "frame_step", reads_back)
    with pytest.raises(RuntimeError):
        b.graph_frame(prog, 0)
    assert not prog.graphs
    monkeypatch.setattr(step, "frame_step", real)
    assert int(torch.ones(1, device=cuda).sum()) == 1

