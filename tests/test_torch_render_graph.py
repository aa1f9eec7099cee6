"""The fresh view's render as one graph (``ops/rendering.FreshView``):
JAX's ``render_volume`` jit with ``reuse_maps=False`` and the composite
around it, against JAX's and the eager class's.

On the CPU the graph's program runs eagerly through the twins: on JAX's
frame-step state of five orbit frames (64^3 voxels over 2 m, 64x48
pixels, both fields, converted by ``convert.py``, JAX's drop counters and
its fresh raycast's ``ray_overflow`` asserted 0 first), the volume image
of the fresh view's composite from two poses against JAX's
``render_volume(..., reuse_maps=False)``: the lit pixels (JAX's valid
mask) exactly, the u8 grey within 1 on the pixels both light; the march's
maps against JAX's raycast, the valid mask exactly, vertices to 1e-4 m
and normals to 1e-3 where both hit. The composite's volume quadrant
equals ``render_volume``'s image and its other quadrants the single
renders, with the light given too. Through the class (six orbit frames),
the graph-mode class's fresh renders after every frame from frame 3 equal
the ``eager=True`` class's bit for bit, with one ``fresh_view`` key, the
view pose copied into its buffer and ``k`` read where it lies;
``viewer.snapshot`` renders from the raycast pose, as JAX's does; the
served CLI in its static view writes the eager run's PPMs. The
``cuda`` cases (``python -m pytest tests/test_torch_render_graph.py -m
cuda --noconftest`` on a machine with the card; they skip elsewhere)
replay the graph after the map has grown on the bench orbit and hold it
to the eager launches bit for bit, one replay a render, and a capture
that fails raising.
"""

import numpy as np
import pytest
import torch

from supereight_tpu_torch import constants as C
from supereight_tpu_torch import viewer
from supereight_tpu_torch.config import Configuration
from supereight_tpu_torch.graphs import Graphs
from supereight_tpu_torch.kernels import _lib
from supereight_tpu_torch.ops import rendering
from supereight_tpu_torch.pipeline import DenseSLAMSystem

W, H = 64, 48
K = (48.0, 48.0, 32.0, 24.0)
MU = {"tsdf": 0.1, "ofusion": 0.008}
N_FRAMES = 5
SHIFTS = (-0.5, 0.3)   # the fresh views: the pose moved back, forward


def moved(pose, shift):
    p = np.array(pose, np.float32)
    p[:3, 3] += shift * p[:3, 2]
    return p


@pytest.fixture(scope="module", params=["tsdf", "ofusion"])
def jax_state(request):
    """JAX's frame-step state after N_FRAMES orbit frames, and per fresh
    view JAX's render and its raycast's maps."""
    import jax
    import jax.numpy as jnp
    from supereight_tpu.core import se3 as jax_se3
    from supereight_tpu.fields import get_field
    from supereight_tpu.ops import raycast as jax_raycast
    from supereight_tpu.ops import rendering as jax_rendering
    from test_torch_step import (assert_no_drops, jax_frames, jax_geometry,
                                 k_jax, make_scene)
    torch.set_num_threads(1)
    name = request.param
    depths, poses = make_scene()
    states, auxes = jax_frames(depths, poses, N_FRAMES, name)
    for a in auxes:
        assert_no_drops(a)
    s = states[-1]
    jmap = jax.tree.map(jnp.asarray, s.map)
    views = {}
    for shift in SHIFTS:
        pose = moved(s.pose, shift)
        jview = jnp.matmul(jnp.asarray(pose),
                           jax_se3.inverse_camera_matrix(k_jax()),
                           precision=jax.lax.Precision.HIGHEST)
        *maps, st = jax_raycast.raycast(
            jax_geometry(), jmap, get_field(name), jview, MU[name], (W, H),
            far=2.0 * C.FAR_PLANE, with_stats=True)
        assert int(st["ray_overflow"]) == 0
        image = jax_rendering.render_volume(
            jax_geometry(), jmap, get_field(name), jnp.asarray(pose),
            k_jax(), MU[name], (W, H), reuse_maps=False)
        views[shift] = (pose, np.asarray(image),
                        [np.asarray(m) for m in maps])
    return name, s, views


def port_inputs(s, name):
    from test_torch_step import FIELDS, torch_geometry
    from supereight_tpu_torch import convert
    ts = convert.frame_to_torch(s, "cpu")
    rng = np.random.default_rng(29)
    depth = torch.from_numpy(rng.uniform(0.0, 5.0, (H, W))
                             .astype(np.float32))
    result = torch.from_numpy(rng.integers(-6, 3, (H, W)).astype(np.int32))
    return torch_geometry(), FIELDS[name], ts.map, depth, result


@pytest.mark.parametrize("shift", SHIFTS, ids=["back", "forward"])
def test_fresh_view_equals_jax_render_volume(jax_state, shift):
    """The graph's volume image against JAX's ``render_volume`` without
    ``reuse_maps``: the lit mask exact, the grey within 1; the march's
    maps against JAX's raycast: valid exact, vertex 1e-4 m, normal
    1e-3."""
    name, s, views = jax_state
    pose, want, (jv, jn, jok) = views[shift]
    geom, field, state, depth, result = port_inputs(s, name)
    fresh = rendering.FreshView(Graphs("cpu"), state, depth, result)
    comp = fresh(geom, field, pose, torch.tensor(K), MU[name], (W, H))
    got = comp[H:, W:].numpy()
    lit_got, lit_want = got[..., :3].max(-1) > 0, want[..., :3].max(-1) > 0
    assert lit_want.mean() > 0.04
    np.testing.assert_array_equal(lit_got, lit_want)
    np.testing.assert_array_equal(lit_want, jok)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    tv, tn, tok = (t.numpy() for t in rendering._fresh_maps(
        geom, state, field, torch.from_numpy(pose), torch.tensor(K),
        MU[name], (W, H)))
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_allclose(tv[tok], jv[tok], atol=1e-4, rtol=0)
    np.testing.assert_allclose(tn[tok], jn[tok], atol=1e-3, rtol=0)


@pytest.mark.parametrize("light", [False, True], ids=["pose", "given"])
def test_composite_quadrants_are_the_renders(jax_state, light):
    """The composite's volume quadrant equals ``render_volume``'s fresh
    image, its depth and track quadrants the single renders, its top
    left zero; a given light is a key of its own."""
    name, s, views = jax_state
    pose = views[SHIFTS[0]][0]
    geom, field, state, depth, result = port_inputs(s, name)
    graphs = Graphs("cpu")
    fresh = rendering.FreshView(graphs, state, depth, result)
    lt = torch.tensor((0.3, 1.7, 0.2)) if light else None
    comp = fresh(geom, field, torch.from_numpy(pose), torch.tensor(K),
                 MU[name], (W, H), light=lt)
    image = rendering.render_volume(
        geom, state, field, torch.from_numpy(pose), torch.tensor(K),
        MU[name], (W, H), light=lt)
    assert torch.equal(comp[H:, W:], image)
    assert torch.equal(comp[:H, W:], rendering.render_depth(depth))
    assert torch.equal(comp[H:, :W], rendering.render_track(result))
    assert not comp[:H, :W].any()
    assert list(graphs.entries) == [fresh.key(geom, field, MU[name], (W, H),
                                              lt)]
    assert list(graphs.entries)[0][-1] is (not light)


# ---- through the class ---------------------------------------------------

def settings(field):
    return Configuration(volume_resolution=64, volume_size=2.0,
                         mu=MU[field], camera=K, compute_size_ratio=1,
                         integration_rate=1, pyramid=(3, 2),
                         block_capacity=1024, field=field)


@pytest.fixture(scope="module", params=["tsdf", "ofusion"])
def class_runs(request):
    """The graph-mode class and the eager class over six orbit frames
    (ground truth on frames 0-1), each rendering after every frame from
    frame 3 a fresh view 0.5 m behind the frame's pose, and the tracking
    maps before and after each render."""
    from test_torch_step import make_scene
    torch.set_num_threads(1)
    field = request.param
    depths, poses = make_scene(6)
    out = {}
    for eager in (False, True):
        p = DenseSLAMSystem((W, H), settings(field), init_pose=poses[0],
                            device="cpu", eager=eager)
        renders, kept, ptrs = [], [], []
        for i, d in enumerate(depths):
            p.process_frame(d, i, is_mm=False,
                            gt_pose=poses[i] if i < 2 else None)
            if i < 3:
                continue
            maps = [t.clone() for t in (p.vertex, p.normal, p.valid)]
            view = moved(p.get_pose(), -0.5)
            renders.append((p.render_views(view), p.render_volume(view)))
            kept.append(all(torch.equal(t, m) for t, m in zip(
                (p.vertex, p.normal, p.valid), maps)))
            if not eager:
                ptrs.append((p._fresh.view_pose.data_ptr(),
                             p._fresh.k.data_ptr()))
        out[eager] = (p, renders, kept, ptrs)
    return field, out


def test_class_fresh_views_equal_eager(class_runs):
    """Every fresh render of the graph-mode class equals the eager
    class's bit for bit, the composite, its views and ``render_volume``;
    the tracking maps stay as they were."""
    field, out = class_runs
    (_, got, kept, _), (_, want, kept_e, _) = out[False], out[True]
    assert len(got) == len(want) == 3
    for i, ((views, volume), (views_e, volume_e)) in enumerate(
            zip(got, want)):
        for a, b in zip(views, views_e):
            np.testing.assert_array_equal(a, b, err_msg=f"render {i}")
        np.testing.assert_array_equal(volume, volume_e)
        np.testing.assert_array_equal(volume, views[3])
        assert volume.flags["C_CONTIGUOUS"]
        assert (volume[..., :3] > 0).any()
    assert all(kept) and all(kept_e)


def test_class_fresh_view_is_one_key(class_runs):
    """One ``fresh_view`` key for every pose; the view pose lands in the
    buffer the graph reads and ``k`` is the class's own tensor."""
    field, out = class_runs
    p, _, _, ptrs = out[False]
    keys = [k for k in p._graphs.entries if k[0] == "fresh_view"]
    assert keys == [("fresh_view", p.geom, field, (W, H), MU[field], True)]
    assert p._fresh.k is p.k
    assert len(set(ptrs)) == 1
    view = moved(p.get_pose(), -0.5)
    p.render_views(view)
    np.testing.assert_array_equal(p._fresh.view_pose.numpy(), view)
    assert out[True][0]._graphs is None


def test_snapshot_is_the_raycast_view(class_runs, tmp_path):
    """``viewer.snapshot`` renders from the raycast pose, as JAX's does (no
    fresh view): the graph-mode class's file equals the eager class's, and
    the fresh-view graph is not called."""
    _, out = class_runs
    files = []
    for eager in (False, True):
        p = out[eager][0]
        keys = None if eager else dict(p._graphs.entries)
        path = tmp_path / f"snap-{eager}.ppm"
        comp = viewer.snapshot(p, str(path))
        np.testing.assert_array_equal(comp, p.render_views()[0])
        files.append(path.read_bytes())
        if not eager:
            assert p._graphs.entries == keys
    assert files[0] == files[1]


# ---- on the card ---------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda", 0)


def bench_class(field, eager):
    """The class at the bench orbit's configuration (320x240 at 512^3
    over 4.8 m) on the card, and the orbit."""
    from supereight_tpu_torch.tools import bench
    b = bench.config(field, "cpu", n_frames=12)
    cfg = Configuration(volume_resolution=b.geom.size,
                        volume_size=b.geom.dim, mu=b.kw["mu"],
                        camera=tuple(float(c) for c in b.k),
                        compute_size_ratio=1, pyramid=bench.ITERATIONS,
                        block_capacity=b.geom.capacity, field=field)
    p = DenseSLAMSystem(b.kw["frame_size"], cfg, init_pose=b.poses[0],
                        device="cuda", eager=eager)
    return p, b


def eager_composite(p, view):
    """The eager launches of the fresh view on ``p``'s tensors (what
    ``eager=True`` runs)."""
    return rendering.render_views(
        p.float_depth, p.track_result, p.geom, p.map, p.field,
        torch.as_tensor(view).to(p.device), p.k, p.config.mu,
        p.computation_size, reuse_maps=False)


@pytest.mark.cuda
@pytest.mark.parametrize("field", ["tsdf", "ofusion"])
def test_fresh_view_replay_after_the_map_grew_on_cuda(cuda, field):
    """Captured after frame 3, replayed after frames 7 and 11 of a map
    that grew: each composite bit-equal to the eager launches on the same
    state, the replays' images new, one replay and no direct launch a
    render, the launches counted as the eager ones."""
    p, b = bench_class(field, eager=False)
    view = None
    seen, blocks = [], []
    for i in range(12):
        p.process_frame(b.depths[i], i, is_mm=False,
                        gt_pose=b.poses[i] if i < 2 else None)
        if i not in (3, 7, 11):
            continue
        if view is None:
            view = moved(p.get_pose(), -0.5)
        torch.cuda.synchronize()
        _lib.reset_launches()
        captured = p._graphs.captured()
        got = p.render_views(view)[0]
        graph_launches = dict(_lib.LAUNCHES)
        _lib.reset_launches()
        want = eager_composite(p, view).cpu().numpy()
        assert graph_launches == dict(_lib.LAUNCHES)
        np.testing.assert_array_equal(got, want, err_msg=f"frame {i}")
        assert p._graphs.captured() == captured + (i == 3)
        seen.append(got)
        blocks.append(p.block_count())
    assert blocks[0] < blocks[1] < blocks[2]
    assert not np.array_equal(seen[0], seen[1])
    assert not np.array_equal(seen[1], seen[2])
    # a replay is one graph launch and no direct kernel launch
    with _lib.host_calls() as calls:
        p.render_views(view)
    assert calls == {"launch": 0, "replay": 1}
    assert p._graphs.replays[p._fresh.key(p.geom, p.field, p.config.mu,
                                          p.computation_size)] == 3


@pytest.mark.cuda
def test_a_failed_fresh_view_capture_raises_on_cuda(cuda, monkeypatch):
    """A host read inside the captured fresh view fails its capture: the
    render raises, no fresh-view graph is kept, and the stream is usable
    after it."""
    p, b = bench_class("tsdf", eager=False)
    for i in range(4):
        p.process_frame(b.depths[i], i, is_mm=False, gt_pose=b.poses[i])
    real = rendering.raycast_mod.raycast

    def reads_back(*args, **kw):
        out = real(*args, **kw)
        if torch.cuda.is_current_stream_capturing():
            bool(out[2].any())
        return out

    monkeypatch.setattr(rendering.raycast_mod, "raycast", reads_back)
    with pytest.raises(RuntimeError):
        p.render_views(moved(p.get_pose(), -0.5))
    monkeypatch.setattr(rendering.raycast_mod, "raycast", real)
    assert not any(k[0] == "fresh_view" and e.graph is not None
                   for k, e in p._graphs.entries.items())
    assert int(torch.ones(1, device=cuda).sum()) == 1


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_served_static_view_graphs_equal_eager(tmp_path, monkeypatch):
    """The served CLI in its static view (as after a click on the viewer's
    "static view" button before the first frame) renders every rendered
    frame from one fresh view through one ``fresh_view`` key; its PPMs and
    log positions equal the ``eager=True`` run's byte for byte. On the CPU
    the graph's program runs eagerly: no replay."""
    from supereight_tpu_torch import webviewer
    from supereight_tpu_torch.tools import render_loop

    class Static(webviewer.LiveViewer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.view_mode = "static"
    monkeypatch.setattr(webviewer, "LiveViewer", Static)
    torch.set_num_threads(1)
    out = {}
    for eager in (False, True):
        run = tmp_path / ("eager" if eager else "graphs")
        argv = ["--synthetic", "10", "-v", "64", "-z", "2", "-r", "1",
                "--groundtruth-mode", "--platform", "cpu", "-o",
                str(run) + ".log", "--dump-renders", str(run),
                "--serve", str(free_port())]
        pipe, err = render_loop.run_cli(argv, eager)
        assert "# live view" in err
        digest, n = render_loop.ppm_digest(str(run))
        rows = open(str(run) + ".log").read().splitlines()
        out[eager] = (digest, n, [r.split("\t")[9:] for r in rows[1:]])
        if eager:
            assert pipe._graphs is None
        else:
            assert [k[0] for k in pipe._graphs.entries].count(
                "fresh_view") == 1
            assert not pipe._graphs.replays
    assert out[False][1] == 3
    assert out[False] == out[True]
