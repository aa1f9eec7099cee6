"""K10's ``render_views`` (``kernels/render.py``): a rendered frame's
three renders in the viewer's 2x2 composite, against JAX's three renders
placed by JAX's ``viewer.composite_views``, byte for byte.

The twin and the CPU wrapper on ``chip_smoke.render_view_edges`` (the
edge inputs of ``render_edges`` at one shape: every u16 millimetre depth,
every track code, the shading maps under the pose's light and a given
one); the class's ``render_views`` on a small map (64^3 over 2 m, 64x48
pixels, five orbit frames of the port's class, its state loaded into
JAX's class through JAX's checkpoint files, its depth and track result
set) from the raycast pose and from a fresh view, against JAX's class's
three renders in JAX's composite; the fresh view leaves the tracking maps
as they were; ``viewer.snapshot`` with an RGB image writes JAX's file; a
CPU render counts no launch and a tensor on another device is refused.
The card's checks (the kernel bit-equal to its twin and to the single
launches) are in ``tests/test_torch_kernels.py``, a file that imports no
JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from supereight_tpu import viewer as jax_viewer
from supereight_tpu.config import Configuration as JaxConfiguration
from supereight_tpu.ops import rendering as jax_rendering
from supereight_tpu.pipeline import DenseSLAMSystem as JaxSystem
from supereight_tpu_torch import viewer
from supereight_tpu_torch.config import Configuration
from supereight_tpu_torch.kernels import _lib, render
from supereight_tpu_torch.ops import rendering
from supereight_tpu_torch.pipeline import DenseSLAMSystem
from test_torch_step import K, MU, H, W, make_scene

EDGES = chip_smoke.render_view_edges(np)
N_FRAMES = 5


def _t(name):
    return torch.from_numpy(EDGES[name])


def jax_composite(light):
    e = {k: jnp.asarray(v) for k, v in EDGES.items()}
    volume = jax_rendering.render_volume(
        None, None, None, e["pose"], None, 0.1, EDGES["valid"].shape[::-1],
        light=e["light"] if light else None, vertex=e["vertex"],
        normal=e["normal"], valid=e["valid"], reuse_maps=True)
    return jax_viewer.composite_views(
        np.asarray(jax_rendering.render_depth(e["depth"])),
        np.asarray(jax_rendering.render_track(e["track"])),
        np.asarray(volume))


def test_view_edge_inputs_hold_their_cases():
    """One shape for all three; every u16 depth, every track code, and
    the shading cases on valid and invalid pixels."""
    hw = EDGES["depth"].shape
    assert EDGES["track"].shape == EDGES["valid"].shape == hw
    assert EDGES["vertex"].shape == EDGES["normal"].shape == hw + (3,)
    assert set(np.unique(EDGES["track"])) == set(range(-7, 4))
    diff = EDGES["vertex"] - EDGES["pose"][:3, 3]
    dn = np.sqrt((diff * diff).sum(-1))
    shade = (EDGES["normal"] * diff).sum(-1) / np.where(dn == 0, 1, dn)
    ok = EDGES["valid"]
    for case in (dn == 0, shade < 0, shade + 0.1 > 1):
        assert (case & ok).any() and (case & ~ok).any()


@pytest.mark.parametrize("light", [False, True], ids=["pose", "given"])
@pytest.mark.parametrize("fn", ["twin", "wrapper", "ops"])
def test_render_views_equals_jax_composite(fn, light):
    args = (_t("depth"), _t("track"), _t("vertex"), _t("normal"),
            _t("valid"), _t("pose"))
    lt = _t("light") if light else None
    if fn == "twin":
        got = render.render_views_plain(*args, lt)
    elif fn == "wrapper":
        got = render.render_views(*args, lt)
    else:
        h, w = EDGES["depth"].shape
        got = rendering.render_views(
            _t("depth"), _t("track"), None, None, None, _t("pose"), None,
            0.1, (w, h), light=lt, vertex=_t("vertex"), normal=_t("normal"),
            valid=_t("valid"), reuse_maps=True)
    want = jax_composite(light)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_render_views_counts_no_launch():
    before = dict(_lib.LAUNCHES)
    render.render_views(_t("depth"), _t("track"), _t("vertex"),
                        _t("normal"), _t("valid"), _t("pose"))
    assert _lib.LAUNCHES == before and "render_views" in before


def test_render_views_other_devices_raise():
    m = torch.zeros((4, 4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        render.render_views(
            torch.zeros((4, 4), device="meta"),
            torch.zeros((4, 4), dtype=torch.int32, device="meta"), m, m,
            torch.zeros((4, 4), dtype=torch.bool, device="meta"),
            torch.eye(4, device="meta"))


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    """The port's class after N_FRAMES orbit frames (ground-truth poses on
    frames 0-1, ICP after) and JAX's class holding its state: the map,
    poses and raycast maps through JAX's checkpoint files, the float
    depth and the track result set."""
    torch.set_num_threads(1)
    depths, poses = make_scene(N_FRAMES)
    kw = dict(volume_resolution=64, volume_size=2.0, mu=MU["tsdf"],
              camera=K, compute_size_ratio=1, integration_rate=1,
              pyramid=(3, 2), block_capacity=1024, field="tsdf")
    port = DenseSLAMSystem((W, H), Configuration(**kw), init_pose=poses[0],
                           device="cpu")
    for i, d in enumerate(depths):
        port.process_frame(d, i, is_mm=False,
                           gt_pose=poses[i] if i < 2 else None)
    ckpt = str(tmp_path_factory.mktemp("views") / "state.npz")
    port.save_checkpoint(ckpt)
    jax_pipe = JaxSystem((W, H), JaxConfiguration(**kw), init_pose=poses[0])
    jax_pipe.load_checkpoint(ckpt)
    jax_pipe.float_depth = jnp.asarray(port.float_depth.numpy())
    jax_pipe.track_result = jnp.asarray(port.track_result.numpy())
    view = np.array(poses[-1], np.float32)
    view[:3, 3] -= 0.5 * view[:3, 2]
    return port, jax_pipe, view


@pytest.mark.parametrize("view", ["raycast", "fresh"])
def test_class_render_views_equals_jax_class(pipes, view):
    """The composite and its three quadrant views against JAX's class's
    renders in JAX's composite, and against the port's single renders;
    a fresh view leaves the tracking maps as they were."""
    port, jax_pipe, pose = pipes
    pose = pose if view == "fresh" else None
    maps = [t.clone() for t in (port.vertex, port.normal, port.valid)]
    before = dict(_lib.LAUNCHES)
    comp, depth, track, volume = port.render_views(pose)
    assert _lib.LAUNCHES == before
    for t, m in zip((port.vertex, port.normal, port.valid), maps):
        assert torch.equal(t, m)
    want = jax_viewer.composite_views(jax_pipe.render_depth(),
                                      jax_pipe.render_track(),
                                      jax_pipe.render_volume(pose))
    assert (want[H:, W:, :3] > 0).any(-1).mean() > 0.2
    np.testing.assert_array_equal(comp, want)
    for got, single in ((depth, port.render_depth()),
                        (track, port.render_track()),
                        (volume, port.render_volume(pose))):
        assert got.base is comp or got.base is comp.base
        np.testing.assert_array_equal(got, single)
    # a fresh array a call: the next render does not write this one
    again = port.render_views(pose)[0]
    assert not np.shares_memory(again, comp)


def test_snapshot_writes_jax_file(pipes, tmp_path):
    """viewer.snapshot with an RGB image (its top-left quadrant filled on
    the host) writes JAX's snapshot's file byte for byte."""
    port, jax_pipe, _ = pipes
    rgb = np.random.default_rng(28).integers(0, 256, (H, W, 3), np.uint8)
    got = viewer.snapshot(port, str(tmp_path / "port.ppm"), rgb)
    want = jax_viewer.snapshot(jax_pipe, str(tmp_path / "jax.ppm"), rgb)
    np.testing.assert_array_equal(got, want)
    assert (tmp_path / "port.ppm").read_bytes() == \
        (tmp_path / "jax.ppm").read_bytes()
