"""K10 ``render`` (``kernels/render.py``): its twins against JAX's jitted
renders, u8 for u8, on the edge inputs of ``chip_smoke.render_edges``,
and the wrapper's dispatch.

Every u16 millimetre depth / 1000 and the near and far planes with their
f32 neighbours (``render_depth``, JAX's default planes folded into its
jit); the track codes -7 to 3; shading maps with vertices at the light,
back-facing normals, shades that clamp at 1 and a checkerboard of
``valid`` False, with the light from the pose and given apart. On the
CPU each wrapper runs its twin and counts no launch; a tensor on another
device is refused. The card's checks (K10 bit-equal to its twins) are in
``tests/test_torch_kernels.py``, a file that imports no JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from supereight_tpu.ops import rendering as jax_rendering
from supereight_tpu_torch import constants as C
from supereight_tpu_torch.kernels import _lib, render
from supereight_tpu_torch.ops import rendering
from supereight_tpu_torch.tools import longseq, render_loop

EDGES = chip_smoke.render_edges(np)


def _t(name):
    return torch.from_numpy(EDGES[name])


def test_edge_inputs_hold_their_cases():
    """The depth image holds every u16 / 1000 and the planes' neighbours;
    the shading maps hold zero distances, shades below 0 and at the
    clamp, on valid and invalid pixels."""
    d = EDGES["depth"].reshape(-1)
    assert np.array_equal(d[:65536], np.arange(65536, dtype=np.float32)
                          / np.float32(1000.0))
    for p in (np.float32(C.NEAR_PLANE), np.float32(C.FAR_PLANE)):
        assert {np.nextafter(p, np.float32(-1)), p,
                np.nextafter(p, np.float32(9))} <= set(d[65536:].tolist())
    v, n, ok = EDGES["vertex"], EDGES["normal"], EDGES["valid"]
    diff = v - EDGES["pose"][:3, 3]
    dn = np.sqrt((diff * diff).sum(-1))
    shade = (n * diff).sum(-1) / np.where(dn == 0, 1, dn)
    for case in (dn == 0, shade < 0, shade + 0.1 > 1):
        assert (case & ok).any() and (case & ~ok).any()
    assert set(np.unique(EDGES["track"])) == set(range(-7, 4))


@pytest.mark.parametrize("fn", ["twin", "wrapper"])
def test_render_depth_equals_jax_on_every_u16(fn):
    got = (render.render_depth_plain if fn == "twin"
           else rendering.render_depth)(_t("depth")).numpy()
    want = np.asarray(jax_rendering.render_depth(jnp.asarray(EDGES["depth"])))
    assert got.dtype == np.uint8 and got.shape == EDGES["depth"].shape + (4,)
    np.testing.assert_array_equal(got, want)
    # past the far plane black, below near white, at d >= 1 red
    d = EDGES["depth"]
    assert (got[d > C.FAR_PLANE][:, :3] == 0).all()
    assert (got[d < np.float32(C.NEAR_PLANE)][:, :3] == 255).all()
    assert (got[(d >= 3.99) & (d <= C.FAR_PLANE)][:, 0] == 255).all()


@pytest.mark.parametrize("fn", ["twin", "wrapper"])
def test_render_track_equals_jax_on_every_code(fn):
    got = (render.render_track_plain if fn == "twin"
           else rendering.render_track)(_t("track")).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_rendering.render_track(
        jnp.asarray(EDGES["track"]))))


@pytest.mark.parametrize("light", [False, True], ids=["pose", "given"])
@pytest.mark.parametrize("fn", ["twin", "wrapper"])
def test_render_volume_equals_jax_on_edge_maps(fn, light):
    """The shading on the maps (JAX's render_volume with reuse_maps; its
    map, field and intrinsics are not read there)."""
    h, w = EDGES["valid"].shape
    lt = _t("light") if light else None
    if fn == "twin":
        got = render.render_volume_plain(_t("vertex"), _t("normal"),
                                         _t("valid"), _t("pose"), lt)
    else:
        got = rendering.render_volume(
            None, None, None, _t("pose"), None, 0.1, (w, h), light=lt,
            vertex=_t("vertex"), normal=_t("normal"), valid=_t("valid"),
            reuse_maps=True)
    want = np.asarray(jax_rendering.render_volume(
        None, None, None, jnp.asarray(EDGES["pose"]), None, 0.1, (w, h),
        light=jnp.asarray(EDGES["light"]) if light else None,
        vertex=jnp.asarray(EDGES["vertex"]),
        normal=jnp.asarray(EDGES["normal"]),
        valid=jnp.asarray(EDGES["valid"]), reuse_maps=True))
    np.testing.assert_array_equal(got.numpy(), want)
    col = want[..., 0][EDGES["valid"]]
    assert {25, 255} <= set(col.tolist())  # ambient alone, the clamp
    assert (want[~EDGES["valid"]] == 0).all()


def test_cpu_renders_count_no_launch():
    before = dict(_lib.LAUNCHES)
    render.render_depth(_t("depth"))
    render.render_track(_t("track"))
    render.render_volume(_t("vertex"), _t("normal"), _t("valid"), _t("pose"))
    assert _lib.LAUNCHES == before
    assert {"render_depth", "render_track", "render_volume"} <= set(before)


def test_other_devices_raise():
    m = torch.zeros((4, 4, 3), device="meta")
    v = torch.zeros((4, 4), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        render.render_depth(torch.zeros((4, 4), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        render.render_track(torch.zeros((4, 4), dtype=torch.int32,
                                        device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        render.render_volume(m, m, v, torch.eye(4, device="meta"))


class _Pipe:
    """The class's three render calls on the edge inputs, on the CPU (a
    class without ``render_views``, as the parent's)."""

    def render_depth(self):
        return render.render_depth(_t("depth")[:48, :64]).numpy()

    def render_track(self):
        return render.render_track(_t("track")).numpy()

    def render_volume(self):
        return render.render_volume(_t("vertex"), _t("normal"), _t("valid"),
                                    _t("pose")).numpy()


class _ViewsPipe(_Pipe):
    """The class's composite of :class:`_Pipe`'s inputs, on the CPU."""

    def _composite(self, view_pose=None):
        return render.render_views(_t("depth")[:48, :64], _t("track"),
                                   _t("vertex"), _t("normal"), _t("valid"),
                                   _t("pose"))

    def render_views(self, view_pose=None):
        comp = self._composite(view_pose).numpy()
        return comp, comp[:48, 64:], comp[48:, :64], comp[48:, 64:]


def test_render_loop_tool(tmp_path):
    """tools/render_loop: the eval's TSDF row as chip_smoke's pipeline
    path runs it, the rendered frames' column, the split's parts, the
    PPM digest, no run without a card, and the CLI's class restored
    after an eager run that fails."""
    assert sorted(render_loop.ARGS) == sorted(
        chip_smoke.PIPE_ARGS + chip_smoke.PIPE_FIELD_ARGS["tsdf"])
    assert render_loop.ARGS[:len(longseq.BASE_ARGS)] == longseq.BASE_ARGS
    rows = [{"frame": float(f), "rendering": 0.001 * f} for f in range(250)]
    col = render_loop.column_ms(rows, 4)
    assert col["frames"] == 62 and col["mean"] == pytest.approx(126.0)
    for pipe, names, ppm in ((_Pipe(), render_loop.PARENT_PARTS, "a.ppm"),
                             (_ViewsPipe(), render_loop.PARTS, "b.ppm")):
        parts = render_loop.split(pipe, str(tmp_path / ppm), reps=2)
        assert list(parts) == list(names)
        assert all(0 <= p["min"] <= p["median"] for p in parts.values())
    # the two splits' PPMs: the same composite
    assert (tmp_path / "a.ppm").read_bytes() == \
        (tmp_path / "b.ppm").read_bytes()
    digest, n = render_loop.ppm_digest(str(tmp_path))
    assert n == 2 and len(digest) == 64
    assert (tmp_path / "a.ppm").read_bytes()[:14] == b"P6\n128 96\n255\n"
    if not torch.cuda.is_available():
        assert render_loop.main(["--raw", "none.raw"]) == 2
    real = render_loop.cli.DenseSLAMSystem
    with pytest.raises(SystemExit):
        render_loop.run_cli(["--no-such-option"], eager=True)
    assert render_loop.cli.DenseSLAMSystem is real
