"""The port's renders (``ops/rendering``) and K1's unprimed march against
the JAX package's.

``gs2rgb``, ``render_depth`` and ``render_track`` are held to JAX's
exactly (u8 for u8, and the rainbow's f32 values), and ``render_volume``
with the tracking maps reused too, on JAX's frame-step state. A fresh
view raycasts the map without a depth prime: the unprimed twin
(``kernels/raycast.raycast_plain`` with no depth) against JAX's
``ops/raycast.raycast`` without ``prime_t`` on the 64^3 map of five
frames, both fields, from the pose moved 0.5 m back (marched to twice the
far plane, as the render does) and from a view whose centre ray starts 5
cm behind the surface, where some rays start behind a surface and must
miss in both (JAX's ``ray_overflow`` asserted 0 first). Hit masks agree on
>= 99.9 % of rays, vertices to 1e-4 m and normals to 1e-3 on the rays both
hit; the fresh render's u8 pixels on >= 99.9 %.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import blocked_starts
from supereight_tpu.core import se3 as jax_se3
from supereight_tpu.fields import get_field
from supereight_tpu.ops import raycast as jax_raycast
from supereight_tpu.ops import rendering as jax_rendering
from supereight_tpu_torch import constants as C
from supereight_tpu_torch import convert
from supereight_tpu_torch.kernels import frame
from supereight_tpu_torch.kernels import nav as knav
from supereight_tpu_torch.kernels import raycast as kray
from supereight_tpu_torch.ops import rendering
from test_torch_step import (FIELDS, MU, H, W, assert_no_drops, jax_frames,
                             jax_geometry, k_jax, k_torch, make_scene,
                             torch_geometry)


@pytest.fixture(scope="module", params=["tsdf", "ofusion"])
def setup(request):
    torch.set_num_threads(1)
    depths, poses = make_scene()
    states, auxes = jax_frames(depths, poses, 5, request.param)
    for a in auxes:
        assert_no_drops(a)
    return depths[4], states[-1], request.param


def moved(pose, shift):
    p = np.array(pose, np.float32)
    p[:3, 3] += shift * p[:3, 2]
    return p


def test_gs2rgb_equals_jax():
    d = np.concatenate([np.linspace(-0.5, 1.5, 4001),
                        np.arange(7) / 6.0]).astype(np.float32)
    np.testing.assert_array_equal(
        rendering.gs2rgb(torch.from_numpy(d)).numpy(),
        np.asarray(jax_rendering.gs2rgb(jnp.asarray(d))))


def test_render_depth_and_track_equal_jax():
    """u8 for u8: depths below near, above far, missing and across the
    range; every tracking status code and others."""
    rng = np.random.default_rng(0)
    depth = rng.uniform(0.0, 5.0, (48, 64)).astype(np.float32)
    depth[0, :8] = 0.0
    depth[1, :8] = np.float32(C.NEAR_PLANE)
    depth[2, :8] = np.float32(C.FAR_PLANE)
    depth[3, :] = np.linspace(C.NEAR_PLANE, C.FAR_PLANE, 64)
    got = rendering.render_depth(torch.from_numpy(depth)).numpy()
    want = np.asarray(jax_rendering.render_depth(jnp.asarray(depth)))
    assert got.dtype == np.uint8 and got.shape == (48, 64, 4)
    np.testing.assert_array_equal(got, want)
    result = rng.integers(-6, 3, (48, 64)).astype(np.int32)
    got = rendering.render_track(torch.from_numpy(result)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_rendering.render_track(jnp.asarray(result))))


def test_render_volume_reusing_maps_equals_jax(setup):
    """The shaded render from the raycast pose, on the tracking maps of
    JAX's frame step, u8 for u8."""
    _, s, name = setup
    want = np.asarray(jax_rendering.render_volume(
        jax_geometry(), jax.tree.map(jnp.asarray, s.map), get_field(name),
        jnp.asarray(s.raycast_pose), k_jax(), MU[name], (W, H),
        vertex=jnp.asarray(s.vertex), normal=jnp.asarray(s.normal),
        valid=jnp.asarray(s.valid), reuse_maps=True))
    ts = convert.frame_to_torch(s, "cpu")
    got = rendering.render_volume(
        torch_geometry(), ts.map, FIELDS[name], ts.raycast_pose, k_torch(),
        MU[name], (W, H), vertex=ts.vertex, normal=ts.normal,
        valid=ts.valid, reuse_maps=True).numpy()
    assert int(s.valid.sum()) > 0.3 * s.valid.size
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("view", ["back", "behind"])
def test_unprimed_raycast_matches_jax(setup, view):
    """The fresh view's march without a prime against JAX's."""
    depth, s, name = setup
    mu = MU[name]
    if view == "back":
        pose, far = moved(s.pose, -0.5), 2.0 * C.FAR_PLANE
    else:
        centre = float(depth[H // 2, W // 2])
        pose, far = moved(s.pose, centre - C.NEAR_PLANE + 0.05), C.FAR_PLANE
    jview = jnp.matmul(jnp.asarray(pose),
                       jax_se3.inverse_camera_matrix(k_jax()),
                       precision=jax.lax.Precision.HIGHEST)
    jv, jn, jok, jst = jax_raycast.raycast(
        jax_geometry(), jax.tree.map(jnp.asarray, s.map), get_field(name),
        jview, mu, (W, H), far=far, with_stats=True)
    assert int(jst["ray_overflow"]) == 0
    jv, jn, jok = np.asarray(jv), np.asarray(jn), np.asarray(jok)

    ts = convert.frame_to_torch(s, "cpu")
    tview = frame.frame_mats(k_torch(), torch.from_numpy(pose)).kpose
    nav = knav.nav_grid(torch_geometry(), ts.map, FIELDS[name])
    rays, probes = kray.raycast_plain(
        torch_geometry(), FIELDS[name], ts.map.data_x, ts.map.data_y, nav,
        tview, None, None, mu, (W, H), with_probes=True, far=far)
    tv, tn, tok = (rays.vertex.numpy(), rays.normal.numpy(),
                   rays.valid.numpy())
    assert int(rays.overflow) == 0
    assert np.mean(tok == jok) >= 0.999
    both = tok & jok
    assert both.sum() > 0.1 * both.size
    np.testing.assert_allclose(tv[both], jv[both], atol=1e-4, rtol=0)
    np.testing.assert_allclose(tn[both], jn[both], atol=1e-3, rtol=0)
    # rays with a range in the map that take no march probe start behind
    # a surface; JAX misses them too
    blocked = blocked_starts(torch_geometry(), tview, probes, far).numpy()
    if view == "behind":
        assert blocked.sum() > 50
    assert not (jok | tok)[blocked].any()


def test_render_volume_fresh_view_matches_jax(setup):
    """The shaded render from a view that is not the raycast pose (K1's
    unprimed march to twice the far plane) against JAX's, on >= 99.9 % of
    pixels."""
    _, s, name = setup
    pose = moved(s.pose, -0.5)
    want = np.asarray(jax_rendering.render_volume(
        jax_geometry(), jax.tree.map(jnp.asarray, s.map), get_field(name),
        jnp.asarray(pose), k_jax(), MU[name], (W, H)))
    ts = convert.frame_to_torch(s, "cpu")
    got = rendering.render_volume(
        torch_geometry(), ts.map, FIELDS[name], torch.from_numpy(pose),
        k_torch(), MU[name], (W, H)).numpy()
    assert (want[..., :3] > 0).any(-1).mean() > 0.2
    assert (got == want).all(-1).mean() >= 0.999
