"""Parity of the port's raycast (kernel K1's plain twin + kernel K2's,
the nav grid) with JAX ``ops/raycast.raycast`` on the depth-primed path
of the fused frame step, for both fields.

The map is JAX's after frames 0-4 (TSDF at mu 0.1, OFusion at mu 0.008);
both raycast it at frame 4's pose, primed with frame 4's depth. Hit masks
must agree on >= 99.5% of rays (TSDF) or 99.9% (OFusion), vertices to
1e-4 m and normals to 1e-3 on rays hit by both, and ray_overflow
exactly. A pool bucket below the block count checks that out-of-bucket
blocks read as unknown, as in the JAX strip table. The nav grid must
equal JAX ``build_nav`` exactly, with and without such a bucket.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu.core import se3 as jax_se3
from supereight_tpu.fields import get_field
from supereight_tpu.ops import raycast as jax_raycast
from supereight_tpu_torch import convert
from supereight_tpu_torch.core import se3
from supereight_tpu_torch.core.map import make_map
from supereight_tpu_torch.kernels import nav as knav
from supereight_tpu_torch.kernels import raycast as kray
from supereight_tpu_torch.ops import raycast
from test_torch_step import (CAPACITY, FIELDS, MU, H, W, assert_no_drops,
                             jax_frames, jax_geometry, k_jax, k_torch,
                             make_scene, torch_geometry)

MIN_AGREE = {"tsdf": 0.995, "ofusion": 0.999}


@pytest.fixture(scope="module", params=["tsdf", "ofusion"])
def setup(request):
    torch.set_num_threads(1)
    depths, poses = make_scene()
    states, auxes = jax_frames(depths, poses, 5, request.param)
    for a in auxes:
        assert_no_drops(a)
    return depths[4], states[-1], request.param


@pytest.mark.parametrize("bucket", [CAPACITY, 48])
def test_raycast_parity(setup, bucket):
    depth, s, name = setup
    mu = MU[name]
    assert int(s.map.n_blocks) > bucket or bucket == CAPACITY
    jview = jnp.matmul(jnp.asarray(s.pose),
                       jax_se3.inverse_camera_matrix(k_jax()),
                       precision=jax.lax.Precision.HIGHEST)
    jv, jn, jok, jst = jax_raycast.raycast(
        jax_geometry(), jax.tree.map(jnp.asarray, s.map), get_field(name),
        jview, mu, (W, H),
        prime_t=jax_raycast.prime_from_depth(jnp.asarray(depth), k_jax()),
        with_stats=True, pool_bucket=bucket)
    jv, jn, jok = np.asarray(jv), np.asarray(jn), np.asarray(jok)

    ts = convert.frame_to_torch(s, "cpu")
    view = se3.matmul4(ts.pose, se3.inverse_camera_matrix(k_torch()))
    prime = raycast.prime_from_depth(torch.from_numpy(depth), k_torch())
    np.testing.assert_allclose(
        prime.numpy(),
        np.asarray(jax_raycast.prime_from_depth(jnp.asarray(depth), k_jax())),
        rtol=1e-6)
    tv, tn, tok, tst = raycast.raycast(torch_geometry(), ts.map, FIELDS[name],
                                       view, mu, (W, H), prime_t=prime,
                                       with_stats=True, pool_bucket=bucket)
    tv, tn, tok = tv.numpy(), tn.numpy(), tok.numpy()
    assert int(tst["ray_overflow"]) == int(jst["ray_overflow"])
    assert np.mean(tok == jok) >= MIN_AGREE[name]
    both = tok & jok
    assert both.sum() > 0.3 * both.size
    np.testing.assert_allclose(tv[both], jv[both], atol=1e-4, rtol=0)
    np.testing.assert_allclose(tn[both], jn[both], atol=1e-3, rtol=0)
    if bucket == CAPACITY:
        # the fused step's own output for frame 4 (same map, pose, prime)
        assert np.mean(tok == s.valid) >= 0.995


def test_nav_grid(setup):
    """Slots for in-bucket blocks, -(1 + capped block distance) else, plus
    the OFusion coarse free-space payload."""
    _, s, name = setup
    jm = jax.tree.map(jnp.asarray, s.map)
    tm = convert.map_to_torch(s.map, "cpu")
    for bucket in (CAPACITY, 48):
        want = np.asarray(jax_raycast.build_nav(jax_geometry(), jm,
                                                get_field(name),
                                                bucket=bucket))
        got = knav.nav_grid(torch_geometry(), tm, FIELDS[name],
                            bucket=bucket).numpy()
        np.testing.assert_array_equal(got, want)
        if name == "ofusion":  # the payload is exercised
            assert ((-want - 1) >= 8).sum() > 0


def test_nav_round_half_even():
    """The OFusion payload rounds half to even like jnp.round: coarse
    values -k/32 (16 q = k/2) straddle every rounding case."""
    geom = torch_geometry()
    tm = make_map(geom, FIELDS["ofusion"], "cpu")
    b = geom.blocks_per_side
    vals = -np.arange(b ** 3, dtype=np.float32).reshape((b,) * 3) / 32.0
    tm.mip_x[0].copy_(torch.from_numpy(vals))
    tm.mip_y[0].fill_(1.0)
    tm.mip_alloc[0].fill_(True)
    jm = jax.tree.map(jnp.asarray, convert.to_numpy(tm))
    want = np.asarray(jax_raycast.build_nav(jax_geometry(), jm,
                                            get_field("ofusion")))
    got = knav.nav_grid(geom, tm, FIELDS["ofusion"]).numpy()
    np.testing.assert_array_equal(got, want)


def test_camera_zcos(setup):
    """The per-ray optical-axis cosine the OFusion sigma-band step uses
    (JAX raycast.py:436-452) at frame 4's view; the port takes 1 / sqrt
    where JAX takes rsqrt."""
    _, s, _ = setup
    jview = jnp.matmul(jnp.asarray(s.pose),
                       jax_se3.inverse_camera_matrix(k_jax()),
                       precision=jax.lax.Precision.HIGHEST)
    jd = jax_raycast.ray_directions_c(jview, W, H)
    want = np.asarray(jax_raycast.camera_zcos(
        jview, *(d.reshape(-1) for d in jd)))
    view = se3.matmul4(torch.tensor(s.pose),
                       se3.inverse_camera_matrix(k_torch()))
    got = kray.camera_zcos(view, *kray.ray_directions_c(view, W, H)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert 0.7 < want.min() and want.max() <= 1.0


def test_unported_options_raise(setup):
    _, s, name = setup
    ts = convert.frame_to_torch(s, "cpu")
    view = se3.matmul4(ts.pose, se3.inverse_camera_matrix(k_torch()))
    with pytest.raises(NotImplementedError):
        raycast.raycast(torch_geometry(), ts.map, FIELDS[name], view,
                        MU[name], (W, H), prime_t=None)
