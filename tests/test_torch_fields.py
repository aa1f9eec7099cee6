"""Parity of the port's field functors with JAX ``fields/``.

``fields/ofusion.update`` (and its pieces) against the JAX functions on
random inputs made with numpy from a seed: voxels in front of and behind
the surface, decayed from older time stamps, at both log-odds clamps
(+/-1000), at the sample clamp's lower bound 0.03 and exactly at
``sample == 0.5`` (no write: on the surface, and 6 sigma behind it).
Values to a relative 1e-6; the write mask and time stamps exactly.
``fields/tsdf.update`` with and without ``noise_weighted`` on the same
inputs: weights and the write mask exactly, values to 1e-6 (a ray
scale's square, which torch and XLA may round an ulp apart).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu.fields import get_field as jax_get_field
from supereight_tpu.fields import ofusion as jof
from supereight_tpu.fields import tsdf as jtsdf
from supereight_tpu_torch.fields import OFUSION, TSDF, get_field
from supereight_tpu_torch.fields import ofusion as tof
from supereight_tpu_torch.fields import tsdf as ttsdf

MU = 0.008
VOXEL = 2.0 / 64
N = 4096


def _inputs(seed):
    rng = np.random.default_rng(seed)
    pz = rng.uniform(0.3, 3.5, N).astype(np.float32)
    px = (pz * rng.uniform(-0.7, 0.7, N)).astype(np.float32)
    py = (pz * rng.uniform(-0.5, 0.5, N)).astype(np.float32)
    # depth a few sigma around the voxel; some missing, some exactly on
    # the voxel (sample 0.5) and some far in front of it (6+ sigma behind
    # the surface: sample 0.5 again)
    depth = (pz + rng.normal(0.0, 0.08, N)).astype(np.float32)
    depth[rng.random(N) < 0.1] = 0.0
    depth[:64] = pz[:64]
    depth[64:128] = pz[64:128] - 0.5
    old_x = rng.uniform(-20.0, 20.0, N).astype(np.float32)
    old_x[128:256] = np.float32(1000.0)
    old_x[256:384] = np.float32(-1000.0)
    old_y = rng.choice(np.float32([0.0, 1 / 30, 0.1, 0.2, 1.0]), N)
    valid = rng.random(N) < 0.9
    timestamp = np.float32(1.0 / 30.0) * np.float32(rng.integers(0, 40))
    return px, py, pz, depth, old_x, old_y.astype(np.float32), valid, \
        timestamp


def test_get_field_and_specs_match_jax():
    assert get_field("ofusion") is OFUSION
    assert get_field("occupancy") is OFUSION
    assert get_field("TSDF") is TSDF
    for name, spec in (("ofusion", OFUSION), ("tsdf", TSDF)):
        j = jax_get_field(name)
        for attr in ("name", "init", "empty", "multiscale_alloc",
                     "invert_normals"):
            assert getattr(spec, attr) == getattr(j, attr), (name, attr)
    with pytest.raises(ValueError):
        get_field("bfusion")


def test_bspline_and_h_match_jax():
    t = np.linspace(-7.0, 7.0, 20001, dtype=np.float32)
    t = np.concatenate([t, np.float32([-3, -1, 0, 1, 3, 6])])
    for tf, jf in ((tof.bspline, jof.bspline), (tof.H, jof.H)):
        got = tf(torch.from_numpy(t)).numpy()
        want = np.asarray(jf(jnp.asarray(t)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # the no-write value of the update gate is exact on and far behind
    # the surface
    h = tof.H(torch.tensor([0.0, 6.5])).numpy()
    np.testing.assert_array_equal(h, np.float32([0.5, 0.5]))


@pytest.mark.parametrize("seed", [0, 1])
def test_ofusion_update_matches_jax(seed):
    px, py, pz, depth, old_x, old_y, valid, ts = _inputs(seed)
    want = jof.update(jnp.asarray(old_x), jnp.asarray(old_y),
                      (jnp.asarray(px), jnp.asarray(py), jnp.asarray(pz)),
                      jnp.asarray(depth), MU, jnp.float32(ts), VOXEL,
                      jnp.asarray(valid))
    got = tof.update(torch.from_numpy(old_x), torch.from_numpy(old_y),
                     (torch.from_numpy(px), torch.from_numpy(py),
                      torch.from_numpy(pz)),
                     torch.from_numpy(depth), MU, torch.tensor(ts), VOXEL,
                     torch.from_numpy(valid))
    nx, ny, wrote = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(got[2].numpy(), wrote)
    np.testing.assert_array_equal(got[1].numpy(), ny)
    np.testing.assert_allclose(got[0].numpy(), nx, rtol=1e-6, atol=1e-6)
    # every rule of the functor is exercised
    assert wrote.any() and (~wrote & valid & (depth > 0)).any()
    assert not wrote[:128].any()                  # sample == 0.5
    assert (nx[wrote] == 1000.0).any() and (nx[wrote] == -1000.0).any()
    decayed = wrote & (old_y < ts) & (np.abs(old_x) < 1000)
    assert decayed.any()
    sample = np.asarray(jof.H(jnp.asarray(
        (pz - depth) * np.sqrt(1 + (px / pz) ** 2 + (py / pz) ** 2)
        / np.clip(MU * pz * pz, 2 * VOXEL, 0.05))))
    # the sample clamp's lower bound (H peaks near 0.90, so the upper
    # bound 0.97 is out of its reach)
    assert ((sample < 0.03) & wrote).any() and 0.85 < sample.max() < 0.97


def test_apply_window_and_logs_match_jax():
    rng = np.random.default_rng(3)
    occ = rng.uniform(-1000, 1000, 512).astype(np.float32)
    dt = rng.uniform(0.0, 10.0, 512).astype(np.float32)
    s = rng.uniform(0.03, 0.97, 512).astype(np.float32)
    np.testing.assert_allclose(
        tof.apply_window(torch.from_numpy(occ), torch.from_numpy(dt)).numpy(),
        np.asarray(jof.apply_window(jnp.asarray(occ), jnp.asarray(dt))),
        rtol=1e-6)
    np.testing.assert_allclose(
        tof.update_logs(torch.from_numpy(occ), torch.from_numpy(s)).numpy(),
        np.asarray(jof.update_logs(jnp.asarray(occ), jnp.asarray(s))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("noise_weighted", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_tsdf_update_matches_jax(seed, noise_weighted):
    """The TSDF functor, with the range weight clip((1.5 / z)^2, 1/16, 1)
    when ``noise_weighted``: weights and the write mask exactly, values to
    1e-6, on voxels from 0.3 to 8 m (both weight clamps), weights from 0
    to past MAX_WEIGHT."""
    px, py, pz, depth, old_x, _, valid, _ = _inputs(seed)
    rng = np.random.default_rng(seed + 10)
    old_x = np.clip(old_x / 20.0, -1.0, 1.0).astype(np.float32)
    old_y = rng.uniform(0.0, 101.0, N).astype(np.float32)
    old_y[:256] = 0.0
    # fresh voxels, some past 6 m (the weight's 1/16 floor)
    far = np.float32(rng.uniform(6.5, 8.0, 56)) / pz[200:256]
    px[200:256] *= far
    py[200:256] *= far
    pz[200:256] *= far
    depth[:256] = pz[:256] + 0.01
    mu = 0.1
    want = jtsdf.update(jnp.asarray(old_x), jnp.asarray(old_y),
                        (jnp.asarray(px), jnp.asarray(py), jnp.asarray(pz)),
                        jnp.asarray(depth), mu, jnp.asarray(valid),
                        noise_weighted=noise_weighted)
    got = ttsdf.update(torch.from_numpy(old_x), torch.from_numpy(old_y),
                       (torch.from_numpy(px), torch.from_numpy(py),
                        torch.from_numpy(pz)),
                       torch.from_numpy(depth), mu, torch.from_numpy(valid),
                       noise_weighted=noise_weighted)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-6, rtol=0)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    wrote = np.asarray(want[2])
    assert wrote.any() and (~wrote & valid).any()
    # the first voxels start from weight 0: their new weight is the
    # sample's; the cap holds everywhere
    fresh = wrote & (old_y == 0.0)
    w = np.asarray(want[1])[fresh]
    assert np.asarray(want[1])[wrote].max() == 100.0
    if noise_weighted:  # both clamps of the weight and the range between
        assert (w == 1.0).any() and (w == np.float32(1 / 16)).any()
        assert ((w < 1.0) & (w > 1 / 16)).any()
    else:
        assert set(np.unique(w)) == {1.0}
