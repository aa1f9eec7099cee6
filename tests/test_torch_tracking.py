"""Parity of the port's ICP (kernel K6's plain twins) with JAX
``ops/tracking.py``.

The reference maps come from JAX ``frame_step`` over frames 0-4 (the
raycast of frame 4); the input is frame 5's pyramid, for the TSDF field
and, for the whole tracking step, the OFusion field too (at the bench's
three levels and 10/5/4 iterations, frame 6 after frames 0-5). Result codes must
agree on >= 99.9% of pixels, the 32-vector to rtol 1e-4 (its entries are
f32 sums over the image taken in another order: each entry is held to
1e-4 of itself, floored at 1e-4 of the vector's largest entry so that a
sum that cancels to ~0 is compared on the vector's scale), poses to 1e-4.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu.core import se3 as jax_se3
from supereight_tpu.ops import tracking as jax_tracking
from supereight_tpu.pipeline import _preprocess_and_pyramid
from supereight_tpu_torch import convert
from supereight_tpu_torch.core import se3
from supereight_tpu_torch.kernels import _lib
from supereight_tpu_torch.constants import (DIST_THRESHOLD, NORMAL_THRESHOLD,
                                            TRACK_THRESHOLD)
from supereight_tpu_torch.kernels.icp import (_icp_track_plain, icp_reduce,
                                              icp_reduce_plain,
                                              icp_track_plain,
                                              solve_normal_equations)
from supereight_tpu_torch.ops import tracking
from supereight_tpu_torch.pipeline import preprocess_and_pyramid
from test_torch_step import (assert_no_drops, jax_frames, k_jax, k_torch,
                             make_scene)

ITERATIONS = (3, 2)
BENCH_ITERATIONS = (10, 5, 4)  # tools/bench.ITERATIONS


@functools.lru_cache(maxsize=None)
def _scene(field, frame=5):
    """Frame ``frame``'s depth and the JAX state after the frames before
    it of ``field``."""
    torch.set_num_threads(1)
    depths, poses = make_scene()
    states, auxes = jax_frames(depths, poses, frame, field)
    for a in auxes:
        assert_no_drops(a)
    s = states[-1]
    assert s.valid.mean() > 0.5
    return depths[frame], s


@pytest.fixture(scope="module")
def setup():
    return _scene("tsdf")


def _allclose32(got, want):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("level", [0, 1])
def test_residuals_and_reduction(setup, level):
    depth, s = setup
    _, jv, jn, jok = _preprocess_and_pyramid(jnp.asarray(depth), k_jax(), 2,
                                             False, False)
    view = jnp.matmul(jax_se3.camera_matrix(k_jax()),
                      jax_se3.inverse(jnp.asarray(s.raycast_pose)))
    pose = jnp.asarray(s.pose)
    res, err, jac = jax_tracking.track_residuals(
        jv[level], jn[level], jok[level], jnp.asarray(s.vertex),
        jnp.asarray(s.normal), jnp.asarray(s.valid), pose, view)
    red = np.asarray(jax_tracking.reduce_tracking(res, err, jac))

    _, tv, tn, tok = preprocess_and_pyramid(torch.from_numpy(depth),
                                            k_torch(), 2, False, False)
    ts = convert.frame_to_torch(s, "cpu")
    tview = se3.matmul4(se3.camera_matrix(k_torch()),
                        se3.inverse(ts.raycast_pose))
    args = (tv[level], tn[level], tok[level], ts.vertex, ts.normal, ts.valid,
            ts.pose, tview)
    tres, tred = icp_reduce_plain(*args)
    assert np.mean(tres.numpy() == np.asarray(res)) >= 0.999
    assert red[28] > 100
    _allclose32(tred.numpy(), red)
    # the wrapper takes the twin for CPU tensors
    wres, wred = icp_reduce(*args)
    np.testing.assert_array_equal(wres.numpy(), tres.numpy())
    np.testing.assert_array_equal(wred.numpy(), tred.numpy())


def test_track_parity(setup):
    depth, s = setup
    _, jv, jn, jok = _preprocess_and_pyramid(jnp.asarray(depth), k_jax(), 2,
                                             False, False)
    jpose, jtracked, jred, jres = jax_tracking.track(
        jnp.asarray(s.pose), jnp.asarray(s.raycast_pose), k_jax(), jv, jn,
        jok, jnp.asarray(s.vertex), jnp.asarray(s.normal),
        jnp.asarray(s.valid), ITERATIONS, 1e-5)
    _, tv, tn, tok = preprocess_and_pyramid(torch.from_numpy(depth),
                                            k_torch(), 2, False, False)
    ts = convert.frame_to_torch(s, "cpu")
    tpose, ttracked, tred, tres = tracking.track(
        ts.pose, ts.raycast_pose, k_torch(), tv, tn, tok, ts.vertex,
        ts.normal, ts.valid, ITERATIONS, 1e-5)
    assert bool(ttracked) == bool(jtracked) is True
    np.testing.assert_allclose(tpose.numpy(), np.asarray(jpose), atol=1e-4)
    _allclose32(tred.numpy(), np.asarray(jred))
    assert np.mean(tres.numpy() == np.asarray(jres)) >= 0.999


def _torch_inputs(depth, s, levels=2):
    """The port's tracking inputs for frame 5: (pose, view, pyramid maps of
    ``levels`` levels, reference maps) on CPU tensors."""
    _, tv, tn, tok = preprocess_and_pyramid(torch.from_numpy(depth),
                                            k_torch(), levels, False, False)
    ts = convert.frame_to_torch(s, "cpu")
    view = se3.matmul4(se3.camera_matrix(k_torch()),
                       se3.inverse(ts.raycast_pose))
    return (ts.pose, view, tv, tn, tok, ts.vertex, ts.normal, ts.valid)


@pytest.mark.parametrize("field", ["tsdf", "ofusion"])
def test_icp_track_plain_matches_jax(field):
    """K6's plain twin (the frame's whole coarse-to-fine ICP and
    check_pose) against JAX ``track``, for both fields' frames."""
    depth, s = _scene(field)
    _, jv, jn, jok = _preprocess_and_pyramid(jnp.asarray(depth), k_jax(), 2,
                                             False, False)
    jpose, jtracked, jred, jres = jax_tracking.track(
        jnp.asarray(s.pose), jnp.asarray(s.raycast_pose), k_jax(), jv, jn,
        jok, jnp.asarray(s.vertex), jnp.asarray(s.normal),
        jnp.asarray(s.valid), ITERATIONS, 1e-5)
    tpose, ttracked, tred, tres = icp_track_plain(
        *_torch_inputs(depth, s), ITERATIONS, 1e-5)
    assert bool(ttracked) == bool(jtracked) is True
    np.testing.assert_allclose(tpose.numpy(), np.asarray(jpose), atol=1e-4)
    _allclose32(tred.numpy(), np.asarray(jred))
    assert np.mean(tres.numpy() == np.asarray(jres)) >= 0.999


@pytest.mark.parametrize("field", ["tsdf", "ofusion"])
def test_icp_track_plain_matches_jax_at_the_bench_schedule(field):
    """K6's plain twin against JAX ``track`` at the bench's schedule, three
    levels of BENCH_ITERATIONS, on frame 6 of both fields, where the
    finest level converges before its last iteration (the twin freezes
    the rest, as the kernel breaks and JAX freezes them)."""
    depth, s = _scene(field, 6)
    _, jv, jn, jok = _preprocess_and_pyramid(jnp.asarray(depth), k_jax(), 3,
                                             False, False)
    jpose, jtracked, jred, jres = jax_tracking.track(
        jnp.asarray(s.pose), jnp.asarray(s.raycast_pose), k_jax(), jv, jn,
        jok, jnp.asarray(s.vertex), jnp.asarray(s.normal),
        jnp.asarray(s.valid), BENCH_ITERATIONS, 1e-5)
    tpose, ttracked, tred, tres, run = _icp_track_plain(
        *_torch_inputs(depth, s, 3), BENCH_ITERATIONS, 1e-5, DIST_THRESHOLD,
        NORMAL_THRESHOLD, TRACK_THRESHOLD)
    assert any(r < n for r, n in zip(run.tolist(), BENCH_ITERATIONS))
    assert bool(ttracked) == bool(jtracked) is True
    np.testing.assert_allclose(tpose.numpy(), np.asarray(jpose), atol=1e-4)
    _allclose32(tred.numpy(), np.asarray(jred))
    assert np.mean(tres.numpy() == np.asarray(jres)) >= 0.999


def test_track_takes_the_plain_version_on_cpu(setup):
    """ops/tracking.track on CPU tensors is the plain twin, bit for bit,
    and launches no kernel."""
    depth, s = setup
    before = dict(_lib.LAUNCHES)
    ts = convert.frame_to_torch(s, "cpu")
    _, tv, tn, tok = preprocess_and_pyramid(torch.from_numpy(depth),
                                            k_torch(), 2, False, False)
    got = tracking.track(ts.pose, ts.raycast_pose, k_torch(), tv, tn, tok,
                         ts.vertex, ts.normal, ts.valid, ITERATIONS, 1e-5)
    want = icp_track_plain(*_torch_inputs(depth, s), ITERATIONS, 1e-5)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert _lib.LAUNCHES == before


def test_solve_matches_jax():
    """The column-vectorised 6x6 Cholesky keeps JAX's summation order."""
    rng = np.random.RandomState(1)
    red = rng.standard_normal(32).astype(np.float32)
    a = rng.standard_normal((6, 6)).astype(np.float32)
    spd = a @ a.T + 6 * np.eye(6, dtype=np.float32)
    red[7:28] = [spd[r, c] for r in range(6) for c in range(r, 6)]
    want = np.asarray(jax_tracking.solve_normal_equations(jnp.asarray(red)))
    got = solve_normal_equations(torch.from_numpy(red)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # a non-SPD system solves to zeros, like the reference's LLT fallback
    red[7] = -1.0
    assert not solve_normal_equations(torch.from_numpy(red)).numpy().any()


def test_se3_exp_matches_jax():
    rng = np.random.RandomState(2)
    for scale in (1e-6, 1e-2, 0.5):
        x = (rng.standard_normal(6) * scale).astype(np.float32)
        np.testing.assert_allclose(se3.exp(torch.from_numpy(x)).numpy(),
                                   np.asarray(jax_se3.exp(jnp.asarray(x))),
                                   atol=1e-6)
