"""Parity of the port's input stage (kernel K7's plain twins, through
``pipeline.preprocess_and_pyramid``, ``kernels/preprocess.pyramid`` for 1
to 4 levels and one by one, and the filters) with JAX
``pipeline._preprocess_and_pyramid`` and its ``ops/preprocess``
functions.

Valid masks must match exactly, depth/vertex/normal floats to 1e-5
(depths exactly in the level sweep). The median filters (one pass and
two) exactly. The bilateral filter to 1e-6 m: its range weight is an exp
of the depth difference, and torch's exp and XLA's differ by an ulp on
about a third of the pixels (4.8e-7 m at 4 m).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu.core import se3 as jax_se3
from supereight_tpu.ops import preprocess as jax_pre
from supereight_tpu.pipeline import _preprocess_and_pyramid
from supereight_tpu_torch.constants import E_DELTA
from supereight_tpu_torch.io import synthetic
from supereight_tpu_torch.kernels import preprocess
from supereight_tpu_torch.pipeline import preprocess_and_pyramid
from test_torch_step import k_jax, k_torch, make_scene

BILATERAL_ATOL = 1e-6


@pytest.fixture(scope="module")
def depths():
    torch.set_num_threads(1)
    d, _ = make_scene(4)
    # a frame with holes: zero out a random 10% of pixels
    holes = d[3].copy()
    holes[np.random.RandomState(0).rand(*holes.shape) < 0.1] = 0.0
    return [d[0], d[3], holes]


@pytest.fixture(scope="module")
def noisy():
    """Range-noised frames (sigma 0.002 z^2, mm rounding) of the orbit,
    the second with a tenth of its pixels 0."""
    d, _ = make_scene(4)
    a = synthetic.add_depth_noise(d[1], 0.002, seed=1)
    b = synthetic.add_depth_noise(d[3], 0.002, seed=3)
    b[np.random.RandomState(1).rand(*b.shape) < 0.1] = 0.0
    return [a, b]


@pytest.mark.parametrize("frame", [0, 1, 2])
@pytest.mark.parametrize("neg_y", [False, True])
def test_pyramid_parity(depths, frame, neg_y):
    d = depths[frame]
    jd, jv, jn, jok = _preprocess_and_pyramid(jnp.asarray(d), k_jax(), 3,
                                              neg_y, False)
    td, tv, tn, tok = preprocess_and_pyramid(torch.from_numpy(d), k_torch(),
                                             3, neg_y, False)
    for lvl in range(3):
        np.testing.assert_array_equal(tok[lvl].numpy(), np.asarray(jok[lvl]))
        for a, b in ((jd, td), (jv, tv), (jn, tn)):
            np.testing.assert_allclose(b[lvl].numpy(), np.asarray(a[lvl]),
                                       atol=1e-5, rtol=0)


@pytest.mark.parametrize("levels", [1, 2, 3, 4])
@pytest.mark.parametrize("crop", [False, True], ids=["even", "odd"])
@pytest.mark.parametrize("neg_y", [False, True])
def test_pyramid_levels_parity(depths, levels, crop, neg_y):
    """K7's wrapper on CPU tensors (its twin ``pyramid``) against JAX for 1
    to 4 levels on the frame with holes, whole (64x48) and cropped to
    63x47, whose odd sizes take the clamped last row and column at every
    level: depths exactly, valid masks exactly, vertices and normals to
    1e-5."""
    d = depths[2][:47, :63] if crop else depths[2]
    jd, jv, jn, jok = _preprocess_and_pyramid(jnp.asarray(d), k_jax(),
                                              levels, neg_y, False)
    td, tv, tn, tok = preprocess.pyramid(torch.from_numpy(d), k_torch(),
                                         levels, neg_y)
    assert len(td) == len(tv) == len(tn) == len(tok) == levels
    for lvl in range(levels):
        np.testing.assert_array_equal(td[lvl].numpy(), np.asarray(jd[lvl]))
        np.testing.assert_array_equal(tok[lvl].numpy(), np.asarray(jok[lvl]))
        for a, b in ((jv, tv), (jn, tn)):
            np.testing.assert_allclose(b[lvl].numpy(), np.asarray(a[lvl]),
                                       atol=1e-5, rtol=0)


@pytest.mark.parametrize("frame", [0, 1, 2])
@pytest.mark.parametrize("crop", [False, True], ids=["even", "odd"])
def test_half_sample_plain_parity(depths, frame, crop):
    """Two halvings; the odd crop (47x63) takes the clamped last row and
    column."""
    d = depths[frame][:47, :63] if crop else depths[frame]
    j, t = jnp.asarray(d), torch.from_numpy(d)
    for _ in range(2):
        j = jax_pre.half_sample_robust(j, E_DELTA * 3.0)
        t = preprocess.half_sample_plain(t, E_DELTA * 3.0)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("frame", [0, 1, 2])
@pytest.mark.parametrize("neg_y", [False, True])
def test_vertex_normal_plain_parity(depths, frame, neg_y):
    """Each level of JAX's depth pyramid through JAX depth2vertex +
    vertex2normal and the port's twin, with the level's intrinsics."""
    jd, _, _, _ = _preprocess_and_pyramid(jnp.asarray(depths[frame]),
                                          k_jax(), 3, neg_y, False)
    for lvl in range(3):
        inv_k = jax_se3.inverse_camera_matrix(k_jax() / (1 << lvl))
        jv = jax_pre.depth2vertex(jd[lvl], inv_k)
        jn, jok = jax_pre.vertex2normal(jv, neg_y)
        tv, tn, tok = preprocess.vertex_normal_plain(
            torch.tensor(np.asarray(jd[lvl])), k_torch(), lvl, neg_y)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        for a, b in ((jv, tv), (jn, tn)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5,
                                       rtol=0)


@pytest.mark.parametrize("frame", [0, 1])
@pytest.mark.parametrize("crop", [False, True], ids=["even", "odd"])
def test_bilateral_filter_plain_parity(noisy, frame, crop):
    """K7's bilateral twin against JAX ``bilateral_filter`` on a noisy
    frame, whole and cropped to odd sizes (the replicated edge)."""
    d = noisy[frame][:47, :63].copy() if crop else noisy[frame]
    want = np.asarray(jax_pre.bilateral_filter(jnp.asarray(d)))
    got = preprocess.bilateral_filter_plain(torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, want, atol=BILATERAL_ATOL, rtol=0)
    np.testing.assert_array_equal(got == 0, d == 0)
    assert np.abs(want - d).max() > 1e-3  # the filter smooths


def test_gauss_is_symmetric_to_the_bit():
    """The bilateral filter's spatial weights: g[-i] is g[i] to the bit,
    the centre's is 1."""
    g = np.asarray(preprocess.GAUSS, np.float32)
    np.testing.assert_array_equal(g.view(np.uint32),
                                  g[::-1].view(np.uint32))
    assert g[preprocess.RADIUS] == 1.0 and len(g) == 2 * preprocess.RADIUS + 1


def test_spatial_table_is_the_f32_products():
    """The kernel's 5 x 5 spatial factors are np.float32(g[i]) *
    np.float32(g[j]), and so the twin's g[i] * g[j], to the bit."""
    g = np.asarray(preprocess.GAUSS, np.float32)
    want = np.float32(g[:, None]) * np.float32(g[None, :])
    got = np.asarray(preprocess.SPATIAL, np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    gt = torch.tensor(preprocess.GAUSS, dtype=torch.float32)
    np.testing.assert_array_equal(
        got, (gt[:, None] * gt[None, :]).numpy())


@pytest.mark.parametrize("case", ["noisy", "holes", "runs"])
def test_bilateral_pair_factors_are_symmetric(noisy, case):
    """The premise of the kernel's pair sharing, on the twin at 64 x 48:
    the factor of p's tap on q at offset (i, j) equals that of q's tap
    on p at (-i, -j) bit for bit, for every pair inside the image, and
    the centre's factor is g[0]^2 (g indexed from the centre); on noisy
    depth, with a tenth of it 0, and with zero runs along rows and
    columns."""
    d = noisy[0 if case == "noisy" else 1].copy()
    if case == "runs":
        d[:, 26:32] = 0.0
        d[14:18, :] = 0.0
    assert d.shape == (48, 64) and (case == "noisy") == (d > 0).all()
    r = preprocess.RADIUS
    taps = [f for _, f in preprocess.bilateral_taps_plain(
        torch.from_numpy(d))]
    h, w = d.shape
    g0 = np.float32(preprocess.GAUSS[r])
    assert torch.equal(taps[len(taps) // 2],
                       torch.full((h, w), float(g0 * g0)))
    for i in range(-r, r + 1):
        for j in range(-r, r + 1):
            a = taps[(i + r) * (2 * r + 1) + j + r]
            b = taps[(r - i) * (2 * r + 1) + r - j]
            # p = (y, x) and q = p + (i, j) both inside the image
            pa = a[max(0, -i):h - max(0, i), max(0, -j):w - max(0, j)]
            qb = b[max(0, i):h - max(0, -i), max(0, j):w - max(0, -j)]
            assert torch.equal(pa.view(torch.int32), qb.view(torch.int32))


@pytest.mark.parametrize("frame", [0, 1])
@pytest.mark.parametrize("crop", [False, True], ids=["even", "odd"])
@pytest.mark.parametrize("passes", [1, 2])
def test_median_filter3_plain_parity(noisy, frame, crop, passes):
    """K7's median twin against JAX ``median_filter3``, once and twice
    (median2), exactly."""
    d = noisy[frame][:47, :63].copy() if crop else noisy[frame]
    want = jnp.asarray(d)
    for _ in range(passes):
        want = jax_pre.median_filter3(want)
    got = preprocess.median_filter3_plain(torch.from_numpy(d), passes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        preprocess.median_filter3(torch.from_numpy(d), passes).numpy(),
        np.asarray(want))


@pytest.mark.parametrize("filter_input",
                         [False, True, "bilateral", "median", "median2"])
def test_preprocess_and_pyramid_dispatch(noisy, filter_input):
    """``preprocess_and_pyramid`` dispatches each ``filter_input`` value as
    JAX's (pipeline.py:36-45): level 0 is the filtered depth (the median
    filters exactly, the bilateral to 1e-6), and the pyramid above it
    matches to 1e-5 with the valid masks exact; after the bilateral,
    normals to 1e-4: its ulps of depth move the central differences of a
    smoothed surface, whose neighbours lie millimetres apart."""
    d = noisy[1]
    jd, jv, jn, jok = _preprocess_and_pyramid(jnp.asarray(d), k_jax(), 3,
                                              False, filter_input)
    td, tv, tn, tok = preprocess_and_pyramid(torch.from_numpy(d), k_torch(),
                                             3, False, filter_input)
    exact = filter_input in (False, "median", "median2")
    np.testing.assert_allclose(td[0].numpy(), np.asarray(jd[0]),
                               atol=0 if exact else BILATERAL_ATOL, rtol=0)
    if filter_input:
        assert not np.array_equal(td[0].numpy(), d)
    for lvl in range(3):
        np.testing.assert_array_equal(tok[lvl].numpy(), np.asarray(jok[lvl]))
        for a, b, tol in ((jd, td, 1e-5), (jv, tv, 1e-5),
                          (jn, tn, 1e-5 if exact else 1e-4)):
            np.testing.assert_allclose(b[lvl].numpy(), np.asarray(a[lvl]),
                                       atol=tol, rtol=0)


def test_filters_refuse_bad_arguments():
    d = torch.zeros((48, 64))
    with pytest.raises(ValueError, match="passes"):
        preprocess.median_filter3(d, 3)
    with pytest.raises(ValueError, match=r"\[H, W\]"):
        preprocess.bilateral_filter(d[None])
