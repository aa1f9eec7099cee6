"""Parity of the port's depth pyramid (kernel K7's plain twins, through
``pipeline.preprocess_and_pyramid``, ``kernels/preprocess.pyramid`` for 1
to 4 levels and one by one) with JAX
``pipeline._preprocess_and_pyramid`` (filter_input=False) and its
``ops/preprocess`` functions.

Valid masks must match exactly, depth/vertex/normal floats to 1e-5
(depths exactly in the level sweep).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu.core import se3 as jax_se3
from supereight_tpu.ops import preprocess as jax_pre
from supereight_tpu.pipeline import _preprocess_and_pyramid
from supereight_tpu_torch.constants import E_DELTA
from supereight_tpu_torch.kernels import preprocess
from supereight_tpu_torch.pipeline import preprocess_and_pyramid
from test_torch_step import K, k_jax, k_torch, make_scene


@pytest.fixture(scope="module")
def depths():
    torch.set_num_threads(1)
    d, _ = make_scene(4)
    # a frame with holes: zero out a random 10% of pixels
    holes = d[3].copy()
    holes[np.random.RandomState(0).rand(*holes.shape) < 0.1] = 0.0
    return [d[0], d[3], holes]


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


def test_filters_raise():
    """Input filters are not ported: asking for one raises."""
    d = torch.zeros((48, 64))
    with pytest.raises(NotImplementedError):
        preprocess_and_pyramid(d, torch.tensor(K), 3, False, "median")
