"""Parity of the port's fused frame step with the JAX reference under
range noise, with the noise-grade options on.

The orbit of ``test_torch_step.py`` (64^3 voxels over 2.0 m, 64x48
pixels, ICP (3, 2)) with each frame i noised as the JAX package's
``add_depth_noise(d, 0.002, seed=i)`` makes it (sigma = 0.002 z^2, mm
rounding), run frame by frame through JAX ``frame_step`` on the CPU and
the port's on CPU tensors (the kernels' twins):

* TSDF with the options of the ``tsdf icp noise=0.002+levers`` row of
  ``EVAL_table.md`` (``filter_input="median2"``, ``fuse_filtered``,
  ``min_ref_weight=4``, ``noise_weighted``), eight frames;
* OFusion with the bilateral filter, ``fuse_filtered`` and the bilinear
  depth read (``depth_interp``), six frames.

Poses must agree frame by frame to 2e-3 (the ``tests/test_dist.py:83``
idiom; the bilateral's exp and XLA's fused multiply-adds put ulps between
the two, which ICP carries forward), and ``n_blocks``, ``tracked``,
``integrated`` and every drop counter exactly, JAX's counters zero.
"""

import numpy as np
import pytest
import torch

from supereight_tpu.io import synthetic as jax_synthetic
from supereight_tpu_torch.io import synthetic
from test_torch_step import (COUNTERS, assert_no_drops, jax_frames,
                             make_scene, torch_frames)

NOISE = 0.002
CASES = {
    "tsdf-noise": ("tsdf", 8, dict(filter_input="median2",
                                   fuse_filtered=True, min_ref_weight=4,
                                   noise_weighted=True)),
    "ofusion-bilateral": ("ofusion", 6, dict(filter_input="bilateral",
                                             fuse_filtered=True,
                                             depth_interp=True)),
}


def noisy_scene(n):
    """(noisy depths [n, H, W], poses) of the orbit, numpy."""
    depths, poses = make_scene(n)
    return np.stack([synthetic.add_depth_noise(d, NOISE, seed=i)
                     for i, d in enumerate(depths)]), poses


@pytest.mark.parametrize("frame", [0, 3, 7])
def test_add_depth_noise_matches_jax(frame):
    """The port's noise model draws JAX's noisy frame bit for bit: numpy's
    RandomState(seed), the mm rounding, 0 kept 0."""
    depths, _ = make_scene(8)
    d = depths[frame].copy()
    d[::7, ::5] = 0.0
    got = synthetic.add_depth_noise(d, NOISE, seed=frame)
    want = jax_synthetic.add_depth_noise(d, NOISE, seed=frame)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got == 0, d == 0)
    assert 0 < np.abs(got - d).max() < 0.1


@pytest.fixture(scope="module", params=list(CASES))
def trajectories(request):
    torch.set_num_threads(1)
    field, n, options = CASES[request.param]
    depths, poses = noisy_scene(n)
    jstates, jaux = jax_frames(depths, poses, n, field, **options)
    _, tposes, taux = torch_frames(depths, poses, n, field, **options)
    return [s.pose for s in jstates], jaux, tposes, taux


def test_noisy_frame_step_pose_parity(trajectories):
    jposes, jaux, tposes, _ = trajectories
    for a in jaux:
        assert_no_drops(a)
    assert sum(bool(a["tracked"]) for a in jaux) >= len(jaux) - 4
    for i, (a, b) in enumerate(zip(jposes, tposes)):
        np.testing.assert_allclose(b, a, atol=2e-3,
                                   err_msg=f"frame {i} diverged")


@pytest.mark.parametrize("key", ("n_blocks", "tracked", "integrated")
                         + COUNTERS)
def test_noisy_frame_step_aux_parity(trajectories, key):
    _, jaux, _, taux = trajectories
    for i, (a, b) in enumerate(zip(jaux, taux)):
        assert int(b[key]) == int(a[key]), (i, key, a[key], b[key])


def test_noisy_touched_buffer_is_zero_after_every_frame(trajectories):
    _, _, _, taux = trajectories
    assert [a["touched_left"] for a in taux] == [0] * len(taux)
