"""Parity of the port's allocation (kernel K5's plain twins + the cumsum
bump allocator + the mip refresh) with JAX ``ops/allocation``:
``allocate_tsdf`` and ``allocate_ofusion``.

The map is JAX's after frames 0-2 of its field (TSDF at mu 0.1, OFusion
at mu 0.008); frame 3's depth is allocated at frame 3's ground-truth
pose. The touched grids (all three levels for OFusion), slot grid,
block_coord, n_blocks, active and mip_alloc must match exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu.ops import allocation as jax_allocation
from supereight_tpu_torch import convert
from supereight_tpu_torch.core import se3
from supereight_tpu_torch.kernels import alloc
from supereight_tpu_torch.kernels.alloc import (touched_mask,
                                                touched_mask_plain)
from supereight_tpu_torch.ops import allocation
from test_torch_step import (assert_no_drops, jax_frames, jax_geometry,
                             k_jax, k_torch, make_scene, torch_geometry)

MU = 0.1
MU_OF = 0.008


def _setup(field):
    torch.set_num_threads(1)
    depths, poses = make_scene()
    states, auxes = jax_frames(depths, poses, 3, field)
    for a in auxes:
        assert_no_drops(a)
    return depths[3], poses[3].astype(np.float32), states[-1].map


@pytest.fixture(scope="module")
def setup():
    return _setup("tsdf")


@pytest.fixture(scope="module")
def setup_of():
    return _setup("ofusion")


def test_touched_mask_parity(setup):
    depth, pose, _ = setup
    want = np.asarray(jax_allocation.tsdf_touched_mask(
        jax_geometry(), jnp.asarray(depth), jnp.asarray(pose), k_jax(), MU))
    tp = torch.from_numpy(pose)
    got = touched_mask(torch_geometry(), torch.from_numpy(depth), tp,
                       k_torch(), MU)
    assert want.sum() > 50
    np.testing.assert_array_equal(got.numpy(), want)
    kpose = se3.matmul4(tp, se3.inverse_camera_matrix(k_torch()))
    plain = touched_mask_plain(torch_geometry(), torch.from_numpy(depth), tp,
                               kpose, MU)
    np.testing.assert_array_equal(plain.numpy(), want)


@pytest.mark.parametrize("budget,when", [(None, True), (None, False),
                                         (2, True)])
def test_allocate_tsdf_parity(setup, budget, when):
    """Default budget, the masked (when=False) step, and an overflowing
    budget of 2 new blocks (the ascending-cell-id cut)."""
    depth, pose, jmap = setup
    jm, jstats = jax_allocation.allocate_tsdf(
        jax_geometry(), jax_map(jmap), jnp.asarray(depth), jnp.asarray(pose),
        k_jax(), MU, with_stats=True, when=jnp.bool_(when), budget=budget)
    tm, tstats = allocation.allocate_tsdf(
        torch_geometry(), convert.map_to_torch(jmap, "cpu"),
        torch.from_numpy(depth),
        torch.from_numpy(pose), k_torch(), MU, with_stats=True,
        when=torch.tensor(when), budget=budget)
    assert int(tstats["alloc_overflow"]) == int(jstats["alloc_overflow"])
    if budget == 2:
        assert int(jstats["alloc_overflow"]) > 0
    jm = convert.to_numpy(convert.map_to_torch(jm, "cpu"))
    tm = convert.to_numpy(tm)
    assert int(tm.n_blocks) == int(jm.n_blocks)
    if when:
        assert int(jm.n_blocks) > int(jmap.n_blocks)
    for name in ("slot", "block_coord", "active"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name),
                                      err_msg=name)
    for lvl, (a, b) in enumerate(zip(tm.mip_alloc, jm.mip_alloc)):
        np.testing.assert_array_equal(a, b, err_msg=f"mip_alloc[{lvl}]")


@pytest.mark.parametrize("max_dist", [None, 0.5])
def test_step_ladder_matches_jax(max_dist):
    """The static (distance, level) ladder of the occupancy march, with
    the default range (dim * sqrt 3) and one that ends in level 1."""
    band = 6.0 * MU_OF
    md = jax_geometry().dim * np.sqrt(3.0) if max_dist is None else max_dist
    want = jax_allocation.ofusion_step_ladder(jax_geometry(), band, md)
    got = alloc.ofusion_step_ladder(torch_geometry(), band, md)
    assert got == want
    assert set(got[1]) == ({0, 1, 2} if max_dist is None else {0, 1})


def test_touched_masks_of_parity(setup_of):
    """All three levels of the occupancy march: the wrapper (its twin on
    the CPU) and the twin against JAX ofusion_touched_masks, exactly."""
    depth, pose, _ = setup_of
    m0, extra = jax_allocation.ofusion_touched_masks(
        jax_geometry(), jnp.asarray(depth), jnp.asarray(pose), k_jax(),
        MU_OF)
    want = [np.asarray(m0), np.asarray(extra[1]), np.asarray(extra[2])]
    assert all(w.sum() > 0 for w in want)
    tp = torch.from_numpy(pose)
    got = alloc.touched_masks_of(torch_geometry(), torch.from_numpy(depth),
                                 tp, k_torch(), MU_OF)
    kpose = se3.matmul4(tp, se3.inverse_camera_matrix(k_torch()))
    plain = alloc.touched_masks_of_plain(
        torch_geometry(), torch.from_numpy(depth), tp, kpose, MU_OF)
    for lvl in range(3):
        np.testing.assert_array_equal(got[lvl].numpy(), want[lvl],
                                      err_msg=f"level {lvl}")
        np.testing.assert_array_equal(plain[lvl].numpy(), want[lvl],
                                      err_msg=f"level {lvl} (twin)")


@pytest.mark.parametrize("budget,when", [(None, True), (None, False),
                                         (2, True)])
def test_allocate_ofusion_parity(setup_of, budget, when):
    """Slots, coordinates, block count, active flags and every mip level's
    existence mask after one occupancy allocation step."""
    depth, pose, jmap = setup_of
    jm, jstats = jax_allocation.allocate_ofusion(
        jax_geometry(), jax_map(jmap), jnp.asarray(depth), jnp.asarray(pose),
        k_jax(), MU_OF, with_stats=True, when=jnp.bool_(when), budget=budget)
    tm, tstats = allocation.allocate_ofusion(
        torch_geometry(), convert.map_to_torch(jmap, "cpu"),
        torch.from_numpy(depth),
        torch.from_numpy(pose), k_torch(), MU_OF, with_stats=True,
        when=torch.tensor(when), budget=budget)
    assert int(tstats["alloc_overflow"]) == int(jstats["alloc_overflow"])
    if budget == 2:
        assert int(jstats["alloc_overflow"]) > 0
    jm = convert.to_numpy(convert.map_to_torch(jm, "cpu"))
    tm = convert.to_numpy(tm)
    assert int(tm.n_blocks) == int(jm.n_blocks)
    if when:
        assert int(jm.n_blocks) > int(jmap.n_blocks)
    for name in ("slot", "block_coord", "active"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name),
                                      err_msg=name)
    changed = False
    for lvl, (a, b) in enumerate(zip(tm.mip_alloc, jm.mip_alloc)):
        np.testing.assert_array_equal(a, b, err_msg=f"mip_alloc[{lvl}]")
        changed |= bool((b != np.asarray(jmap.mip_alloc[lvl])).any())
    assert changed == when


def jax_map(m):
    """A fresh device copy of a host JAX map (JAX ops do not mutate)."""
    import jax
    return jax.tree.map(jnp.asarray, m)
