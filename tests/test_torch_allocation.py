"""Parity of the port's allocation (kernel K5's plain twins: the marches
and ``alloc_assign_plain``, the bump allocator with the incremental mip
refresh) with JAX ``ops/allocation``: ``allocate_tsdf`` and
``allocate_ofusion``.

The map is JAX's after frames 0-2 of its field (TSDF at mu 0.1, OFusion
at mu 0.008); frame 3's depth is allocated at frame 3's ground-truth
pose. The touched grids (all three levels for OFusion), slot grid,
block_coord, n_blocks, active, mip_alloc and alloc_overflow must match
exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu.core.map import MapGeometry as JaxGeometry
from supereight_tpu.ops import allocation as jax_allocation
from supereight_tpu_torch import convert
from supereight_tpu_torch.core import se3
from supereight_tpu_torch.core.map import MapGeometry, touched_buffer
from supereight_tpu_torch.kernels import alloc
from supereight_tpu_torch.kernels.alloc import (touched_mask,
                                                touched_mask_plain)
from supereight_tpu_torch.ops import allocation
from test_torch_step import (CAPACITY, DIM, assert_no_drops, jax_frames,
                             jax_geometry, k_jax, k_torch, make_scene,
                             torch_geometry)

MU = 0.1
MU_OF = 0.008


def _out():
    """A zeroed touched buffer of the test map."""
    return touched_buffer(torch_geometry().blocks_per_side, "cpu")


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
    kpose = se3.matmul4(tp, se3.inverse_camera_matrix(k_torch()))
    got = touched_mask(torch_geometry(), torch.from_numpy(depth), tp, kpose,
                       MU, _out())
    assert want.sum() > 50
    np.testing.assert_array_equal(got.numpy(), want)
    plain = touched_mask_plain(torch_geometry(), torch.from_numpy(depth), tp,
                               kpose, MU)
    np.testing.assert_array_equal(plain.numpy(), want)


def _shrunk(jmap, capacity):
    """The numpy JAX map ``jmap`` in a pool of ``capacity`` slots."""
    return jmap._replace(**{n: getattr(jmap, n)[:capacity] for n in
                            ("data_x", "data_y", "block_coord", "active")})


def _allocate_both(setup, field, budget, when, short):
    """JAX's and the port's allocation step of ``field`` on the map of
    ``setup`` (in a pool one block short of full when ``short``): both
    maps as numpy, both overflow counts, and the map before."""
    depth, pose, jmap = setup
    jg, tg = jax_geometry(), torch_geometry()
    if short:
        cap = int(jmap.n_blocks) + 1
        jmap = _shrunk(jmap, cap)
        jg, tg = JaxGeometry(jg.size, jg.dim, cap), MapGeometry(tg.size,
                                                                tg.dim, cap)
    mu = MU_OF if field == "ofusion" else MU
    jax_fn, fn = ((jax_allocation.allocate_ofusion,
                   allocation.allocate_ofusion) if field == "ofusion" else
                  (jax_allocation.allocate_tsdf, allocation.allocate_tsdf))
    jm, jstats = jax_fn(jg, jax_map(jmap), jnp.asarray(depth),
                        jnp.asarray(pose), k_jax(), mu, with_stats=True,
                        when=jnp.bool_(when), budget=budget)
    tm, tstats = fn(tg, convert.map_to_torch(jmap, "cpu"),
                    torch.from_numpy(depth), torch.from_numpy(pose),
                    k_torch(), mu, with_stats=True, when=torch.tensor(when),
                    budget=budget)
    return (convert.to_numpy(convert.map_to_torch(jm, "cpu")),
            convert.to_numpy(tm), int(jstats["alloc_overflow"]),
            int(tstats["alloc_overflow"]), jmap)


def _assert_same_pool(jm, tm):
    assert int(tm.n_blocks) == int(jm.n_blocks)
    for name in ("slot", "block_coord", "active"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name),
                                      err_msg=name)
    for lvl, (a, b) in enumerate(zip(tm.mip_alloc, jm.mip_alloc)):
        np.testing.assert_array_equal(a, b, err_msg=f"mip_alloc[{lvl}]")


# default budget, the masked (when=False) step, an overflowing budget of 2
# new blocks (the ascending-cell-id cut) and a pool one block short of full
# (the capacity cut)
ALLOC_CASES = [(None, True, False), (None, False, False), (2, True, False),
               (None, True, True)]


@pytest.mark.parametrize("budget,when,short", ALLOC_CASES)
def test_allocate_tsdf_parity(setup, budget, when, short):
    """Slots, coordinates, block count, active flags, every mip level's
    existence mask and alloc_overflow after one band allocation step."""
    jm, tm, j_over, t_over, jmap = _allocate_both(setup, "tsdf", budget,
                                                  when, short)
    assert t_over == j_over
    assert (j_over > 0) == (budget == 2 or short)
    if when:
        assert int(jm.n_blocks) > int(jmap.n_blocks)
    _assert_same_pool(jm, tm)


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
    kpose = se3.matmul4(tp, se3.inverse_camera_matrix(k_torch()))
    got = alloc.touched_masks_of(torch_geometry(), torch.from_numpy(depth),
                                 tp, kpose, MU_OF, _out())
    plain = alloc.touched_masks_of_plain(
        torch_geometry(), torch.from_numpy(depth), tp, kpose, MU_OF)
    for lvl in range(3):
        np.testing.assert_array_equal(got[lvl].numpy(), want[lvl],
                                      err_msg=f"level {lvl}")
        np.testing.assert_array_equal(plain[lvl].numpy(), want[lvl],
                                      err_msg=f"level {lvl} (twin)")


@pytest.mark.parametrize("budget,when,short", ALLOC_CASES)
def test_allocate_ofusion_parity(setup_of, budget, when, short):
    """Slots, coordinates, block count, active flags, every mip level's
    existence mask and alloc_overflow after one occupancy allocation
    step."""
    jm, tm, j_over, t_over, jmap = _allocate_both(setup_of, "ofusion",
                                                  budget, when, short)
    assert t_over == j_over
    assert (j_over > 0) == (budget == 2 or short)
    if when:
        assert int(jm.n_blocks) > int(jmap.n_blocks)
    _assert_same_pool(jm, tm)
    changed = any(bool((b != np.asarray(a)).any())
                  for a, b in zip(jmap.mip_alloc, jm.mip_alloc))
    assert changed == when


@pytest.mark.parametrize("field,short", [("tsdf", False), ("tsdf", True),
                                         ("ofusion", False),
                                         ("ofusion", True)])
def test_slot_grid_and_block_coord_one_to_one(request, field, short):
    """The invariant ``alloc_assign``'s re-activation rests on
    (csrc/alloc.cu): after allocation, slot[c] = s exactly when
    block_coord[s] = c, for every s < n_blocks. So the slots of the
    touched cells that have one (the kernel's form) are the slots whose
    cell is touched (JAX's per-slot gather, the twin's form)."""
    depth, pose, jmap = request.getfixturevalue(
        "setup_of" if field == "ofusion" else "setup")
    _, tm, _, _, _ = _allocate_both((depth, pose, jmap), field, None, True,
                                    short)
    n = int(tm.n_blocks)
    bc = tm.block_coord[:n]
    np.testing.assert_array_equal(tm.slot[bc[:, 0], bc[:, 1], bc[:, 2]],
                                  np.arange(n))
    assert int((tm.slot >= 0).sum()) == n
    tp = torch.from_numpy(pose)
    args = (torch_geometry(), torch.from_numpy(depth), tp,
            se3.matmul4(tp, se3.inverse_camera_matrix(k_torch())))
    touched = (alloc.touched_masks_of(*args, MU_OF, _out())[0]
               if field == "ofusion"
               else touched_mask(*args, MU, _out())).numpy()
    gathered = touched[bc[:, 0], bc[:, 1], bc[:, 2]]
    by_cell = np.zeros(n, dtype=bool)
    by_cell[tm.slot[touched & (tm.slot >= 0)]] = True
    assert gathered.any()
    np.testing.assert_array_equal(by_cell, gathered)


@pytest.mark.parametrize("when", [True, False])
@pytest.mark.parametrize("field", ["tsdf", "ofusion"])
def test_alloc_assign_plain_consumes_its_grids(request, field, when):
    """The field's march into the map's touched buffer, then the allocator's
    twin: the touched grid and the extra grids are all zero on return,
    with ``when`` true (blocks allocated) and false (none)."""
    depth, pose, jmap = request.getfixturevalue(
        "setup_of" if field == "ofusion" else "setup")
    tg = torch_geometry()
    m = convert.map_to_torch(jmap, "cpu")
    tp = torch.from_numpy(pose)
    kpose = se3.matmul4(tp, se3.inverse_camera_matrix(k_torch()))
    args = (tg, torch.from_numpy(depth), tp, kpose)
    grids = (alloc.touched_masks_of(*args, MU_OF, out=m.touched)
             if field == "ofusion"
             else (touched_mask(*args, MU, out=m.touched),))
    assert all(bool(g.any()) for g in grids)
    n_before = int(m.n_blocks)
    alloc.alloc_assign_plain(tg, m, grids[0], torch.tensor(when), None,
                             grids[1:])
    assert not any(bool(g.any()) for g in grids)
    assert not m.touched.any()
    assert (int(m.n_blocks) > n_before) == when


@pytest.mark.parametrize("field", ["tsdf", "ofusion"])
def test_masked_frame_leaves_no_marks(request, field):
    """Frame 7 allocated with ``when`` false, then frame 3 with it true,
    through the port's allocation step and the map's touched buffer: the
    pool and every mip level are JAX's after both, and the buffer is all
    zero after each. Frame 7 touches unallocated cells that frame 3 does
    not, so marks left behind by the masked frame would show."""
    _, _, jmap = request.getfixturevalue(
        "setup_of" if field == "ofusion" else "setup")
    jg, tg = jax_geometry(), torch_geometry()
    mu = MU_OF if field == "ofusion" else MU
    jax_fn, fn = ((jax_allocation.allocate_ofusion,
                   allocation.allocate_ofusion) if field == "ofusion" else
                  (jax_allocation.allocate_tsdf, allocation.allocate_tsdf))
    depths, poses = make_scene()
    jm, tm = jax_map(jmap), convert.map_to_torch(jmap, "cpu")
    touched = []
    for i, when in ((7, False), (3, True)):
        pose = poses[i].astype(np.float32)
        jm = jax_fn(jg, jm, jnp.asarray(depths[i]), jnp.asarray(pose),
                    k_jax(), mu, when=jnp.bool_(when))
        fn(tg, tm, torch.from_numpy(depths[i]), torch.from_numpy(pose),
           k_torch(), mu, when=torch.tensor(when))
        assert not tm.touched.any(), i
        tp = torch.from_numpy(pose)
        args = (tg, torch.from_numpy(depths[i]), tp,
                se3.matmul4(tp, se3.inverse_camera_matrix(k_torch())))
        touched.append(alloc.touched_masks_of(*args, mu, _out())[0]
                       if field == "ofusion"
                       else touched_mask(*args, mu, _out()))
    _assert_same_pool(convert.to_numpy(convert.map_to_torch(jm, "cpu")),
                      convert.to_numpy(tm))
    assert bool((touched[0] & ~touched[1] & (tm.slot < 0)).any())


# geometries whose ladder outgrows the few hundred samples a kernel's
# parameters could hold: the largest map the port admits (b = 512, as
# _lib.MAX_MIP_LEVELS allows) at the OFusion mu, and b = 64 at a wide band
LONG_LADDERS = [(4096, MU_OF), (512, 0.2)]


@pytest.mark.parametrize("size,mu,max_dist",
                         [(64, MU_OF, None), (64, MU_OF, 0.5), (64, 0.1, None)]
                         + [(size, mu, None) for size, mu in LONG_LADDERS])
def test_ladder_holds_the_step_ladder(size, mu, max_dist):
    """The ladder the occupancy kernel reads: the distances of
    ``ofusion_step_ladder`` (and JAX's) rounded to f32, its levels and the
    leading level-0 samples, of any length; levels never fall."""
    geom = MapGeometry(size=size, dim=DIM, capacity=CAPACITY)
    band = 6.0 * mu
    md = geom.dim * np.sqrt(3.0) if max_dist is None else max_dist
    travelled, levels = alloc.ofusion_step_ladder(geom, band, md)
    assert (travelled, levels) == jax_allocation.ofusion_step_ladder(
        JaxGeometry(size=size, dim=DIM, capacity=CAPACITY), band, md)
    ladder = alloc.of_ladder(geom, mu, max_dist)
    assert (ladder.t.dtype, ladder.level.dtype) == (torch.float32,
                                                    torch.uint8)
    np.testing.assert_array_equal(ladder.t.numpy(),
                                  np.array(travelled, dtype=np.float32))
    assert ladder.level.tolist() == levels == sorted(levels)
    assert ladder.n_fine == levels.count(0) >= 1
    assert levels[:ladder.n_fine] == [0] * ladder.n_fine
    assert (len(levels) > 300) == ((size, mu) in LONG_LADDERS)


@pytest.mark.parametrize("size,mu", LONG_LADDERS)
def test_touched_masks_of_takes_a_long_ladder(setup_of, size, mu):
    """The occupancy march on a geometry whose ladder has more than 300
    samples (the largest map the port admits among them) gives JAX's
    three touched grids exactly, in a touched buffer of that map."""
    depth, pose, _ = setup_of
    jg = JaxGeometry(size=size, dim=DIM, capacity=CAPACITY)
    tg = MapGeometry(size=size, dim=DIM, capacity=CAPACITY)
    m0, extra = jax_allocation.ofusion_touched_masks(
        jg, jnp.asarray(depth), jnp.asarray(pose), k_jax(), mu)
    want = [np.asarray(m0), np.asarray(extra[1]), np.asarray(extra[2])]
    del m0, extra
    assert all(w.any() for w in want)
    tp = torch.from_numpy(pose)
    got = alloc.touched_masks_of(
        tg, torch.from_numpy(depth), tp,
        se3.matmul4(tp, se3.inverse_camera_matrix(k_torch())), mu,
        touched_buffer(tg.blocks_per_side, "cpu"))
    for lvl in range(3):
        np.testing.assert_array_equal(got[lvl].numpy(), want[lvl],
                                      err_msg=f"level {lvl}")


def jax_map(m):
    """A fresh device copy of a host JAX map (JAX ops do not mutate)."""
    import jax
    return jax.tree.map(jnp.asarray, m)
