"""Parity of the port's node (coarse mip) pass, kernel K4's plain twin
``kernels/node.node_pass_plain``, with the node pass of JAX
``ops/integration.integrate``, both fields.

The node pass reads only the mip pyramid and the frame, so the twin on a
map equals JAX integrate's mip levels on the same map. Cases: the 64^3
orbit map (8 blocks a side: level 0 takes JAX's sparse pass over the
first occupied parents) after frames 0-2 with frame 3's blocks
allocated, fused at frame 3's pose, with ``when`` True and False; a 32^3
map (4 blocks a side: level 0 is gated by mip_alloc[0], JAX's dense
loop); and a budget of 2 parents, where ``mip_skipped`` > 0. TSDF: mip_x
and mip_y to 1e-5. OFusion (mu 0.008, stamped with 3/30): log-odds to a
relative 1e-5 (absolute 1e-5 near 0), time stamps exactly.
``mip_skipped`` exactly. K4's parent rank twin (``node_rank_plain``, the
gate the rank kernel writes) against JAX's top_k ranking of the occupied
parents: the gate grid and mip_skipped exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu.core.map import MapGeometry as JaxGeometry, make_map
from supereight_tpu.fields import get_field
from supereight_tpu.ops import allocation as jax_allocation
from supereight_tpu.ops import integration as jax_integration
from supereight_tpu_torch import convert
from supereight_tpu_torch.core import se3
from supereight_tpu_torch.core.map import MapGeometry
from supereight_tpu_torch.kernels import node
from test_torch_step import (CAPACITY, DIM, FIELDS, MU, H, K, W, jax_frames,
                             jax_geometry, make_scene, torch_geometry)

TIMESTAMP = np.float32(1.0 / 30.0) * np.float32(3)  # frame 3 (JAX step.py)


def _allocate(geom, jm, field, depth, pose):
    allocate = (jax_allocation.allocate_ofusion if field == "ofusion"
                else jax_allocation.allocate_tsdf)
    jm, st = allocate(geom, jm, jnp.asarray(depth), jnp.asarray(pose),
                      jnp.asarray(K, jnp.float32), MU[field],
                      with_stats=True)
    assert int(st["alloc_overflow"]) == 0
    return jm


def _jax_integrate(geom, jm, field, depth, pose, budget=CAPACITY, when=True):
    return jax_integration.integrate(
        geom, jm, get_field(field), jnp.asarray(depth), jnp.asarray(pose),
        jnp.asarray(K, jnp.float32), MU[field], jnp.float32(TIMESTAMP),
        (W, H), budget=budget, with_stats=True, when=jnp.bool_(when))


@pytest.fixture(scope="module")
def scene():
    torch.set_num_threads(1)
    depths, poses = make_scene(4)
    return depths, poses.astype(np.float32)


@pytest.fixture(scope="module", params=["tsdf", "ofusion"])
def orbit(request, scene):
    """(field, depth, pose, numpy JAX map after frames 0-2 with frame 3's
    blocks allocated) on the 64^3 map."""
    depths, poses = scene
    field = request.param
    states, _ = jax_frames(depths, poses, 3, field)
    jm = _allocate(jax_geometry(), jax.tree.map(jnp.asarray, states[-1].map),
                   field, depths[3], poses[3])
    return field, depths[3], poses[3], jax.tree.map(np.asarray, jm)


def _run_both(geom, tgeom, field, depth, pose, jmap, budget=CAPACITY,
              when=True):
    """JAX integrate and the port's node-pass twin on the same map:
    (JAX map, JAX mip_skipped, port map, port mip_skipped), numpy."""
    jm, stats = _jax_integrate(geom, jax.tree.map(jnp.asarray, jmap), field,
                               depth, pose, budget, when)
    tm = convert.map_to_torch(jmap, "cpu")
    tp = torch.from_numpy(pose)
    kt = torch.tensor(K, dtype=torch.float32)
    skipped = node.node_pass_plain(
        tgeom, tm, FIELDS[field], torch.from_numpy(depth), se3.inverse(tp),
        se3.camera_matrix(kt), MU[field], budget, torch.tensor(TIMESTAMP),
        torch.tensor(when))
    return (jax.tree.map(np.asarray, jm), int(stats["mip_skipped"]),
            convert.to_numpy(tm), int(skipped))


def _assert_mips_close(field, got, want):
    for lvl in range(len(want.mip_x)):
        what = f"mip level {lvl}"
        if field == "ofusion":
            np.testing.assert_allclose(got.mip_x[lvl], want.mip_x[lvl],
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=what + " x")
            np.testing.assert_array_equal(got.mip_y[lvl], want.mip_y[lvl],
                                          err_msg=what + " y")
        else:
            for a, b, c in ((got.mip_x, want.mip_x, "x"),
                            (got.mip_y, want.mip_y, "y")):
                np.testing.assert_allclose(a[lvl], b[lvl], atol=1e-5, rtol=0,
                                           err_msg=what + " " + c)


def _changed(jm, jmap, lvl):
    """Values of mip level ``lvl`` that differ between two maps."""
    return int(((jm.mip_x[lvl] != jmap.mip_x[lvl])
                | (jm.mip_y[lvl] != jmap.mip_y[lvl])).sum())


@pytest.mark.parametrize("when", [True, False])
def test_node_pass_parity_sparse_level0(orbit, when):
    field, depth, pose, jmap = orbit
    assert jax_geometry().blocks_per_side >= 8  # JAX's sparse level 0
    jm, jskip, tm, tskip = _run_both(jax_geometry(), torch_geometry(), field,
                                     depth, pose, jmap, when=when)
    assert tskip == jskip == 0
    _assert_mips_close(field, tm, jm)
    if when:
        # level 0 and a coarser level both took updates
        assert _changed(jm, jmap, 0) > 0 and _changed(jm, jmap, 1) > 0
    else:
        # every level untouched, on both sides
        assert not any(_changed(jm, jmap, lvl) for lvl in range(len(jm.mip_x)))
        for lvl in range(len(jmap.mip_x)):
            np.testing.assert_array_equal(tm.mip_x[lvl], jmap.mip_x[lvl])
            np.testing.assert_array_equal(tm.mip_y[lvl], jmap.mip_y[lvl])


def test_node_pass_budget_skips_parents_like_jax(orbit):
    """A budget of 2 parents: level 0 updates only the first two occupied
    parents' octants and counts the rest in mip_skipped, as JAX does."""
    field, depth, pose, jmap = orbit
    jm, jskip, tm, tskip = _run_both(jax_geometry(), torch_geometry(), field,
                                     depth, pose, jmap, budget=2)
    assert jskip > 0
    assert tskip == jskip
    _assert_mips_close(field, tm, jm)


@pytest.mark.parametrize("field", ["tsdf", "ofusion"])
def test_node_pass_parity_dense_level0(scene, field):
    """A 32^3 map (4 blocks a side): level 0 is gated by mip_alloc[0]. The
    map holds frame 0 fused by JAX and frame 1's blocks; frame 1 is then
    fused by both."""
    depths, poses = scene
    geom = JaxGeometry(size=32, dim=DIM, capacity=CAPACITY)
    tgeom = MapGeometry(size=32, dim=DIM, capacity=CAPACITY)
    assert geom.blocks_per_side < 8
    jm = _allocate(geom, make_map(geom, get_field(field)), field, depths[0],
                   poses[0])
    jm, _ = _jax_integrate(geom, jm, field, depths[0], poses[0])
    jm = _allocate(geom, jm, field, depths[1], poses[1])
    jmap = jax.tree.map(np.asarray, jm)
    got_j, jskip, got_t, tskip = _run_both(geom, tgeom, field, depths[1],
                                           poses[1], jmap)
    assert tskip == jskip == 0
    assert _changed(got_j, jmap, 0) > 0
    _assert_mips_close(field, got_t, got_j)


def _jax_rank(jmap, pbudget, when):
    """JAX's level-0 parent ranking (_node_pass_level0_sparse 449-458):
    the gate of every parent (bool[B/2]^3) and mip_skipped, masked by
    ``when`` as integrate masks it."""
    b = jax_geometry().blocks_per_side
    hp = b // 2
    npar = hp ** 3
    parent = jnp.asarray(jmap.mip_alloc[0]).reshape(hp, 2, hp, 2, hp, 2) \
        .any(axis=(1, 3, 5)).reshape(-1)
    ids = jnp.arange(npar, dtype=jnp.int32)
    vals, _ = jax.lax.top_k(jnp.where(parent, npar - ids, 0), pbudget)
    pw = jnp.where(vals > 0, npar - vals, -1)
    present = pw >= 0
    skipped = (jnp.sum(parent.astype(jnp.int32))
               - jnp.sum(present.astype(jnp.int32))) * 8
    gate = np.zeros(npar + 1, dtype=bool)
    gate[np.where(np.asarray(present), np.asarray(pw), npar)] = True
    return (gate[:npar].reshape(hp, hp, hp),
            int(jnp.where(when, skipped, 0)))


@pytest.mark.parametrize("budget,when", [(2, True), (CAPACITY, True),
                                         (CAPACITY, False)])
def test_rank_matches_jax_top_k(orbit, budget, when):
    """The parent gate and mip_skipped of the rank twin against JAX's top_k
    over the occupied parents: a budget of 2 (mip_skipped > 0), the full
    budget, and ``when`` False (mip_skipped 0)."""
    field, _, _, jmap = orbit
    hp = jax_geometry().blocks_per_side // 2
    pbudget = min(budget, hp ** 3)
    want, jskip = _jax_rank(jmap, pbudget, when)
    present, skipped = node.node_rank(torch_geometry(),
                                      convert.map_to_torch(jmap, "cpu"),
                                      budget, torch.tensor(when))
    np.testing.assert_array_equal(present.numpy(), want)
    assert int(skipped) == jskip
    assert (jskip > 0) == (budget == 2 and when)
