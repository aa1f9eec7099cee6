"""Parity of the port's integration (the plain twins of kernels K3 and K4)
with JAX ``ops/integration.integrate``, both fields, and of K3's worklist
twin with JAX ``build_active_worklist``.

The map is JAX's after frames 0-2, with frame 3's blocks allocated by
JAX; frame 3 is then fused at its ground-truth pose by both. TSDF:
data_x, data_y, mip_x and mip_y must agree to 1e-5. OFusion (mu 0.008,
stamped with frame 3's time 3/30): the log-odds (up to +/-1000) to a
relative 1e-5 (absolute 1e-5 near 0) and the time stamps exactly, so the
write gate agrees voxel for voxel. active and the three counters
exactly. A second TSDF case fuses a 320x240 frame taken 0.5 m from the
sphere into a fresh map, so that near blocks outgrow every depth patch
and take the exact per-pixel fallback. Each case also with the
noise-grade options: the bilinear depth read (``depth_interp``: no
level rule, no fallback, patch_skipped 0), the TSDF range weight
(``noise_weighted``, which OFusion ignores) and both, to the same
tolerances except OFusion's log-odds after the bilinear read, to 1e-4:
XLA on the CPU contracts the read's sum of products into fused
multiply-adds (a fifth of its samples an ulp from the f32 sum that the
port takes), and the occupancy update near sample 0.5 turns an ulp of
depth into up to ~3e-5 of log-odds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu.core.map import make_map
from supereight_tpu.fields import get_field
from supereight_tpu.ops import allocation as jax_allocation
from supereight_tpu.ops import integration as jax_integration
from supereight_tpu_torch import convert
from supereight_tpu_torch.core import map as tmap
from supereight_tpu_torch.core import se3
from supereight_tpu_torch.fields import OFUSION, TSDF
from supereight_tpu_torch.io import synthetic
from supereight_tpu_torch.kernels import integrate as kint
from supereight_tpu_torch.ops import integration
from test_torch_step import (DIM, H, K, SCENE_KW, W, assert_no_drops,
                             jax_frames, jax_geometry, make_scene,
                             torch_geometry)

MU = 0.1
MU_OF = 0.008
K_CLOSE = (240.0, 240.0, 160.0, 120.0)
# case -> (field, mu); "orbit_of" is the orbit case fused as OFusion
FIELD = {"orbit": ("tsdf", MU), "close": ("tsdf", MU),
         "orbit_of": ("ofusion", MU_OF)}
TIMESTAMP = np.float32(1.0 / 30.0) * np.float32(3)  # frame 3 (JAX step.py)


def _close_view():
    """A 320x240 depth frame 0.5 m from the sphere surface, its pose."""
    c = np.full(3, DIM / 2)
    r = SCENE_KW["sphere_radius"]
    pose = synthetic.look_at(c + np.array([0.0, 0.05, -(r + 0.5)]), c)
    depth = synthetic.render_depth(
        pose, K_CLOSE, 320, 240, sphere_center=c, sphere_radius=r,
        box_min=SCENE_KW["room"][0], box_max=SCENE_KW["room"][1])
    return depth, pose


@pytest.fixture(scope="module", params=["orbit", "close", "orbit_of"])
def case(request):
    """(name, depth, pose, k, frame size, JAX map with depth's blocks
    allocated, as numpy)."""
    torch.set_num_threads(1)
    field, mu = FIELD[request.param]
    if request.param != "close":
        depths, poses = make_scene()
        states, auxes = jax_frames(depths, poses, 3, field)
        for a in auxes:
            assert_no_drops(a)
        depth, pose, k, size = depths[3], poses[3], K, (W, H)
        jm = jax.tree.map(jnp.asarray, states[-1].map)
    else:
        depth, pose = _close_view()
        k, size = K_CLOSE, (320, 240)
        jm = make_map(jax_geometry(), get_field(field))
    pose = pose.astype(np.float32)
    allocate = (jax_allocation.allocate_ofusion if field == "ofusion"
                else jax_allocation.allocate_tsdf)
    jm, st = allocate(jax_geometry(), jm, jnp.asarray(depth),
                      jnp.asarray(pose), jnp.asarray(k, jnp.float32), mu,
                      with_stats=True)
    assert int(st["alloc_overflow"]) == 0
    return (request.param, depth, pose, k, size,
            jax.tree.map(np.asarray, jm))


def _run_both(case, when=None, budget=1024, **options):
    name, depth, pose, k, size, jmap = case
    field, mu = FIELD[name]
    jm, jstats = jax_integration.integrate(
        jax_geometry(), jax.tree.map(jnp.asarray, jmap), get_field(field),
        jnp.asarray(depth), jnp.asarray(pose), jnp.asarray(k, jnp.float32),
        mu, jnp.float32(TIMESTAMP), size, budget=budget, with_stats=True,
        when=None if when is None else jnp.bool_(when), **options)
    tm, tstats = integration.integrate(
        torch_geometry(), convert.map_to_torch(jmap, "cpu"),
        OFUSION if field == "ofusion" else TSDF,
        torch.from_numpy(depth), torch.from_numpy(pose),
        torch.tensor(k, dtype=torch.float32), mu, torch.tensor(TIMESTAMP),
        size, budget=budget, with_stats=True,
        when=None if when is None else torch.tensor(when), **options)
    return (jax.tree.map(np.asarray, jm), {k: int(v) for k, v in
                                           jstats.items()},
            convert.to_numpy(tm), {k: int(v) for k, v in tstats.items()})


def _assert_payload_close(name, a, b, what, of_atol=1e-5):
    if FIELD[name][0] == "ofusion":
        # log-odds reach +/-1000: relative; time stamps exactly
        np.testing.assert_allclose(a[0], b[0], rtol=1e-5, atol=of_atol,
                                   err_msg=what + " x")
        np.testing.assert_array_equal(a[1], b[1], err_msg=what + " y")
    else:
        for i, c in enumerate("xy"):
            np.testing.assert_allclose(a[i], b[i], atol=1e-5, rtol=0,
                                       err_msg=what + " " + c)


@pytest.mark.parametrize("when", [True, False])
def test_integrate_parity(case, when):
    jm, jstats, tm, tstats = _run_both(case, when)
    assert tstats == jstats
    assert jstats == {"blocks_truncated": 0, "patch_skipped": 0,
                      "mip_skipped": 0}
    name, jmap = case[0], case[-1]
    np.testing.assert_array_equal(tm.active, jm.active)
    _assert_payload_close(name, (tm.data_x, tm.data_y),
                          (jm.data_x, jm.data_y), "data")
    for lvl in range(len(jm.mip_x)):
        _assert_payload_close(name, (tm.mip_x[lvl], tm.mip_y[lvl]),
                              (jm.mip_x[lvl], jm.mip_y[lvl]), f"mip {lvl}")
    assert (np.abs(jm.data_y - jmap.data_y).sum() > 0) == when
    if name == "orbit_of" and when:
        # the update exercised the write gate, the decay and both signs
        wrote = jm.data_y == TIMESTAMP
        assert wrote.any() and (~wrote & (jm.data_y > 0)).any()
        assert (jm.data_x[wrote] > 0).any() and (jm.data_x[wrote] < 0).any()


@pytest.mark.parametrize("options", [
    dict(depth_interp=True), dict(noise_weighted=True),
    dict(depth_interp=True, noise_weighted=True)],
    ids=["bilinear", "noise", "bilinear+noise"])
def test_integrate_options_parity(case, options):
    """The noise-grade options of integration against JAX's: the block
    pass's bilinear read and the TSDF noise weight, alone and together
    (the node pass reads the nearest depth and weighs 1 in both)."""
    jm, jstats, tm, tstats = _run_both(case, True, **options)
    assert tstats == jstats
    assert jstats == {"blocks_truncated": 0, "patch_skipped": 0,
                      "mip_skipped": 0}
    name, jmap = case[0], case[-1]
    np.testing.assert_array_equal(tm.active, jm.active)
    _assert_payload_close(name, (tm.data_x, tm.data_y),
                          (jm.data_x, jm.data_y), "data",
                          1e-4 if options.get("depth_interp") else 1e-5)
    for lvl in range(len(jm.mip_x)):
        _assert_payload_close(name, (tm.mip_x[lvl], tm.mip_y[lvl]),
                              (jm.mip_x[lvl], jm.mip_y[lvl]), f"mip {lvl}")
    # the option changed the fused payload
    plain, _ = _run_both(case, True)[:2]
    assert not np.array_equal(jm.data_x, plain.data_x) \
        or FIELD[name][0] == "ofusion" and "depth_interp" not in options
    if options.get("noise_weighted") and FIELD[name][0] == "tsdf":
        w = jm.data_y - jmap.data_y
        assert ((w > 0) & (w < 1)).any()


def _block_inputs(case):
    """(torch map, depth, t_cw, kmat) of a case for the K3 wrappers."""
    name, depth, pose, k, size, jmap = case
    kmat = se3.camera_matrix(torch.tensor(k, dtype=torch.float32))
    return (convert.map_to_torch(jmap, "cpu"), torch.from_numpy(depth),
            se3.inverse(torch.from_numpy(pose)), kmat)


def test_close_view_takes_fallback(case):
    """The close case really has blocks no depth patch covers."""
    name, size = case[0], case[4]
    field, mu = FIELD[name]
    tm, depth, t_cw, kmat = _block_inputs(case)
    wl, _, _ = kint.integrate_worklist(torch_geometry(), tm, t_cw, kmat, size,
                                       1024)
    mode, _, need = kint.integrate_fused(
        torch_geometry(), tm, OFUSION if field == "ofusion" else TSDF, wl,
        depth, t_cw, kmat, mu, torch.tensor(TIMESTAMP))
    assert (int(need.sum()) > 0) == (name == "close")
    assert int((mode > 0).sum()) > 0


@pytest.mark.parametrize("budget,when", [(1024, True), (16, True),
                                         (1024, False)])
def test_worklist_matches_jax(case, budget, when):
    """The worklist twin against JAX build_active_worklist: slot order,
    empty entries, the active count and blocks_truncated; a budget of 16
    truncates, and ``when`` False empties the worklist but keeps the
    count."""
    name, depth, pose, k, size, jmap = case
    tm, _, t_cw, kmat = _block_inputs(case)
    kj = jnp.asarray(np.asarray(kmat))
    want, n_want = jax_integration.build_active_worklist(
        jax_geometry(), jax.tree.map(jnp.asarray, jmap),
        jnp.asarray(np.asarray(t_cw)), kj, size, budget)
    wl, n_active, truncated = kint.integrate_worklist_plain(
        torch_geometry(), tm, t_cw, kmat, size, budget, torch.tensor(when))
    assert int(n_active) == int(n_want) > 16
    assert int(truncated) == (max(int(n_want) - budget, 0) if when else 0)
    if when:
        np.testing.assert_array_equal(wl.numpy(), np.asarray(want))
    else:
        assert (wl == torch_geometry().capacity).all()


def test_small_budget_truncates(case):
    """A worklist budget below the active count truncates like JAX."""
    jm, jstats, tm, tstats = _run_both(case, budget=16)
    assert jstats["blocks_truncated"] > 0
    assert tstats == jstats
    _assert_payload_close(case[0], (tm.data_x, tm.data_y),
                          (jm.data_x, jm.data_y), "data")


def test_fallback_mode_caps_at_32():
    """Uncovered blocks past the first 32 (worklist order) skip fusion,
    count their valid voxels in patch_skipped and lose their active flag;
    the first 32 are fused at the exact pixel (mode 0) and stay active."""
    torch.set_num_threads(1)
    geom = torch_geometry()
    m = tmap.make_map(geom, TSDF, "cpu")
    n = 50
    # 50 slots of one block 1 m in front of an identity camera
    m.block_coord[:n] = torch.tensor([0, 0, 4], dtype=torch.int32)
    m.active[:n] = True
    worklist = torch.arange(n, dtype=torch.int32)
    mode = torch.full((n,), -1, dtype=torch.int32)
    mode[::5] = 1                      # every 5th block is covered
    n_valid = torch.arange(n, dtype=torch.int32) + 1
    need = mode < 0
    kmat = se3.camera_matrix(torch.tensor(K, dtype=torch.float32))
    depth = torch.full((H, W), 1.1)
    before = m.data_x.clone()
    skipped = kint.integrate_fallback(geom, m, TSDF, worklist, depth,
                                      torch.eye(4), kmat, MU, mode, n_valid,
                                      need)
    order = torch.nonzero(need)[:, 0]
    fused, left = order[:32], order[32:]
    assert (mode[fused] == 0).all() and (mode[left] == -1).all()
    assert (mode[::5] == 1).all()
    assert int(skipped) == int(n_valid[left].sum())
    assert m.active[fused].all() and not m.active[left].any()
    assert m.active[:n:5].all()        # covered blocks are not its to write
    assert (m.data_x[fused] != before[fused]).any(1).all()
    assert torch.equal(m.data_x[left], before[left])
    assert torch.equal(m.data_x[:n:5], before[:n:5])
