"""K3 at a worklist far longer than the blocks it lists: the class
pipeline's bucket (the next power of two over its preset budget, 49,152
in the eval's runs) and the noise row's budget, where most entries are
empty.

On the CPU, through the kernels' plain twins: the port's
``ops/integration.integrate`` against JAX's ``integrate`` (``with_stats``)
at a worklist budget equal to the capacity of the 64^3 test map, where
the listed blocks are a small fraction of the entries: the orbit's frame
3 for each field, and a close view whose near blocks take the exact-pixel
fallback. JAX's counters are asserted zero first; then the counters,
``active`` exactly and the payloads to the tolerances of
``tests/test_torch_integration.py`` (TSDF to 1e-5; OFusion log-odds to a
relative 1e-5, time stamps exactly). The twins also give every listed
entry the same outputs at the capacity bucket as on a worklist of the
listed entries alone, and every empty entry mode 0, n_valid 0, need
False.

On a CUDA card only (marker ``cuda``; the JAX package is imported by the
CPU tests alone, so ``python3 -m pytest
tests/test_torch_integration_bucket.py -m cuda --noconftest`` runs where
JAX is not installed): each fused mode (TSDF, its noise weight, the
bilinear read, both; OFusion and its bilinear read) and each fallback
mode (TSDF, noise, OFusion) against its twin at 49,152 entries, on a
compacted prefix, on a worklist with empty entries between the listed
ones, and on the empty worklist of ``when`` False, with 0, 17 and 75 need
blocks (75 leaves patch_skipped > 0): mode, n_valid, need, active and
patch_skipped exactly, data_y exactly and data_x to the kernel tests'
tolerances (TSDF 1e-5; OFusion 1e-4 + 1e-5 |x|: log2f against
torch.log2). A worklist longer than 512 entries for each CTA the card
holds (so each CTA walks two tiles) must give what the listed entries
alone give, and the fallback refuses a ``need`` off a 16-byte
boundary.
"""

import numpy as np
import pytest
import torch

from supereight_tpu_torch.core import se3
from supereight_tpu_torch.core.map import MapGeometry, make_map
from supereight_tpu_torch.fields import OFUSION, TSDF
from supereight_tpu_torch.kernels import _lib
from supereight_tpu_torch.kernels import integrate as kint
from supereight_tpu_torch.tools.bench import clone_map

ZERO_STATS = {"blocks_truncated": 0, "patch_skipped": 0, "mip_skipped": 0}


# ---- on the CPU: the port against JAX at the capacity bucket ------------

@pytest.fixture(scope="module", params=["orbit", "orbit_of", "close"])
def case(request):
    """test_torch_integration's cases: (name, depth, pose, k, frame size,
    JAX map with depth's blocks allocated, as numpy)."""
    import jax
    import jax.numpy as jnp

    import test_torch_integration as ti
    from supereight_tpu.core.map import make_map as jax_make_map
    from supereight_tpu.fields import get_field
    from supereight_tpu.ops import allocation as jax_allocation
    from test_torch_step import (K, H, W, assert_no_drops, jax_frames,
                                 jax_geometry, make_scene)
    torch.set_num_threads(1)
    field, mu = ti.FIELD[request.param]
    if request.param != "close":
        depths, poses = make_scene()
        states, auxes = jax_frames(depths, poses, 3, field)
        for a in auxes:
            assert_no_drops(a)
        depth, pose, k, size = depths[3], poses[3], K, (W, H)
        jm = jax.tree.map(jnp.asarray, states[-1].map)
    else:
        depth, pose = ti._close_view()
        k, size = ti.K_CLOSE, (320, 240)
        jm = jax_make_map(jax_geometry(), get_field(field))
    pose = pose.astype(np.float32)
    allocate = (jax_allocation.allocate_ofusion if field == "ofusion"
                else jax_allocation.allocate_tsdf)
    jm, st = allocate(jax_geometry(), jm, jnp.asarray(depth),
                      jnp.asarray(pose), jnp.asarray(k, jnp.float32), mu,
                      with_stats=True)
    assert int(st["alloc_overflow"]) == 0
    return (request.param, depth, pose, k, size,
            jax.tree.map(np.asarray, jm))


def _listed(case, budget):
    """The worklist twin's entries for the case at ``budget``, the count
    of listed ones and the block pass's inputs."""
    import test_torch_integration as ti
    from test_torch_step import torch_geometry
    tm, depth, t_cw, kmat = ti._block_inputs(case)
    wl, _, _ = kint.integrate_worklist_plain(torch_geometry(), tm, t_cw,
                                             kmat, case[4], budget)
    return wl, int((wl < torch_geometry().capacity).sum()), (tm, depth,
                                                              t_cw, kmat)


def test_integrate_at_capacity_bucket_matches_jax(case):
    """integrate at a budget of the whole pool against JAX's: the listed
    blocks are at most a quarter of the entries; the close view's need
    blocks take the fallback."""
    import test_torch_integration as ti
    from test_torch_step import CAPACITY
    name = case[0]
    wl, listed, _ = _listed(case, CAPACITY)
    assert 0 < listed <= CAPACITY // 4
    jm, jstats, tm, tstats = ti._run_both(case, True, budget=CAPACITY)
    assert jstats == ZERO_STATS
    assert tstats == jstats
    np.testing.assert_array_equal(tm.active, jm.active)
    ti._assert_payload_close(name, (tm.data_x, tm.data_y),
                             (jm.data_x, jm.data_y), "data")
    for lvl in range(len(jm.mip_x)):
        ti._assert_payload_close(name, (tm.mip_x[lvl], tm.mip_y[lvl]),
                                 (jm.mip_x[lvl], jm.mip_y[lvl]), f"mip {lvl}")
    assert (np.abs(jm.data_y - case[-1].data_y).sum() > 0)


def test_empty_entries_change_nothing(case):
    """The fused and fallback twins at the capacity bucket against the
    same passes over the listed entries alone: the same map, patch_skipped
    and per-entry outputs on the listed entries, and mode 0, n_valid 0,
    need False on every empty one; the close view has need blocks."""
    import test_torch_integration as ti
    from test_torch_step import CAPACITY, torch_geometry
    name = case[0]
    field, mu = ti.FIELD[name]
    fld = OFUSION if field == "ofusion" else TSDF
    geom = torch_geometry()
    ts = torch.tensor(ti.TIMESTAMP)
    wl, listed, (tm, depth, t_cw, kmat) = _listed(case, CAPACITY)
    out = []
    for entries in (wl, wl[:listed].clone()):
        m = clone_map(tm)
        fused = kint.integrate_fused(geom, m, fld, entries, depth, t_cw,
                                     kmat, mu, ts)
        skipped = kint.integrate_fallback(geom, m, fld, entries, depth, t_cw,
                                          kmat, mu, *fused, ts)
        out.append((m, fused, skipped))
    (ma, fa, sa), (mb, fb, sb) = out
    for x, y in zip(fa, fb):
        assert torch.equal(x[:listed], y)
    assert (fa[0][listed:] == 0).all() and (fa[1][listed:] == 0).all()
    assert not fa[2][listed:].any()
    assert int(sa) == int(sb)
    for key in ("data_x", "data_y", "active"):
        assert torch.equal(getattr(ma, key), getattr(mb, key)), key
    assert (int(fa[2].sum()) > 0) == (name == "close")


# ---- on the card: each mode against its twin at 49,152 entries ----------

N_WORK = 49152           # the class pipeline's and the noise row's bucket
BUCKET_CAPACITY = 4096   # the pool of the synthetic map
N_COVERED, N_HIDDEN = 3000, 200
K_WALL = (240.0, 240.0, 160.0, 120.0)  # 320x240, identity camera
MU = {"tsdf": 0.1, "ofusion": 0.008}
FUSED_MODES = {  # id -> (field, noise_weighted, bilinear)
    "tsdf": (TSDF, False, False), "tsdf-noise": (TSDF, True, False),
    "tsdf-bilinear": (TSDF, False, True),
    "tsdf-noise-bilinear": (TSDF, True, True),
    "ofusion": (OFUSION, False, False),
    "ofusion-bilinear": (OFUSION, False, True)}
LAYOUTS = [("prefix", 0), ("prefix", 17), ("prefix", 75), ("gaps", 0),
           ("gaps", 17), ("gaps", 75), ("empty", 75)]
UPDATE_TOL = {"tsdf": dict(atol=1e-5, rtol=0),
              "ofusion": dict(atol=1e-4, rtol=1e-5)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda", 0)


def bucket_case(device, field, layout, n_need, seed=0):
    """A map of N_COVERED blocks 1.25-4 m before an identity camera (on
    depth levels 0 to 2), n_need blocks 0.25-0.75 m before it (too
    big in pixels for any level: the fallback's) and N_HIDDEN behind it
    (no valid voxel), with random payloads, a 320x240 depth of a slanted
    wall at 3.4-4.4 m with a twentieth of its pixels 0, and an N_WORK
    worklist of those slots: in slot order at entries [0, n) ("prefix"),
    at random entries in random order ("gaps"), or none ("empty", made by
    the worklist kernel under a false ``when``). Returns (geometry, map,
    worklist, depth, t_cw, kmat, time stamp)."""
    rng = np.random.default_rng(seed)
    geom = MapGeometry(size=64, dim=2.0, capacity=BUCKET_CAPACITY)
    m = make_map(geom, field, device)
    coords = np.concatenate([
        np.stack([rng.integers(-3, 3, N_COVERED),
                  rng.integers(-2, 2, N_COVERED),
                  rng.integers(5, 16, N_COVERED)], 1),
        np.stack([rng.integers(-1, 1, n_need), rng.integers(-1, 1, n_need),
                  rng.integers(1, 3, n_need)], 1),
        np.stack([rng.integers(-3, 3, N_HIDDEN), rng.integers(-2, 2, N_HIDDEN),
                  -rng.integers(2, 6, N_HIDDEN)], 1)]).astype(np.int32)
    n = len(coords)
    m.block_coord[:n] = torch.from_numpy(coords).to(device)
    m.active[:n] = True
    m.n_blocks.fill_(n)
    shape = (n, m.data_x.shape[1])
    if field is TSDF:
        x = rng.uniform(-1, 1, shape)
        y = rng.integers(0, 20, shape)
    else:
        x = rng.uniform(-20, 20, shape)
        y = rng.uniform(0, 0.1, shape)
    m.data_x[:n] = torch.from_numpy(x.astype(np.float32)).to(device)
    m.data_y[:n] = torch.from_numpy(y.astype(np.float32)).to(device)
    yy, xx = np.mgrid[0:240, 0:320].astype(np.float32)
    depth = 3.4 + xx / 320 + 0.5 * yy / 240
    depth[rng.random(depth.shape) < 0.05] = 0.0
    depth = torch.from_numpy(depth.astype(np.float32)).to(device)
    t_cw = torch.eye(4, device=device)
    kmat = se3.camera_matrix(torch.tensor(K_WALL, device=device))
    if layout == "empty":
        wl, _, truncated = kint.integrate_worklist(
            geom, m, t_cw, kmat, (320, 240), N_WORK,
            torch.zeros((), dtype=torch.bool, device=device))
        assert int(truncated) == 0
    else:
        wl = np.full(N_WORK, BUCKET_CAPACITY, np.int32)
        slots = np.arange(n, dtype=np.int32)
        if layout == "prefix":
            wl[:n] = slots
        else:
            wl[np.sort(rng.choice(N_WORK, n, replace=False))] = \
                rng.permutation(slots)
        wl = torch.from_numpy(wl).to(device)
    return (geom, m, wl, depth, t_cw, kmat,
            torch.full((), 0.2, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("layout,n_need", LAYOUTS,
                         ids=[f"{a}-{b}" for a, b in LAYOUTS])
@pytest.mark.parametrize("mode", list(FUSED_MODES))
def test_bucket_block_pass_matches_twins_on_cuda(cuda, mode, layout,
                                                 n_need):
    """The fused pass, then (nearest read) the fallback, against their
    twins on two copies of the map at 49,152 entries; one launch each
    counted; the need blocks are the near ones, and beyond 32 they fill
    patch_skipped."""
    field, noise, bilinear = FUSED_MODES[mode]
    geom, m, wl, depth, t_cw, kmat, ts = bucket_case(cuda, field, layout,
                                                     n_need)
    mu = MU[field.name]
    a, b = clone_map(m), clone_map(m)
    fused, fallback = (kint.fused_name(field, noise, bilinear),
                       kint.fallback_name(field, noise))
    sk_a, sk_b = (torch.full((), 7, dtype=torch.int32, device=cuda)
                  for _ in range(2))
    before = _lib.LAUNCHES[fused]
    got = kint.integrate_fused(geom, a, field, wl, depth, t_cw, kmat, mu,
                               ts, noise, bilinear, sk_a if bilinear else None)
    assert _lib.LAUNCHES[fused] == before + 1
    want = kint.integrate_fused_plain(geom, b, field, wl, depth, t_cw, kmat,
                                      mu, ts, noise, bilinear,
                                      sk_b if bilinear else None)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    listed = wl < BUCKET_CAPACITY
    n_listed = int(listed.sum())
    assert n_listed == (0 if layout == "empty"
                        else N_COVERED + n_need + N_HIDDEN)
    assert (got[0][~listed] == 0).all() and (got[1][~listed] == 0).all()
    assert int(got[2].sum()) == (n_need if layout != "empty"
                                 and not bilinear else 0)
    if bilinear:
        assert int(sk_a) == int(sk_b) == 0
    else:
        before = _lib.LAUNCHES[fallback]
        sk_a = kint.integrate_fallback(geom, a, field, wl, depth, t_cw, kmat,
                                       mu, *got, ts, noise)
        assert _lib.LAUNCHES[fallback] == before + 1
        sk_b = kint.integrate_fallback_plain(geom, b, field, wl, depth, t_cw,
                                             kmat, mu, *want, ts, noise)
        assert int(sk_a) == int(sk_b)
        assert (int(sk_a) > 0) == (layout != "empty" and n_need > 32)
        assert torch.equal(got[0], want[0])
    assert torch.equal(a.active, b.active)
    assert torch.equal(a.data_y, b.data_y)
    assert torch.allclose(a.data_x, b.data_x, **UPDATE_TOL[field.name])
    if layout != "empty":
        assert int((a.data_x != m.data_x).sum()) > 0
    else:
        assert torch.equal(a.data_x, m.data_x)


@pytest.mark.cuda
@pytest.mark.parametrize("field", [TSDF, OFUSION], ids=["tsdf", "ofusion"])
def test_worklist_past_one_tile_a_cta_on_cuda(cuda, field):
    """A worklist longer than 512 entries for each CTA the card can hold
    (SMs x 4 CTAs of 512 threads x 512 x 2), its blocks at random entries
    up to the end: the fused pass and the fallback give the listed entries
    the outputs, and the map the payload, of the same passes over the
    listed entries alone; every empty entry mode 0, n_valid 0, need
    False."""
    geom, m, wl, depth, t_cw, kmat, ts = bucket_case(cuda, field, "prefix",
                                                     75)
    listed = wl[wl < BUCKET_CAPACITY]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n_work = sms * 4 * 512 * 2
    rng = np.random.default_rng(1)
    at = np.sort(rng.choice(n_work, listed.numel(), replace=False))
    assert at[-1] >= n_work // 2
    long = torch.full((n_work,), BUCKET_CAPACITY, dtype=torch.int32,
                      device=cuda)
    long[torch.from_numpy(at).to(cuda)] = listed
    mu = MU[field.name]
    out = []
    for entries in (long, listed.clone()):
        mm = clone_map(m)
        fused = kint.integrate_fused(geom, mm, field, entries, depth, t_cw,
                                     kmat, mu, ts)
        skipped = kint.integrate_fallback(geom, mm, field, entries, depth,
                                          t_cw, kmat, mu, *fused, ts)
        out.append((mm, fused, skipped))
    (ma, fa, sa), (mb, fb, sb) = out
    sel = torch.from_numpy(at).to(cuda)
    for x, y in zip(fa, fb):
        assert torch.equal(x[sel], y)
    empty = long == BUCKET_CAPACITY
    assert (fa[0][empty] == 0).all() and (fa[1][empty] == 0).all()
    assert not fa[2][empty].any()
    assert int(sa) == int(sb) > 0
    for key in ("data_x", "data_y", "active"):
        assert torch.equal(getattr(ma, key), getattr(mb, key)), key


@pytest.mark.cuda
def test_fallback_refuses_unaligned_need_on_cuda(cuda):
    """The fallback reads ``need`` 16 flags a load: a view that starts
    off a 16-byte boundary is refused before the launch."""
    geom, m, wl, depth, t_cw, kmat, ts = bucket_case(cuda, TSDF, "prefix",
                                                     17)
    mode, n_valid, need = kint.integrate_fused(geom, m, TSDF, wl, depth,
                                               t_cw, kmat, MU["tsdf"], ts)
    before = _lib.LAUNCHES["integrate_fallback"]
    with pytest.raises(ValueError):
        kint.integrate_fallback(geom, m, TSDF, wl[1:], depth, t_cw, kmat,
                                MU["tsdf"], mode[1:], n_valid[1:], need[1:],
                                ts)
    assert _lib.LAUNCHES["integrate_fallback"] == before


def test_k3_timer_refuses_without_a_card(monkeypatch, capsys):
    """``tools/k3_bucket`` times the card alone: without one it exits 2,
    naming CUDA, and prints no measurement."""
    from supereight_tpu_torch.tools import k3_bucket
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert k3_bucket.main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err
