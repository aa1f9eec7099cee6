"""The kernel wrappers: dispatch, argument checks, build inputs, and (on a
CUDA card only, marker ``cuda``) each kernel against its plain twin, for
both fields and the gather-form probe.

On the CPU a wrapper runs its twin because its tensors lie on the CPU;
on any other device it launches its kernel or raises. The ``cuda`` tests
run with ``python -m pytest tests/test_torch_kernels.py -m cuda`` on a
machine with an sm_90 GPU and nvcc, and skip elsewhere.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from supereight_tpu_torch.core import se3
from supereight_tpu_torch.core.map import (MapGeometry, make_map,
                                           touched_buffer)
from supereight_tpu_torch.fields import OFUSION, TSDF
from supereight_tpu_torch.io import synthetic
from supereight_tpu_torch.kernels import _lib, alloc, frame, icp, \
    integrate, nav, node, preprocess, raycast as kray
from supereight_tpu_torch.kernels import gather_probe as gp
from supereight_tpu_torch.ops import tracking
from supereight_tpu_torch.parallel import step
from supereight_tpu_torch.pipeline import preprocess_and_pyramid

W, H = 64, 48
K = (48.0, 48.0, 32.0, 24.0)
MU = {"tsdf": 0.1, "ofusion": 0.008}
# K3 update against its twin: TSDF distances to 1e-5; OFusion log-odds
# reach +-1000 and log2f differs from torch.log2 by ulps
UPDATE_TOL = {"tsdf": dict(atol=1e-5, rtol=0),
              "ofusion": dict(atol=1e-4, rtol=1e-5)}


def _frames(device, n=5, field=TSDF):
    depths, poses = synthetic.orbit_sequence(
        n + 1, K, width=W, height=H, radius=0.8, center=(1.0,) * 3,
        sphere_radius=0.3, angle_span=0.3, room=((0.15,) * 3, (1.85,) * 3))
    geom = MapGeometry(size=64, dim=2.0, capacity=1024)
    k = torch.tensor(K).to(device)
    state = step.init_frame_state(geom, field, (W, H), poses[0], device)
    for i in range(n):
        state, _ = step.frame_step(
            geom, field, state, torch.from_numpy(depths[i]).to(device), k, i,
            frame_size=(W, H), iterations=(3, 2), mu=MU[field.name],
            icp_threshold=1e-5, neg_y=False, filter_input=False,
            integration_rate=1, budget=1024)
    return geom, state, k, torch.from_numpy(depths[n]).to(device)


def test_cpu_tensors_take_the_twin_and_count_nothing():
    torch.set_num_threads(1)
    before = dict(_lib.LAUNCHES)
    _frames("cpu", n=2)
    _frames("cpu", n=2, field=OFUSION)
    for (name, kernel, _, _), (t, i) in zip(gp.FORMS, gp.probe_inputs()):
        kernel(torch.from_numpy(t), torch.from_numpy(i))
    assert _lib.LAUNCHES == before


def _node_args(geom, state, k, depth, field, t=0.2):
    """K4's arguments for ``depth`` at ``state``'s pose, stamped at t."""
    return (geom, state.map, field, depth, se3.inverse(state.pose),
            se3.camera_matrix(k), MU[field.name], 1024,
            torch.full((), t, device=depth.device),
            torch.ones((), dtype=torch.bool, device=depth.device))


@pytest.mark.parametrize("field", [TSDF, OFUSION], ids=["tsdf", "ofusion"])
def test_cpu_node_pass_and_pyramid_take_the_twins(field):
    """On CPU tensors K4 and K7's wrappers return their twins' results
    exactly and count no launch."""
    torch.set_num_threads(1)
    geom, state, k, depth = _frames("cpu", n=2, field=field)
    before = dict(_lib.LAUNCHES)
    m2 = clone_map(state.map)
    got = node.node_pass(*_node_args(geom, state, k, depth, field))
    want = node.node_pass_plain(*_node_args(geom, state._replace(map=m2), k,
                                            depth, field))
    assert torch.equal(got, want)
    for a, b in zip(state.map.mip_x + state.map.mip_y, m2.mip_x + m2.mip_y):
        assert torch.equal(a, b)
    for a, b in zip(preprocess.pyramid(depth, k, 3, True),
                    preprocess.pyramid_plain(depth, k, 3, True)):
        assert len(a) == len(b) == 3
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert _lib.LAUNCHES == before


def _prologue_rank_raycast(geom, state, k, depth, field, budget, when,
                           frame_no):
    """The pose prologue after a tracker's pose at ``frame_no`` (tracking
    rate 2, integration rate 3), the parent rank under ``budget`` and
    ``when``, and the raycast of ``depth`` at ``state``'s pose with the
    state's maps kept where the prologue's raycast gate is shut; each
    through its wrapper (the kernel on a card, the twin on the CPU)."""
    dev = depth.device
    moved = state.pose.clone()
    moved[:3, 3] += 0.01
    mats = frame.frame_mats(k, moved, state.pose,
                            torch.ones((), dtype=torch.bool, device=dev),
                            torch.full((), frame_no, dtype=torch.int32,
                                       device=dev), 2, 3)
    rank = node.node_rank(geom, state.map, budget, when)
    nv = nav.nav_grid(geom, state.map, field)
    prev = kray.Previous(mats.do_raycast, mats.pose, state.raycast_pose,
                         state.vertex, state.normal, state.valid)
    rays = kray.raycast_rays(geom, state.map, field, nv, mats.kpose, depth,
                             k, MU[field.name], (W, H), prev=prev)
    return mats, rank, rays


def _prologue_rank_raycast_plain(geom, state, k, depth, field, budget, when,
                                 frame_no):
    """:func:`_prologue_rank_raycast` through the twins."""
    dev = depth.device
    moved = state.pose.clone()
    moved[:3, 3] += 0.01
    mats = frame.frame_mats_plain(k, moved, state.pose,
                                  torch.ones((), dtype=torch.bool,
                                             device=dev),
                                  torch.full((), frame_no,
                                             dtype=torch.int32, device=dev),
                                  2, 3)
    rank = node.node_rank_plain(geom, state.map, budget, when)
    nv = nav.nav_grid_plain(geom, state.map, field)
    prev = kray.Previous(mats.do_raycast, mats.pose, state.raycast_pose,
                         state.vertex, state.normal, state.valid)
    rays = kray.raycast_plain(geom, field, state.map.data_x,
                              state.map.data_y, nv, mats.kpose, depth, k,
                              MU[field.name], (W, H), prev=prev)
    return mats, rank, rays


# (frame, rank budget, when): a gated-off raycast and an untracked frame
# (frame 2), a tracked and raycast frame under a parent budget of 2 (frame
# 4), an untracked frame past the early gates with the rank's when False
# (frame 5)
PROLOGUE_CASES = ((2, 1024, True), (4, 2, True), (5, 1024, False))


@pytest.mark.parametrize("field", [TSDF, OFUSION], ids=["tsdf", "ofusion"])
def test_cpu_prologue_rank_and_raycast_take_the_twins(field):
    """On CPU tensors the pose prologue, K4's rank and K1 (with the state's
    select) return their twins' results exactly and count no launch."""
    torch.set_num_threads(1)
    geom, state, k, depth = _frames("cpu", n=3, field=field)
    before = dict(_lib.LAUNCHES)
    for frame_no, budget, on in PROLOGUE_CASES:
        when = torch.tensor(on)
        got = _prologue_rank_raycast(geom, state, k, depth, field, budget,
                                     when, frame_no)
        want = _prologue_rank_raycast_plain(geom, state, k, depth, field,
                                            budget, when, frame_no)
        for a, b in zip(got[0] + got[1] + got[2], want[0] + want[1]
                        + want[2]):
            assert torch.equal(a, b)
    assert _lib.LAUNCHES == before


def _alloc_and_fuse(geom, m, pose, k, depth, field, plain):
    """K5's allocator, then K3's worklist, fused and fallback passes (the
    kernels, or their twins when ``plain``) for ``depth`` at ``pose``, in
    place on ``m``; returns their outputs."""
    mu = MU[field.name]
    dev = depth.device
    h, w = depth.shape
    mats = frame.frame_mats(k, pose)
    t_cw, kmat = mats.t_cw, mats.kmat
    ts = torch.full((), 0.2, device=dev)
    when = torch.ones((), dtype=torch.bool, device=dev)
    grids = ((alloc.touched_mask(geom, depth, pose, mats.kpose, mu,
                                 m.touched),)
             if field is TSDF
             else alloc.touched_masks_of(geom, depth, pose, mats.kpose, mu,
                                         m.touched))
    fn = {name: getattr(mod, name + ("_plain" if plain else "")) for mod, name
          in ((alloc, "alloc_assign"), (integrate, "integrate_worklist"),
              (integrate, "integrate_fused"),
              (integrate, "integrate_fallback"))}
    over = fn["alloc_assign"](geom, m, grids[0], when, None, grids[1:])
    wl, n_active, truncated = fn["integrate_worklist"](
        geom, m, t_cw, kmat, (w, h), 1024, when)
    mode, n_valid, need = fn["integrate_fused"](geom, m, field, wl, depth,
                                                t_cw, kmat, mu, ts)
    skipped = fn["integrate_fallback"](geom, m, field, wl, depth, t_cw, kmat,
                                       mu, mode, n_valid, need, ts)
    return over, wl, n_active, truncated, mode, n_valid, need, skipped


# a 320x240 wall 0.6 m ahead at 5x the focal length: blocks on all three
# depth levels and blocks too big for any, which take the fallback
K_CLOSE = (240.0, 240.0, 160.0, 120.0)


def _close_frame(device):
    return (torch.full((240, 320), 0.6, device=device),
            torch.tensor(K_CLOSE, device=device))


def _fallback_case(device, n=50):
    """K3-fallback inputs with more need blocks than the bound: n slots of
    one block 1 m before an identity camera, every 5th covered at level 1,
    the others needing the fallback (n_valid 1 .. n)."""
    geom = MapGeometry(size=64, dim=2.0, capacity=1024)
    m = make_map(geom, TSDF, device)
    m.block_coord[:n] = torch.tensor([0, 0, 4], dtype=torch.int32)
    m.active[:n] = True
    mode = torch.full((n,), -1, dtype=torch.int32, device=device)
    mode[::5] = 1
    return (geom, m, TSDF, torch.arange(n, dtype=torch.int32, device=device),
            torch.full((H, W), 1.1, device=device),
            torch.eye(4, device=device),
            se3.camera_matrix(torch.tensor(K, device=device)), MU["tsdf"],
            mode, torch.arange(1, n + 1, dtype=torch.int32, device=device),
            mode < 0)


@pytest.mark.parametrize("field", [TSDF, OFUSION], ids=["tsdf", "ofusion"])
def test_cpu_alloc_and_block_pass_take_the_twins(field):
    """On CPU tensors K5's allocator and K3's three wrappers return their
    twins' results and leave the same map, exactly, and count no launch;
    once on the next frame and once on a close frame that needs the
    fallback."""
    torch.set_num_threads(1)
    geom, state, k, depth = _frames("cpu", n=2, field=field)
    before = dict(_lib.LAUNCHES)
    for d, kk in ((depth, k), _close_frame("cpu")):
        a, b = clone_map(state.map), clone_map(state.map)
        got = _alloc_and_fuse(geom, a, state.pose, kk, d, field, False)
        want = _alloc_and_fuse(geom, b, state.pose, kk, d, field, True)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
        for x, y in zip(a, b):
            for u, v in zip(x if isinstance(x, tuple) else (x,),
                            y if isinstance(y, tuple) else (y,)):
                assert torch.equal(u, v)
    assert int(got[6].sum()) > 0 and int((got[4] == 2).sum()) > 0
    assert _lib.LAUNCHES == before


def _options_pass(geom, m, pose, k, depth, field, plain, noise, bilinear):
    """K3's worklist, then its fused pass in a noise-grade mode and (for the
    nearest read) the fallback, for ``depth`` at ``pose`` in place on
    ``m`` (the kernels, or their twins when ``plain``); returns their
    outputs."""
    mu = MU[field.name]
    dev = depth.device
    h, w = depth.shape
    mats = frame.frame_mats(k, pose)
    ts = torch.full((), 0.2, device=dev)
    when = torch.ones((), dtype=torch.bool, device=dev)
    sfx = "_plain" if plain else ""
    wl, _, _ = getattr(integrate, "integrate_worklist" + sfx)(
        geom, m, mats.t_cw, mats.kmat, (w, h), 1024, when)
    blk = (geom, m, field, wl, depth, mats.t_cw, mats.kmat, mu, ts)
    skipped = torch.full((), 7, dtype=torch.int32, device=dev)
    out = getattr(integrate, "integrate_fused" + sfx)(
        *blk, noise, bilinear, skipped if bilinear else None)
    if not bilinear:
        skipped = getattr(integrate, "integrate_fallback" + sfx)(
            *blk[:8], *out, ts, noise)
    return (wl, *out, skipped)


# (noise_weighted, bilinear) modes of K3's fused pass for each field
MODES = {"tsdf": ((True, False), (False, True), (True, True)),
         "ofusion": ((False, True),)}


@pytest.mark.parametrize("field", [TSDF, OFUSION], ids=["tsdf", "ofusion"])
def test_cpu_noise_options_take_the_twins(field):
    """On CPU tensors the input filters, K3's noise-grade modes and K1's
    maturity gate return their twins' results exactly and count no
    launch."""
    torch.set_num_threads(1)
    geom, state, k, depth = _frames("cpu", n=3, field=field)
    before = dict(_lib.LAUNCHES)
    noisy = torch.from_numpy(synthetic.add_depth_noise(depth.numpy(), 0.002,
                                                       seed=3))
    assert torch.equal(preprocess.bilateral_filter(noisy),
                       preprocess.bilateral_filter_plain(noisy))
    for passes in (1, 2):
        assert torch.equal(preprocess.median_filter3(noisy, passes),
                           preprocess.median_filter3_plain(noisy, passes))
    for noise, bilinear in MODES[field.name]:
        for d, kk in ((depth, k), _close_frame("cpu")):
            a, b = clone_map(state.map), clone_map(state.map)
            got = _options_pass(geom, a, state.pose, kk, d, field, False,
                                noise, bilinear)
            want = _options_pass(geom, b, state.pose, kk, d, field, True,
                                 noise, bilinear)
            for x, y in zip(got + tuple(a), want + tuple(b)):
                for u, v in zip(x if isinstance(x, tuple) else (x,),
                                y if isinstance(y, tuple) else (y,)):
                    assert torch.equal(u, v)
            assert int(got[-1]) == 0 or not bilinear
    view = se3.matmul4(state.pose, se3.inverse_camera_matrix(k))
    nv = nav.nav_grid(geom, state.map, field)
    m = state.map
    rays = kray.raycast_rays(geom, m, field, nv, view, depth, k,
                             MU[field.name], (W, H), min_ref_weight=2)
    want = kray.raycast_plain(geom, field, m.data_x, m.data_y, nv, view,
                              depth, k, MU[field.name], (W, H), slot=m.slot,
                              min_ref_weight=2)
    for a, b in zip(rays[:4], want[:4]):
        assert torch.equal(a, b)
    assert _lib.LAUNCHES == before


def test_other_devices_raise():
    """A tensor on neither the CPU nor a CUDA card is refused."""
    m = torch.zeros((2, 2, 3), device="meta")
    v = torch.zeros((2, 2), dtype=torch.bool, device="meta")
    p = torch.eye(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        icp.icp_reduce(m, m, v, m, m, v, p, p)
    with pytest.raises(ValueError, match="unsupported device"):
        icp.icp_track(p, p, (m,), (m,), (v,), m, m, v, (1,), 1e-5)
    with pytest.raises(ValueError, match="unsupported device"):
        alloc.touched_mask(MapGeometry(64, 2.0, 16),
                           torch.zeros((4, 4), device="meta"), p, p, 0.1,
                           touched_buffer(8, "meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        alloc.touched_masks_of(MapGeometry(64, 2.0, 16),
                               torch.zeros((4, 4), device="meta"), p, p,
                               0.008, touched_buffer(8, "meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        frame.frame_mats(torch.ones(4, device="meta"), p)
    geom = MapGeometry(64, 2.0, 16)
    with pytest.raises(ValueError, match="unsupported device"):
        nav.nav_grid(geom, make_map(geom, OFUSION, "meta"), OFUSION)
    d = torch.zeros((4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        node.node_pass(geom, make_map(geom, TSDF, "meta"), TSDF, d, p, p, 0.1,
                       16)
    with pytest.raises(ValueError, match="unsupported device"):
        node.node_rank(geom, make_map(geom, TSDF, "meta"), 16)
    with pytest.raises(ValueError, match="unsupported device"):
        kray.raycast_rays(geom, make_map(geom, TSDF, "meta"), TSDF,
                          torch.zeros(512, dtype=torch.int32, device="meta"),
                          p, d, torch.ones(4, device="meta"), 0.1, (4, 4))
    with pytest.raises(ValueError, match="unsupported device"):
        preprocess.pyramid(d, torch.ones(4, device="meta"), 3, False)
    with pytest.raises(ValueError, match="unsupported device"):
        preprocess.bilateral_filter(d)
    with pytest.raises(ValueError, match="unsupported device"):
        preprocess.median_filter3(d, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        gp.take_rows_staged(torch.zeros((4, 4), device="meta"),
                            torch.zeros(2, dtype=torch.int32, device="meta"))
    mm = make_map(geom, TSDF, "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        alloc.alloc_assign(geom, mm, torch.zeros((8, 8, 8), dtype=torch.bool,
                                                 device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        integrate.integrate_worklist(geom, mm, p, p, (4, 4), 16)
    wl = torch.zeros(16, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        integrate.integrate_fused(geom, mm, TSDF, wl, d, p, p, 0.1)
    with pytest.raises(ValueError, match="unsupported device"):
        integrate.integrate_fused(geom, mm, TSDF, wl, d, p, p, 0.1, None,
                                  True, True, wl[0])
    with pytest.raises(ValueError, match="unsupported device"):
        integrate.integrate_fallback(geom, mm, TSDF, wl, d, p, p, 0.1, wl, wl,
                                     wl.bool())


def test_check_rejects_bad_arguments():
    t = torch.zeros((4, 3))
    with pytest.raises(TypeError):
        _lib.check(t, "t", torch.int32)
    with pytest.raises(ValueError):
        _lib.check(t, "t", torch.float32, (3, 4))
    with pytest.raises(ValueError):
        _lib.check(t.t(), "t", torch.float32)


def test_build_hash_covers_every_source_and_flag():
    names = {p.name for p in _lib._sources()}
    assert {"icp.cu", "alloc.cu", "integrate.cu", "node.cu", "raycast.cu",
            "nav.cu", "preprocess.cu", "gather_probe.cu", "frame.cu",
            "common.cuh", "compact.cuh", "fields.cuh"} <= names
    assert _lib.source_hash() == _lib.source_hash()
    assert "arch=compute_90a,code=sm_90a" in _lib.NVCC_FLAGS
    assert "-fmad=false" in _lib.NVCC_FLAGS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("field", [TSDF, OFUSION], ids=["tsdf", "ofusion"])
def test_kernels_match_twins_on_cuda(cuda, field):
    geom, state, k, depth = _frames(cuda, field=field)
    m, pose = state.map, state.pose
    mu = MU[field.name]

    nv = nav.nav_grid(geom, m, field)
    assert torch.equal(nv, nav.nav_grid_plain(geom, m, field))
    view = se3.matmul4(pose, se3.inverse_camera_matrix(k))
    got = kray.raycast_rays(geom, m, field, nv, view, depth, k, mu, (W, H))
    ref = kray.raycast_plain(geom, field, m.data_x, m.data_y, nv, view,
                             depth, k, mu, (W, H))
    both = got[2] & ref[2]
    assert (got[2] == ref[2]).float().mean() >= 0.999
    assert torch.allclose(got[0][both], ref[0][both], atol=1e-4, rtol=0)

    kview = se3.matmul4(se3.camera_matrix(k), se3.inverse(state.raycast_pose))
    _, v, n, ok = preprocess_and_pyramid(depth, k, 2, False, False)
    args = (v[0], n[0], ok[0], state.vertex, state.normal, state.valid, pose,
            kview)
    rk, sk = icp.icp_reduce(*args)
    rp, sp = icp.icp_reduce_plain(*args)
    assert (rk == rp).float().mean() >= 0.999
    np.testing.assert_allclose(sk.cpu().numpy(), sp.cpu().numpy(),
                               rtol=1e-4, atol=1e-4 * float(sp.abs().max()))

    # K5's march bit-equal to its twin on the next frame, and on a random
    # depth (surfaces from 0.3 m to past the occupancy range, a tenth of
    # the pixels 0) from the frame's pose and from outside the map; into
    # the map's touched buffer (all zero between frames) as into a fresh
    # grid, one launch counted a call
    cases = [("frame", depth, pose)] + chip_smoke.march_cases(
        torch, geom, depth, pose, 0)
    assert chip_smoke.check_marches(torch, geom, field, mu, k, cases,
                                    "K5 march") == 0
    assert not m.touched.any()
    name = "alloc_touch" if field is TSDF else "alloc_touch_of"
    march = alloc.touched_mask if field is TSDF else alloc.touched_masks_of
    kpose = se3.matmul4(pose, se3.inverse_camera_matrix(k))
    before = _lib.LAUNCHES[name]
    into = march(geom, depth, pose, kpose, mu, out=m.touched)
    assert _lib.LAUNCHES[name] == before + 1
    fresh = march(geom, depth, pose, kpose, mu,
                  touched_buffer(geom.blocks_per_side, cuda))
    for a, b in zip(into if field is OFUSION else (into,),
                    fresh if field is OFUSION else (fresh,)):
        assert torch.equal(a, b) and bool(a.any())
    m.touched.zero_()


@pytest.mark.cuda
@pytest.mark.parametrize("size,mu", [(4096, 0.008), (512, 0.2)],
                         ids=["b512", "wide-band"])
def test_long_ladder_march_matches_twin_on_cuda(cuda, size, mu):
    """The occupancy march on geometries whose ladder has more than 300
    samples (the largest map the port admits, b = 512, at the OFusion mu;
    b = 64 at a wide band), bit-equal to its twin on a frame and on a
    random depth from the frame's pose and from outside the map."""
    _, state, k, depth = _frames(cuda, n=1, field=OFUSION)
    geom = MapGeometry(size=size, dim=2.0, capacity=1024)
    assert alloc.of_ladder(geom, mu, None, cuda).t.numel() > 300
    cases = [("frame", depth, state.pose)] + chip_smoke.march_cases(
        torch, geom, depth, state.pose, 2)
    assert chip_smoke.check_marches(torch, geom, OFUSION, mu, k, cases,
                                    f"K5-OF march (b {size // 8})") == 0


@pytest.mark.cuda
@pytest.mark.parametrize("field", [TSDF, OFUSION], ids=["tsdf", "ofusion"])
def test_masked_then_allocating_step_matches_twins_on_cuda(cuda, field):
    """Two allocation steps through the port's op, the march in the map's
    touched buffer: ``when`` false on a random depth, then true on the next
    frame, against the twins (fresh grids, alloc_assign_plain) on a copy of
    the map: slot grid, block_coord, active, n_blocks and every mip_alloc
    level bit for bit, and the buffer all zero after each step. The random
    depth touches unallocated cells that the frame does not, so marks left
    by the masked step would show."""
    from supereight_tpu_torch.ops import allocation
    geom, state, k, depth = _frames(cuda, field=field)
    mu = MU[field.name]
    pose = state.pose
    kpose = frame.frame_mats(k, pose).kpose  # the op's own
    a, b = clone_map(state.map), clone_map(state.map)
    op = (allocation.allocate_tsdf if field is TSDF
          else allocation.allocate_ofusion)
    march = (alloc.touched_masks_of_plain if field is OFUSION
             else lambda *x: (alloc.touched_mask_plain(*x),))
    noise = chip_smoke.march_cases(torch, geom, depth, pose, 1)[0][1]
    for d, on in ((noise, False), (depth, True)):
        when = torch.tensor(on, device=cuda)
        op(geom, a, d, pose, k, mu, when=when)
        assert not a.touched.any(), on
        grids = march(geom, d, pose, kpose, mu)
        alloc.alloc_assign_plain(geom, b, grids[0], when, None, grids[1:])
    for name in ("slot", "block_coord", "active", "n_blocks"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for x, y in zip(a.mip_alloc, b.mip_alloc):
        assert torch.equal(x, y)
    stale = march(geom, noise, pose, kpose, mu)[0]
    assert bool((stale & ~march(geom, depth, pose, kpose, mu)[0]
                 & (a.slot < 0)).any())



@pytest.mark.cuda
@pytest.mark.parametrize("field", [TSDF, OFUSION], ids=["tsdf", "ofusion"])
def test_alloc_and_block_pass_match_twins_on_cuda(cuda, field):
    """K5's allocator and K3's worklist, fused and fallback kernels against
    their twins on two copies of the map, on the next frame and on a close
    frame that needs the fallback: every integer output and the slot grid,
    block_coord, active, n_blocks and mip_alloc bit for bit, data_x to
    UPDATE_TOL and data_y exactly; one launch of each counted. The
    fallback kernel also against its twin with more need blocks than its
    bound. The wrappers refuse bad arguments."""
    geom, state, k, depth = _frames(cuda, field=field)
    of = "_of" if field is OFUSION else ""
    names = ("alloc_assign", "integrate_worklist", "integrate_fused" + of,
             "integrate_fallback" + of)
    for d, kk in ((depth, k), _close_frame(cuda)):
        a, b = clone_map(state.map), clone_map(state.map)
        before = {n: _lib.LAUNCHES[n] for n in names}
        got = _alloc_and_fuse(geom, a, state.pose, kk, d, field, False)
        assert all(_lib.LAUNCHES[n] == before[n] + 1 for n in names)
        want = _alloc_and_fuse(geom, b, state.pose, kk, d, field, True)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
        for name in ("slot", "block_coord", "active", "n_blocks"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name
        for x, y in zip(a.mip_alloc, b.mip_alloc):
            assert torch.equal(x, y)
        assert torch.allclose(a.data_x, b.data_x, **UPDATE_TOL[field.name])
        assert torch.equal(a.data_y, b.data_y)
    assert int(got[6].sum()) > 0 and int((got[4] == 2).sum()) > 0
    ka, kb = _fallback_case(cuda), _fallback_case(cuda)
    sk = integrate.integrate_fallback(*ka)
    sp = integrate.integrate_fallback_plain(*kb)
    assert int(sk) == int(sp) > 0
    assert torch.equal(ka[8], kb[8]) and torch.equal(ka[1].active,
                                                     kb[1].active)
    assert torch.allclose(ka[1].data_x, kb[1].data_x, atol=1e-5, rtol=0)
    assert torch.equal(ka[1].data_y, kb[1].data_y)
    m = state.map
    with pytest.raises(TypeError):
        alloc.alloc_assign(geom, m, m.slot, None)
    with pytest.raises(ValueError):
        alloc.alloc_assign(geom, m, m.slot >= 0, None, None, (m.slot,) * 3)
    p = se3.inverse(state.pose)
    with pytest.raises(ValueError):
        integrate.integrate_worklist(geom, m, p.t(), p, (W, H), 16)
    wl = torch.zeros(16, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        integrate.integrate_fused(geom, m, field, wl.float(), depth, p, p,
                                  0.1, torch.zeros((), device=cuda))
    with pytest.raises(ValueError):
        integrate.integrate_fallback(geom, m, field, wl, depth, p, p, 0.1,
                                     wl[:8], wl, wl.bool(),
                                     torch.zeros((), device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("field", [TSDF, OFUSION], ids=["tsdf", "ofusion"])
def test_noise_options_match_twins_on_cuda(cuda, field):
    """The noise-grade kernels against their twins: the median filters bit
    for bit and the bilateral to 1e-5 m (CUDA's expf against torch's exp
    of a reciprocal product) on a noisy frame with a tenth of its pixels
    0; K3's modes (the TSDF noise weight, the bilinear read, both) as
    ``test_alloc_and_block_pass_match_twins_on_cuda`` holds its nearest
    read, on the next frame and on a close frame; K1's TSDF maturity
    gate: the hit mask on >= 99.9 % of rays, vertices to 1e-4 m, and
    some hits dropped. One launch of each counted per call."""
    geom, state, k, depth = _frames(cuda, field=field)
    rng = np.random.RandomState(5)
    noisy = synthetic.add_depth_noise(depth.cpu().numpy(), 0.002, seed=5)
    noisy[rng.rand(*noisy.shape) < 0.1] = 0.0
    noisy = torch.from_numpy(noisy).to(cuda)
    before = _lib.LAUNCHES["bilateral"]
    got = preprocess.bilateral_filter(noisy)
    assert _lib.LAUNCHES["bilateral"] == before + 1
    assert torch.allclose(got, preprocess.bilateral_filter_plain(noisy),
                          atol=1e-5, rtol=0)
    for passes, name in ((1, "median"), (2, "median2")):
        before = _lib.LAUNCHES[name]
        got = preprocess.median_filter3(noisy, passes)
        assert _lib.LAUNCHES[name] == before + 1
        assert torch.equal(got, preprocess.median_filter3_plain(noisy,
                                                                passes))
    for noise, bilinear in MODES[field.name]:
        fused = integrate.fused_name(field, noise, bilinear)
        for d, kk in ((depth, k), _close_frame(cuda)):
            a, b = clone_map(state.map), clone_map(state.map)
            before = _lib.LAUNCHES[fused]
            got = _options_pass(geom, a, state.pose, kk, d, field, False,
                                noise, bilinear)
            assert _lib.LAUNCHES[fused] == before + 1
            want = _options_pass(geom, b, state.pose, kk, d, field, True,
                                 noise, bilinear)
            for x, y in zip(got, want):
                assert torch.equal(x, y)
            assert torch.equal(a.active, b.active)
            assert torch.allclose(a.data_x, b.data_x,
                                  **UPDATE_TOL[field.name])
            assert torch.equal(a.data_y, b.data_y)
    if field is OFUSION:
        return
    m = state.map
    view = se3.matmul4(state.pose, se3.inverse_camera_matrix(k))
    nv = nav.nav_grid(geom, m, field)
    before = _lib.LAUNCHES["raycast_gated"]
    rays = kray.raycast_rays(geom, m, field, nv, view, depth, k, MU["tsdf"],
                             (W, H), min_ref_weight=3)
    assert _lib.LAUNCHES["raycast_gated"] == before + 1
    want = kray.raycast_plain(geom, field, m.data_x, m.data_y, nv, view,
                              depth, k, MU["tsdf"], (W, H), slot=m.slot,
                              min_ref_weight=3)
    ungated = kray.raycast_plain(geom, field, m.data_x, m.data_y, nv, view,
                                 depth, k, MU["tsdf"], (W, H))
    both = rays.valid & want.valid
    assert (rays.valid == want.valid).float().mean() >= 0.999
    assert torch.allclose(rays.vertex[both], want.vertex[both], atol=1e-4,
                          rtol=0)
    assert 0 < int(want.valid.sum()) < int(ungated.valid.sum())


@pytest.mark.cuda
def test_gather_forms_bit_exact_on_cuda(cuda):
    for (name, kernel, plain, expect), (t, i) in zip(gp.FORMS,
                                                     gp.probe_inputs()):
        tt, it = torch.from_numpy(t).to(cuda), torch.from_numpy(i).to(cuda)
        got = kernel(tt, it)
        assert torch.equal(got, plain(tt, it)), name
        np.testing.assert_array_equal(got.cpu().numpy(), expect(t, i))


def clone_map(m):
    return type(m)(*(tuple(x.clone() for x in v) if isinstance(v, tuple)
                     else v.clone() for v in m))


@pytest.mark.cuda
@pytest.mark.parametrize("field", [TSDF, OFUSION], ids=["tsdf", "ofusion"])
def test_node_pass_and_pyramid_match_twins_on_cuda(cuda, field):
    """K4 against its twin on two copies of the map: mip values to K3's
    UPDATE_TOL, time stamps and mip_skipped exactly, one launch counted.
    K7's one launch against its composed twins on a 3-level pyramid, both
    neg_y (:func:`assert_pyramid_matches_twins`)."""
    geom, state, k, depth = _frames(cuda, field=field)
    m2 = clone_map(state.map)
    before = _lib.LAUNCHES["node_pass"]
    got = node.node_pass(*_node_args(geom, state, k, depth, field))
    assert _lib.LAUNCHES["node_pass"] == before + 1
    want = node.node_pass_plain(*_node_args(geom, state._replace(map=m2), k,
                                            depth, field))
    assert int(got) == int(want)
    for a, b in zip(state.map.mip_x, m2.mip_x):
        assert torch.allclose(a, b, **UPDATE_TOL[field.name])
    for a, b in zip(state.map.mip_y, m2.mip_y):
        assert torch.allclose(a, b, atol=1e-5, rtol=0) if field is TSDF \
            else torch.equal(a, b)
    for neg_y in (False, True):
        assert_pyramid_matches_twins(depth, k, 3, neg_y)


def assert_pyramid_matches_twins(depth, k, levels, neg_y):
    """K7 (one launch counted) against :func:`preprocess.pyramid_plain`:
    depths, vertices and valid masks bit-equal, normals to 1e-6; every
    level's tensor contiguous."""
    before = _lib.LAUNCHES["pyramid"]
    got = preprocess.pyramid(depth, k, levels, neg_y)
    assert _lib.LAUNCHES["pyramid"] == before + 1
    want = preprocess.pyramid_plain(depth, k, levels, neg_y)
    for name, a, b in zip(("depth", "vertex", "normal", "valid"), got, want):
        assert len(a) == len(b) == levels
        for lvl, (x, y) in enumerate(zip(a, b)):
            assert x.is_contiguous() and x.shape == y.shape, (name, lvl)
            if name == "normal":
                assert float((x - y).abs().max()) <= 1e-6, (name, lvl)
            else:
                assert torch.equal(x, y), (name, lvl)


# K7 on the card: the bench size, an odd size that leaves a partial tile
# at every level, and a small odd one whose coarse levels are a few pixels
PYRAMID_SIZES = ((240, 320), (121, 161), (17, 33))


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [1, 2, 3, 4])
@pytest.mark.parametrize("size", PYRAMID_SIZES,
                         ids=[f"{w}x{h}" for h, w in PYRAMID_SIZES])
def test_pyramid_matches_twins_on_cuda(cuda, size, levels):
    """K7 against its composed twins on a random depth frame with 10 %
    holes and 5 % outliers (which the robust mean leaves out), both
    neg_y."""
    rng = np.random.RandomState(levels)
    d = rng.uniform(0.3, 4.0, size).astype(np.float32)
    d[rng.rand(*size) < 0.1] = 0.0
    d[rng.rand(*size) < 0.05] *= 3.0
    k = torch.tensor(K, device=cuda)
    for neg_y in (False, True):
        assert_pyramid_matches_twins(torch.from_numpy(d).to(cuda), k, levels,
                                     neg_y)


@pytest.mark.cuda
@pytest.mark.parametrize("field", [TSDF, OFUSION], ids=["tsdf", "ofusion"])
@pytest.mark.parametrize("b", chip_smoke.NAV_SIDES)
def test_nav_grid_matches_twin_on_cuda(cuda, b, field):
    """K2 bit-equal to its twin, block count and bucket clamp exactly, on
    ``chip_smoke.nav_cases`` of side b (multi-word columns past 64,
    partial words below 32): random grids at 1 %, 10 % and 50 %
    occupancy, one with a single block, whose cells lie at distances 0 to
    b - 1 (5 and 6 among them for b >= 8), and an empty one; each with
    the full pool and a bucket of half the blocks. One launch counted a
    call."""
    for i, (geom, m) in enumerate(chip_smoke.nav_cases(torch, b, cuda)):
        n = int(m.n_blocks)
        for bucket in (None, n // 2):
            before = _lib.LAUNCHES["nav_grid"]
            got, counts = nav.nav_grid(geom, m, field, bucket, True)
            assert _lib.LAUNCHES["nav_grid"] == before + 1
            want, wcounts = nav.nav_grid_plain(geom, m, field, bucket, True)
            assert torch.equal(got, want), (i, bucket)
            assert torch.equal(counts, wcounts), (i, bucket)
        dist = ((-want - 1) & 7)[want < 0]
        if i == len(chip_smoke.NAV_DENSITIES) and b >= 8:
            assert bool((dist == 5).any()) and bool((dist == 6).any())
        if i == len(chip_smoke.NAV_DENSITIES) + 1:
            assert bool((want < 0).all()) and bool((dist == 6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("field", [TSDF, OFUSION], ids=["tsdf", "ofusion"])
def test_prologue_rank_and_raycast_match_twins_on_cuda(cuda, field):
    """The pose prologue bit for bit, K4's rank (gate grid and mip_skipped)
    exactly and K1 with the state's select against their twins: where the
    raycast gate is shut the old maps, pose and a zero ray_overflow
    exactly, else the hit mask on >= 99.9 % of rays and vertices to 1e-4
    m; one launch of each counted per call."""
    geom, state, k, depth = _frames(cuda, field=field)
    names = ("frame_mats", "node_rank", "raycast_of" if field is OFUSION
             else "raycast")
    for frame_no, budget, on in PROLOGUE_CASES:
        when = torch.tensor(on, device=cuda)
        before = {n: _lib.LAUNCHES[n] for n in names}
        mats, rank, rays = _prologue_rank_raycast(geom, state, k, depth,
                                                  field, budget, when,
                                                  frame_no)
        assert all(_lib.LAUNCHES[n] == before[n] + 1 for n in names)
        pm, pr, prays = _prologue_rank_raycast_plain(
            geom, state, k, depth, field, budget, when, frame_no)
        for a, b in zip(mats + rank, pm + pr):
            assert torch.equal(a, b)
        assert torch.equal(rays.raycast_pose, prays.raycast_pose)
        assert int(rays.overflow) == int(prays.overflow)
        if not bool(mats.do_raycast):
            for a, b in zip(rays[:3], (state.vertex, state.normal,
                                       state.valid)):
                assert torch.equal(a, b)
            assert int(rays.overflow) == 0
        else:
            both = rays.valid & prays.valid
            assert (rays.valid == prays.valid).float().mean() >= 0.999
            assert torch.allclose(rays.vertex[both], prays.vertex[both],
                                  atol=1e-4, rtol=0)
    assert int(rank[1]) == 0 and int(pr[1]) == 0  # when False
    torch.cuda.synchronize()
    assert not any(bool(v.any()) for v in kray._SCRATCH.values())


@pytest.mark.cuda
@pytest.mark.parametrize("field", [TSDF, OFUSION], ids=["tsdf", "ofusion"])
def test_raycast_overflow_on_two_streams_on_cuda(cuda, field):
    """K1 with a bound of 4 probes a ray, so that rays overflow, launched
    four times on each of two streams with no sync between: every launch
    counts ray_overflow as the twin does, each stream has its own overflow
    scratch, and every scratch is left zero."""
    geom, state, k, depth = _frames(cuda, field=field)
    m, mu = state.map, MU[field.name]
    nv = nav.nav_grid(geom, m, field)
    view = se3.matmul4(state.pose, se3.inverse_camera_matrix(k))
    max_steps = 4 - kray.EXTRA_PROBES
    want = kray.raycast_plain(geom, field, m.data_x, m.data_y, nv, view,
                              depth, k, mu, (W, H), max_steps)
    assert int(want.overflow) > 0
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    torch.cuda.synchronize()
    got = []
    for _ in range(4):
        for st in streams:
            with torch.cuda.stream(st):
                got.append(kray.raycast_rays(geom, m, field, nv, view, depth,
                                             k, mu, (W, H), max_steps))
    torch.cuda.synchronize()
    assert all(int(r.overflow) == int(want.overflow) for r in got)
    assert {(cuda, st.cuda_stream) for st in streams} <= set(kray._SCRATCH)
    assert not any(bool(v.any()) for v in kray._SCRATCH.values())


def _track_args(cuda, field):
    """Frame 5's tracking inputs after five frames of ``field`` on the
    card: (pose, view, pyramid maps, reference maps)."""
    geom, state, k, depth = _frames(cuda, field=field)
    _, v, n, ok = preprocess_and_pyramid(depth, k, 3, False, False)
    view = se3.matmul4(se3.camera_matrix(k), se3.inverse(state.raycast_pose))
    return (state.pose, view, v, n, ok, state.vertex, state.normal,
            state.valid)


@pytest.mark.cuda
@pytest.mark.parametrize("field", [TSDF, OFUSION], ids=["tsdf", "ofusion"])
def test_icp_track_matches_plain_on_cuda(cuda, field):
    """The one-launch tracking step against its plain twin: tracked equal,
    pose to 1e-4, reduction entries 0-27 to 1e-3 of themselves (floored at
    1e-4 of the largest), the counts 28-31 to 0.1 % of the pixels, result
    codes on >= 99.9 % of pixels; one launch counted; two launches
    bit-identical."""
    args = _track_args(cuda, field)
    iters = (10, 5, 4)
    before = _lib.LAUNCHES["icp_track"]
    got = icp.icp_track(*args, iters, 1e-5)
    assert _lib.LAUNCHES["icp_track"] == before + 1
    want = icp.icp_track_plain(*args, iters, 1e-5)
    assert bool(got[1]) == bool(want[1])
    assert float((got[0] - want[0]).abs().max()) <= 1e-4
    rk, rp = got[2].cpu().numpy(), want[2].cpu().numpy()
    scale = np.abs(rp[:28]) + 1e-4 * np.abs(rp[:28]).max()
    assert (np.abs(rk[:28] - rp[:28]) / scale).max() <= 1e-3
    assert np.abs(rk[28:] - rp[28:]).max() <= 1e-3 * got[3].numel()
    assert (got[3] == want[3]).float().mean() >= 0.999
    again = icp.icp_track(*args, iters, 1e-5)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_inverse_sum_order_on_the_tsdf_bench_slice_on_cuda(cuda,
                                                           monkeypatch):
    """chip_smoke.py's TSDF bench slice (43 frames, 512^3 voxels over
    4.8 m) as the port runs it, the pose prologue summing R^T t of
    inverse(pose) left to right, and again with R^T t summed by
    torch.matmul (a cuBLAS product: the stages' order before the
    prologue). Both pass the slice's checks (every frame from 4 on
    tracked, no drop, final position error below MAX_POS_ERR) and their
    block counts differ by at most 0.1 %. Prints each run's block count
    and error and the frames whose pose differs (``-s`` shows them)."""
    sc = chip_smoke.Scene(torch, TSDF, cuda)

    def run():
        state, poses, auxes = sc.init(), [], []
        for i in range(sc.n_total):
            state, aux = sc.frame(state, i)
            poses.append(state.pose.clone())
            auxes.append(aux)
        err = float(np.linalg.norm(state.pose.cpu().numpy()[:3, 3]
                                   - sc.poses[-1][:3, 3]))
        assert all(bool(a["tracked"]) for a in auxes[4:])
        assert all(int(a[c]) == 0 for a in auxes for c in chip_smoke.COUNTERS)
        assert err < chip_smoke.MAX_POS_ERR
        return int(state.map.n_blocks), err, poses

    def matmul_prologue(*args, **kw):
        m = frame.frame_mats_plain(*args, **kw)
        t_cw = m.t_cw.clone()
        t_cw[:3, 3] = -torch.matmul(m.pose[:3, :3].transpose(0, 1),
                                    m.pose[:3, 3:])[:, 0]
        return m._replace(t_cw=t_cw, view=se3.matmul4(m.kmat, t_cw))

    runs = {"left to right": run()}
    monkeypatch.setattr(step, "frame_mats", matmul_prologue)
    monkeypatch.setattr(tracking, "frame_mats", matmul_prologue)
    runs["torch.matmul"] = run()
    for name, (n, err, _) in runs.items():
        print(f"R^T t summed {name}: n_blocks {n}, final position error "
              f"{err:.4f} m")
    (n_a, _, a), (n_b, _, b) = runs.values()
    differ = [i for i, (x, y) in enumerate(zip(a, b)) if not torch.equal(x, y)]
    print(f"frames whose pose differs: {len(differ)} of {len(a)}, first "
          f"{differ[:1]}")
    assert abs(n_a - n_b) <= 0.001 * n_a


def _moved_view(k, pose, shift):
    """The prologue's view of ``pose`` moved ``shift`` m along its optical
    axis (forward > 0)."""
    p = pose.clone()
    p[:3, 3] += shift * p[:3, 2]
    return frame.frame_mats(k, p).kpose


def test_unprimed_raycast_refuses_select_and_gate():
    """K1's unprimed launch takes neither the frame state's select nor the
    maturity gate (JAX's unprimed raycast has neither)."""
    torch.set_num_threads(1)
    geom, state, k, _ = _frames("cpu", n=3)
    m = state.map
    nv = nav.nav_grid(geom, m, TSDF)
    view = _moved_view(k, state.pose, -0.5)
    prev = kray.Previous(torch.ones((), dtype=torch.bool), state.pose,
                         state.raycast_pose, state.vertex, state.normal,
                         state.valid)
    with pytest.raises(ValueError, match="unprimed"):
        kray.raycast_rays(geom, m, TSDF, nv, view, None, None, 0.1, (W, H),
                          prev=prev)
    with pytest.raises(ValueError, match="unprimed"):
        kray.raycast_rays(geom, m, TSDF, nv, view, None, None, 0.1, (W, H),
                          min_ref_weight=2)


@pytest.mark.cuda
@pytest.mark.parametrize("field", [TSDF, OFUSION], ids=["tsdf", "ofusion"])
def test_unprimed_raycast_matches_twin_on_cuda(cuda, field):
    """K1's unprimed launch (``raycast_cold[_of]``) against its twin, over
    the nav grid of every block: from the pose moved 0.5 m back, marched
    to twice the far plane, and from a view whose centre ray starts 5 cm
    behind the surface the last frame saw there, where some rays start
    behind a surface: those march no probe in the twin and miss in the
    kernel. Hit masks on >= 99.9 % of rays, vertices to 1e-4 m and
    normals to 1e-3 on the rays both hit, ray_overflow exactly."""
    from supereight_tpu_torch.constants import FAR_PLANE, NEAR_PLANE
    geom, state, k, depth = _frames(cuda, field=field)
    m, mu = state.map, MU[field.name]
    nv = nav.nav_grid(geom, m, field)
    name = "raycast_cold_of" if field is OFUSION else "raycast_cold"
    centre = float(depth[H // 2, W // 2])
    for shift, far in ((-0.5, 2.0 * FAR_PLANE),
                       (centre - NEAR_PLANE + 0.05, FAR_PLANE)):
        view = _moved_view(k, state.pose, shift)
        before = _lib.LAUNCHES[name]
        got = kray.raycast_rays(geom, m, field, nv, view, None, None, mu,
                                (W, H), far=far)
        assert _lib.LAUNCHES[name] == before + 1
        want, probes = kray.raycast_plain(geom, field, m.data_x, m.data_y,
                                          nv, view, None, None, mu, (W, H),
                                          with_probes=True, far=far)
        assert int(got.overflow) == int(want.overflow)
        assert (got.valid == want.valid).float().mean() >= 0.999
        both = got.valid & want.valid
        assert int(both.sum()) > 0
        assert torch.allclose(got.vertex[both], want.vertex[both], atol=1e-4,
                              rtol=0)
        assert torch.allclose(got.normal[both], want.normal[both], atol=1e-3,
                              rtol=0)
        blocked = chip_smoke.blocked_starts(geom, view, probes, far)
        if shift > 0:
            assert int(blocked.sum()) > 0
        assert not bool((got.valid & blocked).any())


@pytest.mark.cuda
@pytest.mark.parametrize("field", ["tsdf", "ofusion"])
def test_class_pipeline_on_cuda_matches_cpu(cuda, field):
    """The class pipeline (``pipeline.DenseSLAMSystem``) on the card
    against the same run on the CPU (its stages through the twins) over
    six orbit frames: poses to 1e-4 m, block counts and every frame's
    result exactly; the depth and track renders equal, the volume render
    from the raycast pose and from a fresh view on >= 99.9 % of pixels."""
    from supereight_tpu_torch.config import Configuration
    from supereight_tpu_torch.pipeline import DenseSLAMSystem
    depths, poses = synthetic.orbit_sequence(
        6, K, width=W, height=H, radius=0.8, center=(1.0,) * 3,
        sphere_radius=0.3, angle_span=0.3, room=((0.15,) * 3, (1.85,) * 3))
    cfg = Configuration(volume_resolution=64, volume_size=2.0,
                        mu=MU[field], camera=K, integration_rate=1,
                        pyramid=(3, 2), block_capacity=1024, field=field)
    pipes = [DenseSLAMSystem((W, H), cfg, init_pose=poses[0], device=d)
             for d in (cuda, "cpu")]
    for i, d in enumerate(depths):
        res = [p.process_frame(d, i, is_mm=False,
                               gt_pose=poses[i] if i < 2 else None)
               for p in pipes]
        assert {k: int(v) for k, v in res[0].items()} == \
            {k: int(v) for k, v in res[1].items()}, i
        np.testing.assert_allclose(pipes[0].get_pose(), pipes[1].get_pose(),
                                   atol=1e-4)
        assert pipes[0].block_count() == pipes[1].block_count()
    a, b = pipes
    np.testing.assert_array_equal(a.render_depth(), b.render_depth())
    np.testing.assert_array_equal(a.render_track(), b.render_track())
    view_pose = poses[-1].copy()
    view_pose[:3, 3] -= 0.5 * view_pose[:3, 2]
    for va, vb in ((a.render_volume(), b.render_volume()),
                   (a.render_volume(view_pose), b.render_volume(view_pose))):
        assert (va == vb).all(-1).mean() >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("field", ["tsdf", "ofusion"])
def test_library_surface_on_cuda_matches_cpu(cuda, field):
    """``core/map.allocate_blocks`` (K5's alloc_assign on the card), the
    voxel reads and writes, interp, grad, collision and marching cubes on
    the card against the same calls on the CPU: the map and every integer
    result exactly, the reads exactly, interp and grad to 1e-6."""
    from supereight_tpu_torch.core import geometry, interp
    from supereight_tpu_torch.core import map as tmap
    from supereight_tpu_torch.fields import get_field
    from supereight_tpu_torch.io import meshing
    from supereight_tpu_torch.kernels import _lib
    fld = get_field(field)
    geom = tmap.MapGeometry(size=64, dim=2.0, capacity=300)
    rng = np.random.default_rng(3)
    mask = torch.from_numpy(rng.random((8, 8, 8)) < 0.4)
    v = torch.from_numpy(rng.integers(-8, 72, (6000, 3)).astype(np.int32))
    v = torch.unique(v, dim=0)
    x = torch.from_numpy(rng.normal(size=len(v)).astype(np.float32))
    y = torch.from_numpy((rng.random(len(v)) > 0.2).astype(np.float32))
    p = torch.from_numpy(rng.uniform(-2, 66, (3000, 3)).astype(np.float32))
    out = []
    for dev in (cuda, "cpu"):
        m = tmap.make_map(geom, fld, dev)
        _lib.reset_launches()
        _, st = tmap.allocate_blocks(geom, m, mask.to(dev), with_stats=True,
                                     budget=100)
        assert _lib.LAUNCHES["alloc_assign"] == (dev == cuda)
        tmap.set_voxels(m, v.to(dev), x.to(dev), y.to(dev))
        out.append(dict(
            state=[t.cpu() for f in m[:-1] for t in
                   (f if isinstance(f, tuple) else (f,))],
            overflow=int(st["alloc_overflow"]),
            reads=[t.cpu() for t in tmap.get_with_coarse(geom, m, fld,
                                                         v.to(dev))],
            interp=interp.interp(geom, m, fld, p.to(dev)).cpu(),
            grad=interp.grad(geom, m, fld, p.to(dev)).cpu(),
            collide=[int(geometry.collides_with(geom, m, fld, lo, hi))
                     for lo, hi in (((0, 0, 0), (9, 9, 9)),
                                    ((60, 60, 60), (70, 66, 66)))],
            mesh=meshing.marching_cubes(geom, m)))
    a, b = out
    assert a["overflow"] == b["overflow"] > 0
    for ta, tb in zip(a["state"] + a["reads"], b["state"] + b["reads"]):
        assert torch.equal(ta, tb)
    assert torch.allclose(a["interp"], b["interp"], rtol=1e-6, atol=1e-6)
    assert torch.allclose(a["grad"], b["grad"], rtol=1e-6, atol=1e-6)
    assert a["collide"] == b["collide"]
    np.testing.assert_array_equal(a["mesh"], b["mesh"])


@pytest.mark.cuda
def test_pose_graph_on_cuda_matches_cpu(cuda):
    """``posegraph/graph.optimize`` on the card against the CPU on a
    drifting 24-node chain with closures, padded edges and a frozen node:
    poses to 1e-5; two solves on the card bit-identical (no float
    atomics)."""
    from supereight_tpu_torch.core import se3
    from supereight_tpu_torch.posegraph import graph as pg
    gen = torch.Generator().manual_seed(5)
    n = 24
    steps = se3.exp(torch.randn((n, 6), generator=gen) * 0.1)
    gt = [torch.eye(4)]
    for k in range(1, n):
        gt.append(se3.matmul4(gt[-1], steps[k]))
    gt = torch.stack(gt)
    est = se3.matmul4(gt, se3.exp(torch.randn((n, 6), generator=gen)
                                  * 0.02))
    pairs = [(k, k + 1) for k in range(n - 1)] + [(0, 12), (3, 20), (5, 23)]
    cap = len(pairs) + 9
    i = torch.zeros(cap, dtype=torch.int32)
    j = torch.zeros(cap, dtype=torch.int32)
    tm = torch.eye(4).repeat(cap, 1, 1)
    valid = torch.zeros(cap, dtype=torch.bool)
    for k, (a, b) in enumerate(pairs):
        i[k], j[k], valid[k] = a, b, True
        tm[k] = se3.matmul4(se3.inverse(gt[a]), gt[b])
    w = torch.rand(cap, generator=gen) * 20 + 1
    fixed = torch.zeros(n, dtype=torch.bool)
    fixed[7] = True
    graph = pg.PoseGraph(i, j, tm, w, valid)

    def solve(dev):
        return pg.optimize(est.to(dev), pg.PoseGraph(
            *(x.to(dev) for x in graph)), n, fixed=fixed.to(dev))
    got, again = solve(cuda), solve(cuda)
    assert torch.equal(got, again)
    assert torch.allclose(got.cpu(), solve("cpu"), atol=1e-5, rtol=0)
