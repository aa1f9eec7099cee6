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
from supereight_tpu_torch.constants import (DIST_THRESHOLD, NORMAL_THRESHOLD,
                                            TRACK_THRESHOLD)
from supereight_tpu_torch.core import se3
from supereight_tpu_torch.core.map import (MapGeometry, make_map,
                                           touched_buffer)
from supereight_tpu_torch.fields import OFUSION, TSDF
from supereight_tpu_torch.io import synthetic
from supereight_tpu_torch.kernels import _lib, alloc, frame, icp, \
    integrate, nav, node, preprocess, raycast as kray, render
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
            "render.cu", "common.cuh", "compact.cuh", "fields.cuh"} <= names
    assert _lib.source_hash() == _lib.source_hash()
    assert "arch=compute_90a,code=sm_90a" in _lib.NVCC_FLAGS
    assert "-fmad=false" in _lib.NVCC_FLAGS


def test_signatures_match_the_c_prototypes():
    """Every bound entry point takes as many arguments as its C prototype
    in csrc/ declares (ctypes passes an argument past ``argtypes`` as a
    C int, which cuts a pointer such as the stream)."""
    import re
    declared = {}
    for path in _lib._sources():
        for m in re.finditer(r"SE_EXPORT\s+int\s+(\w+)\s*\(([^)]*)\)",
                             path.read_text()):
            declared[m.group(1)] = len([a for a in m.group(2).split(",")
                                        if a.strip() not in ("", "void")])
    assert {k: len(v) for k, v in _lib._SIGNATURES.items()} == {
        k: declared.get(k) for k in _lib._SIGNATURES}


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


# the gather forms' cases on the card: the probe's inputs, the pool's cut
# 8-fold, widths that take the scalar or a mixed path, a table 4 bytes
# past a 16-byte boundary, and indices at -1 and at the edge past the last
GATHER_CASES = ["probe", "pool", "width3", "width5", "width130", "offset",
                "clamped"]
# form C's own cases, (rows, table width, indices a row), as
# tests/test_torch_gather_probe.py's C_WIDTHS: indices below and above
# the width and not a multiple of 4 (the staged body's int path, the
# second a loop of index units), a row wider than the staged body takes
# (the direct body), an index 4 bytes past a 16-byte boundary, one row,
# and a width not a multiple of 4 under indices that are
C_CASES = {"j7": (40, 512, 7), "j1030": (40, 512, 1030),
           "wide": (3, 16387, 64), "idx_offset": (40, 512, 128),
           "n1": (1, 512, 512), "w130_j64": (40, 130, 64)}
GATHER_PARAMS = [(f, c) for f in range(4) for c in GATHER_CASES] + [
    (2, c) for c in C_CASES]


def _gather_inputs(case, form):
    """Form ``form``'s numpy (table, idx, expectation) in ``case``: the
    expectation is the form's numpy expression on the clamped indices."""
    if case in C_CASES:
        n, width, j = C_CASES[case]
        rng = np.random.default_rng(width + j)
        t = rng.standard_normal((n, width), dtype=np.float32)
        i = rng.integers(0, width, (n, j), dtype=np.int32)
    elif case == "probe":
        t, i = gp.probe_inputs()[form]
    elif case == "pool":
        t, i = gp.pool_inputs(scale=8)[form]
    else:
        width = int(case[5:]) if case.startswith("width") else 128
        rng = np.random.default_rng(form)
        t = rng.standard_normal((40 if form == 2 else 96, width),
                                dtype=np.float32)
        hi = width if form == 2 else 96
        shape = (40,) if form in (0, 3) else (40, width)
        i = rng.integers(0, hi, shape, dtype=np.int32)
        if case == "clamped":
            i.flat[::3] = -1
            i.flat[1::3] = hi
    hi = t.shape[1] if form == 2 else t.shape[0]
    return t, i, gp.FORMS[form][3](t, np.clip(i, 0, hi - 1))


@pytest.mark.cuda
@pytest.mark.parametrize("form,case", GATHER_PARAMS, ids=[
    f"{'ABCD'[f]}-{c}" for f, c in GATHER_PARAMS])
def test_gather_forms_bit_exact_on_cuda(cuda, form, case):
    """Each form's kernel, one launch counted, equal to its twin and to
    the numpy expression bit for bit (out-of-range indices: to the clamped
    expression only, the twins do not take them); form C also at
    :data:`C_CASES`, which take both its bodies and every vector path."""
    name, kernel, plain, _ = gp.FORMS[form]
    t, i, want = _gather_inputs(case, form)
    tt = torch.from_numpy(t).to(cuda)
    if case == "offset":
        base = torch.empty(t.size + 1, device=cuda)
        base[1:] = tt.reshape(-1)
        tt = base[1:].view(t.shape)
        assert tt.data_ptr() % 16 == 4
    it = torch.from_numpy(i).to(cuda)
    if case == "idx_offset":
        base = torch.empty(i.size + 1, dtype=torch.int32, device=cuda)
        base[1:] = it.reshape(-1)
        it = base[1:].view(i.shape)
        assert it.data_ptr() % 16 == 4
    before = dict(_lib.LAUNCHES)
    got = kernel(tt, it)
    assert {k: v - before[k] for k, v in _lib.LAUNCHES.items()
            if v != before[k]} == {gp.KEYS[form]: 1}
    if case != "clamped":
        assert torch.equal(got, plain(tt, it)), name
    np.testing.assert_array_equal(got.cpu().numpy(), want)


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
@pytest.mark.parametrize("field", [TSDF, OFUSION], ids=["tsdf", "ofusion"])
def test_icp_track_runs_every_iteration_on_cuda(cuda, field):
    """With a threshold no step falls below (0), no level breaks early:
    the kernel runs every iteration of every level, within the twin's
    tolerances (``chip_smoke.track_errors``), two launches bit-identical."""
    args = _track_args(cuda, field)
    iters = (10, 5, 4)
    got = icp._icp_track(*args, iters, 0.0)
    assert got[4].tolist() == list(iters)
    want = icp._icp_track_plain(*args, iters, 0.0, DIST_THRESHOLD,
                                NORMAL_THRESHOLD, TRACK_THRESHOLD)
    assert want[4].tolist() == list(iters)
    ok, e = chip_smoke.track_errors(torch, got[:4], want[:4])
    assert ok, e
    again = icp._icp_track(*args, iters, 0.0)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("field", [TSDF, OFUSION], ids=["tsdf", "ofusion"])
def test_icp_track_without_a_reference_on_cuda(cuda, field):
    """A reference with no valid pixel: every pixel rejected, the sums
    0-27 zero, each level's first step zero, so one iteration a level; the
    frame not tracked and its pose the input one; reduction, result codes
    and pose equal to the twin's."""
    args = list(_track_args(cuda, field))
    args[7] = torch.zeros_like(args[7])
    iters = (10, 5, 4)
    got = icp._icp_track(*args, iters, 1e-5)
    want = icp._icp_track_plain(*args, iters, 1e-5, DIST_THRESHOLD,
                                NORMAL_THRESHOLD, TRACK_THRESHOLD)
    assert not bool(got[1]) and not bool(want[1])
    assert not bool(got[2][:28].any())
    assert got[4].tolist() == want[4].tolist() == [1, 1, 1]
    assert torch.equal(got[0], args[0])
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, b)


def _reductions(n=32, seed=22):
    """``n`` f64[32] reductions of seeded SPD systems (J^T J of 40 rows of
    J, steps from 1e-7 to 1 in size, the Taylor branch of se3.exp among
    them), then one whose J^T J is not SPD."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n + 1):
        jac = rng.standard_normal((40, 6))
        err = rng.standard_normal(40) * 10.0 ** rng.uniform(-7, 0)
        a = jac.T @ jac
        red = np.zeros(32)
        red[0], red[1:7] = err @ err, jac.T @ err
        red[7:28] = [a[r, c] for r in range(6) for c in range(r, 6)]
        red[28:] = (40, 1, 2, 3)
        if i == n:
            red[7] = -1.0
        out.append(red)
    return out


@pytest.mark.cuda
def test_icp_update_matches_plain_bit_for_bit_on_cuda(cuda):
    """icp_update (the warp's lane-parallel solve, the step and
    check_pose) against its twin bit for bit on 32 seeded SPD reductions,
    and a non-SPD one, which solves to zeros and keeps the pose."""
    pose = se3.exp(torch.tensor([0.1, -0.2, 0.3, 0.05, -0.02, 0.01]))
    pose = pose.to(torch.float32).to(cuda)
    reds = _reductions()
    for i, red in enumerate(reds):
        red64 = torch.tensor(red, dtype=torch.float64, device=cuda)
        got = icp.icp_update(red64, pose, None, True, 1e-5, pose, (H, W))
        want = icp.icp_update_plain(red64, pose, None, True, 1e-5, pose,
                                    (H, W))
        for a, b in zip(got[0] + got[1], want[0] + want[1]):
            assert torch.equal(a, b), i
        if i == len(reds) - 1:
            assert torch.equal(got[0].pose, pose)


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


def _windows(width, n=4):
    return [(r * (width // n), width // n) for r in range(n)]


def _sharded_args(device, field=TSDF, levels=3):
    """``_track_sharded``'s leading arguments at the test orbit's frame 5
    (three pyramid levels: windows of 16, 8 and 4 columns at D = 4, 768,
    192 and 48 pixels, none a multiple of a CTA's 512 threads)."""
    _, state, k, depth = _frames(device, field=field)
    view = frame.frame_mats(k, state.raycast_pose).view
    _, v, n, ok = preprocess_and_pyramid(depth, k, levels, False, False)
    return (state.pose, view, v, n, ok, state.vertex, state.normal,
            state.valid)


@pytest.mark.cuda
@pytest.mark.parametrize("field", [TSDF, OFUSION], ids=["tsdf", "ofusion"])
def test_sharded_icp_modes_match_twins_on_cuda(cuda, field):
    """Mode A of the sharded step. K6's icp_reduce (one cluster launch)
    over each rank's column window of every level: its codes the full
    launch's columns and the twin's, bit for bit, its f64 sums the
    twin's to 1e-9 of the largest, none without a result map, two
    launches bit-identical. The fused mode (icp_reduce_step) against
    its twin at the first iteration of a frame, mid-level, before a
    level's first iteration and frozen (sums exactly zero): the carry's
    pose to 1e-6, reduction and done exactly, the sums to 1e-9; sums
    over the summed reduction or the carry refused. Then
    icp_update (the solve, freeze and check_pose) against its twin, and
    ``_track_sharded`` with a stand-in group that hands it the four
    ranks' sums: its pose to 1e-6 of the CPU's, one icp_reduce, one
    icp_reduce_step an iteration after that and one icp_update a frame.
    """
    from supereight_tpu_torch.tools import sharded_icp as si
    args = _sharded_args(cuda, field)
    pose, view, v, n, ok, ref = args[0], args[1], args[2], args[3], \
        args[4], args[5:]
    total = torch.zeros(32, dtype=torch.float64, device=cuda)
    for lvl in range(len(v)):
        lv = (v[lvl], n[lvl], ok[lvl], *ref, pose, view)
        full, _ = icp.icp_reduce(*lv)
        for x0, w in _windows(v[lvl].shape[1]):
            res, red = icp.icp_reduce64(*lv, x0=x0, width=w)
            res_p, red_p = icp.icp_reduce64_plain(*lv, x0=x0, width=w)
            assert torch.equal(res, full[:, x0:x0 + w])
            assert torch.equal(res, res_p)
            scale = float(red_p.abs().max())
            assert torch.allclose(red, red_p, rtol=0, atol=1e-9 * scale)
            none, again = icp.icp_reduce64(*lv, x0=x0, width=w,
                                           with_result=False)
            assert none is None and torch.equal(again, red)
            if lvl == 0:
                total += red
    level0 = (v[0], n[0], ok[0], *ref, view)
    win = dict(x0=W // 4, width=W // 4)
    zero = torch.zeros((), dtype=torch.bool, device=cuda)
    carry = icp.Carry(pose.clone(), total.to(torch.float32) * 0.5, zero)
    frozen = carry._replace(done=~zero)
    before = _lib.LAUNCHES["icp_reduce_step"]
    for c, first, next_first in ((None, True, False), (carry, False, False),
                                 (carry, False, True), (frozen, False,
                                                        False)):
        got = icp.icp_reduce_step(total, pose, c, first, next_first, 1e-5,
                                  *level0, **win)
        twice = icp.icp_reduce_step(total, pose, c, first, next_first, 1e-5,
                                    *level0, **win)
        want = icp.icp_reduce_step_plain(total, pose, c, first, next_first,
                                         1e-5, *level0, **win)
        assert torch.allclose(got[0].pose, want[0].pose, atol=1e-6, rtol=0)
        assert torch.equal(got[0].reduction, want[0].reduction)
        assert torch.equal(got[0].done, want[0].done)
        scale = float(want[1].abs().max())
        assert torch.allclose(got[1], want[1], rtol=0, atol=1e-9 * scale)
        assert torch.equal(got[1], twice[1])
        if c is frozen:
            assert not bool(got[1].any())
    assert _lib.LAUNCHES["icp_reduce_step"] == before + 8
    # sums written over the summed reduction or the carry race the CTAs
    # still reading them: refused before any launch
    buf = torch.empty(32, dtype=torch.float64, device=cuda)
    aliased = icp.Carry(torch.empty_like(pose), buf.view(torch.float32)[:32],
                        torch.empty_like(zero))
    for out, cout in ((total, None), (buf, aliased)):
        with pytest.raises(ValueError, match="out overlaps"):
            icp.icp_reduce_step(total, pose, carry, False, False, 1e-5,
                                *level0, **win, out=out, carry_out=cout)
    assert _lib.LAUNCHES["icp_reduce_step"] == before + 8
    before = _lib.LAUNCHES["icp_update"]
    carry = carry_p = None
    for it, first in enumerate((True, False, False)):
        last = it == 2
        got = icp.icp_update(total, pose if carry is None else carry.pose,
                             carry, first, 1e-5, pose if last else None,
                             (H, W))
        want = icp.icp_update_plain(total, pose if carry_p is None
                                    else carry_p.pose, carry_p, first, 1e-5,
                                    pose if last else None, (H, W))
        (carry, checked), (carry_p, checked_p) = got, want
        assert torch.allclose(carry.pose, carry_p.pose, atol=1e-6, rtol=0)
        assert torch.equal(carry.reduction, carry_p.reduction)
        assert torch.equal(carry.done, carry_p.done)
    assert torch.allclose(checked[0], checked_p[0], atol=1e-6, rtol=0)
    assert torch.equal(checked[1], checked_p[1])
    assert _lib.LAUNCHES["icp_update"] == before + 3

    iterations = (3, 2, 2)
    sums, _ = si.record(args, iterations, 1e-5)
    cpu = tuple(tuple(t.cpu() for t in a) if isinstance(a, tuple)
                else a.cpu() for a in args)
    _lib.reset_launches()
    got = si.replay(args, iterations, 1e-5, sums)
    counts = dict(_lib.LAUNCHES)
    want = si.replay(cpu, iterations, 1e-5, sums.cpu())
    assert torch.allclose(got[0].cpu(), want[0], atol=1e-6, rtol=0)
    assert bool(got[1]) == bool(want[1])
    assert {k: v for k, v in counts.items() if v} == {
        "icp_reduce": 1, "icp_reduce_step": 6, "icp_update": 1}


def test_sharded_kernels_tool_on_the_cpu(tmp_path, monkeypatch):
    """``tools/sharded_kernels``: without a card it exits 2; each of its
    side builds edits these sources, and a source its edit does not fit
    gives none; every side build has its part; it reads each launch of
    the named kernel from a chrome trace, and nothing else; its copies of
    a map for the allocation are its own, their touched buffers 16-byte
    aligned; it times a march on its window as the wrapper's launch."""
    from supereight_tpu_torch.tools import sharded_kernels as sk
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        assert sk.main([]) == 2
    for name in sk.SIDE:
        fname, text = sk.side_source(name, _lib.CSRC)
        assert text != (_lib.CSRC / fname).read_text()
    assert {sk.SIDE_PREFIX[n.split("_")[0]] for n in sk.SIDE} <= set(
        sk.PARTS) | {"bilateral", "gather"}
    assert "const int n_coarse = 0;" in sk.side_source(
        "alloc_no_extra", _lib.CSRC)[1]
    assert "if (total >= 0) return;" in sk.side_source(
        "halo_compaction_only", _lib.CSRC)[1]
    (tmp_path / "alloc.cu").write_text("const int n_coarse = 1;\n")
    assert sk.side_source("alloc_no_extra", tmp_path) is None
    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "void halo_pack_kernel(int)",
         "dur": 5.5},
        {"ph": "X", "cat": "Kernel", "name": "halo_pack_kernel", "dur": 6},
        {"ph": "X", "cat": "cuda_runtime", "name": "halo_pack_kernel",
         "dur": 9.0},
        {"ph": "X", "cat": "kernel", "name": "alloc_assign_kernel",
         "dur": 7.0},
        {"ph": "i", "cat": "kernel", "name": "halo_pack_kernel"}]}
    assert sk.launch_durations(trace, "halo_pack_kernel") == [5.5, 6.0]
    geom, state, _, _ = _frames("cpu", n=1)
    copies = sk.fresh(state.map, 3)
    copies[0].slot.fill_(7)
    copies[1].touched.fill_(True)
    assert not bool((copies[2].slot == 7).all())
    assert torch.equal(copies[2].touched, state.map.touched)
    assert all(c.touched.data_ptr() % 16 == 0 for c in copies)
    assert copies[0].data_x is state.map.data_x
    geom, state, k, depth = _frames("cpu", n=1, field=OFUSION)
    kpose = se3.matmul4(state.pose, se3.inverse_camera_matrix(k))
    args = (geom, depth, state.pose, kpose, MU["ofusion"])
    timed = []
    monkeypatch.setattr(sk, "kernel_us", lambda fn, kernel: (
        fn(), timed.append(kernel), (2.0, 1.0, 3.0))[-1])
    r = sk.march_times("t", sk.MARCHES["ofusion"], args,
                       dict(x0=16, width=17), {"touch_no_stores": None})
    assert (r["columns"], r["rays"], r["coarse_rays"]) == (17, 24 * 9,
                                                           6 * 3)
    assert r["whole"] == dict(us=2.0, fastest=1.0, slowest=3.0)
    assert r["touch_no_stores"] is None
    assert timed == ["alloc_touch_of_kernel"]


def test_sharded_icp_tool_on_the_cpu():
    """``tools/sharded_icp``: without a card it exits 2; its recorded sums
    replayed through ``_track_sharded`` (the stand-in group) give the
    pose of the updates run on them alone; its trace split drops a
    replay the trace shows in part and counts each level's launches."""
    from supereight_tpu_torch.tools import sharded_icp as si
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        assert si.main([]) == 2
    args = _sharded_args("cpu", levels=2)
    iterations = (3, 2)
    sums, frozen = si.record(args, iterations, 1e-5)
    assert sums.shape == (5, 32) and not frozen[0] and not frozen[2]
    got = si.replay(args, iterations, 1e-5, sums)
    pose, carry = args[0], None
    for i, first in enumerate((True, False, True, False, False)):
        carry, checked = icp.icp_update_plain(
            sums[i], pose if carry is None else carry.pose, carry, first,
            1e-5, pose if i == 4 else None, (H, W))
    assert torch.equal(got[0], checked[0]) and torch.equal(got[1],
                                                           checked[1])

    def ev(name, t, dur, cat="kernel"):
        return (name, cat, float(t), float(dur))

    def one(t0, parent):
        out, t = [], t0
        for i in range(5):
            out.append(ev("icp_reduce_kernel", t, 5.0 if i < 2 else 6.0))
            if parent:
                out.append(ev("reduce_kernel", t + 10, 3.0))
            out.append(ev("Memcpy DtoD", t + 20, 1.0, "gpu_memcpy"))
            if parent or i == 4:
                out.append(ev("icp_update_kernel", t + 30, 4.0))
            t += 50
        return out
    for parent in (True, False):
        events = one(0, parent)[3:] + one(10_000, parent) + one(
            20_000, parent)
        reps = si.split_replays(events, 5)
        assert len(reps) == 2
        s = si.summarize(reps, iterations, [False, True, False, False,
                                            True])
        lv0, lv1 = s["levels"]
        assert (lv0["iterations"], lv0["frozen"], lv1["frozen"]) == (3, 1, 1)
        assert lv1["reduce_us"] == 5.0 and lv0["reduce_us"] == 6.0
        assert lv0["other_us"] == (3.0 if parent else 0.0)
        assert lv0["update_us"] == 4.0
        assert s["frozen_us"] == 5.5
        assert s["launches"] == (15 if parent else 6)
        assert s["icp_us"] == 28.0 + (35.0 if parent else 4.0)


def test_track_icp_tool_on_the_cpu():
    """``tools/track_icp``: without a card it exits 2; its recorded
    inputs of a 2-frame bench orbit at test size have the shapes
    ``icp_track`` takes (pose, view, three pyramid levels, the reference
    at the finest level's size), and the wrapper takes them; every side
    build takes the early break out, and fits these sources but
    ``scatter`` (the parent's warp sum) and ``approx_exp`` (the parent's
    exponential, which here lives in ``common.cuh``)."""
    from supereight_tpu_torch.tools import bench
    from supereight_tpu_torch.tools import track_icp as ti
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        assert ti.main([]) == 2
    b = bench.config("tsdf", "cpu", size=64, dim=3.0, capacity=512,
                     frame_size=(80, 60), n_frames=2)
    args, iterations, thr = ti.capture(b)
    assert len(args) == 2 and iterations == ti.ITERATIONS and thr == 1e-5
    for a in args:
        pose, view, verts, norms, valids, rv, rn, ro = a
        assert pose.shape == view.shape == (4, 4)
        assert [tuple(v.shape) for v in verts] == [
            (60, 80, 3), (30, 40, 3), (15, 20, 3)]
        assert [tuple(v.shape) for v in norms] == [
            tuple(v.shape) for v in verts]
        assert [tuple(v.shape) for v in valids] == [
            (60, 80), (30, 40), (15, 20)]
        assert valids[0].dtype == ro.dtype == torch.bool
        assert rv.shape == rn.shape == (60, 80, 3) and ro.shape == (60, 80)
        out = icp._icp_track(*a, iterations, thr)
        assert out[3].shape == (60, 80) and len(out[4]) == 3
    assert ti.pixels(args[0]) == [4800, 1200, 300]
    text = (_lib.CSRC / "icp.cu").read_text()
    for name in ti.SPLIT:
        src = ti.split_source(name, text)
        assert (src is None) == (name in ("scatter", "approx_exp")), name
        if src is not None:
            assert "break;  // the level's early break" not in src
            assert (src == text.replace(ti._BREAK[1], "")) == (
                name == "nobreak")


@pytest.mark.cuda
@pytest.mark.parametrize("field", [TSDF, OFUSION], ids=["tsdf", "ofusion"])
def test_sharded_alloc_modes_match_twins_on_cuda(cuda, field):
    """Mode B: K5's marches over a column window (bit-equal to the twin;
    the four windows' union equals the whole frame's grids) and
    alloc_assign with the owner mask against its twin, exactly; the
    kernel, which computes each cell's owner, refuses an owner grid."""
    from supereight_tpu_torch.parallel.dist_step import owner_grid
    geom, state, k, depth = _frames(cuda, field=field)
    b = geom.blocks_per_side
    mu = MU[field.name]
    pose = state.pose
    kpose = se3.matmul4(pose, se3.inverse_camera_matrix(k))
    march = alloc.touched_mask if field is TSDF else alloc.touched_masks_of
    whole = touched_buffer(b, cuda)
    march(geom, depth, pose, kpose, mu, out=whole)
    union = touched_buffer(b, cuda)
    name = "alloc_touch_cols" if field is TSDF else "alloc_touch_of_cols"
    before = _lib.LAUNCHES[name]
    for x0, w in _windows(W):
        got, want = touched_buffer(b, cuda), touched_buffer(b, cuda)
        march(geom, depth, pose, kpose, mu, out=got, x0=x0, width=w)
        plain = (alloc.touched_mask_plain(geom, depth[:, x0:x0 + w], pose,
                                          kpose, mu, x0),) \
            if field is TSDF else alloc.touched_masks_of_plain(
                geom, depth[:, x0:x0 + w], pose, kpose, mu, None, x0)
        for g, p in zip(alloc._grids(geom, got, cuda, len(plain)), plain):
            assert torch.equal(g, p)
        union |= got
    assert torch.equal(union, whole)
    assert _lib.LAUNCHES[name] == before + 4

    owner, grid = alloc.Owners(4), owner_grid(geom, 4, device=cuda)
    grids = alloc._grids(geom, whole, cuda, 1 if field is TSDF else 3)
    with pytest.raises(TypeError, match="Owners"):
        alloc.alloc_assign(geom, chip_smoke.clone_map(state.map),
                           grids[0].clone(), owner=grid, rank=0)
    for rank in range(4):
        ka, kb = chip_smoke.clone_map(state.map), chip_smoke.clone_map(
            state.map)
        ta, tb = whole.clone(), whole.clone()
        ga = alloc._grids(geom, ta, cuda, len(grids))
        gb = alloc._grids(geom, tb, cuda, len(grids))
        oa = alloc.alloc_assign(geom, ka, ga[0], None, None, ga[1:], owner,
                                rank)
        ob = alloc.alloc_assign_plain(geom, kb, gb[0], None, None, gb[1:],
                                      owner, rank)
        assert int(oa) == int(ob)
        for x, y in zip(ka, kb):
            for u, v in zip(x if isinstance(x, tuple) else (x,),
                            y if isinstance(y, tuple) else (y,)):
                assert torch.equal(u, v)
        owned = (ka.slot >= 0) & (state.map.slot < 0)
        assert bool((grid[owned] == rank).all())


# column windows (x0, width) of the test frame (W = 64): the sharded
# step's four ranks', and three that start or end off a warp's 32 rays
# and a CTA's 256: x0 = 1 and 37 columns, 2 columns, the last 18
MARCH_WINDOWS = _windows(W) + [(1, 37), (30, 2), (W - 18, 18)]


@pytest.mark.cuda
@pytest.mark.parametrize("window", MARCH_WINDOWS,
                         ids=[f"x{x0}w{w}" for x0, w in MARCH_WINDOWS])
@pytest.mark.parametrize("field", [TSDF, OFUSION], ids=["tsdf", "ofusion"])
def test_windowed_march_bit_equal_on_cuda(cuda, field, window):
    """K5's march over a column window bit for bit against its twin on
    the test orbit's frame 5, every grid; one launch of
    ``alloc_touch_cols[_of]`` a call. (A window from an odd column
    samples other pixels than the whole frame, as JAX's x_offset does.)"""
    geom, state, k, depth = _frames(cuda, field=field)
    b = geom.blocks_per_side
    mu = MU[field.name]
    pose = state.pose
    kpose = se3.matmul4(pose, se3.inverse_camera_matrix(k))
    x0, w = window
    march = alloc.touched_mask if field is TSDF else alloc.touched_masks_of
    name = "alloc_touch_cols" if field is TSDF else "alloc_touch_of_cols"
    got = touched_buffer(b, cuda)
    before = _lib.LAUNCHES[name]
    march(geom, depth, pose, kpose, mu, out=got, x0=x0, width=w)
    assert _lib.LAUNCHES[name] == before + 1
    plain = (alloc.touched_mask_plain(geom, depth[:, x0:x0 + w], pose,
                                      kpose, mu, x0),) \
        if field is TSDF else alloc.touched_masks_of_plain(
            geom, depth[:, x0:x0 + w], pose, kpose, mu, None, x0)
    for g, p in zip(alloc._grids(geom, got, cuda, len(plain)), plain):
        assert torch.equal(g, p)
    assert bool(got.any())


@pytest.mark.cuda
@pytest.mark.parametrize("frustum", [True, False], ids=["frustum", "all"])
def test_halo_pack_matches_twin_on_cuda(cuda, frustum):
    """Mode C: halo_pack against its twin: counts and cell ids exactly, the
    flagged rows' bricks bit for bit; a budget below the flagged count
    overflows."""
    from supereight_tpu_torch.kernels import frame as kframe
    from supereight_tpu_torch.kernels import halo
    geom, state, k, depth = _frames(cuda)
    mats = kframe.frame_mats(k, state.pose)
    n = int(state.map.n_blocks)
    for budget in (geom.capacity, max(n // 2, 1)):
        got, cnt = halo.halo_pack(geom, state.map, mats.t_cw, mats.kmat,
                                  (W, H), budget, 0.3, frustum)
        want, cnt_p = halo.halo_pack_plain(geom, state.map, mats.t_cw,
                                           mats.kmat, (W, H), budget, 0.3,
                                           frustum)
        assert torch.equal(cnt, cnt_p)
        filled = int(cnt[0])
        assert filled > 0
        assert torch.equal(halo.cells_of(got, budget),
                           halo.cells_of(want, budget))
        for rows in (slice(0, filled), slice(budget, budget + filled)):
            assert torch.equal(got[rows], want[rows])
        if budget < n and not frustum:
            assert int(cnt[1]) == n - budget


def _random_alloc_map(dev, field, seed, capacity):
    """A 512^3 map (64 blocks a side, the bench's) whose blocks come from a
    random touched grid through the twin, and the next frame's touched
    buffer: runs of set cells along z and scattered ones, over allocated
    and new cells alike, and (OFusion) random level-1 and level-2
    octants."""
    from supereight_tpu_torch.core.map import touched_grids
    geom = MapGeometry(size=512, dim=4.8, capacity=capacity)
    b = geom.blocks_per_side
    rng = np.random.default_rng(seed)

    def grid(p):
        g = rng.random((b, b, b)) < p
        for _ in range(40):  # runs of a z-row
            x, y, z = rng.integers(0, b, 3)
            g[x, y, z:z + rng.integers(1, 40)] = True
        return torch.from_numpy(g).to(dev)

    m = make_map(geom, field, dev)
    g0 = grid(0.01)
    alloc.alloc_assign_plain(geom, m, g0.clone())
    buf = touched_buffer(b, dev)
    views = touched_grids(buf, b, 1 if field is TSDF else 3)
    views[0].copy_(grid(0.02) | (g0 & torch.from_numpy(
        rng.random((b, b, b)) < 0.5).to(dev)))
    for lvl, v in enumerate(views[1:], start=1):
        v.copy_(torch.from_numpy(rng.random(v.shape) < 0.01 * lvl).to(dev))
    return geom, m, buf


@pytest.mark.cuda
@pytest.mark.parametrize("field", [TSDF, OFUSION], ids=["tsdf", "ofusion"])
@pytest.mark.parametrize("owned", [False, True], ids=["single", "owned"])
def test_alloc_assign_cases_match_twin_on_cuda(cuda, field, owned):
    """alloc_assign (and alloc_assign_owned, for every rank of 4) against
    its twin at the bench's 64 blocks a side, where a thread reads 32
    cells: ``when`` false, a budget below the new cells and a pool one
    block from full (alloc_overflow > 0), OFusion's coarse grids; slot,
    block_coord, active, n_blocks, mip_alloc and alloc_overflow exactly,
    every grid all zero on return."""
    from supereight_tpu_torch.core.map import touched_grids
    levels = 1 if field is TSDF else 3
    seen_overflow = False
    for seed, capacity, budget, when in ((1, 36864, None, True),
                                         (2, 36864, None, False),
                                         (3, 36864, 37, True),
                                         (4, 9000, None, True)):
        geom, m, buf = _random_alloc_map(cuda, field, seed, capacity)
        b = geom.blocks_per_side
        if capacity < 36864:  # one block from full
            geom = MapGeometry(size=512, dim=4.8,
                               capacity=int(m.n_blocks) + 1)
            m = m._replace(**{n: getattr(m, n)[:geom.capacity] for n in
                              ("data_x", "data_y", "block_coord",
                               "active")})
        w = torch.full((), when, dtype=torch.bool, device=cuda)
        for rank in range(4) if owned else (0,):
            kw = dict(owner=alloc.Owners(4), rank=rank) if owned else {}
            ka, kb = clone_map(m), clone_map(m)
            ta, tb = buf.clone(), buf.clone()
            ga, gb = (touched_grids(t, b, levels) for t in (ta, tb))
            oa = alloc.alloc_assign(geom, ka, ga[0], w, budget, ga[1:], **kw)
            ob = alloc.alloc_assign_plain(geom, kb, gb[0], w, budget, gb[1:],
                                          **kw)
            assert int(oa) == int(ob)
            seen_overflow |= int(oa) > 0
            for x, y in zip(ka, kb):
                for u, v in zip(x if isinstance(x, tuple) else (x,),
                                y if isinstance(y, tuple) else (y,)):
                    assert torch.equal(u, v)
            assert not ta.any() and not tb.any()
            if not when:
                assert torch.equal(ka.slot, m.slot)
            elif budget is None and capacity == 36864:
                assert int(ka.n_blocks) > int(m.n_blocks)
    assert seen_overflow


@pytest.mark.cuda
@pytest.mark.parametrize("frustum", [True, False], ids=["frustum", "all"])
def test_halo_pack_cases_match_twin_on_cuda(cuda, frustum):
    """halo_pack against its twin on a random 512^3 map of 3,000 blocks
    (more rows than the card has SMs, so every CTA of the launch copies
    several), under a budget that holds them, one that overflows and on
    an empty map (n_blocks = 0): counts and cell ids exactly, the sent
    rows bit for bit, the rows past them left as they were."""
    from supereight_tpu_torch.kernels import frame as kframe
    from supereight_tpu_torch.kernels import halo
    geom = MapGeometry(size=512, dim=4.8, capacity=4096)
    b = geom.blocks_per_side
    rng = np.random.default_rng(5)
    m = make_map(geom, TSDF, cuda)
    cells = rng.choice(b ** 3, 3000, replace=False)
    coords = np.stack([cells // (b * b), cells // b % b, cells % b], -1)
    m.block_coord[:3000] = torch.from_numpy(coords.astype(np.int32))
    m.n_blocks.fill_(3000)
    m.data_x.copy_(torch.from_numpy(rng.standard_normal(
        m.data_x.shape).astype(np.float32)))
    m.data_y.copy_(torch.from_numpy(rng.standard_normal(
        m.data_y.shape).astype(np.float32)))
    pose = torch.tensor([[1, 0, 0, 2.4], [0, 1, 0, 2.4], [0, 0, 1, 0.5],
                         [0, 0, 0, 1]], dtype=torch.float32, device=cuda)
    mats = kframe.frame_mats(torch.tensor(K, device=cuda), pose)
    empty = m._replace(n_blocks=torch.zeros_like(m.n_blocks))
    for mm, budget in ((m, 4096), (m, 700), (empty, 512)):
        got, cnt = halo.halo_pack(geom, mm, mats.t_cw, mats.kmat, (W, H),
                                  budget, 0.3, frustum)
        want, cnt_p = halo.halo_pack_plain(geom, mm, mats.t_cw, mats.kmat,
                                           (W, H), budget, 0.3, frustum)
        assert torch.equal(cnt, cnt_p)
        filled = int(cnt[0])
        assert torch.equal(halo.cells_of(got, budget),
                           halo.cells_of(want, budget))
        for rows in (slice(0, filled), slice(budget, budget + filled)):
            assert torch.equal(got[rows], want[rows])
        if mm is empty:
            assert cnt.tolist() == [0, 0]
            assert bool((halo.cells_of(got, budget) == b ** 3).all())
        elif budget == 700:
            assert filled == 700 and int(cnt[1]) > 0
        else:
            assert filled > 132 and int(cnt[1]) == 0
            if not frustum:
                assert filled == 3000


@pytest.mark.cuda
@pytest.mark.parametrize("field", [TSDF, OFUSION], ids=["tsdf", "ofusion"])
def test_raycast_window_matches_whole_image_on_cuda(cuda, field):
    """Mode D: K1 over a column window gives the whole image's launch at
    those columns bit for bit (the window at x0 = 0, w_out = w is that
    launch), and matches its twin as the whole launch does."""
    geom, state, k, depth = _frames(cuda, field=field)
    m = state.map
    mu = MU[field.name]
    nv = nav.nav_grid(geom, m, field)
    view = se3.matmul4(state.pose, se3.inverse_camera_matrix(k))
    whole = kray.raycast_rays(geom, m, field, nv, view, depth, k, mu, (W, H))
    name = "raycast_cols_of" if field is OFUSION else "raycast_cols"
    before = _lib.LAUNCHES[name]
    for x0, w in _windows(W):
        got = kray.raycast_rays(geom, m, field, nv, view, depth, k, mu,
                                (W, H), x0=x0, width=w)
        for a, b in zip(got[:3], whole[:3]):
            assert torch.equal(a, b[:, x0:x0 + w])
        ref = kray.raycast_plain(geom, field, m.data_x, m.data_y, nv, view,
                                 depth, k, mu, (W, H), x0=x0, width=w)
        both = got.valid & ref.valid
        assert (got.valid == ref.valid).float().mean() >= 0.999
        assert torch.allclose(got.vertex[both], ref.vertex[both], atol=1e-4,
                              rtol=0)
    assert _lib.LAUNCHES[name] == before + 4


@pytest.mark.cuda
def test_device_monitor_on_cuda(cuda):
    """telemetry.DeviceMonitor on the card: the peak is the allocator's
    max_memory_allocated and the limit the card's memory."""
    from supereight_tpu_torch.utils.telemetry import DeviceMonitor
    torch.cuda.reset_peak_memory_stats(cuda)
    x = torch.empty(1 << 22, dtype=torch.uint8, device=cuda)
    del x
    got = {k: v[-1] for k, v in DeviceMonitor().sample().series.items()}
    i = cuda.index
    assert got[f"dev{i}.peak_bytes_in_use"] == \
        torch.cuda.max_memory_allocated(cuda) >= 1 << 22
    assert got[f"dev{i}.bytes_limit"] == \
        torch.cuda.get_device_properties(cuda).total_memory
    assert 0 <= got[f"dev{i}.bytes_in_use"] \
        < got[f"dev{i}.peak_bytes_in_use"]


@pytest.mark.cuda
@pytest.mark.parametrize("field", [TSDF, OFUSION], ids=["tsdf", "ofusion"])
def test_debug_dumps_and_mesh_on_cuda_equal_cpu(cuda, field, tmp_path):
    """A map built on the CPU and copied to the card dumps the same bytes
    from either device: the field slice (one download), the block list
    and the mesh through the native writer."""
    from supereight_tpu_torch.core.map import MapState
    from supereight_tpu_torch.io import debug_io, meshing
    geom, state, _, _ = _frames("cpu", n=2, field=field)
    cpu = state.map
    card = MapState(*(tuple(t.to(cuda) for t in v) if isinstance(v, tuple)
                      else v.to(cuda) for v in cpu))
    before = dict(meshing.WRITES)
    for tag, m in (("cpu", cpu), ("cuda", card)):
        debug_io.save_3d_slice(str(tmp_path / f"{tag}.slice"), geom, m,
                               field, (16, 16, 16), (48, 40, 36),
                               select=lambda x, y: y)
        debug_io.save_block_list(str(tmp_path / f"{tag}.blocks"), geom, m)
        meshing.write_obj(str(tmp_path / f"{tag}.obj"),
                          meshing.marching_cubes(geom, m))
    for ext in ("slice", "blocks", "obj"):
        assert (tmp_path / f"cpu.{ext}").read_bytes() == \
            (tmp_path / f"cuda.{ext}").read_bytes(), ext
    assert meshing.WRITES == dict(before, native=before["native"] + 2)


# K1 on a grazing view: along the room's far wall (z = 1.85 m) at about
# 1.4 degrees, whose rays crawl at the floor past the 16 steps after which
# it rises (tests/test_torch_raycast.py holds the twin to JAX there)
GRAZE_EYE, GRAZE_TARGET = (1.8, 1.2, 1.80), (0.2, 1.2, 1.84)
NOISE_OPTIONS = chip_smoke.NOISE_OPTIONS


def _noisy_frames(device, n=8):
    """The test orbit with frame i noised as add_depth_noise(d, 0.002,
    seed=i), through the frame step with the noise+levers options:
    (geometry, state)."""
    depths, poses = synthetic.orbit_sequence(
        n, K, width=W, height=H, radius=0.8, center=(1.0,) * 3,
        sphere_radius=0.3, angle_span=0.3, room=((0.15,) * 3, (1.85,) * 3))
    geom = MapGeometry(size=64, dim=2.0, capacity=1024)
    k = torch.tensor(K).to(device)
    state = step.init_frame_state(geom, TSDF, (W, H), poses[0], device)
    for i in range(n):
        d = synthetic.add_depth_noise(depths[i], 0.002, seed=i)
        state, aux = step.frame_step(
            geom, TSDF, state, torch.from_numpy(d).to(device), k, i,
            frame_size=(W, H), iterations=(3, 2), mu=MU["tsdf"],
            icp_threshold=1e-5, neg_y=False, integration_rate=1,
            budget=1024, **NOISE_OPTIONS)
    return geom, state


def hit_cells(geom, vertex, valid):
    """The nav-grid cells of the voxels at floor(vertex / voxel) of the
    hits (the gate's voxels), clamped into the map."""
    v = torch.floor(vertex[valid] * geom.inv_voxel_size).to(torch.int64)
    v = v.clamp(0, geom.size - 1) >> 3
    b = geom.blocks_per_side
    return (v[:, 0] * b + v[:, 1]) * b + v[:, 2]


def _grazing_view(k, device):
    pose = synthetic.look_at(np.array(GRAZE_EYE), np.array(GRAZE_TARGET))
    return se3.matmul4(torch.from_numpy(pose.astype(np.float32)).to(device),
                       se3.inverse_camera_matrix(k))


@pytest.mark.cuda
def test_raycast_on_a_grazing_view_bit_equal_on_cuda(cuda):
    """Every TSDF K1 instance on the noisy map from the grazing view,
    bit for bit against its twin (vertex, normal, hit mask, ray_overflow):
    primed by a zero depth (the march from the near plane), gated at the
    options' weight and not, over the whole image and a column window, and
    unprimed; some ray takes more than 16 steps at the crawl floor and
    some more than 5 jumps. Where a hit voxel's nav entry is >= 0 it is
    the slot grid's entry (the gated instance reads the weight through
    it)."""
    geom, state = _noisy_frames(cuda)
    k = torch.tensor(K).to(cuda)
    m, field, mu = state.map, TSDF, MU["tsdf"]
    view = _grazing_view(k, cuda)
    zero = torch.zeros((H, W), device=cuda)
    nv = nav.nav_grid(geom, m, field)
    weight = NOISE_OPTIONS["min_ref_weight"]
    cases = {"raycast": dict(depth=zero, k=k),
             "raycast_gated": dict(depth=zero, k=k, min_ref_weight=weight),
             "raycast_cols": dict(depth=zero, k=k, x0=16, width=24),
             "raycast_cold": dict(depth=None, k=None)}
    for name, kw in cases.items():
        before = _lib.LAUNCHES[name]
        got = kray.raycast_rays(geom, m, field, nv, view, mu=mu,
                                frame_size=(W, H), **kw)
        assert _lib.LAUNCHES[name] == before + 1
        plain_kw = dict(kw)
        if "min_ref_weight" in kw:
            plain_kw["slot"] = m.slot
        want, probes = kray.raycast_plain(
            geom, field, m.data_x, m.data_y, nv, view, mu=mu,
            frame_size=(W, H), with_probes=True, **plain_kw)
        for a, b in zip(got[:4], want[:4]):
            assert torch.equal(a, b), name
        assert int(got.valid.sum()) > 0, name
        if name == "raycast":
            assert int(probes.crawl.max()) > 16
            assert int(probes.jump.max()) > 5
            cells = hit_cells(geom, got.vertex, got.valid)
            listed = nv[cells] >= 0
            assert int(listed.sum()) > 0
            assert torch.equal(nv[cells][listed],
                               m.slot.reshape(-1)[cells][listed])
    torch.cuda.synchronize()
    assert not any(bool(v.any()) for v in kray._SCRATCH.values())


# sizes that are not multiples of the median's warp tile (28 or 30 columns
# by 16 rows), 1 and 2 pixels wide or high, and the bench frame's
MEDIAN_SIZES = [(1, 1), (1, 2), (2, 1), (7, 1), (9, 2), (2, 33), (17, 29),
                (33, 57), (16, 28), (239, 319), (240, 320)]


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.parametrize("size", MEDIAN_SIZES,
                         ids=[f"{h}x{w}" for h, w in MEDIAN_SIZES])
def test_median_filters_bit_equal_on_cuda(cuda, size, passes):
    """K7's median (one pass) and median2 bit for bit against the twin:
    positive depths, then a sixth of the pixels 0, then also runs of 0
    along the warp tiles' edges (columns 26-31, rows 14-17) and the first
    column; one launch counted a call."""
    h, w = size
    rng = np.random.default_rng(h * 1000 + w)
    name = "median" if passes == 1 else "median2"
    for trial in range(3):
        d = (rng.random((h, w)) * 3 + 0.5).astype(np.float32)
        if trial:
            d[rng.random((h, w)) < 1 / 6] = 0.0
        if trial == 2:
            d[:, 26:32] = 0.0
            d[14:18, :] = 0.0
            d[:, 0] = 0.0
        dt = torch.from_numpy(d).to(cuda)
        before = _lib.LAUNCHES[name]
        got = preprocess.median_filter3(dt, passes)
        assert _lib.LAUNCHES[name] == before + 1
        assert torch.equal(got, preprocess.median_filter3_plain(dt, passes))


# the bilateral filter's sizes (w, h): 1 pixel, below a tile's 28 output
# columns and 22 rows, not multiples of them, and the class pipeline's
# -c 1 frame
BILATERAL_SIZES = [(1, 1), (5, 3), (33, 17), (161, 119), (640, 480)]


@pytest.mark.cuda
@pytest.mark.parametrize("size", BILATERAL_SIZES,
                         ids=[f"{w}x{h}" for w, h in BILATERAL_SIZES])
def test_bilateral_matches_twin_on_cuda(cuda, size):
    """K7's bilateral filter against its twin to 1e-5 m (CUDA's expf
    against torch's exp of a reciprocal product) on seeded depths with a
    tenth of the pixels 0; one ``bilateral`` launch a call."""
    w, h = size
    rng = np.random.default_rng(w * 1000 + h)
    d = (rng.random((h, w)) * 3 + 0.5).astype(np.float32)
    d[rng.random((h, w)) < 0.1] = 0.0
    dt = torch.from_numpy(d).to(cuda)
    before = _lib.LAUNCHES["bilateral"]
    got = preprocess.bilateral_filter(dt)
    assert _lib.LAUNCHES["bilateral"] == before + 1
    assert torch.allclose(got, preprocess.bilateral_filter_plain(dt),
                          atol=1e-5, rtol=0)
    assert bool((got[dt == 0] == 0).all())


def _render_cases(cuda, field):
    """K10's inputs on the card: ``chip_smoke.render_edges`` (the shading
    under the pose's light and a given one), then frame 5 of a small map:
    its depth, the tracking step's result codes, and the state's raycast
    maps shaded from its raycast pose. (kernel name, args) pairs."""
    e = {k: torch.from_numpy(v).to(cuda)
         for k, v in chip_smoke.render_edges(np).items()}
    geom, state, k, depth = _frames(cuda, field=field)
    _, v, n, ok = preprocess_and_pyramid(depth, k, 3, False, False)
    view = se3.matmul4(se3.camera_matrix(k), se3.inverse(state.raycast_pose))
    result = icp.icp_track(state.pose, view, v, n, ok, state.vertex,
                           state.normal, state.valid, (10, 5, 4), 1e-5)[3]
    maps = (state.vertex, state.normal, state.valid, state.raycast_pose)
    edges = (e["vertex"], e["normal"], e["valid"], e["pose"])
    return [("render_depth", (e["depth"],)), ("render_depth", (depth,)),
            ("render_track", (e["track"],)), ("render_track", (result,)),
            ("render_volume", edges), ("render_volume", edges + (e["light"],)),
            ("render_volume", maps)]


@pytest.mark.cuda
@pytest.mark.parametrize("field", [TSDF, OFUSION], ids=["tsdf", "ofusion"])
def test_render_matches_twins_on_cuda(cuda, field):
    """K10 against its twins bit for bit, on the edge inputs and on a small
    map's depth, result codes and raycast maps; one launch a call."""
    for name, args in _render_cases(cuda, field):
        before = _lib.LAUNCHES[name]
        got = getattr(render, name)(*args)
        assert _lib.LAUNCHES[name] == before + 1
        want = getattr(render, name + "_plain")(*args)
        assert got.dtype == torch.uint8 and got.is_contiguous()
        assert torch.equal(got, want), (name, int((got != want).sum()))
    assert bool((got[..., 0] > 0).any())  # the map's shading lit pixels


@pytest.mark.cuda
@pytest.mark.parametrize("field", [TSDF, OFUSION], ids=["tsdf", "ofusion"])
def test_render_views_matches_twins_on_cuda(cuda, field):
    """K10's render_views against its twin bit for bit, and each quadrant
    against the single launches, on the edge inputs at one shape (the
    pose's light and a given one) and on a small map's depth, result
    codes and raycast maps; one launch a call."""
    e = {k: torch.from_numpy(v).to(cuda)
         for k, v in chip_smoke.render_view_edges(np).items()}
    cases = dict(_render_cases(cuda, field))
    edges = (e["depth"], e["track"], e["vertex"], e["normal"], e["valid"],
             e["pose"])
    for args, light in ((edges, None), (edges, e["light"]),
                        (cases["render_depth"] + cases["render_track"]
                         + cases["render_volume"], None)):
        before = _lib.LAUNCHES["render_views"]
        got = render.render_views(*args, light)
        assert _lib.LAUNCHES["render_views"] == before + 1
        want = render.render_views_plain(*args, light)
        assert got.dtype == torch.uint8 and got.is_contiguous()
        assert torch.equal(got, want), int((got != want).sum())
        h, w = args[0].shape
        assert torch.equal(got[:h, :w], torch.zeros_like(got[:h, :w]))
        assert torch.equal(got[:h, w:], render.render_depth(args[0]))
        assert torch.equal(got[h:, :w], render.render_track(args[1]))
        assert torch.equal(got[h:, w:],
                           render.render_volume(*args[2:6], light))
    assert bool((got[h:, w:, 0] > 0).any())  # the map's shading lit pixels
    with pytest.raises(ValueError, match="shape"):
        render.render_views(e["depth"][:-1], *edges[1:])
    with pytest.raises(TypeError):
        render.render_views(e["depth"], e["track"].long(), *edges[2:])


@pytest.mark.cuda
def test_render_refuses_what_the_kernel_does_not_take_on_cuda(cuda):
    """A non-contiguous vertex map, a wrong dtype or shape raises before a
    launch; no silent copy."""
    e = {k: torch.from_numpy(v).to(cuda)
         for k, v in chip_smoke.render_edges(np).items()}
    before = dict(_lib.LAUNCHES)
    v = e["vertex"].transpose(0, 1).contiguous().transpose(0, 1)
    assert not v.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        render.render_volume(v, e["normal"], e["valid"], e["pose"])
    with pytest.raises(ValueError, match="shape"):
        render.render_volume(e["vertex"], e["normal"][:-1], e["valid"],
                             e["pose"])
    with pytest.raises(TypeError):
        render.render_volume(e["vertex"], e["normal"], e["valid"].int(),
                             e["pose"])
    with pytest.raises(TypeError):
        render.render_depth(e["depth"].double())
    with pytest.raises(TypeError):
        render.render_track(e["track"].long())
    with pytest.raises(ValueError, match="contiguous"):
        render.render_depth(e["depth"].t())
    assert _lib.LAUNCHES == before


def test_noise_kernels_tool_on_the_cpu(tmp_path):
    """``tools/noise_kernels``: without a card it exits 2; its noisy loop
    is frames 0, 1, ... of the 250-frame loop with range noise, in mm as
    the .raw holds them; its probe statistics and probe-bound line on the
    test orbit's gated raycast (a timer that counts its calls): the
    longest ray's kinds sum to its probes, one timed launch a bound; the
    bilateral filter's row: its size, zeros, error against the twin and
    the digest of its output."""
    from supereight_tpu_torch.io.dataset import RawDepthReader
    from supereight_tpu_torch.tools import noise_kernels as nk
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        assert nk.main([]) == 2
    raw = str(tmp_path / "noisy.raw")
    nk.render_noisy_loop(raw, frames=2, workers=2)
    for i in range(2):
        d, _ = synthetic.loop_frame(i, nk.LOOP_FRAMES, nk.LOOP_K,
                                    noise_factor=nk.NOISE_FACTOR)
        got = RawDepthReader(raw).read_frame(i)[0]
        np.testing.assert_array_equal(
            got, np.round(d * 1000.0).astype(np.uint16))
    assert len(open(raw + ".gt.txt").read().splitlines()) == 2
    geom, state, k, depth = _frames("cpu", n=3)
    view = se3.matmul4(state.pose, se3.inverse_camera_matrix(k))
    inp = nk.GateInputs(geom, TSDF, state.map, nav.nav_grid(geom, state.map,
                                                           TSDF),
                        view, depth, k, MU["tsdf"], (W, H), 2)
    calls = []
    out = nk.measure(inp, lambda fn: (fn(), calls.append(1), 1.0)[-1])
    st = out["probes"]
    assert st["p50"] <= st["p90"] <= st["p99"] <= st["max"] > 0
    assert sum(st["longest_split"][k] for k in ("known", "crawl", "jump")) \
        == st["max"]
    assert out["line"]["bounds"][-1] == st["max"]
    assert len(calls) == 3 + len(out["line"]["bounds"])
    assert out["hits"] > 0 and out["overflow"] == 0
    d = depth[:19, :23].clone()
    d[3:5] = 0.0
    bil = nk.bilateral({"crop": d}, timer=lambda fn: (fn(), (2.0, 1.0,
                                                             3.0))[-1])
    assert bil["crop"]["size"] == [23, 19] and bil["crop"]["zeros"] == 46
    assert bil["crop"]["whole"] == dict(
        us=2.0, fastest=1.0, slowest=3.0, max_err=0.0,
        sha256=nk.digest(preprocess.bilateral_filter_plain(d)))
