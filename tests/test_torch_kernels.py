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

from supereight_tpu_torch.core import se3
from supereight_tpu_torch.core.map import MapGeometry, make_map
from supereight_tpu_torch.fields import OFUSION, TSDF
from supereight_tpu_torch.io import synthetic
from supereight_tpu_torch.constants import E_DELTA
from supereight_tpu_torch.kernels import _lib, alloc, icp, integrate, nav, \
    node, preprocess, raycast as kray
from supereight_tpu_torch.kernels import gather_probe as gp
from supereight_tpu_torch.ops import integration, raycast
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
    half = preprocess.half_sample(depth, E_DELTA * 3.0)
    assert torch.equal(half, preprocess.half_sample_plain(depth,
                                                          E_DELTA * 3.0))
    for a, b in zip(preprocess.vertex_normal(half, k, 1, True),
                    preprocess.vertex_normal_plain(half, k, 1, True)):
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
                           torch.zeros((4, 4), device="meta"), p,
                           torch.ones(4, device="meta"), 0.1)
    with pytest.raises(ValueError, match="unsupported device"):
        alloc.touched_masks_of(MapGeometry(64, 2.0, 16),
                               torch.zeros((4, 4), device="meta"), p,
                               torch.ones(4, device="meta"), 0.008)
    geom = MapGeometry(64, 2.0, 16)
    with pytest.raises(ValueError, match="unsupported device"):
        nav.nav_grid(geom, make_map(geom, OFUSION, "meta"), OFUSION)
    d = torch.zeros((4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        node.node_pass(geom, make_map(geom, TSDF, "meta"), TSDF, d, p, p, 0.1,
                       16)
    with pytest.raises(ValueError, match="unsupported device"):
        preprocess.half_sample(d, 0.3)
    with pytest.raises(ValueError, match="unsupported device"):
        preprocess.vertex_normal(d, torch.ones(4, device="meta"), 0, False)
    with pytest.raises(ValueError, match="unsupported device"):
        gp.take_rows_staged(torch.zeros((4, 4), device="meta"),
                            torch.zeros(2, dtype=torch.int32, device="meta"))


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
            "nav.cu", "preprocess.cu", "gather_probe.cu", "common.cuh",
            "fields.cuh"} <= names
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
    prime = raycast.prime_from_depth(depth, k)
    got = kray.raycast_rays(geom, m, field, nv, view, prime, mu, (W, H))
    ref = kray.raycast_plain(geom, field, m.data_x, m.data_y, nv, view,
                             prime, mu, (W, H))
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

    kpose = se3.matmul4(pose, se3.inverse_camera_matrix(k))
    if field is TSDF:
        assert torch.equal(alloc.touched_mask(geom, depth, pose, k, mu),
                           alloc.touched_mask_plain(geom, depth, pose, kpose,
                                                    mu))
    else:
        for a, b in zip(alloc.touched_masks_of(geom, depth, pose, k, mu),
                        alloc.touched_masks_of_plain(geom, depth, pose,
                                                     kpose, mu)):
            assert torch.equal(a, b)

    t_cw, kmat = se3.inverse(pose), se3.camera_matrix(k)
    ts = torch.full((), 0.2, device=cuda)
    wl, _ = integration.build_active_worklist(geom, m, t_cw, kmat, (W, H),
                                              1024)
    a = make_map(geom, field, cuda)._replace(block_coord=m.block_coord)
    b = make_map(geom, field, cuda)._replace(block_coord=m.block_coord)
    sa = integrate.integrate_blocks(geom, a, field, wl, depth, t_cw, kmat, mu,
                                    ts)
    sb = integrate.integrate_blocks_plain(geom, b, field, wl, depth, t_cw,
                                          kmat, mu, ts)
    assert int(sa) == int(sb)
    assert torch.allclose(a.data_x, b.data_x, **UPDATE_TOL[field.name])
    assert torch.equal(a.data_y, b.data_y) and torch.equal(a.active, b.active)


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
    K7 at every level of a 3-level pyramid, both neg_y: valid masks,
    depth and vertices bit-equal, normals to 1e-6."""
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
        d_k = d_p = depth
        for lvl in range(3):
            if lvl:
                d_k = preprocess.half_sample(d_k, E_DELTA * 3.0)
                d_p = preprocess.half_sample_plain(d_p, E_DELTA * 3.0)
                assert torch.equal(d_k, d_p)
            v, n, ok = preprocess.vertex_normal(d_k, k, lvl, neg_y)
            vp, np_, okp = preprocess.vertex_normal_plain(d_p, k, lvl, neg_y)
            assert torch.equal(ok, okp) and torch.equal(v, vp)
            assert float((n - np_).abs().max()) <= 1e-6


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
