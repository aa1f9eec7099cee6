"""Parity of the port's raycast (kernel K1's plain twin + kernel K2's,
the nav grid) with JAX ``ops/raycast.raycast`` on the depth-primed path
of the fused frame step, for both fields.

The map is JAX's after frames 0-4 (TSDF at mu 0.1, OFusion at mu 0.008);
both raycast it at frame 4's pose, primed with frame 4's depth. Hit masks
must agree on >= 99.5% of rays (TSDF) or 99.9% (OFusion), vertices to
1e-4 m and normals to 1e-3 on rays hit by both, and ray_overflow
exactly. A pool bucket below the block count checks that out-of-bucket
blocks read as unknown, as in the JAX strip table. The nav grid must
equal JAX ``build_nav`` exactly, with and without such a bucket, on the
frames' maps and on random slot grids and mip pyramids.

K1 computes each ray's prime from the depth frame and ``k``, and the
frame state's select: on the CPU ``raycast_rays(view, depth, k)`` must
equal the march primed by ``prime_from_depth`` bit for bit, frames 0-2
must leave the state's maps and raycast pose as they were with
ray_overflow 0, and the twin's per-ray probe counts must be nonzero
exactly on the rays whose range is not empty. Its record of the nav
entries and pool voxels read (K1's bound) must change no result and read
voxels only in the slots whose nav entries it read.

The TSDF map-maturity gate (``min_ref_weight``, JAX parallel/step.py:
171-192): the twin's weight read equals JAX ``get_voxel_channel_c``
(channel 1, fill 0) exactly at any point, in the map or not; the gated
raycast agrees with JAX's raycast gated by that read on the rays both
hit (>= 99.9 %: a vertex 1e-4 m away may cross a voxel face) with its
vertices and normals unchanged; for OFusion the option changes nothing.
The same holds on a noisy map (JAX's frame step over the noisy orbit with
the noise+levers options) from a view grazing the room's far wall, where
some rays crawl at the floor for more than 16 steps. The twin's per-ray
probe kinds sum to its probes a ray, and where a hit voxel's nav entry is
>= 0 it is the slot grid's entry (K1's gate reads the weight through it).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import NAV_DENSITIES, random_nav_map
from supereight_tpu.core import se3 as jax_se3
from supereight_tpu.core.map import MapGeometry as JaxMapGeometry
from supereight_tpu.core.map import get_voxel_channel_c
from supereight_tpu.fields import get_field
from supereight_tpu.ops import raycast as jax_raycast
from supereight_tpu_torch import convert
from supereight_tpu_torch.core import se3
from supereight_tpu_torch.core.map import make_map
from supereight_tpu_torch.kernels import nav as knav
from supereight_tpu_torch.kernels import raycast as kray
from supereight_tpu_torch.ops import raycast
from supereight_tpu_torch.io import synthetic
from test_torch_kernels import GRAZE_EYE, GRAZE_TARGET, hit_cells
from test_torch_step import (CAPACITY, FIELDS, MU, H, W, assert_no_drops,
                             jax_frames, jax_geometry, k_jax, k_torch,
                             make_scene, torch_frames, torch_geometry)

MIN_AGREE = {"tsdf": 0.995, "ofusion": 0.999}


@pytest.fixture(scope="module", params=["tsdf", "ofusion"])
def setup(request):
    torch.set_num_threads(1)
    depths, poses = make_scene()
    states, auxes = jax_frames(depths, poses, 5, request.param)
    for a in auxes:
        assert_no_drops(a)
    return depths[4], states[-1], request.param


@pytest.mark.parametrize("bucket", [CAPACITY, 48])
def test_raycast_parity(setup, bucket):
    depth, s, name = setup
    mu = MU[name]
    assert int(s.map.n_blocks) > bucket or bucket == CAPACITY
    jview = jnp.matmul(jnp.asarray(s.pose),
                       jax_se3.inverse_camera_matrix(k_jax()),
                       precision=jax.lax.Precision.HIGHEST)
    jv, jn, jok, jst = jax_raycast.raycast(
        jax_geometry(), jax.tree.map(jnp.asarray, s.map), get_field(name),
        jview, mu, (W, H),
        prime_t=jax_raycast.prime_from_depth(jnp.asarray(depth), k_jax()),
        with_stats=True, pool_bucket=bucket)
    jv, jn, jok = np.asarray(jv), np.asarray(jn), np.asarray(jok)

    ts = convert.frame_to_torch(s, "cpu")
    view = se3.matmul4(ts.pose, se3.inverse_camera_matrix(k_torch()))
    prime = kray.prime_from_depth(torch.from_numpy(depth), k_torch())
    np.testing.assert_allclose(
        prime.numpy(),
        np.asarray(jax_raycast.prime_from_depth(jnp.asarray(depth), k_jax())),
        rtol=1e-6)
    tv, tn, tok, tst = raycast.raycast(torch_geometry(), ts.map, FIELDS[name],
                                       view, mu, (W, H),
                                       depth=torch.from_numpy(depth),
                                       k=k_torch(), with_stats=True,
                                       pool_bucket=bucket)
    tv, tn, tok = tv.numpy(), tn.numpy(), tok.numpy()
    assert int(tst["ray_overflow"]) == int(jst["ray_overflow"])
    assert np.mean(tok == jok) >= MIN_AGREE[name]
    both = tok & jok
    assert both.sum() > 0.3 * both.size
    np.testing.assert_allclose(tv[both], jv[both], atol=1e-4, rtol=0)
    np.testing.assert_allclose(tn[both], jn[both], atol=1e-3, rtol=0)
    if bucket == CAPACITY:
        # the fused step's own output for frame 4 (same map, pose, prime)
        assert np.mean(tok == s.valid) >= 0.995


def test_nav_grid(setup):
    """Slots for in-bucket blocks, -(1 + capped block distance) else, plus
    the OFusion coarse free-space payload."""
    _, s, name = setup
    jm = jax.tree.map(jnp.asarray, s.map)
    tm = convert.map_to_torch(s.map, "cpu")
    for bucket in (CAPACITY, 48):
        want = np.asarray(jax_raycast.build_nav(jax_geometry(), jm,
                                                get_field(name),
                                                bucket=bucket))
        got = knav.nav_grid(torch_geometry(), tm, FIELDS[name],
                            bucket=bucket).numpy()
        np.testing.assert_array_equal(got, want)
        if name == "ofusion":  # the payload is exercised
            assert ((-want - 1) >= 8).sum() > 0


@pytest.mark.parametrize("b", [2, 8, 16])
@pytest.mark.parametrize("density", NAV_DENSITIES)
@pytest.mark.parametrize("name", ["tsdf", "ofusion"])
def test_nav_grid_random_grids(b, density, name):
    """K2's twin (the wrapper on CPU tensors) equals JAX ``build_nav`` on
    random slot grids of side b at 1 %, 10 % and 50 % occupancy, with the
    full pool and a bucket of half the blocks; for OFusion on random mip
    pyramids whose payload (finest value, clip, rounding) shows."""
    geom, m = random_nav_map(torch, b, density, b + int(100 * density),
                             "cpu")
    jgeom = JaxMapGeometry(size=geom.size, dim=geom.dim,
                           capacity=geom.capacity)
    jm = SimpleNamespace(**{k: jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                            getattr(m, k))
                            for k in ("slot", "mip_alloc", "mip_x", "mip_y")})
    n = int(m.n_blocks)
    for bucket in (None, n // 2):
        want = np.asarray(jax_raycast.build_nav(jgeom, jm, get_field(name),
                                                bucket=bucket))
        got = knav.nav_grid(geom, m, FIELDS[name], bucket=bucket)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            knav.nav_grid_plain(geom, m, FIELDS[name], bucket=bucket).numpy(),
            want)
        if name == "ofusion":
            assert ((-want - 1) >= 8).sum() > 0


def test_nav_round_half_even():
    """The OFusion payload rounds half to even like jnp.round: coarse
    values -k/32 (16 q = k/2) straddle every rounding case."""
    geom = torch_geometry()
    tm = make_map(geom, FIELDS["ofusion"], "cpu")
    b = geom.blocks_per_side
    vals = -np.arange(b ** 3, dtype=np.float32).reshape((b,) * 3) / 32.0
    tm.mip_x[0].copy_(torch.from_numpy(vals))
    tm.mip_y[0].fill_(1.0)
    tm.mip_alloc[0].fill_(True)
    jm = jax.tree.map(jnp.asarray, convert.to_numpy(tm))
    want = np.asarray(jax_raycast.build_nav(jax_geometry(), jm,
                                            get_field("ofusion")))
    got = knav.nav_grid(geom, tm, FIELDS["ofusion"]).numpy()
    np.testing.assert_array_equal(got, want)


def test_camera_zcos(setup):
    """The per-ray optical-axis cosine the OFusion sigma-band step uses
    (JAX raycast.py:436-452) at frame 4's view; the port takes 1 / sqrt
    where JAX takes rsqrt."""
    _, s, _ = setup
    jview = jnp.matmul(jnp.asarray(s.pose),
                       jax_se3.inverse_camera_matrix(k_jax()),
                       precision=jax.lax.Precision.HIGHEST)
    jd = jax_raycast.ray_directions_c(jview, W, H)
    want = np.asarray(jax_raycast.camera_zcos(
        jview, *(d.reshape(-1) for d in jd)))
    view = se3.matmul4(torch.tensor(s.pose),
                       se3.inverse_camera_matrix(k_torch()))
    got = kray.camera_zcos(view, *kray.ray_directions_c(view, W, H)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert 0.7 < want.min() and want.max() <= 1.0


def test_unported_options_raise(setup):
    """The unprimed raycast (no depth) takes no frame-state select and no
    maturity gate: JAX's unprimed raycast has neither."""
    _, s, name = setup
    ts = convert.frame_to_torch(s, "cpu")
    view = se3.matmul4(ts.pose, se3.inverse_camera_matrix(k_torch()))
    prev = kray.Previous(torch.ones((), dtype=torch.bool), ts.pose,
                         ts.raycast_pose, ts.vertex, ts.normal, ts.valid)
    with pytest.raises(ValueError, match="unprimed"):
        raycast.raycast(torch_geometry(), ts.map, FIELDS[name], view,
                        MU[name], (W, H), depth=None, prev=prev)
    if name == "tsdf":
        with pytest.raises(ValueError, match="unprimed"):
            raycast.raycast(torch_geometry(), ts.map, FIELDS[name], view,
                            MU[name], (W, H), min_ref_weight=2)


def test_raycast_rays_primes_like_prime_from_depth(setup):
    """The (view, depth, k) signature against the march primed by
    prime_from_depth, the former path, bit for bit on the CPU."""
    depth, s, name = setup
    ts = convert.frame_to_torch(s, "cpu")
    geom, field = torch_geometry(), FIELDS[name]
    view = se3.matmul4(ts.pose, se3.inverse_camera_matrix(k_torch()))
    d = torch.from_numpy(depth)
    nv = knav.nav_grid(geom, ts.map, field)
    got = kray.raycast_rays(geom, ts.map, field, nv, view, d, k_torch(),
                            MU[name], (W, H))
    want, _ = kray.march_plain(geom, field, ts.map.data_x, ts.map.data_y, nv,
                               view, kray.prime_from_depth(d, k_torch()),
                               MU[name], (W, H))
    assert got.raycast_pose is None
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, b)
    assert int(got.valid.sum()) > 0.3 * got.valid.numel()


@pytest.mark.parametrize("name", ["tsdf", "ofusion"])
def test_frames_0_to_2_keep_the_state(name):
    """Frames 0-2 raycast nothing into the state: its maps and raycast pose
    stay as init_frame_state made them and ray_overflow is 0; frame 3's
    raycast replaces them. K1's select gated off directly returns the
    state's tensors' values exactly."""
    depths, poses = make_scene(4)
    state, _, taux = torch_frames(depths, poses, 3, name)
    assert all(int(a["ray_overflow"]) == 0 for a in taux)
    assert torch.equal(state.raycast_pose,
                       torch.from_numpy(poses[0].astype(np.float32)))
    assert not (state.valid.any() or state.vertex.any()
                or state.normal.any())
    state, _, taux = torch_frames(depths, poses, 4, name)
    assert int(state.valid.sum()) > 0.3 * state.valid.numel()
    geom, field = torch_geometry(), FIELDS[name]
    old_v = torch.rand((H, W, 3))
    prev = kray.Previous(torch.tensor(False), state.pose, state.pose.T,
                         old_v, -old_v, old_v[..., 0] > 0.5)
    view = se3.matmul4(state.pose, se3.inverse_camera_matrix(k_torch()))
    rays = kray.raycast_rays(geom, state.map, field,
                             knav.nav_grid(geom, state.map, field), view,
                             torch.from_numpy(depths[3]), k_torch(), MU[name],
                             (W, H), prev=prev)
    for a, b in zip(rays, (old_v, -old_v, old_v[..., 0] > 0.5,
                           torch.zeros((), dtype=torch.int32),
                           state.pose.T)):
        assert torch.equal(a, b)


def test_probe_counts_mark_the_rays_that_march(setup):
    """A camera 2.5 m outside the map cube looking at it, no depth to
    prime the march: a ray marches exactly where its clip to the cube and
    the near/far planes leaves a range, and only those rays take probes."""
    _, s, name = setup
    ts = convert.frame_to_torch(s, "cpu")
    geom, field = torch_geometry(), FIELDS[name]
    pose = torch.from_numpy(synthetic.look_at(
        np.array([-2.5, 1.2, 0.9]), np.array([1.0, 1.0, 1.0]))
        .astype(np.float32))
    view = se3.matmul4(pose, se3.inverse_camera_matrix(k_torch()))
    nv = knav.nav_grid(geom, ts.map, field)
    rays, probes = kray.raycast_plain(
        geom, field, ts.map.data_x, ts.map.data_y, nv, view,
        torch.zeros((H, W)), k_torch(), MU[name], (W, H), with_probes=True)
    dx, dy, dz = kray.ray_directions_c(view, W, H)
    tnear, tfar = kray.ray_box_range_c((view[0, 3], view[1, 3], view[2, 3]),
                                       dx, dy, dz, geom.dim)
    marches = (tnear < tfar).reshape(H, W)
    assert 0 < int(marches.sum()) < marches.numel()
    np.testing.assert_array_equal((probes.per_ray > 0).numpy(),
                                  marches.numpy())
    assert not (rays.valid & ~marches).any()


def test_probe_reads_lie_in_the_slots_whose_nav_entries_were_read(setup):
    """The twin's record of what K1 reads, at frame 4's primed view:
    recording changes no result; every pool voxel read lies in a slot the
    nav grid lists, whose nav entry was read; the hits read voxels; and
    at most one nav entry is read per probe and eight per hit."""
    depth, s, name = setup
    ts = convert.frame_to_torch(s, "cpu")
    geom, field = torch_geometry(), FIELDS[name]
    view = se3.matmul4(ts.pose, se3.inverse_camera_matrix(k_torch()))
    nv = knav.nav_grid(geom, ts.map, field)
    args = (geom, field, ts.map.data_x, ts.map.data_y, nv, view,
            torch.from_numpy(depth), k_torch(), MU[name], (W, H))
    rays, probes = kray.raycast_plain(*args, with_probes=True)
    for a, b in zip(rays[:4], kray.raycast_plain(*args)[:4]):
        assert torch.equal(a, b)
    read_slots = probes.pool.reshape(CAPACITY, -1).any(1)
    cells = torch.nonzero(nv >= 0)[:, 0]
    listed = torch.zeros(CAPACITY, dtype=torch.bool)
    listed[nv[cells].long()] = True
    hits = int(rays.valid.sum())
    assert hits > 0 and int(read_slots.sum()) > 0
    assert not (read_slots & ~listed).any()
    assert bool(probes.nav[cells[read_slots[nv[cells].long()]]].all())
    assert int(probes.nav.sum()) <= (int(probes.per_ray.sum())
                                     + rays.valid.numel() + 8 * hits)


def test_ref_weight_plain_matches_jax(setup):
    """The gate's read at random points of and around the cube (in
    allocated blocks, in empty ones and outside the map), and at the
    state's own vertices, against JAX ``get_voxel_channel_c``."""
    _, s, name = setup
    ts = convert.frame_to_torch(s, "cpu")
    rng = np.random.default_rng(7)
    pts = rng.uniform(-0.2, 2.2, (4096, 3)).astype(np.float32)
    pts = np.concatenate([pts, s.vertex.reshape(-1, 3)])
    iv = jax_geometry().inv_voxel_size
    v = jnp.floor(jnp.asarray(pts) * iv).astype(jnp.int32)
    want = np.asarray(get_voxel_channel_c(
        jax_geometry(), jax.tree.map(jnp.asarray, s.map), get_field(name),
        v[:, 0], v[:, 1], v[:, 2], channel=1, fill=0.0))
    got = kray.ref_weight_plain(torch_geometry(), ts.map.slot,
                                ts.map.data_y, torch.from_numpy(pts))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).any() and (want == 0).any()


@pytest.mark.parametrize("weight", [3, 5])
def test_maturity_gate_parity(setup, weight):
    """K1's twin with the gate against JAX's raycast followed by the JAX
    frame step's gate, at frame 4's primed view."""
    depth, s, name = setup
    jview = jnp.matmul(jnp.asarray(s.pose),
                       jax_se3.inverse_camera_matrix(k_jax()),
                       precision=jax.lax.Precision.HIGHEST)
    jm = jax.tree.map(jnp.asarray, s.map)
    jv, jn, jok = jax_raycast.raycast(
        jax_geometry(), jm, get_field(name), jview, MU[name], (W, H),
        prime_t=jax_raycast.prime_from_depth(jnp.asarray(depth), k_jax()))
    iv = jax_geometry().inv_voxel_size
    hv = jnp.floor(jv * iv).astype(jnp.int32)
    w_ref = get_voxel_channel_c(jax_geometry(), jm, get_field(name),
                                hv[..., 0], hv[..., 1], hv[..., 2],
                                channel=1, fill=0.0)
    jgate = np.asarray(jok & (w_ref >= weight))
    jok = np.asarray(jok)

    ts = convert.frame_to_torch(s, "cpu")
    view = se3.matmul4(ts.pose, se3.inverse_camera_matrix(k_torch()))
    args = (torch_geometry(), ts.map, FIELDS[name], view, MU[name], (W, H))
    kw = dict(depth=torch.from_numpy(depth), k=k_torch())
    ungated = raycast.raycast(*args, **kw)
    gated = raycast.raycast(*args, **kw, min_ref_weight=weight)
    for a, b in ((ungated[0], gated[0]), (ungated[1], gated[1])):
        assert torch.equal(a, b)
    tok, gok = ungated[2].numpy(), gated[2].numpy()
    if name == "ofusion":  # a no-op: channel y is a time stamp
        np.testing.assert_array_equal(gok, tok)
        return
    both = tok & jok
    assert np.mean(gok[both] == jgate[both]) >= 0.999
    assert not (gok & ~tok).any()
    # the gate drops some hits and keeps others
    assert 0 < int(gok.sum()) < int(tok.sum())


def test_probe_kinds_sum_to_the_probes_a_ray(setup):
    """The twin's per-ray probe kinds at frame 4's primed view: known steps
    (above the crawl floor; OFusion: inside a block), floor steps (TSDF
    only) and jumps sum to each ray's probes; a probe reads at most one
    new nav entry, and recording them changes no result."""
    depth, s, name = setup
    ts = convert.frame_to_torch(s, "cpu")
    geom, field = torch_geometry(), FIELDS[name]
    view = se3.matmul4(ts.pose, se3.inverse_camera_matrix(k_torch()))
    nv = knav.nav_grid(geom, ts.map, field)
    args = (geom, field, ts.map.data_x, ts.map.data_y, nv, view,
            torch.from_numpy(depth), k_torch(), MU[name], (W, H))
    rays, probes = kray.raycast_plain(*args, with_probes=True)
    for a, b in zip(rays[:4], kray.raycast_plain(*args)[:4]):
        assert torch.equal(a, b)
    assert torch.equal(probes.known + probes.crawl + probes.jump,
                       probes.per_ray)
    assert bool((probes.new_nav <= probes.per_ray).all())
    assert int(probes.known.sum()) > 0 and int(probes.jump.sum()) > 0
    assert int(probes.new_nav.sum()) > 0
    if name == "ofusion":
        assert int(probes.crawl.sum()) == 0
    else:
        assert int(probes.crawl.sum()) > 0


def test_nav_entry_of_a_hit_is_its_slot(setup):
    """Where a hit voxel's nav entry is >= 0 it is the block's pool slot,
    the slot grid's entry there (K1's gate reads the weight through it),
    with the full pool and with a bucket below the block count."""
    depth, s, name = setup
    ts = convert.frame_to_torch(s, "cpu")
    geom, field = torch_geometry(), FIELDS[name]
    view = se3.matmul4(ts.pose, se3.inverse_camera_matrix(k_torch()))
    for bucket in (CAPACITY, 48):
        nv = knav.nav_grid(geom, ts.map, field, bucket=bucket)
        rays = kray.raycast_plain(geom, field, ts.map.data_x, ts.map.data_y,
                                  nv, view, torch.from_numpy(depth),
                                  k_torch(), MU[name], (W, H))
        cells = hit_cells(geom, rays.vertex, rays.valid)
        listed = nv[cells] >= 0
        assert int(listed.sum()) > 0
        assert torch.equal(nv[cells][listed],
                           ts.map.slot.reshape(-1)[cells][listed])


@pytest.fixture(scope="module")
def noisy_map():
    """JAX's map after the noisy orbit of test_torch_noise.py's tsdf-noise
    case (8 frames, the noise+levers options), its drop counters 0, and
    the options' maturity weight."""
    from test_torch_noise import CASES, noisy_scene
    torch.set_num_threads(1)
    field, n, options = CASES["tsdf-noise"]
    depths, poses = noisy_scene(n)
    states, auxes = jax_frames(depths, poses, n, field, **options)
    for a in auxes:
        assert_no_drops(a)
    return states[-1], options["min_ref_weight"]


def test_gate_parity_on_a_grazing_view_of_a_noisy_map(noisy_map):
    """K1's gated twin against JAX's raycast and the frame step's gate
    (parallel/step.py:171-192) on the noisy map from a grazing view along
    the room's far wall with no depth to prime it, at
    test_maturity_gate_parity's tolerances; some ray of the view takes more
    than 16 steps at the crawl floor (after which the floor rises)."""
    s, weight = noisy_map
    pose = synthetic.look_at(np.array(GRAZE_EYE),
                             np.array(GRAZE_TARGET)).astype(np.float32)
    zero = np.zeros((H, W), np.float32)
    jview = jnp.matmul(jnp.asarray(pose),
                       jax_se3.inverse_camera_matrix(k_jax()),
                       precision=jax.lax.Precision.HIGHEST)
    jm = jax.tree.map(jnp.asarray, s.map)
    jv, jn, jok, jst = jax_raycast.raycast(
        jax_geometry(), jm, get_field("tsdf"), jview, MU["tsdf"], (W, H),
        prime_t=jax_raycast.prime_from_depth(jnp.asarray(zero), k_jax()),
        with_stats=True)
    iv = jax_geometry().inv_voxel_size
    hv = jnp.floor(jv * iv).astype(jnp.int32)
    w_ref = get_voxel_channel_c(jax_geometry(), jm, get_field("tsdf"),
                                hv[..., 0], hv[..., 1], hv[..., 2],
                                channel=1, fill=0.0)
    jgate = np.asarray(jok & (w_ref >= weight))
    jv, jn, jok = np.asarray(jv), np.asarray(jn), np.asarray(jok)

    ts = convert.frame_to_torch(s, "cpu")
    geom, field = torch_geometry(), FIELDS["tsdf"]
    view = se3.matmul4(torch.from_numpy(pose),
                       se3.inverse_camera_matrix(k_torch()))
    nv = knav.nav_grid(geom, ts.map, field)
    args = (geom, field, ts.map.data_x, ts.map.data_y, nv, view,
            torch.from_numpy(zero), k_torch(), MU["tsdf"], (W, H))
    ungated = kray.raycast_plain(*args)
    gated, probes = kray.raycast_plain(*args, with_probes=True,
                                       slot=ts.map.slot,
                                       min_ref_weight=weight)
    assert int(gated.overflow) == int(jst["ray_overflow"]) == 0
    tok, gok = ungated.valid.numpy(), gated.valid.numpy()
    assert np.mean(tok == jok) >= MIN_AGREE["tsdf"]
    both = tok & jok
    assert both.sum() > 0.1 * both.size
    np.testing.assert_allclose(gated.vertex.numpy()[both], jv[both],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(gated.normal.numpy()[both], jn[both],
                               atol=1e-3, rtol=0)
    for a, b in ((ungated.vertex, gated.vertex),
                 (ungated.normal, gated.normal)):
        assert torch.equal(a, b)
    assert np.mean(gok[both] == jgate[both]) >= 0.999
    assert not (gok & ~tok).any()
    assert 0 < int(gok.sum()) < int(tok.sum())
    assert int(probes.crawl.max()) > 16
