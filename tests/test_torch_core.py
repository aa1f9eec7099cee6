"""Parity of the port's library surface with the JAX package: the Morton
codes and key algebra (``core/morton.py``, ``core/keyops.py``), the map's
voxel reads and writes and ``allocate_blocks`` (``core/map.py``),
interpolation and the reference gradient (``core/interp.py``), the
metric facade (``core/volume.py``), collision (``core/geometry.py``) and
the axis-aligned functor (``core/functor.py``).

Inputs come from a seed with numpy; maps are built by JAX's
``allocate_blocks`` with random payloads and coarse values and carried
into torch with ``convert.map_to_torch``. Integer results and reads are
exact; interp and grad agree to rtol 1e-6, atol 1e-6 (XLA on the CPU
contracts products into FMAs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu.core import functor as jax_functor
from supereight_tpu.core import geometry as jax_geometry
from supereight_tpu.core import interp as jax_interp
from supereight_tpu.core import keyops as jax_keyops
from supereight_tpu.core import map as jax_map
from supereight_tpu.core import morton as jax_morton
from supereight_tpu.core import volume as jax_volume
from supereight_tpu.fields import get_field as jax_field
from supereight_tpu_torch import convert
from supereight_tpu_torch.core import functor, geometry, interp, keyops
from supereight_tpu_torch.core import map as tmap
from supereight_tpu_torch.core import morton, volume
from supereight_tpu_torch.fields import get_field
from supereight_tpu_torch.io.serialise import morton_keys as np_morton_keys

SIZE, DIM, CAPACITY = 64, 2.0, 200
MAX_DEPTH = 6
FIELDS = ("tsdf", "ofusion")


def t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


def n(x):
    return np.asarray(x)


def assert_same_map(got, want):
    """A port map against a JAX one, every field exactly."""
    got = convert.to_numpy(got)
    for name in want._fields:
        a, b = getattr(want, name), getattr(got, name)
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(y, np.asarray(x), err_msg=name)


def random_map(field, seed, density=0.3, size=SIZE, capacity=CAPACITY):
    """A JAX map (allocated by JAX's allocate_blocks from a random mask)
    with random payloads and coarse values, and the same map in torch."""
    rng = np.random.default_rng(seed)
    jg = jax_map.MapGeometry(size=size, dim=DIM, capacity=capacity)
    b = jg.blocks_per_side
    st = jax_map.make_map(jg, jax_field(field))
    st = jax_map.allocate_blocks(jg, st,
                                 jnp.asarray(rng.random((b, b, b)) < density))
    lo, hi = (-1.0, 1.0) if field == "tsdf" else (-5.0, 5.0)
    shape = np.shape(st.data_x)
    # a third of the weights (time stamps) 0: unobserved voxels
    y = rng.uniform(0, 10, shape) * (rng.random(shape) > 0.3)
    st = st._replace(
        data_x=jnp.asarray(rng.uniform(lo, hi, shape), jnp.float32),
        data_y=jnp.asarray(y, jnp.float32),
        mip_x=tuple(jnp.asarray(rng.uniform(lo, hi, np.shape(m)),
                                jnp.float32) for m in st.mip_x),
        mip_y=tuple(jnp.asarray(rng.uniform(0, 3, np.shape(m)) *
                                (rng.random(np.shape(m)) > 0.3),
                                jnp.float32) for m in st.mip_y))
    tg = tmap.MapGeometry(size=size, dim=DIM, capacity=capacity)
    return jg, st, tg, convert.map_to_torch(st, "cpu")


# ---------------------------------------------------------------------------
# Morton codes and key algebra
# ---------------------------------------------------------------------------

def test_morton_matches_jax():
    rng = np.random.default_rng(0)
    g = np.arange(16)
    grid = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pts = np.concatenate([grid, rng.integers(0, 1024, (512, 3))]) \
        .astype(np.int32)
    want = n(jax_morton.encode_v(jnp.asarray(pts)))
    got = morton.encode_v(t(pts))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(morton.decode_v(got).numpy(),
                                  n(jax_morton.decode_v(jnp.asarray(want))))
    np.testing.assert_array_equal(morton.decode_v(got).numpy(), pts)
    words = rng.integers(0, 2 ** 32, 1024, dtype=np.uint64) \
        .astype(np.uint32)
    for name in ("expand_bits", "compact_bits"):
        np.testing.assert_array_equal(
            getattr(morton, name)(t(words.astype(np.int64))).numpy(),
            n(getattr(jax_morton, name)(jnp.asarray(words))), err_msg=name)
    assert int(morton.encode(1, 1, 1, device="cpu")) == 7


def _codes(rng, k=64):
    pts = rng.integers(0, 1 << MAX_DEPTH, (k, 3)).astype(np.int32)
    return n(jax_morton.encode_v(jnp.asarray(pts)))


@pytest.mark.parametrize("level", [-1, 0, 1, 3, MAX_DEPTH])
def test_keyops_per_level_match_jax(level):
    rng = np.random.default_rng(level + 5)
    c = _codes(rng)
    jc, tc = jnp.asarray(c), t(c.astype(np.int64))
    got = keyops.code_at_level(tc, level, MAX_DEPTH)
    np.testing.assert_array_equal(
        got.numpy(), n(jax_keyops.code_at_level(jc, level, MAX_DEPTH)))
    pc, pl = keyops.parent(tc, level, MAX_DEPTH)
    jpc, jpl = jax_keyops.parent(jc, level, MAX_DEPTH)
    np.testing.assert_array_equal(pc.numpy(), n(jpc))
    assert int(pl) == int(jpl)
    if level < 0:
        return
    np.testing.assert_array_equal(
        keyops.child_id(tc, level, MAX_DEPTH).numpy(),
        n(jax_keyops.child_id(jc, level, MAX_DEPTH)))
    anc = c[::-1].copy()
    np.testing.assert_array_equal(
        keyops.descendant(tc, t(anc.astype(np.int64)), level,
                          MAX_DEPTH).numpy(),
        n(jax_keyops.descendant(jc, jnp.asarray(anc), level, MAX_DEPTH)))
    if level == 0:
        return
    np.testing.assert_array_equal(
        keyops.siblings(tc, level, MAX_DEPTH).numpy(),
        n(jax_keyops.siblings(jc, level, MAX_DEPTH)))
    np.testing.assert_array_equal(
        keyops.far_corner(tc, level, MAX_DEPTH).numpy(),
        n(jax_keyops.far_corner(jc, level, MAX_DEPTH)))
    for axis in range(3):
        for direction in (-1, 1):
            got, ok = keyops.face_neighbour(tc, level, MAX_DEPTH, axis,
                                            direction)
            want, wok = jax_keyops.face_neighbour(jc, level, MAX_DEPTH,
                                                  axis, direction)
            np.testing.assert_array_equal(got.numpy(), n(want))
            np.testing.assert_array_equal(ok.numpy(), n(wok))


def test_sorted_key_compaction_matches_jax():
    rng = np.random.default_rng(3)
    for k in (1, 2, 17, 200):
        c = np.sort(rng.integers(0, 40, k)).astype(np.uint32)
        lv = rng.integers(2, MAX_DEPTH + 1, k).astype(np.int32)
        order = np.lexsort((lv, c))
        c, lv = c[order], lv[order]
        valid = rng.random(k) > 0.2
        jc, jl, jv = jnp.asarray(c), jnp.asarray(lv), jnp.asarray(valid)
        tc, tl, tv = t(c.astype(np.int64)), t(lv), t(valid)
        np.testing.assert_array_equal(keyops.unique(tc, tv).numpy(),
                                      n(jax_keyops.unique(jc, jv)))
        np.testing.assert_array_equal(
            keyops.filter_ancestors(tc, tl, tv, MAX_DEPTH).numpy(),
            n(jax_keyops.filter_ancestors(jc, jl, jv, MAX_DEPTH)))
        np.testing.assert_array_equal(
            keyops.unique_multiscale(tc, tl, tv).numpy(),
            n(jax_keyops.unique_multiscale(jc, jl, jv)))


# ---------------------------------------------------------------------------
# The map: allocation, reads, writes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("capacity,budget", [(CAPACITY, None), (40, None),
                                             (CAPACITY, 7)])
def test_allocate_blocks_matches_jax(field, capacity, budget):
    """Two allocations (the second overlapping the first) through JAX's
    allocate_blocks and the port's (K5's twin on the CPU): slot grid,
    block coords, n_blocks, active, mip_alloc and alloc_overflow exact,
    the caller's mask untouched and the map's touched buffer zero."""
    rng = np.random.default_rng(11)
    jg = jax_map.MapGeometry(size=SIZE, dim=DIM, capacity=capacity)
    tg = tmap.MapGeometry(size=SIZE, dim=DIM, capacity=capacity)
    b = tg.blocks_per_side
    js = jax_map.make_map(jg, jax_field(field))
    ts = tmap.make_map(tg, get_field(field), "cpu")
    for density in (0.05, 0.2):
        mask = rng.random((b, b, b)) < density
        js, jst = jax_map.allocate_blocks(jg, js, jnp.asarray(mask),
                                          with_stats=True, budget=budget)
        tmask = t(mask)
        out, tst = tmap.allocate_blocks(tg, ts, tmask, with_stats=True,
                                        budget=budget)
        assert out is ts
        np.testing.assert_array_equal(tmask.numpy(), mask)
        assert not ts.touched.any()
        assert int(tst["alloc_overflow"]) == int(jst["alloc_overflow"])
        assert_same_map(ts, js)
    assert int(tmap.count_blocks(ts)) == int(jax_map.count_blocks(js))
    np.testing.assert_array_equal(tmap.block_origin_voxel(ts).numpy(),
                                  n(jax_map.block_origin_voxel(js)))
    keys = tmap.morton_keys(ts).numpy()
    np.testing.assert_array_equal(keys, n(jax_map.morton_keys(js)))
    np.testing.assert_array_equal(keys, np_morton_keys(ts.block_coord))


def _voxels(rng, k=3000):
    """Integer voxel coords, a fifth of them outside the map (negative
    and past the far side)."""
    return rng.integers(-12, SIZE + 12, (k, 3)).astype(np.int32)


@pytest.mark.parametrize("field", FIELDS)
def test_voxel_reads_match_jax(field):
    jg, js, tg, ts = random_map(field, 1)
    jf, tf = jax_field(field), get_field(field)
    rng = np.random.default_rng(2)
    v = _voxels(rng)
    jv, tv = jnp.asarray(v), t(v)
    bc = rng.integers(-2, tg.blocks_per_side + 2, (500, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        tmap.lookup_slot(ts, t(bc)).numpy(),
        n(jax_map.lookup_slot(js, jnp.asarray(bc))))
    for fill in (None, (7.0, -3.0)):
        for a, b in zip(tmap.get_voxel(tg, ts, tf, tv, fill),
                        jax_map.get_voxel(jg, js, jf, jv, fill)):
            np.testing.assert_array_equal(a.numpy(), n(b))
        for c in (0, 1):
            f = None if fill is None else fill[c]
            np.testing.assert_array_equal(
                tmap.get_voxel_channel(tg, ts, tf, tv, c, f).numpy(),
                n(jax_map.get_voxel_channel(jg, js, jf, jv, c, f)))
    for a, b in zip(tmap.get_with_coarse(tg, ts, tf, tv),
                    jax_map.get_with_coarse(jg, js, jf, jv)):
        np.testing.assert_array_equal(a.numpy(), n(b))
    lin = rng.integers(0, 8, (100, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        tmap.voxel_linear_index(t(lin)).numpy(),
        n(jax_map.voxel_linear_index(jnp.asarray(lin))))


@pytest.mark.parametrize("field", FIELDS)
def test_set_voxels_matches_jax(field):
    """Unique coordinates (duplicates have no defined winner in either
    package), some unallocated, some outside the map: those writes are
    dropped."""
    jg, js, tg, ts = random_map(field, 4)
    rng = np.random.default_rng(5)
    v = np.unique(_voxels(rng, 4000), axis=0)
    x = rng.normal(size=len(v)).astype(np.float32)
    y = rng.uniform(0, 9, len(v)).astype(np.float32)
    js = jax_map.set_voxels(js, jnp.asarray(v), jnp.asarray(x),
                            jnp.asarray(y))
    out = tmap.set_voxels(ts, t(v), t(x), t(y))
    assert out is ts
    assert_same_map(ts, js)


def test_reads_and_writes_take_host_coordinates():
    """Coordinates given as numpy arrays or lists (as JAX's functions take
    them) are carried to the map's device: the reads, writes and interp
    give what the same coordinates as tensors give."""
    _, _, tg, ts = random_map("tsdf", 8, density=0.6)
    tf = get_field("tsdf")
    rng = np.random.default_rng(9)
    v = np.unique(_voxels(rng, 500), axis=0)
    p = _points(rng, 200)
    for a, b in zip(tmap.get_voxel(tg, ts, tf, v),
                    tmap.get_voxel(tg, ts, tf, t(v))):
        assert torch.equal(a, b)
    assert torch.equal(tmap.get_voxel_channel(tg, ts, tf, v.tolist(), 1),
                       tmap.get_voxel_channel(tg, ts, tf, t(v), 1))
    for a, b in zip(tmap.get_with_coarse(tg, ts, tf, v),
                    tmap.get_with_coarse(tg, ts, tf, t(v))):
        assert torch.equal(a, b)
    assert torch.equal(tmap.lookup_slot(ts, v // 8),
                       tmap.lookup_slot(ts, t(v // 8)))
    assert torch.equal(interp.interp(tg, ts, tf, p),
                       interp.interp(tg, ts, tf, t(p)))
    assert torch.equal(interp.grad(tg, ts, tf, p.tolist()),
                       interp.grad(tg, ts, tf, t(p)))
    x = rng.normal(size=len(v)).astype(np.float32)
    host = tmap.set_voxels(random_map("tsdf", 8, density=0.6)[3], v, x, 2.0)
    tmap.set_voxels(ts, t(v), t(x), 2.0)
    assert torch.equal(host.data_x, ts.data_x)
    assert torch.equal(host.data_y, ts.data_y)


# ---------------------------------------------------------------------------
# Interpolation, gradient, the metric facade
# ---------------------------------------------------------------------------

def _points(rng, k=2000):
    """Continuous voxel coords, some outside the map and below 0."""
    return rng.uniform(-3.0, SIZE + 3.0, (k, 3)).astype(np.float32)


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("channel", [0, 1])
def test_interp_and_grad_match_jax(field, channel):
    jg, js, tg, ts = random_map(field, 6, density=0.6)
    jf, tf = jax_field(field), get_field(field)
    p = _points(np.random.default_rng(7))
    want = n(jax_interp.interp(jg, js, jf, jnp.asarray(p), channel))
    got = interp.interp(tg, ts, tf, t(p), channel).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    want = n(jax_interp.grad(jg, js, jf, jnp.asarray(p), channel))
    got = interp.grad(tg, ts, tf, t(p), channel).numpy()
    assert got.shape == (len(p), 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_interp_of_analytic_field():
    """The reference's interpolation drive: a smooth field sampled into
    every voxel is reconstructed between voxels, and a linear field's
    gradient is exact."""
    tg = tmap.MapGeometry(size=32, dim=32.0, capacity=64)
    ts = tmap.make_map(tg, get_field("tsdf"), "cpu")
    tmap.allocate_blocks(tg, ts, torch.ones((4, 4, 4), dtype=torch.bool))
    g = torch.arange(32)
    v = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1) \
        .reshape(-1, 3).to(torch.int32)
    lin = (2.0 * v[:, 0] - 3.0 * v[:, 1] + 0.5 * v[:, 2]).float()
    tmap.set_voxels(ts, v, lin, torch.ones(len(v)))
    p = torch.tensor([[5.3, 7.7, 20.1], [8.0, 8.0, 8.0], [15.5, 3.25, 9.0]])
    np.testing.assert_allclose(
        interp.interp(tg, ts, get_field("tsdf"), p).numpy(),
        (2.0 * p[:, 0] - 3.0 * p[:, 1] + 0.5 * p[:, 2]).numpy(), atol=1e-4)
    np.testing.assert_allclose(
        interp.grad(tg, ts, get_field("tsdf"), p).numpy(),
        [[2.0, -3.0, 0.5]] * 3, atol=1e-4)


@pytest.mark.parametrize("field", FIELDS)
def test_volume_matches_jax(field):
    """Metric positions, negative ones included: ``get`` truncates toward
    zero as JAX's cast does."""
    jg, js, tg, ts = random_map(field, 8, density=0.6)
    jvol = jax_volume.Volume(jg, js, jax_field(field))
    tvol = volume.Volume(tg, ts, get_field(field))
    assert (tvol.size, tvol.dim) == (jvol.size, jvol.dim)
    pm = _points(np.random.default_rng(9)) * np.float32(tg.voxel_size)
    for a, b in zip(tvol.get(pm), jvol.get(pm)):
        np.testing.assert_array_equal(a.numpy(), n(b))
    np.testing.assert_allclose(tvol.interp(pm).numpy(), n(jvol.interp(pm)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tvol.grad(pm, 1).numpy(),
                               n(jvol.grad(pm, 1)), rtol=1e-6, atol=1e-6)
    vox = np.array([[1, 2, 3], [63, 0, 7]], np.int32)
    np.testing.assert_array_equal(tvol.pos(vox).numpy(), n(jvol.pos(vox)))


# ---------------------------------------------------------------------------
# Collision and the functor
# ---------------------------------------------------------------------------

BOXES = (((9, 9, 9), (12, 12, 12)), ((0, 0, 0), (16, 16, 16)),
         ((40, 2, 30), (44, 6, 33)), ((58, 58, 58), (70, 66, 67)),
         ((-4, -3, -5), (4, 3, 6)), ((20, 20, 20), (21, 21, 21)))


@pytest.mark.parametrize("field", FIELDS)
def test_collides_with_matches_jax(field):
    """Boxes inside, across the map's edge and at negative coordinates,
    on a sparse map with unobserved voxels: the status is exact."""
    jg, js, tg, ts = random_map(field, 10, density=0.1)
    seen = set()
    for lo, hi in BOXES:
        want = int(jax_geometry.collides_with(jg, js, jax_field(field), lo,
                                              hi))
        got = geometry.collides_with(tg, ts, get_field(field), lo, hi)
        assert got.dtype == torch.int32 and int(got) == want, (lo, hi)
        seen.add(want)
        pred = (lambda x: x > 0.5) if field == "tsdf" else (lambda x: x < 0)
        assert int(geometry.collides_with(tg, ts, get_field(field), lo, hi,
                                          pred)) == int(
            jax_geometry.collides_with(jg, js, jax_field(field), lo, hi,
                                       pred))
    assert len(seen) >= 2


def test_collision_states_and_aabb():
    """JAX's collision drive: a block of observed occupied, then free,
    voxels, and unallocated space."""
    tg = tmap.MapGeometry(size=64, dim=2.0, capacity=64)
    tsdf = get_field("tsdf")
    S = geometry.CollisionStatus

    def block(value):
        ts = tmap.make_map(tg, tsdf, "cpu")
        mask = torch.zeros((8, 8, 8), dtype=torch.bool)
        mask[1, 1, 1] = True
        tmap.allocate_blocks(tg, ts, mask)
        g = torch.arange(8, 16)
        v = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1) \
            .reshape(-1, 3).to(torch.int32)
        return tmap.set_voxels(ts, v, torch.full((512,), value),
                               torch.full((512,), 10.0))
    box = ((9, 9, 9), (12, 12, 12))
    assert int(geometry.collides_with(tg, block(-0.5), tsdf, *box)) \
        == S.OCCUPIED
    assert int(geometry.collides_with(tg, block(0.8), tsdf, *box)) == S.EMPTY
    assert int(geometry.collides_with(tg, block(0.8), tsdf, (40, 40, 40),
                                      (44, 44, 44))) == S.UNSEEN
    assert int(geometry.collides_with(tg, block(-0.5), tsdf, (9, 9, 9),
                                      (30, 12, 12))) == S.OCCUPIED
    for a in (((0, 0, 0), (2, 2, 2), (1, 1, 1), (3, 3, 3)),
              ((0, 0, 0), (1, 1, 1), (2, 2, 2), (3, 3, 3)),
              ((0, 0, 0), (4, 4, 4), (1, 1, 1), (2, 2, 2)),
              ((0, 0, 0), (4, 4, 4), (3, 3, 3), (5, 5, 5))):
        assert bool(geometry.aabb_aabb_collision(*a, device="cpu")) == bool(
            jax_geometry.aabb_aabb_collision(*a))
        assert bool(geometry.aabb_aabb_inclusion(*a, device="cpu")) == bool(
            jax_geometry.aabb_aabb_inclusion(*a))


@pytest.mark.parametrize("box", [(None, None), ((8, 8, 8), (10, 16, 16)),
                                 ((-5, -5, -5), (20, 70, 33)),
                                 ((48, 0, 40), (80, 64, 64))])
@pytest.mark.parametrize("include_nodes", [True, False])
def test_axis_aligned_map_matches_jax(box, include_nodes):
    jg, js, tg, ts = random_map("tsdf", 12)

    def fn(mod):
        def f(x, y, vox):
            return x * 2.0 - vox[..., 0] * 0.01, y + 1.0
        return f
    want = jax_functor.axis_aligned_map(jg, js, fn(jnp), *box,
                                        include_nodes=include_nodes)
    before = convert.to_numpy(ts)
    got = functor.axis_aligned_map(tg, ts, fn(torch), *box,
                                   include_nodes=include_nodes)
    assert_same_map(got, want)
    # the input map is left as it was
    for a, b in zip(convert.to_numpy(ts).data_x, before.data_x):
        np.testing.assert_array_equal(a, b)
