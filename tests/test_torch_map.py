"""Parity of the port's block-pool map (``core/map.py``) with JAX
``core/map.py``: the empty map, the geometry, the voxel reads and the
mip-existence refresh (with OFusion's directly allocated coarse levels),
dense and, frame by frame, the allocator's incremental form.

The map under the reads is filled from a seed with numpy (random slots,
payloads and coordinates, a fifth of them outside the map), so the test
needs no frame step. Everything must match exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu.core import map as jax_map
from supereight_tpu.fields import get_field
from supereight_tpu_torch import convert
from supereight_tpu_torch.core import map as tmap
from supereight_tpu_torch.fields import TSDF

SIZE, DIM, CAPACITY = 64, 2.0, 96


def _geoms():
    return (jax_map.MapGeometry(size=SIZE, dim=DIM, capacity=CAPACITY),
            tmap.MapGeometry(size=SIZE, dim=DIM, capacity=CAPACITY))


def test_make_map_and_geometry_match_jax():
    jg, tg = _geoms()
    for name in ("voxel_size", "inv_voxel_size", "blocks_per_side",
                 "num_levels"):
        assert getattr(tg, name) == getattr(jg, name), name
    want = jax_map.make_map(jg, get_field("tsdf"))
    got = convert.to_numpy(tmap.make_map(tg, TSDF, "cpu"))
    for name in want._fields:
        a, b = getattr(want, name), getattr(got, name)
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert y.dtype == np.asarray(x).dtype, name
            np.testing.assert_array_equal(y, np.asarray(x), err_msg=name)


@pytest.mark.parametrize("size", [8, 16, 32, 64])
@pytest.mark.parametrize("make", ["make_map", "map_to_torch"])
def test_touched_buffer_zeroed_aligned_and_left_out(make, size):
    """The port-only touched buffer: ``make_map`` and
    ``convert.map_to_torch`` make it zeroed, holding levels 0-2 back to
    back (1 to 2 levels at b = 1 and 2) with level 0 first and 16-byte
    aligned; ``to_numpy`` leaves it out, so the numpy map has JAX's fields
    in JAX's order."""
    tg = tmap.MapGeometry(size=size, dim=DIM, capacity=CAPACITY)
    b = tg.blocks_per_side
    m = tmap.make_map(tg, TSDF, "cpu")
    if make == "map_to_torch":
        m = convert.map_to_torch(convert.to_numpy(m), "cpu")
    assert m.touched.dtype == torch.bool and not m.touched.any()
    assert m.touched.numel() == tmap.touched_size(b) == sum(
        (b >> lvl) ** 3 for lvl in range(3))
    assert m.touched.data_ptr() % 16 == 0
    grids = tmap.touched_grids(m.touched, b)
    assert [g.shape for g in grids] == [(b >> lvl,) * 3 for lvl in range(3)]
    assert grids[0].data_ptr() == m.touched.data_ptr()
    back = convert.to_numpy(m)
    jg = jax_map.MapGeometry(size=size, dim=DIM, capacity=CAPACITY)
    assert back._fields == jax_map.make_map(jg, get_field("tsdf"))._fields
    assert "touched" not in back._fields


def _random_map(rng):
    """A JAX-layout map (numpy) with CAPACITY random blocks allocated."""
    tg = _geoms()[1]
    m = convert.to_numpy(tmap.make_map(tg, TSDF, "cpu"))
    b = tg.blocks_per_side
    cells = rng.choice(b ** 3, CAPACITY, replace=False)
    slot = m.slot.reshape(-1).copy()
    slot[cells] = rng.permutation(CAPACITY).astype(np.int32)
    data_x = rng.uniform(-1, 1, m.data_x.shape).astype(np.float32)
    data_y = rng.integers(0, 5, m.data_y.shape).astype(np.float32)
    return m._replace(slot=slot.reshape(m.slot.shape), data_x=data_x,
                      data_y=data_y, n_blocks=np.int32(CAPACITY))


@pytest.mark.parametrize("channel,fill", [(0, None), (1, None), (1, 0.0)])
def test_get_voxel_channel_matches_jax(channel, fill):
    rng = np.random.default_rng(7)
    m = _random_map(rng)
    jg, tg = _geoms()
    # voxel coords: 80% inside the map, the rest up to 8 voxels outside
    v = rng.integers(-8, SIZE + 8, (3, 4096)).astype(np.int32)
    inside = rng.random(4096) < 0.8
    v[:, inside] = rng.integers(0, SIZE, (3, int(inside.sum())))
    jm = jax_map.MapState(*(tuple(map(jnp.asarray, x))
                            if isinstance(x, tuple) else jnp.asarray(x)
                            for x in m))
    want = np.asarray(jax_map.get_voxel_channel_c(
        jg, jm, get_field("tsdf"), *(jnp.asarray(c) for c in v),
        channel=channel, fill=fill))
    tm = convert.map_to_torch(m, "cpu")
    got = tmap.get_voxel_channel_c(tg, tm, TSDF,
                                   *(torch.from_numpy(c) for c in v),
                                   channel=channel, fill=fill).numpy()
    np.testing.assert_array_equal(got, want)
    # the reads hit allocated blocks, unallocated blocks and outside space
    b = v >> 3
    ok = (v >= 0).all(0) & (v < SIZE).all(0)
    slots = np.where(ok, m.slot[tuple(np.clip(b, 0, SIZE // 8 - 1))], -1)
    assert (slots >= 0).any() and ((slots < 0) & ok).any() and (~ok).any()


@pytest.mark.parametrize("extra", [None, (1, 2), (0, 1, 2, 3)])
def test_refresh_mip_alloc_matches_jax(extra):
    """Block allocation plus random masks ORed in at the listed levels
    (OFusion's coarse octants), into a map whose mips already hold bits
    (existence is monotonic)."""
    rng = np.random.default_rng(11)
    jg, tg = _geoms()
    m = _random_map(rng)
    b = tg.blocks_per_side
    old = tuple((rng.random((b >> l,) * 3) < 0.05)
                for l in range(tg.num_levels))
    m = m._replace(mip_alloc=old)
    block_alloc = rng.random((b,) * 3) < 0.02
    masks = None
    if extra is not None:
        masks = [None] * tg.num_levels
        for l in extra:
            masks[l] = rng.random((b >> l,) * 3) < 0.05
    jm = jax_map.MapState(*(tuple(map(jnp.asarray, x))
                            if isinstance(x, tuple) else jnp.asarray(x)
                            for x in m))
    want = jax_map.refresh_mip_alloc(
        jg, jm, jnp.asarray(block_alloc),
        extra_levels=None if masks is None else tuple(
            None if x is None else jnp.asarray(x) for x in masks))
    tm = convert.map_to_torch(m, "cpu")
    tmap.refresh_mip_alloc(
        tg, tm, torch.from_numpy(block_alloc),
        extra_levels=None if masks is None else tuple(
            None if x is None else torch.from_numpy(x) for x in masks))
    for lvl, (a, w) in enumerate(zip(tm.mip_alloc, want.mip_alloc)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w),
                                      err_msg=f"level {lvl}")


@pytest.mark.parametrize("field", ["tsdf", "ofusion"])
def test_incremental_mip_refresh_matches_dense_over_frames(field):
    """The allocator's mip refresh ORs in only what each call's new blocks
    (and OFusion's coarse octants) imply. Over 8 consecutive allocation
    steps of the 64^3 orbit from an empty map, its mip_alloc equals JAX's
    dense refresh_mip_alloc after every step, and the invariant it rests
    on holds: mip_alloc contains the broadcast of the OR-reduce pyramid of
    the allocated blocks."""
    from test_torch_step import (MU, jax_geometry, k_jax, k_torch,
                                 make_scene, torch_geometry)
    from supereight_tpu.ops import allocation as jax_alloc
    from supereight_tpu_torch.fields import OFUSION
    from supereight_tpu_torch.ops import allocation
    torch.set_num_threads(1)
    jg, tg = jax_geometry(), torch_geometry()
    of = field == "ofusion"
    jax_fn = jax_alloc.allocate_ofusion if of else jax_alloc.allocate_tsdf
    fn = allocation.allocate_ofusion if of else allocation.allocate_tsdf
    jm = jax_map.make_map(jg, get_field(field))
    tm = tmap.make_map(tg, OFUSION if of else TSDF, "cpu")
    depths, poses = make_scene(8)
    grew = 0
    for i in range(8):
        pose = poses[i].astype(np.float32)
        n_before = int(tm.n_blocks)
        jm = jax_fn(jg, jm, jnp.asarray(depths[i]), jnp.asarray(pose),
                    k_jax(), MU[field])
        fn(tg, tm, torch.from_numpy(depths[i]), torch.from_numpy(pose),
           k_torch(), MU[field])
        grew += int(tm.n_blocks) > n_before
        np.testing.assert_array_equal(tm.slot.numpy(), np.asarray(jm.slot))
        occ = tm.slot >= 0
        for lvl, (a, w) in enumerate(zip(tm.mip_alloc, jm.mip_alloc)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(w),
                                          err_msg=f"frame {i} level {lvl}")
            if lvl + 1 < tg.num_levels:
                occ = tmap._or_reduce2(occ)
                assert not (tmap.broadcast2(occ) & ~a).any()
    assert grew >= 4


@pytest.mark.parametrize("entry", ["make_map", "init_frame_state",
                                   "map_to_torch", "frame_to_torch"])
def test_entry_points_default_to_the_card(entry):
    """Called without a device, the port's entry points put their tensors
    on the card: on a host without one they raise torch's own error, and
    never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default call runs there")
    from supereight_tpu_torch.parallel import step
    tg = _geoms()[1]
    pose = np.eye(4, dtype=np.float32)
    calls = {
        "make_map": lambda: tmap.make_map(tg, TSDF),
        "init_frame_state": lambda: step.init_frame_state(tg, TSDF, (8, 6),
                                                          pose),
        "map_to_torch": lambda: convert.map_to_torch(
            convert.to_numpy(tmap.make_map(tg, TSDF, "cpu"))),
        "frame_to_torch": lambda: convert.frame_to_torch(convert.to_numpy(
            step.init_frame_state(tg, TSDF, (8, 6), pose, "cpu"))),
    }
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        calls[entry]()
