"""K5 wrappers and twins: the allocation of both fields.

:func:`touched_mask` replaces
``supereight_tpu/ops/allocation.py:tsdf_touched_mask`` (75-115) and
:func:`touched_masks_of` replaces ``ofusion_touched_masks`` (148-214,
with the static ``ofusion_step_ladder``, 118-145); both use
``_pixel_rays_c_sub`` (32-58) and ``_touched_cell_ids`` (61-72).
:func:`alloc_assign` replaces ``supereight_tpu/core/map.py:allocate_blocks``
(273-342) and ``refresh_mip_alloc`` (345-391). The CUDA kernels are in
``csrc/alloc.cu``. The ``*_plain`` functions are the plain PyTorch
versions, used for CPU tensors and as the kernels' reference on the card.
The TPU's dedup of repeated samples was a scatter-cost trick and is not
carried over: it changes no touched flag.

The sharded step (``parallel/dist_step.py``) runs two modes of them: the
marches over a rank's column window (JAX's ``x_offset``) and
:func:`alloc_assign` with the ranks' ownership (:class:`Owners`), each
counted under its own launch name.

On the main path the marches write into the map's touched buffer
(``MapState.touched``, all zero between frames) and :func:`alloc_assign`
consumes the grids it is given: they are all zero on return, so no frame
fills them.
"""

import functools
import math
from typing import NamedTuple

import torch

from benchmark.reference.frozen.core import morton, se3
from benchmark.reference.frozen.core.map import (refresh_mip_alloc, touched_grids,
                                           touched_size)

# per-frame bound on NEW block allocations (the JAX package's value).
# Overflow cells stay unallocated and are re-touched on later frames.
ALLOC_BUDGET = 8192
OWNER_TILE = 64  # morton cells a rank owns together: a 4^3 super-brick


class Owners(NamedTuple):
    """The sharded step's ownership of block cells: ``tile`` consecutive
    morton cells go to one of ``world`` ranks, the tiles round-robin
    (JAX's ``owner_grid``). With the tile of 64 cells, the 4^3
    super-brick, a cell's owner is the morton code of (x >> 2, y >> 2,
    z >> 2) mod ``world`` (:func:`owner_cells`), which ``csrc/alloc.cu``
    computes instead of reading a grid; no other tile is taken."""

    world: int
    tile: int = OWNER_TILE


def owner_cells(b: int, owners: Owners, device="cuda"):
    """i32[b, b, b]: the rank that owns each block cell, by the arithmetic
    of ``csrc/alloc.cu`` ``tile_owner``: the morton code of the cell's 4^3
    super-brick mod the world size. The port's one owner function
    (``parallel/dist_step.owner_grid`` returns it)."""
    _check_owners(owners)
    g = torch.arange(b, dtype=torch.int32, device=device) >> 2
    x, y, z = torch.meshgrid(g, g, g, indexing="ij")
    code = (morton.expand_bits(x) | (morton.expand_bits(y) << 1)
            | (morton.expand_bits(z) << 2))
    return (code % owners.world).to(torch.int32)


def _check_owners(owners):
    if owners.tile != OWNER_TILE or owners.world < 1:
        raise ValueError(f"alloc_assign: ownership of {owners.world} ranks "
                         f"in tiles of {owners.tile} cells; the kernel "
                         f"takes tiles of {OWNER_TILE} (a 4^3 super-brick)")

_STRIDE = 2  # pixels are sampled 2x2 (JAX tsdf_touched_mask)


def band_schedule(geom, mu: float):
    """(band, num_steps, step) of the +/- 2 mu band march: samples every
    ~3 voxels (JAX allocation.py:88-97)."""
    band = 2.0 * mu
    num_steps = int(math.ceil(band * geom.inv_voxel_size / 3.0))
    return band, num_steps, band / num_steps


def pixel_rays(depth, stride: int, pose, kpose, half: float, x_offset=0):
    """The rays of depth[::stride, ::stride] (csrc/alloc.cu ``pixel_ray``):
    (origins, unit directions toward the camera, valid) as component
    tuples of [hs, ws] tensors; an origin is the back-projected pixel
    centre backed off by ``half`` toward the camera (JAX
    _pixel_rays_c_sub). ``depth`` is a column slice of the frame starting
    at column ``x_offset``. A Python float scalar acts as its f32
    rounding, like a JAX constant."""
    dev = depth.device
    d = depth[::stride, ::stride]
    hs, ws = d.shape
    xs = (torch.arange(ws, dtype=torch.float32, device=dev) * stride + 0.5
          + float(x_offset))
    ys = torch.arange(hs, dtype=torch.float32, device=dev) * stride + 0.5
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    wvx, wvy, wvz = se3.transform_c(kpose, px * d, py * d, d)
    dx, dy, dz = pose[0, 3] - wvx, pose[1, 3] - wvy, pose[2, 3] - wvz
    norm = torch.sqrt(dx * dx + dy * dy + dz * dz)
    inv = 1.0 / torch.where(norm == 0, torch.ones_like(norm), norm)
    dx, dy, dz = dx * inv, dy * inv, dz * inv
    origin = (wvx - half * dx, wvy - half * dy, wvz - half * dz)
    return origin, (dx, dy, dz), d > 0


def _mark_plain(geom, flat, origin, direction, t, lvl, ok):
    """Set the cells of the level-``lvl`` grid ``flat`` (its drop cell
    last) under the rays' samples at ``t`` where ``ok`` and in the map
    (csrc/alloc.cu ``mark``)."""
    side = geom.blocks_per_side >> lvl
    shift = 3 + lvl
    iv, size = geom.inv_voxel_size, geom.size
    vx, vy, vz = (torch.floor((o + d * t) * iv).to(torch.int32)
                  for o, d in zip(origin, direction))
    inb = ((vx >= 0) & (vx < size) & (vy >= 0) & (vy < size)
           & (vz >= 0) & (vz < size)) & ok
    ids = ((vx >> shift) * side + (vy >> shift)) * side + (vz >> shift)
    flat.index_fill_(0, torch.where(inb, ids, side ** 3).long().reshape(-1),
                     True)


def touched_mask_plain(geom, depth, pose, kpose, mu: float, x_offset=0):
    """Plain PyTorch twin of :func:`touched_mask` (kpose = pose @ invK) in
    JAX's form: ``depth`` is the window's columns, which start at image
    column ``x_offset``."""
    b = geom.blocks_per_side
    band, num_steps, step = band_schedule(geom, mu)
    origin, direction, valid = pixel_rays(depth, _STRIDE, pose, kpose,
                                          band * 0.5, x_offset)
    flat = torch.zeros(b * b * b + 1, dtype=torch.bool, device=depth.device)
    for i in range(num_steps):
        _mark_plain(geom, flat, origin, direction, i * step, 0, valid)
    return flat[:-1].reshape(b, b, b)


_OF_STRIDES = (2, 8, 8)  # pixel stride of the level-0, 1 and 2 samples


def ofusion_step_ladder(geom, band: float, max_dist: float):
    """Static (travelled distances, sample levels) of the occupancy march
    (JAX allocation.py:118-145, ref compute_stepsize + step_to_depth,
    bfusion/alloc_impl.hpp:37-51): 1-voxel steps while t < band (level
    0), 10 voxels while t < 1.5 band (level 1), then 30 voxels (level
    2); the level of sample i is that of step i - 1."""
    voxel = geom.voxel_size
    travelled, levels = [], []
    t = 0.0
    while t < max_dist:
        travelled.append(t)
        if t < band:
            step, lvl = voxel, 0
        elif t < band * 1.5:
            step, lvl = 10.0 * voxel, 1
        else:
            step, lvl = 30.0 * voxel, 2
        levels.append(lvl)
        t += step
    return travelled, [0] + levels[:-1]


def _of_schedule(geom, mu: float, max_dist):
    band = 6.0 * mu
    if max_dist is None:
        max_dist = geom.dim * math.sqrt(3.0)
    return band, max_dist


class Ladder(NamedTuple):
    """The occupancy march's static samples as the kernel reads them."""

    t: torch.Tensor      # f32[n] distance travelled, rounded to f32
    level: torch.Tensor  # u8[n] the level each sample marks, never falling
    n_fine: int          # the leading level-0 samples


@functools.lru_cache(maxsize=16)
def of_ladder(geom, mu: float, max_dist=None, device="cpu") -> Ladder:
    """The occupancy march's ladder on ``device``, built once per
    (geometry, mu, max_dist, device): :func:`ofusion_step_ladder`'s
    distances rounded to f32, as the twin's Python floats act on f32
    tensors, and its levels, of any length. To a card it goes by one
    asynchronous copy from pinned memory, so a frame step that builds it
    still reads nothing back."""
    band, max_dist = _of_schedule(geom, mu, max_dist)
    travelled, levels = ofusion_step_ladder(geom, band, max_dist)
    t = torch.tensor(travelled, dtype=torch.float32)
    level = torch.tensor(levels, dtype=torch.uint8)
    if torch.device(device).type == "cuda":
        t, level = (x.pin_memory().to(device, non_blocking=True)
                    for x in (t, level))
    return Ladder(t, level, levels.count(0))


def of_rays(geom, depth, stride: int, pose, kpose, mu: float, x_offset=0):
    """The occupancy march's rays of depth[::stride, ::stride]:
    :func:`pixel_rays` backed off by half the band, and each ray's
    distance from the camera to its origin (a sample counts while t is
    below it)."""
    band, _ = _of_schedule(geom, mu, None)
    origin, direction, valid = pixel_rays(depth, stride, pose, kpose,
                                          band * 0.5, x_offset)
    cx, cy, cz = (pose[i, 3] - origin[i] for i in range(3))
    return origin, direction, valid, torch.sqrt(cx * cx + cy * cy + cz * cz)


def touched_masks_of_plain(geom, depth, pose, kpose, mu: float,
                           max_dist=None, x_offset=0):
    """Plain PyTorch twin of :func:`touched_masks_of` (kpose = pose @
    invK), in the JAX form: one sample stack per level; ``depth`` is the
    window's columns, from image column ``x_offset``."""
    b = geom.blocks_per_side
    band, max_dist = _of_schedule(geom, mu, max_dist)
    travelled, sample_levels = ofusion_step_ladder(geom, band, max_dist)
    masks = []
    for lvl, stride in enumerate(_OF_STRIDES):
        side = b >> lvl
        flat = torch.zeros(side ** 3 + 1, dtype=torch.bool,
                           device=depth.device)
        origin, direction, valid, dist = of_rays(geom, depth, stride, pose,
                                                 kpose, mu, x_offset)
        for t, l in zip(travelled, sample_levels):
            if l == lvl and side > 0:
                _mark_plain(geom, flat, origin, direction, t, lvl,
                            valid & (t < dist))
        masks.append(flat[:-1].reshape(side, side, side))
    return tuple(masks)


def alloc_assign_plain(geom, state, touched, when=None, budget: int = None,
                       extra=(), owner=None, rank: int = 0):
    """Plain PyTorch twin of :func:`alloc_assign` (same in-place contract,
    and the grids likewise all zero on return).

    The bump allocator is JAX's ``allocate_blocks`` with a cumsum for its
    top_k. The mip refresh is incremental, as the kernel's:
    ``refresh_mip_alloc`` (JAX's dense rule) applied to this call's new
    blocks and ``extra`` octants alone. That equals the dense rule applied
    to every allocated block because ``mip_alloc`` >= broadcast(R(slot >=
    0)) holds before every call (R: the OR-reduce pyramid): slots are
    never freed, ``mip_alloc`` only grows, and each call covers its own new
    blocks (``tests/test_torch_map.py`` holds it over consecutive
    frames).
    """
    b, cap = geom.blocks_per_side, geom.capacity
    n_cells = b * b * b
    dev = touched.device
    kb = min(n_cells, ALLOC_BUDGET if budget is None else budget)
    grids = (touched,) + tuple(extra)
    if isinstance(owner, Owners):
        owner = owner_cells(b, owner, dev)
    if owner is not None:
        touched = touched & (owner == rank)
    if when is not None:
        touched = touched & when
        extra = tuple(e & when for e in extra)
    flat_new = (touched & (state.slot < 0)).reshape(-1)

    # ascending compaction of new cells into kb lanes (kb = empty lane)
    order = torch.cumsum(flat_new.to(torch.int32), 0) - 1
    lane = torch.where(flat_new & (order < kb), order,
                       torch.full_like(order, kb))
    cells = torch.full((kb + 1,), n_cells, dtype=torch.int32, device=dev)
    cells.index_copy_(0, lane.long(),
                      torch.arange(n_cells, dtype=torch.int32, device=dev))
    cells = cells[:kb]
    dest = state.n_blocks + torch.arange(kb, dtype=torch.int32, device=dev)
    ok = (cells < n_cells) & (dest < cap)
    new_cells, new_slots = cells[ok].long(), dest[ok]
    state.block_coord[new_slots.long()] = torch.stack(
        [new_cells // (b * b), (new_cells // b) % b, new_cells % b],
        -1).to(torch.int32)
    state.active[new_slots.long()] = True
    state.slot.view(-1)[new_cells] = new_slots
    n_new = torch.sum(ok.to(torch.int32))
    n_blocks = state.n_blocks + n_new
    state.n_blocks.copy_(n_blocks)

    # mark pre-existing touched blocks active too (ref alloc_impl.hpp:109)
    bc = state.block_coord.clamp(0, b - 1).long()
    tb = touched[bc[:, 0], bc[:, 1], bc[:, 2]]
    slot_ids = torch.arange(cap, dtype=torch.int32, device=dev)
    state.active.logical_or_(tb & (slot_ids < n_blocks))

    new = torch.zeros(n_cells, dtype=torch.bool, device=dev)
    new[new_cells] = True
    refresh_mip_alloc(geom, state, new.view(b, b, b),
                      extra_levels=(None,) + tuple(extra))
    overflow = torch.sum(flat_new.to(torch.int32)) - n_new
    for g in grids:  # consumed, as the kernel's
        g.zero_()
    return overflow
