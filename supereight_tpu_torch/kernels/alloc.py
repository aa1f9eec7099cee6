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

from supereight_tpu_torch.core import morton, se3
from supereight_tpu_torch.core.map import (refresh_mip_alloc, touched_grids,
                                           touched_size)
from supereight_tpu_torch.kernels import _lib

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


def _grids(geom, out, dev, levels):
    """The grids of levels 0 .. levels - 1 a march writes: views of
    ``out``, a touched buffer (checked)."""
    b = geom.blocks_per_side
    _lib.check(out, "out", torch.bool, (touched_size(b),), dev)
    return touched_grids(out, b, levels)


def _into(geom, out, grids):
    """A twin's grids stored into ``out``'s as the kernel's stores of 1
    do (an OR)."""
    views = _grids(geom, out, out.device, len(grids))
    for v, g in zip(views, grids):
        v.logical_or_(g)
    return views


def _window(depth, x0, width):
    """(x0, width) of a march's column window [x0, x0 + width) of
    ``depth`` (width None: to the frame's edge), checked."""
    w = depth.shape[1]
    width = w - x0 if width is None else width
    if not (0 <= x0 and 0 < width and x0 + width <= w):
        raise ValueError(f"march: columns [{x0}, {x0 + width}) are not "
                         f"inside a frame {w} wide")
    return x0, width


def touched_mask(geom, depth, pose, kpose, mu: float, out, x0=0,
                 width=None):
    """bool[B, B, B]: blocks crossed by the +/- 2 mu band around each
    sampled depth pixel (ref buildAllocationList,
    kfusion/alloc_impl.hpp:53-118). depth f32[H, W], pose [4, 4] and
    kpose = pose @ inverse_camera_matrix(k) [4, 4] (the frame's prologue,
    kernels/frame.frame_mats) on one device. ``out``: a touched buffer
    (the map's ``MapState.touched``, or ``core.map.touched_buffer``), all
    zero, whose level-0 grid the march writes and returns. ``width`` given
    marches only the columns [x0, x0 + width), in image coordinates (the
    sharded step's rank slice, JAX's ``x_offset``), counted as
    ``alloc_touch_cols``."""
    dev = depth.device
    x0, win = _window(depth, x0, width)
    if dev.type == "cpu":
        return _into(geom, out, (touched_mask_plain(
            geom, depth[:, x0:x0 + win], pose, kpose, mu, x0),))[0]
    if dev.type != "cuda":
        raise ValueError(f"touched_mask: unsupported device {dev}")
    h, w = depth.shape
    _lib.check(depth, "depth", torch.float32, (h, w), dev)
    _lib.check(pose, "pose", torch.float32, (4, 4), dev)
    _lib.check(kpose, "kpose", torch.float32, (4, 4), dev)
    b = geom.blocks_per_side
    band, num_steps, step = band_schedule(geom, mu)
    touched = _grids(geom, out, dev, 1)[0]
    _lib.launch("alloc_touch" if width is None else "alloc_touch_cols",
                "se_alloc_touch", dev, depth, h, w, x0, win, _STRIDE,
                kpose, pose, band * 0.5, step, num_steps,
                geom.inv_voxel_size, geom.size, b, touched)
    return touched


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


def touched_masks_of(geom, depth, pose, kpose, mu: float, out,
                     max_dist=None, x0=0, width=None):
    """(bool[B]^3, bool[B/2]^3, bool[B/4]^3): the octants of levels 0-2
    that the occupancy march touches (ref buildOctantList,
    bfusion/alloc_impl.hpp:53-129). Level-0 samples come from every 2x2
    pixel, level 1-2 samples from every 8x8 pixel. depth f32[H, W],
    pose [4, 4] and kpose = pose @ inverse_camera_matrix(k) on one device.
    The three grids are views of ``out``, a touched buffer (the map's
    ``MapState.touched``, or ``core.map.touched_buffer``), all zero.
    ``width`` given marches only the columns [x0, x0 + width) as
    :func:`touched_mask` does, counted as ``alloc_touch_of_cols``."""
    dev = depth.device
    x0, win = _window(depth, x0, width)
    if dev.type == "cpu":
        return _into(geom, out, touched_masks_of_plain(
            geom, depth[:, x0:x0 + win], pose, kpose, mu, max_dist, x0))
    if dev.type != "cuda":
        raise ValueError(f"touched_masks_of: unsupported device {dev}")
    h, w = depth.shape
    _lib.check(depth, "depth", torch.float32, (h, w), dev)
    _lib.check(pose, "pose", torch.float32, (4, 4), dev)
    _lib.check(kpose, "kpose", torch.float32, (4, 4), dev)
    band, _ = _of_schedule(geom, mu, max_dist)
    ladder = of_ladder(geom, mu, max_dist, dev)
    masks = _grids(geom, out, dev, 3)
    _lib.launch("alloc_touch_of" if width is None else "alloc_touch_of_cols",
                "se_alloc_touch_of", dev, depth, h, w, x0, win, kpose, pose, band * 0.5, ladder.t, ladder.level,
                ladder.t.numel(), ladder.n_fine, geom.inv_voxel_size,
                geom.size, geom.blocks_per_side, *masks)
    return masks


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


def alloc_assign(geom, state, touched, when=None, budget: int = None,
                 extra=(), owner=None, rank: int = 0):
    """Allocate every block whose flag is set in the [B,B,B] ``touched``
    grid (ref octree.hpp:792-856) and refresh ``mip_alloc``, IN PLACE.

    New cells take pool slots in ascending cell-id order, bump-allocated
    from ``n_blocks``, at most ``budget`` (default ALLOC_BUDGET) of them
    and up to capacity; touched pre-existing blocks are re-activated.
    ``extra`` holds OFusion's coarse octants touched at levels 1, 2, ...
    (bool[B>>l]^3; levels past the pyramid's top are ignored). ``when``
    (bool[] tensor) masks every grid. ``owner`` (the sharded step's
    :class:`Owners`) keeps only the touched cells that it gives to
    ``rank``, for allocation and re-activation alike (JAX's ``touched &
    (own == idx)``, ``dist_step.py:313``), counted as
    ``alloc_assign_owned``; ``extra`` is not masked by it. The kernel
    computes each cell's owner and reads no grid. The twin also takes an
    i32[B, B, B] owner grid (``parallel/dist_step.owner_grid``), on the
    CPU only: that form is there for the mode-B parity test of
    ``tests/test_torch_dist.py``, which predates :class:`Owners`.
    Returns alloc_overflow (i32[]): the new cells left unallocated. One
    launch, no host sync.

    The grids are consumed: ``touched`` and every ``extra`` grid are all
    zero on return, whatever ``when`` says (the kernel clears what it
    reads), so the map's touched buffer starts the next frame zeroed.
    """
    dev = touched.device
    if isinstance(owner, Owners):
        _check_owners(owner)
        if not 0 <= rank < owner.world:
            raise ValueError(f"alloc_assign: rank {rank} of {owner.world}")
    if dev.type == "cpu":
        return alloc_assign_plain(geom, state, touched, when, budget, extra,
                                  owner, rank)
    if dev.type != "cuda":
        raise ValueError(f"alloc_assign: unsupported device {dev}")
    if owner is not None and not isinstance(owner, Owners):
        raise TypeError("alloc_assign: the kernel computes each cell's "
                        "owner; pass Owners(world), not an owner grid")
    b, nl, cap = geom.blocks_per_side, geom.num_levels, geom.capacity
    if nl > _lib.MAX_MIP_LEVELS or len(extra) > 2:
        raise ValueError(f"alloc_assign: {nl} mip levels and {len(extra)} "
                         f"extra levels; the kernel takes "
                         f"{_lib.MAX_MIP_LEVELS} and 2")
    c = _lib.check
    c(touched, "touched", torch.bool, (b, b, b), dev)
    for t, name in ((touched, "touched"), (state.slot, "slot")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads it 16 bytes at a "
                             f"time and needs it 16-byte aligned")
    # a level at or past nl has no cell (b >> l == 0): nothing to mark or
    # clear there
    ext = [c(e, "extra", torch.bool, (b >> lvl,) * 3, dev)
           if lvl < nl else None for lvl, e in enumerate(extra, start=1)]
    ext += [None] * (2 - len(ext))
    if when is not None:
        when = c(when.reshape(()), "when", torch.bool, (), dev)
    c(state.slot, "slot", torch.int32, (b, b, b), dev)
    c(state.block_coord, "block_coord", torch.int32, (cap, 3), dev)
    c(state.active, "active", torch.bool, (cap,), dev)
    c(state.n_blocks, "n_blocks", torch.int32, (), dev)
    mips = _lib.Mips()
    for lvl in range(nl):
        mips.alloc[lvl] = c(state.mip_alloc[lvl], "mip_alloc", torch.bool,
                            (b >> lvl,) * 3, dev).data_ptr()
        if lvl < nl - 1 and mips.alloc[lvl] % 2:
            raise ValueError("mip_alloc: the kernel marks two bytes a store "
                             "and needs each level below the top 2-byte "
                             "aligned")
    kb = min(b ** 3, ALLOC_BUDGET if budget is None else budget)
    overflow = torch.empty((), dtype=torch.int32, device=dev)
    world = 0 if owner is None else owner.world
    _lib.launch("alloc_assign" if owner is None else "alloc_assign_owned",
                "se_alloc_assign", dev, touched, *ext, when, world,
                int(rank), b, nl, cap, kb, state.slot, state.block_coord,
                state.active, state.n_blocks, overflow, mips)
    return overflow


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
