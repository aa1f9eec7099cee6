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
"""

import math

import torch

from supereight_tpu_torch.core import se3
from supereight_tpu_torch.core.map import refresh_mip_alloc
from supereight_tpu_torch.kernels import _lib

# per-frame bound on NEW block allocations (the JAX package's value).
# Overflow cells stay unallocated and are re-touched on later frames.
ALLOC_BUDGET = 8192

_STRIDE = 2  # pixels are sampled 2x2 (JAX tsdf_touched_mask)


def band_schedule(geom, mu: float):
    """(band, num_steps, step) of the +/- 2 mu band march: samples every
    ~3 voxels (JAX allocation.py:88-97)."""
    band = 2.0 * mu
    num_steps = int(math.ceil(band * geom.inv_voxel_size / 3.0))
    return band, num_steps, band / num_steps


def touched_mask(geom, depth, pose, kpose, mu: float):
    """bool[B, B, B]: blocks crossed by the +/- 2 mu band around each
    sampled depth pixel (ref buildAllocationList,
    kfusion/alloc_impl.hpp:53-118). depth f32[H, W], pose [4, 4] and
    kpose = pose @ inverse_camera_matrix(k) [4, 4] (the frame's prologue,
    kernels/frame.frame_mats) on one device."""
    dev = depth.device
    if dev.type == "cpu":
        return touched_mask_plain(geom, depth, pose, kpose, mu)
    if dev.type != "cuda":
        raise ValueError(f"touched_mask: unsupported device {dev}")
    h, w = depth.shape
    _lib.check(depth, "depth", torch.float32, (h, w), dev)
    _lib.check(pose, "pose", torch.float32, (4, 4), dev)
    _lib.check(kpose, "kpose", torch.float32, (4, 4), dev)
    b = geom.blocks_per_side
    band, num_steps, step = band_schedule(geom, mu)
    touched = torch.zeros((b, b, b), dtype=torch.bool, device=dev)
    _lib.launch("alloc_touch", "se_alloc_touch", dev, depth, h, w, _STRIDE,
                kpose, pose, band * 0.5, step, num_steps,
                geom.inv_voxel_size, geom.size, b, touched)
    return touched


def touched_mask_plain(geom, depth, pose, kpose, mu: float):
    """Plain PyTorch twin of :func:`touched_mask` (kpose = pose @ invK)."""
    b = geom.blocks_per_side
    dev = depth.device
    band, num_steps, step = band_schedule(geom, mu)
    d = depth[::_STRIDE, ::_STRIDE]
    hs, ws = d.shape
    xs = torch.arange(ws, dtype=torch.float32, device=dev) * _STRIDE + 0.5
    ys = torch.arange(hs, dtype=torch.float32, device=dev) * _STRIDE + 0.5
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    wvx, wvy, wvz = se3.transform_c(kpose, px * d, py * d, d)
    dx, dy, dz = pose[0, 3] - wvx, pose[1, 3] - wvy, pose[2, 3] - wvz
    norm = torch.sqrt(dx * dx + dy * dy + dz * dz)
    inv = 1.0 / torch.where(norm == 0, torch.ones_like(norm), norm)
    dx, dy, dz = dx * inv, dy * inv, dz * inv
    # a Python float scalar acts as its f32 rounding, like a JAX constant
    half = band * 0.5
    ox, oy, oz = wvx - half * dx, wvy - half * dy, wvz - half * dz
    valid = d > 0
    iv = geom.inv_voxel_size
    size = geom.size
    flat = torch.zeros(b * b * b + 1, dtype=torch.bool, device=dev)
    for i in range(num_steps):
        t = i * step
        vx = torch.floor((ox + dx * t) * iv).to(torch.int32)
        vy = torch.floor((oy + dy * t) * iv).to(torch.int32)
        vz = torch.floor((oz + dz * t) * iv).to(torch.int32)
        inb = ((vx >= 0) & (vx < size) & (vy >= 0) & (vy < size)
               & (vz >= 0) & (vz < size)) & valid
        ids = ((vx >> 3) * b + (vy >> 3)) * b + (vz >> 3)
        flat.index_fill_(0, torch.where(inb, ids, b * b * b).long()
                         .reshape(-1), True)
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


def touched_masks_of(geom, depth, pose, kpose, mu: float, max_dist=None):
    """(bool[B]^3, bool[B/2]^3, bool[B/4]^3): the octants of levels 0-2
    that the occupancy march touches (ref buildOctantList,
    bfusion/alloc_impl.hpp:53-129). Level-0 samples come from every 2x2
    pixel, level 1-2 samples from every 8x8 pixel. depth f32[H, W],
    pose [4, 4] and kpose = pose @ inverse_camera_matrix(k) on one device.
    The three grids are views of one buffer, zeroed by one fill."""
    dev = depth.device
    if dev.type == "cpu":
        return touched_masks_of_plain(geom, depth, pose, kpose, mu, max_dist)
    if dev.type != "cuda":
        raise ValueError(f"touched_masks_of: unsupported device {dev}")
    h, w = depth.shape
    _lib.check(depth, "depth", torch.float32, (h, w), dev)
    _lib.check(pose, "pose", torch.float32, (4, 4), dev)
    _lib.check(kpose, "kpose", torch.float32, (4, 4), dev)
    b = geom.blocks_per_side
    band, max_dist = _of_schedule(geom, mu, max_dist)
    sizes = [(b >> lvl) ** 3 for lvl in range(3)]
    flat = torch.zeros(sum(sizes), dtype=torch.bool, device=dev)
    masks = [g.view((b >> lvl,) * 3)
             for lvl, g in enumerate(torch.split(flat, sizes))]
    _lib.launch("alloc_touch_of", "se_alloc_touch_of", dev, depth, h, w,
                kpose, pose, band * 0.5, band, geom.voxel_size, max_dist,
                geom.inv_voxel_size, geom.size, b, *masks)
    return tuple(masks)


def touched_masks_of_plain(geom, depth, pose, kpose, mu: float,
                           max_dist=None):
    """Plain PyTorch twin of :func:`touched_masks_of` (kpose = pose @
    invK), in the JAX form: one sample stack per level."""
    b = geom.blocks_per_side
    dev = depth.device
    band, max_dist = _of_schedule(geom, mu, max_dist)
    travelled, sample_levels = ofusion_step_ladder(geom, band, max_dist)
    iv = geom.inv_voxel_size
    size = geom.size
    half = band * 0.5
    masks = []
    for lvl, stride in enumerate(_OF_STRIDES):
        side = b >> lvl
        flat = torch.zeros(side ** 3 + 1, dtype=torch.bool, device=dev)
        d = depth[::stride, ::stride]
        hs, ws = d.shape
        xs = torch.arange(ws, dtype=torch.float32, device=dev) * stride + 0.5
        ys = torch.arange(hs, dtype=torch.float32, device=dev) * stride + 0.5
        py, px = torch.meshgrid(ys, xs, indexing="ij")
        wvx, wvy, wvz = se3.transform_c(kpose, px * d, py * d, d)
        dx, dy, dz = pose[0, 3] - wvx, pose[1, 3] - wvy, pose[2, 3] - wvz
        norm = torch.sqrt(dx * dx + dy * dy + dz * dz)
        inv = 1.0 / torch.where(norm == 0, torch.ones_like(norm), norm)
        dx, dy, dz = dx * inv, dy * inv, dz * inv
        ox, oy, oz = wvx - half * dx, wvy - half * dy, wvz - half * dz
        cx, cy, cz = pose[0, 3] - ox, pose[1, 3] - oy, pose[2, 3] - oz
        dist = torch.sqrt(cx * cx + cy * cy + cz * cz)
        valid = d > 0
        shift = 3 + lvl
        for t, l in zip(travelled, sample_levels):
            if l != lvl or side == 0:
                continue
            vx = torch.floor((ox + dx * t) * iv).to(torch.int32)
            vy = torch.floor((oy + dy * t) * iv).to(torch.int32)
            vz = torch.floor((oz + dz * t) * iv).to(torch.int32)
            inb = ((vx >= 0) & (vx < size) & (vy >= 0) & (vy < size)
                   & (vz >= 0) & (vz < size)) & valid & (t < dist)
            ids = ((vx >> shift) * side + (vy >> shift)) * side \
                + (vz >> shift)
            flat.index_fill_(0, torch.where(inb, ids, side ** 3).long()
                             .reshape(-1), True)
        masks.append(flat[:-1].reshape(side, side, side))
    return tuple(masks)


def alloc_assign(geom, state, touched, when=None, budget: int = None,
                 extra=()):
    """Allocate every block whose flag is set in the [B,B,B] ``touched``
    grid (ref octree.hpp:792-856) and refresh ``mip_alloc``, IN PLACE.

    New cells take pool slots in ascending cell-id order, bump-allocated
    from ``n_blocks``, at most ``budget`` (default ALLOC_BUDGET) of them
    and up to capacity; touched pre-existing blocks are re-activated.
    ``extra`` holds OFusion's coarse octants touched at levels 1, 2, ...
    (bool[B>>l]^3; levels past the pyramid's top are ignored). ``when``
    (bool[] tensor) masks every grid. Returns alloc_overflow (i32[]): the
    new cells left unallocated. One launch, no host sync.
    """
    dev = touched.device
    if dev.type == "cpu":
        return alloc_assign_plain(geom, state, touched, when, budget, extra)
    if dev.type != "cuda":
        raise ValueError(f"alloc_assign: unsupported device {dev}")
    b, nl, cap = geom.blocks_per_side, geom.num_levels, geom.capacity
    if nl > _lib.MAX_MIP_LEVELS or len(extra) > 2:
        raise ValueError(f"alloc_assign: {nl} mip levels and {len(extra)} "
                         f"extra levels; the kernel takes "
                         f"{_lib.MAX_MIP_LEVELS} and 2")
    c = _lib.check
    c(touched, "touched", torch.bool, (b, b, b), dev)
    if touched.data_ptr() % 16:
        raise ValueError("touched: the kernel reads it 16 bytes at a time "
                         "and needs it 16-byte aligned")
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
    kb = min(b ** 3, ALLOC_BUDGET if budget is None else budget)
    overflow = torch.empty((), dtype=torch.int32, device=dev)
    _lib.launch("alloc_assign", "se_alloc_assign", dev, touched, *ext, when,
                b, nl, cap, kb, state.slot, state.block_coord, state.active,
                state.n_blocks, overflow, mips)
    return overflow


def alloc_assign_plain(geom, state, touched, when=None, budget: int = None,
                       extra=()):
    """Plain PyTorch twin of :func:`alloc_assign` (same in-place contract).

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
    return torch.sum(flat_new.to(torch.int32)) - n_new
