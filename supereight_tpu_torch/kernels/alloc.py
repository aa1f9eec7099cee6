"""K5 wrappers and twins: the allocation marches of both fields.

:func:`touched_mask` replaces
``supereight_tpu/ops/allocation.py:tsdf_touched_mask`` (75-115) and
:func:`touched_masks_of` replaces ``ofusion_touched_masks`` (148-214,
with the static ``ofusion_step_ladder``, 118-145); both use
``_pixel_rays_c_sub`` (32-58) and ``_touched_cell_ids`` (61-72). The CUDA
kernels are in ``csrc/alloc.cu``. The ``*_plain`` functions are the plain
PyTorch versions, used for CPU tensors and as the kernels' reference on
the card. The TPU's dedup of repeated samples was a scatter-cost trick
and is not carried over: it changes no touched flag.
"""

import math

import torch

from supereight_tpu_torch.core import se3
from supereight_tpu_torch.kernels import _lib

_STRIDE = 2  # pixels are sampled 2x2 (JAX tsdf_touched_mask)


def band_schedule(geom, mu: float):
    """(band, num_steps, step) of the +/- 2 mu band march: samples every
    ~3 voxels (JAX allocation.py:88-97)."""
    band = 2.0 * mu
    num_steps = int(math.ceil(band * geom.inv_voxel_size / 3.0))
    return band, num_steps, band / num_steps


def touched_mask(geom, depth, pose, k, mu: float):
    """bool[B, B, B]: blocks crossed by the +/- 2 mu band around each
    sampled depth pixel (ref buildAllocationList,
    kfusion/alloc_impl.hpp:53-118). depth f32[H, W], pose [4, 4] and k [4]
    on one device."""
    dev = depth.device
    kpose = se3.matmul4(pose, se3.inverse_camera_matrix(k))
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


def touched_masks_of(geom, depth, pose, k, mu: float, max_dist=None):
    """(bool[B]^3, bool[B/2]^3, bool[B/4]^3): the octants of levels 0-2
    that the occupancy march touches (ref buildOctantList,
    bfusion/alloc_impl.hpp:53-129). Level-0 samples come from every 2x2
    pixel, level 1-2 samples from every 8x8 pixel. depth f32[H, W],
    pose [4, 4] and k [4] on one device."""
    dev = depth.device
    kpose = se3.matmul4(pose, se3.inverse_camera_matrix(k))
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
    masks = [torch.zeros((b >> l,) * 3, dtype=torch.bool, device=dev)
             for l in range(3)]
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
