"""K3 wrapper and twin: the integration block pass of both fields.

Replaces the block pass of ``supereight_tpu/ops/integration.py:integrate``
(286-375) with ``_project_voxels_c`` (78-94), ``_sample_depth_patch``
(123-213, the depth-level rule), the exact fallback for the first 32
uncovered blocks (340-356) and ``_field_update`` (273-279). The CUDA
kernels are the two launches of ``csrc/integrate.cu``
(:func:`integrate_prepass`, :func:`integrate_update`, whose field update
is the TSDF or the OFusion one) with a cumsum between them
(:func:`integrate_blocks`). Each has its plain PyTorch version
(``*_plain``), used for CPU tensors and as the kernel's reference on the
card.

The update writes ``data_x``, ``data_y`` and ``active`` of the map IN
PLACE. The OFusion update's timestamp is a device f32[] (the fused step
computes it from the frame tensor), so no launch reads it on the host.
"""

import torch

from supereight_tpu_torch.constants import BLOCK_SIDE, BLOCK_VOXELS, MAX_WEIGHT
from supereight_tpu_torch.core import se3
from supereight_tpu_torch.core.map import scatter_drop
from supereight_tpu_torch.fields import ofusion as ofusion_field
from supereight_tpu_torch.fields import tsdf as tsdf_field
from supereight_tpu_torch.kernels import _lib

# depth-patch levels of the JAX rule and the bound on blocks taking the
# exact per-pixel fallback per frame
PATCH_LEVELS = 3
FALLBACK_BLOCKS = 32


def patch_levels(h: int, w: int) -> int:
    """Number of depth mip levels the JAX patch read can use: a level is
    usable while its mip is >= 16 rows and >= 3 eight-pixel strips wide
    (JAX integration.py:156-161)."""
    n = 0
    for lv in range(PATCH_LEVELS):
        hl = -(-h // (1 << lv))
        wl = -(-w // (1 << lv))
        if hl < 16 or (wl + 7) // 8 < 3:
            break
        n += 1
    return n


def _fallback_mode(level, need, n_valid, budget):
    """Per-block depth mode from the prepass: the covered level, else 0
    (exact pixel) for the first FALLBACK_BLOCKS uncovered blocks in
    worklist order, else -1 (skip). Returns (mode, patch_skipped)."""
    rank = torch.cumsum(need.to(torch.int32), 0) - 1
    fb = need & (rank < min(FALLBACK_BLOCKS, budget))
    mode = torch.where(level >= 0, level,
                       torch.where(fb, torch.zeros_like(level),
                                   torch.full_like(level, -1)))
    skipped = need & ~fb
    return mode, torch.sum(torch.where(skipped, n_valid,
                                       torch.zeros_like(n_valid)))


def field_update(field, old_x, old_y, pos_cam, depth_sample, valid, mu,
                 timestamp, voxel_size):
    """The field's fusion functor (JAX integration.py:273-279)."""
    if field.name == "tsdf":
        return tsdf_field.update(old_x, old_y, pos_cam, depth_sample, mu,
                                 valid)
    return ofusion_field.update(old_x, old_y, pos_cam, depth_sample, mu,
                                timestamp, voxel_size, valid)


def integrate_blocks(geom, state, field, worklist, depth, t_cw, kmat,
                     mu: float, timestamp=None):
    """Fuse ``depth`` into every block of ``worklist`` (i32[budget] slots,
    entries == capacity are empty), in place. ``t_cw`` is world-to-camera
    [4, 4], ``kmat`` the 4x4 intrinsics, ``timestamp`` the f32[] time the
    OFusion update writes. Returns patch_skipped (i32[]): valid voxels of
    uncovered blocks beyond the fallback bound."""
    level, n_valid, need = integrate_prepass(geom, state, worklist, depth,
                                             t_cw, kmat)
    mode, skipped = _fallback_mode(level, need, n_valid, worklist.shape[0])
    integrate_update(geom, state, field, worklist, depth, t_cw, kmat, mu,
                     mode, timestamp)
    return skipped.to(torch.int32)


def _check_block_args(geom, state, worklist, depth, t_cw, kmat):
    dev = depth.device
    cap = geom.capacity
    c = _lib.check
    c(worklist, "worklist", torch.int32, (worklist.shape[0],), dev)
    c(depth, "depth", torch.float32, tuple(depth.shape), dev)
    c(t_cw, "t_cw", torch.float32, (4, 4), dev)
    c(kmat, "kmat", torch.float32, (4, 4), dev)
    c(state.block_coord, "block_coord", torch.int32, (cap, 3), dev)
    c(state.data_x, "data_x", torch.float32, (cap, BLOCK_VOXELS), dev)
    c(state.data_y, "data_y", torch.float32, (cap, BLOCK_VOXELS), dev)
    c(state.active, "active", torch.bool, (cap,), dev)


def integrate_prepass(geom, state, worklist, depth, t_cw, kmat):
    """Per worklist block: (level i32 — the covered depth level, -1 when
    the bbox is too big for every level —, n_valid i32, need bool —
    uncovered with valid voxels)."""
    dev = depth.device
    if dev.type == "cpu":
        return integrate_prepass_plain(geom, state, worklist, depth, t_cw,
                                       kmat)
    if dev.type != "cuda":
        raise ValueError(f"integrate_prepass: unsupported device {dev}")
    _check_block_args(geom, state, worklist, depth, t_cw, kmat)
    h, w = depth.shape
    n_work = worklist.shape[0]
    level = torch.zeros(n_work, dtype=torch.int32, device=dev)
    n_valid = torch.zeros(n_work, dtype=torch.int32, device=dev)
    need = torch.zeros(n_work, dtype=torch.bool, device=dev)
    if n_work:
        _lib.launch("integrate_prepass", "se_integrate_prepass", dev,
                    worklist, n_work, geom.capacity,
                    state.block_coord, t_cw, kmat, geom.voxel_size,
                    w, h, patch_levels(h, w), level, n_valid, need)
    return level, n_valid, need


def as_timestamp(field, timestamp, dev):
    """The f32[] time stamp the OFusion update writes, on ``dev``: the
    given tensor, or a zero for TSDF, which does not read it."""
    if timestamp is None:
        if field.name != "tsdf":
            raise ValueError("the OFusion update needs a timestamp tensor")
        return torch.zeros((), dtype=torch.float32, device=dev)
    return timestamp.to(device=dev, dtype=torch.float32).reshape(())


def integrate_update(geom, state, field, worklist, depth, t_cw, kmat,
                     mu: float, mode, timestamp=None):
    """Fuse each worklist block at its depth ``mode`` (i32: level, -1 =
    skip) with ``field``'s update in place, and set its active flag to
    (any voxel valid). The launch count is kept per field
    (``integrate_update`` for TSDF, ``integrate_update_of``)."""
    dev = depth.device
    if dev.type == "cpu":
        return integrate_update_plain(geom, state, field, worklist, depth,
                                      t_cw, kmat, mu, mode, timestamp)
    if dev.type != "cuda":
        raise ValueError(f"integrate_update: unsupported device {dev}")
    _check_block_args(geom, state, worklist, depth, t_cw, kmat)
    _lib.check(mode, "mode", torch.int32, worklist.shape, dev)
    ts = as_timestamp(field, timestamp, dev)
    h, w = depth.shape
    n_work = worklist.shape[0]
    of = field.name == "ofusion"
    if n_work:
        _lib.launch("integrate_update_of" if of else "integrate_update",
                    "se_integrate_update", dev,
                    worklist, n_work, geom.capacity,
                    state.block_coord, t_cw, kmat, geom.voxel_size,
                    w, h, mode, depth, int(of), float(mu), float(MAX_WEIGHT),
                    2.0 * geom.voxel_size, ts, state.data_x, state.data_y,
                    state.active)


def project_voxels(wx, wy, wz, t_cw, kmat, frame_size):
    """Camera-frame position, pixel coords and validity of sample points
    (update_block's projection, projective_functor.hpp:85-103): pixel =
    K pos / z + 0.5, valid when z >= 1e-4 and pixel in [0.5, size-1.5]."""
    w, h = frame_size
    cx, cy, cz = se3.transform_c(t_cw, wx, wy, wz)
    kx, ky, kz = se3.transform_c(kmat, cx, cy, cz)
    safe = torch.where(kz == 0, torch.full_like(kz, 1e-12), kz)
    px = kx / safe + 0.5
    py = ky / safe + 0.5
    valid = ((cz >= 1e-4) & (px >= 0.5) & (px <= w - 1.5)
             & (py >= 0.5) & (py <= h - 1.5))
    return (cx, cy, cz), px, py, valid


def _project_blocks(geom, state, worklist, depth, t_cw, kmat):
    """[budget, 512] voxel projection of the worklist blocks: (slots,
    present, camera pos, xi, yi, valid)."""
    cap = geom.capacity
    dev = depth.device
    h, w = depth.shape
    present = worklist < cap
    slots = worklist.clamp(max=cap - 1).long()
    lin = torch.arange(BLOCK_VOXELS, dtype=torch.int32, device=dev)
    bc = state.block_coord[slots]
    vs = geom.voxel_size
    wx = (bc[:, 0:1] * BLOCK_SIDE + (lin & 7)).to(torch.float32) * vs
    wy = (bc[:, 1:2] * BLOCK_SIDE + ((lin >> 3) & 7)).to(torch.float32) * vs
    wz = (bc[:, 2:3] * BLOCK_SIDE + (lin >> 6)).to(torch.float32) * vs
    pos, px, py, valid = project_voxels(wx, wy, wz, t_cw, kmat, (w, h))
    xi = px.to(torch.int32).clamp(0, w - 1)
    yi = py.to(torch.int32).clamp(0, h - 1)
    return slots, present, pos, xi, yi, valid & present[:, None]


def integrate_prepass_plain(geom, state, worklist, depth, t_cw, kmat):
    """Plain PyTorch twin of :func:`integrate_prepass`."""
    h, w = depth.shape
    _, _, _, xi, yi, valid = _project_blocks(geom, state, worklist, depth,
                                             t_cw, kmat)
    # block pixel bbox over valid voxels -> depth level (JAX rule)
    big = 1 << 20
    x0 = torch.where(valid, xi, big).amin(1)
    x1 = torch.where(valid, xi, -1).amax(1)
    y0 = torch.where(valid, yi, big).amin(1)
    y1 = torch.where(valid, yi, -1).amax(1)
    dx, dy = x1 - x0, y1 - y0
    n_lv = patch_levels(h, w)
    lvl = torch.zeros_like(dx)
    for i in range(1, n_lv):
        lvl = torch.where((dx > (24 << (i - 1))) | (dy > (15 << (i - 1))),
                          i, lvl)
    if n_lv > 0:
        covered = (dx <= (24 << (n_lv - 1))) & (dy <= (15 << (n_lv - 1)))
    else:
        covered = torch.zeros_like(dx, dtype=torch.bool)
    n_valid = valid.sum(1, dtype=torch.int32)
    level = torch.where(covered, lvl, -1).to(torch.int32)
    return level, n_valid, ~covered & (n_valid > 0)


def integrate_update_plain(geom, state, field, worklist, depth, t_cw, kmat,
                           mu: float, mode, timestamp=None):
    """Plain PyTorch twin of :func:`integrate_update` (same in-place
    contract)."""
    cap = geom.capacity
    w = depth.shape[1]
    slots, present, pos, xi, yi, valid = _project_blocks(
        geom, state, worklist, depth, t_cw, kmat)
    l = mode.clamp(min=0)[:, None]
    ds = depth.reshape(-1)[(((yi >> l) << l) * w + ((xi >> l) << l)).long()]
    valid = valid & (mode >= 0)[:, None]
    new_x, new_y, _ = field_update(
        field, state.data_x[slots], state.data_y[slots], pos, ds, valid, mu,
        as_timestamp(field, timestamp, depth.device), geom.voxel_size)
    dest = torch.where(present, worklist, cap)
    scatter_drop(state.data_x, dest, new_x)
    scatter_drop(state.data_y, dest, new_y)
    # block stays active iff any voxel projected into the frame
    scatter_drop(state.active, dest, valid.any(1))


def integrate_blocks_plain(geom, state, field, worklist, depth, t_cw, kmat,
                           mu: float, timestamp=None):
    """Plain PyTorch twin of :func:`integrate_blocks`."""
    level, n_valid, need = integrate_prepass_plain(geom, state, worklist,
                                                   depth, t_cw, kmat)
    mode, skipped = _fallback_mode(level, need, n_valid, worklist.shape[0])
    integrate_update_plain(geom, state, field, worklist, depth, t_cw, kmat,
                           mu, mode, timestamp)
    return skipped.to(torch.int32)
