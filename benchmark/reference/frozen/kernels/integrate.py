"""K3 wrappers and twins: the integration block pass of both fields.

Replaces the block pass of ``supereight_tpu/ops/integration.py:integrate``
(286-375) with ``build_active_worklist`` (60-75) and ``in_frustum_mask``
(44-57), ``_project_voxels_c`` (78-94), ``_sample_depth_patch`` (123-213,
the depth-level rule), the exact fallback for the first 32 uncovered
blocks (340-356), ``_sample_depth_bilinear`` (229-270, the
``depth_interp`` read) and ``_field_update`` (273-279, with the TSDF
``noise_weighted`` weight). The CUDA kernels are the three launches of
``csrc/integrate.cu``: :func:`integrate_worklist`, then
:func:`integrate_fused` and :func:`integrate_fallback`, which
:func:`integrate_blocks` makes in turn (the bilinear read has no level
rule and no fallback: two launches). Each has its plain PyTorch version
(``*_plain``), used for CPU tensors and as the kernel's reference on the
card. A launch is counted under its kernel and mode: ``integrate_fused``
with ``_of`` for OFusion, ``_noise`` for the TSDF ``noise_weighted``
update and ``_bilinear`` for the bilinear read (``fused_name``,
``fallback_name``).

The fused pass runs on a grid of the CTAs the card holds at once, never
more than the worklist's entries: CTA c takes the entries c, c + G, ...,
an empty entry costs its thread one load and three stores, and the listed
blocks are fused one at a time by the whole CTA (512 threads, one a
voxel). So a worklist far longer than the blocks it lists, the class
pipeline's bucket of 49,152, costs about what its listed blocks do. The
fallback's min(32, budget) CTAs each rank the ``need`` flags in 16-byte
words (``need`` 16-byte aligned, as a fresh tensor is).

The fused and fallback passes write ``data_x``, ``data_y`` and ``active``
of the map IN PLACE. The OFusion update's timestamp is a device f32[] (the
fused step computes it from the frame tensor), so no launch reads it on
the host.
"""

import torch

from benchmark.reference.frozen.constants import BLOCK_SIDE, BLOCK_VOXELS, MAX_WEIGHT
from benchmark.reference.frozen.core import se3
from benchmark.reference.frozen.fields import ofusion as ofusion_field
from benchmark.reference.frozen.fields import tsdf as tsdf_field

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


def field_update(field, old_x, old_y, pos_cam, depth_sample, valid, mu,
                 timestamp, voxel_size, noise_weighted=False):
    """The field's fusion functor (JAX integration.py:273-279); OFusion
    ignores ``noise_weighted``."""
    if field.name == "tsdf":
        return tsdf_field.update(old_x, old_y, pos_cam, depth_sample, mu,
                                 valid, noise_weighted)
    return ofusion_field.update(old_x, old_y, pos_cam, depth_sample, mu,
                                timestamp, voxel_size, valid)


def fused_name(field, noise_weighted=False, bilinear=False) -> str:
    """The launch count of :func:`integrate_fused` in this mode."""
    of = field.name == "ofusion"
    return ("integrate_fused" + ("_of" if of else "")
            + ("_noise" if noise_weighted and not of else "")
            + ("_bilinear" if bilinear else ""))


def fallback_name(field, noise_weighted=False) -> str:
    """The launch count of :func:`integrate_fallback` in this mode."""
    of = field.name == "ofusion"
    return ("integrate_fallback" + ("_of" if of else "")
            + ("_noise" if noise_weighted and not of else ""))


def as_timestamp(field, timestamp, dev):
    """The f32[] time stamp the OFusion update writes, on ``dev``: the
    given tensor, or a zero for TSDF, which does not read it."""
    if timestamp is None:
        if field.name != "tsdf":
            raise ValueError("the OFusion update needs a timestamp tensor")
        return torch.zeros((), dtype=torch.float32, device=dev)
    return timestamp.to(device=dev, dtype=torch.float32).reshape(())


# ---- the worklist --------------------------------------------------------

def in_frustum_mask(geom, state, t_cw, kmat, frame_size):
    """Per-slot frustum predicate (ref algorithms::in_frustum,
    filter.hpp:37-49): project the block's origin corner."""
    w, h = frame_size
    scale = BLOCK_SIDE * geom.voxel_size
    o = state.block_coord.to(torch.float32) * scale
    cx, cy, cz = se3.transform_c(t_cw, o[:, 0], o[:, 1], o[:, 2])
    px_, py_, pz_ = se3.transform_c(kmat, cx, cy, cz)
    z = torch.where(pz_ == 0, torch.full_like(pz_, 1e-12), pz_)
    px = (px_ / z).to(torch.int32)
    py = (py_ / z).to(torch.int32)
    return (z > 0) & (px >= 0) & (px < w) & (py >= 0) & (py < h)


def integrate_worklist_plain(geom, state, t_cw, kmat, frame_size,
                             budget: int, when=None):
    """Plain PyTorch twin of :func:`integrate_worklist`."""
    cap = geom.capacity
    dev = state.active.device
    slot_ids = torch.arange(cap, dtype=torch.int32, device=dev)
    mask = ((slot_ids < state.n_blocks) & state.active
            & in_frustum_mask(geom, state, t_cw, kmat, frame_size))
    n_active = torch.sum(mask.to(torch.int32))
    truncated = torch.clamp(n_active - budget, min=0)
    if when is not None:
        mask = mask & when
        truncated = torch.where(when, truncated, 0)
    order = torch.cumsum(mask.to(torch.int32), 0) - 1
    dest = torch.where(mask & (order < budget), order, budget)
    worklist = torch.full((budget + 1,), cap, dtype=torch.int32, device=dev)
    worklist.index_copy_(0, dest.long(), slot_ids)
    return worklist[:budget], n_active, truncated.to(torch.int32)


# ---- the block pass --------------------------------------------------------

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
    present, camera pos, xi, yi, valid, (px, py))."""
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
    return slots, present, pos, xi, yi, valid & present[:, None], (px, py)


def sample_bilinear_plain(depth, px, py, xi, yi):
    """JAX's ``_sample_depth_bilinear`` at pixel coordinates (px, py)
    (integration.py:229-270): inverse depth interpolated over the 2x2
    pixels at (px - 0.5, py - 0.5), x0 clamped to [0, w - 2] and y0 to
    [0, h - 2]; 0 if any of them is 0; the nearest read depth[yi, xi] where
    the result lies 5 cm or more from any of them."""
    h, w = depth.shape
    flat = depth.reshape(-1)
    x0f = torch.floor(px - 0.5)
    y0f = torch.floor(py - 0.5)
    fx = (px - 0.5) - x0f
    fy = (py - 0.5) - y0f
    x0 = x0f.to(torch.int32).clamp(0, w - 2)
    y0 = y0f.to(torch.int32).clamp(0, h - 2)
    i00 = (y0 * w + x0).long()
    d00, d10 = flat[i00], flat[i00 + 1]
    d01, d11 = flat[i00 + w], flat[i00 + w + 1]
    any_zero = (d00 == 0) | (d10 == 0) | (d01 == 0) | (d11 == 0)

    def safe(d):
        return torch.where(d == 0, torch.ones_like(d), d)

    inv = ((1.0 / safe(d00)) * (1 - fx) * (1 - fy)
           + (1.0 / safe(d10)) * fx * (1 - fy)
           + (1.0 / safe(d01)) * (1 - fx) * fy
           + (1.0 / safe(d11)) * fx * fy)
    d = 1.0 / inv
    thr = 0.05
    consistent = ((torch.abs(d - d00) < thr) & (torch.abs(d - d10) < thr)
                  & (torch.abs(d - d01) < thr) & (torch.abs(d - d11) < thr))
    out = torch.where(consistent, d, flat[(yi * w + xi).long()])
    return torch.where(any_zero, torch.zeros_like(out), out)


def _update_blocks(geom, state, field, worklist, depth, t_cw, kmat, mu,
                   mode, write, timestamp, noise_weighted=False,
                   bilinear=False):
    """Fuse each worklist block at its depth ``mode`` (i32: level, -1 =
    skip; with ``bilinear`` the bilinear read) and write the payload and
    the active flag (any voxel fused) of the entries that ``write``
    selects, in place."""
    w = depth.shape[1]
    slots, present, pos, xi, yi, valid, (px, py) = _project_blocks(
        geom, state, worklist, depth, t_cw, kmat)
    if bilinear:
        ds = sample_bilinear_plain(depth, px, py, xi, yi)
    else:
        l = mode.clamp(min=0)[:, None]
        ds = depth.reshape(-1)[(((yi >> l) << l) * w
                                + ((xi >> l) << l)).long()]
    valid = valid & (mode >= 0)[:, None]
    new_x, new_y, _ = field_update(
        field, state.data_x[slots], state.data_y[slots], pos, ds, valid, mu,
        as_timestamp(field, timestamp, depth.device), geom.voxel_size,
        noise_weighted)
    sel = write & present
    dest = slots[sel]
    state.data_x[dest] = new_x[sel]
    state.data_y[dest] = new_y[sel]
    # block stays active iff any voxel projected into the frame
    state.active[dest] = valid.any(1)[sel]


def integrate_fused_plain(geom, state, field, worklist, depth, t_cw, kmat,
                          mu: float, timestamp=None, noise_weighted=False,
                          bilinear=False, patch_skipped=None):
    """Plain PyTorch twin of :func:`integrate_fused` (same in-place
    contract)."""
    h, w = depth.shape
    _, _, _, xi, yi, valid, _ = _project_blocks(geom, state, worklist, depth,
                                                t_cw, kmat)
    if bilinear:
        n_valid = valid.sum(1, dtype=torch.int32)
        mode = torch.zeros_like(n_valid)
        _update_blocks(geom, state, field, worklist, depth, t_cw, kmat, mu,
                       mode, torch.ones_like(mode, dtype=torch.bool),
                       timestamp, noise_weighted, True)
        patch_skipped.zero_()
        return mode, n_valid, torch.zeros_like(mode, dtype=torch.bool)
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
    mode = torch.where(covered, lvl, -1).to(torch.int32)
    need = ~covered & (n_valid > 0)
    _update_blocks(geom, state, field, worklist, depth, t_cw, kmat, mu, mode,
                   ~need, timestamp, noise_weighted)
    return mode, n_valid, need


def integrate_fallback_plain(geom, state, field, worklist, depth, t_cw, kmat,
                             mu: float, mode, n_valid, need, timestamp=None,
                             noise_weighted=False):
    """Plain PyTorch twin of :func:`integrate_fallback` (same in-place
    contract, ``mode`` included)."""
    rank = torch.cumsum(need.to(torch.int32), 0) - 1
    fb = need & (rank < min(FALLBACK_BLOCKS, worklist.shape[0]))
    mode.masked_fill_(fb, 0)
    skipped = torch.sum(torch.where(need & ~fb, n_valid, 0))
    _update_blocks(geom, state, field, worklist, depth, t_cw, kmat, mu,
                   torch.where(fb, 0, -1).to(torch.int32), need, timestamp,
                   noise_weighted)
    return skipped.to(torch.int32)
