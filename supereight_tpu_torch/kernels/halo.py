"""The sharded step's halo send buffer (``halo_pack``): wrapper and twin.

Replaces ``supereight_tpu/parallel/dist_step.py:build_halo_worklist``
(190-221) and the gathers of its raycast branch (336-350): a rank's
allocated blocks (with ``frustum``, those whose centre projects inside the
margin-padded image or lies within 0.5 m of the camera), compacted in slot
order into a fixed-budget buffer of both pool channels and the blocks'
cell ids, which one ``all_gather`` turns into every rank's halo table
(``parallel/dist_step.py``). The CUDA kernel is ``csrc/integrate.cu``
(``halo_pack_kernel``, on the compaction of ``compact.cuh``);
:func:`halo_pack_plain` is the plain PyTorch version, used for CPU tensors
and as the kernel's reference on the card.

The send buffer is f32[:func:`halo_rows` (budget), 512]: the data_x bricks
in rows [0, budget), the data_y bricks in rows [budget, 2 budget), then the
i32 cell ids (b^3 past the flagged rows). JAX sent one channel with the
unknown voxels replaced by its sentinel; the port's K1 reads both
channels and decodes "unknown" from data_y, as on the single-device path.
Rows past the flagged ones are left as they were (no rank reads them).
"""

import torch

from supereight_tpu_torch.constants import BLOCK_SIDE, BLOCK_VOXELS
from supereight_tpu_torch.core import se3
from supereight_tpu_torch.kernels import _lib

NEAR = 0.25  # squared camera distance (m^2) below which a block is sent


def halo_rows(budget: int) -> int:
    """Rows of 512 floats of a send buffer of ``budget`` blocks."""
    return 2 * budget + -(-budget // BLOCK_VOXELS)


def cells_of(send, budget: int):
    """The i32[budget] cell ids of a send buffer (a view)."""
    return send[2 * budget:].reshape(-1)[:budget].view(torch.int32)


def view_bounds(frame_size, margin: float):
    """(u_lo, u_hi, v_lo, v_hi): the margin-padded image of the halo test,
    as JAX's Python floats (rounded to f32 where they meet f32 values)."""
    w, h = frame_size
    mw, mh = margin * w, margin * h
    return -mw, w + mw, -mh, h + mh


def halo_pack(geom, state, t_cw, kmat, frame_size, budget: int,
              margin: float = 0.3, frustum: bool = True):
    """Pack the halo blocks of ``state`` (a rank's local map) into a send
    buffer. ``t_cw`` world-to-camera and ``kmat`` the 4x4 intrinsics (the
    frame's prologue), ``frame_size`` (w, h). Returns (send
    f32[halo_rows(budget), 512], counts i32[2]: halo_blocks = min(n,
    budget) and halo_overflow = max(n - budget, 0), n the flagged blocks).
    One launch on a CUDA device, no host sync."""
    dev = state.n_blocks.device
    if dev.type == "cpu":
        return halo_pack_plain(geom, state, t_cw, kmat, frame_size, budget,
                               margin, frustum)
    if dev.type != "cuda":
        raise ValueError(f"halo_pack: unsupported device {dev}")
    cap, b = geom.capacity, geom.blocks_per_side
    c = _lib.check
    c(state.block_coord, "block_coord", torch.int32, (cap, 3), dev)
    c(state.n_blocks, "n_blocks", torch.int32, (), dev)
    c(state.data_x, "data_x", torch.float32, (cap, BLOCK_VOXELS), dev)
    c(state.data_y, "data_y", torch.float32, (cap, BLOCK_VOXELS), dev)
    c(t_cw, "t_cw", torch.float32, (4, 4), dev)
    c(kmat, "kmat", torch.float32, (4, 4), dev)
    send = torch.empty((halo_rows(budget), BLOCK_VOXELS), dtype=torch.float32,
                       device=dev)
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    _lib.launch("halo_pack", "se_halo_pack", dev, state.block_coord,
                state.n_blocks, cap, state.data_x, state.data_y, t_cw, kmat,
                BLOCK_SIDE * geom.voxel_size,
                *view_bounds(frame_size, margin), int(frustum), b, budget,
                send, counts)
    return send, counts


def build_halo_worklist_plain(geom, state, t_cw, kmat, frame_size,
                              budget: int, margin: float = 0.3,
                              frustum: bool = True):
    """JAX's ``build_halo_worklist`` in torch ops: (i32[budget] slots in
    slot order, capacity past the flagged ones; i32[] the flagged
    count)."""
    cap = geom.capacity
    dev = state.n_blocks.device
    slot_ids = torch.arange(cap, dtype=torch.int32, device=dev)
    mask = slot_ids < state.n_blocks
    if frustum:
        scale = BLOCK_SIDE * geom.voxel_size
        c = (state.block_coord.to(torch.float32) + 0.5) * scale
        px, py, pz = se3.transform_c(t_cw, c[:, 0], c[:, 1], c[:, 2])
        kx, ky, kz = se3.transform_c(kmat, px, py, pz)
        z = torch.where(kz == 0, torch.full_like(kz, 1e-12), kz)
        u, v = kx / z, ky / z
        u_lo, u_hi, v_lo, v_hi = view_bounds(frame_size, margin)
        in_view = ((kz > 0) & (u >= u_lo) & (u < u_hi)
                   & (v >= v_lo) & (v < v_hi))
        near = (px * px + py * py + pz * pz) < NEAR
        mask = mask & (in_view | near)
    order = torch.cumsum(mask.to(torch.int32), 0) - 1
    dest = torch.where(mask & (order < budget), order, budget)
    wl = torch.full((budget + 1,), cap, dtype=torch.int32, device=dev)
    wl.index_copy_(0, dest.long(), slot_ids)
    return wl[:budget], torch.sum(mask.to(torch.int32))


def halo_pack_plain(geom, state, t_cw, kmat, frame_size, budget: int,
                    margin: float = 0.3, frustum: bool = True):
    """Plain PyTorch twin of :func:`halo_pack`: the worklist, then a gather
    of the listed bricks and cell ids (rows past them zero)."""
    cap, b = geom.capacity, geom.blocks_per_side
    wl, n = build_halo_worklist_plain(geom, state, t_cw, kmat, frame_size,
                                      budget, margin, frustum)
    present = wl < cap
    slots = wl.clamp(max=cap - 1).long()
    send = torch.zeros((halo_rows(budget), BLOCK_VOXELS), dtype=torch.float32,
                       device=wl.device)
    keep = present[:, None]
    send[:budget] = torch.where(keep, state.data_x[slots], 0.0)
    send[budget:2 * budget] = torch.where(keep, state.data_y[slots], 0.0)
    bc = state.block_coord[slots]
    cells = (bc[:, 0] * b + bc[:, 1]) * b + bc[:, 2]
    cells_of(send, budget).copy_(torch.where(present, cells, b ** 3))
    filled = torch.clamp(n, max=budget)
    return send, torch.stack([filled, n - filled]).to(torch.int32)
