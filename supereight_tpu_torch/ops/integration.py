"""Projective map integration (fusion), TSDF and OFusion.

Port of ``supereight_tpu/ops/integration.py:integrate`` with the nearest-
depth read (ref se::functor::projective_functor,
projective_functor.hpp:54-156): compact the active + in-frustum blocks
into a fixed-budget worklist, update every voxel of those blocks with the
field's functor (kernel K3, ``kernels/integrate.py``), then re-fuse every
existing coarse (mip) value at its octant origin corner with the same
functor (the node pass, kernel K4, ``kernels/node.py``).

The map is updated IN PLACE (JAX donated it); the returned state shares
its tensors with the input.
"""

import torch

from supereight_tpu_torch.constants import BLOCK_SIDE
from supereight_tpu_torch.core import se3
from supereight_tpu_torch.kernels.integrate import (as_timestamp,
                                                    integrate_blocks)
from supereight_tpu_torch.kernels.node import node_pass


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


def build_active_worklist(geom, state, t_cw, kmat, frame_size, budget: int,
                          when=None):
    """Fixed-budget compaction of active + in-frustum slots, in slot order
    (ref build_active_list, projective_functor.hpp:54-71).

    Returns (i32[budget] slot ids, empty entries = capacity; the i32[]
    count of all active + in-frustum slots, for overflow accounting).
    ``when`` (bool[]) empties the worklist when False.
    """
    cap = geom.capacity
    dev = state.active.device
    slot_ids = torch.arange(cap, dtype=torch.int32, device=dev)
    mask = ((slot_ids < state.n_blocks) & state.active
            & in_frustum_mask(geom, state, t_cw, kmat, frame_size))
    n_active = torch.sum(mask.to(torch.int32))
    if when is not None:
        mask = mask & when
    order = torch.cumsum(mask.to(torch.int32), 0) - 1
    dest = torch.where(mask & (order < budget), order, budget)
    worklist = torch.full((budget + 1,), cap, dtype=torch.int32, device=dev)
    worklist.index_copy_(0, dest.long(), slot_ids)
    return worklist[:budget], n_active


def integrate(geom, state, field, depth, pose, k, mu: float, timestamp,
              frame_size, budget: int = 8192, depth_interp: bool = False,
              with_stats: bool = False, when=None,
              noise_weighted: bool = False):
    """One fusion pass: block update + node (mip) update
    (ref projective_functor::apply, projective_functor.hpp:139-156).

    ``pose`` is camera-to-world; ``k`` the f32[4] intrinsics;
    ``timestamp`` the f32[] tensor the OFusion update stamps into channel
    y (None for TSDF, which ignores it). ``when`` (bool[] tensor)
    masks all map writes. With ``with_stats`` also returns
    {blocks_truncated, patch_skipped, mip_skipped} as i32[] tensors.
    """
    if depth_interp:
        raise NotImplementedError("the bilinear depth read is not ported yet")
    if noise_weighted:
        raise NotImplementedError("noise_weighted fusion is not ported yet")
    t_cw = se3.inverse(pose)
    kmat = se3.camera_matrix(k)
    budget = min(budget, geom.capacity)
    dev = depth.device
    timestamp = as_timestamp(field, timestamp, dev)

    # ---- block pass (K3) -----------------------------------------------
    wl, n_active = build_active_worklist(geom, state, t_cw, kmat,
                                         frame_size, budget, when)
    patch_skipped = integrate_blocks(geom, state, field, wl, depth, t_cw,
                                     kmat, mu, timestamp)

    # ---- node (coarse mip) pass (K4) ----------------------------------
    mip_skipped = node_pass(geom, state, field, depth, t_cw, kmat, mu, budget,
                            timestamp, when)

    if not with_stats:
        return state
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    truncated = torch.clamp(n_active - budget, min=0).to(torch.int32)
    if when is not None:
        truncated = torch.where(when, truncated, zero)
        patch_skipped = torch.where(when, patch_skipped, zero)
        mip_skipped = torch.where(when, mip_skipped, zero)
    return state, {"blocks_truncated": truncated,
                   "patch_skipped": patch_skipped,
                   "mip_skipped": mip_skipped}
