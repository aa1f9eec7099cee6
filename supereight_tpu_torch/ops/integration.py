"""Projective map integration (fusion), TSDF and OFusion.

Port of ``supereight_tpu/ops/integration.py:integrate`` with the nearest-
depth read (ref se::functor::projective_functor,
projective_functor.hpp:54-156): compact the active + in-frustum blocks
into a fixed-budget worklist, update every voxel of those blocks with the
field's functor (kernel K3, ``kernels/integrate.py``), then re-fuse every
existing coarse (mip) value at its octant origin corner with the same
functor (the node pass, torch ops here; it becomes kernel K4 in a later
change).

The map is updated IN PLACE (JAX donated it); the returned state shares
its tensors with the input.
"""

import torch

from supereight_tpu_torch.constants import BLOCK_SIDE
from supereight_tpu_torch.core import se3
from supereight_tpu_torch.core.map import broadcast2
from supereight_tpu_torch.kernels.integrate import (as_timestamp,
                                                    field_update,
                                                    integrate_blocks,
                                                    project_voxels)


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


def _sample_depth(depth, px, py):
    """Nearest depth at truncated pixel coords (ref sdf_update reads
    depth[int(pixel)], kfusion/mapping_impl.hpp:39-41)."""
    h, w = depth.shape
    xi = px.to(torch.int32).clamp(0, w - 1)
    yi = py.to(torch.int32).clamp(0, h - 1)
    return depth.reshape(-1)[(yi * w + xi).long()]


def _parent_present(geom, state, pbudget: int):
    """Level-0 octants whose parent node is occupied AND among the first
    ``pbudget`` occupied parents in parent-id order (the JAX sparse
    level-0 pass, integration.py:433-500). Returns ([B,B,B] bool,
    octants of occupied parents beyond the budget)."""
    b = geom.blocks_per_side
    hp = b // 2
    parent = state.mip_alloc[0].reshape(hp, 2, hp, 2, hp, 2) \
        .any(5).any(3).any(1).reshape(-1)
    rank = torch.cumsum(parent.to(torch.int32), 0) - 1
    present = parent & (rank < pbudget)
    skipped = (torch.sum(parent.to(torch.int32))
               - torch.sum(present.to(torch.int32))) * 8
    return broadcast2(present.reshape(hp, hp, hp)), skipped


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

    # ---- node (coarse mip) pass ----------------------------------------
    # ref update_node (projective_functor.hpp:113-137): every existing
    # coarse value is re-fused at its octant origin corner. Level 0 is
    # restricted to the first pbudget occupied parents like the JAX sparse
    # pass (for maps of >= 8 blocks a side); the dense form over the whole
    # level with that mask gives the same values.
    mip_skipped = torch.zeros((), dtype=torch.int32, device=dev)
    for lvl in range(geom.num_levels):
        side = geom.blocks_per_side >> lvl
        octant_m = (BLOCK_SIDE << lvl) * geom.voxel_size
        g = torch.arange(side, dtype=torch.float32, device=dev) * octant_m
        wx = g[:, None, None].expand(side, side, side)
        wy = g[None, :, None].expand(side, side, side)
        wz = g[None, None, :].expand(side, side, side)
        pos, px, py, valid = project_voxels(wx, wy, wz, t_cw, kmat,
                                            frame_size)
        if lvl == 0 and geom.blocks_per_side >= 8:
            present, mip_skipped = _parent_present(
                geom, state, min(budget, (geom.blocks_per_side // 2) ** 3))
            valid = valid & present
        else:
            valid = valid & state.mip_alloc[lvl]
        if when is not None:
            valid = valid & when
        ds = _sample_depth(depth, px, py)
        nx, ny, _ = field_update(field, state.mip_x[lvl], state.mip_y[lvl],
                                 pos, ds, valid, mu, timestamp,
                                 geom.voxel_size)
        state.mip_x[lvl].copy_(nx)
        state.mip_y[lvl].copy_(ny)

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
                   "mip_skipped": mip_skipped.to(torch.int32)}
