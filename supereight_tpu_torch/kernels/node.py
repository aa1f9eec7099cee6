"""K4 wrapper and twin: the node (coarse mip) pass of both fields.

Replaces the node pass of ``supereight_tpu/ops/integration.py:integrate``:
the dense levels (377-419) and ``_node_pass_level0_sparse`` (433-500),
with ``_project_voxels_c`` (78-94), ``_sample_depth`` (97-115) and
``_field_update`` (273-279). Ref update_node
(projective_functor.hpp:113-137): every existing coarse value is re-fused
at its octant's origin corner with the field's update. The CUDA kernels
are the two launches of ``csrc/node.cu``: :func:`node_rank` (one cluster
ranking the level-0 parents) and the pass itself (one thread per coarse
cell over every level); :func:`node_pass_plain` is the plain PyTorch
version, one dense pass per level, used for CPU tensors and as the
kernels' reference on the card.

Level 0 is restricted, like the JAX sparse pass (maps of >= 8 blocks a
side), to the octants whose parent is occupied and among the first
``min(budget, (B/2)^3)`` occupied parents in parent-id order: the rank
kernel's cluster scan, and the twin's cumsum (:func:`_parent_present`).
Smaller maps gate level 0 by ``mip_alloc[0]``, as JAX's dense loop does.

The pass writes ``mip_x`` and ``mip_y`` of the map IN PLACE.
"""

import torch

from supereight_tpu_torch.constants import BLOCK_SIDE, MAX_WEIGHT
from supereight_tpu_torch.core.map import broadcast2
from supereight_tpu_torch.kernels import _lib
from supereight_tpu_torch.kernels.integrate import (as_timestamp,
                                                    field_update,
                                                    project_voxels)


def _parent_present(geom, state, budget: int):
    """Level-0 parents (bool[B/2, B/2, B/2]) that are occupied and among
    the first ``min(budget, (B/2)^3)`` occupied parents in parent-id order,
    and the i32[] count of octants of occupied parents beyond that
    (mip_skipped); (None, 0) for maps of fewer than 8 blocks a side."""
    b = geom.blocks_per_side
    dev = state.mip_alloc[0].device
    if b < 8:
        return None, torch.zeros((), dtype=torch.int32, device=dev)
    hp = b // 2
    parent = state.mip_alloc[0].reshape(hp, 2, hp, 2, hp, 2) \
        .any(5).any(3).any(1).reshape(-1)
    rank = torch.cumsum(parent.to(torch.int32), 0) - 1
    present = parent & (rank < min(budget, hp ** 3))
    skipped = (torch.sum(parent.to(torch.int32))
               - torch.sum(present.to(torch.int32))) * 8
    return present.reshape(hp, hp, hp), skipped.to(torch.int32)


def node_rank(geom, state, budget: int, when=None):
    """The level-0 parent gate and mip_skipped of :func:`_parent_present`,
    with mip_skipped 0 where ``when`` (bool[] tensor) is False; one launch
    of ``csrc/node.cu``'s rank kernel on a CUDA device. (None, 0) for maps
    of fewer than 8 blocks a side."""
    dev = state.mip_alloc[0].device
    if dev.type == "cpu":
        return node_rank_plain(geom, state, budget, when)
    if dev.type != "cuda":
        raise ValueError(f"node_rank: unsupported device {dev}")
    b = geom.blocks_per_side
    if b < 8:
        return None, torch.zeros((), dtype=torch.int32, device=dev)
    hp = b // 2
    alloc0 = _lib.check(state.mip_alloc[0], "mip_alloc", torch.bool,
                        (b, b, b), dev)
    if alloc0.data_ptr() % 2:
        raise ValueError("mip_alloc[0]: the kernel reads it 2 bytes at a "
                         "time and needs it 2-byte aligned")
    if when is not None:
        when = _lib.check(when.reshape(()), "when", torch.bool, (), dev)
    present = torch.empty((hp, hp, hp), dtype=torch.bool, device=dev)
    skipped = torch.empty((), dtype=torch.int32, device=dev)
    _lib.launch("node_rank", "se_node_rank", dev, alloc0, b,
                min(budget, hp ** 3), when, present, skipped)
    return present, skipped


def node_rank_plain(geom, state, budget: int, when=None):
    """Plain PyTorch twin of :func:`node_rank`."""
    present, skipped = _parent_present(geom, state, budget)
    if when is not None:
        skipped = torch.where(when, skipped, torch.zeros_like(skipped))
    return present, skipped


def node_pass(geom, state, field, depth, t_cw, kmat, mu: float, budget: int,
              timestamp=None, when=None):
    """Re-fuse every existing coarse value of ``state`` at its octant
    corner, in place. ``depth`` is the f32[H, W] frame (its shape is the
    frame size), ``t_cw`` world-to-camera [4, 4], ``kmat`` the 4x4
    intrinsics, ``timestamp`` the f32[] the OFusion update writes,
    ``when`` (bool[] tensor) masks every write. Returns mip_skipped
    (i32[]): level-0 octants of occupied parents beyond the budget, 0 where
    ``when`` is False. Two launches on a CUDA device: :func:`node_rank`,
    then the pass."""
    dev = depth.device
    if dev.type == "cpu":
        return node_pass_plain(geom, state, field, depth, t_cw, kmat, mu,
                               budget, timestamp, when)
    if dev.type != "cuda":
        raise ValueError(f"node_pass: unsupported device {dev}")
    b, nl = geom.blocks_per_side, geom.num_levels
    if nl > _lib.MAX_MIP_LEVELS:
        raise ValueError(f"node_pass: {nl} mip levels, the kernel takes "
                         f"{_lib.MAX_MIP_LEVELS}")
    c = _lib.check
    h, w = depth.shape
    c(depth, "depth", torch.float32, (h, w), dev)
    c(t_cw, "t_cw", torch.float32, (4, 4), dev)
    c(kmat, "kmat", torch.float32, (4, 4), dev)
    mips = _lib.Mips()
    for lvl in range(nl):
        s = (b >> lvl,) * 3
        mips.alloc[lvl] = c(state.mip_alloc[lvl], "mip_alloc", torch.bool, s,
                            dev).data_ptr()
        mips.x[lvl] = c(state.mip_x[lvl], "mip_x", torch.float32, s,
                        dev).data_ptr()
        mips.y[lvl] = c(state.mip_y[lvl], "mip_y", torch.float32, s,
                        dev).data_ptr()
    if when is not None:
        when = c(when.reshape(()), "when", torch.bool, (), dev)
    ts = as_timestamp(field, timestamp, dev)
    present, skipped = node_rank(geom, state, budget, when)
    _lib.launch("node_pass", "se_node_pass", dev, mips, b, nl,
                geom.voxel_size, present, when, t_cw, kmat, w, h, depth,
                int(field.name == "ofusion"), float(mu), float(MAX_WEIGHT),
                2.0 * geom.voxel_size, ts)
    return skipped


def _sample_depth(depth, px, py):
    """Nearest depth at truncated pixel coords (ref sdf_update reads
    depth[int(pixel)], kfusion/mapping_impl.hpp:39-41)."""
    h, w = depth.shape
    xi = px.to(torch.int32).clamp(0, w - 1)
    yi = py.to(torch.int32).clamp(0, h - 1)
    return depth.reshape(-1)[(yi * w + xi).long()]


def node_pass_plain(geom, state, field, depth, t_cw, kmat, mu: float,
                    budget: int, timestamp=None, when=None):
    """Plain PyTorch twin of :func:`node_pass` (same in-place contract):
    one dense pass over each level."""
    dev = depth.device
    h, w = depth.shape
    timestamp = as_timestamp(field, timestamp, dev)
    present, skipped = node_rank_plain(geom, state, budget, when)
    for lvl in range(geom.num_levels):
        side = geom.blocks_per_side >> lvl
        octant_m = (BLOCK_SIDE << lvl) * geom.voxel_size
        g = torch.arange(side, dtype=torch.float32, device=dev) * octant_m
        wx = g[:, None, None].expand(side, side, side)
        wy = g[None, :, None].expand(side, side, side)
        wz = g[None, None, :].expand(side, side, side)
        pos, px, py, valid = project_voxels(wx, wy, wz, t_cw, kmat, (w, h))
        if lvl == 0 and present is not None:
            valid = valid & broadcast2(present)
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
    return skipped
