"""K2 wrapper and twin: the raycast's navigation grid, both fields.

Replaces ``supereight_tpu/ops/raycast.py:build_nav`` (138-174) with
``block_distance`` (103-112) and ``coarse_cell_grid`` (115-135). The CUDA
kernel is ``csrc/nav.cu`` (one launch: each column's occupancy as bit
words along z, the capped distance transform as five dilations of them
in shared memory, then the OFusion payload and the slot pick);
:func:`nav_grid_plain` is the plain PyTorch version in the JAX form, used
for CPU tensors and as the kernel's reference on the card.

One i32 per block cell: the pool slot of an allocated block below the
pool bucket, else -(1 + e) with e = the Chebyshev block distance to the
nearest allocated block (capped at MAX_JUMP) plus, for OFusion cells
whose finest existing coarse value is free space, 8 + (q << 4) with q the
log-odds magnitude quantized to 1/16.
"""

import torch
import torch.nn.functional as F

from benchmark.reference.frozen.constants import SURF_BOUNDARY
from benchmark.reference.frozen.core.map import broadcast2

MAX_JUMP = 6        # cap of the Chebyshev block-distance transform


def block_distance(geom, state, max_jump: int = MAX_JUMP):
    """Chebyshev distance (blocks, capped) to the nearest allocated block:
    ``max_jump - 1`` 3^3 min-dilations of the allocation mask."""
    d = torch.where(state.slot >= 0, 0.0, float(max_jump))[None, None]
    for _ in range(max_jump - 1):
        neigh = -F.max_pool3d(-d, 3, stride=1, padding=1)
        d = torch.minimum(d, neigh + 1.0)
    return d[0, 0]


def coarse_cell_grid(geom, state):
    """Finest existing coarse (mip) value per block cell: (f32[B^3],
    bool[B^3] exists); a value exists where mip_alloc and mip_y > 0."""
    b = geom.blocks_per_side
    dev = state.slot.device
    val = torch.zeros((b, b, b), dtype=torch.float32, device=dev)
    have = torch.zeros((b, b, b), dtype=torch.bool, device=dev)
    for lvl in range(geom.num_levels):
        ex = state.mip_alloc[lvl] & (state.mip_y[lvl] > 0)
        mx = state.mip_x[lvl]
        for _ in range(lvl):
            ex, mx = broadcast2(ex), broadcast2(mx)
        take = ex & ~have
        val = torch.where(take, mx, val)
        have = have | take
    return val, have


def nav_grid_plain(geom, state, field, bucket: int = None,
                   with_counts: bool = False):
    """Plain PyTorch twin of :func:`nav_grid` (JAX raycast.py:138-174)."""
    e = block_distance(geom, state).to(torch.int32)
    if field.name == "ofusion":
        cval, have = coarse_cell_grid(geom, state)
        known_free = have & (cval <= SURF_BOUNDARY)
        # torch.round rounds half to even, as jnp.round does
        q = torch.round(torch.clamp(-cval, 0.0, 1000.0) * 16.0) \
            .to(torch.int32)
        e = e + torch.where(known_free, 8 + (q << 4), 0)
    ok = state.slot >= 0
    if bucket is not None and bucket < geom.capacity:
        ok = ok & (state.slot < bucket)
    nav = torch.where(ok, state.slot, -(1 + e)).reshape(-1)
    if not with_counts:
        return nav
    bucket = geom.capacity if bucket is None else min(bucket, geom.capacity)
    n = state.n_blocks.reshape(1)
    return nav, torch.cat([n, torch.clamp(n - bucket, min=0)])
