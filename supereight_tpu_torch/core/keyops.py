"""Octant key algebra over (morton, level) pairs, on torch tensors.

Port of ``supereight_tpu/core/keyops.py`` (behavioral reference:
se::keyops, se_core/include/se/octant_ops.hpp, and the sorted-key
compaction of se_core/include/se/algorithms/unique.hpp). A key is a pair
(code: morton over voxel coords, level: int), the unpacked form of the
reference's 64-bit ``morton | level`` keys; ``max_depth`` is the depth
of a single voxel (log2 of the map size).

Codes are ``int64`` tensors holding JAX's ``uint32`` values
(``core/morton.py`` says why): every shifted mask is cut back to 32 bits,
so ``~uint32(0) << shift`` is ``(0xFFFFFFFF << shift) & 0xFFFFFFFF``.
Tensors keep their device; other inputs go to the device of a tensor among
the arguments, else to ``device``: the card unless the caller asks for the
CPU.
"""

import torch

from supereight_tpu_torch.core import morton
from supereight_tpu_torch.core.morton import _device, _i64, _U32


def _shl(value, shift):
    """``value << shift`` for an int64 tensor ``shift``."""
    return torch.full_like(shift, value) << shift


def code_at_level(code, level, max_depth, device="cuda"):
    """Mask a voxel-level morton code down to octant granularity at
    ``level`` (ref compute_prefix / MASK table, octree_defines.h:58-80).
    Level 0 = root, level max_depth = single voxel."""
    dev = _device(code, level, device=device)
    shift = 3 * (max_depth - _i64(level, dev))
    return _i64(code, dev) & (_shl(_U32, shift) & _U32)


def parent(code, level, max_depth, device="cuda"):
    """Key of the parent octant (ref keyops::parent, octant_ops.hpp:95-99)."""
    dev = _device(code, level, device=device)
    plevel = _i64(level, dev) - 1
    return code_at_level(code, plevel, max_depth), plevel


def child_id(code, level, max_depth, device="cuda"):
    """Which of its parent's 8 children an octant is (ref child_id,
    octant_ops.hpp:107-113); int32."""
    dev = _device(code, level, device=device)
    shift = 3 * (max_depth - _i64(level, dev))
    return ((_i64(code, dev) >> shift) & 7).to(torch.int32)


def descendant(code, ancestor_code, ancestor_level, max_depth,
               device="cuda"):
    """True if ``code`` lies inside the ancestor octant (ref descendant,
    octant_ops.hpp:81-88)."""
    dev = _device(code, ancestor_code, ancestor_level, device=device)
    return code_at_level(code, ancestor_level, max_depth, dev) == \
        code_at_level(ancestor_code, ancestor_level, max_depth, dev)


def face_neighbour(code, level, max_depth, axis, direction, device="cuda"):
    """Same-level neighbour across a face (ref face_neighbour,
    octant_ops.hpp:64-73, by coordinate arithmetic). Returns (code,
    valid); invalid when the neighbour leaves the map."""
    dev = _device(code, level, direction, device=device)
    step = _shl(1, max_depth - _i64(level, dev)).to(torch.int32)
    coords = morton.decode_v(code, dev)
    sign = torch.where(_i64(direction, dev) > 0, 1, -1).to(torch.int32)
    delta = torch.zeros_like(coords)
    delta[..., axis] = step * sign
    n = coords + delta
    size = 1 << max_depth
    valid = ((n >= 0) & (n < size)).all(-1)
    return morton.encode_v(n.clamp(0, size - 1)), valid


def siblings(code, level, max_depth, device="cuda"):
    """All 8 children of the parent (ref siblings, octant_ops.hpp:175-183):
    codes of shape [..., 8]."""
    dev = _device(code, level, device=device)
    pcode = code_at_level(code, _i64(level, dev) - 1, max_depth, dev)
    shift = 3 * (max_depth - _i64(level, dev))
    ids = torch.arange(8, dtype=torch.int64, device=pcode.device)
    return pcode[..., None] | ((ids << shift[..., None]) & _U32)


def far_corner(code, level, max_depth, device="cuda"):
    """Corner of the octant farthest from its parent's centre (ref
    far_corner, octant_ops.hpp:121-129)."""
    dev = _device(code, level, device=device)
    cid = child_id(code, level, max_depth, dev)
    side = _shl(1, max_depth - _i64(level, dev)).to(torch.int32)
    coords = morton.decode_v(code, dev)
    offs = torch.stack([cid & 1, (cid >> 1) & 1, (cid >> 2) & 1], -1) \
        * side[..., None]
    return coords + offs


def _bool(x, device):
    return x if isinstance(x, torch.Tensor) else \
        torch.as_tensor(x, dtype=torch.bool, device=device)


def unique(sorted_codes, valid, device="cuda"):
    """Mask of first occurrences in a sorted key array (ref
    algorithms::unique, unique.hpp:36-47); the first entry's predecessor
    is its own code ^ 1, a sentinel that differs from it."""
    dev = _device(sorted_codes, valid, device=device)
    c, valid = _i64(sorted_codes, dev), _bool(valid, dev)
    prev = torch.cat([c[:1] ^ 1, c[:-1]])
    return valid & (c != prev)


def filter_ancestors(sorted_codes, levels, valid, max_depth, device="cuda"):
    """Keep only the deepest key of each ancestor chain (ref
    filter_ancestors, unique.hpp:49-61): drop a key whose successor is its
    own strict descendant."""
    dev = _device(sorted_codes, levels, valid, device=device)
    c, lv = _i64(sorted_codes, dev), _i64(levels, dev)
    valid = _bool(valid, dev)
    nxt_code = torch.cat([c[1:], c[-1:]])
    nxt_level = torch.cat([lv[1:], lv[-1:]])
    nxt_valid = torch.cat([valid[1:], valid.new_zeros(1)])
    strict_anc = nxt_valid & (nxt_level > lv) \
        & (code_at_level(nxt_code, lv, max_depth) == c)
    return valid & ~strict_anc


def unique_multiscale(sorted_codes, levels, valid, device="cuda"):
    """Per-code dedup keeping the finest level (ref unique_multiscale,
    unique.hpp:63-79): keys sorted by (code, level) ascending keep the
    last entry of each code run."""
    dev = _device(sorted_codes, levels, valid, device=device)
    c, valid = _i64(sorted_codes, dev), _bool(valid, dev)
    nxt = torch.cat([c[1:], c[-1:] ^ 1])
    nxt_valid = torch.cat([valid[1:], valid.new_zeros(1)])
    return valid & ((c != nxt) | ~nxt_valid)
