"""Sparse voxel map: block pool + dense mip pyramid, on torch tensors.

Port of ``supereight_tpu/core/map.py`` (the JAX package's module docstring
describes the design). Leaf storage is a fixed-capacity pool of dense
8x8x8 bricks (two f32 channels of shape [capacity, 512], in-brick index
x + 8y + 64z); a dense i32 grid ``slot[bx, by, bz]`` maps block coords to
pool slots (-1 = unallocated); ``mip_*[l]`` hold the coarse node values.

Allocation (``kernels/alloc.py:alloc_assign``, and :func:`allocate_blocks`
over it) and :func:`set_voxels` update the state's tensors IN PLACE (where
JAX donated the buffers, parallel/step.py there): callers consume a state
once per frame, and the returned state shares its tensors with the input.
The voxel reads (:func:`get_voxel`, :func:`get_with_coarse`, ...) are
JAX's, value for value. Reads and writes take coordinates as tensors,
numpy arrays or lists, and carry them to the map's device (:func:`on_map`).

``MapState.touched`` is the one field with no JAX counterpart: the
allocation march's scratch, kept with the map so that no frame allocates
or fills it (see the field's comment).
"""

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch

from benchmark.reference.frozen.constants import BLOCK_SIDE, BLOCK_VOXELS
from benchmark.reference.frozen.core import morton
from benchmark.reference.frozen.fields.base import FieldSpec


@dataclasses.dataclass(frozen=True)
class MapGeometry:
    """Static map geometry (ref Octree::init, octree.hpp:428-438)."""

    size: int          # voxels per side (power of two, >= 16)
    dim: float         # metric extent of the cube (meters)
    capacity: int      # maximum number of allocated voxel blocks

    def __post_init__(self):
        if self.size % BLOCK_SIDE:
            raise ValueError("map size must be a multiple of 8")
        b = self.size // BLOCK_SIDE
        if b & (b - 1):
            raise ValueError("block grid side must be a power of two")

    @property
    def voxel_size(self) -> float:
        return self.dim / self.size

    @property
    def inv_voxel_size(self) -> float:
        return self.size / self.dim

    @property
    def blocks_per_side(self) -> int:
        return self.size // BLOCK_SIDE

    @property
    def num_levels(self) -> int:
        """Mip levels: level 0 has blocks_per_side^3 octants, top has 1^3."""
        return int(math.log2(self.blocks_per_side)) + 1


TOUCHED_LEVELS = 3  # levels of the touched buffer: OFusion marches 0-2


def touched_size(b: int) -> int:
    """Bytes of the touched buffer of a map of side ``b`` blocks: the grids
    of levels 0, 1 and 2 back to back (299,008 at b = 64)."""
    return sum((b >> lvl) ** 3 for lvl in range(TOUCHED_LEVELS))


def touched_buffer(b: int, device="cuda") -> torch.Tensor:
    """A zeroed touched buffer of a map of side ``b`` blocks on ``device``:
    the map's (``make_map``), or a fresh one for a march's ``out``."""
    return torch.zeros(touched_size(b), dtype=torch.bool, device=device)


def touched_grids(touched: torch.Tensor, b: int,
                  levels: int = TOUCHED_LEVELS):
    """The grids of levels 0 .. levels - 1 (bool[b >> l]^3 views, one op
    each) of a touched buffer; a level past the pyramid's top
    (b >> l == 0) is empty."""
    grids, offset = [], touched.storage_offset()
    for lvl in range(levels):
        s = b >> lvl
        grids.append(touched.as_strided((s, s, s), (s * s, s, 1), offset))
        offset += s ** 3
    return tuple(grids)


class MapState(NamedTuple):
    """The dynamic map contents: the field names of the JAX ``MapState``,
    then ``touched``, the one field that has no JAX counterpart."""

    data_x: torch.Tensor      # f32[capacity, 512] channel 0 (sdf)
    data_y: torch.Tensor      # f32[capacity, 512] channel 1 (weight)
    block_coord: torch.Tensor  # i32[capacity, 3] block-grid coordinate
    active: torch.Tensor      # bool[capacity] ref VoxelBlock::active_
    slot: torch.Tensor        # i32[B, B, B] block coord -> slot (-1 = none)
    n_blocks: torch.Tensor    # i32[] number of allocated slots
    mip_x: Tuple[torch.Tensor, ...]      # f32[B>>l, B>>l, B>>l]
    mip_y: Tuple[torch.Tensor, ...]
    mip_alloc: Tuple[torch.Tensor, ...]  # bool[B>>l, ...] value exists
    # bool[touched_size(B)]: the allocation march's touched grids of
    # levels 0-2 back to back (touched_grids; TSDF uses level 0). All zero
    # between frames: the march writes it and alloc_assign, which reads
    # it, clears it. Its level-0 grid starts the buffer, 16-byte aligned
    # as alloc_assign's loads need.
    touched: torch.Tensor


def make_map(geom: MapGeometry, field: FieldSpec,
             device="cuda") -> MapState:
    """Create an empty map (ref: Octree::init, octree.hpp:428-438) on
    ``device``, the card unless the caller asks for another."""
    cap = geom.capacity
    b = geom.blocks_per_side
    init_x, init_y = field.init
    f32 = dict(dtype=torch.float32, device=device)
    mips_x, mips_y, mips_a = [], [], []
    for lvl in range(geom.num_levels):
        s = b >> lvl
        mips_x.append(torch.full((s, s, s), init_x, **f32))
        mips_y.append(torch.full((s, s, s), init_y, **f32))
        mips_a.append(torch.zeros((s, s, s), dtype=torch.bool, device=device))
    return MapState(
        data_x=torch.full((cap, BLOCK_VOXELS), init_x, **f32),
        data_y=torch.full((cap, BLOCK_VOXELS), init_y, **f32),
        block_coord=torch.zeros((cap, 3), dtype=torch.int32, device=device),
        active=torch.zeros((cap,), dtype=torch.bool, device=device),
        slot=torch.full((b, b, b), -1, dtype=torch.int32, device=device),
        n_blocks=torch.zeros((), dtype=torch.int32, device=device),
        mip_x=tuple(mips_x),
        mip_y=tuple(mips_y),
        mip_alloc=tuple(mips_a),
        touched=touched_buffer(b, device),
    )


def on_map(state: MapState, a, dtype=torch.int32):
    """``a`` as a tensor on the map's device. Tensors keep their dtype;
    numpy arrays and lists take ``dtype`` (int32 coordinates, as JAX's
    functions make of them)."""
    if isinstance(a, torch.Tensor):
        return a.to(state.slot.device)
    return torch.as_tensor(a, dtype=dtype, device=state.slot.device)


def lookup_slot(state: MapState, bc):
    """Block coord [..., 3] -> pool slot (or -1), replacing Octree::fetch;
    out-of-range coordinates return -1."""
    bc = on_map(state, bc)
    b = state.slot.shape[0]
    inb = ((bc >= 0) & (bc < b)).all(-1)
    bcc = bc.clamp(0, b - 1).long()
    s = state.slot[bcc[..., 0], bcc[..., 1], bcc[..., 2]]
    return torch.where(inb, s, -1)


def lookup_slot_c(state: MapState, bx, by, bz):
    """Component-wise block coord -> pool slot (coords must be in range)."""
    b = state.slot.shape[0]
    return state.slot.reshape(-1)[(bx * b + by) * b + bz]


def get_voxel_channel_c(geom: MapGeometry, state: MapState, field: FieldSpec,
                        vx, vy, vz, channel: int, fill: float = None):
    """Read one payload channel at integer voxel coords; unallocated or
    out-of-map voxels read ``fill`` (default: the field's init value)."""
    if fill is None:
        fill = field.init[channel]
    size = geom.size
    inb = ((vx >= 0) & (vx < size) & (vy >= 0) & (vy < size)
           & (vz >= 0) & (vz < size))
    vxc = vx.clamp(0, size - 1)
    vyc = vy.clamp(0, size - 1)
    vzc = vz.clamp(0, size - 1)
    s = lookup_slot_c(state, vxc >> 3, vyc >> 3, vzc >> 3)
    ok = (s >= 0) & inb
    lin = (vxc & 7) + ((vyc & 7) << 3) + ((vzc & 7) << 6)
    flat = (s.clamp(min=0) * BLOCK_VOXELS + lin).long()
    data = state.data_x if channel == 0 else state.data_y
    return torch.where(ok, data.reshape(-1)[flat], fill)


def voxel_linear_index(local):
    """In-brick linear index, x-major like the reference (node.hpp:139-153)."""
    return (local[..., 0] + local[..., 1] * BLOCK_SIDE
            + local[..., 2] * BLOCK_SIDE * BLOCK_SIDE)


def _voxel_flat(geom: MapGeometry, state: MapState, v):
    """(ok, flat pool index) of integer voxel coords ``v`` [..., 3]: ok
    where the voxel is in the map and allocated, the index clamped to
    slot 0 elsewhere."""
    v = on_map(state, v)
    vv = v.clamp(0, geom.size - 1)
    inb = ((v >= 0) & (v < geom.size)).all(-1)
    s = lookup_slot(state, vv // BLOCK_SIDE)
    ok = (s >= 0) & inb
    lin = voxel_linear_index(vv % BLOCK_SIDE)
    return ok, (s.clamp(min=0) * BLOCK_VOXELS + lin).long()


def get_voxel(geom: MapGeometry, state: MapState, field: FieldSpec, v,
              fill: Tuple[float, float] = None):
    """Read voxels at integer coords ``v`` [..., 3] (ref Octree::get_fine,
    octree.hpp:357-380): unallocated or out-of-map voxels read ``fill``
    (default: the field's init value). Returns (x, y) of shape
    v.shape[:-1]."""
    if fill is None:
        fill = field.init
    ok, flat = _voxel_flat(geom, state, v)
    x = torch.where(ok, state.data_x.reshape(-1)[flat], fill[0])
    y = torch.where(ok, state.data_y.reshape(-1)[flat], fill[1])
    return x, y


def get_voxel_channel(geom: MapGeometry, state: MapState, field: FieldSpec,
                      v, channel: int, fill: float = None):
    """Single-channel :func:`get_voxel`."""
    if fill is None:
        fill = field.init[channel]
    ok, flat = _voxel_flat(geom, state, v)
    data = state.data_x if channel == 0 else state.data_y
    return torch.where(ok, data.reshape(-1)[flat], fill)


def get_with_coarse(geom: MapGeometry, state: MapState, field: FieldSpec,
                    v):
    """Read voxels, falling back to the finest existing coarse value
    (ref Octree::get(x,y,z), octree.hpp:333-355): the finest level l whose
    octant value exists (``mip_alloc[l]``), the voxel itself first. The
    coarse lookup clips the block coordinate to the map, so a voxel
    outside the map reads its border octant's coarse value, as JAX's."""
    v = on_map(state, v)
    x, y = get_voxel(geom, state, field, v)
    bv = torch.div(v, BLOCK_SIDE, rounding_mode="floor")
    bc = bv.clamp(0, geom.blocks_per_side - 1).long()
    have = lookup_slot(state, bv) >= 0
    for lvl in range(geom.num_levels):
        g = bc >> lvl
        at = (g[..., 0], g[..., 1], g[..., 2])
        exists = state.mip_alloc[lvl][at]
        take = exists & ~have
        x = torch.where(take, state.mip_x[lvl][at], x)
        y = torch.where(take, state.mip_y[lvl][at], y)
        have = have | exists
    return x, y


def set_voxels(state: MapState, v, x, y) -> MapState:
    """Write values into allocated voxels, IN PLACE (the port's map
    convention; JAX returns a new state): writes to unallocated or
    out-of-map voxels are dropped (ref Octree::set, octree.hpp:310-330).
    Duplicate coordinates have no defined winner. Returns ``state``."""
    v = on_map(state, v)
    s = lookup_slot(state, torch.div(v, BLOCK_SIDE, rounding_mode="floor"))
    ok = s >= 0
    flat = (s.long() * BLOCK_VOXELS
            + voxel_linear_index(v % BLOCK_SIDE).long())
    shape = ok.shape
    x = torch.as_tensor(x, dtype=torch.float32,
                        device=ok.device).expand(shape)
    y = torch.as_tensor(y, dtype=torch.float32,
                        device=ok.device).expand(shape)
    # a library call: the mask sizes its index on the host
    ok, flat = ok.reshape(-1), flat.reshape(-1)
    idx = flat[ok]
    state.data_x.view(-1)[idx] = x.reshape(-1)[ok]
    state.data_y.view(-1)[idx] = y.reshape(-1)[ok]
    return state


def count_blocks(state: MapState):
    """Number of allocated voxel blocks (ref Octree::leavesCount)."""
    return state.n_blocks


def block_origin_voxel(state: MapState):
    """Voxel coordinate of each slot's brick origin corner, i32[cap, 3]."""
    return state.block_coord * BLOCK_SIDE


def morton_keys(state: MapState):
    """Morton key per slot (sort key for serialization and sharding):
    int64 holding JAX's uint32 values (``core/morton.py``)."""
    return morton.encode_v(state.block_coord)


def _or_reduce2(occ):
    s = occ.shape[0] // 2
    return occ.reshape(s, 2, s, 2, s, 2).any(5).any(3).any(1)


def broadcast2(m):
    """[s, s, s] -> [2s, 2s, 2s], each cell to its 2x2x2 children (a view
    expansion: repeat_interleave would read its output size back from the
    device)."""
    s = m.shape[0]
    return m[:, None, :, None, :, None].expand(s, 2, s, 2, s, 2) \
        .reshape(2 * s, 2 * s, 2 * s)


def refresh_mip_alloc(geom: MapGeometry, state: MapState, block_alloc,
                      extra_levels=None):
    """Recompute which coarse octant values exist (JAX core/map.py:345-391,
    the dense rule): an octant's value exists iff its parent node is
    occupied. Monotonic: ORs into ``state.mip_alloc`` in place.

    ``extra_levels[l]`` (optional bool[B>>l]^3, or None) ORs in octants
    allocated directly at level l (OFusion's coarse free-space
    allocation) before the next level is reduced from it."""
    nl = geom.num_levels

    def with_extra(occ, lvl):
        if extra_levels is not None and lvl < len(extra_levels) \
                and extra_levels[lvl] is not None:
            return occ | extra_levels[lvl]
        return occ

    occ = with_extra(block_alloc, 0)
    occupied = [occ]
    for lvl in range(1, nl):
        occ = with_extra(_or_reduce2(occ), lvl)
        occupied.append(occ)
    occupied[nl - 1] = torch.ones_like(occupied[nl - 1])  # root node
    for lvl in range(nl - 1):
        state.mip_alloc[lvl].logical_or_(broadcast2(occupied[lvl + 1]))
    return state
