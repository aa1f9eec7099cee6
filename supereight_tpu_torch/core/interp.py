"""Trilinear interpolation and the exact reference gradient over the block
map, on torch tensors.

Port of ``supereight_tpu/core/interp.py`` (31-145). Field values sit at
integer voxel coordinates and are interpolated between them (ref
se_core/include/se/octree.hpp:542-563 ``interp``); missing stencil
corners read the field's ``empty`` value (ref interp_gather.hpp:43-103)
and gradient samples its ``init`` value (ref octree.hpp:652-737 ``grad``).
JAX's single batched gather of the 8 corners and of the 32 gradient
samples is a TPU cost rule; the port gathers them the same way because it
is also the plain way, and keeps JAX's arithmetic order, which sets the
numbers.
"""

import torch

from supereight_tpu_torch.core import map as m

# corner offsets in the order of interp_offsets (interp_gather.hpp:39-41)
_OFF = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
        (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1))


def _offsets(axis, base):
    off = torch.tensor([o[axis] for o in _OFF], dtype=torch.int32,
                       device=base.device)
    return base[None] + off.reshape((8,) + (1,) * base.dim())


def interp_c(geom, state, field, px, py, pz, channel=0):
    """Trilinear interpolation at continuous voxel coords (components),
    as Octree::interp (octree.hpp:542-563): the base is floor(pos) clamped
    at 0, the fraction is taken from the unclamped floor, and missing
    corners read empty()."""
    bx, by, bz = torch.floor(px), torch.floor(py), torch.floor(pz)
    fx, fy, fz = px - bx, py - by, pz - bz
    ix = bx.to(torch.int32).clamp(min=0)
    iy = by.to(torch.int32).clamp(min=0)
    iz = bz.to(torch.int32).clamp(min=0)
    p = m.get_voxel_channel_c(geom, state, field, _offsets(0, ix),
                              _offsets(1, iy), _offsets(2, iz), channel,
                              fill=field.empty[channel])
    c00 = p[0] * (1 - fx) + p[1] * fx
    c10 = p[2] * (1 - fx) + p[3] * fx
    c01 = p[4] * (1 - fx) + p[5] * fx
    c11 = p[6] * (1 - fx) + p[7] * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def interp(geom, state, field, pos, channel=0):
    """Stacked-[..., 3] form of :func:`interp_c`."""
    pos = m.on_map(state, pos, torch.float32)
    return interp_c(geom, state, field, pos[..., 0], pos[..., 1],
                    pos[..., 2], channel)


# The 4^3 gradient stencil (coordinates base-1 .. base+2 a axis) samples
# only points with at most one coordinate outside the central 2x2x2 core:
# 32 samples. Ladder index a axis: 0 = base-1, 1 = base, 2 = base+1,
# 3 = base+2 (each clamped to the map, octree.hpp:652-737).
_GRAD_SAMPLES = [(i, j, k) for i in range(4) for j in range(4)
                 for k in range(4)
                 if sum(1 for v in (i, j, k) if v in (0, 3)) <= 1]
_GRAD_ID = {s: n for n, s in enumerate(_GRAD_SAMPLES)}


def grad_c(geom, state, field, px, py, pz, channel=0):
    """Field gradient at continuous voxel coords (component form), as
    Octree::grad (octree.hpp:652-737): trilinearly interpolated central
    differences over a ladder clamped to the map, scaled by 0.5 *
    voxel_size. Missing samples read the field's init value. Returns
    (gx, gy, gz)."""
    size = geom.size

    def ladder(b):  # [4, ...] clamped coordinate ladder along one axis
        return torch.stack([(b - 1).clamp(min=0), b.clamp(min=0),
                            (b + 1).clamp(max=size - 1),
                            (b + 2).clamp(max=size - 1)])

    bx, by, bz = torch.floor(px), torch.floor(py), torch.floor(pz)
    fx, fy, fz = px - bx, py - by, pz - bz
    lx = ladder(bx.to(torch.int32))
    ly = ladder(by.to(torch.int32))
    lz = ladder(bz.to(torch.int32))
    dev = px.device

    def pick(lad, axis):
        idx = torch.tensor([s[axis] for s in _GRAD_SAMPLES], device=dev)
        return lad[idx]

    vals = m.get_voxel_channel_c(geom, state, field, pick(lx, 0),
                                 pick(ly, 1), pick(lz, 2), channel,
                                 fill=field.init[channel])

    def p(i, j, k):
        return vals[_GRAD_ID[(i, j, k)]]

    def dx(jy, kz):
        return ((p(2, jy, kz) - p(0, jy, kz)) * (1 - fx)
                + (p(3, jy, kz) - p(1, jy, kz)) * fx)

    gx = ((dx(1, 1) * (1 - fy) + dx(2, 1) * fy) * (1 - fz)
          + (dx(1, 2) * (1 - fy) + dx(2, 2) * fy) * fz)

    def dy(ix, kz):
        return ((p(ix, 2, kz) - p(ix, 0, kz)) * (1 - fy)
                + (p(ix, 3, kz) - p(ix, 1, kz)) * fy)

    gy = ((dy(1, 1) * (1 - fx) + dy(2, 1) * fx) * (1 - fz)
          + (dy(1, 2) * (1 - fx) + dy(2, 2) * fx) * fz)

    def dz(ix, jy):
        return ((p(ix, jy, 2) - p(ix, jy, 0)) * (1 - fz)
                + (p(ix, jy, 3) - p(ix, jy, 1)) * fz)

    gz = ((dz(1, 1) * (1 - fx) + dz(2, 1) * fx) * (1 - fy)
          + (dz(1, 2) * (1 - fx) + dz(2, 2) * fx) * fy)

    s = 0.5 * geom.voxel_size
    return gx * s, gy * s, gz * s


def grad(geom, state, field, pos, channel=0):
    """Stacked-[..., 3] form of :func:`grad_c`."""
    pos = m.on_map(state, pos, torch.float32)
    return torch.stack(grad_c(geom, state, field, pos[..., 0], pos[..., 1],
                              pos[..., 2], channel), -1)
