"""Surface mesh extraction (marching cubes) and VTK/OBJ export.

Port of ``supereight_tpu/io/meshing.py`` (behavioral reference:
se::algorithms::marching_cube, se_core/include/se/algorithms/
meshing.hpp:115-208, and the writers writeVtkMesh / writeObjMesh,
se_denseslam/include/se/commons.h:325,393). Meshing walks only allocated
voxel blocks (+1-voxel halo), skips any cell with an unobserved corner
(weight or time stamp y == 0, meshing.hpp:131-138) and interpolates zero
crossings along cell edges. It is an offline export (``dump_mesh`` at the
end of a run), so it stays host numpy, as JAX's does: the map is
downloaded once (:func:`host_map`) and JAX's numpy code runs on it
unchanged, so the triangles equal JAX's bit for bit for the same state.
The writers prefer the native library (``io/native.py``), as JAX's do,
and fall back to Python; each path writes the bytes of JAX's same path
(the native writers print ``%g``, the Python ones each float's repr).
:data:`WRITES` counts the files each path wrote.
"""

from typing import NamedTuple

import numpy as np

from supereight_tpu_torch.constants import BLOCK_SIDE
from supereight_tpu_torch.io import native
from supereight_tpu_torch.io.mc_tables import (CORNER_A, CORNER_B,
                                               CORNER_OFFSETS, TRI_TABLE)

# blocks per chunk of the block-sparse pass: peak working set is
# ~2 x 8 x chunk x 512 f32 corner arrays ≈ 130 MB
_MESH_CHUNK = 4096

# mesh files written by each path since the process started
WRITES = {"native": 0, "python": 0}

_HALO_NEIGHBOURS = ((1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0),
                    (1, 0, 1), (0, 1, 1), (1, 1, 1))


class HostMap(NamedTuple):
    """The allocated part of a map on the host: what meshing reads."""
    n_blocks: int
    data_x: np.ndarray       # f32[n, 512]
    data_y: np.ndarray       # f32[n, 512]
    slot: np.ndarray         # i32[B, B, B]
    block_coord: np.ndarray  # i32[n, 3]


def host_map(state) -> HostMap:
    """Download the allocated part of a map once: ``n_blocks``, then
    ``data_x``, ``data_y`` and ``block_coord`` up to it, and the slot
    grid."""
    n = int(state.n_blocks)

    def np_(t):
        return t.detach().cpu().numpy()
    return HostMap(n, np_(state.data_x[:n]), np_(state.data_y[:n]),
                   np_(state.slot), np_(state.block_coord[:n]))


def _padded_blocks(geom, state: HostMap, fill_x):
    """[n, 9, 9, 9] x/y arrays: each allocated brick plus a +1 halo from
    its +x/+y/+z neighbour bricks (the reference's per-block pass walks
    the same 1-voxel overlap via octree fetches, meshing.hpp:159-208).
    Unallocated / out-of-map halo reads the init fill (y = 0 there, so
    those cells are skipped by the observed gate like the reference's
    empty fetches)."""
    n = int(state.n_blocks)
    bs = BLOCK_SIDE
    b = geom.blocks_per_side
    # brick linear layout is x + 8y + 64z -> axes come out (z, y, x)
    x = np.asarray(state.data_x[:n]).reshape(n, bs, bs, bs)
    x = x.transpose(0, 3, 2, 1)
    y = np.asarray(state.data_y[:n]).reshape(n, bs, bs, bs)
    y = y.transpose(0, 3, 2, 1)
    px = np.full((n, bs + 1, bs + 1, bs + 1), fill_x, np.float32)
    py = np.zeros((n, bs + 1, bs + 1, bs + 1), np.float32)
    px[:, :bs, :bs, :bs] = x
    py[:, :bs, :bs, :bs] = y
    slot = np.asarray(state.slot)
    coords = np.asarray(state.block_coord[:n])
    for (ox, oy, oz) in _HALO_NEIGHBOURS:
        nc = coords + np.asarray((ox, oy, oz))
        inb = (nc < b).all(axis=1)
        ncc = np.clip(nc, 0, b - 1)
        ns = slot[ncc[:, 0], ncc[:, 1], ncc[:, 2]]
        ok = inb & (ns >= 0) & (ns < n)
        idx = np.nonzero(ok)[0]
        if len(idx) == 0:
            continue
        nsl = ns[idx]
        sl = tuple(slice(0, 1) if o else slice(0, bs)
                   for o in (ox, oy, oz))
        dst = tuple(slice(bs, bs + 1) if o else slice(0, bs)
                    for o in (ox, oy, oz))
        px[(idx,) + dst] = x[nsl][(slice(None),) + sl]
        py[(idx,) + dst] = y[nsl][(slice(None),) + sl]
    return px, py


def marching_cubes(geom, state, inside=None):
    """Extract the zero-crossing surface as triangles [N, 3, 3] (meters)
    from a port map, downloaded once (:func:`host_map`).

    BLOCK-SPARSE (ref per-block marching_cube, meshing.hpp:159-208):
    processes only allocated bricks (+1-voxel halo), in chunks, so a
    512^3 map meshes without a dense size^3 intermediate. ``inside``:
    predicate on the x channel (default x < 0, the reference's dump_mesh
    lambda, DenseSLAMSystem.cpp:305-314).
    """
    state = host_map(state)
    n = state.n_blocks
    if n == 0:
        return np.zeros((0, 3, 3), np.float32)
    if inside is None:
        def inside(x):
            return x < 0.0
    bs = BLOCK_SIDE
    px, py = _padded_blocks(geom, state, fill_x=1.0)
    origins = np.asarray(state.block_coord[:n]) * bs     # [n, 3]

    out = []
    for lo in range(0, n, _MESH_CHUNK):
        hi = min(lo + _MESH_CHUNK, n)
        m = hi - lo
        # corner values for every cell of every brick in the chunk
        cx = np.empty((8, m, bs, bs, bs), np.float32)
        cy = np.empty_like(cx)
        for c, (dx, dy, dz) in enumerate(CORNER_OFFSETS):
            cx[c] = px[lo:hi, dx:bs + dx, dy:bs + dy, dz:bs + dz]
            cy[c] = py[lo:hi, dx:bs + dx, dy:bs + dy, dz:bs + dz]
        cx = cx.reshape(8, -1)
        cy = cy.reshape(8, -1)

        occupied = inside(cx)
        index = np.zeros(cx.shape[1], np.int32)
        for c in range(8):
            index |= occupied[c].astype(np.int32) << c
        observed = (cy != 0).all(axis=0)   # ref meshing.hpp:131-138
        sel = np.nonzero((index != 0) & (index != 255) & observed)[0]
        if len(sel) == 0:
            continue

        # global voxel position of each selected cell
        block_i, local = np.divmod(sel, bs ** 3)
        lx, r = np.divmod(local, bs * bs)
        ly, lz = np.divmod(r, bs)
        cell_pos = (origins[lo + block_i]
                    + np.stack([lx, ly, lz], axis=1)).astype(np.float32)

        tris_edges = TRI_TABLE[index[sel]]                # [M, 16]
        corner_vals = cx[:, sel]                          # [8, M]

        # zero-crossing vertex on each of the 12 edges of each cell
        # (ref interp_vertexes / compute_intersection, meshing.hpp:45-113)
        edge_verts = np.zeros((12, len(sel), 3), np.float32)
        for e in range(12):
            a, b = CORNER_A[e], CORNER_B[e]
            va = corner_vals[a]
            vb = corner_vals[b]
            denom = vb - va
            tpar = np.where(np.abs(denom) < 1e-12, 0.5, -va / np.where(
                np.abs(denom) < 1e-12, 1.0, denom))
            tpar = np.clip(tpar, 0.0, 1.0)
            pa = cell_pos + CORNER_OFFSETS[a]
            pb = cell_pos + CORNER_OFFSETS[b]
            edge_verts[e] = pa + tpar[:, None] * (pb - pa)

        for t in range(5):
            cols = tris_edges[:, 3 * t:3 * t + 3]
            valid = cols[:, 0] >= 0
            if not valid.any():
                break
            rows = np.nonzero(valid)[0]
            tri = np.stack([edge_verts[cols[rows, k], rows]
                            for k in range(3)], axis=1)
            out.append(tri)
    if not out:
        return np.zeros((0, 3, 3), np.float32)
    tris = np.concatenate(out, axis=0)
    return tris * geom.voxel_size


def write_vtk(path, triangles):
    """Legacy-VTK polydata export (ref writeVtkMesh, commons.h:325).

    Uses the native writer when it builds (orders of magnitude faster
    for large meshes); falls back to Python, where each coordinate is
    the repr of its np.float32."""
    if native.available() and native.write_vtk_native(path, triangles):
        WRITES["native"] += 1
        return
    WRITES["python"] += 1
    n = len(triangles)
    verts = triangles.reshape(-1, 3)
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 1.0\n")
        f.write("vtk mesh generated from supereight-tpu\nASCII\n")
        f.write("DATASET POLYDATA\n")
        f.write(f"POINTS {3 * n} FLOAT\n")
        for v in verts:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        f.write(f"POLYGONS {n} {4 * n}\n")
        for i in range(n):
            f.write(f"3 {3 * i} {3 * i + 1} {3 * i + 2}\n")


def write_obj(path, triangles):
    """Wavefront OBJ export (ref writeObjMesh, commons.h:393), native or
    Python as :func:`write_vtk`."""
    if native.available() and native.write_obj_native(path, triangles):
        WRITES["native"] += 1
        return
    WRITES["python"] += 1
    with open(path, "w") as f:
        f.write("# OBJ mesh generated from supereight-tpu\n")
        for tri in triangles:
            for v in tri:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        n = len(triangles)
        for i in range(n):
            f.write(f"f {3 * i + 1} {3 * i + 2} {3 * i + 3}\n")
