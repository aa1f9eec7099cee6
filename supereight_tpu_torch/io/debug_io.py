"""Debug dumps: point clouds, field slices, block lists, normals.

Port of ``supereight_tpu/io/debug_io.py`` (behavioral reference:
se_denseslam/include/se/vtk-io.h — savePointCloud (40), save3DSlice
(114-209), saveBlockList (211), printNormals (280)). The text is
formatted as JAX's, so the files are byte-equal to JAX's for the same
map; a map on the card is read with one download a dump.
"""

import numpy as np
import torch

from supereight_tpu_torch.constants import BLOCK_SIDE
from supereight_tpu_torch.core import map as m


def save_point_cloud(path, points, transform=None):
    """ASCII VTK polydata of a point set (ref vtk-io.h:40-111)."""
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    if transform is not None:
        T = np.asarray(transform)
        pts = pts @ T[:3, :3].T + T[:3, 3]
    n = len(pts)
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 1.0\n")
        f.write("point cloud\nASCII\nDATASET POLYDATA\n")
        f.write(f"POINTS {n} FLOAT\n")
        for p in pts:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")


def save_3d_slice(path, geom, state, field, lower, upper, select=None):
    """Structured-grid VTK dump of a field sub-box (ref vtk-io.h:114-209)
    read through ``core/map.get_voxel`` on the map's device.

    lower/upper: integer voxel bounds (upper exclusive); ``select(x, y)``
    picks the value written from the two channels (numpy), x by default.
    """
    if select is None:
        select = lambda x, y: x
    lo = np.asarray(lower, int)
    hi = np.asarray(upper, int)
    shape = hi - lo
    g = [np.arange(lo[a], hi[a]) for a in range(3)]
    xs, ys, zs = np.meshgrid(*g, indexing="ij")
    v = np.stack([xs, ys, zs], -1).reshape(-1, 3)
    v = torch.as_tensor(v, dtype=torch.int32, device=state.data_x.device)
    x, y = m.get_voxel(geom, state, field, v)
    x, y = torch.stack([x, y]).cpu().numpy()
    vals = np.asarray(select(x, y))
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 1.0\n")
        f.write("field slice\nASCII\nDATASET STRUCTURED_POINTS\n")
        f.write(f"DIMENSIONS {shape[0]} {shape[1]} {shape[2]}\n")
        f.write(f"ORIGIN {lo[0]} {lo[1]} {lo[2]}\n")
        f.write("SPACING 1 1 1\n")
        f.write(f"POINT_DATA {vals.size}\n")
        f.write("SCALARS scalars float 1\nLOOKUP_TABLE default\n")
        # VTK structured points expect x fastest
        for val in vals.reshape(shape).transpose(2, 1, 0).ravel():
            f.write(f"{val}\n")


def save_block_list(path, geom, state):
    """Text dump of allocated block coordinates (ref vtk-io.h:211-278)."""
    n = int(state.n_blocks)
    host = torch.cat([state.block_coord[:n],
                      state.active[:n, None].to(torch.int32)], 1).cpu()
    coords = host[:, :3].numpy() * BLOCK_SIDE
    active = host[:, 3].numpy()
    with open(path, "w") as f:
        f.write("x y z active\n")
        for c, a in zip(coords, active):
            f.write(f"{c[0]} {c[1]} {c[2]} {int(a)}\n")


def print_normals(path_png_or_txt, normals):
    """Dump a normal map as an RGB image (ref printNormals, vtk-io.h:280-294).

    Written as PPM (no image deps in the base install); ``normals`` is a
    numpy array or a tensor on any device."""
    if isinstance(normals, torch.Tensor):
        normals = normals.cpu().numpy()
    n = np.asarray(normals)
    rgb = ((n * 0.5 + 0.5) * 255).clip(0, 255).astype(np.uint8)
    h, w = rgb.shape[:2]
    with open(path_png_or_txt, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(rgb.tobytes())
