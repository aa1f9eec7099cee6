"""Sparse-map raycasting, TSDF and OFusion: vertex/normal map extraction.

Port of ``supereight_tpu/ops/raycast.py:raycast`` (ref raycastKernel,
rendering.cpp:50-90, with the kfusion sphere tracer,
kfusion/rendering_impl.hpp:34-74, and the bfusion constant-step march,
bfusion/rendering_impl.hpp:35-68). The navigation grid is kernel K2
(``kernels/nav.py``: one i32 per block cell, the pool slot of an
allocated block, else -(1 + capped Chebyshev block distance), plus the
OFusion coarse free-space payload); the per-ray march and refinement are
kernel K1 (``kernels/raycast.py``).
"""

import torch

from supereight_tpu_torch.kernels.nav import nav_grid
from supereight_tpu_torch.kernels.raycast import raycast_rays


def prime_from_depth(depth, k):
    """Per-pixel ray-parameter prediction of the surface from a depth
    frame: t = depth * |invK (x, y, 1)|, zero where depth is missing, flat
    [H*W]. Valid as a march prime when the raycast pose is the depth
    frame's pose."""
    h, w = depth.shape
    fx, fy, cx, cy = k[0], k[1], k[2], k[3]
    ys = torch.arange(h, dtype=torch.float32, device=depth.device)
    xs = torch.arange(w, dtype=torch.float32, device=depth.device)
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    ux = (px - cx) / fx
    uy = (py - cy) / fy
    t = depth * torch.sqrt(ux * ux + uy * uy + 1.0)
    return torch.where(depth > 0, t, torch.zeros_like(t)).reshape(-1)


def raycast(geom, state, field, view, mu: float, frame_size, prime_t,
            max_steps: int = None, with_stats: bool = False,
            pool_bucket: int = None):
    """Vertex/normal/valid maps for tracking (ref raycastKernel).

    view = raycast_pose @ inverse_camera_matrix(k). Returns (vertex
    [H,W,3] world meters, normal [H,W,3], valid [H,W]) plus
    {"ray_overflow": i32[]} when ``with_stats``. Only the depth-primed
    march of the fused frame step is ported: ``prime_t`` is required.
    """
    if prime_t is None:
        raise NotImplementedError("the unprimed raycast is not ported yet")
    nav = nav_grid(geom, state, field, bucket=pool_bucket)
    vertex, normal, valid, overflow = raycast_rays(
        geom, state, field, nav, view, prime_t, mu, frame_size, max_steps)
    if with_stats:
        return vertex, normal, valid, {"ray_overflow": overflow}
    return vertex, normal, valid
