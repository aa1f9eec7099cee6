"""Sparse-map raycasting, TSDF and OFusion: vertex/normal map extraction.

Port of ``supereight_tpu/ops/raycast.py:raycast`` (ref raycastKernel,
rendering.cpp:50-90, with the kfusion sphere tracer,
kfusion/rendering_impl.hpp:34-74, and the bfusion constant-step march,
bfusion/rendering_impl.hpp:35-68). The navigation grid is kernel K2
(``kernels/nav.py``: one i32 per block cell, the pool slot of an
allocated block, else -(1 + capped Chebyshev block distance), plus the
OFusion coarse free-space payload); the per-ray prime, march and
refinement, and the frame state's select, are kernel K1
(``kernels/raycast.py``), with the TSDF map-maturity gate; without a
depth frame the march is unprimed, as for a fresh view
(``ops/rendering.render_volume``).
"""

from supereight_tpu_torch.constants import FAR_PLANE, NEAR_PLANE
from supereight_tpu_torch.kernels.nav import nav_grid
from supereight_tpu_torch.kernels.raycast import Previous, raycast_rays


def raycast(geom, state, field, view, mu: float, frame_size, depth=None,
            k=None, max_steps: int = None, with_stats: bool = False,
            pool_bucket: int = None, prev: Previous = None,
            min_ref_weight=0, near=NEAR_PLANE, far=FAR_PLANE):
    """Vertex/normal/valid maps for tracking and rendering (ref
    raycastKernel).

    view = raycast_pose @ inverse_camera_matrix(k) (the pose prologue,
    kernels/frame.frame_mats). ``depth`` (f32[H, W]) and ``k`` (f32[4])
    prime the march, for a raycast pose that is the depth frame's pose;
    without ``depth`` the march is unprimed (JAX's raycast without
    ``prime_t``), and ``prev`` and the gate are refused. Rays run from
    ``near`` to ``far`` inside the map cube; ``pool_bucket`` None is the
    nav grid over every block; ``max_steps`` defaults to twice the map's
    side. Returns (vertex [H,W,3] world meters, normal [H,W,3], valid
    [H,W]). With ``prev`` (:class:`Previous`) they are the new frame
    state's, prev's where ``prev.when`` is False; a TSDF
    ``min_ref_weight`` > 0 clears ``valid`` where the hit's voxel has
    fused less weight (the frame step's map-maturity gate). With
    ``with_stats`` also returns {"ray_overflow", "n_blocks",
    "pool_bucket_overflow"} (i32[]: the rays still marching at the probe
    bound, the block count, the blocks past ``pool_bucket``, which read as
    unknown here) and, with ``prev``, the new state's "raycast_pose".
    """
    nav = nav_grid(geom, state, field, bucket=pool_bucket,
                   with_counts=with_stats)
    if with_stats:
        nav, counts = nav
    rays = raycast_rays(geom, state, field, nav, view, depth, k, mu,
                        frame_size, max_steps, prev, min_ref_weight, near,
                        far)
    if not with_stats:
        return rays.vertex, rays.normal, rays.valid
    stats = {"ray_overflow": rays.overflow, "n_blocks": counts[0],
             "pool_bucket_overflow": counts[1]}
    if prev is not None:
        stats["raycast_pose"] = rays.raycast_pose
    return rays.vertex, rays.normal, rays.valid, stats
