"""Fused whole-frame step: preprocess -> track -> allocate -> integrate ->
raycast, on torch tensors, for the TSDF and the OFusion field.

Port of ``supereight_tpu/parallel/step.py:frame_step``. JAX compiled the
frame into one XLA program; here it is a sequence of the hand-written
kernels K7 (the input filter, if any, and the pyramid), the pose prologue
(``kernels/frame.py``, before and after tracking: every matrix, gate and
the time stamp), K6 (the whole ICP, one launch), K5 (allocation), K3
(integration's block pass), K4 (its parent rank and node pass), K2 (nav
grid, with the block count) and K1 (raycast, with its prime, overflow
count, the TSDF map-maturity gate and the state's select), each in its
field's and options' variant, and no torch op with device work (K5's
touched grids live in the map and its allocator clears them).
Nothing inside :func:`frame_step` reads a device value back
to the host: budgets are Python ints, and the reference's rate gates are
device flags the kernels read, so on a GPU the whole frame is enqueued
without a sync. Each stage runs under a
``torch.profiler.record_function`` span named ``frame_step/<stage>``
(preprocess, track, allocate, integrate, raycast), which a profiler run
reads for the per-stage breakdown; with no profiler active a span costs
about a microsecond.
"""

from typing import NamedTuple

import torch
from torch.profiler import record_function

from supereight_tpu_torch.core.map import MapState, make_map
from supereight_tpu_torch.kernels.frame import frame_mats
from supereight_tpu_torch.kernels.raycast import Previous
from supereight_tpu_torch.ops import allocation, integration, raycast, \
    tracking
from supereight_tpu_torch.pipeline import preprocess_and_pyramid


class FrameState(NamedTuple):
    map: MapState
    pose: torch.Tensor          # camera-to-world, [4, 4]
    raycast_pose: torch.Tensor  # pose of the last raycast
    vertex: torch.Tensor        # [H, W, 3] reference maps for ICP
    normal: torch.Tensor
    valid: torch.Tensor


def init_frame_state(geom, field, frame_size, init_pose, device="cuda"):
    """The state before frame 0, on ``device`` (the card unless the caller
    asks for another)."""
    w, h = frame_size
    p = torch.as_tensor(init_pose, dtype=torch.float32)
    f32 = dict(dtype=torch.float32, device=device)
    return FrameState(
        map=make_map(geom, field, device),
        pose=p.to(device).clone(),
        raycast_pose=p.to(device).clone(),
        vertex=torch.zeros((h, w, 3), **f32),
        normal=torch.zeros((h, w, 3), **f32),
        valid=torch.zeros((h, w), dtype=torch.bool, device=device),
    )


def integration_budget(geom, n_blocks: int) -> int:
    """Static integration worklist budget from a LIVE block count: the next
    power of two covering it, clamped to capacity (JAX step.py:56-67)."""
    n = max(int(n_blocks), 1)
    bucket = 1024
    while bucket < n:
        bucket *= 2
    return min(bucket, geom.capacity)


def frame_step(geom, field, state: FrameState, depth_m, k, frame,
               gt_pose=None, *, frame_size, iterations, mu, icp_threshold,
               neg_y, filter_input, use_gt_pose=False, integration_rate=2,
               tracking_rate=1, budget=8192, depth_interp=False,
               alloc_budget=None, noise_weighted=False, min_ref_weight=0,
               fuse_filtered=False):
    """Run one full frame; returns (new_state, aux dict of device tensors).

    ``depth_m`` f32[H, W] and ``k`` f32[4] lie on the state's device;
    ``frame`` is a Python int or an int tensor. The map in ``state`` is
    updated IN PLACE (the JAX version donated it): the returned state
    shares its tensors, and the caller must not reuse the old one.

    ``budget`` is the integration worklist size (derive it from the live
    block count with :func:`integration_budget`; reading that count is
    the caller's sync, outside the frame). The aux counters
    (``alloc_overflow``, ``blocks_truncated``, ``patch_skipped``,
    ``mip_skipped``, ``ray_overflow``, ``pool_bucket_overflow``) are all
    zero in a well-sized run.

    The noise-grade options, as JAX's: ``filter_input`` (False, True or
    "bilateral", "median", "median2") filters the pyramid's level 0;
    ``fuse_filtered`` integrates that filtered depth instead of the raw
    one (allocation always marches the filtered level 0, the raycast's
    prime always reads the raw depth); ``depth_interp`` reads the block
    pass's depth bilinearly; ``noise_weighted`` weighs the TSDF block
    pass's samples by range; a TSDF ``min_ref_weight`` > 0 keeps only the
    reference pixels whose hit voxel has fused that much weight. OFusion
    ignores the last two, as JAX does (its channel y holds a timestamp,
    not a fusion weight).
    """
    dev = depth_m.device
    if isinstance(frame, torch.Tensor):
        frame = frame.to(device=dev, dtype=torch.int32)
    with record_function("frame_step/preprocess"):
        depths, verts, norms, valids = preprocess_and_pyramid(
            depth_m, k, len(iterations), neg_y, filter_input)

    # ---- tracking (or ground-truth bypass), then the frame's pose,
    # gates and matrices (the pose prologue) ----------------------------
    with record_function("frame_step/track"):
        if use_gt_pose:
            pose_t = torch.as_tensor(gt_pose, dtype=torch.float32,
                                     device=dev)
            tracked_t = None  # the ground truth counts as tracked
            reduction = torch.zeros(32, dtype=torch.float32, device=dev)
            result = torch.zeros(depth_m.shape, dtype=torch.int32,
                                 device=dev)
        else:
            pose_t, tracked_t, reduction, result = tracking.track(
                state.pose, state.raycast_pose, k, verts, norms, valids,
                state.vertex, state.normal, state.valid, iterations,
                icp_threshold)
        # the pose select and the rate gates (ref DenseSLAMSystem.cpp:
        # 206-212), every matrix of the stages below and the time stamp
        mats = frame_mats(k, pose_t, state.pose, tracked_t, frame,
                          tracking_rate, integration_rate)

    # ---- allocation + integration, masked by the rate gate -------------
    allocate = (allocation.allocate_ofusion if field.multiscale_alloc
                else allocation.allocate_tsdf)
    with record_function("frame_step/allocate"):
        m2, astats = allocate(geom, state.map, depths[0], mats.pose, k, mu,
                              with_stats=True, when=mats.do_integrate,
                              budget=alloc_budget, mats=mats)
    fuse_depth = depths[0] if fuse_filtered else depth_m
    with record_function("frame_step/integrate"):
        new_map, istats = integration.integrate(
            geom, m2, field, fuse_depth, mats.pose, k, mu, mats.timestamp,
            frame_size, budget=budget, depth_interp=depth_interp,
            with_stats=True, when=mats.do_integrate,
            noise_weighted=noise_weighted, mats=mats)

    # ---- raycast: primed with this frame's raw depth, gated by the map's
    # maturity (TSDF min_ref_weight), kept from frame 3 -------------------
    with record_function("frame_step/raycast"):
        prev = Previous(mats.do_raycast, mats.pose, state.raycast_pose,
                        state.vertex, state.normal, state.valid)
        r_vertex, r_normal, r_valid, rstats = raycast.raycast(
            geom, new_map, field, mats.kpose, mu, frame_size, depth=depth_m,
            k=k, with_stats=True, pool_bucket=budget, prev=prev,
            min_ref_weight=min_ref_weight)

    new_state = FrameState(
        map=new_map, pose=mats.pose, raycast_pose=rstats["raycast_pose"],
        vertex=r_vertex, normal=r_normal, valid=r_valid)
    aux = {"tracked": mats.tracked, "integrated": mats.do_integrate,
           "reduction": reduction, "track_result": result,
           "n_blocks": rstats["n_blocks"],
           "alloc_overflow": astats["alloc_overflow"].to(torch.int32),
           "blocks_truncated": istats["blocks_truncated"],
           "patch_skipped": istats["patch_skipped"],
           "mip_skipped": istats["mip_skipped"],
           "ray_overflow": rstats["ray_overflow"],
           # blocks past the raycast's pool bucket read as unknown there
           "pool_bucket_overflow": rstats["pool_bucket_overflow"]}
    return new_state, aux
