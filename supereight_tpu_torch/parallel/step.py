"""Fused whole-frame step: preprocess -> track -> allocate -> integrate ->
raycast, on torch tensors, for the TSDF and the OFusion field.

Port of ``supereight_tpu/parallel/step.py:frame_step``. JAX compiled the
frame into one XLA program for each set of static arguments (its jit,
70-81); :class:`FrameProgram` is that program here: one CUDA graph of the
whole :func:`frame_step` a set of static arguments, replayed once a
frame. :func:`frame_step` itself runs eagerly, the sequence of the
hand-written kernels K7 (the input filter, if any, and the pyramid), the pose prologue
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
reads for the per-stage breakdown; with no profiler active a span is a
shared no-op (``utils/spans.py``).
"""

import inspect
from typing import NamedTuple

import torch

from supereight_tpu_torch.core.map import MapState, make_map
from supereight_tpu_torch.graphs import Graphs
from supereight_tpu_torch.kernels.frame import frame_mats
from supereight_tpu_torch.kernels.raycast import Previous
from supereight_tpu_torch.ops import allocation, integration, raycast, \
    tracking
from supereight_tpu_torch.pipeline import preprocess_and_pyramid
from supereight_tpu_torch.utils.spans import span


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
    with span("frame_step/preprocess"):
        depths, verts, norms, valids = preprocess_and_pyramid(
            depth_m, k, len(iterations), neg_y, filter_input)

    # ---- tracking (or ground-truth bypass), then the frame's pose,
    # gates and matrices (the pose prologue) ----------------------------
    with span("frame_step/track"):
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
    with span("frame_step/allocate"):
        m2, astats = allocate(geom, state.map, depths[0], mats.pose, k, mu,
                              with_stats=True, when=mats.do_integrate,
                              budget=alloc_budget, mats=mats)
    fuse_depth = depths[0] if fuse_filtered else depth_m
    with span("frame_step/integrate"):
        new_map, istats = integration.integrate(
            geom, m2, field, fuse_depth, mats.pose, k, mu, mats.timestamp,
            frame_size, budget=budget, depth_interp=depth_interp,
            with_stats=True, when=mats.do_integrate,
            noise_weighted=noise_weighted, mats=mats)

    # ---- raycast: primed with this frame's raw depth, gated by the map's
    # maturity (TSDF min_ref_weight), kept from frame 3 -------------------
    with span("frame_step/raycast"):
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


# the aux entries that are one value each, in the order of the row
# FrameProgram packs them into (aux["scalars"], i32[9])
AUX_SCALARS = ("tracked", "integrated", "n_blocks", "alloc_overflow",
               "blocks_truncated", "patch_skipped", "mip_skipped",
               "ray_overflow", "pool_bucket_overflow")
# frame_step's static keywords, in its order, with their defaults
# (inspect's ``empty``: required); geom and field belong to the program
STATIC = tuple((name, p.default)
               for name, p in inspect.signature(frame_step).parameters.items()
               if p.kind is p.KEYWORD_ONLY)


def static_key(**kw):
    """The key of one set of :func:`frame_step`'s static keywords: every
    keyword in :data:`STATIC`'s order, defaults filled in, ``iterations``
    as a tuple."""
    unknown = set(kw) - {name for name, _ in STATIC}
    if unknown:
        raise TypeError(f"frame_step takes no keyword {sorted(unknown)}")
    key = []
    for name, default in STATIC:
        value = kw.get(name, default)
        if value is inspect.Parameter.empty:
            raise TypeError(f"frame_step needs the keyword {name!r}")
        key.append((name, tuple(value) if name == "iterations" else value))
    return tuple(key)


def state_leaves(state: FrameState):
    """Every tensor of a frame state, the map's mip tuples flattened."""
    out = []
    for v in (*state.map, *state[1:]):
        out.extend(v if isinstance(v, tuple) else (v,))
    return out


class FrameProgram:
    """:func:`frame_step` as one CUDA graph for each set of static
    arguments: the counterpart of JAX's jit of it (``parallel/step.py:
    70-81``).

    The program owns a frame state (``state``, adopted at construction:
    the caller must not use it otherwise) and the buffers of the dynamic
    arguments (``depth``, ``k``, ``frame`` an i32[], ``gt_pose`` a
    [4, 4]), each at a fixed address. A call copies its arguments into
    them and runs the frame as the graph of its set of static keywords
    (:class:`~supereight_tpu_torch.graphs.Graphs`: the first call with a
    set runs it eagerly on the program's capture stream and captures it,
    every later call is one replay on the current stream), so a new
    integration budget bucket captures a new graph, as JAX recompiles.
    Inside the graph the new
    pose, raycast pose and reference maps (and any map leaf the step did
    not update in place) are copied back into the state's own tensors,
    so the next replay reads them where the graph looks, and the aux's
    one-value entries are packed into ``aux["scalars"]`` (i32[9], in
    :data:`AUX_SCALARS` order). Each replay rewrites the returned aux and
    state: a caller that keeps them across frames copies them (the row is
    one copy). A capture or a replay that fails raises; nothing falls
    back to the eager step. On the CPU (the caller must ask for it, as
    the tests do) each call runs :func:`frame_step` eagerly through the
    same buffers, copies and packing.
    """

    def __init__(self, geom, field, state: FrameState):
        self.geom, self.field, self.state = geom, field, state
        dev = self.device = state.pose.device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"FrameProgram: unsupported device {dev}")
        h, w = state.valid.shape
        f32 = dict(dtype=torch.float32, device=dev)
        self.depth = torch.zeros((h, w), **f32)
        self.k = torch.zeros(4, **f32)
        self.frame = torch.zeros((), dtype=torch.int32, device=dev)
        self.gt_pose = torch.zeros((4, 4), **f32)
        self.input_ops = 0  # device ops the last call's input copies took
        # static_key -> Entry, whose ``out`` is (aux, the ops of _run)
        self._graphs = Graphs(dev)

    @property
    def graphs(self):
        return self._graphs.entries

    def load(self, state: FrameState):
        """Copy ``state`` (a snapshot, or any state of the program's
        geometry) into the program's own tensors."""
        for own, new in zip(state_leaves(self.state), state_leaves(state),
                            strict=True):
            if own.shape != new.shape or own.dtype != new.dtype:
                raise ValueError(f"load: a leaf {tuple(new.shape)} "
                                 f"{new.dtype}, the program's "
                                 f"{tuple(own.shape)} {own.dtype}")
            if own.data_ptr() != new.data_ptr():
                own.copy_(new)

    def ops(self, key):
        """The program's own device ops a frame under ``key``: the input
        copies of the last call, and the copies back and the packing
        inside the graph."""
        return self.input_ops + self.graphs[key].out[1]

    def __call__(self, depth_m, k, frame, gt_pose=None, **static):
        """Frame ``frame`` (an int >= 0 or an int tensor) of ``depth_m``
        f32[H, W] with intrinsics ``k`` f32[4] (and ``gt_pose`` [4, 4]
        where ``use_gt_pose``); ``static`` is :func:`frame_step`'s
        keywords. Returns (the program's state, aux), both rewritten by
        the next call."""
        key = static_key(**static)
        use_gt = dict(key)["use_gt_pose"]
        if use_gt and gt_pose is None:
            raise ValueError("FrameProgram: use_gt_pose needs gt_pose")
        self._inputs(depth_m, k, frame, gt_pose if use_gt else None)
        aux, _ = self._graphs(key, lambda: self._run(static, use_gt))
        return self.state, aux

    def _inputs(self, depth_m, k, frame, gt_pose):
        if not isinstance(frame, torch.Tensor) and int(frame) < 0:
            raise ValueError("FrameProgram: frame must be >= 0")
        n = _put(self.depth, depth_m, "depth_m") + _put(self.k, k, "k")
        if isinstance(frame, torch.Tensor):
            n += _put(self.frame, frame.reshape(()), "frame")
        else:
            self.frame.fill_(int(frame))
            n += 1
        if gt_pose is not None:
            n += _put(self.gt_pose, gt_pose, "gt_pose")
        self.input_ops = n

    def _run(self, static, use_gt):
        """The frame through the buffers: frame_step, the copies back
        into the state's own tensors, the packed row. Returns (aux, the
        device ops of the copies and the packing)."""
        new, aux = frame_step(self.geom, self.field, self.state, self.depth,
                              self.k, self.frame,
                              self.gt_pose if use_gt else None, **static)
        ops = 0
        for own, out in zip(state_leaves(self.state), state_leaves(new),
                            strict=True):
            if own.data_ptr() != out.data_ptr():
                own.copy_(out)
                ops += 1
        one = [aux[name] for name in AUX_SCALARS]
        aux = dict(aux, scalars=torch.stack(
            [a.reshape(()).to(torch.int32) for a in one]))
        ops += 1 + sum(a.dtype != torch.int32 for a in one)
        return aux, ops


def _put(buf, x, name):
    """Copy ``x`` into the program's buffer ``buf`` (no copy where ``x``
    is ``buf``); returns the device ops it took."""
    x = torch.as_tensor(x, dtype=buf.dtype)
    if tuple(x.shape) != tuple(buf.shape):
        raise ValueError(f"FrameProgram: {name} has shape {tuple(x.shape)}, "
                         f"the program's {tuple(buf.shape)}")
    if x.device == buf.device and x.data_ptr() == buf.data_ptr():
        return 0
    buf.copy_(x)
    return 1
