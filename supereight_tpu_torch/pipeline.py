"""The dense SLAM pipeline: the input pyramid and the class pipeline.

Port of ``supereight_tpu/pipeline.py``: :func:`preprocess_and_pyramid`
(``_preprocess_and_pyramid``, on kernel K7) and :class:`DenseSLAMSystem`
(61-407; behavioral reference DenseSLAMSystem,
se_denseslam/include/se/DenseSLAMSystem.h:58-411), a stateful shell over
the port's stage ops (``ops/tracking``, ``ops/allocation``,
``ops/integration``, ``ops/raycast``, ``ops/rendering``) on torch tensors.

The class keeps the JAX class's own rules, which are not the fused frame
step's (``parallel/step.py``): the self-sizing allocation budget, the
integration budget and raycast pool bucket from the live block count,
the rate gates on the host, the ground-truth bypass of
:meth:`DenseSLAMSystem.process_frame`, the TSDF maturity gate after the
raycast, and the raw depth for the raycast's prime and for fusion. Its
host reads (``bool(tracked)``, ``int(n_blocks)`` once a frame that
integrates or raycasts, the overflow poll every 8th frame, and with
keyframes on the keyframe step's reads on keyframe frames) are those
rules' semantics, as in JAX's class: JAX reads the block count for the
integration and again for the raycast, and only allocation changes it,
so the class keeps the integration's bucket for the raycast of the same
frame. The keyframe pose graph (``posegraph/``) and the marching-cubes
export (``io/meshing.py``) hang off the class as in JAX's.

Under a profiler each stage method runs in a span of its own
(``utils/spans.py``): ``pipeline/preprocessing``, ``pipeline/tracking``
(also the ground-truth bypass), ``pipeline/integration`` (allocation,
the bucket and fusion), ``pipeline/raycasting`` and
``pipeline/render_views``. Inside them a ``pipeline/wait/<what>`` span
wraps each call at which the host waits for the device: ``depth`` the
depth frame's upload from pageable host memory, ``gt_pose`` a
ground-truth pose's copy in, ``tracked`` the tracking verdict's read,
``n_blocks`` the block count's, ``alloc_overflow`` the overflow poll
(on the frames that poll) and ``composite`` a rendered frame's copy to
the host. With no profiler active they create nothing.

JAX's class is "a thin stateful shell over jitted functional stages": each
stage is one compiled program for each set of its static arguments. Here
each stage is one CUDA graph for each set, captured the first time the
set is seen and replayed on every later frame (``graphs.py``); the host
reads above split a frame into those stages.
"""

from typing import Optional, Tuple

import numpy as np
import torch

from supereight_tpu_torch.config import Configuration, default_camera
from supereight_tpu_torch.constants import DIST_THRESHOLD
from supereight_tpu_torch.core import se3
from supereight_tpu_torch.core.map import MapGeometry, make_map
from supereight_tpu_torch.fields import get_field
from supereight_tpu_torch.graphs import Graphs
from supereight_tpu_torch.kernels import preprocess
from supereight_tpu_torch.kernels.alloc import ALLOC_BUDGET
from supereight_tpu_torch.kernels.frame import (frame_mats,
                                                frame_mats_buffers,
                                                frame_mats_views)
from supereight_tpu_torch.ops import (allocation, integration, raycast,
                                      rendering, tracking)
from supereight_tpu_torch.ops.preprocess import meters, sample_mm
from supereight_tpu_torch.utils.spans import span, spanned

# the drop counters the stages write into ``stats``
STATS = ("alloc_overflow", "blocks_truncated", "patch_skipped",
         "mip_skipped", "ray_overflow")


def preprocess_and_pyramid(depth_m, k, levels: int, neg_y: bool,
                           filter_input, out=None):
    """Filter, then build the depth/vertex/normal pyramid (ref
    DenseSLAMSystem::preprocessing + tracking's pyramid prep,
    DenseSLAMSystem.cpp:128-164).

    ``filter_input`` dispatches as JAX's (pipeline.py:36-45): "median" is
    one 3x3 median pass, "median2" two, any other true value (True,
    "bilateral") the reference's 5x5 bilateral filter, and a false value
    no filter. Returns (depths, verts, norms, valids), tuples finest
    first; depths[0] is the filtered depth. ``out`` is the pyramid's
    (kernels/preprocess.pyramid_buffers).
    """
    if filter_input == "median":
        d0 = preprocess.median_filter3(depth_m)
    elif filter_input == "median2":
        d0 = preprocess.median_filter3(depth_m, passes=2)
    elif filter_input:
        d0 = preprocess.bilateral_filter(depth_m)
    else:
        d0 = depth_m
    return preprocess.pyramid(d0, k, levels, neg_y, out=out)


def _np(t):
    # a copy: the class rewrites its own tensors in place
    return t.detach().to("cpu", copy=True).numpy()


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return (x,)
    return tuple(t for v in x for t in _leaves(v))


class DenseSLAMSystem:
    """Stateful pipeline facade (ref DenseSLAMSystem.h:58-411) on
    ``device``, the card unless the caller asks for another.

    Its stages (:meth:`preprocessing`, :meth:`tracking`, the allocation
    and the fusion of :meth:`integration`, :meth:`raycasting`) read and
    write the class's own tensors, which keep their addresses for the
    pipeline's life: the pose, old pose, raycast pose, reference maps,
    reduction, track result, float depth, pyramid, map and ``stats``,
    and the inputs (the sampled depth frame, the time stamp). On the card
    each stage is one CUDA graph for each set of its static arguments,
    captured on the first frame of the set after running it eagerly
    there, and replayed on every later frame; the graphs share one memory
    pool. The sets (each stage's key, after its name): ``preprocess``
    (JAX's ``_preprocess_and_pyramid``, ``pipeline.py:26``, with
    ``mm2meters``) is_mm, filter, levels, sign of fy, frame shape;
    ``track`` (``tracking.track``, ``ops/tracking.py:240``) iterations,
    threshold; ``allocate`` (``allocate_tsdf`` / ``allocate_ofusion``,
    op by op in JAX) field, allocation budget; ``fuse``
    (``integration.integrate``, ``ops/integration.py:282``) field,
    bucket, depth_interp, noise_weighted, fuse_filtered; ``raycast``
    (``raycast.raycast``, ``ops/raycast.py:798``) field, bucket,
    min_ref_weight. A render from a fresh view (:meth:`render_views`,
    :meth:`render_volume` with a ``view_pose``) is one more graph of the
    cache, ``fresh_view`` (``rendering.render_volume`` without
    ``reuse_maps``, ``ops/rendering.py:77``, and the composite:
    :class:`rendering.FreshView`) geometry, field, frame size, mu, light
    source. A capture or replay that fails raises;
    nothing falls back to the eager stages. On the CPU the stages run
    eagerly through the same tensors and copies. ``eager=True`` runs
    every stage eagerly and takes each result as it comes (JAX's
    ``disable_jit``): the reference the graphs are held to.

    What :meth:`process_frame` returns and ``stats`` hold are the class's
    own tensors (eagerly, the stages'), rewritten by the next frame: a
    caller that keeps them across frames copies them.
    """

    def __init__(self, input_size: Tuple[int, int],
                 config: Configuration,
                 init_pose: Optional[np.ndarray] = None, device="cuda",
                 eager: bool = False):
        self.config = config
        self.device = dev = torch.device(device)
        w, h = input_size
        r = config.compute_size_ratio
        self.computation_size = (w // r, h // r)

        cam = config.camera or default_camera(w, h)
        # one f32 division each, as JAX's (a CUDA tensor divided by a
        # Python scalar would be a product with its reciprocal)
        k = np.asarray(cam, np.float32) / np.float32(r)
        self.k = torch.from_numpy(k).to(dev)

        self.field = get_field(config.field)
        self.geom = MapGeometry(size=config.volume_resolution,
                                dim=config.volume_size,
                                capacity=config.resolve_capacity())
        self.map = make_map(self.geom, self.field, dev)

        if init_pose is None:
            t = np.asarray(config.initial_pos_factor) * config.volume_size
            init_pose = np.eye(4, dtype=np.float32)
            init_pose[:3, 3] = t
        self.pose = self._pose_tensor(init_pose)
        self.init_pose = self.pose.clone()
        self.old_pose = self.pose.clone()
        self.raycast_pose = self.pose.clone()

        cw, ch = self.computation_size
        f32 = dict(dtype=torch.float32, device=dev)
        self.float_depth = torch.zeros((ch, cw), **f32)
        self.vertex = torch.zeros((ch, cw, 3), **f32)
        self.normal = torch.zeros((ch, cw, 3), **f32)
        self.valid = torch.zeros((ch, cw), dtype=torch.bool, device=dev)
        self.pyr = None
        self.reduction = torch.zeros((32,), **f32)
        self.track_result = torch.zeros((ch, cw), dtype=torch.int32,
                                        device=dev)
        self._tracked = torch.zeros((), dtype=torch.bool, device=dev)

        self._iterations = tuple(config.pyramid)
        self._neg_y = float(k[1]) < 0
        # self-sizing per-frame allocation bucket (see integration())
        self._alloc_budget = ALLOC_BUDGET
        # the integration's budget bucket, kept for the same frame's
        # raycast (None: read the block count again)
        self._bucket = None
        # drop-accounting counters from the latest frame (device scalars;
        # all zero in a well-sized run)
        self.stats = {}
        # the pose-graph layer (enable_keyframes)
        self.keyframes = None
        self.trajectory_correction = np.eye(4, dtype=np.float32)

        # the stages' graphs; None: every stage eager. The outputs the
        # kernels write where they are told (the pyramid, the fusion's
        # matrices) and the rest of the class's own tensors
        self._graphs = None if eager else Graphs(dev)
        self._pyr_out = self._mats_out = None
        self._mats = None   # the allocation's matrices, for the fusion
        if not eager:
            levels = len(self._iterations)
            self._pyr_out = preprocess.pyramid_buffers(ch, cw, levels, dev)
            d0 = torch.zeros((ch, cw), **f32) if config.filter_input \
                else self.float_depth
            self.pyr = preprocess.pyramid_views(d0, self._pyr_out, levels)
            self._mats_out = frame_mats_buffers(dev)
            self._mats = frame_mats_views(self._mats_out)
            self._depth_in = torch.zeros((ch, cw), **f32)  # f32 mm
            self._timestamp = torch.zeros((), **f32)
            self._stats = {n: torch.zeros((), dtype=torch.int32, device=dev)
                           for n in STATS}
            # the fresh view's render (JAX's render_volume jit without
            # reuse_maps), a graph of its own in the stages' cache
            self._fresh = rendering.FreshView(
                self._graphs, self.map, self.float_depth, self.track_result,
                k=self.k)

    def _pose_tensor(self, pose):
        return torch.as_tensor(np.asarray(pose, np.float32)) \
            .to(self.device).clone()

    def _stage(self, key, compute):
        """Run one stage: ``compute()`` launches it from the class's
        tensors and returns its results by the attribute each goes to (a
        drop counter by its ``stats`` name). Eagerly the class takes them
        as they are; else they are copied into the class's own tensors
        (where a kernel did not write them there), all inside ``key``'s
        graph."""
        if self._graphs is None:
            for name, value in compute().items():
                if name in STATS:
                    self.stats = {**self.stats, name: value}
                else:
                    setattr(self, name, value)
            return

        def program():
            copies = 0
            for name, value in compute().items():
                if name in STATS:
                    own = self.stats[name] = self._stats[name]
                else:
                    own = getattr(self, name)
                for a, b in zip(_leaves(own), _leaves(value), strict=True):
                    if a.data_ptr() != b.data_ptr():
                        a.copy_(b)
                        copies += 1
            return copies
        self._graphs(key, program)

    def graph_stats(self):
        """The graphs captured so far and the bytes their pool holds."""
        if self._graphs is None:
            return {"graphs": 0, "pool_bytes": 0}
        return {"graphs": self._graphs.captured(),
                "pool_bytes": self._graphs.pool_bytes()}

    # ------------------------------------------------------------------
    # pipeline stages (ref DenseSLAMSystem.cpp:128-268)
    # ------------------------------------------------------------------
    @spanned("pipeline/preprocessing")
    def preprocessing(self, depth, is_mm: bool = True) -> bool:
        """depth: [H, W] u16 mm (is_mm) or f32 meters at input size
        (numpy or a tensor)."""
        cw, ch = self.computation_size
        self._bucket = None  # a new frame
        eager = self._graphs is None
        if is_mm:
            mm = sample_mm(depth, (ch, cw))
            with span("pipeline/wait/depth"):
                if eager:
                    mm = mm.to(self.device)
                else:
                    self._depth_in.copy_(mm)
                    mm = self._depth_in
        else:
            r = self.config.compute_size_ratio
            d = torch.as_tensor(np.asarray(depth, np.float32)) \
                if not isinstance(depth, torch.Tensor) else depth
            with span("pipeline/wait/depth"):
                if eager:
                    self.float_depth = d[::r, ::r].to(
                        device=self.device, dtype=torch.float32).contiguous()
                else:
                    self.float_depth.copy_(d[::r, ::r])
        levels = len(self._iterations)
        filter_input = self.config.filter_input

        def compute():
            depth_m = self.float_depth
            if is_mm:
                depth_m = meters(mm, out=None if eager else depth_m)
            return {"float_depth": depth_m,
                    "pyr": preprocess_and_pyramid(
                        depth_m, self.k, levels, self._neg_y, filter_input,
                        out=self._pyr_out)}
        self._stage(("preprocess", is_mm, filter_input, levels, self._neg_y,
                     (ch, cw)), compute)
        return True

    @spanned("pipeline/tracking")
    def tracking(self, frame: int) -> bool:
        if frame % self.config.tracking_rate != 0:
            return False

        def compute():
            _, verts, norms, valids = self.pyr
            pose, tracked, reduction, result = tracking.track(
                self.pose, self.raycast_pose, self.k, verts, norms, valids,
                self.vertex, self.normal, self.valid,
                self._iterations, self.config.icp_threshold)
            # old_pose first: it takes the pose from before tracking
            return {"old_pose": self.pose, "pose": pose,
                    "_tracked": tracked, "reduction": reduction,
                    "track_result": result}
        self._stage(("track", self._iterations, self.config.icp_threshold),
                    compute)
        with span("pipeline/wait/tracked"):
            return bool(self._tracked)

    def _budget_bucket(self) -> int:
        """The integration budget and raycast pool bucket from the live
        block count (JAX pipeline.py:144-157): the next power of two from
        1024 covering it and ``preset_budget``, clamped to capacity."""
        with span("pipeline/wait/n_blocks"):
            n_blocks = int(self.map.n_blocks)
        n = max(n_blocks, 1, self.config.preset_budget)
        bucket = 1024
        while bucket < n:
            bucket *= 2
        return min(bucket, self.geom.capacity)

    @spanned("pipeline/integration")
    def integration(self, frame: int) -> bool:
        if not (frame % self.config.integration_rate == 0 or frame <= 3):
            return False
        c = self.config
        allocate = (allocation.allocate_ofusion
                    if self.field.multiscale_alloc
                    else allocation.allocate_tsdf)

        def alloc():
            # the matrices the fusion reads too (JAX's one pose prologue)
            mats = frame_mats(self.k, self.pose, out=self._mats_out)
            _, astats = allocate(
                self.geom, self.map, self.pyr[0][0], self.pose, self.k,
                c.mu, with_stats=True, budget=self._alloc_budget,
                mats=mats)
            return {"_mats": mats, "alloc_overflow": astats["alloc_overflow"]}
        self._stage(("allocate", self.field.name, self._alloc_budget), alloc)
        # self-sizing allocation bucket (the reference allocates ALL
        # candidate octants, octree.hpp:792-817): an overflowing frame
        # doubles the bucket for later frames, polled every 8th frame;
        # the overflowed cells are re-touched next frame
        if frame % 8 == 0:
            with span("pipeline/wait/alloc_overflow"):
                overflowed = int(self.stats["alloc_overflow"]) > 0
            if overflowed:
                b = self.geom.blocks_per_side
                self._alloc_budget = min(2 * self._alloc_budget, b ** 3)
        # JAX's Python float time stamp, rounded to f32 as its jit does
        stamp = np.float32((1.0 / 30.0) * frame)
        if self._graphs is None:
            self._timestamp = torch.tensor(stamp, device=self.device)
        else:
            self._timestamp.fill_(float(stamp))
        # allocation was the last change to the block count this frame
        self._bucket = bucket = self._budget_bucket()

        def fuse():
            # fuse_filtered: the noise-grade deviation (the reference
            # fuses the raw float_depth_)
            depth = self.pyr[0][0] if c.fuse_filtered else self.float_depth
            _, istats = integration.integrate(
                self.geom, self.map, self.field, depth, self.pose, self.k,
                c.mu, self._timestamp, self.computation_size, bucket,
                depth_interp=c.depth_interp, with_stats=True,
                noise_weighted=c.noise_weighted, mats=self._mats)
            return {n: istats[n] for n in STATS[1:4]}
        self._stage(("fuse", self.field.name, bucket, c.depth_interp,
                     c.noise_weighted, c.fuse_filtered), fuse)
        return True

    @spanned("pipeline/raycasting")
    def raycasting(self, frame: int) -> bool:
        bucket, self._bucket = self._bucket, None
        if frame <= 2:
            return False
        if bucket is None:  # no integration since the map last changed
            bucket = self._budget_bucket()
        gate = self.config.min_ref_weight

        def compute():
            view = frame_mats(self.k, self.pose).kpose
            # primed by the raw depth; a TSDF min_ref_weight > 0 is the
            # map-maturity ICP gate (K1's gated launch)
            vertex, normal, valid, rstats = raycast.raycast(
                self.geom, self.map, self.field, view, self.config.mu,
                self.computation_size, depth=self.float_depth, k=self.k,
                with_stats=True, pool_bucket=bucket, min_ref_weight=gate)
            return {"raycast_pose": self.pose, "vertex": vertex,
                    "normal": normal, "valid": valid,
                    "ray_overflow": rstats["ray_overflow"]}
        self._stage(("raycast", self.field.name, bucket, gate), compute)
        return True

    def process_frame(self, depth, frame: int, is_mm: bool = True,
                      gt_pose: Optional[np.ndarray] = None) -> dict:
        """One full frame (ref benchmark.cpp:115-177 /
        mainQt.cpp:201-313).

        gt_pose: ground-truth camera-to-world pose; when given, tracking
        is bypassed (ref mainQt.cpp:257-265 setPose path). The counters
        returned are the class's ``stats`` tensors, rewritten by the next
        frame.
        """
        self.preprocessing(depth, is_mm=is_mm)
        if gt_pose is not None:
            # the class's stand-in for tracking
            with span("pipeline/tracking"), span("pipeline/wait/gt_pose"):
                self.set_pose(gt_pose)
            tracked = True
        else:
            tracked = self.tracking(frame)
        integrated = False
        if tracked or frame <= 3:
            integrated = self.integration(frame)
        raycasted = self.raycasting(frame)
        if self.keyframes is not None and tracked and gt_pose is None \
                and frame > 2:
            self._keyframe_step(frame)
        return {"tracked": tracked, "integrated": integrated,
                "raycasted": raycasted, **self.stats}

    # ------------------------------------------------------------------
    # windowed pose-graph BA (no reference equivalent: keyframe graph,
    # loop-closure re-localization, Gauss-Newton window optimization)
    # ------------------------------------------------------------------
    def enable_keyframes(self, every: int = 10, window: int = 32,
                         ba_every: int = 4, loop_closure: bool = True,
                         reanchor: bool = False,
                         closure_dist: float = 1.0):
        """Turn on keyframe recording and windowed BA (JAX
        pipeline.py:252-274).

        ``every``: keyframe cadence in frames. ``ba_every``: optimize the
        window every N keyframes (and at once after a loop closure).
        ``loop_closure``: re-localize against the stored raycast maps of a
        revisited keyframe (K6, with a 3x distance gate) and add that
        constraint. ``reanchor``: also left-multiply the live pose by the
        latest correction (off by default: the corrections reach the
        output trajectory through ``trajectory_correction``).
        ``closure_dist``: the revisit radius (m); it must exceed the
        keyframe spacing, or a loop that closes between keyframes finds
        no candidate.
        """
        from supereight_tpu_torch.posegraph.keyframes import KeyframeManager
        self.keyframes = KeyframeManager(window=window, keyframe_every=every,
                                         device=self.device)
        self._ba_every = ba_every
        self._loop_closure = loop_closure
        self._reanchor = reanchor
        self._closure_dist = closure_dist
        self._pending_ba = False

    def _keyframe_step(self, frame: int):
        """Record a keyframe on schedule, try a loop closure against the
        nearest revisited keyframe, and optimize the window when due (JAX
        pipeline.py:276-326). On a keyframe frame it reads the pose and
        the reduction to the host once, and a closure try's verdict, inlier
        count and pose once: those reads are the class's semantics. On
        other frames it reads nothing."""
        km = self.keyframes
        if frame % km.keyframe_every != 0:
            return
        host = torch.cat([self.pose.reshape(16), self.reduction]) \
            .cpu().numpy()
        km.maybe_add(frame, host[:16].reshape(4, 4), host[16:],
                     ref_maps=(self.vertex, self.normal, self.valid))
        idx = len(km.poses) - 1
        if self._loop_closure:
            cand = km.nearest_revisit(km.poses[idx],
                                      max_dist=self._closure_dist)
            if cand is not None and km.ref_maps[cand] is not None:
                rv, rn, rok = km.ref_maps[cand]
                _, verts, norms, valids = self.pyr
                # a relaxed residual gate (3x the tracker's 0.1 m): a
                # closure exists because the live pose has drifted
                # decimeters from the revisited keyframe
                pose_lc, ok_lc, red, _ = tracking.track(
                    self.pose, self._pose_tensor(km.poses[cand]), self.k,
                    verts, norms, valids, rv, rn, rok, self._iterations,
                    self.config.icp_threshold,
                    dist_threshold=3.0 * DIST_THRESHOLD)
                lc = torch.cat([ok_lc.reshape(1).to(torch.float32),
                                red[28:29], pose_lc.reshape(16)]) \
                    .cpu().numpy()
                if lc[0]:
                    t_meas = np.linalg.inv(km.poses[cand]) \
                        @ lc[2:].reshape(4, 4)
                    w = max(float(lc[1]), 1.0) ** 0.5
                    km.add_loop_closure(cand, idx, t_meas, w)
                    self._pending_ba = True
        if self._pending_ba or (len(km.poses) % self._ba_every == 0
                                and len(km.edges) > 0):
            km.optimize()
            corr = km.correction_for_latest()
            self.trajectory_correction = corr
            if self._reanchor:
                self.set_pose(se3.matmul4(self._pose_tensor(corr),
                                          self.pose))
            self._pending_ba = False

    # ------------------------------------------------------------------
    # rendering + export (ref DenseSLAMSystem.cpp:270-322)
    # ------------------------------------------------------------------
    def render_depth(self):
        return _np(rendering.render_depth(self.float_depth))

    def render_track(self):
        return _np(rendering.render_track(self.track_result))

    def render_volume(self, view_pose=None):
        """The shaded surface from the raycast pose (the tracking maps
        reused) or from ``view_pose`` (K1's unprimed march). Off
        ``eager``, a fresh view is a replay of the fresh-view graph, and
        only its composite's volume quadrant is read; eagerly, its march
        and one ``render_volume`` launch."""
        if view_pose is not None and self._graphs is not None:
            w, h = self.computation_size
            return _np(self._composite(view_pose)[h:, w:])
        reuse = view_pose is None
        pose = self.raycast_pose if reuse else self._pose_tensor(view_pose)
        return _np(rendering.render_volume(
            self.geom, self.map, self.field, pose, self.k, self.config.mu,
            self.computation_size, vertex=self.vertex, normal=self.normal,
            valid=self.valid, reuse_maps=reuse))

    @spanned("pipeline/render_views")
    def render_views(self, view_pose=None):
        """A rendered frame: the depth, track and volume renders (the
        volume as :meth:`render_volume` takes it) in the viewer's 2x2
        composite, one launch (K10 ``render_views``, after a fresh view's
        march) and one device-to-host copy; off ``eager`` a fresh view is
        one replay of its graph (:class:`rendering.FreshView`, one a
        field, frame size and mu). Returns (composite u8[2H, 2W, 4], depth,
        track, volume): numpy arrays, the three images views into the
        composite, which is a fresh array each call. A fresh view's maps
        are scratch: the tracking maps stay as they were."""
        comp = self._composite(view_pose)
        with span("pipeline/wait/composite"):
            comp = _np(comp)
        h, w = comp.shape[0] // 2, comp.shape[1] // 2
        return comp, comp[:h, w:], comp[h:, :w], comp[h:, w:]

    def _composite(self, view_pose=None):
        """:meth:`render_views`' composite, on the class's device; a fresh
        view's is the fresh-view graph's output, rewritten by its next
        replay."""
        if view_pose is not None and self._graphs is not None:
            return self._fresh(self.geom, self.field,
                               np.asarray(view_pose, np.float32), self.k,
                               self.config.mu, self.computation_size)
        reuse = view_pose is None
        pose = self.raycast_pose if reuse else self._pose_tensor(view_pose)
        return rendering.render_views(
            self.float_depth, self.track_result, self.geom, self.map,
            self.field, pose, self.k, self.config.mu, self.computation_size,
            vertex=self.vertex, normal=self.normal, valid=self.valid,
            reuse_maps=reuse)

    def dump_mesh(self, filename: str):
        """Marching-cubes surface export (ref dump_mesh,
        DenseSLAMSystem.cpp:302-322): the map is downloaded once and
        meshed on the host; writes ``.obj``, else ``.vtk``. Returns the
        triangles [N, 3, 3] (m)."""
        from supereight_tpu_torch.io import meshing
        tris = meshing.marching_cubes(self.geom, self.map)
        if filename.endswith(".obj"):
            meshing.write_obj(filename, tris)
        else:
            meshing.write_vtk(filename, tris)
        return tris

    def save_map(self, filename: str):
        from supereight_tpu_torch.io.serialise import save_map
        save_map(filename, self.geom, self.map, self.field)

    def save_checkpoint(self, filename: str):
        """Full run checkpoint: map + pose state + raycast maps, JAX's
        files (the map's ``.npz`` and ``filename + ".run.npz"``)."""
        from supereight_tpu_torch.io.serialise import save_map
        save_map(filename, self.geom, self.map, self.field)
        np.savez_compressed(
            filename + ".run",
            pose=_np(self.pose),
            raycast_pose=_np(self.raycast_pose),
            vertex=_np(self.vertex),
            normal=_np(self.normal),
            valid=_np(self.valid),
        )

    def load_checkpoint(self, filename: str):
        from supereight_tpu_torch.io.serialise import load_map
        geom, state, field = load_map(filename, self.device)
        assert geom == self.geom and field.name == self.field.name, \
            "checkpoint geometry/field mismatch"
        self._bucket = None
        z = np.load(filename + ".run.npz")
        loaded = {"map": state}
        for name in ("pose", "raycast_pose", "vertex", "normal", "valid"):
            loaded[name] = torch.from_numpy(z[name]).to(self.device)
        for name, value in loaded.items():
            if self._graphs is None:
                setattr(self, name, value)
            else:  # into the tensors the graphs read
                for a, b in zip(_leaves(getattr(self, name)),
                                _leaves(value), strict=True):
                    a.copy_(b)

    # ------------------------------------------------------------------
    # getters (ref DenseSLAMSystem.h getters)
    # ------------------------------------------------------------------
    def get_position(self):
        return _np(self.pose[:3, 3])

    def get_pose(self):
        return _np(self.pose)

    def set_pose(self, pose):
        """Set the pose (host or device [4, 4]): copied into the class's
        own tensor, or eagerly rebound."""
        pose = torch.as_tensor(pose, dtype=torch.float32)
        if self._graphs is None:
            self.pose = pose.to(self.device).clone()
        else:
            self.pose.copy_(pose)

    def get_depth(self):
        return _np(self.float_depth)

    def block_count(self) -> int:
        return int(self.map.n_blocks)
