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
"""

from typing import Optional, Tuple

import numpy as np
import torch

from supereight_tpu_torch.config import Configuration, default_camera
from supereight_tpu_torch.constants import DIST_THRESHOLD
from supereight_tpu_torch.core import se3
from supereight_tpu_torch.core.map import MapGeometry, make_map
from supereight_tpu_torch.fields import get_field
from supereight_tpu_torch.kernels import preprocess
from supereight_tpu_torch.kernels.alloc import ALLOC_BUDGET
from supereight_tpu_torch.kernels.frame import frame_mats
from supereight_tpu_torch.ops import (allocation, integration, raycast,
                                      rendering, tracking)
from supereight_tpu_torch.ops.preprocess import mm2meters


def preprocess_and_pyramid(depth_m, k, levels: int, neg_y: bool,
                           filter_input):
    """Filter, then build the depth/vertex/normal pyramid (ref
    DenseSLAMSystem::preprocessing + tracking's pyramid prep,
    DenseSLAMSystem.cpp:128-164).

    ``filter_input`` dispatches as JAX's (pipeline.py:36-45): "median" is
    one 3x3 median pass, "median2" two, any other true value (True,
    "bilateral") the reference's 5x5 bilateral filter, and a false value
    no filter. Returns (depths, verts, norms, valids), tuples finest
    first; depths[0] is the filtered depth.
    """
    if filter_input == "median":
        d0 = preprocess.median_filter3(depth_m)
    elif filter_input == "median2":
        d0 = preprocess.median_filter3(depth_m, passes=2)
    elif filter_input:
        d0 = preprocess.bilateral_filter(depth_m)
    else:
        d0 = depth_m
    return preprocess.pyramid(d0, k, levels, neg_y)


def _np(t):
    return t.detach().cpu().numpy()


class DenseSLAMSystem:
    """Stateful pipeline facade (ref DenseSLAMSystem.h:58-411) on
    ``device``, the card unless the caller asks for another."""

    def __init__(self, input_size: Tuple[int, int],
                 config: Configuration,
                 init_pose: Optional[np.ndarray] = None, device="cuda"):
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
        self.init_pose = self.pose
        self.old_pose = self.pose
        self.raycast_pose = self.pose

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

    def _pose_tensor(self, pose):
        return torch.as_tensor(np.asarray(pose, np.float32)) \
            .to(self.device).clone()

    # ------------------------------------------------------------------
    # pipeline stages (ref DenseSLAMSystem.cpp:128-268)
    # ------------------------------------------------------------------
    def preprocessing(self, depth, is_mm: bool = True) -> bool:
        """depth: [H, W] u16 mm (is_mm) or f32 meters at input size
        (numpy or a tensor)."""
        cw, ch = self.computation_size
        self._bucket = None  # a new frame
        if is_mm:
            depth_m = mm2meters(depth, (ch, cw), self.device)
        else:
            r = self.config.compute_size_ratio
            d = torch.as_tensor(np.asarray(depth, np.float32)) \
                if not isinstance(depth, torch.Tensor) else depth
            depth_m = d[::r, ::r].to(device=self.device,
                                     dtype=torch.float32).contiguous()
        self.float_depth = depth_m
        self.pyr = preprocess_and_pyramid(
            depth_m, self.k, len(self._iterations), self._neg_y,
            self.config.filter_input)
        return True

    def tracking(self, frame: int) -> bool:
        if frame % self.config.tracking_rate != 0:
            return False
        self.old_pose = self.pose
        _, verts, norms, valids = self.pyr
        pose, tracked, reduction, result = tracking.track(
            self.pose, self.raycast_pose, self.k, verts, norms, valids,
            self.vertex, self.normal, self.valid,
            self._iterations, self.config.icp_threshold)
        self.pose = pose
        self.reduction = reduction
        self.track_result = result
        return bool(tracked)

    def _budget_bucket(self) -> int:
        """The integration budget and raycast pool bucket from the live
        block count (JAX pipeline.py:144-157): the next power of two from
        1024 covering it and ``preset_budget``, clamped to capacity."""
        n = max(int(self.map.n_blocks), 1, self.config.preset_budget)
        bucket = 1024
        while bucket < n:
            bucket *= 2
        return min(bucket, self.geom.capacity)

    def integration(self, frame: int) -> bool:
        if not (frame % self.config.integration_rate == 0 or frame <= 3):
            return False
        depths = self.pyr[0]
        mats = frame_mats(self.k, self.pose)
        allocate = (allocation.allocate_ofusion
                    if self.field.multiscale_alloc
                    else allocation.allocate_tsdf)
        self.map, astats = allocate(
            self.geom, self.map, depths[0], self.pose, self.k,
            self.config.mu, with_stats=True, budget=self._alloc_budget,
            mats=mats)
        # self-sizing allocation bucket (the reference allocates ALL
        # candidate octants, octree.hpp:792-817): an overflowing frame
        # doubles the bucket for later frames, polled every 8th frame;
        # the overflowed cells are re-touched next frame
        if frame % 8 == 0 and int(astats["alloc_overflow"]) > 0:
            b = self.geom.blocks_per_side
            self._alloc_budget = min(2 * self._alloc_budget, b ** 3)
        # JAX's Python float time stamp, rounded to f32 as its jit does
        timestamp = torch.tensor(np.float32((1.0 / 30.0) * frame),
                                 device=self.device)
        # allocation was the last change to the block count this frame
        self._bucket = self._budget_bucket()
        # fuse_filtered: the noise-grade deviation (the reference fuses
        # the raw float_depth_)
        fuse_depth = (self.pyr[0][0] if self.config.fuse_filtered
                      else self.float_depth)
        self.map, istats = integration.integrate(
            self.geom, self.map, self.field, fuse_depth, self.pose,
            self.k, self.config.mu, timestamp, self.computation_size,
            self._bucket, depth_interp=self.config.depth_interp,
            with_stats=True, noise_weighted=self.config.noise_weighted,
            mats=mats)
        self.stats = dict(self.stats,
                          alloc_overflow=astats["alloc_overflow"],
                          blocks_truncated=istats["blocks_truncated"],
                          patch_skipped=istats["patch_skipped"],
                          mip_skipped=istats["mip_skipped"])
        return True

    def raycasting(self, frame: int) -> bool:
        bucket, self._bucket = self._bucket, None
        if frame <= 2:
            return False
        if bucket is None:  # no integration since the map last changed
            bucket = self._budget_bucket()
        self.raycast_pose = self.pose
        view = frame_mats(self.k, self.raycast_pose).kpose
        # primed by the raw depth; a TSDF min_ref_weight > 0 is the
        # map-maturity ICP gate (K1's gated launch)
        self.vertex, self.normal, self.valid, rstats = raycast.raycast(
            self.geom, self.map, self.field, view, self.config.mu,
            self.computation_size, depth=self.float_depth, k=self.k,
            with_stats=True, pool_bucket=bucket,
            min_ref_weight=self.config.min_ref_weight)
        self.stats = dict(self.stats, ray_overflow=rstats["ray_overflow"])
        return True

    def process_frame(self, depth, frame: int, is_mm: bool = True,
                      gt_pose: Optional[np.ndarray] = None) -> dict:
        """One full frame (ref benchmark.cpp:115-177 /
        mainQt.cpp:201-313).

        gt_pose: ground-truth camera-to-world pose; when given, tracking
        is bypassed (ref mainQt.cpp:257-265 setPose path).
        """
        self.preprocessing(depth, is_mm=is_mm)
        if gt_pose is not None:
            self.pose = self._pose_tensor(gt_pose)
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
                self.pose = se3.matmul4(self._pose_tensor(corr), self.pose)
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
        reused) or from ``view_pose`` (K1's unprimed march)."""
        reuse = view_pose is None
        pose = self.raycast_pose if reuse else self._pose_tensor(view_pose)
        return _np(rendering.render_volume(
            self.geom, self.map, self.field, pose, self.k, self.config.mu,
            self.computation_size, vertex=self.vertex, normal=self.normal,
            valid=self.valid, reuse_maps=reuse))

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
        self.map = state
        self._bucket = None
        z = np.load(filename + ".run.npz")

        def t(name):
            return torch.from_numpy(z[name]).to(self.device)
        self.pose = t("pose")
        self.raycast_pose = t("raycast_pose")
        self.vertex = t("vertex")
        self.normal = t("normal")
        self.valid = t("valid")

    # ------------------------------------------------------------------
    # getters (ref DenseSLAMSystem.h getters)
    # ------------------------------------------------------------------
    def get_position(self):
        return _np(self.pose[:3, 3])

    def get_pose(self):
        return _np(self.pose)

    def set_pose(self, pose):
        self.pose = self._pose_tensor(pose)

    def get_depth(self):
        return _np(self.float_depth)

    def block_count(self) -> int:
        return int(self.map.n_blocks)
