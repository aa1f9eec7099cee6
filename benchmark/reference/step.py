"""The reference of one frame of the class pipeline.

Plain PyTorch: the class's per-frame rules (``DenseSLAMSystem.
process_frame``: preprocessing, tracking or the given pose, allocation
and fusion, the raycast, and on a rendered frame the 2x2 composite)
restated over the frozen twins (``frozen/``), from a state that the
caller hands in. Nothing of the port is imported or called.

``quantise`` is applied to what each stage hands on (the depth and its
pyramid, the pose, the map's payload, the raycast's maps): the identity
for the reference, a round trip through a lower precision for the
control (:func:`bf16`).
"""

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.frozen.constants import FAR_PLANE, NEAR_PLANE
from benchmark.reference.frozen.core.map import MapGeometry, MapState
from benchmark.reference.frozen.fields import get_field
from benchmark.reference.frozen.kernels.alloc import (alloc_assign_plain,
                                                      touched_mask_plain,
                                                      touched_masks_of_plain)
from benchmark.reference.frozen.kernels.frame import frame_mats_plain
from benchmark.reference.frozen.kernels.icp import icp_track_plain
from benchmark.reference.frozen.kernels.integrate import (
    as_timestamp, integrate_fallback_plain, integrate_fused_plain,
    integrate_worklist_plain)
from benchmark.reference.frozen.kernels.nav import nav_grid_plain
from benchmark.reference.frozen.kernels.node import node_pass_plain
from benchmark.reference.frozen.kernels.preprocess import (
    bilateral_filter_plain, median_filter3_plain, pyramid_plain)
from benchmark.reference.frozen.kernels.raycast import (gated,
                                                        raycast_plain)
from benchmark.reference.frozen.kernels.render import render_views_plain
from benchmark.reference.frozen.ops.preprocess import meters, sample_mm


class Setup(NamedTuple):
    """What a frame's arithmetic takes from the configuration."""
    geom: MapGeometry
    field: object
    k: torch.Tensor          # f32[4] intrinsics at the computation size
    size: tuple              # (w, h) computation size
    mu: float
    pyramid: tuple           # ICP iterations a level, finest first
    icp_threshold: float
    filter_input: object
    fuse_filtered: bool
    depth_interp: bool
    noise_weighted: bool
    min_ref_weight: float
    preset_budget: int


class State(NamedTuple):
    """The pipeline's state between two frames."""
    pose: torch.Tensor
    raycast_pose: torch.Tensor
    vertex: torch.Tensor
    normal: torch.Tensor
    valid: torch.Tensor
    map: MapState
    alloc_budget: int


def setup(cfg: dict, device) -> Setup:
    """The :class:`Setup` of a configuration file's ``pipeline`` settings
    merged with its traffic's (a dict)."""
    w, h = cfg["input_size"]
    r = cfg["compute_size_ratio"]
    # one f32 division each, as the class's
    k = np.asarray(cfg["camera"], np.float32) / np.float32(r)
    geom = MapGeometry(size=cfg["volume_resolution"], dim=cfg["volume_size"],
                       capacity=cfg["block_capacity"])
    return Setup(geom=geom, field=get_field(cfg["field"]),
                 k=torch.from_numpy(k).to(device), size=(w // r, h // r),
                 mu=cfg["mu"], pyramid=tuple(cfg["pyramid"]),
                 icp_threshold=cfg["icp_threshold"],
                 filter_input=cfg.get("filter_input") or False,
                 fuse_filtered=cfg.get("fuse_filtered", False),
                 depth_interp=cfg.get("depth_interp", False),
                 noise_weighted=cfg.get("noise_weighted", False),
                 min_ref_weight=cfg.get("min_ref_weight", 0.0),
                 preset_budget=cfg.get("preset_budget", 0))


def identity(t):
    return t


def bf16(t):
    """The control's precision: a float tensor rounded to bfloat16 and
    back; other tensors as they are."""
    if isinstance(t, torch.Tensor) and t.is_floating_point():
        return t.to(torch.bfloat16).to(t.dtype)
    return t


def budget_bucket(s: Setup, n_blocks: int) -> int:
    """The integration budget and raycast pool bucket (the class's
    ``_budget_bucket``)."""
    n = max(n_blocks, 1, s.preset_budget)
    bucket = 1024
    while bucket < n:
        bucket *= 2
    return min(bucket, s.geom.capacity)


def preprocess(s: Setup, depth_mm, quantise=identity):
    """The frame's metres at the computation size and its pyramid
    (depths, vertices, normals, valid masks; finest first), after the
    input filter: the class's ``preprocessing``."""
    q = quantise
    cw, ch = s.size
    float_depth = q(meters(sample_mm(depth_mm, (ch, cw)).to(s.k.device)))
    f = s.filter_input
    if f == "median":
        d0 = median_filter3_plain(float_depth)
    elif f == "median2":
        d0 = median_filter3_plain(float_depth, passes=2)
    elif f:
        d0 = bilateral_filter_plain(float_depth)
    else:
        d0 = float_depth
    neg_y = float(s.k[1]) < 0
    depths, verts, norms, valids = pyramid_plain(q(d0), s.k, len(s.pyramid),
                                                 neg_y)
    return float_depth, (depths, tuple(map(q, verts)), tuple(map(q, norms)),
                         valids)


def frame(s: Setup, st: State, depth_mm, index: int, gt_pose=None,
          render=False, quantise=identity):
    """One frame from ``st`` (consumed: its map is updated in place).
    ``depth_mm`` is the frame's u16 millimetres at input size (numpy);
    ``gt_pose`` a given camera-to-world pose that replaces tracking.
    Returns a dict of what the frame leaves: ``pose``, ``tracked``,
    ``vertex``, ``normal``, ``valid``, ``map``, and on a rendered frame
    ``composite``."""
    q = quantise
    dev = s.k.device
    geom, field = s.geom, s.field
    float_depth, (depths, verts, norms, valids) = preprocess(s, depth_mm, q)
    d0 = depths[0]

    pose = st.pose
    track_result = None
    if gt_pose is not None:
        pose = torch.as_tensor(np.asarray(gt_pose, np.float32)).to(dev)
        tracked = True
    else:
        view = frame_mats_plain(s.k, st.raycast_pose).view
        pose, tracked_t, _, track_result = icp_track_plain(
            st.pose, view, verts, norms, valids, st.vertex, st.normal,
            st.valid, s.pyramid, s.icp_threshold)
        pose = q(pose)
        tracked = bool(tracked_t)
    m = st.map
    bucket = None
    if tracked or index <= 3:
        mats = frame_mats_plain(s.k, pose)
        if field.multiscale_alloc:
            masks = touched_masks_of_plain(geom, d0, pose, mats.kpose, s.mu)
            alloc_assign_plain(geom, m, masks[0], None, st.alloc_budget,
                               masks[1:])
        else:
            touched = touched_mask_plain(geom, d0, pose, mats.kpose, s.mu)
            alloc_assign_plain(geom, m, touched, None, st.alloc_budget)
        stamp = torch.tensor(float(np.float32((1.0 / 30.0) * index)),
                             dtype=torch.float32, device=dev)
        bucket = budget_bucket(s, int(m.n_blocks))
        depth = d0 if s.fuse_filtered else float_depth
        _fuse(s, m, depth, mats, stamp, bucket)
        if q is not identity:
            for t in (m.data_x, m.data_y) + m.mip_x + m.mip_y:
                t.copy_(q(t))
    vertex, normal, valid = st.vertex, st.normal, st.valid
    raycast_pose = st.raycast_pose
    if index > 2:
        if bucket is None:
            bucket = budget_bucket(s, int(m.n_blocks))
        kpose = frame_mats_plain(s.k, pose).kpose
        nav = nav_grid_plain(geom, m, field, bucket=bucket)
        gate = s.min_ref_weight
        rays = raycast_plain(geom, field, m.data_x, m.data_y, nav, kpose,
                             float_depth, s.k, s.mu, s.size,
                             slot=m.slot if gated(field, gate) else None,
                             min_ref_weight=gate, near=NEAR_PLANE,
                             far=FAR_PLANE)
        vertex, normal, valid = q(rays.vertex), q(rays.normal), rays.valid
        raycast_pose = pose
    out = dict(pose=pose, tracked=tracked, vertex=vertex, normal=normal,
               valid=valid, map=m)
    if render:
        out["composite"] = render_views_plain(float_depth, track_result,
                                              vertex, normal, valid,
                                              raycast_pose)
    return out


def _fuse(s: Setup, m, depth, mats, stamp, bucket):
    """The class's fusion (``ops/integration.integrate``), in place: the
    worklist, the block pass (the fused pass, then the exact fallback; the
    bilinear read alone with ``depth_interp``), then the node pass."""
    geom, field = s.geom, s.field
    budget = min(bucket, geom.capacity)
    ts = as_timestamp(field, stamp, depth.device)
    t_cw, kmat = mats.t_cw, mats.kmat
    wl = integrate_worklist_plain(geom, m, t_cw, kmat, s.size, budget)[0]
    if s.depth_interp:
        skipped = torch.zeros((), dtype=torch.int32, device=depth.device)
        integrate_fused_plain(geom, m, field, wl, depth, t_cw, kmat, s.mu,
                              ts, s.noise_weighted, True, skipped)
    else:
        mode, n_valid, need = integrate_fused_plain(
            geom, m, field, wl, depth, t_cw, kmat, s.mu, ts,
            s.noise_weighted)
        integrate_fallback_plain(geom, m, field, wl, depth, t_cw, kmat, s.mu,
                                 mode, n_valid, need, ts, s.noise_weighted)
    node_pass_plain(geom, m, field, depth, t_cw, kmat, s.mu, budget, ts)
