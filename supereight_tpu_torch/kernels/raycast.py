"""K1 wrapper and twin: the raycast of both fields, depth-primed (the
frame step's) or unprimed (a fresh view's).

Replaces ``supereight_tpu/ops/raycast.py:_march`` (454-769, with
``_probe`` 262-299 and the unprimed start 537-544), ``camera_zcos``
(436-452), ``prime_from_depth`` (772-795) and ``raycast_rays`` (841-899,
with ``_interp_grad`` 318-380), TSDF and OFusion branches, and the frame
step's select of the raycast's outputs
(``supereight_tpu/parallel/step.py:194-200``). The CUDA kernel is
``csrc/raycast.cu`` (one body per field and start); :func:`raycast_plain`
is the plain PyTorch version (every ray stepped in lockstep for the full
probe bound), used for CPU tensors and as the kernel's reference on the
card.

The TPU's compaction cascade, straggler tails, strip tables and nav4 grid
only shaped its cost; what they computed stays: a ray marches until it
hits, leaves its range or has taken ``max_steps + 96`` probes (the most
the JAX cascade plus its 96-step burst tier can give a ray); rays still
marching at that bound miss and count in ``ray_overflow``.
"""

from typing import NamedTuple

import numpy as np
import torch

from supereight_tpu_torch.constants import (BLOCK_SIDE, BLOCK_VOXELS,
                                            FAR_PLANE, INVALID, NEAR_PLANE,
                                            SURF_BOUNDARY)
from supereight_tpu_torch.core import se3
from supereight_tpu_torch.kernels import _lib
from supereight_tpu_torch.kernels.nav import MAX_JUMP

EXTRA_PROBES = 96    # the JAX burst tier's steps beyond max_steps
# unknown sentinel (values >= sentinel / 2 decode as unknown) and the
# refinement fill (the field's init value) of each field
# (JAX raycast.py:93-100, 508)
_SENTINEL = {"tsdf": 2.0, "ofusion": 4096.0}
_FILL = {"tsdf": 1.0, "ofusion": 0.0}
# per (device, stream handle), the kernel's i32[2] overflow scratch:
# zeroed once, and every launch leaves it zero (csrc/raycast.cu). Launches on
# one stream run one after another, so none sees another's partial count;
# launches on two streams take two scratches.
_SCRATCH = {}


class Previous(NamedTuple):
    """The frame state before the raycast, kept where ``when`` (bool[],
    the frame's prologue's frame > 2) is False, as the JAX frame step
    keeps it before frame 3; ``pose`` is the new raycast pose."""
    when: torch.Tensor
    pose: torch.Tensor
    raycast_pose: torch.Tensor
    vertex: torch.Tensor
    normal: torch.Tensor
    valid: torch.Tensor


class Rays(NamedTuple):
    """:func:`raycast_rays`'s outputs: the vertex (f32[H, W, 3]) and
    normal maps, the hit mask (bool[H, W]), ray_overflow (i32[], 0 where
    the select keeps the old state) and, with a :class:`Previous`, the new
    state's raycast pose (else None)."""
    vertex: torch.Tensor
    normal: torch.Tensor
    valid: torch.Tensor
    overflow: torch.Tensor
    raycast_pose: torch.Tensor = None


class Probes(NamedTuple):
    """What a raycast reads, from its twin (CPU and checks only):
    ``per_ray`` each ray's march probes (i32[H, W], nonzero on the rays
    that march; the start's probe is not counted), ``nav`` the nav entries
    (bool[B^3]) and ``pool`` the pool voxels (bool[capacity * 512], both
    channels) that the start probe, the march probes and the hits'
    refinement read. Each ray's march probes by kind (i32[H, W], summing
    to ``per_ray``): ``known`` those in known space that step above the
    crawl floor (TSDF; OFusion: inside an allocated block), the hit
    included; ``crawl`` the TSDF ones that step at the floor
    (f mu <= floor); ``jump`` those that jump (unknown space; OFusion:
    outside the allocated blocks). ``new_nav`` counts the march probes
    that read a nav entry: a block cell other than the last one the ray
    read, the start's probe included (the kernel keeps one entry)."""
    per_ray: torch.Tensor
    nav: torch.Tensor
    pool: torch.Tensor
    known: torch.Tensor = None
    crawl: torch.Tensor = None
    jump: torch.Tensor = None
    new_nav: torch.Tensor = None


def prime_from_depth(depth, k):
    """Per-pixel ray-parameter prediction of the surface from a depth
    frame: t = depth * |invK (x, y, 1)|, zero where depth is missing, flat
    [H*W]. Valid as a march prime when the raycast pose is the depth
    frame's pose. The kernel computes it per ray in this order."""
    h, w = depth.shape
    fx, fy, cx, cy = k[0], k[1], k[2], k[3]
    ys = torch.arange(h, dtype=torch.float32, device=depth.device)
    xs = torch.arange(w, dtype=torch.float32, device=depth.device)
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    ux = (px - cx) / fx
    uy = (py - cy) / fy
    t = depth * torch.sqrt(ux * ux + uy * uy + 1.0)
    return torch.where(depth > 0, t, torch.zeros_like(t)).reshape(-1)


def march_params(geom, field, mu: float, max_steps: int = None):
    """Scalar march constants (Python floats, rounded to f32 on use)."""
    if max_steps is None:
        max_steps = 2 * geom.size
    step = geom.voxel_size
    largestep = step * BLOCK_SIDE
    q = dict(
        max_probes=max_steps + EXTRA_PROBES,
        step=step, largestep=largestep, half_largestep=0.5 * largestep,
        bstep=BLOCK_SIDE * geom.voxel_size,
        small_backoff=0.5 * mu + 2.0 * geom.voxel_size,
        big_backoff=2.0 * mu + 2.0 * geom.voxel_size,
        floor_cap=max(float(torch.tensor(step, dtype=torch.float32)),
                      float(torch.tensor(0.4 * mu, dtype=torch.float32))),
        two_step=2.0 * step, of_cap=step)
    if field.name == "ofusion":
        # JAX evaluates these with mu as a traced f32 (raycast.py:521-522,
        # 553): the same f32 operations here
        f32 = np.float32
        mu32, two_vox = f32(mu), f32(2.0 * geom.voxel_size)
        q.update(small_backoff=float(f32(0.5) * mu32 + two_vox),
                 big_backoff=float(f32(6.0) * mu32 + two_vox),
                 of_cap=float(max(f32(step),
                                  min(f32(2.4 * step), f32(2.7) * mu32))))
    return q


def gated(field, min_ref_weight) -> bool:
    """Whether the map-maturity gate applies: TSDF only (OFusion's channel
    y is a time stamp, so JAX makes the option a no-op there)."""
    return field.name == "tsdf" and min_ref_weight > 0


def raycast_rays(geom, state, field, nav, view, depth, k, mu: float,
                 frame_size, max_steps: int = None, prev: Previous = None,
                 min_ref_weight=0, near=NEAR_PLANE, far=FAR_PLANE, x0=0,
                 width=None):
    """March every pixel ray of ``view`` (= pose @ invK, the frame's
    prologue) through the map from ``near`` to ``far`` (and the map cube),
    each primed by ``depth`` (f32[H, W], this frame's, taken at the
    raycast pose) with the intrinsics ``k`` (f32[4]); with ``depth`` None
    the march is unprimed (JAX's raycast without ``prime_t``: a ray starts
    at its near end, on the free side of the field's value there, or
    misses), ``k`` is not read, and ``prev`` and the gate are refused.

    nav: i32[B^3] navigation grid of ``field`` (kernels/nav.nav_grid).
    Returns :class:`Rays`; with ``prev`` the maps and the raycast pose are
    the new frame state's, prev's where ``prev.when`` is False. With a
    TSDF ``min_ref_weight`` > 0 a hit is valid only where its voxel, read
    through ``state.slot``, has fused at least that weight (JAX's
    map-maturity gate, before the select). ``width`` given marches only
    the rays of the image columns [x0, x0 + width) (the sharded step's
    rank slice, primed from the whole frame at those columns); the maps,
    and ``prev``'s, are then [H, width]. One launch on a CUDA device, no
    host sync; the launch count is kept per field, gate, start and window
    (``raycast``, ``raycast_gated``, ``raycast_of``, ``raycast_cold``,
    ``raycast_cold_of``, ``raycast_cols``, ``raycast_cols_of``).
    """
    dev = view.device
    gate = gated(field, min_ref_weight)
    primed = depth is not None
    if not primed and (prev is not None or gate):
        raise ValueError("raycast_rays: the unprimed march takes no select "
                         "and no maturity gate")
    w, h = frame_size
    w_out = w - x0 if width is None else width
    if not (0 <= x0 and 0 < w_out and x0 + w_out <= w):
        raise ValueError(f"raycast_rays: columns [{x0}, {x0 + w_out}) are "
                         f"not inside an image {w} wide")
    if width is not None and not primed:
        raise ValueError("raycast_rays: a column window is primed")
    if dev.type == "cpu":
        return raycast_plain(geom, field, state.data_x, state.data_y, nav,
                             view, depth, k, mu, frame_size, max_steps, prev,
                             slot=state.slot if gate else None,
                             min_ref_weight=min_ref_weight, near=near,
                             far=far, x0=x0, width=width)
    if dev.type != "cuda":
        raise ValueError(f"raycast_rays: unsupported device {dev}")
    b = geom.blocks_per_side
    cap = geom.capacity
    c = _lib.check
    c(view, "view", torch.float32, (4, 4), dev)
    c(nav, "nav", torch.int32, (b * b * b,), dev)
    c(state.data_x, "data_x", torch.float32, (cap, BLOCK_VOXELS), dev)
    c(state.data_y, "data_y", torch.float32, (cap, BLOCK_VOXELS), dev)
    if primed:
        c(depth, "depth", torch.float32, (h, w), dev)
        c(k, "k", torch.float32, (4,), dev)
    else:
        k = None
    slot = c(state.slot, "slot", torch.int32, (b, b, b), dev) if gate \
        else None
    sel = (None,) * 6
    raycast_pose = None
    if prev is not None:
        sel = (c(prev.when.reshape(()), "when", torch.bool, (), dev),
               c(prev.pose, "pose", torch.float32, (4, 4), dev),
               c(prev.raycast_pose, "raycast_pose", torch.float32, (4, 4),
                 dev),
               c(prev.vertex, "vertex", torch.float32, (h, w_out, 3), dev),
               c(prev.normal, "normal", torch.float32, (h, w_out, 3), dev),
               c(prev.valid, "valid", torch.bool, (h, w_out), dev))
        raycast_pose = torch.empty((4, 4), dtype=torch.float32, device=dev)
    q = march_params(geom, field, mu, max_steps)
    vertex = torch.empty((h, w_out, 3), dtype=torch.float32, device=dev)
    normal = torch.empty((h, w_out, 3), dtype=torch.float32, device=dev)
    valid = torch.empty((h, w_out), dtype=torch.bool, device=dev)
    overflow = torch.empty((), dtype=torch.int32, device=dev)
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    if key not in _SCRATCH:
        _SCRATCH[key] = torch.zeros(2, dtype=torch.int32, device=dev)
    of = field.name == "ofusion"
    name = ("raycast_of" if of else "raycast_gated" if gate else "raycast") \
        if primed else ("raycast_cold_of" if of else "raycast_cold")
    if width is not None:
        name = "raycast_cols_of" if of else "raycast_cols"
    _lib.launch(name, "se_raycast", dev,
                view, nav, state.data_x, state.data_y, slot,
                float(min_ref_weight), depth, k, int(of),
                w, h, x0, w_out, geom.size, b, q["max_probes"], geom.dim,
                geom.inv_voxel_size, q["step"], q["largestep"],
                q["half_largestep"], q["bstep"], float(mu), float(near),
                float(far), q["small_backoff"], q["big_backoff"],
                q["floor_cap"], q["two_step"], q["of_cap"], *sel, vertex,
                normal, valid, raycast_pose, overflow, _SCRATCH[key])
    return Rays(vertex, normal, valid, overflow, raycast_pose)


def ray_directions_c(view, width, height, x0=0):
    """Per-pixel world-space unit ray directions (ref rendering.cpp:62-65)
    of the image columns [x0, x0 + width), three flat [H*width] tensors."""
    dev = view.device
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    xs = torch.arange(width, dtype=torch.float32, device=dev) + float(x0)
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    dx, dy, dz = se3.rotate_c(view, px, py, torch.ones_like(px))
    inv = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
    return (dx * inv).reshape(-1), (dy * inv).reshape(-1), \
        (dz * inv).reshape(-1)


def camera_zcos(view, dx, dy, dz):
    """Per-ray cosine between the ray direction and the camera's optical
    axis normalize(col0 x col1) of ``view`` (JAX raycast.py:436-452), so
    the camera depth of a point at ray parameter t is t * zcos."""
    ax = view[1, 0] * view[2, 1] - view[2, 0] * view[1, 1]
    ay = view[2, 0] * view[0, 1] - view[0, 0] * view[2, 1]
    az = view[0, 0] * view[1, 1] - view[1, 0] * view[0, 1]
    inv = 1.0 / torch.sqrt(ax * ax + ay * ay + az * az)
    return dx * (ax * inv) + dy * (ay * inv) + dz * (az * inv)


def ray_box_range_c(origin, dx, dy, dz, dim, near=NEAR_PLANE, far=FAR_PLANE):
    """Clip rays against the map cube [0, dim]^3 and the near/far planes."""
    def axis(o, d):
        inv = 1.0 / torch.where(d == 0, torch.full_like(d, 1e-12), d)
        a, b = -o * inv, (dim - o) * inv
        return torch.minimum(a, b), torch.maximum(a, b)

    lo_x, hi_x = axis(origin[0], dx)
    lo_y, hi_y = axis(origin[1], dy)
    lo_z, hi_z = axis(origin[2], dz)
    tmin = torch.maximum(torch.maximum(lo_x, lo_y), lo_z)
    tmax = torch.minimum(torch.minimum(hi_x, hi_y), hi_z)
    return tmin.clamp(min=near), tmax.clamp(max=far)


def ref_weight_plain(geom, slot, data_y, vertex):
    """The gate's read (JAX core/map.py:get_voxel_channel_c, channel 1,
    fill 0): the fusion weight of the voxel at floor(vertex / voxel) of
    each f32[..., 3] vertex, through the slot grid."""
    size = geom.size
    b = slot.shape[0]
    v = torch.floor(vertex * geom.inv_voxel_size).to(torch.int32)
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    inb = ((vx >= 0) & (vx < size) & (vy >= 0) & (vy < size)
           & (vz >= 0) & (vz < size))
    vx, vy, vz = (a.clamp(0, size - 1) for a in (vx, vy, vz))
    s = slot.reshape(-1)[(((vx >> 3) * b + (vy >> 3)) * b
                          + (vz >> 3)).long()]
    lin = (vx & 7) + ((vy & 7) << 3) + ((vz & 7) << 6)
    w = data_y.reshape(-1)[(s.clamp(min=0) * BLOCK_VOXELS + lin).long()]
    return torch.where((s >= 0) & inb, w, torch.zeros_like(w))


def raycast_plain(geom, field, data_x, data_y, nav, view, depth, k,
                  mu: float, frame_size, max_steps: int = None,
                  prev: Previous = None, with_probes: bool = False,
                  slot=None, min_ref_weight=0, near=NEAR_PLANE,
                  far=FAR_PLANE, x0=0, width=None):
    """Plain PyTorch twin of :func:`raycast_rays` (data_x/data_y are the
    map's pool channels, ``slot`` its slot grid, read by the TSDF gate
    when ``min_ref_weight`` > 0): :func:`prime_from_depth` (none where
    ``depth`` is None: the unprimed start), the march, the gate and the
    select of ``prev`` as the JAX frame step makes them; with ``width``
    the image columns [x0, x0 + width) alone, as JAX's sharded step slices
    them (``dist_step.py:411-419``). With ``with_probes`` returns (rays,
    :class:`Probes`)."""
    prime = None
    if depth is not None:
        prime = prime_from_depth(depth, k)
        if width is not None:
            h, w = depth.shape
            prime = prime.view(h, w)[:, x0:x0 + width].reshape(-1)
    rays, probes = march_plain(geom, field, data_x, data_y, nav, view,
                               prime, mu, frame_size, max_steps, with_probes,
                               near, far, x0, width)
    if gated(field, min_ref_weight):
        w_ref = ref_weight_plain(geom, slot, data_y, rays.vertex)
        rays = rays._replace(valid=rays.valid & (w_ref >= min_ref_weight))
    if prev is not None:
        when = prev.when
        rays = Rays(torch.where(when, rays.vertex, prev.vertex),
                    torch.where(when, rays.normal, prev.normal),
                    torch.where(when, rays.valid, prev.valid),
                    torch.where(when, rays.overflow,
                                torch.zeros_like(rays.overflow)),
                    torch.where(when, prev.pose, prev.raycast_pose))
    return (rays, probes) if with_probes else rays


def march_plain(geom, field, data_x, data_y, nav, view, prime_t, mu: float,
                frame_size, max_steps: int = None, with_probes: bool = False,
                near=NEAR_PLANE, far=FAR_PLANE, x0=0, width=None):
    """The march of :func:`raycast_plain` from a given prime (f32[H*W],
    :func:`prime_from_depth`; None for the unprimed start) between
    ``near`` and ``far``: (:class:`Rays` without a raycast pose,
    :class:`Probes` with ``with_probes``, else None); with ``width`` the
    rays of the image columns [x0, x0 + width) (the prime is theirs)."""
    w, h = frame_size
    if width is not None:
        w = width
    size, b = geom.size, geom.blocks_per_side
    iv = geom.inv_voxel_size
    of = field.name == "ofusion"
    unk, fill = _SENTINEL[field.name], _FILL[field.name]
    q = march_params(geom, field, mu, max_steps)
    step = q["step"]
    dx, dy, dz = ray_directions_c(view, w, h, x0)
    ox, oy, oz = view[0, 3], view[1, 3], view[2, 3]
    tnear, tfar = ray_box_range_c((ox, oy, oz), dx, dy, dz, geom.dim, near,
                                  far)
    zcos = camera_zcos(view, dx, dy, dz) if of else None
    # pool values with y == 0 voxels carrying the unknown sentinel
    vals = torch.where(data_y == 0, torch.full_like(data_x, unk),
                       data_x).reshape(-1)
    sent = torch.full_like(dx, unk)
    if with_probes:  # reads of each nav entry and pool voxel
        nav_read = torch.zeros(nav.shape, dtype=torch.int32, device=dx.device)
        pool_read = torch.zeros(vals.shape, dtype=torch.int32,
                                device=dx.device)

    def read(cell, nv, lin, mask):
        """Count the nav entry at ``cell`` and, where it is a slot, the
        pool voxel ``lin`` of that slot as read by the rays of ``mask``."""
        if with_probes:
            nav_read.index_add_(0, cell, mask.to(torch.int32))
            # (the rays outside mask add 0 at a clamped index)
            voxel = (nv.clamp(min=0) * BLOCK_VOXELS + lin).clamp(
                0, pool_read.numel() - 1)
            pool_read.index_add_(0, voxel.long(),
                                 (mask & (nv >= 0)).to(torch.int32))

    def cell_of(vx, vy, vz):
        return (((vx >> 3) * b + (vy >> 3)) * b + (vz >> 3)).long()

    def pool(nv, lin):
        return vals[(nv.clamp(min=0) * BLOCK_VOXELS + lin).long()]

    def probe(t, mask):
        vx = ((ox + dx * t) * iv).to(torch.int32)
        vy = ((oy + dy * t) * iv).to(torch.int32)
        vz = ((oz + dz * t) * iv).to(torch.int32)
        inb = ((vx >= 0) & (vx < size) & (vy >= 0) & (vy < size)
               & (vz >= 0) & (vz < size))
        vx, vy, vz = (v.clamp(0, size - 1) for v in (vx, vy, vz))
        cell = cell_of(vx, vy, vz)
        nv = nav[cell]
        in_block = (nv >= 0) & inb
        lin = (vx & 7) + ((vy & 7) << 3) + ((vz & 7) << 6)
        if with_probes:  # a probe outside the map reads no voxel
            read(cell, torch.where(inb, nv, -1), lin, mask)
        e = torch.where(nv < 0, -nv - 1, 0)
        # OFusion: the nav payload's coarse free-space value
        coarse_known = (((e >> 3) & 1) == 1) if of \
            else torch.zeros_like(in_block)
        coarse_val = -(e >> 4).to(torch.float32) * (1.0 / 16.0)
        val = torch.where(in_block, pool(nv, lin),
                          torch.where(coarse_known, coarse_val, sent))
        known = ((val < 0.5 * unk) & in_block) | (coarse_known & inb)
        dist = torch.where(nv < 0, e & 7, 0).to(torch.float32)
        dist = torch.where(inb, dist, float(MAX_JUMP))
        return val, known, dist, in_block, cell

    def free_side(v):  # the start's side of the surface
        return v <= SURF_BOUNDARY if of else v > 0

    everyone = torch.ones_like(dx, dtype=torch.bool)
    if prime_t is None:
        # unprimed start (raycast.py:537-544): the value at tnear, the fill
        # where unknown, on the free side, or the ray misses
        f0, k0, _, _, cell0 = probe(tnear, everyone)
        go = (tnear < tfar) & free_side(torch.where(k0, f0, fill))
    else:
        # primed start: tight backoff when it lands in known free space
        t_tight = torch.where(prime_t > 0,
                              torch.maximum(tnear,
                                            prime_t - q["small_backoff"]),
                              tnear)
        ft, kt, _, _, cell0 = probe(t_tight, everyone)
        ok_tight = kt & free_side(ft)
        tnear = torch.where(ok_tight, t_tight,
                            torch.where(prime_t > 0,
                                        torch.maximum(
                                            tnear, prime_t - q["big_backoff"]),
                                        tnear))
        go = tnear < tfar
    status = torch.where(go, 0, 2).to(torch.int32)
    if with_probes:  # the kernel's one cached nav entry: the start's cell
        last_cell = cell0
        kinds = {k: torch.zeros_like(status)
                 for k in ("known", "crawl", "jump", "new_nav")}

    t = tnear + 0.0
    ss = torch.full_like(t, step if of else q["largestep"])
    f_t = torch.zeros_like(t) if of else torch.full_like(t, float("inf"))
    f_tt = torch.zeros_like(t)
    crawl = torch.zeros_like(t)
    probes = torch.zeros_like(status)
    for _ in range(q["max_probes"]):
        active = status == 0
        mx, known, dist, in_block, cell = probe(t, active)
        probes += active.to(torch.int32)
        hit = active & known & ((mx > SURF_BOUNDARY) if of else (mx < 0))
        f_tt = torch.where(active & known, mx, f_tt)
        adv = active & ~hit
        jump = torch.clamp((dist - 1).clamp(min=0.0) * q["bstep"]
                           + q["half_largestep"], min=q["largestep"])
        if of:
            f_t = torch.where(adv, f_tt, f_t)
            # sigma-band step inside allocated blocks (raycast.py:585-597)
            z = t * zcos
            sigma = torch.clamp(mu * z * z, q["two_step"], 0.05)
            known_step = torch.clamp(0.5 * sigma, step, q["of_cap"])
            new_ss = torch.where(in_block, known_step, jump)
        else:
            f_t = torch.where(active & known & ~hit, mx, f_t)
            # crawl escalation (raycast.py:568-580, 604-610)
            esc = (crawl - 16.0).clamp(min=0.0)
            floor_ = torch.clamp(
                step * (1.0 + torch.clamp(esc * 0.125, max=3.0)),
                max=q["floor_cap"])
            known_step = torch.maximum(f_tt * mu, floor_)
            new_ss = torch.where(known, known_step, jump)
            crawling = adv & known & (f_tt * mu <= floor_)
            crawl = torch.where(crawling, crawl + 1.0,
                                torch.where(adv, torch.zeros_like(crawl),
                                            crawl))
        if with_probes:
            at_floor = torch.zeros_like(known) if of else crawling
            in_known = in_block if of else known
            kinds["crawl"] += at_floor.to(torch.int32)
            kinds["known"] += (active & in_known & ~at_floor).to(torch.int32)
            kinds["jump"] += (active & ~in_known).to(torch.int32)
            moved = active & (cell != last_cell)
            kinds["new_nav"] += moved.to(torch.int32)
            last_cell = torch.where(active, cell, last_cell)
        ss = torch.where(adv, new_ss, ss)
        t = torch.where(adv, t + ss, t)
        status = torch.where(hit, 1, status)
        status = torch.where(adv & (t >= tfar), 2, status)

    overflow = torch.sum((status == 0).to(torch.int32), dtype=torch.int32)
    hit = status == 1
    # linear zero-crossing estimate from the sample bracket
    if of:
        f_hi, f_lo = f_tt, f_t
    else:
        f_hi = torch.where(torch.isinf(f_t), torch.ones_like(f_t), f_t)
        f_lo = f_tt
    denom = torch.where(f_hi == f_lo, torch.ones_like(f_hi), f_hi - f_lo)
    zero = torch.zeros_like(t)
    if of:
        t1 = t - ss * (f_hi - SURF_BOUNDARY) / denom
    else:
        t1 = t + ss * f_lo / denom
    t1 = torch.where(hit, t1, zero)
    t_cross = torch.where(hit, t, zero)
    ss = torch.where(hit, ss, zero)

    # trilinear value + cell gradient at t1 (raycast.py:_interp_grad)
    px, py, pz = (ox + dx * t1) * iv, (oy + dy * t1) * iv, (oz + dz * t1) * iv
    bx, by, bz = torch.floor(px), torch.floor(py), torch.floor(pz)
    fx, fy, fz = px - bx, py - by, pz - bz
    ix = bx.to(torch.int32).clamp(0, size - 1)
    iy0 = by.to(torch.int32).clamp(0, size - 1)
    iz0 = bz.to(torch.int32).clamp(0, size - 1)
    iy1 = (iy0 + 1).clamp(max=size - 1)
    iz1 = (iz0 + 1).clamp(max=size - 1)

    def decode(v):
        return torch.where(v < 0.5 * unk, v, torch.full_like(v, fill))

    def pair(y, z):
        cx = ix >> 3
        cell = ((cx * b + (y >> 3)) * b + (z >> 3)).long()
        nv = nav[cell]
        lin = (ix & 7) + ((y & 7) << 3) + ((z & 7) << 6)
        cell2 = (((cx + 1).clamp(max=b - 1) * b + (y >> 3)) * b
                 + (z >> 3)).long()
        nv2 = nav[cell2]
        # the reads of the kernel's corner_pair, recorded for the hits
        inner = (ix & 7) < 7
        read(cell, nv, lin, hit)
        read(cell, nv, lin + 1, hit & inner)
        read(cell2, nv2, lin - 7, hit & ~inner & (cx + 1 < b) & (nv >= 0))
        v0 = torch.where(nv >= 0, pool(nv, lin), sent)
        v1_in = pool(nv, (lin + 1).clamp(max=BLOCK_VOXELS - 1))
        v1_next = torch.where((cx + 1 < b) & (nv2 >= 0),
                              pool(nv2, (lin - 7).clamp(min=0)), sent)
        v1 = torch.where(nv < 0, sent,
                         torch.where((ix & 7) < 7, v1_in, v1_next))
        return decode(v0), decode(v1)

    v000, v100 = pair(iy0, iz0)
    v010, v110 = pair(iy1, iz0)
    v001, v101 = pair(iy0, iz1)
    v011, v111 = pair(iy1, iz1)
    c00 = v000 * (1 - fx) + v100 * fx
    c10 = v010 * (1 - fx) + v110 * fx
    c01 = v001 * (1 - fx) + v101 * fx
    c11 = v011 * (1 - fx) + v111 * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    v1 = c0 * (1 - fz) + c1 * fz
    gx = (((v100 - v000) * (1 - fy) + (v110 - v010) * fy) * (1 - fz)
          + ((v101 - v001) * (1 - fy) + (v111 - v011) * fy) * fz)
    gy = (c10 - c00) * (1 - fz) + (c11 - c01) * fz
    gz = c1 - c0

    # Newton step along the ray, clamped inside the observed bracket (both
    # fields cross the surface at 0)
    deriv = (gx * dx + gy * dy + gz * dz) * iv
    safe = torch.abs(deriv) > 1e-6
    t_hit = t1 - torch.where(safe, v1 / torch.where(safe, deriv,
                                                    torch.ones_like(deriv)),
                             zero)
    t_hit = torch.minimum(torch.maximum(t_hit, t_cross - ss), t_cross)
    t_hit = torch.where(hit, t_hit, zero)

    vertex = torch.stack([torch.where(hit, ox + dx * t_hit, zero),
                          torch.where(hit, oy + dy * t_hit, zero),
                          torch.where(hit, oz + dz * t_hit, zero)], -1)
    gn = torch.sqrt(gx * gx + gy * gy + gz * gz)
    inv = 1.0 / torch.where(gn == 0, torch.ones_like(gn), gn)
    if field.invert_normals:
        inv = -inv
    ok = hit & (gn > 0)
    normal = torch.stack([torch.where(ok, gx * inv, torch.full_like(gx,
                                                                    INVALID)),
                          torch.where(ok, gy * inv, zero),
                          torch.where(ok, gz * inv, zero)], -1)
    rays = Rays(vertex.reshape(h, w, 3), normal.reshape(h, w, 3),
                ok.reshape(h, w), overflow)
    if not with_probes:
        return rays, None
    return rays, Probes(probes.reshape(h, w), nav_read > 0, pool_read > 0,
                        **{k: v.reshape(h, w) for k, v in kinds.items()})
