"""K10 ``render``: the visualization renders' wrapper and twins.

Replaces JAX's three jitted renders, ``supereight_tpu/ops/rendering.py``
``render_depth`` (:39), ``render_track`` (:64) and the shading of
``render_volume`` (:77) (ref renderDepthKernel / renderTrackKernel /
renderVolumeKernel, se_denseslam/src/rendering.cpp:111-283, and gs2rgb,
commons.h:105-164). The CUDA kernel is ``csrc/render.cu``: one thread a
pixel, one 32-bit RGBA store each, a launch a render counted as
``render_depth``, ``render_track`` or ``render_volume``; or, for a
rendered frame, one launch of :func:`render_views` (counted as
``render_views``) that writes the three images into the viewer's 2x2
composite (``viewer.composite_views``' layout, its RGB quadrant zero).
The plain PyTorch twins :func:`render_depth_plain`,
:func:`render_track_plain`, :func:`render_volume_plain` (with
:func:`gs2rgb`) and :func:`render_views_plain` are elementwise torch ops
in JAX's order of operations; they run for CPU tensors, where their u8
images equal JAX's, and are the kernel's reference on the card, which it
equals bit for bit.

JAX's jitted ``render_depth`` takes its default planes as constants, and
XLA turns the division by the constant ``far - near`` into a product with
its f32 reciprocal: the port takes that product (:func:`depth_scale`; a
true division differs on 32 of 2,000,000 depths in [0.4, 4] m). A NaN
depth has no defined colour (the reference's float-to-u8 casts of NaN
differ between devices); the class's depths are u16 millimetres.
"""

import numpy as np
import torch

from benchmark.reference.frozen import constants as C

AMBIENT = 0.1

_TRACK_COLORS = (
    (255, 128, 128),   # default / grey case fallthrough
    (128, 128, 128),   # 1: tracked ok
    (0, 0, 0),         # -1: no input
    (255, 0, 0),       # -2: not in image
    (0, 255, 0),       # -3: no correspondence
    (0, 0, 255),       # -4: too far
    (255, 255, 0),     # -5: wrong normal
)
TRACK_CODES = (1, -1, -2, -3, -4, -5)  # rows 1-6 of _TRACK_COLORS


def depth_scale(near, far):
    """XLA's folded reciprocal: f32(1) / f32(far - near), the difference
    taken in Python's double."""
    return np.float32(1.0) / np.float32(far - near)


def gs2rgb(d):
    """Scalar [0,1] -> rainbow rgb [..., 3] (ref gs2rgb,
    commons.h:105-164): R -> Y -> G -> C -> B -> M."""
    v = torch.clamp(d, 0.0, 1.0) * 6.0
    fl = torch.floor(v)
    sector = fl.to(torch.int32) % 6
    frac = v - fl
    one = torch.ones_like(frac)
    zero = torch.zeros_like(frac)
    up, down = frac, 1.0 - frac
    rs = torch.stack([one, down, zero, zero, up, one])
    gs = torch.stack([up, one, one, down, zero, zero])
    bs = torch.stack([zero, zero, up, one, one, down])
    idx = sector.long()[None]
    r = torch.gather(rs, 0, idx)[0]
    g = torch.gather(gs, 0, idx)[0]
    b = torch.gather(bs, 0, idx)[0]
    return torch.stack([r, g, b], dim=-1)


def _alpha(shape, dev):
    return torch.zeros(shape + (1,), dtype=torch.uint8, device=dev)


def render_depth_plain(depth, near=C.NEAR_PLANE, far=C.FAR_PLANE):
    """Plain PyTorch twin of :func:`render_depth`."""
    dev = depth.device
    near_t = torch.full((), near, dtype=torch.float32, device=dev)
    far_t = torch.full((), far, dtype=torch.float32, device=dev)
    inv = torch.full((), depth_scale(near, far), dtype=torch.float32,
                     device=dev)
    d = (depth - near_t) * inv
    rgb = (gs2rgb(d) * 255.0).to(torch.uint8)
    white = torch.full_like(rgb, 255)
    black = torch.zeros_like(rgb)
    rgb = torch.where((depth < near_t)[..., None], white, rgb)
    rgb = torch.where((depth > far_t)[..., None], black, rgb)
    return torch.cat([rgb, _alpha(tuple(depth.shape), dev)], dim=-1)


def render_track_plain(result):
    """Plain PyTorch twin of :func:`render_track`."""
    dev = result.device
    idx = torch.zeros(result.shape, dtype=torch.long, device=dev)
    for i, code in enumerate(TRACK_CODES):
        idx = torch.where(result == code, i + 1, idx)
    colors = torch.tensor(_TRACK_COLORS, dtype=torch.uint8, device=dev)
    return torch.cat([colors[idx], _alpha(tuple(result.shape), dev)],
                     dim=-1)


def render_volume_plain(vertex, normal, valid, view_pose, light=None):
    """Plain PyTorch twin of :func:`render_volume`."""
    if light is None:
        light = view_pose[:3, 3]
    diff = vertex - light
    dx, dy, dz = diff[..., 0], diff[..., 1], diff[..., 2]
    dn = torch.sqrt(dx * dx + dy * dy + dz * dz)[..., None]
    diff = diff / torch.where(dn == 0, torch.ones_like(dn), dn)
    prod = normal * diff
    shade = torch.clamp(prod[..., 0] + prod[..., 1] + prod[..., 2], min=0.0)
    col = torch.clamp(shade[..., None] + AMBIENT, 0.0, 1.0) * 255.0
    col = torch.where(valid[..., None], col, torch.zeros_like(col)) \
        .to(torch.uint8).expand(*shade.shape, 3)
    return torch.cat([col, _alpha(tuple(shade.shape), col.device)], dim=-1)


def render_views_plain(depth, result, vertex, normal, valid, view_pose,
                       light=None, near=C.NEAR_PLANE, far=C.FAR_PLANE):
    """Plain PyTorch twin of :func:`render_views`: the three twins'
    images placed into a zero u8[2H, 2W, 4]."""
    h, w = depth.shape
    out = torch.zeros((2 * h, 2 * w, 4), dtype=torch.uint8,
                      device=depth.device)
    out[:h, w:] = render_depth_plain(depth, near, far)
    out[h:, :w] = render_track_plain(result)
    out[h:, w:] = render_volume_plain(vertex, normal, valid, view_pose, light)
    return out


