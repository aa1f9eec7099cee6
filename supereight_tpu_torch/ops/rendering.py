"""Visualization renders (RGBA u8 images).

Port of ``supereight_tpu/ops/rendering.py`` (ref renderDepthKernel /
renderTrackKernel / renderVolumeKernel, se_denseslam/src/rendering.cpp:
111-283, and the gray-to-rainbow map gs2rgb, commons.h:105-164). The
renders are elementwise torch ops in JAX's order of operations, so the
u8 images equal JAX's, and the f32 -> u8 casts truncate as JAX's. JAX's
jitted ``render_depth`` takes its default planes as constants, and XLA
turns the division by the constant ``far - near`` into a product with
its f32 reciprocal: the port takes that product (a true division differs
on 32 of 2,000,000 depths in [0.4, 4] m).
A volume render from a view that is not the raycast pose marches the map
afresh through K1's unprimed launch (``ops/raycast``), to twice the far
plane; its view is the pose prologue's (``kernels/frame.frame_mats``).
"""

import numpy as np
import torch

from supereight_tpu_torch import constants as C
from supereight_tpu_torch.kernels.frame import frame_mats
from supereight_tpu_torch.ops import raycast as raycast_mod

AMBIENT = 0.1


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


def render_depth(depth, near=C.NEAR_PLANE, far=C.FAR_PLANE):
    """Depth image -> RGBA (ref renderDepthKernel, rendering.cpp:111-152):
    white below near, black above far, rainbow in between."""
    dev = depth.device
    near_t = torch.full((), near, dtype=torch.float32, device=dev)
    far_t = torch.full((), far, dtype=torch.float32, device=dev)
    # XLA's product with the f32 reciprocal of the constant far - near
    inv = torch.full((), np.float32(1.0) / np.float32(far - near),
                     dtype=torch.float32, device=dev)
    d = (depth - near_t) * inv
    rgb = (gs2rgb(d) * 255.0).to(torch.uint8)
    white = torch.full_like(rgb, 255)
    black = torch.zeros_like(rgb)
    rgb = torch.where((depth < near_t)[..., None], white, rgb)
    rgb = torch.where((depth > far_t)[..., None], black, rgb)
    return torch.cat([rgb, _alpha(tuple(depth.shape), dev)], dim=-1)


_TRACK_COLORS = (
    (255, 128, 128),   # default / grey case fallthrough
    (128, 128, 128),   # 1: tracked ok
    (0, 0, 0),         # -1: no input
    (255, 0, 0),       # -2: not in image
    (0, 255, 0),       # -3: no correspondence
    (0, 0, 255),       # -4: too far
    (255, 255, 0),     # -5: wrong normal
)


def render_track(result):
    """Tracking-status colours (ref renderTrackKernel,
    rendering.cpp:154-212, legend at DenseSLAMSystem.h:249-258)."""
    dev = result.device
    idx = torch.zeros(result.shape, dtype=torch.long, device=dev)
    for i, code in enumerate((1, -1, -2, -3, -4, -5)):
        idx = torch.where(result == code, i + 1, idx)
    colors = torch.tensor(_TRACK_COLORS, dtype=torch.uint8, device=dev)
    return torch.cat([colors[idx], _alpha(tuple(result.shape), dev)],
                     dim=-1)


def render_volume(geom, state, field, view_pose, k, mu, frame_size,
                  light=None, vertex=None, normal=None, valid=None,
                  reuse_maps=False):
    """Diffuse-shaded surface render (ref renderVolumeKernel,
    rendering.cpp:214-283). When the view pose is the raycast pose the
    reference reuses the tracking maps: pass ``reuse_maps=True`` with
    them; otherwise the map is raycast afresh from ``view_pose`` (K1's
    unprimed launch over every block, to twice the far plane)."""
    if light is None:
        light = view_pose[:3, 3]
    if not reuse_maps:
        view = frame_mats(k, view_pose).kpose
        vertex, normal, valid = raycast_mod.raycast(
            geom, state, field, view, mu, frame_size,
            far=C.FAR_PLANE * 2.0)
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
