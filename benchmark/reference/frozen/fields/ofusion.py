"""Occupancy (OFusion) field: Bayesian log-odds fusion.

Port of ``supereight_tpu/fields/ofusion.py`` (21-80): the bspline sensor
model and the update functor bfusion_update (ref
se_denseslam/src/bfusion/mapping_impl.hpp:94-191). Payload: x = log-odds
occupancy clamped to +/-1000, y = time of the last update. The closed-form
bspline is evaluated directly, as in the JAX package (not the reference's
quantized lookup table). The CUDA integration kernel
(csrc/integrate.cu) inlines the same arithmetic in the same order.
"""

import torch

from benchmark.reference.frozen.constants import (BOTTOM_CLAMP, CAPITAL_T,
                                            TOP_CLAMP)
from benchmark.reference.frozen.fields.base import FieldSpec

OFUSION = FieldSpec(
    name="ofusion",
    init=(0.0, 0.0),
    empty=(0.0, 0.0),
    multiscale_alloc=True,
    invert_normals=False,
)


def bspline(t):
    """Integral of the B-spline sensor kernel (ref mapping_impl.hpp:94-106)."""
    a = 3.0 + t
    b = 3.0 - t
    v1 = a * a * a / 48.0
    v2 = 0.5 + (t * a * b) / 24.0
    v3 = 1.0 - b * b * b / 48.0
    zero = torch.zeros_like(t)
    out = torch.where((t >= -3.0) & (t <= -1.0), v1, zero)
    out = torch.where((t > -1.0) & (t <= 1.0), v2, out)
    out = torch.where((t > 1.0) & (t <= 3.0), v3, out)
    return torch.where(t > 3.0, torch.ones_like(t), out)


def H(val):
    """Piecewise occupancy probability along the ray (ref H, 108-112)."""
    return bspline(val) - 0.5 * bspline(val - 3.0)


def update_logs(prior, sample):
    """Accumulate log2-odds (ref updateLogs, 145-148)."""
    return prior + torch.log2(sample / (1.0 - sample))


def apply_window(occupancy, delta_t, tau: float = CAPITAL_T):
    """Temporal decay of stale occupancy (ref applyWindow, 150-155)."""
    fraction = 1.0 / (1.0 + delta_t / tau)
    return occupancy * torch.clamp(fraction, min=0.5)


def update(old_x, old_y, pos_cam, depth_sample, noise_factor: float,
           timestamp, voxel_size: float, valid):
    """Fuse one observation into occupancy voxels (ref bfusion_update,
    157-191).

    ``noise_factor`` is the pipeline's mu; ``depth_sample`` the nearest
    depth; ``pos_cam`` an (x, y, z) tuple of camera-frame components;
    ``timestamp`` an f32 scalar (tensor or float). Returns (new_x, new_y,
    wrote); non-writes pass the old values through.
    """
    px, py_, pz = pos_cam
    ax, ay = px / pz, py_ / pz
    ray_scale = torch.sqrt(1.0 + ax * ax + ay * ay)
    diff = (pz - depth_sample) * ray_scale
    sigma = torch.clamp(noise_factor * pz * pz, 2.0 * voxel_size, 0.05)
    sample = H(diff / sigma)
    write = valid & (depth_sample > 0) & (sample != 0.5)
    sample = torch.clamp(sample, 0.03, 0.97)
    ts = torch.as_tensor(timestamp, dtype=torch.float32, device=old_y.device)
    decayed = apply_window(old_x, ts - old_y)
    new_x = torch.clamp(update_logs(decayed, sample), BOTTOM_CLAMP, TOP_CLAMP)
    return (torch.where(write, new_x, old_x),
            torch.where(write, ts.expand_as(old_y), old_y),
            write)
