"""TSDF (KinectFusion-style signed distance) field.

Port of ``supereight_tpu/fields/tsdf.py``: the fusion functor sdf_update
(ref se_denseslam/src/kfusion/mapping_impl.hpp:35-65). Payload: x = signed
distance clamped to [-1, 1] (in units of mu), y = integer fusion weight
capped at MAX_WEIGHT.
"""

import torch

from benchmark.reference.frozen.constants import MAX_WEIGHT
from benchmark.reference.frozen.fields.base import FieldSpec

TSDF = FieldSpec(
    name="tsdf",
    init=(1.0, 0.0),
    empty=(1.0, -1.0),
    multiscale_alloc=False,
    invert_normals=True,
)

# range-weighting anchor of the noise_weighted option: samples at z <= Z0
# carry full weight, beyond it the weight falls as (Z0/z)^2, floored at
# 1/16 (JAX fields/tsdf.py:24-27)
NOISE_WEIGHT_Z0 = 1.5


def update(old_x, old_y, pos_cam, depth_sample, mu: float, valid,
           noise_weighted: bool = False):
    """Fuse one depth observation into TSDF voxels (ref sdf_update, 35-65).

    pos_cam: (x, y, z) camera-frame component tensors of the voxels.
    Returns (new_x, new_y, wrote); non-writes pass old values through.
    ``noise_weighted`` weighs each sample clamp((Z0/z)^2, 1/16, 1) instead
    of 1 (JAX fields/tsdf.py:52-60). The CUDA integration kernel
    (csrc/fields.cuh) inlines the same arithmetic in the same order.
    """
    px, py_, pz = pos_cam
    # distance along the ray to the voxel's depth plane, scaled to ray length
    ray_scale = torch.sqrt(1.0 + (px / pz) ** 2 + (py_ / pz) ** 2)
    diff = (depth_sample - pz) * ray_scale
    write = valid & (depth_sample > 0) & (diff > -mu)
    sdf = torch.clamp(diff / mu, max=1.0)
    if noise_weighted:
        # a tensor numerator: ``float / tensor`` would take the
        # reciprocal and then multiply, rounding twice
        r = torch.full_like(pz, NOISE_WEIGHT_Z0) / torch.clamp(pz, min=1e-3)
        w = torch.clamp(r * r, 1.0 / 16.0, 1.0)
        new_x = torch.clamp((old_y * old_x + w * sdf) / (old_y + w), -1.0,
                            1.0)
        new_y = torch.clamp(old_y + w, max=float(MAX_WEIGHT))
    else:
        new_x = torch.clamp((old_y * old_x + sdf) / (old_y + 1.0), -1.0,
                            1.0)
        new_y = torch.clamp(old_y + 1.0, max=float(MAX_WEIGHT))
    return (torch.where(write, new_x, old_x),
            torch.where(write, new_y, old_y),
            write)
