"""Depth input conversion: ``mm2meters``.

Port of ``supereight_tpu/ops/preprocess.py:mm2meters`` (16-25; ref
mm2metersKernel, preprocessing.cpp:161-188): plain strided point sampling
of a u16 millimetre frame, then f32 metres. The division is one
correctly rounded f32 divide by 1000, as JAX's: the divisor is a tensor
on the frame's device, because torch divides a CUDA tensor by a Python
or CPU scalar as a product with its reciprocal, two roundings that move
some values by an ulp. The rest of the depth pipeline is kernel K7
(``kernels/preprocess.py``).
"""

import numpy as np
import torch


def sample_mm(depth_mm, out_hw):
    """The u16 millimetres [H, W] (numpy or a tensor) sampled every ``W //
    w`` pixels in both directions to [h, w] = ``out_hw``, as exact f32
    millimetres where the frame lies (every u16 value is exact in f32)."""
    h, w = out_hw
    ratio = depth_mm.shape[1] // w
    if depth_mm.shape[0] // h != ratio:
        raise ValueError(f"mm2meters: {tuple(depth_mm.shape)} does not "
                         f"sample to {h}x{w} at one ratio")
    sampled = depth_mm[::ratio, ::ratio]
    if isinstance(sampled, torch.Tensor):
        return sampled.to(torch.int32).to(torch.float32)
    return torch.from_numpy(np.ascontiguousarray(sampled, np.float32))


def meters(mm, out=None):
    """f32 millimetres -> metres, the one correctly rounded f32 divide by
    1000 (into ``out`` if given)."""
    return torch.div(mm, torch.full((), 1000.0, dtype=torch.float32,
                                    device=mm.device), out=out)


def mm2meters(depth_mm, out_hw, device="cuda"):
    """u16 millimetres [H, W] (numpy or a tensor) -> f32 metres [h, w]
    on ``device`` (the card unless the caller asks for another), sampled
    every ``W // w`` pixels in both directions. Equals numpy's
    ``d.astype(np.float32) / np.float32(1000)`` for every u16 value."""
    return meters(sample_mm(depth_mm, out_hw).to(device))
