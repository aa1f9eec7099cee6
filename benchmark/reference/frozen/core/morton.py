"""3D Morton (Z-order) codes over block-grid coordinates, on torch tensors.

Port of ``supereight_tpu/core/morton.py`` (semantics: the reference's
se_core/include/se/utils/morton_utils.hpp:37-72): 10 bits per axis, bit k
of x at bit 3k, y at 3k + 1, z at 3k + 2, so codes sort as the
reference's.

JAX computes in ``uint32``. torch cannot shift a ``uint32`` tensor on
every backend, so the port computes in ``int64``, masking to 32 bits after
each shift: every code the port returns is an ``int64`` tensor whose
values equal JAX's ``uint32`` codes. Decoded coordinates are ``int32``.
Tensors keep their device. Other inputs (numpy arrays, Python ints) go to
the device of a tensor among the arguments, else to ``device``: the card
unless the caller asks for the CPU.
"""

import numpy as np
import torch

_U32 = 0xFFFFFFFF


def _device(*xs, device):
    """The device of the first tensor among ``xs``, else ``device``."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device(device)


def _i64(x, device):
    """``x`` (tensor, numpy array or Python int) as an int64 tensor, on
    its own device if it is a tensor, else on ``device``; the low 32 bits
    of a negative value are its uint32 bits, as in JAX's cast."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)
    return torch.from_numpy(np.asarray(x).astype(np.int64)).to(device)


def expand_bits(x, device="cuda"):
    """Spread the low 10 bits of each lane of ``x`` to every third bit
    (ref ``expand``, morton_utils.hpp:37-45)."""
    x = _i64(x, device) & 0x3FF
    x = (x | ((x << 16) & _U32)) & 0x030000FF
    x = (x | ((x << 8) & _U32)) & 0x0300F00F
    x = (x | ((x << 4) & _U32)) & 0x030C30C3
    x = (x | ((x << 2) & _U32)) & 0x09249249
    return x


def compact_bits(x, device="cuda"):
    """Inverse of :func:`expand_bits` (ref ``compact``,
    morton_utils.hpp:47-55)."""
    x = (_i64(x, device) & _U32) & 0x09249249
    x = (x | (x >> 2)) & 0x030C30C3
    x = (x | (x >> 4)) & 0x0300F00F
    x = (x | (x >> 8)) & 0x030000FF
    x = (x | (x >> 16)) & 0x000003FF
    return x


def encode(x, y, z, device="cuda"):
    """Morton-encode integer coordinates (each < 1024): int64 codes."""
    dev = _device(x, y, z, device=device)
    return (expand_bits(x, dev) | ((expand_bits(y, dev) << 1) & _U32)
            | ((expand_bits(z, dev) << 2) & _U32))


def encode_v(coords, device="cuda"):
    """Morton-encode integer coordinates of shape [..., 3]."""
    c = _i64(coords, device)
    return encode(c[..., 0], c[..., 1], c[..., 2])


def decode(code, device="cuda"):
    """Decode Morton codes into (x, y, z) int32 tensors."""
    code = _i64(code, device) & _U32
    return (compact_bits(code).to(torch.int32),
            compact_bits(code >> 1).to(torch.int32),
            compact_bits(code >> 2).to(torch.int32))


def decode_v(code, device="cuda"):
    """Decode Morton codes into an int32 tensor of shape [..., 3]."""
    return torch.stack(decode(code, device), dim=-1)
