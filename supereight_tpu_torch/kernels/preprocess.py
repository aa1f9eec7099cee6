"""K7 wrappers and twins: the tracking stage's input pyramid.

Replaces ``supereight_tpu/pipeline.py:_preprocess_and_pyramid`` (26-58,
the ``filter_input=False`` path) with ``ops/preprocess.py``'s
``half_sample_robust`` (79-98), ``depth2vertex`` (101-114) and
``vertex2normal`` (117-143) (ref se_denseslam/src/preprocessing.cpp). The
CUDA kernels are ``csrc/preprocess.cu``: :func:`half_sample`, one launch
per coarser level, and :func:`vertex_normal`, one launch per level, which
back-projects a level's depth and takes its central-difference normals in
one pass. Their plain PyTorch versions (``*_plain``) run for CPU tensors
and are the kernels' reference on the card.

The input filters (bilateral, median) are not ported yet.
"""

import torch

from supereight_tpu_torch.constants import INVALID
from supereight_tpu_torch.core import se3
from supereight_tpu_torch.kernels import _lib


def half_sample(depth, e_d: float):
    """Robust 2x downsample of the f32[H, W] ``depth``: f32[ceil(H/2),
    ceil(W/2)] (preprocessing.cpp:190-226)."""
    dev = depth.device
    if dev.type == "cpu":
        return half_sample_plain(depth, e_d)
    if dev.type != "cuda":
        raise ValueError(f"half_sample: unsupported device {dev}")
    h, w = depth.shape
    _lib.check(depth, "depth", torch.float32, (h, w), dev)
    out = torch.empty(((h + 1) // 2, (w + 1) // 2), dtype=torch.float32,
                      device=dev)
    _lib.launch("half_sample", "se_half_sample", dev, depth, h, w,
                float(e_d), out)
    return out


def vertex_normal(depth, k, level: int, neg_y: bool):
    """Camera-frame vertices (f32[H, W, 3]), normals (f32[H, W, 3], the
    INVALID sentinel where invalid) and the valid mask (bool[H, W]) of
    pyramid level ``level``'s depth, with the intrinsics ``k / 2^level``
    (``k`` the f32[4] (fx, fy, cx, cy) of level 0)."""
    dev = depth.device
    if dev.type == "cpu":
        return vertex_normal_plain(depth, k, level, neg_y)
    if dev.type != "cuda":
        raise ValueError(f"vertex_normal: unsupported device {dev}")
    h, w = depth.shape
    _lib.check(depth, "depth", torch.float32, (h, w), dev)
    _lib.check(k, "k", torch.float32, (4,), dev)
    vert = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    norm = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    valid = torch.empty((h, w), dtype=torch.bool, device=dev)
    _lib.launch("vertex_normal", "se_vertex_normal", dev, depth, h, w, k,
                int(level), int(neg_y), vert, norm, valid)
    return vert, norm, valid


def half_sample_plain(depth, e_d: float):
    """Plain PyTorch twin of :func:`half_sample`: the 2x2 window at
    offsets {0, 1}; samples further than e_d from the center are excluded
    from the average."""
    h, w = depth.shape
    dev = depth.device
    center = depth[0::2, 0::2]
    t = torch.zeros_like(center)
    s = torch.zeros_like(center)
    rows = torch.arange(0, h, 2, device=dev)
    cols = torch.arange(0, w, 2, device=dev)
    for di in (0, 1):
        r = depth[(rows + di).clamp(max=h - 1)]
        for dj in (0, 1):
            cur = r[:, (cols + dj).clamp(max=w - 1)]
            take = torch.abs(cur - center) < e_d
            t = t + torch.where(take, cur, torch.zeros_like(cur))
            s = s + take.to(depth.dtype)
    return t / torch.where(s == 0, torch.ones_like(s), s)


def depth2vertex(depth, inv_k):
    """Back-project depth to camera-frame vertices (preprocessing.cpp:91-111).

    Returns [H, W, 3]; zero-depth pixels map to (0,0,0).
    """
    h, w = depth.shape
    ys = torch.arange(h, dtype=torch.float32, device=depth.device)
    xs = torch.arange(w, dtype=torch.float32, device=depth.device)
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    rays = torch.stack([inv_k[i, 0] * px + inv_k[i, 1] * py + inv_k[i, 2]
                        for i in range(3)], -1)
    v = depth[..., None] * rays
    return torch.where(depth[..., None] > 0, v, torch.zeros_like(v))


def vertex2normal(vertex, neg_y: bool):
    """Central-difference normals (preprocessing.cpp:113-159).

    Invalid pixels get normal.x = INVALID like the reference sentinel.
    Returns ([H, W, 3] normals, [H, W] valid mask).
    """
    left = torch.cat([vertex[:, :1], vertex[:, :-1]], dim=1)
    right = torch.cat([vertex[:, 1:], vertex[:, -1:]], dim=1)
    row_prev = torch.cat([vertex[:1], vertex[:-1]], dim=0)
    row_next = torch.cat([vertex[1:], vertex[-1:]], dim=0)
    if neg_y:
        up, down = row_prev, row_next
    else:
        up, down = row_next, row_prev
    a = (right - left).unbind(-1)
    b = (up - down).unbind(-1)
    # the cross product and its norm one rounded operation at a time, as
    # the kernel computes them: a library cross product may contract
    # a * b - c * d into an FMA, which moves a cancelling component
    n = torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                     a[0] * b[1] - a[1] * b[0]], -1)
    norm = torch.sqrt(n[..., 0:1] * n[..., 0:1] + n[..., 1:2] * n[..., 1:2]
                      + n[..., 2:3] * n[..., 2:3])
    n = n / torch.where(norm == 0, torch.ones_like(norm), norm)
    valid = ((vertex[..., 2] != 0)
             & (left[..., 2] != 0) & (right[..., 2] != 0)
             & (up[..., 2] != 0) & (down[..., 2] != 0))
    invalid = torch.zeros_like(n)
    invalid[..., 0].fill_(INVALID)
    return torch.where(valid[..., None], n, invalid), valid


def vertex_normal_plain(depth, k, level: int, neg_y: bool):
    """Plain PyTorch twin of :func:`vertex_normal`: depth2vertex, then
    vertex2normal."""
    v = depth2vertex(depth, se3.inverse_camera_matrix(k / (1 << level)))
    n, valid = vertex2normal(v, neg_y)
    return v, n, valid
