"""K7 wrapper and twins: the tracking stage's input pyramid.

Replaces ``supereight_tpu/pipeline.py:_preprocess_and_pyramid`` (26-58,
the ``filter_input=False`` path) with ``ops/preprocess.py``'s
``half_sample_robust`` (79-98), ``depth2vertex`` (101-114) and
``vertex2normal`` (117-143) (ref se_denseslam/src/preprocessing.cpp). The
CUDA kernel is ``csrc/preprocess.cu``: :func:`pyramid`, one launch that
half-samples every level in shared memory and writes each level's depth,
vertices, normals and valid mask. Its plain PyTorch version,
:func:`pyramid_plain`, composes the per-level twins
:func:`half_sample_plain` and :func:`vertex_normal_plain`; it runs for
CPU tensors and is the kernel's reference on the card.

The input filters (bilateral, median) are not ported yet.
"""

import torch

from supereight_tpu_torch.constants import E_DELTA, INVALID
from supereight_tpu_torch.core import se3
from supereight_tpu_torch.kernels import _lib

HALF_SAMPLE_E_D = E_DELTA * 3.0  # the robust mean's outlier distance


def pyramid(depth, k, levels: int, neg_y: bool):
    """The ``levels``-level pyramid of the f32[H, W] ``depth``, finest
    first: (depths, vertices, normals, valid masks), four tuples. Level 0's
    depth is ``depth``; each coarser level is the robust 2x downsample of
    the one before (f32[ceil(h/2), ceil(w/2)]). A level's camera-frame
    vertices (f32[h, w, 3]), normals (f32[h, w, 3], the INVALID sentinel
    where invalid) and valid mask (bool[h, w]) use the intrinsics ``k /
    2^level`` (``k`` the f32[4] (fx, fy, cx, cy) of level 0)."""
    dev = depth.device
    if dev.type == "cpu":
        return pyramid_plain(depth, k, levels, neg_y)
    if dev.type != "cuda":
        raise ValueError(f"pyramid: unsupported device {dev}")
    if not 1 <= levels <= _lib.MAX_ICP_LEVELS:
        raise ValueError(f"pyramid: {levels} levels, the kernel takes 1 to "
                         f"{_lib.MAX_ICP_LEVELS}")
    h, w = depth.shape
    _lib.check(depth, "depth", torch.float32, (h, w), dev)
    _lib.check(k, "k", torch.float32, (4,), dev)
    shapes = [(h, w)]
    for _ in range(1, levels):
        shapes.append(((shapes[-1][0] + 1) // 2, (shapes[-1][1] + 1) // 2))
    px = [a * b for a, b in shapes]
    # every level's outputs as contiguous views of two allocations: the
    # floats (coarser depths, then vertices and normals) and the masks
    floats = torch.empty(sum(px[1:]) + 6 * sum(px), dtype=torch.float32,
                         device=dev)
    masks = torch.empty(sum(px), dtype=torch.bool, device=dev)
    lv = _lib.Levels(n_levels=levels)
    depths, verts, norms, valids = [depth], [], [], []
    f_off = m_off = 0
    for lvl, ((lh, lw), n) in enumerate(zip(shapes, px)):
        if lvl:
            depths.append(floats[f_off:f_off + n].view(lh, lw))
            f_off += n
        verts.append(floats[f_off:f_off + 3 * n].view(lh, lw, 3))
        norms.append(floats[f_off + 3 * n:f_off + 6 * n].view(lh, lw, 3))
        f_off += 6 * n
        valids.append(masks[m_off:m_off + n].view(lh, lw))
        m_off += n
        lv.depth[lvl] = depths[lvl].data_ptr() if lvl else None
        lv.vertex[lvl] = verts[lvl].data_ptr()
        lv.normal[lvl] = norms[lvl].data_ptr()
        lv.valid[lvl] = valids[lvl].data_ptr()
        lv.h[lvl], lv.w[lvl] = lh, lw
    _lib.launch("pyramid", "se_pyramid", dev, depth, k, HALF_SAMPLE_E_D,
                int(neg_y), lv)
    return tuple(depths), tuple(verts), tuple(norms), tuple(valids)


def pyramid_plain(depth, k, levels: int, neg_y: bool):
    """Plain PyTorch twin of :func:`pyramid`: :func:`half_sample_plain`
    per coarser level, then :func:`vertex_normal_plain` per level."""
    depths = [depth]
    for _ in range(1, levels):
        depths.append(half_sample_plain(depths[-1], HALF_SAMPLE_E_D))
    verts, norms, valids = zip(*(vertex_normal_plain(d, k, lvl, neg_y)
                                 for lvl, d in enumerate(depths)))
    return tuple(depths), verts, norms, valids


def half_sample_plain(depth, e_d: float):
    """Robust 2x downsample of the f32[H, W] ``depth`` (f32[ceil(H/2),
    ceil(W/2)], preprocessing.cpp:190-226): the 2x2 window at offsets {0,
    1}; samples further than e_d from the center are excluded from the
    average."""
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
    """Camera-frame vertices, normals and valid mask of pyramid level
    ``level``'s depth with the intrinsics ``k / 2^level``: depth2vertex,
    then vertex2normal."""
    v = depth2vertex(depth, se3.inverse_camera_matrix(k / (1 << level)))
    n, valid = vertex2normal(v, neg_y)
    return v, n, valid
