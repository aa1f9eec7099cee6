"""K7 wrappers and twins: the tracking stage's input filters and pyramid.

Replaces ``supereight_tpu/pipeline.py:_preprocess_and_pyramid`` (26-58)
with ``ops/preprocess.py``'s ``bilateral_filter`` (28-52),
``median_filter3`` (55-76), ``half_sample_robust`` (79-98),
``depth2vertex`` (101-114) and ``vertex2normal`` (117-143) (ref
se_denseslam/src/preprocessing.cpp). The CUDA kernels are in
``csrc/preprocess.cu``: :func:`bilateral_filter` and
:func:`median_filter3` (one launch each, ``median2`` included), which
write the filtered level 0, and :func:`pyramid`, one launch that
half-samples every level in shared memory and writes each level's depth,
vertices, normals and valid mask. Their plain PyTorch versions
(:func:`bilateral_filter_plain`, :func:`median_filter3_plain`, and
:func:`pyramid_plain`, which composes the per-level twins
:func:`half_sample_plain` and :func:`vertex_normal_plain`) run for CPU
tensors and are the kernels' reference on the card.
"""

import numpy as np
import torch

from supereight_tpu_torch.constants import (DELTA, E_DELTA, INVALID,
                                            RADIUS)
from supereight_tpu_torch.core import se3
from supereight_tpu_torch.kernels import _lib

HALF_SAMPLE_E_D = E_DELTA * 3.0  # the robust mean's outlier distance
# the bilateral filter's spatial weights exp(-i^2 / (2 DELTA^2)) for i in
# -RADIUS..RADIUS, in f32 as JAX computes them (an int over a float, then
# exp), and its range denominator 2 E_DELTA^2, rounded to f32 on use
GAUSS = tuple(float(np.exp(np.float32(-(i * i)) / np.float32(2.0 * DELTA
                                                              * DELTA)))
              for i in range(-RADIUS, RADIUS + 1))
E_D_SQ_2 = 2.0 * E_DELTA * E_DELTA
# the kernel's spatial factors GAUSS[i] * GAUSS[j], each the f32 product
# of two f32 weights (the twin's g[i] * g[j]); GAUSS is symmetric to the
# bit, so SPATIAL[i][j] == SPATIAL[-1 - i][-1 - j]
SPATIAL = tuple(tuple(float(np.float32(a) * np.float32(b)) for b in GAUSS)
                for a in GAUSS)


def _filter_args(depth, name):
    dev = depth.device
    if depth.dim() != 2:
        raise ValueError(f"{name}: depth must be [H, W], got "
                         f"{tuple(depth.shape)}")
    if dev.type == "cuda":
        _lib.check(depth, "depth", torch.float32, tuple(depth.shape), dev)
    elif dev.type != "cpu":
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def bilateral_filter(depth):
    """The reference's 5x5 edge-preserving filter of the f32[H, W]
    ``depth`` (preprocessing.cpp:42-89): each pixel the mean of its window
    weighted by the spatial :data:`GAUSS` weights times
    exp(-(d' - d)^2 / (2 E_DELTA^2)), zero neighbours left out, edges
    replicated; a zero pixel stays 0. One launch (``bilateral``)."""
    dev = _filter_args(depth, "bilateral_filter")
    if dev.type == "cpu":
        return bilateral_filter_plain(depth)
    h, w = depth.shape
    out = torch.empty_like(depth)
    _lib.launch("bilateral", "se_bilateral", dev, depth, h, w,
                _lib.Spatial(SPATIAL), E_D_SQ_2, out)
    return out


def bilateral_taps_plain(depth):
    """The twin's 25 taps of the f32[H, W] ``depth``, offset (i, j) row
    offset outer: (cur, factor), cur the edge-padded image shifted by
    (i, j) and factor g[i] g[j] exp(-(cur - depth)^2 / (2 E_DELTA^2)),
    before zero taps are left out."""
    h, w = depth.shape
    r = RADIUS
    pad = torch.nn.functional.pad(depth[None, None], (r, r, r, r),
                                  mode="replicate")[0, 0]
    g = torch.tensor(GAUSS, dtype=torch.float32, device=depth.device)
    for i in range(2 * r + 1):
        for j in range(2 * r + 1):
            cur = pad[i:i + h, j:j + w]
            mod = (cur - depth) ** 2
            yield cur, g[i] * g[j] * torch.exp(-mod / E_D_SQ_2)


def bilateral_filter_plain(depth):
    """Plain PyTorch twin of :func:`bilateral_filter`: JAX's loop over the
    25 offsets of the edge-padded image, row offset outer."""
    t = torch.zeros_like(depth)
    s = torch.zeros_like(depth)
    for cur, factor in bilateral_taps_plain(depth):
        factor = torch.where(cur > 0, factor, torch.zeros_like(factor))
        t = t + factor * cur
        s = s + factor
    out = t / torch.where(s == 0, torch.ones_like(s), s)
    return torch.where(depth == 0, torch.zeros_like(out), out)


def median_filter3(depth, passes: int = 1):
    """``passes`` (1, or 2 for ``median2``) 3x3 median passes over the
    f32[H, W] ``depth``: each pixel the median of its nine taps, zero taps
    replaced by the pixel; a zero pixel stays 0; edges replicated (the
    second pass pads the first pass's output). One launch, counted as
    ``median`` or ``median2``."""
    if passes not in (1, 2):
        raise ValueError(f"median_filter3: passes must be 1 or 2, got "
                         f"{passes}")
    dev = _filter_args(depth, "median_filter3")
    if dev.type == "cpu":
        return median_filter3_plain(depth, passes)
    h, w = depth.shape
    out = torch.empty_like(depth)
    _lib.launch("median" if passes == 1 else "median2", "se_median", dev,
                depth, h, w, passes, out)
    return out


def median_filter3_plain(depth, passes: int = 1):
    """Plain PyTorch twin of :func:`median_filter3`: the nine shifted
    slices of the edge-padded image, sorted, element 4; once per pass."""
    for _ in range(passes):
        h, w = depth.shape
        pad = torch.nn.functional.pad(depth[None, None], (1, 1, 1, 1),
                                      mode="replicate")[0, 0]
        taps = [torch.where(pad[i:i + h, j:j + w] > 0, pad[i:i + h, j:j + w],
                            depth) for i in range(3) for j in range(3)]
        med = torch.sort(torch.stack(taps), dim=0).values[4]
        depth = torch.where(depth > 0, med, torch.zeros_like(med))
    return depth


def _level_shapes(h: int, w: int, levels: int):
    shapes = [(h, w)]
    for _ in range(1, levels):
        shapes.append(((shapes[-1][0] + 1) // 2, (shapes[-1][1] + 1) // 2))
    return shapes


def pyramid_buffers(h: int, w: int, levels: int, device="cuda"):
    """Empty output buffers of a ``levels``-level :func:`pyramid` of an
    [h, w] depth (its ``out``): the f32 coarser depths, vertices and
    normals of every level back to back, and the bool valid masks."""
    px = [a * b for a, b in _level_shapes(h, w, levels)]
    return (torch.empty(sum(px[1:]) + 6 * sum(px), dtype=torch.float32,
                        device=device),
            torch.empty(sum(px), dtype=torch.bool, device=device))


def pyramid_views(depth, out, levels: int):
    """The pyramid (depths, vertices, normals, valid masks), finest first,
    as views of the buffers ``out`` (:func:`pyramid_buffers`); level 0's
    depth is ``depth``."""
    floats, masks = out
    depths, verts, norms, valids = [depth], [], [], []
    f_off = m_off = 0
    for lvl, (lh, lw) in enumerate(_level_shapes(*depth.shape, levels)):
        n = lh * lw
        if lvl:
            depths.append(floats[f_off:f_off + n].view(lh, lw))
            f_off += n
        verts.append(floats[f_off:f_off + 3 * n].view(lh, lw, 3))
        norms.append(floats[f_off + 3 * n:f_off + 6 * n].view(lh, lw, 3))
        f_off += 6 * n
        valids.append(masks[m_off:m_off + n].view(lh, lw))
        m_off += n
    return tuple(depths), tuple(verts), tuple(norms), tuple(valids)


def pyramid(depth, k, levels: int, neg_y: bool, out=None):
    """The ``levels``-level pyramid of the f32[H, W] ``depth``, finest
    first: (depths, vertices, normals, valid masks), four tuples. Level 0's
    depth is ``depth``; each coarser level is the robust 2x downsample of
    the one before (f32[ceil(h/2), ceil(w/2)]). A level's camera-frame
    vertices (f32[h, w, 3]), normals (f32[h, w, 3], the INVALID sentinel
    where invalid) and valid mask (bool[h, w]) use the intrinsics ``k /
    2^level`` (``k`` the f32[4] (fx, fy, cx, cy) of level 0). With
    ``out`` (:func:`pyramid_buffers`) the levels are written there and
    returned as its views (:func:`pyramid_views`)."""
    dev = depth.device
    if dev.type == "cpu":
        pyr = pyramid_plain(depth, k, levels, neg_y)
        if out is None:
            return pyr
        views = pyramid_views(depth, out, levels)
        for own, new in zip(views, pyr):
            for a, b in zip(own, new):
                if a is not b:  # level 0's depth is ``depth`` in both
                    a.copy_(b)
        return views
    if dev.type != "cuda":
        raise ValueError(f"pyramid: unsupported device {dev}")
    if not 1 <= levels <= _lib.MAX_ICP_LEVELS:
        raise ValueError(f"pyramid: {levels} levels, the kernel takes 1 to "
                         f"{_lib.MAX_ICP_LEVELS}")
    h, w = depth.shape
    _lib.check(depth, "depth", torch.float32, (h, w), dev)
    _lib.check(k, "k", torch.float32, (4,), dev)
    if out is None:
        # every level's outputs as contiguous views of two allocations:
        # the floats (coarser depths, then vertices and normals) and the
        # masks
        out = pyramid_buffers(h, w, levels, dev)
    else:
        for buf, want in zip(out, pyramid_buffers(h, w, levels, "meta")):
            _lib.check(buf, "out", want.dtype, want.shape, dev)
    depths, verts, norms, valids = pyramid_views(depth, out, levels)
    lv = _lib.Levels(n_levels=levels)
    for lvl in range(levels):
        lv.depth[lvl] = depths[lvl].data_ptr() if lvl else None
        lv.vertex[lvl] = verts[lvl].data_ptr()
        lv.normal[lvl] = norms[lvl].data_ptr()
        lv.valid[lvl] = valids[lvl].data_ptr()
        lv.h[lvl], lv.w[lvl] = depths[lvl].shape
    _lib.launch("pyramid", "se_pyramid", dev, depth, k, HALF_SAMPLE_E_D,
                int(neg_y), lv)
    return depths, verts, norms, valids


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
