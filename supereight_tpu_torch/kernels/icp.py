"""K6 wrappers and twins: projective ICP.

Replaces ``supereight_tpu/ops/tracking.py:track`` (242-319) with
``track_residuals`` (56-118), ``reduce_tracking`` (125-153), the 6x6 solve
(168-212), ``update_pose`` (215-223) and ``check_pose`` (226-237). The
CUDA kernels are ``csrc/icp.cu``; its source note says what bounds them on
the H100.

* :func:`icp_track` — a frame's whole coarse-to-fine Gauss-Newton, 6x6
  solves, pose updates and ``check_pose`` in one launch of as many
  16-CTA thread-block clusters as the card holds at once (at most 8;
  :func:`track_clusters`), which add their sums through a scratch of
  their stream; the frame's path (``ops/tracking.track``).
* :func:`icp_reduce` (:func:`icp_reduce64`) — one level's residuals and
  32-float reduction (f64 sums over a column window), without the solve:
  one rank's share of the sharded frame's summed reduction
  (``ops/tracking.track`` with a process group), in one launch of one
  thread-block cluster.
* :func:`icp_reduce_step` — :func:`icp_update` folded into the launch of
  the next iteration's :func:`icp_reduce64`: a sharded Gauss-Newton
  iteration is one launch and one all-reduce.
* :func:`icp_update` — one Gauss-Newton iteration from the ranks' summed
  reduction: the solve, the update, the freeze of a converged level and,
  on the frame's last call, ``check_pose``.

:func:`icp_track_plain`, :func:`icp_reduce_plain` (:func:`icp_reduce64_plain`),
:func:`icp_reduce_step_plain` and :func:`icp_update_plain` are the plain
PyTorch versions, used for CPU tensors and as the kernels' reference on
the card.
"""

from typing import NamedTuple, Sequence

import torch

from supereight_tpu_torch.constants import (DIST_THRESHOLD, NORMAL_THRESHOLD,
                                            TRACK_BAD_NORMAL, TRACK_NO_INPUT,
                                            TRACK_NO_REF_NORMAL, TRACK_OK,
                                            TRACK_OUT_OF_FRAME,
                                            TRACK_THRESHOLD, TRACK_TOO_FAR)
from supereight_tpu_torch.core import se3
from supereight_tpu_torch.kernels import _lib

# upper-triangle index pairs of the 6x6 JtJ, row-major (makeJTJ layout)
_TRIU = [(r, c) for r in range(6) for c in range(r, 6)]


def icp_reduce(in_vertex, in_normal, in_valid, ref_vertex, ref_normal,
               ref_valid, pose, view, dist_threshold=DIST_THRESHOLD,
               normal_threshold=NORMAL_THRESHOLD):
    """Per-pixel ICP result codes and the reduced 32-vector.

    in_*: one pyramid level [h, w, (3)] (camera frame); ref_*: the last
    raycast [H, W, (3)] (world frame); pose: camera-to-world estimate
    [4, 4]; view: K @ raycast_pose^-1 [4, 4]. All on one device.
    Returns (result i32[h, w], reduction f32[32]).
    """
    result, red64 = icp_reduce64(in_vertex, in_normal, in_valid, ref_vertex,
                                 ref_normal, ref_valid, pose, view,
                                 dist_threshold, normal_threshold)
    return result, red64.to(torch.float32)


def icp_reduce64(in_vertex, in_normal, in_valid, ref_vertex, ref_normal,
                 ref_valid, pose, view, dist_threshold=DIST_THRESHOLD,
                 normal_threshold=NORMAL_THRESHOLD, x0=0, width=None,
                 with_result=True, out=None):
    """:func:`icp_reduce` with the 32 sums left in f64 over the level's
    columns [x0, x0 + width) (default: all of them): one rank's share of a
    reduction that the ranks sum before it is rounded once to f32
    (``ops/tracking.track`` with a process group). Returns (result
    i32[h, width], or None without ``with_result``, f64[32]); ``out`` is
    the f64[32] to write the sums into (the tensor the ranks all-reduce).
    """
    width = _window(in_vertex, x0, width)
    if in_vertex.device.type == "cpu":
        res, red = icp_reduce64_plain(in_vertex, in_normal, in_valid,
                                      ref_vertex, ref_normal, ref_valid,
                                      pose, view, dist_threshold,
                                      normal_threshold, x0, width)
        return (res if with_result else None), _into(out, red)
    return _reduce("icp_reduce", in_vertex, in_normal, in_valid, ref_vertex,
                   ref_normal, ref_valid, pose, view, dist_threshold,
                   normal_threshold, x0, width, with_result, out,
                   _lib.Step())


def icp_reduce_step(red64, pose, carry, first_of_level, next_first_of_level,
                    icp_threshold, in_vertex, in_normal, in_valid,
                    ref_vertex, ref_normal, ref_valid, view,
                    dist_threshold=DIST_THRESHOLD,
                    normal_threshold=NORMAL_THRESHOLD, x0=0, width=None,
                    out=None, carry_out: "Carry" = None):
    """One sharded Gauss-Newton iteration's update and the next one's
    reduction in one launch: :func:`icp_update` from the ranks' summed
    reduction ``red64`` of the previous iteration (``pose``, ``carry`` and
    ``first_of_level`` as it takes them, without ``check_pose``), then
    :func:`icp_reduce64` over the columns [x0, x0 + width) of the level
    at the stepped pose, without a result map. Where the stepped level
    has converged and the next iteration is not the first of its level
    (``next_first_of_level``), the pass is skipped and the sums are
    zeros: the next update ignores them. Returns (the stepped carry,
    f64[32]), written into ``carry_out`` and ``out`` where given (neither
    may overlap the inputs)."""
    dev = red64.device
    width = _window(in_vertex, x0, width)
    if dev.type == "cpu":
        new, red = icp_reduce_step_plain(
            red64, pose, carry, first_of_level, next_first_of_level,
            icp_threshold, in_vertex, in_normal, in_valid, ref_vertex,
            ref_normal, ref_valid, view, dist_threshold, normal_threshold,
            x0, width)
        if carry_out is not None:
            new = Carry(*(_into(o, t) for o, t in zip(carry_out, new)))
        return new, _into(out, red)
    if dev.type != "cuda":
        raise ValueError(f"icp_reduce_step: unsupported device {dev}")
    c = _lib.check
    c(red64, "red64", torch.float64, (32,), dev)
    c(pose, "pose", torch.float32, (4, 4), dev)
    red_in = done_in = None
    if carry is not None:
        red_in = c(carry.reduction, "reduction", torch.float32, (32,), dev)
        if not first_of_level:
            done_in = c(carry.done, "done", torch.bool, (), dev)
    if carry_out is None:
        carry_out = _empty_carry(dev)
    c(carry_out.pose, "carry_out.pose", torch.float32, (4, 4), dev)
    c(carry_out.reduction, "carry_out.reduction", torch.float32, (32,), dev)
    c(carry_out.done, "carry_out.done", torch.bool, (), dev)
    read = [red64, pose] + ([] if carry is None else [carry.reduction,
                                                      carry.done])
    if any(_overlap(a, b) for a in read for b in carry_out):
        raise ValueError("icp_reduce_step: carry_out overlaps an input")
    if out is not None and any(_overlap(out, b)
                               for b in read + list(carry_out)):
        raise ValueError("icp_reduce_step: out overlaps an input or "
                         "carry_out")
    step = _lib.Step(red64.data_ptr(), _ptr(red_in), _ptr(done_in),
                     carry_out.pose.data_ptr(),
                     carry_out.reduction.data_ptr(),
                     carry_out.done.data_ptr(), float(icp_threshold),
                     int(bool(next_first_of_level)))
    _, red = _reduce("icp_reduce_step", in_vertex, in_normal, in_valid,
                     ref_vertex, ref_normal, ref_valid, pose, view,
                     dist_threshold, normal_threshold, x0, width, False, out,
                     step)
    return carry_out, red


def _reduce(name, in_vertex, in_normal, in_valid, ref_vertex, ref_normal,
            ref_valid, pose, view, dist_threshold, normal_threshold, x0,
            width, with_result, out, step):
    """Launch csrc/icp.cu's icp_reduce (counted as ``name``) over the
    columns [x0, x0 + width) (a checked :func:`_window`) with ``step`` (a
    :class:`_lib.Step`)."""
    dev = in_vertex.device
    h, w = in_vertex.shape[:2]
    if dev.type != "cuda":
        raise ValueError(f"icp_reduce: unsupported device {dev}")
    rh, rw = ref_vertex.shape[:2]
    c = _lib.check
    c(in_vertex, "in_vertex", torch.float32, (h, w, 3), dev)
    c(in_normal, "in_normal", torch.float32, (h, w, 3), dev)
    c(in_valid, "in_valid", torch.bool, (h, w), dev)
    c(ref_vertex, "ref_vertex", torch.float32, (rh, rw, 3), dev)
    c(ref_normal, "ref_normal", torch.float32, (rh, rw, 3), dev)
    c(ref_valid, "ref_valid", torch.bool, (rh, rw), dev)
    c(pose, "pose", torch.float32, (4, 4), dev)
    c(view, "view", torch.float32, (4, 4), dev)
    if out is None:
        out = torch.empty(32, dtype=torch.float64, device=dev)
    c(out, "out", torch.float64, (32,), dev)
    result = torch.empty((h, width), dtype=torch.int32, device=dev) \
        if with_result else None
    _lib.launch(name, "se_icp_reduce", dev, in_vertex, in_normal, in_valid,
                h * width, width, w, x0, ref_vertex, ref_normal, ref_valid,
                rh, rw, pose, view, float(dist_threshold),
                float(normal_threshold), result, out, step)
    return result, out


def _window(in_vertex, x0, width):
    """The window's width (default: from x0 to the level's end), checked
    to lie inside the level."""
    w = in_vertex.shape[1]
    width = w - x0 if width is None else width
    if not (0 <= x0 and 0 < width and x0 + width <= w):
        raise ValueError(f"icp_reduce: columns [{x0}, {x0 + width}) are "
                         f"not inside a level {w} wide")
    return width


def _into(out, t):
    """``t``, copied into ``out`` where one is given."""
    return t if out is None else out.copy_(t)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _overlap(a, b):
    """Whether two tensors' bytes overlap."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and \
        b0 < a0 + a.numel() * a.element_size()


def _empty_carry(dev):
    return Carry(torch.empty((4, 4), dtype=torch.float32, device=dev),
                 torch.empty(32, dtype=torch.float32, device=dev),
                 torch.empty((), dtype=torch.bool, device=dev))


def track_residuals(in_vertex, in_normal, in_valid, ref_vertex, ref_normal,
                    ref_valid, t_track, view, dist_threshold=DIST_THRESHOLD,
                    normal_threshold=NORMAL_THRESHOLD):
    """Per-pixel point-to-plane residual + jacobian (trackKernel, ref
    tracking.cpp:226-302). Returns (result i32[h,w], error f32[h,w],
    6-tuple of f32[h,w] jacobian components), rejected pixels zeroed."""
    ref_h, ref_w = ref_vertex.shape[:2]
    ivx, ivy, ivz = in_vertex.unbind(-1)
    pvx, pvy, pvz = se3.transform_c(t_track, ivx, ivy, ivz)   # world frame
    ppx, ppy, ppz = se3.transform_c(view, pvx, pvy, pvz)
    safe_z = torch.where(ppz == 0, torch.ones_like(ppz), ppz)
    proj_px = ppx / safe_z + 0.5
    proj_py = ppy / safe_z + 0.5
    in_frame = ((proj_px >= 0) & (proj_px <= ref_w - 1)
                & (proj_py >= 0) & (proj_py <= ref_h - 1))
    rx = proj_px.to(torch.int32).clamp(0, ref_w - 1)
    ry = proj_py.to(torch.int32).clamp(0, ref_h - 1)
    flat = (ry * ref_w + rx).long()
    rv = ref_vertex.reshape(-1, 3)[flat]
    rn = ref_normal.reshape(-1, 3)[flat]
    ref_ok = ref_valid.reshape(-1)[flat]
    rvx, rvy, rvz = rv.unbind(-1)
    rnx, rny, rnz = rn.unbind(-1)

    dx_, dy_, dz_ = rvx - pvx, rvy - pvy, rvz - pvz
    pnx, pny, pnz = se3.rotate_c(t_track, *in_normal.unbind(-1))
    dist = torch.sqrt(dx_ * dx_ + dy_ * dy_ + dz_ * dz_)
    ndot = pnx * rnx + pny * rny + pnz * rnz

    # rejection cascade, in reference order (-1 .. -5; the last one wins)
    result = torch.full(in_vertex.shape[:2], TRACK_OK, dtype=torch.int32,
                        device=in_vertex.device)

    def code(cond, value):
        return torch.where(cond, torch.full_like(result, value), result)

    result = code(ndot < normal_threshold, TRACK_BAD_NORMAL)
    result = code(dist > dist_threshold, TRACK_TOO_FAR)
    result = code(~ref_ok, TRACK_NO_REF_NORMAL)
    result = code(~in_frame, TRACK_OUT_OF_FRAME)
    result = code(~in_valid, TRACK_NO_INPUT)

    error = rnx * dx_ + rny * dy_ + rnz * dz_
    # j_rot = projected_vertex x reference_normal
    jrx = pvy * rnz - pvz * rny
    jry = pvz * rnx - pvx * rnz
    jrz = pvx * rny - pvy * rnx
    ok = result == TRACK_OK
    zero = torch.zeros_like(error)
    jac = tuple(torch.where(ok, j, zero)
                for j in (rnx, rny, rnz, jrx, jry, jrz))
    return result, torch.where(ok, error, zero), jac


def reduce_tracking(result, error, jac):
    """Masked reduction to the reference's 32-float layout (reduceKernel):
    [0]=sum err^2, [1:7]=J^T e, [7:28]=upper-tri J^T J, [28]=inliers,
    [29]=#too-far, [30]=#bad-normal, [31]=#other-rejects.

    Each f32 per-pixel term is summed in f64 and rounded to f32 once, as
    both K6 kernels sum them; JAX sums in f32. Near convergence J^T e
    cancels to almost nothing, and two f32 sums in different orders then
    differ by more than the Gauss-Newton step they feed, so a kernel and
    this twin would part ways within a few iterations (ROADMAP.md,
    Queue 3)."""
    return reduce_tracking64(result, error, jac).to(torch.float32)


def reduce_tracking64(result, error, jac):
    """:func:`reduce_tracking`'s f64 sums, before the rounding."""
    z = (error,) + tuple(jac)
    terms = [z[0] * z[0]]
    terms += [z[0] * z[1 + i] for i in range(6)]
    terms += [z[1 + r] * z[1 + c] for r, c in _TRIU]
    terms += [result == TRACK_OK, result == TRACK_TOO_FAR,
              result == TRACK_BAD_NORMAL,
              (result < 1) & (result > TRACK_TOO_FAR)]
    return torch.stack([torch.sum(t, dtype=torch.float64) for t in terms])


def icp_reduce_plain(in_vertex, in_normal, in_valid, ref_vertex, ref_normal,
                     ref_valid, pose, view, dist_threshold=DIST_THRESHOLD,
                     normal_threshold=NORMAL_THRESHOLD):
    """Plain PyTorch twin of :func:`icp_reduce`."""
    res, red64 = icp_reduce64_plain(in_vertex, in_normal, in_valid,
                                    ref_vertex, ref_normal, ref_valid, pose,
                                    view, dist_threshold, normal_threshold)
    return res, red64.to(torch.float32)


def icp_reduce64_plain(in_vertex, in_normal, in_valid, ref_vertex,
                       ref_normal, ref_valid, pose, view,
                       dist_threshold=DIST_THRESHOLD,
                       normal_threshold=NORMAL_THRESHOLD, x0=0, width=None):
    """Plain PyTorch twin of :func:`icp_reduce64`: the columns [x0, x0 +
    width) of the level, JAX's column slice."""
    cols = slice(x0, None if width is None else x0 + width)
    res, err, jac = track_residuals(
        in_vertex[:, cols], in_normal[:, cols], in_valid[:, cols],
        ref_vertex, ref_normal, ref_valid, pose, view, dist_threshold,
        normal_threshold)
    return res, reduce_tracking64(res, err, jac)


def make_jtj(v21):
    """21-vector -> symmetric 6x6 (makeJTJ, tracking.cpp:42-55). The
    row-major upper-triangle position of (r <= c) is 6r - r(r-1)/2 + c - r,
    computed on the device (a host-made index would cost a copy)."""
    a = torch.arange(6, device=v21.device)
    r = torch.minimum(a[:, None], a[None, :])
    c = torch.maximum(a[:, None], a[None, :])
    return v21[6 * r - (r * (r - 1)) // 2 + c - r]


def _cholesky_solve6(A, b):
    """6x6 Cholesky solve, column-vectorised with the JAX package's
    summation order (each entry's subtractions run kk = 0..j-1). A non-SPD
    system yields nan, caught by the caller's finite check."""
    L = [None] * 6          # L[j]: column j below the diagonal, [6 - j]
    diag = [None] * 6
    for j in range(6):
        s = A[j:, j]
        for kk in range(j):
            s = s - L[kk][j - kk:] * L[kk][j - kk]
        d = torch.sqrt(s[0])
        diag[j] = d
        L[j] = torch.cat([d[None], s[1:] / d])
    y = [None] * 6
    for i in range(6):
        s = b[i]
        for kk in range(i):
            s = s - L[kk][i - kk] * y[kk]
        y[i] = s / diag[i]
    x = [None] * 6
    for i in range(5, -1, -1):
        s = y[i]
        for kk in range(i + 1, 6):
            s = s - L[i][kk - i] * x[kk]
        x[i] = s / diag[i]
    return torch.stack(x)


def solve_normal_equations(reduction):
    """x = (J^T J)^{-1} J^T e from the 32-vector (tracking.cpp:57-64); a
    failed (non-finite) solve returns zeros."""
    x = _cholesky_solve6(make_jtj(reduction[7:28]), reduction[1:7])
    return torch.where(torch.isfinite(x).all(), x, torch.zeros_like(x))


def update_pose(pose, reduction, icp_threshold):
    """Apply one GN step (updatePoseKernel, 304-318): (new_pose, converged)."""
    x = solve_normal_equations(reduction)
    new_pose = se3.matmul4(se3.exp(x), pose)
    return new_pose, torch.linalg.vector_norm(x) < icp_threshold


def check_pose(pose, old_pose, reduction, image_size,
               track_threshold=TRACK_THRESHOLD):
    """Accept or roll back the tracked pose (checkPoseKernel, 320-336).
    Returns (pose, tracked bool[])."""
    n_inliers = reduction[28]
    rms = torch.sqrt(reduction[0] / torch.where(n_inliers == 0,
                                                torch.ones_like(n_inliers),
                                                n_inliers))
    total = image_size[0] * image_size[1]
    bad = (rms > 2e-2) | (n_inliers / total < track_threshold) \
        | (n_inliers == 0)
    return torch.where(bad, old_pose, pose), ~bad


class Carry(NamedTuple):
    """What one Gauss-Newton iteration of a sharded frame hands the next
    (:func:`icp_update`): the pose estimate, the last reduction that was
    not frozen (f32[32]) and whether the level has converged."""
    pose: torch.Tensor
    reduction: torch.Tensor
    done: torch.Tensor


def icp_update(red64, pose, carry: Carry = None, first_of_level=True,
               icp_threshold=1e-5, old_pose=None, image_size=None,
               track_threshold=TRACK_THRESHOLD):
    """One Gauss-Newton iteration from the ranks' summed reduction
    ``red64`` (f64[32], rounded here once to f32): JAX's ``track`` body in
    its ``axis_name`` mode (``ops/tracking.py:281-293``). ``pose`` is the
    estimate to step from (the frame's start pose on its first call,
    else ``carry.pose``); ``carry`` None is the frame's first call (the
    reduction reads as zeros); ``first_of_level`` clears ``done``, as
    each level's loop starts unfrozen. A converged level keeps its pose
    and reduction. With ``old_pose`` (the frame's last call) also runs
    ``check_pose`` against it over the reference's ``image_size`` (h, w)
    and returns (carry, (checked pose, tracked)), else (carry, None).
    One launch of one warp on a CUDA device, no host sync."""
    dev = red64.device
    if dev.type == "cpu":
        return icp_update_plain(red64, pose, carry, first_of_level,
                                icp_threshold, old_pose, image_size,
                                track_threshold)
    if dev.type != "cuda":
        raise ValueError(f"icp_update: unsupported device {dev}")
    c = _lib.check
    c(red64, "red64", torch.float64, (32,), dev)
    c(pose, "pose", torch.float32, (4, 4), dev)
    red_in = done_in = None
    if carry is not None:
        red_in = c(carry.reduction, "reduction", torch.float32, (32,), dev)
        if not first_of_level:
            done_in = c(carry.done, "done", torch.bool, (), dev)
    out = _empty_carry(dev)
    checked = tracked = None
    if old_pose is not None:
        c(old_pose, "old_pose", torch.float32, (4, 4), dev)
        checked = torch.empty((4, 4), dtype=torch.float32, device=dev)
        tracked = torch.empty((), dtype=torch.bool, device=dev)
    rh, rw = image_size if old_pose is not None else (0, 0)
    _lib.launch("icp_update", "se_icp_update", dev, red64, pose, red_in,
                done_in, out.pose, out.reduction, out.done,
                float(icp_threshold), old_pose, float(track_threshold), rh,
                rw, checked, tracked)
    return out, (None if old_pose is None else (checked, tracked))


def icp_update_plain(red64, pose, carry: Carry = None, first_of_level=True,
                     icp_threshold=1e-5, old_pose=None, image_size=None,
                     track_threshold=TRACK_THRESHOLD):
    """Plain PyTorch twin of :func:`icp_update`: ``update_pose``, the
    freeze by ``torch.where`` and ``check_pose``."""
    red = red64.to(torch.float32)
    new_pose, converged = update_pose(pose, red, icp_threshold)
    if carry is None:
        reduction = torch.zeros(32, dtype=torch.float32, device=pose.device)
    else:
        reduction = carry.reduction
    done = torch.zeros((), dtype=torch.bool, device=pose.device) \
        if carry is None or first_of_level else carry.done
    out = Carry(torch.where(done, pose, new_pose),
                torch.where(done, reduction, red), done | converged)
    if old_pose is None:
        return out, None
    return out, check_pose(out.pose, old_pose, out.reduction, image_size,
                           track_threshold)


def icp_reduce_step_plain(red64, pose, carry, first_of_level,
                          next_first_of_level, icp_threshold, in_vertex,
                          in_normal, in_valid, ref_vertex, ref_normal,
                          ref_valid, view, dist_threshold=DIST_THRESHOLD,
                          normal_threshold=NORMAL_THRESHOLD, x0=0,
                          width=None):
    """Plain PyTorch twin of :func:`icp_reduce_step`:
    :func:`icp_update_plain`, then :func:`icp_reduce64_plain` at the
    stepped pose, zeros where the stepped carry is done and the next
    iteration is not its level's first."""
    new, _ = icp_update_plain(red64, pose, carry, first_of_level,
                              icp_threshold)
    _, red = icp_reduce64_plain(in_vertex, in_normal, in_valid, ref_vertex,
                                ref_normal, ref_valid, new.pose, view,
                                dist_threshold, normal_threshold, x0, width)
    frozen = new.done & (not next_first_of_level)
    return new, torch.where(frozen, torch.zeros_like(red), red)


def icp_track(pose, view, pyr_vertex, pyr_normal, pyr_valid, ref_vertex,
              ref_normal, ref_valid, iterations: Sequence[int],
              icp_threshold, dist_threshold=DIST_THRESHOLD,
              normal_threshold=NORMAL_THRESHOLD,
              track_threshold=TRACK_THRESHOLD):
    """The coarse-to-fine ICP of one frame (DenseSLAMSystem::tracking,
    143-189), from the coarsest level to the finest, then check_pose.

    pose: camera-to-world estimate [4, 4]; view: K @ raycast_pose^-1
    [4, 4]; pyr_*: tuples of per-level maps [h, w, (3)], finest first, one
    per entry of ``iterations``; ref_*: the last raycast [H, W, (3)]. All
    on one device. Returns (pose f32[4, 4], tracked bool[], reduction
    f32[32], result i32[h0, w0]).
    """
    return _icp_track(pose, view, pyr_vertex, pyr_normal, pyr_valid,
                      ref_vertex, ref_normal, ref_valid, iterations,
                      icp_threshold, dist_threshold, normal_threshold,
                      track_threshold)[:4]


def _icp_track(pose, view, pyr_vertex, pyr_normal, pyr_valid, ref_vertex,
               ref_normal, ref_valid, iterations, icp_threshold,
               dist_threshold=DIST_THRESHOLD,
               normal_threshold=NORMAL_THRESHOLD,
               track_threshold=TRACK_THRESHOLD):
    """:func:`icp_track`'s outputs and the Gauss-Newton iterations run at
    each level (i32[levels], finest first), which a bound on the frame's
    work counts."""
    dev = pose.device
    if dev.type == "cpu":
        return _icp_track_plain(pose, view, pyr_vertex, pyr_normal,
                                pyr_valid, ref_vertex, ref_normal, ref_valid,
                                iterations, icp_threshold, dist_threshold,
                                normal_threshold, track_threshold)
    if dev.type != "cuda":
        raise ValueError(f"icp_track: unsupported device {dev}")
    n_levels = len(iterations)
    if not 1 <= n_levels <= _lib.MAX_ICP_LEVELS:
        raise ValueError(f"icp_track: {n_levels} levels, the kernel takes "
                         f"1 to {_lib.MAX_ICP_LEVELS}")
    c = _lib.check
    rh, rw = ref_vertex.shape[:2]
    c(ref_vertex, "ref_vertex", torch.float32, (rh, rw, 3), dev)
    c(ref_normal, "ref_normal", torch.float32, (rh, rw, 3), dev)
    c(ref_valid, "ref_valid", torch.bool, (rh, rw), dev)
    c(pose, "pose", torch.float32, (4, 4), dev)
    c(view, "view", torch.float32, (4, 4), dev)
    pyr = _lib.Pyramid()
    pyr.n_levels = n_levels
    for lvl in range(n_levels):
        h, w = pyr_vertex[lvl].shape[:2]
        pyr.vertex[lvl] = c(pyr_vertex[lvl], "pyr_vertex", torch.float32,
                            (h, w, 3), dev).data_ptr()
        pyr.normal[lvl] = c(pyr_normal[lvl], "pyr_normal", torch.float32,
                            (h, w, 3), dev).data_ptr()
        pyr.valid[lvl] = c(pyr_valid[lvl], "pyr_valid", torch.bool, (h, w),
                           dev).data_ptr()
        pyr.h[lvl], pyr.w[lvl] = h, w
        pyr.iterations[lvl] = int(iterations[lvl])
    new_pose = torch.empty((4, 4), dtype=torch.float32, device=dev)
    tracked = torch.empty((), dtype=torch.bool, device=dev)
    reduction = torch.empty(32, dtype=torch.float32, device=dev)
    result = torch.empty(tuple(pyr_vertex[0].shape[:2]), dtype=torch.int32,
                         device=dev)
    run = torch.empty(n_levels, dtype=torch.int32, device=dev)
    sums, counts = _grid_scratch(dev)
    _lib.launch("icp_track", "se_icp_track", dev, pyr, ref_vertex,
                ref_normal, ref_valid, rh, rw, pose, view,
                float(icp_threshold), float(dist_threshold),
                float(normal_threshold), float(track_threshold), new_pose,
                tracked, reduction, result, run, sums, counts)
    return new_pose, tracked, reduction, result, run


# (device, stream) -> icp_track's cross-cluster sums f64[2, 8, 32] and
# counters u32[8], zero between launches (the kernel clears its counters
# before it exits); one pair a stream, as launches on two streams may run
# at once
_GRID = {}


def _grid_scratch(dev):
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    if key not in _GRID:
        _GRID[key] = (torch.zeros(2 * 8 * 32, dtype=torch.float64,
                                  device=dev),
                      torch.zeros(8, dtype=torch.int32, device=dev))
    return _GRID[key]


def track_clusters(pixels, dev):
    """The clusters of 16 CTAs an :func:`icp_track` launch over a finest
    level of ``pixels`` pixels takes on the CUDA device ``dev``: as many
    as the card holds at once, at most 8."""
    out = torch.zeros((), dtype=torch.int32)
    with torch.cuda.device(dev):
        err = _lib.library().se_icp_track_clusters(int(pixels),
                                                   out.data_ptr())
    if err != 0:
        raise RuntimeError(f"se_icp_track_clusters: CUDA error {err}")
    return int(out)


def icp_track_plain(pose, view, pyr_vertex, pyr_normal, pyr_valid,
                    ref_vertex, ref_normal, ref_valid,
                    iterations: Sequence[int], icp_threshold,
                    dist_threshold=DIST_THRESHOLD,
                    normal_threshold=NORMAL_THRESHOLD,
                    track_threshold=TRACK_THRESHOLD):
    """Plain PyTorch twin of :func:`icp_track`: the full trip counts with
    a converged level frozen by ``torch.where`` (the reference's early
    break), as JAX's ``track`` runs them."""
    return _icp_track_plain(pose, view, pyr_vertex, pyr_normal, pyr_valid,
                            ref_vertex, ref_normal, ref_valid, iterations,
                            icp_threshold, dist_threshold, normal_threshold,
                            track_threshold)[:4]


def _icp_track_plain(pose, view, pyr_vertex, pyr_normal, pyr_valid,
                     ref_vertex, ref_normal, ref_valid, iterations,
                     icp_threshold, dist_threshold, normal_threshold,
                     track_threshold):
    """:func:`icp_track_plain`'s outputs and the iterations run at each
    level: an iteration counts as run where its level was not frozen
    yet."""
    old_pose = pose
    reduction = torch.zeros(32, dtype=torch.float32, device=pose.device)
    run = [None] * len(iterations)
    result_fine = None
    for level in range(len(iterations) - 1, -1, -1):
        iv, inorm, ival = pyr_vertex[level], pyr_normal[level], \
            pyr_valid[level]
        result = torch.zeros(iv.shape[:2], dtype=torch.int32,
                             device=pose.device)
        done = torch.zeros((), dtype=torch.bool, device=pose.device)
        run[level] = torch.zeros((), dtype=torch.int32, device=pose.device)
        for _ in range(iterations[level]):
            run[level] = run[level] + (~done).to(torch.int32)
            res, red = icp_reduce_plain(iv, inorm, ival, ref_vertex,
                                        ref_normal, ref_valid, pose, view,
                                        dist_threshold, normal_threshold)
            new_pose, converged = update_pose(pose, red, icp_threshold)
            # frozen once converged: the reference breaks the level loop
            pose = torch.where(done, pose, new_pose)
            reduction = torch.where(done, reduction, red)
            result = torch.where(done, result, res)
            done = done | converged
        if level == 0:
            result_fine = result
    pose, tracked = check_pose(pose, old_pose, reduction,
                               ref_vertex.shape[:2], track_threshold)
    return pose, tracked, reduction, result_fine, torch.stack(run)
