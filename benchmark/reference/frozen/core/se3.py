"""SE(3) utilities (exp and log maps, inverse, camera matrices) on torch
tensors.

Port of ``supereight_tpu/core/se3.py``, and of the logs that JAX keeps in
``supereight_tpu/posegraph/graph.py`` (:func:`rot_to_quat`,
:func:`so3_log`, :func:`se3_log`). Twist layout matches Sophus:
x = [translation(3), rotation(3)]. Everything stays on the device of its
input: no helper here reads a value back to the host.
"""

import torch


def hat(w):
    """Skew-symmetric matrix of w[..., 3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def exp(twist):
    """SE(3) exponential map; twist [..., 6] -> [..., 4, 4] matrix.

    Uses the Taylor expansion below 1e-8 rad^2 so it is safe at the
    identity (where ICP converges). Every sum runs left to right (as in
    :func:`matmul4`), the order csrc/icp.cu's icp_track uses, so the two
    agree bit for bit on the same twist.
    """
    v, w = twist[..., :3], twist[..., 3:]
    theta_sq = w[..., 0] * w[..., 0] + w[..., 1] * w[..., 1] \
        + w[..., 2] * w[..., 2]
    theta = torch.sqrt(theta_sq)
    small = theta_sq < 1e-8

    th = torch.where(small, torch.ones_like(theta), theta)
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(th)) / (th * th))
    c = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (th - torch.sin(th)) / (th * th * th))

    W = hat(w)
    W2 = matmul4(W, W)
    eye = torch.eye(3, dtype=twist.dtype, device=twist.device).expand(W.shape)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    t = matmul4(V, v[..., None])[..., 0]

    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = _bottom_row(top)
    return torch.cat([top, bottom], dim=-2)


def _bottom_row(top):
    # filled on the device: assigning a Python scalar into a CUDA tensor
    # copies it from the host and synchronises
    row = torch.zeros_like(top[..., :1, :])
    row[..., 0, 3].fill_(1.0)
    return row


def inverse(T):
    """Inverse of a rigid transform [..., 4, 4]; R^T t is summed left to
    right (:func:`matmul4`), as csrc/frame.cu's kernel sums it."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    ti = -matmul4(Rt, t[..., None])[..., 0]
    top = torch.cat([Rt, ti[..., :, None]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def matmul4(a, b):
    """a @ b for small [..., n, k] @ [..., k, m] matrices (4x4 poses, 3x3
    rotations) with each dot product summed left to right (k = 0, 1, ...),
    the order of the JAX reference's small f32 dots; a library matmul may
    sum in another order and differ in the last bit, which can move a
    floor() in the allocation march."""
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for j in range(1, a.shape[-1]):
        out = out + a[..., :, j:j + 1] * b[..., j:j + 1, :]
    return out


def _rdiv(a: float, t):
    """a / t as one f32 division (torch's ``float / tensor`` takes the
    reciprocal, then multiplies)."""
    return torch.full_like(t, a) / t


def rot_to_quat(R):
    """Rotation matrix -> quaternion (w, x, y, z), branchless Shepperd:
    all four candidates are computed and the best-conditioned one
    selected with masks, so forward-mode derivatives flow through a smooth
    branch (its denominator is bounded below by 1)."""
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    d0 = 1.0 + r00 + r11 + r22       # 4 w^2
    d1 = 1.0 + r00 - r11 - r22       # 4 x^2
    d2 = 1.0 - r00 + r11 - r22       # 4 y^2
    d3 = 1.0 - r00 - r11 + r22       # 4 z^2
    best = torch.stack([d0, d1, d2, d3], -1).argmax(-1)

    def cand(d, a, b, c, order):
        s = torch.sqrt(d.clamp(min=1e-12))
        half = 0.5 * s
        inv = _rdiv(0.5, s)
        out = [None] * 4
        for slot, v in zip(order, (half, a * inv, b * inv, c * inv)):
            out[slot] = v
        return torch.stack(out, -1)

    q0 = cand(d0, r21 - r12, r02 - r20, r10 - r01, (0, 1, 2, 3))
    q1 = cand(d1, r21 - r12, r01 + r10, r02 + r20, (1, 0, 2, 3))
    q2 = cand(d2, r02 - r20, r01 + r10, r12 + r21, (2, 0, 1, 3))
    q3 = cand(d3, r10 - r01, r02 + r20, r12 + r21, (3, 0, 1, 2))
    best = best[..., None]
    q = torch.where(best == 0, q0, torch.where(
        best == 1, q1, torch.where(best == 2, q2, q3)))
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)  # canonical w >= 0


def so3_log(R):
    """Rotation matrix -> axis-angle [..., 3], differentiable at the
    identity: the quaternion route with a Taylor branch for small
    rotations."""
    q = rot_to_quat(R)
    qw, qv = q[..., 0], q[..., 1:]
    nv_sq = (qv * qv).sum(-1)
    small = nv_sq < 1e-10
    nv = torch.sqrt(torch.where(small, torch.ones_like(nv_sq), nv_sq))
    big_scale = 2.0 * torch.atan2(nv, qw) / nv
    qc = qw.clamp(min=1e-6)
    taylor = _rdiv(2.0, qc) * (1.0 - nv_sq / (3.0 * qc ** 2))
    return qv * torch.where(small, taylor, big_scale)[..., None]


def se3_log(T):
    """SE(3) matrix -> twist [..., 6] (translation, rotation), the inverse
    of :func:`exp`. Below theta ~ 1e-3 the closed forms lose all f32
    precision (1 - cos(1e-4) is 0 in f32), so a Taylor window takes over
    there."""
    w = so3_log(T[..., :3, :3])
    theta_sq = (w * w).sum(-1)
    theta = torch.sqrt(theta_sq)
    small = theta_sq < 1e-6
    th = torch.where(small, torch.ones_like(theta), theta)
    W = hat(w)
    W2 = matmul4(W, W)
    sin_half = torch.sin(0.5 * th)
    # b = (1 - cos th) / th^2 = 2 sin^2(th/2) / th^2, the half-angle form
    b = torch.where(small, 0.5 - theta_sq / 24.0,
                    2.0 * sin_half * sin_half / (th * th))
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(W.shape)
    # V^-1 = I - W/2 + (1/theta^2)(1 - a/(2b)) W^2
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(th) / th)
    coef = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0,
                       (1.0 - a / (2.0 * b)) / (th * th))
    Vinv = eye - 0.5 * W + coef[..., None, None] * W2
    v = matmul4(Vinv, T[..., :3, 3:4])[..., 0]
    return torch.cat([v, w], -1)


def transform_c(T, x, y, z):
    """Apply a 4x4 rigid/projective-affine transform to component tensors,
    summed left to right as the JAX package does (and the kernels do)."""
    return (T[0, 0] * x + T[0, 1] * y + T[0, 2] * z + T[0, 3],
            T[1, 0] * x + T[1, 1] * y + T[1, 2] * z + T[1, 3],
            T[2, 0] * x + T[2, 1] * y + T[2, 2] * z + T[2, 3])


def rotate_c(T, x, y, z):
    """Rotation-only component-wise form of :func:`transform_c`."""
    return (T[0, 0] * x + T[0, 1] * y + T[0, 2] * z,
            T[1, 0] * x + T[1, 1] * y + T[1, 2] * z,
            T[2, 0] * x + T[2, 1] * y + T[2, 2] * z)


def camera_matrix(k):
    """4x4 intrinsics from the f32 tensor k = (fx, fy, cx, cy)
    (ref commons.h:255-262)."""
    fx, fy, cx, cy = k[0], k[1], k[2], k[3]
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    return torch.stack([torch.stack([fx, z, cx, z]),
                        torch.stack([z, fy, cy, z]),
                        torch.stack([z, z, o, z]),
                        torch.stack([z, z, z, o])])


def inverse_camera_matrix(k):
    """Inverse intrinsics (ref commons.h:264-270)."""
    fx, fy, cx, cy = k[0], k[1], k[2], k[3]
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    return torch.stack([torch.stack([1.0 / fx, z, -cx / fx, z]),
                        torch.stack([z, 1.0 / fy, -cy / fy, z]),
                        torch.stack([z, z, o, z]),
                        torch.stack([z, z, z, o])])
