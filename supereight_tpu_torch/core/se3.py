"""SE(3) utilities (exp map, inverse, camera matrices) on torch tensors.

Port of ``supereight_tpu/core/se3.py``. Twist layout matches Sophus:
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
