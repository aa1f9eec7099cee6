"""Windowed pose-graph optimization (the bundle-adjustment layer), on
torch tensors.

Port of ``supereight_tpu/posegraph/graph.py`` (27-209). A keyframe graph
with SE(3) relative-pose constraints is solved by Gauss-Newton over a
sliding window:

  minimize  sum_e  || log( T_meas_e^-1 · T_i^-1 · T_j ) ||^2_{W_e}

Per-edge residuals and Jacobians (forward-mode ``torch.func`` products
over all edges at once) are assembled into the 6N x 6N normal equations
through one-hot incidence matrices: a product of dense matrices, with no
scatter and so no float atomics, is the same run to run. The system is
solved by a Cholesky factorisation (``torch.linalg.cholesky_ex``, whose
status is not read back to the host: a failed factorisation becomes NaNs
on the device, as JAX's ``cho_factor`` gives). Everything runs on the
device of the poses, in f32 with TF32 off: JAX pins
``Precision.HIGHEST`` here.
"""

import contextlib
from typing import NamedTuple

import torch

from supereight_tpu_torch.core import se3

mm = se3.matmul4  # small products summed left to right, on any device


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
    of ``se3.exp``. Below theta ~ 1e-3 the closed forms lose all f32
    precision (1 - cos(1e-4) is 0 in f32), so a Taylor window takes over
    there."""
    w = so3_log(T[..., :3, :3])
    theta_sq = (w * w).sum(-1)
    theta = torch.sqrt(theta_sq)
    small = theta_sq < 1e-6
    th = torch.where(small, torch.ones_like(theta), theta)
    W = se3.hat(w)
    W2 = mm(W, W)
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
    v = mm(Vinv, T[..., :3, 3:4])[..., 0]
    return torch.cat([v, w], -1)


class PoseGraph(NamedTuple):
    """Edge list over a pose window (fixed capacity, masked)."""
    i: torch.Tensor        # int[E] source node
    j: torch.Tensor        # int[E] target node
    t_meas: torch.Tensor   # f32[E, 4, 4] measured relative pose T_i^-1 T_j
    weight: torch.Tensor   # f32[E] scalar information (isotropic)
    valid: torch.Tensor    # bool[E]


def edge_residual(t_i, t_j, t_meas):
    """r = log(T_meas^-1 T_i^-1 T_j), [6]."""
    rel = mm(se3.inverse(t_i), t_j)
    return se3_log(mm(se3.inverse(t_meas), rel))


def _residual_local(xi, xj, t_i, t_j, t_meas):
    """The residual as a function of local tangent perturbations."""
    return edge_residual(mm(se3.exp(xi), t_i), mm(se3.exp(xj), t_j), t_meas)


def edge_jacobians(t_i, t_j, t_meas):
    """Each edge's Jacobians of :func:`_residual_local` at zero
    perturbation, [E, 6, 6] with respect to xi and xj (JAX: ``jacfwd``
    per edge under ``vmap``). Edges are independent, so one forward-mode
    product with the same unit tangent on every edge gives that column of
    every edge's Jacobian: ``torch.func.vmap`` runs the 12 columns at
    once over the batched edges. (``jacfwd`` under a ``vmap`` over the
    edges, where each edge's entries are 0-d, carries some tangents in f64
    in torch 2.13: ``1.0 + r00`` promotes them.)"""
    e = t_i.shape[0]
    zeros = torch.zeros((e, 12), dtype=t_i.dtype, device=t_i.device)
    basis = torch.eye(12, dtype=t_i.dtype, device=t_i.device)[:, None, :] \
        .expand(12, e, 12)

    def residual(x):
        return _residual_local(x[:, :6], x[:, 6:], t_i, t_j, t_meas)

    def column(t):
        return torch.func.jvp(residual, (zeros,), (t,))[1]

    jac = torch.func.vmap(column)(basis).permute(1, 2, 0)  # [E, 6, 12]
    return jac[..., :6], jac[..., 6:]


@contextlib.contextmanager
def _full_f32():
    """Products of f32 matrices in full f32 (no TF32) inside."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def optimize(poses, graph: PoseGraph, num_nodes: int, iters: int = 10,
             damping: float = 1e-6, fixed=None):
    """Gauss-Newton over the window; node 0 is the gauge (held fixed).

    poses: f32[N, 4, 4] camera-to-world, on any device (the work stays
    there, with no host read). Returns the optimized poses.

    ``fixed`` (optional bool[N]): more nodes held exactly fixed, the
    frozen loop-closure anchors kept past the sliding window. Fixed nodes
    are masked out: their rows and columns of H become identity and their
    gradient zero, so the solve leaves them untouched without hurting its
    conditioning. The edges' ``valid`` mask zeroes padded edges.
    """
    dev, n6 = poses.device, 6 * num_nodes
    if fixed is None:
        fixed = torch.zeros(num_nodes, dtype=torch.bool, device=dev)
    fixed = fixed.to(dev).clone()
    fixed[:1].fill_(True)  # node 0 is always gauge
    free6 = (~fixed).repeat_interleave(6).to(torch.float32)
    scale = torch.where(graph.valid, graph.weight, 0.0)
    inc_i = torch.nn.functional.one_hot(graph.i.long(), num_nodes) \
        .to(torch.float32)
    inc_j = torch.nn.functional.one_hot(graph.j.long(), num_nodes) \
        .to(torch.float32)
    eye = torch.eye(n6, dtype=torch.float32, device=dev)
    with _full_f32():
        for _ in range(iters):
            t_i, t_j = poses[graph.i.long()], poses[graph.j.long()]
            r = edge_residual(t_i, t_j, graph.t_meas) * scale[:, None]
            ji, jj = edge_jacobians(t_i, t_j, graph.t_meas)
            ji = ji * scale[:, None, None]
            jj = jj * scale[:, None, None]
            # each edge's rows of the full Jacobian [E, 6, N * 6]: its two
            # 6x6 blocks placed by the one-hot incidence of i and j
            jac = (inc_i[:, None, :, None] * ji[:, :, None, :]
                   + inc_j[:, None, :, None] * jj[:, :, None, :]
                   ).reshape(-1, n6)
            H = jac.T @ jac
            b = jac.T @ r.reshape(-1)
            # gauge: fixed nodes masked out of H with identity on their
            # diagonal (a stiff prior would push cond(H) past f32)
            H = H * free6[:, None] * free6[None, :] \
                + torch.diag(1.0 - free6) + eye * damping
            b = b * free6
            # a failed factorisation leaves NaNs, as JAX's cho_factor does
            # (a window whose free nodes have lost their tie to a fixed one
            # is singular but for the damping)
            L, info = torch.linalg.cholesky_ex(H)
            L = torch.where(info == 0, L, torch.nan)
            dx = -torch.cholesky_solve(b[:, None], L)[:, 0]
            dx = (dx * free6).reshape(num_nodes, 6)
            poses = mm(se3.exp(dx), poses)
    return poses
