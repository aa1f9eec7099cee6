"""K9 wrapper and twin: the windowed pose-graph solve (bundle adjustment).

Replaces ``supereight_tpu/posegraph/graph.py:optimize`` (132-212), the
program JAX compiles once a window size: per-edge residuals and their
``jacfwd`` Jacobians, the normal equations, the gauge mask and damping,
the Cholesky solve and the pose update, ``iters`` times. The CUDA kernel
is ``csrc/ba.cu``: one launch a solve, in one of two tiers chosen from n
(:func:`plan`): Tier S, one CTA with H in shared memory, for every
window whose H fits there (:func:`tier_s_nodes`: 39 nodes on the H100);
Tier L, one CTA an SM with H in device memory and a grid barrier between
the phases, for any larger window up to :data:`INDEX_NODES`. Its source
note says what bounds it on the H100. n and the edge capacity E are
run-time arguments, so a window that grows between solves needs no new
build or capture.

:func:`ba_solve_plain` is the plain PyTorch version (forward-mode
``torch.func`` Jacobians, one-hot incidence products, ``cholesky_ex``),
used for CPU tensors and as the kernel's reference on the card. The edge
residual it differentiates lives here too (its SE(3) log in
``core/se3.py``).
"""

import contextlib
import ctypes
from typing import NamedTuple

import torch

from supereight_tpu_torch.core import se3
from supereight_tpu_torch.kernels import _lib

mm = se3.matmul4  # small products summed left to right, on any device

# nodes a launch takes: csrc/ba.cu indexes H (36 n^2 floats) in int32
INDEX_NODES = 7723
MAX_EDGES = 1 << 20  # csrc/ba.cu's kMaxEdges: its scratch indexing in int32
PANEL = 32  # csrc/ba.cu's kPanel: the factor's panel, one warp's lanes
TILE = 64   # csrc/ba.cu's kTile: the trailing update's tile edge
TIERS = ("S", "L")


class Plan(NamedTuple):
    """A launch's tier ("S" or "L"), CTAs, scratch (4-byte words) and
    dynamic shared memory (bytes), as ``csrc/ba.cu`` plans it."""
    tier: str
    ctas: int
    words: int
    smem: int


def edge_residual(t_i, t_j, t_meas):
    """r = log(T_meas^-1 T_i^-1 T_j), [6]."""
    rel = mm(se3.inverse(t_i), t_j)
    return se3.se3_log(mm(se3.inverse(t_meas), rel))


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


def _free6(num_nodes, fixed, dev):
    """1 on the rows of free nodes, 0 on node 0's and the fixed ones'."""
    if fixed is None:
        fixed = torch.zeros(num_nodes, dtype=torch.bool, device=dev)
    fixed = fixed.to(dev).clone()
    fixed[:1].fill_(True)  # node 0 is always gauge
    return (~fixed).repeat_interleave(6).to(torch.float32)


def normal_equations_plain(poses, graph, num_nodes: int, damping: float,
                           free6):
    """One Gauss-Newton iteration's H f32[6N, 6N] and b f32[6N] at
    ``poses``, in torch ops (the twin's; TF32 off inside). The normal
    equations come from one-hot incidence matrices: a product of dense
    matrices, with no scatter and so no float atomics, is the same run to
    run."""
    dev, n6 = poses.device, 6 * num_nodes
    scale = torch.where(graph.valid, graph.weight, 0.0)
    inc_i = torch.nn.functional.one_hot(graph.i.long(), num_nodes) \
        .to(torch.float32)
    inc_j = torch.nn.functional.one_hot(graph.j.long(), num_nodes) \
        .to(torch.float32)
    with _full_f32():
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
    # gauge: fixed nodes masked out of H with identity on their diagonal
    # (a stiff prior would push cond(H) past f32)
    H = H * free6[:, None] * free6[None, :] \
        + torch.diag(1.0 - free6) \
        + torch.eye(n6, dtype=torch.float32, device=dev) * damping
    return H, b * free6


def ba_solve_plain(poses, graph, num_nodes: int, iters: int = 10,
                   damping: float = 1e-6, fixed=None):
    """:func:`ba_solve` in torch ops: ``iters`` Gauss-Newton iterations,
    everything on the device of the poses, in f32 with TF32 off (JAX pins
    ``Precision.HIGHEST`` here): :func:`normal_equations_plain`, then
    ``cholesky_ex`` and ``cholesky_solve``. The Cholesky status is not
    read back to the host: a failed factorisation becomes NaNs on the
    device, as JAX's ``cho_factor`` gives."""
    free6 = _free6(num_nodes, fixed, poses.device)
    with _full_f32():
        for _ in range(iters):
            H, b = normal_equations_plain(poses, graph, num_nodes, damping,
                                          free6)
            # a failed factorisation leaves NaNs, as JAX's cho_factor does
            # (a window whose free nodes have lost their tie to a fixed one
            # is singular but for the damping)
            L, info = torch.linalg.cholesky_ex(H)
            L = torch.where(info == 0, L, torch.nan)
            dx = -torch.cholesky_solve(b[:, None], L)[:, 0]
            dx = (dx * free6).reshape(num_nodes, 6)
            poses = mm(se3.exp(dx), poses)
    return poses


def _check(poses, graph, num_nodes, iters, fixed):
    """Raise ValueError on what neither version takes; returns E."""
    if num_nodes < 1:
        raise ValueError(f"ba_solve: num_nodes must be >= 1, got {num_nodes}")
    if iters < 0:
        raise ValueError(f"ba_solve: iters must be >= 0, got {iters}")
    dev = poses.device
    e = graph.i.shape[0] if graph.i.dim() == 1 else -1
    want = (("poses", poses, (torch.float32,), (num_nodes, 4, 4)),
            ("graph.i", graph.i, (torch.int32, torch.int64), (e,)),
            ("graph.j", graph.j, (torch.int32, torch.int64), (e,)),
            ("graph.t_meas", graph.t_meas, (torch.float32,), (e, 4, 4)),
            ("graph.weight", graph.weight, (torch.float32,), (e,)),
            ("graph.valid", graph.valid, (torch.bool,), (e,)))
    if fixed is not None:
        want += (("fixed", fixed, (torch.bool,), (num_nodes,)),)
    for name, t, dtypes, shape in want:
        if t.dtype not in dtypes:
            raise ValueError(f"ba_solve: {name} must be of dtype "
                             f"{' or '.join(map(str, dtypes))}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"ba_solve: {name} must have shape {shape}, "
                             f"got {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"ba_solve: {name} is on {t.device}, the poses "
                             f"on {dev}")
    if e and not (dev.type == "cuda"
                  and torch.cuda.is_current_stream_capturing()):
        # the one host read of a call (none while a graph captures it: the
        # kernel then turns an index out of range into NaN poses)
        lo, hi = torch.stack([torch.minimum(graph.i.min(), graph.j.min()),
                              torch.maximum(graph.i.max(), graph.j.max())]
                             ).tolist()
        if lo < 0 or hi >= num_nodes:
            raise ValueError(f"ba_solve: edge nodes must lie in [0, "
                             f"{num_nodes}), got [{lo}, {hi}]")
    return e


def plan(num_nodes: int, edges: int, device) -> Plan:
    """The kernel's plan for a window of ``num_nodes`` nodes and ``edges``
    edge slots on the CUDA device ``device``: Tier S where its H fits the
    shared memory, else Tier L. Raises ValueError on a window the kernel
    does not take."""
    out = (ctypes.c_longlong * 4)()
    with torch.cuda.device(device):
        err = _lib.library().se_ba_plan(int(num_nodes), int(edges),
                                        ctypes.addressof(out))
    if err != 0:
        raise ValueError(f"ba_solve: no plan for {num_nodes} nodes and "
                         f"{edges} edge slots (error {err})")
    return Plan(TIERS[out[0]], int(out[1]), int(out[2]), int(out[3]))


def tier_s_nodes(device) -> int:
    """The most nodes Tier S takes on the CUDA device ``device`` (its H,
    an augmented 6n x 6n square, and vectors in the opt-in shared memory
    of one CTA)."""
    out = ctypes.c_int()
    with torch.cuda.device(device):
        err = _lib.library().se_ba_tier_nodes(ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"se_ba_tier_nodes failed with error {err}")
    return out.value


def ba_solve(poses, graph, num_nodes: int, iters: int = 10,
             damping: float = 1e-6, fixed=None):
    """``iters`` Gauss-Newton iterations over the window; node 0 is the
    gauge (held fixed), and so is every node set in ``fixed`` (bool[N]).

    poses: f32[N, 4, 4] camera-to-world; ``graph`` has the fields of
    ``posegraph.graph.PoseGraph`` (i, j int32 or int64 [E], t_meas
    f32[E, 4, 4], weight f32[E], valid bool[E]), all on the poses'
    device. Returns the optimized poses, a new tensor. CPU tensors run
    :func:`ba_solve_plain`; CUDA tensors launch ``csrc/ba.cu`` once in
    the tier :func:`plan` picks, or raise (a window over INDEX_NODES nodes
    or MAX_EDGES edges, before anything is allocated).
    """
    e = _check(poses, graph, num_nodes, iters, fixed)
    dev = poses.device
    if dev.type == "cpu":
        return ba_solve_plain(poses, graph, num_nodes, iters, damping, fixed)
    if dev.type != "cuda":
        raise ValueError(f"ba_solve: unsupported device {dev}")
    if num_nodes > INDEX_NODES:
        raise ValueError(f"ba_solve: the kernel indexes H (36 n^2 floats) "
                         f"in int32 and takes at most INDEX_NODES = "
                         f"{INDEX_NODES} nodes, got {num_nodes}")
    if e > MAX_EDGES:
        raise ValueError(f"ba_solve: the kernel takes at most {MAX_EDGES} "
                         f"edges, got {e}")
    p = plan(num_nodes, e, dev)
    scratch = torch.empty(p.words, dtype=torch.float32, device=dev)
    out = torch.empty_like(poses)
    _lib.launch("ba_solve", "se_ba_solve", dev, poses.contiguous(), out,
                graph.i.to(torch.int32).contiguous(),
                graph.j.to(torch.int32).contiguous(),
                graph.t_meas.contiguous(), graph.weight.contiguous(),
                graph.valid.contiguous(),
                None if fixed is None else fixed.contiguous(), num_nodes, e,
                iters, damping, scratch, p.words)
    return out
