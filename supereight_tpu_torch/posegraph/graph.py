"""Windowed pose-graph optimization (the bundle-adjustment layer), on
torch tensors.

Port of ``supereight_tpu/posegraph/graph.py`` (27-209). A keyframe graph
with SE(3) relative-pose constraints is solved by Gauss-Newton over a
sliding window:

  minimize  sum_e  || log( T_meas_e^-1 · T_i^-1 · T_j ) ||^2_{W_e}

:func:`optimize` is K9 (``kernels/ba.py``): on the card one launch of
``csrc/ba.cu`` a solve, any window up to ``ba.INDEX_NODES`` nodes; on the
CPU its plain twin, forward-mode ``torch.func`` Jacobians and a Cholesky solve. The
edge residual and its Jacobians live beside them in ``kernels/ba.py``,
the SE(3) logs in ``core/se3.py``; they are named here too, where JAX's
module holds them.
"""

from typing import NamedTuple

import torch

from supereight_tpu_torch.core.se3 import (  # noqa: F401
    rot_to_quat, se3_log, so3_log)
from supereight_tpu_torch.kernels import ba
from supereight_tpu_torch.kernels.ba import (  # noqa: F401
    edge_jacobians, edge_residual)


class PoseGraph(NamedTuple):
    """Edge list over a pose window (fixed capacity, masked)."""
    i: torch.Tensor        # int[E] source node
    j: torch.Tensor        # int[E] target node
    t_meas: torch.Tensor   # f32[E, 4, 4] measured relative pose T_i^-1 T_j
    weight: torch.Tensor   # f32[E] scalar information (isotropic)
    valid: torch.Tensor    # bool[E]


def optimize(poses, graph: PoseGraph, num_nodes: int, iters: int = 10,
             damping: float = 1e-6, fixed=None):
    """Gauss-Newton over the window; node 0 is the gauge (held fixed).

    poses: f32[N, 4, 4] camera-to-world, on any device (the work stays
    there; on the card one range check of the edges is the only host
    read). Returns the optimized poses.

    ``fixed`` (optional bool[N]): more nodes held exactly fixed, the
    frozen loop-closure anchors kept past the sliding window. Fixed nodes
    are masked out: their rows and columns of H become identity and their
    gradient zero, so the solve leaves them untouched without hurting its
    conditioning. The edges' ``valid`` mask zeroes padded edges.
    """
    return ba.ba_solve(poses, graph, num_nodes, iters, damping, fixed)
