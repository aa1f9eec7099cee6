"""Projective map integration (fusion), TSDF and OFusion.

Port of ``supereight_tpu/ops/integration.py:integrate`` (ref
se::functor::projective_functor, projective_functor.hpp:54-156): compact
the active + in-frustum blocks into a fixed-budget worklist, update every
voxel of those blocks with the field's functor (kernel K3,
``kernels/integrate.py``: three launches with the nearest-depth read, two
with the bilinear one), then re-fuse every existing coarse (mip) value at
its octant origin corner with the same functor (the node pass, kernel K4,
``kernels/node.py``: nearest read, no noise weight, as JAX's).

The map is updated IN PLACE (JAX donated it); the returned state shares
its tensors with the input.
"""

from supereight_tpu_torch.kernels.frame import frame_mats
from supereight_tpu_torch.kernels.integrate import (as_timestamp,
                                                    integrate_blocks,
                                                    integrate_worklist)
from supereight_tpu_torch.kernels.node import node_pass


def integrate(geom, state, field, depth, pose, k, mu: float, timestamp,
              frame_size, budget: int = 8192, depth_interp: bool = False,
              with_stats: bool = False, when=None,
              noise_weighted: bool = False, mats=None):
    """One fusion pass: block update + node (mip) update
    (ref projective_functor::apply, projective_functor.hpp:139-156).

    ``pose`` is camera-to-world; ``k`` the f32[4] intrinsics;
    ``timestamp`` the f32[] tensor the OFusion update stamps into channel
    y (None for TSDF, which ignores it). ``when`` (bool[] tensor)
    masks all map writes. ``mats`` is the frame's pose prologue of
    ``pose`` and ``k`` (kernels/frame.frame_mats), run here when not
    given. ``depth_interp`` reads the block pass's depth bilinearly in
    inverse depth (no level rule and no fallback: patch_skipped is 0);
    ``noise_weighted`` weighs the TSDF block pass's samples by range
    (OFusion ignores it). With ``with_stats`` also returns
    {blocks_truncated, patch_skipped, mip_skipped} as i32[] tensors.
    """
    if mats is None:
        mats = frame_mats(k, pose)
    t_cw, kmat = mats.t_cw, mats.kmat
    budget = min(budget, geom.capacity)
    dev = depth.device
    timestamp = as_timestamp(field, timestamp, dev)

    # ---- block pass (K3) -----------------------------------------------
    wl, _, truncated = integrate_worklist(geom, state, t_cw, kmat,
                                          frame_size, budget, when)
    # with ``when`` False the worklist is empty: nothing is fused or skipped
    patch_skipped = integrate_blocks(geom, state, field, wl, depth, t_cw,
                                     kmat, mu, timestamp, noise_weighted,
                                     depth_interp)

    # ---- node (coarse mip) pass (K4: the parent rank, then the pass) ---
    mip_skipped = node_pass(geom, state, field, depth, t_cw, kmat, mu, budget,
                            timestamp, when)

    if not with_stats:
        return state
    return state, {"blocks_truncated": truncated,
                   "patch_skipped": patch_skipped,
                   "mip_skipped": mip_skipped}
