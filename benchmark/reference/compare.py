"""The numbers that decide ``correct``: the program's frame against the
reference's, from the same state and the same input.

Each number is a share or a gap that a sound run keeps small and a
lower precision (the control) does not; the limits, and the readings
they were set from, are in ``PERF.md`` and the traffic's file.
"""

import numpy as np
import torch

# a payload value (sdf, weight, log-odds, time stamp) is off where it
# differs from the reference's by more than TOL_ABS + TOL_REL |reference|
TOL_ABS, TOL_REL = 1e-4, 1e-4
# a raycast pixel is off where its hit differs, or where its vertex (m) or
# its normal differs by more than this in any coordinate
RAY_TOL = 1e-3


def pose_gap(prog_pose, prog_tracked, ref_pose, ref_tracked) -> float:
    """The largest entry of |P_program - P_reference| of the [4, 4]
    camera-to-world poses (rotation unitless, translation in metres); 1
    where one side tracked and the other did not."""
    if bool(prog_tracked) != bool(ref_tracked):
        return 1.0
    a = torch.as_tensor(np.asarray(prog_pose, np.float32))
    b = torch.as_tensor(np.asarray(ref_pose.detach().cpu(), np.float32))
    return float((a - b).abs().max())


def _off(a, b):
    return ((a - b).abs() > TOL_ABS + TOL_REL * b.abs()) | \
        (torch.isnan(a) != torch.isnan(b))


def map_off_pct(before, prog, ref) -> float:
    """Of the map values that the frame changed on either side, the share
    (%) that the program and the reference do not agree on: the pool
    voxels' two channels, over the slots either side allocated, and the
    mip levels' two values; a block at another coordinate, a slot grid
    cell or a mip allocation flag that differs counts as off too (all of
    a block's voxels for a block)."""
    n = max(int(before.n_blocks), int(prog.n_blocks), int(ref.n_blocks))
    changed = off = 0
    pairs = [(before.data_x[:n], prog.data_x[:n], ref.data_x[:n]),
             (before.data_y[:n], prog.data_y[:n], ref.data_y[:n])]
    pairs += list(zip(before.mip_x, prog.mip_x, ref.mip_x))
    pairs += list(zip(before.mip_y, prog.mip_y, ref.mip_y))
    for b0, p, r in pairs:
        changed += int(((p != b0) | (r != b0)).sum())
        off += int(_off(p, r).sum())
    coord = (prog.block_coord[:n] != ref.block_coord[:n]).any(1)
    voxels = before.data_x.shape[1]
    flags = [(prog.slot != ref.slot)] + \
        [(p != r) for p, r in zip(prog.mip_alloc, ref.mip_alloc)]
    bad_flags = sum(int(f.sum()) for f in flags) \
        + int(prog.n_blocks != ref.n_blocks)
    off += int(coord.sum()) * voxels + bad_flags
    changed += int(coord.sum()) * voxels + bad_flags
    return 100.0 * off / max(changed, 1)


def ray_off_pct(prog, ref) -> float:
    """The share (%) of raycast pixels whose hit differs, or whose vertex
    or normal differs by more than :data:`RAY_TOL` in a coordinate.
    ``prog`` and ``ref`` are (vertex, normal, valid)."""
    pv, pn, pok = (torch.as_tensor(t) for t in prog)
    rv, rn, rok = (torch.as_tensor(t).cpu() for t in ref)
    both = pok & rok
    far = ((pv - rv).abs().amax(-1) > RAY_TOL) | \
        ((pn - rn).abs().amax(-1) > RAY_TOL)
    return 100.0 * float(((pok != rok) | (both & far)).float().mean())


def render_off_pct(prog, ref) -> float:
    """The share (%) of the composite's pixels (u8 [2H, 2W, 4]) in which
    any byte differs."""
    a = torch.as_tensor(np.asarray(prog))
    b = torch.as_tensor(ref).cpu()
    return 100.0 * float((a != b).any(-1).float().mean())


def ate_rmse(poses, gt) -> float:
    """Root mean square of the translation error (m) of the [N, 4, 4]
    poses against the ground truth, unaligned: the map's frame is the
    ground truth's."""
    d = np.asarray(poses)[:, :3, 3] - np.asarray(gt)[:, :3, 3]
    return float(np.sqrt((d * d).sum(1).mean()))
