"""The frame's pose prologue: wrapper and twin.

Every small matrix, gate and scalar the stages of the fused frame step
build from a pose and the intrinsics ``k``: the pose select and rate gates
of ``supereight_tpu/parallel/step.py:frame_step`` (105-128), its time
stamp (151), raycast view (162) and raycast gate (194), tracking's view
(``ops/tracking.py:262``), allocation's ``pose @ invK``
(``ops/allocation.py:42``) and integration's ``inverse`` and
``camera_matrix`` (``ops/integration.py:310-311``). The CUDA kernel is
``csrc/frame.cu`` (one warp, one launch); :func:`frame_mats_plain` is the
``core/se3.py`` op sequence the stages ran before, used for CPU tensors
and as the kernel's reference on the card, which it equals bit for bit.
"""

from typing import NamedTuple

import torch

from benchmark.reference.frozen.core import se3

_N_MATS = 81  # five 4x4 matrices and the time stamp (csrc/frame.cu)


class FrameMats(NamedTuple):
    pose: torch.Tensor          # f32[4, 4] the frame's camera-to-world pose
    t_cw: torch.Tensor          # f32[4, 4] world-to-camera, inverse(pose)
    kmat: torch.Tensor          # f32[4, 4] camera_matrix(k)
    kpose: torch.Tensor         # f32[4, 4] pose @ inverse_camera_matrix(k)
    view: torch.Tensor          # f32[4, 4] kmat @ t_cw
    timestamp: torch.Tensor     # f32[] (1/30) * frame, OFusion's stamp
    tracked: torch.Tensor       # bool[]
    do_integrate: torch.Tensor  # bool[] the rate gate of the map writes
    do_raycast: torch.Tensor    # bool[] frame > 2


def frame_mats_buffers(device="cuda"):
    """Empty output buffers of :func:`frame_mats` (its ``out``): the
    f32[81] matrices and time stamp, the bool[3] gates."""
    return (torch.empty(_N_MATS, dtype=torch.float32, device=device),
            torch.empty(3, dtype=torch.bool, device=device))


def frame_mats_views(out):
    """The :class:`FrameMats` as views of the buffers ``out``
    (:func:`frame_mats_buffers`)."""
    mats, gates = out
    m = [mats[16 * i:16 * i + 16].view(4, 4) for i in range(5)]
    return FrameMats(*m, mats[80], gates[0], gates[1], gates[2])


def frame_mats_plain(k, pose_t, old_pose=None, tracked_t=None, frame=0,
                     tracking_rate: int = 1, integration_rate: int = 1):
    """Plain PyTorch twin of :func:`frame_mats`: the ``core/se3.py`` ops
    and the gates as the frame step wrote them."""
    dev = k.device
    if not isinstance(frame, torch.Tensor):
        frame = torch.full((), int(frame), dtype=torch.int32, device=dev)
    if tracked_t is None:
        pose = pose_t
        tracked = torch.ones((), dtype=torch.bool, device=dev)
    else:
        do_track = (frame % tracking_rate) == 0
        old = pose_t if old_pose is None else old_pose
        pose = torch.where(do_track, pose_t, old)
        tracked = do_track & tracked_t
    do_integrate = (tracked | (frame <= 3)) \
        & (((frame % integration_rate) == 0) | (frame <= 3))
    t_cw = se3.inverse(pose)
    kmat = se3.camera_matrix(k)
    return FrameMats(
        pose=pose, t_cw=t_cw, kmat=kmat,
        kpose=se3.matmul4(pose, se3.inverse_camera_matrix(k)),
        view=se3.matmul4(kmat, t_cw),
        # f32 like JAX's (1/30) * frame
        timestamp=(1.0 / 30.0) * frame.to(torch.float32),
        tracked=tracked, do_integrate=do_integrate, do_raycast=frame > 2)
