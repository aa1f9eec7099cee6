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

from supereight_tpu_torch.core import se3
from supereight_tpu_torch.kernels import _lib

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


def frame_mats(k, pose_t, old_pose=None, tracked_t=None, frame=0,
               tracking_rate: int = 1, integration_rate: int = 1,
               out=None):
    """The :class:`FrameMats` of a frame (ref DenseSLAMSystem.cpp:206-212
    for the gates).

    ``k`` f32[4] intrinsics; ``pose_t`` f32[4, 4] the tracker's pose (or
    any pose whose matrices are wanted); ``old_pose`` the pose before the
    frame (None: ``pose_t``); ``tracked_t`` the tracker's bool[] verdict,
    None where ``pose_t`` is taken as it is and counts as tracked (the
    ground-truth path); ``frame`` a Python int >= 0 or an i32[] tensor on
    ``k``'s device. The pose is ``pose_t`` on frames that the tracking rate
    tracks, else ``old_pose``. One launch on a CUDA device, no host sync.
    With ``out`` (:func:`frame_mats_buffers`) the results are written
    there and returned as its views (:func:`frame_mats_views`).
    """
    dev = k.device
    if tracking_rate < 1 or integration_rate < 1:
        raise ValueError("frame_mats: the rates must be >= 1")
    if not isinstance(frame, torch.Tensor) and int(frame) < 0:
        raise ValueError("frame_mats: frame must be >= 0")
    if dev.type == "cpu":
        mats = frame_mats_plain(k, pose_t, old_pose, tracked_t, frame,
                                tracking_rate, integration_rate)
        if out is None:
            return mats
        views = frame_mats_views(out)
        for a, b in zip(views, mats):
            a.copy_(b)
        return views
    if dev.type != "cuda":
        raise ValueError(f"frame_mats: unsupported device {dev}")
    c = _lib.check
    c(k, "k", torch.float32, (4,), dev)
    c(pose_t, "pose_t", torch.float32, (4, 4), dev)
    if old_pose is not None:
        c(old_pose, "old_pose", torch.float32, (4, 4), dev)
    if tracked_t is not None:
        tracked_t = c(tracked_t.reshape(()), "tracked_t", torch.bool, (), dev)
    frame_t, frame_val = None, 0
    if isinstance(frame, torch.Tensor):
        frame_t = c(frame.reshape(()), "frame", torch.int32, (), dev)
    else:
        frame_val = int(frame)
    if out is None:
        out = frame_mats_buffers(dev)
    mats = c(out[0], "out", torch.float32, (_N_MATS,), dev)
    gates = c(out[1], "out", torch.bool, (3,), dev)
    _lib.launch("frame_mats", "se_frame_mats", dev, k, pose_t, old_pose,
                tracked_t, frame_t, frame_val, int(tracking_rate),
                int(integration_rate), mats, gates)
    return frame_mats_views((mats, gates))


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
