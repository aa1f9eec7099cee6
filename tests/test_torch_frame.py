"""The frame's pose prologue (``kernels/frame.py``): its plain twin against
the op sequences the stages ran before it, and against JAX.

``frame_mats_plain`` must equal, bit for bit, tracking's ``K @
inverse(raycast_pose)``, allocation's and the raycast's ``pose @ invK``,
integration's ``inverse(pose)`` and ``camera_matrix(k)``, the frame
step's pose select, gates and time stamp, all as ``core/se3.py`` ops. The
former ``se3.inverse`` summed R^T t with a library matmul, in an order
that is not fixed, so that one is held to 1e-6 m instead. Against JAX
(``jnp.matmul(pose, inverse_camera_matrix(k), HIGHEST)``, ``se3.inverse``,
``camera_matrix``, tracking's view and the gates of
``parallel/step.py``): matrices to rtol 1e-6 (atol 1e-6 where an entry is
near 0), gates and the time stamp exactly. Cases: frames 0-7
tracked and untracked, rates (1, 1) and (2, 3), and the ground-truth path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu.core import se3 as jax_se3
from supereight_tpu_torch.core import se3
from supereight_tpu_torch.kernels import _lib
from supereight_tpu_torch.kernels.frame import frame_mats, frame_mats_plain
from test_torch_step import K, make_scene

HIGHEST = jax.lax.Precision.HIGHEST
CASES = [(frame, tracked, rates) for frame in range(8)
         for tracked in (True, False) for rates in ((1, 1), (2, 3))]


def _poses(frame):
    """(tracker's pose, pose before the frame) of the orbit at ``frame``."""
    _, poses = make_scene(9)
    return (torch.from_numpy(poses[frame + 1].astype(np.float32)),
            torch.from_numpy(poses[frame].astype(np.float32)))


def _former(k, pose_t, old, tracked_t, frame, rates):
    """The op sequences the frame step and its stages ran before the
    prologue: the pose select and gates (parallel/step.py), tracking's
    view, allocation's and the raycast's pose @ invK, integration's
    inverse and camera matrix, and the time stamp."""
    frame = torch.full((), frame, dtype=torch.int32)
    do_track = (frame % rates[0]) == 0
    pose = torch.where(do_track, pose_t, old)
    tracked = do_track & tracked_t
    do_integrate = (tracked | (frame <= 3)) \
        & (((frame % rates[1]) == 0) | (frame <= 3))
    return dict(pose=pose, t_cw=se3.inverse(pose),
                kmat=se3.camera_matrix(k),
                kpose=se3.matmul4(pose, se3.inverse_camera_matrix(k)),
                view=se3.matmul4(se3.camera_matrix(k), se3.inverse(pose)),
                timestamp=(1.0 / 30.0) * frame.to(torch.float32),
                tracked=tracked, do_integrate=do_integrate,
                do_raycast=frame > 2)


@pytest.mark.parametrize("frame,tracked,rates", CASES)
def test_frame_mats_plain_equals_former_ops(frame, tracked, rates):
    torch.set_num_threads(1)
    k = torch.tensor(K, dtype=torch.float32)
    pose_t, old = _poses(frame)
    tracked_t = torch.tensor(tracked)
    got = frame_mats_plain(k, pose_t, old, tracked_t, frame, *rates)
    want = _former(k, pose_t, old, tracked_t, frame, rates)
    for name, value in want.items():
        assert torch.equal(getattr(got, name), value), name
    # the former inverse: R^T t by torch.matmul
    rt = got.pose[:3, :3].T
    former = -torch.matmul(rt, got.pose[:3, 3:])[:, 0]
    np.testing.assert_allclose(got.t_cw[:3, 3].numpy(), former.numpy(),
                               rtol=0, atol=1e-6)
    # a frame index given as a tensor takes the same path
    again = frame_mats_plain(k, pose_t, old, tracked_t,
                             torch.tensor(frame, dtype=torch.int32), *rates)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def _jax_gates(frame, tracked, rates):
    """The gates as JAX's parallel/step.py:frame_step computes them."""
    frame = jnp.int32(frame)
    do_track = (frame % rates[0]) == 0
    tracked = jnp.where(do_track, jnp.bool_(tracked), False)
    do_integrate = (tracked | (frame <= 3)) \
        & (((frame % rates[1]) == 0) | (frame <= 3))
    stamp = (1.0 / 30.0) * frame.astype(jnp.float32)
    return do_track, tracked, do_integrate, frame > 2, stamp


@pytest.mark.parametrize("frame,tracked,rates", CASES[::3])
def test_frame_mats_matches_jax(frame, tracked, rates):
    torch.set_num_threads(1)
    k = torch.tensor(K, dtype=torch.float32)
    kj = jnp.asarray(K, jnp.float32)
    pose_t, old = _poses(frame)
    got = frame_mats(k, pose_t, old, torch.tensor(tracked), frame, *rates)
    do_track, jtracked, jint, jray, jstamp = _jax_gates(frame, tracked, rates)
    pose = jnp.where(do_track, jnp.asarray(pose_t.numpy()),
                     jnp.asarray(old.numpy()))
    want = dict(
        pose=pose, t_cw=jax_se3.inverse(pose),
        kmat=jax_se3.camera_matrix(kj),
        kpose=jnp.matmul(pose, jax_se3.inverse_camera_matrix(kj),
                         precision=HIGHEST),
        view=jnp.matmul(jax_se3.camera_matrix(kj), jax_se3.inverse(pose),
                        precision=HIGHEST))
    for name, value in want.items():
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(value), rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    assert bool(got.tracked) == bool(jtracked)
    assert bool(got.do_integrate) == bool(jint)
    assert bool(got.do_raycast) == bool(jray)
    assert float(got.timestamp) == float(jstamp)


def test_ground_truth_path_takes_the_pose_as_tracked():
    """Without a tracker's verdict the given pose is the frame's pose and
    counts as tracked, whatever the tracking rate (JAX's use_gt_pose)."""
    k = torch.tensor(K, dtype=torch.float32)
    pose_t, old = _poses(5)
    before = dict(_lib.LAUNCHES)
    got = frame_mats(k, pose_t, old, None, 5, 2, 1)
    assert torch.equal(got.pose, pose_t) and bool(got.tracked)
    assert bool(got.do_integrate) and bool(got.do_raycast)
    assert _lib.LAUNCHES == before  # CPU tensors take the twin


def test_frame_mats_refuses_bad_rates_and_frames():
    k = torch.tensor(K, dtype=torch.float32)
    p = torch.eye(4)
    with pytest.raises(ValueError):
        frame_mats(k, p, tracking_rate=0)
    with pytest.raises(ValueError):
        frame_mats(k, p, frame=-1)
