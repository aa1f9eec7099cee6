"""The torch loop generator against the port's numpy one."""

import numpy as np
import pytest
import torch

from benchmark import loop
from supereight_tpu_torch.io import synthetic

K = (481.2 / 8, 480.0 / 8, 320.0 / 8, 240.0 / 8)


@pytest.mark.parametrize("i", [0, 5, 19, 20, 100, 248])
def test_frame_equals_loop_frame(i):
    depth, pose = synthetic.loop_frame(i, 250, K, width=80, height=60)
    mine = loop.loop_poses(i + 1, 250)[i]
    np.testing.assert_array_equal(mine, pose)
    got = loop.render_depths(mine[None], K, 80, 60, loop.loop_scene())[0]
    np.testing.assert_array_equal(got.numpy(), depth)


def test_start_moves_along_the_same_path():
    # frame 0 of a loop started at frame 100's angle is frame 100's pose
    n = 250
    ue = 20 / (n - 1)
    u = 100 / (n - 1)
    ang = 2.0 * np.pi * (u - 0.5 * ue) / (1.0 - 0.5 * ue)
    moved = loop.loop_poses(1, n, start=ang)[0]
    np.testing.assert_allclose(moved, loop.loop_pose(100, n), atol=1e-6)
    # and the path closes: frame n - 1 is frame 0 again
    np.testing.assert_allclose(loop.loop_pose(n - 1, n, start=ang),
                               moved, atol=1e-5)


def test_noise_and_millimetres():
    depth = torch.tensor([[0.0, 1.0, 2.0, 3.9996]])
    gen = torch.Generator().manual_seed(3)
    noisy = loop.add_noise(depth, 0.002, gen)
    assert noisy[0, 0] == 0
    assert torch.all((noisy[0, 1:] - depth[0, 1:]).abs() < 0.1)
    mm = loop.to_mm(depth).numpy().view(np.uint16)
    assert mm.tolist() == [[0, 1000, 2000, 4000]]


def test_omit_and_min_depth():
    pose = loop.loop_poses(85, 250)[84]  # inside the wall box
    full = loop.render_depths(pose[None], K, 80, 60, loop.loop_scene())[0]
    spheres, boxes, room = loop.loop_scene(omit=("wall_box",))
    assert len(spheres) == 3 and len(boxes) == 2
    assert boxes == loop.loop_scene()[1][:2]
    near = loop.render_depths(pose[None], K, 80, 60, (spheres, boxes, room),
                              min_depth=0.4)[0]
    assert torch.all((near == 0) | (near >= 0.4))
    kept = (full >= 0.4) & (near > 0)
    assert kept.any()
    assert torch.equal(near[kept], full[kept])
    with pytest.raises(ValueError):
        loop.loop_scene(omit=("sofa",))
