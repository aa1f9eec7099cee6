"""Dataset readers: a copy of ``supereight_tpu/io/dataset.py`` (numpy).

Behavioral reference: se_apps/include/interface.h —
RawDepthReader (SLAMBench 1.0 .raw, interface.h:286-500),
SceneDepthReader (ICL-NUIM .depth directories, interface.h:179-285) and
the TUM-format ground-truth pose parsing (readNextPose,
interface.h:118-154).

The .raw frame layout is
  [u32 w][u32 h][u16 depth * w*h][u32 w][u32 h][u8 rgb * 3*w*h]
read here via a single numpy memmap (random access like the reference's
fseeko-based reader).
"""

import os
from typing import Optional, Tuple

import numpy as np


class RawDepthReader:
    """SLAMBench 1.0 .raw sequence reader (ref interface.h:286-500)."""

    def __init__(self, path: str, groundtruth_path: str = "",
                 transform: Optional[np.ndarray] = None):
        self.path = path
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        w, h = np.frombuffer(self._mm[:8].tobytes(), dtype=np.uint32)
        self.width, self.height = int(w), int(h)
        npix = self.width * self.height
        self.frame_bytes = 16 + 2 * npix + 3 * npix
        self.num_frames = len(self._mm) // self.frame_bytes
        self.frame = -1
        self.poses = None
        if groundtruth_path:
            self.poses = load_groundtruth_poses(groundtruth_path, transform)

    def get_k(self) -> Tuple[float, float, float, float]:
        """Reference fallback: ICL-NUIM-style intrinsics scaled to size."""
        return (481.2 * self.width / 640.0, -480.0 * self.height / 480.0,
                self.width / 2.0, self.height / 2.0)

    def read_frame(self, index: int):
        """Depth (u16 [H, W]) + RGB (u8 [H, W, 3]) of frame ``index``."""
        if index < 0 or index >= self.num_frames:
            return None, None
        off = index * self.frame_bytes
        npix = self.width * self.height
        buf = self._mm[off:off + self.frame_bytes]
        depth = np.frombuffer(buf[8:8 + 2 * npix].tobytes(),
                              dtype=np.uint16).reshape(self.height,
                                                       self.width)
        rgb_off = 8 + 2 * npix + 8
        rgb = np.frombuffer(buf[rgb_off:rgb_off + 3 * npix].tobytes(),
                            dtype=np.uint8).reshape(self.height, self.width,
                                                    3)
        return depth, rgb

    def read_next(self):
        self.frame += 1
        d, rgb = self.read_frame(self.frame)
        pose = None
        if d is not None and self.poses is not None \
                and self.frame < len(self.poses):
            pose = self.poses[self.frame]
        return d, rgb, pose

    def restart(self):
        self.frame = -1


class SceneDepthReader:
    """ICL-NUIM 'scene' directory of .depth text files
    (ref interface.h:179-285; per-pixel values are *ray lengths* that the
    reference converts to z-depth with the hardcoded 640x480 intrinsics,
    scene2raw.cpp:96-123)."""

    K = (481.2, -480.0, 319.5, 239.5)
    WIDTH, HEIGHT = 640, 480

    def __init__(self, directory: str):
        self.directory = directory
        self.frame = -1

    def get_k(self):
        return self.K

    def _path(self, index):
        return os.path.join(self.directory, f"scene_00_{index:04d}.depth")

    def read_frame(self, index: int):
        path = self._path(index)
        if not os.path.exists(path):
            return None
        vals = np.loadtxt(path, dtype=np.float64).reshape(self.HEIGHT,
                                                          self.WIDTH)
        return ray_length_to_z_depth(vals, self.K).astype(np.float32)

    def read_next(self):
        self.frame += 1
        return self.read_frame(self.frame)


def ray_length_to_z_depth(rays, k):
    """ICL-NUIM .depth stores Euclidean ray length; convert to z-depth
    (ref scene2raw.cpp:96-123)."""
    h, w = rays.shape
    fx, fy, cx, cy = k
    us = (np.arange(w) - cx) / fx
    vs = (np.arange(h) - cy) / fy
    u, v = np.meshgrid(us, vs, indexing="xy")
    return rays / np.sqrt(u * u + v * v + 1.0)


def load_groundtruth_poses(path: str,
                           transform: Optional[np.ndarray] = None):
    """TUM-format trajectory -> list of 4x4 camera-to-world matrices
    (ref readNextPose, interface.h:118-154: last 7 columns are
    tx ty tz qx qy qz qw; optional pre-transform)."""
    poses = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            cols = line.replace(",", " ").split()
            if len(cols) < 7:
                continue
            tx, ty, tz = (float(c) for c in cols[-7:-4])
            qx, qy, qz, qw = (float(c) for c in cols[-4:])
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = _quat_to_rot(qx, qy, qz, qw)
            T[:3, 3] = (tx, ty, tz)
            if transform is not None:
                T = np.asarray(transform, np.float32) @ T
            poses.append(T)
    return poses


def _quat_to_rot(x, y, z, w):
    n = x * x + y * y + z * z + w * w
    s = 0.0 if n == 0 else 2.0 / n
    return np.array([
        [1 - s * (y * y + z * z), s * (x * y - w * z), s * (x * z + w * y)],
        [s * (x * y + w * z), 1 - s * (x * x + z * z), s * (y * z - w * x)],
        [s * (x * z - w * y), s * (y * z + w * x), 1 - s * (x * x + y * y)],
    ], np.float32)


def first_pose_transform(first_gt_pose: np.ndarray, init_position):
    """Transform aligning the first ground-truth position with the
    configured initial camera position (what the reference apps pass as
    ReaderConfiguration.transform so trajectories start inside the
    volume)."""
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = np.asarray(init_position) - first_gt_pose[:3, 3]
    return T


def write_raw(path: str, depths_mm, rgbs=None):
    """Write a SLAMBench .raw file (the scene2raw/oni2raw output format,
    ref se_tools/scene2raw.cpp:76-187)."""
    n, h, w = np.asarray(depths_mm).shape
    hdr = np.array([w, h], dtype=np.uint32).tobytes()
    with open(path, "wb") as f:
        for i in range(n):
            d = np.asarray(depths_mm[i], dtype=np.uint16)
            f.write(hdr)
            f.write(d.tobytes())
            f.write(hdr)
            if rgbs is None:
                f.write(np.zeros((h, w, 3), np.uint8).tobytes())
            else:
                f.write(np.asarray(rgbs[i], np.uint8).tobytes())
