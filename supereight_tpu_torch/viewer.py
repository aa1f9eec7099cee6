"""Headless viewer: composite 2x2 frame snapshots (a copy of
``supereight_tpu/viewer.py``, numpy).

Behavioral reference: the GLUT/Qt front-ends' draw loop (drawthem,
se_apps/include/draw.h:51-112; QtGUI.cpp), which blits RGB / depth /
tracking-status / volume renders side by side. Without a display server
this writes the same composite as an image file per frame.
"""

import numpy as np


def composite_views(depth_rgba, track_rgba, volume_rgba, rgb=None):
    """Assemble the 2x2 view grid (ref draw.h:51-112 layout)."""
    h, w = depth_rgba.shape[:2]
    if rgb is None:
        rgb = np.zeros((h, w, 4), np.uint8)
    elif rgb.shape[-1] == 3:
        rgb = np.concatenate([rgb, np.zeros((h, w, 1), np.uint8)], -1)
    top = np.concatenate([rgb, depth_rgba], axis=1)
    bottom = np.concatenate([track_rgba, volume_rgba], axis=1)
    return np.concatenate([top, bottom], axis=0)


def write_ppm(path, rgba):
    """Dependency-free image dump (P6 PPM)."""
    rgb = np.asarray(rgba)[..., :3]
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(rgb).tobytes())


def snapshot(pipe, path, rgb=None):
    """Render the current pipeline state into a composite image file:
    the class's composite (one launch and one read), ``rgb`` (u8[H, W, 3
    or 4]) placed in its top-left quadrant on the host."""
    comp = pipe.render_views()[0]
    if rgb is not None:
        h, w = comp.shape[0] // 2, comp.shape[1] // 2
        comp[:h, :w, :rgb.shape[-1]] = rgb
    write_ppm(path, comp)
    return comp
