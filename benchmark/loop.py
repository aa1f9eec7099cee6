"""The traffic's depth frames: the traj2-class closed loop, rendered on
the device.

A copy, in plain torch, of the port's synthetic loop
(``supereight_tpu_torch/io/synthetic.py``: ``default_loop_scene``,
``loop_frame``, ``look_at``, ``render_depth_scene`` and
``add_depth_noise``'s range model), so that set-up renders a whole loop
on the card in a few calls where numpy takes a third of a second a frame.
The seed moves the loop's starting point along its path
(:func:`loop_poses`' ``start``, an angle): every seed's camera travels the
same closed path through the same room, with the same motion, from
another point of it first. A traffic mix may leave objects out of the
room (``omit``) and give the sensor a minimum range (``min_depth``).
"""

import math

import numpy as np
import torch


# the room's objects by name, in loop_scene's order
SPHERES = ("sphere_large", "sphere_mid", "sphere_small")
BOXES = ("pillar", "table", "wall_box")


def loop_scene(dim=4.8, omit=()):
    """The traj2-class room (``synthetic.default_loop_scene``): a central
    pillar, a table slab, a wall-mounted box and three spheres inside the
    walls, less the objects named in ``omit`` (:data:`SPHERES`,
    :data:`BOXES`)."""
    unknown = set(omit) - set(SPHERES + BOXES)
    if unknown:
        raise ValueError(f"no object {sorted(unknown)} in the loop's room")
    c = dim / 2
    spheres = [((c - 0.9, c - 0.45, c + 0.7), 0.42),
               ((c + 1.05, c + 0.55, c - 0.65), 0.3),
               ((c + 0.55, c - 0.85, c - 1.05), 0.22)]
    boxes = [((c - 0.22, 0.55, c - 0.22), (c + 0.22, dim - 0.55, c + 0.22)),
             ((c - 1.5, c + 0.28, c - 1.15), (c - 0.45, c + 0.45, c - 0.45)),
             ((dim - 1.15, c - 0.5, c + 0.35),
              (dim - 0.62, c + 0.5, c + 1.15))]
    room = ((0.55, 0.55, 0.55), (dim - 0.55,) * 3)
    spheres = [s for s, name in zip(spheres, SPHERES) if name not in omit]
    boxes = [b for b, name in zip(boxes, BOXES) if name not in omit]
    return spheres, boxes, room


def look_at(eye, target, up=(0.0, 1.0, 0.0)):
    """Camera-to-world pose (f32 [4, 4]) with +z from ``eye`` to
    ``target``: x right, y down, z forward (``synthetic.look_at``)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    upv = -np.asarray(up, np.float64)
    right = np.cross(upv, fwd)
    if np.linalg.norm(right) < 1e-9:
        right = np.array([1.0, 0.0, 0.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = \
        right, down, fwd, eye
    return pose.astype(np.float32)


def loop_pose(i, n_frames, dim=4.8, radius=None, start=0.0):
    """Frame ``i``'s pose of the ``n_frames`` loop (``synthetic.loop_frame``
    at ``start`` 0): a quadratic ease-in over the first frames, then
    constant speed round one full circle at varying height, looking inward
    and ahead; the circle starts ``start`` radians further along the
    path."""
    c = dim / 2
    if radius is None:
        radius = 0.32 * dim
    ease = min(20, n_frames // 8)
    u = i / max(n_frames - 1, 1)
    ue = ease / max(n_frames - 1, 1)
    s = 0.5 * u * u / ue if (u < ue and ue > 0) else u - 0.5 * ue
    ang = 2.0 * np.pi * s / (1.0 - 0.5 * ue) + start
    eye = (c + radius * np.sin(ang), c + 0.12 * np.sin(2.0 * ang) - 0.2,
           c - radius * np.cos(ang))
    look = ang + 0.55
    target = (c + 0.25 * radius * np.sin(look), c - 0.1,
              c - 0.25 * radius * np.cos(look))
    return look_at(eye, target)


def loop_poses(n_loop, n_frames, dim=4.8, start=0.0):
    """The first ``n_loop`` poses (f32 [n_loop, 4, 4]) of the ``n_frames``
    loop that starts ``start`` radians along the path."""
    return np.stack([loop_pose(i, n_frames, dim, start=start)
                     for i in range(n_loop)])


def render_depths(poses, k, width, height, scene, max_depth=4.0,
                  device="cpu", chunk=16, min_depth=None):
    """Exact z-depth (f32 [N, H, W] metres, 0 where no hit, beyond
    ``max_depth`` or nearer than ``min_depth``) of ``scene``
    (:func:`loop_scene`) from each camera-to-world pose, in f64 as
    ``synthetic.render_depth_scene``: solid spheres, solid boxes hit from
    outside, the room's walls from inside."""
    f64 = dict(dtype=torch.float64, device=device)
    fx, fy, cx, cy = k
    xs = (torch.arange(width, **f64) - cx) / fx
    ys = (torch.arange(height, **f64) - cy) / fy
    dy, dx = torch.meshgrid(ys, xs, indexing="ij")
    rays_cam = torch.stack([dx, dy, torch.ones_like(dx)], -1)
    spheres, boxes, room = scene
    out = []
    poses = torch.as_tensor(np.asarray(poses, np.float32)).to(**f64)
    for p in poses.split(chunk):
        rot, org = p[:, :3, :3], p[:, :3, 3]
        rays = torch.einsum("hwj,nij->nhwi", rays_cam, rot)
        norm = torch.linalg.norm(rays, dim=-1)
        dirs = rays / norm[..., None]
        o = org[:, None, None, :]
        t_hit = torch.full(norm.shape, math.inf, **f64)
        for centre, r in spheres:
            oc = o - torch.tensor(centre, **f64)
            b = (dirs * oc).sum(-1)
            cc = (oc * oc).sum(-1) - r ** 2
            disc = b * b - cc
            th = -b - torch.sqrt(torch.clamp(disc, min=0.0))
            hit = (disc >= 0) & (th > 0)
            t_hit = torch.where(hit, torch.minimum(t_hit, th), t_hit)
        safe = torch.where(dirs.abs() < 1e-12,
                           torch.full_like(dirs, 1e-12), dirs)
        for bmin, bmax in boxes:
            t0 = (torch.tensor(bmin, **f64) - o) / safe
            t1 = (torch.tensor(bmax, **f64) - o) / safe
            tn = torch.minimum(t0, t1).amax(-1)
            tf = torch.maximum(t0, t1).amin(-1)
            hit = (tn < tf) & (tn > 0)
            t_hit = torch.where(hit, torch.minimum(t_hit, tn), t_hit)
        lo, hi = room
        for axis in range(3):
            for bound in (lo[axis], hi[axis]):
                tw = (bound - o[..., axis]) / safe[..., axis]
                pt = o + tw[..., None] * dirs
                inside = torch.ones_like(tw, dtype=torch.bool)
                for a in range(3):
                    if a != axis:
                        inside &= (pt[..., a] >= lo[a] - 1e-9) \
                            & (pt[..., a] <= hi[a] + 1e-9)
                hit = inside & (tw > 0)
                t_hit = torch.where(hit, torch.minimum(t_hit, tw), t_hit)
        z = torch.where(torch.isfinite(t_hit), t_hit / norm,
                        torch.zeros_like(t_hit))
        if max_depth is not None:
            z = torch.where(z > max_depth, torch.zeros_like(z), z)
        if min_depth is not None:
            z = torch.where(z < min_depth, torch.zeros_like(z), z)
        out.append(z.to(torch.float32))
    return torch.cat(out)


def add_noise(depth, factor, generator):
    """Range noise of ``synthetic.add_depth_noise``'s model, drawn from
    ``generator``: sigma = factor * z^2, then millimetre quantisation; 0
    stays 0."""
    sigma = factor * depth * depth
    noise = torch.randn(depth.shape, generator=generator,
                        device=depth.device, dtype=torch.float32)
    noisy = torch.round((depth + noise * sigma) * 1000.0) / 1000.0
    return torch.where(depth > 0, torch.clamp(noisy, min=0.0),
                       torch.zeros_like(depth))


def to_mm(depth):
    """f32 metres -> millimetres as the port's ``.raw`` writer rounds them
    (``io/convert.synthetic2raw``), held in i16: no depth passes 4 m, so
    the bits are the u16 a camera hands over (view the host copy as
    ``np.uint16``)."""
    return torch.round(depth * 1000.0).to(torch.int16)
