"""Keyframe manager: builds the windowed pose graph from the live pipeline.

Port of ``supereight_tpu/posegraph/keyframes.py`` (20-198). Records a
keyframe every ``keyframe_every`` tracked frames with the odometry
constraint between consecutive keyframes (weighted by the ICP inlier
count, entry 28 of the 32-float reduction), takes loop-closure edges, and
optimizes the window with ``posegraph.graph.optimize`` on ``device``
(the card unless the caller asks for another). The poses, edges and
bookkeeping stay host numpy, as JAX's. Each keyframe's raycast maps are
kept as clones on their own device (JAX copies them to the host and
uploads them again at every closure try): a window of 32 keyframes and
16 pinned anchors at 320x240 holds under 100 MB.
"""

import numpy as np
import torch

from supereight_tpu_torch.posegraph import graph as pg


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class KeyframeManager:
    def __init__(self, window: int = 32, keyframe_every: int = 10,
                 max_edges: int = 128, max_pinned: int = 16,
                 device="cuda"):
        self.device = torch.device(device)
        self.window = window
        self.keyframe_every = keyframe_every
        self.max_edges = max_edges
        self.max_pinned = max_pinned
        self.poses = []          # np [4, 4] a keyframe (optimized in place)
        self.orig_poses = []     # as tracked (never optimized): a
        #                          keyframe's correction for the final
        #                          trajectory is poses[i] @ inv(orig[i])
        self.frames = []         # frame index a keyframe
        self.edges = []          # (i, j, T_meas np[4, 4], weight)
        self.ref_maps = []       # optional (vertex, normal, valid) a kf
        self.pinned = []         # loop-closure anchors survive the trim
        self.frozen = []         # pinned and aged out of the live window:
        #                          held fixed (gauge) by optimize
        self.pre_opt_latest = None

    def maybe_add(self, frame: int, pose, reduction=None,
                  ref_maps=None) -> bool:
        """Call once per tracked frame; records a keyframe on schedule
        and reads nothing otherwise.

        ``pose`` and ``reduction`` (numpy or tensors) are read to the
        host on a keyframe. ``ref_maps``: optional (vertex, normal, valid)
        raycast maps at this keyframe, kept as clones so that later frames
        can re-localize against them for loop-closure edges.
        """
        if frame % self.keyframe_every != 0:
            return False
        pose = _host(pose).astype(np.float32)
        idx = len(self.poses)
        self.poses.append(pose)
        self.orig_poses.append(pose.copy())
        self.frames.append(frame)
        self.ref_maps.append(
            None if ref_maps is None
            else tuple(torch.as_tensor(m).clone() for m in ref_maps))
        self.pinned.append(False)
        self.frozen.append(False)
        if idx > 0:
            prev = self.poses[idx - 1]
            t_meas = np.linalg.inv(prev) @ pose
            weight = 1.0
            if reduction is not None:
                weight = max(float(_host(reduction)[28]), 1.0) ** 0.5
            self.edges.append((idx - 1, idx, t_meas.astype(np.float32),
                               weight))
        self._trim()
        return True

    def add_loop_closure(self, i: int, j: int, t_meas, weight: float = 1.0):
        """Add a non-consecutive constraint (from re-localization). The
        anchor keyframe ``i`` is PINNED: it survives the sliding window
        (``_trim``), so a closure to a keyframe far in the past is kept."""
        self.edges.append((i, j, np.asarray(t_meas, np.float32), weight))
        self.pinned[i] = True

    def _trim(self):
        """Slide the window: evict the oldest unpinned keyframes (and
        their edges). Pinned anchors survive; once older than every live
        unpinned keyframe they are FROZEN (held fixed by optimize). At most
        ``max_pinned`` anchors are kept (the oldest go first)."""
        n = len(self.poses)
        excess = n - self.window
        if excess <= 0:
            return
        pinned_excess = sum(self.pinned) - self.max_pinned
        evict = set()
        for idx in range(n):
            if len(evict) >= excess:
                break
            if not self.pinned[idx]:
                evict.add(idx)
            elif pinned_excess > 0:
                evict.add(idx)
                pinned_excess -= 1
        if not evict:
            return
        keep = [i for i in range(n) if i not in evict]
        remap = {old: new for new, old in enumerate(keep)}
        self.poses = [self.poses[i] for i in keep]
        self.orig_poses = [self.orig_poses[i] for i in keep]
        self.frames = [self.frames[i] for i in keep]
        self.ref_maps = [self.ref_maps[i] for i in keep]
        self.pinned = [self.pinned[i] for i in keep]
        self.frozen = [self.frozen[i] for i in keep]
        self.edges = [(remap[i], remap[j], t, w)
                      for (i, j, t, w) in self.edges
                      if i in remap and j in remap]
        # pinned keyframes older than the oldest live unpinned one are
        # outside the window: their odometry edges are gone, so their pose
        # is reference, not estimate
        first_live = next((x for x in range(len(self.poses))
                           if not self.pinned[x]), 0)
        for x in range(first_live):
            self.frozen[x] = True

    def nearest_revisit(self, pose, min_gap: int = 3,
                        max_dist: float = 0.5, min_dir_dot: float = 0.5):
        """Index of the spatially closest keyframe at least ``min_gap``
        keyframes back, within ``max_dist`` meters of ``pose`` and whose
        viewing direction agrees within acos(min_dir_dot), or None."""
        n = len(self.poses)
        if n <= min_gap:
            return None
        P = _host(pose).astype(np.float32)
        p, z = P[:3, 3], P[:3, 2]
        best, best_d = None, max_dist
        for idx in range(n - min_gap):
            d = float(np.linalg.norm(self.poses[idx][:3, 3] - p))
            if d < best_d and float(self.poses[idx][:3, 2] @ z) \
                    >= min_dir_dot:
                best, best_d = idx, d
        return best

    def optimize(self, iters: int = 10):
        """Optimize the current window on ``device``; returns the corrected
        poses [N, 4, 4] (numpy). The latest keyframe's pose before the
        solve is kept (``pre_opt_latest``) for
        :meth:`correction_for_latest`."""
        n = len(self.poses)
        if n < 2 or not self.edges:
            return np.asarray(self.poses)
        self.pre_opt_latest = np.asarray(self.poses[-1], np.float32)
        e = len(self.edges)
        cap = max(self.max_edges, e)
        i = np.zeros(cap, np.int32)
        j = np.zeros(cap, np.int32)
        t = np.tile(np.eye(4, dtype=np.float32), (cap, 1, 1))
        w = np.zeros(cap, np.float32)
        valid = np.zeros(cap, bool)
        for k, (ei, ej, et, ew) in enumerate(self.edges):
            i[k], j[k], t[k], w[k], valid[k] = ei, ej, et, ew, True

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        g = pg.PoseGraph(i=dev(i), j=dev(j), t_meas=dev(t), weight=dev(w),
                         valid=dev(valid))
        out = pg.optimize(dev(np.stack(self.poses)), g, num_nodes=n,
                          iters=iters,
                          fixed=dev(np.asarray(self.frozen, bool)))
        out = _host(out)
        self.poses = [p for p in out]
        return out

    def correction_for_latest(self):
        """World-frame transform from the latest keyframe's pose before the
        last optimization to its optimized pose (apply as ``pose_live <- C
        @ pose_live`` to re-anchor tracking); identity before any."""
        if self.pre_opt_latest is None:
            return np.eye(4, dtype=np.float32)
        return (np.asarray(self.poses[-1], np.float32)
                @ np.linalg.inv(self.pre_opt_latest)).astype(np.float32)

    def frame_corrections(self):
        """(frame index, correction [4, 4]) a surviving keyframe: the rigid
        transform BA applied to it (optimized @ inv(as tracked)). For the
        final trajectory, each frame takes its nearest keyframe's
        correction."""
        return [(f, (np.asarray(opt) @ np.linalg.inv(np.asarray(orig)))
                 .astype(np.float32))
                for f, opt, orig in zip(self.frames, self.poses,
                                        self.orig_poses)]
