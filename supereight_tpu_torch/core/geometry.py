"""Geometric queries over the map: AABB tests and occupancy collision, on
torch tensors.

Port of ``supereight_tpu/core/geometry.py`` (22-91; behavioral reference:
se_core/include/se/geometry/aabb_collision.hpp and
octree_collision.hpp:37-171). The reference classifies a box by an octree
walk; with the dense pool the same classification is a scan over the
voxels the box covers, each read through ``get_with_coarse``, so that an
unallocated voxel takes the finest existing coarse value, as the
reference's "unallocated child -> parent value" rule does. The AABB
helpers put inputs that are not tensors on ``device``, the card unless
the caller asks for the CPU.
"""

import enum

import torch

from supereight_tpu_torch.core import map as m


class CollisionStatus(enum.IntEnum):
    """Ref collision_status, octree_collision.hpp:37-41."""
    OCCUPIED = 2
    UNSEEN = 1
    EMPTY = 0


def _tensors(xs, device, dtype=None):
    """Each of ``xs`` as a tensor (of ``dtype``, if given) on the device of
    the first tensor among them, else on ``device``."""
    dev = next((x.device for x in xs if isinstance(x, torch.Tensor)),
               torch.device(device))
    return [torch.as_tensor(x, dtype=dtype, device=dev) for x in xs]


def axis_overlap(a_center, a_half, b_center, b_half, device="cuda"):
    """Separating-axis overlap of two 1D intervals (ref
    aabb_collision.hpp:36-50)."""
    a_center, a_half, b_center, b_half = _tensors(
        (a_center, a_half, b_center, b_half), device)
    return (b_center - a_center).abs() <= (a_half + b_half)


def aabb_aabb_collision(a_min, a_max, b_min, b_max, device="cuda"):
    """Box-box overlap test (ref aabb_collision.hpp:59-65)."""
    a_min, a_max, b_min, b_max = _tensors((a_min, a_max, b_min, b_max),
                                          device, torch.float32)
    ac, ah = (a_min + a_max) / 2, (a_max - a_min) / 2
    bc, bh = (b_min + b_max) / 2, (b_max - b_min) / 2
    return axis_overlap(ac, ah, bc, bh).all(-1)


def aabb_aabb_inclusion(a_min, a_max, b_min, b_max, device="cuda"):
    """True if box b lies inside box a (ref aabb_collision.hpp:67-73)."""
    a_min, a_max, b_min, b_max = _tensors((a_min, a_max, b_min, b_max),
                                          device)
    return ((b_min >= a_min) & (b_max <= a_max)).all(-1)


def _status_from_value(x, y, occupied_pred):
    """Per-sample classification: unobserved (weight or time stamp 0) is
    UNSEEN, else occupied_pred(x) decides OCCUPIED or EMPTY."""
    return torch.where(y == 0, int(CollisionStatus.UNSEEN),
                       torch.where(occupied_pred(x),
                                   int(CollisionStatus.OCCUPIED),
                                   int(CollisionStatus.EMPTY))
                       ).to(torch.int32)


def collides_with(geom, state, field, bbox_min_vox, bbox_max_vox,
                  occupied_pred=None):
    """Classify the voxel box [min, max) against the map (ref
    collides_with, octree_collision.hpp:110-171): any OCCUPIED sample
    dominates; failing that, any UNSEEN; else EMPTY (the state machine of
    49-65). The default predicate is x < 0 for TSDF and x > 0 for
    OFusion. Returns an i32[] tensor on the map's device."""
    if occupied_pred is None:
        def occupied_pred(x):
            return x < 0.0 if field.name == "tsdf" else x > 0.0
    dev = state.slot.device
    lo = [int(c) for c in bbox_min_vox]
    hi = [int(c) for c in bbox_max_vox]
    axes = [torch.arange(a, b, dtype=torch.int32, device=dev)
            for a, b in zip(lo, hi)]
    v = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)
    x, y = m.get_with_coarse(geom, state, field, v)
    status = _status_from_value(x, y, occupied_pred)
    any_occupied = (status == CollisionStatus.OCCUPIED).any()
    any_unseen = (status == CollisionStatus.UNSEEN).any()
    return torch.where(any_occupied, int(CollisionStatus.OCCUPIED),
                       torch.where(any_unseen, int(CollisionStatus.UNSEEN),
                                   int(CollisionStatus.EMPTY))
                       ).to(torch.int32)
