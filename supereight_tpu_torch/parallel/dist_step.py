"""Morton-sharded frame step over ``torch.distributed``: one rank a process,
each with its own share of the map, and an explicit halo exchange.

Port of ``supereight_tpu/parallel/dist_step.py`` (its docstring gives the
design). JAX ran one ``shard_map`` program over a device mesh; here every
rank runs :class:`DistStep` on its own :class:`DistState` and the ranks
meet in collectives (``parallel/distributed.Collectives``). A frame, per
rank (D ranks, rank r, columns [r w/D, (r + 1) w/D) of every image):

* **Reference maps.** The last raycast's vertex, normal and valid column
  slices are packed and all-gathered into the full reference ICP reads.
  Every rank is given the full depth frame.
* **Preprocess** (K7) runs whole on every rank, as JAX's replicated one.
* **Tracking**: K6's ``icp_reduce`` over the rank's columns of each level,
  one ``all_reduce`` of the f64 sums, K6's ``icp_update``, at the full
  trip counts (``ops/tracking.track`` with the group). The pose prologue
  (``kernels/frame.py``) then selects the pose and the gates, as on one
  device.
* **Allocation**: K5's march over the rank's own columns (image
  coordinates kept: JAX's ``x_offset``) into the map's touched buffer, one
  ``all_reduce(MAX)`` over the whole buffer (levels 0-2 back to back: the
  union of the ranks' grids), then K5's ``alloc_assign`` with the owner
  mask: a rank allocates only the cells it owns (:func:`owner_grid`:
  64-cell tiles of the morton curve dealt round-robin; the kernel computes
  a cell's owner from its 4^3 super-brick, ``kernels/alloc.Owners``).
  OFusion's coarse levels are unioned and gated, not masked by owner.
* **mip existence**: one ``all_reduce(MAX)`` of the ranks' ``mip_alloc``
  levels (one buffer, :func:`init_dist_state`) after each rank's
  incremental refresh. It equals JAX's dense refresh over the global
  occupancy while ``mip_alloc >= broadcast(R(slot >= 0))`` holds (see
  ``kernels/alloc.alloc_assign_plain``). The mip VALUES stay each rank's:
  its K4 pass updates the parents of its own blocks, as JAX's per-device
  copies do.
* **Integration** (K3, K4) is local: the rank's own blocks from the full
  depth.
* **Halo** (frames > 2; ``frame`` is a host int, so every rank takes the
  same branch): ``halo_pack`` compacts the rank's allocated blocks (with
  ``frustum_halo``, those near the view) into a fixed ``halo_budget``
  send buffer of both channels and the cell ids; one ``all_gather`` gives
  every rank the table. Its slot grid is a scatter of the gathered cells
  (padding goes to the drop cell b^3), its pool the gathered bricks read
  in place, its mips this rank's (JAX's ``lmap._replace(slot=gslot)``).
  K2 builds its nav grid unchanged.
* **Raycast**: K1 over the halo for the rank's own columns, primed from
  the full depth at those columns.
* **Counters**: one int32 ``all_reduce`` a frame carries alloc_overflow,
  blocks_truncated, ray_overflow, halo_overflow, halo_blocks and every
  rank's block count.

That is 1 + (ICP iterations) + 4 collectives a frame (3 on frames 0-2).
JAX's strip tables, their sentinel encoding and bf16 strips above 16,384
bricks are TPU shaping and are not ported: K1 reads f32 from both
channels, as on one device. A frame width that the world size does not
divide at every pyramid level, or whose rank slice is not a multiple of
the allocation march's pixel strides, is refused: JAX would drop columns
or shift the march's sample phase there (``dist_step.py:295-297``).
"""

import dataclasses
from typing import NamedTuple

import torch

from supereight_tpu_torch.core.map import MapState, make_map
from supereight_tpu_torch.kernels.alloc import (_OF_STRIDES, _STRIDE,
                                                OWNER_TILE, Owners,
                                                alloc_assign, owner_cells,
                                                touched_mask,
                                                touched_masks_of)
from supereight_tpu_torch.kernels.frame import frame_mats
from supereight_tpu_torch.kernels.halo import halo_pack, halo_rows
from supereight_tpu_torch.kernels.nav import nav_grid
from supereight_tpu_torch.kernels.raycast import raycast_rays
from supereight_tpu_torch.ops import integration, tracking
from supereight_tpu_torch.parallel.distributed import Collectives
from supereight_tpu_torch.pipeline import preprocess_and_pyramid

TILE = OWNER_TILE  # consecutive morton cells a rank owns together (4^3)
# the aux counters carried by the frame's one int32 all_reduce, in order
COUNTERS = ("alloc_overflow", "blocks_truncated", "ray_overflow",
            "halo_overflow", "halo_blocks")


class DistState(NamedTuple):
    """One rank's frame state: its local map (capacity = global / D), the
    replicated pose and raycast pose, and its column slice [H, W/D] of the
    last raycast's maps."""
    map: MapState
    pose: torch.Tensor
    raycast_pose: torch.Tensor
    vertex: torch.Tensor
    normal: torch.Tensor
    valid: torch.Tensor


def owner_grid(geom, n_shards: int, tile: int = TILE, device="cuda"):
    """i32[B, B, B]: the rank that owns each block cell. Block-cyclic over
    the morton curve: ``tile`` consecutive morton cells (64 = a 4x4x4
    super-brick) go to one rank, tiles round-robin over the ranks (JAX
    ``owner_grid``, ``dist_step.py:82-99``), which is the morton code of
    the cell's super-brick mod ``n_shards``:
    :func:`~supereight_tpu_torch.kernels.alloc.owner_cells`, which takes
    only the tile of 64. The step passes ``alloc_assign`` its
    :class:`~supereight_tpu_torch.kernels.alloc.Owners` instead, whose
    kernel computes the same owners from the cells."""
    return owner_cells(geom.blocks_per_side, Owners(n_shards, tile), device)


def _world(group):
    return group.world if isinstance(group, Collectives) \
        else torch.distributed.get_world_size(group)


def mip_buffer(m: MapState) -> torch.Tensor:
    """The one bool buffer that holds every ``mip_alloc`` level of a map
    made by :func:`init_dist_state`, back to back (checked)."""
    first = m.mip_alloc[0]
    total = sum(a.numel() for a in m.mip_alloc)
    buf = first.as_strided((total,), (1,), first.storage_offset())
    offset = first.storage_offset()
    for a in m.mip_alloc:
        if a.untyped_storage().data_ptr() != \
                first.untyped_storage().data_ptr() \
                or a.storage_offset() != offset or not a.is_contiguous():
            raise ValueError("mip_alloc: the sharded step needs the levels "
                             "of one buffer (init_dist_state)")
        offset += a.numel()
    return buf


def init_dist_state(group, geom_local, field, frame_size, init_pose,
                    device="cuda") -> DistState:
    """This rank's empty state on ``device`` (the card unless the caller
    asks for another). ``geom_local`` is the rank's geometry (capacity =
    global capacity / D); ``group`` the process group (None: the default
    one) or its :class:`Collectives`. The map's ``mip_alloc`` levels are
    views of one buffer, which the step all-reduces at once."""
    d = _world(group)
    w, h = frame_size
    m = make_map(geom_local, field, device)
    buf = torch.zeros(sum(a.numel() for a in m.mip_alloc), dtype=torch.bool,
                      device=device)
    levels, offset = [], 0
    for a in m.mip_alloc:
        levels.append(buf[offset:offset + a.numel()].view(a.shape))
        offset += a.numel()
    p = torch.as_tensor(init_pose, dtype=torch.float32).to(device)
    f32 = dict(dtype=torch.float32, device=device)
    return DistState(
        map=m._replace(mip_alloc=tuple(levels)), pose=p.clone(),
        raycast_pose=p.clone(),
        vertex=torch.zeros((h, w // d, 3), **f32),
        normal=torch.zeros((h, w // d, 3), **f32),
        valid=torch.zeros((h, w // d), dtype=torch.bool, device=device))


def check_frame_size(frame_size, n_ranks: int, levels: int, field):
    """Refuse a frame that the ranks cannot split as the single-device
    step sees it: a pyramid level whose width they do not divide (JAX
    drops the remainder columns), or a rank slice that is not a multiple
    of the allocation march's pixel strides (JAX shifts the march's sample
    phase: its union then differs from the full-image mask)."""
    w, h = frame_size
    widths = [w]
    for _ in range(levels - 1):
        widths.append(widths[-1] // 2)
    for lvl, wl in enumerate(widths):
        if wl % n_ranks:
            raise ValueError(f"frame width {w}: pyramid level {lvl} is "
                             f"{wl} wide, which {n_ranks} ranks do not "
                             f"divide")
    strides = _OF_STRIDES if field.multiscale_alloc else (_STRIDE,)
    for s in strides:
        if (w // n_ranks) % s:
            raise ValueError(f"frame width {w}: a rank's {w // n_ranks} "
                             f"columns are not a multiple of the "
                             f"allocation march's stride {s}")


class DistStep:
    """``step(state, depth, k, frame, gt_pose=None) -> (state, aux)`` of
    one rank (:func:`make_dist_step`). ``comm`` counts the collectives."""

    def __init__(self, comm, geom, field, *, frame_size, iterations, mu,
                 icp_threshold, neg_y, filter_input, use_gt_pose,
                 integration_rate, tracking_rate, budget, halo_budget,
                 frustum_halo, margin):
        self.comm = comm
        self.geom, self.field = geom, field
        self.frame_size = frame_size
        self.iterations = tuple(iterations)
        self.mu, self.icp_threshold = mu, icp_threshold
        self.neg_y, self.filter_input = neg_y, filter_input
        self.use_gt_pose = use_gt_pose
        self.integration_rate = integration_rate
        self.tracking_rate = tracking_rate
        self.budget = geom.capacity if budget is None else budget
        self.halo_budget = geom.capacity if halo_budget is None \
            else halo_budget
        self.frustum_halo, self.margin = frustum_halo, margin
        d, rows = comm.world, halo_rows(self.halo_budget)
        # the gathered halo table, rank-major: data_x rows r R + j, data_y
        # rows budget later; its geometry holds both as views
        self.halo_geom = dataclasses.replace(
            geom, capacity=d * rows - self.halo_budget)
        self.owners = Owners(d, TILE)
        self._halo_slots = {}

    def halo_slots(self, device):
        """i32[D, halo_budget]: the halo table's slot of each gathered
        row (r R + j)."""
        if device not in self._halo_slots:
            d, hb = self.comm.world, self.halo_budget
            r = torch.arange(d, dtype=torch.int32, device=device)[:, None]
            j = torch.arange(hb, dtype=torch.int32, device=device)[None]
            self._halo_slots[device] = r * halo_rows(hb) + j
        return self._halo_slots[device]

    def reference(self, state: DistState):
        """The full reference maps from the ranks' column slices."""
        comm = self.comm
        h, wl = state.valid.shape
        send = torch.cat([state.vertex, state.normal,
                          state.valid[..., None].to(torch.float32)], -1)
        out = torch.empty((comm.world, h, wl, 7), dtype=torch.float32,
                          device=send.device)
        comm.all_gather(out, send)
        full = out.permute(1, 0, 2, 3).reshape(h, comm.world * wl, 7)
        return (full[..., :3].contiguous(), full[..., 3:6].contiguous(),
                full[..., 6] > 0)

    def halo(self, m: MapState, mats):
        """(halo map state, send counts): the all-gathered table of the
        ranks' halo blocks."""
        comm, hb = self.comm, self.halo_budget
        send, counts = halo_pack(self.geom, m, mats.t_cw, mats.kmat,
                                 self.frame_size, hb, self.margin,
                                 self.frustum_halo)
        table = torch.empty((comm.world,) + tuple(send.shape),
                            dtype=torch.float32, device=send.device)
        comm.all_gather(table, send)
        b = self.geom.blocks_per_side
        cells = table[:, 2 * hb:].reshape(comm.world, -1)[:, :hb] \
            .view(torch.int32)
        # glue: the slot grid as one scatter (padding cells b^3 go to the
        # drop entry)
        slot = torch.full((b ** 3 + 1,), -1, dtype=torch.int32,
                          device=send.device)
        slot[cells.long()] = self.halo_slots(send.device)
        pool = table.view(-1, table.shape[-1])
        halo = m._replace(data_x=pool[:pool.shape[0] - hb], data_y=pool[hb:],
                          slot=slot[:-1].view(b, b, b))
        return halo, counts

    def __call__(self, state: DistState, depth, k, frame, gt_pose=None):
        comm, geom, field = self.comm, self.geom, self.field
        frame = int(frame)
        if frame < 0:
            raise ValueError("frame must be >= 0")
        dev = depth.device
        w, h = self.frame_size
        wl = w // comm.world
        x0 = comm.rank * wl
        ref_v, ref_n, ref_ok = self.reference(state)
        depths, verts, norms, valids = preprocess_and_pyramid(
            depth, k, len(self.iterations), self.neg_y, self.filter_input)

        # ---- tracking (the summed reduction) or the ground truth ---------
        if self.use_gt_pose:  # JAX's step takes the identity for None
            pose_t = torch.eye(4, device=dev) if gt_pose is None \
                else torch.as_tensor(gt_pose, dtype=torch.float32,
                                     device=dev)
            tracked_t = None
            reduction = torch.zeros(32, dtype=torch.float32, device=dev)
        else:
            pose_t, tracked_t, reduction, _ = tracking.track(
                state.pose, state.raycast_pose, k, verts, norms, valids,
                ref_v, ref_n, ref_ok, self.iterations, self.icp_threshold,
                group=comm)
        mats = frame_mats(k, pose_t, state.pose, tracked_t, frame,
                          self.tracking_rate, self.integration_rate)

        # ---- allocation: own columns, union, owned cells -----------------
        m = state.map
        if field.multiscale_alloc:
            grids = touched_masks_of(geom, depths[0], mats.pose, mats.kpose,
                                     self.mu, out=m.touched, x0=x0,
                                     width=wl)
        else:
            grids = (touched_mask(geom, depths[0], mats.pose, mats.kpose,
                                  self.mu, out=m.touched, x0=x0, width=wl),)
        comm.all_reduce_max(m.touched)
        alloc_overflow = alloc_assign(geom, m, grids[0], mats.do_integrate,
                                      extra=grids[1:],
                                      owner=self.owners, rank=comm.rank)
        comm.all_reduce_max(mip_buffer(m))
        m, istats = integration.integrate(
            geom, m, field, depth, mats.pose, k, self.mu, mats.timestamp,
            self.frame_size, budget=self.budget, with_stats=True,
            when=mats.do_integrate, mats=mats)

        # ---- halo exchange and the raycast of own columns (frame > 2) ----
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        if frame > 2:
            halo, halo_counts = self.halo(m, mats)
            nav = nav_grid(self.halo_geom, halo, field)
            rays = raycast_rays(self.halo_geom, halo, field, nav, mats.kpose,
                                depth, k, self.mu, self.frame_size, x0=x0,
                                width=wl)
            vertex, normal, valid = rays.vertex, rays.normal, rays.valid
            raycast_pose = mats.pose
            ray_overflow = rays.overflow
            halo_blocks, halo_overflow = halo_counts[0], halo_counts[1]
        else:
            vertex, normal, valid = state.vertex, state.normal, state.valid
            raycast_pose = state.raycast_pose
            ray_overflow = halo_blocks = halo_overflow = zero

        # ---- the frame's counters, one all_reduce -------------------------
        counts = torch.stack(
            [alloc_overflow.to(torch.int32), istats["blocks_truncated"],
             ray_overflow, halo_overflow, halo_blocks]
            + [m.n_blocks if r == comm.rank else zero
               for r in range(comm.world)])
        comm.all_reduce_sum(counts)
        aux = {"tracked": mats.tracked, "integrated": mats.do_integrate,
               "reduction": reduction, "n_blocks_dev": counts[5:]}
        aux.update(zip(COUNTERS, counts[:5]))
        return DistState(map=m, pose=mats.pose, raycast_pose=raycast_pose,
                         vertex=vertex, normal=normal, valid=valid), aux


def make_dist_step(group, geom_local, field, *, frame_size, iterations, mu,
                   icp_threshold, neg_y=False, filter_input=False,
                   use_gt_pose=False, integration_rate=1, tracking_rate=1,
                   budget=None, halo_budget=None, frustum_halo=True,
                   margin=0.3) -> DistStep:
    """The sharded frame step of this rank (JAX ``make_dist_step``).

    ``group``: the process group (None: the default one) or its
    :class:`Collectives`; ``geom_local`` this rank's geometry (global
    capacity = D x its capacity). ``budget`` (integration worklist) and
    ``halo_budget`` (blocks a rank sends) default to the local capacity.
    ``frustum_halo=False`` sends every allocated block (exact). Returns
    ``step(state, depth, k, frame, gt_pose=None) -> (state, aux)``:
    ``depth`` the full f32[H, W] frame and ``k`` f32[4] on the state's
    device, ``frame`` a Python int; the map is updated in place. The aux
    keys are JAX's: tracked, integrated, reduction, n_blocks_dev (i32[D],
    every rank's block count), alloc_overflow, blocks_truncated,
    ray_overflow, halo_overflow, halo_blocks (summed over the ranks)."""
    comm = group if isinstance(group, Collectives) else Collectives(group)
    check_frame_size(frame_size, comm.world, len(iterations), field)
    return DistStep(comm, geom_local, field, frame_size=frame_size,
                    iterations=iterations, mu=mu,
                    icp_threshold=icp_threshold, neg_y=neg_y,
                    filter_input=filter_input, use_gt_pose=use_gt_pose,
                    integration_rate=integration_rate,
                    tracking_rate=tracking_rate, budget=budget,
                    halo_budget=halo_budget, frustum_halo=frustum_halo,
                    margin=margin)
