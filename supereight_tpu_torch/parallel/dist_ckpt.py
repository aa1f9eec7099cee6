"""Checkpoint and resume of the sharded step (``parallel/dist_step.py``).

Port of ``supereight_tpu/parallel/dist_ckpt.py``. JAX wrote the sharded
state with orbax; the GPU host has no orbax, and every rank here holds its
own state, so each rank writes one ``torch.save`` file of its
:class:`DistState` (``rank<r>.pt``) and rank 0 a small ``manifest.json``
(the world size, the state's shapes and, where the caller gives them, the
geometry and the field). Every rank's mip levels are saved: they differ
between ranks (each rank's K4 pass updates the parents of its own blocks).
JAX's orbax checkpoint keeps one copy of them, so an OFusion resume there
may not equal the uninterrupted run (ROADMAP.md, Queue 3); here it does.
"""

import json
import os

import torch
import torch.distributed as dist

from supereight_tpu_torch.parallel.dist_step import DistState, _world

MANIFEST = "manifest.json"


def _shapes(state: DistState):
    return {"blocks_per_side": int(state.map.slot.shape[0]),
            "capacity": int(state.map.data_x.shape[0]),
            "levels": len(state.map.mip_alloc),
            "slice": list(state.valid.shape)}


def _meta(group, state, geom, field):
    meta = {"world_size": _world(group), "shapes": _shapes(state)}
    if geom is not None:
        meta["geometry"] = {"size": geom.size, "dim": geom.dim,
                            "capacity": geom.capacity}
    if field is not None:
        meta["field"] = field.name
    return meta


def _group(group):
    return getattr(group, "group", group)  # a Collectives' process group


def _flat(state: DistState):
    """name -> tensor of every tensor in the state (the mip tuples by
    level)."""
    out = {}
    for name, v in state.map._asdict().items():
        if isinstance(v, tuple):
            out.update({f"map.{name}.{i}": t for i, t in enumerate(v)})
        else:
            out[f"map.{name}"] = v
    for name in ("pose", "raycast_pose", "vertex", "normal", "valid"):
        out[name] = getattr(state, name)
    return out


def save_dist_checkpoint(path: str, state: DistState, group=None, geom=None,
                         field=None) -> None:
    """Write this rank's state under the directory ``path``; returns when
    every rank has written its file (a barrier)."""
    rank = dist.get_rank(_group(group))
    os.makedirs(path, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in _flat(state).items()},
               os.path.join(path, f"rank{rank}.pt"))
    if rank == 0:
        with open(os.path.join(path, MANIFEST), "w") as f:
            json.dump(_meta(group, state, geom, field), f, indent=1)
    dist.barrier(_group(group))


def load_dist_checkpoint(path: str, group, state_like: DistState, geom=None,
                         field=None) -> DistState:
    """This rank's state from :func:`save_dist_checkpoint`'s directory,
    copied into ``state_like`` (a fresh ``init_dist_state``; its tensors,
    devices and the mip buffer are kept) and returned. A checkpoint of
    another world size, other shapes or, where both name them, another
    geometry or field is refused."""
    with open(os.path.join(path, MANIFEST)) as f:
        saved = json.load(f)
    want = _meta(group, state_like, geom, field)
    for key in ("world_size", "shapes", "geometry", "field"):
        if key in saved and key in want and saved[key] != want[key]:
            raise ValueError(f"checkpoint {path}: {key} {saved[key]} is not "
                             f"{want[key]}")
    rank = dist.get_rank(_group(group))
    blob = torch.load(os.path.join(path, f"rank{rank}.pt"))
    for name, t in _flat(state_like).items():
        t.copy_(blob[name])
    return state_like
