"""Process-group set-up for the sharded step (``parallel/dist_step.py``).

Port of ``supereight_tpu/parallel/distributed.py`` (``initialize_from_env``,
``is_primary``, ``scaling_report``) onto ``torch.distributed``. JAX wired
TPU hosts into one runtime; here every rank is a process. Nothing is
chosen silently: the caller names the backend and the device.

* ``"nccl"``: one card per rank, rank r on ``cuda:<LOCAL_RANK>``; refused
  when the world is larger than the cards this host has.
* ``"gloo"``: the CPU (``device="cpu"``), or ranks that share one card
  (``device="cuda"`` or ``"cuda:<i>"``), whose collectives PyTorch's Gloo
  group stages through host memory. NCCL refuses two ranks on one card.

The rank and world come from torchrun's variables (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) unless the
caller passes them with an explicit ``init_method`` (a ``file://`` store
path or a ``tcp://localhost:<port>`` address).
"""

import collections
import datetime
import os
import time

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
TIMEOUT_S = 300  # a rank that waits longer on a collective raises


def initialize(backend: str, device: str = "cuda", init_method=None,
               world_size: int = None, rank: int = None,
               timeout_s: float = TIMEOUT_S) -> torch.device:
    """Join the default process group and return this rank's device.

    ``backend`` and ``device`` are the caller's choice (see the module
    docstring); a CUDA device with no card present raises, as does NCCL
    on the CPU or with more ranks than cards. Without ``init_method`` the
    rank, world size and rendezvous come from torchrun's environment.
    ``timeout_s`` bounds every collective, so a rank that died brings the
    others down instead of hanging them."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if init_method is None:
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        init_method = "env://"
    elif rank is None or world_size is None:
        raise ValueError("an explicit init_method needs rank and world_size")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r}: no CUDA device")
        if backend == "nccl":
            n = torch.cuda.device_count()
            if world_size > n:
                raise RuntimeError(
                    f"nccl: {world_size} ranks need one card each, this host "
                    f"has {n}; ranks that share a card take backend 'gloo'")
            local = int(os.environ.get("LOCAL_RANK", rank))
            dev = torch.device("cuda", local)
        elif dev.index is None:
            dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError("nccl runs on CUDA devices only")
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def is_primary(group=None) -> bool:
    """Whether this process is rank 0 (of ``group``)."""
    return dist.get_rank(group) == 0


def scaling_report(frame_seconds: float, n_frames: int, group=None):
    """Frames a second and the share of each rank (JAX's scaling report,
    over the process group's ranks)."""
    fps = n_frames / frame_seconds if frame_seconds > 0 else 0.0
    ranks = dist.get_world_size(group)
    return {"fps": fps, "ranks": ranks, "fps_per_rank": fps / max(ranks, 1)}


class Collectives:
    """The sharded step's collectives over ``group`` (None: the default
    group), each counted by kind with its payload bytes and the host
    seconds it blocked for (which include waiting for the device to reach
    it: a collective over CUDA tensors under Gloo first copies them to
    the host)."""

    def __init__(self, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.reset()

    def reset(self):
        self.calls = collections.Counter()
        self.bytes = collections.Counter()
        self.seconds = 0.0

    def _count(self, kind, t, t0):
        self.seconds += time.perf_counter() - t0
        self.calls[kind] += 1
        self.bytes[kind] += t.numel() * t.element_size()

    def all_reduce_sum(self, t):
        """Sum ``t`` over the ranks, in place."""
        t0 = time.perf_counter()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        self._count("all_reduce", t, t0)

    def all_reduce_max(self, t):
        """The elementwise maximum of ``t`` over the ranks, in place; a
        bool tensor is reduced as its bytes (NCCL has no bool), which is
        its OR."""
        t0 = time.perf_counter()
        u = t.view(torch.uint8) if t.dtype == torch.bool else t
        dist.all_reduce(u, op=dist.ReduceOp.MAX, group=self.group)
        self._count("all_reduce", t, t0)

    def all_gather(self, out, t):
        """Every rank's ``t`` into ``out`` [world, *t.shape], rank-major."""
        t0 = time.perf_counter()
        dist.all_gather(list(out.unbind(0)), t, group=self.group)
        self._count("all_gather", t, t0)
