"""One CUDA graph for each key: the port's counterpart of a ``jax.jit``.

JAX compiles a jitted function into one XLA program for each set of its
static arguments and reruns that program after. :class:`Graphs` does the
same for a Python program of the port (a callable that launches kernels
and torch ops on tensors at fixed addresses): the first call with a key
runs the program eagerly on the cache's side stream (the warm-up: every
first-call query, build, cache fill and per-stream scratch of the kernels
happens there, outside a capture), then captures it there into the key's
graph. Capturing runs nothing, so the program's writes are the
warm-up's, once. Every later call with the key replays the graph on the
current stream.

The graphs of one cache share one memory pool and the side stream's
scratch (K1's overflow count, K6's sums), so they are replayed one at a
time, in stream order, never concurrently. A tensor the program frees
inside a capture goes back to the pool and a later capture may reuse it:
so a program keeps nothing there that another graph reads. What a graph
hands on lives in tensors outside the pool, or in the tensors its
capture returned, which the cache keeps and each replay rewrites.

Launch counts: the launches made inside a capture are the graph's table
(``_lib.capturing``), and each replay adds it (``_lib.replayed``), so a
run counts what the eager program would; ``replays`` counts each key's
replays. A capture that fails raises and
keeps no graph; nothing falls back to the eager program. On the CPU each
call runs the program eagerly.
"""

import collections
from typing import NamedTuple

import torch

from supereight_tpu_torch.kernels import _lib


class Entry(NamedTuple):
    graph: object     # torch.cuda.CUDAGraph, None on the CPU
    out: object       # what the captured program returned
    launches: dict    # kernel -> launches a replay (_lib.capturing)


class Graphs:
    """The graphs of one owner (a frame program, a pipeline) on
    ``device``: ``entries`` maps each key seen to its :class:`Entry`,
    ``replays`` each key to its graph's replays (none on the CPU)."""

    def __init__(self, device):
        dev = self.device = torch.device(device)
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"Graphs: unsupported device {dev}")
        cuda = dev.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if cuda else None
        self.stream = torch.cuda.Stream(dev) if cuda else None
        self.entries = {}
        self.replays = collections.Counter()

    def __call__(self, key, program):
        """Run ``program`` (no arguments) as ``key``'s graph. Returns what
        it returned: on its first call with ``key`` (and every call on the
        CPU) the eager run's, on a replay the capture's, rewritten."""
        entry = self.entries.get(key)
        if entry is not None and entry.graph is not None:
            entry.graph.replay()
            _lib.replayed(entry.launches)
            self.replays[key] += 1
            return entry.out
        if self.stream is None:
            out = program()
            self.entries[key] = Entry(None, out, {})
            return out
        cur = torch.cuda.current_stream(self.device)
        side = self.stream
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = program()
            graph = torch.cuda.CUDAGraph()
            with _lib.capturing() as launches:
                graph.capture_begin(pool=self.pool,
                                    capture_error_mode="thread_local")
                try:
                    captured = program()
                finally:
                    graph.capture_end()
        cur.wait_stream(side)
        self.entries[key] = Entry(graph, captured, launches)
        return out

    def captured(self) -> int:
        """The graphs captured so far (0 on the CPU)."""
        return sum(e.graph is not None for e in self.entries.values())

    def pool_bytes(self) -> int:
        """Bytes of the device memory the pool holds (its segments in the
        caching allocator's snapshot; 0 on the CPU)."""
        if self.pool is None:
            return 0
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == tuple(self.pool))
