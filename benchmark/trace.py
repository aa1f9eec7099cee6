"""The device's timeline from a ``torch.profiler`` chrome trace.

After ``supereight_tpu_torch/utils/deviceprof.py`` (``device_events``:
kernels, memcpys and memsets are the device's own work; the host's
events and the spans' copies on the device's timeline are not), with
what the benchmark adds: the port's kernel names, the events that the
harness's own copies caused (left out), the traced window from the
harness's frame spans, the union of busy intervals, and the idle gaps by
what the host was doing.
"""

import collections
import json
import re

import numpy as np

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
FRAME_SPAN = "bench.frame"      # the harness's span around each frame
CAPTURE_SPAN = "bench.capture"  # its copies of a frame's inputs

_KERNEL = re.compile(r"(\w+)_kernel(<[^>(]*>)?\(")


def kernel_name(name: str) -> str:
    """The port's kernel name of a device event (``icp_track`` of
    ``icp_track_kernel(...)``; K1's unprimed launch, ``raycast_kernel<..,
    false>``, as ``raycast_cold``), else the event's own name."""
    m = _KERNEL.search(name)
    if not m:
        return name
    base, targs = m.group(1), (m.group(2) or "").replace(" ", "")
    if base == "raycast" and targs.count(",") == 2 \
            and targs.endswith(",false>"):
        return "raycast_cold"
    return base


class Timeline:
    """The device events of one traced window (``events``: (start us,
    duration us, name, kind, bytes) in start order, kind one of
    :data:`DEVICE_CATEGORIES`, bytes a copy's), the traced frames'
    spans (``frames``: (start, end) us, the window), and the host's
    events (``host``: (start, end, name, thread))
    that the idle gaps are named by."""

    def __init__(self, trace_file):
        with open(trace_file) as f:
            trace = json.load(f)["traceEvents"]
        spans = [e for e in trace if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"]
        frames = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in spans if e.get("name") == FRAME_SPAN]
        captures = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e.get("tid")) for e in spans
                    if e.get("name") == CAPTURE_SPAN]
        skip = set()
        for e in trace:
            if e.get("ph") != "X" or e.get("cat") != "cuda_runtime":
                continue
            ts = float(e["ts"])
            if any(a <= ts <= b and t == e.get("tid")
                   for a, b, t in captures):
                skip.add(e.get("args", {}).get("correlation"))
        self.frames = sorted(frames)
        self.events = sorted(
            (float(e["ts"]), float(e.get("dur", 0.0)), str(e.get("name")),
             str(e.get("cat")).lower(),
             int(e.get("args", {}).get("bytes", 0) or 0))
            for e in trace if e.get("ph") == "X"
            and str(e.get("cat", "")).lower() in DEVICE_CATEGORIES
            and e.get("args", {}).get("correlation") not in skip)
        self.host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      str(e.get("name")), e.get("tid")) for e in trace
                     if e.get("ph") == "X" and e.get("cat") in
                     ("cpu_op", "user_annotation", "cuda_runtime")]

    def kernels(self):
        """(port name, duration us) of each kernel event."""
        return [(kernel_name(n), d) for _, d, n, k, _ in self.events
                if k == "kernel"]

    def kernel_us(self, names):
        """Summed device microseconds of the kernels named ``names`` (the
        port's names), None where the trace holds none of them."""
        times = [d for name, d in self.kernels() if name in names]
        return sum(times) if times else None

    def busy_intervals(self):
        """The union of the device events' intervals, cut to the frame
        spans (the harness's own work between frames is not the
        window's)."""
        union = []
        for t, d, *_ in self.events:
            if union and t <= union[-1][1]:
                union[-1][1] = max(union[-1][1], t + d)
            else:
                union.append([t, t + d])
        out, j = [], 0
        for a, b in self.frames:
            while j < len(union) and union[j][1] <= a:
                j += 1
            k = j
            while k < len(union) and union[k][0] < b:
                out.append([max(a, union[k][0]), min(b, union[k][1])])
                k += 1
        return out

    def busy_us(self):
        return sum(b - a for a, b in self.busy_intervals())

    def window_us(self):
        """The traced window: the frame spans' summed length."""
        return sum(b - a for a, b in self.frames)

    def idle_gaps(self, top=10):
        """[name, seconds] of the idle time inside the frame spans, summed
        by what the host was doing at each gap's middle: its innermost
        event there (a torch op, a runtime call or the frame's span), the
        longest first."""
        busy = self.busy_intervals()
        starts = np.array([h[0] for h in self.host])
        ends = np.array([h[1] for h in self.host])
        by = collections.Counter()
        j = 0
        for a, b in self.frames:
            edges = [a]
            while j < len(busy) and busy[j][0] < b:
                edges += busy[j]
                j += 1
            edges.append(b)
            for g0, g1 in zip(edges[::2], edges[1::2]):
                if g1 <= g0:
                    continue
                mid = 0.5 * (g0 + g1)
                inside = np.flatnonzero((starts <= mid) & (ends >= mid))
                name = "no host event"
                if inside.size:
                    name = self.host[inside[np.argmin(
                        ends[inside] - starts[inside])]][2]
                by[name] += (g1 - g0) / 1e6
        return [[n, v] for n, v in by.most_common(top)]

    def device_ops(self, top=10):
        """[name, seconds] of the device operations that took most time
        in the window, by the port's kernel name or the event's own."""
        by = collections.Counter()
        for t, d, n, *_ in self.events:
            if any(a <= t <= b for a, b in self.frames):
                by[kernel_name(n)] += d / 1e6
        return [[n, v] for n, v in by.most_common(top)]
