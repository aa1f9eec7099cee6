"""The class pipeline's profiler spans, and the device's idle time under
them.

``supereight_tpu_torch.pipeline.DenseSLAMSystem`` runs each stage method
under a span of its own and, inside it, each call at which its host
waits for the device under a ``pipeline/wait/<what>`` span (the port's
``utils/spans.py``). The names are copied here, the yardstick's own, so
that nothing here imports the port. A program without the spans leaves
the trace without them, and the readers then find nothing to read.

The stage spans do not overlap one another, so the idle time under each,
and what lies under none, sum to the traced frames' idle time; a wait's
idle time counts to the stage around it.
"""

PREPROCESS = "pipeline/preprocessing"
TRACKING = "pipeline/tracking"
INTEGRATION = "pipeline/integration"
RAYCAST = "pipeline/raycasting"
RENDER = "pipeline/render_views"
STAGES = (PREPROCESS, TRACKING, INTEGRATION, RAYCAST, RENDER)
WAIT = "pipeline/wait/"


def idle_us(timeline, names):
    """Microseconds of the traced frames' idle device time (the frame spans
    less :meth:`trace.Timeline.busy_intervals`) under the host spans named
    ``names``, None where the trace holds none of them."""
    under = _union(sorted((a, b) for a, b, name, _ in timeline.host
                          if name in names))
    if not under:
        return None
    busy = timeline.busy_intervals()
    idle, j = [], 0
    for a, b in timeline.frames:
        t = a
        while j < len(busy) and busy[j][0] < b:
            idle.append((t, busy[j][0]))
            t = busy[j][1]
            j += 1
        idle.append((t, b))
    return _overlap_us([(a, b) for a, b in idle if b > a], under)


def _union(intervals):
    out = []
    for a, b in intervals:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap_us(xs, ys):
    """The summed length of the intersection of two sorted lists of
    disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total
