"""The class pipeline's 99th percentile of every window frame's latency
(CUDA events, as ``frame_p95_ms``): the work done on 1-5 % of frames
(the allocation overflow poll every 8th frame). Not bounded: on the
card's shared host it spread too far between runs (PERF.md)."""

from benchmark.run import percentile


def read(ctx):
    lat = ctx["latency_ms"]
    return percentile(lat, 99) if len(lat) else None
