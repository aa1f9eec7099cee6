"""The rendering layer (``ops/rendering.py`` through
``DenseSLAMSystem.render_views``: K10 and the composite's read to the
host): what a rendered frame's latency has over the other frames', in ms,
the means over every frame of the window (CUDA events, as
``frame_p95_ms``)."""


def read(ctx):
    lat, rendered = ctx["latency_ms"], ctx["rendered"]
    on = [t for t, r in zip(lat, rendered) if r]
    off = [t for t, r in zip(lat, rendered) if not r]
    if not on or not off:
        return None
    return sum(on) / len(on) - sum(off) / len(off)
