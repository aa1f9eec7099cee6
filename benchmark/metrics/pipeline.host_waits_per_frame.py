"""The calls a traced frame at which the class's host waits for the
device: the program's ``pipeline/wait/<what>`` spans inside the frames
(the depth's upload, a ground-truth pose's copy, the tracking verdict,
the block count, the overflow poll, the composite's copy)."""

from benchmark import spans


def read(ctx):
    tl = ctx["timeline"]
    n = sum(1 for a, b, name, _ in tl.host if name.startswith(spans.WAIT)
            and any(f0 <= a and b <= f1 for f0, f1 in tl.frames))
    return n / ctx["frames"] if n else None
