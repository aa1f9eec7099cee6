"""Microseconds a traced frame, over all traced frames, that the device
idles while the host is in the class's ``render_views`` (the program's
``pipeline/render_views`` span: K10's launch and the composite's copy to
the host)."""

from benchmark import spans


def read(ctx):
    us = spans.idle_us(ctx["timeline"], (spans.RENDER,))
    return None if us is None else us / ctx["frames"]
