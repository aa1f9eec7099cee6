"""Microseconds a traced frame that the device idles while the host is in
the class's raycast (the program's ``pipeline/raycasting`` span)."""

from benchmark import spans


def read(ctx):
    us = spans.idle_us(ctx["timeline"], (spans.RAYCAST,))
    return None if us is None else us / ctx["frames"]
