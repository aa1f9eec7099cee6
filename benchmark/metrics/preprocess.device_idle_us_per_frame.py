"""Microseconds a traced frame that the device idles while the host is in
the class's preprocessing (the program's ``pipeline/preprocessing`` span:
the depth's sampling on the host, its upload, the stage graph's replay)."""

from benchmark import spans


def read(ctx):
    us = spans.idle_us(ctx["timeline"], (spans.PREPROCESS,))
    return None if us is None else us / ctx["frames"]
