"""Microseconds a traced frame that the device idles while the host is in
the class's integration (the program's ``pipeline/integration`` span: the
allocation graph, the overflow poll, the block count's read for the
bucket, the fusion graph)."""

from benchmark import spans


def read(ctx):
    us = spans.idle_us(ctx["timeline"], (spans.INTEGRATION,))
    return None if us is None else us / ctx["frames"]
