"""Microseconds a traced frame that the device idles while the host is in
the class's tracking (the program's ``pipeline/tracking`` span: the
tracking graph's replay and the verdict's read, or a ground-truth pose's
copy in)."""

from benchmark import spans


def read(ctx):
    us = spans.idle_us(ctx["timeline"], (spans.TRACKING,))
    return None if us is None else us / ctx["frames"]
