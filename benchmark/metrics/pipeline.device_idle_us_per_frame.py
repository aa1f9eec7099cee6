"""Microseconds a traced frame that the device idles while the host is in
none of the class's stage spans: ``process_frame``'s own glue between
them and the caller's read of the pose and counters. With the stage
readers' it sums to the traced frames' idle time."""

from benchmark import spans


def read(ctx):
    tl = ctx["timeline"]
    staged = spans.idle_us(tl, spans.STAGES)
    if staged is None:
        return None
    return (tl.window_us() - tl.busy_us() - staged) / ctx["frames"]
