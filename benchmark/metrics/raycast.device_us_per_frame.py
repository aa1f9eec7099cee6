"""The raycast layer (``ops/raycast.py``): K2 ``nav_grid`` and K1's
primed march (``raycast``, its OFusion and gated modes), device
microseconds a traced frame."""

KERNELS = ("nav_grid", "raycast")


def read(ctx):
    us = ctx["timeline"].kernel_us(KERNELS)
    return None if us is None else us / ctx["frames"]
