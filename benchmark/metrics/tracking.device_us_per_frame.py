"""The tracking layer (``ops/tracking.py``): K6 ``icp_track``, one launch
a frame, device microseconds a traced frame. (The pose prologue,
``frame_mats``, is launched by tracking, allocation and the raycast
alike, and is credited to none of them.)"""

KERNELS = ("icp_track",)


def read(ctx):
    us = ctx["timeline"].kernel_us(KERNELS)
    return None if us is None else us / ctx["frames"]
