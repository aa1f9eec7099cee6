"""The device's idle share of the traced frames: 100 (1 - busy / window),
busy the union of the device's kernels, copies and sets inside the frame
spans, the window the spans' summed length."""


def read(ctx):
    tl = ctx["timeline"]
    window = tl.window_us()
    if window <= 0 or not tl.events:
        return None
    return 100.0 * (1.0 - tl.busy_us() / window)
