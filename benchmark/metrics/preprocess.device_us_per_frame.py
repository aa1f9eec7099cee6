"""The preprocess layer (``pipeline.preprocess_and_pyramid``,
``ops/preprocess.py``): K7's kernels (the input filters and the pyramid)
and the depth frame's upload, device microseconds a traced frame."""

KERNELS = ("pyramid", "bilateral", "median")
# the depth frame's upload: u16 millimetres sampled to f32 on the host,
# then one host-to-device copy (a pose handed in is 64 bytes)
UPLOAD_MIN_BYTES = 1024


def read(ctx):
    us = ctx["timeline"].kernel_us(KERNELS)
    if us is None:
        return None
    upload = sum(d for _, d, name, kind, n in ctx["timeline"].events
                 if kind == "gpu_memcpy" and "HtoD" in name
                 and n >= UPLOAD_MIN_BYTES)
    return (us + upload) / ctx["frames"]
