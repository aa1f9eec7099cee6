"""The port's profiler spans: ``torch.profiler.record_function`` ranges,
entered only while a profiler records.

A ``record_function`` entered and left with no profiler active still
builds and tears down a record: about 6-12 µs on a host core, a tenth of
a class frame at ten spans. :func:`span` and :func:`spanned` check
torch's own flag (``torch.autograd.profiler._is_profiler_enabled``, set
by ``torch.profiler.profile`` and the autograd profiler alike) and
otherwise create nothing, so a span costs a flag read when off.

The spans are recorded on the profiler's clock beside the CUDA activity
it traces, so a trace puts the device's idle time down to the span the
host was in. Their names, and what reads them:

- ``frame_step/<stage>`` (``parallel/step.py``; preprocess, track,
  allocate, integrate, raycast): ``chip_smoke.py``'s stage breakdown;
- ``pipeline/<stage>`` (``pipeline.DenseSLAMSystem``; preprocessing,
  tracking, integration, raycasting, render_views), each over its whole
  method, and ``pipeline/wait/<what>`` inside them around each call at
  which the class's host blocks on the device (depth, gt_pose, tracked,
  n_blocks, alloc_overflow, composite): the benchmark's
  ``*.device_idle_us_per_frame`` and ``pipeline.host_waits_per_frame``.
"""

import contextlib
import functools

import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` while a profiler records, else a
    shared no-op context."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorate a function to run under :func:`span` ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _profiler._is_profiler_enabled:
                with _profiler.record_function(name):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)
        return call
    return wrap
