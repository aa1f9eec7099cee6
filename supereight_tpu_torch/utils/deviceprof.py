"""Device time from a profiler trace.

Port of ``supereight_tpu/utils/deviceprof.py``. JAX read the device
duration of each compiled program from an xplane trace; the port runs a
frame as a sequence of launches from the host, so it reads a chrome
trace that ``torch.profiler`` exported (``export_chrome_trace``) and sums
the device events in it: kernels, memcpys and memsets. The host's events
(torch ops, CUDA runtime calls, ``record_function`` spans) and the spans'
copies on the device's timeline are not device work and are left out.
"""

import json

# chrome-trace categories of the device's own work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_seconds(trace_file):
    """(summed seconds, count) of the complete (``"ph": "X"``) device
    events of a chrome trace: kernels, memcpys and memsets; ``dur`` is in
    microseconds."""
    with open(trace_file) as f:
        trace = json.load(f)
    events = [e for e in trace["traceEvents"]
              if e.get("ph") == "X"
              and str(e.get("cat", "")).lower() in DEVICE_CATEGORIES]
    return sum(float(e.get("dur", 0.0)) for e in events) / 1e6, len(events)
