"""Device time from a profiler trace.

Port of ``supereight_tpu/utils/deviceprof.py``. JAX read the device
duration of each compiled program from an xplane trace; the port runs a
frame as a sequence of launches from the host, so it reads a chrome
trace that ``torch.profiler`` exported (``export_chrome_trace``) and sums
the device events in it: kernels, memcpys and memsets; for frames
replayed as CUDA graphs (``parallel/step.FrameProgram``) it also splits a
frame's time into busy, idle inside the frame and the gaps between
frames. The host's events
(torch ops, CUDA runtime calls, ``record_function`` spans) and the spans'
copies on the device's timeline are not device work and are left out.
"""

import json

# chrome-trace categories of the device's own work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_events(trace_file):
    """(start, duration) in microseconds of the complete (``"ph": "X"``)
    device events of a chrome trace, kernels, memcpys and memsets, in
    start order."""
    with open(trace_file) as f:
        trace = json.load(f)
    return sorted((float(e.get("ts", 0.0)), float(e.get("dur", 0.0)))
                  for e in trace["traceEvents"]
                  if e.get("ph") == "X"
                  and str(e.get("cat", "")).lower() in DEVICE_CATEGORIES)


def device_seconds(trace_file):
    """(summed seconds, count) of the device events of a chrome trace
    (:func:`device_events`)."""
    events = device_events(trace_file)
    return sum(d for _, d in events) / 1e6, len(events)


def frame_split(events, n_frames):
    """Where the device's time goes in ``n_frames`` frames of the same
    ``len(events) // n_frames`` device events each (:func:`device_events`
    of a trace that holds every event of the frames): mean microseconds a
    frame that the device is busy, that its frame spans from its first
    event's start to its last one's end, the idle time inside that span
    (the gaps between a graph's nodes, and where the host is late, the
    wait between a frame's input copies and its replay), and the gap
    from one frame's last event to the next one's first; None where the
    events do not divide into the frames."""
    per = len(events) // n_frames if n_frames else 0
    if not per or per * n_frames != len(events):
        return None
    frames = [events[i * per:(i + 1) * per] for i in range(n_frames)]
    busy = sum(d for _, d in events) / n_frames
    span = sum(max(t + d for t, d in f) - f[0][0] for f in frames) / n_frames
    between = [b[0][0] - max(t + d for t, d in a)
               for a, b in zip(frames, frames[1:])]
    return dict(busy_us=busy, span_us=span, inside_us=span - busy,
                between_us=sum(between) / len(between) if between else 0.0,
                events=per)
