"""Device telemetry sampling: a port of ``supereight_tpu/utils/
telemetry.py`` onto ``torch.cuda.memory_stats``.

Behavioral reference: the ODROID PowerMonitor
(se_apps/src/PowerMonitor.cpp:14-56) — periodic hardware counters fed
into PerfStats. The CUDA analogues available in-process are the caching
allocator's statistics; the stat names are JAX's: ``dev{i}.bytes_in_use``
(bytes allocated now), ``dev{i}.peak_bytes_in_use`` (the peak since the
last ``torch.cuda.reset_peak_memory_stats``, i.e.
``torch.cuda.max_memory_allocated``) and ``dev{i}.bytes_limit`` (the
card's total memory). Without a CUDA device it samples nothing, as JAX's
CPU device, whose ``memory_stats()`` is None.
"""

import torch

from supereight_tpu_torch.utils.perfstats import PerfStats, StatType


class DeviceMonitor:
    """Samples per-device memory stats into a PerfStats instance."""

    def __init__(self, stats: PerfStats = None):
        self.stats = stats or PerfStats()

    def sample(self):
        if not torch.cuda.is_available():
            return self.stats
        for i in range(torch.cuda.device_count()):
            ms = torch.cuda.memory_stats(i)
            if not ms:   # the allocator has not run on this device
                continue
            values = {
                "bytes_in_use": ms["allocated_bytes.all.current"],
                "peak_bytes_in_use": ms["allocated_bytes.all.peak"],
                "bytes_limit": torch.cuda.mem_get_info(i)[1]}
            for key, v in values.items():
                self.stats.sample(f"dev{i}.{key}", v, StatType.UNDEFINED)
        return self.stats
