"""Device-memory gauges from the structured ``memory_status`` path.

``runtime.utils.collect_memory_stats()`` is the ONE collection point —
the log line, these gauges, and the JSONL memory events all render the
same dict instead of re-parsing each other's strings.

Sampling reads the CUDA caching allocator's ``torch.cuda.memory_stats``
(host bookkeeping, no device drain), ``torch.cuda.mem_get_info`` and
``/proc/self/status`` for the engine's device (host RSS only on the CPU),
so the engine can sample at its periodic flush without adding a device
sync of its own.
"""
from __future__ import annotations

from typing import Optional

from .registry import MetricsRegistry


class MemorySampler:
    def __init__(self, registry: MetricsRegistry, device=None):
        self.registry = registry
        self.device = device
        self.bytes_in_use = registry.gauge(
            "device_bytes_in_use", "HBM bytes currently allocated")
        self.peak_bytes = registry.gauge(
            "device_peak_bytes_in_use", "peak HBM bytes allocated")
        self.bytes_limit = registry.gauge(
            "device_bytes_limit", "HBM allocator capacity")
        self.host_rss = registry.gauge(
            "host_rss_bytes", "process resident set size")

    def sample(self) -> dict:
        """Collect once, set every gauge, return the structured dict
        (the caller forwards it to the JSONL exporter / trace counter
        track)."""
        from ..runtime.utils import collect_memory_stats
        stats = collect_memory_stats(self.device)
        for dev in stats.get("devices", []):
            did = str(dev.get("id"))
            if dev.get("bytes_in_use") is not None:
                self.bytes_in_use.set(dev["bytes_in_use"], device=did)
            if dev.get("peak_bytes_in_use") is not None:
                self.peak_bytes.set(dev["peak_bytes_in_use"], device=did)
            if dev.get("bytes_limit") is not None:
                self.bytes_limit.set(dev["bytes_limit"], device=did)
        rss = stats.get("host_rss_bytes")
        if rss is not None:
            self.host_rss.set(rss)
        return stats

    def peak_hbm_bytes(self) -> Optional[float]:
        """Max peak across sampled devices (the summarize CLI's
        headline number)."""
        series = self.peak_bytes.series()
        if not series:
            return None
        return max(v for _, v in series)
