"""Compile-event tracking — the port of
``deepspeed_tpu/telemetry/compile_monitor.py``.

The reference has two sources: process-wide compile listeners (every
backend compile increments ``jax_compiles_total`` and observes
``jax_compile_seconds``) and ``track(name, fn)``, per-program retrace
counting through the compile cache of a registered program.  The port
runs eager PyTorch: it compiles no program, so there is nothing to
listen to (``install()`` returns False and stays a no-op) and no
program has a compile cache (``track()`` returns False for a callable
without ``_cache_size``, as the reference does for its plain Python
drivers).  The metric names stay registered unchanged — the summarize
CLI and the contract lint read them — and ``sample()`` still folds the
cache growth of anything tracked into ``recompiles_total{program=...}``
with the same storm warning.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from ..utils.logging import logger
from .registry import MetricsRegistry


class CompileMonitor:
    def __init__(self, registry: MetricsRegistry, storm_threshold: int = 3):
        self.registry = registry
        self.storm_threshold = max(int(storm_threshold), 1)
        self.compiles = registry.counter(
            "jax_compiles_total", "XLA backend compiles (jax.monitoring)")
        self.compile_seconds = registry.histogram(
            "jax_compile_seconds", "XLA backend compile durations")
        self.recompiles = registry.counter(
            "recompiles_total",
            "retraces of tracked jitted programs (cache entries beyond "
            "the first)")
        self._tracked: List[Tuple[str, object]] = []
        self._seen_sizes: Dict[str, int] = {}
        self._warned_storm: set = set()

    # -- compile listeners ----------------------------------------------
    def install(self) -> bool:
        """No compile listener exists under eager PyTorch: returns False
        and stays a no-op (the reference's answer where its listener API
        is missing)."""
        return False

    def uninstall(self):
        """Nothing was installed."""

    # -- per-program retrace tracking -----------------------------------
    def track(self, name: str, fn) -> bool:
        """Register a compiled callable for retrace counting.  Accepts
        anything; silently skips (returns False for) objects without a
        compile cache — every program of the eager port."""
        if not hasattr(fn, "_cache_size"):
            return False
        self._tracked.append((name, fn))
        self._seen_sizes.setdefault(name, 0)
        return True

    def sample(self):
        """Fold current cache sizes into ``recompiles_total``.  Rides
        the caller's sync cadence — reading ``_cache_size`` is a host
        dict ``len()``, never a device sync."""
        for name, fn in self._tracked:
            try:
                size = int(fn._cache_size())
            except Exception:
                continue
            prev = self._seen_sizes.get(name, 0)
            if size <= prev:
                continue
            # entries beyond the first are retraces
            new_retraces = max(size - 1, 0) - max(prev - 1, 0)
            self._seen_sizes[name] = size
            if new_retraces <= 0:
                continue
            self.recompiles.inc(new_retraces, program=name)
            if (new_retraces >= self.storm_threshold
                    and name not in self._warned_storm):
                self._warned_storm.add(name)
                logger.warning(
                    "recompile storm: program %r retraced %d times within "
                    "one sample window (total cache entries: %d). A shape "
                    "or static-arg is varying per call — see "
                    "docs/observability.md.", name, new_retraces, size)

    def tracked_programs(self) -> List[str]:
        return [name for name, _ in self._tracked]
