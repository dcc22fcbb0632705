"""Unified telemetry for the port's engines (a copy of
``deepspeed_tpu/telemetry/``, stdlib only but for ``memory.py``, which
reads the CUDA caching allocator, and ``compile_monitor.py``, whose
compile sources do not exist under eager PyTorch).

    metrics registry  -> Prometheus text / JSONL / SummaryWriter bridge
    span tracing      -> Chrome/Perfetto trace-event JSON (host-side,
                         zero added device syncs)
    compile tracking  -> recompiles_total{program=...} + storm warning
    memory gauges     -> structured memory_status at sync points

The engine constructs ONE :class:`TelemetryHub` per run when the
``telemetry`` config block is enabled; see docs/observability.md.

``python -m deepspeed_tpu_torch.telemetry summarize <events.jsonl>`` reports
p50/p95/p99 step time, samples/sec, and peak HBM offline.
"""
from .compile_monitor import CompileMonitor
from .exporters import (JsonlExporter, SummaryWriterBridge,
                        prometheus_text, write_prometheus)
from .heartbeat import (HeartbeatWriter, StragglerMonitor, beat_ages,
                        read_heartbeats)
from .hub import TelemetryHub, write_flight_record
from .memory import MemorySampler
from .registry import Counter, Gauge, Histogram, MetricsRegistry
from .tracing import SpanHandle, TraceContext, TraceRecorder

__all__ = [
    "CompileMonitor", "Counter", "Gauge", "HeartbeatWriter", "Histogram",
    "JsonlExporter", "MemorySampler", "MetricsRegistry", "SpanHandle",
    "StragglerMonitor", "SummaryWriterBridge", "TelemetryHub",
    "TraceContext", "TraceRecorder", "beat_ages", "prometheus_text",
    "read_heartbeats", "write_flight_record", "write_prometheus",
]
