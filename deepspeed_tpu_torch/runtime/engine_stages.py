"""The serving engine's stage plane (docs/stages.md): wiring, not policy.

``runtime/stages.py`` owns the shared async-stage primitives; this module
owns how ONE :class:`~..inference.engine.ServeEngine` instantiates its
drain-order graph.  Only the serving half of the JAX package's
``runtime/engine_stages.py`` is ported so far; the training engine's
stage plane comes with the training slice (ROADMAP.md queue 1).
"""
from __future__ import annotations

from .stages import StageGraph


def wire_serve_stage_plane(serve) -> None:
    """Install the serving engine's drain-order graph (docs/stages.md;
    the fence's second line):

        serve queue -> kv spill -> kv fetch -> telemetry flush

    Close order: stop taking requests first (``serve_queue`` fails the
    queued/pending typed), then the KV tier's spill and fetch planes,
    telemetry last so the final flush still sees every counter.  The
    graph names are the JAX engine's; the kv and telemetry entries are
    no-ops until the port grows the KV tier and telemetry (ROADMAP.md
    queue 1).
    """
    serve._graph = StageGraph()
    serve._graph.register("serve_queue", close=serve._close_queue,
                          drain=lambda: None)
    for name in ("kv_spill", "kv_fetch", "telemetry"):
        serve._graph.register(name, close=lambda: None, drain=lambda: None)
