"""The engines' stage planes (docs/stages.md): wiring, not policy.

``runtime/stages.py`` owns the shared async-stage primitives; this module
owns how the engines use them.  The serving engine's drain-order graph is
ported whole.  Of the training engine's graph only the checkpoint
writer's entry is: its drain (a sync save waits out an in-flight async
one) and its close (``engine.close()`` lands the last save).  The
prefetch, offload and telemetry entries come with ROADMAP.md queue 1
items 5 and 12.
"""
from __future__ import annotations

from .stages import StageGraph


def drain_ckpt_stage(engine) -> None:
    """Wait out an in-flight async save WITHOUT stopping the writer
    (sync-save ordering); its failure, if any, surfaces exactly like the
    pre-step tick's."""
    w = getattr(engine, "_ckpt_writer", None)
    if w is not None:
        from .checkpointing import _surface_writer_error
        _surface_writer_error(engine, w.drain())


def close_ckpt_stage(engine) -> None:
    """Close the checkpoint writer: an in-flight async save must land,
    and a failure surfaces in ``last_ckpt_error`` rather than vanishing
    with the daemon thread."""
    w = getattr(engine, "_ckpt_writer", None)
    if w is not None:
        w.close()
        engine._ckpt_writer_tick()


def wire_serve_stage_plane(serve) -> None:
    """Install the serving engine's drain-order graph (docs/stages.md;
    the fence's second line):

        serve queue -> kv spill -> kv fetch -> telemetry flush

    Close order: stop taking requests first (``serve_queue`` fails the
    queued/pending typed and clears the prefix cache), then stop the KV
    tier's parking and write its host-resident parked pages to the disk
    tier (``kv_spill``), then drop the remaining parked records
    (``kv_fetch`` — host/disk bytes only, no pool refs to return),
    telemetry last.  Both kv entries are no-ops when the tier is off
    (``serving.kv_tier.idle_park_ticks=0``); the telemetry entry is a
    no-op until telemetry is ported (ROADMAP.md queue 1 item 5).
    """
    serve._graph = StageGraph()
    serve._graph.register("serve_queue", close=serve._close_queue,
                          drain=lambda: None)
    serve._graph.register("kv_spill", close=serve._close_kv_spill,
                          drain=serve._drain_kv_spill)
    serve._graph.register("kv_fetch", close=serve._close_kv_fetch,
                          drain=lambda: None)
    serve._graph.register("telemetry", close=lambda: None,
                          drain=lambda: None)
