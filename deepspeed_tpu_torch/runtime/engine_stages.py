"""The engines' stage planes (docs/stages.md): wiring, not policy (a port
of ``deepspeed_tpu/runtime/engine_stages.py``).

``runtime/stages.py`` owns the shared async-stage primitives; this module
owns how the engines use them — the training engine's persistent
per-subsystem :class:`~.stages.Stage` records, the telemetry counter hook,
the degradation dump, and THE documented drain order with its close/drain
entries.

THE training drain order (rationale in docs/stages.md): producers of
droppable work stop first (prefetched batches; a streamed upload that
never outlives its step call), an in-flight checkpoint save is not
droppable, so its stage drains (and surfaces failures) before telemetry
flushes last, still seeing every stage's final spans and counters —

    prefetch -> offload uploads -> disk write-back -> ckpt writer
             -> telemetry flush

(the JAX engine's; the disk tier's read-ahead and write-back workers
never outlive their step call, so its entry aborts a step in flight and
is a no-op between steps).

The serving engine has its own graph with the same discipline
(``wire_serve_stage_plane``) —

    serve queue -> kv spill -> kv fetch -> telemetry flush
"""
from __future__ import annotations

import weakref

from .stages import Stage, StageGraph

#: (stage name, inline/serial fallback named in the degradation warning)
ENGINE_STAGES = (
    ("prefetch", "inline iteration"),
    ("offload_h2d", "the serial offload update"),
    ("disk_read", "the serial read-update-write loop"),
    ("disk_write", "the serial read-update-write loop"),
    ("ckpt_writer", "synchronous saves"),
)


def wire_stage_plane(engine) -> None:
    """Install the stage records and THE drain-order graph on ``engine``.

    The counter hook holds the engine WEAKLY: stage records ride worker
    threads (GC roots), and a strong capture would pin the engine for
    process lifetime.  The graph's entries resolve engine attributes at
    call time (``getattr``), so wiring happens before the checkpoint
    writer exists and close stays correct on partially-built engines.
    """
    eng_ref = weakref.ref(engine)

    def _stage_counter(name, help, n):
        eng = eng_ref()
        if eng is not None and eng.telemetry is not None:
            eng.telemetry.registry.counter(name, help).inc(n)

    def _stage_degrade_dump(st):
        # flight recorder (docs/observability.md): a degradation is the
        # moment the history explaining it is still in the rings — dump
        # before it scrolls off.  Runs on the degrading worker's thread;
        # dump_flight_record never raises.
        eng = eng_ref()
        if eng is not None:
            eng.dump_flight_record(
                reason=f"stage {st.name!r} degraded to {st.fallback}")

    engine._stage_records = {}
    for sname, fallback in ENGINE_STAGES:
        st = Stage(sname,
                   max_failures=engine.config.stages_config
                   .max_stage_failures,
                   fallback=fallback)
        st.counter_fn = _stage_counter
        st.on_degrade = _stage_degrade_dump
        engine._stage_records[sname] = st
    engine.last_stage_error = None
    #: every surfaced stage error, oldest first (bounded) — one tick
    #: can pop several stages' failures and ``last_stage_error`` only
    #: carries the newest
    engine.stage_errors = []
    engine._active_uploader = None

    graph = StageGraph()
    graph.register("prefetch",
                   close=lambda: close_prefetch_stage(engine),
                   drain=lambda: None)  # queued batches are droppable
    graph.register("offload_uploads",
                   close=lambda: close_upload_stage(engine),
                   drain=lambda: None)  # never outlives its step call
    graph.register("disk_writeback",
                   close=lambda: close_disk_stage(engine),
                   drain=lambda: None)  # joined inside its step call
    graph.register("ckpt_writer",
                   close=lambda: close_ckpt_stage(engine),
                   drain=lambda: drain_ckpt_stage(engine))
    graph.register("telemetry",
                   close=lambda: close_telemetry_stage(engine),
                   drain=engine._flush_tensorboard)
    engine._stage_graph = graph


def stage_degraded(engine, name: str) -> bool:
    """True when the named stage exhausted its failure budget — the
    engine's hot paths pin their serial/inline equivalent on this."""
    recs = getattr(engine, "_stage_records", None)
    return bool(recs) and name in recs and recs[name].degraded


def pop_stage_errors(engine) -> None:
    """Land stage failures whose natural reporting path was gone in
    ``engine.last_stage_error`` — the training thread's advertised
    surface, ticked pre-step alongside the checkpoint writer's.  All of
    them are retained in ``engine.stage_errors`` (bounded, oldest
    dropped) so an earlier stage's error is never silently replaced by a
    later one."""
    for st in getattr(engine, "_stage_records", {}).values():
        err = st.pop_error()
        if err is not None:
            engine.last_stage_error = err
            engine.stage_errors.append(err)
            del engine.stage_errors[:-16]


def finish_close(engine) -> None:
    """The tail of ``engine.close()``: run THE drain order, release the
    preemption hook and the GC finalizer, then surface any close-time
    failures.  ``close_all`` never aborts mid-order, so every stage
    still closed; the errors land in ``stage_errors``/
    ``last_stage_error`` and the FIRST re-raises so an explicit caller
    sees the shutdown was not clean (a GC finalizer swallows it like
    any finalizer exception — the hook/finalizer release above already
    happened, so a later explicit close stays idempotent)."""
    errors = engine._stage_graph.close_all()
    pop_stage_errors(engine)
    ph = getattr(engine, "_preemption_handler", None)
    if ph is not None and not ph.fired:
        ph.uninstall()
    if getattr(engine, "_finalizer", None) is not None:
        engine._finalizer.detach()
        engine._finalizer = None
    if errors:
        for _name, err in errors:
            engine.last_stage_error = err
            engine.stage_errors.append(err)
        del engine.stage_errors[:-16]
        raise errors[0][1]


# ---------------------------------------------------------------------------
# the training graph's entries, in THE drain order
# ---------------------------------------------------------------------------
def close_prefetch_stage(engine) -> None:
    """Release the input pipeline: every prefetcher the engine built or
    adopted and the batches it staged ahead (idempotent)."""
    for pf in getattr(engine, "_prefetchers", []):
        pf.close()


def close_upload_stage(engine) -> None:
    """Abort a mid-flight streamed upload (a close landing inside a step
    from another thread): queued uploads drop, the old compute params
    stay the consistent truth, an in-flight failure surfaces through the
    stage record."""
    up = getattr(engine, "_active_uploader", None)
    if up is not None:
        up.abort()


def close_disk_stage(engine) -> None:
    """Abort a mid-flight disk-tier read-ahead/write-back pipeline (a
    close landing inside a step from another thread): the channels
    close, the step raises and poisons, and a checkpoint restore
    rewrites every leaf.  Between steps a no-op."""
    opt = getattr(engine, "_host_opt", None)
    if opt is not None and hasattr(opt, "abort_inflight"):
        opt.abort_inflight()


def drain_ckpt_stage(engine) -> None:
    """Wait out an in-flight async save WITHOUT stopping the writer
    (sync-save ordering); its failure, if any, surfaces exactly like the
    pre-step tick's."""
    w = getattr(engine, "_ckpt_writer", None)
    if w is not None:
        from .checkpointing import _surface_writer_error
        _surface_writer_error(engine, w.drain())


def close_ckpt_stage(engine) -> None:
    """Close the checkpoint writer BEFORE telemetry: an in-flight async
    save must land (its spans/counters included), and a failure surfaces
    in ``last_ckpt_error`` rather than vanishing with the daemon
    thread."""
    w = getattr(engine, "_ckpt_writer", None)
    if w is not None:
        w.close()
        engine._ckpt_writer_tick()


def close_telemetry_stage(engine) -> None:
    """Flush buffered scalars and close the hub + summary writer — LAST,
    after every stage that emits telemetry has drained."""
    engine._flush_tensorboard()
    tel = getattr(engine, "telemetry", None)
    if tel is not None:
        tel.close()
    if engine.summary_writer is not None:
        engine.summary_writer.close()


# ---------------------------------------------------------------------------
# the serving engine's stage graph, in ITS drain order
# ---------------------------------------------------------------------------
def wire_serve_stage_plane(serve) -> None:
    """Install the serving engine's drain-order graph (docs/stages.md;
    the fence's second line):

        serve queue -> kv spill -> kv fetch -> telemetry flush

    Close order: stop taking requests first (``serve_queue`` fails the
    queued/pending typed and clears the prefix cache), then stop the KV
    tier's parking and write its host-resident parked pages to the disk
    tier (``kv_spill``), then drop the remaining parked records
    (``kv_fetch`` — host/disk bytes only, no pool refs to return),
    telemetry last, so the final flush still sees every tier counter.
    Both kv entries are no-ops when the tier is off
    (``serving.kv_tier.idle_park_ticks=0``), the telemetry entry when
    ``telemetry.enabled`` is off.
    """
    serve._graph = StageGraph()
    serve._graph.register("serve_queue", close=serve._close_queue,
                          drain=lambda: None)
    serve._graph.register("kv_spill", close=serve._close_kv_spill,
                          drain=serve._drain_kv_spill)
    serve._graph.register("kv_fetch", close=serve._close_kv_fetch,
                          drain=lambda: None)
    serve._graph.register("telemetry", close=serve._close_telemetry,
                          drain=serve._flush)
