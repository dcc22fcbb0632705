"""Fault-tolerant checkpointing primitives: the background writer, the
retry/fault-injection plane, retention GC, and the preemption hook — a
copy of ``deepspeed_tpu/runtime/resilience.py`` (it imports no JAX), so
the port's checkpoints and KV tier share the JAX package's semantics.

The reference writes checkpoints synchronously and trusts the filesystem
(reference deepspeed/runtime/engine.py:1211-1290): a save stalls the step
loop for the full serialize+fsync duration, a truncated file loads as
garbage, and old tags accumulate forever.  This module supplies the
production pieces (Megatron-LM distributed-checkpointing / Orbax-style
async checkpointing recipe — PAPERS.md, large-scale training infra):

  ``AsyncCheckpointWriter``   one daemon thread per engine; a submitted
                              save job is serialized + fsync'd + renamed
                              off the hot path.  A second submit while one
                              is in flight COALESCES (latest wins).  A
                              writer failure poisons only the pending
                              save — training continues, the next save
                              retries from a fresh snapshot.
  ``RetryPolicy``/``io_retry``  exponential backoff + jitter around every
                              checkpoint read/write; ``DS_CKPT_FAULT``
                              injects per-call failures for tests (the
                              offload tier's ``DS_OFFLOAD_H2D_DELAY_S`` /
                              ``DS_PREFETCH_DELAY_S`` fault-injection
                              style).
  ``sweep_tmp``/``retention_gc``  orphaned ``*.tmp`` cleanup and a
                              ``keep_last_n`` policy that reclaims old
                              tags only AFTER a new save verifies.
  ``install_preemption_handler``  opt-in SIGTERM hook: one final
                              synchronous save + clean ``engine.close()``
                              so a preempted pod resumes at the last
                              step instead of the last interval boundary.

Typed errors (``CheckpointCorruptError`` et al.) live here so both
``runtime.checkpointing`` and user code can catch them without import
cycles.
"""
from __future__ import annotations

import os
import random
import shutil
import signal
import threading
import time
import weakref
from typing import Callable, Iterable, NamedTuple, Optional

from ..utils.logging import log_dist, logger

CKPT_FORMAT_VERSION = 1

#: load_checkpoint status values (the three-way answer the reference
#: collapses into "got None back").
CKPT_OK = "OK"
CKPT_CORRUPT = "CORRUPT"
CKPT_MISSING = "MISSING"


class CheckpointError(Exception):
    """Base class for checkpoint integrity/availability failures."""


class CheckpointMissingError(CheckpointError):
    """An explicitly requested checkpoint does not exist on disk."""


class CheckpointCorruptError(CheckpointError):
    """A checkpoint artifact failed integrity verification (CRC/length/
    digest mismatch, unparseable manifest or meta, missing leaf file).
    The message names the offending leaf/file."""


# ---------------------------------------------------------------------------
# fault injection (tests + CPU overlaps proofs) — the unified stage plane
# ---------------------------------------------------------------------------
# The checkpoint write/read points (leaf, shard_index, manifest, meta,
# rename, latest, read) are stage ``ckpt`` in the unified chaos spec
# (runtime/stages.py, docs/stages.md): arm them with
# ``DS_STAGE_FAULT=ckpt:<point>:<n>[+]`` — or the legacy alias
# ``DS_CKPT_FAULT=<point>:<n>[+]``, kept and tested.  The thin wrappers
# below preserve this module's historical API.
from .stages import (fault_point as _stage_fault_point,
                     reset_fault_injection, spawn)  # noqa: F401 (re-export)


def fault_point(point: str, path: str = "") -> None:
    """Raise an injected transient OSError when the unified spec (or the
    ``DS_CKPT_FAULT`` alias) arms this checkpoint point's current hit
    number.  No-op (one cached dict lookup) when nothing is armed."""
    _stage_fault_point("ckpt", point, path)


# ---------------------------------------------------------------------------
# transient-I/O retry
# ---------------------------------------------------------------------------
class RetryPolicy(NamedTuple):
    """Exponential backoff + full jitter for checkpoint I/O.  ``attempts``
    is the TOTAL number of tries (1 = no retry)."""
    attempts: int = 3
    base_s: float = 0.05
    max_s: float = 2.0


DEFAULT_RETRY = RetryPolicy()


def io_retry(fn: Callable, what: str,
             policy: RetryPolicy = DEFAULT_RETRY,
             on_retry: Optional[Callable[[int, BaseException], None]] = None):
    """Run ``fn`` with up to ``policy.attempts`` tries on OSError (the
    transient class: NFS blips, GCS-fuse hiccups, injected faults).
    Non-OS errors propagate immediately — corruption is not transient."""
    attempts = max(int(policy.attempts), 1)
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except FileNotFoundError:
            # ENOENT never heals on retry (a missing leaf of a corrupt
            # checkpoint, a vanished dir): retrying only slows corruption
            # detection and pollutes logs
            raise
        except OSError as e:
            if attempt >= attempts:
                raise
            delay = min(policy.base_s * (2 ** (attempt - 1)), policy.max_s)
            delay *= 0.5 + random.random()  # full jitter
            logger.warning(
                "checkpoint I/O retry %d/%d for %s after %s: %s "
                "(backoff %.3fs)", attempt, attempts - 1, what,
                type(e).__name__, e, delay)
            if on_retry is not None:
                on_retry(attempt, e)
            if delay > 0:
                time.sleep(delay)


# ---------------------------------------------------------------------------
# async writer
# ---------------------------------------------------------------------------
class CheckpointJob(NamedTuple):
    """One fully host-resident save: ``run()`` needs no device access, no
    engine state, and no locks — everything was snapshotted (COPIED) at
    submit time, so the step loop may donate/mutate freely while the
    writer streams bytes.  ``ctx`` (optional) is the save's causal
    TraceContext: the flow opened inside the ``checkpoint/save`` span is
    terminated inside the writer's ``checkpoint/async_write`` span, so
    trace.json links the submitting step to its background write."""
    tag: str
    tmp_dir: str
    final_dir: str
    run: Callable[[], str]
    ctx: Optional[object] = None


class AsyncCheckpointWriter:
    """Single daemon writer thread with a one-slot, latest-wins queue.

    Semantics:
      - ``submit`` while a job is pending REPLACES the pending job (the
        newer snapshot supersedes it — checkpoints are snapshots of a
        monotonically advancing run, so only the latest matters);
      - a job failure is recorded (``pop_error``) and logged loudly but
        poisons ONLY that save — the writer stays alive and the next
        submit retries from a fresh snapshot;
      - ``drain`` blocks until the queue is empty and the writer idle,
        returning the last un-surfaced error (if any);
      - ``close`` drains and stops the thread (idempotent).

    ``stage`` (optional) is the engine's persistent ``ckpt_writer``
    :class:`~.stages.Stage` record: each job passes the ``job``
    injection point (``DS_STAGE_FAULT=ckpt_writer:job:n[+]``), and a
    FAILED save — after the ``ckpt`` write points' own io_retry plane
    has given up — counts against the stage's failure budget.
    Exhausting the budget degrades the stage; the ENGINE reads
    ``stage.degraded`` at save time and falls back to synchronous saves
    (async == sync bitwise, so degradation costs latency, never bytes).
    """

    def __init__(self, name: str = "ds-ckpt-writer", stage=None):
        self._name = name
        self._stage = stage
        if stage is not None:
            # flight recorder: the writer's "queue depth" is its
            # in-flight job count (racy sample read is fine — it rides
            # event records, not control flow)
            stage.depth_fn = lambda: (int(self._pending is not None)
                                      + int(self._busy is not None))
        self._cv = threading.Condition()
        self._pending: Optional[CheckpointJob] = None
        self._busy: Optional[CheckpointJob] = None
        self._last_error: Optional[BaseException] = None
        self._closed = False
        self._thread = None
        # stats (read under _cv)
        self.completed = 0
        self.failed = 0
        self.coalesced = 0
        self.last_write_s = 0.0

    # -- submission -----------------------------------------------------
    def submit(self, job: CheckpointJob) -> None:
        with self._cv:
            if self._closed:
                raise RuntimeError(f"{self._name} is closed")
            if self._pending is not None:
                self.coalesced += 1
                log_dist(
                    f"async checkpoint: save {self._pending.tag!r} "
                    f"superseded by {job.tag!r} before it started "
                    "(latest wins)", ranks=[0])
            self._pending = job
            if self._thread is None:
                self._thread = spawn(self._run, name=self._name,
                                     restarts=0)
            self._cv.notify_all()

    # -- introspection --------------------------------------------------
    def active_tmp(self) -> set:
        """tmp dirs owned by in-flight/pending jobs — including the
        ``.replaced.tmp`` park dir a publishing job may hold — the
        orphan sweep must never reclaim these."""
        with self._cv:
            live = [j for j in (self._pending, self._busy)
                    if j is not None]
            return ({j.tmp_dir for j in live}
                    | {j.final_dir + ".replaced.tmp" for j in live})

    def in_flight(self) -> bool:
        with self._cv:
            return self._pending is not None or self._busy is not None

    def pop_error(self) -> Optional[BaseException]:
        """Return-and-clear the last writer failure (the engine's
        pre-step tick surfaces it exactly once)."""
        with self._cv:
            err, self._last_error = self._last_error, None
            return err

    # -- lifecycle ------------------------------------------------------
    def drain(self, timeout: Optional[float] = None
              ) -> Optional[BaseException]:
        """Block until no job is pending or running; returns (and clears)
        the last failure so callers can decide loud-vs-fatal."""
        with self._cv:
            self._cv.wait_for(
                lambda: self._pending is None and self._busy is None,
                timeout=timeout)
            err, self._last_error = self._last_error, None
            return err

    def close(self, timeout: Optional[float] = 60.0) -> None:
        with self._cv:
            if self._closed:
                return
        err = self.drain(timeout=timeout)
        with self._cv:
            if err is not None:
                logger.error("async checkpoint writer: pending save "
                             "failed at close: %s", err)
                # re-stash so the caller's pop_error (the engine's close
                # tick) still records the lost save instead of seeing a
                # clean shutdown
                self._last_error = err
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    # -- worker ---------------------------------------------------------
    def _run(self):
        while True:
            with self._cv:
                self._cv.wait_for(
                    lambda: self._pending is not None or self._closed)
                if self._pending is None and self._closed:
                    return
                self._busy, self._pending = self._pending, None
                job = self._busy
            t0 = time.perf_counter()
            try:
                if self._stage is not None:
                    # the writer's own stage boundary (the ckpt write
                    # points inside job.run() are stage "ckpt")
                    self._stage.check("job", job.tag)
                job.run()
                with self._cv:
                    self.completed += 1
                    self.last_write_s = time.perf_counter() - t0
                if self._stage is not None:
                    self._stage.note_ok()
                    # writer drives the stage record manually (no
                    # Stage.call), so it records its own outcomes
                    self._stage.record_event(
                        "job_ok", tag=job.tag,
                        dur_s=round(time.perf_counter() - t0, 6))
            except BaseException as e:  # poison THIS save only
                logger.error(
                    "async checkpoint save %r FAILED (training continues; "
                    "the next save retries from a fresh snapshot): %s",
                    job.tag, e)
                with self._cv:
                    self.failed += 1
                    self._last_error = e
                if self._stage is not None \
                        and not self._stage.is_transient(e):
                    self._stage.record_event("job_failed", tag=job.tag,
                                             error=repr(e))
                if self._stage is not None and self._stage.is_transient(e):
                    # a failed SAVE (io_retry already exhausted inside)
                    # counts against the budget; exhausting it degrades
                    # the stage and the engine saves synchronously from
                    # then on
                    self._stage.note_failure(e)
            finally:
                with self._cv:
                    self._busy = None
                    self._cv.notify_all()


# ---------------------------------------------------------------------------
# retention GC + orphan sweep
# ---------------------------------------------------------------------------
def sweep_tmp(save_dir: str, keep: Iterable[str] = (),
              retry: RetryPolicy = DEFAULT_RETRY) -> int:
    """Remove orphaned ``*.tmp`` checkpoint dirs under ``save_dir`` — the
    debris of a crash mid-save (the old code only reclaimed a tag's tmp
    when the SAME tag was re-saved).  ``keep`` lists tmp/park dirs owned
    by a live async writer.  A ``<tag>.replaced.tmp`` park dir whose tag
    directory is MISSING is the old good copy stranded by a crash
    between the park and publish renames — it is RESTORED (renamed
    back), never deleted, so a same-tag re-save can lose the only copy
    to neither the crash nor this sweep.  Returns the number removed.
    Multi-host contract: call from process 0 only, behind the save
    barrier."""
    if not os.path.isdir(save_dir):
        return 0
    keep = {os.path.abspath(k) for k in keep}
    removed = 0
    for name in os.listdir(save_dir):
        if not name.endswith(".tmp"):
            continue
        path = os.path.join(save_dir, name)
        if not os.path.isdir(path) or os.path.abspath(path) in keep:
            continue
        if name.endswith(".replaced.tmp"):
            tag_dir = path[: -len(".replaced.tmp")]
            if not os.path.isdir(tag_dir):
                try:
                    io_retry(lambda: os.rename(path, tag_dir),
                             f"restore of parked {path}", retry)
                    logger.error(
                        "checkpoint hygiene: a crashed re-save left the "
                        "old copy parked at %s with no published "
                        "replacement — RESTORED it to %s", path, tag_dir)
                except OSError as e:
                    logger.warning("could not restore parked %s: %s",
                                   path, e)
                continue
        try:
            io_retry(lambda p=path: shutil.rmtree(p),
                     f"sweep of orphaned {path}", retry)
            removed += 1
            log_dist(f"checkpoint hygiene: removed orphaned {path} "
                     "(crashed save)", ranks=[0])
        except OSError as e:
            logger.warning("could not remove orphaned %s: %s", path, e)
    return removed


def list_tags(save_dir: str) -> list:
    """Tag directories under ``save_dir``, newest first (mtime order —
    tags are caller-chosen strings, so lexical order means nothing)."""
    if not os.path.isdir(save_dir):
        return []
    tags = []
    for name in os.listdir(save_dir):
        if name.endswith(".tmp"):
            continue
        path = os.path.join(save_dir, name)
        if os.path.isdir(path):
            try:
                tags.append((os.path.getmtime(path), name))
            except OSError:
                continue
    tags.sort(reverse=True)
    return [name for _, name in tags]


def retention_gc(save_dir: str, keep_last_n: int,
                 protect: Iterable[str] = (),
                 retry: RetryPolicy = DEFAULT_RETRY) -> int:
    """Reclaim old checkpoint tags beyond the newest ``keep_last_n``.
    ``protect`` names tags never removed regardless of age (the tag just
    written and the one ``latest`` points to).  keep_last_n <= 0 means
    unlimited (the default — retention is opt-in).  Callers run this
    only AFTER a new save verifies, never before: the fallback chain
    must always have a verified checkpoint to land on."""
    if keep_last_n <= 0:
        return 0
    tags = list_tags(save_dir)
    keep = set(tags[:keep_last_n]) | {str(p) for p in protect}
    removed = 0
    for tag in tags[keep_last_n:]:
        if tag in keep:
            continue
        path = os.path.join(save_dir, tag)
        try:
            io_retry(lambda p=path: shutil.rmtree(p),
                     f"retention GC of {path}", retry)
            removed += 1
            log_dist(f"checkpoint retention: removed {path} "
                     f"(keep_last_n={keep_last_n})", ranks=[0])
        except OSError as e:
            logger.warning("retention GC could not remove %s: %s", path, e)
    return removed


# ---------------------------------------------------------------------------
# preemption (SIGTERM) hook
# ---------------------------------------------------------------------------
class PreemptionHandler:
    """Opt-in SIGTERM hook: one final SYNCHRONOUS save + clean
    ``engine.close()`` so a preempted pod resumes at the last step, not
    the last interval boundary.  Holds the engine weakly (a dropped
    engine must stay collectable).  After the save, the previous handler
    is chained; with ``exit_after`` (the default) the default disposition
    is restored and the signal re-raised so the process still terminates
    with the expected status."""

    def __init__(self, engine, save_dir: Optional[str] = None,
                 tag: Optional[str] = None, exit_after: bool = True,
                 signals=(signal.SIGTERM,)):
        self._engine_ref = weakref.ref(engine)
        self.save_dir = save_dir
        self.tag = tag
        self.exit_after = exit_after
        self._signals = tuple(signals)
        self._prev = {}
        self._fired = False
        self._installed = False
        try:
            for sig in self._signals:
                self._prev[sig] = signal.signal(sig, self._handle)
            self._installed = True
        except ValueError:
            # signal handlers can only be installed from the main thread
            logger.warning(
                "preemption handler NOT installed (engine constructed off "
                "the main thread); call install_preemption_handler from "
                "the main thread instead")

    @property
    def installed(self) -> bool:
        return self._installed

    @property
    def fired(self) -> bool:
        return self._fired

    def _handle(self, signum, frame):
        if self._fired:
            # the preemption save already ran; later signals must not be
            # silently swallowed (an orchestrator escalating SIGTERMs
            # would otherwise need SIGKILL): behave as if uninstalled —
            # chain a callable prev, else restore the old disposition
            # and re-deliver so the default action applies
            prev = self._prev.get(signum)
            if callable(prev):
                prev(signum, frame)
            else:
                self.uninstall()
                os.kill(os.getpid(), signum)
            return
        if not self._installed:
            # uninstalled while sandwiched in a handler chain (a later
            # handler holds us as ITS previous): stay inert, keep the
            # chain intact
            prev = self._prev.get(signum)
            if callable(prev):
                prev(signum, frame)
            return
        eng0 = self._engine_ref()
        if eng0 is not None and getattr(eng0, "_in_step", False):
            # the signal interrupted train_batch mid-update (Python
            # handlers run on the main thread at an arbitrary bytecode):
            # saving NOW could checkpoint a torn, half-applied optimizer
            # state with valid CRCs.  Park on the engine; train_batch's
            # finally block calls complete_deferred() at the step
            # boundary, where the state is consistent.
            self._deferred_signum = signum
            eng0._deferred_preempt = self
            log_dist(
                "SIGTERM mid-step: deferring the preemption save to "
                "this step's boundary", ranks=[0])
            return
        self._fired = True
        eng = self._engine_ref()
        if eng is not None:
            # post-mortem first: the preemption save below can itself
            # fail, and the flight record explains the run's last
            # moments either way (dump_flight_record never raises)
            dump = getattr(eng, "dump_flight_record", None)
            if dump is not None:
                dump(reason=f"SIGTERM preemption (signal {signum})")
            save_dir = self.save_dir or getattr(
                eng, "_ckpt_last_save_dir", None)
            if save_dir:
                log_dist(
                    f"SIGTERM: preemption save to {save_dir} at step "
                    f"{getattr(eng, 'global_steps', '?')}", ranks=[0])
                try:
                    eng.save_checkpoint(save_dir, tag=self.tag,
                                        async_write=False)
                except Exception as e:
                    logger.error("preemption save FAILED: %s", e)
            else:
                logger.warning(
                    "SIGTERM: no checkpoint save_dir known (no prior "
                    "save_checkpoint and no checkpoint.save_dir config); "
                    "closing without a final save")
            try:
                eng.close()
            except Exception as e:
                logger.error("engine.close() during preemption: %s", e)
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)
        elif self.exit_after:
            self.uninstall()
            os.kill(os.getpid(), signum)

    def complete_deferred(self):
        """Run the parked preemption save at the step boundary (called by
        ``train_batch``'s finally block once ``_in_step`` clears)."""
        self._handle(getattr(self, "_deferred_signum", signal.SIGTERM),
                     None)

    def uninstall(self):
        if not self._installed:
            return
        self._installed = False
        try:
            for sig, prev in self._prev.items():
                # restore ONLY if we are still the active handler: blindly
                # writing our stored prev would clobber any handler
                # installed on top of us (e.g. a second engine's hook,
                # which would silently revert SIGTERM to the default
                # kill).  When sandwiched, we go inert instead — _handle
                # passes through to prev.
                if signal.getsignal(sig) == self._handle:
                    signal.signal(sig, prev)
        except ValueError:
            pass


def install_preemption_handler(engine, save_dir: Optional[str] = None,
                               tag: Optional[str] = None,
                               exit_after: bool = True) -> PreemptionHandler:
    """Install the SIGTERM preemption hook for ``engine``; returns the
    handler (``.uninstall()`` removes it — ``engine.close()`` does this
    automatically for the config-installed one)."""
    return PreemptionHandler(engine, save_dir=save_dir, tag=tag,
                             exit_after=exit_after)
