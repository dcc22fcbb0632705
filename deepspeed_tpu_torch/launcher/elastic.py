"""Elastic restart supervisor — ``ds_torch --elastic`` (docs/elastic.md;
a copy of ``deepspeed_tpu/launcher/elastic.py``).

The reference launcher is fire-and-forget: a dead worker takes the job
down and a human relaunches it.  This module closes ROADMAP item 2's
"multi-day run on preemptible pods" loop: the supervisor launches the
job, watches worker exits AND per-host heartbeats (a host can hang with
its process alive — wedged collective, dead NIC), and on failure kills
the remnants, **re-probes the hosts**, re-forms the world from the
survivors at the reduced width, and relaunches.  The relaunched run
resumes from the newest VERIFIED checkpoint tag via the existing
fallback chain (``load_checkpoint(tag=None)`` walks corrupt/vanished
tags back — runtime/resilience.py), and the reshard-on-load checkpoint
format makes the dp-width change free; the data-iterator plane makes
the resume sample-exact.

Restart discipline: bounded attempts with exponential backoff, and a
typed :class:`ElasticGiveUpError` when the budget is exhausted or the
surviving world is smaller than ``min_slots`` — a supervisor that
retries forever against a dead cluster is worse than one that fails
loudly.

The supervisor itself is deliberately free of the worker runtime (it
imports only stdlib + the heartbeat reader, no torch): it must keep
running when the worker runtime is the thing that is broken.  One
``launch_fn`` handle is one host's per-node launcher, which forks that
host's ranks; the heartbeat files are keyed by rank.
"""
from __future__ import annotations

import collections
import subprocess
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

from ..telemetry.heartbeat import StragglerMonitor, read_heartbeats
from ..utils.logging import logger
from .supervise import (backoff_delay, dump_supervisor_flightrec,
                        sweep_heartbeat_files, terminate_with_grace)

#: env vars the supervisor exports to every worker attempt: the attempt
#: number, and the attempt's world size (the ranks' WORLD_SIZE)
ELASTIC_RESTART_ENV = "DS_ELASTIC_RESTART"
ELASTIC_SLOTS_ENV = "DS_ELASTIC_WORLD_SLOTS"

#: probe_fn return sentinel: host alive, keep its current slots
KEEP_SLOTS = True


class ElasticGiveUpError(RuntimeError):
    """The supervisor is out of options: restart budget exhausted, or
    the surviving world fell below ``min_slots``.  Carries the restart
    count and the last failure reason so orchestrators can act on it."""

    def __init__(self, message: str, restarts: int = 0,
                 last_failure: str = ""):
        super().__init__(message)
        self.restarts = restarts
        self.last_failure = last_failure


class RestartPolicy(NamedTuple):
    """Bounded-restart discipline.  ``max_restarts`` counts RELAUNCHES
    (0 = one attempt, never restart); backoff is exponential from
    ``backoff_base_s``, capped at ``backoff_max_s``.  ``min_slots`` is
    the smallest total card count worth resuming at — below it the
    supervisor gives up instead of limping (a dp1 "fleet" resuming a
    dp512 run is usually a paging alert, not a training run)."""
    max_restarts: int = 3
    backoff_base_s: float = 1.0
    backoff_max_s: float = 60.0
    min_slots: int = 1


class ElasticSupervisor:
    """Launch → watch (exits + heartbeats) → kill → re-probe → re-form →
    relaunch, bounded by a :class:`RestartPolicy`.

    ``resources``  {host: [slot, ...]} — the initial active world
                   (hostfile order preserved; it IS the rank order).
    ``launch_fn``  (active_resources, attempt) -> [(host, Popen), ...]
                   — starts one worker process handle per host.  The
                   supervisor owns the handles from then on.
    ``probe_fn``   host -> None (dead) | True (alive, keep slots) |
                   [slot, ...] (alive at a CHANGED slot set — partial
                   card loss).  Called only between attempts.
    ``heartbeat_dir`` / ``heartbeat_timeout_s`` — liveness: a host
                   whose newest beat is older than the timeout while
                   the job still runs is HUNG; the attempt is killed
                   and restarted (the stale host must then fail its
                   probe to be dropped — hung-but-probeable hosts get
                   another chance at the reduced backoff cost).
                   Stragglers (slow, not dead) are logged via
                   :class:`StragglerMonitor`, never killed here —
                   killing on slowness is an operator policy, not a
                   supervisor default.
    """

    def __init__(self, resources: Dict[str, List[int]],
                 launch_fn: Callable[[Dict[str, List[int]], int],
                                     List[Tuple[str, subprocess.Popen]]],
                 probe_fn: Optional[Callable[[str], object]] = None,
                 policy: RestartPolicy = RestartPolicy(),
                 heartbeat_dir: Optional[str] = None,
                 heartbeat_timeout_s: float = 0.0,
                 straggler_ratio: float = 2.0,
                 poll_interval_s: float = 0.2,
                 term_grace_s: float = 10.0,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 remote_kill_fn: Optional[Callable[[str], None]] = None):
        if not resources:
            raise ValueError("elastic supervisor needs a non-empty "
                             "resource pool")
        self.active: Dict[str, List[int]] = collections.OrderedDict(
            (h, list(s)) for h, s in resources.items())
        self.launch_fn = launch_fn
        self.probe_fn = probe_fn if probe_fn is not None else (
            lambda host: KEEP_SLOTS)
        self.policy = policy
        self.heartbeat_dir = heartbeat_dir
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.poll_interval_s = float(poll_interval_s)
        self.term_grace_s = float(term_grace_s)
        # sleep_fn virtualizes the BACKOFF waits (the test seam); the
        # _watch poll uses real time — Popen.poll and heartbeat mtimes
        # advance on the wall clock, not a fake one
        self.sleep_fn = sleep_fn
        self.remote_kill_fn = remote_kill_fn
        self._straggler = StragglerMonitor(
            ratio=straggler_ratio,
            stale_after_s=max(heartbeat_timeout_s, 1.0))
        self.restarts = 0  # relaunches performed so far
        #: supervisor-side flight recorder (docs/observability.md):
        #: bounded ring of launch/failure/probe events, dumped as
        #: flightrec_supervisor.json on ElasticGiveUpError so the
        #: post-mortem survives the dead fleet.  Kept torch-free (no
        #: telemetry hub import) — same schema, written inline.
        self.events: collections.deque = collections.deque(maxlen=256)

    def _record(self, kind: str, **fields) -> None:
        ev = {"t": time.time(), "kind": kind}
        ev.update(fields)
        self.events.append(ev)

    def _dump_flight_record(self, reason: str, error: str) -> None:
        dump_supervisor_flightrec(
            self.heartbeat_dir, supervisor="supervisor", reason=reason,
            error=error, restarts=self.restarts,
            max_restarts=self.policy.max_restarts,
            fallback="give up (typed ElasticGiveUpError)",
            events=self.events,
            extra={"active_world": {h: list(s) for h, s
                                    in self.active.items()}})

    # -- policy helpers -------------------------------------------------
    def total_slots(self) -> int:
        return sum(len(s) for s in self.active.values())

    def _check_viable(self, last_failure: str) -> None:
        slots = self.total_slots()
        if not self.active or slots < self.policy.min_slots:
            msg = (
                f"elastic: surviving world has {slots} slot(s) across "
                f"{len(self.active)} host(s), below min_slots="
                f"{self.policy.min_slots} — giving up after "
                f"{self.restarts} restart(s); last failure: "
                f"{last_failure or 'n/a'}")
            self._record("give_up", error=msg)
            self._dump_flight_record("ElasticGiveUpError: world below "
                                     "min_slots", msg)
            raise ElasticGiveUpError(msg, restarts=self.restarts,
                                     last_failure=last_failure)

    # -- the run loop ---------------------------------------------------
    def run(self) -> int:
        """Supervise until a clean exit (returns 0) or a typed give-up.
        Every relaunch resumes from the newest verified tag via the
        worker's own ``load_checkpoint(tag=None)`` fallback chain."""
        last_failure = ""
        while True:
            self._sweep_heartbeats()
            logger.info(
                "elastic: launching attempt %d on %d host(s) / %d "
                "slot(s): %s", self.restarts, len(self.active),
                self.total_slots(),
                ", ".join(f"{h}:{len(s)}"
                          for h, s in self.active.items()))
            self._record("launch", attempt=self.restarts,
                         hosts=len(self.active),
                         slots=self.total_slots())
            procs = self.launch_fn(self.active, self.restarts)
            rc, reason = self._watch(procs)
            if rc == 0:
                logger.info("elastic: job completed cleanly after %d "
                            "restart(s)", self.restarts)
                return 0
            last_failure = reason
            self._record("failure", attempt=self.restarts, rc=rc,
                         error=reason)
            logger.warning("elastic: attempt %d FAILED: %s",
                           self.restarts, reason)
            if self.restarts >= self.policy.max_restarts:
                msg = (f"elastic: giving up after {self.restarts} "
                       f"restart(s) (max_restarts="
                       f"{self.policy.max_restarts}); last failure: "
                       f"{reason}")
                self._record("give_up", error=msg)
                self._dump_flight_record(
                    "ElasticGiveUpError: restart budget exhausted", msg)
                raise ElasticGiveUpError(msg, restarts=self.restarts,
                                         last_failure=reason)
            self.restarts += 1
            self._reprobe()
            self._check_viable(last_failure)
            delay = backoff_delay(self.policy.backoff_base_s,
                                  self.policy.backoff_max_s,
                                  self.restarts)
            logger.info("elastic: backing off %.1fs before relaunch "
                        "(attempt %d/%d)", delay, self.restarts,
                        self.policy.max_restarts)
            if delay > 0:
                self.sleep_fn(delay)

    # -- one attempt ----------------------------------------------------
    def _watch(self, procs) -> Tuple[Optional[int], str]:
        """Poll worker exits and heartbeats until the attempt resolves:
        (0, "") on a fully clean exit; (rc/None, reason) on any worker
        failure or missed heartbeats — the remnants are killed first,
        so a half-dead job can never wedge a barrier forever."""
        while True:
            states = [(host, p, p.poll()) for host, p in procs]
            failed = [(h, rc) for h, _, rc in states
                      if rc is not None and rc != 0]
            if failed:
                self._kill(procs)
                host, rc = failed[0]
                return rc, (f"worker on {host} exited rc={rc}"
                            + (f" (+{len(failed) - 1} more)"
                               if len(failed) > 1 else ""))
            if all(rc == 0 for _, _, rc in states):
                return 0, ""
            # staleness applies only while EVERY worker still runs: once
            # one exits 0 the job is in its shutdown skew window (e.g.
            # rank 0 writing the final checkpoint after the others left)
            # and the finished workers' beats going stale is healthy,
            # not a hang
            stale = ([] if any(rc == 0 for _, _, rc in states)
                     else self._heartbeat_check())
            if stale:
                self._kill(procs)
                return None, ("missed heartbeats from "
                              + ", ".join(stale)
                              + f" (> {self.heartbeat_timeout_s:.0f}s "
                              "stale; host hung)")
            time.sleep(self.poll_interval_s)

    def _heartbeat_check(self) -> List[str]:
        """Hosts whose newest beat went stale (only hosts that have
        beaten at least once this attempt — the dir is swept before
        each launch, and startup/compile time must not count)."""
        if not self.heartbeat_dir or self.heartbeat_timeout_s <= 0:
            return []
        beats = read_heartbeats(self.heartbeat_dir)
        if not beats:
            return []
        rep = self._straggler.update(beats)
        if rep["new_stragglers"]:
            logger.warning(
                "elastic: straggler(s) %s — step time > %.1fx the fleet "
                "median of %.3fs (not killing; straggler policy is the "
                "operator's)", ", ".join(rep["new_stragglers"]),
                self._straggler.ratio, rep["median_step_s"] or 0.0)
        now = time.time()
        return sorted(k for k, r in beats.items()
                      if now - float(r.get("time", 0))
                      > self.heartbeat_timeout_s)

    def _kill(self, procs) -> None:
        """SIGTERM → grace → SIGKILL + remote cleanup, via the shared
        supervision helper (launcher/supervise.py)."""
        terminate_with_grace(procs, self.term_grace_s,
                             remote_kill_fn=self.remote_kill_fn)

    def _sweep_heartbeats(self) -> None:
        sweep_heartbeat_files(self.heartbeat_dir)

    def _reprobe(self) -> None:
        """Re-form the world from the hosts that still answer: dead
        hosts drop out (the relaunch shrinks dp), resized hosts keep
        their surviving slots.  Order is preserved — it IS rank order,
        and the new rank-0 host becomes the coordinator."""
        survivors = collections.OrderedDict()
        for host, slots in self.active.items():
            try:
                r = self.probe_fn(host)
            except Exception as e:
                logger.warning("elastic: probe of %s raised %s — "
                               "treating as dead", host, e)
                r = None
            if r is None or r is False:
                logger.warning("elastic: host %s failed its probe — "
                               "dropped from the world", host)
                continue
            if isinstance(r, (list, tuple)):
                new_slots = [int(x) for x in r]
                if new_slots != slots:
                    logger.warning(
                        "elastic: host %s resized %d -> %d slot(s)",
                        host, len(slots), len(new_slots))
                survivors[host] = new_slots
            else:
                survivors[host] = slots
        self.active = survivors
