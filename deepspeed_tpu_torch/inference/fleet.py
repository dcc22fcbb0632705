"""Serving fleet: router + replicated ServeEngines + SLO autoscaling
(docs/serving.md "serving fleet"; a port of
``deepspeed_tpu/inference/fleet.py`` whose replicas are the port's
engines, on the card unless the router is given ``device="cpu"``).

One ``ServeEngine`` process is the ceiling on everything the serving
PRs bought: paged KV, speculation and int8 multiplied PER-CHIP
capacity, but aggregate throughput was still one process wide and a
single poison killed every in-flight user.  This module is the front
door over N of them:

  ``FleetRouter``   a router/supervisor that does no device work (the
                    ``launcher/elastic.py`` idiom, shared machinery in
                    ``launcher/supervise.py``) that spawns N replica
                    subprocesses (``python -m
                    deepspeed_tpu_torch.inference.replica`` — each an
                    ordinary ServeEngine on the stage runtime), admits
                    requests **join-shortest-queue** over each
                    replica's heartbeat gauges
                    (``telemetry/heartbeat.py`` payloads extended with
                    ``serve_active_slots``, request-queue depth,
                    ``serve_free_pages``), **fails over**
                    queued-but-unstarted requests when a replica dies
                    or poisons (requests whose tokens already started
                    streaming fail typed :class:`ReplicaFailure` — a
                    half-streamed answer must never be silently
                    retried into a duplicate; the replica's flight
                    recorder captures the corpse), and **autoscales**:
                    a queue-wait p99 breach of ``fleet.slo_p99_s``
                    sustained for ``scale_up_window_s`` spawns a
                    replica, sustained slack retires one, both clamped
                    to ``[min_replicas, max_replicas]`` with every
                    scale event resetting both hysteresis clocks (no
                    flapping inside a window).

Transport is the minimal length-prefixed socket protocol of
``inference/wire.py`` — the router imports stdlib + the heartbeat
reader + the shared supervision helpers, nothing that needs a working
accelerator runtime: it must keep routing when a replica's runtime is
the thing that is broken.

Supervision discipline (the elastic supervisor's, reused): replica
respawns back off exponentially, and ``fleet.max_restarts``
CONSECUTIVE replica failures without a single request completing in
between raise the typed :class:`FleetGiveUpError` (progress resets the
budget — a fleet serving for days must not die on an isolated blip),
with a ``flightrec_supervisor.json`` post-mortem next to the heartbeat
files for ``python -m deepspeed_tpu_torch.telemetry diagnose
<fleet_dir>``.

The router is single-threaded by design: every state change happens
inside :meth:`FleetRouter.poll` (called by ``run_until_idle`` /
``FleetRequest.result``), so the JSQ/failover/autoscale logic needs no
locks and stays deterministic under test — and JL007 (no stray daemon
threads) holds without exemptions.

Disaggregated prefill/decode (``fleet.roles``, docs/serving.md
"disaggregated fleet"): with a ``roles`` map the fleet specializes by
phase — admissions steer to ``prefill``/``mixed`` replicas, and when a
prefill-role replica finishes a request's prefill (one token,
``detach_kv``) its KV pages migrate over binary wire frames to a
``decode``/``mixed`` replica that adopts the request mid-stream.  The
router is the custody ledger: a request's KV blob is owned by exactly
one of {prefill replica, router, decode replica} at any instant, every
transition is an ``events.jsonl`` ``migration`` record, and a replica
death at ANY phase loses zero requests — prefill-phase deaths requeue
the request unstarted (its first token was never surrendered to the
caller), router-custody blobs re-dispatch to another decode replica,
and decode-phase deaths follow the existing started-request
:class:`ReplicaFailure` semantics.  Autoscaling splits per role:
prefill defends TTFT (``fleet.slo_ttft_s``, admission-wait signal),
decode defends TPOT (``fleet.slo_tpot_s``, the ``serve_tpot_p99_s``
heartbeat gauge + migration backlog), each with its own hysteresis
clocks.  Without ``roles`` every path below is the homogeneous fleet.
"""
from __future__ import annotations

import dataclasses
import json
import os
import select
import socket
import subprocess
import sys
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

from ..config.config import DeepSpeedFleetConfig
from ..launcher.supervise import (backoff_delay, dump_supervisor_flightrec,
                                  sweep_heartbeat_files,
                                  terminate_with_grace)
from ..telemetry.heartbeat import read_heartbeats
from ..utils.logging import logger
from .wire import (BinaryFrame, FrameReader, drain_socket,
                   send_binary_frame, send_frame)

#: scale-down hysteresis factor: slack means p99 under THIS fraction of
#: the SLO (or no waiters at all) — retiring at 0.99×SLO would flap
SLACK_FACTOR = 0.5

#: an accepted connection must say hello within this window or it is
#: dropped (a port scanner must not hold a router slot)
HELLO_TIMEOUT_S = 10.0

#: per-frame send/recv timeout on an attached replica socket — a peer
#: that can't take a submit frame for this long is hung, not busy
SOCK_TIMEOUT_S = 10.0

#: wall seconds between heartbeat-directory reads (beats refresh the
#: JSQ gauges and liveness; re-reading every poll would be fs spam)
HEARTBEAT_READ_INTERVAL_S = 0.2

#: wall seconds between metrics records in the fleet events.jsonl
#: (per-replica heartbeat_age_s + queue gauges)
METRICS_INTERVAL_S = 1.0


class FleetGiveUpError(RuntimeError):
    """The router is out of options: ``fleet.max_restarts`` consecutive
    replica failures with no completed request in between.  Carries the
    failure count and last reason so orchestrators can act on it."""

    def __init__(self, message: str, restarts: int = 0,
                 last_failure: str = ""):
        super().__init__(message)
        self.restarts = restarts
        self.last_failure = last_failure


class ReplicaFailure(RuntimeError):
    """A replica died (exit/poison/hang) mid-stream: the request's
    tokens had already started streaming, so failover would re-emit
    them as a duplicate answer — it fails typed instead.  Queued-but-
    unstarted requests on the same replica are failed over, never
    failed."""

    def __init__(self, message: str, replica: int = -1):
        super().__init__(message)
        self.replica = replica


class FleetClosedError(RuntimeError):
    """The router was closed with this request still in flight."""


@dataclasses.dataclass
class FleetRequest:
    """One generation request's router-side lifecycle record."""
    rid: int
    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int]
    submit_t: float = 0.0
    tokens: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None
    error: Optional[BaseException] = None
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    #: current replica assignment (None = queued at the router)
    replica: Optional[int] = None
    #: True once the first token frame arrived — the failover boundary:
    #: started requests fail typed, unstarted ones re-dispatch
    started: bool = False
    #: tenant LoRA adapter id (0 = base model) — steers tenant
    #: affinity in :meth:`FleetRouter._pick_replica` and rides the
    #: submit frame to the replica engine
    adapter_id: int = 0
    failovers: int = 0
    queue_wait_s: Optional[float] = None
    ttft_s: Optional[float] = None
    #: True once dispatched to a prefill-role replica with the migrate
    #: flag — this request will change replicas mid-stream.  The first
    #: token a PREFILL replica streams does NOT flip ``started``: until
    #: the decode replica takes custody, a death anywhere on the
    #: migration path requeues the request from scratch (the caller
    #: never saw the token, so there is no duplicate-answer hazard).
    migrated: bool = False
    prefill_replica: Optional[int] = None
    decode_replica: Optional[int] = None
    #: router-custody KV blob: (migrate_out header, [page payloads]) —
    #: held from blob completion until the decode replica streams, so a
    #: decode-replica death before its first token re-sends the blob
    _migration: Optional[tuple] = dataclasses.field(
        default=None, repr=False)
    _router: Optional["FleetRouter"] = dataclasses.field(
        default=None, repr=False)

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Pump the (single-threaded) router until this request
        finishes; raises its error if it failed — the typed
        :class:`ReplicaFailure` / :class:`FleetClosedError` /
        replica-reported exception."""
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        while not self.done.is_set():
            r = self._router
            if r is None or r._closed:
                if not self.done.wait(timeout=0.0):
                    raise FleetClosedError(
                        f"request {self.rid} abandoned: router closed")
                break
            r.poll(0.02)
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"request {self.rid} not finished after {timeout}s")
        if self.error is not None:
            raise self.error
        return list(self.tokens)


class _Replica:
    """Router-side record of one replica incarnation.  States:
    ``starting`` (spawned, no hello yet) → ``ready`` (serving) →
    ``draining`` (retiring: no new work, finish what it holds) →
    removed.  A replica id is never reused — heartbeat files and
    telemetry dirs stay unambiguous across respawns."""

    def __init__(self, rid: int, proc, spawned_t: float,
                 role: str = "mixed"):
        self.id = rid
        self.proc = proc
        self.spawned_t = spawned_t
        self.role = role
        self.state = "starting"
        self.sock: Optional[socket.socket] = None
        self.reader: Optional[FrameReader] = None
        self.outstanding: "OrderedDict[int, FleetRequest]" = OrderedDict()
        #: in-flight migrate_out receptions: rid → {"header", "pages"}
        #: (custody still THIS replica's until the last page lands — a
        #: death mid-blob discards the partial and requeues the rid)
        self.migrating: Dict[int, dict] = {}
        self.shutdown_sent = False
        #: wall time the replica went ready — the staleness clock's
        #: floor for a replica whose beats never land (beat writes
        #: degrade silently by design: disk full, unwritable dir)
        self.ready_wall_t: Optional[float] = None


def _p99(vals: List[float]) -> Optional[float]:
    """Linear-interpolated p99 — the telemetry CLI's one percentile
    implementation (cli.py is itself pure stdlib, and the heartbeat
    import above already pulls the telemetry package, so this adds
    nothing to the router's import surface)."""
    from ..telemetry.cli import _percentile
    return _percentile(sorted(vals), 0.99)


class FleetRouter:
    """The serving fleet's front door — see the module docstring.

    ``config``    dict / path to a ds_config.json with a ``fleet``
                  block (plus the ``serving`` / ``fleet_model`` blocks
                  the replica entrypoint reads).  A dict is persisted
                  to ``<fleet_dir>/fleet_config.json`` so subprocess
                  replicas can load it.
    ``fleet_dir`` the fleet's shared directory: replica heartbeats,
                  the router's ``events.jsonl`` (per-request completion
                  records, scale events, per-replica
                  ``heartbeat_age_s{replica=...}`` metrics), per-
                  replica telemetry subdirs (``replica_<id>/`` — where
                  a poisoned replica's flight recorder lands), and the
                  give-up post-mortem.
    ``spawn_fn``  (replica_id, attempt) -> Popen-like handle — the test
                  seam (the elastic ``launch_fn`` idiom).  Default
                  spawns ``python -m
                  deepspeed_tpu_torch.inference.replica`` inheriting the
                  router's environment (so ``DS_STAGE_DELAY_S`` chaos
                  specs reach every replica).
    ``now_fn``    monotonic clock for queue-wait/autoscale timing (the
                  test seam for hysteresis-window tests).
    ``device``    the replicas' torch device: None is the card
                  (``--device cuda``; a replica with no CUDA device
                  raises), ``"cpu"`` serves on the CPU.
    """

    def __init__(self, config, fleet_dir: str,
                 spawn_fn=None, now_fn=time.monotonic, device=None):
        if isinstance(config, str):
            self._config_path = config
            with open(config) as f:
                cfg_dict = json.load(f)
        elif isinstance(config, dict):
            cfg_dict = config
            self._config_path = os.path.join(fleet_dir,
                                             "fleet_config.json")
        else:
            raise TypeError(
                "FleetRouter config must be a dict or a path to a "
                f"ds_config.json, got {type(config).__name__}")
        self.cfg = DeepSpeedFleetConfig(cfg_dict)
        self.device = "cuda" if device is None else str(device)
        self.fleet_dir = fleet_dir
        os.makedirs(fleet_dir, exist_ok=True)
        if isinstance(config, dict):
            with open(self._config_path, "w") as f:
                json.dump(cfg_dict, f)
        self._now = now_fn
        self.spawn_fn = spawn_fn if spawn_fn is not None \
            else self._spawn_subprocess

        self._listen = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listen.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listen.bind(("127.0.0.1", 0))
        self._listen.listen(16)
        self._listen.setblocking(False)
        self.addr = self._listen.getsockname()

        self.replicas: Dict[int, _Replica] = {}
        #: accepted connections awaiting their hello frame
        self._greeting: List[tuple] = []
        self._queue: deque = deque()          # unassigned FleetRequests
        self._reqs: Dict[int, FleetRequest] = {}
        self._next_rid = 0
        self._next_replica_id = 0
        #: (now_fn timestamp, queue_wait_s) admission samples — the SLO
        #: signal the autoscaler and the bench's p99 read
        self._wait_samples: deque = deque()
        self._breach_since: Optional[float] = None
        self._slack_since: Optional[float] = None
        #: router-custody requests awaiting a decode replica: the KV
        #: blob arrived in full but no decode/mixed replica could take
        #: it yet (or its decode replica died pre-stream)
        self._migrate_queue: deque = deque()
        #: per-role replica targets (disaggregated fleets only): the
        #: supervision floor AND the autoscaler's moving setpoint —
        #: scale-up bumps a role's target, scale-down lowers it (never
        #: below 1: a role's last replica wedges its whole phase)
        self._role_target: Dict[str, int] = (
            dict(self.cfg.roles) if self.cfg.roles else {})
        self._breach_since_role: Dict[str, float] = {}
        self._slack_since_role: Dict[str, float] = {}
        #: role handed to the NEXT spawn_fn call (the spawn_fn seam
        #: keeps its (replica_id, attempt) signature)
        self._spawn_role = "mixed"
        self.migrations = 0
        self._started_t: Optional[float] = None
        #: consecutive replica failures with no completed request in
        #: between (the give-up budget); ``restarts`` counts every
        #: failure episode over the router's lifetime (never reset)
        self._consec_failures = 0
        self.restarts = 0
        #: killed-but-not-yet-reaped replica processes: _fail_replica
        #: must never block the poll loop on a wedged process — it
        #: SIGKILLs and parks the corpse here for async reaping
        self._reaping: List[tuple] = []
        self._last_failure = ""
        self._next_spawn_t = 0.0
        self._beats: Dict[int, dict] = {}
        self._last_beats_read = 0.0
        self._last_metrics_write = 0.0
        self._closed = False
        self._gave_up = False
        #: bounded event ring for the give-up flight record
        self.events: deque = deque(maxlen=256)
        self._records = open(os.path.join(fleet_dir, "events.jsonl"),
                             "a", buffering=1)

    # -- records + events ------------------------------------------------
    def _record(self, kind: str, **fields) -> None:
        self.events.append({"t": time.time(), "kind": kind, **fields})
        try:
            rec = {"kind": kind, "t": time.time()}
            rec.update(fields)
            self._records.write(json.dumps(rec, default=repr) + "\n")
        except (OSError, ValueError):
            pass  # a full disk must not take the router down

    def _write_request_record(self, fr: FleetRequest) -> None:
        # arrival_s: submit time relative to the router's start — the
        # open-loop schedule, reconstructible from the ledger alone
        # (telemetry/goodput.py; readers tolerate pre-PR-17 records
        # without it)
        epoch = self._started_t if self._started_t is not None \
            else fr.submit_t
        self._record(
            "fleet_request", rid=fr.rid, replica=fr.replica,
            arrival_s=round(fr.submit_t - epoch, 6),
            tokens=len(fr.tokens), finish_reason=fr.finish_reason,
            error=repr(fr.error) if fr.error is not None else None,
            queue_wait_s=fr.queue_wait_s, ttft_s=fr.ttft_s,
            total_s=self._now() - fr.submit_t,
            failovers=fr.failovers, started=fr.started,
            migrated=fr.migrated, prefill_replica=fr.prefill_replica,
            decode_replica=fr.decode_replica)

    def _write_metrics(self) -> None:
        """Per-replica liveness made operator-visible: the same
        ``{"kind": "metrics"}`` record shape the telemetry hub writes,
        so ``summarize``'s liveness row and ``diagnose`` read fleet
        events.jsonl unchanged."""
        now_wall = time.time()
        metrics = []
        for rep in self.replicas.values():
            beat = self._beats.get(rep.id)
            age = (max(0.0, now_wall - float(beat.get("time", 0.0)))
                   if beat else None)
            metrics.append({
                "name": "heartbeat_age_s",
                "labels": {"replica": str(rep.id),
                           "host": f"replica_{rep.id}",
                           "state": rep.state,
                           "role": rep.role},
                "value": age})
        metrics.append({"name": "fleet_queue_depth", "labels": {},
                        "value": len(self._queue)
                        + len(self._migrate_queue)})
        metrics.append({"name": "fleet_live_replicas", "labels": {},
                        "value": len(self._live())})
        self._record("metrics", metrics=metrics)

    # -- spawn / probe ---------------------------------------------------
    def spawn_argv(self, replica_id: int) -> List[str]:
        """The replica command line: ``python -m
        deepspeed_tpu_torch.inference.replica`` with this router's
        address, the fleet dir, the config, the role of the next spawn
        and the replicas' device."""
        return [sys.executable, "-m",
                "deepspeed_tpu_torch.inference.replica", "--router", f"{self.addr[0]}:{self.addr[1]}",
                "--replica-id", str(replica_id),
                "--fleet-dir", self.fleet_dir,
                "--config", self._config_path,
                "--role", self._spawn_role,
                "--device", self.device]

    def _spawn_subprocess(self, replica_id: int, attempt: int):
        """The production spawn: one ``inference.replica`` subprocess,
        env inherited (chaos specs) with this package's parent directory
        put first on ``PYTHONPATH``, stdout/stderr to
        ``replica_<id>.log`` in the fleet dir."""
        log_path = os.path.join(self.fleet_dir,
                                f"replica_{replica_id}.log")
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in (env.get("PYTHONPATH") or "").split(
                os.pathsep) if p])
        with open(log_path, "ab") as log:
            return subprocess.Popen(self.spawn_argv(replica_id), stdout=log,
                                    stderr=subprocess.STDOUT, env=env)

    def _live(self) -> List[_Replica]:
        """Replicas that count toward the autoscale clamps: starting or
        serving (a draining replica is already on its way out)."""
        return [r for r in self.replicas.values()
                if r.state in ("starting", "ready")]

    def _spawn(self, reason: str,
               role: str = "mixed") -> Optional[_Replica]:
        now = self._now()
        if now < self._next_spawn_t:
            return None
        rid = self._next_replica_id
        self._next_replica_id += 1
        self._spawn_role = role
        try:
            # attempt = the current consecutive-failure count, so a
            # spawn_fn varying behavior by attempt (the test seam)
            # sees retries as retries
            proc = self.spawn_fn(rid, self._consec_failures)
        except Exception as e:
            self._note_replica_failure(f"spawn of replica {rid} "
                                       f"raised: {e!r}")
            return None
        rep = _Replica(rid, proc, now, role=role)
        self.replicas[rid] = rep
        self._record("spawn", replica=rid, reason=reason, role=role,
                     live=len(self._live()))
        logger.info("fleet: spawned replica %d (%s, %s), %d live", rid,
                    reason, role, len(self._live()))
        return rep

    def _role_deficit(self) -> Optional[str]:
        """First role (fixed order — deterministic) whose live count
        sits below its target; None when the fleet stands at width."""
        for role in ("prefill", "decode", "mixed"):
            tgt = self._role_target.get(role, 0)
            if tgt and sum(1 for r in self._live()
                           if r.role == role) < tgt:
                return role
        return None

    def start(self, wait_ready: bool = True) -> "FleetRouter":
        """Launch the configured initial replicas; with ``wait_ready``
        pump until every one said hello (spawn failures ride the
        backoff/give-up discipline inside :meth:`poll`)."""
        self._started_t = self._now()
        sweep_heartbeat_files(self.fleet_dir)
        if self.cfg.roles:
            for role in ("prefill", "decode", "mixed"):
                for _ in range(self._role_target.get(role, 0)):
                    self._spawn("initial", role)
        else:
            for _ in range(self.cfg.replicas):
                self._spawn("initial")
        while wait_ready and not self._closed:
            if self.cfg.roles:
                missing = self._role_deficit()
                if missing is not None:
                    self._spawn("initial", missing)
                elif all(r.state == "ready" for r in self._live()):
                    break
            elif len(self._live()) < self.cfg.replicas:
                # a failed initial spawn retries under the backoff/
                # give-up discipline until the configured width stands
                self._spawn("initial")
            elif all(r.state == "ready" for r in self._live()):
                break
            self.poll(0.05)
        return self

    # -- request intake --------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 16,
               eos_id: Optional[int] = None,
               adapter_id: int = 0) -> FleetRequest:
        if self._closed:
            raise RuntimeError("FleetRouter is closed")
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if int(adapter_id) < 0:
            raise ValueError("adapter_id must be >= 0 (0 = base model)")
        self._next_rid += 1
        fr = FleetRequest(rid=self._next_rid, prompt=prompt,
                          max_new_tokens=int(max_new_tokens),
                          eos_id=eos_id, submit_t=self._now(),
                          adapter_id=int(adapter_id), _router=self)
        self._reqs[fr.rid] = fr
        self._queue.append(fr)
        self._record("fleet_submit", rid=fr.rid,
                     prompt_len=len(prompt))
        return fr

    # -- join-shortest-queue ---------------------------------------------
    def _replica_load(self, rep: _Replica) -> int:
        """A replica's load for JSQ: the router's own outstanding count
        (known synchronously) floored by the replica's last heartbeat
        gauges (queue depth + active slots — work the replica admitted
        before this router incarnation, or submitted by the frames
        still in flight)."""
        beat = self._beats.get(rep.id) or {}
        hb = (int(beat.get("serve_queue_depth") or 0)
              + int(beat.get("serve_active_slots") or 0))
        return max(len(rep.outstanding), hb)

    #: tenant affinity's bounded imbalance: a replica whose heartbeat
    #: shows the tenant's adapter already HBM-resident may win over the
    #: JSQ minimum only while its load is within this many requests of
    #: it — affinity saves cold-adapter faults but never starves JSQ
    ADAPTER_AFFINITY_SLACK = 2

    def _pick_replica(self, roles=None,
                      adapter_id: int = 0) -> Optional[_Replica]:
        """JSQ with DETERMINISTIC tie-breaking: equal loads go to the
        lowest replica id (tested — a tie must not depend on dict
        order).  ``roles`` restricts the candidate set (disaggregated
        steering); None considers every ready replica.

        ``adapter_id > 0`` adds tenant affinity on top of JSQ: among
        candidates advertising the adapter in their ``adapters_hot``
        heartbeat gauge, the least-loaded wins IF its load is within
        :data:`ADAPTER_AFFINITY_SLACK` of the JSQ minimum; otherwise
        pure JSQ (bounded imbalance — a hot tenant cannot pile onto
        one replica while the rest idle)."""
        best = None
        aff = None
        for rep in self.replicas.values():
            if rep.state != "ready":
                continue
            if roles is not None and rep.role not in roles:
                continue
            key = (self._replica_load(rep), rep.id)
            if best is None or key < best[0]:
                best = (key, rep)
            if adapter_id:
                hot = (self._beats.get(rep.id) or {}).get(
                    "adapters_hot") or ()
                if adapter_id in hot and (aff is None or key < aff[0]):
                    aff = (key, rep)
        if best is None:
            return None
        if aff is not None and \
                aff[0][0] <= best[0][0] + self.ADAPTER_AFFINITY_SLACK:
            return aff[1]
        return best[1]

    def _admission_roles(self):
        """Where new prompts go: prefill+mixed when the fleet has a
        prefill phase at all; otherwise any replica (a roles map
        without ``prefill`` is labels, not disaggregation)."""
        if self.cfg.roles and "prefill" in self.cfg.roles:
            return ("prefill", "mixed")
        return None

    def _dispatch(self) -> None:
        roles = self._admission_roles()
        while self._queue:
            rep = self._pick_replica(roles,
                                     adapter_id=self._queue[0].adapter_id)
            if rep is None:
                return
            fr = self._queue.popleft()
            fr.replica = rep.id
            # a prefill-only replica never decodes: flag the submit so
            # the replica runs ONE token with detach_kv and hands the
            # pages back for migration.  max_new_tokens == 1 requests
            # are already pure prefill — they serve in place.
            migrate = rep.role == "prefill" and fr.max_new_tokens > 1
            if migrate:
                fr.migrated = True
                fr.prefill_replica = rep.id
            rep.outstanding[fr.rid] = fr
            try:
                send_frame(rep.sock, {
                    "kind": "submit", "rid": fr.rid,
                    "prompt": fr.prompt,
                    "max_new_tokens": fr.max_new_tokens,
                    "eos_id": fr.eos_id,
                    **({"adapter_id": fr.adapter_id}
                       if fr.adapter_id else {}),
                    **({"migrate": True} if migrate else {})})
            except OSError as e:
                # the failover path requeues fr (it is unstarted by
                # construction — nothing was ever streamed back)
                self._fail_replica(rep, f"submit send to replica "
                                        f"{rep.id} failed: {e}")

    def _dispatch_migrations(self) -> None:
        """Hand router-custody KV blobs to decode/mixed replicas —
        header frame first, then the page frames, then custody flips to
        the decode replica (its death before streaming puts the blob
        right back here)."""
        while self._migrate_queue:
            rep = self._pick_replica(
                ("decode", "mixed"),
                adapter_id=self._migrate_queue[0].adapter_id)
            if rep is None:
                return
            fr = self._migrate_queue.popleft()
            hdr, pages = fr._migration
            fr.replica = rep.id
            fr.decode_replica = rep.id
            rep.outstanding[fr.rid] = fr
            try:
                send_frame(rep.sock, {
                    "kind": "migrate_in", "rid": fr.rid,
                    "prompt": fr.prompt,
                    "first_token": hdr.get("first_token"),
                    "kv_len": hdr.get("kv_len"),
                    "pages": len(pages),
                    "max_new_tokens": fr.max_new_tokens,
                    "eos_id": fr.eos_id,
                    **({"adapter_id": fr.adapter_id}
                       if fr.adapter_id else {})})
                for seq, payload in enumerate(pages):
                    send_binary_frame(rep.sock, {
                        "kind": "page", "rid": fr.rid, "seq": seq,
                        "leaves": hdr.get("leaves")}, payload)
            except OSError as e:
                # fr._migration is still set, so the failover path
                # returns it to the migrate queue, not the front door
                self._fail_replica(rep, f"migrate_in send to replica "
                                        f"{rep.id} failed: {e}")
                continue
            self.migrations += 1
            self._record("migration", rid=fr.rid, custody="decode",
                         src=fr.prefill_replica, dst=rep.id,
                         pages=len(pages),
                         bytes=sum(len(p) for p in pages))

    # -- frame handling --------------------------------------------------
    def _complete(self, fr: FleetRequest, rep: Optional[_Replica]) -> None:
        if rep is not None:
            rep.outstanding.pop(fr.rid, None)
        self._reqs.pop(fr.rid, None)
        self._write_request_record(fr)
        fr.done.set()

    def _handle_frame(self, rep: _Replica, frame: dict) -> None:
        kind = frame.get("kind")
        if kind == "hello":
            return  # duplicate hello — harmless
        rid = frame.get("rid")
        fr = rep.outstanding.get(rid)
        if fr is None:
            return  # finished/failed-over meanwhile — a late frame
        now = self._now()
        if kind == "admit":
            fr.queue_wait_s = now - fr.submit_t
            self._wait_samples.append((now, fr.queue_wait_s))
        elif kind == "token":
            toks = frame.get("toks") or []
            if toks:
                if fr.ttft_s is None:
                    fr.ttft_s = now - fr.submit_t
                # a PREFILL replica's token does not flip the failover
                # boundary: the caller hasn't seen it, so a death
                # anywhere before decode custody requeues cleanly
                if not fr.started and not (
                        fr.migrated and rep.id == fr.prefill_replica):
                    fr.started = True
                    fr._migration = None  # decode streaming: blob done
            fr.tokens.extend(int(t) for t in toks)
        elif kind == "migrate_out":
            # the prefill replica finished rid's prefill: its page
            # frames follow on this same socket.  Custody stays with
            # the replica until the LAST page lands.
            rep.migrating[rid] = {"header": frame, "pages": []}
        elif kind == "page":
            entry = rep.migrating.get(rid)
            if entry is not None and isinstance(frame, BinaryFrame):
                entry["pages"].append(frame.payload)
                if len(entry["pages"]) >= int(
                        entry["header"].get("pages", 0)):
                    self._take_custody(rep, fr, entry)
        elif kind == "done":
            fr.finish_reason = frame.get("reason")
            total = frame.get("tokens_total")
            if total is not None and total != len(fr.tokens):
                logger.warning(
                    "fleet: rid=%d stream length %d != replica total "
                    "%d", fr.rid, len(fr.tokens), total)
            self._complete(fr, rep)
            # progress: a completed request resets the give-up budget
            self._consec_failures = 0
        elif kind == "error":
            fr.error = RuntimeError(
                f"replica {rep.id} failed rid={rid}: "
                f"{frame.get('error')}")
            self._complete(fr, rep)

    def _take_custody(self, rep: _Replica, fr: FleetRequest,
                      entry: dict) -> None:
        """The last page of rid's KV blob landed: custody moves prefill
        replica → router.  The prefill replica is done with the rid
        (its pages are already released engine-side)."""
        hdr = entry["header"]
        rep.migrating.pop(fr.rid, None)
        rep.outstanding.pop(fr.rid, None)
        fr.replica = None
        if not fr.tokens and hdr.get("first_token") is not None:
            # belt-and-braces: the replica streams the first token as a
            # normal token frame before migrate_out, but the header
            # carries it too so a blob is self-contained
            fr.tokens.append(int(hdr["first_token"]))
        fr._migration = (hdr, entry["pages"])
        self._migrate_queue.append(fr)
        self._record("migration", rid=fr.rid, custody="router",
                     src=rep.id, pages=len(entry["pages"]),
                     bytes=sum(len(p) for p in entry["pages"]))

    def _pump_replicas(self) -> None:
        for rep in list(self.replicas.values()):
            if rep.sock is None:
                continue
            try:
                frames, closed = drain_socket(rep.sock, rep.reader)
            except Exception as e:
                self._fail_replica(rep, f"replica {rep.id} corrupt "
                                        f"stream: {e!r}")
                continue
            for frame in frames:
                self._handle_frame(rep, frame)
            if closed and rep.id in self.replicas:
                if rep.state == "draining" and not rep.outstanding:
                    self._finish_retire(rep)
                else:
                    self._fail_replica(
                        rep, f"replica {rep.id} connection closed")

    def _accept(self) -> None:
        while True:
            try:
                sock, _ = self._listen.accept()
            except (BlockingIOError, OSError):
                break
            sock.settimeout(SOCK_TIMEOUT_S)
            self._greeting.append((sock, FrameReader(), self._now()))
        still = []
        for sock, reader, t0 in self._greeting:
            try:
                frames, closed = drain_socket(sock, reader)
            except Exception:
                # a garbage connection (port scanner, corrupt framing)
                # fails ITSELF, never the router
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            hello = next((f for f in frames
                          if f.get("kind") == "hello"), None)
            if hello is not None:
                rep = self.replicas.get(hello.get("replica"))
                if rep is not None and rep.sock is None:
                    rep.sock = sock
                    rep.reader = reader
                    reader.pending.extend(
                        f for f in frames if f.get("kind") != "hello")
                    rep.state = "ready"
                    rep.ready_wall_t = time.time()
                    self._record("ready", replica=rep.id)
                    logger.info("fleet: replica %d ready", rep.id)
                else:
                    sock.close()  # unknown or duplicate — drop
                continue
            if closed or self._now() - t0 > HELLO_TIMEOUT_S:
                sock.close()
                continue
            still.append((sock, reader, t0))
        self._greeting = still

    # -- failure + failover ----------------------------------------------
    def _note_replica_failure(self, reason: str) -> None:
        self._consec_failures += 1
        self.restarts += 1
        self._last_failure = reason
        self._next_spawn_t = self._now() + backoff_delay(
            self.cfg.backoff_base_s, self.cfg.backoff_max_s,
            self._consec_failures)
        logger.warning("fleet: %s (consecutive failures: %d/%d)",
                       reason, self._consec_failures,
                       self.cfg.max_restarts)
        if self._consec_failures > self.cfg.max_restarts:
            self._give_up(reason)

    def _give_up(self, reason: str) -> None:
        msg = (f"fleet: giving up after {self._consec_failures} "
               f"consecutive replica failures with no completed "
               f"request (max_restarts={self.cfg.max_restarts}); "
               f"last failure: {reason}")
        self._gave_up = True
        self._record("give_up", error=msg)
        dump_supervisor_flightrec(
            self.fleet_dir, supervisor="fleet", reason="FleetGiveUpError:"
            " restart budget exhausted", error=msg,
            restarts=self._consec_failures,
            max_restarts=self.cfg.max_restarts,
            fallback="give up (typed FleetGiveUpError)",
            events=self.events,
            extra={"replicas": {str(r.id): r.state
                                for r in self.replicas.values()},
                   "queued": len(self._queue)})
        err = FleetGiveUpError(msg, restarts=self._consec_failures,
                               last_failure=reason)
        self.close(error=err)
        raise err

    def _fail_replica(self, rep: _Replica, reason: str) -> None:
        """A replica died/hung/poisoned: kill the remnant, typed-fail
        its MID-STREAM requests, fail over the queued-but-unstarted
        ones (front of the router queue, original order), and let the
        give-up budget decide whether the fleet survives."""
        if rep.id not in self.replicas:
            return
        del self.replicas[rep.id]
        if rep.sock is not None:
            try:
                rep.sock.close()
            except OSError:
                pass
        # SIGKILL, never SIGTERM+grace: this replica's work is already
        # declared lost, and a synchronous grace-wait here would freeze
        # the poll loop — stalling every HEALTHY replica's frames during
        # exactly the degraded window the SLO autoscaler defends.  The
        # corpse is reaped asynchronously by later polls.
        try:
            rep.proc.kill()
        except OSError:
            pass
        self._reaping.append((str(rep.id), rep.proc))
        failed_over = 0
        for fr in sorted(rep.outstanding.values(), key=lambda r: r.rid,
                         reverse=True):
            if fr.started:
                fr.error = ReplicaFailure(
                    f"replica {rep.id} died mid-stream "
                    f"({reason}) after {len(fr.tokens)} token(s)",
                    replica=rep.id)
                self._complete(fr, None)
            elif fr._migration is not None:
                # router custody: the decode replica died before it
                # streamed a token, but the KV blob is still ours —
                # re-dispatch it to another decode replica, losing
                # nothing and re-running nothing
                fr.replica = None
                fr.decode_replica = None
                fr.failovers += 1
                self._migrate_queue.append(fr)
                self._record("migration", rid=fr.rid, custody="router",
                             src=rep.id, requeued=True)
                failed_over += 1
            else:
                # reset to pre-dispatch state; rid order preserved at
                # the FRONT of the queue (they waited longest).  The
                # wait stamp resets too: an admitted-but-unstarted
                # request must stay visible to the oldest-wait wedge
                # detector until its NEW replica admits it.  A migrated
                # request dying in its PREFILL phase lands here: the
                # partial blob (if any) died with the replica and the
                # first token was never surrendered, so it restarts
                # from scratch — tokens and stamps cleared
                fr.replica = None
                fr.queue_wait_s = None
                fr.failovers += 1
                if fr.migrated:
                    fr.tokens.clear()
                    fr.ttft_s = None
                    fr.migrated = False
                    fr.prefill_replica = None
                    fr.decode_replica = None
                self._queue.appendleft(fr)
                failed_over += 1
        rep.outstanding.clear()
        rep.migrating.clear()
        self._record("replica_dead", replica=rep.id, reason=reason,
                     failed_over=failed_over,
                     live=len(self._live()))
        self._note_replica_failure(reason)

    def _reap(self) -> None:
        self._reaping = [(tag, p) for tag, p in self._reaping
                         if p.poll() is None]

    def _check_replicas(self) -> None:
        now = self._now()
        now_wall = time.time()
        for rep in list(self.replicas.values()):
            rc = rep.proc.poll()
            if rc is not None:
                if rep.state == "draining" and rc == 0:
                    self._finish_retire(rep)
                else:
                    self._fail_replica(
                        rep, f"replica {rep.id} exited rc={rc}")
                continue
            if rep.state == "starting" and \
                    now - rep.spawned_t > self.cfg.spawn_timeout_s:
                self._fail_replica(
                    rep, f"replica {rep.id} not ready within "
                         f"spawn_timeout_s="
                         f"{self.cfg.spawn_timeout_s:.0f}s")
                continue
            if rep.state in ("ready", "draining") \
                    and self.cfg.heartbeat_timeout_s:
                # draining replicas stay hang-detectable too: one that
                # wedges mid-drain still holds outstanding requests
                # nobody else would ever fail over
                beat = self._beats.get(rep.id)
                # no beat at all counts from readiness: a replica
                # whose beat writes silently fail must still be
                # hang-detectable, or its requests wedge forever
                last = (float(beat.get("time", 0.0)) if beat
                        else rep.ready_wall_t or now_wall)
                if now_wall - last > self.cfg.heartbeat_timeout_s:
                    self._fail_replica(
                        rep, f"replica {rep.id} missed heartbeats "
                             f"(> {self.cfg.heartbeat_timeout_s:.0f}s "
                             "stale; hung)")

    def _read_beats(self) -> None:
        now_wall = time.time()
        if now_wall - self._last_beats_read < HEARTBEAT_READ_INTERVAL_S:
            return
        self._last_beats_read = now_wall
        beats = read_heartbeats(self.fleet_dir)
        by_idx: Dict[int, dict] = {}
        for rec in beats.values():
            try:
                by_idx[int(rec.get("process_index"))] = rec
            except (TypeError, ValueError):
                continue
        self._beats = by_idx
        if now_wall - self._last_metrics_write >= METRICS_INTERVAL_S:
            self._last_metrics_write = now_wall
            self._write_metrics()

    # -- autoscaling -----------------------------------------------------
    def _oldest_wait(self) -> Optional[float]:
        """Age of the oldest request still waiting for ADMISSION —
        queued at the router or dispatched but unadmitted.  Without
        this a fully wedged fleet produces no admission samples at all
        and the sample-based p99 would read as healthy."""
        now = self._now()
        oldest = None
        for fr in self._queue:
            oldest = fr.submit_t if oldest is None \
                else min(oldest, fr.submit_t)
        for rep in self.replicas.values():
            for fr in rep.outstanding.values():
                if fr.queue_wait_s is None:
                    oldest = fr.submit_t if oldest is None \
                        else min(oldest, fr.submit_t)
        return None if oldest is None else now - oldest

    def queue_wait_p99(self, window_s: Optional[float] = None) -> \
            Optional[float]:
        """p99 of admission queue waits over the trailing window (the
        scale-up window by default) — the number the SLO defends and
        the bench reports."""
        now = self._now()
        w = window_s if window_s is not None \
            else self.cfg.scale_up_window_s
        return _p99([s for t, s in self._wait_samples
                     if now - t <= w])

    def _decode_tpot_p99(self) -> Optional[float]:
        """The decode phase's SLO signal: worst ``serve_tpot_p99_s``
        gauge any live decode/mixed replica last beat (a fleet is as
        slow as its slowest decode replica — averaging would hide one
        wedged member behind healthy peers)."""
        worst = None
        for rep in self.replicas.values():
            if rep.role not in ("decode", "mixed"):
                continue
            beat = self._beats.get(rep.id) or {}
            v = beat.get("serve_tpot_p99_s")
            if v is None:
                continue
            v = float(v)
            worst = v if worst is None else max(worst, v)
        return worst

    def _role_signals(self, role: str):
        """(breach, slack, detail) for one role.  Prefill defends TTFT
        through the admission-wait signal (queue waits ARE the TTFT
        budget a prompt burns before its first prefill step); decode
        defends TPOT through the replica-reported decode-latency gauge
        plus the migration backlog (blobs parked at the router mean
        decode capacity, not prefill, is the bottleneck)."""
        cfg = self.cfg
        if role == "decode":
            slo = cfg.slo_tpot_s or 0.0
            tpot = self._decode_tpot_p99()
            backlog = len(self._migrate_queue)
            breach = bool(backlog) or (
                bool(slo) and tpot is not None and tpot > slo)
            slack = not backlog and (
                not slo or tpot is None or tpot < slo * SLACK_FACTOR)
            return breach, slack, {"tpot_p99_s": tpot,
                                   "migrate_backlog": backlog,
                                   "slo_tpot_s": slo}
        slo = (cfg.slo_ttft_s or cfg.slo_p99_s) if role == "prefill" \
            else cfg.slo_p99_s
        p99_up = self.queue_wait_p99(cfg.scale_up_window_s)
        oldest = self._oldest_wait()
        breach = ((p99_up is not None and p99_up > slo)
                  or (oldest is not None and oldest > slo))
        p99_down = self.queue_wait_p99(cfg.scale_down_window_s)
        slack = (not self._queue
                 and (p99_down is None
                      or p99_down < slo * SLACK_FACTOR))
        return breach, slack, {"p99_s": p99_up, "oldest_wait_s": oldest,
                               "slo_s": slo}

    def _autoscale_roles(self) -> None:
        """Per-role scale decisions with per-role hysteresis clocks.
        The role targets are the supervision floor: a role running
        below its target respawns on supervision grounds alone, so a
        dead prefill replica comes back AS prefill (a fleet that
        backfilled roles arbitrarily would silently de-specialize)."""
        now = self._now()
        cfg = self.cfg
        keep = max(cfg.scale_up_window_s, cfg.scale_down_window_s)
        while self._wait_samples and \
                now - self._wait_samples[0][0] > keep:
            self._wait_samples.popleft()
        live = self._live()
        missing = self._role_deficit()
        if missing is not None:
            self._spawn("role floor", missing)
            self._breach_since_role.pop(missing, None)
            self._slack_since_role.pop(missing, None)
            return
        for role in ("prefill", "decode", "mixed"):
            if not self._role_target.get(role, 0):
                continue
            breach, slack, detail = self._role_signals(role)
            if breach:
                self._slack_since_role.pop(role, None)
                since = self._breach_since_role.get(role)
                if since is None:
                    self._breach_since_role[role] = now
                elif now - since >= cfg.scale_up_window_s \
                        and len(live) < cfg.max_replicas:
                    rep = self._spawn("slo_breach", role)
                    if rep is not None:
                        self._role_target[role] += 1
                        self._record("scale_up", replica=rep.id,
                                     role=role, live=len(self._live()),
                                     **detail)
                        self._breach_since_role.pop(role, None)
                        live = self._live()
                continue
            self._breach_since_role.pop(role, None)
            if not slack:
                self._slack_since_role.pop(role, None)
                continue
            since = self._slack_since_role.get(role)
            if since is None:
                self._slack_since_role[role] = now
                continue
            ready = [r for r in live
                     if r.state == "ready" and r.role == role]
            if now - since >= cfg.scale_down_window_s \
                    and len(live) > cfg.min_replicas \
                    and self._role_target[role] > 1 and ready:
                rep = max(ready, key=lambda r: r.id)
                rep.state = "draining"
                self._role_target[role] -= 1
                self._record("scale_down", replica=rep.id, role=role,
                             live=len(self._live()), **detail)
                logger.info("fleet: retiring %s replica %d (slack)",
                            role, rep.id)
                self._breach_since_role.pop(role, None)
                self._slack_since_role.pop(role, None)
                live = self._live()

    def _autoscale(self) -> None:
        if self.cfg.roles:
            self._autoscale_roles()
            return
        now = self._now()
        cfg = self.cfg
        keep = max(cfg.scale_up_window_s, cfg.scale_down_window_s)
        while self._wait_samples and \
                now - self._wait_samples[0][0] > keep:
            self._wait_samples.popleft()
        live = self._live()
        # min clamp first: a fleet below its floor respawns on
        # supervision grounds alone (subject to the failure backoff)
        if len(live) < cfg.min_replicas:
            self._spawn("min_replicas clamp")
            self._breach_since = None
            self._slack_since = None
            return
        p99_up = self.queue_wait_p99(cfg.scale_up_window_s)
        oldest = self._oldest_wait()
        breach = ((p99_up is not None and p99_up > cfg.slo_p99_s)
                  or (oldest is not None and oldest > cfg.slo_p99_s))
        if breach:
            self._slack_since = None
            if self._breach_since is None:
                self._breach_since = now
            elif now - self._breach_since >= cfg.scale_up_window_s \
                    and len(live) < cfg.max_replicas:
                rep = self._spawn("slo_breach")
                if rep is not None:
                    self._record(
                        "scale_up", replica=rep.id,
                        p99_s=p99_up, oldest_wait_s=oldest,
                        slo_p99_s=cfg.slo_p99_s, live=len(self._live()))
                    self._breach_since = None
                    self._slack_since = None
            return
        self._breach_since = None
        p99_down = self.queue_wait_p99(cfg.scale_down_window_s)
        slack = (not self._queue
                 and (p99_down is None
                      or p99_down < cfg.slo_p99_s * SLACK_FACTOR))
        if not slack:
            self._slack_since = None
            return
        if self._slack_since is None:
            self._slack_since = now
            return
        ready = [r for r in live if r.state == "ready"]
        if now - self._slack_since >= cfg.scale_down_window_s \
                and len(live) > cfg.min_replicas and ready:
            rep = max(ready, key=lambda r: r.id)
            rep.state = "draining"
            self._record("scale_down", replica=rep.id, p99_s=p99_down,
                         live=len(self._live()))
            logger.info("fleet: retiring replica %d (slack; p99=%s)",
                        rep.id, p99_down)
            self._breach_since = None
            self._slack_since = None

    def _finish_retire(self, rep: _Replica) -> None:
        if rep.id not in self.replicas:
            return
        del self.replicas[rep.id]
        if rep.sock is not None:
            try:
                rep.sock.close()
            except OSError:
                pass
        terminate_with_grace([(str(rep.id), rep.proc)],
                             self.cfg.term_grace_s)
        self._record("retired", replica=rep.id,
                     live=len(self._live()))

    def _drive_draining(self) -> None:
        for rep in self.replicas.values():
            if rep.state == "draining" and not rep.outstanding \
                    and not rep.shutdown_sent and rep.sock is not None:
                rep.shutdown_sent = True
                try:
                    send_frame(rep.sock, {"kind": "shutdown"})
                except OSError:
                    pass  # already dying; _check_replicas reaps it

    # -- the poll loop ---------------------------------------------------
    def poll(self, timeout: float = 0.0) -> None:
        """One router iteration: accept hellos, pump replica frames,
        reap exits/hangs (failover), dispatch the queue JSQ, drive
        draining retirees, autoscale — then block up to ``timeout``
        for socket activity.  Single-threaded: this IS the router."""
        if self._closed:
            raise RuntimeError("FleetRouter is closed")
        self._read_beats()
        self._accept()
        self._pump_replicas()
        self._check_replicas()
        self._reap()
        self._dispatch()
        self._dispatch_migrations()
        self._drive_draining()
        self._autoscale()
        if timeout > 0:
            socks = [self._listen] + [
                r.sock for r in self.replicas.values()
                if r.sock is not None]
            try:
                select.select(socks, [], [], timeout)
            except (OSError, ValueError):
                pass

    def idle(self) -> bool:
        return not self._queue and not self._migrate_queue and not any(
            r.outstanding for r in self.replicas.values())

    def run_until_idle(self, max_s: float = 300.0) -> None:
        deadline = time.monotonic() + max_s
        while not self.idle():
            self.poll(0.02)
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"fleet still busy after {max_s}s: "
                    f"{len(self._queue)} queued, "
                    f"{sum(len(r.outstanding) for r in self.replicas.values())}"
                    " outstanding")

    # -- chaos + shutdown ------------------------------------------------
    def kill_replica(self, replica_id: int) -> None:
        """Chaos hook (bench/tests): SIGKILL one replica — no warning,
        no drain, exactly the poison/preemption shape the failover path
        must absorb."""
        rep = self.replicas.get(replica_id)
        if rep is None:
            raise KeyError(f"no live replica {replica_id}")
        self._record("chaos_kill", replica=replica_id)
        try:
            rep.proc.kill()
        except OSError:
            pass

    def close(self, error: Optional[BaseException] = None) -> None:
        """Idempotent teardown: shutdown frames to the living, SIGTERM→
        grace→SIGKILL the rest, typed failure for every request still
        in flight (a waiter must never hang on a closed fleet)."""
        if self._closed:
            return
        self._closed = True
        err = error if error is not None else FleetClosedError(
            "FleetRouter closed with the request in flight")
        notified = False
        for rep in self.replicas.values():
            if rep.sock is not None:
                try:
                    send_frame(rep.sock, {"kind": "shutdown"})
                    notified = True
                except OSError:
                    pass
        if notified and error is None:
            # give notified replicas the grace window to drain and
            # exit 0 on their OWN (final telemetry flush, eng.close())
            # before any signal lands — terminate_with_grace SIGTERMs
            # immediately, which would make the graceful path dead code
            deadline = time.monotonic() + self.cfg.term_grace_s
            while time.monotonic() < deadline and any(
                    r.proc.poll() is None
                    for r in self.replicas.values()
                    if r.sock is not None):
                time.sleep(0.05)
        terminate_with_grace(
            [(str(r.id), r.proc) for r in self.replicas.values()]
            + self._reaping,
            self.cfg.term_grace_s)
        self._reaping.clear()
        for rep in self.replicas.values():
            if rep.sock is not None:
                try:
                    rep.sock.close()
                except OSError:
                    pass
            for fr in rep.outstanding.values():
                if not fr.done.is_set():
                    fr.error = err
                    self._write_request_record(fr)
                    fr.done.set()
            rep.outstanding.clear()
        for fr in list(self._queue) + list(self._migrate_queue):
            if not fr.done.is_set():
                fr.error = err
                self._write_request_record(fr)
                fr.done.set()
        self._queue.clear()
        self._migrate_queue.clear()
        self.replicas.clear()
        for sock, _, _ in self._greeting:
            try:
                sock.close()
            except OSError:
                pass
        self._greeting.clear()
        try:
            self._listen.close()
        except OSError:
            pass
        try:
            self._records.close()
        except OSError:
            pass
