"""Shared subprocess-supervision helpers (docs/elastic.md,
docs/serving.md "serving fleet"; a copy of
``deepspeed_tpu/launcher/supervise.py``).

Two supervisors ride these: the elastic restart loop
(``launcher/elastic.py`` — relaunch a TRAINING world after host
failures) and the serving fleet router (``inference/fleet.py`` — keep N
ServeEngine replicas alive behind one front door).  Both need the same
machinery: SIGTERM-then-grace-then-SIGKILL process teardown, bounded
exponential backoff between relaunches, heartbeat-directory hygiene
between attempts, and a best-effort give-up flight record that survives
the dead fleet.  Before this module each supervisor hand-rolled its own
copy; now the semantics are one tested plane.

Everything here is deliberately free of the worker runtime (stdlib +
the logger): a supervisor must keep running when the worker runtime is
the thing that is broken.
"""
from __future__ import annotations

import glob
import json
import os
import subprocess
import time
from typing import Callable, Iterable, Optional, Tuple

from ..utils.logging import logger


def backoff_delay(base_s: float, max_s: float, attempt: int) -> float:
    """Bounded exponential backoff before relaunch ``attempt`` (1-based:
    the first RETRY waits ``base_s``), capped at ``max_s``."""
    if attempt < 1:
        return 0.0
    return min(float(base_s) * (2 ** (attempt - 1)), float(max_s))


def terminate_with_grace(
        procs: Iterable[Tuple[str, subprocess.Popen]],
        grace_s: float,
        remote_kill_fn: Optional[Callable[[str], None]] = None) -> None:
    """SIGTERM the survivors (workers may run their preemption save —
    the checkpoint.sigterm_save hook), grace-wait, then SIGKILL the
    stubborn.  For transports whose local client does not forward
    signals (plain ssh/pdsh), ``remote_kill_fn`` then best-effort cleans
    the remnant
    on the host itself — otherwise a hung worker keeps its chips,
    coordinator port, and beat files into the next attempt.

    ``procs`` is ``[(tag, Popen), ...]`` — the tag is a host name for
    the elastic supervisor, a replica id for the fleet router; it only
    feeds ``remote_kill_fn`` and logs.
    """
    live = [(tag, p) for tag, p in procs if p.poll() is None]
    for _, p in live:
        try:
            p.terminate()
        except OSError:
            pass
    deadline = time.time() + float(grace_s)
    for _, p in live:
        try:
            p.wait(timeout=max(deadline - time.time(), 0.1))
        except subprocess.TimeoutExpired:
            try:
                p.kill()
                p.wait(timeout=5.0)
            except (OSError, subprocess.TimeoutExpired):
                pass
    if remote_kill_fn is not None:
        for tag in dict(live):
            try:
                remote_kill_fn(tag)
            except Exception as e:
                logger.warning("supervise: remote cleanup of %s "
                               "failed: %s", tag, e)


def sweep_heartbeat_files(directory: Optional[str],
                          prefix: str = "heartbeat_") -> None:
    """Clear stale beat files before a launch so liveness never judges
    this attempt by the previous attempt's files."""
    if not directory:
        return
    for f in glob.glob(os.path.join(directory, f"{prefix}*.json")):
        try:
            os.unlink(f)
        except OSError:
            pass


def dump_supervisor_flightrec(directory: Optional[str], *,
                              supervisor: str, reason: str, error: str,
                              restarts: int, max_restarts: int,
                              fallback: str, events, extra=None) -> None:
    """Best-effort give-up post-mortem next to the heartbeat files
    (``python -m deepspeed_tpu_torch.telemetry diagnose <dir>`` reads it); a
    supervisor out of options must never die on a dump failure.  Same
    schema as the telemetry hub's flight records, written inline so the
    writer stays free of the worker runtime."""
    if not directory:
        return
    try:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, "flightrec_supervisor.json")
        payload = {
            "version": 1, "reason": reason, "step": None,
            "time": time.time(), "error": error,
            "stages": {supervisor: {
                "degraded": False, "failures": restarts,
                "max_failures": max_restarts,
                "fallback": fallback,
                "surfaced": error, "events": list(events)}},
            "extra": dict(extra or {}),
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, default=repr)
        os.replace(tmp, path)
        logger.error("%s: flight record dumped to %s", supervisor, path)
    except OSError as e:
        logger.warning("%s: flight-record dump failed: %s",
                       supervisor, e)
