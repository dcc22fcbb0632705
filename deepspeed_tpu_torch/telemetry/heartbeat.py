"""Per-host heartbeats + straggler detection (docs/elastic.md).

Every training process writes a tiny JSON heartbeat file each step
(atomic tmp+replace, so readers never see a torn record) into a shared
directory — the liveness channel the elastic supervisor watches: a host
whose beat goes stale is hung (wedged collective, dead NIC) even though
its process is still "running", and the supervisor treats that as a
failure.  The same records carry the host-side wall time between beats,
which the :class:`StragglerMonitor` compares against the fleet median —
a host consistently slower than ``ratio`` × median is flagged
(``straggler_detected_total``), because in SPMD training the whole
fleet steps at the pace of its slowest member.

Writers must never take the training loop down: a failed beat degrades
to a one-time warning.  Stdlib only (the supervisor imports this
without torch).
"""
from __future__ import annotations

import json
import os
import socket
import statistics
import time
from typing import Dict, Optional

from ..utils.logging import logger

HEARTBEAT_PREFIX = "heartbeat_"

#: env var the elastic supervisor sets for its workers — the engine
#: starts beating when it is present, no config needed
HEARTBEAT_DIR_ENV = "DS_HEARTBEAT_DIR"


class HeartbeatWriter:
    """One process's heartbeat: ``beat(step)`` atomically rewrites
    ``<dir>/heartbeat_<process_index>.json`` with the current step, wall
    time, and the delta since the previous beat (the per-host step
    time the straggler math consumes)."""

    def __init__(self, directory: str, process_index: int = 0,
                 host: Optional[str] = None):
        self.directory = directory
        self.process_index = int(process_index)
        self.host = host or socket.gethostname()
        self.path = os.path.join(
            directory, f"{HEARTBEAT_PREFIX}{self.process_index}.json")
        self._last_t: Optional[float] = None
        self._warned = False
        try:
            os.makedirs(directory, exist_ok=True)
        except OSError as e:
            logger.warning("heartbeat dir %s could not be created (%s); "
                           "heartbeats disabled", directory, e)
            self._warned = True

    def beat(self, step: int, step_s: Optional[float] = None,
             extra: Optional[dict] = None) -> bool:
        """Emit one heartbeat; returns False when the write failed (a
        beat must never take training down — degraded liveness is the
        monitor's problem to notice, via staleness).

        ``extra`` rides additional gauges in the same record — the
        serving fleet's replicas report ``serve_active_slots``, request
        queue depth, ``serve_free_pages`` and the speculation accept
        ratio this way, and the fleet router's join-shortest-queue
        balancer reads them back (docs/serving.md "serving fleet").
        Core liveness keys always win a collision, so a gauge can never
        mask staleness; readers that predate the richer schema keep
        working because they only key on the core fields."""
        now = time.time()
        if step_s is None and self._last_t is not None:
            step_s = now - self._last_t
        self._last_t = now
        rec = dict(extra or {})
        rec.update({"host": self.host,
                    "process_index": self.process_index,
                    "step": int(step), "time": now,
                    "step_s": (round(float(step_s), 6)
                               if step_s is not None else None)})
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(rec, f)
            os.replace(tmp, self.path)  # atomic: no torn reads
            return True
        except OSError as e:
            if not self._warned:
                logger.warning(
                    "heartbeat write to %s failed (%s); training "
                    "continues, liveness monitoring is degraded",
                    self.path, e)
                self._warned = True
            return False


def read_heartbeats(directory: str) -> Dict[str, dict]:
    """All heartbeat records under ``directory``, keyed by
    ``host/process_index``.  Unparseable or mid-replace files are
    skipped (the writer's next beat heals them)."""
    out: Dict[str, dict] = {}
    if not os.path.isdir(directory):
        return out
    for name in sorted(os.listdir(directory)):
        if not (name.startswith(HEARTBEAT_PREFIX)
                and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(rec, dict) or "time" not in rec:
            continue
        key = f"{rec.get('host', '?')}/{rec.get('process_index', name)}"
        out[key] = rec
    return out


def beat_ages(beats: Dict[str, dict],
              now: Optional[float] = None) -> Dict[str, float]:
    """Seconds since each host's last beat, keyed like
    :func:`read_heartbeats` (``host/process_index``).  The engine
    exports these as the ``heartbeat_age_s`` gauge so supervisor-visible
    staleness is also operator-visible (the summarize liveness row);
    ages clamp at 0 for clock skew between writer and reader."""
    now = time.time() if now is None else now
    return {key: max(0.0, now - float(rec.get("time", 0.0)))
            for key, rec in beats.items()}


class StragglerMonitor:
    """Pure fleet-health policy over a heartbeat snapshot.

    ``update(beats, now)`` returns a report:

      - ``stale``: hosts whose last beat is older than
        ``stale_after_s`` — the supervisor's liveness signal (a stale
        host is hung, not merely slow);
      - ``stragglers``: hosts whose per-step time exceeds ``ratio`` ×
        the fleet median (needs >= ``min_fleet`` hosts reporting step
        times — a median of one is noise);
      - ``new_stragglers``: flagged now but not in the previous update —
        what the ``straggler_detected_total`` counter counts, so a host
        limping for 100 intervals is one detection, not 100.
    """

    def __init__(self, ratio: float = 2.0, stale_after_s: float = 60.0,
                 min_fleet: int = 2):
        if not ratio > 1.0:
            raise ValueError(
                f"straggler ratio must be > 1.0 (it multiplies the "
                f"fleet median), got {ratio!r}")
        self.ratio = float(ratio)
        self.stale_after_s = float(stale_after_s)
        self.min_fleet = int(min_fleet)
        self.flagged_total = 0
        self._flagged_prev: set = set()

    def update(self, beats: Dict[str, dict],
               now: Optional[float] = None) -> dict:
        now = time.time() if now is None else now
        stale = sorted(k for k, r in beats.items()
                       if now - float(r.get("time", 0)) > self.stale_after_s)
        # stale hosts are dead/hung, not slow: their frozen last step_s
        # must not sit in the fleet median (or the straggler set) forever
        step_times = {k: float(r["step_s"]) for k, r in beats.items()
                      if r.get("step_s") and k not in stale}
        median = (statistics.median(step_times.values())
                  if step_times else None)
        stragglers = []
        if median and len(step_times) >= self.min_fleet:
            stragglers = sorted(k for k, t in step_times.items()
                                if t > self.ratio * median)
        new = [k for k in stragglers if k not in self._flagged_prev]
        self.flagged_total += len(new)
        self._flagged_prev = set(stragglers)
        return {"hosts": len(beats), "stale": stale,
                "stragglers": stragglers, "new_stragglers": new,
                "median_step_s": median}
