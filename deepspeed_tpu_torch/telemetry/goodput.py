"""Goodput accounting over the serving completion records.

Goodput (docs/serving.md "workload plane") is the fraction of finished
requests that met BOTH per-phase SLOs:

    TTFT   submit -> first generated token (queue wait + prefill)
    TPOT   mean time per output token over the decode phase

Two planes, one verdict function:

* **offline** — :func:`read_goodput` reconstructs the per-request
  phases from the completion records alone (``serve_request`` from a
  :class:`ServeEngine`, ``fleet_request`` from the router ledger) and
  scores them against the SLOs, tolerating the torn final line of a
  killed run the way ``summarize`` does (skipped count reported,
  never silently dropped).
* **live** — :class:`GoodputTracker` observes completed requests
  during a run and exports the verdicts through the telemetry hub:
  the ``serve_slo_ttft_miss_total`` / ``serve_slo_tpot_miss_total``
  counters, the ``serve_goodput_ratio`` gauge, and one sync flush of
  the ``serve_goodput`` / ``serve_slo_*_s`` scalars the summarize
  "goodput" section reads back.

The phase math is record-only on purpose: an operator scoring a
production artifact and the bench scoring a replay must agree, so
there is exactly one copy of it here.
"""
from __future__ import annotations

from typing import List, Optional

from .cli import _percentile, _read_jsonl_tolerant, _slo_ok


def phases_from_record(rec: dict) -> Optional[dict]:
    """Per-request phase attribution from one completion record.

    Accepts both record shapes — ``serve_request`` (engine: explicit
    ``decode_s_sum``/``decode_tokens``) and ``fleet_request`` (router
    ledger: TPOT reconstructed as ``(total - queue_wait - ttft) /
    (tokens - 1)``).  Pre-PR-17 records without ``arrival_s`` are fine
    (the field rides along when present; nothing here requires it).
    Returns None for records of any other kind.
    """
    kind = rec.get("kind", "serve_request")
    if kind not in ("serve_request", "fleet_request"):
        return None
    queue_wait = rec.get("queue_wait_s")
    ttft = rec.get("ttft_s")
    tpot = None
    dn = rec.get("decode_tokens")
    if dn:
        tpot = float(rec.get("decode_s_sum") or 0.0) / int(dn)
    elif kind == "fleet_request":
        tokens = int(rec.get("tokens") or 0)
        total = rec.get("total_s")
        if tokens > 1 and total is not None and ttft is not None:
            wait = float(queue_wait or 0.0)
            tpot = max(float(total) - wait - float(ttft), 0.0) \
                / (tokens - 1)
    return {
        "rid": rec.get("rid"),
        "arrival_s": rec.get("arrival_s"),
        "queue_wait_s": (float(queue_wait)
                         if queue_wait is not None else None),
        "ttft_s": float(ttft) if ttft is not None else None,
        "tpot_s": tpot,
        "tokens": int(rec.get("tokens") or 0),
        "error": rec.get("error"),
        "started": rec.get("started", True),
    }


def phases_from_request(req) -> dict:
    """The same attribution from a live engine ``Request`` — identical
    math to the record path (``token_times[0]`` is the TTFT stamp, the
    rest are decode intervals), so the live tracker and the offline
    reader can never disagree about a request."""
    times = [float(t) for t in getattr(req, "token_times", [])]
    decode = times[1:]
    admit_t = getattr(req, "admit_t", None)
    return {
        "rid": req.rid,
        "arrival_s": None,
        "queue_wait_s": (admit_t - req.submit_t if admit_t else None),
        "ttft_s": times[0] if times else None,
        "tpot_s": (sum(decode) / len(decode) if decode else None),
        "tokens": len(req.tokens),
        "error": (repr(req.error) if req.error is not None else None),
        "started": True,
    }


def score(phases: List[dict], slo_ttft_s: float,
          slo_tpot_s: float) -> dict:
    """Score attributed requests against both phase SLOs.

    A request is GOOD only when it finished without error, produced a
    first token within the TTFT SLO, and held the TPOT SLO over its
    decode phase (a one-token request has no decode phase and passes
    TPOT vacuously — there was no output cadence to violate).
    """
    good = ttft_miss = tpot_miss = failed = 0
    ttfts: List[float] = []
    tpots: List[float] = []
    waits: List[float] = []
    for ph in phases:
        if ph.get("error"):
            failed += 1
            continue
        ttft, tpot = ph.get("ttft_s"), ph.get("tpot_s")
        if ttft is None or ttft > slo_ttft_s:
            ttft_miss += 1
        if tpot is not None and tpot > slo_tpot_s:
            tpot_miss += 1
        if _slo_ok(ttft, tpot, slo_ttft_s, slo_tpot_s):
            good += 1
        if ttft is not None:
            ttfts.append(ttft)
        if tpot is not None:
            tpots.append(tpot)
        if ph.get("queue_wait_s") is not None:
            waits.append(ph["queue_wait_s"])
    ttfts.sort()
    tpots.sort()
    waits.sort()
    n = len(phases)
    return {
        "requests": n,
        "failed": failed,
        "goodput": good / n if n else None,
        "slo_ttft_s": slo_ttft_s,
        "slo_tpot_s": slo_tpot_s,
        "ttft_miss": ttft_miss,
        "tpot_miss": tpot_miss,
        "ttft_p50_s": _percentile(ttfts, 0.50),
        "ttft_p99_s": _percentile(ttfts, 0.99),
        "tpot_p50_s": _percentile(tpots, 0.50),
        "tpot_p99_s": _percentile(tpots, 0.99),
        "queue_wait_p50_s": _percentile(waits, 0.50),
        "queue_wait_p99_s": _percentile(waits, 0.99),
    }


def read_goodput(path: str, slo_ttft_s: float,
                 slo_tpot_s: float) -> dict:
    """Offline goodput over an events.jsonl (engine telemetry dir or
    fleet ledger): tolerant read, phase attribution, SLO scoring.  The
    skipped (torn/truncated) line count rides in the report — the
    summarize idiom."""
    records, skipped = _read_jsonl_tolerant(path)
    phases = [ph for ph in (phases_from_record(r) for r in records)
              if ph is not None]
    report = score(phases, slo_ttft_s, slo_tpot_s)
    report["skipped_lines"] = skipped
    return report


class GoodputTracker:
    """Live per-request SLO verdicts over a :class:`TelemetryHub`.

    ``observe()`` one attributed request at a time (the dicts
    :func:`phases_from_request` / :func:`phases_from_record` build);
    ``flush(step)`` exports the run's verdict through every plane the
    hub owns — counters/gauge into the registry, scalars into one sync
    record — so ``telemetry summarize`` reports goodput offline from
    events.jsonl alone.
    """

    def __init__(self, slo_ttft_s: float, slo_tpot_s: float, hub=None):
        self.slo_ttft_s = float(slo_ttft_s)
        self.slo_tpot_s = float(slo_tpot_s)
        self.hub = hub
        self.phases: List[dict] = []
        if hub is not None:
            reg = hub.registry
            self._ttft_miss = reg.counter(
                "serve_slo_ttft_miss_total",
                "requests whose time-to-first-token exceeded the TTFT "
                "SLO")
            self._tpot_miss = reg.counter(
                "serve_slo_tpot_miss_total",
                "requests whose mean time-per-output-token exceeded "
                "the TPOT SLO")
            self._goodput_gauge = reg.gauge(
                "serve_goodput_ratio",
                "fraction of finished requests that met BOTH phase "
                "SLOs (TTFT and TPOT)")

    def observe(self, phase: dict) -> bool:
        """Record one completed request; returns its verdict."""
        self.phases.append(phase)
        ttft, tpot = phase.get("ttft_s"), phase.get("tpot_s")
        ok = not phase.get("error") and _slo_ok(
            ttft, tpot, self.slo_ttft_s, self.slo_tpot_s)
        if self.hub is not None:
            if ttft is None or ttft > self.slo_ttft_s:
                self._ttft_miss.inc()
            if tpot is not None and tpot > self.slo_tpot_s:
                self._tpot_miss.inc()
        return ok

    def report(self) -> dict:
        return score(self.phases, self.slo_ttft_s, self.slo_tpot_s)

    def flush(self, step: int = 0) -> dict:
        """One sync flush of the goodput scalars (summarize reads
        exactly these; the LAST flush is the run's answer)."""
        rep = self.report()
        if self.hub is not None and rep["goodput"] is not None:
            self._goodput_gauge.set(rep["goodput"])
            scalars = {
                "serve_goodput": rep["goodput"],
                "serve_goodput_requests": float(rep["requests"]),
                "serve_slo_ttft_s": self.slo_ttft_s,
                "serve_slo_tpot_s": self.slo_tpot_s,
            }
            self.hub.on_sync(step=step, scalars=scalars)
        return rep
