"""Port parity, telemetry: ``deepspeed_tpu_torch/telemetry/`` (copies of
the JAX package's registry, tracing, exporters, hub, heartbeat, goodput
and CLI; the compile monitor and memory sampler adapted to eager PyTorch)
and the serving engine's telemetry plane, on the CPU.

The reference's unit cases (``tests/test_telemetry.py:34-135, 189-264,
405-535``) run on the port's modules unchanged but for the package name.
The compile monitor has no source to listen to: ``install()`` returns
False and an untracked (eager) program is skipped; its metric names stay.
The serving engine's events.jsonl, summarized by the port's CLI, carries
the same ``serve_*`` keys as the JAX engine's on the same config and
requests, with equal counts of requests, tokens, prefix hits, pages and
adapter hits, faults and evictions; its trace.json parses, with paired
flow events, and metrics.prom parses line by line; telemetry adds no
device read to a tick (every host read of a tensor is counted, telemetry
on against off).  Left for the training half of ROADMAP.md queue 1 item 5:
the training engine's cases (``:277-403``) and ``:136-187``, which need
jitted programs.
"""
import json
import os
import re

import numpy as np
import pytest
import jax
import torch

from deepspeed_tpu.inference import ServeEngine as JaxServeEngine
from deepspeed_tpu.models.gpt2 import (GPT2Config as JaxConfig,
                                       GPT2Model as JaxModel)
from deepspeed_tpu.runtime.stages import \
    reset_fault_injection as jax_reset_faults
from deepspeed_tpu.telemetry.cli import summarize as jax_summarize
from deepspeed_tpu_torch.inference import ServeEngine
from deepspeed_tpu_torch.models.gpt2 import (GPT2Config, GPT2Model,
                                             params_from_numpy)
from deepspeed_tpu_torch.runtime.stages import reset_fault_injection
from deepspeed_tpu_torch.telemetry import (CompileMonitor, MetricsRegistry,
                                           TelemetryHub, TraceRecorder,
                                           prometheus_text)
from deepspeed_tpu_torch.telemetry.cli import summarize

SMALL = dict(vocab_size=64, n_positions=64, d_model=64, n_layer=2,
             n_head=4)

_PROM_LINE = re.compile(
    r"^(?:# (?:HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* .+"
    r"|[a-zA-Z_:][a-zA-Z0-9_:]*(?:\{[^{}]*\})? \S+)$")


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    for env in ("DS_STAGE_FAULT", "DS_STAGE_DELAY_S"):
        monkeypatch.delenv(env, raising=False)
    reset_fault_injection()
    jax_reset_faults()
    yield
    reset_fault_injection()
    jax_reset_faults()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# registry, tracing, prometheus (reference :34-135)
# ---------------------------------------------------------------------------


def test_registry_counter_gauge_histogram():
    reg = MetricsRegistry()
    c = reg.counter("requests_total", "help text")
    c.inc()
    c.inc(2, route="train")
    assert c.value() == 1
    assert c.value(route="train") == 2
    with pytest.raises(ValueError):
        c.inc(-1)
    g = reg.gauge("hbm_bytes")
    g.set(5, device="0")
    g.set(7, device="0")
    assert g.value(device="0") == 7
    h = reg.histogram("lat_seconds")
    for v in range(1, 101):
        h.observe(v / 100)
    res = h.reservoir()
    assert res.count == 100 and res.min == 0.01 and res.max == 1.0
    assert abs(res.percentile(0.5) - 0.5) < 0.05
    assert abs(res.percentile(0.99) - 0.99) < 0.05
    assert reg.counter("requests_total") is c
    with pytest.raises(ValueError):
        reg.gauge("requests_total")


def test_histogram_reservoir_is_bounded():
    reg = MetricsRegistry()
    h = reg.histogram("x", reservoir_size=64)
    for v in range(10_000):
        h.observe(float(v))
    res = h.reservoir()
    assert len(res.samples) == 64
    assert res.count == 10_000
    assert res.percentile(0.5) > 1000


def test_trace_recorder_span_and_export(tmp_path):
    tr = TraceRecorder()
    with tr.span("outer", cat="test", step=3):
        with tr.span("inner"):
            pass
    tr.instant("marker")
    tr.counter("hbm", {"bytes": 123.0})
    h = tr.begin("lazy")
    h.end(steps=5)
    h.end()
    path = tr.export(str(tmp_path / "trace.json"))
    doc = json.loads(open(path).read())
    evs = doc["traceEvents"]
    names = {e["name"] for e in evs}
    assert {"outer", "inner", "marker", "hbm", "lazy"} <= names
    for e in evs:
        assert "ph" in e and "ts" in e and "name" in e
    lazy = next(e for e in evs if e["name"] == "lazy")
    assert lazy["args"]["steps"] == 5
    outer = next(e for e in evs if e["name"] == "outer")
    inner = next(e for e in evs if e["name"] == "inner")
    assert outer["ts"] <= inner["ts"]
    assert outer["dur"] >= inner["dur"]


def test_trace_recorder_bounds_events():
    tr = TraceRecorder(max_events=10)
    for i in range(25):
        tr.instant(f"e{i}")
    assert len(tr.events()) == 10
    assert tr.dropped == 15


def test_prometheus_text_parses_line_by_line():
    reg = MetricsRegistry()
    reg.counter("recompiles_total", "retraces").inc(3, program="train_step")
    reg.gauge("device_bytes_in_use").set(1.5e9, device="0")
    h = reg.histogram("train_step_seconds", "synced step time")
    h.observe(0.25)
    h.observe(0.75)
    lines = prometheus_text(reg).strip().splitlines()
    assert lines
    for line in lines:
        assert _PROM_LINE.match(line), f"unparseable line: {line!r}"
    assert 'recompiles_total{program="train_step"} 3.0' in lines
    assert any(l.startswith("train_step_seconds{quantile=") for l in lines)
    assert "train_step_seconds_count 2.0" in lines


# ---------------------------------------------------------------------------
# compile monitor and memory (reference :189-264)
# ---------------------------------------------------------------------------


def test_compile_monitor_installs_nothing_and_keeps_names():
    reg = MetricsRegistry()
    cm = CompileMonitor(reg)
    assert cm.install() is False
    cm.uninstall()
    names = {m.name for m in reg.metrics()}
    assert {"jax_compiles_total", "jax_compile_seconds",
            "recompiles_total"} <= names


def test_track_skips_non_jitted_drivers():
    cm = CompileMonitor(MetricsRegistry())
    assert not cm.track("python_driver", lambda s, b: (s, b))
    assert cm.tracked_programs() == []


def test_compile_monitor_counts_cache_growth_and_storms(monkeypatch):
    """``sample()`` folds a tracked program's cache growth into
    ``recompiles_total`` and warns once per storm, as the reference's does
    (a callable with a ``_cache_size`` stands in for a compiled one)."""
    from deepspeed_tpu_torch.telemetry import compile_monitor as cm_mod
    warnings = []
    monkeypatch.setattr(
        cm_mod.logger, "warning",
        lambda msg, *args: warnings.append(msg % args if args else msg))
    sizes = [1]

    def prog():
        pass
    prog._cache_size = lambda: sizes[0]
    reg = MetricsRegistry()
    cm = CompileMonitor(reg, storm_threshold=2)
    assert cm.track("stormy", prog)
    cm.sample()
    assert reg.counter("recompiles_total").value(program="stormy") == 0
    sizes[0] = 4
    cm.sample()
    assert reg.counter("recompiles_total").value(program="stormy") == 3
    assert any("recompile storm" in w and "stormy" in w for w in warnings)
    warnings.clear()
    sizes[0] = 6
    cm.sample()
    assert not warnings
    assert 'recompiles_total{program="stormy"} 5.0' in \
        prometheus_text(reg).splitlines()


def test_collect_memory_stats_structured():
    from deepspeed_tpu_torch.runtime.utils import (collect_memory_stats,
                                                   format_memory_status,
                                                   memory_status)
    stats = collect_memory_stats()
    assert isinstance(stats["devices"], list)
    assert "host_rss_bytes" in stats
    if stats["host_rss_bytes"] is not None:
        assert stats["host_rss_bytes"] > 0
    assert collect_memory_stats("cpu")["devices"] == []
    line = format_memory_status(stats, "probe")
    assert line.startswith("MEMORY probe:")
    assert memory_status("probe").startswith("MEMORY probe:")
    dev = {"id": 0, "platform": "gpu", "bytes_in_use": 2 ** 30,
           "peak_bytes_in_use": 2 ** 31, "bytes_limit": 2 ** 33}
    assert "0: 1.00/8.00GB peak 2.00" in format_memory_status(
        {"devices": [dev], "host_rss_bytes": None})


def test_memory_sampler_sets_gauges():
    from deepspeed_tpu_torch.telemetry.memory import MemorySampler
    reg = MetricsRegistry()
    ms = MemorySampler(reg, device="cpu")
    stats = ms.sample()
    if stats["host_rss_bytes"] is not None:
        assert reg.gauge("host_rss_bytes").value() == \
            stats["host_rss_bytes"]
    assert ms.peak_hbm_bytes() is None      # no device on the CPU


def test_summarize_cli(tmp_path, capsys):
    path = tmp_path / "events.jsonl"
    with open(path, "w") as f:
        for i in range(6):
            f.write(json.dumps({"kind": "step", "ts": i, "step": i + 1,
                                "dispatch_s": 0.001}) + "\n")
        f.write(json.dumps({"kind": "sync", "ts": 6, "step": 3,
                            "interval_s": 0.6, "steps": 3,
                            "step_avg_s": 0.2,
                            "samples_per_sec": 160.0}) + "\n")
        f.write(json.dumps({"kind": "sync", "ts": 9, "step": 6,
                            "interval_s": 1.2, "steps": 3,
                            "step_avg_s": 0.4,
                            "samples_per_sec": 80.0}) + "\n")
        f.write(json.dumps({"kind": "memory", "ts": 9, "step": 6,
                            "stats": {"devices": [
                                {"id": 0, "peak_bytes_in_use": 2 ** 30}],
                                "host_rss_bytes": 2 ** 28}}) + "\n")
        f.write("not json\n")
    rep = summarize(str(path))
    assert rep["steps"] == 6
    assert rep["step_time_source"] == "synced intervals"
    assert abs(rep["p50_s"] - 0.3) < 1e-9
    assert rep["samples_per_sec"] == pytest.approx(120.0)
    assert rep["peak_hbm_bytes"] == 2 ** 30
    assert rep["bad_lines"] == 1
    from deepspeed_tpu_torch.telemetry.cli import main
    assert main(["summarize", str(path)]) == 0
    out = capsys.readouterr().out
    assert "p50" in out and "peak HBM" in out
    assert main(["summarize", str(tmp_path / "missing.jsonl")]) == 2


def test_summarize_dispatch_only_is_labelled(tmp_path):
    path = tmp_path / "events.jsonl"
    with open(path, "w") as f:
        f.write(json.dumps({"kind": "step", "step": 1,
                            "dispatch_s": 0.001}) + "\n")
    assert "DISPATCH-ONLY" in summarize(str(path))["step_time_source"]


# ---------------------------------------------------------------------------
# config, exporters' escaping, torn tails, heartbeats, hub (:405-535)
# ---------------------------------------------------------------------------


def test_telemetry_config_block_defaults_and_validation():
    from deepspeed_tpu_torch.config import (DeepSpeedConfig,
                                            DeepSpeedConfigError)
    cfg = DeepSpeedConfig({"train_micro_batch_size_per_gpu": 1}, 1)
    assert not cfg.telemetry_config.enabled
    assert cfg.telemetry_config.trace
    assert cfg.telemetry_config.compile_events
    assert cfg.telemetry_config.memory
    for bad in (0, True):
        with pytest.raises(DeepSpeedConfigError):
            DeepSpeedConfig({"train_micro_batch_size_per_gpu": 1,
                             "telemetry": {"enabled": True,
                                           "recompile_storm_threshold":
                                               bad}}, 1)


def test_prometheus_hostile_label_values_escaped():
    reg = MetricsRegistry()
    reg.counter("hostile_total", "h").inc(1, label='pa\\th"quoted"\nline2')
    lines = prometheus_text(reg).strip().splitlines()
    for line in lines:
        assert _PROM_LINE.match(line), f"unparseable line: {line!r}"
    sample = next(l for l in lines if l.startswith("hostile_total{"))
    assert '\\\\' in sample and '\\"' in sample
    assert '\\n' in sample and "\n" not in sample


def test_prometheus_help_fallback_and_escaping():
    reg = MetricsRegistry()
    reg.gauge("helpless_gauge").set(1.0)
    reg.histogram("helpless_seconds").observe(0.5)
    reg.counter("multi_total", "line one\nline two \\ slash").inc()
    lines = prometheus_text(reg).strip().splitlines()
    assert "# HELP helpless_gauge helpless_gauge" in lines
    assert "# HELP helpless_seconds helpless_seconds" in lines
    assert "# HELP multi_total line one\\nline two \\\\ slash" in lines
    for line in lines:
        assert _PROM_LINE.match(line), f"unparseable line: {line!r}"


def test_summarize_and_diagnose_tolerate_torn_tail(tmp_path, capsys):
    from deepspeed_tpu_torch.telemetry.cli import diagnose
    path = tmp_path / "events.jsonl"
    with open(path, "w") as f:
        for i in range(4):
            f.write(json.dumps({"kind": "step", "step": i + 1,
                                "dispatch_s": 0.001}) + "\n")
        f.write('{"kind": "sync", "step": 4, "interval_')
    rep = summarize(str(path))
    assert rep["steps"] == 4 and rep["bad_lines"] == 1
    assert "skipped 1 unparseable" in capsys.readouterr().out
    drep = diagnose(str(tmp_path))
    assert drep["skipped_lines"] == 1 and drep["last_step"] == 4
    assert "skipped 1 malformed/torn" in capsys.readouterr().out


def test_heartbeat_ages_and_summarize_liveness_row(tmp_path, capsys):
    from deepspeed_tpu_torch.telemetry.heartbeat import (HeartbeatWriter,
                                                         beat_ages,
                                                         read_heartbeats)
    hb_dir = tmp_path / "hb"
    HeartbeatWriter(str(hb_dir), process_index=0, host="hostA").beat(3)
    HeartbeatWriter(str(hb_dir), process_index=1, host="hostB").beat(3)
    beats = read_heartbeats(str(hb_dir))
    now = beats["hostA/0"]["time"]
    ages = beat_ages(beats, now=now + 7.5)
    assert set(ages) == {"hostA/0", "hostB/1"}
    assert ages["hostA/0"] == pytest.approx(7.5, abs=1.0)
    assert beat_ages(beats, now=now - 100)["hostA/0"] == 0.0
    reg = MetricsRegistry()
    g = reg.gauge("heartbeat_age_s", "beat age")
    for key, age in ages.items():
        g.set(age, host=key)
    reg.counter("straggler_detected_total", "s").inc()
    path = tmp_path / "events.jsonl"
    with open(path, "w") as f:
        f.write(json.dumps({"kind": "step", "step": 1,
                            "dispatch_s": 0.001}) + "\n")
        f.write(json.dumps({"kind": "metrics", "step": 3,
                            "metrics": reg.snapshot()}) + "\n")
    rep = summarize(str(path))
    assert rep["liveness_hosts"] == 2
    assert rep["liveness_max_age_s"] == pytest.approx(max(ages.values()),
                                                      rel=1e-6)
    out = capsys.readouterr().out
    assert "liveness" in out and "2 host(s)" in out


def test_hub_close_idempotent(tmp_path):
    hub = TelemetryHub(str(tmp_path), compile_events=False, memory=False)
    hub.record_step(1, 0.01)
    hub.on_sync(1, interval_s=0.01, steps=1)
    hub.close()
    hub.close()
    hub.on_sync(2)
    assert os.path.isfile(tmp_path / "trace.json")
    assert os.path.isfile(tmp_path / "metrics.prom")


def test_summarize_offload_attribution_split(tmp_path, capsys):
    p = tmp_path / "events.jsonl"
    lines = [{"kind": "sync", "step": 10 * (i + 1), "interval_s": 1.0,
              "steps": 10, "step_avg_s": 0.1,
              "scalars": {"offload_overlap_ratio": r,
                          "offload_h2d_s": 0.12,
                          "offload_cpu_adam_s": 0.30}}
             for i, r in enumerate((0.6, 0.8))]
    p.write_text("\n".join(json.dumps(l) for l in lines) + "\n")
    rep = summarize(str(p))
    assert rep["offload_overlap_ratio"] == pytest.approx(0.7)
    assert rep["offload_h2d_s"] == pytest.approx(0.12)
    assert rep["offload_cpu_adam_s"] == pytest.approx(0.30)
    out = capsys.readouterr().out
    assert "offload H2D overlap" in out and "Adam" in out


# ---------------------------------------------------------------------------
# the serving engine's telemetry plane
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxConfig(**SMALL, remat=None, attn_impl="dense")
    tree = jax.tree.map(np.asarray, JaxModel(jcfg).init(
        jax.random.PRNGKey(0)))
    return jcfg, tree, GPT2Config(**SMALL, attn_impl="dense")


def _prompts():
    rng = np.random.default_rng(3)
    tmpl = [int(t) for t in rng.integers(0, 64, 16)]
    return ([tmpl + [int(t) for t in rng.integers(0, 64, n)]
             for n in (3, 5)] + [[int(t) for t in rng.integers(0, 64, n)]
                                 for n in (4, 9, 1)] + [tmpl + [7]])


TENANTS = [0, 1, 2, 1, 3, 0]


def _cfg(path, **extra):
    return {"serving": {"slots": 3, "max_seq_len": 40, "prefill_len": 24,
                        "page_len": 8, "pages": 24,
                        "flush_interval_ticks": 2,
                        "lora": {"rank": 4, "alpha": 8.0,
                                 "hbm_adapter_slots": 2,
                                 "targets": ["qkv_w", "fc_w"]}, **extra},
            "telemetry": {"enabled": True, "output_path": str(path)}}


def _serve_both(weights, tmp_path, **extra):
    """The same config and requests through the port's and the JAX
    engine, telemetry on; returns both summaries, engines' counters and
    the two output directories."""
    jcfg, tree, pcfg = weights
    out = {}
    for name in ("port", "jax"):
        path = tmp_path / name
        if name == "port":
            eng = ServeEngine(GPT2Model(pcfg), _cfg(path, **extra),
                              params=params_from_numpy(tree), device="cpu")
        else:
            eng = JaxServeEngine(JaxModel(jcfg), _cfg(path, **extra),
                                 params=tree)
        reqs = [eng.submit(p, max_new_tokens=5, adapter_id=t)
                for p, t in zip(_prompts(), TENANTS)]
        eng.run_until_idle()
        counts = {"tokens": [len(r.tokens) for r in reqs],
                  "prefix": (eng.prefix.hits, eng.prefix.misses,
                             eng.prefix.cow),
                  "adapters": (eng.adapters.hits, eng.adapters.faults,
                               eng.adapters.evictions)}
        eng.close()
        summ = (summarize if name == "port" else jax_summarize)(
            str(path / "events.jsonl"))
        out[name] = (summ, counts, path)
    return out


def _events(path):
    with open(path / "events.jsonl") as f:
        return [json.loads(line) for line in f]


def test_serving_summary_matches_jax_engine(weights, tmp_path):
    """Same config (paged, prefix cache, two LoRA targets, two adapter
    slots for three tenants) and requests: the port's events.jsonl gives
    the same summary keys and the same counts as the JAX engine's, and
    the same registry metric names."""
    got = _serve_both(weights, tmp_path)
    (ps, pc, ppath), (js, jc, jpath) = got["port"], got["jax"]
    assert pc == jc
    present = lambda r: {k for k, v in r.items()  # noqa: E731
                         if k.startswith("serve_") and v is not None}
    assert present(ps) == present(js)
    for key in ("serve_requests", "serve_requests_failed",
                "serve_free_pages", "serve_page_utilization",
                "serve_prefix_hit_ratio", "serve_prefix_hit_tokens",
                "serve_page_cow_total", "serve_adapters_resident",
                "serve_adapter_bytes", "serve_adapter_hits_total",
                "serve_adapter_faults_total",
                "serve_adapter_evictions_total", "serve_param_bytes",
                "serve_kv_bytes"):
        assert ps[key] == js[key], key
    assert ps["serve_requests"] == len(TENANTS)
    assert ps["serve_prefix_hit_tokens"] > 0
    pev, jev = _events(ppath), _events(jpath)
    recs = lambda ev: sorted(  # noqa: E731
        (e["rid"], e["tokens"], e["prompt_len"], e["finish_reason"])
        for e in ev if e["kind"] == "serve_request")
    assert recs(pev) == recs(jev)
    snap = lambda ev: {m["name"]: m.get("value", m.get("count"))  # noqa
                       for m in [e for e in ev
                                 if e["kind"] == "metrics"][-1]["metrics"]}
    psnap, jsnap = snap(pev), snap(jev)
    # the JAX engine's compile listener counts its compiles; eager torch
    # compiles nothing, so those two series stay empty in the port
    assert set(psnap) == set(jsnap) - {"jax_compiles_total",
                                       "jax_compile_seconds"}
    for name in ("serve_tokens_total", "serve_requests_total",
                 "serve_prefix_hits_total", "serve_prefix_misses_total",
                 "serve_adapter_hits_total", "serve_adapter_faults_total",
                 "serve_ttft_seconds", "serve_adapters_resident",
                 "adapter_fetch_attempts_total"):
        assert psnap.get(name) == jsnap.get(name), name
    assert sum(pc["tokens"]) == psnap["serve_tokens_total"]


def test_serving_trace_prom_and_flight_record(weights, tmp_path):
    """The port engine's trace.json parses with every request's flow
    paired (start to end), metrics.prom parses line by line, a poisoned
    tick dumps a flight record that ``diagnose`` reads, and close is
    idempotent."""
    from deepspeed_tpu_torch.telemetry.cli import diagnose
    _, tree, pcfg = weights
    eng = ServeEngine(GPT2Model(pcfg), _cfg(tmp_path, speculate_k=2,
                                            draft={"d_model": 64,
                                                   "n_layer": 1,
                                                   "n_head": 4},
                                            temperature=0.8),
                      params=params_from_numpy(tree), device="cpu")
    reqs = [eng.submit(p, max_new_tokens=5, adapter_id=t)
            for p, t in zip(_prompts(), TENANTS)]
    eng.run_until_idle()
    assert all(r.error is None and len(r.tokens) == 5 for r in reqs)
    boom = RuntimeError("verify exploded")

    def bad(*a, **k):
        raise boom
    eng._verify = bad
    r = eng.submit([1, 2, 3], max_new_tokens=4)
    with pytest.raises(RuntimeError, match="verify exploded"):
        eng.run_until_idle()
    assert r.error is boom
    eng.close()
    eng.close()
    doc = json.loads((tmp_path / "trace.json").read_text())
    evs = doc["traceEvents"]
    for e in evs:
        assert "ph" in e and "ts" in e and "name" in e
    names = {e["name"] for e in evs}
    assert {"serve/prefill", "serve/draft_propose", "serve/verify_step",
            "serve/finish", "serve/error"} <= names
    starts = {e["id"] for e in evs if e["ph"] == "s"}
    ends = {e["id"] for e in evs if e["ph"] == "f"}
    assert starts and starts == ends
    for line in (tmp_path / "metrics.prom").read_text().splitlines():
        if line.strip():
            assert _PROM_LINE.match(line), line
    flights = [f for f in os.listdir(tmp_path) if f.startswith("flightrec_")]
    assert flights
    rep = diagnose(str(tmp_path))
    assert "verify exploded" in (rep.get("error") or "")
    summ = summarize(str(tmp_path / "events.jsonl"))
    assert summ["serve_spec_mean_accepted_len"] >= 1.0
    assert summ["serve_requests_failed"] == 1


def test_kv_tier_telemetry_flows_to_summarize(weights, tmp_path, capsys):
    """The KV tier's ``serve_kv_*`` scalars reach summarize equal to the
    tier's own counters (the port's counterpart of
    ``tests/test_kv_tier.py::test_kv_tier_telemetry_flows_to_summarize``)."""
    _, tree, pcfg = weights
    cfg = {"serving": {"slots": 2, "max_seq_len": 40, "prefill_len": 24,
                       "page_len": 8, "flush_interval_ticks": 1,
                       "kv_tier": {"idle_park_ticks": 1,
                                   "host_budget_pages": 64}},
           "telemetry": {"enabled": True, "output_path": str(tmp_path)}}
    eng = ServeEngine(GPT2Model(pcfg), cfg, params=params_from_numpy(tree),
                      device="cpu")
    turn1 = _prompts()[0]
    eng.submit(turn1, max_new_tokens=4)
    eng.run_until_idle()
    for _ in range(24):
        eng.step()
    r = eng.submit(turn1 + [5, 6, 7], max_new_tokens=4)
    eng.run_until_idle()
    tier = eng.kv_tier
    assert tier.parked_pages_total >= 2 and tier.resumed_pages_total >= 2
    want = (tier.spill_bytes, tier.fetch_bytes)
    eng.close()
    assert r.shared_len >= 16
    rep = summarize(str(tmp_path / "events.jsonl"))
    # the close-time flush runs after the tier dropped its parked records
    assert rep["serve_kv_parked_sessions"] is not None
    assert rep["serve_kv_spill_bytes_total"] == want[0] > 0
    assert rep["serve_kv_fetch_bytes_total"] == want[1] > 0
    assert rep["serve_kv_resume_p99_s"] is not None
    assert "kv tier" in capsys.readouterr().out


class _ReadCounter:
    """Counts every read of a tensor's value into host Python (the
    points where a CUDA tensor would synchronize): ``cpu``, ``item``,
    ``tolist``, ``numpy`` and the scalar conversions."""

    NAMES = ("cpu", "item", "tolist", "numpy", "__int__", "__float__",
             "__bool__", "__index__")

    def __init__(self, monkeypatch):
        self.count = 0
        for name in self.NAMES:
            real = getattr(torch.Tensor, name)
            monkeypatch.setattr(torch.Tensor, name, self._wrap(real))

    def _wrap(self, real):
        def inner(*a, **k):
            self.count += 1
            return real(*a, **k)
        return inner


@pytest.mark.parametrize("arm", ["decode", "spec"])
def test_telemetry_adds_no_read_to_a_tick(weights, tmp_path, arm):
    """The overhead contract: serving the same load with telemetry on
    reads tensors back exactly as often as with it off — spans, records
    and flushes are host-side (on the card each such read is the tick's
    one synchronization)."""
    _, tree, pcfg = weights
    extra = ({"speculate_k": 2, "draft": {"d_model": 64, "n_layer": 1,
                                          "n_head": 4}}
             if arm == "spec" else {})
    counts, streams = {}, {}
    for on in (False, True):
        cfg = _cfg(tmp_path / str(on), **extra)
        cfg["telemetry"]["enabled"] = on
        eng = ServeEngine(GPT2Model(pcfg), cfg,
                          params=params_from_numpy(tree), device="cpu")
        reqs = [eng.submit(p, max_new_tokens=5, adapter_id=t)
                for p, t in zip(_prompts(), TENANTS)]
        with pytest.MonkeyPatch.context() as mp:
            rc = _ReadCounter(mp)
            eng.run_until_idle()
            counts[on] = rc.count
        streams[on] = [r.tokens for r in reqs]
        eng.close()
    assert streams[True] == streams[False]
    assert counts[True] == counts[False] > 0, counts
