"""The training engine's telemetry plane on the port, against the JAX
engine's: both engines with ``telemetry``, ``tensorboard`` and the
heartbeat on, a few steps on the same params and batches (GPT-2 2 layers,
d 64, 4 heads, vocab 128, fp32, on the CPU).

Across the packages: the same metric names in ``metrics.prom``, span
names in ``trace.json``, event kinds in ``events.jsonl`` and keys of a
flight record; equal step and sample counters; TensorBoard scalars equal
by name and within 1e-4 (fp32); the heartbeat and straggler rows of
``summarize`` equal.  On the port: losses with telemetry on equal those
with it off bitwise; a step reads the card no more often with telemetry
on (the counterpart of ``tests/test_telemetry.py``'s zero-added-syncs
contract); the anomaly trigger fires once; the profiler window writes a
Chrome trace; the counterparts of ``tests/test_telemetry.py:277-403``,
``tests/test_timer_monitor.py:176`` and
``tests/test_resilience.py:608,639``.
"""
import glob
import json
import os
import re
import sys

import numpy as np
import pytest
import jax
import torch

from deepspeed_tpu.config import DeepSpeedConfig as JaxDeepSpeedConfig
from deepspeed_tpu.models.gpt2 import (GPT2Config as JaxConfig,
                                       GPT2Model as JaxModel)
from deepspeed_tpu.parallel import build_mesh
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JaxEngine
from deepspeed_tpu.telemetry.cli import summarize as jax_summarize

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.telemetry.cli import summarize

from test_torch_zero import one_thread  # noqa: F401

TINY = dict(vocab_size=128, n_positions=32, d_model=64, n_layer=2,
            n_head=4)
T = 16
STEPS = 4
_PROM_LINE = re.compile(r"^(#.*|[a-zA-Z_:][a-zA-Z0-9_:]*(\{.*\})? \S+)$")


def _tree():
    return jax.tree.map(np.asarray, JaxModel(JaxConfig(
        **TINY, remat=None, attn_impl="dense")).init(jax.random.PRNGKey(0)))


def _batch(step):
    return np.random.default_rng(step % 3).integers(0, 128, (4, T + 1),
                                                     np.int32)


def _config(out=None, steps_per_print=2, **extra):
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 2,
           "steps_per_print": steps_per_print,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
    if out is not None:
        cfg["telemetry"] = {"enabled": True, "output_path": str(out),
                            "heartbeat": True}
        cfg["tensorboard"] = {"enabled": True, "output_path": str(out),
                              "job_name": "tb"}
    cfg.update(extra)
    return cfg


def _port(cfg, tree=None):
    eng, *_ = dst.initialize(
        model=GPT2Model(GPT2Config(**TINY, remat=None)), config=cfg,
        params=tree if tree is not None else _tree(), device="cpu")
    return eng


def _jax(cfg, tree):
    dev = jax.devices()[0]
    return JaxEngine(JaxModel(JaxConfig(**TINY, remat=None,
                                        attn_impl="dense")),
                     JaxDeepSpeedConfig(cfg, world_size=1),
                     mesh=build_mesh(pp=1, dp=1, tp=1, devices=[dev]),
                     params=tree)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """Both SummaryWriters on their JSONL fallback (TensorBoard's writer
    made unimportable), so the scalars are comparable files and no test
    pays TensorBoard's import."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _prom_names(d):
    names = set()
    with open(os.path.join(d, "metrics.prom")) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                names.add(re.split(r"[{ ]", line, 1)[0])
    return names


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two engines, telemetry on, STEPS steps on the same params and
    batches with an async save after step 2, a flight record on demand,
    then close.  Returns the output directories and the losses."""
    root = tmp_path_factory.mktemp("train_tel")
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    tree = _tree()
    out = {}
    try:
        for name, build in (("jax", _jax), ("torch", _port)):
            d = root / name
            eng = build(_config(d), tree)
            losses = []
            for step in range(STEPS):
                losses.append(float(np.asarray(
                    eng.train_batch(_batch(step)))))
                if step == 1:
                    eng.save_checkpoint(str(root / f"ck_{name}"),
                                        async_write=True)
                    # landed before the next sync in both runs
                    assert eng._ckpt_writer.drain() is None
            rec = eng.dump_flight_record(reason="test")
            eng.close()
            out[name] = {"dir": str(d), "losses": losses,
                         "flightrec": rec}
    finally:
        mp.undo()
    return out


def test_same_metric_span_and_event_names(runs):
    j, t = runs["jax"]["dir"], runs["torch"]["dir"]
    # JAX-only names: the jit compile monitor's (eager torch compiles no
    # program) — everything else is shared
    jax_only = {n for n in _prom_names(j) if "compile" in n}
    assert _prom_names(t) == _prom_names(j) - jax_only
    for d in (j, t):
        with open(os.path.join(d, "metrics.prom")) as f:
            for line in f:
                if line.strip():
                    assert _PROM_LINE.match(line.strip()), line

    def spans(d):
        doc = json.load(open(os.path.join(d, "trace.json")))
        return {e["name"] for e in doc["traceEvents"]
                if not e["name"].startswith("compile")}
    assert spans(t) == spans(j)
    assert {"train/dispatch", "train/shard_batch", "train/steps_interval",
            "checkpoint/save", "checkpoint/snapshot",
            "checkpoint/async_write", "checkpoint/job"} <= spans(t)

    def kinds(d):
        return {r["kind"] for r in _records(os.path.join(d, "events.jsonl"))
                if r["kind"] != "compile"}
    assert kinds(t) == kinds(j)
    assert {"step", "sync", "metrics", "memory"} <= kinds(t)


def test_flight_record_keys_equal(runs):
    recs = {}
    for name in ("jax", "torch"):
        path = runs[name]["flightrec"]
        assert path and os.path.isfile(path)
        recs[name] = json.load(open(path))
    assert set(recs["torch"]) == set(recs["jax"])
    assert recs["torch"]["reason"] == "test"
    assert recs["torch"]["step"] == STEPS
    assert "ckpt_writer" in recs["torch"]["stages"]
    assert set(recs["torch"]["stages"]["ckpt_writer"]) \
        == set(recs["jax"]["stages"]["ckpt_writer"])


def test_counters_and_tensorboard_scalars_match(runs):
    reps = {n: summarize(os.path.join(runs[n]["dir"], "events.jsonl"))
            if n == "torch" else
            jax_summarize(os.path.join(runs[n]["dir"], "events.jsonl"))
            for n in ("jax", "torch")}
    for key in ("steps", "liveness_hosts", "straggler_detected_total"):
        assert reps["torch"][key] == reps["jax"][key], key
    assert reps["torch"]["steps"] == STEPS
    assert reps["torch"]["ckpt_save_s"] is not None
    steps = {n: [r for r in _records(os.path.join(runs[n]["dir"],
                                                  "events.jsonl"))
                 if r["kind"] == "step"] for n in ("jax", "torch")}
    assert [(r["step"], r["samples"]) for r in steps["torch"]] \
        == [(r["step"], r["samples"]) for r in steps["jax"]]

    def counters(d):
        snap = [r for r in _records(os.path.join(d, "events.jsonl"))
                if r["kind"] == "metrics"][-1]
        return {m["name"]: m["value"] for m in snap["metrics"]
                if m["name"] in ("train_steps_total", "ckpt_saves_total",
                                 "heartbeat_step")}
    assert counters(runs["torch"]["dir"]) == counters(runs["jax"]["dir"])
    assert counters(runs["torch"]["dir"])["ckpt_saves_total"] == 1

    def scalars(d):
        out = {}
        for r in _records(os.path.join(d, "tb", "events.jsonl")):
            if "compile" not in r["tag"]:      # the jit monitor's (JAX)
                out[(r["tag"], r["step"])] = r["value"]
        return out
    js, ts = scalars(runs["jax"]["dir"]), scalars(runs["torch"]["dir"])
    assert set(ts) == set(js)
    train = {k: v for k, v in ts.items() if k[0].startswith("Train/")}
    assert {tag for tag, _ in train} == {"Train/loss", "Train/lr",
                                         "Train/loss_scale"}
    assert sorted({s for _, s in train}) == list(range(1, STEPS + 1))
    # the telemetry bridge's synced scalars share names; times and
    # memory are this machine's, not the model's
    for k, v in ts.items():
        if k[0].startswith("Train/") or k[0].split("/")[-1] in (
                "loss", "grad_norm", "loss_scale", "lr"):
            assert abs(v - js[k]) <= 1e-4 * max(1.0, abs(js[k])), \
                (k, v, js[k])


def test_losses_with_telemetry_equal_without_bitwise(runs, tmp_path):
    eng = _port(_config())
    losses = [float(eng.train_batch(_batch(s))) for s in range(STEPS)]
    eng.close()
    assert losses == runs["torch"]["losses"]


class _ReadCounter:
    """Counts every read of a tensor's value into host Python (the
    points where a CUDA tensor would synchronize)."""

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


def test_train_batch_adds_no_read(tmp_path):
    """The overhead contract (``tests/test_telemetry.py:341``): between
    ``steps_per_print`` boundaries a telemetry-enabled step reads the
    card exactly as often as a telemetry-off one — none."""
    counts = {}
    for on in (False, True):
        eng = _port(_config(tmp_path / "tel" if on else None,
                            steps_per_print=10 ** 9))
        eng.train_batch(_batch(0))            # warm
        with pytest.MonkeyPatch.context() as mp:
            rc = _ReadCounter(mp)
            for s in range(1, 5):
                eng.train_batch(_batch(s))
            counts[on] = rc.count
        eng.close()
    assert counts[True] == counts[False] == 0, counts


def test_engine_trace_prom_and_events(tmp_path):
    """``tests/test_telemetry.py``'s engine artifacts on the port: the
    periodic sync fires, close is idempotent, trace.json is Chrome
    trace-event JSON with the train spans, metrics.prom parses, and
    events.jsonl has step, sync and metrics records that summarize
    reads."""
    eng = _port(_config(tmp_path, steps_per_print=10 ** 9))
    for s in range(4):
        eng.train_batch(_batch(s))
    eng.config.steps_per_print = 1
    eng.train_batch(_batch(98))
    eng.train_batch(_batch(99))
    eng.close()
    eng.close()
    evs = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    assert evs and all("ph" in e and "ts" in e and "name" in e for e in evs)
    names = {e["name"] for e in evs}
    assert {"train/dispatch", "train/shard_batch",
            "train/steps_interval"} <= names
    for line in open(tmp_path / "metrics.prom"):
        if line.strip():
            assert _PROM_LINE.match(line.strip()), line
    kinds = {r["kind"] for r in _records(tmp_path / "events.jsonl")}
    assert {"step", "sync", "metrics"} <= kinds
    rep = summarize(str(tmp_path / "events.jsonl"))
    assert rep["steps"] == 6 and rep["p50_s"] is not None


def test_track_program_is_false_under_eager_torch(tmp_path):
    eng = _port(_config(tmp_path))
    assert eng.telemetry.track_program("train_step",
                                       eng._train_step) is False
    assert "train_step" not in eng.telemetry.compile_monitor \
        .tracked_programs()
    eng.close()


def test_engine_close_flushes_buffered_scalars(tmp_path):
    """``tests/test_timer_monitor.py:176``: scalars buffered before any
    steps_per_print boundary land in the writer on close()."""
    cfg = _config(steps_per_print=10 ** 9)
    cfg["tensorboard"] = {"enabled": True, "output_path": str(tmp_path),
                          "job_name": "close_test"}
    eng = _port(cfg)
    eng.train_batch(_batch(0))
    eng.train_batch(_batch(1))
    assert eng._tb_pending
    eng.close()
    eng.close()
    recs = _records(tmp_path / "close_test" / "events.jsonl")
    assert sorted({r["step"] for r in recs}) == [1, 2]
    assert "Train/loss" in {r["tag"] for r in recs}


def test_async_overlap_visible_in_tracer(tmp_path, monkeypatch):
    """``tests/test_resilience.py:608``: with injected write latency the
    checkpoint/async_write span runs past its checkpoint/save span and a
    later train/dispatch starts inside the write window."""
    eng = _port(_config(steps_per_print=10 ** 9, telemetry={
        "enabled": True, "output_path": str(tmp_path / "tel"),
        "compile_events": False, "memory": False}))
    eng.train_batch(_batch(0))
    monkeypatch.setenv("DS_CKPT_DELAY_S", "0.2")
    eng.save_checkpoint(str(tmp_path / "ck"), async_write=True)
    eng.train_batch(_batch(1))
    eng.train_batch(_batch(2))
    assert eng._ckpt_writer.drain() is None
    ev = [e for e in eng.telemetry.tracer.events() if e.get("ph") == "X"]

    def spans(name):
        return [(e["ts"], e["ts"] + e["dur"]) for e in ev
                if e["name"] == name]
    (s0, s1), = spans("checkpoint/save")
    (w0, w1), = spans("checkpoint/async_write")
    assert w1 > s1 + 0.1e6, "write did not run past the save call"
    dispatch = [t for t in spans("train/dispatch") if t[0] > s1]
    assert dispatch and dispatch[0][0] < w1
    eng.close()


def test_ckpt_scalars_flow_to_summarize(tmp_path):
    """``tests/test_resilience.py:639``: ckpt_save_s and
    ckpt_async_overlap_s ride the periodic sync into summarize."""
    eng = _port(_config(steps_per_print=2, telemetry={
        "enabled": True, "output_path": str(tmp_path / "tel"),
        "compile_events": False, "memory": False}))
    eng.train_batch(_batch(0))
    eng.save_checkpoint(str(tmp_path / "ck"), async_write=True)
    assert eng._ckpt_writer.drain() is None
    for s in range(1, 4):
        eng.train_batch(_batch(s))
    eng.close()
    rep = summarize(str(tmp_path / "tel" / "events.jsonl"))
    assert rep["ckpt_save_s"] is not None
    assert rep["ckpt_async_overlap_s"] is not None \
        and rep["ckpt_async_overlap_s"] > 0


def test_anomaly_trigger_fires_once(tmp_path, monkeypatch):
    """A slow interval past anomaly_ratio x the trailing median fires ONE
    flight record and one bounded capture, closed at the next sync; a
    later slow interval does not fire again."""
    eng = _port(_config(steps_per_print=10 ** 9, telemetry={
        "enabled": True, "output_path": str(tmp_path),
        "anomaly_ratio": 2.0}))
    calls = []

    class _Capture:
        def stop(self):
            calls.append("stop")

        def export_chrome_trace(self, path):
            calls.append(("export", path))

    monkeypatch.setattr(eng, "_start_capture",
                        lambda: calls.append("start") or _Capture())
    for avg in [0.1] * 6:
        eng._anomaly_check(avg)
    assert not eng._anomaly_fired and not calls
    eng._anomaly_check(0.5)
    assert eng._anomaly_fired and calls == ["start"]
    recs = glob.glob(os.path.join(str(tmp_path), "flightrec_*.json"))
    assert len(recs) == 1
    assert "anomaly" in json.load(open(recs[0]))["reason"]
    eng._anomaly_check(0.5)
    assert calls[:2] == ["start", "stop"]
    assert "anomaly_profile" in calls[2][1]
    eng._anomaly_check(5.0)
    eng.close()
    assert [c for c in calls if c in ("start", "stop")] == ["start", "stop"]


def test_anomaly_trigger_off_by_default(tmp_path, monkeypatch):
    eng = _port(_config(tmp_path, steps_per_print=10 ** 9))
    monkeypatch.setattr(eng, "_start_capture",
                        lambda: pytest.fail("capture opened"))
    for avg in [0.1] * 6 + [9.9]:
        eng._anomaly_check(avg)
    assert not eng._anomaly_fired
    eng.close()


def test_heartbeat_rows_match_the_reference(runs):
    """The liveness and straggler rows of summarize read the same from
    both engines' events, and each wrote one heartbeat file."""
    for name in ("jax", "torch"):
        hb = glob.glob(os.path.join(runs[name]["dir"], "heartbeats",
                                    "heartbeat_*.json"))
        assert len(hb) == 1
        beat = json.load(open(hb[0]))
        assert beat["step"] == STEPS
    rj = jax_summarize(os.path.join(runs["jax"]["dir"], "events.jsonl"))
    rt = summarize(os.path.join(runs["torch"]["dir"], "events.jsonl"))
    assert rt["liveness_hosts"] == rj["liveness_hosts"] == 1
    assert rt["straggler_detected_total"] \
        == rj["straggler_detected_total"] == 0


def test_profiler_window_writes_a_chrome_trace(tmp_path):
    """The profiler window over steps 1-2 is a torch.profiler capture
    exported as Chrome trace JSON under profiler.output_path; the
    wall-clock timers log each boundary; losses are unchanged."""
    ref = _port(_config())
    want = [float(ref.train_batch(_batch(s))) for s in range(STEPS)]
    ref.close()
    eng = _port(_config(steps_per_print=2, wall_clock_breakdown=True,
                        profiler={"enabled": True, "start_step": 1,
                                  "num_steps": 2,
                                  "output_path": str(tmp_path / "prof")}))
    got = [float(eng.train_batch(_batch(s))) for s in range(STEPS)]
    eng.close()
    assert got == want
    (trace,) = glob.glob(str(tmp_path / "prof" / "*.json"))
    assert os.path.basename(trace) == "trace_steps1-2.json"
    doc = json.load(open(trace))
    assert doc["traceEvents"]
    assert set(eng.timers.timers) == {"train_batch_data",
                                      "train_batch_step"}


def test_train_batch_failure_dumps_one_flight_record(tmp_path):
    eng = _port(_config(tmp_path, steps_per_print=10 ** 9))
    bad = np.zeros((3, T + 1), np.int32)      # not train_batch_size rows
    for _ in range(2):
        with pytest.raises(ValueError):
            eng.train_batch(bad)
    recs = glob.glob(os.path.join(str(tmp_path), "flightrec_*.json"))
    assert len(recs) == 1
    rec = json.load(open(recs[0]))
    assert rec["reason"] == "train_batch failure"
    assert "ValueError" in rec["error"]
    eng.close()


def test_telemetry_config_knobs_no_longer_refused():
    cfg = _config(steps_per_print=10 ** 9, wall_clock_breakdown=True,
                  profiler={"enabled": True, "start_step": 0,
                            "num_steps": 1, "output_path": "unused"})
    eng = _port(cfg)
    assert eng.timers is not None and eng._profiler is not None
    eng.close()
