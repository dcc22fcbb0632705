"""``tests/test_prefetch.py``'s cases on the port's input pipeline
(``deepspeed_tpu_torch/runtime/prefetch.py``): the ``data_prefetch`` block
wraps the engine's training loader in a ``DevicePrefetcher`` (on the
card: pinned host copies placed on a side stream, the step's stream
waiting on each batch's event; here on the CPU the placement is a plain
move), and the prefetched run equals the inline one (``DS_PREFETCH=0``)
bit for bit — losses and state — on the plain and the host-offload
engine.  The prefetcher's worker, poison, exhaustion, close and
lookahead contracts are the JAX module's.
"""
import threading
import time

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.config import DeepSpeedConfig, DeepSpeedConfigError
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
from deepspeed_tpu_torch.runtime.prefetch import (DevicePlacedBatch,
                                                  DevicePrefetcher)
from deepspeed_tpu_torch.runtime.stages import reset_fault_injection

from simple_model import base_config
from test_torch_checkpointing import HIDDEN, SimpleModel


def _dataset(n, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((n, HIDDEN)).astype(np.float32)
    return [(xs[i], 0.5 * xs[i]) for i in range(n)]


def _engine(monkeypatch, prefetch_on=True, n_batches=4, cfg_over=None,
            dataset=None):
    cfg = base_config(micro_bs=2, grad_acc=2)
    cfg.update(cfg_over or {})
    if prefetch_on:
        monkeypatch.delenv("DS_PREFETCH", raising=False)
    else:
        monkeypatch.setenv("DS_PREFETCH", "0")
    eng, *_ = dst.initialize(
        model=SimpleModel(), config=cfg, device="cpu", seed=3,
        training_data=(dataset if dataset is not None
                       else _dataset(4 * n_batches)))
    assert eng._prefetch_enabled == prefetch_on
    return eng


def _train(eng, steps):
    return [float(eng.train_batch()) for _ in range(steps)]


def _state(eng):
    st = eng._canonical_state()
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        else:
            leaves.append(torch.as_tensor(t).clone())
    walk(st)
    return leaves


@pytest.mark.parametrize("tier", ["plain", "host_offload"])
def test_prefetch_bitwise_equals_inline(monkeypatch, tier):
    """4 steps over the same loader: identical losses and state with the
    prefetcher and inline (the escape hatch is the reference)."""
    over = ({"zero_optimization": {"stage": 2, "cpu_offload": True}}
            if tier == "host_offload" else None)
    e_on = _engine(monkeypatch, True, cfg_over=over)
    e_off = _engine(monkeypatch, False, cfg_over=over)
    assert isinstance(e_on._training_iter(), DevicePrefetcher)
    assert not isinstance(e_off._training_iter(), DevicePrefetcher)
    assert _train(e_on, 4) == _train(e_off, 4)
    for a, b in zip(_state(e_on), _state(e_off)):
        assert torch.equal(a, b)
    e_on.close()
    e_off.close()


def test_stop_iteration_propagates_after_draining():
    pf = DevicePrefetcher(iter([np.zeros(2), np.ones(2)]), depth=4)
    assert np.asarray(next(pf)).sum() == 0
    assert np.asarray(next(pf)).sum() == 2
    with pytest.raises(StopIteration):
        next(pf)
    with pytest.raises(StopIteration):  # stays exhausted
        next(pf)


def test_engine_epoch_boundary_stop_iteration(monkeypatch):
    e = _engine(monkeypatch, True, n_batches=2)
    _train(e, 2)
    with pytest.raises(StopIteration):
        e.train_batch()
    e.close()


def test_worker_source_failure_poisons_with_original_error():
    def gen():
        yield np.zeros(2)
        raise ValueError("collate died")

    pf = DevicePrefetcher(gen(), depth=2)
    next(pf)  # the batch produced before the failure drains first
    with pytest.raises(ValueError, match="collate died"):
        next(pf)
    with pytest.raises(ValueError, match="collate died"):  # poisoned
        next(pf)


def test_worker_place_failure_poisons():
    seen = {"n": 0}

    def place(b):
        seen["n"] += 1
        if seen["n"] > 1:
            raise RuntimeError("h2d link died")
        return b

    pf = DevicePrefetcher(iter([np.zeros(2)] * 4), place_fn=place, depth=2)
    next(pf)
    with pytest.raises(RuntimeError, match="h2d link died"):
        next(pf)


def test_transient_place_faults_degrade_to_inline(monkeypatch):
    """Sticky injected placement faults exhaust the stage's budget: the
    stage degrades and every batch still arrives, in order."""
    monkeypatch.setenv("DS_STAGE_FAULT", "prefetch:place:1+")
    reset_fault_injection()
    try:
        pf = DevicePrefetcher(iter([np.full(2, i) for i in range(5)]),
                              depth=2)
        got = [int(np.asarray(b)[0]) for b in pf]
        assert got == [0, 1, 2, 3, 4]
        assert pf.stage.degraded
    finally:
        monkeypatch.delenv("DS_STAGE_FAULT")
        reset_fault_injection()


def test_close_idempotent_and_releases_worker():
    before = set(threading.enumerate())
    pf = DevicePrefetcher(iter([np.zeros(2)] * 8), depth=2)
    workers = set(threading.enumerate()) - before
    next(pf)
    pf.close()
    pf.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        next(pf)
    deadline = time.perf_counter() + 5.0
    while any(t.is_alive() for t in workers) and \
            time.perf_counter() < deadline:
        time.sleep(0.01)
    assert not any(t.is_alive() for t in workers), "worker leaked"


def test_engine_close_drains_prefetcher(monkeypatch):
    e = _engine(monkeypatch, True)
    _train(e, 1)
    pf = e._train_prefetcher
    assert pf is not None and not pf.closed
    e.close()
    assert pf.closed


def test_depth_bounds_lookahead():
    class Counting:
        def __init__(self):
            self.count = 0

        def __next__(self):
            self.count += 1
            return np.zeros(2)

    src = Counting()
    pf = DevicePrefetcher(src, depth=2)
    deadline = time.perf_counter() + 5.0
    while src.count < 2 and time.perf_counter() < deadline:
        time.sleep(0.01)
    time.sleep(0.1)  # the worker is parked at the bound now
    assert src.count == 2, src.count
    next(pf)
    deadline = time.perf_counter() + 5.0
    while src.count < 3 and time.perf_counter() < deadline:
        time.sleep(0.01)
    time.sleep(0.1)
    assert src.count == 3, src.count
    pf.close()


def test_depth_validation():
    with pytest.raises(ValueError, match="depth"):
        DevicePrefetcher(iter([]), depth=0)
    with pytest.raises(DeepSpeedConfigError, match="depth"):
        DeepSpeedConfig(base_config(data_prefetch={"depth": 0}))
    cfg = DeepSpeedConfig(base_config())
    assert cfg.data_prefetch_config.enabled is True  # default ON
    assert cfg.data_prefetch_config.depth == 2


def test_train_batch_adopts_external_prefetcher(monkeypatch):
    ds = _dataset(4 * 3)
    e_pf = _engine(monkeypatch, False, dataset=ds)
    e_ref = _engine(monkeypatch, False, dataset=ds)
    pf = e_pf.prefetch(iter(DeepSpeedDataLoader(ds, batch_size=4)))
    got = [float(e_pf.train_batch(data_iter=pf)) for _ in range(3)]
    assert got == _train(e_ref, 3)
    assert e_pf._train_prefetcher is pf
    e_pf.close()
    assert pf.closed
    e_ref.close()


def test_eval_batch_adopts_prefetched_and_kinds_are_checked(monkeypatch):
    ds = _dataset(8)
    e = _engine(monkeypatch, False, dataset=ds)
    batches = [(np.stack([x for x, _ in ds[i:i + 2]]),
                np.stack([y for _, y in ds[i:i + 2]])) for i in (0, 2)]
    pf = e.prefetch(iter(batches), for_eval=True)
    got = [float(e.eval_batch(data_iter=pf)) for _ in range(2)]
    assert got == [float(e.eval_batch(b)) for b in batches]
    placed = DevicePlacedBatch(batches[0], kind="eval")
    with pytest.raises(ValueError, match="train placement"):
        e.train_batch(placed)
    with pytest.raises(ValueError, match="eval placement"):
        e.eval_batch(DevicePlacedBatch(batches[0], kind="train"))
    e.close()


def test_data_iterator_state_counts_queued_batches_as_not_drawn(
        monkeypatch):
    """The checkpoint's data plane names the next batch ``train_batch``
    will see, though the prefetcher has staged batches ahead."""
    e = _engine(monkeypatch, True, n_batches=6)
    _train(e, 2)
    pf = e._train_prefetcher
    deadline = time.perf_counter() + 5.0
    while pf.qsize() < 2 and time.perf_counter() < deadline:
        time.sleep(0.01)
    state = e.data_iterator_state()
    e2 = _engine(monkeypatch, False, n_batches=6)
    _train(e2, 2)
    assert state == e2.data_iterator_state()
    e.close()
    e2.close()


def test_prefetch_telemetry_scalars(monkeypatch, tmp_path):
    import json
    e = _engine(monkeypatch, True, n_batches=4, cfg_over={
        "steps_per_print": 2,
        "telemetry": {"enabled": True, "output_path": str(tmp_path)}})
    _train(e, 4)
    e.close()
    recs = [json.loads(line) for line in open(tmp_path / "events.jsonl")
            if line.strip()]
    assert any("prefetch_hit_ratio" in (r.get("scalars") or {})
               for r in recs)
    trace = json.load(open(tmp_path / "trace.json"))
    names = {ev.get("name") for ev in trace.get("traceEvents", trace)}
    assert {"data/prefetch_place", "data/prefetch_wait"} <= names
