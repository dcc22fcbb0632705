"""Port parity: ``deepspeed_tpu_torch``'s ServeEngine (on the CPU) against
the JAX package's ServeEngine (``attn_impl="flash"``, ``decode_impl``
auto → the Pallas decode kernel in interpret mode) on the same weights,
prompts and config: greedy streams and finish reasons must be equal.  A
token that flips on a near tie (top-2 logit gap below 1e-3 at that step)
is reported with its gap and ends the comparison of that stream.
"""
import numpy as np
import pytest
import jax
import torch

from deepspeed_tpu.inference import ServeEngine as JaxServeEngine
from deepspeed_tpu.models.gpt2 import (GPT2Config as JaxConfig,
                                       GPT2Model as JaxModel)
from deepspeed_tpu.runtime.stages import \
    reset_fault_injection as jax_reset_faults
from deepspeed_tpu_torch.inference import ServeEngine
from deepspeed_tpu_torch.models.gpt2 import (GPT2Config, GPT2Model,
                                             gpt2_prefill,
                                             params_from_numpy)
from deepspeed_tpu_torch.runtime.stages import reset_fault_injection

from test_torch_zero import one_thread  # noqa: F401

SMALL = dict(vocab_size=256, n_positions=64, d_model=64, n_layer=2,
             n_head=4)
GAP = 1e-3


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    for env in ("DS_STAGE_FAULT", "DS_STAGE_DELAY_S"):
        monkeypatch.delenv(env, raising=False)
    reset_fault_injection()
    jax_reset_faults()
    yield
    reset_fault_injection()
    jax_reset_faults()


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxConfig(**SMALL, remat=None, attn_impl="flash")
    tree = jax.tree.map(np.asarray, JaxModel(jcfg).init(
        jax.random.PRNGKey(0)))
    return jcfg, tree, GPT2Config(**SMALL, attn_impl="flash")


def _cfg(slots=3, max_seq=32, prefill=8):
    return {"serving": {"slots": slots, "max_seq_len": max_seq,
                        "prefill_len": prefill}}


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, 256, n)] for n in lengths]


def _serve(engine, load):
    reqs = [engine.submit(p, max_new_tokens=n, eos_id=e)
            for p, n, e in load]
    engine.run_until_idle()
    out = [(r.tokens, r.finish_reason, r.error) for r in reqs]
    engine.close()
    return out


def _run_port(weights, load, cfg):
    _, tree, pcfg = weights
    return _serve(ServeEngine(GPT2Model(pcfg), cfg,
                              params=params_from_numpy(tree),
                              device="cpu"), load)


def _run_jax(weights, load, cfg):
    jcfg, tree, _ = weights
    return _serve(JaxServeEngine(JaxModel(jcfg), cfg, params=tree), load)


def _top2_gap(pcfg, params, seq):
    logits, _, _ = gpt2_prefill(pcfg, params, torch.tensor([seq]))
    top = torch.topk(logits[0, -1], 2).values
    return float(top[0] - top[1])


def _assert_streams_agree(weights, load, ours, ref):
    """Equal streams and finish reasons; a flip is tolerated only on a
    near tie, reported with its gap."""
    _, tree, pcfg = weights
    params = params_from_numpy(tree)
    for (prompt, _, _), (toks, why, err), (rtoks, rwhy, rerr) in zip(
            load, ours, ref):
        assert err is None and rerr is None
        if toks == rtoks:
            assert why == rwhy
            continue
        i = next(i for i, (a, b) in enumerate(zip(toks, rtoks)) if a != b)
        gap = _top2_gap(pcfg, params, prompt + toks[:i])
        print(f"near-tie flip at token {i} of prompt len {len(prompt)}: "
              f"{toks[i]} vs {rtoks[i]}, top-2 gap {gap:.3g}")
        assert gap < GAP, (f"stream diverges at token {i} with top-2 logit "
                           f"gap {gap} >= {GAP}: not a near tie")


def test_serve_mixed_load_matches_jax(weights):
    """More requests than slots (admission mid-flight and slot reuse), a
    1-token prompt, a full-bucket prompt, a kv_capacity finish and an
    eos_id finish."""
    prompts = _prompts([1, 5, 8, 3, 2, 7, 4])
    budgets = [6, 9, 30, 4, 7, 3, 8]
    probe = _run_port(weights, [(p, n, None) for p, n in
                                zip(prompts, budgets)], _cfg())
    # eos = the 3rd token of request 4's own stream: it must stop there
    eos = probe[4][0][2]
    load = [(p, n, eos if i == 4 else None)
            for i, (p, n) in enumerate(zip(prompts, budgets))]
    ours = _run_port(weights, load, _cfg())
    ref = _run_jax(weights, load, _cfg())
    _assert_streams_agree(weights, load, ours, ref)
    assert ours[4][1] == "eos" and ours[4][0][-1] == eos
    assert ours[2][1] == "kv_capacity" and len(ours[2][0]) == 32 - 8 + 1
    assert ours[0][1] == "length"


def test_serve_slot_reuse_matches_jax(weights):
    """One slot, three requests in turn: a slot's stale rows from an
    evicted request never leak into the next one."""
    load = [(p, 6, None) for p in _prompts([7, 4, 2], seed=11)]
    ours = _run_port(weights, load, _cfg(slots=1))
    _assert_streams_agree(weights, load, ours,
                          _run_jax(weights, load, _cfg(slots=1)))
    alone = _run_port(weights, load[1:2], _cfg(slots=1))
    assert ours[1][0] == alone[0][0]


def test_serve_submit_validation_matches_jax(weights):
    jcfg, tree, pcfg = weights
    for eng in (ServeEngine(GPT2Model(pcfg), _cfg(prefill=4),
                            device="cpu"),
                JaxServeEngine(JaxModel(jcfg), _cfg(prefill=4),
                               params=tree)):
        with pytest.raises(ValueError, match="empty prompt"):
            eng.submit([])
        with pytest.raises(ValueError, match="prefill_len"):
            eng.submit([1, 2, 3, 4, 5])
        with pytest.raises(ValueError, match="max_new_tokens"):
            eng.submit([1], max_new_tokens=0)
        with pytest.raises(ValueError, match="paged"):
            eng.submit([1], detach_kv=True)
        with pytest.raises(ValueError, match="LoRA is off"):
            eng.submit([1], adapter_id=3)
        queued = eng.submit([1, 2], max_new_tokens=2)
        eng.close()
        with pytest.raises(RuntimeError, match="closed"):
            queued.result(timeout=0)
        with pytest.raises(RuntimeError, match="closed"):
            eng.submit([1])
        eng.close()  # idempotent


@pytest.mark.parametrize("spec,failures", [
    ("serve:step:1", 1), ("serve:admit:1,serve:step:2", 2)])
def test_serve_transient_faults_absorbed_like_jax(weights, monkeypatch,
                                                  spec, failures):
    """Transient injected faults (``DS_STAGE_FAULT``) at the serve stage's
    points are retried in both engines: same failure count, no
    degradation, the fault-free stream."""
    load = [(p, 5, None) for p in _prompts([3, 6], seed=31)]
    clean = _run_port(weights, load, _cfg(slots=2))
    monkeypatch.setenv("DS_STAGE_FAULT", spec)
    jcfg, tree, pcfg = weights
    for make in (lambda: ServeEngine(GPT2Model(pcfg), _cfg(slots=2),
                                     params=params_from_numpy(tree),
                                     device="cpu"),
                 lambda: JaxServeEngine(JaxModel(jcfg), _cfg(slots=2),
                                        params=tree)):
        reset_fault_injection()
        jax_reset_faults()
        eng = make()
        reqs = [eng.submit(p, max_new_tokens=n) for p, n, _ in load]
        eng.run_until_idle()
        assert eng.stage.failures == failures and not eng.stage.degraded
        assert all(r.error is None for r in reqs)
        assert [r.tokens for r in reqs] == [c[0] for c in clean]
        eng.close()
