"""KV-page migration (the disaggregated fleet's ``detach_kv``,
``export_pages``, ``adopt_request``) across the two packages, on the paged
pool with fp32 and int8 pages: equal per-leaf page sizes; with a pool's
contents carried across, byte-identical export payloads; a JAX engine's
prefill adopted by the port's engine continues to the JAX bare engine's
stream, and the reverse direction to the port's (greedy; a flip allowed
only on a near tie, top-2 logit gap below 1e-3); a payload of the wrong
size, page count or adapter raises before any page is taken or any byte
lands."""
import numpy as np
import pytest
import jax
import torch

from deepspeed_tpu.inference import ServeEngine as JaxServeEngine
from deepspeed_tpu.models.gpt2 import (GPT2Config as JaxConfig,
                                       GPT2Model as JaxModel)
from deepspeed_tpu_torch.inference import ServeEngine
from deepspeed_tpu_torch.inference.scheduler import Request
from deepspeed_tpu_torch.models.gpt2 import (GPT2Config, GPT2Model,
                                             gpt2_prefill,
                                             params_from_numpy)

from test_torch_zero import one_thread  # noqa: F401

TINY = dict(vocab_size=128, n_positions=64, d_model=32, n_layer=2,
            n_head=4, remat=None, attn_impl="dense")
NEAR_TIE = 1e-3
NEW = 8
POOLS = {"fp32": {}, "int8": {"quantization": {"kv": "int8"}}}


@pytest.fixture(scope="module")
def weights():
    tree = jax.tree.map(np.asarray, JaxModel(JaxConfig(**TINY)).init(
        jax.random.PRNGKey(0)))
    return tree


def _serving(pool, lora=False):
    s = {"slots": 3, "max_seq_len": 64, "prefill_len": 32, "page_len": 8,
         "pages": 24, "prefix_cache": False, **POOLS[pool]}
    if lora:
        s["lora"] = {"rank": 4, "alpha": 8.0, "hbm_adapter_slots": 2,
                     "max_adapters": 8}
    return {"serving": s}


def _jax(tree, pool, lora=False):
    return JaxServeEngine(JaxModel(JaxConfig(**TINY)), _serving(pool, lora),
                          params=tree)


def _port(tree, pool, lora=False):
    return ServeEngine(GPT2Model(GPT2Config(**TINY)), _serving(pool, lora),
                       params=params_from_numpy(tree), device="cpu")


def _prompts():
    rng = np.random.default_rng(5)
    # 17 tokens: two full pages and a 1-token tail; 8: one full page
    return [[int(t) for t in rng.integers(0, 128, n)] for n in (17, 8, 3)]


def _prefill_and_export(eng, prompt):
    """The prefill leg of a migration: one token, pages detached."""
    req = eng.submit(prompt, max_new_tokens=1, detach_kv=True)
    eng.run_until_idle()
    assert req.error is None and len(req.tokens) == 1
    payloads = eng.export_pages(req)
    eng.release_detached(req)
    return req.tokens[0], payloads


def _bare(eng, prompts):
    reqs = [eng.submit(p, max_new_tokens=NEW) for p in prompts]
    eng.run_until_idle()
    eng.close()
    return [list(r.tokens) for r in reqs]


def _near_tie_equal(tree, prompt, ours, ref):
    """``ours == ref``, a flip allowed only where the reference model's
    top-2 logits are within NEAR_TIE."""
    if ours == ref:
        return
    i = next(i for i, (a, b) in enumerate(zip(ours, ref)) if a != b)
    logits, _, _ = gpt2_prefill(GPT2Config(**TINY), params_from_numpy(tree),
                                torch.tensor([prompt + ref[:i]]))
    top = torch.topk(logits[0, -1].float(), 2).values
    gap = float(top[0] - top[1])
    assert gap < NEAR_TIE, (i, ours, ref, gap)


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_page_leaf_nbytes_equal(weights, pool):
    j, t = _jax(weights, pool), _port(weights, pool)
    assert t.page_leaf_nbytes() == j.page_leaf_nbytes()
    assert len(t.page_leaf_nbytes()) == (4 if pool == "int8" else 2)
    j.close()
    t.close()


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_export_bytes_identical_with_the_pool_carried_across(weights,
                                                             pool):
    """The JAX engine prefills (detached); its pool's leaves are copied
    into the port's pool; the port's export of the same pages is the JAX
    export byte for byte."""
    j, t = _jax(weights, pool), _port(weights, pool)
    prompt = _prompts()[0]
    jreq = j.submit(prompt, max_new_tokens=1, detach_kv=True)
    j.run_until_idle()
    jpay = j.export_pages(jreq)
    assert len(jpay) == 3
    for k in t._page_leaves():
        t.cache[k].copy_(torch.from_numpy(np.array(j.cache[k])))
    treq = Request(rid=1, prompt=prompt, max_new_tokens=1)
    treq.pages = list(jreq.pages)
    assert t.export_pages(treq) == jpay
    j.release_detached(jreq)
    j.close()
    t.close()


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_jax_prefill_adopted_by_the_port(weights, pool):
    ref = _bare(_jax(weights, pool), _prompts())
    src, dst = _jax(weights, pool), _port(weights, pool)
    free0 = dst.pool.free_count
    out = []
    for p in _prompts():
        first, payloads = _prefill_and_export(src, p)
        req = dst.adopt_request(p, first, NEW, None, payloads)
        assert req is not None
        dst.run_until_idle()
        assert req.error is None and req.finish_reason == "length"
        out.append(list(req.tokens))
    for p, a, b in zip(_prompts(), out, ref):
        _near_tie_equal(weights, p, a, b)
    assert dst.pool.free_count == free0       # adopted pages freed
    src.close()
    dst.close()


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_port_prefill_adopted_by_jax(weights, pool):
    ref = _bare(_port(weights, pool), _prompts())
    src, dst = _port(weights, pool), _jax(weights, pool)
    free0 = src.pool.free_count
    out = []
    for p in _prompts():
        first, payloads = _prefill_and_export(src, p)
        req = dst.adopt_request(p, first, NEW, None, payloads)
        assert req is not None
        dst.run_until_idle()
        assert req.error is None
        out.append(list(req.tokens))
    assert src.pool.free_count == free0       # released after export
    for p, a, b in zip(_prompts(), out, ref):
        _near_tie_equal(weights, p, a, b)
    src.close()
    dst.close()


def test_port_round_trip_is_bitwise(weights):
    """Inside the port a migrated request's stream equals the bare
    engine's bit for bit, and the adopted pool holds the exported bytes
    (a second export of the adopted request's pages is identical)."""
    ref = _bare(_port(weights, "fp32"), _prompts())
    src, dst = _port(weights, "fp32"), _port(weights, "fp32")
    for p, want in zip(_prompts(), ref):
        first, payloads = _prefill_and_export(src, p)
        req = dst.adopt_request(p, first, NEW, None, payloads)
        again = Request(rid=0, prompt=p, max_new_tokens=1)
        again.pages = list(req.pages)
        assert dst.export_pages(again) == payloads
        dst.run_until_idle()
        assert list(req.tokens) == want
    src.close()
    dst.close()


def _bad_cases(payloads, prompt):
    short = [payloads[0][:-1]] + payloads[1:]
    return {
        "size": (prompt, short, 0, "bytes"),
        "page count": (prompt, payloads[:-1], 0, "pages"),
        "adapter": (prompt, payloads, 3, "adapter"),
    }


@pytest.mark.parametrize("case", ["size", "page count", "adapter"])
@pytest.mark.parametrize("pool", sorted(POOLS))
def test_bad_payload_raises_before_any_byte_lands(weights, pool, case):
    src = _jax(weights, pool)
    prompt = _prompts()[0]
    first, payloads = _prefill_and_export(src, prompt)
    src.close()
    p, pay, adapter, msg = _bad_cases(payloads, prompt)[case]
    t, j = _port(weights, pool), _jax(weights, pool)
    before = {k: v.clone() for k, v in t.cache.items()}
    free0, active0 = t.pool.free_count, dict(t.scheduler.active)
    with pytest.raises(ValueError, match=msg):
        t.adopt_request(p, first, NEW, None, pay, adapter_id=adapter)
    assert t.pool.free_count == free0
    assert t.scheduler.active == active0
    for k, v in t.cache.items():
        assert torch.equal(v, before[k]), k
    # the JAX engine refuses the same payload with the same type (its
    # short-payload message is numpy's)
    with pytest.raises(ValueError):
        j.adopt_request(p, first, NEW, None, pay, adapter_id=adapter)
    t.close()
    j.close()


def test_detach_kv_needs_the_paged_pool(weights):
    eng = ServeEngine(GPT2Model(GPT2Config(**TINY)),
                      {"serving": {"slots": 2, "max_seq_len": 64,
                                   "prefill_len": 32}},
                      params=params_from_numpy(weights), device="cpu")
    with pytest.raises(ValueError, match="paged"):
        eng.submit([1, 2, 3], max_new_tokens=1, detach_kv=True)
    with pytest.raises(RuntimeError, match="paged"):
        eng.adopt_request([1, 2, 3], 4, NEW, None, [b""])
    eng.close()


def test_adopt_with_lora_tenant_continues_the_tenant_stream(weights):
    """A tenant's request migrated between two port LoRA engines: the
    adopting engine pins the tenant's adapter (synthesized locally, no
    adapter bytes on the wire) and streams the bare engine's tokens."""
    prompt = _prompts()[0]
    bare = _port(weights, "fp32", lora=True)
    want = bare.submit(prompt, max_new_tokens=NEW, adapter_id=3)
    bare.run_until_idle()
    bare.close()
    src, dst = _port(weights, "fp32", True), _port(weights, "fp32", True)
    req = src.submit(prompt, max_new_tokens=1, detach_kv=True,
                     adapter_id=3)
    src.run_until_idle()
    payloads = src.export_pages(req)
    src.release_detached(req)
    got = dst.adopt_request(prompt, req.tokens[0], NEW, None, payloads,
                            adapter_id=3)
    assert 3 in dst.hot_adapters()
    dst.run_until_idle()
    assert list(got.tokens) == list(want.tokens)
    assert dst.hot_adapters() == [3]          # resident, evictable
    src.close()
    dst.close()
