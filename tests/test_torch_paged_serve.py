"""Port parity, paged KV: ``deepspeed_tpu_torch``'s paged model functions
and paged ``ServeEngine`` (on the CPU; the paged decode kernel runs its
plain version) against the JAX package's (``attn_impl="flash"``; the
Pallas kernels in interpret mode) on the same weights, prompts and config.

Tolerances: the model functions' logits and pools within 1e-4 in fp32
(the two frameworks order their sums differently; logits are O(1)).  The
engines' greedy streams and finish reasons must be equal, a token flip
allowed only on a near tie (top-2 logit gap below 1e-3 at that step,
reported with its gap; the rest of that stream is then not compared);
the allocator state (prefix hits, misses, COW count, free pages, page
refcounts) must be equal exactly.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.inference import ServeEngine as JaxServeEngine
from deepspeed_tpu.models.gpt2 import (
    GPT2Config as JaxConfig, GPT2Model as JaxModel,
    gpt2_decode_step_paged as jax_decode_step_paged,
    gpt2_prefill_paged as jax_prefill_paged)
from deepspeed_tpu.runtime.stages import \
    reset_fault_injection as jax_reset_faults
from deepspeed_tpu_torch.inference import ServeEngine
from deepspeed_tpu_torch.inference.adapters import adapter_param_shapes
from deepspeed_tpu_torch.inference.kv_cache import (PagedKVCacheSpec,
                                                    init_paged_cache)
from deepspeed_tpu_torch.models.gpt2 import (GPT2Config, GPT2Model,
                                             gpt2_decode_step_paged,
                                             gpt2_prefill, gpt2_prefill_paged,
                                             params_from_numpy)
from deepspeed_tpu_torch.runtime.stages import reset_fault_injection

SMALL = dict(vocab_size=256, n_positions=64, d_model=64, n_layer=2,
             n_head=4)
ATOL = 1e-4
GAP = 1e-3
PAGE = 8


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


def _tokens(n, seed):
    return [int(t) for t in np.random.default_rng(seed).integers(0, 256, n)]


# ---------------------------------------------------------------------------
# model functions: prefill_paged (both arms) and decode_step_paged
# ---------------------------------------------------------------------------


def _close(ours, ref):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def test_prefill_and_decode_paged_match_jax(weights):
    """Slot 0 prefills 13 tokens with no prefix (the flash arm), slot 1
    shares slot 0's first page and prefills a 6-token delta after it (the
    gather arm), then both decode 4 ticks next to a free slot.  Scattered
    page ids; logits and the whole pools agree after every call."""
    jcfg, tree, cfg = weights
    params = params_from_numpy(tree)
    L, H, Dh, S, M = 2, 4, 16, 3, 4
    P = 12
    jk = jv = jnp.zeros((L, P, H, PAGE, Dh), jnp.float32)
    spec = PagedKVCacheSpec(layers=L, slots=S, heads=H, pages=P,
                            page_len=PAGE, head_dim=Dh, max_pages=M)
    cache = init_paged_cache(spec)
    table = np.zeros((S, M), np.int32)
    table[0, :3] = [7, 2, 9]          # 13 + 4 decode rows: 3 pages
    table[1, :3] = [7, 5, 11]         # shares page 7 (8 tokens)
    first = _tokens(13, 1)
    second = first[:8] + _tokens(6, 2)
    for prefix, delta, row in ((0, first, table[0]), (8, second[8:],
                                                      table[1])):
        pad = np.zeros((1, 16), np.int32)
        pad[0, :len(delta)] = delta
        lg_j, jk, jv = jax_prefill_paged(
            jcfg, tree, jnp.asarray(pad), np.int32(len(delta)),
            np.int32(prefix), jnp.asarray(row), jk, jv)
        lg, _, _ = gpt2_prefill_paged(cfg, params, torch.from_numpy(pad),
                                      len(delta), prefix,
                                      torch.from_numpy(row), cache["k"],
                                      cache["v"])
        _close(lg[0, :len(delta)], lg_j[0, :len(delta)])
        _close(cache["k"], jk)
        _close(cache["v"], jv)
    lens = np.asarray([13, 14, 0], np.int32)
    active = np.asarray([True, True, False])
    jl, tl = jnp.asarray(lens), torch.from_numpy(lens)
    rng = np.random.default_rng(3)
    for _ in range(4):
        toks = rng.integers(0, 256, (S,), np.int32)
        lg_j, jk, jv, jl = jax_decode_step_paged(
            jcfg, tree, jnp.asarray(toks), jk, jv, jnp.asarray(table), jl,
            jnp.asarray(active))
        lg, _, _, tl = gpt2_decode_step_paged(
            cfg, params, torch.from_numpy(toks), cache["k"], cache["v"],
            torch.from_numpy(table), tl, torch.from_numpy(active))
        _close(lg[:2], lg_j[:2])
        _close(cache["k"], jk)
        _close(cache["v"], jv)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_paged_model_refuses_int8_pool_and_lora(weights):
    """The paged decode step runs the int8 pool (quantize on write, the
    int8 arm on read: the token's row lands in the slot's page with its
    scale, and the logits equal the fp pool's within the quantization's
    reach).  LoRA composes with it: with every slot on the zero adapter
    (pool slot 0, all zeros) the logits are the lora-off logits bit for
    bit."""
    _, tree, cfg = weights
    params = params_from_numpy(tree)
    spec = PagedKVCacheSpec(layers=2, slots=1, heads=4, pages=3,
                            page_len=PAGE, head_dim=16, max_pages=2,
                            dtype=torch.int8, quant=True)
    c = init_paged_cache(spec)
    fp = init_paged_cache(PagedKVCacheSpec(layers=2, slots=1, heads=4,
                                           pages=3, page_len=PAGE,
                                           head_dim=16, max_pages=2))
    table = torch.tensor([[2, 0]], dtype=torch.int32)
    args = (cfg, params, torch.tensor([5]))
    tail = (table, c["lengths"], torch.ones(1, dtype=torch.bool))
    out = gpt2_decode_step_paged(*args, c["k"], c["v"], *tail,
                                 k_scale=c["k_scale"], v_scale=c["v_scale"])
    assert len(out) == 6 and out[-1].tolist() == [1]
    ref = gpt2_decode_step_paged(*args, fp["k"], fp["v"], *tail)
    assert (c["k"][:, 2, :, 0] != 0).any() and (c["k_scale"][:, 2, :, 0]
                                                > 0).all()
    assert (c["k_scale"][:, 2, :, 1:] == 0).all()   # one row written
    np.testing.assert_allclose(out[0].numpy(), ref[0].numpy(), atol=1e-2)
    shapes = adapter_param_shapes(2, 64, 4, ("qkv_w", "out_w", "fc_w",
                                             "proj_w"))
    pools = {t: (torch.zeros((2, 3) + a[1:]), torch.zeros((2, 3) + b[1:]))
             for t, (a, b) in shapes.items()}
    runs = []
    for lora in (None, pools):
        c2 = init_paged_cache(spec)
        runs.append(gpt2_decode_step_paged(
            *args, c2["k"], c2["v"], *tail, k_scale=c2["k_scale"],
            v_scale=c2["v_scale"], lora=lora,
            adapter_slots=torch.zeros(1, dtype=torch.int32),
            lora_scale=2.0)[0])
    assert torch.equal(runs[0], runs[1])
    np.testing.assert_array_equal(runs[0].numpy(), out[0].numpy())


# ---------------------------------------------------------------------------
# the paged engine against the JAX engine
# ---------------------------------------------------------------------------


def _cfg(slots=3, max_seq=40, prefill=24, **extra):
    return {"serving": {"slots": slots, "max_seq_len": max_seq,
                        "prefill_len": prefill, "page_len": PAGE, **extra}}


def _run(engine, load):
    reqs = [engine.submit(p, max_new_tokens=n) for p, n in load]
    engine.run_until_idle()
    out = {"streams": [(r.tokens, r.finish_reason, r.error) for r in reqs],
           "free": engine.pool.free_count,
           "shared": [r.shared_len for r in reqs],
           "computed": [r.computed_len for r in reqs]}
    if engine.prefix is not None:
        out["prefix"] = (engine.prefix.hits, engine.prefix.misses,
                         engine.prefix.cow, engine.prefix.entries)
    engine.close()
    out["refs_after_close"] = dict(engine.pool.refs)
    return out


def _both(weights, load, cfg):
    jcfg, tree, pcfg = weights
    ours = _run(ServeEngine(GPT2Model(pcfg), cfg,
                            params=params_from_numpy(tree), device="cpu"),
                load)
    ref = _run(JaxServeEngine(JaxModel(jcfg), cfg, params=tree), load)
    return ours, ref


def _assert_streams_agree(weights, load, ours, ref):
    """Equal streams and finish reasons; a flip is tolerated only on a
    near tie, reported with its gap."""
    _, tree, pcfg = weights
    params = params_from_numpy(tree)
    for (prompt, _), (toks, why, err), (rtoks, rwhy, rerr) in zip(
            load, ours, ref):
        assert err is None and rerr is None
        if toks == rtoks:
            assert why == rwhy
            continue
        i = next(i for i, (a, b) in enumerate(zip(toks, rtoks)) if a != b)
        logits, _, _ = gpt2_prefill(pcfg, params,
                                    torch.tensor([prompt + toks[:i]]))
        top = torch.topk(logits[0, -1], 2).values
        gap = float(top[0] - top[1])
        print(f"near-tie flip at token {i} of prompt len {len(prompt)}: "
              f"{toks[i]} vs {rtoks[i]}, top-2 gap {gap:.3g}")
        assert gap < GAP, (f"stream diverges at token {i} with top-2 logit "
                           f"gap {gap} >= {GAP}: not a near tie")


def _assert_engines_agree(weights, load, ours, ref):
    _assert_streams_agree(weights, load, ours["streams"], ref["streams"])
    for key in ("free", "shared", "computed", "prefix", "refs_after_close"):
        assert ours.get(key) == ref.get(key), key


TEMPLATE = _tokens(16, 40)                    # exactly two pages


@pytest.mark.parametrize("chunk", [0, 4], ids=["whole", "chunked"])
def test_paged_mixed_load_matches_jax(weights, chunk):
    """Template sharers (full-page hits), identical prompts (a shared
    partial page: COW), a 1-token prompt and a 3-page prompt, more
    requests than slots; with ``prefill_chunk_len`` 4 the long deltas
    prefill across chunk and page boundaries next to decode ticks."""
    load = ([(TEMPLATE + _tokens(n, 41 + n), 6) for n in (3, 7)]
            + [(_tokens(13, 50), 7)] * 3
            + [(_tokens(1, 51), 5), (_tokens(20, 52), 9)])
    ours, ref = _both(weights, load, _cfg(prefill_chunk_len=chunk))
    _assert_engines_agree(weights, load, ours, ref)
    hits, misses, cow, _ = ours["prefix"]
    if not chunk:   # chunked sharers admitted together all miss
        assert hits >= 3 and cow >= 2 and misses >= 3
        assert ours["shared"][1] == 16       # the template's two pages
    assert ours["refs_after_close"] == {}
    assert all(why == "length" for _, why, _ in ours["streams"])


def test_paged_prefix_off_and_slot_reuse_match_jax(weights):
    load = [(_tokens(n, 60 + n), 8) for n in (9, 4, 17, 2)]
    ours, ref = _both(weights, load, _cfg(slots=1, prefix_cache=False))
    _assert_engines_agree(weights, load, ours, ref)
    usable = 1 + 1 * -(-40 // PAGE) - 1
    assert ours["free"] == usable            # every page came back


def test_pool_exhaustion_matches_jax(weights):
    """Admission parks while the pool is dry (order kept), and a request
    that cannot grow into a new page finishes with ``kv_capacity``."""
    load = [(_tokens(9, 70 + i), 3) for i in range(4)]
    ours, ref = _both(weights, load, _cfg(slots=4, pages=5,
                                          prefix_cache=False))
    _assert_engines_agree(weights, load, ours, ref)
    assert all(why == "length" for _, why, _ in ours["streams"])
    load = [(_tokens(8, 80), 50)]
    ours, ref = _both(weights, load, _cfg(slots=2, pages=2,
                                          prefix_cache=False))
    _assert_engines_agree(weights, load, ours, ref)
    toks, why, _ = ours["streams"][0]
    assert why == "kv_capacity" and len(toks) == 1


def test_paged_engine_matches_slot_engine(weights):
    """The paged engine emits the slot-cache engine's streams."""
    _, tree, pcfg = weights
    load = [(_tokens(n, 90 + n), 10) for n in (1, 3, 8, 17, 20)]
    streams = []
    for cfg in (_cfg(), {"serving": {"slots": 3, "max_seq_len": 40,
                                     "prefill_len": 24}}):
        eng = ServeEngine(GPT2Model(pcfg), cfg,
                          params=params_from_numpy(tree), device="cpu")
        reqs = [eng.submit(p, max_new_tokens=n) for p, n in load]
        eng.run_until_idle()
        streams.append([r.tokens for r in reqs])
        eng.close()
    assert streams[0] == streams[1]


def test_paged_submit_validation_and_unported_migration(weights):
    _, tree, pcfg = weights
    eng = ServeEngine(GPT2Model(pcfg), _cfg(slots=2, pages=3),
                      params=params_from_numpy(tree), device="cpu")
    with pytest.raises(ValueError, match="KV pages"):
        eng.submit(_tokens(17, 1))           # 3 pages, 2 usable
    # KV-page migration is ported: a detach_kv request keeps its page for
    # export_pages until release_detached; a request holding no pages has
    # nothing to export, and a payload list of the wrong length is refused
    req = eng.submit(_tokens(3, 1), max_new_tokens=1, detach_kv=True)
    eng.run_until_idle()
    assert req.error is None and len(req.pages) == 1
    assert [len(p) for p in eng.export_pages(req)] \
        == [sum(eng.page_leaf_nbytes())]
    eng.release_detached(req)
    with pytest.raises(RuntimeError, match="detach_kv"):
        eng.export_pages(req)
    with pytest.raises(ValueError, match="pages"):
        eng.adopt_request([1], 1, 4, None, [])
    assert eng._stage_depth()["depth"] == 0
    eng.close()
    assert eng.pool.refs == {}
