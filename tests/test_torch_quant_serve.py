"""Port parity, quantized serving: ``deepspeed_tpu_torch``'s int8
quantizers, the int8 arms of the paged decode kernels (their plain
versions, on the CPU), the quantized model functions and the quantized
``ServeEngine`` against the JAX package's (``tests/test_quant_serve.py``'s
matrix, at its TINY size, fp32; the JAX Pallas kernels in interpret mode)
on the same numpy inputs and weights.

Tolerances: the quantizers' int8 values and scales must be equal (both
divide and round half to even in fp32); the kernel arms within 1e-5 (same
math, other summation order); the model functions' logits within 1e-4 and
their dequantized pools within one quantization step (a K/V value that
lands within 1e-7 of a rounding tie may round the other way).  The
engines' greedy streams and finish reasons must be equal, a flip allowed
only on a near tie (top-2 logit gap below 1e-3, reported with its gap);
the allocator state, ``param_bytes`` and ``kv_bytes`` must be equal.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.config import DeepSpeedConfigError
from deepspeed_tpu.inference import ServeEngine as JaxServeEngine
from deepspeed_tpu.inference.quantize import (
    param_nbytes as jax_param_nbytes,
    quantize_channels as jax_quantize_channels,
    quantize_gpt2_params as jax_quantize_gpt2_params,
    quantize_rows as jax_quantize_rows)
from deepspeed_tpu.models.gpt2 import (
    GPT2Config as JaxConfig, GPT2Model as JaxModel,
    gpt2_decode_step_paged as jax_decode_step_paged,
    gpt2_prefill as jax_prefill,
    gpt2_prefill_paged as jax_prefill_paged,
    gpt2_verify_step_paged as jax_verify_step_paged)
from deepspeed_tpu.ops.pallas.decode_attention import (
    decode_attention_paged as jax_decode_paged,
    decode_attention_paged_multi as jax_decode_paged_multi,
    dequantize_paged as jax_dequantize_paged)
from deepspeed_tpu.runtime.stages import \
    reset_fault_injection as jax_reset_faults
from deepspeed_tpu_torch.config.config import DeepSpeedConfigError as \
    PortConfigError
from deepspeed_tpu_torch.inference import ServeEngine
from deepspeed_tpu_torch.inference.kv_cache import (PagedKVCacheSpec,
                                                    init_paged_cache)
from deepspeed_tpu_torch.inference.quantize import (
    QUANT_WEIGHT_KEYS, SCALE_SUFFIX, dequantize_channels, dequantize_rows,
    param_nbytes, quantize_channels, quantize_gpt2_params, quantize_rows)
from deepspeed_tpu_torch.models.gpt2 import (GPT2Config, GPT2Model,
                                             gpt2_decode_step_paged,
                                             gpt2_prefill, gpt2_prefill_paged,
                                             gpt2_verify_step_paged,
                                             params_from_numpy)
from deepspeed_tpu_torch.ops.kernels.decode_attention import (
    decode_attention_paged, decode_attention_paged_multi,
    decode_attention_reference, dequantize_paged)
from deepspeed_tpu_torch.runtime.stages import reset_fault_injection

TINY = dict(vocab_size=128, n_positions=64, d_model=32, n_layer=2,
            n_head=4)
DRAFT = {"d_model": 32, "n_layer": 2, "n_head": 4}
QUANT = {"weights": "int8", "kv": "int8"}
KTOL = 1e-5
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


@pytest.fixture(scope="module", params=["flash", "dense"])
def weights(request):
    """The JAX TINY tree as numpy, with both packages' configs: ``flash``
    serves through the kernel arms (Pallas interpret mode in JAX, the
    plain versions here), ``dense`` through the dense references."""
    impl = request.param
    jcfg = JaxConfig(**TINY, remat=None, attn_impl=impl)
    tree = jax.tree.map(np.asarray, JaxModel(jcfg).init(
        jax.random.PRNGKey(0)))
    return jcfg, tree, GPT2Config(**TINY, attn_impl=impl)


def _tokens(n, seed):
    return [int(t) for t in np.random.default_rng(seed).integers(0, 128, n)]


# ---------------------------------------------------------------------------
# the quantizers: scale-derived bounds, and equal to the JAX package's
# ---------------------------------------------------------------------------


def test_quantize_rows_bounds_and_match_jax():
    rng = np.random.RandomState(0)
    x = (rng.randn(40, 4, 16) * rng.lognormal(0, 2, (40, 4, 1))).astype(
        np.float32)
    x[3, 1] = 0.0                                   # an all-zero row
    q, s = quantize_rows(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s.shape == (40, 4) and s[3, 1] == 1.0
    err = (dequantize_rows(q, s) - torch.from_numpy(x)).abs()
    assert (err <= s[..., None] / 2 + 1e-6).all()
    assert (dequantize_rows(q, s)[3, 1] == 0).all()
    jq, js = jax_quantize_rows(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # a bf16 input quantizes from its fp32 values, as JAX's does
    xb = torch.from_numpy(x).bfloat16()
    qb, sb = quantize_rows(xb)
    jqb, jsb = jax_quantize_rows(jnp.asarray(xb.float().numpy(),
                                             jnp.bfloat16))
    np.testing.assert_array_equal(qb.numpy(), np.asarray(jqb))
    np.testing.assert_array_equal(sb.numpy(), np.asarray(jsb))


def test_quantize_channels_bounds_and_match_jax():
    rng = np.random.RandomState(1)
    w = rng.randn(2, 32, 3, 32).astype(np.float32)            # qkv shape
    w[1, :, 2, 5] = 0.0                             # an all-zero channel
    q, s = quantize_channels(torch.from_numpy(w))
    assert q.dtype == torch.int8 and s.shape == (2, 1, 3, 32)
    assert s[1, 0, 2, 5] == 1.0
    err = (dequantize_channels(q, s) - torch.from_numpy(w)).abs()
    assert (err <= s / 2 + 1e-6).all()
    # the fused product obeys the per-channel bound: |x w8 s - x w| <=
    # sum|x| s/2 per output channel
    x = torch.from_numpy(rng.randn(4, 32).astype(np.float32))
    got = torch.einsum("bd,dke->bke", x, q[0].float()) * s[0]
    ref = torch.einsum("bd,dke->bke", x, torch.from_numpy(w[0]))
    bound = x.abs().sum(1)[:, None, None] * (s[0] / 2)
    assert ((got - ref).abs() <= bound + 1e-5).all()
    jq, js = jax_quantize_channels(jnp.asarray(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_quantized_param_tree_matches_jax(weights):
    _, tree, _ = weights
    params = params_from_numpy(tree)
    qp = quantize_gpt2_params(params)
    ref = jax_quantize_gpt2_params(jax.tree.map(jnp.asarray, tree))
    assert set(qp["blocks"]) == set(ref["blocks"])
    for name in QUANT_WEIGHT_KEYS:
        assert qp["blocks"][name].dtype == torch.int8
        assert qp["blocks"][name + SCALE_SUFFIX].dtype == torch.float32
    for name, leaf in qp["blocks"].items():
        np.testing.assert_array_equal(leaf.numpy(),
                                      np.asarray(ref["blocks"][name]))
    # the input tree is untouched; the other leaves pass through
    assert params["blocks"]["qkv_w"].dtype == torch.float32
    assert qp["wte"] is params["wte"]
    assert qp["blocks"]["ln1_scale"] is params["blocks"]["ln1_scale"]
    assert param_nbytes(qp) == jax_param_nbytes(ref)
    assert param_nbytes(params) / param_nbytes(qp) > 2.0


def test_quant_weights_prefill_logits_match_jax(weights):
    jcfg, tree, cfg = weights
    toks = np.asarray([_tokens(12, 3)], np.int32)
    qp = quantize_gpt2_params(params_from_numpy(tree))
    got, _, _ = gpt2_prefill(cfg, qp, torch.from_numpy(toks))
    ref, _, _ = jax_prefill(jcfg, jax_quantize_gpt2_params(tree),
                            jnp.asarray(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)
    # the weights arm's whole-model drift stays small (the JAX bound)
    fp, _, _ = gpt2_prefill(cfg, params_from_numpy(tree),
                            torch.from_numpy(toks))
    assert (got - fp).abs().max().item() < 0.05


# ---------------------------------------------------------------------------
# the int8 kernel arms (plain versions here) against the JAX arms
# ---------------------------------------------------------------------------


def _quant_pool(S, H, page_len, max_pages, Dh, seed=0):
    """An int8 pool of ``1 + S*max_pages`` pages by the quantizer (page 0
    the zero scratch page, as the engine keeps it) and a table that gives
    every slot its own pages in a scattered order."""
    rng = np.random.RandomState(seed)
    P = 1 + S * max_pages
    k8, ks = quantize_rows(torch.from_numpy(
        rng.randn(P, H, page_len, Dh).astype(np.float32)))
    v8, vs = quantize_rows(torch.from_numpy(
        rng.randn(P, H, page_len, Dh).astype(np.float32)))
    for t in (k8, ks, v8, vs):
        t[0] = 0
    table = (1 + rng.permutation(P - 1)).reshape(S, max_pages)
    return k8, ks, v8, vs, torch.from_numpy(table.astype(np.int32))


def _jax(*ts):
    return [jnp.asarray(t.numpy()) for t in ts]


@pytest.mark.parametrize("impl", ["pallas", "dense"])
def test_int8_paged_arm_matches_jax(impl):
    S, H, page_len, M, Dh = 4, 3, 16, 3, 32
    k8, ks, v8, vs, pt = _quant_pool(S, H, page_len, M, Dh)
    q = torch.from_numpy(np.random.RandomState(1).randn(S, H, Dh).astype(
        np.float32))
    lengths = torch.tensor([0, 7, 16, 2 * 16 + 5], dtype=torch.int32)
    out = decode_attention_paged(q, k8, v8, pt, lengths, impl=impl,
                                 k_scale=ks, v_scale=vs)
    jargs = _jax(q, k8, v8, pt, lengths)
    jks, jvs = _jax(ks, vs)
    ref_p = jax_decode_paged(*jargs, impl="pallas", interpret=True,
                             k_scale=jks, v_scale=jvs)
    ref_d = jax_decode_paged(*jargs, impl="dense", k_scale=jks,
                             v_scale=jvs)
    for ref in (ref_p, ref_d):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=KTOL,
                                   rtol=0)
    assert (out[0] == 0).all()
    # the dequantized view is the JAX one, and the dense arm is the
    # reference over it
    np.testing.assert_array_equal(
        dequantize_paged(k8, ks, pt).numpy(),
        np.asarray(jax_dequantize_paged(jargs[1], jks, jargs[3])))
    if impl == "dense":
        ref = decode_attention_reference(q, dequantize_paged(k8, ks, pt),
                                         dequantize_paged(v8, vs, pt),
                                         lengths)
        assert torch.equal(out, ref)


@pytest.mark.parametrize("impl", ["pallas", "dense"])
@pytest.mark.parametrize("w", [2, 5])
def test_int8_paged_multi_arm_matches_jax(impl, w):
    S, H, page_len, M, Dh = 3, 2, 8, 4, 16
    k8, ks, v8, vs, pt = _quant_pool(S, H, page_len, M, Dh, seed=2)
    q = torch.from_numpy(np.random.RandomState(3).randn(S, H, w, Dh).astype(
        np.float32))
    base = np.asarray([0, 6, 2 * 8 + 3])
    lens = np.where(base[:, None] > 0, base[:, None] + np.arange(w)[None]
                    + 1, 0)
    lens = torch.from_numpy(np.minimum(lens, M * page_len).astype(np.int32))
    out = decode_attention_paged_multi(q, k8, v8, pt, lens, impl=impl,
                                       k_scale=ks, v_scale=vs)
    jargs = _jax(q, k8, v8, pt, lens)
    jks, jvs = _jax(ks, vs)
    for jimpl in ("pallas", "dense"):
        ref = jax_decode_paged_multi(*jargs, impl=jimpl, interpret=True,
                                     k_scale=jks, v_scale=jvs)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=KTOL,
                                   rtol=0)
    assert (out[0] == 0).all()
    # row i is the single-query arm at row i's lengths
    for i in range(w):
        one = decode_attention_paged(q[:, :, i], k8, v8, pt, lens[:, i],
                                     impl=impl, k_scale=ks, v_scale=vs)
        np.testing.assert_allclose(out[:, :, i].numpy(), one.numpy(),
                                   atol=KTOL, rtol=0)


def test_int8_plain_arms_ignore_dead_pages_and_count_no_cpu_launch():
    """The plain int8 arms never read a page past a slot's live pages nor
    a row past its longest length, as the kernels do: NaN scales and
    garbage bytes there change nothing.  A CPU call is no launch."""
    S, H, page_len, M, Dh = 3, 2, 8, 4, 16
    k8, ks, v8, vs, pt = _quant_pool(S, H, page_len, M, Dh, seed=4)
    q = torch.randn(S, H, 3, Dh, generator=torch.Generator().manual_seed(5))
    lens = torch.tensor([[0, 0, 0], [3, 4, 5], [9, 10, 11]],
                        dtype=torch.int32)
    clean = decode_attention_paged_multi(q, k8, v8, pt, lens, k_scale=ks,
                                         v_scale=vs)
    dirty = [t.clone() for t in (k8, ks, v8, vs)]
    live = {(int(pt[s, p // page_len]), p % page_len) for s in range(S)
            for p in range(int(lens[s].max()))}
    for page in range(k8.shape[0]):
        for row in range(page_len):
            if (page, row) not in live:
                dirty[0][page, :, row] = 77
                dirty[2][page, :, row] = -77
                dirty[1][page, :, row] = float("nan")
                dirty[3][page, :, row] = float("nan")
    counts = (decode_attention_paged.launches_int8,
              decode_attention_paged_multi.launches_int8)
    got = decode_attention_paged_multi(q, dirty[0], dirty[2], pt, lens,
                                       k_scale=dirty[1], v_scale=dirty[3])
    assert torch.equal(got, clean)
    one = decode_attention_paged(q[:, :, 0], dirty[0], dirty[2], pt,
                                 lens[:, 0], k_scale=dirty[1],
                                 v_scale=dirty[3])
    np.testing.assert_allclose(one.numpy(), clean[:, :, 0].numpy(),
                               atol=KTOL, rtol=0)
    assert (decode_attention_paged.launches_int8,
            decode_attention_paged_multi.launches_int8) == counts


def test_int8_arm_argument_validation():
    """The JAX validation test's two errors, from the port."""
    S, H, page_len, M, Dh = 2, 2, 8, 2, 16
    k8, ks, v8, vs, pt = _quant_pool(S, H, page_len, M, Dh)
    lengths = torch.tensor([3, 5], dtype=torch.int32)
    q = torch.zeros(S, H, Dh)
    with pytest.raises(ValueError, match="together"):
        decode_attention_paged(q, k8, v8, pt, lengths, impl="dense",
                               k_scale=ks)
    fp = torch.zeros(1 + S * M, H, page_len, Dh)
    with pytest.raises(ValueError, match="int8"):
        decode_attention_paged_multi(
            torch.zeros(S, H, 2, Dh), fp, fp, pt,
            torch.zeros(S, 2, dtype=torch.int32), impl="dense", k_scale=ks,
            v_scale=vs)


# ---------------------------------------------------------------------------
# the quantized model functions against the JAX ones
# ---------------------------------------------------------------------------


def _close_pools(cache, jk, jks):
    """Dequantized pools within one quantization step of JAX's."""
    ours = dequantize_rows(cache[0], cache[1]).numpy()
    ref = np.asarray(jk, np.float32) * np.asarray(jks)[..., None]
    step = np.maximum(cache[1].numpy(), np.asarray(jks))[..., None]
    assert (np.abs(ours - ref) <= step * 1.001 + 1e-6).all()


def test_quant_prefill_decode_verify_paged_match_jax(weights):
    """Int8 weights and pool: slot 0 prefills 13 tokens with no prefix,
    slot 1 a 6-token delta after slot 0's first page (the gather arm,
    dequantizing), both decode 3 ticks next to a free slot, then one
    W = 3 verify pass; logits, dequantized pools and lengths agree."""
    jcfg, tree, cfg = weights
    params = quantize_gpt2_params(params_from_numpy(tree))
    jparams = jax_quantize_gpt2_params(tree)
    L, H, Dh, S, M, P = 2, 4, 8, 3, 4, 12
    spec = PagedKVCacheSpec(layers=L, slots=S, heads=H, pages=P,
                            page_len=PAGE, head_dim=Dh, max_pages=M,
                            dtype=torch.int8, quant=True)
    c = init_paged_cache(spec)
    assert c["k_scale"].shape == (L, P, H, PAGE)
    assert (c["k_scale"] == 0).all() and c["k"].dtype == torch.int8
    jc = {k: jnp.asarray(v.numpy()) for k, v in c.items()}
    table = np.zeros((S, M), np.int32)
    table[0, :3] = [7, 2, 9]
    table[1, :3] = [7, 5, 11]
    first = _tokens(13, 1)
    second = first[:8] + _tokens(6, 2)

    def check(lg, jlg, n):
        """The first ``n`` rows of the logits, then both pools."""
        np.testing.assert_allclose(lg[:n].numpy(), np.asarray(jlg)[:n],
                                   atol=ATOL, rtol=0)
        _close_pools((c["k"], c["k_scale"]), jc["k"], jc["k_scale"])
        _close_pools((c["v"], c["v_scale"]), jc["v"], jc["v_scale"])

    for prefix, delta, row in ((0, first, table[0]),
                               (8, second[8:], table[1])):
        pad = np.zeros((1, 16), np.int32)
        pad[0, :len(delta)] = delta
        out = gpt2_prefill_paged(cfg, params, torch.from_numpy(pad),
                                 len(delta), prefix, torch.from_numpy(row),
                                 c["k"], c["v"], k_scale=c["k_scale"],
                                 v_scale=c["v_scale"])
        assert len(out) == 5 and out[3] is c["k_scale"]
        jlg, jc["k"], jc["v"], jc["k_scale"], jc["v_scale"] = \
            jax_prefill_paged(jcfg, jparams, jnp.asarray(pad),
                              np.int32(len(delta)), np.int32(prefix),
                              jnp.asarray(row), jc["k"], jc["v"],
                              k_scale=jc["k_scale"], v_scale=jc["v_scale"])
        check(out[0][0], jlg[0], len(delta))
    lens = np.asarray([13, 14, 0], np.int32)
    active = np.asarray([True, True, False])
    jl, tl = jnp.asarray(lens), torch.from_numpy(lens)
    rng = np.random.default_rng(3)
    for _ in range(3):
        toks = rng.integers(0, 128, (S,), np.int32)
        out = gpt2_decode_step_paged(
            cfg, params, torch.from_numpy(toks), c["k"], c["v"],
            torch.from_numpy(table), tl, torch.from_numpy(active),
            k_scale=c["k_scale"], v_scale=c["v_scale"])
        assert len(out) == 6
        tl = out[-1]
        jlg, jc["k"], jc["v"], jc["k_scale"], jc["v_scale"], jl = \
            jax_decode_step_paged(jcfg, jparams, jnp.asarray(toks), jc["k"],
                                  jc["v"], jnp.asarray(table), jl,
                                  jnp.asarray(active), k_scale=jc["k_scale"],
                                  v_scale=jc["v_scale"])
        check(out[0], jlg, 2)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    toks = rng.integers(0, 128, (S, 3), np.int32)
    out = gpt2_verify_step_paged(
        cfg, params, torch.from_numpy(toks), c["k"], c["v"],
        torch.from_numpy(table), tl, torch.from_numpy(active),
        k_scale=c["k_scale"], v_scale=c["v_scale"])
    assert len(out) == 5
    jlg, jc["k"], jc["v"], jc["k_scale"], jc["v_scale"] = \
        jax_verify_step_paged(jcfg, jparams, jnp.asarray(toks), jc["k"],
                              jc["v"], jnp.asarray(table), jl,
                              jnp.asarray(active), k_scale=jc["k_scale"],
                              v_scale=jc["v_scale"])
    check(out[0], jlg, 2)
    # the scratch page and the never-used pages stay exact zeros
    for page in (0, 1, 3):
        assert (c["k"][:, page] == 0).all() and (c["k_scale"][:, page]
                                                 == 0).all()


# ---------------------------------------------------------------------------
# the quantized engine against the JAX engine
# ---------------------------------------------------------------------------


def _cfg(slots=3, max_seq=40, prefill=24, **extra):
    return {"serving": {"slots": slots, "max_seq_len": max_seq,
                        "prefill_len": prefill, **extra}}


def _run(engine, load):
    reqs = [engine.submit(p, max_new_tokens=n) for p, n in load]
    engine.run_until_idle()
    out = {"streams": [(r.tokens, r.finish_reason, r.error) for r in reqs],
           "param_bytes": engine.param_bytes, "kv_bytes": engine.kv_bytes,
           "accepted": [list(r.spec_accepted) for r in reqs]}
    if engine.pool is not None:
        out["free"] = engine.pool.free_count
        out["shared"] = [r.shared_len for r in reqs]
        out["computed"] = [r.computed_len for r in reqs]
    if engine.prefix is not None:
        out["prefix"] = (engine.prefix.hits, engine.prefix.misses,
                         engine.prefix.cow, engine.prefix.entries)
    engine.close()
    if engine.pool is not None:
        out["refs_after_close"] = dict(engine.pool.refs)
    return out


def _both(weights, load, cfg, spec=False):
    jcfg, tree, pcfg = weights
    kw = {"draft_params": tree} if spec else {}
    ours = _run(ServeEngine(GPT2Model(pcfg), cfg,
                            params=params_from_numpy(tree), device="cpu",
                            **({"draft_params": params_from_numpy(tree)}
                               if spec else {})), load)
    ref = _run(JaxServeEngine(JaxModel(jcfg), cfg, params=tree, **kw), load)
    return ours, ref


def _assert_engines_agree(weights, load, ours, ref):
    """Equal streams and finish reasons (a flip tolerated only on a near
    tie of the quantized model, reported with its gap), then the allocator
    state and the memory plane."""
    _, tree, pcfg = weights
    params = quantize_gpt2_params(params_from_numpy(tree))
    flipped = False
    for (prompt, _), (toks, why, err), (rtoks, rwhy, rerr) in zip(
            load, ours["streams"], ref["streams"]):
        assert err is None and rerr is None
        if toks == rtoks:
            assert why == rwhy
            continue
        flipped = True
        i = next(i for i, (a, b) in enumerate(zip(toks, rtoks)) if a != b)
        logits, _, _ = gpt2_prefill(pcfg, params,
                                    torch.tensor([prompt + toks[:i]]))
        top = torch.topk(logits[0, -1], 2).values
        gap = float(top[0] - top[1])
        print(f"near-tie flip at token {i} of prompt len {len(prompt)}: "
              f"{toks[i]} vs {rtoks[i]}, top-2 gap {gap:.3g}")
        assert gap < GAP, (f"stream diverges at token {i} with top-2 logit "
                           f"gap {gap} >= {GAP}: not a near tie")
    keys = ["param_bytes", "kv_bytes", "free", "shared", "computed",
            "prefix", "refs_after_close"]
    if not flipped:
        keys.append("accepted")
    for key in keys:
        assert ours.get(key) == ref.get(key), key


TEMPLATE = _tokens(16, 40)                    # exactly two pages


@pytest.mark.parametrize("chunk", [0, 4], ids=["whole", "chunked"])
def test_quant_paged_engine_matches_jax(weights, chunk):
    """Weights and KV int8 on the paged pool with the prefix cache:
    template sharers (full-page hits), identical prompts (a shared partial
    page: COW, the sidecars copied with it), a 1-token and a 3-page prompt;
    with ``prefill_chunk_len`` 4 the long deltas prefill in chunks."""
    load = ([(TEMPLATE + _tokens(n, 41 + n), 6) for n in (3, 7)]
            + [(_tokens(13, 50), 7)] * 3
            + [(_tokens(1, 51), 5), (_tokens(20, 52), 9)])
    ours, ref = _both(weights, load, _cfg(page_len=PAGE,
                                          prefill_chunk_len=chunk,
                                          quantization=QUANT))
    _assert_engines_agree(weights, load, ours, ref)
    hits, misses, cow, _ = ours["prefix"]
    if not chunk:
        assert hits >= 3 and cow >= 2
    assert ours["refs_after_close"] == {}
    assert all(why == "length" for _, why, _ in ours["streams"])


def test_quant_weights_unpaged_engine_matches_jax(weights):
    load = [(_tokens(n, 30 + n), 6) for n in (2, 9, 15)]
    ours, ref = _both(weights, load, _cfg(quantization={"weights": "int8"}))
    _assert_engines_agree(weights, load, ours, ref)


@pytest.mark.parametrize("k", [1, 4])
def test_quant_spec_engine_matches_jax_and_non_spec(weights, k):
    """Speculation on the int8 pool with int8 target and draft weights:
    streams, accepted counts and allocator state equal the JAX engine's,
    and the streams equal the quantized non-speculative engine's."""
    gen = 2 * (k + 1) + 1
    load = [(_tokens(n, 70 + n), gen) for n in (2, 7, 12)]
    cfg = _cfg(page_len=PAGE, quantization=QUANT, speculate_k=k,
               draft=DRAFT)
    ours, ref = _both(weights, load, cfg, spec=True)
    _assert_engines_agree(weights, load, ours, ref)
    _, tree, pcfg = weights
    base = _run(ServeEngine(GPT2Model(pcfg),
                            _cfg(page_len=PAGE, quantization=QUANT),
                            params=params_from_numpy(tree), device="cpu"),
                load)
    assert [s[0] for s in ours["streams"]] == [s[0] for s in
                                               base["streams"]]


def test_quant_default_off_is_unchanged(weights):
    """An explicit fp16 block, an empty block and no block give the same
    streams, with no scale leaves and no dtype change."""
    _, tree, pcfg = weights
    load = [(_tokens(n, 10 + n), 6) for n in (1, 3, 8, 17)]
    runs = []
    for extra in ({}, {"quantization": {"weights": "fp16", "kv": "fp16"}},
                  {"quantization": {}}):
        eng = ServeEngine(GPT2Model(pcfg), _cfg(page_len=PAGE, **extra),
                          params=params_from_numpy(tree), device="cpu")
        assert set(eng.cache) == {"k", "v", "lengths"}
        assert eng.cache["k"].dtype == torch.float32
        assert "qkv_w_scale" not in eng.params["blocks"]
        assert not eng.cache_spec.quant
        runs.append(_run(eng, load)["streams"])
    assert runs[0] == runs[1] == runs[2]


def test_quant_kv_first_tokens_exact_and_cache_layout(weights):
    """kv int8 alone: the prefill attends the exact fp K/V, so every first
    token equals the fp engine's; the cache and spec are the int8 pool."""
    _, tree, pcfg = weights
    load = [(_tokens(n, 20 + n), 6) for n in (1, 3, 8, 17, 20)]
    streams = {}
    for name, quant in (("fp", {}), ("kv", {"kv": "int8"})):
        eng = ServeEngine(GPT2Model(pcfg),
                          _cfg(page_len=PAGE, quantization=quant),
                          params=params_from_numpy(tree), device="cpu")
        if name == "kv":
            assert eng.cache["k"].dtype == torch.int8
            assert eng.cache["k_scale"].shape == eng.cache["k"].shape[:-1]
            assert eng.cache_spec.quant
            assert eng.kv_bytes == eng.cache_spec.bytes
            assert eng.params["blocks"]["qkv_w"].dtype == torch.float32
        streams[name] = [s[0] for s in _run(eng, load)["streams"]]
    assert [t[0] for t in streams["kv"]] == [t[0] for t in streams["fp"]]


def test_quant_cow_copies_scale_sidecars(weights):
    _, tree, pcfg = weights
    eng = ServeEngine(GPT2Model(pcfg), _cfg(page_len=PAGE,
                                            quantization={"kv": "int8"}),
                      params=params_from_numpy(tree), device="cpu")
    r = eng.submit(_tokens(10, 40), max_new_tokens=2)
    eng.run_until_idle()
    assert r.error is None
    before = {k: v.clone() for k, v in eng.cache.items()}
    src, dst = 1, eng.cache_spec.pages - 1
    assert (before["k_scale"][:, src] != 0).any()
    eng._copy_page(src, dst)
    for key in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(eng.cache[key][:, dst], before[key][:, src])
    assert torch.equal(eng.cache["lengths"], before["lengths"])
    eng.close()


def test_quant_memory_plane_matches_jax(weights):
    """param_bytes and kv_bytes, the target's and the draft's, equal the
    JAX engine's; the weights arm cuts the fp32 parameters' bytes by more
    than 2x and the int8 pool the KV bytes by (4*Dh)/(Dh+4)."""
    jcfg, tree, pcfg = weights
    cfg = _cfg(page_len=PAGE, quantization=QUANT, speculate_k=2,
               draft=DRAFT)
    ours = ServeEngine(GPT2Model(pcfg), cfg, params=params_from_numpy(tree),
                       device="cpu", draft_params=params_from_numpy(tree))
    ref = JaxServeEngine(JaxModel(jcfg), cfg, params=tree,
                         draft_params=tree)
    assert (ours.param_bytes, ours.kv_bytes) == (ref.param_bytes,
                                                 ref.kv_bytes)
    assert ours.draft_params["blocks"]["qkv_w"].dtype == torch.int8
    assert ours._draft_cache["k"].dtype == torch.float32
    assert ours.param_bytes == (param_nbytes(ours.params)
                                + param_nbytes(ours.draft_params))
    ours.close()
    ref.close()
    fp = ServeEngine(GPT2Model(pcfg), _cfg(page_len=PAGE),
                     params=params_from_numpy(tree), device="cpu")
    q8 = ServeEngine(GPT2Model(pcfg), _cfg(page_len=PAGE,
                                           quantization=QUANT),
                     params=params_from_numpy(tree), device="cpu")
    assert fp.param_bytes / q8.param_bytes > 2.0
    Dh = pcfg.d_head
    assert fp.kv_bytes * (Dh + 4) == q8.kv_bytes * 4 * Dh
    fp.close()
    q8.close()


def test_quant_kv_needs_the_paged_pool(weights):
    """kv int8 without pages fails at config parse, in both packages."""
    jcfg, tree, pcfg = weights
    cfg = {"serving": {"slots": 2, "quantization": {"kv": "int8"}}}
    with pytest.raises(PortConfigError, match="page_len"):
        ServeEngine(GPT2Model(pcfg), cfg, params=params_from_numpy(tree),
                    device="cpu")
    with pytest.raises(DeepSpeedConfigError, match="page_len"):
        JaxServeEngine(JaxModel(jcfg), cfg, params=tree)
