"""Port parity, speculative decoding: ``deepspeed_tpu_torch``'s verify
functions, greedy acceptance and speculative ``ServeEngine`` on both KV
layouts (on the CPU; the multi-query kernels run their plain versions)
against the JAX package's (``attn_impl="flash"``; the Pallas kernels in
interpret mode) on the same target and draft weights, prompts and config.

Tolerances: the verify functions' logits and caches within 1e-4 in fp32
(other summation order; logits are O(1)).  The engines' greedy streams,
finish reasons and per-request accepted counts must be equal, as must the
allocator state; the speculative streams must also equal the port's
non-speculative streams (greedy speculation is output-invariant).  A
token flip between the frameworks is allowed only on a near tie (top-2
logit gap below 1e-3 at that step), reported with its gap.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.inference import ServeEngine as JaxServeEngine
from deepspeed_tpu.inference.speculative import \
    greedy_accept as jax_greedy_accept
from deepspeed_tpu.models.gpt2 import (
    GPT2Config as JaxConfig, GPT2Model as JaxModel,
    gpt2_verify_step as jax_verify_step,
    gpt2_verify_step_paged as jax_verify_step_paged)
from deepspeed_tpu.runtime.stages import \
    reset_fault_injection as jax_reset_faults
from deepspeed_tpu_torch.inference import ServeEngine
from deepspeed_tpu_torch.inference.speculative import (greedy_accept,
                                                       speculative_accept)
from deepspeed_tpu_torch.models.gpt2 import (GPT2Config, GPT2Model,
                                             gpt2_prefill, gpt2_verify_step,
                                             gpt2_verify_step_paged,
                                             params_from_numpy)
from deepspeed_tpu_torch.runtime.stages import reset_fault_injection

from test_torch_zero import one_thread  # noqa: F401

SMALL = dict(vocab_size=256, n_positions=64, d_model=64, n_layer=2,
             n_head=4)
DRAFT = {"d_model": 64, "n_layer": 2, "n_head": 4}
ATOL = 1e-4
GAP = 1e-3
GEN = 10


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
    """The target tree and a noisy draft tree (the target with numpy
    noise of 0.01 on its blocks: it agrees often and rejects often)."""
    jcfg = JaxConfig(**SMALL, remat=None, attn_impl="flash")
    tree = jax.tree.map(np.asarray, JaxModel(jcfg).init(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(9)
    noisy = dict(tree)
    noisy["blocks"] = {
        name: a + 0.01 * rng.standard_normal(a.shape).astype(np.float32)
        for name, a in tree["blocks"].items()}
    return jcfg, tree, noisy, GPT2Config(**SMALL, attn_impl="flash")


def _tokens(n, seed):
    return [int(t) for t in np.random.default_rng(seed).integers(0, 256, n)]


# ---------------------------------------------------------------------------
# verify functions and acceptance
# ---------------------------------------------------------------------------


def _close(ours, ref):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def _verify_case(seed):
    """W = 5 rows per slot: slot 0 mid-cache, slot 1 three rows before
    the capacity of 16 (its last two rows are masked and clip onto the
    last position), slot 2 inactive; garbage everywhere past the live
    rows."""
    rng = np.random.default_rng(seed)
    lens = np.asarray([6, 13, 0], np.int32)
    active = np.asarray([True, True, False])
    toks = rng.integers(0, 256, (3, 5)).astype(np.int32)
    return rng, lens, active, toks


def test_verify_step_matches_jax(weights):
    jcfg, tree, _, cfg = weights
    rng, lens, active, toks = _verify_case(1)
    kc = rng.standard_normal((2, 3, 4, 16, 16)).astype(np.float32)
    vc = rng.standard_normal(kc.shape).astype(np.float32)
    lg_j, jk, jv = jax_verify_step(jcfg, tree, jnp.asarray(toks),
                                   jnp.asarray(kc), jnp.asarray(vc),
                                   jnp.asarray(lens), jnp.asarray(active))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    lg, _, _ = gpt2_verify_step(cfg, params_from_numpy(tree),
                                torch.from_numpy(toks), tk, tv,
                                torch.from_numpy(lens),
                                torch.from_numpy(active))
    _close(lg[:2], lg_j[:2])
    _close(tk, jk)
    _close(tv, jv)


def test_verify_step_paged_matches_jax(weights):
    jcfg, tree, _, cfg = weights
    rng, lens, active, toks = _verify_case(2)
    kp = rng.standard_normal((2, 9, 4, 8, 16)).astype(np.float32)
    vp = rng.standard_normal(kp.shape).astype(np.float32)
    table = np.asarray([[5, 2], [8, 3], [0, 0]], np.int32)   # cap 16
    lg_j, jk, jv = jax_verify_step_paged(
        jcfg, tree, jnp.asarray(toks), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(lens), jnp.asarray(active))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    lg, _, _ = gpt2_verify_step_paged(
        cfg, params_from_numpy(tree), torch.from_numpy(toks), tk, tv,
        torch.from_numpy(table), torch.from_numpy(lens),
        torch.from_numpy(active))
    _close(lg[:2], lg_j[:2])
    # the scratch page takes masked writes in both; compare the rest
    _close(tk[:, 1:], jk[:, 1:])
    _close(tv[:, 1:], jv[:, 1:])


def test_greedy_accept_matches_jax_and_sampling_raises():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((6, 5, 32)).astype(np.float32)
    g = logits.argmax(-1)
    drafts = g[:, :4].copy()
    drafts[1, 0] += 1                         # rejects at once
    drafts[2, 2] += 1                         # accepts two
    drafts[3, 3] += 1                         # accepts three
    ref = jax_greedy_accept(jnp.asarray(logits), jnp.asarray(drafts))
    out = greedy_accept(torch.from_numpy(logits), torch.from_numpy(drafts))
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert out[1].tolist() == [4, 0, 2, 3, 4, 4]
    # the sampling arm needs the draft's distributions and a generator
    with pytest.raises(ValueError, match="proposal distributions"):
        speculative_accept(torch.from_numpy(logits),
                           torch.from_numpy(drafts), None, 0.7)


# ---------------------------------------------------------------------------
# the speculative engine against the JAX engine and against itself
# ---------------------------------------------------------------------------

PROMPTS = [_tokens(3, 10), _tokens(7, 11), _tokens(5, 12)]


def _cfg(arm, **extra):
    serving = {"slots": 2, "max_seq_len": 64, "prefill_len": 16, **extra}
    if arm == "paged":
        serving["page_len"] = 8
    return {"serving": serving}


def _run(engine, prompts, gen):
    reqs = [engine.submit(p, max_new_tokens=gen) for p in prompts]
    engine.run_until_idle()
    out = {"streams": [(r.tokens, r.finish_reason, r.error) for r in reqs],
           "accepted": [list(r.spec_accepted) for r in reqs],
           "passes": engine._spec_passes,
           "accepted_n": engine._spec_accepted_n}
    if engine.pool is not None:
        out["free"] = engine.pool.free_count
        out["refs"] = dict(engine.pool.refs)
    engine.close()
    return out


def _serve(weights, cfg, draft="noisy", prompts=PROMPTS, gen=GEN,
           jax_too=True):
    jcfg, tree, noisy, pcfg = weights
    dtree = {"noisy": noisy, "target": tree, None: None}[draft]
    ours = _run(ServeEngine(
        GPT2Model(pcfg), cfg, params=params_from_numpy(tree), device="cpu",
        draft_params=None if dtree is None else params_from_numpy(dtree)),
        prompts, gen)
    if not jax_too:
        return ours, None
    ref = _run(JaxServeEngine(JaxModel(jcfg), cfg, params=tree,
                              draft_params=dtree), prompts, gen)
    return ours, ref


_PLAIN = {}


def _plain(weights, arm, prompts=PROMPTS, gen=GEN, **extra):
    """The port's non-speculative streams (computed once per setting)."""
    key = (arm, repr(sorted(extra.items())), repr(prompts), gen)
    if key not in _PLAIN:
        _PLAIN[key] = _serve(weights, _cfg(arm, **extra), draft=None,
                             prompts=prompts, gen=gen,
                             jax_too=False)[0]["streams"]
    return _PLAIN[key]


def _assert_streams_agree(weights, prompts, ours, ref):
    _, tree, _, pcfg = weights
    params = params_from_numpy(tree)
    for prompt, (toks, why, err), (rtoks, rwhy, rerr) in zip(
            prompts, ours, ref):
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


def _assert_engines_agree(weights, prompts, ours, ref):
    _assert_streams_agree(weights, prompts, ours["streams"], ref["streams"])
    if ours["streams"] == ref["streams"]:
        for key in ("accepted", "passes", "accepted_n", "free", "refs"):
            assert ours.get(key) == ref.get(key), key


@pytest.mark.parametrize("arm", ["unpaged", "paged"])
@pytest.mark.parametrize("k", [1, 4])
def test_spec_stream_parity(weights, arm, k):
    """A rejection-heavy draft: the streams and per-request accepted
    counts equal the JAX engine's, and the streams equal the port's
    non-speculative streams."""
    cfg = _cfg(arm, speculate_k=k, draft=DRAFT)
    ours, ref = _serve(weights, cfg)
    _assert_engines_agree(weights, PROMPTS, ours, ref)
    assert ours["streams"] == _plain(weights, arm)
    accepted = [m for a in ours["accepted"] for m in a]
    assert 0 in accepted and max(accepted) > 0   # rejections and accepts


@pytest.mark.parametrize("arm", ["unpaged", "paged"])
def test_spec_full_acceptance(weights, arm):
    """Draft == target: every proposal is accepted (the bonus-token edge
    and the draft's (k+1)-th KV write), streams unchanged."""
    ours, ref = _serve(weights, _cfg(arm, speculate_k=4, draft=DRAFT),
                       draft="target")
    _assert_engines_agree(weights, PROMPTS, ours, ref)
    decode_tokens = sum(len(t) - 1 for t, _, _ in ours["streams"])
    assert ours["accepted_n"] == decode_tokens - ours["passes"]
    assert ours["accepted_n"] > ours["passes"]   # blocks, not 1 per tick


@pytest.mark.parametrize("arm", ["unpaged", "paged"])
def test_eos_and_kv_capacity_inside_accepted_block(weights, arm):
    """EOS mid-block truncates at the EOS token; a generation reaching
    the KV capacity mid-block stops where the non-speculative arm does."""
    eos = _plain(weights, arm)[1][0][4]
    cfg = _cfg(arm, speculate_k=4, draft=DRAFT, eos_id=int(eos))
    ours, ref = _serve(weights, cfg, draft="target")
    _assert_engines_agree(weights, PROMPTS, ours, ref)
    assert any(why == "eos" for _, why, _ in ours["streams"])
    prompts = [_tokens(5, 20), _tokens(3, 21)]
    cfg = _cfg(arm, speculate_k=4, draft=DRAFT, max_seq_len=16,
               prefill_len=8)
    ours, ref = _serve(weights, cfg, draft="target", prompts=prompts,
                       gen=16)
    _assert_engines_agree(weights, prompts, ours, ref)
    assert any(why == "kv_capacity" for _, why, _ in ours["streams"])
    assert ours["streams"] == _plain(weights, arm, prompts, 16,
                                     max_seq_len=16, prefill_len=8)


def test_eviction_mid_speculation_frees_speculated_pages(weights):
    """EOS inside an accepted block on the paged arm, and a pool too small
    for both requests' blocks: every page the requests held, speculative
    pre-allocation included, returns to the pool."""
    eos = _plain(weights, "paged")[0][0][3]
    cfg = _cfg("paged", speculate_k=4, draft=DRAFT, eos_id=int(eos),
               prefix_cache=False)
    ours, ref = _serve(weights, cfg, draft="target")
    _assert_engines_agree(weights, PROMPTS, ours, ref)
    assert ours["refs"] == {} and ours["free"] == 1 + 2 * 8 - 1
    prompts = [_tokens(8, 30), _tokens(8, 31)]
    cfg = {"serving": {"slots": 2, "max_seq_len": 64, "prefill_len": 16,
                       "page_len": 4, "pages": 9, "prefix_cache": False,
                       "speculate_k": 4, "draft": DRAFT}}
    ours, ref = _serve(weights, cfg, draft="target", prompts=prompts,
                       gen=24)
    _assert_engines_agree(weights, prompts, ours, ref)
    assert "kv_capacity" in {why for _, why, _ in ours["streams"]}
    assert ours["refs"] == {} and ours["free"] == 8
