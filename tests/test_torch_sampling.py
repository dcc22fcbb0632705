"""Port parity, temperature sampling: ``deepspeed_tpu_torch``'s
``select_next_token`` at temperature > 0, ``rejection_sample_accept`` and
the sampling planes of its ``ServeEngine`` (on the CPU) against the JAX
package's functions and ``softmax(logits / T)``.

``jax.random``'s bits cannot be replayed in torch, so the bar is
statistical, on fixed seeds (every run draws the same samples, so nothing
can flake): a goodness-of-fit chi-square against the softmax, or a
two-sample chi-square between the two packages (or two engine paths),
over the bins with an expected count of at least 5, the rest pooled into
one bin; each must give p >= 1e-3.  Within the port, the same seed gives
the same stream bit for bit.  The reference's own checks
(``tests/test_spec_decode.py:260,281``) keep their bars: the recovered
distribution within 0.02 of the target, and a rejected over-proposed
token never resampled as itself.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from scipy import stats

from deepspeed_tpu.inference.speculative import \
    rejection_sample_accept as jax_rejection_sample_accept
from deepspeed_tpu.models.gpt2 import (GPT2Config as JaxConfig,
                                       GPT2Model as JaxModel,
                                       gpt2_prefill as jax_prefill)
from deepspeed_tpu_torch.inference import ServeEngine
from deepspeed_tpu_torch.inference.speculative import (
    rejection_sample_accept, select_next_token, speculative_accept)
from deepspeed_tpu_torch.models.gpt2 import (GPT2Config, GPT2Model,
                                             params_from_numpy)

P_MIN = 1e-3
SMALL = dict(vocab_size=64, n_positions=32, d_model=64, n_layer=2,
             n_head=4)
DRAFT = {"d_model": 64, "n_layer": 1, "n_head": 4}
T = 0.8
PROMPT = [3, 14, 15, 9, 26]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The engine cases serve thousands of tiny requests: one intra-op
    thread runs them fastest and keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _bins(expected):
    """Bin index lists: every bin of expected count >= 5 alone, the rest
    pooled into one (dropped if it is empty)."""
    big = [[i] for i in np.flatnonzero(expected >= 5)]
    small = list(np.flatnonzero(expected < 5))
    return big + ([small] if small else [])


def _gof_p(samples, probs):
    """Goodness-of-fit chi-square p of ``samples`` against ``probs``."""
    n = len(samples)
    obs = np.bincount(samples, minlength=len(probs))
    exp = probs * n
    groups = _bins(exp)
    o = np.array([obs[g].sum() for g in groups], np.float64)
    e = np.array([exp[g].sum() for g in groups], np.float64)
    return stats.chisquare(o, e * o.sum() / e.sum()).pvalue


def _two_sample_p(a, b, minlength):
    """Two-sample chi-square p of equal distributions of ``a`` and
    ``b``."""
    ca = np.bincount(a, minlength=minlength)
    cb = np.bincount(b, minlength=minlength)
    groups = _bins((ca + cb) / 2.0)
    table = np.array([[ca[g].sum() for g in groups],
                      [cb[g].sum() for g in groups]], np.float64)
    table = table[:, table.sum(0) > 0]
    return stats.chi2_contingency(table, correction=False).pvalue


# ---------------------------------------------------------------------------
# the samplers
# ---------------------------------------------------------------------------


def test_select_next_token_matches_softmax_at_temperature():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal(48).astype(np.float32) * 2)
    draws = select_next_token(logits.expand(40000, 48), T, _gen(1))
    assert draws.dtype == torch.int32 and draws.shape == (40000,)
    probs = torch.softmax(logits / T, -1).numpy().astype(np.float64)
    assert _gof_p(draws.numpy(), probs) >= P_MIN
    # greedy ignores the generator; sampling without one raises
    assert select_next_token(logits).item() == int(logits.argmax())
    with pytest.raises(ValueError, match="rng"):
        select_next_token(logits, T)


def test_select_next_token_exact_zeros_and_bf16():
    """-inf logits (a probability of exactly 0) are never drawn, no
    draw is NaN-poisoned, and bf16 logits are cast to fp32 before the
    temperature."""
    logits = torch.full((64,), -float("inf"))
    logits[[3, 40]] = torch.tensor([0.0, 1.0])
    draws = select_next_token(logits.expand(20000, 64), 1.0, _gen(2))
    assert set(draws.tolist()) == {3, 40}
    bf = torch.randn(2000, 32, generator=_gen(3)).to(torch.bfloat16)
    a = select_next_token(bf, T, _gen(4))
    b = select_next_token(bf.float(), T, _gen(4))
    assert torch.equal(a, b)


def test_rejection_sampling_recovers_target_distribution():
    """The reference's bar (``tests/test_spec_decode.py:260``) on the
    port: draft-proposed + accept/resample == sampling the target, at S =
    30000 rows of one position over a 4-token vocab."""
    n = 30000
    p_log = torch.log(torch.tensor([[0.45, 0.30, 0.15, 0.10],
                                    [0.25, 0.25, 0.25, 0.25]]))
    q = torch.tensor([[0.10, 0.40, 0.30, 0.20]])
    d = torch.multinomial(q[0], n, replacement=True, generator=_gen(5))
    out, acc = rejection_sample_accept(p_log[None].expand(n, 2, 4),
                                       d[:, None], q[None].expand(n, 1, 4),
                                       1.0, _gen(6))
    freq = np.bincount(out[:, 0].numpy(), minlength=4) / n
    target = torch.softmax(p_log[0], -1).numpy()
    assert np.abs(freq - target).max() < 0.02, (freq, target)
    assert out.dtype == torch.int32 and acc.dtype == torch.int32


def test_rejection_residual_excludes_overproposed_token():
    """The reference's bar (``:281``): where q >= p the residual is zero,
    so a rejected proposal is never resampled as itself."""
    n = 2000
    p_log = torch.log(torch.tensor([[0.05, 0.90, 0.05],
                                    [1 / 3, 1 / 3, 1 / 3]]))
    q = torch.tensor([[0.90, 0.05, 0.05]])
    out, acc = rejection_sample_accept(
        p_log[None].expand(n, 2, 3), torch.zeros(n, 1, dtype=torch.long),
        q[None].expand(n, 1, 3), 1.0, _gen(7))
    rejected = out[:, 0][acc == 0]
    assert len(rejected) > 100
    assert (rejected != 0).all()


@pytest.fixture(scope="module")
def block():
    """One speculative block's operands at S = 20000 rows, k = 3, V = 16:
    the target's logits, the draft's distributions and drafts drawn from
    them (numpy, seeded) — the same for both packages."""
    rng = np.random.default_rng(8)
    n, k, V = 20000, 3, 16
    tl = (rng.standard_normal((k + 1, V)) * 1.5).astype(np.float32)
    ql = (rng.standard_normal((k, V)) * 1.5).astype(np.float32)
    q = np.exp(ql / T) / np.exp(ql / T).sum(-1, keepdims=True)
    q = q.astype(np.float32)
    cdf = np.cumsum(q, -1)
    u = rng.random((n, k))
    d = np.minimum((u[..., None] > cdf[None]).sum(-1), V - 1).astype(np.int32)
    return (np.broadcast_to(tl, (n, k + 1, V)).copy(), d,
            np.broadcast_to(q, (n, k, V)).copy())


def test_rejection_sampler_matches_jax_two_sample(block):
    """Both packages' rejection samplers on the same target logits,
    draft distributions and drafts: the emitted first token, the accepted
    count and the bonus-or-replacement token agree in distribution; the
    first token also matches the target's softmax."""
    tl, d, q = block
    jout, jacc = jax_rejection_sample_accept(
        jnp.asarray(tl), jnp.asarray(d), jnp.asarray(q), T,
        jax.random.PRNGKey(9))
    jout, jacc = np.asarray(jout), np.asarray(jacc)
    out, acc = speculative_accept(torch.from_numpy(tl), torch.from_numpy(d),
                                  torch.from_numpy(q), T, _gen(10))
    out, acc = out.numpy(), acc.numpy()
    V = tl.shape[-1]
    assert _two_sample_p(out[:, 0], jout[:, 0], V) >= P_MIN
    assert _two_sample_p(acc, jacc, 4) >= P_MIN
    rows = np.arange(len(acc))
    assert _two_sample_p(out[rows, acc], jout[rows, jacc], V) >= P_MIN
    p0 = np.exp(tl[0, 0] / T) / np.exp(tl[0, 0] / T).sum()
    assert _gof_p(out[:, 0], p0.astype(np.float64)) >= P_MIN
    # the tokens before the stop position are the drafts, as in JAX
    for i in range(3):
        keep = acc > i
        assert (out[keep, i] == d[keep, i]).all()


def test_rejection_sampler_is_bitwise_under_one_seed(block):
    tl, d, q = [torch.from_numpy(a[:500]) for a in block]
    a = rejection_sample_accept(tl, d, q, T, _gen(11))
    b = rejection_sample_accept(tl, d, q, T, _gen(11))
    c = rejection_sample_accept(tl, d, q, T, _gen(12))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


# ---------------------------------------------------------------------------
# through the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxConfig(**SMALL, remat=None, attn_impl="dense")
    tree = jax.tree.map(np.asarray, JaxModel(jcfg).init(
        jax.random.PRNGKey(0)))
    return jcfg, tree, GPT2Config(**SMALL, attn_impl="dense")


def _engine(weights, seed=0, **serving):
    _, tree, pcfg = weights
    model = GPT2Model(pcfg)
    draft = None
    if serving.get("speculate_k"):
        draft = GPT2Model(GPT2Config(**{**SMALL, **DRAFT},
                                     attn_impl="dense")).init(7)
    cfg = {"serving": {"slots": 32, "max_seq_len": 16, "prefill_len": 8,
                       "temperature": T, "queue_capacity": 4096,
                       **serving}}
    return ServeEngine(model, cfg, params=params_from_numpy(tree),
                       draft_params=draft, seed=seed, device="cpu")


def _streams(eng, n, gen, prompt=PROMPT):
    reqs = [eng.submit(prompt, max_new_tokens=gen) for _ in range(n)]
    eng.run_until_idle()
    eng.close()
    assert all(r.error is None and len(r.tokens) == gen for r in reqs)
    return np.array([r.tokens for r in reqs])


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_engine_first_token_matches_jax_softmax(weights, paged):
    """2,000 one-token requests on one prompt: the first tokens follow
    ``softmax(JAX prefill logits / T)``, on both KV layouts."""
    jcfg, tree, _ = weights
    logits, _, _ = jax_prefill(jcfg, tree, jnp.asarray([PROMPT]))
    z = np.asarray(logits[0, len(PROMPT) - 1], np.float64) / T
    probs = np.exp(z - z.max()) / np.exp(z - z.max()).sum()
    eng = _engine(weights, **({"page_len": 4} if paged else {}))
    first = _streams(eng, 2000, 1)[:, 0]
    assert _gof_p(first, probs) >= P_MIN
    assert len(set(first.tolist())) > 10           # it really sampled


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_engine_speculative_second_tokens_match_plain(weights, paged):
    """The second token of 2,000 two-token requests: drawn by the
    rejection-sampling verify pass (speculate_k 2, a 1-layer draft of
    other weights) or by the plain decode tick, the same distribution."""
    extra = {"page_len": 4} if paged else {}
    plain = _streams(_engine(weights, seed=1, **extra), 2000, 2)
    spec = _streams(_engine(weights, seed=2, speculate_k=2, draft=DRAFT,
                            **extra), 2000, 2)
    assert _two_sample_p(spec[:, 1], plain[:, 1], 64) >= P_MIN
    assert _two_sample_p(spec[:, 0], plain[:, 0], 64) >= P_MIN


def test_temperature_sampling_deterministic_under_seed(weights):
    """The reference's ``:605`` on the port: the same seed gives the same
    streams bit for bit, another seed other streams, and they are not
    the greedy streams."""
    prompts = [[1, 2, 3], [5, 8, 13, 21], [2, 7]]

    def run(seed, temperature=T, **extra):
        eng = _engine(weights, seed=seed, slots=2, max_seq_len=32,
                      temperature=temperature, **extra)
        reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.run_until_idle()
        eng.close()
        return [r.tokens for r in reqs]

    a, b = run(0), run(0)
    assert a == b
    assert run(1) != a
    assert a != run(0, temperature=0.0)
    # the paged pool draws the same samples from the same seed (the
    # logits agree within rounding, the generators are the same)
    assert run(0, page_len=4) == a


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_temperature_spec_serves_end_to_end(weights, paged):
    """The reference's ``:612`` on the port: T > 0 speculation serves
    every request to its exact length, deterministically under a seed."""
    def run():
        eng = _engine(weights, slots=2, max_seq_len=32, speculate_k=3,
                      draft=DRAFT, **({"page_len": 4} if paged else {}))
        reqs = [eng.submit(p, max_new_tokens=n)
                for p, n in (([1, 2, 3], 6), ([4, 5], 9), ([6], 1))]
        eng.run_until_idle()
        eng.close()
        assert [len(r.tokens) for r in reqs] == [6, 9, 1]
        assert all(r.finish_reason == "length" for r in reqs)
        return [r.tokens for r in reqs], eng._spec_passes
    (a, passes), (b, _) = run(), run()
    assert a == b and passes > 0
