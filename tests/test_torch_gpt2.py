"""Port parity: ``deepspeed_tpu_torch``'s GPT-2 serving model against the
JAX package's ``gpt2_prefill`` / ``gpt2_decode_step`` on the same weights
(``GPT2Model.init``'s tree carried across with ``params_from_numpy``) and
the same token ids, in fp32 at tolerance 1e-4 (the two frameworks order
their sums differently; logits here are O(1)).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.models.gpt2 import (GPT2Config as JaxConfig,
                                       GPT2Model as JaxModel,
                                       gpt2_decode_step as jax_decode_step,
                                       gpt2_prefill as jax_prefill)
from deepspeed_tpu_torch.models.gpt2 import (GPT2Config, GPT2Model,
                                             gpt2_decode_step, gpt2_prefill,
                                             params_from_numpy)

from test_torch_zero import one_thread  # noqa: F401

SMALL = dict(vocab_size=256, n_positions=64, d_model=64, n_layer=3,
             n_head=4)
ATOL = 1e-4


def _models(attn_impl):
    jcfg = JaxConfig(**SMALL, remat=None, attn_impl=attn_impl)
    tree = jax.tree.map(np.asarray, JaxModel(jcfg).init(
        jax.random.PRNGKey(0)))
    return jcfg, tree, GPT2Config(**SMALL, attn_impl=attn_impl)


def test_params_from_numpy_keeps_names_shapes_and_copies():
    _, tree, cfg = _models("flash")
    params = params_from_numpy(tree)
    assert set(params) == set(tree)
    assert set(params["blocks"]) == set(tree["blocks"])
    for name, a in tree["blocks"].items():
        t = params["blocks"][name]
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), a)
    params["wte"][0, 0] += 1.0  # one copy per leaf: the source is untouched
    assert params["wte"][0, 0].item() != tree["wte"][0, 0]
    ours = GPT2Model(cfg).init(0)
    assert {n: tuple(t.shape) for n, t in ours["blocks"].items()} == \
        {n: a.shape for n, a in tree["blocks"].items()}
    bf = params_from_numpy(tree, dtype=torch.bfloat16)
    assert bf["blocks"]["qkv_w"].dtype == torch.bfloat16


@pytest.mark.parametrize("attn_impl", ["flash", "dense"])
def test_prefill_matches_jax(attn_impl):
    jcfg, tree, cfg = _models(attn_impl)
    toks = np.random.default_rng(0).integers(0, 256, (2, 24), np.int32)
    logits_j, ks_j, vs_j = jax_prefill(jcfg, tree, jnp.asarray(toks))
    logits, ks, vs = gpt2_prefill(cfg, params_from_numpy(tree),
                                  torch.from_numpy(toks))
    assert tuple(ks.shape) == (3, 2, 4, 24, 16)
    for ours, ref in ((logits, logits_j), (ks, ks_j), (vs, vs_j)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("attn_impl,impl", [("flash", None),
                                            ("dense", None),
                                            ("flash", "dense")])
def test_decode_steps_match_jax(attn_impl, impl):
    """Two live slots (different prompt lengths) and a free slot riding
    along masked, stepped five ticks: logits of the live slots, both
    caches and the lengths agree with the JAX step after every tick."""
    jcfg, tree, cfg = _models(attn_impl)
    params = params_from_numpy(tree)
    rng = np.random.default_rng(1)
    L, S, Hh, Tm, Dh = 3, 3, 4, 32, 16
    kc = np.zeros((L, S, Hh, Tm, Dh), np.float32)
    vc = np.zeros_like(kc)
    lens = np.zeros((S,), np.int32)
    for slot, n in ((1, 8), (2, 5)):
        p = rng.integers(0, 256, (1, n), np.int32)
        _, ks, vs = jax_prefill(jcfg, tree, jnp.asarray(p))
        kc[:, slot, :, :n] = np.asarray(ks)[:, 0]
        vc[:, slot, :, :n] = np.asarray(vs)[:, 0]
        lens[slot] = n
    # garbage in the free slot and past each live length stays masked
    kc[:, 0] = 1e3
    vc[:, 0] = 1e3
    active = np.asarray([False, True, True])
    jk, jv, jl = jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens)
    tk, tv, tl = (torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()),
                  torch.from_numpy(lens))
    for _ in range(5):
        toks = rng.integers(0, 256, (S,), np.int32)
        lg_j, jk, jv, jl = jax_decode_step(jcfg, tree, jnp.asarray(toks),
                                           jk, jv, jl, jnp.asarray(active),
                                           impl=impl)
        lg, tk, tv, tl = gpt2_decode_step(cfg, params,
                                          torch.from_numpy(toks), tk, tv,
                                          tl, torch.from_numpy(active),
                                          impl=impl)
        np.testing.assert_allclose(lg.numpy()[1:], np.asarray(lg_j)[1:],
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL,
                                   rtol=0)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
