"""Port parity, the dtype of the dense decode over the int8 pool in bf16:
``deepspeed_tpu_torch``'s dense arms of ``decode_attention_paged`` and
``decode_attention_paged_multi`` and one ``gpt2_decode_step_paged`` with
int8 weights and pool against the JAX package's, on the same numpy-made
inputs and weights.

The reference multiplies bf16 probabilities by the fp32 values
``dequantize_paged`` returns, so its attention output is fp32 and the rest
of the step follows in fp32 (jnp promotion); the port must return the same
dtype.  Tolerances: the same arithmetic runs in both packages (fp32
scores and softmax, the probabilities rounded to bf16, fp32 products), so
the attention outputs must agree within 1e-5 and the logits within 1e-4,
the fp32 tiers of tests/test_torch_quant_serve.py (measured: ~1e-7).
JAX's ``scan_layers`` arm cannot run this step: the fp32 attention output
breaks ``lax.scan``'s bf16 carry (a TypeError in the reference), so the
step is held against its unrolled arm, ``scan_layers=False``.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.inference.quantize import (
    quantize_gpt2_params as jax_quantize_gpt2_params,
    quantize_rows as jax_quantize_rows)
from deepspeed_tpu.models.gpt2 import (
    GPT2Config as JaxConfig, GPT2Model as JaxModel,
    gpt2_decode_step_paged as jax_decode_step_paged)
from deepspeed_tpu.ops.pallas.decode_attention import (
    decode_attention_paged as jax_decode_paged,
    decode_attention_paged_multi as jax_decode_paged_multi)
from deepspeed_tpu_torch.inference.quantize import (quantize_gpt2_params,
                                                    quantize_rows)
from deepspeed_tpu_torch.models.gpt2 import (GPT2Config,
                                             gpt2_decode_step_paged,
                                             params_from_numpy)
from deepspeed_tpu_torch.ops.kernels.decode_attention import (
    decode_attention_paged, decode_attention_paged_multi)

from test_torch_zero import one_thread  # noqa: F401

TINY = dict(vocab_size=128, n_positions=64, d_model=32, n_layer=2,
            n_head=4)
ATTN_TOL = 1e-5
LOGIT_TOL = 1e-4


def _pool(L, P, H, page_len, Dh, seed):
    """Both packages' int8 pools and scales, quantized by each package's
    own ``quantize_rows`` from the same numpy rows; page 0 zero."""
    rows = np.random.RandomState(seed).randn(
        L, P, H, page_len, Dh).astype(np.float32)
    rows[:, 0] = 0
    q8, sc = quantize_rows(torch.from_numpy(rows))
    jq8, jsc = jax_quantize_rows(jnp.asarray(rows))
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8))
    return (q8, sc), (jq8, jsc)


def _table(S, M, seed):
    perm = 1 + np.random.RandomState(seed).permutation(S * M)
    return perm.reshape(S, M).astype(np.int32)


@pytest.mark.parametrize("w", [1, 5])
def test_bf16_int8_dense_decode_returns_jax_dtype(w):
    """One dense decode over the int8 pool, bf16 queries: W = 1 through
    ``decode_attention_paged``, W = 5 through ``..._paged_multi``."""
    S, H, page_len, M, Dh = 3, 4, 8, 3, 16
    (k8, ks), (jk8, jks) = _pool(1, 1 + S * M, H, page_len, Dh, 0)
    (v8, vs), (jv8, jvs) = _pool(1, 1 + S * M, H, page_len, Dh, 1)
    k8, ks, v8, vs = k8[0], ks[0], v8[0], vs[0]
    jk8, jks, jv8, jvs = jk8[0], jks[0], jv8[0], jvs[0]
    table = _table(S, M, 2)
    q = np.random.RandomState(3).randn(S, H, w, Dh).astype(np.float32)
    base = np.asarray([0, 5, 2 * page_len + 3])
    lens = np.where(base[:, None] > 0,
                    base[:, None] + np.arange(w)[None] + 1, 0).astype(np.int32)
    tq = torch.from_numpy(q).bfloat16()
    jq = jnp.asarray(q, jnp.bfloat16)
    args = (torch.from_numpy(table),)
    jargs = (jnp.asarray(table),)
    if w == 1:
        out = decode_attention_paged(tq[:, :, 0], k8, v8, *args,
                                     torch.from_numpy(lens[:, 0]),
                                     impl="dense", k_scale=ks, v_scale=vs)
        ref = jax_decode_paged(jq[:, :, 0], jk8, jv8, *jargs,
                               jnp.asarray(lens[:, 0]), impl="dense",
                               k_scale=jks, v_scale=jvs)
    else:
        out = decode_attention_paged_multi(tq, k8, v8, *args,
                                           torch.from_numpy(lens),
                                           impl="dense", k_scale=ks,
                                           v_scale=vs)
        ref = jax_decode_paged_multi(jq, jk8, jv8, *jargs,
                                     jnp.asarray(lens), impl="dense",
                                     k_scale=jks, v_scale=jvs)
    assert np.dtype(ref.dtype) == np.float32
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATTN_TOL,
                               rtol=0)
    assert (out[0] == 0).all()
    # the kernel arm keeps q's dtype in both packages
    kern = decode_attention_paged(tq[:, :, 0], k8, v8, *args,
                                  torch.from_numpy(lens[:, 0]),
                                  impl="pallas", k_scale=ks, v_scale=vs)
    assert kern.dtype == torch.bfloat16


def test_bf16_int8_dense_decode_step_matches_jax_dtype():
    """One ``gpt2_decode_step_paged`` on int8 weights (quantized from the
    same bf16 tree) and the same int8 pool, dense attention: the logits
    come out in JAX's dtype and agree within LOGIT_TOL."""
    jcfg = JaxConfig(**TINY, remat=None, attn_impl="dense", scan_layers=False)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        JaxModel(jcfg).init(jax.random.PRNGKey(0)))
    jparams = jax_quantize_gpt2_params(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree))
    params = quantize_gpt2_params(
        {k: (v.bfloat16() if torch.is_tensor(v) else
             {kk: vv.bfloat16() for kk, vv in v.items()})
         for k, v in params_from_numpy(tree).items()})
    cfg = GPT2Config(**TINY, attn_impl="dense")
    L, H, Dh, S, M, page_len = 2, 4, 8, 3, 3, 8
    (k8, ks), (jk8, jks) = _pool(L, 1 + S * M, H, page_len, Dh, 4)
    (v8, vs), (jv8, jvs) = _pool(L, 1 + S * M, H, page_len, Dh, 5)
    table = _table(S, M, 6)
    lens = np.asarray([5, 2 * page_len + 1, 0], np.int32)
    active = np.asarray([True, True, False])
    toks = np.asarray([3, 17, 0], np.int32)
    out = gpt2_decode_step_paged(
        cfg, params, torch.from_numpy(toks), k8, v8,
        torch.from_numpy(table), torch.from_numpy(lens),
        torch.from_numpy(active), k_scale=ks, v_scale=vs)
    ref = jax_decode_step_paged(
        jcfg, jparams, jnp.asarray(toks), jk8, jv8, jnp.asarray(table),
        jnp.asarray(lens), jnp.asarray(active), k_scale=jks, v_scale=jvs)
    assert out[0].dtype == torch.float32
    assert np.dtype(ref[0].dtype) == np.float32
    np.testing.assert_allclose(out[0][:2].float().numpy(),
                               np.asarray(ref[0], np.float32)[:2],
                               atol=LOGIT_TOL, rtol=0)
    np.testing.assert_array_equal(out[-1].numpy(), np.asarray(ref[-1]))
