"""Why the tensor-core dK/dV kernel rounds P~ and dS once each.

``csrc/flash_bwd_dkv.cu`` (bf16/fp16) computes S^T, dP^T and both
gradient products on the tensor cores with fp32 accumulation, and feeds
P~^T (p times the dropout keep scale) and dS^T to the second products as
bf16 operands, each rounded once, as the JAX kernel's
``pd.astype(do.dtype)`` and ``ds.astype(q.dtype)`` do.  Unlike the
forward (``tests/test_torch_flash_split.py``), no hi + lo split is needed:
the gradients have no one-ulp check, only ``chip_smoke.py``'s 2e-2 of the
largest gradient magnitude.  This emulates the kernel's dK/dV in PyTorch
on the CPU (inputs from a numpy seed) and pins the choice:

(a) the emulation matches ``jax.grad`` of the JAX package's Pallas flash
    kernel in interpret mode, which rounds at the same two places, within
    1e-2 of the largest gradient magnitude (the bf16 tolerance of
    ``tests/test_torch_flash_backward.py``: both sides round their
    gradients to bf16, one ulp of which is 2^-8 to 2^-7 of the largest,
    and they still differ in their forward's lse and their sums' order);
(b) the emulation stays within ``chip_smoke.py``'s 2e-2 of the largest
    gradient magnitude of the plain version in fp32.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention)
from deepspeed_tpu_torch.ops.kernels.flash_attention import (
    NEG_MASK, _bwd_terms, flash_attention_plain, flash_bwd_dkv_plain)

B, H, T, D = 2, 2, 96, 64
BLOCK = 32
SCALE = D ** -0.5
#: emulation against the JAX kernel, and against the fp32 plain version
#: (``chip_smoke.py``'s TOL for bf16), both of the largest magnitude
TOL_JAX, TOL_CHIP = 1e-2, 2e-2

CALLS = {
    # BERT-shaped: non-causal, right-padded key mask, dropout 0.1
    "bert": dict(causal=False, pad=(60, 81), rate=0.1, seed=0xB5297A4D),
    "causal": dict(causal=True, pad=None, rate=0.0, seed=0),
}


def _inputs(seed):
    """q, k, v, dO: bf16 values from a numpy seed, as fp32 tensors."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, H, T, D)).astype(
        np.float32)).bfloat16().float() for _ in range(4)]


def _attend(pad):
    """[B, T] boolean key mask (True = attend), row b padded from pad[b]."""
    if pad is None:
        return None
    keep = np.ones((B, T), bool)
    for b, start in enumerate(pad):
        keep[b, start:] = False
    return keep


def _emulated(q, k, v, do, call):
    """The kernel's dK/dV: fp32 products, P~ and dS rounded once to bf16
    before the second products, the results rounded to bf16.  lse from the
    plain forward, delta = rowsum(dO·O) over the bf16 output (as the
    autograd Function computes it)."""
    keep = _attend(call["pad"])
    km = None
    if keep is not None:
        km = torch.from_numpy(np.where(keep, 0.0, NEG_MASK).astype(
            np.float32))[:, None].expand(B, H, T).reshape(B * H, T)
    args = (call["causal"], SCALE, None, km, call["rate"], call["seed"],
            None)
    out, lse = flash_attention_plain(q, k, v, *args)
    delta = (do * out.bfloat16().float()).sum(-1)
    pd, ds = _bwd_terms(q, k, v, do, lse, delta, *args)
    dv = pd.bfloat16().float().transpose(-1, -2) @ do
    dk = ds.bfloat16().float().transpose(-1, -2) @ q
    plain = flash_bwd_dkv_plain(q, k, v, do, lse, delta, *args)
    return (dk.bfloat16().float(), dv.bfloat16().float()), plain, keep


def _jax_dkv(q, k, v, do, call, keep):
    """dK, dV of the JAX Pallas kernel (interpret mode) on the same bf16
    values and output cotangent."""
    kw = dict(causal=call["causal"], sm_scale=SCALE, block_q=BLOCK,
              block_k=BLOCK, interpret=True)
    if call["rate"] > 0:
        kw.update(dropout_rate=call["rate"], dropout_seed=call["seed"])
    if keep is not None:
        kw["key_mask"] = jnp.asarray(keep)
    g = jnp.asarray(do.numpy(), jnp.bfloat16)

    def f(k_, v_):
        out = jax_flash_attention(jnp.asarray(q.numpy(), jnp.bfloat16), k_,
                                  v_, **kw)
        return jnp.sum(out.astype(jnp.float32) * g.astype(jnp.float32))

    grads = jax.grad(f, argnums=(0, 1))(
        *(jnp.asarray(x.numpy(), jnp.bfloat16) for x in (k, v)))
    return [torch.from_numpy(np.array(x.astype(jnp.float32)))
            for x in grads]


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("name", list(CALLS))
def test_single_rounding_matches_jax_and_stays_within_chip_tolerance(name):
    call = CALLS[name]
    q, k, v, do = _inputs(list(CALLS).index(name))
    (dk, dv), (pk, pv), keep = _emulated(q, k, v, do, call)
    jk, jv = _jax_dkv(q, k, v, do, call, keep)
    e_jax = max(_rel(dk, jk), _rel(dv, jv))
    e_plain = max(_rel(dk, pk), _rel(dv, pv))
    print(f"{name}: emulation vs JAX {e_jax:.3g}, vs fp32 plain "
          f"{e_plain:.3g} (of the largest gradient)")
    assert e_jax <= TOL_JAX, e_jax
    assert e_plain <= TOL_CHIP, e_plain
    if keep is not None:  # padded keys: exact-zero dK/dV in both
        pad = torch.from_numpy(~keep)
        for g in (dk, dv, jk, jv):
            assert (g.transpose(1, 2)[pad] == 0).all()
