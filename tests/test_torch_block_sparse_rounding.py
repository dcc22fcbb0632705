"""Why the tensor-core block-sparse forward feeds P to P·V as two terms, and
why its dQ and dK/dV kernels round dS (and P~) once each.

``csrc/block_sparse_fwd.cu``, ``csrc/block_sparse_bwd_dq.cu`` and
``csrc/block_sparse_bwd_dkv.cu`` (bf16 and fp16) run every product on
mma.sync with fp32 accumulators and bf16 operands.  The forward enters P·V
as hi = round(p) plus lo = round(p - hi), as ``csrc/flash_fwd.cu`` does; dQ
rounds dS once before dS·K, as the JAX kernel's ``ds.astype(k.dtype)``
does, and dK/dV round P~ and dS once each before their second products, as
its ``p.astype(do.dtype)`` and ``ds.astype(q.dtype)`` do.  This emulates
all three in PyTorch on the CPU
(inputs from a numpy seed, [2, 2, 256, 64], the Fixed layout at block 16)
and holds the emulation

(a) to the JAX package's ``block_sparse_attention`` and its ``jax.grad``
    (dQ, dK, dV) in interpret mode, in bf16, within 1e-2 of the largest
    magnitude (both sides round their results to bf16, and the JAX forward
    rounds P once);
(b) to the port's fp32 plain versions within ``chip_smoke.py``'s limits:
    the forward within one bf16 ulp + 1e-4 elementwise, the gradients
    within 2e-2 of the largest magnitude.

Rounding P once in the forward breaks (b): that is why the split exists.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.ops.pallas import block_sparse_attention as jbs
from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bs
from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig

from test_torch_zero import one_thread  # noqa: F401

B, H, T, D = 2, 2, 256, 64
BLOCK = 16
SCALE = D ** -0.5
#: against the JAX kernel, and against the fp32 plain versions
#: (``chip_smoke.py``'s bf16 TOL), both of the largest magnitude
TOL_JAX, TOL_CHIP = 1e-2, 2e-2


def _layout():
    return FixedSparsityConfig(num_heads=H).make_layout(T)


def _inputs(seed=0):
    """q, k, v, dO: bf16 values from a numpy seed, as fp32 tensors."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, H, T, D)).astype(
        np.float32)).bfloat16().float() for _ in range(4)]


def _token_mask(layout):
    """The block layout as a [H, T, T] boolean token mask."""
    return torch.from_numpy(np.kron(layout, np.ones((BLOCK, BLOCK),
                                                    np.int64)) > 0)


def _ulps(got, want):
    """max |got - want| over (one bf16 ulp of want + 1e-4): chip_smoke's
    ``_ulp_err``."""
    return ((got.float() - want).abs()
            / (want.abs() * 2.0 ** -7 + 1e-4)).max().item()


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def _emulated_fwd(q, k, v, layout, split: bool):
    """The forward kernel's arithmetic: fp32 scores of the bf16 inputs,
    the softmax in fp32, P·V on bf16 operands (P rounded once, or as
    hi + lo) with fp32 sums, the output rounded to bf16."""
    s = torch.where(_token_mask(layout), q @ k.transpose(-1, -2) * SCALE,
                    -torch.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    hi = p.bfloat16().float()
    pv = hi @ v
    if split:
        pv = pv + (p - hi).bfloat16().float() @ v
    return (pv / l).bfloat16().float()


def _emulated_bwd(q, k, v, do, layout):
    """The dQ and dK/dV kernels' arithmetic over the plain forward's lse
    and delta = rowsum(dO·O) of the bf16 output (as the autograd Function
    computes it): dS rounded once to bf16 before dS·K (dQ), P~ and dS
    before P~ᵀ·dO and dSᵀ·Q (dK/dV), the results rounded to bf16; beside
    them the fp32 plain versions on the same lse and delta.  Returns
    ``((dq, dk, dv), (plain dq, dk, dv))``."""
    luts = bs.device_luts(bs.build_kernel_luts(layout), "cpu")
    out, lse = bs.block_sparse_fwd_plain(q, k, v, *luts[:2], SCALE, BLOCK)
    delta = (do * out.bfloat16().float()).sum(-1)
    s = q @ k.transpose(-1, -2) * SCALE
    p = torch.where(_token_mask(layout), torch.exp(s - lse[..., None]), 0.0)
    ds = p * (do @ v.transpose(-1, -2) - delta[..., None]) * SCALE
    dq = ds.bfloat16().float() @ k
    dv = p.bfloat16().float().transpose(-1, -2) @ do
    dk = ds.bfloat16().float().transpose(-1, -2) @ q
    plain = (bs.block_sparse_bwd_dq_plain(q, k, v, do, lse, delta,
                                          *luts[:2], SCALE, BLOCK),
             *bs.block_sparse_bwd_dkv_plain(q, k, v, do, lse, delta,
                                            *luts[2:], SCALE, BLOCK))
    return tuple(x.bfloat16().float() for x in (dq, dk, dv)), plain


def _jax(q, k, v, do, layout):
    """The JAX Pallas kernels (interpret mode) on the same bf16 values:
    the forward output and dQ, dK, dV of sum(out * dO)."""
    g = jnp.asarray(do.numpy(), jnp.bfloat16).astype(jnp.float32)
    qj, kj, vj = (jnp.asarray(x.numpy(), jnp.bfloat16) for x in (q, k, v))

    def f(q_, k_, v_):
        return jbs.block_sparse_attention(q_, k_, v_, layout, BLOCK,
                                          interpret=True)

    out = f(qj, kj, vj)
    grads = jax.grad(lambda q_, k_, v_: jnp.sum(
        f(q_, k_, v_).astype(jnp.float32) * g), argnums=(0, 1, 2))(qj, kj,
                                                                 vj)
    return [torch.from_numpy(np.array(x.astype(jnp.float32)))
            for x in (out, *grads)]


@pytest.mark.parametrize("split,within_one_ulp", [(False, False),
                                                  (True, True)],
                         ids=["rounded_once", "hi_plus_lo"])
def test_p_split_keeps_the_forward_within_one_bf16_ulp(split,
                                                       within_one_ulp):
    q, k, v, _ = _inputs()
    layout = _layout()
    luts = bs.device_luts(bs.build_kernel_luts(layout), "cpu")
    want, _ = bs.block_sparse_fwd_plain(q, k, v, *luts[:2], SCALE, BLOCK)
    ulps = _ulps(_emulated_fwd(q, k, v, layout, split), want)
    print(f"P {'hi + lo' if split else 'rounded once'}: {ulps:.3g} of one "
          "bf16 ulp + 1e-4")
    assert (ulps <= 1.0) == within_one_ulp, ulps


def test_single_rounding_dkv_stays_within_chip_tolerance():
    q, k, v, do = _inputs()
    (_, dk, dv), (_, pk, pv) = _emulated_bwd(q, k, v, do, _layout())
    err = max(_rel(dk, pk), _rel(dv, pv))
    print(f"dK/dV emulation vs fp32 plain: {err:.3g} of the largest")
    assert err <= TOL_CHIP, err


def test_single_rounding_dq_stays_within_chip_tolerance():
    q, k, v, do = _inputs()
    (dq, _, _), (pq, _, _) = _emulated_bwd(q, k, v, do, _layout())
    err = _rel(dq, pq)
    print(f"dQ emulation (dS rounded once) vs fp32 plain: {err:.3g} of the "
          "largest")
    assert err <= TOL_CHIP, err


def test_emulation_matches_the_jax_kernels():
    q, k, v, do = _inputs()
    layout = _layout()
    out = _emulated_fwd(q, k, v, layout, split=True)
    (dq, dk, dv), _ = _emulated_bwd(q, k, v, do, layout)
    jout, jq, jk, jv = _jax(q, k, v, do, layout)
    errs = {"out": _rel(out, jout), "dq": _rel(dq, jq), "dk": _rel(dk, jk),
            "dv": _rel(dv, jv)}
    print(f"emulation vs JAX (of the largest magnitude): {errs}")
    assert max(errs.values()) <= TOL_JAX, errs
