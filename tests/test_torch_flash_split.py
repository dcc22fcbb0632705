"""Why the tensor-core flash forward feeds P to P·V as two terms.

``csrc/flash_fwd.cu`` (bf16/fp16) rounds its operands to the input type
before each wgmma.  Rounding P once, as the JAX kernel's
``pd.astype(v.dtype)`` does, moves the bf16 output by several bf16 ulps at
the BERT call (non-causal, a padded key mask, dropout 0.1), where
``chip_smoke.py`` holds the forward to one bf16 ulp + 1e-4 elementwise of
the plain version in fp32.  P as hi = round(p) plus lo = round(p - hi)
keeps ~16 bits of p and stays within that bound.  This emulates both in
PyTorch on the CPU over the plain version's own terms (inputs from a numpy
seed) and pins the choice.
"""
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.kernels.flash_attention import (
    NEG_MASK, _drop_scale, _scores, flash_attention_plain)

B, H, T, D = 2, 4, 512, 64
RATE, SEED = 0.1, 0xB5297A4D


def _ulps(got, want):
    """max |got - want| over (one bf16 ulp of want + 1e-4): chip_smoke's
    ``_ulp_err``."""
    return ((got.float() - want).abs()
            / (want.abs() * 2.0 ** -7 + 1e-4)).max().item()


def _bert_call():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, T, D)).astype(
        np.float32)).bfloat16().float() for _ in range(3))
    pad = np.zeros((B, T), bool)
    pad[0, 300:] = True
    pad[1, 100:] = True
    km = torch.from_numpy(np.where(pad, NEG_MASK, 0.0).astype(np.float32))
    km = km[:, None].expand(B, H, T).reshape(B * H, T).contiguous()
    return q, k, v, (False, D ** -0.5, None, km, RATE, SEED, None)


def _emulated(q, k, v, args, split: bool):
    """The kernel's forward with P·V on bf16 operands: P rounded once, or
    as hi + lo."""
    causal, scale, kvl, km, rate, seed, aff = args
    s = _scores(q, k, causal, scale, kvl, km)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    p = p * _drop_scale(q, T, rate, seed, aff)
    hi = p.bfloat16().float()
    pv = hi @ v
    if split:
        pv = pv + (p - hi).bfloat16().float() @ v
    return (pv / l).bfloat16()


@pytest.mark.parametrize("split,within_one_ulp", [(False, False),
                                                  (True, True)])
def test_p_split_keeps_the_forward_within_one_bf16_ulp(split,
                                                       within_one_ulp):
    q, k, v, args = _bert_call()
    want, _ = flash_attention_plain(q, k, v, *args)
    ulps = _ulps(_emulated(q, k, v, args, split), want)
    print(f"P {'hi + lo' if split else 'rounded once'}: {ulps:.3g} of one "
          "bf16 ulp + 1e-4")
    assert (ulps <= 1.0) == within_one_ulp, ulps
