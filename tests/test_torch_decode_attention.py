"""Port parity: ``deepspeed_tpu_torch``'s decode_attention (``impl="pallas"``
runs its plain version on the CPU; ``impl="dense"`` the dense reference)
against the JAX package's decode_attention with ``impl="pallas"`` (the
Pallas kernel in interpret mode) and ``impl="dense"``.

Tolerances: fp32 1e-5 (same math, different summation order); bf16 2e-2
(the two frameworks round the probabilities at different places).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from deepspeed_tpu.ops.pallas.decode_attention import (
    decode_attention as jax_decode_attention)
from deepspeed_tpu_torch.ops.kernels.decode_attention import (
    decode_attention)

S, H, T, D = 5, 3, 72, 64
LENGTHS = np.asarray([0, 1, T, 17, 40], np.int32)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(seed, dtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((S, H, T, D)).astype(np.float32)
            for _ in range(2))
    if dtype == "bfloat16":
        q, k, v = (np.asarray(torch.from_numpy(a).bfloat16().float())
                   for a in (q, k, v))
    return q, k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("jax_impl", ["pallas", "dense"])
@pytest.mark.parametrize("impl", ["pallas", "dense"])
def test_decode_matches_jax(impl, jax_impl, dtype):
    q, k, v = _inputs(0, dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    ref = jax_decode_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                               jnp.asarray(LENGTHS), impl=jax_impl,
                               block_k=32, interpret=True)
    out = decode_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                           torch.from_numpy(LENGTHS), impl=impl)
    assert out.dtype == tdt and tuple(out.shape) == (S, H, D)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=0)
    assert (out[0] == 0).all()  # length 0: exact zeros


@pytest.mark.parametrize("impl", ["pallas", "dense"])
def test_decode_masks_garbage_tail(impl):
    q, k, v = map(torch.from_numpy, _inputs(1, "float32"))
    lengths = torch.from_numpy(LENGTHS)
    k2, v2 = k.clone(), v.clone()
    for s, n in enumerate(LENGTHS):
        k2[s, :, n:] = 1e4
        v2[s, :, n:] = 1e4
    clean = decode_attention(q, k, v, lengths, impl=impl)
    dirty = decode_attention(q, k2, v2, lengths, impl=impl)
    assert torch.equal(clean, dirty)


def test_decode_rejects_unknown_impl_and_counts_no_cpu_launch():
    q, k, v = map(torch.from_numpy, _inputs(2, "float32"))
    lengths = torch.from_numpy(LENGTHS)
    before = decode_attention.launches
    decode_attention(q, k, v, lengths)
    assert decode_attention.launches == before  # the plain version ran
    with pytest.raises(ValueError, match="impl"):
        decode_attention(q, k, v, lengths, impl="cuda")
