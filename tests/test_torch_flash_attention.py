"""Port parity: ``deepspeed_tpu_torch``'s flash_attention (plain version on
the CPU) against the JAX package's Pallas flash kernel in interpret mode,
on the same numpy inputs.

Tolerances: fp32 1e-5 (same math, different summation order); bf16 2e-2
(the Pallas kernel rounds the probabilities to bf16 before the value
product, the port keeps them in fp32).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from deepspeed_tpu.ops.pallas.flash_attention import (
    dense_keep_mask as jax_dense_keep_mask,
    flash_attention as jax_flash_attention)
from deepspeed_tpu_torch.ops.kernels.flash_attention import (
    DEAD_LSE, dense_keep_mask, flash_attention, flash_attention_plain)

from test_torch_zero import one_thread  # noqa: F401

B, H, D = 2, 3, 64
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(t, tk, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, n, D)).astype(np.float32)
               for n in (t, tk, tk))
    if dtype == "bfloat16":  # the same bf16 values on both sides
        q, k, v = (np.asarray(torch.from_numpy(a).bfloat16().float())
                   for a in (q, k, v))
    return q, k, v


def _both(q, k, v, dtype="float32", **kw):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    ref = jax_flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                              block_q=16, block_k=16, interpret=True, **kw)
    out = flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                          **kw)
    assert out.dtype == tdt
    return (np.asarray(ref.astype(jnp.float32)),
            out.float().numpy())


# causal / non-causal, T not a multiple of the reference's 16-row block,
# kv_length below T, 0 (every row dead) and at T
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,t,tk,kv_length", [
    (True, 40, 40, None),
    (True, 77, 77, 50),
    (False, 40, 56, None),
    (False, 24, 56, 13),
    (False, 24, 56, 0),
    (False, 24, 56, 56),
])
def test_flash_matches_jax(causal, t, tk, kv_length, dtype):
    q, k, v = _inputs(t, tk, seed=t + tk, dtype=dtype)
    ref, out = _both(q, k, v, dtype, causal=causal, kv_length=kv_length)
    np.testing.assert_allclose(out, ref, atol=TOL[dtype], rtol=0)
    if kv_length == 0:
        assert (out == 0).all()


def test_flash_garbage_beyond_kv_length_is_never_read():
    q, k, v = _inputs(24, 56, seed=3)
    k2, v2 = k.copy(), v.copy()
    k2[:, :, 20:] = 1e4
    v2[:, :, 20:] = 1e4
    clean = flash_attention(*map(torch.from_numpy, (q, k, v)),
                            causal=False, kv_length=20)
    dirty = flash_attention(*map(torch.from_numpy, (q, k2, v2)),
                            causal=False, kv_length=20)
    assert torch.equal(clean, dirty)


def test_flash_dead_rows_and_key_mask_match_jax():
    """A key_mask that drops every key of one batch row leaves dead rows:
    exact zeros and lse = +DEAD_LSE, as in the JAX kernel."""
    q, k, v = _inputs(32, 32, seed=5)
    mask = np.ones((B, 32), bool)
    mask[1] = False
    mask[0, 7:19] = False
    ref, out = _both(q, k, v, causal=False, key_mask=mask)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    assert (out[1] == 0).all()
    km = torch.where(torch.from_numpy(mask), 0.0, -1e9)
    _, lse = flash_attention_plain(
        *map(torch.from_numpy, (q, k, v)), False, D ** -0.5,
        kmask=km[:, None, :].expand(B, H, 32).reshape(B * H, 32))
    assert (lse[1] == DEAD_LSE).all() and (lse[0] < 100).all()


def test_flash_dropout_matches_jax_hash():
    """The plain version's dropout is the JAX kernel's position hash bit
    for bit, so the same seed gives the same output."""
    np.testing.assert_array_equal(
        dense_keep_mask(2, 3, 9, 11, 1234, 0.3).numpy(),
        np.asarray(jax_dense_keep_mask(2, 3, 9, 11, 1234, 0.3)))
    q, k, v = _inputs(40, 40, seed=9)
    ref, out = _both(q, k, v, causal=True, dropout_rate=0.25,
                     dropout_seed=77, bh_affine=(5, 3, 7))
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_flash_validation_and_no_cpu_launch_count():
    q, k, v = map(torch.from_numpy, _inputs(8, 8, seed=1))
    before = flash_attention.launches
    flash_attention(q, k, v)
    assert flash_attention.launches == before  # the plain version ran
    with pytest.raises(ValueError, match="kv_length"):
        flash_attention(q, k, v, kv_length=9)
    with pytest.raises(AssertionError, match="causal"):
        flash_attention(q, k[:, :, :4], v[:, :, :4])
