"""Port parity for block-sparse attention: ``deepspeed_tpu_torch``'s layouts
and lookup tables against the JAX package's, and its forward and gradients
(the autograd Function over the plain versions of the forward, dQ and
dK/dV kernels on the CPU) against the JAX package's Pallas kernels in
interpret mode, on the same numpy inputs and output cotangent.

Tolerances: layouts and LUTs are exact; fp32 forward O and lse within
2e-5 and gradients within 1e-5 (absolute; the same math in another
summation order, values of order 1).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.ops.pallas import block_sparse_attention as jbs
from deepspeed_tpu.ops.sparse_attention import sparsity_config as jsc
from deepspeed_tpu.ops.sparse_attention.sparse_self_attention import (
    build_lut as jax_build_lut)
from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bs
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as sc
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (
    build_lut)

B, H, T, D = 2, 4, 256, 64

#: every config, with per-head and random layouts: (name, kwargs)
CONFIGS = [
    ("DenseSparsityConfig", dict(block=16)),
    ("FixedSparsityConfig", dict(block=16)),
    ("FixedSparsityConfig", dict(block=32, attention="unidirectional",
                                 num_local_blocks=2)),
    ("FixedSparsityConfig", dict(block=16, different_layout_per_head=True,
                                 num_local_blocks=4, num_global_blocks=1,
                                 num_different_global_patterns=4,
                                 horizontal_global_attention=True)),
    ("VariableSparsityConfig", dict(block=16, num_random_blocks=2,
                                    local_window_blocks=[2, 3],
                                    global_block_indices=[0, 5],
                                    global_block_end_indices=[2, 7],
                                    different_layout_per_head=True,
                                    seed=3)),
    ("BigBirdSparsityConfig", dict(block=16, num_random_blocks=2,
                                   different_layout_per_head=True, seed=7)),
    ("BigBirdSparsityConfig", dict(block=64)),
    ("BSLongformerSparsityConfig", dict(block=16,
                                        global_block_indices=[1, 9])),
]
IDS = [f"{name[:-14]}-{i}" for i, (name, _) in enumerate(CONFIGS)]


def _layouts(name, kw):
    mine = getattr(sc, name)(num_heads=H, **kw).make_layout(T)
    ref = np.asarray(getattr(jsc, name)(num_heads=H, **kw).make_layout(T))
    return mine, ref, kw["block"]


@pytest.mark.parametrize("name,kw", CONFIGS, ids=IDS)
def test_layouts_and_luts_equal_jax(name, kw):
    mine, ref, _ = _layouts(name, kw)
    assert mine.dtype == ref.dtype and np.array_equal(mine, ref)
    for a, b in zip(bs.build_kernel_luts(mine), jbs.build_kernel_luts(ref)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(build_lut(mine), jax_build_lut(ref, use_native=False)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, T, D)).astype(np.float32)
            for _ in range(4)]


def _jax_fwd_grads(q, k, v, g, layout, block):
    """(O, lse [B·H, T], (dq, dk, dv)) of the interpret-mode Pallas
    kernels."""
    luts = [jnp.asarray(a) for a in jbs.build_kernel_luts(layout)]
    flat = [jnp.asarray(a).reshape(B * H, T, D) for a in (q, k, v)]
    out, lse = jbs._sparse_fwd(*flat, *luts[:2], sm_scale=D ** -0.5,
                               heads=H, block=block, interpret=True)

    def loss(q, k, v):
        return jnp.sum(jbs.block_sparse_attention(
            q, k, v, layout, block, interpret=True) * g)

    grads = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    return (np.asarray(out).reshape(B, H, T, D),
            np.asarray(lse).reshape(B, H, T),
            [np.asarray(x) for x in grads])


def _port_fwd_grads(q, k, v, g, layout, block):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = bs.block_sparse_attention(*ts, layout, block)
    (out * torch.from_numpy(g)).sum().backward()
    cols, nvalid, _, _ = bs.device_luts(bs.build_kernel_luts(layout), "cpu")
    _, lse = bs.block_sparse_fwd(*(t.detach() for t in ts), cols, nvalid,
                                 D ** -0.5, block)
    return (out.detach().numpy(), lse.numpy(),
            [t.grad.numpy() for t in ts])


@pytest.mark.parametrize("name,kw", [CONFIGS[1], CONFIGS[5], CONFIGS[6]],
                         ids=["fixed16", "bigbird16-per-head", "bigbird64"])
def test_forward_and_grads_match_jax(name, kw):
    """Forward O and lse within 2e-5, dq/dk/dv within 1e-5 of jax.grad of
    the interpret-mode Pallas kernels (block 16 and 64, one per-head
    layout)."""
    _, layout, block = _layouts(name, kw)
    q, k, v, g = _inputs(block)
    ref_o, ref_lse, ref_g = _jax_fwd_grads(q, k, v, g, layout, block)
    o, lse, grads = _port_fwd_grads(q, k, v, g, layout, block)
    assert np.abs(o - ref_o).max() <= 2e-5
    assert np.abs(lse - ref_lse).max() <= 2e-5
    for name_, a, b in zip("qkv", grads, ref_g):
        assert np.abs(a - b).max() <= 1e-5, f"d{name_}"


def _empty_layout(block):
    """Fixed layout with query block row 2 and key block column 5 empty
    in every head."""
    layout = sc.FixedSparsityConfig(num_heads=H, block=block).make_layout(T)
    layout[:, 2, :] = 0
    layout[:, :, 5] = 0
    return layout


def test_empty_row_and_column_give_zeros():
    """A query block row with no active block outputs exact zeros (lse
    -1e30) and gets zero dQ; a key block no row attends to gets zero
    dK/dV; nothing is NaN, and the rest equals the JAX kernels'."""
    block = 16
    layout = _empty_layout(block)
    q, k, v, g = _inputs(11)
    ref_o, ref_lse, ref_g = _jax_fwd_grads(q, k, v, g, layout, block)
    o, lse, (dq, dk, dv) = _port_fwd_grads(q, k, v, g, layout, block)
    rows, keys = slice(2 * block, 3 * block), slice(5 * block, 6 * block)
    assert (o[:, :, rows] == 0).all() and (lse[:, :, rows] == -1e30).all()
    assert (dq[:, :, rows] == 0).all()
    assert (dk[:, :, keys] == 0).all() and (dv[:, :, keys] == 0).all()
    for a, b in zip((o, dq, dk, dv), (ref_o, *ref_g)):
        assert np.isfinite(a).all() and np.abs(a - b).max() <= 2e-5


def test_plain_versions_match_a_dense_masked_reference():
    """The three plain versions, called directly on given lse and delta,
    against dense attention under the layout's token mask (block 32, a
    per-head layout, an empty row)."""
    block = 32
    layout = sc.BigBirdSparsityConfig(
        num_heads=H, block=block, different_layout_per_head=True,
        seed=5).make_layout(T)
    layout[1, 3, :] = 0
    q, k, v, do = (torch.from_numpy(a).double() for a in _inputs(4))
    mask = torch.from_numpy(np.kron(layout, np.ones((block, block)))) > 0
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * D ** -0.5
    s = torch.where(mask, s, -1e30)
    p = torch.where(mask, torch.softmax(s, -1), 0.0)
    ref = p @ v
    cols, nvalid, rows_t, nvalid_t = bs.device_luts(
        bs.build_kernel_luts(layout), "cpu")
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    out, lse = bs.block_sparse_fwd_plain(q32, k32, v32, cols, nvalid,
                                         D ** -0.5, block)
    assert (out.double() - ref).abs().max() <= 2e-5
    delta = (do32 * out).sum(-1)
    dq = bs.block_sparse_bwd_dq_plain(q32, k32, v32, do32, lse, delta, cols,
                                      nvalid, D ** -0.5, block)
    dk, dv = bs.block_sparse_bwd_dkv_plain(q32, k32, v32, do32, lse, delta,
                                           rows_t, nvalid_t, D ** -0.5,
                                           block)
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (do * ref).sum(-1, keepdim=True)) * D ** -0.5
    for got, want in ((dq, ds @ k), (dk, ds.transpose(-1, -2) @ q),
                      (dv, p.transpose(-1, -2) @ do)):
        assert (got.double() - want).abs().max() <= 1e-5


def test_smem_guard_is_not_carried_over():
    """The JAX wrapper refuses (outside interpret mode) a LUT over its
    ~1 MB TPU SMEM budget; the port keeps its LUTs in device memory and
    runs the same call.  64 heads with their own layouts at 64 blocks of
    size 1: 64 x 64 x 64 int32 = 1 MB of LUT."""
    Hs, Ts, Ds, block = 64, 64, 8, 1
    rng = np.random.default_rng(0)
    layout = (rng.random((Hs, Ts, Ts)) < 0.9).astype(np.int64)
    layout[:, np.arange(Ts), np.arange(Ts)] = 1  # every row full width
    layout[:, 0, :] = 1
    q, k, v = (rng.standard_normal((1, Hs, Ts, Ds)).astype(np.float32)
               for _ in range(3))
    with pytest.raises(ValueError, match="SMEM"):
        jbs.block_sparse_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                   layout, block, interpret=False)
    out = bs.block_sparse_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                    layout, block)
    s = np.einsum("bhqd,bhkd->bhqk", q, k) * Ds ** -0.5
    s = np.where(layout[None] > 0, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    ref = (p / p.sum(-1, keepdims=True)) @ v
    assert np.abs(out.numpy() - ref).max() <= 2e-5


def test_public_checks_and_lut_reuse():
    layout = sc.FixedSparsityConfig(num_heads=H, block=16).make_layout(T)
    q = torch.zeros(1, H, T, D)
    with pytest.raises(ValueError, match="multiple of block"):
        bs.block_sparse_attention(q[:, :, :T - 8], q[:, :, :T - 8],
                                  q[:, :, :T - 8], layout, 16)
    with pytest.raises(ValueError, match="layout"):
        bs.block_sparse_attention(q, q, q, layout[:2], 16)
    luts = bs.device_luts(bs.build_kernel_luts(layout), "cpu")
    assert all(t.dtype == torch.int32 for t in luts)
    assert all(a is b for a, b in zip(bs.device_luts(luts, "cpu"), luts))
    # on the CPU the plain versions run: no kernel launch is counted
    before = bs.block_sparse_fwd.launches
    bs.block_sparse_attention(q, q, q, layout, 16, luts=luts)
    assert bs.block_sparse_fwd.launches == before
