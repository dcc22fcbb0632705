"""Port parity for ``deepspeed_tpu_torch.ops.sparse_attention``: the gathered
-block path of ``SparseSelfAttention`` (rpe, both mask modes, a fully
masked row) with its gradients, the kernel-path dispatch,
``BertSparseSelfAttention`` on the JAX layer's parameters and the
padding utilities, each against the JAX package on the same numpy inputs
(the JAX kernel path runs its Pallas kernels in interpret mode).

Tolerances: outputs 2e-5 and gradients 1e-5 absolute in fp32 (values of
order 1, the same math in another order); the utilities are exact.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu_torch.ops import sparse_attention as sa
from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bs
from deepspeed_tpu_torch.runtime.utils import params_from_numpy

BLOCK = 16


def _qkv(B, H, T, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, T, D)).astype(np.float32)
            for _ in range(4)]


def _run_both(make_cfg, H, arrays, masks, **modes):
    """(port out, port grads, JAX out, JAX grads) of one
    SparseSelfAttention call; ``masks`` maps keyword → numpy array."""
    q, k, v, g = arrays
    jattn = jsa.SparseSelfAttention(make_cfg(jsa), **modes)
    attn = sa.SparseSelfAttention(make_cfg(sa), **modes)

    def loss(q, k, v):
        out = jattn(q, k, v, **{n: jnp.asarray(m) for n, m in masks.items()})
        return jnp.sum(out * g), out

    (_, jout), jg = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = attn(*ts, **{n: torch.from_numpy(m) for n, m in masks.items()})
    (out * torch.from_numpy(g)).sum().backward()
    return (out.detach().numpy(), [t.grad.numpy() for t in ts],
            np.asarray(jout), [np.asarray(x) for x in jg])


def _fixed(mod):
    return mod.FixedSparsityConfig(4, block=BLOCK, num_local_blocks=2)


def _bigbird(mod):
    return mod.BigBirdSparsityConfig(4, block=BLOCK, num_random_blocks=1,
                                     different_layout_per_head=True, seed=3)


def _masks(case, B, T):
    rng = np.random.default_rng(9)
    if case == "rpe":
        return {"rpe": rng.standard_normal((T, T)).astype(np.float32)}
    if case == "kp_add":
        kp = np.zeros((B, T), np.float32)
        kp[:, -T // 4:] = -1e4
        return {"key_padding_mask": kp}
    if case == "kp_mul":
        kp = np.ones((B, T), np.float32)
        kp[0, 5:40] = 0
        kp[1, :] = 0            # every key of batch row 1: fully masked
        return {"key_padding_mask": kp}
    if case == "am_add":
        return {"attn_mask": (rng.standard_normal((T, T)) * 2).astype(
            np.float32)}
    if case == "am_mul":          # causal, plus query row 3 masked entirely
        am = np.tril(np.ones((T, T), np.float32))
        am[3, :] = 0
        return {"attn_mask": am}
    if case == "all":
        return {**_masks("rpe", B, T), **_masks("kp_add", B, T),
                **_masks("am_mul", B, T)}
    return {}


@pytest.mark.parametrize("case,modes", [
    ("rpe", {}),
    ("kp_add", {"key_padding_mask_mode": "add"}),
    ("kp_mul", {"key_padding_mask_mode": "mul"}),
    ("am_add", {"attn_mask_mode": "add"}),
    ("am_mul", {"attn_mask_mode": "mul"}),
    ("all", {}),
])
def test_gather_path_matches_jax(case, modes):
    """Outputs within 2e-5 and gradients within 1e-5 of the JAX gather
    path; fully-masked rows give zeros and zero gradients, not NaN."""
    B, H, T, D = 2, 4, 4 * BLOCK, 16
    arrays = _qkv(B, H, T, D, seed=len(case))
    masks = _masks(case, B, T)
    out, grads, jout, jgrads = _run_both(_bigbird, H, arrays, masks, **modes)
    assert np.isfinite(out).all() and np.abs(out - jout).max() <= 2e-5
    for a, b in zip(grads, jgrads):
        assert np.isfinite(a).all() and np.abs(a - b).max() <= 1e-5
    if case == "kp_mul":
        assert (out[1] == 0).all() and (grads[0][1] == 0).all()
    if case == "am_mul":
        assert (out[:, :, 3] == 0).all()


def test_kernel_path_matches_jax_and_caches_its_luts():
    """No masks and T a multiple of the block: the block-sparse kernels'
    path (their plain versions on the CPU) against the JAX Pallas path;
    the device LUTs are built once per sequence length."""
    B, H, T, D = 2, 4, 8 * BLOCK, 64
    arrays = _qkv(B, H, T, D, seed=1)
    out, grads, jout, jgrads = _run_both(_fixed, H, arrays, {})
    assert np.abs(out - jout).max() <= 2e-5
    for a, b in zip(grads, jgrads):
        assert np.abs(a - b).max() <= 1e-5
    attn = sa.SparseSelfAttention(_fixed(sa))
    q = torch.from_numpy(arrays[0])
    attn(q, q, q)
    first = attn._device_cache[("kernel", T, "cpu")]
    attn(q, q, q)
    assert attn._device_cache[("kernel", T, "cpu")] is first
    assert len(attn._device_cache) == 1
    with pytest.raises(ValueError, match="heads"):
        attn(q[:, :2], q[:, :2], q[:, :2])


def test_build_lut_native_arm_raises():
    """The native arm (item 12's second half) is ported: it builds the
    host library and equals the numpy arm, or raises ``OpBuilderError``
    where the toolchain is missing (``tests/test_torch_sparse_lut.py``
    holds the three arms)."""
    from deepspeed_tpu_torch.ops.op_builder import OpBuilderError
    layout = _fixed(sa).make_layout(4 * BLOCK)
    cols, valid = sa.build_lut(layout, use_native=False)
    assert cols.dtype == np.int32 and valid.dtype == bool
    try:
        native = sa.build_lut(layout, use_native=True)
    except OpBuilderError:
        return
    assert all(np.array_equal(x, y) for x, y in zip(native, (cols, valid)))


@pytest.mark.parametrize("masked", [False, True], ids=["kernel", "gather"])
def test_bert_sparse_self_attention_matches_jax(masked):
    """The JAX layer's parameters carried over with params_from_numpy:
    without a mask the layer takes the kernel path, with an additive
    padding mask the gather path; context and every gradient (params and
    input) against JAX."""
    B, T, d, H = 2, 4 * BLOCK, 256, 4
    jlayer = jsa.BertSparseSelfAttention(
        jsa.BertSelfAttentionConfig(d, H), _fixed(jsa))
    layer = sa.BertSparseSelfAttention(sa.BertSelfAttentionConfig(d, H),
                                       _fixed(sa))
    tree = jax.tree.map(np.asarray, jlayer.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    g = rng.standard_normal((B, T, d)).astype(np.float32)
    mask = np.zeros((B, T), np.float32)
    mask[1, T // 2:] = -10000.0
    m = mask if masked else None

    def loss(p, x):
        return jnp.sum(jlayer(p, x, None if m is None else jnp.asarray(m))
                       * g)

    jg_p, jg_x = jax.grad(loss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    params = params_from_numpy(tree)
    for sub in params.values():
        for leaf in sub.values():
            leaf.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    before = bs.block_sparse_fwd.launches
    out = layer(params, xt, None if m is None else torch.from_numpy(m))
    (out * torch.from_numpy(g)).sum().backward()
    assert out.shape == (B, T, d)
    assert bs.block_sparse_fwd.launches == before  # plain versions on CPU
    assert np.abs(xt.grad.numpy() - np.asarray(jg_x)).max() <= 1e-5
    for name in ("query", "key", "value"):
        for leaf in ("w", "b"):
            ref = np.asarray(jg_p[name][leaf])
            err = np.abs(params[name][leaf].grad.numpy() - ref).max()
            assert err <= 1e-5 * max(1.0, np.abs(ref).max()), (name, leaf)
    fresh = layer.init(0)
    assert fresh["query"]["w"].shape == (d, d)
    assert abs(float(fresh["query"]["w"].std()) - 0.02) < 2e-3


def test_padding_utils_round_trip_match_jax():
    """pad_to_block_size / unpad_sequence_output /
    extend_position_embedding against the JAX helpers: equal arrays."""
    rng = np.random.default_rng(4)
    ids = rng.integers(1, 50, (2, 20)).astype(np.int64)
    mask = np.ones((2, 20), np.int64)
    tt = np.zeros((2, 20), np.int64)
    pos = np.tile(np.arange(20), (2, 1))
    emb = rng.standard_normal((2, 20, 8)).astype(np.float32)
    U, JU = sa.SparseAttentionUtils, jsa.SparseAttentionUtils
    for use_ids in (True, False):
        args = [ids if use_ids else None, mask, tt, pos,
                None if use_ids else emb]
        n, mine = U.pad_to_block_size(
            BLOCK, *(None if a is None else torch.from_numpy(a)
                     for a in args), pad_token_id=7)
        jn, ref = JU.pad_to_block_size(
            BLOCK, *(None if a is None else jnp.asarray(a) for a in args),
            pad_token_id=7)
        assert n == jn == 12
        for a, b in zip(mine, ref):
            assert (a is None) == (b is None)
            if a is not None:
                assert np.array_equal(a.numpy(), np.asarray(b))
    seq = torch.from_numpy(rng.standard_normal((2, 32, 8)).astype(
        np.float32))
    assert torch.equal(U.unpad_sequence_output(12, seq), seq[:, :20])
    assert U.unpad_sequence_output(0, seq) is seq
    assert torch.equal(U.unpad_sequence_output(12, seq[0, :, 0]),
                       seq[0, :20, 0])
    pe = rng.standard_normal((8, 4)).astype(np.float32)
    for n in (5, 8, 20):
        assert np.array_equal(
            U.extend_position_embedding(torch.from_numpy(pe), n).numpy(),
            np.asarray(JU.extend_position_embedding(jnp.asarray(pe), n)))
