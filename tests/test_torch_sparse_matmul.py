"""Port parity for the standalone block-sparse ops: ``deepspeed_tpu_torch.
ops.sparse_attention.MatMul`` (sdd, dsd, dds, the transpose flags) and
``Softmax`` (scale, both masks) against the JAX package's on the same
numpy inputs, and every case of ``tests/test_sparse_matmul.py`` run on
both packages.

Tolerances: values and gradients of the port within 1e-5 of the JAX ops'
in fp32 (relative, elementwise and of the largest magnitude); against
the dense masked math the JAX test's own bars. Fully masked rows give
zeros in both packages, fp32 and fp16 (where the row-max fill is -inf).
The composition sdd → softmax → dsd equals the port's block-sparse
attention (its plain version on the CPU) and the JAX fused kernel as
``tests/test_sparse_matmul.py`` runs it, within that test's 2e-4.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.sparse_attention import (BigBirdSparsityConfig,
                                                MatMul as JMatMul,
                                                Softmax as JSoftmax)
from deepspeed_tpu_torch.ops.sparse_attention import MatMul, Softmax

from test_torch_zero import one_thread  # noqa: F401

BLK = 16
NB = 8
M = N = K = BLK * NB
TOL = 1e-5


def _layout(seed=0, density=0.4):
    rng = np.random.default_rng(seed)
    lay = (rng.random((NB, NB)) < density)
    lay[np.arange(NB), np.arange(NB)] = True   # keep every row/col alive
    return lay.astype(np.int64)


def _dense_mask(lay):
    return np.kron(lay, np.ones((BLK, BLK))) > 0


def _to_blocks(dense, lay):
    """Dense [., M, N] -> block-COO values in MatMul's row-major order."""
    r, c = np.nonzero(lay)
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    return np.stack([dense[..., i * BLK:(i + 1) * BLK,
                           j * BLK:(j + 1) * BLK]
                     for i, j in zip(r, c)], axis=-3)


def _close(a, b, tol=TOL):
    """Within ``tol`` relative, elementwise and of the largest magnitude
    (an element that cancels to near zero is held to the latter)."""
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(b).max())))


def _both(port_fn, jax_fn, *arrays, weight=None):
    """Each package's output and the gradients of ``sum(out · weight)``
    (a fixed numpy cotangent) with respect to every input."""
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = port_fn(*ts)
    w = np.random.default_rng(99).standard_normal(out.shape).astype(
        np.float32) if weight is None else weight
    (out * torch.from_numpy(w)).sum().backward()
    jout, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in arrays))
    jg = vjp(jnp.asarray(w))
    return (out.detach().numpy(), [t.grad.numpy() for t in ts],
            np.asarray(jout), [np.asarray(g) for g in jg])


def _hold(port_fn, jax_fn, *arrays):
    out, grads, jout, jgrads = _both(port_fn, jax_fn, *arrays)
    _close(out, jout)
    for g, jg in zip(grads, jgrads):
        _close(g, jg)
    return out


# ---------------------------------------------------------------------------
# tests/test_sparse_matmul.py's cases, on both packages
# ---------------------------------------------------------------------------
def test_sdd_matches_dense():
    rng = np.random.default_rng(1)
    lay = _layout()
    a = rng.normal(size=(2, M, K)).astype(np.float32)
    b = rng.normal(size=(2, K, N)).astype(np.float32)
    vals = _hold(MatMul(lay, BLK, "sdd"), JMatMul(lay, BLK, "sdd"), a, b)
    ref = _to_blocks(np.einsum("bmk,bkn->bmn", a, b), lay)
    np.testing.assert_allclose(vals, ref, rtol=2e-5, atol=2e-4)


def test_sdd_transpose_flags():
    rng = np.random.default_rng(2)
    lay = _layout(2)
    a = rng.normal(size=(K, M)).astype(np.float32)   # pre-transposed
    b = rng.normal(size=(N, K)).astype(np.float32)
    vals = _hold(MatMul(lay, BLK, "sdd", trans_a=True, trans_b=True),
                 JMatMul(lay, BLK, "sdd", trans_a=True, trans_b=True), a, b)
    ref = _to_blocks(a.T @ b.T, lay)
    np.testing.assert_allclose(vals, ref, rtol=2e-5, atol=2e-4)


def test_dsd_matches_dense():
    rng = np.random.default_rng(3)
    lay = _layout(3)
    a_dense = rng.normal(size=(2, M, K)).astype(np.float32) * \
        _dense_mask(lay)
    b = rng.normal(size=(2, K, N)).astype(np.float32)
    vals = _to_blocks(a_dense, lay).astype(np.float32)
    out = _hold(MatMul(lay, BLK, "dsd"), JMatMul(lay, BLK, "dsd"), vals, b)
    ref = np.einsum("bmk,bkn->bmn", a_dense, b)
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-4)


def test_dds_matches_dense():
    rng = np.random.default_rng(4)
    lay = _layout(4)
    a = rng.normal(size=(2, M, K)).astype(np.float32)
    b_dense = rng.normal(size=(2, K, N)).astype(np.float32) * \
        _dense_mask(lay)
    vals = _to_blocks(b_dense, lay).astype(np.float32)
    out = _hold(MatMul(lay, BLK, "dds"), JMatMul(lay, BLK, "dds"), a, vals)
    ref = np.einsum("bmk,bkn->bmn", a, b_dense)
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("mode,flags", [("sdd", (False, True)),
                                        ("sdd", (True, False)),
                                        ("dsd", (False, True)),
                                        ("dds", (True, False))])
def test_transpose_flags_on_every_mode(mode, flags):
    """The dense operand's transpose flag in each mode (both of sdd's
    singly), values and gradients against the JAX op."""
    rng = np.random.default_rng(11)
    lay = _layout(11)
    ta, tb = flags
    sparse = _to_blocks(rng.normal(size=(2, M, N)), lay).astype(np.float32)
    dense = rng.normal(size=(2, K, K)).astype(np.float32)
    if mode == "sdd":
        args = (dense, rng.normal(size=(2, K, N)).astype(np.float32))
    elif mode == "dsd":
        args = (sparse, dense)
    else:
        args = (dense, sparse)
    _hold(MatMul(lay, BLK, mode, trans_a=ta, trans_b=tb),
          JMatMul(lay, BLK, mode, trans_a=ta, trans_b=tb), *args)


def test_dsd_and_dds_are_each_others_gradients():
    """Through autograd: dsd's gradient with respect to its dense operand
    is the dds-shaped product of the sparse values with the cotangent,
    and the reverse — checked against the dual op applied by hand."""
    rng = np.random.default_rng(12)
    lay = _layout(12)
    vals = torch.tensor(_to_blocks(rng.normal(size=(M, K)), lay),
                        dtype=torch.float32, requires_grad=True)
    b = torch.tensor(rng.normal(size=(K, N)), dtype=torch.float32,
                     requires_grad=True)
    g = torch.tensor(rng.normal(size=(M, N)), dtype=torch.float32)
    (MatMul(lay, BLK, "dsd")(vals, b) * g).sum().backward()
    # d/db of sum(A_sparse @ b · g) = A_sparseᵀ @ g: dsd over the
    # transposed layout with the transposed blocks
    lay_t = lay.T
    r, c = np.nonzero(lay)                 # row-major: the blocks' order
    by_rc = {(int(i), int(j)): vals.detach().numpy()[n]
             for n, (i, j) in enumerate(zip(r, c))}
    rt, ct = np.nonzero(lay_t)
    blocks_t = np.stack([by_rc[(int(j), int(i))].T
                         for i, j in zip(rt, ct)])
    want_b = MatMul(lay_t, BLK, "dsd")(torch.from_numpy(blocks_t), g)
    _close(b.grad, want_b)
    # d/dvals = the sdd blocks of g @ bᵀ
    want_v = MatMul(lay, BLK, "sdd", trans_b=True)(g, b.detach())
    _close(vals.grad, want_v)


def test_softmax_matches_dense():
    rng = np.random.default_rng(5)
    lay = _layout(5)
    scores = rng.normal(size=(2, M, N)).astype(np.float32)
    mask = _dense_mask(lay)
    vals = _to_blocks(scores, lay).astype(np.float32)
    out = _hold(lambda v: Softmax(lay, BLK)(v, scale=0.5),
                lambda v: JSoftmax(lay, BLK)(v, scale=0.5), vals)
    dense = np.where(mask, scores * 0.5, -1e30)
    p = np.exp(dense - dense.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    np.testing.assert_allclose(out, _to_blocks(p, lay), rtol=2e-5,
                               atol=2e-5)


def test_softmax_key_padding_mask():
    rng = np.random.default_rng(6)
    lay = _layout(6)
    scores = rng.normal(size=(M, N)).astype(np.float32)
    kpm = np.where(rng.random(N) < 0.2, -1e30, 0.0).astype(np.float32)
    vals = _to_blocks(scores, lay).astype(np.float32)
    out = _hold(
        lambda v: Softmax(lay, BLK)(v, key_padding_mask=torch.from_numpy(
            kpm)),
        lambda v: JSoftmax(lay, BLK)(v, key_padding_mask=jnp.asarray(kpm)),
        vals)
    dense = np.where(_dense_mask(lay), scores + kpm[None, :], -1e30)
    p = np.exp(dense - dense.max(-1, keepdims=True))
    s = p.sum(-1, keepdims=True)
    p = p / np.where(s == 0, 1.0, s)
    np.testing.assert_allclose(out, _to_blocks(p, lay), rtol=2e-5,
                               atol=2e-5)


def test_softmax_attn_mask():
    """An additive ``[M, N]`` mask (a causal one, -1e30 above the
    diagonal) with a scale, values and gradients against the JAX op."""
    rng = np.random.default_rng(13)
    lay = _layout(13)
    vals = _to_blocks(rng.normal(size=(2, M, N)), lay).astype(np.float32)
    am = np.where(np.tril(np.ones((M, N))) > 0, 0.0, -1e30).astype(
        np.float32)
    _hold(lambda v: Softmax(lay, BLK)(v, scale=0.25,
                                      attn_mask=torch.from_numpy(am)),
          lambda v: JSoftmax(lay, BLK)(v, scale=0.25,
                                       attn_mask=jnp.asarray(am)), vals)


def test_attention_composition_matches_fused_kernel():
    """sdd → softmax → dsd composed from the standalone ops reproduces
    the port's block-sparse attention (its plain version here) and the
    JAX fused kernel as ``tests/test_sparse_matmul.py`` runs it; the
    port's composition equals the JAX composition within 1e-5, values
    and gradients."""
    from deepspeed_tpu.ops.pallas.block_sparse_attention import (
        block_sparse_attention as jax_bsa)
    from deepspeed_tpu_torch.ops.kernels.block_sparse_attention import (
        block_sparse_attention)
    rng = np.random.default_rng(7)
    H, D = 2, 32
    cfg = BigBirdSparsityConfig(num_heads=H, block=BLK)
    layout3 = np.asarray(cfg.make_layout(M))
    lay = layout3[0]
    q, k, v = (rng.normal(size=(1, H, M, D)).astype(np.float32)
               for _ in range(3))
    sm = 1.0 / np.sqrt(D)

    def compose(mm, smx, q, k, v):
        scores = mm(lay, BLK, "sdd", trans_b=True)(q, k)
        probs = smx(lay, BLK)(scores, scale=sm)
        return mm(lay, BLK, "dsd")(probs, v)

    out = _hold(lambda *a: compose(MatMul, Softmax, *a),
                lambda *a: compose(JMatMul, JSoftmax, *a), q, k, v)
    fused = block_sparse_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), layout3, BLK)
    np.testing.assert_allclose(out, fused.numpy(), rtol=2e-4, atol=2e-4)
    ref = jax_bsa(*(jnp.asarray(a) for a in (q, k, v)), layout3, BLK)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=2e-4, atol=2e-4)


def test_matmul_is_differentiable():
    rng = np.random.default_rng(8)
    lay = _layout(8)
    a = rng.normal(size=(M, K)).astype(np.float32)
    b = rng.normal(size=(K, N)).astype(np.float32)
    ones = np.ones((int(lay.sum()), BLK, BLK), np.float32)
    out, (ga, gb), _, (jga, jgb) = _both(
        lambda x, y: MatMul(lay, BLK, "sdd")(x, y) ** 2,
        lambda x, y: JMatMul(lay, BLK, "sdd")(x, y) ** 2, a, b,
        weight=ones)
    _close(ga, jga)
    _close(gb, jgb)
    # dense reference gradient of sum((A@B * mask)^2)
    c = a @ b * _dense_mask(lay)
    np.testing.assert_allclose(ga, 2 * c @ b.T, rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(gb, 2 * a.T @ c, rtol=2e-4, atol=2e-3)


def test_rejects_per_head_layout_and_bad_mode():
    """The JAX ops' errors with their messages: a 3-D layout that differs
    across heads, a bad mode, a transposed sparse operand, an empty
    layout, and masks of the wrong rank or batch."""
    per_head = np.stack([_layout(1), _layout(9)])
    for cls in (MatMul, JMatMul):
        with pytest.raises(ValueError, match="vmap"):
            cls(per_head, BLK, "sdd")
        with pytest.raises(ValueError, match="mode"):
            cls(_layout(), BLK, "ssd")
        with pytest.raises(ValueError, match="dual mode"):
            cls(_layout(), BLK, "dsd", trans_a=True)
        with pytest.raises(ValueError, match="dual mode"):
            cls(_layout(), BLK, "dds", trans_b=True)
        with pytest.raises(ValueError, match="no active blocks"):
            cls(np.zeros((NB, NB)), BLK, "sdd")
        with pytest.raises(ValueError, match="2-D"):
            cls(np.ones(NB), BLK, "sdd")
    # a head-uniform 3-D layout is taken as its first plane
    assert (MatMul(np.stack([_layout(1)] * 2), BLK, "sdd").layout
            == JMatMul(np.stack([_layout(1)] * 2), BLK, "sdd").layout).all()
    with pytest.raises(ValueError, match="blocks x"):
        MatMul(_layout(), BLK, "sdd")(torch.zeros(M - 1, K),
                                      torch.zeros(K, N))
    vals = torch.zeros(int(_layout().sum()), BLK, BLK)
    with pytest.raises(ValueError, match=r"\[N\] or \[batch, N\]"):
        Softmax(_layout(), BLK)(vals, key_padding_mask=torch.zeros(1, 1, N))
    with pytest.raises(ValueError, match="does not fit"):
        Softmax(_layout(), BLK)(vals, key_padding_mask=torch.zeros(2, N))


def test_softmax_batched_multihead_key_padding_mask():
    """[B, N] masks must hit the batch axis, not the head axis."""
    rng = np.random.default_rng(10)
    B, H = 2, 3
    lay = _layout(10)
    scores = rng.normal(size=(B, H, M, N)).astype(np.float32)
    kpm = np.where(rng.random((B, N)) < 0.2, -1e30, 0.0).astype(np.float32)
    vals = np.stack([np.stack([_to_blocks(scores[b, h], lay)
                               for h in range(H)])
                     for b in range(B)]).astype(np.float32)
    out = _hold(
        lambda v: Softmax(lay, BLK)(v, key_padding_mask=torch.from_numpy(
            kpm)),
        lambda v: JSoftmax(lay, BLK)(v, key_padding_mask=jnp.asarray(kpm)),
        vals)
    dense = np.where(_dense_mask(lay)[None, None], scores
                     + kpm[:, None, None, :], -1e30)
    p = np.exp(dense - dense.max(-1, keepdims=True))
    s = p.sum(-1, keepdims=True)
    p = p / np.where(s == 0, 1.0, s)
    ref = np.stack([np.stack([_to_blocks(p[b, h], lay) for h in range(H)])
                    for b in range(B)])
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_softmax_fully_masked_rows_emit_zeros(dtype):
    """Every key padded with -inf: zeros, not NaN, in both packages — in
    fp16 too, where the -1e30 row-max fill is itself -inf — and zero
    gradients; an unpadded call on the same scores still normalizes and
    its gradients equal the JAX op's."""
    lay = _layout(9 if dtype == "float16" else 8)
    rng = np.random.default_rng(9)
    scores = rng.normal(size=(M, N)).astype(np.float32)
    vals = _to_blocks(scores, lay).astype(dtype)
    kpm = np.full(N, -np.inf, dtype)
    t = torch.tensor(vals, requires_grad=True)
    out = Softmax(lay, BLK)(t, key_padding_mask=torch.from_numpy(kpm))
    jout = np.asarray(JSoftmax(lay, BLK)(jnp.asarray(vals),
                                         key_padding_mask=jnp.asarray(kpm)))
    assert out.dtype == t.dtype
    assert torch.isfinite(out).all() and (out == 0).all()
    assert np.isfinite(jout).all() and (jout == 0).all()
    out.float().sum().backward()
    assert torch.isfinite(t.grad).all() and (t.grad == 0).all()
    live = Softmax(lay, BLK)(torch.from_numpy(vals))
    assert torch.isfinite(live).all() and live.max() > 0
    if dtype == "float32":
        _hold(lambda v: Softmax(lay, BLK)(v),
              lambda v: JSoftmax(lay, BLK)(v), vals)
    else:
        jlive = np.asarray(JSoftmax(lay, BLK)(jnp.asarray(vals)))
        np.testing.assert_allclose(live.float().numpy(),
                                   jlive.astype(np.float32), rtol=2e-3,
                                   atol=2e-3)
