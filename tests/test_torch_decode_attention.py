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

from test_torch_zero import one_thread  # noqa: F401

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


# ---------------------------------------------------------------------------
# paged (kernel 5), multi-query (kernel 6) and paged multi-query (kernel 7):
# plain versions against the JAX Pallas kernels in interpret mode, fp32 1e-5
# ---------------------------------------------------------------------------

from deepspeed_tpu.ops.pallas.decode_attention import (  # noqa: E402
    decode_attention_multi as jax_decode_multi,
    decode_attention_paged as jax_decode_paged,
    decode_attention_paged_multi as jax_decode_paged_multi,
    paged_gather as jax_paged_gather)
from deepspeed_tpu_torch.inference.quantize import (  # noqa: E402
    quantize_rows)
from deepspeed_tpu_torch.ops.kernels.decode_attention import (  # noqa: E402
    decode_attention_multi, decode_attention_paged,
    decode_attention_paged_multi, paged_gather)

PS, PH, PAGE, MAXP, POOL = 5, 2, 8, 6, 31
#: base lengths: a length-0 slot, one key, a page boundary, mid-page past
#: two boundaries (a 32-key step spans pages), the full table
PLENS = np.asarray([0, 1, 8, 21, MAXP * PAGE], np.int32)


def _paged_case(seed, w=None):
    """A pool with a scattered (permuted) page table: each slot owns the
    pages its longest row needs, the rest of its row points at the
    scratch page 0, whose data (like every unowned page) is garbage."""
    rng = np.random.default_rng(seed)
    pool_k, pool_v = (rng.standard_normal((POOL, PH, PAGE, D)).astype(
        np.float32) for _ in range(2))
    pool_k[0] = pool_v[0] = 1e4             # scratch: never attended
    ids = rng.permutation(np.arange(1, POOL))
    table = np.zeros((PS, MAXP), np.int32)
    lens = PLENS if w is None else PLENS[:, None] + np.arange(w)[None]
    lens = np.minimum(lens, MAXP * PAGE)
    if w is not None:
        lens[0] = 0                          # a length-0 slot
        lens[2, 0] = 3                       # row 0 dead in the live pages 1-2
    nxt = 0
    for s in range(PS):
        need = -(-int(np.max(lens[s])) // PAGE)
        table[s, :need] = ids[nxt:nxt + need]
        nxt += need
    qshape = (PS, PH, D) if w is None else (PS, PH, w, D)
    q = rng.standard_normal(qshape).astype(np.float32)
    return q, pool_k, pool_v, table, lens.astype(np.int32)


def test_paged_plain_matches_jax_pallas_interpret():
    q, pk, pv, table, lens = _paged_case(3)
    ref = jax_decode_paged(*(jnp.asarray(a) for a in (q, pk, pv, table,
                                                      lens)),
                           impl="pallas", interpret=True)
    args = [torch.from_numpy(a) for a in (q, pk, pv, table, lens)]
    out = decode_attention_paged(*args)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    dense = decode_attention_paged(*args, impl="dense")
    np.testing.assert_allclose(dense.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    assert (out[0] == 0).all()               # length 0: exact zeros


def test_paged_plain_never_reads_dead_table_columns():
    """Columns at or past ceil(len / page_len) may hold anything, even an
    id outside the pool: they are never read."""
    q, pk, pv, table, lens = map(torch.from_numpy, _paged_case(4))
    clean = decode_attention_paged(q, pk, pv, table, lens)
    need = (lens.long() + PAGE - 1) // PAGE
    dirty = table.clone()
    for s in range(PS):
        dirty[s, need[s]:] = 10 ** 6
    assert torch.equal(decode_attention_paged(q, pk, pv, dirty, lens), clean)


def test_paged_gather_matches_jax():
    _, pk, _, table, _ = _paged_case(5)
    np.testing.assert_array_equal(
        paged_gather(torch.from_numpy(pk), torch.from_numpy(table)).numpy(),
        np.asarray(jax_paged_gather(jnp.asarray(pk), jnp.asarray(table))))


@pytest.mark.parametrize("w", [1, 5, 9])
def test_multi_plain_matches_jax_pallas_interpret(w):
    """Slot-cache multi-query: the gathered view of the paged case as the
    cache, per-query lengths with a length-0 slot and a row fully masked
    in a block the other rows keep live."""
    q, pk, pv, table, lens = _paged_case(6 + w, w)
    k = np.array(jax_paged_gather(jnp.asarray(pk), jnp.asarray(table)))
    v = np.array(jax_paged_gather(jnp.asarray(pv), jnp.asarray(table)))
    ref = jax_decode_multi(*(jnp.asarray(a) for a in (q, k, v, lens)),
                           impl="pallas", block_k=16, interpret=True)
    args = [torch.from_numpy(a) for a in (q, k, v, lens)]
    out = decode_attention_multi(*args)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    dense = decode_attention_multi(*args, impl="dense")
    np.testing.assert_allclose(dense.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    assert (out[0] == 0).all()
    # each row is the single-query attention over its own length
    single = decode_attention(args[0][:, :, -1], args[1], args[2],
                              args[3][:, -1])
    np.testing.assert_allclose(out[:, :, -1].numpy(), single.numpy(),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("w", [1, 5, 9])
def test_paged_multi_plain_matches_jax_pallas_interpret(w):
    q, pk, pv, table, lens = _paged_case(9 + w, w)
    ref = jax_decode_paged_multi(*(jnp.asarray(a) for a in (q, pk, pv, table,
                                                            lens)),
                                 impl="pallas", interpret=True)
    args = [torch.from_numpy(a) for a in (q, pk, pv, table, lens)]
    out = decode_attention_paged_multi(*args)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    dense = decode_attention_paged_multi(*args, impl="dense")
    np.testing.assert_allclose(dense.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    assert (out[0] == 0).all()
    if w > 1:   # the fully masked row of slot 2 stays finite and exact
        assert torch.isfinite(out).all()


def test_paged_arms_refuse_int8_pool_and_count_no_cpu_launch():
    q, pk, pv, table, lens = map(torch.from_numpy, _paged_case(20))
    counts = (decode_attention_paged.launches,
              decode_attention_multi.launches,
              decode_attention_paged_multi.launches)
    decode_attention_paged(q, pk, pv, table, lens)
    decode_attention_paged_multi(q[:, :, None], pk, pv, table, lens[:, None])
    decode_attention_multi(q[:, :, None], paged_gather(pk, table),
                           paged_gather(pv, table), lens[:, None])
    assert (decode_attention_paged.launches, decode_attention_multi.launches,
            decode_attention_paged_multi.launches) == counts
    # the int8 pool: the plain arms (no launch either) against the dense
    # arm over the same quantized pool
    k8, ks = quantize_rows(pk)
    v8, vs = quantize_rows(pv)
    counts = (decode_attention_paged.launches_int8,
              decode_attention_paged_multi.launches_int8)
    for impl in ("pallas", "dense"):
        one = decode_attention_paged(q, k8, v8, table, lens, impl=impl,
                                     k_scale=ks, v_scale=vs)
        multi = decode_attention_paged_multi(q[:, :, None], k8, v8, table,
                                             lens[:, None], impl=impl,
                                             k_scale=ks, v_scale=vs)
        if impl == "pallas":
            plain = (one, multi)
    np.testing.assert_allclose(plain[0].numpy(), one.numpy(), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(plain[1].numpy(), multi.numpy(), atol=1e-5,
                               rtol=0)
    assert (plain[0][0] == 0).all() and (plain[1][0] == 0).all()
    assert (decode_attention_paged.launches_int8,
            decode_attention_paged_multi.launches_int8) == counts
    scale = torch.ones(POOL, PH, PAGE)
    with pytest.raises(ValueError, match="together"):
        decode_attention_paged(q, pk, pv, table, lens, k_scale=scale)
    with pytest.raises(ValueError, match="impl"):
        decode_attention_paged(q, pk, pv, table, lens, impl="cuda")
