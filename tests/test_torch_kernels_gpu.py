"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``: each test decides inside itself whether a card is
present and skips without one.  Run on a machine with one card
(``--noconftest``: ``tests/conftest.py`` imports jax, which the card's
machine need not have):

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q --noconftest

Tolerances: max abs error 1e-4 in fp32 (same math, other summation
order); 2e-2 in bf16/fp16 (the kernel's output is rounded to the input
type; the plain version runs in fp32 on the same inputs); the int8 pool
arms elementwise within one ulp of the output type at the reference's
magnitude, plus 1e-4.  The bf16/fp16 flash forward, dQ and dK/dV
(tensor-core kernels) are held to the same 2e-2 as every other arm.
"""
import pytest
import torch

from deepspeed_tpu_torch.inference.quantize import quantize_rows
from deepspeed_tpu_torch.ops.kernels.decode_attention import (
    _default_scale, decode_attention, decode_attention_cuda,
    decode_attention_multi, decode_attention_paged,
    decode_attention_paged_multi, decode_attention_plain, decode_multi_cuda,
    decode_multi_plain, decode_paged_cuda, decode_paged_int8_cuda,
    decode_paged_int8_plain, decode_paged_multi_cuda, decode_splits,
    decode_paged_multi_int8_cuda, decode_paged_multi_int8_plain,
    decode_paged_multi_plain, decode_paged_plain)
from deepspeed_tpu_torch.ops.kernels.flash_attention import (
    flash_attention, flash_attention_cuda, flash_attention_plain,
    flash_bwd_dkv, flash_bwd_dkv_cuda, flash_bwd_dkv_plain, flash_bwd_dq,
    flash_bwd_dq_cuda, flash_bwd_dq_plain)

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _randn(dev, *shape, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,t,tk,kv_length", [
    (True, 512, 512, None), (True, 77, 77, None), (True, 130, 130, 100),
    (False, 64, 200, None), (False, 33, 200, 17), (False, 33, 200, 0),
])
def test_flash_kernel_matches_plain(dev, dtype, causal, t, tk, kv_length):
    q = _randn(dev, 2, 3, t, 64, seed=1).to(dtype)
    k = _randn(dev, 2, 3, tk, 64, seed=2).to(dtype)
    v = _randn(dev, 2, 3, tk, 64, seed=3).to(dtype)
    out, lse = flash_attention_cuda(q, k, v, causal, 0.125, kv_length)
    torch.cuda.synchronize()
    ref, ref_lse = flash_attention_plain(q.float(), k.float(), v.float(),
                                         causal, 0.125, kv_length)
    assert out.dtype == dtype
    assert (out.float() - ref).abs().max().item() <= TOL[dtype]
    assert (lse - ref_lse).abs().max().item() <= TOL[dtype]
    if kv_length == 0:
        assert (out == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_matches_plain(dev, dtype):
    S, H, T = 6, 4, 1030
    q = _randn(dev, S, H, 64, seed=4).to(dtype)
    k = _randn(dev, S, H, T, 64, seed=5).to(dtype)
    v = _randn(dev, S, H, T, 64, seed=6).to(dtype)
    lengths = torch.tensor([0, 1, 31, 513, T, 2000], dtype=torch.int32,
                           device=dev)
    out = decode_attention_cuda(q, k, v, lengths, _default_scale(64))
    torch.cuda.synchronize()
    ref = decode_attention_plain(q.float(), k.float(), v.float(), lengths,
                                 _default_scale(64))
    assert (out.float() - ref).abs().max().item() <= TOL[dtype]
    assert (out[0] == 0).all()


def _train_arms(dev, bh, tk, dead_row):
    """kmask [bh, tk] with one all-masked row (and a masked stretch)."""
    km = torch.zeros(bh, tk, device=dev)
    km[1, 5:40] = -1e9
    if dead_row:
        km[bh - 1] = -1e9
    return km


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,t,tk,kv_length,rate,masked", [
    (True, 130, 130, None, 0.1, True), (True, 77, 77, 60, 0.0, True),
    (False, 33, 200, 150, 0.25, True), (True, 256, 256, None, 0.1, False),
    (False, 40, 96, 0, 0.1, False),
])
def test_flash_training_arms_match_plain(dev, dtype, causal, t, tk,
                                         kv_length, rate, masked):
    """The forward with dropout, a key mask (one dead row) and a
    non-trivial bh_affine, then both backward kernels on the same
    arguments, each against its plain version in fp32."""
    q = _randn(dev, 2, 3, t, 64, seed=7).to(dtype)
    k = _randn(dev, 2, 3, tk, 64, seed=8).to(dtype)
    v = _randn(dev, 2, 3, tk, 64, seed=9).to(dtype)
    do = _randn(dev, 2, 3, t, 64, seed=10).to(dtype)
    km = _train_arms(dev, 6, tk, True) if masked else None
    args = (causal, 0.125, kv_length, km, rate, 0xDEADBEEF, (11, 2, 5))
    out, lse = flash_attention_cuda(q, k, v, *args)
    ref, ref_lse = flash_attention_plain(q.float(), k.float(), v.float(),
                                         *args)
    tol = TOL[dtype]
    assert (out.float() - ref).abs().max().item() <= tol
    live = ref_lse < 1e29
    assert torch.equal(lse >= 1e29, ~live)
    if live.any():
        assert (lse[live] - ref_lse[live]).abs().max().item() <= tol
    delta = (do.float() * ref).sum(-1)
    dq = flash_bwd_dq_cuda(q, k, v, do, ref_lse, delta, *args)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, ref_lse, delta, *args)
    torch.cuda.synchronize()
    f = (q.float(), k.float(), v.float(), do.float(), ref_lse, delta)
    rdq = flash_bwd_dq_plain(*f, *args)
    rdk, rdv = flash_bwd_dkv_plain(*f, *args)
    for got, want in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert got.dtype == dtype
        err = (got.float() - want).abs().max().item()
        assert err <= tol * max(1.0, want.abs().max().item()), err
    if masked:  # the all-masked row: exact zeros forward and back
        assert (out.view(6, t, 64)[5] == 0).all()
        assert (dq.view(6, t, 64)[5] == 0).all()
    if kv_length == 0:
        for g in (out, dq, dk, dv):
            assert (g == 0).all()


SWEEP_T = [1, 63, 64, 65, 127, 128, 129, 1024, 2048]
#: (key mask, dropout rate) arms run in every sweep case
SWEEP_ARMS = [(False, 0.0), (True, 0.1), (False, 0.25), (True, 0.0)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", SWEEP_T)
def test_flash_tensor_core_arms_sweep(dev, dtype, causal, t):
    """The tensor-core forward, dQ and dK/dV (bf16, fp16) across tile
    edges: T at and around multiples of the 64-row tile, causal (tq = tk)
    and not (tk = 3T/2 + 5), each with and without a key mask (a masked
    stretch and an all-masked row) and dropout 0, 0.1 and 0.25 under a
    non-trivial bh_affine; against the plain versions in fp32, the
    gradients relative to their largest magnitude."""
    tk = t if causal else (3 * t) // 2 + 5
    q = _randn(dev, 2, 3, t, 64, seed=20).to(dtype)
    k = _randn(dev, 2, 3, tk, 64, seed=21).to(dtype)
    v = _randn(dev, 2, 3, tk, 64, seed=22).to(dtype)
    do = _randn(dev, 2, 3, t, 64, seed=23).to(dtype)
    f32 = (q.float(), k.float(), v.float())
    tol = TOL[dtype]
    for masked, rate in SWEEP_ARMS:
        km = _train_arms(dev, 6, tk, True) if masked else None
        args = (causal, 0.125, None, km, rate, 0x1234567 + t, (3, 2, 7))
        out, lse = flash_attention_cuda(q, k, v, *args)
        torch.cuda.synchronize()
        ref, ref_lse = flash_attention_plain(*f32, *args)
        assert (out.float() - ref).abs().max().item() <= tol
        live = ref_lse < 1e29
        assert torch.equal(lse >= 1e29, ~live)
        if live.any():
            assert (lse[live] - ref_lse[live]).abs().max().item() <= tol
        delta = (do.float() * ref).sum(-1)
        dq = flash_bwd_dq_cuda(q, k, v, do, ref_lse, delta, *args)
        dk, dv = flash_bwd_dkv_cuda(q, k, v, do, ref_lse, delta, *args)
        torch.cuda.synchronize()
        plain = (*f32, do.float(), ref_lse, delta, *args)
        rdq = flash_bwd_dq_plain(*plain)
        rdk, rdv = flash_bwd_dkv_plain(*plain)
        for name, got, want in (("dq", dq, rdq), ("dk", dk, rdk),
                                ("dv", dv, rdv)):
            err = (got.float() - want).abs().max().item()
            assert err <= tol * max(1.0, want.abs().max().item()), (
                name, masked, rate, err)
        if masked:  # the all-masked row: exact zeros forward and back;
            # the masked stretch's keys: exact-zero dK/dV
            assert (out.view(6, t, 64)[5] == 0).all()
            assert (dq.view(6, t, 64)[5] == 0).all()
            for g in (dk.view(6, tk, 64), dv.view(6, tk, 64)):
                assert (g[5] == 0).all() and (g[1, 5:40] == 0).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal,t", [(True, 200), (False, 129)])
def test_flash_autograd_dropout_matches_plain(dev, dtype, causal, t):
    """The gradients of ``flash_attention`` at dropout 0.1 (the forward,
    dQ and dK/dV kernels, all three on the tensor cores) against autograd
    through the plain forward on the same seed: equal only if every
    kernel hashes the same keep mask at the same (q, k) positions."""
    q, k, v, do = (_randn(dev, 2, 2, t, 64, seed=30 + i).to(dtype)
                   for i in range(4))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = flash_attention(*leaves, causal=causal, dropout_rate=0.1,
                          dropout_seed=777)
    grads = torch.autograd.grad(out, leaves, do)
    ref_leaves = [x.float().requires_grad_(True) for x in (q, k, v)]
    ref, _ = flash_attention_plain(*ref_leaves, causal, 0.125,
                                   dropout_rate=0.1, seed=777)
    ref_grads = torch.autograd.grad(ref, ref_leaves, do.float())
    tol = TOL[dtype]
    assert (out.float() - ref).abs().max().item() <= tol
    for got, want in zip(grads, ref_grads):
        err = (got.float() - want).abs().max().item()
        assert err <= tol * max(1.0, want.abs().max().item()), err


def test_flash_misaligned_pointer_raises(dev):
    """The bf16/fp16 kernels load by TMA, which needs 16-byte aligned
    bases: a contiguous view two bytes into its storage raises."""
    n = 2 * 64 * 64
    buf = _randn(dev, 4 * n + 8).bfloat16()
    q, k, v, do = (buf[1 + i * n:1 + (i + 1) * n].view(1, 2, 64, 64)
                   for i in range(4))
    assert q.is_contiguous() and q.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_cuda(q, k, v, True, 0.125)
    good = [x.clone() for x in (q, k, v)]
    out, lse = flash_attention_cuda(*good, True, 0.125)
    delta = (out.float() * out.float()).sum(-1)
    with pytest.raises(ValueError, match="16-byte"):
        flash_bwd_dq_cuda(*good[:3], do, lse, delta, True, 0.125)
    with pytest.raises(ValueError, match="16-byte"):
        flash_bwd_dkv_cuda(*good[:3], do, lse, delta, True, 0.125)


def test_public_entry_points_launch_or_raise(dev):
    q = _randn(dev, 1, 2, 16, 64).bfloat16()
    before = flash_attention.launches
    flash_attention(q, q, q)
    assert flash_attention.launches == before + 1
    counts = (flash_attention.launches, flash_bwd_dq.launches,
              flash_bwd_dkv.launches)
    qr = q.clone().requires_grad_(True)
    flash_attention(qr, q, q, dropout_rate=0.1, dropout_seed=1,
                    key_mask=torch.ones(1, 16, dtype=torch.bool,
                                        device=dev)).sum().backward()
    assert (flash_attention.launches, flash_bwd_dq.launches,
            flash_bwd_dkv.launches) == tuple(c + 1 for c in counts)
    with pytest.raises(ValueError, match="shapes"):
        flash_attention(q[..., :32], q[..., :32], q[..., :32])
    kc = _randn(dev, 2, 2, 8, 64)
    lengths = torch.tensor([3, 8], device=dev)
    before = decode_attention.launches
    decode_attention(kc[:, :, 0], kc, kc, lengths)
    assert decode_attention.launches == before + 1
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention_cuda(kc[:, :, 0], kc, kc,
                              lengths.to(torch.int32), 0.125)


def _paged(dev, dtype, page_len, w):
    """Five slots over a scattered page pool: a length-0 slot, one key, a
    page boundary, lengths ending mid-page past several boundaries, the
    full table; W rows at L + i + 1 with one row that is masked in pages
    the others keep live.  Unowned pages and the scratch page 0 hold
    huge garbage; dead table columns hold an id past the pool."""
    S, H, M, P = 5, 3, 9, 60
    base = torch.tensor([0, 1, page_len, 3 * page_len + 5, M * page_len - w],
                        device=dev)
    lens = base[:, None] + torch.arange(1, w + 1, device=dev)[None]
    lens = torch.where(base[:, None] > 0, lens, 0)
    if w > 1:
        lens[3, 0] = 2                   # dead in the slot's later pages
    lens = lens.clamp(max=M * page_len).to(torch.int32)
    g = torch.Generator().manual_seed(page_len + w)
    pool = [torch.randn(P, H, page_len, 64, generator=g).to(dev)
            for _ in range(2)]
    for t in pool:
        t[0] = 1e4
    ids = (torch.randperm(P - 1, generator=g) + 1).tolist()
    table = torch.full((S, M), 10 ** 6, dtype=torch.int32)
    need = ((lens.amax(1).cpu() + page_len - 1) // page_len).tolist()
    nxt = 0
    for s_, n in enumerate(need):
        table[s_, :n] = torch.tensor(ids[nxt:nxt + n], dtype=torch.int32)
        nxt += n
    q = _randn(dev, S, H, w, 64, seed=11).to(dtype)
    return (q, pool[0].to(dtype), pool[1].to(dtype), table.to(dev),
            lens.contiguous())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("page_len", [7, 16])
@pytest.mark.parametrize("w", [1, 5, 9])
def test_paged_kernels_match_plain(dev, dtype, page_len, w):
    """decode_paged (W = 1) and decode_paged_multi against their plain
    versions: key steps crossing pages, scratch and never-read table
    entries, a length-0 slot (exact zeros), a row masked in a live page."""
    q, kp, vp, table, lens = _paged(dev, dtype, page_len, w)
    f32 = (q.float(), kp.float(), vp.float(), table, lens)
    scale = _default_scale(64)
    out = decode_paged_multi_cuda(q, kp, vp, table, lens, scale)
    torch.cuda.synchronize()
    ref = decode_paged_multi_plain(*f32, scale)
    assert out.dtype == dtype and torch.isfinite(out).all()
    assert (out.float() - ref).abs().max().item() <= TOL[dtype]
    assert (out[0] == 0).all()
    if w == 1:
        one = decode_paged_cuda(q[:, :, 0].contiguous(), kp, vp, table,
                                lens[:, 0].contiguous(), scale)
        torch.cuda.synchronize()
        ref1 = decode_paged_plain(q[:, :, 0].float(), kp.float(), vp.float(),
                                  table, lens[:, 0], scale)
        assert (one.float() - ref1).abs().max().item() <= TOL[dtype]
        assert (one[0] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("w", [1, 5, 9])
def test_multi_kernel_matches_plain(dev, dtype, w):
    """decode_multi over the slot cache the pool stands for."""
    q, kp, vp, table, lens = _paged(dev, dtype, 16, w)
    from deepspeed_tpu_torch.ops.kernels.decode_attention import (
        _live_table, paged_gather)
    live = _live_table(table, lens, 16)
    k, v = paged_gather(kp, live), paged_gather(vp, live)
    scale = _default_scale(64)
    out = decode_multi_cuda(q, k, v, lens, scale)
    torch.cuda.synchronize()
    ref = decode_multi_plain(q.float(), k.float(), v.float(), lens, scale)
    assert (out.float() - ref).abs().max().item() <= TOL[dtype]
    assert (out[0] == 0).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("t", [64, 300, 1000, 1024, 2048])
@pytest.mark.parametrize("w", range(2, 10))
def test_multi_split_kernel_sweep(dev, dtype, t, w):
    """decode_multi's bf16/fp16 arm (each (slot, head)'s keys split over a
    cluster of ceil(T / 256) <= 8 CUDA blocks) against its plain version:
    S x H = 5 x 7; T of one tile (1 split), of two splits with a short
    last one, ragged (1000: the last tile is cut), whole (4 splits) and
    2048 (a cluster of 8); a length-0 slot (exact zeros), one key, a row
    ending on a tile boundary, the full cache, and a row dead in the tiles
    the slot's other rows keep live."""
    S, H = 5, 7
    assert decode_splits(t) == min(8, max(1, -(-t // 256)))
    base = torch.tensor([0, 1, min(64, t - w), t - w, (3 * t) // 5 - w],
                        device=dev)
    lens = base[:, None] + torch.arange(1, w + 1, device=dev)[None]
    lens = torch.where(base[:, None] > 0, lens, 0)
    lens[2, 0] = 64                      # ends on a tile boundary
    lens[4, 1] = 2                       # dead past the first tile
    lens = lens.clamp(max=t).to(torch.int32).contiguous()
    q = _randn(dev, S, H, w, 64, seed=30 + w).to(dtype)
    k, v = (_randn(dev, S, H, t, 64, seed=40 + i).to(dtype) for i in range(2))
    scale = _default_scale(64)
    out = decode_multi_cuda(q, k, v, lens, scale)
    torch.cuda.synchronize()
    ref = decode_multi_plain(q.float(), k.float(), v.float(), lens, scale)
    assert out.dtype == dtype and torch.isfinite(out).all()
    err = (out.float() - ref).abs().max().item()
    assert err <= TOL[dtype], err
    assert (out[0] == 0).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("t", [17, 64, 300, 1000, 1024, 2048])
def test_single_split_kernel_sweep(dev, dtype, t):
    """decode_attention's bf16/fp16 arm (decode_multi's split kernel at
    W = 1) against its plain version: S x H = 5 x 7; T below one tile, of
    one tile (1 split), ragged (300: two splits, the last tile cut; 1000),
    whole (4 splits) and 2048 (a cluster of 8); a length-0 slot (exact
    zeros), one key, a tile boundary, a length above T (clamped) and one
    ending inside a split.  Every row at or past a slot's length holds NaN
    in K and V: the kernel must not let one reach the output."""
    S, H = 5, 7
    lens = torch.tensor([0, 1, min(64, t), 2 * t + 5, (3 * t) // 5],
                        dtype=torch.int32, device=dev)
    q = _randn(dev, S, H, 64, seed=50).to(dtype)
    k, v = (_randn(dev, S, H, t, 64, seed=51 + i).to(dtype) for i in range(2))
    dead = (torch.arange(t, device=dev)[None, :]
            >= lens.clamp(max=t)[:, None])[:, None, :, None]
    scale = _default_scale(64)
    out = decode_attention_cuda(q, k.masked_fill(dead, float("nan")),
                                v.masked_fill(dead, float("nan")), lens,
                                scale)
    torch.cuda.synchronize()
    ref = decode_attention_plain(q.float(), k.float(), v.float(), lens, scale)
    assert out.dtype == dtype and torch.isfinite(out).all()
    err = (out.float() - ref).abs().max().item()
    assert err <= TOL[dtype], err
    assert (out[0] == 0).all()


def _paged_int8(dev, dtype, page_len, w):
    """``_paged``'s pools quantized by the port's ``quantize_rows``, with
    every (page, row) no live row reads (the scratch page 0 included) set
    to random bytes and NaN scales, so a stray read shows."""
    q, kp, vp, table, lens = _paged(dev, torch.float32, page_len, w)
    P = kp.shape[0]
    live = torch.zeros(P, page_len, dtype=torch.bool)
    for s_, n in enumerate(lens.amax(1).tolist()):
        for p in range(n):
            live[int(table[s_, p // page_len]), p % page_len] = True
    dead = (~live).to(dev)
    g = torch.Generator().manual_seed(page_len * 10 + w)
    out = []
    for pool in (kp, vp):
        q8, sc = quantize_rows(pool)
        junk = torch.randint(-128, 128, q8.shape, generator=g,
                             dtype=torch.int8).to(dev)
        q8 = torch.where(dead[:, None, :, None], junk, q8)
        sc = torch.where(dead[:, None, :], float("nan"), sc)
        out += [q8.contiguous(), sc.contiguous()]
    k8, ks, v8, vs = out
    return q.to(dtype), k8, v8, ks, vs, table, lens


#: one unit in the last place, relative, of each 16-bit output type
ULP = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7,
       torch.float16: 2.0 ** -10}


def _within_ulp(out, ref) -> bool:
    """Every element within one ulp of the output type at the reference's
    magnitude, plus the fp32 tolerance: the kernel rounds its fp32 result
    once into that type (fp32: the absolute 1e-4)."""
    tol = ref.abs() * ULP[out.dtype] + TOL[torch.float32]
    return bool(((out.float() - ref).abs() <= tol).all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("page_len", [7, 16])
@pytest.mark.parametrize("w", [1, 5, 9])
def test_int8_paged_kernels_match_plain(dev, dtype, page_len, w):
    """The int8 pool arms of decode_paged (W = 1) and decode_paged_multi
    against their plain versions (the live pages dequantized, then the
    plain attention): q in fp32, bf16 or fp16, garbage bytes and NaN
    scales wherever no live row reads, a length-0 slot (exact zeros)."""
    q, k8, v8, ks, vs, table, lens = _paged_int8(dev, dtype, page_len, w)
    scale = _default_scale(64)
    out = decode_paged_multi_int8_cuda(q, k8, v8, ks, vs, table, lens,
                                       scale)
    torch.cuda.synchronize()
    ref = decode_paged_multi_int8_plain(q.float(), k8, v8, ks, vs, table,
                                        lens, scale)
    assert out.dtype == dtype and torch.isfinite(out).all()
    assert _within_ulp(out, ref)
    assert (out[0] == 0).all()
    if w == 1:
        one = decode_paged_int8_cuda(q[:, :, 0].contiguous(), k8, v8, ks,
                                     vs, table, lens[:, 0].contiguous(),
                                     scale)
        torch.cuda.synchronize()
        ref1 = decode_paged_int8_plain(q[:, :, 0].float(), k8, v8, ks, vs,
                                       table, lens[:, 0], scale)
        assert torch.isfinite(one).all() and (one[0] == 0).all()
        assert _within_ulp(one, ref1)


def _paged_sweep_case(dev, dtype, t, page_len, w, pool, slots=5, heads=3):
    """``slots`` x ``heads`` (5 x 3) slots over a pool of ceil(t /
    page_len) pages a slot: a length-0 slot, one key, a row ending on a
    tile boundary (64), the full capacity, and rows at three fifths of it,
    any further slot at its share of the capacity; W rows at L + i + 1 with
    one row dead past its second key.  Each slot's live pages sit at
    permuted ids; every other page (the scratch page 0 included) holds
    garbage, and every dead table column an id past the pool.  ``pool``
    'int8' quantizes the pools with the port's ``quantize_rows`` and puts
    random bytes and NaN scales in every row no live row reads."""
    S, H = slots, heads
    M = -(-t // page_len)
    cap = M * page_len
    base = torch.tensor([0, 1, min(64, cap - w), cap - w, (3 * cap) // 5 - w]
                        + [max(1, i * cap // S - w) for i in range(5, S)])
    lens = base[:, None] + torch.arange(1, w + 1)[None]
    lens = torch.where(base[:, None] > 0, lens, 0)
    lens[2, 0] = 64
    if w > 1:
        lens[4, 1] = 2
    lens = lens.clamp(max=cap).to(torch.int32)
    need = ((lens.amax(1) + page_len - 1) // page_len).tolist()
    P = sum(need) + 2
    g = torch.Generator().manual_seed(1000 * page_len + 10 * w + t)
    ids = (torch.randperm(P - 1, generator=g) + 1).tolist()
    table = torch.full((S, M), 10 ** 6, dtype=torch.int32)
    live = torch.zeros(P, page_len, dtype=torch.bool)
    nxt = 0
    for s_, n in enumerate(need):
        table[s_, :n] = torch.tensor(ids[nxt:nxt + n], dtype=torch.int32)
        nxt += n
        pos = torch.arange(int(lens[s_].max()))
        live[table[s_, pos // page_len].long(), pos % page_len] = True
    pools = [torch.randn(P, H, page_len, 64, generator=g) for _ in range(2)]
    q = torch.randn(S, H, w, 64, generator=g).to(dev, dtype)
    table, lens = table.to(dev), lens.to(dev).contiguous()
    if pool == "fp":
        kp, vp = (torch.where(live[:, None, :, None], x, 1e4).to(dev, dtype)
                  for x in pools)
        return q, (kp, vp), table, lens
    dead = ~live
    out = []
    for x in pools:
        q8, sc = quantize_rows(x)
        junk = torch.randint(-128, 128, q8.shape, generator=g,
                             dtype=torch.int8)
        q8 = torch.where(dead[:, None, :, None], junk, q8)
        sc = torch.where(dead[:, None, :], float("nan"), sc)
        out += [q8.to(dev).contiguous(), sc.to(dev).contiguous()]
    k8, ks, v8, vs = out
    return q, (k8, v8, ks, vs), table, lens


@pytest.mark.parametrize("pool", ["fp", "int8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("t", [64, 300, 1024, 4096])
@pytest.mark.parametrize("page_len", [7, 16, 128])
@pytest.mark.parametrize("w", [1, 5, 9])
def test_paged_split_kernel_sweep(dev, pool, dtype, t, page_len, w):
    """The bf16/fp16 arms of decode_paged_multi and (W = 1) decode_paged,
    both pools (each (slot, head)'s keys split over a cluster of
    ceil(T / 256) <= 8 CUDA blocks, read through the page table), against
    their plain versions: TOL for the fp pool, one ulp + 1e-4 elementwise
    for the int8 pool; exact zeros for the length-0 slot; finite output
    with dead table columns past the pool (never dereferenced)."""
    q, pools, table, lens = _paged_sweep_case(dev, dtype, t, page_len, w,
                                              pool)
    S, H, M = q.shape[0], q.shape[1], table.shape[1]
    assert decode_splits(M * page_len, S * H) == min(
        8, max(1, -(-(M * page_len) // 256)))
    scale = _default_scale(64)
    if pool == "fp":
        kp, vp = pools
        calls = [(decode_paged_multi_cuda, decode_paged_multi_plain, q, lens)]
        if w == 1:
            calls.append((decode_paged_cuda, decode_paged_plain,
                          q[:, :, 0].contiguous(), lens[:, 0].contiguous()))
        for cuda, plain, qq, ll in calls:
            out = cuda(qq, kp, vp, table, ll, scale)
            torch.cuda.synchronize()
            ref = plain(qq.float(), kp.float(), vp.float(), table, ll, scale)
            assert out.dtype == dtype and torch.isfinite(out).all()
            err = (out.float() - ref).abs().max().item()
            assert err <= TOL[dtype], (cuda.__name__, err)
            assert (out[0] == 0).all()
        return
    k8, v8, ks, vs = pools
    calls = [(decode_paged_multi_int8_cuda, decode_paged_multi_int8_plain, q,
              lens)]
    if w == 1:
        calls.append((decode_paged_int8_cuda, decode_paged_int8_plain,
                      q[:, :, 0].contiguous(), lens[:, 0].contiguous()))
    for cuda, plain, qq, ll in calls:
        out = cuda(qq, k8, v8, ks, vs, table, ll, scale)
        torch.cuda.synchronize()
        ref = plain(qq.float(), k8, v8, ks, vs, table, ll, scale)
        assert out.dtype == dtype and torch.isfinite(out).all()
        assert _within_ulp(out, ref), (cuda.__name__, (
            out.float() - ref).abs().max().item())
        assert (out[0] == 0).all()


@pytest.mark.parametrize("pool", ["fp", "int8"])
@pytest.mark.parametrize("t", [700, 2048])
def test_split_count_capped_at_the_serving_pairs(dev, pool, t):
    """At the serving pair count (8 slots x 12 heads) the split count is
    ceil(T / 256) cut to four blocks an SM: clusters of 3 at T 700 and of
    5, not 8, at T 2048 on 132 SMs.  The slot map (decode_multi, W 5, fp
    pool) and the page-table map (decode_paged_multi W 5, decode_paged
    W 1) at those cluster sizes, bf16, against their plain versions."""
    S, H, page_len = 8, 12, 16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    t_max = -(-t // page_len) * page_len
    n = min(8, -(-t_max // 256), 4 * sms // (S * H))
    assert decode_splits(t_max, S * H) == n
    if sms == 132:
        assert n == {700: 3, 2048: 5}[t]
    scale = _default_scale(64)
    if pool == "fp":
        w = 5
        base = torch.tensor([0, 1, 64, t - w, t // 3, 2 * t // 3, 7, t // 2],
                            device=dev)[:, None]
        lens = base + torch.arange(1, w + 1, device=dev)[None]
        lens = torch.where(base > 0, lens, 0).to(torch.int32).contiguous()
        q = _randn(dev, S, H, w, 64, seed=60).bfloat16()
        k, v = (_randn(dev, S, H, t, 64, seed=61 + i).bfloat16()
                for i in range(2))
        out = decode_multi_cuda(q, k, v, lens, scale)
        torch.cuda.synchronize()
        ref = decode_multi_plain(q.float(), k.float(), v.float(), lens, scale)
        assert torch.isfinite(out).all()
        assert (out.float() - ref).abs().max().item() <= TOL[torch.bfloat16]
        assert (out[0] == 0).all()
    for w in (1, 5):
        q, pools, table, lens = _paged_sweep_case(
            dev, torch.bfloat16, t, page_len, w, pool, slots=S, heads=H)
        if w == 1:
            q, lens = q[:, :, 0].contiguous(), lens[:, 0].contiguous()
        if pool == "fp":
            kp, vp = pools
            cuda, plain = ((decode_paged_cuda, decode_paged_plain) if w == 1
                           else (decode_paged_multi_cuda,
                                 decode_paged_multi_plain))
            out = cuda(q, kp, vp, table, lens, scale)
            torch.cuda.synchronize()
            ref = plain(q.float(), kp.float(), vp.float(), table, lens, scale)
            assert torch.isfinite(out).all()
            err = (out.float() - ref).abs().max().item()
            assert err <= TOL[torch.bfloat16], (cuda.__name__, err)
        else:
            k8, v8, ks, vs = pools
            cuda, plain = ((decode_paged_int8_cuda, decode_paged_int8_plain)
                           if w == 1 else (decode_paged_multi_int8_cuda,
                                           decode_paged_multi_int8_plain))
            out = cuda(q, k8, v8, ks, vs, table, lens, scale)
            torch.cuda.synchronize()
            ref = plain(q.float(), k8, v8, ks, vs, table, lens, scale)
            assert torch.isfinite(out).all()
            assert _within_ulp(out, ref), (cuda.__name__, (
                out.float() - ref).abs().max().item())
        assert (out[0] == 0).all()


def test_paged_split_count_follows_the_grid(dev):
    """At the capacity leg's width (64 slots x 12 heads, T 1024, rows of at
    most 3 pages) the slots alone fill the card: one CUDA block a (slot,
    head), and the kernel still matches its plain version; at the serving
    width (8 x 12) the keys split four ways."""
    assert decode_splits(1024, 8 * 12) == 4
    assert decode_splits(1024, 64 * 12) == 1
    assert decode_splits(1024, 8 * 12) == 4
    S, H, L, M = 64, 12, 16, 64
    g = torch.Generator().manual_seed(5)
    lens = torch.randint(1, 3 * L + 1, (S,), generator=g, dtype=torch.int32)
    table = torch.zeros(S, M, dtype=torch.int32)
    table[:, :3] = torch.arange(1, 3 * S + 1, dtype=torch.int32).view(S, 3)
    kp, vp = (torch.randn(3 * S + 1, H, L, 64, generator=g).to(
        dev, torch.bfloat16) for _ in range(2))
    q = torch.randn(S, H, 64, generator=g).to(dev, torch.bfloat16)
    table, lens = table.to(dev), lens.to(dev)
    scale = _default_scale(64)
    out = decode_paged_cuda(q, kp, vp, table, lens, scale)
    torch.cuda.synchronize()
    ref = decode_paged_plain(q.float(), kp.float(), vp.float(), table, lens,
                             scale)
    assert (out.float() - ref).abs().max().item() <= TOL[torch.bfloat16]


@pytest.mark.parametrize("pool", ["fp", "int8"])
def test_paged_split_long_table_opts_into_more_shared_memory(dev, pool):
    """page_len 1, T 4096 over 44 x 12 pairs: one CUDA block a (slot,
    head) whose 4096 table columns take more than 48 KB of shared memory
    with the ring, so the launch raises the kernel's limit first."""
    S, H, M = 44, 12, 4096
    assert decode_splits(M, S * H) == 1
    g = torch.Generator().manual_seed(7)
    lens = torch.randint(0, 300, (S,), generator=g, dtype=torch.int32)
    lens[:3] = torch.tensor([M, M - 1, 2049], dtype=torch.int32)
    P = int(lens.sum()) + 1
    table = torch.zeros((S, M), dtype=torch.int32)
    nxt = 1
    for s_, n in enumerate(lens.tolist()):
        table[s_, :n] = torch.arange(nxt, nxt + n, dtype=torch.int32)
        nxt += n
    x = [torch.randn(P, H, 1, 64, generator=g) for _ in range(2)]
    q = torch.randn(S, H, 64, generator=g).to(dev, torch.bfloat16)
    table, lens = table.to(dev), lens.to(dev)
    scale = _default_scale(64)
    if pool == "fp":
        kp, vp = (t.to(dev, torch.bfloat16) for t in x)
        out = decode_paged_cuda(q, kp, vp, table, lens, scale)
        torch.cuda.synchronize()
        ref = decode_paged_plain(q.float(), kp.float(), vp.float(), table,
                                 lens, scale)
        assert (out.float() - ref).abs().max().item() <= TOL[torch.bfloat16]
        return
    (k8, ks), (v8, vs) = (tuple(t.to(dev).contiguous()
                                for t in quantize_rows(t)) for t in x)
    out = decode_paged_int8_cuda(q, k8, v8, ks, vs, table, lens, scale)
    torch.cuda.synchronize()
    ref = decode_paged_int8_plain(q.float(), k8, v8, ks, vs, table, lens,
                                  scale)
    assert torch.isfinite(out).all() and _within_ulp(out, ref)


def test_int8_entry_points_launch_or_raise(dev):
    """On CUDA tensors the int8 pool goes to the int8 kernels (their own
    counts move, the fp arms' do not) or raises."""
    q, k8, v8, ks, vs, table, lens = _paged_int8(dev, torch.bfloat16, 16, 5)
    fp = (decode_attention_paged.launches,
          decode_attention_paged_multi.launches)
    i8 = (decode_attention_paged.launches_int8,
          decode_attention_paged_multi.launches_int8)
    decode_attention_paged(q[:, :, 0], k8, v8, table, lens[:, 0],
                           k_scale=ks, v_scale=vs)
    decode_attention_paged_multi(q, k8, v8, table, lens, k_scale=ks,
                                 v_scale=vs)
    assert (decode_attention_paged.launches,
            decode_attention_paged_multi.launches) == fp
    assert (decode_attention_paged.launches_int8,
            decode_attention_paged_multi.launches_int8) == tuple(
                c + 1 for c in i8)
    with pytest.raises(TypeError, match="float32"):
        decode_paged_int8_cuda(q[:, :, 0].contiguous(), k8, v8, ks.half(),
                               vs, table, lens[:, 0].contiguous(), 0.125)
    with pytest.raises(ValueError, match="shapes"):
        decode_paged_multi_int8_cuda(q, k8, v8, ks[:, :, :8].contiguous(),
                                     vs, table, lens, 0.125)


def test_decode_entry_points_launch_or_raise(dev):
    q, kp, vp, table, lens = _paged(dev, torch.bfloat16, 16, 5)
    counts = (decode_attention_paged.launches,
              decode_attention_multi.launches,
              decode_attention_paged_multi.launches)
    decode_attention_paged(q[:, :, 0], kp, vp, table, lens[:, 0])
    decode_attention_paged_multi(q, kp, vp, table, lens)
    kc = torch.zeros(5, 3, 32, 64, device=dev, dtype=torch.bfloat16)
    decode_attention_multi(q, kc, kc, lens.clamp(max=32))
    assert (decode_attention_paged.launches, decode_attention_multi.launches,
            decode_attention_paged_multi.launches) == tuple(
                c + 1 for c in counts)
    with pytest.raises(ValueError, match="shapes"):   # W > 9
        decode_attention_multi(q.repeat(1, 1, 2, 1), kc, kc,
                               lens.repeat(1, 2).clamp(max=32))
    with pytest.raises(TypeError, match="dtype"):
        decode_attention_paged_multi(q.float(), kp, vp, table, lens)


def _sparse_layout(kind, H, T, block):
    """A head-uniform Fixed layout (``fixed``; ``fixed_default`` with
    FixedSparsityConfig's defaults, the sparse phase's layout), a per-head
    BigBird layout, or Fixed with query block row 1 and key block column
    2 emptied (block 128: the only row/column 1 of 2)."""
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BigBirdSparsityConfig, FixedSparsityConfig)
    if kind == "per_head":
        return BigBirdSparsityConfig(H, block=block, num_random_blocks=1,
                                     different_layout_per_head=True,
                                     seed=block).make_layout(T)
    if kind == "fixed_default":
        return FixedSparsityConfig(H, block=block).make_layout(T)
    layout = FixedSparsityConfig(H, block=block,
                                 num_local_blocks=2).make_layout(T)
    if kind == "empty":
        nb = T // block
        layout[:, 1 % nb, :] = 0
        layout[:, :, min(2, nb - 1)] = 0
    return layout


def _sparse_tables(bs, layout, block, dev):
    """The four LUT arrays and the group tables, on ``dev``."""
    host = bs.build_kernel_luts(layout)
    groups = bs.build_group_luts(*host, block)
    return bs.device_luts(host, dev), bs.GroupLuts(*bs.device_luts(groups,
                                                                   dev))


#: (kind, block, B, H, T): the three layouts at every block at [2, 4, 512];
#: the sparse phase's Fixed layout at one batch row of T 4096 (64 heavy
#: global columns); a per-head BigBird layout at T 2048 (the rows of one
#: group differ, so unions and member masks are exercised)
SPARSE_CASES = [(kind, block, 2, 4, 512)
                for kind in ("fixed", "per_head", "empty")
                for block in (16, 32, 64, 128)] + [
    ("fixed_default", 16, 1, 4, 4096), ("per_head", 16, 2, 8, 2048)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,block,B,H,T", SPARSE_CASES)
def test_block_sparse_kernels_match_plain(dev, dtype, kind, block, B, H, T):
    """The forward (O, lse), dQ and dK/dV kernels against their plain
    versions in fp32 on the same inputs; gradients relative to their
    largest magnitude; empty rows and columns exact zeros."""
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bs
    layout = _sparse_layout(kind, H, T, block)
    (cols, nvalid, rows_t, nvalid_t), groups = _sparse_tables(bs, layout,
                                                              block, dev)
    q, k, v, do = (_randn(dev, B, H, T, 64, seed=20 + i).to(dtype)
                   for i in range(4))
    f32 = (q.float(), k.float(), v.float())
    out, lse = bs.block_sparse_fwd_cuda(q, k, v, cols, nvalid, 0.125, block,
                                        groups)
    torch.cuda.synchronize()
    ref, ref_lse = bs.block_sparse_fwd_plain(*f32, cols, nvalid, 0.125,
                                             block)
    tol = TOL[dtype]
    assert out.dtype == dtype and torch.isfinite(out).all()
    assert (out.float() - ref).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= tol
    delta = (do.float() * ref).sum(-1)
    dq = bs.block_sparse_bwd_dq_cuda(q, k, v, do, ref_lse, delta, cols,
                                     nvalid, 0.125, block, groups)
    dk, dv = bs.block_sparse_bwd_dkv_cuda(q, k, v, do, ref_lse, delta,
                                          rows_t, nvalid_t, 0.125, block,
                                          groups)
    torch.cuda.synchronize()
    plain = (*f32, do.float(), ref_lse, delta)
    rdq = bs.block_sparse_bwd_dq_plain(*plain, cols, nvalid, 0.125, block)
    rdk, rdv = bs.block_sparse_bwd_dkv_plain(*plain, rows_t, nvalid_t,
                                             0.125, block)
    for got, want in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert got.dtype == dtype and torch.isfinite(got).all()
        err = (got.float() - want).abs().max().item()
        assert err <= tol * max(1.0, want.abs().max().item()), err
    if kind == "empty":
        nb = T // block
        r, c = 1 % nb, min(2, nb - 1)
        rows = slice(r * block, (r + 1) * block)
        keys = slice(c * block, (c + 1) * block)
        assert (out[:, :, rows] == 0).all() and (dq[:, :, rows] == 0).all()
        assert (lse[:, :, rows] == -1e30).all()
        assert (dk[:, :, keys] == 0).all() and (dv[:, :, keys] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_block_sparse_cuda_calls_without_group_tables_raise(dev, dtype):
    """The forward, dQ and dK/dV kernels walk the group tables: a CUDA
    call without them raises (it never builds them from device tensors)
    and launches nothing."""
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bs
    layout = _sparse_layout("fixed", 4, 128, 16)
    (cols, nvalid, rows_t, nvalid_t), _ = _sparse_tables(bs, layout, 16, dev)
    x = _randn(dev, 2, 4, 128, 64).to(dtype)
    stat = torch.zeros(2, 4, 128, device=dev)
    counts = (bs.block_sparse_fwd.launches, bs.block_sparse_bwd_dq.launches,
              bs.block_sparse_bwd_dkv.launches)
    with pytest.raises(ValueError, match="group"):
        bs.block_sparse_fwd_cuda(x, x, x, cols, nvalid, 0.125, 16)
    with pytest.raises(ValueError, match="group"):
        bs.block_sparse_bwd_dq_cuda(x, x, x, x, stat, stat, cols, nvalid,
                                    0.125, 16)
    with pytest.raises(ValueError, match="group"):
        bs.block_sparse_bwd_dkv_cuda(x, x, x, x, stat, stat, rows_t,
                                     nvalid_t, 0.125, 16)
    with pytest.raises(ValueError, match="group"):
        bs.block_sparse_attention(x, x, x, layout, 16,
                                  luts=bs.device_luts(
                                      bs.build_kernel_luts(layout), dev))
    assert (bs.block_sparse_fwd.launches, bs.block_sparse_bwd_dq.launches,
            bs.block_sparse_bwd_dkv.launches) == counts


def test_block_sparse_entry_points_launch_or_raise(dev):
    """SparseSelfAttention with no mask launches each kernel once per
    forward and backward; with a mask it takes the gather path and
    launches none; the wrappers raise on what the kernels do not take."""
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bs
    from deepspeed_tpu_torch.ops.sparse_attention import (
        FixedSparsityConfig, SparseSelfAttention)
    attn = SparseSelfAttention(FixedSparsityConfig(4, block=16))
    q = _randn(dev, 2, 4, 128, 64).bfloat16().requires_grad_(True)
    counts = (bs.block_sparse_fwd.launches, bs.block_sparse_bwd_dq.launches,
              bs.block_sparse_bwd_dkv.launches)
    out = attn(q, q, q)
    out.float().sum().backward()
    after = (bs.block_sparse_fwd.launches, bs.block_sparse_bwd_dq.launches,
             bs.block_sparse_bwd_dkv.launches)
    assert after == tuple(c + 1 for c in counts)
    kp = torch.zeros(2, 128, device=dev)
    gathered = attn(q, q, q, key_padding_mask=kp)
    assert (bs.block_sparse_fwd.launches,) == after[:1]
    # two bf16 results of one function: within 2e-2 of the magnitude
    assert (gathered.float() - out.float()).abs().max().item() <= \
        2e-2 * max(1.0, out.float().abs().max().item())
    layout = FixedSparsityConfig(4, block=8).make_layout(128)
    x = q.detach()
    with pytest.raises(ValueError, match="block"):
        bs.block_sparse_attention(x, x, x, layout, 8)
    layout = FixedSparsityConfig(4, block=16).make_layout(128)
    with pytest.raises(ValueError, match="head_dim"):
        bs.block_sparse_attention(x[..., :32], x[..., :32], x[..., :32],
                                  layout, 16)
    luts, groups = _sparse_tables(bs, layout, 16, dev)
    with pytest.raises(TypeError, match="dtype"):
        bs.block_sparse_fwd_cuda(x, x.float(), x, *luts[:2], 0.125, 16,
                                 groups)
    with pytest.raises(ValueError, match="contiguous"):
        bs.block_sparse_fwd_cuda(x.transpose(2, 3).contiguous().transpose(
            2, 3), x, x, *luts[:2], 0.125, 16, groups)


# ---------------------------------------------------------------------------
# the samplers on the card (torch ops, no kernel of their own): the CPU
# tests' statistical bars at GPT-2's vocab, a seed's draws bitwise
# reproducible, and no host synchronization
# ---------------------------------------------------------------------------


def _zipf_logits(dev, vocab=50257, s=1.1, seed=0):
    """Logits whose softmax falls off as rank^-s, ranks permuted."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    perm = torch.randperm(vocab, generator=g)
    ranks = torch.empty(vocab)
    ranks[perm] = torch.arange(1, vocab + 1, dtype=torch.float32)
    return (-s * torch.log(ranks)).to(dev)


def _chi2_p(obs, probs):
    """Goodness-of-fit chi-square p over bins of expected count >= 5, the
    rest pooled."""
    import numpy as np
    from scipy import stats
    exp = probs * obs.sum()
    big = exp >= 5
    o = np.append(obs[big], obs[~big].sum())
    e = np.append(exp[big], exp[~big].sum())
    return stats.chisquare(o, e * o.sum() / e.sum()).pvalue


def _gen(dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def test_select_next_token_on_card_matches_softmax(dev):
    from deepspeed_tpu_torch.inference.speculative import select_next_token
    logits = _zipf_logits(dev)
    T, rows, chunks = 0.8, 4096, 8
    g = _gen(dev, 1)
    torch.cuda.set_sync_debug_mode("error")
    try:
        draws = torch.cat([select_next_token(logits.expand(rows, -1), T, g)
                           for _ in range(chunks)])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert draws.dtype == torch.int32
    obs = torch.bincount(draws.long(), minlength=50257).cpu().double()
    probs = torch.softmax(logits.double() / T, -1).cpu()
    assert _chi2_p(obs.numpy(), probs.numpy()) >= 1e-3
    again = select_next_token(logits.expand(rows, -1), T, _gen(dev, 1))
    assert torch.equal(again, draws[:rows])


def test_rejection_sampler_on_card(dev):
    """S = 4096 rows of one block (k 4, GPT-2's vocab): the first emitted
    token follows the target's softmax, the mean accepted length its
    closed form; one seed gives the same output twice; no host sync."""
    import math
    from deepspeed_tpu_torch.inference.speculative import (
        rejection_sample_accept, select_next_token)
    S, k, V, T = 4096, 4, 50257, 0.8
    tl = torch.stack([_zipf_logits(dev, seed=i) for i in range(k + 1)])
    dl = tl[:k] + torch.randn(k, V, generator=_gen(dev, 2), device=dev)
    p = torch.softmax(tl.double() / T, -1)
    q = torch.softmax(dl / T, -1)
    drafts = select_next_token(torch.log(q)[None].expand(S, k, V), 1.0,
                               _gen(dev, 3))
    args = (tl[None].expand(S, k + 1, V), drafts, q[None].expand(S, k, V),
            T)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, acc = rejection_sample_accept(*args, _gen(dev, 4))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    out2, acc2 = rejection_sample_accept(*args, _gen(dev, 4))
    assert torch.equal(out, out2) and torch.equal(acc, acc2)
    obs = torch.bincount(out[:, 0].long(), minlength=V).cpu().double()
    assert _chi2_p(obs.numpy(), p[0].cpu().numpy()) >= 1e-3
    alpha = torch.minimum(p[:k], q.double()).sum(-1).cpu()
    expect = sum(float(torch.prod(alpha[:i + 1])) for i in range(k))
    a = acc.double().cpu()
    z = (float(a.mean()) - expect) / (float(a.std()) / math.sqrt(S))
    assert abs(z) < 3.29, (float(a.mean()), expect)


def test_lora_paged_decode_on_card_matches_cpu(dev):
    """The paged decode step with adapters (three slots on three pool
    slots, slot 0 the zero adapter) on the card against the CPU, fp32:
    the LoRA products are torch bmm on both, the attention the paged
    kernel against its plain version."""
    from deepspeed_tpu_torch.inference.adapters import (
        adapter_param_shapes, synth_adapter)
    from deepspeed_tpu_torch.models.gpt2 import (GPT2Config, GPT2Model,
                                                 gpt2_decode_step_paged)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPT2Config(vocab_size=512, n_positions=128, d_model=128,
                     n_layer=2, n_head=2)
    params = GPT2Model(cfg).init(0)
    shapes = adapter_param_shapes(2, 128, 8, ("qkv_w", "out_w", "fc_w",
                                              "proj_w"))
    pools = {t: (torch.zeros((2, 3) + a[1:]), torch.zeros((2, 3) + b[1:]))
             for t, (a, b) in shapes.items()}
    for slot, aid in ((1, 4), (2, 9)):
        w = synth_adapter(aid, shapes)
        for t in pools:
            pools[t][0][:, slot] = torch.from_numpy(w[t][0])
            pools[t][1][:, slot] = torch.from_numpy(w[t][1])
    g = torch.Generator().manual_seed(5)
    kp = torch.randn(2, 9, 2, 16, 64, generator=g)
    vp = torch.randn(2, 9, 2, 16, 64, generator=g)
    table = torch.tensor([[1, 2], [3, 4], [5, 6]], dtype=torch.int32)
    lengths = torch.tensor([5, 17, 30], dtype=torch.int32)
    toks = torch.tensor([7, 11, 13])
    active = torch.ones(3, dtype=torch.bool)
    slots = torch.tensor([0, 1, 2], dtype=torch.int32)
    def to(tree, d):
        if isinstance(tree, dict):
            return {n: to(v, d) for n, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(to(v, d) for v in tree)
        return tree.to(d)

    outs = [gpt2_decode_step_paged(
        cfg, to(params, d), toks.to(d), kp.clone().to(d),
        vp.clone().to(d), table.to(d), lengths.to(d), active.to(d),
        impl="pallas", lora=to(pools, d), adapter_slots=slots.to(d),
        lora_scale=2.0)
        for d in (torch.device("cpu"), dev)]
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert (a.cpu() - b.cpu()).abs().max().item() <= TOL[torch.float32]
