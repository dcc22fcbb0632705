"""The arithmetic of the paged decode kernels' bf16/fp16 arms
(``csrc/decode_paged.cu`` and ``csrc/decode_paged_multi.cu`` over
``csrc/decode_split.cuh``), both pools, emulated in PyTorch on the CPU.

The kernel splits each (slot, head)'s key axis over N CUDA blocks of one
thread-block cluster: block r takes keys [r * chunk, (r + 1) * chunk),
chunk = ceil(T / N) in whole 64-key tiles (T = max_pages * page_len), and
stops at the slot's longest row.  Key j is row j % page_len of page
table[s, j // page_len]; only the table columns below ceil(longest row /
page_len) are read, and rows at or past the longest row are zero-filled
(their bytes and scales never read).  Each of four warps takes 16 keys of
every tile and keeps its own online softmax in the log2 domain (one row max
and rescale a 16-key chunk, keys at or past a row's own length at p = 0,
l summed from the unrounded p).  The fp pool's P enters P.V rounded once to
the input type; the int8 pool scales S by each key's k_scale and P by its
v_scale into pv = p * vs (fp32), which enters P.V as two bf16 terms,
hi = bf16(pv) and lo = bf16(pv - hi), against the int8 values (exact in
bf16).  The warps merge in shared memory, then rank 0 merges the N block
states in rank order and divides.  ``_emulated`` does exactly that, and
the tests hold it

(a) in fp32 (no rounding) to the port's plain versions within 1e-5, for
    N 1, 4 and 8: the split, the table walk, the per-chunk softmax and the
    two merges are the same function;
(b) in bf16 to the JAX package's ``decode_attention_paged`` and
    ``decode_attention_paged_multi`` (Pallas interpret mode) within 1e-2
    absolute, as ``decode_multi``'s emulation is held; and to the port's
    fp32 plain versions within ``chip_smoke.py``'s 2e-2 (fp pool, no
    farther than the JAX kernel is) or one bf16 ulp + 1e-4 elementwise
    (int8 pool, the card's bound for that arm).

Inputs from a numpy seed: S 5 x H 2, page_len 1, 7, 16 and 128, W 1, 5 and
9; a length-0 slot (exact zeros), one key, a row ending on a tile boundary,
the full capacity, and a slot whose rows end before the later splits begin
(l = 0); table columns past the live pages hold an id outside the pool,
and every pool row no live row reads holds garbage (int8: random bytes
and, where the JAX kernel is not run on them, NaN scales).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.decode_attention import (
    decode_attention_paged as jax_decode_paged,
    decode_attention_paged_multi as jax_decode_paged_multi)
from deepspeed_tpu_torch.inference.quantize import quantize_rows
from deepspeed_tpu_torch.ops.kernels.decode_attention import (
    _default_scale, decode_paged_int8_plain, decode_paged_multi_int8_plain,
    decode_paged_multi_plain, decode_paged_plain)

S, H, D = 5, 2, 64
TILE, WARPS = 64, 4
NEG_INF = -1e30
LOG2E = 1.4426950408889634
SCALE = _default_scale(D)
#: table columns a slot has, per page_len: T = 256, 280, 1024 and 1024
MAX_PAGES = {1: 256, 7: 40, 16: 64, 128: 8}
#: ... and, where the JAX kernel runs (one grid step a page), fewer
JAX_PAGES = {1: 64, 7: 40, 16: 64, 128: 8}
#: against the JAX kernel (absolute) and chip_smoke.py's bf16 TOL
TOL_JAX, TOL_CHIP = 1e-2, 2e-2
DEAD_ID = 10 ** 6   # a table entry past the pool: never dereferenced


def _bf16(a: np.ndarray) -> np.ndarray:
    return np.asarray(torch.from_numpy(a).bfloat16().float())


def _case(page_len, max_pages, w, pool, seed=0, nan_scales=True):
    """(q, pools, table, lengths) as numpy arrays; q and the fp pools hold
    bf16 values.  Lengths [S, W]: row i of a live slot at L + i + 1 over
    base lengths {0, 1, 63, T - W, T / 5}; slot 2's row 0 ends on a tile
    boundary (64); slot 4's rows end before key T / 5 + 9, so at N 8 its
    later splits see no key.  ``pool`` 'int8' gives (k8, v8, ks, vs)
    quantized by the port's ``quantize_rows``, every row no live row
    reads holding random bytes and a NaN scale (``nan_scales``) or a
    large finite one."""
    rng = np.random.default_rng(seed + 97 * page_len + w)
    T = max_pages * page_len
    base = np.array([0, 1, 63, T - w, T // 5])
    lens = np.where(base[:, None] > 0, base[:, None] + np.arange(1, w + 1), 0)
    lens[2, 0] = 64
    lens = np.minimum(lens, T).astype(np.int32)
    need = -(-lens.max(axis=1) // page_len)
    P = int(need.sum()) + 3
    ids = rng.permutation(np.arange(1, P))
    table = np.full((S, max_pages), DEAD_ID, np.int32)
    live = np.zeros((P, page_len), bool)
    nxt = 0
    for s in range(S):
        table[s, :need[s]] = ids[nxt:nxt + need[s]]
        nxt += need[s]
        pos = np.arange(lens[s].max())
        live[table[s, pos // page_len], pos % page_len] = True
    q = _bf16(rng.standard_normal((S, H, w, D)).astype(np.float32))
    kv = [_bf16(rng.standard_normal((P, H, page_len, D)).astype(np.float32))
          for _ in range(2)]
    dead = ~live[:, None, :, None]
    if pool == "fp":
        kv = [np.where(dead, np.float32(1e4), x) for x in kv]
        return q, kv, table, lens
    out = []
    for x in kv:
        q8, sc = (t.numpy() for t in quantize_rows(torch.from_numpy(x)))
        junk = rng.integers(-128, 128, q8.shape).astype(np.int8)
        filler = np.float32(np.nan) if nan_scales else np.float32(1e3)
        out += [np.where(dead, junk, q8), np.where(dead[..., 0], filler, sc)]
    k8, ks, v8, vs = out
    return q, [k8, v8, ks.astype(np.float32), vs.astype(np.float32)], table, \
        lens


def _rows(pool, table, maxlen, page_len, width):
    """[S, H, width, ...]: key j < maxlen[s] of slot s read through the
    table (only the live columns are indexed), every later key zero — the
    kernel's zero-filled rows."""
    out = torch.zeros((S, H, width) + tuple(pool.shape[3:]), dtype=pool.dtype)
    for s in range(S):
        n = int(maxlen[s])
        if n:
            j = torch.arange(n)
            pages = torch.from_numpy(table[s])[j // page_len].long()
            out[s, :, :n] = pool[pages, :, j % page_len].transpose(0, 1)
    return out


def _emulated(q, pools, table, lens, n, dtype, states=None):
    """The kernel's arithmetic with N = ``n`` splits, P rounded to
    ``dtype`` (float32: no rounding) on the fp pool and pv as bf16 hi + lo
    on the int8 pool (float32: unrounded); the output in ``dtype``.
    ``states``, a list, receives each split's merged (m, l, acc)."""
    W = q.shape[2]
    page_len = pools[0].shape[2]
    T = table.shape[1] * page_len
    chunk = math.ceil(math.ceil(T / n) / TILE) * TILE
    quant = len(pools) == 4
    maxlen = lens.max(axis=1)
    kv = [_rows(torch.from_numpy(x), table, maxlen, page_len, n * chunk)
          for x in pools]
    tq = torch.from_numpy(q)
    if quant:
        k, v, ks, vs = kv
        k, v = k.float(), v.float()
        f = SCALE * LOG2E * ks[:, :, None, :]
    else:
        k, v = kv
        f = SCALE * LOG2E
    s_all = torch.einsum("shwd,shtd->shwt", tq, k) * f
    live = (torch.arange(n * chunk)[None, None, None]
            < torch.from_numpy(lens).long()[:, None, :, None])
    split_states = []
    for r in range(n):
        warp_states = []
        for wp in range(WARPS):
            m = torch.full((S, H, W), NEG_INF)
            l = torch.zeros((S, H, W))
            acc = torch.zeros((S, H, W, D))
            for i in range(chunk // TILE):
                j = slice(r * chunk + i * TILE + 16 * wp,
                          r * chunk + i * TILE + 16 * wp + 16)
                sc = torch.where(live[..., j], s_all[..., j], NEG_INF)
                mx = torch.maximum(m, sc.amax(-1))
                alpha = torch.exp2(m - mx)
                p = torch.where(live[..., j], torch.exp2(sc - mx[..., None]),
                                0.0)
                l = l * alpha + p.sum(-1)
                if quant:
                    pv = p * vs[:, :, None, j]
                    hi = pv.to(torch.bfloat16).float() if dtype != \
                        torch.float32 else pv
                    lo = (pv - hi).to(torch.bfloat16).float() if dtype != \
                        torch.float32 else torch.zeros_like(pv)
                    pvv = hi @ v[..., j, :] + lo @ v[..., j, :]
                else:
                    pvv = p.to(dtype).float() @ v[..., j, :]
                acc = acc * alpha[..., None] + pvv
                m = mx
            warp_states.append((m, l, acc))
        wm, wl, wa = (torch.stack(x) for x in zip(*warp_states))
        mb = torch.where(wl > 0, wm, NEG_INF).amax(0)
        fw = torch.where(wl > 0, torch.exp2(wm - mb), 0.0)
        split_states.append((mb, (wl * fw).sum(0),
                             (wa * fw[..., None]).sum(0)))
    if states is not None:
        states.extend(split_states)
    # rank 0's merge: the largest m of the splits that saw a key, then the
    # sums in rank order
    mt = torch.full((S, H, W), NEG_INF)
    for pm, pl, _ in split_states:
        mt = torch.where(pl > 0, torch.maximum(mt, pm), mt)
    lt = torch.zeros((S, H, W))
    at = torch.zeros((S, H, W, D))
    for pm, pl, pa in split_states:
        fs = torch.where(pl > 0, torch.exp2(pm - mt), 0.0)
        lt = lt + pl * fs
        at = at + pa * fs[..., None]
    inv = torch.where(lt > 0, 1.0 / torch.where(lt > 0, lt, 1.0), 0.0)
    return (at * inv[..., None]).to(dtype)


def _plain(q, pools, table, lens):
    """The port's fp32 plain version of the same call (the multi-query
    one; W = 1 also through the single-query one, which must agree)."""
    tq, tt, tl = (torch.from_numpy(a) for a in (q, table, lens))
    tp = [torch.from_numpy(x) for x in pools]
    if len(pools) == 4:
        out = decode_paged_multi_int8_plain(tq, *tp, tt, tl, SCALE)
        if q.shape[2] == 1:
            one = decode_paged_int8_plain(tq[:, :, 0], *tp, tt, tl[:, 0],
                                          SCALE)
            assert torch.equal(one, out[:, :, 0])
        return out
    out = decode_paged_multi_plain(tq, *tp, tt, tl, SCALE)
    if q.shape[2] == 1:
        one = decode_paged_plain(tq[:, :, 0], *tp, tt, tl[:, 0], SCALE)
        assert torch.equal(one, out[:, :, 0])
    return out


def _jax(q, pools, table, lens):
    """The JAX package's Pallas kernel (interpret mode) on bf16 operands:
    the single-query entry point at W = 1, the multi-query one otherwise."""
    # the JAX kernel's index maps fetch every column's page (computing
    # only the live ones): its dead columns hold the scratch page 0, as
    # the engine keeps them
    tbl = jnp.asarray(np.where(table == DEAD_ID, 0, table))
    ln = jnp.asarray(lens)
    quant = len(pools) == 4
    kw = {}
    if quant:
        kp, vp = (jnp.asarray(x) for x in pools[:2])
        kw = {"k_scale": jnp.asarray(pools[2]),
              "v_scale": jnp.asarray(pools[3])}
    else:
        kp, vp = (jnp.asarray(x, jnp.bfloat16) for x in pools)
    jq = jnp.asarray(q, jnp.bfloat16)
    if q.shape[2] == 1:
        out = jax_decode_paged(jq[:, :, 0], kp, vp, tbl, ln[:, 0],
                               impl="pallas", interpret=True, **kw)[:, :, None]
    else:
        out = jax_decode_paged_multi(jq, kp, vp, tbl, ln, impl="pallas",
                                     interpret=True, **kw)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


def _ulps(got, want):
    """max |got - want| over (one bf16 ulp of want + 1e-4)."""
    return ((got.float() - want).abs()
            / (want.abs() * 2.0 ** -7 + 1e-4)).max().item()


@pytest.mark.parametrize("pool", ["fp", "int8"])
@pytest.mark.parametrize("n", [1, 4, 8])
@pytest.mark.parametrize("w", [1, 5, 9])
@pytest.mark.parametrize("page_len", [1, 7, 16, 128])
def test_split_and_merge_is_the_plain_function_in_fp32(page_len, w, n, pool):
    q, pools, table, lens = _case(page_len, MAX_PAGES[page_len], w, pool)
    out = _emulated(q, pools, table, lens, n, torch.float32)
    ref = _plain(q, pools, table, lens)
    err = (out - ref).abs().max().item()
    print(f"page_len {page_len}, W {w}, N {n}, {pool}: fp32 emulation vs "
          f"plain {err:.3g}")
    assert torch.isfinite(out).all()   # NaN scales and dead ids never read
    assert err <= 1e-5, err
    assert (out[0] == 0).all()         # length 0: exact zeros


@pytest.mark.parametrize("pool", ["fp", "int8"])
@pytest.mark.parametrize("w", [1, 5, 9])
@pytest.mark.parametrize("page_len", [1, 7, 16, 128])
def test_bf16_rounding_matches_jax_and_stays_within_chip_tolerance(
        page_len, w, pool):
    """N 4 (the serving split).  The JAX kernel scales dead rows' p by
    their v_scale (0 x NaN is NaN), so here those scales are finite."""
    q, pools, table, lens = _case(page_len, JAX_PAGES[page_len], w, pool,
                                  nan_scales=False)
    out = _emulated(q, pools, table, lens, 4, torch.bfloat16)
    ref = _plain(q, pools, table, lens)
    jax_out = _jax(q, pools, table, lens)
    err = (out.float() - ref).abs().max().item()
    err_jax = (out.float() - jax_out).abs().max().item()
    jax_err = (jax_out - ref).abs().max().item()
    print(f"page_len {page_len}, W {w}, {pool}: bf16 emulation vs fp32 "
          f"plain {err:.3g} ({_ulps(out, ref):.3g} ulp), vs JAX "
          f"{err_jax:.3g}; JAX vs fp32 plain {jax_err:.3g} "
          f"({_ulps(jax_out, ref):.3g} ulp)")
    assert err_jax <= TOL_JAX, err_jax
    if pool == "fp":
        assert err <= TOL_CHIP, err
        assert err <= jax_err * 1.25, (err, jax_err)
    else:
        assert _ulps(out, ref) <= 1.0
    assert (out[0] == 0).all()


def test_splits_wholly_past_every_row_see_no_key():
    """N 8 at T 1024 (chunk 128): slot 4's rows end at key 209, so its
    splits 2-7 load nothing and report l = 0; the length-0 slot's splits
    all do."""
    q, pools, table, lens = _case(16, 64, 5, "int8")
    assert lens[4].max() == 1024 // 5 + 5
    states = []
    _emulated(q, pools, table, lens, 8, torch.float32, states)
    ls = torch.stack([l for _, l, _ in states])        # [N, S, H, W]
    assert (ls[2:, 4] == 0).all() and (ls[:2, 4] > 0).all()
    assert (ls[:, 0] == 0).all()
    accs = torch.stack([a for _, _, a in states])
    assert (accs[2:, 4] == 0).all()
