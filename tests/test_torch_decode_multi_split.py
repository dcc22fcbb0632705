"""The arithmetic of ``csrc/decode_multi.cu``'s bf16/fp16 kernel, emulated in
PyTorch on the CPU; at W = 1 it is ``csrc/decode_attention.cu``'s too (the
same kernel, the lengths [S] read as [S, 1]).

The kernel splits each (slot, head)'s key axis over N CUDA blocks of one
thread-block cluster (N = ceil(T / 256) clamped to 1..8: 4 at the serving
cache length 1024): block r takes keys [r * chunk, (r + 1) * chunk),
chunk = ceil(T / N) in whole 64-key tiles, and stops at the slot's longest
row; each of its four warps takes 16 keys of every tile and keeps its own
online softmax (scores in the log2 domain, one row max and rescale a
16-key chunk, keys at or past a row's own length at p = 0, P rounded once
to the input type for P.V, l summed from the unrounded p); the warps merge
in shared memory, then rank 0 merges the N block states in rank order
(distributed shared memory: the largest m of the splits that saw a key,
then the sums) and divides.  ``_emulated`` does exactly that,
and the tests hold it

(a) in fp32 (no rounding) to the port's plain version within 1e-5: the
    split, the per-chunk softmax and the two merges are the same function;
(b) in bf16 to the port's fp32 plain version on the same inputs within
    ``chip_smoke.py``'s 2e-2 and no farther from it than the JAX package's
    Pallas kernel (interpret mode) is, and to that kernel within 1e-2: both
    round P once, at different running maxima, and round the output to
    bf16.

(c) at W = 1, (b) against the JAX package's single-query kernel
    (``decode_attention``, ``_decode_kernel``: Pallas, interpret mode,
    block_k 256) in place of the multi-query one.

Inputs from a numpy seed: S 5 x H 2, T 1024, N 1, 3, 4 and 8, W 1, 5 and
9; lengths 0
(exact zeros), 1, a tile boundary (64, 128), T, and a slot whose rows all
end before the last splits begin (those splits see no key: l = 0).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.decode_attention import (
    decode_attention as jax_decode, decode_attention_multi as jax_decode_multi)
from deepspeed_tpu_torch.ops.kernels.decode_attention import (
    _default_scale, decode_multi_plain)

S, H, T, D = 5, 2, 1024, 64
TILE, WARPS = 64, 4
NEG_INF = -1e30
LOG2E = 1.4426950408889634
SCALE = _default_scale(D)
#: against the fp32 plain version (chip_smoke.py's bf16 TOL), and
#: against the JAX kernel, both absolute
TOL_CHIP, TOL_JAX = 2e-2, 1e-2


def _lengths(w):
    """Per-row lengths [S, W] at base lengths {0, 1, 64, T - W, 300 - W}:
    row i of a live slot at L + i + 1, as the verify pass gives them; slot
    2's row 0 ends on a tile boundary (64), slot 3's last row is T, slot
    4's rows end before key 300, past which splits 3..7 of N = 8 begin."""
    base = np.array([0, 1, 63, T - w, 300 - w])
    lens = np.where(base[:, None] > 0, base[:, None] + np.arange(1, w + 1),
                    0)
    lens[2, 0] = 64
    if w > 1:
        lens[1, -1] = 128            # a tile boundary that ends a split
    return np.minimum(lens, T).astype(np.int32)


def _inputs(w, seed=0):
    """q [S, H, W, D], k, v [S, H, T, D] as bf16 values in fp32 arrays."""
    rng = np.random.default_rng(seed + w)

    def bf16(shape):
        a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return np.asarray(a.bfloat16().float())

    return bf16((S, H, w, D)), bf16((S, H, T, D)), bf16((S, H, T, D))


def _emulated(q, k, v, lengths, n, dtype, states=None):
    """The kernel's arithmetic with N = ``n`` splits, P rounded to
    ``dtype`` (float32: no rounding); the output in ``dtype``.  ``states``,
    a list, receives each split's merged (m, l, acc)."""
    W = q.shape[2]
    chunk = math.ceil(math.ceil(T / n) / TILE) * TILE
    pad = n * chunk - T  # keys past T: zero-filled tiles, never live
    kp, vp = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (k, v))
    lens = lengths.clamp(0, T).long()
    s_all = torch.einsum("shwd,shtd->shwt", q, kp) * (SCALE * LOG2E)
    live = (torch.arange(n * chunk)[None, None, None]
            < lens[:, None, :, None])
    split_states = []
    for r in range(n):
        warp_states = []
        for wp in range(WARPS):
            m = torch.full((S, H, W), NEG_INF)
            l = torch.zeros((S, H, W))
            acc = torch.zeros((S, H, W, D))
            for i in range(chunk // TILE):
                ks = slice(r * chunk + i * TILE + 16 * wp,
                           r * chunk + i * TILE + 16 * wp + 16)
                s = torch.where(live[..., ks], s_all[..., ks], NEG_INF)
                mx = torch.maximum(m, s.amax(-1))
                alpha = torch.exp2(m - mx)
                p = torch.where(live[..., ks], torch.exp2(s - mx[..., None]),
                                0.0)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + p.to(dtype).float() @ vp[
                    ..., ks, :]
                m = mx
            warp_states.append((m, l, acc))
        wm, wl, wa = (torch.stack(x) for x in zip(*warp_states))
        mb = torch.where(wl > 0, wm, NEG_INF).amax(0)
        f = torch.where(wl > 0, torch.exp2(wm - mb), 0.0)
        split_states.append((mb, (wl * f).sum(0), (wa * f[..., None]).sum(0)))
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
        f = torch.where(pl > 0, torch.exp2(pm - mt), 0.0)
        lt = lt + pl * f
        at = at + pa * f[..., None]
    inv = torch.where(lt > 0, 1.0 / torch.where(lt > 0, lt, 1.0), 0.0)
    return (at * inv[..., None]).to(dtype)


def _ulps(got, want):
    """max |got - want| over (one bf16 ulp of want + 1e-4)."""
    return ((got.float() - want).abs()
            / (want.abs() * 2.0 ** -7 + 1e-4)).max().item()


@pytest.mark.parametrize("n", [1, 3, 4, 8])
@pytest.mark.parametrize("w", [1, 5, 9])
def test_split_and_merge_is_the_plain_function_in_fp32(n, w):
    q, k, v = map(torch.from_numpy, _inputs(w))
    lens = torch.from_numpy(_lengths(w))
    out = _emulated(q, k, v, lens, n, torch.float32)
    ref = decode_multi_plain(q, k, v, lens, SCALE)
    err = (out - ref).abs().max().item()
    print(f"N {n}, W {w}: fp32 emulation vs plain {err:.3g}")
    assert err <= 1e-5, err
    assert (out[0] == 0).all()  # length 0: exact zeros


@pytest.mark.parametrize("n", [1, 4, 8])
@pytest.mark.parametrize("w", [1, 5, 9])
def test_p_rounded_once_stays_within_chip_tolerance_and_matches_jax(n, w):
    q, k, v = _inputs(w)
    lens = _lengths(w)
    tq, tk, tv, tl = map(torch.from_numpy, (q, k, v, lens))
    out = _emulated(tq, tk, tv, tl, n, torch.bfloat16)
    ref = decode_multi_plain(tq, tk, tv, tl, SCALE)
    jax_out = jax_decode_multi(*(jnp.asarray(a, jnp.bfloat16)
                                 for a in (q, k, v)), jnp.asarray(lens),
                               impl="pallas", interpret=True)
    jax_out = torch.from_numpy(np.array(jax_out.astype(jnp.float32)))
    err = (out.float() - ref).abs().max().item()
    err_jax = (out.float() - jax_out).abs().max().item()
    print(f"N {n}, W {w}: bf16 emulation vs fp32 plain {err:.3g} "
          f"({_ulps(out, ref):.3g} of one bf16 ulp + 1e-4), vs JAX "
          f"{err_jax:.3g}; JAX vs fp32 plain {(jax_out - ref).abs().max():.3g}"
          f" ({_ulps(jax_out, ref):.3g} ulp)")
    assert err <= TOL_CHIP, err
    assert err <= (jax_out - ref).abs().max().item() * 1.25, err
    assert err_jax <= TOL_JAX, err_jax
    assert (out[0] == 0).all()


@pytest.mark.parametrize("n", [1, 4, 8])
def test_single_query_split_matches_jax_decode_kernel(n):
    """W = 1, the decode tick's kernel, held as (b) holds it but to the
    JAX package's single-query kernel: lengths 0, 1, a tile boundary (64),
    T and 300, which ends before splits 3-7 of N = 8 begin."""
    q, k, v = _inputs(1, seed=7)
    lens = np.array([0, 1, 64, T, 300], np.int32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tl = torch.from_numpy(lens)[:, None]
    out = _emulated(tq, tk, tv, tl, n, torch.bfloat16)[:, :, 0]
    ref = decode_multi_plain(tq, tk, tv, tl, SCALE)[:, :, 0]
    jax_out = jax_decode(*(jnp.asarray(a, jnp.bfloat16)
                           for a in (q[:, :, 0], k, v)), jnp.asarray(lens),
                         impl="pallas", interpret=True)
    jax_out = torch.from_numpy(np.array(jax_out.astype(jnp.float32)))
    err = (out.float() - ref).abs().max().item()
    err_jax = (out.float() - jax_out).abs().max().item()
    print(f"N {n}, W 1: bf16 emulation vs fp32 plain {err:.3g} "
          f"({_ulps(out, ref):.3g} of one bf16 ulp + 1e-4), vs JAX "
          f"_decode_kernel {err_jax:.3g}; JAX vs fp32 plain "
          f"{(jax_out - ref).abs().max():.3g} ({_ulps(jax_out, ref):.3g} ulp)")
    assert err <= TOL_CHIP, err
    assert err <= (jax_out - ref).abs().max().item() * 1.25, err
    assert err_jax <= TOL_JAX, err_jax
    assert (out[0] == 0).all() and (jax_out[0] == 0).all()


def test_splits_wholly_past_every_row_see_no_key():
    """N 8 (chunk 128): slot 4's rows end before key 300, so its splits 3-7
    load nothing and report l = 0; the length-0 slot's splits all do."""
    w = 5
    q, k, v = map(torch.from_numpy, _inputs(w))
    lens = torch.from_numpy(_lengths(w))
    states = []
    _emulated(q, k, v, lens, 8, torch.float32, states)
    ls = torch.stack([l for _, l, _ in states])        # [N, S, H, W]
    assert (ls[3:, 4] == 0).all() and (ls[:3, 4] > 0).all()
    assert (ls[:, 0] == 0).all()
    accs = torch.stack([a for _, _, a in states])
    assert (accs[3:, 4] == 0).all()
