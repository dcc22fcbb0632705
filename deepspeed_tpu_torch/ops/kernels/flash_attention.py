"""Flash attention forward: the hand-written Hopper kernel and its plain
PyTorch version.

Port of ``deepspeed_tpu/ops/pallas/flash_attention.py``'s forward
(``flash_attention`` and the ``_fwd_kernel`` it launches).  On a CUDA
tensor :func:`flash_attention` launches ``csrc/flash_fwd.cu``; on a CPU
tensor it runs :func:`flash_attention_plain`, the same function in plain
PyTorch (the CPU tests' path and the kernel's yardstick on the card).
There is no fallback: a CUDA tensor reaches the kernel or the call raises.

The serving prefill (causal, no dropout, no key mask) is what the kernel
covers.  Dropout and the additive key mask are training-path arguments:
the plain version implements them with the JAX package's exact
position-hash dropout mask, and on a CUDA tensor they raise until the
training slice ports the backward kernels (ROADMAP.md queue 2, items
1-3).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

NEG_INF = -1e30
#: additive-mask drop value for boolean key masks
NEG_MASK = -1e9
#: a row whose max score never rose above this had no valid key: its
#: output is hard-zeroed and its lse set to +DEAD_LSE
DEAD_ROW_THRESH = NEG_MASK * 0.5
DEAD_LSE = 1e30
#: the only head_dim the kernel takes (every GPT-2 size uses 64)
HEAD_DIM = 64

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# the dropout hash, bit-exact with the JAX package's (uint32 math in int64)
# ---------------------------------------------------------------------------


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` holding uint32 values, split
    in 16-bit halves so no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer — the JAX package's ``_fmix32``."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def dropout_keep_mask(q_ids, k_ids, bh, seed, rate: float) -> torch.Tensor:
    """Counter-based keep mask: a uint32 hash of (batch·head, q position,
    k position, seed) compared against ``rate`` — bit-equal to the JAX
    package's ``dropout_keep_mask``.  Arguments broadcast (int64)."""
    x = (_mul32(q_ids, 0x9E3779B9) + k_ids) & _M32
    x = x ^ _mul32(bh, 0x85EBCA6B)
    x = _fmix32(x ^ (int(seed) & _M32))
    thresh = min(round(rate * 2.0 ** 32), 2 ** 32 - 1)
    return x >= thresh


def dense_keep_mask(B, H, Tq, Tk, seed, rate: float, bh_ids=None,
                    device=None) -> torch.Tensor:
    """Full keep mask [B, H, Tq, Tk]; ``bh_ids`` optional [B·H] global
    batch·head ids (default ``arange(B*H)``)."""
    if bh_ids is None:
        bh_ids = torch.arange(B * H, device=device)
    bh_ids = torch.as_tensor(bh_ids, dtype=torch.int64, device=device)
    return dropout_keep_mask(
        torch.arange(Tq, device=device).view(1, 1, Tq, 1),
        torch.arange(Tk, device=device).view(1, 1, 1, Tk),
        bh_ids.view(B, H, 1, 1), seed, rate)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def flash_attention_plain(q, k, v, causal: bool, sm_scale: float,
                          kv_length: Optional[int] = None, kmask=None,
                          dropout_rate: float = 0.0, seed: int = 0,
                          bh_ids=None):
    """The kernel's function in plain PyTorch: ``(out [B,H,T,Dh] in
    q.dtype, lse [B,H,T] fp32)``.  Scores, softmax statistics and the
    value product run in fp32 whatever the input dtype, as in the kernel.
    ``kmask``: optional additive fp32 key mask [B·H, Tk]."""
    B, H, T, _ = q.shape
    tk = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if kmask is not None:
        s = s + kmask.view(B, H, 1, tk)
    seq_len = tk if kv_length is None else kv_length
    k_ids = torch.arange(tk, device=q.device)
    valid = (k_ids < seq_len)[None, :]
    if causal:
        q_ids = torch.arange(T, device=q.device)
        valid = valid & (k_ids[None, :] <= q_ids[:, None])
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    dead = m <= DEAD_ROW_THRESH
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if dropout_rate > 0.0:
        keep = dense_keep_mask(B, H, T, tk, seed, dropout_rate, bh_ids,
                               device=q.device)
        p = p * keep / (1.0 - dropout_rate)
    out = torch.matmul(p, v.float()) / l
    out = torch.where(dead, torch.zeros_like(out), out).to(q.dtype)
    lse = torch.where(dead[..., 0], torch.full_like(m[..., 0], DEAD_LSE),
                      m[..., 0] + torch.log(l[..., 0]))
    return out, lse


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------


def _load():
    lib = build.load("flash_fwd")
    if lib.flash_fwd.argtypes is None:
        lib.flash_fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                                  + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p])
        lib.flash_fwd.restype = ctypes.c_int
    return lib


def flash_attention_cuda(q, k, v, causal: bool, sm_scale: float,
                         kv_length: Optional[int] = None):
    """Launch ``csrc/flash_fwd.cu`` on contiguous CUDA tensors q
    [B,H,T,64] and k/v [B,H,Tk,64] of one dtype (fp32, bf16 or fp16).
    Returns ``(out [B,H,T,64] in q.dtype, lse [B,H,T] fp32)``; raises on
    anything the kernel does not take and on a failed launch."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention_cuda: {name} is on {t.device}, "
                             "not a CUDA device")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODES:
            raise TypeError(f"flash_attention_cuda: {name} has dtype "
                            f"{t.dtype}; q, k and v must share one of "
                            f"{list(_DTYPE_CODES)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_cuda: {name} is not "
                             "contiguous")
        if t.device != q.device:
            raise ValueError("flash_attention_cuda: q, k and v must be on "
                             "one device")
    B, H, T, Dh = q.shape
    tk = k.shape[2]
    if Dh != HEAD_DIM or k.shape != (B, H, tk, Dh) or v.shape != k.shape:
        raise ValueError(
            f"flash_attention_cuda: shapes q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}; the kernel takes "
            f"[B, H, T, {HEAD_DIM}] with k and v of one shape")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = _load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), lse.data_ptr(), B * H, T, tk,
                           tk if kv_length is None else int(kv_length),
                           float(sm_scale), int(causal),
                           _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out, lse


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    sm_scale: Optional[float] = None,
                    dropout_rate: float = 0.0,
                    dropout_rng: Optional[torch.Generator] = None,
                    dropout_seed=None,
                    bh_affine=None,
                    key_mask=None,
                    kv_length: Optional[int] = None) -> torch.Tensor:
    """Flash attention over [B, H, T, Dh] inputs — the JAX package's
    ``flash_attention`` (forward), minus its TPU tiling and interpret-mode
    arguments (``block_q``, ``block_k``, ``interpret``): the kernel's
    tiles are fixed and it never runs in an interpreter.

    ``kv_length``: static live length of k/v — keys at or past it are
    hard-masked; out-of-range values raise.  Rows with no valid key
    (``kv_length=0``, or a key mask dropping every key) output exact
    zeros.  ``dropout_rate > 0`` (with ``dropout_seed`` or a
    ``torch.Generator`` as ``dropout_rng``), ``bh_affine`` and
    ``key_mask`` follow the JAX package's semantics on a CPU tensor and
    raise ``NotImplementedError`` on a CUDA tensor (training slice).
    """
    assert q.ndim == 4, f"expected [B, H, T, D], got {tuple(q.shape)}"
    b, h, t, d = q.shape
    tk = k.shape[2]
    assert not causal or t == tk, (
        f"causal flash attention requires equal q/k lengths, got {t} vs "
        f"{tk}; pass causal=False for cross-attention")
    if kv_length is not None:
        kv_length = int(kv_length)
        if not 0 <= kv_length <= tk:
            raise ValueError(
                f"kv_length={kv_length} is out of range for key length "
                f"{tk}: the mask would silently cover the wrong keys "
                f"(want 0 <= kv_length <= {tk})")
    if sm_scale is None:
        sm_scale = float(d) ** -0.5
    dropout_rate = float(dropout_rate)
    assert 0.0 <= dropout_rate < 1.0, f"bad dropout_rate {dropout_rate}"
    if q.is_cuda:
        if dropout_rate > 0.0 or key_mask is not None:
            raise NotImplementedError(
                "flash_attention on CUDA covers the serving prefill; "
                "dropout and key_mask come with the training slice "
                "(ROADMAP.md queue 2, items 1-3)")
        out, _ = flash_attention_cuda(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal, sm_scale,
                                      kv_length)
        return out
    seed = 0
    if dropout_rate > 0.0:
        if dropout_seed is not None:
            seed = int(dropout_seed)
        else:
            assert dropout_rng is not None, \
                "dropout_rate > 0 requires dropout_rng or dropout_seed"
            seed = int(torch.randint(0, 2 ** 32, (), generator=dropout_rng))
    base, period, stride = bh_affine if bh_affine is not None \
        else (0, b * h, 0)
    g = torch.arange(b * h, device=q.device)
    bh_ids = (int(base) + (g // int(period)) * int(stride)
              + g % int(period)) & _M32
    kmask = None
    if key_mask is not None:
        km = torch.as_tensor(key_mask, device=q.device)
        if km.dtype == torch.bool:
            km = torch.where(km, 0.0, NEG_MASK).float()
        else:
            km = km.float()
        if tuple(km.shape) == (b, tk):
            km = km[:, None, :].expand(b, h, tk)
        elif tuple(km.shape) != (b * h, tk):
            raise ValueError(
                f"key_mask shape {tuple(km.shape)} must be [B, Tk]="
                f"{b, tk} or [B*H, Tk]={b * h, tk}")
        kmask = km.reshape(b * h, tk)
    out, _ = flash_attention_plain(q, k, v, causal, sm_scale, kv_length,
                                   kmask, dropout_rate, seed, bh_ids)
    return out


#: kernel launches since the count was last set to 0 (one per call that
#: reached the CUDA kernel; the plain version never counts)
flash_attention.launches = 0
