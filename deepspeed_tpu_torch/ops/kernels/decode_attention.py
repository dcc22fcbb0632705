"""Single-query decode attention over the slot KV cache: the hand-written
Hopper kernel, its plain PyTorch version and the dense reference.

Port of ``deepspeed_tpu/ops/pallas/decode_attention.py``'s unpaged arm
(``decode_attention``, ``decode_attention_reference`` and the
``_decode_kernel`` it launches).  ``impl`` keeps the JAX package's config
values: ``"pallas"`` is the hand-written kernel (``csrc/
decode_attention.cu``) on a CUDA tensor and its plain version on a CPU
tensor; ``"dense"`` is the dense reference on either.  There is no
fallback: with ``impl="pallas"`` a CUDA tensor reaches the kernel or the
call raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import build
from .flash_attention import _DTYPE_CODES, HEAD_DIM


def _default_scale(d: int) -> float:
    """1/sqrt(d) computed in fp32 — the exact constant the dense attention
    uses (the python-float ``d ** -0.5`` can differ by 1 ulp)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def decode_attention_reference(q, k, v, lengths, sm_scale=None):
    """Dense reference: q [S, H, Dh] against k/v [S, H, T, Dh] masked to
    per-slot ``lengths`` [S].  Rows with length 0 return exact zeros.
    Mirrors the JAX package's reference op for op (fp32 scores, finfo.min
    mask fill, softmax, probs cast to q.dtype before the value product)."""
    S, H, T, Dh = k.shape
    scale = _default_scale(Dh) if sm_scale is None else sm_scale
    s = torch.einsum("shd,shtd->sht", q.float(), k.float()) * scale
    lengths = lengths.to(device=k.device, dtype=torch.int32)
    valid = (torch.arange(T, device=k.device, dtype=torch.int32)[None, None]
             < lengths[:, None, None])
    s = torch.where(valid, s, torch.finfo(torch.float32).min)
    probs = torch.softmax(s, dim=-1)
    probs = torch.where(lengths[:, None, None] > 0, probs, 0.0)
    return torch.einsum("sht,shtd->shd", probs.to(q.dtype), v)


def decode_attention_plain(q, k, v, lengths, sm_scale: float):
    """The kernel's function in plain PyTorch: fp32 scores, softmax and
    value product over the live keys ``[0, lengths[s])`` of each slot,
    exact zeros for a length-0 slot, output in q.dtype."""
    S, H, T, Dh = k.shape
    s = torch.einsum("shd,shtd->sht", q.float(), k.float()) * sm_scale
    lengths = lengths.to(device=k.device, dtype=torch.int64)
    valid = (torch.arange(T, device=k.device)[None, None]
             < lengths[:, None, None])
    s = torch.where(valid, s, float("-inf"))
    live = (lengths > 0)[:, None, None]
    m = torch.where(live, s.amax(dim=-1, keepdim=True), 0.0)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("sht,shtd->shd", p, v.float()) / torch.where(
        live, l, 1.0)
    return out.to(q.dtype)


def _load():
    lib = build.load("decode_attention")
    if lib.decode_attention.argtypes is None:
        lib.decode_attention.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.decode_attention.restype = ctypes.c_int
    return lib


def decode_attention_cuda(q, k, v, lengths, sm_scale: float):
    """Launch ``csrc/decode_attention.cu`` on contiguous CUDA tensors q
    [S,H,64], k/v [S,H,T,64] of one dtype (fp32, bf16 or fp16) and int32
    lengths [S].  The lengths stay on the device (no host sync).  Returns
    the output [S,H,64] in q.dtype; raises on anything the kernel does not
    take and on a failed launch."""
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"decode_attention_cuda: {name} is on "
                             f"{t.device}; all operands must be on one "
                             "CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention_cuda: {name} is not "
                             "contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention_cuda: {name} is not "
                             "16-byte aligned")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODES:
            raise TypeError(f"decode_attention_cuda: {name} has dtype "
                            f"{t.dtype}; q, k and v must share one of "
                            f"{list(_DTYPE_CODES)}")
    if lengths.dtype != torch.int32:
        raise TypeError("decode_attention_cuda: lengths must be int32, got "
                        f"{lengths.dtype}")
    S, H, T, Dh = k.shape
    if (Dh != HEAD_DIM or q.shape != (S, H, Dh) or v.shape != k.shape
            or lengths.shape != (S,)):
        raise ValueError(
            f"decode_attention_cuda: shapes q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, lengths "
            f"{tuple(lengths.shape)}; the kernel takes q [S, H, "
            f"{HEAD_DIM}], k/v [S, H, T, {HEAD_DIM}], lengths [S]")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.decode_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  lengths.data_ptr(), out.data_ptr(), S, H,
                                  T, float(sm_scale), _DTYPE_CODES[q.dtype],
                                  stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error {rc}")
    decode_attention.launches += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor,
                     sm_scale: Optional[float] = None,
                     impl: str = "pallas") -> torch.Tensor:
    """Single-query attention over a slot KV cache.

    q: [S, H, Dh] — one new query token per slot.
    k, v: [S, H, T, Dh] — the slot cache; positions >= lengths[s] are
        garbage and are hard-masked.
    lengths: [S] int — per-slot live KV length including the position
        this query's K/V was just written to.  0 = free slot → exact-zero
        output.

    ``impl``: ``'pallas'`` (the hand-written kernel on CUDA, its plain
    version on the CPU) or ``'dense'`` (the dense reference).
    """
    assert q.ndim == 3 and k.ndim == 4, (tuple(q.shape), tuple(k.shape))
    S, H, T, Dh = k.shape
    assert tuple(q.shape) == (S, H, Dh), (tuple(q.shape), tuple(k.shape))
    if sm_scale is None:
        sm_scale = _default_scale(Dh)
    if impl == "dense":
        return decode_attention_reference(q, k, v, lengths,
                                          sm_scale=sm_scale)
    if impl != "pallas":
        raise ValueError(
            f"decode_attention impl={impl!r}: expected 'pallas' or "
            "'dense'")
    if q.is_cuda:
        return decode_attention_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(),
            lengths.to(torch.int32).contiguous(), sm_scale)
    return decode_attention_plain(q, k, v, lengths, sm_scale)


#: kernel launches since the count was last set to 0 (one per call that
#: reached the CUDA kernel; the plain version never counts)
decode_attention.launches = 0
