"""Flash attention, forward and backward: the three hand-written Hopper
kernels, their plain PyTorch versions and the autograd Function over them.

Port of ``deepspeed_tpu/ops/pallas/flash_attention.py``: ``flash_attention``
and ``mha``, the ``_flash`` custom_vjp (``_flash_fwd``/``_flash_bwd``) and
the three kernels it launches.  On a CUDA tensor the forward launches
``csrc/flash_fwd.cu`` and the backward ``csrc/flash_bwd_dq.cu`` and
``csrc/flash_bwd_dkv.cu``; on a CPU tensor each runs its plain PyTorch
version (the CPU tests' path and the kernels' yardstick on the card).
There is no fallback: a CUDA tensor reaches its kernel or the call raises.

All three kernels cover every arm of the JAX kernels: causal and
non-causal, ``kv_length``, the additive key mask, the in-kernel position
hash dropout (bit-exact with the JAX package's ``dropout_keep_mask``, so
the backward regenerates the forward's mask instead of storing it),
``bh_affine`` head ids and the dead-row rule.  In bf16 and fp16 all three
run on the tensor cores (wgmma, TMA; ``csrc/flash_sm90.cuh``) and need
16-byte aligned bases; fp32 runs FMA kernels.
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
#: the only head_dim the kernels take (every GPT-2 size uses 64)
HEAD_DIM = 64

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the dtypes whose kernels (tensor-core arms) load q, k, v and dO by TMA
_TMA_DTYPES = (torch.bfloat16, torch.float16)
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


def keep_threshold(rate: float) -> int:
    """The uint32 keep threshold of ``rate``: a hash at or above it keeps
    its element.  Computed on the host exactly as the JAX package does
    (``round``, saturating at 2**32 - 1) and handed to the kernels as an
    integer — never derived from a float on the device."""
    return min(round(rate * 2.0 ** 32), 2 ** 32 - 1)


def dropout_keep_mask(q_ids, k_ids, bh, seed, rate: float) -> torch.Tensor:
    """Counter-based keep mask: a uint32 hash of (batch·head, q position,
    k position, seed) compared against ``rate`` — bit-equal to the JAX
    package's ``dropout_keep_mask``.  Arguments broadcast (int64)."""
    x = (_mul32(q_ids, 0x9E3779B9) + k_ids) & _M32
    x = x ^ _mul32(bh, 0x85EBCA6B)
    x = _fmix32(x ^ (int(seed) & _M32))
    return x >= keep_threshold(rate)


def grid_bh_ids(n: int, bh_affine=None, device=None) -> torch.Tensor:
    """The hash's batch·head id of each of the ``n`` grid rows:
    ``base + (g // period) * stride + g % period`` (the JAX package's
    ``_grid_bh``); ``bh_affine=None`` is ``arange(n)``."""
    base, period, stride = _affine(n, bh_affine)
    g = torch.arange(n, device=device)
    return (base + (g // period) * stride + g % period) & _M32


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


def _affine(n: int, bh_affine):
    base, period, stride = bh_affine if bh_affine is not None else (0, n, 0)
    if int(period) < 1:
        raise ValueError(f"bh_affine period must be >= 1, got {period}")
    return int(base) & _M32, int(period), int(stride) & _M32


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _scores(q, k, causal, sm_scale, kv_length, kmask):
    """``_masked_scores`` over the whole [B, H, Tq, Tk] grid, in fp32."""
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
    return torch.where(valid, s, torch.full_like(s, NEG_INF))


def _drop_scale(q, tk, dropout_rate, seed, bh_affine):
    """keep / (1 - rate) over the [B, H, Tq, Tk] grid, or None."""
    if dropout_rate <= 0.0:
        return None
    B, H, T, _ = q.shape
    keep = dense_keep_mask(B, H, T, tk, seed, dropout_rate,
                           grid_bh_ids(B * H, bh_affine, q.device), q.device)
    return keep / (1.0 - dropout_rate)


def flash_attention_plain(q, k, v, causal: bool, sm_scale: float,
                          kv_length: Optional[int] = None, kmask=None,
                          dropout_rate: float = 0.0, seed: int = 0,
                          bh_affine=None):
    """The forward kernel's function in plain PyTorch: ``(out [B,H,T,Dh]
    in q.dtype, lse [B,H,T] fp32)``.  Scores, softmax statistics and the
    value product run in fp32 whatever the input dtype: the fp32 kernel's
    arithmetic, and within rounding the bf16/fp16 kernel's (its products
    take bf16/fp16 operands, P as two terms of the input type, ~16 bits).
    ``kmask``: optional additive fp32 key mask [B·H, Tk]."""
    s = _scores(q, k, causal, sm_scale, kv_length, kmask)
    m = s.amax(dim=-1, keepdim=True)
    dead = m <= DEAD_ROW_THRESH
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    scale = _drop_scale(q, k.shape[2], dropout_rate, seed, bh_affine)
    if scale is not None:
        p = p * scale
    out = torch.matmul(p, v.float()) / l
    out = torch.where(dead, torch.zeros_like(out), out).to(q.dtype)
    lse = torch.where(dead[..., 0], torch.full_like(m[..., 0], DEAD_LSE),
                      m[..., 0] + torch.log(l[..., 0]))
    return out, lse


def _bwd_terms(q, k, v, do, lse, delta, causal, sm_scale, kv_length, kmask,
               dropout_rate, seed, bh_affine):
    """(p·r, ds) of the backward in fp32, r = keep/(1-rate) or 1."""
    s = _scores(q, k, causal, sm_scale, kv_length, kmask)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    pd = p
    scale = _drop_scale(q, k.shape[2], dropout_rate, seed, bh_affine)
    if scale is not None:
        pd = p * scale
        dp = dp * scale
    ds = p * (dp - delta[..., None]) * sm_scale
    return pd, ds


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool,
                       sm_scale: float, kv_length: Optional[int] = None,
                       kmask=None, dropout_rate: float = 0.0, seed: int = 0,
                       bh_affine=None):
    """The dQ kernel's function in plain PyTorch: ``dq = ds · K`` with
    ``ds = p (dp − delta) sm_scale`` recomputed from the saved ``lse``
    ([B,H,T] fp32) and ``delta = rowsum(dO·O)``; fp32 inside, dQ in
    q.dtype (the bf16/fp16 kernel rounds ds to the input type before
    ``ds · K``, as the JAX kernel does)."""
    _, ds = _bwd_terms(q, k, v, do, lse, delta, causal, sm_scale, kv_length,
                       kmask, dropout_rate, seed, bh_affine)
    return torch.matmul(ds, k.float()).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool,
                        sm_scale: float, kv_length: Optional[int] = None,
                        kmask=None, dropout_rate: float = 0.0, seed: int = 0,
                        bh_affine=None):
    """The dK/dV kernel's function in plain PyTorch: ``(dk, dv)`` with
    ``dv = (p·r)ᵀ · dO`` and ``dk = dsᵀ · Q``; fp32 inside, results in
    k.dtype / v.dtype."""
    pd, ds = _bwd_terms(q, k, v, do, lse, delta, causal, sm_scale,
                        kv_length, kmask, dropout_rate, seed, bh_affine)
    dv = torch.matmul(pd.transpose(-1, -2), do.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

_PTR, _INT, _UINT, _FLOAT = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                             ctypes.c_float)
#: kmask pointer, then bh, tq, tk, kv_len, sm_scale, causal, dropout, seed,
#: thresh, keep_div, bh_base, bh_period, bh_stride, dtype, stream
_TAIL = [_PTR] + [_INT] * 4 + [_FLOAT, _INT, _INT, _UINT, _UINT, _FLOAT,
                               _UINT, _INT, _UINT, _INT, _PTR]
_N_TENSORS = {"flash_fwd": 5, "flash_bwd_dq": 7, "flash_bwd_dkv": 8}


def _load(name: str):
    lib = build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = [_PTR] * _N_TENSORS[name] + _TAIL
        fn.restype = ctypes.c_int
    return fn


def _check(fn: str, **tensors) -> None:
    """Device, dtype, contiguity and head_dim of a kernel's tensors."""
    q = tensors["q"]
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{fn}: {name} is on {t.device}, not a CUDA "
                             "device")
        if t.device != q.device:
            raise ValueError(f"{fn}: every tensor must be on one device")
        want = torch.float32 if name in ("lse", "delta", "kmask") else q.dtype
        if t.dtype != want or (want is q.dtype
                               and t.dtype not in _DTYPE_CODES):
            raise TypeError(f"{fn}: {name} has dtype {t.dtype}; q, k, v "
                            f"(and dO) share one of {list(_DTYPE_CODES)}, "
                            "lse, delta and kmask are float32")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")
        if t.dtype in _TMA_DTYPES and t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} starts at a pointer that is not "
                             "16-byte aligned; the bf16/fp16 kernels read it "
                             "through TMA")
    B, H, T, Dh = q.shape
    k, v = tensors["k"], tensors["v"]
    tk = k.shape[2]
    if Dh != HEAD_DIM or k.shape != (B, H, tk, Dh) or v.shape != k.shape:
        raise ValueError(
            f"{fn}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}; the kernel takes [B, H, T, {HEAD_DIM}] "
            "with k and v of one shape")
    km = tensors.get("kmask")
    if km is not None and km.shape != (B * H, tk):
        raise ValueError(f"{fn}: kmask {tuple(km.shape)} is not "
                         f"[B*H, Tk] = {(B * H, tk)}")


def _launch(name: str, tensors, q, tk: int, causal, sm_scale, kv_length,
            kmask, dropout_rate, seed, bh_affine) -> None:
    B, H, T, _ = q.shape
    base, period, stride = _affine(B * H, bh_affine)
    fn = _load(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*[t.data_ptr() for t in tensors],
                None if kmask is None else kmask.data_ptr(),
                B * H, T, tk, tk if kv_length is None else int(kv_length),
                float(sm_scale), int(causal), int(dropout_rate > 0.0),
                int(seed) & _M32, keep_threshold(dropout_rate),
                1.0 - dropout_rate, base, period, stride,
                _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def flash_attention_cuda(q, k, v, causal: bool, sm_scale: float,
                         kv_length: Optional[int] = None, kmask=None,
                         dropout_rate: float = 0.0, seed: int = 0,
                         bh_affine=None):
    """Launch ``csrc/flash_fwd.cu`` on contiguous CUDA tensors q
    [B,H,T,64] and k/v [B,H,Tk,64] of one dtype (fp32, bf16 or fp16), with
    an optional fp32 ``kmask`` [B·H, Tk].  Returns ``(out [B,H,T,64] in
    q.dtype, lse [B,H,T] fp32)``; raises on anything the kernel does not
    take and on a failed launch."""
    extra = {} if kmask is None else {"kmask": kmask}
    _check("flash_attention_cuda", q=q, k=k, v=v, **extra)
    B, H, T, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    _launch("flash_fwd", (q, k, v, out, lse), q, k.shape[2], causal,
            sm_scale, kv_length, kmask, dropout_rate, seed, bh_affine)
    flash_attention.launches += 1
    return out, lse


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal: bool,
                      sm_scale: float, kv_length: Optional[int] = None,
                      kmask=None, dropout_rate: float = 0.0, seed: int = 0,
                      bh_affine=None):
    """Launch ``csrc/flash_bwd_dq.cu``: dQ [B,H,T,64] in q.dtype from q,
    k, v, dO (one dtype, contiguous) and fp32 lse/delta [B,H,T]."""
    extra = {} if kmask is None else {"kmask": kmask}
    _check("flash_bwd_dq_cuda", q=q, k=k, v=v, do=do, lse=lse,
           delta=delta, **extra)
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    _launch("flash_bwd_dq", (q, k, v, do, lse, delta, dq), q, k.shape[2],
            causal, sm_scale, kv_length, kmask, dropout_rate, seed,
            bh_affine)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal: bool,
                       sm_scale: float, kv_length: Optional[int] = None,
                       kmask=None, dropout_rate: float = 0.0, seed: int = 0,
                       bh_affine=None):
    """Launch ``csrc/flash_bwd_dkv.cu``: ``(dk, dv)`` [B,H,Tk,64] in the
    input dtype, from the same operands as :func:`flash_bwd_dq_cuda`."""
    extra = {} if kmask is None else {"kmask": kmask}
    _check("flash_bwd_dkv_cuda", q=q, k=k, v=v, do=do, lse=lse,
           delta=delta, **extra)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    _launch("flash_bwd_dkv", (q, k, v, do, lse, delta, dk, dv), q,
            k.shape[2], causal, sm_scale, kv_length, kmask, dropout_rate,
            seed, bh_affine)
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_bwd_dq(q, *args, **kwargs):
    """dQ: the kernel on a CUDA tensor, its plain version on a CPU one."""
    fn = flash_bwd_dq_cuda if q.is_cuda else flash_bwd_dq_plain
    return fn(q, *args, **kwargs)


def flash_bwd_dkv(q, *args, **kwargs):
    """(dK, dV): the kernel on a CUDA tensor, its plain version on a CPU
    one."""
    fn = flash_bwd_dkv_cuda if q.is_cuda else flash_bwd_dkv_plain
    return fn(q, *args, **kwargs)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class _Flash(torch.autograd.Function):
    """The JAX package's ``_flash`` custom_vjp: the forward saves q, k, v,
    out and lse; the backward computes ``delta = rowsum(dO·O)`` in fp32
    and runs the dQ and dK/dV kernels.  The key mask, the seed and the
    head ids get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kmask, causal, sm_scale, kv_length,
                dropout_rate, seed, bh_affine):
        args = (causal, sm_scale, kv_length, kmask, dropout_rate, seed,
                bh_affine)
        fwd = flash_attention_cuda if q.is_cuda else flash_attention_plain
        out, lse = fwd(q, k, v, *args)
        ctx.save_for_backward(q, k, v, out, lse, kmask)
        ctx.args = args[:3] + args[4:]
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, kmask = ctx.saved_tensors
        causal, sm_scale, kv_length, dropout_rate, seed, bh_affine = ctx.args
        do = do.contiguous()
        delta = (do.float() * out.float()).sum(-1)
        args = (causal, sm_scale, kv_length, kmask, dropout_rate, seed,
                bh_affine)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, *args)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, *args)
        return dq, dk, dv, None, None, None, None, None, None, None


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def _key_mask(key_mask, b, h, tk, device):
    """A [B, Tk] or [B·H, Tk] boolean (True = attend) or additive mask as
    the kernels' fp32 [B·H, Tk] additive row."""
    km = torch.as_tensor(key_mask, device=device)
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
    return km.reshape(b * h, tk).contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    sm_scale: Optional[float] = None,
                    dropout_rate: float = 0.0,
                    dropout_rng: Optional[torch.Generator] = None,
                    dropout_seed=None,
                    bh_affine=None,
                    key_mask=None,
                    kv_length: Optional[int] = None) -> torch.Tensor:
    """Flash attention over [B, H, T, Dh] inputs (differentiable) — the
    JAX package's ``flash_attention`` minus its TPU tiling and
    interpret-mode arguments (``block_q``, ``block_k``, ``interpret``):
    the kernels' tiles are fixed and they never run in an interpreter.

    ``dropout_rate > 0`` drops attention probabilities inside the kernel
    with the position hash, seeded by ``dropout_seed`` (a host integer,
    uint32) or by one draw from ``dropout_rng``, a CPU
    ``torch.Generator`` (drawn on the host: a seed read back from the
    card would stall it).  ``bh_affine = (base, period, stride)`` maps
    row g of the [B·H] grid to the hash's id ``base + (g // period) *
    stride + g % period``.  ``key_mask``: [B, Tk] or [B·H, Tk], boolean
    (True = attend) or additive float.  ``kv_length``: static live length
    of k/v — keys at or past it are hard-masked; out-of-range values
    raise.  Rows with no valid key output exact zeros with zero
    gradients.
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
    seed = 0
    if dropout_rate > 0.0:
        if dropout_seed is not None:
            seed = int(dropout_seed) & _M32
        else:
            assert dropout_rng is not None, \
                "dropout_rate > 0 requires dropout_rng or dropout_seed"
            if dropout_rng.device.type != "cpu":
                raise ValueError(
                    "dropout_rng must be a CPU torch.Generator (the seed is "
                    "drawn on the host); pass dropout_seed for a seed you "
                    "derive yourself")
            seed = int(torch.randint(0, 2 ** 32, (), generator=dropout_rng))
    kmask = (None if key_mask is None
             else _key_mask(key_mask, b, h, tk, q.device))
    return _Flash.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                        kmask, causal, sm_scale, kv_length, dropout_rate,
                        seed, bh_affine)


def mha(q, k, v, dropout_rate: float = 0.0, dropout_rng=None,
        causal: bool = True, **kwargs):
    """The model-facing alias (the JAX package's ``mha``): dropout runs
    inside the flash kernel."""
    return flash_attention(q, k, v, causal=causal,
                           dropout_rate=dropout_rate,
                           dropout_rng=dropout_rng, **kwargs)


#: kernel launches since each count was last set to 0 (one per call that
#: reached the CUDA kernel; the plain versions never count)
flash_attention.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0
