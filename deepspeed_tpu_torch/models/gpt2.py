"""GPT-2 serving model — the port of ``deepspeed_tpu/models/gpt2.py``'s
inference half.

The parameter tree keeps the JAX package's names, shapes and layouts
(layer-stacked blocks, ``qkv_w [L, d, 3, d]``), so weights move across
with :func:`params_from_numpy`, one copy per leaf.  The public functions
keep the JAX layouts too: attention tensors ``[B, H, T, Dh]``, the slot
cache ``[L, S, H, T, Dh]``.

Ported: ``GPT2Config``, ``GPT2Model.init/prefill/decode_step`` and the
block helpers they run.  The prefill attention is the flash kernel
(``ops/kernels/flash_attention.py``) on ``attn_impl="flash"`` and the
dense arm on ``"dense"``; the decode attention is
``ops/kernels/decode_attention.py``.  The large products (qkv, out, fc,
proj and the tied ``x @ wte.T``) stay ``torch.matmul``, as the JAX package
leaves them to XLA.  Not ported yet (ROADMAP.md queue 1): the training
forward, LoRA, int8 weights, the paged and speculative-verify paths and
the tensor-parallel specs.

Unlike the JAX functions, :func:`gpt2_decode_step` writes the new K/V rows
into the caches IN PLACE (a slot cache is the largest tensor of serving;
a functional copy per tick would double it) and returns the same tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.attention import causal_attention
from ..ops.kernels.decode_attention import decode_attention
from ..ops.kernels.flash_attention import flash_attention


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    d_model: int = 768
    n_layer: int = 12
    n_head: int = 12
    attn_impl: str = "flash"         # 'flash' (the CUDA kernel) | 'dense'

    @property
    def d_head(self) -> int:
        assert self.d_model % self.n_head == 0
        return self.d_model // self.n_head


# canned sizes (GPT-2 paper / Megatron perf ladder)
GPT2_SMALL = GPT2Config(d_model=768, n_layer=12, n_head=12)          # 124M
GPT2_MEDIUM = GPT2Config(d_model=1024, n_layer=24, n_head=16)        # 350M
GPT2_LARGE = GPT2Config(d_model=1280, n_layer=36, n_head=20)         # 774M
GPT2_XL = GPT2Config(d_model=1600, n_layer=48, n_head=25)            # 1.5B


class GPT2Model:
    """Causal LM with tied input/output embeddings (serving entry points)."""

    def __init__(self, config: GPT2Config):
        self.config = config

    def init(self, seed: int, device=None,
             dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
        """Random parameters from ``seed`` (an explicit ``torch.Generator``
        on ``device``): the JAX package's init distributions (normal 0.02,
        residual projections 0.02/sqrt(2L), unit LN scales, zero biases)
        — not its numbers, which come from ``jax.random``."""
        cfg = self.config
        d, L = cfg.d_model, cfg.n_layer
        device = torch.device("cpu" if device is None else device)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        std = 0.02
        resid_std = std / math.sqrt(2.0 * L)

        def norm(shape, s=std):
            w = torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * s
            return w.to(dtype)

        def const(shape, value):
            return torch.full(shape, value, device=device, dtype=dtype)

        return {
            "wte": norm((cfg.vocab_size, d)),
            "wpe": norm((cfg.n_positions, d)),
            "ln_f_scale": const((d,), 1.0),
            "ln_f_bias": const((d,), 0.0),
            "blocks": {
                "ln1_scale": const((L, d), 1.0),
                "ln1_bias": const((L, d), 0.0),
                "qkv_w": norm((L, d, 3, d)),
                "qkv_b": const((L, 3, d), 0.0),
                "out_w": norm((L, d, d), resid_std),
                "out_b": const((L, d), 0.0),
                "ln2_scale": const((L, d), 1.0),
                "ln2_bias": const((L, d), 0.0),
                "fc_w": norm((L, d, 4 * d)),
                "fc_b": const((L, 4 * d), 0.0),
                "proj_w": norm((L, 4 * d, d), resid_std),
                "proj_b": const((L, d), 0.0),
            },
        }

    def prefill(self, params, tokens):
        """Inference forward that also returns every layer's K/V (the
        serving cache fill) — see ``gpt2_prefill``."""
        return gpt2_prefill(self.config, params, tokens)

    def decode_step(self, params, tokens, k_cache, v_cache, lengths,
                    active, impl: Optional[str] = None):
        """One masked decode tick over the slot KV cache — see
        ``gpt2_decode_step``."""
        return gpt2_decode_step(self.config, params, tokens, k_cache,
                                v_cache, lengths, active, impl=impl)


def params_from_numpy(tree, device=None, dtype: Optional[torch.dtype] = None):
    """The port's parameter tree from ``GPT2Model.init``'s tree given as
    numpy arrays (``np.asarray`` of each JAX leaf): same names and shapes,
    one copy per leaf onto ``device``, cast to ``dtype`` when given."""
    if isinstance(tree, dict):
        return {name: params_from_numpy(sub, device, dtype)
                for name, sub in tree.items()}
    return torch.tensor(tree, device=device, dtype=dtype)


def _layer_norm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def gpt2_ffn(bp, h):
    """fc → gelu (tanh approximation) → proj over normalized input."""
    y = h @ bp["fc_w"].to(h.dtype) + bp["fc_b"].to(h.dtype)
    y = F.gelu(y, approximate="tanh")
    return y @ bp["proj_w"].to(h.dtype) + bp["proj_b"].to(h.dtype)


def gpt2_qkv_heads(cfg: GPT2Config, bp, x):
    """ln1 → fused qkv → per-head split, [B, H, T, Dh] each (views)."""
    B, T, D = x.shape
    H, Dh = cfg.n_head, cfg.d_head
    h = _layer_norm(x, bp["ln1_scale"], bp["ln1_bias"])
    w = bp["qkv_w"].to(h.dtype).reshape(D, 3 * D)
    qkv = (h @ w).view(B, T, 3, D) + bp["qkv_b"].to(h.dtype)

    def heads(t):
        return t.reshape(B, T, H, Dh).transpose(1, 2)

    return heads(qkv[:, :, 0]), heads(qkv[:, :, 1]), heads(qkv[:, :, 2])


def gpt2_attn_project(bp, x, attn):
    """heads → output projection → residual."""
    B, H, T, Dh = attn.shape
    attn = attn.transpose(1, 2).reshape(B, T, H * Dh)
    return x + attn @ bp["out_w"].to(x.dtype) + bp["out_b"].to(x.dtype)


def _decode_attn_impl(cfg: GPT2Config) -> str:
    """Map the model's attention impl onto the decode kernel arm."""
    if cfg.attn_impl == "flash":
        return "pallas"
    if cfg.attn_impl == "dense":
        return "dense"
    raise NotImplementedError(
        f"attn_impl={cfg.attn_impl!r} has no serving decode path; serve "
        "with 'flash' or 'dense'")


def _layer(blocks, i: int):
    return {name: a[i] for name, a in blocks.items()}


def gpt2_block_prefill(cfg: GPT2Config, bp, x):
    """One block at inference, also returning the per-head K/V."""
    q, k, v = gpt2_qkv_heads(cfg, bp, x)
    if cfg.attn_impl == "flash":
        attn = flash_attention(q, k, v, causal=True)
    elif cfg.attn_impl == "dense":
        attn = causal_attention(q, k, v)
    else:
        _decode_attn_impl(cfg)  # raises with the real story
    x = gpt2_attn_project(bp, x, attn)
    h = _layer_norm(x, bp["ln2_scale"], bp["ln2_bias"])
    return x + gpt2_ffn(bp, h), (k, v)


def _cache_write(cache, new, pos, active):
    """Masked IN-PLACE write of one token's K (or V) rows into the slot
    cache: ``cache[s, :, pos[s]] = new[s]`` where ``active[s]``; inactive
    slots write their old value back.  cache [S, H, T, Dh], new [S, H,
    Dh], pos [S] (clipped), active [S] bool."""
    S, H, T, Dh = cache.shape
    s_idx = torch.arange(S, device=cache.device)
    pos = pos.long().clamp(0, T - 1)
    old = cache[s_idx, :, pos]                          # [S, H, Dh]
    cache[s_idx, :, pos] = torch.where(active[:, None, None],
                                       new.to(cache.dtype), old)
    return cache


def gpt2_block_decode(cfg: GPT2Config, bp, x, k_cache, v_cache,
                      positions, att_len, active, impl: str):
    """One block for a single decode tick: x [S, 1, D]; writes the token's
    K/V at ``positions`` (masked by ``active``) then attends over
    ``att_len`` live keys per slot."""
    q, k, v = gpt2_qkv_heads(cfg, bp, x)                # [S, H, 1, Dh]
    _cache_write(k_cache, k[:, :, 0], positions, active)
    _cache_write(v_cache, v[:, :, 0], positions, active)
    attn = decode_attention(q[:, :, 0], k_cache, v_cache, att_len,
                            impl=impl)                  # [S, H, Dh]
    x = gpt2_attn_project(bp, x, attn[:, :, None, :])
    h = _layer_norm(x, bp["ln2_scale"], bp["ln2_bias"])
    return x + gpt2_ffn(bp, h)


@torch.no_grad()
def gpt2_prefill(cfg: GPT2Config, params, tokens):
    """tokens [B, T] → (logits [B, T, V], k, v [L, B, H, T, Dh]).  Causal
    masking means positions beyond a prompt's live length only
    contaminate their own rows — the cache masks them by length."""
    B, T = tokens.shape
    if T > cfg.n_positions:
        raise ValueError(
            f"sequence length {T} exceeds n_positions={cfg.n_positions}")
    tokens = tokens.long()
    x = params["wte"][tokens] + params["wpe"][:T][None]
    ks, vs = [], []
    for i in range(cfg.n_layer):
        x, (k, v) = gpt2_block_prefill(cfg, _layer(params["blocks"], i), x)
        ks.append(k)
        vs.append(v)
    x = _layer_norm(x, params["ln_f_scale"], params["ln_f_bias"])
    logits = x @ params["wte"].to(x.dtype).T
    return logits, torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def gpt2_decode_step(cfg: GPT2Config, params, tokens, k_cache, v_cache,
                     lengths, active, impl: Optional[str] = None):
    """One decode tick for every slot at once.

    tokens [S] — each slot's last emitted/prompt token; k_cache/v_cache
    [L, S, H, T, Dh], updated in place; lengths [S] — live KV length
    BEFORE this token; active [S] bool — slots actually decoding this
    tick (free/finished slots compute masked no-ops).

    Returns (logits [S, V], k_cache, v_cache, new_lengths); inactive
    slots' logits are garbage-but-finite and must be ignored."""
    if impl is None:
        impl = _decode_attn_impl(cfg)
    T = k_cache.shape[3]
    lengths = lengths.to(torch.int32)
    positions = lengths.clamp(0, min(T, cfg.n_positions) - 1)
    tokens = tokens.long()
    x = (params["wte"][tokens] + params["wpe"][positions.long()])[:, None]
    # live keys this tick include the token being decoded; free slots
    # attend nothing (exact-zero attention rows)
    att_len = torch.where(active, lengths + 1, 0).to(torch.int32)
    for i in range(cfg.n_layer):
        x = gpt2_block_decode(cfg, _layer(params["blocks"], i), x,
                              k_cache[i], v_cache[i], positions, att_len,
                              active, impl)
    x = _layer_norm(x, params["ln_f_scale"], params["ln_f_bias"])
    logits = (x @ params["wte"].to(x.dtype).T)[:, 0]
    new_lengths = lengths + active.to(torch.int32)
    return logits, k_cache, v_cache, new_lengths
