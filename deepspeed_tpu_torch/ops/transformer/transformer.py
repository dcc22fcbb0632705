"""DeepSpeed transformer layer — the port of
``deepspeed_tpu/ops/transformer/transformer.py``, the BERT encoder block.

What is kept from the JAX layer:

- the math: BERT self-attention and FFN, pre- or post-LN, the additive
  attention mask, fp32 softmax and LayerNorm (eps 1e-12) for
  low-precision inputs;
- the config surface (``DeepSpeedTransformerConfig``, key for key, with
  ``from_dict`` and ``from_json_file``);
- the two attention arms: ``flash`` runs the flash kernels
  (``ops/kernels/flash_attention.py``, non-causal, the mask as the
  kernels' additive key mask, attention dropout hashed in-kernel) and
  ``dense`` the softmax in torch ops;
- the memory knobs: ``normalize_invertible``, ``gelu_checkpoint`` and
  ``attn_dropout_checkpoint`` recompute the same segments in the backward
  pass (``torch.utils.checkpoint``) instead of saving their
  intermediates.  ``stochastic_mode`` is only recorded.

Randomness: ``rng`` is a host integer seed (``runtime/module.py``); the
attention and the two hidden dropouts derive theirs with
``runtime.utils.fold_in``, so a checkpointed recompute replays them.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...parallel import collectives as col
from ...parallel.mesh import DATA_AXIS, MODEL_AXIS
from ...runtime.utils import (data_rows, dropout, fold_in,
                              seeded_generator)
from ..kernels.flash_attention import flash_attention

_M32 = 0xFFFFFFFF


@dataclasses.dataclass
class DeepSpeedTransformerConfig:
    """Key-for-key port of the JAX package's config (the reference's
    transformer.py:93-134 there)."""
    batch_size: int = -1
    max_seq_length: int = -1
    hidden_size: int = -1
    intermediate_size: int = -1
    heads: int = -1
    attn_dropout_ratio: float = 0.0
    hidden_dropout_ratio: float = 0.0
    num_hidden_layers: int = -1
    initializer_range: float = 0.02
    local_rank: int = -1          # accepted for parity; no device meaning
    seed: int = -1
    fp16: bool = False            # parity alias: prefer bf16 params
    pre_layer_norm: bool = True
    normalize_invertible: bool = False
    gelu_checkpoint: bool = False
    adjust_init_range: bool = True
    attn_dropout_checkpoint: bool = False
    stochastic_mode: bool = False
    # 'flash' (the CUDA kernels, O(T·D) memory) | 'dense' (torch softmax)
    attn_impl: str = "flash"

    def __post_init__(self):
        if self.intermediate_size <= 0 < self.hidden_size:
            self.intermediate_size = 4 * self.hidden_size

    @classmethod
    def from_dict(cls, json_object: Dict[str, Any]):
        cfg = cls()
        for k, v in json_object.items():
            setattr(cfg, k, v)
        cfg.__post_init__()  # re-derive intermediate_size from hidden_size
        return cfg

    @classmethod
    def from_json_file(cls, json_file: str):
        with open(json_file, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))


def _layer_norm(x, scale, bias, eps: float = 1e-12):
    """LayerNorm accumulated in fp32 whatever x's dtype; BERT's eps."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _head_dropout(probs, rate: float, seed, mesh, heads: int):
    """:func:`dropout` of the rank's rows and heads of ``probs`` [B,
    H/tp, Tq, Tk] under a mesh: the mask is drawn over the global rows
    and all ``heads`` and the rank keeps its own, so it does not depend
    on the layout."""
    if rate <= 0.0:
        return probs
    B, H = probs.shape[:2]
    r0, rows = data_rows(mesh, B)
    keep = torch.rand((rows, heads) + tuple(probs.shape[2:]),
                      generator=seeded_generator(seed, probs.device),
                      device=probs.device) < 1.0 - rate
    h0 = mesh.axis_index(MODEL_AXIS) * H
    return torch.where(keep[r0:r0 + B, h0:h0 + H], probs / (1.0 - rate),
                       0.0).to(probs.dtype)


def _maybe_checkpoint(fn, on: bool):
    """``fn`` recomputed in the backward pass when ``on`` (and autograd is
    recording), else ``fn`` itself."""
    if not on:
        return fn

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        # fn draws no global RNG (its seeds are host integers)
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)

    return wrapped


class DeepSpeedTransformerLayer:
    """Functional BERT encoder layer.

    ``__call__(params, hidden_states, attention_mask, rng, train)`` with
    hidden_states [B, T, d] and an additive attention mask broadcastable
    to [B, 1, 1, T] (HF convention: 0 keep, large-negative drop).
    Parameter names follow the reference layer's: attn_qkvw [d, 3, d] /
    attn_qkvb [3, d], attn_ow/attn_ob, attn_nw/attn_nb (attention LN),
    inter_w/inter_b, output_w/output_b, norm_w/norm_b (output LN).
    """

    def __init__(self, config: DeepSpeedTransformerConfig,
                 initial_weights: Optional[Dict[str, Any]] = None):
        assert config.hidden_size > 0, "hidden_size must be set"
        assert config.heads > 0, "heads must be set"
        assert config.hidden_size % config.heads == 0, \
            f"hidden {config.hidden_size} not divisible by heads {config.heads}"
        if config.attn_impl not in ("flash", "dense"):
            raise ValueError(f"attn_impl={config.attn_impl!r}: expected "
                             "'flash' or 'dense'")
        self.config = config
        self.initial_weights = initial_weights

    def init(self, seed: int, device=None) -> Dict[str, torch.Tensor]:
        """Random parameters from ``seed`` (a ``torch.Generator`` on
        ``device``): the JAX init's distributions (normal
        ``initializer_range``, the two output projections scaled by
        1/sqrt(2L) under ``adjust_init_range``, unit LN scales, zero
        biases), not its numbers."""
        if self.initial_weights is not None:
            return dict(self.initial_weights)
        cfg = self.config
        device = torch.device("cpu" if device is None else device)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        d, i = cfg.hidden_size, cfg.intermediate_size
        std = out_std = cfg.initializer_range
        if cfg.adjust_init_range and cfg.num_hidden_layers > 0:
            out_std = std / math.sqrt(2.0 * cfg.num_hidden_layers)

        def norm(shape, s):
            return torch.randn(shape, generator=gen, device=device) * s

        def const(shape, value):
            return torch.full(shape, value, device=device)

        return {
            "attn_qkvw": norm((d, 3, d), std),
            "attn_qkvb": const((3, d), 0.0),
            "attn_ow": norm((d, d), out_std),
            "attn_ob": const((d,), 0.0),
            "attn_nw": const((d,), 1.0),
            "attn_nb": const((d,), 0.0),
            "inter_w": norm((d, i), std),
            "inter_b": const((i,), 0.0),
            "output_w": norm((i, d), out_std),
            "output_b": const((d,), 0.0),
            "norm_w": const((d,), 1.0),
            "norm_b": const((d,), 0.0),
        }

    @staticmethod
    def _key_mask_rows(attention_mask, B, H, T):
        """HF additive mask (broadcastable to [B, 1|H, 1, T]) → [B, T]
        (shared across heads) or [B·H, T] (per-head) additive fp32 rows
        for the flash kernels' key mask.  A mask with a query dimension is
        not a key mask: use attn_impl='dense' for those."""
        m = torch.as_tensor(attention_mask)
        while m.ndim < 4:
            m = m[:, None]
        if m.shape[2] != 1:
            raise ValueError(
                f"attn_impl='flash' supports key-padding masks "
                f"(broadcastable to [B, 1|H, 1, T]); got mask shape "
                f"{tuple(attention_mask.shape)} with a q-position dimension "
                "— use attn_impl='dense' for arbitrary 2-D masks")
        if m.shape[1] == 1:
            return m[:, 0, 0, :].expand(B, T).float()
        return m[:, :, 0, :].expand(B, H, T).reshape(B * H, T).float()

    def _attention(self, params, h, attention_mask, rng, train, mesh=None):
        """Self-attention; under ``mesh`` (Megatron tensor parallelism)
        ``attn_qkvw`` is the rank's column piece (its heads), ``attn_ow``
        its row piece, the partial output all-reduced over ``model``."""
        cfg = self.config
        B, T, D = h.shape
        Dh = D // cfg.heads
        H = params["attn_qkvw"].shape[-1] // Dh         # the rank's heads
        rate = cfg.attn_dropout_ratio if train else 0.0
        if mesh is not None:
            h = col.copy_to_axis(h, mesh, MODEL_AXIS)
        qkv = (torch.einsum("btd,dke->btke", h, params["attn_qkvw"].to(h.dtype))
               + params["attn_qkvb"].to(h.dtype))

        def split(t):
            return t.reshape(B, T, H, Dh).transpose(1, 2)

        q, k, v = split(qkv[:, :, 0]), split(qkv[:, :, 1]), split(qkv[:, :, 2])
        if cfg.attn_impl == "flash":
            # the probabilities never exist in memory, forward or back:
            # attn_dropout_checkpoint holds by construction
            km = (None if attention_mask is None
                  else self._key_mask_rows(attention_mask, B, H, T))
            # the hash takes the global (batch, head) ids of the rank's
            # rows and heads
            bh = (None if mesh is None else
                  (mesh.axis_index(DATA_AXIS) * B * cfg.heads
                   + mesh.axis_index(MODEL_AXIS) * H, H, cfg.heads))
            ctx = flash_attention(
                q, k, v, causal=False, dropout_rate=rate,
                dropout_seed=None if rng is None else rng & _M32,
                key_mask=km, bh_affine=bh)
        else:
            def probs_ctx(q, k, v):
                scores = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                                      k.float()) * (float(Dh) ** -0.5)
                if attention_mask is not None:
                    mask = attention_mask.float()
                    while mask.ndim < 4:
                        mask = mask[:, None]
                    scores = scores + mask
                probs = torch.softmax(scores, dim=-1).to(q.dtype)
                probs = (dropout(probs, rate, rng) if mesh is None else
                         _head_dropout(probs, rate, rng, mesh, cfg.heads))
                return torch.einsum("bhqk,bhkd->bhqd", probs, v)

            ctx = _maybe_checkpoint(probs_ctx, cfg.attn_dropout_checkpoint)(
                q, k, v)
        ctx = ctx.transpose(1, 2).reshape(B, T, H * Dh)
        y = ctx @ params["attn_ow"].to(h.dtype)
        if mesh is not None:
            y = col.reduce_from_axis(y, mesh, MODEL_AXIS)
        return y + params["attn_ob"].to(h.dtype)

    def _ffn(self, params, h, mesh=None):
        """inter → gelu → output; under ``mesh`` ``inter_w`` is
        column-parallel and ``output_w`` row-parallel (all-reduce over
        ``model`` before the bias)."""
        def inner(h):
            x = h @ params["inter_w"].to(h.dtype) \
                + params["inter_b"].to(h.dtype)
            return F.gelu(x, approximate="none")

        if mesh is not None:
            h = col.copy_to_axis(h, mesh, MODEL_AXIS)
        x = _maybe_checkpoint(inner, self.config.gelu_checkpoint)(h)
        y = x @ params["output_w"].to(h.dtype)
        if mesh is not None:
            y = col.reduce_from_axis(y, mesh, MODEL_AXIS)
        return y + params["output_b"].to(h.dtype)

    def __call__(self, params, hidden_states, attention_mask=None,
                 rng: Optional[int] = None, train: bool = True, mesh=None):
        cfg = self.config
        x = hidden_states
        drop = cfg.hidden_dropout_ratio if train else 0.0
        if rng is None:
            rng = max(cfg.seed, 0)
        r_attn, r1, r2 = fold_in(rng, 0), fold_in(rng, 1), fold_in(rng, 2)
        rows = data_rows(mesh, x.shape[0])

        def ln1(t):
            return _layer_norm(t, params["attn_nw"], params["attn_nb"])

        def ln2(t):
            return _layer_norm(t, params["norm_w"], params["norm_b"])

        ln1 = _maybe_checkpoint(ln1, cfg.normalize_invertible)
        ln2 = _maybe_checkpoint(ln2, cfg.normalize_invertible)
        if cfg.pre_layer_norm:
            attn_out = self._attention(params, ln1(x), attention_mask,
                                       r_attn, train, mesh)
            x = x + dropout(attn_out, drop, r1, rows)
            ffn_out = self._ffn(params, ln2(x), mesh)
            return x + dropout(ffn_out, drop, r2, rows)
        # post-LN (classic BERT)
        attn_out = self._attention(params, x, attention_mask, r_attn, train,
                                   mesh)
        x = ln1(x + dropout(attn_out, drop, r1, rows))
        ffn_out = self._ffn(params, x, mesh)
        return ln2(x + dropout(ffn_out, drop, r2, rows))

    forward = __call__
