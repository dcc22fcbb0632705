"""Int8 quantization for the serving plane — the port of
``deepspeed_tpu/inference/quantize.py`` (docs/serving.md, "quantized
serving").

Two independent arms behind ``serving.quantization``:

**Weights** (LLM.int8, Dettmers et al. 2022): one-shot post-load symmetric
per-OUTPUT-CHANNEL absmax quantization of the GPT-2 matmul weights (qkv,
out, fc, proj).  ``scale[c] = absmax(w[:, c]) / 127`` over the contraction
axis, so the serving matmuls apply it to their output: ``(x · w8) * s``
(``models/gpt2.py::_wscale``).  Embeddings, layer norms and biases keep
the master dtype.

**KV rows** (per-head row scaling): the paged pool stores int8 K/V rows
with one fp32 scale per (page, head, row), quantized at write time
(:func:`quantize_rows`, on the device inside the serving steps) and
folded into the int8 arms of the paged decode kernels.

Both quantizers work in fp32 and round half to even (``torch.round``, as
``jnp.round``), so the port's int8 values equal the JAX package's on the
same input.  Under a serving mesh the whole tree is quantized first and
then split (:func:`quantized_partition_specs`), so each scale is the
absmax over its whole contraction axis.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

#: the GPT-2 block matmul weights the int8 arm covers; each stores its
#: input features on axis 1 (after the stacked layer axis)
QUANT_WEIGHT_KEYS = ("qkv_w", "out_w", "fc_w", "proj_w")
_CONTRACT_AXIS = 1
SCALE_SUFFIX = "_scale"


def _scale_of(absmax: torch.Tensor) -> torch.Tensor:
    """absmax/127 in fp32; an all-zero row or channel gets 1.0."""
    return torch.where(absmax > 0, absmax / 127.0,
                       torch.ones_like(absmax))


def quantize_channels(w: torch.Tensor, axis: int = _CONTRACT_AXIS
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8: reduce ``axis`` (keepdim, so the
    scale broadcasts back), round to nearest even into [-127, 127].
    ``|q * scale - w| <= scale / 2``."""
    w32 = w.float()
    scale = _scale_of(w32.abs().amax(dim=axis, keepdim=True))
    q = torch.round(w32 / scale).clamp(-127, 127)
    return q.to(torch.int8), scale


def dequantize_channels(q: torch.Tensor, scale: torch.Tensor
                        ) -> torch.Tensor:
    return q.float() * scale


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last axis) symmetric int8 for KV rows: ``x [..., Dh]`` ->
    ``(q int8 [..., Dh], scale fp32 [...])``; all-zero rows get scale 1.0.
    Runs on ``x``'s device with no host sync."""
    x32 = x.float()
    scale = _scale_of(x32.abs().amax(dim=-1))
    q = torch.round(x32 / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_rows`: ``q [..., Dh] * scale [...]`` in
    fp32 — the one dequant rule the dense reference, the plain versions of
    the int8 kernel arms and the prefill's gather arm share."""
    return q.float() * scale[..., None]


def quantize_gpt2_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """One-shot post-load quantization of a GPT-2 parameter tree: each
    block matmul weight becomes int8 with an ``<name>_scale`` fp32 sibling
    (keepdim over the contraction axis).  The input tree is not mutated;
    the other leaves are passed through (the same tensors).  Works on the
    target and the speculative draft alike."""
    blocks = dict(params["blocks"])
    for name in QUANT_WEIGHT_KEYS:
        q, scale = quantize_channels(blocks[name])
        blocks[name] = q
        blocks[name + SCALE_SUFFIX] = scale
    out = dict(params)
    out["blocks"] = blocks
    return out


def quantized_partition_specs(pspecs: Dict[str, Any]) -> Dict[str, Any]:
    """Partition specs matching :func:`quantize_gpt2_params` (specs are
    tuples of axis names per dim): each scale inherits its weight's spec
    with the contracted (now size-1) axis unsharded — the output-channel
    shard stays aligned with the Megatron column split, so a TP shard
    holds exactly the scales of the channels it computes."""
    blocks = dict(pspecs["blocks"])
    for name in QUANT_WEIGHT_KEYS:
        axes = list(tuple(blocks[name]))
        while len(axes) <= _CONTRACT_AXIS:
            axes.append(None)
        axes[_CONTRACT_AXIS] = None
        blocks[name + SCALE_SUFFIX] = tuple(axes)
    out = dict(pspecs)
    out["blocks"] = blocks
    return out


def param_nbytes(tree) -> int:
    """Total bytes of every tensor leaf (int8 leaves count one byte per
    element) — the engine's ``param_bytes``."""
    if isinstance(tree, dict):
        return sum(param_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()
