"""GPT-2 — the port of ``deepspeed_tpu/models/gpt2.py``: the training
forward and loss, and the serving prefill and decode step.

The parameter tree keeps the JAX package's names, shapes and layouts
(layer-stacked blocks, ``qkv_w [L, d, 3, d]``), so weights move across
with :func:`params_from_numpy`, one copy per leaf.  The public functions
keep the JAX layouts too: attention tensors ``[B, H, T, Dh]``, the slot
cache ``[L, S, H, T, Dh]``.

Ported: ``GPT2Config``, ``GPT2Model.init/apply/loss_fn/prefill/
decode_step/prefill_paged/decode_step_paged/verify_step/verify_step_paged``
and the block helpers they run.  The attention is the flash kernels
(``ops/kernels/flash_attention.py``: forward, and on the training path its
dQ and dK/dV backward kernels) on ``attn_impl="flash"`` and the dense arm
on ``"dense"``; the decode attention is ``ops/kernels/decode_attention.py``
(slot cache, paged pool, and their multi-query verify arms).  The large
products (qkv, out, fc, proj and the tied ``x @ wte.T``) stay
``torch.matmul``, as the JAX package leaves them to XLA.  Quantized
serving is ported: a parameter tree from ``inference.quantize.
quantize_gpt2_params`` (int8 matmul weights with ``<name>_scale``
siblings) runs through :func:`_wscale`, and the paged functions take the
int8 pool's ``k_scale``/``v_scale`` sidecars (quantize on write, the int8
kernel arms on read).  Multi-tenant LoRA is ported: the paged functions
take the layer-stacked adapter pools, each row's adapter slot and
``alpha/r`` (:func:`_lora_rows`, :func:`_lora_bind`), and every matmul
of a block adds its per-row delta ``(x·A)·B·(alpha/r)`` after the base
product (:func:`_lora_delta`; plain ``torch.bmm``, no kernel).  Megatron
tensor parallelism is ported (:meth:`GPT2Model.param_partition_specs`):
under the training engine's mesh the blocks run on the rank's pieces —
``qkv_w`` and ``fc_w`` column-parallel (the rank's heads ``r·H/tp …
(r+1)·H/tp``), ``out_w`` and ``proj_w`` row-parallel (all-reduce, then
the replicated bias), ``wte`` vocab-parallel where ``V % tp == 0`` (a
masked lookup plus all-reduce, and a vocab-parallel cross-entropy) and
replicated where it does not divide (GPT-2's 50257).  Not ported yet
(ROADMAP.md queue 1): sequence-parallel attention and parameter
streaming.

Randomness: ``rng`` is a host integer (``runtime/module.py``).  Each
block and dropout site derives its own seed with ``runtime.utils.fold_in``
(the counterpart of the JAX ``fold_in``/``split`` calls), and the hidden
dropouts build their ``torch.Generator`` from that seed inside the block,
so ``remat="block"`` (``torch.utils.checkpoint``) replays the same masks
when it recomputes a block.  The attention dropout is the flash kernel's
position hash, seeded by the same kind of integer.  Under a mesh the
hidden dropouts draw their mask over the global micro-batch's rows and
keep the rank's, and the flash hash takes the global (batch, head) ids
(``bh_affine``), so training does not depend on the layout.

Unlike the JAX functions, the serving steps (:func:`gpt2_decode_step`,
:func:`gpt2_verify_step`, their paged twins and :func:`gpt2_prefill_paged`)
write the new K/V rows into the caches and pools IN PLACE (a KV cache is
the largest tensor of serving; a functional copy per tick would double it)
and return the same tensors.  The paged prefill's ``lax.cond`` on the
cached prefix length is a host branch here: the engine knows
``prefix_len`` and ``delta_len`` on the host.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import causal_attention
from ..ops.kernels.decode_attention import (_default_scale,
                                            decode_attention,
                                            decode_attention_multi,
                                            decode_attention_paged,
                                            decode_attention_paged_multi,
                                            dequantize_paged, paged_gather)
from ..ops.kernels.flash_attention import flash_attention, mha
from ..runtime.module import TrainModule
from ..runtime.utils import dropout as _dropout
from ..parallel import collectives as col
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS
from ..runtime.utils import fold_in, params_from_numpy  # noqa: F401
from ..runtime.utils import seeded_generator as _generator

_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    """The JAX package's ``GPT2Config`` with its defaults.

    ``scan_layers`` changes nothing here: eager PyTorch runs the layers as
    a Python loop either way (the JAX flag chose between ``lax.scan`` and
    an unrolled trace).  ``stream_scan=True`` (one layer's parameters
    fetched per tick) is not ported and raises."""
    vocab_size: int = 50257
    n_positions: int = 1024
    d_model: int = 768
    n_layer: int = 12
    n_head: int = 12
    dropout: float = 0.0
    embd_dropout: float = 0.0
    remat: Optional[str] = "block"   # None | 'block'
    attn_impl: str = "flash"         # 'flash' (the CUDA kernels) | 'dense'
    scan_layers: bool = True
    stream_scan: bool = False

    def __post_init__(self):
        if self.stream_scan:
            raise NotImplementedError(
                "GPT2Config.stream_scan (per-layer parameter streaming) is "
                "not ported to deepspeed_tpu_torch yet: ROADMAP.md queue 1, "
                "item 12 (offload and input pipeline)")
        if self.remat not in (None, "block"):
            raise ValueError(f"remat={self.remat!r}: expected None or "
                             "'block'")

    @property
    def d_head(self) -> int:
        assert self.d_model % self.n_head == 0
        return self.d_model // self.n_head

    @property
    def num_params(self) -> int:
        d, L, V, Tmax = (self.d_model, self.n_layer, self.vocab_size,
                         self.n_positions)
        per_block = (4 * d  # ln scales/biases
                     + d * 3 * d + 3 * d      # qkv
                     + d * d + d              # attn out
                     + d * 4 * d + 4 * d      # fc
                     + 4 * d * d + d)         # proj
        return V * d + Tmax * d + L * per_block + 2 * d


# canned sizes (GPT-2 paper / Megatron perf ladder)
GPT2_SMALL = GPT2Config(d_model=768, n_layer=12, n_head=12)          # 124M
GPT2_MEDIUM = GPT2Config(d_model=1024, n_layer=24, n_head=16)        # 350M
GPT2_LARGE = GPT2Config(d_model=1280, n_layer=36, n_head=20)         # 774M
GPT2_XL = GPT2Config(d_model=1600, n_layer=48, n_head=25)            # 1.5B


class GPT2Model(TrainModule):
    """Causal LM with tied input/output embeddings and next-token loss."""

    #: the layer-stacked subtree the training engine fetches one layer at
    #: a time (``runtime/zero.py``)
    stacked_layers = "blocks"

    def __init__(self, config: GPT2Config):
        self.config = config

    def param_partition_specs(self, params) -> Dict[str, Any]:
        """Megatron column/row-parallel placement on the ``model`` axis
        (the JAX package's, a tuple of axis names per dim)."""
        m = MODEL_AXIS
        return {
            "wte": (m, None),           # vocab-parallel embedding
            "wpe": (),
            "ln_f_scale": (),
            "ln_f_bias": (),
            "blocks": {
                "ln1_scale": (), "ln1_bias": (),
                "qkv_w": (None, None, None, m),   # column parallel
                "qkv_b": (None, None, m),
                "out_w": (None, m, None),         # row parallel
                "out_b": (),
                "ln2_scale": (), "ln2_bias": (),
                "fc_w": (None, None, m),          # column parallel
                "fc_b": (None, m),
                "proj_w": (None, m, None),        # row parallel
                "proj_b": (),
            },
        }

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

    def apply(self, params, tokens: torch.Tensor, rng: Optional[int],
              train: bool = True) -> torch.Tensor:
        """tokens [B, T] → logits [B, T, vocab] in the params' dtype.
        ``rng``: host integer seed of this forward's dropout (None when
        ``train`` is False or every rate is 0)."""
        cfg = self.config
        B, T = tokens.shape
        if T > cfg.n_positions:
            raise ValueError(
                f"sequence length {T} exceeds n_positions={cfg.n_positions}")
        tokens = tokens.long()
        blocks = params["blocks"]
        # the training engine's mesh (tensor parallelism, the data rows),
        # None outside it
        mesh = getattr(blocks, "mesh", None)
        x = _embed_tokens(cfg, params["wte"], tokens, mesh) \
            + params["wpe"][:T][None]
        x = _dropout(x, cfg.embd_dropout if train else 0.0,
                     fold_in(rng, 997), data_rows(mesh, B))
        layer = getattr(blocks, "layer", None)
        if layer is None:
            # one unbind per leaf: its backward stacks the layer grads
            # once, where indexing each layer would add a full-stack zero
            # tensor per layer
            layer = [dict(zip(blocks, leaves)) for leaves in
                     zip(*(a.unbind(0) for a in blocks.values()))
                     ].__getitem__
        for i in range(cfg.n_layer):
            lrng = fold_in(rng, i)
            if cfg.remat == "block" and torch.is_grad_enabled():
                # the blocks draw no global RNG (their seeds are host
                # integers), so there is no RNG state to stash and
                # restore; an engine's layer fetch runs inside, so the
                # recompute fetches (gathers) the layer again
                x = checkpoint(_block_at, cfg, layer, i, x, lrng, train,
                               mesh, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = _block_at(cfg, layer, i, x, lrng, train, mesh)
        return _logits(params, x, _vocab_parallel(cfg, params, mesh))

    def loss_fn(self, params, batch, rng: Optional[int],
                train: bool = True) -> torch.Tensor:
        """Mean next-token NLL: logits to fp32, ``log_softmax``, the
        targets' log-probabilities.  ``batch``: tokens [B, T+1] (or a dict
        with ``input_ids``)."""
        tokens = batch["input_ids"] if isinstance(batch, dict) else batch
        logits = self.apply(params, tokens[:, :-1], rng, train)
        targets = tokens[:, 1:].long()
        mesh = _vocab_parallel(self.config, params,
                               getattr(params["blocks"], "mesh", None))
        if mesh is not None:
            return _vocab_parallel_nll(logits, targets, mesh).mean()
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])
        return nll.mean()

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

    def prefill_paged(self, params, tokens, delta_len, prefix_len,
                      page_row, k_pool, v_pool, k_scale=None,
                      v_scale=None, lora=None, adapter_slots=None,
                      lora_scale: float = 1.0):
        """Delta-aware prefill into a paged KV pool — see
        ``gpt2_prefill_paged``."""
        return gpt2_prefill_paged(self.config, params, tokens, delta_len,
                                  prefix_len, page_row, k_pool, v_pool,
                                  k_scale=k_scale, v_scale=v_scale,
                                  lora=lora, adapter_slots=adapter_slots,
                                  lora_scale=lora_scale)

    def decode_step_paged(self, params, tokens, k_pool, v_pool,
                          page_table, lengths, active,
                          impl: Optional[str] = None, k_scale=None,
                          v_scale=None, lora=None, adapter_slots=None,
                          lora_scale: float = 1.0):
        """One masked decode tick over the paged KV pool — see
        ``gpt2_decode_step_paged``."""
        return gpt2_decode_step_paged(self.config, params, tokens, k_pool,
                                      v_pool, page_table, lengths, active,
                                      impl=impl, k_scale=k_scale,
                                      v_scale=v_scale, lora=lora,
                                      adapter_slots=adapter_slots,
                                      lora_scale=lora_scale)

    def verify_step(self, params, tokens, k_cache, v_cache, lengths,
                    active, impl: Optional[str] = None):
        """Score W speculative tokens per slot in one widened decode
        pass — see ``gpt2_verify_step``."""
        return gpt2_verify_step(self.config, params, tokens, k_cache,
                                v_cache, lengths, active, impl=impl)

    def verify_step_paged(self, params, tokens, k_pool, v_pool,
                          page_table, lengths, active,
                          impl: Optional[str] = None, k_scale=None,
                          v_scale=None, lora=None, adapter_slots=None,
                          lora_scale: float = 1.0):
        """The paged twin of ``verify_step`` — see
        ``gpt2_verify_step_paged``."""
        return gpt2_verify_step_paged(self.config, params, tokens, k_pool,
                                      v_pool, page_table, lengths, active,
                                      impl=impl, k_scale=k_scale,
                                      v_scale=v_scale, lora=lora,
                                      adapter_slots=adapter_slots,
                                      lora_scale=lora_scale)


def _layer_norm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def data_rows(mesh, n: int):
    """``(offset, total)`` of this rank's ``n`` rows in the global
    micro-batch the dropouts draw over, None without a mesh."""
    if mesh is None:
        return None
    return mesh.axis_index(DATA_AXIS) * n, mesh.axis_size(DATA_AXIS) * n


def _vocab_parallel(cfg: GPT2Config, params, mesh):
    """``mesh`` when ``wte`` is this rank's vocab-parallel piece (fewer
    rows than the vocabulary), else None."""
    if mesh is None or params["wte"].shape[0] == cfg.vocab_size:
        return None
    return mesh


def _embed_tokens(cfg: GPT2Config, wte, tokens, mesh):
    """``wte[tokens]``; on a vocab-parallel piece, the rank's rows
    looked up (zeros for tokens another rank holds) and all-reduced over
    ``model``."""
    if _vocab_parallel(cfg, {"wte": wte}, mesh) is None:
        return wte[tokens]
    n = wte.shape[0]
    local = tokens - mesh.axis_index(MODEL_AXIS) * n
    mine = (local >= 0) & (local < n)
    e = torch.where(mine[..., None], wte[local.clamp(0, n - 1)], 0.0)
    return col.reduce_from_axis(e.to(wte.dtype), mesh, MODEL_AXIS)


def _vocab_parallel_nll(logits, targets, mesh):
    """Per-token NLL over vocab-parallel logits [B, T, V/tp] (Megatron's
    vocab-parallel cross-entropy, in fp32): the max, the sum of
    exponentials and the target's logit each all-reduced over
    ``model``."""
    lf = logits.float()
    n = lf.shape[-1]
    m = col.pmax(lf.max(dim=-1).values.detach(), mesh, MODEL_AXIS)
    sumexp = col.reduce_from_axis((lf - m[..., None]).exp().sum(dim=-1),
                                  mesh, MODEL_AXIS)
    local = targets - mesh.axis_index(MODEL_AXIS) * n
    mine = (local >= 0) & (local < n)
    t = torch.gather(lf, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    t = col.reduce_from_axis(torch.where(mine, t, 0.0), mesh, MODEL_AXIS)
    return sumexp.log() + m - t


def _wscale(y, bp, name: str):
    """The int8 weights' dequant (reference ``models/gpt2.py:355-366``): a
    quantized tree carries an ``<name>_scale`` sibling per matmul weight,
    per OUTPUT channel, so ``x · (w8 · s) == (x · w8) · s`` — one multiply
    on the product, the scale rounded to the product's dtype first, as the
    reference rounds it.  A tree without scales (training, fp serving)
    returns ``y`` untouched.  The product itself multiplies ``x`` by
    ``w8`` cast to ``x``'s dtype: eager PyTorch materializes that cast, a
    transient copy of one layer's weight."""
    s = bp.get(name + "_scale")
    return y if s is None else y * s.to(y.dtype)


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` on the host (the reference's
    ``jnp.asarray(scale, x.dtype)``), so no scalar is copied to the
    device."""
    return float(torch.tensor(value, dtype=dtype))


def _lora_delta(x, bp, name: str):
    """The heterogeneous batched LoRA delta (reference ``models/gpt2.py:
    368-385``): a bound block carries a ``<name>_lora`` entry of PER-ROW
    factors — each batch row's own tenant adapter (:func:`_lora_bind`) —
    and the delta is ``(x·A)·B · (alpha/r)``: two batched products in
    ``x``'s dtype, then the scale rounded to that dtype.  The caller adds
    it AFTER the base product and bias, as the reference does.  A block
    without lora entries (training, serving with lora off) returns
    None."""
    lo = bp.get(name + "_lora")
    if lo is None:
        return None
    a, b, out, scale = lo
    if a.dtype != x.dtype:
        a, b = a.to(x.dtype), b.to(x.dtype)
    delta = torch.bmm(torch.bmm(x, a), b)           # [B, T, prod(out)]
    return delta.view(*x.shape[:2], *out) * _rounded(scale, x.dtype)


def _lora_rows(lora, adapter_slots):
    """Every layer's per-row factors, one gather per factor: ``lora`` is
    the layer-stacked pools ``{target: (A [L, N, d_in, r], B [L, N, r,
    *out])}`` and ``adapter_slots`` each batch row's pool slot ([B] int
    tensor, or one int for a prefill).  Returns ``{target: (the L layers'
    A [B, d_in, r], their B [B, r, prod(out)], out)}``.  The reference
    gathers layer by layer inside its scan; the rows are the same, and one
    gather, flatten and unbind a factor keep a tick's host ops down (a
    serving tick is host-bound)."""
    if lora is None:
        return None
    if not torch.is_tensor(adapter_slots):
        dev = next(iter(lora.values()))[0].device
        adapter_slots = torch.tensor([int(adapter_slots)], device=dev)
    idx = adapter_slots.reshape(-1).long()
    return {t: (a[:, idx].unbind(0), b[:, idx].flatten(3).unbind(0),
                tuple(b.shape[3:]))
            for t, (a, b) in lora.items()}


def _lora_bind(bp, lora_rows, i: int, scale: float):
    """Layer ``i``'s per-row factors of :func:`_lora_rows` bound into the
    block's params as ``<target>_lora`` entries (reference ``_lora_bind``,
    ``models/gpt2.py:388-402``); slot 0 is the reserved zero adapter, so
    rows with no tenant get an exact-zero delta."""
    if lora_rows is None:
        return bp
    bp = dict(bp)
    for t, (a, b, out) in lora_rows.items():
        bp[t + "_lora"] = (a[i], b[i], out, scale)
    return bp


def _add_delta(y, d):
    return y if d is None else y + d


def gpt2_ffn(bp, h, mesh=None):
    """fc → gelu (tanh approximation) → proj over normalized input, each
    product with its LoRA delta when the block is bound.  Under a mesh
    ``fc`` is column-parallel and ``proj`` row-parallel: the partial
    products are all-reduced over ``model`` before the bias."""
    if mesh is not None:
        h = col.copy_to_axis(h, mesh, MODEL_AXIS)
    y = (_wscale(h @ bp["fc_w"].to(h.dtype), bp, "fc_w")
         + bp["fc_b"].to(h.dtype))
    y = _add_delta(y, _lora_delta(h, bp, "fc_w"))
    y = F.gelu(y, approximate="tanh")
    z = _wscale(y @ bp["proj_w"].to(h.dtype), bp, "proj_w")
    if mesh is not None:
        z = col.reduce_from_axis(z, mesh, MODEL_AXIS)
    z = z + bp["proj_b"].to(h.dtype)
    return _add_delta(z, _lora_delta(y, bp, "proj_w"))


def gpt2_qkv_heads(cfg: GPT2Config, bp, x, mesh=None):
    """ln1 → fused qkv → per-head split, [B, H, T, Dh] each (views).
    Under a mesh ``qkv_w`` is the rank's column-parallel piece
    ``[d, 3, d/tp]`` and the heads are its ``H/tp``."""
    B, T, D = x.shape
    Dl, Dh = bp["qkv_w"].shape[-1], cfg.d_head
    h = _layer_norm(x, bp["ln1_scale"], bp["ln1_bias"])
    if mesh is not None:
        h = col.copy_to_axis(h, mesh, MODEL_AXIS)
    w = bp["qkv_w"].to(h.dtype).reshape(D, 3 * Dl)
    qkv = (_wscale((h @ w).view(B, T, 3, Dl), bp, "qkv_w")
           + bp["qkv_b"].to(h.dtype))
    qkv = _add_delta(qkv, _lora_delta(h, bp, "qkv_w"))    # [B, T, 3, Dl]

    def heads(t):
        return t.reshape(B, T, Dl // Dh, Dh).transpose(1, 2)

    return heads(qkv[:, :, 0]), heads(qkv[:, :, 1]), heads(qkv[:, :, 2])


def gpt2_attn_project(bp, x, attn, drop: float = 0.0,
                      rng: Optional[int] = None, mesh=None):
    """heads → output projection → dropout → residual (the sublayer's
    tail, shared with the serving paths, which pass ``drop=0``).  An
    ``attn`` of a wider type than ``x`` (the fp32 output of the dense
    decode over a dequantized int8 pool) promotes the product and the
    residual, as the reference's jnp promotion does.  Under a mesh
    ``out_w`` is row-parallel: the partial product is all-reduced over
    ``model`` before the bias."""
    B, H, T, Dh = attn.shape
    attn = attn.transpose(1, 2).reshape(B, T, H * Dh)
    dt = torch.promote_types(attn.dtype, x.dtype)
    y = _wscale(attn.to(dt) @ bp["out_w"].to(x.dtype).to(dt), bp, "out_w")
    if mesh is not None:
        y = col.reduce_from_axis(y, mesh, MODEL_AXIS)
    y = y + bp["out_b"].to(x.dtype)
    y = _add_delta(y, _lora_delta(attn, bp, "out_w"))
    return x + _dropout(y, drop, rng, data_rows(mesh, B))


def gpt2_attn_sublayer(cfg: GPT2Config, bp, x, rng: Optional[int],
                       train: bool, mesh=None):
    """ln1 → attention → residual (the block minus its FFN sublayer)."""
    B, T, D = x.shape
    r1, r2 = fold_in(rng, 0), fold_in(rng, 1)
    drop = cfg.dropout if train else 0.0
    q, k, v = gpt2_qkv_heads(cfg, bp, x, mesh)
    if cfg.attn_impl == "flash":
        # the flash kernels, probability dropout hashed in-kernel; under
        # a mesh over the global (batch, head) ids of the rank's rows and
        # heads
        bh = None
        if mesh is not None:
            H, Hl = cfg.n_head, q.shape[1]
            bh = (mesh.axis_index(DATA_AXIS) * B * H
                  + mesh.axis_index(MODEL_AXIS) * Hl, Hl, H)
        attn = mha(q, k, v, dropout_rate=drop, causal=True,
                   dropout_seed=None if r1 is None else r1 & _M32,
                   bh_affine=bh)
    elif cfg.attn_impl == "dense":
        gen = _generator(r1, x.device) if drop > 0.0 else None
        attn = causal_attention(q, k, v, dropout_rate=drop, dropout_rng=gen)
    elif cfg.attn_impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} (sequence-parallel attention) is "
            "not ported to deepspeed_tpu_torch yet: ROADMAP.md queue 1, "
            "item 11 (sequence, expert and compressed parallelism)")
    else:
        raise ValueError(
            f"attn_impl={cfg.attn_impl!r}: expected 'flash', 'dense', "
            "'ring', or 'ulysses'")
    return gpt2_attn_project(bp, x, attn, drop, r2, mesh)


def gpt2_block_forward(cfg: GPT2Config, bp, x, rng: Optional[int],
                       train: bool, mesh=None):
    """One pre-LN transformer block over one layer's params — the training
    forward's block math (over the rank's tensor-parallel pieces under a
    mesh)."""
    r_attn, r3 = fold_in(rng, 0), fold_in(rng, 1)
    drop = cfg.dropout if train else 0.0
    x = gpt2_attn_sublayer(cfg, bp, x, r_attn, train, mesh)
    h = _layer_norm(x, bp["ln2_scale"], bp["ln2_bias"])
    h = gpt2_ffn(bp, h, mesh)
    return x + _dropout(h, drop, r3, data_rows(mesh, x.shape[0]))


def _block_at(cfg: GPT2Config, layer, i: int, x, rng, train: bool, mesh):
    """Block ``i`` over the params ``layer(i)`` fetches."""
    return gpt2_block_forward(cfg, layer(i), x, rng, train, mesh)


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


def _embed(params, tokens, positions):
    """Token plus position embeddings (any matching index shapes)."""
    return params["wte"][tokens.long()] + params["wpe"][positions.long()]


def _logits(params, x, vocab_mesh=None):
    """Tied output head over ``wte``'s rows: the whole vocabulary, or
    under ``vocab_mesh`` (a vocab-parallel ``wte``) the rank's slice of
    it, the input's gradient all-reduced over ``model``."""
    x = _layer_norm(x, params["ln_f_scale"], params["ln_f_bias"])
    if vocab_mesh is not None:
        x = col.copy_to_axis(x, vocab_mesh, MODEL_AXIS)
    return x @ params["wte"].to(x.dtype).T


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
    return _logits(params, x), torch.stack(ks), torch.stack(vs)


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
    logits = _logits(params, x)[:, 0]
    return logits, k_cache, v_cache, lengths + active.to(torch.int32)


# ---------------------------------------------------------------------------
# speculative verify path (serving.speculate_k > 0): ONE widened decode
# pass scores W = k+1 new tokens per slot — the pending token plus the
# draft's k proposals — writing all W K/V rows (masked) and attending each
# query over its own causal window (deepspeed_tpu/models/gpt2.py:691-880).
# ---------------------------------------------------------------------------


def _verify_rows(lengths, active, W: int, cap: int):
    """The per-row geometry every verify arm shares (reference
    ``_verify_rows``, ``models/gpt2.py:701-717``): absolute positions
    (clipped), write validity, per-query attention lengths.  Row ``i`` of
    slot ``s`` sits at ``lengths[s] + i`` and attends ``lengths[s] + i +
    1`` keys; rows at or past ``cap`` are masked (their write is a no-op,
    their output row exact zeros the engine's truncation discards)."""
    base = lengths.to(torch.int32)
    abs_pos = base[:, None] + torch.arange(W, dtype=torch.int32,
                                           device=base.device)[None]
    row_valid = active[:, None] & (abs_pos < cap)
    positions = abs_pos.clamp(0, cap - 1)
    row_lens = torch.where(row_valid, abs_pos + 1, 0).to(torch.int32)
    return positions, row_valid, row_lens


def _cache_write_rows(cache, new, positions, row_valid):
    """Masked IN-PLACE write of W rows per slot into the slot cache in one
    scatter: cache [S, H, T, Dh], new [S, H, W, Dh], positions/row_valid
    [S, W] from :func:`_verify_rows`.

    Rows past the capacity clip onto position ``cap - 1``, where the
    slot's last valid row may also write.  So that no two writers of one
    target disagree, every row writes the value its TARGET ends with: the
    new row whose own position it is (``positions - positions[:, :1]``)
    when that row is valid, else the old value.  The reference gets the
    same result by writing the W rows one after another."""
    S, H, T, Dh = cache.shape
    s_idx = torch.arange(S, device=cache.device)[:, None]
    owner = (positions - positions[:, :1]).long()             # [S, W]
    owner_valid = torch.gather(row_valid, 1, owner)
    rows = new.transpose(1, 2)                                # [S, W, H, Dh]
    owner_new = rows[s_idx, owner]                            # [S, W, H, Dh]
    pos = positions.long()
    old = cache[s_idx, :, pos]                                # [S, W, H, Dh]
    cache[s_idx, :, pos] = torch.where(owner_valid[..., None, None],
                                       owner_new.to(cache.dtype), old)
    return cache


def gpt2_block_verify(cfg: GPT2Config, bp, x, k_cache, v_cache, positions,
                      row_valid, row_lens, impl: str):
    """One block of the verify pass: x [S, W, D]; writes all W K/V rows
    (masked per row) then runs the multi-query decode attention."""
    q, k, v = gpt2_qkv_heads(cfg, bp, x)                # [S, H, W, Dh]
    _cache_write_rows(k_cache, k, positions, row_valid)
    _cache_write_rows(v_cache, v, positions, row_valid)
    attn = decode_attention_multi(q, k_cache, v_cache, row_lens,
                                  impl=impl)            # [S, H, W, Dh]
    x = gpt2_attn_project(bp, x, attn)
    h = _layer_norm(x, bp["ln2_scale"], bp["ln2_bias"])
    return x + gpt2_ffn(bp, h)


@torch.no_grad()
def gpt2_verify_step(cfg: GPT2Config, params, tokens, k_cache, v_cache,
                     lengths, active, impl: Optional[str] = None):
    """One speculative verify pass for every slot at once.

    tokens [S, W] — per slot its pending token then its k draft
    proposals; k_cache/v_cache [L, S, H, T, Dh], updated in place;
    lengths [S] — live KV length BEFORE this pass; active [S] bool.

    Returns ``(logits [S, W, V], k_cache, v_cache)``: ``logits[s, i]``
    scores the token after ``tokens[s, i]``.  Lengths are not advanced:
    how far the cache moved is the caller's acceptance decision."""
    if impl is None:
        impl = _decode_attn_impl(cfg)
    S, W = tokens.shape
    cap = min(k_cache.shape[3], cfg.n_positions)
    positions, row_valid, row_lens = _verify_rows(lengths, active, W, cap)
    x = _embed(params, tokens, positions)               # [S, W, D]
    for i in range(cfg.n_layer):
        x = gpt2_block_verify(cfg, _layer(params["blocks"], i), x,
                              k_cache[i], v_cache[i], positions, row_valid,
                              row_lens, impl)
    return _logits(params, x), k_cache, v_cache


# ---------------------------------------------------------------------------
# paged serving paths (serving.page_len > 0): the same block helpers over a
# flat page pool [P, H, page_len, Dh] addressed through per-slot int32 page
# tables (deepspeed_tpu/models/gpt2.py:883-1201).  Page 0 is the reserved
# scratch page every MASKED write is routed to, so two writers of one pool
# row can only be masked rows writing back the same old value.
# ---------------------------------------------------------------------------


def _paged_cache_write(pool, new, page_ids, offs, active):
    """Masked IN-PLACE write of rows into the page pool:
    ``pool[page_ids, :, offs] = new`` where ``active``; masked rows write
    their old value back at the scratch page.  pool [P, H, page_len, Dh];
    new [..., H, Dh]; page_ids/offs/active share ``new``'s leading shape
    (page ids already routed to scratch for masked rows)."""
    page_ids, offs = page_ids.long(), offs.long()
    old = pool[page_ids, :, offs]
    pool[page_ids, :, offs] = torch.where(active[..., None, None],
                                          new.to(pool.dtype), old)
    return pool


def _paged_cache_write_quant(pool, scales, new, page_ids, offs, active):
    """The quantize-on-write twin of :func:`_paged_cache_write` (reference
    ``models/gpt2.py:905-921``): each row is quantized per (row, head) —
    int8 plus one fp32 scale (``inference/quantize.py``) — and the int8 row
    and its scale land IN PLACE under the same mask.  pool int8 [P, H,
    page_len, Dh], scales fp32 [P, H, page_len].  All on the device."""
    from ..inference.quantize import quantize_rows  # (a cycle at import)
    q8, s = quantize_rows(new)                      # [..., H, Dh] / [..., H]
    page_ids, offs = page_ids.long(), offs.long()
    old = pool[page_ids, :, offs]
    old_s = scales[page_ids, :, offs]
    pool[page_ids, :, offs] = torch.where(active[..., None, None], q8, old)
    scales[page_ids, :, offs] = torch.where(active[..., None], s, old_s)
    return pool, scales


def _paged_write(pool, scales, new, page_ids, offs, active):
    """The reference's fp/int8 dispatch (``models/gpt2.py:923-929``):
    ``scales`` None writes the fp pool, else the rows are quantized."""
    if scales is None:
        return _paged_cache_write(pool, new, page_ids, offs, active), None
    return _paged_cache_write_quant(pool, scales, new, page_ids, offs,
                                    active)


def _layer_scales(k_scale, v_scale, i: int) -> Dict[str, Any]:
    """Layer ``i``'s scale sidecars as keyword arguments (none on the fp
    pool)."""
    if k_scale is None:
        return {}
    return {"k_scale": k_scale[i], "v_scale": v_scale[i]}


def _route(page_table, positions, valid, page_len: int):
    """(page ids, offsets) of ``positions`` [S] or [S, W] through the
    table, masked rows routed to the scratch page 0."""
    pos = positions.long()
    s_idx = torch.arange(page_table.shape[0], device=pos.device)
    if pos.ndim == 2:
        s_idx = s_idx[:, None]
    page_ids = torch.where(valid, page_table.long()[s_idx, pos // page_len],
                           0)
    return page_ids, pos % page_len


def gpt2_block_decode_paged(cfg: GPT2Config, bp, x, k_pool, v_pool,
                            page_table, positions, att_len, active,
                            impl: str, k_scale=None, v_scale=None):
    """One block of a paged decode tick: x [S, 1, D]; writes the token's
    K/V at ``positions`` into the slot's page (masked by ``active``,
    masked slots routed to scratch) then attends over ``att_len`` live
    keys per slot through the page table.  With the int8 pool
    (``k_scale``/``v_scale`` [P, H, page_len]) the write quantizes each
    row and the attention runs the int8 kernel arm."""
    q, k, v = gpt2_qkv_heads(cfg, bp, x)                # [S, H, 1, Dh]
    page_ids, offs = _route(page_table, positions, active, k_pool.shape[2])
    _paged_write(k_pool, k_scale, k[:, :, 0], page_ids, offs, active)
    _paged_write(v_pool, v_scale, v[:, :, 0], page_ids, offs, active)
    attn = decode_attention_paged(q[:, :, 0], k_pool, v_pool, page_table,
                                  att_len, impl=impl, k_scale=k_scale,
                                  v_scale=v_scale)      # [S, H, Dh]
    x = gpt2_attn_project(bp, x, attn[:, :, None, :])
    h = _layer_norm(x, bp["ln2_scale"], bp["ln2_bias"])
    return x + gpt2_ffn(bp, h)


@torch.no_grad()
def gpt2_decode_step_paged(cfg: GPT2Config, params, tokens, k_pool, v_pool,
                           page_table, lengths, active,
                           impl: Optional[str] = None, k_scale=None,
                           v_scale=None, lora=None, adapter_slots=None,
                           lora_scale: float = 1.0):
    """One decode tick for every slot at once over the paged pool — the
    paged twin of :func:`gpt2_decode_step`.

    tokens [S]; k_pool/v_pool [L, P, H, page_len, Dh], updated in place;
    page_table [S, max_pages] int (dead entries = scratch page 0);
    lengths [S] — live KV length BEFORE this token; active [S] bool.
    Returns (logits [S, V], k_pool, v_pool, new_lengths).

    The int8 pool: pass its fp32 sidecars ``k_scale``/``v_scale`` [L, P,
    H, page_len] (updated in place); the return grows to (logits, k_pool,
    v_pool, k_scale, v_scale, new_lengths), as the reference's does.

    Multi-tenant LoRA: ``lora`` is the layer-stacked adapter pools
    ``{target: (A [L, N, d_in, r], B [L, N, r, *out])}``,
    ``adapter_slots`` [S] int each slot's pool slot (0 = the zero
    adapter) and ``lora_scale`` alpha/r; ``lora=None`` runs exactly the
    code without adapters."""
    if impl is None:
        impl = _decode_attn_impl(cfg)
    page_len = k_pool.shape[3]
    cap = page_table.shape[1] * page_len
    lengths = lengths.to(torch.int32)
    positions = lengths.clamp(0, min(cap, cfg.n_positions) - 1)
    x = _embed(params, tokens, positions)[:, None]
    att_len = torch.where(active, lengths + 1, 0).to(torch.int32)
    rows = _lora_rows(lora, adapter_slots)
    for i in range(cfg.n_layer):
        bp = _lora_bind(_layer(params["blocks"], i), rows, i, lora_scale)
        x = gpt2_block_decode_paged(cfg, bp, x,
                                    k_pool[i], v_pool[i], page_table,
                                    positions, att_len, active, impl,
                                    **_layer_scales(k_scale, v_scale, i))
    logits = _logits(params, x)[:, 0]
    new_lengths = lengths + active.to(torch.int32)
    if k_scale is not None:
        return logits, k_pool, v_pool, k_scale, v_scale, new_lengths
    return logits, k_pool, v_pool, new_lengths


def gpt2_block_verify_paged(cfg: GPT2Config, bp, x, k_pool, v_pool,
                            page_table, positions, row_valid, row_lens,
                            impl: str, k_scale=None, v_scale=None):
    """One block of the paged verify pass: the W rows' page-routed writes
    in one scatter (masked rows to scratch; valid rows of a slot are W
    distinct positions of its own pages) then the paged multi-query
    attention — quantizing each row on write and running the int8 arm on
    the int8 pool."""
    q, k, v = gpt2_qkv_heads(cfg, bp, x)                # [S, H, W, Dh]
    page_ids, offs = _route(page_table, positions, row_valid,
                            k_pool.shape[2])            # [S, W]
    _paged_write(k_pool, k_scale, k.transpose(1, 2), page_ids, offs,
                 row_valid)
    _paged_write(v_pool, v_scale, v.transpose(1, 2), page_ids, offs,
                 row_valid)
    attn = decode_attention_paged_multi(q, k_pool, v_pool, page_table,
                                        row_lens, impl=impl, k_scale=k_scale,
                                        v_scale=v_scale)
    x = gpt2_attn_project(bp, x, attn)
    h = _layer_norm(x, bp["ln2_scale"], bp["ln2_bias"])
    return x + gpt2_ffn(bp, h)


@torch.no_grad()
def gpt2_verify_step_paged(cfg: GPT2Config, params, tokens, k_pool, v_pool,
                           page_table, lengths, active,
                           impl: Optional[str] = None, k_scale=None,
                           v_scale=None, lora=None, adapter_slots=None,
                           lora_scale: float = 1.0):
    """The paged twin of :func:`gpt2_verify_step`: the engine must have
    allocated pages covering all W rows before the pass (and rolls back
    the ones the acceptance did not keep).  Returns (logits [S, W, V],
    k_pool, v_pool), and with the int8 pool's sidecars (logits, k_pool,
    v_pool, k_scale, v_scale).  ``lora``/``adapter_slots``/``lora_scale``
    as in :func:`gpt2_decode_step_paged`."""
    if impl is None:
        impl = _decode_attn_impl(cfg)
    S, W = tokens.shape
    cap = min(page_table.shape[1] * k_pool.shape[3], cfg.n_positions)
    positions, row_valid, row_lens = _verify_rows(lengths, active, W, cap)
    x = _embed(params, tokens, positions)
    rows = _lora_rows(lora, adapter_slots)
    for i in range(cfg.n_layer):
        bp = _lora_bind(_layer(params["blocks"], i), rows, i, lora_scale)
        x = gpt2_block_verify_paged(cfg, bp, x,
                                    k_pool[i], v_pool[i], page_table,
                                    positions, row_valid, row_lens, impl,
                                    **_layer_scales(k_scale, v_scale, i))
    if k_scale is not None:
        return _logits(params, x), k_pool, v_pool, k_scale, v_scale
    return _logits(params, x), k_pool, v_pool


def gpt2_block_prefill_paged(cfg: GPT2Config, bp, x, k_pool, v_pool,
                             page_row, prefix_len: int, delta_len: int,
                             k_scale=None, v_scale=None):
    """One block of the delta-aware paged prefill: the delta tokens' K/V
    (absolute positions ``prefix_len + i``, ``i < delta_len``) written
    into the slot's pages, then the attention.  Two arms, chosen on the
    host:

    * ``prefix_len == 0`` — the model's own prefill attention (the flash
      kernel or the dense arm, ``gpt2_block_prefill``'s ops);
    * ``prefix_len > 0`` — dense attention over the pool gathered through
      ``page_row``: delta query ``i`` attends every key at an absolute
      position ``<= prefix_len + i`` (plain torch ops, as the reference's
      jnp arm).

    With the int8 pool the delta rows are quantized on write; the first
    arm still attends the exact fp K/V (only the stored rows are
    quantized), and the gather arm dequantizes the pool first."""
    q, k, v = gpt2_qkv_heads(cfg, bp, x)                # [1, H, Tq, Dh]
    page_len = k_pool.shape[2]
    pos = prefix_len + torch.arange(delta_len, device=x.device)
    page_ids = page_row.long()[pos // page_len]
    offs = pos % page_len
    for pool, scales, new in ((k_pool, k_scale, k), (v_pool, v_scale, v)):
        rows = new[0, :, :delta_len].transpose(0, 1)    # [delta, H, Dh]
        if scales is None:
            pool[page_ids, :, offs] = rows.to(pool.dtype)
        else:
            from ..inference.quantize import quantize_rows
            pool[page_ids, :, offs], scales[page_ids, :, offs] = \
                quantize_rows(rows)
    if prefix_len == 0:
        if cfg.attn_impl == "flash":
            attn = flash_attention(q, k, v, causal=True)
        elif cfg.attn_impl == "dense":
            attn = causal_attention(q, k, v)
        else:
            _decode_attn_impl(cfg)  # raises with the real story
    else:
        if k_scale is None:
            kg = paged_gather(k_pool, page_row[None])[0]    # [H, T', Dh]
            vg = paged_gather(v_pool, page_row[None])[0]
        else:
            kg = dequantize_paged(k_pool, k_scale, page_row[None])[0]
            vg = dequantize_paged(v_pool, v_scale, page_row[None])[0]
        s = torch.einsum("htd,hsd->hts", q[0].float(),
                         kg.to(q.dtype).float()) * _default_scale(cfg.d_head)
        abs_pos = prefix_len + torch.arange(x.shape[1], device=x.device)
        key_pos = torch.arange(kg.shape[1], device=x.device)
        ok = key_pos[None, :] <= abs_pos[:, None]       # [Tq, T']
        s = torch.where(ok[None], s, torch.finfo(torch.float32).min)
        probs = torch.softmax(s, dim=-1).to(q.dtype)
        attn = torch.einsum("hts,hsd->htd", probs, vg.to(q.dtype))[None]
    x = gpt2_attn_project(bp, x, attn)
    h = _layer_norm(x, bp["ln2_scale"], bp["ln2_bias"])
    return x + gpt2_ffn(bp, h)


@torch.no_grad()
def gpt2_prefill_paged(cfg: GPT2Config, params, tokens, delta_len,
                       prefix_len, page_row, k_pool, v_pool, k_scale=None,
                       v_scale=None, lora=None, adapter_slots=None,
                       lora_scale: float = 1.0):
    """Delta-aware prefill into the paged pool (full prefills, prefix-hit
    deltas and prefill chunks alike).

    tokens [1, Tq] — the delta tokens (prompt minus the cached prefix),
    right-padded to the prefill bucket; ``delta_len``/``prefix_len`` host
    integers; page_row [max_pages] int — the slot's full table (shared
    prefix pages plus its own pages, dead entries = scratch);
    k_pool/v_pool [L, P, H, page_len, Dh], updated in place.

    Returns (logits [1, Tq, V], k_pool, v_pool): ``logits[0, i]`` scores
    the token after absolute position ``prefix_len + i``; padding rows are
    garbage and write nothing.  With the int8 pool's sidecars
    ``k_scale``/``v_scale`` [L, P, H, page_len] (updated in place) the
    return grows to (logits, k_pool, v_pool, k_scale, v_scale).

    Multi-tenant LoRA: ``adapter_slots`` is the requesting tenant's pool
    slot (an int, or a [1] int tensor), gathered from the same ``lora``
    pools as the decode tick."""
    B, Tq = tokens.shape
    if Tq > cfg.n_positions:
        raise ValueError(
            f"sequence length {Tq} exceeds n_positions={cfg.n_positions}")
    prefix_len, delta_len = int(prefix_len), int(delta_len)
    if not 0 < delta_len <= Tq or \
            prefix_len + delta_len > page_row.shape[0] * k_pool.shape[3]:
        raise ValueError(
            f"prefill of {delta_len} tokens after a {prefix_len}-token "
            f"prefix does not fit a {Tq}-token bucket and a "
            f"{page_row.shape[0]}-page table")
    pos = (prefix_len + torch.arange(Tq, device=tokens.device)).clamp(
        0, cfg.n_positions - 1)
    x = _embed(params, tokens, pos[None])
    rows = _lora_rows(lora, adapter_slots)
    for i in range(cfg.n_layer):
        bp = _lora_bind(_layer(params["blocks"], i), rows, i, lora_scale)
        x = gpt2_block_prefill_paged(cfg, bp, x,
                                     k_pool[i], v_pool[i], page_row,
                                     prefix_len, delta_len,
                                     **_layer_scales(k_scale, v_scale, i))
    if k_scale is not None:
        return _logits(params, x), k_pool, v_pool, k_scale, v_scale
    return _logits(params, x), k_pool, v_pool
