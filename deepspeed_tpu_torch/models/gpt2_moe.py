"""GPT-2 with Mixture-of-Experts blocks — the port of
``deepspeed_tpu/models/gpt2_moe.py``.

Every ``moe_layer_freq``-th block swaps its dense FFN for a top-k routed
expert FFN (``moe/layer.py``); the attention sublayer is GPT-2's
(``gpt2_attn_sublayer``: the flash kernels on ``attn_impl="flash"``).
The parameter tree is the JAX model's — three layer stacks, ``attn``
``[L, ...]``, ``dense_ffn`` ``[L_dense, ...]`` and ``moe`` ``[L_moe, E,
...]`` — so the JAX ``init`` tree moves across with
``params_from_numpy``.  The training engine places the expert dims over
``data`` (:meth:`GPT2MoEModel.param_partition_specs`, the JAX specs in
the port's tuple form) and hands each stack to the model as a
``LayerStack`` (``stacked_layers``), fetched one layer at a time.

The JAX model has three forms of its layer loop: unrolled,
``scan_groups`` (``lax.scan`` over groups of ``moe_layer_freq`` blocks,
freq-1 dense then one MoE) and ``scan_groups`` + ``stream_scan`` (the
scan fetching one group's rows from host memory).  Eager PyTorch has no
scan: each form is the same Python loop with the same math and the same
per-layer seeds; ``remat="block"`` checkpoints one block in the unrolled
form and one group in the grouped forms.  Under the XLA offload tier's
``param_streaming`` the three stacks stay in pinned host memory and each
block fetches its rows (``runtime/offload_xla.py``).

With ``attn_impl="ring"`` or ``"ulysses"`` the model trains on a
``seq`` axis (:attr:`GPT2MoEModel.seq_parallel`), as ``models/gpt2.py``
does: each seq rank holds its token shard from the embedding to the
loss (its ``wpe`` rows, dropout masks drawn over the whole sequence,
the loss a ``token_mean`` over ``seq`` with the aux added once), and
:func:`moe_ffn` routes the shard as the whole sequence would be routed
(global capacity, positions and drops).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..moe.layer import MoEConfig, init_moe_params, moe_ffn, moe_param_specs
from ..parallel.mesh import MODEL_AXIS
from ..runtime.module import TrainModule
from ..runtime.utils import data_rows, dropout as _dropout, fold_in, seq_tokens
from .gpt2 import (GPT2Config, _embed_tokens, _layer_norm, _logits,
                   _vocab_parallel, _vocab_parallel_nll, gpt2_attn_sublayer,
                   gpt2_ffn, token_mean)


@dataclasses.dataclass(frozen=True)
class GPT2MoEConfig(GPT2Config):
    n_experts: int = 8
    moe_top_k: int = 1
    moe_layer_freq: int = 2           # every freq-th block is MoE
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    aux_loss_weight: float = 1e-2
    router_z_loss_weight: float = 0.0
    router_jitter: float = 0.0
    moe_dispatch_impl: str = "einsum"  # see MoEConfig.dispatch_impl
    # the dense/MoE alternation makes the per-layer loop heterogeneous:
    # scan_layers is refused; scan_groups is the grouped form
    scan_layers: bool = False
    scan_groups: bool = False
    stream_scan: bool = False        # one group's params fetched per group
                                     # (needs scan_groups); pair with
                                     # zero_optimization.param_streaming

    def __post_init__(self):
        super().__post_init__()
        if self.scan_layers:
            raise ValueError(
                "GPT2MoEModel always unrolls its heterogeneous layer "
                "loop; scan_layers=True is not supported")
        if self.stream_scan and not self.scan_groups:
            raise ValueError(
                "stream_scan requires scan_groups=True (the streaming "
                "fetch rides the group scan)")
        if self.moe_layer_freq < 1:
            raise ValueError(
                f"moe_layer_freq must be >= 1, got {self.moe_layer_freq}")
        if not any(self.is_moe_layer(i) for i in range(self.n_layer)):
            raise ValueError(
                f"GPT2MoEConfig with n_layer={self.n_layer}, "
                f"moe_layer_freq={self.moe_layer_freq} yields zero MoE "
                "layers — use GPT2Config/GPT2Model for a dense model")
        if self.scan_groups:
            if self.n_layer % self.moe_layer_freq != 0:
                raise ValueError(
                    f"scan_groups needs n_layer ({self.n_layer}) divisible "
                    f"by moe_layer_freq ({self.moe_layer_freq}) — the scan "
                    "body is one homogeneous group")
            freq = self.moe_layer_freq
            expect = [g * freq + freq - 1
                      for g in range(self.n_layer // freq)]
            if self.moe_layers != expect:
                raise ValueError(
                    f"scan_groups assumes MoE on the last block of each "
                    f"group (layers {expect}), but is_moe_layer yields "
                    f"{self.moe_layers} — use the unrolled path")
        self.moe_cfg()  # validate the routing knobs at config time

    def moe_cfg(self) -> MoEConfig:
        return MoEConfig(
            n_experts=self.n_experts, d_model=self.d_model,
            d_ff=4 * self.d_model, top_k=self.moe_top_k,
            capacity_factor=self.capacity_factor,
            eval_capacity_factor=self.eval_capacity_factor,
            aux_loss_weight=self.aux_loss_weight,
            z_loss_weight=self.router_z_loss_weight,
            router_jitter=self.router_jitter,
            dispatch_impl=self.moe_dispatch_impl)

    def is_moe_layer(self, i: int) -> bool:
        # MoE on the last block of each freq-group (layers 1, 3, ... for
        # freq 2) — DeepSpeed-MoE's alternating placement
        return (i % self.moe_layer_freq) == self.moe_layer_freq - 1

    @property
    def moe_layers(self):
        return [i for i in range(self.n_layer) if self.is_moe_layer(i)]

    @property
    def num_params(self) -> int:
        """Each MoE block swaps the dense FFN for E experts and the
        router."""
        d, L, E = self.d_model, self.n_layer, self.n_experts
        n_moe = len(self.moe_layers)
        attn_per_block = (4 * d            # ln1/ln2 scales+biases
                          + d * 3 * d + 3 * d
                          + d * d + d)
        dense_ffn = d * 4 * d + 4 * d + 4 * d * d + d
        moe_ffn_params = d * E + E * (d * 4 * d + 4 * d
                                      + 4 * d * d + d)
        return (self.vocab_size * d + self.n_positions * d + 2 * d
                + L * attn_per_block
                + (L - n_moe) * dense_ffn + n_moe * moe_ffn_params)


def _layers(stack):
    """Layer ``i`` of a stacked subtree: the engine's ``LayerStack``
    fetch, or for a plain dict one unbind per leaf (its backward stacks
    the layer grads once)."""
    layer = getattr(stack, "layer", None)
    if layer is not None:
        return layer
    return [dict(zip(stack, leaves)) for leaves in
            zip(*(a.unbind(0) for a in stack.values()))].__getitem__


def _dense_block(cfg, layers, i: int, d_idx: int, x, lrng, train, mesh):
    """Block ``i``: attention, then dense FFN row ``d_idx``."""
    ap = layers[0](i)
    r_attn, r_ffn = fold_in(lrng, 0), fold_in(lrng, 1)
    x = gpt2_attn_sublayer(cfg, ap, x, r_attn, train, mesh)
    h = _layer_norm(x, ap["ln2_scale"], ap["ln2_bias"])
    y = gpt2_ffn(layers[1](d_idx), h, mesh)
    return x + _dropout(y, cfg.dropout if train else 0.0, fold_in(r_ffn, 1),
                        data_rows(mesh, x.shape[0]),
                        seq_tokens(mesh, x.shape[1]))


def _moe_block(cfg, layers, i: int, m_idx: int, x, lrng, train, mesh):
    """Block ``i``: attention, then MoE row ``m_idx``; returns (x, aux)."""
    ap = layers[0](i)
    r_attn, r_ffn = fold_in(lrng, 0), fold_in(lrng, 1)
    x = gpt2_attn_sublayer(cfg, ap, x, r_attn, train, mesh)
    h = _layer_norm(x, ap["ln2_scale"], ap["ln2_bias"])
    y, aux = moe_ffn(cfg.moe_cfg(), layers[2](m_idx), h, r_ffn, train, mesh)
    return x + _dropout(y, cfg.dropout if train else 0.0, fold_in(r_ffn, 1),
                        data_rows(mesh, x.shape[0]),
                        seq_tokens(mesh, x.shape[1])), aux


def _group(cfg, layers, g: int, x, rng, train, mesh):
    """Group ``g`` of the grouped forms: freq-1 dense blocks, then the
    MoE block, keyed as the unrolled form keys layer ``g·freq + j``."""
    freq = cfg.moe_layer_freq
    for j in range(freq - 1):
        i = g * freq + j
        x = _dense_block(cfg, layers, i, g * (freq - 1) + j, x,
                         fold_in(rng, i), train, mesh)
    i = g * freq + freq - 1
    return _moe_block(cfg, layers, i, g, x, fold_in(rng, i), train, mesh)


def _run(fn, remat: bool, *args):
    if remat:
        # the blocks draw no global RNG (their seeds are host integers);
        # the layer fetches run inside, so the recompute fetches again —
        # and repeats the expert exchange
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


class GPT2MoEModel(TrainModule):
    """Causal LM where alternate blocks use a top-k routed expert FFN."""

    #: the layer-stacked subtrees the training engine fetches one layer
    #: at a time (``runtime/zero.py``)
    stacked_layers = ("attn", "dense_ffn", "moe")
    #: the engine places the experts over ``data``
    expert_parallel = True

    def __init__(self, config: GPT2MoEConfig):
        self.config = config

    @property
    def seq_parallel(self) -> bool:
        """Trains on a ``seq`` axis (ring or Ulysses attention), as
        ``GPT2Model.seq_parallel`` says: the engine gives a seq rank its
        window of the next-token rows ``[B, T+1]``."""
        return self.config.attn_impl in ("ring", "ulysses")

    def init(self, seed: int, device=None,
             dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
        """Random parameters from ``seed`` (one explicit
        ``torch.Generator`` on ``device``): the JAX init's tree, names,
        shapes and distributions — not its numbers."""
        cfg = self.config
        d, L = cfg.d_model, cfg.n_layer
        device = torch.device("cpu" if device is None else device)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        std = 0.02
        resid_std = std / math.sqrt(2.0 * L)

        def norm(shape, s=std):
            return (torch.randn(shape, generator=gen, device=device,
                                dtype=torch.float32) * s).to(dtype)

        def const(shape, value):
            return torch.full(shape, value, device=device, dtype=dtype)

        Ld = L - len(cfg.moe_layers)
        wte, wpe = norm((cfg.vocab_size, d)), norm((cfg.n_positions, d))
        attn = {
            "ln1_scale": const((L, d), 1.0),
            "ln1_bias": const((L, d), 0.0),
            "qkv_w": norm((L, d, 3, d)),
            "qkv_b": const((L, 3, d), 0.0),
            "out_w": norm((L, d, d), resid_std),
            "out_b": const((L, d), 0.0),
            "ln2_scale": const((L, d), 1.0),
            "ln2_bias": const((L, d), 0.0),
        }
        dense = {
            "fc_w": norm((Ld, d, 4 * d)),
            "fc_b": const((Ld, 4 * d), 0.0),
            "proj_w": norm((Ld, 4 * d, d), resid_std),
            "proj_b": const((Ld, d), 0.0),
        }
        mcfg = cfg.moe_cfg()
        layers = [init_moe_params(gen, mcfg, std=std, out_std=resid_std,
                                  dtype=dtype) for _ in cfg.moe_layers]
        moe = {k: torch.stack([p[k] for p in layers]) for k in layers[0]}
        return {
            "wte": wte,
            "wpe": wpe,
            "ln_f_scale": const((d,), 1.0),
            "ln_f_bias": const((d,), 0.0),
            "attn": attn,
            "dense_ffn": dense,
            "moe": moe,
        }

    def param_partition_specs(self, params) -> Dict[str, Any]:
        """The JAX model's placement as tuples: Megatron column/row
        splits over ``model``, the expert dims over ``data``."""
        m = MODEL_AXIS
        return {
            "wte": (m, None),
            "wpe": (),
            "ln_f_scale": (),
            "ln_f_bias": (),
            "attn": {
                "ln1_scale": (), "ln1_bias": (),
                "qkv_w": (None, None, None, m),
                "qkv_b": (None, None, m),
                "out_w": (None, m, None),
                "out_b": (),
                "ln2_scale": (), "ln2_bias": (),
            },
            "dense_ffn": {
                "fc_w": (None, None, m),
                "fc_b": (None, m),
                "proj_w": (None, m, None),
                "proj_b": (),
            },
            "moe": moe_param_specs(tp_axis=m, stacked=True),
        }

    def apply(self, params, tokens: torch.Tensor, rng: Optional[int],
              train: bool = True):
        """tokens [B, T] → (logits [B, T, vocab], the summed weighted aux
        loss, an fp32 scalar)."""
        cfg = self.config
        B, T = tokens.shape
        # the training engine's mesh (data rows, seq shard, expert and
        # tensor-parallel pieces), None outside it
        mesh = getattr(params["attn"], "mesh", None)
        seq = seq_tokens(mesh, T)
        off, total = seq if seq is not None else (0, T)
        if total > cfg.n_positions:
            raise ValueError(f"sequence length {total} exceeds "
                             f"n_positions={cfg.n_positions}")
        tokens = tokens.long()
        x = (_embed_tokens(cfg, params["wte"], tokens, mesh)
             + params["wpe"][off:off + T][None])
        x = _dropout(x, cfg.embd_dropout if train else 0.0,
                     fold_in(rng, 997), data_rows(mesh, B), seq)
        layers = tuple(_layers(params[k]) for k in self.stacked_layers)
        remat = cfg.remat == "block" and torch.is_grad_enabled()
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.scan_groups:
            for g in range(cfg.n_layer // cfg.moe_layer_freq):
                x, aux = _run(_group, remat, cfg, layers, g, x, rng, train,
                              mesh)
                aux_total = aux_total + aux
        else:
            d_idx = m_idx = 0
            for i in range(cfg.n_layer):
                lrng = fold_in(rng, i)
                if cfg.is_moe_layer(i):
                    x, aux = _run(_moe_block, remat, cfg, layers, i, m_idx,
                                  x, lrng, train, mesh)
                    aux_total = aux_total + aux
                    m_idx += 1
                else:
                    x = _run(_dense_block, remat, cfg, layers, i, d_idx, x,
                             lrng, train, mesh)
                    d_idx += 1
        return _logits(params, x, _vocab_parallel(cfg, params, mesh)), \
            aux_total

    def streaming_param_spec(self, params):
        """The three stacks stream (one group's rows at a time);
        embeddings and the final LN stay on the device.  None unless the
        grouped form with its per-group fetch (``stream_scan``) is on."""
        if not (self.config.scan_groups and self.config.stream_scan):
            return None
        return {k: ({n: True for n in v} if k in self.stacked_layers
                    else False)
                for k, v in params.items()}

    def loss_fn(self, params, batch, rng: Optional[int],
                train: bool = True) -> torch.Tensor:
        """Mean next-token NLL (fp32 ``log_softmax``) plus the aux loss.
        ``batch``: tokens [B, T+1] or a dict with ``input_ids`` — under a
        seq axis the rank's window of them: the NLL is a ``token_mean``
        over ``seq`` and the aux, already the whole batch's, is added
        once."""
        tokens = batch["input_ids"] if isinstance(batch, dict) else batch
        logits, aux = self.apply(params, tokens[:, :-1], rng, train)
        targets = tokens[:, 1:].long()
        mesh = getattr(params["attn"], "mesh", None)
        vmesh = _vocab_parallel(self.config, params, mesh)
        if vmesh is not None:
            nll = _vocab_parallel_nll(logits, targets, vmesh)
        else:
            logp = torch.log_softmax(logits.float(), dim=-1)
            nll = -torch.gather(logp, -1, targets[..., None])
        return token_mean(nll, mesh) + aux
