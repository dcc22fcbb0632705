"""BERT as a pipeline-parallel module — the port of
``deepspeed_tpu/models/bert_pipe.py``.

Per-layer LayerSpecs over the fused ``DeepSpeedTransformerLayer`` block
(``ops/transformer``: the flash kernels on ``attn_impl="flash"``, the
rank's Megatron pieces under a mesh; reference pattern:
deepspeed/runtime/pipe/module.py:85).  The word-embedding table is a
TiedLayerSpec read again by the MLM head through the 3-ary loss; its
gradient is summed over the pipe group with the other pipe-replicated
leaves (replacing the tied-weight allreduce, reference
pipe/module.py:405-474).

Batches: ``(input_ids [B, T], masked_lm_labels [B, T])`` with -100 at
unmasked label positions (``split_bert_batch`` builds the pair from a
dict batch).  Under data parallelism the masked-LM loss is normalized by
the global micro-batch's label count, so the engine's mean over data
ranks is the JAX loss over the global micro-batch.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..ops.transformer import (DeepSpeedTransformerConfig,
                               DeepSpeedTransformerLayer)
from ..ops.transformer.transformer import _layer_norm
from ..parallel import collectives as col
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS
from ..pipe.module import LayerSpec, PipelineModule, TiedLayerSpec
from ..runtime.utils import data_rows, dropout
from .bert import BertConfig, _embed_tokens
from .gpt2 import _vocab_parallel_nll
from .gpt2_pipe import _generator

F32 = torch.float32


def _layer_cfg(cfg: BertConfig) -> DeepSpeedTransformerConfig:
    return DeepSpeedTransformerConfig(
        hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        heads=cfg.num_attention_heads,
        attn_dropout_ratio=cfg.attention_probs_dropout_prob,
        hidden_dropout_ratio=cfg.hidden_dropout_prob,
        num_hidden_layers=cfg.num_hidden_layers,
        initializer_range=cfg.initializer_range,
        pre_layer_norm=cfg.pre_layer_norm,
        normalize_invertible=cfg.normalize_invertible,
        gelu_checkpoint=cfg.gelu_checkpoint,
        attn_dropout_checkpoint=cfg.attn_dropout_checkpoint,
        stochastic_mode=cfg.stochastic_mode,
        attn_impl=cfg.attn_impl)


class BertEmbeddingPipe:
    def __init__(self, cfg: BertConfig):
        self.cfg = cfg

    def param_shapes(self):
        cfg = self.cfg
        d = cfg.hidden_size
        return {"wte": ((cfg.vocab_size, d), F32),
                "wpe": ((cfg.max_position_embeddings, d), F32),
                "tte": ((cfg.type_vocab_size, d), F32),
                "ln_scale": ((d,), F32), "ln_bias": ((d,), F32)}

    def init(self, seed: int, device=None):
        gen = _generator(seed, device)
        std = self.cfg.initializer_range
        out = {}
        for name, (shape, dt) in self.param_shapes().items():
            if name.startswith("ln_"):
                out[name] = torch.full(shape, float(name == "ln_scale"),
                                       device=device, dtype=dt)
            else:
                out[name] = torch.randn(shape, generator=gen, device=device,
                                        dtype=dt) * std
        return out

    def param_partition_specs(self):
        return {"wte": (MODEL_AXIS, None), "wpe": (), "tte": (),
                "ln_scale": (), "ln_bias": ()}

    def apply(self, params, input_ids, rng, train: bool = True, mesh=None):
        cfg = self.cfg
        B, T = input_ids.shape
        if T > cfg.max_position_embeddings:
            raise ValueError(
                f"sequence length {T} exceeds max_position_embeddings="
                f"{cfg.max_position_embeddings}")
        # pipe batches carry no token_type_ids: segment 0 for every token
        x = (_embed_tokens(cfg, params["wte"], input_ids.long(), mesh)
             + params["wpe"][:T][None] + params["tte"][0][None, None])
        x = _layer_norm(x, params["ln_scale"], params["ln_bias"])
        return dropout(x, cfg.hidden_dropout_prob if train else 0.0, rng,
                       data_rows(mesh, B))


class BertLayerPipe:
    """One fused encoder block (an unstacked DeepSpeedTransformerLayer)."""

    def __init__(self, cfg: BertConfig, layer_idx: int):
        self.cfg = cfg
        self.layer_idx = layer_idx
        self.layer = DeepSpeedTransformerLayer(_layer_cfg(cfg))

    def param_shapes(self):
        d, i = self.cfg.hidden_size, self.cfg.intermediate_size
        return {
            "attn_qkvw": ((d, 3, d), F32), "attn_qkvb": ((3, d), F32),
            "attn_ow": ((d, d), F32), "attn_ob": ((d,), F32),
            "attn_nw": ((d,), F32), "attn_nb": ((d,), F32),
            "inter_w": ((d, i), F32), "inter_b": ((i,), F32),
            "output_w": ((i, d), F32), "output_b": ((d,), F32),
            "norm_w": ((d,), F32), "norm_b": ((d,), F32),
        }

    def init(self, seed: int, device=None):
        return self.layer.init(seed, device=device)

    def param_partition_specs(self):
        m = MODEL_AXIS
        return {
            "attn_qkvw": (None, None, m), "attn_qkvb": (None, m),
            "attn_ow": (m, None), "attn_ob": (),
            "attn_nw": (), "attn_nb": (),
            "inter_w": (None, m), "inter_b": (m,),
            "output_w": (m, None), "output_b": (),
            "norm_w": (), "norm_b": (),
        }

    def apply(self, bp, x, rng, train: bool = True, mesh=None):
        kw = {} if mesh is None else {"mesh": mesh}
        return self.layer(bp, x, None, rng, train, **kw)


class BertMLMTransformPipe:
    """MLM head transform + LN (the decoder matmul happens in the tied
    loss head so it can read the embedding table)."""

    def __init__(self, cfg: BertConfig):
        self.cfg = cfg

    def param_shapes(self):
        d = self.cfg.hidden_size
        return {"w": ((d, d), F32), "b": ((d,), F32),
                "ln_scale": ((d,), F32), "ln_bias": ((d,), F32)}

    def init(self, seed: int, device=None):
        d = self.cfg.hidden_size
        gen = _generator(seed, device)
        return {"w": torch.randn((d, d), generator=gen, device=device)
                * self.cfg.initializer_range,
                "b": torch.zeros(d, device=device),
                "ln_scale": torch.ones(d, device=device),
                "ln_bias": torch.zeros(d, device=device)}

    def apply(self, params, x, rng, train: bool = True, mesh=None):
        h = x @ params["w"].to(x.dtype) + params["b"].to(x.dtype)
        h = F.gelu(h, approximate="none")
        return _layer_norm(h, params["ln_scale"], params["ln_bias"])


def bert_mlm_loss_head(params, hidden, labels, vocab_size=None):
    """Tied MLM decoder + masked cross-entropy (labels -100 = unmasked;
    the decoder weights are the embedding table — the per-vocab decoder
    bias the non-pipe BertModel carries is omitted, GPT-2 style).  Under
    the engine's mesh (``params.mesh``) the sum is divided by the global
    micro-batch's label count times the data axis's size, so the mean
    over data ranks is the loss over the global micro-batch; a ``wte``
    piece with fewer rows than ``vocab_size`` is vocab-parallel
    (:func:`build_bert_pipe` binds ``vocab_size``)."""
    wte = params["tied"]["embed"]["wte"]
    mesh = getattr(params, "mesh", None)
    labels = labels.long()
    mask = labels != -100
    if mesh is not None and vocab_size is not None \
            and wte.shape[0] != vocab_size:
        hidden = col.copy_to_axis(hidden, mesh, MODEL_AXIS)
        nll = _vocab_parallel_nll(hidden @ wte.to(hidden.dtype).T,
                                  labels.clamp_min(0), mesh)
    else:
        logp = torch.log_softmax((hidden @ wte.to(hidden.dtype).T).float(),
                                 dim=-1)
        nll = -torch.gather(logp, -1,
                            labels.clamp_min(0)[..., None])[..., 0]
    total = torch.where(mask, nll, 0.0).sum()
    count = mask.sum().float()
    if mesh is not None:
        count = col.psum(count, mesh, DATA_AXIS)
        total = total * mesh.axis_size(DATA_AXIS)
    return total / count.clamp_min(1.0)


def build_bert_pipe(cfg: BertConfig, num_stages: int,
                    partition_method: str = "type:BertLayerPipe",
                    activation_checkpoint_interval: int = 0
                    ) -> PipelineModule:
    layers = [TiedLayerSpec("embed", BertEmbeddingPipe, cfg)]
    layers += [LayerSpec(BertLayerPipe, cfg, i)
               for i in range(cfg.num_hidden_layers)]
    layers += [LayerSpec(BertMLMTransformPipe, cfg)]
    return PipelineModule(
        layers, num_stages=num_stages,
        loss_fn=functools.partial(bert_mlm_loss_head,
                                  vocab_size=cfg.vocab_size),
        partition_method=partition_method,
        activation_checkpoint_interval=activation_checkpoint_interval)


def split_bert_batch(batch):
    """dict batch → (input_ids, masked_lm_labels) for the pipeline."""
    return batch["input_ids"], batch["masked_lm_labels"]
