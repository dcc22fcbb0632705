"""GPT-2 as a pipeline-parallel module — the port of
``deepspeed_tpu/models/gpt2_pipe.py``.

Per-layer LayerSpecs instead of the stacked ``blocks`` tree, so stages can
own layer ranges (reference pattern: deepspeed/runtime/pipe/module.py:85 +
DeepSpeedExamples Megatron pipe models).  The embedding is a
TiedLayerSpec and the LM head reads the same ``wte`` through the 3-ary
loss head; its gradient is summed over the pipe group with the other
pipe-replicated leaves (replacing the tied-weight allreduce, reference
pipe/module.py:405-474).

Each block is the port's :func:`~.gpt2.gpt2_block_forward` (the flash
kernels on ``attn_impl="flash"``, Megatron pieces under a mesh).  The
JAX module's one-hot contractions for the lookup and the loss head
compute the same functions as ``wte[tokens]`` and a gathered
``log_softmax``, which are ordinary torch ops here; under a mesh whose
``model`` axis divides the vocabulary, ``wte`` is vocab-parallel (a
masked lookup plus all-reduce, and the vocab-parallel cross-entropy), as
in :class:`~.gpt2.GPT2Model`.  The blocks carry no remat of their own:
the pipeline engine checkpoints each stage as a whole (``stage_remat``).
With ``attn_impl="ring"`` or ``"ulysses"`` the module trains on a ``seq``
axis (``seq_parallel``): each rank's layers take its token shard, the
embedding offsets its positions by the shard and the loss head takes the
mean over the whole sequence (``gpt2.token_mean``).
"""
from __future__ import annotations

import functools
import math

import torch

from ..parallel import collectives as col
from ..parallel.mesh import MODEL_AXIS
from ..pipe.module import LayerSpec, PipelineModule, TiedLayerSpec
from ..runtime.utils import data_rows, dropout, seeded_generator, seq_tokens
from .gpt2 import (GPT2Config, _embed_tokens, _layer_norm,
                   _vocab_parallel_nll, gpt2_block_forward, token_mean)

F32 = torch.float32


def _generator(seed: int, device) -> torch.Generator:
    return seeded_generator(seed, "cpu" if device is None else device)


class GPT2EmbeddingPipe:
    def __init__(self, cfg: GPT2Config):
        self.cfg = cfg

    def param_shapes(self):
        cfg = self.cfg
        return {"wte": ((cfg.vocab_size, cfg.d_model), F32),
                "wpe": ((cfg.n_positions, cfg.d_model), F32)}

    def init(self, seed: int, device=None):
        gen = _generator(seed, device)
        return {name: torch.randn(shape, generator=gen, device=device,
                                  dtype=dt) * 0.02
                for name, (shape, dt) in self.param_shapes().items()}

    def param_partition_specs(self):
        return {"wte": (MODEL_AXIS, None), "wpe": ()}

    def apply(self, params, tokens, rng, train: bool = True, mesh=None):
        cfg = self.cfg
        B, T = tokens.shape
        seq = seq_tokens(mesh, T)
        off, total = seq if seq is not None else (0, T)
        if total > cfg.n_positions:
            raise ValueError(f"sequence length {total} exceeds "
                             f"n_positions={cfg.n_positions}")
        x = (_embed_tokens(cfg, params["wte"], tokens.long(), mesh)
             + params["wpe"][off:off + T][None])
        return dropout(x, cfg.embd_dropout if train else 0.0, rng,
                       data_rows(mesh, B), seq)


class GPT2BlockPipe:
    """One transformer block (the training forward's block math, over one
    layer's params)."""

    def __init__(self, cfg: GPT2Config, layer_idx: int):
        self.cfg = cfg
        self.layer_idx = layer_idx

    def param_shapes(self):
        d = self.cfg.d_model
        return {
            "ln1_scale": ((d,), F32), "ln1_bias": ((d,), F32),
            "qkv_w": ((d, 3, d), F32), "qkv_b": ((3, d), F32),
            "out_w": ((d, d), F32), "out_b": ((d,), F32),
            "ln2_scale": ((d,), F32), "ln2_bias": ((d,), F32),
            "fc_w": ((d, 4 * d), F32), "fc_b": ((4 * d,), F32),
            "proj_w": ((4 * d, d), F32), "proj_b": ((d,), F32),
        }

    def init(self, seed: int, device=None):
        """The JAX block's distributions (normal 0.02, the residual
        projections 0.02/sqrt(2L), unit LN scales, zero biases)."""
        gen = _generator(seed, device)
        std = 0.02
        resid = std / math.sqrt(2.0 * self.cfg.n_layer)
        out = {}
        for name, (shape, dt) in self.param_shapes().items():
            if name.endswith("_w"):
                s = resid if name in ("out_w", "proj_w") else std
                out[name] = torch.randn(shape, generator=gen, device=device,
                                        dtype=dt) * s
            else:
                fill = 1.0 if name.endswith("_scale") else 0.0
                out[name] = torch.full(shape, fill, device=device, dtype=dt)
        return out

    def param_partition_specs(self):
        """Megatron column/row layout (GPT2Model's stacked specs minus the
        layer axis)."""
        m = MODEL_AXIS
        return {
            "ln1_scale": (), "ln1_bias": (),
            "qkv_w": (None, None, m), "qkv_b": (None, m),
            "out_w": (m, None), "out_b": (),
            "ln2_scale": (), "ln2_bias": (),
            "fc_w": (None, m), "fc_b": (m,),
            "proj_w": (m, None), "proj_b": (),
        }

    def apply(self, bp, x, rng, train: bool = True, mesh=None):
        return gpt2_block_forward(self.cfg, bp, x, rng, train, mesh)


class GPT2FinalNormPipe:
    def __init__(self, cfg: GPT2Config):
        self.cfg = cfg

    def param_shapes(self):
        d = self.cfg.d_model
        return {"scale": ((d,), F32), "bias": ((d,), F32)}

    def init(self, seed: int, device=None):
        d = self.cfg.d_model
        return {"scale": torch.ones(d, device=device),
                "bias": torch.zeros(d, device=device)}

    def apply(self, params, x, rng, train: bool = True, mesh=None):
        return _layer_norm(x, params["scale"], params["bias"])


def gpt2_loss_head(params, hidden, labels, vocab_size=None):
    """Tied LM head + next-token CE; 3-ary so it can read the tied wte
    (labels are the raw token ids of the positions after ``hidden``'s).
    Under the engine's mesh (``params.mesh``) a ``wte`` piece with fewer
    rows than ``vocab_size`` is vocab-parallel: vocab-parallel logits and
    their cross-entropy (:func:`build_gpt2_pipe` binds ``vocab_size``);
    on a seq axis the mean is over the whole sequence."""
    wte = params["tied"]["embed"]["wte"]
    mesh = getattr(params, "mesh", None)
    labels = labels.long()
    if mesh is not None and vocab_size is not None \
            and wte.shape[0] != vocab_size:
        hidden = col.copy_to_axis(hidden, mesh, MODEL_AXIS)
        logits = hidden @ wte.to(hidden.dtype).T
        return token_mean(_vocab_parallel_nll(logits, labels, mesh), mesh)
    logits = (hidden @ wte.to(hidden.dtype).T).float()
    logp = torch.log_softmax(logits, dim=-1)
    return token_mean(-torch.gather(logp, -1, labels[..., None]), mesh)


def build_gpt2_pipe(cfg: GPT2Config, num_stages: int,
                    partition_method: str = "type:GPT2BlockPipe",
                    activation_checkpoint_interval: int = 0
                    ) -> PipelineModule:
    layers = [TiedLayerSpec("embed", GPT2EmbeddingPipe, cfg)]
    layers += [LayerSpec(GPT2BlockPipe, cfg, i) for i in range(cfg.n_layer)]
    layers += [LayerSpec(GPT2FinalNormPipe, cfg)]
    pm = PipelineModule(
        layers, num_stages=num_stages,
        loss_fn=functools.partial(gpt2_loss_head, vocab_size=cfg.vocab_size),
        partition_method=partition_method,
        activation_checkpoint_interval=activation_checkpoint_interval)
    pm.seq_parallel = cfg.attn_impl in ("ring", "ulysses")
    return pm


def split_gpt2_batch(tokens):
    """tokens [B, T+1] → (inputs [B, T], labels [B, T]) for the pipeline
    (inputs enter stage 0; labels are consumed by the last-stage loss)."""
    return tokens[:, :-1], tokens[:, 1:]


__all__ = ["GPT2EmbeddingPipe", "GPT2BlockPipe", "GPT2FinalNormPipe",
           "gpt2_loss_head", "build_gpt2_pipe", "split_gpt2_batch"]
