"""BERT — the port of ``deepspeed_tpu/models/bert.py``: the encoder of
``DeepSpeedTransformerLayer`` blocks (``ops/transformer``), the embeddings
and the MLM + NSP pretraining heads.

The parameter tree keeps the JAX package's names, shapes and layouts (the
``layers`` leaves stacked ``[L, ...]``, ``attn_qkvw [L, d, 3, d]``), so
weights move across with :func:`params_from_numpy`.  The attention is the
flash kernels (``attn_impl="flash"``: non-causal, the padding mask as their
additive key mask) or the dense arm.  The large products stay
``torch.matmul``, as the JAX package leaves them to XLA.  ZeRO 1–3 and
data parallelism run BERT as any model (``runtime/zero.py``; the engine
fetches the ``layers`` one at a time, and the masked-LM loss is
normalized by the global micro-batch's label count).  Megatron tensor
parallelism follows the JAX specs (:meth:`BertModel.param_partition_specs`):
under the engine's mesh ``attn_qkvw`` and ``inter_w`` are the rank's
column pieces (its heads), ``attn_ow`` and ``output_w`` its row pieces
(each product all-reduced over ``model`` before its bias),
``word_embeddings`` and ``mlm_bias`` vocab-parallel where the vocabulary
divides (a masked lookup plus all-reduce, and the MLM loss as a
vocab-parallel cross-entropy; :meth:`BertModel.apply` gathers the logits
over ``model``).  The pipelined BERT is ``models/bert_pipe.py``.

Randomness: ``rng`` is a host integer (``runtime/module.py``); the
embedding dropout and each layer derive their seeds with
``runtime.utils.fold_in`` as the JAX model folds its key, so
``remat="block"`` (``torch.utils.checkpoint`` of each layer) replays the
same dropout.  Under a mesh the hidden dropouts draw over the global
micro-batch's rows and keep the rank's, and the attention dropout takes
the global (batch, head) ids, so training does not depend on the layout.
Progressive layer drop draws each layer's keep decision on
the host from the layer's seed and skips a dropped layer in Python: it
launches nothing and reads nothing back from the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.transformer import (DeepSpeedTransformerConfig,
                               DeepSpeedTransformerLayer)
from ..ops.transformer.transformer import _layer_norm
from ..parallel import collectives as col
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS
from ..runtime.module import TrainModule
from ..runtime.utils import data_rows, dropout, fold_in, host_uniform
from ..runtime.utils import params_from_numpy  # noqa: F401
from .gpt2 import _vocab_parallel_nll


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """The JAX package's ``BertConfig`` with its defaults.  ``scan_layers``
    changes nothing here: eager PyTorch runs the layers as a Python loop
    either way."""
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    pre_layer_norm: bool = False      # classic BERT is post-LN
    remat: Optional[str] = "block"    # None | 'block'
    normalize_invertible: bool = False
    gelu_checkpoint: bool = False
    attn_dropout_checkpoint: bool = False
    stochastic_mode: bool = False
    attn_impl: str = "flash"          # 'flash' (the CUDA kernels) | 'dense'
    scan_layers: bool = True

    def __post_init__(self):
        if self.remat not in (None, "block"):
            raise ValueError(f"remat={self.remat!r}: expected None or "
                             "'block'")


BERT_BASE = BertConfig()
BERT_LARGE = BertConfig(hidden_size=1024, num_hidden_layers=24,
                        num_attention_heads=16, intermediate_size=4096)


def _pld_theta(batch) -> Optional[float]:
    """The batch's progressive-layer-drop keep probability as a host float
    (the engine puts one there; a device tensor is read back)."""
    theta = batch.get("pld_theta")
    if theta is None:
        return None
    if isinstance(theta, torch.Tensor):
        return float(theta.reshape(-1)[0])
    return float(np.asarray(theta).reshape(-1)[0])


class BertModel(TrainModule):
    """BERT encoder with MLM + NSP pretraining loss.

    Batches: dict with ``input_ids`` [B, T]; optional ``token_type_ids``,
    ``attention_mask`` (1 keep / 0 pad), ``masked_lm_labels`` [B, T] with
    -100 for unmasked positions, ``next_sentence_label`` [B], and
    ``pld_theta`` (progressive layer drop's keep probability).
    """

    #: the layer-stacked subtree the training engine fetches one layer at
    #: a time (``runtime/zero.py``)
    stacked_layers = "layers"

    def __init__(self, config: BertConfig):
        self.config = config
        self.layer = DeepSpeedTransformerLayer(
            DeepSpeedTransformerConfig(
                hidden_size=config.hidden_size,
                intermediate_size=config.intermediate_size,
                heads=config.num_attention_heads,
                attn_dropout_ratio=config.attention_probs_dropout_prob,
                hidden_dropout_ratio=config.hidden_dropout_prob,
                num_hidden_layers=config.num_hidden_layers,
                initializer_range=config.initializer_range,
                pre_layer_norm=config.pre_layer_norm,
                normalize_invertible=config.normalize_invertible,
                gelu_checkpoint=config.gelu_checkpoint,
                attn_dropout_checkpoint=config.attn_dropout_checkpoint,
                stochastic_mode=config.stochastic_mode,
                attn_impl=config.attn_impl))

    def init(self, seed: int, device=None,
             dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
        """Random parameters from ``seed`` (``torch.Generator``s on
        ``device``: one for the embeddings and heads, one per layer): the
        JAX init's distributions (normal ``initializer_range``, the
        layers' own init), not its numbers."""
        cfg = self.config
        d, L, V = cfg.hidden_size, cfg.num_hidden_layers, cfg.vocab_size
        device = torch.device("cpu" if device is None else device)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        std = cfg.initializer_range

        def norm(*shape):
            return torch.randn(shape, generator=gen, device=device) * std

        def zeros(*shape):
            return torch.zeros(shape, device=device)

        # layer i from its own seed, as the JAX init splits keys[6 + i]
        layers = [self.layer.init(fold_in(seed, 6 + i) >> 1, device)
                  for i in range(L)]
        params = {
            "word_embeddings": norm(V, d),
            "position_embeddings": norm(cfg.max_position_embeddings, d),
            "token_type_embeddings": norm(cfg.type_vocab_size, d),
            "emb_ln_scale": torch.ones(d, device=device),
            "emb_ln_bias": zeros(d),
            "layers": {name: torch.stack([lp[name] for lp in layers])
                       for name in layers[0]},
            "pooler_w": norm(d, d),
            "pooler_b": zeros(d),
            "mlm_transform_w": norm(d, d),
            "mlm_transform_b": zeros(d),
            "mlm_ln_scale": torch.ones(d, device=device),
            "mlm_ln_bias": zeros(d),
            "mlm_bias": zeros(V),
            "nsp_w": norm(d, 2),
            "nsp_b": zeros(2),
        }
        return {k: (v.to(dtype) if not isinstance(v, dict)
                    else {n: a.to(dtype) for n, a in v.items()})
                for k, v in params.items()}

    def param_partition_specs(self, params) -> Dict[str, Any]:
        """The JAX package's Megatron placement on the ``model`` axis (a
        tuple of axis names per dim); ZeRO composes ``data`` with it."""
        m = MODEL_AXIS
        return {
            "word_embeddings": (m, None),
            "position_embeddings": (),
            "token_type_embeddings": (),
            "emb_ln_scale": (), "emb_ln_bias": (),
            "layers": {
                "attn_qkvw": (None, None, None, m),
                "attn_qkvb": (None, None, m),
                "attn_ow": (None, m, None), "attn_ob": (),
                "attn_nw": (), "attn_nb": (),
                "inter_w": (None, None, m), "inter_b": (None, m),
                "output_w": (None, m, None), "output_b": (),
                "norm_w": (), "norm_b": (),
            },
            "pooler_w": (), "pooler_b": (),
            "mlm_transform_w": (), "mlm_transform_b": (),
            "mlm_ln_scale": (), "mlm_ln_bias": (),
            "mlm_bias": (m,),
            "nsp_w": (), "nsp_b": (),
        }

    def encode(self, params, input_ids, token_type_ids=None,
               attention_mask=None, rng: Optional[int] = None,
               train: bool = True, pld_theta: Optional[float] = None):
        """→ sequence output [B, T, d] in the params' dtype.

        ``pld_theta``: progressive layer drop's keep probability θ (a host
        float).  Layer i keeps with p_i = 1 - (i/L)(1 - θ), decided on the
        host from the layer's seed; a dropped layer passes its input
        through and launches nothing.  Eval ignores it."""
        cfg = self.config
        mesh = getattr(params["layers"], "mesh", None)
        B, T = input_ids.shape
        if T > cfg.max_position_embeddings:
            raise ValueError(
                f"sequence length {T} exceeds max_position_embeddings="
                f"{cfg.max_position_embeddings}")
        if rng is None:
            rng = 0
        input_ids = input_ids.long()
        tt = (token_type_ids.long() if token_type_ids is not None
              else torch.zeros_like(input_ids))
        x = (_embed_tokens(cfg, params["word_embeddings"], input_ids, mesh)
             + params["position_embeddings"][:T][None]
             + params["token_type_embeddings"][tt])
        x = _layer_norm(x, params["emb_ln_scale"], params["emb_ln_bias"])
        x = dropout(x, cfg.hidden_dropout_prob if train else 0.0,
                    fold_in(rng, 997), data_rows(mesh, B))
        # HF-style additive mask [B, 1, 1, T]
        add_mask = None
        if attention_mask is not None:
            add_mask = (1.0 - attention_mask.float())[:, None, None, :] \
                * -10000.0
        L = cfg.num_hidden_layers
        layers = params["layers"]
        layer = getattr(layers, "layer", None)
        if layer is None:
            # one unbind per leaf: its backward stacks the layer grads once
            layer = [dict(zip(layers, leaves)) for leaves in
                     zip(*(a.unbind(0) for a in layers.values()))
                     ].__getitem__
        for i in range(L):
            lrng = fold_in(rng, i)
            if pld_theta is not None and train:
                p_keep = 1.0 - (i / L) * (1.0 - pld_theta)
                if not host_uniform(fold_in(lrng, 131)) < p_keep:
                    continue
            if cfg.remat == "block" and torch.is_grad_enabled():
                # an engine's layer fetch runs inside: the recompute
                # fetches (gathers) the layer again
                x = checkpoint(self._layer_at, layer, i, x, add_mask, lrng,
                               train, mesh, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = self._layer_at(layer, i, x, add_mask, lrng, train, mesh)
        return x

    def _layer_at(self, layer, i, x, add_mask, rng, train, mesh=None):
        kw = {} if mesh is None else {"mesh": mesh}
        return self.layer(layer(i), x, add_mask, rng, train, **kw)

    def _heads(self, params, batch, rng, train):
        """(mlm_logits, nsp_logits, the vocab-parallel mesh or None): the
        MLM logits are the rank's vocabulary slice under that mesh."""
        mesh = getattr(params["layers"], "mesh", None)
        seq = self.encode(params, batch["input_ids"],
                          batch.get("token_type_ids"),
                          batch.get("attention_mask"), rng, train,
                          pld_theta=_pld_theta(batch))
        dt = seq.dtype
        h = seq @ params["mlm_transform_w"].to(dt) \
            + params["mlm_transform_b"].to(dt)
        h = F.gelu(h, approximate="none")
        h = _layer_norm(h, params["mlm_ln_scale"], params["mlm_ln_bias"])
        vm = _vocab_parallel(self.config, params, mesh)
        if vm is not None:
            h = col.copy_to_axis(h, vm, MODEL_AXIS)
        mlm_logits = h @ params["word_embeddings"].to(dt).T \
            + params["mlm_bias"].to(dt)
        pooled = torch.tanh(seq[:, 0] @ params["pooler_w"].to(dt)
                            + params["pooler_b"].to(dt))
        nsp_logits = pooled @ params["nsp_w"].to(dt) + params["nsp_b"].to(dt)
        return mlm_logits, nsp_logits, vm

    def apply(self, params, batch, rng: Optional[int] = None,
              train: bool = True):
        """→ (mlm_logits [B, T, V], nsp_logits [B, 2]); vocab-parallel
        logits are all-gathered over ``model`` (not differentiable: the
        loss takes the rank's slice)."""
        mlm_logits, nsp_logits, vm = self._heads(params, batch, rng, train)
        if vm is not None:
            mlm_logits = col.all_gather(mlm_logits, vm, MODEL_AXIS,
                                        mlm_logits.ndim - 1)
        return mlm_logits, nsp_logits

    def loss_fn(self, params, batch, rng: Optional[int],
                train: bool = True) -> torch.Tensor:
        """Masked-LM NLL over the labelled positions plus the NSP NLL, in
        fp32."""
        mlm_logits, nsp_logits, vm = self._heads(params, batch, rng, train)
        loss = torch.zeros((), dtype=torch.float32,
                           device=mlm_logits.device)
        labels = batch.get("masked_lm_labels")
        if labels is not None:
            labels = labels.long()
            if vm is not None:
                nll = _vocab_parallel_nll(mlm_logits, labels.clamp_min(0),
                                          vm)
            else:
                logp = torch.log_softmax(mlm_logits.float(), dim=-1)
                nll = -torch.gather(logp, -1,
                                    labels.clamp_min(0)[..., None])[..., 0]
            mask = (labels >= 0).float()
            count = mask.sum()
            mesh = getattr(params["layers"], "mesh", None)
            if mesh is not None:
                # the global micro-batch's label count: the engine's mean
                # over data ranks is then the JAX loss over the global
                # micro-batch
                count = col.psum(count, mesh, DATA_AXIS) \
                    / mesh.axis_size(DATA_AXIS)
            loss = loss + (nll * mask).sum() / count.clamp_min(1.0)
        nsl = batch.get("next_sentence_label")
        if nsl is not None:
            logp = torch.log_softmax(nsp_logits.float(), dim=-1)
            loss = loss - torch.gather(logp, -1,
                                       nsl.long()[:, None]).mean()
        return loss


def _vocab_parallel(cfg: BertConfig, params, mesh):
    """``mesh`` when ``word_embeddings`` is this rank's vocab-parallel
    piece (fewer rows than the vocabulary), else None."""
    if mesh is None or \
            params["word_embeddings"].shape[0] == cfg.vocab_size:
        return None
    return mesh


def _embed_tokens(cfg: BertConfig, wte, ids, mesh):
    """``wte[ids]``; on a vocab-parallel piece, the rank's rows looked up
    (zeros for ids another rank holds) and all-reduced over ``model``."""
    if _vocab_parallel(cfg, {"word_embeddings": wte}, mesh) is None:
        return wte[ids]
    n = wte.shape[0]
    local = ids - mesh.axis_index(MODEL_AXIS) * n
    mine = (local >= 0) & (local < n)
    e = torch.where(mine[..., None], wte[local.clamp(0, n - 1)], 0.0)
    return col.reduce_from_axis(e.to(wte.dtype), mesh, MODEL_AXIS)
