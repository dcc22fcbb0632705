"""Port parity for the BERT training family: ``DeepSpeedTransformerLayer``,
``BertModel``, fused LAMB, progressive layer drop and the engine that runs
them, against the JAX package on the same numpy parameters and batches,
on the CPU (the flash kernels' plain versions; the JAX flash arm runs its
Pallas kernels in interpret mode).

Tolerances (stated per test): layer outputs and gradients fp32 1e-5 of the
largest magnitude; BERT loss 1e-5 relative and gradients 1e-4 of each
leaf's largest gradient; LAMB updates 1e-6 relative; engine loss
trajectories fp32 1e-4 and bf16 2e-2 relative; the PLD schedule is exact.
"""
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.config import DeepSpeedConfig as JaxDeepSpeedConfig
from deepspeed_tpu.models.bert import (BertConfig as JaxBertConfig,
                                       BertModel as JaxBertModel)
from deepspeed_tpu.ops.lamb import fused_lamb as jax_fused_lamb
from deepspeed_tpu.ops.transformer import transformer as jtr
from deepspeed_tpu.parallel import build_mesh
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JaxEngine
from deepspeed_tpu.runtime.progressive_layer_drop import (
    ProgressiveLayerDrop as JaxPLD)

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.models.bert import (BERT_LARGE, BertConfig,
                                             BertModel, params_from_numpy)
from deepspeed_tpu_torch.ops.lamb import fused_lamb
from deepspeed_tpu_torch.ops.transformer import transformer as tr
from deepspeed_tpu_torch.runtime.progressive_layer_drop import (
    ProgressiveLayerDrop)
from deepspeed_tpu_torch.runtime.utils import tree_leaves

B, T, D, HEADS = 2, 32, 64, 2
SMALL = dict(vocab_size=96, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=128,
             max_position_embeddings=64, hidden_dropout_prob=0.0,
             attention_probs_dropout_prob=0.0)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _additive_mask():
    """HF additive [B, 1, 1, T]: batch row 1 pads its last 12 keys."""
    m = np.zeros((B, 1, 1, T), np.float32)
    m[1, ..., T - 12:] = -10000.0
    return m


# -- the transformer layer ----------------------------------------------


@pytest.mark.parametrize("pre_ln", [True, False], ids=["pre_ln", "post_ln"])
@pytest.mark.parametrize("impl", ["flash", "dense"])
def test_layer_matches_jax(pre_ln, impl):
    """Forward and backward (input and every parameter) against the JAX
    layer on the same arm, with a padding mask; the memory knobs on in the
    dense pre-LN case.  Within 1e-5 of each tensor's largest magnitude."""
    knobs = dict(normalize_invertible=True, gelu_checkpoint=True,
                 attn_dropout_checkpoint=True) \
        if (impl == "dense" and pre_ln) else {}
    kw = dict(hidden_size=D, heads=HEADS, pre_layer_norm=pre_ln,
              num_hidden_layers=2, attn_impl=impl, **knobs)
    jlayer = jtr.DeepSpeedTransformerLayer(
        jtr.DeepSpeedTransformerConfig(**kw))
    layer = tr.DeepSpeedTransformerLayer(tr.DeepSpeedTransformerConfig(**kw))
    tree = jax.tree.map(np.asarray, jlayer.init(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    g = rng.standard_normal((B, T, D)).astype(np.float32)
    mask = _additive_mask()

    def loss(p, x):
        out = jlayer(p, x, jnp.asarray(mask), jax.random.PRNGKey(0), True)
        return jnp.sum(out * g), out

    (_, jout), (jgp, jgx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    params = params_from_numpy(tree)
    for leaf in params.values():
        leaf.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = layer(params, xt, torch.from_numpy(mask), 0, True)
    (out * torch.from_numpy(g)).sum().backward()

    def close(a, b):
        b = np.asarray(b)
        return np.abs(a - b).max() <= 1e-5 * max(1.0, np.abs(b).max())

    assert close(out.detach().numpy(), jout)
    assert close(xt.grad.numpy(), jgx)
    for name, ref in jgp.items():
        assert close(params[name].grad.numpy(), ref), name


def test_memory_knobs_replay_dropout():
    """normalize_invertible / gelu_checkpoint / attn_dropout_checkpoint
    recompute their segments: with dropout 0.1 on both arms the outputs
    and gradients equal the knobs-off layer's (same seeds, 1e-6)."""
    for impl in ("dense", "flash"):
        base = dict(hidden_size=D, heads=HEADS, attn_impl=impl,
                    attn_dropout_ratio=0.1, hidden_dropout_ratio=0.1,
                    pre_layer_norm=False)
        results = []
        for knobs in (False, True):
            layer = tr.DeepSpeedTransformerLayer(
                tr.DeepSpeedTransformerConfig(
                    **base, normalize_invertible=knobs,
                    gelu_checkpoint=knobs, attn_dropout_checkpoint=knobs))
            params = layer.init(0)
            for leaf in params.values():
                leaf.requires_grad_(True)
            x = torch.from_numpy(np.random.default_rng(2).standard_normal(
                (B, T, D)).astype(np.float32)).requires_grad_(True)
            out = layer(params, x, torch.from_numpy(_additive_mask()), 77,
                        True)
            out.square().sum().backward()
            results.append([out.detach(), x.grad] +
                           [p.grad for p in params.values()])
        for a, b in zip(*results):
            assert (a - b).abs().max() <= 1e-6


def test_key_mask_rows_match_jax():
    """[B, T] rows for a shared mask, [B·H, T] for a per-head one, and the
    ValueError for a mask with a query dimension."""
    rng = np.random.default_rng(5)
    for shape in ((B, T), (B, 1, T), (B, 1, 1, T), (B, HEADS, 1, T)):
        m = rng.standard_normal(shape).astype(np.float32)
        mine = tr.DeepSpeedTransformerLayer._key_mask_rows(
            torch.from_numpy(m), B, HEADS, T)
        ref = jtr.DeepSpeedTransformerLayer._key_mask_rows(
            jnp.asarray(m), B, HEADS, T)
        assert np.array_equal(mine.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="q-position"):
        tr.DeepSpeedTransformerLayer._key_mask_rows(
            torch.zeros(B, 1, T, T), B, HEADS, T)


def test_transformer_config_matches_jax(tmp_path):
    cfg = {"hidden_size": 96, "heads": 4, "attn_dropout_ratio": 0.1,
           "pre_layer_norm": False, "attn_impl": "dense"}
    path = tmp_path / "layer.json"
    path.write_text(json.dumps(cfg))
    for mine, ref in ((tr.DeepSpeedTransformerConfig.from_dict(cfg),
                       jtr.DeepSpeedTransformerConfig.from_dict(cfg)),
                      (tr.DeepSpeedTransformerConfig.from_json_file(path),
                       jtr.DeepSpeedTransformerConfig.from_json_file(path))):
        assert vars(mine) == vars(ref)
        assert mine.intermediate_size == 384


# -- the model -------------------------------------------------------------


def _jax_tree(seed=0, **kw):
    jm = JaxBertModel(JaxBertConfig(**{**SMALL, **kw}, attn_impl="dense",
                                    remat=None))
    return jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))


def _batch(rows, seed=0, vocab=96):
    """The MLM + NSP recipe at a small size: 15 % of the live positions
    labelled, segment B from the middle, a quarter of the rows
    right-padded."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (rows, T)).astype(np.int32)
    mask = np.ones((rows, T), np.int32)
    for r in range(0, rows, 4):
        mask[r, T - 9 - r % 7:] = 0
    ids = np.where(mask > 0, ids, 0).astype(np.int32)
    labels = np.where((rng.random((rows, T)) < 0.15) & (mask > 0), ids,
                      -100).astype(np.int32)
    return {"input_ids": ids, "attention_mask": mask,
            "token_type_ids": (np.arange(T)[None] >= T // 2).astype(
                np.int32).repeat(rows, 0),
            "masked_lm_labels": labels,
            "next_sentence_label": rng.integers(0, 2, rows).astype(
                np.int32)}


@pytest.mark.parametrize("impl,remat,pre_ln", [("flash", "block", False),
                                               ("dense", None, True)])
def test_bert_loss_and_grads_match_jax(impl, remat, pre_ln):
    """MLM + NSP loss within 1e-5 (relative) and every gradient within
    1e-4 of its leaf's largest, dropout 0, against jax.grad(loss_fn)."""
    tree = _jax_tree(pre_layer_norm=pre_ln)
    batch = _batch(3)
    jm = JaxBertModel(JaxBertConfig(**SMALL, attn_impl="dense", remat=None,
                                    pre_layer_norm=pre_ln))
    jloss, jgrads = jax.value_and_grad(jm.loss_fn)(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(1), True)
    model = BertModel(BertConfig(**SMALL, attn_impl=impl, remat=remat,
                                 pre_layer_norm=pre_ln))
    params = params_from_numpy(tree)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    loss = model.loss_fn(params, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}, 3, train=True)
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    ref, ours = _flat(jax.tree.map(np.asarray, jgrads)), _flat(params)
    assert set(ref) == set(ours)
    for name, gr in ref.items():
        err = np.abs(ours[name].grad.numpy() - gr).max()
        assert err <= 1e-4 * max(np.abs(gr).max(), 1e-3), (name, err)


def test_bert_init_shapes_and_presets():
    model = BertModel(BertConfig(**SMALL))
    params = model.init(0)
    ref = _flat(_jax_tree())
    mine = _flat(params)
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: v.shape for k, v in ref.items()}
    assert mine["layers/attn_qkvw"].shape == (2, 64, 3, 64)
    assert abs(float(mine["word_embeddings"].std()) - 0.02) < 2e-3
    assert (BERT_LARGE.hidden_size, BERT_LARGE.num_hidden_layers,
            BERT_LARGE.num_attention_heads) == (1024, 24, 16)
    with pytest.raises(ValueError, match="max_position"):
        model.loss_fn(params, {"input_ids": torch.zeros(1, 65,
                                                        dtype=torch.long)},
                      0, train=False)


# -- LAMB ------------------------------------------------------------------


def test_lamb_matches_jax_per_leaf():
    """Five LAMB updates (weight decay, a schedule-free lr, both clamp
    bounds reached) on a tree with a stacked [L, ...] leaf, a zero leaf
    and a bias: equal to the JAX fused_lamb within 1e-6 relative.  One
    trust ratio per leaf: the stacked leaf is NOT split per layer."""
    rng = np.random.default_rng(0)
    tree = {"layers": {"w": rng.standard_normal((3, 4, 5)).astype(
                np.float32) * np.array([1, 10, 0.01], np.float32)[:, None,
                                                                  None]},
            "bias": np.zeros((5,), np.float32),
            "tiny": (rng.standard_normal((7,)) * 1e-4).astype(np.float32)}
    kw = dict(lr=1e-2, betas=(0.9, 0.99), eps=1e-6, weight_decay=0.01,
              max_coeff=5.0, min_coeff=0.1)
    jopt = jax_fused_lamb(**kw)
    opt = fused_lamb(**kw)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    params = tree_leaves(params_from_numpy(tree))
    names = list(_flat(tree))
    state = opt.init(params)
    for step in range(5):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in _flat(tree).items()}
        jg = {"layers": {"w": grads["layers/w"]}, "bias": grads["bias"],
              "tiny": grads["tiny"]}
        jupd, jstate = jopt.update(jax.tree.map(jnp.asarray, jg), jstate,
                                   jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, jupd)
        upd, state = opt.update([torch.from_numpy(grads[n]) for n in names],
                                state, params)
        params = [p + u for p, u in zip(params, upd)]
        ref = _flat(jax.tree.map(np.asarray, jupd))
        for n, u in zip(names, upd):
            scale = max(np.abs(ref[n]).max(), 1e-12)
            assert np.abs(u.numpy() - ref[n]).max() <= 1e-6 * scale, (step, n)
    assert int(state.count) == 5


# -- progressive layer drop ----------------------------------------------


def test_pld_schedule_equals_jax():
    mine, ref = ProgressiveLayerDrop(0.5, 0.01), JaxPLD(0.5, 0.01)
    assert mine.get_theta() == ref.get_theta() == 1.0
    for step in (0, 1, 7, 100, 5000):
        mine.update_state(step)
        ref.update_state(step)
        assert mine.get_theta() == ref.get_theta()
        assert mine.get_state() == ref.get_state()


def _layer_spy(model, L):
    """Replace the model's layer with one that records its index (read
    from the params: layer i's attn_nb is all i) and adds 1."""
    seen = []

    def layer(lp, x, mask, rng, train):
        seen.append(int(lp["attn_nb"][0]))
        return x + 1.0

    params = model.init(0)
    model.layer = layer
    params["layers"]["attn_nb"] = torch.arange(L, dtype=torch.float32)[
        :, None].expand(L, SMALL["hidden_size"]).clone()
    return params, seen


def test_pld_keeps_layers_at_their_depth_rate():
    """Layer i keeps with p_i = 1 - (i/L)(1 - θ): over 2000 host draws per
    layer at θ = 0.5 the kept share is within 0.05 (~5 standard
    deviations) of p_i; θ = 1 keeps every layer, and eval ignores θ."""
    L, n, theta = 4, 2000, 0.5
    model = BertModel(BertConfig(**{**SMALL, "num_hidden_layers": L},
                                 remat=None))
    params, seen = _layer_spy(model, L)
    ids = torch.zeros(1, 4, dtype=torch.long)
    for seed in range(n):
        model.encode(params, ids, rng=seed, train=True, pld_theta=theta)
    kept = np.bincount(seen, minlength=L) / n
    want = 1 - np.arange(L) / L * (1 - theta)
    assert np.abs(kept - want).max() <= 0.05, (kept, want)
    seen.clear()
    for seed in range(50):
        model.encode(params, ids, rng=seed, train=True, pld_theta=1.0)
        model.encode(params, ids, rng=seed, train=False, pld_theta=0.0)
    assert np.bincount(seen).tolist() == [100] * L


def test_pld_theta_one_equals_no_pld_exactly():
    """θ = 1 keeps every layer: loss and gradients bit-equal to the run
    without PLD (dropout 0.1 on, same seed)."""
    model = BertModel(BertConfig(**{**SMALL, "hidden_dropout_prob": 0.1,
                                    "attention_probs_dropout_prob": 0.1}))
    batch = {k: torch.from_numpy(v) for k, v in _batch(2).items()}
    outs = []
    for theta in (None, 1.0):
        params = model.init(1)
        for leaf in tree_leaves(params):
            leaf.requires_grad_(True)
        b = dict(batch) if theta is None else {**batch, "pld_theta": theta}
        loss = model.loss_fn(params, b, 11, train=True)
        loss.backward()
        outs.append([loss.detach()] + [p.grad for p in tree_leaves(params)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# -- the engine ------------------------------------------------------------


def _lamb_config(precision_):
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 2,
           "steps_per_print": 10 ** 9,
           "gradient_clipping": 1.0,
           "optimizer": {"type": "Lamb",
                         "params": {"lr": 3e-3, "weight_decay": 0.01,
                                    "max_coeff": 5.0, "min_coeff": 0.05}},
           "scheduler": {"type": "WarmupLR",
                         "params": {"warmup_num_steps": 8,
                                    "warmup_max_lr": 3e-3}}}
    if precision_ == "bf16":
        cfg["bf16"] = {"enabled": True}
    return cfg


@pytest.mark.parametrize("precision_,tol", [("fp32", 1e-4), ("bf16", 2e-2)])
def test_engine_lamb_trajectory_matches_jax_engine(precision_, tol):
    """20 steps of BERT pretraining with LAMB, WarmupLR, clipping and
    gradient accumulation 2 at ZeRO-0 on one device: every step's loss
    within ``tol`` (relative) of the JAX engine's."""
    tree = _jax_tree()
    cfg = _lamb_config(precision_)
    jeng = JaxEngine(JaxBertModel(JaxBertConfig(**SMALL, attn_impl="dense",
                                                remat=None)),
                     JaxDeepSpeedConfig(cfg, world_size=1),
                     mesh=build_mesh(pp=1, dp=1, tp=1,
                                     devices=[jax.devices()[0]]),
                     params=tree)
    eng, opt, _, _ = dst.initialize(model=BertModel(BertConfig(**SMALL)),
                                    config=cfg, params=tree, device="cpu")
    assert type(opt.init([torch.zeros(1)])).__name__ == "FusedLambState"
    for step in range(20):
        batch = _batch(4, seed=step % 3)
        ref = float(np.asarray(jeng.train_batch(batch)))
        got = float(eng.train_batch(batch))
        assert abs(got - ref) <= tol * abs(ref), (step, got, ref)
    assert abs(eng.get_lr() - jeng.get_lr()) <= 1e-9
    jeng.close()


def test_engine_pld_feeds_theta_as_a_host_float():
    """progressive_layer_drop: θ follows the JAX engine's schedule, one
    update per step, and reaches every micro-batch as a host float."""
    cfg = {**_lamb_config("fp32"),
           "progressive_layer_drop": {"enabled": True, "theta": 0.5,
                                      "gamma": 0.1}}
    model = BertModel(BertConfig(**SMALL))
    seen = []
    loss_fn = model.loss_fn

    def spy(params, batch, rng, train=True):
        seen.append(batch["pld_theta"])
        return loss_fn(params, batch, rng, train)

    model.loss_fn = spy
    eng, *_ = dst.initialize(model=model, config=cfg, device="cpu")
    ref = JaxPLD(0.5, 0.1)
    for step in range(3):
        eng.train_batch(_batch(4, seed=step))
        ref.update_state(step)
        assert seen[-2:] == [ref.get_theta()] * 2
    assert all(type(t) is float for t in seen) and seen[0] == 1.0
    assert eng.progressive_layer_drop.get_theta() == ref.get_theta()
