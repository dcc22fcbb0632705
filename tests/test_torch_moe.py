"""Port parity for the MoE layer and GPT-2 MoE: ``deepspeed_tpu_torch.moe``
and ``models/gpt2_moe.py`` against the JAX package's ``moe_ffn`` and
``GPT2MoEModel`` on the same weights (the JAX init trees carried across
with ``params_from_numpy``) and the same inputs (numpy, seeded), in fp32.

Tolerances: ``moe_ffn``'s output within 1e-5 and its aux within 1e-6
relative; the gradients with respect to every parameter and to ``x``
against ``jax.grad`` within rtol 1e-4 / atol 1e-5
(``tests/test_moe.py:349-352``); the model's logits, aux, loss and
gradients within 1e-5.  Drops are forced (capacity factor 0.5, train and
eval), the aux weight is 1.0 and the z-loss is on, so the capacity
positions, the queueing of second choices and the aux terms all show.
The port's own counterparts of ``tests/test_moe.py``'s layer cases run
on the port alone.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.gpt2_moe import (GPT2MoEConfig as JaxMoEConfig,
                                           GPT2MoEModel as JaxMoEModel)
from deepspeed_tpu.moe import (MoEConfig as JaxLayerConfig,
                               init_moe_params as jax_init_moe,
                               moe_ffn as jax_moe_ffn)
from deepspeed_tpu_torch.models import GPT2MoEConfig, GPT2MoEModel
from deepspeed_tpu_torch.models.gpt2 import params_from_numpy
from deepspeed_tpu_torch.moe import MoEConfig, init_moe_params, moe_ffn

from test_torch_zero import one_thread  # noqa: F401

LAYER = dict(n_experts=4, d_model=16, d_ff=32, capacity_factor=0.5,
             eval_capacity_factor=0.5, aux_loss_weight=1.0,
             z_loss_weight=1e-3)
MODEL = dict(vocab_size=256, n_positions=64, d_model=64, n_head=4,
             n_experts=4, attn_impl="dense", remat=None)


def _x(g=2, s=16, d=16, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (g, s, d)).astype(np.float32)


def _layer_params(top_k, seed=0):
    cfg = JaxLayerConfig(top_k=top_k, **LAYER)
    return jax.tree.map(np.asarray, jax_init_moe(jax.random.PRNGKey(seed),
                                                 cfg))


def _t(tree):
    return {k: torch.tensor(v, requires_grad=True) for k, v in tree.items()}


def _close(a, b, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# moe_ffn against the JAX layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("impl", ["einsum", "scatter"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_matches_jax(top_k, impl, train):
    """Forward (y within 1e-5, aux within 1e-6 relative) and the
    gradients of ``sum(y²) + aux`` with respect to every parameter and to
    ``x`` (rtol 1e-4 / atol 1e-5), drops forced."""
    mp = _layer_params(top_k)
    x = _x()
    jcfg = JaxLayerConfig(top_k=top_k, dispatch_impl=impl, **LAYER)
    cfg = MoEConfig(top_k=top_k, dispatch_impl=impl, **LAYER)
    assert cfg.capacity(16, train) == jcfg.capacity(16, train) == 2 * top_k

    def jloss(p, xin):
        y, aux = jax_moe_ffn(jcfg, p, xin, jax.random.PRNGKey(2), train)
        return jnp.sum(y ** 2) + aux, (y, aux)

    (_, (yj, auxj)), (gpj, gxj) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(mp, jnp.asarray(x))
    tp, tx = _t(mp), torch.tensor(x, requires_grad=True)
    y, aux = moe_ffn(cfg, tp, tx, 2, train)
    (y.square().sum() + aux).backward()
    _close(y.detach(), yj, rtol=1e-5, atol=1e-5)
    assert abs(aux.item() - float(auxj)) <= 1e-6 * abs(float(auxj))
    # some tokens were dropped: capacity 2·top_k for 16 tokens over 4
    # experts
    assert (np.abs(np.asarray(yj)).sum(-1) == 0).any()
    for k in mp:
        _close(tp[k].grad, gpj[k])
    _close(tx.grad, gxj)


def test_uniform_router_picks_expert_zero_in_both():
    """``wg = 0``: uniform probabilities, and both packages' ``argmax``
    take the first expert (top-1 and the top-2 second choice alike)."""
    from deepspeed_tpu.moe.layer import _route as jax_route
    from deepspeed_tpu_torch.moe.layer import _route
    probs = np.full((2, 5, 4), 0.25, np.float32)
    for k in (1, 2):
        ours = _route(torch.from_numpy(probs), k)
        theirs = jax_route(jnp.asarray(probs), k)
        for (i, g, m), (ij, gj, mj) in zip(ours, theirs):
            np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
            _close(g, gj, rtol=0, atol=0)
            np.testing.assert_array_equal(m.numpy(), np.asarray(mj))
    assert [int(c[0][0, 0]) for c in _route(torch.from_numpy(probs), 2)] \
        == [0, 1]


# ---------------------------------------------------------------------------
# the port's counterparts of tests/test_moe.py's layer cases
# ---------------------------------------------------------------------------
def _gen(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _dense(mp, x, e=0):
    h = torch.nn.functional.gelu(x @ mp["wi"][e] + mp["bi"][e],
                                 approximate="tanh")
    return h @ mp["wo"][e] + mp["bo"][e]


def test_single_expert_is_dense_ffn():
    cfg = MoEConfig(n_experts=1, d_model=16, d_ff=32, capacity_factor=1.0)
    mp = init_moe_params(_gen(), cfg)
    x = torch.from_numpy(_x(s=8))
    y, aux = moe_ffn(cfg, mp, x, 2, train=True)
    _close(y, _dense(mp, x), rtol=2e-5, atol=2e-5)
    assert float(aux) == pytest.approx(cfg.aux_loss_weight, rel=1e-5)


def test_top2_identical_experts_match_dense():
    cfg = MoEConfig(n_experts=2, d_model=16, d_ff=32, top_k=2,
                    capacity_factor=2.0)
    mp = init_moe_params(_gen(), cfg)
    for k in ("wi", "bi", "wo", "bo"):
        mp[k] = torch.stack([mp[k][0], mp[k][0]])
    x = torch.from_numpy(_x(s=8))
    y, _ = moe_ffn(cfg, mp, x, 2, train=True)
    _close(y, _dense(mp, x), rtol=2e-4, atol=2e-4)


def test_capacity_drops_overflow_tokens():
    cfg = MoEConfig(n_experts=4, d_model=16, d_ff=32, capacity_factor=1e-9)
    assert cfg.capacity(8, train=True) == 1
    mp = init_moe_params(_gen(), cfg)
    mp["wg"] = torch.zeros_like(mp["wg"])
    for impl in ("einsum", "scatter"):
        y, _ = moe_ffn(dataclasses.replace(cfg, dispatch_impl=impl), mp,
                       torch.from_numpy(_x(s=8)), 2, train=True)
        assert y[:, 0].abs().max() > 0, "first token must be routed"
        assert (y[:, 1:] == 0).all()


def test_aux_loss_balanced_is_one():
    cfg = MoEConfig(n_experts=4, d_model=16, d_ff=32, aux_loss_weight=1.0,
                    capacity_factor=4.0)
    mp = init_moe_params(_gen(), cfg)
    mp["wg"] = torch.zeros_like(mp["wg"])
    _, aux = moe_ffn(cfg, mp, torch.from_numpy(_x(s=8)), 2, train=True)
    assert float(aux) == pytest.approx(1.0, rel=1e-5)


def test_router_grads_flow():
    cfg = MoEConfig(n_experts=4, d_model=16, d_ff=32)
    mp = {k: v.requires_grad_() for k, v in
          init_moe_params(_gen(), cfg).items()}
    y, aux = moe_ffn(cfg, mp, torch.from_numpy(_x(s=8)), 2, train=True)
    (y.square().sum() + aux).backward()
    for k in ("wg", "wi", "wo"):
        assert mp[k].grad.abs().max() > 0, f"zero grad for {k}"


def test_jitter_is_seeded_and_train_only():
    """The router jitter draws from the seed (same seed, same output;
    another seed, another routing input) and only in training."""
    cfg = MoEConfig(n_experts=4, d_model=16, d_ff=32, router_jitter=0.5)
    mp = init_moe_params(_gen(), cfg)
    x = torch.from_numpy(_x(s=8))
    a = moe_ffn(cfg, mp, x, 5, train=True)[1]
    assert float(a) == float(moe_ffn(cfg, mp, x, 5, train=True)[1])
    assert float(a) != float(moe_ffn(cfg, mp, x, 6, train=True)[1])
    plain = dataclasses.replace(cfg, router_jitter=0.0)
    assert float(moe_ffn(cfg, mp, x, None, train=False)[1]) == \
        float(moe_ffn(plain, mp, x, None, train=False)[1])


REFUSALS = [
    (MoEConfig, dict(n_experts=1, d_model=16, d_ff=32, top_k=2), "top_k"),
    (MoEConfig, dict(n_experts=2, d_model=16, d_ff=32, top_k=3), "top_k"),
    (MoEConfig, dict(n_experts=0, d_model=16, d_ff=32), "n_experts"),
    (MoEConfig, dict(n_experts=2, d_model=8, d_ff=16,
                     dispatch_impl="sorted"), "dispatch_impl"),
    ("model", dict(scan_layers=True), "scan_layers"),
    ("model", dict(n_layer=4, stream_scan=True), "scan_groups"),
    ("model", dict(moe_layer_freq=0), "moe_layer_freq"),
    ("model", dict(n_layer=1, moe_layer_freq=2), "zero MoE"),
    ("model", dict(n_layer=3, scan_groups=True), "divisible"),
    ("model", dict(moe_top_k=3), "top_k"),
    ("model", dict(moe_dispatch_impl="sorted"), "dispatch_impl"),
]


@pytest.mark.parametrize("kind,kw,match", REFUSALS)
def test_config_refusals(kind, kw, match):
    """Every config check of both packages: the port raises the JAX
    package's ValueError on the same fields."""
    if kind == "model":
        base = dict(MODEL, n_layer=2)
        base.update(kw)
        pairs = ((GPT2MoEConfig, base), (JaxMoEConfig, base))
    else:
        pairs = ((MoEConfig, kw), (JaxLayerConfig, kw))
    for cls, args in pairs:
        with pytest.raises(ValueError, match=match):
            cls(**args)


def test_scan_groups_equals_unrolled():
    """The grouped form runs the unrolled form's math and per-layer
    seeds: equal logits and aux with dropout and jitter on, with and
    without a checkpointed group, and equal gradients."""
    cfg_u = GPT2MoEConfig(**{**MODEL, "n_layer": 4, "dropout": 0.1,
                             "embd_dropout": 0.1, "router_jitter": 0.1})
    params = GPT2MoEModel(cfg_u).init(0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 16)))
    outs = {}
    for name, kw in (("unrolled", {}), ("groups", {"scan_groups": True}),
                     ("groups_remat", {"scan_groups": True,
                                       "remat": "block"})):
        p = {k: ({n: a.clone().requires_grad_() for n, a in v.items()}
                 if isinstance(v, dict) else v.clone().requires_grad_())
             for k, v in params.items()}
        model = GPT2MoEModel(dataclasses.replace(cfg_u, **kw))
        logits, aux = model.apply(p, toks, 3, train=True)
        (logits.square().mean() + aux).backward()
        outs[name] = (logits.detach(), aux.item(), p["moe"]["wg"].grad)
    for name in ("groups", "groups_remat"):
        _close(outs[name][0], outs["unrolled"][0], rtol=1e-5, atol=1e-5)
        assert outs[name][1] == pytest.approx(outs["unrolled"][1],
                                              rel=1e-6)
        _close(outs[name][2], outs["unrolled"][2], rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# GPT2MoEModel against the JAX model
# ---------------------------------------------------------------------------
def _jax_tree(**kw):
    cfg = JaxMoEConfig(**{**MODEL, **kw})
    return cfg, jax.tree.map(np.asarray, JaxMoEModel(cfg).init(
        jax.random.PRNGKey(0)))


def _names_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_names_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


@pytest.mark.parametrize("n_layer,freq", [(2, 2), (4, 2), (3, 1)])
def test_init_tree_names_and_shapes_equal_jax(n_layer, freq):
    """The JAX init tree moves across unchanged: every name and shape of
    the port's own ``init`` equals the JAX model's."""
    _, tree = _jax_tree(n_layer=n_layer, moe_layer_freq=freq)
    ours = GPT2MoEModel(GPT2MoEConfig(**{**MODEL, "n_layer": n_layer,
                                         "moe_layer_freq": freq})).init(0)
    assert _names_shapes(ours) == _names_shapes(tree)
    params = params_from_numpy(tree)
    assert _names_shapes(params) == _names_shapes(tree)
    cfg = GPT2MoEConfig(**{**MODEL, "n_layer": n_layer,
                           "moe_layer_freq": freq})
    n = sum(int(np.prod(s)) for s in _names_shapes(tree).values())
    assert cfg.num_params == n


FORMS = [
    ("unrolled", dict(n_layer=2)),
    ("unrolled_top2", dict(n_layer=4, moe_top_k=2)),
    ("scatter", dict(n_layer=2, moe_dispatch_impl="scatter", moe_top_k=2)),
    ("scan_groups", dict(n_layer=4, scan_groups=True, remat="block")),
    ("stream_scan", dict(n_layer=4, scan_groups=True, stream_scan=True,
                         remat="block")),
]


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name,kw", FORMS)
def test_model_matches_jax(name, kw, train):
    """``apply``'s logits and aux, ``loss_fn`` and its gradient on every
    leaf, on the JAX init tree: within 1e-5 (aux weight 1.0, z-loss on,
    capacity factor 0.5)."""
    kw = dict(kw, aux_loss_weight=1.0, router_z_loss_weight=1e-3,
              capacity_factor=0.5, eval_capacity_factor=0.5)
    jcfg, tree = _jax_tree(**kw)
    toks = np.random.default_rng(1).integers(0, 256, (2, 17)).astype(
        np.int32)
    jmodel = JaxMoEModel(jcfg)
    logits_j, aux_j = jmodel.apply(tree, jnp.asarray(toks[:, :-1]),
                                   jax.random.PRNGKey(0), train)
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jnp.asarray(toks),
                                 jax.random.PRNGKey(0), train))(tree)
    model = GPT2MoEModel(GPT2MoEConfig(**{**MODEL, **kw}))
    params = params_from_numpy(tree)
    with torch.no_grad():
        logits, aux = model.apply(params, torch.from_numpy(toks[:, :-1]),
                                  0, train)
    _close(logits, logits_j, rtol=1e-5, atol=1e-5)
    assert float(aux) == pytest.approx(float(aux_j), rel=1e-5)
    for leaf in (v for t in params.values() for v in (
            t.values() if isinstance(t, dict) else [t])):
        leaf.requires_grad_()
    loss = model.loss_fn(params, torch.from_numpy(toks), 0, train)
    loss.backward()
    assert float(loss) == pytest.approx(float(loss_j), rel=1e-5)
    for k, v in params.items():
        for n, t in (v.items() if isinstance(v, dict) else [(None, v)]):
            want = grads_j[k] if n is None else grads_j[k][n]
            _close(t.grad, want, rtol=1e-5, atol=1e-5)
