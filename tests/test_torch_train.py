"""Port parity for the training slice: ``deepspeed_tpu_torch``'s GPT-2
loss, its engine (``initialize`` → ``train_batch``) and its loss scaling,
against the JAX package on the same numpy parameters (``params_from_numpy``
of the JAX ``init``) and tokens, on the CPU (the flash kernels' plain
versions).  The JAX side runs its dense attention arm (with dropout 0 it
computes the same function as the flash kernels); the port runs flash.

Tolerances (stated per test): loss and gradients fp32 1e-4 (relative to
the largest gradient); engine loss trajectories fp32 1e-4 and bf16 2e-2
relative; the loss-scale grid is exact (powers of two and counters).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.config import DeepSpeedConfig as JaxDeepSpeedConfig
from deepspeed_tpu.models.gpt2 import (GPT2Config as JaxConfig,
                                       GPT2Model as JaxModel)
from deepspeed_tpu.parallel import build_mesh
from deepspeed_tpu.runtime import lr_schedules as jax_lr
from deepspeed_tpu.runtime import precision as jax_precision
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JaxEngine

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.models.gpt2 import (GPT2Config, GPT2Model,
                                             _dropout, params_from_numpy)
from deepspeed_tpu_torch.ops.kernels.flash_attention import (
    flash_attention, flash_bwd_dkv, flash_bwd_dq)
from deepspeed_tpu_torch.runtime import lr_schedules, precision
from deepspeed_tpu_torch.runtime.utils import tree_leaves

SMALL = dict(vocab_size=256, n_positions=64, d_model=128, n_layer=2,
             n_head=2)
T = 32


def _jax_tree(seed=0):
    jcfg = JaxConfig(**SMALL, remat=None, attn_impl="dense")
    return jax.tree.map(np.asarray, JaxModel(jcfg).init(
        jax.random.PRNGKey(seed)))


def _tokens(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, T + 1),
                                                np.int32)


def _flat(tree):
    if isinstance(tree, dict):
        return {f"{k}/{kk}" if isinstance(v, dict) else k: vv
                for k, v in tree.items()
                for kk, vv in (_flat(v).items() if isinstance(v, dict)
                               else [(k, v)])}
    return tree


@pytest.mark.parametrize("attn_impl,remat", [("flash", "block"),
                                             ("dense", None)])
def test_loss_and_grads_match_jax(attn_impl, remat):
    tree = _jax_tree()
    toks = _tokens(3)
    jmodel = JaxModel(JaxConfig(**SMALL, remat=None, attn_impl="dense"))
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss_fn),
                            static_argnums=3)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(toks),
        jax.random.PRNGKey(1), False)
    model = GPT2Model(GPT2Config(**SMALL, attn_impl=attn_impl, remat=remat))
    params = params_from_numpy(tree)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    loss = model.loss_fn(params, torch.from_numpy(toks), None, train=True)
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-4 * abs(float(jloss))
    ref, ours = _flat(jax.tree.map(np.asarray, jgrads)), _flat(params)
    assert set(ref) == set(ours)
    for name, g in ref.items():
        err = np.abs(ours[name].grad.numpy() - g).max()
        assert err <= 1e-4 * max(np.abs(g).max(), 1e-3), (name, err)


def _configs(precision_, ga=2):
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": ga,
           "steps_per_print": 10 ** 9,
           "gradient_clipping": 0.5,
           "optimizer": {"type": "Adam",
                         "params": {"lr": 3e-3, "weight_decay": 0.01}},
           "scheduler": {"type": "WarmupLR",
                         "params": {"warmup_num_steps": 8,
                                    "warmup_max_lr": 3e-3}}}
    if precision_ == "bf16":
        cfg["bf16"] = {"enabled": True}
    return cfg


@pytest.mark.parametrize("precision_,tol", [("fp32", 1e-4), ("bf16", 2e-2)])
def test_engine_trajectory_matches_jax_engine(precision_, tol):
    """20 steps, grad accumulation 2, clipping, WarmupLR, AdamW: the loss
    of every step agrees with the JAX engine's within ``tol``
    (relative)."""
    tree = _jax_tree()
    cfg = _configs(precision_)
    dev = jax.devices()[0]
    jeng = JaxEngine(JaxModel(JaxConfig(**SMALL, remat=None,
                                        attn_impl="dense")),
                     JaxDeepSpeedConfig(cfg, world_size=1),
                     mesh=build_mesh(pp=1, dp=1, tp=1, devices=[dev]),
                     params=tree)
    eng, opt, loader, sched = dst.initialize(
        model=GPT2Model(GPT2Config(**SMALL, remat=None)), config=cfg,
        params=tree, device="cpu")
    assert loader is None and callable(sched) and opt is eng.optimizer
    for step in range(20):
        toks = _tokens(4, seed=step % 3)
        ref = float(np.asarray(jeng.train_batch(toks)))
        got = float(eng.train_batch(toks))
        assert abs(got - ref) <= tol * abs(ref), (step, got, ref)
    assert eng.global_steps == 20 and eng.get_skipped_steps() == 0
    assert abs(eng.get_lr() - jeng.get_lr()) <= 1e-9
    m, jm = eng.last_metrics, jeng.last_metrics
    assert abs(m.grad_norm - float(jm.grad_norm)) <= \
        20 * tol * float(jm.grad_norm)


# -- the fp16 loss-scale grid of tests/test_fp16.py, against the JAX
# precision functions step by step --------------------------------------

GRID = [
    (dict(hysteresis=2), [False, False, True, False]),
    (dict(scale_window=3, hysteresis=1), [True] * 7),
    (dict(scale_window=3, hysteresis=1), [True, False, True, True, True]),
    (dict(initial_scale_power=1, hysteresis=1, min_scale=1.0),
     [False] * 5),
    (dict(static_scale=128), [False, True, False]),
    (dict(enabled=False), [False, True]),
    (dict(hysteresis=3, scale_window=2), [False, True, True, False, False,
                                          False, True]),
]


@pytest.mark.parametrize("kw,flags", GRID)
def test_loss_scale_grid_matches_jax(kw, flags):
    base = dict(enabled=True, static_scale=0, initial_scale_power=4,
                scale_window=3, hysteresis=2, min_scale=1.0)
    base.update(kw)
    js, jc = jax_precision.make_loss_scaler(**base)
    ts, tc = precision.make_loss_scaler(**base)
    assert vars(tc) == vars(jc)
    assert float(ts.loss_scale) == float(js.loss_scale)
    for finite in flags:
        js = jax_precision.update_scale(js, jnp.asarray(finite), jc)
        ts = precision.update_scale(ts, torch.tensor(finite), tc)
        assert (float(ts.loss_scale), int(ts.good_steps),
                int(ts.hysteresis)) == (float(js.loss_scale),
                                        int(js.good_steps),
                                        int(js.hysteresis))


def test_grads_finite_and_cast_match_jax():
    good = [torch.ones(3), torch.zeros(2, 2)]
    assert bool(precision.grads_finite(good))
    assert not bool(precision.grads_finite(
        good + [torch.tensor([float("inf"), 1.0])]))
    assert not bool(precision.grads_finite([torch.tensor([float("nan")])]))
    out = precision.cast_to_compute(
        {"w": torch.ones(2), "i": torch.ones(2, dtype=torch.int32)},
        torch.bfloat16)
    assert out["w"].dtype == torch.bfloat16 and out["i"].dtype == torch.int32
    assert precision.select_compute_dtype(True, True) == torch.bfloat16
    assert precision.select_compute_dtype(True, False) == torch.float16
    s, _ = precision.make_loss_scaler(initial_scale_power=3)
    g = precision.unscale_grads([torch.full((2,), 8.0)], s)
    assert torch.equal(g[0], torch.ones(2))


class _Exploding(GPT2Model):
    def loss_fn(self, params, batch, rng, train=True):
        return super().loss_fn(params, batch, rng, train) * 1e38


def test_engine_fp16_overflow_skips_step():
    """An overflowing fp16 step is skipped on the device: skipped_steps 1,
    the scale halved (hysteresis 1), params bitwise unchanged, Adam's
    count (and so the lr schedule) not advanced — as in the JAX engine."""
    cfg = {"train_micro_batch_size_per_gpu": 2, "steps_per_print": 10 ** 9,
           "fp16": {"enabled": True, "initial_scale_power": 8,
                    "hysteresis": 1},
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
    eng, *_ = dst.initialize(
        model=_Exploding(GPT2Config(**SMALL, remat=None)), config=cfg,
        params=_jax_tree(), device="cpu")
    before = [p.clone() for p in tree_leaves(eng.state.master_params)]
    eng.train_batch(_tokens(2))
    assert eng.get_skipped_steps() == 1
    assert eng.get_loss_scale() == 2.0 ** 7
    assert eng.last_metrics.overflow
    assert int(eng.state.opt_state.count) == 0
    for a, b in zip(before, tree_leaves(eng.state.master_params)):
        assert torch.equal(a, b)


def test_engine_fp16_trains_and_facade_matches_train_batch():
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 2, "steps_per_print": 10 ** 9,
           "fp16": {"enabled": True, "initial_scale_power": 12},
           "optimizer": {"type": "Adam", "params": {"lr": 3e-3}}}
    model = GPT2Model(GPT2Config(**SMALL, remat=None))
    a, *_ = dst.initialize(model=model, config=cfg, params=_jax_tree(),
                           device="cpu")
    b, *_ = dst.initialize(model=model, config=cfg, params=_jax_tree(),
                           device="cpu")
    toks = _tokens(4)
    losses = [float(a.train_batch(toks)) for _ in range(4)]
    assert losses[-1] < losses[0] and a.get_skipped_steps() == 0
    b.train_batch(toks)
    for _ in range(3):
        for i in range(2):
            micro = toks[2 * i:2 * i + 2]
            b.backward(b.forward(micro))
            assert b.is_gradient_accumulation_boundary() == (i == 1)
        b.step()
    assert b.global_steps == 4 and b.micro_steps == 8
    assert abs(float(b.last_metrics.loss) - losses[-1]) < 1e-6
    ev = float(a.eval_batch(toks[:2]))
    assert np.isfinite(ev)


def test_remat_block_equals_no_remat_under_dropout():
    """All three dropouts at 0.1: the gradients with ``remat="block"``
    (torch.utils.checkpoint recomputing each block) equal those without
    it — every mask is replayed from host seeds on recompute."""
    tree = _jax_tree()
    toks = torch.from_numpy(_tokens(2))
    grads = {}
    for remat in (None, "block"):
        model = GPT2Model(GPT2Config(**SMALL, remat=remat, dropout=0.1,
                                     embd_dropout=0.1))
        params = params_from_numpy(tree)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        model.loss_fn(params, toks, 1234, train=True).backward()
        grads[remat] = {n: p.grad for n, p in _flat(params).items()}
    for name, g in grads[None].items():
        torch.testing.assert_close(grads["block"][name], g, atol=1e-6,
                                   rtol=1e-6, msg=name)
    # and the dropout is live: another seed gives other gradients
    model = GPT2Model(GPT2Config(**SMALL, remat=None, dropout=0.1,
                                 embd_dropout=0.1))
    params = params_from_numpy(tree)
    params["wte"].requires_grad_(True)
    model.loss_fn(params, toks, 99, train=True).backward()
    assert not torch.allclose(params["wte"].grad, grads[None]["wte"])


def test_hidden_dropout_keep_fraction_and_scale():
    """The JAX package draws hidden dropout from jax.random streams the
    port cannot replay, so it is held statistically: keep fraction
    0.9 ± 5σ, kept values scaled by 1/(1-rate), dropped values 0, the
    same seed giving the same mask."""
    x = torch.ones(200, 500)
    y = _dropout(x, 0.1, 42)
    kept = y != 0
    frac = kept.float().mean().item()
    sigma = (0.9 * 0.1 / x.numel()) ** 0.5
    assert abs(frac - 0.9) < 5 * sigma
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert torch.equal(_dropout(x, 0.1, 42), y)
    assert not torch.equal(_dropout(x, 0.1, 43), y)
    assert _dropout(x, 0.0, None) is x


def test_no_kernel_launch_is_counted_on_the_cpu():
    counts = (flash_attention.launches, flash_bwd_dq.launches,
              flash_bwd_dkv.launches)
    cfg = {"train_micro_batch_size_per_gpu": 2, "steps_per_print": 10 ** 9,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
    eng, *_ = dst.initialize(
        model=GPT2Model(GPT2Config(**SMALL, dropout=0.1)), config=cfg,
        device="cpu")
    assert np.isfinite(float(eng.train_batch(_tokens(2))))
    assert (flash_attention.launches, flash_bwd_dq.launches,
            flash_bwd_dkv.launches) == counts


@pytest.mark.parametrize("name,params", [
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-3,
                     "lr_range_test_step_size": 3,
                     "lr_range_test_staircase": True}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2,
                  "cycle_first_step_size": 4, "decay_step_size": 2,
                  "decay_lr_rate": 0.5}),
    ("WarmupLR", {"warmup_num_steps": 5, "warmup_type": "linear"}),
    ("WarmupDecayLR", {"total_num_steps": 12, "warmup_num_steps": 4}),
])
def test_lr_schedules_match_jax(name, params):
    ours = lr_schedules.get_lr_schedule(name, params)
    ref = jax_lr.get_lr_schedule(name, params)
    for step in range(16):
        np.testing.assert_allclose(
            float(ours(torch.tensor(step, dtype=torch.int32))),
            float(ref(jnp.asarray(step, jnp.int32))), rtol=1e-6)
    with pytest.raises(ValueError, match="Unknown lr schedule"):
        lr_schedules.get_lr_schedule("Cosine", {})


def test_dataloader_batches_and_resume_match_jax():
    """Shuffled global batches over two epochs equal the JAX loader's for
    the same seed, and a restored state resumes at the same batch."""
    from deepspeed_tpu.runtime.dataloader import (
        DeepSpeedDataLoader as JaxLoader, RepeatingLoader as JaxRepeating)
    from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                        RepeatingLoader)
    data = [{"input_ids": row} for row in _tokens(10)]
    ours = RepeatingLoader(DeepSpeedDataLoader(data, 4, shuffle=True,
                                               seed=3))
    ref = JaxRepeating(JaxLoader(data, 4, shuffle=True, seed=3))
    for _ in range(5):  # 2 batches an epoch: wraps twice
        np.testing.assert_array_equal(next(ours)["input_ids"],
                                      next(ref)["input_ids"])
    state = ours.state_dict()
    want = [next(ours)["input_ids"] for _ in range(3)]
    resumed = RepeatingLoader(DeepSpeedDataLoader(data, 4, shuffle=True,
                                                  seed=3))
    resumed.load_state_dict(state)
    for w in want:
        np.testing.assert_array_equal(next(resumed)["input_ids"], w)


def test_initialize_with_training_data_draws_its_batches():
    data = [{"input_ids": row} for row in _tokens(8)]
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 2, "steps_per_print": 10 ** 9,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
    eng, _, loader, sched = dst.initialize(
        model=GPT2Model(GPT2Config(**SMALL, remat=None)), config=cfg,
        params=_jax_tree(), training_data=data, device="cpu")
    assert len(loader) == 2 and sched is None
    ref, *_ = dst.initialize(
        model=GPT2Model(GPT2Config(**SMALL, remat=None)), config=cfg,
        params=_jax_tree(), device="cpu")
    for i in range(2):  # the loader's batches, in order
        batch = {"input_ids": np.stack([d["input_ids"] for d in
                                        data[4 * i:4 * i + 4]])}
        assert float(eng.train_batch()) == float(ref.train_batch(batch))
    assert eng.global_steps == 2


@pytest.mark.parametrize("adam_w_mode,bias_correction,masked", [
    (True, True, False), (False, True, True), (True, False, True)])
def test_fused_adam_matches_jax(adam_w_mode, bias_correction, masked):
    """Three updates of AdamW / L2 Adam, with and without bias correction
    and a weight-decay mask, equal the JAX ``fused_adam``'s (fp32,
    1e-6 relative)."""
    from deepspeed_tpu.ops.adam import fused_adam as jax_fused_adam
    from deepspeed_tpu_torch.ops.adam import fused_adam
    rng = np.random.default_rng(0)
    shapes = ((4, 3), (5,))
    kw = dict(lr=1e-2, betas=(0.9, 0.99), eps=1e-8, weight_decay=0.1,
              adam_w_mode=adam_w_mode, bias_correction=bias_correction,
              weight_decay_mask=(lambda ps: [True, False]) if masked
              else None)
    ours, ref = fused_adam(**kw), jax_fused_adam(**kw)
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tp, jp = [torch.from_numpy(p) for p in init], [jnp.asarray(p)
                                                  for p in init]
    ts, js = ours.init(tp), ref.init(jp)
    for _ in range(3):
        g = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        tu, ts = ours.update([torch.from_numpy(x) for x in g], ts, tp)
        ju, js = ref.update([jnp.asarray(x) for x in g], js, jp)
        tp = [p + u for p, u in zip(tp, tu)]
        jp = [p + u for p, u in zip(jp, ju)]
    assert int(ts.count) == int(js.count) == 3
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
