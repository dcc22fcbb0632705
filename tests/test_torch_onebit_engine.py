"""Port parity for 1-bit Adam in the engine: ``initialize()`` with
``"optimizer": {"type": "OneBitAdam"}`` at ZeRO 0, on gloo ranks, against
the JAX engine on the virtual CPU mesh (``tests/test_onebit_engine.py``'s
cases, and dryrun leg 7).

Three rank jobs, launched together by a module fixture once the JAX
references that they load have been written:

  - 8 ranks, ``SimpleModel`` (hidden 32, 2 layers), fp32, freeze step 3:
    3 warm and 3 frozen steps against the JAX dp-8 engine at 1e-5 (the
    losses, the master, μ, ν and every rank's error rows), the wire of a
    warm and a frozen step, the warm trajectory with freeze step 100, a
    full and a module-only restore, and the JAX dp-8 checkpoint loaded
    and stepped (the port's is loaded into the JAX engine here);
  - 4 ranks: dryrun leg 7 (``__graft_entry__.py:386``: the dryrun's GPT-2,
    bf16, freeze step 1; the warm step's loss within 1 % of the JAX
    one-device loss, the frozen one finite), and the refusals of a
    pipeline, a seq axis and experts at dp > 1;
  - 2 ranks: fp16 with an overflowing second step at dp 2 (the host
    picks the frozen step by the dispatch counter, so step 3 is frozen),
    and the refusals of tensor-parallel and pipeline pieces at dp 1.

In process: fp16 at dp 1 (the branch follows the applied count, so step
3 is still warm), the config refusals, and 1-bit Adam at dp 1 through
``initialize``.  Both packages' config checks refuse 1-bit Adam without
fp16/bf16, so an fp32 config is built with bf16 on and bf16 switched off
after (``built``), as ``tests/test_torch_zero.py`` builds its fp32 ZeRO
configs.

Sign flips: an element whose compression sign differs from the JAX
engine's moves its error buffer by 2·scale.  Each one is reported with
its margin |buf| / scale, and must be a near-tie (margin < 1e-5); its
element is then left out of the later comparisons of that leaf.  Any
other difference fails the 1e-5 bar.
"""
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from test_torch_zero import spawn_ranks
from test_torch_zero import one_thread  # noqa: F401

HIDDEN, NLAYERS = 32, 2
DP, MICRO, FREEZE = 8, 8, 3
STEPS = 6
LR = 5e-3
RTOL = 1e-5
#: fp16 engines: their gradients are the fp16 compute params', so an
#: element whose fp32 value lands on the other side of an fp16 rounding
#: boundary (reduction order) differs by one fp16 step, 2^-11 of itself
FP16_RTOL = 1e-3
NEAR_TIE = 1e-5
#: the dryrun's GPT-2 (__graft_entry__.py:121)
LEG7 = dict(vocab_size=256, n_positions=64, d_model=64, n_layer=2,
            n_head=4, remat="block")


def conf(freeze=FREEZE, precision="fp32", micro=MICRO, lr=LR, stage=0,
         **over):
    cfg = {"train_micro_batch_size_per_gpu": micro,
           "gradient_accumulation_steps": 1,
           "steps_per_print": 10 ** 6,
           "zero_optimization": {"stage": stage},
           "optimizer": {"type": "OneBitAdam",
                         "params": {"lr": lr, "freeze_step": freeze}},
           **over}
    if precision == "fp16":
        # a loss scale the fp16 gradients hold (2^32 overflows them all)
        cfg["fp16"] = {"enabled": True, "initial_scale_power": 8}
    elif precision != "fp32":
        cfg[precision] = {"enabled": True}
    return cfg


def fp16_conf():
    """The fp16 skip tests' config: freeze step 2, 4 rows a rank."""
    return conf(freeze=2, precision="fp16", micro=4, lr=1e-4)


def built(config_cls, cfg, world):
    """``config_cls(cfg, world)``; an fp32 1-bit config is built with bf16
    on and bf16 switched off after (both config checks refuse 1-bit Adam
    without fp16/bf16)."""
    fp32 = "bf16" not in cfg and "fp16" not in cfg
    out = config_cls({**cfg, "bf16": {"enabled": True}} if fp32 else cfg,
                     world_size=world)
    if fp32:
        out.bf16.enabled = False
    return out


def batches(n=STEPS + 1, rows=DP * MICRO, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.standard_normal((rows, HIDDEN)).astype(np.float32)
        out.append((x, (0.5 * x).astype(np.float32)))
    return out


class SimpleModel:
    """tests/simple_model.py's linear stack + MSE, in torch."""

    def __init__(self, hidden_dim=HIDDEN, nlayers=NLAYERS):
        self.hidden_dim, self.nlayers = hidden_dim, nlayers

    def init(self, seed, device=None):
        raise NotImplementedError("the tests pass the JAX init tree")

    def loss_fn(self, params, batch, rng, train=True):
        x, y = batch
        h = x
        for i in range(self.nlayers):
            h = h @ params[f"w{i}"].to(h.dtype) + params[f"b{i}"].to(h.dtype)
            if i < self.nlayers - 1:
                h = torch.relu(h)
        return torch.mean((h.float() - y.float()) ** 2)


def port_engine(cfg, tree, mesh=None, dp=DP, model=None):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.config import DeepSpeedConfig
    eng, *_ = dst.initialize(model=model or SimpleModel(),
                             config=built(DeepSpeedConfig, cfg, dp),
                             params=tree, mesh=mesh, device="cpu")
    return eng


def jax_engine(cfg, tree, dp=DP):
    import jax
    from deepspeed_tpu.config import DeepSpeedConfig
    from deepspeed_tpu.parallel import build_mesh
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine
    from simple_model import SimpleModel as JaxSimple
    return DeepSpeedEngine(
        JaxSimple(hidden_dim=HIDDEN, nlayers=NLAYERS),
        built(DeepSpeedConfig, cfg, dp),
        mesh=build_mesh(dp=dp, devices=jax.devices()[:dp]), params=tree)


def state_of(eng):
    """The port engine's (master, μ, ν, worker rows, server rows) as
    dicts of numpy arrays by name, and the count."""
    master, opt = eng._canonical_state()
    np_ = lambda tr: {k: v.detach().numpy().copy() for k, v in tr.items()}
    return {"master": np_(master), "mu": np_(opt.mu), "nu": np_(opt.nu),
            "we": np_(opt.worker_error), "se": np_(opt.server_error),
            "count": int(opt.count)}


def jax_state(eng):
    import jax
    st = eng.state.opt_state
    np_ = lambda tr: jax.tree.map(np.asarray, dict(tr))
    return {"master": np_(eng.state.master_params), "mu": np_(st.mu),
            "nu": np_(st.nu), "we": np_(st.worker_error),
            "se": np_(st.server_error), "count": int(st.count)}


def _train(eng, blist, dp, d):
    from deepspeed_tpu_torch.runtime.dataloader import rank_rows
    return [float(eng.train_batch(rank_rows(b, 1, dp, d))) for b in blist]


# ---------------------------------------------------------------------------
# the rank jobs
# ---------------------------------------------------------------------------
def _job8(rank, world, tree, blist, work):
    from deepspeed_tpu_torch.compress import padded_size
    from deepspeed_tpu_torch.parallel import build_mesh
    from deepspeed_tpu_torch.parallel import collectives as col
    mesh = build_mesh(dp=world)
    d = mesh.axis_index("data")
    out = {"data_index": d, "steps": []}
    eng = port_engine(conf(), tree, mesh)
    for i, b in enumerate(blist[:STEPS]):
        col.onebit_stats.clear()
        with col.recorded() as log:
            loss = _train(eng, [b], world, d)[0]
        out["steps"].append({"loss": loss, "state": state_of(eng),
                             "log": list(log),
                             "stats": dict(col.onebit_stats)})
        if i == 3:
            eng.save_checkpoint(os.path.join(work, "port4"), tag="t4")
    out["sizes"] = {k: (v.size, padded_size(v.size, world))
                    for k, v in out["steps"][0]["state"]["master"].items()}
    eng.save_checkpoint(os.path.join(work, "port6"), tag="t6")
    saved = state_of(eng)
    out["step7"] = _train(eng, blist[STEPS:], world, d)[0]
    out["after7"] = state_of(eng)
    eng.close()
    # the warm trajectory does not depend on freeze_step
    eng = port_engine(conf(freeze=100), tree, mesh)
    out["far"] = {"losses": _train(eng, blist[:FREEZE], world, d),
                  "state": state_of(eng)}
    eng.close()
    # a full restore keeps this rank's rows; the next step is the same
    eng = port_engine(conf(), tree, mesh)
    eng.load_checkpoint(os.path.join(work, "port6"), tag="t6")
    restored = state_of(eng)
    out["full"] = {"rows_equal": all(
        np.array_equal(restored[f][k], saved[f][k])
        for f in ("we", "se", "mu", "nu", "master") for k in saved[f]),
        "count": restored["count"], "global_steps": eng.global_steps,
        "step7": _train(eng, blist[STEPS:], world, d)[0]}
    eng.close()
    # a module-only restore: fresh per-rank rows sized for dp 8
    eng = port_engine(conf(), tree, mesh)
    eng.load_checkpoint(os.path.join(work, "port6"), tag="t6",
                        load_module_only=True)
    st = state_of(eng)
    out["module_only"] = {
        "shapes": {k: v.shape for k, v in st["we"].items()},
        "se_shapes": {k: v.shape for k, v in st["se"].items()},
        "zeros": all(not v.any() for v in st["we"].values()),
        "count": st["count"],
        "step7": _train(eng, blist[STEPS:], world, d)[0]}
    eng.close()
    # the JAX engine's dp-8 checkpoint after step 4, stepped once
    eng = port_engine(conf(), tree, mesh)
    eng.load_checkpoint(os.path.join(work, "jax4"))
    out["from_jax"] = {"loss": _train(eng, [blist[4]], world, d)[0],
                       "state": state_of(eng)}
    eng.close()
    return out


def _job4(rank, world, leg7_tree, toks7, moe_tree):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.config import DeepSpeedConfig
    from deepspeed_tpu_torch.models import GPT2MoEConfig, GPT2MoEModel
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from deepspeed_tpu_torch.models.gpt2_pipe import build_gpt2_pipe
    from deepspeed_tpu_torch.parallel import build_mesh
    from deepspeed_tpu_torch.parallel import collectives as col
    from deepspeed_tpu_torch.runtime.dataloader import rank_rows
    out = {}
    # dryrun leg 7: bf16, freeze step 1, micro 1
    mesh = build_mesh(dp=world)
    d = mesh.axis_index("data")
    cfg7 = conf(freeze=1, precision="bf16", micro=1, lr=1e-3)
    eng = port_engine(cfg7, leg7_tree, mesh, dp=world,
                      model=GPT2Model(GPT2Config(**LEG7)))
    rows = rank_rows(toks7, 1, world, d)
    col.onebit_stats.clear()
    out["warm"] = float(eng.train_batch(rows))
    warm_stats = dict(col.onebit_stats)
    out["frozen"] = float(eng.train_batch(rows))
    out["stats"] = (warm_stats, dict(col.onebit_stats))
    out["we_max"] = max(float(v.abs().max())
                        for v in eng.state.opt_state.worker_error)
    eng.close()

    def refused(build):
        try:
            build().close()
        except Exception as e:  # noqa: BLE001 — the test reads the class
            return type(e).__name__, str(e)
        return None

    tiny = dict(vocab_size=128, n_positions=16, d_model=32, n_layer=2,
                n_head=4, remat=None, attn_impl="dense")
    out["pipe_dp2"] = refused(lambda: dst.initialize(
        model=build_gpt2_pipe(GPT2Config(**tiny), 2),
        config=built(DeepSpeedConfig, conf(micro=1, precision="bf16"), 2),
        mesh=build_mesh(pp=2, dp=2), device="cpu")[0])
    for impl in ("ring", "ulysses"):
        out[f"seq_dp2_{impl}"] = refused(lambda: dst.initialize(
            model=GPT2Model(GPT2Config(**{**tiny, "attn_impl": impl})),
            config=built(DeepSpeedConfig, conf(micro=1, precision="bf16"),
                         2),
            mesh=build_mesh(dp=2, sp=2), device="cpu")[0])
    out["moe_dp4"] = refused(lambda: dst.initialize(
        model=GPT2MoEModel(GPT2MoEConfig(**tiny, n_experts=4)),
        config=built(DeepSpeedConfig, conf(micro=1, precision="bf16"),
                     world),
        params=moe_tree, mesh=build_mesh(dp=world), device="cpu")[0])
    return out


def _job2(rank, world, tree, fp16_batches, gpt_tree):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.config import DeepSpeedConfig
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from deepspeed_tpu_torch.models.gpt2_pipe import build_gpt2_pipe
    from deepspeed_tpu_torch.parallel import build_mesh
    from deepspeed_tpu_torch.runtime.dataloader import rank_rows
    out = {}
    mesh = build_mesh(dp=world)
    d = mesh.axis_index("data")
    eng = port_engine(fp16_conf(), tree, mesh,
                      dp=world)
    out["fp16"] = []
    for b in fp16_batches:
        loss = float(eng.train_batch(rank_rows(b, 1, world, d)))
        out["fp16"].append({"loss": loss, "state": state_of(eng),
                            "skipped": eng.get_skipped_steps(),
                            "scale": eng.get_loss_scale()})
    eng.close()

    def refused(build):
        try:
            build().close()
        except Exception as e:  # noqa: BLE001 — the test reads the class
            return type(e).__name__, str(e)
        return None

    tiny = dict(vocab_size=128, n_positions=16, d_model=32, n_layer=2,
                n_head=4, remat=None, attn_impl="dense")
    cfg1 = built(DeepSpeedConfig, conf(micro=1, precision="bf16"), 1)
    out["tp2"] = refused(lambda: dst.initialize(
        model=GPT2Model(GPT2Config(**tiny)), config=cfg1,
        mesh=build_mesh(dp=1, tp=2), device="cpu")[0])
    out["pipe_dp1"] = refused(lambda: dst.initialize(
        model=build_gpt2_pipe(GPT2Config(**tiny), 2), config=cfg1,
        mesh=build_mesh(pp=2, dp=1), device="cpu")[0])
    # 1-bit Adam at dp 1 composes with a seq axis (the plain step, as in
    # the JAX engine): two ring steps run
    eng = dst.initialize(model=GPT2Model(GPT2Config(**{**tiny,
                                                       "attn_impl": "ring"})),
                         config=cfg1, params=gpt_tree,
                         mesh=build_mesh(dp=1, sp=2), device="cpu")[0]
    toks = np.random.default_rng(0).integers(0, 128, (1, 17))
    out["seq_dp1"] = [float(eng.train_batch(toks)) for _ in range(2)]
    eng.close()
    return out


# ---------------------------------------------------------------------------
# fixtures: the JAX references first (the 8-rank job loads the JAX
# checkpoint), then the jobs, launched together
# ---------------------------------------------------------------------------
def _jax_tree(model):
    import jax
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("onebit_engine")


@pytest.fixture(scope="module")
def tree():
    from simple_model import SimpleModel as JaxSimple
    return _jax_tree(JaxSimple(hidden_dim=HIDDEN, nlayers=NLAYERS))


@pytest.fixture(scope="module")
def jax_dp8(tree, work):
    """The JAX dp-8 engine's 6 steps (saving after step 4), its 7th, and
    a far-freeze engine's 3 warm steps."""
    blist = batches()
    eng = jax_engine(conf(), tree)
    steps = []
    for i, b in enumerate(blist[:STEPS]):
        steps.append({"loss": float(np.asarray(eng.train_batch(b))),
                      "state": jax_state(eng)})
        if i == 3:
            eng.save_checkpoint(str(work / "jax4"))
    step7 = float(np.asarray(eng.train_batch(blist[STEPS])))
    far = jax_engine(conf(freeze=100), tree)
    far_losses = [float(np.asarray(far.train_batch(b)))
                  for b in blist[:FREEZE]]
    return {"steps": steps, "step7": step7, "far": far_losses}


def _fp16_batches(rows):
    b = batches(4, rows=rows, seed=9)
    x, y = b[1]
    b[1] = (x * np.float32(1e30), y)      # overflows: the step is skipped
    return b


@pytest.fixture(scope="module")
def leg7():
    from deepspeed_tpu.models.gpt2 import GPT2Config, GPT2Model
    cfg = GPT2Config(**LEG7)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (4, 33),
                                             dtype=np.int32)
    return _jax_tree(GPT2Model(cfg)), toks


@pytest.fixture(scope="module")
def launched(tree, work, jax_dp8, leg7):
    from deepspeed_tpu.models.gpt2 import GPT2Config, GPT2Model
    from deepspeed_tpu.models.gpt2_moe import GPT2MoEConfig, GPT2MoEModel
    tiny = dict(vocab_size=128, n_positions=16, d_model=32, n_layer=2,
                n_head=4, remat=None, attn_impl="dense")
    moe_tree = _jax_tree(GPT2MoEModel(GPT2MoEConfig(**tiny, n_experts=4)))
    gpt_tree = _jax_tree(GPT2Model(GPT2Config(**tiny)))
    pool = ThreadPoolExecutor(3)
    futs = {8: pool.submit(spawn_ranks, _job8, 8, work, tree, batches(),
                           str(work)),
            4: pool.submit(spawn_ranks, _job4, 4, work, *leg7, moe_tree),
            2: pool.submit(spawn_ranks, _job2, 2, work, tree,
                           _fp16_batches(8), gpt_tree)}
    yield futs
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def job8(launched):
    return launched[8].result()


@pytest.fixture(scope="module")
def job4(launched):
    return launched[4].result()


@pytest.fixture(scope="module")
def job2(launched):
    return launched[2].result()


# ---------------------------------------------------------------------------
# comparison with the near-tie rule
# ---------------------------------------------------------------------------
def _flips(got, want, d, chunk, floor):
    """Elements of a rank's error row whose compression sign differs from
    the reference's: (padded index, margin |buf| / scale).  A flip moves
    the residual by 2·scale; the reference's buf is its residual plus
    scale in the direction of the move.  ``d``/``chunk`` map a server
    row to padded indices; ``floor`` is the magnitude of the μ the row is
    the residual of (a server row over the padded tail re-compresses a
    constant: its residual is rounding-sized)."""
    diff = got.astype(np.float64) - want.astype(np.float64)
    tol = RTOL * max(np.abs(want).max(), floor, 1e-30)
    out = []
    for j in np.nonzero(np.abs(diff) > tol)[0]:
        scale = abs(diff[j]) / 2
        buf = want[j] + scale * np.sign(diff[j])
        out.append((d * chunk + int(j), abs(buf) / scale))
    return out


def _check_rank_steps(rank, ref_steps, sizes, dp, first=1):
    """One rank's steps (the first numbered ``first``) against the JAX
    engine's: losses, master, μ, ν at RTOL, its error rows at RTOL of the
    μ they are residuals of, except near-tie flips (reported, then left
    out of that leaf)."""
    d = rank["data_index"]
    excluded = {k: set() for k in sizes}
    report = []
    for i, (got, ref) in enumerate(zip(rank["steps"], ref_steps)):
        assert got["loss"] == pytest.approx(ref["loss"], rel=RTOL), i
        g, r = got["state"], ref["state"]
        assert g["count"] == r["count"] == i + first
        for k, (n, P) in sizes.items():
            chunk = P // dp
            m = np.abs(r["mu"][k]).max()
            flips = (_flips(g["we"][k], r["we"][k][d], 0, P, m)
                     + _flips(g["se"][k], r["se"][k][d], d, chunk, m))
            for idx, margin in flips:
                report.append((i + first, k, idx, margin))
                assert margin < NEAR_TIE, (
                    f"step {i + first} leaf {k} element {idx}: sign differs "
                    f"from the JAX engine's at margin {margin:.3g} "
                    f"(near-tie bar {NEAR_TIE})")
                excluded[k].add(idx)
            keep = np.ones(P, bool)
            keep[sorted(excluded[k])] = False
            for f in ("master", "mu", "nu"):
                a, b = g[f][k].reshape(-1), r[f][k].reshape(-1)
                ka = keep[:n]
                assert np.abs(a[ka] - b[ka]).max() <= RTOL * max(
                    np.abs(b).max(), 1e-30), (i, f, k)
            for f, row, sel in (("we", r["we"][k][d], keep),
                                ("se", r["se"][k][d],
                                 keep[d * chunk:(d + 1) * chunk])):
                a = g[f][k]
                assert np.abs(a[sel] - row[sel]).max() <= RTOL * max(
                    np.abs(row).max(), m), (i, f, k)
    if report:
        print(f"rank {d}: near-tie sign flips (step, leaf, element, "
              f"margin): {report}")
    return report


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
def test_dp8_through_the_freeze_boundary(job8, jax_dp8):
    """3 warm and 3 frozen fp32 steps on 8 ranks: every rank's losses,
    master, μ and ν within 1e-5 of the JAX dp-8 engine's at every step,
    and its own worker and server error rows within 1e-5 of the JAX
    engine's rows for that worker (near-tie flips reported); ν unchanged
    once frozen, the error rows nonzero."""
    for rank in job8:
        _check_rank_steps(rank, jax_dp8["steps"], job8[0]["sizes"], DP)
        st = [s["state"] for s in rank["steps"]]
        for k in st[0]["nu"]:
            for later in st[FREEZE:]:
                np.testing.assert_array_equal(later["nu"][k],
                                              st[FREEZE - 1]["nu"][k])
            assert not st[FREEZE - 1]["we"][k].any()
            assert st[-1]["we"][k].any()
    # the masters are bitwise equal on every rank after each step
    for i in range(STEPS):
        for k in job8[0]["sizes"]:
            for rank in job8[1:]:
                np.testing.assert_array_equal(
                    rank["steps"][i]["state"]["master"][k],
                    job8[0]["steps"][i]["state"]["master"][k])


def test_wire_of_the_warm_and_the_frozen_step(job8):
    """In place of the JAX test's HLO scan (``tests/test_onebit_engine.py
    :83``): the frozen step's float collectives are scalar bookkeeping of
    at most 4·dp elements, its momentum crosses as uint8 (the all-to-all
    of ``[dp, P/8dp]`` and the all-gather of ``[P/8dp]`` a leaf, bytes
    from ``padded_size``), and the warm step's fp32 gradient average
    covers the largest leaf."""
    sizes = job8[0]["sizes"]
    biggest = max(n for n, _ in sizes.values())
    assert biggest >= 1024
    for rank in job8:
        warm, frozen = rank["steps"][FREEZE - 1], rank["steps"][FREEZE]
        floats = [e for _, dt, e in frozen["log"] if dt == "float32"]
        assert max(floats) <= 4 * DP, frozen["log"]
        u8 = [(op, e) for op, dt, e in frozen["log"] if dt == "uint8"]
        assert any(op == "all_to_all" for op, _ in u8), u8
        want = sum(P // 8 + P // (8 * DP) for _, P in sizes.values())
        assert frozen["stats"]["bytes_uint8"] == want
        assert frozen["stats"]["bytes_float32"] == 2 * 4 * len(sizes)
        assert sum(e for _, e in u8) == sum(P // 8 + P // 8
                                            for _, P in sizes.values())
        assert max(e for _, dt, e in warm["log"]
                   if dt == "float32") >= biggest
        assert not any(dt == "uint8" for _, dt, _ in warm["log"])
        assert warm["stats"] == {}


def test_warm_trajectory_does_not_depend_on_freeze_step(job8, jax_dp8):
    """Freeze step 100 against 3: the same 3 warm steps — losses within
    1e-6 and the masters bitwise equal, as the JAX engine's are."""
    assert jax_dp8["far"] == pytest.approx(
        [s["loss"] for s in jax_dp8["steps"][:FREEZE]], abs=1e-6)
    for rank in job8:
        far = rank["far"]
        assert far["losses"] == pytest.approx(
            [s["loss"] for s in rank["steps"][:FREEZE]], abs=1e-6)
        near = rank["steps"][FREEZE - 1]["state"]
        for k in near["master"]:
            np.testing.assert_array_equal(far["state"]["master"][k],
                                          near["master"][k])


def test_restores_keep_each_ranks_error_rows(job8, jax_dp8):
    """A full restore gives back this rank's error rows, μ, ν and master
    bitwise, and the next step the same loss; a module-only restore
    rebuilds zeroed rows sized for dp 8 (``[P]`` worker, ``[P/8]`` server
    a rank, ``tests/test_onebit_engine.py:116``) and steps the frozen
    program on them."""
    sizes = job8[0]["sizes"]
    for rank in job8:
        full = rank["full"]
        assert full["rows_equal"]
        assert full["count"] == STEPS and full["global_steps"] == STEPS
        assert full["step7"] == rank["step7"]
        mo = rank["module_only"]
        assert mo["zeros"] and mo["count"] == 0
        for k, (_, P) in sizes.items():
            assert mo["shapes"][k] == (P,)
            assert mo["se_shapes"][k] == (P // DP,)
        assert np.isfinite(mo["step7"])
    assert job8[0]["step7"] == pytest.approx(jax_dp8["step7"], rel=RTOL)


def test_checkpoints_cross_both_ways(job8, jax_dp8, tree, work):
    """The JAX dp-8 checkpoint after step 4 loaded on 8 ranks: step 5
    equal to the JAX engine's step 5 (loss, master and every rank's
    rows, at 1e-5); and the port's (each rank writing its own rows of the
    ``[dp, P]`` leaves) loaded into the JAX engine: its step 5 equal to
    the port's."""
    sizes = job8[0]["sizes"]
    for rank in job8:
        one = {"data_index": rank["data_index"], "steps": [rank["from_jax"]]}
        _check_rank_steps(one, jax_dp8["steps"][4:5], sizes, DP, first=5)
    eng = jax_engine(conf(), tree)
    eng.load_checkpoint(str(work / "port4"), tag="t4")
    st = jax_state(eng)
    for k in sizes:
        for rank in job8:
            d = rank["data_index"]
            np.testing.assert_array_equal(
                st["we"][k][d], rank["steps"][3]["state"]["we"][k])
            np.testing.assert_array_equal(
                st["se"][k][d], rank["steps"][3]["state"]["se"][k])
    loss = float(np.asarray(eng.train_batch(batches()[4])))
    assert loss == pytest.approx(job8[0]["steps"][4]["loss"], rel=RTOL)


def _jax_one_device_loss(tree, toks):
    """The dryrun's oracle (``__graft_entry__.py:33``): the first-step
    loss of a one-device Adam engine over the whole batch."""
    import jax
    from deepspeed_tpu.config import DeepSpeedConfig
    from deepspeed_tpu.models.gpt2 import GPT2Config, GPT2Model
    from deepspeed_tpu.parallel import build_mesh
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine
    cfg = DeepSpeedConfig({
        "train_micro_batch_size_per_gpu": 1,
        "gradient_accumulation_steps": len(toks),
        "steps_per_print": 10 ** 9, "bf16": {"enabled": True},
        "zero_optimization": {"stage": 0},
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}},
        world_size=1)
    eng = DeepSpeedEngine(GPT2Model(GPT2Config(**LEG7)), cfg,
                          mesh=build_mesh(dp=1, devices=jax.devices()[:1]),
                          params=tree)
    return float(np.asarray(eng.train_batch(toks)))


def test_dryrun_leg7_on_four_ranks(job4, leg7):
    """Dryrun leg 7: the dryrun's GPT-2, bf16, freeze step 1, dp 4: every
    rank's warm loss within 1 % of the JAX one-device loss (the dryrun's
    bar), the frozen step finite with live error feedback, and only the
    frozen step on the compressed wire."""
    ref = _jax_one_device_loss(*leg7)
    for r in job4:
        assert abs(r["warm"] - ref) <= 0.01 * max(1.0, abs(ref)), (
            r["warm"], ref)
        assert np.isfinite(r["frozen"]) and r["we_max"] > 0
        warm_stats, frozen_stats = r["stats"]
        assert warm_stats == {} and frozen_stats["bytes_uint8"] > 0
    assert len({r["warm"] for r in job4}) == 1
    assert len({r["frozen"] for r in job4}) == 1


def test_mesh_refusals(job4, job2):
    """Where the JAX engine refuses, the port refuses the same way: the
    pipeline at dp > 1 (ValueError), a seq axis in the per-worker step
    (the JAX NotImplementedError of ``models/gpt2.py:484-507``).  Where it
    runs a combination the port does not (tensor-parallel or pipeline
    pieces at dp 1, experts at dp > 1): NotImplementedError naming
    ROADMAP item 11.  1-bit Adam at dp 1 on a seq axis trains."""
    kind, msg = job4[0]["pipe_dp2"]
    assert kind == "ValueError" and "pipeline" in msg
    for impl in ("ring", "ulysses"):
        kind, msg = job4[0][f"seq_dp2_{impl}"]
        assert kind == "NotImplementedError"
        assert "not the 1-bit or sparse-gradient engines" in msg
    for res in (job4[0]["moe_dp4"], job2[0]["tp2"], job2[0]["pipe_dp1"]):
        kind, msg = res
        assert kind == "NotImplementedError", res
        assert "ROADMAP.md" in msg and "item 11" in msg
    for r in job2:
        assert len(r["seq_dp1"]) == 2 and all(np.isfinite(r["seq_dp1"]))


def _jax_fp16(tree, dp):
    eng = jax_engine(fp16_conf(), tree, dp=dp)
    out = []
    for b in _fp16_batches(4 * dp):
        out.append({"loss": float(np.asarray(eng.train_batch(b))),
                    "state": jax_state(eng),
                    "skipped": int(eng.get_skipped_steps())})
    return out


def _port_fp16_dp1(tree):
    eng = port_engine(fp16_conf(), tree,
                      dp=1)
    out = []
    for b in _fp16_batches(4):
        out.append({"loss": float(eng.train_batch(b)),
                    "state": state_of(eng),
                    "skipped": eng.get_skipped_steps()})
    eng.close()
    return out


@pytest.mark.parametrize("dp", [1, 2])
def test_fp16_skip_applied_count_and_dispatch_counter(dp, tree, job2):
    """fp16, freeze step 2, step 2 overflowing (skipped: the master, the
    count and the error buffers kept).  At dp 1 the branch follows the
    applied count, so step 3 (count 2) is still warm and moves ν; at dp 2
    the host picks by the dispatch counter, so step 3 (global step 2) is
    frozen and ν stays.  Each step's loss and state within 1e-5 of the
    JAX engine's at the same dp, within ``FP16_RTOL``."""
    ref = _jax_fp16(tree, dp)
    runs = [_port_fp16_dp1(tree)] if dp == 1 else [r["fp16"] for r in job2]
    for steps in runs:
        assert [s["skipped"] for s in ref] == [0, 1, 1, 1]
        assert [s["skipped"] for s in steps] == [0, 1, 1, 1]
        assert [s["state"]["count"] for s in steps] == [1, 1, 2, 3]
        for k in steps[0]["state"]["nu"]:
            moved = not np.array_equal(steps[2]["state"]["nu"][k],
                                       steps[1]["state"]["nu"][k])
            assert moved == (dp == 1), k
            np.testing.assert_array_equal(steps[1]["state"]["master"][k],
                                          steps[0]["state"]["master"][k])
        for i in (0, 2, 3):
            assert steps[i]["loss"] == pytest.approx(ref[i]["loss"],
                                                     rel=FP16_RTOL)
            for f in ("master", "mu", "nu"):
                for k, want in ref[i]["state"][f].items():
                    got = steps[i]["state"][f][k]
                    assert np.abs(got - want).max() <= FP16_RTOL * max(
                        np.abs(want).max(), 1e-30), (dp, i, f, k)


def test_config_refusals_and_dp1_through_initialize():
    """The JAX engine's refusals with its wording: 1-bit Adam at ZeRO ≥ 1
    and under cpu_offload (ValueError); and at dp 1 ``initialize`` takes
    it (the simulated exchange in the plain step): the loss falls and the
    optimizer state is ``OnebitAdamState``."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu.config import DeepSpeedConfig as JaxConfig
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JaxEngine
    from deepspeed_tpu_torch.compress import OnebitAdamState
    from deepspeed_tpu_torch.config import DeepSpeedConfig
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from simple_model import SimpleModel as JaxSimple
    import jax
    from deepspeed_tpu.parallel import build_mesh as jax_mesh
    tiny = GPT2Config(vocab_size=128, n_positions=16, d_model=32,
                      n_layer=2, n_head=4)
    for stage in (1, 2):
        cfg = conf(precision="bf16", stage=stage)
        with pytest.raises(ValueError, match="not a ZeRO-supported") as e:
            dst.initialize(model=GPT2Model(tiny), config=cfg, device="cpu")
        with pytest.raises(ValueError) as je:
            JaxEngine(JaxSimple(), JaxConfig(cfg, world_size=1),
                      mesh=jax_mesh(dp=1, devices=jax.devices()[:1]))
        assert str(e.value) == str(je.value)
    msgs = []
    for cls in (DeepSpeedConfig, JaxConfig):
        cfg = cls(conf(precision="bf16"), world_size=1)
        cfg.zero_config.cpu_offload = True
        msgs.append(cfg)
    with pytest.raises(ValueError, match="cpu_offload requires") as e:
        dst.initialize(model=GPT2Model(tiny), config=msgs[0], device="cpu")
    with pytest.raises(ValueError) as je:
        JaxEngine(JaxSimple(), msgs[1],
                  mesh=jax_mesh(dp=1, devices=jax.devices()[:1]))
    assert str(e.value) == str(je.value)
    eng, opt, *_ = dst.initialize(model=GPT2Model(tiny), device="cpu",
                                  config=conf(precision="bf16", micro=2,
                                              freeze=4, lr=1e-3))
    toks = np.random.default_rng(0).integers(0, 128, (2, 17))
    losses = [float(eng.train_batch(toks)) for _ in range(8)]
    assert isinstance(eng.state.opt_state, OnebitAdamState)
    assert losses[-1] < losses[0] and eng.get_skipped_steps() == 0
    assert eng._onebit_steps is None and opt is eng.optimizer
    eng.close()
