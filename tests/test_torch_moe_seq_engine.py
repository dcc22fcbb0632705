"""Port parity for expert × sequence parallelism in training: GPT-2 MoE
with ring and Ulysses attention through ``initialize()`` →
``train_batch`` on meshes with a ``seq`` axis, with the experts over
``data`` (dp 2 × sp 2, dp 4 × sp 2) and replicated (sp 2, sp 4), at ZeRO
0–3.  Three rank jobs (``test_torch_zero.spawn_ranks``), launched
together by a module fixture while the references run in the pytest
process:

  - 8 ranks, dp 4 × sp 2 (the mesh of ``tests/test_moe.py:221``, 4
    experts over ``data``): ring at ZeRO 2, Ulysses with top-2 routing at
    ZeRO 2, and the seq collectives' counters;
  - 4 ranks, dp 2 × sp 2: ring at ZeRO 0, ring with ``scan_groups`` and
    a checkpointed group at ZeRO 3 (4 layers), the same with the XLA
    tier's parameter streaming, Ulysses at ZeRO 1, ring at ZeRO 2 saving
    a checkpoint after two steps and then loading the JAX engine's,
    router jitter and dropout 0.1; then sp 4 (replicated experts) with
    Ulysses at ZeRO 1, and sp 2 × tp 2 with Ulysses at ZeRO 2 (and its
    refusal where the rank's heads do not divide by sp);
  - 2 ranks, sp 2 (replicated experts): ring at ZeRO 3.

The oracle is the JAX package's engine on one device (its seq axis
absent: ring attention's dense fallback) on the same weights (its
``GPT2MoEModel.init`` tree) and batches — 4 rows a micro-batch, 2
micro-batches a step, whatever the mesh: every rank's 3 fp32 losses and
the master gathered from every rank's pieces within 1e-5 relative.  The
aux weight is 1.0 and the z-loss is on, so an aux term or an expert
gradient counted ``sp`` times, or the capacity and queue positions of
one shard instead of the whole sequence, fails the bar.  fp32 ZeRO
configs are built at stage 0 with the stage set after, and Adam's eps is
1e-3 (``tests/test_torch_zero.py`` says why).  Jitter and dropout at dp 2
× sp 2 equal the port's one-process engine over the same global batch
within 1e-5 (the port's draws are its own).  The checkpoint crosses dp 2
× sp 2 → sp 1 → the JAX package, and the JAX engine's → dp 2 × sp 2: the
continued step's loss within 1e-5.
"""
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from test_torch_moe_engine import built
from test_torch_zero import assemble, close, gathered_pieces, jax_leaves
from test_torch_zero import spawn_ranks
from test_torch_zero import one_thread  # noqa: F401

MODEL = dict(vocab_size=256, n_positions=64, d_model=64, n_layer=2,
             n_head=4, remat=None, aux_loss_weight=1.0,
             router_z_loss_weight=1e-3, n_experts=4)
#: the 4-layer grouped form
SCAN = dict(n_layer=4, scan_groups=True, remat="block")
T, ROWS, GA, STEPS = 32, 4, 2, 3     # ROWS: a global micro-batch's rows
RATE = 0.1
NOISE = dict(router_jitter=RATE, dropout=RATE, embd_dropout=RATE)


def conf(stage, micro, **zero):
    return {"train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": GA,
            "steps_per_print": 10 ** 6,
            "gradient_clipping": 1.0,
            "zero_optimization": {"stage": stage, **zero},
            # eps 1e-3: see tests/test_torch_zero.py's config
            "optimizer": {"type": "Adam",
                          "params": {"lr": 1e-2, "eps": 1e-3,
                                     "weight_decay": 0.01}}}


def batches(steps=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, MODEL["vocab_size"], (ROWS * GA, T + 1)).astype(
        np.int32) for _ in range(steps)]


def port_engine(stage, tree, mesh, impl, zero=None, **model_kw):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.config import DeepSpeedConfig
    from deepspeed_tpu_torch.models import GPT2MoEConfig, GPT2MoEModel
    dp = mesh.axis_size("data")
    model = GPT2MoEModel(GPT2MoEConfig(**{**MODEL, "attn_impl": impl,
                                          **model_kw}))
    eng, *_ = dst.initialize(
        model=model, config=built(DeepSpeedConfig, conf(
            stage, ROWS // dp, **(zero or {})), dp),
        params=tree, mesh=mesh, device="cpu")
    return eng


def _train(eng, blist):
    from deepspeed_tpu_torch.runtime.dataloader import rank_rows
    dp = eng.mesh.axis_size("data")
    d = eng.mesh.axis_index("data")
    return [float(eng.train_batch(rank_rows(b, GA, dp, d))) for b in blist]


def _leg(eng, blist, key=None):
    """Losses and master pieces of a run (and, with ``key``, the
    ``<key>_stats`` counters over it)."""
    from deepspeed_tpu_torch.parallel import collectives as col
    stats = getattr(col, f"{key}_stats") if key else None
    if stats is not None:
        stats.clear()
    out = {"losses": _train(eng, blist)}
    if getattr(eng, "_xla", None) is not None:
        # the XLA tier's master lives in its pinned rows
        rt = eng._zero
        out["pieces"] = [(p.tensor.detach().clone().numpy(), p.box, p.shape)
                         for p in rt.shard_pieces(eng._xla_canonical()[0])]
    else:
        out["pieces"] = gathered_pieces(eng)
    if stats is not None:
        out["stats"] = {k: stats[k] for k in ("calls", "bytes")}
    eng.close()
    return out


# ---------------------------------------------------------------------------
# the rank jobs
# ---------------------------------------------------------------------------
def _job8(rank, world, trees, blist):
    from deepspeed_tpu_torch.parallel import build_mesh
    mesh = build_mesh(dp=4, sp=2)
    out = {"ring_z2": _leg(port_engine(2, trees["base"], mesh, "ring"),
                           blist, "ep")}
    eng = port_engine(2, trees["base"], mesh, "ulysses", moe_top_k=2)
    rt = eng._zero
    out["wi"] = (rt.placements[rt.template["moe"]["wi"]].ep_dim,
                 tuple(eng.state.master_params["moe"]["wi"].shape))
    out["ulysses_top2_z2"] = _leg(eng, blist, "seq")
    return out


def _job4(rank, world, trees, blist, work):
    from deepspeed_tpu_torch.parallel import build_mesh
    mesh = build_mesh(dp=2, sp=2)
    out = {}
    eng = port_engine(0, trees["base"], mesh, "ring")
    d, s = mesh.axis_index("data"), mesh.axis_index("seq")
    # the eval capacity: the first global micro-batch, each data rank its
    # rows (the engine keeps the seq window)
    out["eval"] = float(eng.eval_batch(blist[0][d * 2:(d + 1) * 2]))
    out["ring_z0"] = _leg(eng, blist)
    out["scan_z3"] = _leg(port_engine(3, trees["scan"], mesh, "ring",
                                      **SCAN), blist)
    out["stream_z3"] = _leg(port_engine(
        3, trees["scan"], mesh, "ring", stream_scan=True,
        zero=dict(cpu_offload=True, offload_impl="xla",
                  param_streaming=True), **SCAN), blist)
    out["ulysses_z1"] = _leg(port_engine(1, trees["base"], mesh, "ulysses"),
                             blist)
    out["noise"] = _leg(port_engine(2, trees["base"], mesh, "ring",
                                    **NOISE), blist)
    # two steps, a checkpoint, the third
    eng = port_engine(2, trees["base"], mesh, "ring")
    ls = _train(eng, blist[:2])
    eng.save_checkpoint(os.path.join(work, "dp2sp2"), tag="dp2sp2")
    out["ckpt_z2"] = ls + _train(eng, blist[2:])
    eng.close()
    # the JAX engine's checkpoint (written by the pytest process after its
    # second step) continues at dp 2 × sp 2
    done = os.path.join(work, "jax", "latest")
    deadline = time.monotonic() + 300
    while not os.path.exists(done):
        assert time.monotonic() < deadline, "no JAX checkpoint"
        time.sleep(0.05)
    eng = port_engine(2, trees["base"], mesh, "ring")
    eng.load_checkpoint(os.path.join(work, "jax"))
    out["from_jax"] = _train(eng, blist[2:])
    eng.close()
    # sp 4: the experts replicated over seq (dp 1)
    mesh4 = build_mesh(sp=4)
    out["sp4_ulysses_z1"] = _leg(port_engine(1, trees["base"], mesh4,
                                             "ulysses"), blist)
    # sp 2 × tp 2: the experts split over ``model`` on f, Ulysses over
    # each rank's H/tp heads
    mesh22 = build_mesh(sp=2, tp=2)
    out["sp2_tp2_ulysses_z2"] = _leg(port_engine(2, trees["base"], mesh22,
                                                 "ulysses"), blist)
    eng = port_engine(2, trees["heads2"], mesh22, "ulysses", n_head=2)
    try:
        _train(eng, blist[:1])
        out["heads2"] = None
    except ValueError as e:
        out["heads2"] = str(e)
    eng.close()
    return out


def _job2(rank, world, trees, blist):
    from deepspeed_tpu_torch.parallel import build_mesh
    mesh = build_mesh(sp=2)
    return {"sp2_ring_z3": _leg(port_engine(3, trees["base"], mesh, "ring"),
                                blist)}


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------
def _jax_tree(**kw):
    import jax
    from deepspeed_tpu.models.gpt2_moe import GPT2MoEConfig, GPT2MoEModel
    model = GPT2MoEModel(GPT2MoEConfig(**{**MODEL, "attn_impl": "dense",
                                          **kw}))
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def trees():
    return {"base": _jax_tree(), "scan": _jax_tree(**SCAN),
            "heads2": _jax_tree(n_head=2)}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("moe_seq_engine")


@pytest.fixture(scope="module")
def launched(trees, work):
    blist = batches()
    pool = ThreadPoolExecutor(3)
    futs = {8: pool.submit(spawn_ranks, _job8, 8, work, trees, blist),
            4: pool.submit(spawn_ranks, _job4, 4, work, trees, blist,
                           str(work)),
            2: pool.submit(spawn_ranks, _job2, 2, work, trees, blist)}
    yield futs
    pool.shutdown(wait=True)


def _jax_engine(tree, **kw):
    import jax
    from deepspeed_tpu.config import DeepSpeedConfig
    from deepspeed_tpu.models.gpt2_moe import GPT2MoEConfig, GPT2MoEModel
    from deepspeed_tpu.parallel import build_mesh
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine
    model = GPT2MoEModel(GPT2MoEConfig(**{**MODEL, "attn_impl": "ring",
                                          **kw}))
    return DeepSpeedEngine(
        model, built(DeepSpeedConfig, conf(0, ROWS), 1),
        mesh=build_mesh(dp=1, devices=jax.devices()[:1]), params=tree)


def _jax_run(tree, blist, save=None, **kw):
    import jax
    eng = _jax_engine(tree, **kw)
    out = {}
    if save is not None:
        out["eval"] = float(np.asarray(eng.eval_batch(blist[0][:ROWS])))
    losses = []
    for i, b in enumerate(blist):
        losses.append(float(np.asarray(eng.train_batch(b))))
        if save is not None and i == 1:
            eng.save_checkpoint(save, tag="jax")
    out["losses"] = losses
    out["master"] = jax_leaves(jax.tree.map(np.asarray,
                                            eng.state.master_params), tree)
    return out


@pytest.fixture(scope="module")
def refs(trees, work, launched):
    """The JAX engine on one device — the base model (saving after its
    second step), top-2 routing, and the grouped form — then the port's
    one-process engine with jitter and dropout, and the dp 2 × sp 2
    checkpoint loaded at sp 1 and into the JAX engine."""
    from deepspeed_tpu_torch.parallel.mesh import single_device_mesh
    blist = batches()
    out = {"base": _jax_run(trees["base"], blist, save=str(work / "jax")),
           "top2": _jax_run(trees["base"], blist, moe_top_k=2),
           "scan": _jax_run(trees["scan"], blist, **SCAN)}
    local = single_device_mesh()
    eng = port_engine(2, trees["base"], local, "ring", **NOISE)
    out["noise_sp1"] = [float(eng.train_batch(b)) for b in blist]
    eng.close()
    launched[4].result()
    eng = port_engine(2, trees["base"], local, "ring")
    eng.load_checkpoint(str(work / "dp2sp2"))
    out["dp2sp2_to_sp1"] = float(eng.train_batch(blist[2]))
    eng.close()
    eng = _jax_engine(trees["base"])
    eng.load_checkpoint(str(work / "dp2sp2"))
    out["dp2sp2_to_jax"] = float(np.asarray(eng.train_batch(blist[2])))
    return out


@pytest.fixture(scope="module")
def jobs(launched, refs):
    return {n: f.result() for n, f in launched.items()}


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
#: (job, leg, JAX reference)
LEGS = [(8, "ring_z2", "base"), (8, "ulysses_top2_z2", "top2"),
        (4, "ring_z0", "base"), (4, "scan_z3", "scan"),
        (4, "stream_z3", "scan"), (4, "ulysses_z1", "base"),
        (4, "sp4_ulysses_z1", "base"), (4, "sp2_tp2_ulysses_z2", "base"),
        (2, "sp2_ring_z3", "base")]


@pytest.mark.parametrize("job,leg,ref", LEGS,
                         ids=[f"{j}ranks-{leg}" for j, leg, _ in LEGS])
def test_losses_and_master_match_jax(job, leg, ref, jobs, refs):
    """Every rank's 3 fp32 losses and the master gathered from every
    rank's pieces within 1e-5 of the JAX single-device engine's."""
    ranks = jobs[job]
    want = refs[ref]
    for r in ranks:
        assert close(r[leg]["losses"], want["losses"]), (
            leg, r[leg]["losses"], want["losses"])
    got = assemble([r[leg]["pieces"] for r in ranks])
    assert len(got) == len(want["master"])
    for i, (a, b) in enumerate(zip(got, want["master"])):
        assert not np.isnan(a).any(), (leg, i)
        assert close(a, b), (leg, i, np.abs(a - b).max())


def test_experts_split_over_data_at_dp4_sp2(jobs):
    """dp 4 × sp 2: ``moe/wi`` is split over ``data`` on E (one expert a
    data rank, whole over seq), and the expert exchange runs in each
    seq index's data group: 4 calls a MoE layer a micro-step, each of
    ``E · rows · C · d`` fp32 values — C the whole sequence's capacity."""
    C = int(np.ceil(1.25 * T / MODEL["n_experts"]))
    for r in jobs[8]:
        assert r["wi"] == (1, (1, 1, 64, 256)), r["wi"]
        s = r["ring_z2"]["stats"]
        assert s["calls"] == STEPS * GA * 4
        assert s["bytes"] == s["calls"] * MODEL["n_experts"] * 1 * C * \
            MODEL["d_model"] * 4


def test_seq_collectives_per_step(jobs):
    """Ulysses at dp 4 × sp 2: a micro-step runs two all-to-alls a block
    forward (q/k/v to heads, the output back) and two backward, and one
    gather of the routing counts a MoE layer forward — none backward."""
    L, n_moe, d = MODEL["n_layer"], 1, MODEL["d_model"]
    B, t, k = 1, T // 2, 2
    per = L * 4 + n_moe
    for r in jobs[8]:
        s = r["ulysses_top2_z2"]["stats"]
        assert s["calls"] == STEPS * GA * per, s
        a2a = 3 * B * t * d * 4 + B * t * d * 4      # q, k, v in; out back
        gather = k * B * MODEL["n_experts"] * 4      # [k, G, E] fp32
        assert s["bytes"] == STEPS * GA * (L * 2 * a2a + n_moe * gather), s


def test_eval_capacity_on_seq_shards(jobs, refs):
    """``eval_batch`` at dp 2 × sp 2 routes at the eval capacity of the
    whole sequence: the JAX engine's eval loss within 1e-5."""
    for r in jobs[4]:
        assert close([r["eval"]], [refs["base"]["eval"]]), (
            r["eval"], refs["base"]["eval"])


def test_jitter_and_dropout_dp2_sp2_equal_sp1(jobs, refs):
    """Router jitter 0.1 and dropout 0.1 (embedding, residual and the
    ring's hashed attention mask) at dp 2 × sp 2 equal the port's
    one-process engine over the same global batch within 1e-5: every draw
    covers the global rows and the whole sequence."""
    for r in jobs[4]:
        assert close(r["noise"]["losses"], refs["noise_sp1"]), (
            r["noise"]["losses"], refs["noise_sp1"])
    assert not close(refs["noise_sp1"], refs["base"]["losses"])


def test_checkpoints_cross_sp_and_packages(jobs, refs):
    """A checkpoint saved at dp 2 × sp 2 continues at sp 1 and in the JAX
    engine, and the JAX engine's continues at dp 2 × sp 2: the third
    step's loss within 1e-5 of the uninterrupted runs'."""
    want = refs["base"]["losses"][2]
    for r in jobs[4]:
        assert close(r["ckpt_z2"], refs["base"]["losses"])
        assert close(r["from_jax"], [want])
    assert close([refs["dp2sp2_to_sp1"]], [want])
    assert close([refs["dp2sp2_to_jax"]], [want])


def test_ulysses_heads_must_divide_by_tp_sp(jobs):
    """sp 2 × tp 2 with 2 heads: each rank holds one head, which Ulysses
    cannot split over sp 2 — GPT-2's refusal, with its numbers (the JAX
    package runs it: its tp splits under GSPMD after the all-to-all;
    ROADMAP.md lists it)."""
    for r in jobs[4]:
        assert r["heads2"] is not None and "tp·sp" in r["heads2"], \
            r["heads2"]
