"""Port parity for expert parallelism in training: GPT-2 MoE through
``initialize()`` → ``train_batch`` with its experts placed over ``data``,
composed with tensor parallelism, ZeRO 0–3, checkpoints and the XLA
offload tier.  Two rank jobs (``test_torch_zero.spawn_ranks``), launched
together by a module fixture while the references run in the pytest
process:

  - 8 ranks: dryrun leg 8 (dp4 × tp2, ZeRO 2, 4 experts: ``wi`` split
    over ``data`` on E and over ``model`` on f), ep 8 at ZeRO 2 and at
    ZeRO 3 with a checkpointed block (``tests/test_moe.py:127``), and 4
    experts on dp 8, replicated (``:159``);
  - 4 ranks (ep 4): ZeRO 0 and 1 with router jitter and dropout, ZeRO 2
    saving a checkpoint that dp2 × tp2 loads (``:275``) and the JAX
    engine's checkpoint loaded back (``:297``), the XLA tier (``:233``)
    and the host tier, and the exchange's counters against the shapes
    (a seq mesh under MoE: ``tests/test_torch_moe_seq_engine.py``).

The oracle is the JAX package's engine on one device on the same weights
(its ``GPT2MoEModel.init`` tree) and batches: every rank's 3 fp32 losses
within 1e-5 relative.  The aux weight is 1.0 and the z-loss is on in
every leg, so a wrong factor of dp in the aux term or in the expert
gradients fails the bar.  fp32 ZeRO configs are built at stage 0 with
the stage set after, and Adam's eps is 1e-3 (``tests/test_torch_zero.py``
says why).  Jitter 0.1 and dropout 0.1 at dp 4 equal the port's one-rank
engine over the same global batch within 1e-5 (the port's draws are its
own, so the JAX engine is not their oracle).  In-process: parameter
streaming of the three grouped stacks equals the plain group-scan XLA
tier within 1e-5 (``tests/test_param_streaming.py:183``).
"""
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from test_torch_zero import close, spawn_ranks
from test_torch_zero import one_thread  # noqa: F401

MODEL = dict(vocab_size=256, n_positions=64, d_model=64, n_layer=2,
             n_head=4, attn_impl="dense", remat=None, aux_loss_weight=1.0,
             router_z_loss_weight=1e-3)
T, GA, STEPS = 32, 2, 3
RATE = 0.1
#: jitter and dropout; the flash attention (its plain version here) hashes
#: its dropout from global (batch, head) ids, so the masks do not depend
#: on the layout
NOISE = dict(router_jitter=RATE, dropout=RATE, embd_dropout=RATE,
             attn_impl="flash")


def conf(stage=2, micro=1, **zero):
    return {"train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": GA,
            "steps_per_print": 10 ** 6,
            "gradient_clipping": 1.0,
            "zero_optimization": {"stage": stage, **zero},
            # eps 1e-3: see tests/test_torch_zero.py's config
            "optimizer": {"type": "Adam",
                          "params": {"lr": 1e-2, "eps": 1e-3,
                                     "weight_decay": 0.01}}}


def batches(rows, steps=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, MODEL["vocab_size"], (rows, T + 1)).astype(
        np.int32) for _ in range(steps)]


def built(config_cls, cfg, world):
    """The config at fp32: built at stage 0, its ZeRO block set after
    (the offload keys included)."""
    out = config_cls({**cfg, "zero_optimization": {"stage": 0}},
                     world_size=world)
    for k, v in cfg["zero_optimization"].items():
        setattr(out.zero_config, k, v)
    return out


def port_engine(cfg, tree, mesh, dp, experts=4, **model_kw):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.config import DeepSpeedConfig
    from deepspeed_tpu_torch.models import GPT2MoEConfig, GPT2MoEModel
    model = GPT2MoEModel(GPT2MoEConfig(**{**MODEL, "n_experts": experts,
                                          **model_kw}))
    eng, *_ = dst.initialize(model=model,
                             config=built(DeepSpeedConfig, cfg, dp),
                             params=tree, mesh=mesh, device="cpu")
    return eng


def _train(eng, blist, dp, d):
    from deepspeed_tpu_torch.runtime.dataloader import rank_rows
    return [float(eng.train_batch(rank_rows(b, GA, dp, d))) for b in blist]


def _placement(eng, name):
    """(expert dim, tensor-parallel dim, ZeRO dim) of ``moe/<name>``."""
    rt = eng._zero
    pl = rt.placements[rt.template["moe"][name]]
    return pl.ep_dim, pl.tp_dim, pl.zero_dim


def _exchange(eng, blist, dp, d):
    """Losses, and the expert exchange's counters over the steps."""
    from deepspeed_tpu_torch.parallel import collectives as col
    col.ep_stats.clear()
    losses = _train(eng, blist, dp, d)
    return losses, {k: col.ep_stats[k] for k in ("calls", "bytes",
                                                  "staged")}


# ---------------------------------------------------------------------------
# the rank jobs
# ---------------------------------------------------------------------------
def _job8(rank, world, trees, b8, b16):
    from deepspeed_tpu_torch.parallel import build_mesh
    out = {}
    # dryrun leg 8: dp4 × tp2, ZeRO 2, 4 experts
    mesh = build_mesh(dp=4, tp=2)
    d = mesh.axis_index("data")
    eng = port_engine(conf(2), trees[4], mesh, 4)
    out["leg8_wi"] = _placement(eng, "wi")
    out["leg8_wi_piece"] = tuple(eng.state.master_params["moe"]["wi"].shape)
    out["leg8"] = _train(eng, b8, 4, d)
    eng.close()
    # ep 8: 8 experts over dp 8, ZeRO 2 and ZeRO 3 with remat per block
    mesh = build_mesh(dp=8)
    for stage, remat in ((2, None), (3, "block")):
        eng = port_engine(conf(stage), trees[8], mesh, 8, experts=8,
                          remat=remat)
        out[f"ep8_z{stage}_wi"] = _placement(eng, "wi")
        out[f"ep8_z{stage}"], out[f"ep8_z{stage}_stats"] = _exchange(
            eng, b16, 8, rank)
        eng.close()
    # 4 experts on dp 8: the expert dim does not divide, so it stays
    # replicated and ZeRO shards its own dim; no exchange
    eng = port_engine(conf(2), trees[4], mesh, 8)
    out["rep_wi"] = _placement(eng, "wi")
    out["rep"], out["rep_stats"] = _exchange(eng, b16, 8, rank)
    eng.close()
    return out


def _job4(rank, world, trees, b8, work):
    from deepspeed_tpu_torch.parallel import build_mesh
    mesh = build_mesh(dp=4)
    d = mesh.axis_index("data")
    out = {}
    for stage in (0, 1):
        eng = port_engine(conf(stage), trees[4], mesh, 4)
        if stage == 0:
            # the eval capacity: one micro-batch, each rank its row
            out["eval"] = float(eng.eval_batch(b8[0][d:d + 1]))
        out[f"ep4_z{stage}"], out[f"ep4_z{stage}_stats"] = _exchange(
            eng, b8, 4, d)
        out[f"ep4_z{stage}_piece"] = tuple(
            eng.state.master_params["moe"]["wi"].shape)
        eng.close()
        eng = port_engine(conf(stage), trees[4], mesh, 4, **NOISE)
        out[f"noise_z{stage}"] = _train(eng, b8, 4, d)
        eng.close()
    # two steps at ep 4, a checkpoint, the third
    eng = port_engine(conf(2), trees[4], mesh, 4)
    ls = _train(eng, b8[:2], 4, d)
    eng.save_checkpoint(os.path.join(work, "ep4"), tag="ep4")
    out["ep4_z2"] = ls + _train(eng, b8[2:], 4, d)
    eng.close()
    # the ep-4 checkpoint continues at dp2 × tp2 (ZeRO 1)
    mesh22 = build_mesh(dp=2, tp=2)
    d22 = mesh22.axis_index("data")
    eng = port_engine(conf(1, micro=2), trees[4], mesh22, 2)
    eng.load_checkpoint(os.path.join(work, "ep4"))
    out["ep4_to_dp2tp2"] = _train(eng, b8[2:], 2, d22)
    eng.close()
    # the offload tiers at ep 4
    eng = port_engine(conf(2, cpu_offload=True, offload_impl="xla"),
                      trees[4], mesh, 4)
    out["xla"] = _train(eng, b8, 4, d)
    eng.close()
    eng = port_engine(conf(2, cpu_offload=True), trees[4], mesh, 4)
    out["host"] = _train(eng, b8, 4, d)
    eng.close()
    # the JAX engine's checkpoint (written by the pytest process after its
    # second step) continues at ep 4
    done = os.path.join(work, "jax", "latest")
    deadline = time.monotonic() + 300
    while not os.path.exists(done):
        assert time.monotonic() < deadline, "no JAX checkpoint"
        time.sleep(0.05)
    eng = port_engine(conf(2), trees[4], mesh, 4)
    eng.load_checkpoint(os.path.join(work, "jax"))
    out["from_jax"] = _train(eng, b8[2:], 4, d)
    eng.close()
    return out


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------
def _jax_tree(experts):
    import jax
    from deepspeed_tpu.models.gpt2_moe import GPT2MoEConfig, GPT2MoEModel
    model = GPT2MoEModel(GPT2MoEConfig(**{**MODEL, "n_experts": experts}))
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def trees():
    return {4: _jax_tree(4), 8: _jax_tree(8)}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("moe_engine")


@pytest.fixture(scope="module")
def launched(trees, work):
    b8, b16 = batches(8), batches(16, seed=1)
    pool = ThreadPoolExecutor(2)
    futs = {8: pool.submit(spawn_ranks, _job8, 8, work, trees, b8, b16),
            4: pool.submit(spawn_ranks, _job4, 4, work, trees, b8,
                           str(work))}
    yield futs
    pool.shutdown(wait=True)


def _jax_engine(tree, experts, micro):
    import jax
    from deepspeed_tpu.config import DeepSpeedConfig
    from deepspeed_tpu.models.gpt2_moe import GPT2MoEConfig, GPT2MoEModel
    from deepspeed_tpu.parallel import build_mesh
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine
    model = GPT2MoEModel(GPT2MoEConfig(**{**MODEL, "n_experts": experts}))
    return DeepSpeedEngine(
        model, built(DeepSpeedConfig, conf(0, micro=micro), 1),
        mesh=build_mesh(dp=1, devices=jax.devices()[:1]), params=tree)


def _port_local(cfg, tree, **model_kw):
    from deepspeed_tpu_torch.parallel.mesh import single_device_mesh
    return port_engine(cfg, tree, single_device_mesh(), 1, **model_kw)


@pytest.fixture(scope="module")
def refs(trees, work, launched):
    """The JAX engine on one device — 4 experts over 8 and 16 rows, 8
    experts over 16 — the 8-row one saving after its second step; the
    port's one-rank engines with jitter and dropout; then the port's ep-4
    checkpoint loaded into the JAX engine."""
    b8, b16 = batches(8), batches(16, seed=1)
    out = {}
    eng = _jax_engine(trees[4], 4, 4)
    out["jax_eval"] = float(np.asarray(eng.eval_batch(b8[0][:4])))
    out["jax8"] = [float(np.asarray(eng.train_batch(b))) for b in b8[:2]]
    eng.save_checkpoint(str(work / "jax"), tag="jax")
    out["jax8"].append(float(np.asarray(eng.train_batch(b8[2]))))
    eng = _jax_engine(trees[8], 8, 8)
    out["jax16_e8"] = [float(np.asarray(eng.train_batch(b))) for b in b16]
    eng = _jax_engine(trees[4], 4, 8)
    out["jax16_e4"] = [float(np.asarray(eng.train_batch(b))) for b in b16]
    for stage in (0, 1):
        eng = _port_local(conf(stage, micro=4), trees[4], **NOISE)
        out[f"noise_dp1_z{stage}"] = [float(eng.train_batch(b)) for b in b8]
        eng.close()
    launched[4].result()
    eng = _jax_engine(trees[4], 4, 4)
    eng.load_checkpoint(str(work / "ep4"))
    out["ep4_to_jax"] = float(np.asarray(eng.train_batch(b8[2])))
    return out


@pytest.fixture(scope="module")
def job8(launched):
    return launched[8].result()


@pytest.fixture(scope="module")
def job4(launched, refs):
    return launched[4].result()


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
def test_leg8_ep_tp_zero2(job8, refs):
    """Dryrun leg 8: dp4 × tp2, ZeRO 2, 4 experts — ``wi [L, E, d, f]``
    split over ``data`` on E and over ``model`` on f (ZeRO adds no dim),
    each rank holding ``[1, 1, 64, 128]``; every rank's 3 losses within
    1e-5 of the JAX single-device engine's."""
    for r in job8:
        assert r["leg8_wi"] == (1, 3, None), r["leg8_wi"]
        assert r["leg8_wi_piece"] == (1, 1, 64, 128)
        assert close(r["leg8"], refs["jax8"]), (r["leg8"], refs["jax8"])


@pytest.mark.parametrize("stage", [2, 3])
def test_ep8_zero_stages(stage, job8, refs):
    """ep 8 (8 experts over dp 8) at ZeRO 2, and at ZeRO 3 with each
    block checkpointed: the losses within 1e-5 of the JAX engine's."""
    for r in job8:
        assert r[f"ep8_z{stage}_wi"] == (1, 3, None)
        assert close(r[f"ep8_z{stage}"], refs["jax16_e8"]), (
            r[f"ep8_z{stage}"], refs["jax16_e8"])


def test_indivisible_experts_replicate(job8, refs):
    """4 experts on dp 8: the expert dim stays whole, ZeRO shards another
    dim, no token is exchanged, and the losses equal the JAX engine's
    within 1e-5."""
    for r in job8:
        ep, tp, zero = r["rep_wi"]
        assert ep is None and zero is not None and zero != 1, r["rep_wi"]
        assert r["rep_stats"]["calls"] == 0
        assert close(r["rep"], refs["jax16_e4"]), (r["rep"],
                                                   refs["jax16_e4"])


@pytest.mark.parametrize("stage", [0, 1])
def test_ep4_zero_stages(stage, job4, refs):
    """ep 4 at ZeRO 0 and 1 (the experts split at every stage, stage 0
    included): the losses within 1e-5 of the JAX engine's; ``eval_batch``
    at the eval capacity too."""
    for r in job4:
        assert r[f"ep4_z{stage}_piece"] == (1, 1, 64, 256)
        assert close(r[f"ep4_z{stage}"], refs["jax8"]), (
            r[f"ep4_z{stage}"], refs["jax8"])
        assert close([r["eval"]], [refs["jax_eval"]])


@pytest.mark.parametrize("stage", [0, 1])
def test_jitter_and_dropout_dp4_equal_dp1(stage, job4, refs):
    """Router jitter 0.1 and dropout 0.1 at ep 4 equal the port's
    one-rank engine over the same global batch within 1e-5: the jitter
    and the masks are drawn over the global rows."""
    for r in job4:
        assert close(r[f"noise_z{stage}"], refs[f"noise_dp1_z{stage}"]), (
            r[f"noise_z{stage}"], refs[f"noise_dp1_z{stage}"])
    assert not close(refs[f"noise_dp1_z{stage}"], refs["jax8"])


def test_exchange_counters_match_shapes(job4, job8):
    """Each MoE layer exchanges its dispatched tokens ``[E, G_local, C,
    d]`` twice forward and twice backward a micro-step, and once more
    each way when its block is recomputed: 4 (or 6) calls of ``E ·
    G_local · C · d`` fp32 values a micro-step, with no host staging of
    CPU tensors."""
    n_moe, E, d = 1, 4, MODEL["d_model"]
    C = int(np.ceil(1.25 * T / E))
    per = E * 1 * C * d * 4
    for r in job4:
        s = r["ep4_z0_stats"]
        assert s["calls"] == STEPS * GA * n_moe * 4
        assert s["bytes"] == s["calls"] * per
        assert s["staged"] == 0
    C8 = int(np.ceil(1.25 * T / 8))
    for r in job8:
        assert r["ep8_z2_stats"]["calls"] == STEPS * GA * n_moe * 4
        s = r["ep8_z3_stats"]
        assert s["calls"] == STEPS * GA * n_moe * 6
        assert s["bytes"] == s["calls"] * 8 * C8 * d * 4


def test_checkpoints_cross_meshes_and_packages(job4, refs):
    """A checkpoint saved at ep 4 continues at dp2 × tp2 (ZeRO 1) and in
    the JAX engine, and the JAX engine's continues at ep 4: the third
    step's loss within 1e-5 of the uninterrupted runs'."""
    want = refs["jax8"][2]
    for r in job4:
        assert close(r["ep4_z2"], refs["jax8"])
        assert close(r["ep4_to_dp2tp2"], [want])
        assert close(r["from_jax"], [want])
    assert close([refs["ep4_to_jax"]], [want])


@pytest.mark.parametrize("tier", ["xla", "host"])
def test_offload_tiers_at_ep4(tier, job4, refs):
    """The XLA tier (``tests/test_moe.py:233``) and the host tier at ep 4,
    ZeRO 2: each rank's experts are its own rows of the pinned pieces
    (or of the host master); the losses within 1e-5 of the JAX
    engine's."""
    for r in job4:
        assert close(r[tier], refs["jax8"]), (tier, r[tier], refs["jax8"])


# ---------------------------------------------------------------------------
# in-process: parameter streaming of the grouped stacks
# ---------------------------------------------------------------------------
STREAM_MODEL = dict(n_layer=4, scan_groups=True, remat="block")


def test_streaming_matches_plain_group_scan_offload(trees):
    """``param_streaming`` on the XLA tier with ``stream_scan`` (the
    attn, dense_ffn and moe stacks in pinned host memory, fetched a row
    at a time) equals the same tier without streaming within 1e-5
    (``tests/test_param_streaming.py:183``), and the loss on a repeated
    batch falls."""
    import jax
    from deepspeed_tpu.models.gpt2_moe import GPT2MoEConfig, GPT2MoEModel
    tree = jax.tree.map(np.asarray, GPT2MoEModel(GPT2MoEConfig(
        **{**MODEL, "n_experts": 4, **STREAM_MODEL})).init(
            jax.random.PRNGKey(1)))
    b = batches(4, steps=1, seed=2) * 4     # one batch, repeated
    losses = {}
    for stream in (False, True):
        zero = dict(cpu_offload=True, offload_impl="xla",
                    **({"param_streaming": True} if stream else {}))
        eng = _port_local(conf(2, micro=2, **zero), tree,
                          stream_scan=stream, **STREAM_MODEL)
        assert (eng._zero.streamer is not None) == stream
        if stream:
            streamed = sorted(eng._zero.streamer.leaves)
            assert len(streamed) == 8 + 4 + 5
        losses[stream] = [float(eng.train_batch(x)) for x in b]
        eng.close()
    assert close(losses[True], losses[False]), losses
    assert losses[True][-1] < losses[True][0]


def test_streaming_needs_the_grouped_stream_form(trees):
    """``stream_scan`` without ``scan_groups`` is refused at config time
    (``tests/test_param_streaming.py:215``), and streaming a MoE model
    without ``stream_scan`` raises the message naming both models'
    flags."""
    from deepspeed_tpu_torch.models import GPT2MoEConfig
    with pytest.raises(ValueError, match="scan_groups"):
        GPT2MoEConfig(**{**MODEL, "n_layer": 4, "stream_scan": True})
    with pytest.raises(ValueError, match="GPT2MoEModel scan_groups=True"):
        _port_local(conf(2, micro=2, cpu_offload=True, offload_impl="xla",
                         param_streaming=True), trees[4])


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_host_and_disk_tiers_at_dp1(tier, trees, tmp_path, monkeypatch):
    """The host and the disk offload tier train GPT-2 MoE in one process
    (ep 1): the plain ZeRO-2 engine's losses within 1e-5."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.config import DeepSpeedConfig
    from deepspeed_tpu_torch.models import GPT2MoEConfig, GPT2MoEModel
    monkeypatch.setenv("DS_DISK_FSYNC", "0")
    b = batches(4, seed=3)
    eng = _port_local(conf(2, micro=2), trees[4])
    want = [float(eng.train_batch(x)) for x in b]
    eng.close()
    cfg = built(DeepSpeedConfig, conf(2, micro=2, cpu_offload=True,
                                      offload_impl="host"), 1)
    if tier == "disk":
        cfg.offload_config.tier = "disk"
        cfg.offload_config.disk_dir = str(tmp_path / "state")
        cfg.offload_config.io_depth = 2
    eng, *_ = dst.initialize(
        model=GPT2MoEModel(GPT2MoEConfig(**{**MODEL, "n_experts": 4})),
        config=cfg, params=trees[4], device="cpu")
    assert eng._offload and eng._offload_disk == (tier == "disk")
    got = [float(eng.train_batch(x)) for x in b]
    eng.close()
    assert close(got, want), (tier, got, want)
