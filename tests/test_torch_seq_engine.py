"""Port parity for sequence parallelism in training: GPT-2 with ring and
Ulysses attention through ``initialize()`` → ``train_batch`` on meshes
with a ``seq`` axis, composed with data and tensor parallelism, ZeRO 1–3,
the pipeline engine and parameter streaming.  Two rank jobs
(``test_torch_zero.spawn_ranks``), launched together by a module
fixture while the references run in the pytest process:

  - 8 ranks: dryrun leg 6 (dp2 × sp2 × tp2, ZeRO 2, ring), leg 9 (pp2 ×
    dp2 × sp2, ZeRO 2, ring, ``"1f1b"`` — which becomes
    ``"1f1b_uniform"``, the JAX engine's rule — and ``"gpipe"``), Ulysses
    under the pipeline, and the non-uniform partition's refusal;
  - 4 ranks (dp2 × sp2): ring at ZeRO 1, 2 and 3 (stage 2 saves a
    checkpoint and loads the JAX engine's), Ulysses at ZeRO 2, dropout
    0.1 on both, parameter streaming × ring on the XLA tier (ZeRO 3, as
    streaming over data needs), and the serving engine's and a dense
    model's refusals of a seq mesh.

The oracle is the JAX package's engine on one device (the dryrun legs'
``_ref_first_loss``, carried over 3 fp32 steps) on the same weights (its
``GPT2Model.init`` tree; the pipeline's from the same leaves) and
batches: every rank's losses within 1e-5 relative.  fp32 ZeRO configs
are built at stage 0 with the stage set after, and Adam's eps is 1e-3
(``tests/test_torch_zero.py`` says why).  Dropout 0.1 at sp 2 equals the
port's sp 1 engine (the hidden masks drawn over the whole sequence, the
attention's hashed over global positions) within 1e-5; streaming × ring
at sp 2 equals the streaming tier at sp 1 within 1e-5.  Checkpoints
cross sp 2 → sp 1 → the JAX package and the JAX package → sp 2: the
continued step's loss within 1e-5.
"""
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from test_torch_zero import built_config, close, spawn_ranks
from test_torch_zero import one_thread  # noqa: F401

MODEL = dict(vocab_size=256, n_positions=64, d_model=64, n_layer=2,
             n_head=4)
T, MICRO, GA, STEPS = 64, 1, 2, 3
ROWS = MICRO * GA * 2            # the global batch: dp 2
RATE = 0.1


def conf(stage=2, micro=MICRO, **zero):
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
    return [rng.integers(0, MODEL["vocab_size"], (ROWS, T + 1)).astype(
        np.int32) for _ in range(steps)]


def _built(cfg, dp):
    """The config at fp32: built at stage 0, its ZeRO block set after."""
    from deepspeed_tpu_torch.config import DeepSpeedConfig
    out = DeepSpeedConfig({**cfg, "zero_optimization": {"stage": 0}},
                          world_size=dp)
    for k, v in cfg["zero_optimization"].items():
        setattr(out.zero_config, k, v)
    return out


def port_engine(cfg, tree, mesh, impl, dropout=0.0, dp=2, **model_kw):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    model = GPT2Model(GPT2Config(**MODEL, attn_impl=impl, dropout=dropout,
                                 embd_dropout=dropout, **model_kw))
    eng, *_ = dst.initialize(model=model, config=_built(cfg, dp),
                             params=tree, mesh=mesh, device="cpu")
    return eng


def pipe_tree(tree, stages):
    """The GPT-2 tree as ``build_gpt2_pipe``'s packed tree: the tied
    embedding, one layer per block, the final norm."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config
    from deepspeed_tpu_torch.models.gpt2_pipe import build_gpt2_pipe
    L = len(tree["blocks"]["qkv_w"])
    layers = {"tied": {"embed": {"wte": tree["wte"], "wpe": tree["wpe"]}},
              f"layer_{L + 1}": {"scale": tree["ln_f_scale"],
                                 "bias": tree["ln_f_bias"]}}
    for i in range(L):
        layers[f"layer_{i + 1}"] = {k: v[i]
                                    for k, v in tree["blocks"].items()}
    return build_gpt2_pipe(GPT2Config(**MODEL), stages).pack(layers)


def pipe_engine(cfg, tree, mesh, impl, n_layer=MODEL["n_layer"]):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config
    from deepspeed_tpu_torch.models.gpt2_pipe import build_gpt2_pipe
    pm = build_gpt2_pipe(GPT2Config(**{**MODEL, "n_layer": n_layer},
                                    attn_impl=impl), 2)
    eng, *_ = dst.initialize(model=pm, config=_built(cfg, 2),
                             params=tree, mesh=mesh, device="cpu")
    return eng


def _train(eng, blist, d):
    from deepspeed_tpu_torch.runtime.dataloader import rank_rows
    return [float(eng.train_batch(rank_rows(b, GA, 2, d))) for b in blist]


def _split(b):
    return b[:, :-1], b[:, 1:]


# ---------------------------------------------------------------------------
# the rank jobs
# ---------------------------------------------------------------------------
def _job8(rank, world, tree, blist):
    import deepspeed_tpu_torch.models.gpt2 as gpt2
    from deepspeed_tpu_torch.parallel import build_mesh, collectives as col
    out = {}
    # dryrun leg 6: ring over seq × data × tensor, ZeRO 2, remat per
    # block; the ring's calls counted where the model makes them
    mesh = build_mesh(dp=2, sp=2, tp=2)
    calls = []
    real = gpt2.ring_attention

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)
    gpt2.ring_attention = counting
    try:
        eng = port_engine(conf(2), tree, mesh, "ring", remat="block")
        col.seq_stats.clear()
        out["leg6"] = _train(eng, blist, mesh.axis_index("data"))
        out["leg6_calls"] = len(calls)
        out["leg6_rotations"] = col.seq_stats["calls"]
        eng.close()
    finally:
        gpt2.ring_attention = real
    # dryrun leg 9 and Ulysses: the pipeline's stages over seq × data
    mesh = build_mesh(pp=2, dp=2, sp=2)
    ptree = pipe_tree(tree, 2)
    for impl, sched in (("ring", "1f1b"), ("ring", "gpipe"),
                        ("ulysses", "gpipe")):
        cfg = dict(conf(2), pipeline={"schedule": sched})
        eng = pipe_engine(cfg, ptree, mesh, impl)
        out[f"pipe_{impl}_{sched}"] = [
            float(eng.train_batch(_split(b))) for b in blist]
        out[f"pipe_{impl}_{sched}_schedule"] = eng.schedule
        out[f"pipe_{impl}_{sched}_sends"] = eng.channel.stats.sends
        eng.close()
    eng = pipe_engine(conf(2), None, mesh, "ring", n_layer=3)
    try:
        eng.train_batch(_split(blist[0]))
        out["nonuniform"] = None
    except NotImplementedError as e:
        out["nonuniform"] = str(e)
    eng.close()
    return out


def _job4(rank, world, tree, blist, work):
    from deepspeed_tpu_torch.inference import ServeEngine
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from deepspeed_tpu_torch.parallel import build_mesh
    mesh = build_mesh(dp=2, sp=2)
    d = mesh.axis_index("data")
    out = {}
    for stage in (1, 2, 3):
        eng = port_engine(conf(stage), tree, mesh, "ring")
        if stage == 1:
            # the first global micro-batch's rows: one a data rank
            out["eval"] = float(eng.eval_batch(blist[0][d:d + 1]))
        if stage == 2:
            # two steps, a checkpoint, the third
            ls = _train(eng, blist[:2], d)
            eng.save_checkpoint(os.path.join(work, "sp2"), tag="sp2")
            out["ring_2"] = ls + _train(eng, blist[2:], d)
        else:
            out[f"ring_{stage}"] = _train(eng, blist, d)
        eng.close()
    eng = port_engine(conf(2), tree, mesh, "ulysses")
    out["ulysses_2"] = _train(eng, blist, d)
    eng.close()
    for impl in ("ring", "ulysses"):
        eng = port_engine(conf(2), tree, mesh, impl, dropout=RATE)
        out[f"drop_{impl}"] = _train(eng, blist, d)
        eng.close()
    eng = port_engine(conf(3, cpu_offload=True, offload_impl="xla",
                           param_streaming=True), tree, mesh, "ring",
                      remat="block", stream_scan=True)
    assert eng._zero.streamer is not None
    out["stream_ring"] = _train(eng, blist, d)
    eng.close()
    try:
        ServeEngine(GPT2Model(GPT2Config(**MODEL)),
                    {"serving": {"slots": 2, "max_seq_len": 32,
                                 "prefill_len": 8}}, mesh=mesh, device="cpu")
        out["serve"] = None
    except ValueError as e:
        out["serve"] = str(e)
    try:
        port_engine(conf(2), tree, mesh, "dense")
        out["dense"] = None
    except ValueError as e:
        out["dense"] = str(e)
    # the JAX engine's checkpoint (written by the pytest process after its
    # second step) continues at sp 2
    done = os.path.join(work, "jax", "latest")
    deadline = time.monotonic() + 300
    while not os.path.exists(done):
        assert time.monotonic() < deadline, "no JAX checkpoint"
        time.sleep(0.05)
    eng = port_engine(conf(2), tree, mesh, "ring")
    eng.load_checkpoint(os.path.join(work, "jax"))
    out["from_jax"] = _train(eng, blist[2:], d)
    eng.close()
    return out


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tree():
    import jax
    from deepspeed_tpu.models.gpt2 import GPT2Config, GPT2Model
    model = GPT2Model(GPT2Config(**MODEL, remat=None, attn_impl="dense"))
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("seq_engine")


@pytest.fixture(scope="module")
def launched(tree, work):
    blist = batches()
    pool = ThreadPoolExecutor(2)
    futs = {8: pool.submit(spawn_ranks, _job8, 8, work, tree, blist),
            4: pool.submit(spawn_ranks, _job4, 4, work, tree, blist,
                           str(work))}
    yield futs
    pool.shutdown(wait=True)


def _jax_engine(tree):
    import jax
    from deepspeed_tpu.config import DeepSpeedConfig
    from deepspeed_tpu.models.gpt2 import GPT2Config, GPT2Model
    from deepspeed_tpu.parallel import build_mesh
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine
    return DeepSpeedEngine(
        GPT2Model(GPT2Config(**MODEL, remat=None, attn_impl="ring")),
        built_config(DeepSpeedConfig, conf(0, micro=MICRO * 2), 1),
        mesh=build_mesh(dp=1, devices=jax.devices()[:1]), params=tree)


@pytest.fixture(scope="module")
def refs(tree, work, launched):
    """The JAX engine on one device (its seq axis absent: ring attention's
    dense fallback), saving after its second step; then the port's sp-1
    engines: dropout 0.1, streaming × ring, and the sp-2 checkpoint
    loaded at sp 1 and into the JAX engine."""
    blist = batches()
    out = {}
    eng = _jax_engine(tree)
    out["jax_eval"] = float(np.asarray(eng.eval_batch(blist[0][:2])))
    out["jax"] = [float(np.asarray(eng.train_batch(b))) for b in blist[:2]]
    eng.save_checkpoint(str(work / "jax"), tag="jax")
    out["jax"].append(float(np.asarray(eng.train_batch(blist[2]))))
    from deepspeed_tpu_torch.parallel.mesh import single_device_mesh
    local = single_device_mesh()
    eng = port_engine(conf(2, micro=MICRO * 2), tree, local, "ring",
                      dropout=RATE, dp=1)
    out["drop_sp1"] = [float(eng.train_batch(b)) for b in blist]
    eng.close()
    eng = port_engine(conf(3, micro=MICRO * 2, cpu_offload=True,
                           offload_impl="xla", param_streaming=True),
                      tree, local, "ring", dp=1, remat="block",
                      stream_scan=True)
    out["stream_sp1"] = [float(eng.train_batch(b)) for b in blist]
    eng.close()
    launched[4].result()
    eng = port_engine(conf(2, micro=MICRO * 2), tree, local, "ring", dp=1)
    eng.load_checkpoint(str(work / "sp2"))
    out["sp2_to_sp1"] = float(eng.train_batch(blist[2]))
    eng.close()
    eng = _jax_engine(tree)
    eng.load_checkpoint(str(work / "sp2"))
    out["sp2_to_jax"] = float(np.asarray(eng.train_batch(blist[2])))
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
def test_leg6_ring_dp_sp_tp_zero2(job8, refs):
    """Dryrun leg 6: dp2 × sp2 × tp2, ZeRO 2, ring attention — every
    rank's first loss within 1e-5 of the JAX single-device loss, and the
    next two steps too."""
    for r in job8:
        assert close(r["leg6"][:1], refs["jax"][:1]), (r["leg6"], refs)
        assert close(r["leg6"], refs["jax"]), (r["leg6"], refs["jax"])


def test_ring_engages_inside_the_engine(job8):
    """The model called ring attention once a block a micro-step, and
    once more in each block's recompute (remat per block): L · GA · 2 a
    step, as ``tests/test_sequence_parallel.py`` counts it.  Each call at
    sp 2 rotates K/V once forward, and once more in its backward."""
    L = MODEL["n_layer"]
    for r in job8:
        assert r["leg6_calls"] == STEPS * L * GA * 2
        assert r["leg6_rotations"] == STEPS * L * GA * 3


@pytest.mark.parametrize("key", ["pipe_ring_1f1b", "pipe_ring_gpipe",
                                 "pipe_ulysses_gpipe"])
def test_leg9_pipeline_over_seq(key, job8, refs):
    """Dryrun leg 9 (pp2 × dp2 × sp2, ZeRO 2, ring; ``"1f1b"`` runs as
    ``"1f1b_uniform"``) and Ulysses under the pipeline: every rank's
    losses within 1e-5 of the JAX single-device engine's, the schedules
    equal to each other; stage 0 sent M activations a step."""
    for r in job8:
        assert close(r[key], refs["jax"]), (key, r[key], refs["jax"])
        assert close(r[key], r["pipe_ring_gpipe"])
    sched = "1f1b_uniform" if key.endswith("1f1b") else "gpipe"
    assert all(r[key + "_schedule"] == sched for r in job8)
    assert job8[0][key + "_sends"] == STEPS * GA


def test_pipeline_refusals(job8):
    """A partition whose stages do not run the same stacked rows raises
    under a seq axis (the JAX engine's message); ``"1f1b"`` becomes
    ``"1f1b_uniform"`` (``test_leg9_pipeline_over_seq``)."""
    for r in job8:
        assert r["nonuniform"] is not None and "uniform" in r["nonuniform"]


@pytest.mark.parametrize("key", ["ring_1", "ring_2", "ring_3", "ulysses_2"])
def test_dp_sp_zero_stages(key, job4, refs):
    """dp2 × sp2: ring at ZeRO 1, 2 and 3 and Ulysses at ZeRO 2 — every
    rank's 3 fp32 losses within 1e-5 of the JAX single-device engine's;
    ``eval_batch`` on a micro-batch too (each rank its row and token
    window)."""
    for r in job4:
        assert close(r[key], refs["jax"]), (key, r[key], refs["jax"])
        assert close([r["eval"]], [refs["jax_eval"]])


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_dropout_sp2_equals_sp1(impl, job4, refs):
    """Dropout 0.1 (embedding, residual and attention): sp 2 × dp 2 equals
    the port's one-process sp 1 engine over the same global batch within
    1e-5 — the masks do not depend on the seq layout."""
    for r in job4:
        assert close(r[f"drop_{impl}"], refs["drop_sp1"]), (
            r[f"drop_{impl}"], refs["drop_sp1"])
    assert refs["drop_sp1"] != refs["jax"]


def test_streaming_composes_with_ring(job4, refs):
    """Parameter streaming on the XLA tier (ZeRO 3) × ring attention at
    dp 2 × sp 2: the streaming tier's losses at sp 1 within 1e-5, and
    those the JAX single-device engine's."""
    for r in job4:
        assert close(r["stream_ring"], refs["stream_sp1"]), (
            r["stream_ring"], refs["stream_sp1"])
    assert close(refs["stream_sp1"], refs["jax"]), (refs["stream_sp1"],
                                                    refs["jax"])


def test_checkpoints_cross_sp_and_packages(job4, refs):
    """A checkpoint saved at sp 2 continues at sp 1 and in the JAX engine,
    and the JAX engine's continues at sp 2: the third step's loss within
    1e-5 of the uninterrupted runs'."""
    want = refs["jax"][2]
    for r in job4:
        assert close([r["ring_2"][2]], [want])
        assert close(r["from_jax"], [want])
    assert close([refs["sp2_to_sp1"]], [want])
    assert close([refs["sp2_to_jax"]], [want])


def test_seq_mesh_refusals(job4):
    """The serving engine shards over (data, model) only: a seq mesh
    raises with the JAX package's message.  A model that attends only
    within a rank's shard (GPT-2 with dense attention) refuses a seq
    axis at construction."""
    for r in job4:
        assert r["serve"] is not None and "'seq'" in r["serve"]
        assert r["dense"] is not None and "seq axis" in r["dense"]
