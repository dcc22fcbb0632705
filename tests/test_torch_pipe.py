"""Port parity for pipeline parallelism: ``deepspeed_tpu_torch``'s
``PipelineEngine`` on gloo ranks (one process per stage, spawned by
``test_torch_zero.spawn_ranks``, launched once per mesh by a
module-scoped fixture) against the JAX ``PipelineEngine`` on the virtual
CPU mesh in the pytest process, both from the same seeded numpy weights
(the JAX init tree, carried to every depth by
``pipe.module.carry_params``) and batches.

Meshes: pp 2, pp 4, pp2 × dp2 (ZeRO 1 and 3; dryrun legs 2 and 4) and
pp2 × dp2 × tp2 (ZeRO 2; leg 3).  Each holds 3 fp32 steps of losses and
the master gathered from every rank's checkpoint pieces to the JAX
engine's 1F1B within 1e-5 relative: pp 2 and pp 4 to the JAX engine at
pp 2, the dp-2 meshes to the JAX engine on pp2 × dp2 × tp2 (the JAX
engine's arithmetic does not depend on its depth or its tp: its pp 2
and pp 4 losses, and its pp2 × dp2 and pp2 × dp2 × tp2 ones, agree to
the last printed digit, so one JAX run per batch keeps this file's
time down).  The JAX engine's 1F1B deadlocks in XLA's CPU
collective-permute rendezvous with ZeRO >= 1 at dp 2 (its own
``test_pipeline_with_zero1`` is a slow-tier test), so the ZeRO legs are
held to the JAX 1F1B at stage 0: a ZeRO stage changes where state lives,
not the arithmetic (the port's stages are also held to each other).
Further: the tied-layer module and BERT with LAMB at pp 2 against JAX;
``eval_batch``; the refusals; per-rank parameter bytes at pp 2 below
pp 1; the 1F1B boundary bound (at most ``num_pipe_buffers()`` boundary
inputs live, at M 4 and M 16); dropout masks that do not depend on pp,
dp, tp or the schedule; and checkpoints (save → load → continue
bitwise, async = sync, pp 2 → pp 4 and pp 1, the JAX engine's
checkpoint loaded by the port and the port's by the JAX engine)."""
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from test_torch_zero import (assemble, built_config, close, gathered_pieces,
                             jax_leaves, spawn_ranks)

TINY = dict(vocab_size=128, n_positions=16, d_model=32, n_layer=4, n_head=4)
BERT = dict(vocab_size=96, hidden_size=32, num_hidden_layers=4,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=16, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
T, MICRO, GA, STEPS = 8, 1, 4, 3
DIM = 16
RTOL = 1e-5


def conf(stage=0, optimizer="Adam", schedule="1f1b", ga=GA, micro=MICRO,
         bf16=False, **over):
    cfg = {"train_micro_batch_size_per_gpu": micro,
           "gradient_accumulation_steps": ga,
           "steps_per_print": 10 ** 6,
           "gradient_clipping": 1.0,
           "zero_optimization": {"stage": stage},
           "pipeline": {"schedule": schedule},
           # eps 1e-3: see tests/test_torch_zero.py's config
           "optimizer": {"type": optimizer,
                         "params": {"lr": 1e-2, "eps": 1e-3,
                                    "weight_decay": 0.01}}}
    if bf16:
        cfg["bf16"] = {"enabled": True}
    cfg.update(over)
    return cfg


def gpt2_batches(rows, steps=STEPS + 1, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TINY["vocab_size"], (rows, T + 1)).astype(
        np.int32) for _ in range(steps)]


def split(toks):
    return toks[:, :-1], toks[:, 1:]


def bert_batches(rows, steps=STEPS, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        ids = rng.integers(1, BERT["vocab_size"], (rows, 12)).astype(np.int32)
        labels = np.where(rng.random((rows, 12)) < 0.3, ids, -100)
        out.append((ids, labels.astype(np.int32)))
    return out


def linear_batches(rows, steps=STEPS, seed=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        x = rng.standard_normal((rows, DIM)).astype(np.float32)
        out.append((x, (0.5 * np.abs(x)).astype(np.float32)))
    return out


# ---------------------------------------------------------------------------
# the modules, both packages
# ---------------------------------------------------------------------------
class TorchLinear:
    def __init__(self, din, dout):
        self.din, self.dout = din, dout

    def init(self, seed, device=None):
        g = torch.Generator().manual_seed(int(seed) & 0x7FFFFFFF)
        return {"w": torch.randn(self.din, self.dout, generator=g) * 0.2,
                "b": torch.zeros(self.dout)}

    def apply(self, params, x, rng, train=True, mesh=None):
        return torch.relu(x @ params["w"].to(x.dtype)
                          + params["b"].to(x.dtype))


def torch_mse(out, labels):
    return ((out.float() - labels.float()) ** 2).mean()


def port_module(kind, stages, dropout=0.0, impl="dense"):
    from deepspeed_tpu_torch.pipe import (LayerSpec, PipelineModule,
                                          TiedLayerSpec)
    if kind == "gpt2":
        from deepspeed_tpu_torch.models.gpt2 import GPT2Config
        from deepspeed_tpu_torch.models.gpt2_pipe import build_gpt2_pipe
        return build_gpt2_pipe(GPT2Config(
            **TINY, attn_impl=impl, dropout=dropout, embd_dropout=dropout),
            stages)
    if kind == "bert":
        from deepspeed_tpu_torch.models.bert import BertConfig
        from deepspeed_tpu_torch.models.bert_pipe import build_bert_pipe
        return build_bert_pipe(BertConfig(**BERT, attn_impl="dense"), stages)
    if kind == "tied":
        specs = [TiedLayerSpec("emb", TorchLinear, DIM, DIM),
                 LayerSpec(TorchLinear, DIM, DIM),
                 LayerSpec(TorchLinear, DIM, DIM),
                 TiedLayerSpec("emb", TorchLinear, DIM, DIM)]
    else:   # "mismatch": stage boundaries [., 32] and [., 16]
        specs = [LayerSpec(TorchLinear, DIM, 32),
                 LayerSpec(TorchLinear, 32, 32),
                 LayerSpec(TorchLinear, 32, 32),
                 LayerSpec(TorchLinear, 32, DIM)]
    return PipelineModule(specs, stages, loss_fn=torch_mse,
                          partition_method="uniform")


def jax_module(kind, stages):
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.pipe import LayerSpec, PipelineModule, TiedLayerSpec
    if kind == "gpt2":
        from deepspeed_tpu.models.gpt2 import GPT2Config
        from deepspeed_tpu.models.gpt2_pipe import build_gpt2_pipe
        return build_gpt2_pipe(GPT2Config(**TINY, remat=None,
                                          attn_impl="dense"), stages)
    if kind == "bert":
        from deepspeed_tpu.models.bert import BertConfig
        from deepspeed_tpu.models.bert_pipe import build_bert_pipe
        return build_bert_pipe(BertConfig(**BERT, remat=None), stages)

    class Linear:
        def __init__(self, din, dout):
            self.din, self.dout = din, dout

        def init(self, rng):
            return {"w": jax.random.normal(rng, (self.din, self.dout),
                                           jnp.float32) * 0.2,
                    "b": jnp.zeros((self.dout,), jnp.float32)}

        def apply(self, params, x, rng, train=True):
            return jax.nn.relu(x @ params["w"] + params["b"])

    specs = [TiedLayerSpec("emb", Linear, DIM, DIM),
             LayerSpec(Linear, DIM, DIM), LayerSpec(Linear, DIM, DIM),
             TiedLayerSpec("emb", Linear, DIM, DIM)]
    return PipelineModule(specs, stages,
                          loss_fn=lambda o, lb: jnp.mean((o - lb) ** 2),
                          partition_method="uniform")


def jax_tree(kind, stages=2):
    import jax
    return jax.tree.map(np.asarray,
                        jax_module(kind, stages).init(jax.random.PRNGKey(0)))


def jax_engine(kind, pp, dp, tp, cfg, tree):
    import jax
    from deepspeed_tpu.config import DeepSpeedConfig
    from deepspeed_tpu.parallel import build_mesh
    from deepspeed_tpu.pipe.engine import PipelineEngine
    from deepspeed_tpu_torch.pipe.module import carry_params
    pm = jax_module(kind, pp)
    mesh = build_mesh(pp=pp, dp=dp, tp=tp,
                      devices=jax.devices()[:pp * dp * tp])
    return PipelineEngine(pm, built_config(DeepSpeedConfig, cfg, dp), mesh,
                          params=carry_params(tree, port_module(kind, pp)))


def port_engine(kind, cfg, dp, pp, tp=1, tree=None, dropout=0.0,
                impl="dense", mesh=None, device="cpu"):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.config import DeepSpeedConfig
    from deepspeed_tpu_torch.parallel import build_mesh
    from deepspeed_tpu_torch.pipe.engine import PipelineEngine
    if mesh is None:
        mesh = build_mesh(pp=pp, dp=dp, tp=tp)
    eng, *_ = dst.initialize(
        model=port_module(kind, pp, dropout, impl),
        config=built_config(DeepSpeedConfig, cfg, dp), params=tree,
        mesh=mesh, device=device, seed=7)
    assert isinstance(eng, PipelineEngine)
    return eng


def _bytes(eng):
    from deepspeed_tpu_torch.runtime.utils import tree_leaves
    return sum(x.numel() * x.element_size()
               for x in tree_leaves(eng.state.master_params))


def _train(eng, blist, steps=STEPS):
    return [float(eng.train_batch(b)) for b in blist[:steps]]


# ---------------------------------------------------------------------------
# the rank jobs: one launch per mesh
# ---------------------------------------------------------------------------
def _pp2_job(rank, world, trees, save_dir):
    from deepspeed_tpu_torch.runtime.prefetch import DevicePlacedBatch
    out = {}
    g = [split(b) for b in gpt2_batches(GA * MICRO)]
    for sched in ("1f1b", "gpipe"):
        eng = port_engine("gpt2", conf(schedule=sched), 1, 2,
                          tree=trees["gpt2"])
        out[f"eval0_{sched}"] = float(eng.eval_batch(g[0]))
        out[sched] = _train(eng, g)
        out[f"{sched}_pieces"] = gathered_pieces(eng)
        out[f"{sched}_live"] = eng.max_live_boundaries
        if sched == "1f1b":
            out["bytes"] = _bytes(eng)
            out["sends"] = eng.channel.stats.sends
            # save → load → continue, bitwise, inside the port
            eng.save_checkpoint(save_dir, tag="pp2")
            again = port_engine("gpt2", conf(), 1, 2, tree=trees["gpt2"])
            assert again.load_checkpoint(save_dir, tag="pp2")[0]
            out["cont"] = float(eng.train_batch(g[STEPS]))
            out["cont_again"] = float(again.train_batch(g[STEPS]))
            out["cont_pieces"] = [p[0] for p in gathered_pieces(eng)]
            out["cont_again_pieces"] = [p[0] for p in gathered_pieces(again)]
            again.close()
            # the refusals of eval and the facade
            errs = []
            for call in (lambda: eng.eval_batch(),
                         lambda: eng.eval_batch(DevicePlacedBatch(
                             g[0], kind="train")),
                         lambda: eng.eval_batch((g[0][0][:3], g[0][1][:3])),
                         lambda: eng(g[0])):
                try:
                    call()
                except (ValueError, NotImplementedError) as e:
                    errs.append(type(e).__name__ + ": " + str(e))
            out["errs"] = errs
        eng.close()
    # the 1F1B boundary bound: live boundary inputs at M 4 (the 1F1B
    # engine above) and M 16
    out["live_4"] = out["1f1b_live"]
    eng = port_engine("gpt2", conf(ga=16), 1, 2, tree=trees["gpt2"])
    eng.train_batch(split(gpt2_batches(16)[0]))
    out["live_16"] = eng.max_live_boundaries
    eng.close()
    # dropout 0.1 on the hashed attention: both schedules
    for sched in ("1f1b", "gpipe"):
        eng = port_engine("gpt2", conf(schedule=sched), 1, 2,
                          tree=trees["gpt2"], dropout=0.1, impl="flash")
        out[f"drop_{sched}"] = _train(eng, g)
        eng.close()
    # the tied-layer module and BERT with LAMB
    eng = port_engine("tied", conf(), 1, 2, tree=trees["tied"])
    out["tied"] = _train(eng, linear_batches(GA * MICRO))
    out["tied_pieces"] = gathered_pieces(eng)
    out["tied_keys"] = sorted(eng.state.master_params)
    eng.close()
    eng = port_engine("bert", conf(optimizer="Lamb"), 1, 2,
                      tree=trees["bert"])
    out["bert"] = _train(eng, bert_batches(GA * MICRO))
    out["bert_pieces"] = gathered_pieces(eng)
    eng.close()
    # stage boundaries that disagree
    eng = port_engine("mismatch", conf(), 1, 2)
    try:
        eng.train_batch(linear_batches(GA * MICRO)[0])
        out["mismatch"] = None
    except ValueError as e:
        out["mismatch"] = str(e)
    eng.close()
    return out


def _pp4_job(rank, world, trees, save_dir, jax_dir):
    out = {}
    g = [split(b) for b in gpt2_batches(GA * MICRO)]
    eng = port_engine("gpt2", conf(), 1, 4, tree=trees["gpt2"])
    out["losses"] = _train(eng, g)
    out["pieces"] = gathered_pieces(eng)
    out["live"] = eng.max_live_boundaries
    # pp 2 → pp 4: the pp-2 checkpoint restacked (a load replaces the
    # whole state, so the trained engine takes it)
    eng.load_checkpoint(save_dir, tag="pp2")
    out["resized"] = float(eng.train_batch(g[STEPS]))
    # the JAX engine's pp-2 checkpoint, restacked and continued
    eng.load_checkpoint(jax_dir, tag="jax")
    out["from_jax"] = float(eng.train_batch(g[STEPS]))
    eng.close()
    eng = port_engine("gpt2", conf(), 1, 4, tree=trees["gpt2"],
                      dropout=0.1, impl="flash")
    out["drop"] = _train(eng, g)
    eng.close()
    return out


def _dp2_job(rank, world, trees, save_dir):
    out = {}
    g = [split(b) for b in gpt2_batches(2 * GA * MICRO)]
    for stage in (1, 3):
        eng = port_engine("gpt2", conf(stage=stage), 2, 2,
                          tree=trees["gpt2"])
        out[stage] = _train(eng, g)
        out[f"{stage}_pieces"] = gathered_pieces(eng)
        rt = eng._zero
        out[f"{stage}_split"] = [
            (rt.master_split(i), rt.placements[i].zero_dim,
             i in rt.pipe_local) for i in range(len(rt.placements))]
        eng.close()
    # the JAX package's pipeline checkpoint cases: bf16 ZeRO-1
    # roundtrip (tests/test_checkpointing.py:169) and async == sync
    # (tests/test_resilience.py:145; across processes an async save
    # writes synchronously, as in the JAX engine)
    ckpt = {"async_save": True, "sigterm_save": True}
    eng = port_engine("gpt2", conf(stage=1, ga=2, bf16=True, checkpoint=ckpt),
                      2, 2, tree=trees["gpt2"])
    eng.train_batch(split(gpt2_batches(4)[0]))
    eng.save_checkpoint(os.path.join(save_dir, "sync"), tag="t",
                        async_write=False)
    eng.save_checkpoint(os.path.join(save_dir, "async"), tag="t",
                        async_write=True)
    # across processes: written when the call returns, no SIGTERM hook
    out["single_controller"] = (not eng._ckpt_writer.in_flight(),
                                eng._preemption_handler is None)
    again = port_engine("gpt2", conf(stage=1, ga=2, bf16=True), 2, 2,
                        tree=trees["gpt2"])
    again.load_checkpoint(os.path.join(save_dir, "sync"), tag="t")
    toks = split(gpt2_batches(4)[1])
    out["roundtrip"] = (float(eng.train_batch(toks)),
                        float(again.train_batch(toks)))
    eng.close()
    again.close()
    eng = port_engine("gpt2", conf(), 2, 2, tree=trees["gpt2"],
                      dropout=0.1, impl="flash")
    out["drop"] = _train(eng, g)
    eng.close()
    return out


def _3d_job(rank, world, trees):
    out = {}
    g = [split(b) for b in gpt2_batches(2 * GA * MICRO)]
    eng = port_engine("gpt2", conf(stage=2), 2, 2, tp=2, tree=trees["gpt2"])
    out["losses"] = _train(eng, g)
    out["pieces"] = gathered_pieces(eng)
    out["tp_dims"] = [p.tp_dim for p in eng._zero.placements]
    eng.close()
    eng = port_engine("gpt2", conf(), 2, 2, tp=2, tree=trees["gpt2"],
                      dropout=0.1, impl="flash")
    out["drop"] = _train(eng, g)
    eng.close()
    return out


# ---------------------------------------------------------------------------
# fixtures: the JAX references, then one launch per mesh
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def trees():
    return {k: jax_tree(k) for k in ("gpt2", "bert", "tied")}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("pipe")


@pytest.fixture(scope="module")
def launched(trees, work):
    """The rank jobs, in two chains beside the JAX references in this
    process: the 8-rank mesh then the dp-2 one, and pp 2 (pp 4 follows
    it once the JAX pp-2 checkpoint exists, ``jax_refs``)."""
    wide, deep = ThreadPoolExecutor(1), ThreadPoolExecutor(1)
    futs = {"3d": wide.submit(spawn_ranks, _3d_job, 8, work, trees),
            "dp2": wide.submit(spawn_ranks, _dp2_job, 4, work, trees,
                               str(work / "dp2")),
            "pp2": deep.submit(spawn_ranks, _pp2_job, 2, work, trees,
                               str(work / "port")),
            "deep": deep}
    yield futs
    wide.shutdown(wait=True)
    deep.shutdown(wait=True)


@pytest.fixture(scope="module")
def jax_refs(trees, work, launched):
    g1 = [split(b) for b in gpt2_batches(GA * MICRO)]
    g2 = [split(b) for b in gpt2_batches(2 * GA * MICRO)]
    refs = {}

    def run(name, kind, pp, dp, tp, cfg, blist, save=None):
        import jax
        eng = jax_engine(kind, pp, dp, tp, cfg, trees[kind])
        if name == "pp2":
            refs["eval0"] = float(np.asarray(eng.eval_batch(blist[0])))
        losses = [float(np.asarray(eng.train_batch(b)))
                  for b in blist[:STEPS]]
        refs[name] = (losses, jax.tree.map(np.asarray,
                                           eng.state.master_params))
        if save:
            eng.save_checkpoint(save, tag="jax")
            refs[name + "_cont"] = float(np.asarray(
                eng.train_batch(blist[STEPS])))

    run("pp2", "gpt2", 2, 1, 1, conf(), g1, save=str(work / "jax"))
    # pp 4 loads both pp-2 checkpoints: launched once they exist
    launched["pp2"].result()
    launched["pp4"] = launched["deep"].submit(
        spawn_ranks, _pp4_job, 4, work, trees, str(work / "port"),
        str(work / "jax"))
    run("3d", "gpt2", 2, 2, 2, conf(), g2)
    run("tied", "tied", 2, 1, 1, conf(), linear_batches(GA * MICRO))
    run("bert", "bert", 2, 1, 1, conf(optimizer="Lamb"),
        bert_batches(GA * MICRO))
    return refs


@pytest.fixture(scope="module")
def pp2(launched):
    return launched["pp2"].result()


@pytest.fixture(scope="module")
def dp2(launched):
    return launched["dp2"].result()


@pytest.fixture(scope="module")
def three_d(launched):
    return launched["3d"].result()


@pytest.fixture(scope="module")
def pp4(launched, jax_refs):
    return launched["pp4"].result()


@pytest.fixture(scope="module")
def pp1(trees, work, pp2):
    """The one-process pp-1 engine (a local mesh): the masks' and the
    parameter bytes' reference, and the pp 2 → pp 1 load."""
    g = [split(b) for b in gpt2_batches(GA * MICRO)]
    g2 = [split(b) for b in gpt2_batches(2 * GA * MICRO)]
    out = {}
    # tiny ops: one intra-op thread, as the ranks run (and no fight for
    # the cores with the JAX side and the rank processes)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _pp1_runs(trees, work, g, g2, out)
    finally:
        torch.set_num_threads(threads)
    return out


def _pp1_runs(trees, work, g, g2, out):
    for sched in ("1f1b", "gpipe"):
        eng = port_engine("gpt2", conf(schedule=sched), 1, 1,
                          tree=trees["gpt2"])
        out[sched] = _train(eng, g)
        out["bytes"] = _bytes(eng)
        eng.close()
    eng = port_engine("gpt2", conf(), 1, 1, tree=trees["gpt2"])
    eng.load_checkpoint(str(work / "port"), tag="pp2")
    out["resized"] = float(eng.train_batch(g[STEPS]))
    eng.close()
    eng = port_engine("gpt2", conf(), 1, 1, tree=trees["gpt2"], dropout=0.1,
                      impl="flash")
    out["drop"] = _train(eng, g)
    eng.close()
    # the dp-2 meshes' global micro-batches, in one process
    eng = port_engine("gpt2", conf(micro=2), 1, 1, tree=trees["gpt2"],
                      dropout=0.1, impl="flash")
    out["drop_dp2"] = _train(eng, g2)
    eng.close()


def _check_master(per_rank, key, ref_master, tree):
    got = assemble([r[key] for r in per_rank])
    for a, b in zip(got, jax_leaves(ref_master, tree)):
        assert close(a, b), key


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sched", ["1f1b", "gpipe"])
def test_pp2_matches_jax_engine(sched, pp2, jax_refs, trees):
    """pp 2 (2 gloo ranks), 1F1B and GPipe: every rank's 3 fp32 losses
    and the gathered master equal the JAX 1F1B engine's within 1e-5."""
    losses, master = jax_refs["pp2"]
    for r in pp2:
        assert close(r[sched], losses), (sched, r[sched], losses)
    _check_master(pp2, f"{sched}_pieces", master, trees["gpt2"])
    # the point-to-point path ran: stage 0 sends M activations a step
    # (and an eval pass), stage 1 M grads a step
    assert pp2[0]["sends"] == (STEPS + 1) * GA
    assert pp2[1]["sends"] == STEPS * GA


def test_pp4_matches_jax_engine(pp4, jax_refs, trees):
    from deepspeed_tpu_torch.pipe.module import carry_params
    losses, master = jax_refs["pp2"]
    # the JAX master's [2, 2, ...] stacks as the pp-4 engine's [4, 1, ...]
    master = carry_params(master, port_module("gpt2", 4))
    for r in pp4:
        assert close(r["losses"], losses), (r["losses"], losses)
    _check_master(pp4, "pieces", master, trees["gpt2"])


@pytest.mark.parametrize("stage", [1, 3])
def test_pp2_dp2_zero_matches_jax_engine(stage, dp2, jax_refs, trees):
    """pp2 × dp2 at ZeRO 1 and 3 (dryrun legs 2 and 4): losses and the
    gathered master equal the JAX engine's on the same mesh; a stacked
    leaf is stage-local and, from stage 1, data-sharded on a non-stage
    dim (leg 4's 'pipe' and 'data' in one spec)."""
    losses, master = jax_refs["3d"]
    for r in dp2:
        assert close(r[stage], losses), (stage, r[stage], losses)
    _check_master(dp2, f"{stage}_pieces", master, trees["gpt2"])
    placed = dp2[0][f"{stage}_split"]
    assert any(split_ and local for split_, _, local in placed)
    for split_, zero_dim, local in placed:
        if local:
            assert zero_dim is not None and split_
    assert dp2[0][1] == dp2[0][3]


def test_3d_matches_jax_engine(three_d, jax_refs, trees):
    """pp2 × dp2 × tp2 at ZeRO 2 (dryrun leg 3) on 8 ranks."""
    losses, master = jax_refs["3d"]
    for r in three_d:
        assert close(r["losses"], losses), (r["losses"], losses)
    _check_master(three_d, "pieces", master, trees["gpt2"])
    assert any(d is not None for d in three_d[0]["tp_dims"])


@pytest.mark.parametrize("kind", ["tied", "bert"])
def test_tied_and_bert_match_jax_engine(kind, pp2, jax_refs, trees):
    """The tied-layer module (``tests/test_pipe.py:179-202``: one copy
    of the tied weights, their gradients summed over both stages) and
    BERT with LAMB at pp 2."""
    losses, master = jax_refs[kind]
    for r in pp2:
        assert close(r[kind], losses), (kind, r[kind], losses)
    _check_master(pp2, f"{kind}_pieces", master, trees[kind])
    if kind == "tied":
        keys = pp2[0]["tied_keys"]
        assert "tied" in keys and "layer_0" not in keys \
            and "layer_3" not in keys
        w = jax_leaves(master, trees["tied"])
        assert not np.array_equal(w[-1], jax_leaves(trees["tied"],
                                                     trees["tied"])[-1])


def test_one_stage_schedules_bitwise(pp1, pp2):
    """At one stage 1F1B and GPipe accumulate the micro-batches in the
    same order: bitwise equal; and pp 1 equals pp 2 within 1e-5."""
    assert pp1["1f1b"] == pp1["gpipe"]
    assert close(pp2[0]["1f1b"], pp1["1f1b"])


def test_eval_batch_and_refusals(pp2, jax_refs):
    for r in pp2:
        for sched in ("1f1b", "gpipe"):
            assert abs(r[f"eval0_{sched}"] - jax_refs["eval0"]) \
                <= RTOL * abs(jax_refs["eval0"])
    errs = pp2[0]["errs"]
    assert len(errs) == 4
    assert "needs a batch or a data_iter" in errs[0]
    assert "'train'-placed batch" in errs[1]
    assert "must be divisible by micro_batches (4)" in errs[2]
    assert errs[3].startswith("NotImplementedError") and "facade" in errs[3]
    assert "stage boundaries must share one activation shape" \
        in pp2[0]["mismatch"]


def test_refusals_in_one_process(trees):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.config import DeepSpeedConfig
    from deepspeed_tpu_torch.pipe.engine import PipelineEngine
    cfg = built_config(DeepSpeedConfig, conf(), 1)
    with pytest.raises(ValueError, match=r"mesh pipe axis \(1\) != "
                       r"PipelineModule.num_stages \(2\)"):
        PipelineEngine(port_module("gpt2", 2), cfg, device="cpu")
    with pytest.raises(ValueError, match="schedule must be"):
        PipelineEngine(port_module("gpt2", 1), cfg, device="cpu",
                       schedule="bogus")
    with pytest.raises(ValueError, match="cpu_offload × pipeline"):
        dst.initialize(model=port_module("gpt2", 1), device="cpu",
                       config=conf(stage=2, bf16=True, zero_optimization={
                           "stage": 2, "cpu_offload": True}))
    eng = PipelineEngine(port_module("gpt2", 1), cfg, device="cpu",
                         schedule="1f1b_uniform")
    with pytest.raises(ValueError, match="pair"):
        eng.train_batch(gpt2_batches(GA)[0])
    with pytest.raises(ValueError, match="!= train_batch_size 4"):
        eng.train_batch(split(gpt2_batches(GA + 1)[0]))
    # 1f1b_uniform runs the 1F1B interpreter
    assert np.isfinite(float(eng.train_batch(split(gpt2_batches(GA)[0]))))
    eng.close()


def test_parameter_bytes_per_rank(pp1, pp2):
    """pp 2 keeps each stage's rows of the stacked blocks: every rank
    holds fewer master bytes than the one-stage engine."""
    for r in pp2:
        assert r["bytes"] < pp1["bytes"]


def test_boundary_bound(pp2, pp4):
    """1F1B holds at most ``num_pipe_buffers()`` boundary inputs —
    ``min(stages - stage, M)`` live — whatever M is; GPipe holds M."""
    for s, r in enumerate(pp2):
        for m in (4, 16):
            assert r[f"live_{m}"] == min(2 - s, m)
        assert r["1f1b_live"] == min(2 - s, GA)
        assert r["gpipe_live"] == GA
    for s, r in enumerate(pp4):
        assert r["live"] == min(4 - s, GA)


def test_dropout_masks_do_not_depend_on_layout(pp1, pp2, pp4, dp2, three_d):
    """At dropout 0.1 (the hashed attention dropout, the seeded hidden
    dropouts over the global micro-batch rows): pp 1, 2 and 4, both
    schedules, dp 2 and tp 2 draw the same masks — the losses agree
    within fp32 noise."""
    ref = pp1["drop"]
    assert not close(ref, pp1["1f1b"], 1e-3)   # the dropout is on
    for got in (pp2[0]["drop_1f1b"], pp2[0]["drop_gpipe"], pp4[0]["drop"]):
        assert close(got, ref), (got, ref)
    for got in (dp2[0]["drop"], three_d[0]["drop"]):
        assert close(got, pp1["drop_dp2"]), (got, pp1["drop_dp2"])


def test_checkpoints_roundtrip_resize_and_cross_packages(pp1, pp2, pp4, dp2,
                                                         jax_refs, trees,
                                                         work):
    # save → load → continue inside the port: bitwise
    for r in pp2:
        assert r["cont"] == r["cont_again"]
        for a, b in zip(r["cont_pieces"], r["cont_again_pieces"]):
            np.testing.assert_array_equal(a, b)
    cont = pp2[0]["cont"]
    # pp 2 → pp 4 and pp 2 → pp 1
    assert close(pp4[0]["resized"], cont)
    assert close(pp1["resized"], cont)
    # the JAX engine's pp-2 checkpoint continued on the port at pp 4
    assert close(pp4[0]["from_jax"], jax_refs["pp2_cont"])
    # the port's (two processes, sharded pieces) continued on JAX
    import jax
    g = [split(b) for b in gpt2_batches(GA * MICRO)]
    eng = jax_engine("gpt2", 2, 1, 1, conf(), trees["gpt2"])
    assert eng.load_checkpoint(str(work / "port"), tag="pp2")[0]
    assert close(float(np.asarray(eng.train_batch(g[STEPS]))), cont)
    del jax
    # the bf16 ZeRO-1 roundtrip and async == sync (the JAX engine's
    # single-controller rules across processes)
    for r in dp2:
        a, b = r["roundtrip"]
        assert a == b
        assert r["single_controller"] == (True, True)
    sync, asy = work / "dp2" / "sync", work / "dp2" / "async"
    files = sorted(p.relative_to(sync) for p in sync.rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(asy) for p in asy.rglob("*")
                           if p.is_file())
    for rel in files:
        assert (sync / rel).read_bytes() == (asy / rel).read_bytes(), rel
