"""Port parity for ZeRO stages 0-3 and the data-parallel step:
``deepspeed_tpu_torch`` on 2 and 4 gloo ranks (spawned processes, one
``torch.distributed`` group over a ``file://`` store under the test's
``tmp_path``) against the JAX engine on a virtual CPU mesh of the same
shape (``tests/conftest.py``'s 8 devices).

Each configuration launches its ranks once (``spawn_ranks``); a rank that
raises fails the test at once, and ranks still running at the time limit
are killed.  The ranks import only torch and the port: this module keeps
jax out of module level (the JAX side runs in the pytest process).

Tolerances, stated per test: fp32 losses and the gathered master within
1e-5 relative of the JAX engine's (3 steps, Adam or LAMB); per-rank
state sizes exact; ``verify_gradient_partitioning`` under 2e-5, as
``tests/test_engine.py`` holds the JAX engine.
"""
import multiprocessing as mp
import os
import time
import traceback

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.runtime.utils import tree_leaves

VOCAB, T = 128, 8
TINY = dict(vocab_size=VOCAB, n_positions=16, d_model=32, n_layer=4,
            n_head=4)
MICRO, GA = 2, 2
STEPS = 3
RTOL = 1e-5


# ---------------------------------------------------------------------------
# rank launcher (shared with the other multi-rank test files)
# ---------------------------------------------------------------------------
def _rank_entry(fn, rank, world, init, out, args):
    torch.set_num_threads(1)
    try:
        from deepspeed_tpu_torch.parallel import init_distributed
        init_distributed(device="cpu", init_method=init, rank=rank,
                         world_size=world, timeout_s=60)
        res = fn(rank, world, *args)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
        import torch.distributed as dist
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def spawn_ranks(fn, world, tmp_path, *args, timeout=240.0):
    """Run ``fn(rank, world, *args)`` on ``world`` gloo ranks; returns
    each rank's result.  The first rank to fail (or the time limit)
    kills the rest and fails the caller with the rank's traceback."""
    out = tmp_path / f"ranks_{fn.__name__}_{world}_{time.monotonic_ns()}"
    out.mkdir()
    init = "file://" + str(out / "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(fn, r, world, init, str(out), args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while True:
            codes = [p.exitcode for p in procs]
            if all(c == 0 for c in codes):
                break
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed or time.monotonic() > deadline:
                errs = [(out / f"rank{r}.err").read_text()
                        for r in range(world)
                        if (out / f"rank{r}.err").exists()]
                raise AssertionError(
                    f"{fn.__name__} on {world} ranks: "
                    + (f"ranks {failed} failed" if failed
                       else f"timed out after {timeout} s")
                    + "\n" + "\n".join(errs))
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# shared fixtures: the JAX init tree, batches, configs, the JAX engine
# ---------------------------------------------------------------------------
def jax_tree(cfg=TINY, seed=0):
    import jax
    from deepspeed_tpu.models.gpt2 import GPT2Config, GPT2Model
    model = GPT2Model(GPT2Config(**cfg, remat=None, attn_impl="dense"))
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed)))


def batches(dp, steps=STEPS, ga=GA, micro=MICRO, vocab=VOCAB, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (ga * micro * dp, T + 1), np.int32)
            for _ in range(steps)]


def config(stage, optimizer="Adam", bf16=False, clip=1.0):
    cfg = {"train_micro_batch_size_per_gpu": MICRO,
           "gradient_accumulation_steps": GA,
           "steps_per_print": 10 ** 6,
           "gradient_clipping": clip,
           "zero_optimization": {"stage": stage},
           # eps 1e-3: Adam's m/(sqrt(v)+eps) turns the summation-order
           # noise on zero-gradient elements (the key bias) into lr-sized
           # steps; with eps 1e-8 the JAX engine's own dp 1 and dp 2
           # masters differ by 2.3e-4 relative after 3 steps, with 1e-3
           # by 1.3e-6 (the port's dp 2 master by 4.8e-6 from JAX's),
           # under the 1e-5 these tests hold the port to
           "optimizer": {"type": optimizer,
                         "params": {"lr": 1e-2, "eps": 1e-3,
                                    "weight_decay": 0.01}}}
    if bf16:
        cfg["bf16"] = {"enabled": True}
    return cfg


def built_config(config_cls, cfg, world):
    """``config_cls(cfg, world)``.  Both packages' config checks refuse
    ZeRO without fp16/bf16 (the reference's rule); an fp32 config is
    built at stage 0 and its ZeRO stage set after, so the stages are held
    to the JAX engine at fp32's tolerance."""
    stage = cfg["zero_optimization"]["stage"]
    fp32 = "bf16" not in cfg and "fp16" not in cfg
    out = config_cls({**cfg, "zero_optimization": {"stage": 0}}
                     if fp32 else cfg, world_size=world)
    out.zero_config.stage = stage
    return out


def jax_run(cfg, tree, blist, dp, tp=1, model_cfg=TINY):
    """The JAX engine on a virtual (dp, tp) mesh: (losses, master, the
    last step's gradient norm)."""
    import jax
    from deepspeed_tpu.config import DeepSpeedConfig
    from deepspeed_tpu.models.gpt2 import GPT2Config, GPT2Model
    from deepspeed_tpu.parallel import build_mesh
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine
    mesh = build_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    eng = DeepSpeedEngine(
        GPT2Model(GPT2Config(**model_cfg, remat=None, attn_impl="dense")),
        built_config(DeepSpeedConfig, cfg, dp), mesh=mesh, params=tree)
    losses = [float(np.asarray(eng.train_batch(b))) for b in blist]
    master = jax.tree.map(np.asarray, eng.state.master_params)
    return losses, master, float(eng.last_metrics.grad_norm)


def port_engine(cfg, tree, dp, tp=1, model_cfg=TINY, attn_impl="dense",
                dropout=0.0, remat="block"):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.config import DeepSpeedConfig
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from deepspeed_tpu_torch.parallel import build_mesh
    model = GPT2Model(GPT2Config(**model_cfg, remat=remat,
                                 attn_impl=attn_impl, dropout=dropout,
                                 embd_dropout=dropout))
    eng, *_ = dst.initialize(model=model,
                             config=built_config(DeepSpeedConfig, cfg, dp),
                             params=tree, device="cpu",
                             mesh=build_mesh(dp=dp, tp=tp))
    return eng


def gathered_pieces(eng):
    """This rank's master pieces with their boxes (the test assembles the
    whole leaves from every rank's)."""
    rt = eng._zero
    return [(p.tensor.detach().clone().numpy(), p.box, p.shape)
            for p in rt.shard_pieces(tree_leaves(eng.state.master_params))]


def assemble(per_rank):
    """Whole leaves from every rank's ``gathered_pieces``."""
    out = []
    for i in range(len(per_rank[0])):
        shape = per_rank[0][i][2]
        full = np.full(shape, np.nan, np.float32)
        for pieces in per_rank:
            t, box, _ = pieces[i]
            full[tuple(slice(a, b) for a, b in box)] = t
        out.append(full)
    return out


def jax_leaves(master, order):
    """The JAX master's leaves in the port engine's order: that of the
    ``order`` tree it was given (``tree_leaves``, dict order)."""
    def walk(tmpl, tree):
        if isinstance(tmpl, dict):
            return [x for k in tmpl for x in walk(tmpl[k], tree[k])]
        return [np.asarray(tree)]
    return walk(order, master)


def leaf_names(order, prefix=""):
    if isinstance(order, dict):
        return [n for k in order for n in leaf_names(order[k],
                                                     f"{prefix}{k}/")]
    return [prefix[:-1]]


def close(a, b, rtol=RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() <= rtol * max(np.abs(b).max(), 1e-6)


# ---------------------------------------------------------------------------
# the rank functions
# ---------------------------------------------------------------------------
def _train_stages(rank, world, tree, blist, stages, optimizer):
    """Every stage in turn: losses, master pieces, per-rank state and
    grad sizes, and the stage-3 live-gather audit."""
    from deepspeed_tpu_torch.runtime.dataloader import rank_rows
    from deepspeed_tpu_torch.runtime.zero import ZeroRuntime
    out = {}
    for stage in stages:
        eng = port_engine(config(stage, optimizer), tree, dp=world)
        rt = eng._zero
        acc_numels, live = [], []
        refs = []
        orig_finish, orig_mat = rt.finish_grads, rt.materialize

        def finish():
            acc_numels.append([a.numel() for a in rt._acc])
            return orig_finish()

        def materialize(i, layer):
            t = orig_mat(i, layer)
            if layer is not None:
                # no other layer's gathered params alive at this fetch
                live.append(sum(1 for lyr, r in refs
                                if lyr != layer and r() is not None))
                import weakref
                refs.append((layer, weakref.ref(t)))
            return t
        rt.finish_grads, rt.materialize = finish, materialize
        losses = [float(eng.train_batch(rank_rows(b, GA, world, rank)))
                  for b in blist]
        rt.finish_grads, rt.materialize = orig_finish, orig_mat
        pg = (eng.verify_gradient_partitioning(
            rank_rows(blist[0], GA, world, rank)) if stage >= 2 else None)
        out[stage] = {
            "losses": losses,
            "pieces": gathered_pieces(eng),
            "master_numel": [p.numel()
                             for p in tree_leaves(eng.state.master_params)],
            "mu_numel": [m.numel() for m in eng.state.opt_state.mu],
            "nu_numel": [m.numel() for m in eng.state.opt_state.nu],
            "acc_numel": acc_numels[0],
            "live_max": max(live) if live else 0,
            "live_after": sum(1 for _, r in refs if r() is not None),
            "zero_dims": [p.zero_dim for p in rt.placements],
            "pg": pg,
        }
        assert isinstance(rt, ZeroRuntime)
        eng.close()
    return out


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", [2, 4])
def test_zero_stages_match_jax_engine(world, tmp_path):
    """Stages 0-3, fp32 Adam with clipping and weight decay, 3 steps at dp
    2 and 4: every rank's losses and the master gathered from every
    rank's pieces match the JAX engine on a (dp, 1) virtual mesh within
    fp32 1e-5; at stage >= 1 a rank holds 1/dp of every divisible master
    and moment leaf, at stage >= 2 1/dp of their grads; at stage 3 no
    layer's gathered params outlive its forward or backward;
    ``verify_gradient_partitioning`` at stages 2-3 is under 2e-5."""
    tree = jax_tree()
    blist = batches(world)
    stages = (0, 1, 2, 3)
    res = spawn_ranks(_train_stages, world, tmp_path, tree, blist, stages,
                      "Adam")
    full = [int(np.prod(x.shape)) for x in jax_leaves(tree, tree)]
    for stage in stages:
        ref_losses, ref_master, _ = jax_run(config(stage), tree, blist,
                                            world)
        ref = jax_leaves(ref_master, tree)
        for r in range(world):
            got = res[r][stage]
            assert close(got["losses"], ref_losses), (stage, r, got["losses"],
                                                      ref_losses)
        for a, b in zip(assemble([res[r][stage]["pieces"]
                                  for r in range(world)]), ref):
            assert close(a, b), stage
        got = res[0][stage]
        split = [d is not None for d in got["zero_dims"]]
        names = leaf_names(tree)
        # wte shards on d (its vocab dim is the tensor-parallel one), the
        # stacked blocks on L
        assert got["zero_dims"][names.index("wte")] == 1
        assert got["zero_dims"][names.index("blocks/qkv_w")] == 0
        for i, n in enumerate(full):
            want = n // world if stage >= 1 and split[i] else n
            assert got["master_numel"][i] == want, (stage, i)
            assert got["mu_numel"][i] == got["nu_numel"][i] == want
            grad = n // world if stage >= 2 and split[i] else n
            assert got["acc_numel"][i] == grad, (stage, i)
        if stage == 3:
            assert got["live_max"] == 0 and got["live_after"] == 0
        if stage >= 2:
            assert got["pg"]["max_abs_diff"] < 2e-5


def test_lamb_stage1_matches_jax_engine(tmp_path):
    """LAMB at ZeRO stage 1 (examples/bert_pretrain.py's optimizer and
    stage) on 2 ranks: each trust ratio takes the whole leaf's norms.
    The losses match the JAX engine's within fp32 1e-5.  The gathered
    master matches within 1e-5 relative, or where the JAX engine
    disagrees with itself between dp 1 and dp 2 by more than a fifth of
    that, within 5x its own disagreement: LAMB's first step moves the
    zero-initialized biases by lr times m/(sqrt(v)+eps), noise on
    zero-gradient elements included (the JAX engine's own dp-1/dp-2
    distance on ``proj_b`` is 4.7e-6 relative, the port's 1.4e-5)."""
    tree = jax_tree()
    blist = batches(2)
    res = spawn_ranks(_train_stages, 2, tmp_path, tree, blist, (1,),
                      "Lamb")
    ref_losses, ref_master, _ = jax_run(config(1, "Lamb"), tree, blist, 2)
    one = config(1, "Lamb")
    one["train_micro_batch_size_per_gpu"] = 2 * MICRO
    _, one_master, _ = jax_run(one, tree, blist, 1)
    for r in range(2):
        assert close(res[r][1]["losses"], ref_losses), (
            res[r][1]["losses"], ref_losses)
    for a, b, c in zip(assemble([res[r][1]["pieces"] for r in range(2)]),
                       jax_leaves(ref_master, tree),
                       jax_leaves(one_master, tree)):
        scale = np.abs(b).max()
        floor = np.abs(c.astype(np.float64) - b).max() / scale
        assert close(a, b, max(RTOL, 5 * floor))


# ---------------------------------------------------------------------------
# BERT (ZeRO is model-agnostic) and the refusals that remain
# ---------------------------------------------------------------------------
BERT = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=16, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
BERT_T = 16


def bert_batch(rows, seed=0):
    """MLM + NSP rows (``tests/test_torch_bert.py``'s recipe): 15 % of
    the live positions labelled and every fourth row right-padded, so the
    data ranks hold unequal label counts."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, BERT["vocab_size"], (rows, BERT_T)).astype(np.int32)
    mask = np.ones((rows, BERT_T), np.int32)
    for r in range(0, rows, 4):
        mask[r, BERT_T - 9 - r % 7:] = 0
    ids = np.where(mask > 0, ids, 0).astype(np.int32)
    labels = np.where((rng.random((rows, BERT_T)) < 0.15) & (mask > 0), ids,
                      -100).astype(np.int32)
    return {"input_ids": ids, "attention_mask": mask,
            "token_type_ids": (np.arange(BERT_T)[None] >= BERT_T // 2)
            .astype(np.int32).repeat(rows, 0),
            "masked_lm_labels": labels,
            "next_sentence_label": rng.integers(0, 2, rows).astype(np.int32)}


def bert_engine(cfg, dp, tp=1):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.config import DeepSpeedConfig
    from deepspeed_tpu_torch.models.bert import BertConfig, BertModel
    from deepspeed_tpu_torch.parallel import build_mesh
    eng, *_ = dst.initialize(
        model=BertModel(BertConfig(**BERT)), seed=3,
        config=built_config(DeepSpeedConfig, cfg, dp), device="cpu",
        mesh=build_mesh(dp=dp, tp=tp))
    return eng


def _bert_and_refusals(rank, world, blist, save_dir):
    import os
    from deepspeed_tpu_torch.runtime.dataloader import rank_rows
    out = {}
    eng = bert_engine(config(1, "Lamb"), dp=world)
    out["losses"] = [float(eng.train_batch(rank_rows(b, GA, world, rank)))
                     for b in blist]
    eng.close()
    tp = bert_engine(dict(config(0, "Lamb"),
                          train_micro_batch_size_per_gpu=2 * MICRO),
                     dp=1, tp=world)
    out["bert_tp"] = [float(tp.train_batch(b)) for b in blist]
    tp.close()
    eng = bert_engine(dict(config(0), checkpoint={"async_save": True,
                                                  "sigterm_save": True}),
                      dp=world)
    eng.train_batch(rank_rows(blist[0], GA, world, rank))
    eng.save_checkpoint(save_dir)
    # written synchronously: on disk when the call returns, no writer
    # in flight; and no SIGTERM hook installed
    out["async"] = (os.path.exists(os.path.join(save_dir, "global_step1",
                                                "meta.json")),
                    eng._ckpt_writer.in_flight(),
                    eng._preemption_handler is None)
    eng.close()
    return out


def test_bert_lamb_stage1_on_two_ranks_and_refusals(tmp_path):
    """BERT with LAMB at stage 1 on 2 ranks trains as one rank on the
    same global batch (losses within fp32 1e-5): the masked-LM loss is
    normalized by the global micro-batch's label count though the ranks
    hold unequal counts.  BERT at tp 2 trains as one rank too (within
    1e-5), and across processes an async save writes synchronously and
    ``sigterm_save`` installs no hook, as in the JAX engine."""
    blist = [bert_batch(GA * MICRO * 2, seed=s) for s in range(2)]
    res = spawn_ranks(_bert_and_refusals, 2, tmp_path, blist,
                      str(tmp_path / "ckpt"))
    one = bert_engine(dict(config(1, "Lamb"),
                           train_micro_batch_size_per_gpu=2 * MICRO), dp=1)
    ref = [float(one.train_batch(b)) for b in blist]
    one.close()
    for r in range(2):
        assert close(res[r]["losses"], ref), (res[r]["losses"], ref)
        assert close(res[r]["bert_tp"], ref), (res[r]["bert_tp"], ref)
        assert res[r]["async"] == (True, False, True)


def _one_rank_stages(rank, world, tree, blist):
    from deepspeed_tpu_torch.runtime.dataloader import rank_rows
    import torch.distributed as dist
    out = {"backend": dist.get_backend()}
    for stage in (0, 1, 2, 3):
        eng = port_engine(config(stage, bf16=True), tree, dp=1,
                          attn_impl="flash", dropout=0.1)
        out[stage] = [float(eng.train_batch(rank_rows(b, GA, 1, 0)))
                      for b in blist]
        eng.close()
    return out


def test_one_rank_group_stages_equal_bitwise(tmp_path):
    """On a process group of one rank (the card's train_zero phase, here
    on gloo) every stage runs its collectives, slicing and gathers over
    the one rank, and bf16 training with dropout 0.1 gives stage 0's
    losses bit for bit at stages 1-3."""
    tree = jax_tree()
    res, = spawn_ranks(_one_rank_stages, 1, tmp_path, tree, batches(1))
    assert res["backend"] == "gloo"
    for stage in (1, 2, 3):
        assert res[stage] == res[0], (stage, res[stage], res[0])
