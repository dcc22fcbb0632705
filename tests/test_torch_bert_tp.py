"""Port parity for BERT's Megatron tensor parallelism: the port's engine on
2 and 4 gloo ranks (tp2, dp2×tp2; ``tests/test_torch_zero.py::
spawn_ranks``) against the port's one-rank engine and the JAX engine on a
virtual (dp, tp) mesh, on the same numpy weights and MLM + NSP batches
(``tests/test_torch_zero.py::bert_batch``: unequal label counts, padded
rows).  ``attn_qkvw``/``inter_w`` column-split, ``attn_ow``/``output_w``
row-split, ``word_embeddings``/``mlm_bias`` vocab-parallel (vocabulary 64
divides by 2).

Tolerances: every step's loss within fp32 1e-5 relative of the one-rank
port engine's and of the JAX engine's (LAMB, 3 steps), the gathered
master within 1e-5; with hidden and attention dropout 0.1 the tp2 losses
equal the one-rank engine's within 1e-5 (the masks are drawn over all
heads, so they do not depend on the layout).
"""
import numpy as np
import pytest

from test_torch_zero import (BERT, GA, MICRO, assemble, bert_batch,
                             built_config, close, config, jax_leaves,
                             leaf_names, spawn_ranks)

STEPS = 3


def _jax_tree():
    import jax
    from deepspeed_tpu.models.bert import BertConfig, BertModel
    return jax.tree.map(np.asarray, BertModel(BertConfig(
        **BERT, attn_impl="dense", remat=None)).init(jax.random.PRNGKey(0)))


def _engine(tree, dp, tp, stage=0, dropout=0.0):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.config import DeepSpeedConfig
    from deepspeed_tpu_torch.models.bert import BertConfig, BertModel
    from deepspeed_tpu_torch.parallel import build_mesh
    cfg = dict(config(stage, "Lamb"),
               train_micro_batch_size_per_gpu=2 * MICRO // dp)
    model = BertModel(BertConfig(**{**BERT, "hidden_dropout_prob": dropout,
                                    "attention_probs_dropout_prob": dropout}))
    eng, *_ = dst.initialize(model=model, params=tree, seed=3,
                             config=built_config(DeepSpeedConfig, cfg, dp),
                             device="cpu", mesh=build_mesh(dp=dp, tp=tp))
    return eng


def _run(eng, blist, dp, rank):
    from deepspeed_tpu_torch.runtime.dataloader import rank_rows
    return [float(eng.train_batch(rank_rows(b, GA, dp, rank)))
            for b in blist]


def _tp_job(rank, world, tree, blist):
    from test_torch_zero import gathered_pieces
    tp = 2
    dp = world // tp
    d = rank // tp
    out = {}
    eng = _engine(tree, dp, tp, stage=1 if dp > 1 else 0)
    out["losses"] = _run(eng, blist, dp, d)
    out["pieces"] = gathered_pieces(eng)
    eng.close()
    eng = _engine(tree, dp, tp, dropout=0.1)
    out["dropout"] = _run(eng, blist, dp, d)
    eng.close()
    return out


@pytest.fixture(scope="module")
def setup():
    tree = _jax_tree()
    blist = [bert_batch(GA * MICRO * 2, seed=s) for s in range(STEPS)]
    one = _engine(tree, 1, 1)
    ref = _run(one, blist, 1, 0)
    one.close()
    drop = _engine(tree, 1, 1, dropout=0.1)
    ref_drop = _run(drop, blist, 1, 0)
    drop.close()
    return tree, blist, ref, ref_drop


def _jax_losses(tree, blist, dp, tp):
    import jax
    from deepspeed_tpu.config import DeepSpeedConfig
    from deepspeed_tpu.models.bert import BertConfig, BertModel
    from deepspeed_tpu.parallel import build_mesh
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine
    cfg = dict(config(0, "Lamb"),
               train_micro_batch_size_per_gpu=2 * MICRO // dp)
    eng = DeepSpeedEngine(
        BertModel(BertConfig(**BERT, attn_impl="dense", remat=None)),
        built_config(DeepSpeedConfig, cfg, dp), params=tree,
        mesh=build_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp]))
    losses = [float(np.asarray(eng.train_batch(b))) for b in blist]
    master = jax.tree.map(np.asarray, eng.state.master_params)
    eng.close()
    return losses, master


@pytest.mark.parametrize("world", [2, 4], ids=["tp2", "dp2tp2"])
def test_bert_tensor_parallel_matches_one_rank_and_jax(tmp_path, setup,
                                                       world):
    """BERT with LAMB at tp2 (stage 0) and dp2×tp2 (stage 1): every
    rank's losses within fp32 1e-5 of the one-rank port engine's and of
    the JAX engine's on the same mesh shape; the master pieces assemble
    to the JAX engine's master within 1e-5; with dropout 0.1 the losses
    equal the one-rank engine's within 1e-5."""
    tree, blist, ref, ref_drop = setup
    res = spawn_ranks(_tp_job, world, tmp_path, tree, blist, timeout=300.0)
    jl, jmaster = _jax_losses(tree, blist, world // 2, 2)
    for r in range(world):
        assert close(res[r]["losses"], ref), (r, res[r]["losses"], ref)
        assert close(res[r]["losses"], jl), (r, res[r]["losses"], jl)
        assert close(res[r]["dropout"], ref_drop), (
            r, res[r]["dropout"], ref_drop)
    got = assemble([res[r]["pieces"] for r in range(world)])
    want = jax_leaves(jmaster, tree)
    names = leaf_names(tree)
    assert len(got) == len(want)
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                   err_msg=name)
