"""Multi-process checkpoints in the JAX package's format: the port's
ZeRO saves across gloo ranks (per-rank shard files, index files, rank 0's
manifest entry ``"sharded": true``) and loads that merge exactly the
ranges a rank needs — the cases of ``tests/test_checkpointing.py``
(``test_elastic_dp_resize``, ``test_zero_stage_change_on_load``,
``test_roundtrip_exact``) across processes and across the two packages.

Tolerances, stated per test: leaves carried without arithmetic are equal
bit for bit across the packages; a resume at the same dp and stage is
bitwise; a resume at another dp (the same global batch) or another stage
continues within fp32 1e-5 relative of the uninterrupted run's losses.
"""
import os

import numpy as np

from test_torch_zero import (GA, MICRO, assemble, batches, built_config,
                             close, config, gathered_pieces, jax_leaves,
                             jax_tree, one_thread, port_engine,  # noqa: F401
                             spawn_ranks)
from deepspeed_tpu_torch.runtime.dataloader import rank_rows
from deepspeed_tpu_torch.runtime.utils import tree_leaves

SAVE_STEPS, MORE = 2, 2


def _micro(dp):
    """The micro-batch that keeps dp 2's global batch at ``dp``."""
    return dict(config(2), train_micro_batch_size_per_gpu=MICRO * 2 // dp)


def _continue(eng, blist, dp):
    d = eng.mesh.axis_index("data")
    return [float(eng.train_batch(rank_rows(b, GA, dp, d))) for b in blist]


def _pieces(eng):
    opt = eng.state.opt_state
    rt = eng._zero
    return {"master": gathered_pieces(eng),
            "mu": [(p.tensor.clone().numpy(), p.box, p.shape)
                   for p in rt.shard_pieces(opt.mu)],
            "nu": [(p.tensor.clone().numpy(), p.box, p.shape)
                   for p in rt.shard_pieces(opt.nu)]}


def _save_and_resume(rank, world, tree, blist, save_dir, jax_dir):
    """dp 2: train, save (ZeRO 2), continue; a fresh stage-2 engine and a
    fresh stage-3 engine load and continue; a fresh engine loads the JAX
    package's dp-8 save."""
    eng = port_engine(config(2), tree, dp=2)
    _continue(eng, blist[:SAVE_STEPS], 2)
    eng.save_checkpoint(save_dir, tag="s2")
    saved = _pieces(eng)
    files = sorted(os.listdir(os.path.join(save_dir, "s2", "optim")))
    cont = _continue(eng, blist[SAVE_STEPS:], 2)
    eng.close()
    out = {"saved": saved, "files": files, "cont": cont}
    for stage in (2, 3):
        fresh = port_engine(config(stage), tree, dp=2)
        fresh.load_checkpoint(save_dir, tag="s2")
        out[f"resume{stage}"] = _continue(fresh, blist[SAVE_STEPS:], 2)
        fresh.close()
    fresh = port_engine(config(2), tree, dp=2)
    fresh.load_checkpoint(jax_dir, tag="j8")
    out["from_jax"] = _pieces(fresh)
    fresh.close()
    return out


def _resume_at(rank, world, tree, blist, save_dir):
    eng = port_engine(_micro(world), tree, dp=world)
    eng.load_checkpoint(save_dir, tag="s2")
    out = _continue(eng, blist[SAVE_STEPS:], world)
    eng.close()
    return out


def _jax_engine(dp, stage, tree, micro):
    import jax
    from deepspeed_tpu.config import DeepSpeedConfig
    from deepspeed_tpu.models.gpt2 import GPT2Config, GPT2Model
    from deepspeed_tpu.parallel import build_mesh
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine
    from test_torch_zero import TINY
    cfg = dict(config(stage), train_micro_batch_size_per_gpu=micro)
    return DeepSpeedEngine(
        GPT2Model(GPT2Config(**TINY, remat=None, attn_impl="dense")),
        built_config(DeepSpeedConfig, cfg, dp),
        mesh=build_mesh(dp=dp, devices=jax.devices()[:dp]), params=tree)


def _jax_opt_leaves(eng, tree, field):
    import jax
    return jax_leaves(jax.tree.map(np.asarray,
                                   getattr(eng.state.opt_state, field)),
                      tree)


def test_zero_checkpoints_cross_packages_and_resize(tmp_path):
    """A dp-2 ZeRO-2 save on 2 gloo ranks: the optimizer plane holds each
    rank's shard files and index files; the JAX package loads it into a
    dp-2 engine equal leaf for leaf (master and moments, bitwise); the
    same dp and stage resume bitwise; stage 3 at dp 2, dp 1 and dp 4 (the
    same global batch) continue within fp32 1e-5 of the uninterrupted
    run; and the JAX package's dp-8 save loads in the port at dp 2 equal
    to the JAX engine's state, bit for bit."""
    tree = jax_tree()
    blist = batches(2, steps=SAVE_STEPS + MORE)
    save_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    jeng8 = _jax_engine(8, 2, tree, 1)
    jeng8.train_batch(batches(8, steps=1, micro=1)[0])
    jeng8.save_checkpoint(jax_dir, tag="j8")
    res = spawn_ranks(_save_and_resume, 2, tmp_path, tree, blist, save_dir,
                      jax_dir)
    r0 = res[0]
    # the JAX package's multi-process layout: shard and index files of
    # both ranks beside rank 0's whole leaves and manifest
    files = r0["files"]
    assert "manifest.json" in files
    assert any(f.endswith(".proc0_0.npy") for f in files)
    assert any(f.endswith(".proc1_0.npy") for f in files)
    assert any(f.endswith(".proc1.json") for f in files)
    # same dp and stage: bitwise; stage 2 -> 3: within tolerance
    assert r0["resume2"] == r0["cont"], (r0["resume2"], r0["cont"])
    assert close(r0["resume3"], r0["cont"])
    # the JAX package loads the port's sharded save
    jeng = _jax_engine(2, 2, tree, MICRO)
    jeng.load_checkpoint(save_dir, tag="s2")
    import jax
    want = {"master": jax_leaves(jax.tree.map(np.asarray,
                                              jeng.state.master_params),
                                 tree),
            "mu": _jax_opt_leaves(jeng, tree, "mu"),
            "nu": _jax_opt_leaves(jeng, tree, "nu")}
    for field in ("master", "mu", "nu"):
        got = assemble([res[r]["saved"][field] for r in range(2)])
        for a, b in zip(got, want[field]):
            np.testing.assert_array_equal(a, b)
    # the port loads the JAX package's dp-8 save at dp 2
    want8 = {"master": jax_leaves(jax.tree.map(
        np.asarray, jeng8.state.master_params), tree),
        "mu": _jax_opt_leaves(jeng8, tree, "mu"),
        "nu": _jax_opt_leaves(jeng8, tree, "nu")}
    for field in ("master", "mu", "nu"):
        got = assemble([res[r]["from_jax"][field] for r in range(2)])
        for a, b in zip(got, want8[field]):
            np.testing.assert_array_equal(a, b)
    # dp 2 -> 4 on 4 ranks, dp 2 -> 1 in this process
    res4 = spawn_ranks(_resume_at, 4, tmp_path, tree, blist, save_dir)
    for r in range(4):
        assert close(res4[r], r0["cont"]), (res4[r], r0["cont"])
    eng1 = port_engine(_micro(1), tree, dp=1)
    eng1.load_checkpoint(save_dir, tag="s2")
    assert close([float(eng1.train_batch(b)) for b in blist[SAVE_STEPS:]],
                 r0["cont"])
    assert all(t.numel() == int(np.prod(s)) for t, s in zip(
        tree_leaves(eng1.state.master_params),
        [x.shape for x in jax_leaves(tree, tree)]))
    eng1.close()
