"""Port parity for GPT-2's Megatron tensor parallelism: ``deepspeed_tpu_
torch`` on gloo ranks laid out as ``build_mesh(dp=2, tp=2)`` against the
JAX engine on the same virtual mesh, and the port's layout independence
under dropout.  The ranks are spawned by ``test_torch_zero.spawn_ranks``
(one launch per configuration list) and import only torch and the port.

Tolerances, stated per test: fp32 losses, gradient norms and the
gathered master within 1e-5 relative of the JAX engine's (3 steps); the
bf16 first-step loss within ``__graft_entry__._check_close``'s 1 % of the
JAX engine's one-device value (the dryrun bar); under dropout 0.1 the
dp-2 and tp-2 losses within 1e-5 of the one-rank run's.
"""
import numpy as np

from test_torch_zero import (GA, MICRO, TINY, assemble, batches, close,
                             config, gathered_pieces, jax_leaves, jax_run,
                             jax_tree, one_thread, port_engine,  # noqa: F401
                             spawn_ranks)
from deepspeed_tpu_torch.runtime.dataloader import rank_rows

ODD = dict(TINY, vocab_size=127)   # V % tp != 0: wte stays replicated
CLIP = 0.25


def _run_jobs(rank, world, jobs):
    """Each job on this rank: losses, last grad norm, master pieces and
    wte's piece shape."""
    out = []
    for job in jobs:
        eng = port_engine(job["cfg"], job["tree"], dp=job["dp"],
                          tp=job["tp"], model_cfg=job["model"],
                          attn_impl=job.get("attn", "dense"),
                          dropout=job.get("dropout", 0.0))
        d = eng.mesh.axis_index("data")
        losses = [float(eng.train_batch(rank_rows(b, GA, job["dp"], d)))
                  for b in job["batches"]]
        out.append({"losses": losses,
                    "grad_norm": eng.last_metrics.grad_norm,
                    "pieces": gathered_pieces(eng),
                    "wte": tuple(eng.state.master_params["wte"].shape)})
        eng.close()
    return out


def test_dp2_tp2_zero_stages_match_jax_engine(tmp_path):
    """``initialize(model=GPT2Model(tiny), mesh=build_mesh(dp=2, tp=2))``
    on 4 gloo ranks at ZeRO stages 0-3 (fp32, Adam, clipping at 0.25 —
    which acts: the norm is above it, so a leaf counted twice would
    change every step), with the vocab-parallel ``wte`` (V 128), and at
    stage 3 with the replicated one (V 127): losses, the last gradient
    norm and the master gathered from every rank's pieces match the JAX
    engine on ``build_mesh(dp=2, tp=2)`` within fp32 1e-5.  Then bf16
    ZeRO-3: the first-step loss within 1 % of the JAX engine's one-device
    value."""
    tree, odd_tree = jax_tree(), jax_tree(ODD)
    blist, odd_batches = batches(2), batches(2, vocab=ODD["vocab_size"])
    jobs = [{"cfg": config(s, clip=CLIP), "tree": tree, "dp": 2, "tp": 2,
             "model": TINY, "batches": blist} for s in (0, 1, 2, 3)]
    jobs.append({"cfg": config(3, clip=CLIP), "tree": odd_tree, "dp": 2, "tp": 2,
                 "model": ODD, "batches": odd_batches})
    jobs.append({"cfg": config(3, bf16=True), "tree": tree, "dp": 2,
                 "tp": 2, "model": TINY, "batches": blist[:1]})
    res = spawn_ranks(_run_jobs, 4, tmp_path, jobs)
    for j, job in enumerate(jobs[:5]):
        losses, master, norm = jax_run(job["cfg"], job["tree"],
                                       job["batches"], 2, 2, job["model"])
        assert norm > CLIP, norm      # clipping acts
        for r in range(4):
            got = res[r][j]
            assert close(got["losses"], losses), (j, r, got["losses"],
                                                  losses)
            assert close(got["grad_norm"], norm), (j, got["grad_norm"],
                                                   norm)
        for a, b in zip(assemble([res[r][j]["pieces"] for r in range(4)]),
                        jax_leaves(master, job["tree"])):
            assert close(a, b), j
    # vocab-parallel wte: half the rows a rank (stage 0, whole over
    # data); replicated wte where 127 rows do not divide (stage 3: its
    # data shard on d)
    assert res[0][0]["wte"] == (TINY["vocab_size"] // 2, TINY["d_model"])
    assert res[0][4]["wte"] == (ODD["vocab_size"], TINY["d_model"] // 2)
    one = dict(config(0, bf16=True),
               train_micro_batch_size_per_gpu=2 * MICRO)
    ref1, _, _ = jax_run(one, tree, blist[:1], 1)
    got = res[0][5]["losses"][0]
    assert abs(got - ref1[0]) <= 0.01 * max(1.0, abs(ref1[0])), (got, ref1)


def test_layout_independent_under_dropout(tmp_path):
    """Dropout 0.1 on the flash arm (the hidden dropouts drawn over the
    global micro-batch's rows, the attention's hash over global (batch,
    head) ids): dp 2 and tp 2 on 2 ranks train as one rank does — losses
    within fp32 1e-5 over 3 steps.  (The dense arm draws its attention
    mask from a generator over the rank's own rows and heads.)"""
    tree = jax_tree()
    blist = batches(2)
    one_cfg = dict(config(0), train_micro_batch_size_per_gpu=2 * MICRO)
    eng = port_engine(one_cfg, tree, dp=1, attn_impl="flash", dropout=0.1)
    ref = [float(eng.train_batch(b)) for b in blist]
    eng.close()
    job = {"tree": tree, "model": TINY, "attn": "flash", "dropout": 0.1,
           "batches": blist}
    jobs = [dict(job, cfg=config(2), dp=2, tp=1),
            dict(job, cfg=one_cfg, dp=1, tp=2)]
    res = spawn_ranks(_run_jobs, 2, tmp_path, jobs)
    for j in range(len(jobs)):
        for r in range(2):
            assert close(res[r][j]["losses"], ref), (j, r,
                                                     res[r][j]["losses"],
                                                     ref)
