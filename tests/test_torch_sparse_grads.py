"""Port parity for CSR embedding gradients (``sparse_gradients: true``):
``deepspeed_tpu_torch/runtime/csr_tensor.py`` against the JAX package's
``runtime/csr_tensor.py`` on the same numpy inputs, and the engine's CSR
step on 8 gloo ranks against the JAX engine's on the virtual CPU mesh
(``tests/test_sparse_grads_engine.py``'s cases, ``tests/test_aux.py``'s
CSR cases).

  - ``CSRTensor`` round trips, duplicate sums and ``from_dense``'s row
    budget, ``sparse_embedding_grad`` and ``csr_allgather`` (on the 8
    ranks) equal to JAX's;
  - ``BigEmbeddingModel`` (embedding → mean-pool → head) at dp 8, fp32,
    5 steps: the sparse engine's losses and master within 1e-5 of the
    port's dense engine's and of the JAX sparse engine's;
  - the wire: no collective as large as a quarter of the dense table,
    the indices and values bytes worked out from the tokens;
  - the dense fallbacks (no hook, ZeRO 2, dp 1), the unknown-key
    ``ValueError``, and the meshes the port refuses (tensor parallelism,
    experts, a seq axis).

The rank job is launched by a module fixture while the JAX references
run in the pytest process; the ranks import only torch and the port.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.runtime.module import TrainModule
from test_torch_zero import spawn_ranks
from test_torch_zero import one_thread  # noqa: F401

VOCAB, DIM, SEQ = 4096, 16, 8
DP, MICRO, GA, STEPS = 8, 2, 2, 5
RTOL = 1e-5


class BigEmbeddingModel(TrainModule):
    """``tests/test_sparse_grads_engine.py``'s model in torch: the
    embedding's gradient touches only the batch's token rows."""

    def init(self, seed, device=None):
        raise NotImplementedError("the tests pass the JAX init tree")

    def loss_fn(self, params, batch, rng, train=True):
        tokens, target = batch
        h = params["emb"].float()[tokens.long()].mean(dim=1)
        out = h @ params["head_w"].float()
        return torch.mean((out - target.float()) ** 2)

    def sparse_grad_tokens(self, batch):
        tokens, _ = batch
        return {"['emb']": tokens}


class WrongKeyModel(BigEmbeddingModel):
    def sparse_grad_tokens(self, batch):
        return {"['embedding']": batch[0]}


class NoHookModel(BigEmbeddingModel):
    sparse_grad_tokens = TrainModule.sparse_grad_tokens


def conf(sparse=True, stage=0, micro=MICRO, precision=None):
    cfg = {"train_micro_batch_size_per_gpu": micro,
           "gradient_accumulation_steps": GA,
           "steps_per_print": 10 ** 9,
           "sparse_gradients": sparse,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
           "zero_optimization": {"stage": stage}}
    if precision:
        cfg[precision] = {"enabled": True}
    return cfg


def batch(seed, rows=DP * MICRO * GA):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, VOCAB, (rows, SEQ), dtype=np.int32),
            rng.normal(size=(rows, DIM)).astype(np.float32))


def port_engine(cfg, tree, mesh=None, dp=DP, model=None):
    import deepspeed_tpu_torch as dst
    eng, *_ = dst.initialize(model=model or BigEmbeddingModel(),
                             config=cfg, params=tree, mesh=mesh,
                             device="cpu")
    return eng


def master_of(eng):
    return {k: v.detach().numpy().copy()
            for k, v in eng.state.master_params.items()}


# ---------------------------------------------------------------------------
# the 8-rank job
# ---------------------------------------------------------------------------
def _job8(rank, world, tree, blist, gather_in, moe_tree):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import GPT2MoEConfig, GPT2MoEModel
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from deepspeed_tpu_torch.parallel import build_mesh
    from deepspeed_tpu_torch.parallel import collectives as col
    from deepspeed_tpu_torch.runtime.csr_tensor import (CSRTensor,
                                                        csr_allgather)
    from deepspeed_tpu_torch.runtime.dataloader import rank_rows
    mesh = build_mesh(dp=world)
    d = mesh.axis_index("data")
    out = {"data_index": d}
    idx, vals = gather_in
    local = CSRTensor(torch.from_numpy(idx[d]), torch.from_numpy(vals[d]),
                      (16, 4))
    out["gathered"] = csr_allgather(local, mesh).to_dense().numpy()
    for label, sparse in (("sparse", True), ("dense", False)):
        eng = port_engine(conf(sparse), tree, mesh)
        out[f"{label}_path"] = eng._sparse_path
        losses, logs, stats = [], [], []
        for b in blist:
            col.csr_stats.clear()
            with col.recorded() as log:
                losses.append(float(eng.train_batch(rank_rows(b, GA, world,
                                                              d))))
            logs.append(list(log))
            stats.append(dict(col.csr_stats))
        out[label] = {"losses": losses, "master": master_of(eng),
                      "logs": logs, "stats": stats,
                      "eval": float(eng.eval_batch(
                          tuple(x[:MICRO] for x in rank_rows(
                              blist[0], GA, world, d))))}
        eng.close()
    # the fallbacks to the dense step
    eng = port_engine(conf(), tree, mesh, model=NoHookModel())
    out["no_hook"] = eng._sparse_path
    eng.close()
    eng = port_engine(conf(stage=2, precision="bf16"), tree, mesh)
    out["zero2"] = (eng._sparse_path, float(eng.train_batch(
        rank_rows(blist[0], GA, world, d))))
    eng.close()
    eng = port_engine(conf(), tree, mesh, model=WrongKeyModel())
    try:
        eng.train_batch(rank_rows(blist[0], GA, world, d))
        out["wrong_key"] = None
    except ValueError as e:
        out["wrong_key"] = str(e)
    eng.close()

    def refused(build):
        try:
            build().close()
        except NotImplementedError as e:
            return str(e)
        return None

    class HookGPT2(GPT2Model):
        def sparse_grad_tokens(self, b):
            return {"['wte']": b[..., :-1]}

    class HookMoE(GPT2MoEModel):
        def sparse_grad_tokens(self, b):
            return {"['wte']": b[..., :-1]}

    tiny = dict(vocab_size=128, n_positions=16, d_model=32, n_layer=2,
                n_head=4, remat=None, attn_impl="dense")
    cfg = conf(micro=1)
    out["tp"] = refused(lambda: dst.initialize(
        model=HookGPT2(GPT2Config(**tiny)), config=cfg,
        mesh=build_mesh(dp=4, tp=2), device="cpu")[0])
    out["seq"] = refused(lambda: dst.initialize(
        model=HookGPT2(GPT2Config(**{**tiny, "attn_impl": "ring"})),
        config=cfg, mesh=build_mesh(dp=4, sp=2), device="cpu")[0])
    out["moe"] = refused(lambda: dst.initialize(
        model=HookMoE(GPT2MoEConfig(**tiny, n_experts=4)), config=cfg,
        params=moe_tree, mesh=build_mesh(dp=world), device="cpu")[0])
    return out


@pytest.fixture(scope="module")
def tree():
    import jax
    from test_sparse_grads_engine import BigEmbeddingModel as JaxModel
    return jax.tree.map(np.asarray, JaxModel().init(jax.random.PRNGKey(5)))


@pytest.fixture(scope="module")
def gather_in():
    rng = np.random.default_rng(1)
    return (rng.integers(0, 16, (8, 2)).astype(np.int32),
            rng.standard_normal((8, 2, 4)).astype(np.float32))


@pytest.fixture(scope="module")
def job(tree, gather_in, tmp_path_factory):
    import jax
    from deepspeed_tpu.models.gpt2_moe import GPT2MoEConfig, GPT2MoEModel
    tiny = dict(vocab_size=128, n_positions=16, d_model=32, n_layer=2,
                n_head=4, remat=None, attn_impl="dense")
    moe_tree = jax.tree.map(np.asarray, GPT2MoEModel(GPT2MoEConfig(
        **tiny, n_experts=4)).init(jax.random.PRNGKey(0)))
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(spawn_ranks, _job8, DP,
                      tmp_path_factory.mktemp("sparse_grads"), tree,
                      [batch(i) for i in range(STEPS)], gather_in,
                      moe_tree)
    yield fut
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def ranks(job):
    return job.result()


@pytest.fixture(scope="module")
def jax_sparse(tree, job):
    """The JAX sparse engine at dp 8, fp32, on the same tree: losses and
    master after 5 steps."""
    import jax
    from deepspeed_tpu.config import DeepSpeedConfig
    from deepspeed_tpu.parallel import build_mesh
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine
    from test_sparse_grads_engine import BigEmbeddingModel as JaxModel
    eng = DeepSpeedEngine(JaxModel(), DeepSpeedConfig(conf(), world_size=DP),
                          mesh=build_mesh(dp=DP, devices=jax.devices()),
                          params=tree)
    assert eng._use_sparse_grads()
    losses = [float(np.asarray(eng.train_batch(batch(i))))
              for i in range(STEPS)]
    return losses, jax.tree.map(np.asarray, dict(eng.state.master_params))


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------------
# the CSR container against JAX's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("max_nnz", [None, 2, 4, 12])
def test_from_dense_round_trip_against_jax(max_nnz):
    import jax.numpy as jnp
    from deepspeed_tpu.runtime.csr_tensor import CSRTensor as JaxCSR
    from deepspeed_tpu_torch.runtime.csr_tensor import CSRTensor
    dense = np.zeros((10, 4), np.float32)
    dense[2] = 1.5
    dense[7] = -2.0
    dense[5, 3] = 0.25
    csr = CSRTensor.from_dense(torch.from_numpy(dense), max_nnz=max_nnz)
    ref = JaxCSR.from_dense(jnp.asarray(dense), max_nnz=max_nnz)
    np.testing.assert_array_equal(csr.indices.numpy(),
                                  np.asarray(ref.indices))
    np.testing.assert_array_equal(csr.values.numpy(), np.asarray(ref.values))
    np.testing.assert_array_equal(csr.to_dense().numpy(),
                                  np.asarray(ref.to_dense()))
    assert csr.nnz == ref.nnz and csr.sparse_size() == ref.sparse_size()
    assert csr.indices.dtype == torch.int32
    if max_nnz is None or max_nnz >= 3:
        np.testing.assert_array_equal(csr.to_dense().numpy(), dense)
    assert repr(csr) == repr(ref)


def test_duplicate_indices_sum_against_jax():
    import jax.numpy as jnp
    from deepspeed_tpu.runtime.csr_tensor import CSRTensor as JaxCSR
    from deepspeed_tpu_torch.runtime.csr_tensor import CSRTensor
    idx, vals = [1, 1, 3], [[1.0], [2.0], [4.0]]
    got = CSRTensor(torch.tensor(idx), torch.tensor(vals), (5, 1)).to_dense()
    want = JaxCSR(jnp.asarray(idx), jnp.asarray(vals), (5, 1)).to_dense()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[1, 0] == 3.0 and got[3, 0] == 4.0


def test_sparse_embedding_grad_against_jax():
    """``tests/test_aux.py``'s case: one entry per token (6), duplicated
    tokens carrying row / k so the densified gradient is the dense one;
    indices and values equal to JAX's."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.runtime.csr_tensor import \
        sparse_embedding_grad as jax_seg
    from deepspeed_tpu_torch.runtime.csr_tensor import sparse_embedding_grad
    V, D = 50, 8
    tokens = np.asarray([[1, 4, 4], [9, 1, 30]], np.int32)
    emb = np.random.default_rng(0).standard_normal((V, D)).astype(
        np.float32)
    dense = np.asarray(jax.grad(lambda tb: jnp.sum(tb[tokens] ** 2))(
        jnp.asarray(emb)))
    csr = sparse_embedding_grad(torch.from_numpy(dense),
                                torch.from_numpy(tokens))
    ref = jax_seg(jnp.asarray(dense), jnp.asarray(tokens))
    assert csr.nnz == ref.nnz == 6
    np.testing.assert_array_equal(csr.indices.numpy(),
                                  np.asarray(ref.indices))
    assert close(csr.values.numpy(), np.asarray(ref.values), 1e-6)
    assert close(csr.to_dense().numpy(), dense, 1e-6)
    # the port's own autograd gives the same dense gradient
    tb = torch.from_numpy(emb).requires_grad_()
    (tb[torch.from_numpy(tokens).long()] ** 2).sum().backward()
    assert close(tb.grad.numpy(), dense, 1e-6)


def test_csr_allgather_on_gloo_ranks(ranks, gather_in):
    idx, vals = gather_in
    ref = np.zeros((16, 4), np.float32)
    for s in range(8):
        for j in range(2):
            ref[idx[s, j]] += vals[s, j]
    for r in ranks:
        assert close(r["gathered"], ref, 1e-6)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def test_sparse_engine_equals_dense_and_jax(ranks, jax_sparse):
    """fp32, dp 8, 5 steps: every rank's sparse losses within 1e-5 of the
    dense engine's and of the JAX sparse engine's, the masters too; the
    eval loss sane."""
    jl, jm = jax_sparse
    for r in ranks:
        assert r["sparse_path"] and not r["dense_path"]
        s, dn = r["sparse"], r["dense"]
        assert s["losses"] == pytest.approx(dn["losses"], rel=RTOL)
        assert s["losses"] == pytest.approx(jl, rel=RTOL)
        for k in jm:
            assert close(s["master"][k], dn["master"][k]), k
            assert close(s["master"][k], jm[k]), k
        assert s["losses"][-1] < s["eval"] * 5


def test_wire_is_indices_and_values(ranks):
    """No collective of the sparse step reaches a quarter of the dense
    table (``tests/test_sparse_grads_engine.py:82``'s bar); the dense
    step's gradient all-reduce is the whole table.  The CSR gather moves
    the rank's token ids (int32) and their rows (fp32), counted from the
    tokens."""
    tokens = GA * MICRO * SEQ
    for r in ranks:
        for log, st in zip(r["sparse"]["logs"], r["sparse"]["stats"]):
            assert max(e for _, _, e in log) < VOCAB * DIM // 4, log
            assert st["calls"] == 2
            assert st["bytes_int32"] == tokens * 4
            assert st["bytes_float32"] == tokens * DIM * 4
            gathers = sorted(e for op, _, e in log if op == "all_gather")
            assert gathers == [DP * tokens, DP * tokens * DIM]
        for log in r["dense"]["logs"]:
            assert max(e for _, _, e in log) == VOCAB * DIM
        assert r["dense"]["stats"] == [{}] * STEPS


def test_dense_fallbacks_and_unknown_key(ranks, tree):
    """The JAX engine's fallbacks to the dense step: a model without the
    hook, ZeRO 2 (trains), and one rank; a declared key missing from the
    tree raises its ``ValueError``."""
    import deepspeed_tpu_torch as dst
    for r in ranks:
        assert r["no_hook"] is False
        path, loss = r["zero2"]
        assert path is False and np.isfinite(loss)
        assert r["wrong_key"] is not None
        # the JAX engine's message: the unknown and the valid keystrs
        assert r["wrong_key"] == (
            f"sparse_grad_tokens declares params {["['embedding']"]} "
            f"that do not exist in the gradient tree; valid keystrs: "
            f"{["['emb']", "['head_w']"]}")
    eng, *_ = dst.initialize(model=BigEmbeddingModel(), params=tree,
                             config=conf(micro=DP * MICRO), device="cpu")
    assert eng._sparse_path is False
    assert np.isfinite(float(eng.train_batch(batch(0))))
    eng.close()


def test_refused_meshes(ranks):
    """The JAX engine runs CSR gradients over tensor-parallel pieces and
    over experts on ``data``; the port refuses both with
    NotImplementedError naming item 11 (ROADMAP lists them).  A seq axis
    in the CSR step raises the JAX engine's NotImplementedError."""
    for r in ranks:
        for key in ("tp", "moe"):
            assert r[key] is not None and "ROADMAP.md" in r[key] \
                and "item 11" in r[key], (key, r[key])
        assert "not the 1-bit or sparse-gradient engines" in r["seq"]
