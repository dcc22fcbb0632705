"""Port parity for ``deepspeed_tpu_torch.pipe.module`` and the pipelined
models (``models/gpt2_pipe.py``, ``models/bert_pipe.py``): partitions,
stack plans, tied keys and the packed tree's keys and shapes equal the
JAX ``PipelineModule``'s for GPT-2, BERT, heterogeneous and tied
modules at every partition method; the one-process forward and loss of
the port, on the JAX init tree carried across with
``pipe.module.carry_params``, equal JAX's at fp32 within 1e-5; and the
carry-over restacks pp 1 ↔ 2 ↔ 4 exactly (a JAX tree at one depth,
restacked, is the JAX init at the other).  One process, the CPU."""
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.pipe import LayerSpec, PipelineModule, TiedLayerSpec
from deepspeed_tpu_torch.pipe.module import carry_params, stack_stages

from test_torch_zero import one_thread  # noqa: F401

RTOL = 1e-5
GPT = dict(vocab_size=128, n_positions=16, d_model=32, n_layer=4, n_head=4)
BERT = dict(vocab_size=96, hidden_size=32, num_hidden_layers=4,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=16, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
DIM = 16


class TorchLinear:
    """The port's minimal pipeline layer (the JAX tests' ``Linear``)."""

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


def _jax_linear():
    import jax
    import jax.numpy as jnp

    class Linear:
        def __init__(self, din, dout):
            self.din, self.dout = din, dout

        def init(self, rng):
            return {"w": jax.random.normal(rng, (self.din, self.dout),
                                           jnp.float32) * 0.2,
                    "b": jnp.zeros((self.dout,), jnp.float32)}

        def apply(self, params, x, rng, train=True):
            return jax.nn.relu(x @ params["w"] + params["b"])
    return Linear


def _jax_mse(out, labels):
    import jax.numpy as jnp
    return jnp.mean((out - labels) ** 2)


def _linear_specs(dims, tied=()):
    """Both packages' layer specs over ``dims`` (tied positions share the
    key "emb")."""
    from deepspeed_tpu.pipe import LayerSpec as JL, TiedLayerSpec as JT
    JLin = _jax_linear()
    port, jax_ = [], []
    for i, (a, b) in enumerate(dims):
        if i in tied:
            port.append(TiedLayerSpec("emb", TorchLinear, a, b))
            jax_.append(JT("emb", JLin, a, b))
        else:
            port.append(LayerSpec(TorchLinear, a, b))
            jax_.append(JL(JLin, a, b))
    return port, jax_


def _modules(kind, stages, method=None):
    """(port module, JAX module) of ``kind`` at ``stages``."""
    from deepspeed_tpu.pipe import PipelineModule as JPM
    if kind == "gpt2":
        from deepspeed_tpu.models.gpt2 import GPT2Config as JC
        from deepspeed_tpu.models.gpt2_pipe import build_gpt2_pipe as jb
        from deepspeed_tpu_torch.models.gpt2 import GPT2Config
        from deepspeed_tpu_torch.models.gpt2_pipe import build_gpt2_pipe
        kw = {} if method is None else {"partition_method": method}
        return (build_gpt2_pipe(GPT2Config(**GPT, attn_impl="dense"), stages,
                                **kw),
                jb(JC(**GPT, remat=None, attn_impl="dense"), stages, **kw))
    if kind == "bert":
        from deepspeed_tpu.models.bert import BertConfig as JC
        from deepspeed_tpu.models.bert_pipe import build_bert_pipe as jb
        from deepspeed_tpu_torch.models.bert import BertConfig
        from deepspeed_tpu_torch.models.bert_pipe import build_bert_pipe
        kw = {} if method is None else {"partition_method": method}
        return (build_bert_pipe(BertConfig(**BERT, attn_impl="dense"), stages,
                                **kw),
                jb(JC(**BERT, remat=None), stages, **kw))
    dims = {"uniform": [(DIM, DIM)] * 8,
            "hetero": [(DIM, 48), (48, DIM), (DIM, 24), (24, DIM)],
            "tied": [(DIM, DIM)] * 4}[kind]
    tied = (0, 3) if kind == "tied" else ()
    port, jax_ = _linear_specs(dims, tied)
    method = method or "uniform"
    return (PipelineModule(port, stages, loss_fn=torch_mse,
                           partition_method=method),
            JPM(jax_, stages, loss_fn=_jax_mse, partition_method=method))


def _jax_tree(jpm, seed=0):
    import jax
    return jax.tree.map(np.asarray, jpm.init(jax.random.PRNGKey(seed)))


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_shapes(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tuple(tree.shape)}


CASES = [("gpt2", None), ("gpt2", "parameters"), ("gpt2", "uniform"),
         ("bert", None), ("bert", "parameters"), ("uniform", "uniform"),
         ("uniform", "parameters"), ("uniform", "type:linear"),
         ("hetero", "uniform"), ("tied", "uniform")]


@pytest.mark.parametrize("kind,method", CASES)
@pytest.mark.parametrize("stages", [1, 2, 4])
def test_plan_and_packed_tree_equal_jax(kind, method, stages):
    pm, jpm = _modules(kind, stages, method)
    assert pm.parts == jpm.parts
    assert pm.stack_plan() == jpm.stack_plan()
    assert pm.stack_index() == jpm.stack_index()
    assert pm.tied_keys() == jpm.tied_keys()
    for s in range(stages):
        assert pm.stage_layer_range(s) == jpm.stage_layer_range(s)
    assert pm.stage_remat == jpm.stage_remat
    tree = pm.init(0)
    jtree = _jax_tree(jpm)
    assert _shapes(tree) == _shapes(jtree)
    assert list(tree) == sorted(jtree)
    # a rank's tree: its stage's stack rows, every other leaf whole
    for s in range(stages):
        local = pm.init(0, stage=s)
        want = {k: (v[1:] if "/stack_" in k else v)
                for k, v in _shapes(jtree).items()}
        assert _shapes(local) == want
        for name, idxs in pm.stack_plan().items():
            np.testing.assert_array_equal(
                next(iter(local[name].values())).numpy(),
                next(iter(tree[name].values()))[s].numpy())


def test_heterogeneous_module_has_no_stack():
    pm, jpm = _modules("hetero", 2, "uniform")
    assert pm.stack_plan() == jpm.stack_plan() == {}
    assert stack_stages(pm.init(0)) is None


def test_count_from_shapes_builds_no_tensor(monkeypatch):
    """The "parameters" partitioner reads ``param_shapes``: it never
    initializes a layer, let alone the whole model."""
    from deepspeed_tpu_torch.models import gpt2_pipe
    calls = []
    for cls in (gpt2_pipe.GPT2EmbeddingPipe, gpt2_pipe.GPT2BlockPipe,
                gpt2_pipe.GPT2FinalNormPipe):
        monkeypatch.setattr(cls, "init",
                            lambda self, *a, **k: calls.append(1))
    pm, jpm = _modules("gpt2", 2, "parameters")
    assert pm.stack_plan() == jpm.stack_plan() and not calls


@pytest.mark.parametrize("src,dst", [(1, 2), (2, 4), (4, 1), (2, 1),
                                     (1, 4), (4, 2)])
@pytest.mark.parametrize("kind", ["gpt2", "bert", "uniform"])
def test_carry_restacks_between_depths(kind, src, dst):
    """A JAX init tree stacked for ``src`` stages, carried to ``dst``,
    is the JAX init at ``dst`` bit for bit (layer i draws from
    fold_in(rng, i) at every depth)."""
    _, jsrc = _modules(kind, src)
    pm, jdst = _modules(kind, dst)
    got = carry_params(_jax_tree(jsrc), pm)
    want = _jax_tree(jdst)
    assert _shapes(got) == _shapes(want)
    for a, b in zip(_leaves(got), _leaves(want)):
        np.testing.assert_array_equal(a, b)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree)]


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def _batch(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "gpt2":
        toks = rng.integers(0, GPT["vocab_size"], (3, 9))
        return toks[:, :-1], toks[:, 1:]
    if kind == "bert":
        ids = rng.integers(0, BERT["vocab_size"], (3, 12))
        labels = np.where(rng.random((3, 12)) < 0.3, ids, -100)
        return ids, labels
    x = rng.standard_normal((3, DIM)).astype(np.float32)
    return x, (0.5 * np.abs(x)).astype(np.float32)


@pytest.mark.parametrize("kind,stages", [
    ("gpt2", 1), ("gpt2", 2), ("bert", 1), ("uniform", 1), ("uniform", 2),
    ("tied", 2), ("hetero", 2)])
def test_forward_and_loss_equal_jax(kind, stages):
    """``PipelineModule.forward`` over the whole packed tree (the stacked
    leaves indexed per layer) and the loss head on it, from the JAX init
    tree: equal to JAX's at fp32 within 1e-5."""
    import jax
    import jax.numpy as jnp
    pm, jpm = _modules(kind, stages, None if kind in ("gpt2", "bert")
                       else "uniform")
    jtree = _jax_tree(jpm)
    x, labels = _batch(kind)
    jrng = jax.random.PRNGKey(0)
    jy = jpm.forward(jax.tree.map(jnp.asarray, jtree), jnp.asarray(x), jrng,
                     train=False)
    tree = _to_torch(carry_params(jtree, pm))
    y = pm.forward(tree, torch.tensor(x), 0, train=False)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=RTOL * np.abs(np.asarray(jy)).max())
    if kind in ("gpt2", "bert"):
        from deepspeed_tpu_torch.pipe.engine import _ReplicatedParamsView
        jl = jpm.loss_fn(jax.tree.map(jnp.asarray, jtree), jy,
                         jnp.asarray(labels))
        loss = pm.loss_fn(_ReplicatedParamsView(pm.replicated_view(tree)),
                          y, torch.tensor(labels))
    else:
        jl = jpm.loss_fn(jy, jnp.asarray(labels))
        loss = pm.loss_fn(y, torch.tensor(labels))
    assert abs(float(loss) - float(jl)) <= RTOL * abs(float(jl))


def test_loss_head_reading_a_stacked_param_raises():
    """A 3-ary loss head sees only the pipe-replicated params; a stacked
    key raises the JAX engine's explanation."""
    from deepspeed_tpu_torch.pipe.engine import _ReplicatedParamsView
    pm, _ = _modules("gpt2", 2)
    view = _ReplicatedParamsView(pm.replicated_view(pm.init(0)))
    assert sorted(view) == ["layer_5", "tied"]
    with pytest.raises(KeyError, match="stage-local"):
        view["stack_0"]


def test_stage_view_and_activation_checkpoint_interval():
    """``stage_view`` of a rank's tree reads each layer's row; a forward
    with ``activation_checkpoint_interval`` gives the plain forward's
    values and gradients."""
    port, _ = _linear_specs([(DIM, DIM)] * 6)
    pm = PipelineModule(port, 2, loss_fn=torch_mse,
                        partition_method="uniform",
                        activation_checkpoint_interval=2)
    assert not pm.stage_remat
    whole = pm.init(3)
    local = pm.init(3, stage=1)
    view = pm.stage_view(local, 1, local=True)
    gview = pm.stage_view(whole, 1)
    for i in range(3, 6):
        for k in ("w", "b"):
            torch.testing.assert_close(view[f"layer_{i}"][k],
                                       gview[f"layer_{i}"][k], rtol=0,
                                       atol=0)
    x = torch.randn(4, DIM, requires_grad=True)
    y = pm.forward_range(view, x, 0, 3, 6)
    y.sum().backward()
    g = x.grad.clone()
    x.grad = None
    pm.activation_checkpoint_interval = 0
    y0 = pm.forward_range(view, x, 0, 3, 6)
    y0.sum().backward()
    torch.testing.assert_close(y, y0, rtol=0, atol=0)
    torch.testing.assert_close(x.grad, g, rtol=0, atol=0)
