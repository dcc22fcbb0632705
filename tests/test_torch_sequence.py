"""Port parity for sequence parallelism's operators
(``deepspeed_tpu_torch/parallel/sequence.py`` and the seq pairs of
``parallel/collectives.py``): ``ring_attention`` and ``ulysses_attention``
(its flash arm, which on CPU tensors runs the flash wrapper's plain
version, and its dense arm) on 2 and 4 gloo ranks (one process per seq
rank, ``test_torch_zero.spawn_ranks``, both jobs launched once by a
module fixture) against the JAX functions under ``shard_map`` on the
virtual CPU mesh, as ``tests/test_sequence_parallel.py`` runs them (the
Ulysses flash arm in Pallas interpret mode), on the same seeded numpy
q, k, v.

Tolerances: fp32 outputs and the q/k/v gradients of ``sum(out · w)``
within 1e-5 (absolute and relative), causal and not, dropout 0.1 from
the shared position hash included; bf16 outputs within 1e-2 (about two
bf16 ulps at these magnitudes).  The autograd pairs are held to a numpy
emulation of the layout exactly and to the adjoint identity
``Σ_r <A x, g> = Σ_r <x, Aᵀ g>`` within 1e-5 relative.
"""
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np
import pytest
import torch

from test_torch_zero import spawn_ranks, one_thread  # noqa: F401

B, H, T, D = 2, 4, 64, 16
SEED = 42
RATE = 0.1
TOL = 1e-5
BF16_TOL = 1e-2
#: (case name, impl, causal, dropout rate)
CASES = [(f"{impl}-{'causal' if causal else 'full'}-{rate}", impl, causal,
          rate)
         for impl in ("ring", "ulysses", "ulysses-dense")
         for causal, rate in ((True, 0.0), (False, 0.0), (True, RATE))]
SIZES = (2, 4)


def _inputs():
    rng = np.random.default_rng(0)
    q, k, v, w = (rng.standard_normal((B, H, T, D)).astype(np.float32)
                  for _ in range(4))
    return q, k, v, w


def _shard(x, s, n):
    per = x.shape[2] // n
    return x[:, :, s * per:(s + 1) * per]


def _port_fn(impl):
    from deepspeed_tpu_torch.parallel.sequence import (ring_attention,
                                                       ulysses_attention)
    if impl == "ring":
        return ring_attention
    if impl == "ulysses":
        return ulysses_attention
    return partial(ulysses_attention, local_impl="dense")


# ---------------------------------------------------------------------------
# the rank job: every case of one seq size, the guards and the pairs
# ---------------------------------------------------------------------------
def _ops_job(rank, world, arrays):
    from deepspeed_tpu_torch.models.gpt2 import (GPT2Config,
                                                 gpt2_attn_sublayer)
    from deepspeed_tpu_torch.parallel import build_mesh, collectives as col
    from deepspeed_tpu_torch.parallel.sequence import ulysses_attention
    mesh = build_mesh(sp=world)
    s = mesh.axis_index("seq")
    q, k, v, w = (torch.from_numpy(_shard(a, s, world)) for a in arrays)
    out = {}
    for name, impl, causal, rate in CASES:
        qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
        o = _port_fn(impl)(qq, kk, vv, mesh, causal=causal,
                           dropout_rate=rate,
                           dropout_seed=SEED if rate else None)
        (o * w).sum().backward()
        out[name] = [x.detach().numpy() for x in
                     (o, qq.grad, kk.grad, vv.grad)]
    for impl in ("ring", "ulysses"):
        o = _port_fn(impl)(q.bfloat16(), k.bfloat16(), v.bfloat16(), mesh)
        out[f"bf16-{impl}"] = (str(o.dtype), o.float().numpy())
    # the pairs: values and gradients, per rank
    g = torch.Generator().manual_seed(100 + rank)
    x = torch.randn(2, 4, 3, 5, generator=g)
    gy = torch.randn(2, 4 // world, 3 * world, 5, generator=g)
    pairs = {}
    xr = x.clone().requires_grad_(True)
    y = col.seq_all_to_all(xr, mesh, 1, 2)
    y.backward(gy)
    pairs["a2a"] = [t.detach().numpy() for t in (x, y, gy, xr.grad)]
    xr = x.clone().requires_grad_(True)
    gr = torch.randn(x.shape, generator=g)
    y = col.seq_ring_shift(xr, mesh)
    y.backward(gr)
    pairs["ring"] = [t.detach().numpy() for t in (x, y, gr, xr.grad)]
    out["pairs"] = pairs
    col.seq_stats.clear()
    _port_fn("ring")(q, k, v, mesh)
    out["ring_stats"] = dict(col.seq_stats)
    # the guards: Ulysses needs its heads to divide by the seq axis, and
    # on a tensor-parallel mesh its per-rank heads
    if world == 4:
        try:
            ulysses_attention(q[:, :2], k[:, :2], v[:, :2], mesh)
            out["divisible"] = None
        except ValueError as e:
            out["divisible"] = str(e)
        m22 = build_mesh(sp=2, tp=2)
        cfg = GPT2Config(vocab_size=64, n_positions=64, d_model=32,
                         n_layer=1, n_head=2, attn_impl="ulysses")
        d = cfg.d_model
        bp = {"ln1_scale": torch.ones(d), "ln1_bias": torch.zeros(d),
              "qkv_w": torch.zeros(d, 3, d // 2), "qkv_b": torch.zeros(3,
                                                                      d // 2),
              "out_w": torch.zeros(d // 2, d), "out_b": torch.zeros(d)}
        try:
            gpt2_attn_sublayer(cfg, bp, torch.zeros(1, 4, d), None, False,
                               m22)
            out["tp_sp"] = None
        except ValueError as e:
            out["tp_sp"] = str(e)
    return out


# ---------------------------------------------------------------------------
# the JAX references
# ---------------------------------------------------------------------------
def _jax_case(impl, causal, rate, n, arrays, dtype=None):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from deepspeed_tpu.parallel.sequence import (ring_attention,
                                                 ulysses_attention)
    fn = {"ring": ring_attention, "ulysses": ulysses_attention,
          "ulysses-dense": partial(ulysses_attention,
                                   local_impl="dense")}[impl]
    mesh = Mesh(np.array(jax.devices()[:n]), ("seq",))
    spec = P(None, None, "seq", None)
    seed = jnp.uint32(SEED) if rate else None
    sharded = jax.shard_map(
        lambda a, b, c: fn(a, b, c, "seq", causal=causal, dropout_rate=rate,
                           dropout_seed=seed),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
        check_vma=False)
    q, k, v, w = (jnp.asarray(a) for a in arrays)
    if dtype is not None:
        return np.asarray(jax.jit(sharded)(
            q.astype(dtype), k.astype(dtype), v.astype(dtype)
        ).astype(jnp.float32))

    def loss(q, k, v):
        o = sharded(q, k, v)
        return jnp.sum(o * w), o

    (_, o), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return [np.asarray(x) for x in (o, *grads)]


@pytest.fixture(scope="module")
def arrays():
    return _inputs()


@pytest.fixture(scope="module")
def ranks(arrays, tmp_path_factory):
    work = tmp_path_factory.mktemp("seq_ops")
    pool = ThreadPoolExecutor(len(SIZES))
    futs = {n: pool.submit(spawn_ranks, _ops_job, n, work, arrays)
            for n in SIZES}
    yield futs
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def jax_refs(arrays, ranks):
    import jax.numpy as jnp
    refs = {}
    for n in SIZES:
        for name, impl, causal, rate in CASES:
            refs[n, name] = _jax_case(impl, causal, rate, n, arrays)
        for impl in ("ring", "ulysses"):
            refs[n, f"bf16-{impl}"] = _jax_case(impl, True, 0.0, n, arrays,
                                                dtype=jnp.bfloat16)
    return refs


def _assemble(per_rank, i):
    return np.concatenate([r[i] for r in per_rank], axis=2)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_attention_matches_jax(case, n, ranks, jax_refs):
    """Forward and the q/k/v gradients of ring and Ulysses (flash and
    dense arms), causal and not, dropout 0.1 from the global position
    hash: every rank's shard equals the JAX function's within 1e-5."""
    name = case[0]
    per_rank = [r[name] for r in ranks[n].result()]
    ref = jax_refs[n, name]
    for i, what in enumerate(("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(_assemble(per_rank, i), ref[i],
                                   rtol=TOL, atol=TOL,
                                   err_msg=f"{name} sp{n} {what}")


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_bf16_io(impl, n, ranks, jax_refs):
    """bf16 q, k, v give a bf16 output (fp32 accumulation inside) within
    1e-2 of the JAX function's bf16 output."""
    per_rank = [r[f"bf16-{impl}"] for r in ranks[n].result()]
    assert all(d == "torch.bfloat16" for d, _ in per_rank)
    got = np.concatenate([o for _, o in per_rank], axis=2)
    np.testing.assert_allclose(got, jax_refs[n, f"bf16-{impl}"],
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("n", SIZES)
def test_autograd_pairs_are_their_transposes(n, ranks):
    """``seq_all_to_all`` and ``seq_ring_shift``: the values equal a numpy
    emulation of the tiled all-to-all and of the rotation, the backward
    equals the emulated transpose exactly, and ``Σ_r <A x, g> = Σ_r <x,
    Aᵀ g>``; ring attention at sp n makes n − 1 rotations."""
    per_rank = [r["pairs"] for r in ranks[n].result()]
    xs = [p["a2a"][0] for p in per_rank]
    gys = [p["a2a"][2] for p in per_rank]
    for r, p in enumerate(per_rank):
        want = np.concatenate([np.split(x, n, axis=1)[r] for x in xs],
                              axis=2)
        np.testing.assert_array_equal(p["a2a"][1], want)
        back = np.concatenate([np.split(g, n, axis=2)[r] for g in gys],
                              axis=1)
        np.testing.assert_array_equal(p["a2a"][3], back)
    for key in ("a2a", "ring"):
        lhs = sum(float((p[key][1].astype(np.float64) * p[key][2]).sum())
                  for p in per_rank)
        rhs = sum(float((p[key][0].astype(np.float64) * p[key][3]).sum())
                  for p in per_rank)
        assert abs(lhs - rhs) <= 1e-5 * max(1.0, abs(lhs)), (key, lhs, rhs)
    for r, p in enumerate(per_rank):
        x, y, g, xg = p["ring"]
        np.testing.assert_array_equal(y, per_rank[(r - 1) % n]["ring"][0])
        np.testing.assert_array_equal(xg, per_rank[(r + 1) % n]["ring"][2])
    for r in ranks[n].result():
        assert r["ring_stats"]["calls"] == n - 1
        assert r["ring_stats"]["bytes"] == (n - 1) * 2 * B * H * T // n * D * 4


def test_guards(ranks):
    """Ulysses needs its heads divisible by the seq axis (the JAX
    function's assertion, ``tests/test_sequence_parallel.py``), and on a
    tensor-parallel mesh each rank's H/tp heads divisible by sp: GPT-2's
    2 heads at tp 2 × sp 2 raise naming both numbers."""
    r = ranks[4].result()[0]
    assert r["divisible"] is not None and "divisible" in r["divisible"]
    assert r["tp_sp"] is not None and "2 heads" in r["tp_sp"] \
        and "tp·sp = 2·2" in r["tp_sp"]


def test_jax_divisibility_guard():
    """The JAX function refuses the same layout (its assertion)."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    from deepspeed_tpu.parallel.sequence import ulysses_attention
    q = np.zeros((1, 2, 8, 4), np.float32)
    spec = P(None, None, "seq", None)
    fn = jax.shard_map(lambda a, b, c: ulysses_attention(a, b, c, "seq"),
                       mesh=Mesh(np.array(jax.devices()[:4]), ("seq",)),
                       in_specs=(spec,) * 3, out_specs=spec, check_vma=False)
    with pytest.raises(AssertionError, match="divisible"):
        fn(q, q, q)


@pytest.mark.parametrize("impl", ["ring", "ulysses", "ulysses-dense"])
def test_sp1_fallback(impl, arrays):
    """On a mesh with one seq rank each function is the whole-sequence
    attention in one process: the JAX function's on a one-device mesh
    within 1e-5, dropout 0.1 included, no collective made."""
    from deepspeed_tpu_torch.parallel import collectives as col
    from deepspeed_tpu_torch.parallel.mesh import single_device_mesh
    q, k, v, w = (torch.from_numpy(a) for a in arrays)
    col.seq_stats.clear()
    o = _port_fn(impl)(q, k, v, single_device_mesh(), dropout_rate=RATE,
                       dropout_seed=SEED)
    assert not col.seq_stats
    ref = _jax_case(impl, True, RATE, 1, arrays)[0]
    np.testing.assert_allclose(o.numpy(), ref, rtol=TOL, atol=TOL)


def test_gpt2_sp1_fallback_is_the_hashed_dense_attention():
    """GPT-2 with ring or Ulysses attention on no seq axis is dense
    attention with the flash kernels' hash mask: at dropout 0.1 its loss
    and gradients equal the flash arm's (the same seed derivation), and
    at dropout 0 the JAX model's (ring on no seq axis) within 1e-5."""
    import jax
    from deepspeed_tpu.models.gpt2 import (GPT2Config as JConfig,
                                           GPT2Model as JModel)
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from deepspeed_tpu_torch.runtime.utils import params_from_numpy
    kw = dict(vocab_size=256, n_positions=64, d_model=64, n_layer=2,
              n_head=4, remat=None)
    tree = jax.tree.map(np.asarray, JModel(JConfig(**kw, attn_impl="dense"))
                        .init(jax.random.PRNGKey(0)))
    toks = np.random.default_rng(1).integers(0, 256, (2, 33)).astype(
        np.int32)
    # the JAX model's ring fallback on no seq axis: its dense attention
    jref = float(JModel(JConfig(**kw, attn_impl="ring")).loss_fn(
        tree, toks, jax.random.PRNGKey(0), train=False))
    losses, grads = {}, {}
    for impl in ("flash", "ring", "ulysses"):
        model = GPT2Model(GPT2Config(**kw, attn_impl=impl, dropout=RATE,
                                     embd_dropout=RATE))
        params = params_from_numpy(tree)
        for p in params["blocks"].values():
            p.requires_grad_(True)
        loss = model.loss_fn(params, torch.from_numpy(toks), 11, train=True)
        loss.backward()
        losses[impl] = loss.item()
        grads[impl] = params["blocks"]["qkv_w"].grad.numpy()
        eval_loss = float(model.loss_fn(params_from_numpy(tree),
                                        torch.from_numpy(toks), None,
                                        train=False))
        assert abs(eval_loss - jref) <= TOL * abs(jref), (impl, eval_loss,
                                                          jref)
    for impl in ("ring", "ulysses"):
        assert abs(losses[impl] - losses["flash"]) <= TOL * losses["flash"]
        np.testing.assert_allclose(grads[impl], grads["flash"], rtol=TOL,
                                   atol=TOL)
