"""Port parity for the MoE layer on a ``seq`` axis: ``moe_ffn`` on gloo
ranks that each hold a token shard of every row (sp 2, sp 4, and dp 2 ×
sp 2 with the experts over ``data``) against the JAX package's
``moe_ffn`` on the whole ``x`` — the same weights (the JAX init carried
across) and inputs (numpy, seeded), fp32.

Each rank's loss is ``sum(y²)`` over its own tokens plus the aux; the
JAX loss is ``sum(y²) / dp + aux``, the mean over the data ranks that
the training engine takes.  So the rank's y and aux equal the JAX
layer's on its rows and tokens, its ``dx / dp`` equals the JAX ``dx``
there, the router's gradient summed over every rank and divided by dp
equals the JAX one, and an expert's summed over ``seq`` (over every rank
where the experts are replicated) and divided by dp equals the JAX
expert's: all within 1e-5 (rtol and atol).

The drops are exact: the capacity is the whole row's, and a token's
position in its expert's queue counts the lower seq ranks' tokens (and,
for a second choice, every first choice of the row).  Each case
compares the (token, choice) pairs kept against the JAX layer's, read
from both layers' ``_choice_positions``.  The ``part`` cases route most
tokens of every shard to one expert at a capacity factor that drops:
there the rule that routes each shard alone keeps another set, and the
test asserts that too.  A routing choice may differ from JAX's only
where the router's top-2 (or second and third) probability gap is under
1e-6; each such flip is printed with its gap, and any other fails.

The router jitter's uniform draw is the port's own (a ``torch``
generator over the global rows and the whole sequence); in the jitter
cases the JAX layer's ``jax.random.uniform`` is replaced by that draw,
so both layers route the same noisy input.
"""
import contextlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from test_torch_zero import spawn_ranks
from test_torch_zero import one_thread  # noqa: F401

LAYER = dict(n_experts=4, d_model=16, d_ff=32, capacity_factor=0.5,
             eval_capacity_factor=0.75, aux_loss_weight=1.0,
             z_loss_weight=1e-3)
G, S, E = 2, 16, 4
RNG = 7                  # the port's host seed of the layer's jitter
JITTER = 0.1
RTOL = ATOL = 1e-5
NEAR_TIE = 1e-6

#: (top_k, dispatch, train, jitter, part)
CASES = {f"top{k}_{impl}_{'train' if train else 'eval'}": (k, impl, train,
                                                          0.0, False)
         for k in (1, 2) for impl in ("einsum", "scatter")
         for train in (True, False)}
CASES.update({f"top2_{impl}_jitter": (2, impl, True, JITTER, False)
              for impl in ("einsum", "scatter")})
CASES.update({f"part_top{k}_{impl}": (k, impl, True, 0.0, True)
              for k in (1, 2) for impl in ("einsum", "scatter")})

#: name → (world, build_mesh kwargs)
MESHES = {"sp2": (2, dict(sp=2)), "sp4": (4, dict(sp=4)),
          "dp2_sp2": (4, dict(dp=2, sp=2))}


def _inputs():
    """The JAX init of one layer, x [G, S, d], and the ``part`` inputs: the
    router's expert-0 column and every token pushed along one direction,
    so most tokens of every shard pick expert 0."""
    import jax
    from deepspeed_tpu.moe import MoEConfig, init_moe_params
    mp = jax.tree.map(np.asarray, init_moe_params(
        jax.random.PRNGKey(0), MoEConfig(**LAYER)))
    mp = {k: np.array(v) for k, v in mp.items()}
    rng = np.random.default_rng(1)
    x = rng.standard_normal((G, S, LAYER["d_model"])).astype(np.float32)
    u = np.full(LAYER["d_model"], LAYER["d_model"] ** -0.5, np.float32)
    mp_part = dict(mp, wg=mp["wg"].copy())
    mp_part["wg"][:, 0] += 0.5 * u
    x_part = (x + 2.0 * u).astype(np.float32)
    return {"plain": (x, mp), "part": (x_part, mp_part)}


def _layer_cfg(cls, case):
    k, impl, _train, jitter, _part = CASES[case]
    return cls(top_k=k, dispatch_impl=impl, router_jitter=jitter, **LAYER)


@contextlib.contextmanager
def _spy(module, name, log):
    """Record ``module.name``'s results in ``log`` while inside."""
    real = getattr(module, name)

    def spy(*a, **k):
        out = real(*a, **k)
        log.append(out)
        return out
    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, real)


def _kept(positions, C):
    """Per choice, each token's kept flag [G, S] from the queue positions
    [G, S, E] the layer computed."""
    return np.stack([((np.asarray(p) >= 0) & (np.asarray(p) < C)).any(-1)
                     for p in positions])


# ---------------------------------------------------------------------------
# the rank side
# ---------------------------------------------------------------------------
def _rank_case(mesh, case, x, mp):
    import torch
    from deepspeed_tpu_torch.moe import layer
    cfg = _layer_cfg(layer.MoEConfig, case)
    train = CASES[case][2]
    dp, sp = mesh.axis_size("data"), mesh.axis_size("seq")
    d, s = mesh.axis_index("data"), mesh.axis_index("seq")
    g, t = G // dp, S // sp
    ep = layer._expert_parallel(mesh, E)
    n = E // dp if ep else E
    e0 = d * n if ep else 0
    tp = {k: torch.tensor(v if k == "wg" else v[e0:e0 + n],
                          requires_grad=True) for k, v in mp.items()}
    tx = torch.tensor(x[d * g:(d + 1) * g, s * t:(s + 1) * t],
                      requires_grad=True)
    positions, routes = [], []
    with _spy(layer, "_choice_positions", positions), \
            _spy(layer, "_route", routes):
        y, aux = layer.moe_ffn(cfg, tp, tx, RNG, train, mesh)
    (y.square().sum() + aux).backward()
    C = cfg.capacity(S, train)
    return {"y": y.detach().numpy(), "aux": float(aux),
            "dx": tx.grad.numpy(), "ep": ep,
            "grads": {k: v.grad.numpy() for k, v in tp.items()},
            "kept": _kept([p.detach() for p in positions], C),
            "idx": np.stack([i.numpy() for i, _g, _m in routes[0]])}


def _job(rank, world, names, inputs):
    from deepspeed_tpu_torch.parallel import build_mesh
    from deepspeed_tpu_torch.parallel import collectives as col
    out = {}
    for name in names:
        mesh = build_mesh(**MESHES[name][1])
        out[name] = {"data": mesh.axis_index("data"),
                     "seq": mesh.axis_index("seq")}
        for case in CASES:
            x, mp = inputs["part" if CASES[case][4] else "plain"]
            col.seq_stats.clear()
            out[name][case] = _rank_case(mesh, case, x, mp)
            out[name][case]["seq_stats"] = dict(col.seq_stats)
    return out


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _port_jitter(eps):
    """The JAX layer's jitter draw replaced by the port's: the same
    multiplier on the same (row, token, feature)."""
    if eps == 0.0:
        yield
        return
    import jax
    import jax.numpy as jnp
    import torch
    from deepspeed_tpu_torch.runtime.utils import fold_in, seeded_generator
    u = torch.rand((G, S, LAYER["d_model"]),
                   generator=seeded_generator(fold_in(RNG, 11), "cpu"))
    mult = ((1.0 - eps) + (2.0 * eps) * u).numpy()
    real = jax.random.uniform

    def port_draw(key, shape, dtype=None, minval=0.0, maxval=1.0):
        assert tuple(shape) == mult.shape and (minval, maxval) == (
            1.0 - eps, 1.0 + eps), (shape, minval, maxval)
        return jnp.asarray(mult)
    jax.random.uniform = port_draw
    try:
        yield
    finally:
        jax.random.uniform = real


def _jax_case(case, x, mp):
    import jax
    import jax.numpy as jnp
    import deepspeed_tpu.moe.layer as jl
    cfg = _layer_cfg(jl.MoEConfig, case)
    train = CASES[case][2]
    key = jax.random.PRNGKey(3)
    with _port_jitter(cfg.router_jitter):
        positions, routes = [], []
        with _spy(jl, "_choice_positions", positions), \
                _spy(jl, "_route", routes):
            y, aux = jl.moe_ffn(cfg, mp, jnp.asarray(x), key, train)
        probs = _probs(cfg, mp, x)

        def parts(p, xin):
            yy, a = jl.moe_ffn(cfg, p, xin, key, train)
            return jnp.sum(yy ** 2), a
        (sq, a), vjp = jax.vjp(parts, mp, jnp.asarray(x))
        g_sq = vjp((jnp.ones(()), jnp.zeros(())))
        g_aux = vjp((jnp.zeros(()), jnp.ones(())))
    C = cfg.capacity(S, train)
    return {"y": np.asarray(y), "aux": float(aux),
            "g_sq": jax.tree.map(np.asarray, g_sq),
            "g_aux": jax.tree.map(np.asarray, g_aux),
            "kept": _kept(positions, C),
            "idx": np.stack([np.asarray(i) for i, _g, _m in routes[0]]),
            "probs": probs, "C": C}


def _probs(cfg, mp, x):
    """The router's probabilities of the JAX layer's routing input (the
    jittered one inside :func:`_port_jitter`), for the near-tie gaps."""
    import jax
    import jax.numpy as jnp
    xg = jnp.asarray(x, jnp.float32)
    if cfg.router_jitter > 0:
        xg = xg * jax.random.uniform(jax.random.PRNGKey(0), xg.shape,
                                     jnp.float32, 1.0 - cfg.router_jitter,
                                     1.0 + cfg.router_jitter)
    return np.asarray(jax.nn.softmax(xg @ mp["wg"], axis=-1))


def _local_rule_kept(ref, sp, top_k):
    """The drops a layer that routed each seq shard alone would make:
    its own capacity and positions from its own tokens."""
    cap = int(np.ceil(top_k * LAYER["capacity_factor"] * (S // sp) / E))
    cap = max(1, min(S // sp, cap))
    kept = np.zeros_like(ref["kept"])
    t = S // sp
    for s in range(sp):
        idx = ref["idx"][:, :, s * t:(s + 1) * t]          # [k, G, t]
        behind = np.zeros((G, E))
        for k in range(top_k):
            onehot = np.eye(E)[idx[k]]                      # [G, t, E]
            pos = (np.cumsum(onehot, 1) + behind[:, None]) * onehot - 1
            kept[k, :, s * t:(s + 1) * t] = ((pos >= 0) & (pos < cap)).any(-1)
            behind = behind + onehot.sum(1)
    return kept


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def launched(inputs, tmp_path_factory):
    work = tmp_path_factory.mktemp("moe_seq")
    pool = ThreadPoolExecutor(2)
    futs = {2: pool.submit(spawn_ranks, _job, 2, work, ["sp2"], inputs),
            4: pool.submit(spawn_ranks, _job, 4, work, ["sp4", "dp2_sp2"],
                           inputs)}
    yield futs
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def refs(inputs, launched):
    return {case: _jax_case(case, *inputs["part" if CASES[case][4]
                                          else "plain"])
            for case in CASES}


@pytest.fixture(scope="module")
def ranks(launched, refs):
    out = {}
    for fut in launched.values():
        for per_rank in fut.result():
            for name, r in per_rank.items():
                out.setdefault(name, []).append(r)
    return out


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_moe_ffn_on_seq_shards_matches_jax(mesh, case, ranks, refs):
    """y, aux, dx and every parameter gradient within 1e-5 of the JAX
    layer on the whole ``x``; the kept (token, choice) pairs exactly
    JAX's; routing flips only on near-ties."""
    ref = refs[case]
    per = ranks[mesh]
    dp = MESHES[mesh][1].get("dp", 1)
    sp = MESHES[mesh][1]["sp"]
    g, t = G // dp, S // sp
    y = np.full((G, S, LAYER["d_model"]), np.nan, np.float32)
    dx = np.full_like(y, np.nan)
    kept = np.zeros_like(ref["kept"])
    idx = np.zeros_like(ref["idx"])
    grads = {k: np.zeros_like(v) for k, v in ref["g_sq"][0].items()}
    for r in per:
        d, s = r["data"], r["seq"]
        c = r[case]
        rows, toks = slice(d * g, (d + 1) * g), slice(s * t, (s + 1) * t)
        y[rows, toks] = c["y"]
        dx[rows, toks] = c["dx"] / dp
        kept[:, rows, toks] = c["kept"]
        idx[:, rows, toks] = c["idx"]
        assert abs(c["aux"] - ref["aux"]) <= ATOL + RTOL * abs(ref["aux"]), (
            c["aux"], ref["aux"])
        for k, v in c["grads"].items():
            if k == "wg" or not c["ep"]:
                grads[k] += v / dp
            else:
                n = E // dp
                grads[k][d * n:(d + 1) * n] += v / dp
        # one gather of the routing counts a layer call, none backward
        assert c["seq_stats"]["calls"] == 1, c["seq_stats"]
    flips = np.argwhere(idx != ref["idx"])
    for k, gi, si in flips:
        p = np.sort(ref["probs"][gi, si])[::-1]
        gap = p[k] - p[k + 1]
        print(f"routing flip: {mesh} {case} choice {k} row {gi} token {si} "
              f"gap {gap:.3g}")
        assert gap < NEAR_TIE, (mesh, case, k, gi, si, gap)
    np.testing.assert_array_equal(kept, ref["kept"])
    dropped = int((~ref["kept"]).sum())
    print(f"{mesh} {case}: C {ref['C']}, dropped (token, choice) pairs "
          f"{dropped} of {ref['kept'].size}, flips {len(flips)}")
    _close(y, ref["y"])
    _close(dx, ref["g_sq"][1] / dp + ref["g_aux"][1])
    for k in grads:
        _close(grads[k], ref["g_sq"][0][k] / dp + ref["g_aux"][0][k])


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][4]])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_local_and_global_rules_part(mesh, case, refs):
    """In the ``part`` cases the JAX layer drops tokens, and a layer that
    routed each seq shard alone (its own capacity and positions) would
    keep another set — so the exact drop-set match above tells the
    global rule from the local one."""
    ref = refs[case]
    sp = MESHES[mesh][1]["sp"]
    dropped = int((~ref["kept"]).sum())
    local = _local_rule_kept(ref, sp, CASES[case][0])
    print(f"{mesh} {case}: global rule drops {dropped}, the local rule "
          f"{int((~local).sum())}, differing on "
          f"{int((local != ref['kept']).sum())} pairs")
    assert dropped > 0
    assert (local != ref["kept"]).any()
    # most tokens of every shard chose expert 0
    t = S // sp
    for s in range(sp):
        assert (ref["idx"][0, :, s * t:(s + 1) * t] == 0).mean() > 0.5
