"""Port parity for 1-bit Adam's functions (``deepspeed_tpu_torch/compress``)
against the JAX package's ``deepspeed_tpu/compress/onebit.py`` on the
same numpy inputs.

  - pack / unpack bitwise, ``padded_size`` exactly;
  - ``_sign_compress`` and the simulated exchange at n = 64, 100 and
    1000, the padded tail's error included;
  - ``compressed_allreduce`` on 4 gloo ranks against JAX's ``shard_map``
    on 4 virtual devices and against a numpy version of the two-phase
    algorithm (copied from ``tests/test_onebit.py``, not imported), with
    its wire bytes and collective sizes;
  - ``onebit_adam`` across the freeze boundary with weight decay and an
    lr schedule: the simulated transform (warm, frozen and ``phase=None``)
    against the optax transform, and the collective one on 4 gloo ranks
    (``phase=None`` and the host-picked warm/frozen pair) against JAX's
    transform inside ``shard_map``.

Bars: fp32 values within 1e-6 relative to the reference's largest
magnitude (``close``), signs and packed bytes equal.  The 4-rank job is
launched once by a module fixture while the JAX references run in the
pytest process; the ranks import only torch and the port.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from test_torch_zero import spawn_ranks
from test_torch_zero import one_thread  # noqa: F401

WORLD = 4
SIZES = (64, 100, 1000)
RTOL = 1e-6
#: the optimizer runs: steps, freeze step, weight decay, the schedule
STEPS, FREEZE, WD = 6, 3, 0.01


def close(got, want, rtol=RTOL, floor=0.0):
    """Every element within ``rtol`` of the reference's largest magnitude
    (or of ``floor``, the magnitude of the values an error buffer is the
    residual of, where the residual itself is rounding-sized)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= rtol * max(np.abs(want).max(), floor, 1e-30), (err, rtol)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# numpy version of the two-phase algorithm (tests/test_onebit.py's oracle)
# ---------------------------------------------------------------------------
def np_padded_size(n, world):
    q = world * 8
    return ((n + q - 1) // q) * q


def np_sign_compress(buf, error):
    buf = buf + error
    scale = np.linalg.norm(buf) / np.sqrt(buf.size)
    sign = np.where(buf >= 0, 1.0, -1.0)
    return sign, scale, buf - scale * sign


def np_compressed_allreduce(locals_, worker_errors, server_errors):
    """locals_: [world, n].  Returns (out [n], new_we, new_se)."""
    world, n = locals_.shape
    Pn = np_padded_size(n, world)
    chunk = Pn // world
    signs = np.zeros((world, Pn))
    scales = np.zeros(world)
    new_we = np.zeros_like(worker_errors)
    for w in range(world):
        buf = np.pad(locals_[w], (0, Pn - n))
        s, sc, err = np_sign_compress(buf, worker_errors[w])
        signs[w], scales[w], new_we[w] = s, sc, err
    out = np.zeros(Pn)
    new_se = np.zeros_like(server_errors)
    for r in range(world):
        comp = np.mean(
            signs[:, r * chunk:(r + 1) * chunk] * scales[:, None], axis=0)
        s, sc, err = np_sign_compress(comp, server_errors[r])
        out[r * chunk:(r + 1) * chunk] = sc * s
        new_se[r] = err
    return out[:n], new_we, new_se


def exchange_inputs(n, seed=1):
    rng = np.random.default_rng(seed + n)
    Pn = np_padded_size(n, WORLD)
    return (rng.standard_normal((WORLD, n)).astype(np.float32),
            (rng.standard_normal((WORLD, Pn)) * 0.1).astype(np.float32),
            (rng.standard_normal((WORLD, Pn // WORLD)) * 0.1).astype(
                np.float32))


def grads_seq(shapes, steps=STEPS, seed=4):
    rng = np.random.default_rng(seed)
    return [[rng.standard_normal(s).astype(np.float32) for s in shapes]
            for _ in range(steps)]


SHAPES = ((4, 3), (3,), (5, 7))


def port_schedule(c):
    return 0.05 / torch.sqrt(c.float())


# ---------------------------------------------------------------------------
# the 4-rank job
# ---------------------------------------------------------------------------
def _ranks(rank, world, cases, targets):
    from deepspeed_tpu_torch.compress import (compressed_allreduce,
                                              init_onebit_state, onebit_adam)
    from deepspeed_tpu_torch.parallel import build_mesh
    from deepspeed_tpu_torch.parallel import collectives as col
    mesh = build_mesh(dp=world)
    d = mesh.axis_index("data")
    out = {"data_index": d}
    for n, (locals_, we, se) in cases.items():
        col.onebit_stats.clear()
        with col.recorded() as log:
            o, w2, s2 = compressed_allreduce(t(locals_[d]), t(we[d]),
                                             t(se[d]), mesh)
        out[n] = {"out": o.numpy(), "we": w2.numpy(), "se": s2.numpy(),
                  "stats": dict(col.onebit_stats), "log": list(log)}
    # the collective optimizer, local quadratic targets: phase None, and
    # the pair picked on the host by the step number
    n = targets.shape[1]
    for label in ("none", "pair"):
        txs = {ph: onebit_adam(lr=0.05, freeze_step=2, mesh=mesh, phase=ph)
               for ph in ((None,) if label == "none"
                          else ("warm", "frozen"))}
        x = torch.zeros(n)
        st = init_onebit_state([x], world)
        traj = []
        for step in range(6):
            tx = (txs[None] if label == "none"
                  else txs["warm" if step < 2 else "frozen"])
            g = 2 * (x - t(targets[d]))
            upd, st = tx.update([g], st, [x])
            x = x + upd[0]
            traj.append((x.numpy().copy(), st.mu[0].numpy().copy(),
                         st.worker_error[0].numpy().copy(),
                         st.server_error[0].numpy().copy()))
        out[label] = {"traj": traj, "count": int(st.count)}
    return out


@pytest.fixture(scope="module")
def cases():
    return {n: exchange_inputs(n) for n in SIZES}


@pytest.fixture(scope="module")
def targets():
    return np.random.default_rng(6).standard_normal((WORLD, 64)).astype(
        np.float32)


@pytest.fixture(scope="module")
def job(cases, targets, tmp_path_factory):
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(spawn_ranks, _ranks, WORLD,
                      tmp_path_factory.mktemp("onebit"), cases, targets)
    yield fut
    pool.shutdown(wait=True)


def _jax_mesh():
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:WORLD]), ("data",))


def _shard_map(fn, **kw):
    import jax
    return jax.jit(jax.shard_map(fn, mesh=_jax_mesh(), check_vma=False,
                                 **kw))


# ---------------------------------------------------------------------------
# pack / unpack / sizes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(256,), (3, 64), (2, 5, 8)])
def test_pack_unpack_bitwise_against_jax(shape):
    import jax.numpy as jnp
    from deepspeed_tpu.compress import pack_signs as jpack
    from deepspeed_tpu.compress import unpack_signs as junpack
    from deepspeed_tpu_torch.compress import pack_signs, unpack_signs
    bits = np.random.default_rng(len(shape)).random(shape) > 0.5
    packed = pack_signs(t(bits))
    want = np.asarray(jpack(jnp.asarray(bits)))
    assert packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed.numpy(), want)
    assert packed.numel() * 8 == bits.size          # 1/32 of fp32
    np.testing.assert_array_equal(unpack_signs(packed).numpy(),
                                  np.asarray(junpack(jnp.asarray(want))))
    np.testing.assert_array_equal(unpack_signs(packed).numpy(),
                                  np.where(bits, 1.0, -1.0))
    # big-endian: bit weight 128 first, as cupy.packbits
    first = pack_signs(torch.tensor([True] + [False] * 7))
    assert int(first) == 128


def test_padded_size_against_jax():
    from deepspeed_tpu.compress import padded_size as jps
    from deepspeed_tpu_torch.compress import padded_size
    for n in (1, 7, 8, 63, 64, 100, 1000, 124_439_808):
        for world in (1, 2, 3, 4, 8):
            assert padded_size(n, world) == jps(n, world)
            assert padded_size(n, world) % (8 * world) == 0


# ---------------------------------------------------------------------------
# compression and the simulated exchange
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", SIZES)
def test_sign_compress_and_simulated_exchange_against_jax(n):
    import jax.numpy as jnp
    from deepspeed_tpu.compress import onebit as jb
    from deepspeed_tpu_torch.compress import onebit as tb
    rng = np.random.default_rng(n)
    P = tb.padded_size(n, WORLD)
    x = rng.standard_normal(n).astype(np.float32)
    we = (rng.standard_normal(P) * 0.1).astype(np.float32)
    se = (rng.standard_normal(P) * 0.1).astype(np.float32)
    buf = np.pad(x, (0, P - n))
    sign, scale, err = tb._sign_compress(t(buf), t(we))
    jsign, jscale, jerr = jb._sign_compress(jnp.asarray(buf),
                                            jnp.asarray(we))
    np.testing.assert_array_equal(sign.numpy(), np.asarray(jsign))
    close(scale.numpy(), np.asarray(jscale))
    close(err.numpy(), np.asarray(jerr))
    out = tb.simulated_compressed_allreduce(t(x), t(we), t(se))
    want = jb.simulated_compressed_allreduce(jnp.asarray(x),
                                             jnp.asarray(we),
                                             jnp.asarray(se))
    for got, ref in zip(out, want):
        close(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(np.sign(out[0].numpy()),
                                  np.sign(np.asarray(want[0])))
    # with zero errors the padded tail (n 100 and 1000) compresses to +1
    # and keeps -scale as its error, carried to the next step
    z = tb.simulated_compressed_allreduce(t(x), torch.zeros(P),
                                          torch.zeros(P))
    jz = jb.simulated_compressed_allreduce(jnp.asarray(x), jnp.zeros(P),
                                           jnp.zeros(P))
    close(z[1].numpy(), np.asarray(jz[1]))
    s0 = np.linalg.norm(buf) / np.sqrt(P)
    if P > n:
        close(z[1].numpy()[n:], np.full(P - n, -s0, np.float32))
    # the server re-compresses ±scale: its residual is rounding-sized
    close(z[2].numpy(), np.asarray(jz[2]), floor=s0)


# ---------------------------------------------------------------------------
# the exchange on 4 gloo ranks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", SIZES)
def test_compressed_allreduce_on_gloo_ranks(n, cases, job):
    from deepspeed_tpu.compress import compressed_allreduce as jca
    from jax.sharding import PartitionSpec as P
    locals_, we, se = cases[n]
    fn = _shard_map(
        lambda x, w, s: jca(x[0], w[0], s[0], "data"),
        in_specs=(P("data"), P("data"), P("data")),
        out_specs=(P(), P("data"), P("data")))
    jout, jwe, jse = (np.asarray(a) for a in fn(locals_, we, se))
    ref_out, ref_we, ref_se = np_compressed_allreduce(
        locals_.astype(np.float64), we.astype(np.float64),
        se.astype(np.float64))
    Pn = np_padded_size(n, WORLD)
    chunk = Pn // WORLD
    for r in job.result():
        d = r["data_index"]
        got = r[n]
        close(got["out"], jout)
        close(got["out"], ref_out, rtol=2e-5)
        np.testing.assert_array_equal(np.sign(got["out"]), np.sign(jout))
        close(got["we"], jwe.reshape(WORLD, -1)[d])
        close(got["se"], jse.reshape(WORLD, -1)[d])
        close(got["we"], ref_we[d], rtol=2e-5)
        close(got["se"], ref_se[d], rtol=2e-5)
        # the wire: the packed all-to-all [world, chunk/8] and the
        # packed all-gather [chunk/8] in uint8, two one-float scales
        st = got["stats"]
        assert st["bytes_uint8"] == Pn // 8 + chunk // 8
        assert st["bytes_float32"] == 2 * 4
        assert st["calls"] == 4 and st["bytes"] == (
            st["bytes_uint8"] + st["bytes_float32"])
        floats = [e for op, dt, e in got["log"] if dt == "float32"]
        assert floats == [WORLD, WORLD], got["log"]
        u8 = sorted((op, e) for op, dt, e in got["log"] if dt == "uint8")
        assert u8 == [("all_gather", Pn // 8), ("all_to_all", Pn // 8)]


def _jax_collective_traj(targets):
    """tests/test_onebit.py's optimizer step inside shard_map, 4 workers:
    (params, mu, worker error row, server error row) per step and
    worker."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P
    from deepspeed_tpu.compress import (OnebitAdamState, init_onebit_state,
                                        onebit_adam)
    n = targets.shape[1]
    tx = onebit_adam(lr=0.05, freeze_step=2, data_axis="data")

    def one_step(params, state, tg):
        g = {"x": 2 * (params["x"] - tg[0])}
        sq = lambda tr: jax.tree.map(lambda a: a[0], tr)
        unsq = lambda tr: jax.tree.map(lambda a: a[None], tr)
        local = state._replace(worker_error=sq(state.worker_error),
                               server_error=sq(state.server_error))
        updates, st2 = tx.update(g, local, params)
        new = optax.apply_updates(params, updates)
        rows = jax.lax.all_gather(new["x"], "data")
        st2 = st2._replace(worker_error=unsq(st2.worker_error),
                           server_error=unsq(st2.server_error))
        return new, st2, rows

    spec = OnebitAdamState(count=P(), mu=P(), nu=P(),
                           worker_error=P("data"), server_error=P("data"))
    fn = _shard_map(one_step, in_specs=(P(), spec, P("data")),
                    out_specs=(P(), spec, P()))
    params = {"x": jnp.zeros(n)}
    st = init_onebit_state(params, WORLD)
    st = st._replace(
        worker_error={"x": jnp.tile(st.worker_error["x"], (WORLD, 1))},
        server_error={"x": jnp.tile(st.server_error["x"], (WORLD, 1))})
    traj = []
    for _ in range(6):
        params, st, rows = fn(params, st, targets)
        traj.append((np.asarray(rows), np.asarray(st.mu["x"]),
                     np.asarray(st.worker_error["x"]),
                     np.asarray(st.server_error["x"])))
    return traj, int(st.count)


def test_collective_optimizer_on_gloo_ranks(targets, job):
    """The optimizer with the exchange on 4 ranks, warm steps 1–2 (the
    gradient averaged over ``data``) and frozen 3–6: every rank's params,
    μ and error rows at every step within 1e-6 of JAX's transform inside
    ``shard_map`` — with ``phase=None`` and with the host-picked pair."""
    traj, count = _jax_collective_traj(targets)
    for r in job.result():
        d = r["data_index"]
        for label in ("none", "pair"):
            assert r[label]["count"] == count == 6
            for step, (got, want) in enumerate(zip(r[label]["traj"], traj)):
                x, mu, we, se = got
                close(x, want[0][d])
                close(mu, want[1])
                m = np.abs(want[1]).max()
                close(we, want[2][d], floor=m)
                close(se, want[3][d], floor=m)
                if step >= 2:
                    # frozen: the exchange's output is one buffer, so μ
                    # and the params agree across the workers
                    close(x, want[0][0])


# ---------------------------------------------------------------------------
# the simulated optimizer against the optax transform
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("phase", ["none", "pair"])
def test_onebit_adam_against_optax(phase):
    """``onebit_adam`` without a mesh, 6 steps over three leaves across
    ``freeze_step`` 3, weight decay 0.01 and lr ``0.05 / sqrt(count)``:
    the updates, μ, ν and both error buffers at every step within 1e-6
    of the optax transform (``phase=None``: the branch picked on the card
    from the count; ``pair``: warm then frozen fixed, as the engine's
    step pair), ν bitwise unchanged once frozen."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.compress import onebit_adam as jadam
    from deepspeed_tpu_torch.compress import onebit_adam
    jtx = jadam(lr=lambda c: 0.05 / jnp.sqrt(c.astype(jnp.float32)),
                weight_decay=WD, freeze_step=FREEZE)
    if phase == "none":
        txs = [onebit_adam(lr=port_schedule, weight_decay=WD,
                           freeze_step=FREEZE)] * STEPS
    else:
        warm, frozen = (onebit_adam(lr=port_schedule, weight_decay=WD,
                                    freeze_step=FREEZE, phase=p)
                        for p in ("warm", "frozen"))
        txs = [warm] * FREEZE + [frozen] * (STEPS - FREEZE)
    rng = np.random.default_rng(3)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    jp = {str(i): jnp.asarray(a) for i, a in enumerate(p0)}
    jst = jtx.init(jp)
    tp = [t(a.copy()) for a in p0]
    st = txs[0].init(tp)
    nu_frozen = None
    for step, g in enumerate(grads_seq(SHAPES)):
        jg = {str(i): jnp.asarray(a) for i, a in enumerate(g)}
        jupd, jst = jtx.update(jg, jst, jp)
        jp = jax.tree.map(lambda a, b: a + b, jp, jupd)
        upd, st = txs[step].update([t(a) for a in g], st, tp)
        tp = [a + u for a, u in zip(tp, upd)]
        assert int(st.count) == int(jst.count) == step + 1
        for i in range(len(SHAPES)):
            k = str(i)
            close(upd[i].numpy(), np.asarray(jupd[k]))
            close(tp[i].numpy(), np.asarray(jp[k]))
            close(st.mu[i].numpy(), np.asarray(jst.mu[k]))
            close(st.nu[i].numpy(), np.asarray(jst.nu[k]))
            # the residuals of compressing μ: rounding-sized on the
            # server, which re-compresses ±scale
            m = np.abs(np.asarray(jst.mu[k])).max()
            close(st.worker_error[i].numpy(),
                  np.asarray(jst.worker_error[k]), floor=m)
            close(st.server_error[i].numpy(),
                  np.asarray(jst.server_error[k]), floor=m)
        if step + 1 == FREEZE:
            nu_frozen = [v.clone() for v in st.nu]
        elif step + 1 > FREEZE:
            for a, b in zip(st.nu, nu_frozen):
                assert torch.equal(a, b)
            assert max(float(e.abs().max()) for e in st.worker_error) > 0
        else:
            assert all(float(e.abs().max()) == 0 for e in st.worker_error)


def test_phase_is_checked():
    from deepspeed_tpu_torch.compress import onebit_adam
    with pytest.raises(ValueError, match="phase must be"):
        onebit_adam(phase="cold")
    tx = onebit_adam()
    with pytest.raises(ValueError, match="requires params"):
        tx.update([torch.zeros(3)], tx.init([torch.zeros(3)]))
