"""Port parity for ZeRO-Offload's XLA tier (``offload_impl: "xla"``,
``runtime/offload_xla.py``: the rank's rows of the fp32 master and the
moments in pinned host pieces, the update on the device), against the
JAX engine's XLA tier (``tests/test_offload_xla.py``) on the same numpy
weights and batches, and item 6's offload checkpoint cases
(``tests/test_checkpointing.py``).

Tolerances (Adam at eps 1e-3, as ``tests/test_torch_zero.py``; fp32
configs built at stage 0 with the ZeRO and offload knobs set after, the
practice of ``tests/test_torch_zero.py``): losses and the final master
within fp32 1e-5 relative of the JAX XLA tier (fused, grad chunks 2,
split update, delayed update); inside the port the tier equals the plain
engine bit for bit at fp32 (every arm, ZeRO-2 and 3), chunks and the
split update equal the fused update bit for bit, and save → load →
continue repeats the losses bit for bit; checkpoints cross tiers and
packages within fp32 1e-5 on the continued losses; dryrun legs 5 and 11
(``__graft_entry__.py``) on 4 gloo ranks: the bf16 first-step loss within
1 % of one device's, and the fp32 run within 1e-5 of the JAX engine's
4-device run (losses and the assembled master).
"""
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.parallel import collectives as col
from deepspeed_tpu_torch.runtime import offload_xla as ox

# the gloo ranks import this module: it keeps jax (and the helpers that
# import it) out of module level
from test_torch_zero import assemble, close, jax_leaves, spawn_ranks

HIDDEN = 16
GPT2 = dict(vocab_size=128, n_positions=16, d_model=32, n_layer=2,
            n_head=4)
XLA = {"cpu_offload": True, "offload_impl": "xla"}
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny models: one intra-op thread runs them as fast and keeps
    parallel test workers (and the spawned gloo ranks) from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(precision="fp32", micro=2, ga=2, clip=1.0, wd=0.0, stage=2,
           lr=1e-2, **zero):
    cfg = {"train_micro_batch_size_per_gpu": micro,
           "gradient_accumulation_steps": ga, "steps_per_print": 10 ** 9,
           "gradient_clipping": clip,
           "optimizer": {"type": "Adam",
                         "params": {"lr": lr, "eps": 1e-3,
                                    "weight_decay": wd}},
           "zero_optimization": {"stage": stage, **zero}}
    if precision == "bf16":
        cfg["bf16"] = {"enabled": True}
    elif precision == "fp16":
        cfg["fp16"] = {"enabled": True, "initial_scale_power": 8,
                       "hysteresis": 1, "loss_scale_window": 1000}
    return cfg


def built(config_cls, cfg, world=1):
    """Both packages refuse ZeRO (and so offload) at fp32: an fp32 config
    is built at stage 0 and its ZeRO block set after."""
    if "bf16" in cfg or "fp16" in cfg:
        return config_cls(cfg, world_size=world)
    out = config_cls({**cfg, "zero_optimization": {"stage": 0}},
                     world_size=world)
    for k, v in cfg["zero_optimization"].items():
        setattr(out.zero_config, k, v)
    return out


def port_model(family, stream=False, nlayers=2):
    if family == "simple":
        from test_torch_checkpointing import SimpleModel
        return SimpleModel(nlayers=nlayers)
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    return GPT2Model(GPT2Config(**GPT2, remat="block", attn_impl="dense",
                                stream_scan=stream))


def jax_model(family, stream=False, nlayers=2):
    if family == "simple":
        from simple_model import SimpleModel as JaxSimple
        return JaxSimple(hidden_dim=HIDDEN, nlayers=nlayers)
    from deepspeed_tpu.models.gpt2 import GPT2Config, GPT2Model
    return GPT2Model(GPT2Config(**GPT2, remat="block", attn_impl="dense",
                                stream_scan=stream))


def tree(family, seed=0, nlayers=2):
    import jax
    return jax.tree.map(np.asarray, jax_model(family, nlayers=nlayers).init(
        jax.random.PRNGKey(seed)))


def batches(family, rows, steps=STEPS, seed=11):
    if family == "simple":
        from simple_model import random_batches
        return list(random_batches(rows, HIDDEN, num_batches=steps,
                                   seed=seed))
    rng = np.random.default_rng(seed)
    return [rng.integers(0, GPT2["vocab_size"], (rows, 9), np.int32)
            for _ in range(steps)]


def port(family, cfg, params, mesh=None, world=1, stream=False, nlayers=2,
         seed=3):
    from deepspeed_tpu_torch.config import DeepSpeedConfig
    eng, *_ = dst.initialize(model=port_model(family, stream, nlayers),
                             params=params, mesh=mesh, device="cpu",
                             config=built(DeepSpeedConfig, cfg, world),
                             seed=seed)
    return eng


def jax_engine(family, cfg, params, dp=1, stream=False, nlayers=2):
    import jax
    from deepspeed_tpu.config import DeepSpeedConfig
    from deepspeed_tpu.parallel import build_mesh
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine
    return DeepSpeedEngine(jax_model(family, stream, nlayers),
                           built(DeepSpeedConfig, cfg, dp), params=params,
                           seed=3,
                           mesh=build_mesh(dp=dp,
                                           devices=jax.devices()[:dp]))


def run(eng, bs):
    return [float(np.asarray(eng.train_batch(b))) for b in bs]


def port_master(eng):
    """The port's master leaves (its placement; whole at one rank)."""
    if eng._offload_xla:
        return [x.numpy() for x in eng._xla_canonical()[0]]
    from deepspeed_tpu_torch.runtime.utils import tree_leaves
    return [x.detach().cpu().numpy()
            for x in tree_leaves(eng.state.master_params)]


def jax_master(jeng, order):
    """The JAX engine's master in the port's leaf order."""
    if getattr(jeng, "_offload_xla", False):
        m = jeng._unflatten_numpy(jeng.state.master_params)
    else:
        m = jeng.state.master_params
    return jax_leaves(m, order)


def masters_close(a, b, rtol=1e-5):
    return all(close(x, y, rtol) for x, y in zip(a, b))


def bitwise(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# against the JAX XLA tier
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family,arm", [
    ("simple", "fused"), ("gpt2", "fused"), ("gpt2", "chunks"),
    ("gpt2", "split"), ("gpt2", "dpu")])
def test_xla_tier_matches_jax_xla_tier(family, arm):
    """fp32, 3 steps: every loss and the final master within 1e-5 of the
    JAX engine's XLA tier (the delayed update compared after a flush)."""
    zero = dict(XLA, **{"fused": {}, "chunks": {"offload_grad_chunks": 2},
                        "split": {"offload_split_update": True},
                        "dpu": {"delayed_param_update": True}}[arm])
    cfg = config(wd=0.01, **zero)
    params = tree(family)
    p, j = port(family, cfg, params), jax_engine(family, cfg, params)
    assert p._offload_xla and j._offload_xla
    bs = batches(family, int(p.train_batch_size))
    got, want = run(p, bs), run(j, bs)
    assert close(got, want), (got, want)
    p._xla_dpu_flush()
    j._xla_dpu_flush()
    assert masters_close(port_master(p), jax_master(j, params))
    p.close()
    j.close()


@pytest.mark.parametrize("arm", ["fused", "chunks2", "chunks3", "split",
                                 "stage3", "adam_l2"])
def test_xla_tier_equals_plain_engine_bitwise(arm):
    """At fp32 the pinned pieces, the device ring's math and the packing
    change where the state lives, not its bytes: losses and master bit
    for bit the plain stage-2 engine's (grad chunks and the split update
    included; Adam with L2 decay folded into the grad)."""
    extra = {"chunks2": {"offload_grad_chunks": 2},
             "chunks3": {"offload_grad_chunks": 3},
             "split": {"offload_split_update": True},
             "stage3": {"stage": 3},
             "adam_l2": {}}.get(arm, {})
    stage = extra.pop("stage", 2)
    wd = 0.1
    params = tree("gpt2")
    plain_cfg = config(wd=wd, stage=stage)
    xla_cfg = config(wd=wd, stage=stage, **XLA, **extra)
    if arm == "adam_l2":
        for c in (plain_cfg, xla_cfg):
            c["optimizer"]["params"]["adam_w_mode"] = False
    plain, xla = port("gpt2", plain_cfg, params), port("gpt2", xla_cfg,
                                                       params)
    bs = batches("gpt2", int(plain.train_batch_size))
    assert run(xla, bs) == run(plain, bs)
    assert bitwise(port_master(xla), port_master(plain))
    if arm.startswith("chunks"):
        assert len(xla._xla_groups) == int(arm[-1])
    plain.close()
    xla.close()


def test_flat_layout_matches_jax_and_packs_collective_free():
    """The partition-major records equal the JAX engine's
    ``_flat_leaf_layout`` for the same (shape, data dim, dp); pack/unpack
    is an exact inverse in torch and numpy; a rank's row is its data
    shard, and packing and unpacking it call no collective."""
    from deepspeed_tpu.runtime.engine import _flat_leaf_layout
    from jax.sharding import PartitionSpec as P
    cases = [((8, 6), 0), ((6, 8), 1), ((5, 3), None), ((7,), None),
             ((4, 3, 8), 2), ((2, 64, 32), 1)]
    before = dict(col.calls)
    for dp in (1, 4):
        for shape, dd in cases:
            size = int(np.prod(shape))
            spec = [None] * len(shape)
            if dd is not None:
                spec[dd] = "data"
            want = _flat_leaf_layout(shape, size, P(*spec), dp)
            rec = ox.flat_leaf_layout(shape, dd, dp)
            assert tuple(rec) == tuple(want), (shape, dd, dp)
            x = np.arange(size, dtype=np.float32).reshape(shape)
            pc = ox.pack_leaf(x, rec, dp)
            assert pc.shape == (dp, rec.w)
            np.testing.assert_array_equal(ox.unpack_leaf(pc, rec), x)
            t = torch.from_numpy(x)
            assert torch.equal(ox.unpack_leaf(ox.pack_leaf(t, rec, dp), rec),
                               t)
            for r in range(dp):
                if rec.data_dim is not None:
                    n = shape[rec.data_dim] // dp
                    shard = t.narrow(rec.data_dim, r * n, n)
                    row = ox.pack_row(shard, rec, dp, r)
                    assert torch.equal(ox.unpack_row(row, rec, dp), shard)
                else:
                    row = ox.pack_row(t, rec, dp, r)
                np.testing.assert_array_equal(row.numpy(), pc[r])
    assert dict(col.calls) == before


def test_engine_pieces_roundtrip_and_padding():
    """The engine's pieces are one (1, w) row per leaf at one rank; the
    numpy pair inverts the layout exactly."""
    eng = port("simple", config(**XLA), tree("simple"))
    pieces = tuple(eng._xla_gather_rows(eng._xla.master, i).numpy()
                   for i in range(len(eng._flat_layout)))
    assert len(pieces) == len(eng._flat_layout)
    for p, rec, row in zip(pieces, eng._flat_layout,
                           eng.state.master_params):
        assert p.shape == (1, rec.w) == tuple(row.shape)
        assert row.is_pinned() or not torch.cuda.is_available()
    again = eng._flatten_numpy(eng._unflatten_numpy(pieces))
    assert bitwise(again, pieces)
    eng.close()


def test_grad_group_partition_matches_jax():
    """The greedy size-balanced groups equal the JAX engine's for the same
    leaves; every leaf once, the heaviest group within 2x of the ideal."""
    params = tree("simple", nlayers=6)
    cfg = config(**XLA)
    j = jax_engine("simple", cfg, params, nlayers=6)
    p = port("simple", cfg, params, nlayers=6)
    # the port orders leaves by the tree's dict order, the JAX engine by
    # sorted keys
    names_p = list(params)
    for k in (2, 3, 5):
        groups = ox.grad_group_indices(p._flat_sizes, k)
        flat = sorted(i for g in groups for i in g)
        assert flat == list(range(len(p._flat_sizes)))
        loads = [sum(p._flat_sizes[i] for i in g) for g in groups]
        ideal = sum(p._flat_sizes) / len(groups)
        assert max(loads) <= 2 * ideal + max(p._flat_sizes)
        jg = j._grad_group_indices(k)
        jnames = sorted(params)   # jax.tree's flatten order
        assert sorted(sorted(jnames[i] for i in g) for g in jg) == sorted(
            sorted(names_p[i] for i in g) for g in groups)
    p.close()
    j.close()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_checkpoint_crosses_packages_xla_tier(direction, tmp_path):
    """XLA-tier checkpoints (the canonical tree) cross between the two
    packages' XLA tiers: continued losses within fp32 1e-5."""
    params = tree("gpt2")
    cfg = config(**XLA)
    bs = batches("gpt2", 4, steps=4)
    if direction == "port_to_jax":
        src, dst_eng = port("gpt2", cfg, params), jax_engine(
            "gpt2", cfg, tree("gpt2", 1))
    else:
        src, dst_eng = jax_engine("gpt2", cfg, params), port(
            "gpt2", cfg, tree("gpt2", 1))
    run(src, bs[:2])
    src.save_checkpoint(str(tmp_path))
    ref = run(src, bs[2:])
    dst_eng.load_checkpoint(str(tmp_path))
    assert close(run(dst_eng, bs[2:]), ref), direction
    src.close()
    dst_eng.close()


def test_checkpoint_roundtrip_module_only_and_plain(tmp_path):
    """Inside the port: save → load → continue bitwise (the delayed
    update flushed by the save), into a plain engine bitwise at fp32; a
    module-only load keeps the weights with fresh moments."""
    params = tree("gpt2")
    cfg = config(**XLA, delayed_param_update=True)
    a = port("gpt2", cfg, params)
    bs = batches("gpt2", 4, steps=4)
    run(a, bs[:2])
    a.save_checkpoint(str(tmp_path), tag="t")
    assert a._xla_dpu_pending is None
    ref = run(a, bs[2:])
    b = port("gpt2", cfg, tree("gpt2", 1))
    b.load_checkpoint(str(tmp_path), tag="t")
    assert run(b, bs[2:]) == ref
    plain_cfg = config()
    c = port("gpt2", plain_cfg, tree("gpt2", 1))
    c.load_checkpoint(str(tmp_path), tag="t")
    d = port("gpt2", config(**XLA), tree("gpt2", 1))
    d.load_checkpoint(str(tmp_path), tag="t")
    assert run(c, bs[2:]) == run(d, bs[2:])
    e = port("gpt2", config(**XLA), tree("gpt2", 1))
    e.load_checkpoint(str(tmp_path), tag="t", load_module_only=True)
    assert int(e._xla.count) == 0
    assert all(float(m.abs().sum()) == 0 for m in e._xla.mu)
    loss = run(e, bs[2:3])[0]
    assert np.isfinite(loss)
    for x in (a, b, c, d, e):
        x.close()


def _item6_engine(impl, seed, tmp_path=None, name="d"):
    zero = {"stage": 2}
    cfg = config("bf16", lr=1e-2)
    if impl:
        zero.update({"cpu_offload": True,
                     "offload_impl": "host" if impl == "disk" else impl})
    cfg["zero_optimization"] = zero
    if impl == "disk":
        cfg["offload"] = {"tier": "disk", "disk_dir": str(tmp_path / name)}
    from deepspeed_tpu_torch.config import DeepSpeedConfig
    eng, *_ = dst.initialize(model=port_model("simple"), device="cpu",
                             seed=seed,
                             config=DeepSpeedConfig(cfg, world_size=1))
    return eng


def test_cross_tier_offload_restore(tmp_path):
    """``tests/test_checkpointing.py::test_cross_tier_offload_restore``:
    the one canonical ``FusedAdamState`` lets checkpoints cross between
    the XLA, host and disk tiers and the plain engine (continued loss
    within 2e-4, the reference's bar)."""
    batch = batches("simple", 4, steps=1, seed=0)[0]
    pairs = (("xla", "host"), ("host", "xla"), (None, "host"),
             ("host", None), ("xla", "disk"), ("disk", "xla"))
    for k, (src, dst_impl) in enumerate(pairs):
        e1 = _item6_engine(src, 3, tmp_path, f"s{k}")
        for _ in range(3):
            e1.train_batch(batch)
        d = str(tmp_path / f"{src}-{dst_impl}")
        e1.save_checkpoint(d, tag="t")
        ref = float(e1.train_batch(batch))
        e2 = _item6_engine(dst_impl, 9, tmp_path, f"d{k}")
        path, _ = e2.load_checkpoint(d, tag="t")
        assert path is not None, (src, dst_impl)
        got = float(e2.train_batch(batch))
        assert abs(got - ref) < 2e-4, (src, dst_impl, got, ref)
        e1.close()
        e2.close()


def test_dpu_dispatch_counter_restores_from_global_steps(tmp_path):
    """``tests/test_checkpointing.py::test_dpu_dispatch_counter_restores_
    from_global_steps``: the delayed update's seed counter continues from
    ``global_steps`` (every dispatch), not the applied count."""
    cfg = config("bf16", **XLA, delayed_param_update=True)
    params = tree("simple")
    eng = port("simple", cfg, params)
    bs = batches("simple", 4, steps=5)
    run(eng, bs[:3])
    assert eng._xla_dpu_dispatch == 3
    eng.save_checkpoint(str(tmp_path), tag="t")
    applied = int(eng._xla.count)
    eng2 = port("simple", cfg, tree("simple", 1))
    eng2.load_checkpoint(str(tmp_path), tag="t")
    assert eng2._xla_dpu_dispatch == 3 >= applied
    run(eng2, bs[3:])
    assert eng2._xla_dpu_dispatch == 5
    eng.close()
    eng2.close()


# ---------------------------------------------------------------------------
# the delayed update, the split update and the poison
# ---------------------------------------------------------------------------
def test_xla_dpu_staleness_flush_and_overflow():
    """Steps 0 and 1 run on the initial master (equal losses on a fixed
    batch); the first loss equals the fused tier's; with fp16 one
    overflow costs exactly one skip and one halving."""
    params = tree("simple")
    x, y = batches("simple", 4, steps=1)[0]
    ed = port("simple", config("bf16", micro=4, ga=1, **XLA,
                               delayed_param_update=True), params)
    en = port("simple", config("bf16", micro=4, ga=1, **XLA), params)
    l0, l1 = run(ed, [(x, y)] * 2)
    n0, n1 = run(en, [(x, y)] * 2)
    assert l0 == l1 == n0 and n1 != n0
    ed._xla_dpu_flush()
    assert ed._xla_dpu_pending is None
    ef = port("simple", config("fp16", micro=4, ga=1, **XLA,
                               delayed_param_update=True), params)
    bad_x = x.copy()
    bad_x[0, 0] = np.float32(3e38)
    run(ef, [(bad_x, y), (x, y), (x, y)])
    ef._xla_dpu_flush()
    assert ef.get_skipped_steps() == 1
    assert float(ef.state.scaler.loss_scale) == 2 ** 7
    assert int(ef._xla.count) == 2
    for e in (ed, en, ef):
        e.close()


def test_split_update_overflow_skips_whole_step():
    eng = port("simple", config("fp16", **XLA, offload_split_update=True),
               tree("simple"))
    before = port_master(eng)
    x, y = batches("simple", 4, steps=1)[0]
    eng.train_batch((np.full_like(x, 1e30), y))
    assert bitwise(port_master(eng), before)
    assert eng.get_skipped_steps() == 1 and int(eng._xla.count) == 0
    eng.close()


@pytest.mark.parametrize("exc", [KeyboardInterrupt, RuntimeError])
def test_split_update_failure_poisons_until_load(exc, tmp_path,
                                                 monkeypatch):
    """A failure part-way through the split update's piece loop (Ctrl-C
    keeps its type) poisons the engine: train, eval, forward and save
    refuse with the recovery message until ``load_checkpoint``."""
    eng = port("simple", config("bf16", **XLA, offload_split_update=True),
               tree("simple"))
    bs = batches("simple", 4, steps=3)
    eng.train_batch(bs[0])
    eng.save_checkpoint(str(tmp_path), tag="ok")
    calls = []
    real = ox.PinnedPieces.piece_math

    def failing(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise exc("interrupted mid piece loop")
        return real(*a, **k)

    monkeypatch.setattr(eng._xla, "piece_math", failing)
    with pytest.raises(exc):
        eng.train_batch(bs[1])
    monkeypatch.undo()
    assert "1/4 piece updates" in eng._fatal_state_error
    for call in (lambda: eng.train_batch(bs[1]),
                 lambda: eng.eval_batch(bs[1]), lambda: eng.forward(bs[1]),
                 lambda: eng.save_checkpoint(str(tmp_path), tag="no")):
        with pytest.raises(RuntimeError, match="load_checkpoint"):
            call()
    eng.load_checkpoint(str(tmp_path), tag="ok")
    assert eng._fatal_state_error is None
    assert np.isfinite(run(eng, bs[1:2])[0])
    eng.close()


def test_fused_update_failure_leaves_state_whole(monkeypatch):
    """The fused update writes a second set of pieces and swaps it in at
    the end: a failure part-way leaves the master and the moments as
    they were, and the engine trains on."""
    eng = port("simple", config("bf16", **XLA), tree("simple"))
    bs = batches("simple", 4, steps=3)
    eng.train_batch(bs[0])
    before = [t.clone() for t in eng._xla.master + eng._xla.mu]
    real = ox.PinnedPieces.piece_math
    calls = []

    def failing(*a, **k):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("device lost")
        return real(*a, **k)

    monkeypatch.setattr(eng._xla, "piece_math", failing)
    with pytest.raises(RuntimeError, match="device lost"):
        eng.train_batch(bs[1])
    monkeypatch.undo()
    assert eng._fatal_state_error is None
    assert all(torch.equal(a, b) for a, b in zip(
        before, eng._xla.master + eng._xla.mu))
    assert np.isfinite(run(eng, bs[1:])).all()
    eng.close()


def test_split_update_env_knob(monkeypatch, caplog):
    """``DS_OFFLOAD_SPLIT_UPDATE=1`` fails as loudly as the flag on the host
    tier, is ignored with a warning by an engine without offload, and
    turns the split update on for an XLA-tier engine."""
    import logging
    from deepspeed_tpu_torch.utils.logging import logger
    monkeypatch.setenv("DS_OFFLOAD_SPLIT_UPDATE", "1")
    with pytest.raises(ValueError, match="xla-tier"):
        port("simple", config("bf16", cpu_offload=True,
                              offload_impl="host"), tree("simple"))
    monkeypatch.setattr(logger, "propagate", True)
    with caplog.at_level(logging.WARNING):
        plain = port("simple", config("bf16"), tree("simple"))
    assert any("DS_OFFLOAD_SPLIT_UPDATE=1 ignored" in r.message
               for r in caplog.records)
    off = port("simple", config("bf16", **XLA), tree("simple"))
    assert off._xla_split
    for e in (plain, off):
        e.close()


# ---------------------------------------------------------------------------
# dryrun legs 5 and 11 on 4 gloo ranks (and the dp resize)
# ---------------------------------------------------------------------------
DRY = dict(vocab_size=256, n_positions=64, d_model=64, n_layer=2,
           n_head=4)


def dry_tree(seed=0, **over):
    import jax
    from deepspeed_tpu.models.gpt2 import GPT2Config, GPT2Model
    m = GPT2Model(GPT2Config(**{**DRY, **over}, remat="block",
                             attn_impl="dense"))
    return jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(seed)))


def dry_tokens(seed, rows):
    return np.random.default_rng(seed).integers(0, DRY["vocab_size"],
                                                (rows, 33), np.int32)


def dry_cfg(precision, **zero):
    cfg = config(precision, micro=1, ga=2, lr=1e-3, **zero)
    cfg["gradient_clipping"] = 1.0
    return cfg


def dry_port(cfg, params, world, stream=False):
    from deepspeed_tpu_torch.config import DeepSpeedConfig
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from deepspeed_tpu_torch.parallel import build_mesh
    m = GPT2Model(GPT2Config(**DRY, remat="block", attn_impl="dense",
                             stream_scan=stream))
    eng, *_ = dst.initialize(model=m, params=params, device="cpu",
                             config=built(DeepSpeedConfig, cfg, world),
                             mesh=build_mesh() if world > 1 else None)
    return eng


def one_device_loss(params, tokens):
    """The dryrun's reference: one device, stage 0, bf16, micro 1 and the
    whole batch as accumulation steps."""
    cfg = {"train_micro_batch_size_per_gpu": 1,
           "gradient_accumulation_steps": int(tokens.shape[0]),
           "steps_per_print": 10 ** 9, "bf16": {"enabled": True},
           "zero_optimization": {"stage": 0},
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
    return float(dry_port(cfg, params, 1).train_batch(tokens))


def dry_leg(rank, world, params, zero, steps, stream=False, extra=None,
            save_dir=None):
    """One dryrun leg on this rank: the bf16 first-step loss, then the
    fp32 run's losses and master pieces (and ``extra``'s checks; a save
    into ``save_dir``)."""
    from deepspeed_tpu_torch.runtime.dataloader import rank_rows
    from test_torch_zero import gathered_pieces
    out = {}
    toks = dry_tokens(5, 2 * world)
    eng = dry_port(dry_cfg("bf16", **zero), params, world, stream)
    out["bf16_loss"] = float(eng.train_batch(rank_rows(toks, 2, world,
                                                       rank)))
    eng.close()
    eng = dry_port(dry_cfg("fp32", **zero), params, world, stream)
    out["losses"] = [float(eng.train_batch(rank_rows(
        dry_tokens(7 + s, 2 * world), 2, world, rank))) for s in
        range(steps)]
    eng._xla_dpu_flush()
    master, _, _, _ = eng._xla_canonical()
    pieces = gathered_pieces(eng)
    out["pieces"] = [(m.numpy(), box, shape) for m, (_, box, shape)
                     in zip(master, pieces)]
    out["layout"] = [tuple(r) for r in eng._flat_layout]
    if extra is not None:
        out.update(extra(rank, world, eng))
    if save_dir is not None:
        eng.save_checkpoint(save_dir, tag="dp4")
    eng.close()
    return out


def dry_jax(zero, params, steps, world=4, stream=False):
    """The JAX engine's fp32 run on a ``world``-device virtual mesh."""
    import jax
    from deepspeed_tpu.config import DeepSpeedConfig
    from deepspeed_tpu.models.gpt2 import GPT2Config, GPT2Model
    from deepspeed_tpu.parallel import build_mesh
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine
    eng = DeepSpeedEngine(
        GPT2Model(GPT2Config(**DRY, remat="block", attn_impl="dense",
                             scan_layers=True, stream_scan=stream)),
        built(DeepSpeedConfig, dry_cfg("fp32", **zero), world),
        params=params,
        mesh=build_mesh(dp=world, devices=jax.devices()[:world]))
    losses = [float(np.asarray(eng.train_batch(dry_tokens(7 + s,
                                                          2 * world))))
              for s in range(steps)]
    eng._xla_dpu_flush()
    return losses, jax_leaves(eng._unflatten_numpy(
        eng.state.master_params), params), eng._flat_layout


def check_leg(res, params, zero, ref, world=4, stream=False):
    """Each rank's bf16 first-step loss within 1 % of one device's; the
    fp32 losses and assembled master within 1e-5 of the JAX 4-device
    run; the layout records the JAX engine's."""
    for r in res:
        assert abs(r["bf16_loss"] - ref) <= 0.01 * max(1.0, abs(ref)), (
            r["bf16_loss"], ref)
    jl, jm, jlayout = dry_jax(zero, params, len(res[0]["losses"]), world,
                              stream)
    for r in res:
        assert close(r["losses"], jl), (r["losses"], jl)
    got = assemble([r["pieces"] for r in res])
    assert masters_close(got, jm)
    # the params tree's dicts are in sorted key order, the JAX engine's
    # flatten order, so the records line up leaf for leaf
    assert res[0]["layout"] == [tuple(x) for x in jlayout]


def _leg5_extra(rank, world, eng):
    """ZeRO-3's pieces: each rank's row is its data shard, and the stage-3
    pack/unpack of every piece runs no collective; the disk tier refuses
    several processes (single-controller)."""
    before = dict(col.calls)
    for m, rec in zip(eng._xla.master, eng._flat_layout):
        if rec.data_dim is not None:
            shard = ox.unpack_row(m, rec, world)
            assert torch.equal(ox.pack_row(shard, rec, world, rank), m)
    free = dict(col.calls) == before
    cfg = dry_cfg("bf16", cpu_offload=True)
    cfg["offload"] = {"tier": "disk", "disk_dir": "unused"}
    try:
        dry_port(cfg, None, world)
        disk = "built"
    except ValueError as e:
        disk = str(e)
    return {"collective_free": free, "disk": disk,
            "sharded": [rec.data_dim is not None
                        for rec in eng._flat_layout]}


def _leg10_extra(rank, world, eng):
    """The streamed leaves' compute copies are pinned host shards; below
    stage 3 streaming refuses dp > 1."""
    st = eng._zero.streamer
    host = all(not t.is_cuda for t in st.leaves.values())
    try:
        dry_port(dry_cfg("bf16", **XLA, param_streaming=True), None,
                 world, stream=True)
        refusal = "built"
    except ValueError as e:
        refusal = str(e)
    return {"streamed": sorted(st.leaves), "host": host,
            "refusal": refusal}


LEGS = {
    5: (dict(XLA, stage=3), False, _leg5_extra),
    10: (dict(XLA, stage=3, param_streaming=True), True, _leg10_extra),
    11: (dict(XLA, stage=2, offload_split_update=True,
              offload_grad_chunks=2), False, None),
}


def _four_rank_legs(rank, world, params, save_dir):
    """Legs 5, 10 and 11 on this rank (leg 5's fp32 run saves)."""
    return {leg: dry_leg(rank, world, params, zero, 2, stream, extra,
                         save_dir if leg == 5 else None)
            for leg, (zero, stream, extra) in LEGS.items()}


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """One launch of 4 gloo ranks runs the three legs; the JAX side and
    the one-device reference run here."""
    root = tmp_path_factory.mktemp("legs")
    params = dry_tree()
    res = spawn_ranks(_four_rank_legs, 4, root, params, str(root / "ck"))
    return {"params": params, "res": res, "ckpt": str(root / "ck"),
            "ref": one_device_loss(params, dry_tokens(5, 8))}


def _leg(legs, n):
    return [r[n] for r in legs["res"]]


def test_dryrun_leg5_zero3_xla_tier_on_four_ranks(legs):
    """Leg 5: ZeRO-3 × the XLA tier on 4 gloo ranks: the pieces' rows are
    the data shards, packing them is collective-free, the runs hold the
    one-device loss and the JAX 4-device engine; the disk tier refuses
    several processes."""
    res = _leg(legs, 5)
    check_leg(res, legs["params"], LEGS[5][0], legs["ref"])
    for r in res:
        assert r["collective_free"] and any(r["sharded"])
        assert "single-controller" in r["disk"]


def test_dryrun_leg10_zero3_param_streaming_on_four_ranks(legs):
    """Leg 10: ZeRO-3 × the XLA tier × parameter streaming on 4 gloo
    ranks: every stacked block leaf streams from pinned host shards; the
    runs hold the one-device loss of the model without the fetch and the
    JAX 4-device engine; streaming below stage 3 refuses dp > 1."""
    res = _leg(legs, 10)
    check_leg(res, legs["params"], LEGS[10][0], legs["ref"], stream=True)
    n_blocks = len(legs["params"]["blocks"])
    for r in res:
        assert len(r["streamed"]) == n_blocks and r["host"]
        assert "requires ZeRO-3" in r["refusal"]


def test_dryrun_leg11_split_update_chunks_on_four_ranks(legs):
    """Leg 11: ZeRO-2 × the XLA tier × the split update × grad chunks 2 on
    4 gloo ranks."""
    check_leg(_leg(legs, 11), legs["params"], LEGS[11][0], legs["ref"])


def test_offload_elastic_dp_resize(legs):
    """``tests/test_checkpointing.py::test_offload_elastic_dp_resize``
    across packages: the port's XLA tier at dp 4 (leg 5's fp32 run)
    saves; one port process (dp 1) and the JAX XLA tier at dp 2 load the
    same master exactly and train on."""
    import jax
    from deepspeed_tpu.config import DeepSpeedConfig
    from deepspeed_tpu.models.gpt2 import GPT2Config, GPT2Model
    from deepspeed_tpu.parallel import build_mesh
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine
    params = legs["params"]
    saved = assemble([r["pieces"] for r in _leg(legs, 5)])
    one = dry_port(dry_cfg("fp32", **XLA), dry_tree(1), 1)
    one.load_checkpoint(legs["ckpt"], tag="dp4")
    assert bitwise([x.numpy() for x in one._xla_canonical()[0]], saved)
    assert np.isfinite(float(one.train_batch(dry_tokens(9, 2))))
    one.close()
    j = DeepSpeedEngine(
        GPT2Model(GPT2Config(**DRY, remat="block", attn_impl="dense")),
        built(DeepSpeedConfig, dry_cfg("fp32", **XLA), 2),
        params=dry_tree(1),
        mesh=build_mesh(dp=2, devices=jax.devices()[:2]))
    j.load_checkpoint(legs["ckpt"], tag="dp4")
    assert bitwise(jax_leaves(j._unflatten_numpy(j.state.master_params),
                              params), saved)
    assert np.isfinite(float(np.asarray(j.train_batch(dry_tokens(9, 4)))))
    j.close()
