"""Port parity for ZeRO-Offload's host tier (``zero_optimization.
cpu_offload``, ``runtime/offload.py``): the port's engine against the JAX
engine's host tier (``offload_impl: "host"``) on the same numpy weights
and batches, and the tier's own invariants (``tests/
test_offload_pipeline.py``, ``tests/test_multiprocess.py``'s sharded
tier, ``tests/test_resilience.py``'s host-offload async save).

Tolerances (Adam at eps 1e-3, as ``tests/test_torch_zero.py``): fp32
losses and the final master within 1e-5 relative of the JAX host tier's
(SimpleModel and a tiny GPT-2, serial, pipelined and delayed update);
inside the port the pipelined update equals the serial
one bit for bit (master, moments, compute copy), with and without the
delayed update; two gloo ranks of the sharded tier equal one process's
tier within fp32 1e-6; checkpoints cross host ↔ plain and port ↔ JAX
within fp32 1e-5 on the continued losses (bitwise inside the port).
"""
import os

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.runtime import offload as offload_mod

from simple_model import base_config, random_batches
from test_torch_checkpointing import HIDDEN, SimpleModel
from test_torch_zero import close, spawn_ranks, one_thread  # noqa: F401

STEPS = 4
GPT2 = dict(vocab_size=128, n_positions=16, d_model=32, n_layer=2,
            n_head=4)


def _cfg(precision="fp32", pipeline=True, dpu=False, micro=2, ga=2,
         **zero):
    cfg = base_config(micro_bs=micro, grad_acc=ga, stage=2,
                      precision="bf16" if precision == "bf16" else "fp32")
    cfg["steps_per_print"] = 10 ** 9
    cfg["gradient_clipping"] = 1.0
    # eps 1e-3: at 1e-8 Adam's direction on near-zero gradients turns
    # fp32 rounding differences into 1e-4 moves (tests/test_torch_zero.py)
    cfg["optimizer"]["params"]["eps"] = 1e-3
    cfg["zero_optimization"].update({"cpu_offload": True,
                                     "offload_pipeline": pipeline,
                                     "delayed_param_update": dpu, **zero})
    return cfg


def _built(config_cls, cfg, world=1):
    """Both packages refuse ZeRO (and so offload) without bf16/fp16: an
    fp32 config is built without its ZeRO block and the block set
    after, so the tier is held at fp32's tolerance."""
    if "bf16" in cfg or "fp16" in cfg:
        return config_cls(cfg, world_size=world)
    zero = cfg["zero_optimization"]
    out = config_cls({**cfg, "zero_optimization": {"stage": 0}},
                     world_size=world)
    zc = out.zero_config
    zc.stage = zero["stage"]
    zc.cpu_offload = zero.get("cpu_offload", False)
    zc.offload_pipeline = zero.get("offload_pipeline", True)
    zc.delayed_param_update = zero.get("delayed_param_update", False)
    zc.offload_impl = "host"
    return out


def _model(family):
    if family == "simple":
        return SimpleModel()
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    return GPT2Model(GPT2Config(**GPT2, remat=None, attn_impl="dense"))


def _jax_model(family):
    if family == "simple":
        from simple_model import SimpleModel as JaxSimple
        return JaxSimple(hidden_dim=HIDDEN)
    from deepspeed_tpu.models.gpt2 import GPT2Config, GPT2Model
    return GPT2Model(GPT2Config(**GPT2, remat=None, attn_impl="dense"))


def _tree(family, seed=0):
    import jax
    return jax.tree.map(np.asarray, _jax_model(family).init(
        jax.random.PRNGKey(seed)))


def _batches(family, rows, steps=STEPS, seed=11):
    if family == "simple":
        return list(random_batches(rows, HIDDEN, num_batches=steps,
                                   seed=seed))
    rng = np.random.default_rng(seed)
    return [rng.integers(0, GPT2["vocab_size"], (rows, 9), np.int32)
            for _ in range(steps)]


def _port(family, cfg, tree, mesh=None, world=1):
    from deepspeed_tpu_torch.config import DeepSpeedConfig
    eng, *_ = dst.initialize(model=_model(family), params=tree,
                             config=_built(DeepSpeedConfig, cfg, world),
                             device="cpu", seed=3, mesh=mesh)
    return eng


def _jax(family, cfg, tree):
    import jax
    from deepspeed_tpu.config import DeepSpeedConfig
    from deepspeed_tpu.parallel import build_mesh
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine
    return DeepSpeedEngine(_jax_model(family), _built(DeepSpeedConfig, cfg),
                           params=tree, seed=3,
                           mesh=build_mesh(dp=1, devices=jax.devices()[:1]))


def _run(eng, batches):
    return [float(np.asarray(eng.train_batch(b))) for b in batches]


def _host_state(eng):
    """(master, mu, nu, compute copy) of a port offload engine."""
    ho = eng._host_opt
    st = ho.state_tree()
    return ([p.clone() for p in ho.master], [m.clone() for m in st["mu"]],
            [v.clone() for v in st["nu"]],
            [s.clone() for s in eng._zero.sources])


@pytest.mark.parametrize("family", ["simple", "gpt2"])
@pytest.mark.parametrize("arm", ["serial", "pipelined", "dpu"])
def test_host_tier_matches_jax_host_tier(family, arm):
    """fp32, 4 steps: every loss and the final master within 1e-5 of the
    JAX engine's host tier (the delayed update compared after a
    flush)."""
    cfg = _cfg(pipeline=arm != "serial", dpu=arm == "dpu")
    tree = _tree(family)
    port, jeng = _port(family, cfg, tree), _jax(family, cfg, tree)
    assert port._offload and jeng._offload_host
    assert port._host_opt.is_native == jeng._host_opt.is_native
    batches = _batches(family, int(port.train_batch_size))
    got, want = _run(port, batches), _run(jeng, batches)
    assert close(got, want), (got, want)
    port._dpu_flush()
    jeng._dpu_flush()
    import jax
    jm = jax.tree.leaves(jeng.state.master_params)
    pm = port._host_opt.master
    assert len(jm) == len(pm)
    for a, b in zip(pm, jm):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    port.close()
    jeng.close()


@pytest.mark.parametrize("dpu", [False, True], ids=["plain", "dpu"])
def test_pipelined_bitwise_equals_serial(dpu):
    """Identical losses, master, moments and uploaded compute copy after
    4 bf16 steps: the streamed upload changes when bytes move, not
    which bytes."""
    tree = _tree("gpt2")
    out = []
    for pipeline in (True, False):
        eng = _port("gpt2", _cfg("bf16", pipeline=pipeline, dpu=dpu), tree)
        assert eng._offload_pipeline is pipeline
        losses = _run(eng, _batches("gpt2", int(eng.train_batch_size)))
        eng._dpu_flush()
        out.append((losses, _host_state(eng)))
        eng.close()
    (la, sa), (lb, sb) = out
    assert la == lb
    for xs, ys in zip(sa, sb):
        for x, y in zip(xs, ys):
            assert x.dtype == y.dtype and torch.equal(x, y)


def test_offload_trains_as_the_plain_engine_within_bf16():
    """Host offload against the plain stage-2 engine (bf16 compute, the
    same Adam rule in another order of operations): losses within 2e-2
    relative."""
    tree = _tree("gpt2")
    off = _port("gpt2", _cfg("bf16"), tree)
    cfg = _cfg("bf16")
    cfg["zero_optimization"] = {"stage": 2}
    plain = _port("gpt2", cfg, tree)
    assert not plain._offload
    b = _batches("gpt2", int(off.train_batch_size))
    assert close(_run(off, b), _run(plain, b), rtol=2e-2)
    off.close()
    plain.close()


def test_upload_failure_poisons_and_preserves_compute_params(monkeypatch):
    """An upload failing after the Adam: the step raises, the compute
    copy the forward reads is the previous step's, the optimizer is
    poisoned (no step, no save) until a checkpoint load."""
    eng = _port("simple", _cfg("bf16"), _tree("simple"))
    batches = _batches("simple", int(eng.train_batch_size))
    eng.train_batch(batches[0])
    before = [s.clone() for s in eng._zero.sources]
    real = eng._host_opt.upload

    def flaky(i, host):
        if i == 1:
            raise RuntimeError("H2D link down")
        return real(i, host)

    monkeypatch.setattr(eng._host_opt, "upload", flaky)
    with pytest.raises(RuntimeError, match="H2D link down"):
        eng.train_batch(batches[1])
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 eng._zero.sources))
    monkeypatch.setattr(eng._host_opt, "upload", real)
    with pytest.raises(RuntimeError, match="poisoned"):
        eng.train_batch(batches[2])
    with pytest.raises(RuntimeError, match="inconsistent"):
        eng._canonical_state()
    eng.close()


def test_adam_failure_poisons_and_preserves_compute_params(monkeypatch):
    eng = _port("simple", _cfg("bf16"), _tree("simple"))
    batches = _batches("simple", int(eng.train_batch_size))
    eng.train_batch(batches[0])
    before = [s.clone() for s in eng._zero.sources]
    opt = eng._host_opt.opt
    real = opt.apply_leaf
    calls = []

    def bad(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("host Adam failed")
        return real(*a, **k)

    monkeypatch.setattr(opt, "apply_leaf", bad)
    with pytest.raises(RuntimeError, match="host Adam failed"):
        eng.train_batch(batches[1])
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 eng._zero.sources))
    with pytest.raises(RuntimeError, match="poisoned"):
        eng.train_batch(batches[2])
    eng.close()


def test_streaming_uploader_raises_after_abort_and_drains_failures():
    """finish() re-raises the first put failure once every submission
    drained; after abort() it raises UploadAborted (never partial
    results)."""
    def put(i, host):
        if i == 1:
            raise ValueError("bad leaf")
        return host.clone(), None

    up = offload_mod.StreamingUploader(put)
    for i in range(4):
        up.submit(i, torch.full((3,), float(i)))
    with pytest.raises(ValueError, match="bad leaf"):
        up.finish()
    up2 = offload_mod.StreamingUploader(lambda i, h: (h.clone(), None))
    up2.abort()
    with pytest.raises(offload_mod.UploadAborted):
        up2.finish()


def test_serial_path_reports_zero_overlap_and_breakdown():
    eng = _port("simple", _cfg("bf16", pipeline=False), _tree("simple"))
    _run(eng, _batches("simple", int(eng.train_batch_size), steps=2))
    bd = eng.last_offload_breakdown
    assert bd["pipelined"] is False and bd["overlap_ratio"] == 0.0
    assert bd["cpu_adam_s"] > 0 and bd["h2d_tail_s"] >= 0
    # the bytes the serial upload moved: every leaf's bf16 copy
    assert bd["h2d_bytes"] == sum(p.numel() * 2
                                  for p in eng._host_opt.master)
    eng.close()


def _two_rank_sharded(rank, world, tree, batches):
    from deepspeed_tpu_torch.parallel import build_mesh
    from deepspeed_tpu_torch.runtime.dataloader import rank_rows
    eng = _port("gpt2", _cfg("fp32", micro=1), tree, mesh=build_mesh(),
                world=world)
    losses = [float(eng.train_batch(rank_rows(b, 2, world, rank)))
              for b in batches]
    ho = eng._host_opt
    out = {"losses": losses, "staged": ho.staged_bytes,
           "pieces": [(p.numpy().copy(), pc.box, pc.shape) for p, pc in zip(
               ho.master, eng._zero.shard_pieces(ho.master))]}
    eng.close()
    return out


def test_sharded_tier_two_ranks_matches_one_process(tmp_path):
    """ZeRO-2 with the host tier on 2 gloo ranks: each rank stages only
    its data shards (half the divisible leaves' bytes) and the run
    equals one process's host tier on the global batch (losses and the
    assembled master within fp32 1e-6)."""
    from test_torch_zero import assemble
    tree = _tree("gpt2")
    batches = _batches("gpt2", 4)
    res = spawn_ranks(_two_rank_sharded, 2, tmp_path, tree, batches)
    one = _port("gpt2", _cfg("fp32", micro=2), tree)
    ref = _run(one, batches)
    whole = one._host_opt.staged_bytes
    for r in range(2):
        assert close(res[r]["losses"], ref, rtol=1e-6), (res[r], ref)
        # the rank stages its own pieces and nothing else
        assert res[r]["staged"] == 3 * sum(
            p.nbytes for p, _, _ in res[r]["pieces"])
        assert res[r]["staged"] < 0.6 * whole
    got = assemble([res[r]["pieces"] for r in range(2)])
    for g, w in zip(got, one._host_opt.master):
        np.testing.assert_allclose(g, w.numpy(), rtol=1e-6, atol=1e-7)
    one.close()


@pytest.mark.parametrize("direction", ["host_to_plain", "plain_to_host"])
def test_checkpoint_crosses_host_and_plain(direction, tmp_path):
    """A host-tier checkpoint continues on a plain engine and the reverse:
    the continued losses within fp32 1e-5 of the uninterrupted source
    engine's."""
    tree = _tree("gpt2")
    off_cfg = _cfg()
    plain_cfg = _cfg()
    plain_cfg["zero_optimization"] = {"stage": 2}
    src_cfg, dst_cfg = ((off_cfg, plain_cfg) if direction == "host_to_plain"
                        else (plain_cfg, off_cfg))
    src = _port("gpt2", src_cfg, tree)
    b = _batches("gpt2", int(src.train_batch_size), steps=5)
    _run(src, b[:2])
    src.save_checkpoint(str(tmp_path))
    ref = _run(src, b[2:])
    dst_eng = _port("gpt2", dst_cfg, _tree("gpt2", seed=1))
    dst_eng.load_checkpoint(str(tmp_path))
    assert close(_run(dst_eng, b[2:]), ref), direction
    src.close()
    dst_eng.close()


def test_checkpoint_roundtrip_bitwise_and_module_only(tmp_path):
    """Inside the port: save → load → continue repeats the losses bit for
    bit (DPU pending update flushed by the save); a module-only load
    starts fresh moments on the loaded master."""
    tree = _tree("gpt2")
    cfg = _cfg("bf16", dpu=True)
    a = _port("gpt2", cfg, tree)
    b = _batches("gpt2", int(a.train_batch_size), steps=5)
    _run(a, b[:2])
    a.save_checkpoint(str(tmp_path))
    ref = _run(a, b[2:])
    c = _port("gpt2", cfg, _tree("gpt2", seed=1))
    c.load_checkpoint(str(tmp_path))
    assert _run(c, b[2:]) == ref
    d = _port("gpt2", cfg, _tree("gpt2", seed=1))
    d.load_checkpoint(str(tmp_path), load_module_only=True)
    assert d._host_opt.opt.step_count == 0
    assert all(float(m.abs().sum()) == 0
               for m in d._host_opt.state_tree()["mu"])
    for x, y in zip(d._host_opt.master, a._host_opt.master):
        assert x.shape == y.shape
    for e in (a, c, d):
        e.close()


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_checkpoint_crosses_packages_host_tier(direction, tmp_path):
    """Host-tier checkpoints cross between the two packages' host tiers:
    continued losses within fp32 1e-5."""
    tree = _tree("gpt2")
    cfg = _cfg()
    b = _batches("gpt2", 4, steps=5)
    if direction == "port_to_jax":
        src, dst_eng = _port("gpt2", cfg, tree), _jax("gpt2", cfg,
                                                      _tree("gpt2", 1))
    else:
        src, dst_eng = _jax("gpt2", cfg, tree), _port("gpt2", cfg,
                                                      _tree("gpt2", 1))
    _run(src, b[:2])
    src.save_checkpoint(str(tmp_path))
    ref = _run(src, b[2:])
    dst_eng.load_checkpoint(str(tmp_path))
    assert close(_run(dst_eng, b[2:]), ref), direction
    src.close()
    dst_eng.close()


def test_async_save_bitwise_equals_sync_host_offload(tmp_path):
    """``tests/test_resilience.py::test_async_save_bitwise_equals_sync
    [host_offload]``'s counterpart: an async save (host snapshot, then
    the writer) writes the same bytes as a sync save of the same state
    while training continues."""
    from deepspeed_tpu_torch.runtime import checkpointing as ckpt
    tree = _tree("simple")
    eng = _port("simple", _cfg("bf16"), tree)
    b = _batches("simple", int(eng.train_batch_size), steps=4)
    _run(eng, b[:2])
    eng.save_checkpoint(str(tmp_path / "sync"), tag="t")
    eng.save_checkpoint(str(tmp_path / "async"), tag="t", async_write=True)
    _run(eng, b[2:])          # mutates the host master under the writer
    eng.close()
    for plane in ("model", "optim"):
        ma = ckpt._read_json(str(tmp_path / "sync" / "t" / plane /
                                 "manifest.json"), "m", ckpt.DEFAULT_RETRY)
        mb = ckpt._read_json(str(tmp_path / "async" / "t" / plane /
                                 "manifest.json"), "m", ckpt.DEFAULT_RETRY)
        assert ma == mb, plane


def _multi_process_saves(rank, world, tree, batches, save_dir):
    from deepspeed_tpu_torch.parallel import build_mesh
    from deepspeed_tpu_torch.runtime.dataloader import rank_rows
    cfg = _cfg("bf16", micro=1)
    cfg["checkpoint"] = {"async_save": True, "sigterm_save": True}
    eng = _port("gpt2", cfg, tree, mesh=build_mesh(), world=world)
    eng.train_batch(rank_rows(batches[0], 2, world, rank))
    eng.save_checkpoint(save_dir)
    out = (os.path.exists(os.path.join(save_dir, "global_step1",
                                       "meta.json")),
           eng._ckpt_writer.in_flight(), eng._preemption_handler is None)
    eng.close()
    return out


def test_async_and_sigterm_saves_across_processes(tmp_path):
    """On 2 gloo ranks (host tier, ZeRO-2) an async save writes
    synchronously and ``sigterm_save`` installs no hook — the JAX
    engine's single-controller rules."""
    res = spawn_ranks(_multi_process_saves, 2, tmp_path, _tree("gpt2"),
                      _batches("gpt2", 4, steps=1), str(tmp_path / "ck"))
    assert res == [(True, False, True)] * 2


@pytest.mark.parametrize("zero,exc,match", [
    # the XLA tier is ported; it refuses streaming a model that marks
    # no streamable leaves
    ({"offload_impl": "xla", "param_streaming": True}, ValueError,
     "streaming_param_spec"),
    ({"stage": 3}, ValueError, "ZeRO-3"),
    ({"param_streaming": True}, ValueError, "xla-tier"),
    ({"offload_grad_chunks": 2}, ValueError, "xla-tier"),
], ids=["xla", "stage3", "param_streaming", "grad_chunks"])
def test_offload_refusals(zero, exc, match):
    cfg = _cfg("bf16", **{k: v for k, v in zero.items() if k != "stage"})
    if "stage" in zero:
        cfg["zero_optimization"]["stage"] = zero["stage"]
    with pytest.raises(exc, match=match):
        dst.initialize(model=SimpleModel(), config=cfg, device="cpu")


def test_disk_tier_refused_naming_item_12(tmp_path):
    """Item 12's disk tier is ported (``tests/test_torch_disk_offload.py``):
    it trains, one state file per leaf, and refuses the XLA tier's
    explicit ``offload_impl`` (a host-impl structure)."""
    from deepspeed_tpu_torch.config import DeepSpeedConfigError
    cfg = _cfg("bf16")
    cfg["offload"] = {"tier": "disk", "disk_dir": str(tmp_path / "d")}
    eng, *_ = dst.initialize(model=SimpleModel(), config=cfg, device="cpu")
    _run(eng, _batches("simple", int(eng.train_batch_size), steps=1))
    assert len(os.listdir(tmp_path / "d")) == len(eng._host_opt._meta)
    eng.close()
    cfg["zero_optimization"]["offload_impl"] = "xla"
    with pytest.raises(DeepSpeedConfigError, match="host-impl"):
        dst.initialize(model=SimpleModel(), config=cfg, device="cpu")


def test_overlap_ratio_reaches_telemetry(tmp_path):
    """The ``offload_overlap_ratio`` gauge and the interval scalars land
    in the telemetry plane; ``offload/*`` spans in the trace."""
    import json
    cfg = _cfg("bf16")
    cfg["steps_per_print"] = 2
    cfg["telemetry"] = {"enabled": True, "output_path": str(tmp_path)}
    eng = _port("simple", cfg, _tree("simple"))
    _run(eng, _batches("simple", int(eng.train_batch_size), steps=4))
    eng.close()
    recs = [json.loads(line) for line in
            open(tmp_path / "events.jsonl") if line.strip()]
    scal = [r for r in recs if "offload_overlap_ratio" in
            (r.get("scalars") or {})]
    assert scal, recs[:3]
    trace = json.load(open(tmp_path / "trace.json"))
    names = {e.get("name") for e in trace.get("traceEvents", trace)}
    assert {"offload/host_adam", "offload/h2d_params"} <= names
