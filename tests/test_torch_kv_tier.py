"""KV tiering on the port (``deepspeed_tpu_torch/inference/kv_tier.py``
and the paged ``ServeEngine``'s tier seams), on the CPU: the cases of
``tests/test_kv_tier.py`` run on the port, and the port against the JAX
package.

On the port: resumed streams bitwise equal to a never-spilled engine's
across {host, disk} x {fp, int8 KV} x {plain, speculative}; parked pages
leave the pool; a one-shot fault at every ``kv_spill``/``kv_fetch`` point
absorbed by the retry budget, a sticky one degrading once with every
request served; a degraded spill going dormant; CRC flip, truncation and
deletion of a parked page and a poisoned host copy all landing the typed
``KVTierCorruptError`` before any byte re-enters the pool, then recompute;
the ``DSDISK1`` page-file dialect; the close-time drain; config
validation.  Left out: ``test_kv_tier_telemetry_flows_to_summarize``
(ROADMAP.md queue 1 item 5, telemetry; the ``serve_kv_*`` gauges wait
for it).

Against the JAX package: the two engines on the same fp32 weights with
the tier on give equal greedy streams, equal shared prefixes and equal
park, resume and byte counts, and a parked page's payload has the JAX
engine's layout with its values within 1e-4 (fp32; the two frameworks
order their sums differently); a page file either package's
``KVTierDiskStore`` writes is the other's byte for byte and reads back in
it.  A resume on the int8 pool carries the scale sidecars bit for bit.
"""
import logging
import os

import numpy as np
import pytest
import jax
import torch

from deepspeed_tpu.inference import ServeEngine as JaxServeEngine
from deepspeed_tpu.inference.kv_tier import \
    KVTierDiskStore as JaxKVTierDiskStore
from deepspeed_tpu.models.gpt2 import (GPT2Config as JaxConfig,
                                       GPT2Model as JaxModel)
from deepspeed_tpu.runtime.disk_offload import _MAGIC as JAX_DISK_MAGIC
from deepspeed_tpu.runtime.stages import \
    reset_fault_injection as jax_reset_faults
from deepspeed_tpu_torch.config.config import DeepSpeedConfigError
from deepspeed_tpu_torch.inference import ServeEngine
from deepspeed_tpu_torch.inference.kv_tier import (KVTierCorruptError,
                                                   KVTierDiskStore, _MAGIC)
from deepspeed_tpu_torch.models.gpt2 import (GPT2Config, GPT2Model,
                                             params_from_numpy)
from deepspeed_tpu_torch.runtime.resilience import CheckpointCorruptError
from deepspeed_tpu_torch.runtime.stages import reset_fault_injection
from deepspeed_tpu_torch.utils.logging import logger as port_logger

TINY = dict(vocab_size=128, n_positions=64, d_model=32, n_layer=2,
            n_head=4)
DRAFT_BLOCK = {"d_model": 32, "n_layer": 2, "n_head": 4}
_CHAOS_ENVS = ("DS_STAGE_FAULT", "DS_STAGE_DELAY_S")
#: idle_park_ticks of every engine-level test; the idle loop runs IDLE + 3
#: ticks (one snapshots last_hit, IDLE more cross the threshold)
IDLE = 3


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    for env in _CHAOS_ENVS:
        monkeypatch.delenv(env, raising=False)
    reset_fault_injection()
    jax_reset_faults()
    yield
    reset_fault_injection()
    jax_reset_faults()


@pytest.fixture
def port_caplog(caplog, monkeypatch):
    """The port's logger does not propagate; flip it so caplog sees the
    degradation warning."""
    monkeypatch.setattr(port_logger, "propagate", True)
    with caplog.at_level(logging.WARNING, logger=port_logger.name):
        yield caplog


def _tokens(n, vocab=128, seed=0):
    return [int(t) for t in np.random.default_rng(seed).integers(
        0, vocab, (n,))]


def _p1():
    # 17 tokens: two full pages (page_len=8) + a 1-token partial tail
    return _tokens(17, seed=11)


def _p2():
    # turn 2 of the same conversation: turn 1's prompt + new tokens
    return _p1() + _tokens(8, seed=12)


_model_cache = {}


def _model_params():
    if not _model_cache:
        model = GPT2Model(GPT2Config(**TINY, remat=None, attn_impl="dense"))
        _model_cache["mp"] = (model, model.init(0))
    return _model_cache["mp"]


def _serve_cfg(slots=4, max_seq=64, prefill=32, **serving_extra):
    return {"serving": {"slots": slots, "max_seq_len": max_seq,
                        "prefill_len": prefill, "page_len": 8,
                        "pages": 16, **serving_extra}}


def _tier(disk_dir=None, ticks=IDLE, budget=256, **kw):
    kv = {"idle_park_ticks": ticks, "host_budget_pages": budget}
    if disk_dir is not None:
        kv["disk_dir"] = str(disk_dir)
    kv.update(kw)
    return {"kv_tier": kv}


def _mode_serving(mode):
    s = {}
    if "int8" in mode:
        s["quantization"] = {"kv": "int8"}
    if "spec" in mode:
        s["speculate_k"] = 2
        s["draft"] = dict(DRAFT_BLOCK)
    return s


def _engine(serving_extra, mode="plain"):
    model, params = _model_params()
    return ServeEngine(model, _serve_cfg(**_mode_serving(mode),
                                         **serving_extra),
                       params=params,
                       draft_params=params if "spec" in mode else None,
                       device="cpu")


def _two_turns(serving_extra, mode="plain", idle=0, between=None,
               collect=None):
    """Turn 1, a think-time gap of idle ticks (what parks the session),
    an optional mid-gap hook, then turn 2 extending the same prompt.
    Returns the two streams, turn 2's shared prefix length and the
    collect() snapshot; asserts no request error and a leak-free pool."""
    eng = _engine(serving_extra, mode)
    r1 = eng.submit(_p1(), max_new_tokens=4)
    eng.run_until_idle()
    for _ in range(idle):
        eng.step()
    if between is not None:
        between(eng)
    r2 = eng.submit(_p2(), max_new_tokens=4)
    eng.run_until_idle()
    assert r1.error is None and r2.error is None
    stats = collect(eng) if collect is not None else None
    streams = (list(r1.tokens), list(r2.tokens))
    shared = r2.shared_len
    eng.close()
    assert eng.pool.refs == {}
    return streams, shared, stats


_base_cache = {}


def _baseline(mode):
    """The never-spilled streams (the tier-off engine still gets a live
    prefix-cache hit on turn 2)."""
    if mode not in _base_cache:
        _base_cache[mode] = _two_turns({}, mode=mode)[0]
    return _base_cache[mode]


def _tier_stats(eng):
    t = eng.kv_tier
    return {"parked": t.parked_pages_total, "spill": t.spill_bytes,
            "fetched": t.fetch_bytes, "resumed": t.resumed_sessions_total,
            "corrupt": t.corrupt_total,
            "spill_deg": t.spill_stage.degraded,
            "fetch_deg": t.fetch_stage.degraded,
            "fails": t.spill_stage.failures + t.fetch_stage.failures}


# ---------------------------------------------------------------------------
# resume is bitwise a never-spilled engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["plain", "int8", "spec", "int8_spec"])
@pytest.mark.parametrize("arm", ["host", "disk"])
def test_park_resume_stream_bitwise_vs_never_spilled(arm, mode, tmp_path):
    extra = _tier(tmp_path if arm == "disk" else None,
                  budget=0 if arm == "disk" else 256)
    # parking cascades root-ward one leaf per idle window: a few windows
    streams, shared, stats = _two_turns(
        extra, mode=mode, idle=4 * (IDLE + 3), collect=_tier_stats)
    assert streams == _baseline(mode)
    assert stats["parked"] >= 2 and stats["spill"] > 0
    assert stats["fetched"] > 0 and stats["resumed"] >= 1
    assert stats["corrupt"] == 0
    assert shared >= 16       # both full pages came back from the tier


def test_parked_pages_leave_the_pool_during_the_gap(tmp_path):
    eng = _engine(_tier(tmp_path, budget=1))
    r1 = eng.submit(_p1(), max_new_tokens=4)
    eng.run_until_idle()
    for _ in range(IDLE + 3):
        eng.step()
    held_mid_gap = (eng.pool.used_count, eng.kv_tier.parked_pages)
    on_disk = [f for f in os.listdir(tmp_path) if f.endswith(".page")]
    r2 = eng.submit(_p2(), max_new_tokens=4)
    eng.run_until_idle()
    assert r1.error is None and r2.error is None
    assert held_mid_gap[0] == 0 and held_mid_gap[1] >= 2
    assert len(on_disk) >= 1
    assert eng.kv_tier.parked_sessions == 0   # consumed by the resume
    eng.close()
    assert eng.pool.refs == {}


def test_int8_resume_carries_the_scale_sidecars(tmp_path):
    """On the int8 pool a page payload is k, v, k_scale, v_scale: the
    page a resume imports holds every one of the four slices bit for bit
    as it was parked (a resume that dropped the scales would dequantize
    garbage)."""
    eng = _engine(_tier(None), mode="int8")
    assert eng._page_leaves() == ["k", "v", "k_scale", "v_scale"]
    eng.submit(_p1(), max_new_tokens=4)
    eng.run_until_idle()
    (page, before), = [(p, {k: eng.cache[k][:, p].clone()
                            for k in eng._page_leaves()})
                       for p in [eng.prefix.full[next(iter(
                           eng.prefix.full))].page]]
    payload = eng._export_page_bytes(page)
    sizes = [eng.cache[k][:, page].numel() * eng.cache[k].element_size()
             for k in eng._page_leaves()]
    assert len(payload) == sum(sizes) and sizes[2] > 0
    for k in eng._page_leaves():
        eng.cache[k][:, page] = 0
    eng._import_page_bytes(page, payload)
    for k in eng._page_leaves():
        assert torch.equal(eng.cache[k][:, page], before[k]), k
    with pytest.raises(KVTierCorruptError, match="bytes"):
        eng._import_page_bytes(page, payload[:sizes[0] + sizes[1]])
    eng.close()


# ---------------------------------------------------------------------------
# torture matrix: a fault at every spill/fetch point
# ---------------------------------------------------------------------------
POINTS = [("kv_spill", "pageout"), ("kv_spill", "write"),
          ("kv_fetch", "read"), ("kv_fetch", "pagein")]


@pytest.mark.parametrize("stage,point", POINTS)
def test_one_shot_fault_is_absorbed_by_the_retry_budget(
        stage, point, tmp_path, monkeypatch):
    monkeypatch.setenv("DS_STAGE_FAULT", f"{stage}:{point}:1")
    reset_fault_injection()
    streams, shared, stats = _two_turns(
        _tier(tmp_path, budget=0), idle=IDLE + 3, collect=_tier_stats)
    assert streams == _baseline("plain")
    assert stats["fails"] == 1
    assert not stats["spill_deg"] and not stats["fetch_deg"]
    assert stats["fetched"] > 0 and stats["corrupt"] == 0
    assert shared >= 16


@pytest.mark.parametrize("stage,point", POINTS)
def test_sticky_fault_degrades_once_and_keeps_serving(
        stage, point, tmp_path, monkeypatch, port_caplog):
    monkeypatch.setenv("DS_STAGE_FAULT", f"{stage}:{point}:1+")
    reset_fault_injection()
    eng = _engine(_tier(tmp_path, budget=0))
    r1 = eng.submit(_p1(), max_new_tokens=4)
    eng.run_until_idle()
    for _ in range(IDLE + 3):
        eng.step()
    r2 = eng.submit(_p2(), max_new_tokens=4)
    eng.run_until_idle()
    r3 = eng.submit(_tokens(9, seed=44), max_new_tokens=3)
    eng.run_until_idle()
    tier = eng.kv_tier
    degraded = tier.spill_stage.degraded or tier.fetch_stage.degraded
    corrupt = tier.corrupt_total
    eng.close()
    assert [r.error for r in (r1, r2, r3)] == [None, None, None]
    assert (list(r1.tokens), list(r2.tokens)) == _baseline("plain")
    assert degraded and corrupt == 0
    warns = [r for r in port_caplog.records
             if "failure budget" in r.getMessage()]
    assert len(warns) == 1, "degradation must warn exactly ONCE"
    assert eng.pool.refs == {}


def test_degraded_spill_goes_dormant(tmp_path, monkeypatch):
    monkeypatch.setenv("DS_STAGE_FAULT", "kv_spill:pageout:1+")
    reset_fault_injection()
    eng = _engine(_tier(tmp_path, budget=0))
    r1 = eng.submit(_p1(), max_new_tokens=4)
    eng.run_until_idle()
    for _ in range(IDLE + 3):
        eng.step()
    assert eng.kv_tier.spill_stage.degraded
    parked_at_degrade = eng.kv_tier.parked_pages_total
    r2 = eng.submit(_tokens(17, seed=55), max_new_tokens=4)
    eng.run_until_idle()
    for _ in range(IDLE + 3):
        eng.step()
    assert eng.kv_tier.parked_pages_total == parked_at_degrade
    assert eng.prefix.entries > 0
    assert r1.error is None and r2.error is None
    eng.close()
    assert eng.pool.refs == {}


# ---------------------------------------------------------------------------
# corruption matrix: typed error + recompute fallback, never a poison
# ---------------------------------------------------------------------------
def _flip(path):
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))


def _truncate(path):
    with open(path, "r+b") as f:
        f.truncate(10)


@pytest.mark.parametrize("damage", [_flip, _truncate, os.unlink],
                         ids=["crc_flip", "truncate", "unlink"])
def test_disk_damage_falls_back_to_recompute(damage, tmp_path):
    def corrupt(eng):
        files = [f for f in os.listdir(tmp_path) if f.endswith(".page")]
        assert files, "nothing parked to disk"
        for fn in files:
            damage(os.path.join(str(tmp_path), fn))

    streams, shared, stats = _two_turns(
        _tier(tmp_path, budget=0), idle=IDLE + 3, between=corrupt,
        collect=_tier_stats)
    assert streams == _baseline("plain")
    assert stats["corrupt"] >= 1
    assert stats["fetched"] == 0      # no damaged byte reached the pool
    assert not stats["fetch_deg"]     # typed, not transient: no budget


def test_poisoned_host_copy_reverifies_at_pagein(tmp_path):
    def poison(eng):
        recs = list(eng.kv_tier._full.values())
        assert recs
        for rec in recs:
            rec.payload = bytes(len(rec.payload))

    streams, _, stats = _two_turns(
        _tier(None, budget=256), idle=IDLE + 3, between=poison,
        collect=_tier_stats)
    assert streams == _baseline("plain")
    assert stats["corrupt"] >= 1 and stats["fetched"] == 0


def test_corrupt_error_is_typed_not_transient():
    assert issubclass(KVTierCorruptError, CheckpointCorruptError)
    assert not issubclass(KVTierCorruptError, OSError)


# ---------------------------------------------------------------------------
# the disk-store dialect
# ---------------------------------------------------------------------------
def test_disk_store_roundtrip(tmp_path):
    st = KVTierDiskStore(str(tmp_path), fsync=False)
    payload = bytes(np.random.default_rng(3).integers(
        0, 256, 4096).astype(np.uint8))
    assert st.write("abc", payload) == 4096
    assert st.read("abc") == payload
    assert os.path.basename(st.path("abc")) == "kv_abc.page"
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    st.remove("abc")
    with pytest.raises(KVTierCorruptError, match="missing"):
        st.read("abc")
    st.remove("abc")                     # best-effort: no raise


@pytest.mark.parametrize("mutate,msg", [
    (lambda p: open(p, "r+b").write(b"XXXXXXXX"), "bad magic"),
    (lambda p: _truncate(p), "truncated in its header"),
    (lambda p: _flip(p), "CRC"),
], ids=["magic", "header", "crc"])
def test_disk_store_detects_corruption(tmp_path, mutate, msg):
    st = KVTierDiskStore(str(tmp_path), fsync=False)
    st.write("x", b"\x01\x02\x03\x04" * 64)
    mutate(st.path("x"))
    with pytest.raises(KVTierCorruptError, match=msg):
        st.read("x")


def test_disk_store_shares_the_checkpoint_magic():
    """One on-disk dialect: the port's page files open with the magic of
    the JAX package's disk offload tier."""
    assert _MAGIC == JAX_DISK_MAGIC


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_page_files_cross_packages_byte_for_byte(writer, tmp_path):
    """A page file either package writes is the other's byte for byte,
    and reads back in the other's store."""
    payload = bytes(np.random.default_rng(5).integers(
        0, 256, 3000).astype(np.uint8))
    jst = JaxKVTierDiskStore(str(tmp_path / "jax"), fsync=False)
    pst = KVTierDiskStore(str(tmp_path / "port"), fsync=False)
    jst.write("rec", payload)
    pst.write("rec", payload)
    with open(jst.path("rec"), "rb") as a, open(pst.path("rec"), "rb") as b:
        assert a.read() == b.read()
    src, dst = (jst, pst) if writer == "jax" else (pst, jst)
    reader = type(dst)(src.directory, fsync=False)
    assert reader.read("rec") == payload


# ---------------------------------------------------------------------------
# close plane: drain barrier, idempotence, defaults
# ---------------------------------------------------------------------------
def test_drain_writes_every_host_copy_to_disk(tmp_path):
    eng = _engine(_tier(tmp_path, budget=256))
    eng.submit(_p1(), max_new_tokens=4)
    eng.run_until_idle()
    for _ in range(IDLE + 3):
        eng.step()
    tier = eng.kv_tier
    assert tier.parked_pages >= 2 and tier._host_pages > 0
    n = tier.drain()
    assert n >= 2 and tier._host_pages == 0
    files = [f for f in os.listdir(tmp_path) if f.endswith(".page")]
    assert len(files) == tier.parked_pages
    eng.close()
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".page")]
    assert eng.pool.refs == {}


def test_close_is_idempotent_with_parked_sessions(tmp_path):
    eng = _engine(_tier(tmp_path, budget=1))
    eng.submit(_p1(), max_new_tokens=4)
    eng.run_until_idle()
    for _ in range(IDLE + 3):
        eng.step()
    assert eng.kv_tier.parked_pages >= 2
    eng.close()
    eng.close()
    assert eng.kv_tier.parked_pages == 0
    assert eng.pool.refs == {}


def test_tier_off_by_default_builds_no_tier():
    eng = _engine({})
    assert eng.kv_tier is None
    eng.close()


@pytest.mark.parametrize("kv,msg", [
    ("nope", "must be a dict"),
    ({"bogus": 1}, "unknown key"),
    ({"idle_park_ticks": -1}, "int >= 0"),
    ({"idle_park_ticks": True}, "int >= 0"),
    ({"host_budget_pages": -2}, "int >= 0"),
    ({"disk_dir": 7}, "string"),
    ({"fsync": "yes"}, "bool"),
], ids=["dict", "unknown", "neg_ticks", "bool_ticks", "neg_budget",
        "dir_type", "fsync_type"])
def test_kv_tier_config_validation(kv, msg):
    with pytest.raises(DeepSpeedConfigError, match=msg):
        ServeEngine(_model_params()[0], _serve_cfg(kv_tier=kv),
                    device="cpu")


def test_kv_tier_requires_the_paged_plane():
    cfg = {"serving": {"slots": 2, "max_seq_len": 32, "prefill_len": 16,
                       "kv_tier": {"idle_park_ticks": 2}}}
    with pytest.raises(DeepSpeedConfigError, match="page_len"):
        ServeEngine(_model_params()[0], cfg, device="cpu")


# ---------------------------------------------------------------------------
# the port against the JAX engine, tier on
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def weights():
    jcfg = JaxConfig(**TINY, remat=None, attn_impl="dense")
    tree = jax.tree.map(np.asarray, JaxModel(jcfg).init(
        jax.random.PRNGKey(0)))
    return jcfg, tree


def _sessions(eng):
    """Four conversations over two shared templates: turn 1, an idle gap
    that parks them, turn 2 extending each.  Returns the streams, the
    tier's counters and one parked page's payload."""
    tmpl = [_tokens(16, seed=1), _tokens(16, seed=2)]
    first = [tmpl[i % 2] + _tokens(3 + i, seed=10 + i) for i in range(4)]
    r1 = [eng.submit(p, max_new_tokens=4) for p in first]
    eng.run_until_idle()
    for _ in range(4 * (IDLE + 3)):
        eng.step()
    t = eng.kv_tier
    payload = max((r for r in t._full.values() if r.payload is not None),
                  key=lambda r: r.stamp).payload
    r2 = [eng.submit(p + _tokens(5, seed=20 + i), max_new_tokens=4)
          for i, p in enumerate(first)]
    eng.run_until_idle()
    out = {"streams": [list(r.tokens) for r in r1 + r2],
           "errors": [r.error for r in r1 + r2],
           "shared": [r.shared_len for r in r2],
           "counts": (t.parked_pages_total, t.resumed_pages_total,
                      t.resumed_sessions_total, t.spill_bytes,
                      t.fetch_bytes, t.corrupt_total)}
    eng.close()
    out["refs_after_close"] = dict(eng.pool.refs)
    return out, payload


def test_tier_matches_jax_engine(weights, tmp_path):
    """The port and the JAX engine on the same fp32 weights, tier on with
    a one-page host budget over a disk tier: equal streams, equal shared
    prefixes, equal park/resume/byte counts; a parked page's payload has
    the JAX engine's layout, its values within 1e-4."""
    jcfg, tree = weights
    cfg = _serve_cfg(**_tier(None, budget=1))
    ours, opay = _sessions(ServeEngine(
        GPT2Model(GPT2Config(**TINY, remat=None, attn_impl="dense")),
        {"serving": {**cfg["serving"], "kv_tier": {
            **cfg["serving"]["kv_tier"], "disk_dir": str(tmp_path / "p")}}},
        params=params_from_numpy(tree), device="cpu"))
    ref, jpay = _sessions(JaxServeEngine(
        JaxModel(jcfg),
        {"serving": {**cfg["serving"], "kv_tier": {
            **cfg["serving"]["kv_tier"], "disk_dir": str(tmp_path / "j")}}},
        params=tree))
    assert ours["errors"] == [None] * 8 and ref["errors"] == [None] * 8
    assert ours["refs_after_close"] == {} == ref["refs_after_close"]
    assert ours["counts"] == ref["counts"]
    assert ours["counts"][0] >= 4 and ours["counts"][1] >= 4
    assert ours["shared"] == ref["shared"] and min(ours["shared"]) >= 16
    assert ours["streams"] == ref["streams"]
    # the payloads hold the same layout; their fp32 values agree to 1e-4
    assert len(opay) == len(jpay)
    np.testing.assert_allclose(np.frombuffer(opay, np.float32),
                               np.frombuffer(jpay, np.float32), atol=1e-4,
                               rtol=0)

