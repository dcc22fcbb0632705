"""Port parity for checkpointing: ``deepspeed_tpu_torch``'s save/load
against the JAX package's on-disk format, on the CPU.

Across the two packages (GPT-2 with Adam, BERT with LAMB; dropout 0,
since the two frameworks draw different dropout masks from the same seed):
a checkpoint either one writes loads into the other and the fp32
trajectory continues within ``tests/test_torch_train.py``'s fp32
tolerance (1e-4 relative per step's loss) of the writer's own
continuation; both write the same manifests (keys, ``leaf_{i:05d}``
names, shapes, logical dtypes) for the same state, with equal CRCs for
every leaf carried without arithmetic; the port's key order is
``jax.tree_util.tree_flatten_with_path``'s; bf16 leaves cross both ways
bit for bit.

On the port alone, the single-device cases of ``tests/test_checkpointing
.py``: an exact round trip (bitwise continuation), the fp16 scaler, a
module-only load, ``latest`` and client state, missing and partial tags,
LAMB's moments, lr-schedule continuity and the size-preserving reshape.
Its ZeRO-stage and dp-resize cases are in
``tests/test_torch_zero_checkpoint.py``; its pipeline and offload cases
wait for ROADMAP.md queue 1 items 10 and 12.  A sharded (multi-process)
manifest entry loads, merged from its shard files.
"""
import json
import os

import numpy as np
import pytest
import jax
import torch

from deepspeed_tpu.config import DeepSpeedConfig as JaxDeepSpeedConfig
from deepspeed_tpu.models.bert import (BertConfig as JaxBertConfig,
                                       BertModel as JaxBertModel)
from deepspeed_tpu.models.gpt2 import (GPT2Config as JaxConfig,
                                       GPT2Model as JaxModel)
from deepspeed_tpu.parallel import build_mesh
from deepspeed_tpu.runtime import checkpointing as jax_ckpt
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JaxEngine

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.models.bert import BertConfig, BertModel
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.runtime import checkpointing as ckpt
from deepspeed_tpu_torch.runtime.module import TrainModule
from deepspeed_tpu_torch.runtime.resilience import (CheckpointCorruptError,
                                                    CheckpointMissingError)

from simple_model import base_config, random_batches

GPT2_SMALL = dict(vocab_size=256, n_positions=64, d_model=128, n_layer=2,
                  n_head=2)
BERT_SMALL = dict(vocab_size=96, hidden_size=64, num_hidden_layers=2,
                  num_attention_heads=2, intermediate_size=128,
                  max_position_embeddings=64, hidden_dropout_prob=0.0,
                  attention_probs_dropout_prob=0.0)
T = 32
TOL = 1e-4          # fp32 loss, relative (tests/test_torch_train.py)


# ---------------------------------------------------------------------------
# the two packages' engines on the same numpy params
# ---------------------------------------------------------------------------
def _gpt2_batch(step):
    return np.random.default_rng(step % 3).integers(0, 256, (4, T + 1),
                                                    np.int32)


def _bert_batch(step):
    rng = np.random.default_rng(step % 3)
    ids = rng.integers(1, 96, (4, T)).astype(np.int32)
    mask = np.ones((4, T), np.int32)
    mask[0, T - 9:] = 0
    ids = np.where(mask > 0, ids, 0).astype(np.int32)
    labels = np.where((rng.random((4, T)) < 0.15) & (mask > 0), ids,
                      -100).astype(np.int32)
    return {"input_ids": ids, "attention_mask": mask,
            "token_type_ids": (np.arange(T)[None] >= T // 2).astype(
                np.int32).repeat(4, 0),
            "masked_lm_labels": labels,
            "next_sentence_label": rng.integers(0, 2, 4).astype(np.int32)}


def _config(family, precision_="fp32"):
    opt = ({"type": "Adam", "params": {"lr": 3e-3, "weight_decay": 0.01}}
           if family == "gpt2" else
           {"type": "Lamb", "params": {"lr": 3e-3, "weight_decay": 0.01,
                                       "max_coeff": 5.0,
                                       "min_coeff": 0.05}})
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 2,
           "steps_per_print": 10 ** 9,
           "gradient_clipping": 0.5,
           "optimizer": opt,
           "scheduler": {"type": "WarmupLR",
                         "params": {"warmup_num_steps": 8,
                                    "warmup_max_lr": 3e-3}}}
    if precision_ == "bf16":
        cfg["bf16"] = {"enabled": True}
    return cfg


def _pair(family, precision_="fp32", seed=0):
    """(JAX engine, port engine, batch fn) on the same numpy params."""
    if family == "gpt2":
        jmodel = JaxModel(JaxConfig(**GPT2_SMALL, remat=None,
                                    attn_impl="dense"))
        model = GPT2Model(GPT2Config(**GPT2_SMALL, remat=None))
        batch = _gpt2_batch
    else:
        jmodel = JaxBertModel(JaxBertConfig(**BERT_SMALL, attn_impl="dense",
                                            remat=None))
        model = BertModel(BertConfig(**BERT_SMALL))
        batch = _bert_batch
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    cfg = _config(family, precision_)
    jeng = JaxEngine(jmodel, JaxDeepSpeedConfig(cfg, world_size=1),
                     mesh=build_mesh(pp=1, dp=1, tp=1,
                                     devices=[jax.devices()[0]]),
                     params=tree)
    eng, *_ = dst.initialize(model=model, config=cfg, params=tree,
                             device="cpu")
    return jeng, eng, batch


def _manifest(path, plane):
    with open(os.path.join(path, plane, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_crosses_packages(direction, tmp_path):
    """The writer trains 3 fp32 GPT-2 steps and saves; the reader — a
    fresh engine of the other package on other params — loads and trains
    5 more steps: every loss within 1e-4 (relative) of the writer's own
    continuation, and the counters and lr come across."""
    jeng, eng, batch = _pair("gpt2")
    writer = jeng if direction == "jax_to_port" else eng
    for step in range(3):
        writer.train_batch(batch(step))
    writer.save_checkpoint(str(tmp_path), tag="t3")
    ref = [float(np.asarray(writer.train_batch(batch(s))))
           for s in range(3, 8)]
    # the reader starts from other weights: the load must replace them
    jfresh, fresh, _ = _pair("gpt2", seed=7)
    reader = fresh if direction == "jax_to_port" else jfresh
    path, client = reader.load_checkpoint(str(tmp_path))
    assert path.endswith("t3") and client == {}
    assert reader.global_steps == 3
    got = [float(np.asarray(reader.train_batch(batch(s))))
           for s in range(3, 8)]
    for s, (a, b) in enumerate(zip(got, ref)):
        assert abs(a - b) <= TOL * abs(b), (s, a, b)
    assert abs(reader.get_lr() - writer.get_lr()) <= 1e-9
    jeng.close()
    jfresh.close()


@pytest.mark.parametrize("family,precision_", [("gpt2", "bf16"),
                                               ("bert", "fp32")],
                         ids=["gpt2_adam_bf16", "bert_lamb_fp32"])
def test_manifests_match_jax(family, precision_, tmp_path):
    """The same initial state saved by both packages: equal manifest keys,
    file names, shapes and logical dtypes in every plane; equal CRCs for
    every leaf carried without arithmetic (all but the two PRNG keys,
    which the packages seed differently); equal meta keys.  The
    optimizer count's dtype is the one a JAX-written manifest records."""
    jeng, eng, _ = _pair(family, precision_)
    jeng.save_checkpoint(str(tmp_path / "jax"), tag="t")
    eng.save_checkpoint(str(tmp_path / "port"), tag="t")
    for plane in ("model", "optim"):
        jm = _manifest(tmp_path / "jax" / "t", plane)
        pm = _manifest(tmp_path / "port" / "t", plane)
        assert list(jm) == list(pm), plane
        for key, je in jm.items():
            pe = pm[key]
            assert (pe["file"], pe["shape"], pe["dtype"], pe["nbytes"]) \
                == (je["file"], je["shape"], je["dtype"], je["nbytes"]), key
            if key not in ("['rng']", "['data_rng']"):
                assert pe["crc32"] == je["crc32"], key
    count = _manifest(tmp_path / "jax" / "t", "optim")[
        "['opt_state'].count"]
    assert count["dtype"] == "int32" and count["shape"] == []
    if precision_ == "bf16":
        assert {e["dtype"] for e in _manifest(
            tmp_path / "port" / "t", "model").values()} == {"bfloat16"}
    with open(tmp_path / "jax" / "t" / "meta.json") as f:
        jmeta = json.load(f)
    with open(tmp_path / "port" / "t" / "meta.json") as f:
        pmeta = json.load(f)
    assert set(jmeta) == set(pmeta)
    assert set(jmeta["manifest_digests"]) == set(pmeta["manifest_digests"])
    jeng.close()


@pytest.mark.parametrize("family", ["gpt2", "bert"],
                         ids=["gpt2_adam", "bert_lamb"])
def test_leaf_order_matches_tree_flatten_with_path(family):
    """The port's flatten of its optimizer and model planes gives the key
    strings and leaf order of ``jax.tree_util.tree_flatten_with_path``
    over the JAX engine's planes — the order that names the
    ``leaf_{i:05d}`` files."""
    from deepspeed_tpu.runtime import precision as jax_precision
    jeng, eng, _ = _pair(family)
    jmaster, jopt = jeng._canonical_state()
    jplanes = {"optim": {"master_params": jmaster, "opt_state": jopt,
                         "scaler": jeng.state.scaler, "rng": jeng.state.rng,
                         "data_rng": jeng._data_rng},
               "model": {"module": jax_precision.cast_to_compute(
                   jmaster, jeng.compute_dtype)}}
    master, opt = eng._canonical_state()
    planes = {"optim": ckpt._optim_plane(eng, master, opt),
              "model": {"module": master}}
    for name, jtree in jplanes.items():
        want = [(jax.tree_util.keystr(p), tuple(np.shape(x)))
                for p, x in jax.tree_util.tree_flatten_with_path(jtree)[0]]
        got = [(k, tuple(x.shape))
               for k, x in ckpt.tree_flatten_with_keys(planes[name])]
        assert got == want, name
        assert len(got) > 10, name
    keys = [k for k, _ in ckpt.tree_flatten_with_keys(planes["optim"])]
    assert keys[0] == "['data_rng']" and "['rng']" in keys
    assert any(k.startswith("['opt_state'].mu['") for k in keys)
    jeng.close()


def test_bf16_leaves_cross_both_ways(tmp_path):
    """A bf16 tree written by either package's ``save_tree`` reads back
    in the other's ``load_tree`` bit for bit (uint16 bit patterns with
    logical dtype ``bfloat16``; torch rebuilds them, the JAX package uses
    ml_dtypes)."""
    import ml_dtypes
    rng = np.random.default_rng(0)
    vals = rng.standard_normal((3, 5)).astype(np.float32)
    t = torch.from_numpy(vals).to(torch.bfloat16)
    ckpt.save_tree(str(tmp_path / "port"), {"w": t, "s": torch.zeros(())})
    got = jax_ckpt.load_tree(str(tmp_path / "port"), {
        "w": np.zeros((3, 5), ml_dtypes.bfloat16),
        "s": np.zeros((), np.float32)})
    np.testing.assert_array_equal(
        np.asarray(got["w"]).view(np.uint16),
        t.view(torch.int16).numpy().view(np.uint16))
    jax_ckpt.save_tree(str(tmp_path / "jax"),
                       {"w": vals.astype(ml_dtypes.bfloat16)})
    back = ckpt.load_tree(str(tmp_path / "jax"),
                          {"w": torch.zeros((3, 5), dtype=torch.bfloat16)})
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16),
                       t.view(torch.int16))


def test_prng_seed_words_round_trip():
    """A 64-bit host seed travels as the uint32[2] words of a JAX key
    (high word first, as ``PRNGKey`` lays out a seed) and back."""
    for seed in (0, 1, 2 ** 32 + 5, 2 ** 64 - 1):
        key = ckpt.seed_to_key(seed)
        assert key.dtype == np.uint32 and key.shape == (2,)
        assert ckpt.key_to_seed(key) == seed
    np.testing.assert_array_equal(
        ckpt.seed_to_key(7), np.asarray(jax.random.PRNGKey(7)))


def test_sharded_manifest_entry_raises_naming_item_9(tmp_path):
    """A leaf a multi-process run wrote as per-process shards (queue 1
    item 9, now ported) loads on one process, merged from the shard
    files its index files list; with the index files gone the load
    raises ``CheckpointCorruptError``."""
    ckpt.save_tree(str(tmp_path), {"w": torch.ones(4)})
    mpath = tmp_path / "manifest.json"
    m = json.loads(mpath.read_text())
    m["['w']"] = {"sharded": True, "leaf": 0, "dtype": "float32",
                  "store_dtype": "float32", "shape": [4]}
    mpath.write_text(json.dumps(m))
    for proc, (a, b) in enumerate(((0, 3), (3, 4))):
        piece = np.arange(a, b, dtype=np.float32)
        np.save(tmp_path / f"leaf_00000.proc{proc}_0.npy", piece)
        (tmp_path / f"leaf_00000.proc{proc}.json").write_text(json.dumps(
            [{"file": f"leaf_00000.proc{proc}_0.npy", "index": [[a, b]],
              "crc32": ckpt._crc32_arr(piece), "nbytes": piece.nbytes}]))
    got = ckpt.load_tree(str(tmp_path), {"w": torch.zeros(4)})["w"]
    assert torch.equal(got, torch.arange(4, dtype=torch.float32))
    for proc in (0, 1):
        (tmp_path / f"leaf_00000.proc{proc}.json").unlink()
    with pytest.raises(CheckpointCorruptError, match="shard index"):
        ckpt.load_tree(str(tmp_path), {"w": torch.zeros(4)})


# ---------------------------------------------------------------------------
# tests/test_checkpointing.py's single-device cases, on the port
# ---------------------------------------------------------------------------
HIDDEN = 16


class SimpleModel(TrainModule):
    """tests/simple_model.py's linear stack + MSE, in torch."""

    def __init__(self, hidden_dim: int = HIDDEN, nlayers: int = 2):
        self.hidden_dim = hidden_dim
        self.nlayers = nlayers

    def init(self, seed, device=None):
        rng = np.random.default_rng(seed)
        params = {}
        for i in range(self.nlayers):
            params[f"w{i}"] = torch.tensor(
                rng.standard_normal((self.hidden_dim, self.hidden_dim))
                * 0.1, dtype=torch.float32, device=device)
            params[f"b{i}"] = torch.zeros(self.hidden_dim, device=device)
        return params

    def loss_fn(self, params, batch, rng, train=True):
        x, y = batch
        h = x
        for i in range(self.nlayers):
            h = h @ params[f"w{i}"].to(h.dtype) + params[f"b{i}"].to(h.dtype)
            if i < self.nlayers - 1:
                h = torch.relu(h)
        return torch.mean((h.float() - y.float()) ** 2)


def _engine(precision="bf16", seed=0, **over):
    eng, *_ = dst.initialize(
        model=SimpleModel(), seed=seed, device="cpu",
        config=base_config(micro_bs=2, grad_acc=1, stage=0,
                           precision=precision, **over))
    return eng


def _train(eng, steps=3, seed=0):
    return [float(eng.train_batch(b)) for b in random_batches(
        int(eng.train_batch_size), HIDDEN, num_batches=steps, seed=seed)]


def _state_equal(a, b):
    fa, fb = ckpt.tree_flatten_with_keys(a), ckpt.tree_flatten_with_keys(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y)), k


def test_roundtrip_exact(tmp_path):
    """ZeRO stage 0: a fresh engine of another seed loads the state
    bitwise (master, moments, count, the PRNG seeds) and continues with
    bitwise-equal losses."""
    eng = _engine()
    _train(eng, steps=3)
    eng.save_checkpoint(str(tmp_path), tag="t3")
    eng2 = _engine(seed=123)
    path, _ = eng2.load_checkpoint(str(tmp_path), tag="t3")
    assert path is not None
    _state_equal(eng.state.master_params, eng2.state.master_params)
    _state_equal(eng._canonical_state()[1], eng2._canonical_state()[1])
    assert eng2.global_steps == 3
    assert (eng2._rng, eng2._data_rng) == (eng._rng, eng._data_rng)
    assert _train(eng, steps=2, seed=7) == _train(eng2, steps=2, seed=7)


def test_fp16_scaler_restored(tmp_path):
    over = {"fp16": {"enabled": True, "initial_scale_power": 8}}
    eng = _engine(precision="fp16", **over)
    _train(eng, steps=2)
    scale_before = eng.get_loss_scale()
    eng.save_checkpoint(str(tmp_path))
    eng2 = _engine(precision="fp16", seed=9, **over)
    eng2.load_checkpoint(str(tmp_path))
    assert eng2.get_loss_scale() == scale_before
    assert eng2.get_skipped_steps() == eng.get_skipped_steps()


def test_module_only_load(tmp_path):
    eng = _engine()
    _train(eng, steps=3)
    eng.save_checkpoint(str(tmp_path), tag="m")
    eng2 = _engine(seed=77)
    path, _ = eng2.load_checkpoint(str(tmp_path), tag="m",
                                   load_module_only=True)
    assert path is not None
    # weights match only to compute-dtype precision (bf16-cast restore)
    for k, a in eng.state.master_params.items():
        np.testing.assert_allclose(
            a.numpy(), eng2.state.master_params[k].numpy(), atol=1e-2,
            rtol=1e-2)
    # optimizer state re-initialized, counters restored
    assert int(eng2.state.opt_state.count) == 0
    assert all(float(m.abs().max()) == 0 for m in eng2.state.opt_state.mu)
    assert eng2.global_steps == 3


def test_latest_tag_and_client_state(tmp_path):
    eng = _engine()
    _train(eng, steps=1)
    eng.save_checkpoint(str(tmp_path), tag="a", client_state={"epoch": 1})
    _train(eng, steps=1)
    eng.save_checkpoint(str(tmp_path), tag="b", client_state={"epoch": 2})
    eng2 = _engine(seed=42)
    path, client = eng2.load_checkpoint(str(tmp_path))  # tag=None → latest
    assert path.endswith("b")
    assert client == {"epoch": 2}
    assert eng2.global_steps == 2


def test_missing_checkpoint_returns_none(tmp_path):
    """tag=None on an empty dir is a fresh run → (None, None); an
    explicit tag that does not exist or has no meta.json raises, naming
    it."""
    eng = _engine()
    path, client = eng.load_checkpoint(str(tmp_path))
    assert path is None and client is None
    with pytest.raises(CheckpointMissingError, match="nope"):
        eng.load_checkpoint(str(tmp_path), tag="nope")
    (tmp_path / "half").mkdir()
    (tmp_path / "half" / "junk.npy").write_bytes(b"x")
    with pytest.raises(CheckpointCorruptError, match="half"):
        eng.load_checkpoint(str(tmp_path), tag="half")


def test_lamb_optimizer_state_roundtrip(tmp_path):
    opt = {"type": "lamb", "params": {"lr": 1e-2}}
    eng = _engine(optimizer=opt)
    _train(eng, steps=3)
    eng.save_checkpoint(str(tmp_path), tag="t")
    eng2 = _engine(optimizer=opt, seed=99)
    eng2.load_checkpoint(str(tmp_path), tag="t")
    assert type(eng2.state.opt_state).__name__ == "FusedLambState"
    _state_equal(eng.state.master_params, eng2.state.master_params)
    _state_equal(eng.state.opt_state.mu, eng2.state.opt_state.mu)
    _state_equal(eng.state.opt_state.nu, eng2.state.opt_state.nu)
    assert int(eng2.state.opt_state.count) == 3


def test_lr_schedule_continuity_across_restore(tmp_path):
    """The schedule is a pure function of the restored step count: the
    post-restore lr continues where the saved run left off."""
    sched = {"scheduler": {"type": "WarmupLR",
                           "params": {"warmup_min_lr": 0.0,
                                      "warmup_max_lr": 0.01,
                                      "warmup_num_steps": 10}}}
    eng = _engine(**sched)
    _train(eng, steps=4)
    lr_before = float(eng.last_metrics.lr)
    eng.save_checkpoint(str(tmp_path), tag="t")
    eng2 = _engine(seed=7, **sched)
    eng2.load_checkpoint(str(tmp_path), tag="t")
    _train(eng2, steps=1, seed=42)
    assert lr_before < float(eng2.last_metrics.lr) < 0.01


def test_size_preserving_layout_reshape_on_load(tmp_path):
    """A master leaf whose dims were merged on disk (element count and
    row-major order unchanged, manifest and meta digest rewritten to
    match) loads via a logged reshape and continues bitwise."""
    import hashlib
    eng = _engine(seed=3)
    _train(eng, 2)
    eng.save_checkpoint(str(tmp_path), tag="t0")
    batch = next(iter(random_batches(int(eng.train_batch_size), HIDDEN,
                                     num_batches=1, seed=9)))
    ref = float(eng.train_batch(batch))
    plane = tmp_path / "t0" / "optim"
    manifest = json.loads((plane / "manifest.json").read_text())
    victim = manifest["['master_params']['w0']"]
    fpath = plane / victim["file"]
    np.save(fpath, np.load(fpath).reshape(-1))  # [a, b] -> [a*b]
    victim["shape"] = [int(np.prod(victim["shape"]))]
    data = json.dumps(manifest, indent=1).encode()
    (plane / "manifest.json").write_bytes(data)
    meta = json.loads((tmp_path / "t0" / "meta.json").read_text())
    meta["manifest_digests"]["optim"] = hashlib.sha256(data).hexdigest()
    (tmp_path / "t0" / "meta.json").write_text(json.dumps(meta))
    e2 = _engine(seed=11)
    path, _ = e2.load_checkpoint(str(tmp_path), tag="t0")
    assert path is not None
    assert tuple(e2.state.master_params["w0"].shape) == (HIDDEN, HIDDEN)
    assert float(e2.train_batch(batch)) == ref
