"""The port stands alone: no module of ``deepspeed_tpu_torch/`` (nor
``chip_smoke.py``) imports jax or the JAX package, every module imports
with jax made unimportable, the serving engine runs on the card unless
told otherwise, and every config knob whose path is not ported raises
instead of being silently ignored.
"""
import ast
import hashlib
import json
import os
import subprocess
import sys

import pytest
import torch

import deepspeed_tpu_torch
import deepspeed_tpu_torch.inference.engine as engine_mod
from deepspeed_tpu_torch.inference import ServeEngine
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "deepspeed_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "deepspeed_tpu")


def _package_files():
    out = []
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _port_files():
    return [os.path.join(REPO, "chip_smoke.py"),
            os.path.join(REPO, "profile_serve_torch.py"),
            os.path.join(REPO, "profile_train_torch.py"),
            os.path.join(REPO, "profile_decode_torch.py")] + _package_files()


def _module_names():
    names = []
    for path in _package_files():
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        names.append(rel[:-len(".__init__")] if rel.endswith("__init__")
                     else rel)
    return names


def test_no_file_imports_jax_or_the_jax_package():
    bad = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                if m.split(".")[0] in FORBIDDEN:
                    bad.append(f"{os.path.relpath(path, REPO)}:"
                               f"{node.lineno} imports {m}")
    assert len(_port_files()) > 15
    assert not bad, bad


def test_every_module_imports_with_jax_unimportable():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'deepspeed_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {_module_names()!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr


TINY = GPT2Config(vocab_size=64, n_positions=32, d_model=64, n_layer=1,
                  n_head=1)


def test_engine_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(GPT2Model(TINY), {})
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(GPT2Model(TINY), {}, device="cuda")
    eng = ServeEngine(GPT2Model(TINY), {"serving": {"slots": 1}},
                      device="cpu")
    assert eng.cache["k"].device.type == "cpu"
    eng.close()


@pytest.mark.parametrize("extra,item", [
    # paged KV, KV tiering, greedy speculation and quantized serving are
    # ported; the unported arms beside them (sampling on the tiered pool,
    # LoRA on the paged pool, sampling) still raise.  The ids name the
    # ported block each case rides on.
    ({"serving": {"page_len": 8, "kv_tier": {"idle_park_ticks": 3},
                  "temperature": 0.7}}, "7.3"),
    ({"serving": {"speculate_k": 2, "temperature": 0.7}}, "7.3"),
    ({"serving": {"temperature": 0.7}}, "7.3"),
    ({"serving": {"page_len": 8, "quantization": {"weights": "int8"},
                  "lora": {"rank": 4}}}, "7.5"),
    ({"telemetry": {"enabled": True}}, "item 5"),
], ids=["page_len", "speculate_k", "temperature", "quantization",
        "telemetry"])
def test_unported_knob_raises_naming_its_roadmap_item(extra, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md.*{item}"):
        ServeEngine(GPT2Model(TINY), extra, device="cpu")


def test_unported_paged_only_knobs_and_mesh_raise():
    """kv_tier and lora need page_len > 0 to parse at all; on the paged
    engine (ported, chunked prefill and the KV tier included) lora raises
    naming its item, and a mesh raises before anything else."""
    extra = {"lora": {"rank": 4}}
    cfg = engine_mod._ServeConfigView({"serving": {"page_len": 8,
                                                   **extra}})
    with pytest.raises(NotImplementedError, match="7.5"):
        engine_mod._refuse_unported(cfg)
    with pytest.raises(NotImplementedError, match="7.5"):
        ServeEngine(GPT2Model(TINY), {"serving": {"page_len": 8, **extra}},
                    device="cpu")
    eng = ServeEngine(GPT2Model(TINY), {"serving": {
        "page_len": 8, "prefill_chunk_len": 4,
        "kv_tier": {"idle_park_ticks": 3}}}, device="cpu")
    assert eng.paged and eng.prefill_chunk_len == 4
    assert eng.kv_tier is not None and eng.kv_tier.idle_park_ticks == 3
    eng.close()
    with pytest.raises(NotImplementedError, match="item 9"):
        ServeEngine(GPT2Model(TINY), {}, mesh=object(), device="cpu")


TRAIN_BASE = {"train_micro_batch_size_per_gpu": 1,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}


def test_initialize_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.initialize(model=GPT2Model(TINY),
                                       config=TRAIN_BASE)
    with pytest.raises(RuntimeError, match="CUDA"):
        deepspeed_tpu_torch.initialize(model=GPT2Model(TINY),
                                       config=TRAIN_BASE, device="cuda")
    eng, *_ = deepspeed_tpu_torch.initialize(model=GPT2Model(TINY),
                                             config=TRAIN_BASE,
                                             device="cpu")
    assert eng.state.master_params["wte"].device.type == "cpu"
    eng.close()


@pytest.mark.parametrize("extra,item", [
    ({"zero_optimization": {"stage": 2}, "bf16": {"enabled": True}},
     "item 9"),
    ({"zero_optimization": {"stage": 2, "cpu_offload": True},
      "bf16": {"enabled": True}}, "item 12"),
    ({"pipeline": {"stages": 2}}, "item 10"),
    ({"optimizer": {"type": "OneBitAdam", "params": {}},
      "bf16": {"enabled": True}}, "item 11"),
    # LAMB and PLD are ported; their unported arms (examples/
    # bert_pretrain.py's ZeRO stage 1, the pipelined BERT) still raise
    ({"optimizer": {"type": "Lamb", "params": {}},
      "zero_optimization": {"stage": 1}, "fp16": {"enabled": True}},
     "item 9"),
    ({"sparse_gradients": True}, "item 11"),
    ({"progressive_layer_drop": {"enabled": True},
      "pipeline": {"stages": 2}}, "item 10"),
    ({"telemetry": {"enabled": True}}, "item 5"),
    ({"tensorboard": {"enabled": True}}, "item 5"),
    # checkpointing is ported; a checkpoint of a ZeRO-partitioned state
    # waits for item 9
    ({"checkpoint": {"async_save": True, "sigterm_save": True},
      "zero_optimization": {"stage": 2}, "bf16": {"enabled": True}},
     "item 9"),
], ids=["zero", "offload", "pipeline", "onebit", "lamb", "sparse_grads",
        "pld", "telemetry", "tensorboard", "checkpoint"])
def test_unported_training_knob_raises_naming_its_roadmap_item(extra, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md.*{item}"):
        deepspeed_tpu_torch.initialize(model=GPT2Model(TINY),
                                       config={**TRAIN_BASE, **extra},
                                       device="cpu")


def test_unported_training_paths_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="item 9"):
        deepspeed_tpu_torch.initialize(model=GPT2Model(TINY),
                                       config=TRAIN_BASE, mesh=object(),
                                       device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        GPT2Config(stream_scan=True)
    eng, *_ = deepspeed_tpu_torch.initialize(model=GPT2Model(TINY),
                                             config=TRAIN_BASE,
                                             device="cpu")
    # a checkpoint a multi-process run wrote (a sharded leaf) raises
    eng.save_checkpoint(str(tmp_path), tag="t")
    plane = tmp_path / "t" / "optim"
    manifest = json.loads((plane / "manifest.json").read_text())
    manifest["['master_params']['wte']"] = {
        "sharded": True, "leaf": 0, "dtype": "float32",
        "store_dtype": "float32", "shape": [64, 64]}
    data = json.dumps(manifest).encode()
    (plane / "manifest.json").write_bytes(data)
    meta = json.loads((tmp_path / "t" / "meta.json").read_text())
    meta["manifest_digests"]["optim"] = hashlib.sha256(data).hexdigest()
    (tmp_path / "t" / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(NotImplementedError, match="item 9"):
        eng.load_checkpoint(str(tmp_path), tag="t")
    model = GPT2Model(GPT2Config(**{**TINY.__dict__, "attn_impl": "ring"}))
    with pytest.raises(NotImplementedError, match="item 11"):
        model.loss_fn(model.init(0), torch.zeros(1, 5, dtype=torch.long),
                      None, train=False)
