"""The port stands alone: no module of ``deepspeed_tpu_torch/`` (nor
``chip_smoke.py``) imports jax or the JAX package, every module imports
with jax made unimportable, the serving engine runs on the card unless
told otherwise, and every config knob or call whose path is not ported
raises instead of being silently ignored.
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


def test_parallel_modules_run_with_jax_unimportable():
    """The data/tensor-parallel modules (``parallel/``, ``runtime/zero``)
    import with jax made unimportable, and a one-rank gloo group trains a
    ZeRO-3 step and saves and loads its checkpoint through them."""
    code = ("import sys, os, tempfile\n"
            "for m in ('jax', 'jaxlib', 'deepspeed_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import torch\n"
            "from deepspeed_tpu_torch.parallel import (build_mesh, "
            "collectives, distributed, mesh, topology, init_distributed)\n"
            "from deepspeed_tpu_torch.runtime import zero\n"
            "import deepspeed_tpu_torch as dst\n"
            "from deepspeed_tpu_torch.models.gpt2 import GPT2Config, "
            "GPT2Model\n"
            "d = tempfile.mkdtemp()\n"
            "init_distributed(device='cpu', init_method='file://' + d + "
            "'/store', rank=0, world_size=1)\n"
            "cfg = {'train_micro_batch_size_per_gpu': 1, 'bf16': "
            "{'enabled': True}, 'zero_optimization': {'stage': 3}, "
            "'optimizer': {'type': 'Adam', 'params': {'lr': 1e-3}}}\n"
            "eng, *_ = dst.initialize(model=GPT2Model(GPT2Config("
            "vocab_size=64, n_positions=16, d_model=32, n_layer=2, "
            "n_head=2)), config=cfg, device='cpu')\n"
            "assert not eng.mesh.is_local and eng.zero_stage == 3\n"
            "loss = eng.train_batch(torch.zeros(1, 9, dtype=torch.long))\n"
            "eng.save_checkpoint(d, tag='t')\n"
            "eng.load_checkpoint(d, tag='t')\n"
            "print('ok', float(loss))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr


def test_serve_mesh_offload_and_prefetch_run_with_jax_unimportable():
    """The modules this slice adds (``runtime/offload.py``,
    ``runtime/prefetch.py``, ``ops/cpu_adam.py``, ``ops/op_builder.py``)
    and the serving mesh run with jax made unimportable: a one-rank gloo
    group serves on a mesh, and the host offload tier trains from a
    prefetched loader."""
    code = ("import sys, tempfile\n"
            "for m in ('jax', 'jaxlib', 'deepspeed_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import numpy as np, torch\n"
            "import deepspeed_tpu_torch as dst\n"
            "from deepspeed_tpu_torch.inference import ServeEngine\n"
            "from deepspeed_tpu_torch.models.gpt2 import GPT2Config, "
            "GPT2Model\n"
            "from deepspeed_tpu_torch.parallel import build_mesh, "
            "init_distributed\n"
            "from deepspeed_tpu_torch.runtime import offload, prefetch\n"
            "from deepspeed_tpu_torch.ops import cpu_adam, op_builder\n"
            "d = tempfile.mkdtemp()\n"
            "init_distributed(device='cpu', init_method='file://' + d + "
            "'/store', rank=0, world_size=1)\n"
            "m = GPT2Model(GPT2Config(vocab_size=64, n_positions=32, "
            "d_model=32, n_layer=1, n_head=2))\n"
            "eng = ServeEngine(m, {'serving': {'slots': 2, 'max_seq_len': "
            "16, 'prefill_len': 8, 'page_len': 4}}, mesh=build_mesh(), "
            "device='cpu')\n"
            "r = eng.submit([1, 2, 3], max_new_tokens=3)\n"
            "eng.run_until_idle(); eng.close()\n"
            "assert len(r.tokens) == 3\n"
            "data = [np.arange(9) % 64 for _ in range(8)]\n"
            "cfg = {'train_micro_batch_size_per_gpu': 2, 'bf16': "
            "{'enabled': True}, 'zero_optimization': {'stage': 2, "
            "'cpu_offload': True}, 'optimizer': {'type': 'Adam', "
            "'params': {'lr': 1e-3}}}\n"
            "tr, *_ = dst.initialize(model=m, config=cfg, device='cpu', "
            "training_data=data)\n"
            "loss = tr.train_batch()\n"
            "assert tr._offload and tr._train_prefetcher is not None\n"
            "tr.close()\n"
            "print('ok', float(loss))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr


def test_disk_xla_streaming_and_lut_run_with_jax_unimportable():
    """The modules item 12's second half adds (``runtime/disk_offload.py``,
    ``runtime/offload_xla.py``) and the native LUT run with jax made
    unimportable: the disk tier and the XLA tier with parameter streaming
    and grad chunks each train a step, and ``build_lut(use_native=True)``
    equals the numpy arm."""
    code = ("import sys, tempfile\n"
            "for m in ('jax', 'jaxlib', 'deepspeed_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import numpy as np, torch\n"
            "import deepspeed_tpu_torch as dst\n"
            "from deepspeed_tpu_torch.models.gpt2 import GPT2Config, "
            "GPT2Model\n"
            "from deepspeed_tpu_torch.runtime import disk_offload, "
            "offload_xla\n"
            "from deepspeed_tpu_torch.ops.sparse_attention import "
            "sparse_self_attention as ssa\n"
            "m = GPT2Model(GPT2Config(vocab_size=64, n_positions=16, "
            "d_model=32, n_layer=2, n_head=2, stream_scan=True))\n"
            "base = {'train_micro_batch_size_per_gpu': 1, 'bf16': "
            "{'enabled': True}, 'optimizer': {'type': 'Adam', 'params': "
            "{'lr': 1e-3}}}\n"
            "d = tempfile.mkdtemp()\n"
            "for extra in ({'zero_optimization': {'stage': 2, "
            "'cpu_offload': True}, 'offload': {'tier': 'disk', "
            "'disk_dir': d}}, {'zero_optimization': {'stage': 2, "
            "'cpu_offload': True, 'offload_impl': 'xla', "
            "'param_streaming': True, 'offload_grad_chunks': 2}}):\n"
            "    eng, *_ = dst.initialize(model=m, config={**base, "
            "**extra}, device='cpu')\n"
            "    loss = eng.train_batch(torch.zeros(1, 9, dtype=torch.long))"
            "\n"
            "    assert torch.isfinite(loss)\n"
            "    eng.close()\n"
            "lay = (np.random.default_rng(0).random((2, 8, 8)) < .3)"
            ".astype(np.int32)\n"
            "a, b = ssa.build_lut(lay, use_native=True), "
            "ssa.build_lut(lay, use_native=False)\n"
            "assert all(np.array_equal(x, y) for x, y in zip(a, b))\n"
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
    # paged KV, KV tiering, speculation, sampling, quantized serving, LoRA,
    # telemetry, KV-page migration and a serving mesh (item 9) are ported:
    # each config builds alone and on a one-rank local mesh, and a mesh
    # that is not a ``parallel.Mesh`` is refused typed.  The ids name the
    # block each case rides on.
    ({"serving": {"page_len": 8, "kv_tier": {"idle_park_ticks": 3},
                  "temperature": 0.7}}, "item 9"),
    ({"serving": {"speculate_k": 2, "temperature": 0.7}}, "item 9"),
    ({"serving": {"temperature": 0.7}}, "item 9"),
    ({"serving": {"page_len": 8, "quantization": {"weights": "int8"},
                  "lora": {"rank": 4}}}, "item 9"),
    ({"telemetry": {"enabled": True}}, "item 9"),
], ids=["page_len", "speculate_k", "temperature", "quantization",
        "telemetry"])
def test_unported_knob_raises_naming_its_roadmap_item(extra, item, tmp_path):
    if "telemetry" in extra:
        extra = {"telemetry": {"enabled": True,
                               "output_path": str(tmp_path)}}
    eng = ServeEngine(GPT2Model(TINY), extra, device="cpu")
    if eng.paged:
        # KV-page migration is ported: a request with no pages held has
        # nothing to export, and a short payload list is refused typed
        with pytest.raises(RuntimeError, match="detach_kv"):
            eng.export_pages(eng.submit([1], max_new_tokens=1))
        with pytest.raises(ValueError, match="pages"):
            eng.adopt_request([1], 1, 4, None, [])
    eng.close()
    from deepspeed_tpu_torch.parallel import single_device_mesh
    eng = ServeEngine(GPT2Model(TINY), extra, mesh=single_device_mesh(),
                      device="cpu")
    assert eng.mesh is not None and item == "item 9"
    eng.close()
    with pytest.raises(TypeError, match="Mesh"):
        ServeEngine(GPT2Model(TINY), extra, mesh=object(), device="cpu")
    if "telemetry" in extra:
        assert (tmp_path / "events.jsonl").is_file()


def test_unported_paged_only_knobs_and_mesh_raise():
    """kv_tier and lora need page_len > 0 to parse at all; on the paged
    engine (chunked prefill, the KV tier and LoRA ported) a tenant's
    request serves, a ``detach_kv`` request keeps its pages for
    ``export_pages`` until ``release_detached``, and a mesh that is not a
    ``parallel.Mesh`` is refused before anything else."""
    eng = ServeEngine(GPT2Model(TINY), {"serving": {
        "page_len": 8, "prefill_chunk_len": 4, "lora": {"rank": 4},
        "kv_tier": {"idle_park_ticks": 3}}}, device="cpu")
    assert eng.paged and eng.prefill_chunk_len == 4 and eng.lora
    assert eng.kv_tier is not None and eng.kv_tier.idle_park_ticks == 3
    req = eng.submit([1, 2, 3], max_new_tokens=2, adapter_id=1)
    eng.run_until_idle()
    assert req.error is None and len(req.tokens) == 2
    det = eng.submit([1, 2, 3], max_new_tokens=1, detach_kv=True)
    eng.run_until_idle()
    held = list(det.pages)
    assert len(held) == 1 and all(eng.pool.refs.get(p) for p in held)
    assert [len(p) for p in eng.export_pages(det)] \
        == [sum(eng.page_leaf_nbytes())]
    refs = {p: eng.pool.refs[p] for p in held}
    eng.release_detached(det)
    assert det.pages is None
    assert all(eng.pool.refs.get(p, 0) == refs[p] - 1 for p in held)
    eng.close()
    with pytest.raises(TypeError, match="Mesh"):
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
    # item None: ported since (ZeRO 1-3), the config builds
    ({"zero_optimization": {"stage": 2}, "bf16": {"enabled": True}},
     None),
    # the host offload tier is ported (item 12's first half)
    ({"zero_optimization": {"stage": 2, "cpu_offload": True},
      "bf16": {"enabled": True}}, None),
    ({"pipeline": {"stages": 2}}, "item 10"),
    ({"optimizer": {"type": "OneBitAdam", "params": {}},
      "bf16": {"enabled": True}}, "item 11"),
    # LAMB and PLD are ported, examples/bert_pretrain.py's ZeRO stage 1
    # too; the pipelined BERT still raises
    ({"optimizer": {"type": "Lamb", "params": {}},
      "zero_optimization": {"stage": 1}, "fp16": {"enabled": True}},
     None),
    ({"sparse_gradients": True}, "item 11"),
    ({"progressive_layer_drop": {"enabled": True},
      "pipeline": {"stages": 2}}, "item 10"),
    # the telemetry plane and ZeRO 3 are ported, and item 12's XLA
    # offload tier (with TensorBoard and the timers on) and disk tier
    ({"telemetry": {"enabled": True}, "zero_optimization": {"stage": 3},
      "bf16": {"enabled": True}}, None),
    ({"tensorboard": {"enabled": True}, "wall_clock_breakdown": True,
      "zero_optimization": {"stage": 2, "cpu_offload": True,
                            "offload_impl": "xla"},
      "bf16": {"enabled": True}}, None),
    # checkpointing of a ZeRO-partitioned state is ported (across
    # processes async and SIGTERM saves are single-controller, as in the
    # JAX engine: tested on 2 ranks in tests/test_torch_zero.py)
    ({"checkpoint": {"async_save": True, "sigterm_save": True},
      "zero_optimization": {"stage": 2}, "bf16": {"enabled": True}},
     None),
    ({"zero_optimization": {"stage": 2, "cpu_offload": True},
      "offload": {"tier": "disk", "disk_dir": "ds_disk"},
      "bf16": {"enabled": True}}, None),
], ids=["zero", "offload", "pipeline", "onebit", "lamb", "sparse_grads",
        "pld", "telemetry", "tensorboard", "checkpoint", "disk_tier"])
def test_unported_training_knob_raises_naming_its_roadmap_item(extra, item,
                                                               tmp_path):
    if "telemetry" in extra:
        extra = {**extra, "telemetry": {"enabled": True,
                                        "output_path": str(tmp_path)}}
    if "tensorboard" in extra:
        extra = {**extra, "tensorboard": {"enabled": True,
                                          "output_path": str(tmp_path)}}
    if "offload" in extra:
        extra = {**extra, "offload": {**extra["offload"],
                                      "disk_dir": str(tmp_path / "disk")}}
    if item is None:
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=GPT2Model(TINY), config={**TRAIN_BASE, **extra},
            device="cpu")
        stage = extra.get("zero_optimization", {}).get("stage", 0)
        assert eng.zero_stage == stage
        loss = eng.train_batch(torch.zeros(1, 5, dtype=torch.long))
        assert torch.isfinite(loss)
        eng.close()
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md.*{item}"):
        deepspeed_tpu_torch.initialize(model=GPT2Model(TINY),
                                       config={**TRAIN_BASE, **extra},
                                       device="cpu")


def test_unported_training_paths_raise(tmp_path):
    from deepspeed_tpu_torch.parallel import build_mesh
    from deepspeed_tpu_torch.runtime.resilience import CheckpointCorruptError
    # a mesh is ported (item 9); its pipe and seq axes are items 10, 11
    with pytest.raises(NotImplementedError, match="item 10"):
        build_mesh(pp=2)
    with pytest.raises(NotImplementedError, match="item 11"):
        build_mesh(sp=2)
    with pytest.raises(TypeError, match="Mesh"):
        deepspeed_tpu_torch.initialize(model=GPT2Model(TINY),
                                       config=TRAIN_BASE, mesh=object(),
                                       device="cpu")
    # item 12's stream_scan is ported: it marks the stacked leaves
    spec = GPT2Model(GPT2Config(stream_scan=True)).streaming_param_spec(
        {"wte": 0, "blocks": {"qkv_w": 0}})
    assert spec == {"wte": False, "blocks": {"qkv_w": True}}
    assert GPT2Model(GPT2Config(stream_scan=True, scan_layers=False)
                     ).streaming_param_spec({"blocks": {}}) is None
    eng, *_ = deepspeed_tpu_torch.initialize(model=GPT2Model(TINY),
                                             config=TRAIN_BASE,
                                             device="cpu")
    # a checkpoint a multi-process run wrote (a sharded leaf) loads from
    # its shard files; with them missing it is corrupt
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
    with pytest.raises(CheckpointCorruptError, match="shard index"):
        eng.load_checkpoint(str(tmp_path), tag="t")
    model = GPT2Model(GPT2Config(**{**TINY.__dict__, "attn_impl": "ring"}))
    with pytest.raises(NotImplementedError, match="item 11"):
        model.loss_fn(model.init(0), torch.zeros(1, 5, dtype=torch.long),
                      None, train=False)


def test_replica_without_device_raises_when_cuda_is_absent(tmp_path,
                                                            monkeypatch):
    """A fleet replica spawned without ``--device cpu`` on a machine with
    no CUDA device raises before it connects to the router: it never
    serves on the CPU."""
    from deepspeed_tpu_torch.inference.replica import build_engine, main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = {"serving": {"slots": 1, "max_seq_len": 32, "prefill_len": 8},
           "fleet_model": {"vocab_size": 64, "n_positions": 32,
                           "d_model": 64, "n_layer": 1, "n_head": 1}}
    with pytest.raises(RuntimeError, match="--device cpu"):
        build_engine(cfg, str(tmp_path), 0)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--router", "127.0.0.1:9", "--replica-id", "0",
              "--fleet-dir", str(tmp_path), "--config", str(path)])
    eng = build_engine(cfg, str(tmp_path), 0, device="cpu")
    assert eng.device.type == "cpu"
    eng.close()
