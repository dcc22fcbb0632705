"""The port stands alone: no module of ``deepspeed_tpu_torch/`` (nor
``chip_smoke.py``) imports jax or the JAX package, every module imports
with jax made unimportable, the serving engine runs on the card unless
told otherwise, and every config knob whose path is not ported raises
instead of being silently ignored.
"""
import ast
import os
import subprocess
import sys

import pytest
import torch

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
            os.path.join(REPO, "profile_serve_torch.py")] + _package_files()


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
    ({"serving": {"page_len": 8}}, "7.2"),
    ({"serving": {"speculate_k": 2}}, "7.3"),
    ({"serving": {"temperature": 0.7}}, "7.3"),
    ({"serving": {"quantization": {"weights": "int8"}}}, "7.4"),
    ({"telemetry": {"enabled": True}}, "item 5"),
], ids=["page_len", "speculate_k", "temperature", "quantization",
        "telemetry"])
def test_unported_knob_raises_naming_its_roadmap_item(extra, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md.*{item}"):
        ServeEngine(GPT2Model(TINY), extra, device="cpu")


def test_unported_paged_only_knobs_and_mesh_raise(monkeypatch):
    """kv_tier, lora and prefill_chunk_len need page_len > 0 to parse at
    all, so the page_len refusal comes first; the engine's own checks for
    them are exercised directly, and a mesh raises before anything
    else."""
    with pytest.raises(NotImplementedError, match="7.2"):
        ServeEngine(GPT2Model(TINY), {"serving": {
            "page_len": 8, "prefill_chunk_len": 4}}, device="cpu")
    cfg = engine_mod._ServeConfigView({"serving": {"slots": 1}})
    monkeypatch.setitem(cfg.serving.kv_tier, "idle_park_ticks", 3)
    with pytest.raises(NotImplementedError, match="7.6"):
        engine_mod._refuse_unported(cfg)
    cfg = engine_mod._ServeConfigView({"serving": {"slots": 1}})
    monkeypatch.setitem(cfg.serving.lora, "rank", 4)
    with pytest.raises(NotImplementedError, match="7.5"):
        engine_mod._refuse_unported(cfg)
    cfg = engine_mod._ServeConfigView({"serving": {"slots": 1}})
    monkeypatch.setattr(cfg.serving, "prefill_chunk_len", 4)
    with pytest.raises(NotImplementedError, match="7.2"):
        engine_mod._refuse_unported(cfg)
    with pytest.raises(NotImplementedError, match="item 9"):
        ServeEngine(GPT2Model(TINY), {}, mesh=object(), device="cpu")
