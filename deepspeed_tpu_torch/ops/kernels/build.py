"""Build the port's CUDA kernels on first use and load them with ctypes.

Each source under ``deepspeed_tpu_torch/csrc/`` has a plain ``extern "C"``
launcher and compiles on its own with ``nvcc`` for ``sm_90a`` into a
shared library under ``deepspeed_tpu_torch/_build/`` (listed in
``.gitignore``).  The library's file name carries a digest of the flags,
the source and every header it includes (``csrc/*.cuh``), so an edited
source or header is rebuilt and a stale library is never loaded.  Nothing here runs at import time: the CPU tests import
every module on a machine with no ``nvcc``.

A build failure raises with the compiler's output; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Tuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then
    ``/usr/local/cuda/bin/nvcc``, then ``nvcc`` on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from deepspeed_tpu_torch/csrc/ on first use")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(src: str) -> List[str]:
    """``src`` and every file it includes with ``#include "..."``,
    transitively (paths relative to the including file), in a stable
    order: what the library's digest must cover."""
    seen, todo = [src], [src]
    while todo:
        path = todo.pop()
        with open(path, "rb") as f:
            text = f.read()
        for inc in _INCLUDE.findall(text):
            dep = os.path.join(os.path.dirname(path), inc.decode())
            if os.path.exists(dep) and dep not in seen:
                seen.append(dep)
                todo.append(dep)
    return seen


def _target(name: str) -> Tuple[str, str]:
    src = os.path.join(CSRC_DIR, name + ".cu")
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in _sources(src):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    return src, os.path.join(BUILD_DIR,
                             f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names: Iterable[str], verbose: bool = False,
          force: bool = False) -> Dict[str, str]:
    """Compile every named source that has no up-to-date library (every
    one with ``force``), one ``nvcc`` process per source, all started
    together.  Returns ``{name: compiler output}`` for the sources
    compiled by this call (with ``verbose`` the output holds ``-Xptxas
    -v``'s register and shared-memory lines)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        src, lib = _target(name)
        if os.path.exists(lib) and not force:
            continue
        tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, lib)
    logs = {}
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu "
                          f"(rc {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent build never loads half
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_target(name)[1])
            _libs[name] = lib
        return lib
