"""The host C++ ops' build — the port's own copy of
``deepspeed_tpu/ops/op_builder.py``.

The repo's host-side C++ (``csrc/cpu_adam.cpp``: the fused CPU Adam of
the offload tier; ``csrc/sparse_lut.cpp``: the block-sparse LUT builder)
lies at the repo root and is shared by both packages.  The port compiles
every ``csrc/*.cpp`` with the system ``g++ -O3 -march=native -fopenmp``
into ``deepspeed_tpu_torch/_build/libds_cpu_ops_<hash>.so`` at first
use, the hash over the sources and the host's CPU model (a change of
either rebuilds; concurrent builders rename into place), and binds it
with ctypes.  ``ctypes.CDLL`` releases the GIL for the length of each
call, so a host Adam overlaps Python threads (the offload tier's
transfer workers).  The CUDA kernels have their own build
(``ops/kernels/build.py``, nvcc).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

_REPO_ROOT = Path(__file__).resolve().parents[2]
_CSRC = _REPO_ROOT / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

_compile_error: Optional[str] = None
_lib: Optional[ctypes.CDLL] = None


class OpBuilderError(RuntimeError):
    pass


def _cpu_model() -> bytes:
    """The host CPU's model line: ``-march=native`` builds for it, so a
    library built on another host is never loaded here."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"model name"):
                    return line
    except OSError:
        pass
    return b""


def _source_hash(sources) -> str:
    h = hashlib.sha256(_cpu_model())
    for s in sources:
        h.update(Path(s).read_bytes())
    return h.hexdigest()[:16]


def build_cpu_ops(verbose: bool = False) -> Path:
    """Compile every ``csrc/*.cpp`` into ``_build/libds_cpu_ops_<hash>.so``
    (once per source or CPU-model change); returns its path."""
    sources = sorted(_CSRC.glob("*.cpp"))
    if not sources:
        raise OpBuilderError(
            f"no native sources under {_CSRC}: the host ops build from a "
            "source checkout")
    out = _BUILD_DIR / f"libds_cpu_ops_{_source_hash(sources)}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a process-unique path and rename into place: a
    # concurrent builder must never dlopen a half-written library
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
           "-o", str(tmp)] + [str(s) for s in sources]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise OpBuilderError(f"native build failed to launch: {e}") from e
    if proc.returncode != 0:
        raise OpBuilderError(
            f"native build failed:\n{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    if verbose:
        print(f"[deepspeed_tpu_torch] built {out.name}")
    return out


def load_cpu_ops() -> ctypes.CDLL:
    """Build (if needed) and load the host-ops library.  Raises
    :class:`OpBuilderError` when the toolchain is unavailable (callers
    choose the numpy arm explicitly); a library missing a symbol raises
    a plain RuntimeError, never a silent fallback."""
    global _lib, _compile_error
    if _lib is not None:
        return _lib
    if _compile_error is not None:
        raise OpBuilderError(_compile_error)
    try:
        path = build_cpu_ops()
        lib = ctypes.CDLL(str(path))
    except (OpBuilderError, OSError) as e:
        _compile_error = str(e)
        raise OpBuilderError(_compile_error) from None
    i64, f32 = ctypes.c_int64, ctypes.c_float
    fp = ctypes.POINTER(ctypes.c_float)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    try:
        lib.ds_cpu_adam_step.argtypes = [
            i64, fp, fp, fp, fp, f32, f32, f32, f32, f32,
            ctypes.c_int, ctypes.c_int, i64, u16p, ctypes.c_int]
        lib.ds_cpu_adam_step.restype = None
        lib.ds_lut_width.argtypes = [i64, i64, i32p]
        lib.ds_lut_width.restype = i64
        lib.ds_build_lut.argtypes = [i64, i64, i32p, i64, i32p, u8p]
        lib.ds_build_lut.restype = None
        lib.ds_cpu_ops_version.restype = ctypes.c_int
        # OpenMP's own (a dependency of the library): the thread cap
        lib.omp_set_num_threads.argtypes = [ctypes.c_int]
        lib.omp_set_num_threads.restype = None
    except AttributeError as e:
        raise RuntimeError(
            f"native library {path.name} is incomplete: {e}") from None
    _lib = lib
    return lib


def cpu_ops_loaded() -> Optional[ctypes.CDLL]:
    """The already-loaded library, or None: never triggers a build (for
    callers whose native path is optional, such as the sparse LUT)."""
    return _lib
