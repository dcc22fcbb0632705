"""Packaging (reference: setup.py — DS_BUILD_* driven op pre-compilation).

``pip install .`` ships the pure-Python package plus the csrc/ sources;
the native host ops build lazily on first use (ops/op_builder.py) or
eagerly here with DS_BUILD_CPU_ADAM=1, mirroring the reference's
pre-install vs JIT split (reference setup.py + op_builder/builder.py).
"""
import os

from setuptools import find_packages, setup


def _maybe_prebuild():
    if os.environ.get("DS_BUILD_CPU_ADAM", "0") == "1":
        import sys
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from deepspeed_tpu.ops.op_builder import build_cpu_ops
        print(f"[deepspeed_tpu] prebuilt native ops: {build_cpu_ops()}")


_maybe_prebuild()

version = {}
with open("deepspeed_tpu/version.py") as f:
    exec(f.read(), version)

setup(
    name="deepspeed_tpu",
    version=version["__version__"],
    description="TPU-native deep learning optimization library "
                "(ZeRO, pipeline/tensor/sequence parallelism, 1-bit Adam, "
                "sparse attention) built on JAX/XLA/Pallas",
    packages=find_packages(include=["deepspeed_tpu", "deepspeed_tpu.*",
                                    "deepspeed_tpu_torch*"]),
    # csrc/ ships in the sdist via MANIFEST.in; a wheel install without the
    # sources degrades gracefully (op_builder reports the numpy fallback)
    scripts=["bin/ds", "bin/ds_report", "bin/ds_ssh", "bin/deepspeed",
             "bin/deepspeed.pt", "bin/ds_torch", "bin/ds_report_torch"],
    python_requires=">=3.10",
    install_requires=["jax", "optax", "numpy", "ml_dtypes"],
)
