"""deepspeed_tpu_torch — the PyTorch + CUDA port of ``deepspeed_tpu``.

A second package beside the JAX one, built for one NVIDIA H100.  It keeps
the JAX package's module layout, ``ds_config.json`` keys and GPT-2
parameter tree, and it never imports ``jax`` or ``deepspeed_tpu``: what
it needs from the JAX package's pure-Python modules it carries as its own
copy.  Every Pallas kernel on a ported path becomes a kernel written by
hand for Hopper (``csrc/``), built on first use by
``ops/kernels/build.py``.

Ported so far: GPT-2 greedy serving (``inference.ServeEngine``) on the
unpaged slot cache, with the flash-attention forward and the single-query
decode-attention kernels.  ROADMAP.md lists what comes next.
"""
from .version import __version__  # noqa: F401
