"""Build/version identity (reference: deepspeed/git_version_info.py; a
port of ``deepspeed_tpu/git_version_info.py``) — the version, the git
hash and branch, and the per-op map ``compatible_ops``.

The git facts are read lazily from the working tree when available
(source checkouts are the normal deployment) and fall back to "unknown".
The op map reports each CUDA kernel library of ``ops/kernels/build.py``:
whether it can be built here (``nvcc`` found) and whether an up-to-date
library is already built.
"""
from __future__ import annotations

import os
import subprocess

from .version import __version__ as version


def _git(*args: str) -> str:
    """Git facts about the checkout this package lives in — NOT whatever
    repo happens to enclose a site-packages install: the resolved toplevel
    must be an ancestor of the package directory."""
    # realpath on both sides: git prints the physical toplevel, so a
    # symlinked checkout must be compared physically too
    pkg_dir = os.path.dirname(os.path.realpath(__file__))
    try:
        top = subprocess.run(
            ("git", "-C", pkg_dir, "rev-parse", "--show-toplevel"),
            capture_output=True, text=True, timeout=5).stdout.strip()
        if not top or not (pkg_dir + os.sep).startswith(top + os.sep):
            return "unknown"
        out = subprocess.run(
            ("git", "-C", pkg_dir) + args, capture_output=True, text=True,
            timeout=5)
        return out.stdout.strip() or "unknown"
    except Exception:
        return "unknown"


def __getattr__(name):
    # Lazy: importing the package must not pay git subprocess roundtrips
    # or the digest of every kernel source — these resolve on first
    # access (version banners, reports), then cache on the module.
    if name == "git_hash":
        value = _git("rev-parse", "--short", "HEAD")
    elif name == "git_branch":
        value = _git("rev-parse", "--abbrev-ref", "HEAD")
    elif name == "compatible_ops":
        value = _op_compat()
    else:
        raise AttributeError(name)
    globals()[name] = value
    return value


def kernel_libraries() -> list:
    """The kernel sources ``ops/kernels/build.py`` compiles: every
    ``csrc/*.cu``, by name."""
    from .ops.kernels.build import CSRC_DIR
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _op_compat() -> dict:
    """Kernel library name → ``{"buildable": nvcc found, "built": an
    up-to-date library exists}``.  Nothing is compiled here."""
    from .ops.kernels import build
    try:
        build.nvcc()
        buildable = True
    except RuntimeError:
        buildable = False
    return {name: {"buildable": buildable,
                   "built": os.path.exists(build._target(name)[1])}
            for name in kernel_libraries()}
