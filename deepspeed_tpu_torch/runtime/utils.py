"""Runtime numeric utilities — the port of ``deepspeed_tpu/runtime/utils.py``
(norms and clipping, the structured memory snapshot), plus the host-side seed derivation the port uses in
place of ``jax.random.fold_in`` and the helpers every model shares: the
seeded dropout, a host uniform draw and ``params_from_numpy``.

Trees are dicts of tensors, possibly nested; ``tree_leaves`` walks them in
key order, the same order on every call.
"""
from __future__ import annotations

from typing import List, Optional

import torch

_M64 = (1 << 64) - 1


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a (nested) dict in key-insertion order; a list or
    tuple of tensors passes through."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return [tree]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over every leaf of its fp32 sum of squares (a
    device scalar; no host sync)."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.tensor(0.0)
    return torch.stack([x.float().square().sum() for x in leaves]).sum() \
        .sqrt()


def clip_by_global_norm(tree, max_norm: float, norm=None):
    """Scale the leaves so their global L2 norm is <= max_norm (reference:
    runtime/utils.py clip_grad_norm_ semantics): ``min(1, max_norm /
    (norm + 1e-6))``.  Returns ``(list of scaled leaves, norm)``."""
    leaves = tree_leaves(tree)
    if norm is None:
        norm = global_norm(leaves)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return [x * scale.to(x.dtype) for x in leaves], norm


def collect_memory_stats(device=None) -> dict:
    """Structured device + host memory snapshot (reference
    ``runtime/utils.py:43``, the same dict schema) — the one collection
    path the ``memory_status`` log line and the telemetry gauges
    (``telemetry.memory.MemorySampler``) share.

    Returns ``{"devices": [{"id", "platform", "bytes_in_use",
    "peak_bytes_in_use", "bytes_limit"}, ...], "host_rss_bytes": int |
    None}``: ``device`` (a CUDA device) alone, or every CUDA device when
    it is None; none on the CPU.  Reads the caching allocator's
    bookkeeping (``torch.cuda.memory_stats``), ``torch.cuda.mem_get_info``
    and ``/proc/self/status`` — no stream is synchronized, so it is safe
    at the engine's flush cadence."""
    if device is not None:
        device = torch.device(device)
        ids = [device.index or 0] if device.type == "cuda" else []
    else:
        ids = (list(range(torch.cuda.device_count()))
               if torch.cuda.is_available() else [])
    devices = []
    for i in ids:
        stats = torch.cuda.memory_stats(i)
        devices.append({
            "id": i,
            "platform": "gpu",
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.mem_get_info(i)[1],
        })
    rss = None
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    rss = int(line.split()[1]) * 1024
                    break
    except OSError:
        pass
    return {"devices": devices, "host_rss_bytes": rss}


def format_memory_status(stats: dict, message: str = "") -> str:
    """Render ``collect_memory_stats()`` output as the reference's
    ``memory_status`` line (first 8 devices, GiB with peaks, host RSS)."""
    parts = []
    for dev in stats.get("devices", [])[:8]:
        used = (dev.get("bytes_in_use") or 0) / 2 ** 30
        peak = (dev.get("peak_bytes_in_use") or 0) / 2 ** 30
        lim = (dev.get("bytes_limit") or 0) / 2 ** 30
        parts.append(f"{dev['id']}: {used:.2f}/{lim:.2f}GB peak {peak:.2f}")
    rss = stats.get("host_rss_bytes")
    if rss is not None:
        parts.append(f"host RSS {rss / 2 ** 30:.2f}GB")
    return (f"MEMORY {message}: " if message else "MEMORY: ") + \
        ("; ".join(parts) if parts else "no stats available")


def memory_status(message: str = "", device=None) -> str:
    report = format_memory_status(collect_memory_stats(device), message)
    from ..utils.logging import log_dist
    log_dist(report, ranks=[0])
    return report


def fold_in(seed: Optional[int], data: int) -> Optional[int]:
    """A new 64-bit host seed from ``(seed, data)`` — the counterpart of
    ``jax.random.fold_in`` for the port's integer seeds (the splitmix64
    finalizer over ``seed + golden * (data + 1)``).  Deterministic, so a
    recomputed block derives the same seeds; ``None`` stays ``None`` (no
    randomness wanted)."""
    if seed is None:
        return None
    z = (int(seed) + 0x9E3779B97F4A7C15 * (int(data) + 1)) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def host_uniform(seed: int) -> float:
    """A uniform draw in [0, 1) from a host seed (the top 53 bits of
    ``fold_in(seed, 0)``): a decision the host takes without a generator
    and without reading anything back from the card."""
    return (fold_in(seed, 0) >> 11) * 2.0 ** -53


def seeded_generator(seed: Optional[int], device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from a host seed."""
    if seed is None:
        raise ValueError("dropout > 0 needs an rng seed (train=True)")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & ((1 << 63) - 1))
    return gen


def data_rows(mesh, n: int):
    """``(offset, total)`` of a data rank's ``n`` rows in the global
    micro-batch the dropouts draw over, None without a mesh."""
    if mesh is None:
        return None
    from ..parallel.mesh import DATA_AXIS
    return mesh.axis_index(DATA_AXIS) * n, mesh.axis_size(DATA_AXIS) * n


def dropout(x, rate: float, seed: Optional[int], rows=None):
    """Inverted dropout with keep probability ``1 - rate``, its mask drawn
    from a ``torch.Generator`` built here from the host ``seed`` (so a
    block recomputed under ``torch.utils.checkpoint`` draws the same
    mask).  ``rows = (offset, total)``: ``x`` holds rows ``offset …
    offset + len(x)`` of a batch of ``total`` (a data-parallel rank's
    share of the global micro-batch): the mask is drawn for all ``total``
    rows and the rank keeps its own, so the masks do not depend on the
    layout."""
    if rate <= 0.0:
        return x
    shape = x.shape if rows is None else (rows[1],) + tuple(x.shape[1:])
    keep = torch.rand(shape, generator=seeded_generator(seed, x.device),
                      device=x.device) < 1.0 - rate
    if rows is not None:
        keep = keep[rows[0]:rows[0] + x.shape[0]]
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def params_from_numpy(tree, device=None, dtype: Optional[torch.dtype] = None):
    """The port's parameter tree from a JAX ``init`` tree given as numpy
    arrays (``np.asarray`` of each JAX leaf): same names and shapes, one
    copy per leaf onto ``device``, cast to ``dtype`` when given."""
    if isinstance(tree, dict):
        return {name: params_from_numpy(sub, device, dtype)
                for name, sub in tree.items()}
    return torch.tensor(tree, device=device, dtype=dtype)
