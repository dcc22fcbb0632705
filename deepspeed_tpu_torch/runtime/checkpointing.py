"""Checkpoint save / load — the port of ``deepspeed_tpu/runtime/
checkpointing.py``, writing the JAX package's on-disk format byte for
byte.

Layout of ``<save_dir>/<tag>/`` (the reference's two-plane scheme plus an
optional data-iterator plane):
  - ``meta.json``                       counters, world info, client_state,
                                        ``format_version`` + manifest digests
  - ``model/manifest.json  + *.npy``    module weights in compute dtype
  - ``optim/manifest.json  + *.npy``    fp32 master + optimizer state + scaler
  - ``data/manifest.json   + *.npy``    the training iterator's position

``<save_dir>/latest`` holds the most recent tag.  Every leaf is one
``leaf_{i:05d}.npy`` written with ``allow_pickle=False``; ``i`` counts the
leaves in JAX's tree order (dict keys sorted, NamedTuple fields in
declaration order) and each manifest key is JAX's ``keystr`` of the leaf's
path, e.g. ``['opt_state'].mu['blocks']['qkv_w']`` — so the manifests, and
the SHA-256 digests of them that ``meta.json`` pins, are the ones the JAX
package writes for the same tree.  bfloat16 leaves are stored as their
``uint16`` bit patterns with the logical dtype in the manifest (rebuilt
with torch, not ``ml_dtypes``).

The port keeps its optimizer moments as lists in the params' leaf order
and its PRNG state as host integers; the engine's ``_checkpoint_state``
re-nests the moments onto the param tree (each leaf as the rank's
``ShardPiece``), and a host seed travels as the
two ``uint32`` words of the ``rng``/``data_rng`` leaves (high word first,
as ``jax.random.PRNGKey`` lays out a 64-bit seed).  Inside the port a seed
round-trips exactly, so save → load → continue is bitwise.  Across
frameworks the dropout streams differ (a JAX key and a port seed draw
different masks), so trajectories carried from one package to the other
are compared at dropout 0.

Fault tolerance is the reference's, unchanged (primitives in
``resilience.py``): per-leaf CRC32 and byte length in every manifest entry
verified lazily on load, SHA-256 manifest digests in ``meta.json``, async
saves through the engine's daemon writer (host snapshot first, one
serialization path shared with sync saves, so their bytes are equal), the
``latest`` fallback chain bounded by ``checkpoint.load_fallback``,
retention GC after a verified save, orphaned ``*.tmp`` sweep, and
``io_retry`` around every read and write with the ``ckpt`` stage fault
points.

Several processes (data/tensor parallelism, ZeRO): the JAX package's
multi-process format.  A leaf split across ranks is written as each
rank's piece, ``leaf_{i:05d}.proc{rank}_0.npy``, with the rank's index
file ``leaf_{i:05d}.proc{rank}.json`` (``[[start, stop], …]`` per dim,
CRC32, byte length); replicas of a piece are written once, and rank 0
writes the manifest entry ``{"sharded": true, …}``, the whole leaves and
``meta.json``.  Load merges exactly the ranges a rank needs from whatever
pieces the files hold, so the data-parallel size and the ZeRO stage may
change between save and load, in either package.  Async and SIGTERM
saves are one process's (the engine refuses them across processes).
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import threading
import time
import weakref
import zlib
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.logging import log_dist, logger
from .zero import ShardPiece
from .resilience import (AsyncCheckpointWriter, CheckpointCorruptError,
                         CheckpointError, CheckpointJob,
                         CheckpointMissingError, CKPT_CORRUPT,
                         CKPT_FORMAT_VERSION, CKPT_MISSING, CKPT_OK,
                         DEFAULT_RETRY, RetryPolicy, fault_point,
                         io_retry, retention_gc, list_tags, sweep_tmp)

LATEST_FILE = "latest"

_M32 = 0xFFFFFFFF


def _tel_span(engine, name: str, **args):
    """Per-plane telemetry span via the engine's hub (nullcontext when
    telemetry is off or the caller is not a full engine)."""
    span = getattr(engine, "_tel_span", None)
    if span is None:
        return contextlib.nullcontext()
    return span(name, cat="checkpoint", **args)


# ---------------------------------------------------------------------------
# telemetry sink (counters reachable from helpers + the writer thread)
# ---------------------------------------------------------------------------
_TEL = threading.local()


@contextlib.contextmanager
def _tel_sink(engine):
    """Bind the engine's metrics registry (None without telemetry) for
    this thread so the deep write/read helpers can bump counters."""
    reg = getattr(getattr(engine, "telemetry", None), "registry", None)
    prev = getattr(_TEL, "reg", None)
    _TEL.reg = reg
    try:
        yield
    finally:
        _TEL.reg = prev


def _count(name: str, help: str, n: float = 1):
    reg = getattr(_TEL, "reg", None)
    if reg is not None and n:
        reg.counter(name, help).inc(n)


def _on_retry(_attempt, _exc):
    _count("ckpt_retries_total",
           "checkpoint I/O retries (transient OSError, backed off)")


# ---------------------------------------------------------------------------
# resolved checkpoint config (engine-shaped ducks get defaults)
# ---------------------------------------------------------------------------
class _CkptCfg(NamedTuple):
    retry: RetryPolicy = DEFAULT_RETRY
    keep_last_n: int = 0
    load_fallback: int = 2


def _ckpt_config(engine) -> _CkptCfg:
    cc = getattr(getattr(engine, "config", None), "checkpoint_config", None)
    if cc is None:
        return _CkptCfg()
    return _CkptCfg(
        retry=RetryPolicy(attempts=int(cc.io_retry_attempts),
                          base_s=float(cc.io_retry_base_s)),
        keep_last_n=int(cc.keep_last_n),
        load_fallback=int(cc.load_fallback))


# ---------------------------------------------------------------------------
# the JAX tree walk: keys and leaf order
# ---------------------------------------------------------------------------
def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten_with_keys(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(keystr, leaf), ...]`` in ``jax.tree_util.tree_flatten_with_path``
    order: dict keys sorted (``['name']``), NamedTuple fields in
    declaration order (``.name``), list/tuple items by index (``[i]``);
    ``None`` holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in tree_flatten_with_keys(tree[k],
                                                 f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in tree_flatten_with_keys(getattr(tree, f),
                                                 f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in tree_flatten_with_keys(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def tree_map_with_keys(fn: Callable[[str, Any], Any], tree,
                       prefix: str = ""):
    """``fn(keystr, leaf)`` over every leaf, rebuilding the tree with its
    own container types and dict insertion order (the order the port's
    ``tree_leaves`` walks)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_keys(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map_with_keys(fn, getattr(tree, f),
                                               f"{prefix}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_keys(fn, v, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


# ---------------------------------------------------------------------------
# host seeds <-> PRNG key words
# ---------------------------------------------------------------------------
def seed_to_key(seed: int) -> np.ndarray:
    """A 64-bit host seed as the ``uint32[2]`` words of a JAX PRNG key."""
    s = int(seed) & ((1 << 64) - 1)
    return np.asarray([s >> 32, s & _M32], np.uint32)


def key_to_seed(key) -> int:
    """The host seed a saved ``uint32[2]`` key stands for."""
    w = np.asarray(key).astype(np.uint64).reshape(-1)
    if w.size != 2:
        raise CheckpointCorruptError(
            f"a PRNG key leaf must hold 2 uint32 words, got shape "
            f"{np.asarray(key).shape}")
    return (int(w[0]) << 32) | int(w[1])


# ---------------------------------------------------------------------------
# leaf codec
# ---------------------------------------------------------------------------
_TORCH_BITS = {torch.bfloat16: "bfloat16"}
if hasattr(torch, "float8_e4m3fn"):
    _TORCH_BITS[torch.float8_e4m3fn] = "float8_e4m3fn"
    _TORCH_BITS[torch.float8_e5m2] = "float8_e5m2"
_BITS_VIEW = {1: (torch.uint8, np.uint8), 2: (torch.int16, np.uint16)}


def _c_order(arr: np.ndarray) -> np.ndarray:
    """``arr`` in C order, 0-d shapes kept (``np.save`` writes a
    Fortran-ordered array with another header)."""
    return arr if arr.flags.c_contiguous else arr.copy(order="C")


def _to_storage(leaf) -> Tuple[np.ndarray, str]:
    """Return (storable host array, logical dtype name).  A tensor is read
    back with ``.detach().cpu()``; bf16/fp8 leaves are stored as their
    unsigned bit patterns, as the JAX package stores them."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        logical = _TORCH_BITS.get(t.dtype)
        if logical is not None:
            tview, nview = _BITS_VIEW[t.element_size()]
            return t.contiguous().view(tview).numpy().view(nview), logical
        arr = _c_order(t.numpy())
        return arr, arr.dtype.name
    arr = _c_order(np.asarray(leaf))
    return arr, arr.dtype.name


def _from_storage(arr: np.ndarray, logical: str):
    """The stored array as its logical dtype: a numpy array, or a CPU
    tensor for the dtypes numpy lacks (bf16/fp8 rebuilt from their bit
    patterns with torch)."""
    if arr.dtype.name == logical:
        return arr
    want = {v: k for k, v in _TORCH_BITS.items()}.get(logical)
    if want is None:
        raise CheckpointCorruptError(
            f"checkpoint leaf stored as {arr.dtype.name} has an unknown "
            f"logical dtype {logical!r}")
    tview, _ = _BITS_VIEW[arr.dtype.itemsize]
    bits = _c_order(arr).view(
        np.int16 if tview is torch.int16 else np.uint8)
    return torch.from_numpy(bits.copy()).view(want)


def _crc32_arr(arr: np.ndarray) -> int:
    """CRC32 of the array's raw data bytes (the integrity record every
    manifest entry carries), on the STORAGE array."""
    a = np.ascontiguousarray(arr)
    try:
        buf = memoryview(a).cast("B")
    except (TypeError, ValueError):
        buf = a.tobytes()
    return zlib.crc32(buf) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# fsync'd, retried, fault-injectable file primitives
# ---------------------------------------------------------------------------
def _fsync_enabled() -> bool:
    """Per-file fsync before the atomic rename (power-loss durability).
    Default ON; ``DS_CKPT_FSYNC=0`` turns it off (tests simulate process
    death, which the page cache survives).  A torn newest checkpoint is
    still caught by the CRC plane and recovered via the fallback chain."""
    return os.environ.get("DS_CKPT_FSYNC", "1") != "0"


def _write_npy(path: str, store: np.ndarray,
               retry: RetryPolicy, point: str = "leaf") -> None:
    def write():
        fault_point(point, path)
        with open(path, "wb") as f:
            np.save(f, store, allow_pickle=False)
            f.flush()
            if _fsync_enabled():
                os.fsync(f.fileno())
    io_retry(write, f"write {path}", retry, on_retry=_on_retry)


def _write_bytes(path: str, data: bytes, retry: RetryPolicy,
                 point: str) -> None:
    def write():
        fault_point(point, path)
        with open(path, "wb") as f:
            f.write(data)
            f.flush()
            if _fsync_enabled():
                os.fsync(f.fileno())
    io_retry(write, f"write {path}", retry, on_retry=_on_retry)


def _read_npy(path: str, retry: RetryPolicy, key: str) -> np.ndarray:
    def read():
        fault_point("read", path)
        return np.load(path, allow_pickle=False)
    try:
        return io_retry(read, f"read {path}", retry, on_retry=_on_retry)
    except FileNotFoundError:
        raise CheckpointCorruptError(
            f"checkpoint leaf {key!r}: file {path} is missing")
    except (ValueError, EOFError, OSError) as e:
        raise CheckpointCorruptError(
            f"checkpoint leaf {key!r}: file {path} is unreadable "
            f"({type(e).__name__}: {e})")


def _read_json(path: str, what: str, retry: RetryPolicy) -> Any:
    def read():
        fault_point("read", path)
        with open(path, "rb") as f:
            return f.read()
    try:
        data = io_retry(read, f"read {path}", retry, on_retry=_on_retry)
    except OSError as e:
        # a missing/unreadable piece of a checkpoint IS corruption — the
        # fallback chain catches this and walks back
        raise CheckpointCorruptError(
            f"checkpoint {what} at {path} is unreadable "
            f"({type(e).__name__}: {e})")
    try:
        return json.loads(data)
    except ValueError as e:
        raise CheckpointCorruptError(
            f"checkpoint {what} at {path} is unparseable: {e}")


def _fsync_dir(path: str) -> None:
    """POSIX durability for the atomic rename itself."""
    if not _fsync_enabled():
        return
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _verify_leaf(arr: np.ndarray, entry: Dict[str, Any], key: str,
                 path: str) -> None:
    """Lazy per-leaf integrity check (entries without a CRC are
    pre-integrity-plane checkpoints — loaded on trust)."""
    want_crc = entry.get("crc32")
    if want_crc is None:
        return
    want_bytes = entry.get("nbytes")
    if want_bytes is not None and int(arr.nbytes) != int(want_bytes):
        raise CheckpointCorruptError(
            f"checkpoint leaf {key!r}: file {path} has {arr.nbytes} data "
            f"bytes, manifest records {want_bytes} (truncated write?)")
    got = _crc32_arr(arr)
    if got != int(want_crc):
        raise CheckpointCorruptError(
            f"checkpoint leaf {key!r}: file {path} CRC32 mismatch "
            f"(stored {int(want_crc):#010x}, computed {got:#010x}) — "
            "bit corruption or partial write")


def _split_merge_compatible(src: tuple, dst: tuple) -> bool:
    """True iff ``dst`` is reachable from ``src`` by only SPLITTING a dim
    into adjacent factors or MERGING adjacent dims — the reshapes that
    keep the row-major layout (qkv [d, 3d] <-> [d, 3, d]); a permutation
    with the same element count is rejected."""
    if int(np.prod(src, dtype=np.int64)) != int(np.prod(dst,
                                                        dtype=np.int64)):
        return False
    src = tuple(d for d in src if d != 1)
    dst = tuple(d for d in dst if d != 1)
    i = j = 0
    while i < len(src) and j < len(dst):
        a, b = int(src[i]), int(dst[j])
        ni, nj = 1, 1
        while a != b:
            if a < b:
                i += 1
                if i >= len(src):
                    return False
                a *= int(src[i])
                ni += 1
            else:
                j += 1
                if j >= len(dst):
                    return False
                b *= int(dst[j])
                nj += 1
        if ni > 1 and nj > 1:
            return False
        i += 1
        j += 1
    return all(d == 1 for d in src[i:]) and all(d == 1 for d in dst[j:])


def _dtype_names(t: torch.Tensor) -> Tuple[str, str]:
    """(logical, storage) dtype names of a tensor as the manifests record
    them: bf16/fp8 are stored as their unsigned bit patterns."""
    logical = _TORCH_BITS.get(t.dtype)
    if logical is not None:
        return logical, np.dtype(_BITS_VIEW[t.element_size()][1]).name
    name = torch.empty(0, dtype=t.dtype).numpy().dtype.name
    return name, name


def _shard_index_files(dirpath: str, leaf: int) -> List[str]:
    import glob
    return sorted(glob.glob(os.path.join(dirpath,
                                         f"leaf_{leaf:05d}.proc*.json")))


def _box_overlap(index, box):
    """The overlap of a shard's ``[[start, stop], …]`` with ``box`` as
    (slices into the shard, slices into the box), or None."""
    src, dst = [], []
    for (a, b), (c, d) in zip(index, box):
        lo, hi = max(a, c), min(b, d)
        if lo >= hi:
            return None
        src.append(slice(lo - a, hi - a))
        dst.append(slice(lo - c, hi - c))
    return tuple(src), tuple(dst)


def _merge_shards(dirpath: str, key: str, entry: dict, box,
                  retry: RetryPolicy) -> np.ndarray:
    """The ``box`` of a sharded leaf, read from exactly the shard files
    that overlap it (every piece CRC-checked); a box the files do not
    cover whole is corruption."""
    sd = {"bfloat16": np.dtype(np.uint16),
          "float8_e4m3fn": np.dtype(np.uint8),
          "float8_e5m2": np.dtype(np.uint8)}.get(
        entry.get("store_dtype", entry["dtype"])) \
        or np.dtype(entry.get("store_dtype", entry["dtype"]))
    out = np.zeros([b - a for a, b in box], sd)
    idx_files = _shard_index_files(dirpath, int(entry["leaf"]))
    if not idx_files:
        raise CheckpointCorruptError(
            f"sharded checkpoint leaf {key!r}: no shard index files in "
            f"{dirpath}")
    covered = 0
    for jf in idx_files:
        for shard in _read_json(jf, "shard index", retry):
            ov = _box_overlap(shard["index"], box)
            if ov is None:
                continue
            spath = os.path.join(dirpath, shard["file"])
            data = _read_npy(spath, retry, key)
            _verify_leaf(data, shard, key, spath)
            out[ov[1]] = data[ov[0]]
            covered += int(np.prod([s.stop - s.start for s in ov[1]]))
    if covered != out.size:
        raise CheckpointCorruptError(
            f"sharded checkpoint leaf {key!r} in {dirpath}: its shard files "
            f"cover {covered} of the {out.size} elements this rank needs")
    return out


# ---------------------------------------------------------------------------
# tree save / load
# ---------------------------------------------------------------------------
def save_tree(dirpath: str, tree: Any,
              retry: RetryPolicy = DEFAULT_RETRY,
              process_index: int = 0) -> str:
    """Write every leaf of ``tree`` as .npy files plus a manifest mapping
    JAX key-paths to files (with per-leaf CRC32 + byte length).  Returns
    the SHA-256 hex digest of the manifest as written (rank 0; "" on the
    other ranks), so ``meta.json`` can pin it.

    A ``ShardPiece`` leaf that is not the whole leaf is one rank's piece:
    its first holder writes it as ``leaf_{i:05d}.proc{rank}_0.npy``, and
    every rank writes its index file ``leaf_{i:05d}.proc{rank}.json``
    (empty where it holds only replicas).  Whole leaves, and the
    manifest, are rank 0's.  Every rank must call this function."""
    os.makedirs(dirpath, exist_ok=True)
    manifest: Dict[str, Dict[str, Any]] = {}
    for i, (key, leaf) in enumerate(tree_flatten_with_keys(tree)):
        if isinstance(leaf, ShardPiece):
            if not leaf.whole:
                indices = []
                if leaf.write:
                    store, _ = _to_storage(leaf.tensor)
                    fname = f"leaf_{i:05d}.proc{process_index}_0.npy"
                    _write_npy(os.path.join(dirpath, fname), store, retry)
                    indices.append({"file": fname,
                                    "index": [list(b) for b in leaf.box],
                                    "crc32": _crc32_arr(store),
                                    "nbytes": int(store.nbytes)})
                _write_bytes(
                    os.path.join(dirpath,
                                 f"leaf_{i:05d}.proc{process_index}.json"),
                    json.dumps(indices).encode(), retry,
                    point="shard_index")
                if process_index == 0:
                    logical, stored = _dtype_names(leaf.tensor)
                    manifest[key] = {"sharded": True, "leaf": i,
                                     "dtype": logical,
                                     "store_dtype": stored,
                                     "shape": list(leaf.shape)}
                continue
            leaf = leaf.tensor
        if process_index != 0:
            continue
        store, logical = _to_storage(leaf)
        fname = f"leaf_{i:05d}.npy"
        _write_npy(os.path.join(dirpath, fname), store, retry)
        manifest[key] = {
            "file": fname,
            "dtype": logical,
            "shape": list(store.shape),
            "crc32": _crc32_arr(store),
            "nbytes": int(store.nbytes),
        }
    if process_index != 0:
        return ""
    data = json.dumps(manifest, indent=1).encode()
    _write_bytes(os.path.join(dirpath, "manifest.json"), data, retry,
                 point="manifest")
    return hashlib.sha256(data).hexdigest()


def _leaf_meta(tleaf) -> Tuple[tuple, Optional[torch.dtype], Any]:
    """(shape, torch dtype or None, device or None) of a template leaf
    (a ``ShardPiece``'s whole shape)."""
    if isinstance(tleaf, ShardPiece):
        return tleaf.shape, tleaf.tensor.dtype, tleaf.tensor.device
    if isinstance(tleaf, torch.Tensor):
        return tuple(tleaf.shape), tleaf.dtype, tleaf.device
    arr = np.asarray(tleaf)
    return tuple(arr.shape), None, None


def load_tree(dirpath: str, target: Any, strict: bool = True,
              retry: RetryPolicy = DEFAULT_RETRY) -> Any:
    """Load leaves by key-path into the structure of ``target``: a tensor
    leaf becomes a tensor of its dtype on its device, a numpy leaf a
    numpy array of its dtype, a ``ShardPiece`` the tensor of its box
    (merged from the shard files that overlap it when the leaf was saved
    sharded).  Each leaf read is verified against its manifest
    CRC32/byte length (when present) and a mismatch raises
    ``CheckpointCorruptError`` naming the leaf and file BEFORE any engine
    state is touched."""
    manifest = _read_json(os.path.join(dirpath, "manifest.json"),
                          "manifest", retry)

    def load(key, tleaf):
        entry = manifest.get(key)
        if entry is None:
            if strict:
                raise KeyError(
                    f"checkpoint at {dirpath} has no entry for {key!r}")
            log_dist(f"checkpoint {dirpath}: no entry for {key!r}; "
                     "keeping the engine's current value", ranks=[0])
            return tleaf
        tshape, tdtype, tdev = _leaf_meta(tleaf)
        box = (tleaf.box if isinstance(tleaf, ShardPiece)
               else tuple((0, n) for n in tshape))
        if entry.get("sharded"):
            if tuple(entry["shape"]) != tshape:
                raise ValueError(
                    f"checkpoint leaf {key!r} has shape "
                    f"{tuple(entry['shape'])}, engine expects {tshape} — "
                    "model/optimizer config mismatch")
            val = _from_storage(
                _merge_shards(dirpath, key, entry, box, retry),
                entry["dtype"])
            box = None
        else:
            fpath = os.path.join(dirpath, entry["file"])
            arr = _read_npy(fpath, retry, key)
            _verify_leaf(arr, entry, key, fpath)
            val = _from_storage(arr, entry["dtype"])
        if box is not None and tuple(val.shape) != tshape:
            if _split_merge_compatible(tuple(val.shape), tshape):
                # size-preserving layout change (dims split or merged,
                # row-major order unchanged): reshape, loudly
                val = val.reshape(tshape)
                log_dist(
                    f"checkpoint leaf {key!r}: reshaped "
                    f"{entry['shape']} -> {list(tshape)} (size-preserving "
                    "layout change)", ranks=[0])
            else:
                raise ValueError(
                    f"checkpoint leaf {key!r} has shape {tuple(val.shape)}"
                    f", engine expects {tshape} — model/optimizer config "
                    "mismatch")
        if box is not None and isinstance(tleaf, ShardPiece):
            val = val[tuple(slice(a, b) for a, b in box)]
        if tdtype is not None:
            t = val if isinstance(val, torch.Tensor) else \
                torch.from_numpy(_c_order(val))
            return t.to(device=tdev, dtype=tdtype)
        if isinstance(val, torch.Tensor):
            val = val.float().numpy()
        tdt = np.asarray(tleaf).dtype
        return val.astype(tdt) if val.dtype != tdt else val

    return tree_map_with_keys(load, target)


# ---------------------------------------------------------------------------
# data-iterator plane codec (sample-exact resume)
# ---------------------------------------------------------------------------
def _iter_state_plane(state: Any) -> Any:
    """A JSON-able iterator state as a one-leaf tree, so the data plane
    rides the same machinery as model/optim."""
    data = json.dumps(state).encode()
    return {"state": np.frombuffer(data, np.uint8)}


def _load_iter_state_plane(ckpt_dir: str, retry: RetryPolicy) -> Any:
    """Decode the data-iterator plane: manifest-driven, CRC-verified."""
    ddir = os.path.join(ckpt_dir, "data")
    manifest = _read_json(os.path.join(ddir, "manifest.json"),
                          "data-iterator manifest", retry)
    if len(manifest) != 1:
        raise CheckpointCorruptError(
            f"data-iterator plane at {ddir} has {len(manifest)} manifest "
            "entries, expected exactly 1")
    (key, entry), = manifest.items()
    fpath = os.path.join(ddir, entry["file"])
    arr = _read_npy(fpath, retry, key)
    _verify_leaf(arr, entry, key, fpath)
    try:
        return json.loads(bytes(arr.tobytes()).decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise CheckpointCorruptError(
            f"data-iterator plane at {fpath} is unparseable: {e}")


def _capture_iter_state(engine) -> Optional[Any]:
    """The engine's data-iterator state, or None (no checkpointable
    loader: no data plane, and the checkpoint loads like a legacy one)."""
    fn = getattr(engine, "data_iterator_state", None)
    return fn() if callable(fn) else None


# ---------------------------------------------------------------------------
# verification (status without loading)
# ---------------------------------------------------------------------------
def _manifest_digest_error(ckpt_dir: str, plane: str, want: str,
                           retry: RetryPolicy = DEFAULT_RETRY
                           ) -> Tuple[Optional[str], Optional[dict]]:
    """The one manifest-digest check (checkpoint_status and the load path
    share it): returns (error, parsed_manifest)."""
    mpath = os.path.join(ckpt_dir, plane, "manifest.json")

    def read():
        fault_point("read", mpath)
        with open(mpath, "rb") as f:
            return f.read()
    try:
        data = io_retry(read, f"read {mpath}", retry, on_retry=_on_retry)
    except OSError as e:
        return f"{mpath}: {e}", None
    if hashlib.sha256(data).hexdigest() != want:
        return (f"{mpath}: manifest digest mismatch — the manifest was "
                "modified or truncated after the save"), None
    try:
        return None, json.loads(data)
    except ValueError as e:
        return f"{mpath}: unparseable ({e})", None


def checkpoint_status(ckpt_dir: str, deep: bool = False,
                      retry: RetryPolicy = DEFAULT_RETRY
                      ) -> Tuple[str, str]:
    """Classify a checkpoint directory: ``(CKPT_OK | CKPT_CORRUPT |
    CKPT_MISSING, detail)``.  Structural check: meta parses, manifest
    digests match, every referenced file exists with a plausible size;
    ``deep=True`` also re-reads every leaf and verifies its CRC."""
    if not os.path.isdir(ckpt_dir):
        return CKPT_MISSING, f"no directory at {ckpt_dir}"
    meta_path = os.path.join(ckpt_dir, "meta.json")
    if not os.path.isfile(meta_path):
        return CKPT_CORRUPT, (f"{ckpt_dir} has no meta.json "
                              "(crashed or partial save)")
    try:
        meta = _read_json(meta_path, "meta.json", retry)
    except (CheckpointCorruptError, OSError) as e:
        return CKPT_CORRUPT, str(e)
    digests = meta.get("manifest_digests") or {}
    for plane, want in sorted(digests.items()):
        err, manifest = _manifest_digest_error(ckpt_dir, plane, want,
                                               retry)
        if err:
            return CKPT_CORRUPT, err
        err = _verify_manifest_files(os.path.join(ckpt_dir, plane),
                                     manifest, deep, retry)
        if err:
            return CKPT_CORRUPT, err
    return CKPT_OK, ""


def _verify_manifest_files(plane_dir: str, manifest: dict, deep: bool,
                           retry: RetryPolicy) -> Optional[str]:
    for key, entry in manifest.items():
        if entry.get("sharded"):
            err = _verify_shard_files(plane_dir, key, entry, deep, retry)
            if err:
                return err
            continue
        fpath = os.path.join(plane_dir, entry["file"])
        if not os.path.isfile(fpath):
            return f"{key!r}: file {fpath} is missing"
        nbytes = entry.get("nbytes")
        if nbytes is not None and os.path.getsize(fpath) < int(nbytes):
            return (f"{key!r}: file {fpath} is {os.path.getsize(fpath)} "
                    f"bytes, smaller than its {nbytes} recorded data bytes "
                    "(truncated)")
        if deep and entry.get("crc32") is not None:
            try:
                arr = _read_npy(fpath, retry, key)
                _verify_leaf(arr, entry, key, fpath)
            except CheckpointCorruptError as e:
                return str(e)
    return None


def _verify_shard_files(plane_dir: str, key: str, entry: dict, deep: bool,
                        retry: RetryPolicy) -> Optional[str]:
    """A sharded leaf's index files and the shard files they list."""
    idx_files = _shard_index_files(plane_dir, int(entry["leaf"]))
    if not idx_files:
        return f"{key!r}: no shard index files in {plane_dir}"
    for jf in idx_files:
        try:
            shards = _read_json(jf, "shard index", retry)
        except CheckpointCorruptError as e:
            return str(e)
        for shard in shards:
            fpath = os.path.join(plane_dir, shard["file"])
            if not os.path.isfile(fpath):
                return f"{key!r}: shard file {fpath} is missing"
            nbytes = shard.get("nbytes")
            if nbytes is not None and os.path.getsize(fpath) < int(nbytes):
                return (f"{key!r}: shard file {fpath} is smaller than its "
                        f"{nbytes} recorded data bytes (truncated)")
            if deep:
                try:
                    _verify_leaf(_read_npy(fpath, retry, key), shard, key,
                                 fpath)
                except CheckpointCorruptError as e:
                    return str(e)
    return None


# ---------------------------------------------------------------------------
# engine-level save
# ---------------------------------------------------------------------------
def _host_snapshot(tree: Any) -> Any:
    """The tree fully on the host, every leaf a private COPY: the engine
    updates the master in place on its device (and a CPU tensor's
    ``.cpu()`` is the live tensor itself), so an async writer must own
    its bytes before training continues."""
    def snap(_key, x):
        if isinstance(x, ShardPiece):
            return x.with_tensor(x.tensor.detach().to("cpu", copy=True))
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True)
        return np.array(x, copy=True)
    return tree_map_with_keys(snap, tree)


def _surface_writer_error(engine, err):
    if err is None:
        return
    logger.error(
        "previous async checkpoint save failed (that save was lost; "
        "this save proceeds from the current state): %s", err)
    # the training thread's advertised surface must record it too
    engine.last_ckpt_error = err
    with _tel_sink(engine):
        _count("ckpt_save_failures_total",
               "checkpoint saves that failed (async writer or sync)")


def _write_checkpoint_files(save_dir: str, tag: str, ckpt_dir: str,
                            tmp_dir: str, model_plane: Any,
                            optim_plane: Any, meta: dict,
                            save_latest: bool, keep_last_n: int,
                            retry: RetryPolicy, span=None,
                            data_plane: Any = None,
                            process_index: int = 0,
                            barrier: Optional[Callable[[], None]] = None
                            ) -> str:
    """The single serialization path sync and async saves share (which
    is what makes async == sync bitwise): tmp-dir staging, per-plane
    manifests with CRCs, meta with manifest digests, fsync, verification
    of the STAGED dir, swap-rename, ``latest`` update, then retention GC
    — destruction strictly AFTER the new save verifies.  Across several
    processes every rank writes its pieces between ``barrier`` calls and
    rank 0 stages the directory, writes the rest and publishes."""
    span = span or (lambda name: contextlib.nullcontext())
    barrier = barrier or (lambda: None)
    rank0 = process_index == 0
    # injected write latency (overlap proofs): DS_STAGE_DELAY_S=ckpt:sec
    # or its legacy DS_CKPT_DELAY_S alias
    from .stages import injected_delay
    delay = injected_delay("ckpt")
    if delay > 0:
        time.sleep(delay)
    if rank0 and os.path.isdir(tmp_dir):
        import shutil
        io_retry(lambda: shutil.rmtree(tmp_dir), f"clear {tmp_dir}", retry,
                 on_retry=_on_retry)
    if rank0:
        os.makedirs(tmp_dir, exist_ok=True)
    barrier()
    with span("checkpoint/save_model_plane"):
        model_digest = save_tree(os.path.join(tmp_dir, "model"),
                                 model_plane, retry=retry,
                                 process_index=process_index)
    with span("checkpoint/save_optim_plane"):
        optim_digest = save_tree(os.path.join(tmp_dir, "optim"),
                                 optim_plane, retry=retry,
                                 process_index=process_index)
    barrier()
    if not rank0:
        barrier()
        return ckpt_dir
    meta = dict(meta)
    meta["format_version"] = CKPT_FORMAT_VERSION
    meta["manifest_digests"] = {"model": model_digest,
                                "optim": optim_digest}
    if data_plane is not None:
        with span("checkpoint/save_data_plane"):
            meta["manifest_digests"]["data"] = save_tree(
                os.path.join(tmp_dir, "data"), data_plane, retry=retry)
    _write_bytes(os.path.join(tmp_dir, "meta.json"),
                 json.dumps(meta, indent=1).encode(), retry, point="meta")
    # verify the STAGED dir before anything is destroyed or published
    status, why = checkpoint_status(tmp_dir, deep=False, retry=retry)
    if status != CKPT_OK:
        raise CheckpointCorruptError(
            f"freshly written checkpoint staging {tmp_dir} failed "
            f"verification ({why}); `{LATEST_FILE}` untouched, retention "
            "GC skipped, nothing was deleted")
    _publish_staged(save_dir, tag, ckpt_dir, tmp_dir, save_latest,
                    keep_last_n, retry)
    barrier()
    log_dist(f"saved checkpoint {ckpt_dir}", ranks=[0])
    return ckpt_dir


def _publish_staged(save_dir: str, tag: str, ckpt_dir: str, tmp_dir: str,
                    save_latest: bool, keep_last_n: int,
                    retry: RetryPolicy) -> None:
    """Publish a VERIFIED staged checkpoint: swap-rename (an existing
    same-tag checkpoint is parked at ``<tag>.replaced.tmp`` and restored
    if the publish fails), fsync the dir, move ``latest``, then
    retention GC."""
    import shutil
    old_dir = None
    if os.path.isdir(ckpt_dir):
        old_dir = ckpt_dir + ".replaced.tmp"
        if os.path.isdir(old_dir):
            io_retry(lambda: shutil.rmtree(old_dir),
                     f"clear {old_dir}", retry, on_retry=_on_retry)
        io_retry(lambda: os.rename(ckpt_dir, old_dir),
                 f"park {ckpt_dir}", retry, on_retry=_on_retry)

    def rename():
        fault_point("rename", ckpt_dir)
        os.rename(tmp_dir, ckpt_dir)
    try:
        io_retry(rename, f"rename {tmp_dir} -> {ckpt_dir}", retry,
                 on_retry=_on_retry)
    except Exception:
        if old_dir is not None:
            try:
                os.rename(old_dir, ckpt_dir)  # restore the old good copy
            except OSError as e:
                logger.error("could not restore %s after failed publish: "
                             "%s (parked at %s)", ckpt_dir, e, old_dir)
        raise
    if old_dir is not None:
        try:
            shutil.rmtree(old_dir)
        except OSError:
            pass  # orphan sweep reclaims it on the next save
    _fsync_dir(save_dir)
    _count("ckpt_saves_total", "checkpoints written and verified")
    if save_latest:
        def write_latest():
            fault_point("latest", save_dir)
            latest_tmp = os.path.join(save_dir, LATEST_FILE + ".tmp")
            with open(latest_tmp, "w") as f:
                f.write(tag)
                f.flush()
                if _fsync_enabled():
                    os.fsync(f.fileno())
            os.replace(latest_tmp, os.path.join(save_dir, LATEST_FILE))
        io_retry(write_latest, f"update {save_dir}/{LATEST_FILE}", retry,
                 on_retry=_on_retry)
    if keep_last_n > 0:
        # protect the tag `latest` names too
        protect = {tag}
        try:
            with open(os.path.join(save_dir, LATEST_FILE)) as f:
                protect.add(f.read().strip())
        except OSError:
            pass
        removed = retention_gc(save_dir, keep_last_n, protect=protect,
                               retry=retry)
        _count("ckpt_gc_removed_total",
               "old checkpoint tags + orphaned tmp dirs reclaimed",
               removed)


def _optim_plane(engine, master_tree, opt_tree) -> dict:
    """The optimizer plane in the JAX engine's tree: master, optimizer
    state, loss scaler and the two PRNG keys."""
    return {
        "master_params": master_tree,
        "opt_state": opt_tree,
        "scaler": engine.state.scaler,
        "rng": seed_to_key(engine._rng),
        "data_rng": seed_to_key(engine._data_rng),
    }


def _build_save_job(engine, save_dir: str, tag: str, ckpt_dir: str,
                    tmp_dir: str, client_state: Optional[dict],
                    save_latest: bool, cfg: _CkptCfg,
                    async_write: bool) -> CheckpointJob:
    """Snapshot the state to the host NOW when ``async_write`` (the only
    step-loop-exposed cost of an async save) and return a write job."""
    tracer = getattr(getattr(engine, "telemetry", None), "tracer", None)
    ctx = None
    with _tel_span(engine, "checkpoint/snapshot", tag=tag):
        if tracer is not None:
            # causal arrow: flow opened inside the submitting step's
            # save/snapshot span, terminated inside the writer's
            # async_write span (host-side appends only)
            from ..telemetry.tracing import TraceContext
            ctx = TraceContext.new()
            tracer.flow_start("checkpoint/job", ctx, cat="checkpoint",
                              tag=tag)
        master_tree, opt_tree = engine._checkpoint_state()
        module_params = _cast_pieces(master_tree, engine.compute_dtype)
        model_plane = {"module": module_params}
        optim_plane = _optim_plane(engine, master_tree, opt_tree)
        if async_write:
            # the host COPY makes the job immune to the training that
            # continues while the writer serializes; a sync save runs the
            # job before returning and streams the live leaves instead
            model_plane = _host_snapshot(model_plane)
            optim_plane = _host_snapshot(optim_plane)
        # captured NOW, so an async save records the consumption point
        # matching the model state
        iter_state = _capture_iter_state(engine)
        data_plane = (_iter_state_plane(iter_state)
                      if iter_state is not None else None)
    meta = {
        "tag": tag,
        "global_steps": int(engine.global_steps),
        "micro_steps": int(engine.micro_steps),
        "skipped_steps": int(engine.state.skipped_steps),
        "dp_world_size": int(engine.dp_world_size),
        "zero_stage": int(engine.config.zero_optimization_stage),
        "client_state": client_state or {},
    }
    eng_ref = weakref.ref(engine)
    mesh = getattr(engine, "mesh", None)
    process_index = mesh.rank if mesh is not None else 0
    barrier = None
    if mesh is not None and mesh.size > 1:
        import torch.distributed as dist
        group = mesh.group("world")

        def barrier():
            dist.barrier(group=group)

    def run():
        eng = eng_ref()
        t0 = time.perf_counter()
        span = (_tel_span(eng, "checkpoint/async_write", tag=tag)
                if async_write and eng is not None
                else contextlib.nullcontext())
        with _tel_sink(eng), span:
            run_tracer = getattr(getattr(eng, "telemetry", None),
                                 "tracer", None)
            if ctx is not None and run_tracer is not None:
                # inside the write span: sync saves close the flow in
                # the save span itself, async saves on the writer thread
                run_tracer.flow_end("checkpoint/job", ctx,
                                    cat="checkpoint", tag=tag)
            _write_checkpoint_files(
                save_dir, tag, ckpt_dir, tmp_dir, model_plane,
                optim_plane, meta, save_latest, cfg.keep_last_n,
                cfg.retry,
                span=lambda name: _tel_span(eng, name, tag=tag),
                data_plane=data_plane, process_index=process_index,
                barrier=barrier)
        if async_write and eng is not None:
            acc = getattr(eng, "_ckpt_interval_acc", None)
            if acc is not None:
                # write wall time hidden behind training (the
                # ckpt_async_overlap_s scalar), per WRITTEN save, under
                # the engine's lock: the telemetry sync's read-and-reset
                # runs on the training thread
                with getattr(eng, "_ckpt_acc_lock",
                             contextlib.nullcontext()):
                    acc["overlap_s"] += time.perf_counter() - t0
                    acc["writes"] = acc.get("writes", 0) + 1
        return ckpt_dir

    return CheckpointJob(tag=tag, tmp_dir=tmp_dir, final_dir=ckpt_dir,
                         run=run, ctx=ctx)


def _cast_pieces(tree, dtype):
    """The master tree cast to the compute dtype, pieces kept pieces."""
    from . import precision

    def cast(_key, x):
        if isinstance(x, ShardPiece):
            return x.with_tensor(precision.cast_to_compute(x.tensor, dtype))
        return precision.cast_to_compute(x, dtype)
    return tree_map_with_keys(cast, tree)


def save_checkpoint(engine, save_dir: str, tag: Optional[str] = None,
                    client_state: Optional[dict] = None,
                    save_latest: bool = True,
                    async_write: bool = False) -> str:
    """Two-plane checkpoint write (reference engine.py:1211-1290).

    Atomic: everything lands in ``<tag>.tmp`` and is renamed into place
    only after ``meta.json`` (written last) is on disk and the staged dir
    verifies, so a killed save never leaves a loadable-looking partial
    checkpoint.  ``async_write=True`` snapshots the state to host and
    hands serialization to the engine's daemon writer; a second async
    save while one is in flight coalesces (latest wins); a sync save
    first drains the writer (ordering); a writer failure poisons only
    that save.  The model plane duplicates a down-cast of the fp32 master
    so module-only loads need no optimizer plane."""
    if tag is None:
        tag = f"global_step{engine.global_steps}"
    tag = str(tag)
    ckpt_dir = os.path.join(save_dir, tag)
    tmp_dir = ckpt_dir + ".tmp"
    cfg = _ckpt_config(engine)
    mesh = getattr(engine, "mesh", None)
    if async_write and mesh is not None and mesh.size > 1:
        raise NotImplementedError(
            "an async checkpoint save across processes is not ported to "
            "deepspeed_tpu_torch yet: ROADMAP.md queue 1, item 9 (its "
            "remaining half)")
    writer: Optional[AsyncCheckpointWriter] = getattr(
        engine, "_ckpt_writer", None)
    if not async_write and writer is not None and writer.in_flight():
        # ordering: a pending async save must land (or fail) before a
        # synchronous one renames over it / moves `latest` past it
        from .engine_stages import drain_ckpt_stage
        drain_ckpt_stage(engine)

    with _tel_sink(engine):
        # hygiene: reclaim orphaned <*>.tmp dirs from crashed saves,
        # skipping the live writer's dirs (rank 0's job)
        keep = writer.active_tmp() if writer is not None else set()
        removed = (sweep_tmp(save_dir, keep=keep, retry=cfg.retry)
                   if mesh is None or mesh.rank == 0 else 0)
        _count("ckpt_gc_removed_total",
               "old checkpoint tags + orphaned tmp dirs reclaimed",
               removed)

    job = _build_save_job(engine, save_dir, tag, ckpt_dir, tmp_dir,
                          client_state, save_latest, cfg, async_write)
    if async_write:
        if writer is None:
            writer = engine._ckpt_writer = AsyncCheckpointWriter(
                stage=getattr(engine, "_stage_records",
                              {}).get("ckpt_writer"))
        writer.submit(job)
        return ckpt_dir
    with _tel_sink(engine):
        try:
            job.run()
        except OSError as e:
            # exhausted-retry I/O failure: the load side's typed vocabulary
            _count("ckpt_save_failures_total",
                   "checkpoint saves that failed (async writer or sync)")
            raise CheckpointError(
                f"checkpoint save to {ckpt_dir} failed after "
                f"{cfg.retry.attempts} attempts: {e}") from e
        except CheckpointError:
            _count("ckpt_save_failures_total",
                   "checkpoint saves that failed (async writer or sync)")
            raise
    return ckpt_dir


# ---------------------------------------------------------------------------
# engine-level load
# ---------------------------------------------------------------------------
def load_checkpoint(engine, load_dir: str, tag: Optional[str] = None,
                    load_optimizer_states: bool = True,
                    load_lr_scheduler_states: bool = True,
                    load_module_only: bool = False):
    """Restore engine state; returns ``(load_path, client_state)`` like the
    reference (engine.py:1292-1324).

      - ``tag=None`` with no ``latest`` file → a fresh run: ``(None,
        None)``.
      - ``tag=None`` where ``latest`` names a missing or corrupt tag →
        logs loudly and walks back to the newest on-disk tag that loads
        with every per-leaf CRC verified, bounded by
        ``checkpoint.load_fallback`` older candidates; raises
        ``CheckpointCorruptError`` if none do.
      - an EXPLICIT ``tag=`` that is absent raises
        ``CheckpointMissingError``; one that fails verification raises
        ``CheckpointCorruptError`` — both name the path.

    ``load_lr_scheduler_states`` is accepted for API parity: every lr
    schedule is a pure function of the restored step count."""
    cfg = _ckpt_config(engine)
    retry = cfg.retry
    with _tel_sink(engine):
        if tag is not None:
            ckpt_dir = os.path.join(load_dir, str(tag))
            if not os.path.isdir(ckpt_dir):
                raise CheckpointMissingError(
                    f"checkpoint tag {str(tag)!r} was explicitly "
                    f"requested but {ckpt_dir} does not exist")
            if not os.path.isfile(os.path.join(ckpt_dir, "meta.json")):
                _count("ckpt_corrupt_total",
                       "checkpoints that failed integrity verification")
                raise CheckpointCorruptError(
                    f"checkpoint tag {str(tag)!r} at {ckpt_dir} has no "
                    "meta.json — a crashed or partial save, not a "
                    "loadable checkpoint")
            return _load_into_engine(
                engine, ckpt_dir, load_optimizer_states,
                load_module_only, retry)

        latest_path = os.path.join(load_dir, LATEST_FILE)
        if not os.path.isfile(latest_path):
            hint = ""
            tags = list_tags(load_dir)
            if tags:
                hint = (f" ({len(tags)} tag dir(s) exist but no "
                        f"'{LATEST_FILE}' file names one — pass tag= "
                        "explicitly to load them)")
            log_dist(f"no 'latest' file in {load_dir}; nothing to "
                     f"load{hint}", ranks=[0])
            return None, None
        with open(latest_path) as f:
            latest_tag = f.read().strip()
        candidates = [latest_tag] + [t for t in list_tags(load_dir)
                                     if t != latest_tag]
        limit = 1 + max(int(cfg.load_fallback), 0)
        errors = []
        for t in candidates[:limit]:
            d = os.path.join(load_dir, t)
            if not os.path.isfile(os.path.join(d, "meta.json")):
                _count("ckpt_corrupt_total",
                       "checkpoints that failed integrity verification")
                logger.error(
                    "checkpoint fallback: tag %r at %s is %s — trying "
                    "the next newest on-disk tag",
                    t, d, "missing" if not os.path.isdir(d)
                    else "missing its meta.json")
                errors.append(f"{t}: missing or no meta.json")
                continue
            # every leaf read is CRC-checked lazily and a corrupt
            # candidate raises BEFORE engine state is touched
            try:
                return _load_into_engine(
                    engine, d, load_optimizer_states, load_module_only,
                    retry)
            except CheckpointCorruptError as e:
                _count("ckpt_corrupt_total",
                       "checkpoints that failed integrity verification")
                logger.error(
                    "checkpoint tag %r is CORRUPT (%s) — falling back to "
                    "the next newest tag that verifies", t, e)
                errors.append(f"{t}: {e}")
        raise CheckpointCorruptError(
            f"no loadable checkpoint under {load_dir}: tried "
            f"{min(len(candidates), limit)} candidate(s) "
            f"(checkpoint.load_fallback={cfg.load_fallback}); "
            + "; ".join(errors))


def _load_into_engine(engine, ckpt_dir: str, load_optimizer_states: bool,
                      load_module_only: bool, retry: RetryPolicy):
    """Restore from one candidate dir.  Every read is integrity-checked
    (manifest digest first, then per-leaf CRC inside load_tree); any
    corruption raises BEFORE engine state is replaced, so a caller can
    walk to an older tag safely."""
    meta = _read_json(os.path.join(ckpt_dir, "meta.json"), "meta.json",
                      retry)
    digests = meta.get("manifest_digests") or {}

    def check_digest(plane):
        want = digests.get(plane)
        if want is None:
            return  # pre-integrity checkpoint: load on trust
        err, _ = _manifest_digest_error(ckpt_dir, plane, want, retry)
        if err:
            raise CheckpointCorruptError(f"checkpoint {err}")

    optim_dir = os.path.join(ckpt_dir, "optim")
    use_optim = (load_optimizer_states and not load_module_only
                 and os.path.isdir(optim_dir))
    # the data plane is read and verified NOW, before any state is
    # replaced; it is applied to the loader at the end.  Module-only
    # loads are not a resume and skip it.
    iter_state = None
    has_data_plane = ("data" in digests
                      or os.path.isdir(os.path.join(ckpt_dir, "data")))
    if has_data_plane and use_optim:
        check_digest("data")
        with _tel_span(engine, "checkpoint/load_data_plane"):
            iter_state = _load_iter_state_plane(ckpt_dir, retry)
    elif (not has_data_plane and use_optim
          and _capture_iter_state(engine) is not None):
        logger.warning(
            "checkpoint %s predates the data-iterator plane (or was "
            "saved without a checkpointable loader): the training data "
            "iterator starts FRESH — the resumed run will replay or "
            "skip data relative to the interrupted one (model/optimizer "
            "state restore exactly)", ckpt_dir)
    tmpl_master, tmpl_opt = engine._checkpoint_state()
    rng_seed = data_seed = None
    if use_optim:
        check_digest("optim")
        with _tel_span(engine, "checkpoint/load_optim_plane"):
            loaded = load_tree(optim_dir, _optim_plane(
                engine, tmpl_master, tmpl_opt), retry=retry)
        master, opt_state = loaded["master_params"], loaded["opt_state"]
        scaler = loaded["scaler"]
        rng_seed = key_to_seed(loaded["rng"])
        data_seed = key_to_seed(loaded["data_rng"])
    else:
        # fp16-cast restore: module weights promoted to a fresh fp32 master
        check_digest("model")
        module_tmpl = _cast_pieces(tmpl_master, engine.compute_dtype)
        with _tel_span(engine, "checkpoint/load_model_plane"):
            loaded = load_tree(os.path.join(ckpt_dir, "model"),
                               {"module": module_tmpl}, retry=retry)
        master = tree_map_with_keys(lambda _k, x: x.float(),
                                    loaded["module"])
        opt_state = None
        scaler = engine.state.scaler
    engine._adopt_loaded(master, opt_state, scaler,
                         skipped_steps=int(meta["skipped_steps"]))
    if rng_seed is not None:
        engine._rng, engine._data_rng = rng_seed, data_seed
    engine.global_steps = int(meta["global_steps"])
    engine.micro_steps = int(meta["micro_steps"])
    if iter_state is not None:
        apply_fn = getattr(engine, "load_data_iterator_state", None)
        if callable(apply_fn):
            apply_fn(iter_state)
    log_dist(
        f"loaded checkpoint {ckpt_dir} (saved at dp={meta['dp_world_size']} "
        f"zero={meta['zero_stage']}; now dp={engine.dp_world_size} "
        f"zero={engine.config.zero_optimization_stage})", ranks=[0])
    return ckpt_dir, meta.get("client_state", {})
