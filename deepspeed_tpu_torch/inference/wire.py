"""Minimal length-prefixed socket protocol for the serving fleet
(docs/serving.md "serving fleet"; a copy of
``deepspeed_tpu/inference/wire.py``: both packages speak the same bytes).

One frame = a 4-byte big-endian length prefix + a UTF-8 JSON object.
That is the ENTIRE protocol: the router stays import-light (stdlib
only, no serialization deps) and a replica stays an ordinary
``ServeEngine`` with a socket pump bolted on.  Frames are small host
bookkeeping (token ids, rids, gauges) — never tensors — so JSON's
overhead is noise next to a decode tick.

Frame kinds (the ``kind`` key):

  replica → router
    ``hello``     {replica, pid}            connection handshake
    ``admit``     {rid}                     the engine admitted rid —
                                            the router stamps queue
                                            wait NOW (the SLO signal)
    ``token``     {rid, toks: [int, ...]}   newly generated tokens
    ``done``      {rid, reason, tokens_total}
    ``error``     {rid, error}              per-request failure
    ``migrate_out`` {rid, first_token, kv_len, pages, ...}
                                            a prefill replica finished
                                            rid's prefill; ``pages``
                                            binary page frames follow
  router → replica
    ``submit``    {rid, prompt, max_new_tokens, eos_id[, migrate]}
    ``migrate_in``  {rid, prompt, first_token, kv_len, pages, ...}
                                            adopt rid mid-decode; the
                                            binary page frames follow
    ``shutdown``  {}                        drain in-flight, then exit 0

Binary page frames (disaggregated prefill/decode, docs/serving.md
"disaggregated fleet"): KV pages are tensors, so JSON is the wrong
envelope.  A binary frame sets the top bit of the 4-byte length prefix
and its body is ``[4-byte header length][JSON header][raw payload]
[4-byte CRC32]`` — the CRC covers everything before it, and a mismatch
raises :class:`WireError` (connection-fatal: a corrupt page must fail
the CONNECTION, never be silently adopted into a KV pool).  JSON and
binary frames interleave freely on one socket; :class:`FrameReader`
yields dicts for JSON frames and :class:`BinaryFrame` objects (which
quack like dicts for ``get``) for binary ones.

Framing is torn-read safe by construction: :class:`FrameReader`
buffers partial reads and yields only complete frames, so a
non-blocking pump can feed it whatever ``recv`` returned — including a
read torn mid page payload.  An oversized or non-JSON frame raises
:class:`WireError` — a corrupt stream must fail the CONNECTION (the
router's failover path), never silently resync.
"""
from __future__ import annotations

import json
import select
import socket
import struct
import zlib
from collections import deque
from typing import List, Tuple, Union

#: hard frame cap — a fleet frame is host bookkeeping or ONE bounded
#: KV page, so anything bigger is a corrupt length prefix, not a real
#: message
MAX_FRAME_BYTES = 16 << 20

_LEN = struct.Struct(">I")

#: top bit of the length prefix marks a BINARY frame (header + raw
#: payload + CRC32); clear = the original JSON frame.  The cap keeps
#: lengths below 2**31, so the bit is unambiguous.
BINARY_FLAG = 0x80000000


class WireError(RuntimeError):
    """Corrupt framing (oversized length, non-JSON payload, CRC
    mismatch on a binary page frame): the connection is unrecoverable —
    tear it down and fail over."""


class BinaryFrame:
    """One decoded binary frame: a JSON ``header`` dict riding a raw
    byte ``payload`` (a KV page on the migration path).  ``get``/
    ``kind`` delegate to the header so frame-dispatch loops written for
    JSON dicts handle both shapes."""

    __slots__ = ("header", "payload")

    def __init__(self, header: dict, payload: bytes):
        self.header = header
        self.payload = payload

    def get(self, key, default=None):
        return self.header.get(key, default)

    @property
    def kind(self):
        return self.header.get("kind")

    def __repr__(self):
        return (f"BinaryFrame({self.header!r}, "
                f"<{len(self.payload)} bytes>)")


def encode_frame(obj: dict) -> bytes:
    payload = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(payload) > MAX_FRAME_BYTES:
        raise WireError(f"frame of {len(payload)} bytes exceeds the "
                        f"{MAX_FRAME_BYTES}-byte cap")
    return _LEN.pack(len(payload)) + payload


def encode_binary_frame(header: dict, payload: bytes) -> bytes:
    """One binary frame: flagged length prefix + [header length][JSON
    header][payload][CRC32 of everything before the CRC]."""
    hdr = json.dumps(header, separators=(",", ":")).encode("utf-8")
    body = _LEN.pack(len(hdr)) + hdr + bytes(payload)
    body += _LEN.pack(zlib.crc32(body) & 0xFFFFFFFF)
    if len(body) > MAX_FRAME_BYTES:
        raise WireError(
            f"binary frame of {len(body)} bytes exceeds the "
            f"{MAX_FRAME_BYTES}-byte cap (a KV page is bounded — "
            "split the transfer per page)")
    return _LEN.pack(BINARY_FLAG | len(body)) + body


def send_binary_frame(sock: socket.socket, header: dict,
                      payload: bytes) -> None:
    sock.sendall(encode_binary_frame(header, payload))


def send_frame(sock: socket.socket, obj: dict) -> None:
    """Blocking send of one frame (``sendall`` — frames are small, and
    a partial write would corrupt the stream for every later frame)."""
    sock.sendall(encode_frame(obj))


class FrameReader:
    """Incremental decoder.  ``feed(data)`` buffers whatever a
    (possibly non-blocking) ``recv`` returned and returns the complete
    frames it closed over — zero, one, or many.  Frames a caller sets
    aside (e.g. everything after a ``hello`` during the handshake)
    ride ``pending`` until the next :func:`drain_socket`."""

    def __init__(self):
        self._buf = bytearray()
        self.pending: deque = deque()

    def feed(self, data: bytes) -> List[Union[dict, BinaryFrame]]:
        self._buf.extend(data)
        frames: List[Union[dict, BinaryFrame]] = []
        while True:
            if len(self._buf) < _LEN.size:
                return frames
            (raw,) = _LEN.unpack_from(self._buf)
            binary = bool(raw & BINARY_FLAG)
            n = raw & ~BINARY_FLAG
            if n > MAX_FRAME_BYTES:
                raise WireError(
                    f"frame length {n} exceeds the {MAX_FRAME_BYTES}-"
                    "byte cap (corrupt stream)")
            if len(self._buf) < _LEN.size + n:
                return frames
            payload = bytes(self._buf[_LEN.size:_LEN.size + n])
            del self._buf[:_LEN.size + n]
            frames.append(self._parse_binary(payload) if binary
                          else self._parse_json(payload))

    @staticmethod
    def _parse_json(payload: bytes) -> dict:
        try:
            obj = json.loads(payload.decode("utf-8"))
        except (UnicodeDecodeError, ValueError) as e:
            raise WireError(f"unparseable frame payload: {e}")
        if not isinstance(obj, dict):
            raise WireError(
                f"frame must be a JSON object, got "
                f"{type(obj).__name__}")
        return obj

    @staticmethod
    def _parse_binary(body: bytes) -> BinaryFrame:
        # body = [4-byte header len][JSON header][payload][CRC32]; the
        # CRC covers everything before it.  Any violation is a
        # connection-fatal WireError — a corrupt page must never be
        # silently adopted into a KV pool.
        if len(body) < 2 * _LEN.size:
            raise WireError(
                f"binary frame body of {len(body)} bytes is shorter "
                "than its fixed fields (corrupt stream)")
        (want,) = _LEN.unpack_from(body, len(body) - _LEN.size)
        got = zlib.crc32(body[:-_LEN.size]) & 0xFFFFFFFF
        if got != want:
            raise WireError(
                f"binary frame CRC mismatch: computed {got:#010x}, "
                f"frame says {want:#010x} (corrupt stream)")
        (hlen,) = _LEN.unpack_from(body)
        if _LEN.size + hlen > len(body) - _LEN.size:
            raise WireError(
                f"binary frame header length {hlen} overruns the "
                f"{len(body)}-byte body (corrupt stream)")
        header = FrameReader._parse_json(body[_LEN.size:_LEN.size + hlen])
        return BinaryFrame(header, body[_LEN.size + hlen:-_LEN.size])


def drain_socket(sock: socket.socket, reader: FrameReader) -> \
        Tuple[List[Union[dict, BinaryFrame]], bool]:
    """Non-blocking drain: every complete frame currently readable
    (including any the reader had pending), plus whether the peer
    CLOSED the connection (EOF).  Works on blocking sockets too — each
    ``recv`` is gated by a zero-timeout ``select``, so a drain never
    stalls a single-threaded pump loop."""
    frames: List[Union[dict, BinaryFrame]] = list(reader.pending)
    reader.pending.clear()
    closed = False
    while True:
        try:
            readable, _, _ = select.select([sock], [], [], 0)
        except (OSError, ValueError):
            closed = True
            break
        if not readable:
            break
        try:
            data = sock.recv(65536)
        except (BlockingIOError, InterruptedError):
            break
        except OSError:
            closed = True
            break
        if not data:
            closed = True
            break
        frames.extend(reader.feed(data))
    return frames, closed
