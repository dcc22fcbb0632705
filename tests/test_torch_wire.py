"""The fleet's wire protocol (``inference/wire.py``) in both packages:
frames encoded by either decode in the other, both encode the same bytes,
and corrupt, torn and CRC-mismatched streams raise the same typed errors
in both — a replica of one package speaks to a router of the other."""
import socket
import struct
import zlib

import numpy as np
import pytest

from deepspeed_tpu.inference import wire as jwire
from deepspeed_tpu_torch.inference import wire as twire

PACKAGES = {"jax": jwire, "torch": twire}
PAIRS = [("jax", "torch"), ("torch", "jax")]

FRAMES = [{"kind": "hello", "replica": 3, "pid": 77, "role": "decode"},
          {"kind": "submit", "rid": 9, "prompt": [1, 2, 3],
           "max_new_tokens": 8, "eos_id": None, "migrate": True},
          {"kind": "token", "rid": 9, "toks": [5, 50256]},
          {"kind": "done", "rid": 9, "reason": "length",
           "tokens_total": 8},
          {"kind": "error", "rid": 4, "error": "RuntimeError('é δ')"},
          {"kind": "shutdown"}]


def _payload(n=4096, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def _stream(mod):
    """JSON frames interleaved with binary page frames."""
    out = b""
    for i, f in enumerate(FRAMES):
        out += mod.encode_frame(f)
        out += mod.encode_binary_frame(
            {"kind": "page", "rid": 9, "seq": i, "leaves": [1024, 1024]},
            _payload(2048, seed=i))
    return out


def test_both_packages_encode_the_same_bytes():
    for f in FRAMES:
        assert jwire.encode_frame(f) == twire.encode_frame(f)
    hdr = {"kind": "page", "rid": 1, "seq": 0, "leaves": [8, 8, 2, 2]}
    assert jwire.encode_binary_frame(hdr, _payload()) \
        == twire.encode_binary_frame(hdr, _payload())
    assert _stream(jwire) == _stream(twire)
    assert (jwire.MAX_FRAME_BYTES, jwire.BINARY_FLAG) \
        == (twire.MAX_FRAME_BYTES, twire.BINARY_FLAG)


@pytest.mark.parametrize("enc,dec", PAIRS)
def test_frames_cross_packages_whole_and_torn(enc, dec):
    blob = _stream(PACKAGES[enc])
    whole = PACKAGES[dec].FrameReader().feed(blob)
    r = PACKAGES[dec].FrameReader()
    torn = []
    for i in range(0, len(blob), 7):          # reads torn every 7 bytes
        torn.extend(r.feed(blob[i:i + 7]))
    for got in (whole, torn):
        assert len(got) == 2 * len(FRAMES)
        assert [got[2 * i] for i in range(len(FRAMES))] == FRAMES
        for i in range(len(FRAMES)):
            bf = got[2 * i + 1]
            assert isinstance(bf, PACKAGES[dec].BinaryFrame)
            assert bf.kind == "page" and bf.get("seq") == i
            assert bf.payload == _payload(2048, seed=i)


@pytest.mark.parametrize("enc,dec", PAIRS)
def test_frames_cross_packages_over_a_socket(enc, dec):
    a, b = socket.socketpair()
    try:
        PACKAGES[enc].send_frame(a, FRAMES[1])
        PACKAGES[enc].send_binary_frame(a, {"kind": "page", "rid": 9,
                                            "seq": 0}, _payload())
        a.close()
        got, closed = [], False
        reader = PACKAGES[dec].FrameReader()
        while not closed:
            frames, closed = PACKAGES[dec].drain_socket(b, reader)
            got.extend(frames)
        assert got[0] == FRAMES[1]
        assert got[1].payload == _payload()
    finally:
        b.close()


def _crc_flip(mod):
    good = bytearray(mod.encode_binary_frame(
        {"kind": "page", "rid": 1, "seq": 0}, b"\x55" * 128))
    good[-10] ^= 0x01
    return bytes(good)


def _header_overrun():
    body = struct.pack(">I", 9999) + b"xx"
    body += struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)
    return struct.pack(">I", 0x80000000 | len(body)) + body


CORRUPT = {
    "oversized length": lambda mod: b"\xff\xff\xff\xff",
    "non-JSON body": lambda mod: struct.pack(">I", 4) + b"\x00\x01\x02\x03",
    "JSON not an object": lambda mod: struct.pack(">I", 3) + b"[1]",
    "CRC mismatch": _crc_flip,
    "binary header overruns": lambda mod: _header_overrun(),
}


@pytest.mark.parametrize("case", sorted(CORRUPT))
@pytest.mark.parametrize("enc,dec", PAIRS)
def test_corrupt_streams_raise_the_same_typed_error(case, enc, dec):
    """Each package's reader raises its own ``WireError`` on a corrupt
    stream made by either package, with the same message."""
    blob = CORRUPT[case](PACKAGES[enc])
    msgs = []
    for name in (dec, enc):
        with pytest.raises(PACKAGES[name].WireError) as ei:
            PACKAGES[name].FrameReader().feed(blob)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("enc,dec", PAIRS)
def test_torn_stream_yields_only_complete_frames(enc, dec):
    """A stream cut mid binary payload yields the complete frames before
    the cut and holds the partial one (no error until more bytes)."""
    blob = PACKAGES[enc].encode_frame(FRAMES[0]) \
        + PACKAGES[enc].encode_binary_frame({"kind": "page", "rid": 1},
                                            _payload())
    cut = len(blob) - 100
    r = PACKAGES[dec].FrameReader()
    assert r.feed(blob[:cut]) == [FRAMES[0]]
    rest = r.feed(blob[cut:])
    assert len(rest) == 1 and rest[0].payload == _payload()
