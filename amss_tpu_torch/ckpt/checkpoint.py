"""Reading the JAX package's checkpoints without flax or msgpack.

A checkpoint is one msgpack document written by
``flax.serialization.msgpack_serialize``: nested maps with string keys whose
leaves are numbers, strings, ``None`` or arrays.  flax packs an array as
msgpack extension type 1 whose payload is itself a msgpack array
``[shape, dtype_name, raw_bytes]`` (C order, little-endian), and a numpy
scalar as extension type 3 with the same payload.  This module decodes that
subset in pure Python plus numpy and raises on anything else.
"""

from __future__ import annotations

import os
import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    """One pass over a msgpack buffer."""

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends inside an object")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def sint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big", signed=True)

    def obj(self):
        b = self.uint(1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.uint(1 << (b - 0xC4))))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.uint(1 << (b - 0xC7))
            return self.ext(self.sint(1), n)
        if b == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= b <= 0xCF:
            return self.uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:
            return self.sint(1 << (b - 0xD0))
        if 0xD4 <= b <= 0xD8:
            code = self.sint(1)
            return self.ext(code, 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return str(self.take(self.uint(1 << (b - 0xD9))), "utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.uint(2 << (b - 0xDC)))
        if b in (0xDE, 0xDF):
            return self.map(self.uint(2 << (b - 0xDE)))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, code: int, n: int):
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        raise ValueError(f"unsupported msgpack extension type {code}")


def _ndarray(payload: bytes) -> np.ndarray:
    inner = _Reader(payload)
    shape, name, raw = inner.obj()
    if inner.pos != len(payload):
        raise ValueError("trailing bytes in an ndarray payload")
    if isinstance(name, bytes):
        name = name.decode()
    shape = tuple(int(s) for s in shape)
    if name == "bfloat16":
        # numpy has no bfloat16: its bits are the high half of a float32
        bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    try:
        dtype = np.dtype(name).newbyteorder("<")
    except TypeError as e:
        raise ValueError(f"unsupported array dtype {name!r}") from e
    return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()


def msgpack_restore(data: bytes):
    """Decode one msgpack document as flax writes it."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(data):
        raise ValueError("trailing bytes after the msgpack document")
    return out


def _split_raw(raw: dict) -> tuple[dict, dict]:
    """(state, manifest): the current {"meta", "state"} layout or a bare state."""
    if isinstance(raw, dict) and set(raw.keys()) == {"meta", "state"}:
        return raw["state"], dict(raw["meta"])
    return raw, {}


def load_params(run_dir: str) -> dict:
    """The served parameter tree of a run dir, as numpy arrays.

    Reads ``ckpt_best.msgpack`` (else ``ckpt_latest.msgpack``), prefers
    ``ema_params`` over ``params`` as the JAX package's loader does, and
    supplies the ``front`` key that a parameter-free STFT front leaves out."""
    path = os.path.join(run_dir, "ckpt_best.msgpack")
    if not os.path.exists(path):
        path = os.path.join(run_dir, "ckpt_latest.msgpack")
    with open(path, "rb") as f:
        raw = msgpack_restore(f.read())
    state, _ = _split_raw(raw)
    params = dict(state.get("ema_params", state["params"]))
    params.setdefault("front", {})
    return params
