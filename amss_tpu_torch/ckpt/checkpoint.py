"""Checkpoints in the JAX package's format, without flax or msgpack.

A checkpoint is one msgpack document written by
``flax.serialization.msgpack_serialize``: nested maps with string keys whose
leaves are numbers, strings, ``None`` or arrays.  flax packs an array as
msgpack extension type 1 whose payload is itself a msgpack array
``[shape, dtype_name, raw_bytes]`` (C order, little-endian), and a numpy
scalar as extension type 3 with the same payload.  This module decodes and
encodes that subset in pure Python plus numpy and raises on anything else;
the encoder writes the bytes flax writes for the same tree.

``save_checkpoint`` keeps the JAX package's rules: one file holds
``{"meta": {step, metric}, "state": ...}``, ``ckpt_latest.msgpack`` is always
written and ``ckpt_best.msgpack`` when the metric improves, a ``.json``
sidecar sits beside each, and every write is a temporary file moved into place
with ``os.replace``.
"""

from __future__ import annotations

import json
import os
import queue
import struct
import threading

import numpy as np
import torch

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


# -- encoding ----------------------------------------------------------------

_MAX_ARRAY_BYTES = 1 << 30  # flax splits larger arrays into chunks; never needed here


def _pack_len(out: bytearray, n: int, fix: tuple | None, codes: tuple) -> None:
    """A header with a length in msgpack's smallest form: ``fix`` is (first
    byte, limit) of the one-byte form, ``codes`` the 8-, 16- and 32-bit forms
    (None where a form does not exist)."""
    if fix is not None and n < fix[1]:
        out.append(fix[0] | n)
        return
    for code, size in zip(codes, (1, 2, 4)):
        if code is not None and n < 1 << (8 * size):
            out += bytes([code]) + n.to_bytes(size, "big")
            return
    raise ValueError(f"msgpack object of length {n} is too large")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, n in ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)):
            if v < 1 << (8 * n):
                out += bytes([code]) + v.to_bytes(n, "big")
                return
        raise ValueError(f"integer {v} does not fit msgpack")
    else:
        for code, n in ((0xD0, 1), (0xD1, 2), (0xD2, 4), (0xD3, 8)):
            if v >= -(1 << (8 * n - 1)):
                out += bytes([code]) + v.to_bytes(n, "big", signed=True)
                return
        raise ValueError(f"integer {v} does not fit msgpack")


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(out, n, None, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code) + payload


def _ndarray_payload(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialised")
    if a.size * a.dtype.itemsize > _MAX_ARRAY_BYTES:
        raise ValueError(f"array of {a.size * a.dtype.itemsize} bytes exceeds one chunk")
    out = bytearray()
    _pack(out, [list(a.shape), a.dtype.name, a.astype(a.dtype.newbyteorder("<")).tobytes("C")])
    return bytes(out)


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif type(obj) is int:
        _pack_int(out, obj)
    elif type(obj) is float:
        out += b"\xcb" + struct.pack(">d", obj)
    elif type(obj) is str:
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out += raw
    elif type(obj) is bytes:
        _pack_len(out, len(obj), None, (0xC4, 0xC5, 0xC6))
        out += obj
    elif type(obj) is list:
        _pack_len(out, len(obj), (0x90, 16), (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif type(obj) is dict:
        _pack_len(out, len(obj), (0x80, 16), (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_payload(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)))
    else:
        raise TypeError(f"cannot serialise {type(obj).__name__} to a checkpoint")


def msgpack_serialize(tree) -> bytes:
    """Encode a tree of dicts with string keys, Python scalars and numpy
    arrays as flax's ``to_bytes`` does."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


def to_host(tree):
    """A state tree as the JAX package writes it: tensors and numbers become
    numpy arrays (a Python int an int64 array, as ``np.asarray`` makes it), and
    every dict's keys are sorted, as a JAX tree map leaves them."""
    if isinstance(tree, dict):
        return {str(k): to_host(tree[k]) for k in sorted(tree, key=str)}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


# -- files -------------------------------------------------------------------


def _read(path: str) -> tuple[dict, dict]:
    """(state tree, manifest) of a checkpoint file; the manifest comes from
    the sidecar for a file that embeds none."""
    with open(path, "rb") as f:
        state, manifest = _split_raw(msgpack_restore(f.read()))
    if not manifest and os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            manifest = json.load(f)
    return state, manifest


def read_manifest(path: str) -> dict:
    """The manifest of a checkpoint file."""
    return _read(path)[1]


def save_checkpoint(directory: str, state: dict, step: int, metric: float | None = None) -> str:
    """Write ``state`` (a tree as ``to_host`` leaves it) atomically to
    ``<dir>/ckpt_latest.msgpack``, and to ``ckpt_best.msgpack`` too when
    ``metric`` is lower than the stored best's."""
    os.makedirs(directory, exist_ok=True)
    manifest = {"step": step, "metric": metric}
    blob = msgpack_serialize({"meta": manifest, "state": to_host(state)})

    def write(name: str):
        tmp = os.path.join(directory, f".tmp_{name}")
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, os.path.join(directory, name))
        mtmp = os.path.join(directory, f".tmp_{name}.json")
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
        os.replace(mtmp, os.path.join(directory, f"{name}.json"))

    write("ckpt_latest.msgpack")
    if metric is not None:
        best = os.path.join(directory, "ckpt_best.msgpack")
        best_metric = read_manifest(best).get("metric") if os.path.exists(best) else None
        if best_metric is None or metric < best_metric:
            write("ckpt_best.msgpack")
    return os.path.join(directory, "ckpt_latest.msgpack")


def restore_checkpoint(directory: str, best: bool = False) -> tuple[dict, dict]:
    """(state tree of numpy arrays, manifest) of a run dir's latest or best
    checkpoint."""
    return _read(os.path.join(directory, "ckpt_best.msgpack" if best else "ckpt_latest.msgpack"))


class AsyncCheckpointer:
    """Checkpoint writes on a background thread.

    The copy to the host happens on the caller's thread (the next step updates
    the tensors in place); encoding and file I/O run on one worker, so the
    train loop does not wait on the disk.  ``wait()`` drains pending writes
    and raises the first error a write met."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self._thread: threading.Thread | None = None
        self._err: BaseException | None = None

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            directory, host_state, step, metric = item
            try:
                save_checkpoint(directory, host_state, step=step, metric=metric)
            except BaseException as e:  # reported by wait()
                self._err = self._err or e

    def save(self, directory: str, state: dict, step: int, metric: float | None = None):
        host_state = to_host(state)
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        self._q.put((directory, host_state, step, metric))

    def wait(self):
        if self._thread is not None:
            self._q.put(None)
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("a checkpoint write failed") from err


def restore_subtree(directory: str, target: dict, keys: list[str]) -> dict:
    """``target`` (a parameter tree of numpy arrays) with its ``keys``
    subtrees overwritten from the ``params`` of a run dir's best checkpoint: the partial restore that puts a pretrained front into a
    fine-tuning run.  A subtree whose keys or shapes differ from the target's
    raises."""
    tree, _ = restore_checkpoint(directory, best=True)
    src = tree.get("params", tree)
    out = dict(target)
    for k in keys:
        if k not in src:
            raise KeyError(f"checkpoint at {directory} has no subtree {k!r}")
        _check_like(target[k], src[k], k)
        out[k] = src[k]
    return out


def _check_like(want, got, path: str) -> None:
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"subtree {path}: keys {sorted(got) if isinstance(got, dict) else got!r}"
                             f" != {sorted(want)}")
        for k in want:
            _check_like(want[k], got[k], f"{path}/{k}")
    elif np.shape(got) != np.shape(want):
        raise ValueError(f"subtree {path}: shape {np.shape(got)} != {np.shape(want)}")
