"""The native batch fill (``amss_tpu/data/native.py``): gather and gain-scale
B·S chunks out of the speakers' shards in C++ (``csrc/amss_data.cc``), bound
with ``ctypes``.

The library is built with ``g++`` at first use
(``ops/kernels/build.py::build_native``).  Unlike the JAX package's binding,
a failed build or load raises, naming the compiler's message: there is no
silent fallback to the numpy loop.  ``batch_fill_ref`` is that loop, the
plain version the fill is held to bit for bit.  The library call releases the
GIL, so the trainer's prefetch thread fills while the main thread steps.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

_F = ctypes.POINTER(ctypes.c_float)


def _chunk_wrap(wave: np.ndarray, start: int, t: int) -> np.ndarray:
    """Chunk of length t from ``wave`` starting at ``start``, wrapping to the
    shard head if short."""
    if start + t <= len(wave):
        return np.asarray(wave[start : start + t], np.float32)
    out = np.empty(t, np.float32)
    pos, filled = start, 0
    while filled < t:
        take = min(len(wave) - pos, t - filled)
        out[filled : filled + take] = wave[pos : pos + take]
        filled += take
        pos = 0
    return out


@functools.lru_cache(maxsize=None)
def load_native() -> ctypes.CDLL:
    """The fill's shared library, built if needed, with its signature set."""
    from amss_tpu_torch.ops.kernels.build import build_native

    lib = ctypes.CDLL(str(build_native()[0]))
    lib.amss_batch_fill.argtypes = [
        _F, ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(_F),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), _F,
    ]
    lib.amss_batch_fill.restype = None
    return lib


def _check(out: np.ndarray, shards, speaker_idx, starts, gains):
    if out.dtype != np.float32 or out.ndim != 2 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous [n, T] float32 array, got "
                         f"{out.dtype} {out.shape}")
    idx = np.ascontiguousarray(speaker_idx, np.int32).reshape(-1)
    st = np.ascontiguousarray(starts, np.int64).reshape(-1)
    g = np.ascontiguousarray(gains, np.float32).reshape(-1)
    if not idx.size == st.size == g.size == out.shape[0]:
        raise ValueError(f"{out.shape[0]} rows, {idx.size} speakers, {st.size} starts, "
                         f"{g.size} gains")
    if idx.size and not (0 <= idx.min() and idx.max() < len(shards)):
        raise ValueError(f"speaker index out of range for {len(shards)} shards")
    return idx, st, g


def batch_fill(out: np.ndarray, shards: list, speaker_idx, starts, gains) -> None:
    """``out[j] = gains[j] · shards[speaker_idx[j]][starts[j] : starts[j] + T]``,
    a short shard wrapping to its head, in the native library.

    out ``[n, T]`` float32 (C-contiguous); shards: 1-D float32 arrays
    (memory-mapped ones too); speaker_idx, starts, gains ``[n]``."""
    idx, st, g = _check(out, shards, speaker_idx, starts, gains)
    ptrs = (_F * max(len(shards), 1))()
    lens = np.empty(len(shards), np.int64)
    for i, s in enumerate(shards):
        if s.dtype != np.float32 or s.ndim != 1 or not s.flags.c_contiguous:
            raise ValueError(f"shard {i} must be a contiguous 1-D float32 array")
        ptrs[i] = s.ctypes.data_as(_F)
        lens[i] = len(s)
    load_native().amss_batch_fill(
        out.ctypes.data_as(_F), out.shape[0], out.shape[1], ptrs,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        st.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), g.ctypes.data_as(_F))


def batch_fill_ref(out: np.ndarray, shards: list, speaker_idx, starts, gains) -> None:
    """``batch_fill``'s plain version: the numpy loop, a chunk at a time."""
    idx, st, g = _check(out, shards, speaker_idx, starts, gains)
    for k in range(out.shape[0]):
        out[k] = g[k] * _chunk_wrap(shards[int(idx[k])], int(st[k]), out.shape[1])
