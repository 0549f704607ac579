"""Int8 weight compression for serving artifacts, post-training and
symmetric (``amss_tpu/infer/quantize.py``, in numpy).

    q  = round(w / scale)   in [-127, 127], int8
    w' = q * scale          (dequantized when the artifact is opened, float32)

* Only matrix-shaped weights are quantized (float32, ndim >= 2 and size >=
  ``min_size``): dense and conv kernels, the learned bases, centroid tables.
  Biases, norm gains, PReLU slopes and other small or 1-D leaves pass
  through.
* ``scale`` is per output channel, the trailing axis of every weight in the
  JAX layout (``[..., in, out]`` or ``[taps, channels]``), so one outlier
  column does not crush the resolution of the rest.
* Compute is untouched: the exported programs take float32 parameters, and
  the loader dequantizes once (``infer/export.py`` reads
  ``params_quantize`` from ``export_meta.json``).

A quantized leaf becomes a ``{"q8:data": int8[..., C], "q8:scale":
float32[C]}`` sub-dict, which the msgpack writer stores as it is; parameter
names are alphanumeric, so the marker keys cannot collide with a subtree.
The encoding is bit for bit the JAX package's.
"""

from __future__ import annotations

import numpy as np

_DATA = "q8:data"
_SCALE = "q8:scale"

#: quantize float32 leaves with at least this many elements (and ndim >= 2)
MIN_SIZE = 1024


def _is_q8(node) -> bool:
    return isinstance(node, dict) and set(node.keys()) == {_DATA, _SCALE}


def _eligible(a, min_size: int) -> bool:
    return (
        isinstance(a, np.ndarray)
        and a.dtype == np.float32
        and a.ndim >= 2
        and a.size >= min_size
    )


def quantize_leaf(a: np.ndarray) -> dict:
    """float32 [..., C] -> {"q8:data": int8 [..., C], "q8:scale": f32 [C]}."""
    amax = np.max(np.abs(a), axis=tuple(range(a.ndim - 1)))
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(a / scale), -127, 127).astype(np.int8)
    return {_DATA: q, _SCALE: scale}


def dequantize_leaf(node: dict) -> np.ndarray:
    return (node[_DATA].astype(np.float32) * node[_SCALE]).astype(np.float32)


def quantize_state_dict(sd, min_size: int = MIN_SIZE):
    """Replace every eligible weight of a state dict (nested plain dicts,
    ndarray leaves) with its int8 encoding; returns a new tree."""
    if isinstance(sd, dict):
        return {k: quantize_state_dict(v, min_size) for k, v in sd.items()}
    a = np.asarray(sd)
    return quantize_leaf(a) if _eligible(a, min_size) else sd


def dequantize_state_dict(sd):
    """Inverse of ``quantize_state_dict`` (up to the int8 rounding)."""
    if _is_q8(sd):
        return dequantize_leaf(sd)
    if isinstance(sd, dict):
        return {k: dequantize_state_dict(v) for k, v in sd.items()}
    return sd


def quantized_fraction(sd) -> float:
    """Fraction of parameter bytes the encoding eliminates, ``1 -
    encoded_bytes / float32_bytes`` (recorded in ``export_meta.json``)."""

    def walk(node):
        if _is_q8(node):
            n = node[_DATA].size
            return 4 * n, n + 4 * node[_SCALE].size
        if isinstance(node, dict):
            tot, enc = 0, 0
            for v in node.values():
                t, e = walk(v)
                tot, enc = tot + t, enc + e
            return tot, enc
        a = np.asarray(node)
        return a.nbytes, a.nbytes

    total_f32, encoded = walk(sd)
    return 0.0 if total_f32 == 0 else 1.0 - encoded / total_f32
