"""Analytic operation and byte counts, and the card's peaks.

Each family's count of a whole pass is ``forward_flops`` in
``reference/<family>.py``, built from the pieces here.  Counted are the
multiply-adds of the products and convolutions (two operations each);
elementwise work (norms, activations, the softmax) is left out, so a share
of a peak is a lower bound of the work done.  Every count is
computed from a configuration's widths and the shapes served, never from the
program's own counters.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: TF32 on the tensor cores, float32 off
# them, HBM3 bandwidth.  3xTF32 (float32-accurate) runs three TF32 products.
PEAK_TF32 = 495e12
PEAK_FP32_ACCURATE_TC = PEAK_TF32 / 3.0
PEAK_FP32_SIMT = 67e12
PEAK_HBM = 3.35e12
MFU_PEAK = PEAK_TF32  # the highest rate at which the card multiplies float32 operands


def stft_frames(t: int, win: int, hop: int) -> int:
    return 0 if t < win else 1 + (t - win) // hop


def framed_matmul_cost(b: int, t: int, win: int, hop: int, k: int) -> tuple[float, float]:
    """(operations, bytes) of B1 on x ``[b, t]`` and a basis ``[win, k]``:
    ``2·b·nf·win·k``, each input byte read once and each output byte written
    once (float32)."""
    nf = stft_frames(t, win, hop)
    return 2.0 * b * nf * win * k, 4.0 * (b * t + win * k + b * nf * k)


def decode_ola_cost(b: int, nf: int, k: int, win: int, length: int) -> tuple[float, float]:
    """(operations, bytes) of B2 on codes ``[b, nf, k]`` and a basis ``[k,
    win]`` into ``[b, length]``: ``2·b·nf·k·win``."""
    return 2.0 * b * nf * k * win, 4.0 * (b * nf * k + k * win + b * length)


def roofline_seconds(ops: float, nbytes: float, peak_ops: float = PEAK_FP32_ACCURATE_TC) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / peak_ops, nbytes / PEAK_HBM)


def lstm_flops(frames: int, n_in: int, hidden: int) -> float:
    """One direction of one LSTM layer: 4 gates x 2 x (in + hidden) x hidden
    per frame."""
    return 4.0 * 2.0 * (n_in + hidden) * hidden * frames


def kmeans_flops(n: int, e: int, k: int, iters: int) -> float:
    """Weighted k-means with farthest-point seeding over n points of width
    e: the seeding's squared norms and its k - 1 rounds of distances to the
    chosen centroids, then per Lloyd iteration the distances (2·n·e·k) and
    the weighted sums (2·n·k·e), and the final assignment."""
    seeding = 2.0 * n * e + sum(2.0 * n * e * j for j in range(1, k))
    return seeding + iters * 4.0 * n * e * k + 2.0 * n * e * k


def forward_flops(cfg: dict, t: int) -> float:
    """The operations of one mixture of ``t`` samples through the
    configuration's model: ``forward_flops`` of ``reference/<family>.py``."""
    from bm.core import family

    return family(cfg).forward_flops(cfg, t)
