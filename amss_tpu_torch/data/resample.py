"""Windowed-sinc polyphase sample-rate conversion on the host
(``amss_tpu/data/resample.py``), a copy that gives the same samples bit for
bit: ingest resamples a WAV tree to the store's rate, and STOI resamples to
10 kHz.

A Kaiser-windowed sinc low-pass evaluated polyphase-style: each output sample
gathers only the taps that land on real input samples, so the zero-stuffed
upsampled signal is never built (O(n_out · taps/phase) work, in blocks).
"""

from __future__ import annotations

import math

import numpy as np


def design_kaiser_sinc(half: int, cutoff: float, beta: float = 8.6) -> np.ndarray:
    """Low-pass FIR: 2*half+1 taps, cutoff in cycles/sample of the target
    grid (0.5 = Nyquist), Kaiser window (beta 8.6 ~ 90 dB stopband)."""
    n = np.arange(-half, half + 1)
    return (2.0 * cutoff * np.sinc(2.0 * cutoff * n) * np.kaiser(2 * half + 1, beta)).astype(
        np.float64
    )


def resample_sinc(
    x: np.ndarray,
    sr_in: int,
    sr_out: int,
    half_factor: int = 10,
    beta: float = 8.6,
    block: int = 1 << 16,
) -> np.ndarray:
    """Resample 1-D ``x`` from sr_in to sr_out.  Output length
    ceil(len(x) * up / down); output sample m sits at input time m*down/up."""
    if sr_in == sr_out:
        return np.asarray(x, np.float32)
    g = math.gcd(int(sr_in), int(sr_out))
    up, down = sr_out // g, sr_in // g
    x = np.asarray(x, np.float64)

    # Anti-alias/anti-image filter on the virtual up-rate grid (sr_in * up):
    # cutoff at the tighter of the two Nyquists; gain `up` compensates the
    # zero-stuffing energy loss.
    half = half_factor * max(up, down)
    h = up * design_kaiser_sinc(half, 0.5 / max(up, down), beta)

    n_in = len(x)
    n_out = int(math.ceil(n_in * up / down))
    taps = 2 * half // up + 2  # inputs under the kernel per output sample
    out = np.empty(n_out, np.float64)

    for m0 in range(0, n_out, block):
        m = np.arange(m0, min(m0 + block, n_out))
        t = m * down  # position on the up-rate grid
        j0 = np.ceil((t - half) / up).astype(np.int64)  # first contributing input
        j = j0[:, None] + np.arange(taps)[None, :]  # [M, taps] input indices
        k = t[:, None] - j * up + half  # tap index into h
        tap_ok = (k >= 0) & (k <= 2 * half)
        in_ok = (j >= 0) & (j < n_in)
        w = np.where(tap_ok, h[np.clip(k, 0, 2 * half)], 0.0)
        xs = np.where(in_ok, x[np.clip(j, 0, n_in - 1)], 0.0)
        out[m] = np.sum(w * xs, axis=1)
    return out.astype(np.float32)
