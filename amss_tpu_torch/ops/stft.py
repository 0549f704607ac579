"""STFT / iSTFT as matrix products (``amss_tpu/ops/stft.py``).

The conventions are the JAX package's: a periodic Hann window, no centre
padding, the imaginary part carrying the rfft sign (-sin), hermitian weights
folded into the inverse basis, and a COLA normaliser clamped relative to its
peak.  These are the plain versions; the main path runs the same bases through
the kernels in ``ops/kernels``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from amss_tpu_torch.ops.framing import frame_signal, overlap_add


def hann_window(win: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window."""
    n = np.arange(win)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win)).astype(dtype)


@functools.lru_cache(maxsize=None)
def dft_matrices(win: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT basis (C, S), each [win, F] with F = win//2 + 1; S = -sin."""
    f = win // 2 + 1
    n = np.arange(win)[:, None]
    k = np.arange(f)[None, :]
    ang = 2.0 * np.pi * n * k / win
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def idft_matrices(win: int) -> tuple[np.ndarray, np.ndarray]:
    """Inverse real-DFT basis (Ci, Si), each [F, win], hermitian weights in."""
    f = win // 2 + 1
    n = np.arange(win)[None, :]
    k = np.arange(f)[:, None]
    ang = 2.0 * np.pi * n * k / win
    w = np.full((f, 1), 2.0)
    w[0] = 1.0
    if win % 2 == 0:
        w[-1] = 1.0
    ci = (w * np.cos(ang) / win).astype(np.float32)
    si = (-w * np.sin(ang) / win).astype(np.float32)
    return ci, si


def cola_norm(window: torch.Tensor, nf: int, hop: int, length: int | None) -> torch.Tensor:
    """Overlap-added squared window, clamped at 1e-2 of its peak.

    Near the utterance edges the raw normaliser tends to zero, and a masked
    (inconsistent) spectrum divided by it would blow up there."""
    wsq = (window * window).expand(nf, -1)
    norm = overlap_add(wsq, hop, length=length)
    return torch.maximum(norm, 1e-2 * norm.max())


def stft_ri(x: torch.Tensor, win: int, hop: int) -> tuple[torch.Tensor, torch.Tensor]:
    """STFT of ``x[..., T]`` -> (re, im), each ``[..., num_frames, F]``."""
    window = hann_window(win)
    c, s = dft_matrices(win)
    wc = torch.as_tensor(window[:, None] * c, device=x.device)
    ws = torch.as_tensor(window[:, None] * s, device=x.device)
    frames = frame_signal(x, win, hop)
    return frames @ wc, frames @ ws


def istft_ri(
    re: torch.Tensor, im: torch.Tensor, win: int, hop: int, length: int | None = None
) -> torch.Tensor:
    """Inverse STFT from (re, im) ``[..., num_frames, F]`` -> ``[..., T]``."""
    window = torch.as_tensor(hann_window(win), device=re.device)
    ci, si = idft_matrices(win)
    frames = re @ torch.as_tensor(ci, device=re.device) + im @ torch.as_tensor(
        si, device=re.device
    )
    out = overlap_add(frames * window, hop, length=length)
    return out / cola_norm(window, re.shape[-2], hop, length)
