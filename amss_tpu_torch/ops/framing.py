"""Framing and overlap-add on tensors (``amss_tpu/ops/framing.py``).

No centre padding: ``num_frames = 1 + (T - win) // hop``.  Overlap-add
requires ``win % hop == 0`` and sums ``r = win // hop`` shifted hop-chunks, as
the JAX package does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def num_frames(t: int, win: int, hop: int) -> int:
    """Number of full frames covering a length-``t`` signal (no padding)."""
    if t < win:
        return 0
    return 1 + (t - win) // hop


def frame_signal(x: torch.Tensor, win: int, hop: int) -> torch.Tensor:
    """``x[..., T]`` -> overlapping frames ``[..., num_frames, win]`` (a view)."""
    if num_frames(x.shape[-1], win, hop) <= 0:
        raise ValueError(f"signal length {x.shape[-1]} shorter than window {win}")
    return x.unfold(-1, win, hop)


def overlap_add(frames: torch.Tensor, hop: int, length: int | None = None) -> torch.Tensor:
    """Overlap-add ``[..., num_frames, win]`` back to ``[..., T]``.

    T = (num_frames - 1) * hop + win unless ``length`` trims or zero-pads."""
    *lead, nf, win = frames.shape
    if win % hop != 0:
        raise ValueError(f"overlap_add requires win % hop == 0, got {win} % {hop}")
    r = win // hop
    t_full = (nf - 1) * hop + win
    nblocks = t_full // hop
    chunks = frames.reshape(*lead, nf, r, hop)
    out = frames.new_zeros((*lead, nblocks, hop))
    for i in range(r):
        out[..., i : i + nf, :] += chunks[..., :, i, :]
    out = out.reshape(*lead, t_full)
    if length is not None:
        out = out[..., :length] if length <= t_full else F.pad(out, (0, length - t_full))
    return out
