"""Plain signal processing for the references: framing, overlap-add, the
windowed DFT bases, and products in float32 or rounded to TF32.

Nothing here imports the port or JAX.  Conventions (stated by the
configurations): a periodic Hann window, no centre padding, frames of
``1 + (T - win) // hop``, the imaginary part carrying -sin, hermitian weights
folded into the inverse basis, and the STFT's overlap-added squared window
clamped at 1e-2 of its peak.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32, the tensor cores' 10-bit mantissa:
    round to nearest, ties to even, on the bit pattern."""
    i = x.detach().contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    """``a @ b`` with both operands rounded to TF32, and the backward's two
    products rounded the same way, as TF32 tensor cores run all three."""

    @staticmethod
    def forward(ctx, a, b):
        ar, br = tf32(a), tf32(b)
        ctx.save_for_backward(ar, br)
        return ar @ br

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        gr = tf32(g)
        return gr @ br.transpose(-1, -2), ar.transpose(-1, -2) @ gr


class Products:
    """The references' products: float32 (``control`` False), or with each
    operand rounded to TF32 and the sums in float32, as the card's TF32
    tensor cores compute them (the control)."""

    def __init__(self, control: bool = False):
        self.control = control

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.control:
            return _Tf32Matmul.apply(a, b)
        return a @ b

    def linear(self, x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
        """``x @ wᵀ + bias`` for an ``nn.Linear``-layout weight ``[out, in]``."""
        y = self(x, w.t())
        return y if bias is None else y + bias


def frames(x: torch.Tensor, win: int, hop: int) -> torch.Tensor:
    """``x[..., T]`` -> ``[..., 1 + (T - win) // hop, win]``."""
    return x.unfold(-1, win, hop)


def overlap_add(fr: torch.Tensor, hop: int, length: int) -> torch.Tensor:
    """``[..., nf, win]`` summed at ``hop`` -> ``[..., length]`` (trimmed or
    zero-padded), by ``F.fold``."""
    *lead, nf, win = fr.shape
    total = (nf - 1) * hop + win
    cols = fr.reshape(-1, nf, win).transpose(1, 2)  # [N, win, nf]
    out = F.fold(cols, output_size=(1, total), kernel_size=(1, win), stride=(1, hop))
    out = out.reshape(*lead, total)
    return out[..., :length] if length <= total else F.pad(out, (0, length - total))


def hann(win: int, device, dtype=torch.float64) -> torch.Tensor:
    n = torch.arange(win, device=device, dtype=dtype)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / win)


def dft_bases(win: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(analysis ``[win, 2F]`` = window·[cos | -sin], synthesis ``[2F, win]``
    = [Ci; Si]·window with the hermitian weights), float32, built in float64."""
    f = win // 2 + 1
    n = torch.arange(win, device=device, dtype=torch.float64)
    k = torch.arange(f, device=device, dtype=torch.float64)
    ang = 2.0 * math.pi * n[:, None] * k[None, :] / win  # [win, F]
    w = hann(win, device)
    analysis = w[:, None] * torch.cat([torch.cos(ang), -torch.sin(ang)], dim=1)
    herm = torch.full((f,), 2.0, device=device, dtype=torch.float64)
    herm[0] = 1.0
    if win % 2 == 0:
        herm[-1] = 1.0
    ci = herm[:, None] * torch.cos(ang.t()) / win
    si = -herm[:, None] * torch.sin(ang.t()) / win
    synthesis = torch.cat([ci, si], dim=0) * w[None, :]
    return analysis.float(), synthesis.float()


def cola(win: int, hop: int, nf: int, length: int, device) -> torch.Tensor:
    """The overlap-added squared window of ``nf`` frames, clamped at 1e-2 of
    its peak, float32 ``[length]``."""
    w = hann(win, device, torch.float32)
    norm = overlap_add((w * w).expand(nf, win), hop, length)
    return torch.maximum(norm, 1e-2 * norm.max())
