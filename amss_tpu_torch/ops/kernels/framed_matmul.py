"""B1: fused framing + basis product (``amss_tpu/ops/pallas/framed_matmul.py``).

``framed_matmul(x, basis, hop)`` computes ``frames(x, win, hop) @ basis``.  A
CUDA tensor goes to the hand-written kernel in ``csrc/framed_matmul.cu``,
which runs the product on the tensor cores in 3xTF32 (FP32 accuracy) and
feeds ``mma.sync`` from the staged signal span, so no frame tensor exists; a
CPU tensor goes to the plain version ``framed_matmul_ref``; anything else
raises.  ``framed_matmul.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from amss_tpu_torch.ops.framing import frame_signal, num_frames
from amss_tpu_torch.ops.kernels.build import c_ints, check_launch, load_library
from amss_tpu_torch.ops.stft import dft_matrices, hann_window


def framed_matmul_ref(x: torch.Tensor, basis: torch.Tensor, hop: int) -> torch.Tensor:
    """Plain version: ``unfold`` into frames, then one matrix product."""
    return frame_signal(x, basis.shape[0], hop) @ basis


def profitable(win: int, hop: int) -> bool:
    """The JAX package's shape gate (``pallas_profitable``): the fused kernel
    serves STFT-like shapes; short filters take framing + matmul."""
    return win // hop >= 4 and hop >= 64


def _check(x: torch.Tensor, basis: torch.Tensor, hop: int) -> int:
    win = basis.shape[0]
    if win % hop != 0 or hop % 8 != 0:
        raise ValueError(f"framed_matmul needs win%hop==0 and hop%8==0, got {win}/{hop}")
    if x.dim() != 2 or basis.dim() != 2:
        raise ValueError(f"framed_matmul takes x [B, T] and basis [win, K], got "
                         f"{tuple(x.shape)} and {tuple(basis.shape)}")
    if x.dtype != torch.float32 or basis.dtype != torch.float32:
        raise TypeError(f"framed_matmul takes float32, got {x.dtype} and {basis.dtype}")
    if x.device != basis.device:
        raise ValueError(f"x on {x.device} but basis on {basis.device}")
    nf = num_frames(x.shape[-1], win, hop)
    if nf <= 0:
        raise ValueError(f"signal length {x.shape[-1]} shorter than window {win}")
    return nf


def _launch(x: torch.Tensor, basis: torch.Tensor, hop: int, nf: int) -> torch.Tensor:
    if not torch.cuda.is_available():
        raise RuntimeError("framed_matmul got a CUDA tensor but CUDA is not available")
    x = x.contiguous()
    basis = basis.contiguous()
    b, t = x.shape
    win, k = basis.shape
    sizes = c_ints(b, t, win, hop, k, nf)
    out = torch.empty((b, nf, k), dtype=torch.float32, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.amss_framed_matmul(
            x.data_ptr(), basis.data_ptr(), out.data_ptr(), *sizes,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    check_launch(lib, "framed_matmul", err)
    framed_matmul.launches += 1
    return out


def framed_matmul(
    x: torch.Tensor, basis: torch.Tensor, hop: int, force: bool = False
) -> torch.Tensor:
    """``frames(x, win, hop) @ basis`` -> ``[B, NF, K]``.

    x ``[B, T]`` and basis ``[win, K]``, float32, on one device.  Shapes the
    JAX package sends to XLA (``profitable`` false) take the plain version
    unless ``force`` is set."""
    if not force and not profitable(basis.shape[0], hop):
        return framed_matmul_ref(x, basis, hop)
    nf = _check(x, basis, hop)
    if x.device.type == "cpu":
        return framed_matmul_ref(x, basis, hop)
    if x.device.type == "cuda":
        return _launch(x, basis, hop, nf)
    raise ValueError(f"framed_matmul runs on cpu or cuda tensors, got {x.device}")


framed_matmul.launches = 0


@functools.lru_cache(maxsize=None)
def stft_basis(win: int) -> np.ndarray:
    """Hann-windowed real-DFT analysis basis ``[win, 2F]`` = window·[C | S]."""
    c, s = dft_matrices(win)
    return hann_window(win)[:, None] * np.concatenate([c, s], axis=1)


def stft_ri(x: torch.Tensor, win: int, hop: int) -> tuple[torch.Tensor, torch.Tensor]:
    """STFT (re, im) through one ``framed_matmul`` over the folded basis."""
    f = win // 2 + 1
    out = framed_matmul(x, torch.as_tensor(stft_basis(win), device=x.device), hop)
    return out[..., :f], out[..., f:]
