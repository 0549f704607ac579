"""B1: fused framing + basis product (``amss_tpu/ops/pallas/framed_matmul.py``).

``framed_matmul(x, basis, hop)`` computes ``frames(x, win, hop) @ basis``
through the operator ``amss::framed_matmul`` (``torch.library``, so an
exported program keeps it as one node).  A CUDA tensor goes to the
hand-written kernel in ``csrc/framed_matmul.cu``, which runs the product on
the tensor cores in 3xTF32 (FP32 accuracy) and feeds ``mma.sync`` from the
staged signal span, so no frame tensor exists; a CPU tensor goes to the plain
version ``framed_matmul_ref``; anything else raises.
``framed_matmul.launches`` counts the kernel's launches, those of
``decode_ola``'s backward and of exported programs included.

It is differentiable as the JAX package's ``custom_vjp`` is: the adjoint of
framing + product is product + overlap-add, so ``dx`` is B2 (``decode_ola``)
on the output gradient and ``dbasis`` is one plain product of the frames with
it.  The backward calls the public wrappers, so the tensor's device picks the
kernel or the plain version there too.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from amss_tpu_torch.ops.framing import frame_signal, num_frames
from amss_tpu_torch.ops.kernels.build import c_ints, check_device, check_launch, load_library
from amss_tpu_torch.ops.stft import dft_matrices, hann_window


def framed_matmul_ref(x: torch.Tensor, basis: torch.Tensor, hop: int) -> torch.Tensor:
    """Plain version: ``unfold`` into frames, then one matrix product."""
    return frame_signal(x, basis.shape[0], hop) @ basis


def profitable(win: int, hop: int) -> bool:
    """The shape gate of the adjoint pair: True where B1 and B2 both beat
    their plain versions on the H100, so both wrappers (and each one's
    backward) launch their kernels; elsewhere both take the plain products.

    Measured by ``chip_smoke.py`` (phases 2, 6 and 10) on an H100 80GB HBM3 at
    700 W: at 256/64 (c1's STFT, c2's front) both kernels win.  At 16/8
    (c6_flagship) and 32/16 (c6_3spk and the c6 recipe) B1 wins (0.0344-0.0346
    ms against 0.0390-0.0391, and 0.0234-0.0237 against 0.0332-0.0340), but
    B2 loses 2.3-2.8x (0.2268-0.2287 ms against 0.0820-0.0830, and
    0.1708-0.1728 against 0.0751-0.0759): its tile is 64 samples of the hop
    wide, so at hop 8 or 16 it does 8x or 4x the tensor-core work the output
    needs (ROADMAP B.f).  So the pair stays closed there.  Shapes not
    measured keep the JAX package's rule (``pallas_profitable``), which every
    measured point agrees with."""
    return win // hop >= 4 and hop >= 64


def _check(x: torch.Tensor, basis: torch.Tensor, hop: int) -> None:
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
    check_device(x.device, "framed_matmul")


def _launch(x: torch.Tensor, basis: torch.Tensor, hop: int) -> torch.Tensor:
    x = x.contiguous()
    basis = basis.contiguous()
    b, t = x.shape
    win, k = basis.shape
    nf = num_frames(t, win, hop)
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


# The kernel as the operator ``amss::framed_matmul``, so that ``torch.export``
# keeps it as one node of a program and a loaded program launches it: the CPU
# runs the plain version, CUDA the kernel (counted in ``launches``, from
# eager calls and exported programs alike), and the fake implementation gives
# the output's shape without touching a device.
@torch.library.custom_op("amss::framed_matmul", mutates_args=(), device_types="cpu")
def framed_matmul_op(x: torch.Tensor, basis: torch.Tensor, hop: int) -> torch.Tensor:
    return framed_matmul_ref(x, basis, hop)


framed_matmul_op.register_kernel("cuda")(_launch)


@framed_matmul_op.register_fake
def _(x, basis, hop):
    return x.new_empty((x.shape[0], num_frames(x.shape[-1], basis.shape[0], hop), basis.shape[1]))


def _setup(ctx, inputs, output):
    x, basis, hop = inputs
    ctx.hop = hop
    # the op is reached where the gate is open or the call was forced; the
    # backward is forced exactly where the gate is closed
    ctx.force = not profitable(basis.shape[0], hop)
    ctx.save_for_backward(x, basis)


def _backward(ctx, g):
    """B1's adjoint: ``dx`` through B2, ``dbasis = frames(x)ᵀ·g``."""
    from amss_tpu_torch.ops.kernels.ola import decode_ola

    x, basis = ctx.saved_tensors
    dx = dbasis = None
    if ctx.needs_input_grad[0]:
        dx = decode_ola(g, basis.T, ctx.hop, length=x.shape[-1], force=ctx.force)
    if ctx.needs_input_grad[1]:
        frames = frame_signal(x, basis.shape[0], ctx.hop)
        dbasis = torch.einsum("bnw,bnk->wk", frames, g)
    return dx, dbasis, None


framed_matmul_op.register_autograd(_backward, setup_context=_setup)


@register_flop_formula(torch.ops.amss.framed_matmul)
def _flops(x_shape, basis_shape, hop, *args, out_shape=None, **kwargs) -> int:
    b, nf, k = out_shape
    return 2 * b * nf * basis_shape[0] * k


def framed_matmul(
    x: torch.Tensor, basis: torch.Tensor, hop: int, force: bool = False
) -> torch.Tensor:
    """``frames(x, win, hop) @ basis`` -> ``[B, NF, K]``, differentiable in
    both inputs.

    x ``[B, T]`` and basis ``[win, K]``, float32, on one device.  Shapes the
    gate closes (``profitable`` false) take the plain version unless ``force``
    is set; a forced call's backward is forced too.

    The backward's ``dx`` on CUDA is B2, which fills few of the card's SMs at
    small batches: at the c1 training shape ``[8, 16384]`` it is slower than
    the plain version's autograd (ROADMAP B.e).  c1 training never reaches it:
    its basis and waveforms need no gradient."""
    if not force and not profitable(basis.shape[0], hop):
        return framed_matmul_ref(x, basis, hop)
    _check(x, basis, hop)
    return framed_matmul_op(x, basis, hop)


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
