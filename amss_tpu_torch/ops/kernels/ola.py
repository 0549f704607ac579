"""B2: fused synthesis product + overlap-add (``amss_tpu/ops/pallas/ola.py``).

``decode_ola(codes, basis, hop, length)`` computes
``overlap_add(codes @ basis, hop, length)`` through the operator
``amss::decode_ola`` (``torch.library``).  A CUDA tensor goes to the
hand-written kernel in ``csrc/decode_ola.cu``, which sums each output
hop-chunk's overlapping frames on the tensor cores in 3xTF32 (FP32 accuracy),
with no atomics and no frame tensor; a CPU tensor goes to the plain version
``decode_ola_ref``; anything else raises.  ``decode_ola.launches`` counts the
kernel's launches, those of ``framed_matmul``'s backward and of exported
programs included.

It is differentiable as the JAX package's ``custom_vjp`` is: the adjoint of
product + overlap-add is framing + product, so ``dcodes`` is B1
(``framed_matmul``) on the output gradient, first padded or cut back to the
full overlap-add length, and ``dbasis`` is one plain product of the codes with
its frames.  The backward calls the public wrappers, so the tensor's device
picks the kernel or the plain version there too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from amss_tpu_torch.ops.framing import frame_signal, overlap_add
from amss_tpu_torch.ops.kernels.build import c_ints, check_device, check_launch, load_library
from amss_tpu_torch.ops.kernels.framed_matmul import framed_matmul, profitable


def decode_ola_ref(
    codes: torch.Tensor, basis: torch.Tensor, hop: int, length: int | None = None
) -> torch.Tensor:
    """Plain version: one matrix product, then overlap-add."""
    return overlap_add(codes @ basis, hop, length=length)


def _check(codes: torch.Tensor, basis: torch.Tensor, hop: int) -> None:
    if codes.dim() != 3 or basis.dim() != 2 or codes.shape[-1] != basis.shape[0]:
        raise ValueError(f"decode_ola takes codes [B, NF, K] and basis [K, win], got "
                         f"{tuple(codes.shape)} and {tuple(basis.shape)}")
    win = basis.shape[1]
    if win % hop != 0 or hop % 8 != 0:
        raise ValueError(f"decode_ola needs win%hop==0 and hop%8==0, got {win}/{hop}")
    if codes.dtype != torch.float32 or basis.dtype != torch.float32:
        raise TypeError(f"decode_ola takes float32, got {codes.dtype} and {basis.dtype}")
    if codes.device != basis.device:
        raise ValueError(f"codes on {codes.device} but basis on {basis.device}")
    if codes.shape[1] <= 0:
        raise ValueError("decode_ola needs at least one frame")
    check_device(codes.device, "decode_ola")


def _launch(codes: torch.Tensor, basis: torch.Tensor, hop: int, length: int) -> torch.Tensor:
    codes = codes.contiguous()
    basis = basis.contiguous()
    b, nf, k = codes.shape
    win = basis.shape[1]
    sizes = c_ints(b, nf, k, win, hop, length)
    out = torch.empty((b, length), dtype=torch.float32, device=codes.device)
    lib = load_library()
    with torch.cuda.device(codes.device):
        err = lib.amss_decode_ola(
            codes.data_ptr(), basis.data_ptr(), out.data_ptr(), *sizes,
            torch.cuda.current_stream(codes.device).cuda_stream,
        )
    check_launch(lib, "decode_ola", err)
    decode_ola.launches += 1
    return out


# The kernel as the operator ``amss::decode_ola``, as ``amss::framed_matmul``
# is: the CPU runs the plain version, CUDA the kernel (counted in
# ``launches``), and the fake implementation gives the output's shape.
@torch.library.custom_op("amss::decode_ola", mutates_args=(), device_types="cpu")
def decode_ola_op(codes: torch.Tensor, basis: torch.Tensor, hop: int,
                  length: int) -> torch.Tensor:
    return decode_ola_ref(codes, basis, hop, length)


decode_ola_op.register_kernel("cuda")(_launch)


@decode_ola_op.register_fake
def _(codes, basis, hop, length):
    return codes.new_empty((codes.shape[0], length))


def _setup(ctx, inputs, output):
    codes, basis, hop, _ = inputs
    ctx.hop = hop
    ctx.force = not profitable(basis.shape[1], hop)  # as framed_matmul's
    ctx.save_for_backward(codes, basis)


def _backward(ctx, g):
    """B2's adjoint: ``dcodes`` through B1, ``dbasis = codesᵀ·frames(g)``."""
    codes, basis = ctx.saved_tensors
    win = basis.shape[1]
    t_full = (codes.shape[1] - 1) * ctx.hop + win
    # undo the trim or zero-pad, so g covers the whole overlap-add extent
    g = F.pad(g, (0, t_full - g.shape[-1])) if g.shape[-1] < t_full else g[:, :t_full]
    dcodes = dbasis = None
    if ctx.needs_input_grad[0]:
        dcodes = framed_matmul(g, basis.T, ctx.hop, force=ctx.force)
    if ctx.needs_input_grad[1]:
        dbasis = torch.einsum("bnk,bnw->kw", codes, frame_signal(g, win, ctx.hop))
    return dcodes, dbasis, None, None


decode_ola_op.register_autograd(_backward, setup_context=_setup)


@register_flop_formula(torch.ops.amss.decode_ola)
def _flops(codes_shape, basis_shape, *args, out_shape=None, **kwargs) -> int:
    b, nf, k = codes_shape
    return 2 * b * nf * k * basis_shape[1]


def decode_ola(
    codes: torch.Tensor,
    basis: torch.Tensor,
    hop: int,
    length: int | None = None,
    force: bool = False,
) -> torch.Tensor:
    """``overlap_add(codes @ basis, hop)`` -> ``[B, length]``, frames never in
    device memory, differentiable in both inputs.  ``length`` (default
    ``(NF-1)*hop + win``) trims or zero-pads.  Shapes the gate closes
    (``framed_matmul.profitable`` false) take the plain version unless
    ``force`` is set; a forced call's backward is forced too."""
    if not force and not profitable(basis.shape[1], hop):
        return decode_ola_ref(codes, basis, hop, length)
    _check(codes, basis, hop)
    if length is None:
        length = (codes.shape[1] - 1) * hop + basis.shape[1]
    return decode_ola_op(codes, basis, hop, length)


decode_ola.launches = 0


def overlap_add_via_kernel(
    frames: torch.Tensor, hop: int, length: int | None = None
) -> torch.Tensor:
    """Overlap-add alone through ``decode_ola`` with an identity basis."""
    win = frames.shape[-1]
    eye = torch.eye(win, dtype=torch.float32, device=frames.device)
    return decode_ola(frames, eye, hop, length=length)
