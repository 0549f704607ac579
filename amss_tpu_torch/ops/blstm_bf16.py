"""The BLSTM's bfloat16 recurrence (``amss_tpu/models/blstm.py::_bilstm_fused_scan``
with ``compute_dtype=bf16``), and the operator ``amss::blstm_bf16_layer``
that runs one layer of it in an exported program.

``bilstm_bf16`` runs both directions of one layer in one loop (direction a
leading batch axis): the input projection hoisted out of the loop, each step
one batched ``[2, B, H] x [2, H, 4H]`` product; x, h and the weights rounded
to bf16, the products summed in float32, the bias, gates, cell state c, h and
the mask's freeze in float32.  It takes any mask.  Training calls it with
``Bf16Bmm.apply``, whose backward rounds each operand's gradient to bf16 as
JAX's does.  ``torch.export`` keeps ``amss::blstm_bf16_layer`` as one node
(the loop would unroll over every frame of a bucket), and a loaded program
runs the same loop with the plain product on the CPU and on CUDA: the same
function as the live path, bit for bit.  This module imports no model
module, so the artifact loader can register the operator.
"""

from __future__ import annotations

from typing import Optional

import torch

# How the card multiplies two bf16 operands into a float32 result: cuBLAS's
# bf16 product with a float32 output where this torch has ``aten::mm.dtype``,
# else the float32 product of the bf16-rounded operands (TF32 off).  The CPU
# always takes the second: its products are exact in float32 either way.
BF16_PRODUCT = ("cublas_bf16_out_float32" if hasattr(torch.ops.aten.mm, "dtype")
                else "float32_of_bf16_operands")


def bf16_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two 2-D bf16 tensors, summed and returned in float32."""
    if a.device.type == "cuda" and BF16_PRODUCT == "cublas_bf16_out_float32":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def bf16_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two 3-D bf16 tensors, batch by batch, summed and returned
    in float32, as ``bf16_mm``."""
    if a.device.type == "cuda" and hasattr(torch.ops.aten.bmm, "dtype"):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


class Bf16Bmm(torch.autograd.Function):
    """``a @ b`` of two bf16 tensors ``[D, M, K] x [D, K, N]`` into float32.
    The backward is JAX's transpose of that product: each operand's gradient
    is the float32 product of the float32 cotangent with the other bf16
    operand, rounded to bf16 (the operand's own type), so that the gradients
    of one operand used at many steps add up in bf16."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return bf16_bmm(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.bmm(g, b.float().transpose(1, 2)).to(torch.bfloat16)
        if ctx.needs_input_grad[1]:
            db = torch.bmm(a.float().transpose(1, 2), g).to(torch.bfloat16)
        return da, db


def bilstm_bf16(x: torch.Tensor, mask: torch.Tensor | None, wx: torch.Tensor,
                wh: torch.Tensor, bias: torch.Tensor, bmm=bf16_bmm) -> torch.Tensor:
    """One bidirectional layer: x ``[B, T, In]`` (float32), mask ``[B, T]``
    (1 = valid) or None, the bf16 weights wx ``[2, In, 4H]`` and wh ``[2, H,
    4H]`` and the float32 bias ``[2, 1, 4H]`` of (forward, backward), gates
    (i, f, g, o) -> ``[B, T, 2H]`` float32.  ``bmm`` multiplies two bf16
    operands into float32."""
    b, t, _ = x.shape
    hd = wh.shape[1]
    xd = torch.stack([x, torch.flip(x, dims=(1,))]).to(torch.bfloat16)  # [2, B, T, In]
    xproj = (bmm(xd.reshape(2, b * t, -1), wx)
             + bias).reshape(2, b, t, 4 * hd)  # the input projection, hoisted
    valid = None
    if mask is not None:
        valid = torch.stack([mask, torch.flip(mask, dims=(1,))])[..., None] > 0  # [2, B, T, 1]
    h = x.new_zeros((2, b, hd), dtype=torch.float32)
    c = torch.zeros_like(h)
    outs = []
    for s in range(t):
        gates = xproj[:, :, s] + bmm(h.to(torch.bfloat16), wh)
        sig = torch.sigmoid(gates)  # i, f and o (the g quarter unused)
        g = torch.tanh(gates[..., 2 * hd : 3 * hd])
        c_new = sig[..., hd : 2 * hd] * c + sig[..., :hd] * g
        h_new = sig[..., 3 * hd :] * torch.tanh(c_new)
        if valid is None:
            h, c = h_new, c_new
            outs.append(h_new)
        else:
            m = valid[:, :, s]
            c = torch.where(m, c_new, c)
            h = torch.where(m, h_new, h)
            outs.append(torch.where(m, h_new, torch.zeros_like(h_new)))
    out = torch.stack(outs, dim=2)  # [2, B, T, H]
    return torch.cat([out[0], torch.flip(out[1], dims=(1,))], dim=-1)


# One layer as the operator ``amss::blstm_bf16_layer``: the CPU and CUDA run
# the loop above with the plain product, and the fake implementation gives
# the output's shape without touching a device.
@torch.library.custom_op("amss::blstm_bf16_layer", mutates_args=(),
                         device_types=("cpu", "cuda"))
def blstm_bf16_layer(x: torch.Tensor, mask: Optional[torch.Tensor], wx: torch.Tensor,
                     wh: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return bilstm_bf16(x, mask, wx, wh, bias)


@blstm_bf16_layer.register_fake
def _(x, mask, wx, wh, bias):
    return x.new_empty((x.shape[0], x.shape[1], 2 * wh.shape[1]), dtype=torch.float32)
