"""One float32 bidirectional LSTM layer on the card (``csrc/blstm.cu`` for
a few rows, ``csrc/blstm_rows.cu`` for many), and its plain version.

``bilstm_layer(x, mask, fwd, bwd)``: x ``[B, T, In]``, mask ``[B, T]`` (> 0
valid, any mask) or None, and each direction's ``(w_ih [4H, In], w_hh
[4H, H], bias [4H])`` as ``nn.LSTM`` stores them (gates i, f, g, o; the bias
is bias_ih + bias_hh) -> ``[B, T, 2H]``, the forward direction's h, then the
backward's.  On a masked step (h, c) freeze and the output is 0; the backward
direction runs from the last step to the first, so with a prefix mask each
row starts at its own last valid frame.

A CPU tensor goes to the plain version, ``bilstm_layer_ref``: the
step-by-step loop that ``models/blstm.py::BLSTM.loop`` runs.  A CUDA tensor
goes to one float32 GEMM for both directions' input projections
(``[B·T, In] x [In, 8H]`` plus the bias; TF32 off, as PyTorch's default
``torch.backends.cuda.matmul.allow_tf32`` has it for every float32 product
of the port, and as the trainer sets it) and then one launch of a
recurrence kernel over every step of both directions, which reads the mask
on the card; anything else raises.  Up to ``MAX_ROWS`` rows the launch is
``csrc/blstm.cu``'s, a chain of latency-bound steps whose clusters of 16
blocks spread W_hh over 16 SMs for at most 8 rows; past it,
``csrc/blstm_rows.cu``'s, which cuts the rows into tiles that fill the card
in one wave, each direction's W_hh held by a cluster of 2.  Both kernels'
arithmetic is float32 FFMA, summed in their own orders, with precise
``expf`` and ``tanhf``.

The wrapper takes float32 tensors, ``w_hh`` and the mask contiguous,
``1 <= B <= MAX_BATCH``, ``T >= 1`` and ``1 <= H <= MAX_HIDDEN`` (the
largest H whose W_hh slice fits the registers of a block of a cluster of 16)
up to ``MAX_ROWS`` rows, ``1 <= H <= ROWS_MAX_HIDDEN`` (the largest H whose
W_hh a cluster of 2 holds in shared memory beside the tile's h) past it, and
raises ``ValueError`` for anything else, on every device.  The kernels have
no backward: a CUDA call where autograd would record raises.
``bilstm_layer.launches`` counts ``csrc/blstm.cu``'s launches and
``bilstm_layer.rows_launches`` ``csrc/blstm_rows.cu``'s, one a layer.
"""

from __future__ import annotations

import torch

from amss_tpu_torch.ops.kernels.build import c_ints, check_device, check_launch, load_library

MAX_BATCH = 65535  # the grid's tiles of rows, a tile at least one row
MAX_HIDDEN = 304
# the rows past which the row-parallel kernel runs (the crossover with cuDNN's
# packed path at H = 300 that csrc/blstm.cu was measured against:
# models/blstm.py)
MAX_ROWS = 192
ROWS_MAX_HIDDEN = 128


def takes(rows: int, hidden: int) -> bool:
    """Whether one of the kernels takes ``rows`` rows of ``hidden`` cells:
    ``csrc/blstm.cu`` up to ``MAX_ROWS`` rows and ``MAX_HIDDEN`` cells,
    ``csrc/blstm_rows.cu`` past them, up to ``MAX_BATCH`` rows and
    ``ROWS_MAX_HIDDEN`` cells.  Past ``MAX_ROWS`` rows at more cells neither
    does, and the call runs cuDNN packed: TF-GridNet's H = 192 rows, 5992
    intra and 520 inter rows a call in its benchmark cell."""
    return 1 <= rows <= MAX_BATCH and 1 <= hidden <= (
        MAX_HIDDEN if rows <= MAX_ROWS else ROWS_MAX_HIDDEN)


def direction_ref(x: torch.Tensor, mask: torch.Tensor | None, w_ih: torch.Tensor,
                  w_hh: torch.Tensor, bias: torch.Tensor, reverse: bool) -> torch.Tensor:
    """One direction over every step of ``x`` ``[B, T, In]`` -> ``[B, T, H]``,
    the reverse one on the flipped input."""
    if reverse:
        x = torch.flip(x, dims=(1,))
        mask = None if mask is None else torch.flip(mask, dims=(1,))
    b, t, _ = x.shape
    hd = w_hh.shape[1]
    xproj = x @ w_ih.T + bias  # input projection hoisted out of the loop
    h = x.new_zeros((b, hd))
    c = x.new_zeros((b, hd))
    outs = []
    for s in range(t):
        gates = xproj[:, s] + h @ w_hh.T
        i = torch.sigmoid(gates[:, :hd])
        f = torch.sigmoid(gates[:, hd : 2 * hd])
        g = torch.tanh(gates[:, 2 * hd : 3 * hd])
        o = torch.sigmoid(gates[:, 3 * hd :])
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        if mask is None:
            h, c = h_new, c_new
            outs.append(h_new)
        else:
            m = mask[:, s, None] > 0
            c = torch.where(m, c_new, c)
            h = torch.where(m, h_new, h)
            outs.append(torch.where(m, h_new, torch.zeros_like(h_new)))
    out = torch.stack(outs, dim=1)
    return torch.flip(out, dims=(1,)) if reverse else out


def bilstm_layer_ref(x: torch.Tensor, mask: torch.Tensor | None, fwd, bwd) -> torch.Tensor:
    """The plain version: both directions' loops, concatenated."""
    return torch.cat([direction_ref(x, mask, *fwd, reverse=False),
                      direction_ref(x, mask, *bwd, reverse=True)], dim=-1)


def _check(x: torch.Tensor, mask: torch.Tensor | None, fwd, bwd) -> None:
    """Raise ``ValueError`` unless the kernel takes these tensors."""
    if x.dim() != 3:
        raise ValueError(f"bilstm_layer takes x [B, T, In], got {tuple(x.shape)}")
    b, t, n_in = x.shape
    if len(fwd) != 3 or len(bwd) != 3:
        raise ValueError("bilstm_layer takes (w_ih, w_hh, bias) for each direction")
    w_hh = fwd[1]
    hd = w_hh.shape[-1] if w_hh.dim() == 2 else 0
    if t < 1 or not takes(b, hd):
        raise ValueError(f"bilstm_layer takes T >= 1, 1 <= B <= {MAX_BATCH}, 1 <= H <= "
                         f"{MAX_HIDDEN} up to {MAX_ROWS} rows and H <= {ROWS_MAX_HIDDEN} past "
                         f"them, got B {b}, H {hd}, T {t}")
    want = {"w_ih": (4 * hd, n_in), "w_hh": (4 * hd, hd), "bias": (4 * hd,)}
    named = {"x": x}
    for side, ws in (("forward", fwd), ("backward", bwd)):
        for (what, shape), w in zip(want.items(), ws):
            if tuple(w.shape) != shape:
                raise ValueError(f"bilstm_layer: the {side} {what} is {tuple(w.shape)}, want "
                                 f"{shape}")
            named[f"the {side} {what}"] = w
    if mask is not None:
        if tuple(mask.shape) != (b, t):
            raise ValueError(f"bilstm_layer: mask {tuple(mask.shape)} for x {tuple(x.shape)}")
        named["mask"] = mask
    for what, v in named.items():
        if v.dtype != torch.float32:
            raise ValueError(f"bilstm_layer takes float32 tensors, {what} is {v.dtype}")
        if v.device != x.device:
            raise ValueError(f"bilstm_layer: {what} on {v.device} but x on {x.device}")
    for what in ("the forward w_hh", "the backward w_hh", "mask"):
        if what in named and not named[what].is_contiguous():
            raise ValueError(f"bilstm_layer takes {what} contiguous")
    check_device(x.device, "bilstm_layer")


def _launch(x: torch.Tensor, mask: torch.Tensor | None, fwd, bwd) -> torch.Tensor:
    if torch.is_grad_enabled() and any(v.requires_grad for v in (x, *fwd, *bwd)):
        raise RuntimeError("bilstm_layer's kernels have no backward: call it under no_grad")
    b, t, n_in = x.shape
    hd = fwd[1].shape[1]
    xproj = torch.addmm(torch.cat([fwd[2], bwd[2]]), x.reshape(b * t, n_in),
                        torch.cat([fwd[0], bwd[0]]).T)  # [B·T, 8H]
    out = torch.empty((b, t, 2 * hd), dtype=torch.float32, device=x.device)
    lib = load_library()
    many = b > MAX_ROWS
    entry = lib.amss_blstm_rows if many else lib.amss_blstm
    with torch.cuda.device(x.device):
        err = entry(xproj.data_ptr(), fwd[1].data_ptr(), bwd[1].data_ptr(),
                    None if mask is None else mask.data_ptr(), out.data_ptr(), *c_ints(b, t, hd),
                    torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(lib, "blstm_rows" if many else "blstm", err)
    if many:
        bilstm_layer.rows_launches += 1
    else:
        bilstm_layer.launches += 1
    return out


def bilstm_layer(x: torch.Tensor, mask: torch.Tensor | None, fwd, bwd) -> torch.Tensor:
    """One bidirectional layer (module docstring): a kernel on CUDA, chosen
    by the rows, the plain version on the CPU, after the same checks."""
    _check(x, mask, fwd, bwd)
    if x.device.type == "cpu":
        return bilstm_layer_ref(x, mask, fwd, bwd)
    return _launch(x, mask, fwd, bwd)


bilstm_layer.launches = 0
bilstm_layer.rows_launches = 0

