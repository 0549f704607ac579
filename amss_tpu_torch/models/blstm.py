"""Bidirectional LSTM stack (``amss_tpu/models/blstm.py``).

The weights live in one ``nn.LSTM(bidirectional=True)``, whose gate order
(i, f, g, o) is the JAX package's: ``weight_ih = wxᵀ``, ``weight_hh = whᵀ``,
``bias_ih = b`` and ``bias_hh = 0``, which is frozen (no gradient).  Five
ways to run them; ``BLSTM.path`` picks one from what the call shows (its
device, the compute dtype, whether autograd records, dropout, export, its
rows and the hidden size), and the ``trunk`` span records it as
``blstm_path``:

* ``loop``: an explicit loop with the reference's mask semantics (padded steps
  freeze (h, c) and output 0; the backward direction runs on the flipped
  input), ``ops/kernels/blstm.py::bilstm_layer_ref`` a layer.  It takes any
  mask.  Every live float32 call on the CPU runs it.
* ``kernel``: ``ops/kernels/blstm.py::bilstm_layer`` a layer on CUDA: one
  float32 GEMM for both directions' input projections and one launch of a
  recurrence kernel over every step of both directions, with ``loop``'s
  function for any mask, read on the card (no host lengths, no packing):
  ``csrc/blstm.cu`` up to ``MAX_ROWS`` rows (the measured crossover with
  ``packed`` at H = 300) and ``MAX_HIDDEN`` cells, ``csrc/blstm_rows.cu``
  past ``MAX_ROWS`` rows at up to ``ROWS_MAX_HIDDEN`` cells (DPRNN's paths;
  the limits are ``ops/kernels/blstm.py``'s, its ``takes`` the rule).
  Live float32 calls on CUDA take it where autograd does not record and
  without dropout, at the hidden sizes the kernel of their rows takes;
  ``lengths`` is not read.
* ``packed``: cuDNN's LSTM over packed prefix-length sequences.  For a prefix
  mask it computes ``loop``'s function; it runs on CUDA, in FP32 (TF32 off),
  and trains (cuDNN's backward needs the module in training mode).  The other
  live float32 calls on CUDA take it: training, dropout, or more cells than
  the kernel of their rows takes.  The lengths come from the caller when it
  has them on the host; otherwise the mask is copied to the host, once a
  call.
* ``traced``: two unidirectional ``torch.lstm`` calls a layer over the whole
  bucket, the reverse one on each row reversed within its own length by one
  ``gather``.  It reads no host data, so ``torch.export`` can trace it, and
  it computes ``loop``'s function for prefix masks (it does not check that
  the mask is one).  Every exported float32 program runs it.
* ``bf16``: in bfloat16 (``compute_dtype``) every live call, on either
  device, runs ``loop_bf16``, the JAX package's
  ``_bilstm_fused_scan(compute_dtype=bf16)``: ``ops/blstm_bf16.py::
  bilstm_bf16`` a layer, both directions in one loop, each step one batched
  ``[2, B, H] x [2, H, 4H]`` product; x, h and the weights rounded to bf16,
  the products summed in float32, the bias, gates, cell state c, h and the
  mask's freeze in float32.  Its products are ``Bf16Bmm``, whose gradients
  are rounded to bf16 as JAX's are, the weights' cast made once outside the
  loop, so that a weight's gradient sums over the steps in bf16, as JAX's
  scan sums it.  It takes any mask.  cuDNN's own bf16 LSTM keeps h in bf16
  and is not that function.  Under ``torch.export`` each layer is one
  operator, ``amss::blstm_bf16_layer``, which runs the same loop when the
  program runs.

With a dropout key and a rate, dropout follows every layer, the last one
included, as in the JAX package's ``blstm_stack``; cuDNN then runs one layer
at a time, copying that layer's weights out of the flat buffer each call.

``dense`` is the JAX package's ``dense`` (``blstm.py:43-46``) over an
``nn.Linear`` holding ``weight = wᵀ``, in float32 or bfloat16.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.rnn import PackedSequence, pack_padded_sequence, pad_packed_sequence

# importing ops/blstm_bf16.py registers the operator amss::blstm_bf16_layer
from amss_tpu_torch.ops.blstm_bf16 import Bf16Bmm, bf16_mm, bilstm_bf16
from amss_tpu_torch.ops.kernels.blstm import bilstm_layer, bilstm_layer_ref, takes
from amss_tpu_torch.utils.profiling import SYNC_LENGTHS, span

# The row rule (ops/kernels/blstm.py::takes): up to MAX_ROWS (192) rows
# csrc/blstm.cu, past them csrc/blstm_rows.cu where H <= ROWS_MAX_HIDDEN
# (128), else packed.  So rows of H = 192 past 192 rows run packed:
# TF-GridNet's (models/tfgridnet.py), whose benchmark cell serves intra rows
# [5992, 62, 192] and inter rows [520, 764, 192] (746 steps valid), every
# call given its host lengths.
# One layer, csrc/blstm.cu | packed ms (packed given host lengths) | cuDNN
# unpacked ms where every row is whole | csrc/blstm_rows.cu, on an H100 80GB
# HBM3 at 700 W (PERF.md §6; each kernel with the projection's GEMM):
#   H = 300, 765 steps: 8 rows 1.86-1.94 | 14.4-17.5, 128 21.8-22.0 |
#     24.0-29.6, 160 26.7 | 31.6-32.9, 192 32.6-33.0 | 22.8-36.8, 256
#     42.4 | 24.3-35.5 (csrc/blstm_rows.cu takes no H = 300);
#   H = 128, 250 steps: 64 rows 1.80 | 9.1-9.3 | 1.26, 128 3.03 | 7.3-10.6
#     | 1.39, 256 6.0 | 10.9 | 2.68, 512 11.3 | 9.1-9.3 | 4.81, 1000 rows
#     packed 7.0-9.1 | 4.22-4.66;
#   c6's DPRNN inter rows [256, 125, 128], masked, 3.12-3.13 | 2.46-4.35 |
#     | 2.03-2.14;
#   DPRNN-TasNet's intra rows [3088, 250, 64] 65.4-65.5 | 14.7-16.4 | 24.8
#     | 8.61-8.93 and inter rows [2000, 396, 64], 386 valid, 67.1-67.6 |
#     16.0-17.0 | | 9.90-10.34.
# cuDNN's packed call enqueues its steps one by one, so below a few hundred
# rows its time is the host's and moves with the host by a third.
# csrc/blstm.cu's clusters of 16 carry at most 8 rows each and run in waves
# past a few dozen rows; csrc/blstm_rows.cu cuts the rows into tiles that
# fill the card in one wave and wins wherever it was measured past 192 rows
# at H = 128.  The crossover of the two kernels was not measured, so
# MAX_ROWS stays where csrc/blstm.cu was measured against packed at H = 300.
# Unpacked cuDNN lies 1.1e-5 of the peak from the float64 loop
# (ROADMAP C.15), the kernels and packed 3-7e-7.


def prefix_lengths(mask: torch.Tensor) -> torch.Tensor:
    """The valid lengths (int64, on the host) of a prefix mask ``[B, T]``,
    copied to the host once: cuDNN wants them there.  Any other mask is
    refused."""
    with span(SYNC_LENGTHS):
        m = mask.to("cpu") > 0
    lengths = m.sum(dim=1)
    if not torch.equal(m, torch.arange(m.shape[1])[None, :] < lengths[:, None]):
        raise ValueError("the packed BLSTM takes prefix masks only")
    return lengths


def blstm_path(device_type: str, dtype: torch.dtype, compute_dtype: torch.dtype, rows: int,
               hidden: int, grad: bool, dropout: bool, exporting: bool) -> str:
    """The path (module docstring) of a call on ``device_type`` with input
    ``dtype``, ``rows`` rows and ``hidden`` cells, with autograd recording
    (``grad``), with dropout, or under ``torch.export``."""
    if compute_dtype == torch.bfloat16:
        return "bf16"
    if compute_dtype != torch.float32:
        raise ValueError(f"compute dtype {compute_dtype} is neither float32 nor bfloat16")
    if exporting:
        return "traced"
    if device_type != "cuda":
        return "loop"
    if grad or dropout or dtype != torch.float32:
        return "packed"
    return "kernel" if takes(rows, hidden) else "packed"


class BLSTM(nn.Module):
    def __init__(self, n_in: int, hidden: int, layers: int):
        super().__init__()
        self.hidden = hidden
        self.layers = layers
        self.lstm = nn.LSTM(n_in, hidden, num_layers=layers, batch_first=True,
                            bidirectional=True)
        # the JAX cell has one bias, carried in bias_ih; a trained bias_hh
        # would take the same gradient again and double the bias's step
        for name, p in self.lstm.named_parameters():
            if name.startswith("bias_hh"):
                p.requires_grad_(False)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """``init_blstm_stack``'s distributions: wx and wh uniform in
        ±1/√hidden, the bias 0 with the forget gate at 1.0; ``bias_hh`` stays
        0 (the JAX cell has one bias)."""
        hd = self.hidden
        for name, p in self.lstm.named_parameters():
            if name.startswith("weight_"):
                p.copy_(torch.empty(p.shape).uniform_(-1.0 / math.sqrt(hd), 1.0 / math.sqrt(hd),
                                                      generator=generator))
            elif name.startswith("bias_ih"):
                p.zero_()
                p[hd : 2 * hd] = 1.0
            else:
                p.zero_()

    def path(self, x: torch.Tensor, dropout_rate: float = 0.0, rng=None,
             compute_dtype: torch.dtype = torch.float32) -> str:
        """The path ``forward`` takes for this call (``blstm_path``)."""
        return blstm_path(x.device.type, x.dtype, compute_dtype, x.shape[0], self.hidden,
                          torch.is_grad_enabled(), rng is not None and dropout_rate > 0.0,
                          torch.compiler.is_exporting())

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                lengths: torch.Tensor | None = None, dropout_rate: float = 0.0,
                rng=None, compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """x ``[B, T, In]``, mask ``[B, T]`` (1 = valid) -> ``[B, T, 2H]``.

        ``lengths`` (int64 on the host) are the mask's prefix lengths, where
        the caller has them: the packed path then copies nothing to the host.
        ``rng`` (a ``models/dprnn.py::DropoutKey``) turns dropout on.
        ``compute_dtype`` bfloat16 runs ``loop_bf16`` on any device."""
        path = self.path(x, dropout_rate, rng, compute_dtype)
        dropping = rng is not None and dropout_rate > 0.0
        if path == "bf16":
            if torch.compiler.is_exporting():
                if dropping:
                    raise NotImplementedError("an exported BLSTM runs without dropout")
                h = x
                for layer in range(self.layers):
                    h = torch.ops.amss.blstm_bf16_layer(h, mask, *self._bf16_weights(layer))
                return h
            return self.loop_bf16(x, mask, dropout_rate, rng)
        if path == "traced":
            if dropping:
                raise NotImplementedError("an exported BLSTM runs without dropout")
            return self.traced(x, mask)
        if path == "kernel":
            return self.kernel(x, mask)
        cuda = path == "packed"
        if cuda and mask is not None and lengths is None:
            lengths = prefix_lengths(mask)
        if not dropping:
            return self.packed(x, mask, lengths) if cuda else self.loop(x, mask)
        from amss_tpu_torch.models.dprnn import dropout

        h = x
        for layer, r in enumerate(rng.split(self.layers)):
            h = self.packed(h, mask, lengths, layer) if cuda else self._layer_loop(h, mask, layer)
            h = dropout(h, dropout_rate, r)
        return h

    def kernel(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        """Every layer through ``bilstm_layer``: on CUDA, one GEMM and one
        launch of the recurrence kernel a layer; the mask as float32."""
        m = None if mask is None else mask.to(torch.float32).contiguous()
        h = x
        for layer in range(self.layers):
            h = bilstm_layer(h, m, self._weights(layer, False), self._weights(layer, True))
        return h

    def _weights(self, layer: int, reverse: bool):
        sfx = f"_l{layer}" + ("_reverse" if reverse else "")
        p = self.lstm
        return (
            getattr(p, "weight_ih" + sfx),
            getattr(p, "weight_hh" + sfx),
            getattr(p, "bias_ih" + sfx) + getattr(p, "bias_hh" + sfx),
        )

    def _layer_loop(self, x, mask, layer: int) -> torch.Tensor:
        return bilstm_layer_ref(x, mask, self._weights(layer, False), self._weights(layer, True))

    def loop(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        h = x
        for layer in range(self.layers):
            h = self._layer_loop(h, mask, layer)
        return h

    def _bf16_weights(self, layer: int) -> tuple:
        """One layer's (wx ``[2, In, 4H]``, wh ``[2, H, 4H]``) in bf16 and bias
        ``[2, 1, 4H]`` in float32, (forward, backward) stacked; the casts
        happen once, outside the loop, as in the JAX package."""
        fwd, bwd = self._weights(layer, False), self._weights(layer, True)
        wx = torch.stack([fwd[0].T, bwd[0].T]).to(torch.bfloat16)
        wh = torch.stack([fwd[1].T, bwd[1].T]).to(torch.bfloat16)
        bias = torch.stack([fwd[2], bwd[2]])[:, None, :]
        return wx, wh, bias

    def _layer_bf16(self, x: torch.Tensor, mask: torch.Tensor | None, layer: int) -> torch.Tensor:
        """One layer, both directions in one loop, bf16 products into float32
        (``ops/blstm_bf16.py::bilstm_bf16``), differentiable."""
        return bilstm_bf16(x, mask, *self._bf16_weights(layer), bmm=Bf16Bmm.apply)

    def loop_bf16(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                  dropout_rate: float = 0.0, rng=None) -> torch.Tensor:
        """Every layer through ``_layer_bf16``, dropout after each with a
        key."""
        from amss_tpu_torch.models.dprnn import dropout

        keys = [None] * self.layers if rng is None else rng.split(self.layers)
        h = x
        for layer, r in enumerate(keys):
            h = dropout(self._layer_bf16(h, mask, layer), dropout_rate, r)
        return h

    def _one_way(self, x: torch.Tensor, layer: int, reverse: bool) -> torch.Tensor:
        """One direction of one layer over every step of ``x`` ``[B, T, In]``:
        one unidirectional ``torch.lstm`` call on that direction's weights."""
        sfx = f"_l{layer}" + ("_reverse" if reverse else "")
        w = [getattr(self.lstm, n + sfx) for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
        h0 = x.new_zeros((1, x.shape[0], self.hidden))
        return torch.lstm(x, (h0, h0), w, True, 1, 0.0, self.training, False, True)[0]

    def traced(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        """Every layer as two unidirectional calls over the whole bucket, with
        no host data.  With a prefix mask, row b's reverse direction runs on
        its first ``len_b`` steps reversed in place (step t reads ``len_b - 1
        - t``; the padded steps keep their places, after the valid ones), and
        each layer's output is zeroed on the padded steps, so the valid steps
        see what ``loop`` computes.  On CUDA it runs cuDNN in FP32 (TF32
        off); an exported program's caller sets that flag itself."""
        if mask is None:
            def rev(h):
                return torch.flip(h, dims=(1,))
        else:
            steps = torch.arange(x.shape[1], device=x.device)[None, :]
            lengths = (mask > 0).sum(dim=1, keepdim=True)  # [B, 1], on the device
            idx = torch.where(steps < lengths, lengths - 1 - steps, steps)[..., None]

            def rev(h):  # an involution: it also un-reverses
                return torch.gather(h, 1, idx.expand(-1, -1, h.shape[-1]))
        flags = torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=False, allow_tf32=False
        )
        h = x
        with flags:
            for layer in range(self.layers):
                h = torch.cat([self._one_way(h, layer, False),
                               rev(self._one_way(rev(h), layer, True))], dim=-1)
                if mask is not None:
                    h = h.masked_fill(mask[..., None] <= 0, 0.0)
        return h

    def _cudnn(self, inp, layer: int | None, batch_sizes=None) -> torch.Tensor:
        """cuDNN's LSTM over every layer (``layer`` None), or over one: the
        call ``nn.LSTM.forward`` makes, given that layer's weights alone."""
        if layer is None:
            if batch_sizes is None:
                return self.lstm(inp)[0]
            return self.lstm(PackedSequence(inp, batch_sizes))[0].data
        w = [getattr(self.lstm, f"{n}_l{layer}{sfx}") for sfx in ("", "_reverse")
             for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
        n = inp.shape[0] if batch_sizes is None else int(batch_sizes[0])
        h0 = inp.new_zeros((2, n, self.hidden))
        if batch_sizes is None:
            return torch._VF.lstm(inp, (h0, h0), w, True, 1, 0.0, self.training, True, True)[0]
        return torch._VF.lstm(inp, batch_sizes, (h0, h0), w, True, 1, 0.0, self.training,
                              True)[0]

    def packed(self, x: torch.Tensor, mask: torch.Tensor | None = None,
               lengths: torch.Tensor | None = None, layer: int | None = None) -> torch.Tensor:
        """cuDNN over every layer, or over ``layer`` alone.  The rows are
        sorted by length on the host and reordered on the device through
        pinned copies, so a call given ``lengths`` waits for nothing.
        Without a mask, ``lengths`` (each at least 1) still pack the call:
        cuDNN's unpacked float32 LSTM lies further from ``loop`` at H = 128
        (ROADMAP C.15); with neither, it runs unpacked."""
        flags = torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=False, allow_tf32=False
        )
        if mask is None and lengths is None:
            with flags:
                return self._cudnn(x, layer)
        if lengths is None:
            lengths = prefix_lengths(mask)
        order = torch.argsort(lengths, descending=True, stable=True)
        unorder = torch.empty_like(order)
        unorder[order] = torch.arange(order.numel())

        def on_device(idx):
            if x.device.type != "cuda":
                return idx
            return idx.pin_memory().to(x.device, non_blocking=True)

        packed = pack_padded_sequence(
            x.index_select(0, on_device(order)), torch.clamp(lengths[order], min=1),
            batch_first=True, enforce_sorted=True)
        with flags:
            data = self._cudnn(packed.data, layer, packed.batch_sizes)
        out, _ = pad_packed_sequence(PackedSequence(data, packed.batch_sizes),
                                     batch_first=True, total_length=x.shape[1])
        out = out.index_select(0, on_device(unorder))
        # rows with no valid frame output 0
        return out if mask is None else out * mask[..., None]


class _Bf16Dense(torch.autograd.Function):
    """``x @ wᵀ + b`` with x and w rounded to bf16, the products summed in
    float32 and the bias added in float32.  The backward is JAX's transpose
    of that product: each operand's gradient is the float32 product of the
    float32 cotangent with the other bf16 operand, rounded to bf16 (the
    gradient of the cast), and the bias's is the cotangent's sum."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        xb = x.reshape(-1, x.shape[-1]).to(torch.bfloat16)
        wb = weight.to(torch.bfloat16)
        ctx.save_for_backward(xb, wb)
        ctx.lead = x.shape[:-1]
        return bf16_mm(xb, wb.T).reshape(*x.shape[:-1], -1) + bias

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = (g2 @ wb.float()).to(torch.bfloat16).float().reshape(*ctx.lead, -1)
        if ctx.needs_input_grad[1]:
            dw = (g2.T @ xb.float()).to(torch.bfloat16).float()
        if ctx.needs_input_grad[2]:
            db = g2.sum(dim=0)
        return dx, dw, db


@torch.no_grad()
def init_dense(layer: nn.Linear, generator: torch.Generator, scale: float | None = None) -> None:
    """``_init_dense``'s distribution: w ``[in, out]`` uniform in ±scale
    (1/√in by default), drawn in that layout from ``generator``; bias 0
    where the layer has one."""
    n_in = layer.in_features
    scale = 1.0 / math.sqrt(n_in) if scale is None else scale
    w = torch.empty(n_in, layer.out_features).uniform_(-scale, scale, generator=generator)
    layer.weight.copy_(w.T)
    if layer.bias is not None:
        layer.bias.zero_()


def dense(layer: nn.Linear, x: torch.Tensor, compute_dtype: torch.dtype = torch.float32):
    """``x @ w + b`` of the JAX package's ``dense`` (``layer.weight = wᵀ``).

    In bfloat16 the JAX package casts x and w to bf16, multiplies with a
    float32 result and adds the float32 bias.  ``x.bfloat16() @
    w.bfloat16()`` would round the product to bf16 as well; ``_Bf16Dense``
    does not."""
    if compute_dtype == torch.float32:
        return F.linear(x, layer.weight, layer.bias)
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"compute dtype {compute_dtype} is neither float32 nor bfloat16")
    return _Bf16Dense.apply(x, layer.weight, layer.bias)
