"""Bidirectional LSTM stack (``amss_tpu/models/blstm.py``).

The weights live in one ``nn.LSTM(bidirectional=True)``, whose gate order
(i, f, g, o) is the JAX package's: ``weight_ih = wxᵀ``, ``weight_hh = whᵀ``,
``bias_ih = b`` and ``bias_hh = 0``, which is frozen (no gradient).  Two
ways to run them:

* ``loop``: an explicit loop with the reference's mask semantics (padded steps
  freeze (h, c) and output 0; the backward direction runs on the flipped
  input).  It takes any mask and runs on the CPU and in the tests.
* ``packed``: cuDNN's LSTM over packed prefix-length sequences.  For a prefix
  mask, which is all the serving path builds, it computes the same thing; it
  runs on CUDA, in FP32 (TF32 off), and trains (cuDNN's backward needs the
  module in training mode).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence


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

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        """x ``[B, T, In]``, mask ``[B, T]`` (1 = valid) -> ``[B, T, 2H]``."""
        if x.device.type == "cuda":
            return self.packed(x, mask)
        return self.loop(x, mask)

    def _weights(self, layer: int, reverse: bool):
        sfx = f"_l{layer}" + ("_reverse" if reverse else "")
        p = self.lstm
        return (
            getattr(p, "weight_ih" + sfx),
            getattr(p, "weight_hh" + sfx),
            getattr(p, "bias_ih" + sfx) + getattr(p, "bias_hh" + sfx),
        )

    def _direction(self, x, mask, layer: int, reverse: bool) -> torch.Tensor:
        wx, wh, bias = self._weights(layer, reverse)
        if reverse:
            x = torch.flip(x, dims=(1,))
            mask = None if mask is None else torch.flip(mask, dims=(1,))
        b, t, _ = x.shape
        hd = self.hidden
        xproj = x @ wx.T + bias  # input projection hoisted out of the loop
        h = x.new_zeros((b, hd))
        c = x.new_zeros((b, hd))
        outs = []
        for s in range(t):
            gates = xproj[:, s] + h @ wh.T
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

    def loop(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        h = x
        for layer in range(self.layers):
            h = torch.cat(
                [self._direction(h, mask, layer, False), self._direction(h, mask, layer, True)],
                dim=-1,
            )
        return h

    def packed(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        flags = torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=False, allow_tf32=False
        )
        if mask is None:
            with flags:
                return self.lstm(x)[0]
        m = mask.to("cpu")  # cuDNN wants the lengths on the host
        lengths = (m > 0).sum(dim=1)
        steps = torch.arange(m.shape[1])
        if not torch.equal(m > 0, steps[None, :] < lengths[:, None]):
            raise ValueError("the packed BLSTM takes prefix masks only")
        packed = pack_padded_sequence(
            x, torch.clamp(lengths, min=1), batch_first=True, enforce_sorted=False
        )
        with flags:
            out = self.lstm(packed)[0]
        out, _ = pad_packed_sequence(out, batch_first=True, total_length=x.shape[1])
        return out * mask[..., None]  # rows with no valid frame output 0
