"""Plain DPRNN-TasNet (Luo, Chen and Yoshioka, "Dual-path RNN: efficient long
sequence modeling for time-domain single-channel speech separation", ICASSP
2020, arXiv:1910.06379), its best WSJ0-2mix configuration, with the masker
of SpeechBrain's ``Dual_Path_Model`` (``speechbrain/lobes/models/
dual_path.py``) and ``SBRNNBlock`` paths, step for step on one unpadded
mixture ``[T]``:

* ``Encoder``: a bias-free Conv1d (N filters of L taps, stride L/2), ReLU:
  ``codes = ReLU(frames(mix, L, L/2) @ enc)`` ``[T', N]``, T' = 1 + (T - L)
  // (L/2);
* ``Dual_Path_Model``: GroupNorm(1, N, eps), a bias-free 1x1 conv N -> D,
  ``_Segmentation`` (chunks of K at hop K/2, ``reference/sepformer.py``),
  R ``Dual_Computation_Block``s with ``linear_layer_after_inter_intra`` and
  the skip around intra:

      intra = GN(W_a · BLSTM_a(x over K) + b_a) + x
      out   = GN(W_e · BLSTM_e(intra over S) + b_e) + intra

  then PReLU, a 1x1 conv D -> D·S, ``_over_add``, tanh(conv)·sigmoid(conv),
  a bias-free 1x1 conv D -> N and ReLU masks;
* each BLSTM ``layers`` layers of H cells a direction, gates (i, f, g, o):
  an explicit cell loop over a batch of rows (h ``[rows, H]``), the
  backward direction on the time-reversed rows, the bias b_ih + b_hh;
* ``Decoder``: a bias-free ConvTranspose1d (N -> 1, L taps, stride L/2),
  padded or trimmed to the mixture's length.

Departures from the paper, which the configuration lists too: the mask head
and its ReLU are SpeechBrain's ``Dual_Path_Model``'s; the weights are random
from the seed.  Every product, the recurrent ones included, goes through
``Products``, so the control rounds them all.  Rows of a batch are mixtures
of one length, each run at its own length, so nothing is masked.  Widths come
from the configuration's ``port`` entry (D = ``sep.hidden``, H =
``sep.expansion``·D, ``sep.blocks`` BLSTM layers a path, R =
``sep.repeats``, K = ``sep.chunk_frames``), the GroupNorms' eps from its top
level; the weights by the port's parameter names in its layouts (an
``nn.LSTM``'s ``weight_ih_l0 [4H, In]``, ``weight_hh_l0 [4H, H]``; an
``nn.Linear``'s ``[out, in]``; the front's ``enc [L, N]``, ``dec [N, L]``).
Everything is differentiable, for a training reference.  Nothing here
imports the port or JAX.
"""

from __future__ import annotations

import torch

from bm import flops
from reference.dsp import Products, frames, overlap_add
from reference.sepformer import group_norm, over_add, segmentation
from reference.tasnet import pit_si_sdr, prelu


def widths(cfg: dict) -> dict:
    """The widths the model runs at, from the configuration's ``port``
    entry."""
    p = cfg["port"]
    f, s = p["front"], p["sep"]
    return {"N": f["n_filters"], "L": f["filter_len"], "stride": f["stride"],
            "D": s["hidden"], "H": s["expansion"] * s["hidden"], "layers": s["blocks"],
            "repeats": s["repeats"], "K": s["chunk_frames"], "S": p["nb_speakers"]}


def direction(x, w_ih, w_hh, bias, mm: Products, reverse: bool):
    """One direction of one LSTM layer over ``x [R, T, In]`` -> ``[R, T, H]``:
    the input products for every step at once, then the cell, step by step."""
    if reverse:
        x = torch.flip(x, dims=(1,))
    hd = w_hh.shape[1]
    xp = mm.linear(x, w_ih, bias)  # [R, T, 4H]
    h = x.new_zeros(x.shape[0], hd)
    c = x.new_zeros(x.shape[0], hd)
    outs = []
    for t in range(x.shape[1]):
        gates = xp[:, t] + mm(h, w_hh.t())
        i = torch.sigmoid(gates[:, :hd])
        f = torch.sigmoid(gates[:, hd:2 * hd])
        g = torch.tanh(gates[:, 2 * hd:3 * hd])
        o = torch.sigmoid(gates[:, 3 * hd:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        outs.append(h)
    out = torch.stack(outs, dim=1)
    return torch.flip(out, dims=(1,)) if reverse else out


def blstm(x, w: dict, pre: str, layers: int, mm: Products):
    """A bidirectional LSTM of ``layers`` layers over ``x [R, T, In]`` ->
    ``[R, T, 2H]``, the forward direction's h then the backward's."""
    for layer in range(layers):
        outs = []
        for sfx, reverse in (("", False), ("_reverse", True)):
            q = f"{pre}weight_ih_l{layer}{sfx}", f"{pre}weight_hh_l{layer}{sfx}"
            bias = w[f"{pre}bias_ih_l{layer}{sfx}"] + w[f"{pre}bias_hh_l{layer}{sfx}"]
            outs.append(direction(x, w[q[0]], w[q[1]], bias, mm, reverse))
        x = torch.cat(outs, dim=-1)
    return x


def dual_block(x, w: dict, pre: str, cfg: dict, mm: Products):
    """``Dual_Computation_Block`` (norm "ln", skip around intra, a linear
    after each path) on the chunks ``x [B, S, K, D]``."""
    b, s, k, d = x.shape
    eps, layers = cfg["group_norm_eps"], widths(cfg)["layers"]
    intra = blstm(x.reshape(b * s, k, d), w, pre + "intra.lstm.lstm.", layers, mm)
    intra = mm.linear(intra, w[pre + "intra.proj.weight"], w[pre + "intra.proj.bias"])
    intra = group_norm(intra.reshape(b, s, k, d), w[pre + "intra_norm.g"],
                       w[pre + "intra_norm.b"], eps) + x
    inter = blstm(intra.transpose(1, 2).reshape(b * k, s, d), w, pre + "inter.lstm.lstm.",
                  layers, mm)
    inter = mm.linear(inter, w[pre + "inter.proj.weight"], w[pre + "inter.proj.bias"])
    inter = group_norm(inter.reshape(b, k, s, d).transpose(1, 2), w[pre + "inter_norm.g"],
                       w[pre + "inter_norm.b"], eps)
    return inter + intra


def forward(mix: torch.Tensor, w: dict, cfg: dict, mm: Products) -> torch.Tensor:
    """``mix [B, T]`` -> separated ``[B, S, T]``."""
    wd = widths(cfg)
    b, s, d = mix.shape[0], wd["S"], wd["D"]
    codes = torch.relu(mm(frames(mix, wd["L"], wd["stride"]), w["front.enc"]))  # [B, nf, N]
    nf = codes.shape[1]
    x = group_norm(codes, w["masker.norm.g"], w["masker.norm.b"], cfg["group_norm_eps"])
    x = mm.linear(x, w["masker.in_proj.weight"], None)
    x, gap = segmentation(x, wd["K"])
    for i in range(wd["repeats"]):
        x = dual_block(x, w, f"masker.blocks.{i}.", cfg, mm)
    x = prelu(w["masker.prelu"], x)
    x = mm.linear(x, w["masker.mask_proj.weight"], w["masker.mask_proj.bias"])
    _, n_chunks, k, _ = x.shape
    x = x.reshape(b, n_chunks, k, s, d).permute(0, 3, 1, 2, 4).reshape(b * s, n_chunks, k, d)
    x = over_add(x, gap)  # [B·S, nf, D]
    x = (torch.tanh(mm.linear(x, w["masker.output.weight"], w["masker.output.bias"]))
         * torch.sigmoid(mm.linear(x, w["masker.output_gate.weight"],
                                   w["masker.output_gate.bias"])))
    masks = torch.relu(mm.linear(x, w["masker.out_proj.weight"], None))
    sep_h = codes[:, None] * masks.reshape(b, s, nf, -1)  # [B, S, nf, N]
    return overlap_add(mm(sep_h, w["front.dec"]), wd["stride"], mix.shape[-1])


def separate(mix: torch.Tensor, wts: dict, cfg: dict, mm: Products) -> torch.Tensor:
    """The serving pass on one mixture ``[T]`` -> ``[S, T]``."""
    return forward(mix[None], wts, cfg, mm)[0]


def loss(sources: torch.Tensor, wts: dict, cfg: dict, mm: Products) -> torch.Tensor:
    """Negative mean PIT SI-SDR of the separation of the sum of ``sources
    [B, S, T]``."""
    est = forward(sources.sum(dim=1), wts, cfg, mm)
    return -pit_si_sdr(est, sources).mean()


def judge(mix: torch.Tensor, est: torch.Tensor, wts: dict, cfg: dict,
          padded_lengths=()) -> dict:
    """``serve.judged_error``: ||y_ref - est|| / ||y_ref|| of a program's
    separation ``est [S, T]`` of ``mix [T]``, over the samples that only the
    utterance's own frames cover.  Padding changes nothing here."""
    wd = widths(cfg)
    with torch.no_grad():
        ref = separate(mix, wts, cfg, Products())
    keep = flops.stft_frames(mix.shape[-1], wd["L"], wd["stride"]) * wd["stride"]
    return {"serve.judged_error":
            float((ref[:, :keep] - est[:, :keep]).norm() / ref[:, :keep].norm())}


def parameters(cfg: dict) -> int:
    """The model's parameter count at the configuration's widths: the
    encoder and decoder, the masker's norm and input conv, each path's BLSTM
    (both directions' two weights and two biases a layer, as ``nn.LSTM``
    holds them), linear and GroupNorm, the PReLU, the mask conv, the gate and
    the output conv."""
    wd = widths(cfg)
    n, l, d, h, spk = (wd[x] for x in ("N", "L", "D", "H", "S"))
    lstm = sum(2 * (4 * h * (d if i == 0 else 2 * h) + 4 * h * h + 8 * h)
               for i in range(wd["layers"]))
    path = lstm + (2 * h * d + d) + 2 * d
    return (2 * l * n + 2 * n + n * d + wd["repeats"] * 2 * path + 1
            + (d * d * spk + d * spk) + 2 * (d * d + d) + d * n)


def forward_flops(cfg: dict, t: int) -> float:
    """The products of the pass over one mixture of ``t`` samples, at the
    published segmentation of its own length (S·K positions, each run once
    by every path): the encoder, the input conv, each path's BLSTM layers
    (``bm/flops.py::lstm_flops`` a direction) and linear, the mask conv on the
    chunks, the gate, the output conv and the decoder."""
    wd = widths(cfg)
    n, l, d, h, k, spk = (wd[x] for x in ("N", "L", "D", "H", "K", "S"))
    nf = flops.stft_frames(t, l, wd["stride"])
    pos = 2 * ((k // 2 + nf) // k + 1) * k
    lstm = sum(2.0 * flops.lstm_flops(pos, d if i == 0 else 2 * h, h)
               for i in range(wd["layers"]))
    path = lstm + 2.0 * pos * 2 * h * d
    ops = 2.0 * nf * l * n + 2.0 * nf * n * d
    ops += wd["repeats"] * 2 * path
    ops += 2.0 * pos * d * d * spk + spk * (2.0 * 2.0 * nf * d * d + 2.0 * nf * d * n)
    ops += 2.0 * spk * nf * n * l
    return ops
