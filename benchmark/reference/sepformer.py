"""Plain SepFormer (Subakan et al., ICASSP 2021, arXiv:2010.13154) as
SpeechBrain's released recipe builds it (``recipes/WSJ0Mix/separation/
hparams/sepformer.yaml`` over ``speechbrain/lobes/models/dual_path.py``),
step for step on one unpadded mixture:

* ``Encoder``: a bias-free Conv1d (N filters of L taps, stride L/2), ReLU;
* ``Dual_Path_Model``: GroupNorm(1, N, eps), a bias-free 1x1 conv,
  ``_Segmentation`` (``_padding``'s K/2 zeros at each end plus the gap, two
  tilings K/2 apart interleaved), ``num_layers`` ``Dual_Computation_Block``s
  (intra ``SBTransformerBlock`` over each chunk, GroupNorm, + its input;
  inter ``SBTransformerBlock`` over the chunks, GroupNorm, + the intra
  output), PReLU, a 1x1 conv to D·S, ``_over_add``, tanh(conv)·sigmoid(conv),
  a bias-free 1x1 conv, ReLU;
* an ``SBTransformerBlock``: the interleaved sinusoid of its
  ``PositionalEncoding`` added, pre-LN ``TransformerEncoderLayer``s
  (``nn.MultiheadAttention``: q scaled by 1/√dh, softmax, the value
  product), and the ``TransformerEncoder``'s final LayerNorm;
* ``Decoder``: a bias-free ConvTranspose1d, padded or trimmed to the
  mixture's length, as the recipe's ``compute_forward`` does.

Every product, the attention's included, goes through ``Products``, so the
control rounds them all.  Widths come from the configuration's ``port``
entry, the norms' eps from its top level.  The weights come by the port's
parameter names in its layouts (``nn.Linear`` weights ``[out, in]``; the
front's ``enc [L, N]``, ``dec [N, L]``).  Rows of a batch are mixtures of one
length; everything is differentiable, for the training reference.
"""

from __future__ import annotations

import math

import torch

from bm import flops
from reference.dsp import Products, frames, overlap_add
from reference.tasnet import pit_si_sdr, prelu


def widths(cfg: dict) -> dict:
    """The widths the model runs at, from the configuration's ``port``
    entry."""
    p = cfg["port"]
    f, s = p["front"], p["sep"]
    return {"N": f["n_filters"], "L": f["filter_len"], "stride": f["stride"],
            "D": s["hidden"], "heads": s["heads"], "F": s["expansion"] * s["hidden"],
            "layers": s["blocks"], "repeats": s["repeats"], "K": s["chunk_frames"],
            "S": p["nb_speakers"]}


def layer_norm(x, g, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * g + b


def group_norm(x, g, b, eps):
    """``nn.GroupNorm(1, D)`` on ``x [B, ..., D]``: the statistics of each
    row over every other axis, the gain and bias per channel."""
    dims = tuple(range(1, x.dim()))
    mu = x.mean(dims, keepdim=True)
    var = ((x - mu) ** 2).mean(dims, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * g + b


def positional_encoding(length: int, d: int, device) -> torch.Tensor:
    """SpeechBrain's ``PositionalEncoding``: sin in the even columns, cos in
    the odd, at ``exp(-2i·ln(10000)/d)``."""
    pe = torch.zeros(length, d, device=device)
    pos = torch.arange(0, length, device=device).unsqueeze(1).float()
    den = torch.exp(torch.arange(0, d, 2, device=device).float() * -(math.log(10000.0) / d))
    pe[:, 0::2] = torch.sin(pos * den)
    pe[:, 1::2] = torch.cos(pos * den)
    return pe


def attention(x, w: dict, pre: str, heads: int, mm: Products):
    """``nn.MultiheadAttention`` self-attention on ``x [N, L, D]``."""
    n, l, d = x.shape
    dh = d // heads

    def split(t):
        return t.reshape(n, l, heads, dh).transpose(1, 2)  # [N, H, L, dh]

    q = split(mm.linear(x, w[pre + "wq.weight"], w[pre + "wq.bias"])) * (1.0 / math.sqrt(dh))
    k = split(mm.linear(x, w[pre + "wk.weight"], w[pre + "wk.bias"]))
    v = split(mm.linear(x, w[pre + "wv.weight"], w[pre + "wv.bias"]))
    a = torch.softmax(mm(q, k.transpose(-1, -2)), dim=-1)
    o = mm(a, v).transpose(1, 2).reshape(n, l, d)
    return mm.linear(o, w[pre + "wo.weight"], w[pre + "wo.bias"])


def transformer_block(x, w: dict, pre: str, cfg: dict, mm: Products):
    """``SBTransformerBlock`` (pre-LN, position code on) over ``x [N, L, D]``."""
    wd, eps = widths(cfg), cfg["layer_norm_eps"]
    x = x + positional_encoding(x.shape[1], x.shape[2], x.device)
    for j in range(wd["layers"]):
        q = f"{pre}layers.{j}."
        h = layer_norm(x, w[q + "ln1.g"], w[q + "ln1.b"], eps)
        x = x + attention(h, w, q + "attn.", wd["heads"], mm)
        h = layer_norm(x, w[q + "ln2.g"], w[q + "ln2.b"], eps)
        f = torch.relu(mm.linear(h, w[q + "ffn.w1.weight"], w[q + "ffn.w1.bias"]))
        x = x + mm.linear(f, w[q + "ffn.w2.weight"], w[q + "ffn.w2.bias"])
    return layer_norm(x, w[pre + "norm.g"], w[pre + "norm.b"], eps)


def padding(x, k: int):
    """``_padding`` on ``x [B, L, D]``: the gap to the grid, then K/2 zeros
    at each end."""
    b, length, d = x.shape
    p = k // 2
    gap = k - (p + length % k) % k
    if gap > 0:
        x = torch.cat([x, x.new_zeros(b, gap, d)], dim=1)
    pad = x.new_zeros(b, p, d)
    return torch.cat([pad, x, pad], dim=1), gap


def segmentation(x, k: int):
    """``_Segmentation``: ``[B, L, D]`` -> (chunks ``[B, S, K, D]``, gap)."""
    b, _, d = x.shape
    p = k // 2
    x, gap = padding(x, k)
    x1 = x[:, :-p].reshape(b, -1, k, d)
    x2 = x[:, p:].reshape(b, -1, k, d)
    return torch.cat([x1, x2], dim=2).reshape(b, -1, k, d), gap


def over_add(x, gap: int):
    """``_over_add``: chunks ``[B, S, K, D]`` -> ``[B, L, D]``."""
    b, _, k, d = x.shape
    p = k // 2
    x = x.reshape(b, -1, 2 * k, d)
    x1 = x[:, :, :k].reshape(b, -1, d)[:, p:]
    x2 = x[:, :, k:].reshape(b, -1, d)[:, :-p]
    x = x1 + x2
    return x[:, :-gap] if gap > 0 else x


def dual_block(x, w: dict, pre: str, cfg: dict, mm: Products):
    """``Dual_Computation_Block`` (norm "ln", skip around intra, no linear
    after the paths) on the chunks ``x [B, S, K, D]``."""
    b, s, k, d = x.shape
    eps = cfg["group_norm_eps"]
    intra = transformer_block(x.reshape(b * s, k, d), w, pre + "intra.", cfg, mm)
    intra = group_norm(intra.reshape(b, s, k, d), w[pre + "intra_norm.g"],
                       w[pre + "intra_norm.b"], eps)
    intra = intra + x
    inter = transformer_block(intra.transpose(1, 2).reshape(b * k, s, d), w, pre + "inter.",
                              cfg, mm)
    inter = group_norm(inter.reshape(b, k, s, d).transpose(1, 2), w[pre + "inter_norm.g"],
                       w[pre + "inter_norm.b"], eps)
    return inter + intra


def forward(mix: torch.Tensor, w: dict, cfg: dict, mm: Products) -> torch.Tensor:
    """``mix [B, T]`` -> separated ``[B, S, T]``."""
    wd = widths(cfg)
    b, s, d = mix.shape[0], wd["S"], wd["D"]
    mix_w = torch.relu(mm(frames(mix, wd["L"], wd["stride"]), w["front.enc"]))  # [B, nf, N]
    nf = mix_w.shape[1]
    x = group_norm(mix_w, w["masker.norm.g"], w["masker.norm.b"], cfg["group_norm_eps"])
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
    sep_h = mix_w[:, None] * masks.reshape(b, s, nf, -1)  # [B, S, nf, N]
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
    encoder and decoder, the masker's norm and input conv, each layer's
    attention (four projections with biases), feed-forward and two norms,
    each stack's final norm, each block's two GroupNorms, the PReLU, the
    mask conv, the gate and the output conv."""
    wd = widths(cfg)
    n, l, d, f, spk = (wd[x] for x in ("N", "L", "D", "F", "S"))
    layer = 4 * (d * d + d) + (d * f + f) + (f * d + d) + 4 * d
    block = 2 * (wd["layers"] * layer + 2 * d) + 2 * 2 * d
    return (2 * l * n + 2 * n + n * d + wd["repeats"] * block + 1
            + (d * d * spk + d * spk) + 2 * (d * d + d) + d * n)


def forward_flops(cfg: dict, t: int) -> float:
    """The products of the pass over one mixture of ``t`` samples, at the
    published segmentation of its own length (S·K positions; attention over
    K in a chunk and over S chunks): the encoder, the input conv, each
    layer's four projections, two attention products and feed-forward, the
    mask conv on the chunks, the gate, the output conv and the decoder."""
    wd = widths(cfg)
    n, l, d, f, k, spk = (wd[x] for x in ("N", "L", "D", "F", "K", "S"))
    nf = flops.stft_frames(t, l, wd["stride"])
    s = 2 * ((k // 2 + nf) // k + 1)
    pos = s * k
    dense = 2.0 * pos * (4 * d * d + 2 * d * f)
    intra = dense + 2.0 * 2.0 * s * k * k * d
    inter = dense + 2.0 * 2.0 * k * s * s * d
    ops = 2.0 * nf * l * n + 2.0 * nf * n * d
    ops += wd["repeats"] * wd["layers"] * (intra + inter)
    ops += 2.0 * pos * d * d * spk + spk * (2.0 * 2.0 * nf * d * d + 2.0 * nf * d * n)
    ops += 2.0 * spk * nf * n * l
    return ops
