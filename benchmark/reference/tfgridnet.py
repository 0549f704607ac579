"""Plain TF-GridNet (Wang, Cornell, Choi, Lee, Kim, Watanabe, "TF-GridNet:
Integrating Full- and Sub-Band Modeling for Speech Separation", IEEE/ACM
TASLP 2023, arXiv:2211.12433) as ESPnet's ``espnet2/enh/separator/
tfgridnet_separator.py::TFGridNet`` computes it, step for step on one
unpadded mixture ``x [T]``, in ESPnet's layout ``[C, T', F]``:

1. σ = std(x[:C]) with correction 1 (``torch.std``), C = (V - 1)·hop + win
   the samples the V frames cover; x̃ = x / σ (x itself where σ is 0).
2. X = STFT(x̃) ``[V, F]``: periodic Hann, frames of ``win`` at ``hop``
   (``reference/dsp.py``), F = win/2 + 1.
3. Z₀ = gLN(Conv2d_{2→D, 3×3, pad 1}([Re X; Im X])) ``[D, V, F]``, gLN
   ``nn.GroupNorm(1, D)``: the statistics over all of Z, biased variance.
4. B blocks (``GridNetBlock``), each:

   * intra: U = LN4D(Z) (statistics over the channels of each T-F unit);
     for each frame, ``F.unfold`` of ``[D, F, 1]`` by (I, 1) at hop 1,
     channel-major, gives ``[F - I + 1, D·I]``; the BLSTM (H cells a
     direction, gates (i, f, g, o), bias b_ih + b_hh, an explicit cell
     loop); ConvTranspose1d 2H → D, I taps, stride 1, back to ``[D, F]``;
     Z' = that + Z;
   * inter: the same over the V frames of each bin on LN4D(Z'), V - I + 1
     steps (none where V < I: the transposed conv's bias alone), Z'';
   * attention, for each head l of L: Q_l = LN4DCF(PReLU(Conv1x1_{D→E}
     (Z''))), K_l alike with its own weights, V_l = LN4DCF(PReLU(Conv1x1
     _{D→D/L}(Z''))), LN4DCF taking the statistics over the channels and
     bins of each frame, its gain and bias ``[C, F]``; each flattened a frame
     with the channel axis outer (q_l[t] of E·F values); A_l = softmax over
     the keys of q_l k_lᵀ / √(E·F); O_l = A_l v_l; the heads concatenated in
     head order along the channels; Z = LN4DCF(PReLU(Conv1x1_{D→D}(O))) + Z''.

5. Y = ConvTranspose2d_{D→2S, 3×3, pad 1}(Z) read as ``[S, 2, V, F]``;
   Ŝ_s = Y[s, 0] + i·Y[s, 1]; y_s = iSTFT(Ŝ_s)·σ of length T: the
   overlap-add of the frames' inverse DFT, divided by the frames'
   overlap-added squared window clamped at 1e-2 of its peak.

Every PReLU has one slope; every eps is the configuration's (1e-5).  The 3×3
convolutions are ``F.unfold`` patches times the weights, the transposed one
the convolution with the kernel flipped and its axes swapped; the transposed
1-D conv a product a tap and the taps' shifted sums.  Every product, the
recurrent ones included, goes through ``Products``, so the control rounds
them all.

Departures from ESPnet, which the configuration lists too: the STFT has no
centred, reflect-padded frames (the port's front), so σ is taken over the
samples the frames cover (all of them where hop divides T - win, as at 6.0 s
and 8 kHz); the iSTFT's normaliser is clamped; the weights are random from
the seed.  Widths come from the configuration's ``port`` entry (D =
``sep.embed_dim``, I = ``sep.kernel``, H = ``sep.hidden``, ``sep.layers``
BLSTM layers a path, L = ``sep.heads``, E = ``sep.expansion``, B =
``sep.blocks``, the front's ``win`` and ``hop``), the eps from its top level;
the weights by the port's parameter names in its layouts (an ``nn.LSTM``'s,
an ``nn.Linear``'s ``[out, in]`` for a 1x1 conv, a ConvTranspose1d's ``[2H,
D, I]``).  Everything is differentiable, for a training reference.  Nothing
here imports the port or JAX.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bm import flops
from reference.dprnn import blstm
from reference.dsp import Products, cola, dft_bases, frames, overlap_add
from reference.tasnet import pit_si_sdr, prelu


def widths(cfg: dict) -> dict:
    """The widths the model runs at, from the configuration's ``port``
    entry."""
    p = cfg["port"]
    f, s = p["front"], p["sep"]
    return {"win": f["win"], "hop": f["hop"], "F": f["win"] // 2 + 1, "D": s["embed_dim"],
            "I": s["kernel"], "H": s["hidden"], "layers": s["layers"], "L": s["heads"],
            "E": s["expansion"], "B": s["blocks"], "S": p["nb_speakers"]}


def conv2d(x, w, b, mm: Products):
    """A 3×3 convolution, padding 1, of ``x [C, T, F]`` by ``w [O, C, 3,
    3]`` -> ``[O, T, F]``."""
    _, t, f = x.shape
    patches = F.unfold(x[None], (3, 3), padding=1)[0]  # [C·9, T·F]
    y = mm(patches.t(), w.reshape(w.shape[0], -1).t()) + b  # [T·F, O]
    return y.t().reshape(-1, t, f)


def conv_transpose2d(x, w, b, mm: Products):
    """A 3×3 transposed convolution, stride 1, padding 1, of ``x [C, T, F]``
    by ``w [C, O, 3, 3]``: the convolution by the flipped kernel."""
    return conv2d(x, w.transpose(0, 1).flip(2, 3), b, mm)


def conv_transpose1d(h, w, b, length: int, mm: Products):
    """ConvTranspose1d (stride 1) of ``h [R, S, 2H]`` by ``w [2H, D, I]`` ->
    ``[R, length, D]``, length = S + I - 1 (the bias alone where S = 0)."""
    r, s = h.shape[0], h.shape[1]
    out = b.expand(r, length, b.shape[0]).clone()
    for k in range(w.shape[2]):
        if s:
            out[:, k:k + s] = out[:, k:k + s] + mm(h, w[:, :, k])
    return out


def ln4d(x, g, b, eps):
    """Statistics over the channels of each T-F unit of ``x [C, T, F]``."""
    mu = x.mean(0, keepdim=True)
    var = ((x - mu) ** 2).mean(0, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * g[:, None, None] + b[:, None, None]


def ln4dcf(x, g, b, eps):
    """Statistics over the channels and bins of each frame of ``x [C, T,
    F]``; gain and bias ``[C, F]``."""
    mu = x.mean((0, 2), keepdim=True)
    var = ((x - mu) ** 2).mean((0, 2), keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * g[:, None, :] + b[:, None, :]


def group_norm(x, g, b, eps):
    """``nn.GroupNorm(1, C)`` of ``x [C, T, F]``."""
    mu = x.mean()
    var = ((x - mu) ** 2).mean()
    return (x - mu) / torch.sqrt(var + eps) * g[:, None, None] + b[:, None, None]


def path(z, w: dict, pre: str, over_freq: bool, wd: dict, eps: float, mm: Products):
    """One intra (``over_freq``) or inter path over ``z [D, T, F]`` ->
    ``[D, T, F]``, its residual included."""
    u = ln4d(z, w[pre + "norm.g"], w[pre + "norm.b"], eps)
    seqs = u.permute(1, 0, 2) if over_freq else u.permute(2, 0, 1)  # [rows, D, n]
    n, k = seqs.shape[-1], wd["I"]
    if n >= k:
        x = F.unfold(seqs[..., None], (k, 1)).transpose(1, 2)  # [rows, n - k + 1, D·I]
        h = blstm(x, w, pre + "rnn.lstm.", wd["layers"], mm)
    else:
        h = seqs.new_zeros(seqs.shape[0], 0, 2 * wd["H"])
    y = conv_transpose1d(h, w[pre + "linear.weight"], w[pre + "linear.bias"], n, mm)
    y = y.permute(2, 0, 1) if over_freq else y.permute(2, 1, 0)  # [D, T, F]
    return y + z


def attn_conv(z, w: dict, pre: str, eps: float, mm: Products):
    """ESPnet's ``attn_conv_*`` on ``z [D, T, F]``: a 1x1 conv, a PReLU and
    an LN4DCF -> ``[C, T, F]``."""
    y = mm.linear(z.permute(1, 2, 0), w[pre + "conv.weight"], w[pre + "conv.bias"])
    y = prelu(w[pre + "prelu"], y.permute(2, 0, 1))
    return ln4dcf(y, w[pre + "norm.g"], w[pre + "norm.b"], eps)


def attention(z, w: dict, pre: str, wd: dict, eps: float, mm: Products):
    """The full-band self-attention over the frames of ``z [D, T, F]``, its
    residual included."""
    _, t, f = z.shape
    outs = []
    for head in range(wd["L"]):
        q, k, v = (attn_conv(z, w, f"{pre}attn_{x}.{head}.", eps, mm) for x in "qkv")
        q, k = (a.transpose(0, 1).reshape(t, -1) for a in (q, k))  # [T, E·F], channel outer
        cv = v.shape[0]
        a = torch.softmax(mm(q, k.t()) / math.sqrt(q.shape[-1]), dim=-1)
        o = mm(a, v.transpose(0, 1).reshape(t, -1))  # [T, (D/L)·F]
        outs.append(o.reshape(t, cv, f).transpose(0, 1))
    return attn_conv(torch.cat(outs, dim=0), w, pre + "attn_proj.", eps, mm) + z


def sigma(mix: torch.Tensor, cfg: dict) -> torch.Tensor:
    """σ of step 1: the standard deviation (correction 1) of the samples the
    frames cover; 0 where there are fewer than two."""
    wd = widths(cfg)
    v = flops.stft_frames(mix.shape[-1], wd["win"], wd["hop"])
    c = (v - 1) * wd["hop"] + wd["win"] if v else 0
    return torch.std(mix[:c]) if c > 1 else mix.new_zeros(())


def separate(mix: torch.Tensor, w: dict, cfg: dict, mm: Products) -> torch.Tensor:
    """The serving pass on one mixture ``[T]`` -> ``[S, T]``."""
    wd = widths(cfg)
    t, f, s = mix.shape[-1], wd["F"], wd["S"]
    v = flops.stft_frames(t, wd["win"], wd["hop"])
    if v == 0:
        return mix.new_zeros(s, t)
    eps = cfg["eps"]
    sd = sigma(mix, cfg)
    x = mix / sd if float(sd) > 0 else mix
    analysis, synthesis = dft_bases(wd["win"], mix.device)
    spec = mm(frames(x, wd["win"], wd["hop"]), analysis)  # [V, 2F]
    z = conv2d(spec.reshape(v, 2, f).transpose(0, 1), w["conv.weight"], w["conv.bias"], mm)
    z = group_norm(z, w["norm.g"], w["norm.b"], eps)
    for i in range(wd["B"]):
        pre = f"blocks.{i}."
        z = path(z, w, pre + "intra.", True, wd, eps, mm)
        z = path(z, w, pre + "inter.", False, wd, eps, mm)
        z = attention(z, w, pre, wd, eps, mm)
    y = conv_transpose2d(z, w["deconv.weight"], w["deconv.bias"], mm).reshape(s, 2, v, f)
    ri = torch.cat([y[:, 0], y[:, 1]], dim=-1)  # [S, V, 2F]
    out = overlap_add(mm(ri, synthesis), wd["hop"], t) / cola(wd["win"], wd["hop"], v, t,
                                                             mix.device)
    return out * sd


def forward(mix: torch.Tensor, w: dict, cfg: dict, mm: Products) -> torch.Tensor:
    """``mix [B, T]`` -> ``[B, S, T]``, a row at a time."""
    return torch.stack([separate(m, w, cfg, mm) for m in mix])


def loss(sources: torch.Tensor, wts: dict, cfg: dict, mm: Products) -> torch.Tensor:
    """Negative mean PIT SI-SDR of the separation of the sum of ``sources
    [B, S, T]``."""
    est = forward(sources.sum(dim=1), wts, cfg, mm)
    return -pit_si_sdr(est, sources).mean()


def judge(mix: torch.Tensor, est: torch.Tensor, wts: dict, cfg: dict,
          padded_lengths=()) -> dict:
    """``serve.judged_error``: ||y_ref - est|| / ||y_ref|| of a program's
    separation ``est [S, T]`` of ``mix [T]``, over every sample: a padded
    row's answer is its unpadded one (the padding contract), to its last
    sample."""
    with torch.no_grad():
        ref = separate(mix, wts, cfg, Products())
    return {"serve.judged_error": float((ref - est).norm() / ref.norm())}


def parameters(cfg: dict) -> int:
    """The model's parameter count at the configuration's widths: the input
    conv and its gLN; in each block two paths (LN4D, the BLSTM with both
    biases a direction and layer, as ``nn.LSTM`` holds them, and the
    transposed conv) and the attention (for each head the Q and K convs D ->
    E and the V conv D -> D/L, each with a bias, a slope and an LN4DCF of
    ``[C, F]``, then the projection D -> D with its own); the output
    transposed conv."""
    wd = widths(cfg)
    d, k, h, f, heads, e, spk = (wd[x] for x in ("D", "I", "H", "F", "L", "E", "S"))
    lstm = sum(2 * (4 * h * (d * k if i == 0 else 2 * h) + 4 * h * h + 8 * h)
               for i in range(wd["layers"]))
    path_ = 2 * d + lstm + 2 * h * d * k + d

    def conv(c):
        return d * c + c + 1 + 2 * c * f

    attn = heads * (2 * conv(e) + conv(d // heads)) + conv(d)
    return (2 * d * 9 + d + 2 * d) + wd["B"] * (2 * path_ + attn) + (d * 2 * spk * 9 + 2 * spk)


def forward_flops(cfg: dict, t: int) -> float:
    """The products of the pass over one mixture of ``t`` samples (V frames):
    the STFT, the input conv, each block's two paths (``bm/flops.py::
    lstm_flops`` a direction over the valid steps, the transposed conv's
    2H·D products a tap and step), the attention's 1x1 convs and its two
    products a head, the output transposed conv and the iSTFT."""
    wd = widths(cfg)
    d, k, h, f, heads, e, spk = (wd[x] for x in ("D", "I", "H", "F", "L", "E", "S"))
    win, v = wd["win"], flops.stft_frames(t, wd["win"], wd["hop"])
    if v == 0:
        return 0.0

    def rnn_path(rows, n):
        steps = max(n - k + 1, 0) * rows
        lstm = sum(2.0 * flops.lstm_flops(steps, d * k if i == 0 else 2 * h, h)
                   for i in range(wd["layers"]))
        return lstm + 2.0 * steps * 2 * h * d * k

    units = v * f
    attn = (heads * 2.0 * units * d * (2 * e + d // heads)
            + heads * 2.0 * v * v * f * (e + d // heads) + 2.0 * units * d * d)
    block = rnn_path(v, f) + rnn_path(f, v) + attn
    ops = 2.0 * v * win * 2 * (win // 2 + 1) + 2.0 * units * 2 * 9 * d
    ops += wd["B"] * block + 2.0 * units * d * 9 * 2 * spk + 2.0 * spk * v * 2 * f * win
    return ops
