"""Plain Conv-TasNet (Luo and Mesgarani 2019) as the configuration states it,
with the port's departures that the configuration lists: a learned encoder
taking |conv| (the sign kept for synthesis), a 4-tap causal smoothing and a
log before a per-utterance norm, R·X blocks of 1x1 conv, PReLU, per-frame
layer norm, a non-causal dilated depthwise conv, PReLU, layer norm and 1x1
residual and skip convs, sigmoid masks, and the learned decoder.

Rows of a batch are mixtures of one length with no padding.  Everything is
differentiable, for the training reference.  The weights come by the port's
parameter names.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from bm import flops
from reference.dsp import Products, frames, overlap_add


def prelu(alpha, x):
    return torch.where(x >= 0, x, alpha * x)


def layer_norm(x, g, b, eps: float = 1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * g + b


def depthwise(w: torch.Tensor, x: torch.Tensor, dilation: int) -> torch.Tensor:
    """``w [P, C]`` over ``x [B, T, C]``, zero-padded P//2·d on the left and
    the rest on the right: P shifted, scaled adds."""
    p, t = w.shape[0], x.shape[1]
    left, right = (p // 2) * dilation, (p - 1 - p // 2) * dilation
    xp = F.pad(x, (0, 0, left, right))
    out = w[0] * xp[:, :t]
    for i in range(1, p):
        out = out + w[i] * xp[:, i * dilation:i * dilation + t]
    return out


def forward(mix: torch.Tensor, wts: dict, cfg: dict, mm: Products) -> torch.Tensor:
    """``mix [B, T]`` -> separated ``[B, S, T]``."""
    n_len, stride, s = cfg["L"], cfg["stride"], cfg["speakers"]
    z = mm(frames(mix, n_len, stride), wts["front.enc"])  # [B, nf, N]
    codes, sign = torch.abs(z), torch.sign(z)
    k = wts["front.smooth"][:, 0]
    t = codes.shape[1]
    padded = F.pad(codes, (0, 0, k.shape[0] - 1, 0))
    sm = sum(k[i] * padded[:, i:i + t] for i in range(k.shape[0]))
    feats = torch.log(torch.clamp(sm, min=0.0) + 1e-7)
    mu = feats.mean(dim=(1, 2), keepdim=True)
    var = ((feats - mu) ** 2).mean(dim=(1, 2), keepdim=True)
    x = (feats - mu) / torch.sqrt(var + 1e-5)

    h = mm.linear(x, wts["tcn.in_proj.weight"], wts["tcn.in_proj.bias"])
    skip_sum = torch.zeros_like(h)
    for i in range(cfg["R"] * cfg["X"]):
        p = f"tcn.blocks.{i}."
        u = prelu(wts[p + "a1"], mm.linear(h, wts[p + "pw_in.weight"], wts[p + "pw_in.bias"]))
        u = layer_norm(u, wts[p + "ln1.g"], wts[p + "ln1.b"])
        v = depthwise(wts[p + "dw"], u, 2 ** (i % cfg["X"]))
        v = layer_norm(prelu(wts[p + "a2"], v), wts[p + "ln2.g"], wts[p + "ln2.b"])
        h = h + mm.linear(v, wts[p + "pw_res.weight"], wts[p + "pw_res.bias"])
        skip_sum = skip_sum + mm.linear(v, wts[p + "pw_skip.weight"], wts[p + "pw_skip.bias"])
    out = prelu(wts["tcn.out_alpha"], skip_sum)
    m = mm.linear(out, wts["proj_mask.weight"], wts["proj_mask.bias"])
    masks = torch.sigmoid(m.reshape(*codes.shape, s))  # [B, nf, N, S]
    masked = torch.movedim(codes[..., None] * masks, -1, 1) * sign[:, None]  # [B, S, nf, N]
    y = overlap_add(mm(masked, wts["front.dec"]), stride, mix.shape[-1])
    return y


def separate(mix: torch.Tensor, wts: dict, cfg: dict, mm: Products) -> torch.Tensor:
    """The serving pass on one mixture ``[T]`` -> ``[S, T]``."""
    return forward(mix[None], wts, cfg, mm)[0]


def si_sdr(est, ref, eps: float = 1e-8):
    est = est - est.mean(-1, keepdim=True)
    ref = ref - ref.mean(-1, keepdim=True)
    proj = (est * ref).sum(-1, keepdim=True) / ((ref * ref).sum(-1, keepdim=True) + eps) * ref
    noise = est - proj
    ratio = (proj * proj).sum(-1) / ((noise * noise).sum(-1) + eps)
    return 10.0 * torch.log10(ratio + eps)


def pit_si_sdr(est, ref):
    """Best mean SI-SDR over the speaker orders, ``[B, S, T]`` -> ``[B]``."""
    s = est.shape[1]
    scores = [si_sdr(est[:, list(p)], ref).mean(-1) for p in itertools.permutations(range(s))]
    return torch.stack(scores, -1).max(-1).values


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
    with torch.no_grad():
        ref = separate(mix, wts, cfg, Products())
    keep = flops.stft_frames(mix.shape[-1], cfg["L"], cfg["stride"]) * cfg["stride"]
    return {"serve.judged_error":
            float((ref[:, :keep] - est[:, :keep]).norm() / ref[:, :keep].norm())}


def forward_flops(cfg: dict, t: int) -> float:
    """The pass over one mixture of ``t`` samples: the encoder, the input
    projection, R·X blocks (1x1 in, depthwise, 1x1 residual and skip), the
    mask head and the decoder."""
    n, l, stride, b, h, p = (cfg[k] for k in ("N", "L", "stride", "B", "H", "P"))
    s = cfg["speakers"]
    nf = flops.stft_frames(t, l, stride)
    ops = 2.0 * nf * l * n + 2.0 * nf * n * b
    block = 2.0 * nf * (b * h + h * p + h * b + h * cfg["Sc"])
    ops += cfg["R"] * cfg["X"] * block
    ops += 2.0 * nf * b * n * s + 2.0 * s * nf * n * l
    return ops
