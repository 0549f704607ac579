"""Plain deep clustering (Hershey et al. 2016) as the configuration states
it, for one unpadded mixture: STFT, log magnitudes normalised over the
utterance, a two-layer BLSTM as an explicit loop, the tanh embedding head of
unit norm, voice-activity weights, weighted k-means with farthest-point
seeding, distance-softmax masks and the inverse STFT; and the training loss,
the weighted affinity mismatch against the ideal binary mask.

The weights come by the port's parameter names (``blstm.lstm.weight_ih_l0``,
``proj.weight``, ...), in ``nn.LSTM``'s gate order i, f, g, o.

``judge`` scores a separation that some other program produced.  The
k-means seeding of the configuration picks the first seed by the largest
weighted squared norm, and every embedding has norm 1, so that choice is a
tie that rounding breaks: two correct programs may end in different
clusterings.  So the judge leaves that choice, and only it, to the program:
it reads the partition off the program's waveforms, then forms that
partition's voice-weighted centroids over the reference's own embeddings and
the reference's masks at the configured tau from them.
"""

from __future__ import annotations

import torch

from bm import flops
from reference.dsp import Products, cola, dft_bases, frames, overlap_add

_EPS_MAG = 1e-7


def stft(mix: torch.Tensor, win: int, hop: int, mm: Products):
    """(re, im) ``[nf, F]`` of a mixture ``[T]``."""
    analysis, _ = dft_bases(win, mix.device)
    out = mm(frames(mix, win, hop), analysis)
    f = win // 2 + 1
    return out[:, :f], out[:, f:]


def _lstm_direction(x, w_ih, w_hh, bias, hidden, mm: Products):
    xproj = mm.linear(x, w_ih, bias)
    h = x.new_zeros(hidden)
    c = x.new_zeros(hidden)
    outs = []
    for t in range(x.shape[0]):
        g = xproj[t] + mm(h[None], w_hh.t())[0]
        i = torch.sigmoid(g[:hidden])
        f = torch.sigmoid(g[hidden:2 * hidden])
        gg = torch.tanh(g[2 * hidden:3 * hidden])
        o = torch.sigmoid(g[3 * hidden:])
        c = f * c + i * gg
        h = o * torch.tanh(c)
        outs.append(h)
    return torch.stack(outs)


def blstm(x: torch.Tensor, weights: dict, layers: int, hidden: int, mm: Products) -> torch.Tensor:
    """``[T, In]`` -> ``[T, 2·hidden]``: per layer a forward pass and a pass
    over the reversed sequence, concatenated."""
    h = x
    for layer in range(layers):
        outs = []
        for sfx in ("", "_reverse"):
            key = f"_l{layer}{sfx}"
            w_ih = weights["blstm.lstm.weight_ih" + key]
            w_hh = weights["blstm.lstm.weight_hh" + key]
            bias = weights["blstm.lstm.bias_ih" + key] + weights["blstm.lstm.bias_hh" + key]
            inp = h if not sfx else torch.flip(h, dims=(0,))
            out = _lstm_direction(inp, w_ih, w_hh, bias, hidden, mm)
            outs.append(out if not sfx else torch.flip(out, dims=(0,)))
        h = torch.cat(outs, dim=-1)
    return h


def embed(mix: torch.Tensor, weights: dict, cfg: dict, mm: Products) -> dict:
    """The analysis of one mixture: re, im, magnitudes ``[nf, F]`` and the
    unit embeddings ``[nf, F, E]``."""
    win, hop = cfg["stft_window"], cfg["stft_hop"]
    re, im = stft(mix, win, hop, mm)
    mag = torch.sqrt(re * re + im * im + _EPS_MAG * _EPS_MAG)
    feats = torch.log(mag + _EPS_MAG)
    mu = feats.mean()
    var = ((feats - mu) ** 2).mean()
    x = (feats - mu) / torch.sqrt(var + 1e-5)
    h = blstm(x, weights, cfg["blstm_layers"], cfg["blstm_hidden_dim"], mm)
    f, e = cfg["freq_bins"], cfg["embedding_dim"]
    v = torch.tanh(mm.linear(h, weights["proj.weight"], weights["proj.bias"]))
    v = v.reshape(-1, f, e)
    v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-8)
    return {"re": re, "im": im, "mag": mag, "v": v}


def vad(mag: torch.Tensor, threshold_db: float) -> torch.Tensor:
    logmag = 20.0 * torch.log10(mag + _EPS_MAG)
    return (logmag > logmag.max() - threshold_db).to(mag.dtype)


def _sq_dist(x, c, mm: Products):
    xx = (x * x).sum(-1, keepdim=True)
    cc = (c * c).sum(-1)[None]
    return torch.clamp(xx - 2.0 * mm(x, c.t()) + cc, min=0.0)


def kmeans(x: torch.Tensor, w: torch.Tensor, k: int, iters: int, mm: Products) -> torch.Tensor:
    """Weighted Lloyd k-means over ``x [N, E]`` from farthest-point seeds
    (the first maximum wins; an empty cluster keeps its centroid) ->
    centroids ``[K, E]``."""
    cents = [x[torch.argmax(w * (x * x).sum(-1))]]
    for _ in range(1, k):
        d = _sq_dist(x, torch.stack(cents), mm).min(dim=-1).values * w
        cents.append(x[torch.argmax(d)])
    c = torch.stack(cents)
    for _ in range(iters):
        assign = torch.argmin(_sq_dist(x, c, mm), dim=-1)
        onehot = (assign[:, None] == torch.arange(k, device=x.device)).to(x.dtype) * w[:, None]
        counts = onehot.sum(0)
        new_c = mm(onehot.t(), x) / torch.clamp(counts[:, None], min=1e-8)
        c = torch.where(counts[:, None] > 1e-8, new_c, c)
    return c


def separate(mix: torch.Tensor, weights: dict, cfg: dict, mm: Products) -> torch.Tensor:
    """The whole serving pass on one mixture ``[T]`` -> ``[S, T]``."""
    a = embed(mix, weights, cfg, mm)
    s, e = cfg["speakers"], cfg["embedding_dim"]
    x = a["v"].reshape(-1, e)
    w = vad(a["mag"], cfg["port"]["vad_threshold_db"]).reshape(-1)
    c = kmeans(x, w, s, cfg["separate"]["kmeans_iters"], mm)
    d = _sq_dist(x, c, mm)
    masks = torch.softmax(-d / (cfg["separate"]["tau"] * (d.mean() + 1e-8)), dim=-1)
    masks = masks.reshape(*a["mag"].shape, s).permute(2, 0, 1)  # [S, nf, F]
    return synthesize(a["re"], a["im"], masks, cfg, mix.shape[-1], mm)


def synthesize(re, im, masks, cfg: dict, length: int, mm: Products) -> torch.Tensor:
    """Masked spectra ``masks [S, nf, F]`` of (re, im) back to ``[S, length]``
    through the inverse STFT and the clamped COLA normaliser."""
    win, hop = cfg["stft_window"], cfg["stft_hop"]
    _, synthesis = dft_bases(win, re.device)
    ri = torch.cat([masks * re, masks * im], dim=-1)
    y = overlap_add(mm(ri, synthesis.to(ri.dtype)), hop, length)
    return y / cola(win, hop, re.shape[0], length, re.device).to(ri.dtype)


def _fit_partition(a: dict, target: torch.Tensor, cfg: dict, length: int,
                   iters: int) -> tuple[torch.Tensor, float]:
    """(theta ``[E + 1]``, its error): the hyperplane (mask 1 = sigmoid(v·a +
    b)) whose two soft masks come closest to the program's waveforms
    ``target [2, keep]``, by Levenberg-Marquardt steps in float64 from the
    reference's own clustering in both speaker orders, the better end kept;
    the error is ||y_fit - target|| / ||target||."""
    nf, f = a["mag"].shape
    e = cfg["embedding_dim"]
    keep = target.shape[-1]
    v = a["v"].double()
    re, im = a["re"].double(), a["im"].double()
    feats = torch.cat([v, torch.ones(nf, f, 1, dtype=v.dtype, device=v.device)], dim=-1)

    def wave(m1: torch.Tensor) -> torch.Tensor:  # mask 1 [.., nf, F] -> speaker 1 [.., keep]
        return synthesize(re, im, m1, cfg, length, Products())[..., :keep]

    w = vad(a["mag"], cfg["port"]["vad_threshold_db"]).reshape(-1)
    c = kmeans(a["v"].reshape(-1, e), w, 2, cfg["separate"]["kmeans_iters"], Products()).double()
    d = _sq_dist(v.reshape(-1, e), c, Products())
    scale = cfg["separate"]["tau"] * (d.mean() + 1e-8)
    theta0 = torch.cat([2.0 * (c[0] - c[1]), (c[1] * c[1]).sum()[None] - (c[0] * c[0]).sum()])
    theta0 = theta0 / scale
    full = wave(torch.ones_like(re))  # both speakers' sum

    def residual(theta):
        y1 = wave(torch.sigmoid(feats @ theta))
        return torch.cat([y1 - target[0], (full - y1) - target[1]])

    best, best_norm = None, None
    for start in (theta0, -theta0):
        theta = start.clone()
        lam = 1e-3
        r = residual(theta)
        for _ in range(iters):
            sig = torch.sigmoid(feats @ theta)
            dm = (sig * (1 - sig))[..., None] * feats  # [nf, F, E + 1]
            j1 = wave(dm.permute(2, 0, 1))  # [E + 1, keep]
            jac = torch.cat([j1, -j1], dim=1).t()  # [2·keep, E + 1]
            jtj = jac.t() @ jac
            g = jac.t() @ r
            while True:
                step = torch.linalg.solve(jtj + lam * torch.diag(torch.diagonal(jtj)), -g)
                r_new = residual(theta + step)
                if float(r_new.norm()) <= float(r.norm()):
                    theta, r, lam = theta + step, r_new, max(lam * 0.3, 1e-9)
                    break
                lam *= 10.0
                if lam > 1e8:
                    break
            if lam > 1e8:
                break
        if best is None or float(r.norm()) < best_norm:
            best, best_norm = theta, float(r.norm())
    scale = float(target.norm())
    return best, best_norm / scale if scale > 0 else float("inf")


def judge(mix: torch.Tensor, est: torch.Tensor, weights: dict, cfg: dict,
          padded_lengths=(), iters: int = 30) -> dict:
    """Two numbers of a program's separation ``est [2, T]`` of ``mix [T]``,
    each ||y - est|| / ||est|| over the samples that only the utterance's own
    frames cover:

    * ``serve.fit_error``: y is the closest that any partition's soft masks
      come (``_fit_partition``), so it reads the front, the norm, the BLSTM,
      the head, the masks' form and the synthesis, and not the clustering;
    * ``serve.cluster_error``: y is the reference's soft masks at the
      configured tau around the voice-weighted centroids of the partition the
      fit read, the centroids a Lloyd iteration forms from it, so it reads
      the clustering too: its weights, its iterations (the program's last
      iteration leaves centroids one step from these, which is what a sound
      program reads), the masks' distances and tau.

    The masks' distance scale is the mean distance over the utterance's
    points, as the configuration states it; where the program ran the
    mixture padded to one of ``padded_lengths`` (samples), the mean over the
    padded row's points is tried too, a padded frame's trunk output being 0
    and so its embedding the head's of 0.  The smaller error counts."""
    a = embed(mix, weights, cfg, Products())
    nf, f = a["mag"].shape
    e, s, hop, win = cfg["embedding_dim"], cfg["speakers"], cfg["stft_hop"], cfg["stft_window"]
    if s != 2:
        raise ValueError("the judge reads a partition in two")
    length = mix.shape[-1]
    keep = nf * hop
    target = est[:, :keep].double()
    theta, fit_error = _fit_partition(a, target, cfg, length, iters)
    if not fit_error < float("inf"):
        return {"serve.fit_error": fit_error, "serve.cluster_error": float("inf")}

    x = a["v"].reshape(-1, e).double()
    w = vad(a["mag"], cfg["port"]["vad_threshold_db"]).reshape(-1).double()
    ones = torch.ones(x.shape[0], 1, dtype=x.dtype, device=x.device)
    first = (torch.cat([x, ones], dim=-1) @ theta) > 0
    member = torch.stack([first, ~first], dim=-1).double() * w[:, None]  # [N, 2]
    counts = member.sum(0)
    if bool((counts <= 0).any()):
        return {"serve.fit_error": fit_error, "serve.cluster_error": float("inf")}
    c = (member.t() @ x) / counts[:, None]
    d = _sq_dist(x, c, Products())
    scales = [d.mean()]
    pad_v = torch.tanh(weights["proj.bias"].double()).reshape(f, e)
    pad_v = pad_v / (torch.linalg.vector_norm(pad_v, dim=-1, keepdim=True) + 1e-8)
    d_pad = _sq_dist(pad_v, c, Products()).sum()  # one padded frame's distances
    for p in sorted({int(t) for t in padded_lengths}):
        pf = flops.stft_frames(p, win, hop)
        if pf > nf:
            scales.append((d.sum() + (pf - nf) * d_pad) / (pf * f * s))
    re, im = a["re"].double(), a["im"].double()
    cluster_error = float("inf")
    for scale in scales:
        masks = torch.softmax(-d / (cfg["separate"]["tau"] * (scale + 1e-8)), dim=-1)
        y = synthesize(re, im, masks.t().reshape(s, nf, f), cfg, length, Products())
        cluster_error = min(cluster_error,
                            float((y[:, :keep] - target).norm() / target.norm()))
    return {"serve.fit_error": fit_error, "serve.cluster_error": cluster_error}


def loss(sources: torch.Tensor, weights: dict, cfg: dict, mm: Products) -> torch.Tensor:
    """The training loss of the mixture of ``sources [B, S, T]``: per row
    the weighted ||VVᵀ - YYᵀ||²_F over (Σw)², Y the ideal binary mask (the
    loudest source of each bin, the first of equals), w the voice-activity
    weights; the mean over the rows."""
    out = []
    for src in sources:
        a = embed(src.sum(0), weights, cfg, mm)
        mags = []
        for one in src:
            re, im = stft(one, cfg["stft_window"], cfg["stft_hop"], mm)
            mags.append(torch.sqrt(re * re + im * im + _EPS_MAG * _EPS_MAG))
        dom = torch.argmax(torch.stack(mags), dim=0)
        y = (dom[..., None] == torch.arange(src.shape[0], device=src.device)).to(src.dtype)
        w = vad(a["mag"], cfg["port"]["vad_threshold_db"])
        sw = torch.sqrt(w)[..., None]
        v = (a["v"] * sw).reshape(-1, cfg["embedding_dim"])
        y = (y * sw).reshape(-1, src.shape[0])
        per = ((mm(v.t(), v) ** 2).sum() - 2.0 * (mm(v.t(), y) ** 2).sum()
               + (mm(y.t(), y) ** 2).sum())
        out.append(per / torch.clamp(w.sum(), min=1.0) ** 2)
    return torch.stack(out).mean()


def forward_flops(cfg: dict, t: int) -> float:
    """The serving pass over one mixture of ``t`` samples: STFT (B1), the
    BLSTM, the embedding head, k-means, the soft masks' distances and the
    synthesis (B2)."""
    win, hop, f = cfg["stft_window"], cfg["stft_hop"], cfg["freq_bins"]
    h, e, s = cfg["blstm_hidden_dim"], cfg["embedding_dim"], cfg["speakers"]
    nf = flops.stft_frames(t, win, hop)
    ops = 2.0 * nf * win * 2 * f
    n_in = f
    for _ in range(cfg["blstm_layers"]):
        ops += 2 * flops.lstm_flops(nf, n_in, h)
        n_in = 2 * h
    ops += 2.0 * nf * n_in * f * e
    ops += flops.kmeans_flops(nf * f, e, s, cfg["kmeans_iters"]) + 2.0 * nf * f * e * s
    ops += 2.0 * s * nf * 2 * f * win
    return ops
