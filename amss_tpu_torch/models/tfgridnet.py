"""TF-GridNet (Z.-Q. Wang, S. Cornell, S. Choi, Y. Lee, B.-Y. Kim, S.
Watanabe, "TF-GridNet: Integrating Full- and Sub-Band Modeling for Speech
Separation", IEEE/ACM TASLP 2023, arXiv:2211.12433) as ESPnet builds it
(``espnet2/enh/separator/tfgridnet_separator.py::TFGridNet``), on the port's
STFT front (``models/front.py::STFTFrontEnd``, its ``encode_ri`` and
``decode_ri``).  Kind ``tfgridnet``.

For one mixture x of T samples whose V frames cover its first C = (V - 1)·hop
+ win samples:

    σ   = std(x[:C]), correction 1                      (1 where it is 0)
    X   = STFT(x / σ)                                   [T', F] complex
    Z   = gLN(Conv2d_{2→D, 3×3, pad 1}([Re X; Im X]))    [T', F, D]
    B blocks:
      intra  Z' = Z  + ConvT1d_{2H→D, I}(BLSTM_H(unfold_I over F of LN4D(Z)))    a frame a row
      inter  Z''= Z' + ConvT1d_{2H→D, I}(BLSTM_H(unfold_I over T' of LN4D(Z')))  a bin a row
      attn   Z  = Z'' + LN4DCF(PReLU(W_o · [O_1 .. O_L]))
             O_l = softmax(q_l k_lᵀ / √(E·F)) v_l over the frames of the row,
             q_l = LN4DCF(PReLU(W_q,l Z'')) flattened a frame (E·F), k_l alike,
             v_l = LN4DCF(PReLU(W_v,l Z'')) ((D/L)·F)
    Y   = ConvT2d_{D→2S, 3×3, pad 1}(Z), read as [S, 2, T', F]
    y_s = iSTFT(Y[s, 0] + i·Y[s, 1]) · σ                  [T]

gLN is ``nn.GroupNorm(1, D)`` (statistics over the channels, frames and bins
of the row), LN4D takes them over the channels of each T-F unit and LN4DCF
over the channels and bins of each frame, all with the biased variance and
eps 1e-5; LN4DCF's gain and bias are ``[C, F]``.  The unfold puts I adjacent
bins (or frames) at hop 1 into a step of D·I inputs, channel-major
(``F.unfold``'s order), so a path of n positions runs n - I + 1 steps, and the
transposed conv (I taps, stride 1) gives the n positions back.  Each BLSTM is
``sep.layers`` layers of H cells a direction, gates (i, f, g, o), its bias
b_ih + b_hh.  Every PReLU has one slope.  The model maps to a complex
spectrum, so it has no masks.

The config's fields: ``sep.embed_dim`` is D, ``sep.kernel`` I (its hop J is
1, ESPnet's default, under which ESPnet pads nothing), ``sep.hidden`` H,
``sep.layers`` the layers of each BLSTM, ``sep.heads`` L, ``sep.expansion`` E
(the channels a bin of each head's queries and keys: ESPnet's ⌈
``attn_approx_qk_dim`` / F⌉), ``sep.blocks`` B; the front's ``win`` and
``hop`` the STFT's, F = win/2 + 1; ``sep.remat`` is not read.  The tensors
run as ``[B, T', F, C]``.

The padding contract: each row of a padded batch (``frame_mask``, a prefix
of V_r valid frames) gives what the model gives on that row alone.  σ is
taken over the row's own C_r samples; the spectrum, and Z after the input
conv and after every block, are zero at frames >= V_r, so the 3×3
convolutions and the inter unfold see there what the row alone sees past
its end; gLN takes its statistics over the row's own frames; the intra rows
of frames >= V_r are not run; an inter row runs V_r - I + 1 steps (its
lengths come to the host once a call, ``prefix_lengths``, the
``sync.lengths`` span); the keys of frames >= V_r are masked out of the
softmax (additively, ``models/dptransformer.py`` says why); Y is zero at
frames >= V_r; and the iSTFT's normaliser is that of the row's own frames.

Spans inside ``trunk``: ``tfgridnet.intra`` and ``tfgridnet.inter`` (one path
of one block with its norm, transposed conv and residual; ``rows`` run,
``steps`` = rows × the grid's steps, ``valid_steps``, the BLSTM's
``blstm_path``) and ``tfgridnet.attn`` (one block's attention; ``frames``,
``valid_frames``, ``heads``).  ``front`` holds σ and the STFT, ``head`` the
output transposed conv, ``decode`` the iSTFT.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from amss_tpu_torch.models.base import SeparatorBase
from amss_tpu_torch.models.blstm import BLSTM, prefix_lengths
from amss_tpu_torch.models.dprnn import LayerNorm
from amss_tpu_torch.models.front import _to_device
from amss_tpu_torch.ops.metrics import pit_si_sdr
from amss_tpu_torch.utils.config import ModelConfig
from amss_tpu_torch.utils.profiling import (
    DECODE,
    FRONT,
    HEAD,
    TFGRIDNET_ATTN,
    TFGRIDNET_INTER,
    TFGRIDNET_INTRA,
    span,
)

EPS = 1e-5  # ESPnet's TFGridNet eps: its gLN, LN4D and LN4DCF
_NEG = -1e9  # the additive logit of a padded key


class AttnConv(nn.Module):
    """ESPnet's ``attn_conv_*``: a 1x1 conv D -> ``out`` (``conv``, an
    ``nn.Linear`` over the channels), a PReLU of one slope and an LN4DCF of
    gain and bias ``[out, F]``."""

    def __init__(self, d: int, out: int, freqs: int):
        super().__init__()
        self.conv = nn.Linear(d, out)
        self.prelu = nn.Parameter(torch.full((1,), 0.25))
        self.norm = LayerNorm(out, freqs)


class Path(nn.Module):
    """An intra or inter path: LN4D (``norm``), the BLSTM (``rnn``) and the
    transposed conv 2H -> D of I taps (``linear``)."""

    def __init__(self, d: int, kernel: int, hidden: int, layers: int):
        super().__init__()
        self.norm = LayerNorm(d)
        self.rnn = BLSTM(d * kernel, hidden, layers)
        self.linear = nn.ConvTranspose1d(2 * hidden, d, kernel)


class GridBlock(nn.Module):
    """ESPnet's ``GridNetBlock``: ``intra``, ``inter``, the heads' ``attn_q``,
    ``attn_k``, ``attn_v`` and ``attn_proj``."""

    def __init__(self, d: int, kernel: int, hidden: int, layers: int, heads: int, e: int,
                 freqs: int):
        super().__init__()
        self.intra = Path(d, kernel, hidden, layers)
        self.inter = Path(d, kernel, hidden, layers)
        self.attn_q = nn.ModuleList(AttnConv(d, e, freqs) for _ in range(heads))
        self.attn_k = nn.ModuleList(AttnConv(d, e, freqs) for _ in range(heads))
        self.attn_v = nn.ModuleList(AttnConv(d, d // heads, freqs) for _ in range(heads))
        self.attn_proj = AttnConv(d, d, freqs)


@dataclass(frozen=True)
class OwnFrames:
    """The frames of each row of a padded batch: ``counts`` V_r (int64 on the
    host), ``mask [B, T']`` (float32, 1 = a frame of the row's own) and
    ``flat``, the indices b·T' + t of those frames (int64), both on the
    batch's device."""

    counts: torch.Tensor
    mask: torch.Tensor
    flat: torch.Tensor


def own_frames(frame_mask: torch.Tensor) -> OwnFrames:
    """The own frames of a padded batch's rows: the mask comes to the host
    once (``prefix_lengths``)."""
    counts = prefix_lengths(frame_mask)
    t = frame_mask.shape[1]
    own = torch.arange(t)[None, :] < counts[:, None]
    flat = own.reshape(-1).nonzero().reshape(-1)
    return OwnFrames(counts, frame_mask.to(torch.float32), _to_device(flat, frame_mask.device))


def deconv1d(conv: nn.ConvTranspose1d, y: torch.Tensor) -> torch.Tensor:
    """``conv`` (stride 1, I taps) over the steps of ``y [N, S, 2H]`` ->
    ``[N, S + I - 1, D]``: one product for all the taps, then their shifted
    sums."""
    n_in, d, k = conv.weight.shape
    s = y.shape[1]
    p = torch.matmul(y, conv.weight.permute(0, 2, 1).reshape(n_in, k * d))
    p = p.reshape(y.shape[0], s, k, d)
    out = conv.bias.expand(y.shape[0], s + k - 1, d).clone()
    for tap in range(k):
        out[:, tap:tap + s] += p[:, :, tap]
    return out


def _prelu(x: torch.Tensor, slope: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def _unfold(rows: torch.Tensor, k: int) -> torch.Tensor:
    """``[N, n, C]`` -> ``[N, n - k + 1, C·k]``, channel-major."""
    n, length, c = rows.shape
    return rows.unfold(1, k, 1).reshape(n, length - k + 1, c * k)


def _path(p: Path, rows: torch.Tensor, k: int, mask: torch.Tensor | None,
          lengths: torch.Tensor) -> torch.Tensor:
    """LN4D'd rows ``[N, n, D]`` -> the path's output ``[N, n, D]`` before the
    residual; ``mask [N, n - k + 1]`` and the host ``lengths`` of the steps."""
    return deconv1d(p.linear, p.rnn(_unfold(rows, k), mask, lengths=lengths))


def _ln4d(p: LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p.g, p.b, EPS)


def _attention(blk: GridBlock, z: torch.Tensor, keys: torch.Tensor | None) -> torch.Tensor:
    """The full-band attention over ``z [B, T', F, D]`` -> its residual sum;
    ``keys [B, T']`` (1 = a frame of the row's own) or None.  Every head's
    1x1 convs run as one product; each head's flattening per frame is the
    bins-major one, which gives the same products as ESPnet's channel-major
    one in another order."""
    b, t, f, d = z.shape
    mods = [*blk.attn_q, *blk.attn_k, *blk.attn_v]
    heads, e, dv = len(blk.attn_q), blk.attn_q[0].conv.out_features, d // len(blk.attn_q)
    w = torch.cat([m.conv.weight for m in mods])
    bias = torch.cat([m.conv.bias for m in mods])
    slope = torch.cat([m.prelu.expand(m.conv.out_features) for m in mods])
    h = _prelu(F.linear(z, w, bias), slope)  # [B, T', F, L·(2E + D/L)]

    def part(lo: int, mods_: nn.ModuleList, c: int) -> torch.Tensor:
        x = h[..., lo:lo + heads * c].reshape(b, t, f, heads, c).permute(0, 3, 1, 2, 4)
        g = torch.stack([m.norm.g.t() for m in mods_])[:, None]  # [L, 1, F, c]
        beta = torch.stack([m.norm.b.t() for m in mods_])[:, None]
        x = F.layer_norm(x, (f, c), eps=EPS) * g + beta  # [B, L, T', F, c]
        return x.reshape(b, heads, t, f * c)

    q = part(0, blk.attn_q, e)
    k = part(heads * e, blk.attn_k, e)
    v = part(2 * heads * e, blk.attn_v, dv)
    logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(e * f)  # [B, L, T', T']
    if keys is not None:
        logits = logits + ((keys - 1.0) * -_NEG)[:, None, None, :]
    o = torch.matmul(torch.softmax(logits, dim=-1), v)  # [B, L, T', F·D/L]
    o = o.reshape(b, heads, t, f, dv).permute(0, 2, 3, 1, 4).reshape(b, t, f, d)
    pr = blk.attn_proj
    o = _prelu(F.linear(o, pr.conv.weight, pr.conv.bias), pr.prelu)
    return F.layer_norm(o, (f, d), pr.norm.g.t(), pr.norm.b.t(), EPS) + z


def _block(blk: GridBlock, z: torch.Tensor, own: OwnFrames | None, k: int) -> torch.Tensor:
    """One block over ``z [B, T', F, D]``; ``own`` the rows' own frames of a
    padded batch, or None (module docstring)."""
    b, t, f, d = z.shape
    dev = z.device
    rows = _ln4d(blk.intra.norm, z).reshape(b * t, f, d)
    if own is not None:
        rows = rows.index_select(0, own.flat)
    n, steps = rows.shape[0], f - k + 1
    with span(TFGRIDNET_INTRA, device=dev, rows=n, steps=n * steps, valid_steps=n * steps,
              blstm_path=blk.intra.rnn.path(rows)):
        y = _path(blk.intra, rows, k, None, torch.full((n,), steps, dtype=torch.int64))
        if own is not None:
            y = y.new_zeros(b * t, f, d).index_copy(0, own.flat, y)
        z = y.reshape(b, t, f, d) + z

    steps = t - k + 1
    rows = _ln4d(blk.inter.norm, z).permute(0, 2, 1, 3).reshape(b * f, t, d)
    if own is None:
        mask, lengths = None, torch.full((b * f,), steps, dtype=torch.int64)
    else:
        valid = torch.clamp(own.counts - k + 1, min=0)
        lengths = valid.repeat_interleave(f)
        vd = own.mask.sum(dim=1, keepdim=True) - (k - 1)  # the same counts, on the device
        mask = (torch.arange(steps, device=dev)[None, :] < vd).to(z.dtype)
        mask = mask[:, None, :].expand(b, f, steps).reshape(b * f, steps)
    with span(TFGRIDNET_INTER, device=dev, rows=b * f, steps=b * f * steps,
              valid_steps=int(lengths.sum()), blstm_path=blk.inter.rnn.path(rows)):
        y = _path(blk.inter, rows, k, mask, lengths)
        z = y.reshape(b, f, t, d).permute(0, 2, 1, 3) + z

    valid_frames = b * t if own is None else int(own.counts.sum())
    with span(TFGRIDNET_ATTN, device=dev, frames=b * t, valid_frames=valid_frames,
              heads=len(blk.attn_q)):
        z = _attention(blk, z, None if own is None else own.mask)
        if own is not None:  # frames past a row's own stay exactly zero downstream
            z = z * own.mask[:, :, None, None]
    return z


class TFGridNetModel(SeparatorBase):
    """TF-GridNet on the port's STFT front (module docstring); PIT SI-SDR
    loss, no dropout."""

    KIND = "tfgridnet"

    def __init__(self, cfg: ModelConfig):
        if cfg.kind != self.KIND:
            raise ValueError(f"TFGridNetModel needs kind {self.KIND!r}, got {cfg.kind!r}")
        if cfg.front.kind != "stft":
            raise ValueError(f"TFGridNetModel runs on the STFT front, got {cfg.front.kind!r}")
        if cfg.sep.compute_dtype != "float32" or cfg.sep.dropout:
            raise ValueError("TFGridNetModel runs in float32 without dropout")
        super().__init__(cfg)

    def _build_trunk(self, sep, f: int) -> None:
        d = sep.embed_dim
        if d % sep.heads:
            raise ValueError(f"sep.embed_dim={d} not divisible by heads={sep.heads}")
        s = self.cfg.nb_speakers
        self.conv = nn.Conv2d(2, d, 3, padding=1)
        self.norm = LayerNorm(d)
        self.blocks = nn.ModuleList(
            GridBlock(d, sep.kernel, sep.hidden, sep.layers, sep.heads, sep.expansion, f)
            for _ in range(sep.blocks))
        self.deconv = nn.ConvTranspose2d(d, 2 * s, 3, padding=1)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """PyTorch's own draws (``generator`` a CPU generator): each LSTM
        tensor uniform in ±1/√H, each conv's weight and bias in ±1/√fan-in as
        ``nn.Conv*d`` reckons it (the second axis times the taps), the
        norms at gain 1 and bias 0, the PReLUs at 0.25."""
        def uniform(p: torch.Tensor, bound: float) -> None:
            p.copy_((torch.rand(p.shape, generator=generator) * 2.0 - 1.0) * bound)

        fills = {"g": 1.0, "b": 0.0, "prelu": 0.25}
        for name, p in self.named_parameters():
            last = name.rsplit(".", 1)[-1]
            if last in fills:
                p.fill_(fills[last])
            elif ".rnn.lstm." in name:
                uniform(p, self.cfg.sep.hidden ** -0.5)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose1d, nn.ConvTranspose2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                uniform(m.weight, fan_in ** -0.5)
                uniform(m.bias, fan_in ** -0.5)

    def _trunk(self, feats: torch.Tensor, frame_mask: torch.Tensor | None,
               rng=None) -> torch.Tensor:
        """The spectrum ``[B, T', 2F]`` (zero past each row's frames) -> the
        last block's ``[B, T', F, D]``, zero past each row's frames."""
        b, t, f2 = feats.shape
        if t < self.cfg.sep.kernel:
            raise ValueError(f"TF-GridNet needs at least {self.cfg.sep.kernel} frames, got {t}")
        own = None if frame_mask is None else own_frames(frame_mask)
        x = feats.reshape(b, t, 2, f2 // 2).permute(0, 2, 1, 3)  # [B, 2, T', F]
        z = F.conv2d(x, self.conv.weight, self.conv.bias, padding=1)
        z = z.permute(0, 2, 3, 1).contiguous()
        z = self._gln(z, None if own is None else own.mask)
        for blk in self.blocks:
            z = _block(blk, z, own, self.cfg.sep.kernel)
        return z

    def _gln(self, z: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        """``nn.GroupNorm(1, D)`` of ``z [B, T', F, D]`` per row over its own
        frames (``mask [B, T']``, or every frame), zero past them."""
        m = z.new_ones(z.shape[:2]) if mask is None else mask
        m = m[:, :, None, None]
        n = torch.clamp(m.sum(dim=(1, 2, 3), keepdim=True) * z.shape[2] * z.shape[3], min=1.0)
        mu = (z * m).sum(dim=(1, 2, 3), keepdim=True) / n
        var = (m * (z - mu) ** 2).sum(dim=(1, 2, 3), keepdim=True) / n
        return ((z - mu) / torch.sqrt(var + EPS) * self.norm.g + self.norm.b) * m

    def _sigma(self, mix: torch.Tensor, frame_mask: torch.Tensor | None) -> torch.Tensor:
        """σ ``[B, 1]``: the standard deviation (correction 1) of each row's
        samples that its own frames cover, 0 where there are fewer than 2."""
        fc = self.cfg.front
        if frame_mask is None:
            v = torch.full((mix.shape[0],), fc.frames_for(mix.shape[-1]), device=mix.device)
        else:
            v = frame_mask.sum(dim=-1)
        n = torch.where(v > 0, (v - 1) * fc.hop + fc.win, 0).to(mix.dtype)[:, None]
        m = (torch.arange(mix.shape[-1], device=mix.device)[None, :] < n).to(mix.dtype)
        mu = (mix * m).sum(dim=-1, keepdim=True) / torch.clamp(n, min=1.0)
        var = (m * (mix - mu) ** 2).sum(dim=-1, keepdim=True) / torch.clamp(n - 1.0, min=1.0)
        return torch.where(n > 1.0, torch.sqrt(var), 0.0)

    def _forward(self, mix: torch.Tensor, frame_mask: torch.Tensor | None = None
                 ) -> torch.Tensor:
        """mix ``[B, T]`` -> ``[B, S, T]`` (module docstring)."""
        fm = None if frame_mask is None else frame_mask.to(mix.dtype)
        with span(FRONT, device=mix.device):
            sigma = self._sigma(mix, fm)
            spec = self.front.encode_ri(mix / torch.where(sigma > 0, sigma, 1.0))
            if fm is not None:
                spec = spec * fm[..., None]
        z = self.trunk(spec, fm)
        b, t = spec.shape[:2]
        s = self.cfg.nb_speakers
        with span(HEAD, device=mix.device):
            y = F.conv_transpose2d(z.permute(0, 3, 1, 2), self.deconv.weight, self.deconv.bias,
                                   padding=1)  # [B, 2S, T', F]
            y = y.reshape(b, s, 2, t, -1).permute(0, 1, 3, 2, 4).reshape(b, s, t, -1)
            if fm is not None:
                y = y * fm[:, None, :, None]
        with span(DECODE, device=mix.device):
            return self.front.decode_ri(y, mix.shape[-1], fm) * sigma[:, :, None]

    def loss(self, sources: torch.Tensor, rng=None) -> tuple[torch.Tensor, dict]:
        """Negative mean PIT SI-SDR of the waveforms separated from the mixture
        of ``sources`` [B, S, T] (``observed_mix``'s with the key ``rng``)."""
        est = self._forward(self.observed_mix(sources, rng))
        sdr, _ = pit_si_sdr(est, sources)
        loss = -sdr.mean()
        return loss, {"neg_pit_si_sdr": loss}

    @torch.no_grad()
    def separate(self, mix: torch.Tensor, frame_mask: torch.Tensor | None = None) -> torch.Tensor:
        """mix [B, T] -> separated [B, S, T]; ``frame_mask`` [B, T'] marks the
        valid frames of a padded batch (the padding contract)."""
        return self._forward(mix, frame_mask)
