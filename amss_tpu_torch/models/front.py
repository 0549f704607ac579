"""The STFT front, the feature norms and the mask and target helpers
(``amss_tpu/models/front.py``); ``make_front`` also builds the adaptive front
of ``models/adapt.py``.

``encode(wave) -> (codes, aux)``: magnitudes and the unit mixture phase.
``features(codes)``: log-compressed separator input.
``decode(codes, aux, length)``: masked magnitudes times the phase, back to
waveforms.  Analysis runs kernel B1 and synthesis kernel B2, with the window
folded into their bases; the COLA divide stays outside the kernel.
``encode_ri`` and ``decode_ri`` are the same pair on the complex spectrum
itself (real parts, then imaginary ones), for a model that maps spectra to
spectra (TF-GridNet, ``models/tfgridnet.py``).
``make_front`` also builds SepFormer's conv front (``ConvFrontEnd``).

The train-time corruptions (``drop_sources``, ``corrupt_mix``,
``reverberate_sources``) are each a draw and an apply.  The draws come from a
``DropoutKey`` under the JAX package's constants: the per-row scalars (k, the
SNR, RT60 and DRR) from a host generator, so the card and the CPU draw the
same ones, copied to the device without a wait; the noise and the RIR tails
from a generator on the device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from amss_tpu_torch.models.adapt import AdaptFrontEnd
from amss_tpu_torch.ops.kernels.framed_matmul import framed_matmul, stft_basis
from amss_tpu_torch.ops.kernels.ola import decode_ola
from amss_tpu_torch.ops.framing import overlap_add
from amss_tpu_torch.ops.stft import cola_norm, hann_window, idft_matrices
from amss_tpu_torch.utils.config import FrontConfig

_EPS = 1e-7
# the JAX package's fold-in constants of the corruptions' keys
_NOISE_KEY, _DROP_KEY, _REVERB_KEY = 0x5E15E, 0xC0DE7, 0x4EE4B


class STFTFrontEnd(nn.Module):
    """Fixed windowed-DFT analysis and synthesis; its bases are buffers."""

    def __init__(self, cfg: FrontConfig):
        super().__init__()
        if cfg.kind != "stft":
            raise ValueError(f"STFTFrontEnd needs kind 'stft', got {cfg.kind!r}")
        self.cfg = cfg
        win = cfg.win
        window = hann_window(win)
        ci, si = idft_matrices(win)
        self.register_buffer("window", torch.as_tensor(window))
        self.register_buffer("analysis_basis", torch.tensor(stft_basis(win)))
        self.register_buffer(
            "synthesis_basis",
            torch.as_tensor(np.concatenate([ci, si], axis=0) * window[None, :]),
        )

    def encode_ri(self, wave: torch.Tensor) -> torch.Tensor:
        """``wave[..., T]`` -> the spectrum ``[..., T', 2F]``, the real parts
        then the imaginary ones."""
        lead = wave.shape[:-1]
        out = framed_matmul(wave.reshape(-1, wave.shape[-1]), self.analysis_basis,
                            self.cfg.hop)
        return out.reshape(*lead, *out.shape[-2:])

    def encode(self, wave: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """``wave[..., T]`` -> (magnitudes ``[..., T', F]``, {"cos", "sin"})."""
        f = self.cfg.win // 2 + 1
        out = self.encode_ri(wave)
        re, im = out[..., :f], out[..., f:]
        mag = torch.sqrt(re * re + im * im + _EPS * _EPS)
        return mag, {"cos": re / mag, "sin": im / mag}

    def features(self, codes: torch.Tensor) -> torch.Tensor:
        return torch.log(codes + _EPS)

    def decode(self, codes: torch.Tensor, aux: dict, length: int) -> torch.Tensor:
        """codes ``[..., T', F]`` with the phase in ``aux`` -> ``[..., length]``."""
        return self.decode_ri(torch.cat([codes * aux["cos"], codes * aux["sin"]], dim=-1),
                              length)

    def decode_ri(self, ri: torch.Tensor, length: int,
                  frame_mask: torch.Tensor | None = None) -> torch.Tensor:
        """A spectrum ``[B, ..., T', 2F]`` (``encode_ri``'s layout) ->
        ``[B, ..., length]``.  With a prefix ``frame_mask [B, T']``, each
        row's normaliser is that of its own frames alone, so a row of a
        padded batch whose spectrum is zero past its frames gets what it gets
        unpadded."""
        lead = ri.shape[:-2]
        nf = ri.shape[-2]
        y = decode_ola(ri.reshape(-1, nf, ri.shape[-1]), self.synthesis_basis, self.cfg.hop,
                       length=length).reshape(*lead, length)
        if frame_mask is None:
            return y / cola_norm(self.window, nf, self.cfg.hop, length)
        wsq = (self.window * self.window) * frame_mask[..., None]
        norm = overlap_add(wsq, self.cfg.hop, length=length)  # [B, length]
        peak = norm.amax(dim=-1, keepdim=True).clamp(min=1e-30)  # a row of no frame reads 0
        norm = torch.maximum(norm, 1e-2 * peak)
        return y / norm.reshape(norm.shape[0], *([1] * (y.dim() - 2)), length)


class ConvFrontEnd(nn.Module):
    """SepFormer's published encoder and decoder (SpeechBrain's
    ``dual_path.Encoder`` and ``Decoder``): a bias-free stride-s conv1d of L
    taps followed by a ReLU, and a bias-free transposed conv1d.  They are
    ``frames @ enc`` (kernel B1) and ``overlap_add(codes @ dec)`` (kernel B2)
    behind the same wrappers and shape gate as the adaptive front's, with its
    layouts (``enc [L, N]``, ``dec [N, L]``).  The codes are the separator's
    features and carry no aux."""

    def __init__(self, cfg: FrontConfig):
        super().__init__()
        if cfg.kind != "conv" or cfg.pool != 1:
            raise ValueError(f"ConvFrontEnd needs kind 'conv' and pool 1, got {cfg.kind!r}, "
                             f"pool {cfg.pool}")
        self.cfg = cfg
        self.enc = nn.Parameter(torch.zeros(cfg.filter_len, cfg.n_filters))
        self.dec = nn.Parameter(torch.zeros(cfg.n_filters, cfg.filter_len))

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """PyTorch's default conv init: uniform in ±1/√L for both."""
        bound = self.cfg.filter_len ** -0.5
        for p in (self.enc, self.dec):
            p.copy_((torch.rand(p.shape, generator=generator) * 2.0 - 1.0) * bound)

    def encode(self, wave: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """``wave[..., T]`` -> (codes ``[..., T', N]``, {})."""
        lead = wave.shape[:-1]
        z = framed_matmul(wave.reshape(-1, wave.shape[-1]), self.enc, self.cfg.stride)
        return torch.relu(z).reshape(*lead, *z.shape[-2:]), {}

    def features(self, codes: torch.Tensor) -> torch.Tensor:
        return codes

    def decode(self, codes: torch.Tensor, aux: dict, length: int) -> torch.Tensor:
        """codes ``[..., T', N]`` -> ``[..., length]``, trimmed or zero-padded."""
        lead = codes.shape[:-2]
        y = decode_ola(codes.reshape(-1, *codes.shape[-2:]), self.dec, self.cfg.stride,
                       length=length)
        return y.reshape(*lead, length)


def make_front(cfg: FrontConfig) -> nn.Module:
    if cfg.kind == "stft":
        return STFTFrontEnd(cfg)
    if cfg.kind == "adapt":
        return AdaptFrontEnd(cfg)
    if cfg.kind == "conv":
        return ConvFrontEnd(cfg)
    raise ValueError(f"unknown front kind {cfg.kind!r}")


# ---------------------------------------------------------------------------
# Train-time corruptions.  Targets stay the clean, dry sources; only
# drop_sources changes them (the dropped sources are silent in the targets).
# ---------------------------------------------------------------------------


def _to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on ``device``; to a card through pinned memory, without
    the host waiting for the copy."""
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _host_uniform(key, shape, lo: float, hi: float) -> torch.Tensor:
    """Uniform float32 in [lo, hi) from a host generator seeded with ``key``."""
    return lo + (hi - lo) * key.rand(shape)


def draw_active_counts(rng, b: int, s: int, min_speakers: int) -> torch.Tensor:
    """k ~ U{min_speakers..s} per row, [b] int64 on the host."""
    return rng.fold_in(_DROP_KEY).randint(min_speakers, s + 1, (b,))


def apply_drop(sources: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Zero the sources [B, S, T] at index >= k [B]."""
    s = sources.shape[1]
    active = (torch.arange(s, device=sources.device)[None, :] < k[:, None]).to(sources.dtype)
    return sources * active[:, :, None]


def drop_sources(sources: torch.Tensor, rng, min_speakers: int) -> torch.Tensor:
    """Count-diverse training: draw an active count k per row and zero the
    sources at index >= k, before mixing and target building.  The speaker
    order in a row is already a uniform draw (``data/mixer.py``), so zeroing
    the tail is an unbiased subset."""
    b, s, _ = sources.shape
    k = draw_active_counts(rng, b, s, min_speakers)
    return apply_drop(sources, _to_device(k, sources.device))


def draw_noise(rng, shape, snr_db_range: tuple[float, float],
               device) -> tuple[torch.Tensor, torch.Tensor]:
    """(SNR in dB [B] drawn on the host, white noise ``shape`` [B, T] drawn on
    ``device``), from ``split(2)`` of the key folded with the noise constant."""
    kn, ks = rng.fold_in(_NOISE_KEY).split(2)
    snr_db = _to_device(_host_uniform(ks, (shape[0],), *snr_db_range), device)
    noise = kn.randn(shape, device)
    return snr_db, noise


def apply_noise(mix: torch.Tensor, snr_db: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """``mix`` [B, T] plus ``noise`` scaled to ``snr_db`` [B] below its RMS."""
    mix_rms = torch.sqrt((mix * mix).mean(dim=-1) + _EPS)
    noise_rms = torch.sqrt((noise * noise).mean(dim=-1) + _EPS)
    target_rms = mix_rms * 10.0 ** (-snr_db / 20.0)
    return mix + noise * (target_rms / noise_rms)[:, None]


def corrupt_mix(mix: torch.Tensor, rng, snr_db_range: tuple[float, float]) -> torch.Tensor:
    """Noisy training: white Gaussian noise at an SNR drawn uniformly per row
    in ``snr_db_range`` against the mixture's RMS."""
    return apply_noise(mix, *draw_noise(rng, mix.shape, snr_db_range, mix.device))


def rir_length(t: int, rt60_hi: float) -> int:
    """The RIR's taps: the tail is cut at the -30 dB point of the longest
    RT60, and at 4096 taps and the chunk's length."""
    return int(min(t, 4096, max(2, int(rt60_hi) // 2)))


def draw_reverb(rng, b: int, s: int, rir_len: int, rt60_range: tuple[float, float],
                drr_db_range: tuple[float, float], device) -> tuple:
    """(RT60 in samples [B, S, 1] and DRR in dB [B, S, 1], drawn on the host;
    the Gaussian tails [B, S, rir_len - 1], drawn on ``device``), from
    ``split(3)`` of the key folded with the reverb constant."""
    kt, kd, kn = rng.fold_in(_REVERB_KEY).split(3)
    rt60 = _to_device(_host_uniform(kt, (b, s, 1), *rt60_range), device)
    drr_db = _to_device(_host_uniform(kd, (b, s, 1), *drr_db_range), device)
    gauss = kn.randn((b, s, rir_len - 1), device)
    return rt60, drr_db, gauss


def room_impulse_responses(rt60: torch.Tensor, drr_db: torch.Tensor,
                           gauss: torch.Tensor) -> torch.Tensor:
    """Synthetic RIRs [B, S, L]: a direct tap of 1 at lag 0, then the tail
    ``gauss`` [B, S, L - 1] decaying to -60 dB at lag ``rt60``, its energy
    scaled to the direct-to-reverb ratio ``drr_db``, the whole of unit
    energy."""
    n = torch.arange(1, gauss.shape[-1] + 1, dtype=gauss.dtype, device=gauss.device)
    tail = gauss * 10.0 ** (-3.0 * n / rt60)
    tail_energy = (tail * tail).sum(dim=-1, keepdim=True)
    tail = tail * torch.sqrt(10.0 ** (-drr_db / 10.0) / (tail_energy + _EPS))
    h = torch.cat([torch.ones_like(tail[..., :1]), tail], dim=-1)
    return h / torch.sqrt((h * h).sum(dim=-1, keepdim=True))


def apply_reverb(sources: torch.Tensor, rt60: torch.Tensor, drr_db: torch.Tensor,
                 gauss: torch.Tensor) -> torch.Tensor:
    """Each source [B, S, T] convolved causally with its own RIR: one
    depthwise cross-correlation with the kernel flipped (B·S groups), padded
    by L - 1 and trimmed to T, as the JAX package's ``lax.conv``.  cuDNN runs
    it in float32 (no TF32)."""
    b, s, t = sources.shape
    h = room_impulse_responses(rt60, drr_db, gauss)
    rir_len = h.shape[-1]
    w = torch.flip(h, dims=[-1]).reshape(b * s, 1, rir_len)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                    allow_tf32=False):
        y = F.conv1d(sources.reshape(1, b * s, t), w, padding=rir_len - 1, groups=b * s)
    return y[..., :t].reshape(b, s, t)


def reverberate_sources(sources: torch.Tensor, rng, rt60_range: tuple[float, float],
                        drr_db_range: tuple[float, float] = (0.0, 10.0)) -> torch.Tensor:
    """Reverberant training: each source [B, S, T] convolved with its own
    synthetic RIR of ``rir_length`` taps, RT60 (in samples) and DRR drawn
    uniformly per source.  The caller sums the result into the observed
    mixture; the targets stay dry."""
    b, s, t = sources.shape
    draws = draw_reverb(rng, b, s, rir_length(t, rt60_range[1]), rt60_range, drr_db_range,
                        sources.device)
    return apply_reverb(sources, *draws)


def vad_weights(mix_codes: torch.Tensor, threshold_db: float = 40.0) -> torch.Tensor:
    """Binary voice activity: drop bins more than ``threshold_db`` below the
    utterance's loudest.  [B, T', F] -> [B, T', F]."""
    logmag = 20.0 * torch.log10(mix_codes + _EPS)
    ref = torch.amax(logmag, dim=(-2, -1), keepdim=True)
    return (logmag > ref - threshold_db).to(mix_codes.dtype)


def ideal_binary_mask(src_codes: torch.Tensor) -> torch.Tensor:
    """Dominant-source one-hot mask: [B, S, T', F] -> [B, T', F, S], ties to
    the first maximum (``torch.argmax``, as ``jnp.argmax``)."""
    dom = torch.argmax(src_codes, dim=1)
    return _one_hot_last(dom, src_codes.shape[1], src_codes.dtype)


def magnitude_weights(mix_codes: torch.Tensor) -> torch.Tensor:
    """Magnitude-ratio bin weights, normalised to mean 1 per utterance."""
    mean = mix_codes.mean(dim=(-2, -1), keepdim=True)
    return mix_codes / torch.clamp(mean, min=_EPS)


def bin_weights(mix_codes: torch.Tensor, kind: str, threshold_db: float) -> torch.Tensor:
    """The loss's bin weights: "vad", "magnitude" or both ("magvad")."""
    if kind == "vad":
        return vad_weights(mix_codes, threshold_db)
    if kind == "magnitude":
        return magnitude_weights(mix_codes)
    if kind == "magvad":
        return magnitude_weights(mix_codes) * vad_weights(mix_codes, threshold_db)
    raise ValueError(f"unknown weight_kind {kind!r}")


def instance_norm(
    feats: torch.Tensor, frame_mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Per-utterance zero mean, unit variance over (time, freq), padding-aware."""
    if frame_mask is None:
        mu = feats.mean(dim=(-2, -1), keepdim=True)
        var = feats.var(dim=(-2, -1), keepdim=True, unbiased=False)
    else:
        m = frame_mask[..., None]
        denom = torch.clamp(
            (m * torch.ones_like(feats)).sum(dim=(-2, -1), keepdim=True), min=1.0
        )
        mu = (feats * m).sum(dim=(-2, -1), keepdim=True) / denom
        var = (m * (feats - mu) ** 2).sum(dim=(-2, -1), keepdim=True) / denom
    return (feats - mu) * (1.0 / torch.sqrt(var + 1e-5))


def channel_norm(
    feats: torch.Tensor, frame_mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Per-channel zero mean, unit variance over time, padding-aware: the
    learned fronts' norm, whose filters' output scales are arbitrary."""
    if frame_mask is None:
        mu = feats.mean(dim=-2, keepdim=True)
        var = feats.var(dim=-2, keepdim=True, unbiased=False)
    else:
        m = frame_mask[..., None]
        denom = torch.clamp(m.sum(dim=-2, keepdim=True), min=1.0)
        mu = (feats * m).sum(dim=-2, keepdim=True) / denom
        var = (m * (feats - mu) ** 2).sum(dim=-2, keepdim=True) / denom
    return (feats - mu) * (1.0 / torch.sqrt(var + 1e-5))


def _one_hot_last(idx: torch.Tensor, depth: int, dtype) -> torch.Tensor:
    iota = torch.arange(depth, dtype=idx.dtype, device=idx.device)
    return (idx[..., None] == iota).to(dtype)


def psa_targets(mix_codes: torch.Tensor, mix_aux: dict, src_codes: torch.Tensor,
                src_aux: dict) -> torch.Tensor:
    """Truncated phase-sensitive targets ``|S_s|·cos(φ_s − φ_mix)`` clipped to
    ``[0, |X|]``, from the STFT front's unit phases ``{"cos", "sin"}``.
    mix_codes [B, T', F], src_codes [B, S, T', F] -> [B, S, T', F]."""
    cosd = src_aux["cos"] * mix_aux["cos"][:, None] + src_aux["sin"] * mix_aux["sin"][:, None]
    t = src_codes * cosd
    return torch.minimum(torch.clamp(t, min=0.0), mix_codes[:, None])


def _prefix_sums(valid: torch.Tensor, x: torch.Tensor, f: int, carry) -> tuple:
    """Running (count, sum, sum of squares) over frames of the masked features
    ``x`` [..., T', F], each seeded with the carry's total when one is given."""
    cnt = torch.cumsum(valid, dim=-1) * f
    s = torch.cumsum(x.sum(dim=-1), dim=-1)
    ss = torch.cumsum((x * x).sum(dim=-1), dim=-1)
    if carry is None:
        return cnt, s, ss
    c0, s0, ss0 = (torch.as_tensor(v, dtype=x.dtype, device=x.device)[..., None]
                   for v in carry)
    return cnt + c0, s + s0, ss + ss0


def _valid(feats: torch.Tensor, frame_mask: torch.Tensor | None) -> torch.Tensor:
    if frame_mask is None:
        return torch.ones(feats.shape[:-1], dtype=feats.dtype, device=feats.device)
    return frame_mask.to(feats.dtype)


def cumulative_norm(
    feats: torch.Tensor,  # [..., T', F]
    frame_mask: torch.Tensor | None = None,  # [..., T'] 1 = valid
    carry: tuple | None = None,  # (count, sum, sumsq) of the frames before t = 0
) -> tuple[torch.Tensor, tuple]:
    """Causal utterance norm: frame t is normalised by the running mean and
    variance of all valid frames <= t (cumulative layer norm), so nothing
    reads the future.  ``carry`` seeds the running sums with everything that
    already streamed past (``infer/realtime.py``).

    The float32 sums stop registering new frames after about 2^24 pushes, and
    ``ss/n - mu²`` cancels; ``cumulative_norm_welford`` is the form for
    unbounded streams.  Returns (normalised features, (count, sum, sumsq)
    totals over all frames)."""
    valid = _valid(feats, frame_mask)
    cnt, s, ss = _prefix_sums(valid, feats * valid[..., None], feats.shape[-1], carry)
    denom = torch.clamp(cnt, min=1.0)
    mu = s / denom
    var = torch.clamp(ss / denom - mu * mu, min=0.0)
    out = (feats - mu[..., None]) * (1.0 / torch.sqrt(var[..., None] + 1e-5))
    if frame_mask is not None:
        out = out * valid[..., None]
    return out, (cnt[..., -1], s[..., -1], ss[..., -1])


def cumulative_norm_welford(
    feats: torch.Tensor,  # [..., T', F]
    frame_mask: torch.Tensor | None = None,  # [..., T'] 1 = valid
    carry: tuple | None = None,  # (count, mean, M2) of the frames before t = 0
) -> tuple[torch.Tensor, tuple]:
    """``cumulative_norm`` with a (count, mean, M2) carry merged by Chan's
    parallel Welford formula: no large-sum cancellation, so the carry stays
    accurate over unbounded streams.  Within one call the prefix statistics
    come from sums; only the merge with the carry uses the stable form.  It
    agrees with ``cumulative_norm`` to rounding, not bit for bit."""
    f = feats.shape[-1]
    valid = _valid(feats, frame_mask)
    cnt, s, ss = _prefix_sums(valid, feats * valid[..., None], f, None)
    d_loc = torch.clamp(cnt, min=1.0)
    mu_loc = s / d_loc
    m2_loc = torch.clamp(ss - cnt * mu_loc * mu_loc, min=0.0)
    if carry is None:
        n0 = torch.zeros(feats.shape[:-2], dtype=feats.dtype, device=feats.device)
        mu0, m20 = torch.zeros_like(n0), torch.zeros_like(n0)
    else:
        n0, mu0, m20 = carry
    n0_, mu0_, m20_ = n0[..., None], mu0[..., None], m20[..., None]
    n = n0_ + cnt
    dn = torch.clamp(n, min=1.0)
    delta = mu_loc - mu0_
    mu = mu0_ + delta * cnt / dn
    m2 = m20_ + m2_loc + delta * delta * n0_ * cnt / dn
    var = torch.clamp(m2 / dn, min=0.0)
    out = (feats - mu[..., None]) * (1.0 / torch.sqrt(var[..., None] + 1e-5))
    if frame_mask is not None:
        out = out * valid[..., None]
    return out, (n[..., -1], mu[..., -1], m2[..., -1])
