"""The benchmark's inputs, made from ``--seed``: speech-like speakers, the
mixtures cut from them, and the fixed length grid of a traffic mix.

``speakers`` is a vectorised copy of the port's synthetic v2 generator
(``amss_tpu_torch/data/synthetic.py::synth_speaker_wave_v2``): per speaker an
f0 and three formants; per segment of 80-300 ms a kind (voiced 55%: a
glottal harmonic stack under the formant envelope with a 3 Hz f0 wander;
unvoiced 25%: formant-coloured noise at 0.7; silence 20%: breath noise at
0.003), 20 ms linear ramps at both ends, and the whole peak-normalised to 0.5.
The segment plans are drawn on the host; the samples are computed on the
device in a few large calls.  One departure: an unvoiced segment takes its
stretch of one noise signal coloured over the whole speaker, not a noise
coloured over the segment alone, so no FFT runs per segment.

Every seed gets the same lengths (``length_grid``: the mix's list); the seed
picks the content and the order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SAMPLE_RATE = 8000
_MAX_HARMONICS = 40


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A host generator for one named stream of a seed (any size of seed)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2**63, *stream]))


def device_generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(rng_for(seed, stream).integers(0, 2**62)))
    return g


def _segment_plan(rng: np.random.Generator, n: int):
    """Segment starts, lengths and kinds (0 voiced, 1 unvoiced, 2 silence)
    covering ``n`` samples, drawn as the v2 generator draws them."""
    lens = []
    total = 0
    while total < n:
        seg = int((0.08 + 0.22 * rng.random()) * SAMPLE_RATE)
        seg = min(seg, n - total)
        lens.append(seg)
        total += seg
    lens = np.asarray(lens, np.int64)
    kind_u = rng.random(len(lens))
    kinds = np.where(kind_u < 0.55, 0, np.where(kind_u < 0.8, 1, 2))
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return starts, lens, kinds


def speakers(seed: int, n_speakers: int, seconds: float, device) -> torch.Tensor:
    """``[n_speakers, seconds·8000]`` float32 speech-like waveforms on
    ``device``, each of peak 0.5."""
    n = int(seconds * SAMPLE_RATE)
    rng = rng_for(seed, 1)
    f0 = 85.0 + 170.0 * rng.random(n_speakers)
    formants = np.stack([300.0 + 500.0 * rng.random(n_speakers),
                         900.0 + 1200.0 * rng.random(n_speakers),
                         2200.0 + 1300.0 * rng.random(n_speakers)], axis=1)
    fbw = 80.0 + 80.0 * rng.random((n_speakers, 3))

    starts, lens, kinds, phases = [], [], [], []  # per segment, speakers in turn
    for _ in range(n_speakers):
        st, ln, kd = _segment_plan(rng, n)
        starts.append(st)
        lens.append(ln)
        kinds.append(kd)
        phases.append(rng.random((len(ln), 1 + _MAX_HARMONICS)))  # wander, harmonics
    n_segs = sum(len(x) for x in lens)

    dev = torch.device(device)
    g = device_generator(seed, 2, dev)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    seg_lens = t(np.concatenate(lens), torch.int64)
    sid = torch.repeat_interleave(torch.arange(n_segs, device=dev), seg_lens).reshape(
        n_speakers, n)
    tl = (torch.arange(n, device=dev)[None] - t(np.concatenate(starts), torch.int64)[sid]
          ).double()
    sl = seg_lens[sid].float()
    kd = t(np.concatenate(kinds), torch.int64)[sid]
    ph = t(np.concatenate(phases), torch.float64)

    # the formant envelope on a 2048-point grid, as v2 builds it
    freqs = torch.fft.rfftfreq(2048, 1.0 / SAMPLE_RATE, device=dev, dtype=torch.float64)
    fm, bw = t(formants, torch.float64), t(fbw, torch.float64)
    env = (1.0 / (1.0 + ((freqs[None, None] - fm[..., None]) / bw[..., None]) ** 2)).sum(1)
    env = env + 0.01  # [n_speakers, 1025]

    # voiced: phase = cumulative sum of the wandering f0 within the segment
    f0d = t(f0, torch.float64)[:, None]
    wander = f0d * (1.0 + 0.03 * torch.sin(2 * math.pi * 3.0 * tl / SAMPLE_RATE
                                           + ph[sid, 0]))
    step = 2 * math.pi * wander / SAMPLE_RATE
    csum = torch.cumsum(step, dim=1)
    first = csum - step  # value before each sample
    seg_base = torch.zeros(n_segs, dtype=torch.float64, device=dev)
    starts_mask = tl == 0
    seg_base[sid[starts_mask]] = first[starts_mask]
    phase = csum - seg_base[sid]
    voiced = torch.zeros((n_speakers, n), dtype=torch.float64, device=dev)
    for h in range(1, _MAX_HARMONICS + 1):
        fh = h * f0d[:, 0]
        ok = fh < 0.45 * SAMPLE_RATE
        if not bool(ok.any()):
            break
        # the envelope's gain at h·f0, linearly interpolated as np.interp
        pos = torch.clamp(fh / (SAMPLE_RATE / 2) * 1024, 0, 1024)
        lo = torch.floor(pos).long().clamp(max=1023)
        frac = pos - lo
        gain = env.gather(1, lo[:, None])[:, 0] * (1 - frac) + env.gather(
            1, (lo + 1)[:, None])[:, 0] * frac
        gain = torch.where(ok, gain, torch.zeros_like(gain))
        voiced += gain[:, None] * torch.sin(h * phase + 2 * math.pi * ph[sid, h])

    # unvoiced: one noise signal per speaker coloured by its envelope
    white = torch.randn((n_speakers, n), generator=g, device=dev, dtype=torch.float32)
    spec = torch.fft.rfft(white.double(), dim=1)
    f_loc = torch.fft.rfftfreq(n, 1.0 / SAMPLE_RATE, device=dev, dtype=torch.float64)
    pos = f_loc / (SAMPLE_RATE / 2) * 1024
    lo = torch.floor(pos).long().clamp(max=1023)
    frac = pos - lo
    shaped = env[:, lo] * (1 - frac) + env[:, lo + 1] * frac
    unvoiced = 0.7 * torch.fft.irfft(spec * shaped, n, dim=1)
    breath = 0.003 * torch.randn((n_speakers, n), generator=g, device=dev,
                                 dtype=torch.float32).double()

    out = torch.where(kd == 0, voiced, torch.where(kd == 1, unvoiced, breath))
    ramp = torch.clamp(torch.floor(sl / 4), max=160).double()
    up = torch.clamp(tl / torch.clamp(ramp - 1, min=1), max=1.0)
    down = torch.clamp((sl.double() - 1 - tl) / torch.clamp(ramp - 1, min=1), max=1.0)
    out = out * torch.where(ramp > 0, up * down, torch.ones_like(up))
    peak = out.abs().amax(dim=1, keepdim=True).clamp(min=1e-6)
    return (0.5 * out / peak).to(torch.float32)


def length_grid(lengths_s: list[float], count: int) -> np.ndarray:
    """``count`` lengths in samples: the mix's list of lengths (seconds),
    repeated in order to fill ``count``.  The same for every seed."""
    return np.round(np.resize(np.asarray(lengths_s, np.float64), count) * SAMPLE_RATE
                    ).astype(np.int64)


def mixtures(seed: int, bank: np.ndarray, lengths: np.ndarray, gain_db: tuple[float, float],
             stream: int = 3) -> tuple[list[np.ndarray], np.ndarray]:
    """One two-speaker mixture per length: two distinct speakers of ``bank``
    ``[n_speakers, n]`` at drawn offsets, the second at a drawn gain in
    ``gain_db`` relative to the first.  Returns (mixtures, sources [M, 2]
    as (speaker, offset, speaker, offset) rows and gains, for the record)."""
    rng = rng_for(seed, stream)
    n_spk, n = bank.shape
    out = []
    plan = np.empty((len(lengths), 5))
    for i, t in enumerate(lengths):
        a, b = rng.choice(n_spk, size=2, replace=False)
        oa, ob = rng.integers(0, n - t + 1, size=2)
        gain = 10.0 ** (rng.uniform(*gain_db) / 20.0)
        out.append((bank[a, oa:oa + t] + np.float32(gain) * bank[b, ob:ob + t]).astype(np.float32))
        plan[i] = (a, oa, b, ob, gain)
    return out, plan
