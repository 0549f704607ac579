"""Short-Time Objective Intelligibility (STOI) in numpy on the host
(``amss_tpu/ops/stoi.py``), a copy that gives the same numbers bit for bit.
Taal et al., "An Algorithm for Intelligibility Prediction of Time-Frequency
Weighted Noisy Speech" (IEEE TASLP 2011):

  1. resample both signals to 10 kHz (``data/resample.py``);
  2. remove frames more than 40 dB below the loudest frame of the CLEAN
     signal (256-sample Hann frames, 50% overlap);
  3. 512-point STFT -> 15 one-third-octave bands, centres 150·2^(k/3) Hz,
     k = 0..14 (150 Hz … ~3.8 kHz);
  4. over 384 ms segments (N=30 frames), normalise the degraded band
     envelope to the clean energy, clip at -15 dB SDR, and average the
     per-segment per-band linear correlation coefficients.
"""

from __future__ import annotations

import numpy as np

FS = 10000  # STOI's internal rate
WIN = 256
HOP = 128
NFFT = 512
N_BANDS = 15
MIN_FREQ = 150.0
SEG = 30  # frames per intelligibility segment (384 ms @ 10 kHz, hop 128)
BETA = -15.0  # clipping SDR bound, dB
DYN_RANGE = 40.0  # silent-frame threshold below the loudest clean frame


def _third_octave_bands() -> np.ndarray:
    """[N_BANDS, NFFT//2+1] boolean band matrix over one-third octaves."""
    f = np.linspace(0, FS / 2, NFFT // 2 + 1)
    cf = MIN_FREQ * 2.0 ** (np.arange(N_BANDS) / 3.0)
    lo = cf * 2.0 ** (-1.0 / 6.0)
    hi = cf * 2.0 ** (1.0 / 6.0)
    return (f[None, :] >= lo[:, None]) & (f[None, :] < hi[:, None])


def _frames(x: np.ndarray) -> np.ndarray:
    n = 1 + max(0, (len(x) - WIN)) // HOP
    idx = np.arange(WIN)[None, :] + HOP * np.arange(n)[:, None]
    return x[idx]


def _resample_to_fs(x: np.ndarray, sr: int) -> np.ndarray:
    if sr == FS:
        return np.asarray(x, np.float64)
    from amss_tpu_torch.data.resample import resample_sinc

    return np.asarray(resample_sinc(np.asarray(x, np.float32), sr, FS),
                      np.float64)


def stoi(clean: np.ndarray, degraded: np.ndarray, sample_rate: int) -> float:
    """STOI in [~0, 1] of ``degraded`` against ``clean`` (same length)."""
    if clean.shape != degraded.shape:
        raise ValueError(f"shape mismatch {clean.shape} vs {degraded.shape}")
    x = _resample_to_fs(clean, sample_rate)
    y = _resample_to_fs(degraded, sample_rate)
    if len(x) < WIN + SEG * HOP:
        raise ValueError(
            f"need at least {(WIN + SEG * HOP) / FS:.2f} s of audio at "
            f"{sample_rate} Hz for a STOI segment, got {len(x) / FS:.2f} s"
        )

    # silent-frame removal, driven by the clean signal's frame energies
    w = np.hanning(WIN + 2)[1:-1]
    xf, yf = _frames(x) * w, _frames(y) * w
    e = 20.0 * np.log10(np.linalg.norm(xf, axis=1) + 1e-12)
    keep = e >= e.max() - DYN_RANGE
    if keep.sum() < SEG:
        raise ValueError("fewer than one segment of non-silent frames")
    xf, yf = xf[keep], yf[keep]

    # one-third-octave band envelopes
    bands = _third_octave_bands()
    X = np.abs(np.fft.rfft(xf, NFFT, axis=1)) ** 2
    Y = np.abs(np.fft.rfft(yf, NFFT, axis=1)) ** 2
    Xb = np.sqrt(X @ bands.T)  # [T, N_BANDS]
    Yb = np.sqrt(Y @ bands.T)

    # segment correlations
    clip = 10.0 ** (-BETA / 20.0)
    scores = []
    for m in range(SEG, Xb.shape[0] + 1):
        xs = Xb[m - SEG : m]  # [SEG, B]
        ys = Yb[m - SEG : m]
        alpha = np.linalg.norm(xs, axis=0) / (np.linalg.norm(ys, axis=0) + 1e-12)
        ysn = np.minimum(ys * alpha[None, :], xs * (1.0 + clip))
        xm = xs - xs.mean(axis=0, keepdims=True)
        ym = ysn - ysn.mean(axis=0, keepdims=True)
        denom = np.linalg.norm(xm, axis=0) * np.linalg.norm(ym, axis=0)
        scores.append((xm * ym).sum(axis=0) / (denom + 1e-12))
    return float(np.mean(scores))
