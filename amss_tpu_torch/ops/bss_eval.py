"""BSS-Eval (SDR / SIR / SAR) in numpy on the host
(``amss_tpu/ops/bss_eval.py``), a copy that gives the same numbers bit for
bit: the BSS Eval v3 source decomposition (Vincent, Gribonval & Fevotte,
"Performance measurement in blind audio source separation", IEEE TASLP 2006)
that ``mir_eval.separation.bss_eval_sources`` computes.

Each estimate decomposes against the true sources as

    est = s_target + e_interf + e_artif
    s_target = P_{ref_j}(est)   — projection onto {ref_j delayed 0..L-1}
    e_interf = P_{refs}(est) - s_target
    e_artif  = est - P_{refs}(est)

with L = 512 taps, the projections solved by least squares over the
delayed-reference subspace.  Then

    SDR = 10 log10 |s_target|^2 / |e_interf + e_artif|^2
    SIR = 10 log10 |s_target|^2 / |e_interf|^2
    SAR = 10 log10 |s_target + e_interf|^2 / |e_artif|^2

The permutation maximises the mean SIR over the S! assignments.  The
correlations ride rFFTs; the Gram solve is an (S·L)² SPD system.  It runs per
utterance at evaluation only; serving scores SI-SDR on the device
(``ops/metrics.py``).
"""

from __future__ import annotations

import itertools

import numpy as np

_FLEN = 512  # distortion-filter taps, the bss_eval default


def _correlations(refs: np.ndarray, est: np.ndarray, flen: int):
    """FFT correlations for the projection normal equations.

    refs [S, T], est [T] (both zero-padded conceptually to T+flen-1).
    Returns (G [S*flen, S*flen] Gram of delayed refs, d [S*flen] cross-corr).
    """
    s, t = refs.shape
    n = t + flen - 1
    nfft = 1 << (n - 1).bit_length()
    rf = np.fft.rfft(refs, nfft)  # [S, nf]
    ef = np.fft.rfft(est, nfft)

    # c[i, j, k] = sum_t refs_i(t) refs_j(t + k), k in [-(flen-1), flen-1]
    cc = np.fft.irfft(rf[:, None] * np.conj(rf[None, :]), nfft)  # [S, S, nfft]
    g = np.zeros((s, flen, s, flen))
    # G[(i,l),(j,m)] = <ref_i delayed l, ref_j delayed m> = c_ij(l-m) with
    # c_ij(k) = sum_u ref_i(u) ref_j(u+k) = cc[j, i, k]; negative lags via
    # c_ij(-k) = c_ji(k).  Toeplitz in (l, m) per (i, j) block.
    idx = np.subtract.outer(np.arange(flen), np.arange(flen))  # l - m
    for i in range(s):
        for j in range(s):
            g[i, :, j, :] = np.where(
                idx >= 0, cc[j, i, idx % nfft], cc[i, j, (-idx) % nfft]
            )
    g = g.reshape(s * flen, s * flen)

    ce = np.fft.irfft(np.conj(rf) * ef[None, :], nfft)  # [S, nfft]; lag l -> ref delayed l
    d = np.stack([ce[j, :flen] for j in range(s)]).reshape(s * flen)
    return g, d


def _apply_filters(refs: np.ndarray, coefs: np.ndarray, flen: int, out_len: int):
    """sum_j (refs_j * h_j)(t) for per-ref FIR taps coefs [S, flen]."""
    s, t = refs.shape
    nfft = 1 << (t + flen - 1 - 1).bit_length()
    rf = np.fft.rfft(refs, nfft)
    hf = np.fft.rfft(coefs, nfft)
    y = np.fft.irfft(np.sum(rf * hf, axis=0), nfft)
    return y[:out_len]


def _project(refs: np.ndarray, est: np.ndarray, flen: int) -> np.ndarray:
    """Least-squares projection of est onto span{refs_j delayed 0..flen-1},
    returned at length T + flen - 1 (the padded decomposition length)."""
    s, t = refs.shape
    g, d = _correlations(refs, est, flen)
    # relative ridge: delayed narrowband refs (pure tones) make G nearly
    # singular; lstsq fallback covers the truly rank-deficient case
    ridge = 1e-9 * (np.trace(g) / (s * flen) + 1e-30)
    try:
        coefs = np.linalg.solve(g + ridge * np.eye(s * flen), d)
    except np.linalg.LinAlgError:
        coefs = np.linalg.lstsq(g, d, rcond=None)[0]
    return _apply_filters(refs, coefs.reshape(s, flen), flen, t + flen - 1)


def _pad(x: np.ndarray, flen: int) -> np.ndarray:
    return np.concatenate([x, np.zeros(flen - 1, x.dtype)])


def _db(num: float, den: float) -> float:
    return 10.0 * np.log10((num + 1e-12) / (den + 1e-12))


def bss_eval_sources(
    ref: np.ndarray,  # [S, T] true sources
    est: np.ndarray,  # [S, T] estimates
    flen: int = _FLEN,
    compute_permutation: bool = True,
):
    """BSS Eval v3 SDR/SIR/SAR with permutation resolution.

    Returns (sdr [S], sir [S], sar [S], perm [S]) where perm[j] is the index
    of the estimate assigned to reference j (max-mean-SIR assignment, the
    bss_eval_sources convention).
    """
    ref = np.asarray(ref, np.float64)
    est = np.asarray(est, np.float64)
    s = ref.shape[0]

    # Per-estimate pieces: P_all(est_i) is independent of the pairing.
    sdr = np.zeros((s, s))
    sir = np.zeros((s, s))
    sar = np.zeros((s, s))
    for i in range(s):
        e_pad = _pad(est[i], flen)
        p_all = _project(ref, est[i], flen)
        e_artif = e_pad - p_all
        na = float(np.sum(e_artif**2))
        for j in range(s):
            s_target = _project(ref[j : j + 1], est[i], flen)
            e_interf = p_all - s_target
            nt = float(np.sum(s_target**2))
            ni = float(np.sum(e_interf**2))
            sdr[j, i] = _db(nt, float(np.sum((e_interf + e_artif) ** 2)))
            sir[j, i] = _db(nt, ni)
            sar[j, i] = _db(float(np.sum((s_target + e_interf) ** 2)), na)

    if not compute_permutation:
        perm = np.arange(s)
    else:
        best, best_sir = None, -np.inf
        for cand in itertools.permutations(range(s)):
            m = float(np.mean([sir[j, cand[j]] for j in range(s)]))
            if m > best_sir:
                best, best_sir = cand, m
        perm = np.array(best)
    idx = (np.arange(s), perm)
    return sdr[idx], sir[idx], sar[idx], perm


def bss_eval_batch(
    ref: np.ndarray, est: np.ndarray, flen: int = _FLEN, per_utt: bool = False
) -> dict:
    """Mean SDR/SIR/SAR over a batch [B, S, T] (aggregation used by eval).
    ``per_utt=True`` adds the per-utterance SDR list (bootstrap-CI input)."""
    sdrs, sirs, sars = [], [], []
    for b in range(ref.shape[0]):
        sdr, sir, sar, _ = bss_eval_sources(ref[b], est[b], flen=flen)
        sdrs.append(sdr.mean())
        sirs.append(sir.mean())
        sars.append(sar.mean())
    out = {
        "sdr": float(np.mean(sdrs)),
        "sir": float(np.mean(sirs)),
        "sar": float(np.mean(sars)),
    }
    if per_utt:
        out["sdr_per_utt"] = [float(s) for s in sdrs]
    return out
