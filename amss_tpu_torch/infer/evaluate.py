"""Evaluation (``amss_tpu/infer/evaluate.py``): SI-SDR and SI-SDRi on the
device, BSS-Eval SDR/SIR/SAR and STOI on the host, bootstrap intervals, and
WAV export.

``evaluate_separation`` takes numpy arrays or tensors.  SI-SDR is computed
with ``ops/metrics.py`` on the tensors' device (numpy arrays on the CPU); the
BSS-Eval and STOI columns on host copies, with the numpy code of
``ops/bss_eval.py`` and ``ops/stoi.py``.  When ``mir_eval`` can be imported, a
cross-check column is added, as in the JAX package.
"""

from __future__ import annotations

import os
import wave as wave_mod

import numpy as np
import torch

from amss_tpu_torch.ops.bss_eval import bss_eval_batch
from amss_tpu_torch.ops.metrics import permute_estimates, pit_si_sdr, si_sdr
from amss_tpu_torch.ops.stoi import stoi


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def bootstrap_ci(
    vals: np.ndarray, n_boot: int = 10000, seed: int = 0, level: float = 95.0
) -> dict:
    """Bootstrap interval of the mean of per-utterance scores: the utterances
    resampled with replacement ``n_boot`` times.  Returns mean, lo, hi, the
    standard error and n."""
    v = np.asarray(vals, np.float64)
    rng = np.random.default_rng(seed)
    means = rng.choice(v, size=(n_boot, len(v)), replace=True).mean(axis=1)
    lo, hi = np.percentile(means, [(100 - level) / 2, 100 - (100 - level) / 2])
    return {
        "mean": float(v.mean()),
        "ci_lo": float(lo),
        "ci_hi": float(hi),
        "stderr": float(v.std(ddof=1) / np.sqrt(len(v))),
        "n": int(len(v)),
    }


def evaluate_separation(
    est,  # [B, S, T]
    ref,  # [B, S, T]
    mix,  # [B, T]
    bss: bool = True,
    per_utt: bool = False,
    with_stoi: bool = False,
    sample_rate: int = 8000,
) -> dict:
    """Mean SI-SDR and SI-SDRi (on the device), the BSS-Eval SDR/SIR/SAR
    columns and SDRi against the mixture under the same 512-tap decomposition
    (``bss``), and STOI of the PIT-aligned estimates with its improvement over
    the mixture (``with_stoi``).  ``per_utt=True`` adds per-utterance SI-SDRi
    (and SDRi) lists with bootstrap 95% intervals."""
    est_t = _tensor(est)
    ref_t = _tensor(ref).to(est_t.device)
    mix_t = _tensor(mix).to(est_t.device)
    sep_scores, perm = pit_si_sdr(est_t, ref_t)
    base = si_sdr(mix_t[..., None, :].expand_as(ref_t), ref_t).mean(dim=-1)
    improvement = sep_scores - base
    out = {
        "si_sdr": float(sep_scores.mean()),
        "si_sdr_mix": float(base.mean()),
        "si_sdri": float(improvement.mean()),
        "n": int(est_t.shape[0]),
    }
    if per_utt:
        si_sdri_utt = _host(improvement).astype(np.float64)
        out["si_sdri_ci"] = bootstrap_ci(si_sdri_utt)
        out["si_sdri_per_utt"] = [round(float(v), 3) for v in si_sdri_utt]
    est_np, ref_np, mix_np = _host(est), _host(ref), _host(mix)
    if bss:
        out.update(bss_eval_batch(ref_np, est_np))
        mix_s = np.broadcast_to(mix_np[:, None, :], ref_np.shape)
        out["sdr_mix"] = bss_eval_batch(ref_np, mix_s)["sdr"]
        out["sdri"] = out["sdr"] - out["sdr_mix"]
        if per_utt:
            per_sdr = bss_eval_batch(ref_np, est_np, per_utt=True)
            per_mix = bss_eval_batch(ref_np, mix_s, per_utt=True)
            sdri_utt = np.asarray(per_sdr["sdr_per_utt"]) - np.asarray(per_mix["sdr_per_utt"])
            out["sdri_ci"] = bootstrap_ci(sdri_utt)
            out["sdri_per_utt"] = [round(float(v), 3) for v in sdri_utt]
    aligned = None
    if with_stoi:
        aligned = _host(permute_estimates(est_t, perm))
        vals, base_vals = [], []
        for b in range(ref_np.shape[0]):
            for s in range(ref_np.shape[1]):
                vals.append(stoi(ref_np[b, s], aligned[b, s], sample_rate))
                base_vals.append(stoi(ref_np[b, s], mix_np[b], sample_rate))
        out["stoi"] = float(np.mean(vals))
        out["stoi_mix"] = float(np.mean(base_vals))
        out["stoi_i"] = out["stoi"] - out["stoi_mix"]
    try:  # a host cross-check, where mir_eval is installed
        import mir_eval.separation as mes

        if aligned is None:
            aligned = _host(permute_estimates(est_t, perm))
        sdrs = []
        for b in range(est_np.shape[0]):
            sdr, _, _, _ = mes.bss_eval_sources(ref_np[b], aligned[b], compute_permutation=False)
            sdrs.append(sdr.mean())
        out["mir_eval_sdr"] = float(np.mean(sdrs))
    except ImportError:
        pass
    return out


def write_wav(path: str, x: np.ndarray, sample_rate: int = 8000):
    """16-bit PCM WAV export of a waveform in [-1, 1]."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    x = np.clip(x, -1.0, 1.0)
    pcm = np.round(x * 32767.0).astype(np.int16)
    with wave_mod.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
