"""The training reference: the batches worked out again from the seed and
the corpus, and plain steps of the configuration's loss (``loss`` of
``reference/<family>.py``, found by the configuration's ``family``) with
autograd, a clip by the global norm and Adam (b1 0.9, b2 0.999, eps 1e-8,
the bias corrections in float32).

``plan`` is a copy of the draw that the configuration's training states
(speaker-disjoint splits of a shuffled speaker list, 70% for training; per
row two distinct speakers, a start uniform in ``[0, n - chunk)`` and gains
uniform in ±2.5 dB, from ``SeedSequence([seed, 0, step, 0])``); ``sources``
reads a plan from the corpus quantised to int16, as the training corpus on
the card holds it.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from reference.dsp import Products

B1, B2, EPS = 0.9, 0.999, 1e-8
MIN_LEAF = 100  # elements; see gaps


def plan(seed: int, n_speakers: int, n_samples: int, step: int, batch: int, s: int,
         chunk: int, gain_db: tuple[float, float] = (-2.5, 2.5)):
    """(speaker indices ``[batch, s]``, starts, gains) of training batch
    ``step``."""
    spk = list(range(n_speakers))
    np.random.default_rng(seed).shuffle(spk)
    n_tr = max(int(n_speakers * 0.7), s)
    n_va = max(int(n_speakers * 0.15), s)
    if n_tr + n_va + s > n_speakers:
        n_tr = n_speakers - n_va - s
    train = spk[:n_tr]
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0, step, 0]))
    gains = (10.0 ** (rng.uniform(*gain_db, size=(batch, s)) / 20.0)).astype(np.float32)
    ids = np.empty((batch, s), np.int64)
    starts = np.empty((batch, s), np.int64)
    for b in range(batch):
        for j, c in enumerate(rng.choice(len(train), size=s, replace=False)):
            ids[b, j] = train[c]
            starts[b, j] = rng.integers(0, max(n_samples - chunk, 1))
    return ids, starts, gains


def sources(corpus: torch.Tensor, ids, starts, gains, chunk: int) -> torch.Tensor:
    """Rows of the float32 corpus ``[n_speakers, n]`` quantised to int16
    (rounded, clipped to ±32767), read at the plan and scaled by its gains:
    ``[batch, s, chunk]``."""
    q = torch.clamp(torch.round(corpus * 32767.0), -32767, 32767)
    idx = torch.as_tensor(starts, device=corpus.device)[..., None] + torch.arange(
        chunk, device=corpus.device)
    rows = q[torch.as_tensor(ids, device=corpus.device)[..., None], idx]
    g = torch.as_tensor(gains, device=corpus.device)
    return rows.to(torch.float32) * (1.0 / 32767.0) * g[..., None]


def steps(weights: dict, batches: list[torch.Tensor], cfg: dict, lr: float, clip: float,
          control: bool = False) -> dict:
    """Plain steps from ``weights`` on ``batches`` (one source tensor each):
    the loss of each step, the clipped gradients of the first, and the
    parameters after the last."""
    mm = Products(control)
    family = importlib.import_module(f"reference.{cfg['family']}")
    params = {n: w.detach().clone().requires_grad_(True) for n, w in weights.items()}
    mu = {n: torch.zeros_like(w) for n, w in weights.items()}
    nu = {n: torch.zeros_like(w) for n, w in weights.items()}
    losses, first = [], None
    for count, src in enumerate(batches, start=1):
        loss = family.loss(src, params, cfg, mm)
        # a parameter that feeds nothing (Conv-TasNet's last residual output) has gradient 0
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
            params.values(), torch.autograd.grad(loss, list(params.values()), allow_unused=True))]
        losses.append(float(loss.detach()))
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        if float(norm) >= clip:
            grads = [g / norm * clip for g in grads]
        if first is None:
            first = {n: g.detach().clone() for n, g in zip(params, grads)}
        bc1 = float(np.float32(1) - np.float32(B1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(B2) ** np.float32(count))
        with torch.no_grad():
            for (n, p), g in zip(params.items(), grads):
                mu[n] = (1 - B1) * g + B1 * mu[n]
                nu[n] = (1 - B2) * (g * g) + B2 * nu[n]
                p.add_((mu[n] / bc1) / (torch.sqrt(nu[n] / bc2) + EPS) * (-lr))
    return {"losses": losses, "grads": first,
            "params": {n: p.detach() for n, p in params.items()}}


def gaps(prog: dict, ref: dict, initial: dict) -> dict:
    """The compared numbers of a program's first steps against the
    reference's.  The first step's loss gap (dB): the later steps' gaps, in
    the diagnostics, carry the noise of Adam's first, sign-like updates of
    gradients that are nought to rounding.  The first clipped gradient's
    worst leaf, |‖g‖ - ‖g_ref‖| over the larger of ‖g_ref‖ and the median
    leaf's, over the leaves of at least ``MIN_LEAF`` elements: a smaller
    leaf's gradient is one sum over a whole batch's frames and filters
    (Conv-TasNet's four smoothing taps: 33M products each), whose rounding
    reads up to 3e-3 where every other leaf reads under 2e-4.  The
    parameters' change after the last step, the same way, over the leaves
    whose reference gradient is at least 1e-3 of the median leaf's (the
    others move by Adam's rounding alone)."""
    step_gaps = [abs(a - b) for a, b in zip(prog["losses"], ref["losses"])]
    gn = {n: float(g.norm()) for n, g in ref["grads"].items()}
    med_g = float(np.median(list(gn.values())))

    def grad_gap(n):
        return abs(float(prog["grads"][n].norm()) - gn[n]) / max(gn[n], med_g)

    grad_worst = max(grad_gap(n) for n in gn if ref["grads"][n].numel() >= MIN_LEAF)
    moved = [n for n in gn if gn[n] >= 1e-3 * med_g]
    dn = {n: float((ref["params"][n] - initial[n]).norm()) for n in moved}
    med_d = float(np.median(list(dn.values())))
    change_gap = max(abs(float((prog["params"][n] - initial[n]).norm()) - dn[n])
                     / max(dn[n], med_d) for n in moved)
    worst = sorted(gn, key=lambda n: -grad_gap(n))[:4]
    return {"train.step1_loss_gap_db": step_gaps[0], "train.grad_gap": grad_worst,
            "train.change_gap": change_gap}, {
        "loss_gap_by_step": step_gaps, "ref_losses": ref["losses"], "median_grad": med_g,
        "worst_grad_leaves": [(n, grad_gap(n), gn[n], int(ref["grads"][n].numel()))
                              for n in worst]}
