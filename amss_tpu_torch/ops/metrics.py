"""Separation metrics on tensors (``amss_tpu/ops/metrics.py``): SI-SDR, its
permutation-invariant form, the estimates reordered by the best permutation,
and the improvement over the mixture."""

from __future__ import annotations

import itertools

import torch

_EPS = 1e-8


def si_sdr(est: torch.Tensor, ref: torch.Tensor, zero_mean: bool = True) -> torch.Tensor:
    """Scale-invariant SDR in dB.  est/ref: ``[..., T]`` -> ``[...]``."""
    if zero_mean:
        est = est - est.mean(dim=-1, keepdim=True)
        ref = ref - ref.mean(dim=-1, keepdim=True)
    dot = (est * ref).sum(dim=-1, keepdim=True)
    energy = (ref * ref).sum(dim=-1, keepdim=True)
    proj = dot / (energy + _EPS) * ref
    noise = est - proj
    ratio = (proj * proj).sum(dim=-1) / ((noise * noise).sum(dim=-1) + _EPS)
    return 10.0 * torch.log10(ratio + _EPS)


def pit_si_sdr(est: torch.Tensor, ref: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Permutation-invariant SI-SDR over ``[..., S, T]``: (best mean-over-sources
    score ``[...]``, index of the best of ``itertools.permutations(range(S))``)."""
    perms = list(itertools.permutations(range(est.shape[-2])))
    # each permutation by slices: a list index would copy it to the device
    # and wait for the copy
    scores = torch.stack(
        [si_sdr(torch.stack([est[..., i, :] for i in p], dim=-2), ref).mean(dim=-1)
         for p in perms], dim=-1)
    best = torch.argmax(scores, dim=-1)
    return scores.max(dim=-1).values, best


def permute_estimates(est: torch.Tensor, perm_idx: torch.Tensor) -> torch.Tensor:
    """Reorder ``est[..., S, T]`` by ``perm_idx[...]``, the index into
    ``itertools.permutations(range(S))`` that ``pit_si_sdr`` returns."""
    perms = list(itertools.permutations(range(est.shape[-2])))
    out = est
    # each permutation by slices, picked where it is the index, as in pit_si_sdr
    for j, p in enumerate(perms):
        cand = torch.stack([est[..., i, :] for i in p], dim=-2)
        out = torch.where((perm_idx == j)[..., None, None], cand, out)
    return out


def sdr_improvement(est: torch.Tensor, ref: torch.Tensor, mix: torch.Tensor) -> torch.Tensor:
    """PIT SI-SDR of ``est`` minus that of the mixture, ``[..., S, T]`` -> ``[...]``."""
    sep, _ = pit_si_sdr(est, ref)
    base = si_sdr(mix[..., None, :].expand_as(ref), ref).mean(dim=-1)
    return sep - base
