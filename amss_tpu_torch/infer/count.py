"""Blind speaker counting from deep-clustering embeddings
(``amss_tpu/infer/count.py``), and separation at the counted number of
speakers (``amss_tpu/cli.py:361-393``, ``separate --num-speakers auto``).

For ideal embeddings the weighted Gram ``G = Vᵀdiag(w)V / Σw`` (E x E) has
one significant eigenvalue per speaker, each about that speaker's share of
the weight; the count is the largest relative gap of G's descending
spectrum.  ``torch.linalg.eigh`` runs LAPACK on the CPU and cuSOLVER on the
card, whose eigenvalues differ in their last bits, so a near-tie between two
gaps can count differently on the two.
"""

from __future__ import annotations

import numpy as np
import torch

from amss_tpu_torch.infer.streaming import StreamingSeparator
from amss_tpu_torch.models.front import bin_weights
from amss_tpu_torch.utils.device import resolve_device

_EPS = 1e-8


def eigengap_counts(v: torch.Tensor, w: torch.Tensor, k_max: int = 4) -> torch.Tensor:
    """Per-utterance speaker counts in [1, k_max] (int32 [B]) from unit
    embeddings ``v [B, N, E]`` and bin weights ``w [B, N]`` (0 = ignore):
    ``argmax_j (λ_j - λ_{j+1}) / λ_j`` over the top ``k_max + 1``
    eigenvalues of the weighted Gram, descending and clamped at 0.  Needs
    ``E >= k_max + 1``."""
    e = v.shape[-1]
    if e < k_max + 1:
        raise ValueError(f"k_max={k_max} needs embed_dim >= {k_max + 1}, got {e}")
    g = (v * w[..., None]).transpose(1, 2) @ v
    g = g / torch.clamp(w.sum(dim=-1), min=_EPS)[:, None, None]
    g = 0.5 * (g + g.transpose(-1, -2))  # exact symmetry for eigh
    lam = torch.clamp(torch.linalg.eigh(g).eigenvalues.flip(-1), min=0.0)
    top = lam[..., : k_max + 1]
    gaps = (top[..., :-1] - top[..., 1:]) / (top[..., :-1] + _EPS)
    return (torch.argmax(gaps, dim=-1) + 1).to(torch.int32)


@torch.no_grad()
def count_speakers(model, mix: torch.Tensor, k_max: int = 4,
                   frame_mask: torch.Tensor | None = None,
                   weight_kind: str = "vad") -> torch.Tensor:
    """The number of speakers in each mixture ``mix [B, T]`` (int32 [B]),
    for a model with an embedding head: ``embed`` (deep clustering, L41) or
    the first output of ``heads`` (Chimera).  ``weight_kind`` weights the
    Gram's bins as ``models/front.py::bin_weights`` does ("vad" is what
    clustering uses)."""
    c = model.cfg
    codes, _ = model.front.encode(mix)
    feats = model.front.features(codes)
    if hasattr(model, "embed"):
        v = model.embed(feats, frame_mask)
    elif hasattr(model, "heads"):
        v = model.heads(feats, frame_mask)[0]
    else:
        raise TypeError(f"{type(model).__name__} has no embedding head; speaker-count "
                        "estimation needs a clustering model (dpcl/chimera)")
    w = bin_weights(codes, weight_kind, c.vad_threshold_db)
    if frame_mask is not None:
        w = w * frame_mask[..., None]
    b = v.shape[0]
    return eigengap_counts(v.reshape(b, -1, c.sep.embed_dim), w.reshape(b, -1), k_max=k_max)


def separate_auto_k(model, waves: list[np.ndarray], k_max: int = 4, weight_kind: str = "vad",
                    sample_rate: int = 8000, device=None, **sep_kw):
    """``separate --num-speakers auto`` of the JAX package's CLI
    (``amss_tpu/cli.py:361-393``): count each utterance alone (one count read
    back to the host per utterance), then serve each group of one count
    through its own ``StreamingSeparator(..., separate_kwargs={"n_speakers":
    k})``.  Returns (counts, separated ``[k, T]`` arrays in input order, the
    largest RTF of the groups).  ``sep_kw`` goes to each separator."""
    if not (hasattr(model, "embed") or hasattr(model, "heads")):
        raise TypeError(f"auto-k needs an embedding model (dpcl/chimera), got "
                        f"{type(model).__name__}")
    device = resolve_device(device)
    model.to(device).eval()
    ks = [int(count_speakers(model, torch.from_numpy(np.asarray(w, np.float32)[None]).to(device),
                             k_max=k_max, weight_kind=weight_kind)[0]) for w in waves]
    ests: list = [None] * len(waves)
    rtfs = []
    for k in sorted(set(ks)):
        idx = [i for i, ki in enumerate(ks) if ki == k]
        sep = StreamingSeparator(model, sample_rate=sample_rate, device=device,
                                 separate_kwargs={"n_speakers": k}, **sep_kw)
        for i, est in zip(idx, sep.separate_all([waves[i] for i in idx])):
            ests[i] = est
        rtfs.append(sep.meter.rtf)
    return ks, ests, max(rtfs)
