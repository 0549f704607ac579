"""Batched weighted k-means on the device (``amss_tpu/ops/kmeans.py``).

Deterministic farthest-point seeding (first max wins), a fixed number of
weighted Lloyd iterations, an empty cluster keeping its centroid, distances
clamped at 0.  The loop has no host synchronisation: no ``.item()``, no
data-dependent branch.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _pairwise_sq_dist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """||x_n - c_j||² for x [B, N, E], c [B, K, E] -> [B, N, K]."""
    xx = (x * x).sum(dim=-1, keepdim=True)
    cc = (c * c).sum(dim=-1)[:, None, :]
    return torch.clamp(xx - 2.0 * (x @ c.transpose(-1, -2)) + cc, min=0.0)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, E], idx [B] -> x[b, idx[b]] as [B, E]."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def _farthest_point_init(x: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    score = w * (x * x).sum(dim=-1)
    cents = [_take(x, torch.argmax(score, dim=-1))]
    for _ in range(1, k):
        d = _pairwise_sq_dist(x, torch.stack(cents, dim=1))
        mind = d.min(dim=-1).values * w
        cents.append(_take(x, torch.argmax(mind, dim=-1)))
    return torch.stack(cents, dim=1)


def kmeans(
    x: torch.Tensor, k: int, iters: int = 10, weights: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted Lloyd k-means over ``x [B, N, E]`` (or ``[N, E]``).

    weights ``[B, N]`` are nonnegative point weights (0 = ignore).  Returns
    (centroids ``[B, K, E]``, assignments int32 ``[B, N]``)."""
    if x.dim() == 2:
        c, a = kmeans(x[None], k, iters, None if weights is None else weights[None])
        return c[0], a[0]
    if x.dim() != 3:
        raise ValueError(f"kmeans expects [N,E] or [B,N,E], got {tuple(x.shape)}")
    w = torch.ones(x.shape[:2], dtype=x.dtype, device=x.device) if weights is None else weights
    c = _farthest_point_init(x, w, k)
    clusters = torch.arange(k, device=x.device)
    for _ in range(iters):
        assign = torch.argmin(_pairwise_sq_dist(x, c), dim=-1)
        # a comparison, not F.one_hot, which may check its indices on the host
        onehot = (assign[..., None] == clusters).to(x.dtype) * w[..., None]  # [B, N, K]
        counts = onehot.sum(dim=1)  # [B, K]
        sums = onehot.transpose(1, 2) @ x  # [B, K, E]
        new_c = sums / torch.clamp(counts[..., None], min=_EPS)
        c = torch.where(counts[..., None] > _EPS, new_c, c)
    assign = torch.argmin(_pairwise_sq_dist(x, c), dim=-1)
    return c, assign.to(torch.int32)


def soft_assignments(
    x: torch.Tensor, centroids: torch.Tensor, tau: float = 0.25
) -> torch.Tensor:
    """Distance-softmax soft masks ``[B, N, E] x [B, K, E] -> [B, N, K]``; tau
    is relative to the mean point-to-centroid distance."""
    d = _pairwise_sq_dist(x, centroids)
    scale = d.mean(dim=(-2, -1), keepdim=True) + _EPS
    return torch.softmax(-d / (tau * scale), dim=-1)
