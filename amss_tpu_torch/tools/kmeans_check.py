"""The k-means kernels against the plain version, on one device.

``compare_with_plain(x, w, k)`` runs the operators (``ops/kernels/kmeans.py``)
and the plain version (``ops/kmeans.py``) on the same tensors and returns
what differs; ``failures(result, tol)`` says which of it breaks the limits.
``chip_smoke.py``'s phase 2c and the card tests of
``tests/test_torch_kmeans_kernel.py`` share both, and ``blobs`` makes their
data: well-separated blobs, or the same blobs scaled to unit norm as deep
clustering's embeddings are.  On unit norm every point's ``w·||x||²`` ties,
so there the first seed is the plain version's only if the kernels take the
plain version's rounding of that score.

The limits: the kernels' sums run in other orders than cuBLAS's, so
centroids (relative to their norm) and masks agree within ``tol``, and
assignments wherever a point's two nearest distances differ by more than
``tol`` relative, since only there can rounding not flip them.  The first
seed, and two runs of the kernels, agree bit for bit.
"""

from __future__ import annotations

import torch

from amss_tpu_torch.ops import kmeans as plain
from amss_tpu_torch.ops.kernels.kmeans import (
    SOFT_LAUNCHES,
    fit_launches,
    kmeans,
    kmeans_launches,
    soft_assignments,
)


def blobs(b: int, n: int, e: int, k: int, gen: torch.Generator, pad_share: float = 0.023,
          unit: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(x [b, n, e], w [b, n]) on ``gen``'s device: k blobs a row, centres 3
    apart in each coordinate on average, noise 1, each point scaled to unit
    norm if ``unit``; the last ``pad_share`` of each row at weight 0 (a
    bucket's padding) and the rest 0/1 at random."""
    dev = gen.device
    centres = 3.0 * torch.randn(b, k, e, generator=gen, device=dev)
    which = torch.randint(0, k, (b, n), generator=gen, device=dev)
    x = torch.gather(centres, 1, which[..., None].expand(b, n, e))
    x = x + torch.randn(b, n, e, generator=gen, device=dev)
    if unit:
        x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    w = (torch.rand(b, n, generator=gen, device=dev) > 0.2).float()
    w[:, n - int(pad_share * n):] = 0.0
    return x.contiguous(), w


def near_ties(x: torch.Tensor, c: torch.Tensor, rel: float) -> torch.Tensor:
    """Points whose two nearest distances to ``c`` lie within ``rel`` of each
    other (relative to the larger), by the plain version's distances."""
    d = plain._pairwise_sq_dist(x, c)
    if d.shape[-1] == 1:
        return torch.zeros(d.shape[:2], dtype=torch.bool, device=d.device)
    two = torch.topk(d, 2, dim=-1, largest=False).values
    return (two[..., 1] - two[..., 0]) <= rel * two[..., 1].clamp(min=1e-30)


def compare_with_plain(x: torch.Tensor, w: torch.Tensor, k: int, iters: int = 10,
                       tau: float = 0.5, tol: float = 1e-5) -> dict:
    """The operators against the plain version on ``x``'s device: whether the
    first seed and all k seeds are the plain version's, the largest centroid
    error relative to its norm, the assignments that differ off near ties
    (``tol`` relative), the masks' largest error, whether a second run is
    bit-identical, and the kernels' launches of one fit and its masks."""
    pc, pa = plain.kmeans(x, k, iters, w)
    pm = plain.soft_assignments(x, pc, tau)
    before = kmeans_launches()
    c, a = kmeans(x, k, iters, w)
    m = soft_assignments(x, c, tau)
    launched = kmeans_launches() - before
    c2, a2 = kmeans(x, k, iters, w)
    m2 = soft_assignments(x, c2, tau)
    first = torch.equal(kmeans(x, 1, 0, w)[0], plain.kmeans(x, 1, 0, w)[0])
    seeds = torch.equal(kmeans(x, k, 0, w)[0], plain.kmeans(x, k, 0, w)[0])
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    rel = (torch.linalg.vector_norm(c - pc, dim=-1)
           / torch.linalg.vector_norm(pc, dim=-1).clamp(min=1e-30)).max()
    off = ~near_ties(x, pc, tol)
    return {"first_seed_equal": bool(first), "seeds_equal": bool(seeds),
            "centroid_rel": float(rel),
            "assign_diff": int(((a != pa) & off).sum()),
            "near_ties": int((~off).sum()),
            "mask_err": float((m - pm).abs().max()),
            "repeats": bool(torch.equal(c, c2) and torch.equal(a, a2) and torch.equal(m, m2)),
            "launches": launched, "tol": tol}


def failures(r: dict, k: int, iters: int = 10) -> list[str]:
    """What of ``compare_with_plain``'s result ``r`` breaks its limits; the
    launches are those of one fit of ``k`` clusters and its masks."""
    tol = r["tol"]
    want = fit_launches(k, iters) + SOFT_LAUNCHES
    checks = {"first seed not the plain version's": not r["first_seed_equal"],
              f"centroids {r['centroid_rel']:.3e} > {tol:g}": not r["centroid_rel"] <= tol,
              f"masks {r['mask_err']:.3e} > {tol:g}": not r["mask_err"] <= tol,
              f"{r['assign_diff']} assignments differ off near ties": r["assign_diff"] != 0,
              "a second run differs": not r["repeats"],
              f"{r['launches']} launches, want {want}": r["launches"] != want}
    return [what for what, failed in checks.items() if failed]
