"""Weighted k-means and its soft masks on the card (``csrc/kmeans.cu``).

``kmeans(x, k, iters, weights)`` and ``soft_assignments(x, centroids, tau)``
take the plain versions' arguments (``ops/kmeans.py``) and go through the
operators ``amss::kmeans`` and ``amss::soft_assignments`` (``torch.library``,
so an exported program keeps each as one node).  A CUDA tensor goes to the
hand-written kernels: the whole fit (farthest-point seeding, ``iters`` Lloyd
steps, the final assignment) in one C call, each step one pass over the
embeddings, and the masks in a second; a CPU tensor goes to the plain
version; anything else raises.  The arithmetic is the plain version's:
float32, the same seeding, ``iters`` steps and no early stop, the first
maximum and the first minimum on ties, the same empty-cluster rule and mask
scale.  The first seed's score, ``w·||x||²``, is the plain version's own
PyTorch expression on the same device, so the first seed is the plain
version's bit for bit: on embeddings of unit norm (deep clustering's) every
point ties there, and the rounding alone picks it.  Elsewhere the kernels'
sums run in other orders than cuBLAS's, so a point whose two nearest
distances tie within rounding may take the other cluster.

The wrapper takes float32 contiguous ``x [B, N, E]`` (or ``[N, E]``) with
E <= 64 and K <= 4, and raises ``ValueError`` for anything else, on every
device.  ``kmeans.launches`` counts the kernels' launches, both operators',
those of exported programs included: ``fit_launches(k, iters)`` a fit and
``SOFT_LAUNCHES`` a set of masks.
"""

from __future__ import annotations

import torch

from amss_tpu_torch.ops.kernels.build import c_ints, check_device, check_launch, load_library
from amss_tpu_torch.ops.kmeans import kmeans as kmeans_ref
from amss_tpu_torch.ops.kmeans import soft_assignments as soft_assignments_ref

MAX_E = 64
MAX_K = 4
THREADS = 256  # points a tile of the pass kernel (csrc/kmeans.cu)
SOFT_LAUNCHES = 2


def fit_launches(k: int, iters: int) -> int:
    """The kernels a fit launches: a pass and a copy for each seed, a pass
    and an update for each Lloyd step, the final assignment."""
    return 2 * k + 2 * iters + 1


def _check(name: str, x: torch.Tensor, k: int, **others: torch.Tensor) -> None:
    """Raise ``ValueError`` unless the kernels take ``x`` [B, N, E] with ``k``
    clusters and ``others`` beside it."""
    if x.dim() != 3:
        raise ValueError(f"{name} takes x [B, N, E], got {tuple(x.shape)}")
    b, n, e = x.shape
    if not (1 <= e <= MAX_E and 1 <= k <= MAX_K and n >= 1):
        raise ValueError(f"{name} takes 1 <= E <= {MAX_E}, 1 <= K <= {MAX_K} and N >= 1, "
                         f"got E {e}, K {k}, N {n}")
    for what, t in {"x": x, **others}.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{name} takes float32 tensors, {what} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors, {what} is not")
        if t.device != x.device:
            raise ValueError(f"{name}: {what} on {t.device} but x on {x.device}")
    check_device(x.device, name)


def _tiles(n: int) -> int:
    return -(-n // THREADS)


def _check_fit(x: torch.Tensor, weights: torch.Tensor, k: int, iters: int) -> None:
    _check("kmeans", x, k, weights=weights)
    if weights.shape != x.shape[:2]:
        raise ValueError(f"kmeans: weights {tuple(weights.shape)} for x {tuple(x.shape)}")
    if iters < 0:
        raise ValueError(f"kmeans: iters must be >= 0, got {iters}")


def _check_soft(x: torch.Tensor, centroids: torch.Tensor) -> None:
    k = centroids.shape[1] if centroids.dim() == 3 else 0
    _check("soft_assignments", x, k, centroids=centroids)
    if centroids.shape != (x.shape[0], k, x.shape[2]):
        raise ValueError(f"soft_assignments: centroids {tuple(centroids.shape)} for x "
                         f"{tuple(x.shape)}")


def first_seed_score(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The first seed's score ``[B, N]``, written as the plain version's
    ``_farthest_point_init`` writes it, so that it rounds as that does."""
    return w * (x * x).sum(dim=-1)


def _launch_fit(x: torch.Tensor, weights: torch.Tensor, k: int, iters: int):
    _check_fit(x, weights, k, iters)
    b, n, e = x.shape
    tiles = _tiles(n)
    dev = x.device
    cent = torch.empty((b, k, e), dtype=torch.float32, device=dev)
    assign = torch.empty((b, n), dtype=torch.int32, device=dev)
    part = torch.empty(b * k * (e + 1) * tiles, dtype=torch.float32, device=dev)
    seed_val = torch.empty(b * tiles, dtype=torch.float32, device=dev)
    seed_idx = torch.empty(b * tiles, dtype=torch.int32, device=dev)
    score = first_seed_score(x, weights)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.amss_kmeans(
            x.data_ptr(), weights.data_ptr(), score.data_ptr(), cent.data_ptr(),
            assign.data_ptr(),
            part.data_ptr(), seed_val.data_ptr(), seed_idx.data_ptr(),
            *c_ints(b, n, e, k, iters), torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, "kmeans", err)
    kmeans.launches += fit_launches(k, iters)
    return cent, assign


def _launch_soft(x: torch.Tensor, centroids: torch.Tensor, tau: float) -> torch.Tensor:
    _check_soft(x, centroids)
    b, n, e = x.shape
    k = centroids.shape[1]
    dev = x.device
    masks = torch.empty((b, n, k), dtype=torch.float32, device=dev)
    part = torch.empty(b * _tiles(n), dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.amss_soft_assignments(
            x.data_ptr(), centroids.data_ptr(), masks.data_ptr(), part.data_ptr(),
            *c_ints(b, n, e, k), float(tau), torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, "soft_assignments", err)
    kmeans.launches += SOFT_LAUNCHES
    return masks


# The kernels as operators, so that ``torch.export`` keeps each as one node
# and a loaded program launches them: the CPU runs the plain versions, CUDA
# the kernels (counted in ``kmeans.launches``), each after the same checks,
# and the fake implementations give the outputs' shapes without touching a
# device.
@torch.library.custom_op("amss::kmeans", mutates_args=(), device_types="cpu")
def kmeans_op(x: torch.Tensor, weights: torch.Tensor, k: int,
              iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    _check_fit(x, weights, k, iters)
    return kmeans_ref(x, k, iters, weights)


kmeans_op.register_kernel("cuda")(_launch_fit)


@kmeans_op.register_fake
def _(x, weights, k, iters):
    return (x.new_empty((x.shape[0], k, x.shape[2])),
            x.new_empty(x.shape[:2], dtype=torch.int32))


@torch.library.custom_op("amss::soft_assignments", mutates_args=(), device_types="cpu")
def soft_assignments_op(x: torch.Tensor, centroids: torch.Tensor, tau: float) -> torch.Tensor:
    _check_soft(x, centroids)
    return soft_assignments_ref(x, centroids, tau)


soft_assignments_op.register_kernel("cuda")(_launch_soft)


@soft_assignments_op.register_fake
def _(x, centroids, tau):
    return x.new_empty((x.shape[0], x.shape[1], centroids.shape[1]))


def kmeans(
    x: torch.Tensor, k: int, iters: int = 10, weights: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted Lloyd k-means over ``x [B, N, E]`` (or ``[N, E]``) as the plain
    version: weights ``[B, N]`` nonnegative (0 = ignore, None = all 1).
    Returns (centroids ``[B, K, E]``, assignments int32 ``[B, N]``)."""
    if x.dim() == 2:
        c, a = kmeans(x[None], k, iters, None if weights is None else weights[None])
        return c[0], a[0]
    if x.dim() != 3:
        raise ValueError(f"kmeans expects [N,E] or [B,N,E], got {tuple(x.shape)}")
    w = torch.ones(x.shape[:2], dtype=x.dtype, device=x.device) if weights is None else weights
    return kmeans_op(x, w, k, iters)


kmeans.launches = 0


def soft_assignments(
    x: torch.Tensor, centroids: torch.Tensor, tau: float = 0.25
) -> torch.Tensor:
    """Distance-softmax soft masks ``[B, N, E] x [B, K, E] -> [B, N, K]`` as the
    plain version: tau is relative to the mean point-to-centroid distance
    over the row's N·K entries."""
    return soft_assignments_op(x, centroids, tau)


def kmeans_launches() -> int:
    """``kmeans.launches`` now: callers read the count through this, so that
    a stand-in for ``kmeans`` patched into their module leaves it readable."""
    return kmeans.launches
