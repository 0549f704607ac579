"""Max-pool with argmax and argmax-unpool over time (``amss_tpu/ops/pooling.py``).

* The tie-break is the first maximum: ``torch.argmax`` documents that it
  returns the first maximal index, as ``jnp.argmax`` does.
* Indices are the offset inside the window (int32 in ``[0, pool)``), not
  global indices.
* Values come from ``max``, not from a gather at the argmax.
* Unpool is branchless: a one-hot ``(slot == idx)`` product, no scatter.
"""

from __future__ import annotations

import torch


def max_pool_argmax(x: torch.Tensor, pool: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Pool ``x[..., T, N]`` over time -> (values ``[..., T/pool, N]``, idx int32).

    T must be divisible by ``pool``."""
    *lead, t, n = x.shape
    if t % pool != 0:
        raise ValueError(f"time length {t} not divisible by pool {pool}")
    xr = x.reshape(*lead, t // pool, pool, n)
    idx = torch.argmax(xr, dim=-2).to(torch.int32)
    return torch.amax(xr, dim=-2), idx


def unpool_argmax(vals: torch.Tensor, idx: torch.Tensor, pool: int) -> torch.Tensor:
    """The inverse of ``max_pool_argmax``: each value at its argmax slot,
    zeros elsewhere.  vals, idx ``[..., T/pool, N]`` -> ``[..., T, N]``."""
    *lead, tp, n = vals.shape
    slots = torch.arange(pool, dtype=torch.int32, device=vals.device).reshape(pool, 1)
    onehot = (slots == idx[..., None, :]).to(vals.dtype)  # [..., T/pool, pool, N]
    return (onehot * vals[..., None, :]).reshape(*lead, tp * pool, n)
