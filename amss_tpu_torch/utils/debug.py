"""Numerical-safety rails (``amss_tpu/utils/debug.py``).

* ``nan_guard()``: for the block, every operator's tensor outputs are checked
  as it returns, and the first non-finite one raises ``FloatingPointError``
  naming the operator (the counterpart of ``jax.debug_nans``).  Each check
  waits for the device, so it is for debug runs.
* ``check_finite(tree)``: a host-side check over a tree of tensors or arrays
  (metrics, parameters).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


class _NanGuard(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and not bool(torch.isfinite(t).all())):
                raise FloatingPointError(
                    f"non-finite output of {func}: nan={int(torch.isnan(t).sum())}, "
                    f"inf={int(torch.isinf(t).sum())}")
        return out


@contextlib.contextmanager
def nan_guard():
    with _NanGuard():
        yield


def check_finite(tree, where: str = "") -> None:
    leaves, _ = tree_flatten(tree)
    for i, leaf in enumerate(leaves):
        arr = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        if not np.isfinite(arr).all():
            raise FloatingPointError(
                f"non-finite value in {where or 'tree'} leaf {i}: "
                f"nan={np.isnan(arr).sum()}, inf={np.isinf(arr).sum()}")
