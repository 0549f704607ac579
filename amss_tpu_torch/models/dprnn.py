"""Layer norm and dropout (``amss_tpu/models/dprnn.py:32-48``), the two
pieces of the dual-path module that the TCN trunk (``models/tcn.py``) uses.

The DPRNN trunk itself (intra- and inter-chunk BLSTMs) is ROADMAP item 19.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm(nn.Module):
    """The parameters of a layer norm over the last axis, with the JAX
    package's names: gain ``g`` (1 at init) and bias ``b`` (0)."""

    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim))
        self.b = nn.Parameter(torch.zeros(dim))


def layer_norm(p: LayerNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``(x - mean) / sqrt(var + eps) * g + b`` over the last axis, with the
    population variance, as ``jnp.var`` takes it (``torch.var``'s default is
    the unbiased one; ``F.layer_norm`` takes the population one)."""
    return F.layer_norm(x, (x.shape[-1],), p.g, p.b, eps)


def dropout(x: torch.Tensor, rate: float, training: bool) -> torch.Tensor:
    """Identity outside training or at rate 0, as the JAX package's dropout
    is without a key.  Training-time dropout raises: ROADMAP item 12d."""
    if training and rate > 0.0:
        raise NotImplementedError(
            f"dropout rate {rate} in training is not ported yet: ROADMAP item 12d")
    return x
