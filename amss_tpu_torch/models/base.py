"""Separator machinery shared by the heads (``amss_tpu/models/base.py``):
the front, the normalised BLSTM trunk, and mask application.

Slice 1 ports the BLSTM trunk with the global (instance) feature norm in
float32; other trunks, norms and compute types raise until their slice.
"""

from __future__ import annotations

import torch
from torch import nn

from amss_tpu_torch.models.blstm import BLSTM
from amss_tpu_torch.models.front import instance_norm, make_front
from amss_tpu_torch.utils.config import ModelConfig

_EPS = 1e-8


class SeparatorBase(nn.Module):
    """Front + BLSTM trunk; subclasses add heads."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        sep = cfg.sep
        if sep.trunk != "blstm":
            raise NotImplementedError(f"trunk {sep.trunk!r} is not ported yet")
        if sep.compute_dtype != "float32":
            raise NotImplementedError(f"compute_dtype {sep.compute_dtype!r} is not ported yet")
        if sep.feature_norm in ("channel", "cumulative"):
            raise NotImplementedError(f"feature_norm {sep.feature_norm!r} is not ported yet")
        self.cfg = cfg
        self.front = make_front(cfg.front)
        self.blstm = BLSTM(cfg.front.feature_dim, sep.hidden, sep.layers)

    @property
    def trunk_dim(self) -> int:
        return 2 * self.cfg.sep.hidden

    def trunk(self, feats: torch.Tensor, frame_mask: torch.Tensor | None = None) -> torch.Tensor:
        """features [B, T', F] -> [B, T', 2H]."""
        return self.blstm(instance_norm(feats, frame_mask), frame_mask)

    def apply_masks_and_decode(
        self,
        codes: torch.Tensor,  # [B, T', F]
        aux: dict,
        masks: torch.Tensor,  # [B, T', F, S]
        length: int,
    ) -> torch.Tensor:
        """Masked codes per speaker -> waveforms [B, S, T]."""
        masked = torch.movedim(codes[..., None] * masks, -1, 1)  # [B, S, T', F]
        aux_b = {k: v[:, None] for k, v in aux.items()}
        return self.front.decode(masked, aux_b, length)
