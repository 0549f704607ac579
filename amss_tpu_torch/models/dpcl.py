"""Deep-clustering separator (``amss_tpu/models/dpcl.py``): BLSTM -> unit
embedding per time-frequency bin; at inference, k-means weighted by voice
activity, distance-softmax masks and resynthesis, all on the device."""

from __future__ import annotations

import torch
from torch import nn

from amss_tpu_torch.models.base import _EPS, SeparatorBase
from amss_tpu_torch.models.front import _one_hot_last, vad_weights
from amss_tpu_torch.ops.kmeans import kmeans, soft_assignments
from amss_tpu_torch.utils.config import ModelConfig


class DPCLModel(SeparatorBase):
    def __init__(self, cfg: ModelConfig):
        if cfg.kind != "dpcl":
            raise ValueError(f"DPCLModel needs kind 'dpcl', got {cfg.kind!r}")
        super().__init__(cfg)
        self.proj = nn.Linear(self.trunk_dim, cfg.front.feature_dim * cfg.sep.embed_dim)

    def embed(
        self, feats: torch.Tensor, frame_mask: torch.Tensor | None = None
    ) -> torch.Tensor:
        """features [B, T', F] -> unit embeddings [B, T', F, E]."""
        return self.head(self.trunk(feats, frame_mask))

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """trunk output [B, T', 2H] -> unit embeddings [B, T', F, E]."""
        v = self.proj(h)
        v = torch.tanh(v.reshape(*h.shape[:-1], self.cfg.front.feature_dim, self.cfg.sep.embed_dim))
        return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + _EPS)

    @torch.no_grad()
    def separate(
        self,
        mix: torch.Tensor,
        kmeans_iters: int = 10,
        frame_mask: torch.Tensor | None = None,
        soft_masks: bool = True,
        tau: float = 0.5,
        n_speakers: int | None = None,
    ) -> torch.Tensor:
        """mix [B, T] -> separated [B, S, T].

        frame_mask [B, T'] marks the valid frames of a padded batch: padded
        frames are left out of the norm, the recurrence and the clustering."""
        c = self.cfg
        k = n_speakers or c.nb_speakers
        length = mix.shape[-1]
        codes, aux = self.front.encode(mix)
        v = self.embed(self.front.features(codes), frame_mask)
        b = v.shape[0]
        w = vad_weights(codes, c.vad_threshold_db)
        if frame_mask is not None:
            w = w * frame_mask[..., None]
        flat_v = v.reshape(b, -1, c.sep.embed_dim)
        cent, assign = kmeans(flat_v, k=k, iters=kmeans_iters, weights=w.reshape(b, -1))
        if soft_masks:
            masks = soft_assignments(flat_v, cent, tau=tau)
        else:
            masks = _one_hot_last(assign, k, codes.dtype)
        masks = masks.reshape(*codes.shape, k)
        return self.apply_masks_and_decode(codes, aux, masks, length)
