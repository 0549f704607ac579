"""The Chimera multitask separator (``amss_tpu/models/chimera.py``): one BLSTM
trunk and two heads, per-bin unit embeddings trained on the deep-clustering
loss, and per-bin softmax masks over the S sources trained on a
permutation-invariant weighted L2 of the masked mixture against the source
magnitudes (msa) or the phase-sensitive targets (psa).  The loss is
``alpha · L_DC + (1 - alpha) · L_MI``, plus ``recon_weight`` times the
mixture's reconstruction error when that is set.  Serving uses the MI head's
masks: no clustering."""

from __future__ import annotations

import itertools

import torch
from torch import nn

from amss_tpu_torch.models.base import _EPS, SeparatorBase
from amss_tpu_torch.models.blstm import dense, init_dense
from amss_tpu_torch.models.dpcl import dpcl_loss
from amss_tpu_torch.models.dprnn import DropoutKey
from amss_tpu_torch.utils.config import ModelConfig


def msa_pit_loss(
    masks: torch.Tensor,  # [B, T', F, S] softmax masks
    mix_codes: torch.Tensor,  # [B, T', F]
    src_codes: torch.Tensor,  # [B, S, T', F]
    w: torch.Tensor,  # [B, T', F]
) -> torch.Tensor:
    """Permutation-invariant weighted L2 between the masked mixture and the
    sources, every permutation of S enumerated (6 for S = 3).  The minimum
    over permutations is ``amin``, whose gradient splits between ties as
    ``jnp.min``'s does."""
    est = masks * mix_codes[..., None]
    s = masks.shape[-1]
    ref = torch.movedim(src_codes, 1, -1)
    # slices, not a list index: a list is copied to the card, which waits for it
    losses = [(w[..., None] * (torch.stack([est[..., j] for j in perm], dim=-1) - ref) ** 2)
              .sum(dim=(1, 2, 3)) for perm in itertools.permutations(range(s))]
    per = torch.amin(torch.stack(losses, dim=-1), dim=-1)  # [B]
    norm = torch.clamp(w.sum(dim=(1, 2)) * s, min=1.0)
    return (per / norm).mean()


class ChimeraModel(SeparatorBase):
    def __init__(self, cfg: ModelConfig):
        if cfg.kind != "chimera":
            raise ValueError(f"ChimeraModel needs kind 'chimera', got {cfg.kind!r}")
        super().__init__(cfg)
        f = cfg.front.feature_dim
        self.proj_embed = nn.Linear(self.trunk_dim, f * cfg.sep.embed_dim)
        self.proj_mask = nn.Linear(self.trunk_dim, f * cfg.nb_speakers)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's distributions: the trunk's, each head uniform in
        ±1/√n_in with bias 0, and a learned front's own.  ``generator`` (a CPU
        generator) cannot replay ``jax.random``."""
        self.init_trunk(generator)
        init_dense(self.proj_embed, generator)
        init_dense(self.proj_mask, generator)
        if hasattr(self.front, "init_parameters"):
            self.front.init_parameters(generator)

    def heads(self, feats: torch.Tensor, frame_mask: torch.Tensor | None = None,
              rng: DropoutKey | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """features [B, T', F] -> (unit embeddings [B, T', F, E], softmax masks
        [B, T', F, S])."""
        c = self.cfg
        h = self.trunk(feats, frame_mask, rng)
        v = dense(self.proj_embed, h, self.compute_dtype)
        v = torch.tanh(v.reshape(*feats.shape, c.sep.embed_dim))
        v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + _EPS)
        m = dense(self.proj_mask, h, self.compute_dtype)
        return v, torch.softmax(m.reshape(*feats.shape, c.nb_speakers), dim=-1)

    def loss(self, sources: torch.Tensor, rng: DropoutKey | None = None
             ) -> tuple[torch.Tensor, dict]:
        """The two heads' losses from the source chunks [B, S, T], mixed on
        the device, weighted by ``chimera_alpha``."""
        c = self.cfg
        mix, codes, aux, src_codes, y, w, src_aux = self.encode_mix_and_sources(
            sources, rng)
        v, masks = self.heads(self.front.features(codes), rng=rng)
        l_dc = dpcl_loss(v, y, w)
        l_mi = msa_pit_loss(masks, codes, self.mi_targets(codes, aux, src_codes, src_aux), w)
        loss = c.chimera_alpha * l_dc + (1.0 - c.chimera_alpha) * l_mi
        metrics = {"chimera_loss": loss, "dc_loss": l_dc, "mi_loss": l_mi}
        if c.recon_weight > 0.0:
            recon = self.front.decode(codes, aux, mix.shape[-1])
            l_rec = ((recon - mix) ** 2).mean()
            metrics["recon_l2"] = l_rec
            loss = loss + c.recon_weight * l_rec
            metrics["chimera_loss"] = loss
        return loss, metrics

    @torch.no_grad()
    def separate(self, mix: torch.Tensor,
                 frame_mask: torch.Tensor | None = None) -> torch.Tensor:
        """mix [B, T] -> separated [B, S, T] through the MI head's masks."""
        codes, aux = self.front.encode(mix)
        _, masks = self.heads(self.front.features(codes), frame_mask)
        return self.apply_masks_and_decode(codes, aux, masks, mix.shape[-1])
