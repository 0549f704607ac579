"""The TasNet separator (``amss_tpu/models/tasnet.py``): a learned
filterbank, a trunk, one sigmoid mask per source and code, and synthesis,
trained end to end on the waveform's permutation-invariant SI-SDR.

There is no clustering: ``separate`` is one feed-forward pass.  The mask head
is a ``dense`` in the trunk's compute dtype whose output ``[B, T', F·S]``
reshapes to ``[B, T', F, S]`` (column ``f·S + s``), as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from amss_tpu_torch.models.base import SeparatorBase
from amss_tpu_torch.models.blstm import dense, init_dense
from amss_tpu_torch.models.dprnn import DropoutKey
from amss_tpu_torch.ops.metrics import pit_si_sdr
from amss_tpu_torch.utils.config import ModelConfig
from amss_tpu_torch.utils.profiling import FRONT, HEAD, span


class TasNetModel(SeparatorBase):
    """Mask-inference separator trained on waveform PIT SI-SDR."""

    def __init__(self, cfg: ModelConfig):
        if cfg.kind != "tasnet":
            raise ValueError(f"TasNetModel needs kind 'tasnet', got {cfg.kind!r}")
        super().__init__(cfg)
        self.proj_mask = nn.Linear(self.trunk_dim, cfg.front.feature_dim * cfg.nb_speakers)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's distributions: the trunk's, the mask head uniform
        in ±1/√n_in with bias 0, and a learned front's own.  ``generator`` is
        a CPU generator; it cannot replay ``jax.random``."""
        self.init_trunk(generator)
        init_dense(self.proj_mask, generator)
        if hasattr(self.front, "init_parameters"):
            self.front.init_parameters(generator)

    def masks(self, feats: torch.Tensor, frame_mask: torch.Tensor | None = None,
              rng: DropoutKey | None = None) -> torch.Tensor:
        """features [B, T', F] -> sigmoid masks [B, T', F, S], independent per
        source (the waveform loss, not a sum to one, arbitrates overlap)."""
        h = self.trunk(feats, frame_mask, rng)
        with span(HEAD, device=h.device):
            m = dense(self.proj_mask, h, self.compute_dtype)
            return torch.sigmoid(m.reshape(*feats.shape, self.cfg.nb_speakers))

    def _forward(self, mix: torch.Tensor, frame_mask: torch.Tensor | None = None,
                 rng: DropoutKey | None = None) -> torch.Tensor:
        with span(FRONT, device=mix.device):
            codes, aux = self.front.encode(mix)
            feats = self.front.features(codes)
        m = self.masks(feats, frame_mask, rng)
        return self.apply_masks_and_decode(codes, aux, m, mix.shape[-1])

    def loss(self, sources: torch.Tensor, rng: DropoutKey | None = None
             ) -> tuple[torch.Tensor, dict]:
        """Negative mean PIT SI-SDR of the waveforms separated from the mixture
        of ``sources`` [B, S, T].  Only the mixture is encoded: with the key
        ``rng`` it is ``observed_mix``'s, reverberant or noisy, scored against
        the dry sources.  ``train_min_speakers`` has no effect here, as in the
        JAX package's TasNet."""
        mix = self.observed_mix(sources, rng)
        est = self._forward(mix, rng=rng)
        sdr, _ = pit_si_sdr(est, sources)
        loss = -sdr.mean()
        return loss, {"neg_pit_si_sdr": loss}

    @torch.no_grad()
    def separate(self, mix: torch.Tensor, frame_mask: torch.Tensor | None = None) -> torch.Tensor:
        """mix [B, T] -> separated [B, S, T]; ``frame_mask`` [B, T'] marks the
        valid frames of a padded batch (the norm and the trunk skip the rest)."""
        return self._forward(mix, frame_mask)
