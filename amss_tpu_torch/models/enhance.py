"""The enhancement stage (``amss_tpu/models/enhance.py``): a small BLSTM
that refines a frozen base separator's estimates.

For each source the refiner sees ``[mixture ; estimate]`` log features,
instance-normed (sources are folded into the batch, ``B·S`` rows), and emits
a per-bin logit delta added to the log of the base's energy share; a softmax
over the sources renormalises.  The delta projection starts near zero
(uniform in ±1e-3), so at init the refined masks are the shares of the
re-encoded first-pass estimates.

The base (any separator, or another enhancer when stages are stacked) runs
under ``torch.no_grad()`` in eval mode with ``requires_grad=False`` on its
parameters.  It is held outside this module's parameter tree, so the
trainable tree, and the checkpoint, is ``{"separator": {"blstm", "proj"}}``
as in the JAX package; ``to()`` moves it along.  The front is the base's,
adopted wholesale, as there: a recipe front that differs warns, and so does
a TasNet base, which the JAX package measured to regress.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch
from torch import nn

from amss_tpu_torch.models.base import _EPS, SeparatorBase
from amss_tpu_torch.models.blstm import BLSTM, dense, init_dense
from amss_tpu_torch.models.chimera import msa_pit_loss
from amss_tpu_torch.models.front import instance_norm, psa_targets, vad_weights
from amss_tpu_torch.ops.metrics import pit_si_sdr
from amss_tpu_torch.utils.config import ModelConfig


class EnhancerModel(nn.Module):
    """Refines a frozen base separator's estimates."""

    def __init__(self, cfg: ModelConfig, base: nn.Module):
        super().__init__()
        if cfg.kind != "enhance":
            raise ValueError(f"EnhancerModel needs kind 'enhance', got {cfg.kind!r}")
        if cfg.front != base.cfg.front:
            warnings.warn(
                f"enhance recipe front ({cfg.front.kind}, feature_dim={cfg.front.feature_dim}) "
                f"differs from base run's ({base.cfg.front.kind}, "
                f"feature_dim={base.cfg.front.feature_dim}); using the base's front.")
        if base.cfg.kind == "tasnet":
            warnings.warn(
                "enhancement over a waveform-trained (tasnet) base measurably REGRESSES it "
                "(round-2: base +9.87 dB -> enh +8.70/+9.23); refine clustering bases "
                "(dpcl/l41/chimera) only", stacklevel=2)
        self.cfg = dataclasses.replace(cfg, front=base.cfg.front)
        base.eval().requires_grad_(False)
        self._frozen = [base]  # a list: not a submodule, so not in the parameter tree
        f = self.front.cfg.feature_dim
        self.blstm = BLSTM(2 * f, cfg.sep.hidden, cfg.sep.layers)
        self.proj = nn.Linear(2 * cfg.sep.hidden, f)

    @property
    def base(self) -> nn.Module:
        return self._frozen[0]

    @property
    def compute_dtype(self) -> torch.dtype:
        """The refiner's: its BLSTM and its projection run in it; the base
        runs in its own."""
        return torch.bfloat16 if self.cfg.sep.compute_dtype == "bfloat16" else torch.float32

    @property
    def front(self) -> nn.Module:
        """The base chain's front (a stacked stage's base's, recursively)."""
        return self.base.front

    def _apply(self, fn, *args, **kwargs):
        self.base._apply(fn, *args, **kwargs)
        return super()._apply(fn, *args, **kwargs)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's distributions: the BLSTM's, and the delta
        projection uniform in ±1e-3 with bias 0.  ``generator`` (a CPU
        generator) cannot replay ``jax.random``."""
        self.blstm.init_parameters(generator)
        init_dense(self.proj, generator, scale=1e-3)

    def refined_masks(self, mix_codes: torch.Tensor, est_codes: torch.Tensor,
                      frame_mask: torch.Tensor | None = None) -> torch.Tensor:
        """mix codes [B, T', F], estimate codes [B, S, T', F] -> masks
        [B, T', F, S]; ``frame_mask`` [B, T'] leaves padded frames out of the
        norm and the recurrence."""
        b, s, t, f = est_codes.shape
        estf = torch.log(est_codes + _EPS)
        mixf = torch.log(mix_codes + _EPS)[:, None].expand_as(estf)
        pairs = torch.cat([mixf, estf], dim=-1).reshape(b * s, t, 2 * f)
        fm = None
        if frame_mask is not None:
            fm = frame_mask[:, None].expand(b, s, t).reshape(b * s, t)
        h = self.blstm(instance_norm(pairs, fm), fm, compute_dtype=self.compute_dtype)
        delta = torch.movedim(dense(self.proj, h, self.compute_dtype).reshape(b, s, t, f), 1, -1)
        base_logits = torch.log(torch.movedim(est_codes, 1, -1) + _EPS)
        return torch.softmax(base_logits + delta, dim=-1)

    def _base_separate_codes(self, mix: torch.Tensor, frame_mask=None):
        """The frozen first pass: mixture -> (mix codes, aux, estimate codes
        [B, S, T', F])."""
        with torch.no_grad():
            est = self.base.separate(mix, frame_mask=frame_mask)
            codes, aux = self.front.encode(mix)
            est_codes, _ = self.front.encode(est)
        return codes, aux, est_codes

    # the separators' masking and decode, which reads nothing but ``front``
    apply_masks_and_decode = SeparatorBase.apply_masks_and_decode

    def loss(self, sources: torch.Tensor, rng=None) -> tuple[torch.Tensor, dict]:
        """The refiner's loss on the mixture of ``sources`` [B, S, T]: PIT
        SI-SDR through the decoder ("sisdr"), else the permutation-invariant
        masked-magnitude loss against the sources ("msa") or the
        phase-sensitive targets ("psa").  The refiner has no dropout and the
        mixture no corruption, so the key ``rng`` changes nothing."""
        mix = sources.sum(dim=1)
        codes, aux, est_codes = self._base_separate_codes(mix)
        masks = self.refined_masks(codes, est_codes)
        if self.cfg.loss_variant == "sisdr":
            est = self.apply_masks_and_decode(codes, aux, masks, sources.shape[-1])
            sdr, _ = pit_si_sdr(est, sources)
            loss = -sdr.mean()
            return loss, {"enhance_neg_sisdr": loss}
        with torch.no_grad():
            src_codes, src_aux = self.front.encode(sources)
        w = vad_weights(codes, self.cfg.vad_threshold_db)
        ref = src_codes
        if self.cfg.loss_variant == "psa" and "cos" in aux:
            ref = psa_targets(codes, aux, src_codes, src_aux)
        loss = msa_pit_loss(masks, codes, ref, w)
        return loss, {"enhance_mi": loss}

    def loss_from_batch(self, batch: dict, rng=None):
        return self.loss(batch["sources"], rng)

    @torch.no_grad()
    def separate(self, mix: torch.Tensor, frame_mask: torch.Tensor | None = None) -> torch.Tensor:
        """Two stages: the frozen base, then the refined soft masks on the
        mixture -> [B, S, T]."""
        codes, aux, est_codes = self._base_separate_codes(mix, frame_mask)
        masks = self.refined_masks(codes, est_codes, frame_mask)
        return self.apply_masks_and_decode(codes, aux, masks, mix.shape[-1])
