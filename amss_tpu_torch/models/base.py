"""Separator machinery shared by the heads (``amss_tpu/models/base.py``):
the front, the normalised trunk, the training targets, and mask application.

The port has the JAX package's four trunks, each after the global
(instance), per-channel or cumulative (causal) feature norm: the BLSTM, the
dual-path RNN, the TCN and the dual-path transformer, each in float32 or with
bf16 operands in its products (``compute_dtype="bfloat16"``; the BLSTM's
recurrence then runs ``models/blstm.py::BLSTM.loop_bf16``).  Every head takes
every trunk.  Training-time dropout (``sep.dropout``) and the
train-time corruptions (``train_reverb_rt60``, ``train_noise_snr_db``,
``train_min_speakers``; ``models/front.py``) draw from a ``DropoutKey``
(``models/dprnn.py``), which the ``Trainer`` passes as ``rng``; without one
the loss is the clean one, as the JAX package's is without a key.
"""

from __future__ import annotations

import torch
from torch import nn

from amss_tpu_torch.models.blstm import BLSTM
from amss_tpu_torch.models.dprnn import DPRNN, DropoutKey, dprnn_stack
from amss_tpu_torch.models.dptransformer import DPT, dpt_stack
from amss_tpu_torch.models.front import (
    bin_weights,
    channel_norm,
    corrupt_mix,
    cumulative_norm,
    drop_sources,
    ideal_binary_mask,
    instance_norm,
    make_front,
    psa_targets,
    reverberate_sources,
)
from amss_tpu_torch.models.tcn import TCN, tcn_stack
from amss_tpu_torch.utils.config import ModelConfig
from amss_tpu_torch.utils.profiling import DECODE, TRUNK, span

_EPS = 1e-8


class SeparatorBase(nn.Module):
    """Front + trunk (``blstm``, ``tcn``, ``dprnn`` or ``dpt``); subclasses
    add heads."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.sep.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {cfg.sep.compute_dtype!r}")
        self.cfg = cfg
        self.front = make_front(cfg.front)
        self._build_trunk(cfg.sep, cfg.front.feature_dim)

    def _build_trunk(self, sep, f: int) -> None:
        """The trunk's module of ``sep.trunk`` over ``f`` features, under the
        trunk's name (a model whose separator is no trunk and head, as
        SepFormer's masker, builds its own here)."""
        if sep.trunk not in ("blstm", "tcn", "dprnn", "dpt"):
            raise ValueError(f"unknown trunk {sep.trunk!r}")
        if sep.trunk == "tcn":
            self.tcn = TCN(f, bottleneck=sep.hidden, hidden=sep.expansion * sep.hidden,
                           blocks=sep.blocks, repeats=sep.repeats, kernel=sep.kernel)
        elif sep.trunk == "dprnn":
            self.dprnn = DPRNN(f, d_model=sep.hidden, hidden=sep.hidden, blocks=sep.blocks)
        elif sep.trunk == "dpt":
            if sep.hidden % sep.heads:
                raise ValueError(f"sep.hidden={sep.hidden} not divisible by heads={sep.heads}")
            self.dpt = DPT(f, d_model=sep.hidden, ffn_dim=sep.expansion * sep.hidden,
                           blocks=sep.blocks)
        else:
            self.blstm = BLSTM(f, sep.hidden, sep.layers)

    @property
    def trunk_dim(self) -> int:
        """Width of the trunk's output: ``hidden`` for the TCN (its
        bottleneck) and the dual-path trunks, ``2·hidden`` for the BLSTM."""
        return 2 * self.cfg.sep.hidden if self.cfg.sep.trunk == "blstm" else self.cfg.sep.hidden

    def init_trunk(self, generator: torch.Generator) -> None:
        """Draw the trunk's parameters from the JAX package's distributions."""
        getattr(self, self.cfg.sep.trunk).init_parameters(generator)

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.cfg.sep.compute_dtype == "bfloat16" else torch.float32

    def trunk(self, feats: torch.Tensor, frame_mask: torch.Tensor | None = None,
              rng: DropoutKey | None = None) -> torch.Tensor:
        """features [B, T', F] -> [B, T', trunk_dim]; ``rng`` is the
        training-time dropout key (None: no dropout)."""
        with span(TRUNK, device=feats.device) as rec:
            if rec is not None and self.cfg.sep.trunk == "blstm":
                rec.attrs["blstm_path"] = self.blstm.path(feats, self.cfg.sep.dropout, rng,
                                                          self.compute_dtype)
            return self._trunk(feats, frame_mask, rng)

    def _trunk(self, feats: torch.Tensor, frame_mask: torch.Tensor | None,
               rng: DropoutKey | None) -> torch.Tensor:
        sep = self.cfg.sep
        if sep.feature_norm == "cumulative":
            h, _ = cumulative_norm(feats, frame_mask)
        elif sep.feature_norm == "channel":
            h = channel_norm(feats, frame_mask)
        else:
            h = instance_norm(feats, frame_mask)
        common = dict(compute_dtype=self.compute_dtype, remat=sep.remat,
                      dropout_rate=sep.dropout, rng=rng)
        if sep.trunk == "tcn":
            return tcn_stack(self.tcn, h, mask=frame_mask, blocks_per_repeat=sep.blocks,
                             causal=sep.causal, **common)
        if sep.trunk == "dprnn":
            return dprnn_stack(self.dprnn, h, mask=frame_mask, chunk_frames=sep.chunk_frames,
                               **common)
        if sep.trunk == "dpt":
            return dpt_stack(self.dpt, h, mask=frame_mask, chunk_frames=sep.chunk_frames,
                             heads=sep.heads, **common)
        return self.blstm(h, frame_mask, dropout_rate=sep.dropout, rng=rng,
                          compute_dtype=self.compute_dtype)

    def observed_mix(self, sources: torch.Tensor, rng: DropoutKey | None = None) -> torch.Tensor:
        """The mixture the model observes, from the sources [B, S, T]: with a
        key, each source reverberated (``train_reverb_rt60``), then the sum,
        then noise at a drawn SNR (``train_noise_snr_db``).  Without a key,
        the plain sum."""
        c = self.cfg
        if c.train_reverb_rt60 is not None and rng is not None:
            sources = reverberate_sources(sources, rng, tuple(c.train_reverb_rt60),
                                          tuple(c.train_reverb_drr_db))
        mix = sources.sum(dim=1)
        if c.train_noise_snr_db is not None and rng is not None:
            mix = corrupt_mix(mix, rng, tuple(c.train_noise_snr_db))
        return mix

    def encode_mix_and_sources(self, sources: torch.Tensor, rng: DropoutKey | None = None):
        """Mixing on the device, then analysis of the mixture and the sources.

        sources [B, S, T] -> (mix [B, T], mix codes, aux, source codes
        [B, S, T', F], ideal binary mask Y [B, T', F, S], bin weights
        [B, T', F], source aux).  With a key and ``train_min_speakers``, the
        sources at index >= a drawn count are zeroed first, so the targets
        change too; the mixture is then ``observed_mix``'s."""
        if self.cfg.train_min_speakers is not None and rng is not None:
            sources = drop_sources(sources, rng, self.cfg.train_min_speakers)
        mix = self.observed_mix(sources, rng)
        codes, aux = self.front.encode(mix)
        src_codes, src_aux = self.front.encode(sources)
        y = ideal_binary_mask(src_codes)
        w = bin_weights(codes, self.cfg.weight_kind, self.cfg.vad_threshold_db)
        return mix, codes, aux, src_codes, y, w, src_aux

    def mi_targets(self, codes, aux, src_codes, src_aux) -> torch.Tensor:
        """Regression targets of a mask-inference loss: the source magnitudes
        (``loss_variant`` "msa"), or the truncated phase-sensitive targets
        ("psa") where the front carries the phase."""
        if self.cfg.loss_variant == "psa" and "cos" in aux:
            return psa_targets(codes, aux, src_codes, src_aux)
        return src_codes

    def loss_from_batch(self, batch: dict, rng: DropoutKey | None = None):
        """The trainer's entry point: ``(loss, metrics)`` from a batch holding
        ``sources`` [B, S, T]; ``rng`` is the key of dropout and the
        corruptions."""
        return self.loss(batch["sources"], rng=rng)

    def apply_masks_and_decode(
        self,
        codes: torch.Tensor,  # [B, T', F]
        aux: dict,
        masks: torch.Tensor,  # [B, T', F, S]
        length: int,
    ) -> torch.Tensor:
        """Masked codes per speaker -> waveforms [B, S, T].  Tensors of
        ``aux`` gain the speaker axis; anything else (the adaptive front's
        ``t_frames``) passes through."""
        with span(DECODE, device=codes.device):
            masked = torch.movedim(codes[..., None] * masks, -1, 1)  # [B, S, T', F]
            aux_b = {k: v[:, None] if isinstance(v, torch.Tensor) else v for k, v in aux.items()}
            return self.front.decode(masked, aux_b, length)
