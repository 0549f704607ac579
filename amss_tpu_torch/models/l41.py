"""The L41 speaker-centroid separator (``amss_tpu/models/l41.py``): BLSTM
embeddings per time-frequency bin and a learned centroid per training
speaker, trained with the sigmoid cross-entropy of ``<v_tf, c_s>`` against
the ideal binary mask of the speakers in each mixture.

Serving has two paths: enrolled speakers (their ids known) get sigmoid masks
from their centroids, with no clustering; otherwise k-means over the
embeddings gives hard one-hot masks.  The embeddings are tanh without an L2
normalisation (they keep their scale)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from amss_tpu_torch.models.base import SeparatorBase
from amss_tpu_torch.models.blstm import dense, init_dense
from amss_tpu_torch.models.dprnn import DropoutKey
from amss_tpu_torch.models.front import _one_hot_last, vad_weights
from amss_tpu_torch.ops.kernels.kmeans import kmeans
from amss_tpu_torch.utils.config import ModelConfig


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's formula: ``-y·log σ(x) - (1 - y)·log σ(-x)``, elementwise."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


class L41Model(SeparatorBase):
    def __init__(self, cfg: ModelConfig):
        if cfg.kind != "l41":
            raise ValueError(f"L41Model needs kind 'l41', got {cfg.kind!r}")
        if cfg.n_train_speakers <= 0:
            raise ValueError("L41 needs n_train_speakers > 0 (centroid table size)")
        super().__init__(cfg)
        self.proj = nn.Linear(self.trunk_dim, cfg.front.feature_dim * cfg.sep.embed_dim)
        self.centroids = nn.Parameter(torch.zeros(cfg.n_train_speakers, cfg.sep.embed_dim))

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's distributions: the trunk's, the embedding head
        uniform in ±1/√n_in with bias 0, centroids N(0, 0.5²), and a learned
        front's own.  ``generator`` (a CPU generator) cannot replay
        ``jax.random``."""
        self.init_trunk(generator)
        init_dense(self.proj, generator)
        self.centroids.copy_(torch.randn(self.centroids.shape, generator=generator) * 0.5)
        if hasattr(self.front, "init_parameters"):
            self.front.init_parameters(generator)

    def embed(self, feats: torch.Tensor, frame_mask: torch.Tensor | None = None,
              rng: DropoutKey | None = None) -> torch.Tensor:
        """features [B, T', F] -> tanh embeddings [B, T', F, E]."""
        h = self.trunk(feats, frame_mask, rng)
        v = dense(self.proj, h, self.compute_dtype)
        return torch.tanh(v.reshape(*feats.shape, self.cfg.sep.embed_dim))

    def _logits(self, v: torch.Tensor, speaker_ids: torch.Tensor) -> torch.Tensor:
        """``<v_tf, c_s>`` for the mixture's speakers: [B, T', F, E] x the
        centroids of speaker_ids [B, S] -> [B, T', F, S]."""
        cent = self.centroids[speaker_ids.long()]  # [B, S, E]
        return torch.einsum("btfe,bse->btfs", v, cent)

    def loss(self, sources: torch.Tensor, speaker_ids: torch.Tensor,
             rng: DropoutKey | None = None) -> tuple[torch.Tensor, dict]:
        """sources [B, S, T] and their global train-set ids [B, S] -> the
        weighted sigmoid cross-entropy over the bins, divided by
        ``max(Σw · S, 1)``."""
        _, codes, _, _, y, w, _ = self.encode_mix_and_sources(sources, rng)
        v = self.embed(self.front.features(codes), rng=rng)
        bce = sigmoid_binary_cross_entropy(self._logits(v, speaker_ids), y)
        loss = (bce * w[..., None]).sum() / torch.clamp(w.sum() * y.shape[-1], min=1.0)
        return loss, {"l41_loss": loss}

    def loss_from_batch(self, batch: dict, rng: DropoutKey | None = None):
        """The trainer's entry point: the batch carries ``speaker_ids``."""
        return self.loss(batch["sources"], batch["speaker_ids"], rng)

    @torch.no_grad()
    def separate(self, mix: torch.Tensor, speaker_ids: torch.Tensor | None = None,
                 kmeans_iters: int = 10,
                 frame_mask: torch.Tensor | None = None) -> torch.Tensor:
        """mix [B, T] -> separated [B, S, T].  Enrolled (``speaker_ids`` [B,
        S]): sigmoid masks from the speakers' centroids.  Blind: k-means over
        the embeddings, weighted by voice activity, and hard one-hot masks."""
        c = self.cfg
        codes, aux = self.front.encode(mix)
        v = self.embed(self.front.features(codes), frame_mask)
        if speaker_ids is not None:
            masks = torch.sigmoid(self._logits(v, speaker_ids))
        else:
            b = v.shape[0]
            w = vad_weights(codes, c.vad_threshold_db)
            if frame_mask is not None:
                w = w * frame_mask[..., None]
            _, assign = kmeans(v.reshape(b, -1, c.sep.embed_dim), k=c.nb_speakers,
                               iters=kmeans_iters, weights=w.reshape(b, -1))
            masks = _one_hot_last(assign, c.nb_speakers, codes.dtype).reshape(
                *codes.shape, c.nb_speakers)
        return self.apply_masks_and_decode(codes, aux, masks, mix.shape[-1])
