"""Deep-clustering separator (``amss_tpu/models/dpcl.py``): BLSTM -> unit
embedding per time-frequency bin.  Training minimises the weighted affinity
mismatch ||VVᵀ - YYᵀ||²_F in its expanded gram form (E x E and E x S grams
only, never the (T'·F)² affinity); at inference, k-means weighted by voice
activity, distance-softmax masks and resynthesis, all on the device."""

from __future__ import annotations

import torch
from torch import nn

from amss_tpu_torch.models.base import _EPS, SeparatorBase
from amss_tpu_torch.models.blstm import dense, init_dense
from amss_tpu_torch.models.dprnn import DropoutKey
from amss_tpu_torch.models.front import _one_hot_last, vad_weights
from amss_tpu_torch.ops.kernels.kmeans import kmeans, kmeans_launches, soft_assignments
from amss_tpu_torch.utils.config import ModelConfig
from amss_tpu_torch.utils.profiling import CLUSTER, FRONT, HEAD, span


def dpcl_loss(v: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted ||VVᵀ - YYᵀ||²_F through its gram expansion, mean over the batch.

    v [B, T', F, E] unit embeddings, y [B, T', F, S] one-hot targets, w
    [B, T', F] bin weights.  The grams are float32 products (run it with TF32
    off on the card)."""
    b, e, s = v.shape[0], v.shape[-1], y.shape[-1]
    sw = torch.sqrt(torch.clamp(w, min=0.0))[..., None]
    vw = (v * sw).reshape(b, -1, e)  # [B, N, E]
    yw = (y * sw).reshape(b, -1, s)  # [B, N, S]
    vtv = vw.transpose(1, 2) @ vw
    vty = vw.transpose(1, 2) @ yw
    yty = yw.transpose(1, 2) @ yw
    per = (vtv**2).sum(dim=(-2, -1)) - 2.0 * (vty**2).sum(dim=(-2, -1)) + (yty**2).sum(
        dim=(-2, -1))
    norm = torch.clamp(w.reshape(b, -1).sum(dim=-1), min=1.0) ** 2
    return (per / norm).mean()


class DPCLModel(SeparatorBase):
    def __init__(self, cfg: ModelConfig):
        if cfg.kind != "dpcl":
            raise ValueError(f"DPCLModel needs kind 'dpcl', got {cfg.kind!r}")
        super().__init__(cfg)
        self.proj = nn.Linear(self.trunk_dim, cfg.front.feature_dim * cfg.sep.embed_dim)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """Draw the parameters from the JAX package's distributions
        (``init_blstm_stack`` and ``_init_dense``): the LSTM's wx and wh
        uniform in ±1/√hidden, its bias 0 with the forget gate at 1.0; the
        dense head uniform in ±1/√n_in, its bias 0; a learned front's own
        init (``AdaptFrontEnd.init_parameters``).  ``generator`` is a CPU
        generator, so a seed gives the same weights on any device; it cannot
        replay ``jax.random``."""
        self.init_trunk(generator)
        init_dense(self.proj, generator)
        if hasattr(self.front, "init_parameters"):  # a learned front, drawn last
            self.front.init_parameters(generator)

    def loss(self, sources: torch.Tensor, rng: DropoutKey | None = None
             ) -> tuple[torch.Tensor, dict]:
        """Training objective from the source chunks [B, S, T], mixed on the
        device: the DPCL loss, plus ``recon_weight`` times the mixture's
        reconstruction error when that is set.  ``rng`` is the key of dropout
        and the corruptions."""
        mix, codes, aux, _, y, w, _ = self.encode_mix_and_sources(sources, rng)
        v = self.embed(self.front.features(codes), rng=rng)
        l_dc = dpcl_loss(v, y, w)
        metrics = {"dpcl_loss": l_dc}
        loss = l_dc
        if self.cfg.recon_weight > 0.0:
            recon = self.front.decode(codes, aux, mix.shape[-1])
            l_rec = ((recon - mix) ** 2).mean()
            metrics["recon_l2"] = l_rec
            loss = loss + self.cfg.recon_weight * l_rec
        return loss, metrics

    def embed(
        self, feats: torch.Tensor, frame_mask: torch.Tensor | None = None,
        rng: DropoutKey | None = None,
    ) -> torch.Tensor:
        """features [B, T', F] -> unit embeddings [B, T', F, E]."""
        return self.head(self.trunk(feats, frame_mask, rng))

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """trunk output [B, T', trunk_dim] -> unit embeddings [B, T', F, E]."""
        with span(HEAD, device=h.device):
            v = dense(self.proj, h, self.compute_dtype)
            v = torch.tanh(v.reshape(*h.shape[:-1], self.cfg.front.feature_dim,
                                     self.cfg.sep.embed_dim))
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
        with span(FRONT, device=mix.device):
            codes, aux = self.front.encode(mix)
            feats = self.front.features(codes)
        v = self.embed(feats, frame_mask)
        b = v.shape[0]
        with span(CLUSTER, device=mix.device) as rec:
            launched = kmeans_launches()
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
            if rec is not None:  # the k-means kernels' launches, 0 on the CPU
                rec.attrs["kmeans_launches"] = kmeans_launches() - launched
        return self.apply_masks_and_decode(codes, aux, masks, length)
