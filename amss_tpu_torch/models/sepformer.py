"""SepFormer (Subakan, Ravanelli, Cornell, Bronzi, Zhong, "Attention is all
you need in speech separation", ICASSP 2021, arXiv:2010.13154) as
SpeechBrain's released recipe builds it (``recipes/WSJ0Mix/separation/
hparams/sepformer.yaml`` over ``speechbrain/lobes/models/dual_path.py``).

The conv front (``models/front.py::ConvFrontEnd``) encodes the mixture.  The
masker is SpeechBrain's ``Dual_Path_Model``: a GroupNorm of one group over
channels and time, a bias-free 1x1 conv N -> D, the published segmentation
(chunks of K frames at hop K/2, ``models/dprnn.py::pad_to_chunks``), then
``repeats`` blocks, each an intra stack over the K frames of every chunk and
an inter stack over the chunks at every position, each stack ``blocks``
pre-LN transformer layers (``models/dptransformer.py::TransformerStack``)
followed by a GroupNorm, with the skip around the intra path and inter +
intra as the block's output.  The mask head: PReLU, a 1x1 conv D -> D·S on
the chunks, overlap-add, a tanh·sigmoid gate, a bias-free 1x1 conv D -> N
and ReLU masks.  The masked codes are decoded by the transposed conv.

Widths come from the config: N, L and the stride from the front; D =
``sep.hidden``, ``sep.heads``, the feed-forward ``sep.expansion``·D,
``sep.blocks`` layers a stack, ``sep.repeats`` and K = ``sep.chunk_frames``.

The padding contract: each row of a padded batch (``frame_mask``, a prefix
of V_r valid frames) gives what the model gives on that row alone.  The
row's own segmentation has S_r = ``segments(V_r)`` chunks, the first S_r of
the batch's grid, as both grids start K/2 before frame 0 and share the hop.
The frames >= V_r are zeroed after the input conv, so those chunks hold what
the row's own hold, the zeros of its own segmentation included; every
GroupNorm takes its statistics over the row's valid frames, or over the K
frames of its valid chunks; the inter stack masks the keys of chunks >= S_r
(additively, as ``models/dptransformer.py`` says why); chunks >= S_r are
zeroed after every block; the masks of frames >= V_r are zero.

Spans: ``sepformer.intra`` and ``sepformer.inter`` (a stack of one repeat
each, its GroupNorm and residual) inside ``trunk``, with ``chunks`` (rows ×
the grid's chunks), ``valid_chunks`` (Σ_r S_r) and ``rows``; the mask head
under ``head``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from amss_tpu_torch.models.base import SeparatorBase
from amss_tpu_torch.models.blstm import dense, init_dense
from amss_tpu_torch.models.dprnn import (
    DropoutKey,
    LayerNorm,
    pad_to_chunks,
    segments,
    split_key,
    unchunk,
)
from amss_tpu_torch.models.dptransformer import TransformerStack, transformer_stack
from amss_tpu_torch.ops.metrics import pit_si_sdr
from amss_tpu_torch.utils.config import ModelConfig
from amss_tpu_torch.utils.profiling import (
    FRONT,
    HEAD,
    SEPFORMER_INTER,
    SEPFORMER_INTRA,
    keeping,
    span,
)

LN_EPS = 1e-6  # SpeechBrain's LayerNorm in its TransformerEncoder
GN_EPS = 1e-8  # its select_norm("ln"), a GroupNorm of one group


def group_norm(p: LayerNorm, x: torch.Tensor, valid: torch.Tensor | None = None,
               eps: float = GN_EPS) -> torch.Tensor:
    """A GroupNorm of one group: ``x [B, ..., D]`` normalised per row over
    every other axis with the population variance, then the gain and bias of
    each channel D.  ``valid`` (x's shape less D, or broadcast to it; 1 =
    counted) restricts the statistics."""
    dims = tuple(range(1, x.dim()))
    if valid is None:
        mu = x.mean(dim=dims, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=dims, keepdim=True)
    else:
        m = valid.to(x.dtype)[..., None]
        n = m.sum(dim=dims, keepdim=True) * (x[0].numel() // m[0].numel())
        mu = (x * m).sum(dim=dims, keepdim=True) / n
        var = (m * (x - mu) ** 2).sum(dim=dims, keepdim=True) / n
    return (x - mu) / torch.sqrt(var + eps) * p.g + p.b


class DualBlock(nn.Module):
    """One repeat: SpeechBrain's ``Dual_Computation_Block`` with transformer
    stacks, its GroupNorms (``intra_norm``, ``inter_norm``) and no linear
    layer after the paths."""

    def __init__(self, d_model: int, ffn_dim: int, layers: int):
        super().__init__()
        self.intra = TransformerStack(d_model, ffn_dim, layers)
        self.intra_norm = LayerNorm(d_model)
        self.inter = TransformerStack(d_model, ffn_dim, layers)
        self.inter_norm = LayerNorm(d_model)


class SepFormerMasker(nn.Module):
    """SpeechBrain's ``Dual_Path_Model``: ``norm``, ``in_proj`` (its
    ``conv1d``), ``blocks``, ``prelu``, ``mask_proj`` (``conv2d``),
    ``output`` and ``output_gate``, ``out_proj`` (``end_conv1x1``)."""

    def __init__(self, n_in: int, d_model: int, ffn_dim: int, layers: int, repeats: int,
                 speakers: int):
        super().__init__()
        self.norm = LayerNorm(n_in)
        self.in_proj = nn.Linear(n_in, d_model, bias=False)
        self.blocks = nn.ModuleList(DualBlock(d_model, ffn_dim, layers) for _ in range(repeats))
        self.prelu = nn.Parameter(torch.full((1,), 0.25))
        self.mask_proj = nn.Linear(d_model, d_model * speakers)
        self.output = nn.Linear(d_model, d_model)
        self.output_gate = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, n_in, bias=False)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """Dense weights uniform in ±1/√n_in with bias 0, norms g = 1 and
        b = 0, the PReLU slope 0.25 (``generator`` a CPU generator)."""
        self.norm.reset()
        init_dense(self.in_proj, generator)
        for blk in self.blocks:
            blk.intra.init_parameters(generator)
            blk.inter.init_parameters(generator)
            blk.intra_norm.reset()
            blk.inter_norm.reset()
        self.prelu.fill_(0.25)
        for layer in (self.mask_proj, self.output, self.output_gate, self.out_proj):
            init_dense(layer, generator)


def _block(blk: DualBlock, x, valid, heads, rate, rng, attrs, device):
    """One repeat over the chunks ``x [B, P, K, D]``; ``valid [B, P]`` (1 = a
    chunk of the row's own segmentation) or None."""
    b, p, k, d = x.shape
    r1, r2 = split_key(rng, 2)
    cv = None if valid is None else valid[..., None]  # [B, P, 1]: a chunk's K frames
    with span(SEPFORMER_INTRA, device=device, **attrs):
        intra = transformer_stack(blk.intra, x.reshape(b * p, k, d), None, heads, eps=LN_EPS,
                                  rate=rate, rng=r1).reshape(b, p, k, d)
        intra = group_norm(blk.intra_norm, intra, cv) + x
    with span(SEPFORMER_INTER, device=device, **attrs):
        keys = None if valid is None else valid[:, None, :].expand(b, k, p).reshape(b * k, p)
        inter = transformer_stack(blk.inter, intra.transpose(1, 2).reshape(b * k, p, d), keys,
                                  heads, eps=LN_EPS, rate=rate, rng=r2)
        out = group_norm(blk.inter_norm, inter.reshape(b, k, p, d).transpose(1, 2), cv) + intra
        if valid is not None:  # chunks past a row's own stay exactly zero downstream
            out = out * valid[..., None, None]
    return out


class SepFormerModel(SeparatorBase):
    """SepFormer on the port's front, masks and PIT SI-SDR loss, as TasNet's
    (module docstring)."""

    def __init__(self, cfg: ModelConfig):
        if cfg.kind != "sepformer":
            raise ValueError(f"SepFormerModel needs kind 'sepformer', got {cfg.kind!r}")
        if cfg.sep.compute_dtype != "float32":
            raise ValueError("SepFormerModel runs in float32")
        super().__init__(cfg)

    def _build_trunk(self, sep, f: int) -> None:
        if sep.hidden % sep.heads:
            raise ValueError(f"sep.hidden={sep.hidden} not divisible by heads={sep.heads}")
        if sep.chunk_frames % 2:
            raise ValueError(f"chunks of {sep.chunk_frames} frames cannot overlap by half")
        self.masker = SepFormerMasker(f, sep.hidden, sep.expansion * sep.hidden, sep.blocks,
                                      sep.repeats, self.cfg.nb_speakers)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """The masker's and the front's distributions (``generator`` a CPU
        generator)."""
        self.masker.init_parameters(generator)
        self.front.init_parameters(generator)

    def _trunk(self, feats: torch.Tensor, frame_mask: torch.Tensor | None,
               rng: DropoutKey | None) -> torch.Tensor:
        """codes ``[B, T', N]`` -> the last block's chunks ``[B, P, K, D]``,
        those past a row's own zero: the masker up to its head."""
        sep, mk = self.cfg.sep, self.masker
        k = sep.chunk_frames
        fm = None if frame_mask is None else frame_mask.to(feats.dtype)
        h = dense(mk.in_proj, group_norm(mk.norm, feats, fm))
        if fm is not None:
            h = h * fm[..., None]
        x, _ = pad_to_chunks(h, None, k, hop=k // 2)
        b, p = x.shape[:2]
        valid = counts = None
        if frame_mask is not None:
            counts = segments(frame_mask.sum(dim=-1).long(), k)
            valid = (torch.arange(p, device=x.device)[None, :] < counts[:, None]).to(x.dtype)
        attrs = dict(chunks=b * p, rows=b,
                     valid_chunks=counts.sum() if counts is not None and keeping() else b * p)
        for blk, r in zip(mk.blocks, split_key(rng, len(mk.blocks))):
            args = (blk, x, valid, sep.heads, sep.dropout, r, attrs, feats.device)
            if sep.remat and torch.is_grad_enabled():
                # the block draws its dropout masks from its key (models/dprnn.py)
                x = checkpoint(_block, *args, use_reentrant=False, preserve_rng_state=False)
            else:
                x = _block(*args)
        return x

    def masks(self, feats: torch.Tensor, frame_mask: torch.Tensor | None = None,
              rng: DropoutKey | None = None) -> torch.Tensor:
        """codes [B, T', N] -> ReLU masks [B, T', N, S], zero at padded frames."""
        x = self.trunk(feats, frame_mask, rng)
        mk, s = self.masker, self.cfg.nb_speakers
        with span(HEAD, device=x.device):
            b, p, k, d = x.shape
            m = dense(mk.mask_proj, torch.where(x >= 0, x, mk.prelu * x))  # [B, P, K, D·S]
            m = m.reshape(b, p, k, s, d).permute(0, 3, 1, 2, 4).reshape(b * s, p, k, d)
            m = unchunk(m, feats.shape[1], hop=k // 2)  # [B·S, T', D]
            m = torch.tanh(dense(mk.output, m)) * torch.sigmoid(dense(mk.output_gate, m))
            m = torch.relu(dense(mk.out_proj, m))
            m = m.reshape(b, s, *feats.shape[1:]).permute(0, 2, 3, 1)
            if frame_mask is not None:
                m = m * frame_mask.to(m.dtype)[..., None, None]
            return m

    def _forward(self, mix: torch.Tensor, frame_mask: torch.Tensor | None = None,
                 rng: DropoutKey | None = None) -> torch.Tensor:
        with span(FRONT, device=mix.device):
            codes, aux = self.front.encode(mix)
        m = self.masks(codes, frame_mask, rng)
        return self.apply_masks_and_decode(codes, aux, m, mix.shape[-1])

    def loss(self, sources: torch.Tensor, rng: DropoutKey | None = None
             ) -> tuple[torch.Tensor, dict]:
        """Negative mean PIT SI-SDR of the waveforms separated from the mixture
        of ``sources`` [B, S, T] (``observed_mix``'s with the key ``rng``)."""
        est = self._forward(self.observed_mix(sources, rng), rng=rng)
        sdr, _ = pit_si_sdr(est, sources)
        loss = -sdr.mean()
        return loss, {"neg_pit_si_sdr": loss}

    @torch.no_grad()
    def separate(self, mix: torch.Tensor, frame_mask: torch.Tensor | None = None) -> torch.Tensor:
        """mix [B, T] -> separated [B, S, T]; ``frame_mask`` [B, T'] marks the
        valid frames of a padded batch (the padding contract)."""
        return self._forward(mix, frame_mask)
