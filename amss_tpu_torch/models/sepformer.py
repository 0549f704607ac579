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

DPRNN-TasNet (Luo, Chen, Yoshioka, "Dual-path RNN: efficient long sequence
modeling for time-domain single-channel speech separation", ICASSP 2020,
arXiv:1910.06379; ``DPRNNTasNetModel``, kind ``dprnn_tasnet``) is the same
masker with recurrent paths, SpeechBrain's ``SBRNNBlock`` with
``linear_layer_after_inter_intra``.  For a mixture ``[B, T]``:

    codes = ReLU(frames(mix, L, L/2) @ enc)                  [B, T', N]
    x     = segment(in_proj(GroupNorm(codes)), K, K/2)         [B, P, K, D]
    repeat R times:
        intra = GN(W_a · BLSTM_a(x over K) + b_a) + x
        x     = GN(W_e · BLSTM_e(intra over P) + b_e) + intra
    m     = overlap_add(mask_proj(PReLU(x)))                   [B·S, T', D]
    m     = tanh(output(m)) ⊙ σ(output_gate(m))
    masks = ReLU(out_proj(m))                                  [B, T', N, S]
    out   = dec^T(codes ⊙ masks)                               [B, S, T]

each BLSTM of H cells a direction (gates i, f, g, o), each W a linear
2H -> D with a bias, each GN a GroupNorm of one group (the config's fields:
``DPRNNTasNetModel``).  The padding contract of the recurrent paths:
the valid frame counts come to the host once a call (``prefix_lengths``,
the ``sync.lengths`` span).  An intra row of a chunk of the row's own
segmentation runs all K steps, the segmentation's zeros included, as the
unpadded row does; the rows of chunks >= S_r are not run, and the path's
output there is zero before its linear.  An inter row is a prefix of S_r
chunks, so its backward direction starts at chunk S_r - 1.  The GroupNorms
take their statistics over the valid chunks, and chunks >= S_r are zeroed
after every block.  The BLSTMs take their paths by ``BLSTM.path``; cuDNN is
given each row's length (K for an intra row), so it packs every call.
Spans: ``dprnn.intra`` and ``dprnn.inter`` (one path of one block with its
linear, GroupNorm and residual) inside ``trunk``, with ``rows`` (rows run),
``steps`` (rows × the grid's steps), ``valid_steps`` (the steps of the rows'
own) and ``blstm_path``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from amss_tpu_torch.models.base import SeparatorBase
from amss_tpu_torch.models.blstm import BLSTM, dense, init_dense, prefix_lengths
from amss_tpu_torch.models.dprnn import (
    DropoutKey,
    LayerNorm,
    pad_to_chunks,
    segments,
    split_key,
    unchunk,
)
from amss_tpu_torch.models.dptransformer import TransformerStack, transformer_stack
from amss_tpu_torch.models.front import _to_device
from amss_tpu_torch.ops.metrics import pit_si_sdr
from amss_tpu_torch.utils.config import ModelConfig
from amss_tpu_torch.utils.profiling import (
    DPRNN_INTER,
    DPRNN_INTRA,
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


class RNNPath(nn.Module):
    """One recurrent path of a DPRNN block: SpeechBrain's ``SBRNNBlock`` (a
    BLSTM of ``layers`` layers, D -> 2H) and the linear after it (2H -> D)."""

    def __init__(self, d_model: int, hidden: int, layers: int):
        super().__init__()
        self.lstm = BLSTM(d_model, hidden, layers)
        self.proj = nn.Linear(2 * hidden, d_model)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        self.lstm.init_parameters(generator)
        init_dense(self.proj, generator)


class DualBlock(nn.Module):
    """One repeat: SpeechBrain's ``Dual_Computation_Block`` with its
    GroupNorms (``intra_norm``, ``inter_norm``) and ``path`` (a module class
    built from ``d_model``, ``width``, ``layers``) each way: SepFormer's
    ``TransformerStack`` (no linear layer after the paths), or DPRNN's
    ``RNNPath``."""

    def __init__(self, path: type[nn.Module], d_model: int, width: int, layers: int):
        super().__init__()
        self.intra = path(d_model, width, layers)
        self.intra_norm = LayerNorm(d_model)
        self.inter = path(d_model, width, layers)
        self.inter_norm = LayerNorm(d_model)


class SepFormerMasker(nn.Module):
    """SpeechBrain's ``Dual_Path_Model``: ``norm``, ``in_proj`` (its
    ``conv1d``), ``blocks`` (``DualBlock`` over ``path``), ``prelu``,
    ``mask_proj`` (``conv2d``), ``output`` and ``output_gate``, ``out_proj``
    (``end_conv1x1``)."""

    def __init__(self, n_in: int, d_model: int, width: int, layers: int, repeats: int,
                 speakers: int, path: type[nn.Module]):
        super().__init__()
        self.norm = LayerNorm(n_in)
        self.in_proj = nn.Linear(n_in, d_model, bias=False)
        self.blocks = nn.ModuleList(DualBlock(path, d_model, width, layers)
                                    for _ in range(repeats))
        self.prelu = nn.Parameter(torch.full((1,), 0.25))
        self.mask_proj = nn.Linear(d_model, d_model * speakers)
        self.output = nn.Linear(d_model, d_model)
        self.output_gate = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, n_in, bias=False)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """Dense weights uniform in ±1/√n_in with bias 0, each path's own
        (``TransformerStack``'s, or ``BLSTM.init_parameters``'), norms g = 1
        and b = 0, the PReLU slope 0.25 (``generator`` a CPU generator)."""
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


@dataclass(frozen=True)
class OwnChunks:
    """The chunks of each row's own segmentation on a padded batch's grid:
    ``counts`` S_r (int64 on the host), ``valid [B, P]`` (1 = a chunk of the
    row's own) and ``flat``, the indices b·P + p of those chunks (int64), both
    on the batch's device."""

    counts: torch.Tensor
    valid: torch.Tensor
    flat: torch.Tensor


def own_chunks(frame_mask: torch.Tensor, k: int, p: int) -> OwnChunks:
    """The own chunks of the rows of a padded batch whose prefix ``frame_mask
    [B, T']`` marks the valid frames, on a grid of ``p`` chunks of ``k``
    frames: the mask comes to the host once (``prefix_lengths``)."""
    counts = segments(prefix_lengths(frame_mask), k)
    own = torch.arange(p)[None, :] < counts[:, None]
    dev = frame_mask.device
    return OwnChunks(counts, _to_device(own.to(torch.float32), dev),
                     _to_device(own.reshape(-1).nonzero().reshape(-1), dev))


def inter_rows(own: OwnChunks | None, b: int, k: int, p: int):
    """The inter path's ``b·k`` rows over the ``p`` chunks: (mask ``[b·k, p]``
    on the device or None, lengths ``[b·k]`` on the host).  Each row is a
    prefix of its row's S_r chunks, or all ``p`` where every row is whole."""
    if own is None:
        return None, torch.full((b * k,), p, dtype=torch.int64)
    mask = own.valid[:, None, :].expand(b, k, p).reshape(b * k, p)
    return mask, own.counts.repeat_interleave(k)


def _rnn_block(blk: DualBlock, x: torch.Tensor, own: OwnChunks | None, device) -> torch.Tensor:
    """One DPRNN block over the chunks ``x [B, P, K, D]``; ``own`` the rows'
    own chunks of a padded batch, or None (module docstring)."""
    b, p, k, d = x.shape
    cv = None if own is None else own.valid[..., None]  # [B, P, 1]: a chunk's K frames
    rows = x.reshape(b * p, k, d)
    if own is not None:
        rows = rows.index_select(0, own.flat)
    n, lstm = rows.shape[0], blk.intra.lstm
    with span(DPRNN_INTRA, device=device, rows=n, steps=n * k, valid_steps=n * k,
              blstm_path=lstm.path(rows)):
        y = dense(blk.intra.proj, lstm(rows, lengths=torch.full((n,), k, dtype=torch.int64)))
        if own is not None:
            y = y.new_zeros(b * p, k, d).index_copy(0, own.flat, y)
        intra = group_norm(blk.intra_norm, y.reshape(b, p, k, d), cv) + x
    rows = intra.transpose(1, 2).reshape(b * k, p, d)
    mask, lengths = inter_rows(own, b, k, p)
    lstm = blk.inter.lstm
    with span(DPRNN_INTER, device=device, rows=b * k, steps=b * k * p,
              valid_steps=int(lengths.sum()), blstm_path=lstm.path(rows)):
        y = dense(blk.inter.proj, lstm(rows, mask, lengths=lengths))
        out = group_norm(blk.inter_norm, y.reshape(b, k, p, d).transpose(1, 2), cv) + intra
        if own is not None:  # chunks past a row's own stay exactly zero downstream
            out = out * own.valid[..., None, None]
    return out


class SepFormerModel(SeparatorBase):
    """SepFormer on the port's front, masks and PIT SI-SDR loss, as TasNet's
    (module docstring).  ``KIND`` is the config's kind."""

    KIND = "sepformer"

    def __init__(self, cfg: ModelConfig):
        name = type(self).__name__
        if cfg.kind != self.KIND:
            raise ValueError(f"{name} needs kind {self.KIND!r}, got {cfg.kind!r}")
        if cfg.sep.compute_dtype != "float32":
            raise ValueError(f"{name} runs in float32")
        super().__init__(cfg)

    def _build_trunk(self, sep, f: int) -> None:
        if sep.hidden % sep.heads:
            raise ValueError(f"sep.hidden={sep.hidden} not divisible by heads={sep.heads}")
        self._build_masker(sep, f, TransformerStack)

    def _build_masker(self, sep, f: int, path: type[nn.Module]) -> None:
        if sep.chunk_frames % 2:
            raise ValueError(f"chunks of {sep.chunk_frames} frames cannot overlap by half")
        self.masker = SepFormerMasker(f, sep.hidden, sep.expansion * sep.hidden, sep.blocks,
                                      sep.repeats, self.cfg.nb_speakers, path)

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
        mk, k = self.masker, self.cfg.sep.chunk_frames
        fm = None if frame_mask is None else frame_mask.to(feats.dtype)
        h = dense(mk.in_proj, group_norm(mk.norm, feats, fm))
        if fm is not None:
            h = h * fm[..., None]
        x, _ = pad_to_chunks(h, None, k, hop=k // 2)
        return self._blocks(x, frame_mask, rng)

    def _blocks(self, x: torch.Tensor, frame_mask: torch.Tensor | None,
                rng: DropoutKey | None) -> torch.Tensor:
        """The repeats over the chunks ``x [B, P, K, D]``."""
        sep, mk = self.cfg.sep, self.masker
        b, p = x.shape[:2]
        valid = counts = None
        if frame_mask is not None:
            counts = segments(frame_mask.sum(dim=-1).long(), sep.chunk_frames)
            valid = (torch.arange(p, device=x.device)[None, :] < counts[:, None]).to(x.dtype)
        attrs = dict(chunks=b * p, rows=b,
                     valid_chunks=counts.sum() if counts is not None and keeping() else b * p)
        for blk, r in zip(mk.blocks, split_key(rng, len(mk.blocks))):
            args = (blk, x, valid, sep.heads, sep.dropout, r, attrs, x.device)
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


class DPRNNTasNetModel(SepFormerModel):
    """DPRNN-TasNet: the same masker with recurrent paths (module
    docstring), which run without dropout.  The config's fields:
    ``sep.hidden`` is D, ``sep.blocks`` the layers of each path's BLSTM,
    ``sep.expansion``·``sep.hidden`` its H cells a direction, ``sep.repeats``
    the dual-path blocks and ``sep.chunk_frames`` K; ``sep.heads`` is not
    read."""

    KIND = "dprnn_tasnet"

    def __init__(self, cfg: ModelConfig):
        if cfg.sep.dropout:
            raise ValueError("DPRNNTasNetModel's paths run without dropout")
        super().__init__(cfg)

    def _build_trunk(self, sep, f: int) -> None:
        self._build_masker(sep, f, RNNPath)

    def _blocks(self, x: torch.Tensor, frame_mask: torch.Tensor | None,
                rng: DropoutKey | None) -> torch.Tensor:
        own = None if frame_mask is None else own_chunks(frame_mask, x.shape[2], x.shape[1])
        for blk in self.masker.blocks:
            if self.cfg.sep.remat and torch.is_grad_enabled():
                x = checkpoint(_rnn_block, blk, x, own, x.device, use_reentrant=False)
            else:
                x = _rnn_block(blk, x, own, x.device)
        return x
