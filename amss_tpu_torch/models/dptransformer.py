"""The dual-path transformer trunk (``amss_tpu/models/dptransformer.py``):
the frame axis in P chunks of K frames as in ``models/dprnn.py``, each block
an intra-chunk and an inter-chunk pre-LN transformer layer (self-attention,
then a ReLU feed-forward, each with dropout and a residual), with a
sinusoidal position code added before each attention.  SepFormer's paths
(``models/sepformer.py``) are ``TransformerStack``s of these layers without
that code, which ``transformer_stack`` adds once, and with a final norm.

The padding mask is additive, ``logits + (mask - 1)·1e9`` in float32, as in
the JAX package.  A query row whose keys are all padding then has logits that
all round to -1e9: its softmax is uniform and finite, and the end-of-block
mask zeroes the row.  A boolean mask or -inf would give NaN there, and NaN·0
is NaN, so the attention is the explicit product and softmax, not a fused
library kernel.  The parameter names are the JAX package's (``in_proj``,
``blocks.<i>.{intra,inter}.{ln1, attn.{wq,wk,wv,wo}, ln2, ffn.{w1,w2}}``).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from amss_tpu_torch.models.blstm import dense, init_dense
from amss_tpu_torch.models.dprnn import (
    DropoutKey,
    LayerNorm,
    dropout,
    layer_norm,
    pad_to_chunks,
    split_key,
    unchunk,
)

_NEG = -1e9  # the additive logit of a padded key


class Attention(nn.Module):
    def __init__(self, d_model: int):
        super().__init__()
        self.wq = nn.Linear(d_model, d_model)
        self.wk = nn.Linear(d_model, d_model)
        self.wv = nn.Linear(d_model, d_model)
        self.wo = nn.Linear(d_model, d_model)


class FeedForward(nn.Module):
    def __init__(self, d_model: int, ffn_dim: int):
        super().__init__()
        self.w1 = nn.Linear(d_model, ffn_dim)
        self.w2 = nn.Linear(ffn_dim, d_model)


class TransformerPath(nn.Module):
    def __init__(self, d_model: int, ffn_dim: int):
        super().__init__()
        self.ln1 = LayerNorm(d_model)
        self.attn = Attention(d_model)
        self.ln2 = LayerNorm(d_model)
        self.ffn = FeedForward(d_model, ffn_dim)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """Layer norms g = 1 and b = 0, each dense uniform in ±1/√n_in with
        bias 0, drawn in the order q, k, v, o, w1, w2."""
        self.ln1.reset()
        self.ln2.reset()
        for layer in (self.attn.wq, self.attn.wk, self.attn.wv, self.attn.wo, self.ffn.w1,
                      self.ffn.w2):
            init_dense(layer, generator)


class DPTBlock(nn.Module):
    def __init__(self, d_model: int, ffn_dim: int):
        super().__init__()
        self.intra = TransformerPath(d_model, ffn_dim)
        self.inter = TransformerPath(d_model, ffn_dim)


class DPT(nn.Module):
    """``in_proj`` (F -> D) and ``blocks`` of intra and inter paths
    (``init_dpt``)."""

    def __init__(self, n_in: int, d_model: int, ffn_dim: int, blocks: int):
        super().__init__()
        self.in_proj = nn.Linear(n_in, d_model)
        self.blocks = nn.ModuleList(DPTBlock(d_model, ffn_dim) for _ in range(blocks))

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's distributions: each dense uniform in ±1/√n_in
        with bias 0, layer norms g = 1 and b = 0.  ``generator`` (a CPU
        generator) cannot replay ``jax.random``."""
        init_dense(self.in_proj, generator)
        for blk in self.blocks:
            blk.intra.init_parameters(generator)
            blk.inter.init_parameters(generator)


def sinusoid(length: int, dim: int, device=None, interleaved: bool = False) -> torch.Tensor:
    """The fixed sinusoidal position code ``[length, dim]`` (float32): the
    sines, then the cosines, zero padded in its last column for an odd
    ``dim``; ``interleaved``, sine and cosine alternate (columns 2i and
    2i + 1) at SpeechBrain's frequencies ``exp(-2i·ln(10000)/dim)``, as its
    ``PositionalEncoding`` makes them (``dim`` even)."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    if interleaved:
        two_i = torch.arange(0, dim, 2, dtype=torch.float32, device=device)
        ang = pos * torch.exp(two_i * -(math.log(10000.0) / dim))
        return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(length, dim)
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2.0 * i / dim)
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return torch.nn.functional.pad(pe, (0, dim - pe.shape[-1]))


def _operand(x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """An attention product's operand: rounded to bf16 in bfloat16 (the
    product then sums in float32, as ``preferred_element_type`` does)."""
    return x if compute_dtype == torch.float32 else x.to(compute_dtype).float()


def mha(attn: Attention, x: torch.Tensor, mask: torch.Tensor | None, heads: int,
        compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Multi-head self-attention: x ``[N, L, D]``, mask ``[N, L]`` (1 = valid
    key) -> ``[N, L, D]``; logits and softmax in float32, padded keys at
    -1e9."""
    n, l, d = x.shape
    dh = d // heads
    q, k, v = (_operand(dense(w, x, compute_dtype).reshape(n, l, heads, dh), compute_dtype)
               for w in (attn.wq, attn.wk, attn.wv))
    logits = torch.einsum("nqhd,nkhd->nhqk", q, k) / math.sqrt(dh)
    if mask is not None:
        logits = logits + (mask[:, None, None, :].to(torch.float32) - 1.0) * (-_NEG)
    a = _operand(torch.softmax(logits, dim=-1), compute_dtype)
    o = torch.einsum("nhqk,nkhd->nqhd", a, v).reshape(n, l, d)
    return dense(attn.wo, o, compute_dtype)


def _path(p: TransformerPath, x, mask, heads, compute_dtype, rate, rng, pe: bool = True,
          eps: float = 1e-5):
    """x + Attn(LN(x + pe)), then + FFN(LN(.)): ``[N, L, D]`` -> ``[N, L, D]``;
    without ``pe`` the plain pre-LN layer x + Attn(LN(x)), as a
    ``TransformerStack``'s layers are."""
    r1, r2 = split_key(rng, 2)
    y = x + sinusoid(x.shape[1], x.shape[2], x.device) if pe else x
    h = x + dropout(mha(p.attn, layer_norm(p.ln1, y, eps), mask, heads, compute_dtype),
                    rate, r1)
    f = dense(p.ffn.w2, torch.relu(dense(p.ffn.w1, layer_norm(p.ln2, h, eps), compute_dtype)),
              compute_dtype)
    return h + dropout(f, rate, r2)


class TransformerStack(nn.Module):
    """``layers`` pre-LN layers and a final ``norm``: SpeechBrain's
    ``SBTransformerBlock`` (its ``TransformerEncoder`` with
    ``normalize_before``), each path of a SepFormer block."""

    def __init__(self, d_model: int, ffn_dim: int, layers: int):
        super().__init__()
        self.layers = nn.ModuleList(TransformerPath(d_model, ffn_dim) for _ in range(layers))
        self.norm = LayerNorm(d_model)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """Each layer's (``TransformerPath.init_parameters``), the final norm
        g = 1 and b = 0 (``generator`` a CPU generator)."""
        for path in self.layers:
            path.init_parameters(generator)
        self.norm.reset()


def transformer_stack(st: TransformerStack, x: torch.Tensor, mask: torch.Tensor | None,
                      heads: int, compute_dtype: torch.dtype = torch.float32,
                      eps: float = 1e-6, rate: float = 0.0,
                      rng: DropoutKey | None = None) -> torch.Tensor:
    """The interleaved position code added once to x ``[N, L, D]``, the
    layers, the final norm: -> ``[N, L, D]``; ``mask [N, L]`` (1 = valid key)
    as ``mha``'s.  ``eps`` 1e-6 is SpeechBrain's."""
    h = x + sinusoid(x.shape[1], x.shape[2], x.device, interleaved=True)
    for layer, r in zip(st.layers, split_key(rng, len(st.layers))):
        h = _path(layer, h, mask, heads, compute_dtype, rate, r, pe=False, eps=eps)
    return layer_norm(st.norm, h, eps)


def _block(bp: DPTBlock, h, m_g, heads, compute_dtype, rate, rng):
    b, p, k, d = h.shape
    r1, r2 = split_key(rng, 2)
    mi = None if m_g is None else m_g.reshape(b * p, k)
    h = _path(bp.intra, h.reshape(b * p, k, d), mi, heads, compute_dtype, rate,
              r1).reshape(b, p, k, d)
    ht = h.transpose(1, 2).reshape(b * k, p, d)
    mt = None if m_g is None else m_g.transpose(1, 2).reshape(b * k, p)
    h = _path(bp.inter, ht, mt, heads, compute_dtype, rate, r2).reshape(b, k, p, d)
    h = h.transpose(1, 2)
    if m_g is not None:  # padded positions stay exactly zero downstream
        h = h * m_g[..., None]
    return h


def dpt_stack(
    dpt: DPT,
    x: torch.Tensor,  # [B, T', F]
    mask: torch.Tensor | None = None,  # [B, T'] 1 = valid
    chunk_frames: int = 16,
    heads: int = 4,
    compute_dtype: torch.dtype = torch.float32,
    remat: bool = True,
    dropout_rate: float = 0.0,
    rng: DropoutKey | None = None,
) -> torch.Tensor:
    """-> ``[B, T', D]``, with ``dprnn_stack``'s chunking and padding
    contract (padded frames exactly zero on output)."""
    b, t, _ = x.shape
    h = dense(dpt.in_proj, x, compute_dtype)
    d = h.shape[-1]
    h, m_g = pad_to_chunks(h, mask, chunk_frames)
    for bp, r in zip(dpt.blocks, split_key(rng, len(dpt.blocks))):
        args = (bp, h, m_g, heads, compute_dtype, dropout_rate, r)
        if remat and torch.is_grad_enabled():
            # the block draws its dropout masks from its key (see dprnn_stack)
            h = checkpoint(_block, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            h = _block(*args)
    return unchunk(h, t)
