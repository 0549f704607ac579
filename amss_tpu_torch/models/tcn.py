"""The temporal convolutional trunk (``amss_tpu/models/tcn.py``): R repeats
of X blocks with dilations 1, 2, 4, ... 2^(X-1), each

    1x1 conv (bottleneck -> H) -> PReLU -> layer norm ->
    depthwise dilated conv (kernel P) -> PReLU -> layer norm ->
    1x1 residual conv (H -> bottleneck)  [+ 1x1 skip conv, summed over blocks]

then a PReLU of the skip sum.  The 1x1 convs are ``dense`` products
(``models/blstm.py``), in float32 or with bf16 operands; everything else runs
in float32, as in the JAX package.  The depthwise conv is P shifted
multiply-adds, as there: no convolution library, so no TF32.

Padded frames are re-zeroed after every block, so the next block's dilated
conv reads exact zeros there, as a conv over the unpadded sequence reads its
zero padding: a padded row of a bucket gives the unpadded row's result.

The parameter names are the JAX package's (``in_proj``, ``blocks.<i>.{pw_in,
a1, ln1, dw, a2, ln2, pw_res, pw_skip}``, ``out_alpha``); a dense's ``w [in,
out]`` is its ``nn.Linear``'s ``weightᵀ``.

The streaming form (``tcn_stack_streaming``, for ``infer/realtime.py``) runs
the causal stack over new frames only, each block carrying the last
``(P-1)·dilation`` inputs of its depthwise conv.  It runs the same
multiply-adds as the causal ``tcn_stack``: the carried inputs stand where the
offline conv reads its left zero padding, so zero state is that padding.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from amss_tpu_torch.models.blstm import dense, init_dense
from amss_tpu_torch.models.dprnn import DropoutKey, LayerNorm, dropout, layer_norm, split_key


def prelu(alpha: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-channel PReLU over the LAST axis (``F.prelu`` takes channels on
    dim 1)."""
    return torch.where(x >= 0, x, alpha * x)


class TCNBlock(nn.Module):
    def __init__(self, bottleneck: int, hidden: int, kernel: int):
        super().__init__()
        self.pw_in = nn.Linear(bottleneck, hidden)
        self.a1 = nn.Parameter(torch.full((hidden,), 0.25))
        self.ln1 = LayerNorm(hidden)
        self.dw = nn.Parameter(torch.zeros(kernel, hidden))  # [P, H] taps
        self.a2 = nn.Parameter(torch.full((hidden,), 0.25))
        self.ln2 = LayerNorm(hidden)
        self.pw_res = nn.Linear(hidden, bottleneck)
        self.pw_skip = nn.Linear(hidden, bottleneck)


class TCN(nn.Module):
    """Input 1x1 conv F -> bottleneck, ``repeats * blocks`` conv blocks, and
    the output PReLU's slopes (``init_tcn``)."""

    def __init__(self, n_in: int, bottleneck: int, hidden: int, blocks: int,
                 repeats: int = 2, kernel: int = 3):
        super().__init__()
        self.in_proj = nn.Linear(n_in, bottleneck)
        self.blocks = nn.ModuleList(
            TCNBlock(bottleneck, hidden, kernel) for _ in range(repeats * blocks))
        self.out_alpha = nn.Parameter(torch.full((bottleneck,), 0.25))

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's distributions: each dense uniform in ±1/√n_in
        with bias 0, PReLU slopes 0.25, layer norms g = 1 and b = 0, and
        depthwise taps N(0, 1/P).  ``generator`` (a CPU generator) cannot
        replay ``jax.random``."""
        init_dense(self.in_proj, generator)
        for blk in self.blocks:
            init_dense(blk.pw_in, generator)
            p = blk.dw.shape[0]
            blk.dw.copy_(torch.randn(blk.dw.shape, generator=generator) / math.sqrt(p))
            init_dense(blk.pw_res, generator)
            init_dense(blk.pw_skip, generator)
            for alpha in (blk.a1, blk.a2):
                alpha.fill_(0.25)
            blk.ln1.reset()
            blk.ln2.reset()
        self.out_alpha.fill_(0.25)


def receptive_field_frames(blocks: int, repeats: int, kernel: int) -> int:
    """One-sided (past) receptive field of the causal TCN, in frames."""
    return repeats * (kernel - 1) * (2**blocks - 1)


def dw_state_shapes(hidden: int, blocks: int, repeats: int,
                    kernel: int) -> list[tuple[int, int]]:
    """Per-block streaming state shapes ``[(ctx_frames, channels), ...]``:
    the ``(P-1)·dilation`` past depthwise inputs each causal block keeps."""
    return [((kernel - 1) * 2 ** (i % blocks), hidden) for i in range(repeats * blocks)]


def _depthwise_dilated(w: torch.Tensor, x: torch.Tensor, dilation: int,
                       causal: bool = False) -> torch.Tensor:
    """Depthwise cross-correlation as P shifted scaled adds.

    w ``[P, C]``, x ``[B, T, C]`` -> ``[B, T, C]``; zero padding of
    ``(P-1)·d`` in all, split as ``P//2·d`` left and the rest right, or all on
    the left when ``causal`` (output t reads inputs <= t)."""
    p = w.shape[0]
    if causal:
        left, right = (p - 1) * dilation, 0
    else:
        left, right = (p // 2) * dilation, (p - 1 - p // 2) * dilation
    xp = F.pad(x, (0, 0, left, right))
    t = x.shape[1]
    out = w[0] * xp[:, :t]
    for i in range(1, p):
        out = out + w[i] * xp[:, i * dilation : i * dilation + t]
    return out


def _depthwise_dilated_streaming(w: torch.Tensor, ctx: torch.Tensor,
                                 dilation: int) -> torch.Tensor:
    """Valid-mode causal depthwise conv: ctx ``[B, (P-1)·d + T, C]`` ->
    ``[B, T, C]``, the multiply-adds of ``_depthwise_dilated(causal=True)``
    with the carried prefix of ctx in place of the zero padding."""
    p = w.shape[0]
    t = ctx.shape[1] - (p - 1) * dilation
    out = w[0] * ctx[:, :t]
    for i in range(1, p):
        out = out + w[i] * ctx[:, i * dilation : i * dilation + t]
    return out


def _block(bp: TCNBlock, h: torch.Tensor, m: torch.Tensor | None, dil: int,
           compute_dtype: torch.dtype, causal: bool, dropout_rate: float,
           rng: DropoutKey | None, state: torch.Tensor | None = None):
    """One block -> (h', skip), or (h', skip, state') when ``state`` (the
    conv's carried inputs, streaming) is given."""
    u = prelu(bp.a1, dense(bp.pw_in, h, compute_dtype))
    u = layer_norm(bp.ln1, u)
    if m is not None:
        u = u * m
    if state is None:
        v = _depthwise_dilated(bp.dw, u, dil, causal)
    else:
        ctx = torch.cat([state, u], dim=1)
        state = ctx[:, ctx.shape[1] - state.shape[1]:]
        v = _depthwise_dilated_streaming(bp.dw, ctx, dil)
    v = prelu(bp.a2, v)
    v = layer_norm(bp.ln2, v)
    res = dropout(dense(bp.pw_res, v, compute_dtype), dropout_rate, rng)
    skip = dense(bp.pw_skip, v, compute_dtype)
    hn = h + res
    if m is not None:  # the next block's dilated conv must read exact zeros
        hn = hn * m
        skip = skip * m
    return (hn, skip) if state is None else (hn, skip, state)


def tcn_stack(
    tcn: TCN,
    x: torch.Tensor,  # [B, T', F]
    mask: torch.Tensor | None = None,  # [B, T'] 1 = valid
    blocks_per_repeat: int | None = None,
    compute_dtype: torch.dtype = torch.float32,
    remat: bool = False,
    dropout_rate: float = 0.0,
    rng: DropoutKey | None = None,
    causal: bool = False,
) -> torch.Tensor:
    """-> ``[B, T', bottleneck]``, the PReLU of the skip sum.

    With ``remat`` and gradients on, each block's activations are recomputed
    in the backward (``torch.utils.checkpoint``, as ``jax.checkpoint``).
    ``rng`` is the dropout key: each block gets its own, split on the host."""
    xpr = blocks_per_repeat or len(tcn.blocks)
    m = None if mask is None else mask[..., None].to(x.dtype)
    h = dense(tcn.in_proj, x, compute_dtype)
    if m is not None:
        h = h * m
    skip_sum = torch.zeros_like(h)
    for i, (bp, r) in enumerate(zip(tcn.blocks, split_key(rng, len(tcn.blocks)))):
        args = (bp, h, m, 2 ** (i % xpr), compute_dtype, causal, dropout_rate, r)
        if remat and torch.is_grad_enabled():
            # a block draws its dropout mask from its own key, so the
            # recompute draws the same one: no generator state to keep
            h, skip = checkpoint(_block, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            h, skip = _block(*args)
        skip_sum = skip_sum + skip
    out = prelu(tcn.out_alpha, skip_sum)
    return out if m is None else out * m


def tcn_stack_streaming(
    tcn: TCN,
    x: torch.Tensor,  # [B, T_new, F] the new frames only
    states: list[torch.Tensor],  # per block [B, (P-1)·d, H], its conv's past inputs
    mask: torch.Tensor | None = None,  # [B, T_new] 1 = valid (stream start)
    blocks_per_repeat: int | None = None,
    compute_dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The causal TCN over new frames only, carrying each block's conv state:
    -> (``[B, T_new, bottleneck]``, new states).  From zero states it computes
    what ``tcn_stack(causal=True)`` computes for the same frames of the whole
    sequence, with O(T_new) work."""
    xpr = blocks_per_repeat or len(tcn.blocks)
    m = None if mask is None else mask[..., None].to(x.dtype)
    h = dense(tcn.in_proj, x, compute_dtype)
    if m is not None:
        h = h * m
    skip_sum = torch.zeros_like(h)
    new_states = []
    for i, bp in enumerate(tcn.blocks):
        h, skip, st = _block(bp, h, m, 2 ** (i % xpr), compute_dtype, True, 0.0, None,
                             states[i])
        new_states.append(st)
        skip_sum = skip_sum + skip
    out = prelu(tcn.out_alpha, skip_sum)
    return (out if m is None else out * m), new_states
