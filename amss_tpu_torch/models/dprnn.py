"""The dual-path recurrent trunk (``amss_tpu/models/dprnn.py``), its layer
norm, and training-time dropout.

The frame axis ``T'`` is padded to ``P·K`` frames and factored into P chunks
of K frames.  Each block runs an intra-chunk path over K (chunks folded into
the batch, ``[B·P, K, D]``) and an inter-chunk path over P (frame positions
folded into the batch, ``[B·K, P, D]``), each a one-layer BLSTM, a ``dense``
back to D, a layer norm, dropout and the residual.  Padded frames are zeroed
after every block.  With ``remat`` each block is recomputed in the backward
(``torch.utils.checkpoint``).  The same chunking at hop K/2 is SepFormer's
published segmentation (``pad_to_chunks``, ``unchunk``; ``models/sepformer.py``).

For a prefix frame mask every intra row and every inter row is again a prefix
(or empty), which is what cuDNN's packed LSTM takes.  Their lengths are
derived on the host once per trunk call (``path_lengths``): from the shapes
alone when the mask only marks the padding to ``P·K`` (training), else from
one copy of the mask to the host.  The BLSTM then copies nothing itself.
In bfloat16 the BLSTMs run their loop (``BLSTM.loop_bf16``), which needs no
lengths, and each path's ``dense`` takes bf16 operands.

Dropout: the JAX package's ``where(bernoulli(keep), x / keep, 0)``, the
identity without a key or at rate 0.  A key (``DropoutKey``) is an integer
seed that splits into child keys on the host and draws its keep mask from a
generator seeded with it on the tensor's device.  A block receives its key
and draws its masks inside, so the recompute of a checkpointed block draws
the same masks again (``torch.utils.checkpoint`` restores the global
generators only, not an explicit one).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from amss_tpu_torch.models.blstm import BLSTM, dense, init_dense, prefix_lengths


class DropoutKey:
    """A key for training-time draws (dropout, and the corruptions of
    ``models/front.py``), as a JAX PRNG key is for the JAX package's:
    ``split`` and ``fold_in`` derive child keys on the host, ``generator``
    gives a generator seeded with the key on a device, and ``rand``,
    ``randn``, ``randint`` and ``keep_mask`` draw from the one on a device.
    The same key draws the same values again on one device; a CPU and a CUDA
    generator draw different values from one seed.

    A key of one rank of data-parallel training (``shard``) draws for the
    global batch and keeps its rows: a draw of shape ``[n, ...]``, whose
    leading axis holds the rank's ``local`` rows outermost (``n`` a multiple
    of ``local``, as when chunks or frames are folded into the batch), is
    the global draw's slice from row ``offset``.  So N ranks draw what one
    process fed the ranks' rows concatenated in rank order draws.  Child
    keys keep the shard."""

    __slots__ = ("seed", "rows")

    def __init__(self, seed: int, rows: tuple[int, int, int] | None = None):
        self.seed = int(seed) % 2**63
        self.rows = rows  # (offset, local, total) rows of the global batch

    def shard(self, offset: int, local: int, total: int) -> DropoutKey:
        """This key for the ``local`` rows from ``offset`` of a global batch
        of ``total`` rows."""
        if not (0 <= offset and 0 < local and offset + local <= total):
            raise ValueError(f"rows {offset}..{offset + local} outside a batch of {total}")
        return DropoutKey(self.seed, (offset, local, total))

    def split(self, n: int) -> list[DropoutKey]:
        g = torch.Generator().manual_seed(self.seed)
        return [DropoutKey(s, self.rows)
                for s in torch.randint(0, 2**62, (n,), generator=g).tolist()]

    def fold_in(self, data: int) -> DropoutKey:
        """The key of ``data`` (a step, a microbatch) under this one."""
        g = torch.Generator().manual_seed((self.seed * 0x9E3779B97F4A7C15 + int(data)) % 2**63)
        return DropoutKey(int(torch.randint(0, 2**62, (1,), generator=g)), self.rows)

    def generator(self, device="cpu") -> torch.Generator:
        """A generator on ``device`` seeded with the key."""
        return torch.Generator(device=device).manual_seed(self.seed)

    def _draw(self, fn, shape, device, *args) -> torch.Tensor:
        shape = tuple(shape)
        if self.rows is None:
            return fn(*args, shape, generator=self.generator(device), device=device)
        offset, local, total = self.rows
        if shape[0] % local:
            raise ValueError(f"a draw of {shape} for a shard of {local} rows")
        fold = shape[0] // local
        full = fn(*args, (total * fold, *shape[1:]), generator=self.generator(device),
                  device=device)
        return full[offset * fold : (offset + local) * fold]

    def rand(self, shape, device="cpu") -> torch.Tensor:
        """Uniform float32 in [0, 1)."""
        return self._draw(torch.rand, shape, device)

    def randn(self, shape, device="cpu") -> torch.Tensor:
        """Standard normal float32."""
        return self._draw(torch.randn, shape, device)

    def randint(self, low: int, high: int, shape, device="cpu") -> torch.Tensor:
        """Integers in [low, high), int64."""
        return self._draw(torch.randint, shape, device, low, high)

    def keep_mask(self, shape, keep: float, device) -> torch.Tensor:
        """A boolean mask of ``shape``, each entry True with probability
        ``keep``."""
        return self.rand(shape, device) < keep


def apply_keep_mask(x: torch.Tensor, keep_mask: torch.Tensor, keep: float) -> torch.Tensor:
    """Inverted dropout with a given mask: ``x / keep`` where kept, else 0."""
    return torch.where(keep_mask, x / keep, 0.0)


def dropout(x: torch.Tensor, rate: float, rng: DropoutKey | None) -> torch.Tensor:
    """Inverted dropout at ``rate``; the identity when ``rng`` is None (eval)
    or the rate is 0, as the JAX package's dropout is without a key."""
    if rng is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    return apply_keep_mask(x, rng.keep_mask(x.shape, keep, x.device), keep)


def split_key(rng: DropoutKey | None, n: int) -> list:
    """``n`` child keys of ``rng``, or ``n`` Nones without one."""
    return [None] * n if rng is None else rng.split(n)


class LayerNorm(nn.Module):
    """The parameters of a layer norm over the last axis, with the JAX
    package's names: gain ``g`` (1 at init) and bias ``b`` (0), of ``shape``
    (one axis; TF-GridNet's norm over channels and bins takes ``[C, F]``)."""

    def __init__(self, *shape: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(shape))
        self.b = nn.Parameter(torch.zeros(shape))

    @torch.no_grad()
    def reset(self) -> None:
        self.g.fill_(1.0)
        self.b.zero_()


def layer_norm(p: LayerNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``(x - mean) / sqrt(var + eps) * g + b`` over the last axis, with the
    population variance, as ``jnp.var`` takes it (``torch.var``'s default is
    the unbiased one; ``F.layer_norm`` takes the population one)."""
    return F.layer_norm(x, (x.shape[-1],), p.g, p.b, eps)


class DualPathPath(nn.Module):
    """One path of a block: ``lstm`` (a one-layer BLSTM D -> 2·hidden),
    ``proj`` (2·hidden -> D) and ``ln``."""

    def __init__(self, d_model: int, hidden: int):
        super().__init__()
        self.lstm = BLSTM(d_model, hidden, 1)
        self.proj = nn.Linear(2 * hidden, d_model)
        self.ln = LayerNorm(d_model)


class DPRNNBlock(nn.Module):
    def __init__(self, d_model: int, hidden: int):
        super().__init__()
        self.intra = DualPathPath(d_model, hidden)
        self.inter = DualPathPath(d_model, hidden)


class DPRNN(nn.Module):
    """``in_proj`` (F -> D) and ``blocks`` of intra and inter paths
    (``init_dprnn``)."""

    def __init__(self, n_in: int, d_model: int, hidden: int, blocks: int):
        super().__init__()
        self.in_proj = nn.Linear(n_in, d_model)
        self.blocks = nn.ModuleList(DPRNNBlock(d_model, hidden) for _ in range(blocks))

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's distributions: each dense uniform in ±1/√n_in
        with bias 0, each LSTM as ``init_lstm_layer``, layer norms g = 1 and
        b = 0.  ``generator`` (a CPU generator) cannot replay ``jax.random``."""
        init_dense(self.in_proj, generator)
        for blk in self.blocks:
            for path in (blk.intra, blk.inter):
                path.lstm.init_parameters(generator)
                init_dense(path.proj, generator)
                path.ln.reset()


def path_lengths(t: int, k: int, mask: torch.Tensor | None, batch: int):
    """The host-side valid lengths of the intra rows ``[B·P]`` and the inter
    rows ``[B·K]`` of a trunk over ``t`` frames in chunks of ``k``, or None
    where neither path needs a mask.

    Without ``mask`` only the padding to ``P·K`` is masked, and the lengths
    follow from the shapes.  With one, it is copied to the host once and must
    be a prefix mask (cuDNN's packed LSTM takes prefixes only)."""
    p = -(-t // k)
    if mask is None:
        if p * k == t:
            return None
        counts = np.full(batch, t, np.int64)
    else:
        counts = prefix_lengths(mask).numpy()
    starts = np.arange(p) * k
    intra = np.clip(counts[:, None] - starts[None, :], 0, k)  # [B, P]
    inter = np.clip(-(-(counts[:, None] - np.arange(k)[None, :]) // k), 0, p)  # [B, K]
    return torch.from_numpy(intra.reshape(-1)), torch.from_numpy(inter.reshape(-1))


def segments(t: int | torch.Tensor, k: int):
    """The number of chunks of SepFormer's published segmentation of ``t``
    frames (SpeechBrain's ``Dual_Path_Model._Segmentation``): K/2 zero frames
    before frame 0, 1 to K after the last (the ``gap`` and K/2), chunks of K
    at hop K/2.  ``t`` may be a tensor of frame counts."""
    return 2 * ((k // 2 + t) // k + 1)


def pad_to_chunks(h: torch.Tensor, mask: torch.Tensor | None, k: int, hop: int | None = None):
    """The trunk's input ``[B, T', D]`` on a grid of chunks of K frames, and
    its mask: -> (h ``[B, P, K, D]``, mask ``[B, P, K]`` or None).

    At hop K (the default; DPRNN and DPT) the P = ⌈T'/K⌉ chunks tile the
    frames padded to ``P·K``, and the mask is materialised when padding is
    introduced (so padded frames never reach the inter-chunk path).  At hop
    K/2 the grid is SepFormer's published segmentation (``segments``), the
    chunks overlap by half, and there is no frame mask: SepFormer masks
    whole chunks (``models/sepformer.py``).  ``unchunk`` puts the frames
    back."""
    b, t, d = h.shape
    if hop is not None and hop != k:
        if 2 * hop != k or mask is not None:
            raise ValueError(f"chunks of {k} frames overlap at hop {k} or, without a mask, "
                             f"{k // 2}; got hop {hop}")
        back = segments(t, k) // 2 * k - t
        return F.pad(h, (0, 0, hop, back)).unfold(1, k, hop).transpose(2, 3), None
    p = -(-t // k)
    if p * k != t:
        h = F.pad(h, (0, 0, 0, p * k - t))
        m = torch.ones((b, t), dtype=h.dtype, device=h.device) if mask is None else mask
        mask = F.pad(m.to(h.dtype), (0, p * k - t))
    m_g = None if mask is None else mask.to(h.dtype).reshape(b, p, k)
    return h.reshape(b, p, k, d), m_g


def unchunk(h: torch.Tensor, t: int, hop: int | None = None) -> torch.Tensor:
    """The inverse of ``pad_to_chunks``: chunks ``[B, P, K, D]`` back to the
    frames ``[B, t, D]``.  At hop K/2 each frame is the sum of the two chunks
    over it, the even chunks' value plus the odd's, as SpeechBrain's
    ``_over_add`` adds them."""
    b, _, k, d = h.shape
    if hop is None or hop == k:
        return h.reshape(b, -1, d)[:, :t]
    even = h[:, 0::2].reshape(b, -1, d)  # chunks from padded frame 0, K, 2K, ...
    odd = h[:, 1::2].reshape(b, -1, d)  # from K/2, 3K/2, ...
    return (even[:, hop:] + odd[:, :-hop])[:, :t]


def _path(path: DualPathPath, x, mask, lengths, compute_dtype, rate, rng):
    """BLSTM -> proj -> layer norm -> dropout; x ``[N, L, D]`` -> ``[N, L, D]``."""
    h = path.lstm(x, mask, lengths=lengths, compute_dtype=compute_dtype)
    h = dense(path.proj, h, compute_dtype)
    return dropout(layer_norm(path.ln, h), rate, rng)


def _block(bp: DPRNNBlock, h, m_g, lengths, compute_dtype, rate, rng):
    b, p, k, d = h.shape
    r1, r2 = split_key(rng, 2)
    li, lt = (None, None) if lengths is None else lengths
    mi = None if m_g is None else m_g.reshape(b * p, k)
    h = h + _path(bp.intra, h.reshape(b * p, k, d), mi, li, compute_dtype, rate,
                  r1).reshape(b, p, k, d)
    ht = h.transpose(1, 2).reshape(b * k, p, d)
    mt = None if m_g is None else m_g.transpose(1, 2).reshape(b * k, p)
    delta = _path(bp.inter, ht, mt, lt, compute_dtype, rate, r2)
    h = h + delta.reshape(b, k, p, d).transpose(1, 2)
    if m_g is not None:  # padded positions stay exactly zero downstream
        h = h * m_g[..., None]
    return h


def dprnn_stack(
    dprnn: DPRNN,
    x: torch.Tensor,  # [B, T', F]
    mask: torch.Tensor | None = None,  # [B, T'] 1 = valid, a prefix
    chunk_frames: int = 16,
    compute_dtype: torch.dtype = torch.float32,
    remat: bool = True,
    dropout_rate: float = 0.0,
    rng: DropoutKey | None = None,
) -> torch.Tensor:
    """-> ``[B, T', D]``, non-overlapping chunks of ``chunk_frames``."""
    b, t, _ = x.shape
    k = chunk_frames
    h = dense(dprnn.in_proj, x, compute_dtype)
    d = h.shape[-1]
    # the BLSTM's lengths on the host, needed only where cuDNN packs (not in
    # an exported program, whose BLSTM is the traced one, nor in bf16, whose
    # BLSTM is the loop; a path whose rows take the kernel ignores them)
    packs = (x.device.type == "cuda" and not torch.compiler.is_exporting()
             and compute_dtype == torch.float32)
    lengths = path_lengths(t, k, mask, b) if packs else None
    h, m_g = pad_to_chunks(h, mask, k)
    for bp, r in zip(dprnn.blocks, split_key(rng, len(dprnn.blocks))):
        args = (bp, h, m_g, lengths, compute_dtype, dropout_rate, r)
        if remat and torch.is_grad_enabled():
            # the block draws its dropout masks from its key: the recompute
            # draws the same ones, whatever the global generators hold
            h = checkpoint(_block, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            h = _block(*args)
    return unchunk(h, t)
