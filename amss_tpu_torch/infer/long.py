"""Separation of utterances of any length at the memory of one chunk
(``amss_tpu/infer/long.py``).

The BLSTM is bidirectional, so there is no carried state: the mixture is cut
into chunks of C samples that overlap by O, every chunk is separated on its
own in fixed-width groups, and the host stitches the chunks: k-means labels
are arbitrary per chunk, so each chunk's speakers are put in the order that
best correlates with the audio already stitched over the overlap, and the
overlap is crossfaded linearly.

Groups are ``CHUNK_BATCH`` chunks wide, and the last few drop to
``TAIL_BATCH`` when that pads less.  All chunks go to the device in one copy,
every group is launched before any result is copied back, and the results
come back in one copy, the one synchronisation of the call.
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from amss_tpu_torch.utils.device import synchronize

CHUNK_BATCH = 8
TAIL_BATCH = 4
OVERLAP = 4096  # samples that neighbouring chunks share, at most a quarter chunk


def _device(model) -> torch.device:
    return next(model.parameters()).device


def warm_long(model, chunk: int, **separate_kwargs) -> float:
    """Run the chunk program once on zeros at each group width, so that
    first-use costs are not charged to serving; returns the seconds spent."""
    dev = _device(model)
    t0 = time.perf_counter()
    for width in sorted({CHUNK_BATCH, TAIL_BATCH}):
        model.separate(torch.zeros((width, chunk), device=dev), **separate_kwargs)
    synchronize(dev)
    return time.perf_counter() - t0


def _group_widths(n_chunks: int) -> list[int]:
    """Group widths covering ``n_chunks``: ``CHUNK_BATCH``-wide groups, the
    remainder in ``TAIL_BATCH``-wide groups where that wastes less padding."""
    widths, left = [], n_chunks
    while left >= CHUNK_BATCH:
        widths.append(CHUNK_BATCH)
        left -= CHUNK_BATCH
    while left > 0:
        w = TAIL_BATCH if left <= TAIL_BATCH else CHUNK_BATCH
        widths.append(w)
        left -= w
    return widths


def chunk_layout(t: int, chunk: int) -> tuple[int, list[int], int]:
    """(overlap, chunk starts, padded length) of an utterance of ``t`` samples
    cut into chunks of ``chunk`` samples."""
    overlap = min(OVERLAP, chunk // 4)  # the overlap must leave a positive hop
    hop = chunk - overlap
    n_chunks = -(-max(t - overlap, 1) // hop)
    return overlap, [i * hop for i in range(n_chunks)], (n_chunks - 1) * hop + chunk


def separate_long(model, mix: np.ndarray, chunk: int, **separate_kwargs) -> np.ndarray:
    """One utterance ``mix[T]`` of any length -> ``[S, T]``, on the model's
    device.  An utterance no longer than ``chunk`` is one ``separate`` call."""
    dev = _device(model)
    t = len(mix)
    if t <= chunk:
        est = model.separate(torch.from_numpy(np.asarray(mix, np.float32)[None]).to(dev),
                             **separate_kwargs)
        return est[0].cpu().numpy()

    overlap, starts, t_pad = chunk_layout(t, chunk)
    n_chunks = len(starts)
    widths = _group_widths(n_chunks)
    # the chunks, then zero chunks up to the groups' total width
    batch = np.zeros((sum(widths), chunk), np.float32)
    for i, s in enumerate(starts):
        part = mix[s : s + chunk]
        batch[i, : len(part)] = part
    batch = torch.from_numpy(batch).to(dev)
    outs, g0 = [], 0
    for width in widths:
        outs.append(model.separate(batch[g0 : g0 + width], **separate_kwargs))
        g0 += width
    est = torch.cat(outs)[:n_chunks].cpu().numpy()
    return stitch_chunks(est, starts, overlap, t, t_pad)


def separate_long_sharded(*args, **kwargs):
    """Long-form separation with the chunks spread over several cards."""
    raise NotImplementedError(
        "separate_long_sharded (chunks spread over several cards) is not ported yet: "
        "ROADMAP item 23 (multi-GPU)")


def stitch_chunks(
    est: np.ndarray,  # [n_chunks, S, chunk] separated audio per chunk
    starts: list[int],
    overlap: int,
    t: int,
    t_pad: int,
) -> np.ndarray:
    """-> ``[S, t]``.  Each chunk's speakers in the order that best correlates
    with the audio already stitched over the overlap, then a linear
    crossfade there."""
    n_chunks, s_dim, chunk = est.shape
    perms = list(itertools.permutations(range(s_dim)))
    out = np.zeros((s_dim, t_pad), np.float32)
    out[:, :chunk] = est[0]
    fade_in = np.linspace(0.0, 1.0, overlap, dtype=np.float32)

    for ci in range(1, n_chunks):
        s0 = starts[ci]
        prev_tail = out[:, s0 : s0 + overlap]
        best, best_score = 0, -np.inf
        for pi, perm in enumerate(perms):
            score = sum(
                float(np.dot(prev_tail[k], est[ci][perm[k], :overlap]))
                for k in range(s_dim)
            )
            if score > best_score:
                best, best_score = pi, score
        aligned = est[ci][list(perms[best])]
        out[:, s0 : s0 + overlap] = (
            prev_tail * (1.0 - fade_in) + aligned[:, :overlap] * fade_in
        )
        out[:, s0 + overlap : s0 + chunk] = aligned[:, overlap:]
    return out[:, :t]
