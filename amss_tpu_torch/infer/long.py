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

``separate_long_sharded`` spreads the chunks over a mesh (a list of devices,
``parallel/mesh.py``): each group of ``len(mesh) · chunk_batch_per_device``
chunks, zero-padded to full size, is split into one slice per entry of the
mesh, and each slice runs on a replica of the model on that entry's device.
Each chunk is computed on one device, so no collective is needed; the host
stitches as ``separate_long`` does.
"""

from __future__ import annotations

import copy
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


def chunk_layout(t: int, chunk: int, overlap: int = OVERLAP) -> tuple[int, list[int], int]:
    """(overlap, chunk starts, padded length) of an utterance of ``t`` samples
    cut into chunks of ``chunk`` samples that overlap by ``overlap``, at most a
    quarter chunk."""
    overlap = min(overlap, chunk // 4)  # the overlap must leave a positive hop
    hop = chunk - overlap
    n_chunks = -(-max(t - overlap, 1) // hop)
    return overlap, [i * hop for i in range(n_chunks)], (n_chunks - 1) * hop + chunk


def _one_call(model, mix: np.ndarray, **separate_kwargs) -> np.ndarray:
    """An utterance no longer than a chunk: one ``separate`` call."""
    mix = torch.from_numpy(np.asarray(mix, np.float32)[None]).to(_device(model))
    return model.separate(mix, **separate_kwargs)[0].cpu().numpy()


def chunk_rows(mix: np.ndarray, starts: list[int], chunk: int, rows: int) -> np.ndarray:
    """The chunks of ``mix`` as ``[rows, chunk]``, zero rows after them."""
    batch = np.zeros((rows, chunk), np.float32)
    for i, s in enumerate(starts):
        part = mix[s : s + chunk]
        batch[i, : len(part)] = part
    return batch


def separate_long(model, mix: np.ndarray, chunk: int, overlap: int = OVERLAP,
                  **separate_kwargs) -> np.ndarray:
    """One utterance ``mix[T]`` of any length -> ``[S, T]``, on the model's
    device.  An utterance no longer than ``chunk`` is one ``separate`` call."""
    t = len(mix)
    if t <= chunk:
        return _one_call(model, mix, **separate_kwargs)

    overlap, starts, t_pad = chunk_layout(t, chunk, overlap)
    n_chunks = len(starts)
    widths = _group_widths(n_chunks)
    # the chunks, then zero chunks up to the groups' total width
    batch = torch.from_numpy(chunk_rows(mix, starts, chunk, sum(widths))).to(_device(model))
    outs, g0 = [], 0
    for width in widths:
        outs.append(model.separate(batch[g0 : g0 + width], **separate_kwargs))
        g0 += width
    est = torch.cat(outs)[:n_chunks].cpu().numpy()
    return stitch_chunks(est, starts, overlap, t, t_pad)


def separate_long_sharded(model, mix: np.ndarray, chunk: int, mesh: list | None = None,
                          overlap: int = OVERLAP, chunk_batch_per_device: int = CHUNK_BATCH,
                          **separate_kwargs) -> np.ndarray:
    """One utterance ``mix[T]`` of any length -> ``[S, T]``, its chunks spread
    over ``mesh`` (default: every visible card, ``parallel/mesh.py::make_mesh``)
    in groups of ``len(mesh) · chunk_batch_per_device``, each device taking a
    slice of ``chunk_batch_per_device`` chunks of every group.  Every slice is
    launched before any result is copied back.

    For a deterministic mask head (TasNet) the result equals
    ``separate_long``'s on one device type where the slices have the batch
    shapes of ``separate_long``'s groups (products whose rounding depends on
    the batch size may differ otherwise); a clustering model may pick another
    equally good clustering where k-means meets a tie (ROADMAP C.2)."""
    from amss_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices=mesh)
    home = _device(model)  # the model serves its own device, a copy any other
    replicas = {dev: model if dev == home else copy.deepcopy(model).to(dev).eval()
                for dev in dict.fromkeys(mesh)}
    t = len(mix)
    if t <= chunk:
        return _one_call(replicas[mesh[0]], mix, **separate_kwargs)

    overlap, starts, t_pad = chunk_layout(t, chunk, overlap)
    n_chunks = len(starts)
    cb = chunk_batch_per_device
    group = len(mesh) * cb
    rows = -(-n_chunks // group) * group
    host = torch.from_numpy(chunk_rows(mix, starts, chunk, rows))
    on = {dev: host.to(dev) for dev in replicas}  # one copy to each device
    outs = []
    for g0 in range(0, rows, group):
        for d, dev in enumerate(mesh):
            s0 = g0 + d * cb
            outs.append(replicas[dev].separate(on[dev][s0 : s0 + cb], **separate_kwargs))
    est = np.concatenate([o.cpu().numpy() for o in outs])[:n_chunks]
    return stitch_chunks(est, starts, overlap, t, t_pad)


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
