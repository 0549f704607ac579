"""The STFT of one long signal sharded over time (``amss_tpu/parallel/timeshard.py``).

One process splits ``[B, T]`` into one contiguous time shard per entry of
the mesh.  Each shard takes its right halo, the first ``win - hop`` samples
of the next shard, copied onto its device, so that it can build its last
overlapping frames alone; then it is analysed where it lies, through B1
(``ops/kernels/framed_matmul.py::stft_ri``: the kernel on a card where the
shape gate opens, as at 256/64, else the plain product).  The last shard's
halo wraps around to the first shard, as the JAX package's ``ppermute``
does, and its wrapped frames are trimmed: the global frame count is
``(T - win) // hop + 1``.
"""

from __future__ import annotations

import torch

from amss_tpu_torch.ops.kernels.framed_matmul import stft_ri


def sharded_stft_ri(x: torch.Tensor, win: int, hop: int,
                    mesh: list) -> tuple[torch.Tensor, torch.Tensor]:
    """Time-sharded STFT of ``x`` ``[B, T]`` over ``mesh`` (a list of
    devices) -> (re, im), each ``[B, NF, F]`` on ``mesh[0]``, with
    ``NF = (T - win) // hop + 1``.  ``T`` must be a multiple of
    ``len(mesh) · hop``, and ``win`` of ``hop``."""
    b, t = x.shape
    p = len(mesh)
    if t % (p * hop) != 0 or win % hop != 0:
        raise ValueError(f"need T % (P*hop) == 0 and win % hop == 0; {t=} {p=}")
    halo, width = win - hop, t // p
    if width < halo:
        raise ValueError(f"a shard of {width} samples is shorter than the halo of {halo}")
    shards = [x[:, i * width : (i + 1) * width].to(mesh[i]) for i in range(p)]
    outs = []
    for i in range(p):
        right = shards[(i + 1) % p][:, :halo].to(mesh[i])
        outs.append(stft_ri(torch.cat([shards[i], right], dim=1), win, hop))
    nf = (t - win) // hop + 1
    re = torch.cat([r.to(mesh[0]) for r, _ in outs], dim=1)[:, :nf]
    im = torch.cat([m.to(mesh[0]) for _, m in outs], dim=1)[:, :nf]
    return re, im
