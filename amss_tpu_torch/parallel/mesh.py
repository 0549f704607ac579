"""Meshes and the ranks of data-parallel training (``amss_tpu/parallel/mesh.py``).

A mesh is an explicit list of ``torch.device``s: one process places shards
or replicas on each entry.  An entry may repeat (``[cuda:0, cuda:0]`` runs
two shards on one card, in turns) and may be ``cpu``.

Training across devices runs one process per rank, PyTorch's idiom, and
follows the JAX package's multi-process contract: each rank draws its own
rows of the global batch, the ranks average their gradients once a step
(``all_reduce_mean``, one flat bucket), and parameters start from rank 0's
(``broadcast_tensors``).  The backend is always named by the caller: ``nccl``
for one rank per card, ``gloo`` for CPU ranks or ranks that share a card
(NCCL refuses two ranks on one card).  ``run_ranks`` starts the ranks of one
host and fails if any of them fails.
"""

from __future__ import annotations

import socket

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def make_mesh(n: int | None = None, devices=None) -> list[torch.device]:
    """The first ``n`` of ``devices`` (default: every visible card), as
    ``torch.device``s (a card with its index).  Asking for more than there are raises; the mesh never
    shrinks and never moves to the CPU on its own."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [_indexed(torch.device(d)) for d in devices]
    if n is not None:
        if n > len(devices):
            raise ValueError(f"asked for {n} devices, have {len(devices)}")
        devices = devices[:n]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return devices


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the card it means now (``cuda:<current>``), so that equal
    devices compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_data_parallel(backend: str, rank: int, world: int, init_method: str,
                       device=None) -> None:
    """Join the process group of ``world`` ranks as ``rank`` over ``backend``
    (``nccl`` or ``gloo``), at ``init_method`` (``tcp://localhost:<port>``,
    or ``env://`` under ``torchrun``).  With ``nccl`` the rank's card is
    ``device``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl":
        if device is None or torch.device(device).type != "cuda":
            raise ValueError(f"nccl needs the rank's card, got device={device!r}")
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)


def rank_and_world() -> tuple[int, int] | None:
    """(rank, world) of the process group, or None outside one."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return dist.get_rank(), dist.get_world_size()


def _buckets(tensors: list[torch.Tensor]):
    """The tensors grouped by (device, dtype), each group as (indices, one
    flat tensor of them all)."""
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.device, t.dtype), []).append(i)
    for idx in groups.values():
        yield idx, torch.cat([tensors[i].reshape(-1) for i in idx])


def _unflatten(flat: torch.Tensor, idx: list[int], tensors: list[torch.Tensor], out: list):
    o = 0
    for i in idx:
        n = tensors[i].numel()
        out[i] = flat[o : o + n].view(tensors[i].shape)
        o += n


def all_reduce_mean(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The mean over the ranks of each tensor, reduced as one flat bucket
    (one per device and dtype).  Every rank gets the same values."""
    world = dist.get_world_size()
    out: list = [None] * len(tensors)
    for idx, flat in _buckets(tensors):
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        _unflatten(flat / world, idx, tensors, out)
    return out


@torch.no_grad()
def broadcast_tensors(tensors: list[torch.Tensor], src: int = 0) -> None:
    """Overwrite each tensor with rank ``src``'s, in place, as one flat
    bucket."""
    out: list = [None] * len(tensors)
    for idx, flat in _buckets(tensors):
        dist.broadcast(flat, src=src)
        _unflatten(flat, idx, tensors, out)
    for t, v in zip(tensors, out):
        t.copy_(v)


def _rank_main(rank: int, fn, world: int, backend: str, init_method: str, devices, args):
    device = devices[rank] if devices is not None else None
    init_data_parallel(backend, rank, world, init_method, device)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, backend: str, args: tuple = (), devices=None) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes joined
    over ``backend`` on a free localhost port, rank r on ``devices[r]`` where
    given (``nccl`` needs them).  ``fn`` must be importable by name.  Returns
    when every rank has returned; raises if any rank fails (the others are
    ended)."""
    import torch.multiprocessing as mp

    if devices is not None and len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    init_method = f"tcp://localhost:{free_port()}"
    mp.spawn(_rank_main, args=(fn, world, backend, init_method, devices, args),
             nprocs=world, join=True)
