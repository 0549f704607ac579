"""Bucketed batch separation with real-time-factor accounting
(``amss_tpu/infer/streaming.py``).

Utterances are grouped into length buckets and padded to the bucket with a
prefix frame mask; each group runs ``model.separate`` once.  Utterances longer
than the largest bucket take the long-form path (``infer/long.py``) with
chunks of the largest bucket, never truncated; with a ``mesh`` (a list of
devices, ``parallel/mesh.py``) their chunks are spread over it
(``separate_long_sharded``).  Every distinct shape is run
once on zeros before it is timed, so first-use costs (the kernels' build,
cuDNN's set-up) are booked as warm-up, not serving time.  Each timed phase
ends on ``torch.cuda.synchronize()``.  The loop (``BucketedServing``) also
serves exported programs (``infer/export.py::ServingArtifact``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from amss_tpu_torch.infer.long import separate_long, separate_long_sharded, warm_long
from amss_tpu_torch.utils.config import FrontConfig
from amss_tpu_torch.utils.device import resolve_device, synchronize
from amss_tpu_torch.utils.profiling import (
    SERVE_BATCH,
    SERVE_COPY_OUT,
    SERVE_JOB,
    SERVE_PACK,
    SYNC_END,
    span,
)


@dataclass
class BucketSpec:
    """Static bucket lengths (samples): 1-16 s at 8 kHz, ~1.6x apart."""

    lengths: tuple[int, ...] = (8192, 16384, 24576, 32768, 49152, 65536, 131072)

    def bucket_for(self, n: int) -> int:
        for length in self.lengths:
            if n <= length:
                return length
        return self.lengths[-1]


@dataclass
class RTFMeter:
    audio_seconds: float = 0.0
    compute_seconds: float = 0.0
    warmup_seconds: float = 0.0  # first run of each shape, kept out of rtf
    utterances: int = 0
    calls: int = 0  # batch calls booked into compute_seconds

    @property
    def rtf(self) -> float:
        return self.compute_seconds / max(self.audio_seconds, 1e-9)

    @property
    def utterances_per_sec(self) -> float:
        return self.utterances / max(self.compute_seconds, 1e-9)


def frame_mask(front: FrontConfig, bucket: int, lengths, rows: int) -> np.ndarray:
    """``[rows, frames of bucket]`` prefix masks: row j marks the frames of an
    utterance of ``lengths[j]`` samples valid, and rows past ``lengths`` are
    zero.  An utterance shorter than one window has no frame (the JAX
    package's negative count would mark the wrong frames valid, ROADMAP C.4)."""
    frames = [max(front.frames_for(int(n)), 0) for n in (bucket, *lengths)]
    fmask = np.zeros((rows, frames[0]), np.float32)
    for j, f in enumerate(frames[1:]):
        fmask[j, :f] = 1.0
    return fmask


class BucketedServing:
    """Serving's packing loop, shared by ``StreamingSeparator`` (a live model)
    and ``infer/export.py::ServingArtifact`` (exported programs).

    A subclass sets ``device``, ``meter``, ``sample_rate``, ``front`` (a
    ``FrontConfig``) and ``lengths`` (the buckets' samples, ascending), and
    supplies ``_program(bucket, rows)``, the launch ``(mix, frame_mask) ->
    est`` of that shape, run once beforehand and booked as warm-up;
    ``_warm_long()``, the same for the long-form path; and ``_long(wave)``,
    an utterance longer than the largest bucket."""

    device: torch.device
    meter: RTFMeter
    sample_rate: int
    front: FrontConfig
    lengths: tuple[int, ...]

    def _program(self, bucket: int, rows: int):
        raise NotImplementedError

    def _warm_long(self) -> None:
        raise NotImplementedError

    def _long(self, wave: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _serve(self, waves: list[np.ndarray], max_batch: int, pad_to: int | None = None,
               meter: RTFMeter | None = None) -> list[np.ndarray]:
        """``waves`` -> ``[S, T_orig]`` each, in input order, booked in
        ``meter`` (``self.meter`` by default).  Over-bucket utterances go
        first, one ``_long`` call each (one meter call each).  The rest are
        sorted by length, grouped by bucket up to ``max_batch`` rows,
        zero-padded to the bucket and to ``pad_to`` rows (by default the
        group's) with prefix frame masks; every group is launched before any
        result is copied back, and the call ends on one synchronisation."""
        meter = self.meter if meter is None else meter
        results: list[np.ndarray | None] = [None] * len(waves)
        long_idx = [i for i in range(len(waves)) if len(waves[i]) > self.lengths[-1]]
        if long_idx:
            self._warm_long()
        for i in long_idx:
            t0 = time.perf_counter()
            results[i] = self._long(waves[i])
            meter.compute_seconds += time.perf_counter() - t0
            meter.audio_seconds += len(waves[i]) / self.sample_rate
            meter.utterances += 1
            meter.calls += 1

        with span(SERVE_PACK):
            order = sorted((i for i in range(len(waves)) if results[i] is None),
                           key=lambda i: len(waves[i]))
            groups: list[tuple[int, list[int]]] = []  # (bucket, utterances)
            bucket_for = BucketSpec(self.lengths).bucket_for
            for i in order:
                bucket = bucket_for(len(waves[i]))
                if not groups or groups[-1][0] != bucket or len(groups[-1][1]) >= max_batch:
                    groups.append((bucket, []))
                groups[-1][1].append(i)

            packed = []
            for bucket, g in groups:
                rows = pad_to or len(g)
                n = [len(waves[i]) for i in g]
                mix = np.zeros((rows, bucket), np.float32)
                for j, i in enumerate(g):
                    mix[j, : n[j]] = waves[i]
                packed.append((self._program(bucket, rows), mix,
                               frame_mask(self.front, bucket, n, rows), sum(n)))

        t0 = time.perf_counter()
        outs = []
        for run, mix, fmask, audio in packed:
            with span(SERVE_BATCH, rows=mix.shape[0], samples=mix.shape[1], audio_samples=audio):
                outs.append(run(torch.from_numpy(mix).to(self.device),
                                torch.from_numpy(fmask).to(self.device)))
        for est, (_, g) in zip(outs, groups):
            with span(SERVE_COPY_OUT):
                est_np = est.cpu().numpy()
                for j, i in enumerate(g):
                    t_i = len(waves[i])
                    results[i] = est_np[j, :, :t_i]
                    meter.audio_seconds += t_i / self.sample_rate
                    meter.utterances += 1
        with span(SYNC_END):
            synchronize(self.device)
        meter.compute_seconds += time.perf_counter() - t0
        meter.calls += len(groups)
        return results  # type: ignore[return-value]


class StreamingSeparator(BucketedServing):
    """Wraps a model for bucketed batch separation on one device.

    ``model.separate`` must accept (mix [B, T], frame_mask=[B, T']).  The
    device is ``cuda`` unless the caller names another; with none named and no
    card present, construction raises.  With ``mesh``, over-bucket utterances
    spread their chunks over its devices."""

    def __init__(self, model, sample_rate: int = 8000, buckets: BucketSpec | None = None,
                 separate_kwargs: dict | None = None, device=None, mesh: list | None = None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.model = model.to(self.device).eval()
        self.sample_rate = sample_rate
        self.buckets = buckets or BucketSpec()
        self.kw = separate_kwargs or {}
        self._warm: set[tuple] = set()
        self.meter = RTFMeter()

    @property
    def front(self) -> FrontConfig:
        return self.model.cfg.front

    @property
    def lengths(self) -> tuple[int, ...]:
        return self.buckets.lengths

    def _launch(self, mix: torch.Tensor, fmask: torch.Tensor) -> torch.Tensor:
        return self.model.separate(mix, frame_mask=fmask, **self.kw)

    def _program(self, bucket: int, rows: int):
        if (bucket, rows) not in self._warm:
            t0 = time.perf_counter()
            fmask = frame_mask(self.front, bucket, [bucket] * rows, rows)
            self._launch(torch.zeros((rows, bucket), device=self.device),
                         torch.from_numpy(fmask).to(self.device))
            synchronize(self.device)
            self.meter.warmup_seconds += time.perf_counter() - t0
            self._warm.add((bucket, rows))
        return self._launch

    def _warm_long(self) -> None:
        chunk = self.lengths[-1]
        if ("long", chunk) not in self._warm:
            self.meter.warmup_seconds += warm_long(self.model, chunk=chunk, **self.kw)
            self._warm.add(("long", chunk))

    def _long(self, wave: np.ndarray) -> np.ndarray:
        chunk = self.lengths[-1]
        if self.mesh is None:
            return separate_long(self.model, wave, chunk=chunk, **self.kw)
        return separate_long_sharded(self.model, wave, chunk=chunk, mesh=self.mesh, **self.kw)

    def separate_all(self, waves: list[np.ndarray], max_batch: int = 8) -> list[np.ndarray]:
        """Separate a corpus of variable-length utterances.

        Returns per-utterance arrays [S, T_orig] in input order and books the
        compute time against the audio time in ``self.meter``.  Utterances
        longer than the largest bucket go first, one ``separate_long`` call
        each (one meter call each)."""
        with span(SERVE_JOB, utterances=len(waves), audio_samples=sum(len(w) for w in waves)):
            return self._serve(waves, max_batch)
