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
ends on ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from amss_tpu_torch.infer.long import separate_long, separate_long_sharded, warm_long
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


class StreamingSeparator:
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

    def _frame_count(self, t: int) -> int:
        # an utterance shorter than one window has no frame (the JAX package's
        # negative count would mark the wrong frames valid)
        return max(self.model.cfg.front.frames_for(t), 0)

    def _run(self, mix: np.ndarray, fmask: np.ndarray) -> torch.Tensor:
        return self.model.separate(
            torch.from_numpy(mix).to(self.device),
            frame_mask=torch.from_numpy(fmask).to(self.device),
            **self.kw,
        )

    def _warm_up(self, bucket: int, batch: int) -> None:
        if (bucket, batch) in self._warm:
            return
        t0 = time.perf_counter()
        self._run(np.zeros((batch, bucket), np.float32),
                  np.ones((batch, self._frame_count(bucket)), np.float32))
        synchronize(self.device)
        self.meter.warmup_seconds += time.perf_counter() - t0
        self._warm.add((bucket, batch))

    def separate_all(self, waves: list[np.ndarray], max_batch: int = 8) -> list[np.ndarray]:
        """Separate a corpus of variable-length utterances.

        Returns per-utterance arrays [S, T_orig] in input order and books the
        compute time against the audio time in ``self.meter``.  Utterances
        longer than the largest bucket go first, one ``separate_long`` call
        each (one meter call each)."""
        with span(SERVE_JOB, utterances=len(waves), audio_samples=sum(len(w) for w in waves)):
            return self._separate_all(waves, max_batch)

    def _separate_all(self, waves: list[np.ndarray], max_batch: int) -> list[np.ndarray]:
        results: list[np.ndarray | None] = [None] * len(waves)
        max_bucket = self.buckets.lengths[-1]
        long_idx = [i for i in range(len(waves)) if len(waves[i]) > max_bucket]
        if long_idx and ("long", max_bucket) not in self._warm:
            self.meter.warmup_seconds += warm_long(self.model, chunk=max_bucket, **self.kw)
            self._warm.add(("long", max_bucket))
        for i in long_idx:
            t0 = time.perf_counter()
            if self.mesh is None:
                results[i] = separate_long(self.model, waves[i], chunk=max_bucket, **self.kw)
            else:
                results[i] = separate_long_sharded(self.model, waves[i], chunk=max_bucket,
                                                   mesh=self.mesh, **self.kw)
            self.meter.compute_seconds += time.perf_counter() - t0
            self.meter.audio_seconds += len(waves[i]) / self.sample_rate
            self.meter.utterances += 1
            self.meter.calls += 1

        with span(SERVE_PACK):
            order = sorted((i for i in range(len(waves)) if results[i] is None),
                           key=lambda i: len(waves[i]))
            groups: list[list[int]] = []
            current = None
            for i in order:
                bkt = self.buckets.bucket_for(len(waves[i]))
                if not groups or bkt != current or len(groups[-1]) >= max_batch:
                    groups.append([])
                current = bkt
                groups[-1].append(i)

            packed = []
            for g in groups:
                bucket = self.buckets.bucket_for(max(len(waves[i]) for i in g))
                mix = np.zeros((len(g), bucket), np.float32)
                fmask = np.zeros((len(g), self._frame_count(bucket)), np.float32)
                for j, i in enumerate(g):
                    mix[j, : len(waves[i])] = waves[i]
                    fmask[j, : self._frame_count(len(waves[i]))] = 1.0
                packed.append((mix, fmask, sum(len(waves[i]) for i in g)))
                self._warm_up(bucket, len(g))

        t0 = time.perf_counter()
        outs = []
        for mix, fmask, audio in packed:
            with span(SERVE_BATCH, rows=mix.shape[0], samples=mix.shape[1], audio_samples=audio):
                outs.append(self._run(mix, fmask))
        for est, g in zip(outs, groups):
            with span(SERVE_COPY_OUT):
                est_np = est.cpu().numpy()
                for j, i in enumerate(g):
                    t_i = len(waves[i])
                    results[i] = est_np[j, :, :t_i]
                    self.meter.audio_seconds += t_i / self.sample_rate
                    self.meter.utterances += 1
        with span(SYNC_END):
            synchronize(self.device)
        self.meter.compute_seconds += time.perf_counter() - t0
        self.meter.calls += len(groups)
        return results  # type: ignore[return-value]
