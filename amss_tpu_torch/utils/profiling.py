"""Tracing and profiling hooks (``amss_tpu/utils/profiling.py``).

* ``trace(logdir)``: a context manager around any region; writes a Chrome
  trace (``trace.json``, loadable in Perfetto or ``chrome://tracing``) of the
  host and the card's kernels with ``torch.profiler`` (the host alone for a
  CPU run).
* ``annotate(name)``: a named span inside a trace (``record_function``).
* ``StepTimer``: wall-clock step statistics (p50/p95) without a trace.
* ``compiled_flops`` / ``mfu``: the operations of one call, counted op by op
  by ``FlopCounterMode`` (the kernels' operators by their registered
  formulas), and the achieved share of the card's peak.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

# Peak dense tensor-core rate of one H100 SXM in bf16 (FP32 accumulate):
# 989 TFLOP/s (NVIDIA H100 Tensor Core GPU data sheet, without sparsity, at
# the 700 W power limit).  Float32 programs are measured against the same
# number, so their MFU is a lower bound.
H100_PEAK_FLOPS = 989e12


def compiled_flops(fn, *args, **kwargs) -> float:
    """Operations of ``fn(*args, **kwargs)``, counted while it runs: matrix
    products, convolutions and attention by shape, and ``amss::framed_matmul``
    and ``amss::decode_ola`` as 2·B·NF·win·K each; elementwise work is not
    counted."""
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def mfu(flops_total: float, seconds: float, peak: float = H100_PEAK_FLOPS) -> dict:
    """Achieved FLOP/s, and its share of the card's peak, of ``flops_total``
    operations done in ``seconds`` of wall time."""
    achieved = flops_total / max(seconds, 1e-12)
    return {"achieved_tflops": achieved / 1e12, "mfu_vs_h100_peak": achieved / peak}


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """Profile the block and write ``<logdir>/trace.json``; yields the
    profiler.  On ``device`` cuda (the default where there is a card) the
    card is traced too, and a trace holding none of its kernels raises
    rather than be written as a host-only trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        yield prof
    if cuda and not any(e.device_type == DeviceType.CUDA for e in prof.events()):
        raise RuntimeError("torch.profiler recorded no CUDA kernel on this machine; no trace "
                           "written")
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock statistics of steps (call ``tick()`` after each step has
    finished on the device)."""

    def __init__(self):
        self.samples: list[float] = []
        self._last = None

    def start(self):
        self._last = time.perf_counter()

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self.samples.append(now - self._last)
        self._last = now

    def stats(self) -> dict:
        if not self.samples:
            return {}
        s = sorted(self.samples)
        n = len(s)
        return {
            "mean_s": sum(s) / n,
            "p50_s": s[n // 2],
            "p95_s": s[min(int(n * 0.95), n - 1)],
            "n": n,
        }
