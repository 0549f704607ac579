"""Tracing and profiling hooks (``amss_tpu/utils/profiling.py``).

* ``trace(logdir)``: a context manager around any region; writes a Chrome
  trace (``trace.json``, loadable in Perfetto or ``chrome://tracing``) of the
  host and the card's kernels with ``torch.profiler`` (the host alone for a
  CPU run), the port's spans among its ranges.
* ``span(name, device=None, **attrs)``: one of the port's named spans.  With
  no profiler recording and no ``recording()`` block open it returns a shared
  null context and costs one flag check.  Otherwise it opens a
  ``record_function`` range (so every Chrome trace shows it on the
  profiler's clock) and keeps a ``SpanRecord``: its host interval, its parent
  on this thread, the id of its root span and ``attrs``.  The layer spans of
  ``DEVICE_TIMED``, given a CUDA ``device``, also record two timing events
  on the current stream: the interval between the stream reaching the span's
  start and its end, the layer's busy time and the idle time inside it.
  Past ``CAP`` kept records, spans are counted, not kept.
* ``recording()``: keep spans without a profiler (tests, operators).
* ``spans()``: the kept records, their device intervals resolved, and the
  list cleared (``trace()`` clears it too).
* ``StepTimer``: wall-clock step statistics (p50/p95) without a trace.

The span names are the constants below; each layer's code opens its own.
Serving (``infer/streaming.py``): ``serve.job`` > ``serve.pack``,
``serve.batch`` (> the model's), ``serve.copy_out``, ``sync.end``.  The
model (``models/``): ``front``, ``trunk``, ``head``, ``cluster``, ``decode``,
and ``sync.lengths`` where the BLSTM copies its mask to the host.  Training
(``train/engine.py``): ``train.step`` > ``train.gather``, ``train.forward``,
``train.backward``, ``train.optimizer`` (> ``train.clip``; its attributes
``tensors`` and ``chunks`` say what the kernel pair of the optimizer took, 0
on the CPU); ``train.draw`` and ``train.put`` on the prefetch thread.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from dataclasses import dataclass, field

import torch

SERVE_JOB = "serve.job"
SERVE_PACK = "serve.pack"
SERVE_BATCH = "serve.batch"
SERVE_COPY_OUT = "serve.copy_out"
SYNC_END = "sync.end"
SYNC_LENGTHS = "sync.lengths"
FRONT = "front"
TRUNK = "trunk"
HEAD = "head"
CLUSTER = "cluster"
DECODE = "decode"
TRAIN_STEP = "train.step"
TRAIN_GATHER = "train.gather"
TRAIN_FORWARD = "train.forward"
TRAIN_BACKWARD = "train.backward"
TRAIN_OPTIMIZER = "train.optimizer"
TRAIN_CLIP = "train.clip"
TRAIN_DRAW = "train.draw"
TRAIN_PUT = "train.put"

DEVICE_TIMED = frozenset({FRONT, TRUNK, HEAD, CLUSTER, DECODE, TRAIN_FORWARD, TRAIN_BACKWARD,
                          TRAIN_OPTIMIZER})
CAP = 100_000  # kept records; spans past it are counted in ``SpanList.dropped``

_profiler = torch.autograd.profiler  # its _is_profiler_enabled is read at each call
_NULL = contextlib.nullcontext()
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()
_open = 0  # recording() blocks open, over all threads
_kept: list = []
_dropped = 0


@dataclass
class SpanRecord:
    """One kept span.  Host times are ``time.perf_counter_ns``; ``root`` is
    the id of the outermost span open on this thread when it began (its own
    id if none was).  ``device_ms`` is the stream's interval from the span's
    start to its end and ``device_start_ms`` its start after the first timed
    span of the same ``spans()`` list, both None where untimed."""

    name: str
    id: int
    parent: int | None
    root: int
    thread: int
    start_ns: int
    end_ns: int | None = None
    attrs: dict = field(default_factory=dict)
    device_ms: float | None = None
    device_start_ms: float | None = None
    events: tuple | None = field(default=None, repr=False, compare=False)


class SpanList(list):
    """The records ``spans()`` returns, with ``dropped``: the spans past
    ``CAP`` that were counted and not kept."""

    dropped: int = 0


class _Span:
    __slots__ = ("name", "device", "attrs", "rf", "rec")

    def __init__(self, name: str, device, attrs: dict):
        self.name, self.device, self.attrs = name, device, attrs

    def __enter__(self) -> SpanRecord:
        global _dropped
        self.rf = _profiler.record_function(self.name)
        self.rf.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        sid = next(_ids)
        rec = SpanRecord(self.name, sid, parent.id if parent else None,
                         parent.root if parent else sid, threading.get_ident(),
                         time.perf_counter_ns(), attrs=self.attrs)
        if len(_kept) < CAP:
            _kept.append(rec)
            dev = None if self.device is None else torch.device(self.device)
            if self.name in DEVICE_TIMED and dev is not None and dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                start.record(torch.cuda.current_stream(dev))
                rec.events = (start, None, dev)
        else:
            with _lock:
                _dropped += 1
        stack.append(rec)
        self.rec = rec
        return rec

    def __exit__(self, *exc) -> bool:
        rec = self.rec
        if rec.events is not None:
            start, _, dev = rec.events
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(dev))
            rec.events = (start, end, dev)
        rec.end_ns = time.perf_counter_ns()
        _local.stack.pop()
        self.rf.__exit__(*exc)
        return False


def span(name: str, device=None, **attrs):
    """A context manager: the port's span ``name`` (module docstring); off,
    the shared null context."""
    if not (_profiler._is_profiler_enabled or _open):
        return _NULL
    return _Span(name, device, attrs)


@contextlib.contextmanager
def recording():
    """Keep spans inside the block, with or without a profiler."""
    global _open
    with _lock:
        _open += 1
    try:
        yield
    finally:
        with _lock:
            _open -= 1


def spans() -> SpanList:
    """The kept records in the order the spans began, each device interval
    resolved (this waits for the card), and the list cleared."""
    global _kept, _dropped
    kept, dropped = _kept, _dropped
    _kept, _dropped = [], 0
    timed = [r for r in kept if r.events is not None and r.events[1] is not None]
    for dev in {r.events[2] for r in timed}:
        torch.cuda.synchronize(dev)
    origin: dict = {}
    for r in timed:
        start, end, dev = r.events
        first = origin.setdefault(dev, start)
        r.device_start_ms = first.elapsed_time(start)
        r.device_ms = start.elapsed_time(end)
    for r in kept:
        r.events = None
    out = SpanList(kept)
    out.dropped = dropped
    return out


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """Profile the block and write ``<logdir>/trace.json``; yields the
    profiler.  On ``device`` cuda (the default where there is a card) the
    card is traced too, and a trace holding none of its kernels raises
    rather than be written as a host-only trace.  The spans kept meanwhile
    are dropped at the end: the trace holds them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        spans()
    if cuda and not any(e.device_type == DeviceType.CUDA for e in prof.events()):
        raise RuntimeError("torch.profiler recorded no CUDA kernel on this machine; no trace "
                           "written")
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


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
