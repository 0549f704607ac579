"""The traced window: ``torch.profiler`` over the window, read back as
device intervals and the harness's own spans.

The harness opens spans (``torch.profiler.record_function``) only around its
own calls into the port: ``window`` around the whole window, ``job``,
``request``, ``step`` and ``draw`` inside it, ``warmup`` in set-up.  The
trace goes to a file under ``TMPDIR``, is parsed, and the file is deleted.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = ("warmup", "job", "request", "step", "draw")


@dataclass
class Trace:
    """Device operations and host spans of a traced window, in seconds on
    the profiler's clock."""

    window: tuple[float, float]
    ops: list[tuple[str, str, float, float]] = field(default_factory=list)  # cat, name, t0, t1
    spans: list[tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self, substring: str | None = None) -> list[tuple[str, float, float]]:
        """The kernels that started inside the window, by name substring."""
        w0, w1 = self.window
        return [(n, a, b) for c, n, a, b in self.ops
                if c == "kernel" and w0 <= a < w1 and (substring is None or substring in n)]

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of device operations, clipped to the window."""
        w0, w1 = self.window
        ivs = sorted((max(a, w0), min(b, w1)) for _, _, a, b in self.ops if b > w0 and a < w1)
        merged: list[list[float]] = []
        for a, b in ivs:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def idle_gaps(self) -> list[tuple[str, float]]:
        """Idle time by the innermost harness span open at each gap's middle
        (``none`` where no span of the harness was open)."""
        w0, w1 = self.window
        busy = self.busy_intervals()
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        by_name: dict[str, tuple[list[float], list[tuple[float, float]]]] = {}
        for n, s0, s1 in sorted(self.spans, key=lambda s: s[1]):
            starts, ivs = by_name.setdefault(n, ([], []))
            starts.append(s0)
            ivs.append((s0, s1))
        out: dict[str, float] = {}
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid, name, best = 0.5 * (a + b), "none", float("inf")
            for n, (starts, ivs) in by_name.items():
                i = bisect.bisect_right(starts, mid) - 1
                # spans of one name may overlap (a draw thread): look back a little
                for s0, s1 in ivs[max(i - 2, 0):i + 1]:
                    if s0 <= mid <= s1 and s1 - s0 < best:
                        name, best = n, s1 - s0
            out[name] = out.get(name, 0.0) + (b - a)
        return sorted(out.items(), key=lambda kv: -kv[1])

    def device_ops(self) -> list[tuple[str, float]]:
        """Seconds per device operation name inside the window, largest first."""
        w0, w1 = self.window
        out: dict[str, float] = {}
        for _, n, a, b in self.ops:
            d = min(b, w1) - max(a, w0)
            if d > 0:
                out[n] = out.get(n, 0.0) + d
        return sorted(out.items(), key=lambda kv: -kv[1])


def profiler() -> torch.profiler.profile:
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)


def read(prof: torch.profiler.profile) -> Trace:
    """Parse a finished profile's chrome trace; the window is the span named
    ``window``."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bm_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    ops, spans, window = [], [], None
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        t0 = float(ev["ts"]) * 1e-6
        t1 = t0 + float(ev["dur"]) * 1e-6
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            ops.append((cat, ev.get("name", ""), t0, t1))
        elif cat == "user_annotation":
            name = ev.get("name", "")
            if name == "window":
                window = (t0, t1)
            elif name in SPANS:
                spans.append((name, t0, t1))
    if window is None:
        raise RuntimeError("the trace holds no 'window' span")
    return Trace(window=window, ops=ops, spans=spans)
