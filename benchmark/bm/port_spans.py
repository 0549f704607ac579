"""The port's own spans, for the per-layer readers: a bridge.

``bm/trace.py::read`` keeps the harness's spans alone, so the port's
(``amss_tpu_torch/utils/profiling.py::span``, kept while the profiler
records) are taken from the port itself, once per reading, with
``profiling.spans()``.  Their host times are on ``time.perf_counter``'s
clock; they are put on the trace's by pairing, in order, the port's root
spans (``serve.job``, ``train.step``) with the harness's spans that enclose
those calls directly (``job``, ``step``).  A harness span starts before the
port's and ends after it, so the offset lies at or above every start
difference and at or below every end difference; it is the middle of that
bracket, and there is none unless the counts match and the bracket is
at most ``MAX_SPREAD_S`` wide.  (A start difference alone can be late by a
switch of the interpreter's lock, as when the prefetch thread draws: the
bracket keeps the pairs that lag least.)  The trace's idle time (the
window less its busy intervals) is then split exactly, each piece of each gap
going to the innermost port span of the root spans' trees open over it, or
to none.

This module goes once ``bm/trace.py`` keeps the port's spans, whose ranges
in the trace share its clock already.  Against a port without spans every
reading here is None.
"""

from __future__ import annotations

from dataclasses import dataclass

ROOTS = {"serve.job": "job", "train.step": "step"}  # the port's root: the harness's span
MAX_SPREAD_S = 2e-4
MODEL = frozenset({"front", "trunk", "head", "cluster", "decode", "sync.lengths"})
_KEY = "_port_spans"


@dataclass
class PortSpans:
    """A reading's port spans (``records``, in start order), the offset of
    the trace's clock over the port's (seconds, None where the pairing
    fails) and the width of the bracket it was taken from (``align``)."""

    records: list
    offset: float | None
    spread: float | None

    def roots(self, name: str) -> set[int]:
        """The ids of the root spans named ``name``."""
        return {x.id for x in self.records if x.name == name and x.parent is None}

    def under(self, root: str, name: str) -> list:
        """The spans named ``name`` in the trees of the ``root`` spans."""
        ids = self.roots(root)
        return [x for x in self.records if x.name == name and x.root in ids]


def read(r) -> PortSpans | None:
    """The port's spans of the reading ``r``, taken once and kept on it; None
    where the port keeps none."""
    if _KEY not in vars(r):
        vars(r)[_KEY] = _take(r.trace)
    return vars(r)[_KEY]


def _take(trace) -> PortSpans | None:
    try:
        from amss_tpu_torch.utils import profiling

        take = profiling.spans
    except (ImportError, AttributeError):
        return None
    records = [x for x in take() if x.end_ns is not None]
    if not records:
        return None
    return PortSpans(records, *align(records, trace.spans))


def align(records: list, harness: list) -> tuple[float | None, float | None]:
    """(offset, spread): the trace's clock minus the port's, in seconds, and
    the width of the bracket it was taken from, by the first root name of
    ``ROOTS`` that the port's ``records`` hold, paired in order with the
    harness's spans ``(name, t0, t1)``.  The offset is None where the counts
    differ, the bracket is empty (a harness span does not enclose its port
    span) or wider than ``MAX_SPREAD_S``."""
    for port_name, harness_name in ROOTS.items():
        port = sorted((x for x in records if x.name == port_name and x.parent is None),
                      key=lambda x: x.start_ns)
        if not port:
            continue
        theirs = sorted((s for s in harness if s[0] == harness_name), key=lambda s: s[1])
        if len(theirs) != len(port):
            return None, None
        low = max(h[1] - p.start_ns * 1e-9 for h, p in zip(theirs, port))
        high = min(h[2] - p.end_ns * 1e-9 for h, p in zip(theirs, port))
        spread = high - low
        if not 0.0 <= spread <= MAX_SPREAD_S:
            return None, spread
        return 0.5 * (low + high), spread
    return None, None


def idle_gaps(trace) -> list[tuple[float, float]]:
    """The window less the union of device operations."""
    w0, w1 = trace.window
    out, t = [], w0
    for a, b in trace.busy_intervals():
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if w1 > t:
        out.append((t, w1))
    return out


def _segments(ps: PortSpans) -> list[tuple[float, float, tuple[str, ...]]]:
    """Consecutive pieces of the trace's clock, each with the chain of names
    (root first) of the innermost span of a root's tree open over it; ``()``
    where none is."""
    roots = set().union(*(ps.roots(n) for n in ROOTS))
    by_id = {x.id: x for x in ps.records}
    tree = [x for x in ps.records if x.root in roots]
    chain: dict[int, tuple[str, ...]] = {}
    for x in tree:  # in start order: a parent comes before its children
        chain[x.id] = chain.get(x.parent, ()) + (x.name,) if x.parent in by_id else (x.name,)
    edges = []
    for x in tree:
        edges.append((x.start_ns * 1e-9 + ps.offset, 1, x.id))
        edges.append((x.end_ns * 1e-9 + ps.offset, 0, x.id))
    edges.sort()
    out, open_, last = [], {}, None
    for t, starts, sid in edges:
        if last is not None and t > last:
            inner = max(open_.values(), key=len) if open_ else ()
            out.append((last, t, inner))
        if starts:
            open_[sid] = chain[sid]
        else:
            open_.pop(sid, None)
        last = t
    return out


def idle_split(r) -> dict[tuple[str, ...], float] | None:
    """The trace's idle seconds by the chain of names (root first) of the
    innermost port span open over them (``()``: none), summing to the idle
    time of the window; None without spans or an offset."""
    ps = read(r)
    if ps is None or ps.offset is None:
        return None
    gaps, segs = idle_gaps(r.trace), _segments(ps)
    out: dict[tuple[str, ...], float] = {}
    i = 0
    for a, b in gaps:
        t = a
        while i < len(segs) and segs[i][1] <= t:
            i += 1
        j = i
        while t < b:
            if j >= len(segs) or segs[j][0] >= b:
                out[()] = out.get((), 0.0) + (b - t)
                break
            s0, s1, names = segs[j]
            if s0 > t:  # before the next piece: no span open
                out[()] = out.get((), 0.0) + (s0 - t)
                t = s0
            end = min(s1, b)
            out[names] = out.get(names, 0.0) + (end - t)
            t = end
            j += 1
    return out


def idle_share(r, keep) -> float | None:
    """The share (%) of the window idle while the port's innermost open span
    had the chain ``names`` for which ``keep(names)`` holds."""
    split = idle_split(r)
    if split is None:
        return None
    return 100.0 * sum(s for names, s in split.items() if keep(names)) / r.trace.window_s


def device_share(r, root: str, name: str) -> float | None:
    """The share (%) of the window in the device intervals of the spans
    ``name`` under the ``root`` spans; None where none was timed."""
    ps = read(r)
    if ps is None:
        return None
    ms = [x.device_ms for x in ps.under(root, name) if x.device_ms is not None]
    if not ms:
        return None
    return 100.0 * 1e-3 * sum(ms) / r.trace.window_s
