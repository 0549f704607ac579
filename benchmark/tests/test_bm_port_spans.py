"""``bm/port_spans.py``: the port's spans put on the trace's clock through
the harness's root spans, and the trace's idle time split exactly by the
innermost port span open over it; on synthetic traces and spans with a known
offset, and on tiny traced runs on the CPU."""

from dataclasses import dataclass, field

import pytest

from bm import core, port_spans
from bm.trace import Trace
from bm_tiny import tiny_cell

OFFSET = 1234.5  # the trace's clock minus the port's, seconds


@dataclass
class Rec:
    name: str
    id: int
    parent: int | None
    root: int
    start_ns: int
    end_ns: int
    attrs: dict = field(default_factory=dict)
    device_ms: float | None = None


def _ns(t):
    return round(t * 1e9)


def _tree(jobs):
    """Records of ``jobs``: each ``(t0, t1, [(name, t0, t1, [children])])`` on
    the port's clock (seconds)."""
    recs, ids = [], iter(range(1, 10_000))

    def add(name, t0, t1, parent, root, kids):
        rid = next(ids)
        recs.append(Rec(name, rid, parent, root if root else rid, _ns(t0), _ns(t1)))
        for k in kids:
            add(*k[:3], rid, root or rid, k[3] if len(k) > 3 else [])

    for t0, t1, kids in jobs:
        add("serve.job", t0, t1, None, None, kids)
    return sorted(recs, key=lambda r: r.start_ns)


JOBS = [
    (10.0, 10.5, [("serve.pack", 10.0, 10.05),
                  ("serve.batch", 10.05, 10.3, [("front", 10.05, 10.1),
                                                ("trunk", 10.1, 10.25, [("sync.lengths", 10.1, 10.12)])]),
                  ("serve.copy_out", 10.35, 10.45)]),
    (10.6, 11.0, [("serve.batch", 10.6, 10.9, [("cluster", 10.7, 10.8)])]),
]


def _trace(busy, jitter=(0.0, 0.0)):
    """A trace over the port's [9.9, 11.1] s, shifted by OFFSET, with the
    harness's ``job`` spans around the port's jobs (starts earlier and ends
    later by ``jitter``, or by each job's of a list) and device operations at
    ``busy``."""
    lags = jitter if isinstance(jitter, list) else [jitter] * len(JOBS)
    spans = [("job", OFFSET + t0 - a, OFFSET + t1 + b) for (t0, t1, _), (a, b) in zip(JOBS, lags)]
    ops = [("kernel", "k", OFFSET + a, OFFSET + b) for a, b in busy]
    return Trace(window=(OFFSET + 9.9, OFFSET + 11.1), ops=ops, spans=spans)


class Reading:
    def __init__(self, trace, records):
        self.trace = trace
        self.records = records


@pytest.fixture
def take(monkeypatch):
    """``profiling.spans`` replaced by the reading's own records."""
    from amss_tpu_torch.utils import profiling

    def use(r):
        monkeypatch.setattr(profiling, "spans", lambda: list(r.records))
        return r

    return use


def test_the_offset_is_found_and_the_idle_time_split_exactly(take):
    busy = [(9.95, 10.02), (10.11, 10.2), (10.5, 10.55), (10.65, 10.75)]
    r = take(Reading(_trace(busy, jitter=(4e-6, 9e-6)), _tree(JOBS)))
    ps = port_spans.read(r)
    assert ps.offset == pytest.approx(OFFSET, abs=1e-5) and ps.spread == pytest.approx(1.3e-5)
    split = port_spans.idle_split(r)
    want = {
        (): 0.05 + 0.05 + 0.1,  # 9.9-9.95, 10.55-10.6, 11.0-11.1
        ("serve.job", "serve.pack"): 0.03,  # 10.02-10.05
        ("serve.job", "serve.batch", "front"): 0.05,  # 10.05-10.1
        ("serve.job", "serve.batch", "trunk", "sync.lengths"): 0.01,  # 10.1-10.11
        ("serve.job", "serve.batch", "trunk"): 0.05,  # 10.2-10.25
        ("serve.job", "serve.batch"): 0.05 + 0.05 + 0.1,  # 10.25-10.3, 10.6-10.65, 10.8-10.9
        ("serve.job",): 0.05 + 0.05 + 0.1,  # 10.3-10.35, 10.45-10.5, 10.9-11.0
        ("serve.job", "serve.copy_out"): 0.1,  # 10.35-10.45
        ("serve.job", "serve.batch", "cluster"): 0.05,  # 10.75-10.8
    }
    assert set(split) == set(want)
    for k, v in want.items():
        assert split[k] == pytest.approx(v, abs=2e-5), k
    idle = 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
    model = port_spans.idle_share(r, lambda n: bool(port_spans.MODEL.intersection(n)))
    serving = port_spans.idle_share(
        r, lambda n: n[:1] == ("serve.job",) and not port_spans.MODEL.intersection(n))
    none = port_spans.idle_share(r, lambda n: n == ())
    assert model + serving + none == pytest.approx(idle, abs=1e-9)
    assert model == pytest.approx(100 * 0.16 / 1.2, abs=2e-3)


def test_the_spans_are_taken_once_per_reading(take):
    r = take(Reading(_trace([]), _tree(JOBS)))
    first = port_spans.read(r)
    r.records = []
    assert port_spans.read(r) is first


def test_a_late_start_does_not_move_the_offset(take):
    """The port's first job began 0.4 ms after the harness's (the lock was
    elsewhere): the bracket is set by the pairs that lag least."""
    r = take(Reading(_trace([], jitter=[(4e-4, 9e-6), (4e-6, 9e-6)]), _tree(JOBS)))
    ps = port_spans.read(r)
    assert ps.offset == pytest.approx(OFFSET + 2.5e-6, abs=1e-9)
    assert ps.spread == pytest.approx(1.3e-5, abs=1e-9)


@pytest.mark.parametrize("jobs,jitter", [
    (JOBS[:1], (0.0, 0.0)),  # the harness ran two jobs, the port kept one
    (JOBS, (0.0, 2.5e-4)),  # the offset is known within 0.25 ms only
    (JOBS, (-1e-4, 0.0)),  # the harness's spans do not enclose the port's
])
def test_no_offset_where_the_pairing_fails(take, jobs, jitter):
    r = take(Reading(_trace([(10.0, 10.1)], jitter=jitter), _tree(jobs)))
    assert port_spans.read(r).offset is None
    assert port_spans.idle_split(r) is None
    assert port_spans.idle_share(r, lambda n: True) is None


def test_device_shares_sum_the_timed_spans_under_the_roots(take):
    recs = _tree(JOBS)
    for x in recs:
        x.device_ms = {"front": 20.0, "trunk": 60.0, "cluster": 30.0}.get(x.name)
    recs.append(Rec("front", 999, None, 999, _ns(10.95), _ns(10.99), device_ms=500.0))
    r = take(Reading(_trace([]), recs))
    assert port_spans.device_share(r, "serve.job", "front") == pytest.approx(100 * 0.02 / 1.2)
    assert port_spans.device_share(r, "serve.job", "decode") is None
    assert port_spans.device_share(r, "train.step", "train.forward") is None


def test_a_port_without_spans_reads_nothing(monkeypatch):
    from amss_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    r = Reading(_trace([]), [])
    assert port_spans.read(r) is None
    for name in ("serve.front.device_share", "serve.idle_share.model", "serve.syncs_per_call",
                 "serve.pad_share.program", "train.idle_share.backward"):
        assert core.metric_reader(name).read(r) is None


@pytest.mark.parametrize("workload", ["dpcl_hershey2016.offline_wsj",
                                      "convtasnet_luo2019.offline_wsj",
                                      "convtasnet_luo2019.train_4s"])
def test_tiny_traced_runs_read_the_new_metrics(workload):
    """On the CPU: every program-span metric but the device intervals reads
    a number; the idle split sums to the trace's idle share; the padding
    from the spans is the harness's."""
    result, _ = core.run(tiny_cell(workload, trace=True))
    m = {k: v["value"] for k, v in result["metrics"].items()}
    if workload.endswith("train_4s"):
        for what in ("forward", "backward", "optimizer"):
            assert f"train.idle_share.{what}" in m
            assert f"train.{what}.device_share" not in m  # no timing events off the card
        parts = sum(m[f"train.idle_share.{w}"] for w in ("forward", "backward", "optimizer"))
        assert 0.0 <= parts <= m["device.idle_share.train"] + 1e-9
        return
    assert m["serve.pad_share.program"] == pytest.approx(m["serve.pad_share"], abs=1e-9)
    assert m["serve.idle_share.model"] > 0.0 and m["serve.idle_share.serving"] > 0.0
    assert m["serve.idle_share.model"] + m["serve.idle_share.serving"] <= (
        m["device.idle_share.serve"] + 1e-9)
    assert m["serve.syncs_per_call"] >= 1.0  # each batch's copy out at least
    assert "serve.front.device_share" not in m
