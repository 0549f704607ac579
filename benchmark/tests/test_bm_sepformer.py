"""The SepFormer cell (``sepformer_subakan2021.offline_wsj``) at tiny sizes on
the CPU, with the checks ``test_bm_run.py`` makes of the other cells: the
result line, the port against the reference, ``correct`` turning false under
each serving fault, the control above the limit where the port is below it;
and the cell's own readers and operation count."""

import json
from dataclasses import dataclass, field

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bm import core, faults
from bm.trace import Trace
from bm_tiny import tiny_cell, tiny_config

CELL = "sepformer_subakan2021.offline_wsj"
NEW = ("serve.sepformer.intra.device_share", "serve.sepformer.inter.device_share",
       "serve.sepformer.masked_chunk_share")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(trace):
    cell = tiny_cell(CELL, trace=bool(trace))
    result, lines = core.run(cell)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert len(lines) == len(line["checks"]) == 1
    if not trace:
        assert set(line["metrics"]) == {"audio_s_per_s", "setup_s"}
        return
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(m) <= {x["name"] for x in cell.per_layer()} and set(NEW) <= {
        x["name"] for x in cell.per_layer()}
    # the tiny jobs: 0.3, 0.55 and 1.0 s twice, in the 1 s bucket (999 frames,
    # 10 chunks of 250 at hop 125), batches of 4: rows of 4, 4, 6, 6 own
    # chunks, then 10, 10, so 20 of 60 chunks are masked
    assert m["serve.sepformer.masked_chunk_share"] == pytest.approx(100.0 * 20 / 60)
    # the device intervals are timed on a card alone
    assert NEW[0] not in m and NEW[1] not in m and "serve.trunk.device_share" not in m


@pytest.mark.parametrize("fault", [f for f in faults.SERVING
                                   if faults.applies(f, tiny_config("sepformer_subakan2021"),
                                                     tiny_cell(CELL).traffic)])
def test_serving_faults_are_not_correct(fault):
    cell = tiny_cell(CELL)
    cell.traffic["check_sample"] = 64  # judge every answer, so the faulty rows are in
    with faults.SERVING[fault](cell.config):
        result, _ = core.run(cell)
    assert result["correct"] is False


def test_both_serving_faults_fit_the_cell():
    cell = tiny_cell(CELL)
    fit = {f for f in faults.SERVING if faults.applies(f, cell.config, cell.traffic)}
    assert fit == {"altered_answer", "half_batch"}


def test_the_control_fails_where_the_port_passes():
    """The reference with TF32 products in the port's place reads above the
    cell's limit, on the same tiny cell on which the port reads below it."""
    kind = core.kind_module(cell := tiny_cell(CELL))
    state = kind.setup(cell)
    clock = core.Clock(cell)
    clock.open()
    kind.window(cell, state, clock)
    prog = kind.judge(cell, state)
    ctrl = kind.control(cell := tiny_cell(CELL), kind.setup(cell))
    lim = core.limits(cell)
    assert all(prog[n] <= lim[n]["limit"] for n in prog)
    assert any(ctrl[n] > lim[n]["limit"] for n in ctrl)


def test_the_count_matches_the_references_products():
    """``forward_flops`` against PyTorch's count of the reference's products
    at tiny widths (two chunk grids: the mixture shorter and longer than a
    chunk)."""
    from bm import flops, serving
    from reference import sepformer
    from reference.dsp import Products

    cfg = tiny_config("sepformer_subakan2021")
    _, w = serving.port_model(cfg, 2**31 + 11, "cpu")
    for t in (16 + 8 * 99, 16 + 8 * 700):
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            sepformer.forward(torch.randn(1, t), w, cfg, Products())
        assert counter.get_total_flops() == sepformer.forward_flops(cfg, t)
        assert flops.forward_flops(cfg, t) == sepformer.forward_flops(cfg, t)


def test_the_full_count_is_the_papers_order():
    """699.5 GFLOP for a 6.0 s mixture at 8 kHz (50 chunks of 250), over 98%
    of it in the 32 layers."""
    from reference import sepformer

    cfg = core.load_json(core.BENCH_DIR / "configs" / "sepformer_subakan2021.json")
    ops = sepformer.forward_flops(cfg, 48000)
    assert 6.9e11 < ops < 7.1e11
    layers = dict(cfg, port=dict(cfg["port"], sep=dict(cfg["port"]["sep"], blocks=0)))
    assert sepformer.forward_flops(layers, 48000) < 0.02 * ops
    assert sepformer.parameters(cfg) == cfg["parameters"]


@dataclass
class _Rec:
    name: str
    id: int
    parent: int | None
    root: int
    start_ns: int
    end_ns: int
    attrs: dict = field(default_factory=dict)
    device_ms: float | None = None


class _Reading:
    def __init__(self, trace):
        self.trace = trace


def _records():
    """One job of one batch call, its two repeats' spans timed on a card."""
    recs = [_Rec("serve.job", 1, None, 1, 0, 10**9), _Rec("serve.batch", 2, 1, 1, 1, 9 * 10**8),
            _Rec("trunk", 3, 2, 1, 2, 8 * 10**8, device_ms=700.0)]
    attrs = {"chunks": 416, "valid_chunks": 400, "rows": 8}
    for i, (name, ms) in enumerate([("sepformer.intra", 200.0), ("sepformer.inter", 150.0)] * 2):
        recs.append(_Rec(name, 4 + i, 3, 1, 3 + i, 4 + i, dict(attrs), ms))
    return recs


def test_the_readers_on_timed_spans(monkeypatch):
    from amss_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", _records)
    r = _Reading(Trace(window=(0.0, 1.0), ops=[], spans=[("job", -0.01, 1.01)]))
    got = {name: core.metric_reader(name).read(r) for name in NEW}
    assert got[NEW[0]] == pytest.approx(40.0) and got[NEW[1]] == pytest.approx(30.0)
    assert got[NEW[2]] == pytest.approx(100.0 * 2 / 52)


def test_the_readers_read_nothing_without_the_spans(monkeypatch):
    from amss_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: [_Rec("serve.job", 1, None, 1, 0, 10)])
    r = _Reading(Trace(window=(0.0, 1.0), ops=[], spans=[("job", -0.01, 1.01)]))
    assert all(core.metric_reader(name).read(r) is None for name in NEW)
