"""The DPRNN-TasNet cell (``dprnn_luo2020.offline_wsj``) at tiny sizes on the
CPU, with the checks ``test_bm_sepformer.py`` makes of SepFormer's: the
result line, the port against the reference, ``correct`` turning false under
each serving fault and under inter rows run unmasked, the control above the
limit where the port is below it; and the cell's own readers and operation
count."""

import json
from dataclasses import dataclass, field
from unittest import mock

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bm import core, faults
from bm.trace import Trace
from bm_tiny import tiny_cell, tiny_config

CELL = "dprnn_luo2020.offline_wsj"
NEW = ("serve.dprnn.intra.device_share", "serve.dprnn.inter.device_share",
       "serve.dprnn.masked_step_share", "serve.dprnn.kernel_share")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _steps(own, grid):
    """(steps, valid steps) of one call whose rows have ``own`` valid frames
    each in a bucket of ``grid`` frames, chunks of 250 at hop 125: the intra
    rows of the rows' own chunks run whole, the inter rows (250 a row) run
    over the grid's chunks and count their row's own."""
    from amss_tpu_torch.models.dprnn import segments

    s = sum(segments(v, 250) for v in own)
    return s * 250 + len(own) * 250 * segments(grid, 250), 2 * s * 250


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
    # the tiny jobs: 0.3, 0.55 and 1.0 s twice (2399, 4399 and 7999 frames),
    # all in the bucket of 8192 samples (8191 frames, 68 chunks), in batches
    # of 4: rows of 22, 22, 38 and 38 own chunks, then 66 and 66, so that 39000
    # of 165000 steps lie past a row's own
    a, av = _steps([2399, 2399, 4399, 4399], 8191)
    b, bv = _steps([7999, 7999], 8191)
    assert a + b == 165000 and a - av + b - bv == 39000
    assert m["serve.dprnn.masked_step_share"] == pytest.approx(100.0 * 39000 / 165000)
    # the device intervals are timed on a card alone
    assert not set(NEW) - {"serve.dprnn.masked_step_share"} & set(m)


@pytest.mark.parametrize("fault", [f for f in faults.SERVING
                                   if faults.applies(f, tiny_config("dprnn_luo2020"),
                                                     tiny_cell(CELL).traffic)])
def test_serving_faults_are_not_correct(fault):
    cell = tiny_cell(CELL)
    cell.traffic["check_sample"] = 64  # judge every answer, so the faulty rows are in
    with faults.SERVING[fault](cell.config):
        result, _ = core.run(cell)
    assert result["correct"] is False


def test_inter_rows_run_unmasked_are_not_correct():
    """Every inter row runs the grid's chunks: a short row's backward
    recurrence enters through the bucket's padded chunks."""
    from amss_tpu_torch.models import sepformer

    cell = tiny_cell(CELL)
    cell.traffic["check_sample"] = 64
    with mock.patch.object(sepformer, "inter_rows", lambda own, b, k, p: (
            None, torch.full((b * k,), p, dtype=torch.int64))):
        result, _ = core.run(cell)
    assert result["correct"] is False


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
    at tiny widths and two BLSTM layers a path (the mixture shorter and longer
    than a chunk)."""
    from bm import flops, serving
    from reference import dprnn
    from reference.dsp import Products

    cfg = tiny_config("dprnn_luo2020")
    cfg["port"]["sep"]["chunk_frames"] = 16
    _, w = serving.port_model(cfg, 2**31 + 11, "cpu")
    for t in (11, 100):
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            dprnn.forward(torch.randn(1, t), w, cfg, Products())
        assert counter.get_total_flops() == dprnn.forward_flops(cfg, t)
        assert flops.forward_flops(cfg, t) == dprnn.forward_flops(cfg, t)


def test_the_full_count_is_the_papers_order():
    """497.7 GFLOP for a 6.0 s mixture at 8 kHz (386 chunks of 250), about
    90% of it in the 12 BLSTMs; 2.6 M parameters."""
    from reference import dprnn

    cfg = core.load_json(core.BENCH_DIR / "configs" / "dprnn_luo2020.json")
    ops = dprnn.forward_flops(cfg, 48000)
    assert 4.9e11 < ops < 5.0e11
    no_rnn = dict(cfg, port=dict(cfg["port"], sep=dict(cfg["port"]["sep"], blocks=0)))
    assert 0.85 * ops < ops - dprnn.forward_flops(no_rnn, 48000) < 0.95 * ops
    assert dprnn.parameters(cfg) == cfg["parameters"]
    assert 2.55e6 < cfg["parameters"] < 2.65e6


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
    """One job of one batch call, its block's two paths timed on a card."""
    recs = [_Rec("serve.job", 1, None, 1, 0, 10**9), _Rec("serve.batch", 2, 1, 1, 1, 9 * 10**8),
            _Rec("trunk", 3, 2, 1, 2, 8 * 10**8, device_ms=700.0)]
    paths = [("dprnn.intra", 300.0, dict(rows=3088, steps=772000, valid_steps=772000,
                                         blstm_path="packed")),
             ("dprnn.inter", 100.0, dict(rows=2000, steps=792000, valid_steps=772000,
                                         blstm_path="kernel"))]
    for i, (name, ms, attrs) in enumerate(paths):
        recs.append(_Rec(name, 4 + i, 3, 1, 3 + i, 4 + i, attrs, ms))
    return recs


def test_the_readers_on_timed_spans(monkeypatch):
    from amss_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", _records)
    r = _Reading(Trace(window=(0.0, 1.0), ops=[], spans=[("job", -0.01, 1.01)]))
    got = {name: core.metric_reader(name).read(r) for name in NEW}
    assert got[NEW[0]] == pytest.approx(30.0) and got[NEW[1]] == pytest.approx(10.0)
    assert got[NEW[2]] == pytest.approx(100.0 * 20000 / 1564000)
    assert got[NEW[3]] == pytest.approx(25.0)


def test_the_readers_read_nothing_without_the_spans(monkeypatch):
    from amss_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: [_Rec("serve.job", 1, None, 1, 0, 10)])
    r = _Reading(Trace(window=(0.0, 1.0), ops=[], spans=[("job", -0.01, 1.01)]))
    assert all(core.metric_reader(name).read(r) is None for name in NEW)
