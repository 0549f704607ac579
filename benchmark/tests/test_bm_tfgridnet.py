"""The TF-GridNet cell (``tfgridnet_wang2023.offline_wsj``) at tiny sizes on
the CPU, with the checks ``test_bm_dprnn.py`` makes of DPRNN-TasNet's: the
result line, the port against the reference, ``correct`` turning false under
each serving fault and under the attention attending to the padded frames'
keys, the control above the limit where the port is below it; and the
cell's own readers, operation count and parameter count."""

import json
from dataclasses import dataclass, field
from unittest import mock

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bm import core, faults
from bm.trace import Trace
from bm_tiny import tiny_cell, tiny_config

CELL = "tfgridnet_wang2023.offline_wsj"
NEW = ("serve.tfgridnet.intra.device_share", "serve.tfgridnet.inter.device_share",
       "serve.tfgridnet.attn.device_share", "serve.tfgridnet.masked_step_share")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _steps(own, grid, bins=65, k=4):
    """(steps, valid steps) of one call whose rows have ``own`` valid frames
    each in a bucket of ``grid`` frames: the intra rows of the own frames run
    whole (bins - k + 1 steps), the inter rows (one a bin) run the grid's
    frames and count their row's own."""
    intra = sum(own) * (bins - k + 1)
    return intra + len(own) * bins * (grid - k + 1), intra + bins * sum(v - k + 1 for v in own)


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
    # the tiny jobs: 0.3, 0.55 and 1.0 s twice (36, 67 and 124 frames), all in
    # the bucket of 8192 samples (127 frames), in batches of 4: rows of 36,
    # 36, 67 and 67 own frames, then 124 and 124, so that 20 020 of 76 508
    # steps lie past a row's own
    a, av = _steps([36, 36, 67, 67], 127)
    b, bv = _steps([124, 124], 127)
    assert a + b == 76508 and a - av + b - bv == 20020
    assert m["serve.tfgridnet.masked_step_share"] == pytest.approx(100.0 * 20020 / 76508)
    # the device intervals are timed on a card alone
    assert not set(NEW[:3]) & set(m)


@pytest.mark.parametrize("fault", [f for f in faults.SERVING
                                   if faults.applies(f, tiny_config("tfgridnet_wang2023"),
                                                     tiny_cell(CELL).traffic)])
def test_serving_faults_are_not_correct(fault):
    cell = tiny_cell(CELL)
    cell.traffic["check_sample"] = 64  # judge every answer, so the faulty rows are in
    with faults.SERVING[fault](cell.config):
        result, _ = core.run(cell)
    assert result["correct"] is False


def test_attention_to_padded_keys_is_not_correct():
    """The full-band attention attends to every frame of the bucket: a
    padded row's queries weigh the padded frames' keys too."""
    from amss_tpu_torch.models import tfgridnet

    cell = tiny_cell(CELL)
    cell.traffic["check_sample"] = 64
    real = tfgridnet._attention
    with mock.patch.object(tfgridnet, "_attention", lambda blk, z, keys: real(blk, z, None)):
        result, _ = core.run(cell)
    assert result["correct"] is False
    assert result["checks"]["serve.judged_error"]["value"] > 100 * core.limits(cell)[
        "serve.judged_error"]["limit"]


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


@pytest.mark.parametrize("t", [300, 1000])
def test_the_count_matches_the_references_products(t):
    """``forward_flops`` against PyTorch's count of the reference's products
    at tiny widths and two BLSTM layers a path: 3 frames, fewer than an
    unfold takes (no inter step), and 14."""
    from bm import flops, serving
    from reference import tfgridnet
    from reference.dsp import Products

    cfg = tiny_config("tfgridnet_wang2023")
    cfg["port"]["sep"]["layers"] = 2
    _, w = serving.port_model(cfg, 2**31 + 11, "cpu")
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        tfgridnet.separate(torch.randn(t), w, cfg, Products())
    assert counter.get_total_flops() == tfgridnet.forward_flops(cfg, t)
    assert flops.forward_flops(cfg, t) == tfgridnet.forward_flops(cfg, t)


def test_the_full_count_and_the_parameters():
    """0.796 TFLOP for a 6.0 s mixture at 8 kHz (749 frames), 84% of it in
    the 12 BLSTMs; the port's model holds the reference's count of
    parameters, 8 175 874."""
    from bm import serving
    from reference import tfgridnet

    cfg = core.load_json(core.BENCH_DIR / "configs" / "tfgridnet_wang2023.json")
    ops = tfgridnet.forward_flops(cfg, 48000)
    assert 7.9e11 < ops < 8.0e11
    no_rnn = dict(cfg, port=dict(cfg["port"], sep=dict(cfg["port"]["sep"], layers=0)))
    assert 0.83 * ops < ops - tfgridnet.forward_flops(no_rnn, 48000) < 0.85 * ops
    model, _ = serving.port_model(dict(cfg, init=[[".", "const", 0.0]]), 1, "cpu")
    assert sum(p.numel() for p in model.parameters()) == tfgridnet.parameters(cfg)
    assert tfgridnet.parameters(cfg) == cfg["parameters"] == 8_175_874


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
    """One job of one batch call, its block's paths and attention timed on
    a card."""
    recs = [_Rec("serve.job", 1, None, 1, 0, 10**9), _Rec("serve.batch", 2, 1, 1, 1, 9 * 10**8),
            _Rec("trunk", 3, 2, 1, 2, 8 * 10**8, device_ms=700.0)]
    spans = [("tfgridnet.intra", 300.0, dict(rows=5992, steps=371504, valid_steps=371504,
                                             blstm_path="packed")),
             ("tfgridnet.inter", 200.0, dict(rows=520, steps=397280, valid_steps=387920,
                                             blstm_path="packed")),
             ("tfgridnet.attn", 50.0, dict(frames=6136, valid_frames=5992, heads=4))]
    for i, (name, ms, attrs) in enumerate(spans):
        recs.append(_Rec(name, 4 + i, 3, 1, 3 + i, 4 + i, attrs, ms))
    return recs


def test_the_readers_on_timed_spans(monkeypatch):
    from amss_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", _records)
    r = _Reading(Trace(window=(0.0, 1.0), ops=[], spans=[("job", -0.01, 1.01)]))
    got = {name: core.metric_reader(name).read(r) for name in NEW}
    assert got[NEW[0]] == pytest.approx(30.0) and got[NEW[1]] == pytest.approx(20.0)
    assert got[NEW[2]] == pytest.approx(5.0)
    assert got[NEW[3]] == pytest.approx(100.0 * 9360 / 768784)


def test_the_readers_read_nothing_without_the_spans(monkeypatch):
    from amss_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: [_Rec("serve.job", 1, None, 1, 0, 10)])
    r = _Reading(Trace(window=(0.0, 1.0), ops=[], spans=[("job", -0.01, 1.01)]))
    assert all(core.metric_reader(name).read(r) is None for name in NEW)
