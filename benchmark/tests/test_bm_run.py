"""Whole runs of each cell at tiny sizes on the CPU: the result line's
schema, the port against the reference, and ``correct`` turning false under
each fault a cell can have, planted in the port underneath the harness."""

import json

import pytest
import torch

from bm import core, faults
from bm_tiny import tiny_cell

SERVING = ["dpcl_hershey2016.offline_wsj", "convtasnet_luo2019.offline_wsj"]
TRAIN = "convtasnet_luo2019.train_4s"
ALL = SERVING + [TRAIN]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", ALL)
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(workload, trace):
    cell = tiny_cell(workload, trace=bool(trace))
    result, lines = core.run(cell)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    names = {m["name"] for m in (cell.per_layer() if trace else cell.end_to_end())}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
    else:
        assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert len(lines) == len(line["checks"]) and all(
        c["value"] <= c["limit"] for c in line["checks"].values())


def _fitting(table, workloads):
    return [(w, f) for w in workloads for f in table
            if faults.applies(f, (c := tiny_cell(w)).config, c.traffic)]


@pytest.mark.parametrize("workload,fault", _fitting(faults.SERVING, SERVING))
def test_serving_faults_are_not_correct(workload, fault):
    cell = tiny_cell(workload)
    cell.traffic["check_sample"] = 64  # judge every answer, so the faulty rows are in
    with faults.SERVING[fault](cell.config):
        result, _ = core.run(cell)
    assert result["correct"] is False


@pytest.mark.parametrize("fault", sorted(faults.TRAINING))
def test_training_faults_are_not_correct(fault):
    cell = tiny_cell(TRAIN)
    cell.traffic["batch_size"] = 4
    with faults.TRAINING[fault](cell.config):
        result, _ = core.run(cell)
    assert result["correct"] is False


@pytest.mark.parametrize("workload", ALL)
def test_the_control_fails_where_the_port_passes(workload):
    """The reference with TF32 products in the port's place reads above the
    cell's limit, on the same tiny cell on which the port reads below it."""
    kind = core.kind_module(tiny_cell(workload))
    prog = kind.judge(cell := tiny_cell(workload), _windowed(kind, cell))
    ctrl = kind.control(cell := tiny_cell(workload), kind.setup(cell))
    lim = core.limits(cell)
    assert all(prog[n] <= lim[n]["limit"] for n in prog)
    assert any(ctrl[n] > lim[n]["limit"] for n in ctrl)


def _windowed(kind, cell):
    state = kind.setup(cell)
    clock = core.Clock(cell)
    clock.open()
    kind.window(cell, state, clock)
    return state
