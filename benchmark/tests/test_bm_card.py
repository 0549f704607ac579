"""Every cell of BENCHMARK.json run once on the card, briefly, through the
same path as ``run.py``: ``correct`` true, the card named, every metric
present.  Skips without a card."""

import time

import pytest

from bm import core

CELLS = [w["name"] for w in core.load_json(core.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(workload, trace, card):
    import torch

    cell = core.make_cell(workload, 3_000_000_123 + trace, 3.0, bool(trace), card,
                          time.perf_counter())
    result, _ = core.run(cell)
    assert result["correct"] is True and result["failed"] == 0
    assert result["device"]["kind"] == torch.cuda.get_device_name(0)
    names = {m["name"] for m in (cell.per_layer() if trace else cell.end_to_end())}
    assert set(result["metrics"]) <= names and result["metrics"]
