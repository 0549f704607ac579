"""BENCHMARK.json against the contract the checks hold it to, and every file
it names present."""

import json
import re

import pytest

from bm import core

M = core.load_json(core.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_command_and_paths():
    assert set(M) == KEYS
    assert M["command"] == ["python3", "benchmark/run.py"] and len(M["command"]) <= 32
    assert M["paths"] == ["benchmark"]
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) for p in M["paths"])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) <= 64 * 1024


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
])
def test_entries_have_just_the_keys(section, keys):
    for e in M[section]:
        assert set(e) == keys, e
        assert NAME.match(e["name"]) and _line(e["why"])


def test_configs_files_and_reductions():
    for c in M["configs"]:
        cfg = core.load_json(core.ROOT / c["file"])
        assert c["file"].startswith("benchmark/")
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"] and _line(c["source"])
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["precision"] == {"dtype": "float32", "tf32": False}
    assert len({c["file"] for c in M["configs"]}) == len(M["configs"])
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}


def test_workloads_files_and_chips():
    names = [w["name"] for w in M["workloads"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    pairs = {(w["config"], w["traffic"]) for w in M["workloads"]}
    assert len(pairs) == len(names)
    for w in M["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        t = core.load_json(core.BENCH_DIR / "traffic" / f"{w['traffic']}.json")
        assert (core.BENCH_DIR / "bm" / "kinds" / f"{t['kind']}.py").exists()
        assert _line(t["source"])  # where the mix's sizes come from
        lim = core.load_json(core.BENCH_DIR / "limits" / f"{w['name']}.json")["numbers"]
        assert lim and all(v["limit"] > 0 for v in lim.values())
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(1, len(names) // 4)


def test_metrics():
    e2e = M["end_to_end"]
    names = [m["name"] for m in e2e + M["per_layer"]]
    assert len(set(names)) == len(names)
    assert "setup_s" in {m["name"] for m in e2e}
    cells = {w["name"] for w in M["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in M["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {x["name"] for x in e2e} and _line(m["layer"])
        assert (core.BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
        reporting = {c for x in e2e if x["name"] == m["moves"] for c in x.get("workloads", cells)}
        assert set(m["workloads"]) <= reporting
    for m in e2e + M["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in cells:  # setup_s, another end-to-end metric and a per-layer one in every cell
        cell = core.make_cell(c, 1, 1, False, "cpu", 0.0, M)
        assert len(cell.end_to_end()) >= 2 and cell.per_layer()


def test_a_full_check_fits_its_time_at_24_cells():
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
