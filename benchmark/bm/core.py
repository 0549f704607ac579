"""One run of one cell: the manifest and the cell's files found by name, the
kind's set-up, window and judging, the per-layer readers, and the result
line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``,
whose ``family`` picks ``reference/<family>.py``) and a traffic mix
(``traffic/<name>.json``); the mix's ``kind`` picks
``bm/kinds/<kind>.py``; each per-layer metric is read by
``metrics/<name>.py``; the limits of the cell's compared numbers are
``limits/<cell>.json``.  Adding any of them adds files and entries only.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """Everything a kind needs to run one cell once."""

    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    manifest: dict
    t_start: float

    @property
    def name(self) -> str:
        return self.workload["name"]

    def end_to_end(self) -> list[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.manifest["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> list[dict]:
        """The per-layer metrics read in this cell's traced run: those whose
        ``workloads`` list it."""
        return [m for m in self.manifest["per_layer"] if self.name in m["workloads"]]


def make_cell(workload: str, seed: int, seconds: float, trace: bool, device, t_start: float,
              manifest: dict | None = None, config: dict | None = None,
              traffic: dict | None = None) -> Cell:
    """The cell named ``workload``; ``config`` and ``traffic`` replace the
    files where given (the CPU tests run tiny sizes that way)."""
    manifest = manifest or load_json(ROOT / "BENCHMARK.json")
    by_name = {w["name"]: w for w in manifest["workloads"]}
    if workload not in by_name:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(by_name)}")
    w = by_name[workload]
    cfg_file = {c["name"]: c["file"] for c in manifest["configs"]}[w["config"]]
    config = config or load_json(ROOT / cfg_file)
    traffic = traffic or load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    return Cell(workload=w, config=config, traffic=traffic, seed=int(seed),
                seconds=float(seconds), trace=bool(trace), device=device, manifest=manifest,
                t_start=t_start)


def family(cfg: dict):
    """The reference module of a configuration's ``family``
    (``reference/<family>.py``: ``judge``, ``separate``, ``loss``,
    ``forward_flops``), found by name."""
    return importlib.import_module(f"reference.{cfg['family']}")


def kind_module(cell: Cell):
    return importlib.import_module(f"bm.kinds.{cell.traffic['kind']}")


def metric_reader(name: str):
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bm_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Reading:
    """What a per-layer reader may read: the trace of the window, the
    harness's counters of the window, and the cell."""

    trace: object
    counters: dict
    cell: Cell


def span(name: str):
    """A harness span, visible to the profiler in a traced run."""
    import torch

    return torch.profiler.record_function(name)


class Clock:
    """The window's clock.  A kind calls ``done()`` after each unit of work
    (a job, a request, a step), which says whether the window has closed.  In
    a traced run the profiler records the window's first ``trace_seconds``
    (the traffic file's, at most ``--seconds``), stopped at the end of a
    unit; ``tracing``, read before ``done()``, says whether the unit just
    run was recorded, so that the counters the readers get are those of the
    traced units alone."""

    def __init__(self, cell: Cell):
        self.cell = cell
        self.seconds = cell.seconds
        self.trace_seconds = (min(cell.seconds, cell.traffic.get("trace_seconds", cell.seconds))
                              if cell.trace else 0.0)
        self.prof = None
        self.tracing = False
        self._span = None
        self.t0 = 0.0

    def open(self) -> None:
        if self.trace_seconds:
            from bm import trace as tracing

            self.prof = tracing.profiler()
            self.prof.__enter__()
            self._span = span("window")
            self._span.__enter__()
            self.tracing = True
        self.t0 = time.perf_counter()

    def _stop_trace(self) -> None:
        import torch

        if torch.device(self.cell.device).type == "cuda":
            torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.tracing = False

    def done(self) -> bool:
        elapsed = time.perf_counter() - self.t0
        if self.tracing and elapsed >= self.trace_seconds:
            self._stop_trace()
        return elapsed >= self.seconds

    def close(self) -> None:
        if self.tracing:
            self._stop_trace()


def port_model_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file's ``port`` entry."""
    from amss_tpu_torch.utils.config import FrontConfig, ModelConfig, SeparatorConfig

    p = dict(cfg["port"])
    return ModelConfig(front=FrontConfig(**p.pop("front")), sep=SeparatorConfig(**p.pop("sep")),
                       **p)


def set_precision(cfg: dict) -> None:
    """The configuration's float32 products: TF32 on or off for matrix
    products and cuDNN alike."""
    import torch

    tf32 = bool(cfg["precision"]["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def note(cell: Cell, what: str) -> None:
    """A set-up milestone on standard error, in seconds since the run began."""
    print(f"[{time.perf_counter() - cell.t_start:8.3f} s] {what}", file=sys.stderr, flush=True)


def limits(cell: Cell) -> dict:
    return load_json(BENCH_DIR / "limits" / f"{cell.name}.json")["numbers"]


def run(cell: Cell) -> tuple[dict, list[str]]:
    """Set up, warm up, measure, read, judge; returns (the result line's
    object, the lines of the numbers compared)."""
    import torch

    from bm import guard, trace as tracing

    kind = kind_module(cell)
    note(cell, "torch imported")
    state = kind.setup(cell)
    cuda = torch.device(cell.device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - cell.t_start
    note(cell, "set-up done; the window opens")
    clock = Clock(cell)
    clock.open()
    try:
        out = kind.window(cell, state, clock)
    finally:
        clock.close()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = guard.forbidden_loaded()
    if found:
        raise RuntimeError(f"forbidden modules loaded: {found}")

    result = {"correct": False, "attempted": out["attempted"], "failed": out["failed"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": int(peak)}
    if cell.trace:
        tr = tracing.read(clock.prof)
        reading = Reading(trace=tr, counters=out["counters"], cell=cell)
        metrics = {}
        for m in cell.per_layer():
            value = metric_reader(m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        breakdown = {"device_ops": [[n[:160], s] for n, s in tr.device_ops()[:10]],
                     "idle_gaps": [[n, s] for n, s in tr.idle_gaps()[:10]]}
    else:
        values = dict(out["e2e"], setup_s=setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end()}
        breakdown = None
    result["metrics"] = metrics
    result["device"] = device
    if breakdown is not None:
        result["breakdown"] = breakdown

    note(cell, "window closed and read; judging")
    numbers = kind.judge(cell, state)
    note(cell, "judged")
    lim = limits(cell)
    checks, lines, ok = {}, [], out["failed"] == 0
    for name, value in numbers.items():
        limit = lim[name]["limit"]
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value == value and value <= limit
        lines.append(f"check {name} = {value!r} (limit {limit!r})")
    result["correct"] = bool(ok)
    result["checks"] = checks
    found = guard.forbidden_loaded()
    if found:
        raise RuntimeError(f"forbidden modules loaded: {found}")
    return result, lines


def main(argv: list[str], t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bm import guard

    found = guard.forbidden_loaded()
    if found:
        print(f"forbidden modules loaded before the run: {found}", file=sys.stderr)
        return 3
    import torch

    manifest = load_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in manifest["workloads"]}.get(args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    cell = make_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda"), t_start, manifest)
    result, lines = run(cell)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
