"""The port's spans (``amss_tpu_torch/utils/profiling.py::span``) on the CPU.

Off, a span is the shared null context and keeps nothing.  Inside
``recording()`` serving keeps the tree ``serve.job`` > ``serve.pack``,
``serve.batch`` (> ``front``, ``trunk``, ``head``, ``cluster``, ``decode``),
``serve.copy_out``, ``sync.end``; a training step ``train.step`` >
``train.gather``, ``train.forward``, ``train.backward``, ``train.optimizer``
(> ``train.clip``), and the prefetch thread's ``train.draw`` stands apart.
Under ``torch.profiler`` the kept spans are the Chrome trace's
``user_annotation`` ranges of the same names, nesting and order."""

import dataclasses
import json
import sys
import threading

import numpy as np
import pytest
import torch

from amss_tpu_torch.configs import recipes
from amss_tpu_torch.data.prefetch import Prefetcher
from amss_tpu_torch.data.store import SpeakerStore
from amss_tpu_torch.data.synthetic import make_synthetic_corpus
from amss_tpu_torch.infer.streaming import StreamingSeparator
from amss_tpu_torch.models.dpcl import DPCLModel
from amss_tpu_torch.models.tasnet import TasNetModel
from amss_tpu_torch.train.engine import Trainer
from amss_tpu_torch.utils import profiling
from amss_tpu_torch.utils.config import FrontConfig, ModelConfig, SeparatorConfig
from amss_tpu_torch.utils.profiling import recording, span, spans

torch.set_num_threads(2)

LENGTHS = (3000, 5200, 9000, 7100, 4000, 12000, 2500)
MAX_BATCH = 2


def _c1():
    cfg = ModelConfig(kind="dpcl", front=FrontConfig(kind="stft", win=256, hop=64),
                      sep=SeparatorConfig(hidden=8, layers=1, embed_dim=5), nb_speakers=2)
    model = DPCLModel(cfg)
    model.init_parameters(torch.Generator().manual_seed(0))
    return model


def _tasnet():
    cfg = ModelConfig(kind="tasnet",
                      front=FrontConfig(kind="adapt", n_filters=16, filter_len=16, stride=8,
                                        pool=1),
                      sep=SeparatorConfig(hidden=8, trunk="tcn", blocks=2, repeats=1),
                      nb_speakers=2)
    model = TasNetModel(cfg)
    model.init_parameters(torch.Generator().manual_seed(0))
    return model


MODELS = {"c1": (_c1, ["front", "trunk", "head", "cluster", "decode"]),
          "tasnet": (_tasnet, ["front", "trunk", "head", "decode"])}


@pytest.fixture(autouse=True)
def _empty():
    spans()
    yield
    spans()


def _waves():
    rng = np.random.default_rng(0)
    return [rng.standard_normal(n).astype(np.float32) for n in LENGTHS]


def _children(recs):
    out: dict = {}
    for r in recs:
        out.setdefault(r.parent, []).append(r)
    return out


def _raise(*a, **k):
    raise AssertionError("record_function entered with nothing recording")


def test_off_span_is_the_shared_null_context_and_keeps_nothing(monkeypatch):
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    assert span("front", device="cpu", rows=3) is span("serve.job") is profiling._NULL
    with span("train.step", step=1) as inner:
        assert inner is None
    sep = StreamingSeparator(_c1(), device="cpu")
    sep.separate_all(_waves(), max_batch=MAX_BATCH)
    got = spans()
    assert list(got) == [] and got.dropped == 0


@pytest.mark.parametrize("name", sorted(MODELS))
def test_serving_keeps_one_tree_per_job(name):
    make, layers = MODELS[name]
    sep = StreamingSeparator(make(), device="cpu")
    waves = _waves()
    sep.separate_all(waves, max_batch=MAX_BATCH)  # warms every shape, unrecorded
    assert list(spans()) == []
    with recording():
        sep.separate_all(waves, max_batch=MAX_BATCH)
    recs = list(spans())
    kids = _children(recs)
    (job,) = kids[None]
    assert job.name == "serve.job" and job.attrs == {"utterances": len(waves),
                                                     "audio_samples": sum(LENGTHS)}
    assert {r.root for r in recs} == {job.id}
    assert all(r.thread == job.thread and r.end_ns >= r.start_ns for r in recs)

    groups, bucket_of = [], sep.buckets.bucket_for
    for n in sorted(LENGTHS):
        if not groups or bucket_of(n) != bucket_of(groups[-1][-1]) or len(groups[-1]) >= MAX_BATCH:
            groups.append([])
        groups[-1].append(n)
    g = len(groups)
    top = [r.name for r in kids[job.id]]
    assert top == ["serve.pack"] + ["serve.batch"] * g + ["serve.copy_out"] * g + ["sync.end"]
    pack = kids[job.id][0]
    assert pack.id not in kids  # every shape was warm: no model call while packing
    batches = [r for r in kids[job.id] if r.name == "serve.batch"]
    for b in batches:
        assert [r.name for r in kids[b.id]] == layers
        assert all(r.id not in kids for r in kids[b.id])  # sync.lengths is the card's alone
        assert all(r.device_ms is None for r in kids[b.id])  # no timing events off the card
    rows = [b.attrs["rows"] for b in batches]
    assert rows == [len(x) for x in groups]
    assert sum(b.attrs["rows"] * b.attrs["samples"] for b in batches) == sum(
        len(x) * bucket_of(max(x)) for x in groups)
    assert sum(b.attrs["audio_samples"] for b in batches) == sum(LENGTHS)
    starts = [r.start_ns for r in recs]
    assert starts == sorted(starts) and recs[0] is job


def test_warm_up_runs_the_model_inside_serve_pack():
    sep = StreamingSeparator(_c1(), device="cpu")
    with recording():
        sep.separate_all(_waves()[:1], max_batch=MAX_BATCH)
    kids = _children(list(spans()))
    (job,) = kids[None]
    pack = kids[job.id][0]
    assert pack.name == "serve.pack"
    assert [r.name for r in kids[pack.id]] == MODELS["c1"][1]


def _tiny_recipe():
    r = recipes.c6_tasnet()
    model = dataclasses.replace(
        r.model, front=dataclasses.replace(r.model.front, n_filters=16, filter_len=16, stride=8),
        sep=dataclasses.replace(r.model.sep, hidden=8, blocks=2, repeats=1))
    train = dataclasses.replace(r.train, batch_size=2, chunk_samples=2048, steps=3,
                                valid_every=3, lr_schedule="const")
    return dataclasses.replace(r, model=model, train=train)


def _tiny_trainer(tmp_path):
    make_synthetic_corpus(str(tmp_path / "corpus"), n_speakers=6, seconds_per_speaker=1.0)
    tr = Trainer(_tiny_recipe(), SpeakerStore(str(tmp_path / "corpus")),
                 workdir=str(tmp_path / "runs"), device="cpu")
    tr.load_state(tr.init_state())
    return tr


def test_a_training_step_and_the_prefetch_thread(tmp_path):
    tr = _tiny_trainer(tmp_path)
    steps = 2
    with recording():
        batches = Prefetcher(make_batch=lambda s: tr._draw("train", s, 2),
                             put_batch=tr._device_batch, start_step=0, end_step=steps)
        try:
            for step, batch in batches:
                tr._train_step(batch)
                tr.step = step + 1
        finally:
            batches.close()
    recs = list(spans())
    kids = _children(recs)
    main = threading.get_ident()
    roots = kids[None]
    step_roots = [r for r in roots if r.name == "train.step"]
    assert [r.attrs for r in step_roots] == [{"step": 0}, {"step": 1}]
    for st in step_roots:
        assert st.thread == main and st.root == st.id
        assert [r.name for r in kids[st.id]] == ["train.gather", "train.forward",
                                                 "train.backward", "train.optimizer"]
        by = {r.name: r for r in kids[st.id]}
        assert "trunk" in [r.name for r in kids[by["train.forward"].id]]
        assert [r.name for r in kids[by["train.optimizer"].id]] == ["train.clip"]
        assert by["train.backward"].id not in kids
        tree = {st.id}
        for r in recs:  # in start order, so a parent is seen before its children
            if r.parent in tree:
                tree.add(r.id)
        assert {r.id for r in recs if r.root == st.id} == tree
        assert all(r.name not in ("train.draw", "train.put") for r in recs if r.id in tree)
    draws = [r for r in roots if r.name == "train.draw"]
    puts = [r for r in roots if r.name == "train.put"]
    assert len(draws) == len(puts) == steps
    for r in draws + puts:
        assert r.parent is None and r.root == r.id and r.thread != main and r.id not in kids


def test_stage_times_reads_the_layers_of_served_calls(monkeypatch):
    """``tools/stage_times.py`` reports the model's layer spans under
    ``serve.batch``, per call, the warm call (and its warm-up inside
    ``serve.pack``) left out; on the CPU no device time is read."""
    from amss_tpu_torch.tools import stage_times

    monkeypatch.setattr(stage_times, "BATCH", 2)
    monkeypatch.setattr(stage_times, "SECONDS", 1)
    out = stage_times.serving_spans(_c1(), calls=2)
    table = out["spans"]
    assert out["device"] == "cpu" and out["calls"] == 2 and out["call_wall_ms"] > 0
    batch = "serve.job > serve.batch"
    assert list(table) == ["serve.job", "serve.job > serve.pack", batch] + [
        f"{batch} > {layer}" for layer in MODELS["c1"][1]] + [
        "serve.job > serve.copy_out", "serve.job > sync.end"]
    for row in table.values():
        assert row["roots"] == 2 and row["host_ms"] > 0 and row["device_ms"] is None
    # the BLSTM's path on the CPU, and no launch of the card's recurrence
    assert list(out["blstm_paths"]) == ["loop"] and out["blstm_launches_per_root"] == 0


def test_stage_times_reads_train_steps(monkeypatch):
    """``stage_times --train``: ``train.step`` and its children per step, the
    prefetch thread's ``train.draw`` and ``train.put`` per draw."""
    from amss_tpu_torch.tools import stage_times

    monkeypatch.setattr(stage_times, "SPEAKERS", 6)
    monkeypatch.setattr(stage_times, "SPEAKER_SECONDS", 1.0)
    out = stage_times.training_spans(_tiny_recipe(), steps=2, device="cpu")
    table = out["spans"]
    assert out["device"] == "cpu" and out["steps"] == 2 and out["step_wall_ms"] > 0
    for child in ("", " > train.gather", " > train.forward", " > train.forward > trunk",
                  " > train.backward", " > train.optimizer", " > train.optimizer > train.clip"):
        assert table[f"train.step{child}"]["roots"] == 2, child
    assert table["train.draw"]["roots"] >= 2 and table["train.put"]["roots"] >= 2
    assert all(row["device_ms"] is None for row in table.values())


def test_spans_past_the_cap_are_counted_not_kept(monkeypatch):
    monkeypatch.setattr(profiling, "CAP", 3)
    with recording():
        with span("serve.job"):
            for _ in range(4):
                with span("serve.batch", rows=1):
                    pass
    got = spans()
    assert [r.name for r in got] == ["serve.job", "serve.batch", "serve.batch"]
    assert got.dropped == 2
    assert list(spans()) == [] and spans().dropped == 0


def test_threads_keep_their_own_trees_and_lose_no_count(monkeypatch):
    """Sixteen threads open nested spans at once, the interpreter switching
    between them every microsecond: each span is kept or counted, once, with
    its parent from its own thread."""
    monkeypatch.setattr(profiling, "CAP", 1000)
    n_threads, n_jobs = 16, 40
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with recording():
            def work():
                for _ in range(n_jobs):
                    with span("serve.job"):
                        with span("serve.batch"):
                            pass

            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    got = spans()
    assert len(got) + got.dropped == 2 * n_threads * n_jobs and len(got) >= 1000
    by_id = {r.id: r for r in got}
    assert len(by_id) == len(got)
    for r in got:
        if r.name == "serve.batch" and r.parent in by_id:
            parent = by_id[r.parent]
            assert parent.name == "serve.job" and parent.thread == r.thread
            assert r.root == parent.id
        if r.name == "serve.job":
            assert r.parent is None and r.root == r.id


def test_the_chrome_trace_holds_the_kept_spans(tmp_path):
    sep = StreamingSeparator(_c1(), device="cpu")
    waves = _waves()[:4]
    sep.separate_all(waves, max_batch=MAX_BATCH)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        sep.separate_all(waves, max_batch=MAX_BATCH)
    recs = list(spans())
    assert recs and recs[0].name == "serve.job"
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {r.name for r in recs}
    events = [e for e in json.load(open(path))["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and e.get("name") in names]
    events.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
    assert [e["name"] for e in events] == [r.name for r in recs]
    ev = {r.id: e for r, e in zip(recs, events)}
    for r in recs:
        if r.parent is not None:
            p, c = ev[r.parent], ev[r.id]
            assert float(p["ts"]) <= float(c["ts"])
            assert float(c["ts"]) + float(c["dur"]) <= float(p["ts"]) + float(p["dur"])
    # and the host intervals kept are those of the trace, on another clock
    for r in recs[1:]:
        lag_trace = float(ev[r.id]["ts"]) - float(events[0]["ts"])
        lag_kept = (r.start_ns - recs[0].start_ns) * 1e-3
        assert abs(lag_trace - lag_kept) < 2000.0
