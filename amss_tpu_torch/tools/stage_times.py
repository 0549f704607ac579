"""Where served calls and train steps spend their time, read from the port's
own spans (``utils/profiling.py``).

    python3 -m amss_tpu_torch.tools.stage_times [--recipe c1]        # serving
    python3 -m amss_tpu_torch.tools.stage_times --recipe c6 --train  # training

Serving builds the recipe's model on its committed checkpoint where there is
one (``CHECKPOINTS``), else with weights drawn from seed 0, and serves
BATCH mixtures of SECONDS s through ``StreamingSeparator.separate_all``: one
warm call, then CALLS calls.  ``--train`` runs a ``Trainer`` of the recipe at
its own widths and batch on a synthetic corpus written from seed 0: one warm
step, then STEPS steps.  Both run under ``profiling.recording()`` and print
one JSON line: per span path (``serve.job > serve.batch > trunk``) the median
over the calls (or steps, draws, puts: each root span) of its host ms and,
for the layer spans on the card, its device ms, beside the median wall ms of
a call or a step, and, for a BLSTM trunk, the paths its ``trunk`` spans
record (``blstm_path``: how many of each) and the recurrence kernels'
launches a root (``ops/kernels/blstm.py::bilstm_layer``'s ``launches`` and
``rows_launches``).  The layers' own code opens the spans, so this reads
whatever a model does inside them.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import tempfile
import time
from collections import Counter

import numpy as np
import torch

from amss_tpu_torch.configs.recipes import (
    ALL_RECIPES,
    c6_dual_path,
    dprnn_tasnet,
    sepformer,
    tfgridnet,
)
from amss_tpu_torch.data.synthetic import make_synthetic_corpus
from amss_tpu_torch.infer.streaming import StreamingSeparator
from amss_tpu_torch.ops.kernels.blstm import bilstm_layer
from amss_tpu_torch.train.engine import Trainer, make_model
from amss_tpu_torch.utils import profiling
from amss_tpu_torch.weights import load_model_from_run

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BATCH, SECONDS, SAMPLE_RATE, CALLS, STEPS = 8, 8, 8000, 10, 10
SPEAKERS, SPEAKER_SECONDS = 24, 20.0  # the training corpus
CHECKPOINTS = {"c1": "c1_dpcl", "c2": "c2_adapt", "c3": "c3_l41", "c6": "c6_flagship",
               "c7": "c7_causal"}
RECIPES = {**ALL_RECIPES, "sepformer": sepformer, "dprnn_tasnet": dprnn_tasnet,
           "tfgridnet": tfgridnet,
           "c6_dprnn": lambda **over: c6_dual_path("dprnn", **over),
           "c6_dpt": lambda **over: c6_dual_path("dpt", **over)}


def recipe(name: str):
    """The recipe ``name``: c3 with the corpus's speakers, enh over c1_dpcl."""
    given = {"c3": {"n_train_speakers": SPEAKERS},
             "enh": {"base_run": os.path.join(REPO, "checkpoints", "c1_dpcl")}}
    return RECIPES[name](**given.get(name, {}))


def serving_model(name: str):
    """The recipe's model on the card: its checkpoint, else seed 0's weights."""
    if name in CHECKPOINTS:
        return load_model_from_run(os.path.join(REPO, "checkpoints", CHECKPOINTS[name]))
    r = recipe(name)
    model = make_model(r.model, r.base_run, "cuda")
    model.init_parameters(torch.Generator().manual_seed(0))
    return model.cuda()


def span_table(records) -> dict:
    """Per span path: the median, over the root spans of its root's name with
    the first of them left out as warm-up, of the path's host ms summed
    within a root, of its device ms where the card timed it (else None), and
    the count of roots that hold it."""
    path: dict = {}
    per_root: dict = {}
    roots: dict = {}
    for r in records:  # in start order: a parent comes before its children
        path[r.id] = r.name if r.parent is None else f"{path[r.parent]} > {r.name}"
        if r.parent is None:
            roots.setdefault(r.name, []).append(r.id)
        sums = per_root.setdefault(r.root, {}).setdefault(path[r.id], [0.0, None])
        sums[0] += (r.end_ns - r.start_ns) / 1e6
        if r.device_ms is not None:
            sums[1] = (sums[1] or 0.0) + r.device_ms
    table = {}
    for ids in roots.values():
        kept = [per_root[i] for i in ids[1:]]
        for p in dict.fromkeys(p for sums in kept for p in sums):
            host = [s[p][0] for s in kept if p in s]
            dev = [s[p][1] for s in kept if p in s and s[p][1] is not None]
            table[p] = {"host_ms": statistics.median(host),
                        "device_ms": statistics.median(dev) if dev else None,
                        "roots": len(host)}
    return table


def _blstm_launches() -> int:
    """Both recurrence kernels' launches so far."""
    return bilstm_layer.launches + bilstm_layer.rows_launches


def blstm_record(records, roots: int, launched: int) -> dict:
    """The ``trunk`` spans' ``blstm_path`` attributes (how many of each) and
    the recurrence kernels' launches over ``roots`` root spans."""
    paths = Counter(r.attrs["blstm_path"] for r in records
                    if r.name == profiling.TRUNK and "blstm_path" in r.attrs)
    return {"blstm_paths": dict(paths), "blstm_launches_per_root": launched / roots}


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def serving_spans(model, calls: int = CALLS) -> dict:
    """One warm call and ``calls`` calls of BATCH mixtures of SECONDS s
    through ``StreamingSeparator`` on the model's device, recorded."""
    device = next(model.parameters()).device
    sep = StreamingSeparator(model, sample_rate=SAMPLE_RATE, device=device)
    rng = np.random.default_rng(0)
    waves = list((rng.standard_normal((BATCH, SECONDS * SAMPLE_RATE)) * 0.3).astype(np.float32))
    wall = []
    launched = _blstm_launches()
    with profiling.recording():
        for _ in range(calls + 1):
            t0 = time.perf_counter()
            sep.separate_all(waves, max_batch=BATCH)
            wall.append((time.perf_counter() - t0) * 1e3)
    records = profiling.spans()
    return {"device": _device_name(device), "batch": BATCH, "samples": SECONDS * SAMPLE_RATE,
            "calls": calls, "call_wall_ms": statistics.median(wall[1:]),
            **blstm_record(records, calls + 1, _blstm_launches() - launched),
            "spans": span_table(records)}


def training_spans(r, steps: int = STEPS, device=None) -> dict:
    """One warm step and ``steps`` steps of ``Trainer.fit`` of the recipe
    ``r`` on SPEAKERS synthetic speakers, recorded; a step's wall ms is the
    interval between two steps' starts."""
    train = dataclasses.replace(r.train, steps=steps + 1, valid_every=steps + 1)
    r = dataclasses.replace(r, train=train)
    with tempfile.TemporaryDirectory(prefix="stage_times_") as tmp:
        store = make_synthetic_corpus(os.path.join(tmp, "corpus"), n_speakers=SPEAKERS,
                                      seconds_per_speaker=SPEAKER_SECONDS, seed=0)
        tr = Trainer(r, store, workdir=tmp, device=device)
        launched = _blstm_launches()
        with profiling.recording():
            tr.fit(log_every=steps + 1)
        records = profiling.spans()
        launched = _blstm_launches() - launched
    starts = [rec.start_ns for rec in records if rec.name == profiling.TRAIN_STEP]
    return {"device": _device_name(tr.device), "batch": train.batch_size,
            "samples": train.chunk_samples, "steps": steps,
            "step_wall_ms": float(np.median(np.diff(starts)[1:])) / 1e6,
            **blstm_record(records, steps + 1, launched), "spans": span_table(records)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--recipe", choices=sorted(RECIPES), default="c1")
    ap.add_argument("--train", action="store_true", help="train steps instead of served calls")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stage_times needs a CUDA device")
    out = (training_spans(recipe(args.recipe)) if args.train
           else serving_spans(serving_model(args.recipe)))
    print(json.dumps({"recipe": args.recipe, **out}))


if __name__ == "__main__":
    main()
