"""Training steps, as ``Trainer.fit`` drives them: the host draws a batch
(a plan over the corpus on the card), the prefetcher puts it on the device,
and ``Trainer._train_step`` gathers it, runs the loss, the backward, the
clip and Adam.  Reports ``train_step_ms``, the window's seconds over the
steps completed in it.

Set-up builds one ``Trainer`` over a synthetic corpus made from the seed,
writes the seed's weights into it, and drives its first ``warm_steps`` steps
through the same feed as the window; the numbers compared come from the
first ``check_steps`` of them.
"""

from __future__ import annotations

import gc
import tempfile
import time

import numpy as np
import torch

from bm import gen
from bm.core import Cell, note, port_model_config, set_precision, span
from bm.weights import load_into, make_weights


class Corpus:
    """The seed's speakers as the port's trainer reads a corpus: names,
    lengths and float32 waveforms."""

    def __init__(self, waves: np.ndarray):
        self.waves = waves
        self.speakers = [f"spk{i:03d}" for i in range(len(waves))]
        self.sample_rate = gen.SAMPLE_RATE

    def waveform(self, speaker: str) -> np.ndarray:
        return self.waves[self.speakers.index(speaker)]

    def n_samples(self, speaker: str) -> int:
        return self.waves.shape[1]


def recipe(cell: Cell):
    from amss_tpu_torch.utils.config import RecipeConfig, TrainConfig

    tr = cell.traffic
    train = TrainConfig(batch_size=tr["batch_size"], chunk_samples=tr["chunk_samples"],
                        lr=tr["lr"], lr_schedule=tr["lr_schedule"], grad_clip=tr["grad_clip"],
                        steps=2**31 - 1, valid_every=2**31 - 1, seed=cell.seed,
                        device_data=tr["device_data"], ema_decay=0.0)
    return RecipeConfig(name=cell.config["name"], model=port_model_config(cell.config),
                        train=train, sample_rate=cell.config["sample_rate"])


def run_steps(trainer, start: int, count: int, keep=None, stop=None) -> int:
    """Steps from ``start`` through the trainer's own feed (the host's draw,
    the prefetcher's copy to the device, the step), as ``Trainer.fit`` runs
    them: ``count`` of them, or fewer where ``stop()`` turns true after a
    step.  ``keep(i, metrics)`` sees each step's metrics.  Returns the steps
    run."""
    from amss_tpu_torch.data.prefetch import Prefetcher

    bs = trainer.recipe.train.batch_size

    def draw(s):
        with span("draw"):
            return trainer._draw("train", s, bs)

    batches = Prefetcher(make_batch=draw, put_batch=trainer._device_batch,
                         start_step=start, end_step=start + count)
    done = 0
    try:
        for step, batch in batches:
            with span("step"):
                metrics = trainer._train_step(batch)
            trainer.step = step + 1
            if keep is not None:
                keep(step - start, metrics)
            done += 1
            if stop is not None and stop():
                break
    finally:
        batches.close()
    return done


def setup(cell: Cell) -> dict:
    from amss_tpu_torch.train.engine import Trainer

    tr = cell.traffic
    set_precision(cell.config)
    waves = gen.speakers(cell.seed, tr["corpus"]["speakers"], tr["corpus"]["seconds"],
                         cell.device).cpu().numpy()
    note(cell, "corpus")
    trainer = Trainer(recipe(cell), Corpus(waves), workdir=tempfile.gettempdir(),
                      device=cell.device)
    note(cell, "trainer and corpus on the card")
    shapes = {n: tuple(p.shape) for n, p in trainer.model.named_parameters()}
    weights = make_weights(shapes, cell.config["init"], cell.seed, cell.device)
    load_into(trainer.model, weights)
    note(cell, "weights")
    snap = {"losses": [], "mu": None, "params": None}
    n_check = tr["check_steps"]

    def keep(i, metrics):
        if i < n_check:
            snap["losses"].append(float(next(iter(metrics.values()))))
        if i == 0:  # Adam's first moment after one step is (1 - b1) times the clipped gradient
            snap["mu"] = {n: (m / 0.1).cpu() for n, m in zip(trainer.names, trainer.opt.state.mu)}
        if i == n_check - 1:
            snap["params"] = {n: p.detach().cpu().clone()
                              for n, p in trainer.model.named_parameters()}

    with span("warmup"):
        run_steps(trainer, 0, tr["warm_steps"], keep)
    note(cell, "first steps")
    if torch.device(cell.device).type == "cuda":
        torch.cuda.synchronize()
    return {"trainer": trainer, "weights": weights, "waves": waves, "snap": snap}


def window(cell: Cell, state: dict, clock) -> dict:
    trainer = state["trainer"]
    traced = {"steps": 0}

    def keep(i, metrics):
        traced["steps"] += clock.tracing

    done = run_steps(trainer, trainer.step, 2**31 - 1 - trainer.step, keep, stop=clock.done)
    if torch.device(cell.device).type == "cuda":
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - clock.t0
    traced.update(rows=traced["steps"] * cell.traffic["batch_size"],
                  chunk_samples=cell.traffic["chunk_samples"])
    return {"e2e": {"train_step_ms": 1e3 * elapsed / done}, "attempted": done, "failed": 0,
            "counters": traced}


def _batches(cell: Cell, waves: np.ndarray) -> list[torch.Tensor]:
    from reference import train as ref

    tr = cell.traffic
    corpus = torch.as_tensor(waves, device=cell.device)
    out = []
    for step in range(tr["check_steps"]):
        ids, starts, gains = ref.plan(cell.seed, waves.shape[0], waves.shape[1], step,
                                      tr["batch_size"], cell.config["speakers"],
                                      tr["chunk_samples"])
        out.append(ref.sources(corpus, ids, starts, gains, tr["chunk_samples"]))
    return out


def _free(state: dict, device) -> tuple:
    weights, waves, snap = state["weights"], state["waves"], state["snap"]
    state.clear()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return weights, waves, snap


def judge(cell: Cell, state: dict) -> dict:
    """The first steps' losses, first clipped gradient and change of the
    parameters, against the reference's on the same batches."""
    from reference import train as ref

    weights, waves, snap = _free(state, cell.device)
    tr = cell.traffic
    reference = ref.steps(weights, _batches(cell, waves), cell.config, tr["lr"], tr["grad_clip"])
    dev = cell.device
    prog = {"losses": snap["losses"], "grads": {n: g.to(dev) for n, g in snap["mu"].items()},
            "params": {n: p.to(dev) for n, p in snap["params"].items()}}
    numbers, state["diagnostics"] = ref.gaps(prog, reference, weights)
    return numbers


def control(cell: Cell, state: dict) -> dict:
    """The reference in TF32 in the program's place, against the reference."""
    from reference import train as ref

    weights, waves, _ = _free(state, cell.device)
    tr = cell.traffic
    batches = _batches(cell, waves)
    reference = ref.steps(weights, batches, cell.config, tr["lr"], tr["grad_clip"])
    ctrl = ref.steps(weights, batches, cell.config, tr["lr"], tr["grad_clip"], control=True)
    numbers, state["diagnostics"] = ref.gaps(ctrl, reference, weights)
    return numbers
