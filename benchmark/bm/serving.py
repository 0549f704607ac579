"""What the serving kinds share: the port's model from a configuration with
the seed's weights behind its ``StreamingSeparator``, the counting wrapper
at the model boundary, the bank of speakers, and the judging of a sample of
answers against the reference of the configuration's ``family``
(``reference/<family>.py``: ``judge`` and ``separate``), after the program
is freed.  The judge is told the padded lengths that the counting wrapper
saw the program's calls run at, a shape of what it did."""

from __future__ import annotations

import gc

import numpy as np
import torch

from bm import gen
from bm.core import Cell, family, limits, note, port_model_config, set_precision
from bm.weights import load_into, make_weights


class CountingModel:
    """The model as the serving layer sees it, counting what reaches
    ``separate``: each call's batch shape ``(rows, samples)``.  Everything
    else is the model's own."""

    def __init__(self, model):
        self.model = model
        self.calls: list[tuple[int, int]] = []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def to(self, *args, **kwargs):
        self.model = self.model.to(*args, **kwargs)
        return self

    def eval(self):
        self.model.eval()
        return self

    def separate(self, mix, *args, **kwargs):
        self.calls.append((int(mix.shape[0]), int(mix.shape[-1])))
        return self.model.separate(mix, *args, **kwargs)


def port_model(cfg: dict, seed: int, device):
    """(the port's model of the configuration on ``device`` with the seed's
    weights, the weights)."""
    from amss_tpu_torch.train.engine import make_model

    model = make_model(port_model_config(cfg)).to(device)
    shapes = {n: tuple(t.shape) for n, t in model.named_parameters()}
    weights = make_weights(shapes, cfg["init"], seed, device)
    load_into(model, weights)
    return model.eval(), weights


def setup(cell: Cell) -> dict:
    """The state a serving kind starts from: the separator over the counted
    model (``sep``, ``counted``), the seed's ``weights``, the speaker
    ``bank`` and an empty map of answers (``outs``)."""
    from amss_tpu_torch.infer.streaming import StreamingSeparator

    cfg = cell.config
    set_precision(cfg)
    model, weights = port_model(cfg, cell.seed, cell.device)
    counted = CountingModel(model)
    sep = StreamingSeparator(counted, sample_rate=cfg["sample_rate"], device=cell.device,
                             separate_kwargs=dict(cfg["separate"]))
    note(cell, "model and weights")
    b = cell.traffic["bank"]
    bank = gen.speakers(cell.seed, b["speakers"], b["seconds"], cell.device).cpu().numpy()
    note(cell, "speaker bank")
    return {"sep": sep, "counted": counted, "weights": weights, "bank": bank, "outs": {}}


def sample(seed: int, n_done: int, lengths: list[int], k: int) -> list[int]:
    """``k`` indices among the first ``n_done`` answers, drawn from the seed,
    with the longest among them always in."""
    rng = gen.rng_for(seed, 50)
    longest = int(np.argmax(lengths[:n_done]))
    rest = [i for i in rng.permutation(n_done).tolist() if i != longest]
    return [longest] + rest[:k - 1]


def _free(state: dict, device) -> tuple[dict, list[int]]:
    """(the weights, the padded lengths the program's calls ran at), the
    rest of the state freed."""
    weights, padded = state["weights"], sorted({t for _, t in state["counted"].calls})
    state.clear()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return weights, padded


def _worst(cell: Cell, weights: dict, mixes: list[np.ndarray], outs: list,
           padded: list[int]) -> dict:
    """Each number of the family's ``judge`` at its largest over the answers
    ``outs[i]`` ``[S, T]`` of ``mixes[i]``, which the program ran padded to
    one of ``padded`` (samples); a number that is not finite stands."""
    fn = family(cell.config).judge
    worst: dict = {}
    for mix, est in zip(mixes, outs):
        m = torch.as_tensor(mix, device=cell.device)
        e = torch.as_tensor(np.asarray(est), device=cell.device)
        for name, value in fn(m, e, weights, cell.config, padded).items():
            if not np.isfinite(value) or not np.isfinite(worst.get(name, 0.0)):
                worst[name] = float("inf")
            else:
                worst[name] = max(worst.get(name, 0.0), value)
    return worst


def judge(cell: Cell, state: dict, answers: list[tuple[np.ndarray, np.ndarray]]) -> dict:
    """The numbers compared, over a sample of ``answers`` (mixture, the
    program's answer) drawn from the seed, the longest mixture in it; run
    after the program is freed.  No answer misses every limit."""
    weights, padded = _free(state, cell.device)
    if not answers:
        return {name: float("inf") for name in limits(cell)}
    idx = sample(cell.seed, len(answers), [len(m) for m, _ in answers],
                 cell.traffic["check_sample"])
    return _worst(cell, weights, [answers[i][0] for i in idx], [answers[i][1] for i in idx],
                  padded)


def control(cell: Cell, state: dict, pool: list[np.ndarray]) -> dict:
    """The reference with its products in TF32 (the control) in the
    program's place, on a sample of ``pool`` drawn as ``judge`` draws,
    judged as the program's answers are."""
    from reference.dsp import Products

    weights, _ = _free(state, cell.device)
    idx = sample(cell.seed, len(pool), [len(m) for m in pool], cell.traffic["check_sample"])
    mixes = [pool[i] for i in idx]
    sep = family(cell.config).separate
    with torch.no_grad():
        outs = [sep(torch.as_tensor(m, device=cell.device), weights, cell.config,
                    Products(control=True)).cpu().numpy() for m in mixes]
    return _worst(cell, weights, mixes, outs, [])
