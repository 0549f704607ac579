"""Faults planted in the port underneath the harness, to show that the
numbers compared catch them: each is a context manager that patches one
function or method of the port while it is open, given the configuration.
The tests plant them at tiny sizes on the CPU; ``calibrate.py --faults``
reads them on the card at a cell's size.

``applies(name, cfg, traffic)`` says which fit a cell: the clustering
faults fit a model whose module clusters (has ``kmeans``), ``half_batch``
traffic that batches.  ``READ_ONLY`` are read for the record, not held to fail.
"""

from __future__ import annotations

import contextlib
import sys
from unittest import mock

import torch


def model_class(cfg: dict):
    """The port's model class of a configuration, as the port's own
    ``make_model`` picks it."""
    from amss_tpu_torch.train.engine import make_model

    from bm.core import port_model_config

    return type(make_model(port_model_config(cfg)))


def _module(cfg: dict):
    return sys.modules[model_class(cfg).__module__]


@contextlib.contextmanager
def altered_answer(cfg: dict):
    """Every batch's first answer scaled by 0.9 where ``separate`` makes it."""
    cls = model_class(cfg)
    real = cls.separate

    def separate(self, mix, *a, **k):
        out = real(self, mix, *a, **k)
        out[0] = 0.9 * out[0]
        return out

    with mock.patch.object(cls, "separate", separate):
        yield


@contextlib.contextmanager
def half_batch(cfg: dict):
    """``separate`` runs the first half of each batch's rows; the rest come
    back silent."""
    cls = model_class(cfg)
    real = cls.separate

    def separate(self, mix, *a, **k):
        half = (mix.shape[0] + 1) // 2
        if k.get("frame_mask") is not None:
            k = dict(k, frame_mask=k["frame_mask"][:half])
        out = real(self, mix[:half], *a, **k)
        return torch.cat([out, torch.zeros_like(out[:1]).expand(mix.shape[0] - half, -1, -1)])

    with mock.patch.object(cls, "separate", separate):
        yield


@contextlib.contextmanager
def no_lloyd(cfg: dict):
    """k-means returns its seeds: no Lloyd iteration runs."""
    mod = _module(cfg)
    real = mod.kmeans

    def kmeans(x, k, iters=10, weights=None):
        return real(x, k, 0, weights)

    with mock.patch.object(mod, "kmeans", kmeans):
        yield


@contextlib.contextmanager
def tau_halved(cfg: dict):
    """The soft masks at half the configured tau."""
    mod = _module(cfg)
    real = mod.soft_assignments

    def soft_assignments(x, centroids, tau=0.25):
        return real(x, centroids, tau / 2)

    with mock.patch.object(mod, "soft_assignments", soft_assignments):
        yield


@contextlib.contextmanager
def vad_off(cfg: dict):
    """k-means weighs every bin alike: the voice-activity weights all 1."""
    mod = _module(cfg)

    with mock.patch.object(mod, "vad_weights", lambda codes, *a, **k: torch.ones_like(codes)):
        yield


@contextlib.contextmanager
def state_unchanged(cfg: dict):
    """The optimiser's step returns leaving every parameter as it was."""
    from amss_tpu_torch.train.optim import Adam

    with mock.patch.object(Adam, "step", lambda self, grads: None):
        yield


@contextlib.contextmanager
def half_the_rows(cfg: dict):
    """The training loss over the first half of the batch's rows, its mean
    taken over them alone."""
    cls = model_class(cfg)
    real = cls.loss_from_batch

    def loss_from_batch(self, batch, rng=None):
        half = batch["sources"].shape[0] // 2
        return real(self, {k: v[:half] for k, v in batch.items()}, rng)

    with mock.patch.object(cls, "loss_from_batch", loss_from_batch):
        yield


SERVING = {"altered_answer": altered_answer, "half_batch": half_batch, "no_lloyd": no_lloyd,
           "tau_halved": tau_halved}
TRAINING = {"state_unchanged": state_unchanged, "half_the_rows": half_the_rows}
READ_ONLY = {"vad_off": vad_off}
_CLUSTERING = {"no_lloyd", "tau_halved", "vad_off"}


def applies(name: str, cfg: dict, traffic: dict) -> bool:
    """Whether fault ``name`` fits a cell of configuration ``cfg`` and
    traffic mix ``traffic``."""
    training = traffic["kind"] == "train_steps"
    if name in TRAINING or training:
        return name in TRAINING and training
    if name in _CLUSTERING:
        return hasattr(_module(cfg), "kmeans")
    return name != "half_batch" or traffic.get("max_batch", 1) > 1
