"""The port's optimiser against optax, fed the same gradients: clip by the
global norm, Adam and both learning-rate schedules of the engine; and the
engine's accumulation and EMA.

Tolerances: schedules 1e-6 relative (float32 against float32); parameters and
moments after each Adam step within 1e-6 of the tensor's largest magnitude,
since both run the same float32 formulas and differ only in the order of the
norm's sum and the rounding of a pow and a sqrt (a moment entry where two
steps cancel keeps that absolute error, not its relative size); accumulated
against whole-batch gradients (as tests/test_train_e2e.py holds the JAX
package) metrics 1e-5 relative and gradients 2e-6 absolute."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from amss_tpu_torch.configs.recipes import c1_stft_dpcl
from amss_tpu_torch.data.synthetic import make_synthetic_corpus
from amss_tpu_torch.train.engine import Trainer
from amss_tpu_torch.train.optim import (
    Adam, clip_by_global_norm, global_norm, make_schedule, warmup_cosine_decay_schedule)
from amss_tpu_torch.utils.config import TrainConfig

torch.set_num_threads(2)

SHAPES = [(5, 3), (7,), (2, 2, 4)]


def _close(got: torch.Tensor, want, tol: float = 1e-6) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * float(np.abs(want).max()))


def _optax_schedule(t: TrainConfig):
    """The JAX engine's schedule (amss_tpu/train/engine.py:125-137)."""
    if t.lr_schedule == "cosine":
        warmup = min(t.warmup_steps, max(t.steps // 10, 1))
        return optax.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=t.lr, warmup_steps=warmup,
            decay_steps=max(t.steps, warmup + 1), end_value=t.lr / 20.0)
    return t.lr


@pytest.mark.parametrize("steps,warmup", [(40, 500), (40, 2), (1, 500), (7, 0)])
def test_cosine_schedule_matches_optax(steps, warmup):
    t = TrainConfig(lr=3e-3, lr_schedule="cosine", steps=steps, warmup_steps=warmup)
    ours, theirs = make_schedule(t), _optax_schedule(t)
    for count in range(steps + 5):
        np.testing.assert_allclose(float(ours(count)), float(theirs(count)), rtol=1e-6,
                                   atol=1e-12)


def test_schedule_needs_a_cosine_phase():
    with pytest.raises(ValueError):
        warmup_cosine_decay_schedule(0.0, 1e-3, 10, 10)


def test_clip_matches_optax_on_both_sides_of_the_threshold(rng):
    grads = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads)))
    tx = optax.clip_by_global_norm(norm * 1.5)
    for max_norm in (norm * 1.5, norm, norm / 3):  # keep, at the threshold, clip
        tx = optax.clip_by_global_norm(max_norm)
        want, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(None))
        got = clip_by_global_norm([torch.from_numpy(g) for g in grads], max_norm)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    assert abs(float(global_norm([torch.from_numpy(g) for g in grads])) - norm) <= 1e-5 * norm


@pytest.mark.parametrize("schedule", ["const", "cosine"])
def test_adam_matches_optax_fed_the_same_gradients(rng, schedule):
    t = TrainConfig(lr=1e-2, lr_schedule=schedule, steps=6, warmup_steps=2, grad_clip=5.0)
    init = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    tx = optax.chain(optax.clip_by_global_norm(t.grad_clip), optax.adam(_optax_schedule(t)))
    jparams = [jnp.asarray(p) for p in init]
    jstate = tx.init(jparams)
    params = [torch.from_numpy(p.copy()) for p in init]
    opt = Adam(params, make_schedule(t), t.grad_clip)
    clipped = 0
    for step in range(t.steps):
        scale = 4.0 if step % 2 else 0.3  # every other step clips (norm > 5)
        grads = [(rng.standard_normal(s) * scale).astype(np.float32) for s in SHAPES]
        clipped += float(global_norm([torch.from_numpy(g) for g in grads])) >= t.grad_clip
        updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step([torch.from_numpy(g) for g in grads])
        adam = jstate[1][0]
        assert opt.state.count == int(adam.count) == step + 1
        for ours, theirs in ((params, jparams), (opt.state.mu, adam.mu), (opt.state.nu, adam.nu)):
            for a, b in zip(ours, theirs):
                _close(a, b)
    assert clipped == t.steps // 2


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return make_synthetic_corpus(str(tmp_path_factory.mktemp("corpus")), n_speakers=10,
                                 seconds_per_speaker=2.0)


def _tiny(**train):
    r = c1_stft_dpcl()
    return dataclasses.replace(
        r,
        train=dataclasses.replace(r.train, batch_size=4, chunk_samples=2048, steps=2,
                                  valid_every=2, valid_steps=1, lr=3e-3, **train),
        model=dataclasses.replace(
            r.model, sep=dataclasses.replace(r.model.sep, hidden=24, layers=1, embed_dim=6)),
    )


def test_accum_steps_2_equals_1(store, tmp_path):
    """The mean of two half-batch gradients is the whole batch's (every loss
    is a per-utterance mean), read through plain SGD, as the JAX package's
    test reads it: one Adam step from init is about sign(g)."""
    out = {}
    for accum in (1, 2):
        tr = Trainer(_tiny(accum_steps=accum), store, workdir=str(tmp_path), device="cpu")
        tr.load_state(tr.init_state())
        before = [p.detach().clone() for p in tr.params]

        @torch.no_grad()
        def sgd(grads, params=tr.params):
            for p, g in zip(params, grads):
                p.sub_(0.1 * g)

        tr.opt.step = sgd
        batch = tr._device_batch(tr.mixer.batch("train", 0, 4))
        metrics = {k: float(v) for k, v in tr._train_step(batch).items()}
        out[accum] = ([(b - p.detach()) / 0.1 for b, p in zip(before, tr.params)], metrics)
    (g1, m1), (g2, m2) = out[1], out[2]
    for k in m1:
        np.testing.assert_allclose(m1[k], m2[k], rtol=1e-5)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-6)


def test_ema_follows_the_params(store, tmp_path):
    tr = Trainer(_tiny(ema_decay=0.9), store, workdir=str(tmp_path), device="cpu")
    tr.load_state(tr.init_state())
    want = [p.detach().clone() for p in tr.params]
    assert all(torch.equal(e, w) for e, w in zip(tr.ema, want))
    for step in range(3):
        tr._train_step(tr._device_batch(tr.mixer.batch("train", step, 4)))
        want = [0.9 * w + (1.0 - 0.9) * p.detach() for w, p in zip(want, tr.params)]
    for e, w, p in zip(tr.ema, want, tr.params):
        torch.testing.assert_close(e, w, rtol=0, atol=0)
    assert not torch.equal(tr.ema[0], tr.params[0])
