"""c6 (TasNet) training on the CPU: three steps of a small c6 against the JAX
``Trainer`` from the same init and batches, the recipe's cosine schedule, and
each package resuming the other's run dir.

Tolerances, those of tests/test_torch_train.py: the loss of the first step
1e-4 relative to the JAX package's, of the next steps 1e-3 (Adam's first
steps move every weight by about ±lr, and float rounding decides the signs
of near-zero gradients).  What a package writes and the other reads back is
held bit for bit."""

import dataclasses
import json
import logging
import os

import jax
import numpy as np
import optax
import pytest
import torch

from amss_tpu.ckpt.checkpoint import restore_checkpoint as j_restore
from amss_tpu.configs import recipes as jrecipes
from amss_tpu.data.synthetic import make_synthetic_corpus as j_make_corpus
from amss_tpu.train.engine import Trainer as JTrainer
from amss_tpu.train.engine import load_model_from_run as j_load_model_from_run
from amss_tpu.utils.config import run_id as j_run_id
from amss_tpu_torch.ckpt.checkpoint import restore_checkpoint
from amss_tpu_torch.configs import recipes
from amss_tpu_torch.data.store import SpeakerStore
from amss_tpu_torch.models.tasnet import TasNetModel
from amss_tpu_torch.train.engine import Trainer
from amss_tpu_torch.train.optim import make_schedule
from amss_tpu_torch.utils.config import run_id

torch.set_num_threads(2)

LOSS = "train/neg_pit_si_sdr"


def _tiny(mod, steps=3, **train):
    """c6 cut to a TCN of 2 x 3 blocks of bottleneck 16, batch 2 of 2048
    samples, EMA on, the cosine schedule with one warm-up step."""
    r = mod.c6_tasnet()
    return dataclasses.replace(
        r,
        train=dataclasses.replace(r.train, **{
            "batch_size": 2, "chunk_samples": 2048, "steps": steps, "valid_every": steps,
            "valid_steps": 1, "lr": 3e-3, "ema_decay": 0.9, **train}),
        model=dataclasses.replace(r.model, sep=dataclasses.replace(
            r.model.sep, hidden=16, blocks=3, repeats=2)),
    )


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _metrics(run_dir: str, key: str) -> dict:
    out = {}
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if key in rec:
                out[rec["step"]] = rec[key]
    return out


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    j_make_corpus(str(root), n_speakers=10, seconds_per_speaker=2.0)
    return SpeakerStore(str(root))


@pytest.fixture(scope="module")
def twin_runs(store, tmp_path_factory):
    """The small c6 trained 3 steps by each package from the JAX init."""
    root = tmp_path_factory.mktemp("runs")
    jtr = JTrainer(_tiny(jrecipes), store, workdir=str(root / "jax"))
    init = jtr.init_state()
    jinit = _np(init["params"])
    jtr.fit(state=init, log_every=1)
    tr = Trainer(_tiny(recipes), store, workdir=str(root / "port"), device="cpu")
    final = tr.fit(tr.state_from_tree({"params": jinit}), log_every=1)
    return jtr, tr, final


def test_three_steps_follow_the_jax_trainer(twin_runs):
    jtr, tr, _ = twin_runs
    assert isinstance(tr.model, TasNetModel)
    assert os.path.basename(tr.dir) == os.path.basename(jtr.dir)
    assert run_id(_tiny(recipes)) == j_run_id(_tiny(jrecipes))
    ours, theirs = _metrics(tr.dir, LOSS), _metrics(jtr.dir, LOSS)
    assert sorted(ours) == sorted(theirs) == [1, 2, 3]
    assert abs(ours[1] - theirs[1]) <= 1e-4 * abs(theirs[1])
    for s in (2, 3):
        assert abs(ours[s] - theirs[s]) <= 1e-3 * abs(theirs[s]), s
    assert ours[3] < ours[1]  # the loss falls once the warm-up step is past
    v, jv = _metrics(tr.dir, "valid/loss")[3], _metrics(jtr.dir, "valid/loss")[3]
    assert abs(v - jv) <= 1e-3 * abs(jv)


@pytest.mark.parametrize("steps", [3, 1000, 96000])
def test_the_cosine_schedule_is_optaxs(steps):
    t = dataclasses.replace(recipes.c6_tasnet().train, steps=steps)
    assert t.lr_schedule == "cosine"
    warmup = min(t.warmup_steps, max(t.steps // 10, 1))
    theirs = optax.warmup_cosine_decay_schedule(0.0, t.lr, warmup, max(t.steps, warmup + 1),
                                                t.lr / 20.0)
    ours = make_schedule(t)
    for count in sorted({0, 1, warmup - 1, warmup, warmup + 1, steps // 2, steps - 1, steps,
                         steps + 7}):
        np.testing.assert_allclose(float(ours(count)), float(theirs(count)), rtol=1e-6,
                                   atol=1e-12)


def test_the_jax_package_loads_and_resumes_a_port_run(twin_runs):
    jtr, tr, final = twin_runs
    _, served = j_load_model_from_run(tr.dir)  # EMA weights, as the port serves them
    want = tr.state_tree(final)
    for a, b in zip(jax.tree_util.tree_leaves(_np(served)),
                    jax.tree_util.tree_leaves(want["ema_params"])):
        np.testing.assert_array_equal(a, b)
    state = JTrainer(jtr.recipe, tr.mixer.store, run_dir=tr.dir).restore()
    assert int(state["step"]) == 3
    for a, b in zip(jax.tree_util.tree_leaves(_np(state["params"])),
                    jax.tree_util.tree_leaves(want["params"])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree_util.tree_leaves(_np(state["opt_state"][1][0].nu)),
                    jax.tree_util.tree_leaves(want["opt_state"]["1"]["0"]["nu"])):
        np.testing.assert_array_equal(a, b)


def test_the_port_resumes_a_jax_run(twin_runs, store, tmp_path):
    jtr, tr, _ = twin_runs
    tree, manifest = restore_checkpoint(jtr.dir)
    jstate, jmanifest = j_restore(jtr.dir, jtr.init_state())
    assert manifest == jmanifest
    port = Trainer(_tiny(recipes, steps=4), store, run_dir=str(tmp_path / "r"), device="cpu")
    state = port.state_from_tree(tree)
    assert state["step"] == 3 and state["opt_state"]["count"] == 3
    back = port.state_tree(state)
    for part in ("params", "ema_params"):
        for a, b in zip(jax.tree_util.tree_leaves(back[part]),
                        jax.tree_util.tree_leaves(_np(jstate[part]))):
            np.testing.assert_array_equal(a, b)
    final = port.fit(state, log_every=1)
    assert final["step"] == 4 and sorted(_metrics(port.dir, LOSS)) == [4]


def test_image_summaries_work_for_tasnet(store, tmp_path, caplog):
    with caplog.at_level(logging.WARNING):
        tr = Trainer(_tiny(recipes, steps=1), store, workdir=str(tmp_path), device="cpu")
        tr.fit(log_every=1)
    assert _metrics(tr.dir, "valid/loss")
    assert not [r for r in caplog.records if "image summaries failed" in r.getMessage()]
