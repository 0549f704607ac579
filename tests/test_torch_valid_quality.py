"""``train.valid_quality`` on the CPU: each validation logs ``valid/si_sdri``,
the serving path's PIT SI-SDR less the mixture's on one valid batch, with the
serving (EMA) weights.  The value is held within 1e-3 dB of the JAX package's
``Trainer._quality_summary`` on the same weights and batch (a tiny TasNet, so
no k-means and no seeding tie; float32 against jnp through the whole
separator).  A tiny c1 run that also drops sources writes the scalar too."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from amss_tpu.ckpt.checkpoint import restore_checkpoint as j_restore
from amss_tpu.configs import recipes as jrecipes
from amss_tpu.data.synthetic import make_synthetic_corpus as j_make_corpus
from amss_tpu.train.engine import Trainer as JTrainer
from amss_tpu_torch.configs import recipes
from amss_tpu_torch.data.store import SpeakerStore
from amss_tpu_torch.train.engine import Trainer

torch.set_num_threads(2)


def _metrics(run_dir: str, key: str) -> dict:
    out = {}
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if key in rec:
                out[rec["step"]] = rec[key]
    return out


def _tiny_c6(mod, **train):
    r = mod.c6_tasnet()
    return dataclasses.replace(
        r,
        train=dataclasses.replace(r.train, **{
            "batch_size": 2, "chunk_samples": 2048, "steps": 4, "valid_every": 2,
            "valid_steps": 1, "lr": 3e-3, "ema_decay": 0.9, "valid_quality": True, **train}),
        model=dataclasses.replace(r.model, sep=dataclasses.replace(
            r.model.sep, hidden=16, blocks=3, repeats=2)),
    )


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    j_make_corpus(str(root), n_speakers=10, seconds_per_speaker=2.0)
    return SpeakerStore(str(root))


def test_valid_si_sdri_is_the_jax_packages_quality_summary(store, tmp_path):
    tr = Trainer(_tiny_c6(recipes), store, workdir=str(tmp_path / "port"), device="cpu")
    final = tr.fit(log_every=1)
    got = _metrics(tr.dir, "valid/si_sdri")
    assert sorted(got) == [2, 4] and not tr._warned_quality
    assert all(np.isfinite(v) for v in got.values())
    # the JAX package's summary on the weights the port served at step 4
    jtr = JTrainer(_tiny_c6(jrecipes), store, run_dir=str(tmp_path / "jax"))
    state, manifest = j_restore(tr.dir, jtr.init_state())
    assert manifest["step"] == final["step"] == 4
    jtr._quality_summary(state["ema_params"], 3, "valid", 0)
    want = _metrics(jtr.dir, "valid/si_sdri")
    assert sorted(want) == [4]
    assert abs(got[4] - want[4]) <= 1e-3, (got[4], want[4])


def test_a_c1_run_that_drops_sources_logs_it(store, tmp_path):
    r = recipes.c1_stft_dpcl()
    recipe = dataclasses.replace(
        r,
        train=dataclasses.replace(r.train, batch_size=2, chunk_samples=2048, steps=2,
                                  valid_every=2, valid_steps=1, valid_quality=True),
        model=dataclasses.replace(r.model, train_min_speakers=1, sep=dataclasses.replace(
            r.model.sep, hidden=16, layers=1, embed_dim=4)))
    tr = Trainer(recipe, store, workdir=str(tmp_path), device="cpu")
    tr.fit(log_every=1)
    q = _metrics(tr.dir, "valid/si_sdri")
    assert sorted(q) == [2] and np.isfinite(q[2]) and not tr._warned_quality
    assert np.isfinite(_metrics(tr.dir, "train/dpcl_loss")[2])
