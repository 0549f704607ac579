"""The port's training engine on the CPU: it learns, resumes exactly, names and
writes its run dir as the JAX package does, and follows the JAX ``Trainer``'s
trajectory from the same init and batches.

Tolerances: the loss of the first step 1e-4 relative to the JAX package's
(the same function in float32, computed in another order); of the next steps
1e-3 relative, because a step moves every weight by about ±lr wherever
Adam's first steps divide a near-zero gradient by its own size, and float
rounding decides such signs.  Everything the port does twice on the CPU, or
writes and reads back, is held bit for bit."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from amss_tpu.ckpt.checkpoint import restore_checkpoint as j_restore
from amss_tpu.configs import recipes as jrecipes
from amss_tpu.data.synthetic import make_synthetic_corpus as j_make_corpus
from amss_tpu.train.engine import Trainer as JTrainer
from amss_tpu.train.engine import load_model_from_run as j_load_model_from_run
from amss_tpu.utils.config import run_id as j_run_id
from amss_tpu_torch.ckpt.checkpoint import msgpack_restore, restore_checkpoint
from amss_tpu_torch.configs import recipes
from amss_tpu_torch.data.mixer import Batch
from amss_tpu_torch.data.store import SpeakerStore
from amss_tpu_torch.parallel.mesh import run_ranks
from amss_tpu_torch.train.engine import Trainer
from amss_tpu_torch.utils.config import recipe_from_dict, run_id, run_id_from_stored

import torch_ranks  # noqa: E402

torch.set_num_threads(2)


def _tiny(mod, steps=3, **train):
    r = mod.c1_stft_dpcl()
    return dataclasses.replace(
        r,
        train=dataclasses.replace(r.train, **{
            "batch_size": 2, "chunk_samples": 2048, "steps": steps, "valid_every": steps,
            "valid_steps": 1, "lr": 3e-3, **train}),
        model=dataclasses.replace(
            r.model, sep=dataclasses.replace(r.model.sep, hidden=16, layers=1, embed_dim=4)),
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


def _layout(tree, path=""):
    """{path: (shape, dtype)} of a decoded checkpoint tree, or the type of a
    non-array leaf."""
    if isinstance(tree, dict):
        out = {path: "dict"} if not tree else {}
        for k, v in tree.items():
            out.update(_layout(v, f"{path}/{k}"))
        return out
    if isinstance(tree, np.ndarray):
        return {path: (tree.shape, tree.dtype.str)}
    return {path: type(tree).__name__}


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    j_make_corpus(str(root), n_speakers=10, seconds_per_speaker=2.0)
    return SpeakerStore(str(root))


@pytest.fixture(scope="module")
def twin_runs(store, tmp_path_factory):
    """The same recipe (EMA and the cosine schedule on, so the checkpoint holds
    every part) trained 3 steps by each package from the JAX init."""
    root = tmp_path_factory.mktemp("runs")
    over = dict(ema_decay=0.9, lr_schedule="cosine", warmup_steps=1)
    jtr = JTrainer(_tiny(jrecipes, **over), store, workdir=str(root / "jax"))
    init = jtr.init_state()
    jinit = _np(init["params"])
    jtr.fit(state=init, log_every=1)
    tr = Trainer(_tiny(recipes, **over), store, workdir=str(root / "port"), device="cpu")
    final = tr.fit(tr.state_from_tree({"params": jinit}), log_every=1)
    return jtr, tr, final


def test_run_id_is_the_jax_packages():
    for over in ({}, {"ema_decay": 0.99, "accum_steps": 2}, {"steps_per_call": 8},
                 {"lr_schedule": "cosine", "steps": 300}):
        assert run_id(recipes.c1_stft_dpcl(**over)) == j_run_id(jrecipes.c1_stft_dpcl(**over))
        assert run_id(recipes.c5_streaming(**over)) == j_run_id(jrecipes.c5_streaming(**over))
    assert run_id(recipes.c1_stft_dpcl(steps_per_call=8)) == run_id(recipes.c1_stft_dpcl())
    assert run_id(recipes.c1_stft_dpcl(seed=1)) != run_id(recipes.c1_stft_dpcl())


def test_losses_follow_the_jax_trainer(twin_runs):
    jtr, tr, _ = twin_runs
    assert os.path.basename(tr.dir) == os.path.basename(jtr.dir)
    ours, theirs = _metrics(tr.dir, "train/dpcl_loss"), _metrics(jtr.dir, "train/dpcl_loss")
    assert sorted(ours) == sorted(theirs) == [1, 2, 3]
    assert abs(ours[1] - theirs[1]) <= 1e-4 * abs(theirs[1])
    for s in (2, 3):
        assert abs(ours[s] - theirs[s]) <= 1e-3 * abs(theirs[s]), s
    v, jv = _metrics(tr.dir, "valid/loss")[3], _metrics(jtr.dir, "valid/loss")[3]
    assert abs(v - jv) <= 1e-3 * abs(jv)
    assert set(_metrics(tr.dir, "train/steps_per_sec")) == {1, 2, 3}


def test_run_dir_files_and_checkpoint_layout_are_the_jax_packages(twin_runs):
    jtr, tr, _ = twin_runs
    for name in ("config.json", "corpus.json", "metrics.jsonl", "ckpt_latest.msgpack",
                 "ckpt_best.msgpack", "ckpt_latest.msgpack.json", "ckpt_best.msgpack.json"):
        assert os.path.exists(os.path.join(tr.dir, name)), name
    with open(os.path.join(tr.dir, "config.json")) as f, \
            open(os.path.join(jtr.dir, "config.json")) as g:
        assert json.load(f) == json.load(g)
    for name in ("ckpt_latest.msgpack", "ckpt_best.msgpack"):
        with open(os.path.join(tr.dir, name), "rb") as f:
            ours = msgpack_restore(f.read())
        with open(os.path.join(jtr.dir, name), "rb") as f:
            theirs = msgpack_restore(f.read())
        assert list(ours) == list(theirs) == ["meta", "state"]
        assert ours["meta"]["step"] == theirs["meta"]["step"] == 3
        assert list(ours["meta"]) == list(theirs["meta"])
        assert _layout(ours["state"]) == _layout(theirs["state"])
        with open(os.path.join(tr.dir, name + ".json")) as f:
            assert json.load(f) == ours["meta"]


def test_the_jax_package_loads_and_resumes_a_port_run(twin_runs):
    jtr, tr, final = twin_runs
    _, served = j_load_model_from_run(tr.dir)  # EMA weights, as the port serves them
    want = tr.state_tree(final)
    for a, b in zip(jax.tree_util.tree_leaves(_np(served)),
                    jax.tree_util.tree_leaves(want["ema_params"])):
        np.testing.assert_array_equal(a, b)
    jback = JTrainer(jtr.recipe, tr.mixer.store, run_dir=tr.dir)
    state = jback.restore()
    assert int(state["step"]) == 3
    assert int(state["opt_state"][1][0].count) == int(state["opt_state"][1][1].count) == 3
    for a, b in zip(jax.tree_util.tree_leaves(_np(state["opt_state"][1][0].mu)),
                    jax.tree_util.tree_leaves(want["opt_state"]["1"]["0"]["mu"])):
        np.testing.assert_array_equal(a, b)


def test_the_port_restores_a_jax_run(twin_runs):
    jtr, tr, _ = twin_runs
    tree, manifest = restore_checkpoint(jtr.dir)
    jstate, jmanifest = j_restore(jtr.dir, jtr.init_state())
    assert manifest == jmanifest
    state = tr.state_from_tree(tree)
    assert state["step"] == 3 and state["opt_state"]["count"] == 3
    back = tr.state_tree(state)
    for part in ("params", "ema_params"):
        for a, b in zip(jax.tree_util.tree_leaves(back[part]),
                        jax.tree_util.tree_leaves(_np(jstate[part]))):
            np.testing.assert_array_equal(a, b)


def test_fit_lowers_the_loss_and_resumes_exactly(store, tmp_path):
    straight = Trainer(_tiny(recipes, steps=4, valid_every=2), store,
                       run_dir=str(tmp_path / "a"), device="cpu")
    straight.load_state(straight.init_state())
    v0 = straight.valid_loss()
    end = straight.fit(log_every=1)
    assert straight.valid_loss() < v0

    half = Trainer(_tiny(recipes, steps=2), store, run_dir=str(tmp_path / "b"), device="cpu")
    half.fit(log_every=1)
    resumed = Trainer(_tiny(recipes, steps=4, valid_every=2), store,
                      run_dir=str(tmp_path / "b"), device="cpu")
    state = resumed.restore()
    assert state["step"] == 2
    again = resumed.fit(state, log_every=1)
    assert again["step"] == end["step"] == 4
    a, b = _metrics(straight.dir, "train/dpcl_loss"), _metrics(resumed.dir, "train/dpcl_loss")
    assert [a[s] for s in (1, 2, 3, 4)] == [b[s] for s in (1, 2, 3, 4)]
    for part in ("params",):
        for n, t in end[part].items():
            assert torch.equal(t, again[part][n]), n
    for n, t in end["opt_state"]["nu"].items():
        assert torch.equal(t, again["opt_state"]["nu"][n]), n

    with open(os.path.join(straight.dir, "config.json")) as f:
        stored = json.load(f)
    assert run_id_from_stored(stored) == straight.rid
    assert recipe_from_dict(stored).train == straight.recipe.train


def test_trainer_raises_without_a_card_and_for_what_is_not_ported(store, tmp_path, monkeypatch):
    """The name is kept from when data-parallel training raised: it is
    ported (``tests/test_torch_ddp.py``), and two gloo CPU ranks train here
    and match one process fed their rows; what still raises is a run
    without a card when none is named."""
    dp = _tiny(recipes, data_axis=2, batch_size=4, steps=2, valid_every=2)
    run_ranks(torch_ranks.fit_rank, 2, "gloo", args=(dp, store.root, str(tmp_path / "dp")))
    ranks = [torch.load(tmp_path / "dp" / f"rank{r}.pt") for r in range(2)]
    assert ranks[0]["step"] == ranks[1]["step"] == 2
    for n, t in ranks[0]["params"].items():
        assert torch.equal(t, ranks[1]["params"][n]), n
    one = Trainer(_tiny(recipes, batch_size=4), store, run_dir=str(tmp_path / "one"),
                  device="cpu")
    seen = torch_ranks.capture_first_step(one)
    one.load_state(one.init_state())
    parts = [one.mixer.batch("train", 0, 2, host=r) for r in range(2)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks compute (tests/torch_ranks.py)
    try:
        one._train_step(one._device_batch(Batch(
            sources=np.concatenate([p.sources for p in parts]),
            speaker_ids=np.concatenate([p.speaker_ids for p in parts]),
            gains=np.concatenate([p.gains for p in parts]))))
    finally:
        torch.set_num_threads(threads)
    want = seen["metrics"]["dpcl_loss"]
    assert abs(ranks[0]["first"]["metrics"]["dpcl_loss"] - want) <= 1e-5 * abs(want)
    # the corpus resident on the card is ported (tests/test_torch_device_corpus.py)
    dd = Trainer(_tiny(recipes, device_data=True), store, workdir=str(tmp_path), device="cpu")
    assert dd.corpus is not None and dd.corpus.device.type == "cpu"
    # valid_quality is ported (tests/test_torch_valid_quality.py): it trains
    # and logs valid/si_sdri
    quality = Trainer(_tiny(recipes, steps=1, valid_every=1, valid_quality=True), store,
                      workdir=str(tmp_path), device="cpu")
    quality.fit(log_every=1)
    assert 1 in _metrics(quality.dir, "valid/si_sdri")
    r = _tiny(recipes)
    # the enhancer is ported (tests/test_torch_enhance.py); without a base run
    # it has nothing to refine
    other = dataclasses.replace(r, model=dataclasses.replace(r.model, kind="enhance"))
    with pytest.raises(ValueError, match="base_run"):
        Trainer(other, store, workdir=str(tmp_path), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(r, store, workdir=str(tmp_path))


def test_a_run_dir_keeps_its_corpus(store, tmp_path):
    tr = Trainer(_tiny(recipes, steps=1), store, run_dir=str(tmp_path / "r"), device="cpu")
    tr._write_config()
    other = SpeakerStore(store.root)
    other.root = str(tmp_path / "elsewhere")
    with pytest.raises(ValueError, match="trained on corpus"):
        Trainer(_tiny(recipes, steps=1), other, run_dir=str(tmp_path / "r"), device="cpu")


def test_early_stopping_and_best_effort_summaries(store, tmp_path, monkeypatch, caplog):
    tr = Trainer(_tiny(recipes, steps=8, valid_every=2, early_stop_patience=1), store,
                 run_dir=str(tmp_path / "r"), device="cpu")
    losses = iter([0.5, 0.7, 0.4, 0.3])  # the second validation is worse: stop there
    monkeypatch.setattr(tr, "valid_loss", lambda: next(losses))

    def broken(*a, **k):
        raise RuntimeError("no separate today")

    monkeypatch.setattr(tr.model, "separate", broken)
    with caplog.at_level("WARNING"):
        final = tr.fit(log_every=1)
    assert final["step"] == 4
    assert _metrics(tr.dir, "train/early_stopped") == {4: 1.0}
    assert _metrics(tr.dir, "valid/loss") == {2: 0.5, 4: 0.7}
    assert sum("image summaries failed" in r.getMessage() for r in caplog.records) == 1
    _, manifest = restore_checkpoint(tr.dir, best=True)
    assert manifest == {"step": 2, "metric": 0.5}
