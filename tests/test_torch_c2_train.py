"""c2 training on the CPU: the filterbank autoencoder (c2_pretrain) and the
fine-tuning of c2 from a pretrained front, each against the JAX ``Trainer``
from the same init and batches, the front-freeze gate, ``restore_subtree``,
and each package fine-tuning from the other's pretraining run dir.

Tolerances, those of tests/test_torch_train.py: the loss of the first step
1e-4 relative to the JAX package's, of the next steps 1e-3 (Adam's first
steps move every weight by about ±lr, and float rounding decides signs of
near-zero gradients).  What the port restores or freezes is held bit for
bit."""

import dataclasses
import json
import logging
import os

import jax
import numpy as np
import pytest
import torch

from amss_tpu.ckpt.checkpoint import restore_subtree as j_restore_subtree
from amss_tpu.configs import recipes as jrecipes
from amss_tpu.data.synthetic import make_synthetic_corpus as j_make_corpus
from amss_tpu.train.engine import Trainer as JTrainer
from amss_tpu.utils.config import run_id as j_run_id
from amss_tpu_torch.ckpt.checkpoint import restore_subtree
from amss_tpu_torch.configs import recipes
from amss_tpu_torch.data.store import SpeakerStore
from amss_tpu_torch.models.adapt import AdaptAutoencoder
from amss_tpu_torch.train.engine import Trainer
from amss_tpu_torch.utils.config import run_id

torch.set_num_threads(2)

FRONT = ("front.enc", "front.dec", "front.smooth")


def _tiny(recipe, steps=3, freeze=None, **train):
    r = dataclasses.replace(
        recipe,
        train=dataclasses.replace(recipe.train, **{
            "batch_size": 2, "chunk_samples": 2048, "steps": steps, "valid_every": steps,
            "valid_steps": 1, "lr": 3e-3, **train}),
        model=dataclasses.replace(recipe.model, sep=dataclasses.replace(
            recipe.model.sep, hidden=16, layers=1, embed_dim=4)),
    )
    return r if freeze is None else dataclasses.replace(r, freeze_front_steps=freeze)


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


def _follows(ours: dict, theirs: dict) -> None:
    assert sorted(ours) == sorted(theirs) == [1, 2, 3]
    assert abs(ours[1] - theirs[1]) <= 1e-4 * abs(theirs[1])
    for s in (2, 3):
        assert abs(ours[s] - theirs[s]) <= 1e-3 * abs(theirs[s]), s


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    j_make_corpus(str(root), n_speakers=10, seconds_per_speaker=2.0)
    return SpeakerStore(str(root))


@pytest.fixture(scope="module")
def pretrained(store, tmp_path_factory):
    """c2_pretrain trained 3 steps by each package from the JAX init."""
    root = tmp_path_factory.mktemp("pre")
    jtr = JTrainer(_tiny(jrecipes.c2_pretrain_adapt()), store, workdir=str(root / "jax"))
    init = jtr.init_state()
    jinit = _np(init["params"])
    jtr.fit(state=init, log_every=1)
    tr = Trainer(_tiny(recipes.c2_pretrain_adapt()), store, workdir=str(root / "port"),
                 device="cpu")
    final = tr.fit(tr.state_from_tree({"params": jinit}), log_every=1)
    return jtr, tr, final


def test_recipes_and_run_ids_are_the_jax_packages():
    for port, jax_ in ((recipes.c2_pretrain_adapt, jrecipes.c2_pretrain_adapt),
                       (recipes.c2_adapt_dpcl, jrecipes.c2_adapt_dpcl)):
        assert run_id(port()) == j_run_id(jax_())
        assert dataclasses.asdict(port()) == dataclasses.asdict(jax_())
    a, b = recipes.c2_adapt_dpcl("runs/x"), jrecipes.c2_adapt_dpcl("runs/x")
    assert a.freeze_front_steps == b.freeze_front_steps == 200
    assert run_id(a) == j_run_id(b)


def test_pretraining_follows_the_jax_trainer(pretrained):
    jtr, tr, final = pretrained
    assert isinstance(tr.model, AdaptAutoencoder)
    assert os.path.basename(tr.dir) == os.path.basename(jtr.dir)
    _follows(_metrics(tr.dir, "train/ae_loss"), _metrics(jtr.dir, "train/ae_loss"))
    v, jv = _metrics(tr.dir, "valid/loss")[3], _metrics(jtr.dir, "valid/loss")[3]
    assert abs(v - jv) <= 1e-3 * abs(jv)
    assert sorted(final["params"]) == sorted(FRONT)
    # the checkpoint holds the front alone, as the JAX package's does
    tree = restore_subtree(tr.dir, {"front": {k: np.zeros(v.shape) for k, v in
                                              jtr.init_state()["params"]["front"].items()}},
                           keys=["front"])
    np.testing.assert_array_equal(tree["front"]["enc"], final["params"]["front.enc"].numpy())


def test_restore_subtree_matches_the_jax_packages(pretrained):
    jtr, tr, _ = pretrained
    jtarget = _np(jtr.init_state()["params"])
    zeros = jax.tree_util.tree_map(np.zeros_like, jtarget)
    for src in (jtr.dir, tr.dir):
        want = _np(j_restore_subtree(src, zeros, keys=["front"], best=True))
        got = restore_subtree(src, zeros, keys=["front"])
        for k in ("enc", "dec", "smooth"):
            np.testing.assert_array_equal(got["front"][k], want["front"][k])
    with pytest.raises(KeyError, match="no subtree 'separator'"):
        restore_subtree(tr.dir, zeros, keys=["separator"])
    wrong = {"front": {**zeros["front"], "enc": np.zeros((3, 3))}}
    with pytest.raises(ValueError, match="shape"):
        restore_subtree(tr.dir, wrong, keys=["front"])


def _finetune(mod, pre_dir, **kw):
    return _tiny(mod.c2_adapt_dpcl(pretrained_front=pre_dir), freeze=2, **kw)


def test_each_package_fine_tunes_from_the_others_pretraining(pretrained, store, tmp_path):
    jtr, tr, _ = pretrained
    port = Trainer(_finetune(recipes, jtr.dir), store, workdir=str(tmp_path / "p"), device="cpu")
    state = port.init_state()
    jbest = _np(j_restore_subtree(jtr.dir, _np(jtr.init_state()["params"]), ["front"], True))
    for n in FRONT:
        np.testing.assert_array_equal(state["params"][n].numpy(), jbest["front"][n[6:]])
    jax_side = JTrainer(_finetune(jrecipes, tr.dir), store, workdir=str(tmp_path / "j"))
    jstate = _np(jax_side.init_state()["params"])
    mine = restore_subtree(tr.dir, jstate, keys=["front"])
    for k in ("enc", "dec", "smooth"):
        np.testing.assert_array_equal(jstate["front"][k], mine["front"][k])


def test_fine_tuning_follows_the_jax_trainer_and_freezes_the_front(pretrained, store, tmp_path):
    jtr, _, _ = pretrained
    jft = JTrainer(_finetune(jrecipes, jtr.dir), store, workdir=str(tmp_path / "jax"))
    init = jft.init_state()
    jinit = _np(init["params"])
    jft.fit(state=init, log_every=1)

    tr = Trainer(_finetune(recipes, jtr.dir), store, workdir=str(tmp_path / "port"), device="cpu")
    assert os.path.basename(tr.dir) == os.path.basename(jft.dir)
    start = tr.state_from_tree({"params": jinit})
    restored = tr.init_state()
    for n in FRONT:  # the port's own restore gives the JAX package's init front
        assert torch.equal(restored["params"][n], start["params"][n]), n
    final = tr.fit(start, log_every=1)
    for key in ("train/dpcl_loss", "train/recon_l2"):
        _follows(_metrics(tr.dir, key), _metrics(jft.dir, key))

    # the freeze gate: through step 2 the front is bit for bit the restored
    # one and Adam's moments of it are 0; step 3 moves it
    frozen = Trainer(_finetune(recipes, jtr.dir, steps=2), store, run_dir=str(tmp_path / "f"),
                     device="cpu").fit(start, log_every=1)
    for n in FRONT:
        assert torch.equal(frozen["params"][n], start["params"][n]), n
        assert not frozen["opt_state"]["mu"][n].any() and not frozen["opt_state"]["nu"][n].any()
        assert not torch.equal(final["params"][n], start["params"][n]), n
    assert not torch.equal(frozen["params"]["proj.weight"], start["params"]["proj.weight"])


def test_image_summaries_work_for_both_c2_models(store, tmp_path, caplog):
    with caplog.at_level(logging.WARNING):
        for recipe in (recipes.c2_pretrain_adapt(), recipes.c2_adapt_dpcl()):
            tr = Trainer(_tiny(recipe, steps=1), store, workdir=str(tmp_path), device="cpu")
            tr.fit(log_every=1)
            assert _metrics(tr.dir, "valid/loss")
    assert not [r for r in caplog.records if "image summaries failed" in r.getMessage()]


def test_base_run_still_raises(store, tmp_path):
    """The name is kept from when ``base_run`` raised: it is ported for the
    enhancer (tests/test_torch_enhance.py), and a separator of another kind
    ignores it, as the JAX package's ``make_model`` does.  The corpus
    resident on the card, which raised here until it was ported, builds
    (``tests/test_torch_device_corpus.py``).  Data-parallel training, which
    raised here until it was ported (``tests/test_torch_ddp.py``), builds,
    and its ``fit`` raises outside a process group of ``data_axis`` ranks."""
    r = dataclasses.replace(_tiny(recipes.c2_adapt_dpcl()), base_run="runs/somewhere")
    tr = Trainer(r, store, workdir=str(tmp_path), device="cpu")
    assert tr.model.cfg.kind == "dpcl"
    dd = dataclasses.replace(r, train=dataclasses.replace(r.train, device_data=True))
    assert Trainer(dd, store, workdir=str(tmp_path), device="cpu").corpus is not None
    r = dataclasses.replace(r, train=dataclasses.replace(r.train, data_axis=2))
    dp = Trainer(r, store, workdir=str(tmp_path), device="cpu")
    assert dp.group is None
    with pytest.raises(ValueError, match="data_axis=2 needs a process group"):
        dp.fit()
