"""The Chimera separator (``amss_tpu_torch/models/chimera.py``) and the
phase-sensitive targets (``models/front.py::psa_targets``) against the JAX
package on the CPU, on the same weights (the JAX init carried across) and
inputs drawn from numpy seeds; the JAX side takes its jnp path
(``AMSS_PALLAS=0``), as tests/test_goldens.py runs it.

Tolerances and why:
  * ``psa_targets``: 1e-6 absolute (three products and a clip);
  * ``msa_pit_loss`` at S = 3 (all six permutations): 1e-5 relative, and its
    gradients 1e-5 of their largest magnitude (float32 sums over the bins in
    another order);
  * golden "c4": 1e-4 relative, the golden test's own bound;
  * the loss (msa, psa, with the reconstruction term) from the same weights:
    1e-5 relative; every gradient 1e-4 of its tensor's largest JAX magnitude
    (float32 backward through the BLSTM in another order);
  * separation: 1e-4 of the output's largest magnitude (softmax masks, no
    clustering);
  * three steps of the c4 recipe against the JAX ``Trainer``: the bounds of
    tests/test_torch_train.py.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amss_tpu.configs import recipes as jrecipes
from amss_tpu.data.synthetic import make_synthetic_corpus as j_make_corpus
from amss_tpu.models import front as jfront
from amss_tpu.models.chimera import msa_pit_loss as j_msa_pit_loss
from amss_tpu.train.engine import Trainer as JTrainer
from amss_tpu.train.engine import make_model as j_make_model
from amss_tpu_torch.configs import recipes
from amss_tpu_torch.data.store import SpeakerStore
from amss_tpu_torch.models import front
from amss_tpu_torch.models.chimera import ChimeraModel, msa_pit_loss
from amss_tpu_torch.train.engine import Trainer, make_model
from amss_tpu_torch.utils.config import FrontConfig, ModelConfig, SeparatorConfig
from amss_tpu_torch.weights import named_from_jax, params_from_jax, params_to_jax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _jnp_path(monkeypatch):
    monkeypatch.setenv("AMSS_PALLAS", "0")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_cfg(jcfg) -> ModelConfig:
    d = dataclasses.asdict(jcfg)
    return ModelConfig(front=FrontConfig(**d.pop("front")), sep=SeparatorConfig(**d.pop("sep")),
                       **d)


def _small(**model):
    """c4 at the goldens' width: one BLSTM layer of 16, E = 4, S = 3."""
    r = jrecipes.c4_chimera_3mix()
    return dataclasses.replace(r.model, sep=dataclasses.replace(
        r.model.sep, hidden=16, layers=1, embed_dim=4), **model)


def test_the_recipe_is_the_jax_packages():
    assert dataclasses.asdict(recipes.c4_chimera_3mix()) == dataclasses.asdict(
        jrecipes.c4_chimera_3mix())
    assert isinstance(make_model(recipes.c4_chimera_3mix().model), ChimeraModel)


def test_psa_targets_match_jax():
    rng = np.random.default_rng(0)
    th_mix = rng.uniform(0, 2 * np.pi, (2, 10, 7)).astype(np.float32)
    th_src = rng.uniform(0, 2 * np.pi, (2, 3, 10, 7)).astype(np.float32)
    mix = np.abs(rng.standard_normal((2, 10, 7))).astype(np.float32)
    src = np.abs(rng.standard_normal((2, 3, 10, 7))).astype(np.float32) * 2
    args = (mix, {"cos": np.cos(th_mix), "sin": np.sin(th_mix)}, src,
            {"cos": np.cos(th_src), "sin": np.sin(th_src)})
    want = jfront.psa_targets(*jax.tree_util.tree_map(jnp.asarray, args))
    got = front.psa_targets(*jax.tree_util.tree_map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert float(got.min()) == 0.0 and bool((got <= torch.from_numpy(mix)[:, None]).all())


@pytest.mark.parametrize("s", [2, 3])
def test_msa_pit_loss_and_its_gradient_match_jax(s):
    rng = np.random.default_rng(s)
    logits = rng.standard_normal((2, 12, 9, s)).astype(np.float32)
    masks = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    mix = np.abs(rng.standard_normal((2, 12, 9))).astype(np.float32)
    src = np.abs(rng.standard_normal((2, s, 12, 9))).astype(np.float32)
    w = (rng.random((2, 12, 9)) > 0.3).astype(np.float32)
    jl, jg = jax.value_and_grad(j_msa_pit_loss)(jnp.asarray(masks), jnp.asarray(mix),
                                                 jnp.asarray(src), jnp.asarray(w))
    mt = torch.from_numpy(masks).requires_grad_(True)
    loss = msa_pit_loss(mt, torch.from_numpy(mix), torch.from_numpy(src), torch.from_numpy(w))
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    loss.backward()
    jg = np.asarray(jg)
    assert np.abs(mt.grad.numpy() - jg).max() <= 1e-5 * np.abs(jg).max()
    # the minimum is over every permutation: reordering the sources is free
    perm = torch.from_numpy(src[:, ::-1].copy())
    again = msa_pit_loss(torch.from_numpy(masks[..., ::-1].copy()), torch.from_numpy(mix), perm,
                         torch.from_numpy(w))
    assert abs(again.item() - loss.item()) <= 1e-6 * abs(loss.item())


def test_loss_reproduces_golden_c4():
    """tests/test_goldens.py's protocol: the JAX init from PRNGKey(7) carried
    across, and the draws of every recipe before c4 in the same order."""
    jcfg = _small()
    jp = _np(j_make_model(jcfg).init(jax.random.PRNGKey(7)))
    rng = np.random.default_rng(1234)
    for name, s in (("c1", 2), ("c2_pretrain", 2), ("c2", 2), ("c3", 2)):
        rng.standard_normal((2, s, 2048))
        if name == "c3":
            rng.integers(0, 6, (2, s))
    sources = (rng.standard_normal((2, 3, 2048)) * 0.1).astype(np.float32)
    model = params_from_jax(_port_cfg(jcfg), jp, device="cpu")
    with torch.no_grad():
        loss, metrics = model.loss_from_batch({"sources": torch.from_numpy(sources)})
    with open(os.path.join(REPO, "tests", "goldens.json")) as f:
        want = json.load(f)["c4"]
    assert set(metrics) == {"chimera_loss", "dc_loss", "mi_loss"}
    assert abs(float(loss) - want) <= 1e-4 * max(abs(want), 1.0), (float(loss), want)


@pytest.mark.parametrize("model_over", [{}, {"loss_variant": "psa"},
                                        {"recon_weight": 0.2, "chimera_alpha": 0.3}],
                         ids=["msa", "psa", "recon"])
def test_loss_and_gradients_match_jax_grad(model_over):
    jcfg = _small(**model_over)
    jm = j_make_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    src = (np.random.default_rng(2).standard_normal((2, 3, 2048)) * 0.1).astype(np.float32)
    (jl, jmet), jg = jax.value_and_grad(lambda p: jm.loss(p, jnp.asarray(src)), has_aux=True)(jp)
    model = params_from_jax(_port_cfg(jcfg), _np(jp), device="cpu").train()
    loss, metrics = model.loss(torch.from_numpy(src))
    assert set(metrics) == set(jmet)
    for k, v in jmet.items():
        assert abs(float(metrics[k].detach()) - float(v)) <= 1e-5 * abs(float(v)) + 1e-9, k
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    loss.backward()
    want = {n: v.numpy() for n, v in named_from_jax(_np(jg)).items()}
    for n, p in model.named_parameters():
        if not p.requires_grad:
            continue
        scale = float(np.abs(want[n]).max())
        assert np.abs(p.grad.numpy() - want[n]).max() <= 1e-4 * scale, n


def test_separation_and_the_weight_round_trip_match_jax():
    jcfg = _small()
    jm = j_make_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    model = params_from_jax(_port_cfg(jcfg), _np(jp), device="cpu")
    mix = (np.random.default_rng(3).standard_normal((2, 4096)) * 0.1).astype(np.float32)
    fmask = np.ones((2, jcfg.front.frames_for(4096)), np.float32)
    fmask[1, 40:] = 0.0
    for fm in (None, fmask):
        want = np.asarray(jm.separate(jp, jnp.asarray(mix),
                                      frame_mask=None if fm is None else jnp.asarray(fm)))
        got = model.separate(torch.from_numpy(mix),
                             frame_mask=None if fm is None else torch.from_numpy(fm)).numpy()
        assert got.shape == want.shape == (2, 3, 4096)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    tree = params_to_jax(model)
    assert sorted(tree["separator"]) == ["blstm", "proj_embed", "proj_mask"]
    for a, b in zip(jax.tree_util.tree_leaves(tree["separator"]["proj_mask"]),
                    jax.tree_util.tree_leaves(_np(jp["separator"]["proj_mask"]))):
        np.testing.assert_array_equal(a, b)


def _metrics(run_dir: str, key: str) -> dict:
    out = {}
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if key in rec:
                out[rec["step"]] = rec[key]
    return out


def _tiny(mod, steps=3):
    """c4 cut to one BLSTM layer of 16, E = 4, batch 2 of 2048 samples of
    three speakers, EMA on."""
    r = mod.c4_chimera_3mix()
    return dataclasses.replace(
        r,
        train=dataclasses.replace(r.train, batch_size=2, chunk_samples=2048, steps=steps,
                                  valid_every=steps, valid_steps=1, lr=3e-3, ema_decay=0.9),
        model=dataclasses.replace(r.model, sep=dataclasses.replace(
            r.model.sep, hidden=16, layers=1, embed_dim=4)),
    )


def test_three_c4_steps_follow_the_jax_trainer(tmp_path):
    root = tmp_path / "corpus"
    j_make_corpus(str(root), n_speakers=12, seconds_per_speaker=2.0)
    store = SpeakerStore(str(root))
    jtr = JTrainer(_tiny(jrecipes), store, workdir=str(tmp_path / "jax"))
    init = jtr.init_state()
    jinit = _np(init["params"])
    jtr.fit(state=init, log_every=1)
    tr = Trainer(_tiny(recipes), store, workdir=str(tmp_path / "port"), device="cpu")
    tr.fit(tr.state_from_tree({"params": jinit}), log_every=1)
    assert os.path.basename(tr.dir) == os.path.basename(jtr.dir)
    for key in ("train/chimera_loss", "train/dc_loss", "train/mi_loss"):
        ours, theirs = _metrics(tr.dir, key), _metrics(jtr.dir, key)
        assert sorted(ours) == sorted(theirs) == [1, 2, 3], key
        assert abs(ours[1] - theirs[1]) <= 1e-4 * abs(theirs[1]), key
        for s in (2, 3):
            assert abs(ours[s] - theirs[s]) <= 1e-3 * abs(theirs[s]), (key, s)
    v, jv = _metrics(tr.dir, "valid/loss")[3], _metrics(jtr.dir, "valid/loss")[3]
    assert abs(v - jv) <= 1e-3 * abs(jv)
