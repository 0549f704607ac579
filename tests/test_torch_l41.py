"""The L41 separator (``amss_tpu_torch/models/l41.py``) against the JAX package
(``amss_tpu/models/l41.py``) on the CPU, on the same weights (the JAX init
carried across) and inputs drawn from numpy seeds; the JAX side takes its
jnp path (``AMSS_PALLAS=0``), as tests/test_goldens.py runs it.

Tolerances and why:
  * the sigmoid cross-entropy: 1e-6 absolute (optax's formula, elementwise);
  * golden "c3": 1e-4 relative, the golden test's own bound;
  * the loss from the same weights: 1e-5 relative; every gradient 1e-4 of
    its tensor's largest JAX magnitude (float32 backward through the BLSTM
    in another order);
  * enrolled separation: 1e-4 of the output's largest magnitude (the same
    float32 functions; sigmoid masks have no ties);
  * blind separation: hard k-means masks flip only on a near-tie of two
    distances, so it is held as SI-SDR >= 40 dB per speaker.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from amss_tpu.configs import recipes as jrecipes
from amss_tpu.train.engine import make_model as j_make_model
from amss_tpu_torch.configs import recipes
from amss_tpu_torch.models.l41 import L41Model, sigmoid_binary_cross_entropy
from amss_tpu_torch.ops.metrics import si_sdr
from amss_tpu_torch.train.engine import make_model
from amss_tpu_torch.utils.config import FrontConfig, ModelConfig, SeparatorConfig
from amss_tpu_torch.weights import named_from_jax, params_from_jax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SPK = 6


@pytest.fixture(autouse=True)
def _jnp_path(monkeypatch):
    monkeypatch.setenv("AMSS_PALLAS", "0")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_cfg(jcfg) -> ModelConfig:
    d = dataclasses.asdict(jcfg)
    return ModelConfig(front=FrontConfig(**d.pop("front")), sep=SeparatorConfig(**d.pop("sep")),
                       **d)


def _small():
    """c3 at the goldens' width: one BLSTM layer of 16, E = 4, six speakers."""
    r = jrecipes.c3_l41(n_train_speakers=N_SPK)
    return dataclasses.replace(r.model, sep=dataclasses.replace(
        r.model.sep, hidden=16, layers=1, embed_dim=4))


def _pair(seed: int = 0):
    jcfg = _small()
    jm = j_make_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, params_from_jax(_port_cfg(jcfg), _np(jp), device="cpu")


def test_the_recipe_is_the_jax_packages():
    assert dataclasses.asdict(recipes.c3_l41(17)) == dataclasses.asdict(jrecipes.c3_l41(17))
    assert isinstance(make_model(recipes.c3_l41(5).model), L41Model)
    with pytest.raises(ValueError, match="n_train_speakers"):
        L41Model(recipes.c3_l41(0).model)


def test_sigmoid_cross_entropy_is_optaxs():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(1000) * 30).astype(np.float32)
    y = (rng.random(1000) > 0.5).astype(np.float32)
    got = sigmoid_binary_cross_entropy(torch.from_numpy(x), torch.from_numpy(y))
    want = optax.sigmoid_binary_cross_entropy(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_loss_reproduces_golden_c3():
    """tests/test_goldens.py's protocol: the JAX init from PRNGKey(7) carried
    across, and the draws of every recipe before c3 in the same order."""
    jcfg = _small()
    jp = _np(j_make_model(jcfg).init(jax.random.PRNGKey(7)))
    rng = np.random.default_rng(1234)
    for s in (2, 2, 2):  # c1, c2_pretrain, c2
        rng.standard_normal((2, s, 2048))
    sources = (rng.standard_normal((2, 2, 2048)) * 0.1).astype(np.float32)
    ids = rng.integers(0, 6, (2, 2)).astype(np.int32)
    model = params_from_jax(_port_cfg(jcfg), jp, device="cpu")
    with torch.no_grad():
        loss, metrics = model.loss_from_batch({"sources": torch.from_numpy(sources),
                                               "speaker_ids": torch.from_numpy(ids)})
    with open(os.path.join(REPO, "tests", "goldens.json")) as f:
        want = json.load(f)["c3"]
    assert set(metrics) == {"l41_loss"}
    assert abs(float(loss) - want) <= 1e-4 * max(abs(want), 1.0), (float(loss), want)


@pytest.mark.parametrize("ids", [[[0, 1], [2, 3]], [[5, 0], [4, 4]]])
def test_loss_and_gradients_match_jax_grad(ids):
    jm, jp, model = _pair(1)
    src = (np.random.default_rng(2).standard_normal((2, 2, 2048)) * 0.1).astype(np.float32)
    ids = np.asarray(ids, np.int32)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(src), jnp.asarray(ids)), has_aux=True)(jp)
    model.train()
    loss, _ = model.loss(torch.from_numpy(src), torch.from_numpy(ids))
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    loss.backward()
    want = {n: v.numpy() for n, v in named_from_jax(_np(jg)).items()}
    for n, p in model.named_parameters():
        if not p.requires_grad:
            continue
        scale = max(float(np.abs(want[n]).max()), 1e-30)
        assert np.abs(p.grad.numpy() - want[n]).max() <= 1e-4 * scale, n
    # only the centroids of the speakers present receive a gradient
    absent = sorted(set(range(N_SPK)) - set(ids.ravel().tolist()))
    assert not model.centroids.grad[absent].any()


def test_enrolled_and_blind_separation_match_jax():
    jm, jp, model = _pair(0)
    mix = (np.random.default_rng(3).standard_normal((2, 4096)) * 0.1).astype(np.float32)
    ids = np.asarray([[0, 1], [2, 3]], np.int32)
    want = np.asarray(jm.separate(jp, jnp.asarray(mix), speaker_ids=jnp.asarray(ids)))
    got = model.separate(torch.from_numpy(mix), speaker_ids=torch.from_numpy(ids)).numpy()
    assert got.shape == want.shape == (2, 2, 4096)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    want = np.array(jm.separate(jp, jnp.asarray(mix), kmeans_iters=3))
    got = model.separate(torch.from_numpy(mix), kmeans_iters=3)
    assert torch.isfinite(got).all()
    db = si_sdr(got.double(), torch.from_numpy(want).double())
    assert (db >= 40.0).all(), db


def test_padded_rows_enrolled_match_jax():
    jm, jp, model = _pair(0)
    mix = (np.random.default_rng(4).standard_normal((2, 4096)) * 0.1).astype(np.float32)
    mix[1, 3000:] = 0.0
    nf = jm.cfg.front.frames_for(4096)
    fmask = np.ones((2, nf), np.float32)
    fmask[1, jm.cfg.front.frames_for(3000):] = 0.0
    ids = np.asarray([[1, 2], [3, 0]], np.int32)
    want = np.asarray(jm.separate(jp, jnp.asarray(mix), speaker_ids=jnp.asarray(ids),
                                  frame_mask=jnp.asarray(fmask)))
    got = model.separate(torch.from_numpy(mix), speaker_ids=torch.from_numpy(ids),
                         frame_mask=torch.from_numpy(fmask)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
