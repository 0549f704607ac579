"""The training objective of c1: targets, bin weights, the gram-form DPCL loss
and ``DPCLModel.loss`` with its gradients, the port against the JAX package on
the CPU (its jnp path, ``AMSS_PALLAS=0``, as tests/test_goldens.py runs it).

Tolerances:
  * targets and weights: equal (argmax, comparisons) or 1e-6 relative;
  * ``dpcl_loss`` on the same inputs: 1e-5 relative (float32 grams of a few
    thousand terms in another order);
  * golden "c1": 1e-4 relative, the golden test's own bound;
  * gradients: each parameter's within 1e-4 of its largest JAX magnitude
    (float32 backward through the BLSTM in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amss_tpu.configs.recipes import c1_stft_dpcl as j_c1
from amss_tpu.models import front as jfront
from amss_tpu.models.dpcl import dpcl_loss as j_dpcl_loss
from amss_tpu.train.engine import make_model as j_make_model
from amss_tpu_torch.models.dpcl import DPCLModel, dpcl_loss
from amss_tpu_torch.models.dprnn import DropoutKey
from amss_tpu_torch.models.front import (
    bin_weights, ideal_binary_mask, magnitude_weights, vad_weights)
from amss_tpu_torch.utils.config import FrontConfig, ModelConfig, SeparatorConfig
from amss_tpu_torch.weights import jax_tree, params_from_jax, params_to_jax

torch.set_num_threads(2)

GOLDEN_C1 = 0.749794065952301  # tests/goldens.json "c1"


@pytest.fixture(autouse=True)
def _jnp_path(monkeypatch):
    monkeypatch.setenv("AMSS_PALLAS", "0")


def _port_cfg(jcfg) -> ModelConfig:
    d = dataclasses.asdict(jcfg)
    return ModelConfig(front=FrontConfig(**d.pop("front")), sep=SeparatorConfig(**d.pop("sep")),
                       **d)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


def _golden_setup(**model_over):
    """tests/test_goldens.py's c1 case: hidden 16, one layer, E = 4, params
    from PRNGKey(7), sources the first draw of default_rng(1234)."""
    r = j_c1()
    sep = dataclasses.replace(r.model.sep, hidden=16, layers=1, embed_dim=4)
    jcfg = dataclasses.replace(r.model, sep=sep, **model_over)
    jmodel = j_make_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(7))
    rng = np.random.default_rng(1234)
    sources = (rng.standard_normal((2, 2, 2048)) * 0.1).astype(np.float32)
    model = params_from_jax(_port_cfg(jcfg), _np_tree(params), device="cpu")
    return jmodel, params, model, sources


def _rel(got, want) -> float:
    got, want = float(np.asarray(got.detach() if torch.is_tensor(got) else got)), float(want)
    return abs(got - want) / max(abs(want), 1e-12)


def test_ideal_binary_mask_and_bin_weights_match(rng):
    codes = np.abs(rng.standard_normal((2, 3, 20, 17))).astype(np.float32)
    codes[0, :, 0, 0] = 0.5  # a three-way tie: the first maximum wins
    np.testing.assert_array_equal(ideal_binary_mask(torch.from_numpy(codes)).numpy(),
                                  np.asarray(jfront.ideal_binary_mask(jnp.asarray(codes))))
    mix = codes.sum(axis=1) * np.float32(1e-3)
    mix[1, :4] = 1e-9  # near-silent bins, under the VAD threshold
    np.testing.assert_array_equal(vad_weights(torch.from_numpy(mix), 40.0).numpy(),
                                  np.asarray(jfront.vad_weights(jnp.asarray(mix), 40.0)))
    np.testing.assert_allclose(magnitude_weights(torch.from_numpy(mix)).numpy(),
                               np.asarray(jfront.magnitude_weights(jnp.asarray(mix))), rtol=1e-6)
    for kind in ("vad", "magnitude", "magvad"):
        np.testing.assert_allclose(
            bin_weights(torch.from_numpy(mix), kind, 40.0).numpy(),
            np.asarray(jfront.bin_weights(jnp.asarray(mix), kind, 40.0)), rtol=1e-6)
    with pytest.raises(ValueError, match="weight_kind"):
        bin_weights(torch.from_numpy(mix), "nope", 40.0)


@pytest.mark.parametrize("s,weights", [(2, "vad"), (3, "magnitude")])
def test_dpcl_loss_matches_jax(rng, s, weights):
    v = rng.standard_normal((2, 30, 65, 8)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    y = np.eye(s, dtype=np.float32)[rng.integers(0, s, (2, 30, 65))]
    w = (rng.random((2, 30, 65)) > 0.3).astype(np.float32)
    if weights == "magnitude":
        w = w * rng.random((2, 30, 65)).astype(np.float32) * 2
    got = dpcl_loss(torch.from_numpy(v), torch.from_numpy(y), torch.from_numpy(w))
    want = j_dpcl_loss(jnp.asarray(v), jnp.asarray(y), jnp.asarray(w))
    assert _rel(got, want) <= 1e-5


def test_loss_reproduces_golden_c1():
    jmodel, params, model, sources = _golden_setup()
    loss, metrics = model.loss(torch.from_numpy(sources))
    assert _rel(loss, GOLDEN_C1) <= 1e-4
    jloss, _ = jmodel.loss(params, jnp.asarray(sources))
    assert _rel(loss, jloss) <= 1e-4
    assert set(metrics) == {"dpcl_loss"}


def test_loss_with_reconstruction_term_matches_jax():
    jmodel, params, model, sources = _golden_setup(recon_weight=0.2)
    loss, metrics = model.loss(torch.from_numpy(sources))
    jloss, jmetrics = jmodel.loss(params, jnp.asarray(sources))
    assert set(metrics) == set(jmetrics) == {"dpcl_loss", "recon_l2"}
    assert _rel(loss, jloss) <= 1e-4
    assert abs(float(metrics["recon_l2"]) - float(jmetrics["recon_l2"])) <= 1e-6


def test_every_parameter_gradient_matches_jax_grad():
    jmodel, params, model, sources = _golden_setup()
    jgrads = jax.grad(lambda p: jmodel.loss(p, jnp.asarray(sources))[0])(params)
    jgrads = _np_tree(jgrads)
    model.train()
    loss, _ = model.loss(torch.from_numpy(sources))
    loss.backward()
    trained = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    assert not any(n.startswith("blstm.lstm.bias_hh") for n in trained)
    got = jax_tree(trained, 1)["separator"]
    want = jgrads["separator"]
    pairs = [(f"proj/{k}", got["proj"][k], want["proj"][k]) for k in ("w", "b")]
    for d in ("fwd", "bwd"):
        for k in ("wx", "wh", "b"):
            pairs.append((f"blstm/0/{d}/{k}", got["blstm"]["0"][d][k], want["blstm"][0][d][k]))
    for name, g, w in pairs:
        assert g.shape == w.shape, name
        err = float(np.abs(g - w).max())
        assert err <= 1e-4 * float(np.abs(w).max()), f"{name}: {err:.3e}"


@torch.no_grad()
def test_init_draws_the_reference_distributions():
    cfg = ModelConfig(sep=SeparatorConfig(hidden=16, layers=2, embed_dim=4))
    model = DPCLModel(cfg)
    model.init_parameters(torch.Generator().manual_seed(3))
    again = DPCLModel(cfg)
    again.init_parameters(torch.Generator().manual_seed(3))
    for (n, p), (_, q) in zip(model.named_parameters(), again.named_parameters()):
        assert torch.equal(p, q), n
    lstm = model.blstm.lstm
    for sfx in ("_l0", "_l0_reverse", "_l1", "_l1_reverse"):
        for w in ("weight_ih", "weight_hh"):
            t = getattr(lstm, w + sfx)
            assert float(t.abs().max()) <= 0.25 and float(t.abs().max()) > 0.2  # 1/sqrt(16)
        b = getattr(lstm, "bias_ih" + sfx)
        assert torch.equal(b[16:32], torch.ones(16)) and float(b[:16].abs().sum()) == 0.0
        assert float(getattr(lstm, "bias_hh" + sfx).abs().sum()) == 0.0
        assert not getattr(lstm, "bias_hh" + sfx).requires_grad
    bound = 1 / np.sqrt(32)
    assert bound * 0.9 < float(model.proj.weight.abs().max()) <= bound
    assert float(model.proj.bias.abs().sum()) == 0.0


def test_training_raises_for_what_is_not_ported():
    """The name is kept from when dropout and the train-time corruptions
    raised.  Both are ported (tests/test_torch_dropout.py,
    test_torch_augment.py): without a key each is off, as in the JAX package,
    and a key turns it on."""
    cfg = ModelConfig(sep=SeparatorConfig(hidden=8, layers=1, embed_dim=3, dropout=0.1))
    model = DPCLModel(cfg)
    model.init_parameters(torch.Generator().manual_seed(0))
    sources = torch.randn((1, 2, 1024), generator=torch.Generator().manual_seed(1)) * 0.1
    with torch.no_grad():
        plain = model.loss(sources)[0]
        assert torch.equal(model.loss(sources)[0], plain)
        assert not torch.equal(model.loss(sources, rng=DropoutKey(3))[0], plain)
    clean = DPCLModel(ModelConfig(sep=SeparatorConfig(hidden=8, layers=1, embed_dim=3)))
    clean.init_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        plain = clean.loss(sources)[0]
    for over in ({"train_noise_snr_db": (0.0, 10.0)}, {"train_reverb_rt60": (800.0, 3200.0)},
                 {"train_min_speakers": 1}):
        cfg = ModelConfig(sep=SeparatorConfig(hidden=8, layers=1, embed_dim=3), **over)
        model = DPCLModel(cfg)
        model.init_parameters(torch.Generator().manual_seed(0))
        with torch.no_grad():
            assert torch.equal(model.loss(sources)[0], plain)
            keyed = [model.loss(sources, rng=DropoutKey(k))[0] for k in range(4)]
        assert all(torch.isfinite(v) for v in keyed)
        assert any(not torch.equal(v, plain) for v in keyed), over


def test_params_to_jax_inverts_params_from_jax():
    jmodel, params, model, _ = _golden_setup()
    back = params_to_jax(model)
    assert set(back) == {"front", "separator"} and back["front"] == {}
    assert list(back["separator"]["blstm"]) == ["0"]
    want = _np_tree(params)
    want["separator"]["blstm"] = {"0": want["separator"]["blstm"][0]}
    flat, flat_want = jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(want)
    assert len(flat) == len(flat_want)
    for a, b in zip(flat, flat_want):
        assert a.dtype == np.float32 and a.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(a, b)
    again = params_from_jax(model.cfg, back, device="cpu")
    for (n, p), (_, q) in zip(model.named_parameters(), again.named_parameters()):
        assert torch.equal(p, q), n
