"""The adaptive front (``amss_tpu_torch/models/adapt.py``), the channel norm
and the c2 losses against the JAX package on the same parameters and inputs,
both on the CPU (the JAX package takes its plain path there, as its own
tests do; the port's kernel wrappers take their plain versions).

Tolerances and why:
  * codes, features, decoded waveforms: 1e-5 absolute on values of order 1
    (float32 products of 256 terms summed in other orders);
  * the pooling's argmax: exactly equal wherever the two pooled magnitudes
    of a window differ by more than 1e-5.  A smaller gap is a near-tie that
    float rounding may decide either way in the two packages;
  * the autoencoder's loss 1e-5 relative; its gradients 1e-4 of each
    tensor's largest magnitude (the SI-SDR's ratio and the 256-term products
    in both directions, in float32);
  * goldens "c2_pretrain" and "c2": 1e-4 relative, as tests/test_goldens.py
    holds the JAX package.
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
from amss_tpu.models.adapt import AdaptAutoencoder as JAE
from amss_tpu.models.adapt import AdaptFrontEnd as JFront
from amss_tpu.models.front import channel_norm as j_channel_norm
from amss_tpu.train.engine import make_model as j_make_model
from amss_tpu.utils.config import FrontConfig as JFrontConfig
from amss_tpu_torch.models.adapt import AdaptAutoencoder, AdaptFrontEnd, gabor_bank
from amss_tpu_torch.models.dpcl import DPCLModel
from amss_tpu_torch.models.front import channel_norm, make_front
from amss_tpu_torch.utils.config import FrontConfig, ModelConfig, SeparatorConfig
from amss_tpu_torch.weights import named_from_jax, params_from_jax

torch.set_num_threads(2)

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens.json")
CONFIGS = {
    "small": dict(kind="adapt", n_filters=32, filter_len=64, stride=16, pool=2, smooth_len=3),
    "recipe": dict(kind="adapt", n_filters=256, filter_len=256, stride=64, pool=2, smooth_len=4),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_model_cfg(jcfg) -> ModelConfig:
    d = dataclasses.asdict(jcfg)
    return ModelConfig(front=FrontConfig(**d.pop("front")), sep=SeparatorConfig(**d.pop("sep")),
                       **d)


def _fronts(name, seed=0):
    jf = JFront(JFrontConfig(**CONFIGS[name]))
    jp = _np(jf.init(jax.random.PRNGKey(seed)))
    tf = AdaptFrontEnd(FrontConfig(**CONFIGS[name]))
    tf.load_state_dict({k: torch.tensor(v) for k, v in jp.items()})
    return jf, jp, tf


def _wave(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encode_matches_jax(name):
    jf, jp, tf = _fronts(name)
    x = _wave((2, 3, 4000) if name == "small" else (2, 4096))
    want_codes, want_aux = jf.encode(jp, jnp.asarray(x))
    with torch.no_grad():
        codes, aux = tf.encode(torch.from_numpy(x))
    assert codes.shape == want_codes.shape and aux["t_frames"] == want_aux["t_frames"]
    np.testing.assert_allclose(codes.numpy(), np.asarray(want_codes), atol=1e-5)
    # the argmax where the window's two magnitudes are more than 1e-5 apart
    c = FrontConfig(**CONFIGS[name])
    z = np.asarray(jnp.matmul(
        np.stack([x[..., i * c.stride : i * c.stride + c.filter_len]
                  for i in range(want_aux["t_frames"])], axis=-2), jp["enc"]))
    mag = np.abs(z).reshape(*z.shape[:-2], -1, c.pool, z.shape[-1])
    top2 = np.sort(mag, axis=-2)
    clear = (top2[..., -1, :] - top2[..., -2, :]) > 1e-5
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(aux["idx"].numpy()[clear], np.asarray(want_aux["idx"])[clear])
    sure = np.abs(z) > 1e-5
    np.testing.assert_array_equal(aux["sign"].numpy()[sure], np.asarray(want_aux["sign"])[sure])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_features_and_decode_match_jax_on_the_same_codes(name):
    jf, jp, tf = _fronts(name, seed=1)
    x = _wave((2, 4096), seed=1)
    codes, aux = jf.encode(jp, jnp.asarray(x))
    want_f = np.asarray(jf.features(jp, codes))
    want_y = np.asarray(jf.decode(jp, codes, aux, 4000))
    taux = {k: torch.from_numpy(np.asarray(v)) if not isinstance(v, int) else v
            for k, v in aux.items()}
    with torch.no_grad():
        got_f = tf.features(torch.from_numpy(np.asarray(codes)))
        got_y = tf.decode(torch.from_numpy(np.asarray(codes)), taux, 4000)
    np.testing.assert_allclose(got_f.numpy(), want_f, atol=1e-5)
    assert got_y.shape == want_y.shape == (2, 4000)
    np.testing.assert_allclose(got_y.numpy(), want_y, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_channel_norm_matches_jax(masked):
    rng = np.random.default_rng(2)
    feats = (rng.standard_normal((3, 20, 8)) * rng.uniform(0.1, 5.0, 8)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((3, 20), np.float32)
        mask[1, 12:] = 0.0
        mask[2, 1:] = 0.0
    want = j_channel_norm(jnp.asarray(feats), None if mask is None else jnp.asarray(mask))
    got = channel_norm(torch.from_numpy(feats), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_make_front_and_the_gabor_init():
    cfg = FrontConfig(**CONFIGS["small"])
    front = make_front(cfg)
    assert isinstance(front, AdaptFrontEnd)
    front.init_parameters(torch.Generator().manual_seed(0))
    bank = gabor_bank(cfg.n_filters, cfg.filter_len)
    jbank = np.asarray(JFront(JFrontConfig(**CONFIGS["small"])).init(jax.random.PRNGKey(0))["dec"])
    # the bank is the JAX package's; only the N(0, 0.05²) noise differs
    assert (jbank - bank).std() == pytest.approx(0.05, rel=0.1)
    assert (front.dec.detach().numpy() - bank).std() == pytest.approx(0.05, rel=0.1)
    assert front.enc.shape == (cfg.filter_len, cfg.n_filters)
    assert front.smooth.shape == (cfg.smooth_len, 1)
    np.testing.assert_allclose(front.smooth.detach().numpy().mean(), 1 / cfg.smooth_len, atol=0.2)


def test_autoencoder_loss_and_gradients_match_jax():
    jr = jrecipes.c2_pretrain_adapt()
    jm = JAE(dataclasses.replace(jr.model, front=JFrontConfig(**CONFIGS["small"])))
    jp = jm.init(jax.random.PRNGKey(3))
    src = _wave((2, 2, 2048), seed=3) / 3
    (jl, jmet), jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, jnp.asarray(src)),
                                                has_aux=True))(jp)
    tm = AdaptAutoencoder(_port_model_cfg(jm.cfg))
    tm.load_state_dict(named_from_jax(_np(jp)))
    loss, met = tm.loss(torch.from_numpy(src))
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    for k in ("neg_si_sdr", "l2"):
        assert float(met[k]) == pytest.approx(float(jmet[k]), rel=1e-5)
    loss.backward()
    for name in ("enc", "dec", "smooth"):
        want = np.asarray(jg["front"][name])
        grad = getattr(tm.front, name).grad
        # the AE loss never reads the features: smooth's gradient is 0 in JAX
        # and None here, which the trainer takes as 0
        got = np.zeros_like(want) if grad is None else grad.numpy()
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(initial=0.0), name
    assert np.abs(np.asarray(jg["front"]["enc"])).max() > 0


def test_dpcl_with_the_adapt_front_gradients_match_jax():
    """c2's DPCL + reconstruction loss: the front's gradients, the smoothing
    included, against ``jax.grad``."""
    jr = jrecipes.c2_adapt_dpcl()
    jcfg = dataclasses.replace(
        jr.model, front=JFrontConfig(**CONFIGS["small"]),
        sep=dataclasses.replace(jr.model.sep, hidden=8, layers=1, embed_dim=3))
    jm = j_make_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(4))
    src = _wave((2, 2, 1024), seed=4) / 3
    (jl, _), jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, jnp.asarray(src)),
                                             has_aux=True))(jp)
    tm = params_from_jax(_port_model_cfg(jcfg), _np(jp), device="cpu")
    loss, metrics = tm.loss(torch.from_numpy(src))
    assert set(metrics) == {"dpcl_loss", "recon_l2"}
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    loss.backward()
    for name in ("enc", "dec", "smooth"):
        want = np.asarray(jg["front"][name])
        got = getattr(tm.front, name).grad.numpy()
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), name


def test_apply_masks_passes_non_tensor_aux_through():
    jr = jrecipes.c2_adapt_dpcl()
    cfg = _port_model_cfg(dataclasses.replace(
        jr.model, front=JFrontConfig(**CONFIGS["small"]),
        sep=dataclasses.replace(jr.model.sep, hidden=8, layers=1, embed_dim=3)))
    model = DPCLModel(cfg)
    model.init_parameters(torch.Generator().manual_seed(0))
    mix = torch.from_numpy(_wave((2, 3000)))
    with torch.no_grad():
        codes, aux = model.front.encode(mix)
        assert isinstance(aux["t_frames"], int)
        masks = torch.full((*codes.shape, 2), 0.5)
        y = model.apply_masks_and_decode(codes, aux, masks, 3000)
        whole = model.front.decode(codes, aux, 3000)
    assert y.shape == (2, 2, 3000)
    np.testing.assert_allclose(y.sum(dim=1).numpy(), whole.numpy(), atol=1e-6)


def _port_golden(name: str) -> tuple[float, float]:
    """(the port's loss, the golden) on tests/test_goldens.py's protocol: the
    JAX init from PRNGKey(7) carried across, the same draws in the same
    order."""
    recipes = {"c2_pretrain": jrecipes.c2_pretrain_adapt(), "c2": jrecipes.c2_adapt_dpcl()}
    recipe = recipes[name]
    sep = dataclasses.replace(recipe.model.sep, hidden=16, layers=1, embed_dim=4)
    jcfg = dataclasses.replace(recipe.model, sep=sep)
    jp = _np(j_make_model(jcfg).init(jax.random.PRNGKey(7)))
    rng = np.random.default_rng(1234)
    # the draws of tests/test_goldens.py: one per recipe before this one
    for n in ("c1", "c2_pretrain", "c2"):
        sources = (rng.standard_normal((2, 2, 2048)) * 0.1).astype(np.float32)
        if n == name:
            break
    cfg = _port_model_cfg(jcfg)
    if name == "c2":
        model = params_from_jax(cfg, jp, device="cpu")
    else:
        model = AdaptAutoencoder(cfg)
        model.load_state_dict(named_from_jax(jp))
    with torch.no_grad():
        loss, _ = model.loss_from_batch({"sources": torch.from_numpy(sources)})
    with open(GOLDENS) as f:
        return float(loss), json.load(f)[name]


@pytest.mark.parametrize("name", ["c2_pretrain", "c2"])
def test_golden(name):
    got, want = _port_golden(name)
    assert abs(got - want) <= 1e-4 * max(abs(want), 1.0), (got, want)
