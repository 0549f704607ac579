"""The train-time corruptions (``drop_sources``, ``corrupt_mix``,
``reverberate_sources``), the port against the JAX package on the CPU.

The port draws from a ``DropoutKey`` and cannot replay ``jax.random``, so each
apply is fed the JAX package's own draws, reproduced here from its key and
constants, and the port's draws are checked by their statistics.  Tolerances:
  * ``apply_drop``: bit-equal;
  * ``apply_noise``: 1e-6 of the peak (float32 RMS sums in another order);
  * ``apply_reverb``: 1e-5 of the peak (a 1600-tap float32 convolution in
    another order); exact zeros before an impulse; the direct tap to 1e-6;
    the DRR within 0.2 dB; unit energy within 1e-4;
  * model losses with the JAX draws patched in: DPCL and Chimera 1e-5
    relative (their targets and weights bit-equal), TasNet 1e-4 relative, as
    each slice's loss tests hold them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amss_tpu.models import front as jfront
from amss_tpu.train.engine import make_model as j_make_model
from amss_tpu.utils.config import FrontConfig as JFront
from amss_tpu.utils.config import ModelConfig as JModel
from amss_tpu.utils.config import SeparatorConfig as JSep
from amss_tpu_torch.models import front
from amss_tpu_torch.models.dprnn import DropoutKey
from amss_tpu_torch.utils.config import FrontConfig, ModelConfig, SeparatorConfig
from amss_tpu_torch.weights import params_from_jax

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _jnp_path(monkeypatch):
    monkeypatch.setenv("AMSS_PALLAS", "0")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# -- the JAX package's draws, reproduced from its key and constants ---------

def j_counts(rng, b, s, min_speakers):
    return _t(jax.random.randint(jax.random.fold_in(rng, 0xC0DE7), (b,), min_speakers, s + 1))


def j_noise(rng, shape, snr_db_range):
    kn, ks = jax.random.split(jax.random.fold_in(rng, 0x5E15E))
    snr = jax.random.uniform(ks, (shape[0],), minval=snr_db_range[0], maxval=snr_db_range[1])
    return _t(snr), _t(jax.random.normal(kn, shape, jnp.float32))


def j_reverb(rng, b, s, rir_len, rt60_range, drr_db_range):
    kt, kd, kn = jax.random.split(jax.random.fold_in(rng, 0x4EE4B), 3)
    rt60 = jax.random.uniform(kt, (b, s, 1), minval=rt60_range[0], maxval=rt60_range[1])
    drr = jax.random.uniform(kd, (b, s, 1), minval=drr_db_range[0], maxval=drr_db_range[1])
    gauss = jax.random.normal(kn, (b, s, rir_len - 1), jnp.float32)
    return _t(rt60), _t(drr), _t(gauss)


def _patch_jax_draws(monkeypatch, rng):
    """The port's draw functions, returning the JAX package's draws of ``rng``."""
    monkeypatch.setattr(front, "draw_active_counts",
                        lambda key, b, s, m: j_counts(rng, b, s, m))
    monkeypatch.setattr(front, "draw_noise",
                        lambda key, shape, r, device: j_noise(rng, tuple(shape), r))
    monkeypatch.setattr(front, "draw_reverb",
                        lambda key, b, s, n, r, d, device: j_reverb(rng, b, s, n, r, d))


def _sources(seed, b, s, t):
    return (np.random.default_rng(seed).standard_normal((b, s, t)) * 0.1).astype(np.float32)


# -- each apply against the JAX function ------------------------------------

@pytest.mark.parametrize("min_speakers", [1, 2, 3])
def test_drop_matches_jax_bit_for_bit(min_speakers):
    src = _sources(0, 16, 3, 256)
    rng = jax.random.PRNGKey(4)
    want = np.asarray(jfront.drop_sources(jnp.asarray(src), rng, min_speakers))
    k = j_counts(rng, 16, 3, min_speakers)
    got = front.apply_drop(torch.from_numpy(src), k).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("snr_range", [(5.0, 20.0), (-5.0, 0.0)])
def test_noise_matches_jax(snr_range):
    mix = _sources(1, 4, 1, 8192)[:, 0]
    rng = jax.random.PRNGKey(7)
    want = np.asarray(jfront.corrupt_mix(jnp.asarray(mix), rng, snr_range))
    got = front.apply_noise(torch.from_numpy(mix), *j_noise(rng, mix.shape, snr_range)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("rt60,drr", [((800.0, 3200.0), (0.0, 10.0)), ((400.0, 1600.0), (5.0, 5.0))])
def test_reverb_matches_jax(rt60, drr):
    src = _sources(2, 2, 2, 4096)
    rng = jax.random.PRNGKey(3)
    want = np.asarray(jfront.reverberate_sources(jnp.asarray(src), rng, rt60, drr))
    n = front.rir_length(4096, rt60[1])
    got = front.apply_reverb(torch.from_numpy(src), *j_reverb(rng, 2, 2, n, rt60, drr)).numpy()
    assert got.shape == want.shape == src.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_reverb_of_an_impulse_is_its_room():
    """Causal (exact zeros before the impulse), the direct tap, the drawn DRR
    and unit energy, from the JAX package's draws."""
    at, t = 1000, 4096
    x = np.zeros((2, 2, t), np.float32)
    x[:, :, at] = 1.0
    rng = jax.random.PRNGKey(0)
    rt60, drr, gauss = j_reverb(rng, 2, 2, front.rir_length(t, 3200.0), (800.0, 3200.0),
                                (0.0, 10.0))
    y = front.apply_reverb(torch.from_numpy(x), rt60, drr, gauss).double().numpy()
    assert np.all(y[:, :, :at] == 0.0)
    direct = 1.0 / np.sqrt(1.0 + 10.0 ** (-drr.double().numpy()[..., 0] / 10.0))
    np.testing.assert_allclose(y[:, :, at], direct, atol=1e-6)
    got_drr = 10.0 * np.log10(y[:, :, at] ** 2 / (y[:, :, at + 1:] ** 2).sum(-1))
    assert np.abs(got_drr - drr.numpy()[..., 0]).max() <= 0.2
    np.testing.assert_allclose((y ** 2).sum(-1), 1.0, atol=1e-4)
    h = front.room_impulse_responses(rt60, drr, gauss).double()
    np.testing.assert_allclose((h ** 2).sum(-1).numpy(), 1.0, atol=1e-6)


# -- the port's own draws, by their statistics --------------------------------

def test_drawn_counts_cover_each_k_in_its_share():
    k = front.draw_active_counts(DropoutKey(5), 64, 3, 1)
    assert k.dtype == torch.int64 and set(k.tolist()) == {1, 2, 3}
    many = torch.cat([front.draw_active_counts(DropoutKey(5).fold_in(i), 64, 3, 1)
                      for i in range(50)])
    shares = torch.bincount(many, minlength=4)[1:].double() / many.numel()
    assert (shares - 1 / 3).abs().max() <= 0.03, shares
    assert set(front.draw_active_counts(DropoutKey(6), 64, 3, 2).tolist()) == {2, 3}
    assert set(front.draw_active_counts(DropoutKey(6), 64, 3, 3).tolist()) == {3}


def test_realised_snr_is_the_drawn_one():
    mix = torch.from_numpy(_sources(3, 8, 1, 16384)[:, 0])
    out = front.corrupt_mix(mix, DropoutKey(9), (12.5, 12.5))
    snr = 10 * torch.log10((mix.double() ** 2).mean(-1) / ((out - mix).double() ** 2).mean(-1))
    assert (snr - 12.5).abs().max() <= 0.1, snr
    snr_db, _ = front.draw_noise(DropoutKey(9), (256, 8), (5.0, 20.0), "cpu")
    assert 5.0 <= float(snr_db.min()) and float(snr_db.max()) < 20.0
    assert float(snr_db.max() - snr_db.min()) > 10.0


def test_one_key_draws_the_same_twice_and_another_key_not():
    src = torch.from_numpy(_sources(4, 2, 3, 4096))
    for fn in (lambda x, k: front.drop_sources(x, k, 1),
               lambda x, k: front.corrupt_mix(x.sum(1), k, (5.0, 20.0)),
               lambda x, k: front.reverberate_sources(x, k, (800.0, 3200.0))):
        a, b, c = fn(src, DropoutKey(11)), fn(src, DropoutKey(11)), fn(src, DropoutKey(12))
        assert torch.equal(a, b) and not torch.equal(a, c)


def test_sources_in_a_row_get_different_rooms():
    x = torch.zeros((2, 3, 4096))
    x[:, :, 0] = 1.0
    y = front.reverberate_sources(x, DropoutKey(13), (800.0, 3200.0))
    for b in range(2):
        for i in range(3):
            for j in range(i + 1, 3):
                assert not torch.allclose(y[b, i], y[b, j])
    rt60, drr, gauss = front.draw_reverb(DropoutKey(13), 2, 3, 1600, (800.0, 3200.0),
                                         (0.0, 10.0), "cpu")
    assert rt60.shape == drr.shape == (2, 3, 1) and gauss.shape == (2, 3, 1599)
    assert 800.0 <= float(rt60.min()) and float(rt60.max()) < 3200.0
    assert 0.0 <= float(drr.min()) and float(drr.max()) < 10.0


# -- model losses, the JAX draws patched in -----------------------------------

def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_cfg(jcfg: JModel) -> ModelConfig:
    d = dataclasses.asdict(jcfg)
    return ModelConfig(front=FrontConfig(**d.pop("front")), sep=SeparatorConfig(**d.pop("sep")),
                       **d)


def _count_cfg(kind="dpcl", **kw):
    """tests/test_count_diverse.py::_cfg."""
    return JModel(kind=kind, front=JFront(kind="stft", n_filters=64, filter_len=64, stride=32),
                  sep=JSep(hidden=24, layers=1, embed_dim=6), nb_speakers=3, **kw)


def _reverb_cfg(kind, **kw):
    """tests/test_reverb.py::_cfg."""
    fr = (JFront(kind="stft", win=128, hop=32) if kind == "dpcl" else
          JFront(kind="adapt", n_filters=32, filter_len=32, stride=16, pool=2, smooth_len=2))
    return JModel(kind=kind, front=fr, sep=JSep(hidden=32, layers=1, embed_dim=8, trunk="tcn",
                                                blocks=2, repeats=1),
                  nb_speakers=2, train_reverb_rt60=(400, 1600), **kw)


def _noise_cfg():
    """tests/test_noise_robust.py::_noisy_cfg."""
    return JModel(kind="tasnet",
                  front=JFront(kind="adapt", n_filters=32, filter_len=16, stride=8, pool=1),
                  sep=JSep(hidden=24, layers=1, embed_dim=4, trunk="tcn", blocks=2, repeats=1),
                  nb_speakers=2, train_noise_snr_db=(5.0, 20.0))


CASES = {
    "dpcl_count": (_count_cfg(train_min_speakers=1), 1e-5),
    "chimera_count": (_count_cfg("chimera", train_min_speakers=1), 1e-5),
    "tasnet_noise": (_noise_cfg(), 1e-4),
    "tasnet_reverb": (_reverb_cfg("tasnet"), 1e-4),
    "dpcl_reverb": (_reverb_cfg("dpcl"), 1e-5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_with_the_jax_draws_matches_jax(case, monkeypatch):
    jcfg, tol = CASES[case]
    jm = j_make_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    src = _sources(5, 4, jcfg.nb_speakers, 2048)
    rng = jax.random.PRNGKey(3)
    want, _ = jm.loss(jp, jnp.asarray(src), rng=rng)
    clean, _ = jm.loss(jp, jnp.asarray(src))
    model = params_from_jax(_port_cfg(jcfg), _np(jp), device="cpu").train()
    sources = torch.from_numpy(src)
    with torch.no_grad():
        plain = model.loss(sources)[0]
        _patch_jax_draws(monkeypatch, rng)
        got = model.loss(sources, rng=DropoutKey(0))[0]
    assert abs(float(got) - float(want)) <= tol * abs(float(want)), (float(got), float(want))
    # without a key the loss is the clean config's, in both packages
    assert abs(float(plain) - float(clean)) <= tol * abs(float(clean))
    jclean = dataclasses.replace(jcfg, train_min_speakers=None, train_noise_snr_db=None,
                                 train_reverb_rt60=None)
    clean_model = params_from_jax(_port_cfg(jclean), _np(jp), device="cpu").train()
    with torch.no_grad():
        assert torch.equal(clean_model.loss(sources)[0], plain)
    assert abs(float(want) - float(clean)) > 1e-6  # the corruption changed the loss


def test_dropped_sources_give_the_jax_targets_bit_for_bit(monkeypatch):
    jcfg = _count_cfg(train_min_speakers=1)
    jm = j_make_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    src = _sources(6, 8, 3, 2048)
    rng = jax.random.PRNGKey(8)
    _, _, _, _, jy, jw, _ = jm.encode_mix_and_sources(jp, jnp.asarray(src), rng=rng)
    model = params_from_jax(_port_cfg(jcfg), _np(jp), device="cpu")
    _patch_jax_draws(monkeypatch, rng)
    _, _, _, _, y, w, _ = model.encode_mix_and_sources(torch.from_numpy(src), DropoutKey(0))
    assert len(set(j_counts(rng, 8, 3, 1).tolist())) > 1
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))


def test_tasnet_ignores_the_count_draw():
    """TasNet mixes through ``observed_mix`` only, so ``train_min_speakers``
    changes nothing, in the JAX package and in the port alike."""
    jcfg = dataclasses.replace(_noise_cfg(), train_noise_snr_db=None, train_min_speakers=1)
    jm = j_make_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    src = _sources(7, 2, 2, 2048)
    want, _ = jm.loss(jp, jnp.asarray(src), rng=jax.random.PRNGKey(1))
    clean, _ = jm.loss(jp, jnp.asarray(src))
    assert float(want) == float(clean)
    model = params_from_jax(_port_cfg(jcfg), _np(jp), device="cpu")
    with torch.no_grad():
        a = model.loss(torch.from_numpy(src), rng=DropoutKey(1))[0]
        b = model.loss(torch.from_numpy(src))[0]
    assert torch.equal(a, b)
