"""c2 end to end: the adaptive front + deep clustering on the committed
``checkpoints/c2_adapt`` weights (E = 40, channel norm, pool 2, smoothing of
4), the port against the JAX package, both on the CPU.

Tolerances, the c1 slice's (tests/test_torch_dpcl_slice.py) and why:
  * embeddings 1e-4 from the same features;
  * waveforms: per-utterance SI-SDR(port, JAX), best speaker order, >= 40 dB
    at 30 k-means iterations and >= 30 dB at the served 10, where the
    k-means seed's tie (ROADMAP C.2) may start the two packages from
    different points;
  * quality: the PIT SI-SDR improvement of the bench.py protocol within
    0.2 dB of the JAX package's;
  * the weight round trip is exact.

Run as a script to print the quality numbers of both packages, the source of
chip_smoke.py's c2 gate:
    python tests/test_torch_c2_slice.py
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
from amss_tpu.train.engine import load_model_from_run as j_load  # noqa: E402
from amss_tpu_torch.ckpt.checkpoint import load_params  # noqa: E402
from amss_tpu_torch.infer.streaming import BucketSpec, StreamingSeparator  # noqa: E402
from amss_tpu_torch.ops.metrics import sdr_improvement, si_sdr  # noqa: E402
from amss_tpu_torch.weights import load_model_from_run, params_from_jax, params_to_jax  # noqa: E402

torch.set_num_threads(2)

RUN = os.path.join(REPO, "checkpoints", "c2_adapt")
T = 16384


@pytest.fixture(scope="module")
def models():
    jm, jp = j_load(RUN)
    return jm, jp, load_model_from_run(RUN, device="cpu")


@pytest.fixture(scope="module")
def mixes():
    mix, _ = bench._mix_pairs(2, T)
    return np.stack(mix)


def _best_order_si_sdr(est: np.ndarray, ref: np.ndarray) -> np.ndarray:
    e, r = torch.tensor(est, dtype=torch.float64), torch.tensor(ref, dtype=torch.float64)
    return torch.maximum(si_sdr(e, r).mean(-1), si_sdr(e.flip(1), r).mean(-1)).numpy()


def test_the_checkpoint_loads_with_its_learned_front(models):
    _, jp, tm = models
    cfg = tm.cfg
    assert (cfg.front.kind, cfg.sep.feature_norm, cfg.sep.embed_dim) == ("adapt", "channel", 40)
    for name in ("enc", "dec", "smooth"):
        np.testing.assert_array_equal(getattr(tm.front, name).detach().numpy(),
                                      np.asarray(jp["front"][name]))


def test_weights_round_trip(models):
    _, _, tm = models
    tree = params_to_jax(tm)
    stored = load_params(RUN)
    for name in ("enc", "dec", "smooth"):
        np.testing.assert_array_equal(tree["front"][name], stored["front"][name])
    np.testing.assert_array_equal(tree["separator"]["proj"]["w"], stored["separator"]["proj"]["w"])
    again = params_from_jax(tm.cfg, tree, device="cpu")
    for (n, a), (m, b) in zip(tm.state_dict().items(), again.state_dict().items()):
        assert n == m and torch.equal(a, b), n


def test_the_autoencoder_builds_but_has_no_separator_to_load():
    """One table maps a kind to its class (``weights.py::MODELS``):
    ``make_model`` builds c2's pretraining autoencoder from it, and
    ``params_from_jax``, which loads separators, refuses that kind."""
    from amss_tpu_torch.configs.recipes import c2_pretrain_adapt
    from amss_tpu_torch.models.adapt import AdaptAutoencoder
    from amss_tpu_torch.train.engine import make_model

    cfg = c2_pretrain_adapt().model
    assert type(make_model(cfg)) is AdaptAutoencoder
    with pytest.raises(ValueError, match="model kind 'adapt_ae' has no separator to load"):
        params_from_jax(cfg, {"front": {}, "separator": {}}, device="cpu")


def test_embeddings_match(models, mixes):
    jm, jp, tm = models
    codes, _ = jm.front.encode(jp["front"], jnp.asarray(mixes))
    feats = np.array(jm.front.features(jp["front"], codes))
    mask = np.ones(feats.shape[:2], np.float32)
    mask[1, 80:] = 0.0
    for m in (None, mask):
        want = np.asarray(jm.embed(jp, jnp.asarray(feats), None if m is None else jnp.asarray(m)))
        with torch.no_grad():
            got = tm.embed(torch.from_numpy(feats), None if m is None else torch.from_numpy(m))
        assert got.shape == want.shape == (2, 126, 256, 40)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("iters,min_db", [(30, 40.0), (10, 30.0)])
def test_separated_waveforms_match(models, mixes, iters, min_db):
    jm, jp, tm = models
    want = np.asarray(jm.separate(jp, jnp.asarray(mixes), kmeans_iters=iters))
    got = tm.separate(torch.from_numpy(mixes), kmeans_iters=iters).numpy()
    assert got.shape == want.shape == (2, 2, T)
    assert np.isfinite(got).all()
    agree = _best_order_si_sdr(got, want)
    assert (agree >= min_db).all(), agree


def _quality():
    """(port, JAX) mean PIT SI-SDRi and the JAX package's 95% interval on the
    bench.py trained-quality protocol (64 mixtures of 16384 samples)."""
    jm, jp = j_load(RUN)
    want, band = bench._trained_quality(jm, jp, s=2)
    mixes, refs = bench._mix_pairs(64, T)
    sep = StreamingSeparator(load_model_from_run(RUN, device="cpu"),
                             buckets=BucketSpec(lengths=(T,)), device="cpu")
    est = np.stack(sep.separate_all(mixes, max_batch=8))
    got = sdr_improvement(torch.from_numpy(est).double(), torch.from_numpy(np.stack(refs)).double(),
                          torch.from_numpy(np.stack(mixes)).double()).mean()
    return float(got), float(want), band


def test_quality_protocol_matches_jax():
    got, want, _ = _quality()
    assert abs(got - want) <= 0.2, (got, want)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    port, ref, band = _quality()
    print(f"bench.py trained-quality protocol (64 mixtures, c2_adapt, CPU float32): "
          f"port si_sdri {port:.3f} dB, JAX package {ref:.3f} dB, 95% CI {band}, n=64")
