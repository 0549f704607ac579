"""The STFT front, instance norm and VAD weights against the JAX package.

atol 2e-3 on STFT-scaled values (float32 sums of 256 terms in another
order), 2e-4 on waveforms, 1e-5 on normalised features."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amss_tpu.models.front import STFTFrontEnd as JFront
from amss_tpu.models.front import instance_norm as j_instance_norm
from amss_tpu.models.front import vad_weights as j_vad_weights
from amss_tpu.ops.framing import overlap_add as jola
from amss_tpu.ops.stft import hann_window as jhann
from amss_tpu.utils.config import FrontConfig as JFrontConfig
from amss_tpu_torch.models.front import STFTFrontEnd, instance_norm, make_front, vad_weights
from amss_tpu_torch.ops.stft import cola_norm, hann_window, istft_ri, stft_ri
from amss_tpu_torch.utils.config import FrontConfig

torch.set_num_threads(2)


@pytest.fixture
def fronts():
    return STFTFrontEnd(FrontConfig()), JFront(JFrontConfig())


def test_encode_matches_jax(rng, fronts):
    front, jfront = fronts
    wave = (0.3 * rng.standard_normal((2, 3, 4096))).astype(np.float32)
    mag, aux = front.encode(torch.from_numpy(wave))
    jmag, jaux = jfront.encode({}, jnp.asarray(wave))
    assert mag.shape == jmag.shape == (2, 3, 61, 129)
    np.testing.assert_allclose(mag.numpy(), np.asarray(jmag), atol=2e-3)
    # the phase of a near-zero bin is rounding noise: compare re and im
    for key in ("cos", "sin"):
        np.testing.assert_allclose((mag * aux[key]).numpy(),
                                   np.asarray(jmag * jaux[key]), atol=2e-3)
    np.testing.assert_allclose(front.features(mag).numpy(),
                               np.asarray(jfront.features({}, jnp.asarray(mag.numpy()))),
                               atol=1e-6)


def test_decode_matches_jax_on_masked_spectra(rng, fronts):
    front, jfront = fronts
    wave = (0.3 * rng.standard_normal((2, 4096))).astype(np.float32)
    jmag, jaux = jfront.encode({}, jnp.asarray(wave))
    # an inconsistent (masked) spectrum, as separation makes
    masked = np.asarray(jmag) * rng.uniform(size=jmag.shape).astype(np.float32)
    aux = {k: torch.tensor(np.asarray(v)) for k, v in jaux.items()}
    for length in (4096, 4000, 4500):
        got = front.decode(torch.from_numpy(masked), aux, length).numpy()
        want = np.asarray(jfront.decode({}, jnp.asarray(masked), jaux, length))
        assert got.shape == want.shape == (2, length)
        np.testing.assert_allclose(got, want, atol=2e-4)


def test_stft_istft_reconstruct_and_match_jax(rng):
    from amss_tpu.ops.stft import istft_ri as j_istft_ri
    from amss_tpu.ops.stft import stft_ri as j_stft_ri

    x = rng.standard_normal((2, 2048)).astype(np.float32)
    re, im = stft_ri(torch.from_numpy(x), 256, 64)
    jre, jim = j_stft_ri(jnp.asarray(x), 256, 64)
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), atol=2e-3)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), atol=2e-3)
    y = istft_ri(re, im, 256, 64, length=2048).numpy()
    np.testing.assert_allclose(y, np.asarray(j_istft_ri(jre, jim, 256, 64, length=2048)),
                               atol=2e-4)
    np.testing.assert_allclose(y[:, 256:-256], x[:, 256:-256], atol=1e-4)


def test_cola_clamp_is_relative_to_the_peak():
    win, hop, nf = 256, 64, 61
    window = torch.from_numpy(hann_window(win))
    np.testing.assert_array_equal(window.numpy(), jhann(win))
    norm = cola_norm(window, nf, hop, None).numpy()
    raw = np.asarray(jola(jnp.tile(jnp.asarray(jhann(win) ** 2)[None], (nf, 1)), hop))
    floor = 1e-2 * raw.max()
    np.testing.assert_allclose(norm, np.maximum(raw, floor), rtol=1e-6)
    # the clamp bites at both edges, where the raw normaliser tends to zero
    assert norm[0] == pytest.approx(floor) and norm[-1] == pytest.approx(floor)
    assert raw[0] < floor and raw[-1] < floor
    assert (norm[win:-win] > floor).all()


def test_instance_norm_matches_jax_with_a_ragged_mask(rng):
    feats = rng.standard_normal((3, 20, 129)).astype(np.float32) * 3 + 1
    mask = np.zeros((3, 20), np.float32)
    for b, n in enumerate((20, 13, 1)):
        mask[b, :n] = 1.0
    for m in (None, mask):
        got = instance_norm(torch.from_numpy(feats), None if m is None else torch.from_numpy(m))
        want = j_instance_norm(jnp.asarray(feats), None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_vad_weights_match_jax(rng):
    codes = np.exp(rng.uniform(-12, 2, size=(2, 30, 129))).astype(np.float32)
    for db in (40.0, 20.0):
        got = vad_weights(torch.from_numpy(codes), db).numpy()
        want = np.asarray(j_vad_weights(jnp.asarray(codes), db))
        np.testing.assert_array_equal(got, want)
        assert 0 < got.mean() < 1


def test_make_front_covers_stft_only():
    # slice 3 added the adaptive front; any other kind raises
    from amss_tpu_torch.models.adapt import AdaptFrontEnd

    assert isinstance(make_front(FrontConfig()), STFTFrontEnd)
    assert isinstance(make_front(FrontConfig(kind="adapt")), AdaptFrontEnd)
    with pytest.raises(ValueError, match="unknown front kind"):
        make_front(FrontConfig(kind="tasnet"))
