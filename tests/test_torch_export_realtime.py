"""The realtime artifact (``export_realtime``, ``RealtimeArtifact``) and the
pure step of ``infer/realtime.py`` on the CPU, against the JAX package's on
the same weights: the JAX test's tiny c7 (``tests/test_export.py``).

Bounds: the artifact against the port's and the JAX package's offline
``separate``, and against the JAX package's ``RealtimeArtifact``: atol 1e-4,
the JAX test's own bound for streamed against offline; the pure ``step``
against the separator's pushes: bit for bit (the same operations), and
against the JAX package's ``RealtimeSeparator``: rtol 1e-4, atol 1e-5 (the
bound of ``tests/test_torch_realtime.py``)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from amss_tpu.infer.export import RealtimeArtifact as JRealtimeArtifact
from amss_tpu.infer.export import export_realtime as j_export_realtime
from amss_tpu.infer.realtime import RealtimeSeparator as JRealtime
from amss_tpu_torch.infer.export import (
    RealtimeArtifact,
    ServingArtifact,
    export_realtime,
    export_serving,
)
from amss_tpu_torch.infer.realtime import RealtimeSeparator
from amss_tpu_torch.utils.config import FrontConfig, ModelConfig, SeparatorConfig
from amss_tpu_torch.weights import params_from_jax
from test_export import _tiny_c7_model, _waves

torch.set_num_threads(2)

ATOL = 1e-4
CHUNK = 1024


def _port_cfg(jcfg) -> ModelConfig:
    d = dataclasses.asdict(jcfg)
    return ModelConfig(front=FrontConfig(**d.pop("front")), sep=SeparatorConfig(**d.pop("sep")),
                       **d)


@pytest.fixture(scope="module")
def c7(tmp_path_factory):
    """(JAX model, JAX params, the port's model, port dirs {streams: dir}, JAX
    dirs {streams: dir}) at one and two streams."""
    jm = _tiny_c7_model()
    jp = jm.init(jax.random.PRNGKey(1))
    model = params_from_jax(_port_cfg(jm.cfg), jax.tree_util.tree_map(np.asarray, jp),
                            device="cpu")
    root = tmp_path_factory.mktemp("rt")
    ours, theirs = {}, {}
    for b in (1, 2):
        ours[b], theirs[b] = str(root / f"port{b}"), str(root / f"jax{b}")
        export_realtime(model, ours[b], chunk_samples=CHUNK, n_streams=b, platforms=("cpu",))
        j_export_realtime(jm, jp, theirs[b], chunk_samples=CHUNK, n_streams=b,
                          platforms=("cpu",))
    return jm, jp, model, ours, theirs


def _offline(model, wave: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        return model.separate(torch.from_numpy(wave[None]))[0].numpy()


def _j_offline(jm, jp, wave: np.ndarray) -> np.ndarray:
    return np.asarray(jm.separate(jp, jax.numpy.asarray(wave[None])))[0]


def test_artifact_equals_offline_and_the_jax_artifact(c7):
    jm, jp, model, ours, theirs = c7
    art = RealtimeArtifact(ours[1], device="cpu")
    assert (art.c, art.b, art.n_speakers) == (CHUNK, 1, 2)
    assert art.lag == JRealtimeArtifact(theirs[1]).lag
    wave = _waves([3000], seed=3)[0]
    got = art.separate_stream(wave)
    assert got.shape == (2, 3000)
    np.testing.assert_allclose(got, _offline(model, wave), atol=ATOL)
    np.testing.assert_allclose(got, _j_offline(jm, jp, wave), atol=ATOL)
    np.testing.assert_allclose(got, JRealtimeArtifact(theirs[1]).separate_stream(wave),
                               atol=ATOL)

    # push: the state persists across pushes; reset starts a new stream
    art.reset()
    first = art.push(wave[:CHUNK])
    assert first.shape == (2, CHUNK)
    art.push(wave[CHUNK : 2 * CHUNK])
    art.reset()
    np.testing.assert_array_equal(art.push(wave[:CHUNK]), first)
    with pytest.raises(ValueError, match="push expects"):
        art.push(wave[:512])


def test_multistream_ragged(c7):
    jm, jp, model, ours, theirs = c7
    art = RealtimeArtifact(ours[2], device="cpu")
    waves = _waves([2000, 1300], seed=7)
    got = art.separate_streams(waves)
    want = JRealtimeArtifact(theirs[2]).separate_streams(waves)
    for g, w, j in zip(got, waves, want):
        assert g.shape == (2, len(w))
        np.testing.assert_allclose(g, _offline(model, w), atol=ATOL)
        np.testing.assert_allclose(g, j, atol=ATOL)
    solo = art.separate_streams(waves[:1])  # a short group leaves a slot empty
    np.testing.assert_allclose(solo[0], got[0], atol=1e-5)
    with pytest.raises(ValueError, match="separate_stream serves one"):
        art.separate_stream(waves[0])
    with pytest.raises(ValueError, match="1..2 waves"):
        art.separate_streams(waves * 2)


def test_step_is_pure_and_equals_the_pushes(c7):
    """``step(state, chunk, end)`` threaded by the caller gives the separator's
    pushes bit for bit, leaves its input state as it was, and matches the JAX
    package's ``RealtimeSeparator`` push by push."""
    jm, jp, model, _, _ = c7
    wave = _waves([4 * CHUNK], seed=9)[0]
    chunks = wave.reshape(4, 1, CHUNK)
    rt = RealtimeSeparator(model, chunk_samples=CHUNK, device="cpu")
    pushed = [rt.push(c[0]) for c in chunks]
    jrt = JRealtime(jm, jp, chunk_samples=CHUNK)
    jpushed = [np.asarray(jrt.push(c[0])) for c in chunks]

    fresh = RealtimeSeparator(model, chunk_samples=CHUNK, device="cpu")
    state = fresh._init_state()
    end = torch.full((1,), np.iinfo(np.int32).max, dtype=torch.int64)
    for c, want, jwant in zip(chunks, pushed, jpushed):
        before = jax.tree_util.tree_map(lambda t: t.clone(), state)
        est, nxt = fresh.step(state, torch.from_numpy(c), end)
        for a, b in zip(jax.tree_util.tree_leaves(before), jax.tree_util.tree_leaves(state)):
            assert torch.equal(a, b)  # the input state is untouched
        assert int(nxt["frame_base"]) == int(state["frame_base"]) + fresh.hop
        state = nxt
        np.testing.assert_array_equal(est.numpy()[0], want)
        np.testing.assert_allclose(est.numpy()[0], jwant, rtol=1e-4, atol=1e-5)


def test_artifact_kind_guards(c7, tmp_path):
    _, _, model, ours, _ = c7
    with pytest.raises(ValueError, match="RealtimeArtifact"):
        ServingArtifact(ours[1], device="cpu")
    off = str(tmp_path / "off")
    export_serving(model, off, lengths=(2048,), batch=1, platforms=("cpu",))
    with pytest.raises(ValueError, match="ServingArtifact"):
        RealtimeArtifact(off, device="cpu")
