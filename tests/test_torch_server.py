"""The HTTP daemon (``amss_tpu_torch/infer/server.py``) on the CPU: its WAV
codec byte for byte against the JAX package's, and live in-process servers
whose responses equal direct artifact calls.  The offline server serves a
tiny c1 (a BLSTM under prefix masks of ragged utterances, ROADMAP C.5's
re-check for this caller); the realtime one a tiny c7 carried across from the
JAX package's init, streamed against its offline separation (atol 1e-4, the
JAX test's bound)."""

import base64
import dataclasses
import http.client
import json
import threading

import jax
import numpy as np
import pytest
import torch

from amss_tpu.infer import server as jserver
from amss_tpu_torch.infer.export import (
    RealtimeArtifact,
    ServingArtifact,
    export_realtime,
    export_serving,
)
from amss_tpu_torch.infer.server import SeparationServer, wav_bytes_decode, wav_bytes_encode
from amss_tpu_torch.models.dpcl import DPCLModel
from amss_tpu_torch.utils.config import FrontConfig, ModelConfig, SeparatorConfig
from amss_tpu_torch.weights import params_from_jax
from test_export import _tiny_c7_model

torch.set_num_threads(2)


def _spawn(artifact_dir):
    srv = SeparationServer(artifact_dir, port=0, device="cpu")  # an ephemeral port
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _request(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, body=body, headers=headers or {})
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r.status, data


@pytest.mark.parametrize("n,scale", [(777, 0.5), (1, 0.1), (4000, 3.0)])
def test_wav_codec_is_the_jax_packages(n, scale):
    x = (np.random.default_rng(n).standard_normal(n) * scale).astype(np.float32)
    data = wav_bytes_encode(x, 8000)
    assert data == jserver.wav_bytes_encode(x, 8000)
    y, sr = wav_bytes_decode(data)
    jy, jsr = jserver.wav_bytes_decode(data)
    assert sr == jsr == 8000 and y.dtype == np.float32
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_allclose(y, np.clip(x, -1, 1), atol=1 / 32767.0)


def test_wav_decode_32_bit_and_stereo():
    import io
    import wave

    pcm = (np.arange(-6, 6, dtype=np.int32) * 2**27).reshape(-1, 2)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(4)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    y, sr = wav_bytes_decode(buf.getvalue())
    jy, _ = jserver.wav_bytes_decode(buf.getvalue())
    assert sr == 16000 and y.shape == (6,)
    np.testing.assert_array_equal(y, jy)


@pytest.fixture(scope="module")
def offline_server(tmp_path_factory):
    cfg = ModelConfig(kind="dpcl", front=FrontConfig(kind="stft", win=256, hop=64),
                      sep=SeparatorConfig(hidden=8, layers=2, embed_dim=5), nb_speakers=2)
    model = DPCLModel(cfg)
    model.init_parameters(torch.Generator().manual_seed(0))
    d = str(tmp_path_factory.mktemp("srv") / "art")
    export_serving(model.eval(), d, lengths=(2048,), batch=2, platforms=("cpu",))
    srv = _spawn(d)
    yield srv, ServingArtifact(d, device="cpu")
    srv.shutdown()


def _separate(srv, wave):
    status, data = _request(srv.port, "POST", "/separate", wav_bytes_encode(wave, 8000))
    assert status == 200, data
    rep = json.loads(data)
    assert rep["sample_rate"] == 8000
    return [base64.b64decode(s) for s in rep["speakers"]]


def test_healthz_and_separate_ragged(offline_server):
    """Each response is the direct artifact call's WAV, byte for byte, for
    utterances shorter than, equal to and longer than the bucket."""
    srv, art = offline_server
    status, data = _request(srv.port, "GET", "/healthz")
    assert status == 200
    assert json.loads(data) == {"status": "ok", "kind": "offline", "n_speakers": 2,
                                "sample_rate": 8000}
    rng = np.random.default_rng(0)
    for n in (1500, 2048, 700, 5000):
        wave = (rng.standard_normal(n) * 0.3).astype(np.float32)
        got = _separate(srv, wave)
        direct = art.separate_all([wav_bytes_decode(wav_bytes_encode(wave, 8000))[0]])[0]
        assert len(got) == 2
        for s in range(2):
            assert got[s] == wav_bytes_encode(direct[s], 8000), (n, s)


def test_concurrent_requests_take_turns(offline_server):
    """Six clients at once: the lock serialises the artifact, and every client
    gets its own utterance's separation."""
    srv, art = offline_server
    rng = np.random.default_rng(1)
    waves = [(rng.standard_normal(600 + 200 * i) * 0.3).astype(np.float32) for i in range(6)]
    got: dict = {}

    def client(i):
        got[i] = _separate(srv, waves[i])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for i, w in enumerate(waves):
        direct = art.separate_all([wav_bytes_decode(wav_bytes_encode(w, 8000))[0]])[0]
        assert got[i] == [wav_bytes_encode(direct[s], 8000) for s in range(2)]


def test_separate_rejects_wrong_rate_and_route(offline_server):
    srv, _ = offline_server
    status, data = _request(srv.port, "POST", "/separate",
                            wav_bytes_encode(np.zeros(100, np.float32), 16000))
    assert status == 400 and b"16000" in data
    status, data = _request(srv.port, "POST", "/stream/push", b"\0" * 8)
    assert status == 400 and b"no route" in data
    status, data = _request(srv.port, "GET", "/metrics")
    assert status == 404
    status, data = _request(srv.port, "POST", "/separate", b"not a wav")
    assert status == 500 and b"error" in data  # wave.Error: the cause, as the JAX server answers


@pytest.fixture(scope="module")
def realtime_server(tmp_path_factory):
    jm = _tiny_c7_model()
    jp = jm.init(jax.random.PRNGKey(1))
    d = dataclasses.asdict(jm.cfg)
    cfg = ModelConfig(front=FrontConfig(**d.pop("front")), sep=SeparatorConfig(**d.pop("sep")),
                      **d)
    model = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    out = str(tmp_path_factory.mktemp("srv_rt") / "art")
    export_realtime(model, out, chunk_samples=1024, platforms=("cpu",))
    srv = _spawn(out)
    yield srv, RealtimeArtifact(out, device="cpu"), model
    srv.shutdown()


def test_stream_push_matches_offline(realtime_server):
    srv, art, model = realtime_server
    wave = (np.random.default_rng(5).standard_normal(2048) * 0.3).astype(np.float32)
    status, _ = _request(srv.port, "POST", "/stream/reset", b"")
    assert status == 200
    padded = np.zeros(3 * 1024, np.float32)
    padded[:2048] = wave
    end = art.front.frames_for(2048)
    blocks, direct = [], []
    art.reset()
    for i in range(3):
        chunk = padded[i * 1024 : (i + 1) * 1024]
        status, data = _request(srv.port, "POST", "/stream/push", chunk.tobytes(),
                                headers={"X-End-Frame": str(end)})
        assert status == 200, data
        blocks.append(np.frombuffer(data, np.float32).reshape(2, 1024))
        direct.append(art.push(chunk, end_frame=end))
    np.testing.assert_array_equal(np.stack(blocks), np.stack(direct))
    full = np.concatenate(blocks, axis=-1)[:, art.lag : art.lag + 2048]
    with torch.no_grad():
        ref = model.separate(torch.from_numpy(wave[None]))[0].numpy()
    np.testing.assert_allclose(full, ref, atol=1e-4)

    status, data = _request(srv.port, "POST", "/stream/push", b"\0" * 16)
    assert status == 400 and b"float32" in data
    status, data = _request(srv.port, "POST", "/separate", b"")
    assert status == 400 and b"no route" in data
