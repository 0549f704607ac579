"""WAV ingest (``data/store.py::ingest_wav_tree``, ``_read_wav``), the port
against the JAX package on the CPU: a tree of 16-bit WAVs at 16 kHz and 8 kHz
goes into 8 kHz stores whose ``.npy`` files and manifests are bit-equal, so
either package reads a store the other ingested.  The resampler is the copy
held bit for bit in tests/test_torch_eval.py."""

import json
import os
import struct
import wave

import numpy as np
import pytest
import torch

from amss_tpu.data import store as jstore
from amss_tpu_torch.data.mixer import Mixer
from amss_tpu_torch.data.store import SpeakerStore, _read_wav, ingest_wav_tree
from amss_tpu_torch.data.synthetic import synth_speaker_wave_v2
from amss_tpu_torch.infer.evaluate import write_wav

torch.set_num_threads(2)


SPEAKERS = [f"spk{c}" for c in "ABCDEF"]


def _tree(root, rates=(16000, 8000), seconds=1.5):
    """Six speakers, each with an utterance at every rate in ``rates`` (one
    in a subdirectory), and a file that is not a WAV."""
    for s, spk in enumerate(SPEAKERS):
        for u, rate in enumerate(rates):
            x = synth_speaker_wave_v2(100 * s + u, int(seconds * rate), sample_rate=rate)
            sub = os.path.join(root, spk, "sess1" if u else "")
            write_wav(os.path.join(sub, f"utt{u}.wav"), x, sample_rate=rate)
        with open(os.path.join(root, spk, "notes.txt"), "w") as f:
            f.write("not audio")
    return root


def _store_files(root):
    return {fn: open(os.path.join(root, fn), "rb").read() for fn in sorted(os.listdir(root))}


@pytest.mark.parametrize("sample_rate", [8000, None])
def test_ingest_writes_the_jax_packages_store_bit_for_bit(tmp_path, sample_rate):
    wavs = _tree(str(tmp_path / "wavs"))
    got = ingest_wav_tree(wavs, str(tmp_path / "port"), sample_rate=sample_rate)
    want = jstore.ingest_wav_tree(wavs, str(tmp_path / "jax"), sample_rate=sample_rate)
    assert got.sample_rate == want.sample_rate == (sample_rate or 16000)
    assert got.speakers == want.speakers == SPEAKERS
    assert _store_files(got.root) == _store_files(want.root)
    with open(os.path.join(got.root, "manifest.json")) as f:
        manifest = json.load(f)
    utts = manifest["speakers"]["spkA"]["utterances"]
    n16, n8 = int(1.5 * 16000), int(1.5 * 8000)
    want_lens = [n16 // 2, n8] if sample_rate == 8000 else [n16, 2 * n8]
    assert [b - a for a, b in utts] == want_lens
    # the other package's store opens here and feeds the Mixer
    other = SpeakerStore(want.root)
    np.testing.assert_array_equal(other.waveform("spkB"), got.waveform("spkB"))
    batch = Mixer(other, nb_speakers=2, chunk_samples=4000, seed=0).batch("train", 0, 2)
    assert batch.sources.shape == (2, 2, 4000) and np.isfinite(batch.sources).all()


def test_read_wav_takes_int16_int32_and_the_first_channel(tmp_path):
    x = np.linspace(-1.0, 1.0, 101).astype(np.float32)
    path = str(tmp_path / "m.wav")
    write_wav(path, x, sample_rate=8000)
    got, sr = _read_wav(path)
    want, jsr = jstore._read_wav(path)
    assert sr == jsr == 8000
    np.testing.assert_array_equal(got, want)
    pcm = (np.stack([x, -x], axis=1) * 2**31 * 0.5).astype(np.int32)
    with wave.open(str(tmp_path / "s.wav"), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(4)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    got, sr = _read_wav(str(tmp_path / "s.wav"))
    np.testing.assert_array_equal(got, jstore._read_wav(str(tmp_path / "s.wav"))[0])
    assert sr == 16000 and got.shape == (101,)
    np.testing.assert_allclose(got, 0.5 * x, atol=1e-6)


def _float_wav(path, x, rate=8000):
    """An IEEE-float (format 3) WAV, which the stdlib ``wave`` cannot parse."""
    data = np.asarray(x, "<f4").tobytes()
    fmt = struct.pack("<HHIIHH", 3, 1, rate, 4 * rate, 4, 32)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", len(fmt)) + fmt)
        f.write(b"data" + struct.pack("<I", len(data)) + data)


def test_float_wavs_and_empty_trees_raise(tmp_path):
    os.makedirs(tmp_path / "wavs" / "spkA")
    _float_wav(str(tmp_path / "wavs" / "spkA" / "f.wav"), np.zeros(100))
    for ingest in (ingest_wav_tree, jstore.ingest_wav_tree):
        with pytest.raises(ValueError, match="only integer PCM"):
            ingest(str(tmp_path / "wavs"), str(tmp_path / "out"))
    os.makedirs(tmp_path / "none")
    with pytest.raises(ValueError, match="no speaker directories"):
        ingest_wav_tree(str(tmp_path / "none"), str(tmp_path / "out"))
    os.makedirs(tmp_path / "silent" / "spkA")
    with pytest.raises(ValueError, match="no WAV files"):
        ingest_wav_tree(str(tmp_path / "silent"), str(tmp_path / "out"))
