"""The port's data path against the JAX package's: the synthetic corpus, the
speaker store, the Mixer's plans and batches, and the int16 wire format, all
bit for bit; and the prefetcher's error and stall paths."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amss_tpu.data.mixer import Mixer as JMixer
from amss_tpu.data.store import SpeakerStore as JStore
from amss_tpu.data.synthetic import make_synthetic_corpus as j_make_corpus
from amss_tpu.data.synthetic import synth_speaker_wave as j_synth
from amss_tpu.train.engine import Trainer as JTrainer
from amss_tpu_torch.data.mixer import Mixer
from amss_tpu_torch.data.prefetch import Prefetcher
from amss_tpu_torch.data.store import SpeakerStore
from amss_tpu_torch.data.synthetic import make_synthetic_corpus, synth_speaker_wave
from amss_tpu_torch.train.engine import Trainer

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    ours = make_synthetic_corpus(str(root / "port"), n_speakers=9, seconds_per_speaker=1.5)
    theirs = j_make_corpus(str(root / "jax"), n_speakers=9, seconds_per_speaker=1.5)
    return ours, theirs


@pytest.mark.parametrize("seed,n", [(0, 8000), (10_003, 5000)])
def test_synthetic_v1_speaker_is_the_jax_packages(seed, n):
    np.testing.assert_array_equal(synth_speaker_wave(seed, n), j_synth(seed, n))


def test_corpus_files_and_manifest_are_equal(corpora):
    ours, theirs = corpora
    assert ours.manifest == theirs.manifest and ours.speakers == theirs.speakers
    for spk in ours.speakers:
        np.testing.assert_array_equal(np.asarray(ours.waveform(spk)),
                                      np.asarray(theirs.waveform(spk)))
    # each package opens the other's directory
    assert SpeakerStore(theirs.root).speakers == JStore(ours.root).speakers


@pytest.mark.parametrize("split,step,host", [("train", 0, 0), ("train", 7, 0), ("valid", 3, 0),
                                             ("test", 1, 2)])
def test_mixer_plans_and_batches_are_bit_equal(corpora, split, step, host):
    ours, theirs = corpora
    # a chunk longer than a shard exercises the wrap-around fill
    for t in (2048, 16000):
        m, jm = Mixer(ours, chunk_samples=t, seed=5), JMixer(theirs, chunk_samples=t, seed=5)
        assert m.split_speakers == jm.split_speakers
        assert m.n_train_speakers() == jm.n_train_speakers()
        p, jp = m.plan(split, step, 3, host=host), jm.plan(split, step, 3, host=host)
        for k in ("speaker_ids", "starts", "gains"):
            np.testing.assert_array_equal(getattr(p, k), getattr(jp, k))
        b, jb = m.batch(split, step, 3, host=host), jm.batch(split, step, 3, host=host)
        assert b.sources.dtype == np.float32 and b.sources.shape == (3, 2, t)
        for k in ("sources", "speaker_ids", "gains"):
            np.testing.assert_array_equal(getattr(b, k), getattr(jb, k))


def test_int16_wire_round_trips_as_the_jax_packages(corpora):
    batch = Mixer(corpora[0], chunk_samples=2048, seed=1).batch("train", 0, 4)
    batch.sources[0, 0, :3] = [1.5, -1.5, 0.25]  # clipped at full scale
    wire = Trainer._host_arrays(batch)
    jwire = {"sources_q": np.clip(batch.sources * 32767.0, -32767.0, 32767.0).astype(np.int16)}
    np.testing.assert_array_equal(wire["sources_q"], jwire["sources_q"])
    got = Trainer._dequantize({"sources_q": torch.from_numpy(wire["sources_q"])})["sources"]
    want = JTrainer._dequantize({"sources_q": jnp.asarray(jwire["sources_q"])})["sources"]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefetcher_yields_in_order_and_raises_the_workers_error():
    got = [s for s, _ in Prefetcher(lambda s: s, lambda h: h * 2, start_step=3, end_step=7)]
    assert got == [3, 4, 5, 6]

    def bad(step):
        if step == 2:
            raise KeyError("no such speaker")
        return step

    it = Prefetcher(bad, lambda h: h, start_step=0, end_step=5)
    assert [next(it)[0], next(it)[0]] == [0, 1]
    with pytest.raises(KeyError, match="no such speaker"):
        next(it)


def test_prefetcher_raises_on_a_stall():
    release = threading.Event()
    it = Prefetcher(lambda s: release.wait(5.0), lambda h: h, start_step=0, end_step=1,
                    stall_timeout=0.2)
    with pytest.raises(RuntimeError, match="produced nothing"):
        next(it)
    release.set()
    it.close()
