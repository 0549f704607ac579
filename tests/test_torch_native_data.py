"""The native batch fill (``amss_tpu_torch/data/native.py``,
``csrc/amss_data.cc``) and the ``Mixer`` that fills through it, against the
numpy loop and the JAX package (``amss_tpu/data/native.py``,
``amss_tpu/data/mixer.py``), on the CPU.

Every comparison is bit for bit: the fill is one float32 product per sample
(gain times the shard's sample) whichever of the three computes it, and the
chunk selection is the same numpy draw.  A failed build raises, naming the
compiler's message (the JAX package's binding falls back to numpy instead).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from amss_tpu.data.mixer import Mixer as JMixer
from amss_tpu.data.native import batch_fill as j_batch_fill
from amss_tpu.data.store import SpeakerStore as JStore
from amss_tpu_torch.data import native
from amss_tpu_torch.data.mixer import Mixer
from amss_tpu_torch.data.native import _chunk_wrap, batch_fill, batch_fill_ref
from amss_tpu_torch.data.store import SpeakerStore
from amss_tpu_torch.ops.kernels import build

torch.set_num_threads(2)

T = 1024


def _shards(seed=0, lens=(5000, 300, 20000, 1024, 1)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for n in lens]


def _draw(shards, n, seed=1, wrap=True):
    """Speakers, starts (anywhere in the shard with ``wrap``, so that short
    shards and late starts wrap; else where a whole chunk fits) and gains."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(shards), n).astype(np.int32)
    hi = [len(shards[i]) if wrap else max(len(shards[i]) - T, 1) for i in idx]
    starts = np.array([rng.integers(0, h) for h in hi], np.int64)
    gains = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return idx, starts, gains


@pytest.mark.parametrize("wrap", [False, True], ids=["in_range", "wrapping"])
def test_the_fill_is_the_numpy_loops_and_the_jax_packages_bit_for_bit(wrap):
    shards = _shards()
    idx, starts, gains = _draw(shards, 24, wrap=wrap)
    if wrap:  # a shard shorter than T, read from near its end
        idx[0], starts[0] = 1, 290
    got, ref, jax_out = (np.full((24, T), np.nan, np.float32) for _ in range(3))
    batch_fill(got, shards, idx, starts, gains)
    batch_fill_ref(ref, shards, idx, starts, gains)
    assert j_batch_fill(jax_out, shards, idx, starts, gains)  # the JAX package's native path
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, jax_out)
    if wrap:
        np.testing.assert_array_equal(got[0], gains[0] * _chunk_wrap(shards[1], 290, T))


def test_the_fill_reads_memory_mapped_shards(tmp_path):
    shards = _shards(seed=2)
    paths = []
    for i, s in enumerate(shards):
        paths.append(str(tmp_path / f"{i}.npy"))
        np.save(paths[-1], s)
    mapped = [np.load(p, mmap_mode="r") for p in paths]
    idx, starts, gains = _draw(shards, 10, seed=3)
    got, want = np.empty((10, T), np.float32), np.empty((10, T), np.float32)
    batch_fill(got, mapped, idx, starts, gains)
    batch_fill_ref(want, shards, idx, starts, gains)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """Eight speakers of several lengths, two of them shorter than the chunk,
    written once and read by both packages."""
    root = str(tmp_path_factory.mktemp("corpus"))
    s = SpeakerStore.create(root, 8000)
    rng = np.random.default_rng(4)
    for i, n in enumerate((6000, 9000, 700, 12000, 5000, 900, 7000, 8000)):
        s.add_speaker(f"spk{i}", rng.standard_normal(n))
    s.finalize()
    return root


@pytest.mark.parametrize("split,step", [("train", 0), ("train", 7), ("valid", 3),
                                        ("test", 11), ("train", 5_000_000)])
def test_mixer_batch_is_the_jax_packages_bit_for_bit(store, split, step):
    ours = Mixer(SpeakerStore(store), nb_speakers=2, chunk_samples=T, seed=5)
    theirs = JMixer(JStore(store), nb_speakers=2, chunk_samples=T, seed=5)
    a, b = ours.batch(split, step, 4), theirs.batch(split, step, 4)
    assert a.sources.shape == (4, 2, T) and a.sources.dtype == np.float32
    np.testing.assert_array_equal(a.sources, b.sources)
    np.testing.assert_array_equal(a.speaker_ids, b.speaker_ids)
    np.testing.assert_array_equal(a.gains, b.gains)


def test_mixer_batch_is_the_numpy_loop_on_every_draw(store):
    m = Mixer(SpeakerStore(store), nb_speakers=2, chunk_samples=T, seed=6)
    for step in range(3):
        plan = m.plan("train", step, 3)
        shards = [m.store.waveform(s) for s in m.store.speakers]
        want = np.empty((6, T), np.float32)
        batch_fill_ref(want, shards, plan.speaker_ids.ravel(), plan.starts.ravel(),
                       plan.gains.ravel())
        np.testing.assert_array_equal(m.batch("train", step, 3).sources, want.reshape(3, 2, T))


def test_a_failed_build_raises_with_the_compilers_message(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    bad = tmp_path / "broken.cc"
    bad.write_text('extern "C" void f() { this is not C++ }\n')
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        build.build_native(bad)
    assert "broken.cc" in str(err.value) and "error" in str(err.value)
    good = tmp_path / "good.cc"
    good.write_text('extern "C" int f() { return 1; }\n')
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        build.build_native(good)


def test_the_build_is_cached_by_source_hash(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    lib, seconds = build.build_native()
    assert lib.exists() and lib.parent.name.startswith("native-") and seconds > 0
    again, seconds = build.build_native()
    assert again == lib and seconds == 0.0
    assert os.listdir(lib.parent) == [lib.name]  # no temporary left behind


def test_bad_arguments_are_refused():
    shards = _shards()
    idx, starts, gains = _draw(shards, 4)
    with pytest.raises(ValueError, match="float32"):
        batch_fill(np.empty((4, T), np.float64), shards, idx, starts, gains)
    with pytest.raises(ValueError, match="rows"):
        batch_fill(np.empty((5, T), np.float32), shards, idx, starts, gains)
    with pytest.raises(ValueError, match="out of range"):
        batch_fill(np.empty((4, T), np.float32), shards[:1], np.full(4, 2), starts, gains)
    with pytest.raises(ValueError, match="shard 0"):
        batch_fill(np.empty((4, T), np.float32), [s.astype(np.float64) for s in shards], idx,
                   starts, gains)
    assert native.load_native().amss_batch_fill.restype is None
