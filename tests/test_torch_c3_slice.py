"""c3 end to end: L41 on the committed ``checkpoints/c3_l41`` (STFT 256/64, a
2×300 BLSTM, E = 20, a centroid table of 100 training speakers), the port
against the JAX package, both on the CPU: enrolled (the speakers' centroids
give sigmoid masks) and blind (k-means, hard masks) through both packages'
``StreamingSeparator``, the weight round trip, and three steps of the c3
recipe against the JAX ``Trainer``.

Tolerances and why:
  * enrolled: 1e-4 of the output's largest magnitude (the same float32
    functions; the features of near-silent bins differ by float rounding,
    ROADMAP C.3, but a sigmoid mask moves smoothly with them);
  * blind: per-utterance SI-SDR of the port's output against the JAX
    package's >= 30 dB, the c1 slice's bound at the served 10 Lloyd
    iterations (ROADMAP C.2: seeds picked by rounding can stop short of the
    common fixed point);
  * the train steps: the bounds of tests/test_torch_train.py.

The checkpoint was trained on the v2 synthetic corpus of 100 speakers x 120 s
from seed 1 (``scripts/r3_wave.py``'s ``V2BIG``), so its centroid table's
speakers can be rebuilt from seeds (``data/synthetic.py::SyntheticStore``).
Run as a script to print the quality numbers of both packages: blind on the
bench.py protocol (64 two-speaker mixtures of 16384 samples) and enrolled on
ENROLLED_N mixtures of that corpus's training speakers at unseen offsets
(``scripts/quality_pipeline.py``'s protocol), the sources of chip_smoke.py's
c3 gates:
    python tests/test_torch_c3_slice.py
"""

import dataclasses
import json
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
from amss_tpu.configs import recipes as jrecipes  # noqa: E402
from amss_tpu.data.synthetic import make_synthetic_corpus as j_make_corpus  # noqa: E402
from amss_tpu.infer.streaming import BucketSpec as JBuckets  # noqa: E402
from amss_tpu.infer.streaming import StreamingSeparator as JStreaming  # noqa: E402
from amss_tpu.train.engine import Trainer as JTrainer  # noqa: E402
from amss_tpu.train.engine import load_model_from_run as j_load  # noqa: E402
from amss_tpu_torch.ckpt.checkpoint import load_params  # noqa: E402
from amss_tpu_torch.configs import recipes  # noqa: E402
from amss_tpu_torch.data.mixer import Mixer  # noqa: E402
from amss_tpu_torch.data.store import SpeakerStore  # noqa: E402
from amss_tpu_torch.data.synthetic import SyntheticStore  # noqa: E402
from amss_tpu_torch.infer.streaming import BucketSpec, StreamingSeparator  # noqa: E402
from amss_tpu_torch.models.l41 import L41Model  # noqa: E402
from amss_tpu_torch.ops.metrics import sdr_improvement, si_sdr  # noqa: E402
from amss_tpu_torch.train.engine import Trainer  # noqa: E402
from amss_tpu_torch.weights import load_model_from_run, params_to_jax  # noqa: E402

torch.set_num_threads(2)

RUN = os.path.join(REPO, "checkpoints", "c3_l41")
BUCKET = 8192
LOSS = "train/l41_loss"
ENROLLED_N = 16  # mixtures of the enrolled protocol (two batches of 8)
ENROLLED_OFFSET = 10_000_000  # scripts/quality_pipeline.py's unseen train-split steps


@pytest.fixture(autouse=True)
def _jnp_path(monkeypatch):
    monkeypatch.setenv("AMSS_PALLAS", "0")


@pytest.fixture(scope="module")
def models():
    jm, jp = j_load(RUN)
    return jm, jp, load_model_from_run(RUN, device="cpu")


def enrolled_mixtures(n: int = ENROLLED_N):
    """(sources [n, 2, 16384], speaker ids [n, 2]): the checkpoint's training
    speakers at unseen chunk offsets, rebuilt from seeds."""
    store = SyntheticStore(n_speakers=100, seconds_per_speaker=120.0, seed=1, version=2)
    mixer = Mixer(store, nb_speakers=2, chunk_samples=16384, seed=0)
    batches = [mixer.batch("train", ENROLLED_OFFSET + i, 1) for i in range(n)]
    return (np.concatenate([b.sources for b in batches]),
            np.concatenate([b.speaker_ids for b in batches]))


def test_the_checkpoint_loads_and_round_trips(models):
    _, _, model = models
    cfg = model.cfg
    assert isinstance(model, L41Model)
    assert (cfg.n_train_speakers, cfg.sep.embed_dim, cfg.sep.hidden, cfg.front.kind) == (
        100, 20, 300, "stft")
    stored, tree = load_params(RUN), params_to_jax(model)
    assert sorted(tree["separator"]) == sorted(stored["separator"]) == ["blstm", "centroids",
                                                                         "proj"]
    np.testing.assert_array_equal(tree["separator"]["centroids"],
                                  stored["separator"]["centroids"])
    np.testing.assert_array_equal(tree["separator"]["proj"]["w"], stored["separator"]["proj"]["w"])


def test_enrolled_matches_jax(models):
    jm, jp, model = models
    mixes, _ = bench._mix_pairs(2, BUCKET)
    mix = np.stack(mixes)
    ids = np.asarray([[3, 17], [42, 99]], np.int32)
    want = np.asarray(jax.jit(lambda p, m, s: jm.separate(p, m, speaker_ids=s))(
        jp, jnp.asarray(mix), jnp.asarray(ids)))
    got = model.separate(torch.from_numpy(mix), speaker_ids=torch.from_numpy(ids)).numpy()
    assert got.shape == want.shape == (2, 2, BUCKET) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_enrolled_speakers_are_the_rebuilt_training_split():
    sources, ids = enrolled_mixtures(2)
    store = SyntheticStore(n_speakers=100, seconds_per_speaker=120.0, seed=1, version=2)
    train = Mixer(store, nb_speakers=2, chunk_samples=16384, seed=0).split_speakers["train"]
    assert sources.shape == (2, 2, 16384) and ids.shape == (2, 2)
    assert all(store.speakers[i] in train for i in ids.ravel())


def test_blind_through_streaming_separator_matches_jax(models):
    jm, jp, model = models
    mixes, _ = bench._mix_pairs(2, BUCKET)
    waves = [mixes[0][:6001], mixes[1]]
    want = JStreaming(jm, jp, buckets=JBuckets(lengths=(BUCKET,))).separate_all(waves)
    got = StreamingSeparator(model, buckets=BucketSpec(lengths=(BUCKET,)),
                             device="cpu").separate_all(waves)
    for w, g, j in zip(waves, got, want):
        assert g.shape == j.shape == (2, len(w)) and np.isfinite(g).all()
        # the speakers' order is k-means's: take the better of the two
        a, b = (si_sdr(torch.from_numpy(g[None]).double(),
                       torch.from_numpy(np.array(x[None])).double())
                for x in (j, j[::-1]))
        assert max(float(a.min()), float(b.min())) >= 30.0, (a, b)


def _tiny(mod, steps=3):
    """c3 cut to one BLSTM layer of 16, E = 4, batch 2 of 2048 samples, EMA
    on, over the ten speakers of the test corpus."""
    r = mod.c3_l41(n_train_speakers=10)
    return dataclasses.replace(
        r,
        train=dataclasses.replace(r.train, batch_size=2, chunk_samples=2048, steps=steps,
                                  valid_every=steps, valid_steps=1, lr=3e-3, ema_decay=0.9),
        model=dataclasses.replace(r.model, sep=dataclasses.replace(
            r.model.sep, hidden=16, layers=1, embed_dim=4)),
    )


def _metrics(run_dir: str, key: str) -> dict:
    out = {}
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if key in rec:
                out[rec["step"]] = rec[key]
    return out


def test_three_c3_steps_follow_the_jax_trainer(tmp_path):
    root = tmp_path / "corpus"
    j_make_corpus(str(root), n_speakers=10, seconds_per_speaker=2.0)
    store = SpeakerStore(str(root))
    jtr = JTrainer(_tiny(jrecipes), store, workdir=str(tmp_path / "jax"))
    init = jtr.init_state()
    jinit = jax.tree_util.tree_map(np.asarray, init["params"])
    jtr.fit(state=init, log_every=1)
    tr = Trainer(_tiny(recipes), store, workdir=str(tmp_path / "port"), device="cpu")
    batch = tr._device_batch(tr.mixer.batch("train", 0, 2))
    assert batch["speaker_ids"].dtype == torch.int32 and batch["speaker_ids"].shape == (2, 2)
    tr.fit(tr.state_from_tree({"params": jinit}), log_every=1)
    assert os.path.basename(tr.dir) == os.path.basename(jtr.dir)
    ours, theirs = _metrics(tr.dir, LOSS), _metrics(jtr.dir, LOSS)
    assert sorted(ours) == sorted(theirs) == [1, 2, 3]
    assert abs(ours[1] - theirs[1]) <= 1e-4 * abs(theirs[1])
    for s in (2, 3):
        assert abs(ours[s] - theirs[s]) <= 1e-3 * abs(theirs[s]), s
    v, jv = _metrics(tr.dir, "valid/loss")[3], _metrics(jtr.dir, "valid/loss")[3]
    assert abs(v - jv) <= 1e-3 * abs(jv)


def _ci(imp: np.ndarray) -> list:
    boot = np.random.default_rng(0).choice(imp, size=(10000, imp.size)).mean(axis=1)
    return [round(float(v), 3) for v in np.percentile(boot, [2.5, 97.5])]


def _imp(est, refs, mixes) -> np.ndarray:
    return sdr_improvement(torch.from_numpy(np.asarray(est)).double(),
                           torch.from_numpy(refs).double(),
                           torch.from_numpy(mixes).double()).numpy()


def _quality():
    """The port's and the JAX package's mean SI-SDRi with the JAX package's
    95% interval: blind on the bench.py protocol, enrolled on the rebuilt
    training speakers."""
    jm, jp = j_load(RUN)
    model = load_model_from_run(RUN, device="cpu")
    out = {}
    want, band = bench._trained_quality(jm, jp, s=2)
    mixes, refs = bench._mix_pairs(64, 16384)
    sep = StreamingSeparator(model, buckets=BucketSpec(lengths=(16384,)), device="cpu")
    est = np.stack(sep.separate_all(mixes, max_batch=8))
    out["blind"] = (float(_imp(est, np.stack(refs), np.stack(mixes)).mean()), want, band)
    sources, ids = enrolled_mixtures()
    mix = sources.sum(axis=1)
    fn = jax.jit(lambda p, m, s: jm.separate(p, m, speaker_ids=s))
    jest = np.concatenate([np.asarray(fn(jp, jnp.asarray(mix[i : i + 8]), jnp.asarray(ids[i : i + 8])))
                           for i in range(0, len(mix), 8)])
    est = np.concatenate([model.separate(torch.from_numpy(mix[i : i + 8]),
                                         speaker_ids=torch.from_numpy(ids[i : i + 8])).numpy()
                          for i in range(0, len(mix), 8)])
    jimp = _imp(jest, sources, mix)
    out["enrolled"] = (float(_imp(est, sources, mix).mean()), float(jimp.mean()), _ci(jimp))
    return out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(os.cpu_count())
    q = _quality()
    port, ref, band = q["blind"]
    print(f"bench.py trained-quality protocol (64 mixtures of 2 speakers, c3_l41 blind, CPU): "
          f"port si_sdri {port:.3f} dB, JAX package {ref:.3f} dB, 95% CI {band}, n=64")
    port, ref, band = q["enrolled"]
    print(f"enrolled protocol ({ENROLLED_N} mixtures of the rebuilt training speakers, c3_l41 "
          f"enrolled, CPU): port si_sdri {port:.3f} dB, JAX package {ref:.3f} dB, 95% CI "
          f"{band}, n={ENROLLED_N}")
