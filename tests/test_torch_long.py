"""Long-form serving (``amss_tpu_torch/infer/long.py``) and the over-bucket
path of ``StreamingSeparator``, against the JAX package's ``infer/long.py``
on the CPU.

Tolerances and why:
  * ``stitch_chunks`` and ``_group_widths`` are host code copied line for
    line: bit for bit and exactly equal;
  * ``separate_long``: per-utterance SI-SDR(port, JAX), best speaker order,
    >= 30 dB, the c1 slice's bound at the served 10 k-means iterations
    (ROADMAP C.2), on the committed c1_dpcl weights with chunks of 8192
    samples so that an utterance of a few seconds spans several chunks and
    two groups;
  * an utterance no longer than one chunk is one ``separate`` call: equal.

Run as a script to print the JAX package's SI-SDRi and 95% interval on the
long-form mixtures of chip_smoke.py (4 of 60 s and 4 of 90 s, c1_dpcl, chunks
of 64000 samples), the source of its long-form gate:
    python tests/test_torch_long.py
"""

import inspect
import os
import sys

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from amss_tpu.data.synthetic import synth_speaker_wave_v2 as j_synth  # noqa: E402
from chip_smoke import LONG_SECONDS, LONG_SEED0  # noqa: E402
from amss_tpu.infer import long as jlong  # noqa: E402
from amss_tpu.infer.streaming import BucketSpec as JBuckets  # noqa: E402
from amss_tpu.infer.streaming import StreamingSeparator as JStreaming  # noqa: E402
from amss_tpu.train.engine import load_model_from_run as j_load  # noqa: E402
from amss_tpu_torch.infer import long  # noqa: E402
from amss_tpu_torch.infer.streaming import BucketSpec, StreamingSeparator  # noqa: E402
from amss_tpu_torch.ops.metrics import si_sdr  # noqa: E402
from amss_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from amss_tpu_torch.weights import load_model_from_run  # noqa: E402

torch.set_num_threads(2)

RUN = os.path.join(REPO, "checkpoints", "c1_dpcl")
CHUNK = 8192


def long_mixtures(seconds=LONG_SECONDS, seed0=LONG_SEED0):
    """chip_smoke.py's long-form mixtures (by default) from the JAX package's
    synthetic speakers: (mixtures, sources)."""
    refs = [np.stack([j_synth(seed0 + 2 * i + j, n_samples=s * 8000) for j in range(2)])
            .astype(np.float32) for i, s in enumerate(seconds)]
    return [r.sum(axis=0) for r in refs], refs


@pytest.fixture(scope="module")
def models():
    jm, jp = j_load(RUN)
    return jm, jp, load_model_from_run(RUN, device="cpu")


def _best_order_db(est: np.ndarray, ref: np.ndarray) -> float:
    """SI-SDR of est [S, T] against ref, mean over speakers, best order."""
    e, r = torch.tensor(est, dtype=torch.float64), torch.tensor(ref, dtype=torch.float64)
    return float(torch.maximum(si_sdr(e, r).mean(), si_sdr(e.flip(0), r).mean()))


def test_group_widths_are_the_jax_packages():
    assert (long.CHUNK_BATCH, long.TAIL_BATCH) == (jlong.CHUNK_BATCH, jlong.TAIL_BATCH)
    for n in range(1, 41):
        assert long._group_widths(n) == jlong._group_widths(n), n
    assert long._group_widths(8) == [8] and long._group_widths(12) == [8, 4]


def test_chunk_layout_is_the_jax_packages():
    """The JAX package's default overlap, clamped as it clamps it; the chunk
    counts chip_smoke.py predicts its launches from."""
    assert inspect.signature(jlong.separate_long).parameters["overlap"].default == long.OVERLAP
    assert long.chunk_layout(21000, CHUNK) == (2048, [0, 6144, 12288, 18432], 26624)
    assert [len(long.chunk_layout(s * 8000, 64000)[1]) for s in (60, 90)] == [8, 12]
    assert long.chunk_layout(64001, 64000) == (4096, [0, 59904], 123904)


@pytest.mark.parametrize("s_dim", [2, 3])
def test_stitch_chunks_is_the_jax_packages_bit_for_bit(s_dim):
    rng = np.random.default_rng(s_dim)
    chunk, overlap, t = 1000, 200, 4300
    hop = chunk - overlap
    n_chunks = -(-max(t - overlap, 1) // hop)
    t_pad = (n_chunks - 1) * hop + chunk
    truth = rng.standard_normal((s_dim, t_pad)).astype(np.float32)
    starts = [i * hop for i in range(n_chunks)]
    est = np.stack([truth[:, s : s + chunk] for s in starts])
    est += 0.05 * rng.standard_normal(est.shape).astype(np.float32)
    for ci in range(1, n_chunks, 2):  # planted swaps: k-means labels per chunk
        est[ci] = np.roll(est[ci], 1, axis=0)
    got = long.stitch_chunks(est, starts, overlap, t, t_pad)
    want = jlong.stitch_chunks(est, starts, overlap, t, t_pad)
    assert got.shape == (s_dim, t)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - truth[:, :t]).max() < 0.3  # the swaps were undone


def test_separate_long_matches_jax(models):
    jm, jp, tm = models
    mixes, _ = long_mixtures(seconds=(3, 9), seed0=700)
    mixes = [m[: n] for m, n in zip(mixes, (21000, 66000))]  # 4 chunks: [4]; 11: [8, 4]
    for mix in mixes:
        want = jlong.separate_long(jm, jp, mix, chunk=CHUNK)
        got = long.separate_long(tm, mix, chunk=CHUNK)
        assert got.shape == want.shape == (2, len(mix))
        assert np.isfinite(got).all()
        assert _best_order_db(got, want) >= 30.0


def test_a_short_utterance_is_one_separate_call(models):
    _, _, tm = models
    mix = long_mixtures(seconds=(1,), seed0=900)[0][0][:7000]
    got = long.separate_long(tm, mix, chunk=CHUNK)
    want = tm.separate(torch.from_numpy(mix[None]))[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_separate_long_sharded_raises(models):
    """The name is kept from when the sharded path raised: it is ported
    (``tests/test_torch_parallel.py``).  Over a mesh of two CPU entries with
    8 chunks a slice, each slice has the batch shape of ``separate_long``'s
    group, so c1 serves the same chunks to the bit; what raises is a mesh of
    more cards than there are (none here)."""
    _, _, tm = models
    mix = long_mixtures(seconds=(4,), seed0=910)[0][0]
    want = long.separate_long(tm, mix, chunk=CHUNK)
    got = long.separate_long_sharded(tm, mix, chunk=CHUNK, mesh=["cpu", "cpu"])
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="asked for 2 devices, have 0"):
        long.separate_long_sharded(tm, mix, chunk=CHUNK, mesh=make_mesh(2))


def test_streaming_separator_serves_over_bucket_utterances(models, monkeypatch):
    jm, jp, tm = models
    lengths = (5000, 21000, 8000, 30000)
    waves = [j_synth(40 + i, n) + j_synth(60 + i, n) for i, n in enumerate(lengths)]
    sep = StreamingSeparator(tm, buckets=BucketSpec(lengths=(4096, CHUNK)), device="cpu")
    calls = []

    def spy(model, mix, chunk, **kw):
        calls.append((len(mix), chunk))
        return long.separate_long(model, mix, chunk=chunk, **kw)

    monkeypatch.setattr("amss_tpu_torch.infer.streaming.separate_long", spy)
    got = sep.separate_all(waves, max_batch=2)
    assert calls == [(21000, CHUNK), (30000, CHUNK)]  # chunks of the largest bucket
    assert [g.shape for g in got] == [(2, n) for n in lengths]
    m = sep.meter
    assert m.utterances == 4 and m.calls == 2 + 1  # two long calls, one bucket group
    assert m.audio_seconds == pytest.approx(sum(lengths) / 8000)
    warm = m.warmup_seconds
    assert warm > 0 and ("long", CHUNK) in sep._warm
    again = sep.separate_all(waves, max_batch=2)  # every shape is warm now
    assert sep.meter.warmup_seconds == warm
    for a, b in zip(got, again):
        np.testing.assert_array_equal(a, b)

    jsep = JStreaming(jm, jp, buckets=JBuckets(lengths=(4096, CHUNK)))
    want = jsep.separate_all(waves, max_batch=2)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _best_order_db(g, w) >= 30.0


def _jax_long_quality() -> dict:
    from amss_tpu.infer.evaluate import bootstrap_ci
    from amss_tpu_torch.ops.metrics import sdr_improvement

    jm, jp = j_load(RUN)
    mixes, refs = long_mixtures()
    est = JStreaming(jm, jp, buckets=JBuckets(lengths=(64000,))).separate_all(mixes, max_batch=8)
    imp = [float(sdr_improvement(torch.from_numpy(e[None]).double(),
                                 torch.from_numpy(r[None]).double(),
                                 torch.from_numpy(m[None]).double())[0])
           for e, r, m in zip(est, refs, mixes)]
    return {"per_mixture": imp, **bootstrap_ci(np.array(imp))}


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    q = _jax_long_quality()
    print(f"long-form (c1_dpcl, chunks of 64000, {len(LONG_SECONDS)} mixtures of "
          f"{LONG_SECONDS} s, CPU float32): JAX package si_sdri {q['mean']:.3f} dB, "
          f"95% CI [{q['ci_lo']:.3f}, {q['ci_hi']:.3f}], n={q['n']}; per mixture "
          f"{[round(v, 3) for v in q['per_mixture']]}")
