"""c7 end to end: the causal TasNet on the committed ``checkpoints/c7_causal``
(L32 / stride 16, the cumulative norm, a causal TCN of 3 x 8 blocks at
expansion 4, float32), the port against the JAX package, both on the CPU:
offline through both packages' ``StreamingSeparator``, streamed through the
port's ``RealtimeSeparator``, and three steps of the c7 recipe against the
JAX ``Trainer``.

Tolerances and why:
  * served and streamed waveforms: 1e-4 of the output's largest magnitude
    (float32 through 24 blocks, products and prefix sums in other orders);
  * the first train step's loss 1e-4 relative, the next steps' 1e-3, the
    bounds of tests/test_torch_train.py (Adam's first steps move every
    weight by about ±lr, and rounding decides the signs of near-zero
    gradients).

Run as a script to print the quality numbers of both packages on the bench.py
protocol (64 two-speaker mixtures of 16384 samples), the source of
chip_smoke.py's c7 gate:
    python tests/test_torch_c7_slice.py
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
from amss_tpu_torch.configs import recipes  # noqa: E402
from amss_tpu_torch.data.store import SpeakerStore  # noqa: E402
from amss_tpu_torch.infer.realtime import RealtimeSeparator  # noqa: E402
from amss_tpu_torch.infer.streaming import BucketSpec, StreamingSeparator  # noqa: E402
from amss_tpu_torch.ops.metrics import sdr_improvement  # noqa: E402
from amss_tpu_torch.train.engine import Trainer  # noqa: E402
from amss_tpu_torch.weights import load_model_from_run  # noqa: E402

torch.set_num_threads(2)

RUN = os.path.join(REPO, "checkpoints", "c7_causal")
BUCKET = 8192
CHUNK = 4096
LOSS = "train/neg_pit_si_sdr"


@pytest.fixture(scope="module")
def served():
    """(waves, the port's and the JAX package's offline outputs through
    StreamingSeparator on two bench mixtures, one cut to 6001 samples so its
    row is padded, the JAX package's ``separate`` of each wave alone, the
    port's model).  A padded row decodes the frames that straddle its end,
    which the wave alone does not have (ROADMAP C.9): streaming, which masks
    them, is held against the wave alone."""
    mixes, _ = bench._mix_pairs(2, BUCKET)
    waves = [mixes[0][:6001], mixes[1]]
    jm, jp = j_load(RUN)
    want = JStreaming(jm, jp, buckets=JBuckets(lengths=(BUCKET,))).separate_all(waves)
    alone = [np.asarray(jm.separate(jp, jnp.asarray(w)[None]))[0] for w in waves]
    model = load_model_from_run(RUN, device="cpu")
    got = StreamingSeparator(model, buckets=BucketSpec(lengths=(BUCKET,)),
                             device="cpu").separate_all(waves)
    return waves, got, want, alone, model


def _close(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= 1e-4 * np.abs(want).max(), (err, np.abs(want).max())


def test_the_checkpoint_loads_with_its_config(served):
    cfg = served[4].cfg
    assert (cfg.kind, cfg.sep.trunk, cfg.sep.causal, cfg.sep.feature_norm) == (
        "tasnet", "tcn", True, "cumulative")
    assert (cfg.front.filter_len, cfg.front.stride, cfg.sep.expansion, cfg.sep.repeats,
            cfg.sep.compute_dtype) == (32, 16, 4, 3, "float32")
    assert served[4].tcn.blocks[0].dw.shape == (3, 512)


def test_served_offline_matches_jax(served):
    waves, got, want, _, _ = served
    for w, g, j in zip(waves, got, want):
        assert g.shape == (2, len(w))
        _close(g, j)


def test_streamed_matches_jax_offline(served):
    waves, _, _, want, model = served
    rt = RealtimeSeparator(model, chunk_samples=CHUNK, device="cpu")
    for w, j in zip(waves, want):
        _close(rt.separate_stream(w), j)
    _close(rt.separate_stream_pipelined(waves[1]), want[1])


def test_streamed_ragged_pair_and_long_stream_match_jax_offline(served):
    waves, _, _, want, model = served
    batch = np.zeros((2, BUCKET), np.float32)
    for i, w in enumerate(waves):
        batch[i, : len(w)] = w
    got = RealtimeSeparator(model, chunk_samples=CHUNK, n_streams=2, device="cpu")\
        .separate_streams(batch, lengths=[len(w) for w in waves])
    for i, (w, j) in enumerate(zip(waves, want)):
        _close(got[i, :, : len(w)], j)
    long = RealtimeSeparator(model, chunk_samples=CHUNK, long_stream=True, device="cpu")
    _close(long.separate_stream(waves[1]), want[1])


def _tiny(mod, steps=3):
    """c7 cut to a TCN of 2 x 3 blocks of bottleneck 16, batch 2 of 2048
    samples, EMA on."""
    r = mod.c7_realtime()
    return dataclasses.replace(
        r,
        train=dataclasses.replace(r.train, batch_size=2, chunk_samples=2048, steps=steps,
                                  valid_every=steps, valid_steps=1, lr=3e-3, ema_decay=0.9),
        model=dataclasses.replace(r.model, sep=dataclasses.replace(
            r.model.sep, hidden=16, blocks=3, repeats=2)),
    )


def _metrics(run_dir: str, key: str) -> dict:
    out = {}
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if key in rec:
                out[rec["step"]] = rec[key]
    return out


def test_three_c7_steps_follow_the_jax_trainer(tmp_path):
    root = tmp_path / "corpus"
    j_make_corpus(str(root), n_speakers=10, seconds_per_speaker=2.0)
    store = SpeakerStore(str(root))
    jtr = JTrainer(_tiny(jrecipes), store, workdir=str(tmp_path / "jax"))
    init = jtr.init_state()
    jinit = jax.tree_util.tree_map(np.asarray, init["params"])
    jtr.fit(state=init, log_every=1)
    tr = Trainer(_tiny(recipes), store, workdir=str(tmp_path / "port"), device="cpu")
    tr.fit(tr.state_from_tree({"params": jinit}), log_every=1)
    assert os.path.basename(tr.dir) == os.path.basename(jtr.dir)
    ours, theirs = _metrics(tr.dir, LOSS), _metrics(jtr.dir, LOSS)
    assert sorted(ours) == sorted(theirs) == [1, 2, 3]
    assert abs(ours[1] - theirs[1]) <= 1e-4 * abs(theirs[1])
    for s in (2, 3):
        assert abs(ours[s] - theirs[s]) <= 1e-3 * abs(theirs[s]), s
    v, jv = _metrics(tr.dir, "valid/loss")[3], _metrics(jtr.dir, "valid/loss")[3]
    assert abs(v - jv) <= 1e-3 * abs(jv)


def _quality():
    """(port, JAX) mean PIT SI-SDRi and the JAX package's 95% interval on the
    bench.py trained-quality protocol (64 mixtures of 16384 samples)."""
    jm, jp = j_load(RUN)
    want, band = bench._trained_quality(jm, jp, s=2)
    mixes, refs = bench._mix_pairs(64, 16384)
    sep = StreamingSeparator(load_model_from_run(RUN, device="cpu"),
                             buckets=BucketSpec(lengths=(16384,)), device="cpu")
    est = np.stack(sep.separate_all(mixes, max_batch=8))
    got = sdr_improvement(torch.from_numpy(est).double(), torch.from_numpy(np.stack(refs)).double(),
                          torch.from_numpy(np.stack(mixes)).double()).mean()
    return float(got), float(want), band


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(os.cpu_count())
    port, ref, band = _quality()
    print(f"bench.py trained-quality protocol (64 mixtures of 2 speakers, c7_causal, CPU): "
          f"port si_sdri {port:.3f} dB, JAX package {ref:.3f} dB, 95% CI {band}, n=64")
