"""c6 end to end: TasNet on the committed ``checkpoints/c6_flagship`` (L16 /
stride 8, a TCN of 3 x 8 blocks at expansion 4, bf16 operands in its dense
products, two speakers) and ``checkpoints/c6_3spk`` (L32 / stride 16, float32,
three speakers), the port against the JAX package, both on the CPU, through
both packages' ``StreamingSeparator`` and long-form paths.

Tolerances and why:
  * c6_3spk (float32): 1e-4 of the output's largest magnitude (the front's
    products, 24 TCN blocks and the decode, summed in other orders);
  * c6_flagship (bf16 operands): SI-SDR of the port's output against the
    JAX package's >= 45 dB per speaker.  Where their float32 inputs differ in
    the last bits, the two packages round a product operand to bf16 on either
    side of a boundary, one bf16 step (2^-8) apart, and such flips compound
    over 24 blocks; on these mixtures the two agree to 51-61 dB;
  * a padded row of a bucket against the same utterance alone: the same
    bounds, up to sample ``nf·stride`` (the padded row's instance norm sums
    its valid frames in another order, and in bf16 that flips roundings).
    The last few samples differ in both packages: the padded row decodes the
    frames that straddle the utterance's end, which the utterance alone does
    not have (ROADMAP C.9).

Run as a script to print the quality numbers of both packages on the bench.py
protocol (64 mixtures of 16384 samples; S = 2 for the flagship, S = 3 for
c6_3spk), the source of chip_smoke.py's c6 gates:
    python tests/test_torch_c6_slice.py
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
from amss_tpu.infer import long as jlong  # noqa: E402
from amss_tpu.infer.streaming import BucketSpec as JBuckets  # noqa: E402
from amss_tpu.infer.streaming import StreamingSeparator as JStreaming  # noqa: E402
from amss_tpu.train.engine import load_model_from_run as j_load  # noqa: E402
from amss_tpu_torch.infer import long  # noqa: E402
from amss_tpu_torch.infer.streaming import BucketSpec, StreamingSeparator  # noqa: E402
from amss_tpu_torch.ops.metrics import sdr_improvement, si_sdr  # noqa: E402
from amss_tpu_torch.weights import load_model_from_run  # noqa: E402

torch.set_num_threads(2)

RUNS = {"c6_flagship": 2, "c6_3spk": 3}  # run -> speakers
BUCKET = 8192
BF16_MIN_DB = 45.0


@pytest.fixture(scope="module", params=sorted(RUNS))
def served(request):
    """(run, the port's and the JAX package's outputs on two mixtures of the
    bench protocol through StreamingSeparator, one cut to 6001 samples so its
    row is padded, and the port's model)."""
    run = request.param
    path = os.path.join(REPO, "checkpoints", run)
    mixes, _ = bench._mix_pairs(2, BUCKET, s=RUNS[run])
    waves = [mixes[0][:6001], mixes[1]]
    jm, jp = j_load(path)
    want = JStreaming(jm, jp, buckets=JBuckets(lengths=(BUCKET,))).separate_all(waves)
    model = load_model_from_run(path, device="cpu")
    sep = StreamingSeparator(model, buckets=BucketSpec(lengths=(BUCKET,)), device="cpu")
    got = sep.separate_all(waves)
    return run, waves, got, want, model, (jm, jp)


def _agree(got: np.ndarray, want: np.ndarray, run: str) -> None:
    assert got.shape == want.shape and np.isfinite(got).all()
    if run == "c6_3spk":
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    else:
        db = si_sdr(torch.tensor(got, dtype=torch.float64),
                    torch.tensor(want, dtype=torch.float64)).numpy()
        assert (db >= BF16_MIN_DB).all(), db


def test_the_checkpoints_load_with_their_configs(served):
    run, _, _, _, model, _ = served
    cfg = model.cfg
    assert (cfg.kind, cfg.sep.trunk, cfg.front.pool, cfg.nb_speakers) == ("tasnet", "tcn", 1,
                                                                         RUNS[run])
    want = {"c6_flagship": (16, 8, "bfloat16"), "c6_3spk": (32, 16, "float32")}[run]
    assert (cfg.front.filter_len, cfg.front.stride, cfg.sep.compute_dtype) == want


def test_served_waveforms_match_jax(served):
    run, waves, got, want, _, _ = served
    for w, g, j in zip(waves, got, want):
        assert g.shape == (RUNS[run], len(w))
        _agree(g, j, run)


def test_a_padded_row_gives_the_unpadded_result(served):
    run, waves, got, _, model, _ = served
    alone = model.separate(torch.from_numpy(waves[0][None].copy()))[0].numpy()
    nf = model.cfg.front.frames_for(len(waves[0]))
    valid = nf * model.cfg.front.stride
    assert len(waves[0]) - valid < model.cfg.front.filter_len
    _agree(got[0][:, :valid], alone[:, :valid], run)


def test_separate_long_matches_the_jax_long_path(served):
    run, _, _, _, model, (jm, jp) = served
    mixes, _ = bench._mix_pairs(1, 6000, seed0=9500, s=RUNS[run])
    chunk = 4096
    assert len(long.chunk_layout(6000, chunk)[1]) == 2
    want = jlong.separate_long(jm, jp, mixes[0], chunk=chunk, overlap=long.OVERLAP)
    got = long.separate_long(model, mixes[0], chunk=chunk)
    _agree(got, np.asarray(want), run)


def _quality(run: str):
    """(port, JAX) mean PIT SI-SDRi and the JAX package's 95% interval on the
    bench.py trained-quality protocol (64 mixtures of 16384 samples)."""
    path = os.path.join(REPO, "checkpoints", run)
    s = RUNS[run]
    jm, jp = j_load(path)
    want, band = bench._trained_quality(jm, jp, s=s)
    mixes, refs = bench._mix_pairs(64, 16384, s=s)
    sep = StreamingSeparator(load_model_from_run(path, device="cpu"),
                             buckets=BucketSpec(lengths=(16384,)), device="cpu")
    est = np.stack(sep.separate_all(mixes, max_batch=8))
    got = sdr_improvement(torch.from_numpy(est).double(), torch.from_numpy(np.stack(refs)).double(),
                          torch.from_numpy(np.stack(mixes)).double()).mean()
    return float(got), float(want), band


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(os.cpu_count())
    for run, s in RUNS.items():
        port, ref, band = _quality(run)
        print(f"bench.py trained-quality protocol (64 mixtures of {s} speakers, {run}, CPU): "
              f"port si_sdri {port:.3f} dB, JAX package {ref:.3f} dB, 95% CI {band}, n=64")
