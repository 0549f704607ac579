"""Evaluation: the resampler, BSS-Eval, STOI, ``permute_estimates``,
``bootstrap_ci``, ``evaluate_separation`` and ``write_wav``, the port against
the JAX package on the CPU.

Tolerances and why:
  * ``resample_sinc``, ``bss_eval_*``, ``stoi`` and ``bootstrap_ci``:
    bit-equal (the port's are copies of the numpy code);
  * ``permute_estimates``: equal (a reordering);
  * ``evaluate_separation`` on the same estimates: the SI-SDR columns within
    1e-4 dB (float32 sums on tensors against jnp), the BSS-Eval and STOI
    columns equal;
  * c1_dpcl end to end on 8 mixtures: each package separates, then each
    evaluates its own estimates.  k-means seeds on a tie broken by rounding
    (ROADMAP C.2): at the served 10 Lloyd iterations one of the 8 mixtures
    agrees at only 19.6 dB and the mean SI-SDR differs by 0.13 dB, so both
    run 30 iterations, where every mixture agrees at >= 64 dB; every metric
    is PIT-aligned (the speaker order does not matter), and the columns agree
    within 0.01 dB (0.001 dB seen) and STOI within 0.001 (3e-5 seen).

Run as a script to print the JAX package's reference numbers on the bench.py
protocol (64 two-speaker mixtures of 16384 samples, c1_dpcl), the gates of
chip_smoke.py's evaluation phase:
    python tests/test_torch_eval.py
"""

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
from amss_tpu.data.resample import resample_sinc as j_resample  # noqa: E402
from amss_tpu.infer import evaluate as jeval  # noqa: E402
from amss_tpu.ops import bss_eval as jbss  # noqa: E402
from amss_tpu.ops.metrics import permute_estimates as j_permute  # noqa: E402
from amss_tpu.ops.metrics import pit_si_sdr as j_pit  # noqa: E402
from amss_tpu.ops.stoi import stoi as j_stoi  # noqa: E402
from amss_tpu.train.engine import load_model_from_run as j_load  # noqa: E402
from amss_tpu_torch.data.resample import resample_sinc  # noqa: E402
from amss_tpu_torch.data.store import _read_wav  # noqa: E402
from amss_tpu_torch.infer.evaluate import bootstrap_ci, evaluate_separation, write_wav  # noqa: E402
from amss_tpu_torch.ops import bss_eval  # noqa: E402
from amss_tpu_torch.ops.metrics import permute_estimates, pit_si_sdr  # noqa: E402
from amss_tpu_torch.ops.stoi import stoi  # noqa: E402
from amss_tpu_torch.weights import load_model_from_run  # noqa: E402

torch.set_num_threads(2)

RUN = os.path.join(REPO, "checkpoints", "c1_dpcl")
T = 16384
SI_SDR_TOL_DB = 1e-4
KMEANS_ITERS = 30  # past the seeding tie of ROADMAP C.2


def _signals(seed, *shape):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(np.float32)


def _noisy_estimates(seed, b=2, s=2, t=8192):
    """(est, ref, mix): references, and estimates that are the references
    swapped in some rows, with a leak of the other source and noise."""
    ref = _signals(seed, b, s, t)
    est = 0.8 * ref + 0.2 * ref[:, ::-1] + _signals(seed + 1, b, s, t) * 0.3
    est[::2] = est[::2, ::-1]
    return est.astype(np.float32), ref, ref.sum(axis=1)


@pytest.mark.parametrize("sr_in,sr_out,n", [(16000, 8000, 5000), (8000, 10000, 4097),
                                             (44100, 8000, 9000), (8000, 8000, 100)])
def test_resample_is_the_jax_packages_bit_for_bit(sr_in, sr_out, n):
    x = _signals(0, n)
    got, want = resample_sinc(x, sr_in, sr_out), j_resample(x, sr_in, sr_out)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s", [2, 3])
def test_bss_eval_is_the_jax_packages_bit_for_bit(s):
    est, ref, _ = _noisy_estimates(1, b=2, s=s, t=4096)
    for got, want in zip(bss_eval.bss_eval_sources(ref[0], est[0]),
                         jbss.bss_eval_sources(ref[0], est[0])):
        np.testing.assert_array_equal(got, want)
    assert bss_eval.bss_eval_batch(ref, est, per_utt=True) == \
        jbss.bss_eval_batch(ref, est, per_utt=True)


def test_stoi_is_the_jax_packages_bit_for_bit():
    est, ref, mix = _noisy_estimates(2, b=1, s=2, t=8192)
    for rate in (8000, 10000, 16000):
        assert stoi(ref[0, 0], est[0, 0], rate) == j_stoi(ref[0, 0], est[0, 0], rate)
        assert stoi(ref[0, 1], mix[0], rate) == j_stoi(ref[0, 1], mix[0], rate)
    with pytest.raises(ValueError):
        stoi(ref[0, 0], est[0, 0, :-1], 8000)


@pytest.mark.parametrize("s", [2, 3])
def test_permute_estimates_matches_jax(s):
    est, ref, _ = _noisy_estimates(3, b=6, s=s, t=512)
    _, perm = pit_si_sdr(torch.from_numpy(est), torch.from_numpy(ref))
    assert len(set(perm.tolist())) > 1
    want = np.asarray(j_permute(jnp.asarray(est), jnp.asarray(perm.numpy())))
    got = permute_estimates(torch.from_numpy(est), perm).numpy()
    np.testing.assert_array_equal(got, want)


def test_bootstrap_ci_is_the_jax_packages():
    v = np.random.default_rng(4).standard_normal(40) * 2 + 7
    assert bootstrap_ci(v) == jeval.bootstrap_ci(v)
    assert bootstrap_ci(v, n_boot=500, seed=3, level=90.0) == \
        jeval.bootstrap_ci(v, n_boot=500, seed=3, level=90.0)


def _same_columns(got: dict, want: dict, si_tol: float = SI_SDR_TOL_DB) -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        if k.startswith("si_sdr"):
            if k.endswith("_ci"):
                for ck in ("mean", "ci_lo", "ci_hi", "stderr"):
                    assert abs(got[k][ck] - v[ck]) <= si_tol, (k, ck)
            elif k.endswith("_per_utt"):
                assert np.abs(np.subtract(got[k], v)).max() <= si_tol + 5e-4, k  # rounded
            else:
                assert abs(got[k] - v) <= si_tol, (k, got[k], v)
        else:
            assert got[k] == v, (k, got[k], v)


@pytest.mark.parametrize("as_tensors", [False, True])
def test_evaluate_separation_matches_jax_on_the_same_estimates(as_tensors):
    est, ref, mix = _noisy_estimates(5, b=3, s=2, t=8192)
    kw = dict(bss=True, per_utt=True, with_stoi=True)
    want = jeval.evaluate_separation(est, ref, mix, **kw)
    args = [torch.from_numpy(a) for a in (est, ref, mix)] if as_tensors else (est, ref, mix)
    got = evaluate_separation(*args, **kw)
    assert {"sdr", "sir", "sar", "sdri", "sdri_ci", "stoi", "stoi_i", "si_sdri_ci"} <= set(got)
    _same_columns(got, want)
    lean = evaluate_separation(est, ref, mix, bss=False)
    assert set(lean) == {"si_sdr", "si_sdr_mix", "si_sdri", "n"}


def test_write_wav_round_trips_through_read_wav(tmp_path):
    x = np.clip(_signals(6, 3000) * 5, -1.2, 1.2)
    path = str(tmp_path / "a" / "x.wav")
    write_wav(path, x, sample_rate=16000)
    jpath = str(tmp_path / "b" / "x.wav")
    jeval.write_wav(jpath, x, sample_rate=16000)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    y, sr = _read_wav(path)
    assert sr == 16000 and y.dtype == np.float32
    pcm = np.round(np.clip(x, -1, 1) * 32767).astype(np.int16)
    np.testing.assert_array_equal(y, pcm.astype(np.float32) / 32767.0)
    write_wav(path, y, sample_rate=16000)
    np.testing.assert_array_equal(_read_wav(path)[0], y)


@pytest.fixture(scope="module")
def c1_estimates():
    """c1_dpcl on 8 bench.py mixtures, separated by each package."""
    mixes, refs = bench._mix_pairs(8, T)
    mixes, refs = np.stack(mixes), np.stack(refs)
    jm, jp = j_load(RUN)
    sep = jax.jit(lambda p, m: jm.separate(p, m, kmeans_iters=KMEANS_ITERS))
    want = np.asarray(sep(jp, jnp.asarray(mixes)))
    model = load_model_from_run(RUN, device="cpu")
    got = model.separate(torch.from_numpy(mixes), kmeans_iters=KMEANS_ITERS)
    return got, want, refs, mixes


def test_c1_dpcl_evaluated_end_to_end_matches_jax(c1_estimates):
    got, want, refs, mixes = c1_estimates
    kw = dict(bss=True, per_utt=True, with_stoi=True)
    port = evaluate_separation(got, torch.from_numpy(refs), torch.from_numpy(mixes), **kw)
    ref = jeval.evaluate_separation(want, refs, mixes, **kw)
    assert port["n"] == ref["n"] == 8
    for k in ("si_sdr", "si_sdri", "sdr", "sir", "sar", "sdri"):
        assert abs(port[k] - ref[k]) <= 0.01, (k, port[k], ref[k])
    for k in ("stoi", "stoi_i"):
        assert abs(port[k] - ref[k]) <= 0.001, (k, port[k], ref[k])
    assert port["si_sdri"] > 3.0 and port["stoi_i"] > 0.0
    # the same estimates give the JAX package's columns
    _same_columns(evaluate_separation(want, refs, mixes, **kw), ref)


def _reference_numbers() -> dict:
    """The JAX package's evaluation of c1_dpcl on the bench.py protocol, with
    bootstrap 95% intervals of SDRi, SIR, SAR and STOIi."""
    from amss_tpu.infer.streaming import BucketSpec, StreamingSeparator

    jm, jp = j_load(RUN)
    mixes, refs = bench._mix_pairs(64, T)
    sep = StreamingSeparator(jm, jp, sample_rate=8000, buckets=BucketSpec(lengths=(T,)))
    est, refs, mixes = np.stack(sep.separate_all(mixes, max_batch=8)), np.stack(refs), \
        np.stack(mixes)
    q = jeval.evaluate_separation(est, refs, mixes, bss=True, per_utt=True, with_stoi=True)
    per = [jbss.bss_eval_sources(refs[b], est[b]) for b in range(len(est))]
    _, perm = j_pit(jnp.asarray(est), jnp.asarray(refs))
    aligned = np.asarray(j_permute(jnp.asarray(est), perm))
    stoi_i = [np.mean([j_stoi(refs[b, s], aligned[b, s], 8000)
                       - j_stoi(refs[b, s], mixes[b], 8000) for s in range(refs.shape[1])])
              for b in range(len(est))]
    return {"si_sdri": q["si_sdri_ci"], "sdri": q["sdri_ci"],
            "sir": jeval.bootstrap_ci([p[1].mean() for p in per]),
            "sar": jeval.bootstrap_ci([p[2].mean() for p in per]),
            "stoi_i": jeval.bootstrap_ci(stoi_i), "stoi": q["stoi"], "stoi_mix": q["stoi_mix"]}


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    r = _reference_numbers()
    print("c1_dpcl on the bench.py protocol (64 mixtures of 16384, the JAX package, CPU "
          "float32), mean [95% interval]:")
    for k in ("si_sdri", "sdri", "sir", "sar", "stoi_i"):
        print(f"  {k}: {r[k]['mean']:.4f} [{r[k]['ci_lo']:.4f}, {r[k]['ci_hi']:.4f}]")
    print(f"  stoi {r['stoi']:.4f}, of the mixture {r['stoi_mix']:.4f}")
