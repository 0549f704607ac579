"""The port's command line (``amss_tpu_torch/cli.py``) on the CPU: the JAX
package's dress rehearsal (``tests/test_cli_e2e.py``) with ``--device cpu``:
a 16 kHz WAV tree ingested at 8 kHz, a tiny c1 trained, evaluated,
separated (at the recipe's k and blind), profiled, exported and served from
the artifact; then ``sweep``, ``python -m amss_tpu_torch``, the several-card
flags on CPU ranks and a CPU mesh, and the recipes the flags build against
the JAX CLI's."""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from amss_tpu import cli as jcli
from amss_tpu.data.store import SpeakerStore as JStore
from amss_tpu.utils.config import recipe_to_dict as j_recipe_to_dict
from amss_tpu_torch import cli
from amss_tpu_torch.cli import main
from amss_tpu_torch.data.synthetic import synth_speaker_wave
from amss_tpu_torch.infer.evaluate import write_wav
from amss_tpu_torch.utils.config import recipe_to_dict

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--recipe", "c1", "--hidden", "16", "--layers", "1", "--embed-dim", "8",
        "--chunk-samples", "4096", "--batch-size", "4"]


@pytest.fixture(scope="module")
def wav_tree(tmp_path_factory):
    """Nine speakers, two 16 kHz utterances each."""
    root = tmp_path_factory.mktemp("wavtree")
    for s in range(9):
        w = synth_speaker_wave(s, n_samples=6 * 16000, sample_rate=16000)
        half = len(w) // 2
        for u, seg in enumerate((w[:half], w[half:])):
            write_wav(str(root / f"spk{s:02d}" / f"utt{u}.wav"), np.asarray(seg, np.float32),
                      sample_rate=16000)
    return str(root)


@pytest.fixture(scope="module")
def corpus(wav_tree, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("store") / "store")
    main(["ingest", "--wav-root", wav_tree, "--out", out, "--sample-rate", "8000",
          "--device", "cpu"])
    return out


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_dress_rehearsal(corpus, tmp_path, capsys):
    workdir = str(tmp_path / "runs")
    common = [*TINY, "--corpus", corpus, "--device", "cpu"]
    main(["train", *common, "--workdir", workdir, "--steps", "30", "--valid-every", "15"])
    out = capsys.readouterr().out
    run_dir = next(line.split("run dir: ")[1] for line in out.splitlines()
                   if line.startswith("run dir: "))
    metrics = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    assert any("valid/loss" in m for m in metrics)

    main(["evaluate", *common, "--run-dir", run_dir, "--n-mixtures", "2"])
    ev = _last_json(capsys)
    assert {"si_sdri", "sdri", "rtf"} <= set(ev) and np.isfinite(ev["si_sdri"])

    mix_wav = str(tmp_path / "mix.wav")
    a = synth_speaker_wave(101, n_samples=8000, sample_rate=8000)
    b = synth_speaker_wave(102, n_samples=8000, sample_rate=8000)
    write_wav(mix_wav, np.asarray(a + b, np.float32), sample_rate=8000)
    sep_dir = str(tmp_path / "sep")
    main(["separate", *common, "--run-dir", run_dir, "--wav", mix_wav, "--out", sep_dir])
    assert sorted(os.listdir(sep_dir)) == ["mix_spk0.wav", "mix_spk1.wav"]

    auto_dir = str(tmp_path / "sep_auto")
    main(["separate", *common, "--run-dir", run_dir, "--wav", mix_wav, "--out", auto_dir,
          "--num-speakers", "auto", "--max-speakers", "3"])
    out = capsys.readouterr().out
    est = next(json.loads(line) for line in out.splitlines()
               if line.startswith('{"estimated_speakers"'))["estimated_speakers"]
    k_hat = est[mix_wav]
    assert 1 <= k_hat <= 3
    assert sorted(os.listdir(auto_dir)) == [f"mix_spk{s}.wav" for s in range(k_hat)]

    # the EMA step and accumulation ride along, as in the JAX test
    trace_dir = str(tmp_path / "trace")
    main(["profile", *common, "--workdir", workdir, "--profile-steps", "2",
          "--accum-steps", "2", "--ema-decay", "0.9", "--trace-dir", trace_dir])
    pr = _last_json(capsys)
    assert pr["n"] == 2 and np.isfinite(pr["p50_s"])
    trace = json.load(open(os.path.join(trace_dir, "trace.json")))
    assert trace["traceEvents"]

    exp_dir = str(tmp_path / "exported")
    main(["export", *common, "--run-dir", run_dir, "--out", exp_dir, "--lengths", "8192",
          "--serve-batch", "2", "--platforms", "cpu"])
    ej = _last_json(capsys)
    assert "serving_t8192_b2.cpu.pt2" in ej["files"]
    sep2 = str(tmp_path / "sep_exp")
    main(["separate-exported", "--export-dir", exp_dir, "--wav", mix_wav, "--out", sep2,
          "--device", "cpu"])
    assert sorted(os.listdir(sep2)) == ["mix_spk0.wav", "mix_spk1.wav"]

    # the run dir is the JAX package's format: its loader reads what the port trained
    from amss_tpu.train.engine import load_model_from_run as j_load

    j_model, _ = j_load(run_dir)
    assert j_model.cfg.sep.hidden == 16


def test_module_entry_point():
    r = subprocess.run([sys.executable, "-m", "amss_tpu_torch", "--help"], capture_output=True,
                       text=True, timeout=240, cwd=REPO)
    assert r.returncode == 0, r.stderr
    for cmd in ("make-synthetic", "ingest", "train", "evaluate", "separate", "export",
                "separate-exported", "sweep", "serve", "profile"):
        assert cmd in r.stdout


def test_grid_parse_matches_jax():
    for specs in (["lr=1e-3,3e-4", "expansion=2,4"], ["trunk=tcn,dprnn"], ["causal=true,false"]):
        assert cli._parse_grid(specs) == jcli._parse_grid(specs)


@pytest.mark.parametrize("flags", [
    [],
    ["--hidden", "16", "--layers", "1", "--lr", "3e-3", "--ema-decay", "0.9"],
    ["--train-noise-snr", "5", "20", "--train-reverb-rt60", "0.1", "0.4", "--min-speakers", "1"],
    ["--device-data", "--compute-dtype", "bfloat16"],
], ids=["defaults", "widths", "corruptions", "device_data_bf16"])
def test_recipe_from_flags_matches_jax(corpus, flags):
    """The same flags build the same recipe (so the same run id) in both CLIs."""
    def parse(mod):
        p = argparse.ArgumentParser()
        p.add_argument("--recipe")
        mod._add_train_overrides(p)
        return p.parse_args(["--recipe", "c1", *flags])

    ours = cli._build_recipe(parse(cli), None)
    theirs = jcli._build_recipe(parse(jcli), JStore(corpus))
    assert recipe_to_dict(ours) == j_recipe_to_dict(theirs)


def test_several_card_flags_raise(corpus, tmp_path):
    """The name is kept from when the several-card flags raised: ``train
    --data-axis 2 --device cpu`` trains on two gloo CPU ranks, and rank 0
    alone writes the run dir's checkpoints; ``separate --mesh-devices 2``
    spreads an over-bucket utterance over two CPU entries.  What raises is a
    mesh of more cards than there are (none here)."""
    workdir = str(tmp_path / "runs")
    common = [*TINY, "--corpus", corpus, "--device", "cpu"]
    main(["train", *common, "--workdir", workdir, "--data-axis", "2", "--steps", "2",
          "--valid-every", "2"])
    (run,) = os.listdir(workdir)
    run_dir = os.path.join(workdir, run)
    ckpts = sorted(f for f in os.listdir(run_dir) if f.startswith("ckpt"))
    assert ckpts == ["ckpt_best.msgpack", "ckpt_best.msgpack.json", "ckpt_latest.msgpack",
                     "ckpt_latest.msgpack.json"], ckpts
    with open(os.path.join(run_dir, "ckpt_latest.msgpack.json")) as f:
        assert json.load(f)["step"] == 2
    steps = [json.loads(line)["step"] for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    assert steps == sorted(steps) and len(steps) == len(set(steps))  # one writer

    long_wav = str(tmp_path / "long.wav")
    n = 17 * 8000  # over the largest bucket (131072 samples): the long-form path
    a = synth_speaker_wave(201, n_samples=n, sample_rate=8000)
    b = synth_speaker_wave(202, n_samples=n, sample_rate=8000)
    write_wav(long_wav, np.asarray(a + b, np.float32), sample_rate=8000)
    sep_dir = str(tmp_path / "sep")
    main(["separate", *common, "--run-dir", run_dir, "--wav", long_wav, "--out", sep_dir,
          "--mesh-devices", "2"])
    assert sorted(os.listdir(sep_dir)) == ["long_spk0.wav", "long_spk1.wav"]

    with pytest.raises(ValueError, match="asked for 2 devices, have 0"):
        main(["train", *TINY, "--corpus", corpus, "--device", "cuda", "--workdir",
              workdir, "--data-axis", "2"])


def test_device_flag_in_any_position(monkeypatch):
    seen = {}
    monkeypatch.setattr(cli, "cmd_make_synthetic", lambda a: seen.update(device=a.device))
    main(["--device", "cpu", "make-synthetic", "--out", "x"])
    assert seen["device"] == "cpu"
    main(["make-synthetic", "--out", "x", "--device=cpu"])
    assert seen["device"] == "cpu"
    main(["make-synthetic", "--out", "x"])
    assert seen["device"] == "cuda"


def test_cli_sweep(corpus, tmp_path, capsys):
    main(["sweep", *TINY, "--corpus", corpus, "--device", "cpu", "--workdir",
          str(tmp_path / "runs"), "--steps", "20", "--valid-every", "10",
          "--grid", "lr=1e-3,3e-3", "--n-mixtures", "2"])
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()
             if line.startswith("{")]
    ranking = [line for line in lines if "ranking" in line]
    assert len(ranking) == 1 and len(ranking[0]["ranking"]) == 2
    assert sorted(r["combo"]["lr"] for r in ranking[0]["ranking"]) == [0.001, 0.003]
    assert all(np.isfinite(r["si_sdri"]) for r in ranking[0]["ranking"])


def test_make_synthetic_corpus_matches_jax(tmp_path, capsys):
    from amss_tpu.data.synthetic import make_synthetic_corpus as j_make

    main(["make-synthetic", "--out", str(tmp_path / "p"), "--speakers", "3", "--seconds", "2",
          "--device", "cpu"])
    assert "synthetic corpus: 3 speakers" in capsys.readouterr().out
    j_make(str(tmp_path / "j"), n_speakers=3, seconds_per_speaker=2.0)
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "p")) == names
    for n in names:
        if n.endswith(".npy"):
            assert np.array_equal(np.load(tmp_path / "p" / n), np.load(tmp_path / "j" / n))
