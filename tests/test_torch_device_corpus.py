"""The corpus resident on the device (``amss_tpu_torch/data/device_corpus.py``)
and the ``Trainer``'s plan mode (``train.device_data``), against the JAX
package (``amss_tpu/data/device_corpus.py``, its ``Trainer``), on the CPU
(``device="cpu"``).

Tolerances and why:
  * the flat int16 corpus and ``gather``: bit for bit the JAX package's (the
    same quantization, tiling, offsets and float32 products);
  * ``gather`` against the host ``Mixer.batch``: one LSB times the gain, the
    reference test's bound (``tests/test_device_corpus.py``): the device path
    rounds the unscaled waveform to int16, the host's wire format truncates
    ``gain · chunk``;
  * the first valid loss of a device-data c1 against a host-data one: 1e-3,
    the reference test's bound (the int16 difference above);
  * the first step against the JAX ``Trainer`` with device data: 1e-4
    relative, as ``tests/test_torch_train.py`` holds the host-data step.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amss_tpu.configs import recipes as jrecipes
from amss_tpu.data.device_corpus import DeviceCorpus as JDeviceCorpus
from amss_tpu.data.synthetic import make_synthetic_corpus as j_make_corpus
from amss_tpu.train.engine import Trainer as JTrainer
from amss_tpu_torch.cli import main
from amss_tpu_torch.configs import recipes
from amss_tpu_torch.data.device_corpus import DeviceCorpus
from amss_tpu_torch.data.mixer import Mixer, Plan
from amss_tpu_torch.data.native import _chunk_wrap
from amss_tpu_torch.data.store import SpeakerStore
from amss_tpu_torch.train.engine import Trainer
from amss_tpu_torch.utils.config import recipe_from_dict

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 2048


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    j_make_corpus(str(root), n_speakers=8, seconds_per_speaker=3.0)
    return SpeakerStore(str(root))


@pytest.fixture(scope="module")
def corpora(store):
    return DeviceCorpus(store, T, device="cpu"), JDeviceCorpus(store, T)


def _t(plan: Plan):
    return (torch.from_numpy(plan.speaker_ids), torch.from_numpy(plan.starts),
            torch.from_numpy(plan.gains))


def test_the_flat_corpus_is_the_jax_packages(corpora, store):
    ours, theirs = corpora
    assert ours.row == theirs.row == 24000 + T
    assert ours.flat.dtype == torch.int16 and ours.flat.device.type == "cpu"
    np.testing.assert_array_equal(ours.flat.numpy(), np.asarray(theirs.flat))
    assert ours.nbytes == 2 * len(store.speakers) * ours.row


@pytest.mark.parametrize("split,step", [("train", 0), ("train", 7), ("valid", 2)])
def test_gather_is_the_jax_packages_bit_for_bit(corpora, store, split, step):
    ours, theirs = corpora
    plan = Mixer(store, nb_speakers=2, chunk_samples=T, seed=3).plan(split, step, 4)
    got = ours.gather(*_t(plan))
    want = np.asarray(theirs.gather(jnp.asarray(plan.speaker_ids), jnp.asarray(plan.starts),
                                    jnp.asarray(plan.gains)))
    assert got.shape == (4, 2, T) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_a_start_near_the_end_of_a_shard_wraps(corpora, store):
    ours, theirs = corpora
    w = np.asarray(store.waveform(store.speakers[0]), np.float32)
    start = len(w) - 100
    args = (np.array([[0]], np.int32), np.array([[start]], np.int32),
            np.array([[1.0]], np.float32))
    got = ours.gather(*map(torch.from_numpy, args))[0, 0].numpy()
    q = np.clip(np.round(w * 32767.0), -32767, 32767) / 32767.0
    np.testing.assert_allclose(got, _chunk_wrap(q.astype(np.float32), start, T), atol=1e-6)
    np.testing.assert_array_equal(got, np.asarray(theirs.gather(*map(jnp.asarray, args)))[0, 0])


def test_gather_against_the_host_batch_within_one_lsb_times_the_gain(corpora, store):
    ours, _ = corpora
    mixer = Mixer(store, nb_speakers=2, chunk_samples=T, seed=3)
    for step in (0, 7):
        plan, host = mixer.plan("train", step, 4), mixer.batch("train", step, 4)
        np.testing.assert_array_equal(plan.speaker_ids, host.speaker_ids)
        atol = float(plan.gains.max()) / 32767.0 + 1e-6
        np.testing.assert_allclose(ours.gather(*_t(plan)).numpy(), host.sources, atol=atol)


def _tiny(mod, device_data, steps=1, **train):
    r = mod.c1_stft_dpcl()
    return dataclasses.replace(
        r,
        model=dataclasses.replace(
            r.model, sep=dataclasses.replace(r.model.sep, hidden=16, layers=1, embed_dim=4)),
        train=dataclasses.replace(r.train, batch_size=2, chunk_samples=T, steps=steps,
                                  valid_every=steps, valid_steps=1, device_data=device_data,
                                  **train))


def test_device_data_and_host_data_give_the_same_first_valid_loss(store, tmp_path):
    losses = {}
    for device_data in (False, True):
        tr = Trainer(_tiny(recipes, device_data), store, workdir=str(tmp_path), device="cpu")
        assert (tr.corpus is not None) == device_data
        tr.load_state(tr.init_state())
        losses[device_data] = tr.valid_loss()
    assert abs(losses[True] - losses[False]) < 1e-3, losses


def test_a_plan_ships_its_three_arrays_and_the_step_gathers(store, tmp_path):
    tr = Trainer(_tiny(recipes, True), store, workdir=str(tmp_path), device="cpu")
    plan = tr._draw("train", 0, 2)
    assert isinstance(plan, Plan)
    arrays = tr._host_arrays(plan)
    assert sorted(arrays) == ["plan_gains", "plan_ids", "plan_starts"]
    assert sum(a.nbytes for a in arrays.values()) == 2 * 2 * 12
    batch = tr.prep(tr._device_batch(plan))
    torch.testing.assert_close(batch["sources"], tr.corpus.gather(*_t(plan)), rtol=0, atol=0)
    assert torch.equal(batch["speaker_ids"], torch.from_numpy(plan.speaker_ids))
    # a host batch still takes the int16 wire format in the same trainer
    host = tr.prep(tr._device_batch(tr.mixer.batch("train", 0, 2)))
    assert sorted(host) == ["sources"]


def _metrics(run_dir: str, key: str) -> dict:
    out = {}
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if key in rec:
                out[rec["step"]] = rec[key]
    return out


def test_the_first_step_follows_the_jax_trainer_with_device_data(store, tmp_path):
    jtr = JTrainer(_tiny(jrecipes, True, steps=2, lr=3e-3), store,
                   workdir=str(tmp_path / "jax"))
    init = jtr.init_state()
    jinit = jax.tree_util.tree_map(np.asarray, init["params"])
    jtr.fit(state=init, log_every=1)
    tr = Trainer(_tiny(recipes, True, steps=2, lr=3e-3), store, workdir=str(tmp_path / "port"),
                 device="cpu")
    tr.fit(tr.state_from_tree({"params": jinit}), log_every=1)
    ours, theirs = _metrics(tr.dir, "train/dpcl_loss"), _metrics(jtr.dir, "train/dpcl_loss")
    assert sorted(ours) == sorted(theirs) == [1, 2]
    assert abs(ours[1] - theirs[1]) <= 1e-4 * abs(theirs[1])
    assert abs(ours[2] - theirs[2]) <= 1e-3 * abs(theirs[2])
    v, jv = _metrics(tr.dir, "valid/loss")[2], _metrics(jtr.dir, "valid/loss")[2]
    assert abs(v - jv) <= 1e-3 * abs(jv)


def test_c6_flagships_config_trains_with_device_data_at_reduced_width(store, tmp_path):
    """``checkpoints/c6_flagship/config.json`` (device data, bf16 TCN, EMA,
    steps_per_call 20) cut to a width and a batch the CPU runs in seconds."""
    with open(os.path.join(REPO, "checkpoints", "c6_flagship", "config.json")) as f:
        r = recipe_from_dict(json.load(f))
    assert r.train.device_data and r.train.steps_per_call == 20
    assert r.model.sep.compute_dtype == "bfloat16"
    r = dataclasses.replace(
        r,
        model=dataclasses.replace(r.model, sep=dataclasses.replace(
            r.model.sep, hidden=8, blocks=2, repeats=1)),
        train=dataclasses.replace(r.train, batch_size=2, chunk_samples=T, steps=3,
                                  valid_every=3, valid_steps=1))
    tr = Trainer(r, store, workdir=str(tmp_path), device="cpu")
    assert tr.corpus is not None and tr.ema is None
    final = tr.fit(log_every=1)
    assert final["step"] == 3 and "ema_params" in final
    losses = _metrics(tr.dir, "train/neg_pit_si_sdr")
    assert sorted(losses) == [1, 2, 3] and all(np.isfinite(list(losses.values())))
    assert np.isfinite(_metrics(tr.dir, "valid/loss")[3])


def test_the_cli_trains_with_device_data(store, tmp_path):
    main(["train", "--recipe", "c1", "--hidden", "16", "--layers", "1", "--embed-dim", "4",
          "--chunk-samples", str(T), "--batch-size", "2", "--steps", "2", "--valid-every", "2",
          "--device-data", "--corpus", store.root, "--workdir", str(tmp_path), "--device", "cpu"])
    (run,) = os.listdir(tmp_path)
    with open(os.path.join(tmp_path, run, "config.json")) as f:
        assert json.load(f)["train"]["device_data"] is True
    assert sorted(_metrics(os.path.join(tmp_path, run), "valid/loss")) == [2]


def test_the_corpus_goes_to_the_card_unless_told_otherwise(store, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceCorpus(store, T)
