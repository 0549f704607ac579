"""Data-parallel training of the port over gloo CPU ranks
(``train/engine.py`` with ``train.data_axis`` = 2, ``parallel/mesh.py``).

Two ranks started by ``run_ranks`` fit the tiny c1 recipe.  They hold the
JAX package's contract (``tests/test_sharding.py``, ``tests/test_multihost.py``):
the global loss of the first step equals the JAX package's on its 8 virtual
CPU devices for the same global batch and parameters (rtol 1e-5), and the
parameters are bit-identical across the ranks after the steps.  Two ranks
also equal one process fed the ranks' rows concatenated in rank order, with
the training-time draws on (dropout in a DPRNN trunk, dropped sources, mixture
noise): the loss within 1e-5 relative and every gradient within 1e-5 of the
largest gradient magnitude, since only the order of the sums differs.  The
ranks and the one process each compute on one thread, which sums in a fixed
order (``tests/torch_ranks.py`` says why).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from amss_tpu.configs import recipes as jrecipes
from amss_tpu.data.synthetic import make_synthetic_corpus as j_make_corpus
from amss_tpu.parallel.mesh import make_mesh as j_make_mesh
from amss_tpu.train.engine import make_model as j_make_model
from amss_tpu_torch.configs import recipes
from amss_tpu_torch.data.mixer import Batch
from amss_tpu_torch.data.store import SpeakerStore
from amss_tpu_torch.parallel.mesh import run_ranks
from amss_tpu_torch.train.engine import Trainer

import torch_ranks

torch.set_num_threads(2)

BATCH, CHUNK, WORLD = 8, 2048, 2
REL_TOL = 1e-5


def _tiny(mod, steps=2, data_axis=WORLD, sep=None, model=None):
    r = mod.c1_stft_dpcl()
    return dataclasses.replace(
        r,
        train=dataclasses.replace(r.train, batch_size=BATCH, chunk_samples=CHUNK, steps=steps,
                                  valid_every=steps, valid_steps=1, lr=3e-3,
                                  data_axis=data_axis),
        model=dataclasses.replace(
            r.model, **(model or {}),
            sep=dataclasses.replace(r.model.sep, hidden=16, layers=1, embed_dim=4,
                                    **(sep or {}))),
    )


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    j_make_corpus(str(root), n_speakers=10, seconds_per_speaker=2.0)
    return str(root)


def _ranks(recipe, corpus, out_dir, params_tree=None) -> list[dict]:
    run_ranks(torch_ranks.fit_rank, WORLD, "gloo",
              args=(recipe, corpus, str(out_dir), params_tree))
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(WORLD)]


def _global_batch(tr: Trainer) -> Batch:
    """Step 0's global batch: the ranks' rows concatenated in rank order."""
    parts = [tr.mixer.batch("train", 0, BATCH // WORLD, host=r) for r in range(WORLD)]
    return Batch(sources=np.concatenate([p.sources for p in parts]),
                 speaker_ids=np.concatenate([p.speaker_ids for p in parts]),
                 gains=np.concatenate([p.gains for p in parts]))


def _one_process_first_step(recipe, corpus, tmp_path, params_tree=None) -> dict:
    one = dataclasses.replace(recipe, train=dataclasses.replace(recipe.train, data_axis=1))
    tr = Trainer(one, SpeakerStore(corpus), run_dir=str(tmp_path / "one"), device="cpu")
    seen = torch_ranks.capture_first_step(tr)
    state = (tr.init_state() if params_tree is None
             else tr.state_from_tree({"params": params_tree}))
    tr.load_state(state)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tr._train_step(tr._device_batch(_global_batch(tr)))
    finally:
        torch.set_num_threads(threads)
    return seen


def _assert_first_steps_equal(ranks: list[dict], one: dict) -> None:
    for k, v in one["metrics"].items():
        for r in ranks:
            assert abs(r["first"]["metrics"][k] - v) <= REL_TOL * abs(v), (k, r, v)
    scale = max(float(g.abs().max()) for g in one["grads"].values())
    for n, g in one["grads"].items():
        for r in ranks:
            assert float((r["first"]["grads"][n] - g).abs().max()) <= REL_TOL * scale, n


def _assert_ranks_bit_identical(ranks: list[dict]) -> None:
    assert ranks[0]["step"] == ranks[1]["step"]
    for n, p in ranks[0]["params"].items():
        assert torch.equal(p, ranks[1]["params"][n]), n


def test_two_ranks_match_jax_and_one_process_and_stay_bit_identical(corpus, tmp_path):
    recipe = _tiny(recipes)
    jm = j_make_model(_tiny(jrecipes).model)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    ranks = _ranks(recipe, corpus, tmp_path, jp)

    # the global loss of the first step against the JAX package's on its 8
    # virtual devices, the batch sharded over them, on the same int16 wire batch
    tr = Trainer(dataclasses.replace(recipe, train=dataclasses.replace(recipe.train,
                                                                       data_axis=1)),
                 SpeakerStore(corpus), run_dir=str(tmp_path / "probe"), device="cpu")
    src = _global_batch(tr).sources
    q = np.clip(src * 32767.0, -32767.0, 32767.0).astype(np.int16)
    sources = q.astype(np.float32) * np.float32(1.0 / 32767.0)
    mesh = j_make_mesh(8)
    fn = jax.jit(lambda p, s: jm.loss_from_batch(p, {"sources": s})[0],
                 in_shardings=(NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))),
                 out_shardings=NamedSharding(mesh, P()))
    want = float(fn(jp, sources))
    for r in ranks:
        np.testing.assert_allclose(r["first"]["metrics"]["dpcl_loss"], want, rtol=REL_TOL)

    _assert_first_steps_equal(ranks, _one_process_first_step(recipe, corpus, tmp_path, jp))
    _assert_ranks_bit_identical(ranks)
    assert ranks[0]["step"] == recipe.train.steps
    # rank 0 alone writes the config, the metrics and the checkpoints
    assert {"config.json", "metrics.jsonl"} <= set(os.listdir(tmp_path / "rank0"))
    assert any(f.startswith("ckpt") for f in os.listdir(tmp_path / "rank0"))
    assert not os.path.exists(tmp_path / "rank1") or not os.listdir(tmp_path / "rank1")


@pytest.mark.parametrize("draws", [
    {"sep": {"trunk": "dprnn", "dropout": 0.2, "chunk_frames": 8}},
    {"model": {"train_min_speakers": 1}},
    {"model": {"train_noise_snr_db": (0.0, 10.0)}},
], ids=["dprnn_dropout", "drop_sources", "noise"])
def test_two_ranks_draw_what_one_process_draws(corpus, tmp_path, draws):
    recipe = _tiny(recipes, steps=1, **draws)
    ranks = _ranks(recipe, corpus, tmp_path)
    one = _one_process_first_step(recipe, corpus, tmp_path)
    _assert_first_steps_equal(ranks, one)
    _assert_ranks_bit_identical(ranks)


def test_a_batch_the_ranks_cannot_split_raises(corpus, tmp_path):
    store = SpeakerStore(corpus)
    r = _tiny(recipes)
    with pytest.raises(ValueError, match="not divisible by 2 ranks"):
        Trainer(dataclasses.replace(r, train=dataclasses.replace(r.train, batch_size=7)),
                store, workdir=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="accum_steps"):
        Trainer(dataclasses.replace(r, train=dataclasses.replace(r.train, batch_size=6,
                                                                 accum_steps=2)),
                store, workdir=str(tmp_path), device="cpu")
    # two ranks' recipe in a process that is not one of two ranks
    tr = Trainer(r, store, workdir=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="needs a process group"):
        tr.fit()


def test_a_torchrun_launch_trains_as_one_rank(corpus, tmp_path, monkeypatch):
    """With ``torchrun``'s environment set, ``train`` joins the group it
    names (here one gloo rank) instead of starting ranks itself."""
    from amss_tpu_torch.cli import main
    from amss_tpu_torch.parallel.mesh import free_port

    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "localhost",
                 "MASTER_PORT": str(free_port())}.items():
        monkeypatch.setenv(k, v)
    workdir = str(tmp_path / "runs")
    main(["train", "--recipe", "c1", "--hidden", "16", "--layers", "1", "--embed-dim", "4",
          "--chunk-samples", str(CHUNK), "--batch-size", "2", "--steps", "2",
          "--valid-every", "2", "--corpus", corpus, "--workdir", workdir, "--device", "cpu"])
    assert not torch.distributed.is_initialized()
    (run,) = os.listdir(workdir)
    assert "ckpt_latest.msgpack" in os.listdir(os.path.join(workdir, run))


def test_a_failed_rank_fails_the_run():
    with pytest.raises(Exception, match="rank 1 fails"):
        run_ranks(torch_ranks.fail_on_rank_1, WORLD, "gloo")
