"""Several devices in one process (``amss_tpu_torch/parallel``,
``infer/long.py::separate_long_sharded``, ``StreamingSeparator(mesh=...)``)
and the exported bf16 BLSTM (``ops/blstm_bf16.py``), on the CPU, against the
port's one-device paths and the JAX package's.

Meshes here are lists of ``"cpu"`` entries; the JAX package's side runs on the
conftest's 8 virtual CPU devices.  Tolerances and why:
  * the time-sharded STFT: 1e-4, ``tests/test_timeshard.py``'s bound, against
    the port's unsharded STFT and the JAX package's sharded one;
  * sharded long-form TasNet against the port's ``separate_long``: 0 where
    each device's slice has the batch shape of ``separate_long``'s groups
    (the same batches, one stitcher), as the JAX package's test holds its
    own to 1e-6; against the JAX package's ``separate_long_sharded``: 1e-4,
    the bound of ``tests/test_torch_tasnet.py`` between the two packages'
    TasNets;
  * a clustering model through the sharded path: finite, of the right shape,
    its first chunk equal to ``separate`` on it (later chunks may differ by a
    k-means tie, ROADMAP C.2);
  * the exported bf16 c1 against the live bf16 model: 0 (one loop, one order
    of sums); against the JAX package's bf16 ``separate``: 40 dB SI-SDR in the
    best speaker order, ``tests/test_torch_blstm_bf16.py``'s serving bound.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
from amss_tpu.configs import recipes as jrecipes  # noqa: E402
from amss_tpu.infer import long as jlong  # noqa: E402
from amss_tpu.models.dpcl import DPCLModel as JDPCL  # noqa: E402
from amss_tpu.parallel.mesh import make_mesh as j_make_mesh  # noqa: E402
from amss_tpu.parallel.timeshard import sharded_stft_ri as j_sharded_stft_ri  # noqa: E402
from amss_tpu.train.engine import load_model_from_run as j_load  # noqa: E402
from amss_tpu.train.engine import make_model as j_make_model  # noqa: E402
from amss_tpu_torch.configs import recipes  # noqa: E402
from amss_tpu_torch.infer import long  # noqa: E402
from amss_tpu_torch.infer.export import ServingArtifact, export_serving  # noqa: E402
from amss_tpu_torch.infer.streaming import BucketSpec, StreamingSeparator  # noqa: E402
from amss_tpu_torch.ops.metrics import si_sdr  # noqa: E402
from amss_tpu_torch.ops.stft import stft_ri  # noqa: E402
from amss_tpu_torch.parallel.mesh import init_data_parallel, make_mesh  # noqa: E402
from amss_tpu_torch.parallel.timeshard import sharded_stft_ri  # noqa: E402
from amss_tpu_torch.train.engine import make_model  # noqa: E402
from amss_tpu_torch.weights import load_model_from_run, named_from_jax  # noqa: E402

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8
RUN = os.path.join(REPO, "checkpoints", "c1_dpcl")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(mod_j, recipe_j, recipe_t, **sep):
    """The JAX model and params from PRNGKey(0), and the port's model on
    the CPU with the same parameters."""
    cfg = dataclasses.replace(recipe_j.model, sep=dataclasses.replace(recipe_j.model.sep, **sep))
    jm = j_make_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(recipe_t.model, sep=dataclasses.replace(recipe_t.model.sep, **sep))
    tm = make_model(tcfg)
    tm.load_state_dict(named_from_jax(_np(jp)), strict=False)
    return jm, jp, tm.eval()


@pytest.fixture(scope="module")
def tasnet():
    return _pair(None, jrecipes.c6_tasnet(), recipes.c6_tasnet(), hidden=32, blocks=2,
                 repeats=1, embed_dim=4)


@pytest.fixture(scope="module")
def dpcl():
    return _pair(None, jrecipes.c1_stft_dpcl(), recipes.c1_stft_dpcl(), hidden=16, layers=1,
                 embed_dim=4)


def test_a_mesh_is_an_explicit_list_and_never_shrinks():
    assert make_mesh(devices=["cpu", "cpu"]) == [torch.device("cpu")] * 2
    assert make_mesh(2, devices=["cpu"] * 3) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="asked for 3 devices, have 2"):
        make_mesh(3, devices=["cpu", "cpu"])
    # no card here: a mesh of cards cannot be made, and none falls back to the CPU
    with pytest.raises(ValueError, match="asked for 1 devices, have 0"):
        make_mesh(1)
    with pytest.raises(ValueError, match="at least one device"):
        make_mesh()
    with pytest.raises(ValueError, match="backend"):
        init_data_parallel("mpi", 0, 1, "tcp://localhost:1")
    with pytest.raises(ValueError, match="nccl needs the rank's card"):
        init_data_parallel("nccl", 0, 1, "tcp://localhost:1", device="cpu")


def test_a_rank_key_draws_its_rows_of_the_global_draw():
    """``DropoutKey.shard``: a rank's draws are the global batch's draws at
    its rows, whatever is folded behind the batch axis, in its children too."""
    from amss_tpu_torch.models.dprnn import DropoutKey

    key = DropoutKey(7).fold_in(3)
    for fold in (1, 5):  # rows alone, and chunks folded into the batch
        whole = key.split(2)[1].rand((8 * fold, 3))
        parts = [key.shard(r * 4, 4, 8).split(2)[1].rand((4 * fold, 3)) for r in range(2)]
        assert torch.equal(torch.cat(parts), whole)
    assert torch.equal(torch.cat([key.shard(r, 1, 4).fold_in(9).randint(1, 4, (1,))
                                  for r in range(4)]), key.fold_in(9).randint(1, 4, (4,)))
    assert torch.equal(torch.cat([key.shard(r * 2, 2, 4).randn((2, 5)) for r in range(2)]),
                       key.randn((4, 5)))
    with pytest.raises(ValueError, match="a shard of 4 rows"):
        key.shard(0, 4, 8).rand((6, 3))
    with pytest.raises(ValueError, match="outside a batch"):
        key.shard(6, 4, 8)


def test_sharded_stft_matches_unsharded_and_jax():
    win, hop = 256, 64
    x = np.random.default_rng(0).standard_normal((2, 8 * hop * 32)).astype(np.float32)
    re_s, im_s = sharded_stft_ri(torch.from_numpy(x), win, hop, make_mesh(devices=CPU8))
    re_r, im_r = stft_ri(torch.from_numpy(x), win, hop)
    assert re_s.shape == re_r.shape == (2, (x.shape[1] - win) // hop + 1, win // 2 + 1)
    np.testing.assert_allclose(re_s.numpy(), re_r.numpy(), atol=1e-4)
    np.testing.assert_allclose(im_s.numpy(), im_r.numpy(), atol=1e-4)
    re_j, im_j = j_sharded_stft_ri(jnp.asarray(x), win, hop,
                                   Mesh(np.array(jax.devices()[:8]), ("time",)))
    np.testing.assert_allclose(re_s.numpy(), np.asarray(re_j), atol=1e-4)
    np.testing.assert_allclose(im_s.numpy(), np.asarray(im_j), atol=1e-4)


def test_sharded_stft_refuses_what_the_jax_package_refuses():
    x = torch.zeros(1, 8 * 64 * 4 + 64)
    with pytest.raises(ValueError, match="T % \\(P\\*hop\\)"):
        sharded_stft_ri(x, 256, 64, CPU8)
    with pytest.raises(ValueError, match="win % hop"):
        sharded_stft_ri(torch.zeros(1, 8 * 96 * 4), 256, 96, CPU8)
    with pytest.raises(ValueError, match="shorter than the halo"):
        sharded_stft_ri(torch.zeros(1, 8 * 64), 256, 64, CPU8)


def test_long_sharded_tasnet_matches_jax(tasnet):
    """8 entries x 1 chunk a group, and a zero-padded second group (11
    chunks at chunk 4096, hop 3584), as the JAX package's test."""
    jm, jp, tm = tasnet
    t = 40000
    mix = np.random.default_rng(0).standard_normal(t).astype(np.float32)
    got = long.separate_long_sharded(tm, mix, chunk=4096, mesh=CPU8, overlap=512,
                                     chunk_batch_per_device=1)
    assert got.shape == (2, t)
    want = jlong.separate_long_sharded(jm, jp, mix, mesh=j_make_mesh(8), chunk=4096,
                                       overlap=512, chunk_batch_per_device=1)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_long_sharded_tasnet_equals_one_device_at_its_group_shapes(tasnet):
    """16 chunks: ``separate_long`` runs two groups of 8, and a mesh of two
    entries with 8 chunks each runs the same two batches, so the result is
    the same to the bit.  (At other slice widths the CPU's convolutions
    round by the batch's shape: 8e-6 on outputs of magnitude 11 was seen at
    1 chunk a slice.)"""
    _, _, tm = tasnet
    t = 16 * 3584 + 512
    mix = np.random.default_rng(3).standard_normal(t).astype(np.float32)
    ref = long.separate_long(tm, mix, chunk=4096, overlap=512)
    got = long.separate_long_sharded(tm, mix, chunk=4096, mesh=["cpu"] * 2, overlap=512,
                                     chunk_batch_per_device=8)
    np.testing.assert_array_equal(got, ref)


def test_long_sharded_clustering_is_valid(dpcl):
    _, _, tm = dpcl
    t = 20000
    mix = np.random.default_rng(1).standard_normal(t).astype(np.float32)
    got = long.separate_long_sharded(tm, mix, chunk=8192, mesh=CPU8, overlap=1024,
                                     chunk_batch_per_device=1)
    assert got.shape == (2, t) and np.isfinite(got).all()
    # the first chunk alone, up to the first overlap, is separate on it
    first = tm.separate(torch.from_numpy(mix[None, :8192]))[0].numpy()
    np.testing.assert_array_equal(got[:, :8192 - 2048], first[:, :8192 - 2048])
    # an utterance no longer than a chunk is one separate call on mesh[0]
    short = long.separate_long_sharded(tm, mix[:5000], chunk=8192, mesh=CPU8)
    np.testing.assert_array_equal(short, tm.separate(torch.from_numpy(mix[None, :5000]))[0])


def test_streaming_separator_spreads_over_bucket_utterances_over_its_mesh(tasnet):
    _, _, tm = tasnet
    rng = np.random.default_rng(2)
    waves = [rng.standard_normal(n).astype(np.float32) for n in (3000, 30000, 4000)]
    buckets = BucketSpec(lengths=(4096, 8192))
    plain = StreamingSeparator(tm, buckets=buckets, device="cpu").separate_all(waves)
    sharded = StreamingSeparator(tm, buckets=buckets, device="cpu",
                                 mesh=["cpu"] * 2).separate_all(waves)
    for a, b, w in zip(sharded, plain, waves):  # one slice of 8 is separate_long's group
        assert a.shape == (2, len(w))
        np.testing.assert_array_equal(a, b)


def _bf16(cfg):
    return dataclasses.replace(cfg, sep=dataclasses.replace(cfg.sep, compute_dtype="bfloat16"))


def test_the_exported_bf16_c1_equals_live_and_jax(tmp_path):
    """checkpoints/c1_dpcl in bf16, exported for the CPU: one operator a
    BLSTM layer, the live bf16 model's output exactly, and the JAX package's
    bf16 separate within the serving bound."""
    model = load_model_from_run(RUN, device="cpu")
    model.cfg = _bf16(model.cfg)
    mixes = np.stack(bench._mix_pairs(2, 16384)[0])
    kw = {"kmeans_iters": 30}
    export_serving(model, str(tmp_path), lengths=(16384,), batch=2, platforms=("cpu",),
                   separate_kwargs=kw)
    art = ServingArtifact(str(tmp_path), device="cpu")
    got = np.stack(art.separate_all(list(mixes)))
    live = np.stack(StreamingSeparator(model, buckets=BucketSpec(lengths=(16384,)),
                                       separate_kwargs=kw, device="cpu").separate_all(list(mixes)))
    np.testing.assert_array_equal(got, live)
    jm, jp = j_load(RUN)
    want = np.asarray(JDPCL(_bf16(jm.cfg)).separate(jp, jnp.asarray(mixes), kmeans_iters=30))
    e, r = torch.tensor(got, dtype=torch.float64), torch.tensor(want, dtype=torch.float64)
    agree = torch.maximum(si_sdr(e, r).mean(-1), si_sdr(e.flip(1), r).mean(-1)).numpy()
    assert (agree >= 40.0).all(), agree
    ep = torch.export.load(str(tmp_path / "serving_t16384_b2.cpu.pt2"))
    ops = [n for n in ep.graph.nodes if "blstm_bf16_layer" in str(n.target)]
    assert len(ops) == model.blstm.layers
