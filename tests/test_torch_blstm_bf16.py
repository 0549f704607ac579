"""The BLSTM in bfloat16 (``amss_tpu_torch/models/blstm.py::BLSTM.loop_bf16``)
and the models that run it (the blstm and dprnn trunks, the enh refiner)
against the JAX package's ``blstm_stack(compute_dtype=bf16)``
(``_bilstm_fused_scan``), both on the CPU, on the same parameters and inputs.

Tolerances and why:
  * the stack's output: 1e-3 of its peak, inside the 2e-2 that
    ``tests/test_torch_tcn.py`` gives bf16 operands.  Both packages round the
    same float32 values to bf16 and sum exact bf16 products in float32, so
    they differ only where a sum order flips a rounding (2e-7 of the peak
    seen); float32 is 3.7e-3 to 3.9e-3 of the peak away, outside the bound,
    so the bound shows that bf16 took effect;
  * every gradient of one loss against ``jax.grad``: one bf16 step, 2^-8 of
    the tensor's largest magnitude, as ``test_torch_tcn.py`` holds a bf16
    ``dense``: each package rounds the same float32 product to bf16, and a
    sum order may flip its last bit (3e-4 seen; the recurrent weights' sums
    over the steps, which both take in bf16, agree exactly);
  * the models: c1's unit-norm embeddings 2e-3 from the same features
    (1.1e-3 seen over a 2x300 stack and 253 frames; float32 is 4.3e-3 away),
    its separation >= 40 dB SI-SDR from the JAX package's after 30 Lloyd
    iterations; the DPRNN stack, c6 with it and the enh refiner's masks 1e-3
    of the peak; each loss 1e-4 relative;
  * a model's gradients through its loss: each tensor's within 1e-2 of its
    norm (3.7e-3 seen on a tiny c1).  The losses' float32 sums run in other
    orders in the two packages, so the cotangents reaching the bf16 products
    differ in their last bits and flip gradient roundings to bf16, a step of
    2^-8 at each flipped element; ROADMAP C.10 measures c6's the same way;
  * a model with a bf16 BLSTM exports, one operator a layer, and c1's
    artifact returns the live bf16 output exactly.

Run as a script to print the JAX package's SI-SDRi of checkpoints/c1_dpcl
served in bf16 on the quality protocol, with its 95% interval, which
``chip_smoke.py`` phase 31 is gated on:
    python tests/test_torch_blstm_bf16.py
"""

import dataclasses
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
from amss_tpu.models import dprnn as jdprnn  # noqa: E402
from amss_tpu.models.blstm import blstm_stack, init_blstm_stack  # noqa: E402
from amss_tpu.models.dpcl import DPCLModel as JDPCL  # noqa: E402
from amss_tpu.train.engine import load_model_from_run as j_load  # noqa: E402
from amss_tpu.train.engine import make_model as j_make_model  # noqa: E402
from amss_tpu_torch.configs import recipes  # noqa: E402
from amss_tpu_torch.infer.export import ServingArtifact, export_serving  # noqa: E402
from amss_tpu_torch.infer.streaming import BucketSpec, StreamingSeparator  # noqa: E402
from amss_tpu_torch.models import dprnn  # noqa: E402
from amss_tpu_torch.models.base import SeparatorBase  # noqa: E402
from amss_tpu_torch.models.blstm import BLSTM  # noqa: E402
from amss_tpu_torch.ops.metrics import si_sdr  # noqa: E402
from amss_tpu_torch.train.engine import make_model  # noqa: E402
from amss_tpu_torch.utils.config import (  # noqa: E402
    FrontConfig,
    ModelConfig,
    SeparatorConfig,
)
from amss_tpu_torch.weights import (  # noqa: E402
    load_model_from_run,
    lstm_state,
    named_from_jax,
    params_from_jax,
)

torch.set_num_threads(2)

RUN = os.path.join(REPO, "checkpoints", "c1_dpcl")
N_IN, HIDDEN, T = 37, 24, 13
OUT_TOL = 1e-3  # of the peak
BF16_STEP = 2.0**-8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _port_cfg(jcfg) -> ModelConfig:
    d = dataclasses.asdict(jcfg)
    return ModelConfig(front=FrontConfig(**d.pop("front")), sep=SeparatorConfig(**d.pop("sep")),
                       **d)


def _bf16(cfg):
    return dataclasses.replace(cfg, sep=dataclasses.replace(cfg.sep, compute_dtype="bfloat16"))


@pytest.fixture(scope="module", params=[1, 2], ids=["1-layer", "2-layer"])
def stack(request):
    layers = _np(init_blstm_stack(jax.random.PRNGKey(request.param), N_IN, HIDDEN,
                                  request.param))
    m = BLSTM(N_IN, HIDDEN, request.param)
    m.lstm.load_state_dict(lstm_state(layers))
    return layers, m


def _masks():
    prefix = np.ones((3, T), np.float32)
    prefix[1, 7:] = 0.0
    prefix[2, :] = 0.0
    other = (np.random.default_rng(2).random((3, T)) > 0.3).astype(np.float32)
    return {"none": None, "prefix": prefix, "not_a_prefix": other}


@pytest.mark.parametrize("mask", ["none", "prefix", "not_a_prefix"])
def test_the_stack_matches_jax_and_is_not_float32(stack, mask):
    layers, m = stack
    x = _x((3, T, N_IN))
    mk = _masks()[mask]
    jm = None if mk is None else jnp.asarray(mk)
    want = np.asarray(blstm_stack(layers, jnp.asarray(x), mask=jm, compute_dtype=jnp.bfloat16))
    with torch.no_grad():
        tm = None if mk is None else torch.from_numpy(mk)
        got = m(torch.from_numpy(x), tm, compute_dtype=torch.bfloat16).numpy()
        f32 = m(torch.from_numpy(x), tm).numpy()
    scale = np.abs(want).max()
    assert got.shape == want.shape == (3, T, 2 * HIDDEN)
    assert np.abs(got - want).max() <= OUT_TOL * scale
    assert np.abs(f32 - want).max() > OUT_TOL * scale
    if mk is not None:  # masked steps output 0
        assert not got[np.broadcast_to(mk[..., None] == 0, got.shape)].any()


class _Masks:
    """A key whose children hand out given keep masks, one a layer."""

    def __init__(self, masks):
        self.masks = masks

    def split(self, n):
        assert n == len(self.masks)
        return [_Mask(m) for m in self.masks]


class _Mask:
    def __init__(self, m):
        self.m = m

    def keep_mask(self, shape, keep, device):
        assert tuple(shape) == self.m.shape
        return torch.from_numpy(self.m)


def test_dropout_matches_jax_given_its_masks(stack):
    layers, m = stack
    rate, key = 0.3, jax.random.PRNGKey(5)
    x = _x((3, T, N_IN), seed=3)
    mk = _masks()["prefix"]
    want = np.asarray(blstm_stack(layers, jnp.asarray(x), mask=jnp.asarray(mk),
                                  compute_dtype=jnp.bfloat16, dropout_rate=rate, rng=key))
    keeps = [np.array(jax.random.bernoulli(k, 1.0 - rate, (3, T, 2 * HIDDEN)))
             for k in jax.random.split(key, len(layers))]
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(mk), dropout_rate=rate,
                rng=_Masks(keeps), compute_dtype=torch.bfloat16).numpy()
    assert np.abs(got - want).max() <= OUT_TOL * np.abs(want).max()


def test_every_gradient_matches_jax_grad(stack):
    layers, m = stack
    x = _x((3, T, N_IN), seed=4)
    mk = _masks()["prefix"]
    cot = _x((3, T, 2 * HIDDEN), seed=5)

    def f(p, x):
        y = blstm_stack(p, x, mask=jnp.asarray(mk), compute_dtype=jnp.bfloat16)
        return jnp.sum(y * cot)

    jgp, jgx = jax.grad(f, argnums=(0, 1))(layers, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    m.zero_grad()
    y = m(xt, torch.from_numpy(mk), compute_dtype=torch.bfloat16)
    (y * torch.from_numpy(cot)).sum().backward()
    jgx = np.asarray(jgx)
    assert np.abs(xt.grad.numpy() - jgx).max() <= BF16_STEP * np.abs(jgx).max()
    want = lstm_state(_np(jgp))
    for n, p in m.lstm.named_parameters():
        if not p.requires_grad:  # bias_hh: 0, frozen
            continue
        w = want[n].numpy()
        assert np.abs(p.grad.numpy() - w).max() <= BF16_STEP * np.abs(w).max(), n


def test_every_trunk_and_the_refiner_build_in_bf16():
    for trunk in ("blstm", "dprnn"):
        cfg = _bf16(ModelConfig(sep=SeparatorConfig(hidden=8, layers=1, trunk=trunk,
                                                    chunk_frames=4)))
        assert SeparatorBase(cfg).compute_dtype == torch.bfloat16
    r = recipes.enh_dpcl(RUN)
    enh = make_model(_bf16(r.model), r.base_run, "cpu")
    assert enh.compute_dtype == torch.bfloat16 and enh.base.compute_dtype == torch.float32


@pytest.fixture(scope="module")
def c1():
    """checkpoints/c1_dpcl served in bf16 by both packages, and two mixtures."""
    jm, jp = j_load(RUN)
    jm = JDPCL(_bf16(jm.cfg))
    model = load_model_from_run(RUN, device="cpu")
    model.cfg = _bf16(model.cfg)
    mix, _ = bench._mix_pairs(2, 16384)
    return jm, jp, model, np.stack(mix)


def test_c1_embeddings_in_bf16_match_jax(c1):
    jm, jp, model, mixes = c1
    codes, _ = jm.front.encode(jp["front"], jnp.asarray(mixes))
    feats = np.array(jm.front.features(jp["front"], codes))
    mask = np.ones(feats.shape[:2], np.float32)
    mask[1, 150:] = 0.0
    want = np.asarray(jm.embed(jp, jnp.asarray(feats), jnp.asarray(mask)))
    with torch.no_grad():
        got = model.embed(torch.from_numpy(feats), torch.from_numpy(mask)).numpy()
        model.cfg = dataclasses.replace(model.cfg, sep=dataclasses.replace(
            model.cfg.sep, compute_dtype="float32"))
        f32 = model.embed(torch.from_numpy(feats), torch.from_numpy(mask)).numpy()
        model.cfg = _bf16(model.cfg)
    assert got.shape == want.shape == (2, 253, 129, 40)
    assert np.abs(got - want).max() <= 2e-3
    assert np.abs(f32 - want).max() > 2e-3


def test_c1_separate_in_bf16_matches_jax(c1):
    jm, jp, model, mixes = c1
    want = np.asarray(jm.separate(jp, jnp.asarray(mixes), kmeans_iters=30))
    got = model.separate(torch.from_numpy(mixes), kmeans_iters=30).numpy()
    e, r = torch.tensor(got, dtype=torch.float64), torch.tensor(want, dtype=torch.float64)
    agree = torch.maximum(si_sdr(e, r).mean(-1), si_sdr(e.flip(1), r).mean(-1)).numpy()
    assert got.shape == want.shape == (2, 2, 16384)
    assert (agree >= 40.0).all(), agree


def test_c1_loss_and_gradients_in_bf16_match_jax_grad():
    jcfg = _bf16(jrecipes.c1_stft_dpcl().model)
    jcfg = dataclasses.replace(jcfg, sep=dataclasses.replace(jcfg.sep, hidden=16, layers=2,
                                                             embed_dim=4))
    jm = JDPCL(jcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    model = params_from_jax(_port_cfg(jcfg), _np(jp), device="cpu")
    src = (np.random.default_rng(6).standard_normal((2, 2, 2048)) * 0.1).astype(np.float32)
    (jl, _), jg = jax.value_and_grad(lambda p: jm.loss(p, jnp.asarray(src)), has_aux=True)(jp)
    loss, _ = model.loss(torch.from_numpy(src))
    assert abs(loss.item() - float(jl)) <= 1e-4 * abs(float(jl))
    loss.backward()
    want = named_from_jax(_np(jg))
    for n, p in model.named_parameters():
        if not p.requires_grad:
            continue
        w = want[n].numpy()
        assert np.linalg.norm(p.grad.numpy() - w) <= 1e-2 * np.linalg.norm(w), n


def _c6_dprnn():
    r = jrecipes.c6_tasnet()
    return _bf16(dataclasses.replace(r.model, sep=dataclasses.replace(
        r.model.sep, trunk="dprnn", hidden=16, blocks=2, chunk_frames=8)))


def test_the_dprnn_stack_in_bf16_matches_jax():
    jp = jdprnn.init_dprnn(jax.random.PRNGKey(0), 12, 8, 8, 2)
    port = dprnn.DPRNN(12, 8, 8, 2)
    named = named_from_jax({"separator": {"dprnn": _np(jp)}})
    port.load_state_dict({n[len("dprnn."):]: v for n, v in named.items()})
    x = _x((2, 18, 12))
    m = np.ones((2, 18), np.float32)
    m[1, 11:] = 0.0
    want = np.asarray(jdprnn.dprnn_stack(jp, jnp.asarray(x), jnp.asarray(m), chunk_frames=4,
                                         compute_dtype=jnp.bfloat16))
    with torch.no_grad():
        got = dprnn.dprnn_stack(port, torch.from_numpy(x), torch.from_numpy(m), chunk_frames=4,
                                compute_dtype=torch.bfloat16).numpy()
        f32 = dprnn.dprnn_stack(port, torch.from_numpy(x), torch.from_numpy(m),
                                chunk_frames=4).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= OUT_TOL * scale
    assert np.abs(f32 - want).max() > OUT_TOL * scale


def test_c6_with_the_dprnn_trunk_in_bf16_matches_jax():
    jcfg = _c6_dprnn()
    jm = j_make_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(2))
    model = params_from_jax(_port_cfg(jcfg), _np(jp), device="cpu")
    src = (np.random.default_rng(6).standard_normal((2, 2, 2048)) * 0.1).astype(np.float32)
    jl, _ = jm.loss(jp, jnp.asarray(src))
    with torch.no_grad():
        loss, _ = model.loss(torch.from_numpy(src))
    assert abs(loss.item() - float(jl)) <= 1e-4 * abs(float(jl))
    mix = src.sum(axis=1)
    fm = np.ones((2, jcfg.front.frames_for(2048)), np.float32)
    fm[1, 70:] = 0.0
    want = np.asarray(jm.separate(jp, jnp.asarray(mix), frame_mask=jnp.asarray(fm)))
    got = model.separate(torch.from_numpy(mix), frame_mask=torch.from_numpy(fm)).numpy()
    assert np.abs(got - want).max() <= OUT_TOL * np.abs(want).max()


def test_the_enh_refiner_in_bf16_matches_jax():
    """The refiner over checkpoints/c1_dpcl, given one first pass (its
    k-means seeds on a tie that rounding breaks, ROADMAP C.2): the masks of
    both packages from the same mixture and estimate codes."""
    def cfg(mod):
        m = mod.enh_dpcl(RUN).model
        return _bf16(dataclasses.replace(m, sep=dataclasses.replace(m.sep, hidden=16)))

    jm = j_make_model(cfg(jrecipes), base_run=RUN)
    jp = jax.tree_util.tree_map(
        lambda a: a + 0.01 * jnp.asarray(np.random.default_rng(7).standard_normal(a.shape),
                                         jnp.float32), jm.init(jax.random.PRNGKey(7)))
    model = make_model(cfg(recipes), RUN, "cpu")
    model.load_state_dict(named_from_jax(_np(jp)))
    src = _x((2, 2, 4096), seed=8) * 0.1
    mix = src.sum(axis=1)
    est = src + 0.05 * _x(src.shape, seed=9)
    codes, _ = jm.front.encode(jm.front_params, jnp.asarray(mix))
    est_codes, _ = jm.front.encode(jm.front_params, jnp.asarray(est))
    fm = np.ones((2, codes.shape[1]), np.float32)
    fm[1, 40:] = 0.0
    want = np.asarray(jm._refined_masks(jp, codes, est_codes, jnp.asarray(fm)))
    with torch.no_grad():
        got = model.refined_masks(torch.from_numpy(np.asarray(codes)),
                                  torch.from_numpy(np.asarray(est_codes)),
                                  torch.from_numpy(fm)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= OUT_TOL


@pytest.mark.parametrize("kind", ["c1", "enh"])
def test_exporting_a_bf16_blstm_raises_24b(kind, tmp_path):
    """The name is kept from when the export raised: a model whose BLSTM runs
    in bf16 now exports, one ``amss::blstm_bf16_layer`` operator a layer,
    and serves from the artifact.  c1's artifact returns the live bf16
    model's output exactly (one loop, one order of sums); the enhancer's
    first pass is c1 in float32, whose traced BLSTM may seed k-means
    otherwise (ROADMAP C.2), so it is held to shapes and finite values."""
    if kind == "c1":
        model = load_model_from_run(RUN, device="cpu")
        model.cfg = _bf16(model.cfg)
    else:
        r = recipes.enh_dpcl(RUN)
        model = make_model(_bf16(r.model), r.base_run, "cpu")
    export_serving(model, str(tmp_path), lengths=(2048,), batch=1, platforms=("cpu",))
    ep = torch.export.load(str(tmp_path / "serving_t2048_b1.cpu.pt2"))
    assert sum("blstm_bf16_layer" in str(n.target) for n in ep.graph.nodes) == model.blstm.layers
    rng = np.random.default_rng(0)
    waves = [rng.standard_normal(n).astype(np.float32) * 0.3 for n in (2048, 1500)]
    got = ServingArtifact(str(tmp_path), device="cpu").separate_all(waves)
    assert [g.shape for g in got] == [(2, len(w)) for w in waves]
    assert all(np.isfinite(g).all() for g in got)
    if kind == "c1":
        live = StreamingSeparator(model, buckets=BucketSpec(lengths=(2048,)),
                                  device="cpu").separate_all(waves, max_batch=1)
        for g, w in zip(got, live):
            np.testing.assert_array_equal(g, w)


def _quality():
    """The JAX package's (SI-SDRi, 95% interval) of checkpoints/c1_dpcl in
    bf16 on bench.py's trained-quality protocol, and in float32."""
    jm, jp = j_load(RUN)
    return (bench._trained_quality(JDPCL(_bf16(jm.cfg)), jp, s=2),
            bench._trained_quality(jm, jp, s=2))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    (bf16, ci), (f32, ci32) = _quality()
    print(f"bench.py trained-quality protocol (64 mixtures, c1_dpcl, JAX on the CPU): bf16 "
          f"si_sdri {bf16:.3f} dB, 95% CI {ci}; float32 {f32:.3f} dB, 95% CI {ci32}")
