"""The causal realtime path (``amss_tpu_torch/infer/realtime.py``, the
cumulative norms of ``models/front.py`` and ``tcn_stack_streaming`` of
``models/tcn.py``) against the JAX package on the CPU, on the same weights
(the JAX init carried across) and inputs drawn from numpy seeds.

Tolerances and why:
  * the cumulative norms: 1e-5 absolute on values of order 1 (float32 prefix
    sums in other orders; the carry's sums feed ``ss/n - mu²``);
  * ``tcn_stack_streaming`` against the JAX one: 1e-5 absolute (float32
    products of at most 32 terms, summed in other orders); against the port's
    own causal ``tcn_stack``: bit for bit, the same multiply-adds;
  * streamed output against the JAX package's offline ``separate`` and its
    ``RealtimeSeparator``: rtol 1e-4, atol 1e-5, the JAX package's own bound
    for streamed against offline (``tests/test_realtime.py``);
  * pipelined against synchronous pushes: bit for bit;
  * golden "c7": 1e-4 relative, the golden test's own bound.
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
from amss_tpu.infer.realtime import RealtimeSeparator as JRealtime
from amss_tpu.models import front as jfront
from amss_tpu.models import tcn as jtcn
from amss_tpu.train.engine import make_model as j_make_model
from amss_tpu_torch.configs import recipes
from amss_tpu_torch.infer.realtime import RealtimeSeparator
from amss_tpu_torch.models import front, tcn
from amss_tpu_torch.utils.config import FrontConfig, ModelConfig, SeparatorConfig
from amss_tpu_torch.weights import _flatten, params_from_jax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
CHUNK = 1024


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_cfg(jcfg) -> ModelConfig:
    d = dataclasses.asdict(jcfg)
    return ModelConfig(front=FrontConfig(**d.pop("front")), sep=SeparatorConfig(**d.pop("sep")),
                       **d)


def _tiny(**sep):
    """c7 cut to a TCN of 2 x 3 blocks of bottleneck 16 (the JAX package's
    realtime tests' size)."""
    r = jrecipes.c7_realtime()
    return dataclasses.replace(r.model, sep=dataclasses.replace(
        r.model.sep, **{"hidden": 16, "blocks": 3, "repeats": 2, **sep}))


@pytest.fixture(scope="module")
def c7():
    """(JAX model, JAX params, the port's model) of the tiny c7."""
    jcfg = _tiny()
    jm = j_make_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, params_from_jax(_port_cfg(jcfg), _np(jp), device="cpu")


def _wave(seed: int, t: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(t) * 0.3).astype(np.float32)


_JITTED = {}


def _offline(jm, jp, wave: np.ndarray) -> np.ndarray:
    """The JAX package's offline ``separate``: [T] -> [S, T], or [B, T] -> [B,
    S, T] (jitted: one compile per shape)."""
    fn = _JITTED.setdefault(id(jm), jax.jit(jm.separate))
    out = np.asarray(fn(jp, jnp.asarray(wave if wave.ndim == 2 else wave[None])))
    return out if wave.ndim == 2 else out[0]


# -- the cumulative norms ----------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("split", [None, 9])
def test_cumulative_norm_matches_jax(masked, split):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 24, 6)) + 2.0).astype(np.float32)
    mask = (rng.random((2, 24)) > 0.3).astype(np.float32) if masked else None
    want, jtot = jfront.cumulative_norm(jnp.asarray(x), None if mask is None else jnp.asarray(mask))
    xt = torch.from_numpy(x)
    mt = None if mask is None else torch.from_numpy(mask)
    if split is None:
        got, tot = front.cumulative_norm(xt, mt)
    else:  # the second half seeded with the first half's totals
        head, carry = front.cumulative_norm(xt[:, :split], None if mt is None else mt[:, :split])
        tail, tot = front.cumulative_norm(xt[:, split:], None if mt is None else mt[:, split:],
                                          carry=carry)
        got = torch.cat([head, tail], dim=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for a, b in zip(tot, jtot):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)


@pytest.mark.parametrize("split", [None, 15])
def test_welford_norm_matches_jax(split):
    x = (np.random.default_rng(5).standard_normal((1, 40, 6)) + 3.0).astype(np.float32)
    xj = jnp.asarray(x)
    if split is None:
        want, _ = jfront.cumulative_norm_welford(xj)
        got, _ = front.cumulative_norm_welford(torch.from_numpy(x))
    else:
        a, st = jfront.cumulative_norm_welford(xj[:, :split])
        b, _ = jfront.cumulative_norm_welford(xj[:, split:], carry=st)
        want = jnp.concatenate([a, b], axis=1)
        pa, pst = front.cumulative_norm_welford(torch.from_numpy(x[:, :split]))
        pb, _ = front.cumulative_norm_welford(torch.from_numpy(x[:, split:]), carry=pst)
        got = torch.cat([pa, pb], dim=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    ref, _ = front.cumulative_norm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL, atol=ATOL)


# -- the streaming TCN -------------------------------------------------------

def _stacks():
    jp = jtcn.init_tcn(jax.random.PRNGKey(0), 8, 12, 16, 3, repeats=2)
    port = tcn.TCN(8, 12, 16, 3, 2)
    port.load_state_dict(_flatten(_np(jp), ""))
    return jp, port


@pytest.mark.parametrize("masked", [False, True])
def test_tcn_stack_streaming_matches_jax_and_the_causal_stack(masked):
    jp, port = _stacks()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 48, 8)).astype(np.float32)
    mask = np.ones((2, 48), np.float32)
    if masked:
        mask[:, :2] = 0.0  # the pre-stream frames of a first push
    jstates = [jnp.zeros((2, t, c)) for t, c in jtcn.dw_state_shapes(16, 3, 2, 3)]
    states = [torch.zeros((2, t, c)) for t, c in tcn.dw_state_shapes(16, 3, 2, 3)]
    jouts, outs = [], []
    with torch.no_grad():
        for lo in (0, 16, 32):
            sl = slice(lo, lo + 16)
            o, jstates = jtcn.tcn_stack_streaming(jp, jnp.asarray(x[:, sl]), jstates,
                                                  mask=jnp.asarray(mask[:, sl]),
                                                  blocks_per_repeat=3)
            jouts.append(np.asarray(o))
            p, states = tcn.tcn_stack_streaming(port, torch.from_numpy(x[:, sl]), states,
                                                mask=torch.from_numpy(mask[:, sl]),
                                                blocks_per_repeat=3)
            outs.append(p)
        got = torch.cat(outs, dim=1)
        full = tcn.tcn_stack(port, torch.from_numpy(x), mask=torch.from_numpy(mask),
                             blocks_per_repeat=3, causal=True)
    np.testing.assert_allclose(got.numpy(), np.concatenate(jouts, axis=1), atol=ATOL)
    assert torch.equal(got, full)
    for a, b in zip(states, jstates):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


# -- RealtimeSeparator ---------------------------------------------------------

def test_one_stream_matches_jax_offline_and_jax_streaming(c7):
    jm, jp, model = c7
    wave = _wave(3, 5000)  # not a multiple of the chunk
    rt = RealtimeSeparator(model, chunk_samples=CHUNK, device="cpu")
    got = rt.separate_stream(wave)
    assert got.shape == (2, 5000) and np.isfinite(got).all()
    np.testing.assert_allclose(got, _offline(jm, jp, wave), rtol=RTOL, atol=ATOL)
    want = JRealtime(jm, jp, chunk_samples=CHUNK).separate_stream(wave)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # against the port's own offline path, through the same arithmetic
    off = model.separate(torch.from_numpy(wave[None]))[0].numpy()
    np.testing.assert_allclose(got, off, rtol=RTOL, atol=ATOL)


def test_pipelined_equals_synchronous_and_state_resets(c7):
    jm, jp, model = c7
    rt = RealtimeSeparator(model, chunk_samples=CHUNK, device="cpu")
    wave = _wave(13, 5000)
    sync = rt.separate_stream(wave)
    np.testing.assert_array_equal(rt.separate_stream_pipelined(wave), sync)
    other = _wave(4, 3000)  # a second utterance: nothing carries over
    np.testing.assert_allclose(rt.separate_stream(other), _offline(jm, jp, other),
                               rtol=RTOL, atol=ATOL)
    assert rt._timed_pushes > 0 and rt.warmup_seconds > 0 and np.isfinite(rt.rtf)


def test_sixteen_ragged_streams_match_jax_offline(c7):
    """Four lengths, four streams each, in an interleaved order: every stream
    ends at its own frame (the JAX offline side compiles once per length)."""
    jm, jp, model = c7
    lengths = [1200 + 917 * (i % 4) for i in range(16)]
    waves = np.zeros((16, max(lengths)), np.float32)
    for i, n in enumerate(lengths):
        waves[i, :n] = _wave(20 + i, n)
    rt = RealtimeSeparator(model, chunk_samples=CHUNK, n_streams=16, device="cpu")
    got = rt.separate_streams(waves, lengths=lengths)
    assert got.shape == (16, 2, max(lengths))
    for n in sorted(set(lengths)):
        rows = [i for i, m in enumerate(lengths) if m == n]
        want = _offline(jm, jp, waves[rows, :n])
        np.testing.assert_allclose(got[rows, :, :n], want, rtol=RTOL, atol=ATOL,
                                   err_msg=f"streams of {n} samples")
    # the JAX package's multi-stream push with the same per-stream end frames
    jrt = JRealtime(jm, jp, chunk_samples=CHUNK, n_streams=16)
    n_chunks, _ = jrt._plan(max(lengths))
    padded = np.zeros((16, n_chunks * CHUNK), np.float32)
    padded[:, : max(lengths)] = waves
    nf = np.asarray([jm.cfg.front.frames_for(n) for n in lengths], np.int32)
    want = np.concatenate([jrt.push(padded[:, k * CHUNK : (k + 1) * CHUNK], end_frame=nf)
                           for k in range(n_chunks)], axis=-1)
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(got[i, :, :n], want[i, :, jrt.lag : jrt.lag + n],
                                   rtol=RTOL, atol=ATOL)


def test_equal_length_streams_match_jax(c7):
    jm, jp, model = c7
    waves = np.stack([_wave(11 + i, 4000) for i in range(3)])
    got = RealtimeSeparator(model, chunk_samples=CHUNK, n_streams=3,
                            device="cpu").separate_streams(waves)
    want = _offline(jm, jp, waves)
    assert got.shape == want.shape == (3, 2, 4000)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_long_stream_matches_jax_offline(c7):
    jm, jp, model = c7
    wave = _wave(7, 4000)
    got = RealtimeSeparator(model, chunk_samples=CHUNK, long_stream=True,
                            device="cpu").separate_stream(wave)
    np.testing.assert_allclose(got, _offline(jm, jp, wave), rtol=RTOL, atol=ATOL)
    want = JRealtime(jm, jp, chunk_samples=CHUNK, long_stream=True).separate_stream(wave)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_expansion_4_matches_jax_offline():
    jcfg = _tiny(expansion=4)
    jm = j_make_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    model = params_from_jax(_port_cfg(jcfg), _np(jp), device="cpu")
    assert model.tcn.blocks[0].dw.shape[-1] == 4 * 16
    wave = _wave(5, 3000)
    got = RealtimeSeparator(model, chunk_samples=CHUNK, device="cpu").separate_stream(wave)
    np.testing.assert_allclose(got, _offline(jm, jp, wave), rtol=RTOL, atol=ATOL)


def test_the_constructor_and_push_reject_what_jax_rejects(c7, monkeypatch):
    _, _, model = c7
    for sep in ({"causal": False}, {"feature_norm": "global"}):
        bad = params_from_jax(_port_cfg(_tiny(**sep)), _np(j_make_model(_tiny()).init(
            jax.random.PRNGKey(0))), device="cpu")
        with pytest.raises(ValueError):
            RealtimeSeparator(bad, device="cpu")
    with pytest.raises(ValueError, match="multiple of stride"):
        RealtimeSeparator(model, chunk_samples=1000, device="cpu")
    with pytest.raises(ValueError, match="chunk too small"):
        RealtimeSeparator(model, chunk_samples=32, device="cpu")
    rt = RealtimeSeparator(model, chunk_samples=CHUNK, device="cpu")
    with pytest.raises(ValueError, match="push expects"):
        rt.push(np.zeros(1000, np.float32))
    with pytest.raises(ValueError, match="one stream"):
        RealtimeSeparator(model, n_streams=2, device="cpu").separate_stream(np.zeros(2000))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RealtimeSeparator(model)


def test_the_recipe_is_the_jax_packages_and_reproduces_golden_c7():
    assert dataclasses.asdict(recipes.c7_realtime()) == dataclasses.asdict(
        jrecipes.c7_realtime())
    r = jrecipes.c7_realtime()
    jcfg = dataclasses.replace(r.model, sep=dataclasses.replace(
        r.model.sep, hidden=16, layers=1, embed_dim=4))
    jp = _np(j_make_model(jcfg).init(jax.random.PRNGKey(7)))
    rng = np.random.default_rng(1234)  # tests/test_goldens.py's draws, in its order
    order = [("c1", 2), ("c2_pretrain", 2), ("c2", 2), ("c3", 2), ("c4", 3), ("c6", 2),
             ("c6_dpt", 2), ("c7", 2)]
    for name, s in order:
        sources = (rng.standard_normal((2, s, 2048)) * 0.1).astype(np.float32)
        if name == "c3":
            rng.integers(0, 6, (2, s))
    model = params_from_jax(_port_cfg(jcfg), jp, device="cpu")
    with torch.no_grad():
        loss, _ = model.loss_from_batch({"sources": torch.from_numpy(sources)})
    with open(os.path.join(REPO, "tests", "goldens.json")) as f:
        want = json.load(f)["c7"]
    assert abs(float(loss) - want) <= 1e-4 * max(abs(want), 1.0), (float(loss), want)
