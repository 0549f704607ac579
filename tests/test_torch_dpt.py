"""The dual-path transformer trunk (``amss_tpu_torch/models/dptransformer.py``)
against the JAX package (``amss_tpu/models/dptransformer.py``), both on the
CPU, on the same parameters (the JAX init carried across, moved off it) and
inputs.

Tolerances and why:
  * the position code: 1e-6 absolute (float32 sin and cos of the same
    angles);
  * ``dpt_stack``: 1e-5 of the output's largest magnitude, with and without
    padding to ``P·K``, with a frame mask, and with a chunk whose every key
    is padding (float32 products and softmaxes summed in other orders);
  * every parameter and input gradient against ``jax.grad``: 1e-4 of each
    tensor's largest magnitude; the key projection's bias, whose gradient is
    0 in exact arithmetic (a softmax is unchanged by a shift of a query's
    logits), is rounding noise on both sides and is held at 1e-4 of the
    stack's largest gradient;
  * golden "c6_dpt": 1e-4 relative, the golden test's own bound;
  * c6 with the DPT trunk served: 1e-4 of the output's peak.
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
from amss_tpu.models import dptransformer as jdpt
from amss_tpu.train.engine import make_model as j_make_model
from amss_tpu_torch.models import dptransformer as dpt
from amss_tpu_torch.models.tasnet import TasNetModel
from amss_tpu_torch.utils.config import FrontConfig, ModelConfig, SeparatorConfig
from amss_tpu_torch.weights import named_from_jax, params_from_jax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_IN, D, FFN, BLOCKS, K, HEADS = 12, 8, 16, 2, 4, 2


@pytest.fixture(autouse=True)
def _jnp_path(monkeypatch):
    monkeypatch.setenv("AMSS_PALLAS", "0")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _stacks(seed=0):
    jp = jdpt.init_dpt(jax.random.PRNGKey(seed), N_IN, D, FFN, BLOCKS)
    leaves, tree = jax.tree_util.tree_flatten(jp)
    rng = np.random.default_rng(seed)
    leaves = [jnp.asarray(np.asarray(x) + 0.1 * rng.standard_normal(x.shape), jnp.float32)
              for x in leaves]
    jp = jax.tree_util.tree_unflatten(tree, leaves)
    port = dpt.DPT(N_IN, D, FFN, BLOCKS)
    named = named_from_jax({"separator": {"dpt": _np(jp)}})
    port.load_state_dict({n[len("dpt."):]: v for n, v in named.items()})
    return jp, port


def _mask(t, lengths):
    m = np.zeros((len(lengths), t), np.float32)
    for i, n in enumerate(lengths):
        m[i, :n] = 1.0
    return m


@pytest.mark.parametrize("length,dim", [(7, 8), (32, 9), (5, 1)])
def test_sinusoid_matches_jax(length, dim):
    np.testing.assert_allclose(dpt.sinusoid(length, dim).numpy(),
                               np.asarray(jdpt._sinusoid(length, dim)), atol=1e-6)


@pytest.mark.parametrize("t,lengths", [(16, None), (18, None), (18, (18, 11)), (16, (16, 3))],
                         ids=["exact", "padded", "masked", "masked_chunks"])
def test_dpt_stack_matches_jax(t, lengths):
    """"masked_chunks": the second row's last three chunks hold padding
    alone, so their intra rows have no valid key: a uniform softmax there,
    finite, and zeroed at the block's end, as in the JAX package."""
    jp, port = _stacks()
    x = _x((2, t, N_IN))
    m = None if lengths is None else _mask(t, lengths)
    want = np.asarray(jdpt.dpt_stack(jp, jnp.asarray(x), None if m is None else jnp.asarray(m),
                                     chunk_frames=K, heads=HEADS))
    with torch.no_grad():
        got = dpt.dpt_stack(port, torch.from_numpy(x), None if m is None else torch.from_numpy(m),
                            chunk_frames=K, heads=HEADS).numpy()
    assert got.shape == want.shape == (2, t, D)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    if m is not None:
        assert not got[m == 0].any()


def test_a_query_with_no_valid_key_stays_finite():
    """The additive -1e9 keeps a fully masked row's softmax finite (uniform);
    the row is garbage but finite, and JAX's is the same garbage."""
    jp, port = _stacks(seed=5)
    x = _x((3, K, D), seed=6)
    m = np.zeros((3, K), np.float32)
    m[0] = 1.0
    m[1, :2] = 1.0
    path = jp["blocks"][0]["intra"]["attn"]
    want = np.asarray(jdpt._mha(path, jnp.asarray(x), jnp.asarray(m), HEADS, jnp.float32))
    with torch.no_grad():
        got = dpt.mha(port.blocks[0].intra.attn, torch.from_numpy(x), torch.from_numpy(m),
                      HEADS).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("padded", [False, True])
def test_every_gradient_matches_jax_grad(padded):
    jp, port = _stacks(seed=3)
    t = 18 if padded else 16
    x = _x((2, t, N_IN), seed=4)
    m = _mask(t, (t, 9))
    cot = _x((2, t, D), seed=5)

    def f(p, x):
        return jnp.sum(jdpt.dpt_stack(p, x, jnp.asarray(m), chunk_frames=K, heads=HEADS) * cot)

    jgp, jgx = jax.grad(f, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = dpt.dpt_stack(port, xt, torch.from_numpy(m), chunk_frames=K, heads=HEADS, remat=True)
    (y * torch.from_numpy(cot)).sum().backward()
    jgx = np.asarray(jgx)
    assert np.abs(xt.grad.numpy() - jgx).max() <= 1e-4 * np.abs(jgx).max()
    want = named_from_jax({"separator": {"dpt": _np(jgp)}})
    assert {"dpt." + n for n, _ in port.named_parameters()} == set(want)
    top = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for n, p in port.named_parameters():
        w = want["dpt." + n].numpy()
        scale = top if n.endswith("attn.wk.bias") else np.abs(w).max()
        assert np.abs(p.grad.numpy() - w).max() <= 1e-4 * scale, n


def _port_cfg(jcfg) -> ModelConfig:
    d = dataclasses.asdict(jcfg)
    return ModelConfig(front=FrontConfig(**d.pop("front")), sep=SeparatorConfig(**d.pop("sep")),
                       **d)


def _c6_dpt():
    """golden "c6_dpt" (tests/test_goldens.py): c6 with the DPT trunk, K = 8,
    four heads, at the goldens' width (hidden 16, E = 4)."""
    r = jrecipes.c6_tasnet()
    return dataclasses.replace(r.model, sep=dataclasses.replace(
        r.model.sep, trunk="dpt", chunk_frames=8, heads=4, hidden=16, layers=1, embed_dim=4))


def test_loss_reproduces_golden_c6_dpt():
    """tests/test_goldens.py's protocol: the JAX init from PRNGKey(7) carried
    across, and the draws of every recipe before c6_dpt in the same order."""
    jcfg = _c6_dpt()
    jp = _np(j_make_model(jcfg).init(jax.random.PRNGKey(7)))
    rng = np.random.default_rng(1234)
    for name, s in (("c1", 2), ("c2_pretrain", 2), ("c2", 2), ("c3", 2), ("c4", 3), ("c6", 2)):
        rng.standard_normal((2, s, 2048))
        if name == "c3":
            rng.integers(0, 6, (2, s))
    sources = (rng.standard_normal((2, 2, 2048)) * 0.1).astype(np.float32)
    model = params_from_jax(_port_cfg(jcfg), jp, device="cpu")
    with torch.no_grad():
        loss, _ = model.loss_from_batch({"sources": torch.from_numpy(sources)})
    with open(os.path.join(REPO, "tests", "goldens.json")) as f:
        want = json.load(f)["c6_dpt"]
    assert abs(float(loss) - want) <= 1e-4 * max(abs(want), 1.0), (float(loss), want)


def test_c6_dpt_serves_as_jax_does_and_needs_heads_to_divide_the_width():
    jcfg = _c6_dpt()
    jm = j_make_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    model = params_from_jax(_port_cfg(jcfg), _np(jp), device="cpu")
    mix = (np.random.default_rng(7).standard_normal((2, 4096)) * 0.1).astype(np.float32)
    fm = np.ones((2, jcfg.front.frames_for(4096)), np.float32)
    fm[1, 100:] = 0.0
    want = np.asarray(jm.separate(jp, jnp.asarray(mix), frame_mask=jnp.asarray(fm)))
    got = model.separate(torch.from_numpy(mix), frame_mask=torch.from_numpy(fm)).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    bad = dataclasses.replace(_port_cfg(jcfg), sep=dataclasses.replace(
        _port_cfg(jcfg).sep, heads=3))
    with pytest.raises(ValueError, match="divisible"):
        TasNetModel(bad)
