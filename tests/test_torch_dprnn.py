"""The dual-path RNN trunk (``amss_tpu_torch/models/dprnn.py``) against the
JAX package (``amss_tpu/models/dprnn.py``), both on the CPU, on the same
parameters (the JAX init carried across, moved off it) and inputs; and the
host-side lengths that let cuDNN pack its rows.

Tolerances and why:
  * ``dprnn_stack``: 1e-5 of the output's largest magnitude, with and without
    padding to ``P·K`` and with a frame mask (float32 recurrences of at most
    K or P steps and products summed in other orders);
  * every parameter and input gradient against ``jax.grad``: 1e-4 of each
    tensor's largest magnitude (float32 backward through the recurrences);
  * c6 with the DPRNN trunk: the loss 1e-5 relative, separation 1e-4 of the
    output's peak;
  * the lengths and the prefix property (ROADMAP C.5): exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amss_tpu.configs import recipes as jrecipes
from amss_tpu.models import dprnn as jdprnn
from amss_tpu.train.engine import make_model as j_make_model
from amss_tpu_torch.models import dprnn
from amss_tpu_torch.models.blstm import BLSTM
from amss_tpu_torch.utils.config import FrontConfig, ModelConfig, SeparatorConfig
from amss_tpu_torch.weights import named_from_jax, params_from_jax, params_to_jax

torch.set_num_threads(2)

N_IN, D, BLOCKS, K = 12, 8, 2, 4


@pytest.fixture(autouse=True)
def _jnp_path(monkeypatch):
    monkeypatch.setenv("AMSS_PALLAS", "0")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _stacks(seed=0):
    jp = jdprnn.init_dprnn(jax.random.PRNGKey(seed), N_IN, D, D, BLOCKS)
    leaves, tree = jax.tree_util.tree_flatten(jp)
    rng = np.random.default_rng(seed)
    leaves = [jnp.asarray(np.asarray(x) + 0.1 * rng.standard_normal(x.shape), jnp.float32)
              for x in leaves]
    jp = jax.tree_util.tree_unflatten(tree, leaves)
    port = dprnn.DPRNN(N_IN, D, D, BLOCKS)
    named = named_from_jax({"separator": {"dprnn": _np(jp)}})
    port.load_state_dict({n[len("dprnn."):]: v for n, v in named.items()})
    return jp, port


def _mask(t, lengths):
    m = np.zeros((len(lengths), t), np.float32)
    for i, n in enumerate(lengths):
        m[i, :n] = 1.0
    return m


@pytest.mark.parametrize("t,lengths", [(16, None), (18, None), (18, (18, 7)), (16, (16, 0))],
                         ids=["exact", "padded", "masked", "empty_row"])
def test_dprnn_stack_matches_jax(t, lengths):
    jp, port = _stacks()
    x = _x((2, t, N_IN))
    m = None if lengths is None else _mask(t, lengths)
    want = np.asarray(jdprnn.dprnn_stack(jp, jnp.asarray(x), None if m is None else jnp.asarray(m),
                                         chunk_frames=K))
    with torch.no_grad():
        got = dprnn.dprnn_stack(port, torch.from_numpy(x),
                                None if m is None else torch.from_numpy(m), chunk_frames=K)
    assert got.shape == want.shape == (2, t, D)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    if m is not None:
        assert not got.numpy()[m == 0].any()


@pytest.mark.parametrize("padded", [False, True])
def test_every_gradient_matches_jax_grad(padded):
    jp, port = _stacks(seed=3)
    t = 18 if padded else 16
    x = _x((2, t, N_IN), seed=4)
    m = _mask(t, (t, 9))
    cot = _x((2, t, D), seed=5)

    def f(p, x):
        return jnp.sum(jdprnn.dprnn_stack(p, x, jnp.asarray(m), chunk_frames=K) * cot)

    jgp, jgx = jax.grad(f, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = dprnn.dprnn_stack(port, xt, torch.from_numpy(m), chunk_frames=K, remat=True)
    (y * torch.from_numpy(cot)).sum().backward()
    jgx = np.asarray(jgx)
    assert np.abs(xt.grad.numpy() - jgx).max() <= 1e-4 * np.abs(jgx).max()
    want = named_from_jax({"separator": {"dprnn": _np(jgp)}})
    for n, p in port.named_parameters():
        if not p.requires_grad:
            continue
        w = want["dprnn." + n].numpy()
        assert np.abs(p.grad.numpy() - w).max() <= 1e-4 * np.abs(w).max(), n


@pytest.mark.parametrize("t", [16, 18, 21])
def test_intra_and_inter_rows_of_a_prefix_mask_are_prefixes(t):
    """ROADMAP C.5: for a prefix frame mask every intra row [B·P, K] and every
    inter row [B·K, P] is a prefix or empty, and ``path_lengths`` gives each
    row's length from the shapes (no mask) or from the mask, as the rows'
    own sums."""
    for lengths in [(t,) * 3, (t, 1, 0), (t - 1, 5, 4), (3, 8, t)]:
        m = torch.from_numpy(_mask(t, lengths))
        h, m_g = dprnn.pad_to_chunks(torch.zeros(3, t, 2), m, K)
        b, p, k = m_g.shape
        intra = m_g.reshape(b * p, k)
        inter = m_g.transpose(1, 2).reshape(b * k, p)
        li, lt = dprnn.path_lengths(t, K, m, b)
        for rows, lens in ((intra, li), (inter, lt)):
            assert torch.equal(rows.sum(dim=1).long(), lens)
            steps = torch.arange(rows.shape[1])[None, :]
            assert torch.equal(rows > 0, steps < lens[:, None])
    # without a mask only the padding to P·K is masked, and the shapes give it
    b = 2
    got = dprnn.path_lengths(t, K, None, b)
    if t % K == 0:
        assert got is None
    else:
        _, m_g = dprnn.pad_to_chunks(torch.zeros(b, t, 2), None, K)
        want = dprnn.path_lengths(t, K, torch.ones(b, t), b)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert torch.equal(got[0], m_g.reshape(-1, K).sum(1).long())


def test_a_mask_that_is_not_a_prefix_is_refused():
    m = torch.ones(2, 16)
    m[1, 3] = 0.0
    with pytest.raises(ValueError, match="prefix"):
        dprnn.path_lengths(16, K, m, 2)


def test_the_blstm_takes_lengths_in_place_of_its_mask_copy():
    """The lengths reach cuDNN's packed path only; on the CPU the loop runs on
    the mask, so given lengths change nothing."""
    lstm = BLSTM(5, 4, 1)
    lstm.init_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x((3, 6, 5)))
    m = torch.from_numpy(_mask(6, (6, 2, 0)))
    with torch.no_grad():
        assert torch.equal(lstm(x, m), lstm(x, m, lengths=torch.tensor([6, 2, 0])))


def _c6(trunk="dprnn", **sep):
    r = jrecipes.c6_tasnet()
    return dataclasses.replace(r.model, sep=dataclasses.replace(
        r.model.sep, trunk=trunk, hidden=16, blocks=2, chunk_frames=8, **sep))


def _port_cfg(jcfg) -> ModelConfig:
    d = dataclasses.asdict(jcfg)
    return ModelConfig(front=FrontConfig(**d.pop("front")), sep=SeparatorConfig(**d.pop("sep")),
                       **d)


def test_c6_with_the_dprnn_trunk_matches_jax():
    jcfg = _c6()
    jm = j_make_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(2))
    model = params_from_jax(_port_cfg(jcfg), _np(jp), device="cpu")
    src = (np.random.default_rng(6).standard_normal((2, 2, 2048)) * 0.1).astype(np.float32)
    jl, _ = jm.loss(jp, jnp.asarray(src))
    with torch.no_grad():
        loss, _ = model.loss(torch.from_numpy(src))
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    mix = src.sum(axis=1)
    fm = np.ones((2, jcfg.front.frames_for(2048)), np.float32)
    fm[1, 70:] = 0.0
    want = np.asarray(jm.separate(jp, jnp.asarray(mix), frame_mask=jnp.asarray(fm)))
    got = model.separate(torch.from_numpy(mix), frame_mask=torch.from_numpy(fm)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    tree = params_to_jax(model)
    for a, b in zip(jax.tree_util.tree_leaves(tree["separator"]),
                    jax.tree_util.tree_leaves(_np(jp["separator"]))):
        np.testing.assert_array_equal(a, b)


def test_init_draws_the_reference_distributions():
    port = dprnn.DPRNN(N_IN, D, D, BLOCKS)
    port.init_parameters(torch.Generator().manual_seed(0))
    path = port.blocks[1].inter
    assert float(path.proj.weight.abs().max()) <= 1 / np.sqrt(2 * D)
    assert torch.equal(path.ln.g, torch.ones(D)) and not path.ln.b.any()
    b = path.lstm.lstm.bias_ih_l0
    assert torch.equal(b[D : 2 * D], torch.ones(D)) and not b[:D].any()
    jtree = _np(jdprnn.init_dprnn(jax.random.PRNGKey(0), N_IN, D, D, BLOCKS))
    names = {n[len("dprnn."):] for n in named_from_jax({"separator": {"dprnn": jtree}})}
    assert names == set(port.state_dict())
