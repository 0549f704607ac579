"""The BLSTM: the explicit loop against JAX's blstm_stack, and the packed
nn.LSTM path against the loop.  atol 1e-5: float32 gate arithmetic over a
few steps, summed in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amss_tpu.models.blstm import blstm_stack, init_blstm_stack
from amss_tpu_torch.models.blstm import BLSTM
from amss_tpu_torch.weights import lstm_state

torch.set_num_threads(2)

N_IN, HIDDEN, LAYERS, T = 129, 300, 2, 9


@pytest.fixture(scope="module")
def stack():
    layers = init_blstm_stack(jax.random.PRNGKey(0), N_IN, HIDDEN, LAYERS)
    return jax.tree_util.tree_map(np.asarray, layers)


@pytest.fixture(scope="module")
def blstm(stack):
    m = BLSTM(N_IN, HIDDEN, LAYERS)
    m.lstm.load_state_dict(lstm_state(stack))
    return m.eval()


def _prefix_mask(lengths, t=T):
    m = np.zeros((len(lengths), t), np.float32)
    for b, n in enumerate(lengths):
        m[b, :n] = 1.0
    return m


@pytest.mark.parametrize("mask", [
    None,
    _prefix_mask((T, 5, 1)),
    np.array([[1, 0, 1, 1, 0, 0, 1, 1, 1]] * 3, np.float32),  # not a prefix
], ids=["none", "ragged-prefix", "holes"])
def test_loop_matches_jax(rng, stack, blstm, mask):
    x = rng.standard_normal((3, T, N_IN)).astype(np.float32)
    want = np.asarray(blstm_stack(stack, jnp.asarray(x),
                                  mask=None if mask is None else jnp.asarray(mask)))
    with torch.no_grad():
        got = blstm.loop(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    assert got.shape == want.shape == (3, T, 2 * HIDDEN)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    if mask is not None:
        assert (got.numpy()[mask == 0] == 0).all()


@pytest.mark.parametrize("lengths", [(T, T, T), (T, 5, 1), (3, 7, 0)])
def test_packed_matches_loop(rng, blstm, lengths):
    x = rng.standard_normal((3, T, N_IN)).astype(np.float32)
    mask = torch.from_numpy(_prefix_mask(lengths))
    with torch.no_grad():
        packed = blstm.packed(torch.from_numpy(x), mask)
        loop = blstm.loop(torch.from_numpy(x), mask)
    np.testing.assert_allclose(packed.numpy(), loop.numpy(), atol=1e-5)


def test_packed_without_mask_matches_loop(rng, blstm):
    x = torch.from_numpy(rng.standard_normal((2, T, N_IN)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(blstm.packed(x).numpy(), blstm.loop(x).numpy(), atol=1e-5)


def test_packed_rejects_a_mask_with_holes(blstm):
    mask = torch.tensor([[1.0, 0.0, 1.0] + [0.0] * (T - 3)])
    with pytest.raises(ValueError, match="prefix"):
        blstm.packed(torch.zeros((1, T, N_IN)), mask)


def test_cpu_forward_is_the_loop(rng, blstm):
    x = torch.from_numpy(rng.standard_normal((2, T, N_IN)).astype(np.float32))
    mask = torch.from_numpy(_prefix_mask((T, 4), T))
    with torch.no_grad():
        np.testing.assert_array_equal(blstm(x, mask).numpy(), blstm.loop(x, mask).numpy())
