"""Max-pool with argmax and its unpool (``amss_tpu_torch/ops/pooling.py``)
against the JAX package's ``ops/pooling.py`` on the same inputs.

Both are exact: the values are a max and the unpool a one-hot product, so the
outputs are compared bit for bit, the indices too, including exact ties
(first maximum wins in both)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amss_tpu.ops.pooling import max_pool_argmax as j_pool
from amss_tpu.ops.pooling import unpool_argmax as j_unpool
from amss_tpu_torch.ops.pooling import max_pool_argmax, unpool_argmax

torch.set_num_threads(2)


@pytest.mark.parametrize("shape,pool", [((3, 12, 5), 2), ((2, 2, 9, 4), 3), ((8, 7), 1)])
def test_pool_and_unpool_match_jax(shape, pool):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    x = np.abs(x)
    want_v, want_i = j_pool(jnp.asarray(x), pool)
    got_v, got_i = max_pool_argmax(torch.from_numpy(x), pool)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    want_u = j_unpool(want_v, want_i, pool)
    got_u = unpool_argmax(got_v, got_i, pool)
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))


def test_exact_ties_take_the_first_maximum():
    x = np.array([[1.0, 2.0], [1.0, 2.0], [0.5, 3.0], [0.5, 3.0], [0.0, 0.0], [0.0, 0.0]],
                 np.float32)[None]  # [1, 6, 2]: every window of 2 is a tie
    for pool in (2, 3):
        want_v, want_i = j_pool(jnp.asarray(x), pool)
        got_v, got_i = max_pool_argmax(torch.from_numpy(x), pool)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    _, idx = max_pool_argmax(torch.from_numpy(x), 2)
    assert (idx == 0).all()


def test_unpool_broadcasts_a_speaker_axis():
    """Masked codes [B, S, T'', N] unpool with the mixture's idx [B, 1, T'', N]."""
    rng = np.random.default_rng(1)
    vals = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    idx = rng.integers(0, 2, (2, 1, 4, 5)).astype(np.int32)
    want = j_unpool(jnp.asarray(vals), jnp.asarray(idx), 2)
    got = unpool_argmax(torch.from_numpy(vals), torch.from_numpy(idx), 2)
    assert got.shape == (2, 3, 8, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pool_rejects_a_ragged_length():
    with pytest.raises(ValueError, match="not divisible"):
        max_pool_argmax(torch.zeros(1, 5, 2), 2)


def test_pool_gradient_matches_jax_at_ties():
    """The gradient of the pooled values: both split it evenly among tied maxima."""
    import jax

    x = np.array([[[1.0], [1.0], [0.2], [0.7]]], np.float32)
    g = np.array([[[2.0], [3.0]]], np.float32)
    want = jax.grad(lambda a: jnp.sum(j_pool(a, 2)[0] * g))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (max_pool_argmax(xt, 2)[0] * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
