"""k-means and soft masks against the JAX package on fixed embeddings.

Centroids to atol 1e-5 (float32 means of a few hundred points summed in
another order), assignments exactly, soft masks to 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amss_tpu.ops.kmeans import _farthest_point_init as j_init
from amss_tpu.ops.kmeans import kmeans as j_kmeans
from amss_tpu.ops.kmeans import soft_assignments as j_soft
from amss_tpu_torch.ops.kmeans import _farthest_point_init, kmeans, soft_assignments

torch.set_num_threads(2)


def _blobs(rng, b=2, n=300, e=8, k=3):
    centers = rng.standard_normal((b, k, e)) * 3
    which = rng.integers(0, k, size=(b, n))
    x = np.take_along_axis(centers, which[..., None], axis=1) + 0.3 * rng.standard_normal((b, n, e))
    w = (rng.uniform(size=(b, n)) > 0.2).astype(np.float32)
    return x.astype(np.float32), w


@pytest.mark.parametrize("k,iters", [(2, 10), (3, 10), (3, 0)])
def test_kmeans_matches_jax(rng, k, iters):
    x, w = _blobs(rng, k=3)
    jc, ja = j_kmeans(jnp.asarray(x), k=k, iters=iters, weights=jnp.asarray(w))
    tc, ta = kmeans(torch.from_numpy(x), k=k, iters=iters, weights=torch.from_numpy(w))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert ta.dtype == torch.int32


def test_kmeans_unbatched_and_unweighted_match_jax(rng):
    x, _ = _blobs(rng, b=1)
    jc, ja = j_kmeans(jnp.asarray(x[0]), k=3, iters=10)
    tc, ta = kmeans(torch.from_numpy(x[0]), k=3, iters=10)
    assert tc.shape == (3, 8) and ta.shape == (300,)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


def test_ties_take_the_first_max():
    # exactly representable points: the weighted energies tie exactly at
    # indices 1 and 4, and the farthest-point distances tie at 2 and 5
    x = np.array([[0, 0], [2, 0], [-2, 0], [0, 1], [2, 0], [-2, 0]], np.float32)
    w = np.ones(6, np.float32)
    want = np.asarray(j_init(jnp.asarray(x), jnp.asarray(w), 3))
    got = _farthest_point_init(torch.from_numpy(x)[None], torch.from_numpy(w)[None], 3)[0]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, x[[1, 2, 3]])


def test_empty_cluster_keeps_its_centroid():
    # two distinct weighted points and k=3: the third seed duplicates the
    # first, gets no points, and must keep its centroid in both packages
    x = np.array([[[1, 0], [1, 0], [0, 3], [5, 5]]], np.float32)
    w = np.array([[1, 1, 1, 0]], np.float32)
    jc, ja = j_kmeans(jnp.asarray(x), k=3, iters=5, weights=jnp.asarray(w))
    tc, ta = kmeans(torch.from_numpy(x), k=3, iters=5, weights=torch.from_numpy(w))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert np.isfinite(tc.numpy()).all()


@pytest.mark.parametrize("tau", [0.5, 0.25])
def test_soft_assignments_match_jax(rng, tau):
    x, w = _blobs(rng)
    cent = np.asarray(j_kmeans(jnp.asarray(x), k=2, iters=10, weights=jnp.asarray(w))[0])
    want = np.asarray(j_soft(jnp.asarray(x), jnp.asarray(cent), tau=tau))
    got = soft_assignments(torch.from_numpy(x), torch.tensor(cent), tau=tau).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)


def test_kmeans_rejects_other_ranks():
    with pytest.raises(ValueError, match=r"\[N,E\] or \[B,N,E\]"):
        kmeans(torch.zeros((1, 2, 3, 4)), k=2)
