"""B1 and B2: the port's plain versions and CPU dispatch against the JAX
package's Pallas kernels (interpret mode) and their jnp references.

Tolerances are those of tests/test_pallas_kernels.py: atol 2e-4, and 2e-3
for STFT-scaled outputs (float32 sums of 256 terms in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amss_tpu.ops.framing import frame_signal as jframe
from amss_tpu.ops.framing import overlap_add as jola
from amss_tpu.ops.pallas.framed_matmul import framed_matmul as jfm
from amss_tpu.ops.pallas.framed_matmul import pallas_profitable, pallas_stft_ri
from amss_tpu.ops.pallas.ola import pallas_decode_ola, pallas_overlap_add
from amss_tpu.ops.stft import stft_ri as jstft
from amss_tpu_torch.ops.framing import frame_signal, overlap_add
from amss_tpu_torch.ops.kernels.build import c_ints
from amss_tpu_torch.ops.kernels.framed_matmul import (
    framed_matmul, framed_matmul_ref, profitable, stft_basis, stft_ri)
from amss_tpu_torch.ops.kernels.ola import decode_ola, decode_ola_ref, overlap_add_via_kernel

torch.set_num_threads(2)


@pytest.mark.parametrize("win,hop,k,t", [(256, 64, 258, 4000), (128, 32, 65, 3000), (32, 16, 64, 2048)])
def test_framed_matmul_matches_pallas_and_jnp(rng, win, hop, k, t):
    x = rng.standard_normal((2, t)).astype(np.float32)
    basis = rng.standard_normal((win, k)).astype(np.float32)
    pallas = np.asarray(jfm(jnp.asarray(x), jnp.asarray(basis), hop=hop, interpret=True, force=True))
    plain = np.asarray(jframe(jnp.asarray(x), win, hop) @ jnp.asarray(basis))
    ref = framed_matmul_ref(torch.from_numpy(x), torch.from_numpy(basis), hop).numpy()
    via = framed_matmul(torch.from_numpy(x), torch.from_numpy(basis), hop, force=True).numpy()
    assert ref.shape == pallas.shape == via.shape
    np.testing.assert_allclose(ref, pallas, atol=2e-4)
    np.testing.assert_allclose(ref, plain, atol=2e-4)
    np.testing.assert_array_equal(via, ref)


@pytest.mark.parametrize("win,hop", [(256, 64), (128, 32), (32, 16)])
def test_stft_ri_matches_pallas_stft_and_jnp(rng, win, hop):
    x = rng.standard_normal((2, 4096)).astype(np.float32)
    re, im = stft_ri(torch.from_numpy(x), win, hop)
    for jre, jim in (pallas_stft_ri(jnp.asarray(x), win, hop, interpret=True),
                     jstft(jnp.asarray(x), win, hop)):
        np.testing.assert_allclose(re.numpy(), np.asarray(jre), atol=2e-3)
        np.testing.assert_allclose(im.numpy(), np.asarray(jim), atol=2e-3)


def test_stft_basis_is_the_folded_dft():
    from amss_tpu.ops.stft import dft_matrices, hann_window

    c, s = dft_matrices(256)
    want = hann_window(256)[:, None] * np.concatenate([c, s], axis=1)
    np.testing.assert_array_equal(stft_basis(256), want)


@pytest.mark.parametrize("nf,k,win,hop,length", [
    (61, 258, 256, 64, None),    # the iSTFT shape, cut short
    (40, 96, 256, 128, None),    # hop 128
    (30, 16, 128, 32, 900),      # trim
    (50, 32, 128, 32, 2000),     # zero-pad past (nf-1)*hop + win = 1696
])
def test_decode_ola_matches_pallas_and_jnp(rng, nf, k, win, hop, length):
    codes = rng.standard_normal((2, nf, k)).astype(np.float32)
    basis = rng.standard_normal((k, win)).astype(np.float32)
    pallas = np.asarray(pallas_decode_ola(jnp.asarray(codes), jnp.asarray(basis), hop=hop,
                                          length=length, interpret=True, force=True))
    plain = np.asarray(jola(jnp.asarray(codes) @ jnp.asarray(basis), hop, length=length))
    ref = decode_ola_ref(torch.from_numpy(codes), torch.from_numpy(basis), hop, length).numpy()
    via = decode_ola(torch.from_numpy(codes), torch.from_numpy(basis), hop, length=length,
                     force=True).numpy()
    assert ref.shape == pallas.shape == via.shape
    np.testing.assert_allclose(ref, pallas, atol=2e-4)
    np.testing.assert_allclose(ref, plain, atol=2e-4)
    np.testing.assert_array_equal(via, ref)


@pytest.mark.parametrize("win,hop,length", [(128, 32, None), (256, 64, None), (256, 64, 3000)])
def test_overlap_add_via_kernel_matches_pallas(rng, win, hop, length):
    frames = rng.standard_normal((2, 40, win)).astype(np.float32)
    want = np.asarray(pallas_overlap_add(jnp.asarray(frames), hop=hop, length=length,
                                         interpret=True))
    got = overlap_add_via_kernel(torch.from_numpy(frames), hop, length=length).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(overlap_add(torch.from_numpy(frames), hop, length).numpy(),
                               want, atol=1e-4)


def test_frame_signal_matches_jax(rng):
    x = rng.standard_normal((3, 1000)).astype(np.float32)
    np.testing.assert_array_equal(frame_signal(torch.from_numpy(x), 256, 64).numpy(),
                                  np.asarray(jframe(jnp.asarray(x), 256, 64)))


@pytest.mark.parametrize("win,hop", [(256, 64), (32, 16), (256, 128), (512, 128), (128, 32)])
def test_dispatch_gate_matches_pallas_profitable(win, hop):
    assert profitable(win, hop) == pallas_profitable(win, hop)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros((2, 4096))
    with pytest.raises(ValueError, match="win%hop"):
        framed_matmul(x, torch.zeros((256, 8)), 48, force=True)
    with pytest.raises(TypeError, match="float32"):
        framed_matmul(x.double(), torch.zeros((256, 8), dtype=torch.float64), 64)
    with pytest.raises(ValueError, match="shorter than window"):
        framed_matmul(torch.zeros((2, 100)), torch.zeros((256, 8)), 64)
    with pytest.raises(ValueError, match="codes"):
        decode_ola(torch.zeros((2, 10, 8)), torch.zeros((9, 256)), 64)
    with pytest.raises(ValueError, match="32-bit"):
        c_ints(2, 2**31)
