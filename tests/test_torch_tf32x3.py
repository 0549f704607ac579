"""The numerics of the kernels' 3xTF32 design, emulated in numpy on the CPU.

``csrc/tf32x3.cuh`` rounds each FP32 operand to TF32 as ``cvt.rna`` does
(to nearest, ties away from zero, 10 mantissa bits kept), splits it into
big = rna(a) and small = rna(a - big), and sums small·big + big·small +
big·big in FP32.  Here the same split feeds float32 matrix products, and the
result is held against the port's plain versions at the main path's widths
(256/64, K = 258) with the tolerances ``chip_smoke.py`` applies to the
kernels: 2e-3 for B1's STFT output, 2e-4 for B2.  Plain 1xTF32 is reported
beside it, to show why one TF32 product is not enough.

The test also checks the bank arithmetic of the kernels' shared-memory
layouts: the A- and B-fragment loads of one ``mma.sync`` hit 32 banks."""

import numpy as np
import pytest
import torch

from amss_tpu_torch.models.front import STFTFrontEnd
from amss_tpu_torch.ops.framing import frame_signal, overlap_add
from amss_tpu_torch.ops.kernels.framed_matmul import framed_matmul_ref, stft_basis
from amss_tpu_torch.ops.kernels.ola import decode_ola_ref
from amss_tpu_torch.utils.config import FrontConfig

torch.set_num_threads(2)

WIN, HOP = 256, 64
TOL_STFT, TOL_OLA = 2e-3, 2e-4


def tf32_rna(a: np.ndarray) -> np.ndarray:
    """float32 -> TF32 as ``cvt.rna.tf32.f32``: add half a unit of the 13
    dropped bits to the magnitude, then clear them (ties away from zero)."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    big = tf32_rna(a)
    return big, tf32_rna(a.astype(np.float32) - big)


def matmul_tf32x3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    (ab, asm), (bb, bsm) = split(a), split(b)
    return (asm @ bb) + (ab @ bsm) + (ab @ bb)


def matmul_tf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return tf32_rna(a) @ tf32_rna(b)


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0**-10)  # TF32 spacing above 1
    a = np.array([1 + ulp / 4, 1 + ulp / 2, 1 + 3 * ulp / 4, -(1 + ulp / 2), 3.0], np.float32)
    want = np.array([one, 1 + ulp, 1 + ulp, -(1 + ulp), 3.0], np.float32)
    np.testing.assert_array_equal(tf32_rna(a), want)
    big, small = split(np.float32([np.pi]))
    assert tf32_rna(big)[0] == big[0] and tf32_rna(small)[0] == small[0]
    assert abs(float(big[0]) + float(small[0]) - np.float32(np.pi)) < 2.0**-21


def _signal(seed: int, batch: int, t: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((batch, t)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("batch,t", [(1, 3001), (2, 4000)])
def test_b1_stft_in_tf32x3_within_kernel_tolerance(batch, t):
    x = _signal(batch, batch, t)
    basis = stft_basis(WIN)
    want = framed_matmul_ref(torch.from_numpy(x), torch.from_numpy(basis), HOP).numpy()
    frames = frame_signal(torch.from_numpy(x), WIN, HOP).numpy()
    err3 = float(np.abs(matmul_tf32x3(frames, basis) - want).max())
    err1 = float(np.abs(matmul_tf32(frames, basis) - want).max())
    # about 6e-6 for 3xTF32 and 2.4e-3 to 2.6e-3 for 1xTF32, at outputs up to 9.5
    assert err1 > TOL_STFT, f"1xTF32 error {err1:.3e} unexpectedly within {TOL_STFT}"
    assert err3 <= TOL_STFT, f"3xTF32 error {err3:.3e} (1xTF32 {err1:.3e}), tol {TOL_STFT}"
    assert err3 * 50 < err1, f"3xTF32 {err3:.3e} is not far below 1xTF32 {err1:.3e}"


@pytest.mark.parametrize("batch,t,length", [(1, 3001, 3001), (2, 4000, 3900)])
def test_b2_istft_in_tf32x3_within_kernel_tolerance(batch, t, length):
    x = _signal(10 + batch, batch, t)
    codes = framed_matmul_ref(torch.from_numpy(x), torch.from_numpy(stft_basis(WIN)), HOP)
    syn = STFTFrontEnd(FrontConfig()).synthesis_basis
    want = decode_ola_ref(codes, syn, HOP, length).numpy()

    def ola(frames: np.ndarray) -> np.ndarray:
        return overlap_add(torch.from_numpy(frames), HOP, length=length).numpy()

    err3 = float(np.abs(ola(matmul_tf32x3(codes.numpy(), syn.numpy())) - want).max())
    err1 = float(np.abs(ola(matmul_tf32(codes.numpy(), syn.numpy())) - want).max())
    # about 8e-7 for 3xTF32 and 2.3e-4 for 1xTF32, at outputs up to 1.7
    assert err1 > TOL_OLA, f"1xTF32 error {err1:.3e} unexpectedly within {TOL_OLA}"
    assert err3 <= TOL_OLA, f"3xTF32 error {err3:.3e} (1xTF32 {err1:.3e}), tol {TOL_OLA}"
    assert err3 * 50 < err1, f"3xTF32 {err3:.3e} is not far below 1xTF32 {err1:.3e}"


@pytest.mark.parametrize("hop", [8, 16, 24, 32, 64, 128, 200])
def test_b1_skewed_span_feeds_a_fragments_without_bank_conflicts(hop):
    # framed_matmul.cu stores span sample s at s + 4*(s // hop); lane (g, t)
    # reads frame f0 + g, sample w + t (w % 8 == 0), and frame f0 + g + 8
    for w in range(0, 4 * hop, 8):
        for f0 in (0, 16):
            for dt in (0, 4):
                for dg in (0, 8):
                    s = [(f0 + dg + g) * hop + w + tq + dt for g in range(8) for tq in range(4)]
                    banks = {(v + 4 * (v // hop)) % 32 for v in s}
                    assert len(banks) == 32, (hop, w, f0, dt, dg)


@pytest.mark.parametrize("ld", [36, 20, 12, 104, 72])
def test_staged_row_strides_are_free_of_bank_conflicts(ld):
    if ld % 8 == 4:  # A fragments of decode_ola.cu: lane (g, t) reads row g, column t
        banks = {(g * ld + tq) % 32 for g in range(8) for tq in range(4)}
    else:  # B fragments of both kernels: lane (g, t) reads row t, column g
        banks = {(tq * ld + g) % 32 for g in range(8) for tq in range(4)}
    assert len(banks) == 32
