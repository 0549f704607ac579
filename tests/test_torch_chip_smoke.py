"""chip_smoke.py's bookkeeping, on the CPU: the two bounds it holds the kernels
to, and how it reads the compiler's report and the machine code."""

import pytest
import torch

import chip_smoke

torch.set_num_threads(2)

B1 = dict(flops=2.0 * 8 * 997 * 258 * 256, nbytes=4.0 * (8 * 64000 + 256 * 258 + 8 * 997 * 258))
B2 = dict(flops=2.0 * 16 * 997 * 258 * 256, nbytes=4.0 * (16 * 997 * 258 + 258 * 256 + 16 * 64000))


@pytest.mark.parametrize("work,tc_us,fp32_us", [(B1, 6.385, 15.725), (B2, 12.771, 31.451)])
def test_bounds_at_the_main_path(work, tc_us, fp32_us):
    b = chip_smoke.bound(**work)
    assert b["bound_ms"] * 1e3 == pytest.approx(tc_us, abs=1e-3)
    assert b["bound_fp32_ms"] * 1e3 == pytest.approx(fp32_us, abs=1e-3)
    assert b["bound_by"] == b["bound_fp32_by"] == "operations"


def test_bound_by_bytes_when_the_work_is_light():
    b = chip_smoke.bound(flops=1e6, nbytes=1e9)
    assert b["bound_by"] == b["bound_fp32_by"] == "bytes"
    assert b["bound_ms"] == b["bound_fp32_ms"] == pytest.approx(1e9 / 3.35e12 * 1e3)


PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN2_17decode_ola_kernelILi32EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN2_17decode_ola_kernelILi32EEEvPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 191 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN2_17decode_ola_kernelILi8EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN2_17decode_ola_kernelILi8EEEvPKf
    16 bytes stack frame, 16 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
"""

SASS = """\
\t\tFunction : _ZN2_17decode_ola_kernelILi32EEEvPKf
        /*6040*/                   HMMA.1688.F32.TF32 R52, R44.reuse, R62, RZ ;
        /*6050*/                   FSETP.GEU.AND P4, PT, |R74|, +INF , PT ;
        /*6060*/                   HMMA.1688.F32.TF32 R56, R44, R8, RZ ;
\t\tFunction : _ZN2_17decode_ola_kernelILi8EEEvPKf
        /*0040*/                   HMMA.1688.F32.TF32 R52, R44.reuse, R62, RZ ;
"""


def test_ptxas_report_and_sass_counts_are_read_per_function(monkeypatch):
    ptxas = chip_smoke.ptxas_report(PTXAS)
    assert ptxas == {"_ZN2_17decode_ola_kernelILi32EEEvPKf": {"spill_bytes": 0, "registers": 191},
                     "_ZN2_17decode_ola_kernelILi8EEEvPKf": {"spill_bytes": 24, "registers": 128}}
    monkeypatch.setattr(chip_smoke, "run", lambda cmd: SASS)
    sass = chip_smoke.sass_counts("lib.so", "/usr/local/cuda/bin/nvcc")
    assert sass["_ZN2_17decode_ola_kernelILi32EEEvPKf"] == {"HMMA": 2, "HGMMA": 0}
    facts = chip_smoke.kernel_facts(ptxas, sass, "decode_ola_kernel")
    # the worst instance for registers and spills, the fewest tensor-core instructions
    assert facts == dict(instances=2, registers=191, spill_bytes=24, HMMA=1, HGMMA=0)
    with pytest.raises(AssertionError, match="framed_matmul_kernel"):
        chip_smoke.kernel_facts(ptxas, sass, "framed_matmul_kernel")


def test_fit_launches_count_the_quality_summary():
    """A validation runs its loss batches (two B1 each), the image summaries
    (three B1, one B2) and, with valid_quality, one separate (a B1, a B2)."""
    import dataclasses

    from amss_tpu_torch.configs.recipes import c1_stft_dpcl

    r = c1_stft_dpcl(steps=200, valid_every=50)
    step, want = chip_smoke._fit_launches(r, 200)
    assert step == {"framed_matmul": 2, "decode_ola": 0}
    assert want == {"framed_matmul": 400 + 4 * (2 * r.train.valid_steps + 3), "decode_ola": 4}
    quality = dataclasses.replace(r, train=dataclasses.replace(r.train, valid_quality=True))
    assert chip_smoke._fit_launches(quality, 200) == (
        step, {"framed_matmul": want["framed_matmul"] + 4, "decode_ola": 8})


def test_rows_against_live_name_the_seeding_tie_and_refuse_the_rest():
    """Phase 24's per-row check: a row far from the live path passes only
    where its embeddings agree (k-means' seeding tie, ROADMAP C.2)."""
    import numpy as np

    rng = np.random.default_rng(0)
    live = rng.standard_normal((3, 2, 400)).astype(np.float32)
    got = live.copy()
    got[1] = live[1, ::-1] + rng.standard_normal((2, 400)).astype(np.float32)
    emb_err = np.zeros(3)
    rows = chip_smoke._rows_against_live("rows", got, live, emb_err)
    assert rows["rows_below"] == [1] and rows["min_db"] < chip_smoke.AGREE_MIN_DB
    emb_err[1] = 10 * chip_smoke.EMBED_TOL
    with pytest.raises(AssertionError, match=r"rows \[1\] differ"):
        chip_smoke._rows_against_live("rows", got, live, emb_err)
