"""Profiling and debug helpers (``amss_tpu_torch/utils/profiling.py``,
``utils/debug.py``) on the CPU.

``FlopCounterMode`` over a tiny c1 ``separate`` at STFT 256/64, where the
gate sends the STFT and its inverse through the kernels' operators, must
count what the plain versions' matrix products count: the operators'
registered formulas (2·B·NF·win·K) stand for those products.  ``trace``
writes a Chrome trace that carries the port's spans.  ``check_finite`` and
``nan_guard`` raise where the JAX package's do."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from amss_tpu.utils import debug as jdebug
from amss_tpu_torch.models.dpcl import DPCLModel
from amss_tpu_torch.ops.kernels import framed_matmul as fm_mod
from amss_tpu_torch.ops.kernels import ola as ola_mod
from amss_tpu_torch.ops.kernels.framed_matmul import framed_matmul
from amss_tpu_torch.ops.kernels.ola import decode_ola
from amss_tpu_torch.utils import profiling
from amss_tpu_torch.utils.config import FrontConfig, ModelConfig, SeparatorConfig
from amss_tpu_torch.utils.debug import check_finite, nan_guard
from amss_tpu_torch.utils.profiling import StepTimer, span, spans, trace

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def c1():
    cfg = ModelConfig(kind="dpcl", front=FrontConfig(kind="stft", win=256, hop=64),
                      sep=SeparatorConfig(hidden=8, layers=1, embed_dim=5), nb_speakers=2)
    model = DPCLModel(cfg)
    model.init_parameters(torch.Generator().manual_seed(0))
    return model.eval()


def _flops(fn, *args, **kwargs) -> int:
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    return counter.get_total_flops()


def test_operator_flops_are_their_formulas(rng):
    x = torch.from_numpy(rng.standard_normal((3, 2048)).astype(np.float32))
    basis = torch.from_numpy(rng.standard_normal((256, 258)).astype(np.float32))
    nf = 1 + (2048 - 256) // 64
    assert _flops(framed_matmul, x, basis, 64) == 2 * 3 * nf * 256 * 258
    codes = torch.from_numpy(rng.standard_normal((3, nf, 258)).astype(np.float32))
    assert _flops(decode_ola, codes, basis.T, 64, length=2048) == 2 * 3 * nf * 258 * 256


def test_separate_flops_equal_with_the_plain_versions(rng, c1, monkeypatch):
    mix = torch.from_numpy(rng.standard_normal((2, 4096)).astype(np.float32))
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        c1.separate(mix)
    with_ops = counter.get_total_flops()
    per_op = counter.get_flop_counts()["Global"]
    assert per_op[torch.ops.amss.framed_matmul] > 0 and per_op[torch.ops.amss.decode_ola] > 0

    monkeypatch.setattr(fm_mod, "profitable", lambda win, hop: False)
    monkeypatch.setattr(ola_mod, "profitable", lambda win, hop: False)
    with torch.no_grad():
        plain = _flops(c1.separate, mix)
    assert with_ops == plain > 0


def test_mfu_and_step_timer():
    """The wall-clock peak share and the op-by-op count are gone (the
    benchmark counts operations analytically); ``StepTimer`` stays."""
    for gone in ("mfu", "compiled_flops", "H100_PEAK_FLOPS", "annotate"):
        assert not hasattr(profiling, gone)
    timer = StepTimer()
    assert timer.stats() == {}
    timer.start()
    for _ in range(4):
        timer.tick()
    s = timer.stats()
    assert s["n"] == 4 and 0 <= s["p50_s"] <= s["p95_s"]


def test_trace_writes_a_chrome_trace_with_spans(tmp_path):
    with trace(str(tmp_path), device="cpu"):
        with span("train.step", step=0):
            with span("train.forward", device="cpu"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.load(open(os.path.join(tmp_path, "trace.json")))["traceEvents"]
    got = {e["name"]: e for e in events
           if e.get("cat") == "user_annotation" and e.get("name", "").startswith("train.")}
    assert set(got) == {"train.step", "train.forward"}
    outer, inner = got["train.step"], got["train.forward"]
    assert float(outer["ts"]) <= float(inner["ts"])
    assert float(inner["ts"]) + float(inner["dur"]) <= float(outer["ts"]) + float(outer["dur"])
    assert list(spans()) == []  # trace() dropped what it kept: the trace holds it


def test_sepformer_opens_its_stack_spans_under_trunk():
    """A padded batch of SepFormer (chunks of 8 frames at hop 4) opens
    ``sepformer.intra`` and ``sepformer.inter`` once a repeat each, inside
    ``trunk``, with the grid's chunks and the rows' own (their count read on
    the device, resolved by ``spans()``)."""
    from amss_tpu_torch.models.sepformer import SepFormerModel

    cfg = ModelConfig(kind="sepformer",
                      front=FrontConfig(kind="conv", n_filters=8, filter_len=16, stride=8, pool=1),
                      sep=SeparatorConfig(hidden=8, trunk="sepformer", heads=2, expansion=2,
                                          blocks=1, repeats=2, chunk_frames=8), nb_speakers=2)
    model = SepFormerModel(cfg)
    model.init_parameters(torch.Generator().manual_seed(0))
    lengths = (800, 400, 200)  # 99, 49, 24 frames: 26, 14 and 8 chunks of their own
    mix = torch.zeros(3, 800)
    fm = torch.zeros(3, cfg.front.frames_for(800))
    for i, n in enumerate(lengths):
        mix[i, :n] = torch.randn(n, generator=torch.Generator().manual_seed(i))
        fm[i, :cfg.front.frames_for(n)] = 1.0
    spans()
    with profiling.recording():
        model.eval().separate(mix, frame_mask=fm)
    kept = {r.id: r for r in spans()}
    for name in ("sepformer.intra", "sepformer.inter"):
        got = [r for r in kept.values() if r.name == name]
        assert len(got) == 2
        for r in got:
            assert kept[r.parent].name == "trunk"
            assert r.attrs == {"chunks": 3 * 26, "rows": 3, "valid_chunks": 26 + 14 + 8}
            assert isinstance(r.attrs["valid_chunks"], int)
    with profiling.recording():
        model.separate(mix)  # no mask: every chunk is a row's own
    got = [r for r in spans() if r.name == "sepformer.inter"]
    assert [r.attrs["valid_chunks"] for r in got] == [3 * 26] * 2


def test_trace_of_the_card_without_kernels_raises(tmp_path):
    """A CUDA trace that recorded no kernel raises and writes nothing (here
    the block runs on the CPU, so the card records none)."""
    with pytest.raises(RuntimeError, match="no CUDA kernel"):
        with trace(str(tmp_path / "t"), device="cuda"):
            torch.ones(8) + 1
    assert not os.path.exists(tmp_path / "t" / "trace.json")


@pytest.mark.parametrize("bad", [np.nan, np.inf], ids=["nan", "inf"])
def test_check_finite_raises_as_the_jax_packages(bad):
    tree = {"a": torch.ones(3), "b": [np.zeros(2), {"c": np.array([1.0, bad])}]}
    with pytest.raises(FloatingPointError, match="leaf 2"):
        check_finite(tree, "metrics")
    with pytest.raises(FloatingPointError, match="leaf 2"):
        jdebug.check_finite({"a": jnp.ones(3), "b": [jnp.zeros(2), {"c": jnp.array([1.0, bad])}]})
    check_finite({"a": torch.ones(3), "b": np.zeros(2)})


def test_nan_guard_names_the_first_op():
    x = torch.tensor([1.0, -1.0])
    with nan_guard():
        y = torch.exp(x) + 1  # finite ops pass
        with pytest.raises(FloatingPointError, match="aten.log"):
            torch.log(x - 0.5) * 2
    assert torch.isfinite(y).all()
    torch.log(x)  # outside the guard nothing is checked
