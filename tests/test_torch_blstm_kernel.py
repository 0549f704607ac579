"""The BLSTM's recurrence kernels (``amss_tpu_torch/ops/kernels/blstm.py``
over ``csrc/blstm.cu`` up to ``MAX_ROWS`` rows and ``csrc/blstm_rows.cu``
past them) and the BLSTM's choice of path (``models/blstm.py::blstm_path``).

On the CPU: the path of each (device, dtype, grad mode, dropout, export,
rows, hidden size), as ``BLSTM.path`` gives it and as the ``trunk`` span
records it (``blstm_path``); DPRNN's rows at serving's batch take the path
their count gives; the wrapper launches the kernel of its row count (its C
entry point and launch counter, the launch itself stubbed); it refuses what
the kernels do not take, H past ``ROWS_MAX_HIDDEN`` past ``MAX_ROWS`` rows
included, and ``blstm_path`` sends to ``kernel`` what it takes (``takes``,
one rule for both); its CPU dispatch is the plain version, which equals
``BLSTM.loop`` bit for bit at either side of ``MAX_ROWS``; the benchmark's
``serve.blstm.kernel_share`` reads the spans' paths.

On the card (marked ``card``; ``python -m pytest
tests/test_torch_blstm_kernel.py --noconftest -m card``, since the card's
machine has no JAX for ``conftest.py``): the kernel at deep clustering's
serving shape (``[8, 765, 129]`` -> 600, two layers), at 1, 3, 64 and
``MAX_ROWS`` rows and at DPRNN's intra rows (128 x 32 steps, H = 128),
with prefix masks of random lengths and a row of length 0, a mask with holes
and no mask, against ``loop`` in float64 on the CPU and against ``packed`` on
the card, within 1e-5 of the output's largest magnitude; two runs
bit-identical; a mask with holes, which ``packed`` refuses, matches ``loop``;
a served call on the card takes the kernel, one launch a layer, and copies no
mask to the host, and its trunk matches the CPU's on the same features.  The
row-parallel kernel at DPRNN-TasNet's cell shapes (intra ``[3088, 250, 64]``
unmasked, inter ``[2000, 396, 64]`` with the cell's prefix mask) within
ROWS_TOL of ``loop`` in float64 and TOL of ``packed``; at c6's inter rows
``[256, 125, 128]`` with a prefix mask, a mask with holes, row counts that
are no multiple of a tile and ``MAX_ROWS + 1``, within TOL; two runs
bit-identical, one launch a layer on its own counter; a raise where
autograd records.

This file imports no JAX: the card's machine has none.
"""

import contextlib
import importlib.util
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from amss_tpu_torch.configs.recipes import c6_dual_path
from amss_tpu_torch.models.blstm import BLSTM, blstm_path
from amss_tpu_torch.models.dpcl import DPCLModel
from amss_tpu_torch.models.dprnn import DropoutKey
from amss_tpu_torch.ops.kernels import blstm as kernels
from amss_tpu_torch.ops.kernels.blstm import (
    MAX_BATCH, MAX_HIDDEN, MAX_ROWS, ROWS_MAX_HIDDEN, bilstm_layer, takes)
from amss_tpu_torch.utils import profiling
from amss_tpu_torch.utils.config import FrontConfig, ModelConfig, SeparatorConfig

torch.set_num_threads(2)

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
TOL = 1e-5  # of the output's largest magnitude: float32 sums in other orders
F32, BF16 = torch.float32, torch.bfloat16


def _blstm(n_in: int, hidden: int, layers: int, seed: int) -> BLSTM:
    m = BLSTM(n_in, hidden, layers)
    m.init_parameters(torch.Generator().manual_seed(seed))
    return m.eval()


def _mask(kind: str | None, b: int, t: int, seed: int) -> torch.Tensor | None:
    """None, prefix masks of random lengths (row 0 whole, row 1 empty where
    there is one) or a mask with holes."""
    if kind is None:
        return None
    gen = torch.Generator().manual_seed(seed)
    if kind == "holes":
        return (torch.rand(b, t, generator=gen) > 0.3).float()
    lengths = torch.randint(1, t + 1, (b,), generator=gen)
    lengths[0] = t
    if b > 1:
        lengths[1] = 0
    return (torch.arange(t)[None, :] < lengths[:, None]).float()


def _tiny_c1(dtype: str = "float32") -> DPCLModel:
    cfg = ModelConfig(kind="dpcl", front=FrontConfig(kind="stft", win=256, hop=64),
                      sep=SeparatorConfig(hidden=8, layers=1, embed_dim=5, compute_dtype=dtype),
                      nb_speakers=2)
    model = DPCLModel(cfg)
    model.init_parameters(torch.Generator().manual_seed(0))
    return model.eval()


def _weights(m: BLSTM, layer: int):
    return m._weights(layer, False), m._weights(layer, True)


# -- the CPU ------------------------------------------------------------------

# (device, compute dtype, grad, dropout, exporting, rows, hidden) -> path
DISPATCH = [
    (("cuda", F32, False, False, False, 8, 300), "kernel"),  # deep clustering's cell
    (("cuda", F32, False, False, False, 1, 300), "kernel"),
    (("cuda", F32, False, False, False, MAX_ROWS, MAX_HIDDEN), "kernel"),
    (("cuda", F32, False, False, False, MAX_ROWS + 1, 300), "packed"),
    (("cuda", F32, False, False, False, MAX_ROWS + 1, ROWS_MAX_HIDDEN), "kernel"),
    (("cuda", F32, False, False, False, 3088, 128), "kernel"),  # DPRNN-TasNet's cell
    (("cuda", F32, False, False, False, MAX_ROWS + 1, ROWS_MAX_HIDDEN + 1), "packed"),
    (("cuda", F32, False, False, False, MAX_BATCH + 1, ROWS_MAX_HIDDEN), "packed"),
    (("cuda", F32, True, False, False, 3088, 128), "packed"),  # training past MAX_ROWS
    (("cuda", F32, False, True, False, 3088, 128), "packed"),
    (("cuda", F32, False, False, False, 8, MAX_HIDDEN + 1), "packed"),
    (("cuda", F32, True, False, False, 8, 300), "packed"),  # training
    (("cuda", F32, True, True, False, 8, 300), "packed"),
    (("cuda", F32, False, True, False, 8, 300), "packed"),  # dropout without grad
    (("cuda", F32, False, False, True, 8, 300), "traced"),  # export
    (("cuda", F32, True, False, True, 8, 300), "traced"),
    (("cuda", BF16, False, False, False, 8, 300), "bf16"),
    (("cuda", BF16, True, True, False, 8, 300), "bf16"),
    (("cuda", BF16, False, False, True, 8, 300), "bf16"),
    (("cpu", F32, False, False, False, 8, 300), "loop"),
    (("cpu", F32, True, True, False, 8, 300), "loop"),
    (("cpu", F32, False, False, True, 8, 300), "traced"),
    (("cpu", BF16, False, False, False, 8, 300), "bf16"),
]


@pytest.mark.parametrize("case,want", DISPATCH)
def test_dispatch_table(case, want):
    device, compute, grad, drop, exporting, rows, hidden = case
    assert blstm_path(device, torch.float32, compute, rows, hidden, grad, drop, exporting) == want
    # BLSTM.path reads the same from a call: its device, rows, grad mode, key
    m = BLSTM(4, hidden, 1)
    x = types.SimpleNamespace(device=torch.device(device), dtype=torch.float32,
                              shape=(rows, 5, 4))
    rng = DropoutKey(0) if drop else None
    with torch.set_grad_enabled(grad):
        if exporting:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(torch.compiler, "is_exporting", lambda: True)
                assert m.path(x, 0.1, rng, compute) == want
        else:
            assert m.path(x, 0.1, rng, compute) == want


def test_dispatch_keeps_packed_for_other_input_dtypes_and_refuses_other_compute_dtypes():
    assert blstm_path("cuda", torch.float64, F32, 8, 300, False, False, False) == "packed"
    with pytest.raises(ValueError):
        blstm_path("cuda", F32, torch.float16, 8, 300, False, False, False)


@pytest.mark.parametrize("dtype,grad,want", [("float32", False, "loop"), ("float32", True, "loop"),
                                             ("bfloat16", False, "bf16")])
def test_trunk_span_records_the_path(dtype, grad, want):
    model = _tiny_c1(dtype)
    mix = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 2048)).astype(np.float32))
    fm = torch.ones((2, 29))
    fm[1, 20:] = 0.0
    with profiling.recording(), torch.set_grad_enabled(grad):
        model.separate(mix, frame_mask=fm)
    trunks = [r for r in profiling.spans() if r.name == profiling.TRUNK]
    assert [r.attrs.get("blstm_path") for r in trunks] == [want]


@pytest.mark.parametrize("bucket,want", [(8192, ("kernel", "kernel")),
                                         (65536, ("kernel", "kernel"))])
def test_dprnn_rows_at_serving_batch_take_the_path_of_their_count(bucket, want):
    """DPRNN's rows are B·P chunks (intra) and B·K frames of a chunk (inter):
    at serving's batch of 8, H = 128, both paths take a kernel whatever
    their count (the row-parallel one past MAX_ROWS)."""
    cfg = c6_dual_path("dprnn").model
    k = cfg.sep.chunk_frames
    t = cfg.front.frames_for(bucket)
    rows = (8 * -(-t // k), 8 * k)
    got = tuple(blstm_path("cuda", F32, F32, r, cfg.sep.hidden, False, False, False)
                for r in rows)
    assert got == want


@pytest.mark.parametrize("mask_kind", [None, "prefix", "holes"])
def test_cpu_dispatch_is_loop_bit_for_bit(mask_kind):
    m = _blstm(12, 16, 2, seed=1)
    x = torch.randn(5, 23, 12, generator=torch.Generator().manual_seed(2))
    mask = _mask(mask_kind, 5, 23, seed=3)
    with torch.no_grad():
        h = x
        for layer in range(m.layers):
            h = bilstm_layer(h, mask, *_weights(m, layer))
        assert torch.equal(h, m.loop(x, mask))
        assert torch.equal(h, m(x, mask))
    if mask is not None:  # a row with no valid frame outputs 0
        assert torch.equal(h * (1 - mask)[..., None], torch.zeros_like(h))


@pytest.mark.parametrize("mask_kind", [None, "prefix", "holes"])
def test_cpu_dispatch_past_max_rows_is_loop_bit_for_bit(mask_kind):
    m = _blstm(6, 8, 1, seed=4)
    b = MAX_ROWS + 1
    x = torch.randn(b, 7, 6, generator=torch.Generator().manual_seed(5))
    mask = _mask(mask_kind, b, 7, seed=6)
    with torch.no_grad():
        h = bilstm_layer(x, mask, *_weights(m, 0))
        assert torch.equal(h, m.loop(x, mask))
        assert torch.equal(h, m(x, mask))


class _Lib:
    """The kernels' library with its launches stubbed: records which entry
    point each call reached, with its three sizes (before the stream)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args[-4:-1]))
            return 0
        return entry


@pytest.mark.parametrize("rows,entry", [(1, "amss_blstm"), (MAX_ROWS, "amss_blstm"),
                                        (MAX_ROWS + 1, "amss_blstm_rows"),
                                        (1000, "amss_blstm_rows")])
def test_the_wrapper_launches_the_kernel_of_its_row_count(monkeypatch, rows, entry):
    lib = _Lib()
    monkeypatch.setattr(kernels, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    m = _blstm(6, 8, 1, seed=0)
    x = torch.randn(rows, 3, 6)
    counts = (bilstm_layer.launches, bilstm_layer.rows_launches)
    with torch.no_grad():
        out = kernels._launch(x, None, *_weights(m, 0))
    assert out.shape == (rows, 3, 16)
    assert lib.calls == [(entry, (rows, 3, 8))]
    many = entry == "amss_blstm_rows"
    assert (bilstm_layer.launches - counts[0], bilstm_layer.rows_launches - counts[1]) == (
        (0, 1) if many else (1, 0))


@pytest.mark.parametrize("rows,hidden,refused", [
    (MAX_ROWS + 1, ROWS_MAX_HIDDEN + 1, True), (MAX_ROWS + 1, MAX_HIDDEN, True),
    (MAX_ROWS + 1, ROWS_MAX_HIDDEN, False), (MAX_ROWS, ROWS_MAX_HIDDEN + 1, False)])
def test_the_wrapper_refuses_hidden_past_the_row_kernels_limit(rows, hidden, refused):
    m = _blstm(4, hidden, 1, seed=0)
    x = torch.randn(rows, 1, 4)
    with torch.no_grad():
        if refused:
            with pytest.raises(ValueError, match="past"):
                bilstm_layer(x, None, *_weights(m, 0))
        else:
            assert bilstm_layer(x, None, *_weights(m, 0)).shape == (rows, 1, 2 * hidden)


@pytest.mark.parametrize("rows,hidden", [
    (1, 1), (MAX_ROWS, MAX_HIDDEN), (MAX_ROWS, MAX_HIDDEN + 1), (MAX_ROWS + 1, ROWS_MAX_HIDDEN),
    (MAX_ROWS + 1, ROWS_MAX_HIDDEN + 1), (MAX_BATCH, ROWS_MAX_HIDDEN), (MAX_BATCH + 1, 1)])
def test_the_models_rule_is_what_the_wrapper_takes(rows, hidden):
    """``blstm_path`` sends a shape to ``kernel`` exactly where the wrapper's
    check takes it: both read ``takes``."""
    ws = (torch.zeros(4 * hidden, 2), torch.zeros(4 * hidden, hidden), torch.zeros(4 * hidden))
    try:
        kernels._check(torch.zeros(rows, 1, 2), None, ws, ws)
        taken = True
    except ValueError:
        taken = False
    assert taken == takes(rows, hidden)
    assert (blstm_path("cuda", F32, F32, rows, hidden, False, False, False) == "kernel") == taken


REFUSED = ["x float64", "x 2-D", "no steps", "rows past MAX_BATCH", "hidden past MAX_HIDDEN",
           "mask int64", "mask shape", "mask not contiguous", "w_ih shape", "w_hh float64",
           "w_hh not contiguous", "bias shape", "two weights"]


def _refused(case: str):
    m = _blstm(6, 8, 1, seed=0)
    fwd, bwd = _weights(m, 0)
    x = torch.randn(2, 5, 6)
    mask = torch.ones(2, 5)
    wide = _blstm(6, MAX_HIDDEN + 1, 1, seed=0) if case == "hidden past MAX_HIDDEN" else m
    return {
        "x float64": (x.double(), mask, fwd, bwd),
        "x 2-D": (x[0], None, fwd, bwd),
        "no steps": (x[:, :0], None, fwd, bwd),
        "rows past MAX_BATCH": (torch.empty(MAX_BATCH + 1, 1, 6), None, fwd, bwd),
        "hidden past MAX_HIDDEN": (x, mask, *_weights(wide, 0)),
        "mask int64": (x, mask.long(), fwd, bwd),
        "mask shape": (x, mask[:, :4], fwd, bwd),
        "mask not contiguous": (x, torch.ones(5, 2).T, fwd, bwd),
        "w_ih shape": (x, mask, (fwd[0][:, :5], fwd[1], fwd[2]), bwd),
        "w_hh float64": (x, mask, fwd, (bwd[0], bwd[1].double(), bwd[2])),
        "w_hh not contiguous": (x, mask, (fwd[0], fwd[1].T.contiguous().T, fwd[2]), bwd),
        "bias shape": (x, mask, fwd, (bwd[0], bwd[1], bwd[2][:-1])),
        "two weights": (x, mask, fwd[:2], bwd),
    }[case]


@pytest.mark.parametrize("case", REFUSED)
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    args = _refused(case)
    with pytest.raises(ValueError):
        bilstm_layer(*args)


def _load_metric(name: str):
    if str(BENCH) not in sys.path:  # the readers import ``bm``
        sys.path.insert(0, str(BENCH))
    spec = importlib.util.spec_from_file_location(name, BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Spans:
    def __init__(self, trunks):
        self.trunks = trunks

    def under(self, root, name):
        assert (root, name) == ("serve.job", "trunk")
        return self.trunks


@pytest.mark.parametrize("paths,want", [(["kernel"] * 4, 100.0), (["kernel", "packed"], 50.0),
                                        (["packed", None], 0.0), ([None, None], None), ([], None)])
def test_kernel_share_reader(monkeypatch, paths, want):
    metric = _load_metric("serve.blstm.kernel_share")
    trunks = [types.SimpleNamespace(attrs={} if p is None else {"blstm_path": p}) for p in paths]
    monkeypatch.setattr(metric.port_spans, "read", lambda r: _Spans(trunks))
    assert metric.read(object()) == want
    monkeypatch.setattr(metric.port_spans, "read", lambda r: None)
    assert metric.read(object()) is None


# -- the card -----------------------------------------------------------------

@pytest.fixture
def card():
    """The CUDA device of a test marked ``card``; skips where there is none
    (decided when the test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: python -m pytest "
                    "tests/test_torch_blstm_kernel.py --noconftest -m card)")
    return torch.device("cuda")


def _loop64(m: BLSTM, x: torch.Tensor, mask) -> torch.Tensor:
    """``loop`` in float64 on the CPU, from the same float32 weights."""
    m64 = BLSTM(m.lstm.input_size, m.hidden, m.layers).double()
    m64.load_state_dict({k: v.double().cpu() for k, v in m.state_dict().items()})
    return m64.loop(x.double().cpu(), None if mask is None else mask.double().cpu())


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


# (rows, steps, inputs, hidden, layers): the serving cell's, then 1, 3, 64
# rows and MAX_ROWS (clusters in waves)
SHAPES = [(8, 765, 129, 300, 2), (1, 200, 129, 300, 2), (3, 150, 40, 300, 1),
          (64, 120, 129, 300, 2), (MAX_ROWS, 60, 129, 300, 1)]
# DPRNN's intra rows at serving's batch of 8 in a bucket of 8192 samples
DPRNN_INTRA = (128, 32, 128, 128, 1)


def _held_on_card(card, shape, mask_kind, against_packed: bool) -> None:
    """The kernel at ``shape`` with a ``mask_kind`` mask: its launches, two
    runs bit-identical, within TOL of ``loop`` in float64, and of ``packed``
    where ``against_packed`` (which refuses a mask with holes)."""
    b, t, n_in, hd, layers = shape
    m = _blstm(n_in, hd, layers, seed=b + t)
    x = torch.randn(b, t, n_in, generator=torch.Generator().manual_seed(t))
    mask = _mask(mask_kind, b, t, seed=b)
    mc = m.to(card)
    xc, mcard = x.to(card), None if mask is None else mask.to(card)
    before = (bilstm_layer.launches, bilstm_layer.rows_launches)
    with torch.no_grad():
        assert mc.path(xc) == "kernel"
        got = mc(xc, mcard)
        again = mc(xc, mcard)
        torch.cuda.synchronize()
        assert (bilstm_layer.launches - before[0], bilstm_layer.rows_launches - before[1]) == (
            (0, 2 * layers) if b > MAX_ROWS else (2 * layers, 0))
        assert torch.equal(got, again)
        assert _err(got, _loop64(m, x, mask)) <= TOL
        if mask_kind == "holes":
            with pytest.raises(ValueError):
                mc.packed(xc, mcard)
        elif against_packed:
            assert _err(got, mc.packed(xc, mcard)) <= TOL
    if mask is not None:
        assert torch.equal(got.cpu() * (1 - mask)[..., None], torch.zeros(b, t, 2 * hd))


@pytest.mark.card
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mask_kind", ["prefix", "holes", None])
def test_kernel_matches_loop_and_packed_on_the_card(card, shape, mask_kind):
    _held_on_card(card, shape, mask_kind, against_packed=True)


@pytest.mark.card
@pytest.mark.parametrize("mask_kind", ["prefix", "holes", None])
def test_kernel_matches_loop_at_dprnn_intra_rows_on_the_card(card, mask_kind):
    """Held against ``packed`` with the prefix mask alone, the one DPRNN's
    serving gives it.  Unmasked, ``packed`` runs cuDNN's unpacked algorithm,
    which lay 1.004e-5 of the peak from the kernel at this shape on an H100
    (PERF.md, PR 22), with the kernel within TOL of ``loop`` in float64."""
    _held_on_card(card, DPRNN_INTRA, mask_kind, against_packed=mask_kind == "prefix")


@pytest.mark.card
def test_wrapper_raises_where_autograd_records_on_the_card(card):
    m = _blstm(6, 8, 1, seed=0).to(card)
    x = torch.randn(2, 5, 6, device=card, requires_grad=True)
    with pytest.raises(RuntimeError):
        bilstm_layer(x, None, *_weights(m, 0))


@pytest.mark.card
def test_wrapper_raises_where_autograd_records_past_max_rows_on_the_card(card):
    m = _blstm(6, 8, 1, seed=0).to(card)
    x = torch.randn(MAX_ROWS + 1, 5, 6, device=card, requires_grad=True)
    before = bilstm_layer.rows_launches
    with pytest.raises(RuntimeError):
        bilstm_layer(x, None, *_weights(m, 0))
    assert bilstm_layer.rows_launches == before


# the row-parallel kernel: DPRNN-TasNet's cell shapes (rows, steps, inputs,
# hidden, layers) with the cell's masks: intra unmasked, inter valid on its
# first 386 of 396 chunks in every row.  Its error from ``loop`` in float64
# there is held to ROWS_TOL of the peak, as cuDNN's packed path's (3.6e-7)
CELL_SHAPES = {"intra": ((3088, 250, 64, 128, 1), None), "inter": ((2000, 396, 64, 128, 1), 386)}
ROWS_TOL = 1e-6
# c6's DPRNN inter rows at a serving batch of 8 (masked), rows no multiple of
# a tile, MAX_ROWS + 1, a hidden size no multiple of 4
ROW_SHAPES = [(256, 125, 128, 128, 1), (1000, 40, 64, 128, 1), (MAX_ROWS + 1, 60, 64, 128, 1),
              (3001, 20, 64, 128, 1), (300, 30, 40, 98, 2)]


@pytest.mark.card
@pytest.mark.parametrize("name", list(CELL_SHAPES))
def test_row_kernel_at_the_cells_shapes_on_the_card(card, name):
    (b, t, n_in, hd, layers), valid = CELL_SHAPES[name]
    m = _blstm(n_in, hd, layers, seed=b)
    x = torch.randn(b, t, n_in, generator=torch.Generator().manual_seed(t))
    mask = None if valid is None else (torch.arange(t)[None, :] < valid).float().expand(b, t)
    mask = None if mask is None else mask.contiguous()
    lengths = torch.full((b,), t if valid is None else valid, dtype=torch.int64)
    mc, xc = m.to(card), x.to(card)
    mcard = None if mask is None else mask.to(card)
    before = bilstm_layer.rows_launches
    with torch.no_grad():
        assert mc.path(xc) == "kernel"
        got = mc(xc, mcard)
        again = mc(xc, mcard)
        torch.cuda.synchronize()
        assert bilstm_layer.rows_launches - before == 2 * layers
        assert torch.equal(got, again)
        assert _err(got, mc.packed(xc, mcard, lengths)) <= TOL
    assert _err(got, _loop64(m, x, mask)) <= ROWS_TOL


@pytest.mark.card
@pytest.mark.parametrize("shape", ROW_SHAPES)
@pytest.mark.parametrize("mask_kind", ["prefix", "holes"])
def test_row_kernel_matches_loop_and_packed_on_the_card(card, shape, mask_kind):
    _held_on_card(card, shape, mask_kind, against_packed=True)


@pytest.mark.card
def test_a_served_call_takes_the_kernel_and_copies_no_mask(card):
    model = _tiny_c1().to(card)
    mix = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 2048)).astype(np.float32))
    fm = torch.ones((2, 29), device=card)
    fm[1, 20:] = 0.0
    before = bilstm_layer.launches
    with profiling.recording(), torch.no_grad():
        est = model.separate(mix.to(card), frame_mask=fm)
    records = profiling.spans()
    assert [r.attrs.get("blstm_path") for r in records if r.name == profiling.TRUNK] == ["kernel"]
    assert not [r for r in records if r.name == profiling.SYNC_LENGTHS]
    assert bilstm_layer.launches - before == model.cfg.sep.layers
    assert torch.isfinite(est).all()
    # the trunk on the same features, card against CPU (the features
    # themselves differ in near-silent bins, ROADMAP C.3)
    cpu = _tiny_c1()
    with torch.no_grad():
        feats = cpu.front.features(cpu.front.encode(mix)[0])
        got = model.trunk(feats.to(card), fm)
        want = cpu.trunk(feats, fm.cpu())
    assert _err(got, want) <= TOL
