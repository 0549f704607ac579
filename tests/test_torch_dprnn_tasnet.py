"""DPRNN-TasNet (``models/sepformer.py::DPRNNTasNetModel``) on the CPU at
tiny widths (N 8, L 2 at stride 1, D 6, chunks of 8 at hop 4, BLSTMs of 6
cells a direction, 2 blocks) against the plain reference of the benchmark
(``benchmark/reference/dprnn.py``, loaded by path; plain float32 ``torch``,
an explicit LSTM cell loop).

Tolerances: 1e-5 relative for a separation (float32 products in another
order and grouping, the port's loop summing each gate's two products apart;
the readings are ~3e-7), 1e-4 relative for the loss and each parameter's
gradient (the backward sums over every frame and chunk).  A planted fault,
inter rows run over the grid's chunks, must move a short row by more than
100 times the separation's tolerance."""

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from amss_tpu_torch.configs import recipes
from amss_tpu_torch.infer.streaming import StreamingSeparator
from amss_tpu_torch.models import dprnn, sepformer
from amss_tpu_torch.models.blstm import blstm_path
from amss_tpu_torch.train.engine import make_model
from amss_tpu_torch.utils import profiling
from amss_tpu_torch.utils.config import FrontConfig, ModelConfig, SeparatorConfig

torch.set_num_threads(2)

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
TOL = 1e-5
F32 = torch.float32


def _load(name: str, path: Path):
    if str(BENCH) not in sys.path:  # the reference imports ``bm`` and ``reference``
        sys.path.insert(0, str(BENCH))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load("dprnn_reference", BENCH / "reference" / "dprnn.py")
PRODUCTS = _load("reference_dsp", BENCH / "reference" / "dsp.py").Products


def _cfg() -> ModelConfig:
    return ModelConfig(kind="dprnn_tasnet",
                       front=FrontConfig(kind="conv", n_filters=8, filter_len=2, stride=1, pool=1),
                       sep=SeparatorConfig(hidden=6, trunk="dprnn", expansion=1, blocks=1,
                                           repeats=2, chunk_frames=8, remat=False),
                       nb_speakers=2)


def _ref_cfg(cfg: ModelConfig) -> dict:
    """The reference's configuration of a port ``ModelConfig``."""
    return {"port": {"front": dataclasses.asdict(cfg.front), "sep": dataclasses.asdict(cfg.sep),
                     "nb_speakers": cfg.nb_speakers},
            "group_norm_eps": sepformer.GN_EPS}


@pytest.fixture(scope="module")
def tiny():
    cfg = _cfg()
    model = make_model(cfg)
    model.init_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():  # norms and biases away from their init, so each one counts
        for name, p in model.named_parameters():
            if not name.endswith(".weight") and not name.startswith("front."):
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(7)))
    return model.eval(), _ref_cfg(cfg)


def _weights(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def _mix(t: int, seed: int) -> torch.Tensor:
    return 0.3 * torch.randn(t, generator=torch.Generator().manual_seed(seed))


def test_one_mixture_matches_the_reference(tiny):
    model, cfg = tiny
    mix = _mix(150, 1)
    est = model.separate(mix[None])[0]
    ref = REF.separate(mix, _weights(model), cfg, PRODUCTS())
    assert est.shape == ref.shape == (2, 150)
    assert _rel(est, ref) < TOL


# 150 samples: 149 frames, 40 chunks of the own grid; 95 samples 26, 51
# samples 14; the bucket of 150 has 40: 14 and 26 chunks past the short
# rows' own, whose intra rows are not run
LENGTHS = (150, 95, 51)


def _padded(model, lengths=LENGTHS):
    t = max(lengths)
    mix = torch.zeros(len(lengths), t)
    fm = torch.zeros(len(lengths), model.cfg.front.frames_for(t))
    for i, n in enumerate(lengths):
        mix[i, :n] = _mix(n, 10 + i)
        fm[i, :model.cfg.front.frames_for(n)] = 1.0
    return mix, fm


@pytest.mark.parametrize("row", range(len(LENGTHS)))
def test_each_row_of_a_padded_batch_matches_the_row_alone(tiny, row):
    """The padding contract: a row of the padded batch gives what the model
    gives on that row unpadded, and what the reference gives."""
    model, cfg = tiny
    k = model.cfg.sep.chunk_frames
    f = model.cfg.front.frames_for
    assert [dprnn.segments(f(n), k) for n in LENGTHS] == [40, 26, 14]
    mix, fm = _padded(model)
    est = model.separate(mix, frame_mask=fm)[row]
    n = LENGTHS[row]
    alone = model.separate(mix[row:row + 1, :n])[0]
    ref = REF.separate(mix[row, :n], _weights(model), cfg, PRODUCTS())
    assert _rel(est[:, :n], alone) < TOL and _rel(est[:, :n], ref) < TOL
    assert float(est[:, n:].abs().sum()) == 0.0  # no frame of its own reaches there


def test_inter_rows_run_unmasked_move_a_short_row(tiny):
    """Every inter row over the grid's chunks: the short row's backward
    recurrence starts in the bucket's padding."""
    model, cfg = tiny
    mix, fm = _padded(model)
    n = LENGTHS[2]
    ref = REF.separate(mix[2, :n], _weights(model), cfg, PRODUCTS())

    def unmasked(own, b, k, p):
        return None, torch.full((b * k,), p, dtype=torch.int64)

    with mock.patch.object(sepformer, "inter_rows", unmasked):
        est = model.separate(mix, frame_mask=fm)[2]
    assert _rel(est[:, :n], ref) > 100 * TOL


def test_the_spans_count_the_rows_and_steps_each_path_ran(tiny):
    """One ``dprnn.intra`` and one ``dprnn.inter`` a block inside ``trunk``:
    the intra rows of the own chunks alone (80 of 120), the inter rows over
    the grid's 40 chunks (8 a row), and the mask copied to the host once."""
    model, _ = tiny
    mix, fm = _padded(model)
    with profiling.recording():
        model.separate(mix, frame_mask=fm)
    kept = profiling.spans()
    trunk = [r for r in kept if r.name == profiling.TRUNK]
    assert len(trunk) == 1
    got = [(r.name, r.attrs) for r in kept if r.name.startswith("dprnn.")]
    intra = dict(rows=80, steps=80 * 8, valid_steps=80 * 8, blstm_path="loop")
    inter = dict(rows=24, steps=24 * 40, valid_steps=8 * 80, blstm_path="loop")
    assert got == [("dprnn.intra", intra), ("dprnn.inter", inter)] * 2
    assert all(r.parent == trunk[0].id for r in kept if r.name.startswith("dprnn."))
    assert sum(r.name == profiling.SYNC_LENGTHS for r in kept) == 1


def _grads(model, cfg, sources):
    model.zero_grad()
    port, _ = model.train().loss(sources)
    port.backward()
    model.eval()
    w = {n: p.detach().clone().requires_grad_(True) for n, p in model.named_parameters()}
    ref = REF.loss(sources, w, cfg, PRODUCTS())
    ref.backward()
    return port, ref, {n: p.grad for n, p in model.named_parameters()}, {
        n: t.grad for n, t in w.items()}


@pytest.mark.parametrize("remat", [False, True])
def test_the_loss_and_every_gradient_match_the_reference(tiny, remat):
    """The PIT loss within 1e-4, and each trainable parameter's gradient
    within 1e-4 of the reference's norm, with each block recomputed in the
    backward or not.  ``bias_hh`` is frozen in the port (the cell has one
    bias, in ``bias_ih``): it has no gradient there, and the reference's
    equals ``bias_ih``'s."""
    model, cfg = tiny
    sources = 0.3 * torch.randn(2, 2, 120, generator=torch.Generator().manual_seed(3))
    kept = model.cfg
    model.cfg = dataclasses.replace(kept, sep=dataclasses.replace(kept.sep, remat=remat))
    try:
        port, ref, gp, gr = _grads(model, cfg, sources)
    finally:
        model.cfg = kept
    assert float(port.detach()) == pytest.approx(float(ref.detach()), rel=1e-4)
    for name, g in gp.items():
        if "bias_hh" in name:
            assert g is None and torch.equal(gr[name], gr[name.replace("bias_hh", "bias_ih")])
            continue
        scale = float(gr[name].norm())
        assert scale > 0.0, name
        assert float((g - gr[name]).norm()) <= 1e-4 * scale, name


def test_one_streaming_job_matches_the_reference(tiny):
    """A ``StreamingSeparator`` job of four mixtures in two buckets, batches
    of two: each answer the reference's on the mixture alone."""
    model, cfg = tiny
    waves = [_mix(n, 20 + i).numpy() for i, n in enumerate((3000, 2000, 9000, 7000))]
    outs = StreamingSeparator(model, sample_rate=8000, device="cpu").separate_all(
        waves, max_batch=2)
    w = _weights(model)
    for wave, est in zip(waves, outs):
        ref = REF.separate(torch.from_numpy(wave), w, cfg, PRODUCTS())
        assert np.asarray(est).shape == tuple(ref.shape)
        assert _rel(torch.as_tensor(np.asarray(est)), ref) < TOL


# (rows, hidden) of the measured shapes -> the path of a live float32 call on
# the card: deep clustering's cell, DPRNN-TasNet's intra and inter rows at the
# benchmark's batch (the row-parallel kernel), then the probes whose faster
# side every reading agreed on (PERF.md §6)
RULE = [((8, 300), "kernel"), ((3088, 128), "kernel"), ((2000, 128), "kernel"),
        ((128, 300), "kernel"), ((160, 300), "kernel"), ((256, 300), "packed"),
        ((512, 128), "kernel")]


@pytest.mark.parametrize("shape,want", RULE)
def test_the_row_rule_takes_the_faster_path_measured(shape, want):
    rows, hidden = shape
    assert blstm_path("cuda", F32, F32, rows, hidden, False, False, False) == want


def test_the_cells_rows_are_the_rules_measured_shapes():
    """The benchmark's batch of 8 × 6.0 s in the 49152 bucket: 3088 intra
    rows of 250 steps and 2000 inter rows of 396 chunks."""
    cfg = recipes.dprnn_tasnet().model
    k = cfg.sep.chunk_frames
    own = dprnn.segments(cfg.front.frames_for(48000), k)
    grid = dprnn.segments(cfg.front.frames_for(49152), k)
    assert (own, grid) == (386, 396)
    assert (8 * own, 8 * k) == (3088, 2000)


def test_the_published_widths_have_the_references_parameter_count():
    cfg = json.loads((BENCH / "configs" / "dprnn_luo2020.json").read_text())
    p = dict(cfg["port"])
    model = make_model(ModelConfig(front=FrontConfig(**p.pop("front")),
                                   sep=SeparatorConfig(**p.pop("sep")), **p))
    count = sum(t.numel() for t in model.parameters())
    assert count == REF.parameters(cfg) == cfg["parameters"] == 2_608_001
    assert sum(t.numel() for t in make_model(recipes.dprnn_tasnet().model).parameters()) == count
    assert "dprnn_tasnet" not in recipes.ALL_RECIPES


def test_the_kind_refuses_dropout():
    cfg = _cfg()
    with pytest.raises(ValueError):
        make_model(dataclasses.replace(cfg, sep=dataclasses.replace(cfg.sep, dropout=0.1)))
    with pytest.raises(ValueError):
        sepformer.DPRNNTasNetModel(dataclasses.replace(cfg, kind="sepformer"))
