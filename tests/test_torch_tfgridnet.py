"""TF-GridNet (``models/tfgridnet.py::TFGridNetModel``) on the CPU at tiny
widths (STFT 16/8, so F 9; D 6, unfolds of 2, BLSTMs of 6 cells a direction,
2 heads of 3 query channels a bin, 2 blocks) against the plain reference of
the benchmark (``benchmark/reference/tfgridnet.py``, loaded by path; plain
float32 ``torch`` in ESPnet's layout, an explicit LSTM cell loop).

Tolerances: 1e-5 relative for a separation (float32 products in another
order and grouping: the port runs the heads' convs as one product, flattens
each frame bins-major and sums the transposed convs' taps after one
product; the readings are 3-9e-7), 1e-4 relative for the loss and each
parameter's gradient (the backward sums over every frame, bin and head).  A
planted fault, the attention attending to the padded frames' keys, must move
a short row by more than 100 times the separation's tolerance."""

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
from amss_tpu_torch.models import tfgridnet
from amss_tpu_torch.models.blstm import blstm_path
from amss_tpu_torch.models.front import STFTFrontEnd
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


REF = _load("tfgridnet_reference", BENCH / "reference" / "tfgridnet.py")
PRODUCTS = _load("reference_dsp", BENCH / "reference" / "dsp.py").Products


def _cfg() -> ModelConfig:
    return ModelConfig(kind="tfgridnet", front=FrontConfig(kind="stft", win=16, hop=8),
                       sep=SeparatorConfig(hidden=6, layers=1, embed_dim=6, trunk="tfgridnet",
                                           kernel=2, heads=2, expansion=3, blocks=2,
                                           remat=False),
                       nb_speakers=2)


def _ref_cfg(cfg: ModelConfig) -> dict:
    """The reference's configuration of a port ``ModelConfig``."""
    return {"port": {"front": dataclasses.asdict(cfg.front), "sep": dataclasses.asdict(cfg.sep),
                     "nb_speakers": cfg.nb_speakers},
            "eps": tfgridnet.EPS}


@pytest.fixture(scope="module")
def tiny():
    cfg = _cfg()
    model = make_model(cfg)
    model.init_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():  # norms, slopes and biases away from their init, so each one counts
        g = torch.Generator().manual_seed(7)
        for name, p in model.named_parameters():
            if not name.endswith(".weight"):
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return model.eval(), _ref_cfg(cfg)


def _weights(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def _mix(t: int, seed: int) -> torch.Tensor:
    return 0.3 * torch.randn(t, generator=torch.Generator().manual_seed(seed))


def test_one_mixture_matches_the_reference(tiny):
    model, cfg = tiny
    mix = _mix(203, 1)
    est = model.separate(mix[None])[0]
    ref = REF.separate(mix, _weights(model), cfg, PRODUCTS())
    assert est.shape == ref.shape == (2, 203)
    assert _rel(est, ref) < TOL


# frames 24, 15, 6 and 1 of the bucket's 24: the last row has fewer frames
# than an unfold takes, so its inter paths run no step
LENGTHS = (200, 130, 60, 20)


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
    gives on that row unpadded, and what the reference gives, to its last
    sample."""
    model, cfg = tiny
    assert [model.cfg.front.frames_for(n) for n in LENGTHS] == [24, 15, 6, 1]
    mix, fm = _padded(model)
    est = model.separate(mix, frame_mask=fm)[row]
    n = LENGTHS[row]
    ref = REF.separate(mix[row, :n], _weights(model), cfg, PRODUCTS())
    assert _rel(est[:, :n], ref) < TOL
    if model.cfg.front.frames_for(n) >= model.cfg.sep.kernel:  # the unpadded model's floor
        assert _rel(est[:, :n], model.separate(mix[row:row + 1, :n])[0]) < TOL
    assert float(est[:, n:].abs().sum()) == 0.0  # no frame of its own reaches there


def test_attention_to_padded_keys_moves_a_short_row(tiny):
    """The planted fault of the benchmark's tests: the full-band attention
    attends to the padded frames' keys."""
    model, cfg = tiny
    mix, fm = _padded(model)
    n = LENGTHS[2]
    ref = REF.separate(mix[2, :n], _weights(model), cfg, PRODUCTS())
    real = tfgridnet._attention
    with mock.patch.object(tfgridnet, "_attention", lambda blk, z, keys: real(blk, z, None)):
        est = model.separate(mix, frame_mask=fm)[2]
    assert _rel(est[:, :n], ref) > 100 * TOL


def test_the_spans_count_the_rows_steps_and_frames(tiny):
    """Per block one ``tfgridnet.intra`` (the rows of the own frames alone:
    46 of 96, 8 bins a row), one ``tfgridnet.inter`` (9 bins a row over the
    grid's 23 steps, 23 + 14 + 5 + 0 of them valid) and one
    ``tfgridnet.attn``, inside ``trunk``; the mask copied to the host once."""
    model, _ = tiny
    mix, fm = _padded(model)
    with profiling.recording():
        model.separate(mix, frame_mask=fm)
    kept = profiling.spans()
    trunk = [r for r in kept if r.name == profiling.TRUNK]
    assert len(trunk) == 1
    got = [(r.name, r.attrs) for r in kept if r.name.startswith("tfgridnet.")]
    intra = dict(rows=46, steps=46 * 8, valid_steps=46 * 8, blstm_path="loop")
    inter = dict(rows=36, steps=36 * 23, valid_steps=9 * 42, blstm_path="loop")
    attn = dict(frames=96, valid_frames=46, heads=2)
    assert got == [("tfgridnet.intra", intra), ("tfgridnet.inter", inter),
                   ("tfgridnet.attn", attn)] * 2
    assert all(r.parent == trunk[0].id for r in kept if r.name.startswith("tfgridnet."))
    assert sum(r.name == profiling.SYNC_LENGTHS for r in kept) == 1
    assert [r.name for r in kept if r.parent is None] == [
        profiling.FRONT, profiling.TRUNK, profiling.HEAD, profiling.DECODE]


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


def test_the_loss_and_every_gradient_match_the_reference(tiny):
    """The PIT loss within 1e-4, and each trainable parameter's gradient
    within 1e-4 of the reference's norm.  ``bias_hh`` is frozen in the port (``models/blstm.py``):
    it has no gradient there, and the reference's equals ``bias_ih``'s.  The
    keys' parameters take their gradients through the softmax's derivative,
    whose terms of both signs sum to small totals (a key slope's 0.08 against
    its head's key-conv weight's ~10 at one seed, 1e-4 apart on the two
    sides, and as far from float64), and the keys' LN4DCF bias shifts every
    logit of a query alike, which the softmax ignores (its gradient is zero
    but for rounding): each of a head's key parameters is held within 1e-4
    of that head's key-conv weight's gradient."""
    model, cfg = tiny
    sources = 0.3 * torch.randn(2, 2, 120, generator=torch.Generator().manual_seed(3))
    port, ref, gp, gr = _grads(model, cfg, sources)
    assert float(port.detach()) == pytest.approx(float(ref.detach()), rel=1e-4)
    for name, g in gp.items():
        if "bias_hh" in name:
            assert g is None and torch.equal(gr[name], gr[name.replace("bias_hh", "bias_ih")])
            continue
        head = name.split(".attn_k.")
        key = f"{head[0]}.attn_k.{head[1].split('.')[0]}.conv.weight" if len(head) == 2 else name
        scale = float(gr[key].norm())
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


def test_the_ri_pair_inverts_the_stft_row_by_row():
    """``decode_ri(encode_ri(x))`` gives x back where the frames overlap, and
    a padded row's normaliser is its own frames': the row alone's answer."""
    front = STFTFrontEnd(FrontConfig(kind="stft", win=16, hop=8))
    x = _mix(200, 5)
    y = front.decode_ri(front.encode_ri(x[None]), 200)[0]
    assert torch.allclose(y[8:192], x[8:192], atol=1e-5)
    pad = torch.cat([x[:100], torch.zeros(100)])
    fm = torch.zeros(1, 24)
    fm[0, :11] = 1.0
    spec = front.encode_ri(pad[None]) * fm[..., None]
    padded = front.decode_ri(spec, 200, fm)[0]
    alone = front.decode_ri(front.encode_ri(x[None, :100]), 100)[0]
    assert torch.allclose(padded[:100], alone, atol=1e-6) and float(padded[100:].abs().sum()) == 0


# the cell's batch of 8 × 6.0 s in the 49152 bucket: intra rows of the own
# frames, inter rows a bin each; both past the rows and cells both kernels take
CELL_ROWS = [((8 * 749, 192), "packed"), ((8 * 65, 192), "packed")]


@pytest.mark.parametrize("shape,want", CELL_ROWS)
def test_the_row_rule_sends_the_cells_rows_to_packed(shape, want):
    rows, hidden = shape
    assert blstm_path("cuda", F32, F32, rows, hidden, False, False, False) == want


def test_the_cells_rows_and_steps():
    """The benchmark's batch: 5992 intra rows of 62 steps (8 × 749 frames),
    520 inter rows of 764 steps, 746 of them valid."""
    cfg = recipes.tfgridnet().model
    own, grid = cfg.front.frames_for(48000), cfg.front.frames_for(49152)
    f, k = cfg.front.feature_dim, cfg.sep.kernel
    assert (own, grid, f) == (749, 767, 65)
    assert (8 * own, f - k + 1, 8 * f, grid - k + 1, own - k + 1) == (5992, 62, 520, 764, 746)


def test_the_published_widths_have_the_references_parameter_count():
    cfg = json.loads((BENCH / "configs" / "tfgridnet_wang2023.json").read_text())
    p = dict(cfg["port"])
    model = make_model(ModelConfig(front=FrontConfig(**p.pop("front")),
                                   sep=SeparatorConfig(**p.pop("sep")), **p))
    count = sum(t.numel() for t in model.parameters())
    assert count == REF.parameters(cfg) == cfg["parameters"] == 8_175_874
    assert sum(t.numel() for t in make_model(recipes.tfgridnet().model).parameters()) == count
    assert "tfgridnet" not in recipes.ALL_RECIPES


@pytest.mark.parametrize("change", [dict(dropout=0.1), dict(compute_dtype="bfloat16")])
def test_the_kind_refuses_what_it_does_not_run(change):
    cfg = _cfg()
    with pytest.raises(ValueError):
        make_model(dataclasses.replace(cfg, sep=dataclasses.replace(cfg.sep, **change)))


def test_the_kind_refuses_another_front():
    cfg = _cfg()
    with pytest.raises(ValueError):
        tfgridnet.TFGridNetModel(dataclasses.replace(cfg, front=FrontConfig(kind="conv")))
