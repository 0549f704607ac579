"""SepFormer (``models/sepformer.py``) on the CPU at tiny widths (d 16, 2
heads, chunks of 8 frames, 2 layers a stack, 2 repeats) against the plain
reference of the benchmark (``benchmark/reference/sepformer.py``, loaded by
path; plain float32 ``torch``, SpeechBrain's code path step for step).

Tolerances: 1e-5 relative for a separation (float32 products in another
order and grouping; the readings are ~2e-7), 1e-4 relative for the loss and
each parameter's gradient (the backward sums over every frame and chunk).  A
planted fault, the chunk mask dropped, must move a row by more than 100
times the separation's tolerance."""

import dataclasses
import importlib.util
import sys
from pathlib import Path
from unittest import mock

import pytest
import torch

from amss_tpu.configs import recipes as jrecipes
from amss_tpu.utils.config import run_id as j_run_id
from amss_tpu_torch.ckpt.tree import jax_tree, named_from_jax
from amss_tpu_torch.configs import recipes
from amss_tpu_torch.data.synthetic import make_synthetic_corpus
from amss_tpu_torch.models import dprnn, sepformer
from amss_tpu_torch.models.dptransformer import sinusoid
from amss_tpu_torch.train.engine import Trainer, make_model
from amss_tpu_torch.utils.config import FrontConfig, ModelConfig, SeparatorConfig, run_id

torch.set_num_threads(2)

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
TOL = 1e-5


def _load(name: str, path: Path):
    if str(BENCH) not in sys.path:  # the reference imports ``bm`` and ``reference``
        sys.path.insert(0, str(BENCH))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load("sepformer_reference", BENCH / "reference" / "sepformer.py")
PRODUCTS = _load("reference_dsp", BENCH / "reference" / "dsp.py").Products


def _cfg(n=16, d=16, heads=2, k=8, layers=2, repeats=2) -> ModelConfig:
    return ModelConfig(kind="sepformer",
                       front=FrontConfig(kind="conv", n_filters=n, filter_len=16, stride=8,
                                         pool=1),
                       sep=SeparatorConfig(hidden=d, trunk="sepformer", heads=heads,
                                           expansion=4, blocks=layers, repeats=repeats,
                                           chunk_frames=k, remat=False),
                       nb_speakers=2)


def _ref_cfg(cfg: ModelConfig) -> dict:
    """The reference's configuration of a port ``ModelConfig``."""
    return {"port": {"front": dataclasses.asdict(cfg.front), "sep": dataclasses.asdict(cfg.sep),
                     "nb_speakers": cfg.nb_speakers},
            "layer_norm_eps": sepformer.LN_EPS, "group_norm_eps": sepformer.GN_EPS}


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
    mix = _mix(1200, 1)
    est = model.separate(mix[None])[0]
    ref = REF.separate(mix, _weights(model), cfg, PRODUCTS())
    assert est.shape == ref.shape == (2, 1200)
    assert _rel(est, ref) < TOL


# 1480 samples: 184 frames, 48 chunks of the own grid; the bucket of 2000
# (249 frames) has 64: 16 chunks past the short rows' own, masked
LENGTHS = (2000, 1480, 1010)


def _padded(model, lengths=LENGTHS):
    t = max(lengths)
    mix = torch.zeros(len(lengths), t)
    fm = torch.zeros(len(lengths), model.cfg.front.frames_for(t))
    for i, n in enumerate(lengths):
        mix[i, :n] = _mix(n, 10 + i)
        fm[i, :model.cfg.front.frames_for(n)] = 1.0
    return mix, fm


@pytest.mark.parametrize("row", range(len(LENGTHS)))
def test_each_row_of_a_padded_batch_matches_its_own_reference(tiny, row):
    model, cfg = tiny
    k = model.cfg.sep.chunk_frames
    f = model.cfg.front.frames_for
    assert dprnn.segments(f(LENGTHS[0]), k) - dprnn.segments(f(LENGTHS[2]), k) >= 2
    mix, fm = _padded(model)
    est = model.separate(mix, frame_mask=fm)[row]
    n = LENGTHS[row]
    ref = REF.separate(mix[row, :n], _weights(model), cfg, PRODUCTS())
    assert _rel(est[:, :n], ref) < TOL
    assert float(est[:, n:].abs().sum()) == 0.0  # no frame of its own reaches there


def test_dropping_the_chunk_mask_moves_a_short_row(tiny):
    """Every chunk of the grid taken as the row's own: the short row's inter
    attention, norms and zeroing see the bucket's padding."""
    model, cfg = tiny
    mix, fm = _padded(model)
    n = LENGTHS[2]
    ref = REF.separate(mix[2, :n], _weights(model), cfg, PRODUCTS())
    with mock.patch.object(sepformer, "segments", lambda t, k: torch.full_like(t, 10**6)):
        est = model.separate(mix, frame_mask=fm)[2]
    assert _rel(est[:, :n], ref) > 100 * TOL


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


@pytest.fixture(scope="module")
def grads(tiny):
    model, cfg = tiny
    sources = 0.3 * torch.randn(2, 2, 1000, generator=torch.Generator().manual_seed(3))
    return _grads(model, cfg, sources)


def test_the_pit_loss_matches_the_reference(grads):
    port, ref, _, _ = grads
    assert float(port.detach()) == pytest.approx(float(ref.detach()), rel=1e-4)


def test_every_gradient_matches_the_reference(grads):
    """Each gradient within 1e-4 of the reference's norm.  A key bias adds
    the same logit to every key of a query, which the softmax takes away: its
    gradient is 0 in exact arithmetic, so both packages' readings of it are
    rounding, held under 1e-6 of the whole gradient's norm instead."""
    _, _, gp, gr = grads
    assert set(gp) == set(gr)
    total = sum(float(g.norm()) ** 2 for g in gr.values()) ** 0.5
    for name in gp:
        if name.endswith("attn.wk.bias"):
            assert max(float(gp[name].norm()), float(gr[name].norm())) <= 1e-6 * total, name
            continue
        scale = float(gr[name].norm())
        assert scale > 0.0, name
        assert float((gp[name] - gr[name]).norm()) <= 1e-4 * scale, name


def test_the_segmentation_is_speechbrains(tiny):
    """``pad_to_chunks`` at hop K/2 and ``unchunk`` are the reference's
    ``_Segmentation`` and ``_over_add`` bit for bit; ``segments`` counts its
    chunks at every length."""
    for k in (8, 250):
        for t in (1, 5, k // 2 - 1, k // 2, k - 1, k, k + 1, 3 * k + 7, 5999, 6143):
            x = torch.randn(2, t, 3)
            got, _ = dprnn.pad_to_chunks(x, None, k, hop=k // 2)
            want, gap = REF.segmentation(x, k)
            assert torch.equal(got, want) and got.shape[1] == dprnn.segments(t, k)
            y = torch.randn_like(want)
            assert torch.equal(dprnn.unchunk(y, t, hop=k // 2), REF.over_add(y, gap))
    assert dprnn.segments(5999, 250) == 50 and dprnn.segments(6143, 250) == 52


def test_the_interleaved_code_is_speechbrains():
    assert torch.equal(sinusoid(250, 256, interleaved=True),
                       REF.positional_encoding(250, 256, "cpu"))


def test_the_conv_front_counts_its_frames():
    front = FrontConfig(kind="conv", n_filters=256, filter_len=16, stride=8, pool=1)
    assert front.frames_for(48000) == 5999 and front.frames_for(49152) == 6143
    model = make_model(_cfg())
    codes, aux = model.front.encode(torch.randn(2, 1234))
    assert codes.shape == (2, model.cfg.front.frames_for(1234), 16) and aux == {}
    assert float(codes.min()) >= 0.0  # the encoder's ReLU


def test_the_full_configuration_has_the_references_parameter_count():
    import json

    cfg = json.loads((BENCH / "configs" / "sepformer_subakan2021.json").read_text())
    p = dict(cfg["port"])
    model = make_model(ModelConfig(front=FrontConfig(**p.pop("front")),
                                   sep=SeparatorConfig(**p.pop("sep")), **p))
    count = sum(t.numel() for t in model.parameters())
    assert count == REF.parameters(cfg) == cfg["parameters"]
    assert 25.6e6 < count < 25.8e6
    recipe = recipes.sepformer().model
    assert sum(t.numel() for t in make_model(recipe).parameters()) == count


def test_a_checkpoint_tree_carries_every_parameter(tiny):
    model, _ = tiny
    named = _weights(model)
    back = named_from_jax(jax_tree(named))
    assert set(back) == set(named)
    for name, t in named.items():
        assert torch.equal(back[name], t), name


_SHARED = {"c1": (), "c2_pretrain": (), "c2": (), "c3": (60,), "c4": (), "c5": (), "c6": (),
           "c7": (), "enh": ()}


@pytest.mark.parametrize("name", sorted(_SHARED))
def test_every_recipe_keeps_its_run_id(name):
    jname = {"c1": "c1_stft_dpcl", "c2_pretrain": "c2_pretrain_adapt", "c2": "c2_adapt_dpcl",
             "c3": "c3_l41", "c4": "c4_chimera_3mix", "c5": "c5_streaming", "c6": "c6_tasnet",
             "c7": "c7_realtime", "enh": "enh_dpcl"}[name]
    args = _SHARED[name]
    assert run_id(recipes.ALL_RECIPES[name](*args)) == j_run_id(getattr(jrecipes, jname)(*args))


def test_the_dual_path_recipes_keep_their_run_ids():
    assert run_id(recipes.c6_dual_path("dprnn")) == "e801ae494d1b"
    assert run_id(recipes.c6_dual_path("dpt")) == "ab4189341a56"
    assert "sepformer" not in recipes.ALL_RECIPES
    base = recipes.sepformer()
    heads = dataclasses.replace(base, model=dataclasses.replace(
        base.model, sep=dataclasses.replace(base.model.sep, heads=4)))
    assert run_id(heads) != run_id(base)  # the heads are SepFormer's width


def test_one_trainer_step_on_the_recipe(tmp_path):
    store = make_synthetic_corpus(str(tmp_path / "corpus"), n_speakers=6,
                                  seconds_per_speaker=2.0)
    r = recipes.sepformer(batch_size=2, chunk_samples=2048, steps=1, valid_every=1,
                          valid_steps=1)
    small = _cfg(layers=1, repeats=1)
    r = dataclasses.replace(r, model=dataclasses.replace(
        r.model, front=small.front, sep=dataclasses.replace(r.model.sep, hidden=16, heads=2,
                                                            blocks=1, repeats=1,
                                                            chunk_frames=8)))
    tr = Trainer(r, store, workdir=str(tmp_path / "runs"), device="cpu")
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    state = tr.fit(log_every=1)
    assert state["step"] == 1
    moved = [n for n, p in tr.model.named_parameters() if not torch.equal(p.detach(), before[n])]
    assert len(moved) == len(before)
