"""The k-means operators (``amss_tpu_torch/ops/kernels/kmeans.py``).

On the CPU: ``amss::kmeans`` and ``amss::soft_assignments`` pass
``torch.library.opcheck`` (schema, fake shapes and dtypes) at K 2 and 3, E 20
and 40; their CPU dispatch is bit-equal to the plain versions
(``ops/kmeans.py``), ties and an empty cluster included; the wrapper refuses
what the kernels do not take; an exported c1 program holds one node of each;
deep clustering's ``cluster`` span carries the launches (0 on the CPU).

On the card (marked ``card``; ``python -m pytest
tests/test_torch_kmeans_kernel.py --noconftest -m card``, since the card's
machine has no JAX for ``conftest.py``): the kernels against the plain
version on the same card at the serving cell's shape ([8, 765·129, 40], K 2)
and at K 3 / E 20, the last 2.3% of each row's points at weight 0 as a
bucket's padding, through ``tools/kmeans_check.py`` (``chip_smoke.py``'s
phase 2c uses the same comparison).  The data are well-separated blobs, so
no point lies within rounding of two centroids, and the same blobs at unit
norm, as deep clustering's embeddings are, where every point's score for the
first seed ties: the first seed equals the plain version's bit for bit,
centroids agree to 1e-5 of their norm, assignments on every point whose two
nearest distances differ by more than 1e-5 relative (the sums run in other
orders than cuBLAS's, so a near tie may flip), masks to 1e-5; two runs are
bit-identical.  The ties and the empty
cluster, in exactly representable numbers, are bit-equal to the plain version
on the CPU, and a loaded CUDA program launches the kernels.

This file imports no JAX: the card's machine has none.
"""

import numpy as np
import pytest
import torch

from amss_tpu_torch.models.dpcl import DPCLModel
from amss_tpu_torch.ops import kmeans as plain
from amss_tpu_torch.ops.kernels.kmeans import (
    SOFT_LAUNCHES,
    first_seed_score,
    fit_launches,
    kmeans,
    kmeans_launches,
    kmeans_op,
    soft_assignments,
    soft_assignments_op,
)
from amss_tpu_torch.tools.kmeans_check import blobs, compare_with_plain, failures
from amss_tpu_torch.utils import profiling
from amss_tpu_torch.utils.config import FrontConfig, ModelConfig, SeparatorConfig

torch.set_num_threads(2)

CELL_N = 765 * 129  # the serving cell's points a row: 765 frames of 129 bins
PAD_SHARE = 0.023  # the cell's padding: its last points weigh 0


def _blobs(b: int, n: int, e: int, k: int, seed: int, device="cpu", unit: bool = False):
    """``tools/kmeans_check.blobs`` from ``seed``, the last PAD_SHARE of each
    row at weight 0."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return blobs(b, n, e, k, gen, PAD_SHARE, unit)


def _tiny_c1() -> DPCLModel:
    cfg = ModelConfig(kind="dpcl", front=FrontConfig(kind="stft", win=256, hop=64),
                      sep=SeparatorConfig(hidden=8, layers=1, embed_dim=5), nb_speakers=2)
    model = DPCLModel(cfg)
    model.init_parameters(torch.Generator().manual_seed(0))
    return model.eval()


# -- the CPU ------------------------------------------------------------------

@pytest.mark.parametrize("k,e", [(2, 20), (2, 40), (3, 20), (3, 40)])
def test_opcheck_shapes_and_dtypes(k, e):
    x, w = _blobs(2, 300, e, k, seed=10 * k + e)
    torch.library.opcheck(kmeans_op, (x, w, k, 3))
    c, a = kmeans_op(x, w, k, 3)
    assert c.shape == (2, k, e) and c.dtype == torch.float32
    assert a.shape == (2, 300) and a.dtype == torch.int32
    torch.library.opcheck(soft_assignments_op, (x, c, 0.5))
    m = soft_assignments_op(x, c, 0.5)
    assert m.shape == (2, 300, k) and m.dtype == torch.float32


@pytest.mark.parametrize("k,e,iters,unit", [(2, 40, 10, False), (3, 20, 10, False),
                                            (3, 20, 0, False), (1, 7, 4, False),
                                            (4, 64, 5, False), (2, 40, 10, True)])
def test_cpu_dispatch_is_the_plain_version_bit_for_bit(k, e, iters, unit):
    x, w = _blobs(2, 500, e, 3, seed=k + e + iters, unit=unit)
    c, a = kmeans(x, k, iters, w)
    pc, pa = plain.kmeans(x, k, iters, w)
    assert torch.equal(c, pc) and torch.equal(a, pa)
    assert torch.equal(soft_assignments(x, c, 0.5), plain.soft_assignments(x, pc, 0.5))
    # unbatched and unweighted, as the plain version takes them
    c1, a1 = kmeans(x[0], k, iters)
    pc1, pa1 = plain.kmeans(x[0], k, iters)
    assert torch.equal(c1, pc1) and torch.equal(a1, pa1)


# exactly representable points: the weighted energies tie at indices 1 and 4,
# the farthest-point distances at 2 and 5; the first of each wins
TIES = np.array([[[0, 0], [2, 0], [-2, 0], [0, 1], [2, 0], [-2, 0]]], np.float32)
# two distinct weighted points and k = 3: the third seed duplicates the first,
# gets no points and keeps its centroid
EMPTY = (np.array([[[1, 0], [1, 0], [0, 3], [5, 5]]], np.float32),
         np.array([[1, 1, 1, 0]], np.float32))


def test_cpu_dispatch_ties_first_and_keeps_an_empty_cluster():
    x = torch.from_numpy(TIES)
    c, a = kmeans(x, 3, 0)
    assert torch.equal(c[0], x[0, [1, 2, 3]])
    assert torch.equal(a, plain.kmeans(x, 3, 0)[1])
    x, w = map(torch.from_numpy, EMPTY)
    c, a = kmeans(x, 3, 5, w)
    pc, pa = plain.kmeans(x, 3, 5, w)
    assert torch.equal(c, pc) and torch.equal(a, pa) and torch.isfinite(c).all()


@pytest.mark.parametrize("case", ["wide", "many", "float64", "strided", "rank"])
def test_wrapper_refuses_what_the_kernels_do_not_take(case):
    x = torch.zeros(2, 10, 8)
    k = 2
    if case == "wide":
        x = torch.zeros(2, 10, 65)
    elif case == "many":
        k = 5
    elif case == "float64":
        x = x.double()
    elif case == "strided":
        x = torch.zeros(2, 8, 10).transpose(1, 2)
    with pytest.raises(ValueError):
        kmeans(x if case != "rank" else torch.zeros(1, 2, 3, 4), k)
    if case != "rank":
        with pytest.raises(ValueError):
            soft_assignments(x, torch.zeros(2, k, x.shape[-1], dtype=x.dtype))


def test_wrapper_refuses_weights_it_cannot_take():
    x = torch.zeros(2, 10, 8)
    with pytest.raises(ValueError):
        kmeans(x, 2, weights=torch.ones(2, 10, dtype=torch.float64))
    with pytest.raises(ValueError):
        kmeans(x, 2, weights=torch.ones(10, 2).T)


def test_exported_c1_program_holds_one_node_of_each(tmp_path):
    from amss_tpu_torch.infer.export import export_serving

    out = export_serving(_tiny_c1(), str(tmp_path / "art"), lengths=(2048,), batch=2,
                         platforms=("cpu",))
    ep = torch.export.load(str(tmp_path / "art" / "serving_t2048_b2.cpu.pt2"))
    ops = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert ops.count("amss.kmeans.default") == 1
    assert ops.count("amss.soft_assignments.default") == 1
    assert out.endswith("art")


def test_cluster_span_carries_the_launches_on_the_cpu():
    model = _tiny_c1()
    mix = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 2048)).astype(np.float32))
    with profiling.recording():
        model.separate(mix)
    spans = [r for r in profiling.spans() if r.name == profiling.CLUSTER]
    assert [r.attrs for r in spans] == [{"kmeans_launches": 0}]


def test_first_seed_score_is_the_plain_version_s_and_the_comparison_holds_on_the_cpu():
    x, w = _blobs(2, 500, 40, 2, seed=7, unit=True)
    score = first_seed_score(x, w)
    # unit norm: the weighted points' scores tie up to rounding
    assert float(score[w > 0].max() - score[w > 0].min()) < 1e-5
    assert torch.equal(x[torch.arange(2), score.argmax(-1)], plain.kmeans(x, 1, 0, w)[0][:, 0])
    r = compare_with_plain(x, w, 2)
    assert r["first_seed_equal"] and r["seeds_equal"] and r["repeats"], r
    assert r["centroid_rel"] == 0.0 and r["mask_err"] == 0.0 and r["assign_diff"] == 0, r
    assert failures(r, 2) == [f"0 launches, want {fit_launches(2, 10) + SOFT_LAUNCHES}"]


def test_launch_counts():
    assert fit_launches(2, 10) + SOFT_LAUNCHES == 27
    assert fit_launches(3, 0) == 7


# -- the card -----------------------------------------------------------------

@pytest.fixture
def card():
    """The CUDA device of a test marked ``card``; skips where there is none
    (decided when the test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: python -m pytest "
                    "tests/test_torch_kmeans_kernel.py --noconftest -m card)")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("k,e,unit", [(2, 40, False), (3, 20, False), (2, 40, True)])
def test_kernels_match_the_plain_version_on_the_card(card, k, e, unit):
    x, w = _blobs(8, CELL_N, e, k, seed=k * 100 + e + unit, device=card, unit=unit)
    r = compare_with_plain(x, w, k)
    assert failures(r, k) == [], r


@pytest.mark.card
def test_ties_and_an_empty_cluster_bit_equal_on_the_card(card):
    x = torch.from_numpy(TIES)
    c, a = kmeans(x.to(card), 3, 0)
    pc, pa = plain.kmeans(x, 3, 0)
    assert torch.equal(c.cpu(), pc) and torch.equal(a.cpu(), pa)
    x, w = map(torch.from_numpy, EMPTY)
    c, a = kmeans(x.to(card), 3, 5, w.to(card))
    pc, pa = plain.kmeans(x, 3, 5, w)
    assert torch.equal(c.cpu(), pc) and torch.equal(a.cpu(), pa)
    m = soft_assignments(x.to(card), c, 0.5)
    torch.testing.assert_close(m.cpu(), plain.soft_assignments(x, pc, 0.5), rtol=0, atol=1e-6)


@pytest.mark.card
def test_separate_and_a_loaded_program_launch_the_kernels(card, tmp_path):
    from amss_tpu_torch.infer.export import ServingArtifact, export_serving

    model = _tiny_c1()
    export_serving(model, str(tmp_path / "art"), lengths=(2048,), batch=2, platforms=("cuda",))
    per_call = fit_launches(2, 10) + SOFT_LAUNCHES
    mix = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 2048)).astype(np.float32))
    live = model.to(card)
    with profiling.recording():
        live.separate(mix.to(card))
    spans = [r for r in profiling.spans() if r.name == profiling.CLUSTER]
    assert [r.attrs for r in spans] == [{"kmeans_launches": per_call}]
    art = ServingArtifact(str(tmp_path / "art"), device="cuda")
    art.separate_batch(mix.numpy())  # loads the program and runs it once on zeros first
    before = kmeans_launches()
    est = art.separate_batch(mix.numpy())
    assert kmeans_launches() - before == per_call
    assert np.isfinite(est).all()
