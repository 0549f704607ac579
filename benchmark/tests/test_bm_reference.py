"""The references against the port at tiny sizes on the CPU, and each
configuration's family found by name."""

import pytest
import torch

from bm import core, serving
from bm_tiny import tiny_config

CONFIGS = [c["name"] for c in core.load_json(core.ROOT / "BENCHMARK.json")["configs"]]


@pytest.mark.parametrize("name", CONFIGS)
def test_every_family_module_has_what_the_harness_looks_up(name):
    fam = core.family(core.load_json(core.BENCH_DIR / "configs" / f"{name}.json"))
    for fn in ("judge", "separate", "loss", "forward_flops"):
        assert callable(getattr(fam, fn)), fn


@pytest.mark.parametrize("name", CONFIGS)
def test_the_training_loss_matches_the_port(name):
    from reference.dsp import Products

    cfg = tiny_config(name)
    model, weights = serving.port_model(cfg, 2**31 + 3, "cpu")
    g = torch.Generator().manual_seed(3)
    sources = 0.3 * torch.randn(2, cfg["speakers"], 256 + 64 * 11, generator=g)
    port = model.loss_from_batch({"sources": sources})[0]
    ref = core.family(cfg).loss(sources, weights, cfg, Products())
    assert float(ref.detach()) == pytest.approx(float(port.detach()), rel=1e-4, abs=1e-5)


def test_the_dpcl_judge_reads_the_references_own_separation_as_exact():
    """The reference's own float32 separation, judged: both numbers at
    rounding, whatever first seed its k-means took."""
    from reference import dpcl
    from reference.dsp import Products

    cfg = tiny_config("dpcl_hershey2016")
    _, weights = serving.port_model(cfg, 2**31 + 5, "cpu")
    mix = 0.3 * torch.randn(256 + 64 * 40, generator=torch.Generator().manual_seed(5))
    cfg["separate"]["kmeans_iters"] = 100  # a fixed point, which the judge's centroids are too
    est = dpcl.separate(mix, weights, cfg, Products())
    numbers = dpcl.judge(mix, est, weights, cfg)
    assert numbers["serve.fit_error"] < 1e-4 and numbers["serve.cluster_error"] < 1e-4
