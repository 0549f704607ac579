"""The TasNet model (``amss_tpu_torch/models/tasnet.py``) against the JAX
package on the CPU: the golden loss, the PIT SI-SDR it trains on, its loss
and gradients from the same weights, and the weight round trip of both
committed c6 checkpoints.

Tolerances and why:
  * golden "c6": 1e-4 relative, the golden test's own bound
    (tests/test_goldens.py);
  * ``pit_si_sdr``: 1e-4 dB (float32 sums of 2048 terms in other orders);
  * the loss from the same weights: 1e-5 relative; every gradient 1e-4 of
    its tensor's largest magnitude (float32 through the front, a TCN of six
    blocks and the SI-SDR's ratio);
  * swapping the sources, and the weight round trip: exact.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amss_tpu.configs import recipes as jrecipes
from amss_tpu.ops.metrics import pit_si_sdr as j_pit_si_sdr
from amss_tpu.train.engine import make_model as j_make_model
from amss_tpu_torch.ckpt.checkpoint import load_params
from amss_tpu_torch.configs import recipes
from amss_tpu_torch.models.dprnn import DropoutKey
from amss_tpu_torch.models.tasnet import TasNetModel
from amss_tpu_torch.ops.metrics import pit_si_sdr
from amss_tpu_torch.train.engine import make_model
from amss_tpu_torch.utils.config import FrontConfig, ModelConfig, SeparatorConfig
from amss_tpu_torch.weights import (load_model_from_run, named_from_jax, params_from_jax,
                                    params_to_jax)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "goldens.json")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_cfg(jcfg) -> ModelConfig:
    d = dataclasses.asdict(jcfg)
    return ModelConfig(front=FrontConfig(**d.pop("front")), sep=SeparatorConfig(**d.pop("sep")),
                       **d)


def _small(**sep):
    """c6 at the goldens' width: bottleneck 16, expansion 2, 3 x 8 blocks."""
    r = jrecipes.c6_tasnet()
    return dataclasses.replace(r.model, sep=dataclasses.replace(
        r.model.sep, **{"hidden": 16, "layers": 1, "embed_dim": 4, **sep}))


def test_the_recipe_is_the_jax_packages():
    assert dataclasses.asdict(recipes.c6_tasnet()) == dataclasses.asdict(jrecipes.c6_tasnet())
    assert isinstance(make_model(recipes.c6_tasnet().model), TasNetModel)


def test_loss_reproduces_golden_c6():
    """tests/test_goldens.py's protocol: the JAX init from PRNGKey(7) carried
    across, and the draws of every recipe before c6 in the same order."""
    jcfg = _small()
    jp = _np(j_make_model(jcfg).init(jax.random.PRNGKey(7)))
    rng = np.random.default_rng(1234)
    for name in ("c1", "c2_pretrain", "c2", "c3", "c4", "c6"):
        r = {"c1": jrecipes.c1_stft_dpcl(), "c2_pretrain": jrecipes.c2_pretrain_adapt(),
             "c2": jrecipes.c2_adapt_dpcl(), "c3": jrecipes.c3_l41(n_train_speakers=6),
             "c4": jrecipes.c4_chimera_3mix(), "c6": jrecipes.c6_tasnet()}[name]
        s = r.model.nb_speakers
        sources = (rng.standard_normal((2, s, 2048)) * 0.1).astype(np.float32)
        if r.model.kind == "l41":
            rng.integers(0, 6, (2, s))
    model = params_from_jax(_port_cfg(jcfg), jp, device="cpu")
    with torch.no_grad():
        loss, metrics = model.loss_from_batch({"sources": torch.from_numpy(sources)})
    with open(GOLDENS) as f:
        want = json.load(f)["c6"]
    assert set(metrics) == {"neg_pit_si_sdr"}
    assert abs(float(loss) - want) <= 1e-4 * max(abs(want), 1.0), (float(loss), want)


@pytest.mark.parametrize("s", [2, 3])
def test_pit_si_sdr_matches_jax(s):
    rng = np.random.default_rng(s)
    ref = rng.standard_normal((4, s, 2048)).astype(np.float32)
    est = (ref[:, ::-1] + 0.5 * rng.standard_normal(ref.shape)).astype(np.float32)
    want, want_idx = j_pit_si_sdr(jnp.asarray(est), jnp.asarray(ref))
    got, idx = pit_si_sdr(torch.from_numpy(est), torch.from_numpy(ref))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))


@pytest.mark.parametrize("s", [2, 3])
def test_loss_and_gradients_match_jax_and_ignore_source_order(s):
    jcfg = dataclasses.replace(_small(blocks=3, repeats=2), nb_speakers=s)
    jm = j_make_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(s))
    src = (np.random.default_rng(s).standard_normal((2, s, 2048)) * 0.1).astype(np.float32)
    (jl, _), jg = jax.value_and_grad(lambda p: jm.loss(p, jnp.asarray(src)), has_aux=True)(jp)
    model = params_from_jax(_port_cfg(jcfg), _np(jp), device="cpu")
    loss, _ = model.loss(torch.from_numpy(src))
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    loss.backward()
    want = {n: v.numpy() for n, v in named_from_jax(_np(jg)).items()}
    for n, p in model.named_parameters():
        scale = np.abs(want[n]).max()
        got = np.zeros_like(want[n]) if p.grad is None else p.grad.numpy()
        assert np.abs(got - want[n]).max() <= 1e-4 * scale, n
    with torch.no_grad():
        swapped, _ = model.loss(torch.from_numpy(src[:, ::-1].copy()))
    assert swapped.item() == loss.item()


@pytest.mark.parametrize("run", ["c6_flagship", "c6_3spk"])
def test_weights_round_trip_on_the_checkpoints(run):
    path = os.path.join(REPO, "checkpoints", run)
    model = load_model_from_run(path, device="cpu")
    stored = load_params(path)
    tree = params_to_jax(model)

    def same(a, b, where=""):
        if isinstance(b, dict):
            assert sorted(a) == sorted(b), where
            for k in b:
                same(a[k], b[k], f"{where}/{k}")
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b), where

    same(tree, stored)
    again = params_from_jax(model.cfg, tree, device="cpu")
    for (n, a), (m, b) in zip(model.state_dict().items(), again.state_dict().items()):
        assert n == m and torch.equal(a, b), n
    assert len(model.tcn.blocks) == model.cfg.sep.blocks * model.cfg.sep.repeats == 24


def test_the_trunks_still_to_port_raise():
    """The name is kept from when the dual-path trunks and dropout raised:
    both are ported (tests/test_torch_dprnn.py, test_torch_dpt.py and
    test_torch_dropout.py hold them against the JAX package), and so are the
    train-time corruptions (test_torch_augment.py): a noisy config trains with
    a key and is clean without one."""
    for trunk in ("dprnn", "dpt"):
        model = TasNetModel(_port_cfg(_small(trunk=trunk, blocks=2, chunk_frames=8)))
        assert model.trunk_dim == 16 and hasattr(model, trunk)
    noisy = TasNetModel(dataclasses.replace(_port_cfg(_small()), train_noise_snr_db=(5.0, 15.0)))
    noisy.init_parameters(torch.Generator().manual_seed(0))
    clean = TasNetModel(_port_cfg(_small()))
    clean.init_parameters(torch.Generator().manual_seed(0))
    mix = torch.randn((1, 2, 2048), generator=torch.Generator().manual_seed(2)) * 0.1
    with torch.no_grad():
        assert torch.equal(noisy.loss(mix)[0], clean.loss(mix)[0])
        keyed = noisy.loss(mix, rng=DropoutKey(0))[0]
        assert torch.isfinite(keyed) and not torch.equal(keyed, clean.loss(mix)[0])
    model = TasNetModel(_port_cfg(_small(dropout=0.1)))
    model.init_parameters(torch.Generator().manual_seed(0))
    sources = torch.randn((1, 2, 2048), generator=torch.Generator().manual_seed(1)) * 0.1
    with torch.no_grad():
        plain = model.loss(sources)[0]  # evaluation: no key, no dropout
        assert torch.equal(model.loss(sources)[0], plain)
        dropped = model.loss(sources, rng=DropoutKey(0))[0]
        assert not torch.equal(dropped, plain)
        assert torch.equal(model.loss(sources, rng=DropoutKey(0))[0], dropped)
