"""Training-time dropout (``amss_tpu_torch/models/dprnn.py::dropout``) in the
BLSTM stack, the TCN, the DPRNN and the DPT, and the Trainer's keys.

A torch generator cannot replay ``jax.random``, so the masks are not the JAX
package's.  What is held:
  * the identity without a key or at rate 0 (the JAX package's eval path);
  * the JAX package's formula, exactly, given its own keep mask;
  * the keep rate within five standard deviations of a binomial draw;
  * a key draws the same mask again, and child keys draw different ones;
  * remat (``torch.utils.checkpoint``) recomputes the same masks: values and
    gradients bit for bit those without remat;
  * the BLSTM's dropout after every layer, the last included, as
    ``blstm_stack`` applies it;
  * training with dropout > 0 runs and is deterministic for a seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amss_tpu.models.dprnn import dropout as j_dropout
from amss_tpu_torch.configs import recipes
from amss_tpu_torch.data.synthetic import make_synthetic_corpus
from amss_tpu_torch.models import dprnn, dptransformer, tcn
from amss_tpu_torch.models.blstm import BLSTM
from amss_tpu_torch.models.dprnn import DropoutKey, apply_keep_mask, dropout
from amss_tpu_torch.train.engine import Trainer

torch.set_num_threads(2)


def _x(shape, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def test_the_identity_without_a_key_or_at_rate_0():
    x = _x((4, 5))
    assert dropout(x, 0.3, None) is x
    assert dropout(x, 0.0, DropoutKey(1)) is x


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_the_jax_formula_given_its_keep_mask(rate):
    x = _x((64, 33), seed=2)
    key = jax.random.PRNGKey(3)
    want = np.asarray(j_dropout(key, jnp.asarray(x.numpy()), rate))
    keep = np.array(jax.random.bernoulli(key, 1.0 - rate, x.shape))
    got = apply_keep_mask(x, torch.from_numpy(keep), 1.0 - rate).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_the_keep_rate_is_within_binomial_bounds(rate):
    n = 200_000
    x = torch.ones(n)
    y = dropout(x, rate, DropoutKey(11))
    kept = float((y != 0).float().mean())
    keep = 1.0 - rate
    assert abs(kept - keep) <= 5.0 * np.sqrt(keep * rate / n)
    assert torch.equal(torch.unique(y[y != 0]), torch.tensor([1.0]) / keep)


def test_keys_are_deterministic_and_children_differ():
    key = DropoutKey(7)
    a = key.keep_mask((1000,), 0.5, "cpu")
    assert torch.equal(a, DropoutKey(7).keep_mask((1000,), 0.5, "cpu"))
    kids = key.split(3)
    assert [k.seed for k in kids] == [k.seed for k in DropoutKey(7).split(3)]
    assert len({k.seed for k in kids} | {key.fold_in(0).seed, key.fold_in(1).seed}) == 5
    assert not torch.equal(a, kids[0].keep_mask((1000,), 0.5, "cpu"))


def test_the_blstm_drops_after_every_layer():
    lstm = BLSTM(5, 4, 2)
    lstm.init_parameters(torch.Generator().manual_seed(0))
    x, m = _x((3, 6, 5)), torch.ones(3, 6)
    m[2, 4:] = 0.0
    key = DropoutKey(5)
    with torch.no_grad():
        got = lstm(x, m, dropout_rate=0.25, rng=key)
        h = x
        for layer, r in enumerate(key.split(2)):
            h = lstm._layer_loop(h, m, layer)
            h = apply_keep_mask(h, r.keep_mask(h.shape, 0.75, "cpu"), 0.75)
        assert torch.equal(got, h)
        assert torch.equal(lstm(x, m, dropout_rate=0.25), lstm(x, m))


def _trunks():
    gen = torch.Generator().manual_seed(0)
    t = tcn.TCN(12, 8, 16, blocks=2, repeats=1)
    r = dprnn.DPRNN(12, 8, 8, blocks=2)
    d = dptransformer.DPT(12, 8, 16, blocks=2)
    for m in (t, r, d):
        m.init_parameters(gen)
    return {
        "tcn": (t, lambda x, m, **kw: tcn.tcn_stack(t, x, m, blocks_per_repeat=2, **kw)),
        "dprnn": (r, lambda x, m, **kw: dprnn.dprnn_stack(r, x, m, chunk_frames=4, **kw)),
        "dpt": (d, lambda x, m, **kw: dptransformer.dpt_stack(d, x, m, chunk_frames=4, heads=2,
                                                              **kw)),
    }


@pytest.mark.parametrize("trunk", ["tcn", "dprnn", "dpt"])
def test_remat_recomputes_the_same_masks(trunk):
    module, run = _trunks()[trunk]
    x = _x((2, 18, 12), seed=4)
    mask = torch.ones(2, 18)
    mask[1, 11:] = 0.0
    outs = []
    for remat in (False, True):
        module.zero_grad()
        y = run(x, mask, remat=remat, dropout_rate=0.2, rng=DropoutKey(9))
        (y * torch.linspace(-1, 1, y.shape[-1])).sum().backward()
        outs.append((y.detach(), {n: None if p.grad is None else p.grad.clone()
                                  for n, p in module.named_parameters()}))
    assert torch.equal(outs[0][0], outs[1][0])
    for n, g in outs[0][1].items():
        assert (g is None) == (outs[1][1][n] is None), n
        assert g is None or torch.equal(g, outs[1][1][n]), n
    with torch.no_grad():
        plain = run(x, mask)
        again = run(x, mask, dropout_rate=0.2, rng=DropoutKey(9))
        other = run(x, mask, dropout_rate=0.2, rng=DropoutKey(10))
    assert torch.equal(again, outs[0][0]) and not torch.equal(again, plain)
    assert not torch.equal(again, other)


def _tiny_dpt(rate: float):
    r = recipes.c6_tasnet()
    return dataclasses.replace(
        r,
        train=dataclasses.replace(r.train, batch_size=2, chunk_samples=2048, steps=2,
                                  valid_every=2, valid_steps=1),
        model=dataclasses.replace(r.model, sep=dataclasses.replace(
            r.model.sep, trunk="dpt", hidden=16, blocks=2, chunk_frames=8, heads=2,
            expansion=2, dropout=rate)),
    )


def test_training_with_dropout_is_deterministic_for_a_seed(tmp_path):
    """Two runs at rate 0.1 from one seed end bit for bit alike; a run at
    rate 0 from the same init and batches ends elsewhere."""
    store = make_synthetic_corpus(str(tmp_path / "corpus"), n_speakers=8,
                                  seconds_per_speaker=2.0, seed=0, version=1)
    finals = [Trainer(_tiny_dpt(rate), store, run_dir=str(tmp_path / f"run{i}"),
                      device="cpu").fit(log_every=1)["params"]
              for i, rate in enumerate((0.1, 0.1, 0.0))]
    a, b, c = finals
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert any(not torch.equal(a[n], c[n]) for n in a)
