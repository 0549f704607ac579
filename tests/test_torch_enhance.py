"""The enhancement stage (``amss_tpu_torch/models/enhance.py``, the enh
recipe, enh run dirs) against the JAX package (``amss_tpu/models/enhance.py``),
both on the CPU, over tiny run dirs that the JAX package writes: a c1 base
(deep clustering, STFT), a c6 base (TasNet, the adaptive front), and an
enhancer stacked on the c6 enhancer.  The refiner's weights are the JAX
init moved off it by N(0, 0.01²) noise, ten times the delta projection's
init range (at init the refiner is near the identity, which would hide it).
A move of 0.1 makes the float32 output ill-conditioned in both packages
alike: each is then 3.5-3.9e-4 of the peak from the port in float64, at 0.01
5e-5.

Tolerances and why:
  * ``separate``: 1e-4 of the output's peak (float32).  A deep-clustering
    base seeds its k-means on a tie that float rounding breaks (ROADMAP C.2):
    on a tiny untrained c1 the two packages then cluster differently.  So over
    the c1 base the second stage is held given one first pass (the JAX
    package's estimates, encoded by each package), and the whole two-stage
    call over the c6 base and over an enhancer stacked on the c6 enhancer;
  * the loss (msa, psa, sisdr): 1e-5 relative; over the c1 base, given one
    first pass as above.  Each gradient to 1e-4 of its tensor's largest JAX
    magnitude or 1e-5 of the largest gradient of all, whichever is larger
    (float32 backward through the BLSTM).  The second bound holds the
    gradients that cancel: the delta projection's bias adds the same logit
    to every source, which the softmax over the sources removes, so its
    gradient is 0 in exact arithmetic and rounding noise on both sides; and
    behind the decoder the BLSTM's gradients are sums that cancel to 1e-3 of
    the largest.  sisdr over the c6 base (the adaptive front, whose log of
    near-silent codes magnifies rounding, ROADMAP C.11) is held at 5e-3, as
    ``chip_smoke.py`` holds c6's first step: there the port in float64 puts
    each package's float32 gradients 1e-3 to 2.6e-3 of their scale from
    exact, and the two packages 1.1e-3 from each other;
  * three enh steps against the JAX ``Trainer``, over the c6 base: the
    bounds of tests/test_torch_train.py (1e-4 on the first step's loss, 1e-3
    after);
  * what a package writes and the other reads back, and the frozen base:
    bit for bit.

Run as a script to print the JAX package's numbers that ``chip_smoke.py``'s
enh phase is gated on (the enh recipe over checkpoints/c1_dpcl at init, on
the quality protocol):
    python tests/test_torch_enhance.py
"""

import dataclasses
import json
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from amss_tpu.ckpt.checkpoint import save_checkpoint as j_save  # noqa: E402
from amss_tpu.configs import recipes as jrecipes  # noqa: E402
from amss_tpu.data.synthetic import make_synthetic_corpus as j_make_corpus  # noqa: E402
from amss_tpu.train.engine import Trainer as JTrainer  # noqa: E402
from amss_tpu.train.engine import load_model_from_run as j_load  # noqa: E402
from amss_tpu.train.engine import make_model as j_make_model  # noqa: E402
from amss_tpu_torch.ckpt.checkpoint import restore_checkpoint  # noqa: E402
from amss_tpu_torch.configs import recipes  # noqa: E402
from amss_tpu_torch.data.store import SpeakerStore  # noqa: E402
from amss_tpu_torch.models.enhance import EnhancerModel  # noqa: E402
from amss_tpu_torch.train.engine import Trainer, make_model  # noqa: E402
from amss_tpu_torch.utils.config import recipe_from_dict  # noqa: E402
from amss_tpu_torch.weights import load_model_from_run, named_from_jax  # noqa: E402

torch.set_num_threads(2)

T = 4096
JITTER = 0.01


@pytest.fixture(autouse=True)
def _jnp_path(monkeypatch):
    monkeypatch.setenv("AMSS_PALLAS", "0")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jitter(tree, seed):
    leaves, td = jax.tree_util.tree_flatten(tree)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(td, [
        jnp.asarray(np.asarray(x) + JITTER * rng.standard_normal(x.shape), jnp.float32)
        for x in leaves])


def _write_run(root: str, recipe, params) -> str:
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(recipe), f)
    j_save(root, {"params": params}, step=1)
    return root


def _small(recipe, **sep):
    return dataclasses.replace(recipe, model=dataclasses.replace(
        recipe.model, sep=dataclasses.replace(recipe.model.sep, **sep)))


def _enh(base_run: str, **model):
    r = _small(jrecipes.enh_dpcl(base_run), hidden=8)
    return dataclasses.replace(r, model=dataclasses.replace(r.model, **model))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX run dirs: c1 and c6 bases, an enhancer over each, and a second
    enhancer stacked on the first."""
    root = tmp_path_factory.mktemp("runs")
    out = {}
    c1 = _small(jrecipes.c1_stft_dpcl(), hidden=16, layers=1, embed_dim=4)
    out["c1_base"] = _write_run(str(root / "c1"), c1,
                                j_make_model(c1.model).init(jax.random.PRNGKey(0)))
    c6 = _small(jrecipes.c6_tasnet(), hidden=16, blocks=2, repeats=1)
    out["c6_base"] = _write_run(str(root / "c6"), c6,
                                j_make_model(c6.model).init(jax.random.PRNGKey(1)))
    for name, base, seed in (("c1", "c1_base", 2), ("c6", "c6_base", 3), ("stacked", "c6", 4)):
        r = _enh(out[base])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jm = j_make_model(r.model, base_run=r.base_run)
        out[name] = _write_run(str(root / f"enh_{name}"), r,
                               _jitter(jm.init(jax.random.PRNGKey(seed)), seed))
    return out


def _mix(seed=5, b=2):
    return (np.random.default_rng(seed).standard_normal((b, T)) * 0.1).astype(np.float32)


def _sources(seed=6, s=2):
    return (np.random.default_rng(seed).standard_normal((2, s, T)) * 0.1).astype(np.float32)


def _load(run):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return j_load(run), load_model_from_run(run, device="cpu")


def test_the_recipe_is_the_jax_packages():
    assert dataclasses.asdict(recipes.enh_dpcl("r")) == dataclasses.asdict(jrecipes.enh_dpcl("r"))


class _Fixed:
    """A base whose ``separate`` returns ``est`` whatever it is given; every
    other attribute is the wrapped base's."""

    def __init__(self, base, est):
        self._base, self._est = base, est

    def separate(self, *args, **kwargs):
        return self._est

    def __getattr__(self, name):
        return getattr(self._base, name)


def _frame_masks(model):
    fm = np.ones((2, model.cfg.front.frames_for(T)), np.float32)
    fm[1, 40:] = 0.0
    return (None, fm)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("name", ["c6", "stacked"])
def test_separate_matches_jax(runs, name):
    (jm, jp), model = _load(runs[name])
    assert isinstance(model, EnhancerModel)
    mix = _mix()
    for fm in _frame_masks(model):
        want = np.asarray(jm.separate(jp, jnp.asarray(mix), frame_mask=_j(fm)))
        got = model.separate(torch.from_numpy(mix), frame_mask=_t(fm)).numpy()
        assert got.shape == want.shape == (2, 2, T)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_the_second_stage_over_c1_matches_jax_given_one_first_pass(runs):
    (jm, jp), model = _load(runs["c1"])
    mix = _mix()
    est = np.asarray(jm.base.separate(jm.base_params, jnp.asarray(mix)))
    for fm in _frame_masks(model):
        codes, aux = jm.front.encode(jm.front_params, jnp.asarray(mix))
        est_codes, _ = jm.front.encode(jm.front_params, jnp.asarray(est))
        masks = jm._refined_masks(jp, codes, est_codes, _j(fm))
        want = np.asarray(jm.front.decode(
            jm.front_params, jnp.moveaxis(codes[..., None] * masks, -1, 1),
            {k: v[:, None] for k, v in aux.items()}, T))
        with torch.no_grad():
            codes, aux = model.front.encode(torch.from_numpy(mix))
            est_codes, _ = model.front.encode(torch.from_numpy(est.copy()))
            got = model.apply_masks_and_decode(codes, aux, model.refined_masks(codes, est_codes, _t(fm)),
                                T).numpy()
        assert got.shape == want.shape == (2, 2, T)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("variant,base,grad_tol", [("msa", "c1", 1e-4), ("psa", "c1", 1e-4),
                                                   ("sisdr", "c1", 1e-4), ("sisdr", "c6", 5e-3)])
def test_loss_and_gradients_match_jax_grad(runs, variant, base, grad_tol):
    r = _enh(runs[f"{base}_base"], loss_variant=variant)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm = j_make_model(r.model, base_run=r.base_run)
        jp = _jitter(jm.init(jax.random.PRNGKey(7)), 7)
        model = make_model(recipe_from_dict(dataclasses.asdict(r)).model, r.base_run, "cpu")
    model.load_state_dict(named_from_jax(_np(jp)))
    src = _sources()
    if base == "c1":  # one first pass for both (ROADMAP C.2)
        est = np.array(jm.base.separate(jm.base_params, jnp.asarray(src.sum(axis=1))))
        jm.base = _Fixed(jm.base, jnp.asarray(est))
        model._frozen[0] = _Fixed(model.base, torch.from_numpy(est))
    (jl, jmet), jg = jax.value_and_grad(lambda p: jm.loss(p, jnp.asarray(src)), has_aux=True)(jp)
    loss, metrics = model.loss(torch.from_numpy(src))
    assert set(metrics) == set(jmet)
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    loss.backward()
    want = named_from_jax(_np(jg))
    trained = {n for n, p in model.named_parameters() if p.requires_grad}
    assert trained == {n for n in want if "bias_hh" not in n}
    top = max(float(np.abs(want[n].numpy()).max()) for n in trained)
    for n in trained:
        g, w = dict(model.named_parameters())[n].grad.numpy(), want[n].numpy()
        assert np.abs(g - w).max() <= max(grad_tol * np.abs(w).max(), 1e-5 * top), n
    assert not any(p.requires_grad for p in model.base.parameters())
    assert not any(p.grad is not None for p in model.base.parameters())


def test_the_front_is_the_bases_and_a_tasnet_base_warns(runs):
    with pytest.warns(UserWarning, match="REGRESSES"):
        model = load_model_from_run(runs["c6"], device="cpu")
    assert model.front is model.base.front and model.cfg.front == model.base.cfg.front
    stacked = load_model_from_run(runs["stacked"], device="cpu")
    assert stacked.front is stacked.base.base.front
    assert sorted(n.split(".")[0] for n, _ in stacked.named_parameters()) == ["blstm"] * 8 + [
        "proj"] * 2


def _metrics(run_dir: str, key: str) -> dict:
    out = {}
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if key in rec:
                out[rec["step"]] = rec[key]
    return out


def _tiny(mod, base_run, steps=3):
    r = mod.enh_dpcl(base_run)
    return dataclasses.replace(
        r,
        train=dataclasses.replace(r.train, batch_size=2, chunk_samples=2048, steps=steps,
                                  valid_every=steps, valid_steps=1, lr=3e-3, ema_decay=0.9),
        model=dataclasses.replace(r.model, sep=dataclasses.replace(r.model.sep, hidden=8)),
    )


def test_three_enh_steps_follow_the_jax_trainer_and_each_resumes_the_other(runs, tmp_path):
    root = tmp_path / "corpus"
    j_make_corpus(str(root), n_speakers=10, seconds_per_speaker=2.0)
    store = SpeakerStore(str(root))
    base = runs["c6_base"]
    warnings.simplefilter("ignore")  # a TasNet base warns: feed-forward, so both agree
    jtr = JTrainer(_tiny(jrecipes, base), store, workdir=str(tmp_path / "jax"))
    init = jtr.init_state()
    jinit = _np(init["params"])
    jtr.fit(state=init, log_every=1)
    tr = Trainer(_tiny(recipes, base), store, workdir=str(tmp_path / "port"), device="cpu")
    frozen = {n: p.clone() for n, p in tr.model.base.named_parameters()}
    final = tr.fit(tr.state_from_tree({"params": jinit}), log_every=1)
    assert os.path.basename(tr.dir) == os.path.basename(jtr.dir)
    ours, theirs = _metrics(tr.dir, "train/enhance_mi"), _metrics(jtr.dir, "train/enhance_mi")
    assert sorted(ours) == sorted(theirs) == [1, 2, 3]
    assert abs(ours[1] - theirs[1]) <= 1e-4 * abs(theirs[1])
    for s in (2, 3):
        assert abs(ours[s] - theirs[s]) <= 1e-3 * abs(theirs[s]), s
    v, jv = _metrics(tr.dir, "valid/loss")[3], _metrics(jtr.dir, "valid/loss")[3]
    assert abs(v - jv) <= 1e-3 * abs(jv)
    for n, p in tr.model.base.named_parameters():
        assert torch.equal(p, frozen[n]), n
    # the port's checkpoint is the JAX layout: {"separator": {"blstm", "proj"}}
    tree, _ = restore_checkpoint(tr.dir)
    assert sorted(tree["params"]) == ["separator"]
    assert sorted(tree["params"]["separator"]) == ["blstm", "proj"]
    _, served = j_load(tr.dir)
    for a, b in zip(jax.tree_util.tree_leaves(_np(served)),
                    jax.tree_util.tree_leaves(tr.state_tree(final)["ema_params"])):
        np.testing.assert_array_equal(a, b)
    state = JTrainer(jtr.recipe, store, run_dir=tr.dir).restore()
    assert int(state["step"]) == 3
    port = Trainer(_tiny(recipes, base, steps=4), store, run_dir=str(tmp_path / "r"),
                   device="cpu")
    jtree, _ = restore_checkpoint(jtr.dir)
    resumed = port.state_from_tree(jtree)
    assert resumed["step"] == 3
    back = port.state_tree(resumed)
    for a, b in zip(jax.tree_util.tree_leaves(back["params"]),
                    jax.tree_util.tree_leaves(jtree["params"])):
        np.testing.assert_array_equal(a, b)
    assert port.fit(resumed, log_every=1)["step"] == 4


def _reference_numbers():
    """The JAX package's enh recipe over checkpoints/c1_dpcl at init (the
    delta projection near 0), in float32 on the CPU: the SI-SDRi of the base
    and of the two stages on bench.py's quality protocol (64 two-speaker
    mixtures of 16384 samples), and how far the refined output is from the
    base's on eight of them (largest difference over the base's peak, and
    SI-SDR of one against the other)."""
    import bench
    from amss_tpu_torch.ops.metrics import si_sdr

    base_run = os.path.join(REPO, "checkpoints", "c1_dpcl")
    r = jrecipes.enh_dpcl(base_run)
    jm = j_make_model(r.model, base_run=base_run)
    jp = jm.init(jax.random.PRNGKey(0))
    base_q = bench._trained_quality(jm.base, jm.base_params, s=2)
    enh_q = bench._trained_quality(jm, jp, s=2)
    mixes = jnp.asarray(np.stack(bench._mix_pairs(8, 16384)[0]))
    b = np.asarray(jm.base.separate(jm.base_params, mixes))
    e = np.asarray(jm.separate(jp, mixes))
    db = si_sdr(torch.from_numpy(e).double(), torch.from_numpy(b).double())
    print(json.dumps({"base_si_sdri": base_q, "enh_init_si_sdri": enh_q,
                      "enh_init_vs_base_max_over_peak": float(np.abs(e - b).max()
                                                              / np.abs(b).max()),
                      "enh_init_vs_base_si_sdr_db_min": float(db.min()),
                      "enh_init_vs_base_si_sdr_db_mean": float(db.mean())}))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    _reference_numbers()
