"""Blind speaker counting (``amss_tpu_torch/infer/count.py``) against the JAX
package (``amss_tpu/infer/count.py``), both on the CPU.

Tolerances and why:
  * ``eigengap_counts``: the counts equal, and equal the true count on
    well-separated clusters, balanced or not, with a quarter of the bins
    weighted 0;
  * ``count_speakers`` through small random DPCL and Chimera models (the JAX
    init carried across): each mixture's count equal;
  * ``checkpoints/c1_count``: each mixture's count equal, on mixtures of 1, 2
    and 3 speakers from the test split of the synthetic v2 corpus (30
    speakers x 40 s from seed 0) drawn as ``scripts/r3_wave.py::
    test_mixtures`` draws them;
  * k-means at k = 1, 2 and 3 on c1_count's embeddings, its first seed made
    no tie: centroids to 1e-5, assignments 99.9% equal (float32 distances
    of near-equidistant points may round either way);
  * separation at the counted k (``separate_auto_k``, the JAX package's
    ``separate --num-speakers auto``): the counts equal, each group the
    port's own ``separate`` at its k bit for bit, and at k <= 2 each mixture
    at least 30 dB SI-SDR from the JAX package's ``separate(...,
    n_speakers=k)`` in the best speaker order.  k-means seeds on a tie that
    rounding breaks (ROADMAP C.2), so the two may stop short of one fixed
    point (tests/test_torch_dpcl_slice.py holds c1 at the same bound), and
    at k = 3 they reach different ones on these mixtures (16.5 dB apart).

Run as a script to print the JAX package's numbers that ``chip_smoke.py``'s
counting phase is gated on (c1_count, 50 mixtures per k, and the auto-k
SI-SDRi of the correctly counted at k = 2 and 3, 32 mixtures each):
    python tests/test_torch_count.py
"""

import dataclasses
import itertools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from amss_tpu.infer import count as jcount  # noqa: E402
from amss_tpu.train.engine import load_model_from_run as j_load  # noqa: E402
from amss_tpu.train.engine import make_model as j_make_model  # noqa: E402
from amss_tpu.utils.config import ModelConfig as JModelConfig  # noqa: E402
from amss_tpu.utils.config import SeparatorConfig as JSepConfig  # noqa: E402
from amss_tpu_torch.data.mixer import Mixer  # noqa: E402
from amss_tpu_torch.data.synthetic import SyntheticStore  # noqa: E402
from amss_tpu_torch.infer import count  # noqa: E402
from amss_tpu_torch.ops.metrics import si_sdr  # noqa: E402
from amss_tpu_torch.utils.config import FrontConfig, ModelConfig, SeparatorConfig  # noqa: E402
from amss_tpu_torch.weights import load_model_from_run, params_from_jax  # noqa: E402

torch.set_num_threads(2)

RUN = os.path.join(REPO, "checkpoints", "c1_count")
T = 16384


@pytest.fixture(autouse=True)
def _jnp_path(monkeypatch):
    monkeypatch.setenv("AMSS_PALLAS", "0")


def _clusters(k: int, seed: int, n: int = 400, e: int = 8, unbalanced: bool = False):
    """Unit embeddings in ``k`` tight clusters around orthogonal centres, and
    bin weights with a quarter of the bins zeroed."""
    rng = np.random.default_rng(seed)
    centres = np.linalg.qr(rng.standard_normal((e, e)))[0][:k]
    share = np.arange(1, k + 1, dtype=np.float64) if unbalanced else np.ones(k)
    labels = rng.choice(k, size=n, p=share / share.sum())
    v = centres[labels] + 0.05 * rng.standard_normal((n, e))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    w = (rng.random(n) > 0.25).astype(np.float32)
    return v.astype(np.float32), w


@pytest.mark.parametrize("k,unbalanced", list(itertools.product([1, 2, 3, 4], [False, True])))
def test_eigengap_counts_match_jax(k, unbalanced):
    v, w = map(np.stack, zip(*[_clusters(k, seed, unbalanced=unbalanced) for seed in range(3)]))
    want = np.asarray(jcount.eigengap_counts(jnp.asarray(v), jnp.asarray(w), k_max=4))
    got = count.eigengap_counts(torch.from_numpy(v), torch.from_numpy(w), k_max=4).numpy()
    assert got.dtype == np.int32 and got.tolist() == want.tolist() == [k] * 3
    # zeroed bins are left out: flipping their embeddings changes nothing
    v2 = v.copy()
    v2[w == 0] = -v2[w == 0]
    assert count.eigengap_counts(torch.from_numpy(v2), torch.from_numpy(w)).tolist() == [k] * 3


def test_eigengap_needs_embed_dim_above_k_max():
    with pytest.raises(ValueError, match="embed_dim"):
        count.eigengap_counts(torch.zeros(1, 5, 4), torch.ones(1, 5), k_max=4)


def _port_cfg(jcfg: JModelConfig) -> ModelConfig:
    d = dataclasses.asdict(jcfg)
    return ModelConfig(front=FrontConfig(**d.pop("front")), sep=SeparatorConfig(**d.pop("sep")),
                       **d)


@pytest.mark.parametrize("kind", ["dpcl", "chimera"])
def test_count_speakers_matches_jax_through_both_embedding_heads(kind):
    jcfg = JModelConfig(kind=kind, sep=JSepConfig(hidden=16, layers=1, embed_dim=6))
    jm = j_make_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(4))
    model = params_from_jax(_port_cfg(jcfg), jax.tree_util.tree_map(np.asarray, jp),
                            device="cpu")
    mix = (np.random.default_rng(5).standard_normal((3, 4096)) * 0.1).astype(np.float32)
    fm = np.ones((3, jcfg.front.frames_for(4096)), np.float32)
    fm[2, 30:] = 0.0
    for frame_mask, weights in ((None, "vad"), (fm, "magvad")):
        want = np.asarray(jcount.count_speakers(
            jm, jp, jnp.asarray(mix), frame_mask=None if frame_mask is None
            else jnp.asarray(frame_mask), weight_kind=weights))
        got = count.count_speakers(model, torch.from_numpy(mix), frame_mask=None
                                   if frame_mask is None else torch.from_numpy(frame_mask),
                                   weight_kind=weights).numpy()
        assert got.tolist() == want.tolist()


def test_a_model_without_an_embedding_head_is_refused():
    from amss_tpu_torch.configs import recipes
    from amss_tpu_torch.models.tasnet import TasNetModel

    r = recipes.c6_tasnet()
    model = TasNetModel(dataclasses.replace(r.model, sep=dataclasses.replace(
        r.model.sep, hidden=8, blocks=1, repeats=1)))
    with pytest.raises(TypeError, match="embedding head"):
        count.count_speakers(model, torch.zeros(1, 2048))


def test_mixtures(k: int, n: int, offset: int = 0):
    """``scripts/r3_wave.py::test_mixtures`` on the v2 corpus of 30 x 40 s
    from seed 0 (Mixer seed 0, test split, steps ``offset`` on, batch 1):
    (mixtures [n, T], sources [n, k, T])."""
    mixer = Mixer(SyntheticStore(n_speakers=30, seconds_per_speaker=40.0, seed=0, version=2),
                  nb_speakers=k, chunk_samples=T, seed=0)
    refs = np.stack([mixer.batch("test", offset + i, 1).sources[0] for i in range(n)])
    return refs.sum(axis=1), refs


test_mixtures.__test__ = False  # a helper named as r3_wave names it, not a test


@pytest.fixture(scope="module")
def c1_count():
    return j_load(RUN), load_model_from_run(RUN, device="cpu")


def test_c1_count_counts_each_mixture_as_jax_does(c1_count):
    (jm, jp), model = c1_count
    for k in (1, 2, 3):
        mixes, _ = test_mixtures(k, 4)
        want = np.asarray(jcount.count_speakers(jm, jp, jnp.asarray(mixes), k_max=4))
        got = count.count_speakers(model, torch.from_numpy(mixes), k_max=4).numpy()
        assert got.tolist() == want.tolist(), k


def test_kmeans_at_one_and_three_clusters_matches_jax(c1_count):
    """The seeding loop and the Lloyd iterations at k = 1, 2 and 3 on
    c1_count's embeddings, with one bin's weight raised so that the first
    seed, argmax of w·||v||², is no tie (ROADMAP C.2)."""
    from amss_tpu.models.front import vad_weights
    from amss_tpu.ops.kmeans import kmeans as j_kmeans
    from amss_tpu_torch.ops.kmeans import kmeans

    (jm, jp), _ = c1_count
    mixes, _ = test_mixtures(3, 2, offset=4)
    codes, _ = jm.front.encode(jp["front"], jnp.asarray(mixes))
    v = np.asarray(jm.embed(jp, jm.front.features(jp["front"], codes))).reshape(2, -1, 20)
    w = np.array(vad_weights(codes, 40.0)).reshape(2, -1)
    w[:, np.argmax(w, axis=1)] = 1.5
    for k in (1, 2, 3):
        jc, ja = j_kmeans(jnp.asarray(v), k, 10, jnp.asarray(w))
        c, a = kmeans(torch.from_numpy(v), k, 10, torch.from_numpy(w))
        assert np.abs(c.numpy() - np.asarray(jc)).max() <= 1e-5, k
        assert np.mean(a.numpy() == np.asarray(ja)) >= 0.999, k


def test_separation_at_the_counted_k(c1_count):
    """``separate_auto_k`` counts as the JAX package counts, serves each
    mixture at its count (the port's own ``separate(n_speakers=k)``), and at
    k <= 2 agrees with the JAX package's ``separate`` to 30 dB.  At k = 3 the
    k-means seeding tie (ROADMAP C.2) sends the two to different fixed points
    on these mixtures, which the test above covers without the tie."""
    (jm, jp), model = c1_count
    mixes = [m for k in (1, 2, 3) for m in test_mixtures(k, 2, offset=4)[0]]
    ks, ests, rtf = count.separate_auto_k(model, mixes, device="cpu")
    want_k = np.asarray(jcount.count_speakers(jm, jp, jnp.asarray(np.stack(mixes)), k_max=4))
    assert ks == want_k.tolist() and rtf > 0
    for k in set(ks):  # each group is one batch of the port's own separate at k
        idx = [i for i, ki in enumerate(ks) if ki == k]
        own = model.separate(torch.from_numpy(np.stack([mixes[i] for i in idx])),
                             frame_mask=torch.ones(len(idx), model.cfg.front.frames_for(T)),
                             n_speakers=k).numpy()
        for j, i in enumerate(idx):
            np.testing.assert_array_equal(ests[i], own[j])
    for mix, k, est in zip(mixes, ks, ests):
        assert est.shape == (k, T) and np.isfinite(est).all()
        if k > 2:
            continue
        want = np.array(jm.separate(jp, jnp.asarray(mix[None]), n_speakers=k))[0]
        e, r = torch.tensor(est, dtype=torch.float64), torch.from_numpy(want).double()
        best = max(float(si_sdr(e[list(p)], r).mean()) for p in itertools.permutations(range(k)))
        assert best >= 30.0, (k, best)


def _reference_numbers(n_count: int = 50, n_sep: int = 32) -> dict:
    """The JAX package on its own corpus writer and Mixer, in float32 on the
    CPU: ``scripts/r3_wave.py::count_accuracy`` (n_count per k) and
    ``count_sep_eval_model`` (n_sep per k) for checkpoints/c1_count."""
    import tempfile

    from amss_tpu.data.mixer import Mixer as JMixer
    from amss_tpu.data.store import SpeakerStore as JStore
    from amss_tpu.data.synthetic import make_synthetic_corpus as j_make
    from amss_tpu.infer.evaluate import evaluate_separation

    jm, jp = j_load(RUN)
    with tempfile.TemporaryDirectory() as root:
        j_make(root, n_speakers=30, seconds_per_speaker=40.0, version=2, seed=0)
        store = JStore(root)

        def draw(k, n):
            mixer = JMixer(store, nb_speakers=k, chunk_samples=T, seed=0)
            refs = np.stack([mixer.batch("test", i, 1).sources[0] for i in range(n)])
            port_mix, _ = test_mixtures(k, 2)
            assert np.array_equal(port_mix, refs[:2].sum(axis=1))  # the port draws the same
            return refs.sum(axis=1), refs

        out = {"accuracy": {}, "confusion": {}, "auto_k": {}}
        for k in (1, 2, 3):
            mixes, refs = draw(k, max(n_count, n_sep))
            est = np.concatenate([np.asarray(jcount.count_speakers(
                jm, jp, jnp.asarray(mixes[i:i + 10]), k_max=4)) for i in range(0, n_count, 10)])
            out["accuracy"][k] = float(np.mean(est == k))
            out["confusion"][k] = {int(a): int(c) for a, c in zip(*np.unique(est, return_counts=True))}
            ok = np.flatnonzero(est[:n_sep] == k)
            if k > 1 and ok.size:
                sep = np.asarray(jm.separate(jp, jnp.asarray(mixes[ok]), n_speakers=k))
                r = evaluate_separation(sep, refs[ok], mixes[ok], per_utt=True)
                out["auto_k"][k] = {"si_sdri": r["si_sdri"], "ci": r["si_sdri_ci"], "n": int(ok.size),
                                    "count_acc": float(ok.size / n_sep)}
    return out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(_reference_numbers()))
