"""Serving artifacts (``amss_tpu_torch/infer/export.py``) on the CPU, against
the JAX package's (``amss_tpu/infer/export.py``) on the same weights (the JAX
init carried across with ``params_from_jax``) and inputs drawn from numpy
seeds.

* The JAX test's tiny TasNet: the port's artifact against the JAX package's
  ``ServingArtifact`` and against the port's live ``StreamingSeparator`` on a
  ragged corpus, atol 2e-5 (the JAX test's own bound; float32 sums in other
  orders); against the live path alone on a corpus with an utterance shorter
  than one window, a ragged group and an over-bucket utterance; the exact
  batch API, and long-form through the artifact.
* A tiny c1 at STFT 256/64, where the gate is open: the exported graph holds
  the two kernels' operators, and a fresh process separates through the
  artifact with no model module imported.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from amss_tpu.infer.export import ServingArtifact as JArtifact
from amss_tpu.infer.export import export_serving as j_export
from amss_tpu.models.tasnet import TasNetModel as JTasNet
from amss_tpu_torch.infer.export import ServingArtifact, export_serving
from amss_tpu_torch.infer.long import separate_long
from amss_tpu_torch.infer.streaming import BucketSpec, StreamingSeparator, frame_mask
from amss_tpu_torch.models.dpcl import DPCLModel
from amss_tpu_torch.utils.config import FrontConfig, ModelConfig, SeparatorConfig
from amss_tpu_torch.weights import params_from_jax
from test_export import _tiny_cfg, _waves

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 2e-5
LENGTHS = (1024, 4096)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_cfg(jcfg) -> ModelConfig:
    import dataclasses

    d = dataclasses.asdict(jcfg)
    return ModelConfig(front=FrontConfig(**d.pop("front")), sep=SeparatorConfig(**d.pop("sep")),
                       **d)


@pytest.fixture(scope="module")
def tasnet(tmp_path_factory):
    """(port model, port artifact dir, JAX artifact dir) of the tiny TasNet."""
    jm = JTasNet(_tiny_cfg())
    jp = jm.init(jax.random.PRNGKey(0))
    root = tmp_path_factory.mktemp("exp")
    j_dir, p_dir = str(root / "jax"), str(root / "port")
    j_export(jm, jp, j_dir, lengths=LENGTHS, batch=4, platforms=("cpu",))
    model = params_from_jax(port_cfg(_tiny_cfg()), _np(jp), device="cpu")
    export_serving(model, p_dir, lengths=LENGTHS, batch=4, platforms=("cpu",))
    return model, p_dir, j_dir


def test_artifact_files_and_meta(tasnet):
    _, p_dir, j_dir = tasnet
    names = sorted(os.listdir(p_dir))
    assert names == ["export_meta.json", "params.msgpack", "serving_t1024_b4.cpu.pt2",
                     "serving_t4096_b4.cpu.pt2"]
    meta = json.load(open(os.path.join(p_dir, "export_meta.json")))
    jmeta = json.load(open(os.path.join(j_dir, "export_meta.json")))
    assert set(meta) == set(jmeta) - {"jax_version"} | {"torch_version"}
    for key in ("format_version", "kind", "batch", "n_speakers", "sample_rate", "front"):
        assert meta[key] == jmeta[key], key
    assert [(b["length"], b["frames"]) for b in meta["buckets"]] == [
        (b["length"], b["frames"]) for b in jmeta["buckets"]]
    assert [b["files"] for b in meta["buckets"]] == [
        {"cpu": f"serving_t{t}_b4.cpu.pt2"} for t in LENGTHS]
    # the parameter blob is the JAX package's, byte for byte
    assert (open(os.path.join(p_dir, "params.msgpack"), "rb").read()
            == open(os.path.join(j_dir, "params.msgpack"), "rb").read())


def test_programs_hold_no_parameter(tasnet):
    """The parameters are program inputs: a program keeps no state dict,
    and its file is far smaller than the parameters it was traced on."""
    _, p_dir, _ = tasnet
    ep = torch.export.load(os.path.join(p_dir, "serving_t1024_b4.cpu.pt2"))
    assert not ep.state_dict
    kinds = {s.kind.name for s in ep.graph_signature.input_specs}
    assert kinds <= {"USER_INPUT", "CONSTANT_TENSOR"}
    assert ep.example_inputs is None


@pytest.mark.parametrize("lengths,calls,against_jax", [
    ([900, 1024, 2000, 4096, 3000], 2, True),
    # shorter than one window (a negative frame count: ROADMAP C.4, the JAX
    # side's fault, so the live path alone), a ragged group, over-bucket
    ([5, 600, 9000, 700, 900, 1024, 2000, 3000, 3500, 4096], 4, False),
], ids=["jax_and_live", "live_short_ragged_long"])
def test_artifact_matches_jax_artifact_and_live(tasnet, lengths, calls, against_jax):
    model, p_dir, j_dir = tasnet
    waves = _waves(lengths)
    art = ServingArtifact(p_dir, device="cpu")
    got = art.separate_all(waves)
    sep = StreamingSeparator(model, buckets=BucketSpec(lengths=LENGTHS), device="cpu")
    live = sep.separate_all(waves, max_batch=4)
    assert art.meter.utterances == sep.meter.utterances == len(waves)
    assert art.meter.calls == sep.meter.calls == calls
    assert art.meter.warmup_seconds > 0 and np.isfinite(art.meter.rtf)
    short = frame_mask(art.front, LENGTHS[0], [min(lengths)], 2)  # the loop's masks
    assert short.sum() == max(art.front.frames_for(min(lengths)), 0) and not short[1].any()
    want = JArtifact(j_dir).separate_all(waves) if against_jax else live
    for g, w, v, x in zip(got, want, live, waves):
        assert g.shape == w.shape == (2, len(x))
        np.testing.assert_allclose(g, w, atol=ATOL)
        np.testing.assert_allclose(g, v, atol=ATOL)


def test_exact_batch_api(tasnet):
    _, p_dir, j_dir = tasnet
    art = ServingArtifact(p_dir, device="cpu")
    mix = np.stack(_waves([1024] * 4))
    n_valid = np.array([1024, 1000, 600, 300])
    est = art.separate_batch(mix, n_valid)
    assert est.shape == (4, 2, 1024)
    np.testing.assert_allclose(est, JArtifact(j_dir).separate_batch(mix, n_valid), atol=ATOL)
    with pytest.raises(ValueError, match="exact-shape"):
        art.separate_batch(mix[:, :512])
    with pytest.raises(ValueError, match="largest exported bucket"):
        art.separate_batch(np.stack(_waves([9000] * 4)))


def test_long_form_through_artifact(tasnet):
    """An over-bucket utterance takes the artifact's chunked path: equal to
    the port's live ``separate_long`` and to the JAX package's artifact."""
    model, p_dir, j_dir = tasnet
    wave = _waves([9000], seed=11)[0]
    art = ServingArtifact(p_dir, device="cpu")
    got = art.separate_all([wave])[0]
    assert got.shape == (2, 9000) and art.meter.utterances == 1
    np.testing.assert_allclose(got, separate_long(model, wave, chunk=4096), atol=ATOL)
    np.testing.assert_allclose(got, JArtifact(j_dir).separate_all([wave])[0], atol=ATOL)


def test_int8_or_nothing_and_cuda_needs_a_card(tasnet, tmp_path, monkeypatch):
    model, p_dir, _ = tasnet
    with pytest.raises(ValueError, match="int8"):
        export_serving(model, str(tmp_path / "a"), lengths=(1024,), platforms=("cpu",),
                       quantize="int4")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        export_serving(model, str(tmp_path / "b"), lengths=(1024,), platforms=("cuda",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingArtifact(p_dir)  # cuda unless the caller names another device
    with pytest.raises(ValueError, match="programs for"):
        ServingArtifact(p_dir, device="cuda")


def _tiny_c1() -> DPCLModel:
    cfg = ModelConfig(kind="dpcl", front=FrontConfig(kind="stft", win=256, hop=64),
                      sep=SeparatorConfig(hidden=8, layers=2, embed_dim=5), nb_speakers=2)
    model = DPCLModel(cfg)
    model.init_parameters(torch.Generator().manual_seed(0))
    return model.eval()


@pytest.fixture(scope="module")
def c1_artifact(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("c1") / "art")
    export_serving(_tiny_c1(), out, lengths=(2048,), batch=2, platforms=("cpu",))
    return out


def test_c1_program_holds_both_kernels(c1_artifact):
    ep = torch.export.load(os.path.join(c1_artifact, "serving_t2048_b2.cpu.pt2"))
    ops = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert ops.count("amss.framed_matmul.default") == 1
    assert ops.count("amss.decode_ola.default") == 1
    assert "aten.lstm.input" in ops  # the traced BLSTM: no packing, no host copy
    assert not any("pack_padded" in op or "_local_scalar_dense" in op for op in ops)


def test_serving_without_model_code(c1_artifact):
    """A fresh process separates through the artifact with no model module
    (nor anything of JAX) imported."""
    code = f"""
import sys
import numpy as np
from amss_tpu_torch.infer.export import ServingArtifact
art = ServingArtifact({c1_artifact!r}, device="cpu")
est = art.separate_all([np.zeros(700, np.float32), np.ones(2048, np.float32),
                        np.ones(5000, np.float32)])
assert [e.shape for e in est] == [(2, 700), (2, 2048), (2, 5000)]
assert all(np.isfinite(e).all() for e in est)
banned = [m for m in sys.modules if m.startswith(("amss_tpu_torch.models", "amss_tpu_torch.train",
                                                  "amss_tpu_torch.weights", "jax", "amss_tpu."))]
assert not banned, banned
print("OK")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "OK" in r.stdout
