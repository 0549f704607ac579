"""Int8 parameter compression (``amss_tpu_torch/infer/quantize.py``) on the
CPU, against the JAX package's ``amss_tpu/infer/quantize.py``: the encoding
bit for bit on the same state dicts, its error bound and eligibility rules,
and int8 artifacts: the offline one equal to the live model on the
dequantized weights (atol 2e-5, the export tests' bound) and to the JAX
package's int8 artifact, the realtime one to the offline separation of the
dequantized model (atol 1e-4, streamed against offline)."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from amss_tpu.infer import quantize as jq
from amss_tpu.infer.export import ServingArtifact as JArtifact
from amss_tpu.infer.export import export_serving as j_export
from amss_tpu.models.tasnet import TasNetModel as JTasNet
from amss_tpu_torch.infer import quantize as q
from amss_tpu_torch.infer.export import (
    RealtimeArtifact,
    ServingArtifact,
    export_realtime,
    export_serving,
)
from amss_tpu_torch.infer.streaming import BucketSpec, StreamingSeparator
from amss_tpu_torch.utils.config import FrontConfig, ModelConfig, SeparatorConfig
from amss_tpu_torch.weights import params_from_jax, params_to_jax
from test_quantize import _cfg

torch.set_num_threads(2)


def _port_cfg(jcfg) -> ModelConfig:
    d = dataclasses.asdict(jcfg)
    return ModelConfig(front=FrontConfig(**d.pop("front")), sep=SeparatorConfig(**d.pop("sep")),
                       **d)


def _state_dict(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "w": (rng.standard_normal((64, 48)) * 3.0).astype(np.float32),
        "outlier": np.concatenate([rng.standard_normal((80, 15)),
                                   100 * rng.standard_normal((80, 1))], axis=1).astype(np.float32),
        "zero_col": np.concatenate([rng.standard_normal((40, 30)), np.zeros((40, 2))],
                                   axis=1).astype(np.float32),
        "conv": rng.standard_normal((3, 16, 32)).astype(np.float32),
        "bias": rng.standard_normal(128).astype(np.float32),
        "tiny": rng.standard_normal((4, 4)).astype(np.float32),
        "f64": rng.standard_normal((64, 64)),
        "nested": {"a": {"w": rng.standard_normal((32, 40)).astype(np.float32)}},
        "step": np.int32(7),
    }


def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("min_size", [1, 512, q.MIN_SIZE])
def test_encoding_is_the_jax_packages(min_size):
    assert q.MIN_SIZE == jq.MIN_SIZE
    sd = _state_dict(min_size)
    ours, theirs = q.quantize_state_dict(sd, min_size), jq.quantize_state_dict(sd, min_size)
    _assert_trees_equal(ours, theirs)
    _assert_trees_equal(q.dequantize_state_dict(ours), jq.dequantize_state_dict(theirs))
    assert q.quantized_fraction(ours) == jq.quantized_fraction(theirs)


def test_leaf_error_bound_and_eligibility():
    sd = _state_dict(0)
    enc = q.quantize_state_dict(sd, min_size=512)
    d = q.dequantize_state_dict(enc)
    for name in ("w", "outlier"):
        col_max = np.max(np.abs(sd[name]), axis=0)
        # symmetric round to nearest: |err| <= scale / 2 = col_max / 254
        assert np.all(np.abs(d[name] - sd[name]) <= col_max / 254.0 + 1e-7), name
    assert d["bias"] is sd["bias"] and d["tiny"] is sd["tiny"] and d["f64"] is sd["f64"]
    assert d["step"] == 7
    # the JAX test's dict: most of its bytes are eliminated
    jax_test = {k: sd[k] for k in ("w", "outlier", "bias", "tiny", "step")}
    assert 0.6 < q.quantized_fraction(q.quantize_state_dict(jax_test, min_size=512)) < 0.76


def test_quantize_idempotent_on_roundtrip():
    sd = {"w": np.random.default_rng(1).standard_normal((64, 64)).astype(np.float32)}
    once = q.dequantize_state_dict(q.quantize_state_dict(sd, min_size=1))
    twice = q.dequantize_state_dict(q.quantize_state_dict(once, min_size=1))
    np.testing.assert_array_equal(once["w"], twice["w"])


def _waves(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(t).astype(np.float32) * 0.3 for t in lengths]


def test_serving_artifact_int8_equals_live_on_dequantized(tmp_path):
    jm = JTasNet(_cfg())
    jp = jm.init(jax.random.PRNGKey(0))
    model = params_from_jax(_port_cfg(_cfg()), jax.tree_util.tree_map(np.asarray, jp),
                            device="cpu")
    out, ref, jout = str(tmp_path / "q8"), str(tmp_path / "f32"), str(tmp_path / "jq8")
    export_serving(model, out, lengths=(1024,), batch=2, platforms=("cpu",), quantize="int8")
    export_serving(model, ref, lengths=(1024,), batch=2, platforms=("cpu",))
    j_export(jm, jp, jout, lengths=(1024,), batch=2, platforms=("cpu",), quantize="int8")
    size = os.path.getsize(os.path.join(out, "params.msgpack"))
    assert size < 0.5 * os.path.getsize(os.path.join(ref, "params.msgpack"))
    assert size == os.path.getsize(os.path.join(jout, "params.msgpack"))

    art = ServingArtifact(out, device="cpu")
    assert art.meta["params_quantize"] == "int8"
    assert art.meta["params_bytes_saved_frac"] == JArtifact(jout).meta["params_bytes_saved_frac"]
    waves = _waves((1000, 700), seed=2)
    got = art.separate_all(waves)

    deq = params_from_jax(model.cfg, q.dequantize_state_dict(q.quantize_state_dict(
        params_to_jax(model))), device="cpu")
    live = StreamingSeparator(deq, buckets=BucketSpec(lengths=(1024,)),
                              device="cpu").separate_all(waves, max_batch=2)
    want = JArtifact(jout).separate_all(waves)
    base = ServingArtifact(ref, device="cpu").separate_all(waves)
    for g, v, j, b in zip(got, live, want, base):
        np.testing.assert_allclose(g, v, atol=2e-5)
        np.testing.assert_allclose(g, j, atol=2e-5)
        # the rounding itself is mild
        assert np.linalg.norm(g - b) / (np.linalg.norm(b) + 1e-9) < 0.15


def test_realtime_artifact_int8(tmp_path):
    jm = JTasNet(_cfg(causal=True))
    jp = jm.init(jax.random.PRNGKey(0))
    model = params_from_jax(_port_cfg(_cfg(causal=True)), jax.tree_util.tree_map(np.asarray, jp),
                            device="cpu")
    out = str(tmp_path / "rt_q8")
    export_realtime(model, out, chunk_samples=256, platforms=("cpu",), quantize="int8")
    art = RealtimeArtifact(out, device="cpu")
    assert art.meta["params_quantize"] == "int8"
    wave = _waves((1024,), seed=3)[0]
    est = art.separate_stream(wave)
    deq = params_from_jax(model.cfg, q.dequantize_state_dict(q.quantize_state_dict(
        params_to_jax(model))), device="cpu")
    with torch.no_grad():
        want = deq.separate(torch.from_numpy(wave[None]))[0].numpy()
    assert est.shape == (2, 1024) and float(np.abs(est).max()) > 0
    np.testing.assert_allclose(est, want, atol=1e-4)
