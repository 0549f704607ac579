"""The port's msgpack reader and writer against flax's, its checkpoint files,
and its config loader."""

import json
from pathlib import Path

import flax.serialization as fser
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amss_tpu_torch.ckpt.checkpoint import (
    AsyncCheckpointer, load_params, msgpack_restore, msgpack_serialize, read_manifest,
    restore_checkpoint, save_checkpoint, to_host)
from amss_tpu_torch.utils.config import recipe_from_dict

torch.set_num_threads(2)

RUN = Path(__file__).resolve().parents[1] / "checkpoints" / "c1_dpcl"


def _assert_same(got, want, path="", bf16_as_f32=False):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}", bf16_as_f32)
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}/{i}", bf16_as_f32)
    elif isinstance(want, (np.ndarray, np.generic)):
        want = np.asarray(want)
        got = np.asarray(got)
        if bf16_as_f32 and want.dtype.name == "bfloat16":
            want = want.astype(np.float32)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want), path
    else:
        assert type(got) is type(want) and got == want, path


def test_reads_the_c1_checkpoint_bit_for_bit():
    data = (RUN / "ckpt_best.msgpack").read_bytes()
    _assert_same(msgpack_restore(data), fser.msgpack_restore(data))


def test_reads_flax_blobs_bit_for_bit():
    rng = np.random.default_rng(0)
    tree = {
        "params": {
            "dense": {"w": rng.standard_normal((7, 5)).astype(np.float32),
                      "b": np.arange(5, dtype=np.int32)},
            "layers": [{"k": rng.standard_normal(3).astype(np.float32)},
                       {"k": np.zeros((0, 2), np.float32)}],
            "bf": jnp.asarray(rng.standard_normal((4, 3)), jnp.bfloat16),
        },
        "step": 12345,
        "neg": -77,
        "big": 2**40,
        "lr": 1e-3,
        "name": "c1_stft_dpcl",
        "long_name": "x" * 300,
        "nothing": None,
        "flag": True,
        "scalar": np.float32(2.5),
    }
    blob = fser.to_bytes(tree)
    _assert_same(msgpack_restore(blob), fser.msgpack_restore(blob), bf16_as_f32=True)


def test_bfloat16_decodes_exactly():
    x = jnp.asarray(np.random.default_rng(1).standard_normal(64), jnp.bfloat16)
    got = msgpack_restore(fser.to_bytes({"x": x}))["x"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(x, np.float32))


def test_rejects_unknown_extension_and_trailing_bytes():
    with pytest.raises(ValueError, match="extension type 2"):
        msgpack_restore(fser.to_bytes({"z": 1 + 2j}))
    with pytest.raises(ValueError, match="trailing"):
        msgpack_restore(fser.to_bytes({"a": 1}) + b"\x00")


def test_load_params_supplies_the_front_and_serves_the_params():
    params = load_params(str(RUN))
    assert params["front"] == {}
    w = params["separator"]["proj"]["w"]
    assert w.shape == (600, 5160) and w.dtype == np.float32


def test_config_loader_accepts_the_c1_config():
    raw = json.loads((RUN / "config.json").read_text())
    for key in ("heads", "kernel", "expansion"):
        assert key not in raw["model"]["sep"]
    recipe = recipe_from_dict(raw)
    m = recipe.model
    assert (m.kind, m.front.kind, m.front.win, m.front.hop) == ("dpcl", "stft", 256, 64)
    assert (m.sep.hidden, m.sep.layers, m.sep.embed_dim) == (300, 2, 40)
    assert m.front.feature_dim == 129 and m.front.frames_for(64000) == 997
    assert recipe.sample_rate == 8000


def test_writes_flax_bytes_bit_for_bit():
    rng = np.random.default_rng(2)
    tree = {
        "meta": {"step": 300, "metric": 0.25},
        "state": {
            "params": {"w": rng.standard_normal((7, 5)).astype(np.float32),
                       "big": np.ones(70_000, np.float32), "empty": np.zeros((0, 3), np.float32),
                       "i": np.arange(4, dtype=np.int32), "front": {}},
            "many": {str(i): i * 1000 for i in range(20)},
            "ints": {str(v): v for v in (0, 127, 128, 255, 256, 65_536, 2**33, -1, -32, -33,
                                         -129, -40_000, -2**40)},
            "step": np.asarray(12), "count": np.asarray(3, np.int32),
            "s": "x" * 31, "t": "y" * 32, "u": "z" * 300, "none": None, "flag": False,
            "scalar": np.float32(2.5), "f": 1e-3,
        },
    }
    # to_bytes keeps the dicts' order; the port writes what it is given
    assert msgpack_serialize(tree) == fser.to_bytes(tree)
    with pytest.raises(TypeError):
        msgpack_serialize({"t": (1, 2)})


def test_to_host_sorts_as_a_jax_tree_map():
    host = to_host({"b": torch.ones(2), "a": {"d": 3, "c": torch.zeros(1, dtype=torch.int32)}})
    assert list(host) == ["a", "b"] and list(host["a"]) == ["c", "d"]
    assert host["a"]["d"].dtype == np.int64 and host["a"]["c"].dtype == np.int32


def test_save_keeps_latest_and_best_and_restores(tmp_path):
    d = str(tmp_path)
    state = {"params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}, "step": 1}
    save_checkpoint(d, state, step=1, metric=0.5)
    state["params"]["w"] += 1
    save_checkpoint(d, state, step=2, metric=0.7)  # worse: best stays at step 1
    assert read_manifest(str(tmp_path / "ckpt_best.msgpack")) == {"step": 1, "metric": 0.5}
    latest, manifest = restore_checkpoint(d)
    assert manifest == {"step": 2, "metric": 0.7}
    np.testing.assert_array_equal(latest["params"]["w"], state["params"]["w"].numpy())
    best, _ = restore_checkpoint(d, best=True)
    np.testing.assert_array_equal(best["params"]["w"], state["params"]["w"].numpy() - 1)
    assert json.loads((tmp_path / "ckpt_latest.msgpack.json").read_text()) == manifest
    # flax reads it as the JAX package would
    raw = fser.msgpack_restore((tmp_path / "ckpt_latest.msgpack").read_bytes())
    assert raw["meta"] == manifest and int(raw["state"]["step"]) == 1
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".tmp_")]


def test_async_checkpointer_writes_in_order_and_reports_a_failure(tmp_path):
    ck = AsyncCheckpointer()
    for step in (1, 2, 3):
        ck.save(str(tmp_path), {"step": step}, step=step, metric=1.0 / step)
    ck.wait()
    assert read_manifest(str(tmp_path / "ckpt_latest.msgpack"))["step"] == 3
    blocked = tmp_path / "file"
    blocked.write_text("")
    ck.save(str(blocked / "sub"), {"step": 1}, step=1)
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        ck.wait()
