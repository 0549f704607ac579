"""Carrying the JAX package's parameters into the port's modules."""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from amss_tpu_torch.ckpt.checkpoint import load_params
from amss_tpu_torch.models.dpcl import DPCLModel
from amss_tpu_torch.utils.config import ModelConfig, recipe_from_dict
from amss_tpu_torch.utils.device import resolve_device


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a writable copy


def lstm_state(layers) -> dict:
    """``nn.LSTM(bidirectional=True)`` state from JAX BLSTM layers
    ``[{"fwd": {wx, wh, b}, "bwd": {...}}, ...]`` (a list, or a dict keyed
    "0", "1", ... as a checkpoint stores it)."""
    if isinstance(layers, dict):
        layers = [layers[str(i)] for i in range(len(layers))]
    state = {}
    for i, layer in enumerate(layers):
        for direction, sfx in (("fwd", f"_l{i}"), ("bwd", f"_l{i}_reverse")):
            p = layer[direction]
            state["weight_ih" + sfx] = _t(p["wx"]).T
            state["weight_hh" + sfx] = _t(p["wh"]).T
            state["bias_ih" + sfx] = _t(p["b"])
            state["bias_hh" + sfx] = torch.zeros_like(_t(p["b"]))
    return state


def params_from_jax(cfg: ModelConfig, params: dict, device=None) -> DPCLModel:
    """A ``DPCLModel`` holding a JAX parameter tree given as numpy arrays.

    ``params`` is ``{"front": {}, "separator": {"blstm": layers, "proj": {w, b}}}``
    with ``layers`` a list, or a dict keyed "0", "1", ... as a checkpoint
    stores it.  Each LSTM direction maps as ``weight_ih = wxᵀ``,
    ``weight_hh = whᵀ``, ``bias_ih = b``, ``bias_hh = 0``; the dense head as
    ``weight = wᵀ``."""
    device = resolve_device(device)
    model = DPCLModel(cfg)
    sep = params["separator"]
    layers = sep["blstm"]
    if len(layers) != cfg.sep.layers:
        raise ValueError(f"{len(layers)} BLSTM layers in the params, config says {cfg.sep.layers}")
    state = {"blstm.lstm." + k: v for k, v in lstm_state(layers).items()}
    state["proj.weight"] = _t(sep["proj"]["w"]).T
    state["proj.bias"] = _t(sep["proj"]["b"])
    # the front's bases are buffers computed from the config, not parameters
    state.update({k: v for k, v in model.state_dict().items() if k.startswith("front.")})
    model.load_state_dict(state, strict=True)
    return model.to(device).eval()


def load_model_from_run(run_dir: str, device=None) -> DPCLModel:
    """Rebuild a trained model from a run dir (config.json + best checkpoint)."""
    device = resolve_device(device)
    with open(os.path.join(run_dir, "config.json")) as f:
        recipe = recipe_from_dict(json.load(f))
    if recipe.model.kind != "dpcl":
        raise NotImplementedError(f"model kind {recipe.model.kind!r} is not ported yet")
    return params_from_jax(recipe.model, load_params(run_dir), device=device)
