"""Carrying parameters between the JAX package's tree and the port's modules,
in both directions.

The JAX tree is ``{"front": front, "separator": {"blstm": layers, "proj":
{w, b}}}``, each BLSTM layer ``{"fwd": {wx, wh, b}, "bwd": {...}}``.  The
front is ``{}`` for the STFT front (its bases are buffers computed from the
config) and ``{enc, dec, smooth}`` for the adaptive front, in the port's
layouts; the autoencoder's tree has the front alone.  A checkpoint keys the
layers "0", "1", ...; the port's names are those of ``named_parameters()``
(``front.enc``, ``blstm.lstm.*``, ``proj.*``)."""

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


def named_from_jax(tree: dict) -> dict:
    """The port's named tensors (``front.*``, ``blstm.lstm.*``, ``proj.*``)
    from a JAX parameter tree, ``bias_hh`` included as zeros."""
    named = {"front." + k: _t(v) for k, v in tree.get("front", {}).items()}
    sep = tree.get("separator")
    if sep is not None:
        named.update({"blstm.lstm." + k: v for k, v in lstm_state(sep["blstm"]).items()})
        named["proj.weight"] = _t(sep["proj"]["w"]).T
        named["proj.bias"] = _t(sep["proj"]["b"])
    return named


def _np(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.detach().to("cpu", torch.float32).numpy())


def jax_tree(named: dict, layers: int) -> dict:
    """The JAX tree, as numpy arrays, of named tensors laid out as the port's
    parameters: the parameters themselves, or Adam's moments or gradients of
    them.  ``b = bias_ih + bias_hh`` where both are present, else ``bias_ih``.
    Layers are keyed "0", "1", ... as a checkpoint stores them.  Without a
    ``proj.weight`` (the autoencoder) the tree has the front alone."""
    front = {n[len("front."):]: _np(v) for n, v in named.items() if n.startswith("front.")}
    if "proj.weight" not in named:
        return {"front": front}
    blstm = {}
    for i in range(layers):
        layer = {}
        for direction, sfx in (("fwd", f"_l{i}"), ("bwd", f"_l{i}_reverse")):
            pre = "blstm.lstm."
            b = named[pre + "bias_ih" + sfx]
            if pre + "bias_hh" + sfx in named:
                b = b + named[pre + "bias_hh" + sfx]
            layer[direction] = {"wx": _np(named[pre + "weight_ih" + sfx].T),
                                "wh": _np(named[pre + "weight_hh" + sfx].T), "b": _np(b)}
        blstm[str(i)] = layer
    proj = {"w": _np(named["proj.weight"].T), "b": _np(named["proj.bias"])}
    return {"front": front, "separator": {"blstm": blstm, "proj": proj}}


def params_to_jax(model: DPCLModel) -> dict:
    """The inverse of ``params_from_jax``: the model's parameters as the JAX
    package's tree of numpy arrays, in the checkpoint's layout."""
    return jax_tree(dict(model.named_parameters()), model.cfg.sep.layers)


def params_from_jax(cfg: ModelConfig, params: dict, device=None) -> DPCLModel:
    """A ``DPCLModel`` holding a JAX parameter tree given as numpy arrays.

    ``params`` is ``{"front": front, "separator": {"blstm": layers, "proj":
    {w, b}}}`` with ``layers`` a list, or a dict keyed "0", "1", ... as a
    checkpoint stores it.  Each LSTM direction maps as ``weight_ih = wxᵀ``,
    ``weight_hh = whᵀ``, ``bias_ih = b``, ``bias_hh = 0``; the dense head as
    ``weight = wᵀ``; a learned front's tensors as they are."""
    device = resolve_device(device)
    model = DPCLModel(cfg)
    sep = params["separator"]
    layers = sep["blstm"]
    if len(layers) != cfg.sep.layers:
        raise ValueError(f"{len(layers)} BLSTM layers in the params, config says {cfg.sep.layers}")
    state = named_from_jax(params)
    # the STFT front's bases are buffers computed from the config
    state.update({k: v for k, v in model.named_buffers() if k.startswith("front.")})
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
