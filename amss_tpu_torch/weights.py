"""Carrying parameters between the JAX package's tree and the port's modules,
in both directions.

The JAX tree is ``{"front": front, "separator": separator}``.  The front is
``{}`` for the STFT front (its bases are buffers computed from the config)
and ``{enc, dec, smooth}`` for the adaptive front, in the port's layouts;
the autoencoder's tree has the front alone.  The separator is

* a trunk: ``{"blstm": layers}``, each BLSTM layer ``{"fwd": {wx, wh, b},
  "bwd": {...}}``, in one ``nn.LSTM``; ``{"tcn": {in_proj, blocks,
  out_alpha}}``, each block ``{pw_in, a1, ln1: {g, b}, dw, a2, ln2, pw_res,
  pw_skip}``, under the same names in the port (``tcn.blocks.<i>.ln1.g``);
  ``{"dprnn": {in_proj, blocks}}``, each block ``{intra, inter}`` of
  ``{lstm: {fwd, bwd}, proj, ln}``, the one-layer ``lstm`` in a ``BLSTM``
  (``dprnn.blocks.<i>.intra.lstm.lstm.weight_ih_l0``); or ``{"dpt":
  {in_proj, blocks}}``, each path ``{ln1, attn: {wq, wk, wv, wo}, ln2, ffn:
  {w1, w2}}``;
* the heads beside it, under their names: deep clustering ``proj``, L41
  ``proj`` and ``centroids [n_train_speakers, E]``, Chimera ``proj_embed``
  and ``proj_mask``, TasNet (c6, and c7 with ``causal=True``) ``proj_mask``.

The enhancer's tree is ``{"separator": {"blstm", "proj"}}`` alone, with no
front: its base comes from the run dir that its config's ``base_run`` names.

A dense ``{w [in, out], b}`` is an ``nn.Linear`` with ``weight = wᵀ``.  A
checkpoint keys a list's entries "0", "1", ...; the port's names are those
of ``named_parameters()``."""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from amss_tpu_torch.ckpt.checkpoint import load_params
from amss_tpu_torch.models.chimera import ChimeraModel
from amss_tpu_torch.models.dpcl import DPCLModel
from amss_tpu_torch.models.enhance import EnhancerModel
from amss_tpu_torch.models.l41 import L41Model
from amss_tpu_torch.models.tasnet import TasNetModel
from amss_tpu_torch.utils.config import ModelConfig, recipe_from_dict
from amss_tpu_torch.utils.device import resolve_device

_MODELS = {"dpcl": DPCLModel, "tasnet": TasNetModel, "l41": L41Model,
           "chimera": ChimeraModel}
Separator = DPCLModel | TasNetModel | L41Model | ChimeraModel | EnhancerModel


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


def _flatten(tree, prefix: str) -> dict:
    """Named tensors of a JAX subtree: a dense ``{w, b}`` becomes ``weight =
    wᵀ`` and ``bias``, a list's entries are named by their index, every other
    key keeps its name."""
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if not isinstance(tree, dict):
        return {prefix[:-1]: _t(tree)}
    if set(tree) == {"fwd", "bwd"}:  # one BLSTM layer of a dual-path block
        return {f"{prefix}lstm.{k}": v for k, v in lstm_state([tree]).items()}
    if set(tree) == {"w", "b"}:
        return {prefix + "weight": _t(tree["w"]).T, prefix + "bias": _t(tree["b"])}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}{k}."))
    return out


def named_from_jax(tree: dict) -> dict:
    """The port's named tensors (``front.*``, then ``blstm.lstm.*``,
    ``tcn.*``, ``dprnn.*`` or ``dpt.*``, then the heads' ``proj.*``,
    ``centroids``, ``proj_embed.*``, ``proj_mask.*``) from a JAX parameter
    tree, ``bias_hh`` included as zeros."""
    named = {"front." + k: _t(v) for k, v in tree.get("front", {}).items()}
    sep = tree.get("separator")
    if sep is None:
        return named
    for key, sub in sep.items():
        if key == "blstm":
            named.update({"blstm.lstm." + k: v for k, v in lstm_state(sub).items()})
        else:
            named.update(_flatten(sub, key + "."))
    return named


def _np(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.detach().to("cpu", torch.float32).numpy())


def _unflatten(named: dict) -> dict:
    """The inverse of ``_flatten``: ``weight`` and ``bias`` back to ``w =
    weightᵀ`` and ``b``, a list's entries keyed "0", "1", ... as a checkpoint
    stores them."""
    tree: dict = {}
    for name, v in named.items():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        if leaf == "weight":
            node["w"] = _np(v.T)
        elif leaf == "bias":
            node["b"] = _np(v)
        else:
            node[leaf] = _np(v)
    return tree


def _lstm_layers(named: dict, pre: str, layers: int) -> dict:
    """BLSTM layers ``{"0": {"fwd": {wx, wh, b}, "bwd": ...}, ...}`` from the
    ``nn.LSTM`` tensors named ``pre + weight_ih_l0`` and so on."""
    out = {}
    for i in range(layers):
        layer = {}
        for direction, sfx in (("fwd", f"_l{i}"), ("bwd", f"_l{i}_reverse")):
            b = named[pre + "bias_ih" + sfx]
            if pre + "bias_hh" + sfx in named:
                b = b + named[pre + "bias_hh" + sfx]
            layer[direction] = {"wx": _np(named[pre + "weight_ih" + sfx].T),
                                "wh": _np(named[pre + "weight_hh" + sfx].T), "b": _np(b)}
        out[str(i)] = layer
    return out


def jax_tree(named: dict, layers: int | None = None, with_front: bool = True) -> dict:
    """The JAX tree, as numpy arrays, of named tensors laid out as the port's
    parameters: the parameters themselves, or Adam's moments or gradients of
    them.  For a BLSTM ``b = bias_ih + bias_hh`` where both are present, else
    ``bias_ih``; the trunk's stack ``blstm`` has ``layers`` layers (by default
    as many as the names hold), a dual-path block's ``lstm`` is one layer.
    Without a head (the autoencoder) the tree has the front alone; without
    ``with_front`` (the enhancer) the separator alone."""
    front = {n[len("front."):]: _np(v) for n, v in named.items() if n.startswith("front.")}
    rest = {n: v for n, v in named.items() if not n.startswith("front.")}
    key = ".lstm.weight_ih_l0"
    lstms = sorted({n[: n.index(key)] for n in rest if key in n})
    sep = _unflatten({n: v for n, v in rest.items()
                      if not any(n.startswith(p + ".lstm.") for p in lstms)})
    for p in lstms:
        if p == "blstm":
            n_layers = layers or sum(1 for n in rest if n.startswith("blstm.lstm.weight_ih_l")
                                     and not n.endswith("_reverse"))
            sep["blstm"] = _lstm_layers(rest, "blstm.lstm.", n_layers)
            continue
        *path, leaf = p.split(".")
        node = sep
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = _lstm_layers(rest, p + ".lstm.", 1)["0"]
    if not with_front:
        return {"separator": sep}
    return {"front": front, "separator": sep} if sep else {"front": front}


def params_to_jax(model: Separator) -> dict:
    """The inverse of ``params_from_jax``: the model's parameters as the JAX
    package's tree of numpy arrays, in the checkpoint's layout."""
    return jax_tree(dict(model.named_parameters()),
                    with_front=not isinstance(model, EnhancerModel))


def params_from_jax(cfg: ModelConfig, params: dict, device=None,
                    base: Separator | None = None) -> Separator:
    """The model of ``cfg.kind`` (``dpcl``, ``tasnet``, ``l41``, ``chimera``,
    or ``enhance`` over ``base``) holding a JAX parameter tree given as numpy
    arrays (lists, or dicts keyed "0", "1", ... as a checkpoint stores them).
    Each LSTM direction maps as ``weight_ih = wxᵀ``, ``weight_hh = whᵀ``,
    ``bias_ih = b``, ``bias_hh = 0``; each dense as ``weight = wᵀ``;
    everything else as it is."""
    device = resolve_device(device)
    if cfg.kind == "enhance":
        if base is None:
            raise ValueError("an enhance model needs its base separator")
        model = EnhancerModel(cfg, base)
    elif cfg.kind in _MODELS:
        model = _MODELS[cfg.kind](cfg)
    else:
        raise ValueError(f"model kind {cfg.kind!r} has no separator to load")
    sep = params["separator"]
    if "blstm" in sep and len(sep["blstm"]) != cfg.sep.layers:
        raise ValueError(f"{len(sep['blstm'])} BLSTM layers in the params, config says "
                         f"{cfg.sep.layers}")
    state = named_from_jax(params)
    # the STFT front's bases are buffers computed from the config
    state.update({k: v for k, v in model.named_buffers() if k.startswith("front.")})
    model.load_state_dict(state, strict=True)
    return model.to(device).eval()


def load_model_from_run(run_dir: str, device=None) -> Separator:
    """Rebuild a trained model from a run dir (config.json + best checkpoint).
    An enhance run's base is rebuilt from the ``base_run`` its config
    records, recursively for stacked stages."""
    device = resolve_device(device)
    with open(os.path.join(run_dir, "config.json")) as f:
        recipe = recipe_from_dict(json.load(f))
    base = None
    if recipe.model.kind == "enhance":
        if not recipe.base_run:
            raise ValueError(f"enhance run {run_dir} records no base_run")
        base = load_model_from_run(recipe.base_run, device=device)
    return params_from_jax(recipe.model, load_params(run_dir), device=device, base=base)
