"""The JAX package's parameter tree and the port's named tensors, each from
the other, with no model module: a serving artifact (``infer/export.py``)
reads its parameters in the JAX layout and hands the named tensors to its
programs.  ``weights.py`` documents the layouts.

A dense ``{w, b}`` is ``weight = wᵀ`` and ``bias``; a BLSTM layer ``{fwd,
bwd}`` is an ``nn.LSTM``'s ``weight_ih_l<i>``, ``weight_hh_l<i>``,
``bias_ih_l<i>`` and a zero ``bias_hh_l<i>`` (``_reverse`` for ``bwd``); a
list's entries are keyed "0", "1", ... as a checkpoint stores them."""

from __future__ import annotations

import numpy as np
import torch


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
    """Named tensors of a JAX subtree: a dense ``{w, b}`` (or a bias-free
    ``{w}``) becomes ``weight = wᵀ`` and ``bias``, a list's entries are named
    by their index, every other key keeps its name."""
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if not isinstance(tree, dict):
        return {prefix[:-1]: _t(tree)}
    if set(tree) == {"fwd", "bwd"}:  # one BLSTM layer of a dual-path block
        return {f"{prefix}lstm.{k}": v for k, v in lstm_state([tree]).items()}
    if set(tree) in ({"w", "b"}, {"w"}):  # a dense, with or without its bias
        out = {prefix + "weight": _t(tree["w"]).T}
        if "b" in tree:
            out[prefix + "bias"] = _t(tree["b"])
        return out
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
