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

from amss_tpu_torch.ckpt.checkpoint import load_params
from amss_tpu_torch.ckpt.tree import (  # noqa: F401  (the port's callers import them here)
    _flatten,
    jax_tree,
    lstm_state,
    named_from_jax,
)
from amss_tpu_torch.models.adapt import AdaptAutoencoder
from amss_tpu_torch.models.chimera import ChimeraModel
from amss_tpu_torch.models.dpcl import DPCLModel
from amss_tpu_torch.models.enhance import EnhancerModel
from amss_tpu_torch.models.l41 import L41Model
from amss_tpu_torch.models.sepformer import DPRNNTasNetModel, SepFormerModel
from amss_tpu_torch.models.tasnet import TasNetModel
from amss_tpu_torch.models.tfgridnet import TFGridNetModel
from amss_tpu_torch.utils.config import ModelConfig, recipe_from_dict
from amss_tpu_torch.utils.device import resolve_device

# a model's kind -> its class (``train/engine.py::make_model`` reads it too);
# the enhancer, built over its base separator, is not in it
MODELS = {"dpcl": DPCLModel, "adapt_ae": AdaptAutoencoder, "tasnet": TasNetModel,
          "l41": L41Model, "chimera": ChimeraModel, "sepformer": SepFormerModel,
          "dprnn_tasnet": DPRNNTasNetModel, "tfgridnet": TFGridNetModel}
Separator = (DPCLModel | TasNetModel | L41Model | ChimeraModel | SepFormerModel
             | DPRNNTasNetModel | TFGridNetModel | EnhancerModel)


def params_to_jax(model: Separator) -> dict:
    """The inverse of ``params_from_jax``: the model's parameters as the JAX
    package's tree of numpy arrays, in the checkpoint's layout."""
    return jax_tree(dict(model.named_parameters()),
                    with_front=not isinstance(model, EnhancerModel))


def params_from_jax(cfg: ModelConfig, params: dict, device=None,
                    base: Separator | None = None) -> Separator:
    """The model of ``cfg.kind`` (``dpcl``, ``tasnet``, ``l41``, ``chimera``,
    ``sepformer``, ``dprnn_tasnet``, ``tfgridnet``, or ``enhance`` over ``base``) holding a
    JAX parameter tree given as numpy arrays (lists, or dicts keyed "0", "1",
    ... as a checkpoint stores them).
    Each LSTM direction maps as ``weight_ih = wxᵀ``, ``weight_hh = whᵀ``,
    ``bias_ih = b``, ``bias_hh = 0``; each dense as ``weight = wᵀ``;
    everything else as it is."""
    device = resolve_device(device)
    if cfg.kind == "enhance":
        if base is None:
            raise ValueError("an enhance model needs its base separator")
        model = EnhancerModel(cfg, base)
    elif cfg.kind in MODELS and cfg.kind != "adapt_ae":
        model = MODELS[cfg.kind](cfg)
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
