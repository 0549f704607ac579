"""Serving artifacts: separation without the model code
(``amss_tpu/infer/export.py``).

``export_serving`` traces ``model.separate`` once per (bucket, platform) with
``torch.export`` and writes each program beside one parameter blob; any
process with torch on that platform runs them, with no model class, no
config reconstruction and no tracing.  The hand-written kernels stay in
the programs as the operators ``amss::framed_matmul``, ``amss::decode_ola``,
``amss::kmeans`` and ``amss::soft_assignments`` (``ops/kernels``), so a loaded
CUDA program launches them, counted in their wrappers' ``launches``; the
BLSTM takes its ``traced`` path, which reads no host data, in float32, and
one operator a layer, ``amss::blstm_bf16_layer`` (``ops/blstm_bf16.py``), in
bfloat16.

A program is tied to the device it was traced on (its constants and the
tensors it makes live there), so there is one per (bucket, platform), and
``cuda`` programs are exported only where there is a card.  The parameters
are inputs of the programs, not constants in them: they are stored once, in
``params.msgpack``, in the JAX package's state-dict layout (``ckpt/tree.py``),
optionally int8-compressed (``infer/quantize.py``).

Directory layout (``export_serving``)::

    export_meta.json     format, kind, serving shapes, the front's config (for
                         the frame masks), n_speakers, provenance
    params.msgpack       the parameter tree (msgpack, as flax writes it)
    serving_t{T}_b{B}.{platform}.pt2
                         (params, mix [B, T], frame_mask [B, T']) -> est [B, S, T]

``export_realtime`` writes ``realtime_init.{platform}.pt2`` (``() -> state``)
and ``realtime_step_c{C}_b{B}.{platform}.pt2`` (``(params, state, chunk [B, C],
end_frame [B]) -> (block [B, S, C], state')``), the pure step of
``infer/realtime.py``.

``ServingArtifact`` and ``RealtimeArtifact`` run them with
``StreamingSeparator``'s and ``RealtimeSeparator``'s semantics (buckets,
padding, frame masks, the RTF meter; push, lag, end frames).  This module and
what it imports hold no model module, so loading an artifact imports none.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import json
import os
import time

import numpy as np
import torch

# the operators the programs call are registered when these are imported
import amss_tpu_torch.ops.blstm_bf16  # noqa: F401
import amss_tpu_torch.ops.kernels.framed_matmul  # noqa: F401
import amss_tpu_torch.ops.kernels.kmeans  # noqa: F401
import amss_tpu_torch.ops.kernels.ola  # noqa: F401
from amss_tpu_torch.ckpt.checkpoint import msgpack_restore, msgpack_serialize, to_host
from amss_tpu_torch.ckpt.tree import named_from_jax
from amss_tpu_torch.infer.long import chunk_layout, chunk_rows, stitch_chunks
from amss_tpu_torch.infer.quantize import (
    dequantize_state_dict,
    quantize_state_dict,
    quantized_fraction,
)
from amss_tpu_torch.infer.streaming import BucketedServing, RTFMeter, frame_mask
from amss_tpu_torch.utils.config import FrontConfig
from amss_tpu_torch.utils.device import resolve_device, synchronize

_FORMAT_VERSION = 1
_NO_END = np.iinfo(np.int32).max  # "no end frame", as ``infer/realtime.py`` says it


# -- parameters ----------------------------------------------------------------


def _write_params(out_dir: str, tree: dict, quantize: str | None) -> dict:
    """Write params.msgpack (int8-compressed with ``quantize="int8"``) and
    return the meta fields that say how it was stored."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unsupported quantize={quantize!r} (int8 or None)")
    blob, extra = tree, {}
    if quantize == "int8":
        blob = quantize_state_dict(tree)
        extra = {"params_quantize": "int8",
                 "params_bytes_saved_frac": round(quantized_fraction(blob), 4)}
    with open(os.path.join(out_dir, "params.msgpack"), "wb") as f:
        f.write(msgpack_serialize(to_host(blob)))
    return extra


def _restore_params(path: str, meta: dict) -> dict:
    """params.msgpack back to the float32 tree the programs take,
    dequantized where the artifact is int8-compressed."""
    with open(os.path.join(path, "params.msgpack"), "rb") as f:
        tree = msgpack_restore(f.read())
    if meta.get("params_quantize") == "int8":
        tree = dequantize_state_dict(tree)
    return tree


def _program_params(tree: dict, device: torch.device) -> dict:
    """The named tensors a program takes, in name order, on ``device``."""
    named = named_from_jax(tree)
    # contiguous: cuDNN's LSTM views its weights (``weight_ih = wxᵀ`` is not)
    return {k: named[k].contiguous().to(device) for k in sorted(named)}


def _model_tree(model) -> dict:
    """The model's parameters as the JAX package's tree, checked to name
    exactly the model's parameters (a name the program did not take would
    be traced in as a constant)."""
    from amss_tpu_torch.weights import params_to_jax

    tree = params_to_jax(model)
    got = set(named_from_jax(tree))
    want = {n for n, _ in model.named_parameters()}
    if got != want:
        raise ValueError(f"the parameter tree does not name the model's parameters: "
                         f"missing {sorted(want - got)}, extra {sorted(got - want)}")
    return tree


# -- tracing -------------------------------------------------------------------


class _Bound(torch.nn.Module):
    """``fn`` run with ``model`` as a submodule, so that
    ``torch.func.functional_call`` swaps the model's parameters for the call."""

    def __init__(self, model: torch.nn.Module, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


class _Program(torch.nn.Module):
    """What is exported: ``fn(*args)`` on the parameters given as the first
    input.  The model is held outside the module tree, so the exported
    program owns no parameter of its own."""

    def __init__(self, model: torch.nn.Module, fn):
        super().__init__()
        self._bound = [_Bound(model, fn)]

    def forward(self, params: dict, *args):
        named = {"model." + k: v for k, v in params.items()}
        return torch.func.functional_call(self._bound[0], named, args)


def _platform_device(platform: str) -> torch.device:
    if platform not in ("cpu", "cuda"):
        raise ValueError(f"platform {platform!r} is neither cpu nor cuda")
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda program is exported on a CUDA card, and none is available")
    return torch.device(platform)


def _save(program, args: tuple, path: str) -> None:
    with torch.no_grad():
        ep = torch.export.export(program, args)
    ep.example_inputs = None  # the file holds the program, not the parameters it was traced on
    torch.export.save(ep, path)


@contextlib.contextmanager
def _fp32():
    """cuDNN in FP32 around a program call: the traced BLSTM's LSTM calls
    read the global flag when the program runs, not when it was traced."""
    with torch.no_grad(), torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=False, allow_tf32=False):
        yield


def _meta_common(kind: str, model, platforms, sample_rate: int, recipe_dict, q_meta) -> dict:
    return {"format_version": _FORMAT_VERSION, "kind": kind, **q_meta,
            "torch_version": torch.__version__, "platforms": list(platforms),
            "n_speakers": int(model.cfg.nb_speakers), "sample_rate": int(sample_rate),
            "front": dataclasses.asdict(model.cfg.front), "recipe": recipe_dict}


def export_serving(
    model,
    out_dir: str,
    *,
    lengths: tuple[int, ...] = (16384, 65536),
    batch: int = 8,
    platforms: tuple[str, ...] = ("cpu", "cuda"),
    sample_rate: int = 8000,
    recipe_dict: dict | None = None,
    separate_kwargs: dict | None = None,
    quantize: str | None = None,
) -> str:
    """Export ``model.separate`` for each (length, platform) at ``batch`` rows
    and write a self-contained serving directory; returns ``out_dir``.

    ``model.separate`` takes (mix [B, T], frame_mask=[B, T'], **separate_kwargs),
    the ``StreamingSeparator`` contract.  ``quantize="int8"`` stores the
    parameters int8-compressed (about 4x smaller); the programs are the same
    and the loader dequantizes."""
    kw = separate_kwargs or {}
    tree = _model_tree(model)
    front = model.cfg.front
    os.makedirs(out_dir, exist_ok=True)
    buckets = [{"length": t, "frames": front.frames_for(t), "files": {}}
               for t in sorted({int(x) for x in lengths})]
    for platform in platforms:
        dev = _platform_device(platform)
        m = copy.deepcopy(model).to(dev).eval()
        params = _program_params(tree, dev)

        def run(mix, frame_mask, m=m):
            return m.separate(mix, frame_mask=frame_mask, **kw)

        for b in buckets:
            name = f"serving_t{b['length']}_b{batch}.{platform}.pt2"
            args = (params, torch.zeros((batch, b["length"]), device=dev),
                    torch.ones((batch, b["frames"]), device=dev))
            _save(_Program(m, run), args, os.path.join(out_dir, name))
            b["files"][platform] = name
    meta = {**_meta_common("offline", model, platforms, sample_rate, recipe_dict,
                           _write_params(out_dir, tree, quantize)),
            "batch": int(batch), "buckets": buckets}
    with open(os.path.join(out_dir, "export_meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return out_dir


class _Init(torch.nn.Module):
    def __init__(self, rt):
        super().__init__()
        self._rt = [rt]

    def forward(self):
        return self._rt[0]._init_state()


def export_realtime(
    model,
    out_dir: str,
    *,
    chunk_samples: int = 4096,
    n_streams: int = 1,
    platforms: tuple[str, ...] = ("cpu", "cuda"),
    sample_rate: int = 8000,
    long_stream: bool = False,
    recipe_dict: dict | None = None,
    quantize: str | None = None,
) -> str:
    """Export the causal streaming path (``infer/realtime.py``) as two
    programs per platform, ``init() -> state`` (zeros made in the program)
    and ``step(params, state, chunk, end_frame) -> (block, state')``, beside
    the parameter blob; ``RealtimeArtifact`` runs the streaming loop with no
    model code."""
    from amss_tpu_torch.infer.realtime import RealtimeSeparator

    tree = _model_tree(model)
    os.makedirs(out_dir, exist_ok=True)
    files: dict = {"init": {}, "step": {}}
    for platform in platforms:
        dev = _platform_device(platform)
        rt = RealtimeSeparator(copy.deepcopy(model), chunk_samples=chunk_samples,
                               sample_rate=sample_rate, long_stream=long_stream,
                               n_streams=n_streams, device=dev)
        files["init"][platform] = f"realtime_init.{platform}.pt2"
        _save(_Init(rt), (), os.path.join(out_dir, files["init"][platform]))
        files["step"][platform] = f"realtime_step_c{chunk_samples}_b{n_streams}.{platform}.pt2"
        args = (_program_params(tree, dev), rt._init_state(),
                torch.zeros((n_streams, chunk_samples), device=dev),
                torch.full((n_streams,), _NO_END, dtype=torch.int64, device=dev))
        _save(_Program(rt.model, rt.step), args, os.path.join(out_dir, files["step"][platform]))
    meta = {**_meta_common("realtime", model, platforms, sample_rate, recipe_dict,
                           _write_params(out_dir, tree, quantize)),
            "chunk_samples": int(chunk_samples), "n_streams": int(n_streams),
            "lag": int(rt.lag), "long_stream": bool(long_stream), "files": files}
    with open(os.path.join(out_dir, "export_meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return out_dir


# -- loading -------------------------------------------------------------------


def _read_meta(path: str, kind: str) -> dict:
    with open(os.path.join(path, "export_meta.json")) as f:
        meta = json.load(f)
    if meta["format_version"] != _FORMAT_VERSION:
        raise ValueError(f"serving artifact at {path} has format_version "
                         f"{meta['format_version']}; this loader reads {_FORMAT_VERSION}")
    got = meta.get("kind", "offline")
    if got != kind:
        other = "RealtimeArtifact" if got == "realtime" else "ServingArtifact"
        raise ValueError(f"artifact at {path} is kind={got!r}; use {other}")
    return meta


def _device_for(meta: dict, path: str, device) -> torch.device:
    """The artifact's device: ``cuda`` unless the caller names another (with
    none named and no card, this raises), and a platform it was exported for."""
    dev = resolve_device(device)
    if dev.type not in meta["platforms"]:
        raise ValueError(f"artifact at {path} holds programs for {meta['platforms']}, "
                         f"not {dev.type}")
    return dev


def _load(path: str):
    return torch.export.load(path).module()


class ServingArtifact(BucketedServing):
    """Run an exported serving directory with no model code and no tracing::

        art = ServingArtifact("/path/to/export")
        outs = art.separate_all(list_of_waves)   # [S, T_orig] each

    Bucketing, zero padding, frame masks and the meter are
    ``StreamingSeparator``'s, the one loop of ``infer/streaming.py``; groups
    are padded to the exported batch with zero rows.  Each bucket's program is
    loaded at its first use and run once on zeros, booked as warm-up.  The
    device is ``cuda`` unless ``device`` names another."""

    def __init__(self, path: str, device=None):
        self.path = path
        self.meta = _read_meta(path, "offline")
        self.device = _device_for(self.meta, path, device)
        self.params = _program_params(_restore_params(path, self.meta), self.device)
        self.front = FrontConfig(**self.meta["front"])
        self.batch = self.meta["batch"]
        self.n_speakers = self.meta["n_speakers"]
        self.sample_rate = self.meta["sample_rate"]
        self.buckets = sorted(self.meta["buckets"], key=lambda b: b["length"])
        self.lengths = tuple(b["length"] for b in self.buckets)
        self._fns: dict[int, object] = {}  # length -> loaded program
        self.meter = RTFMeter()

    def _bucket_for(self, n: int) -> dict:
        for b in self.buckets:
            if n <= b["length"]:
                return b
        raise ValueError(
            f"utterance of {n} samples exceeds the largest exported bucket "
            f"({self.buckets[-1]['length']}): the exact-shape API does not chunk; "
            "separate_all and separate_long take over-bucket audio")

    def _call(self, fn, mix: torch.Tensor, fmask: torch.Tensor) -> torch.Tensor:
        with _fp32():
            return fn(self.params, mix, fmask)

    def _loaded(self, bucket: dict):
        t = bucket["length"]
        if t not in self._fns:
            t0 = time.perf_counter()
            fn = _load(os.path.join(self.path, bucket["files"][self.device.type]))
            self._call(fn, torch.zeros((self.batch, t), device=self.device),
                       torch.ones((self.batch, bucket["frames"]), device=self.device))
            synchronize(self.device)
            self.meter.warmup_seconds += time.perf_counter() - t0
            self._fns[t] = fn
        return self._fns[t]

    def _program(self, bucket: int, rows: int):
        return functools.partial(self._call, self._loaded(self._bucket_for(bucket)))

    def _warm_long(self) -> None:
        self._loaded(self.buckets[-1])

    def _long(self, wave: np.ndarray) -> np.ndarray:
        return self.separate_long(wave)

    def separate_batch(self, mix: np.ndarray, n_valid: np.ndarray | None = None) -> np.ndarray:
        """One exact-shape batch [B, T]: T an exported bucket, B the exported
        batch.  ``n_valid[j]`` is row j's true sample count (for its frame
        mask), by default the full length."""
        b, t = mix.shape
        bucket = self._bucket_for(t)
        if t != bucket["length"] or b != self.batch:
            raise ValueError(
                f"exact-shape API: got {mix.shape}, exported shape is "
                f"({self.batch}, {bucket['length']}); use separate_all for ragged inputs")
        fmask = frame_mask(self.front, t, [t] * b if n_valid is None else n_valid, b)
        return self._call(self._loaded(bucket),
                          torch.from_numpy(mix.astype(np.float32)).to(self.device),
                          torch.from_numpy(fmask).to(self.device)).cpu().numpy()

    def separate_all(self, waves: list[np.ndarray]) -> list[np.ndarray]:
        """Variable-length utterances -> [S, T_orig] each, in input order, as
        ``StreamingSeparator.separate_all``: every group is launched before
        any result is copied back.  Utterances longer than the largest bucket
        take ``separate_long``, never truncated."""
        return self._serve(waves, self.batch, pad_to=self.batch)

    def separate_long(self, wave: np.ndarray) -> np.ndarray:
        """Audio of any length -> [S, len(wave)] through the largest bucket's
        program: chunks overlapping as ``infer/long.py`` cuts them, launched
        in groups of the exported batch through ``separate_all``'s loop (its
        meter left alone), stitched by the same ``stitch_chunks``."""
        chunk = self.lengths[-1]
        t = len(wave)
        if t <= chunk:
            return self.separate_all([wave])[0]
        overlap, starts, t_pad = chunk_layout(t, chunk)
        rows = chunk_rows(wave, starts, chunk, len(starts))
        est = self._serve(list(rows), self.batch, pad_to=self.batch, meter=RTFMeter())
        return stitch_chunks(np.stack(est), starts, overlap, t, t_pad)


class RealtimeArtifact:
    """Run an exported causal-streaming directory: ``RealtimeSeparator``'s
    push and stream semantics (the step program is its ``step``), with no
    model code::

        art = RealtimeArtifact(path)
        for chunk in stream:              # [B, chunk], or [chunk] when B == 1
            out = art.push(chunk)         # [B, S, chunk], lagging by art.lag
        est = art.separate_stream(wave)   # a whole utterance

    The device is ``cuda`` unless ``device`` names another."""

    def __init__(self, path: str, device=None):
        self.path = path
        self.meta = _read_meta(path, "realtime")
        self.device = _device_for(self.meta, path, device)
        self.params = _program_params(_restore_params(path, self.meta), self.device)
        files = self.meta["files"]
        self._init = _load(os.path.join(path, files["init"][self.device.type]))
        self._step = _load(os.path.join(path, files["step"][self.device.type]))
        self.front = FrontConfig(**self.meta["front"])
        self.c = self.meta["chunk_samples"]
        self.b = self.meta["n_streams"]
        self.lag = self.meta["lag"]
        self.n_speakers = self.meta["n_speakers"]
        self.sample_rate = self.meta["sample_rate"]
        self.reset()

    def reset(self) -> None:
        """Zero the stream state (new utterances in every slot)."""
        with _fp32():
            self.state = self._init()

    def push(self, chunk: np.ndarray, end_frame=None) -> np.ndarray:
        """One streaming step: [B, c] (or [c] when B == 1) mixture samples ->
        [B, S, c] ([S, c]) separated samples, lagging the input by
        ``self.lag`` samples.  ``end_frame`` as in ``RealtimeSeparator.push``."""
        chunk = np.array(chunk, np.float32)  # a copy: torch takes writable arrays
        squeeze = self.b == 1 and chunk.ndim == 1
        if squeeze:
            chunk = chunk[None]
        if chunk.shape != (self.b, self.c):
            raise ValueError(f"push expects ({self.b}, {self.c}) "
                             f"(or ({self.c},) when n_streams=1), got {chunk.shape}")
        end = np.broadcast_to(np.asarray(_NO_END if end_frame is None else end_frame,
                                         np.int64), (self.b,))
        with _fp32():
            est, self.state = self._step(
                self.params, self.state, torch.from_numpy(chunk).to(self.device),
                torch.from_numpy(np.array(end)).to(self.device))
        out = est.cpu().numpy()
        return out[0] if squeeze else out

    def _chunks(self, t: int) -> int:
        return -(-(t + self.lag) // self.c)

    def separate_stream(self, wave: np.ndarray) -> np.ndarray:
        """One utterance (n_streams == 1) -> [S, len(wave)], the model's
        offline separation."""
        if self.b != 1:
            raise ValueError("separate_stream serves one stream")
        self.reset()
        t = len(wave)
        n_chunks = self._chunks(t)
        padded = np.zeros(n_chunks * self.c, np.float32)
        padded[:t] = wave
        nf = self.front.frames_for(t)
        outs = [self.push(padded[i * self.c : (i + 1) * self.c], end_frame=nf)
                for i in range(n_chunks)]
        return np.concatenate(outs, axis=-1)[:, self.lag : self.lag + t]

    def separate_streams(self, waves) -> list[np.ndarray]:
        """Up to B (ragged) waves, one per stream slot, each with its own end
        frame -> [S, len(wave)] each; spare slots stay zero."""
        if self.b == 1:
            return [self.separate_stream(w) for w in waves]
        if not 1 <= len(waves) <= self.b:
            raise ValueError(f"separate_streams takes 1..{self.b} waves "
                             f"(n_streams={self.b}), got {len(waves)}")
        self.reset()
        n_chunks = self._chunks(max(len(w) for w in waves))
        padded = np.zeros((self.b, n_chunks * self.c), np.float32)
        nf = np.zeros((self.b,), np.int64)
        for j, w in enumerate(waves):
            padded[j, : len(w)] = w
            nf[j] = self.front.frames_for(len(w))
        outs = [self.push(padded[:, i * self.c : (i + 1) * self.c], end_frame=nf)
                for i in range(n_chunks)]
        full = np.concatenate(outs, axis=-1)  # [B, S, n * c]
        return [full[j, :, self.lag : self.lag + len(w)] for j, w in enumerate(waves)]
