"""Where one batch call of a serving path, one realtime push, one count and
one train step spend their device time.

    python3 -m amss_tpu_torch.tools.stage_times [--recipe c1|c2|c3|c4|c6|c7|enh]          # serving
    python3 -m amss_tpu_torch.tools.stage_times [--recipe c1|c2|c3|c4|c6|c7|enh] --train  # one step
    python3 -m amss_tpu_torch.tools.stage_times --recipe c6 --trunk dprnn|dpt [--train]
    python3 -m amss_tpu_torch.tools.stage_times --count
    python3 -m amss_tpu_torch.tools.stage_times --recipe c1_count --train
    python3 -m amss_tpu_torch.tools.stage_times --recipe c6 --train --corrupt noise|reverb
    python3 -m amss_tpu_torch.tools.stage_times --eval

``--recipe enh`` refines the separator of ``--base-run`` (default
``checkpoints/c1_dpcl``) with refiner weights drawn from seed 0, and times
both stages: the base's ``separate``, the re-encoding of the mixture and the
estimates, the refined masks and the decode.  ``--trunk`` swaps c6's TCN for
a dual-path trunk at the width the JAX package's scripts trained it
(``configs/recipes.py::c6_dual_path``, weights from seed 0), and takes one
block apart into its intra and inter paths.  ``--count`` times
``count_speakers`` on ``checkpoints/c1_count``: the encode, the embedding,
the bin weights and the eigengap (the Gram, ``eigh`` and the argmax).

Serving runs the stages of ``separate`` one by one on the card, on the
committed weights (``checkpoints/c1_dpcl``, ``c2_adapt`` for c2, ``c3_l41``
for c3, blind, ``c6_flagship`` for c6, ``c7_causal`` for c7; c4 has no
checkpoint, so its weights are drawn from seed 0) and the main path's batch
(8 utterances of 8 s).  For c6 and c7 the TCN is also taken apart: its input
product, all its blocks, and one block's stages (the three dense products,
the PReLUs and layer norms, the depthwise conv, the residual).  For c7 a
``RealtimeSeparator`` push (chunks of 4096 and 1024 samples, 1 and 16
streams) is taken apart too, into the stage methods the push runs: the
masks, encode, smoothing with the cumulative norm, the streaming TCN, the
mask head, and the decode with the overlap-add tail, beside the whole push
queued alone and with its fetch.  Training runs the stages of
one step of the recipe at full width (weights drawn from seed 0, a random
batch): the front and the targets, the features, the trunk's forward, the
head and loss, the backward and the optimiser.  A train-time corruption is
a stage of its own, its draws and its apply: ``--recipe c1_count`` trains
from ``checkpoints/c1_count/config.json`` (dropped sources, S = 3, batch 16),
and ``--corrupt`` adds noise at 5-20 dB or reverberation of RT60 800-3200
samples to a TasNet recipe.  ``--eval`` times ``evaluate_separation`` on
c1_dpcl's estimates of the bench.py protocol (64 two-speaker mixtures of
16384 samples): the SI-SDR on the card, then BSS-Eval and STOI on the host
(wall seconds, once).  Each prints one JSON line
with the median milliseconds of each stage over 10 calls (CUDA events around
it, synchronised alone) beside the median of the whole call or step.  Needs
a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from amss_tpu_torch.models.front import vad_weights
from amss_tpu_torch.ops.kernels.kmeans import kmeans, soft_assignments
from amss_tpu_torch.weights import load_model_from_run

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BATCH, SECONDS, REPS = 8, 8, 10
# recipe -> (run dir, the names of the serving stages in order)
SERVING = {
    "c1": ("c1_dpcl", ("stft_encode_B1", "log_features", "norm_blstm", "dense_tanh_l2",
                       "vad_kmeans", "soft_masks", "mask_istft_B2")),
    "c2": ("c2_adapt", ("adapt_encode_B1_abs_sign_pool", "smooth_log_features",
                        "channel_norm_blstm", "dense_tanh_l2", "vad_kmeans", "soft_masks",
                        "mask_unpool_decode_B2")),
}
TASNET_RUNS = {"c6": "c6_flagship", "c7": "c7_causal"}
# the noise-robust and reverb-robust settings of scripts/r3_wave.py
CORRUPTIONS = {"noise": {"train_noise_snr_db": (5.0, 20.0)},
               "reverb": {"train_reverb_rt60": (800.0, 3200.0)}}


def _timed(fn, reps: int):
    """(result of the last call, median ms over reps calls after one warm-up)."""
    out = fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return out, float(np.median(ms))


@torch.no_grad()
def stage_times(recipe: str, batch: int, seconds: int, reps: int) -> dict:
    run, names = SERVING[recipe]
    model = load_model_from_run(os.path.join(REPO, "checkpoints", run))
    cfg = model.cfg
    t = seconds * 8000
    rng = np.random.default_rng(0)
    mix = torch.from_numpy((rng.standard_normal((batch, t)) * 0.3).astype(np.float32)).cuda()
    mask = torch.ones((batch, cfg.front.frames_for(t)), device="cuda")
    k, e = cfg.nb_speakers, cfg.sep.embed_dim
    times, stage = {}, iter(names)

    def timed(fn):
        out, times[next(stage)] = _timed(fn, reps)
        return out

    codes, aux = timed(lambda: model.front.encode(mix))
    feats = timed(lambda: model.front.features(codes))
    h = timed(lambda: model.trunk(feats, mask))
    flat_v = timed(lambda: model.head(h)).reshape(batch, -1, e)

    def cluster():
        w = vad_weights(codes, cfg.vad_threshold_db) * mask[..., None]
        return kmeans(flat_v, k=k, iters=10, weights=w.reshape(batch, -1))[0]

    cent = timed(cluster)
    masks = timed(lambda: soft_assignments(flat_v, cent, tau=0.5).reshape(*codes.shape, k))
    timed(lambda: model.apply_masks_and_decode(codes, aux, masks, t))
    _, whole = _timed(lambda: model.separate(mix, frame_mask=mask), reps)
    return {"device": torch.cuda.get_device_name(0), "recipe": recipe, "batch": batch,
            "samples": t, "stage_ms": times, "sum_of_stages_ms": sum(times.values()),
            "separate_ms": whole}


def _front_name(cfg) -> str:
    """``B1`` where the shape gate opens the front's (win, hop), else ``plain``."""
    from amss_tpu_torch.ops.kernels.framed_matmul import profitable

    return "B1" if profitable(cfg.front.filter_len, cfg.front.stride) else "plain"


@torch.no_grad()
def heads_stage_times(recipe: str, batch: int, seconds: int, reps: int) -> dict:
    """The stages of a BLSTM head's ``separate``: c3 blind (k-means, hard
    masks) on ``checkpoints/c3_l41``, c4 (the MI head's softmax masks, S = 3)
    with weights drawn from seed 0."""
    from amss_tpu_torch.configs.recipes import c4_chimera_3mix
    from amss_tpu_torch.models.front import _one_hot_last
    from amss_tpu_torch.train.engine import make_model

    if recipe == "c3":
        model = load_model_from_run(os.path.join(REPO, "checkpoints", "c3_l41"))
    else:
        model = make_model(c4_chimera_3mix().model)
        model.init_parameters(torch.Generator().manual_seed(0))
        model = model.cuda().eval()
    cfg = model.cfg
    t = seconds * 8000
    rng = np.random.default_rng(0)
    mix = torch.from_numpy((rng.standard_normal((batch, t)) * 0.3).astype(np.float32)).cuda()
    mask = torch.ones((batch, cfg.front.frames_for(t)), device="cuda")
    k, e = cfg.nb_speakers, cfg.sep.embed_dim
    times = {}

    def timed(name, fn):
        out, times[name] = _timed(fn, reps)
        return out

    codes, aux = timed("stft_encode_B1", lambda: model.front.encode(mix))
    feats = timed("log_features", lambda: model.front.features(codes))
    h = timed("norm_blstm", lambda: model.trunk(feats, mask))
    if recipe == "c3":
        v = timed("dense_tanh", lambda: torch.tanh(model.proj(h).reshape(*feats.shape, e)))
        flat_v = v.reshape(batch, -1, e)

        def cluster():
            w = vad_weights(codes, cfg.vad_threshold_db) * mask[..., None]
            return kmeans(flat_v, k=k, iters=10, weights=w.reshape(batch, -1))[1]

        assign = timed("vad_kmeans", cluster)
        masks = timed("hard_masks", lambda: _one_hot_last(assign, k, codes.dtype).reshape(
            *codes.shape, k))
    else:
        masks = timed("mask_head_softmax", lambda: torch.softmax(
            model.proj_mask(h).reshape(*feats.shape, k), dim=-1))
    timed("mask_istft_B2", lambda: model.apply_masks_and_decode(codes, aux, masks, t))
    _, whole = _timed(lambda: model.separate(mix, frame_mask=mask), reps)
    return {"device": torch.cuda.get_device_name(0), "recipe": recipe, "batch": batch,
            "samples": t, "speakers": k, "stage_ms": times,
            "sum_of_stages_ms": sum(times.values()), "separate_ms": whole}


@torch.no_grad()
def realtime_push_times(model, chunk: int, streams: int, reps: int) -> dict:
    """One ``RealtimeSeparator`` push taken apart into the stage methods its
    ``step`` runs, its state warmed by a few pushes first; each stage runs on
    the state the push would see, and none of them changes it."""
    from amss_tpu_torch.infer.realtime import RealtimeSeparator

    rt = RealtimeSeparator(model, chunk_samples=chunk, n_streams=streams)
    rng = np.random.default_rng(0)
    wave = (rng.standard_normal((streams, chunk)) * 0.3).astype(np.float32)
    for _ in range(3):
        rt.push(wave)
    chunk_t = torch.from_numpy(wave).cuda()
    ends = rt._end_frames(None)
    st = rt._state
    times = {}

    def timed(name, fn):
        out, times[name] = _timed(fn, reps)
        return out

    valid, dec_valid = timed("masks", lambda: rt._masks(st, ends))
    _, codes, aux = timed("encode_plain_abs_sign", lambda: rt._encode(st, chunk_t, valid))
    _, normed, _ = timed("smoothing_log_cumulative_norm",
                         lambda: rt._features_and_norm(st, codes, valid))
    h, _ = timed("tcn_streaming", lambda: rt._trunk(st, normed, valid))
    m = timed("mask_head_sigmoid", lambda: rt._head(h))
    timed("decode_plain_ola_tail", lambda: rt._decode(st, codes, aux, m, dec_valid))
    _, queued = _timed(lambda: rt._dispatch(wave, None), reps)
    _, pushed = _timed(lambda: rt.push(wave), reps)
    return {"chunk": chunk, "streams": streams, "frames": rt.hop, "stage_ms": times,
            "sum_of_stages_ms": sum(times.values()), "push_queued_ms": queued,
            "push_with_fetch_ms": pushed}


@torch.no_grad()
def tasnet_stage_times(recipe: str, batch: int, seconds: int, reps: int) -> dict:
    """The stages of ``TasNetModel.separate`` on c6_flagship or c7_causal, the
    TCN taken apart into its input product, its blocks and one block's
    stages; for c7 also a realtime push, taken apart."""
    from amss_tpu_torch.models.blstm import dense
    from amss_tpu_torch.models.dprnn import layer_norm
    from amss_tpu_torch.models.front import cumulative_norm, instance_norm
    from amss_tpu_torch.models.tcn import _depthwise_dilated, prelu, tcn_stack

    model = load_model_from_run(os.path.join(REPO, "checkpoints", TASNET_RUNS[recipe]))
    cfg, cd = model.cfg, model.compute_dtype
    t = seconds * 8000
    rng = np.random.default_rng(0)
    mix = torch.from_numpy((rng.standard_normal((batch, t)) * 0.3).astype(np.float32)).cuda()
    mask = torch.ones((batch, cfg.front.frames_for(t)), device="cuda")
    kern = _front_name(cfg)
    times = {}

    def timed(name, fn):
        out, times[name] = _timed(fn, reps)
        return out

    codes, aux = timed(f"adapt_encode_{kern}_abs_sign", lambda: model.front.encode(mix))
    feats = timed("smooth_log_features", lambda: model.front.features(codes))
    if cfg.sep.feature_norm == "cumulative":
        h = timed("cumulative_norm", lambda: cumulative_norm(feats, mask)[0])
    else:
        h = timed("instance_norm", lambda: instance_norm(feats, mask))
    trunk = timed("tcn_stack", lambda: tcn_stack(model.tcn, h, mask, cfg.sep.blocks, cd,
                                                 causal=cfg.sep.causal))
    masks = timed("mask_head_sigmoid", lambda: torch.sigmoid(
        dense(model.proj_mask, trunk, cd).reshape(*feats.shape, cfg.nb_speakers)))
    dec = "B2" if kern == "B1" else "plain"
    timed(f"mask_decode_{dec}", lambda: model.apply_masks_and_decode(codes, aux, masks, t))
    _, whole = _timed(lambda: model.separate(mix, frame_mask=mask), reps)

    # the TCN's input product, then its first block (dilation 1) taken apart
    bp, m = model.tcn.blocks[0], mask[..., None]
    parts = {}

    def part(name, fn):
        out, parts[name] = _timed(fn, reps)
        return out

    x = part("in_proj_dense_mask", lambda: dense(model.tcn.in_proj, h, cd) * m)
    u = part("block_pw_in_dense", lambda: dense(bp.pw_in, x, cd))
    u = part("block_prelu_layer_norm_1", lambda: layer_norm(bp.ln1, prelu(bp.a1, u)))
    v = part("block_mask_depthwise_conv", lambda: _depthwise_dilated(bp.dw, u * m, 1,
                                                                     cfg.sep.causal))
    v = part("block_prelu_layer_norm_2", lambda: layer_norm(bp.ln2, prelu(bp.a2, v)))
    res, skip = part("block_pw_res_pw_skip_dense",
                     lambda: (dense(bp.pw_res, v, cd), dense(bp.pw_skip, v, cd)))
    skip_sum = torch.zeros_like(x)
    part("block_residual_mask_skip_sum", lambda: ((x + res) * m, skip_sum + skip * m))
    out = {"device": torch.cuda.get_device_name(0), "recipe": recipe, "batch": batch,
           "samples": t, "frames": int(codes.shape[-2]), "compute_dtype": cfg.sep.compute_dtype,
           "stage_ms": times, "sum_of_stages_ms": sum(times.values()), "separate_ms": whole,
           "tcn_parts_ms": parts, "blocks": len(model.tcn.blocks)}
    if recipe == "c7":
        out["realtime_push"] = [realtime_push_times(model, chunk, streams, reps)
                                for chunk in (4096, 1024) for streams in (1, 16)]
    return out


def _observed_mix_stages(model, sources: torch.Tensor, key, timed) -> torch.Tensor:
    """``model.observed_mix`` stage by stage, each timed alone with its draws:
    each source's reverberation, the mixing, the noise."""
    from amss_tpu_torch.models.front import corrupt_mix, reverberate_sources

    c = model.cfg
    wet = sources
    if c.train_reverb_rt60 is not None:
        wet = timed("reverb_draw_rir_conv", lambda: reverberate_sources(
            sources, key, tuple(c.train_reverb_rt60), tuple(c.train_reverb_drr_db)))
    mix = timed("mix", lambda: wet.sum(dim=1))
    if c.train_noise_snr_db is not None:
        mix = timed("noise_draw_apply",
                    lambda: corrupt_mix(mix, key, tuple(c.train_noise_snr_db)))
    return mix


def tasnet_train_stage_times(recipe, reps: int) -> dict:
    """The stages of one train step of a TasNet recipe (c6, c7, or c6 with a
    dual-path trunk) at its full width; dropout and the corruptions, where
    the recipe has them, draw from a key."""
    from amss_tpu_torch.models.blstm import dense
    from amss_tpu_torch.models.dprnn import DropoutKey
    from amss_tpu_torch.ops.metrics import pit_si_sdr
    from amss_tpu_torch.train.engine import make_model
    from amss_tpu_torch.train.optim import Adam, make_schedule

    torch.backends.cuda.matmul.allow_tf32 = False  # the default, stated
    t = recipe.train
    key = DropoutKey(t.seed)
    model = make_model(recipe.model)
    model.init_parameters(torch.Generator().manual_seed(t.seed))
    model = model.cuda().train()
    params = [p for p in model.parameters() if p.requires_grad]
    opt = Adam(params, make_schedule(t), t.grad_clip)
    rng = np.random.default_rng(0)
    sources = torch.from_numpy(
        (rng.standard_normal((t.batch_size, 2, t.chunk_samples)) * 0.1).astype(np.float32)).cuda()
    kern = _front_name(recipe.model)
    dec = "B2" if kern == "B1" else "plain"

    times = {}

    def timed(name, fn):
        out, times[name] = _timed(fn, reps)
        return out

    mix = _observed_mix_stages(model, sources, key, timed)
    codes, aux = timed(f"adapt_encode_{kern}_abs_sign", lambda: model.front.encode(mix))
    feats = timed("smooth_log_features", lambda: model.front.features(codes))
    h = timed(f"norm_{recipe.model.sep.trunk}_forward_remat",
              lambda: model.trunk(feats, rng=key))
    masks = timed("mask_head_sigmoid", lambda: torch.sigmoid(
        dense(model.proj_mask, h, model.compute_dtype).reshape(*feats.shape, 2)))
    est = timed(f"mask_decode_{dec}", lambda: model.apply_masks_and_decode(
        codes, aux, masks, t.chunk_samples))
    loss = timed("pit_si_sdr_loss", lambda: -pit_si_sdr(est, sources)[0].mean())
    grads, times["whole_backward"] = _timed(
        lambda: torch.autograd.grad(loss, params, retain_graph=True, allow_unused=True), reps)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
    _, times["clip_adam"] = _timed(lambda: opt.step(list(grads)), reps)

    def step():
        loss, _ = model.loss(sources, rng=key)
        g = torch.autograd.grad(loss, params, allow_unused=True)
        opt.step([torch.zeros_like(p) if x is None else x for x, p in zip(g, params)])

    _, whole = _timed(step, reps)
    m = recipe.model
    return {"device": torch.cuda.get_device_name(0), "recipe": recipe.name,
            "trunk": m.sep.trunk, "batch": t.batch_size, "samples": t.chunk_samples,
            "noise_snr_db": m.train_noise_snr_db, "reverb_rt60": m.train_reverb_rt60,
            "stage_ms": times, "sum_of_stages_ms": sum(times.values()), "train_step_ms": whole}


def heads_train_stage_times(recipe_name: str, reps: int) -> dict:
    """The stages of one c3 (L41) or c4 (Chimera, S = 3) train step at the
    recipe's full width; the head and loss are the whole forward less the
    stages before them."""
    from amss_tpu_torch.configs.recipes import c3_l41, c4_chimera_3mix
    from amss_tpu_torch.train.engine import make_model
    from amss_tpu_torch.train.optim import Adam, make_schedule

    torch.backends.cuda.matmul.allow_tf32 = False  # the default, stated
    recipe = c3_l41(100) if recipe_name == "c3" else c4_chimera_3mix()
    t, s = recipe.train, recipe.model.nb_speakers
    model = make_model(recipe.model)
    model.init_parameters(torch.Generator().manual_seed(t.seed))
    model = model.cuda().train()
    params = [p for p in model.parameters() if p.requires_grad]
    opt = Adam(params, make_schedule(t), t.grad_clip)
    rng = np.random.default_rng(0)
    sources = torch.from_numpy(
        (rng.standard_normal((t.batch_size, s, t.chunk_samples)) * 0.1).astype(np.float32)).cuda()
    batch = {"sources": sources}
    if recipe_name == "c3":
        batch["speaker_ids"] = torch.from_numpy(
            rng.integers(0, 100, (t.batch_size, s)).astype(np.int32)).cuda()

    times = {}
    enc, times["mix_encode_B1x2_targets"] = _timed(
        lambda: model.encode_mix_and_sources(sources), reps)
    codes = enc[1]
    feats, times["features"] = _timed(lambda: model.front.features(codes), reps)
    _, times["norm_blstm_forward"] = _timed(lambda: model.trunk(feats), reps)
    loss, forward = _timed(lambda: model.loss_from_batch(batch)[0], reps)
    times["head_and_loss_forward"] = forward - sum(times.values())
    grads, times["whole_backward"] = _timed(
        lambda: torch.autograd.grad(loss, params, retain_graph=True), reps)
    _, times["clip_adam"] = _timed(lambda: opt.step(list(grads)), reps)

    def step():
        loss, _ = model.loss_from_batch(batch)
        opt.step(list(torch.autograd.grad(loss, params)))

    _, whole = _timed(step, reps)
    return {"device": torch.cuda.get_device_name(0), "recipe": recipe_name,
            "batch": t.batch_size, "speakers": s, "samples": t.chunk_samples,
            "stage_ms": times, "sum_of_stages_ms": sum(times.values()), "train_step_ms": whole}


def _c1_count_recipe():
    """c1_count's own config, as its checkpoint stores it."""
    from amss_tpu_torch.utils.config import recipe_from_dict

    with open(os.path.join(REPO, "checkpoints", "c1_count", "config.json")) as f:
        return recipe_from_dict(json.load(f))


def train_stage_times(recipe_name: str, reps: int) -> dict:
    """The stages of one c1, c1_count or c2 train step at the recipe's full
    width; c1_count's dropped sources are a stage of their own, drawn from a
    key."""
    from amss_tpu_torch.configs.recipes import c1_stft_dpcl, c2_adapt_dpcl
    from amss_tpu_torch.models.dpcl import dpcl_loss
    from amss_tpu_torch.models.dprnn import DropoutKey
    from amss_tpu_torch.train.engine import make_model
    from amss_tpu_torch.train.optim import Adam, make_schedule

    torch.backends.cuda.matmul.allow_tf32 = False  # the default, stated
    recipe = {"c1": c1_stft_dpcl, "c2": c2_adapt_dpcl, "c1_count": _c1_count_recipe}[recipe_name]()
    t, s = recipe.train, recipe.model.nb_speakers
    key = DropoutKey(t.seed)
    model = make_model(recipe.model)
    model.init_parameters(torch.Generator().manual_seed(t.seed))
    model = model.cuda().train()
    params = [p for p in model.parameters() if p.requires_grad]
    opt = Adam(params, make_schedule(t), t.grad_clip)
    rng = np.random.default_rng(0)
    sources = torch.from_numpy(
        (rng.standard_normal((t.batch_size, s, t.chunk_samples)) * 0.1).astype(np.float32)).cuda()

    times = {}
    if recipe.model.train_min_speakers is not None:
        from amss_tpu_torch.models.front import drop_sources

        sources, times["drop_sources_draw_apply"] = _timed(
            lambda: drop_sources(sources, key, recipe.model.train_min_speakers), reps)
    enc, times["mix_encode_B1x2_targets"] = _timed(
        lambda: model.encode_mix_and_sources(sources), reps)
    mix, codes, aux, _, y, w, _ = enc
    feats, times["features"] = _timed(lambda: model.front.features(codes), reps)
    h, times["norm_blstm_forward"] = _timed(lambda: model.trunk(feats), reps)
    v, times["dense_tanh_l2_forward"] = _timed(lambda: model.head(h), reps)
    loss, times["dpcl_loss_forward"] = _timed(lambda: dpcl_loss(v, y, w), reps)
    if recipe.model.recon_weight > 0.0:
        recon, times["recon_decode_B2_l2_forward"] = _timed(
            lambda: ((model.front.decode(codes, aux, t.chunk_samples) - mix) ** 2).mean(), reps)
        loss = loss + recipe.model.recon_weight * recon
    gh = torch.autograd.grad(loss, h, retain_graph=True)[0]
    blstm = [p for p in model.blstm.parameters() if p.requires_grad]
    _, times["blstm_backward"] = _timed(
        lambda: torch.autograd.grad(h, blstm, gh, retain_graph=True), reps)
    grads, times["whole_backward"] = _timed(
        lambda: torch.autograd.grad(loss, params, retain_graph=True), reps)
    _, times["clip_adam"] = _timed(lambda: opt.step(list(grads)), reps)

    def step():
        loss, _ = model.loss(sources, rng=key)
        opt.step(list(torch.autograd.grad(loss, params)))

    _, whole = _timed(step, reps)
    return {"device": torch.cuda.get_device_name(0), "recipe": recipe_name,
            "batch": t.batch_size, "speakers": s, "samples": t.chunk_samples, "stage_ms": times,
            "sum_of_stages_ms": sum(v for k, v in times.items() if k != "blstm_backward"),
            "train_step_ms": whole}


@torch.no_grad()
def count_stage_times(batch: int, seconds: int, reps: int) -> dict:
    """The stages of ``count_speakers`` on checkpoints/c1_count."""
    from amss_tpu_torch.infer.count import count_speakers, eigengap_counts
    from amss_tpu_torch.models.front import bin_weights

    model = load_model_from_run(os.path.join(REPO, "checkpoints", "c1_count"))
    cfg = model.cfg
    t = seconds * 8000
    rng = np.random.default_rng(0)
    mix = torch.from_numpy((rng.standard_normal((batch, t)) * 0.3).astype(np.float32)).cuda()
    times = {}

    def timed(name, fn):
        out, times[name] = _timed(fn, reps)
        return out

    codes, _ = timed(f"stft_encode_{_front_name(cfg)}", lambda: model.front.encode(mix))
    feats = timed("log_features", lambda: model.front.features(codes))
    v = timed("norm_blstm_dense_tanh_l2", lambda: model.embed(feats))
    w = timed("vad_bin_weights", lambda: bin_weights(codes, "vad", cfg.vad_threshold_db))
    timed("gram_eigh_argmax", lambda: eigengap_counts(v.reshape(batch, -1, cfg.sep.embed_dim),
                                                      w.reshape(batch, -1)))
    _, whole = _timed(lambda: count_speakers(model, mix), reps)
    return {"device": torch.cuda.get_device_name(0), "what": "count_speakers c1_count",
            "batch": batch, "samples": t, "stage_ms": times,
            "sum_of_stages_ms": sum(times.values()), "count_ms": whole}


def _enh_model(base_run: str):
    from amss_tpu_torch.configs.recipes import enh_dpcl
    from amss_tpu_torch.train.engine import make_model

    recipe = enh_dpcl(base_run)
    model = make_model(recipe.model, base_run, "cuda")
    model.init_parameters(torch.Generator().manual_seed(recipe.train.seed))
    return recipe, model.cuda()


@torch.no_grad()
def enh_stage_times(base_run: str, batch: int, seconds: int, reps: int) -> dict:
    """The stages of the two-stage ``EnhancerModel.separate`` over
    ``base_run``, with refiner weights drawn from seed 0."""
    _, model = _enh_model(base_run)
    model.eval()
    cfg = model.cfg
    t = seconds * 8000
    rng = np.random.default_rng(0)
    mix = torch.from_numpy((rng.standard_normal((batch, t)) * 0.3).astype(np.float32)).cuda()
    mask = torch.ones((batch, cfg.front.frames_for(t)), device="cuda")
    kern = _front_name(cfg)
    dec = "B2" if kern == "B1" else "plain"
    times = {}

    def timed(name, fn):
        out, times[name] = _timed(fn, reps)
        return out

    est = timed(f"base_separate_{kern}_{dec}", lambda: model.base.separate(mix, frame_mask=mask))
    codes, aux = timed(f"encode_mix_{kern}", lambda: model.front.encode(mix))
    est_codes, _ = timed(f"encode_estimates_{kern}", lambda: model.front.encode(est))
    masks = timed("log_norm_blstm_proj_softmax",
                  lambda: model.refined_masks(codes, est_codes, mask))
    timed(f"mask_decode_{dec}", lambda: model.apply_masks_and_decode(codes, aux, masks, t))
    _, whole = _timed(lambda: model.separate(mix, frame_mask=mask), reps)
    return {"device": torch.cuda.get_device_name(0), "recipe": "enh",
            "base_run": os.path.basename(os.path.normpath(base_run)), "batch": batch,
            "samples": t, "stage_ms": times, "sum_of_stages_ms": sum(times.values()),
            "separate_ms": whole}


def enh_train_stage_times(base_run: str, reps: int) -> dict:
    """The stages of one enh train step over ``base_run`` at the recipe's
    width (batch 8 of 16384, msa loss)."""
    from amss_tpu_torch.models.chimera import msa_pit_loss
    from amss_tpu_torch.models.front import vad_weights as vad
    from amss_tpu_torch.train.optim import Adam, make_schedule

    torch.backends.cuda.matmul.allow_tf32 = False  # the default, stated
    recipe, model = _enh_model(base_run)
    t = recipe.train
    model.train()
    params = [p for p in model.parameters() if p.requires_grad]
    opt = Adam(params, make_schedule(t), t.grad_clip)
    rng = np.random.default_rng(0)
    sources = torch.from_numpy(
        (rng.standard_normal((t.batch_size, 2, t.chunk_samples)) * 0.1).astype(np.float32)).cuda()
    mix = sources.sum(dim=1)
    times = {}

    def timed(name, fn):
        out, times[name] = _timed(fn, reps)
        return out

    codes, _, est_codes = timed("base_separate_reencode_no_grad",
                                lambda: model._base_separate_codes(mix))
    with torch.no_grad():
        src_codes, _ = timed("encode_sources", lambda: model.front.encode(sources))
    masks = timed("refined_masks_forward", lambda: model.refined_masks(codes, est_codes))
    loss = timed("msa_pit_loss", lambda: msa_pit_loss(
        masks, codes, src_codes, vad(codes, recipe.model.vad_threshold_db)))
    grads, times["whole_backward"] = _timed(
        lambda: torch.autograd.grad(loss, params, retain_graph=True), reps)
    _, times["clip_adam"] = _timed(lambda: opt.step(list(grads)), reps)

    def step():
        loss, _ = model.loss(sources)
        opt.step(list(torch.autograd.grad(loss, params)))

    _, whole = _timed(step, reps)
    return {"device": torch.cuda.get_device_name(0), "recipe": "enh",
            "batch": t.batch_size, "samples": t.chunk_samples, "stage_ms": times,
            "sum_of_stages_ms": sum(times.values()), "train_step_ms": whole}


@torch.no_grad()
def dual_path_stage_times(model, batch: int, seconds: int, reps: int) -> dict:
    """The stages of ``separate`` of a c6 model with a dual-path trunk, its
    first block taken apart into the intra and the inter path."""
    from amss_tpu_torch.models import dprnn, dptransformer
    from amss_tpu_torch.models.blstm import dense
    from amss_tpu_torch.models.front import instance_norm

    cfg, cd = model.cfg, model.compute_dtype
    sep = cfg.sep
    t = seconds * 8000
    rng = np.random.default_rng(0)
    mix = torch.from_numpy((rng.standard_normal((batch, t)) * 0.3).astype(np.float32)).cuda()
    mask = torch.ones((batch, cfg.front.frames_for(t)), device="cuda")
    kern = _front_name(cfg)
    dec = "B2" if kern == "B1" else "plain"
    times = {}

    def timed(name, fn):
        out, times[name] = _timed(fn, reps)
        return out

    codes, aux = timed(f"adapt_encode_{kern}_abs_sign", lambda: model.front.encode(mix))
    feats = timed("smooth_log_features", lambda: model.front.features(codes))
    h = timed("instance_norm", lambda: instance_norm(feats, mask))
    trunk = timed(f"{sep.trunk}_stack", lambda: model.trunk(feats, mask))
    masks = timed("mask_head_sigmoid", lambda: torch.sigmoid(
        dense(model.proj_mask, trunk, cd).reshape(*feats.shape, cfg.nb_speakers)))
    timed(f"mask_decode_{dec}", lambda: model.apply_masks_and_decode(codes, aux, masks, t))
    _, whole = _timed(lambda: model.separate(mix, frame_mask=mask), reps)

    # the trunk's input product and chunking, then its first block's paths
    net = getattr(model, sep.trunk)
    k = sep.chunk_frames
    parts = {}

    def part(name, fn):
        out, parts[name] = _timed(fn, reps)
        return out

    hg, m_g = part("in_proj_dense_pad_chunk", lambda: dprnn.pad_to_chunks(
        dense(net.in_proj, h, cd), mask, k))
    b, p, _, d = hg.shape
    lengths = part("host_lengths_from_mask", lambda: dprnn.path_lengths(h.shape[1], k, mask, b))
    bp = net.blocks[0]
    rows = hg.reshape(b * p, k, d)
    mi = m_g.reshape(b * p, k)
    cols = hg.transpose(1, 2).reshape(b * k, p, d)
    mt = m_g.transpose(1, 2).reshape(b * k, p)
    if sep.trunk == "dprnn":
        part("intra_blstm", lambda: bp.intra.lstm(rows, mi, lengths=lengths[0], compute_dtype=cd))
        part("intra_path", lambda: dprnn._path(bp.intra, rows, mi, lengths[0], cd, 0.0, None))
        part("inter_path", lambda: dprnn._path(bp.inter, cols, mt, lengths[1], cd, 0.0, None))
        part("block", lambda: dprnn._block(bp, hg, m_g, lengths, cd, 0.0, None))
    else:
        part("intra_attention", lambda: dptransformer.mha(bp.intra.attn, rows, mi, sep.heads, cd))
        part("intra_path", lambda: dptransformer._path(bp.intra, rows, mi, sep.heads, cd, 0.0,
                                                       None))
        part("inter_path", lambda: dptransformer._path(bp.inter, cols, mt, sep.heads, cd, 0.0,
                                                       None))
        part("block", lambda: dptransformer._block(bp, hg, m_g, sep.heads, cd, 0.0, None))
    return {"device": torch.cuda.get_device_name(0), "recipe": f"c6_{sep.trunk}",
            "batch": batch, "samples": t, "frames": int(codes.shape[-2]), "chunk_frames": k,
            "chunks": p, "stage_ms": times, "sum_of_stages_ms": sum(times.values()),
            "separate_ms": whole, "trunk_parts_ms": parts, "blocks": len(net.blocks)}


def timed_evaluation(est: torch.Tensor, refs: torch.Tensor, mixes: torch.Tensor,
                     reps: int = REPS) -> dict:
    """``evaluate_separation(bss=True, per_utt=True, with_stoi=True)`` on
    tensors on the card: its device part (the SI-SDR columns, median ms of
    ``reps``) and its host parts (the BSS-Eval passes and STOI, wall seconds
    of one run), beside the whole call and its result."""
    import time

    from amss_tpu_torch.infer import evaluate
    from amss_tpu_torch.ops.metrics import sdr_improvement

    _, device_ms = _timed(lambda: sdr_improvement(est, refs, mixes), reps)
    host = {"bss_eval_batch": 0.0, "stoi": 0.0}
    calls = {"bss_eval_batch": 0, "stoi": 0}

    def clocked(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                host[name] += time.perf_counter() - t0
                calls[name] += 1
        return run

    kept = evaluate.bss_eval_batch, evaluate.stoi
    evaluate.bss_eval_batch = clocked("bss_eval_batch", kept[0])
    evaluate.stoi = clocked("stoi", kept[1])
    try:
        t0 = time.perf_counter()
        q = evaluate.evaluate_separation(est, refs, mixes, bss=True, per_utt=True,
                                         with_stoi=True)
        whole_s = time.perf_counter() - t0
    finally:
        evaluate.bss_eval_batch, evaluate.stoi = kept
    return {"si_sdr_device_ms": device_ms, "host_s": host, "host_calls": calls,
            "evaluate_separation_s": whole_s, "result": q}


def eval_stage_times(n: int = 64, t: int = 16384, reps: int = REPS) -> dict:
    """``timed_evaluation`` of c1_dpcl's estimates of ``n`` bench.py
    mixtures, separated on the card in batches of BATCH."""
    from amss_tpu_torch.data.synthetic import synth_speaker_wave_v2

    refs = torch.from_numpy(np.stack([
        np.stack([synth_speaker_wave_v2(9000 + 2 * i + j, n_samples=t) for j in range(2)])
        for i in range(n)]).astype(np.float32)).cuda()
    mixes = refs.sum(dim=1)
    model = load_model_from_run(os.path.join(REPO, "checkpoints", "c1_dpcl"))
    est = torch.cat([model.separate(mixes[i : i + BATCH]) for i in range(0, n, BATCH)])
    out = timed_evaluation(est, refs, mixes, reps)
    q = out.pop("result")
    return {"device": torch.cuda.get_device_name(0), "mixtures": n, "samples": t, **out,
            **{k: q[k] for k in ("si_sdri", "sdri", "sir", "sar", "stoi_i")}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--recipe", choices=["c1", "c1_count", "c2", "c3", "c4", "c6", "c7", "enh"],
                    default="c1")
    ap.add_argument("--corrupt", choices=["noise", "reverb"],
                    help="a TasNet train step with noise at 5-20 dB or RT60 800-3200 samples")
    ap.add_argument("--eval", action="store_true", help="time evaluate_separation on c1_dpcl")
    ap.add_argument("--train", action="store_true", help="one train step instead of serving")
    ap.add_argument("--trunk", choices=["dprnn", "dpt"], help="c6 with a dual-path trunk")
    ap.add_argument("--count", action="store_true", help="time count_speakers on c1_count")
    ap.add_argument("--base-run", default=os.path.join(REPO, "checkpoints", "c1_dpcl"),
                    help="the separator that --recipe enh refines")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stage_times needs a CUDA device")
    if args.trunk and args.recipe != "c6":
        raise SystemExit("--trunk applies to --recipe c6")
    if args.corrupt and not (args.train and args.recipe in TASNET_RUNS):
        raise SystemExit("--corrupt applies to --train of --recipe c6 or c7")
    if args.recipe == "c1_count" and not args.train:
        raise SystemExit("--recipe c1_count times a train step: add --train (--count serves it)")
    if args.eval:
        print(json.dumps(eval_stage_times()))
    elif args.count:
        print(json.dumps(count_stage_times(BATCH, SECONDS, REPS)))
    elif args.recipe == "enh":
        print(json.dumps(enh_train_stage_times(args.base_run, REPS) if args.train
                         else enh_stage_times(args.base_run, BATCH, SECONDS, REPS)))
    elif args.trunk:
        from amss_tpu_torch.configs.recipes import c6_dual_path
        from amss_tpu_torch.train.engine import make_model

        recipe = c6_dual_path(args.trunk)
        if args.train:
            print(json.dumps(tasnet_train_stage_times(recipe, REPS)))
        else:
            model = make_model(recipe.model)
            model.init_parameters(torch.Generator().manual_seed(recipe.train.seed))
            print(json.dumps(dual_path_stage_times(model.cuda().eval(), BATCH, SECONDS, REPS)))
    elif args.recipe in TASNET_RUNS:
        from amss_tpu_torch.configs.recipes import c6_tasnet, c7_realtime

        recipe = {"c6": c6_tasnet, "c7": c7_realtime}[args.recipe]()
        if args.corrupt:
            recipe = dataclasses.replace(recipe, model=dataclasses.replace(
                recipe.model, **CORRUPTIONS[args.corrupt]))
        print(json.dumps(tasnet_train_stage_times(recipe, REPS) if args.train
                         else tasnet_stage_times(args.recipe, BATCH, SECONDS, REPS)))
    elif args.recipe in ("c3", "c4"):
        print(json.dumps(heads_train_stage_times(args.recipe, REPS) if args.train
                         else heads_stage_times(args.recipe, BATCH, SECONDS, REPS)))
    elif args.train:
        print(json.dumps(train_stage_times(args.recipe, REPS)))
    else:
        print(json.dumps(stage_times(args.recipe, BATCH, SECONDS, REPS)))


if __name__ == "__main__":
    main()
