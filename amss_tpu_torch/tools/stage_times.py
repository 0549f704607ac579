"""Where one batch call of a serving path, and one train step, spend their
device time.

    python3 -m amss_tpu_torch.tools.stage_times [--recipe c1|c2|c6]           # serving
    python3 -m amss_tpu_torch.tools.stage_times [--recipe c1|c2|c6] --train   # one step

Serving runs the stages of ``separate`` one by one on the card, on the
committed weights (``checkpoints/c1_dpcl``, ``checkpoints/c2_adapt`` for c2,
``checkpoints/c6_flagship`` for c6) and the main path's batch (8 utterances of
8 s).  For c6 the TCN is also taken apart: its input product, all its blocks,
and one block's stages (the three dense products, the PReLUs and layer norms,
the depthwise conv, the residual).  Training runs the stages of one step of
the recipe (c1, c2 with its reconstruction term, or c6) at full width
(weights drawn from seed 0, a random batch): the front and the targets, the
features, the trunk's forward, the head, the loss (and c2's decode through
B2, c6's masking and decode), the BLSTM's backward alone, the whole backward,
and the optimiser.  Each prints one JSON line with the median milliseconds of
each stage over 10 calls (CUDA events around it, synchronised alone) beside
the median of the whole call or step.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from amss_tpu_torch.models.front import vad_weights
from amss_tpu_torch.ops.kmeans import kmeans, soft_assignments
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
C6_RUN = "c6_flagship"


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
def tasnet_stage_times(batch: int, seconds: int, reps: int) -> dict:
    """The stages of ``TasNetModel.separate`` on the flagship, the TCN taken
    apart into its input product, its blocks and one block's stages."""
    from amss_tpu_torch.models.blstm import dense
    from amss_tpu_torch.models.dprnn import layer_norm
    from amss_tpu_torch.models.front import instance_norm
    from amss_tpu_torch.models.tcn import _depthwise_dilated, prelu, tcn_stack

    model = load_model_from_run(os.path.join(REPO, "checkpoints", C6_RUN))
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
    h = timed("instance_norm", lambda: instance_norm(feats, mask))
    trunk = timed("tcn_stack", lambda: tcn_stack(model.tcn, h, mask, cfg.sep.blocks, cd))
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
    v = part("block_mask_depthwise_conv", lambda: _depthwise_dilated(bp.dw, u * m, 1))
    v = part("block_prelu_layer_norm_2", lambda: layer_norm(bp.ln2, prelu(bp.a2, v)))
    res, skip = part("block_pw_res_pw_skip_dense",
                     lambda: (dense(bp.pw_res, v, cd), dense(bp.pw_skip, v, cd)))
    skip_sum = torch.zeros_like(x)
    part("block_residual_mask_skip_sum", lambda: ((x + res) * m, skip_sum + skip * m))
    return {"device": torch.cuda.get_device_name(0), "recipe": "c6", "batch": batch,
            "samples": t, "frames": int(codes.shape[-2]), "compute_dtype": cfg.sep.compute_dtype,
            "stage_ms": times, "sum_of_stages_ms": sum(times.values()), "separate_ms": whole,
            "tcn_parts_ms": parts, "blocks": len(model.tcn.blocks)}


def tasnet_train_stage_times(reps: int) -> dict:
    """The stages of one c6 train step at the recipe's full width."""
    from amss_tpu_torch.configs.recipes import c6_tasnet
    from amss_tpu_torch.models.blstm import dense
    from amss_tpu_torch.ops.metrics import pit_si_sdr
    from amss_tpu_torch.train.engine import make_model
    from amss_tpu_torch.train.optim import Adam, make_schedule

    torch.backends.cuda.matmul.allow_tf32 = False  # the default, stated
    recipe = c6_tasnet()
    t = recipe.train
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

    mix = timed("mix", lambda: model.observed_mix(sources, training=True))
    codes, aux = timed(f"adapt_encode_{kern}_abs_sign", lambda: model.front.encode(mix))
    feats = timed("smooth_log_features", lambda: model.front.features(codes))
    h = timed("norm_tcn_forward_remat", lambda: model.trunk(feats, training=True))
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
        loss, _ = model.loss(sources, training=True)
        g = torch.autograd.grad(loss, params, allow_unused=True)
        opt.step([torch.zeros_like(p) if x is None else x for x, p in zip(g, params)])

    _, whole = _timed(step, reps)
    return {"device": torch.cuda.get_device_name(0), "recipe": "c6",
            "batch": t.batch_size, "samples": t.chunk_samples, "stage_ms": times,
            "sum_of_stages_ms": sum(times.values()), "train_step_ms": whole}


def train_stage_times(recipe_name: str, reps: int) -> dict:
    from amss_tpu_torch.configs.recipes import c1_stft_dpcl, c2_adapt_dpcl
    from amss_tpu_torch.models.dpcl import dpcl_loss
    from amss_tpu_torch.train.engine import make_model
    from amss_tpu_torch.train.optim import Adam, make_schedule

    torch.backends.cuda.matmul.allow_tf32 = False  # the default, stated
    recipe = {"c1": c1_stft_dpcl, "c2": c2_adapt_dpcl}[recipe_name]()
    t = recipe.train
    model = make_model(recipe.model)
    model.init_parameters(torch.Generator().manual_seed(t.seed))
    model = model.cuda().train()
    params = [p for p in model.parameters() if p.requires_grad]
    opt = Adam(params, make_schedule(t), t.grad_clip)
    rng = np.random.default_rng(0)
    sources = torch.from_numpy(
        (rng.standard_normal((t.batch_size, 2, t.chunk_samples)) * 0.1).astype(np.float32)).cuda()

    times = {}
    enc, times["mix_encode_B1x2_targets"] = _timed(
        lambda: model.encode_mix_and_sources(sources, training=True), reps)
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
        loss, _ = model.loss(sources, training=True)
        opt.step(list(torch.autograd.grad(loss, params)))

    _, whole = _timed(step, reps)
    return {"device": torch.cuda.get_device_name(0), "recipe": recipe_name,
            "batch": t.batch_size, "samples": t.chunk_samples, "stage_ms": times,
            "sum_of_stages_ms": sum(v for k, v in times.items() if k != "blstm_backward"),
            "train_step_ms": whole}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--recipe", choices=[*sorted(SERVING), "c6"], default="c1")
    ap.add_argument("--train", action="store_true", help="one train step instead of serving")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stage_times needs a CUDA device")
    if args.recipe == "c6":
        print(json.dumps(tasnet_train_stage_times(REPS) if args.train
                         else tasnet_stage_times(BATCH, SECONDS, REPS)))
    elif args.train:
        print(json.dumps(train_stage_times(args.recipe, REPS)))
    else:
        print(json.dumps(stage_times(args.recipe, BATCH, SECONDS, REPS)))


if __name__ == "__main__":
    main()
