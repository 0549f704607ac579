"""Where one batch call of a serving path, and one train step, spend their
device time.

    python3 -m amss_tpu_torch.tools.stage_times [--recipe c1|c2]           # serving
    python3 -m amss_tpu_torch.tools.stage_times [--recipe c1|c2] --train   # one step

Serving runs the stages of ``DPCLModel.separate`` one by one on the card, on
the committed weights (``checkpoints/c1_dpcl``, or ``checkpoints/c2_adapt``
for c2) and the main path's batch (8 utterances of 8 s).  Training runs the
stages of one step of the recipe (c1, or c2 with its reconstruction term) at
full width (2x300 BLSTM, E = 20, batch 8 of 16384 samples, weights drawn from
seed 0, a random batch): the front with its two B1 launches and the targets,
the features, the norm and BLSTM forward, the head, the loss (and c2's
decode through B2), the BLSTM's backward alone, the whole backward, and the
optimiser.  Each prints one JSON line with the median milliseconds of each
stage over 10 calls (CUDA events around it, synchronised alone) beside the
median of the whole call or step.  Needs a CUDA device.
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
    ap.add_argument("--recipe", choices=sorted(SERVING), default="c1")
    ap.add_argument("--train", action="store_true", help="one train step instead of serving")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stage_times needs a CUDA device")
    if args.train:
        print(json.dumps(train_stage_times(args.recipe, REPS)))
    else:
        print(json.dumps(stage_times(args.recipe, BATCH, SECONDS, REPS)))


if __name__ == "__main__":
    main()
