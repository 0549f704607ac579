"""The training engine (``amss_tpu/train/engine.py``): one fit loop for a
recipe, with periodic validation, checkpoints and best-checkpoint retention.

A step mixes on the device, runs the front (kernel B1 on a card where the
shape gate opens; the adaptive front also B2 and, in its backward, B1
again), the trunk, the head and the loss, then clips by the global norm and
takes an Adam step, all without waiting for the device on the host.  The
recipes ported are c1, c5, c2_pretrain (the filterbank autoencoder), c2,
which restores a pretrained front and keeps it frozen for
``freeze_front_steps`` (its gradients are scaled by 0 before the clip, so
Adam's moments and update stay 0 and the front's tensors stay bit for bit
what was restored), c3 (L41, whose batches carry the speakers' global ids
from the ``Mixer``'s plan), c4 (Chimera), c6 and c7 (TasNet, whose loss
encodes the mixture alone and scores the separated waveforms; any trunk,
the dual-path ones included), and enh (the refiner over the frozen separator
of ``base_run``, whose trainable tree is ``{"separator": {"blstm",
"proj"}}``).  The host draws batches on a background thread
(``data/prefetch.py``) and ships the sources as int16.  With
``train.device_data`` the corpus is uploaded to the device once
(``data/device_corpus.py``) and the host ships plans (speaker ids, starts,
gains) that the step gathers on the device before its loss; validation takes
plans too, the image and quality summaries host batches.  Training-time
dropout draws from a ``DropoutKey`` that the Trainer folds from
``train.seed``, the step and the microbatch, as the JAX package folds its key:
a seed gives the same masks on a device, and a resumed run draws what an
unbroken one would have drawn.  The train-time corruptions (noise,
reverberation, dropped sources) draw from the same key, before the trunk and
outside its recompute.  With ``train.valid_quality`` each validation also
logs ``valid/si_sdri``.

With ``train.data_axis`` N > 1 the Trainer is one of N ranks of a process
group (``parallel/mesh.py``; the CLI's ``train --data-axis N`` starts them),
under the JAX package's multi-process contract: each rank draws
``batch_size // N`` rows with ``host=rank`` (the global batch is the ranks'
rows in rank order) and uploads its own device corpus; its dropout and
corruption keys draw for the global batch and keep its rows
(``DropoutKey.shard``), microbatch by microbatch; the gradients and metrics
are averaged over the ranks in one flat all-reduce after the last
microbatch, before the clip and Adam, so every rank takes the same step
from the same parameters, broadcast from rank 0 before the first.
Validation averages the ranks' losses, so the early-stop decision is the
same everywhere; rank 0 alone writes the config, the metrics, the summaries
and the checkpoints.  The reduction is explicit, not
``DistributedDataParallel``'s: a step's loss comes from the model's loss
methods, not from a ``forward`` call whose reducer DDP would prepare.

A run dir is named ``<recipe>_<run id>`` with the JAX package's run id, and
holds the same files: ``config.json``, ``corpus.json``, ``metrics.jsonl`` and
msgpack checkpoints in the JAX package's layout (``params`` and ``ema_params``
as its parameter tree, ``opt_state`` as optax's state tree, ``step``).  A run
dir trained here loads through the JAX package's ``load_model_from_run``, and
a JAX run dir restores here.

A state is a dict of detached tensors: ``params`` (the model's named
parameters), ``opt_state`` (``count`` and Adam's ``mu`` and ``nu`` by
parameter name), ``step`` and, with EMA on, ``ema_params``.  ``fit`` copies a
state into the live model and returns a new one.
"""

from __future__ import annotations

import json
import logging
import os
import time
from contextlib import contextmanager

import numpy as np
import torch

from amss_tpu_torch.ckpt.checkpoint import AsyncCheckpointer, restore_checkpoint, restore_subtree
from amss_tpu_torch.data.device_corpus import DeviceCorpus
from amss_tpu_torch.data.mixer import Mixer, Plan
from amss_tpu_torch.data.prefetch import Prefetcher
from amss_tpu_torch.models.adapt import AdaptAutoencoder
from amss_tpu_torch.models.chimera import ChimeraModel
from amss_tpu_torch.models.dpcl import DPCLModel
from amss_tpu_torch.models.dprnn import DropoutKey
from amss_tpu_torch.models.l41 import L41Model
from amss_tpu_torch.models.tasnet import TasNetModel
from amss_tpu_torch.ops.metrics import sdr_improvement
from amss_tpu_torch.parallel.mesh import all_reduce_mean, broadcast_tensors, rank_and_world
from amss_tpu_torch.train.optim import Adam, AdamState, make_schedule
from amss_tpu_torch.utils.config import ModelConfig, RecipeConfig, recipe_to_dict, run_id
from amss_tpu_torch.utils.device import resolve_device
from amss_tpu_torch.utils.logging import MetricWriter
from amss_tpu_torch.utils.profiling import (
    TRAIN_BACKWARD,
    TRAIN_DRAW,
    TRAIN_FORWARD,
    TRAIN_GATHER,
    TRAIN_OPTIMIZER,
    TRAIN_PUT,
    TRAIN_STEP,
    span,
)
from amss_tpu_torch.weights import jax_tree, load_model_from_run, named_from_jax

_MODELS = {"dpcl": DPCLModel, "adapt_ae": AdaptAutoencoder, "tasnet": TasNetModel,
           "l41": L41Model, "chimera": ChimeraModel}


def make_model(cfg: ModelConfig, base_run: str | None = None, device=None) -> torch.nn.Module:
    """A model of ``cfg.kind``; an enhance model over the trained separator
    of the run dir ``base_run``, loaded on ``device``."""
    if cfg.kind in _MODELS:
        return _MODELS[cfg.kind](cfg)
    if cfg.kind == "enhance":
        from amss_tpu_torch.models.enhance import EnhancerModel

        if not base_run:
            raise ValueError("enhance model needs recipe.base_run (run dir)")
        return EnhancerModel(cfg, load_model_from_run(base_run, device=device))
    raise ValueError(f"unknown model kind {cfg.kind!r}")


def _clone(named: dict) -> dict:
    return {k: v.detach().clone() for k, v in named.items()}


class _NoMetrics:
    """The metric writer of a rank other than 0: rank 0 writes the ranks'
    metrics, which are equal."""

    def scalars(self, step, values) -> None:
        pass

    def image(self, step, tag, img) -> None:
        pass

    def flush(self) -> None:
        pass


class Trainer:
    """Trains ``recipe`` on the speakers of ``store``, in
    ``<workdir>/<recipe name>_<run id>`` unless ``run_dir`` names the dir.

    Runs on ``cuda`` unless ``device`` names another (``"cpu"`` runs the plain
    versions of the kernels); without a card and without ``device`` it
    raises.  ``train.steps_per_call`` is accepted and runs the same per-step
    loop: the JAX package scans that many steps per call for the TPU, the
    per-step math is the same, and the run id leaves the knob out, so it
    cannot change the trajectory.

    A Trainer made inside a process group is that group's rank, and ``fit``
    and ``valid_loss`` raise unless the group has ``train.data_axis`` ranks
    (a Trainer that only restores a run needs no group)."""

    def __init__(self, recipe: RecipeConfig, store, workdir: str = "runs",
                 run_dir: str | None = None, device=None):
        t = recipe.train
        if t.data_axis < 1 or t.batch_size % t.data_axis != 0:
            raise ValueError(
                f"global batch {t.batch_size} not divisible by {t.data_axis} ranks")
        if (t.batch_size // t.data_axis) % max(t.accum_steps, 1) != 0:
            raise ValueError(f"batch_size {t.batch_size} over {t.data_axis} ranks not "
                             f"divisible by accum_steps {t.accum_steps}")
        self.group = rank_and_world()  # (rank, world) inside a process group
        self.rank = 0 if self.group is None else self.group[0]
        self.device = resolve_device(device)
        self.recipe = recipe
        self.rid = run_id(recipe)
        self.dir = run_dir or os.path.join(workdir, f"{recipe.name}_{self.rid}")
        self._check_corpus_collision(store)
        # the gram products of the loss and every other product run in FP32 on
        # the card (the default, stated); the BLSTM turns cuDNN's TF32 off itself
        torch.backends.cuda.matmul.allow_tf32 = False
        self.model = make_model(recipe.model, recipe.base_run, self.device).to(self.device)
        self.mixer = Mixer(store, nb_speakers=recipe.model.nb_speakers,
                           chunk_samples=t.chunk_samples, seed=t.seed)
        # a corpus resident on the device: batches become plans.  An upload
        # that fails raises; there is no fallback to host batches
        self.corpus = DeviceCorpus(store, t.chunk_samples, self.device) if t.device_data else None
        named = [(n, p) for n, p in self.model.named_parameters() if p.requires_grad]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self._front = [i for i, n in enumerate(self.names) if n.startswith("front.")]
        self.opt = Adam(self.params, make_schedule(t), t.grad_clip)
        self.ema: list[torch.Tensor] | None = None
        self.step = 0
        self.writer = MetricWriter(self.dir) if self.rank == 0 else _NoMetrics()
        self._ckpt = AsyncCheckpointer()
        self._warned_summaries = False
        self._warned_quality = False

    # -- states ------------------------------------------------------------
    def init_state(self) -> dict:
        """A fresh state: parameters drawn from a CPU generator seeded with
        ``train.seed``, zero moments, step 0.  With ``pretrained_front`` set,
        the front's parameters come from that run dir's best checkpoint."""
        gen = torch.Generator().manual_seed(self.recipe.train.seed)
        model = make_model(self.recipe.model, self.recipe.base_run, "cpu")
        model.init_parameters(gen)
        params = {n: p.detach() for n, p in model.named_parameters()}
        if self.recipe.pretrained_front:
            tree = restore_subtree(self.recipe.pretrained_front,
                                   jax_tree(params), keys=["front"])
            params.update(named_from_jax({"front": tree["front"]}))
        return self._fresh_state({n: v.to(self.device) for n, v in params.items()})

    def _fresh_state(self, params: dict) -> dict:
        state = {"params": params, "step": 0,
                 "opt_state": {"count": 0,
                               "mu": {n: torch.zeros_like(params[n]) for n in self.names},
                               "nu": {n: torch.zeros_like(params[n]) for n in self.names}}}
        if self.recipe.train.ema_decay > 0.0:
            state["ema_params"] = {n: params[n].clone() for n in self.names}
        return state

    def state(self) -> dict:
        """A snapshot of the live state."""
        st = self.opt.state
        out = {"params": _clone(dict(self.model.named_parameters())), "step": self.step,
               "opt_state": {"count": st.count,
                             "mu": _clone(dict(zip(self.names, st.mu))),
                             "nu": _clone(dict(zip(self.names, st.nu)))}}
        if self.ema is not None:
            out["ema_params"] = _clone(dict(zip(self.names, self.ema)))
        return out

    @torch.no_grad()
    def load_state(self, state: dict) -> None:
        """Copy ``state`` into the live model, optimiser and EMA."""
        live = dict(self.model.named_parameters())
        for n, v in state["params"].items():
            live[n].copy_(v)
        opt = state["opt_state"]
        self.opt.state = AdamState(
            mu=[opt["mu"][n].to(self.device, copy=True) for n in self.names],
            nu=[opt["nu"][n].to(self.device, copy=True) for n in self.names],
            count=int(opt["count"]))
        self.ema = None
        if self.recipe.train.ema_decay > 0.0:
            # a state from before EMA was on seeds the average at the params
            src = state.get("ema_params") or {n: live[n] for n in self.names}
            self.ema = [src[n].to(self.device, copy=True) for n in self.names]
        self.step = int(state["step"])

    def state_tree(self, state: dict) -> dict:
        """``state`` in the JAX package's checkpoint layout: parameter trees of
        numpy arrays and optax's state ``(clip, (adam, schedule))``, each tuple
        a map keyed by index as flax writes it."""
        opt = state["opt_state"]
        wf = self.recipe.model.kind != "enhance"  # the enhancer's tree has no front
        adam = {"count": np.asarray(opt["count"], np.int32),
                "mu": jax_tree(opt["mu"], with_front=wf), "nu": jax_tree(opt["nu"], with_front=wf)}
        sched = ({"count": np.asarray(opt["count"], np.int32)}
                 if self.recipe.train.lr_schedule == "cosine" else {})
        tree = {"params": jax_tree(state["params"], with_front=wf),
                "opt_state": {"0": {}, "1": {"0": adam, "1": sched}},
                "step": int(state["step"])}
        if "ema_params" in state:
            tree["ema_params"] = jax_tree(state["ema_params"], with_front=wf)
        return tree

    def state_from_tree(self, tree: dict) -> dict:
        """A state from a tree in the JAX package's layout (a checkpoint's, or
        ``{"params": ...}`` alone for fresh moments at step 0)."""

        def named(t: dict) -> dict:
            return {n: v.to(self.device) for n, v in named_from_jax(t).items()}

        state = self._fresh_state(named(tree["params"]))
        if "opt_state" in tree:
            adam = tree["opt_state"]["1"]["0"]
            mu, nu = named(adam["mu"]), named(adam["nu"])
            state["opt_state"] = {"count": int(adam["count"]),
                                  "mu": {n: mu[n] for n in self.names},
                                  "nu": {n: nu[n] for n in self.names}}
        state["step"] = int(tree.get("step", 0))
        if "ema_params" in tree and "ema_params" in state:
            ema = named(tree["ema_params"])
            state["ema_params"] = {n: ema[n] for n in self.names}
        return state

    # -- data --------------------------------------------------------------
    def _draw(self, split: str, step: int, batch_size: int, host: int = 0):
        """The host's draw of a batch: a ``Plan`` with a device corpus, else
        the audio."""
        with span(TRAIN_DRAW):
            if self.corpus is not None:
                return self.mixer.plan(split, step, batch_size, host=host)
            return self.mixer.batch(split, step, batch_size, host=host)

    def _ranks(self) -> tuple[int, int]:
        """(rank, world) of this Trainer; raises unless the process group
        (none for one rank) has ``train.data_axis`` ranks."""
        world = 1 if self.group is None else self.group[1]
        if world != self.recipe.train.data_axis:
            raise ValueError(f"train.data_axis={self.recipe.train.data_axis} needs a process "
                             f"group of that many ranks; this process is one of {world} "
                             "(parallel/mesh.py::init_data_parallel, or the CLI's train "
                             "--data-axis)")
        return self.rank, world

    @staticmethod
    def _host_arrays(batch) -> dict:
        """A plan as its three arrays (a few hundred bytes), or a host batch
        in the int16 wire format."""
        if isinstance(batch, Plan):
            return {"plan_ids": batch.speaker_ids, "plan_starts": batch.starts,
                    "plan_gains": batch.gains}
        q = np.clip(batch.sources * 32767.0, -32767.0, 32767.0).astype(np.int16)
        return {"sources_q": q}

    def _device_batch(self, batch) -> dict:
        """A plan or a host batch on the device, through pinned memory,
        copied without waiting on a card; an L41 host batch also carries its
        speakers' global ids [B, S]."""
        with span(TRAIN_PUT):
            arrays = self._host_arrays(batch)
            if self.recipe.model.kind == "l41" and not isinstance(batch, Plan):
                arrays["speaker_ids"] = batch.speaker_ids
            out = {}
            for k, v in arrays.items():
                t = torch.from_numpy(v)
                if self.device.type == "cuda":
                    out[k] = t.pin_memory().to(self.device, non_blocking=True)
                else:
                    out[k] = t.to(self.device)
            return out

    @staticmethod
    def _dequantize(batch: dict) -> dict:
        """int16 wire format -> float32 on the device, times exactly 1/32767."""
        out = dict(batch)
        if "sources_q" in out:
            out["sources"] = out.pop("sources_q").to(torch.float32) * (1.0 / 32767.0)
        return out

    def prep(self, batch: dict) -> dict:
        """A device batch as the loss takes it: a plan gathered from the
        device corpus (the speakers' ids ride along, as L41 needs them), or
        the int16 wire format dequantized."""
        if "plan_ids" not in batch:
            return self._dequantize(batch)
        sources = self.corpus.gather(batch["plan_ids"], batch["plan_starts"],
                                     batch["plan_gains"])
        return {"sources": sources, "speaker_ids": batch["plan_ids"]}

    def _check_corpus_collision(self, store) -> None:
        """Refuse a run dir that was trained on another corpus: the run id
        hashes the config only, so the corpus root is kept in
        ``corpus.json``."""
        self._corpus_root = os.path.abspath(getattr(store, "root", ""))
        side = os.path.join(self.dir, "corpus.json")
        if not os.path.exists(side):
            return
        with open(side) as f:
            prev = json.load(f).get("corpus_root", "")
        if prev and self._corpus_root and prev != self._corpus_root:
            raise ValueError(
                f"run dir {self.dir} was trained on corpus {prev!r} but this Trainer was "
                f"given {self._corpus_root!r}; the run id hashes the config only, so pass "
                "a distinct workdir/run_dir per corpus (or delete the old dir)")

    def _write_config(self) -> None:
        os.makedirs(self.dir, exist_ok=True)
        with open(os.path.join(self.dir, "config.json"), "w") as f:
            json.dump(recipe_to_dict(self.recipe), f, indent=1)
        if self._corpus_root:
            with open(os.path.join(self.dir, "corpus.json"), "w") as f:
                json.dump({"corpus_root": self._corpus_root}, f, indent=1)

    # -- the step ----------------------------------------------------------
    def dropout_key(self, step: int) -> DropoutKey:
        """The dropout key of ``step``: ``train.seed`` folded with the step."""
        return DropoutKey(self.recipe.train.seed).fold_in(step)

    def _train_step(self, batch: dict, front_grad_scale: float = 1.0) -> dict:
        """One optimiser step on a device batch; returns the metrics as
        tensors (nothing here waits for the device).  With ``accum_steps`` >
        1 the gradients and metrics are the means over that many
        microbatches, each with its own dropout key."""
        with span(TRAIN_STEP, step=self.step):
            return self._run_step(batch, front_grad_scale)

    def _run_step(self, batch: dict, front_grad_scale: float) -> dict:
        t = self.recipe.train
        key = self.dropout_key(self.step)
        accum = max(t.accum_steps, 1)
        with span(TRAIN_GATHER):
            full = self.prep(batch)
        mb_size = full["sources"].shape[0] // accum
        self.model.train()
        for p in self.params:
            p.grad = None
        msum: dict = {}
        for i in range(accum):
            mb = {k: v[i * mb_size : (i + 1) * mb_size] for k, v in full.items()}
            mkey = key.fold_in(i)
            if self.group is not None:  # this rank's rows of the global microbatch
                rank, world = self.group
                mkey = mkey.shard(rank * mb_size, mb_size, world * mb_size)
            with span(TRAIN_FORWARD, device=self.device):
                loss, metrics = self.model.loss_from_batch(mb, rng=mkey)
            with span(TRAIN_BACKWARD, device=self.device):
                loss.backward()
            for k, v in metrics.items():
                msum[k] = msum[k] + v.detach() if k in msum else v.detach()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if accum > 1:
            grads = [g / accum for g in grads]
            msum = {k: v / accum for k, v in msum.items()}
        if self.group is not None:  # the global mean, before the clip sees it
            names = sorted(msum)
            reduced = all_reduce_mean(grads + [msum[k] for k in names])
            grads, msum = reduced[: len(grads)], dict(zip(names, reduced[len(grads) :]))
        for i in self._front:
            grads[i] = grads[i] * front_grad_scale
        kernel = self.opt.kernel  # None on the CPU
        with span(TRAIN_OPTIMIZER, device=self.device, tensors=kernel.tensors if kernel else 0,
                  chunks=kernel.chunks if kernel else 0):
            self.opt.step(grads)
        for p in self.params:
            p.grad = None
        if self.ema is not None:
            d = t.ema_decay
            with torch.no_grad():
                for e, p in zip(self.ema, self.params):
                    e.copy_(d * e + (1.0 - d) * p)
        return msum

    # -- the fit loop --------------------------------------------------------
    def fit(self, state: dict | None = None, log_every: int = 50) -> dict:
        """Train from ``state`` (a fresh one by default) to ``train.steps``,
        validating and checkpointing every ``valid_every`` steps and at the
        end; returns the final state."""
        r = self.recipe.train
        rank, world = self._ranks()
        if rank == 0:
            self._write_config()
        self.load_state(self.init_state() if state is None else state)
        if self.group is not None:  # every rank starts from rank 0's state
            st = self.opt.state
            broadcast_tensors(self.params + (self.ema or []) + st.mu + st.nu)
        start = self.step
        local_bs = r.batch_size // world
        batches = Prefetcher(
            make_batch=lambda s: self._draw("train", s, local_bs, host=rank),
            put_batch=self._device_batch, start_step=start, end_step=r.steps)
        best_v, stale = float("inf"), 0
        t0 = time.time()
        try:
            for step, batch in batches:
                fscale = 0.0 if step < self.recipe.freeze_front_steps else 1.0
                metrics = self._train_step(batch, fscale)
                self.step = step + 1

                if (step + 1) % log_every == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["steps_per_sec"] = log_every / max(time.time() - t0, 1e-9)
                    t0 = time.time()
                    self.writer.scalars(step + 1, {f"train/{k}": v for k, v in m.items()})

                if (step + 1) % r.valid_every == 0 or step + 1 == r.steps:
                    vloss = self._validate(step)
                    if rank == 0:  # the ranks' states are equal
                        self._ckpt.save(self.dir, self.state_tree(self.state()),
                                        step=step + 1, metric=vloss)
                    if r.early_stop_patience > 0:
                        if vloss < best_v:
                            best_v, stale = vloss, 0
                        else:
                            stale += 1
                        if stale >= r.early_stop_patience:
                            self.writer.scalars(step + 1, {"train/early_stopped": 1.0})
                            break
        finally:
            batches.close()
        self._ckpt.wait()
        self.writer.flush()
        return self.state()

    @contextmanager
    def _serving_weights(self):
        """The weights validation ranks and serving uses: the EMA ones when
        EMA is on, swapped in for the block; the model in eval mode."""
        kept = None
        with torch.no_grad():
            if self.ema is not None:  # copies: cuDNN keeps the LSTM's weights in one buffer
                kept = [p.clone() for p in self.params]
                for e, p in zip(self.ema, self.params):
                    p.copy_(e)
            self.model.eval()
            try:
                yield
            finally:
                if kept is not None:
                    for k, p in zip(kept, self.params):
                        p.copy_(k)
                self.model.train()

    def _valid_split(self) -> tuple[str, int]:
        """The split and first step that validation draws from.  L41's
        centroid table covers the training speakers only, so it validates on
        them at chunk offsets training never draws (steps from 5,000,000 on),
        as the JAX package does."""
        return ("train", 5_000_000) if self.recipe.model.kind == "l41" else ("valid", 0)

    def valid_loss(self) -> float:
        """The mean loss over ``valid_steps`` fixed batches of the valid split
        (``_valid_split``); over ranks, each draws its rows of every batch
        and the ranks' means are averaged."""
        r = self.recipe.train
        rank, world = self._ranks()
        split, offset = self._valid_split()
        losses = []
        with self._serving_weights():
            for i in range(r.valid_steps):
                hb = self._draw(split, offset + i, r.batch_size // world, host=rank)
                loss, _ = self.model.loss_from_batch(self.prep(self._device_batch(hb)))
                losses.append(float(loss))
        vloss = float(np.mean(losses))
        if self.group is not None:
            vloss = float(all_reduce_mean([torch.tensor(vloss, dtype=torch.float64,
                                                        device=self.device)])[0])
        return vloss

    def _validate(self, step: int) -> float:
        vloss = self.valid_loss()
        if self.rank != 0:  # rank 0 writes what every rank would
            return vloss
        self.writer.scalars(step + 1, {"valid/loss": vloss})
        if self.recipe.train.valid_quality:
            self._quality_summary(step)
        self._image_summaries(step)
        return vloss

    def _quality_summary(self, step: int) -> None:
        """``valid/si_sdri``: the serving path (``separate``, L41 with its
        speakers' ids) on one valid batch of up to 8 mixtures, PIT SI-SDR less
        the mixture's, with the serving weights.  Best-effort: a failure is
        logged once and the summary stops, training goes on."""
        if not hasattr(self.model, "separate") or self._warned_quality:
            return
        try:
            split, offset = self._valid_split()
            hb = self.mixer.batch(split, offset + 999_983, min(self.recipe.train.batch_size, 8))
            src = torch.from_numpy(hb.sources).to(self.device)
            mix = src.sum(dim=1)
            with self._serving_weights():
                if self.recipe.model.kind == "l41":
                    ids = torch.from_numpy(hb.speaker_ids).to(self.device)
                    est = self.model.separate(mix, speaker_ids=ids)
                else:
                    est = self.model.separate(mix)
            q = float(sdr_improvement(est, src, mix).mean())
            self.writer.scalars(step + 1, {"valid/si_sdri": q})
        except Exception:
            self._warned_quality = True
            logging.getLogger(__name__).warning(
                "valid_quality summary failed; disabling for this run", exc_info=True)

    def _image_summaries(self, step: int) -> None:
        """Log-spectrogram images of one valid mixture and, for a model that
        separates, of the first speaker separated from it.  Best-effort: a
        failure is logged once and the summaries stop, training goes on."""
        if self._warned_summaries:
            return
        try:
            with self._serving_weights():
                hb = self.mixer.batch("valid", 0, 1)
                mix = torch.from_numpy(hb.sources.sum(axis=1)).to(self.device)
                front = self.model.front
                codes, _ = front.encode(mix)
                self.writer.image(step + 1, "valid/mix_log_spectrogram",
                                  front.features(codes)[0].T.cpu().numpy())
                if not hasattr(self.model, "separate"):
                    return
                est = self.model.separate(mix)
                ecodes, _ = front.encode(est[:, 0])
                self.writer.image(step + 1, "valid/est0_log_spectrogram",
                                  np.log(ecodes[0].T.cpu().numpy() + 1e-7))
        except Exception:
            self._warned_summaries = True
            logging.getLogger(__name__).warning(
                "image summaries failed; disabling for this run", exc_info=True)

    def restore(self, best: bool = False) -> dict:
        """The state of the run dir's latest (or best) checkpoint."""
        self._ckpt.wait()
        tree, _ = restore_checkpoint(self.dir, best=best)
        return self.state_from_tree(tree)
