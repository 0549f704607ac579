"""The optimiser of ``amss_tpu/train/engine.py``, with optax's semantics:
``chain(clip_by_global_norm(grad_clip), adam(lr))`` and its learning-rate
schedules.

Everything a step computes stays on the device: the norm, the clip factor and
the moments are tensors, and the learning rate and Adam's bias corrections are
host numbers, computed from the host's step count in float32 as optax computes
them.  Nothing in ``step`` waits for the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from amss_tpu_torch.utils.config import TrainConfig
from amss_tpu_torch.utils.profiling import TRAIN_CLIP, span

_F32 = np.float32
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults; eps_root 0


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ Σ t²) over all tensors, as ``optax.global_norm``."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> list[torch.Tensor]:
    """``optax.clip_by_global_norm``: scale every gradient by ``max_norm /
    norm`` only when ``norm >= max_norm`` (``clip_grad_norm_`` would add 1e-6
    to the norm and scale below it too)."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm) * max_norm) for g in grads]


def constant_schedule(value: float):
    return lambda count: _F32(value)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0):
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then cosine decay to ``end_value`` at
    ``decay_steps`` (warm-up included), held after that."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError("the cosine phase needs decay_steps > warmup_steps")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = _F32(decay_steps - warmup_steps)

    def schedule(count: int) -> np.float32:
        if count < warmup_steps:  # optax's polynomial schedule of power 1
            c = _F32(min(max(count, 0), warmup_steps))
            frac = _F32(1) - c / _F32(warmup_steps)
            return _F32(init_value - peak_value) * frac + _F32(peak_value)
        c = _F32(min(_F32(count - warmup_steps), cos_steps))
        cosine = _F32(0.5) * (_F32(1) + _F32(np.cos(_F32(math.pi) * c / cos_steps)))
        return _F32(peak_value) * (_F32(1 - alpha) * cosine + _F32(alpha))

    return schedule


def make_schedule(t: TrainConfig):
    """The engine's schedule: constant, or cosine with warm-up
    ``min(warmup_steps, max(steps // 10, 1))``, ``decay_steps = max(steps,
    warmup + 1)`` and end value lr / 20."""
    if t.lr_schedule == "cosine":
        warmup = min(t.warmup_steps, max(t.steps // 10, 1))
        return warmup_cosine_decay_schedule(0.0, t.lr, warmup, max(t.steps, warmup + 1),
                                            t.lr / 20.0)
    return constant_schedule(t.lr)


@dataclass
class AdamState:
    """Adam's moments, one per trained parameter in order, and the count of
    steps taken (``ScaleByAdamState.count``, also the schedule's count)."""

    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    count: int = 0


class Adam:
    """``optax.chain(clip_by_global_norm(grad_clip), adam(schedule))`` over a
    fixed list of parameters, updated in place: b1 0.9, b2 0.999, eps 1e-8,
    eps_root 0."""

    def __init__(self, params: list[torch.Tensor], schedule, grad_clip: float):
        self.params = params
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.state = self.init()

    def init(self) -> AdamState:
        return AdamState(mu=[torch.zeros_like(p) for p in self.params],
                         nu=[torch.zeros_like(p) for p in self.params])

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> None:
        """One update from ``grads`` (one per parameter, in order)."""
        st = self.state
        lr = self.schedule(st.count)  # the schedule reads the count before the step
        count = st.count + 1
        # optax: 1 - decay**count in float32
        b1, b2 = ADAM_B1, ADAM_B2
        bc1 = float(_F32(1) - _F32(b1) ** _F32(count))
        bc2 = float(_F32(1) - _F32(b2) ** _F32(count))
        with span(TRAIN_CLIP):
            clipped = clip_by_global_norm(grads, self.grad_clip)
        for p, g, mu, nu in zip(self.params, clipped, st.mu, st.nu):
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
            p.add_(u * float(-lr))
        st.count = count
