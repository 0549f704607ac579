"""Rank workers of the data-parallel tests (``tests/test_torch_ddp.py``).

``parallel/mesh.py::run_ranks`` starts each in a fresh process, which imports
this module by name: it imports torch and the port only, never JAX.

Each rank computes on one CPU thread.  With more, the math library may use
fewer threads for a product when the machine is busy, which sums in another
order: the DPCL loss, a difference of large sums, then moved by up to 3e-5
relative from run to run on the same inputs, more than the tests allow.
The ranks write their metrics as JSON lines only: importing TensorBoard
(which pulls in TensorFlow here) would cost each rank 0 about 10 s.
"""

import os
import sys

import torch

from amss_tpu_torch.data.store import SpeakerStore
from amss_tpu_torch.train.engine import Trainer


def capture_first_step(tr: Trainer) -> dict:
    """Keep the first step's metrics and the gradients Adam receives (after
    the ranks' reduction, before the clip) in the returned dict."""
    seen: dict = {}
    step, opt_step = tr._train_step, tr.opt.step

    def train_step(*a, **k):
        m = step(*a, **k)
        seen.setdefault("metrics", {n: float(v) for n, v in m.items()})
        return m

    def adam(grads):
        seen.setdefault("grads", {n: g.detach().clone() for n, g in zip(tr.names, grads)})
        return opt_step(grads)

    tr._train_step, tr.opt.step = train_step, adam
    return seen


def fit_rank(rank: int, world: int, recipe, corpus: str, out_dir: str,
             params_tree=None) -> None:
    """Fit ``recipe`` as one rank, in its own run dir ``out_dir/rank<r>`` (so
    that what each rank writes shows), from ``params_tree`` (the JAX
    package's layout) where given; save the first step and the final
    parameters to ``out_dir/rank<r>.pt``."""
    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None  # MetricWriter's optional mirror: off
    tr = Trainer(recipe, SpeakerStore(corpus), run_dir=os.path.join(out_dir, f"rank{rank}"),
                 device="cpu")
    seen = capture_first_step(tr)
    state = None if params_tree is None else tr.state_from_tree({"params": params_tree})
    final = tr.fit(state, log_every=1)
    torch.save({"first": seen, "params": final["params"], "step": final["step"]},
               os.path.join(out_dir, f"rank{rank}.pt"))


def fail_on_rank_1(rank: int, world: int) -> None:
    """Rank 1 fails; rank 0 returns."""
    if rank == 1:
        raise RuntimeError("rank 1 fails")
