"""The multi-tensor clip and Adam (``ops/kernels/multi_adam.py``,
``csrc/multi_adam.cu``), the CUDA path of ``train/optim.py::Adam.step``.

On the CPU: the chunk planner (a pure function of the shapes), the checks the
wrapper makes before a launch, that every training recipe trains float32
parameters the kernel takes, and that CPU parameters keep the plain version.

On the card (marked ``card``; ``python -m pytest tests/test_torch_multi_adam.py
--noconftest -m card``, since the card's machine has no JAX for
``conftest.py``): the kernel pair against the plain version ``adam_ref`` on the same
card, over Conv-TasNet's and c1's parameter lists, three steps each:

* a step that does not clip is bit-equal in p, m and v: the same float32
  operations in the same order, each rounded once;
* a step that clips, with gradients whose squares sum exactly in float32, is
  bit-equal too: both norms are then the same number;
* a step that clips random gradients differs only by the norm's order of
  summation (the plain version sums per tensor in float32, then the
  tensors; the kernel per chunk in float32, then the chunks in float64): the
  kernel's norm lies within 1 ulp of the exact one, and the plain version
  given the kernel's norm is bit-equal.  (The plain version's own norm lies
  up to 5 ulp from the exact one on Conv-TasNet's 320 tensors, so an
  element-by-element comparison of the two paths measures that error.)
* the last step follows a new state (as ``Trainer.load_state`` sets one) and
  parameters whose storage moved, so pointers left from an earlier step
  would show.

This file imports no JAX: the card's machine has none.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from amss_tpu_torch.configs import recipes
from amss_tpu_torch.ops.kernels.multi_adam import CHUNK, MultiTensorAdam, check_tensor, plan_chunks
from amss_tpu_torch.train import optim
from amss_tpu_torch.train.engine import make_model
from amss_tpu_torch.train.optim import (
    Adam, AdamState, adam_ref, bias_corrections, constant_schedule, global_norm)
from chip_smoke import _ulps, convtasnet_luo2019

# Conv-TasNet at Luo and Mesgarani's best widths, as the benchmark's
# convtasnet_luo2019 configuration builds it in the port
CONVTASNET = convtasnet_luo2019()
MAX_NORM = 5.0
LR = 1e-3
C1_RUN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "checkpoints", "c1_dpcl")


@pytest.fixture
def card():
    """The CUDA device of a test marked ``card``; skips where there is none
    (decided when the test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: python -m pytest "
                    "tests/test_torch_multi_adam.py --noconftest -m card)")
    return torch.device("cuda")


def _trainable(model) -> list[torch.Tensor]:
    """The parameters a Trainer hands Adam."""
    return [p for p in model.parameters() if p.requires_grad]


def _covered(plan: np.ndarray, numels) -> np.ndarray:
    """How often the plan covers each element, tensor by tensor, concatenated."""
    counts = [np.zeros(n, dtype=np.int64) for n in numels]
    for t, start, stop in plan:
        counts[t][start:stop] += 1
    return np.concatenate(counts) if counts else np.zeros(0, dtype=np.int64)


# -- the planner (CPU) --------------------------------------------------------

PLANS = {
    "ragged": [1, 5, CHUNK - 1, CHUNK, CHUNK + 1, 3 * CHUNK + 7],
    "one_and_65536": [1, 65536, 1],
    "with_empty": [0, 17, 0, 2 * CHUNK],
    "convtasnet": [p.numel() for p in _trainable(make_model(CONVTASNET))],
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_covers_every_element_once(name):
    numels = PLANS[name]
    plan = plan_chunks(numels)
    assert plan.dtype == np.int64 and plan.shape[1] == 3
    assert (_covered(plan, numels) == 1).all()
    assert len(plan) == sum(-(-n // CHUNK) for n in numels)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_chunks_never_cross_a_tensor(name):
    numels = PLANS[name]
    plan = plan_chunks(numels)
    t, start, stop = plan.T
    sizes = np.asarray(numels)[t]
    assert ((0 <= start) & (start < stop) & (stop <= sizes)).all()
    assert (stop - start <= CHUNK).all()
    assert (start % CHUNK == 0).all()  # every chunk keeps its tensor's alignment
    assert (np.diff(t) >= 0).all()  # in the tensors' order


@pytest.mark.parametrize("numel,chunk,rows", [(1, CHUNK, [(0, 0, 1)]),
                                              (65536, CHUNK, [(0, s, s + CHUNK)
                                                              for s in range(0, 65536, CHUNK)]),
                                              (65536, 65536, [(0, 0, 65536)]),
                                              (10, 4, [(0, 0, 4), (0, 4, 8), (0, 8, 10)])])
def test_plan_of_one_tensor(numel, chunk, rows):
    assert plan_chunks([numel], chunk).tolist() == [list(r) for r in rows]


def test_plan_of_nothing_and_a_bad_chunk():
    assert plan_chunks([]).shape == (0, 3)
    assert plan_chunks([0, 0]).shape == (0, 3)
    with pytest.raises(ValueError):
        plan_chunks([4], 0)


def _recipe_models():
    """Every recipe that trains: the CLI's recipes and the dual-path trunks."""
    out = {}
    for name, make in recipes.ALL_RECIPES.items():
        if name == "c3":
            r = make(n_train_speakers=10)
        elif name == "enh":
            r = make(base_run=C1_RUN)
        else:
            r = make()
        out[name] = r
    for trunk in ("dprnn", "dpt"):
        out[f"c6_{trunk}"] = recipes.c6_dual_path(trunk)
    out["c1_bf16"] = dataclasses.replace(out["c1"], model=dataclasses.replace(
        out["c1"].model, sep=dataclasses.replace(out["c1"].model.sep, compute_dtype="bfloat16")))
    return out


RECIPES = _recipe_models()


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_every_training_recipe_trains_what_the_kernel_takes(name):
    """float32 and contiguous: the kernel's path raises for anything else."""
    r = RECIPES[name]
    params = _trainable(make_model(r.model, r.base_run, "cpu"))
    assert params
    for i, p in enumerate(params):
        check_tensor("params", i, p, p.shape, p.device)
    assert {p.dtype for p in params} == {torch.float32}
    # every tensor has elements, so the kernel updates each
    assert len(np.unique(plan_chunks([p.numel() for p in params])[:, 0])) == len(params)


def test_checks_name_what_the_kernel_does_not_take():
    shape, cpu = torch.Size((6, 8)), torch.device("cpu")
    check_tensor("grads", 0, torch.ones(6, 8), shape, cpu)
    with pytest.raises(TypeError, match="float32"):
        check_tensor("grads", 0, torch.ones(6, 8, dtype=torch.float64), shape, cpu)
    with pytest.raises(ValueError, match="contiguous"):
        check_tensor("grads", 3, torch.ones(8, 6).t(), shape, cpu)
    with pytest.raises(ValueError, match=r"grads\[1\]"):
        check_tensor("grads", 1, torch.ones(48), shape, cpu)
    with pytest.raises(ValueError, match=r"mu\[2\] is \(6, 8\) on cpu"):
        check_tensor("mu", 2, torch.ones(6, 8), shape, torch.device("cuda", 0))


def test_kernel_path_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        MultiTensorAdam([torch.zeros(5)])


def test_cpu_parameters_take_the_plain_version():
    gen = torch.Generator().manual_seed(0)
    init = [torch.randn(s, generator=gen) for s in ((5, 3), (7,), (2, 2, 4))]
    grads = [[torch.randn(p.shape, generator=gen) * 3 for p in init] for _ in range(3)]
    params = [p.clone() for p in init]
    opt = Adam(params, constant_schedule(LR), MAX_NORM)
    assert opt.kernel is None
    ref = [p.clone() for p in init]
    mu, nu = [torch.zeros_like(p) for p in init], [torch.zeros_like(p) for p in init]
    before = MultiTensorAdam.launches
    for count, g in enumerate(grads, start=1):
        opt.step(g)
        adam_ref(ref, g, mu, nu, LR, *bias_corrections(count), MAX_NORM)
    assert MultiTensorAdam.launches == before
    for ours, theirs in ((params, ref), (opt.state.mu, mu), (opt.state.nu, nu)):
        for a, b in zip(ours, theirs):
            assert torch.equal(a, b)


# -- the kernel pair on the card -----------------------------------------------

def _card_params(cfg, card) -> list[torch.Tensor]:
    """The trainable parameters of ``cfg`` on the card, as a Trainer has them
    (cuDNN's LSTM keeps its weights as views of one buffer)."""
    return _trainable(make_model(cfg).to(card))


def _scaled_grads(params, gen, norm: float) -> list[torch.Tensor]:
    """Random gradients of global norm about ``norm``."""
    g = [torch.randn(p.shape, generator=gen, device=p.device) for p in params]
    s = norm / float(global_norm(g))
    return [x * s for x in g]


def _exact_grads(params, gen, norm: float) -> list[torch.Tensor]:
    """Gradients of 0 and +-2**k, k chosen so that the global norm passes
    ``norm``: their squares sum exactly in float32 in any order."""
    g = [(torch.randint(-1, 2, p.shape, generator=gen, device=p.device)).float()
         for p in params]
    count = sum(int((x != 0).sum()) for x in g)
    assert count < 2**24
    k = int(np.ceil(np.log2(norm / np.sqrt(count)))) + 1
    return [x * 2.0**k for x in g]


def _norm_ulps(a: float, b: float) -> float:
    return abs(a - b) / float(np.spacing(np.float32(b)))


@pytest.mark.card
@pytest.mark.parametrize("cfg", [CONVTASNET, recipes.c1_stft_dpcl().model],
                         ids=["convtasnet", "c1_dpcl"])
def test_kernel_against_the_plain_version(cfg, card, monkeypatch):
    gen = torch.Generator(device=card).manual_seed(0)
    params = _card_params(cfg, card)
    plain = [p.detach().clone() for p in params]
    mu, nu = [torch.zeros_like(p) for p in plain], [torch.zeros_like(p) for p in plain]
    opt = Adam(params, constant_schedule(LR), MAX_NORM)
    assert (opt.kernel.tensors, opt.kernel.chunks) == (
        len(params), len(plan_chunks([p.numel() for p in params])))
    steps = [("no clip", _scaled_grads(params, gen, 0.5 * MAX_NORM)),
             ("clip, exact norm", _exact_grads(params, gen, 3 * MAX_NORM)),
             ("clip after a new state", _scaled_grads(params, gen, 3 * MAX_NORM))]
    for count, (what, grads) in enumerate(steps, start=1):
        if count == 3:  # as Trainer.load_state: new moments, the same values
            st = opt.state
            opt.state = AdamState(mu=[m.clone() for m in st.mu], nu=[v.clone() for v in st.nu],
                                  count=st.count)
            for p in params:  # and parameters whose storage moved
                p.data = p.data.clone()
        before = MultiTensorAdam.launches
        opt.step(grads)
        assert MultiTensorAdam.launches == before + 2, what
        norm = opt.kernel.norm
        exact = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))
        assert _norm_ulps(float(norm), exact) <= 1, what  # float32 partials, a float64 sum
        if count == 2:
            assert float(global_norm(grads)) == float(norm), what
        # the plain version given the kernel's norm: the kernel's step bit for bit
        with monkeypatch.context() as m:
            m.setattr(optim, "global_norm", lambda tensors: norm)
            adam_ref(plain, grads, mu, nu, LR, *bias_corrections(count), MAX_NORM)
        torch.cuda.synchronize()
        for name, ours, theirs in (("p", params, plain), ("m", opt.state.mu, mu),
                                   ("v", opt.state.nu, nu)):
            for i, (a, b) in enumerate(zip(ours, theirs)):
                assert torch.equal(a, b), f"{what}: {name}[{i}] {_ulps(a, b)} ulp"


@pytest.mark.card
def test_kernel_step_needs_no_host_sync(card):
    gen = torch.Generator(device=card).manual_seed(1)
    params = _card_params(CONVTASNET, card)
    opt = Adam(params, constant_schedule(LR), MAX_NORM)
    grads = _scaled_grads(params, gen, 2 * MAX_NORM)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            opt.step(grads)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(torch.isfinite(p).all() for p in params)


@pytest.mark.card
@pytest.mark.parametrize("fault", ["float64_params", "noncontiguous_params",
                                   "noncontiguous_grads", "grad_shape", "cpu_grads"])
def test_kernel_raises_for_what_it_does_not_take(fault, card):
    dtype = torch.float64 if fault == "float64_params" else torch.float32
    w = torch.randn(6, 8, device=card, dtype=dtype)
    params = [w.t() if fault == "noncontiguous_params" else w, torch.zeros(3, device=card)]
    grads = [torch.ones_like(params[0]), torch.ones(3, device=card)]
    if fault == "noncontiguous_grads":
        grads[0] = torch.ones(8, 6, device=card).t()
    elif fault == "grad_shape":
        grads[1] = torch.ones(4, device=card)
    elif fault == "cpu_grads":
        grads[1] = torch.ones(3)
    before = MultiTensorAdam.launches
    with pytest.raises((TypeError, ValueError)):  # the params' faults when the pair is built
        Adam(params, constant_schedule(LR), MAX_NORM).step(grads)
    assert MultiTensorAdam.launches == before
