"""Clip by the global norm and Adam over a list of tensors in two launches:
the CUDA path of ``train/optim.py::Adam.step``.

``MultiTensorAdam(params)`` holds what the kernel pair of
``csrc/multi_adam.cu`` needs for one fixed list of float32 CUDA parameters:
the chunk table (``plan_chunks``, a pure function of the shapes), on the
device from the start.  Each step checks the parameters, Adam's moments and
the gradients, and sends their pointers in one small copy from pinned memory
(so a new state, as ``Trainer.load_state`` sets one, needs nothing more);
then the norm pass launches, inside the ``train.clip`` span, and the update
pass.  Nothing waits for the card.

The plain version is the per-tensor code of ``train/optim.py``, which the CPU
takes; this wrapper takes CUDA tensors only and raises for anything the kernel
does not take (a dtype other than float32, a tensor that is not contiguous,
another device, another shape): there is no fallback.
``MultiTensorAdam.launches`` counts the kernels' launches, two a step.
"""

from __future__ import annotations

import numpy as np
import torch

from amss_tpu_torch.ops.kernels.build import c_ints, check_device, check_launch, load_library
from amss_tpu_torch.utils.profiling import TRAIN_CLIP, span

CHUNK = 4096  # elements a block updates: a few thousand, so a step has enough blocks
_F32 = np.float32


def plan_chunks(numels, chunk: int = CHUNK) -> np.ndarray:
    """The chunk table of tensors of ``numels`` elements: int64 rows
    ``(tensor, start, stop)`` in order, each at most ``chunk`` elements of one
    tensor, together covering every element once (an empty tensor has
    none)."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    rows = [(t, s, min(s + chunk, n)) for t, n in enumerate(numels) for s in range(0, n, chunk)]
    return np.asarray(rows, dtype=np.int64).reshape(-1, 3)


def check_tensor(what: str, i: int, t: torch.Tensor, shape, device: torch.device) -> None:
    """Raise unless ``t`` (``what[i]``) is a contiguous float32 tensor of
    ``shape`` on ``device``."""
    if t.dtype != torch.float32:
        raise TypeError(f"multi_adam takes float32 tensors, {what}[{i}] is {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"multi_adam takes contiguous tensors, {what}[{i}] is not")
    if t.shape != shape or t.device != device:
        raise ValueError(f"{what}[{i}] is {tuple(t.shape)} on {t.device}, its parameter "
                         f"{tuple(shape)} on {device}")


class MultiTensorAdam:
    """The kernel pair over one fixed list of CUDA parameters."""

    launches = 0

    def __init__(self, params: list[torch.Tensor]):
        device = params[0].device
        check_device(device, "multi_adam")
        if device.type != "cuda":
            raise ValueError(f"multi_adam runs on CUDA tensors, got {device}")
        self.params = params
        self.shapes = [p.shape for p in params]
        self.device = device
        for i, p in enumerate(params):
            check_tensor("params", i, p, p.shape, device)
        plan = plan_chunks([p.numel() for p in params])
        self.tensors = len(np.unique(plan[:, 0]))  # those with elements
        self.chunks = len(plan)
        self.plan = torch.from_numpy(plan).to(device)
        self.norm: torch.Tensor | None = None  # the last step's global norm, on the device

    def _pointers(self, grads, mu, nu) -> torch.Tensor:
        """This step's pointers of ``[params, mu, nu, grads]`` on the device,
        every tensor checked."""
        lists = (("params", self.params), ("mu", mu), ("nu", nu), ("grads", grads))
        for what, tensors in lists:
            if len(tensors) != len(self.params):
                raise ValueError(f"{len(tensors)} {what} for {len(self.params)} parameters")
        index = self.device.index
        ptrs = []
        for what, tensors in lists:
            for i, (t, shape) in enumerate(zip(tensors, self.shapes)):
                if (t.dtype != torch.float32 or t.get_device() != index or t.shape != shape
                        or not t.is_contiguous()):
                    check_tensor(what, i, t, shape, self.device)  # raises, naming the fault
                ptrs.append(t.data_ptr())
        # the pinned block is not reused before the copy has run
        return torch.tensor(ptrs, dtype=torch.int64).pin_memory().to(self.device,
                                                                      non_blocking=True)

    def step(self, grads, mu, nu, **numbers) -> None:
        """Clip ``grads`` by their global norm and take Adam's step into the
        parameters and the moments ``mu`` and ``nu``, in place: ``launch`` on
        this step's pointers."""
        self.launch(self._pointers(grads, mu, nu), **numbers)

    def launch(self, ptrs: torch.Tensor, *, max_norm: float, b1: float, b2: float, eps: float,
               lr: float, bc1: float, bc2: float) -> None:
        """The norm pass (in the ``train.clip`` span) and the update pass over
        the tensors of ``ptrs`` (``_pointers``), with the bias corrections
        ``bc1`` and ``bc2``.  The numbers go to the card in float32 as the
        plain version on the card has them (a float32 tensor times or divided
        by a host number takes the number in float32; divided, times its
        float32 reciprocal)."""
        # the chunks' partial sums of g*g, then the norm (for the tests)
        partials = torch.empty(self.chunks + 1, dtype=torch.float32, device=self.device)
        sizes = c_ints(len(self.params), self.chunks)
        consts = [float(x) for x in (
            _F32(max_norm), _F32(1 - b1), _F32(b1), _F32(1 - b2), _F32(b2),
            _F32(1) / _F32(bc1), _F32(1) / _F32(bc2), _F32(eps), _F32(-lr))]
        lib = load_library()
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            with span(TRAIN_CLIP):
                err = lib.amss_multi_adam_norm(self.plan.data_ptr(), ptrs.data_ptr(),
                                               partials.data_ptr(), *sizes, stream)
                check_launch(lib, "multi_adam norm", err)
                MultiTensorAdam.launches += 1
            err = lib.amss_multi_adam_update(self.plan.data_ptr(), ptrs.data_ptr(),
                                             partials.data_ptr(), *sizes, *consts, stream)
            check_launch(lib, "multi_adam update", err)
            MultiTensorAdam.launches += 1
        self.norm = partials[self.chunks]
