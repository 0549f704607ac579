"""B1 and B2 are differentiable, each through the other: the port's autograd
functions against the JAX package's ``custom_vjp`` (Pallas in interpret mode,
forced as tests/test_pallas_kernels.py runs it) and against torch autograd of
the plain versions, on the CPU.

Tolerance: every gradient within 2e-5 of the reference's largest magnitude
(float32 sums of up to ~1000 products, taken in another order); against the
plain versions' autograd on the CPU, where the port's backward runs the same
plain products, 1e-5 of it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amss_tpu.ops.pallas.framed_matmul import framed_matmul as jfm
from amss_tpu.ops.pallas.ola import pallas_decode_ola
from amss_tpu_torch.ops.kernels import framed_matmul as fm_mod
from amss_tpu_torch.ops.kernels import ola as ola_mod
from amss_tpu_torch.ops.kernels.framed_matmul import framed_matmul, framed_matmul_ref
from amss_tpu_torch.ops.kernels.ola import decode_ola, decode_ola_ref

torch.set_num_threads(2)

TOL_JAX = 2e-5
TOL_PLAIN = 1e-5


def _close(got: torch.Tensor, want, tol: float, what: str) -> None:
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err:.3e} > {tol:g} x {scale:.3g}"


def _torch_grads(fn, *args, cot):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = fn(*leaves)
    out.backward(torch.from_numpy(cot))
    return out, [t.grad for t in leaves]


# (win, hop, K, T): hop 32 as the JAX package's own gradient tests, and the
# STFT shape 256/64 with K = 258
FM_SHAPES = [(128, 32, 32, 1024), (256, 64, 258, 3001)]


@pytest.mark.parametrize("win,hop,k,t", FM_SHAPES)
def test_framed_matmul_grads_match_custom_vjp_and_plain_autograd(rng, win, hop, k, t):
    x = rng.standard_normal((2, t)).astype(np.float32)
    basis = rng.standard_normal((win, k)).astype(np.float32)
    nf = 1 + (t - win) // hop
    cot = rng.standard_normal((2, nf, k)).astype(np.float32)

    out_j, vjp = jax.vjp(lambda a, b: jfm(a, b, hop=hop, interpret=True, force=True),
                         jnp.asarray(x), jnp.asarray(basis))
    gx_j, gb_j = vjp(jnp.asarray(cot))
    out, (gx, gb) = _torch_grads(lambda a, b: framed_matmul(a, b, hop, force=True),
                                 x, basis, cot=cot)
    assert out.grad_fn is not None
    _close(out, out_j, TOL_JAX, "out")
    _close(gx, gx_j, TOL_JAX, "dx vs custom_vjp")
    _close(gb, gb_j, TOL_JAX, "dbasis vs custom_vjp")

    _, (gx_p, gb_p) = _torch_grads(lambda a, b: framed_matmul_ref(a, b, hop), x, basis, cot=cot)
    _close(gx, gx_p.numpy(), TOL_PLAIN, "dx vs plain autograd")
    _close(gb, gb_p.numpy(), TOL_PLAIN, "dbasis vs plain autograd")


# (NF, K, win, hop, length): hop 32 trimmed as the JAX package's test, the
# iSTFT shape 258 x 256 / 64 at its full length, trimmed and zero-padded
OLA_SHAPES = [
    (30, 16, 128, 32, 900),
    (44, 258, 256, 64, None),
    (44, 258, 256, 64, 2900),
    (44, 258, 256, 64, 3300),
]


@pytest.mark.parametrize("nf,k,win,hop,length", OLA_SHAPES)
def test_decode_ola_grads_match_custom_vjp_and_plain_autograd(rng, nf, k, win, hop, length):
    codes = rng.standard_normal((2, nf, k)).astype(np.float32)
    basis = rng.standard_normal((k, win)).astype(np.float32)
    t_out = length if length is not None else (nf - 1) * hop + win
    cot = rng.standard_normal((2, t_out)).astype(np.float32)

    out_j, vjp = jax.vjp(
        lambda c, b: pallas_decode_ola(c, b, hop=hop, length=length, interpret=True, force=True),
        jnp.asarray(codes), jnp.asarray(basis))
    gc_j, gb_j = vjp(jnp.asarray(cot))
    out, (gc, gb) = _torch_grads(lambda c, b: decode_ola(c, b, hop, length=length, force=True),
                                 codes, basis, cot=cot)
    assert out.grad_fn is not None
    _close(out, out_j, TOL_JAX, "out")
    _close(gc, gc_j, TOL_JAX, "dcodes vs custom_vjp")
    _close(gb, gb_j, TOL_JAX, "dbasis vs custom_vjp")

    _, (gc_p, gb_p) = _torch_grads(lambda c, b: decode_ola_ref(c, b, hop, length),
                                   codes, basis, cot=cot)
    _close(gc, gc_p.numpy(), TOL_PLAIN, "dcodes vs plain autograd")
    _close(gb, gb_p.numpy(), TOL_PLAIN, "dbasis vs plain autograd")


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*args, **kw):
        calls.append(kw.get("force"))
        return real(*args, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_each_backward_runs_the_other_wrapper_only_when_needed(rng, monkeypatch):
    """dx/dcodes go through the other kernel's public wrapper, forced when the
    forward was; a basis-only gradient never calls it."""
    ola_calls = _spy(monkeypatch, ola_mod, "decode_ola")
    fm_calls = _spy(monkeypatch, ola_mod, "framed_matmul")
    x = torch.from_numpy(rng.standard_normal((2, 1024)).astype(np.float32))
    basis = torch.from_numpy(rng.standard_normal((256, 258)).astype(np.float32))

    basis.requires_grad_(True)
    fm_mod.framed_matmul(x, basis, 64).sum().backward()
    assert ola_calls == [] and basis.grad is not None
    x.requires_grad_(True)
    fm_mod.framed_matmul(x, basis, 64).sum().backward()
    assert ola_calls == [False] and x.grad.shape == x.shape

    codes = torch.from_numpy(rng.standard_normal((2, 13, 258)).astype(np.float32))
    syn = basis.detach().T.contiguous().requires_grad_(True)
    decode_ola(codes, syn, 64, length=900).sum().backward()
    assert fm_calls == [] and syn.grad is not None
    codes.requires_grad_(True)
    decode_ola(codes, syn, 32, length=900, force=True).sum().backward()
    assert fm_calls == [True] and codes.grad.shape == codes.shape


def test_no_grad_input_records_no_graph(rng):
    x = torch.from_numpy(rng.standard_normal((2, 1024)).astype(np.float32))
    basis = torch.from_numpy(rng.standard_normal((256, 258)).astype(np.float32))
    assert framed_matmul(x, basis, 64).grad_fn is None
    with torch.no_grad():
        assert framed_matmul(x, basis.requires_grad_(True), 64).grad_fn is None
