"""The TCN trunk (``amss_tpu_torch/models/tcn.py``) and its parts against the
JAX package (``amss_tpu/models/tcn.py``), both on the CPU, on the same
parameters (the JAX init carried across) and inputs.

Tolerances and why:
  * ``prelu``, ``layer_norm`` and the dilated depthwise conv: 1e-6 absolute
    on values of order 1 (the same few float32 operations; the layer norm's
    mean and variance summed in other orders);
  * ``tcn_stack`` in float32: 1e-5 absolute (six blocks of float32 products
    of at most 32 terms, summed in other orders);
  * ``tcn_stack`` with bf16 operands: 2e-2 of the output's largest
    magnitude.  A product operand that the two packages round to bf16 on
    either side of a rounding boundary (their float32 inputs differ in the
    last bits) differs by one bf16 step, 2^-8 of it, and such flips compound
    over six blocks;
  * every parameter gradient against ``jax.grad``: 1e-4 of each tensor's
    largest magnitude (float32);
  * one bf16 ``dense``: the output to 1e-5 of its scale (exact products,
    float32 sums in other orders), each gradient within one bf16 step of
    JAX's (both round the same float32 product to bf16, whose last bit a sum
    order can flip), 2^-8 of its magnitude;
  * padding and remat: bit for bit, in the port alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amss_tpu.models import tcn as jtcn
from amss_tpu.models.blstm import dense as j_dense
from amss_tpu.models.dprnn import layer_norm as j_layer_norm
from amss_tpu_torch.models import tcn
from amss_tpu_torch.models.blstm import dense
from amss_tpu_torch.models.dprnn import DropoutKey, LayerNorm, dropout, layer_norm
from amss_tpu_torch.weights import _flatten

torch.set_num_threads(2)

N_IN, BOTTLENECK, HIDDEN, BLOCKS, REPEATS = 24, 16, 32, 3, 2  # hidden 16, expansion 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _stacks(seed=0, kernel=3):
    jp = jtcn.init_tcn(jax.random.PRNGKey(seed), N_IN, BOTTLENECK, HIDDEN, BLOCKS, REPEATS,
                       kernel)
    # move the layer norms and slopes off their init, so each is exercised
    leaves, tree = jax.tree_util.tree_flatten(jp)
    rng = np.random.default_rng(seed)
    leaves = [jnp.asarray(np.asarray(x) + 0.1 * rng.standard_normal(x.shape), jnp.float32)
              for x in leaves]
    jp = jax.tree_util.tree_unflatten(tree, leaves)
    port = tcn.TCN(N_IN, BOTTLENECK, HIDDEN, BLOCKS, REPEATS, kernel)
    port.load_state_dict(_flatten(_np(jp), ""))
    return jp, port


def _grad(p: torch.Tensor) -> torch.Tensor:
    """A parameter's gradient, 0 where the loss never reads it (the last
    block's residual conv: only its skip output reaches the result)."""
    return torch.zeros_like(p) if p.grad is None else p.grad


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_prelu_acts_per_channel_on_the_last_axis():
    x, alpha = _x((2, 5, 7)), np.linspace(0.1, 0.7, 7).astype(np.float32)
    want = np.asarray(jtcn.prelu(jnp.asarray(alpha), jnp.asarray(x)))
    got = tcn.prelu(torch.from_numpy(alpha), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(got[x >= 0], x[x >= 0])


def test_bf16_dense_matches_jax_values_and_gradients():
    x, w, b = _x((6, 40, 48)), _x((48, 24), seed=2) * 0.2, _x((24,), seed=3)
    cot = _x((6, 40, 24), seed=4)

    def f(p, xx):
        return jnp.sum(j_dense(p, xx, jnp.bfloat16) * cot)

    want_y = np.asarray(j_dense({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
                                jnp.bfloat16))
    jg, jdx = jax.grad(f, argnums=(0, 1))({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                           jnp.asarray(x))
    layer = torch.nn.Linear(48, 24)
    layer.load_state_dict({"weight": torch.from_numpy(w.T.copy()), "bias": torch.from_numpy(b)})
    xt = torch.from_numpy(x).requires_grad_(True)
    y = dense(layer, xt, torch.bfloat16)
    (y * torch.from_numpy(cot)).sum().backward()
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), want_y, atol=1e-5 * np.abs(want_y).max())
    for got, want in ((xt.grad, jdx), (layer.weight.grad.T, jg["w"]), (layer.bias.grad, jg["b"])):
        want = np.asarray(want)
        assert np.all(np.abs(got.numpy() - want) <= 2.0**-8 * np.abs(want) + 1e-6)
    # the operands' gradients are rounded to bf16, as JAX's are; the bias's is not
    for g in (xt.grad, layer.weight.grad):
        assert torch.equal(g, g.bfloat16().float())


def test_layer_norm_uses_the_population_variance():
    x = _x((3, 9, 6)) * 3.0 + 1.0
    g, b = _x((6,), seed=2), _x((6,), seed=3)
    want = np.asarray(j_layer_norm({"g": jnp.asarray(g), "b": jnp.asarray(b)}, jnp.asarray(x)))
    p = LayerNorm(6)
    p.load_state_dict({"g": torch.from_numpy(g), "b": torch.from_numpy(b)})
    with torch.no_grad():
        got = layer_norm(p, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_dropout_is_identity_outside_training_and_raises_inside():
    """Without a key (evaluation) or at rate 0 dropout is the identity; with
    a key it zeroes some entries and scales the rest by 1/keep (the name is
    kept from when training-time dropout still raised)."""
    x = torch.ones(3000)
    assert dropout(x, 0.5, None) is x and dropout(x, 0.0, DropoutKey(0)) is x
    y = dropout(x, 0.1, DropoutKey(0))
    assert set(torch.unique(y).tolist()) == {0.0, float(torch.tensor(1.0) / 0.9)}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dilation", [1, 2, 4, 8, 16, 32, 64, 128])
def test_depthwise_dilated_matches_jax(dilation, causal):
    x, w = _x((2, 150, 5)), _x((3, 5), seed=2)
    want = np.asarray(jtcn._depthwise_dilated(jnp.asarray(w), jnp.asarray(x), dilation, causal))
    got = tcn._depthwise_dilated(torch.from_numpy(w), torch.from_numpy(x), dilation, causal)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_receptive_field_and_state_shapes_are_the_jax_packages():
    for args in ((8, 3, 3), (6, 2, 5)):
        assert tcn.receptive_field_frames(*args) == jtcn.receptive_field_frames(*args)
    assert tcn.dw_state_shapes(32, 3, 2, 3) == jtcn.dw_state_shapes(32, 3, 2, 3)


@pytest.mark.parametrize("causal", [False, True])
def test_tcn_stack_float32_matches_jax(causal):
    jp, port = _stacks()
    x = _x((2, 40, N_IN))
    mask = np.ones((2, 40), np.float32)
    mask[1, 27:] = 0.0
    for m in (None, mask):
        want = np.asarray(jtcn.tcn_stack(jp, jnp.asarray(x), None if m is None else jnp.asarray(m),
                                         blocks_per_repeat=BLOCKS, causal=causal))
        with torch.no_grad():
            got = tcn.tcn_stack(port, torch.from_numpy(x),
                                None if m is None else torch.from_numpy(m),
                                blocks_per_repeat=BLOCKS, causal=causal)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        if m is not None:
            assert not got[1, 27:].any()


def test_tcn_stack_bf16_matches_jax():
    jp, port = _stacks(seed=3)
    x = _x((2, 40, N_IN), seed=4)
    want = np.asarray(jtcn.tcn_stack(jp, jnp.asarray(x), blocks_per_repeat=BLOCKS,
                                     compute_dtype=jnp.bfloat16))
    with torch.no_grad():
        got = tcn.tcn_stack(port, torch.from_numpy(x), blocks_per_repeat=BLOCKS,
                            compute_dtype=torch.bfloat16).numpy()
        f32 = tcn.tcn_stack(port, torch.from_numpy(x), blocks_per_repeat=BLOCKS).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-2 * scale
    # bf16 operands do change the result: the check above is not float32's
    assert np.abs(f32 - want).max() > 1e-3 * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_rows_equal_unpadded_rows_bit_for_bit(dtype):
    _, port = _stacks(seed=5)
    x = torch.from_numpy(_x((1, 40, N_IN), seed=6))
    padded = torch.cat([x, torch.from_numpy(_x((1, 25, N_IN), seed=7)) * 5.0], dim=1)
    mask = torch.zeros((1, 65))
    mask[:, :40] = 1.0
    with torch.no_grad():
        alone = tcn.tcn_stack(port, x, blocks_per_repeat=BLOCKS, compute_dtype=dtype)
        inside = tcn.tcn_stack(port, padded, mask, blocks_per_repeat=BLOCKS, compute_dtype=dtype)
    assert torch.equal(inside[:, :40], alone)
    assert not inside[:, 40:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_gives_the_same_values_and_gradients(dtype):
    _, port = _stacks(seed=8)
    x = torch.from_numpy(_x((2, 30, N_IN), seed=9))
    mask = torch.ones((2, 30))
    mask[0, 22:] = 0.0
    outs = []
    for remat in (False, True):
        port.zero_grad()
        y = tcn.tcn_stack(port, x, mask, blocks_per_repeat=BLOCKS, compute_dtype=dtype,
                          remat=remat, rng=DropoutKey(0))
        (y * torch.linspace(-1, 1, y.shape[-1])).sum().backward()
        outs.append((y.detach(), {n: _grad(p).clone() for n, p in port.named_parameters()}))
    assert torch.equal(outs[0][0], outs[1][0])
    for n, g in outs[0][1].items():
        assert torch.equal(g, outs[1][1][n]), n


def test_every_parameter_gradient_matches_jax_grad():
    jp, port = _stacks(seed=10)
    x = _x((2, 36, N_IN), seed=11)
    mask = np.ones((2, 36), np.float32)
    mask[1, 25:] = 0.0
    cot = _x((2, 36, BOTTLENECK), seed=12)

    def f(p):
        y = jtcn.tcn_stack(p, jnp.asarray(x), jnp.asarray(mask), blocks_per_repeat=BLOCKS,
                           remat=True)
        return jnp.sum(y * cot)

    jg = _flatten(_np(jax.grad(f)(jp)), "")
    y = tcn.tcn_stack(port, torch.from_numpy(x), torch.from_numpy(mask),
                      blocks_per_repeat=BLOCKS, remat=True, rng=DropoutKey(0))
    (y * torch.from_numpy(cot)).sum().backward()
    names = dict(port.named_parameters())
    assert sorted(names) == sorted(jg)
    last = f"blocks.{len(port.blocks) - 1}.pw_res."
    for n, p in names.items():
        want = jg[n].numpy()
        scale = np.abs(want).max()
        assert (scale == 0) == n.startswith(last), n
        assert np.abs(_grad(p).numpy() - want).max() <= 1e-4 * scale, n


def test_init_draws_the_reference_distributions():
    port = tcn.TCN(64, 32, 64, 4, 2, 3)
    port.init_parameters(torch.Generator().manual_seed(0))
    jp = jtcn.init_tcn(jax.random.PRNGKey(0), 64, 32, 64, 4, 2, 3)
    bound = 1 / np.sqrt(64)
    assert 0.9 * bound < float(port.in_proj.weight.detach().abs().max()) <= bound
    assert not port.in_proj.bias.any()
    blk, jblk = port.blocks[0], jp["blocks"][0]
    assert float(blk.dw.detach().std()) == pytest.approx(float(np.std(jblk["dw"])), rel=0.1)
    assert float(blk.dw.detach().std()) == pytest.approx(1 / np.sqrt(3), rel=0.1)
    for name in ("a1", "a2"):
        assert torch.all(getattr(blk, name) == 0.25)
    assert torch.all(blk.ln1.g == 1) and not blk.ln2.b.any()
    assert torch.all(port.out_alpha == 0.25)
    assert len(port.blocks) == len(jp["blocks"]) == 8
