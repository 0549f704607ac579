"""The BLSTM's ``traced`` path (``amss_tpu_torch/models/blstm.py``), the one
every exported program runs: against the explicit loop and the JAX package's
``blstm_stack`` on ragged prefix masks at one and two layers, through
``torch.export``, and a c1 embedding through an exported ``embed`` against
the live one.  atol 1e-5, ``test_torch_blstm.py``'s bound: float32 gate
arithmetic over a few steps, summed in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amss_tpu.models.blstm import blstm_stack, init_blstm_stack
from amss_tpu_torch.infer.export import _model_tree, _Program, _program_params
from amss_tpu_torch.models.blstm import BLSTM
from amss_tpu_torch.models.dpcl import DPCLModel
from amss_tpu_torch.models.dprnn import DPRNN, dprnn_stack
from amss_tpu_torch.utils.config import FrontConfig, ModelConfig, SeparatorConfig
from amss_tpu_torch.weights import lstm_state

torch.set_num_threads(2)

N_IN, HIDDEN, T = 37, 24, 11
ATOL = 1e-5


def _prefix_mask(lengths, t=T):
    m = np.zeros((len(lengths), t), np.float32)
    for b, n in enumerate(lengths):
        m[b, :n] = 1.0
    return m


@pytest.fixture(scope="module", params=[1, 2], ids=["1-layer", "2-layer"])
def stack(request):
    """(JAX layers, the port's BLSTM holding them)."""
    layers = jax.tree_util.tree_map(
        np.asarray, init_blstm_stack(jax.random.PRNGKey(request.param), N_IN, HIDDEN,
                                     request.param))
    m = BLSTM(N_IN, HIDDEN, request.param)
    m.lstm.load_state_dict(lstm_state(layers))
    return layers, m.eval()


@pytest.mark.parametrize("lengths", [None, (T, T, T), (T, 5, 1), (3, 7, 0)],
                         ids=["none", "full", "ragged", "ragged-empty"])
def test_traced_matches_loop_and_jax(rng, stack, lengths):
    layers, m = stack
    x = rng.standard_normal((3, T, N_IN)).astype(np.float32)
    mask = None if lengths is None else _prefix_mask(lengths)
    want = np.asarray(blstm_stack(layers, jnp.asarray(x),
                                  mask=None if mask is None else jnp.asarray(mask)))
    with torch.no_grad():
        tm = None if mask is None else torch.from_numpy(mask)
        got = m.traced(torch.from_numpy(x), tm)
        loop = m.loop(torch.from_numpy(x), tm)
    assert got.shape == want.shape == (3, T, 2 * HIDDEN)
    np.testing.assert_allclose(got.numpy(), loop.numpy(), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    if mask is not None:
        assert (got.numpy()[mask == 0] == 0).all()


class _Call(torch.nn.Module):
    def __init__(self, m):
        super().__init__()
        self.m = m

    def forward(self, x, mask):
        return self.m(x, mask)


def test_exported_forward_is_the_traced_path(rng, stack):
    """Under ``torch.export`` the forward takes ``traced``: the program holds
    plain LSTM calls (no packing, no copy to the host) and computes the loop's
    function on another ragged batch than the one it was traced on."""
    _, m = stack
    x0 = torch.zeros((3, T, N_IN))
    with torch.no_grad():
        ep = torch.export.export(_Call(m), (x0, torch.ones((3, T))))
    ops = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert ops.count("aten.lstm.input") == 2 * m.layers
    assert not any("pack" in op or "_local_scalar_dense" in op for op in ops)
    x = torch.from_numpy(rng.standard_normal((3, T, N_IN)).astype(np.float32))
    mask = torch.from_numpy(_prefix_mask((4, T, 0)))
    with torch.no_grad():
        np.testing.assert_allclose(ep.module()(x, mask).numpy(), m.loop(x, mask).numpy(),
                                   atol=ATOL)


def test_exported_c1_embed_matches_live(rng):
    cfg = ModelConfig(kind="dpcl", front=FrontConfig(kind="stft", win=256, hop=64),
                      sep=SeparatorConfig(hidden=16, layers=2, embed_dim=6), nb_speakers=2)
    model = DPCLModel(cfg)
    model.init_parameters(torch.Generator().manual_seed(3))
    model.eval()
    mix = torch.from_numpy(rng.standard_normal((3, 3000)).astype(np.float32) * 0.3)
    fmask = torch.from_numpy(_prefix_mask((43, 30, 9), t=43))
    params = _program_params(_model_tree(model), torch.device("cpu"))

    def embed(mix, frame_mask):
        return model.embed(model.front.features(model.front.encode(mix)[0]), frame_mask)

    with torch.no_grad():
        ep = torch.export.export(_Program(model, embed), (params, mix, fmask))
        got = ep.module()(params, mix, fmask)
        live = embed(mix, fmask)
    assert got.shape == (3, 43, 129, 6)
    np.testing.assert_allclose(got.numpy(), live.numpy(), atol=ATOL)


def test_exported_dprnn_matches_live(rng):
    """The dual-path trunk's BLSTMs under export: their host lengths are not
    computed, and the output is the live one's on a padded, masked batch."""
    dp = DPRNN(12, d_model=8, hidden=8, blocks=2)
    dp.init_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.standard_normal((2, 21, 12)).astype(np.float32))
    mask = torch.from_numpy(_prefix_mask((21, 13), t=21))

    class Stack(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.dp = dp

        def forward(self, x, mask):
            return dprnn_stack(self.dp, x, mask=mask, chunk_frames=4)

    with torch.no_grad():
        ep = torch.export.export(Stack(), (x, mask))
        np.testing.assert_allclose(ep.module()(x, mask).numpy(),
                                   dprnn_stack(dp, x, mask=mask, chunk_frames=4).numpy(),
                                   atol=ATOL)
