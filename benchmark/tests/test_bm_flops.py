"""The analytic operation and byte counts against hand counts and against
PyTorch's own count of the references' products."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bm import flops
from bm_tiny import tiny_config


def test_framed_matmul_cost_by_hand():
    # [1, 512] at 256/64: 5 frames of a [256, 258] basis
    ops, nbytes = flops.framed_matmul_cost(1, 512, 256, 64, 258)
    assert ops == 2 * 5 * 256 * 258
    assert nbytes == 4 * (512 + 256 * 258 + 5 * 258)


def test_decode_ola_cost_by_hand():
    ops, nbytes = flops.decode_ola_cost(4, 5, 258, 256, 512)
    assert ops == 2 * 4 * 5 * 258 * 256
    assert nbytes == 4 * (4 * 5 * 258 + 258 * 256 + 4 * 512)


def test_roofline_takes_the_larger_bound():
    assert flops.roofline_seconds(165e12, 0.0) == pytest.approx(1.0)
    assert flops.roofline_seconds(0.0, 3.35e12) == pytest.approx(1.0)
    assert flops.PEAK_FP32_ACCURATE_TC * 3 == flops.MFU_PEAK == 495e12


def test_lstm_and_kmeans_by_hand():
    assert flops.lstm_flops(10, 3, 2) == 4 * 2 * (3 + 2) * 2 * 10
    # seeding 2·n·e + 2·n·e·1, one iteration 4·n·e·k, final 2·n·e·k
    assert flops.kmeans_flops(4, 2, 2, 1) == 16 + 16 + 64 + 32


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_dpcl_counts_match_the_references_products():
    from reference import dpcl
    from reference.dsp import Products

    cfg = tiny_config("dpcl_hershey2016")
    h, e, f = cfg["blstm_hidden_dim"], cfg["embedding_dim"], cfg["freq_bins"]
    shapes = {"proj.weight": (f * e, 2 * h), "proj.bias": (f * e,)}
    for layer, n_in in ((0, f), (1, 2 * h)):
        for sfx in ("", "_reverse"):
            shapes[f"blstm.lstm.weight_ih_l{layer}{sfx}"] = (4 * h, n_in)
            shapes[f"blstm.lstm.weight_hh_l{layer}{sfx}"] = (4 * h, h)
            shapes[f"blstm.lstm.bias_ih_l{layer}{sfx}"] = (4 * h,)
            shapes[f"blstm.lstm.bias_hh_l{layer}{sfx}"] = (4 * h,)
    w = {k: torch.randn(s) * 0.1 for k, s in shapes.items()}
    t = 256 + 64 * 9
    mix = torch.randn(t)
    counted = _counted(lambda: dpcl.embed(mix, w, cfg, Products()))
    nf = 10
    # the analytic pass without k-means, the soft masks' distances and synthesis
    expected = (dpcl.forward_flops(cfg, t)
                - flops.kmeans_flops(nf * f, e, 2, cfg["kmeans_iters"]) - 2 * nf * f * e * 2
                - 2 * 2 * nf * 2 * f * 256)
    assert counted == expected


def test_tasnet_counts_match_the_references_products():
    from reference import tasnet
    from reference.dsp import Products

    cfg = tiny_config("convtasnet_luo2019")
    n, l, b, h, p = cfg["N"], cfg["L"], cfg["B"], cfg["H"], cfg["P"]
    shapes = {"front.enc": (l, n), "front.dec": (n, l), "front.smooth": (4, 1),
              "tcn.in_proj.weight": (b, n), "tcn.in_proj.bias": (b,), "tcn.out_alpha": (b,),
              "proj_mask.weight": (n * 2, b), "proj_mask.bias": (n * 2,)}
    for i in range(cfg["R"] * cfg["X"]):
        q = f"tcn.blocks.{i}."
        shapes.update({q + "pw_in.weight": (h, b), q + "pw_in.bias": (h,), q + "a1": (h,),
                       q + "ln1.g": (h,), q + "ln1.b": (h,), q + "dw": (p, h), q + "a2": (h,),
                       q + "ln2.g": (h,), q + "ln2.b": (h,), q + "pw_res.weight": (b, h),
                       q + "pw_res.bias": (b,), q + "pw_skip.weight": (b, h),
                       q + "pw_skip.bias": (b,)})
    w = {k: torch.rand(s) for k, s in shapes.items()}
    t = 16 + 8 * 99
    counted = _counted(lambda: tasnet.forward(torch.randn(1, t), w, cfg, Products()))
    nf = 100
    # the depthwise taps are elementwise adds, which PyTorch does not count
    depthwise = cfg["R"] * cfg["X"] * 2 * nf * h * p
    assert counted == tasnet.forward_flops(cfg, t) - depthwise
    assert flops.forward_flops(cfg, t) == tasnet.forward_flops(cfg, t)
