"""model.mfu.train: the analytic operations of the training steps in the
traced window (forward at each row's length, backward at twice the forward,
recomputation not counted) over the window's seconds, as a share of the
card's 495 TFLOP/s (dense TF32)."""

from bm import flops

READS = ("counters", "trace")


def read(r):
    rows = r.counters.get("rows")
    if not rows:
        return None
    ops = 3.0 * rows * flops.forward_flops(r.cell.config, r.counters["chunk_samples"])
    return 100.0 * ops / r.trace.window_s / flops.MFU_PEAK
