"""model.mfu.serve: the analytic operations of the audio served in the
traced window (each mixture at its own length, padding not counted) over the
window's seconds, as a share of the card's 495 TFLOP/s (dense TF32, the
highest rate at which it multiplies float32 operands)."""

from bm import flops

READS = ("counters", "trace")


def read(r):
    lengths = r.counters.get("audio_lengths")
    if not lengths:
        return None
    ops = sum(flops.forward_flops(r.cell.config, t) for t in lengths)
    return 100.0 * ops / r.trace.window_s / flops.MFU_PEAK
