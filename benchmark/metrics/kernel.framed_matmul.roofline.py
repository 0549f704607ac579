"""kernel.framed_matmul.roofline: B1's least time over its device time in
the traced window.  Each call's least time is max(operations / 165 TFLOP/s,
bytes / 3.35 TB/s) from its shape (3xTF32 runs three TF32 products, so its
float32-accurate peak is 495 / 3); the shapes are the STFT of every batch
that reached ``model.separate``, one B1 launch each.  Nothing is read where
the launches in the trace are not one per call."""

from bm import flops

READS = ("counters", "trace")
KERNEL = "framed_matmul_kernel"


def read(r):
    calls = r.counters.get("calls") or []
    kernels = r.trace.kernels(KERNEL)
    if not calls or len(kernels) != len(calls):
        return None
    cfg = r.cell.config
    win, hop, f = cfg["stft_window"], cfg["stft_hop"], cfg["freq_bins"]
    least = sum(flops.roofline_seconds(*flops.framed_matmul_cost(b, t, win, hop, 2 * f))
                for b, t in calls)
    return 100.0 * least / sum(t1 - t0 for _, t0, t1 in kernels)
