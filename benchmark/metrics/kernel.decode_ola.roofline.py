"""kernel.decode_ola.roofline: B2's least time over its device time in the
traced window, as for B1: each batch's synthesis of S speakers' masked
spectra ``[rows·S, frames, 2F]`` through the ``[2F, win]`` basis into the
bucket's samples, one launch each."""

from bm import flops

READS = ("counters", "trace")
KERNEL = "decode_ola_kernel"


def read(r):
    calls = r.counters.get("calls") or []
    kernels = r.trace.kernels(KERNEL)
    if not calls or len(kernels) != len(calls):
        return None
    cfg = r.cell.config
    win, hop, f, s = cfg["stft_window"], cfg["stft_hop"], cfg["freq_bins"], cfg["speakers"]
    least = sum(flops.roofline_seconds(*flops.decode_ola_cost(
        b * s, flops.stft_frames(t, win, hop), 2 * f, win, t)) for b, t in calls)
    return 100.0 * least / sum(t1 - t0 for _, t0, t1 in kernels)
