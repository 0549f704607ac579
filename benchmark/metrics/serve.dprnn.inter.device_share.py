"""serve.dprnn.inter.device_share: the device intervals of the port's
``dprnn.inter`` spans (DPRNN-TasNet's inter-chunk paths: the BLSTM over each
row's own chunks at every frame of a chunk, its linear, GroupNorm, residual
and chunk mask) inside its ``serve.job`` spans, summed over the traced
window, as a share of the window (bm/port_spans.py).  None against a port
without the span."""

from bm import port_spans

READS = ("trace",)


def read(r):
    return port_spans.device_share(r, "serve.job", "dprnn.inter")
