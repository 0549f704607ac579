"""serve.dprnn.intra.device_share: the device intervals of the port's
``dprnn.intra`` spans (DPRNN-TasNet's intra-chunk paths: the BLSTM over the
K frames of each chunk of a row's own, its linear, GroupNorm and residual)
inside its ``serve.job`` spans, summed over the traced window, as a share of
the window (bm/port_spans.py).  None against a port without the span."""

from bm import port_spans

READS = ("trace",)


def read(r):
    return port_spans.device_share(r, "serve.job", "dprnn.intra")
