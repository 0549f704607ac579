"""serve.sepformer.intra.device_share: the device intervals of the port's
``sepformer.intra`` spans (SepFormer's intra-chunk transformer stacks, with
their GroupNorm and residual) inside its ``serve.job`` spans, summed over the
traced window, as a share of the window (bm/port_spans.py).  None against a
port without the span."""

from bm import port_spans

READS = ("trace",)


def read(r):
    return port_spans.device_share(r, "serve.job", "sepformer.intra")
