"""serve.sepformer.inter.device_share: the device intervals of the port's
``sepformer.inter`` spans (SepFormer's inter-chunk transformer stacks, with
their GroupNorm, residual and chunk mask) inside its ``serve.job`` spans,
summed over the traced window, as a share of the window
(bm/port_spans.py).  None against a port without the span."""

from bm import port_spans

READS = ("trace",)


def read(r):
    return port_spans.device_share(r, "serve.job", "sepformer.inter")
