"""serve.tfgridnet.attn.device_share: the device intervals of the port's
``tfgridnet.attn`` spans (TF-GridNet's full-band self-attention over the
frames of a row: the heads' 1x1 convs, PReLUs and LN4DCFs, the two products,
the projection and the residual) inside its ``serve.job`` spans, summed over
the traced window, as a share of the window (bm/port_spans.py).  None against
a port without the span."""

from bm import port_spans

READS = ("trace",)


def read(r):
    return port_spans.device_share(r, "serve.job", "tfgridnet.attn")
