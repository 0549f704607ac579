"""serve.tfgridnet.inter.device_share: the device intervals of the port's
``tfgridnet.inter`` spans (TF-GridNet's full-band temporal paths: LN4D, the
BLSTM over the unfolded frames of each bin of a row, its own frames' steps
alone, the transposed conv and the residual) inside its ``serve.job`` spans,
summed over the traced window, as a share of the window (bm/port_spans.py).
None against a port without the span."""

from bm import port_spans

READS = ("trace",)


def read(r):
    return port_spans.device_share(r, "serve.job", "tfgridnet.inter")
