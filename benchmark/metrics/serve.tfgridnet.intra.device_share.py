"""serve.tfgridnet.intra.device_share: the device intervals of the port's
``tfgridnet.intra`` spans (TF-GridNet's sub-band paths: LN4D, the BLSTM over
the unfolded bins of each of a row's own frames, the transposed conv and the
residual) inside its ``serve.job`` spans, summed over the traced window, as a
share of the window (bm/port_spans.py).  None against a port without the
span."""

from bm import port_spans

READS = ("trace",)


def read(r):
    return port_spans.device_share(r, "serve.job", "tfgridnet.intra")
