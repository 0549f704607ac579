"""train.idle_share.backward: the share of the traced window in which the card
was idle while the host was inside the port's ``train.backward`` span (or a
span within it), the port's spans put on the trace's clock through the
harness's ``step`` spans (bm/port_spans.py)."""

from bm import port_spans

READS = ("trace",)


def read(r):
    return port_spans.idle_share(r, lambda names: "train.backward" in names)
