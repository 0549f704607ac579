"""serve.idle_share.model: the share of the traced window in which the card
was idle while the host was inside one of the model's spans (``front``,
``trunk``, ``head``, ``cluster``, ``decode`` and those within them, such as
``sync.lengths``), the port's spans put on the trace's clock through the
harness's ``job`` spans (bm/port_spans.py)."""

from bm import port_spans

READS = ("trace",)


def read(r):
    return port_spans.idle_share(r, lambda names: bool(port_spans.MODEL.intersection(names)))
