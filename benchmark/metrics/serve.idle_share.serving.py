"""serve.idle_share.serving: the share of the traced window in which the
card was idle while the host was inside the port's ``serve.job`` but outside
every model span (packing, the copies out, between the batch calls), the
port's spans put on the trace's clock through the harness's ``job`` spans
(bm/port_spans.py).  With ``serve.idle_share.model`` and the idle time under
no port span it sums to ``device.idle_share.serve``."""

from bm import port_spans

READS = ("trace",)


def read(r):
    return port_spans.idle_share(
        r, lambda names: names[:1] == ("serve.job",) and not port_spans.MODEL.intersection(names))
