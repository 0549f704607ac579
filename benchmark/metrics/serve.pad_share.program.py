"""serve.pad_share.program: the share of the samples of the batch calls in
the traced window that are padding, from the port's ``serve.batch`` spans:
one minus their ``audio_samples`` over their ``rows`` x ``samples``
(bm/port_spans.py).  ``serve.pad_share`` counts the same at the harness's
model boundary."""

from bm import port_spans

READS = ("trace",)


def read(r):
    ps = port_spans.read(r)
    if ps is None:
        return None
    calls = ps.under("serve.job", "serve.batch")
    if not calls:
        return None
    batch = sum(x.attrs["rows"] * x.attrs["samples"] for x in calls)
    return 100.0 * (batch - sum(x.attrs["audio_samples"] for x in calls)) / batch
