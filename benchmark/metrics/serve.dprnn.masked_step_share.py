"""serve.dprnn.masked_step_share: the share of the recurrence's steps that
DPRNN-TasNet's paths ran in the traced window past their rows' own
segmentation (the bucket's padding): Σ(steps - valid_steps) / Σ steps over
the port's ``dprnn.intra`` and ``dprnn.inter`` spans inside ``serve.job``
(bm/port_spans.py).  None against a port without the spans."""

from bm import port_spans

READS = ("trace",)


def read(r):
    ps = port_spans.read(r)
    if ps is None:
        return None
    paths = ps.under("serve.job", "dprnn.intra") + ps.under("serve.job", "dprnn.inter")
    if not paths:
        return None
    steps = sum(x.attrs["steps"] for x in paths)
    return 100.0 * (steps - sum(x.attrs["valid_steps"] for x in paths)) / steps
