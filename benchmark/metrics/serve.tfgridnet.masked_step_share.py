"""serve.tfgridnet.masked_step_share: the share of the recurrence's steps
that TF-GridNet's paths ran in the traced window past their rows' own frames
(the bucket's padding): Σ(steps - valid_steps) / Σ steps over the port's
``tfgridnet.intra`` and ``tfgridnet.inter`` spans inside ``serve.job``
(bm/port_spans.py).  None against a port without the spans."""

from bm import port_spans

READS = ("trace",)


def read(r):
    ps = port_spans.read(r)
    if ps is None:
        return None
    paths = ps.under("serve.job", "tfgridnet.intra") + ps.under("serve.job", "tfgridnet.inter")
    if not paths:
        return None
    steps = sum(x.attrs["steps"] for x in paths)
    return 100.0 * (steps - sum(x.attrs["valid_steps"] for x in paths)) / steps
