"""serve.blstm.kernel_share: the share of the port's ``trunk`` spans inside
its ``serve.job`` spans, over those that carry ``blstm_path`` (the BLSTM's
path of the call, ``amss_tpu_torch/models/blstm.py``), whose path is
``kernel``: the calls whose recurrence ran on the hand-written kernel, one
launch a layer, with no host lengths (bm/port_spans.py).  None where no
``trunk`` span carries the attribute, as against a port without it."""

from bm import port_spans

READS = ("trace",)


def read(r):
    ps = port_spans.read(r)
    if ps is None:
        return None
    paths = [x.attrs["blstm_path"] for x in ps.under("serve.job", "trunk")
             if "blstm_path" in x.attrs]
    if not paths:
        return None
    return 100.0 * sum(p == "kernel" for p in paths) / len(paths)
