"""serve.dprnn.kernel_share: the share of the device intervals of the port's
``dprnn.intra`` and ``dprnn.inter`` spans inside its ``serve.job`` spans
spent in those whose ``blstm_path`` (the BLSTM's path of the call,
``amss_tpu_torch/models/blstm.py``) is ``kernel``: which side of the row
rule DPRNN-TasNet's recurrence sits on (bm/port_spans.py).  None where no
such span was timed, as against a port without them or off the card."""

from bm import port_spans

READS = ("trace",)


def read(r):
    ps = port_spans.read(r)
    if ps is None:
        return None
    timed = [x for name in ("dprnn.intra", "dprnn.inter") for x in ps.under("serve.job", name)
             if x.device_ms is not None]
    total = sum(x.device_ms for x in timed)
    if not total:
        return None
    return 100.0 * sum(x.device_ms for x in timed if x.attrs["blstm_path"] == "kernel") / total
