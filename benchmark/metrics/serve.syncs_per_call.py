"""serve.syncs_per_call: the port's host syncs in the traced window (its
``sync.*`` and ``serve.copy_out`` spans inside ``serve.job``) over its
``serve.batch`` spans, the batch calls of the model (bm/port_spans.py)."""

from bm import port_spans

READS = ("trace",)


def read(r):
    ps = port_spans.read(r)
    if ps is None:
        return None
    calls = ps.under("serve.job", "serve.batch")
    if not calls:
        return None
    jobs = ps.roots("serve.job")
    syncs = [x for x in ps.records if x.root in jobs
             and (x.name.startswith("sync.") or x.name == "serve.copy_out")]
    return len(syncs) / len(calls)
