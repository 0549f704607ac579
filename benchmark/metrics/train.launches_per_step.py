"""train.launches_per_step: the kernels the trace records in the window
over the training steps run in it (a count; copies and memsets are not
kernels)."""

READS = ("counters", "trace")


def read(r):
    steps = r.counters.get("steps")
    if not steps:
        return None
    return len(r.trace.kernels()) / steps
