"""The share of the traced window in which no operation (kernel, copy or
memset) ran on the card: one minus the union of their intervals over the
window."""

READS = ("trace",)


def read(r):
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
