"""train.backward.device_share: the device intervals of the port's
``train.backward`` spans (timing events on the stream at the span's start and
end), summed over the traced window, as a share of the window
(bm/port_spans.py)."""

from bm import port_spans

READS = ("trace",)


def read(r):
    return port_spans.device_share(r, "train.step", "train.backward")
