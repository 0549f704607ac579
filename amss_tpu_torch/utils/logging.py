"""Metric writer (``amss_tpu/utils/logging.py``): scalars as JSON lines in
``metrics.jsonl`` (keys such as ``train/dpcl_loss``, ``train/steps_per_sec``,
``valid/loss``), mirrored to TensorBoard when it imports, and images as
TensorBoard images or ``.npy`` files.  Writes happen on the host, between
steps."""

from __future__ import annotations

import json
import os
import time

import numpy as np


class MetricWriter:
    def __init__(self, directory: str):
        # nothing touches the disk until the first write
        self.dir = directory
        self._f = None
        self._tb = None
        self._opened = False

    def _open(self):
        if self._opened:
            return
        self._opened = True
        os.makedirs(self.dir, exist_ok=True)
        self._f = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        try:  # optional mirror
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(os.path.join(self.dir, "tb"))
        except Exception:
            pass

    def scalars(self, step: int, values: dict[str, float]):
        self._open()
        rec = {"step": step, "time": time.time(), **values}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, v, step)

    def image(self, step: int, tag: str, img):
        """A [H, W] heatmap or a [3, H, W] image; a ``.npy`` file when no
        TensorBoard writer exists."""
        arr = np.asarray(img, dtype=np.float32)
        self._open()
        if self._tb is not None:
            if arr.ndim == 2:  # min-max normalise a heatmap to [0, 1]
                lo, hi = float(arr.min()), float(arr.max())
                arr = ((arr - lo) / max(hi - lo, 1e-9))[None]
            self._tb.add_image(tag, arr, step)
        else:
            d = os.path.join(self.dir, "images")
            os.makedirs(d, exist_ok=True)
            np.save(os.path.join(d, f"{tag.replace('/', '_')}_{step}.npy"), arr)

    def flush(self):
        if self._f is not None:
            self._f.flush()
        if self._tb is not None:
            self._tb.flush()
