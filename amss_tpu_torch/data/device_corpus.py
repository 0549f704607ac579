"""A corpus resident on the card (``amss_tpu/data/device_corpus.py``): every
speaker shard uploaded once, so that a training step's batch is a plan of
(speaker, start, gain) of a few hundred bytes, gathered on the device.

A training-scale corpus is small next to the card's memory: 100 speakers x
120 s at 8 kHz is 192 MB as int16.  Each shard is quantized to int16
(``round``, clipped to ±32767) and tiled (``np.resize``) to one row of
``max(longest shard, chunk) + chunk`` samples, so a start anywhere in a shard
reads a whole chunk inside its row, wrapping as the host fill does
(``data/native.py``).  The rows go up as one flat int16 tensor.  Unlike the
JAX package, the upload is one copy: its 64 MB slabs were a limit of the
TPU's transport, and a failed upload here raises.

``gather`` dequantizes the unscaled waveform and then scales it by the gain,
where the host path's int16 wire format truncates ``gain · chunk``
(``train/engine.py``), so the two differ by up to one LSB times the gain: a
property of the JAX package, which does the same.
"""

from __future__ import annotations

import numpy as np
import torch

from amss_tpu_torch.utils.device import resolve_device


class DeviceCorpus:
    """All speaker shards of ``store`` as one int16 tensor ``flat``
    ``[n_speakers · row]`` on ``device`` (``cuda`` unless named)."""

    def __init__(self, store, chunk_samples: int, device=None):
        self.device = resolve_device(device)
        lens = [store.n_samples(s) for s in store.speakers]
        # every shard tiled up to max(shard lens, chunk), so any start in
        # [0, len) gives a whole chunk inside its row
        self.row = int(max(max(lens), chunk_samples) + chunk_samples)
        self.chunk = int(chunk_samples)
        arr = np.empty((len(store.speakers), self.row), np.int16)
        for i, s in enumerate(store.speakers):
            w = np.asarray(store.waveform(s), np.float32)
            q = np.clip(np.round(w * 32767.0), -32767, 32767).astype(np.int16)
            arr[i] = np.resize(q, self.row)  # tile = wrap semantics
        self.flat = torch.from_numpy(arr.reshape(-1)).to(self.device)

    @property
    def nbytes(self) -> int:
        """Bytes resident on the device."""
        return self.flat.numel() * self.flat.element_size()

    def gather(self, speaker_ids: torch.Tensor, starts: torch.Tensor,
               gains: torch.Tensor) -> torch.Tensor:
        """speaker_ids and starts ``[B, S]`` (integers), gains ``[B, S]``
        float32, all on the corpus's device -> sources ``[B, S, T]`` float32,
        dequantized and gain-scaled.  Reads nothing on the host."""
        b, s = speaker_ids.shape
        off = (speaker_ids.reshape(-1).to(torch.int64) * self.row
               + starts.reshape(-1).to(torch.int64))
        idx = off[:, None] + torch.arange(self.chunk, device=off.device)
        out = self.flat[idx].to(torch.float32) * (1.0 / 32767.0)
        return out.reshape(b, s, self.chunk) * gains[..., None]
