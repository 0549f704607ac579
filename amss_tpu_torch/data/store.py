"""Speaker-keyed waveform store (``amss_tpu/data/store.py``): one float32
``<speaker>.npy`` per speaker, opened memory-mapped, and a ``manifest.json``.

A copy of the JAX package's ``SpeakerStore``, so that either package reads a
corpus the other wrote.  WAV ingestion is not ported yet.
"""

from __future__ import annotations

import json
import os

import numpy as np


class SpeakerStore:
    """Directory of ``<speaker>.npy`` waveforms + ``manifest.json``."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "manifest.json")) as f:
            self.manifest = json.load(f)
        self.sample_rate = self.manifest["sample_rate"]
        self.speakers = list(self.manifest["speakers"])
        self._cache: dict[str, np.ndarray] = {}

    @classmethod
    def create(cls, root: str, sample_rate: int) -> "SpeakerStore":
        os.makedirs(root, exist_ok=True)
        obj = object.__new__(cls)
        obj.root = root
        obj.manifest = {"sample_rate": sample_rate, "speakers": {}}
        obj.sample_rate = sample_rate
        obj.speakers = []
        obj._cache = {}
        return obj

    def add_speaker(self, speaker_id: str, wave: np.ndarray, normalize: bool = True):
        wave = np.asarray(wave, np.float32)
        if normalize:
            peak = np.abs(wave).max()
            if peak > 0:
                wave = 0.5 * wave / peak
        np.save(os.path.join(self.root, f"{speaker_id}.npy"), wave)
        self.manifest["speakers"][speaker_id] = {"n_samples": int(wave.shape[0])}
        if speaker_id not in self.speakers:
            self.speakers.append(speaker_id)

    def finalize(self):
        with open(os.path.join(self.root, "manifest.json"), "w") as f:
            json.dump(self.manifest, f, indent=1)

    def waveform(self, speaker_id: str) -> np.ndarray:
        if speaker_id not in self._cache:
            self._cache[speaker_id] = np.load(
                os.path.join(self.root, f"{speaker_id}.npy"), mmap_mode="r"
            )
        return self._cache[speaker_id]

    def n_samples(self, speaker_id: str) -> int:
        return self.manifest["speakers"][speaker_id]["n_samples"]
