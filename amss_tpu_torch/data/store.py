"""Speaker-keyed waveform store (``amss_tpu/data/store.py``): one float32
``<speaker>.npy`` per speaker, opened memory-mapped, and a ``manifest.json``.

A copy of the JAX package's ``SpeakerStore`` and its WAV ingest
(``_read_wav``, ``ingest_wav_tree``), so that either package reads a corpus
the other wrote or ingested.
"""

from __future__ import annotations

import json
import os
import wave as wave_mod

import numpy as np

from amss_tpu_torch.data.resample import resample_sinc


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


def _read_wav(path: str) -> tuple[np.ndarray, int]:
    """Minimal PCM WAV reader (16-bit / 32-bit int, mono or first channel).
    Float (IEEE format 3) WAVs raise ``ValueError``: the stdlib ``wave``
    module parses PCM only."""
    try:
        with wave_mod.open(path, "rb") as w:
            sr = w.getframerate()
            n = w.getnframes()
            ch = w.getnchannels()
            width = w.getsampwidth()
            raw = w.readframes(n)
    except wave_mod.Error as e:
        raise ValueError(
            f"{path}: unsupported WAV encoding ({e}); only integer PCM is "
            "supported — convert float WAVs to 16-bit PCM before ingest"
        ) from e
    if width == 2:
        # 32767 mirrors write_wav's scale: int16 round-trips bit-exactly.
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32767.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported WAV sample width {width} in {path}")
    if ch > 1:
        x = x.reshape(-1, ch)[:, 0]
    return x, sr


def ingest_wav_tree(
    wav_root: str, store_root: str, sample_rate: int | None = None
) -> SpeakerStore:
    """Build a SpeakerStore from ``wav_root/<speaker>/**.wav`` (a LibriSpeech
    or WSJ style tree).  A speaker's utterances concatenate into one shard,
    and the manifest records their boundaries.  Files at another rate than the
    store's are resampled (``data/resample.py``), so a 16 kHz tree ingests
    into an 8 kHz store.  ``sample_rate=None`` adopts the first file's rate.
    """
    speakers = sorted(
        d for d in os.listdir(wav_root) if os.path.isdir(os.path.join(wav_root, d))
    )
    if not speakers:
        raise ValueError(f"no speaker directories under {wav_root}")
    store = None
    for spk in speakers:
        waves, bounds, off = [], [], 0
        for dirpath, _, files in sorted(os.walk(os.path.join(wav_root, spk))):
            for fn in sorted(files):
                if not fn.lower().endswith(".wav"):
                    continue
                x, sr = _read_wav(os.path.join(dirpath, fn))
                if sample_rate is None:
                    sample_rate = sr
                if sr != sample_rate:
                    x = resample_sinc(x, sr, sample_rate)
                waves.append(x)
                bounds.append((off, off + len(x)))
                off += len(x)
        if not waves:
            continue
        if store is None:
            store = SpeakerStore.create(store_root, sample_rate=sample_rate)
        store.add_speaker(spk, np.concatenate(waves))
        store.manifest["speakers"][spk]["utterances"] = bounds
    if store is None:
        raise ValueError(f"no WAV files under {wav_root}")
    store.finalize()
    return store
