"""On-the-fly S-speaker mixing with speaker-disjoint splits
(``amss_tpu/data/mixer.py``).

The host only gathers per-speaker source chunks; the mixture is summed on the
device inside the train step.  Batch ``step`` of a split is a pure function of
(seed, split, step, host), drawn through ``np.random.SeedSequence([seed,
split, step, host])``, so a run resumes exactly by replaying its step counter
and the port draws the same batches as the JAX package.  The chunks are
gathered and gain-scaled by the native fill (``data/native.py``), bit for bit
the numpy loop and the JAX package's fill.  A device-resident corpus
(``data/device_corpus.py``) takes the ``plan`` alone.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from amss_tpu_torch.data.native import batch_fill
from amss_tpu_torch.data.store import SpeakerStore

_SPLITS = ("train", "valid", "test")


@dataclass
class Batch:
    """Host-side batch; ``sources`` is summed on the device into the mixture."""

    sources: np.ndarray  # [B, S, T] float32
    speaker_ids: np.ndarray  # [B, S] int32 global speaker indices
    gains: np.ndarray  # [B, S] float32 linear gains, already applied


@dataclass
class Plan:
    """Which chunks a batch takes, without the audio."""

    speaker_ids: np.ndarray  # [B, S] int32
    starts: np.ndarray  # [B, S] int32 chunk offsets into each shard
    gains: np.ndarray  # [B, S] float32


class Mixer:
    """Sample S distinct same-split speakers, random chunks, random gains."""

    def __init__(
        self,
        store: SpeakerStore,
        nb_speakers: int = 2,
        chunk_samples: int = 32000,
        split_fractions: tuple[float, float, float] = (0.7, 0.15, 0.15),
        gain_db_range: tuple[float, float] = (-2.5, 2.5),
        seed: int = 0,
    ):
        self.store = store
        self.s = nb_speakers
        self.t = chunk_samples
        self.gain_db = gain_db_range
        self.seed = seed

        # speaker-disjoint splits: partition the shuffled global speaker list
        spk = list(store.speakers)
        rng = np.random.default_rng(seed)
        rng.shuffle(spk)
        n = len(spk)
        n_tr = max(int(n * split_fractions[0]), nb_speakers)
        n_va = max(int(n * split_fractions[1]), nb_speakers)
        if n_tr + n_va + nb_speakers > n:  # shrink train to keep splits disjoint
            n_tr = n - n_va - nb_speakers
        if n_tr < nb_speakers:
            raise ValueError(f"{n} speakers cannot give disjoint splits with S={nb_speakers}")
        self.split_speakers = {
            "train": spk[:n_tr],
            "valid": spk[n_tr : n_tr + n_va],
            "test": spk[n_tr + n_va :],
        }
        self.global_index = {s: i for i, s in enumerate(store.speakers)}

    def n_train_speakers(self) -> int:
        return len(self.split_speakers["train"])

    def batch(self, split: str, step: int, batch_size: int, host: int = 0) -> Batch:
        """Deterministic batch: a pure function of (seed, split, step, host)."""
        plan = self.plan(split, step, batch_size, host=host)
        # the shards of the speakers drawn (a lazy store synthesises no other)
        used, local = np.unique(plan.speaker_ids.ravel(), return_inverse=True)
        shards = [np.ascontiguousarray(self.store.waveform(self.store.speakers[i]), np.float32)
                  for i in used.tolist()]
        flat = np.empty((batch_size * self.s, self.t), np.float32)
        batch_fill(flat, shards, local, plan.starts.ravel(), plan.gains.ravel())
        return Batch(sources=flat.reshape(batch_size, self.s, self.t),
                     speaker_ids=plan.speaker_ids, gains=plan.gains)

    def plan(self, split: str, step: int, batch_size: int, host: int = 0) -> Plan:
        """The chunk selection alone, drawn in the order ``batch`` uses."""
        if split not in _SPLITS:
            raise ValueError(f"split must be one of {_SPLITS}, got {split!r}")
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, _SPLITS.index(split), step, host])
        )
        speakers = self.split_speakers[split]
        ids = np.empty((batch_size, self.s), np.int32)
        starts = np.empty((batch_size, self.s), np.int32)
        lo, hi = self.gain_db
        gains_db = rng.uniform(lo, hi, size=(batch_size, self.s))
        gains = (10.0 ** (gains_db / 20.0)).astype(np.float32)
        for b in range(batch_size):
            chosen = rng.choice(len(speakers), size=self.s, replace=False)
            for j, c in enumerate(chosen):
                spk = speakers[c]
                ids[b, j] = self.global_index[spk]
                n = self.store.n_samples(spk)
                starts[b, j] = rng.integers(0, max(n - self.t, 1))
        return Plan(speaker_ids=ids, starts=starts, gains=gains)
