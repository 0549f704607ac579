"""Typed dataclass configs, a copy of ``amss_tpu/utils/config.py``.

The fields and defaults are those of the JAX package, so a run dir's
``config.json`` written by either package rebuilds the same model here, and a
recipe gets the same run id (so the same run dir name) in both packages.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field


@dataclass(frozen=True)
class FrontConfig:
    kind: str = "stft"  # "stft" | "adapt" | "conv"
    win: int = 256
    hop: int = 64
    n_filters: int = 256
    filter_len: int = 256
    stride: int = 64
    pool: int = 2
    smooth_len: int = 4

    @property
    def feature_dim(self) -> int:
        return self.win // 2 + 1 if self.kind == "stft" else self.n_filters

    def frames_for(self, t: int) -> int:
        """Separator-rate frame count for a length-t signal."""
        if self.kind == "stft":
            return 1 + (t - self.win) // self.hop
        nf = 1 + (t - self.filter_len) // self.stride
        return nf // self.pool


@dataclass(frozen=True)
class SeparatorConfig:
    hidden: int = 300
    layers: int = 2
    embed_dim: int = 20
    compute_dtype: str = "float32"
    remat: bool = True
    trunk: str = "blstm"
    chunk_frames: int = 16
    heads: int = 4
    blocks: int = 6
    repeats: int = 2
    kernel: int = 3
    expansion: int = 2
    causal: bool = False
    dropout: float = 0.0
    feature_norm: str = "global"
    scan_unroll: int = 1


@dataclass(frozen=True)
class ModelConfig:
    kind: str = "dpcl"
    front: FrontConfig = field(default_factory=FrontConfig)
    sep: SeparatorConfig = field(default_factory=SeparatorConfig)
    nb_speakers: int = 2
    n_train_speakers: int = 0
    chimera_alpha: float = 0.5
    vad_threshold_db: float = 40.0
    weight_kind: str = "vad"
    loss_variant: str = "msa"
    recon_weight: float = 0.0
    train_noise_snr_db: tuple | None = None
    train_reverb_rt60: tuple | None = None
    train_reverb_drr_db: tuple = (0.0, 10.0)
    train_min_speakers: int | None = None


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 8
    chunk_samples: int = 16384
    lr: float = 1e-3
    lr_schedule: str = "const"
    warmup_steps: int = 500
    grad_clip: float = 5.0
    steps: int = 1000
    valid_every: int = 100
    valid_steps: int = 4
    seed: int = 0
    data_axis: int = 1
    device_data: bool = False
    accum_steps: int = 1
    ema_decay: float = 0.0
    valid_quality: bool = False
    early_stop_patience: int = 0
    steps_per_call: int = 1


@dataclass(frozen=True)
class RecipeConfig:
    name: str = "recipe"
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    sample_rate: int = 8000
    pretrained_front: str | None = None
    freeze_front_steps: int = 0
    base_run: str | None = None


def recipe_from_dict(d: dict) -> RecipeConfig:
    """Rebuild a RecipeConfig from its asdict form (run-dir config.json).

    Keys missing from an older config take the dataclass defaults; an unknown
    key raises ``TypeError``, as in the JAX package."""
    d = dict(d)
    model = dict(d.pop("model"))
    front = FrontConfig(**model.pop("front"))
    sep = SeparatorConfig(**model.pop("sep"))
    return RecipeConfig(
        model=ModelConfig(front=front, sep=sep, **model),
        train=TrainConfig(**d.pop("train")),
        **d,
    )


def recipe_to_dict(cfg: RecipeConfig) -> dict:
    return dataclasses.asdict(cfg)


def run_id_from_stored(d: dict) -> str:
    """The run id of a config dict in its stored (run-dir config.json) form.

    Hashing the dict as stored keeps an existing run dir's id across later
    growth of the config.  Fields added after a release are left out of the
    hash while they cannot change the model or the trajectory, so fresh
    configs keep the ids they had before those fields existed."""
    d = json.loads(json.dumps(d))  # deep copy, JSON-normalised
    sep = d.get("model", {}).get("sep", {})
    if sep.get("trunk") not in ("dpt", "sepformer", "tfgridnet"):
        sep.pop("heads", None)
    tr = d.get("train", {})
    if tr.get("accum_steps", 1) == 1:
        tr.pop("accum_steps", None)
    if not tr.get("ema_decay", 0.0):
        tr.pop("ema_decay", None)
    if not tr.get("valid_quality", False):
        tr.pop("valid_quality", None)
    if not tr.get("early_stop_patience", 0):
        tr.pop("early_stop_patience", None)
    # an execution-shape knob: the same per-step math at any value
    tr.pop("steps_per_call", None)
    if sep.get("scan_unroll", 1) == 1:
        sep.pop("scan_unroll", None)
    mdl = d.get("model", {})
    if not mdl.get("train_noise_snr_db"):
        mdl.pop("train_noise_snr_db", None)
    if not mdl.get("train_reverb_rt60"):
        mdl.pop("train_reverb_rt60", None)
        mdl.pop("train_reverb_drr_db", None)
    if not mdl.get("train_min_speakers"):
        mdl.pop("train_min_speakers", None)
    blob = json.dumps(d, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


def run_id(cfg: RecipeConfig) -> str:
    """Deterministic 12-hex id of the full config: the run dir's name."""
    return run_id_from_stored(recipe_to_dict(cfg))
