"""Recipes of the ported paths, copies of ``amss_tpu/configs/recipes.py``:
STFT 256/64 and a 2×300 BLSTM with E = 20, two speakers, batch 8 of 16384
samples.  Keyword overrides go to ``TrainConfig``."""

from __future__ import annotations

from amss_tpu_torch.utils.config import (
    FrontConfig,
    ModelConfig,
    RecipeConfig,
    SeparatorConfig,
    TrainConfig,
)

_STFT = FrontConfig(kind="stft", win=256, hop=64)
_SEP = SeparatorConfig(hidden=300, layers=2, embed_dim=20)


def c1_stft_dpcl(**over) -> RecipeConfig:
    """Config 1: STFT + BLSTM deep clustering, 2 speakers."""
    return RecipeConfig(
        name="c1_stft_dpcl",
        model=ModelConfig(kind="dpcl", front=_STFT, sep=_SEP, nb_speakers=2),
        train=TrainConfig(**{"batch_size": 8, "chunk_samples": 16384, **over}),
    )


def c5_streaming(**over) -> RecipeConfig:
    """Config 5: the model of the bucketed serving path (trains as c1)."""
    return RecipeConfig(
        name="c5_streaming",
        model=ModelConfig(kind="dpcl", front=_STFT, sep=_SEP, nb_speakers=2),
        train=TrainConfig(**{"batch_size": 8, "chunk_samples": 16384, **over}),
    )
