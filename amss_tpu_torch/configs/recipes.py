"""Recipes of the ported paths, copies of ``amss_tpu/configs/recipes.py``:
c1, c5, c2_pretrain and c2 (STFT 256/64 or the adaptive front of 256 filters
of 256 taps, stride 64, pool 2; a 2×300 BLSTM with E = 20), and c6 (TasNet:
the adaptive front of 256 filters of 32 taps, stride 16, pool 1; a TCN of 3
repeats of 8 blocks, bottleneck 128, expansion 2).  Two speakers, batch 8 of
16384 samples.  Keyword overrides go to ``TrainConfig``."""

from __future__ import annotations

from amss_tpu_torch.utils.config import (
    FrontConfig,
    ModelConfig,
    RecipeConfig,
    SeparatorConfig,
    TrainConfig,
)

_STFT = FrontConfig(kind="stft", win=256, hop=64)
_ADAPT = FrontConfig(kind="adapt", n_filters=256, filter_len=256, stride=64, pool=2)
_SEP = SeparatorConfig(hidden=300, layers=2, embed_dim=20)


def c1_stft_dpcl(**over) -> RecipeConfig:
    """Config 1: STFT + BLSTM deep clustering, 2 speakers."""
    return RecipeConfig(
        name="c1_stft_dpcl",
        model=ModelConfig(kind="dpcl", front=_STFT, sep=_SEP, nb_speakers=2),
        train=TrainConfig(**{"batch_size": 8, "chunk_samples": 16384, **over}),
    )


def c2_pretrain_adapt(**over) -> RecipeConfig:
    """Config 2's prerequisite: autoencoder pretraining of the adaptive
    filterbank on clean speech."""
    return RecipeConfig(
        name="c2_pretrain_adapt",
        model=ModelConfig(kind="adapt_ae", front=_ADAPT, sep=_SEP, nb_speakers=2),
        train=TrainConfig(**{"batch_size": 8, "chunk_samples": 16384, "lr": 1e-3, **over}),
    )


def c2_adapt_dpcl(pretrained_front: str | None = None, **over) -> RecipeConfig:
    """Config 2: the adaptive front + deep clustering, fine-tuned end to end
    from a pretrained front, which stays frozen for the first 200 steps."""
    return RecipeConfig(
        name="c2_adapt_dpcl",
        model=ModelConfig(
            kind="dpcl", front=_ADAPT, sep=_SEP, nb_speakers=2, recon_weight=0.2
        ),
        train=TrainConfig(**{"batch_size": 8, "chunk_samples": 16384, "lr": 3e-4, **over}),
        pretrained_front=pretrained_front,
        freeze_front_steps=200 if pretrained_front else 0,
    )


def c5_streaming(**over) -> RecipeConfig:
    """Config 5: the model of the bucketed serving path (trains as c1)."""
    return RecipeConfig(
        name="c5_streaming",
        model=ModelConfig(kind="dpcl", front=_STFT, sep=_SEP, nb_speakers=2),
        train=TrainConfig(**{"batch_size": 8, "chunk_samples": 16384, **over}),
    )


def c6_tasnet(**over) -> RecipeConfig:
    """Config 6: TasNet, a short-filter adaptive front, the TCN trunk and
    sigmoid masks, trained end to end on waveform PIT SI-SDR."""
    return RecipeConfig(
        name="c6_tasnet",
        model=ModelConfig(
            kind="tasnet",
            front=FrontConfig(kind="adapt", n_filters=256, filter_len=32, stride=16, pool=1),
            sep=SeparatorConfig(hidden=128, layers=2, embed_dim=20, trunk="tcn", blocks=8,
                                repeats=3, chunk_frames=32, dropout=0.0),
            nb_speakers=2,
        ),
        train=TrainConfig(**{"batch_size": 8, "chunk_samples": 16384, "lr": 1e-3,
                             "lr_schedule": "cosine", **over}),
    )
