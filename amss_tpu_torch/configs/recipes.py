"""Recipes of the ported paths, copies of ``amss_tpu/configs/recipes.py``:
c1, c5, c2_pretrain, c2, c3 (L41) and c4 (Chimera, three speakers) (STFT
256/64 or the adaptive front of 256 filters of 256 taps, stride 64, pool 2;
a 2×300 BLSTM with E = 20), c6 (TasNet: the adaptive front of 256 filters of
32 taps, stride 16, pool 1; a TCN of 3 repeats of 8 blocks, bottleneck 128,
expansion 2) and c7 (c6's front and a causal TCN of 2 repeats of 8 blocks
after the cumulative norm, served in chunks by ``infer/realtime.py``), and
enh (a 1×128 BLSTM refining the frozen separator of ``base_run``, STFT
256/64).  Two speakers unless named, batch 8 of 16384 samples.  Keyword
overrides go to ``TrainConfig``."""

from __future__ import annotations

import dataclasses

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


def c3_l41(n_train_speakers: int, **over) -> RecipeConfig:
    """Config 3: L41, BLSTM embeddings against a learned centroid per
    training speaker; enrolled speakers are masked without clustering."""
    return RecipeConfig(
        name="c3_l41",
        model=ModelConfig(kind="l41", front=_STFT, sep=_SEP, nb_speakers=2,
                          n_train_speakers=n_train_speakers),
        train=TrainConfig(**{"batch_size": 8, "chunk_samples": 16384, **over}),
    )


def c4_chimera_3mix(**over) -> RecipeConfig:
    """Config 4: Chimera, deep-clustering and mask-inference heads on one
    BLSTM, three speakers."""
    return RecipeConfig(
        name="c4_chimera_3mix",
        model=ModelConfig(kind="chimera", front=_STFT, sep=_SEP, nb_speakers=3,
                          chimera_alpha=0.5),
        train=TrainConfig(**{"batch_size": 8, "chunk_samples": 16384, **over}),
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


def c7_realtime(**over) -> RecipeConfig:
    """Causal low-latency TasNet: a causal TCN after the cumulative norm,
    separable in fixed-size chunks with the offline result
    (``infer/realtime.py``); algorithmic latency chunk + (filter_len - stride)
    samples."""
    return RecipeConfig(
        name="c7_realtime",
        model=ModelConfig(
            kind="tasnet",
            front=FrontConfig(kind="adapt", n_filters=256, filter_len=32, stride=16, pool=1),
            sep=SeparatorConfig(hidden=128, embed_dim=20, trunk="tcn", blocks=8, repeats=2,
                                causal=True, feature_norm="cumulative"),
            nb_speakers=2,
        ),
        train=TrainConfig(**{"batch_size": 8, "chunk_samples": 16384, "lr": 1e-3, **over}),
    )


def enh_dpcl(base_run: str | None = None, **over) -> RecipeConfig:
    """The enhancement stage: a one-layer BLSTM of 128 that refines the
    frozen separator of ``base_run`` (clustering bases: a TasNet base
    regresses, and ``EnhancerModel`` warns)."""
    return RecipeConfig(
        name="enh_dpcl",
        model=ModelConfig(kind="enhance", front=_STFT,
                          sep=SeparatorConfig(hidden=128, layers=1, embed_dim=20),
                          nb_speakers=2),
        train=TrainConfig(**{"batch_size": 8, "chunk_samples": 16384, "lr": 3e-4, **over}),
        base_run=base_run,
    )


def c6_dual_path(trunk: str, **over) -> RecipeConfig:
    """c6 with a dual-path trunk, at the widths the JAX package's experiment
    scripts trained it: ``dprnn`` as ``tasnet_h128b6_12k``
    (``scripts/r2b_wave.py:118-123``: width 128, 6 blocks) and ``dpt`` as
    ``dpt_probe`` (``scripts/r3_wave.py:480-481``: width 192, 6 blocks, 4
    heads, feed-forward 4 x 192, dropout 0.1); both in chunks of 32 frames.
    The run names and training settings are c6's; keyword overrides go to
    ``TrainConfig``."""
    sep = {"dprnn": dict(trunk="dprnn", blocks=6),
           "dpt": dict(trunk="dpt", hidden=192, blocks=6, chunk_frames=32, heads=4,
                       expansion=4, dropout=0.1)}[trunk]
    r = c6_tasnet(**over)
    return dataclasses.replace(r, model=dataclasses.replace(
        r.model, sep=dataclasses.replace(r.model.sep, **sep)))


def sepformer(**over) -> RecipeConfig:
    """SepFormer at its published widths (``models/sepformer.py``; SpeechBrain's
    ``recipes/WSJ0Mix/separation/hparams/sepformer.yaml``): the conv front of
    256 filters of 16 taps at stride 8, chunks of 250 frames at hop 125, 2
    repeats of an intra and an inter stack of 8 pre-LN layers of width 256, 8
    heads and a feed-forward of 1024, two speakers; trained as released, batch
    1, Adam at 1.5e-4, clip 5, here on chunks of 4 s.  It is no recipe of the
    JAX package, so not in ``ALL_RECIPES``.  Keyword overrides go to
    ``TrainConfig``."""
    return RecipeConfig(
        name="sepformer",
        model=ModelConfig(
            kind="sepformer",
            front=FrontConfig(kind="conv", n_filters=256, filter_len=16, stride=8, pool=1),
            sep=SeparatorConfig(hidden=256, trunk="sepformer", chunk_frames=250, heads=8,
                                blocks=8, repeats=2, expansion=4, dropout=0.0),
            nb_speakers=2,
        ),
        train=TrainConfig(**{"batch_size": 1, "chunk_samples": 32000, "lr": 1.5e-4,
                             "grad_clip": 5.0, **over}),
    )


def dprnn_tasnet(**over) -> RecipeConfig:
    """DPRNN-TasNet at its published widths (``models/sepformer.py``; Luo,
    Chen and Yoshioka, ICASSP 2020, arXiv:1910.06379, its best WSJ0-2mix
    configuration): the conv front of 64 filters of 2 taps at stride 1, a
    bottleneck of 64, chunks of 250 frames at hop 125, 6 blocks, each path a
    one-layer BLSTM of 128 cells a direction and a linear 256 -> 64, two
    speakers; trained as the paper, Adam at 1e-3, clip 5, on chunks of 4 s
    (the paper gives no batch: the port's default).  It is no recipe of the
    JAX package, so not in ``ALL_RECIPES``.  Keyword overrides go to
    ``TrainConfig``."""
    return RecipeConfig(
        name="dprnn_tasnet",
        model=ModelConfig(
            kind="dprnn_tasnet",
            front=FrontConfig(kind="conv", n_filters=64, filter_len=2, stride=1, pool=1),
            sep=SeparatorConfig(hidden=64, trunk="dprnn", chunk_frames=250, blocks=1, repeats=6,
                                expansion=2, dropout=0.0),
            nb_speakers=2,
        ),
        train=TrainConfig(**{"chunk_samples": 32000, "lr": 1e-3, "grad_clip": 5.0, **over}),
    )


def tfgridnet(**over) -> RecipeConfig:
    """TF-GridNet at ESPnet's published widths (``models/tfgridnet.py``;
    Wang et al., IEEE/ACM TASLP 2023, arXiv:2211.12433, and the defaults of
    ESPnet's ``TFGridNet``): the STFT of 128 at hop 64 (65 bins at 8 kHz),
    an embedding of 48 channels, unfolds of 4 at hop 1, 6 blocks, each path
    a one-layer BLSTM of 192 cells a direction, 4 heads of 8 query and key
    channels a bin (⌈512 / 65⌉), two speakers.  Its training settings (chunks
    of 4 s, batch 1, Adam at 1e-3, clip 5) are the port's choice; no cell
    trains it yet.  It is no recipe of the JAX package, so not in
    ``ALL_RECIPES``.  Keyword overrides go to ``TrainConfig``."""
    return RecipeConfig(
        name="tfgridnet",
        model=ModelConfig(
            kind="tfgridnet",
            front=FrontConfig(kind="stft", win=128, hop=64),
            sep=SeparatorConfig(hidden=192, layers=1, embed_dim=48, trunk="tfgridnet",
                                kernel=4, heads=4, expansion=8, blocks=6, remat=False,
                                dropout=0.0),
            nb_speakers=2,
        ),
        train=TrainConfig(**{"batch_size": 1, "chunk_samples": 32000, "lr": 1e-3,
                             "grad_clip": 5.0, **over}),
    )


# The CLI's recipe names, the JAX package's (``amss_tpu/configs/recipes.py``).
ALL_RECIPES = {
    "c1": c1_stft_dpcl,
    "c2_pretrain": c2_pretrain_adapt,
    "c2": c2_adapt_dpcl,
    "c3": c3_l41,
    "c4": c4_chimera_3mix,
    "c5": c5_streaming,
    "c6": c6_tasnet,
    "c7": c7_realtime,
    "enh": enh_dpcl,
}
