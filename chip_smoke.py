#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (amss_tpu_torch) through its main path on one card.

    python3 chip_smoke.py

Phases, each printing its wall seconds:

0. environment: torch, the card's name and power limit, nvcc;
1. build: compile the CUDA kernels from ``amss_tpu_torch/csrc`` with nvcc, and
   read each kernel's registers and spills (ptxas) and its tensor-core
   instructions (``cuobjdump -sass``);
2. kernels: each kernel against its plain PyTorch version on the card, at the
   main path's shapes, at long-form's tail-group shapes and at edge shapes
   (ragged frame counts, K not a multiple of 8, trimmed lengths), and timed beside its plain version, one
   PyTorch library call computing the same function, and its two bounds;
2c. k-means: the fit and the soft masks of ``csrc/kmeans.cu`` against the
   plain version (``ops/kmeans.py``) on the card at the serving cell's shape
   ([8, 765·129, 40], K 2) and at K 3 / E 20, the last 2.3% of each row's
   points at weight 0, well-separated blobs, and the first shape again at
   unit norm, as deep clustering's embeddings are, where the first seed's
   score ties on every point (``tools/kmeans_check.py``, which the card tests
   share): the first seed bit for bit the plain version's, centroids within
   KMEANS_TOL of their norm, masks within KMEANS_TOL, assignments equal off
   near ties, two runs bit-identical; the blobs timed beside the plain
   version and its bound (one read of the embeddings a pass at 3.35 TB/s);
   then k-means at the main path's size under CUDA's sync debug mode "error";
2d. the BLSTM's recurrence kernel (``csrc/blstm.cu``, the live gradient-free
   float32 path) against its plain version (``BLSTM.loop``) and cuDNN's
   packed path on the card at deep clustering's serving shape ([8, 765, 129]
   -> 2 x 300, two layers, the last 18 frames of each row masked), within
   BLSTM_TOL of the output's largest magnitude, two runs bit-identical, and
   ms a layer of each (eager calls between CUDA events: the kernel with its
   GEMM, the loop, cuDNN with the host's packing) beside the kernel's FLOP
   over 67 TFLOP/s;
2e. the row-parallel BLSTM kernel (``csrc/blstm_rows.cu``, the live
   gradient-free float32 path past ``MAX_ROWS`` rows) against its plain
   version (``BLSTM.loop``) and cuDNN's packed path at DPRNN-TasNet's cell
   shapes (intra [3088, 250, 64] unmasked, inter [2000, 396, 64] with the
   cell's mask, 386 chunks valid) -> 2 x 128, within BLSTM_TOL of the
   output's largest magnitude, two runs bit-identical, one launch a layer on
   its own counter, and ms a layer of each (eager calls between CUDA events:
   the kernel with its GEMM, the GEMM alone, cuDNN with host lengths, the
   plain loop) beside the layer's bound (3xTF32 and bytes, the projection
   included, valid steps only) and the recurrence's FLOP over 67 TFLOP/s;
2b. gradients: each kernel's autograd (its backward runs the other kernel)
   against torch autograd of its plain version on the card, at the training
   shape, the serving shape and edge shapes, with the backward launches
   counted, and the backward timed at the training shape;
3. main path, speed: c1 deep clustering on ``checkpoints/c1_dpcl`` served
   through ``StreamingSeparator.separate_all`` (64 utterances of 8 s, batches
   of 8, two passes), with every kernel's launch count checked (the BLSTM
   kernel's, a launch a layer a call, counted beside ``launch_counts`` as
   the k-means kernels' are, in every path served this way);
4. main path, quality: PIT SI-SDR improvement on 64 synthetic two-speaker
   mixtures, which must reach QUALITY_MIN_DB;
5. training: c1 at the recipe's full width (2x300 BLSTM, E = 20, batch 8 of
   16384 samples) through ``Trainer.fit`` for TRAIN_STEPS steps on a
   synthetic corpus written from seed 0.  The card's first step is held
   against the same step on the CPU; B1's launches are counted; one step runs
   with no host sync; the valid loss must fall; the last checkpoint must
   reload bit for bit and serve one batch;
6. the adaptive front's kernels: B1 and B2 with the learned bases of
   ``checkpoints/c2_adapt`` at c2's serving and training shapes, forward
   against the plain versions and gradients against their autograd, timed
   beside the library calls and the bounds;
7. c2 serving: ``checkpoints/c2_adapt`` through ``StreamingSeparator`` as in
   phase 3, and its quality on phase 4's protocol, which must reach
   C2_QUALITY_MIN_DB;
8. c2 training at full width: c2_pretrain (the filterbank autoencoder, 16
   waves of 16384 samples a step), then c2 fine-tuned from that run's front
   (2x300 BLSTM, E = 20), each for a cut number of steps, with phase 5's
   checks; the front must stay bit for bit the restored one through the
   freeze window and move after it;
9. long-form serving: c1 on a corpus of phase 3's utterances and two-speaker
   mixtures of 60 s and 90 s, which take ``separate_long`` in chunks of
   64000 samples, twice; launch counts, RTF, and the long mixtures' quality,
   which must reach LONG_QUALITY_MIN_DB;
10. c6's kernels: B1 and B2 forced with the learned bases of
   ``checkpoints/c6_flagship`` (16/8) and ``checkpoints/c6_3spk`` (32/16) at
   their serving shapes and at the c6 recipe's and the flagship's training
   shapes, forward against the plain versions and gradients against their
   autograd; at the serving shapes timed beside the plain versions, the
   library calls and the bounds, and the shape gate's decision printed;
11. c6 serving: ``checkpoints/c6_flagship`` (bf16 operands) through
   ``StreamingSeparator`` as in phase 3, its quality (S = 2, C6_QUALITY_MIN_DB)
   and ``checkpoints/c6_3spk``'s (S = 3, C6_3SPK_QUALITY_MIN_DB) on phase 4's
   protocol, and the flagship on the card against the port on the CPU;
   every path's launches equal what the gate says (0 where it is closed);
12. c6 training: the c6 recipe at full width (TCN of 3 x 8 blocks, batch 8
   of 16384, L32/16, float32, remat) for C6_STEPS steps with phase 5's
   checks, then one bf16 step of the flagship at its config's batch of 16 x
   16384 from the checkpoint's weights, loss and gradients against the CPU;
13. c7 realtime: ``checkpoints/c7_causal`` (causal TCN of 3 x 8 blocks at
   width 512, the cumulative norm) served offline through
   ``StreamingSeparator`` on phase 4's mixtures, then streamed through
   ``RealtimeSeparator`` in chunks of REALTIME_CHUNK (one stream, 16 ragged
   streams, pipelined, ``long_stream``), each against the offline output
   within C7_STREAM_TOL of its peak; ms per push and RTF at chunks of 4096
   and 1024 and 1 and 16 streams; one push queued with no host sync; B1 and
   B2 launched 0 times (the gate is closed at 32/16);
14. c7 quality and training: c7_causal's SI-SDRi on phase 4's protocol
   (C7_QUALITY_MIN_DB), then the c7 recipe at full width for C7_STEPS steps
   with phase 5's checks;
15. c3 (L41): ``checkpoints/c3_l41`` served blind through
   ``StreamingSeparator`` as in phase 3 (B1 and B2 counted), its blind
   quality on phase 4's protocol (C3_QUALITY_MIN_DB) and its enrolled
   quality (``separate(mix, speaker_ids=...)``, batches of 8) on its training
   speakers rebuilt from seeds (C3_ENROLLED_MIN_DB); then the c3 recipe at
   full width for C3_STEPS steps with phase 5's checks;
16. c4 (Chimera, S = 3): B2 at the three-speaker serving shape [24, 997,
   258] against its plain version and timed; the c4 recipe at full width
   (2x300 BLSTM, E = 20) for C4_STEPS steps with phase 5's checks, on a
   synthetic v1 corpus of C4_SPEAKERS x TRAIN_SECONDS s; the trained state
   served through ``StreamingSeparator`` as in phase 3 and on three-speaker
   mixtures (B1 and B2 counted), and on the card against the port on the CPU
   (C4_CARD_CPU_MIN_DB);
17. counting: ``checkpoints/c1_count`` counts COUNT_N mixtures of each of 1, 2
   and 3 speakers (the test split of the v2 corpus of 30 x 40 s from seed 0)
   on the card and on the CPU: the accuracy per k (COUNT_MIN_ACC), the
   confusion matrix, and the card's counts against the CPU's
   (COUNT_AGREE_MIN); then auto-k (``infer/count.py::separate_auto_k``) on
   AUTOK_N of each, the SI-SDRi of the correctly counted at k = 2 and 3
   (AUTOK_MIN_DB); B1 and B2 counted on both paths;
18. enhancement: the enh recipe over ``checkpoints/c1_dpcl`` at full width
   (1 x 128 BLSTM, batch 8 x 16384) for ENH_STEPS steps with phase 5's checks
   (its first step against the CPU's from one first pass), the base bit for
   bit frozen, the two stages at init near the base alone (ENH_INIT_MIN_DB),
   the trained state served on phase 4's protocol (QUALITY_MIN_DB) and on
   the card against the CPU; B1 3 and B2 2 launches a separate call;
19. the BLSTM stack's dropout on the card (cuDNN a layer at a time) against
   the loop with the same masks; c6 with the DPRNN trunk (width 128, 6
   blocks, K = 32) at full width for DP_STEPS steps with phase 5's checks, served on the card against the CPU
   with a padded utterance in its bucket, and the spans of one served call
   (``tools/stage_times.py``); B1 and B2 launch 0 times (the gate is closed
   at 32/16), and the served call launches the recurrence kernel once a
   layer where ``blstm_path`` gives ``kernel`` at the path's rows (all 12
   at 4 rows of 32 chunks);
20. c6 with the DPT trunk (width 192, 6 blocks, 4 heads, dropout 0.1) as
   phase 19, its first step against the CPU at rate 0 and its training at
   0.1;
21. c1_count trained from its own ``config.json`` (2x300 BLSTM, E = 20, S =
   3, ``train_min_speakers`` 1, batch 16 x 16384, ``valid_quality`` on) for
   COUNT_TRAIN_STEPS steps with phase 5's checks, its first step against the
   CPU's with one key (the drawn k agree by construction), on synthetic v2
   speakers written as 16-bit WAVs at 16 kHz and ingested into an 8 kHz store
   (``ingest_wav_tree``); the drawn k cover 1, 2 and 3, each at 1/3 ±
   COUNT_K_SHARE_TOL, and ``valid/si_sdri`` is logged at every validation;
22. the c6 recipe trained clean, with noise (5-20 dB) and with reverberation
   (RT60 800-3200 samples) for C6_CORRUPT_STEPS steps each: each apply on the
   card against the CPU's on the same draws (CORRUPT_TOL of the peak, TF32
   off), the realised SNR of each row its drawn one, the RIRs' direct tap,
   unit energy and DRR, one key giving the same mixture twice, one step with
   no host sync, and the valid loss falling;
23. evaluation: ``evaluate_separation(bss=True, per_utt=True,
   with_stoi=True)`` on phase 4's estimates, its SI-SDRi phase 4's own, SDRi
   and STOIi gated (EVAL_SDRI_MIN_DB, EVAL_STOI_I_MIN), the call's seconds
   printed;
24. the c1 artifact: ``checkpoints/c1_dpcl`` exported for cuda
   (``infer/export.py``, buckets 16384 and 64000, batch 8) and served from a
   fresh process that imports no model module: phase 3's utterances twice
   (RTF, utterances/s, B1 and B2 launched from the exported program as
   often as phase 3 launches them) and phase 4's mixtures (SI-SDRi ≥
   QUALITY_MIN_DB); the traced BLSTM's embeddings against the live one's,
   the kernel's (EMBED_TOL of the peak), the artifact's rows against phase
   4's live estimates in the best speaker order (a row under AGREE_MIN_DB
   whose embeddings agree is ROADMAP C.2's seeding tie), and live serving's
   RTF with the kernel and with the traced BLSTM in turns;
25. int8: c1 exported with int8 parameters, its program on the dequantized
   weights bit for bit the fp32 program's on them, its rows against the live
   model on the dequantized weights, its SI-SDRi and the bytes saved;
26. the realtime artifact: ``checkpoints/c7_causal`` exported at chunk
   REALTIME_CHUNK for 1 and RT_ART_STREAMS streams, streamed against
   offline (C7_STREAM_TOL of the peak; ragged streams against each alone),
   ms per push;
27. the server and the CLI: ``SeparationServer`` on 127.0.0.1 over the
   phase-24 and phase-26 artifacts, every answer equal to the direct
   artifact call, request latency; then make-synthetic, train
   (CLI_TRAIN_STEPS c1 steps at full width), evaluate, separate, export,
   separate-exported and profile through ``amss_tpu_torch.cli.main`` on the
   card, the profile's trace holding the card's kernels;
28. the native batch fill: ``csrc/amss_data.cc`` built with g++, bit for bit
   the numpy loop and ``Mixer.batch`` at c6_flagship's batch (16 x 2 x 16384)
   on phase 5's corpus, the host ms of each;
29. a corpus resident on the card at training scale (100 speakers x 120 s,
   192 MB as int16; cut to what DC_BUILD_BUDGET_S writes): the bytes
   resident, the upload's time, ``gather`` against ``Mixer.batch`` within one
   LSB times the gain on the first steps' plans, and a gather's device time;
30. ``checkpoints/c6_flagship/config.json`` through ``Trainer.fit`` with
   that corpus on the card (device data, bf16 TCN, batch 16 x 16384, EMA),
   cut to C6F_STEPS steps: the first step's loss on device data against host
   data on one plan, one step with no host sync, the valid loss falling, the
   checkpoint reloading, and ms a step of device against host data in turns;
31. c1 at full width in bf16 with device data: the first step card against
   CPU, C1_BF16_STEPS steps of fit launching B1 and B2 as often as float32 c1
   does, ms a step against float32; ``checkpoints/c1_dpcl`` served in bf16,
   its RTF beside phase 3's and its quality gated (C1_BF16_QUALITY_MIN_DB);
32. one bf16 step of c6 with the DPRNN trunk and of the enh refiner, card
   against CPU;
33. the time-sharded STFT (``parallel/timeshard.py``) at 256/64 on [2,
   8·64·1000] over a mesh of four entries of ``cuda:0``: equal to the
   unsharded STFT within SHARD_STFT_TOL, B1 launched once a shard;
34. long-form over a mesh of ``[cuda:0, cuda:0]``
   (``separate_long_sharded``, through ``StreamingSeparator(mesh=...)``):
   phase 9's mixtures, c1_dpcl's SI-SDRi gated as phase 9's, its launches
   and RTF beside phase 9's, every mask the BLSTM gets a prefix (ROADMAP
   C.5); c6_flagship against ``separate_long`` on the card at least
   MESH_C6_MIN_DB, and bit for bit where the slices have the groups' shapes;
35. data-parallel training: two ranks on ``cuda:0`` over gloo (NCCL refuses
   two ranks on one card) fit the c1 recipe at full width (global batch 8 x
   16384) for RANK_STEPS steps: parameters bit for bit equal across ranks,
   the first step equal to one process's on the ranks' rows within
   RANK_LOSS_TOL and RANK_GRAD_TOL, rank 0 alone writing checkpoints, ms a
   step beside one process's; then c1_count's config.json (dropped sources)
   for RANK_COUNT_STEPS steps with the same first-step check; then a
   one-rank NCCL group for RANK_NCCL_STEPS steps, so the NCCL path runs;
36. ``checkpoints/c1_dpcl`` in bf16 exported for cuda (one
   ``amss::blstm_bf16_layer`` operator a BLSTM layer) and served from a
   fresh process with no model module on phase 24's protocol: SI-SDRi gated
   as phase 31's, its output against live bf16 serving within
   BF16_ARTIFACT_TOL, B1 and B2 launched as often as phase 24's float32
   artifact, its RTF beside phase 31's;
37. the multi-tensor clip and Adam (``csrc/multi_adam.cu``) on the c6
   recipe's parameter list and on the benchmark's Conv-TasNet's
   (``benchmark/configs/convtasnet_luo2019.json``), each against the plain
   per-tensor version (bit-equal
   without the clip, and with it given the kernel's norm, which lies within
   MADAM_NORM_ULPS of the exact one) and a
   ``torch._foreach_*`` version, the kernel pair's device time against its
   bound (bytes at 3.35 TB/s) beside both, the host's time a step of all
   three, and two steps of a c6 ``Trainer`` with no host sync, two launches
   each and the ``train.optimizer`` span's attributes.  Every training path
   above counts the pair's launches (``multi_adam``, two a step) beside B1's
   and B2's, and every serving path none.
38. DPRNN-TasNet at its published widths
   (``benchmark/configs/dprnn_luo2020.json``; N 64, L 2, stride 1, chunks of
   250 at hop 125, 6 blocks of 2 x 128-cell BLSTMs) served through
   ``StreamingSeparator`` in one padded batch of DPRNN_LENGTHS in the 49152
   bucket, each row against the benchmark's plain float32 reference
   (``benchmark/reference/dprnn.py``) on the card within the cell's limit of
   ``serve.judged_error``; the path each of the 12 BLSTM layers of a call
   took (the ``dprnn.intra``/``dprnn.inter`` spans' ``blstm_path``) against
   ``blstm_path``'s rule at their rows, one ``sync.lengths`` a call, and the
   spans' step counts.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero,
and so does a machine without a CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
CONVTASNET_CONFIG = os.path.join(REPO, "benchmark", "configs", "convtasnet_luo2019.json")
CKPT = os.path.join(REPO, "checkpoints", "c1_dpcl")
C2_CKPT = os.path.join(REPO, "checkpoints", "c2_adapt")
TIME_LIMIT_S = 1150  # the whole run; a hang ends with a traceback and exit 1

# Published peaks of one H100 SXM at 700 W (NVIDIA data sheet): dense TF32 on
# the tensor cores, FP32 on the CUDA cores, and HBM3 bandwidth.  Both kernels
# compute in 3xTF32: three TF32 products per FP32 product.
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
TF32X3 = 3

SECONDS = 8
SAMPLE_RATE = 8000
N_UTTS = 64
BATCH = 8
QUALITY_N = 64
QUALITY_T = 16384
# A working path scores about 6.4 dB here: the JAX package gives 6.396 dB
# [5.263, 7.523] on this protocol in FP32 on the CPU and the port agrees
# (tests/test_torch_dpcl_slice.py).  A broken kernel scores about 0 dB.  The
# gate sits at the lower end of the reference's 95% interval.
QUALITY_MIN_DB = 5.25

# phase 5: the c1 recipe at full width, cut to TRAIN_STEPS steps on a
# synthetic v1 corpus of TRAIN_SPEAKERS x TRAIN_SECONDS s
TRAIN_STEPS = 200
TRAIN_VALID_EVERY = 100
TRAIN_LOG_EVERY = 10
TRAIN_SPEAKERS = 24
TRAIN_SECONDS = 20.0
# the card's first step against the CPU's (plain versions, the BLSTM as a
# loop): the loss relative to the CPU's, each gradient relative to its largest
# CPU magnitude (FP32 on both sides, summed in other orders through 253 steps)
STEP_LOSS_TOL = 1e-4
STEP_GRAD_TOL = 1e-3
# phase 2b: each kernel's gradients against the plain version's autograd,
# relative to the reference's largest magnitude.  3xTF32 gives under 1e-6;
# a single-pass TF32 kernel is off by about 1e-3 and fails.
GRAD_TOL = 2e-5

# phase 7: c2_adapt scores about 6.9 dB on phase 4's protocol: the JAX package
# gives 6.893 dB [6.478, 7.316] (n = 64) in FP32 on the CPU and the port agrees
# (tests/test_torch_c2_slice.py).  The gate sits at the lower end of the
# reference's 95% interval.
C2_QUALITY_MIN_DB = 6.47
# phase 8: the recipes at full width, cut to C2_PRETRAIN_STEPS and C2_STEPS
# steps (the recipes say 1000), the front frozen for C2_FREEZE_STEPS (the
# recipe says 200), on phase 5's corpus
C2_PRETRAIN_STEPS = 200
C2_STEPS = 200
C2_FREEZE_STEPS = 100
C2_VALID_EVERY = 100
# phase 9: two-speaker mixtures of 60 s and 90 s in turn (8 and 12 chunks of
# 64000 samples), speakers from seed LONG_SEED0 on.  c1_dpcl scores 4.819 dB
# [3.556, 6.010] (n = 8) on them through the JAX package's long-form path in
# FP32 on the CPU (python tests/test_torch_long.py); the gate sits at the lower
# end of that 95% interval.
LONG_SECONDS = (60, 90) * 4
LONG_SEED0 = 30000
LONG_QUALITY_MIN_DB = 3.55

# phase 10: the c6 checkpoints (their learned front's bases are B1's and B2's)
C6_FLAGSHIP = os.path.join(REPO, "checkpoints", "c6_flagship")
C6_3SPK = os.path.join(REPO, "checkpoints", "c6_3spk")
# phase 11: c6_flagship scores 13.396 dB [12.843, 13.958] (S = 2) and
# c6_3spk 8.477 dB [8.032, 8.913] (S = 3) on phase 4's protocol through the
# JAX package on the CPU, and the port agrees (13.395 and 8.477; python
# tests/test_torch_c6_slice.py).  Each gate sits at the lower end of the
# reference's 95% interval.
C6_QUALITY_MIN_DB = 12.84
C6_3SPK_QUALITY_MIN_DB = 8.03
# the flagship's output on the card against the port's on the CPU, as SI-SDR
# of one against the other.  bf16 operands make the two differ where a sum
# order flips a rounding to bf16: two float32 sum orders on the CPU (float32
# against float64 accumulation) agree to 55.0-57.8 dB
C6_CARD_CPU_MIN_DB = 40.0
# phase 12: the c6 recipe at full width, cut to C6_STEPS steps (the recipe
# says 1000) on phase 5's corpus
C6_STEPS = 200
C6_VALID_EVERY = 100
# its first step, card against CPU: the loss to STEP_LOSS_TOL, each gradient
# to C6_STEP_GRAD_TOL of its largest CPU magnitude.  The encoder's gradient
# passes through log(|z| + 1e-7) of near-silent codes, whose slope magnifies
# float32 rounding: on the CPU, float32 against float64 gives front.enc's
# gradient 9.5e-4 of its scale apart (the TCN's at most 7.7e-4), so two
# float32 sum orders may differ by twice that
C6_STEP_GRAD_TOL = 5e-3
# and one bf16 step of the flagship at its config.json batch (16 x 16384) from
# the checkpoint's weights, card against CPU.  Two float32 sum orders on the
# CPU (float32 against float64 accumulation, batch 4) gave losses 5.8e-4 dB
# apart (the loss is -SI-SDR in dB, near 0 on some batches, so it is held
# absolutely), gradients 4.4% apart in norm over all tensors and at most
# 11.3% for one tensor: bf16 roundings of operands and of gradients flip with
# the sum order
C6_BF16_LOSS_TOL_DB = 0.01
C6_BF16_GRAD_TOL = 0.15  # ||g_card - g_cpu|| / ||g_cpu|| over all tensors
C6_BF16_TENSOR_TOL = 0.4  # the same for each tensor alone

# phase 13: c7_causal streamed in chunks of REALTIME_CHUNK against its offline
# output on the card, as the largest difference over the output's peak
C7_CAUSAL = os.path.join(REPO, "checkpoints", "c7_causal")
REALTIME_CHUNK = 4096
C7_STREAM_TOL = 1e-4
REALTIME_STREAMS = 16
REALTIME_SPEED_SECONDS = 8  # audio per stream in the ms-per-push runs
# phase 14: c7_causal scores 8.347 dB [7.760, 8.953] on phase 4's protocol
# through the JAX package on the CPU, and the port agrees (8.347; python
# tests/test_torch_c7_slice.py); the gate sits at the lower end of that
# interval.  The c7 recipe at full width, cut to C7_STEPS steps.
C7_QUALITY_MIN_DB = 7.76
C7_STEPS = 200
# phase 15: c3_l41 blind scores 5.498 dB [4.144, 6.834] on phase 4's protocol,
# and enrolled 13.061 dB [12.176, 13.952] on C3_ENROLLED_N mixtures of its
# training speakers (the v2 corpus of 100 x 120 s from seed 1, steps from
# 10,000,000 of the train split), both through the JAX package on the CPU,
# and the port agrees (python tests/test_torch_c3_slice.py); each gate sits at
# the lower end of its interval.
C3_L41 = os.path.join(REPO, "checkpoints", "c3_l41")
C3_QUALITY_MIN_DB = 4.14
C3_ENROLLED_MIN_DB = 12.17
C3_ENROLLED_N = 16
C3_STEPS = 200
# phase 16: the c4 recipe at full width, cut to C4_STEPS steps on a v1 corpus
# of its own, C4_SPEAKERS x TRAIN_SECONDS s (nine valid speakers).  Phase 5's
# 24 speakers leave three valid ones, and every three-speaker valid mixture
# then holds the same three: there the valid loss did not fall in 200 steps
# while the train loss did.  The trained state on the card against the port
# on the CPU, as SI-SDR of one against the other, on two three-speaker
# mixtures (float32 on both sides)
C4_SPEAKERS = 60
C4_STEPS = 200
C4_CARD_CPU_MIN_DB = 40.0

# phase 17: blind counting on checkpoints/c1_count (2x300 BLSTM, E = 20,
# trained on mixtures of 1-3 speakers), COUNT_N mixtures of each of k = 1, 2
# and 3 speakers drawn as scripts/r3_wave.py::test_mixtures draws them: the
# test split of the synthetic v2 corpus of 30 x 40 s from seed 0, Mixer seed 0,
# steps 0 on, batch 1.  The JAX package counts them right at 0.98, 1.00 and
# 0.84 (confusion {1: {1: 49, 2: 1}, 2: {2: 50}, 3: {1: 2, 2: 6, 3: 42}}) in
# float32 on the CPU (python tests/test_torch_count.py).  Each gate is that
# accuracy less 0.06, three mixtures of 50: the card may count up to 2% of the
# 150 otherwise than the CPU (COUNT_AGREE_MIN), where cuSOLVER's eigenvalues
# and LAPACK's break a near-tie of two gaps apart
C1_COUNT = os.path.join(REPO, "checkpoints", "c1_count")
COUNT_N = 50
COUNT_MIN_ACC = {1: 0.92, 2: 0.94, 3: 0.78}
COUNT_AGREE_MIN = 0.98
# auto-k (infer/count.py::separate_auto_k, the CLI's --num-speakers auto) on the
# first AUTOK_N mixtures of each k: the JAX package's SI-SDRi of the correctly
# counted (scripts/r3_wave.py::count_sep_eval_model) is 12.787 dB [12.165,
# 13.419] at k = 2 (32 of 32 counted right) and 10.645 dB [10.231, 11.026] at
# k = 3 (26 of 32); each gate sits at the lower end of its interval
AUTOK_N = 32
AUTOK_MIN_DB = {2: 12.16, 3: 10.23}

# phase 18: the enh recipe (a 1 x 128 BLSTM refining checkpoints/c1_dpcl) at
# full width, cut to ENH_STEPS steps on phase 5's corpus.  At init the refiner
# is near the identity: the JAX package's init puts the two-stage output
# 22.07 dB SI-SDR from the base's at least (26.63 dB on average) on eight of
# phase 4's mixtures, and scores 6.317 dB on phase 4's protocol against the
# base's 6.396 (python tests/test_torch_enhance.py); the port's init is held at
# ENH_INIT_MIN_DB.  The trained state is served on phase 4's protocol and gated
# at c1's QUALITY_MIN_DB.  The base's k-means seeds on a tie that rounding
# breaks (ROADMAP C.2), so the card and the CPU are compared twice: the second
# stage given one first pass (ENH_STAGE_CARD_CPU_MIN_DB, float32 on both
# sides), and the whole two-stage output in the best speaker order (the two
# may seed in another order) at the bound c1 keeps against the JAX package
# (tests/test_torch_dpcl_slice.py)
ENH_STEPS = 200
ENH_INIT_MIN_DB = 18.0
ENH_STAGE_CARD_CPU_MIN_DB = 40.0
ENH_CARD_CPU_MIN_DB = 30.0

# phases 19 and 20: c6 with the DPRNN trunk (width 128, 6 blocks) and the DPT
# trunk (width 192, 6 blocks, 4 heads, dropout 0.1) at full width
# (configs/recipes.py::c6_dual_path), cut to DP_STEPS steps on phase 5's
# corpus; the trained state served on the card against the CPU at
# C4_CARD_CPU_MIN_DB, with one utterance padded in its bucket
DP_STEPS = 200
DP_PADDED_SAMPLES = 12000
# and phase 19 holds the BLSTM stack's dropout (cuDNN a layer at a time) to
# the step-by-step loop on the card with the same masks, float32 on both: the
# output to 1e-4 of its peak (8.7e-6 seen), the input's gradient to phase 5's
# STEP_GRAD_TOL (3.3e-4 seen: sums through 50 steps and two layers in other
# orders; a wrong mask is off by order 1)
BLSTM_DROPOUT_TOL = 1e-4

# phase 21: checkpoints/c1_count's own config.json, valid_quality on, cut to
# COUNT_TRAIN_STEPS steps of 12000, on COUNT_TRAIN_SPEAKERS synthetic v2
# speakers of TRAIN_SECONDS s written as 16-bit WAVs at COUNT_WAV_RATE, two
# utterances each, and ingested into an 8 kHz store.  k ~ U{1, 2, 3} per row
COUNT_TRAIN_STEPS = 200
COUNT_TRAIN_SPEAKERS = 60
COUNT_WAV_RATE = 16000
COUNT_K_SHARE_TOL = 0.1
# phase 22: the c6 recipe with the noise-robust and reverb-robust settings of
# scripts/r3_wave.py, cut to C6_CORRUPT_STEPS steps each on phase 5's corpus;
# each apply on the card held to the CPU's on the same draws within
# CORRUPT_TOL of the peak (float32 sums in another order; TF32 would give
# about 1e-3), the drawn DRR within RIR_DRR_TOL_DB of the RIR's
C6_CORRUPT_STEPS = 50
C6_CORRUPTIONS = {"noise": {"train_noise_snr_db": (5.0, 20.0)},
                  "reverb": {"train_reverb_rt60": (800.0, 3200.0)}}
CORRUPT_TOL = 1e-5
RIR_DRR_TOL_DB = 0.2
# phase 23: c1_dpcl on phase 4's protocol, the JAX package's evaluation on the
# CPU: SDRi 7.5488 dB [6.4866, 8.6005], STOIi 0.1073 [0.0763, 0.1363] (95%
# bootstrap intervals, `python tests/test_torch_eval.py`); gated at their
# lower ends.  Its SI-SDRi is phase 4's within EVAL_SI_SDRI_TOL_DB (float32 on
# the card against phase 4's float64 on the CPU)
EVAL_SDRI_MIN_DB = 6.48
EVAL_STOI_I_MIN = 0.076
EVAL_SI_SDRI_TOL_DB = 1e-3

# phase 28: the native batch fill (csrc/amss_data.cc, built with g++) against
# the numpy loop (data/native.py::batch_fill_ref), bit for bit, at
# c6_flagship's batch (16 x 2 x 16384) on phase 5's corpus, FILL_ROUNDS plans
FILL_BATCH = 16
FILL_CHUNK = 16384
FILL_ROUNDS = 10
# phase 29: a corpus resident on the card at the size that
# amss_tpu/data/device_corpus.py:4-9 calls training scale, 100 speakers x
# 120 s at 8 kHz (192 MB as int16), synthetic v1 from seed 0, written in at
# most DC_BUILD_BUDGET_S and cut to the speakers written by then.  ``gather``
# against ``Mixer.batch`` on the plans of steps 0 to DC_CHECK_STEPS - 1 within
# one LSB times the gain (tests/test_device_corpus.py's bound: the device
# path rounds the unscaled waveform to int16, the host's wire format
# truncates gain x chunk)
DC_SPEAKERS = 100
DC_SECONDS = 120.0
DC_BUILD_BUDGET_S = 60.0
DC_CHECK_STEPS = 4
# phase 30: checkpoints/c6_flagship/config.json (device data, the bf16 TCN,
# batch 16 x 16384, EMA 0.999, steps_per_call 20) cut to C6F_STEPS of its
# 96000 steps, validating every C6F_VALID_EVERY (9600), on phase 29's corpus.
# Its first step's loss on device data against host data on one plan within
# DEVICE_HOST_LOSS_TOL (tests/test_device_corpus.py's bound); then ms per
# step of each in turns of SPEED_TURN_STEPS steps (device, host, host, device)
C6F_STEPS = 200
C6F_VALID_EVERY = 100
DEVICE_HOST_LOSS_TOL = 1e-3
SPEED_TURN_STEPS = 10
# phase 31: the c1 recipe at full width (2x300 BLSTM, batch 8 x 16384) in
# bf16 with device data, C1_BF16_STEPS steps of fit on phase 29's corpus; its
# first step on the card against the CPU: the loss relative to the CPU's, the
# gradients' distance over all tensors and each tensor's, relative to the
# CPU's norms (loss, all, each).  A sum order flips roundings to bf16, of h in
# the forward and of the gradients in the backward: the port and the JAX
# package (two float32 sum orders of the same bf16 products, on the CPU) put
# the full-width c1 step 2.2e-7, 1.0e-3 and 2.2e-3 apart, and the card and
# the CPU 1.9e-6, 1.06e-3 and 2.18e-3 (enh's refiner 4.9e-6, 4.2e-4, 1.8e-3;
# this phase on an H100 80GB HBM3 at 700 W).  The bounds are phase 5's loss
# bound and ten times the gradients' distances
C1_BF16_STEPS = 20
C1_BF16_TOLS = (1e-4, 1e-2, 2e-2)
# checkpoints/c1_dpcl served in bf16: the JAX package scores 6.377 dB [5.242,
# 7.500] on phase 4's protocol in bf16 on the CPU (python
# tests/test_torch_blstm_bf16.py); the gate sits at the lower end of that
# 95% interval
C1_BF16_QUALITY_MIN_DB = 5.24
# phase 32: one bf16 step of c6 with the DPRNN trunk and of the enh refiner,
# card against CPU, as phase 31's.  The DPRNN c6 step was 6.95e-5, 4.66e-3
# and 7.68e-3 apart (this phase on the same card): six blocks of bf16 roundings
# behind the adaptive front, whose log of near-silent codes magnifies
# rounding (ROADMAP C.11); its bounds are about ten times those
DP_BF16_TOLS = (1e-3, 5e-2, 0.1)

# phases 33-36 check the several-card code on the one card of the machine,
# with meshes that name it more than once and ranks that share it.  phase 33:
# the bound of tests/test_timeshard.py
SHARD_STFT_TOL = 1e-4
SHARD_STFT_SAMPLES = 8 * 64 * 1000
# phase 34: c6_flagship's long-form over the mesh against separate_long on the
# card, as SI-SDR of one against the other: the TCN's bf16 products may round
# otherwise at another batch size, and 40 dB is the card-against-CPU bound
MESH_C6_MIN_DB = 40.0
MESH = ("cuda:0", "cuda:0")
# phase 35: the c1 recipe at full width over RANK_WORLD ranks; the first step
# of the ranks against one process fed their rows: the loss relative, every
# gradient within RANK_GRAD_TOL of the largest gradient magnitude (only the
# order of the sums differs)
RANK_WORLD = 2
RANK_STEPS = 20
RANK_COUNT_STEPS = 10
RANK_NCCL_STEPS = 5
RANK_LOSS_TOL = 1e-5
RANK_GRAD_TOL = 1e-5
# phase 36: the exported bf16 c1 against live bf16 serving, as the largest
# difference over the live output's peak: one loop, one order of sums, so 0 is
# expected
BF16_ARTIFACT_TOL = 1e-5

# phase 37: the multi-tensor clip and Adam on c6's and Conv-TasNet's
# parameter lists.  A step that does not clip is bit-equal to the plain
# version, and so is one that clips when the plain version is given the
# kernel's norm: only the norm's order of summation differs, and the kernel's
# norm (float32 partials of 4096 elements, summed in float64) lies within
# MADAM_NORM_ULPS of the exact one; the torch._foreach_* yardstick sums in its
# own order, within MADAM_LIBRARY_TOL of each tensor's largest magnitude
MADAM_MAX_NORM = 5.0
MADAM_LR = 1e-3
MADAM_NORM_ULPS = 1
MADAM_LIBRARY_TOL = 1e-5
MADAM_BYTES = 28  # read p, g, m, v and write p, m, v: each byte once
MADAM_DESIGN = ("two launches a step over every tensor: a static chunk table (<= 4096 elements, "
                "one block each), the norm pass's float32 partials with no atomics, the update "
                "pass re-summing them in float64 in every block; float4 loads where aligned")

# phase 38: DPRNN-TasNet at its published widths in one padded batch of the
# 49152 bucket (8 rows, 35000-48000 samples), against the benchmark's plain
# reference within the cell's limit (benchmark/limits/, read there)
DPRNN_CONFIG = os.path.join(REPO, "benchmark", "configs", "dprnn_luo2020.json")
DPRNN_LIMITS = os.path.join(REPO, "benchmark", "limits", "dprnn_luo2020.offline_wsj.json")
DPRNN_LENGTHS = (48000, 47000, 45000, 43000, 41000, 39000, 37000, 35000)

# phase 2c: the k-means kernels against the plain version at the serving
# cell's points a row (765 frames of 129 bins), the last KMEANS_PAD of each
# row at weight 0.  The sums run in other orders than cuBLAS's: centroids
# (relative to their norm) and masks within KMEANS_TOL, assignments equal
# wherever a point's two nearest distances differ by more than KMEANS_TOL
# relative, since only there can rounding not flip them; the first seed,
# whose score the kernels take from the plain version's expression, equal
KMEANS_N = 765 * 129
KMEANS_PAD = 0.023
KMEANS_TOL = 1e-5
KMEANS_DESIGN = ("one pass over the embeddings a step: a block stages 256 points by 16-byte "
                 "loads, a thread a point (norm, dots, distances, first argmin), the tile's "
                 "weighted sums by cluster to partials in a fixed order; one warp a centroid "
                 "element sums them; no float atomics; 2K + 2 iters + 1 launches a fit, 2 "
                 "for the masks")

# phase 2d: the BLSTM's recurrence kernel against the loop and packed at deep
# clustering's serving shape, the last BLSTM_PAD frames of each row masked
# (the serving cell's bucket); float32 sums in other orders: BLSTM_TOL of the
# output's largest magnitude
BLSTM_SHAPE = (8, 765, 129)
BLSTM_HIDDEN = 300
BLSTM_PAD = 18
BLSTM_TOL = 1e-5
BLSTM_DESIGN = ("a cluster of 16 blocks per (direction, tile of rows), W_hh's slice in registers "
                "(FFMA, float32), h exchanged by st.async into every block's next buffer, counted "
                "on mbarriers; one launch a layer, both directions, every step, the mask read on "
                "the card; the input projection one float32 GEMM a layer")

# phase 2e: the row-parallel BLSTM kernel against loop and packed at DPRNN-TasNet's
# cell shapes, name -> (rows, steps, inputs, valid steps or None: unmasked);
# H = BLSTM_ROWS_HIDDEN, tolerance BLSTM_TOL
BLSTM_ROWS_SHAPES = {"intra": (3088, 250, 64, None), "inter": (2000, 396, 64, 386)}
BLSTM_ROWS_HIDDEN = 128
BLSTM_ROWS_DESIGN = ("a cluster of 2 blocks per (direction, tile of rows), the tile sized so "
                     "that both directions' tiles fill the card in one wave; W_hh's slice in "
                     "shared memory, 8 rows x 2 units (all 4 gates) a thread in FFMA, float32; "
                     "h exchanged by st.async into both blocks' next buffer, counted on "
                     "mbarriers; one launch a layer, both directions, every step, the mask read "
                     "on the card; the input projection one float32 GEMM a layer")

# name -> (source, the TPU kernel it replaces, its design)
KERNELS = {
    "framed_matmul": ("amss_tpu_torch/csrc/framed_matmul.cu",
                      "amss_tpu/ops/pallas/framed_matmul.py:75",
                      "mma.sync m16n8k8 3xTF32 split in registers, FP32 promotion every 2 "
                      "k-steps, cp.async 2-stage ring, 64x88 tiles of 4 warps, 3 blocks/SM"),
    "decode_ola": ("amss_tpu_torch/csrc/decode_ola.cu", "amss_tpu/ops/pallas/ola.py:72",
                   "mma.sync m16n8k8 3xTF32 split in registers, FP32 promotion every 2 "
                   "k-steps, cp.async 2-stage ring, 128x64 tiles of 8 warps, 1 block/SM"),
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def say(msg: str) -> None:
    print(msg, flush=True)


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True,
                          timeout=120).stdout.strip()


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if not torch.isfinite(a).all():
        raise AssertionError("kernel output has non-finite values")
    return float((a - b).abs().max())


def check(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    err = max_err(got, want)
    say(f"  {name}: max_abs_err {err:.3e} (tol {tol:g})")
    if not err <= tol:
        raise AssertionError(f"{name}: max abs error {err} > {tol}")
    return err


def launch_counts() -> dict:
    """Each kernel wrapper's count of launches (the optimizer's pair, two a
    train step, as ``multi_adam``)."""
    from amss_tpu_torch.ops.kernels.framed_matmul import framed_matmul
    from amss_tpu_torch.ops.kernels.multi_adam import MultiTensorAdam
    from amss_tpu_torch.ops.kernels.ola import decode_ola

    return {"framed_matmul": framed_matmul.launches, "decode_ola": decode_ola.launches,
            "multi_adam": MultiTensorAdam.launches}


def reset_launches() -> None:
    from amss_tpu_torch.ops.kernels.framed_matmul import framed_matmul
    from amss_tpu_torch.ops.kernels.multi_adam import MultiTensorAdam
    from amss_tpu_torch.ops.kernels.ola import decode_ola

    framed_matmul.launches = decode_ola.launches = MultiTensorAdam.launches = 0


def bound(flops: float, nbytes: float) -> dict:
    """The least time for the work: the 3xTF32 tensor-core bound the kernels
    are held to, and the FP32 CUDA-core bound beside it for reference."""
    t_bytes = nbytes / PEAK_HBM_BYTES
    t_tc = TF32X3 * flops / PEAK_TF32_FLOPS
    t_fp32 = flops / PEAK_FP32_FLOPS
    return dict(bound_ms=max(t_tc, t_bytes) * 1e3,
                bound_by="operations" if t_tc >= t_bytes else "bytes",
                bound_fp32_ms=max(t_fp32, t_bytes) * 1e3,
                bound_fp32_by="operations" if t_fp32 >= t_bytes else "bytes")


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes of each kernel, from nvcc's -Xptxas=-v output."""
    report, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            report[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            report[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[name]["registers"] = int(m.group(1))
    return report


def sass_counts(lib_path, nvcc: str) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) in each kernel's machine code."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    counts, name = {}, None
    for line in run([cuobjdump, "-sass", str(lib_path)]).splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = m.group(1)
            counts[name] = {"HMMA": 0, "HGMMA": 0}
        elif name is not None:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\.", line):
                    counts[name][op] += 1
                    break
    return counts


def kernel_facts(ptxas: dict, sass: dict, kernel: str) -> dict:
    """What the compiler made of ``kernel`` over all its template instances:
    the most registers and spill bytes of any, and the fewest tensor-core
    instructions of any."""
    names = [n for n in sass if kernel in n]
    if not names or any(n not in ptxas for n in names):
        raise AssertionError(f"{kernel}: not found in {sorted(sass)} and {sorted(ptxas)}")
    return dict(instances=len(names),
                registers=max(ptxas[n]["registers"] for n in names),
                spill_bytes=max(ptxas[n]["spill_bytes"] for n in names),
                HMMA=min(sass[n]["HMMA"] for n in names),
                HGMMA=min(sass[n]["HGMMA"] for n in names))


def phase_kernels(gen: torch.Generator) -> dict:
    from amss_tpu_torch.models.front import STFTFrontEnd
    from amss_tpu_torch.ops.kernels.framed_matmul import (
        framed_matmul, framed_matmul_ref, stft_basis)
    from amss_tpu_torch.ops.kernels.ola import (
        decode_ola, decode_ola_ref, overlap_add_via_kernel)
    from amss_tpu_torch.ops.framing import overlap_add
    from amss_tpu_torch.utils.config import FrontConfig
    from amss_tpu_torch.utils.timing import time_ms

    dev = torch.device("cuda")

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    # -- B1 at the main path's shape: STFT analysis of 8 x 8 s ----------------
    say("B1 framed_matmul vs framed_matmul_ref")
    x = randn(BATCH, SECONDS * SAMPLE_RATE, scale=0.3)
    basis = torch.as_tensor(stft_basis(256), device=dev)
    hop = 64
    got = framed_matmul(x, basis, hop)
    b1_err = check("256/64 K=258 [8, 64000] (STFT)", got, framed_matmul_ref(x, basis, hop), 2e-3)
    xs = randn(16, 16384, scale=0.3)  # the sources' STFT in a c1 train step
    check("256/64 K=258 [16, 16384] (STFT, training sources)", framed_matmul(xs, basis, hop),
          framed_matmul_ref(xs, basis, hop), 2e-3)
    xr = randn(1, 3001, scale=0.3)  # 44 frames: a ragged last tile
    check("256/64 K=258 [1, 3001] (STFT, 44 frames)", framed_matmul(xr, basis, hop),
          framed_matmul_ref(xr, basis, hop), 2e-3)
    for win, hop_e, k, nb, t in ((256, 64, 7, 1, 3001), (128, 32, 65, 2, 4000),
                                 (32, 16, 64, 2, 2048), (512, 128, 96, 2, 6000)):
        xe, be = randn(nb, t), randn(win, k)
        check(f"{win}/{hop_e} K={k} [{nb}, {t}] forced", framed_matmul(xe, be, hop_e, force=True),
              framed_matmul_ref(xe, be, hop_e), 2e-4)
    b, nf, k = BATCH, got.shape[1], basis.shape[1]
    win = basis.shape[0]
    b1_bounds = bound(2.0 * b * nf * k * win, 4.0 * (x.numel() + basis.numel() + b * nf * k))
    w_conv = basis.T.contiguous()[:, None, :]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        lib_out = F.conv1d(x[:, None, :], w_conv, stride=hop).transpose(1, 2)
        log(f"  conv1d yardstick max_abs_err {max_err(lib_out, got):.3e}")
        b1_lib = time_ms(lambda: F.conv1d(x[:, None, :], w_conv, stride=hop))
    x4 = x[:4]  # long-form's tail group: 4 chunks of 64000
    y4 = framed_matmul(x4, basis, hop)
    check(f"256/64 K=258 [4, 64000] (STFT, long-form tail group; |out| <= "
          f"{float(y4.abs().max()):.3g})", y4, framed_matmul_ref(x4, basis, hop), 2e-3)
    b1 = dict(ms=time_ms(lambda: framed_matmul(x, basis, hop)),
              plain_ms=time_ms(lambda: framed_matmul_ref(x, basis, hop)),
              library_ms=b1_lib, max_abs_err=b1_err, tol=2e-3, **b1_bounds)

    # -- B2 at the main path's shape: iSTFT of 8 utterances x 2 speakers ------
    say("B2 decode_ola vs decode_ola_ref")
    front = STFTFrontEnd(FrontConfig()).to(dev)
    codes = torch.cat([got, 0.5 * got], dim=0).contiguous()  # [16, 997, 258] STFT values
    syn = front.synthesis_basis
    length = SECONDS * SAMPLE_RATE
    y = decode_ola(codes, syn, hop, length=length)
    b2_err = check("258x256 hop 64 [16, 997, 258] -> 64000 (iSTFT)", y,
                   decode_ola_ref(codes, syn, hop, length), 2e-4)
    c8 = codes[:8]  # long-form's tail group: 4 chunks x 2 speakers
    y8 = decode_ola(c8, syn, hop, length=length)
    check(f"258x256 hop 64 [8, 997, 258] -> 64000 (iSTFT, long-form tail group; |out| <= "
          f"{float(y8.abs().max()):.3g})", y8, decode_ola_ref(c8, syn, hop, length), 2e-4)
    for nb, nf_e, k_e, win_e, hop_e, len_e, what in (
        (2, 40, 96, 256, 128, None, "hop 128"),
        (2, 45, 258, 512, 128, 5000, "512/128 K=258 length 5000 trim"),
        (1, 30, 16, 128, 32, 900, "length 900 trim"),
        (2, 50, 32, 128, 32, 2000, "length 2000 zero-pad"),
        (2, 127, 64, 32, 16, 2048, "32/16"),
    ):
        ce, be = randn(nb, nf_e, k_e), randn(k_e, win_e)
        check(f"{what} forced", decode_ola(ce, be, hop_e, length=len_e, force=True),
              decode_ola_ref(ce, be, hop_e, len_e), 2e-4)
    frames = randn(2, 997, 256)
    check("overlap_add_via_kernel 256/64", overlap_add_via_kernel(frames, 64),
          overlap_add(frames, 64), 2e-4)
    b2n, nf2, k2 = codes.shape
    win2 = syn.shape[1]
    b2_bounds = bound(2.0 * b2n * nf2 * k2 * win2,
                      4.0 * (codes.numel() + syn.numel() + b2n * length))
    codes_t = codes.transpose(1, 2).contiguous()
    w_t = syn[:, None, :].contiguous()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        lib_y = F.conv_transpose1d(codes_t, w_t, stride=hop)[:, 0, :length]
        log(f"  conv_transpose1d yardstick max_abs_err {max_err(lib_y, y):.3e}")
        b2_lib = time_ms(lambda: F.conv_transpose1d(codes_t, w_t, stride=hop)[:, 0, :length])
    b2 = dict(ms=time_ms(lambda: decode_ola(codes, syn, hop, length=length)),
              plain_ms=time_ms(lambda: decode_ola_ref(codes, syn, hop, length)),
              library_ms=b2_lib, max_abs_err=b2_err, tol=2e-4, **b2_bounds)
    return {"framed_matmul": b1, "decode_ola": b2}


def grad_check(what: str, fn, ref_fn, inputs: list, cot: torch.Tensor, fwd_tol: float,
               other) -> dict:
    """``fn`` (a kernel's autograd) against its plain version ``ref_fn`` on the
    same inputs: the output within ``fwd_tol`` (the forward checks' absolute
    tolerance), and the gradients against torch autograd of ``ref_fn``, each
    within ``GRAD_TOL`` of the reference's largest magnitude.  Counts the
    launches of ``other`` (the kernel the backward runs) made by the backward
    alone."""
    tol = GRAD_TOL
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    check(f"{what} forward", out.detach(), ref_fn(*inputs), fwd_tol)
    before = other.launches
    got = torch.autograd.grad(out, leaves, cot)
    launched = other.launches - before
    ref_leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    want = torch.autograd.grad(ref_fn(*ref_leaves), ref_leaves, cot)
    worst = dict(grad_max_abs_err=0.0, grad_scale=1.0, grad_rel_err=0.0)
    for name, g, w in zip(("d" + what.split()[0], "dbasis"), got, want):
        scale = float(w.abs().max())
        err = max_err(g, w)
        say(f"  {what} {name}: max_abs_err {err:.3e} = {err / scale:.2e} of "
            f"{scale:.3g} (tol {tol:g} of it)")
        if not err <= tol * scale:
            raise AssertionError(f"{what} {name}: max abs error {err} > {tol} x {scale}")
        if err / scale >= worst["grad_rel_err"]:
            worst = dict(grad_max_abs_err=err, grad_scale=scale, grad_rel_err=err / scale)
    return {**worst, "launched": launched}


def phase_gradients(gen: torch.Generator) -> dict:
    """Each kernel's backward (the other kernel plus a plain product) against
    the plain version's autograd, and its time at the training shape."""
    from amss_tpu_torch.models.front import STFTFrontEnd
    from amss_tpu_torch.ops.framing import frame_signal
    from amss_tpu_torch.ops.kernels.framed_matmul import (
        framed_matmul, framed_matmul_ref, stft_basis)
    from amss_tpu_torch.ops.kernels.ola import decode_ola, decode_ola_ref
    from amss_tpu_torch.utils.config import FrontConfig
    from amss_tpu_torch.utils.timing import time_ms

    dev = torch.device("cuda")

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    stft = torch.as_tensor(stft_basis(256), device=dev)
    syn = STFTFrontEnd(FrontConfig()).to(dev).synthesis_basis
    out = {}

    say("B1 framed_matmul backward (dx through B2) vs autograd of framed_matmul_ref")
    checks = []
    t_train = 16384
    for what, x, basis, hop, fwd_tol in (
        ("x [8, 16384] 256/64 K=258 (STFT, training)", randn(8, t_train, scale=0.3), stft, 64,
         2e-3),
        ("x [1, 3001] 256/64 K=258 (STFT, 44 frames)", randn(1, 3001, scale=0.3), stft, 64,
         2e-3),
        ("x [1, 3001] 256/64 K=7", randn(1, 3001), randn(256, 7), 64, 2e-4),
        ("x [2, 6000] 512/128 K=258", randn(2, 6000), randn(512, 258), 128, 2e-4),
    ):
        nf = 1 + (x.shape[1] - basis.shape[0]) // hop
        cot = randn(x.shape[0], nf, basis.shape[1])
        checks.append((grad_check(what, lambda a, b, h=hop: framed_matmul(a, b, h),
                                  lambda a, b, h=hop: framed_matmul_ref(a, b, h),
                                  [x, basis], cot, fwd_tol, decode_ola), GRAD_TOL))
    out["framed_matmul"] = checks

    say("B2 decode_ola backward (dcodes through B1) vs autograd of decode_ola_ref")
    checks = []
    for what, codes, basis, hop, length, fwd_tol in (
        ("codes [16, 997, 258] -> 64000 (iSTFT, serving)",
         randn(16, 997, 258, scale=3.0), syn, 64, 64000, 2e-4),
        ("codes [2, 44, 258] -> 2900 (iSTFT, trimmed)", randn(2, 44, 258, scale=3.0), syn, 64,
         2900, 2e-4),
        ("codes [2, 45, 258] 512/128 -> 5000 (trimmed)", randn(2, 45, 258), randn(258, 512),
         128, 5000, 2e-4),
        ("codes [2, 44, 258] 256/64 -> 3300 (zero-padded)", randn(2, 44, 258), randn(258, 256),
         64, 3300, 2e-4),
    ):
        cot = randn(codes.shape[0], length)
        checks.append((grad_check(what, lambda c, b, h=hop, n=length: decode_ola(c, b, h, n),
                                  lambda c, b, h=hop, n=length: decode_ola_ref(c, b, h, n),
                                  [codes, basis], cot, fwd_tol, framed_matmul), GRAD_TOL))
    out["decode_ola"] = checks

    # the backward's time at the training shapes: B1 on the sources' STFT
    # [8, 16384], B2 on the codes of the same chunk [8, 253, 258].  The
    # forward runs on the stream the backward is then captured on.
    x = randn(8, t_train, scale=0.3).requires_grad_(True)
    basis = stft.clone().requires_grad_(True)
    codes = randn(8, 253, 258).requires_grad_(True)
    sb = syn.clone().requires_grad_(True)
    times = {}
    for name, fn, plain, leaves in (
        ("framed_matmul", lambda: framed_matmul(x, basis, 64),
         lambda: framed_matmul_ref(x, basis, 64), (x, basis)),
        ("decode_ola", lambda: decode_ola(codes, sb, 64, t_train),
         lambda: decode_ola_ref(codes, sb, 64, t_train), (codes, sb)),
    ):
        for key, forward in (("backward_ms", fn), ("backward_plain_ms", plain)):
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                y = forward()
                cot = torch.randn(y.shape, generator=gen, device=dev)
            times.setdefault(name, {})[key] = time_ms(
                lambda: torch.autograd.grad(y, leaves, cot, retain_graph=True), stream=stream)
    # the backward's two parts alone: the other kernel, and the dbasis product
    g_codes, g_wave = randn(8, 253, 258), randn(8, t_train)
    parts = {
        "framed_matmul": (
            lambda: decode_ola(g_codes, stft.T, 64, t_train),
            lambda: torch.einsum("bnw,bnk->wk", frame_signal(x.detach(), 256, 64), g_codes)),
        "decode_ola": (
            lambda: framed_matmul(g_wave, syn.T, 64),
            lambda: torch.einsum("bnk,bnw->kw", codes.detach(), frame_signal(g_wave, 256, 64))),
    }
    for name, (kernel, dbasis) in parts.items():
        times[name]["backward_kernel_ms"] = time_ms(kernel)
        times[name]["backward_dbasis_ms"] = time_ms(dbasis)
        say(f"  {name} backward at the training shape: {times[name]['backward_ms']:.4f} ms "
            f"(the other kernel {times[name]['backward_kernel_ms']:.4f} ms, dbasis "
            f"{times[name]['backward_dbasis_ms']:.4f} ms; plain autograd "
            f"{times[name]['backward_plain_ms']:.4f} ms)")
    return {"checks": out, "times": times}


def time_pair(x, enc, codes, dec, hop: int, length: int, force: bool = False) -> dict:
    """B1 on ``x`` with ``enc`` and B2 on ``codes`` with ``dec``, each timed
    beside its plain version, its library call (cuDNN, TF32 off, channels
    first) and its bounds."""
    from amss_tpu_torch.ops.kernels.framed_matmul import framed_matmul, framed_matmul_ref
    from amss_tpu_torch.ops.kernels.ola import decode_ola, decode_ola_ref
    from amss_tpu_torch.utils.timing import time_ms

    win, k = enc.shape
    b, nf = x.shape[0], 1 + (x.shape[1] - win) // hop
    b2 = codes.shape[0]
    w_conv = enc.T.contiguous()[:, None, :]
    codes_t = codes.transpose(1, 2).contiguous()
    w_t = dec[:, None, :].contiguous()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        b1_lib = time_ms(lambda: F.conv1d(x[:, None, :], w_conv, stride=hop))
        b2_lib = time_ms(lambda: F.conv_transpose1d(codes_t, w_t, stride=hop)[:, 0, :length])
    return {
        "framed_matmul": dict(
            shape=f"x {list(x.shape)} x enc {list(enc.shape)}, hop {hop}",
            ms=time_ms(lambda: framed_matmul(x, enc, hop, force=force)),
            plain_ms=time_ms(lambda: framed_matmul_ref(x, enc, hop)), library_ms=b1_lib,
            **bound(2.0 * b * nf * k * win, 4.0 * (x.numel() + enc.numel() + b * nf * k))),
        "decode_ola": dict(
            shape=f"codes {list(codes.shape)} x dec {list(dec.shape)}, hop {hop} -> {length}",
            ms=time_ms(lambda: decode_ola(codes, dec, hop, length=length, force=force)),
            plain_ms=time_ms(lambda: decode_ola_ref(codes, dec, hop, length)),
            library_ms=b2_lib,
            **bound(2.0 * b2 * codes.shape[1] * codes.shape[2] * dec.shape[1],
                    4.0 * (codes.numel() + dec.numel() + b2 * length))),
    }


def phase_kernels_c2(gen: torch.Generator) -> dict:
    """B1 and B2 with c2_adapt's learned bases (enc [256, 256], dec [256,
    256], stride 64) at c2's serving and training shapes: forward against the
    plain versions, gradients against their autograd, and the serving shape
    timed beside the plain version, the library call and the bounds."""
    from amss_tpu_torch.ckpt.checkpoint import load_params
    from amss_tpu_torch.ops.kernels.framed_matmul import framed_matmul, framed_matmul_ref
    from amss_tpu_torch.ops.kernels.ola import decode_ola, decode_ola_ref

    dev = torch.device("cuda")

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    front = load_params(C2_CKPT)["front"]
    enc = torch.as_tensor(front["enc"], device=dev)
    dec = torch.as_tensor(front["dec"], device=dev)
    hop, length = 64, SECONDS * SAMPLE_RATE
    say("c2: B1 framed_matmul with the learned encoder vs framed_matmul_ref")
    x = randn(BATCH, length, scale=0.3)
    z = framed_matmul(x, enc, hop)
    b1_err = check(f"enc [256, 256] [8, 64000] (c2 serving; |out| <= {float(z.abs().max()):.3g})",
                   z, framed_matmul_ref(x, enc, hop), 2e-4)
    for shape, what in (((8, 16384), "c2 training mixture"), ((16, 16384), "c2 sources, AE")):
        xs = randn(*shape, scale=0.3)
        check(f"enc [256, 256] {list(shape)} ({what})", framed_matmul(xs, enc, hop),
              framed_matmul_ref(xs, enc, hop), 2e-4)
    say("c2: B2 decode_ola with the learned decoder vs decode_ola_ref")
    # unpooled, signed codes of 8 utterances x 2 speakers: T' = 996 (997 trimmed to pool 2)
    codes = torch.cat([z[:, :996], 0.5 * z[:, :996]]).contiguous()
    y = decode_ola(codes, dec, hop, length=length)
    b2_err = check(f"dec [256, 256] [16, 996, 256] -> 64000 (c2 serving; "
                   f"|out| <= {float(y.abs().max()):.3g})", y,
                   decode_ola_ref(codes, dec, hop, length), 2e-4)
    zt = randn(8, 252, 256, scale=0.3)
    check("dec [256, 256] [8, 252, 256] -> 16384 (c2 recon)", decode_ola(zt, dec, hop, 16384),
          decode_ola_ref(zt, dec, hop, 16384), 2e-4)

    out = time_pair(x, enc, codes, dec, hop, length)
    out["framed_matmul"].update(max_abs_err=b1_err, tol=2e-4)
    out["decode_ola"].update(max_abs_err=b2_err, tol=2e-4)

    say("c2: gradients with the learned bases vs autograd of the plain versions")
    grads = {"framed_matmul": [], "decode_ola": []}
    for what, xg in (("x [8, 16384] enc [256, 256] (c2 training)", randn(8, 16384, scale=0.3)),
                     ("x [16, 16384] enc [256, 256] (c2_pretrain)", randn(16, 16384, scale=0.3))):
        cot = randn(xg.shape[0], 1 + (xg.shape[1] - 256) // hop, 256)
        grads["framed_matmul"].append(grad_check(
            what, lambda a, e: framed_matmul(a, e, hop), lambda a, e: framed_matmul_ref(a, e, hop),
            [xg, enc], cot, 2e-4, decode_ola))
    for what, cg, n in (("codes [8, 252, 256] dec [256, 256] -> 16384 (c2 recon)",
                         randn(8, 252, 256, scale=0.3), 16384),
                        ("codes [16, 252, 256] dec [256, 256] -> 16384 (c2_pretrain)",
                         randn(16, 252, 256, scale=0.3), 16384),
                        ("codes [16, 996, 256] dec [256, 256] -> 64000 (c2 serving)",
                         codes, length)):
        cot = randn(cg.shape[0], n)
        grads["decode_ola"].append(grad_check(
            what, lambda c, d, n=n: decode_ola(c, d, hop, n),
            lambda c, d, n=n: decode_ola_ref(c, d, hop, n), [cg, dec], cot, 2e-4, framed_matmul))
    for name, checks in grads.items():
        out[name]["grad_checks"] = checks
    return out


def check_kmeans_needs_no_host_sync(gen: torch.Generator) -> None:
    """k-means at the main path's size under CUDA's sync debug mode "error":
    any operation that waits for the device on the host raises."""
    from amss_tpu_torch.ops.kernels.kmeans import (
        SOFT_LAUNCHES, fit_launches, kmeans, kmeans_launches, soft_assignments)

    n = 997 * 129
    v = torch.randn(BATCH, n, 40, generator=gen, device="cuda")
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    w = (torch.rand(BATCH, n, generator=gen, device="cuda") > 0.3).float()
    torch.cuda.synchronize()
    before = kmeans_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cent, _ = kmeans(v, k=2, iters=10, weights=w)
        soft_assignments(v, cent, tau=0.5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launched = kmeans_launches() - before
    if launched != fit_launches(2, 10) + SOFT_LAUNCHES:
        raise AssertionError(f"k-means + soft masks launched {launched} kernels")
    say(f"  k-means + soft masks [8, 128613, 40]: no host sync, {launched} kernel launches")


def phase_kmeans(gen: torch.Generator) -> dict:
    """The k-means kernels against the plain version at the serving cell's
    shape (K 2, E 40), at K 3 / E 20, and at the cell's shape on unit-norm
    embeddings (``tools/kmeans_check.py``); the first two timed beside it."""
    from amss_tpu_torch.ops import kmeans as plain
    from amss_tpu_torch.ops.kernels.kmeans import kmeans, soft_assignments
    from amss_tpu_torch.tools.kmeans_check import blobs, compare_with_plain, failures
    from amss_tpu_torch.utils.timing import time_ms

    out = {}
    for k, e, unit in ((2, 40, False), (3, 20, False), (2, 40, True)):
        x, w = blobs(BATCH, KMEANS_N, e, k, gen, KMEANS_PAD, unit)
        r = compare_with_plain(x, w, k, tau=0.5, tol=KMEANS_TOL)
        what = f"K {k} E {e} [{BATCH}, {KMEANS_N}, {e}]" + (" unit norm" if unit else "")
        say(f"  {what}: first seed the plain version's: {r['first_seed_equal']}, all seeds: "
            f"{r['seeds_equal']}; centroids {r['centroid_rel']:.3e} of their norm, masks "
            f"{r['mask_err']:.3e} (tol {KMEANS_TOL:g}); assignments differing off "
            f"{r['near_ties']} near ties: {r['assign_diff']}; bit-identical on a second run: "
            f"{r['repeats']}; launches {r['launches']}")
        failed = failures(r, k)
        if failed:
            raise AssertionError(f"k-means {what} against the plain version: {failed}")
        name = f"k{k}_e{e}" + ("_unit" if unit else "")
        out[name] = dict(shape=[BATCH, KMEANS_N, e], k=k, centroid_rel_err=r["centroid_rel"],
                         mask_err=r["mask_err"], near_ties=r["near_ties"],
                         first_seed_equal=r["first_seed_equal"], seeds_equal=r["seeds_equal"],
                         repeats=r["repeats"], launches=r["launches"], tol=KMEANS_TOL)
        if unit:
            continue
        nbytes = 4.0 * x.numel()
        c = kmeans(x, k, 10, w)[0]
        fit = dict(ms=time_ms(lambda: kmeans(x, k, 10, w), calls=5),
                   plain_ms=time_ms(lambda: plain.kmeans(x, k, 10, w), calls=2, rounds=3),
                   passes=k + 10 + 1)
        fit["bound_ms"] = fit["passes"] * nbytes / PEAK_HBM_BYTES * 1e3
        soft = dict(ms=time_ms(lambda: soft_assignments(x, c, 0.5), calls=5),
                    plain_ms=time_ms(lambda: plain.soft_assignments(x, c, 0.5), calls=5),
                    passes=2)
        soft["bound_ms"] = (2 * nbytes + 4.0 * BATCH * KMEANS_N * k) / PEAK_HBM_BYTES * 1e3
        for label, t in (("fit", fit), ("soft masks", soft)):
            t["roofline_share"] = t["bound_ms"] / t["ms"]
            say(f"  {what} {label}: {t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['passes']} "
                f"reads of x; {100 * t['roofline_share']:.1f}%), plain {t['plain_ms']:.4f} ms")
        out[name].update(fit=fit, soft=soft)
        del x, w, c
    return out


def _eager_ms(fn, calls: int = 10) -> float:
    """ms a call of ``fn`` launched eagerly, ``calls`` in a row between CUDA
    events after warm-up: the host's launching included, as serving pays it."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def phase_blstm(gen: torch.Generator) -> dict:
    """The BLSTM's recurrence kernel against its plain version (``BLSTM.loop``)
    and cuDNN's packed path at deep clustering's serving shape on the card,
    and ms a layer of each."""
    from amss_tpu_torch.models.blstm import BLSTM
    from amss_tpu_torch.ops.kernels.blstm import bilstm_layer

    b, t, n_in = BLSTM_SHAPE
    hd = BLSTM_HIDDEN
    m = BLSTM(n_in, hd, 2)
    m.init_parameters(torch.Generator().manual_seed(0))
    m = m.cuda().eval()
    x = torch.randn(b, t, n_in, generator=gen, device="cuda")
    mask = torch.ones(b, t, device="cuda")
    mask[:, t - BLSTM_PAD:] = 0.0
    lengths = torch.full((b,), t - BLSTM_PAD, dtype=torch.int64)
    with torch.no_grad():
        if m.path(x) != "kernel":
            raise AssertionError(f"the serving shape takes the {m.path(x)} path, not the kernel")
        before = bilstm_layer.launches
        got = m(x, mask)
        again = m(x, mask)
        if bilstm_layer.launches - before != 4:
            raise AssertionError(f"two calls launched {bilstm_layer.launches - before} kernels")
        repeats = bool(torch.equal(got, again))
        errs = {}
        for name, want in (("plain", m.loop(x, mask)), ("packed", m.packed(x, mask, lengths))):
            errs[name] = max_err(got, want) / float(want.abs().max())
        fwd, bwd = m._weights(0, False), m._weights(0, True)
        ms = _eager_ms(lambda: bilstm_layer(x, mask, fwd, bwd))
        plain_ms = _eager_ms(lambda: m._layer_loop(x, mask, 0), calls=2)
        packed_ms = _eager_ms(lambda: m.packed(x, mask, lengths, 0))
    say(f"  BLSTM [{b}, {t}, {n_in}] -> 2 x {hd}, 2 layers: kernel against the plain loop "
        f"{errs['plain']:.3e} and against packed {errs['packed']:.3e} of the peak (tol "
        f"{BLSTM_TOL:g}), bit-identical on a second run: {repeats}")
    if not (max(errs.values()) <= BLSTM_TOL and repeats):
        raise AssertionError(f"the BLSTM kernel: errors {errs}, repeats {repeats}")
    # a layer's products: the projection and the recurrence, both directions
    flops = 2.0 * b * t * n_in * 8 * hd + 2 * t * 8.0 * b * hd * hd
    out = dict(shape=[b, t, n_in], hidden=hd, layers=2, rel_err=errs["plain"],
               rel_err_packed=errs["packed"], tol=BLSTM_TOL, repeats=repeats, ms_per_layer=ms,
               plain_ms_per_layer=plain_ms, packed_ms_per_layer=packed_ms, step_us=1e3 * ms / t,
               flops_per_layer=flops, fp32_bound_ms=flops / PEAK_FP32_FLOPS * 1e3)
    say(f"  a layer: kernel {ms:.4f} ms ({out['step_us']:.3f} us a step, GEMM included), plain "
        f"loop {plain_ms:.4f} ms, packed {packed_ms:.4f} ms; FLOP / 67 TFLOP/s "
        f"{out['fp32_bound_ms']:.4f} ms")
    return out


def phase_blstm_rows(gen: torch.Generator) -> dict:
    """The row-parallel BLSTM kernel against its plain version (``BLSTM.loop``)
    and cuDNN's packed path at DPRNN-TasNet's cell shapes on the card, ms a
    layer of each, and the layer's bound by the kernel table's rule (3xTF32
    and bytes, the projection included, valid steps only)."""
    from amss_tpu_torch.models.blstm import BLSTM
    from amss_tpu_torch.ops.kernels.blstm import MAX_ROWS, bilstm_layer

    hd = BLSTM_ROWS_HIDDEN
    out = {}
    for name, (b, t, n_in, valid) in BLSTM_ROWS_SHAPES.items():
        m = BLSTM(n_in, hd, 1)
        m.init_parameters(torch.Generator().manual_seed(b))
        m = m.cuda().eval()
        x = torch.randn(b, t, n_in, generator=gen, device="cuda")
        lengths = torch.full((b,), t if valid is None else valid, dtype=torch.int64)
        mask = None
        if valid is not None:
            mask = torch.ones(b, t, device="cuda")
            mask[:, valid:] = 0.0
        fwd, bwd = m._weights(0, False), m._weights(0, True)
        with torch.no_grad():
            if b <= MAX_ROWS or m.path(x) != "kernel":
                raise AssertionError(f"{name} rows take the {m.path(x)} path at {b} rows")
            before = (bilstm_layer.launches, bilstm_layer.rows_launches)
            got = m(x, mask)
            again = m(x, mask)
            launched = (bilstm_layer.launches - before[0], bilstm_layer.rows_launches - before[1])
            if launched != (0, 2):
                raise AssertionError(f"{name}: two calls launched {launched} kernels (few rows, "
                                     f"many rows), want (0, 2)")
            repeats = bool(torch.equal(got, again))
            errs = {}
            for kind, want in (("plain", m.loop(x, mask)), ("packed", m.packed(x, mask, lengths))):
                errs[kind] = max_err(got, want) / float(want.abs().max())
            ms = _eager_ms(lambda: bilstm_layer(x, mask, fwd, bwd))
            w_ih, bias = torch.cat([fwd[0], bwd[0]]).T, torch.cat([fwd[2], bwd[2]])
            x2 = x.reshape(b * t, n_in)
            proj_ms = _eager_ms(lambda: torch.addmm(bias, x2, w_ih))
            packed_ms = _eager_ms(lambda: m.packed(x, mask, lengths, 0))
            plain_ms = _eager_ms(lambda: m._layer_loop(x, mask, 0), calls=2)
        # the layer's products over its valid steps, both directions: the
        # projection and the recurrence; its bytes: x, the output, the mask
        # and the weights
        steps = valid or t
        rec_flops = 2 * steps * 8.0 * b * hd * hd
        flops = 2.0 * b * steps * n_in * 8 * hd + rec_flops
        nbytes = 4.0 * (b * t * (n_in + 2 * hd + (mask is not None))
                        + 2 * 4 * hd * (n_in + hd + 1))
        r = dict(shape=[b, t, n_in], hidden=hd, valid_steps=steps, rel_err=errs["plain"],
                 rel_err_packed=errs["packed"], tol=BLSTM_TOL, repeats=repeats,
                 ms_per_layer=ms, projection_ms=proj_ms, recurrence_ms=ms - proj_ms,
                 packed_ms_per_layer=packed_ms, plain_ms_per_layer=plain_ms,
                 flops_per_layer=flops, bytes_per_layer=nbytes, **bound(flops, nbytes),
                 recurrence_flops=rec_flops,
                 recurrence_fp32_ms=rec_flops / PEAK_FP32_FLOPS * 1e3)
        say(f"  BLSTM {name} [{b}, {t}, {n_in}] -> 2 x {hd}: the row-parallel kernel against "
            f"the plain loop {errs['plain']:.3e} and against packed {errs['packed']:.3e} of the "
            f"peak (tol {BLSTM_TOL:g}), bit-identical on a second run: {repeats}; a layer "
            f"{ms:.4f} ms (its GEMM {proj_ms:.4f}), packed {packed_ms:.4f} ms, the plain loop "
            f"{plain_ms:.4f} ms; bound {r['bound_ms']:.4f} ms ({r['bound_by']}, 3xTF32), the "
            f"recurrence's FLOP / 67 TFLOP/s {r['recurrence_fp32_ms']:.4f} ms")
        if not (max(errs.values()) <= BLSTM_TOL and repeats):
            raise AssertionError(f"the row-parallel BLSTM kernel at {name}: errors {errs}, "
                                 f"repeats {repeats}")
        out[name] = r
    return out


def blstm_per_call(model) -> int:
    """The BLSTM kernel's launches in one default ``separate`` call at phase
    3's batch: one a layer of a float32 BLSTM trunk, none elsewhere."""
    sep = model.cfg.sep
    float32 = getattr(model, "compute_dtype", torch.float32) == torch.float32
    return sep.layers if sep.trunk == "blstm" and float32 else 0


def kmeans_per_call(model) -> int:
    """The k-means kernels' launches in one default ``separate`` call: deep
    clustering's fit and soft masks, L41's blind fit, none elsewhere."""
    from amss_tpu_torch.models.dpcl import DPCLModel
    from amss_tpu_torch.models.l41 import L41Model
    from amss_tpu_torch.ops.kernels.kmeans import SOFT_LAUNCHES, fit_launches

    k = model.cfg.nb_speakers
    if isinstance(model, DPCLModel):
        return fit_launches(k, 10) + SOFT_LAUNCHES
    return fit_launches(k, 10) if isinstance(model, L41Model) else 0


def phase_speed(model, per_call: dict | None = None) -> tuple[dict, dict]:
    """Serve phase 3's utterances twice; ``per_call`` is each kernel's
    launches per batch call (1 each of B1 and B2 by default, and none of the
    optimizer's pair, as in all serving); the k-means kernels' are
    ``kmeans_per_call``'s, the BLSTM kernel's ``blstm_per_call``'s."""
    from amss_tpu_torch.infer.streaming import BucketSpec, StreamingSeparator
    from amss_tpu_torch.ops.kernels.blstm import bilstm_layer
    from amss_tpu_torch.ops.kernels.kmeans import kmeans_launches

    t = SECONDS * SAMPLE_RATE
    rng = np.random.default_rng(0)
    waves = [rng.standard_normal(t).astype(np.float32) * 0.3 for _ in range(N_UTTS)]
    sep = StreamingSeparator(model, sample_rate=SAMPLE_RATE, buckets=BucketSpec(lengths=(t,)))
    calls = N_UTTS // BATCH

    def counts():
        return {**launch_counts(), "kmeans": kmeans_launches() - k0,
                "blstm": bilstm_layer.launches - b0}

    reset_launches()
    k0, b0 = kmeans_launches(), bilstm_layer.launches
    est = sep.separate_all(waves, max_batch=BATCH)  # pass 1 warms the one shape
    after1 = counts()
    rtf1 = sep.meter.rtf
    sep.meter.compute_seconds = sep.meter.audio_seconds = 0.0
    sep.meter.utterances = sep.meter.calls = 0
    est = sep.separate_all(waves, max_batch=BATCH)
    launches = counts()

    per_call = {**(per_call or {"framed_matmul": 1, "decode_ola": 1, "multi_adam": 0}),
                "kmeans": kmeans_per_call(model), "blstm": blstm_per_call(model)}
    for n in launches:
        k = per_call[n]
        if after1[n] != k * (calls + 1) or launches[n] - after1[n] != k * calls:
            raise AssertionError(
                f"{n}: launches {after1[n]} after pass 1 (want {k} x ({calls} + 1 warm-up)) "
                f"and {launches[n] - after1[n]} in pass 2 (want {k} x {calls})")
    s = model.cfg.nb_speakers
    if len(est) != N_UTTS or any(e.shape != (s, t) for e in est):
        raise AssertionError("separate_all returned the wrong shapes")
    if not all(np.isfinite(e).all() for e in est):
        raise AssertionError("separate_all returned non-finite samples")
    m = sep.meter
    out = dict(rtf_pass1=rtf1, rtf_pass2=m.rtf, utterances_per_s=m.utterances_per_sec,
               warmup_s=m.warmup_seconds, compute_s_pass2=m.compute_seconds)
    return out, launches


def quality_mixtures(s: int = 2, n: int | None = None) -> np.ndarray:
    """bench.py's protocol: ``n`` (QUALITY_N) sets of ``s`` v2 speakers of
    QUALITY_T samples from seeds ``9000 + s·i + j``, ``[n, s, T]``."""
    from amss_tpu_torch.data.synthetic import synth_speaker_wave_v2

    n = n or QUALITY_N
    return np.stack([
        np.stack([synth_speaker_wave_v2(9000 + s * i + j, n_samples=QUALITY_T) for j in range(s)])
        for i in range(n)
    ]).astype(np.float32)


def phase_quality(model, keep: dict | None = None) -> dict:
    """PIT SI-SDRi of ``model`` on bench.py's protocol for its number of
    speakers, served by StreamingSeparator in batches of BATCH; ``keep``
    receives the references, mixtures and estimates."""
    from amss_tpu_torch.infer.streaming import BucketSpec, StreamingSeparator
    from amss_tpu_torch.ops.metrics import sdr_improvement

    refs = quality_mixtures(model.cfg.nb_speakers)
    mixes = refs.sum(axis=1)
    sep = StreamingSeparator(model, sample_rate=SAMPLE_RATE,
                             buckets=BucketSpec(lengths=(QUALITY_T,)))
    est = np.stack(sep.separate_all(list(mixes), max_batch=BATCH))
    if keep is not None:
        keep.update(refs=refs, mixes=mixes, est=est)
    imp = sdr_improvement(torch.from_numpy(est).double(), torch.from_numpy(refs).double(),
                          torch.from_numpy(mixes).double()).numpy()
    boot = np.random.default_rng(0).choice(imp, size=(10000, imp.size)).mean(axis=1)
    lo, hi = np.percentile(boot, [2.5, 97.5])
    return dict(si_sdri_db=float(imp.mean()), ci95=[float(lo), float(hi)], n=int(imp.size))


def unread_parameters(model) -> set:
    """The trainable parameters whose gradient is None because the loss never
    reads them: the autoencoder's smoothing filter (its loss never reads the
    features), and TasNet's last residual conv (only the last block's skip
    output reaches the masks; the dual-path trunks read all theirs)."""
    if model.cfg.kind == "adapt_ae":
        return {"front.smooth"}
    if model.cfg.kind == "tasnet" and model.cfg.sep.trunk == "tcn":
        last = f"tcn.blocks.{len(model.tcn.blocks) - 1}.pw_res."
        return {last + "weight", last + "bias"}
    return set()


def cancelled_gradients(model) -> set:
    """The trainable parameters whose gradient is 0 in exact arithmetic, so
    that what either side computes is rounding noise: a bias that adds the
    same logit to every entry a softmax normalises over (the enhancer's delta
    projection, over the sources; the DPT's key projection, over a query's
    keys).  Their error is held against the largest gradient of all."""
    if model.cfg.kind == "enhance":
        return {"proj.bias"}
    return {n for n, _ in model.named_parameters() if n.endswith(".attn.wk.bias")}


def card_and_cpu_step(tr, state0: dict, batch0, prepare=None, key=None) -> tuple:
    """The loss, its terms and every gradient of one step from ``state0`` on
    ``batch0`` (a host batch), on the card (the trainer's model) and on a CPU
    twin: ``((loss, terms, grads) card, (loss, terms, grads) CPU)``, the
    gradients on the host (None where the loss reads no parameter)."""
    from amss_tpu_torch.train.engine import make_model

    def loss_and_grads(model, device):
        model.train()
        if prepare is not None:
            prepare(model, device)
        batch = tr._dequantize({k: v.to(device) for k, v in tr._device_batch(batch0).items()})
        loss, metrics = model.loss_from_batch(batch, rng=key)
        loss.backward()
        grads = {n: None if p.grad is None else p.grad.detach().cpu()
                 for n, p in model.named_parameters() if p.requires_grad}
        return float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()}, grads

    tr.load_state(state0)
    card = loss_and_grads(tr.model, tr.device)
    for p in tr.model.parameters():
        p.grad = None
    cpu = make_model(tr.recipe.model, tr.recipe.base_run, "cpu")
    # the state holds every parameter; the CPU twin builds its own buffers
    # (the fixed STFT bases) and nothing else may be left out
    keys = cpu.load_state_dict({n: v.cpu() for n, v in state0["params"].items()}, strict=False)
    buffers = {n for n, _ in cpu.named_buffers()}
    if keys.unexpected_keys or set(keys.missing_keys) - buffers:
        raise AssertionError(f"CPU twin: missing {keys.missing_keys}, "
                             f"unexpected {keys.unexpected_keys}")
    return card, loss_and_grads(cpu, torch.device("cpu"))


def first_step_matches_cpu(tr, state0: dict, batch0, grad_tol: float = STEP_GRAD_TOL,
                           prepare=None, key=None) -> dict:
    """The card's first step against the same step on the CPU through the
    port's plain path (plain kernels, the BLSTM as a loop), from the same init
    and batch: the loss, each term of it, and every gradient.  Both sides get
    ``key``; by default neither has one, so dropout and the corruptions are
    off.  A key may only reach host draws (dropped sources), which the card
    and the CPU draw alike.  ``prepare(model, device)`` runs on each model
    before its step.

    The autoencoder's loss, -SI-SDR + 10 L2, nearly cancels at init (about
    0.007 from terms of about 1.2), so it is held relative to the size of its
    terms, |neg_si_sdr| + 10 l2; each term is held relative to itself."""
    (loss_gpu, terms_gpu, grads_gpu), (loss_cpu, terms_cpu, grads_cpu) = card_and_cpu_step(
        tr, state0, batch0, prepare, key)
    scale = abs(loss_cpu)
    if "neg_si_sdr" in terms_cpu:
        scale = abs(terms_cpu.pop("neg_si_sdr")) + 10.0 * abs(terms_cpu["l2"])
        terms_cpu.pop("ae_loss")
    rel = abs(loss_gpu - loss_cpu) / scale
    say(f"  first step: loss card {loss_gpu:.7f} cpu {loss_cpu:.7f} ({rel:.2e} of {scale:.4g}, "
        f"tol {STEP_LOSS_TOL:g})")
    if not rel <= STEP_LOSS_TOL:
        raise AssertionError(f"first step loss differs from the CPU's by {rel:.3e}")
    for k, v in terms_cpu.items():
        if not abs(terms_gpu[k] - v) <= STEP_LOSS_TOL * abs(v):
            raise AssertionError(f"first step {k}: card {terms_gpu[k]} cpu {v}")
    if set(grads_gpu) != set(grads_cpu):
        raise AssertionError(f"gradients on the card {sorted(grads_gpu)}, on the CPU "
                             f"{sorted(grads_cpu)}")
    # every trainable parameter has a gradient, save those the loss never reads
    no_grad = unread_parameters(tr.model)
    for where, grads in (("card", grads_gpu), ("CPU", grads_cpu)):
        missing = {n for n, g in grads.items() if g is None}
        if missing != no_grad:
            raise AssertionError(f"first step on the {where}: no gradient for "
                                 f"{sorted(missing)}, want none for {sorted(no_grad)}")
    worst = 0.0
    cancelled = cancelled_gradients(tr.model)
    top = max(float(g.abs().max()) for g in grads_cpu.values() if g is not None)
    for n, g in grads_cpu.items():
        if g is None:
            continue
        scale = top if n in cancelled else float(g.abs().max())
        err = max_err(grads_gpu[n], g) / scale
        worst = max(worst, err)
        if not err <= grad_tol:
            raise AssertionError(f"first step gradient {n}: {err:.3e} of {scale:.3g} "
                                 f"> {grad_tol}")
    say(f"  first step: {len(grads_cpu) - len(no_grad)} gradients, worst {worst:.2e} of each tensor's "
        f"largest CPU magnitude (tol {grad_tol:g}; {len(cancelled)} whose exact gradient is 0 "
        f"held against the largest of all, {top:.3g})")
    return dict(loss_card=loss_gpu, loss_cpu=loss_cpu, loss_rel_err=rel, grad_worst_rel_err=worst)


def check_train_step_needs_no_host_sync(tr, batch0) -> dict:
    """One train step under CUDA's sync debug mode "error"; returns each
    kernel's launches in that step."""
    batch = tr._device_batch(batch0)
    torch.cuda.synchronize()
    before = launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tr._train_step(batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    per_step = {n: k - before[n] for n, k in launch_counts().items()}
    say(f"  one train step (front, trunk, loss, backward, clip, Adam): no host sync; "
        f"launches {per_step}")
    return per_step


def check_checkpoint_reloads(tr, final: dict, steps: int) -> None:
    """The run dir's latest checkpoint is ``final`` bit for bit."""
    from amss_tpu_torch.ckpt.checkpoint import restore_checkpoint

    tree, manifest = restore_checkpoint(tr.dir)
    want_tree = tr.state_tree(final)

    def same(a, b, path=""):
        if isinstance(b, dict):
            if not isinstance(a, dict) or list(a) != sorted(b):
                raise AssertionError(f"checkpoint {path}: keys {list(a)} != {sorted(b)}")
            for k in b:
                same(a[k], b[k], f"{path}/{k}")
        elif not np.array_equal(np.asarray(a), np.asarray(b)) or \
                np.asarray(a).dtype != np.asarray(b).dtype:
            raise AssertionError(f"checkpoint {path} does not reload bit for bit")

    same(tree, want_tree)
    if manifest["step"] != steps:
        raise AssertionError(f"ckpt_latest is at step {manifest['step']}")
    say(f"  ckpt_latest.msgpack (step {manifest['step']}) reloads bit for bit")


def training_corpus(workdir: str, n_speakers: int = TRAIN_SPEAKERS, name: str = "corpus"):
    from amss_tpu_torch.data.synthetic import make_synthetic_corpus

    t0 = time.perf_counter()
    store = make_synthetic_corpus(os.path.join(workdir, name), n_speakers=n_speakers,
                                  seconds_per_speaker=TRAIN_SECONDS, seed=0, version=1)
    say(f"  corpus {n_speakers} x {TRAIN_SECONDS:g} s: {time.perf_counter() - t0:.2f} s")
    return store


def window_ms_per_step(run_dir: str, skip: set) -> float:
    """The median ms per step over the logged windows of ``fit``, leaving out
    the windows at the steps in ``skip`` (each fit's first holds its
    warm-up)."""
    rates = [m["train/steps_per_sec"] for m in
             (json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl")))
             if "train/steps_per_sec" in m and m["step"] not in skip]
    return 1e3 / float(np.median(rates))


def phase_train(store, workdir: str) -> tuple[dict, dict]:
    """c1 at full width through Trainer.fit; returns (results, launches)."""
    from amss_tpu_torch.configs.recipes import c1_stft_dpcl
    from amss_tpu_torch.infer.streaming import BucketSpec, StreamingSeparator
    from amss_tpu_torch.ops.kernels.framed_matmul import framed_matmul
    from amss_tpu_torch.ops.metrics import sdr_improvement
    from amss_tpu_torch.train.engine import Trainer
    from amss_tpu_torch.utils.timing import time_ms
    from amss_tpu_torch.weights import load_model_from_run

    recipe = c1_stft_dpcl(steps=TRAIN_STEPS, valid_every=TRAIN_VALID_EVERY)
    t = recipe.train
    tr = Trainer(recipe, store, workdir=os.path.join(workdir, "runs"))
    say(f"  run dir {os.path.basename(tr.dir)}")

    state0 = tr.init_state()
    batch0 = tr.mixer.batch("train", 0, t.batch_size)
    step_check = first_step_matches_cpu(tr, state0, batch0)
    per_step = check_train_step_needs_no_host_sync(tr, batch0)
    if per_step != {"framed_matmul": 2, "decode_ola": 0, "multi_adam": 2}:
        raise AssertionError(f"a c1 train step launched {per_step}")
    tr.load_state(state0)
    valid0 = tr.valid_loss()

    final, launches, fit_s, peak = _fit_counted(tr, state0)

    n_valid = -(-t.steps // t.valid_every)
    # two STFTs (mixture, sources) per train step and per valid batch; the
    # image summaries of each validation add three (mixture, separate, its
    # first speaker) and separate's iSTFT one B2; the optimizer's pair a step
    want = {"framed_matmul": 2 * t.steps + 2 * t.valid_steps * n_valid + 3 * n_valid,
            "decode_ola": n_valid, "multi_adam": 2 * t.steps}
    if launches != want:
        raise AssertionError(f"training launches {launches}, want {want}")

    metrics = [json.loads(line) for line in open(os.path.join(tr.dir, "metrics.jsonl"))]
    valid = [m["valid/loss"] for m in metrics if "valid/loss" in m]
    ms_step = window_ms_per_step(tr.dir, skip={TRAIN_LOG_EVERY})
    if len(valid) != n_valid or not valid[-1] < valid0:
        raise AssertionError(f"valid loss {valid0} at init, {valid} after training")
    check_checkpoint_reloads(tr, final, t.steps)

    model = load_model_from_run(tr.dir)
    hb = tr.mixer.batch("valid", 0, t.batch_size)
    mixes = hb.sources.sum(axis=1)
    sep = StreamingSeparator(model, buckets=BucketSpec(lengths=(t.chunk_samples,)))
    est = np.stack(sep.separate_all(list(mixes), max_batch=t.batch_size))
    if est.shape != hb.sources.shape or not np.isfinite(est).all():
        raise AssertionError(f"serving the trained run gave {est.shape}")
    imp = sdr_improvement(torch.from_numpy(est).double(), torch.from_numpy(hb.sources).double(),
                          torch.from_numpy(mixes).double()).numpy()

    # B1's share of a step, from its launches and its time at the two shapes
    x = torch.from_numpy(hb.sources).to(tr.device)
    basis = tr.model.front.analysis_basis
    b1_ms = (time_ms(lambda: framed_matmul(x.sum(dim=1), basis, 64))
             + time_ms(lambda: framed_matmul(x.reshape(-1, x.shape[-1]), basis, 64)))
    out = dict(steps=t.steps, batch=t.batch_size, chunk=t.chunk_samples, fit_s=fit_s,
               ms_per_step=ms_step, steps_per_s=1e3 / ms_step, peak_bytes=peak,
               valid_loss_init=valid0, valid_loss=valid, b1_ms_per_step=b1_ms,
               b1_share=b1_ms / ms_step, served_si_sdri_db=float(imp.mean()),
               launches_per_step=per_step, **step_check)
    return out, launches


@functools.lru_cache(maxsize=1)
def long_mixtures() -> tuple[list, list]:
    """Phase 9's two-speaker mixtures of LONG_SECONDS and their sources."""
    from amss_tpu_torch.data.synthetic import synth_speaker_wave_v2

    refs = [np.stack([synth_speaker_wave_v2(LONG_SEED0 + 2 * i + j, n_samples=s * SAMPLE_RATE)
                      for j in range(2)]).astype(np.float32) for i, s in enumerate(LONG_SECONDS)]
    return [r.sum(axis=0) for r in refs], refs


def phase_long(model) -> tuple[dict, dict]:
    """c1 serving of phase 3's utterances mixed with long mixtures, twice,
    through StreamingSeparator (bucket 64000, so the long ones take
    separate_long in chunks of 64000); returns (results, launches)."""
    from amss_tpu_torch.infer.long import _group_widths, chunk_layout, separate_long
    from amss_tpu_torch.infer.streaming import BucketSpec, StreamingSeparator
    from amss_tpu_torch.ops.metrics import sdr_improvement

    t = SECONDS * SAMPLE_RATE
    t0 = time.perf_counter()
    mixes, refs = long_mixtures()
    say(f"  {len(mixes)} mixtures of {LONG_SECONDS} s: {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    shorts = [rng.standard_normal(t).astype(np.float32) * 0.3 for _ in range(N_UTTS)]
    half = N_UTTS // 2  # the long ones in the middle: results must keep input order
    waves = shorts[:half] + mixes + shorts[half:]
    sep = StreamingSeparator(model, sample_rate=SAMPLE_RATE, buckets=BucketSpec(lengths=(t,)))
    chunks = [len(chunk_layout(len(m), t)[1]) for m in mixes]
    calls = N_UTTS // BATCH + sum(len(_group_widths(n)) for n in chunks)
    warm = 1 + 2  # one bucket shape; warm_long's two group widths

    reset_launches()
    sep.separate_all(waves, max_batch=BATCH)
    after1 = launch_counts()
    sep.meter.compute_seconds = sep.meter.audio_seconds = 0.0
    sep.meter.utterances = sep.meter.calls = 0
    est = sep.separate_all(waves, max_batch=BATCH)
    launches = launch_counts()
    if launches["multi_adam"]:
        raise AssertionError(f"long-form serving launched the optimizer: {launches}")
    for n in KERNELS:
        if after1[n] != calls + warm or launches[n] - after1[n] != calls:
            raise AssertionError(
                f"{n}: launches {after1[n]} after pass 1 (want {calls} + {warm} warm-up) and "
                f"{launches[n] - after1[n]} in pass 2 (want {calls})")
    if [e.shape for e in est] != [(2, len(w)) for w in waves]:
        raise AssertionError("long-form serving returned the wrong shapes")
    if not all(np.isfinite(e).all() for e in est):
        raise AssertionError("long-form serving returned non-finite samples")
    m = sep.meter
    imp = np.array([float(sdr_improvement(torch.from_numpy(e[None]).double(),
                                          torch.from_numpy(r[None]).double(),
                                          torch.from_numpy(x[None]).double())[0])
                    for e, r, x in zip(est[half : half + len(mixes)], refs, mixes)])
    boot = np.random.default_rng(0).choice(imp, size=(10000, imp.size)).mean(axis=1)
    lo, hi = np.percentile(boot, [2.5, 97.5])

    # an utterance no longer than one chunk is one separate call
    one = separate_long(model, shorts[0], chunk=t)
    dev = next(model.parameters()).device
    want = model.separate(torch.from_numpy(shorts[0][None]).to(dev))[0].cpu().numpy()
    if not np.array_equal(one, want):
        raise AssertionError(f"separate_long of one chunk differs from separate by "
                             f"{np.abs(one - want).max()}")
    say("  separate_long of an 8 s utterance equals separate on it")
    out = dict(n_long=len(mixes), long_seconds=list(LONG_SECONDS), chunks=chunks,
               n_short=N_UTTS, rtf_pass2=m.rtf, utterances_per_s=m.utterances_per_sec,
               audio_s_pass2=m.audio_seconds, compute_s_pass2=m.compute_seconds,
               calls_pass2=m.calls, warmup_s=m.warmup_seconds, si_sdri_db=float(imp.mean()),
               ci95=[float(lo), float(hi)], n=int(imp.size), per_mixture=imp.tolist())
    return out, launches


def _fit_counted(tr, state: dict) -> tuple[dict, dict, float, int]:
    """``tr.fit(state)`` with the kernels' counts set to 0 just before it:
    (final state, launches, wall seconds, peak device bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    final = tr.fit(state, log_every=TRAIN_LOG_EVERY)
    torch.cuda.synchronize()
    return final, launch_counts(), time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def _valid_losses(run_dir: str) -> list:
    return [m["valid/loss"] for m in
            (json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl")))
            if "valid/loss" in m]


def phase_train_c2(store, workdir: str) -> tuple[dict, dict]:
    """c2_pretrain, then c2 fine-tuned from its run dir, at full width through
    Trainer.fit; returns (results, launches by path)."""
    from amss_tpu_torch.ckpt.checkpoint import restore_checkpoint
    from amss_tpu_torch.configs.recipes import c2_adapt_dpcl, c2_pretrain_adapt
    from amss_tpu_torch.train.engine import Trainer

    out, launches = {}, {}
    # -- c2_pretrain: 8 x 2 sources autoencode as 16 waves of 16384 ---------
    say("c2_pretrain (the filterbank autoencoder)")
    recipe = c2_pretrain_adapt(steps=C2_PRETRAIN_STEPS, valid_every=C2_VALID_EVERY)
    t = recipe.train
    pre = Trainer(recipe, store, workdir=os.path.join(workdir, "runs"))
    state0 = pre.init_state()
    batch0 = pre.mixer.batch("train", 0, t.batch_size)
    step_check = first_step_matches_cpu(pre, state0, batch0)
    per_step = check_train_step_needs_no_host_sync(pre, batch0)
    # B1 encodes, B2 decodes, and B2's backward runs B1 for the codes'
    # gradient; B1's own backward needs no dx (the waves are data)
    if per_step != {"framed_matmul": 2, "decode_ola": 1, "multi_adam": 2}:
        raise AssertionError(f"a c2_pretrain step launched {per_step}")
    pre.load_state(state0)
    valid0 = pre.valid_loss()
    final, got, fit_s, peak = _fit_counted(pre, state0)
    n_valid = -(-t.steps // t.valid_every)
    # per valid batch B1 + B2; per validation's image one B1 (no separate)
    want = {"framed_matmul": 2 * t.steps + (t.valid_steps + 1) * n_valid,
            "decode_ola": t.steps + t.valid_steps * n_valid, "multi_adam": 2 * t.steps}
    if got != want:
        raise AssertionError(f"c2_pretrain launches {got}, want {want}")
    valid = _valid_losses(pre.dir)
    if len(valid) != n_valid or not valid[-1] < valid0:
        raise AssertionError(f"AE valid loss {valid0} at init, {valid} after training")
    check_checkpoint_reloads(pre, final, t.steps)
    ms = window_ms_per_step(pre.dir, skip={TRAIN_LOG_EVERY})
    launches["c2_pretrain"] = got
    out["c2_pretrain"] = dict(steps=t.steps, waves=2 * t.batch_size, chunk=t.chunk_samples,
                              fit_s=fit_s, ms_per_step=ms, steps_per_s=1e3 / ms,
                              peak_bytes=peak, valid_loss_init=valid0, valid_loss=valid,
                              launches_per_step=per_step, **step_check)

    # -- c2: the front restored from the pretraining run, frozen, then free ---
    say("c2 (adaptive front + deep clustering, fine-tuned from the c2_pretrain run)")

    def c2(steps):
        r = c2_adapt_dpcl(pretrained_front=pre.dir, steps=steps, valid_every=C2_VALID_EVERY)
        return dataclasses.replace(r, freeze_front_steps=C2_FREEZE_STEPS)

    run_dir = os.path.join(workdir, "runs", "c2_finetune")
    tr = Trainer(c2(C2_FREEZE_STEPS), store, run_dir=run_dir)
    state0 = tr.init_state()
    restored = {n: v.clone() for n, v in state0["params"].items() if n.startswith("front.")}
    pre_best = restore_checkpoint(pre.dir, best=True)[0]["params"]["front"]
    for n, v in restored.items():
        if not np.array_equal(v.cpu().numpy(), pre_best[n[len("front."):]]):
            raise AssertionError(f"{n} is not the c2_pretrain run's best")
    t = tr.recipe.train
    batch0 = tr.mixer.batch("train", 0, t.batch_size)
    step_check = first_step_matches_cpu(tr, state0, batch0)
    per_step = check_train_step_needs_no_host_sync(tr, batch0)
    # B1: mixture, sources, and B2's backward (the recon term's codes); B2:
    # the reconstruction of the mixture
    if per_step != {"framed_matmul": 3, "decode_ola": 1, "multi_adam": 2}:
        raise AssertionError(f"a c2 step launched {per_step}")
    tr.load_state(state0)
    valid0 = tr.valid_loss()
    frozen, got1, fit1_s, peak1 = _fit_counted(tr, state0)
    for n, v in restored.items():
        if not torch.equal(frozen["params"][n], v):
            raise AssertionError(f"{n} moved in the {C2_FREEZE_STEPS} frozen steps")
        if frozen["opt_state"]["mu"][n].any() or frozen["opt_state"]["nu"][n].any():
            raise AssertionError(f"Adam's moments of {n} moved in the frozen steps")
    say(f"  the front (enc, dec, smooth) is bit for bit the restored one after "
        f"{C2_FREEZE_STEPS} frozen steps")
    tr = Trainer(c2(C2_STEPS), store, run_dir=run_dir)
    final, got2, fit2_s, peak2 = _fit_counted(tr, frozen)
    moved = {n: float((final["params"][n] - v).abs().max()) for n, v in restored.items()}
    if not all(m > 0 for m in moved.values()):
        raise AssertionError(f"the front did not move after the freeze: {moved}")
    say(f"  after the freeze the front moved by up to {moved}")
    got = {n: got1[n] + got2[n] for n in got1}
    n_valid = -(-C2_STEPS // t.valid_every)
    # per valid batch two B1 and one B2; per validation's images three B1
    # (mixture, separate, its first speaker) and one B2 (separate)
    want = {"framed_matmul": 3 * C2_STEPS + (2 * t.valid_steps + 3) * n_valid,
            "decode_ola": C2_STEPS + (t.valid_steps + 1) * n_valid, "multi_adam": 2 * C2_STEPS}
    if got != want:
        raise AssertionError(f"c2 launches {got}, want {want}")
    valid = _valid_losses(run_dir)
    if len(valid) != n_valid or not valid[-1] < valid0:
        raise AssertionError(f"c2 valid loss {valid0} at init, {valid} after training")
    check_checkpoint_reloads(tr, final, C2_STEPS)
    ms = window_ms_per_step(run_dir, skip={TRAIN_LOG_EVERY, C2_FREEZE_STEPS + TRAIN_LOG_EVERY})
    launches["c2_train"] = got
    out["c2"] = dict(steps=C2_STEPS, freeze_steps=C2_FREEZE_STEPS, batch=t.batch_size,
                     chunk=t.chunk_samples, fit_s=fit1_s + fit2_s, ms_per_step=ms,
                     steps_per_s=1e3 / ms, peak_bytes=max(peak1, peak2), valid_loss_init=valid0,
                     valid_loss=valid, front_moved_after_freeze=moved,
                     launches_per_step=per_step, **step_check)
    return out, launches


def _c6_bases(run: str) -> tuple[torch.Tensor, torch.Tensor, int]:
    """(enc [L, N], dec [N, L], stride) of a c6 checkpoint's front, on the card."""
    from amss_tpu_torch.ckpt.checkpoint import load_params

    with open(os.path.join(run, "config.json")) as f:
        stride = json.load(f)["model"]["front"]["stride"]
    front = load_params(run)["front"]
    return (torch.as_tensor(front["enc"], device="cuda"),
            torch.as_tensor(front["dec"], device="cuda"), stride)


def phase_kernels_c6(gen: torch.Generator) -> dict:
    """B1 and B2 forced at c6's shapes with the checkpoints' learned bases:
    the flagship's and c6_3spk's serving shapes and the c6 recipe's and the
    flagship's training shapes.  Forward against the plain versions,
    gradients against their autograd, and at the serving shapes each timed
    beside its plain version, its library call and its bound.  The gate opens
    a (win, hop) for the pair when both kernels beat their plain versions."""
    from amss_tpu_torch.ops.kernels.framed_matmul import (
        framed_matmul, framed_matmul_ref, profitable)
    from amss_tpu_torch.ops.kernels.ola import decode_ola, decode_ola_ref

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    length = SECONDS * SAMPLE_RATE
    out = {"serve": {}, "grad_checks": {"framed_matmul": [], "decode_ola": []}, "gate": {}}
    for name, run, s in (("c6_flagship", C6_FLAGSHIP, 2), ("c6_3spk", C6_3SPK, 3)):
        enc, dec, hop = _c6_bases(run)
        win = enc.shape[0]
        say(f"{name}: B1 and B2 forced, {win}/{hop}, K = {enc.shape[1]}")
        x = randn(BATCH, length, scale=0.3)
        z = framed_matmul(x, enc, hop, force=True)
        b1_err = check(f"enc {list(enc.shape)} [8, 64000] ({name} serving; |out| <= "
                       f"{float(z.abs().max()):.3g})", z, framed_matmul_ref(x, enc, hop), 2e-4)
        # the masked codes of s speakers: [B·S, T', N]
        codes = torch.cat([z * (0.5 ** i) for i in range(s)]).contiguous()
        y = decode_ola(codes, dec, hop, length=length, force=True)
        b2_err = check(f"dec {list(dec.shape)} {list(codes.shape)} -> 64000 ({name} serving; "
                       f"|out| <= {float(y.abs().max()):.3g})", y,
                       decode_ola_ref(codes, dec, hop, length), 2e-4)
        out["serve"][name] = pair = time_pair(x, enc, codes, dec, hop, length, force=True)
        b1, b2 = pair["framed_matmul"], pair["decode_ola"]
        b1.update(max_abs_err=b1_err, tol=2e-4)
        b2.update(max_abs_err=b2_err, tol=2e-4)
        k = enc.shape[1]
        measured = b1["ms"] < b1["plain_ms"] and b2["ms"] < b2["plain_ms"]
        out["gate"][f"{win}/{hop}"] = dict(kernels_win=measured, profitable=profitable(win, hop))
        for kname, r in (("B1", b1), ("B2", b2)):
            say(f"  {kname} at {name} serving ({r['shape']}): forced {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound "
                f"{r['bound_ms'] * 1e3:.3f} us ({r['bound_by']})")
        say(f"  gate at {win}/{hop}: both kernels beat their plain versions: {measured}; "
            f"profitable({win}, {hop}) = {profitable(win, hop)}")

        # gradients at the training shapes: c6 (32/16, 8 x 16384, 2 speakers)
        # and the flagship (16/8, its config's 16 x 16384)
        tb, train = (8, "c6 recipe training") if name == "c6_3spk" else (16, "flagship step")
        xt = randn(tb, 16384, scale=0.3)
        nft = 1 + (16384 - win) // hop
        cot = randn(tb, nft, k)
        what = f"x [{tb}, 16384] enc {list(enc.shape)} hop {hop} ({train})"
        out["grad_checks"]["framed_matmul"].append(grad_check(
            what, lambda a, e: framed_matmul(a, e, hop, force=True),
            lambda a, e: framed_matmul_ref(a, e, hop), [xt, enc], cot, 2e-4, decode_ola))
        ct = randn(2 * tb, nft, k, scale=0.3)
        what = f"codes [{2 * tb}, {nft}, {k}] dec {list(dec.shape)} -> 16384 ({train})"
        out["grad_checks"]["decode_ola"].append(grad_check(
            what, lambda c, d: decode_ola(c, d, hop, 16384, force=True),
            lambda c, d: decode_ola_ref(c, d, hop, 16384), [ct, dec], randn(2 * tb, 16384),
            2e-4, framed_matmul))
    return out


def _gate_launches(cfg) -> dict:
    """Each kernel's launches in one ``separate`` call of a model whose front
    is ``cfg``: one each of B1 and B2 where the gate opens the front's (win,
    hop), else 0, and none of the optimizer's pair."""
    from amss_tpu_torch.ops.kernels.framed_matmul import profitable

    k = int(profitable(cfg.front.filter_len, cfg.front.stride))
    return {"framed_matmul": k, "decode_ola": k, "multi_adam": 0}


def phase_serve_c6() -> tuple[dict, dict]:
    """c6_flagship served as phase 3 serves c1, its quality and c6_3spk's on
    phase 4's protocol, and the flagship on the card against the port on the
    CPU; returns (results, launches by path)."""
    from amss_tpu_torch.ops.blstm_bf16 import BF16_PRODUCT
    from amss_tpu_torch.ops.metrics import si_sdr
    from amss_tpu_torch.weights import load_model_from_run

    out, launches = {"bf16_product": BF16_PRODUCT}, {}
    say(f"  the TCN's bf16 products on the card: {BF16_PRODUCT}")
    model = load_model_from_run(C6_FLAGSHIP)
    per_call = _gate_launches(model.cfg)
    out["speed"], launches["c6_flagship_serve"] = phase_speed(model, per_call)
    for key, run, gate in (("quality", None, C6_QUALITY_MIN_DB),
                           ("quality_3spk", C6_3SPK, C6_3SPK_QUALITY_MIN_DB)):
        m = model if run is None else load_model_from_run(run)
        reset_launches()
        q = phase_quality(m)
        got = launch_counts()
        calls = -(-QUALITY_N // BATCH) + 1  # + the warm-up
        k = _gate_launches(m.cfg)
        if got != {n: k[n] * calls for n in k}:
            raise AssertionError(f"{key}: launches {got}, want {k} x {calls}")
        launches[f"{os.path.basename(run or C6_FLAGSHIP)}_quality"] = got
        say(f"  {os.path.basename(run or C6_FLAGSHIP)} quality (64 mixtures of "
            f"{m.cfg.nb_speakers} speakers): si_sdri {q['si_sdri_db']:.3f} dB, 95% CI "
            f"{q['ci95']} (gate {gate} dB), launches {got}")
        if not q["si_sdri_db"] >= gate:
            raise AssertionError(f"{key}: SI-SDRi {q['si_sdri_db']:.3f} dB < {gate} dB")
        out[key] = q

    mix = torch.from_numpy(quality_mixtures(2, 2).sum(axis=1))
    card = model.separate(mix.cuda()).cpu().double()
    cpu = load_model_from_run(C6_FLAGSHIP, device="cpu").separate(mix).double()
    db = si_sdr(card, cpu)
    say(f"  c6_flagship on the card against the port on the CPU, two mixtures: SI-SDR "
        f"{[round(float(v), 2) for v in db.flatten()]} dB (bound {C6_CARD_CPU_MIN_DB} dB)")
    if not bool((db >= C6_CARD_CPU_MIN_DB).all()):
        raise AssertionError(f"card against CPU: {db.tolist()} dB")
    out["card_vs_cpu_db"] = [float(v) for v in db.flatten()]
    return out, launches


def bf16_step_matches_cpu(store) -> dict:
    """One step of the flagship (bf16 operands) at its config's batch of 16 x
    16384, from the checkpoint's weights: the loss and every gradient on the
    card against the port on the CPU, the card's launches and peak memory."""
    from amss_tpu_torch.data.mixer import Mixer
    from amss_tpu_torch.utils.config import recipe_from_dict
    from amss_tpu_torch.weights import load_model_from_run

    with open(os.path.join(C6_FLAGSHIP, "config.json")) as f:
        recipe = recipe_from_dict(json.load(f))
    batch_size = recipe.train.batch_size
    sources = torch.from_numpy(Mixer(store, nb_speakers=2, chunk_samples=16384, seed=0)
                               .batch("train", 0, batch_size).sources)

    def loss_and_grads(device):
        model = load_model_from_run(C6_FLAGSHIP, device=device).train()
        loss, _ = model.loss(sources.to(device))
        loss.backward()
        skip = unread_parameters(model)
        return float(loss.detach()), {n: p.grad.detach().cpu() for n, p in model.named_parameters()
                             if n not in skip}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    loss_gpu, grads_gpu = loss_and_grads("cuda")
    torch.cuda.synchronize()
    peak, launches = torch.cuda.max_memory_allocated(), launch_counts()
    loss_cpu, grads_cpu = loss_and_grads("cpu")
    diff_db = abs(loss_gpu - loss_cpu)
    diff = sum(float(((grads_gpu[n] - g) ** 2).sum()) for n, g in grads_cpu.items())
    norm = sum(float((g**2).sum()) for g in grads_cpu.values())
    grad_rel = (diff / norm) ** 0.5
    tensor_rel = {n: float((grads_gpu[n] - g).norm() / g.norm()) for n, g in grads_cpu.items()}
    worst = max(tensor_rel, key=tensor_rel.get)
    say(f"  c6_flagship bf16 step, batch {batch_size} x 16384: loss card {loss_gpu:.6f} cpu "
        f"{loss_cpu:.6f} ({diff_db:.2e} dB apart, tol {C6_BF16_LOSS_TOL_DB:g}); gradients "
        f"{grad_rel:.3e} apart "
        f"over all {len(grads_cpu)} tensors (tol {C6_BF16_GRAD_TOL:g}), worst tensor {worst} "
        f"{tensor_rel[worst]:.3e} (tol {C6_BF16_TENSOR_TOL:g}); peak memory "
        f"{peak / 2**30:.3f} GiB; launches {launches}")
    if not diff_db <= C6_BF16_LOSS_TOL_DB:
        raise AssertionError(f"bf16 step loss: card {loss_gpu}, cpu {loss_cpu}")
    if not (grad_rel <= C6_BF16_GRAD_TOL and tensor_rel[worst] <= C6_BF16_TENSOR_TOL):
        raise AssertionError(f"bf16 step gradients {grad_rel}, {worst} {tensor_rel[worst]}")
    if not all(torch.isfinite(g).all() for g in grads_gpu.values()):
        raise AssertionError("bf16 step: non-finite gradients on the card")
    k = _gate_launches(recipe.model)
    # the forward's B1 and B2, and B2's backward through B1 (no optimizer step)
    want = {"framed_matmul": 2 * k["framed_matmul"], "decode_ola": k["decode_ola"],
            "multi_adam": 0}
    if launches != want:
        raise AssertionError(f"bf16 step launched {launches}, want {want}")
    return dict(batch=batch_size, loss_card=loss_gpu, loss_cpu=loss_cpu, loss_diff_db=diff_db,
                grad_rel_err=grad_rel, worst_tensor=worst, worst_tensor_rel_err=tensor_rel[worst],
                peak_bytes=peak, launches=launches)


def phase_train_c6(store, workdir: str) -> tuple[dict, dict]:
    """The c6 recipe at full width through Trainer.fit, then one bf16 step of
    the flagship; returns (results, launches by path)."""
    from amss_tpu_torch.configs.recipes import c6_tasnet
    from amss_tpu_torch.train.engine import Trainer

    recipe = c6_tasnet(steps=C6_STEPS, valid_every=C6_VALID_EVERY)
    t = recipe.train
    tr = Trainer(recipe, store, workdir=os.path.join(workdir, "runs"))
    say(f"  run dir {os.path.basename(tr.dir)}")
    state0 = tr.init_state()
    batch0 = tr.mixer.batch("train", 0, t.batch_size)
    step_check = first_step_matches_cpu(tr, state0, batch0, grad_tol=C6_STEP_GRAD_TOL)
    per_step = check_train_step_needs_no_host_sync(tr, batch0)
    k = _gate_launches(recipe.model)
    # the mixture's B1, the decode's B2 and B2's backward through B1 (the
    # waveform is data: B1's backward needs no dx)
    want_step = {"framed_matmul": 2 * k["framed_matmul"], "decode_ola": k["decode_ola"],
                 "multi_adam": 2}
    if per_step != want_step:
        raise AssertionError(f"a c6 step launched {per_step}, want {want_step}")
    tr.load_state(state0)
    valid0 = tr.valid_loss()
    final, launches, fit_s, peak = _fit_counted(tr, state0)
    n_valid = -(-t.steps // t.valid_every)
    # per valid batch one B1 and one B2; per validation's images three B1
    # (mixture, separate, its first speaker) and separate's B2
    want = {"framed_matmul": want_step["framed_matmul"] * t.steps
            + k["framed_matmul"] * (t.valid_steps + 3) * n_valid,
            "decode_ola": k["decode_ola"] * (t.steps + (t.valid_steps + 1) * n_valid),
            "multi_adam": 2 * t.steps}
    if launches != want:
        raise AssertionError(f"c6 training launches {launches}, want {want}")
    valid = _valid_losses(tr.dir)
    if len(valid) != n_valid or not valid[-1] < valid0:
        raise AssertionError(f"c6 valid loss {valid0} at init, {valid} after training")
    check_checkpoint_reloads(tr, final, t.steps)
    ms = window_ms_per_step(tr.dir, skip={TRAIN_LOG_EVERY})
    out = {"c6": dict(steps=t.steps, batch=t.batch_size, chunk=t.chunk_samples, fit_s=fit_s,
                      ms_per_step=ms, steps_per_s=1e3 / ms, peak_bytes=peak,
                      valid_loss_init=valid0, valid_loss=valid, launches_per_step=per_step,
                      **step_check)}
    say("c6_flagship: one bf16 step, card against CPU")
    out["c6_flagship_bf16_step"] = bf16_step_matches_cpu(store)
    return out, {"c6_train": launches,
                 "c6_flagship_bf16_step": out["c6_flagship_bf16_step"]["launches"]}


def _offline_batches(model, mixes: np.ndarray) -> np.ndarray:
    """``model.separate`` on the card in batches of BATCH: [n, T] -> [n, S, T]."""
    outs = [model.separate(torch.from_numpy(mixes[i : i + BATCH]).cuda()).cpu().numpy()
            for i in range(0, len(mixes), BATCH)]
    return np.concatenate(outs)


def _stream_err(got: np.ndarray, want: np.ndarray, what: str) -> float:
    """The largest difference of streamed from offline output, over the
    offline output's peak; raises above C7_STREAM_TOL."""
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{what}: {got.shape} (finite {np.isfinite(got).all()}), "
                             f"want {want.shape}")
    err = float(np.abs(got - want).max() / np.abs(want).max())
    say(f"  {what}: max |streamed - offline| = {err:.3e} of the peak (tol {C7_STREAM_TOL:g}; "
        f"peak {np.abs(want).max():.3g})")
    if not err <= C7_STREAM_TOL:
        raise AssertionError(f"{what}: streamed differs from offline by {err:.3e} of the peak")
    return err


def realtime_speed(model, chunk: int, streams: int) -> dict:
    """ms per push and RTF of REALTIME_SPEED_SECONDS of audio per stream
    through ``separate_streams`` (first push booked as warm-up)."""
    from amss_tpu_torch.infer.realtime import RealtimeSeparator

    rng = np.random.default_rng(1)
    t = REALTIME_SPEED_SECONDS * SAMPLE_RATE
    waves = (rng.standard_normal((streams, t)) * 0.3).astype(np.float32)
    rt = RealtimeSeparator(model, chunk_samples=chunk, n_streams=streams)
    out = rt.separate_streams(waves)
    if out.shape != (streams, model.cfg.nb_speakers, t) or not np.isfinite(out).all():
        raise AssertionError(f"realtime {chunk} x {streams}: {out.shape}")
    ms = 1e3 * rt.compute_seconds / rt._timed_pushes
    return dict(chunk=chunk, streams=streams, pushes=rt._timed_pushes, ms_per_push=ms,
                rtf=rt.rtf, ms_per_push_per_stream=ms / streams,
                latency_ms=1e3 * (chunk + rt.lag) / SAMPLE_RATE)


def phase_realtime() -> tuple[dict, dict]:
    """c7_causal offline and streamed on the card; returns (results,
    launches)."""
    from amss_tpu_torch.infer.realtime import RealtimeSeparator
    from amss_tpu_torch.infer.streaming import BucketSpec, StreamingSeparator
    from amss_tpu_torch.weights import load_model_from_run

    model = load_model_from_run(C7_CAUSAL)
    refs = quality_mixtures(2)
    mixes = refs.sum(axis=1)
    reset_launches()
    sep = StreamingSeparator(model, sample_rate=SAMPLE_RATE,
                             buckets=BucketSpec(lengths=(QUALITY_T,)))
    offline = np.stack(sep.separate_all(list(mixes), max_batch=BATCH))
    out = {}
    rt = RealtimeSeparator(model, chunk_samples=REALTIME_CHUNK)
    streamed = np.stack([rt.separate_stream(m) for m in mixes])
    out["one_stream_err"] = _stream_err(streamed, offline, f"one stream, {len(mixes)} mixtures "
                                        f"of {QUALITY_T} samples, chunk {REALTIME_CHUNK}")
    piped = np.stack([rt.separate_stream_pipelined(m) for m in mixes[:BATCH]])
    out["pipelined_err"] = _stream_err(piped, offline[:BATCH], "pipelined, 8 mixtures")
    if not np.array_equal(piped, streamed[:BATCH]):
        raise AssertionError("separate_stream_pipelined differs from separate_stream")
    long = RealtimeSeparator(model, chunk_samples=REALTIME_CHUNK, long_stream=True)
    out["long_stream_err"] = _stream_err(
        np.stack([long.separate_stream(m) for m in mixes[:BATCH]]), offline[:BATCH],
        "long_stream (Welford carry), 8 mixtures")
    # 16 ragged streams at once, each against its own utterance offline
    lengths = [QUALITY_T - 613 * i for i in range(REALTIME_STREAMS)]
    waves = np.zeros((REALTIME_STREAMS, QUALITY_T), np.float32)
    for i, n in enumerate(lengths):
        waves[i, :n] = mixes[i, :n]
    multi = RealtimeSeparator(model, chunk_samples=REALTIME_CHUNK, n_streams=REALTIME_STREAMS)
    got = multi.separate_streams(waves, lengths=lengths)
    alone = [model.separate(torch.from_numpy(waves[i : i + 1, :n]).cuda())[0].cpu().numpy()
             for i, n in enumerate(lengths)]
    out["ragged_err"] = max(
        _stream_err(got[i, :, :n], alone[i], f"stream {i} of {REALTIME_STREAMS} ({n} samples) "
                    "against it alone offline") for i, n in enumerate(lengths))
    launches = launch_counts()
    if any(launches.values()):
        raise AssertionError(f"c7 launched {launches}; the gate is closed at 32/16")
    # one push queued under the sync debug mode, its fetch outside it
    chunk = mixes[0, :REALTIME_CHUNK].copy()
    rt.reset()
    rt.push(chunk)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        est = rt._dispatch(chunk, None)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not np.isfinite(est.cpu().numpy()).all():
        raise AssertionError("the queued push gave non-finite samples")
    say(f"  one push (copy in, encode, smoothing, norm, TCN, mask, decode, OLA): no host sync")
    out["speed"] = [realtime_speed(model, chunk, streams)
                    for chunk in (REALTIME_CHUNK, 1024) for streams in (1, REALTIME_STREAMS)]
    for r in out["speed"]:
        say(f"  chunk {r['chunk']} x {r['streams']} stream(s): {r['ms_per_push']:.3f} ms per "
            f"push ({r['ms_per_push_per_stream']:.3f} per stream), rtf {r['rtf']:.5f}, "
            f"latency {r['latency_ms']:.1f} ms, {r['pushes']} timed pushes")
    launches = launch_counts()
    if any(launches.values()):
        raise AssertionError(f"c7 launched {launches}; the gate is closed at 32/16")
    return out, launches


def _fit_launches(recipe, steps: int) -> tuple[dict, dict]:
    """(each kernel's launches in one train step, in ``fit`` for ``steps``
    steps): a TasNet step encodes the mixture (B1) and decodes (B2, whose
    backward runs B1); a clustering or L41 step encodes the mixture and the
    sources (B1 twice).  Each validation runs ``valid_steps`` loss batches and
    the image summaries (three encodes and one separate's decode), and with
    ``valid_quality`` one more separate (an encode and a decode).  The
    optimizer's pair launches twice a step."""
    t = recipe.train
    k = _gate_launches(recipe.model)
    b1, b2 = k["framed_matmul"], k["decode_ola"]
    tasnet = recipe.model.kind == "tasnet"
    step = {"framed_matmul": 2 * b1, "decode_ola": b2 if tasnet else 0, "multi_adam": 2}
    valid = {"framed_matmul": b1 if tasnet else 2 * b1, "decode_ola": b2 if tasnet else 0,
             "multi_adam": 0}
    q = int(t.valid_quality)
    summaries = {"framed_matmul": (3 + q) * b1,
                 "decode_ola": (1 + q) * b2, "multi_adam": 0}
    n_valid = -(-steps // t.valid_every)
    want = {n: step[n] * steps + (valid[n] * t.valid_steps + summaries[n]) * n_valid
            for n in step}
    return step, want


def phase_train_recipe(recipe, store, workdir: str, grad_tol: float = STEP_GRAD_TOL,
                       key=None) -> tuple[dict, dict]:
    """``recipe`` at full width through Trainer.fit with phase 5's checks,
    the first step's with ``key``; returns (results, launches)."""
    from amss_tpu_torch.train.engine import Trainer

    t = recipe.train
    tr = Trainer(recipe, store, workdir=os.path.join(workdir, "runs"))
    say(f"  run dir {os.path.basename(tr.dir)}")
    state0 = tr.init_state()
    batch0 = tr.mixer.batch("train", 0, t.batch_size)
    step_check = first_step_matches_cpu(tr, state0, batch0, grad_tol=grad_tol, key=key)
    per_step = check_train_step_needs_no_host_sync(tr, batch0)
    want_step, want = _fit_launches(recipe, t.steps)
    if per_step != want_step:
        raise AssertionError(f"a {recipe.name} step launched {per_step}, want {want_step}")
    tr.load_state(state0)
    valid0 = tr.valid_loss()
    final, launches, fit_s, peak = _fit_counted(tr, state0)
    if launches != want:
        raise AssertionError(f"{recipe.name} training launches {launches}, want {want}")
    valid = _valid_losses(tr.dir)
    if len(valid) != -(-t.steps // t.valid_every):
        raise AssertionError(f"{recipe.name}: {len(valid)} validations")
    if not valid[-1] < valid0:
        raise AssertionError(f"{recipe.name} valid loss {valid0} at init, {valid} after")
    check_checkpoint_reloads(tr, final, t.steps)
    ms = window_ms_per_step(tr.dir, skip={TRAIN_LOG_EVERY})
    say(f"  {recipe.name}: {ms:.3f} ms/step median after warm-up, peak memory "
        f"{peak / 2**30:.3f} GiB, valid loss {valid0:.4f} -> {[round(v, 4) for v in valid]}, "
        f"launches per step {per_step}")
    return dict(steps=t.steps, batch=t.batch_size, chunk=t.chunk_samples, fit_s=fit_s,
                ms_per_step=ms, steps_per_s=1e3 / ms, peak_bytes=peak, valid_loss_init=valid0,
                valid_loss=valid, launches_per_step=per_step, run_dir=tr.dir,
                **step_check), launches


def _gated_quality(model, gate: float | None, what: str) -> tuple[dict, dict]:
    """phase_quality with the launches counted (one warm-up call and one per
    batch) and checked, and the SI-SDRi gated unless ``gate`` is None."""
    reset_launches()
    q = phase_quality(model)
    got = launch_counts()
    calls = -(-QUALITY_N // BATCH) + 1
    k = _gate_launches(model.cfg)
    if got != {n: k[n] * calls for n in k}:
        raise AssertionError(f"{what} quality: launches {got}, want {k} x {calls}")
    say(f"  {what} quality ({QUALITY_N} mixtures of {model.cfg.nb_speakers} speakers): si_sdri "
        f"{q['si_sdri_db']:.3f} dB, 95% CI {q['ci95']} "
        f"({'not gated' if gate is None else f'gate {gate} dB'}), launches {got}")
    if gate is not None and not q["si_sdri_db"] >= gate:
        raise AssertionError(f"{what}: SI-SDRi {q['si_sdri_db']:.3f} dB < {gate} dB")
    return q, got


def phase_c7(store, workdir: str) -> tuple[dict, dict]:
    """c7_causal's quality, then the c7 recipe at full width."""
    from amss_tpu_torch.configs.recipes import c7_realtime
    from amss_tpu_torch.weights import load_model_from_run

    out, launches = {}, {}
    out["quality"], launches["c7_quality"] = _gated_quality(
        load_model_from_run(C7_CAUSAL), C7_QUALITY_MIN_DB, "c7_causal")
    say("c7 recipe training")
    out["train"], launches["c7_train"] = phase_train_recipe(
        c7_realtime(steps=C7_STEPS, valid_every=C7_STEPS // 2), store, workdir,
        grad_tol=C6_STEP_GRAD_TOL)
    return out, launches


def enrolled_mixtures() -> tuple[np.ndarray, np.ndarray]:
    """c3_l41's training speakers at unseen offsets, rebuilt from seeds:
    (sources [C3_ENROLLED_N, 2, 16384], speaker ids [C3_ENROLLED_N, 2])."""
    from amss_tpu_torch.data.mixer import Mixer
    from amss_tpu_torch.data.synthetic import SyntheticStore

    store = SyntheticStore(n_speakers=100, seconds_per_speaker=120.0, seed=1, version=2)
    mixer = Mixer(store, nb_speakers=2, chunk_samples=16384, seed=0)
    batches = [mixer.batch("train", 10_000_000 + i, 1) for i in range(C3_ENROLLED_N)]
    return (np.concatenate([b.sources for b in batches]),
            np.concatenate([b.speaker_ids for b in batches]))


def phase_c3(store, workdir: str) -> tuple[dict, dict]:
    """c3_l41 served blind and enrolled, then the c3 recipe at full width."""
    from amss_tpu_torch.configs.recipes import c3_l41
    from amss_tpu_torch.ops.metrics import sdr_improvement
    from amss_tpu_torch.weights import load_model_from_run

    out, launches = {}, {}
    model = load_model_from_run(C3_L41)
    out["speed"], launches["c3_serve"] = phase_speed(model)
    sp = out["speed"]
    say(f"  c3_l41 blind serving (64 x 8 s, batch 8): rtf {sp['rtf_pass2']:.6f}, "
        f"{sp['utterances_per_s']:.2f} utterances/s, launches {launches['c3_serve']}")
    out["quality"], launches["c3_quality"] = _gated_quality(model, C3_QUALITY_MIN_DB,
                                                            "c3_l41 blind")
    t0 = time.perf_counter()
    sources, ids = enrolled_mixtures()
    say(f"  enrolled mixtures rebuilt from seeds: {time.perf_counter() - t0:.2f} s")
    mixes = sources.sum(axis=1)
    reset_launches()
    est = np.concatenate([
        model.separate(torch.from_numpy(mixes[i : i + BATCH]).cuda(),
                       speaker_ids=torch.from_numpy(ids[i : i + BATCH]).cuda()).cpu().numpy()
        for i in range(0, len(mixes), BATCH)])
    got = launch_counts()
    calls = -(-len(mixes) // BATCH)
    if got != {"framed_matmul": calls, "decode_ola": calls, "multi_adam": 0}:
        raise AssertionError(f"c3 enrolled launches {got}, want {calls} each")
    launches["c3_enrolled"] = got
    imp = sdr_improvement(torch.from_numpy(est).double(), torch.from_numpy(sources).double(),
                          torch.from_numpy(mixes).double()).numpy()
    boot = np.random.default_rng(0).choice(imp, size=(10000, imp.size)).mean(axis=1)
    out["enrolled"] = dict(si_sdri_db=float(imp.mean()), n=int(imp.size),
                           ci95=[float(v) for v in np.percentile(boot, [2.5, 97.5])])
    say(f"  c3_l41 enrolled ({len(mixes)} mixtures of its training speakers): si_sdri "
        f"{imp.mean():.3f} dB, 95% CI {out['enrolled']['ci95']} (gate {C3_ENROLLED_MIN_DB} "
        f"dB), launches {got}")
    if not imp.mean() >= C3_ENROLLED_MIN_DB:
        raise AssertionError(f"c3 enrolled SI-SDRi {imp.mean():.3f} dB < {C3_ENROLLED_MIN_DB}")
    say("c3 recipe training")
    out["train"], launches["c3_train"] = phase_train_recipe(
        c3_l41(len(store.speakers), steps=C3_STEPS, valid_every=C3_STEPS // 2), store, workdir)
    return out, launches


def phase_kernel_c4(gen: torch.Generator) -> dict:
    """B2 at c4's serving shape (8 utterances x 3 speakers) against its plain
    version, timed beside it, its library call and its bound."""
    from amss_tpu_torch.models.front import STFTFrontEnd
    from amss_tpu_torch.ops.kernels.framed_matmul import framed_matmul, stft_basis
    from amss_tpu_torch.ops.kernels.ola import decode_ola, decode_ola_ref
    from amss_tpu_torch.utils.config import FrontConfig
    from amss_tpu_torch.utils.timing import time_ms

    say("c4: B2 decode_ola vs decode_ola_ref at [24, 997, 258]")
    dev = torch.device("cuda")
    x = torch.randn(BATCH, SECONDS * SAMPLE_RATE, generator=gen, device=dev) * 0.3
    spec = framed_matmul(x, torch.as_tensor(stft_basis(256), device=dev), 64)
    codes = torch.cat([spec, 0.5 * spec, 0.25 * spec]).contiguous()  # [24, 997, 258]
    syn = STFTFrontEnd(FrontConfig()).to(dev).synthesis_basis
    length, hop = SECONDS * SAMPLE_RATE, 64
    y = decode_ola(codes, syn, hop, length=length)
    err = check(f"258x256 hop 64 {list(codes.shape)} -> 64000 (c4 iSTFT, S = 3)", y,
                decode_ola_ref(codes, syn, hop, length), 2e-4)
    b, nf, k = codes.shape
    codes_t = codes.transpose(1, 2).contiguous()
    w_t = syn[:, None, :].contiguous()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        lib = time_ms(lambda: F.conv_transpose1d(codes_t, w_t, stride=hop)[:, 0, :length])
    r = dict(shape=f"codes {list(codes.shape)} x syn {list(syn.shape)}, hop {hop} -> {length}",
             ms=time_ms(lambda: decode_ola(codes, syn, hop, length=length)),
             plain_ms=time_ms(lambda: decode_ola_ref(codes, syn, hop, length)),
             library_ms=lib, max_abs_err=err, tol=2e-4,
             **bound(2.0 * b * nf * k * syn.shape[1],
                     4.0 * (codes.numel() + syn.numel() + b * length)))
    say(f"  B2 at c4 serving: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
        f"{r['library_ms']:.4f} ms, bound {r['bound_ms'] * 1e3:.3f} us ({r['bound_by']})")
    g = grad_check(f"codes {list(codes.shape)} syn [258, 256] -> {length} (c4 serving, S = 3)",
                   lambda c, d: decode_ola(c, d, hop, length),
                   lambda c, d: decode_ola_ref(c, d, hop, length), [codes, syn],
                   torch.randn(b, length, generator=gen, device=dev), 2e-4, framed_matmul)
    if g["launched"] != 1:
        raise AssertionError(f"B2's backward at c4's shape launched B1 {g['launched']} times")
    r.update(grad_rel_err=g["grad_rel_err"], grad_tol=GRAD_TOL)
    return r


def phase_c4(workdir: str) -> tuple[dict, dict]:
    """The c4 recipe at full width on its own corpus, and the trained state
    served, scored and held against the port on the CPU."""
    from amss_tpu_torch.configs.recipes import c4_chimera_3mix
    from amss_tpu_torch.ops.metrics import si_sdr
    from amss_tpu_torch.weights import load_model_from_run

    out, launches = {}, {}
    say("c4 recipe training (S = 3)")
    store = training_corpus(workdir, C4_SPEAKERS, "corpus_c4")
    out["train"], launches["c4_train"] = phase_train_recipe(
        c4_chimera_3mix(steps=C4_STEPS, valid_every=C4_STEPS // 4), store, workdir)
    run_dir = out["train"]["run_dir"]
    model = load_model_from_run(run_dir)
    out["speed"], launches["c4_serve"] = phase_speed(model)
    sp = out["speed"]
    say(f"  c4 serving of the trained state (64 x 8 s, batch 8, S = 3): rtf "
        f"{sp['rtf_pass2']:.6f}, {sp['utterances_per_s']:.2f} utterances/s, launches "
        f"{launches['c4_serve']}")
    out["quality_3spk"], launches["c4_quality"] = _gated_quality(
        model, None, f"c4 after {C4_STEPS} steps (a cut run)")
    mix = torch.from_numpy(quality_mixtures(3, 2).sum(axis=1))
    card = model.separate(mix.cuda()).cpu().double()
    cpu = load_model_from_run(run_dir, device="cpu").separate(mix).double()
    db = si_sdr(card, cpu)
    say(f"  c4 trained state on the card against the port on the CPU, two mixtures: SI-SDR "
        f"{[round(float(v), 2) for v in db.flatten()]} dB (bound {C4_CARD_CPU_MIN_DB} dB)")
    if not bool((db >= C4_CARD_CPU_MIN_DB).all()):
        raise AssertionError(f"c4 card against CPU: {db.tolist()} dB")
    out["card_vs_cpu_db"] = [float(v) for v in db.flatten()]
    return out, launches


def count_mixtures(store, k: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """scripts/r3_wave.py::test_mixtures: (mixtures [n, T], sources [n, k, T])."""
    from amss_tpu_torch.data.mixer import Mixer

    mixer = Mixer(store, nb_speakers=k, chunk_samples=QUALITY_T, seed=0)
    refs = np.stack([mixer.batch("test", i, 1).sources[0] for i in range(n)])
    return refs.sum(axis=1), refs


def _separator_calls(n: int) -> int:
    """A StreamingSeparator's batch calls for ``n`` utterances of one bucket:
    one a batch of BATCH, and one warm-up for each batch size."""
    sizes = {min(BATCH, n - i) for i in range(0, n, BATCH)}
    return -(-n // BATCH) + len(sizes)


def phase_count() -> tuple[dict, dict]:
    """c1_count on mixtures of 1, 2 and 3 speakers, card against CPU, then
    auto-k serving; returns (results, launches by path)."""
    from amss_tpu_torch.data.synthetic import SyntheticStore
    from amss_tpu_torch.infer.count import count_speakers, separate_auto_k
    from amss_tpu_torch.infer.streaming import BucketSpec
    from amss_tpu_torch.ops.metrics import sdr_improvement
    from amss_tpu_torch.weights import load_model_from_run

    t0 = time.perf_counter()
    store = SyntheticStore(n_speakers=30, seconds_per_speaker=40.0, seed=0, version=2)
    data = {k: count_mixtures(store, k, max(COUNT_N, AUTOK_N)) for k in (1, 2, 3)}
    say(f"  {COUNT_N} mixtures of each k from the v2 corpus of 30 x 40 s: "
        f"{time.perf_counter() - t0:.2f} s")
    model = load_model_from_run(C1_COUNT)
    cpu = load_model_from_run(C1_COUNT, device="cpu")

    def counts(m, mixes, dev):
        return np.concatenate([
            count_speakers(m, torch.from_numpy(mixes[i : i + BATCH]).to(dev)).cpu().numpy()
            for i in range(0, COUNT_N, BATCH)])

    reset_launches()
    card = {k: counts(model, mixes[:COUNT_N], "cuda") for k, (mixes, _) in data.items()}
    launches = {"count": launch_counts()}
    calls = 3 * -(-COUNT_N // BATCH)
    if launches["count"] != {"framed_matmul": calls, "decode_ola": 0, "multi_adam": 0}:
        raise AssertionError(f"counting launched {launches['count']}, want B1 {calls} times")
    t0 = time.perf_counter()
    host = {k: counts(cpu, mixes[:COUNT_N], "cpu") for k, (mixes, _) in data.items()}
    cpu_s = time.perf_counter() - t0
    differ = [(k, i, int(card[k][i]), int(host[k][i])) for k in card
              for i in np.flatnonzero(card[k] != host[k])]
    agree = 1.0 - len(differ) / (3 * COUNT_N)
    say(f"  card against CPU: {agree:.4f} of {3 * COUNT_N} counts equal (gate {COUNT_AGREE_MIN}); "
        f"differing (true k, mixture, card, CPU): {differ}")
    if not agree >= COUNT_AGREE_MIN:
        raise AssertionError(f"the card counts {differ} otherwise than the CPU")
    acc = {k: float(np.mean(card[k] == k)) for k in card}
    confusion = {k: {int(a): int(c) for a, c in zip(*np.unique(card[k], return_counts=True))}
                 for k in card}
    say(f"  count accuracy on the card {acc} (gates {COUNT_MIN_ACC}), confusion {confusion}, "
        f"launches {launches['count']}")
    for k, a in acc.items():
        if not a >= COUNT_MIN_ACC[k]:
            raise AssertionError(f"count accuracy at k = {k}: {a} < {COUNT_MIN_ACC[k]}")

    waves = [m for k in (1, 2, 3) for m in data[k][0][:AUTOK_N]]
    true_k = [k for k in (1, 2, 3) for _ in range(AUTOK_N)]
    reset_launches()
    t0 = time.perf_counter()
    ks, ests, rtf = separate_auto_k(model, waves, buckets=BucketSpec(lengths=(QUALITY_T,)))
    autok_s = time.perf_counter() - t0
    launches["auto_k"] = launch_counts()
    groups = [ks.count(k) for k in sorted(set(ks))]
    want = {"framed_matmul": len(waves) + sum(map(_separator_calls, groups)),
            "decode_ola": sum(map(_separator_calls, groups)), "multi_adam": 0}
    if launches["auto_k"] != want:
        raise AssertionError(f"auto-k launched {launches['auto_k']}, want {want}")
    autok = {}
    for k in (2, 3):
        idx = [i for i, (kt, ke) in enumerate(zip(true_k, ks)) if kt == k and ke == k]
        imp = np.array([float(sdr_improvement(
            torch.from_numpy(ests[i][None]).double(),
            torch.from_numpy(data[k][1][i - true_k.index(k)][None]).double(),
            torch.from_numpy(waves[i][None]).double())[0]) for i in idx])
        boot = np.random.default_rng(0).choice(imp, size=(10000, imp.size)).mean(axis=1)
        autok[k] = dict(si_sdri_db=float(imp.mean()), n=int(imp.size),
                        count_acc=float(imp.size / AUTOK_N),
                        ci95=[float(v) for v in np.percentile(boot, [2.5, 97.5])])
    say(f"  auto-k ({AUTOK_N} mixtures of each k, counted one at a time, then one separator "
        f"per count): groups {dict(zip(sorted(set(ks)), groups))}, si_sdri of the correctly "
        f"counted {autok} (gates {AUTOK_MIN_DB}), rtf {rtf:.6f}, {autok_s:.2f} s, launches "
        f"{launches['auto_k']}")
    for k, r in autok.items():
        if not r["si_sdri_db"] >= AUTOK_MIN_DB[k]:
            raise AssertionError(f"auto-k SI-SDRi at k = {k}: {r['si_sdri_db']:.3f} dB")
    out = dict(n=COUNT_N, accuracy=acc, confusion=confusion, card_cpu_agreement=agree,
               card_cpu_differ=differ, cpu_count_s=cpu_s, auto_k=autok, auto_k_rtf=rtf,
               auto_k_s=autok_s, auto_k_groups=groups)
    return out, launches


class FixedFirstPass:
    """Stands for an enhancer's base: ``separate`` returns ``est`` whatever it
    is given; everything else is the base's."""

    def __init__(self, base, est: torch.Tensor):
        self.base, self.est = base, est

    def separate(self, mix, frame_mask=None):
        return self.est

    def __getattr__(self, name):
        return getattr(self.base, name)


def _db(a: np.ndarray, b: np.ndarray, best_order: bool = False) -> np.ndarray:
    """SI-SDR of ``a`` [n, S, T] against ``b`` per utterance (mean over
    sources), in the given source order or in the best one (k-means names
    its clusters in the order it seeds them)."""
    import itertools

    from amss_tpu_torch.ops.metrics import si_sdr

    a, b = torch.from_numpy(a).double(), torch.from_numpy(b).double()
    orders = itertools.permutations(range(a.shape[1])) if best_order else [range(a.shape[1])]
    return torch.stack([si_sdr(a[:, list(p)], b).mean(-1) for p in orders]).amax(0).numpy()


def phase_enh(store, workdir: str, base_quality: dict) -> tuple[dict, dict]:
    """The enh recipe over checkpoints/c1_dpcl at full width with phase 5's
    checks, the frozen base, the refiner at init, and the trained state
    served; returns (results, launches by path)."""
    from amss_tpu_torch.configs.recipes import enh_dpcl
    from amss_tpu_torch.train.engine import Trainer
    from amss_tpu_torch.weights import load_model_from_run

    recipe = enh_dpcl(CKPT, steps=ENH_STEPS, valid_every=ENH_STEPS // 2)
    t = recipe.train
    tr = Trainer(recipe, store, workdir=os.path.join(workdir, "runs"))
    say(f"  run dir {os.path.basename(tr.dir)}")
    base = tr.model.base
    frozen = {n: p.detach().clone() for n, p in base.named_parameters()}
    state0 = tr.init_state()
    batch0 = tr.mixer.batch("train", 0, t.batch_size)

    # the first step, card against CPU, from one first pass (the card's)
    mix0 = tr._dequantize(tr._device_batch(batch0))["sources"].sum(dim=1)
    est0 = base.separate(mix0)
    cpu_base = load_model_from_run(CKPT, device="cpu")
    base_db = _db(est0.cpu().numpy(), cpu_base.separate(mix0.cpu()).numpy(), best_order=True)
    say(f"  the base's first pass on the card against the CPU's, best speaker order: SI-SDR "
        f"{[round(float(v), 2) for v in base_db]} dB (k-means seeding tie, ROADMAP C.2)")

    def one_first_pass(model, device):
        model._frozen[0] = FixedFirstPass(model.base, est0.to(device))

    step_check = first_step_matches_cpu(tr, state0, batch0, prepare=one_first_pass)
    tr.model._frozen[0] = base
    per_step = check_train_step_needs_no_host_sync(tr, batch0)
    if per_step != {"framed_matmul": 4, "decode_ola": 1, "multi_adam": 2}:
        raise AssertionError(f"an enh step launched {per_step}: want B1 4 times (the base's "
                             "encode, the mixture, the estimates, the sources) and B2 once")

    # at init the two stages are near the base alone
    tr.load_state(state0)
    mixes = torch.from_numpy(quality_mixtures(2, BATCH).sum(axis=1)).cuda()
    with tr._serving_weights():
        init_db = _db(tr.model.separate(mixes).cpu().numpy(), base.separate(mixes).cpu().numpy())
    say(f"  at init, two stages against the base alone ({BATCH} of phase 4's mixtures): SI-SDR "
        f"{init_db.min():.2f}-{init_db.max():.2f} dB, mean {init_db.mean():.2f} "
        f"(gate {ENH_INIT_MIN_DB} dB)")
    if not init_db.min() >= ENH_INIT_MIN_DB:
        raise AssertionError(f"the refiner at init moves the base's output to {init_db} dB")

    valid0 = tr.valid_loss()
    final, launches, fit_s, peak = _fit_counted(tr, state0)
    n_valid = -(-t.steps // t.valid_every)
    # a validation: valid_steps loss batches, and the image summaries (the
    # mixture's encode, a two-stage separate, its first speaker's encode)
    want = {"framed_matmul": 4 * t.steps + (4 * t.valid_steps + 5) * n_valid,
            "decode_ola": t.steps + (t.valid_steps + 2) * n_valid, "multi_adam": 2 * t.steps}
    if launches != want:
        raise AssertionError(f"enh training launches {launches}, want {want}")
    valid = _valid_losses(tr.dir)
    if len(valid) != n_valid or not valid[-1] < valid0:
        raise AssertionError(f"enh valid loss {valid0} at init, {valid} after")
    check_checkpoint_reloads(tr, final, t.steps)
    moved = [n for n, p in base.named_parameters() if not torch.equal(p, frozen[n])]
    if moved:
        raise AssertionError(f"the frozen base moved: {moved}")
    say(f"  the base's {len(frozen)} tensors are bit for bit those of checkpoints/c1_dpcl")
    ms = window_ms_per_step(tr.dir, skip={TRAIN_LOG_EVERY})
    say(f"  enh: {ms:.3f} ms/step median after warm-up, peak memory {peak / 2**30:.3f} GiB, "
        f"valid loss {valid0:.4f} -> {[round(v, 4) for v in valid]}, launches per step "
        f"{per_step}")

    model = load_model_from_run(tr.dir)
    reset_launches()
    q = phase_quality(model)
    got = launch_counts()
    calls = -(-QUALITY_N // BATCH) + 1
    if got != {"framed_matmul": 3 * calls, "decode_ola": 2 * calls, "multi_adam": 0}:
        raise AssertionError(f"enh serving launched {got}, want 3 x {calls} and 2 x {calls}")
    out_launches = {"enh_train": launches, "enh_serve": got}
    say(f"  enh after {t.steps} steps, served ({QUALITY_N} mixtures, batch {BATCH}): si_sdri "
        f"{q['si_sdri_db']:.3f} dB, 95% CI {q['ci95']} (gate {QUALITY_MIN_DB} dB; the base "
        f"{base_quality['si_sdri_db']:.3f} dB), launches {got}")
    if not q["si_sdri_db"] >= QUALITY_MIN_DB:
        raise AssertionError(f"enh SI-SDRi {q['si_sdri_db']:.3f} dB < {QUALITY_MIN_DB} dB")

    # the trained state on the card against the CPU
    cpu = load_model_from_run(tr.dir, device="cpu")
    two = mixes[:2]
    whole_db = _db(model.separate(two).cpu().numpy(), cpu.separate(two.cpu()).numpy(),
                   best_order=True)
    est = model.base.separate(two)
    model._frozen[0] = FixedFirstPass(model.base, est)
    cpu._frozen[0] = FixedFirstPass(cpu.base, est.cpu())
    stage_db = _db(model.separate(two).cpu().numpy(), cpu.separate(two.cpu()).numpy())
    say(f"  trained state, card against CPU, two mixtures: two stages {whole_db.round(2).tolist()} "
        f"dB in the best speaker order (bound {ENH_CARD_CPU_MIN_DB}), the second stage from "
        f"one first pass "
        f"{stage_db.round(2).tolist()} dB (bound {ENH_STAGE_CARD_CPU_MIN_DB})")
    if not (whole_db >= ENH_CARD_CPU_MIN_DB).all() or not (
            stage_db >= ENH_STAGE_CARD_CPU_MIN_DB).all():
        raise AssertionError(f"enh card against CPU: {whole_db}, {stage_db} dB")
    out = dict(steps=t.steps, batch=t.batch_size, chunk=t.chunk_samples, fit_s=fit_s,
               ms_per_step=ms, peak_bytes=peak, valid_loss_init=valid0, valid_loss=valid,
               launches_per_step=per_step, base_first_pass_card_cpu_db=base_db.tolist(),
               init_vs_base_db=init_db.tolist(), quality=q, base_quality=base_quality,
               card_cpu_db=whole_db.tolist(), stage_card_cpu_db=stage_db.tolist(),
               **step_check)
    return out, out_launches


def check_blstm_dropout() -> dict:
    """The BLSTM stack's training-time dropout on the card: cuDNN one layer
    at a time (packed where masked) against the step-by-step loop on the card
    with the same key, so the same masks; the output and the input's
    gradient, relative to their largest magnitudes."""
    from amss_tpu_torch.models.blstm import BLSTM
    from amss_tpu_torch.models.dprnn import DropoutKey, dropout

    gen = torch.Generator().manual_seed(0)
    lstm = BLSTM(64, 32, 2)
    lstm.init_parameters(gen)
    lstm = lstm.cuda().train()
    x = torch.randn(6, 50, 64, generator=gen).cuda()
    mask = torch.ones(6, 50, device="cuda")
    mask[1, 30:] = 0.0
    mask[4, 7:] = 0.0
    out = {}
    for name, m in (("unmasked", None), ("masked", mask)):
        key = DropoutKey(5)
        xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
        a = lstm(xa, m, dropout_rate=0.2, rng=key)
        h = xb
        for layer, r in enumerate(key.split(lstm.layers)):
            h = dropout(lstm._layer_loop(h, m, layer), 0.2, r)
        a.square().sum().backward()
        h.square().sum().backward()
        err = float((a - h).detach().abs().max() / h.detach().abs().max())
        gerr = float((xa.grad - xb.grad).abs().max() / xb.grad.abs().max())
        out[name] = dict(err=err, grad_err=gerr)
        if not (err <= BLSTM_DROPOUT_TOL and gerr <= STEP_GRAD_TOL):
            raise AssertionError(f"the BLSTM's dropout on the card ({name}): {err}, {gerr}")
    say(f"  BLSTM 2 x 32 with dropout 0.2, cuDNN a layer at a time against the loop, one key: "
        f"{out} of the peak (tol {BLSTM_DROPOUT_TOL:g}, gradients {STEP_GRAD_TOL:g})")
    return out


def dual_path_blstm_launches(model, rows: int, bucket: int) -> int:
    """The recurrence kernel's launches in one gradient-free float32 call of
    ``rows`` rows in ``bucket`` samples on the card: a layer each where
    ``blstm_path`` gives ``kernel`` at the path's rows (0 for DPT)."""
    from amss_tpu_torch.models.blstm import blstm_path

    sep = model.cfg.sep
    if sep.trunk != "dprnn":
        return 0
    k = sep.chunk_frames
    p = -(-model.cfg.front.frames_for(bucket) // k)
    n = 0
    for blk in model.dprnn.blocks:
        for path, n_rows in ((blk.intra, rows * p), (blk.inter, rows * k)):
            lstm = path.lstm
            if blstm_path("cuda", torch.float32, model.compute_dtype, n_rows, lstm.hidden,
                          False, False, False) == "kernel":
                n += lstm.layers
    return n


def phase_dual_path(trunk: str, store, workdir: str) -> tuple[dict, dict]:
    """c6 with the ``trunk`` (dprnn or dpt) trained with phase 5's checks,
    served on the card against the CPU (one utterance padded in its bucket)
    and scored, and the spans of one served call; returns (results, launches
    by path)."""
    from amss_tpu_torch.configs.recipes import c6_dual_path
    from amss_tpu_torch.infer.streaming import BucketSpec, StreamingSeparator
    from amss_tpu_torch.ops.kernels.blstm import bilstm_layer
    from amss_tpu_torch.tools.stage_times import serving_spans
    from amss_tpu_torch.weights import load_model_from_run

    recipe = c6_dual_path(trunk, steps=DP_STEPS, valid_every=DP_STEPS // 2)
    if recipe.model.sep.dropout > 0.0:
        say(f"  the first step against the CPU runs at rate 0 (no dropout key on either side); "
            f"training runs at {recipe.model.sep.dropout}")
    out, launches = {}, {}
    if trunk == "dprnn":
        out["blstm_dropout"] = check_blstm_dropout()
    out["train"], launches[f"c6_{trunk}_train"] = phase_train_recipe(
        recipe, store, workdir, grad_tol=C6_STEP_GRAD_TOL)
    run_dir = out["train"]["run_dir"]
    model = load_model_from_run(run_dir)
    cpu = load_model_from_run(run_dir, device="cpu")
    waves = list(quality_mixtures(2, 4).sum(axis=1))
    waves[1] = waves[1][:DP_PADDED_SAMPLES]
    buckets = BucketSpec(lengths=(QUALITY_T,))
    reset_launches()
    b0 = bilstm_layer.launches + bilstm_layer.rows_launches
    card = StreamingSeparator(model, buckets=buckets).separate_all(waves)
    launches[f"c6_{trunk}_serve"] = launch_counts()
    blstm = bilstm_layer.launches + bilstm_layer.rows_launches - b0
    # a fresh separator runs the group's shape once to warm it, then serves it
    want = 2 * dual_path_blstm_launches(model, len(waves), QUALITY_T)
    if blstm != want:
        raise AssertionError(f"c6 {trunk}'s served call launched {blstm} BLSTM kernels, "
                             f"want {want} (blstm_path at its rows)")
    out["blstm_launches"] = blstm
    host = StreamingSeparator(cpu, buckets=buckets, device="cpu").separate_all(waves)
    if [c.shape for c in card] != [(2, len(w)) for w in waves] or not all(
            np.isfinite(c).all() for c in card):
        raise AssertionError(f"c6 {trunk} serving: {[c.shape for c in card]}, finite "
                             f"{[bool(np.isfinite(c).all()) for c in card]}")
    db = np.array([float(_db(c[None], h[None])[0]) for c, h in zip(card, host)])
    say(f"  c6 {trunk} trained state, card against CPU ({len(waves)} utterances, the second "
        f"{DP_PADDED_SAMPLES} samples in a bucket of {QUALITY_T}): SI-SDR {db.round(2).tolist()} "
        f"dB (bound {C4_CARD_CPU_MIN_DB}), all finite, launches {launches[f'c6_{trunk}_serve']}, "
        f"BLSTM kernels {blstm}")
    if not (db >= C4_CARD_CPU_MIN_DB).all():
        raise AssertionError(f"c6 {trunk} card against CPU: {db} dB")
    if any(launches[f"c6_{trunk}_serve"].values()):
        raise AssertionError("the shape gate is closed at 32/16: no kernel may launch")
    out["card_cpu_db"] = db.tolist()
    out["quality"], launches[f"c6_{trunk}_quality"] = _gated_quality(
        model, None, f"c6 {trunk} after {DP_STEPS} steps (a cut run)")
    out["spans"] = serving_spans(model, calls=1)
    st = out["spans"]
    say(f"  c6 {trunk} served call ({BATCH} x {SECONDS} s, after a warm one): "
        f"{st['call_wall_ms']:.3f} ms, device ms by span "
        f"{ {k: round(v['device_ms'], 3) for k, v in st['spans'].items() if v['device_ms']} }")
    return out, launches


def wav_corpus(workdir: str):
    """COUNT_TRAIN_SPEAKERS synthetic v2 speakers written as 16-bit WAVs at
    COUNT_WAV_RATE, two utterances each, and ingested into a store at
    SAMPLE_RATE through ``ingest_wav_tree`` (its resampler)."""
    from amss_tpu_torch.data.store import ingest_wav_tree
    from amss_tpu_torch.data.synthetic import SyntheticStore
    from amss_tpu_torch.infer.evaluate import write_wav

    t0 = time.perf_counter()
    synth = SyntheticStore(COUNT_TRAIN_SPEAKERS, TRAIN_SECONDS, sample_rate=COUNT_WAV_RATE,
                           seed=0, version=2)
    wavs = os.path.join(workdir, "wavs_c1_count")
    for name in synth.speakers:
        wave = synth.waveform(name)
        for u, part in enumerate(np.split(wave, 2)):
            write_wav(os.path.join(wavs, name, f"utt{u}.wav"), part, sample_rate=COUNT_WAV_RATE)
    written = time.perf_counter() - t0
    store = ingest_wav_tree(wavs, os.path.join(workdir, "corpus_c1_count"),
                            sample_rate=SAMPLE_RATE)
    n = int(TRAIN_SECONDS * SAMPLE_RATE)
    lengths = {store.n_samples(spk) for spk in store.speakers}
    if store.sample_rate != SAMPLE_RATE or len(store.speakers) != COUNT_TRAIN_SPEAKERS or \
            lengths != {n}:
        raise AssertionError(f"ingested store: {store.sample_rate} Hz, "
                             f"{len(store.speakers)} speakers of {lengths} samples")
    say(f"  corpus {COUNT_TRAIN_SPEAKERS} x {TRAIN_SECONDS:g} s (v2) as WAVs at {COUNT_WAV_RATE} "
        f"Hz: written {written:.2f} s, ingested at {SAMPLE_RATE} Hz "
        f"{time.perf_counter() - t0 - written:.2f} s")
    return store


def phase_train_count(workdir: str) -> tuple[dict, dict]:
    """c1_count's own config.json at full width with phase 5's checks (its
    first step with a key, so the sources are dropped on both sides), on the
    ingested WAV corpus; the drawn counts, valid/si_sdri at every validation,
    and the CUDA BLSTM's prefix masks (ROADMAP C.5) checked."""
    from amss_tpu_torch.models import blstm, front
    from amss_tpu_torch.models.dprnn import DropoutKey
    from amss_tpu_torch.utils.config import recipe_from_dict

    with open(os.path.join(C1_COUNT, "config.json")) as f:
        recipe = recipe_from_dict(json.load(f))
    m, t = recipe.model, recipe.train
    got = (m.train_min_speakers, m.nb_speakers, m.sep.hidden, m.sep.layers, m.sep.embed_dim,
           t.batch_size, t.chunk_samples)
    if got != (1, 3, 300, 2, 20, 16, 16384):
        raise AssertionError(f"c1_count's config is not the one this phase was written for: {got}")
    recipe = dataclasses.replace(recipe, train=dataclasses.replace(
        t, steps=COUNT_TRAIN_STEPS, valid_every=COUNT_TRAIN_STEPS // 4, valid_quality=True))
    say("c1_count's config.json (dropped sources, valid_quality)")
    store = wav_corpus(workdir)
    drawn, masks = [], {"calls": 0, "raised": 0}
    draw, prefix = front.draw_active_counts, blstm.prefix_lengths

    def recorded_draw(*args):
        k = draw(*args)
        drawn.append(k)
        return k

    def counted_prefix(mask):
        masks["calls"] += 1
        try:
            return prefix(mask)
        except ValueError:
            masks["raised"] += 1
            raise

    front.draw_active_counts, blstm.prefix_lengths = recorded_draw, counted_prefix
    try:
        out, launches = phase_train_recipe(recipe, store, workdir, key=DropoutKey(t.seed))
    finally:
        front.draw_active_counts, blstm.prefix_lengths = draw, prefix
    # the first step on the card and on the CPU, the step with no host sync, then fit's
    if len(drawn) != COUNT_TRAIN_STEPS + 3:
        raise AssertionError(f"{len(drawn)} count draws, want {COUNT_TRAIN_STEPS + 3}")
    k = torch.cat(drawn[-COUNT_TRAIN_STEPS:])
    shares = {int(v): float((k == v).double().mean()) for v in (1, 2, 3)}
    if any(abs(sh - 1.0 / 3.0) > COUNT_K_SHARE_TOL for sh in shares.values()):
        raise AssertionError(f"drawn k over the run: shares {shares}")
    records = [json.loads(line) for line in open(os.path.join(out["run_dir"], "metrics.jsonl"))]
    valid_steps = [r["step"] for r in records if "valid/loss" in r]
    quality = {r["step"]: r["valid/si_sdri"] for r in records if "valid/si_sdri" in r}
    if sorted(quality) != valid_steps or not all(np.isfinite(list(quality.values()))):
        raise AssertionError(f"valid/si_sdri at {sorted(quality)}, validations at {valid_steps}")
    if masks["raised"]:
        raise AssertionError(f"the BLSTM refused {masks['raised']} masks (ROADMAP C.5)")
    say(f"  drawn k over {COUNT_TRAIN_STEPS} steps x {t.batch_size} rows: shares {shares}; "
        f"valid/si_sdri {[round(v, 3) for v in quality.values()]} dB; the BLSTM's prefix "
        f"check ran {masks['calls']} times and refused none")
    out.update(k_shares=shares, valid_si_sdri=quality, prefix_checks=masks["calls"])
    return out, {"c1_count_train": launches}


def check_corruptions_on_the_card(store) -> dict:
    """Each apply on the card against the CPU's on the same draws, the
    realised SNR of each row, the RIRs of the key's draws (causal, the direct
    tap, unit energy, the drawn DRR), at c6's batch of 8 x 16384."""
    from amss_tpu_torch.data.mixer import Mixer
    from amss_tpu_torch.models import front
    from amss_tpu_torch.models.dprnn import DropoutKey

    dev = torch.device("cuda")
    src = torch.from_numpy(Mixer(store, nb_speakers=2, chunk_samples=16384, seed=0)
                           .batch("train", 0, 8).sources)
    mix, key, out = src.sum(dim=1), DropoutKey(0), {}
    snr_range = C6_CORRUPTIONS["noise"]["train_noise_snr_db"]
    draws = front.draw_noise(key, mix.shape, snr_range, "cpu")
    want = front.apply_noise(mix, *draws)
    got = front.apply_noise(mix.to(dev), *(d.to(dev) for d in draws))
    out["noise_err"] = check("noise on [8, 16384], card against CPU (same draws)", got.cpu(),
                             want, CORRUPT_TOL * float(want.abs().max()))
    mix_d = mix.to(dev)
    snr, _ = front.draw_noise(key, mix.shape, snr_range, dev)
    noisy = front.corrupt_mix(mix_d, key, snr_range)
    real = 10.0 * torch.log10((mix_d.double() ** 2).sum(-1) / ((noisy - mix_d).double() ** 2).sum(-1))
    out["snr_err_db"] = float((real - snr.double()).abs().max())
    if not out["snr_err_db"] <= 0.01 or not (snr >= snr_range[0]).all() or \
            not (snr < snr_range[1]).all():
        raise AssertionError(f"realised SNR {real.tolist()}, drawn {snr.tolist()}")

    rt60_range = C6_CORRUPTIONS["reverb"]["train_reverb_rt60"]
    n = front.rir_length(16384, rt60_range[1])
    draws = front.draw_reverb(key, 8, 2, n, rt60_range, (0.0, 10.0), "cpu")
    want = front.apply_reverb(src, *draws)
    got = front.apply_reverb(src.to(dev), *(d.to(dev) for d in draws))
    out["reverb_err"] = check(f"reverb of [8, 2, 16384] by {n}-tap RIRs, card against CPU "
                              "(same draws)", got.cpu(), want,
                              CORRUPT_TOL * float(want.abs().max()))
    at = 1000
    x = torch.zeros((8, 2, 16384), device=dev)
    x[:, :, at] = 1.0
    rt60, drr, gauss = front.draw_reverb(key, 8, 2, n, rt60_range, (0.0, 10.0), dev)
    y = front.apply_reverb(x, rt60, drr, gauss).double().cpu()
    drr = drr.double().cpu()[..., 0]
    direct = 1.0 / torch.sqrt(1.0 + 10.0 ** (-drr / 10.0))
    got_drr = 10.0 * torch.log10(y[..., at] ** 2 / (y[..., at + 1:] ** 2).sum(-1))
    out.update(rir_direct_err=float((y[..., at] - direct).abs().max()),
               rir_energy_err=float(((y ** 2).sum(-1) - 1.0).abs().max()),
               rir_drr_err_db=float((got_drr - drr).abs().max()))
    if (y[..., :at] != 0.0).any() or out["rir_direct_err"] > 1e-6 or \
            out["rir_energy_err"] > 1e-4 or out["rir_drr_err_db"] > RIR_DRR_TOL_DB or \
            not ((drr >= 0.0) & (drr < 10.0)).all():
        raise AssertionError(f"RIRs on the card: {out}")
    say(f"  realised SNR within {out['snr_err_db']:.2e} dB of the drawn; RIRs causal, direct "
        f"tap within {out['rir_direct_err']:.1e}, energy 1 within {out['rir_energy_err']:.1e}, "
        f"DRR within {out['rir_drr_err_db']:.3f} dB of the drawn")
    return out


def phase_train_c6_corrupt(store, workdir: str) -> tuple[dict, dict]:
    """The c6 recipe clean, with noise, then with reverberation, for
    C6_CORRUPT_STEPS steps each, so the three steps compare at one run
    length: one key's mixture twice (and another key's differing where a
    corruption draws), one step with no host sync, the launches, and the
    valid loss falling."""
    from amss_tpu_torch.configs.recipes import c6_tasnet
    from amss_tpu_torch.train.engine import Trainer

    out, launches = {"checks": check_corruptions_on_the_card(store)}, {}
    for name, over in {"clean": {}, **C6_CORRUPTIONS}.items():
        # one validation, at the end: ms/step is the median of fit's windows
        r = c6_tasnet(steps=C6_CORRUPT_STEPS, valid_every=C6_CORRUPT_STEPS)
        recipe = dataclasses.replace(r, model=dataclasses.replace(r.model, **over))
        t = recipe.train
        tr = Trainer(recipe, store, workdir=os.path.join(workdir, "runs"))
        say(f"  c6 {name} {over}: run dir {os.path.basename(tr.dir)}")
        state0 = tr.init_state()
        batch0 = tr.mixer.batch("train", 0, t.batch_size)
        src = torch.from_numpy(batch0.sources).cuda()
        a, b, other = (tr.model.observed_mix(src, tr.dropout_key(k)) for k in (0, 0, 1))
        if not torch.equal(a, b) or torch.equal(a, other) != (not over):
            raise AssertionError(f"{name}: one key's mixture differs, or two keys' "
                                 f"{'differ' if not over else 'agree'}")
        tr.load_state(state0)
        per_step = check_train_step_needs_no_host_sync(tr, batch0)
        want_step, want = _fit_launches(recipe, t.steps)
        if per_step != want_step:
            raise AssertionError(f"a c6 {name} step launched {per_step}, want {want_step}")
        tr.load_state(state0)
        valid0 = tr.valid_loss()
        _, got, fit_s, peak = _fit_counted(tr, state0)
        if got != want:
            raise AssertionError(f"c6 {name} training launches {got}, want {want}")
        valid = _valid_losses(tr.dir)
        train_loss = [m["train/neg_pit_si_sdr"] for m in
                      (json.loads(line) for line in open(os.path.join(tr.dir, "metrics.jsonl")))
                      if "train/neg_pit_si_sdr" in m]
        if not np.isfinite(train_loss).all() or not valid[-1] < valid0:
            raise AssertionError(f"c6 {name}: train loss {train_loss}, valid loss {valid0} at "
                                 f"init, {valid} after")
        ms = window_ms_per_step(tr.dir, skip={TRAIN_LOG_EVERY})
        out[name] = dict(steps=t.steps, batch=t.batch_size, chunk=t.chunk_samples, fit_s=fit_s,
                         ms_per_step=ms, peak_bytes=peak, valid_loss_init=valid0,
                         valid_loss=valid, train_loss_first=train_loss[0],
                         train_loss_last=train_loss[-1], launches_per_step=per_step)
        launches[f"c6_{name}_train"] = got
    return out, launches


def phase_eval(quality: dict, kept: dict) -> dict:
    """``evaluate_separation`` on phase 4's estimates on the card: its
    SI-SDRi phase 4's, SDRi and STOIi gated, the whole call timed."""
    from amss_tpu_torch.infer.evaluate import evaluate_separation

    est, refs, mixes = (torch.from_numpy(kept[k]).cuda() for k in ("est", "refs", "mixes"))
    t0 = time.perf_counter()
    q = evaluate_separation(est, refs, mixes, bss=True, per_utt=True, with_stoi=True)
    out = {"evaluate_separation_s": time.perf_counter() - t0}
    cols = ("si_sdri", "sdri", "sir", "sar", "stoi", "stoi_i")
    if q["n"] != QUALITY_N or not np.isfinite([q[k] for k in cols]).all():
        raise AssertionError(f"evaluation of {q['n']} mixtures: {q}")
    if not abs(q["si_sdri"] - quality["si_sdri_db"]) <= EVAL_SI_SDRI_TOL_DB:
        raise AssertionError(f"evaluate_separation's SI-SDRi {q['si_sdri']} is not phase 4's "
                             f"{quality['si_sdri_db']}")
    if not q["sdri"] >= EVAL_SDRI_MIN_DB or not q["stoi_i"] >= EVAL_STOI_I_MIN:
        raise AssertionError(f"SDRi {q['sdri']:.4f} dB (gate {EVAL_SDRI_MIN_DB}), STOIi "
                             f"{q['stoi_i']:.4f} (gate {EVAL_STOI_I_MIN})")
    out.update({k: q[k] for k in cols}, sdri_ci=q["sdri_ci"], si_sdri_ci=q["si_sdri_ci"])
    return out


# -- slice 8: the serving surface ---------------------------------------------

ART_LENGTHS = (16384, 64000)
ART_CHILD_TIMEOUT_S = 300
AGREE_MIN_DB = 40.0  # a row of the artifact at least this close to the live path
EMBED_TOL = 1e-5  # traced against the live (kernel) BLSTM's embeddings, of the peak
RT_ART_STREAMS = 16

# Run in a fresh interpreter: separate phase 3's utterances twice and phase
# 4's mixtures once through a ServingArtifact, with no model module imported.
ARTIFACT_CHILD = r"""
import json, sys, time
import numpy as np
import torch
from amss_tpu_torch.infer.export import ServingArtifact
from amss_tpu_torch.ops.kernels.framed_matmul import framed_matmul
from amss_tpu_torch.ops.kernels.kmeans import kmeans
from amss_tpu_torch.ops.kernels.ola import decode_ola

path, inp, outp = sys.argv[1:4]
data = np.load(inp)
t0 = time.perf_counter()
art = ServingArtifact(path)
load_s = time.perf_counter() - t0
waves = list(data["waves"])
passes = []
for p in range(2):
    framed_matmul.launches = decode_ola.launches = kmeans.launches = 0
    m = art.meter
    m.compute_seconds = m.audio_seconds = 0.0
    m.utterances = m.calls = 0
    est = art.separate_all(waves)
    passes.append(dict(rtf=m.rtf, utterances_per_s=m.utterances_per_sec,
                       warmup_s=m.warmup_seconds,
                       launches={"framed_matmul": framed_matmul.launches,
                                 "decode_ola": decode_ola.launches,
                                 "kmeans": kmeans.launches}))
quality = np.stack(art.separate_all(list(data["quality"])))
models = sorted(m for m in sys.modules if m.startswith("amss_tpu_torch.models"))
np.savez(outp, est=np.stack(est), quality=quality)
print(json.dumps(dict(load_s=load_s, passes=passes, model_modules=models,
                      device=str(art.device))))
"""


def phase3_waves() -> list:
    """Phase 3's utterances: N_UTTS of SECONDS of noise from seed 0."""
    rng = np.random.default_rng(0)
    return [rng.standard_normal(SECONDS * SAMPLE_RATE).astype(np.float32) * 0.3
            for _ in range(N_UTTS)]


@contextlib.contextmanager
def _traced_blstm(model):
    """Run ``model``'s BLSTM on its ``traced`` path for the block (live
    calls take the kernel on the card)."""
    model.blstm.forward = lambda x, mask=None, **kw: model.blstm.traced(x, mask)
    try:
        yield
    finally:
        del model.blstm.forward


def embeddings_both(model, mixes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """c1's embeddings of ``mixes`` [n, T] on the card, in batches of BATCH,
    through the live BLSTM (the kernel) and through the traced one."""
    out = ([], [])
    with torch.no_grad():
        for i in range(0, len(mixes), BATCH):
            mix = torch.from_numpy(mixes[i : i + BATCH]).cuda()
            feats = model.front.features(model.front.encode(mix)[0])
            out[0].append(model.embed(feats).cpu().numpy())
            with _traced_blstm(model):
                out[1].append(model.embed(feats).cpu().numpy())
    return np.concatenate(out[0]), np.concatenate(out[1])


def _rtf_pass(model, waves: list) -> float:
    """RTF of one warm pass of StreamingSeparator over ``waves``."""
    from amss_tpu_torch.infer.streaming import BucketSpec, StreamingSeparator

    sep = StreamingSeparator(model, sample_rate=SAMPLE_RATE,
                             buckets=BucketSpec(lengths=(len(waves[0]),)))
    sep.separate_all(waves, max_batch=BATCH)
    sep.meter.compute_seconds = sep.meter.audio_seconds = 0.0
    sep.separate_all(waves, max_batch=BATCH)
    return sep.meter.rtf


def _si_sdri(est: np.ndarray, refs: np.ndarray, mixes: np.ndarray) -> float:
    from amss_tpu_torch.ops.metrics import sdr_improvement

    return float(sdr_improvement(torch.from_numpy(est).double(), torch.from_numpy(refs).double(),
                                 torch.from_numpy(mixes).double()).mean())


def _rows_against_live(what: str, got: np.ndarray, live: np.ndarray, emb_err: np.ndarray
                       ) -> dict:
    """Per-row SI-SDR of ``got`` against the live path's ``live`` in the best
    speaker order; a row under AGREE_MIN_DB whose embeddings agree within
    EMBED_TOL is k-means' seeding tie (ROADMAP C.2)."""
    db = _db(got, live, best_order=True)
    low = [i for i in range(len(db)) if db[i] < AGREE_MIN_DB]
    say(f"  {what} against the live path, best speaker order: min {db.min():.2f} dB, median "
        f"{np.median(db):.2f} dB, {len(low)} of {len(db)} rows under {AGREE_MIN_DB:g} dB")
    unexplained = [i for i in low if emb_err[i] > EMBED_TOL]
    if unexplained:
        raise AssertionError(f"{what}: rows {unexplained} differ and so do their embeddings")
    if low:
        say(f"  rows {low}: their embeddings agree within {EMBED_TOL:g} of the peak, so "
            "k-means' seeding tie (ROADMAP C.2) picked other seeds")
    return dict(min_db=float(db.min()), median_db=float(np.median(db)), rows_below=low,
                per_row_db=db.tolist())


def phase_artifact_c1(model, kept: dict, workdir: str) -> tuple[dict, dict]:
    """c1_dpcl exported for cuda and served from a fresh process with no
    model module; its launches against phase 3's, its SI-SDRi on phase 4's
    mixtures, its rows against phase 4's live estimates, and the traced
    BLSTM against the live one, the kernel (embeddings, and phase 3's RTF)."""
    from amss_tpu_torch.infer.export import export_serving
    from amss_tpu_torch.ops.kernels.blstm import bilstm_layer

    out_dir = os.path.join(workdir, "c1_artifact")
    t0 = time.perf_counter()
    export_serving(model, out_dir, lengths=ART_LENGTHS, batch=BATCH, platforms=("cuda",),
                   sample_rate=SAMPLE_RATE)
    export_s = time.perf_counter() - t0
    sizes = {f: os.path.getsize(os.path.join(out_dir, f)) for f in sorted(os.listdir(out_dir))}
    say(f"  export (c1, buckets {ART_LENGTHS}, batch {BATCH}, cuda): {export_s:.2f} s, files "
        f"{sizes}")
    waves = phase3_waves()
    inp, outp = os.path.join(workdir, "art_in.npz"), os.path.join(workdir, "art_out.npz")
    np.savez(inp, waves=np.stack(waves), quality=kept["mixes"])
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", ARTIFACT_CHILD, out_dir, inp, outp], cwd=REPO,
                          capture_output=True, text=True, timeout=ART_CHILD_TIMEOUT_S)
    child_s = time.perf_counter() - t0
    log(proc.stderr[-4000:])
    if proc.returncode != 0:
        raise AssertionError(f"the artifact's process failed ({proc.returncode})")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    if child["model_modules"] or child["device"] != "cuda":
        raise AssertionError(f"the artifact's process imported {child['model_modules']} "
                             f"and ran on {child['device']}")
    calls = N_UTTS // BATCH
    per_call = kmeans_per_call(model)
    for p, want in zip(child["passes"], (calls + 1, calls)):
        if p["launches"] != {"framed_matmul": want, "decode_ola": want, "kmeans": per_call * want}:
            raise AssertionError(f"the exported program launched {p['launches']}, phase 3 "
                                 f"launches {want} of B1 and B2 and {per_call * want} of the "
                                 f"k-means kernels in that pass")
    res = np.load(outp)
    if res["est"].shape != (N_UTTS, 2, len(waves[0])) or not np.isfinite(res["est"]).all():
        raise AssertionError(f"the artifact returned {res['est'].shape}")
    si_sdri = _si_sdri(res["quality"], kept["refs"], kept["mixes"])
    say(f"  artifact from a fresh process (no model module): load {child['load_s']:.2f} s, "
        f"warm-up {child['passes'][0]['warmup_s']:.2f} s, rtf {child['passes'][1]['rtf']:.6f} "
        f"(pass 1 {child['passes'][0]['rtf']:.6f}), "
        f"{child['passes'][1]['utterances_per_s']:.2f} utterances/s, launches per pass "
        f"{[p['launches'] for p in child['passes']]}, si_sdri {si_sdri:.3f} dB; process "
        f"{child_s:.2f} s")
    if not si_sdri >= QUALITY_MIN_DB:
        raise AssertionError(f"the artifact's SI-SDRi {si_sdri:.3f} dB < {QUALITY_MIN_DB} dB")

    # the live BLSTM is the kernel: a launch a layer of each batch, none traced
    layers = blstm_per_call(model)
    b0 = bilstm_layer.launches
    live, traced = embeddings_both(model, kept["mixes"])
    want = layers * -(-len(kept["mixes"]) // BATCH)
    if bilstm_layer.launches - b0 != want:
        raise AssertionError(f"the live embeddings launched {bilstm_layer.launches - b0} BLSTM "
                             f"kernels, want {want}")
    peak = np.abs(live).max()
    emb_err = np.abs(traced - live).reshape(len(live), -1).max(axis=1) / peak
    say(f"  c1 embeddings, traced against the live BLSTM (the kernel, {want} launches) on the "
        f"card: {emb_err.max():.3e} of the peak at most (tol {EMBED_TOL:g})")
    if not emb_err.max() <= EMBED_TOL:
        raise AssertionError(f"traced and live embeddings differ by {emb_err.max():.3e}")
    rows = _rows_against_live("artifact", res["quality"], kept["est"], emb_err)

    # ROADMAP Z.3: phase 3's serving with the live BLSTM (the kernel) and the
    # traced one, in turns; a turn is two passes of a new separator, the
    # first with its warm-up call, as phase 3's
    rtf = {"kernel": [], "traced": []}
    for path in ("kernel", "traced", "traced", "kernel"):
        b0 = bilstm_layer.launches
        if path == "traced":
            with _traced_blstm(model):
                rtf[path].append(_rtf_pass(model, waves))
        else:
            rtf[path].append(_rtf_pass(model, waves))
        want = layers * (2 * calls + 1) if path == "kernel" else 0
        if bilstm_layer.launches - b0 != want:
            raise AssertionError(f"a {path} turn launched {bilstm_layer.launches - b0} BLSTM "
                                 f"kernels, want {want}")
    say(f"  live c1 serving (phase 3's utterances, pass 2) with the BLSTM kernel: rtf "
        f"{rtf['kernel']}; with the traced BLSTM: {rtf['traced']}")
    out = dict(export_s=export_s, files=sizes, load_s=child["load_s"],
               warmup_s=child["passes"][0]["warmup_s"], rtf_pass1=child["passes"][0]["rtf"],
               rtf_pass2=child["passes"][1]["rtf"],
               utterances_per_s=child["passes"][1]["utterances_per_s"],
               process_s=child_s, si_sdri_db=si_sdri, embed_err=float(emb_err.max()),
               rows=rows, live_rtf_kernel=rtf["kernel"], live_rtf_traced=rtf["traced"])
    return out, child["passes"][1]["launches"]


def phase_artifact_int8(model, kept: dict, quality: dict, workdir: str) -> dict:
    """c1 exported int8 (bucket QUALITY_T): the program on the dequantized
    weights bit for bit the fp32 artifact's on them, its rows against the
    live model on the dequantized weights, its SI-SDRi and the bytes saved."""
    from amss_tpu_torch.infer.export import ServingArtifact, export_serving
    from amss_tpu_torch.infer.quantize import dequantize_state_dict, quantize_state_dict
    from amss_tpu_torch.infer.streaming import BucketSpec, StreamingSeparator
    from amss_tpu_torch.weights import params_from_jax, params_to_jax

    q_dir, f_dir = os.path.join(workdir, "c1_int8"), os.path.join(workdir, "c1_artifact")
    t0 = time.perf_counter()
    export_serving(model, q_dir, lengths=(QUALITY_T,), batch=BATCH, platforms=("cuda",),
                   sample_rate=SAMPLE_RATE, quantize="int8")
    export_s = time.perf_counter() - t0
    q_art, f_art = ServingArtifact(q_dir), ServingArtifact(f_dir)
    f_art.params = q_art.params
    mixes = list(kept["mixes"])
    got = np.stack(q_art.separate_all(mixes))
    if not np.array_equal(got, np.stack(f_art.separate_all(mixes))):
        raise AssertionError("the int8 artifact differs from the fp32 program on its weights")
    deq = params_from_jax(model.cfg, dequantize_state_dict(quantize_state_dict(
        params_to_jax(model))))
    live = np.stack(StreamingSeparator(deq, sample_rate=SAMPLE_RATE, buckets=BucketSpec(
        lengths=(QUALITY_T,))).separate_all(mixes, max_batch=BATCH))
    live_emb, traced = embeddings_both(deq, kept["mixes"])
    emb_err = (np.abs(traced - live_emb).reshape(len(live_emb), -1).max(axis=1)
               / np.abs(live_emb).max())
    rows = _rows_against_live("int8 artifact against the live model on the dequantized "
                              "weights", got, live, emb_err)
    si_sdri = _si_sdri(got, kept["refs"], kept["mixes"])
    f32 = os.path.getsize(os.path.join(f_dir, "params.msgpack"))
    q8 = os.path.getsize(os.path.join(q_dir, "params.msgpack"))
    say(f"  int8 c1 artifact: si_sdri {si_sdri:.3f} dB (live fp32 {quality['si_sdri_db']:.3f}), "
        f"params.msgpack {q8} bytes against {f32} ({1 - q8 / f32:.4f} saved; meta "
        f"{q_art.meta['params_bytes_saved_frac']}), export {export_s:.2f} s")
    if not si_sdri >= QUALITY_MIN_DB:
        raise AssertionError(f"the int8 artifact's SI-SDRi {si_sdri:.3f} dB < {QUALITY_MIN_DB}")
    return dict(export_s=export_s, si_sdri_db=si_sdri, params_bytes=q8, params_bytes_f32=f32,
                bytes_saved_frac=q_art.meta["params_bytes_saved_frac"], rows=rows)


def _push_ms(art, seconds: int) -> float:
    """ms per push of ``seconds`` of noise per stream through a
    RealtimeArtifact, the first push left out."""
    rng = np.random.default_rng(1)
    n = seconds * SAMPLE_RATE // art.c
    chunks = (rng.standard_normal((n, art.b, art.c)) * 0.3).astype(np.float32)
    art.reset()
    art.push(chunks[0])
    t0 = time.perf_counter()
    for c in chunks[1:]:
        art.push(c)
    return 1e3 * (time.perf_counter() - t0) / (n - 1)


def phase_artifact_realtime(workdir: str) -> tuple[dict, dict]:
    """c7_causal exported for cuda at REALTIME_CHUNK x 1 and x RT_ART_STREAMS
    streams: streamed against offline (phase 13's bound), ragged streams
    against each alone, ms per push."""
    from amss_tpu_torch.infer.export import RealtimeArtifact, export_realtime
    from amss_tpu_torch.infer.streaming import BucketSpec, StreamingSeparator
    from amss_tpu_torch.weights import load_model_from_run

    model = load_model_from_run(C7_CAUSAL)
    refs = quality_mixtures(2)
    mixes = refs.sum(axis=1)
    offline = np.stack(StreamingSeparator(model, sample_rate=SAMPLE_RATE, buckets=BucketSpec(
        lengths=(QUALITY_T,))).separate_all(list(mixes), max_batch=BATCH))
    out, arts = {}, {}
    for streams in (1, RT_ART_STREAMS):
        d = os.path.join(workdir, f"c7_rt_b{streams}")
        t0 = time.perf_counter()
        export_realtime(model, d, chunk_samples=REALTIME_CHUNK, n_streams=streams,
                        platforms=("cuda",), sample_rate=SAMPLE_RATE)
        out[f"export_s_b{streams}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        arts[streams] = RealtimeArtifact(d)
        out[f"load_s_b{streams}"] = time.perf_counter() - t0
    reset_launches()
    one = arts[1]
    streamed = np.stack([one.separate_stream(m) for m in mixes])
    out["one_stream_err"] = _stream_err(streamed, offline, f"artifact, one stream, {len(mixes)} "
                                        f"mixtures, chunk {REALTIME_CHUNK}")
    lengths = [QUALITY_T - 613 * i for i in range(RT_ART_STREAMS)]
    waves = [mixes[i, :n] for i, n in enumerate(lengths)]
    got = arts[RT_ART_STREAMS].separate_streams(waves)
    alone = [model.separate(torch.from_numpy(w[None]).cuda())[0].cpu().numpy() for w in waves]
    out["ragged_err"] = max(_stream_err(g, a, f"artifact stream {i} of {RT_ART_STREAMS} "
                                        f"({len(a[0])} samples) against it alone offline")
                            for i, (g, a) in enumerate(zip(got, alone)))
    for streams, art in arts.items():
        out[f"ms_per_push_b{streams}"] = _push_ms(art, REALTIME_SPEED_SECONDS)
    say(f"  realtime artifact (c7, chunk {REALTIME_CHUNK}): {out['ms_per_push_b1']:.3f} ms per "
        f"push at 1 stream, {out[f'ms_per_push_b{RT_ART_STREAMS}']:.3f} at {RT_ART_STREAMS}; "
        f"export {out['export_s_b1']:.2f} s, load {out['load_s_b1']:.2f} s")
    launches = launch_counts()
    if any(launches.values()):
        raise AssertionError(f"c7 launched {launches}; the gate is closed at 32/16")
    return out, launches


SERVER_REQUESTS = 16
CLI_TRAIN_STEPS = 20


def _http(port: int, method: str, path: str, body: bytes | None = None,
          headers: dict | None = None) -> tuple[int, bytes]:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _serving(artifact_dir: str):
    """A SeparationServer on 127.0.0.1 and an ephemeral port, answering from
    a thread; the caller shuts it down."""
    import threading

    from amss_tpu_torch.infer.server import SeparationServer

    srv = SeparationServer(artifact_dir, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def phase_server(workdir: str) -> dict:
    """The phase-24 c1 artifact and the phase-26 one-stream c7 artifact behind
    SeparationServer: each response equal to the direct artifact call, and
    the request latency."""
    import base64

    from amss_tpu_torch.infer.export import RealtimeArtifact, ServingArtifact
    from amss_tpu_torch.infer.server import wav_bytes_decode, wav_bytes_encode

    out = {}
    art_dir = os.path.join(workdir, "c1_artifact")
    srv = _serving(art_dir)
    try:
        status, data = _http(srv.port, "GET", "/healthz")
        if status != 200 or json.loads(data)["kind"] != "offline":
            raise AssertionError(f"/healthz answered {status} {data[:200]}")
        direct = ServingArtifact(art_dir)
        # ragged lengths, each served under its own prefix mask (ROADMAP C.5)
        waves = [w[: len(w) - 997 * i] for i, w in enumerate(phase3_waves()[:SERVER_REQUESTS])]
        lat = []
        for i, w in enumerate(waves):
            body = wav_bytes_encode(w, SAMPLE_RATE)
            t0 = time.perf_counter()
            status, data = _http(srv.port, "POST", "/separate", body)
            lat.append(1e3 * (time.perf_counter() - t0))
            if status != 200:
                raise AssertionError(f"/separate answered {status}: {data[:300]}")
            got = [base64.b64decode(s) for s in json.loads(data)["speakers"]]
            est = direct.separate_all([wav_bytes_decode(body)[0]])[0]
            if got != [wav_bytes_encode(e, SAMPLE_RATE) for e in est]:
                raise AssertionError(f"request {i}: the server's answer differs from the "
                                     "artifact's")
        status, _ = _http(srv.port, "POST", "/separate", wav_bytes_encode(waves[0], 16000))
        if status != 400:
            raise AssertionError(f"a 16 kHz wav got {status}, want 400")
        out["separate_ms"] = lat
        say(f"  server, c1 artifact: {SERVER_REQUESTS} /separate requests of "
            f"{len(waves[-1]) / SAMPLE_RATE:.2f}-{len(waves[0]) / SAMPLE_RATE:.2f} s, each equal "
            f"to the artifact's answer; latency median {np.median(lat):.2f} ms, first (the "
            f"program's load and warm-up) {lat[0]:.2f} ms")
    finally:
        srv.shutdown()

    rt_dir = os.path.join(workdir, "c7_rt_b1")
    srv = _serving(rt_dir)
    try:
        direct = RealtimeArtifact(rt_dir)
        mix = quality_mixtures(2, 1).sum(axis=1)[0]
        c = direct.c
        n = -(-(len(mix) + direct.lag) // c)
        padded = np.zeros(n * c, np.float32)
        padded[: len(mix)] = mix
        end = direct.front.frames_for(len(mix))
        _http(srv.port, "POST", "/stream/reset", b"")
        blocks, lat = [], []
        for i in range(n):
            chunk = padded[i * c : (i + 1) * c]
            t0 = time.perf_counter()
            status, data = _http(srv.port, "POST", "/stream/push", chunk.tobytes(),
                                 {"X-End-Frame": str(end)})
            lat.append(1e3 * (time.perf_counter() - t0))
            if status != 200:
                raise AssertionError(f"/stream/push answered {status}: {data[:300]}")
            blocks.append(np.frombuffer(data, np.float32).reshape(-1, c))
        want = [direct.push(padded[i * c : (i + 1) * c], end_frame=end) for i in range(n)]
        if not np.array_equal(np.stack(blocks), np.stack(want)):
            raise AssertionError("the stream server's blocks differ from the artifact's")
        streamed = np.concatenate(blocks, axis=-1)[:, direct.lag : direct.lag + len(mix)]
        offline = direct.separate_stream(mix)
        out["stream_err"] = _stream_err(streamed, offline, "server stream against the artifact's "
                                        "whole utterance")
        out["push_ms"] = lat
        say(f"  server, c7 realtime artifact: {n} /stream/push requests of {c} samples, each "
            f"equal to the artifact's block; latency median {np.median(lat):.2f} ms")
    finally:
        srv.shutdown()
    return out


def _cli(argv: list[str]) -> list[str]:
    """``amss_tpu_torch.cli.main(argv)`` on the card; its stdout lines."""
    import contextlib
    import io

    from amss_tpu_torch.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main(argv)
    lines = buf.getvalue().strip().splitlines()
    log("\n".join(lines[-5:]))
    return lines


def phase_cli(workdir: str) -> tuple[dict, dict]:
    """make-synthetic, train, evaluate, separate, export, separate-exported
    and profile through the CLI on the card (c1 at full width, a few steps);
    the profile's trace must hold the card's kernels."""
    from amss_tpu_torch.infer.evaluate import write_wav

    corpus, runs = os.path.join(workdir, "cli_corpus"), os.path.join(workdir, "cli_runs")
    secs = {}

    def timed(name, argv):
        t0 = time.perf_counter()
        lines = _cli(argv)
        secs[name] = time.perf_counter() - t0
        return lines

    reset_launches()
    timed("make-synthetic", ["make-synthetic", "--out", corpus, "--speakers", "12",
                             "--seconds", "20"])
    common = ["--recipe", "c1", "--corpus", corpus]
    lines = timed("train", ["train", *common, "--workdir", runs, "--steps",
                            str(CLI_TRAIN_STEPS), "--valid-every", str(CLI_TRAIN_STEPS // 2)])
    run_dir = next(x.split("run dir: ")[1] for x in lines if x.startswith("run dir: "))
    ev = json.loads(timed("evaluate", ["evaluate", *common, "--run-dir", run_dir,
                                       "--n-mixtures", "8"])[-1])
    if not np.isfinite(ev["si_sdri"]):
        raise AssertionError(f"evaluate printed {ev}")
    mix_wav = os.path.join(workdir, "cli_mix.wav")
    write_wav(mix_wav, quality_mixtures(2, 1).sum(axis=1)[0], SAMPLE_RATE)
    timed("separate", ["separate", *common, "--run-dir", run_dir, "--wav", mix_wav, "--out",
                       os.path.join(workdir, "cli_sep")])
    exp = os.path.join(workdir, "cli_export")
    files = json.loads(timed("export", ["export", *common, "--run-dir", run_dir, "--out", exp,
                                        "--lengths", str(QUALITY_T), "--serve-batch", "2",
                                        "--platforms", "cuda"])[-1])["files"]
    timed("separate-exported", ["separate-exported", "--export-dir", exp, "--wav", mix_wav,
                                "--out", os.path.join(workdir, "cli_sep2")])
    for d in ("cli_sep", "cli_sep2"):
        if sorted(os.listdir(os.path.join(workdir, d))) != ["cli_mix_spk0.wav", "cli_mix_spk1.wav"]:
            raise AssertionError(f"{d}: {os.listdir(os.path.join(workdir, d))}")
    trace_dir = os.path.join(workdir, "cli_trace")
    pr = json.loads(timed("profile", ["profile", *common, "--workdir", runs,
                                      "--profile-steps", "5", "--trace-dir", trace_dir])[-1])
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    if not kernels:
        raise AssertionError("the profile's trace holds no CUDA kernel event")
    launches = launch_counts()
    say(f"  CLI on the card (c1, {CLI_TRAIN_STEPS} steps): seconds {secs}; evaluate si_sdri "
        f"{ev['si_sdri']:.3f} dB on 8 mixtures, rtf {ev['rtf']:.6f}; export files {files}; "
        f"profile p50 {pr['p50_s'] * 1e3:.3f} ms a step, {kernels} kernel events in the trace; "
        f"launches {launches}")
    return dict(seconds=secs, evaluate=ev, export_files=files, profile=pr,
                trace_kernel_events=kernels), launches


def phase_native_fill(store) -> dict:
    """The native fill against the numpy loop and ``Mixer.batch``, bit for
    bit, on FILL_ROUNDS plans of FILL_BATCH x 2 x FILL_CHUNK; host ms of
    each."""
    from amss_tpu_torch.data.mixer import Mixer
    from amss_tpu_torch.data.native import batch_fill, batch_fill_ref
    from amss_tpu_torch.ops.kernels.build import build_native

    lib, build_s = build_native()
    mixer = Mixer(store, nb_speakers=2, chunk_samples=FILL_CHUNK, seed=0)
    shards = [store.waveform(s) for s in store.speakers]
    ms: dict = {"native": [], "numpy": []}
    for step in range(FILL_ROUNDS):
        plan = mixer.plan("train", step, FILL_BATCH)
        args = (shards, plan.speaker_ids.ravel(), plan.starts.ravel(), plan.gains.ravel())
        outs = {}
        for name, fill in (("native", batch_fill), ("numpy", batch_fill_ref)):
            outs[name] = np.empty((FILL_BATCH * 2, FILL_CHUNK), np.float32)
            t0 = time.perf_counter()
            fill(outs[name], *args)
            ms[name].append((time.perf_counter() - t0) * 1e3)
        batch = mixer.batch("train", step, FILL_BATCH).sources.reshape(outs["native"].shape)
        if not (np.array_equal(outs["native"], outs["numpy"]) and np.array_equal(batch,
                                                                              outs["native"])):
            raise AssertionError(f"the native fill differs from the numpy loop at step {step}")
    med = {k: float(np.median(v)) for k, v in ms.items()}
    say(f"  g++ build {build_s:.2f} s ({os.path.relpath(lib, REPO)}); {FILL_ROUNDS} batches of "
        f"{FILL_BATCH} x 2 x {FILL_CHUNK} bit for bit the numpy loop's and Mixer.batch's; host "
        f"ms a batch (median): native {med['native']:.3f}, numpy {med['numpy']:.3f}")
    return dict(build_s=build_s, batch=FILL_BATCH, chunk=FILL_CHUNK, rounds=FILL_ROUNDS,
                host_ms=med, host_ms_all=ms)


def training_scale_corpus(workdir: str):
    """DC_SPEAKERS synthetic v1 speakers of DC_SECONDS from seed 0, the
    corpus ``make_synthetic_corpus`` writes, synthesised on a thread pool and
    written until DC_BUILD_BUDGET_S has passed; returns (store, facts)."""
    from concurrent.futures import ThreadPoolExecutor

    from amss_tpu_torch.data.store import SpeakerStore
    from amss_tpu_torch.data.synthetic import SyntheticStore

    t0 = time.perf_counter()
    synth = SyntheticStore(DC_SPEAKERS, DC_SECONDS, SAMPLE_RATE, seed=0, version=1)
    store = SpeakerStore.create(os.path.join(workdir, "corpus_large"), SAMPLE_RATE)
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        futures = [pool.submit(synth.waveform, name) for name in synth.speakers]
        for name, fut in zip(synth.speakers, futures):
            if time.perf_counter() - t0 > DC_BUILD_BUDGET_S:
                pool.shutdown(cancel_futures=True)
                break
            store.add_speaker(name, fut.result(), normalize=False)
    store.finalize()
    secs = time.perf_counter() - t0
    n = len(store.speakers)
    cut = "" if n == DC_SPEAKERS else (f" (cut from {DC_SPEAKERS}: the "
                                       f"{DC_BUILD_BUDGET_S:g} s budget)")
    say(f"  corpus {n} x {DC_SECONDS:g} s{cut}: {secs:.2f} s")
    return store, dict(speakers=n, seconds=DC_SECONDS, write_s=secs, cut=n != DC_SPEAKERS)


def phase_device_corpus(store) -> dict:
    """The corpus uploaded once (bytes resident, seconds), ``gather`` against
    ``Mixer.batch`` on c6_flagship's plans of the first steps, and a gather's
    device time."""
    from amss_tpu_torch.data.device_corpus import DeviceCorpus
    from amss_tpu_torch.data.mixer import Mixer
    from amss_tpu_torch.utils.timing import time_ms

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    corpus = DeviceCorpus(store, FILL_CHUNK)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated() - before
    host = corpus.flat.cpu()  # the same bytes, uploaded again and timed alone
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = host.to("cuda")
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) * 1e3
    del again, host
    mixer = Mixer(store, nb_speakers=2, chunk_samples=FILL_CHUNK, seed=0)
    worst = 0.0
    for step in range(DC_CHECK_STEPS):
        plan, hb = mixer.plan("train", step, FILL_BATCH), mixer.batch("train", step, FILL_BATCH)
        args = [torch.from_numpy(a).cuda() for a in (plan.speaker_ids, plan.starts, plan.gains)]
        got = corpus.gather(*args).cpu().numpy()
        err = float(np.abs(got - hb.sources).max())
        lsb = float(plan.gains.max()) / 32767.0 + 1e-6
        worst = max(worst, err / lsb)
        if not err <= lsb:
            raise AssertionError(f"gather at step {step}: {err} from Mixer.batch > {lsb}")
    gather_ms = time_ms(lambda: corpus.gather(*args))
    elems = FILL_BATCH * 2 * FILL_CHUNK
    # int16 read and float32 written once each, the plan's few hundred bytes aside
    gather_bound_ms = elems * (2 + 4) / PEAK_HBM_BYTES * 1e3
    say(f"  DeviceCorpus: {corpus.nbytes / 1e6:.1f} MB int16 ({len(store.speakers)} rows of "
        f"{corpus.row}), {resident / 1e6:.1f} MB more allocated on the card; built and "
        f"uploaded in {build_s:.3f} s, the upload alone {upload_ms:.3f} ms; gather of "
        f"{FILL_BATCH} x 2 x {FILL_CHUNK} within {worst:.3f} LSB x gain of Mixer.batch on steps "
        f"0-{DC_CHECK_STEPS - 1}, {gather_ms:.4f} ms on the card (bound {gather_bound_ms:.4f} "
        f"ms, bytes)")
    return dict(nbytes=corpus.nbytes, row=corpus.row, resident_bytes=resident,
                build_s=build_s, upload_ms=upload_ms, gather_ms=gather_ms,
                gather_bound_ms=gather_bound_ms, gather_worst_lsb=worst)


def timed_steps(tr, make_batch, start: int, n: int) -> float:
    """ms per step of ``n`` train steps from ``start``, each batch drawn by
    ``make_batch(step)`` on ``fit``'s prefetch thread and put on the card as
    ``fit`` puts it, between two synchronisations."""
    from amss_tpu_torch.data.prefetch import Prefetcher

    batches = Prefetcher(make_batch=make_batch, put_batch=tr._device_batch, start_step=start,
                         end_step=start + n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for _, batch in batches:
            tr._train_step(batch)
        torch.cuda.synchronize()
    finally:
        batches.close()
    return (time.perf_counter() - t0) * 1e3 / n


def phase_train_flagship(store, workdir: str) -> tuple[dict, dict]:
    """c6_flagship's own config.json through Trainer.fit with its corpus on
    the card; returns (results, launches by path)."""
    from amss_tpu_torch.train.engine import Trainer
    from amss_tpu_torch.utils.config import recipe_from_dict

    with open(os.path.join(C6_FLAGSHIP, "config.json")) as f:
        recipe = recipe_from_dict(json.load(f))
    t = recipe.train
    say(f"  checkpoints/c6_flagship/config.json: device_data {t.device_data}, "
        f"{recipe.model.sep.compute_dtype} TCN, batch {t.batch_size} x {t.chunk_samples}, EMA "
        f"{t.ema_decay}, steps_per_call {t.steps_per_call}; cut: steps {t.steps} -> "
        f"{C6F_STEPS}, valid_every {t.valid_every} -> {C6F_VALID_EVERY}")
    if not t.device_data:
        raise AssertionError("c6_flagship's config no longer asks for device data")
    recipe = dataclasses.replace(recipe, train=dataclasses.replace(
        t, steps=C6F_STEPS, valid_every=C6F_VALID_EVERY))
    t = recipe.train
    t0 = time.perf_counter()
    tr = Trainer(recipe, store, workdir=os.path.join(workdir, "runs"))
    setup_s = time.perf_counter() - t0
    say(f"  run dir {os.path.basename(tr.dir)}; Trainer with the corpus uploaded "
        f"({tr.corpus.nbytes / 1e6:.1f} MB): {setup_s:.2f} s")
    state0 = tr.init_state()
    plan0 = tr._draw("train", 0, t.batch_size)
    host0 = tr.mixer.batch("train", 0, t.batch_size)
    tr.load_state(state0)
    with torch.no_grad():
        loss_dev = float(tr.model.loss_from_batch(tr.prep(tr._device_batch(plan0)))[0])
        loss_host = float(tr.model.loss_from_batch(tr.prep(tr._device_batch(host0)))[0])
    gap = abs(loss_dev - loss_host)
    say(f"  first step's loss on one plan: device data {loss_dev:.6f}, host data "
        f"{loss_host:.6f} ({gap:.2e} apart, tol {DEVICE_HOST_LOSS_TOL:g})")
    if not gap <= DEVICE_HOST_LOSS_TOL:
        raise AssertionError(f"device-data loss {loss_dev} against host-data {loss_host}")
    per_step = check_train_step_needs_no_host_sync(tr, plan0)
    k = _gate_launches(recipe.model)
    want_step = {"framed_matmul": 2 * k["framed_matmul"], "decode_ola": k["decode_ola"],
                 "multi_adam": 2}
    if per_step != want_step:
        raise AssertionError(f"a flagship step launched {per_step}, want {want_step}")
    tr.load_state(state0)
    valid0 = tr.valid_loss()
    final, launches, fit_s, peak = _fit_counted(tr, state0)
    n_valid = -(-t.steps // t.valid_every)
    want = {"framed_matmul": want_step["framed_matmul"] * t.steps
            + k["framed_matmul"] * (t.valid_steps + 3) * n_valid,
            "decode_ola": k["decode_ola"] * (t.steps + (t.valid_steps + 1) * n_valid),
            "multi_adam": 2 * t.steps}
    if launches != want:
        raise AssertionError(f"flagship training launches {launches}, want {want}")
    valid = _valid_losses(tr.dir)
    if len(valid) != n_valid or not valid[-1] < valid0:
        raise AssertionError(f"flagship valid loss {valid0} at init, {valid} after training")
    check_checkpoint_reloads(tr, final, t.steps)
    ms = window_ms_per_step(tr.dir, skip={TRAIN_LOG_EVERY})
    turns = []
    step = t.steps
    for mode in ("device", "host", "host", "device"):
        draw = tr._draw if mode == "device" else tr.mixer.batch
        turns.append((mode, timed_steps(tr, lambda s, d=draw: d("train", s, t.batch_size), step,
                                        SPEED_TURN_STEPS)))
        step += SPEED_TURN_STEPS
    say(f"  c6_flagship from its config, device data, {t.steps} steps: {ms:.3f} ms/step median "
        f"in fit after warm-up, peak memory {peak / 2**30:.3f} GiB, valid loss (EMA weights) "
        f"{valid0:.4f} -> {[round(v, 4) for v in valid]}, launches {launches}; ms a step in "
        f"turns of {SPEED_TURN_STEPS}: {[(m, round(v, 3)) for m, v in turns]}")
    out = dict(steps=t.steps, batch=t.batch_size, chunk=t.chunk_samples, fit_s=fit_s,
               ms_per_step=ms, peak_bytes=peak, valid_loss_init=valid0, valid_loss=valid,
               launches_per_step=per_step, setup_s=setup_s, loss_device=loss_dev,
               loss_host=loss_host, turns_ms=turns,
               cut={"steps": [96000, C6F_STEPS], "valid_every": [9600, C6F_VALID_EVERY]})
    return out, {"c6_flagship_device_train": launches}


def bf16_card_matches_cpu(tr, state0: dict, batch0, what: str, tols: tuple,
                          prepare=None) -> dict:
    """One bf16 step from ``state0`` on ``batch0``, card against CPU: the
    loss relative to the CPU's, the gradients' distance over all tensors and
    each tensor's (save those whose exact gradient is 0), relative to the
    CPU's norms, each held to its entry of ``tols``."""
    loss_tol, grad_tol, tensor_tol = tols
    (loss_gpu, _, grads_gpu), (loss_cpu, _, grads_cpu) = card_and_cpu_step(
        tr, state0, batch0, prepare)
    grads_gpu = {n: g for n, g in grads_gpu.items() if g is not None}
    grads_cpu = {n: g for n, g in grads_cpu.items() if g is not None}
    if set(grads_gpu) != set(grads_cpu):
        raise AssertionError(f"{what}: gradients {sorted(grads_gpu)} against {sorted(grads_cpu)}")
    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    diff = sum(float(((grads_gpu[n] - g) ** 2).sum()) for n, g in grads_cpu.items())
    grad_rel = (diff / sum(float((g**2).sum()) for g in grads_cpu.values())) ** 0.5
    skip = cancelled_gradients(tr.model)
    tensor_rel = {n: float((grads_gpu[n] - g).norm() / g.norm()) for n, g in grads_cpu.items()
                  if n not in skip}
    worst = max(tensor_rel, key=tensor_rel.get)
    say(f"  {what}, one bf16 step: loss card {loss_gpu:.7f} cpu {loss_cpu:.7f} ({loss_rel:.2e} "
        f"relative, tol {loss_tol:g}); gradients {grad_rel:.3e} apart over all "
        f"{len(grads_cpu)} tensors (tol {grad_tol:g}), worst tensor {worst} "
        f"{tensor_rel[worst]:.3e} (tol {tensor_tol:g})")
    if not (loss_rel <= loss_tol and grad_rel <= grad_tol and tensor_rel[worst] <= tensor_tol):
        raise AssertionError(f"{what}: bf16 step card against CPU {loss_rel}, {grad_rel}, "
                             f"{worst} {tensor_rel[worst]}")
    if not all(torch.isfinite(g).all() for g in grads_gpu.values()):
        raise AssertionError(f"{what}: non-finite gradients on the card")
    return dict(loss_card=loss_gpu, loss_cpu=loss_cpu, loss_rel_err=loss_rel,
                grad_rel_err=grad_rel, worst_tensor=worst, worst_tensor_rel_err=tensor_rel[worst])


def _bf16(cfg):
    """A model config with its separator in bfloat16."""
    return dataclasses.replace(cfg, sep=dataclasses.replace(cfg.sep, compute_dtype="bfloat16"))


def blstm_bf16_costs(model) -> dict:
    """c1_dpcl's 2x300 BLSTM at phase 3's serving shape ([8, 1001, 129]):
    host-clock ms of one forward (between synchronisations, launches
    included) of the packed float32 path, the bf16 loop, and cuDNN's own bf16
    LSTM (not the port's path: it keeps h, and maybe c, in bf16), with the
    latter's largest difference from the bf16 loop over the loop's peak."""
    import copy

    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(BATCH, model.cfg.front.frames_for(SECONDS * SAMPLE_RATE),
                    model.cfg.front.feature_dim, generator=gen, device="cuda")
    lstm = model.blstm
    cudnn_bf16 = copy.deepcopy(lstm.lstm).to(torch.bfloat16)

    def cudnn():
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False):
            return cudnn_bf16(x.to(torch.bfloat16))[0].float()

    paths = {"packed_f32": lambda: lstm(x),
             "loop_bf16": lambda: lstm(x, compute_dtype=torch.bfloat16), "cudnn_bf16": cudnn}
    out, ms = {}, {}
    with torch.no_grad():
        for name, fn in paths.items():
            out[name] = fn()
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            ms[name] = float(np.median(times))
    ref = out["loop_bf16"]
    err = {n: float((out[n] - ref).abs().max() / ref.abs().max()) for n in ("packed_f32",
                                                                             "cudnn_bf16")}
    say(f"  c1's BLSTM forward at {tuple(x.shape)}: ms {ms}; largest difference from the bf16 "
        f"loop over its peak {err}")
    return dict(shape=list(x.shape), ms=ms, err_vs_loop_bf16=err)


def phase_c1_bf16(store, workdir: str, speed_f32: dict) -> tuple[dict, dict]:
    """The c1 recipe in bf16 with device data: its first step card against
    CPU, fit with B1/B2 launched as often as float32 c1's fit, ms a step
    against float32; then checkpoints/c1_dpcl served in bf16 (phase 3's RTF,
    phase 4's gated quality); returns (results, launches by path)."""
    from amss_tpu_torch.configs.recipes import c1_stft_dpcl
    from amss_tpu_torch.train.engine import Trainer
    from amss_tpu_torch.weights import load_model_from_run

    def trainer(dtype: str):
        r = c1_stft_dpcl(steps=C1_BF16_STEPS, valid_every=C1_BF16_STEPS // 2, device_data=True)
        r = dataclasses.replace(r, model=dataclasses.replace(r.model, sep=dataclasses.replace(
            r.model.sep, compute_dtype=dtype)))
        return Trainer(r, store, workdir=os.path.join(workdir, f"runs_{dtype}"))

    tr, tr32 = trainer("bfloat16"), trainer("float32")
    t = tr.recipe.train
    state0 = tr.init_state()
    step_check = bf16_card_matches_cpu(tr, state0, tr.mixer.batch("train", 0, t.batch_size),
                                       "c1 2x300", C1_BF16_TOLS)
    per_step = check_train_step_needs_no_host_sync(tr, tr._draw("train", 0, t.batch_size))
    tr.load_state(state0)
    valid0 = tr.valid_loss()
    final, launches, fit_s, peak = _fit_counted(tr, state0)
    _, launches32, fit32_s, _ = _fit_counted(tr32, tr32.init_state())
    n_valid = -(-t.steps // t.valid_every)
    want = {"framed_matmul": 2 * t.steps + 2 * t.valid_steps * n_valid + 3 * n_valid,
            "decode_ola": n_valid, "multi_adam": 2 * t.steps}
    if not launches == launches32 == want:
        raise AssertionError(f"bf16 c1 fit launched {launches}, float32 {launches32}, "
                             f"want {want}")
    valid = _valid_losses(tr.dir)
    if len(valid) != n_valid or not np.isfinite(valid).all():
        raise AssertionError(f"bf16 c1 valid loss {valid}")
    check_checkpoint_reloads(tr, final, t.steps)
    turns = []
    for name, trn in (("bfloat16", tr), ("float32", tr32), ("float32", tr32),
                      ("bfloat16", tr)):
        turns.append((name, timed_steps(trn, lambda s, d=trn._draw: d("train", s, t.batch_size),
                                        t.steps, 5)))
    say(f"  c1 bf16 with device data, {t.steps} steps: fit {fit_s:.2f} s (float32 "
        f"{fit32_s:.2f} s), peak memory {peak / 2**30:.3f} GiB, valid loss {valid0:.4f} -> "
        f"{[round(v, 4) for v in valid]}, launches {launches} (float32's {launches32}), per "
        f"step {per_step}; ms a step in turns of 5: {[(m, round(v, 3)) for m, v in turns]}")

    model = load_model_from_run(CKPT)
    costs = blstm_bf16_costs(model)
    model.cfg = _bf16(model.cfg)
    speed, serve_launches = phase_speed(model)
    reset_launches()
    q = phase_quality(model)
    q_launches = launch_counts()
    calls = -(-QUALITY_N // BATCH) + 1
    if q_launches != {"framed_matmul": calls, "decode_ola": calls, "multi_adam": 0}:
        raise AssertionError(f"bf16 quality launched {q_launches}, want {calls} each")
    say(f"  c1_dpcl served in bf16 (64 x 8 s, batch 8): rtf {speed['rtf_pass2']:.6f} (float32, "
        f"phase 3: {speed_f32['rtf_pass2']:.6f}), launches {serve_launches}; quality si_sdri "
        f"{q['si_sdri_db']:.3f} dB, 95% CI {q['ci95']} (gate {C1_BF16_QUALITY_MIN_DB} dB)")
    if not q["si_sdri_db"] >= C1_BF16_QUALITY_MIN_DB:
        raise AssertionError(f"bf16 c1 SI-SDRi {q['si_sdri_db']:.3f} dB < "
                             f"{C1_BF16_QUALITY_MIN_DB} dB")
    out = dict(steps=t.steps, batch=t.batch_size, chunk=t.chunk_samples, fit_s=fit_s,
               fit_f32_s=fit32_s, peak_bytes=peak, valid_loss_init=valid0, valid_loss=valid,
               launches_per_step=per_step, turns_ms=turns, serving=speed, quality=q,
               blstm_costs=costs, **step_check)
    return out, {"c1_bf16_train": launches, "c1_f32_device_train": launches32,
                 "c1_bf16_serve": serve_launches, "c1_bf16_quality": q_launches}


def phase_bf16_dual_path_and_enh(store, workdir: str) -> dict:
    """One bf16 step of c6 with the DPRNN trunk and of the enh refiner over
    c1_dpcl (from one first pass), card against CPU."""
    from amss_tpu_torch.configs.recipes import c6_dual_path, enh_dpcl
    from amss_tpu_torch.train.engine import Trainer

    out = {}
    for name, recipe, tols in (("c6_dprnn", c6_dual_path("dprnn"), DP_BF16_TOLS),
                               ("enh", enh_dpcl(CKPT), C1_BF16_TOLS)):
        recipe = dataclasses.replace(recipe, model=_bf16(recipe.model))
        tr = Trainer(recipe, store, workdir=os.path.join(workdir, f"runs_bf16_{name}"))
        state0 = tr.init_state()
        batch0 = tr.mixer.batch("train", 0, recipe.train.batch_size)
        prepare = None
        if name == "enh":  # one first pass for both (ROADMAP C.2)
            mix0 = tr._dequantize(tr._device_batch(batch0))["sources"].sum(dim=1)
            est0 = tr.model.base.separate(mix0)

            def prepare(model, device, est0=est0):
                model._frozen[0] = FixedFirstPass(model.base, est0.to(device))

        out[name] = bf16_card_matches_cpu(tr, state0, batch0, name, tols, prepare)
    return out


# -- phases 33-36: several cards, checked on one ------------------------------


def _host_ms(fn, rounds: int = 10) -> float:
    """Median host-clock ms of ``fn`` between synchronisations."""
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_sharded_stft(gen: torch.Generator) -> tuple[dict, dict]:
    """The time-sharded STFT over four entries of ``cuda:0`` against the
    unsharded plain STFT: the largest difference, B1's launches (one a shard)
    and host-clock ms of each, with B1 on the whole signal beside them."""
    from amss_tpu_torch.ops import stft
    from amss_tpu_torch.ops.kernels import framed_matmul as b1
    from amss_tpu_torch.parallel.mesh import make_mesh
    from amss_tpu_torch.parallel.timeshard import sharded_stft_ri

    win, hop = 256, 64
    mesh = make_mesh(devices=["cuda:0"] * 4)
    x = torch.randn(2, SHARD_STFT_SAMPLES, generator=gen, device="cuda")
    reset_launches()
    re, im = sharded_stft_ri(x, win, hop, mesh)
    torch.cuda.synchronize()
    launches = launch_counts()
    if launches != {"framed_matmul": len(mesh), "decode_ola": 0, "multi_adam": 0}:
        raise AssertionError(f"the sharded STFT launched {launches}, want B1 once a shard")
    want_re, want_im = stft.stft_ri(x, win, hop)
    err = max(check("sharded STFT re", re, want_re, SHARD_STFT_TOL),
              check("sharded STFT im", im, want_im, SHARD_STFT_TOL))
    ms = {"sharded": _host_ms(lambda: sharded_stft_ri(x, win, hop, mesh)),
          "b1_whole": _host_ms(lambda: b1.stft_ri(x, win, hop)),
          "plain": _host_ms(lambda: stft.stft_ri(x, win, hop))}
    say(f"  sharded STFT [2, {SHARD_STFT_SAMPLES}] at {win}/{hop} over {len(mesh)} entries of "
        f"cuda:0: {err:.3e} from the plain STFT (tol {SHARD_STFT_TOL:g}), launches {launches}, "
        f"host ms {ms}")
    return dict(shape=[2, SHARD_STFT_SAMPLES], mesh=[str(d) for d in mesh], max_abs_err=err,
                tol=SHARD_STFT_TOL, ms=ms), launches


def phase_long_sharded(model, long_form: dict) -> tuple[dict, dict]:
    """Phase 9's serving over the mesh MESH: its mixtures' long-form through
    ``separate_long_sharded``, twice, c1's SI-SDRi gated as phase 9's, its
    launches and RTF, the BLSTM's masks all prefixes (ROADMAP C.5); then
    c6_flagship's long-form over the mesh against ``separate_long``."""
    from amss_tpu_torch.infer.long import chunk_layout, separate_long, separate_long_sharded
    from amss_tpu_torch.infer.streaming import BucketSpec, StreamingSeparator
    from amss_tpu_torch.models import blstm
    from amss_tpu_torch.ops.metrics import sdr_improvement, si_sdr
    from amss_tpu_torch.parallel.mesh import make_mesh
    from amss_tpu_torch.weights import load_model_from_run

    mesh = make_mesh(devices=MESH)
    t = SECONDS * SAMPLE_RATE
    mixes, refs = long_mixtures()
    rng = np.random.default_rng(0)
    shorts = [rng.standard_normal(t).astype(np.float32) * 0.3 for _ in range(N_UTTS)]
    half = N_UTTS // 2
    waves = shorts[:half] + mixes + shorts[half:]
    sep = StreamingSeparator(model, sample_rate=SAMPLE_RATE, buckets=BucketSpec(lengths=(t,)),
                             mesh=mesh)
    group = len(mesh) * 8  # the default chunk_batch_per_device, CHUNK_BATCH
    calls = N_UTTS // BATCH + sum(
        len(mesh) * -(-len(chunk_layout(len(m), t)[1]) // group) for m in mixes)
    masks, prefix = {"calls": 0, "raised": 0}, blstm.prefix_lengths

    def counted_prefix(mask):
        masks["calls"] += 1
        try:
            return prefix(mask)
        except ValueError:
            masks["raised"] += 1
            raise

    blstm.prefix_lengths = counted_prefix
    try:
        reset_launches()
        sep.separate_all(waves, max_batch=BATCH)
        after1 = launch_counts()
        sep.meter.compute_seconds = sep.meter.audio_seconds = 0.0
        sep.meter.utterances = sep.meter.calls = 0
        est = sep.separate_all(waves, max_batch=BATCH)
        launches = launch_counts()
    finally:
        blstm.prefix_lengths = prefix
    if launches["multi_adam"]:
        raise AssertionError(f"long-form serving over the mesh launched the optimizer: {launches}")
    for n in KERNELS:
        if launches[n] - after1[n] != calls:
            raise AssertionError(f"{n}: {launches[n] - after1[n]} launches in pass 2 over the "
                                 f"mesh, want {calls}")
    if masks["raised"]:
        raise AssertionError(f"the BLSTM refused {masks['raised']} masks (ROADMAP C.5)")
    if [e.shape for e in est] != [(2, len(w)) for w in waves] or not all(
            np.isfinite(e).all() for e in est):
        raise AssertionError("long-form over the mesh returned wrong shapes or non-finite samples")
    imp = np.array([float(sdr_improvement(torch.from_numpy(e[None]).double(),
                                          torch.from_numpy(r[None]).double(),
                                          torch.from_numpy(x[None]).double())[0])
                    for e, r, x in zip(est[half : half + len(mixes)], refs, mixes)])
    m = sep.meter
    say(f"  c1 long-form over {[str(d) for d in mesh]}: rtf {m.rtf:.6f} on pass 2 (phase 9: "
        f"{long_form['rtf_pass2']:.6f}), si_sdri of the long mixtures {imp.mean():.3f} dB "
        f"(phase 9: {long_form['si_sdri_db']:.3f}; gate {LONG_QUALITY_MIN_DB}), launches "
        f"{launches} ({calls} calls a pass), the BLSTM's prefix check ran {masks['calls']} "
        f"times and refused none")
    if not imp.mean() >= LONG_QUALITY_MIN_DB:
        raise AssertionError(f"long-form over the mesh: SI-SDRi {imp.mean():.3f} dB < "
                             f"{LONG_QUALITY_MIN_DB} dB")

    c6 = load_model_from_run(C6_FLAGSHIP)
    c6_rows = []
    for mix in mixes:
        ref = separate_long(c6, mix, chunk=t)
        got = separate_long_sharded(c6, mix, chunk=t, mesh=mesh)
        n_chunks = len(chunk_layout(len(mix), t)[1])
        db = si_sdr(torch.from_numpy(got).double(), torch.from_numpy(ref).double())
        c6_rows.append(dict(seconds=len(mix) // SAMPLE_RATE, chunks=n_chunks,
                            # one slice of 8 is separate_long's one group of 8
                            same_shapes=n_chunks == 8,
                            max_abs_diff=float(np.abs(got - ref).max()),
                            min_db=float(db.min())))
    worst = min(r["min_db"] for r in c6_rows)
    same = [r["max_abs_diff"] for r in c6_rows if r["same_shapes"]]
    other = [r["max_abs_diff"] for r in c6_rows if not r["same_shapes"]]
    say(f"  c6_flagship long-form over the mesh against separate_long: min {worst:.2f} dB "
        f"(bound {MESH_C6_MIN_DB}); largest difference where the slices have the groups' "
        f"shapes {max(same):.3e}, elsewhere {max(other):.3e}")
    if not worst >= MESH_C6_MIN_DB:
        raise AssertionError(f"c6_flagship over the mesh: {worst:.2f} dB < {MESH_C6_MIN_DB}")
    out = dict(mesh=[str(d) for d in mesh], rtf_pass2=m.rtf, rtf_pass2_phase9=long_form["rtf_pass2"],
               si_sdri_db=float(imp.mean()), calls_pass2=calls, prefix_checks=masks["calls"],
               c6_flagship=c6_rows)
    return out, launches


def capture_first_step(tr) -> dict:
    """Keep the first step's metrics and the gradients Adam receives (after
    the ranks' reduction, before the clip) in the returned dict."""
    seen: dict = {}
    step, opt_step = tr._train_step, tr.opt.step

    def train_step(*a, **k):
        m = step(*a, **k)
        seen.setdefault("metrics", {n: float(v) for n, v in m.items()})
        return m

    def adam(grads):
        seen.setdefault("grads", {n: g.detach().cpu().clone() for n, g in zip(tr.names, grads)})
        return opt_step(grads)

    tr._train_step, tr.opt.step = train_step, adam
    return seen


def rank_fit(rank: int, world: int, recipe, corpus: str, out_dir: str, device: str) -> None:
    """One rank of phase 35 (a fresh process): fit ``recipe`` in its own run
    dir ``out_dir/rank<r>`` on ``device``; save its first step, final
    parameters, fit seconds and launches to ``out_dir/rank<r>.pt``."""
    from amss_tpu_torch.data.store import SpeakerStore
    from amss_tpu_torch.models import blstm
    from amss_tpu_torch.parallel.mesh import all_reduce_mean
    from amss_tpu_torch.train.engine import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    tr = Trainer(recipe, SpeakerStore(corpus), run_dir=os.path.join(out_dir, f"rank{rank}"),
                 device=device)
    seen = capture_first_step(tr)
    masks, prefix = [], blstm.prefix_lengths  # ROADMAP C.5: the masks the BLSTM gets

    def counted_prefix(mask):
        masks.append(mask.shape)
        return prefix(mask)

    blstm.prefix_lengths = counted_prefix
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    final = tr.fit(log_every=TRAIN_LOG_EVERY)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    blstm.prefix_lengths = prefix
    launches = launch_counts()
    # one step's reduction alone: the gradients' bucket over the ranks
    reduce_ms = _host_ms(lambda: all_reduce_mean([p.detach() for p in tr.params]), rounds=5)
    torch.save({"first": seen, "params": {n: v.cpu() for n, v in final["params"].items()},
                "step": final["step"], "fit_s": fit_s, "launches": launches,
                "reduce_ms": reduce_ms, "prefix_checks": len(masks)},
               os.path.join(out_dir, f"rank{rank}.pt"))


def _ranks_against_one(recipe, store, workdir: str, name: str, backend: str = "gloo",
                       world: int = RANK_WORLD) -> dict:
    """``recipe`` (data_axis = ``world``) fit by ``world`` ranks on
    ``cuda:0``; with more than one rank, their parameters bit for bit equal,
    their first step against one process fed their rows, rank 0 alone
    writing; returns the numbers."""
    from amss_tpu_torch.data.mixer import Batch
    from amss_tpu_torch.parallel.mesh import run_ranks
    from amss_tpu_torch.train.engine import Trainer

    out_dir = os.path.join(workdir, f"ranks_{name}")
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    run_ranks(rank_fit, world, backend, args=(recipe, store.root, out_dir, "cuda:0"),
              devices=["cuda:0"] * world)
    wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(world)]
    steps = recipe.train.steps
    if any(r["step"] != steps for r in ranks):
        raise AssertionError(f"{name}: ranks ended at {[r['step'] for r in ranks]}, want {steps}")
    # ms a step: the median of fit's logged windows after the first where there
    # are any (rank 0 logs the ranks' steps), else fit's wall time over its steps
    windowed = steps > TRAIN_LOG_EVERY
    ms = (window_ms_per_step(os.path.join(out_dir, "rank0"), skip={TRAIN_LOG_EVERY})
          if windowed else 1e3 * ranks[0]["fit_s"] / steps)
    out = dict(world=world, backend=backend, steps=steps, wall_s=wall, ms_per_step=ms,
               ms_per_step_of=("windows after the first" if windowed else "fit's wall time"),
               fit_s=[r["fit_s"] for r in ranks], reduce_ms=[r["reduce_ms"] for r in ranks],
               prefix_checks=[r["prefix_checks"] for r in ranks],
               launches=[r["launches"] for r in ranks],
               first_loss=ranks[0]["first"]["metrics"])
    if not all(np.isfinite(list(r["first"]["metrics"].values())).all() for r in ranks):
        raise AssertionError(f"{name}: non-finite first-step metrics")
    if world == 1:
        return out
    diff = max(float((p - ranks[r]["params"][n]).abs().max())
               for n, p in ranks[0]["params"].items() for r in range(1, world))
    if diff != 0.0:
        raise AssertionError(f"{name}: parameters differ across ranks by {diff}")
    ckpt0 = sorted(f for f in os.listdir(os.path.join(out_dir, "rank0")) if f.startswith("ckpt"))
    others = [f for r in range(1, world) if os.path.isdir(os.path.join(out_dir, f"rank{r}"))
              for f in os.listdir(os.path.join(out_dir, f"rank{r}"))]
    if not ckpt0 or others:
        raise AssertionError(f"{name}: rank 0 wrote {ckpt0}, the others {others}")

    one = Trainer(dataclasses.replace(recipe, train=dataclasses.replace(recipe.train,
                                                                        data_axis=1)),
                  store, run_dir=os.path.join(out_dir, "one"))
    seen = capture_first_step(one)
    one.load_state(one.init_state())
    local = recipe.train.batch_size // world
    parts = [one.mixer.batch("train", 0, local, host=r) for r in range(world)]
    one._train_step(one._device_batch(Batch(
        sources=np.concatenate([p.sources for p in parts]),
        speaker_ids=np.concatenate([p.speaker_ids for p in parts]),
        gains=np.concatenate([p.gains for p in parts]))))
    loss_rel = max(abs(ranks[0]["first"]["metrics"][k] - v) / abs(v)
                   for k, v in seen["metrics"].items())
    scale = max(float(g.abs().max()) for g in seen["grads"].values())
    grad_err = max(float((ranks[0]["first"]["grads"][n] - g).abs().max())
                   for n, g in seen["grads"].items()) / scale
    one_fit = Trainer(one.recipe, store, run_dir=os.path.join(out_dir, "one_fit"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_fit.fit(log_every=TRAIN_LOG_EVERY)
    torch.cuda.synchronize()
    one_ms = (window_ms_per_step(one_fit.dir, skip={TRAIN_LOG_EVERY}) if windowed
              else 1e3 * (time.perf_counter() - t0) / steps)
    say(f"  {name} on {world} ranks on cuda:0 over {backend}, {steps} steps: parameters equal "
        f"across ranks (max diff {diff}), rank 0 alone wrote {ckpt0}; first step against one "
        f"process on the ranks' rows: loss {loss_rel:.2e} relative (tol {RANK_LOSS_TOL:g}), "
        f"gradients {grad_err:.2e} of the largest (tol {RANK_GRAD_TOL:g}); ms a step in fit "
        f"({out['ms_per_step_of']}) {ms:.2f} against one process's {one_ms:.2f}; one "
        f"reduction of the gradients {[round(v, 2) for v in out['reduce_ms']]} ms; launches "
        f"per rank {out['launches']}; the BLSTM's prefix check ran "
        f"{out['prefix_checks']} times a rank (ROADMAP C.5: a refusal would fail the rank); "
        f"ranks' wall {wall:.2f} s")
    if not (loss_rel <= RANK_LOSS_TOL and grad_err <= RANK_GRAD_TOL):
        raise AssertionError(f"{name}: {world} ranks against one process: loss {loss_rel}, "
                             f"gradients {grad_err}")
    out.update(params_max_diff=diff, loss_rel_err=loss_rel, grad_err=grad_err,
               one_process_ms_per_step=one_ms, rank0_files=ckpt0)
    return out


def phase_ranks(workdir: str) -> tuple[dict, dict]:
    """Data-parallel training on ``cuda:0``: the c1 recipe at full width on
    two gloo ranks, c1_count's config.json on two, and a one-rank NCCL group
    (phase 35)."""
    from amss_tpu_torch.configs.recipes import c1_stft_dpcl
    from amss_tpu_torch.utils.config import recipe_from_dict

    store = training_corpus(workdir)
    out = {}
    r = c1_stft_dpcl(steps=RANK_STEPS, valid_every=RANK_STEPS)
    out["c1"] = _ranks_against_one(
        dataclasses.replace(r, train=dataclasses.replace(r.train, data_axis=RANK_WORLD)),
        store, workdir, "c1")
    with open(os.path.join(C1_COUNT, "config.json")) as f:
        rc = recipe_from_dict(json.load(f))
    rc = dataclasses.replace(rc, train=dataclasses.replace(
        rc.train, steps=RANK_COUNT_STEPS, valid_every=RANK_COUNT_STEPS, data_axis=RANK_WORLD))
    out["c1_count"] = _ranks_against_one(rc, store, workdir, "c1_count")
    r1 = c1_stft_dpcl(steps=RANK_NCCL_STEPS, valid_every=RANK_NCCL_STEPS)
    out["nccl"] = _ranks_against_one(r1, store, workdir, "c1_nccl", backend="nccl", world=1)
    say(f"  one NCCL rank, {RANK_NCCL_STEPS} steps: first loss {out['nccl']['first_loss']}, "
        f"ms a step {out['nccl']['ms_per_step']:.2f} ({out['nccl']['ms_per_step_of']}, "
        f"NCCL's set-up in it), one reduction of the gradients {out['nccl']['reduce_ms']} ms")
    return out, {"ranks_c1": out["c1"]["launches"][0],
                 "ranks_c1_count": out["c1_count"]["launches"][0],
                 "rank_nccl": out["nccl"]["launches"][0]}


def phase_artifact_bf16(kept: dict, workdir: str, artifact_launches: dict,
                        bf16_rtf: float) -> tuple[dict, dict]:
    """checkpoints/c1_dpcl in bf16 exported for cuda and served as phase 24
    serves float32's: from a fresh process with no model module, its quality
    gated as phase 31's, its output against live bf16 serving, its launches
    against phase 24's artifact, its RTF beside phase 31's live bf16 RTF."""
    from amss_tpu_torch.infer.export import export_serving
    from amss_tpu_torch.infer.streaming import BucketSpec, StreamingSeparator
    from amss_tpu_torch.ops.kernels.kmeans import SOFT_LAUNCHES, fit_launches
    from amss_tpu_torch.weights import load_model_from_run

    model = load_model_from_run(CKPT)
    model.cfg = _bf16(model.cfg)
    out_dir = os.path.join(workdir, "c1_bf16_artifact")
    t0 = time.perf_counter()
    export_serving(model, out_dir, lengths=ART_LENGTHS, batch=BATCH, platforms=("cuda",),
                   sample_rate=SAMPLE_RATE)
    export_s = time.perf_counter() - t0
    ep = torch.export.load(os.path.join(out_dir, f"serving_t{ART_LENGTHS[0]}_b{BATCH}.cuda.pt2"))
    ops = sum("blstm_bf16_layer" in str(n.target) for n in ep.graph.nodes)
    if ops != model.blstm.layers:
        raise AssertionError(f"the bf16 program holds {ops} recurrence operators, want "
                             f"{model.blstm.layers}")
    waves = phase3_waves()
    inp, outp = os.path.join(workdir, "bf16_in.npz"), os.path.join(workdir, "bf16_out.npz")
    np.savez(inp, waves=np.stack(waves), quality=kept["mixes"])
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", ARTIFACT_CHILD, out_dir, inp, outp], cwd=REPO,
                          capture_output=True, text=True, timeout=ART_CHILD_TIMEOUT_S)
    child_s = time.perf_counter() - t0
    log(proc.stderr[-4000:])
    if proc.returncode != 0:
        raise AssertionError(f"the bf16 artifact's process failed ({proc.returncode})")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    if child["model_modules"] or child["device"] != "cuda":
        raise AssertionError(f"the bf16 artifact's process imported {child['model_modules']} "
                             f"and ran on {child['device']}")
    calls = N_UTTS // BATCH
    per_call = fit_launches(2, 10) + SOFT_LAUNCHES  # deep clustering's fit and soft masks
    for p, want in zip(child["passes"], (calls + 1, calls)):
        k = per_call * want
        if p["launches"] != {"framed_matmul": want, "decode_ola": want, "kmeans": k}:
            raise AssertionError(f"the bf16 program launched {p['launches']}, want {want} of B1 "
                                 f"and B2 and {k} of the k-means kernels")
    if child["passes"][1]["launches"] != artifact_launches:
        raise AssertionError(f"the bf16 program launched {child['passes'][1]['launches']}, the "
                             f"float32 one {artifact_launches}")
    res = np.load(outp)
    si_sdri = _si_sdri(res["quality"], kept["refs"], kept["mixes"])
    live = np.stack(StreamingSeparator(model, sample_rate=SAMPLE_RATE,
                                       buckets=BucketSpec(lengths=(QUALITY_T,)))
                    .separate_all(list(kept["mixes"]), max_batch=BATCH))
    err = float(np.abs(res["quality"] - live).max() / np.abs(live).max())
    p1, p2 = child["passes"]
    say(f"  bf16 c1 artifact: export {export_s:.2f} s ({ops} recurrence operators), from a "
        f"fresh process (no model module): load {child['load_s']:.2f} s, warm-up "
        f"{p1['warmup_s']:.2f} s, rtf {p2['rtf']:.6f} (pass 1 {p1['rtf']:.6f}; live bf16, "
        f"phase 31: {bf16_rtf:.6f}), launches per pass {[p['launches'] for p in child['passes']]} "
        f"(float32's pass 2: {artifact_launches}), si_sdri {si_sdri:.3f} dB (gate "
        f"{C1_BF16_QUALITY_MIN_DB}); against live bf16 serving {err:.3e} of the peak (tol "
        f"{BF16_ARTIFACT_TOL:g}); process {child_s:.2f} s")
    if not si_sdri >= C1_BF16_QUALITY_MIN_DB:
        raise AssertionError(f"the bf16 artifact's SI-SDRi {si_sdri:.3f} dB < "
                             f"{C1_BF16_QUALITY_MIN_DB} dB")
    if not err <= BF16_ARTIFACT_TOL:
        raise AssertionError(f"the bf16 artifact against live bf16 serving: {err:.3e}")
    out = dict(export_s=export_s, operators=ops, load_s=child["load_s"],
               warmup_s=p1["warmup_s"], rtf_pass1=p1["rtf"], rtf_pass2=p2["rtf"],
               live_bf16_rtf_phase31=bf16_rtf, utterances_per_s=p2["utterances_per_s"],
               process_s=child_s, si_sdri_db=si_sdri, err_vs_live=err)
    return out, p2["launches"]


def _ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest difference in ulps of ``want``'s largest magnitude."""
    got, want = got.detach(), want.detach()
    top = float(want.abs().max())
    if top == 0.0:
        return 0.0 if torch.equal(got, want) else float("inf")
    return float((got - want).abs().max()) / float(np.spacing(np.float32(top)))


def foreach_adam(params, grads, mu, nu, lr: float, bc1: float, bc2: float,
                 max_norm: float) -> None:
    """The clip and Adam in ``torch._foreach_*`` operations: phase 37's
    library yardstick (the port never calls it)."""
    from amss_tpu_torch.train.optim import ADAM_B1, ADAM_B2, ADAM_EPS

    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    g = torch._foreach_mul(grads, scale)
    torch._foreach_mul_(mu, ADAM_B1)
    torch._foreach_add_(mu, g, alpha=1 - ADAM_B1)
    torch._foreach_mul_(nu, ADAM_B2)
    torch._foreach_addcmul_(nu, g, g, value=1 - ADAM_B2)
    den = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, ADAM_EPS)
    torch._foreach_addcdiv_(params, torch._foreach_div(mu, bc1), den, value=-float(lr))


def convtasnet_luo2019():
    """The port's ``ModelConfig`` of the benchmark's Conv-TasNet configuration
    (the ``port`` entry of ``benchmark/configs/convtasnet_luo2019.json``)."""
    from amss_tpu_torch.utils.config import FrontConfig, ModelConfig, SeparatorConfig

    with open(CONVTASNET_CONFIG) as f:
        p = json.load(f)["port"]
    return ModelConfig(front=FrontConfig(**p.pop("front")), sep=SeparatorConfig(**p.pop("sep")),
                       **p)


def phase_dprnn() -> dict:
    """DPRNN-TasNet at its published widths served through
    ``StreamingSeparator`` against the benchmark's plain reference on the
    card, with the BLSTM's path of each of a call's 12 layers counted."""
    from collections import Counter

    from amss_tpu_torch.infer.streaming import StreamingSeparator
    from amss_tpu_torch.models.blstm import blstm_path
    from amss_tpu_torch.ops.kernels.blstm import MAX_ROWS
    from amss_tpu_torch.models.dprnn import segments
    from amss_tpu_torch.ops.kernels.blstm import bilstm_layer
    from amss_tpu_torch.train.engine import make_model
    from amss_tpu_torch.utils import profiling
    from amss_tpu_torch.utils.config import FrontConfig, ModelConfig, SeparatorConfig

    sys.path.insert(0, os.path.join(REPO, "benchmark"))  # the reference imports bm, reference
    from reference import dprnn as ref

    with open(DPRNN_CONFIG) as f:
        cfg = json.load(f)
    with open(DPRNN_LIMITS) as f:
        tol = json.load(f)["numbers"]["serve.judged_error"]["limit"]
    p = dict(cfg["port"])
    mc = ModelConfig(front=FrontConfig(**p.pop("front")), sep=SeparatorConfig(**p.pop("sep")),
                     **p)
    model = make_model(mc)
    model.init_parameters(torch.Generator().manual_seed(38))
    model = model.cuda().eval()
    if sum(t.numel() for t in model.parameters()) != cfg["parameters"]:
        raise AssertionError("DPRNN-TasNet's parameters differ from the configuration's count")
    gen = np.random.default_rng(38)
    waves = [(0.1 * gen.standard_normal(n)).astype(np.float32) for n in DPRNN_LENGTHS]
    torch.backends.cudnn.allow_tf32 = False
    sep = StreamingSeparator(model, sample_rate=cfg["sample_rate"])
    sep.separate_all(waves, max_batch=len(waves))  # warm-up
    torch.cuda.synchronize()
    launched = (bilstm_layer.launches, bilstm_layer.rows_launches)
    t0 = time.perf_counter()
    with profiling.recording():
        outs = sep.separate_all(waves, max_batch=len(waves))
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    launched = (bilstm_layer.launches - launched[0], bilstm_layer.rows_launches - launched[1])
    kept = profiling.spans()
    paths = [r for r in kept if r.name in ("dprnn.intra", "dprnn.inter")]
    took = Counter(f"{r.name}:{r.attrs['blstm_path']}" for r in paths)
    k, hd = mc.sep.chunk_frames, mc.sep.expansion * mc.sep.hidden
    own = [segments(mc.front.frames_for(n), k) for n in DPRNN_LENGTHS]
    grid = segments(mc.front.frames_for(49152), k)
    rows = {"dprnn.intra": sum(own), "dprnn.inter": len(own) * k}
    rule = {name: blstm_path("cuda", torch.float32, torch.float32, n, hd, False, False, False)
            for name, n in rows.items()}
    want = Counter({f"{name}:{path}": mc.sep.repeats for name, path in rule.items()})
    steps = {"dprnn.intra": (sum(own) * k, sum(own) * k),
             "dprnn.inter": (len(own) * k * grid, k * sum(own))}
    for r in paths:
        if (r.attrs["rows"], (r.attrs["steps"], r.attrs["valid_steps"])) != (
                rows[r.name], steps[r.name]):
            raise AssertionError(f"{r.name}: attributes {r.attrs}, want rows {rows[r.name]}, "
                                 f"(steps, valid) {steps[r.name]}")
    if took != want:
        raise AssertionError(f"the BLSTM paths of a call {dict(took)}, want {dict(want)}")
    # each layer on the kernel of its rows: a launch of the row-parallel one
    # past MAX_ROWS, of the other below
    want_launches = tuple(sum(mc.sep.repeats for name, n in rows.items()
                              if rule[name] == "kernel" and (n > MAX_ROWS) == many)
                          for many in (False, True))
    if launched != want_launches:
        raise AssertionError(f"a call launched {launched} BLSTM kernels (few rows, many rows), "
                             f"want {want_launches}")
    syncs = sum(r.name == "sync.lengths" for r in kept)
    calls = sum(r.name == "serve.batch" for r in kept)
    if (syncs, calls) != (1, 1):
        raise AssertionError(f"{syncs} sync.lengths in {calls} batch calls, want one in one")
    weights = {n: t.detach() for n, t in model.named_parameters()}
    errs = []
    with torch.no_grad():
        for wave, est in zip(waves, outs):
            mix = torch.from_numpy(wave).cuda()
            errs.append(ref.judge(mix, torch.as_tensor(est).cuda(), weights,
                                  cfg)["serve.judged_error"])
    device_ms = {name: sum(r.device_ms or 0.0 for r in paths if r.name == name)
                 for name in rows}
    out = dict(lengths=list(DPRNN_LENGTHS), own_chunks=own, grid_chunks=grid, rows=rows,
               blstm_paths=dict(took), blstm_launches=launched, rel_err=errs, tol=tol,
               wall_ms=wall_ms, device_ms=device_ms, syncs_per_call=syncs / calls)
    say(f"  DPRNN-TasNet [8 x 35000-48000 in 49152] on the card: paths {dict(took)}, "
        f"launches (few rows, many rows) {launched}, "
        f"rows {rows}, against the reference at most {max(errs):.3e} (limit {tol:g}), a "
        f"call {wall_ms:.1f} ms, intra/inter device {device_ms} ms, syncs a call "
        f"{syncs / calls}")
    if not max(errs) <= tol:
        raise AssertionError(f"DPRNN-TasNet against the reference: {errs} (limit {tol})")
    return out


def _multi_adam_list(what: str, cfg, gen: torch.Generator) -> dict:
    """Phase 37 on the trainable parameters of ``cfg``: the kernel pair
    against the plain version and the ``torch._foreach_*`` yardstick from one
    state (a step without the clip, one with it), then the pair's device time
    against its bound (bytes) and the three paths' device and host times."""
    from amss_tpu_torch.ops.kernels.build import check_launch, load_library
    from amss_tpu_torch.train import optim
    from amss_tpu_torch.train.engine import make_model
    from amss_tpu_torch.train.optim import (
        ADAM_B1, ADAM_B2, ADAM_EPS, Adam, adam_ref, bias_corrections, constant_schedule,
        global_norm)
    from amss_tpu_torch.utils.timing import time_ms

    dev = torch.device("cuda")
    params = [p for p in make_model(cfg).to(dev).parameters() if p.requires_grad]
    n = sum(p.numel() for p in params)

    def state() -> dict:
        return {"p": [p.detach().clone() for p in params],
                "m": [torch.zeros_like(p) for p in params],
                "v": [torch.zeros_like(p) for p in params]}

    def grads_of_norm(norm: float) -> list:
        g = [torch.randn(p.shape, generator=gen, device=dev) for p in params]
        s = norm / float(global_norm(g))
        return [x * s for x in g]

    opt = Adam(params, constant_schedule(MADAM_LR), MADAM_MAX_NORM)
    plain, own, lib = state(), state(), state()
    agree = {}
    for count, (case, target) in enumerate((("no_clip", 0.5 * MADAM_MAX_NORM),
                                            ("clip", 3.0 * MADAM_MAX_NORM)), start=1):
        grads = grads_of_norm(target)
        bc1, bc2 = bias_corrections(count)
        opt.step(grads)
        norm = opt.kernel.norm
        # the plain version given the kernel's norm (bit for bit), and with its own
        with mock.patch.object(optim, "global_norm", lambda tensors: norm):
            adam_ref(plain["p"], grads, plain["m"], plain["v"], MADAM_LR, bc1, bc2,
                     MADAM_MAX_NORM)
        adam_ref(own["p"], grads, own["m"], own["v"], MADAM_LR, bc1, bc2, MADAM_MAX_NORM)
        foreach_adam(lib["p"], grads, lib["m"], lib["v"], MADAM_LR, bc1, bc2, MADAM_MAX_NORM)
        torch.cuda.synchronize()
        exact = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))
        ours = {"p": params, "m": opt.state.mu, "v": opt.state.nu}

        def pairs(other):
            return [(a, b) for k in "pmv" for a, b in zip(ours[k], other[k])]

        agree[case] = dict(
            equal_given_norm=all(torch.equal(a, b) for a, b in pairs(plain)),
            kernel_ulps=max(_ulps(a, b) for a, b in pairs(own)),
            kernel_max_abs_err=max(max_err(a.detach(), b) for a, b in pairs(own)),
            norm=float(norm), norm_ulps=_ulps(norm, global_norm(grads)),
            norm_exact_ulps=abs(float(norm) - exact) / float(np.spacing(np.float32(exact))),
            library_rel_err=max(max_err(b, a.detach()) / max(float(a.detach().abs().max()), 1e-30)
                                for a, b in zip([*params, *opt.state.mu, *opt.state.nu],
                                                [*lib["p"], *lib["m"], *lib["v"]])))
        a = agree[case]
        say(f"  {what} step {count} ({case}, global norm {a['norm']:.7g}, "
            f"{a['norm_exact_ulps']:.3f} ulp from the exact one; the plain version's "
            f"{a['norm_ulps']:g} ulp from it): kernel against the plain version "
            f"{a['kernel_ulps']:g} ulp at most (max abs {a['kernel_max_abs_err']:.3e}), "
            f"bit-equal given the kernel's norm {a['equal_given_norm']}; foreach "
            f"{a['library_rel_err']:.3e} of the peak")
    if not all(a["equal_given_norm"] for a in agree.values()):
        raise AssertionError(f"{what}: the plain version given the kernel's norm differs: {agree}")
    if agree["no_clip"]["kernel_ulps"] != 0:
        raise AssertionError(f"{what}: a step without the clip is not bit-equal: "
                             f"{agree['no_clip']}")
    if not max(a["norm_exact_ulps"] for a in agree.values()) <= MADAM_NORM_ULPS:
        raise AssertionError(f"{what}: the kernel's norm: {agree} (tol {MADAM_NORM_ULPS} ulp of "
                             f"the exact one)")
    if not max(a["library_rel_err"] for a in agree.values()) <= MADAM_LIBRARY_TOL:
        raise AssertionError(f"{what}: the foreach yardstick disagrees: {agree}")

    # device times (CUDA graphs: the host's launching left out), then host times
    grads = grads_of_norm(3.0 * MADAM_MAX_NORM)
    bc1, bc2 = bias_corrections(3)
    kernel = opt.kernel
    ptrs = kernel._pointers(grads, opt.state.mu, opt.state.nu)
    partials = torch.empty(kernel.chunks + 1, dtype=torch.float32, device=dev)
    numbers = dict(max_norm=MADAM_MAX_NORM, b1=ADAM_B1, b2=ADAM_B2, eps=ADAM_EPS, lr=MADAM_LR,
                   bc1=bc1, bc2=bc2)
    clib = load_library()

    def norm_pass():
        check_launch(clib, "multi_adam norm", clib.amss_multi_adam_norm(
            kernel.plan.data_ptr(), ptrs.data_ptr(), partials.data_ptr(), len(params),
            kernel.chunks, torch.cuda.current_stream().cuda_stream))

    def plain_step():
        adam_ref(plain["p"], grads, plain["m"], plain["v"], MADAM_LR, bc1, bc2, MADAM_MAX_NORM)

    def lib_step():
        foreach_adam(lib["p"], grads, lib["m"], lib["v"], MADAM_LR, bc1, bc2, MADAM_MAX_NORM)

    nbytes = MADAM_BYTES * n
    out = dict(tensors=kernel.tensors, chunks=kernel.chunks, elements=n,
               ms=time_ms(lambda: kernel.launch(ptrs, **numbers)), norm_ms=time_ms(norm_pass),
               plain_ms=time_ms(plain_step, calls=2), library_ms=time_ms(lib_step, calls=5),
               bound_ms=nbytes / PEAK_HBM_BYTES * 1e3, bound_by="bytes", bytes=nbytes,
               host_ms={"kernel": _host_ms(lambda: opt.step(grads)),
                        "plain": _host_ms(plain_step), "library": _host_ms(lib_step)},
               agree=agree, norm_ulps_tol=MADAM_NORM_ULPS, library_tol=MADAM_LIBRARY_TOL)
    out["roofline_share"] = out["bound_ms"] / out["ms"]
    say(f"  {what}'s {out['tensors']} tensors, {n} elements, {out['chunks']} chunks: kernel "
        f"pair {out['ms']:.4f} ms (norm pass {out['norm_ms']:.4f}), bound "
        f"{out['bound_ms'] * 1e3:.2f} us ({MADAM_BYTES} B an element), plain "
        f"{out['plain_ms']:.4f} ms, foreach {out['library_ms']:.4f} ms; host clock a step: "
        f"{out['host_ms']}")
    return out


def phase_multi_adam(workdir: str) -> dict:
    """The multi-tensor clip and Adam on c6's parameter list and on the
    benchmark's Conv-TasNet's (``_multi_adam_list``; c6's at the top level),
    and two steps of a c6 Trainer with no host sync, two launches each and
    the ``train.optimizer`` span's attributes."""
    from amss_tpu_torch.configs.recipes import c6_tasnet
    from amss_tpu_torch.train.engine import Trainer
    from amss_tpu_torch.utils import profiling

    gen = torch.Generator(device="cuda").manual_seed(37)
    out = _multi_adam_list("c6", c6_tasnet().model, gen)
    out["convtasnet_luo2019"] = _multi_adam_list("convtasnet_luo2019", convtasnet_luo2019(), gen)

    # a Trainer's steps: two launches each, no host sync, the span's attributes
    store = training_corpus(workdir)
    tr = Trainer(c6_tasnet(steps=4, valid_every=4), store, workdir=os.path.join(workdir, "runs"))
    tr.load_state(tr.init_state())
    batch = tr._device_batch(tr.mixer.batch("train", 0, tr.recipe.train.batch_size))
    torch.cuda.synchronize()
    before = launch_counts()["multi_adam"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        with profiling.recording():
            for _ in range(2):
                tr._train_step(batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    kept = profiling.spans()
    launched = launch_counts()["multi_adam"] - before
    spans = {name: [r for r in kept if r.name == name]
             for name in ("train.optimizer", "train.clip")}
    want = {"tensors": len(tr.params), "chunks": tr.opt.kernel.chunks}
    if launched != 4:
        raise AssertionError(f"two c6 train steps launched the kernel pair {launched} times")
    if len(spans["train.optimizer"]) != 2 or any(
            {k: r.attrs.get(k) for k in want} != want for r in spans["train.optimizer"]):
        raise AssertionError(f"train.optimizer spans {[r.attrs for r in spans['train.optimizer']]}"
                             f", want attributes {want}")
    parents = {r.id for r in spans["train.optimizer"]}
    if len(spans["train.clip"]) != 2 or any(r.parent not in parents for r in spans["train.clip"]):
        raise AssertionError("train.clip is not inside train.optimizer")
    out["trainer"] = dict(launches_per_step=launched / 2, span_attrs=want,
                          optimizer_device_ms=[r.device_ms for r in spans["train.optimizer"]])
    say(f"  c6 Trainer: two steps with no host sync, {launched // 2} launches a step, "
        f"train.optimizer {want}, its stream time {out['trainer']['optimizer_device_ms']} ms")
    return out


def main() -> None:
    faulthandler.dump_traceback_later(TIME_LIMIT_S, exit=True)
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device (torch.cuda.is_available() is False)")

    # the port comes first: without it (the script alone) nothing is printed
    from amss_tpu_torch.ops.kernels.build import build, find_nvcc, load_library
    from amss_tpu_torch.weights import load_model_from_run

    t0 = time.perf_counter()
    say(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    card = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    say(card)
    say(run([find_nvcc(), "--version"]).splitlines()[-1])
    torch.backends.cuda.matmul.allow_tf32 = False  # the default, stated
    say(f"phase 0 environment: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    lib_path, build_s, build_log = build()
    log(build_log)
    load_library()
    ptxas, sass = ptxas_report(build_log), sass_counts(lib_path, find_nvcc())
    compiled = {}
    for name in KERNELS:
        compiled[name] = kernel_facts(ptxas, sass, f"{name}_kernel")
        say(f"  {name}: {compiled[name]}")
        if compiled[name]["HMMA"] + compiled[name]["HGMMA"] == 0:
            raise AssertionError(f"{name}: no tensor-core instruction in its machine code")
    for name in ("multi_adam_norm", "multi_adam_update", "kmeans_pass", "kmeans_update",
                 "kmeans_seed", "blstm", "blstm_rows"):
        compiled[name] = kernel_facts(ptxas, sass, f"{name}_kernel")
        say(f"  {name}: {compiled[name]}")
    say(f"phase 1 build: build_s {build_s:.2f} (wall {time.perf_counter() - t0:.2f} s)")

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    kern = phase_kernels(gen)
    say(f"phase 2 kernels: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    kmeans_record = phase_kmeans(gen)
    check_kmeans_needs_no_host_sync(gen)
    say(f"phase 2c k-means: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    blstm_record = phase_blstm(gen)
    say(f"phase 2d BLSTM kernel: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    blstm_rows_record = phase_blstm_rows(gen)
    say(f"phase 2e row-parallel BLSTM kernel: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    grads = phase_gradients(gen)
    for name, checks in grads["checks"].items():
        if any(c["launched"] != 1 for c, _ in checks):
            raise AssertionError(f"{name}: its backward launched the other kernel "
                                 f"{[c['launched'] for c, _ in checks]} times, want 1 each")
    say(f"phase 2b kernel gradients: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    model = load_model_from_run(CKPT)
    speed, launches = phase_speed(model)
    say(f"main path (c1, 64 x 8 s, batch 8) on {card}: rtf {speed['rtf_pass2']:.6f} "
        f"(pass 1 {speed['rtf_pass1']:.6f}), {speed['utterances_per_s']:.2f} utterances/s, "
        f"warm-up {speed['warmup_s']:.2f} s, launches {launches}")
    say(f"phase 3 main path speed: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    kept = {}
    quality = phase_quality(model, kept)
    say(f"quality (c1, 64 two-speaker mixtures of {QUALITY_T} samples) on {card}: "
        f"si_sdri {quality['si_sdri_db']:.3f} dB, 95% CI {quality['ci95']}")
    if not quality["si_sdri_db"] >= QUALITY_MIN_DB:
        raise AssertionError(f"SI-SDRi {quality['si_sdri_db']:.3f} dB < {QUALITY_MIN_DB} dB")
    say(f"phase 4 main path quality: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="amss_train_") as workdir:
        store = training_corpus(workdir)
        train, train_launches = phase_train(store, workdir)
        say(f"training (c1 2x300 E=20, batch {train['batch']} x {train['chunk']}, "
            f"{train['steps']} steps) on {card}: {train['ms_per_step']:.3f} ms/step median "
            f"after warm-up, {train['steps_per_s']:.2f} steps/s, peak memory "
            f"{train['peak_bytes'] / 2**30:.3f} GiB, valid loss {train['valid_loss_init']:.4f} "
            f"-> {train['valid_loss'][-1]:.4f}, B1 {train['b1_ms_per_step']:.4f} ms/step "
            f"({100 * train['b1_share']:.2f}%), launches {train_launches}")
        say(f"phase 5 training: {time.perf_counter() - t0:.2f} s")

        t0 = time.perf_counter()
        kern_c2 = phase_kernels_c2(gen)
        for name, k in kern_c2.items():
            if any(c["launched"] != 1 for c in k["grad_checks"]):
                raise AssertionError(f"{name}: its backward launched the other kernel "
                                     f"{[c['launched'] for c in k['grad_checks']]} times")
            say(f"  {name} at c2 serving ({k['shape']}): {k['ms']:.4f} ms, bound "
                f"{k['bound_ms'] * 1e3:.3f} us ({k['bound_by']}), plain {k['plain_ms']:.4f} ms, "
                f"library {k['library_ms']:.4f} ms")
        say(f"phase 6 c2 kernels: {time.perf_counter() - t0:.2f} s")

        t0 = time.perf_counter()
        model_c2 = load_model_from_run(C2_CKPT)
        speed_c2, launches_c2 = phase_speed(model_c2)
        say(f"c2 serving (64 x 8 s, batch 8) on {card}: rtf {speed_c2['rtf_pass2']:.6f} "
            f"(pass 1 {speed_c2['rtf_pass1']:.6f}), {speed_c2['utterances_per_s']:.2f} "
            f"utterances/s, warm-up {speed_c2['warmup_s']:.2f} s, launches {launches_c2}")
        quality_c2 = phase_quality(model_c2)
        say(f"c2 quality (64 two-speaker mixtures of {QUALITY_T} samples) on {card}: si_sdri "
            f"{quality_c2['si_sdri_db']:.3f} dB, 95% CI {quality_c2['ci95']}")
        if not quality_c2["si_sdri_db"] >= C2_QUALITY_MIN_DB:
            raise AssertionError(f"c2 SI-SDRi {quality_c2['si_sdri_db']:.3f} dB < "
                                 f"{C2_QUALITY_MIN_DB} dB")
        del model_c2
        say(f"phase 7 c2 serving: {time.perf_counter() - t0:.2f} s")

        t0 = time.perf_counter()
        train_c2, train_c2_launches = phase_train_c2(store, workdir)
        for key, what in (("c2_pretrain", "c2_pretrain, 16 waves"), ("c2", "c2 2x300 E=20, 8")):
            r = train_c2[key]
            say(f"training ({what} x {r['chunk']}, {r['steps']} steps) on {card}: "
                f"{r['ms_per_step']:.3f} ms/step median after warm-up, {r['steps_per_s']:.2f} "
                f"steps/s, peak memory {r['peak_bytes'] / 2**30:.3f} GiB, valid loss "
                f"{r['valid_loss_init']:.4f} -> {r['valid_loss'][-1]:.4f}, launches per step "
                f"{r['launches_per_step']}")
        say(f"phase 8 c2 training: {time.perf_counter() - t0:.2f} s")

        t0 = time.perf_counter()
        long_form, long_launches = phase_long(model)
        say(f"long-form (c1, {N_UTTS} x 8 s + {long_form['n_long']} mixtures of "
            f"{LONG_SECONDS} s, chunks of 64000) on {card}: rtf {long_form['rtf_pass2']:.6f} on "
            f"pass 2, {long_form['utterances_per_s']:.2f} utterances/s, si_sdri of the long "
            f"mixtures {long_form['si_sdri_db']:.3f} dB, 95% CI {long_form['ci95']}, launches "
            f"{long_launches}")
        if not long_form["si_sdri_db"] >= LONG_QUALITY_MIN_DB:
            raise AssertionError(f"long-form SI-SDRi {long_form['si_sdri_db']:.3f} dB < "
                                 f"{LONG_QUALITY_MIN_DB} dB")
        say(f"phase 9 long-form: {time.perf_counter() - t0:.2f} s")

        t0 = time.perf_counter()
        kern_c6 = phase_kernels_c6(gen)
        for name, checks in kern_c6["grad_checks"].items():
            if any(c["launched"] != 1 for c in checks):
                raise AssertionError(f"{name}: its backward launched the other kernel "
                                     f"{[c['launched'] for c in checks]} times")
        say(f"  gate (both kernels beat their plain versions at c6's serving shapes): "
            f"{kern_c6['gate']}")
        say(f"phase 10 c6 kernels: {time.perf_counter() - t0:.2f} s")

        t0 = time.perf_counter()
        serve_c6, serve_c6_launches = phase_serve_c6()
        sp = serve_c6["speed"]
        say(f"c6_flagship serving (64 x 8 s, batch 8) on {card}: rtf {sp['rtf_pass2']:.6f} "
            f"(pass 1 {sp['rtf_pass1']:.6f}), {sp['utterances_per_s']:.2f} utterances/s, "
            f"warm-up {sp['warmup_s']:.2f} s, launches {serve_c6_launches}")
        say(f"phase 11 c6 serving: {time.perf_counter() - t0:.2f} s")

        t0 = time.perf_counter()
        train_c6, train_c6_launches = phase_train_c6(store, workdir)
        r = train_c6["c6"]
        say(f"training (c6 TCN 3x8 expansion 2, batch {r['batch']} x {r['chunk']}, "
            f"{r['steps']} steps) on {card}: {r['ms_per_step']:.3f} ms/step median after "
            f"warm-up, {r['steps_per_s']:.2f} steps/s, peak memory "
            f"{r['peak_bytes'] / 2**30:.3f} GiB, valid loss {r['valid_loss_init']:.4f} -> "
            f"{r['valid_loss'][-1]:.4f}, launches per step {r['launches_per_step']}")
        say(f"phase 12 c6 training: {time.perf_counter() - t0:.2f} s")

        t0 = time.perf_counter()
        realtime, realtime_launches = phase_realtime()
        say(f"c7 realtime (c7_causal, chunk {REALTIME_CHUNK}) on {card}: streamed against "
            f"offline {max(realtime[k] for k in realtime if k.endswith('_err')):.3e} of the "
            f"peak at most, launches {realtime_launches}")
        say(f"phase 13 c7 realtime: {time.perf_counter() - t0:.2f} s")

        t0 = time.perf_counter()
        c7, c7_launches = phase_c7(store, workdir)
        say(f"phase 14 c7 quality and training: {time.perf_counter() - t0:.2f} s")

        t0 = time.perf_counter()
        c3, c3_launches = phase_c3(store, workdir)
        say(f"phase 15 c3 (L41): {time.perf_counter() - t0:.2f} s")

        t0 = time.perf_counter()
        c4_b2 = phase_kernel_c4(gen)
        c4, c4_launches = phase_c4(workdir)
        say(f"phase 16 c4 (Chimera): {time.perf_counter() - t0:.2f} s")

        t0 = time.perf_counter()
        count, count_launches = phase_count()
        say(f"phase 17 counting (c1_count, auto-k): {time.perf_counter() - t0:.2f} s")

        t0 = time.perf_counter()
        enh, enh_launches = phase_enh(store, workdir, quality)
        say(f"phase 18 enhancement (enh over c1_dpcl): {time.perf_counter() - t0:.2f} s")

        dual = {}
        for phase, trunk in ((19, "dprnn"), (20, "dpt")):
            t0 = time.perf_counter()
            say(f"c6 with the {trunk} trunk")
            dual[trunk], dual_launches = phase_dual_path(trunk, store, workdir)
            enh_launches.update(dual_launches)
            say(f"phase {phase} c6 {trunk}: {time.perf_counter() - t0:.2f} s")

        t0 = time.perf_counter()
        count_train, count_train_launches = phase_train_count(workdir)
        say(f"training (c1_count's config.json, batch {count_train['batch']} x "
            f"{count_train['chunk']}, {count_train['steps']} steps) on {card}: "
            f"{count_train['ms_per_step']:.3f} ms/step in fit (phase 5's c1: "
            f"{train['ms_per_step']:.3f}), launches {count_train_launches}")
        say(f"phase 21 c1_count training: {time.perf_counter() - t0:.2f} s")

        t0 = time.perf_counter()
        corrupt, corrupt_launches = phase_train_c6_corrupt(store, workdir)
        for name in ("clean", *C6_CORRUPTIONS):
            r = corrupt[name]
            say(f"training (c6 {name}, {r['steps']} steps) on {card}: "
                f"{r['ms_per_step']:.3f} ms/step in fit (phase 12's clean c6 over "
                f"{train_c6['c6']['steps']} steps: {train_c6['c6']['ms_per_step']:.3f}), "
                f"valid loss {r['valid_loss_init']:.4f} -> {r['valid_loss'][-1]:.4f}")
        say(f"phase 22 c6 with noise and reverberation: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    evaluation = phase_eval(quality, kept)
    say(f"evaluation (phase 4's {QUALITY_N} estimates) on {card}: si_sdri "
        f"{evaluation['si_sdri']:.4f} dB, sdri {evaluation['sdri']:.4f} dB (gate "
        f"{EVAL_SDRI_MIN_DB}), sir {evaluation['sir']:.4f}, sar {evaluation['sar']:.4f}, "
        f"stoi_i {evaluation['stoi_i']:.4f} (gate {EVAL_STOI_I_MIN}); the call "
        f"{evaluation['evaluate_separation_s']:.2f} s")
    say(f"phase 23 evaluation: {time.perf_counter() - t0:.2f} s")

    with tempfile.TemporaryDirectory(prefix="amss_serve_") as workdir:
        t0 = time.perf_counter()
        artifact, artifact_launches = phase_artifact_c1(model, kept, workdir)
        say(f"phase 24 c1 artifact: {time.perf_counter() - t0:.2f} s")

        t0 = time.perf_counter()
        int8 = phase_artifact_int8(model, kept, quality, workdir)
        say(f"phase 25 int8 artifact: {time.perf_counter() - t0:.2f} s")

        t0 = time.perf_counter()
        rt_artifact, rt_artifact_launches = phase_artifact_realtime(workdir)
        say(f"phase 26 realtime artifact: {time.perf_counter() - t0:.2f} s")

        t0 = time.perf_counter()
        server = phase_server(workdir)
        cli, cli_launches = phase_cli(workdir)
        say(f"phase 27 server and CLI: {time.perf_counter() - t0:.2f} s")

    with tempfile.TemporaryDirectory(prefix="amss_data_") as workdir:
        t0 = time.perf_counter()
        fill = phase_native_fill(training_corpus(workdir))
        say(f"native fill ({FILL_BATCH} x 2 x {FILL_CHUNK}) on the host of {card}: native "
            f"{fill['host_ms']['native']:.3f} ms, numpy {fill['host_ms']['numpy']:.3f} ms")
        say(f"phase 28 native batch fill: {time.perf_counter() - t0:.2f} s")

        t0 = time.perf_counter()
        big, big_facts = training_scale_corpus(workdir)
        resident = {"corpus": big_facts, **phase_device_corpus(big)}
        say(f"DeviceCorpus ({resident['nbytes'] / 1e6:.1f} MB) on {card}: upload "
            f"{resident['upload_ms']:.3f} ms, gather {resident['gather_ms']:.4f} ms")
        say(f"phase 29 DeviceCorpus at training scale: {time.perf_counter() - t0:.2f} s")

        t0 = time.perf_counter()
        flagship, flagship_launches = phase_train_flagship(big, workdir)
        say(f"training (c6_flagship's config.json with device data, batch {flagship['batch']} x "
            f"{flagship['chunk']}, {flagship['steps']} steps) on {card}: "
            f"{flagship['ms_per_step']:.3f} ms/step in fit; device against host data, ms a step "
            f"in turns: {flagship['turns_ms']}")
        say(f"phase 30 c6_flagship from its config: {time.perf_counter() - t0:.2f} s")

        t0 = time.perf_counter()
        c1_bf16, c1_bf16_launches = phase_c1_bf16(big, workdir, speed)
        say(f"c1 in bf16 on {card}: serving rtf {c1_bf16['serving']['rtf_pass2']:.6f} (float32 "
            f"{speed['rtf_pass2']:.6f}), si_sdri {c1_bf16['quality']['si_sdri_db']:.3f} dB; "
            f"training ms a step in turns {c1_bf16['turns_ms']}")
        say(f"phase 31 c1 in bf16 with device data: {time.perf_counter() - t0:.2f} s")

        t0 = time.perf_counter()
        bf16_more = phase_bf16_dual_path_and_enh(big, workdir)
        say(f"phase 32 dprnn and enh in bf16: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    sharded_stft, sharded_stft_launches = phase_sharded_stft(gen)
    say(f"phase 33 time-sharded STFT: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    long_mesh, long_mesh_launches = phase_long_sharded(model, long_form)
    say(f"phase 34 long-form over a mesh: {time.perf_counter() - t0:.2f} s")

    with tempfile.TemporaryDirectory(prefix="amss_ranks_") as workdir:
        t0 = time.perf_counter()
        ranks, ranks_launches = phase_ranks(workdir)
        say(f"phase 35 data-parallel ranks: {time.perf_counter() - t0:.2f} s")

        t0 = time.perf_counter()
        bf16_artifact, bf16_artifact_launches = phase_artifact_bf16(
            kept, workdir, artifact_launches, c1_bf16["serving"]["rtf_pass2"])
        say(f"phase 36 bf16 c1 artifact: {time.perf_counter() - t0:.2f} s")

    with tempfile.TemporaryDirectory(prefix="amss_adam_") as workdir:
        t0 = time.perf_counter()
        madam = phase_multi_adam(workdir)
        say(f"phase 37 multi-tensor clip and Adam: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    dprnn_tasnet = phase_dprnn()
    say(f"phase 38 DPRNN-TasNet: {time.perf_counter() - t0:.2f} s")

    per_path = {"c1_serve": launches, "c1_train": train_launches, "c2_serve": launches_c2,
                **train_c2_launches, "long_form": long_launches, **serve_c6_launches,
                **train_c6_launches, "c7_realtime": realtime_launches, **c7_launches,
                **c3_launches, **c4_launches, **count_launches, **enh_launches,
                **count_train_launches, **corrupt_launches, "c1_artifact": artifact_launches,
                "c7_realtime_artifact": rt_artifact_launches, "cli": cli_launches,
                **flagship_launches, **c1_bf16_launches, "sharded_stft": sharded_stft_launches,
                "long_form_mesh": long_mesh_launches, **ranks_launches,
                "c1_bf16_artifact": bf16_artifact_launches}
    record = []
    other = {"framed_matmul": "decode_ola", "decode_ola": "framed_matmul"}
    for name, (source, replaces, design) in KERNELS.items():
        k = kern[name]
        worst, grad_tol = max(grads["checks"][name], key=lambda c: c[0]["grad_rel_err"])
        k2 = kern_c2[name]
        worst2 = max(k2["grad_checks"], key=lambda c: c["grad_rel_err"])
        record.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": k["max_abs_err"], "tol": k["tol"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "bound_us": k["bound_ms"] * 1e3, "roofline_share": k["bound_ms"] / k["ms"],
            "bound_fp32_ms": k["bound_fp32_ms"], "bound_fp32_by": k["bound_fp32_by"],
            "design": design, **compiled[name],
            "train_launches": train_launches[name],
            "launches_per_path": {p: n[name] for p, n in per_path.items()},
            "backward_route": f"cuda: {other[name]} kernel + plain dbasis product",
            "backward_launches": sum(c["launched"] for c, _ in grads["checks"][name]),
            "grad_max_abs_err": worst["grad_max_abs_err"], "grad_scale": worst["grad_scale"],
            "grad_tol": grad_tol, **grads["times"][name],
            "c2": {"shape": k2["shape"], "ms": k2["ms"], "plain_ms": k2["plain_ms"],
                   "library_ms": k2["library_ms"], "bound_ms": k2["bound_ms"],
                   "bound_by": k2["bound_by"], "roofline_share": k2["bound_ms"] / k2["ms"],
                   "max_abs_err": k2["max_abs_err"], "tol": k2["tol"],
                   "grad_rel_err": worst2["grad_rel_err"], "grad_tol": GRAD_TOL},
            "c6": {**{run: {key: kern_c6["serve"][run][name][key]
                            for key in ("shape", "ms", "plain_ms", "library_ms", "bound_ms",
                                        "bound_by", "max_abs_err", "tol")}
                      for run in kern_c6["serve"]},
                   "grad_rel_err": max(c["grad_rel_err"] for c in kern_c6["grad_checks"][name]),
                   "grad_tol": GRAD_TOL, "gate": kern_c6["gate"]},
        })
        if name == "decode_ola":
            record[-1]["c4"] = {key: c4_b2[key] for key in (
                "shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err",
                "tol", "grad_rel_err", "grad_tol")}
    record.append({
        "name": "multi_adam", "route": "cuda", "source": "amss_tpu_torch/csrc/multi_adam.cu",
        "replaces": None, "design": MADAM_DESIGN,
        **{key: madam[key] for key in ("tensors", "chunks", "elements", "ms", "norm_ms",
                                      "plain_ms", "library_ms", "bound_ms", "bound_by",
                                      "roofline_share", "host_ms", "agree")},
        "launches_per_step": madam["trainer"]["launches_per_step"],
        # the exported programs' processes count B1 and B2 alone: serving, so 0
        "launches_per_path": {p: n.get("multi_adam", 0) for p, n in per_path.items()},
        "convtasnet_luo2019": {key: madam["convtasnet_luo2019"][key] for key in (
            "tensors", "chunks", "elements", "ms", "norm_ms", "plain_ms", "library_ms",
            "bound_ms", "roofline_share", "host_ms", "agree")},
        "kernels": {k: compiled[k] for k in ("multi_adam_norm", "multi_adam_update")},
    })
    record.append({
        "name": "kmeans", "route": "cuda", "source": "amss_tpu_torch/csrc/kmeans.cu",
        "replaces": None, "design": KMEANS_DESIGN, **kmeans_record,
        "launches_per_path": {p: n["kmeans"] for p, n in per_path.items() if "kmeans" in n},
        "kernels": {k: compiled[k] for k in ("kmeans_pass", "kmeans_update", "kmeans_seed")},
    })
    record.append({
        "name": "blstm", "route": "cuda", "source": "amss_tpu_torch/csrc/blstm.cu",
        "replaces": None, "design": BLSTM_DESIGN, **blstm_record,
        "launches_per_path": {p: n["blstm"] for p, n in per_path.items() if "blstm" in n},
        "kernels": {"blstm": compiled["blstm"]},
    })
    record.append({
        "name": "blstm_rows", "route": "cuda", "source": "amss_tpu_torch/csrc/blstm_rows.cu",
        "replaces": None, "design": BLSTM_ROWS_DESIGN, **blstm_rows_record,
        "launches_per_call": {"dprnn_tasnet": dprnn_tasnet["blstm_launches"][1]},
        "kernels": {"blstm_rows": compiled["blstm_rows"]},
    })
    say(json.dumps({"main_path": speed, "quality": quality, "training": train,
                    "c2_serving": speed_c2, "c2_quality": quality_c2, "c2_training": train_c2,
                    "long_form": long_form, "c6_serving": serve_c6, "c6_training": train_c6,
                    "c7_realtime": realtime, "c7": c7, "c3": c3,
                    "c4": c4, "count": count, "enh": enh, "c6_dprnn": dual["dprnn"],
                    "c6_dpt": dual["dpt"], "c1_count_training": count_train,
                    "c6_corrupt_training": corrupt, "evaluation": evaluation,
                    "c1_artifact": artifact, "int8_artifact": int8,
                    "realtime_artifact": rt_artifact, "server": server, "cli": cli,
                    "native_fill": fill, "device_corpus": resident,
                    "c6_flagship_device_training": flagship, "c1_bf16": c1_bf16,
                    "bf16_dprnn_enh": bf16_more, "sharded_stft": sharded_stft,
                    "long_form_mesh": long_mesh, "ranks": ranks, "c1_bf16_artifact": bf16_artifact,
                    "multi_adam": madam, "dprnn_tasnet": dprnn_tasnet,
                    "card": card,
                    "total_s": time.perf_counter() - t_start}))
    say(card)
    say(json.dumps({"kernels": record}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    faulthandler.cancel_dump_traceback_later()


if __name__ == "__main__":
    main()
