#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tsr_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
card, ``nvcc`` and the repository; it imports nothing of JAX.

1. Identity: the card's name and power limit, versions, and the build of
   every kernel of the slice (one ``nvcc`` per source, all in parallel).
2. Kernel checks at the slice's shapes (B=64, 224x224x3, K=15) with TF32
   off: each hand-written kernel against its plain PyTorch version on the
   same inputs, with its tolerance, then timed beside its bound, its plain
   version and (for the blur) a cuDNN grouped convolution. B2 is also held
   on a box kernel (225 equal taps) and in its random-mix epilogue mode.
   B1 and B2 (epilogue mode) are checked and timed again at the training
   mix's group shapes ``[4, s, s, 3]``, s in TRAIN_SCALES. B2+epilogue is
   held with every blur gate on (so each shape's bands run their taps) and
   with the draw's gates, and timed with the draw's.
3. The slice at full width: ResUNet (64/128/256, 512) and VGG16-D (FC 4096,
   43 classes), random weights from a seed, bf16 compute. Seeded clean
   batches go through the random mix (B1 -> B2 with the epilogue in its
   store) and the fused restore -> classify step, then one unified demo
   (its blur on B3). The
   launch counts are zeroed just before and read just after: every kernel
   must have run. The mix's time is one synchronised window over the
   steady batches. A small CUDA-vs-CPU run of the same path, the mix
   under both blur backends, checks the output against the plain versions.
   The profiled mix batch gives the device kernels per batch.
4. The unified trainer at full width, bf16 (``train.loops.
   train_unified_on_device``): the multiscale random mix on B1/B2 ->
   ResUNet in train mode -> L1 + 0.1 x perceptual loss on the frozen
   VGG16-D's ``features[:16]`` -> AdamW with its cosine schedule, over a
   seeded uint8 clean set on the card. One warm-up step, then a
   synchronised window of TRAIN_STEPS steps at batch TRAIN_BATCH (the
   ``train:`` line: images/s, losses, peak memory, B1/B2 launches, which
   must be one per scale group per train or validation batch), then
   REMAT_BATCH with the remat the trainer picks (``"vgg"``). A profiled
   train step, and one small train step on CUDA vs the CPU's plain path.
5. The file-tree pipeline at full width (``trees_phase``), in a
   temporary directory: a seeded clean tree of TREE_IMAGES .ppm files at
   GTSRB's native sizes; ``offline.generate_tree`` for each of the seven
   kinds at batch TREE_BATCH (B3 for blur and compound, B2 for blur_rand;
   launch counts zeroed just before each call and read just after); B2/B3
   held against their plain versions at every bucket shape, three shapes
   a kind timed; the blur tree made on the card and on the CPU, compared
   file by file; ``infer.restore_tree`` with device and host resize (PNG
   round trip, metrics, host time by stage, the device's busy share);
   ``eval.evaluate_directory`` with host resize, then device resize twice;
   the device resize alone per canvas, against the CPU's.
6. The specialized SimpleUNet restorers and the cascade stress test at
   full width (``cascade_phase``), on the trees phase's clean tree and its
   noise / blur / fog trees: ``data.gtsrb.PairedFolder`` at 224, one
   epoch of ``train.loops.train_restorer_on_device`` per task (MSE, Adam
   1e-3, batch 32, fp32, ``checkpoint_every=1``, provenance from the
   tree's ``.distortion`` marker), the advanced restorer (L1 + 0.1 x
   perceptual on the judge's ``features[:16]``, Adam 2e-4) for
   ADVANCED_STEPS steps, a bf16 rerun, one epoch with TF32 convolutions
   (PyTorch's default), resume through ``zoo.load_train_state``; then the
   three checkpoints through ``zoo.load_model`` and ``cascade_variant``,
   and ``pipeline.cascade_stress`` on a batch of CASCADE_BATCH and on
   CASCADE_NATIVE images distorted one by one at their native sizes and
   resized on the card (script 13's flow): the mild blur on B3 at
   run-time K=5, launch counts zeroed just before and read just after. B3
   at K=5 is then held against its plain version at the batch's shape and
   at every native shape the phase ran, and timed beside its bound, its
   plain version and cuDNN's grouped convolution; a small fp32 cascade on
   the card against the CPU.
7. The judge's trainers and the interpretability arm (``judge_phase``,
   scripts 05 -> 11 -> 12), on the trees phase's clean tree, its noise /
   blur / fog trees and the cascade phase's restorer checkpoints, with
   launch counts zeroed just before and read just after (none of its
   modules runs a TPU kernel): ``data.gtsrb.ImageFolder.load_batch`` and
   ``train_val_split(0.8)``; ``train.loops.train_judge_on_device`` on
   VGG16-D (FC 4096, 43 classes, 224) in bf16 with AdamW 3e-4, warmup and
   clipping at batch 64 (bench.py's judge shape) for JUDGE_EPOCHS epochs
   with a best checkpoint, its log lines and a synchronised window per
   epoch, then bench.py's measure (a JUDGE_WINDOW_STEPS-step window) and
   a profiled step; one epoch of the reference recipe (SGD 1e-3, momentum
   0.9, fp32) and one of a batch-norm judge in bf16 (profiled); one
   host-streamed epoch of ``train.loops.train_judge`` on
   ``data.gtsrb.batches``; resume through ``zoo.load_train_state`` and
   the best checkpoint through ``zoo.load_model``; one small judge step on
   the card against the CPU; ``infer.restore_tree`` on script 12's
   sampled files of each task, script 11's {clean, distorted, restored}
   heatmaps at ``tap_index(HIDDEN_STATE_TAP)`` on the card and the CPU;
   script 12's UMAP_SAMPLES files of 7 modes through
   ``interpret.collect_mode_embeddings``, ``project_2d("umap")`` and
   ``export_embeddings_pt``, reloaded against the fixture's schema.
   ``judge:`` and ``interpret:`` JSON lines.
8. int8 serving and the streamed trainers (``int8_phase``), with launch
   counts zeroed just before and read just after: ``quant.quantized_
   restorer`` / ``quantized_judge`` on the card against the CPU (a narrow
   pair on 4 images at 32 and the full-width pair on 2 at SIZE, within one
   bf16 ulp of each output's largest value, preds equal); phase 3's
   ResUNet and VGG16-D quantized and run in ``eval.make_fused_eval_step``
   against the bf16 step on one random-mix batch of 64 (B1/B2): logit
   correlation, top-1 agreement and the restorer's relative error against
   float32, reported and not gated (random weights); int8 and bf16 fused
   images/s at batch 64 (CUDA events over the step) and at bench.py's 512
   x 8 chunks (best of 3), peak memory, and the int8 step's device time
   by kind (``INT8_KINDS``); one epoch of the host-streamed
   ``train.loops.train_restorer`` on ``PairedFolder`` batches of the noise
   tree (fp32, ``save_best`` and ``checkpoint_every=1``) and of
   ``train_unified`` on ``data.gtsrb.batches`` of the clean tree (bf16,
   perceptual, B1/B2 launches one per scale group of each batch); then
   ``train_unified_on_device`` for UNIFIED_CKPT_EPOCHS epochs with
   ``save_path``: the checkpoint equals the best epoch's snapshot,
   ``zoo.load_model`` gives its fused-step preds, ``zoo.load_train_state``
   continues its step count. An ``int8:`` JSON line.
9. The CLI on the card (``cli_phase``), in a temporary directory: one
   subprocess ``python3 -m tsr_tpu_torch --help`` (all 19 commands
   listed), then the README's Quickstart through each script's
   ``main([...])`` in process, at full width and ``--image-size 224`` on
   the card (the scripts' default device): ``download --synthetic`` (43
   classes x 8), ``gen-noise``, ``gen-blur``, ``gen-blur
   --strength-jitter``, ``gen-fog`` (as the one subprocess ``python3 -m
   tsr_tpu_torch gen-fog``), ``gen-compound``, ``train-judge`` (1 epoch,
   AdamW, bf16), ``eval-baseline``, ``train-restorer`` (noise) and
   ``train-restorer-advanced`` (blur), ``train-unified`` (1 epoch, bf16),
   ``restore``, ``eval-restoration --fused`` and ``--int8``,
   ``restore-unified --metrics``, ``eval-unified --fused`` and ``--int8``,
   ``embeddings``; then the figure scripts (10, 11, 13, 15) where
   matplotlib is installed, else one line saying they were not run. One
   ``cli:`` line per command (wall seconds, the images/s it printed, the
   kernels' launches, zeroed just before and read just after): B3 must
   launch in ``gen-blur`` and ``gen-compound``, B2 in ``gen-blur
   --strength-jitter``, B1 and B2 in ``train-unified``. Every checkpoint
   loads through ``zoo.load_model``, every tree has the clean tree's file
   count, every report parses. Then ``eval-baseline`` and ``eval-unified
   --fused`` with the same seeded ``.pth`` weights on a 2 x 4 tree at 64
   px, on the card and with ``--device cpu`` (TF32 off): equal
   accuracies. A ``cli:`` JSON line.
10. The multi-device layer (``mesh_phase``, ``tsr_tpu_torch.parallel``)
   on this one card, so it shows the code on the card, not a scaling: B1
   on a [BATCH, SIZE, SIZE, 3] batch split at MESH_SPLIT into three calls
   with their ``row0``, bit-equal to the whole call; ``parallel.dryrun.
   dryrun_multichip(2)`` at full width (two ranks sharing the card over
   gloo on the mesh (data=1, model=2), the loss within 1e-3 of one
   process, the TP weights halved); the data-parallel unified step at the
   training cell (batch TRAIN_BATCH, bf16, the multiscale mix) on
   MESH_RANKS ranks sharing the card over gloo, a warm-up step and
   MESH_STEPS more, each loss within MESH_RTOL of the one-process steps
   from the same weights and draws, B1/B2 launches counted on each rank
   (launch counts zeroed just before and read just after, in each rank)
   and summed, images/s and peak memory per rank printed, not gated; a
   world of one over NCCL (its first loss equal to the step without a
   mesh); then, on phase 9's tree, ``train-unified --mesh data=2`` for one
   epoch against the command without (in float32 with TF32 off, both
   losses within MESH_CLI_RTOL; with ``--bf16``, the train loss within it
   and the validation loss reported beside the spread of two runs without
   a mesh, ``mesh_cli`` says why) and
   ``eval-baseline --mesh data=2`` (the same report). A ``mesh:`` JSON
   line.
11. The port's own JPEG codec (``jpeg_phase``), in the same temporary
   directory on the trees phase's clean tree: the committed fixtures
   (``tests/data/jpeg``: the port's decode equal to their ``cv2.imread``
   arrays, its encode equal to ``cv2.imwrite``'s bytes; the card's machine
   has no cv2); the clean tree written as .jpg by ``native.write_images``
   and its decoded pixels as a .png twin; host decode images/s (``probe`` +
   ``load_canvas``, and ``load_batch`` at 224) on the .jpg and .ppm trees;
   ``generate_tree`` on the .jpg tree for noise, blur, fog, compound and
   blur_rand at batch TREE_BATCH (launch counts zeroed just before and
   read just after each call: B3 in blur and compound, B2 in blur_rand),
   and for blur and compound on the twin: compound's .png files equal, the
   blur .jpg files decode equal to the port's encode of the twin's output;
   ``infer.restore_tree`` on the .jpg noise tree with its .jpg clean twin
   (metrics on, device and host resize) and ``eval.evaluate_directory`` on
   the .jpg clean and noise trees with phase 3's models, the restored files,
   metrics and per-file preds equal to those on the .png twins. A ``jpeg:``
   JSON line.
12. The JPEG data cv2 reads with a warning, or rarely
   (``jpeg_features_phase``), from the committed fixtures: scans cut short
   and corrupt (block smoothing among them), CMYK and YCCK, lossless gray
   and RGB, arithmetic coding, each decoded equal to ``expected.npz`` (what
   the reference reads: cv2.imread, or PIL for the lossless gray file),
   and the files neither reads raising with their feature named; host
   decode images/s by path (one thread) beside cv2-written baseline files;
   ``probe`` of phase 11's .jpg tree by header and as cv2 reads (the cost
   of generate_tree's skip rule);
   ``generate_tree`` on a tree of them plus the skip-class files for blur,
   compound and blur_rand (launch counts zeroed just before and read just
   after each call: B3 in blur and compound, B2 in blur_rand; the written
   count equal to the reference's, as make_fixtures.py recorded it);
   ``restore_tree`` (device and host resize, and device asked under the
   PIL resize backend, which runs the host path as the reference does)
   and ``evaluate_directory`` over the readable files with phase 3's
   models. A ``jpeg_features:`` JSON line.
13. The PNG, PNM, PAM, BMP, GIF, Sun raster, PFM, Radiance HDR, TIFF,
   WebP (lossless and lossy) and JPEG 2000 (parts 1 to 4: the colour
   boxes and HTJ2K among them) files cv2 reads and
   the port once refused, and the damaged ones cv2 gives None for
   (``image_formats_phase``), from the committed fixtures
   (``tests/data/images``, ``tests/data/webp``, ``tests/data/webp_lossy``,
   ``tests/data/jpeg2000``, ``tests/data/jpeg2000_colour``,
   ``tests/data/jpeg2000_ht``): each decoded
   equal to its ``expected.npz``
   (cv2's pixels, or PIL's for the damaged files, the gray PFM, the
   28-byte WebP, the ALPH damage PIL reads past and the JPEG 2000 files
   only PIL reads, CMYK and a palette among them) and probed as cv2 reads
   it, the rest raising (AVIF,
   JPEG 2000 of a feature the port leaves out and TIFF data named); a 640
   x 480 VP8L file built at run time (``webp_built``) decoded equal to its
   source, the committed 640 x 480 lossy WebP, 9/7 JPEG 2000 and 9/7
   HTJ2K files and
   two 640 x 480 9/7 JPEG 2000 files built at run time (``j2k_built``:
   style 63, a POC, PPT; ``j2k_colour_built``: an sYCC colr box and a
   cdef that moves channels) to cv2's digests, with their decode rates;
   host decode
   rates by
   format, GIF, Sun raster, PFM, HDR, lossless and lossy WebP and JPEG
   2000 among them; the whole-file probe of
   generate_tree's skip rule timed on phase 5's .ppm and phase 11's .png
   trees; ``generate_tree`` on the fixtures plus the skip files for blur,
   compound and blur_rand (launch counts zeroed just before and read just
   after each call; the written count the reference's) with B3/B2 held at
   its buckets; ``restore_tree`` and ``evaluate_directory`` over the
   readable files in both resize modes; then the ``tiff_scanline`` group
   (``tiff_scanline_checks``): three 16384 x 15700 single-strip TIFFs
   built at run time that cv2 reads through its scanline branch, the
   MINISWHITE and orientation-3 ones equal to cv2's digests, the
   half-deflate one refused, the decode rate and a decode-only child's
   peak RSS, and the MINISWHITE one through ``generate_tree`` (blur and
   blur_rand: one B3 and one B2 launch at ``[1, 15712, 16384, 3]``, each
   held against its plain version there), ``restore_tree`` and
   ``evaluate_directory`` in a tree of its own. An ``image_formats:``
   JSON line.
14. One JSON line of the kernels (with ``launches_trees``,
   ``tree_shapes``, ``launches_cascade``, ``cascade_shapes``,
   ``launches_judge``, ``launches_int8``, ``launches_cli``,
   ``launches_mesh``, ``launches_jpeg``, ``launches_jpeg_features``,
   ``launches_image_formats``, ``image_format_times``,
   ``launches_tiff_scanline`` and ``tiff_scanline_times``), the card's
   line, and the final ``{"ok": true, ...}`` line.

Any failed check raises, so the script exits non-zero and prints no
result line. It also exits non-zero without CUDA or outside a checkout.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import math
import os
import re
import runpy
import shutil
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SEED = 0
BATCH, SIZE, K = 64, 224, 15
N_BATCHES = 21               # batch 0 is the warm-up
NOISE_SE = 8                 # B1 noise statistics: tolerance in std errors
# the train phase: UnifiedTrainConfig's batch and multiscale mix
TRAIN_BATCH, TRAIN_SCALES = 16, (40, 56, 80, 112)
TRAIN_STEPS = 20             # the timed window, after one warm-up step
REMAT_BATCH, REMAT_STEPS = 128, 3   # auto-selected remat="vgg"
# the trees phase: a seeded clean tree at GTSRB's native sizes
TREE_CLASSES, TREE_IMAGES = 43, 1344   # 21 restore batches of 64
TREE_BATCH = 256             # generate_tree's default batch
# (share, least side, largest side) of the clean tree's native sizes: most
# 25-64 px, some 65-192, a few device-resized in the 224 bucket, a few
# host-resized (a side >= 224)
TREE_SIDES = ((0.78, 25, 64), (0.16, 65, 192), (0.03, 193, 223),
              (0.03, 224, 260))
BLUR_CPU_FILES = 96          # the blur tree made on the card and the CPU
RESIZE_CANVASES = (64, 128, 192, 224)
# the cascade phase: the specialized SimpleUNet restorers, trained on the
# trees phase's noise / blur / fog trees at RestorationTrainConfig's batch
# 32 and 0.9 split (37 steps an epoch on 1344 pairs), then the cascade
RESTORER_TASKS = ("noise", "blur", "fog")
RESTORER_EPOCHS = 1
RESTORER_BATCH = 32          # RestorationTrainConfig / AdvancedTrainConfig
ADVANCED_STEPS = 5           # the advanced (perceptual) restorer's steps
BF16_EPOCHS = 2              # the bf16 rerun: epoch 2 is timed warm
RESUME_STEPS = 2
CASCADE_BATCH = 64           # the batched cascade (EvalConfig's batch)
CASCADE_NATIVE = 10          # script 13's --num-samples, at native sizes
# the judge phase: script 05 at bench.py's judge shape (batch 64, AdamW
# 3e-4 with warmup and clipping, bf16) on the trees cell's clean tree, then
# scripts 11 and 12
JUDGE_BATCH, JUDGE_LR = 64, 3e-4
JUDGE_EPOCHS = 3             # in place of script 05's 10
JUDGE_WINDOW_STEPS = 10      # bench.py's train-step window
UMAP_SAMPLES = 100           # script 12's --samples-per-mode
# the int8 phase: bench.py's int8 numbers (the fused step at batch 64,
# then 512 x 8 chunks, best of 3) and the unified trainer's checkpoints
INT8_BATCH = 64
INT8_STEP_ITERS = 5          # CUDA-event window of the batch-64 step
# the bench-shape passes: best of 2 after a warm-up (they spread < 0.2 %)
INT8_BENCH_BATCH, INT8_BENCH_CHUNKS, INT8_BENCH_REPS = 512, 8, 2
UNIFIED_CKPT_EPOCHS = 2
# the CLI phase: the Quickstart on the README's synthetic tree (43 classes x
# 8 images at GTSRB-like native sizes), one epoch each, at full width and
# 224; then card vs CPU on a 2 x 4 tree at 64 px
CLI_CLASSES, CLI_PER_CLASS = 43, 8
CLI_EMBED_SAMPLES = 20       # embeddings --samples-per-mode
CLI_PARITY_SIZE = 64
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, published peak
# phase 10: multi-device (parallel/), ranks sharing this one card over gloo
MESH_SPLIT = (16, 40)        # B1's [BATCH, SIZE, SIZE, 3] cut into 3 calls
MESH_RANKS = 2               # the data-parallel step and the CLI's --mesh
MESH_STEPS = 5               # after one warm-up step, at TRAIN_BATCH
MESH_RTOL = 1e-3             # per-step loss against one process
MESH_CLI_RTOL = 2e-3         # the reference's bound for the mesh loop
MESH_CLI_PER_CLASS = 2       # images a class of phase 9's tree the
                             # commands' --mesh runs take (its first ones)
MESH_CLI_DISTORTED = ("data/processed/Noise", "data/processed/Blur",
                      "data/processed/Fog")  # phase 9's trees eval-baseline
                                             # reads beside the clean one
# phase 11: the port's JPEG codec on the trees phase's clean tree
JPEG_KINDS = ("noise", "blur", "fog", "compound", "blur_rand")
JPEG_TWIN_KINDS = ("blur", "compound")   # also made from the PNG twin
JPEG_DECODE_REPS = 3         # host decode rates: best of 3 passes
JPEG_FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / "jpeg"
# phase 12: the JPEG data cv2 reads with a warning, or rarely, from the
# committed fixtures (tests/data/jpeg/make_fixtures.py's FEATURE_CASES and
# SKIP_CASES), by decode path; "baseline" is cv2-written baseline files
JPEG_FEATURE_GROUPS = {
    "baseline": ("s444_q95", "s422_q75_w7", "s420_default", "s440_q10",
                 "s411_q75", "optimized_q95", "restart2_s422"),
    "cut": ("cut_baseline", "cut_progressive_dc", "cut_progressive_scan3",
            "cut_progressive_rst", "no_eoi_progressive"),
    "corrupt": ("corrupt_huffman", "corrupt_bytes", "rst_replaced"),
    "cmyk_ycck": ("cmyk", "ycck"),
    "lossless": ("lossless_gray", "lossless_rgb"),
    "arithmetic": ("arith_sequential", "arith_progressive",
                   "arith_relabelled"),
}
# skip/<name>.jpg -> the feature its RuntimeError names
JPEG_SKIP_FIXTURES = {
    "precision12": "sample precision", "hierarchical": "hierarchical",
    "two_components": "component count", "cut_in_header": "failed to decode",
    "lossless_ycc": "lossless JPEG in YCbCr",
    "lossless_arith": "lossless arithmetic"}
JPEG_FEATURE_KINDS = ("blur", "compound", "blur_rand")
JPEG_FEATURE_DECODES = 1024  # decodes a timed pass of each group, 1 thread
# phase 12's C11 files, built here with the port's JPEG writer (cv2.imwrite's
# bytes) from a seeded C11_SIZE image: at each site c11_sites picks, the
# byte before an FF 00 of the entropy data is set to FF, so the data reads
# FF FF 00 (libjpeg-turbo's fast Huffman pass takes that for a marker, its
# slow pass for an FF data byte; which one runs depends on what the stdio
# source's 4096-byte buffer holds). C11_DIGESTS: SHA-256 of cv2.imread's
# RGB pixels of each, by site (tests/test_torch_port_jpeg_fast.py checks
# them against cv2).
C11_SIZE = (200, 280)
C11_SEED = 11
C11_DIGESTS = {
    688: "00509936f9374ec8ba86a397763413f2a43b8a317c24dbc0f2337939db3b60ef",
    3429: "9e7e3cae300cafc9c3b7853adba05ff7d403550528a8c1581e7302d6d7680baa",
    4369: "5ee2be31a354e842c82c2d8b28abfaacd5bfd2b2c7238e45fd9776550abf198f",
    7602: "010d5a05547d375ee69285e550aa93bc58bd73d2f600dcc79594c1803448c662",
    7971: "59a2093b550bdb87067256b13c1fdfc838d0b875e8f890744a9f6803ee1f0d45",
    8951: "88a6092f229d27c4b21808ab5560cefc9df39212efcc204c677c300061881b3b",
    11531: "cba0be39f8212d80485b8eae5614e0639b497a824b1dadd3df3c4e1d4666bb57",
    12985: "475a3f63ded28ca774d0635be7d66839bdefdd80917bbd53e07b3c65aa4c6c94",
    14257: "4afde3b80634776f38846b56a4fd228ab4ab05d807cd2f31801844ca59c60663",
    16376: "d1b0b027e0244b71f95d40860730a48df764e6bd21f776d8205d0252af1eb958",
    16384: "f21f1762674c181930434a7dacddf90c8c35847e3fd28a9108aec1afe0df1f2c",
    16717: "e9118e9b9a5adb83d67b8c5113669475de3847871e71ad4a918627fdc00885fe",
    19241: "9c80b0a8e0ab195e9fc9b77a55f2dc801479d29e5ad238eb42c6aa7dab279f6e",
    19602: "d5c821773ab4b96afcba46a79b1c03be2d3ab765a42fa8838cca04f2f7c4a86a",
    20612: "2b8352a27f4230caf809b4d17a8900464a83a9b9ee62dbab54a54dcc6387a426",
    23967: "fef8dba92b9733861faa84ebe43ae7d34e30dc863597dc442dc7c05caf0ea550",
    25009: "7c58594df95bd9f72b8fcdcef77d79410b24fa0bc3ee5ef498da242b8345555f",
    26456: "125d877ebcc455c9087a9a12615f6ee7525f19b3ec86bb1438b0bd9f294dbb7f",
    28289: "9cc8e8ee7dad5910db6f8277ac7e6d6cce7fc0f5052602a1c95cb0e2df11c73e",
    29062: "0c5f7443d8aee38fdd709f93f830c8b2ca726d0ab9162544034941ab37635d0d",
    31538: "0b1b81328e02f4c8b5d7dc97aa28885463d5da7478cd02d1f86ebd5e740ec2eb",
    32763: "ca077b7ba95d5682202ae28290418000cbb2a4c1e1fc3e60d4ae38819976e969",
    33037: "b9fdd30576a33194462b187c96224b1511de76e95d4be2d7ed780cf755731c3b",
    33261: "4a83b836d401dae668b137c5ef03c1f951e3e41f945809ed086dba02eb190ba9",
    36684: "051af30ac3e2a9de83579b68bc11a0392142832976a8ad6bf25e5eeaaae045b9",
    37523: "eeff3dbe65f1d23e7f60dd53d58add3b31a0ee1273105eb2c07cf375f206371a",
    38404: "edec3c4e6be3d7358bb679d19ad385e51178d350ab42a09555fb56af2f28c60c"}
# phase 13: the PNG, PNM, PAM, BMP, GIF, Sun raster, PFM, Radiance HDR and
# TIFF files of tests/data/images (make_fixtures.py): the variants cv2 reads
# at the top, the files it gives None for (and AVIF data, JPEG 2000 files
# of the feature the port leaves out, sub-sampled components in a JP2 file
# and in a raw codestream, and a ZSTD TIFF, which the port does not
# decode) under skip/
IMAGE_FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / "images"
IMAGE_SUFFIXES = (".ppm", ".png", ".jpg", ".jpeg", ".bmp")
IMAGE_FOREIGN = {"avif.png": "AVIF", "jp2.jpg": "JPEG 2000",
                 "tiff_zstd.png": "TIFF", "j2k.png": "JPEG 2000"}
# decode groups by file-name prefix; "tiff" is TIFF part 1 (8-bit strips),
# the files of no tiff_* group below it; "tiff_thunder_sgilog" and
# "tiff_modes" hold files built at run time (TIFF_2C_FILES,
# TIFF_MODES_FILES)
IMAGE_GROUPS = {"pnm_ascii": ("p1_", "p2_", "p3_"), "pnm_binary": ("p4_",
                "p5_", "p6_"), "pam": ("pam_",), "bmp_rle": ("bmp_rle",),
                "bmp_bitfields_core": ("bmp16", "bmp32", "bmp_core"),
                "png": ("png_",), "gif": ("gif_",), "sun_raster": ("sun_",),
                "pfm": ("pfm",), "hdr": ("hdr_",), "tiff": ("tiff",),
                "tiff_16bit": ("tiff16", "tiff_cv2_rgb16", "tiff_miniswhite_16",
                               "tiff_extra_1_16", "tiff_extra_2_16"),
                "tiff_1_4bit": ("tiff_1bit", "tiff_4bit", "tiff_pil_1bit"),
                "tiff_alpha_extra": ("tiff_pil_la", "tiff_pil_rgba",
                                     "tiff_cv2_rgba", "tiff_extra_0",
                                     "tiff_gray_two"),
                "tiff_planar_fillorder": ("tiff_planar2", "tiff_fillorder2",
                                          "tiff_miniswhite_sample"),
                "tiff_tiles": ("tiff_tile", "tiff_orientation_6_sq"),
                "tiff_bigtiff": ("tiff_bigtiff",),
                "tiff_color_jpeg": ("tiff_cmyk", "tiff_ycbcr", "tiff_jpeg",
                                    "tiff_unknown", "tiff_cielab"),
                "tiff_ccitt": ("tiff_group4", "tiff_ccitt"),
                "tiff_thunder_sgilog": ("tiff_2c_",),
                "tiff_modes": ("tiff_modes_",), "webp": ("webp_",),
                "webp_lossy": ("webp_lossy_",), "jpeg2000": ("j2k_",),
                "jpeg2000_part2": ("j2k2_",), "jpeg2000_colour": ("j2k3_",),
                "jpeg2000_ht": ("j2k4_",), "jpeg2000_mct": ("j2k5_",)}
# phase 13's TIFF files built at run time (no cv2 or PIL there): a BigTIFF
# of deflate strips, a big-endian tiled file and a JPEG-compressed YCbCr
# file (4:2:0 streams), each of this RGB size and rows a strip, decoded
# this many times a timed pass
BUILT_TIFF_SIZE = (480, 640)
BUILT_TIFF_ROWS = 16
BUILT_TIFF_DECODES = 20
# and ThunderScan and SGILog files (TIFF part 2c), built by thunder_code
# and sgilog_code from TIFF_2C_SEED: {name: (kind, h, w, rows a strip)},
# the tiff_2c_ ones small enough to keep phase 13's tree in its buckets,
# the rate_2c_ ones the size of the decode rates' files; TIFF_2C_DIGESTS:
# SHA-256 of cv2.imread's RGB pixels of each (tests/test_torch_port_tiff_2c
# .py checks them against cv2)
TIFF_2C_FILES = {
    "tiff_2c_thunder_palette.png": ("thunder", 12, 15, 5),
    "tiff_2c_logl.png": ("logl", 10, 14, 4),
    "tiff_2c_luv32.png": ("luv32", 16, 11, 6),
    "tiff_2c_luv24.png": ("luv24", 9, 13, 9),
    "rate_2c_thunder.png": ("thunder", *BUILT_TIFF_SIZE, BUILT_TIFF_ROWS),
    "rate_2c_luv32.png": ("luv32", *BUILT_TIFF_SIZE, BUILT_TIFF_ROWS)}
TIFF_2C_SEED = 19
TIFF_2C_DIGESTS = {
    "tiff_2c_thunder_palette.png":
        "8c983ca3a93bb0d1271a6d597516950dc8e0cc556b0089400aff86b678b09b3e",
    "tiff_2c_logl.png":
        "35a9eb504e063c5afbad4693c83fbe927a0e8b1ff0ff68e1ebf15196bb268326",
    "tiff_2c_luv32.png":
        "24c9eba89cf21572532c9af343989b58022c86e9fd530fe68a58590807db2f80",
    "tiff_2c_luv24.png":
        "97c44282fa9eb673a0b914b21aee007415dedf094820aca327ccbee1f357d757",
    "rate_2c_thunder.png":
        "dddb3e032ad137c6821896b9c1817192185023a35a39447d2d9f582a95036e71",
    "rate_2c_luv32.png":
        "a9c20fc99ca7cacbe73a76de3929ee95809231e62e1ec9f3d2245502fafb10e3"}
# and TIFF part 2c-iii, which only PIL reads (cv2 refuses each): Pillow's
# I;16S (at orientation 6), big-endian I;32S, F (NaN, infinities,
# negatives and values past 255 among its samples), I;12, F deflate with
# the floating-point predictor, and old-style JPEG (6) with the whole
# stream at JPEGInterchangeFormat or its tables in tags, the streams the
# port's own JPEG writer makes (cv2.imwrite's bytes), built by
# tiff_mode_bytes from TIFF_MODES_SEED: {name: (kind, h, w)}, the
# tiff_modes_ ones for the tree, the rate_modes_ ones the size of the
# decode rates' files; TIFF_MODES_DIGESTS: SHA-256 of PIL's convert("RGB")
# pixels of each (tests/test_torch_port_tiff_modes.py checks them against
# PIL)
TIFF_MODES_FILES = {
    "tiff_modes_i16s.png": ("i16s", 12, 14),
    "tiff_modes_i32s_be.png": ("i32s_be", 11, 13),
    "tiff_modes_f.png": ("f", 10, 15),
    "tiff_modes_i12.png": ("i12", 9, 11),
    "tiff_modes_f_pred3.png": ("f_pred3", 13, 12),
    "tiff_modes_ojpeg_stream.png": ("ojpeg_stream", 16, 16),
    "tiff_modes_ojpeg_tables.png": ("ojpeg_tables", 14, 24),
    "rate_modes_f_pred3.png": ("f_pred3", *BUILT_TIFF_SIZE),
    "rate_modes_ojpeg.png": ("ojpeg_stream", *BUILT_TIFF_SIZE)}
TIFF_MODES_SEED = 20
TIFF_MODES_DIGESTS = {
    "tiff_modes_i16s.png":
        "78e878be84791273f3c6ace79fcbbca1f9fc4adcd7b5ef7faeb677353be149d5",
    "tiff_modes_i32s_be.png":
        "42dcdec4bfd86713f3b9a4b8fa6e2b8bc12fe11c52f1acad481732cdfbeb008c",
    "tiff_modes_f.png":
        "d3d9b58d6e2647d0592e040c2fd0b25f59bbb4a4fa9ed901a86a587073f5f30d",
    "tiff_modes_i12.png":
        "e74fb4def2f1847590eedbfa2706f048f4bf32d8618e65fc1b3e018af1e97da2",
    "tiff_modes_f_pred3.png":
        "c4e74645b8f23964c0b425f7575d1fe3e2cf3d33ef6f8c9744dc54b00e21813e",
    "tiff_modes_ojpeg_stream.png":
        "f729670d87473f05caab1db29cd31a5fd9098005b828eeb8b1a548ba51896822",
    "tiff_modes_ojpeg_tables.png":
        "e16dc376e7aff92bc67d0bf9b95f54c935adb93ce510fbbfe4fa4045df3b55b6",
    "rate_modes_f_pred3.png":
        "7a5a6e4916d9066261f1d340d87d06b69d6f2daa1081022824d0054f8b3ad556",
    "rate_modes_ojpeg.png":
        "e8b6c8ed757629e9255d0e12f44d98ffd34619a683d230ac2d1c59ad6d3734c4"}
# and single-strip TIFFs whose RGBA buffer (4 bytes a pixel) reaches 95 %
# of 1 GiB, which cv2 reads through its scanline branch (TIFF part 2d),
# built by scanline_tiff at this (h, w), 4 h w = 1.03e9 bytes: {name:
# (photometric, orientation, the deflate stream cut at half)}; the cut one
# cv2 gives None for, TIFF_SCANLINE_DIGESTS the SHA-256 of cv2.imread's RGB
# pixels of the others (tests/test_torch_port_tiff_scanline.py checks
# them against cv2), decoded this many times a timed pass
TIFF_SCANLINE_SIZE = (15700, 16384)
TIFF_SCANLINE_FILES = {
    "tiff_scanline_miniswhite.jpg": (0, 1, False),
    "tiff_scanline_orientation3.jpg": (1, 3, False),
    "tiff_scanline_half_deflate.jpg": (1, 1, True)}
TIFF_SCANLINE_DIGESTS = {  # both as stored, so one digest
    "tiff_scanline_miniswhite.jpg":
        "3401b9557ae8ecdbb91d1ed486ddf5ae5948e46e8c2fe5686910e751efcbf36b",
    "tiff_scanline_orientation3.jpg":
        "3401b9557ae8ecdbb91d1ed486ddf5ae5948e46e8c2fe5686910e751efcbf36b"}
TIFF_SCANLINE_DECODES = 3
# and a fax page (T.4's 1728 pixels a row, fine mode's 2292 rows, one
# strip, MINISWHITE) as group 4 and as group 3 2-D (K = 4), written by
# fax_code's T.6 and T.4 coder
FAX_PAGE = (2292, 1728)
FAX_K = 4
# and WebP (tests/data/webp, make_fixtures.py): lossless files cv2 reads
# at the top (decoded__ in its expected.npz), those it gives None for under
# skip/, a 28-byte one PIL reads among them; and a VP8L file built at run
# time by vp8l_bytes (webp_built) of this RGB size from its seed, decoded
# this many times a timed pass
WEBP_FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / "webp"
WEBP_BUILT_SIZE = (480, 640)
WEBP_BUILT_SEED = 22
WEBP_BUILT_DECODES = 20
# phase 13's lossy WebP (VP8): the fixtures of tests/data/webp_lossy
# (make_fixtures.py) as for WEBP_FIXTURES, among them a 640 x 480
# quality-75 file of cv2's writer, checked by the SHA-256 of cv2.imread's
# RGB and decoded WEBP_BUILT_DECODES times a timed pass
WEBP_LOSSY_FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / (
    "webp_lossy")
WEBP_LOSSY_BIG = "webp_lossy_640x480_q75.jpg"
WEBP_LOSSY_BIG_SIZE = (480, 640)
WEBP_LOSSY_BIG_DIGEST = (
    "7167baf6b5cbb9eec9960d98d5dfeadc6be2ae84e36993acf7dfa4e4439be92f")
# phase 13's JPEG 2000: the fixtures of tests/data/jpeg2000
# (make_fixtures.py) as for WEBP_FIXTURES, among them a 640 x 480 lossy
# 9/7 file of Pillow's writer, checked by the SHA-256 of cv2.imread's RGB
# and decoded WEBP_BUILT_DECODES times a timed pass
JPEG2000_FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / (
    "jpeg2000")
JPEG2000_BIG = "j2k_640x480_97.jpg"
JPEG2000_BIG_SIZE = (480, 640)
JPEG2000_BIG_DIGEST = (
    "a750f3dcfdbef03e534f95a7d41d2baca8af1342541697a4cbe3b7bcb680131d")
# phase 13's JPEG 2000 part 2: the j2k2_ fixtures of JPEG2000_FIXTURES
# (code-block styles, POC, PPM and PPT, RGN; group and slice
# "jpeg2000_part2"), and a file built at run time by j2k_bytes from
# JPEG2000_BIG's source (j2k_source: the gradient and grain of
# tests/data/jpeg2000_cases.py's build_big, from JPEG2000_SOURCE_SEED):
# 9/7, code-block style 63 (BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM)
# over three layers, a POC of three entries, every packet header in PPT
# markers; held to JPEG2000_BUILT_DIGEST (SHA-256 of cv2.imread's RGB,
# which tests/test_torch_port_jpeg2000_part2.py checks) and decoded
# WEBP_BUILT_DECODES times a timed pass
JPEG2000_SOURCE_SEED = 25
JPEG2000_BUILT = "j2k_built_style63_poc_ppt.jpg"
JPEG2000_BUILT_DIGEST = (
    "f21990e576e86caac1259a9243d17f7583c3421974e2a0e6afb31fd7f423e7f5")
# phase 13's JPEG 2000 part 3 (the colour boxes): the j2k3_ fixtures of
# tests/data/jpeg2000_colour (group and slice "jpeg2000_colour"; 3 of its
# skip/ files PIL reads), and a file built at run time by j2k_colour_built
# from j2k_source (9/7, an sYCC colr box, a cdef that moves channels), held
# to JPEG2000_COLOUR_DIGEST (SHA-256 of cv2.imread's RGB, which
# tests/test_torch_port_jpeg2000_colour.py checks) and decoded
# WEBP_BUILT_DECODES times a timed pass
JPEG2000_COLOUR_FIXTURES = Path(__file__).resolve().parent / "tests" / (
    "data") / "jpeg2000_colour"
JPEG2000_COLOUR_PIL_READS = 3
JPEG2000_COLOUR_BUILT = "j2k3_built_sycc_cdef.jpg"
JPEG2000_COLOUR_DIGEST = (
    "55aa62e5e57f89b3f127d076b409f93970e646c03055d0ec826dcbc023d3d8a2")
# phase 13's JPEG 2000 part 4 (HTJ2K): the j2k4_ fixtures of
# tests/data/jpeg2000_ht (group and slice "jpeg2000_ht"; 3 of its skip/
# files PIL reads), among them JPEG2000_HT_BIG, j2k_source in a JP2 file of
# 64 x 64 HT code-blocks (the 9/7, the ICT; tests/data/jpeg2000_cases.py's
# ht_big), held to JPEG2000_HT_DIGEST (SHA-256 of cv2.imread's RGB, which
# tests/test_torch_port_jpeg2000_ht.py checks) and decoded
# WEBP_BUILT_DECODES times a timed pass beside JPEG2000_BIG in one call
JPEG2000_HT_FIXTURES = Path(__file__).resolve().parent / "tests" / (
    "data") / "jpeg2000_ht"
JPEG2000_HT_BIG = "j2k4_640x480_97.jpg"
JPEG2000_HT_PIL_READS = 3
JPEG2000_HT_DIGEST = (
    "f21990e576e86caac1259a9243d17f7583c3421974e2a0e6afb31fd7f423e7f5")
# phase 13's JPEG 2000 part 5 (Part 2's CBD, MCT, MCC and MCO markers): the
# j2k5_ fixtures of tests/data/jpeg2000_mct (group and slice
# "jpeg2000_mct"; 3 of its skip/ files PIL reads), a 100 x 14 file among
# them in generate_tree buckets no other fixture brings
JPEG2000_MCT_FIXTURES = Path(__file__).resolve().parent / "tests" / (
    "data") / "jpeg2000_mct"
JPEG2000_MCT_PIL_READS = 3
# the slices of C7 by file-name prefix, counted apart in phase 13's line
IMAGE_SLICES = {"gif_sun": ("gif_", "sun_"), "pfm_hdr": ("pfm", "hdr_"),
                "tiff": ("tiff",), "webp": ("webp_",),
                "webp_lossy": ("webp_lossy_",), "jpeg2000": ("j2k_",),
                "jpeg2000_part2": ("j2k2_",), "jpeg2000_colour": ("j2k3_",),
                "jpeg2000_ht": ("j2k4_",), "jpeg2000_mct": ("j2k5_",)}
# C9 and C10 in phase 13: a PNG past the old 64 Mpx cap, and headers whose
# size makes cv2.imread raise (built at run time from zlib and struct)
BIG_PNG_SIDE = 8200
RAISING_HEADERS = {"png_40000x30000.png": (40000, 30000),
                   "tiff_2000000x1.png": (2000000, 1)}
IMAGE_KINDS = ("blur", "compound", "blur_rand")
FP32_FLOPS = 67e12           # H100 SXM non-tensor fp32, published peak
INT8_OPS_PER_S = 1979e12     # H100 SXM dense int8 tensor cores, published


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over back-to-back calls (CUDA events).

    A spin kernel queued first keeps the device busy while the host queues
    all ``iters`` calls, so the events time the device work alone and not
    the host's launch rate (a call's Python overhead can exceed its kernel).
    """
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # ~25 ms at the H100's boost clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_breakdown(fn, top=14):
    """Device time and launches by kernel name over one call of ``fn``
    (torch.profiler), the number of device kernels that call ran, and its
    wall time measured inside the profiled window; returns (the ``top``
    rows of (name, ms, launches), busy_ms, n_kernels, wall_ms, every row),
    or None if the profiler cannot start or be read. A failure of ``fn``
    itself always propagates."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    try:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    except Exception as e:
        print(f"profiler unavailable: {type(e).__name__}: {e}")
        return None
    try:
        fn()  # warm: the profiler's own start-up stays out of the window
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    except BaseException:
        with contextlib.suppress(Exception):
            prof.stop()
        raise
    try:
        prof.stop()
        # a user annotation on the device's timeline (optimizer.step's
        # range) spans kernels already counted: it is not a kernel
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
    except Exception as e:
        print(f"profiler unreadable: {type(e).__name__}: {e}")
        return None
    by_name = {}
    # both calls launch the same kernels: keep the second call's half
    events.sort(key=lambda e: e.time_range.start)
    events = events[len(events) // 2:]
    for e in events:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3,
                           n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    rows = sorted(((name, ms, n) for name, (ms, n) in by_name.items()),
                  key=lambda r: -r[1])
    return rows[:top], busy, len(events), wall_ms, rows


# kernel-name fragments of each kind of device work, first match wins: an
# approximate split by name, with what matches none filed as "other"
KINDS = (("hand-written mix kernels (B1, B2)", ("fog_noise_kernel",
                                                "blur_runs", "build_runs")),
         ("convolution and GEMM", ("xmma", "gemm", "convolve", "dgrad",
                                   "wgrad", "cutlass", "sm90_", "fft",
                                   "_complex", "DSE::")),
         ("batch norm and its statistics", ("batchnorm", "batch_norm",
                                            "bn_", "Welford")),
         ("optimizer (multi-tensor)", ("multi_tensor", "Adam")),
         ("reductions", ("reduce_kernel",)),
         ("casts and copies", ("copy", "cat_", "Memcpy", "nchwToNhwc",
                               "nhwcToNchw")),
         ("other elementwise", ("elementwise", "max_pool", "where")))


def kinds_line(rows, busy):
    """Device time by kind of work (KINDS, approximate), as ms and share of
    ``busy``; "other" is always listed."""
    sums = {"other": 0.0}
    for name, ms, _ in rows:
        kind = next((k for k, frags in KINDS
                     if any(f in name for f in frags)), "other")
        sums[kind] = sums.get(kind, 0.0) + ms
    return "; ".join(f"{k} {ms:.3f} ms ({100 * ms / busy:.1f} %)"
                     for k, ms in sorted(sums.items(), key=lambda r: -r[1]))


def check_b1(clean, draws):
    """B1 on ``clean`` with the mix's fog gates, held against its plain
    version: the deterministic half (sigma = 0) exactly, the noise by its
    statistics. Returns ``(f max err, noisy f, noisy pre_blur)``."""
    import torch
    from tsr_tpu_torch.kernels import distort as kdistort
    b = clean.shape[0]
    dev = clean.device
    gate_fog = draws.gate_fog.to(torch.int32)
    ones = torch.ones(b, dtype=torch.int32, device=dev)
    zeros = torch.zeros(b, device=dev)
    # B1 deterministic half: sigma = 0, fog gates from the mix, noise on
    f, pre = kdistort.fused_fog_noise(clean, draws.seed, gate_fog, draws.t,
                                      ones, zeros)
    f_ref, pre_ref = kdistort.fog_noise_plain(
        clean, gate_fog, draws.t, ones, zeros,
        noise=torch.zeros(clean.shape, device=dev))
    torch.cuda.synchronize()
    b1_err = (f - f_ref).abs().max().item()
    pre_mismatch = int((pre != pre_ref).sum())
    check(b1_err <= 1e-6, f"B1 f max err {b1_err} > 1e-6")
    check(pre_mismatch == 0, f"B1 pre_blur differs at {pre_mismatch} values")
    # B1 noise: per sample, z = (f - fogged) / sigma must be N(0,1). Its
    # mean, std and kurtosis (3 for a normal) must each lie within
    # NOISE_SE standard errors for the sample's n values: sqrt(1/n),
    # sqrt(1/(2n)) and sqrt(24/n). At 224x224x3 that is 0.021 on the mean
    # of z (3.5e-3 on a mean of f - fogged at sigma 0.17) and 0.10 on the
    # kurtosis.
    f_n, pre_n = kdistort.fused_fog_noise(clean, draws.seed, gate_fog,
                                          draws.t, ones, draws.sigma)
    z = (f_n - f).reshape(b, -1) / draws.sigma.reshape(-1, 1)
    n_px = z.shape[1]
    zc = z - z.mean(1, keepdim=True)
    kurtosis = (zc ** 4).mean(1) / (zc ** 2).mean(1) ** 2
    stats = {
        "mean": (z.mean(1).abs().max().item(), math.sqrt(1 / n_px)),
        "std": ((z.std(1) - 1).abs().max().item(), math.sqrt(0.5 / n_px)),
        "kurtosis": ((kurtosis - 3).abs().max().item(),
                     math.sqrt(24 / n_px))}
    for stat, (err, se) in stats.items():
        check(err < NOISE_SE * se,
              f"B1 noise {stat} off by {err} ({err / se:.1f} standard errors)")
    print(f"B1 fog_noise {list(clean.shape)}: f max err {b1_err:.3g} (tol "
          f"1e-6), pre_blur mismatches {pre_mismatch}; noise z = (f - "
          f"fogged)/sigma, worst sample: " + ", ".join(
              f"{stat} off by {err:.4g} ({err / se:.2f} SE)"
              for stat, (err, se) in stats.items())
          + f" (tol {NOISE_SE} SE)")
    return b1_err, f_n, pre_n


def b1_times(clean, draws):
    """B1's time, its plain version's and its bound on ``clean``."""
    import torch
    from tsr_tpu_torch.kernels import distort as kdistort
    b = clean.shape[0]
    dev = clean.device
    gate_fog = draws.gate_fog.to(torch.int32)
    ones = torch.ones(b, dtype=torch.int32, device=dev)
    n = clean.numel()
    args = (clean, draws.seed, gate_fog, draws.t, ones, draws.sigma)
    ms = cuda_ms(lambda: kdistort.fused_fog_noise(*args))
    g_plain = torch.Generator(device=dev).manual_seed(SEED)
    plain = cuda_ms(lambda: kdistort.fog_noise_plain(
        clean, gate_fog, draws.t, ones, draws.sigma, generator=g_plain))
    t_b, by = bound(n * 1 + 2 * n * 4 + b * 16 + 8, 10 * n)
    return dict(ms=ms, plain_ms=plain, bound_ms=t_b, bound_by=by)


def b2_epilogue_lsb(x, kerns, f_n, gate):
    """B2 with the random mix's epilogue in its store, on B1's outputs,
    held within 1 LSB of its plain version; returns (max LSB, values that
    differ)."""
    import torch
    from tsr_tpu_torch.kernels import blur as kblur
    got = kblur.filter2d_sparse(x, kerns, f=f_n, gate_blur=gate)
    ref = kblur.random_mix_epilogue_plain(kblur.filter2d_plain(x, kerns),
                                          f_n, gate)
    torch.cuda.synchronize()
    diff = (got.int() - ref.int()).abs()
    lsb, n_diff = int(diff.max()), int((diff != 0).sum())
    check(lsb <= 1, f"B2+epilogue {list(x.shape)} ({int(gate.sum())} of "
          f"{len(gate)} gates on) differs by {lsb} LSB")
    return lsb, n_diff


def check_b2_epilogue(x, kerns, f_n, gate):
    """B2+epilogue held by :func:`b2_epilogue_lsb` with every blur gate on
    (each sample runs its taps) and with ``gate``, then timed with
    ``gate`` beside its bound."""
    import torch
    from tsr_tpu_torch.kernels import blur as kblur
    lsb_on, n_on_diff = b2_epilogue_lsb(x, kerns, f_n, torch.ones_like(gate))
    lsb, n_diff = b2_epilogue_lsb(x, kerns, f_n, gate)
    ms = cuda_ms(lambda: kblur.filter2d_sparse(x, kerns, f=f_n,
                                               gate_blur=gate))
    plain = cuda_ms(lambda: kblur.random_mix_epilogue_plain(
        kblur.filter2d_plain(x, kerns), f_n, gate))
    b, h, w, c = x.shape
    pix = x.numel()
    k = kerns.shape[-1]
    n_on = int(gate.sum())
    # gate on: the blur input is read; gate off: f is read; uint8 written
    t_b, by = bound(pix * 4 + pix + b * k * k * 4,
                    2 * int((kerns[gate] != 0).sum()) * h * w * c)
    print(f"B2+epilogue {list(x.shape)}: every gate on, max {lsb_on} LSB "
          f"(tol 1), {n_on_diff} of {pix} values differ; the draw's gates "
          f"({n_on} of {b} on), max {lsb} LSB, {n_diff} differ; {ms:.4f} ms, "
          f"bound {t_b:.4f} ms ({by}), plain {plain:.4f} ms")
    return dict(name="B2+epilogue blur_sparse", max_lsb=max(lsb, lsb_on),
                n_differ=n_diff, n_differ_all_gates_on=n_on_diff,
                ms=ms, plain_ms=plain, bound_ms=t_b, bound_by=by,
                gates_on=n_on)


def kernel_checks(dev):
    """Phase 2: each kernel against its plain version, then timed."""
    import torch
    import torch.nn.functional as F
    from tsr_tpu_torch import configs
    from tsr_tpu_torch.kernels import blur as kblur
    from tsr_tpu_torch.ops import blur as tblur
    from tsr_tpu_torch.ops import distortions
    g = torch.Generator(device=dev).manual_seed(SEED)
    clean = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), dtype=torch.uint8,
                          device=dev, generator=g)
    draws = distortions.draw_random_mix(BATCH, g, configs.RandomMixConfig())
    rows = []

    b1_err, f_n, pre_n = check_b1(clean, draws)
    rows.append(dict(
        name="B1 fog_noise", route="cuda",
        source="tsr_tpu_torch/kernels/csrc/fog_noise.cu",
        replaces="tsr_tpu/kernels/distort.py:131", max_abs_err=b1_err,
        tol=1e-6, **b1_times(clean, draws), library_ms=None))

    # B2 / B3 on the mix's pre-blur batch (integers 0..255), each held
    # against the plain version with the full kernels: both are exact
    x = pre_n
    kerns = tblur.motion_blur_kernels(draws.degrees, draws.angles, K)
    b, h, w, c = x.shape
    pix = b * h * w * c
    nnz = int((kerns != 0).sum())  # taps this run's kernels need
    xp = F.pad(x.permute(0, 3, 1, 2).reshape(1, b * c, h, w),
               (K // 2, K - 1 - K // 2) * 2, mode="reflect")
    weight = kerns.repeat_interleave(c, 0).reshape(b * c, 1, K, K)
    lib = cuda_ms(lambda: F.conv2d(xp, weight, groups=b * c))
    for name, fn, flops, source_line in (
            ("B2 blur_sparse", kblur.filter2d_sparse, 2 * nnz * h * w * c,
             "tsr_tpu/kernels/blur_pallas.py:191"),
            ("B3 blur_dense", kblur.filter2d_dense, 2 * K * K * pix,
             "tsr_tpu/kernels/blur_pallas.py:87")):
        out = fn(x, kerns)
        ref = kblur.filter2d_plain(x, kerns)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        check(err < 1e-3, f"{name} max err {err} >= 1e-3")
        ms = cuda_ms(lambda: fn(x, kerns))
        plain = cuda_ms(lambda: kblur.filter2d_plain(x, kerns))
        t_b, by = bound(2 * pix * 4 + b * K * K * 4, flops)
        print(f"{name}: max err {err:.3g} (tol 1e-3); {ms:.4f} ms, bound "
              f"{t_b:.4f} ms ({by}), {100 * t_b / ms:.0f} % of bound")
        rows.append(dict(
            name=name, route="cuda",
            source="tsr_tpu_torch/kernels/csrc/blur_taps.cu",
            replaces=source_line, max_abs_err=err, tol=1e-3, ms=ms,
            plain_ms=plain, bound_ms=t_b, bound_by=by, library_ms=lib))

    # B2 on a box kernel: 225 equal taps, far above the TPU's 3K budget
    box = torch.full((b, K, K), 1.0 / (K * K), device=dev)
    err_box = (kblur.filter2d_sparse(x, box)
               - kblur.filter2d_plain(x, box)).abs().max().item()
    check(err_box < 1e-3, f"B2 box kernel max err {err_box} >= 1e-3")
    rows[1]["max_abs_err"] = max(rows[1]["max_abs_err"], err_box)
    print(f"B2 box kernel (225 equal taps): max err {err_box:.3g} (tol 1e-3)")

    epilogue = check_b2_epilogue(x, kerns, f_n, draws.gate_blur)
    print("blur_epilogue: " + json.dumps(epilogue))

    # a shared even-sized kernel (the demo's K=10) through filter2d: B3
    k10 = tblur.motion_blur_kernel(10, 45.0, max_degree=10, device=dev)
    out = tblur.filter2d(x, k10)
    ref = kblur.filter2d_plain(x, k10.expand(b, 10, 10))
    torch.cuda.synchronize()
    err10 = (out - ref).abs().max().item()
    check(err10 < 1e-3, f"shared K=10 filter2d max err {err10} >= 1e-3")
    rows[2]["max_abs_err"] = max(rows[2]["max_abs_err"], err10)
    print(f"B3 shared K=10 via filter2d: max err {err10:.3g} (tol 1e-3)")

    # B1 and B2 (epilogue mode) at the training mix's group shapes
    rows[0]["train_shapes"], rows[1]["train_shapes"] = {}, {}
    n = TRAIN_BATCH // len(TRAIN_SCALES)
    for s in TRAIN_SCALES:
        clean = torch.randint(0, 256, (n, s, s, 3), dtype=torch.uint8,
                              device=dev, generator=g)
        draws = distortions.draw_random_mix(n, g, configs.RandomMixConfig())
        err, f_n, pre_n = check_b1(clean, draws)
        rows[0]["max_abs_err"] = max(rows[0]["max_abs_err"], err)
        rows[0]["train_shapes"][s] = b1_times(clean, draws)
        kerns = tblur.motion_blur_kernels(draws.degrees, draws.angles, K)
        ep = check_b2_epilogue(pre_n, kerns, f_n, draws.gate_blur)
        rows[1]["train_shapes"][s] = {k: ep[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "max_lsb",
            "gates_on")}
        t1 = rows[0]["train_shapes"][s]
        print(f"times at [{n}, {s}, {s}, 3]: B1 {t1['ms']:.4f} ms (plain "
              f"{t1['plain_ms']:.4f}, bound {t1['bound_ms']:.5f}); "
              f"B2+epilogue {ep['ms']:.4f} ms (plain {ep['plain_ms']:.4f}, "
              f"bound {ep['bound_ms']:.5f})")
    return rows


def small_reference_check(dev):
    """The slice's path on CUDA vs the CPU's plain versions, fp32, small
    shapes, noise gates off (the kernel's Philox stream has no CPU twin).
    The mix runs under both blur backends: sparse (B2) and dense (B3)."""
    import torch
    from tsr_tpu_torch import eval as teval
    from tsr_tpu_torch.kernels import _build
    from tsr_tpu_torch.models import ResUNet, VGG16
    from tsr_tpu_torch.ops import blur as tblur
    from tsr_tpu_torch.ops import distortions
    torch.manual_seed(SEED)
    r_cpu = ResUNet((8, 16, 32), 64).eval()
    j_cpu = VGG16(num_classes=43, cfg=(16, "M", 32, "M", 32, "M"),
                  fc_width=64, input_size=32).eval()
    r_gpu = copy.deepcopy(r_cpu).to(dev)
    j_gpu = copy.deepcopy(j_cpu).to(dev)
    g = torch.Generator().manual_seed(SEED + 7)
    clean = torch.randint(0, 256, (8, 32, 32, 3), dtype=torch.uint8,
                          generator=g)
    draws = distortions.draw_random_mix(8, g)
    draws = dataclasses.replace(draws,
                                gate_noise=torch.zeros(8, dtype=torch.bool))
    lsbs = {}
    for backend, kernel in (("dense", "blur_dense"),
                            ("sparse", "blur_sparse")):
        tblur.set_backend(backend)
        try:
            bad_cpu = distortions.random_mix_from_draws(clean, draws)
            _build.reset_launch_counts()
            bad_gpu = distortions.random_mix_from_draws(clean.to(dev),
                                                        draws.to(dev))
            counts = _build.launch_counts()
        finally:
            tblur.set_backend("sparse")
        check(counts[kernel] == 1 and sum(counts.values()) == 2,
              f"{backend} mix launched {counts}")
        lsbs[backend] = int((bad_gpu.cpu().int() - bad_cpu.int()).abs().max())
        check(lsbs[backend] <= 1,
              f"{backend} random mix CUDA vs CPU differs by "
              f"{lsbs[backend]} LSB")
    labels = torch.randint(0, 43, (8,), generator=g)
    out_cpu = teval.make_fused_eval_step(r_cpu, j_cpu, with_metrics=True,
                                         device="cpu")(bad_cpu, labels, clean)
    out_gpu = teval.make_fused_eval_step(r_gpu, j_gpu, with_metrics=True,
                                         device=dev)(bad_cpu, labels, clean)
    conf = (out_gpu["confidence"].cpu() - out_cpu["confidence"]).abs().max()
    psnr = (out_gpu["psnr"].cpu() - out_cpu["psnr"]).abs().max()
    agree = (out_gpu["pred"].cpu() == out_cpu["pred"]).float().mean()
    check(conf.item() <= 1e-3, f"fused step confidence differs by {conf}")
    check(psnr.item() <= 1e-2, f"fused step PSNR differs by {psnr}")
    check(agree.item() == 1.0, f"fused step pred agreement {agree}")
    print(f"reference check (fp32, 8x32x32): mix max {lsbs['sparse']} LSB "
          f"on B2, {lsbs['dense']} LSB on B3 (tol 1), "
          f"confidence max diff {conf.item():.3g} (tol 1e-3), PSNR max diff "
          f"{psnr.item():.3g} dB (tol 1e-2), pred agreement {agree.item()}")


def _grads_close(name, got, ref, rtol):
    """Gradients of two copies of one model: each within ``rtol`` of its
    tensor's largest plus ``rtol`` / 100 of the model's largest gradient;
    a convolution bias that feeds a batch norm (exact gradient 0) below
    ``rtol`` / 10 of the model's largest on both sides. Returns the worst
    error relative to its tensor's largest."""
    from tsr_tpu_torch.models.layers import batchnorm_fed_biases
    ref = {n: p.grad.cpu() for n, p in ref.named_parameters()}
    top = max(g.abs().max().item() for g in ref.values())
    fed = batchnorm_fed_biases(got)
    check(len(fed) > 0, f"{name}: no convolution bias feeds a batch norm")
    worst = 0.0
    for n, p in got.named_parameters():
        g, r = p.grad.cpu(), ref[n]
        if n in fed:
            check(max(g.abs().max().item(), r.abs().max().item())
                  <= rtol / 10 * top, f"{name}: {n} gradient not ~0")
            continue
        err = (g - r).abs().max().item()
        check(err <= rtol * r.abs().max().item() + rtol / 100 * top,
              f"{name}: {n} gradient differs by {err}")
        worst = max(worst, err / max(r.abs().max().item(), 1e-30))
    return worst


def small_train_check(dev):
    """One unified train step on CUDA vs the CPU's plain path: fp32, TF32
    off, small widths, the multiscale mix (scales 16 and 24 of 32) with
    the noise gates off. The mix within 1 LSB (B1 and B2 once per group on
    the card); on the CPU's training pair, the loss within 1e-5 relative,
    the gradients as ``_grads_close`` holds them at 1e-4 and the running
    statistics within 1e-5 of the layer's largest (and at least 1)."""
    import torch
    from tsr_tpu_torch import configs, losses
    from tsr_tpu_torch.kernels import _build
    from tsr_tpu_torch.models import ResUNet, VGG16
    from tsr_tpu_torch.ops import distortions
    from tsr_tpu_torch.ops import image as timage
    from tsr_tpu_torch.train import common
    torch.manual_seed(SEED)
    r_cpu = ResUNet((8, 16, 32), 64).train()
    v_cpu = VGG16(num_classes=5, cfg=(16, 16, "M", 32, 32, "M", 32, 32, 32,
                                      "M"), fc_width=32, input_size=32)
    r_gpu = copy.deepcopy(r_cpu).to(dev)
    v_gpu = copy.deepcopy(v_cpu).to(dev)
    scales = (16, 24)
    cfg = configs.RandomMixConfig(apply_scales=scales)
    g = torch.Generator().manual_seed(SEED + 9)
    clean = torch.randint(0, 256, (8, 32, 32, 3), dtype=torch.uint8,
                          generator=g)
    draws = distortions.draw_random_mix(8, g, cfg, n_seeds=len(scales))
    draws = dataclasses.replace(draws,
                                gate_noise=torch.zeros(8, dtype=torch.bool))
    bad_cpu = distortions.random_mix_multiscale_from_draws(clean, draws,
                                                           scales)
    _build.reset_launch_counts()
    bad_gpu = distortions.random_mix_multiscale_from_draws(
        clean.to(dev), draws.to(dev), scales)
    counts = _build.launch_counts()
    check(counts["fog_noise"] == counts["blur_sparse"] == len(scales)
          and counts["blur_dense"] == 0, f"multiscale mix launched {counts}")
    lsb = int((bad_gpu.cpu().int() - bad_cpu.int()).abs().max())
    check(lsb <= 1, f"multiscale mix CUDA vs CPU differs by {lsb} LSB")
    pair = (timage.to_float01(bad_cpu), timage.to_float01(clean))
    out = {}
    for name, r, v, d in (("cpu", r_cpu, v_cpu, torch.device("cpu")),
                          ("gpu", r_gpu, v_gpu, dev)):
        loss, _ = common.unified_loss(r, *(t.to(d) for t in pair), 0.1,
                                      losses.perceptual_features(v))
        loss.backward()
        out[name] = loss.item()
    rel = abs(out["gpu"] - out["cpu"]) / abs(out["cpu"])
    check(rel <= 1e-5, f"train step loss differs by {rel} relative")
    worst = _grads_close("train step CUDA vs CPU", r_gpu, r_cpu, 1e-4)
    stats = 0.0
    for (n, a), (_, b) in zip(r_cpu.named_buffers(), r_gpu.named_buffers()):
        if n.endswith(("running_mean", "running_var")):
            err = (b.cpu() - a).abs().max().item()
            check(err <= 1e-5 * max(1.0, a.abs().max().item()),
                  f"train step {n} differs by {err}")
            stats = max(stats, err)
    print(f"train-step reference check (fp32, 8x32x32, scales {scales}): mix "
          f"max {lsb} LSB (tol 1), loss {out['gpu']:.6g} vs "
          f"{out['cpu']:.6g} ({rel:.3g} relative, tol 1e-5), worst gradient "
          f"{worst:.3g} of its tensor's largest (tol 1e-4), running stats "
          f"max diff {stats:.3g} (tol 1e-5)")


def train_phase(dev, vgg):
    """The unified trainer at full width, bf16: ResUNet (64/128/256, 512)
    from a seed, the frozen ``vgg`` as the perceptual net, a seeded uint8
    clean set on the card. One warm-up step, then a synchronised window of
    TRAIN_STEPS steps at TRAIN_BATCH; then REMAT_BATCH with the remat the
    trainer picks. Launch counts are zeroed just before each trainer call
    and read just after."""
    import torch
    from tsr_tpu_torch import configs, losses
    from tsr_tpu_torch.kernels import _build
    from tsr_tpu_torch.models import ResUNet
    from tsr_tpu_torch.train import common, loops
    torch.manual_seed(SEED + 2)
    with torch.device(dev):
        model = ResUNet((64, 128, 256), 512, dtype="bf16")
    model = model.to(memory_format=torch.channels_last)
    vgg_apply = losses.perceptual_features(vgg)
    cfg = configs.UnifiedTrainConfig(
        batch_size=TRAIN_BATCH, epochs=1,
        mix=configs.RandomMixConfig(apply_scales=TRAIN_SCALES))
    n_clean = max(TRAIN_STEPS * TRAIN_BATCH, REMAT_STEPS * REMAT_BATCH)
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    clean = torch.randint(0, 256, (n_clean + REMAT_BATCH, SIZE, SIZE, 3),
                          dtype=torch.uint8, device=dev, generator=g)
    va_idx = torch.arange(n_clean, n_clean + TRAIN_BATCH).numpy()
    state = common.create_unified_state(model, cfg, TRAIN_STEPS)
    before = {k: v.clone() for k, v in model.state_dict().items()
              if not k.endswith("num_batches_tracked")}
    quiet = lambda line: None  # noqa: E731
    n_groups = len(TRAIN_SCALES)

    def fit(cfg, tr_idx, va_idx):
        _build.reset_launch_counts()
        _, hist = loops.train_unified_on_device(
            state, clean, tr_idx, va_idx, cfg, vgg_apply, log=quiet,
            device=dev)
        return hist[-1], _build.launch_counts()

    warm, _ = fit(cfg, torch.arange(TRAIN_BATCH).numpy(), va_idx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    rec, counts = fit(cfg, torch.arange(TRAIN_STEPS * TRAIN_BATCH).numpy(),
                      va_idx)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    expect = n_groups * (TRAIN_STEPS + 1)  # every train and val batch
    check(counts["fog_noise"] == counts["blur_sparse"] == expect
          and counts["blur_dense"] == 0,
          f"train window launched {counts}, expected {expect} of B1 and B2 "
          f"({n_groups} groups x ({TRAIN_STEPS} steps + 1 val batch))")
    losses_all = (warm["step_loss"] + rec["step_loss"] + rec["pixel_loss"]
                  + rec["perceptual_loss"] + [warm["val_loss"],
                                              rec["val_loss"]])
    check(all(math.isfinite(v) for v in losses_all), "finite train losses")
    after = model.state_dict()
    moved = {k: not torch.equal(v, after[k]) for k, v in before.items()}
    check(all(moved.values()), "every parameter and running statistic "
          f"moved: {[k for k, m in moved.items() if not m]}")
    check(state.step == TRAIN_STEPS + 1, f"{state.step} steps taken")

    # batch REMAT_BATCH: the trainer picks remat="vgg"; one warm-up step,
    # then REMAT_STEPS steps
    big = dataclasses.replace(cfg, batch_size=REMAT_BATCH)
    remat = loops.auto_remat(big, vgg_apply)
    check(remat == "vgg", f"auto remat at batch {REMAT_BATCH}: {remat}")
    va_big = torch.arange(n_clean, n_clean + REMAT_BATCH).numpy()
    fit(big, torch.arange(REMAT_BATCH).numpy(), va_big)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    rec_big, counts_big = fit(
        big, torch.arange(REMAT_STEPS * REMAT_BATCH).numpy(), va_big)
    peak_big = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    check(all(math.isfinite(v) for v in rec_big["step_loss"]),
          "finite batch-128 losses")
    check(counts_big["fog_noise"] == n_groups * (REMAT_STEPS + 1),
          f"batch-{REMAT_BATCH} window launched {counts_big}")
    summary = {
        "path": "multiscale mix (B1, B2) -> ResUNet train -> L1 + 0.1 VGG "
                "perceptual -> AdamW cosine", "dtype": "bf16", "size": SIZE,
        "batch": TRAIN_BATCH, "scales": list(TRAIN_SCALES),
        "window_steps": TRAIN_STEPS,
        "images_per_sec": rec["images_per_sec"],
        "window_seconds": rec["train_seconds"],
        "first_loss": warm["step_loss"][0], "last_loss": rec["step_loss"][-1],
        "pixel_loss_last": rec["pixel_loss"][-1],
        "perceptual_loss_last": rec["perceptual_loss"][-1],
        "val_loss": rec["val_loss"], "peak_memory_gib": peak,
        "launches_window": counts, "launches_expected": expect,
        "params_and_stats_moved": True,
        "remat_batch": REMAT_BATCH, "remat": remat,
        "remat_window_steps": REMAT_STEPS,
        "remat_images_per_sec": rec_big["images_per_sec"],
        "remat_peak_memory_gib": peak_big,
        "remat_last_loss": rec_big["step_loss"][-1]}
    print("train: " + json.dumps(summary))

    # where the device time of one train step goes (diagnostic only)
    step = common.make_unified_train_step(cfg.mix, cfg.perceptual_weight,
                                          vgg_apply)
    batch = clean[:TRAIN_BATCH]
    breakdown = device_breakdown(lambda: step(
        state, batch, torch.Generator(device=dev).manual_seed(SEED)))
    if breakdown is not None:
        prof_rows, busy, n_kernels, wall, all_rows = breakdown
        print(f"profile of one train step (batch {TRAIN_BATCH}): device "
              f"busy {busy:.3f} ms over {wall:.3f} ms wall; {n_kernels} "
              f"device kernels")
        print("  by kind (approximate, by kernel name): "
              + kinds_line(all_rows, busy))
        for kname, ms, n in prof_rows:
            print(f"  {ms:8.3f} ms {n:4d}x  {kname[:110]}")
    return counts


def write_clean_tree(root):
    """TREE_IMAGES seeded images in TREE_CLASSES class folders as .ppm
    (the port's writer), native sides drawn from TREE_SIDES, often not
    square: a coarse random field upsampled plus grain. Returns the
    ``(h, w)`` of each file, in file order."""
    import numpy as np
    from tsr_tpu_torch import native
    rng = np.random.default_rng(SEED)
    shares = [s for s, _, _ in TREE_SIDES]
    paths, images = [], []
    for i in range(TREE_IMAGES):
        _, lo, hi = TREE_SIDES[rng.choice(len(TREE_SIDES), p=shares)]
        h = int(rng.integers(lo, hi + 1))
        w = int(np.clip(round(h * rng.uniform(0.8, 1.25)), lo, hi))
        coarse = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3))
        img = np.repeat(np.repeat(coarse, 8, 0), 8, 1)[:h, :w]
        img = np.clip(img + rng.integers(-20, 21, img.shape), 0, 255)
        cls = root / f"{i % TREE_CLASSES:05d}"
        cls.mkdir(parents=True, exist_ok=True)
        paths.append(str(cls / f"{i // TREE_CLASSES:05d}.ppm"))
        images.append(img.astype(np.uint8))
    native.write_images(paths, images)
    order = sorted(range(TREE_IMAGES), key=lambda i: paths[i])
    return [images[i].shape[:2] for i in order]


def tree_buckets(sides, halo):
    """``{(bh, bw): images}`` of generate_tree's buckets for natives
    ``sides``."""
    from tsr_tpu_torch import offline
    seen = {}
    for h, w in sides:
        b = (offline._bucket_with_room(h, halo),
             offline._bucket_with_room(w, halo))
        seen[b] = seen.get(b, 0) + 1
    return seen


def check_blur_at_buckets(dev, files, rows, key="tree_times"):
    """B3 (blur's shared K=12, compound's shared K=10) and B2 (blur_rand's
    per-sample K=15) on the first padded batch of each of their buckets
    over ``files`` (generate_tree's batches), against filter2d_plain on the
    same batch: max error < 1e-3, and the uint8 after cvRound/saturate
    compared value by value. Three shapes a kind are timed beside their
    bound and their plain version: the batch with the most pixels, the
    smallest canvas and the largest. Adds ``key`` (those times) to the B2
    and B3 rows."""
    import torch
    from tsr_tpu_torch import offline
    from tsr_tpu_torch.kernels import blur as kblur
    from tsr_tpu_torch.ops import blur as tblur
    from tsr_tpu_torch.ops import distortions
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    rows[1][key], rows[2][key] = {}, {}
    for kind, row, fn in (("blur", rows[2], kblur.filter2d_dense),
                          ("compound", rows[2], kblur.filter2d_dense),
                          ("blur_rand", rows[1], kblur.filter2d_sparse)):
        firsts = {}
        for bucket, _, batch in offline.bucketed_batches(
                files, TREE_BATCH, offline.HALO[kind]):
            firsts.setdefault(bucket, batch)
        held = []
        for batch in firsts.values():
            x = torch.from_numpy(batch).to(dev).to(torch.float32)
            b = x.shape[0]
            if kind == "blur_rand":
                k = distortions.MAX_BLUR_DEGREE
                kerns = tblur.motion_blur_kernels(
                    torch.randint(4, k + 1, (b,), generator=g, device=dev),
                    torch.rand(b, generator=g, device=dev) * 360.0, k)
            else:
                k = 12 if kind == "blur" else 10
                kerns = tblur.motion_blur_kernel(
                    k, 45.0, max_degree=k, device=dev).expand(b, k, k)
            got = fn(x, kerns)
            ref = kblur.filter2d_plain(x, kerns)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            n_u8 = int((torch.round(got).clamp(0, 255)
                        != torch.round(ref).clamp(0, 255)).sum())
            check(err < 1e-3, f"{row['name']} at {list(x.shape)} K={k} "
                  f"({kind}) max err {err} >= 1e-3")
            row["max_abs_err"] = max(row["max_abs_err"], err)
            held.append((x, kerns, k, err, n_u8))
        print(f"{row['name']} {kind}: held at the first batch of each of "
              f"{len(held)} buckets (K={held[0][2]}): max err "
              f"{max(e for *_, e, _ in held):.3g} (tol 1e-3), cvRound/"
              f"saturate differs at {sum(n for *_, n in held)} of "
              f"{sum(x.numel() for x, *_ in held)} values")
        timed = {id(h): h for h in (
            max(held, key=lambda h: h[0].numel()),
            min(held, key=lambda h: h[0].shape[1] * h[0].shape[2]),
            max(held, key=lambda h: h[0].shape[1] * h[0].shape[2]))}
        for x, kerns, k, err, n_u8 in timed.values():
            b, h, w, c = x.shape
            flops = (2 * int((kerns != 0).sum()) * h * w * c
                     if kind == "blur_rand" else 2 * k * k * x.numel())
            ms = cuda_ms(lambda: fn(x, kerns))
            plain = cuda_ms(lambda: kblur.filter2d_plain(x, kerns))
            t_b, by = bound(2 * x.numel() * 4 + b * k * k * 4, flops)
            row[key][f"{kind} {b}x{h}x{w}x{c} K={k}"] = dict(
                max_abs_err=err, u8_differ=n_u8, ms=ms, plain_ms=plain,
                bound_ms=t_b, bound_by=by)
            print(f"  {kind} {list(x.shape)} K={k}: {ms:.4f} ms, bound "
                  f"{t_b:.5f} ms ({by}), plain {plain:.4f} ms")


def blur_tree_card_vs_cpu(dev, clean_dir, work):
    """The deterministic blur kind over BLUR_CPU_FILES files of the tree,
    on the card (B3) and on the CPU (plain versions): the files compared
    value by value. A blur value at a cvRound tie may round the other way
    where float32 sums differ in order, and the min-max epilogue magnifies
    such a difference; the differences are counted."""
    import numpy as np
    from tsr_tpu_torch import native, offline
    files = offline.tree_files(str(clean_dir))[:BLUR_CPU_FILES]
    sub = work / "blur_subset"
    for p in files:
        dst = sub / p.relative_to(clean_dir)
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_bytes(p.read_bytes())
    quiet = lambda line: None  # noqa: E731
    for name, d in (("card", dev), ("cpu", "cpu")):
        offline.generate_tree(str(sub), str(work / f"blur_{name}"), "blur",
                              seed=SEED, batch_size=TREE_BATCH, log=quiet,
                              device=d)
    n_files = n_vals = n_diff = max_diff = files_diff = 0
    for p in offline.tree_files(str(work / "blur_card")):
        rel = p.relative_to(work / "blur_card")
        a = native.decode(str(p)).astype(int)
        b = native.decode(str(work / "blur_cpu" / rel)).astype(int)
        d = np.abs(a - b)
        n_files += 1
        n_vals += d.size
        n_diff += int((d > 0).sum())
        files_diff += int(d.max() > 0)
        max_diff = max(max_diff, int(d.max()))
    check(n_files == len(files), f"blur subset wrote {n_files} files")
    check(n_diff <= 1e-3 * n_vals,
          f"blur tree card vs CPU: {n_diff} of {n_vals} values differ")
    print(f"blur tree card vs CPU ({n_files} files): {files_diff} files "
          f"differ, {n_diff} of {n_vals} values, max {max_diff} LSB after "
          f"the min-max epilogue (tol: under 0.1 % of values)")
    return dict(files=n_files, files_differ=files_diff, values=n_vals,
                values_differ=n_diff, max_lsb=max_diff)


def preds_by_file(step, data_dir, resize, dev):
    """Per-file predictions of the fused step over ``data_dir``, in file
    order, through the same loaders as ``evaluate_directory``."""
    import numpy as np
    import torch
    from tsr_tpu_torch import infer
    from tsr_tpu_torch.data import gtsrb
    ds = gtsrb.ImageFolder(str(data_dir), size=SIZE)
    paths = [p for p, _ in ds.samples]
    labels = np.asarray([lab for _, lab in ds.samples])
    preds = np.full(len(paths), -1)
    if resize == "host":
        for s in range(0, len(paths), BATCH):
            imgs, labs = ds.load_batch(np.arange(s, min(s + BATCH,
                                                        len(paths))))
            preds[s:s + len(labs)] = step(imgs, labs)["pred"].cpu().numpy()
    else:
        for padded, sizes, _, idxs in infer.native_batches(
                paths, SIZE, BATCH, pad_batch=False, device=dev):
            out = step((padded, sizes), torch.from_numpy(labels[idxs]))
            preds[idxs] = out["pred"].cpu().numpy()
    check((preds >= 0).all(), "a prediction for every file")
    return preds


def png_round_trip(dev, resunet, bad_dir, out_dir, resize):
    """The first batch of a restore walk rebuilt as ``restore_tree`` builds
    it and restored again; the PNGs the walk wrote for those files, decoded
    back, must equal it exactly. Returns (files compared, the batch's
    restore-step device ms)."""
    import numpy as np
    from tsr_tpu_torch import infer, native, offline
    from tsr_tpu_torch.data import gtsrb
    files = offline.tree_files(str(bad_dir))
    if resize == "device":
        step = infer.make_native_restore_step(resunet, SIZE, device=dev)
        walk = infer.native_batches([str(p) for p in files], SIZE, BATCH,
                                    device=dev)
        padded, sizes, _, idxs = next(walk)
        walk.close()  # stops its producer thread
        out = step(padded, sizes)[:len(idxs)].cpu().numpy()
        ms = cuda_ms(lambda: step(padded, sizes), iters=5, warmup=1)
    else:
        step = infer.make_restore_step(resunet, device=dev)
        idxs = list(range(BATCH))
        batch = gtsrb._decode_resize_batch([str(files[i]) for i in idxs],
                                           SIZE)
        out = step(batch).cpu().numpy()
        ms = cuda_ms(lambda: step(batch), iters=5, warmup=1)
    for j, i in enumerate(idxs):
        png = (out_dir / files[i].relative_to(bad_dir)).with_suffix(".png")
        check(np.array_equal(native.decode(str(png)), out[j]),
              f"{resize} walk's PNG {png} differs from the device output")
    return len(idxs), ms


def resize_numbers(dev, resunet, judge):
    """resize_from_padded at B=64 on each canvas of RESIZE_CANVASES: card
    ms beside its bytes bound, the card against the CPU on the same inputs,
    and the fused native-size step's images/s on that canvas."""
    import torch
    from tsr_tpu_torch import configs
    from tsr_tpu_torch import eval as teval
    from tsr_tpu_torch.ops import image as timage
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    step = teval.make_fused_eval_step(resunet, judge, native_size=SIZE,
                                      device=dev)
    labels = torch.randint(0, configs.NUM_CLASSES, (BATCH,), device=dev,
                           generator=g)
    out = {}
    for canvas in RESIZE_CANVASES:
        padded = torch.randint(0, 256, (BATCH, canvas, canvas, 3),
                               dtype=torch.uint8, device=dev, generator=g)
        # natives that native_batches puts on this canvas
        lo = max([c for c in RESIZE_CANVASES if c < canvas], default=0) + 1
        sizes = torch.randint(lo, canvas + 1, (BATCH, 2), device=dev,
                              generator=g, dtype=torch.int32)
        got = timage.resize_from_padded(padded, sizes, SIZE)
        ref = timage.resize_from_padded(padded.cpu(), sizes.cpu(), SIZE)
        d = (got.cpu().int() - ref.int()).abs()
        lsb, share = int(d.max()), float((d > 0).float().mean())
        check(lsb <= 1, f"resize_from_padded card vs CPU {lsb} LSB at "
              f"canvas {canvas}")
        ms = cuda_ms(lambda: timage.resize_from_padded(padded, sizes, SIZE))
        t_b, by = bound(padded.numel() + sizes.numel() * 4 + got.numel(),
                        6 * got.numel())
        step_ms = cuda_ms(lambda: step((padded, sizes), labels), iters=5,
                          warmup=2)
        ips = BATCH / step_ms * 1e3
        out[canvas] = dict(resize_ms=ms, bound_ms=t_b, bound_by=by,
                           card_vs_cpu_max_lsb=lsb,
                           card_vs_cpu_share_differ=share,
                           fused_native_images_per_sec=ips)
        print(f"resize_from_padded [{BATCH}, {canvas}, {canvas}, 3] -> "
              f"{SIZE}: {ms:.4f} ms, bound {t_b:.5f} ms ({by}); card vs "
              f"CPU max {lsb} LSB (tol 1), {share:.3g} of values differ; "
              f"fused native step {ips:.1f} images/s")
    return out


def trees_phase(dev, resunet, judge, rows, fused_ips, work):
    """Phase 5: the file-tree pipeline at full width, in the directory
    ``work`` (its trees stay there for the cascade phase). A seeded clean
    tree; generate_tree for each of the seven kinds (B3 for blur and
    compound, B2 for blur_rand, launch counts zeroed just before each call
    and read just after); the blur kernels held at every bucket shape; the
    blur tree on the card against the CPU; restore_tree (device and host
    resize) and evaluate_directory (host and device) on the compound tree;
    the device resize alone; where the walk's time goes. Returns the B2/B3
    launches of the generate_tree runs and the buckets each ran at."""
    import numpy as np
    import torch
    from tsr_tpu_torch import eval as teval
    from tsr_tpu_torch import infer, native, offline
    from tsr_tpu_torch.kernels import _build
    quiet = lambda line: None  # noqa: E731
    clean = work / "clean"
    t0 = time.perf_counter()
    sides = write_clean_tree(clean)
    print(f"clean tree: {TREE_IMAGES} .ppm files in {TREE_CLASSES} "
          f"classes, written in {time.perf_counter() - t0:.2f} s; "
          f"max side <= 64: {sum(max(s) <= 64 for s in sides)}, 65-192: "
          f"{sum(64 < max(s) <= 192 for s in sides)}, 193-223: "
          f"{sum(192 < max(s) < 224 for s in sides)}, >= 224: "
          f"{sum(max(s) >= 224 for s in sides)}; non-square "
          f"{sum(h != w for h, w in sides)}")

    launches = {"blur_sparse": 0, "blur_dense": 0, "fog_noise": 0}
    shapes = {"blur_sparse": set(), "blur_dense": set()}
    gen = {}
    for kind in offline.KINDS:
        buckets = tree_buckets(sides, offline.HALO.get(kind, 0))
        n_batches = sum(-(-n // TREE_BATCH) for n in buckets.values())
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        n = offline.generate_tree(str(clean), str(work / kind), kind,
                                  seed=SEED, batch_size=TREE_BATCH,
                                  log=quiet, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = _build.launch_counts()
        check(n == TREE_IMAGES, f"{kind} wrote {n} images")
        want = {"blur_dense": n_batches if kind in ("blur", "compound")
                else 0,
                "blur_sparse": n_batches if kind == "blur_rand" else 0,
                "fog_noise": 0}
        check(counts == want, f"{kind} launched {counts}, expected "
              f"{want}")
        for k, v in counts.items():
            launches[k] += v
            if v:
                shapes[k].update(f"{bh}x{bw}" for bh, bw in buckets)
        gen[kind] = dict(images_per_sec=n / dt, seconds=dt,
                         batches=n_batches, launches=counts,
                         buckets={f"{bh}x{bw}": m for (bh, bw), m
                                  in sorted(buckets.items())})
        print(f"generate_tree {kind}: {n / dt:.1f} images/s ({dt:.3f} "
              f"s), {n_batches} batches, B2 {counts['blur_sparse']} / "
              f"B3 {counts['blur_dense']} launches; buckets "
              + json.dumps(gen[kind]["buckets"]))
    check(launches["blur_sparse"] > 0 and launches["blur_dense"] > 0,
          "B2 and B3 launched on the trees path")

    check_blur_at_buckets(dev, offline.tree_files(str(clean)), rows)
    blur_cpu = blur_tree_card_vs_cpu(dev, clean, work)

    bad = work / "compound"
    walks = {}
    for resize in ("device", "host"):
        out = work / f"restored_{resize}"
        _build.reset_launch_counts()
        res = infer.restore_tree(resunet, str(bad), str(out),
                                 clean_dir=str(clean), batch_size=BATCH,
                                 size=SIZE, resize=resize, log=quiet,
                                 device=dev)
        written = len(list(out.glob("*/*.png")))
        check(res["images"] == written == TREE_IMAGES,
              f"restore_tree {resize}: {res['images']} images, "
              f"{written} files")
        check(math.isfinite(res["psnr"]) and 0 <= res["ssim"] <= 1,
              f"restore_tree {resize} metrics finite")
        check(sum(_build.launch_counts().values()) == 0,
              "restore_tree launches no blur or B1 kernel")
        n_png, step_ms = png_round_trip(dev, resunet, bad, out, resize)
        res["png_round_trip_files"] = n_png
        res["step_ms_first_batch"] = step_ms
        res["device_busy_share"] = (step_ms * res["batches"]
                                    / (res["seconds"] * 1e3))
        walks[resize] = res
        print(f"restore_tree resize={resize}: {res['images_per_sec']:.1f}"
              f" images/s ({res['seconds']:.3f} s, {res['batches']} "
              f"batches), {written} files, PSNR {res['psnr']:.4f} dB, "
              f"SSIM {res['ssim']:.5f}; PNG round trip exact on "
              f"{n_png} files; restore step {step_ms:.3f} ms a batch, "
              f"device busy about {100 * res['device_busy_share']:.1f} % "
              f"of the walk; host seconds by stage (summed over "
              f"threads) " + json.dumps(res["host_seconds"]))
    n_px = n_diff = max_diff = 0
    for p in (work / "restored_device").glob("*/*.png"):
        a = native.decode(str(p)).astype(int)
        b = native.decode(str(work / "restored_host"
                              / p.relative_to(work / "restored_device"))
                          ).astype(int)
        d = np.abs(a - b)
        n_px += d.size
        n_diff += int((d > 0).sum())
        max_diff = max(max_diff, int(d.max()))
    modes_share = n_diff / n_px
    print(f"restore_tree device vs host resize: {n_diff} of {n_px} "
          f"output values differ ({100 * modes_share:.3f} %), max "
          f"{max_diff} LSB")

    evals = {}
    # device resize twice: its bucket tails (pad_batch=False) give the
    # models batch sizes they meet first in the first run
    for name, resize in (("host", "host"), ("device", "device"),
                         ("device, second run", "device")):
        res = teval.evaluate_directory(judge, str(bad), batch_size=BATCH,
                                       size=SIZE, restorer=resunet,
                                       resize=resize, device=dev)
        check(res["n"] == TREE_IMAGES and 0 <= res["top1"] <= 1
              and math.isfinite(res["confidence"]),
              f"evaluate_directory {name}: {res}")
        evals[name] = res
    steps = {
        "host": teval.make_fused_eval_step(resunet, judge, device=dev),
        "device": teval.make_fused_eval_step(resunet, judge,
                                             native_size=SIZE,
                                             device=dev)}
    preds = {r: preds_by_file(s, bad, r, dev) for r, s in steps.items()}
    agree = float((preds["host"] == preds["device"]).mean())
    for name, res in evals.items():
        print(f"evaluate_directory resize={name}: "
              f"{res['images_per_sec']:.1f} images/s, n {res['n']}, "
              f"top-1 {res['top1']:.4f} (random weights)")
    print(f"evaluate_directory: host and device resize agree on "
          f"{100 * agree:.2f} % of predictions")

    resize_stats = resize_numbers(dev, resunet, judge)
    print(f"fused step at 224x224 (phase 3): {fused_ips:.1f} images/s")

    summary = {
        "path": "generate_tree -> restore_tree -> evaluate_directory",
        "images": TREE_IMAGES, "classes": TREE_CLASSES,
        "generate_batch": TREE_BATCH, "batch": BATCH, "size": SIZE,
        "generate_tree": {k: {f: v for f, v in r.items() if f != "buckets"}
                          for k, r in gen.items()},
        "blur_card_vs_cpu": blur_cpu,
        "restore_tree": walks,
        "restore_modes_values_differ_share": modes_share,
        "restore_modes_max_lsb": max_diff,
        "evaluate_directory": {r: {k: v for k, v in res.items()}
                               for r, res in evals.items()},
        "evaluate_modes_agree": agree, "resize_from_padded": resize_stats,
        "fused_224_images_per_sec": fused_ips}
    print("trees: " + json.dumps(summary))
    return launches, {k: sorted(v) for k, v in shapes.items()}


def restorer_provenance(distorted_dir, input_minmax):
    """A restorer checkpoint's config as the reference's training scripts
    write it: no identity anchor, ``input_minmax`` when set, and the
    severity read from the tree's ``.distortion`` marker."""
    cfg = {"identity_frac": 0.0}
    if input_minmax:
        cfg["input_minmax"] = True
    kind = json.loads((distorted_dir / ".distortion").read_text())["kind"]
    cfg["severity"] = "jittered" if kind.endswith("_rand") else "reference"
    return cfg


def model_flops():
    """Forward FLOPs of one SIZE x SIZE image through SimpleUNet, ResUNet,
    VGG16-D and its perceptual ``features[:16]`` (``torch.utils.
    flop_counter`` on the meta device: shapes only, the same on any
    card)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from tsr_tpu_torch.models import ResUNet, SimpleUNet, VGG16
    with torch.device("meta"):
        unet = SimpleUNet()
        resunet = ResUNet()
        vgg = VGG16(num_classes=43, input_size=SIZE)
        x = torch.zeros(1, 3, SIZE, SIZE)
    out = {}
    for name, fn in (("simple_unet", lambda: unet(x)),
                     ("resunet", lambda: resunet(x)),
                     ("vgg16", lambda: vgg(x)),
                     ("vgg16_features_16", lambda: vgg(x, tap_layer=15))):
        with FlopCounterMode(display=False) as counter:
            fn()
        out[name] = counter.get_total_flops()
    return out


def fit_restorer(dev, pairs, splits, ckpt=None, provenance=None,
                 dtype="fp32", epochs=1, input_minmax=False, vgg_apply=None,
                 seed=0):
    """One restorer trained by ``train_restorer_on_device`` on ``pairs``
    (uint8 distorted and clean trees) from a seed: the specialized recipe
    (MSE, Adam 1e-3), or with ``vgg_apply`` the advanced one (L1 + 0.1 x
    perceptual, Adam 2e-4); with ``ckpt``, checkpointed there every epoch
    with ``provenance`` as its config. Checks finite losses, the step count
    and that every parameter moved. Returns (state, last epoch's record,
    peak GiB)."""
    import torch
    from tsr_tpu_torch import configs, zoo
    from tsr_tpu_torch.train import common, loops
    if vgg_apply is None:
        cfg, pixel, weight = configs.RestorationTrainConfig(), "mse", 0.0
    else:
        cfg = configs.AdvancedTrainConfig()
        pixel, weight = "l1", cfg.perceptual_weight
    torch.manual_seed(SEED + seed)
    state = common.create_restoration_state(
        zoo.build_simple_unet(dtype, input_minmax, device=dev), cfg)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    tr_idx, va_idx = splits
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    state, hist = loops.train_restorer_on_device(
        state, *pairs, tr_idx, va_idx, epochs, cfg.batch_size, pixel=pixel,
        perceptual_weight=weight, vgg_apply=vgg_apply,
        save_path=None if ckpt is None else str(ckpt),
        checkpoint_every=1 if ckpt is not None else 0,
        ckpt_config=provenance, log=lambda line: None, seed=cfg.seed,
        device=dev)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    steps = len(tr_idx) // cfg.batch_size
    vals = [v for r in hist for v in r["step_loss"] + r["pixel_loss"]
            + r["perceptual_loss"] + [r["val_loss"]]]
    check(all(math.isfinite(v) for v in vals), "finite restorer losses")
    check(state.step == epochs * steps, f"restorer took {state.step} steps")
    after = state.model.state_dict()
    still = [k for k, v in before.items() if torch.equal(v, after[k])]
    check(not still, f"restorer parameters that did not move: {still}")
    return state, hist[-1], peak


def native_stages(dev, files, generator):
    """Script 13's phase 1 for each file: the native image on the card,
    mild blur (B3 at run-time K=5 on ``[1, h, w, 3]``), mild fog and mild
    noise, each stage resized to SIZE on the card (``resize_from_padded``,
    the cv2 convention). Returns the four stages as ``(name, [N, SIZE,
    SIZE, 3] uint8)`` and the native shapes."""
    import torch
    from tsr_tpu_torch import native
    from tsr_tpu_torch.ops import distortions
    from tsr_tpu_torch.ops import image as timage
    names = ("Clean", "+ Blur", "+ Fog", "+ Noise (final bad)")
    stages = {n: [] for n in names}
    shapes = []
    for f in files:
        x = torch.from_numpy(native.decode(str(f))).to(dev)
        h, w = x.shape[:2]
        shapes.append((h, w))
        blur = distortions.mild_blur(x, device=dev)
        fog = distortions.mild_fog(blur, device=dev)
        noise = distortions.mild_noise(fog, generator, device=dev)
        hw = torch.tensor([[h, w]], device=dev)
        for n, img in zip(names, (x, blur, fog, noise)):
            stages[n].append(timage.resize_from_padded(img[None], hw, SIZE))
    return [(n, torch.cat(v)) for n, v in stages.items()], shapes


def check_b3_k5(dev, shapes, gen):
    """B3 with the cascade's shared K=5 kernel against filter2d_plain on
    seeded integer images at each of ``shapes`` (``[B, H, W, 3]``): max
    error < 1e-3, and the uint8 after cvRound/saturate compared value by
    value; each timed beside its bound, its plain version and cuDNN's
    grouped convolution. Returns ``{shape: numbers}`` and the worst
    error."""
    import torch
    import torch.nn.functional as F
    from tsr_tpu_torch.kernels import blur as kblur
    from tsr_tpu_torch.ops import blur as tblur
    k = 5
    k5 = tblur.motion_blur_kernel(k, 45.0, max_degree=k, device=dev)
    out, worst = {}, 0.0
    for shape in shapes:
        b, h, w, c = shape
        x = torch.randint(0, 256, shape, generator=gen, device=dev).to(
            torch.float32)
        kerns = k5.expand(b, k, k)
        got = kblur.filter2d_dense(x, kerns)
        ref = kblur.filter2d_plain(x, kerns)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        n_u8 = int((torch.round(got).clamp(0, 255)
                    != torch.round(ref).clamp(0, 255)).sum())
        check(err < 1e-3, f"B3 K=5 at {list(shape)} max err {err} >= 1e-3")
        worst = max(worst, err)
        ms = cuda_ms(lambda: kblur.filter2d_dense(x, kerns))
        plain = cuda_ms(lambda: kblur.filter2d_plain(x, kerns))
        xp = F.pad(x.permute(0, 3, 1, 2).reshape(1, b * c, h, w),
                   (k // 2, k - 1 - k // 2) * 2, mode="reflect")
        weight = kerns.repeat_interleave(c, 0).reshape(b * c, 1, k, k)
        lib = cuda_ms(lambda: F.conv2d(xp, weight, groups=b * c))
        t_b, by = bound(2 * x.numel() * 4 + b * k * k * 4,
                        2 * k * k * x.numel())
        out[f"{b}x{h}x{w}x{c} K=5"] = dict(
            max_abs_err=err, u8_differ=n_u8, ms=ms, plain_ms=plain,
            library_ms=lib, bound_ms=t_b, bound_by=by)
        print(f"B3 K=5 {list(shape)}: max err {err:.3g} (tol 1e-3), "
              f"cvRound/saturate differs at {n_u8} of {x.numel()} values; "
              f"{ms:.4f} ms, bound {t_b:.5f} ms ({by}), plain {plain:.4f} "
              f"ms, cuDNN grouped conv {lib:.4f} ms")
    return out, worst


def small_cascade_check(dev):
    """A small fp32 cascade on the card against the CPU (TF32 off): small
    SimpleUNets (the fog one with input_minmax) and a narrow judge copied
    to both, the same injected noise. The distorted stages within 1 LSB
    (B3 on the card, the plain blur on the CPU); then, on the CPU's
    distorted stages, preds equal at all 7 stages, confidences and the
    restored stages within 1e-4."""
    import torch
    from tsr_tpu_torch import pipeline
    from tsr_tpu_torch.models import SimpleUNet, VGG16
    torch.manual_seed(SEED + 11)
    cpu = {t: SimpleUNet((8, 16), input_minmax=t == "fog").eval()
           for t in pipeline.RESTORATION_ORDER}
    j_cpu = VGG16(num_classes=5, cfg=(16, "M", 32, "M", 32, "M"),
                  fc_width=64, input_size=32).eval()
    gpu = {t: copy.deepcopy(m).to(dev) for t, m in cpu.items()}
    j_gpu = copy.deepcopy(j_cpu).to(dev)
    g = torch.Generator().manual_seed(SEED + 12)
    clean = torch.randint(0, 256, (8, 32, 32, 3), dtype=torch.uint8,
                          generator=g)
    noise = torch.randn(clean.shape, generator=g)
    ref = pipeline.cascade_stress(clean, cpu, j_cpu, noise=noise,
                                  device="cpu")
    drawn = pipeline.cascade_stress(clean, gpu, j_gpu, noise=noise,
                                    device=dev)
    lsb = max(int(abs(a.astype(int) - b.astype(int)).max())
              for (_, a), (_, b) in zip(drawn["stages"][:4],
                                        ref["stages"][:4]))
    check(lsb <= 1, f"cascade distorted stages card vs CPU {lsb} LSB")
    got = pipeline.cascade_stress(clean, gpu, j_gpu, device=dev,
                                  precomputed_stages=ref["stages"][:4])
    conf = max(float(abs(a - b).max()) for a, b in
               zip(got["confidences"], ref["confidences"]))
    rest = max(float(abs(a - b).max()) for (_, a), (_, b) in
               zip(got["stages"][4:], ref["stages"][4:]))
    same = all((a == b).all() for a, b in zip(got["preds"], ref["preds"]))
    check(same, "cascade preds card vs CPU")
    check(conf <= 1e-4, f"cascade confidence card vs CPU differs by {conf}")
    check(rest <= 1e-4, f"cascade restored stages differ by {rest}")
    print(f"cascade reference check (fp32, TF32 off, 8x32x32): distorted "
          f"stages max {lsb} LSB (tol 1), preds equal at 7 stages, "
          f"confidence max diff {conf:.3g} (tol 1e-4), restored stages max "
          f"diff {rest:.3g} (tol 1e-4)")
    return dict(distorted_max_lsb=lsb, confidence_max_diff=conf,
                restored_max_diff=rest)


def cascade_phase(dev, judge, rows, work):
    """Phase 6: the specialized SimpleUNet restorers, trained and
    checkpointed, then the cascade at full width, on the trees phase's
    clean tree and its noise / blur / fog trees in ``work`` (made again if
    missing). ``judge`` (the serving VGG16-D) goes through a ``.pth`` and
    ``zoo.load_model`` in fp32, as scripts 07adv and 13 load it. Returns
    the kernels' launches over the cascade runs; adds ``cascade_times``
    and ``cascade_shapes`` to B3's row."""
    import random

    import numpy as np
    import torch
    from tsr_tpu_torch import configs, losses, offline, pipeline, zoo
    from tsr_tpu_torch.data import gtsrb
    from tsr_tpu_torch.kernels import _build
    from tsr_tpu_torch.train import common, loops
    quiet = lambda line: None  # noqa: E731
    clean_dir = work / "clean"
    if not clean_dir.exists():
        write_clean_tree(clean_dir)
    for task in RESTORER_TASKS:
        if not (work / task / ".distortion").exists():
            offline.generate_tree(str(clean_dir), str(work / task), task,
                                  seed=SEED, batch_size=TREE_BATCH,
                                  log=quiet, device=dev)
    pth = work / "vgg16_judge.pth"
    torch.save(judge.state_dict(), pth)
    judge32 = zoo.load_model("vgg16", str(pth), size=SIZE, device=dev)
    check(judge32.dtype == torch.float32 and not judge32.training,
          "the fp32 judge from zoo.load_model")

    # -- the three specialized restorers (MSE, Adam 1e-3, fp32) -----------
    train = {}
    states = {}
    for i, task in enumerate(RESTORER_TASKS):
        t0 = time.perf_counter()
        ds = gtsrb.PairedFolder(str(clean_dir), str(work / task), size=SIZE)
        pairs = ds.load_batch(range(len(ds)))
        load_s = time.perf_counter() - t0
        check(len(ds) == TREE_IMAGES, f"{task}: {len(ds)} pairs")
        splits = gtsrb.train_val_split(
            len(ds), configs.RestorationTrainConfig().train_split, SEED)
        ckpt = work / "ckpt" / task
        state, rec, peak = fit_restorer(
            dev, pairs, splits, ckpt,
            restorer_provenance(work / task, task == "fog"),
            epochs=RESTORER_EPOCHS, input_minmax=task == "fog", seed=i)
        states[task] = (state, pairs, splits)
        check((ckpt / "model").exists() and (ckpt / "train").exists(),
              f"{task} checkpoint written")
        train[task] = dict(images_per_sec=rec["images_per_sec"],
                           seconds=rec["train_seconds"],
                           steps=state.step, first_loss=rec["step_loss"][0],
                           last_loss=rec["step_loss"][-1],
                           val_loss=rec["val_loss"], peak_memory_gib=peak,
                           pairs_load_seconds=load_s,
                           config=zoo.checkpoint_config(str(ckpt)))
        print(f"restorer {task} (fp32, TF32 off, batch 32, MSE, Adam 1e-3): "
              f"{rec['images_per_sec']:.1f} images/s over {state.step} "
              f"steps, loss {rec['step_loss'][0]:.5f} -> "
              f"{rec['step_loss'][-1]:.5f}, val {rec['val_loss']:.5f}, peak "
              f"{peak:.3f} GiB; pairs decoded in {load_s:.2f} s; config "
              + json.dumps(train[task]["config"]))

    # -- resume: the noise checkpoint continues its step count ------------
    noise_state, pairs, (tr_idx, va_idx) = states["noise"]
    torch.manual_seed(SEED + 20)
    resumed = zoo.load_train_state(
        str(work / "ckpt" / "noise"), common.create_restoration_state(
            zoo.build_simple_unet(device=dev),
            configs.RestorationTrainConfig()))
    check(resumed.step == noise_state.step,
          f"resumed at step {resumed.step}, saved {noise_state.step}")
    for (n, a), (_, b) in zip(noise_state.model.state_dict().items(),
                              resumed.model.state_dict().items()):
        check(torch.equal(a, b), f"resumed weight {n}")
    for a, b in zip(noise_state.optimizer.state.values(),
                    resumed.optimizer.state.values()):
        check(torch.equal(a["exp_avg_sq"], b["exp_avg_sq"]),
              "resumed Adam moments")
    resumed, _ = loops.train_restorer_on_device(
        resumed, *pairs, tr_idx[:RESUME_STEPS * RESTORER_BATCH], va_idx, 1,
        RESTORER_BATCH,
        log=quiet, device=dev)
    check(resumed.step == noise_state.step + RESUME_STEPS,
          f"resume continued to step {resumed.step}")
    print(f"resume: zoo.load_train_state at step {noise_state.step}, weights "
          f"and Adam moments equal, {RESUME_STEPS} more steps -> step "
          f"{resumed.step}")
    del states, resumed

    # -- bf16, TF32 (PyTorch's default), the advanced restorer ------------
    bf16 = fit_restorer(dev, pairs, (tr_idx, va_idx), dtype="bf16",
                        epochs=BF16_EPOCHS, seed=7)
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = fit_restorer(dev, pairs, (tr_idx, va_idx), seed=8)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    vgg_apply = losses.perceptual_features(judge32)
    adv = fit_restorer(dev, pairs,
                       (tr_idx[:ADVANCED_STEPS * RESTORER_BATCH], va_idx),
                       vgg_apply=vgg_apply, seed=9)
    for name, (st, rec, peak) in (("bf16", bf16), ("fp32 TF32", tf32),
                                  ("advanced", adv)):
        train[name] = dict(images_per_sec=rec["images_per_sec"],
                           seconds=rec["train_seconds"], steps=st.step,
                           last_loss=rec["step_loss"][-1],
                           val_loss=rec["val_loss"], peak_memory_gib=peak)
        print(f"restorer {name} (noise pairs): {rec['images_per_sec']:.1f} "
              f"images/s over the last epoch's {len(rec['step_loss'])} "
              f"steps, last loss {rec['step_loss'][-1]:.5f}, peak "
              f"{peak:.3f} GiB")
    del bf16, tf32, adv
    # where the device time of one specialized train step goes (diagnostic)
    torch.manual_seed(SEED + 21)
    st = common.create_restoration_state(zoo.build_simple_unet(device=dev),
                                         configs.RestorationTrainConfig())
    xb, yb = (torch.from_numpy(a[:RESTORER_BATCH]).to(dev) for a in pairs)
    step = common.make_restoration_train_step("mse")
    breakdowns = {"restorer train step (batch 32, fp32)": device_breakdown(
        lambda: step(st, xb, yb))}
    del st, xb, yb, pairs
    check(train["advanced"]["steps"] == ADVANCED_STEPS, "advanced steps")

    # -- load the checkpoints, label the variant --------------------------
    restorers, cfgs = {}, {}
    for task in RESTORER_TASKS:
        path = str(work / "ckpt" / task)
        restorers[task] = zoo.load_model("simple_unet", path, device=dev)
        cfgs[task] = zoo.checkpoint_config(path)
    check(restorers["fog"].input_minmax and not restorers["noise"]
          .input_minmax, "input_minmax from config.json")
    variant = pipeline.cascade_variant(cfgs)
    print(f"cascade variant {variant[0]}: {variant[1]}")

    # -- the cascade: a batch at 224, then script 13's native-size flow ---
    folder = gtsrb.ImageFolder(str(clean_dir), size=SIZE)
    batch = folder.load_batch(range(CASCADE_BATCH))[0]
    files = sorted(offline.tree_files(str(clean_dir)))
    picks = random.Random(SEED).sample(files, CASCADE_NATIVE)
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launch_counts()
    pipeline.cascade_stress(batch, restorers, judge32, g, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipeline.cascade_stress(batch, restorers, judge32, g, device=dev)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    peak_batch = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    stages, shapes = native_stages(dev, picks, g)
    torch.cuda.synchronize()
    stages_s = time.perf_counter() - t0
    out_native = pipeline.cascade_stress(stages[0][1], restorers, judge32,
                                         precomputed_stages=stages,
                                         device=dev)
    torch.cuda.synchronize()
    native_s = time.perf_counter() - t0
    peak_native = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    counts = _build.launch_counts()
    check(counts == {"fog_noise": 0, "blur_sparse": 0,
                     "blur_dense": 2 + CASCADE_NATIVE},
          f"cascade launched {counts}, expected B3 once a batched cascade "
          f"and once a native image")
    for name, res, n in (("batched", out, CASCADE_BATCH),
                         ("native", out_native, CASCADE_NATIVE)):
        names = [s for s, _ in res["stages"]]
        check(len(names) == 7 and all(
            img.shape == (n, SIZE, SIZE, 3) for _, img in res["stages"]),
            f"{name} cascade stages")
        check([img.dtype for _, img in res["stages"]]
              == [np.uint8] * 4 + [np.float32] * 3,
              f"{name} cascade stage dtypes")
        check(all(np.isfinite(c).all() for c in res["confidences"]),
              f"{name} cascade confidences finite")
    print(f"cascade batched ({CASCADE_BATCH} at {SIZE}, fp32): "
          f"{CASCADE_BATCH / batch_s:.1f} images/s ({batch_s:.3f} s), peak "
          f"{peak_batch:.3f} GiB; mean confidence "
          + json.dumps(out["mean_confidence"]))
    print(f"cascade native ({CASCADE_NATIVE} images distorted at native "
          f"sizes {shapes}, resized on the card): {native_s:.3f} s "
          f"({stages_s:.3f} s of it decode, distort and resize), peak "
          f"{peak_native:.3f} GiB; mean confidence "
          + json.dumps(out_native["mean_confidence"]))

    # -- B3 at K=5, at every shape the phase ran --------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    k5_shapes = [(CASCADE_BATCH, SIZE, SIZE, 3)] + [
        (1, h, w, 3) for h, w in shapes]
    times, err = check_b3_k5(dev, k5_shapes, gen)
    rows[2]["max_abs_err"] = max(rows[2]["max_abs_err"], err)
    rows[2]["cascade_times"] = times
    rows[2]["cascade_shapes"] = [f"{b}x{h}x{w}x{c}"
                                 for b, h, w, c in k5_shapes]
    breakdowns[f"batched cascade ({CASCADE_BATCH} at {SIZE}, fp32)"] = \
        device_breakdown(lambda: pipeline.cascade_stress(
            batch, restorers, judge32, g, device=dev))
    profiles = {}
    for label, breakdown in breakdowns.items():
        if breakdown is None:
            continue
        prof_rows, busy, n_kernels, wall, all_rows = breakdown
        profiles[label] = dict(busy_ms=busy, wall_ms=wall,
                               kernels=n_kernels)
        print(f"profile of one {label}: device busy {busy:.3f} ms over "
              f"{wall:.3f} ms wall; {n_kernels} device kernels")
        print("  by kind (approximate, by kernel name): "
              + kinds_line(all_rows, busy))
        for kname, ms, n in prof_rows[:8]:
            print(f"  {ms:8.3f} ms {n:4d}x  {kname[:110]}")
    reference = small_cascade_check(dev)
    flops = model_flops()
    print("forward FLOPs of one image: " + json.dumps(flops))

    summary = {
        "path": "PairedFolder -> train_restorer_on_device (noise, blur, "
                "fog; bf16; TF32; advanced) -> checkpoints -> "
                "zoo.load_model -> cascade_stress (batched, native)",
        "size": SIZE, "batch": RESTORER_BATCH, "epochs": RESTORER_EPOCHS,
        "train": train, "variant": variant[0],
        "cascade_batch": CASCADE_BATCH,
        "cascade_batched_images_per_sec": CASCADE_BATCH / batch_s,
        "cascade_batched_seconds": batch_s,
        "cascade_batched_peak_memory_gib": peak_batch,
        "cascade_native_images": CASCADE_NATIVE,
        "cascade_native_seconds": native_s,
        "cascade_native_stages_seconds": stages_s,
        "cascade_native_peak_memory_gib": peak_native,
        "native_shapes": shapes,
        "mean_confidence_batched": out["mean_confidence"],
        "mean_confidence_native": out_native["mean_confidence"],
        "launches": counts, "card_vs_cpu": reference, "profiles": profiles,
        "forward_flops_per_image": flops}
    print("cascade: " + json.dumps(summary))
    return counts


def small_judge_check(dev):
    """One judge train step on CUDA vs the CPU's plain path: fp32, TF32
    off, a narrow batch-norm judge at 8x32x32 with dropout off, copied to
    both. The loss within 1e-5 relative, the gradients as ``_grads_close``
    holds them at 1e-4 and the running statistics within 1e-5 of the
    layer's largest (and at least 1)."""
    import torch
    from tsr_tpu_torch.models import VGG16
    from tsr_tpu_torch.train import common

    class Capture(torch.optim.SGD):
        """Leaves the parameters as they are; keeps the step's gradients."""

        def __init__(self, params):
            super().__init__(params, lr=0.0)
            self.grads = None

        def step(self, closure=None):
            self.grads = [p.grad.clone() for g in self.param_groups
                          for p in g["params"]]

    torch.manual_seed(SEED + 30)
    cpu = VGG16(num_classes=5, cfg=(16, "M", 32, "M"), fc_width=32,
                input_size=32, use_batchnorm=True, dropout_rate=0.0)
    gpu = copy.deepcopy(cpu).to(dev)
    g = torch.Generator().manual_seed(SEED + 31)
    images = torch.randint(0, 256, (8, 32, 32, 3), dtype=torch.uint8,
                           generator=g)
    labels = torch.randint(0, 5, (8,), generator=g)
    step = common.make_judge_train_step()
    out = {}
    for name, model, d in (("cpu", cpu, torch.device("cpu")),
                           ("gpu", gpu, dev)):
        opt = Capture(model.parameters())
        state = common.TrainState(model, opt, torch.optim.lr_scheduler.
                                  LambdaLR(opt, lambda c: 1.0))
        out[name] = step(state, images.to(d), labels.to(d))["loss"].item()
        for p, grad in zip(model.parameters(), opt.grads):
            p.grad = grad
    rel = abs(out["gpu"] - out["cpu"]) / abs(out["cpu"])
    check(rel <= 1e-5, f"judge step loss differs by {rel} relative")
    worst = _grads_close("judge step CUDA vs CPU", gpu, cpu, 1e-4)
    stats = 0.0
    for (n, a), (_, b) in zip(cpu.named_buffers(), gpu.named_buffers()):
        if n.endswith(("running_mean", "running_var")):
            err = (b.cpu() - a).abs().max().item()
            check(err <= 1e-5 * max(1.0, a.abs().max().item()),
                  f"judge step {n} differs by {err}")
            stats = max(stats, err)
    print(f"judge-step reference check (fp32, TF32 off, bn judge, 8x32x32): "
          f"loss {out['gpu']:.6g} vs {out['cpu']:.6g} ({rel:.3g} relative, "
          f"tol 1e-5), worst gradient {worst:.3g} of its tensor's largest "
          f"(tol 1e-4), running stats max diff {stats:.3g} (tol 1e-5)")
    return dict(loss_rel=rel, worst_grad=worst, stats_max_diff=stats)


def fit_judge(dev, folder_arrays, splits, cfg, dtype, use_batchnorm=False,
              ckpt=None, seed=0):
    """A VGG16-D judge from a seed trained by ``train_judge_on_device``
    with ``cfg`` (checkpointed to ``ckpt`` with script 05's config when
    given). Checks finite losses, the step count, that every parameter got
    a nonzero gradient into its optimizer state and, under AdamW, moved
    (SGD at 1e-3 may move a parameter by less than its float32 spacing);
    a conv bias that feeds a batch norm, whose gradient is exactly 0, is
    left out. Returns (state, best_acc, record): the
    trainer's log lines, each epoch's images/s from its log line and from
    a synchronised window between log lines (the epoch's steps and
    validation: the trainer reads its metrics back at the end of each
    epoch), the losses and the peak memory."""
    import re

    import torch
    from tsr_tpu_torch import zoo
    from tsr_tpu_torch.train import common, loops
    images, labels = folder_arrays
    tr_idx, va_idx = splits
    torch.manual_seed(SEED + seed)
    judge = zoo.build_judge(TREE_CLASSES, use_batchnorm, dtype, SIZE,
                            device=dev)
    state = common.create_judge_state(judge, cfg)
    before = {k: v.clone() for k, v in judge.state_dict().items()
              if v.is_floating_point()}
    stamps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    stamps.append((time.perf_counter(), "start"))
    state, best = loops.train_judge_on_device(
        state, images, labels, tr_idx, va_idx, cfg,
        save_path=None if ckpt is None else str(ckpt),
        log=lambda line: stamps.append((time.perf_counter(), line)),
        ckpt_config={"kind": "vgg16", "num_classes": TREE_CLASSES,
                     "use_batchnorm": use_batchnorm}, device=dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    lines = [line for _, line in stamps[1:]]
    steps = len(tr_idx) // cfg.batch_size
    epoch_at = [i for i, (_, line) in enumerate(stamps)
                if line.startswith("Epoch ")]
    window = [steps * cfg.batch_size / (stamps[i][0] - stamps[i - 1][0])
              for i in epoch_at]
    logged = [float(re.search(r"\(([\d.]+) img/s\)", stamps[i][1]).group(1))
              for i in epoch_at]
    losses_ = [float(re.search(r"train loss (\S+)", stamps[i][1]).group(1))
               for i in epoch_at]
    best_epoch = max((k + 1 for k, i in enumerate(epoch_at)
                      if i + 2 < len(stamps)
                      and "new best" in stamps[i + 2][1]), default=0)
    check(len(losses_) == cfg.epochs and all(map(math.isfinite, losses_)),
          f"finite judge losses {losses_}")
    check(state.step == cfg.epochs * steps, f"judge took {state.step} steps")
    from tsr_tpu_torch.models.layers import batchnorm_fed_biases
    fed = batchnorm_fed_biases(state.model)
    after = state.model.state_dict()
    still = [k for k, v in before.items()
             if k not in fed and torch.equal(v, after[k])]
    moment = "exp_avg_sq" if cfg.optimizer == "adamw" else "momentum_buffer"
    unreached = [n for n, p in state.model.named_parameters() if n not in fed
                 and not state.optimizer.state[p][moment].any().item()]
    check(not unreached, f"judge parameters with no gradient: {unreached}")
    check(not still or cfg.optimizer != "adamw",
          f"judge parameters that did not move: {still}")
    check(0.0 <= best <= 1.0, f"best val acc {best}")
    return state, best, dict(unmoved=still,
        log=lines, images_per_sec_logged=logged,
        images_per_sec_window=window, train_loss=losses_, best_acc=best,
        best_epoch=best_epoch, steps=state.step, peak_memory_gib=peak)


def train_step_window(dev, state, images, labels, steps):
    """bench.py's judge number: images/s of ``steps`` judge train steps on
    batches already on the card (one warm-up step, then a window closed by
    a CUDA synchronise)."""
    import torch
    from tsr_tpu_torch.train import common
    bs = JUDGE_BATCH
    idx = torch.arange(bs * (steps + 1)) % len(images)
    x = torch.from_numpy(images)[idx].to(dev)
    y = torch.from_numpy(labels.astype("int64"))[idx].to(dev)
    step = common.make_judge_train_step()
    step(state, x[:bs], y[:bs])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = [step(state, x[bs * (k + 1):bs * (k + 2)],
                y[bs * (k + 1):bs * (k + 2)]) for k in range(steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(all(math.isfinite(m["loss"].item()) for m in out),
          "finite train-step losses")
    return steps * bs / dt


def profile_judge_step(label, state, images, labels):
    """Device time by kind of kernel over one judge train step on a batch
    already on the card (diagnostic only); None where the profiler cannot
    run."""
    import torch
    from tsr_tpu_torch.train import common
    dev = next(state.model.parameters()).device
    x = torch.from_numpy(images[:JUDGE_BATCH]).to(dev)
    y = torch.from_numpy(labels[:JUDGE_BATCH].astype("int64")).to(dev)
    step = common.make_judge_train_step()
    breakdown = device_breakdown(lambda: step(state, x, y))
    if breakdown is None:
        return None
    prof_rows, busy, n_kernels, wall, all_rows = breakdown
    print(f"profile of one {label}: device busy {busy:.3f} ms over "
          f"{wall:.3f} ms wall; {n_kernels} device kernels")
    print("  by kind (approximate, by kernel name): "
          + kinds_line(all_rows, busy))
    for kname, ms, n in prof_rows[:8]:
        print(f"  {ms:8.3f} ms {n:4d}x  {kname[:110]}")
    return dict(busy_ms=busy, wall_ms=wall, kernels=n_kernels)


def judge_phase(dev, work):
    """Phase 7: script 05 (the judge's trainers), 11 (hidden-state
    heatmaps) and 12 (GAP -> UMAP -> ``umap_embeddings.pt``) on the trees
    phase's clean tree and its noise / blur / fog trees, with the cascade
    phase's three restorer checkpoints, in ``work``. Returns the kernels'
    launches over the phase (none of its modules runs a TPU kernel)."""
    import random
    import re

    import numpy as np
    import torch
    from tsr_tpu_torch import configs, infer, interpret, zoo
    from tsr_tpu_torch.data import gtsrb
    from tsr_tpu_torch.kernels import _build
    from tsr_tpu_torch.models.vgg import GAP_TAP, HIDDEN_STATE_TAP
    from tsr_tpu_torch.train import common, loops
    quiet = lambda line: None  # noqa: E731
    clean_dir = work / "clean"
    for task in RESTORER_TASKS:
        check((work / "ckpt" / task / "model").exists(),
              f"the cascade phase's {task} restorer checkpoint")
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t_phase = time.perf_counter()

    # -- script 05: the device-resident trainer, three recipes -------------
    t0 = time.perf_counter()
    folder = gtsrb.ImageFolder(str(clean_dir), size=SIZE)
    arrays = folder.load_batch(range(len(folder)))
    load_s = time.perf_counter() - t0
    check(len(folder) == TREE_IMAGES
          and len(folder.classes) == TREE_CLASSES, "the clean tree")
    adamw = configs.JudgeTrainConfig(
        optimizer="adamw", learning_rate=JUDGE_LR, batch_size=JUDGE_BATCH,
        epochs=JUDGE_EPOCHS)
    splits = gtsrb.train_val_split(len(folder), adamw.train_split,
                                   adamw.seed)
    ckpt = work / "ckpt" / "judge"
    runs = {}
    bf16_state, _, runs["bf16 AdamW"] = fit_judge(
        dev, arrays, splits, adamw, "bf16", ckpt=ckpt)
    for line in runs["bf16 AdamW"]["log"]:
        print(f"  judge (bf16, AdamW {JUDGE_LR:g}, batch {JUDGE_BATCH}): "
              + line)
    step_ips = train_step_window(dev, bf16_state, *arrays,
                                 JUDGE_WINDOW_STEPS)
    profiles = {"bf16 AdamW": profile_judge_step(
        f"judge train step (bf16 AdamW, batch {JUDGE_BATCH})", bf16_state,
        *arrays)}
    del bf16_state
    sgd = configs.JudgeTrainConfig(batch_size=JUDGE_BATCH, epochs=1)
    _, _, runs["fp32 SGD"] = fit_judge(dev, arrays, splits, sgd, "fp32",
                                       seed=1)
    bn_state, _, runs["bf16 AdamW bn"] = fit_judge(
        dev, arrays, splits, dataclasses.replace(adamw, epochs=1), "bf16",
        use_batchnorm=True, seed=2)
    profiles["bf16 AdamW bn"] = profile_judge_step(
        f"batch-norm judge train step (bf16 AdamW, batch {JUDGE_BATCH})",
        bn_state, *arrays)
    del bn_state
    for name, rec in runs.items():
        print(f"judge {name}: images/s by epoch {rec['images_per_sec_window']}"
              f" (window between log lines; logged "
              f"{rec['images_per_sec_logged']}), losses {rec['train_loss']},"
              f" best val acc {rec['best_acc']:.4f}, {rec['steps']} steps, "
              f"peak {rec['peak_memory_gib']:.3f} GiB")
    print(f"judge train steps (bf16 AdamW, batch {JUDGE_BATCH}, "
          f"{JUDGE_WINDOW_STEPS}-step window, bench.py's measure): "
          f"{step_ips:.1f} images/s")

    # -- script 05 --host-stream: train_judge on data.gtsrb.batches --------
    torch.manual_seed(SEED + 3)
    judge = zoo.build_judge(TREE_CLASSES, False, "bf16", SIZE, device=dev)
    stream_cfg = dataclasses.replace(adamw, epochs=1)
    tr_idx, va_idx = splits
    lines = []
    t0 = time.perf_counter()
    streamed, stream_best = loops.train_judge(
        common.create_judge_state(judge, stream_cfg),
        lambda ep: gtsrb.batches(folder, tr_idx, JUDGE_BATCH,
                                 seed=stream_cfg.seed + ep),
        lambda: gtsrb.batches(folder, va_idx, JUDGE_BATCH, shuffle=False,
                              drop_remainder=False),
        stream_cfg, log=lines.append, device=dev)
    stream_s = time.perf_counter() - t0
    stream_ips = float(re.search(r"\(([\d.]+) img/s\)", lines[0]).group(1))
    stream_loss = float(re.search(r"train loss (\S+)", lines[0]).group(1))
    check(streamed.step == len(tr_idx) // JUDGE_BATCH and stream_best == 0.0
          and math.isfinite(stream_loss), "host-streamed judge epoch")
    print(f"judge host-streamed (train_judge, bf16 AdamW, decode on the "
          f"host per batch): {' | '.join(lines)}; {stream_s:.2f} s in all")
    del streamed, judge

    # -- resume and reload -------------------------------------------------
    saved = torch.load(ckpt / "train", weights_only=True)["step"]
    rec = runs["bf16 AdamW"]
    steps = len(tr_idx) // JUDGE_BATCH
    check(saved == rec["best_epoch"] * steps,
          f"checkpoint at step {saved}, best epoch {rec['best_epoch']}")
    torch.manual_seed(SEED + 4)
    resumed = zoo.load_train_state(str(ckpt), common.create_judge_state(
        zoo.build_judge(TREE_CLASSES, False, "bf16", SIZE, device=dev),
        adamw))
    check(resumed.step == saved, f"resumed at {resumed.step}, saved {saved}")
    resumed, _ = loops.train_judge_on_device(
        resumed, *arrays, tr_idx[:RESUME_STEPS * JUDGE_BATCH], va_idx,
        dataclasses.replace(adamw, epochs=1), log=quiet, device=dev)
    check(resumed.step == saved + RESUME_STEPS,
          f"resume continued to step {resumed.step}")
    del resumed
    judge32 = zoo.load_model("vgg16", str(ckpt), size=SIZE, device=dev)
    model_file = torch.load(ckpt / "model", weights_only=True)
    check(judge32.dtype == torch.float32 and not judge32.training
          and not judge32.use_batchnorm and all(
              torch.equal(v.cpu(), model_file[k])
              for k, v in judge32.state_dict().items()),
          "zoo.load_model of the best judge checkpoint")
    print(f"judge resume: zoo.load_train_state at step {saved} (best epoch "
          f"{rec['best_epoch']}), {RESUME_STEPS} more steps -> step "
          f"{saved + RESUME_STEPS}; zoo.load_model: fp32 VGG16-D, "
          f"{TREE_CLASSES} classes, config "
          + json.dumps(zoo.checkpoint_config(str(ckpt))))
    reference = small_judge_check(dev)

    # -- script 08 on the sampled files, then script 11 --------------------
    files = sorted(f for f in clean_dir.glob("*/*")
                   if f.suffix.lower() in gtsrb.IMG_EXTENSIONS)
    random.seed(42)  # scripts/12_generate_umap_pt.py:51-53
    picks = random.sample(files, UMAP_SAMPLES)
    sample = files[0]  # script 11's default sample
    rels = sorted({p.relative_to(clean_dir) for p in picks + [sample]})

    def twin(root, rel):
        path = root / rel
        return path if path.exists() else path.with_suffix(".png")

    restore = {}
    for task in RESTORER_TASKS:
        subset = work / "sampled" / task
        for rel in rels:
            src = twin(work / task, rel)
            dst = subset / rel.parent / src.name
            dst.parent.mkdir(parents=True, exist_ok=True)
            dst.write_bytes(src.read_bytes())
        restorer = zoo.load_model("simple_unet", str(work / "ckpt" / task),
                                  device=dev)
        res = infer.restore_tree(restorer, str(subset),
                                 str(work / "restored" / task),
                                 str(clean_dir), batch_size=JUDGE_BATCH,
                                 log=quiet, device=dev)
        check(res["images"] == len(rels), f"{task}: restored {res['images']}")
        restore[task] = dict(images_per_sec=res["images_per_sec"],
                             psnr=res["psnr"], ssim=res["ssim"])
        del restorer

    tap_layer = judge32.tap_index(HIDDEN_STATE_TAP)
    tap = interpret.make_tap_fn(judge32, tap_layer)
    judge_cpu = zoo.load_model("vgg16", str(ckpt), size=SIZE, device="cpu")
    tap_cpu = interpret.make_tap_fn(judge_cpu, tap_layer)
    rel = sample.relative_to(clean_dir)
    hm_diff, heat = 0.0, {}
    for task in RESTORER_TASKS:
        imgs = gtsrb._decode_resize_batch(
            [str(sample), str(twin(work / task, rel)),
             str((work / "restored" / task / rel).with_suffix(".png"))],
            SIZE)
        feats = tap(imgs)
        hms = interpret.heatmap(feats)
        check(tuple(feats.shape) == (3, 64, SIZE, SIZE)
              and hms.shape == (3, SIZE, SIZE) and np.isfinite(hms).all()
              and hms.min() >= 0.0 and hms.max() <= 1.0,
              f"{task} heatmaps {hms.shape}")
        diff = float(np.abs(hms - interpret.heatmap(tap_cpu(imgs))).max())
        check(diff <= 1e-4, f"{task} heatmaps card vs CPU differ by {diff}")
        hm_diff = max(hm_diff, diff)
        heat[task] = [float(h.mean()) for h in hms]
    del judge_cpu, tap_cpu
    print(f"script 11 (tap {HIDDEN_STATE_TAP}, fp32 judge from the "
          f"checkpoint): {{clean, distorted, restored}} heatmaps [3, {SIZE},"
          f" {SIZE}] in [0, 1] for {rel}, card vs CPU max diff {hm_diff:.3g} "
          f"(tol 1e-4); restore_tree on the {len(rels)} sampled files "
          + json.dumps(restore))

    # -- script 12: GAP features of 7 modes -> UMAP -> umap_embeddings.pt --
    modes = {"Clean": clean_dir}
    for task in RESTORER_TASKS:
        name = task.capitalize()
        modes[f"{name} (Bad)"] = work / task
        modes[f"{name} (Restored)"] = work / "restored" / task
    t0 = time.perf_counter()
    mode_batches = {
        mode: gtsrb._decode_resize_batch(
            [str(twin(root, p.relative_to(clean_dir))) for p in picks], SIZE)
        for mode, root in modes.items()}
    decode_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = interpret.collect_mode_embeddings(
        judge32, mode_batches, tap_layer=judge32.tap_index(GAP_TAP))
    gap_s = time.perf_counter() - t0
    all_feats = np.concatenate([feats[m] for m in mode_batches])
    all_labels = sum(([m] * len(feats[m]) for m in mode_batches), [])
    check(all_feats.shape == (7 * UMAP_SAMPLES, 512)
          and np.isfinite(all_feats).all(), f"GAP features {all_feats.shape}")
    t0 = time.perf_counter()
    emb = interpret.project_2d(all_feats, method="umap", seed=42)
    umap_s = time.perf_counter() - t0
    out_pt = work / "umap_embeddings.pt"
    interpret.export_embeddings_pt(str(out_pt), emb, all_labels, all_feats)
    back = torch.load(out_pt, weights_only=False)
    check(list(back) == ["embeddings", "labels", "original_features"]
          and back["embeddings"].dtype == torch.float32
          and tuple(back["embeddings"].shape) == (7 * UMAP_SAMPLES, 2)
          and back["original_features"].dtype == torch.float32
          and tuple(back["original_features"].shape)
          == (7 * UMAP_SAMPLES, 512)
          and back["labels"] == all_labels
          and torch.isfinite(back["embeddings"]).all().item(),
          "umap_embeddings.pt has the fixture's schema")
    gap_ips = 7 * UMAP_SAMPLES / gap_s
    print(f"script 12: {len(modes)} modes x {UMAP_SAMPLES} files decoded in "
          f"{decode_s:.2f} s; GAP features (fp32 judge, TF32 off) "
          f"{gap_ips:.1f} images/s; UMAP of {all_feats.shape} "
          f"{umap_s:.2f} s; umap_embeddings.pt reloaded with the fixture's "
          f"keys, dtypes and shapes")
    torch.cuda.synchronize()
    phase_s = time.perf_counter() - t_phase
    counts = _build.launch_counts()
    check(not any(counts.values()),
          f"phase 7 launched {counts}: none of its modules has a TPU kernel")

    print("judge: " + json.dumps({
        "path": "ImageFolder.load_batch -> train_judge_on_device (bf16 "
                "AdamW, fp32 SGD, bf16 AdamW bn) | train_judge on "
                "data.gtsrb.batches -> zoo checkpoint -> load_train_state, "
                "load_model",
        "size": SIZE, "batch": JUDGE_BATCH, "images": TREE_IMAGES,
        "classes": TREE_CLASSES, "train": len(tr_idx), "val": len(va_idx),
        "decode_seconds": load_s, "runs": {
            k: {kk: vv for kk, vv in v.items() if kk != "log"}
            for k, v in runs.items()},
        "train_step_images_per_sec": step_ips,
        "train_step_window_steps": JUDGE_WINDOW_STEPS,
        "host_streamed_images_per_sec": stream_ips,
        "host_streamed_seconds": stream_s,
        "resume": {"saved_step": saved, "resumed_to": saved + RESUME_STEPS},
        "card_vs_cpu": reference, "profiles": profiles}))
    print("interpret: " + json.dumps({
        "path": "restore_tree (sampled files) -> make_tap_fn -> heatmap | "
                "collect_mode_embeddings -> project_2d(umap) -> "
                "export_embeddings_pt",
        "hidden_state_tap": HIDDEN_STATE_TAP, "heatmap_means": heat,
        "heatmap_card_vs_cpu_max_diff": hm_diff, "restore": restore,
        "modes": len(modes), "samples_per_mode": UMAP_SAMPLES,
        "decode_seconds": decode_s, "gap_images_per_sec": gap_ips,
        "gap_seconds": gap_s, "umap_seconds": umap_s,
        "phase_seconds": phase_s, "launches": counts}))
    return counts


class _CleanOnly:
    """An ``ImageFolder`` whose batches are 1-tuples ``(images,)``: the
    clean batches of script 14's host-streamed loop."""

    def __init__(self, folder):
        self.folder = folder

    def __len__(self):
        return len(self.folder)

    def load_batch(self, indices):
        return (self.folder.load_batch(indices)[0],)


def bf16_ulp(t):
    """One bf16 ulp at ``t``'s largest magnitude."""
    top = float(t.abs().max())
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def int8_card_vs_cpu(dev):
    """The int8 ResUNet and judge quantized and run on the card and on the
    CPU: narrow (the CPU tests' sizes, 4 images at 32) and full width (2
    images at SIZE). Restorer outputs and logits must agree within one
    bf16 ulp of their tensor's largest value, preds exactly. Returns the
    measured differences."""
    import torch
    from tsr_tpu_torch import quant
    from tsr_tpu_torch.models import ResUNet, VGG16
    from tsr_tpu_torch.ops import image as image_ops
    out = {}
    for name, widths, judge_arch, n, size in (
            ("narrow", ((8, 16, 24), 32), dict(cfg=(8, "M", 16, "M"),
                                               fc_width=32), 4, 32),
            ("full", ((64, 128, 256), 512), {}, 2, SIZE)):
        torch.manual_seed(SEED + 30)
        r_cpu = ResUNet(*widths).eval()
        j_cpu = VGG16(num_classes=43, input_size=size, **judge_arch).eval()
        x = torch.rand(n, 3, size, size,
                       generator=torch.Generator().manual_seed(SEED + 31))
        xn = image_ops.imagenet_normalize(x.permute(0, 2, 3, 1)).permute(
            0, 3, 1, 2)
        with torch.inference_mode():
            rc = quant.quantized_restorer(r_cpu)(x)
            lc = quant.quantized_judge(j_cpu)(xn)
            rg = quant.quantized_restorer(copy.deepcopy(r_cpu).to(dev))(
                x.to(dev)).cpu()
            lg = quant.quantized_judge(copy.deepcopy(j_cpu).to(dev))(
                xn.to(dev)).cpu()
        check(rg.dtype == rc.dtype == torch.bfloat16
              and lg.dtype == lc.dtype == torch.float32,
              "int8 restorer bf16 and logits float32")
        dr = float((rg.float() - rc.float()).abs().max())
        dl = float((lg - lc).abs().max())
        check(dr <= bf16_ulp(rc) and dl <= bf16_ulp(lc),
              f"int8 {name} card vs CPU: restorer {dr} (ulp "
              f"{bf16_ulp(rc)}), logits {dl} (ulp {bf16_ulp(lc)})")
        check(torch.equal(lg.argmax(-1), lc.argmax(-1)),
              f"int8 {name} preds card vs CPU")
        out[name] = {"restorer_max_diff": dr, "restorer_ulp": bf16_ulp(rc),
                     "logits_max_diff": dl, "logits_ulp": bf16_ulp(lc),
                     "images": n, "size": size}
    return out


# each kind of the int8 forwards' device work and the quant helpers that
# do it (their ranges are recorded only while int8_breakdown profiles)
INT8_KINDS = (("_int_mm", ("_int8_product",)),
              ("im2col and padding copies", ("_columns", "_pad_hw",
                                             "_pad_operand")),
              ("activation quantizer", ("quantize_act",)),
              ("dequantize, activation, bf16 store", ("_dequantize",
                                                      "_prelu",
                                                      "_residual")),
              ("pooling", ("_maxpool2",)))


def int8_breakdown(fn):
    """Device time of one call of ``fn`` by kind of int8 work: each helper
    of INT8_KINDS is wrapped in a ``record_function`` range for the
    profiled calls only, and a range's device time (its kernels and its
    children's) goes to its kind, nested ranges counted once; the rest of
    the busy time is "other" (the concats, the pixel shuffle, the fused
    step's own work). Returns ({kind: ms}, busy_ms, wall_ms, kernels) or
    None if the profiler cannot start or be read."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from tsr_tpu_torch import quant
    kind_of = {n: k for k, names in INT8_KINDS for n in names}
    originals = {n: getattr(quant, n) for n in kind_of}

    def ranged(name, f):
        def inner(*args, **kwargs):
            with record_function(f"int8::{name}"):
                return f(*args, **kwargs)
        return inner

    for n, f in originals.items():
        setattr(quant, n, ranged(n, f))
    try:
        fn()
        torch.cuda.synchronize()
        try:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
        except Exception as e:
            print(f"profiler unavailable: {type(e).__name__}: {e}")
            return None
        try:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        except BaseException:
            with contextlib.suppress(Exception):
                prof.stop()
            raise
        try:
            prof.stop()
            events = list(prof.events())
        except Exception as e:
            print(f"profiler unreadable: {type(e).__name__}: {e}")
            return None
    finally:
        for n, f in originals.items():
            setattr(quant, n, f)

    def outermost(e):
        p = e.cpu_parent
        while p is not None:
            if p.name.startswith("int8::"):
                return False
            p = p.cpu_parent
        return True

    def kernel_us(e):
        """The device time of the kernels launched inside CPU event ``e``
        (the ranges' own device-side spans left out)."""
        return (sum(k.duration for k in e.kernels
                    if not k.name.startswith("int8::"))
                + sum(kernel_us(c) for c in e.cpu_children))

    ms = {k: 0.0 for k, _ in INT8_KINDS}
    for e in events:
        if (e.device_type == torch.autograd.DeviceType.CPU
                and e.name.startswith("int8::") and outermost(e)):
            ms[kind_of[e.name[6:]]] += kernel_us(e) / 1e3
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.time_range.end - e.time_range.start for e in kernels) / 1e3
    ms["other"] = busy - sum(ms.values())
    return ms, busy, wall_ms, len(kernels)


def int8_phase(dev, resunet, judge, work):
    """Phase 8: int8 serving (``quant.quantized_restorer`` /
    ``quantized_judge`` in ``eval.make_fused_eval_step``) against the bf16
    step at full width, then the host-streamed trainers and the unified
    trainer's checkpoints, on the trees phase's clean and noise trees in
    ``work``. ``resunet`` and ``judge`` are phase 3's bf16 models. Returns
    the kernels' launches over the phase (B1/B2 in the mix batch and the
    unified trainers)."""
    import numpy as np
    import torch
    from tsr_tpu_torch import configs, losses, quant, zoo
    from tsr_tpu_torch import eval as teval
    from tsr_tpu_torch.data import gtsrb
    from tsr_tpu_torch.kernels import _build
    from tsr_tpu_torch.models import ResUNet
    from tsr_tpu_torch.ops import distortions
    from tsr_tpu_torch.ops import image as image_ops
    from tsr_tpu_torch.train import common, loops
    clean_dir = work / "clean"
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t_phase = time.perf_counter()
    result = {"card": card_line()}

    # -- 1. the int8 forwards on the card against the CPU ------------------
    result["card_vs_cpu"] = int8_card_vs_cpu(dev)
    print("int8 card vs CPU (tol one bf16 ulp of the largest value): "
          + json.dumps(result["card_vs_cpu"]))

    # -- 2. int8 against bf16 at full width on one random-mix batch --------
    g = torch.Generator(device=dev).manual_seed(SEED + 32)
    clean = torch.randint(0, 256, (INT8_BATCH, SIZE, SIZE, 3),
                          dtype=torch.uint8, device=dev, generator=g)
    label = torch.randint(0, configs.NUM_CLASSES, (INT8_BATCH,), device=dev,
                          generator=g)
    bad = distortions.apply_random_distortions(clean, g, device=dev)
    t0 = time.perf_counter()
    q_res = quant.quantized_restorer(resunet)
    q_judge = quant.quantized_judge(judge)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    step8 = teval.make_fused_eval_step(q_res, q_judge, device=dev)
    step16 = teval.make_fused_eval_step(resunet, judge, device=dev)
    with torch.device(dev):
        resunet32 = ResUNet(resunet.widths, 512)
    resunet32.load_state_dict(resunet.state_dict())
    resunet32.eval()
    with torch.inference_mode():
        o8, o16 = step8(bad, label), step16(bad, label)
        x01 = image_ops.to_float01(bad)
        nchw = x01.permute(0, 3, 1, 2)
        raw8, raw16 = q_res(nchw).float(), resunet(nchw).float()
        raw32 = resunet32(nchw)
        l8 = q_judge(image_ops.imagenet_normalize(
            teval.restore_batch(q_res, x01)).permute(0, 3, 1, 2))
        l16 = judge(image_ops.imagenet_normalize(
            teval.restore_batch(resunet, x01)).permute(0, 3, 1, 2)).float()
    check(torch.isfinite(raw8).all().item() and torch.isfinite(l8).all()
          .item() and raw8.shape == raw32.shape
          and l8.shape == (INT8_BATCH, configs.NUM_CLASSES),
          "int8 restorer output and logits finite, of the bf16 shapes")
    check(torch.equal(o8["pred"], l8.argmax(-1)),
          "the int8 fused step's preds are its judge's argmax")

    def rel_err(ref, got):
        return float((got - ref).pow(2).mean().sqrt() / ref.std())

    corr = float(np.corrcoef(l8.double().cpu().numpy().ravel(),
                             l16.double().cpu().numpy().ravel())[0, 1])
    result["accuracy"] = {
        "logit_correlation_int8_vs_bf16": corr,
        "top1_agreement_int8_vs_bf16":
            (o8["pred"] == o16["pred"]).float().mean().item(),
        "restorer_rel_err_int8_vs_fp32": rel_err(raw32, raw8),
        "restorer_rel_err_bf16_vs_fp32": rel_err(raw32, raw16),
        "confidence_int8": o8["confidence"].mean().item(),
        "confidence_bf16": o16["confidence"].mean().item(),
        "quantize_seconds": quantize_s}
    print("int8 vs bf16 (random weights: reported, not gated): "
          + json.dumps(result["accuracy"]))
    del resunet32, raw8, raw16, raw32, l8, l16, x01, nchw

    # -- 3. throughput: batch 64 (CUDA events), then bench.py's shape ------
    flops = sum(model_flops()[k] for k in ("resunet", "vgg16"))
    ms8 = cuda_ms(lambda: step8(bad, label), iters=INT8_STEP_ITERS,
                  warmup=1)
    ms16 = cuda_ms(lambda: step16(bad, label), iters=INT8_STEP_ITERS,
                   warmup=1)
    # each input byte and each stored weight read once, the preds and
    # confidences written once; the operations at the int8 peak
    weight_bytes = sum(b.numel() * b.element_size() for m in (q_res, q_judge)
                       for b in m.buffers())
    bound8 = max(INT8_BATCH * flops / INT8_OPS_PER_S,
                 (INT8_BATCH * (SIZE * SIZE * 3 + 12) + weight_bytes)
                 / HBM_BYTES_PER_S) * 1e3
    result["batch64"] = {
        "int8_images_per_sec": INT8_BATCH / ms8 * 1e3, "int8_ms": ms8,
        "bf16_images_per_sec": INT8_BATCH / ms16 * 1e3, "bf16_ms": ms16,
        "flops_per_image": flops, "int8_bound_ms": bound8,
        "int8_share_of_bound": bound8 / ms8}
    chunks = [torch.randint(0, 256, (INT8_BENCH_BATCH, SIZE, SIZE, 3),
                            dtype=torch.uint8, device=dev, generator=g)
              for _ in range(INT8_BENCH_CHUNKS)]
    chunk_labels = torch.zeros(INT8_BENCH_BATCH, dtype=torch.int64,
                               device=dev)

    def bench(step):
        """bench.py's measure: the chunks back to back, a warm-up pass,
        then the best of INT8_BENCH_REPS synchronised passes."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for _ in range(1 + INT8_BENCH_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for c in chunks:
                step(c, chunk_labels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        n = INT8_BENCH_BATCH * INT8_BENCH_CHUNKS
        return {"images_per_sec": n / min(times[1:]),
                "seconds_each": times[1:],
                "peak_memory_gib": torch.cuda.max_memory_allocated(dev)
                / 2 ** 30}

    result["bench_shape"] = {"batch": INT8_BENCH_BATCH,
                             "chunks": INT8_BENCH_CHUNKS,
                             "int8": bench(step8), "bf16": bench(step16)}
    del chunks
    print("int8 throughput: " + json.dumps({
        k: result[k] for k in ("batch64", "bench_shape")}))
    breakdown = int8_breakdown(lambda: step8(bad, label))
    if breakdown is not None:
        kinds, busy, wall, n_kernels = breakdown
        result["breakdown_batch64"] = {"ms_by_kind": kinds, "busy_ms": busy,
                                       "wall_ms": wall,
                                       "kernels": n_kernels}
        print(f"profile of one int8 fused step (batch {INT8_BATCH}): device "
              f"busy {busy:.3f} ms over {wall:.3f} ms wall; {n_kernels} "
              "device kernels; by kind: " + "; ".join(
                  f"{k} {v:.3f} ms ({100 * v / max(busy, 1e-9):.1f} %)"
                  for k, v in sorted(kinds.items(), key=lambda r: -r[1])))

    # -- 4. the host-streamed trainers -------------------------------------
    quiet = lambda line: None  # noqa: E731
    rcfg = configs.RestorationTrainConfig()
    pairs = gtsrb.PairedFolder(str(clean_dir), str(work / "noise"),
                               size=SIZE)
    tr_idx, va_idx = gtsrb.train_val_split(len(pairs), rcfg.train_split,
                                           SEED)
    torch.manual_seed(SEED + 33)
    state = common.create_restoration_state(
        zoo.build_simple_unet(device=dev), rcfg)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    ckpt = work / "ckpt" / "noise_streamed"
    lines = []
    t0 = time.perf_counter()
    state, hist = loops.train_restorer(
        state, lambda ep: gtsrb.batches(pairs, tr_idx, rcfg.batch_size,
                                        seed=rcfg.seed + ep),
        lambda: gtsrb.batches(pairs, va_idx, rcfg.batch_size,
                              shuffle=False, drop_remainder=False),
        1, common.make_restoration_train_step("mse"),
        common.make_restoration_eval_step("mse"), save_path=str(ckpt),
        checkpoint_every=1, save_best=True, log=lines.append,
        ckpt_config={"identity_frac": 0.0}, device=dev)
    restorer_s = time.perf_counter() - t0
    rec = hist[-1]
    steps = len(tr_idx) // rcfg.batch_size
    check(state.step == steps and all(math.isfinite(v) for v in
                                      rec["step_loss"] + [rec["val_loss"]]),
          f"streamed restorer: {state.step} steps, finite losses")
    after = state.model.state_dict()
    check(all(not torch.equal(v, after[k]) for k, v in before.items()),
          "every streamed restorer parameter moved")
    check(torch.load(ckpt / "train", weights_only=True)["step"] == steps
          and any("saved best checkpoint" in ln for ln in lines),
          "streamed restorer wrote its best checkpoint last")
    result["train_restorer"] = {
        "images_per_sec": rec["images_per_sec"], "steps": state.step,
        "seconds": restorer_s, "first_loss": rec["step_loss"][0],
        "last_loss": rec["step_loss"][-1], "val_loss": rec["val_loss"],
        "log": lines}
    del state, before, after

    folder = gtsrb.ImageFolder(str(clean_dir), size=SIZE)
    clean_only = _CleanOnly(folder)
    ucfg = configs.UnifiedTrainConfig(epochs=1)
    utr, uva = gtsrb.train_val_split(len(folder), ucfg.train_split,
                                     ucfg.seed)
    usteps = len(utr) // ucfg.batch_size
    vgg_apply = losses.perceptual_features(judge)

    def unified_state(seed, steps_per_epoch):
        torch.manual_seed(SEED + seed)
        with torch.device(dev):
            model = ResUNet((64, 128, 256), 512, dtype="bf16")
        model = model.to(memory_format=torch.channels_last)
        return common.create_unified_state(model, ucfg, steps_per_epoch)

    state = unified_state(34, usteps)
    before = {k: v.clone() for k, v in state.model.state_dict().items()
              if not k.endswith("num_batches_tracked")}
    val_sizes = [len(uva[i:i + ucfg.batch_size])
                 for i in range(0, len(uva), ucfg.batch_size)]
    groups = sum(len(distortions.scale_groups(n, ucfg.mix.apply_scales))
                 for n in [ucfg.batch_size] * usteps + val_sizes)
    counts0 = _build.launch_counts()
    lines = []
    t0 = time.perf_counter()
    state, hist = loops.train_unified(
        state, lambda ep: gtsrb.batches(clean_only, utr, ucfg.batch_size,
                                        seed=ucfg.seed + ep),
        lambda: gtsrb.batches(clean_only, uva, ucfg.batch_size,
                              shuffle=False, drop_remainder=False),
        ucfg, vgg_apply, save_path=str(work / "ckpt" / "unified_streamed"),
        log=lines.append, ckpt_config={"kind": "resunet"}, device=dev)
    unified_s = time.perf_counter() - t0
    counts1 = _build.launch_counts()
    launched = {k: counts1[k] - counts0[k] for k in counts1}
    rec = hist[-1]
    check(state.step == usteps and all(math.isfinite(v) for v in
                                       rec["step_loss"] + [rec["val_loss"]]),
          f"streamed unified: {state.step} steps, finite losses")
    check(launched["fog_noise"] == launched["blur_sparse"] == groups
          and launched["blur_dense"] == 0,
          f"streamed unified launched {launched}, expected {groups} of B1 "
          "and B2 (one per scale group of each train and val batch)")
    after = state.model.state_dict()
    still = [k for k, v in before.items() if torch.equal(v, after[k])]
    check(not still, f"streamed unified parameters that did not move: "
          f"{still}")
    check((work / "ckpt" / "unified_streamed" / "model").exists(),
          "streamed unified checkpoint written")
    result["train_unified"] = {
        "images_per_sec": rec["images_per_sec"], "steps": state.step,
        "seconds": unified_s, "first_loss": rec["step_loss"][0],
        "last_loss": rec["step_loss"][-1], "val_loss": rec["val_loss"],
        "launches": launched, "log": lines}
    del state, before, after
    print("int8 phase streamed trainers: " + json.dumps({
        k: {kk: vv for kk, vv in result[k].items() if kk != "log"}
        for k in ("train_restorer", "train_unified")}))

    # -- 5. the unified trainer's checkpoints ------------------------------
    images = folder.load_batch(range(len(folder)))[0]
    ccfg = dataclasses.replace(ucfg, epochs=UNIFIED_CKPT_EPOCHS)
    state = unified_state(35, usteps)
    ckpt = work / "ckpt" / "unified"
    snapshot = {}
    lines = []

    def log(line):
        lines.append(line)
        if line == "  new best (val loss)":
            snapshot["weights"] = copy.deepcopy(state.model.state_dict())
            snapshot["step"] = state.step

    state, hist = loops.train_unified_on_device(
        state, images, utr, uva, ccfg, vgg_apply, save_path=str(ckpt),
        log=log, ckpt_config={"kind": "resunet", "dtype": "bf16"},
        device=dev)
    saved = torch.load(ckpt / "train", weights_only=True)["step"]
    check(saved == snapshot["step"] and state.step == 2 * usteps,
          f"unified checkpoint at step {saved}, snapshot "
          f"{snapshot['step']}")
    loaded = zoo.load_model("resunet", str(ckpt), dtype="bf16", device=dev)
    with torch.device(dev):
        snap = ResUNet((64, 128, 256), 512, dtype="bf16")
    snap.load_state_dict(snapshot["weights"])
    out_loaded = teval.make_fused_eval_step(loaded, judge, device=dev)(
        bad, label)
    out_snap = teval.make_fused_eval_step(snap.eval(), judge, device=dev)(
        bad, label)
    check(torch.equal(out_loaded["pred"], out_snap["pred"]),
          "zoo.load_model of the unified checkpoint gives the snapshot's "
          "fused-step preds")
    conf_diff = float((out_loaded["confidence"]
                       - out_snap["confidence"]).abs().max())
    resumed = zoo.load_train_state(str(ckpt), unified_state(36, usteps))
    check(resumed.step == saved, f"resumed at {resumed.step}, saved {saved}")
    resumed, _ = loops.train_unified_on_device(
        resumed, images, utr[:RESUME_STEPS * ucfg.batch_size], uva,
        dataclasses.replace(ucfg, epochs=1), vgg_apply, log=quiet,
        device=dev)
    check(resumed.step == saved + RESUME_STEPS,
          f"resume continued to step {resumed.step}")
    result["unified_checkpoint"] = {
        "epochs": UNIFIED_CKPT_EPOCHS, "val_loss": [r["val_loss"]
                                                    for r in hist],
        "images_per_sec": [r["images_per_sec"] for r in hist],
        "saved_step": saved, "resumed_to": resumed.step,
        "fused_preds_equal": True, "fused_confidence_max_diff": conf_diff,
        "config": zoo.checkpoint_config(str(ckpt)), "log": lines}
    print("int8 phase unified checkpoint: " + " | ".join(lines)
          + f"; saved step {saved}, load_model preds equal (confidence max "
          f"diff {conf_diff:.3g}), resumed to {resumed.step}")
    del state, loaded, snap, resumed, images
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    check(counts["fog_noise"] > 0 and counts["blur_sparse"] > 0,
          f"phase 8 launched {counts}: B1 and B2 in the mix and trainers")
    result["launches"] = counts
    result["phase_seconds"] = time.perf_counter() - t_phase
    print("int8: " + json.dumps({k: v for k, v in result.items()
                                 if k not in ("train_restorer",
                                              "train_unified",
                                              "unified_checkpoint")}))
    return counts


REPO = Path(__file__).resolve().parent
ACC_RE = re.compile(r"Result \[(.+?)\] Accuracy: ([0-9.]+)%")


def cli_commands():
    """``{command: script file}`` from ``tsr_tpu_torch.__main__``."""
    from tsr_tpu_torch.__main__ import COMMANDS
    return COMMANDS


def cli_subprocess(args, cwd, **env):
    """``python3 -m tsr_tpu_torch <args>`` in ``cwd`` with the checkout on
    PYTHONPATH (and ``env`` added to the environment); raises with its
    output on a non-zero exit. Returns its standard output and wall
    seconds."""
    env = dict(os.environ, PYTHONPATH=str(REPO), **env)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "tsr_tpu_torch", *args],
                         cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=600)
    check(out.returncode == 0,
          f"python -m tsr_tpu_torch {' '.join(args)} exited "
          f"{out.returncode}:\n{out.stdout[-2000:]}\n{out.stderr[-3000:]}")
    return out.stdout, time.perf_counter() - t0


def cli_main(command, argv):
    """Run ``command``'s script in process (its ``main(argv)``), its
    standard output captured, the kernels' launch counts zeroed just before
    and read just after. Returns (output, wall seconds, counts)."""
    import torch
    from tsr_tpu_torch.kernels import _build
    script = REPO / "tsr_tpu_torch" / "scripts" / cli_commands()[command]
    main = runpy.run_path(str(script), run_name="chip_smoke_cli")["main"]
    buf = io.StringIO()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            main(list(argv))
        torch.cuda.synchronize()
    except BaseException:
        print(f"cli {command} failed; its output:\n{buf.getvalue()[-3000:]}")
        raise
    return buf.getvalue(), time.perf_counter() - t0, _build.launch_counts()


def printed_rates(text):
    """Every images/s figure a command printed, as [what, rate] pairs:
    ``what`` is the ``Result [...]`` label of an evaluation line (the
    models that ran on that tree), else the start of the line."""
    rates = []
    for line in text.splitlines():
        m = re.search(r"\(([0-9.eE+-]+) img/s", line)
        if m:
            label = re.match(r"Result \[(.+?)\]", line)
            what = (label.group(1) if label
                    else line[:m.start()].strip()[:48])
            rates.append([what, float(m.group(1))])
    return rates


def parse_accuracy_report(text, title):
    """The rows of the accuracy table titled ``title`` as {name: percent};
    each must equal its ``Result [...]`` line."""
    lines = text.splitlines()
    check(title in lines, f"report {title!r} printed")
    i = lines.index(title)
    check(lines[i + 2].startswith("Dataset") and lines[i + 3] == "-" * 32,
          f"report {title!r} header")
    rows = {}
    for line in lines[i + 4:]:
        if line == "=" * 30:
            break
        name, acc = line.rsplit(" | ", 1)
        rows[name.strip()] = float(acc.rstrip("%"))
    results = {n: float(a) for n, a in ACC_RE.findall(text)}
    check(rows and rows == {n: results[n] for n in rows},
          f"report {title!r} rows {rows} match the Result lines {results}")
    return rows


def cli_parity(dev, work):
    """eval-baseline and eval-unified --fused with the same seeded .pth
    weights (full-width VGG16-D with 2 classes, ResUNet) on a 2 x 4 tree at
    CLI_PARITY_SIZE, on the card and with --device cpu, TF32 off (as
    ``run`` sets it): equal accuracy reports, each with a row off the
    single-class 50 %. The weights come from ``tsr_tpu_torch.parity``: the
    ResUNet passes its input through plus ``parity.OFFSET``, and the
    judge's head is the nearest-centroid rule over its own features of the
    three trees and of the restored compound tree (fitted on the CPU);
    plain random weights read 50 % on every tree.
    Returns {command: {device: report}}."""
    import torch
    from tsr_tpu_torch import parity
    from tsr_tpu_torch.models import ResUNet, VGG16
    root = work / "cli_parity"
    root.mkdir()
    cwd = os.getcwd()
    os.chdir(root)
    try:
        common = ["--clean-dir", "data/gtsrb/GTSRB/Training", "--synthetic",
                  "--synthetic-classes", "2", "--synthetic-per-class", "4",
                  "--image-size", str(CLI_PARITY_SIZE)]
        for command in ("download", "gen-noise", "gen-compound"):
            cli_main(command, common)
        torch.manual_seed(SEED + 8)
        resunet = parity.pass_through(ResUNet())
        compound = "data/processed/Compound"
        judge = parity.spread_judge(
            VGG16(num_classes=2, input_size=CLI_PARITY_SIZE),
            [("data/gtsrb/GTSRB/Training", None),
             ("data/processed/Noise", None), (compound, None),
             (compound, resunet)], CLI_PARITY_SIZE)
        torch.save(judge.state_dict(), "judge.pth")
        torch.save(resunet.state_dict(), "unified.pth")
        out = {}
        for command, title, extra in (
                ("eval-baseline", "Final Test Report (Baseline 1)", []),
                ("eval-unified", "Final Test Report (Unified Model)",
                 ["--fused", "--unified", "unified.pth"])):
            reports = {}
            for device in ("cuda", "cpu"):
                text, _, _ = cli_main(command, common + extra + [
                    "--batch-size", "4", "--model", "judge.pth",
                    "--device", device])
                reports[device] = parse_accuracy_report(text, title)
            check(reports["cuda"] == reports["cpu"],
                  f"{command} card {reports['cuda']} != CPU {reports['cpu']}")
            check(any(v != 50.0 for v in reports["cuda"].values()),
                  f"{command}: every row reads 50 %, as a judge that gives "
                  f"every image one class does: {reports['cuda']}")
            print(f"cli card vs CPU {command}: {reports['cuda']} on both")
            out[command] = reports
        return out
    finally:
        os.chdir(cwd)


def cli_phase(dev, work):
    """Phase 9: the port's commands (``python -m tsr_tpu_torch``) on the
    card, in ``work/cli``. Returns the kernels' launches summed over the
    in-process commands."""
    import importlib.util
    import numpy as np
    import torch
    from tsr_tpu_torch import zoo
    from tsr_tpu_torch.data import gtsrb
    t_phase = time.perf_counter()
    figures = importlib.util.find_spec("matplotlib") is not None
    cli_dir = work / "cli"
    cli_dir.mkdir()

    # -- 1. the entry point itself -----------------------------------------
    text, secs = cli_subprocess(["--help"], cli_dir)
    listed = re.findall(r"^  (\S+)\s+-> tsr_tpu_torch/scripts/(\S+)$", text,
                        re.M)
    check(dict(listed) == cli_commands() and len(listed) == 19,
          f"--help lists the 19 commands: {listed}")
    print(f"cli: python -m tsr_tpu_torch --help listed {len(listed)} "
          f"commands ({secs:.1f} s)")

    clean = "data/gtsrb/GTSRB/Training"
    common = ["--clean-dir", clean, "--ckpt-dir", "checkpoints",
              "--synthetic", "--synthetic-classes", str(CLI_CLASSES),
              "--synthetic-per-class", str(CLI_PER_CLASS),
              "--image-size", str(SIZE)]
    # the Quickstart's order; the default device (cuda) throughout
    steps = [
        ("download", []),
        ("gen-noise", []),
        ("gen-blur", []),
        ("gen-blur", ["--strength-jitter", "--dst",
                      "data/processed/BlurJitter"]),
        ("gen-fog", None),   # the subprocess
        ("gen-compound", []),
        ("train-judge", ["--epochs", "1", "--optimizer", "adamw", "--bf16"]),
        ("eval-baseline", []),
        ("train-restorer", ["--task", "noise", "--epochs", "1"]),
        ("train-restorer-advanced", ["--task", "blur", "--epochs", "1"]),
        ("train-unified", ["--epochs", "1", "--bf16"]),
        ("restore", ["--tasks", "noise", "blur"]),
        ("eval-restoration", ["--fused"]),
        ("eval-restoration", ["--fused", "--int8"]),
        ("restore-unified", ["--metrics"]),
        ("eval-unified", ["--fused"]),
        ("eval-unified", ["--fused", "--int8"]),
        ("embeddings", ["--samples-per-mode", str(CLI_EMBED_SAMPLES)]),
    ]
    if figures:
        # script 13 chains all three specialized restorers
        steps += [("train-restorer", ["--task", "fog", "--epochs", "1"]),
                  ("visualize", []), ("hidden-states", []),
                  ("stress-test", ["--num-samples", "4"]),
                  ("demo-unified", [])]
    else:
        print("cli: visualize, hidden-states, stress-test and demo-unified "
              "not run: matplotlib is not installed on this machine, and "
              "they draw figures with it")

    # a user's process has PyTorch's defaults: TF32 convolutions on, TF32
    # matmuls off (phases 2-8 turn both off)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    cwd = os.getcwd()
    os.chdir(cli_dir)
    runs, totals = [], {}
    try:
        for command, extra in steps:
            if extra is None:
                text, secs = cli_subprocess([command, *common], cli_dir)
                counts = None
            else:
                text, secs, counts = cli_main(command, common + extra)
                for k, v in counts.items():
                    totals[k] = totals.get(k, 0) + v
            rates = printed_rates(text)
            label = " ".join([command] + (extra or []))
            runs.append({"command": label, "seconds": secs,
                         "images_per_sec": rates, "launches": counts,
                         "output": text})
            print(f"cli {label}: {secs:.2f} s; images/s printed "
                  f"{[(what, round(r, 1)) for what, r in rates]}; launches "
                  f"{counts if counts is not None else 'subprocess'}")

        def launched(label, key):
            counts = next(r["launches"] for r in runs
                          if r["command"] == label)
            return counts[key]

        check(launched("gen-blur", "blur_dense") > 0, "B3 in gen-blur")
        check(launched("gen-compound", "blur_dense") > 0,
              "B3 in gen-compound")
        check(launched("gen-blur --strength-jitter --dst "
                       "data/processed/BlurJitter", "blur_sparse") > 0,
              "B2 in gen-blur --strength-jitter")
        for key in ("fog_noise", "blur_sparse"):
            check(launched("train-unified --epochs 1 --bf16", key) > 0,
                  f"{key} in train-unified")

        # -- artifacts ------------------------------------------------------
        n_clean = len(gtsrb.ImageFolder(clean))
        check(n_clean == CLI_CLASSES * CLI_PER_CLASS, "the synthetic tree")
        trees = ["data/processed/" + t for t in
                 ("Noise", "Blur", "BlurJitter", "Fog", "Compound")]
        trees += ["data/restored/" + t for t in ("Noise", "Blur", "Compound")]
        for tree in trees:
            n = len([p for p in Path(tree).glob("*/*")
                     if p.suffix in gtsrb.IMG_EXTENSIONS])
            check(n == n_clean, f"{tree} holds {n} of {n_clean} files")
        loaded = {}
        for kind, name in (("vgg16", "vgg16_baseline"),
                           ("simple_unet", "restoration_noise"),
                           ("simple_unet", "restoration_blur"),
                           ("resunet", "restoration_unified_resnet")):
            model = zoo.load_model(kind, f"checkpoints/{name}", SIZE,
                                   device=dev)
            n_params = sum(p.numel() for p in model.parameters())
            check(all(bool(torch.isfinite(p).all())
                      for p in model.parameters()), f"{name} finite")
            loaded[name] = n_params
        reports = {}
        for label, title in (
                ("eval-baseline", "Final Test Report (Baseline 1)"),
                ("eval-restoration --fused",
                 "Final Test Report (Restoration)"),
                ("eval-restoration --fused --int8",
                 "Final Test Report (Restoration)"),
                ("eval-unified --fused", "Final Test Report (Unified Model)"),
                ("eval-unified --fused --int8",
                 "Final Test Report (Unified Model)")):
            text = next(r["output"] for r in runs if r["command"] == label)
            reports[label] = parse_accuracy_report(text, title)
        check(len(reports["eval-baseline"]) == 4, "eval-baseline: 4 trees")
        metrics = {}
        for label in ("restore --tasks noise blur", "restore-unified "
                      "--metrics"):
            text = next(r["output"] for r in runs if r["command"] == label)
            psnr = [float(x) for x in re.findall(r"Average PSNR: ([0-9.]+)",
                                                 text)]
            ssim = [float(x) for x in re.findall(
                r"Average SSIM: (-?[0-9.]+)", text)]
            check(psnr and len(psnr) == len(ssim)
                  and all(math.isfinite(v) for v in psnr + ssim),
                  f"{label} PSNR/SSIM printed: {psnr} {ssim}")
            metrics[label] = {"psnr": psnr, "ssim": ssim}
        emb = torch.load("umap_embeddings.pt", weights_only=False)
        check(emb["embeddings"].shape[1] == 2
              and emb["original_features"].shape[1] == 512
              and len(emb["labels"]) == emb["embeddings"].shape[0]
              and bool(np.isfinite(emb["embeddings"].numpy()).all()),
              "umap_embeddings.pt schema")
        if figures:
            for fig in ("result_visualization.png",
                        "hidden_state_visualization.png",
                        "unified_test_result.png"):
                check(Path(fig).exists(), f"{fig} written")
            check(len(list(Path("pipeline_results").glob("*.png"))) == 4,
                  "stress-test figures")
    finally:
        os.chdir(cwd)
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32

    # -- card against CPU ---------------------------------------------------
    parity = cli_parity(dev, work)
    summary = {
        "card": card_line(), "tree": [CLI_CLASSES, CLI_PER_CLASS],
        "size": SIZE, "figures_run": figures,
        "commands": [{k: r[k] for k in ("command", "seconds",
                                        "images_per_sec", "launches")}
                     for r in runs],
        "reports": reports, "restore_metrics": metrics,
        "checkpoint_params": loaded, "card_vs_cpu": parity,
        "launches": totals,
        "phase_seconds": time.perf_counter() - t_phase}
    print("cli: " + json.dumps(summary))
    return totals


def b1_split_check(dev):
    """B1 on a [BATCH, SIZE, SIZE, 3] batch with every noise gate on, once
    whole and once as three calls split at MESH_SPLIT with their ``row0``:
    f and pre_blur equal bit for bit (the split calls draw the whole
    call's Philox stream). Comparison launches, not a path."""
    import torch
    from tsr_tpu_torch.kernels import distort as kdistort
    from tsr_tpu_torch.ops import distortions
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    clean = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), dtype=torch.uint8,
                          device=dev, generator=g)
    d = distortions.draw_random_mix(BATCH, g)
    args = (d.gate_fog.to(torch.int32), d.t,
            torch.ones(BATCH, dtype=torch.int32, device=dev), d.sigma)
    f, pre = kdistort.fused_fog_noise(clean, d.seed[:1], *args)
    cuts = (0, *MESH_SPLIT, BATCH)
    parts = [kdistort.fused_fog_noise(
        clean[a:b], d.seed[:1], *(v[a:b] for v in args), row0=a,
        group_rows=BATCH) for a, b in zip(cuts, cuts[1:])]
    f_split = torch.cat([p[0] for p in parts])
    pre_split = torch.cat([p[1] for p in parts])
    torch.cuda.synchronize()
    diff = {"f": int((f_split != f).sum()), "pre_blur":
            int((pre_split != pre).sum())}
    check(diff == {"f": 0, "pre_blur": 0},
          f"B1 split at {MESH_SPLIT} with row0 differs from the whole call "
          f"at {diff} values")
    print(f"mesh: B1 on {list(clean.shape)} split at rows {MESH_SPLIT} "
          f"into 3 calls with row0: f and pre_blur equal to the whole call "
          f"bit for bit")
    return {"shape": list(clean.shape), "split": list(MESH_SPLIT),
            "mismatches": diff}


def cli_subprocesses(lanes, cwd):
    """``cli_subprocess`` of each ``(args, env)`` job of ``lanes``: the
    lanes start together, and each runs its jobs one after another.
    Returns each job's standard output and wall seconds, lane by lane."""
    from concurrent.futures import ThreadPoolExecutor

    def lane(jobs):
        return [cli_subprocess(args, cwd, **env) for args, env in jobs]

    with ThreadPoolExecutor(len(lanes)) as pool:
        futures = [pool.submit(lane, jobs) for jobs in lanes]
        return [run for f in futures for run in f.result()]


def mesh_cli_tree(work):
    """A copy of phase 9's trees (``work / "cli"``: the clean one and the
    noisy, blurred and foggy ones eval-baseline reads) with the first
    MESH_CLI_PER_CLASS images of each class, beside its checkpoints (a
    link): the directory the commands of mesh_cli run in."""
    src = work / "cli"
    dst = work / "mesh_cli"
    for tree in map(Path, ("data/gtsrb/GTSRB/Training", *MESH_CLI_DISTORTED)):
        for cls in sorted(p for p in (src / tree).iterdir() if p.is_dir()):
            (dst / tree / cls.name).mkdir(parents=True)
            for f in sorted(cls.iterdir())[:MESH_CLI_PER_CLASS]:
                shutil.copyfile(f, dst / tree / cls.name / f.name)
    (dst / "checkpoints").symlink_to((src / "checkpoints").resolve())
    return dst


def mesh_cli(work):
    """On a smaller copy of phase 9's trees (mesh_cli_tree): train-unified
    (one epoch) and eval-baseline, each
    once with ``--mesh data=MESH_RANKS`` (ranks the command starts on this
    card, gloo) and once without (train-unified then on the host-streamed
    loop the mesh takes), as subprocesses: the three with a mesh one after
    another (each takes a free port for its group), beside the four
    without, which start with them. Their seconds and rates (the keys
    ending ``_concurrent``) are of runs that share the card and the host
    with the others. In float32 with TF32 off
    (``NVIDIA_TF32_OVERRIDE=0``) both the train and the validation loss
    are held to MESH_CLI_RTOL. In bf16 (``--bf16``) the train loss is held
    to it, and the validation loss is reported beside the spread of two
    runs of the command without a mesh: Adam moves the convolution biases
    that feed a batch norm (exact gradient 0) by about its rate each step
    in the sign of rounding noise, and only the eval-mode loss sees them
    (PERF.md, section 6)."""
    cli_dir = mesh_cli_tree(work)
    common = ["--clean-dir", "data/gtsrb/GTSRB/Training", "--ckpt-dir",
              "checkpoints", "--image-size", str(SIZE)]
    mesh = ["--mesh", f"data={MESH_RANKS}"]
    fp32 = {"NVIDIA_TF32_OVERRIDE": "0"}
    out = {"tree": [len(list((cli_dir / common[1]).iterdir())),
                    MESH_CLI_PER_CLASS]}

    def train_job(extra, save, **env):
        return (["train-unified", *common, "--epochs", "1", *extra, "--save",
                 f"checkpoints/{save}"], env)

    def losses(text):
        found = [float(x) for x in re.findall(r"loss (\d+\.\d+)", text)]
        check(len(found) == 2, f"train and val losses printed: {found}")
        return found

    def rel(x, y):
        return abs(x - y) / abs(y)

    title = "Final Test Report (Baseline 1)"
    runs = cli_subprocesses([
        [train_job(mesh, "mesh_two", **fp32),
         train_job(mesh + ["--bf16"], "bf16_mesh"),
         (["eval-baseline", *common, *mesh], fp32)],
        [train_job(["--host-stream"], "mesh_one", **fp32)],
        [train_job(["--host-stream", "--bf16"], "bf16_one_a")],
        [train_job(["--host-stream", "--bf16"], "bf16_one_b")],
        [(["eval-baseline", *common], fp32)]], cli_dir)
    ((two, t_two), (mtext, t_m), (e2, t_e2), (one, t_one), (atext, t_a1),
     (btext, t_a2), (e1, t_e1)) = runs
    a, b, a1, a2, m = map(losses, (one, two, atext, btext, mtext))
    line = re.search(r"^Mesh: .*$", two, re.M)
    check(line and "backend gloo" in line.group(0)
          and f"over {MESH_RANKS} ranks" in line.group(0),
          f"train-unified --mesh names gloo and the devices: {line}")
    worst = max(rel(x, y) for x, y in zip(b, a))
    check(worst <= MESH_CLI_RTOL,
          f"train-unified --mesh losses {b} vs {a}: {worst} > "
          f"{MESH_CLI_RTOL}")
    check(two.count("Done. Checkpoint at") == 1, "only the first rank prints")
    out["train_unified"] = {"losses": a, "mesh_losses": b, "max_rel": worst,
                            "seconds_concurrent": t_one,
                            "mesh_seconds_concurrent": t_two,
                            "mesh_line": line.group(0),
                            "images_per_sec_concurrent": printed_rates(one),
                            "mesh_images_per_sec_concurrent":
                                printed_rates(two)}
    print(f"mesh: cli train-unified --mesh data={MESH_RANKS} (fp32, TF32 "
          f"off): losses {b} vs {a} without (max rel {worst:.3g}, tol "
          f"{MESH_CLI_RTOL})")

    # bf16: the train loss gated, the validation loss beside two runs
    # without a mesh
    train_rel = rel(m[0], a1[0])
    check(train_rel <= MESH_CLI_RTOL,
          f"train-unified --mesh --bf16 train loss {m[0]} vs {a1[0]}: "
          f"{train_rel} > {MESH_CLI_RTOL}")
    out["train_unified_bf16"] = {
        "losses_run_a": a1, "losses_run_b": a2, "mesh_losses": m,
        "train_rel": train_rel,
        "val_rel_two_runs_without_mesh": rel(a2[1], a1[1]),
        "val_rel_mesh": rel(m[1], a1[1]),
        "train_rel_two_runs_without_mesh": rel(a2[0], a1[0]),
        "seconds_concurrent": t_a1, "seconds_run_b_concurrent": t_a2,
        "mesh_seconds_concurrent": t_m,
        "mesh_images_per_sec_concurrent": printed_rates(mtext)}
    print(f"mesh: cli train-unified --mesh data={MESH_RANKS} --bf16: train "
          f"loss {m[0]} vs {a1[0]} without (rel {train_rel:.3g}, tol "
          f"{MESH_CLI_RTOL}); not gated: validation loss {m[1]} (rel "
          f"{rel(m[1], a1[1]):.3g}) against two runs without a mesh "
          f"{a1[1]} and {a2[1]} (rel {rel(a2[1], a1[1]):.3g}; their train "
          f"losses {a1[0]} and {a2[0]})")

    r1, r2 = (parse_accuracy_report(t, title) for t in (e1, e2))
    rows = ["Clean (Original)", "Noisy", "Blurred", "Foggy"]
    check(list(r1) == rows and list(r2) == rows,
          f"eval-baseline reports {list(r1)} and --mesh {list(r2)}: not "
          f"the rows {rows}")
    check(r1 == r2, f"eval-baseline --mesh {r2} != without {r1}")
    out["eval_baseline"] = r1
    out["eval_baseline_seconds_concurrent"] = [t_e1, t_e2]
    print(f"mesh: cli eval-baseline --mesh data={MESH_RANKS} report {r2} "
          f"equals the one without")
    return out


def mesh_phase(dev, work):
    """Phase 10: the multi-device layer (``tsr_tpu_torch.parallel``) on
    this one card. Returns the kernels' launches of its main path (the
    data-parallel steps on the ranks, summed, and the NCCL world of one)."""
    import numpy as np
    import torch
    from tsr_tpu_torch import configs
    from tsr_tpu_torch.parallel import checks, launch
    from tsr_tpu_torch.parallel.dryrun import dryrun_multichip
    t_phase = time.perf_counter()
    result = {"card": card_line(), "b1_split": b1_split_check(dev)}

    # -- the flagship step on (data=1, model=2): two ranks, one card ------
    t0 = time.perf_counter()
    records = dryrun_multichip(2, device="cuda")
    check(records[0]["mesh"] == {"data": 1, "model": 2}
          and records[0]["backend"] == "gloo", f"dryrun mesh {records[0]}")
    result["dryrun"] = dict(records[0], seconds=time.perf_counter() - t0)

    # -- the data-parallel step at the training cell ----------------------
    clean = np.random.default_rng(SEED + 11).integers(
        0, 256, (TRAIN_BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    kw = dict(arch=dict(widths=(64, 128, 256), bottleneck_width=512,
                        dtype="bf16"),
              judge_arch=dict(num_classes=configs.NUM_CLASSES,
                              input_size=SIZE, dtype="bf16"),
              seed=SEED + 12, clean_u8=clean,
              gen_seeds=list(range(SEED + 100, SEED + 101 + MESH_STEPS)))
    one = checks.unified_train_steps(**kw, device=dev)
    ranks = [r[0] for r in launch.spawn(
        checks.run, MESH_RANKS,
        ([("unified_train_steps", dict(kw, data=MESH_RANKS))],),
        device="cuda")]
    counts = {k: sum(r["launches"][k] for r in ranks)
              for k in ranks[0]["launches"]}
    n_groups = len(configs.UnifiedTrainConfig().mix.apply_scales)
    for r in ranks:
        check(r["backend"] == "gloo" and r["device"].startswith("cuda"),
              f"ranks sharing one card run gloo on it: {r['backend']} "
              f"{r['device']}")
        check(r["losses"] == ranks[0]["losses"], "ranks log the same loss")
        for key in ("fog_noise", "blur_sparse"):
            check(r["launches"][key] > 0, f"{key} launched on each rank")
    rel = [abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"],
                                               one["losses"])]
    check(max(rel) <= MESH_RTOL, f"data-parallel losses "
          f"{ranks[0]['losses']} vs one process {one['losses']}")
    for key in ("fog_noise", "blur_sparse"):
        check(counts[key] == one["launches"][key]
              == n_groups * len(kw["gen_seeds"]),
              f"{key}: {counts[key]} launches over the ranks, "
              f"{one['launches'][key]} in one process")
    result["data_parallel"] = {
        "batch": TRAIN_BATCH, "size": SIZE, "dtype": "bf16",
        "ranks": MESH_RANKS, "steps": MESH_STEPS, "losses": ranks[0]["losses"],
        "one_process_losses": one["losses"], "max_rel": max(rel),
        "images_per_sec_two_ranks_one_card": ranks[0]["images_per_sec"],
        "images_per_sec_one_process": one["images_per_sec"],
        "peak_memory_gib_per_rank": [r["peak_memory_gib"] for r in ranks],
        "launches_per_rank": [r["launches"] for r in ranks]}
    per_rank = [(r["launches"]["fog_noise"], r["launches"]["blur_sparse"])
                for r in ranks]
    print(f"mesh: data-parallel unified step, {MESH_RANKS} ranks sharing "
          f"one card (gloo), batch {TRAIN_BATCH} at {SIZE} bf16: losses "
          f"{ranks[0]['losses']} vs one process {one['losses']} (max rel "
          f"{max(rel):.3g}, tol {MESH_RTOL}); B1/B2 launches per rank "
          f"{per_rank}; "
          f"not gated: {ranks[0]['images_per_sec']:.1f} images/s for the "
          f"{MESH_RANKS} ranks sharing one card (no scaling measured) "
          f"against {one['images_per_sec']:.1f} in one process, peak "
          f"memory per rank {[round(r['peak_memory_gib'], 3) for r in ranks]}"
          f" GiB")

    # -- a world of one over NCCL ------------------------------------------
    nccl = launch.spawn(checks.run, 1, ([("unified_train_steps", dict(
        kw, data=1, gen_seeds=kw["gen_seeds"][:2]))],), device="cuda")[0][0]
    check(nccl["backend"] == "nccl", f"one rank on one card: {nccl}")
    check(nccl["losses"][0] == one["losses"][0],
          f"NCCL world of one: first step {nccl['losses'][0]} != "
          f"{one['losses'][0]} without a mesh")
    nrel = max(abs(a - b) / abs(b) for a, b in zip(nccl["losses"],
                                                   one["losses"]))
    check(nrel <= MESH_RTOL, f"NCCL world of one {nccl['losses']}")
    for k, v in nccl["launches"].items():
        counts[k] += v
    result["nccl_world_of_one"] = {"losses": nccl["losses"],
                                   "max_rel": nrel}
    check(counts["blur_dense"] == 0, "no shared blur (B3) on the mesh path")

    # -- the commands' --mesh on phase 9's tree -----------------------------
    result["cli"] = mesh_cli(work)
    result["launches"] = counts
    result["phase_seconds"] = time.perf_counter() - t_phase
    print("mesh: " + json.dumps(result))
    return counts


def twin_tree(src, dst, suffix):
    """Every file of the tree ``src`` decoded by the port's IO library and
    written under ``dst`` with ``suffix``: the same pixels in another
    format. Returns the written paths, in file order."""
    from tsr_tpu_torch import native, offline
    files = offline.tree_files(str(src))
    written = []
    for _, chunk, batch in offline.bucketed_batches(files, TREE_BATCH):
        paths, crops = [], []
        for (p, (h, w)), img in zip(chunk, batch):
            out = (dst / p.relative_to(src)).with_suffix(suffix)
            out.parent.mkdir(parents=True, exist_ok=True)
            paths.append(str(out))
            crops.append(img[:h, :w])
        native.write_images(paths, crops)
        written += paths
    return sorted(written)


def check_jpeg_fixtures(work):
    """The committed fixtures (``tests/data/jpeg``, written by cv2, PIL and
    ``jpeg_writers.py``): each .jpg decoded by the port equals what the
    reference reads from it (its ``cv2.imread`` array, or PIL's where cv2
    gives None), and each encoder input written as .jpg by the port equals
    ``cv2.imwrite``'s bytes. The card's machine has neither cv2 nor PIL:
    these files are the yardstick."""
    import numpy as np
    from tsr_tpu_torch import native
    want = np.load(JPEG_FIXTURES / "expected.npz")
    names = sorted(p.stem for p in JPEG_FIXTURES.glob("*.jpg"))
    check(len(names) >= 12, f"{len(names)} fixture JPEGs")
    for name in names:
        got = native.decode(str(JPEG_FIXTURES / f"{name}.jpg"))
        check(np.array_equal(got, want[f"decoded__{name}"]),
              f"fixture {name}.jpg decodes unlike cv2.imread")
    inputs = sorted(k for k in want.files if k.startswith("encode_input__"))
    for key in inputs:
        k = key.split("__")[1]
        out = work / f"fixture_{k}.jpg"
        native.write_images([str(out)], [want[key]])
        check(out.read_bytes() == want[f"encode_bytes__{k}"].tobytes(),
              f"fixture encode {k} differs from cv2.imwrite's bytes")
    return {"decoded": len(names), "encoded": len(inputs)}


def host_decode_rates(trees):
    """Images/s of the host decode paths over each tree ``{name: dir}``,
    best of JPEG_DECODE_REPS passes: ``native.probe`` + ``load_canvas``
    (``offline.bucketed_batches``, generate_tree's reader) and
    ``load_batch`` at SIZE in chunks of TREE_BATCH."""
    from tsr_tpu_torch import native, offline
    rates = {}
    for name, root in trees.items():
        files = offline.tree_files(str(root))
        paths = [str(p) for p in files]
        canvas, resized = [], []
        for _ in range(JPEG_DECODE_REPS):
            t0 = time.perf_counter()
            for _ in offline.bucketed_batches(files, TREE_BATCH):
                pass
            canvas.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            for s in range(0, len(paths), TREE_BATCH):
                native.load_batch(paths[s:s + TREE_BATCH], SIZE)
            resized.append(time.perf_counter() - t0)
        rates[name] = {"images": len(paths),
                       "probe_load_canvas_images_per_sec":
                       len(paths) / min(canvas),
                       "load_batch_224_images_per_sec":
                       len(paths) / min(resized),
                       "seconds_canvas": canvas, "seconds_load_batch":
                       resized}
    return rates


def jpeg_phase(dev, resunet, judge, work):
    """Phase 11: the port's JPEG codec on the card's machine, in ``work``
    (the trees phase's clean tree): the committed fixtures against cv2's
    pixels and bytes; the clean tree written as .jpg by the port's encoder
    and its decoded pixels as a .png twin; host decode rates on the .jpg
    and .ppm trees; generate_tree on the .jpg tree for JPEG_KINDS (B3 in
    blur and compound, B2 in blur_rand, launch counts zeroed just before
    and read just after each call) and on the twin for JPEG_TWIN_KINDS,
    compared; restore_tree (host and device resize, metrics on) and
    evaluate_directory on the .jpg trees against their .png twins. Returns
    the kernels' launches."""
    import numpy as np
    import torch
    from tsr_tpu_torch import eval as teval
    from tsr_tpu_torch import infer, native, offline
    from tsr_tpu_torch.kernels import _build
    quiet = lambda line: None  # noqa: E731
    t_phase = time.perf_counter()
    result = {"card": card_line(), "host_cpus": os.cpu_count()}
    result["fixtures"] = check_jpeg_fixtures(work)
    print("jpeg fixtures: " + json.dumps(result["fixtures"]) + " equal to "
          "the reference's pixels and cv2's bytes")

    jroot, proot = work / "jpeg", work / "jpeg_png"
    t0 = time.perf_counter()
    jpg = twin_tree(work / "clean", jroot / "clean", ".jpg")
    result["write_jpeg_tree_seconds"] = time.perf_counter() - t0
    png = twin_tree(jroot / "clean", proot / "clean", ".png")
    check(len(jpg) == len(png) == TREE_IMAGES, "the JPEG tree and its twin")
    result["jpeg_tree_bytes"] = sum(Path(p).stat().st_size for p in jpg)
    rates = host_decode_rates({"jpg": jroot / "clean",
                               "ppm": work / "clean"})
    result["host_decode"] = rates
    print(f"jpeg tree: {len(jpg)} .jpg files ({result['jpeg_tree_bytes']} "
          f"bytes) written in {result['write_jpeg_tree_seconds']:.3f} s; "
          "host decode images/s (best of "
          f"{JPEG_DECODE_REPS}, {result['host_cpus']} CPUs, beside "
          f"{result['card']}): " + ", ".join(
              f"{k} probe+load_canvas "
              f"{v['probe_load_canvas_images_per_sec']:.1f}, load_batch@224 "
              f"{v['load_batch_224_images_per_sec']:.1f}"
              for k, v in rates.items()))

    sides = [tuple(d) for d in native.probe(jpg).tolist()]
    launches = {"blur_sparse": 0, "blur_dense": 0, "fog_noise": 0}
    gen = {}
    for tree, root, kinds in (("jpg", jroot, JPEG_KINDS),
                              ("png", proot, JPEG_TWIN_KINDS)):
        for kind in kinds:
            buckets = tree_buckets(sides, offline.HALO.get(kind, 0))
            n_batches = sum(-(-n // TREE_BATCH) for n in buckets.values())
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            n = offline.generate_tree(str(root / "clean"), str(root / kind),
                                      kind, seed=SEED,
                                      batch_size=TREE_BATCH, log=quiet,
                                      device=dev)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = _build.launch_counts()
            want = {"blur_dense": n_batches if kind in ("blur", "compound")
                    else 0,
                    "blur_sparse": n_batches if kind == "blur_rand" else 0,
                    "fog_noise": 0}
            check(n == TREE_IMAGES, f"{tree} {kind} wrote {n} images")
            check(counts == want, f"{tree} {kind} launched {counts}, "
                  f"expected {want}")
            suffix = ".png" if kind == "compound" else f".{tree}"
            n_files = len(list((root / kind).glob(f"*/*{suffix}")))
            check(n_files == TREE_IMAGES, f"{tree} {kind}: {n_files} "
                  f"{suffix} files")
            for k, v in counts.items():
                launches[k] += v
            gen[f"{tree} {kind}"] = dict(images_per_sec=n / dt, seconds=dt,
                                         batches=n_batches, launches=counts)
            print(f"generate_tree {kind} on the {tree} tree: "
                  f"{n / dt:.1f} images/s ({dt:.3f} s), {n_batches} "
                  f"batches, B2 {counts['blur_sparse']} / B3 "
                  f"{counts['blur_dense']} launches, {n_files} {suffix}")
    result["generate_tree"] = gen
    check(launches["blur_sparse"] > 0 and launches["blur_dense"] > 0,
          "B2 and B3 launched on the JPEG path")

    # the twin's outputs: compound .png equal file for file; blur .jpg
    # equal to the port's JPEG encode of the twin's .png blur output
    same_png = same_jpg = 0
    reenc = work / "jpeg_reenc"
    for p in offline.tree_files(str(proot / "compound")):
        rel = p.relative_to(proot / "compound")
        check(p.read_bytes() == (jroot / "compound" / rel).read_bytes(),
              f"compound {rel}: the .jpg tree's and the twin's differ")
        same_png += 1
    blur_png = offline.tree_files(str(proot / "blur"))
    reenc_paths = [str(reenc / p.relative_to(proot / "blur")
                       .with_suffix(".jpg")) for p in blur_png]
    for q in reenc_paths:
        Path(q).parent.mkdir(parents=True, exist_ok=True)
    native.write_images(reenc_paths, [native.decode(str(p))
                                      for p in blur_png])
    for p, q in zip(blur_png, reenc_paths):
        rel = p.relative_to(proot / "blur").with_suffix(".jpg")
        mine = jroot / "blur" / rel
        check(np.array_equal(native.decode(str(mine)), native.decode(q)),
              f"blur {rel}: the .jpg output and the twin's re-encoded one "
              "decode differently")
        same_jpg += mine.read_bytes() == Path(q).read_bytes()
    result["twins"] = {"compound_png_equal": same_png,
                       "blur_jpg_decoded_equal": len(blur_png),
                       "blur_jpg_bytes_equal": same_jpg}
    print("jpeg twins: " + json.dumps(result["twins"]))

    noise_png = twin_tree(jroot / "noise", proot / "noise_decoded", ".png")
    check(len(noise_png) == TREE_IMAGES, "the noise tree's PNG twin")
    trees = {"jpg": (jroot / "noise", jroot / "clean"),
             "png": (proot / "noise_decoded", proot / "clean")}
    walks = {}
    _build.reset_launch_counts()
    for resize in ("device", "host"):
        outs = {}
        for tree, (bad, clean) in trees.items():
            out = work / f"jpeg_restored_{tree}_{resize}"
            res = infer.restore_tree(resunet, str(bad), str(out),
                                     clean_dir=str(clean),
                                     batch_size=BATCH, size=SIZE,
                                     resize=resize, log=quiet, device=dev)
            check(res["images"] == TREE_IMAGES and math.isfinite(res["psnr"])
                  and 0 <= res["ssim"] <= 1,
                  f"restore_tree {tree} {resize}: {res}")
            outs[tree] = (out, res)
            walks[f"{tree} {resize}"] = {
                k: res[k] for k in ("images_per_sec", "seconds", "batches",
                                    "psnr", "ssim", "host_seconds")}
        (a, ra), (b, rb) = outs["jpg"], outs["png"]
        files = sorted(a.glob("*/*.png"))
        check(len(files) == TREE_IMAGES and all(
            p.read_bytes() == (b / p.relative_to(a)).read_bytes()
            for p in files), f"restore_tree {resize}: the .jpg tree's "
              "restored files differ from its .png twin's")
        check(ra["psnr"] == rb["psnr"] and ra["ssim"] == rb["ssim"],
              f"restore_tree {resize}: metrics differ from the twin's")
        print(f"restore_tree resize={resize} on the jpg noise tree: "
              f"{ra['images_per_sec']:.1f} images/s (png twin "
              f"{rb['images_per_sec']:.1f}), PSNR {ra['psnr']:.4f} dB, SSIM "
              f"{ra['ssim']:.5f}, restored files equal to the twin's")
    result["restore_tree"] = walks
    evals = {}
    for name in ("clean", "noise"):
        res = teval.evaluate_directory(judge, str(jroot / name),
                                       batch_size=BATCH, size=SIZE,
                                       restorer=resunet, resize="host",
                                       device=dev)
        check(res["n"] == TREE_IMAGES and 0 <= res["top1"] <= 1
              and math.isfinite(res["confidence"]),
              f"evaluate_directory on the jpg {name} tree: {res}")
        evals[name] = res
        print(f"evaluate_directory on the jpg {name} tree: "
              f"{res['images_per_sec']:.1f} images/s, n {res['n']}, top-1 "
              f"{res['top1']:.4f} (random weights)")
    check(sum(_build.launch_counts().values()) == 0,
          "the walks launch no blur or B1 kernel")
    result["evaluate_directory"] = evals
    steps = {"host": teval.make_fused_eval_step(resunet, judge, device=dev),
             "device": teval.make_fused_eval_step(resunet, judge,
                                                  native_size=SIZE,
                                                  device=dev)}
    agree = {}
    for name, jdir, pdir, modes in (
            ("clean", jroot / "clean", proot / "clean", ("host",)),
            ("noise", jroot / "noise", proot / "noise_decoded",
             ("host", "device"))):
        for resize in modes:
            a = preds_by_file(steps[resize], jdir, resize, dev)
            b = preds_by_file(steps[resize], pdir, resize, dev)
            check(np.array_equal(a, b), f"preds on the jpg {name} tree "
                  f"({resize} resize) differ from its png twin's")
            agree[f"{name} {resize}"] = len(a)
    result["preds_equal_to_png_twin"] = agree
    result["launches"] = launches
    result["phase_seconds"] = time.perf_counter() - t_phase
    print("jpeg: " + json.dumps(result))
    return launches


def group_decode_rates(groups):
    """Host decode images/s and megapixels/s of each fixture group
    ``{name: [paths]}``: JPEG_FEATURE_DECODES decodes a pass (the group's
    files in turn) through ``native.load_canvas`` at native size on one
    thread, best of JPEG_DECODE_REPS passes."""
    import numpy as np
    from tsr_tpu_torch import native
    rates = {}
    for name, paths in groups.items():
        dims = [native.decode(p).shape[:2] for p in paths]
        reps = -(-JPEG_FEATURE_DECODES // len(paths))
        batch = (paths * reps)[:JPEG_FEATURE_DECODES]
        pixels = sum(h * w for h, w in (dims * reps)[:len(batch)])
        out = np.empty((len(batch), max(h for h, _ in dims),
                        max(w for _, w in dims), 3), np.uint8)
        best = math.inf
        for _ in range(JPEG_DECODE_REPS):
            t0 = time.perf_counter()
            native.load_canvas(batch, out, threads=1)
            best = min(best, time.perf_counter() - t0)
        rates[name] = {"files": len(paths), "images_per_sec":
                       len(batch) / best, "megapixels_per_sec":
                       pixels / best / 1e6, "seconds": best}
    return rates


def probe_seconds(paths):
    """Best of JPEG_DECODE_REPS ``native.probe`` calls on ``paths`` (8
    threads) by header and as cv2 reads (the whole file: generate_tree's
    skip rule); each must read every file."""
    from tsr_tpu_torch import native
    out = {}
    for reader in ("port", "cv2"):
        best = math.inf
        for _ in range(JPEG_DECODE_REPS):
            t0 = time.perf_counter()
            dims = native.probe(paths, reader=reader)
            best = min(best, time.perf_counter() - t0)
        check(int((dims[:, 0] > 0).sum()) == len(paths),
              f"probe(reader={reader!r}) reads {int((dims[:, 0] > 0).sum())}"
              f" of {len(paths)} files")
        out[reader] = best
    return out


def jpeg_features_phase(dev, resunet, judge, work):
    """Phase 12: the JPEG data cv2 reads with a warning, or rarely, from
    the committed fixtures (the card's machine has neither cv2 nor PIL),
    in ``work``: every JPEG_FEATURE_GROUPS fixture decoded equal to
    ``expected.npz`` and every JPEG_SKIP_FIXTURES file raising with its
    feature named; C11's files (c11_files) decoded to C11_DIGESTS; host
    decode rates by group; generate_tree on the
    fixtures plus the skip files for JPEG_FEATURE_KINDS (B3 in blur and
    compound, B2 in blur_rand, launch counts zeroed just before and read
    just after each call; the written count the reference's);
    restore_tree and evaluate_directory over the readable fixtures in
    both resize modes and under the PIL resize backend. Returns the
    kernels' launches."""
    import hashlib

    import numpy as np
    import torch
    from tsr_tpu_torch import eval as teval
    from tsr_tpu_torch import infer, native, offline
    from tsr_tpu_torch.data import gtsrb
    from tsr_tpu_torch.kernels import _build
    quiet = lambda line: None  # noqa: E731
    t_phase = time.perf_counter()
    result = {"card": card_line(), "host_cpus": os.cpu_count()}
    want = np.load(JPEG_FIXTURES / "expected.npz")
    groups = {g: [str(JPEG_FIXTURES / f"{n}.jpg") for n in names]
              for g, names in JPEG_FEATURE_GROUPS.items()}
    for g, paths in groups.items():
        for p in paths:
            check(np.array_equal(native.decode(p),
                                 want[f"decoded__{Path(p).stem}"]),
                  f"fixture {Path(p).name} ({g}) decodes unlike the "
                  "reference's read")
    for name, feature in JPEG_SKIP_FIXTURES.items():
        try:
            native.decode(str(JPEG_FIXTURES / "skip" / f"{name}.jpg"))
        except RuntimeError as e:
            check(feature in str(e), f"skip/{name}.jpg: {e}")
        else:
            check(False, f"skip/{name}.jpg decoded; cv2 and PIL refuse it")
    # C11: FF FF 00 in entropy data, read as libjpeg-turbo's fast and slow
    # Huffman passes read it
    c11 = c11_files(work / "c11")
    check(sorted(c11) == sorted(C11_DIGESTS),
          f"C11 sites {sorted(c11)}; the digests hold {sorted(C11_DIGESTS)}")
    for site, p in c11.items():
        got = np.ascontiguousarray(native.decode(str(p)))
        check(hashlib.sha256(got.tobytes()).hexdigest() == C11_DIGESTS[site],
              f"C11 file {p.name} decodes unlike cv2.imread")
    result["c11_files"] = len(c11)
    print(f"C11: {len(c11)} files built from the port's JPEG writer with FF "
          "FF 00 in their entropy data decode to cv2.imread's pixels "
          "(SHA-256)")
    result["fixtures"] = {g: len(p) for g, p in groups.items()}
    result["skip_fixtures"] = len(JPEG_SKIP_FIXTURES)
    print("jpeg features: " + json.dumps(result["fixtures"]) + " fixtures "
          "equal to expected.npz; " + str(len(JPEG_SKIP_FIXTURES)) +
          " skip-class files raise naming their feature")
    rates = group_decode_rates(groups)
    result["host_decode"] = rates
    print(f"host decode by path (one thread of {result['host_cpus']} CPUs,"
          f" best of {JPEG_DECODE_REPS} passes of {JPEG_FEATURE_DECODES} "
          f"decodes, beside {result['card']}): " + ", ".join(
              f"{g} {v['images_per_sec']:.0f} images/s "
              f"({v['megapixels_per_sec']:.2f} MP/s)"
              for g, v in rates.items()))

    # what generate_tree's skip rule costs: the header probe against the
    # probe as cv2 reads (markers and entropy data) on phase 11's .jpg tree
    jpg_tree = [str(p) for p in offline.tree_files(str(work / "jpeg" /
                                                       "clean"))]
    check(len(jpg_tree) == TREE_IMAGES, "phase 11's .jpg tree")
    probe_s = probe_seconds(jpg_tree)
    result["probe_jpg_tree_seconds"] = probe_s
    print(f"probe of phase 11's {len(jpg_tree)}-file .jpg tree (8 threads, "
          f"best of {JPEG_DECODE_REPS}): headers {probe_s['port']:.4f} s, "
          f"as cv2 reads {probe_s['cv2']:.4f} s")

    root = work / "jpeg_features"
    readable, mixed = root / "readable", root / "mixed"
    names = [n for g, ns in JPEG_FEATURE_GROUPS.items() if g != "baseline"
             for n in ns]
    files = [JPEG_FIXTURES / f"{n}.jpg" for n in names]
    skips = [JPEG_FIXTURES / "skip" / f"{n}.jpg" for n in JPEG_SKIP_FIXTURES]
    for k, p in enumerate(files + skips):
        for tree in ((readable, mixed) if p in files else (mixed,)):
            out = tree / f"c{k % 3}" / p.name
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_bytes(p.read_bytes())
    written = int(want["generate_tree_written"])
    dims = native.probe([str(p) for p in offline.tree_files(str(mixed))],
                        reader="cv2")
    sides = [tuple(d) for d in dims.tolist() if d[0] > 0]
    check(len(sides) == written, f"probe(reader='cv2') reads {len(sides)} "
          f"files; the reference reads {written}")
    launches = {"blur_sparse": 0, "blur_dense": 0, "fog_noise": 0}
    gen = {}
    for kind in JPEG_FEATURE_KINDS:
        buckets = tree_buckets(sides, offline.HALO.get(kind, 0))
        n_batches = sum(-(-n // TREE_BATCH) for n in buckets.values())
        lines = []
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        n = offline.generate_tree(str(mixed), str(root / kind), kind,
                                  seed=SEED, batch_size=TREE_BATCH,
                                  log=lines.append, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = _build.launch_counts()
        want_counts = {
            "blur_dense": n_batches if kind in ("blur", "compound") else 0,
            "blur_sparse": n_batches if kind == "blur_rand" else 0,
            "fog_noise": 0}
        skipped = len(files) + len(skips) - written
        check(n == written, f"generate_tree {kind} wrote {n}; the "
              f"reference writes {written}")
        check(f"Skipped {skipped} unreadable files" in lines,
              f"generate_tree {kind} log: {lines}")
        check(counts == want_counts, f"generate_tree {kind} launched "
              f"{counts}, expected {want_counts}")
        n_files = len(list((root / kind).glob("*/*")))
        check(n_files == written, f"generate_tree {kind}: {n_files} files")
        for k, v in counts.items():
            launches[k] += v
        gen[kind] = dict(images_per_sec=n / dt, seconds=dt, written=n,
                         skipped=skipped, batches=n_batches,
                         launches=counts)
        print(f"generate_tree {kind} on the feature fixtures: {n} written, "
              f"{skipped} skipped as the reference skips them, "
              f"{n / dt:.1f} images/s, {n_batches} batches, B2 "
              f"{counts['blur_sparse']} / B3 {counts['blur_dense']} "
              "launches")
    result["generate_tree"] = gen
    check(launches["blur_sparse"] > 0 and launches["blur_dense"] > 0,
          "B2 and B3 launched on the JPEG features path")

    n_readable = len(files)
    walks, evals = {}, {}
    _build.reset_launch_counts()
    old_backend = gtsrb.RESIZE_BACKEND
    try:
        for backend, resize in (("cv2", "device"), ("cv2", "host"),
                                ("pil", "device"), ("pil", "host")):
            gtsrb.set_resize_backend(backend)
            out = root / f"restored_{backend}_{resize}"
            res = infer.restore_tree(resunet, str(readable), str(out),
                                     clean_dir=str(readable),
                                     batch_size=BATCH, size=SIZE,
                                     resize=resize, log=quiet, device=dev)
            check(res["images"] == n_readable and math.isfinite(res["psnr"])
                  and 0 <= res["ssim"] <= 1,
                  f"restore_tree {backend} {resize}: {res}")
            ev = teval.evaluate_directory(judge, str(readable),
                                          batch_size=BATCH, size=SIZE,
                                          restorer=resunet, resize=resize,
                                          device=dev)
            check(ev["n"] == n_readable and 0 <= ev["top1"] <= 1
                  and math.isfinite(ev["confidence"]),
                  f"evaluate_directory {backend} {resize}: {ev}")
            key = f"{backend} {resize}"
            walks[key] = {k: res[k] for k in ("images_per_sec", "psnr",
                                              "ssim", "batches")}
            evals[key] = {k: ev[k] for k in ("n", "top1", "confidence",
                                             "images_per_sec")}
            print(f"restore_tree / evaluate_directory, {backend} backend, "
                  f"resize={resize}: {res['images']} images, PSNR "
                  f"{res['psnr']:.4f} dB, SSIM {res['ssim']:.5f}; top-1 "
                  f"{ev['top1']:.4f}, confidence {ev['confidence']:.6f}")
    finally:
        gtsrb.set_resize_backend(old_backend)
    a, b = root / "restored_pil_device", root / "restored_pil_host"
    check(all(p.read_bytes() == (b / p.relative_to(a)).read_bytes()
              for p in a.glob("*/*.png")) and len(list(a.glob("*/*.png")))
          == n_readable, "the PIL backend's device-asked restore_tree "
          "differs from its host run")
    dev_ev, host_ev = evals["pil device"], evals["pil host"]
    check(walks["pil device"]["psnr"] == walks["pil host"]["psnr"]
          and dev_ev["top1"] == host_ev["top1"]
          and abs(dev_ev["confidence"] - host_ev["confidence"]) <= 1e-6,
          "the PIL backend's device-asked walks differ from the host runs")
    check(sum(_build.launch_counts().values()) == 0,
          "the walks launch no blur or B1 kernel")
    result["restore_tree"] = walks
    result["evaluate_directory"] = evals
    result["launches"] = launches
    result["phase_seconds"] = time.perf_counter() - t_phase
    print("jpeg_features: " + json.dumps(result))
    return launches


def _png_chunk(tag, data):
    import struct
    import zlib
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data)))


def gray_png(w, h, rows=None):
    """A gray 8-bit PNG of ``rows`` (uint8 [h, w]), or with no rows its
    header alone (IHDR, then an IDAT of one filter byte, then IEND)."""
    import struct
    import zlib
    raw = b"\0" if rows is None else b"".join(
        b"\0" + rows[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw, 6))
            + _png_chunk(b"IEND", b""))


def tiff_header(w, h):
    """A gray TIFF of ``w`` x ``h`` whose one strip holds 4 bytes."""
    import struct
    entries = [(256, 4, w), (257, 4, h), (258, 3, 8), (259, 3, 1),
               (262, 3, 1), (273, 4, 8 + 2 + 12 * 9 + 4), (277, 3, 1),
               (278, 4, h), (279, 4, 4)]
    ifd = struct.pack("<H", len(entries)) + b"".join(
        struct.pack("<HHII" if t == 4 else "<HHIH2x", tag, t, 1, v)
        for tag, t, v in entries) + struct.pack("<I", 0)
    return b"II*\0" + struct.pack("<I", 8) + ifd + bytes(4)


def tiff_bytes(img, tile=None, bigtiff=False, big=False, jpeg=None):
    """A TIFF of uint8 RGB ``img`` [h, w, 3]: deflate strips of
    BUILT_TIFF_ROWS rows, or deflate ``tile`` = (width, length) tiles (edge
    tiles zero-padded); classic or BigTIFF, little or big endian; the IFD
    first. With ``jpeg``, a list of whole JPEG streams at 4:2:0, one a
    strip: JPEG compression (7) of YCbCr (photometric 6,
    YCbCrSubsampling 2, 2)."""
    import zlib
    import numpy as np
    h, w = img.shape[:2]
    if tile is None:
        chunks = [img[y:y + BUILT_TIFF_ROWS]
                  for y in range(0, h, BUILT_TIFF_ROWS)]
    else:
        tw, th = tile
        chunks = []
        for y in range(0, h, th):
            for x in range(0, w, tw):
                block = np.zeros((th, tw, 3), np.uint8)
                part = img[y:y + th, x:x + tw]
                block[:part.shape[0], :part.shape[1]] = part
                chunks.append(block)
    data = [zlib.compress(np.ascontiguousarray(c).tobytes()) for c in chunks]
    long_type = 16 if bigtiff else 4
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8, 8, 8]),
            259: (3, [8]), 262: (3, [2]), 277: (3, [3])}
    if jpeg is not None:
        data = list(jpeg)
        tags.update({259: (3, [7]), 262: (3, [6]), 530: (3, [2, 2])})
    if tile is None:
        tags.update({273: (long_type, None), 278: (4, [BUILT_TIFF_ROWS]),
                     279: (long_type, [len(d) for d in data])})
    else:
        tags.update({322: (3, [tile[0]]), 323: (3, [tile[1]]),
                     324: (long_type, None),
                     325: (long_type, [len(d) for d in data])})
    return tiff_layout(tags, data, bigtiff, big)


def tiff_layout(tags, data, bigtiff=False, big=False):
    """A TIFF of one IFD of ``tags`` {tag: (type, values)} (SHORT, LONG or
    LONG8 values; the tag whose values are None takes the offsets of the
    ``data`` chunks, one whose values are a function takes what it gives
    of the list of them), the IFD and its values first, then the chunks;
    classic or BigTIFF, little or big endian."""
    import struct
    e = ">" if big else "<"
    word = "Q" if bigtiff else "I"
    chars = {3: "H", 4: "I", 16: "Q"}
    inline = 8 if bigtiff else 4
    head = 16 if bigtiff else 8
    n = len(tags)
    values_at = head + (8 if bigtiff else 2) + n * (20 if bigtiff else 12) + inline
    arrays = {t: (v(list(range(len(data)))) if callable(v) else
                  v if v is not None else [0] * len(data))
              for t, (_, v) in tags.items()}
    sizes = {t: struct.calcsize(e + chars[tags[t][0]] * len(v))
             for t, v in arrays.items()}
    extra = sum(z for z in sizes.values() if z > inline)
    offset, offsets = values_at + extra, []
    for d in data:
        offsets.append(offset)
        offset += len(d)
    for t, (_, v) in tags.items():
        if v is None:
            arrays[t] = offsets
        elif callable(v):
            arrays[t] = v(offsets)
    ifd, values = [struct.pack(e + ("Q" if bigtiff else "H"), n)], b""
    for tag in sorted(tags):
        typ, v = tags[tag][0], arrays[tag]
        raw = struct.pack(e + chars[typ] * len(v), *v)
        if len(raw) <= inline:
            field = raw.ljust(inline, b"\0")
        else:
            field = struct.pack(e + word, values_at + len(values))
            values += raw
        ifd.append(struct.pack(e + "HH" + word, tag, typ, len(v)) + field)
    ifd.append(struct.pack(e + word, 0))
    start = ((b"MM\0+" if big else b"II+\0") + struct.pack(e + "HHQ", 8, 0, 16)
             if bigtiff else (b"MM\0*" if big else b"II*\0")
             + struct.pack(e + "I", 8))
    return start + b"".join(ifd) + values + b"".join(data)


# ITU-T T.4's run-length codes (Tables 2-4): the white and black terminating
# codes of runs 0-63, their make-up codes of 64-1728, and the extended
# make-up codes of 1792-2560, which both colours share
FAX_WHITE = """00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111
01000 001000 000011 110100 110101 101010 101011 0100111 0001100 0001000
0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 00000010
00000011 00011010 00011011 00010010 00010011 00010100 00010101 00010110
00010111 00101000 00101001 00101010 00101011 00101100 00101101 00000100
00000101 00001010 00001011 01010010 01010011 01010100 01010101 00100100
00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010
00110011 00110100 11011 10010 010111 0110111 00110110 00110111 01100100
01100101 01101000 01100111 011001100 011001101 011010010 011010011
011010100 011010101 011010110 011010111 011011000 011011001 011011010
011011011 010011000 010011001 010011010 011000 010011011""".split()
FAX_BLACK = """0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100
0000101 0000111 00000100 00000111 000011000 0000010111 0000011000
0000001000 00001100111 00001101000 00001101100 00000110111 00000101000
00000010111 00000011000 000011001010 000011001011 000011001100
000011001101 000001101000 000001101001 000001101010 000001101011
000011010010 000011010011 000011010100 000011010101 000011010110
000011010111 000001101100 000001101101 000011011010 000011011011
000001010100 000001010101 000001010110 000001010111 000001100100
000001100101 000001010010 000001010011 000000100100 000000110111
000000111000 000000100111 000000101000 000001011000 000001011001
000000101011 000000101100 000001011010 000001100110 000001100111
0000001111 000011001000 000011001001 000001011011 000000110011
000000110100 000000110101 0000001101100 0000001101101 0000001001010
0000001001011 0000001001100 0000001001101 0000001110010 0000001110011
0000001110100 0000001110101 0000001110110 0000001110111 0000001010010
0000001010011 0000001010100 0000001010101 0000001011010 0000001011011
0000001100100 0000001100101""".split()
FAX_EXTENDED = """00000001000 00000001100 00000001101 000000010010 000000010011
000000010100 000000010101 000000010110 000000010111 000000011100
000000011101 000000011110 000000011111""".split()
FAX_EOL = "000000000001"
# T.4's two-dimensional modes: pass, horizontal, and vertical by a1 - b1
FAX_PASS, FAX_HORIZONTAL = "0001", "001"
FAX_VERTICAL = {0: "1", 1: "011", 2: "000011", 3: "0000011", -1: "010",
                -2: "000010", -3: "0000010"}


def fax_run(run, black):
    """One run's code: make-up codes, then a terminating one."""
    table = FAX_BLACK if black else FAX_WHITE
    out = []
    while run >= 2560:
        out.append(FAX_EXTENDED[-1])
        run -= 2560
    if run >= 64:
        out.append(table[63 + run // 64] if run < 1792
                   else FAX_EXTENDED[run // 64 - 28])
    out.append(table[run % 64])
    return "".join(out)


def fax_changes(row):
    """A row's changing elements (bool, True black): the columns where the
    colour changes from the one before, the row starting white; an even
    index turns black."""
    import numpy as np
    r = np.concatenate(([0], row.astype(np.int8)))
    return np.flatnonzero(np.diff(r)).tolist()


def fax_row_1d(a, w):
    """T.4's one-dimensional coding of a row of changing elements ``a``:
    white and black runs in turn, from a white one."""
    out, x = [], 0
    for k, p in enumerate(a + [w]):
        out.append(fax_run(p - x, k % 2 == 1))
        x = p
    return "".join(out)


def fax_row_2d(a, b, w):
    """T.6's two-dimensional coding of a row's changing elements ``a``
    against the reference row's ``b``: pass, vertical or horizontal mode
    from a0 (before the row, white) to the row's end."""
    import bisect
    out, a0, color = [], -1, 0

    def at(lst, i):
        return lst[i] if i < len(lst) else w

    while a0 < w:
        i = bisect.bisect_right(a, a0)
        a1, a2 = at(a, i), at(a, i + 1)
        j = bisect.bisect_right(b, a0)
        j += j % 2 != color  # b1 turns to the colour a0's is not
        b1, b2 = at(b, j), at(b, j + 1)
        if b2 < a1:
            out.append(FAX_PASS)
            a0 = b2
        elif abs(a1 - b1) <= 3:
            out.append(FAX_VERTICAL[a1 - b1])
            a0, color = a1, 1 - color
        else:
            out.append(FAX_HORIZONTAL + fax_run(a1 - max(a0, 0), color == 1)
                       + fax_run(a2 - a1, color == 0))
            a0 = a2
    return "".join(out)


def fax_code(page, group4):
    """``page`` (bool [h, w], True black) coded as T.6 (group 4: 2-D rows,
    then EOFB) or as T.4 2-D (group 3: each row after an EOL and its tag
    bit, one-dimensional every FAX_K-th), MSB first, zero padded."""
    import numpy as np
    h, w = page.shape
    ref, bits = [], []
    for y in range(h):
        a = fax_changes(page[y])
        if group4:
            bits.append(fax_row_2d(a, ref, w))
        elif y % FAX_K == 0:
            bits.append(FAX_EOL + "1" + fax_row_1d(a, w))
        else:
            bits.append(FAX_EOL + "0" + fax_row_2d(a, ref, w))
        ref = a
    if group4:
        bits.append(FAX_EOL * 2)
    s = "".join(bits)
    s += "0" * (-len(s) % 8)
    return np.packbits(np.frombuffer(s.encode(), np.uint8) - 48).tobytes()


def fax_tiff(page, group4):
    """A little-endian TIFF of ``page`` (bool [h, w], True black): one
    MINISWHITE strip coded by fax_code, Compression 4, or 3 with
    Group3Options 1 (2-D)."""
    import struct
    h, w = page.shape
    strip = fax_code(page, group4)
    tags = [(256, 4, w), (257, 4, h), (258, 3, 1), (259, 3, 4 if group4 else 3),
            (262, 3, 0), (273, 4, 0), (277, 3, 1), (278, 4, h),
            (279, 4, len(strip))]
    if not group4:
        tags.append((292, 4, 1))
    at = 8 + 2 + 12 * len(tags) + 4
    ifd = struct.pack("<H", len(tags)) + b"".join(
        struct.pack("<HHII" if t == 4 else "<HHIH2x", tag, t, 1,
                    at if tag == 273 else v) for tag, t, v in tags)
    return b"II*\0" + struct.pack("<I", 8) + ifd + struct.pack("<I", 0) + strip


def fax_page(h, w, seed):
    """A page of text-like black strokes on white (bool [h, w], True black):
    lines of words, each word upright strokes of a few pixels' width,
    under a rule at the top."""
    import numpy as np
    rng = np.random.default_rng(seed)
    page = np.zeros((h, w), bool)
    page[80:84, 100:w - 100] = True
    y = 140
    while y + 32 < h - 100:
        x = 100
        while x < w - 160:
            for _ in range(int(rng.integers(2, 9))):
                sw, sh = int(rng.integers(2, 6)), int(rng.integers(12, 29))
                page[y + 28 - sh:y + 28, x:x + sw] = True
                x += sw + int(rng.integers(3, 9))
            x += int(rng.integers(14, 30))
        y += int(rng.integers(40, 56))
    return page


def built_ccitt_checks(work):
    """CCITT on files built here (the card's machine has no cv2 or PIL): a
    FAX_PAGE page (fax_page) as group 4 and as group 3 2-D (fax_tiff),
    each decoded equal to its bitmap (white 255, black 0) and probed at its
    size by both readers; their host decode rates (BUILT_TIFF_DECODES
    decodes on one thread, best of JPEG_DECODE_REPS passes). Returns the
    numbers for phase 13's line."""
    import numpy as np
    from tsr_tpu_torch import native
    root = work / "built_ccitt"
    root.mkdir(parents=True, exist_ok=True)
    h, w = FAX_PAGE
    page = fax_page(h, w, SEED)
    want = np.repeat(np.where(page, 0, 255).astype(np.uint8)[:, :, None], 3,
                     axis=2)
    out = {"black_share": float(page.mean())}
    for name, group4 in (("page_group4.png", True),
                         ("page_group3_2d.png", False)):
        p = root / name
        t0 = time.perf_counter()
        p.write_bytes(fax_tiff(page, group4))
        write_s = time.perf_counter() - t0
        check(np.array_equal(native.decode(str(p)), want),
              f"{name} decodes unlike the page it was built from")
        for reader in ("port", "cv2"):
            check(native.probe([str(p)], reader=reader).tolist() == [[h, w]],
                  f"{name}: probe({reader!r})")
        best = math.inf
        for _ in range(JPEG_DECODE_REPS):
            t0 = time.perf_counter()
            for _ in range(BUILT_TIFF_DECODES):
                native.decode(str(p))
            best = min(best, time.perf_counter() - t0)
        out[name] = {"bytes": p.stat().st_size, "write_s": write_s,
                     "images_per_sec": BUILT_TIFF_DECODES / best,
                     "megapixels_per_sec":
                         BUILT_TIFF_DECODES * h * w / best / 1e6}
    return out


def c11_image():
    """The seeded C11_SIZE RGB image of phase 12's C11 files: gradients
    under noise, whose JPEG data holds many FF bytes."""
    import numpy as np
    h, w = C11_SIZE
    y, x = np.mgrid[:h, :w]
    img = np.stack([(x * 2 + y) % 256, (y * 3) % 256, (x * y // 64) % 256], -1)
    noise = np.random.default_rng(C11_SEED).integers(0, 48, img.shape)
    return np.clip(img + noise, 0, 255).astype(np.uint8)


def c11_sites(data):
    """The FF 00 pairs of ``data``'s entropy data whose byte before is set
    to FF: the last before and the first after each 4096-byte boundary of
    the file (just before one, the stdio source's buffer holds fewer bytes
    than the fast pass of a 4:2:0 MCU needs, 3072; just after, more), and
    8 spread over the rest."""
    start = data.index(b"\xff\xda") + 2
    sites = [i for i in range(start, len(data) - 2)
             if data[i] == 0xFF and data[i + 1] == 0]
    chosen = set(sites[::max(1, len(sites) // 8)])
    for k in range(4096, len(data), 4096):
        before = [i for i in sites if i < k]
        after = [i for i in sites if i >= k]
        chosen.update(before[-1:] + after[:1])
    return sorted(chosen)


def c11_files(root):
    """{site: path} of phase 12's C11 files in ``root``: c11_image through
    the port's JPEG writer, one byte set to FF at each c11_sites site."""
    from tsr_tpu_torch import native
    root.mkdir(parents=True, exist_ok=True)
    src = root / "c11_source.jpg"
    native.write_images([str(src)], [c11_image()])
    data = src.read_bytes()
    out = {}
    for i in c11_sites(data):
        p = root / f"c11_{i}.jpg"
        p.write_bytes(data[:i - 1] + b"\xff" + data[i:])
        out[i] = p
    return out


def thunder_code(img):
    """ThunderScan code words of 4-bit ``img`` [h, w], row by row from a
    last pixel of 0: a run of the last pixel where 2 to 63 repeat it, two
    3-bit deltas where the next two pixels lie within 3 of the one before,
    three 2-bit deltas within 1 (the one deltas' codes, never a skip),
    else a raw value."""
    three = {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}
    two = {0: 0, 1: 1, -1: 3}
    out = bytearray()
    for row in img.tolist():
        last, i, n = 0, 0, len(row)
        while i < n:
            j = i
            while j < n and j - i < 63 and row[j] == last:
                j += 1
            d = [(row[k] - (last if k == i else row[k - 1]) + 8) % 16 - 8
                 for k in range(i, min(i + 3, n))]
            if j - i >= 2:
                out.append(j - i)
                i = j
                continue
            if len(d) == 3 and all(x in two for x in d):
                out.append(0x40 | two[d[0]] << 4 | two[d[1]] << 2 | two[d[2]])
            elif len(d) >= 2 and d[0] in three and d[1] in three:
                out.append(0x80 | three[d[0]] << 3 | three[d[1]])
                d = d[:2]
            else:
                out.append(0xC0 | row[i])
                d = d[:1]
            i += len(d)
            last = row[i - 1]
    return bytes(out)


def sgilog_code(words, planes):
    """SGILog byte planes of ``words`` [h, w] (uint32), each row on its own,
    its high plane first: runs of 3 to 129 equal bytes (a byte of 126 plus
    the count, then the byte), literal strings of at most 127 bytes (the
    count, then the bytes) between them."""
    import numpy as np
    out = bytearray()
    for row in words:
        for k in range(planes - 1, -1, -1):
            b = (row >> (8 * k) & 255).astype(np.uint8)
            edges = np.flatnonzero(np.diff(b)) + 1
            starts = [0] + edges.tolist()
            ends = edges.tolist() + [len(b)]
            lit = 0
            for a, z in zip(starts, ends):
                if z - a < 3:
                    continue
                for q in range(lit, a, 127):
                    out.append(min(127, a - q))
                    out += b[q:min(q + 127, a)].tobytes()
                while z - a >= 3:
                    m = min(129, z - a)
                    out += bytes([m + 126, int(b[a])])
                    a += m
                lit = a
            for q in range(lit, len(b), 127):
                out.append(min(127, len(b) - q))
                out += b[q:q + 127].tobytes()
    return bytes(out)


def tiff_2c_samples(kind, h, w, rng):
    """Seeded samples of ``kind`` [h, w]: 4-bit palette indices of a
    gradient with flat bands ("thunder"); LogL's sign and 15-bit log of Y
    ("logl": 0, negative and past Y = 1 among them); LogLuv32 words of
    that and 8-bit u', v' ("luv32"); LogLuv24 words of a 10-bit log and a
    14-bit colour index ("luv24": indices past the table's 16289 among
    them)."""
    import numpy as np
    y, x = np.mgrid[:h, :w]
    if kind == "thunder":
        img = (x * 16 // max(w, 2) + y // 3) % 16
        img[:, w // 3:w // 2] = 7
        return (img ^ (rng.random((h, w)) < 0.2)).astype(np.uint8)
    if kind == "luv24":
        L = (x * 1024 // w + y * 37 + rng.integers(0, 40, (h, w))) % 1024
        L[0, :2] = 0, 1023
        C = rng.integers(0, 16384, (h, w))
        C[-1, -4:] = (16288, 16289, 16290, 16383)
        return (L << 14 | C).astype(np.uint32)
    L = 13800 + x * 1800 // w + y * 900 // h + rng.integers(0, 64, (h, w))
    L[rng.random((h, w)) < 0.1] = 0
    neg = rng.random((h, w)) < 0.1
    L[neg] |= 0x8000
    L[0, 0] = 0x7FFF
    if kind == "logl":
        return L.astype(np.uint32)
    u = 60 + x * 110 // w + rng.integers(0, 8, (h, w))
    v = 80 + y * 140 // h + rng.integers(0, 8, (h, w))
    return (L << 16 | u << 8 | v).astype(np.uint32)


def tiff_2c_bytes(kind, samples, rows):
    """A little-endian TIFF of ``samples`` (tiff_2c_samples) in strips of
    ``rows`` rows: ThunderScan (32809) 4-bit palette data of a fixed
    ColorMap, or SGILog's LogL (32844 under 34676), LogLuv32 (32845 under
    34676) or LogLuv24 (32845 under 34677) with the 16-bit signed samples
    cv2.imwrite writes."""
    import numpy as np
    h, w = samples.shape
    strips = []
    for y in range(0, h, rows):
        block = samples[y:y + rows]
        strips.append(
            thunder_code(block) if kind == "thunder"
            else sgilog_code(block, 2 if kind == "logl" else 4)
            if kind != "luv24" else np.stack(
                [block >> 16, block >> 8, block], -1).astype(np.uint8).tobytes())
    spp = 3 if kind.startswith("luv") else 1
    tags = {256: (4, [w]), 257: (4, [h]), 273: (4, None), 277: (3, [spp]),
            278: (4, [rows]), 279: (4, [len(d) for d in strips]),
            284: (3, [1])}
    if kind == "thunder":
        k = np.arange(16)
        cmap = np.concatenate([k * 4369, (15 - k) * 4369, (k * 7 % 16) * 4369])
        tags.update({258: (3, [4]), 259: (3, [32809]), 262: (3, [3]),
                     320: (3, cmap.tolist())})
    else:
        tags.update({258: (3, [16] * spp), 339: (3, [2] * spp),
                     259: (3, [34677 if kind == "luv24" else 34676]),
                     262: (3, [32844 if kind == "logl" else 32845])})
    return tiff_layout(tags, strips)


def tiff_2c_files(root):
    """{name: path} of phase 13's ThunderScan and SGILog files in ``root``
    (TIFF_2C_FILES: the small ones of its tree, and the BUILT_TIFF_SIZE
    ones of its decode rates), from one seeded stream."""
    import numpy as np
    rng = np.random.default_rng(TIFF_2C_SEED)
    root.mkdir(parents=True, exist_ok=True)
    out = {}
    for name, (kind, h, w, rows) in TIFF_2C_FILES.items():
        out[name] = root / name
        out[name].write_bytes(tiff_2c_bytes(
            kind, tiff_2c_samples(kind, h, w, rng), rows))
    return out


def built_tiff_2c_checks(work):
    """ThunderScan and SGILog on files built here (tiff_2c_files; the
    card's machine has no cv2 or PIL): each decoded to its TIFF_2C_DIGESTS
    digest of cv2.imread's pixels and probed at its size by both readers;
    the host decode rates of the rate_2c_ files (BUILT_TIFF_DECODES
    decodes on one thread, best of JPEG_DECODE_REPS passes). Returns (the
    tiff_2c_ files' paths, the numbers for phase 13's line)."""
    import hashlib
    from tsr_tpu_torch import native
    t0 = time.perf_counter()
    files = tiff_2c_files(work / "built_tiff_2c")
    out = {"write_s": time.perf_counter() - t0}
    check(sorted(files) == sorted(TIFF_2C_DIGESTS),
          f"TIFF 2c files {sorted(files)}")
    for name, p in files.items():
        img = native.decode(str(p))
        h, w = TIFF_2C_FILES[name][1:3]
        check(img.shape == (h, w, 3) and hashlib.sha256(
            img.tobytes()).hexdigest() == TIFF_2C_DIGESTS[name],
            f"{name} decodes unlike cv2.imread")
        for reader in ("port", "cv2"):
            check(native.probe([str(p)], reader=reader).tolist() == [[h, w]],
                  f"{name}: probe({reader!r})")
        if not name.startswith("rate_2c_"):
            continue
        best = math.inf
        for _ in range(JPEG_DECODE_REPS):
            t0 = time.perf_counter()
            for _ in range(BUILT_TIFF_DECODES):
                native.decode(str(p))
            best = min(best, time.perf_counter() - t0)
        out[name] = {"bytes": p.stat().st_size, "images_per_sec":
                     BUILT_TIFF_DECODES / best, "megapixels_per_sec":
                     BUILT_TIFF_DECODES * h * w / best / 1e6}
    return [p for n, p in files.items() if n.startswith("tiff_2c_")], out


def scanline_rows(w, y0, y1, spp=1, bits=8, big=False):
    """Rows [y0, y1) of the scanline group's samples, [rows, w, spp]:
    (7 x + 3 y + 50 k) mod 256 (at 16 bits the high byte, with (5 x + 11 y
    + k) mod 256 the low one), in the file's byte order. They repeat every
    256 rows."""
    import numpy as np

    def mod256(a, b, c):  # (a x + b y + c k) mod 256, summed in uint8
        def term(n, start, stop):
            return ((n * np.arange(start, stop)) & 255).astype(np.uint8)
        return (term(a, 0, w)[None, :, None] + term(b, y0, y1)[:, None, None]
                + term(c, 0, spp)[None, None, :])
    v = mod256(7, 3, 50)
    if bits == 16:
        v = (v.astype(np.uint16) << 8) | mod256(5, 11, 1)
        return v.astype(">u2" if big else "<u2")
    return v


def scanline_deflate(h, block_of, period=256):
    """One zlib stream of ``h`` rows, those of rows [y0, y1) the bytes
    ``block_of(y0, y1)`` (rows that repeat every ``period``): the first
    block compressed once as raw deflate ended by Z_FULL_FLUSH, so that its
    bytes stand for every repeat, the rest of the rows after them, the
    Adler-32 of all rows at the end. Seconds, where zlib.compress of the
    rows takes many."""
    import zlib
    n = min(h, period)
    block = block_of(0, n)
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    body = co.compress(block) + co.flush(zlib.Z_FULL_FLUSH)
    repeats, rest = divmod(h, n)
    adler = 1
    for _ in range(repeats):
        adler = zlib.adler32(block, adler)
    tail = block[:rest * (len(block) // n)]
    adler = zlib.adler32(tail, adler)
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    return (b"\x78\x9c" + body * repeats + co.compress(tail) + co.flush()
            + struct.pack(">I", adler))


def scanline_tiff(w, h, spp=1, bits=8, photometric=1, tags=None, data=None,
                  compression=8, big=False):
    """A TIFF of one strip of the whole image (RowsPerStrip ``h``) of
    scanline_rows' samples: deflate (scanline_deflate), uncompressed with
    ``compression`` 1, or the strip ``data`` under ``compression``;
    ``tags`` {tag: (type, values)} added or replaced, or left out where
    None."""
    if data is None:
        def rows_of(y0, y1):
            return scanline_rows(w, y0, y1, spp, bits, big).tobytes()
        data = (scanline_deflate(h, rows_of) if compression == 8 else
                b"".join(rows_of(y, min(h, y + 256))
                         for y in range(0, h, 256)))
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp),
               259: (3, [compression]), 262: (3, [photometric]),
               273: (4, None), 277: (3, [spp]), 278: (4, [h]),
               279: (4, [len(data)])}
    entries.update(tags or {})
    return tiff_layout({t: v for t, v in entries.items() if v is not None},
                       [data], big=big)


def tiff_scanline_files(root):
    """{name: path} of phase 13's scanline group in ``root``
    (TIFF_SCANLINE_FILES at TIFF_SCANLINE_SIZE)."""
    h, w = TIFF_SCANLINE_SIZE
    root.mkdir(parents=True, exist_ok=True)
    out = {}
    data = scanline_deflate(h, lambda y0, y1: scanline_rows(
        w, y0, y1).tobytes())
    for name, (photometric, orientation, cut) in TIFF_SCANLINE_FILES.items():
        out[name] = root / name
        out[name].write_bytes(scanline_tiff(
            w, h, photometric=photometric,
            data=data[:len(data) // 2] if cut else data,
            tags={274: (3, [orientation])}))
    return out


# a child process that only decodes: its RSS after the import and its peak,
# VmHWM (its own memory map's high-water mark: Linux carries ru_maxrss
# across exec, so a child's would hold its parent's RSS at fork) where
# /proc has it, else VmRSS read every millisecond through the decode (the
# peak, the C image and its copy both held, lasts the copy)
SCANLINE_RSS_CHILD = """
import json, sys, threading, time
from tsr_tpu_torch import native
def status(key):
    for ln in open("/proc/self/status"):
        if ln.startswith(key + ":"):
            return int(ln.split()[1]) * 1024
native._lib()
rss = status("VmRSS")
polled, done = [rss], threading.Event()
def poll():
    while not done.is_set():
        polled.append(status("VmRSS"))
        time.sleep(0.001)
watch = threading.Thread(target=poll)
watch.start()
img = native.decode(sys.argv[1])
done.set()
watch.join()
hwm = status("VmHWM")
print(json.dumps({"rss_after_import": rss, "output_bytes": img.nbytes,
                  "peak_rss": hwm or max(polled),
                  "peak_from": "VmHWM" if hwm else "VmRSS polled"}))
"""


def tiff_scanline_checks(dev, resunet, judge, rows, work):
    """The scanline group (TIFF part 2d) on files built here
    (tiff_scanline_files; the card's machine has no cv2): the MINISWHITE
    and orientation-3 files decoded to their TIFF_SCANLINE_DIGESTS (as
    stored: no inversion, no flip) and probed at their size by both
    readers, the half-deflate file probed (0, 0) by the cv2 reader with its
    decode raising; the MINISWHITE file's decode time (best of
    TIFF_SCANLINE_DECODES) and the peak RSS of a child that only decodes
    it, held to twice the output plus the file plus 64 MiB; then, in a
    tree of its own, generate_tree for blur and blur_rand (launch counts
    zeroed just before and read just after each call: one B3 and one B2
    batch at the new bucket), restore_tree and evaluate_directory, and B3
    and B2 held against filter2d_plain at that bucket (check_blur_at_buckets:
    the tiff_scanline_times of the B2 and B3 rows). Sets each row's
    launches_tiff_scanline; returns (the numbers for phase 13's line, the
    launches)."""
    import hashlib
    import numpy as np
    import torch
    from tsr_tpu_torch import eval as teval
    from tsr_tpu_torch import infer, native, offline
    from tsr_tpu_torch.kernels import _build
    h, w = TIFF_SCANLINE_SIZE
    t0 = time.perf_counter()
    files = tiff_scanline_files(work / "tiff_scanline" / "files")
    out = {"write_s": time.perf_counter() - t0,
           "file_bytes": {n: p.stat().st_size for n, p in files.items()}}
    for name, p in files.items():
        if name in TIFF_SCANLINE_DIGESTS:
            img = native.decode(str(p))
            check(img.shape == (h, w, 3) and hashlib.sha256(
                img.tobytes()).hexdigest() == TIFF_SCANLINE_DIGESTS[name],
                f"{name} decodes unlike cv2.imread")
            del img
            for reader in ("port", "cv2"):
                check(native.probe([str(p)], reader=reader).tolist()
                      == [[h, w]], f"{name}: probe({reader!r})")
            continue
        check(native.probe([str(p)], reader="cv2").tolist() == [[0, 0]],
              f"{name}: probe(reader='cv2') reads what cv2 refuses")
        try:
            native.decode(str(p))
        except RuntimeError as e:
            check("failed to decode" in str(e), f"{name}: {e}")
        else:
            check(False, f"{name} decoded; cv2 and PIL refuse it")
    ms_file = files["tiff_scanline_miniswhite.jpg"]
    best = math.inf
    for _ in range(TIFF_SCANLINE_DECODES):
        t0 = time.perf_counter()
        native.decode(str(ms_file))
        best = min(best, time.perf_counter() - t0)
    out["decode"] = {"seconds": best, "megapixels_per_sec": h * w / best / 1e6}
    proc = subprocess.run([sys.executable, "-c", SCANLINE_RSS_CHILD,
                           str(ms_file)], capture_output=True, text=True,
                          cwd=str(REPO), timeout=300)
    check(proc.returncode == 0, f"decode child failed: {proc.stderr[-2000:]}")
    rss = json.loads(proc.stdout.strip().splitlines()[-1])
    grown = rss["peak_rss"] - rss["rss_after_import"]
    allowed = 2 * rss["output_bytes"] + ms_file.stat().st_size + 64 * 2**20
    check(grown <= allowed, f"decode child grew by {grown} bytes; allowed "
          f"{allowed}")
    out["decode_rss"] = dict(rss, grown=grown, allowed=allowed)

    tree = work / "tiff_scanline" / "tree"
    (tree / "c0").mkdir(parents=True, exist_ok=True)
    shutil.copy(ms_file, tree / "c0" / ms_file.name)
    launches = {"blur_sparse": 0, "blur_dense": 0, "fog_noise": 0}
    gen = {}
    for kind in ("blur", "blur_rand"):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        n = offline.generate_tree(str(tree),
                                  str(work / "tiff_scanline" / kind), kind,
                                  seed=SEED, batch_size=TREE_BATCH,
                                  log=lambda line: None, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = _build.launch_counts()
        want = {"blur_dense": int(kind == "blur"),
                "blur_sparse": int(kind == "blur_rand"), "fog_noise": 0}
        check(n == 1 and counts == want, f"generate_tree {kind}: {n} "
              f"written, launches {counts}, expected {want}")
        written = next((work / "tiff_scanline" / kind).glob("*/*"))
        check(tuple(native.probe([str(written)])[0]) == (h, w),
              f"generate_tree {kind} wrote {written.name} at another size")
        for k, v in counts.items():
            launches[k] += v
        gen[kind] = {"seconds": dt, "launches": counts,
                     "bucket": [offline._bucket_with_room(
                         s, offline.HALO.get(kind, 0)) for s in (h, w)]}
    out["generate_tree"] = gen
    quiet = lambda line: None  # noqa: E731
    _build.reset_launch_counts()
    res = infer.restore_tree(resunet, str(tree), str(work / "tiff_scanline"
                                                     / "restored"),
                             clean_dir=str(tree), batch_size=BATCH, size=SIZE,
                             log=quiet, device=dev)
    check(res["images"] == 1 and math.isfinite(res["psnr"]),
          f"restore_tree: {res}")
    ev = teval.evaluate_directory(judge, str(tree), batch_size=BATCH,
                                  size=SIZE, restorer=resunet, device=dev)
    check(ev["n"] == 1 and math.isfinite(ev["confidence"]),
          f"evaluate_directory: {ev}")
    check(sum(_build.launch_counts().values()) == 0,
          "the walks launch no blur or B1 kernel")
    out["restore_tree"] = {k: res[k] for k in ("psnr", "ssim")}
    out["evaluate_directory"] = {k: ev[k] for k in ("top1", "confidence")}
    check_blur_at_buckets(dev, [ms_file], rows, key="tiff_scanline_times")
    for row in rows:
        row["launches_tiff_scanline"] = launches[{
            "B1": "fog_noise", "B2": "blur_sparse",
            "B3": "blur_dense"}[row["name"][:2]]]
    return out, launches


def jpeg_segments(stream):
    """A JPEG stream's marker segments up to its first scan, [(marker,
    payload past the length)], then ("data", the bytes after the SOS
    segment)."""
    import struct
    out, i = [], 2
    while i + 4 <= len(stream):
        m = stream[i + 1]
        n = struct.unpack(">H", stream[i + 2:i + 4])[0]
        out.append((m, stream[i + 4:i + 2 + n]))
        i += 2 + n
        if m == 0xDA:
            out.append(("data", stream[i:]))
            break
    return out


def ojpeg_bytes(stream, h, w, layout, rps=None, photometric=6, tags=None):
    """A little-endian old-style JPEG TIFF (Compression 6) of the baseline
    ``stream`` (its frame ``w`` x ``h``, 1 or 3 components): ``layout``
    "stream" points JPEGInterchangeFormat and one strip at the whole
    stream; "tables" puts the quantisation and Huffman tables (the first
    and last of each kind: luma, then the chroma tables both chroma
    components share) at JPEGQTables, JPEGDCTables and JPEGACTables and
    the entropy-coded data in strips of ``rps`` rows, cut at its restart
    markers (the codec writes them again); ``tags`` added or replaced."""
    import re
    segs = jpeg_segments(stream)
    spp = next(p[5] for m, p in segs if m in (0xC0, 0xC1))
    tags_ = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * spp),
             259: (3, [6]), 262: (3, [photometric]), 277: (3, [spp])}
    if layout == "stream":
        chunks = [stream]
        tags_.update({273: (4, lambda o: [o[0]]), 278: (4, [h]),
                      279: (4, [len(stream)]), 513: (4, lambda o: [o[0]]),
                      514: (4, [len(stream)])})
    else:
        data = segs[-1][1]
        if data.endswith(b"\xff\xd9"):
            data = data[:-2]
        strips = re.split(rb"\xff[\xd0-\xd7]", data)
        n = len(strips)
        qts = [p[1:65] for m, p in segs if m == 0xDB]
        dhts = [p for m, p in segs if m == 0xC4]
        dc = [p[1:] for p in dhts if p[0] < 16]
        ac = [p[1:] for p in dhts if p[0] >= 16]
        chunks = strips + [qts[0], qts[-1], dc[0], dc[-1], ac[0], ac[-1]]
        comp = [0] + [1] * (spp - 1)
        tags_.update({
            273: (4, lambda o: o[:n]), 278: (4, [rps or h]),
            279: (4, [len(x) for x in strips]), 512: (3, [1]),
            519: (4, lambda o: [o[n + k] for k in comp]),
            520: (4, lambda o: [o[n + 2 + k] for k in comp]),
            521: (4, lambda o: [o[n + 4 + k] for k in comp])})
    tags_.update(tags or {})
    return tiff_layout(tags_, chunks)


def pack_i12(rows):
    """Each row of 12-bit samples (``rows``, [n, w], 0..4095) packed most
    significant bit first and padded to a byte: a list of n bytes."""
    packed = []
    for r in rows:
        bits = "".join(f"{int(a):012b}" for a in r)
        bits += "0" * (-len(bits) % 8)
        packed.append(bytes(int(bits[i:i + 8], 2)
                            for i in range(0, len(bits), 8)))
    return packed


def fp_predictor_bytes(block):
    """``block`` ([n, w] floats) under TIFF's floating-point predictor
    (3): each row's bytes split into planes, most significant first, and
    differenced byte by byte."""
    import numpy as np
    n, w = block.shape
    be = block.astype(block.dtype.newbyteorder(">"))
    planes = be.view(np.uint8).reshape(n, w, be.itemsize).transpose(
        0, 2, 1).reshape(n, -1)
    d = planes.astype(np.int64)
    d[:, 1:] -= planes[:, :-1]
    return (d & 255).astype(np.uint8).tobytes()


# the WebP lossless distance map: (dx, dy) of distance codes 1-120
VP8L_PLANE = (
    (0, 1), (1, 0), (1, 1), (-1, 1), (0, 2), (2, 0), (1, 2), (-1, 2),
    (2, 1), (-2, 1), (2, 2), (-2, 2), (0, 3), (3, 0), (1, 3), (-1, 3),
    (3, 1), (-3, 1), (2, 3), (-2, 3), (3, 2), (-3, 2), (0, 4), (4, 0),
    (1, 4), (-1, 4), (4, 1), (-4, 1), (3, 3), (-3, 3), (2, 4), (-2, 4),
    (4, 2), (-4, 2), (0, 5), (3, 4), (-3, 4), (4, 3), (-4, 3), (5, 0),
    (1, 5), (-1, 5), (5, 1), (-5, 1), (2, 5), (-2, 5), (5, 2), (-5, 2),
    (4, 4), (-4, 4), (3, 5), (-3, 5), (5, 3), (-5, 3), (0, 6), (6, 0),
    (1, 6), (-1, 6), (6, 1), (-6, 1), (2, 6), (-2, 6), (6, 2), (-6, 2),
    (4, 5), (-4, 5), (5, 4), (-5, 4), (3, 6), (-3, 6), (6, 3), (-6, 3),
    (0, 7), (7, 0), (1, 7), (-1, 7), (5, 5), (-5, 5), (7, 1), (-7, 1),
    (4, 6), (-4, 6), (6, 4), (-6, 4), (2, 7), (-2, 7), (7, 2), (-7, 2),
    (3, 7), (-3, 7), (7, 3), (-7, 3), (5, 6), (-5, 6), (6, 5), (-6, 5),
    (8, 0), (4, 7), (-4, 7), (7, 4), (-7, 4), (8, 1), (8, 2), (6, 6),
    (-6, 6), (8, 3), (5, 7), (-5, 7), (7, 5), (-7, 5), (8, 4), (6, 7),
    (-6, 7), (7, 6), (-7, 6), (8, 5), (7, 7), (-7, 7), (8, 6), (8, 7))
VP8L_CODE_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12,
                   13, 14, 15)


def vp8l_code_lengths(freq, limit):
    """Lengths of a complete prefix code over the symbols of ``freq`` (a
    list of counts) that occur, none over ``limit`` bits (Huffman's, its
    counts halved until it fits); one symbol gets length 1."""
    import heapq
    used = [s for s, f in enumerate(freq) if f]
    lens = [0] * len(freq)
    if len(used) == 1:
        lens[used[0]] = 1
        return lens
    weights = {s: freq[s] for s in used}
    while True:
        heap = [(w, i, (s,)) for i, (s, w) in enumerate(weights.items())]
        heapq.heapify(heap)
        depth = dict.fromkeys(used, 0)
        tie = len(heap)
        while len(heap) > 1:
            w1, _, a = heapq.heappop(heap)
            w2, _, b = heapq.heappop(heap)
            for s in a + b:
                depth[s] += 1
            heapq.heappush(heap, (w1 + w2, tie, a + b))
            tie += 1
        if max(depth.values()) <= limit:
            break
        weights = {s: (w >> 1) | 1 for s, w in weights.items()}
    for s, d in depth.items():
        lens[s] = d
    return lens


def vp8l_canonical(lens):
    """{symbol: (code, length)} of the canonical code of ``lens``, each code
    bit-reversed, as a least-significant-bit-first writer puts it down."""
    out, code, prev = {}, 0, 0
    for length, s in sorted((l, s) for s, l in enumerate(lens) if l):
        code <<= length - prev
        prev = length
        out[s] = (int(f"{code:0{length}b}"[::-1], 2), length)
        code += 1
    return out


class VP8LBits:
    """Values and their widths, least significant bit first."""

    def __init__(self):
        self.vals, self.widths = [], []

    def put(self, value, width):
        if width:
            self.vals.append(int(value))
            self.widths.append(int(width))

    def put_many(self, values, widths):
        import numpy as np
        keep = np.asarray(widths) > 0
        self.vals.extend(np.asarray(values)[keep].tolist())
        self.widths.extend(np.asarray(widths)[keep].tolist())

    def tobytes(self):
        import numpy as np
        vals = np.asarray(self.vals, np.uint64)
        widths = np.asarray(self.widths, np.int64)
        starts = np.cumsum(widths) - widths
        bits = np.zeros(int(widths.sum()), np.uint8)
        for lo in range(0, len(widths), 1 << 20):  # a million values a pass
            w = widths[lo:lo + (1 << 20)]
            at = np.repeat(starts[lo:lo + len(w)], w)
            k = np.arange(len(at)) - np.repeat(np.cumsum(w) - w, w)
            bits[at + k] = (np.repeat(vals[lo:lo + len(w)], w)
                            >> k.astype(np.uint64)) & 1
        return np.packbits(bits, bitorder="little").tobytes()


def vp8l_prefix(v):
    """(prefix symbol, extra bits, extra value) of a length or distance
    code ``v`` >= 1."""
    v -= 1
    if v < 4:
        return v, 0, 0
    h = v.bit_length() - 1
    second = (v >> (h - 1)) & 1
    return 2 * h + second, h - 1, v & ((1 << (h - 1)) - 1)


def vp8l_length_tokens(lens, last):
    """Code lengths 0..``last`` as code-length symbols (symbol, extra bits,
    extra value): literal lengths, 16 (the last nonzero length, at first
    8, again 3-6 times), 17 (3-10 zeros) and 18 (11-138 zeros)."""
    tokens, i, prev = [], 0, 8
    while i <= last:
        v, run = lens[i], 1
        while i + run <= last and lens[i + run] == v:
            run += 1
        i += run
        if v == 0:
            while run >= 11:
                k = min(run, 138)
                tokens.append((18, 7, k - 11))
                run -= k
            if run >= 3:
                tokens.append((17, 3, run - 3))
                run = 0
            tokens += [(0, 0, 0)] * run
            continue
        if v != prev:
            tokens.append((v, 0, 0))
            prev = v
            run -= 1
        while run >= 3:
            k = min(run, 6)
            tokens.append((16, 2, k - 3))
            run -= k
        tokens += [(v, 0, 0)] * run
    return tokens


def vp8l_write_code(bw, freq, simple=True, max_symbol=False, lens=None):
    """A prefix code for the counts ``freq`` (its alphabet their length):
    a simple code where one or two symbols below 256 occur (and
    ``simple``), else a normal code of Huffman lengths under a code-length
    code (its repeat codes 16, 17 and 18 where runs allow, ``max_symbol``
    writes the number of code-length symbols read). Returns {symbol:
    (code, length)}; an alphabet nothing uses gets symbol 0. ``lens``, where
    given, are written as they are, valid or not."""
    used = [s for s, f in enumerate(freq) if f]
    if not used:
        freq = [1] + list(freq[1:])
        used = [0]
    if lens is not None:
        used = [s for s, n in enumerate(lens) if n] or [0]
        simple = False
    if simple and len(used) <= 2 and max(used) < 256:
        bw.put(1, 1)
        bw.put(len(used) - 1, 1)
        if used[0] < 2:
            bw.put(0, 1)
            bw.put(used[0], 1)
        else:
            bw.put(1, 1)
            bw.put(used[0], 8)
        if len(used) == 2:
            bw.put(used[1], 8)
        if len(used) == 1:
            return {used[0]: (0, 0)}
        return {used[0]: (0, 1), used[1]: (1, 1)}
    if lens is None:
        lens = vp8l_code_lengths(freq, 15)
    if len(used) == 1:
        codes = {used[0]: (0, 0)}
    else:
        codes = vp8l_canonical(lens)
    tokens = vp8l_length_tokens(lens, max(used) if max_symbol
                                else len(lens) - 1)
    if len(tokens) < 2:
        max_symbol = False
        tokens = vp8l_length_tokens(lens, len(lens) - 1)
    cl_freq = [0] * 19
    for s, _, _ in tokens:
        cl_freq[s] += 1
    cl_lens = vp8l_code_lengths(cl_freq, 7)
    cl_codes = ({s: (0, 0) for s in range(19) if cl_freq[s]}
                if sum(1 for f in cl_freq if f) == 1
                else vp8l_canonical(cl_lens))
    n = max(4, max(k + 1 for k, s in enumerate(VP8L_CODE_ORDER)
                   if cl_lens[s]))
    bw.put(0, 1)
    bw.put(n - 4, 4)
    for s in VP8L_CODE_ORDER[:n]:
        bw.put(cl_lens[s], 3)
    if max_symbol:
        k = 0
        while len(tokens) - 2 >= 1 << (2 + 2 * k):
            k += 1
        bw.put(1, 1)
        bw.put(k, 3)
        bw.put(len(tokens) - 2, 2 + 2 * k)
    else:
        bw.put(0, 1)
    for s, nbits, extra in tokens:
        bw.put(*cl_codes[s])
        bw.put(extra, nbits)
    return codes


def vp8l_tokens(argb, w, cache_bits, lz77, dist_mode):
    """The pixels ``argb`` (uint32, row-major, ``w`` wide) as literals,
    backward references (greedy, the longest among the distance map's
    distances and a few others, 3 to 4096 pixels, overlapping where the
    distance is shorter) and colour cache hits: a list of ("lit", argb) /
    ("copy", length, distance code) / ("cache", key), each with the pixel
    index it starts at."""
    import numpy as np
    n = len(argb)
    best_len = np.zeros(n, np.int64)
    best_code = np.zeros(n, np.int64)
    if lz77 and n > 3:
        cands = {}
        if dist_mode in ("map", "both"):
            for c, (dx, dy) in enumerate(VP8L_PLANE, 1):
                d = max(dx + dy * w, 1)
                cands.setdefault(d, c)
        if dist_mode in ("plain", "both"):
            for d in (1, 2, 3, w, w + 1, 2 * w, 3 * w + 2, 7, 64):
                if dist_mode == "plain" or d not in cands:
                    cands[d] = d + 120
        idx = np.arange(n)
        for d, code in sorted(cands.items()):
            if d >= n:
                continue
            match = np.zeros(n + 1, bool)
            match[d:n] = argb[d:] == argb[:-d]
            fail = np.where(~match, np.arange(n + 1), n + 1)
            nxt = np.minimum.accumulate(fail[::-1])[::-1][:n]
            run = np.minimum(nxt - idx, 4096)
            better = run > best_len
            best_len[better] = run[better]
            best_code[better] = code
    if cache_bits:
        hashes = ((argb.astype(np.uint64) * 0x1e35a7bd) & 0xffffffff) >> (
            32 - cache_bits)
        hashes = hashes.astype(np.int64).tolist()
        cache = [0] * (1 << cache_bits)
    px = argb.tolist()
    bl, bc = best_len.tolist(), best_code.tolist()
    out, i, cached = [], 0, 0
    while i < n:
        if cache_bits:
            for k in range(cached, i):
                cache[hashes[k]] = px[k]
            cached = i
        if bl[i] >= 3:
            out.append(("copy", i, min(bl[i], n - i), bc[i]))
            i += out[-1][2]
        elif cache_bits and cache[hashes[i]] == px[i]:
            out.append(("cache", i, hashes[i]))
            i += 1
        else:
            out.append(("lit", i, px[i]))
            i += 1
    return out


def vp8l_image(bw, argb, w, h, level0, cache_bits=0, meta_bits=0,
                meta_groups=1, lz77=True, dist_mode="map", simple=True,
                max_symbol=False, tokens=None, code_lens=None):
    """One VP8L image stream of ``argb`` (uint32 [h * w]): the colour cache
    bit, the meta bit and entropy image (``level0`` only; block (by, bx)
    of 2^meta_bits pixels takes group 3 x ((by x blocks + bx) mod
    meta_groups), so groups between go unused), five prefix codes a group,
    then the coded pixels: ``tokens`` ([("lit", argb) or ("copy", length,
    distance code)]) in place of the matcher's, ``code_lens`` ({code:
    lengths}) in place of group 0's Huffman lengths."""
    import numpy as np
    if cache_bits:
        bw.put(1, 1)
        bw.put(cache_bits, 4)
    else:
        bw.put(0, 1)
    group_of = None
    if level0:
        if meta_bits:
            bw.put(1, 1)
            bw.put(meta_bits - 2, 3)
            mw = -(-w // (1 << meta_bits))
            mh = -(-h // (1 << meta_bits))
            block = np.arange(mw * mh) % meta_groups * 3
            vp8l_image(bw, (0xff000000 | (block >> 8) << 16
                             | (block & 0xff) << 8).astype(np.uint32),
                        mw, mh, False)
            group_of = block.reshape(mh, mw)
        else:
            bw.put(0, 1)
    if tokens is None:
        tokens = vp8l_tokens(np.asarray(argb, np.uint32), w, cache_bits,
                             lz77, dist_mode)
    else:
        placed, i = [], 0
        for t in tokens:
            placed.append((t[0], i) + tuple(t[1:]))
            i += t[1] if t[0] == "copy" else 1
        tokens = placed
    n_groups = int(group_of.max()) + 1 if group_of is not None else 1
    alphabet = (280 + ((1 << cache_bits) if cache_bits else 0), 256, 256,
                256, 40)
    hist = [[[0] * a for a in alphabet] for _ in range(n_groups)]
    coded = []
    for t in tokens:
        i = t[1]
        g = int(group_of[(i // w) >> meta_bits, (i % w) >> meta_bits]) if (
            group_of is not None) else 0
        hg = hist[g]
        if t[0] == "lit":
            p = t[2]
            syms = ((p >> 8) & 0xff, (p >> 16) & 0xff, p & 0xff, p >> 24)
            for j, s in enumerate(syms):
                hg[j][s] += 1
            coded.append((g, "lit", syms))
        elif t[0] == "copy":
            ls, lb, lv = vp8l_prefix(t[2])
            ds, db, dv = vp8l_prefix(t[3])
            hg[0][256 + ls] += 1
            hg[4][ds] += 1
            coded.append((g, "copy", (ls, lb, lv, ds, db, dv)))
        else:
            hg[0][280 + t[2]] += 1
            coded.append((g, "cache", 280 + t[2]))
    code_lens = code_lens or {}
    codes = [[vp8l_write_code(bw, hist[g][j], simple, max_symbol,
                              code_lens.get(j) if g == 0 else None)
              for j in range(5)] for g in range(n_groups)]
    vals, widths = [], []
    for g, kind, v in coded:
        c = codes[g]
        if kind == "lit":
            for j, s in zip((0, 1, 2, 3), v):
                code, length = c[j][s]
                vals.append(code)
                widths.append(length)
        elif kind == "copy":
            ls, lb, lv, ds, db, dv = v
            for code, length in (c[0][256 + ls], (lv, lb), c[4][ds], (dv, db)):
                vals.append(code)
                widths.append(length)
        else:
            code, length = c[0][v]
            vals.append(code)
            widths.append(length)
    bw.put_many(vals, widths)


def vp8l_argb(img):
    import numpy as np
    img = np.asarray(img, np.uint8)
    if img.shape[2] == 3:
        img = np.concatenate([img, np.full(img.shape[:2] + (1,), 255,
                                           np.uint8)], 2)
    a, r, g, b = (img[..., k].astype(np.uint32) for k in (3, 0, 1, 2))
    return a << 24 | r << 16 | g << 8 | b


def vp8l_bytes_of(argb):
    """[..., 4] uint8 (B, G, R, A) of uint32 ARGB."""
    import numpy as np
    return np.ascontiguousarray(argb, np.uint32).view(np.uint8).reshape(
        argb.shape + (4,))


def vp8l_predict(mode, left, top, topright, topleft):
    """lossless.c's predictor ``mode`` on [..., 4] int arrays (14, 15 and
    0: opaque black)."""
    import numpy as np
    avg = lambda a, b: (a + b) >> 1  # noqa: E731
    clip = lambda v: np.clip(v, 0, 255)  # noqa: E731
    if mode == 1:
        return left
    if mode == 2:
        return top
    if mode == 3:
        return topright
    if mode == 4:
        return topleft
    if mode == 5:
        return avg(avg(left, topright), top)
    if mode == 6:
        return avg(left, topleft)
    if mode == 7:
        return avg(left, top)
    if mode == 8:
        return avg(topleft, top)
    if mode == 9:
        return avg(top, topright)
    if mode == 10:
        return avg(avg(left, topleft), avg(top, topright))
    if mode == 11:
        pa = (np.abs(left - topleft) - np.abs(top - topleft)).sum(
            -1, keepdims=True)
        return np.where(pa <= 0, top, left)
    if mode == 12:
        return clip(left + top - topleft)
    if mode == 13:
        a = avg(left, top)
        return clip(a + np.trunc((a - topleft) / 2).astype(a.dtype))
    out = np.zeros_like(left)
    out[..., 3] = 255
    return out


def vp8l_delta(pred, color):
    import numpy as np
    return (pred.astype(np.int64) * color.astype(np.int64)) >> 5


def vp8l_bytes(img, transforms=(), cache_bits=0, meta_bits=0, meta_groups=2,
               lz77=True, dist_mode="map", simple=True, max_symbol=False,
               sub_cache_bits=0, tokens=None, code_lens=None):
    """A WebP lossless (VP8L) bitstream of ``img`` (uint8 [h, w, 3] RGB or
    [h, w, 4] RGBA), with the features asked for; it need not compress
    well. ``transforms``, in the order written (each once): ("green",)
    subtract-green; ("predictor", bits, modes) with ``modes`` an int array
    of one mode (0-15) a 2^bits block; ("cross", bits, multipliers) with
    ``multipliers`` an int array [blocks_y, blocks_x, 3] of int8
    green-to-red, green-to-blue and red-to-blue; ("palette",) colour
    indexing over the image's colours (256 at most), 1, 2, 4 or 8 pixels a
    byte by their count. ``cache_bits`` (1-11) a colour cache on the main
    image, ``sub_cache_bits`` one on each sub-image; ``meta_bits`` (2-9)
    meta prefix codes, ``meta_groups`` of them; ``lz77`` backward
    references, by the distance map's codes ("map"), plain distances
    ("plain") or both; ``simple`` simple codes where one or two symbols
    below 256 occur; ``max_symbol`` the code-length count written;
    ``tokens`` and ``code_lens`` the main image's own (vp8l_image), to
    write damaged streams."""
    import numpy as np
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    argb = vp8l_argb(img)
    bw = VP8LBits()
    bw.put(0x2f, 8)
    bw.put(w - 1, 14)
    bw.put(h - 1, 14)
    bw.put(int((argb >> 24 != 255).any()), 1)  # the alpha hint
    bw.put(0, 3)
    sub = dict(cache_bits=sub_cache_bits, lz77=lz77, dist_mode=dist_mode,
               simple=simple, max_symbol=max_symbol)
    cur = argb
    for t in transforms:
        cw = cur.shape[1]
        bw.put(1, 1)
        if t[0] == "green":
            bw.put(2, 2)
            px = vp8l_bytes_of(cur).copy()
            px[..., 0] -= px[..., 1]
            px[..., 2] -= px[..., 1]
            cur = px.view(np.uint32)[..., 0]
        elif t[0] == "predictor":
            _, bits, modes = t
            modes = np.asarray(modes, np.int64)
            bw.put(0, 2)
            bw.put(bits - 2, 3)
            vp8l_image(bw, (0xff000000 | modes.ravel() << 8).astype(
                np.uint32), modes.shape[1], modes.shape[0], False, **sub)
            p = vp8l_bytes_of(cur).astype(np.int64)
            hh, ww = p.shape[:2]
            left = np.zeros_like(p)
            left[:, 1:] = p[:, :-1]
            top = np.zeros_like(p)
            top[1:] = p[:-1]
            topleft = np.zeros_like(p)
            topleft[1:, 1:] = p[:-1, :-1]
            topright = np.zeros_like(p)
            topright[1:, :-1] = p[:-1, 1:]
            topright[1:, -1] = p[1:, 0]
            pix_mode = np.repeat(np.repeat(modes, 1 << bits, 0), 1 << bits,
                                 1)[:hh, :ww]
            pred = np.zeros_like(p)
            for m in np.unique(pix_mode):
                sel = pix_mode == m
                pred[sel] = vp8l_predict(int(m), left, top, topright,
                                     topleft)[sel]
            pred[1:, 0] = p[:-1, 0]
            pred[0, 1:] = p[0, :-1]
            pred[0, 0] = (0, 0, 0, 255)
            cur = ((p - pred) & 255).astype(np.uint8).view(np.uint32)[..., 0]
        elif t[0] == "cross":
            _, bits, mult = t
            mult = np.asarray(mult, np.int64)
            bw.put(1, 2)
            bw.put(bits - 2, 3)
            g2r, g2b, r2b = (mult[..., k] & 255 for k in range(3))
            vp8l_image(bw, (0xff000000 | r2b << 16 | g2b << 8 | g2r).ravel(
            ).astype(np.uint32), mult.shape[1], mult.shape[0], False, **sub)
            m = np.repeat(np.repeat(mult, 1 << bits, 0), 1 << bits,
                          1)[:cur.shape[0], :cur.shape[1]].astype(np.int8)
            px = vp8l_bytes_of(cur).copy()
            green = px[..., 1].view(np.int8)
            red = px[..., 2].view(np.int8)
            new_red = (px[..., 2].astype(np.int64)
                       - vp8l_delta(m[..., 0], green))
            new_blue = (px[..., 0].astype(np.int64)
                        - vp8l_delta(m[..., 1], green)
                        - vp8l_delta(m[..., 2], red))
            px[..., 2] = new_red & 255
            px[..., 0] = new_blue & 255
            cur = px.view(np.uint32)[..., 0]
        elif t[0] == "palette":
            colors, index = np.unique(cur, return_inverse=True)
            index = index.reshape(cur.shape)
            k = len(colors)
            if k > 256:
                raise ValueError(f"colour indexing of {k} colours")
            bw.put(3, 2)
            bw.put(k - 1, 8)
            bits = 0 if k > 16 else 1 if k > 4 else 2 if k > 2 else 3
            deltas = vp8l_bytes_of(colors).astype(np.int64)
            deltas[1:] -= vp8l_bytes_of(colors)[:-1]
            vp8l_image(bw, (deltas & 255).astype(np.uint8).view(
                np.uint32)[:, 0], k, 1, False, **sub)
            per = 1 << bits
            pw = -(-cw // per)
            padded = np.zeros((cur.shape[0], pw * per), np.int64)
            padded[:, :cw] = index
            shifts = (np.arange(per) * (8 >> bits)).astype(np.int64)
            green = (padded.reshape(cur.shape[0], pw, per) << shifts).sum(-1)
            cur = (0xff000000 | green << 8).astype(np.uint32)
        else:
            raise ValueError(f"unknown transform {t[0]!r}")
    bw.put(0, 1)
    vp8l_image(bw, cur.ravel(), cur.shape[1], cur.shape[0], True,
                cache_bits=cache_bits, meta_bits=meta_bits,
                meta_groups=meta_groups, lz77=lz77, dist_mode=dist_mode,
                simple=simple, max_symbol=max_symbol, tokens=tokens,
                code_lens=code_lens)
    return bw.tobytes()


def webp_riff(chunks):
    """A RIFF WEBP file of ``chunks`` ([(fourcc, payload)]), each padded to
    an even size."""
    import struct
    body = b"WEBP"
    for tag, data in chunks:
        body += tag + struct.pack("<I", len(data)) + data + b"\0" * (
            len(data) & 1)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def webp_built():
    """(the RGB source, the file) of phase 13's built WebP: a simple RIFF
    file of one VP8L stream of WEBP_BUILT_SIZE pixels (gradients, grain
    and flat boxes from WEBP_BUILT_SEED) under subtract-green, a predictor
    (every mode 0-13 over 32-pixel blocks) and cross-colour (random
    multipliers), a 10-bit colour cache, meta prefix codes (3 groups over
    64-pixel blocks) and backward references by the distance map."""
    import numpy as np
    rng = np.random.default_rng(WEBP_BUILT_SEED)
    h, w = WEBP_BUILT_SIZE
    y, x = np.mgrid[:h, :w]
    img = np.stack([x * 255 // w, y * 255 // h, (x + y) // 4 % 256], -1)
    img = (img + rng.integers(0, 3, (h, w, 1))).clip(0, 255).astype(np.uint8)
    img[100:200, 100:300] = (200, 30, 40)
    img[300:420, 400:600] = rng.integers(0, 256, 3)
    blocks = (-(-h // 32), -(-w // 32))
    modes = np.arange(blocks[0] * blocks[1]).reshape(blocks) % 14
    payload = vp8l_bytes(img, [
        ("green",), ("predictor", 5, modes),
        ("cross", 5, rng.integers(-40, 40, blocks + (3,)))],
        cache_bits=10, meta_bits=6, meta_groups=3)
    return img, webp_riff([(b"VP8L", payload)])


# ---------------------------------------------- a JPEG 2000 encoder
# phase 13's built JPEG 2000 file (j2k_built): ITU-T T.800's encoder in
# numpy and plain Python (the card's machine has no OpenJPEG): the forward
# 9/7 and ICT, scalar expounded quantisation, tier 1 under any code-block
# style with TERMALL (the MQ coder of Annex C, raw bypass segments, VSC,
# RESET, SEGSYM), tier 2 with tag trees, quality layers, a POC and PPT.

J2K_MQ = (  # (Qe, NMPS, NLPS, SWITCH) of Annex C's Table C.2
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0))


def _j2k_tables():
    """Annex D's context tables by neighbourhood word (as the port's
    jpeg2000.cpp builds them): zero coding by orientation, sign context
    and its XOR bit."""
    zc = [[0] * 256 for _ in range(4)]
    for o in range(4):
        for m in range(256):
            h = (m & 1 > 0) + (m & 2 > 0)
            v = (m & 4 > 0) + (m & 8 > 0)
            d = sum(m & b > 0 for b in (16, 32, 64, 128))
            if o == 3:
                hv = h + v
                c = (8 if d >= 3 else (7 if hv >= 1 else 6) if d == 2 else
                     (5 if hv >= 2 else 4 if hv == 1 else 3) if d == 1 else
                     2 if hv >= 2 else 1 if hv == 1 else 0)
            else:
                if o == 1:
                    h, v = v, h
                c = (8 if h == 2 else (7 if v >= 1 else 6 if d >= 1 else 5)
                     if h == 1 else 4 if v == 2 else 3 if v == 1 else
                     2 if d >= 2 else 1 if d == 1 else 0)
            zc[o][m] = c
    sc, sx = [0] * 256, [0] * 256
    ctx = ((13, 12, 11), (10, 9, 10), (11, 12, 13))
    for m in range(256):
        def part(sig, neg):
            return (-1 if m & neg else 1) if m & sig else 0
        h = max(-1, min(1, part(1, 16) + part(2, 32)))
        v = max(-1, min(1, part(4, 64) + part(8, 128)))
        sc[m] = ctx[h + 1][v + 1]
        sx[m] = 1 if h == -1 or (h == 0 and v == -1) else 0
    return zc, sc, sx


class J2kMq:
    """The MQ encoder (Annex C, software conventions: INITENC, ENCODE,
    FLUSH), one terminated segment at a time."""

    def __init__(self):
        self.reset_contexts()

    def reset_contexts(self):
        self.state = [0] * 19
        self.mps = [0] * 19
        self.state[18], self.state[17], self.state[0] = 46, 3, 4

    def start(self):
        self.a, self.c, self.ct = 0x8000, 0, 12
        self.out = bytearray([0])  # the byte before the segment

    def _byteout(self):
        out = self.out
        if out[-1] == 0xFF:
            out.append(self.c >> 20)
            self.c &= 0xFFFFF
            self.ct = 7
        elif not self.c & 0x8000000:
            out.append(self.c >> 19)
            self.c &= 0x7FFFF
            self.ct = 8
        else:
            out[-1] += 1
            if out[-1] == 0xFF:
                self.c &= 0x7FFFFFF
                out.append(self.c >> 20)
                self.c &= 0xFFFFF
                self.ct = 7
            else:
                out.append((self.c >> 19) & 0xFF)
                self.c &= 0x7FFFF
                self.ct = 8

    def encode(self, d, cx):
        qe, nmps, nlps, sw = J2K_MQ[self.state[cx]]
        self.a -= qe
        if d == self.mps[cx]:
            if self.a & 0x8000:
                self.c += qe
                return
            if self.a < qe:
                self.a = qe
            else:
                self.c += qe
            self.state[cx] = nmps
        else:
            if self.a < qe:
                self.c += qe
            else:
                self.a = qe
            if sw:
                self.mps[cx] ^= 1
            self.state[cx] = nlps
        while True:  # RENORME
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                break

    def flush(self):
        t = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= t:
            self.c -= 0x8000
        self.c <<= self.ct
        self._byteout()
        self.c <<= self.ct
        self._byteout()
        out = bytes(self.out[1:])
        return out[:-1] if out.endswith(b"\xff") else out


def j2k_raw_bytes(bits):
    """The bypass mode's raw segment: bits MSB first, 7 of them in a byte
    after 0xFF, the last byte padded 0, 1, 0, ...; a last 0xFF dropped
    (the decoder's artificial marker reads the same)."""
    out, cur, ct = bytearray(), 0, 8
    for b in bits:
        ct -= 1
        cur |= b << ct
        if ct == 0:
            out.append(cur)
            ct = 7 if cur == 0xFF else 8
            cur = 0
    if ct < 8 and not (ct == 7 and out and out[-1] == 0xFF and cur == 0):
        pad = 0
        while ct > 0:
            ct -= 1
            cur |= pad << ct
            pad ^= 1
        out.append(cur)
    if out.endswith(b"\xff"):
        out = out[:-1]
    return bytes(out)


J2K_ZC, J2K_SC, J2K_SX = _j2k_tables()
# a coefficient's flag word: bits 0-7 its W, E, N, S, NW, NE, SW, SE
# neighbours' significance, 8-11 the W, E, N, S neighbours' signs
_KW, _KE, _KN, _KS, _KNW, _KNE, _KSW, _KSE = 1, 2, 4, 8, 16, 32, 64, 128
_KWNEG, _KENEG, _KNNEG, _KSNEG = 256, 512, 1024, 2048
_KSIG, _KVISIT, _KREF = 1 << 12, 1 << 13, 1 << 14


def j2k_t1_encode(mag, neg, orient, style, segsym_value=0b1010):
    """One code-block's coding passes (its magnitudes and signs, row-major
    lists of w x h) under code-block ``style`` with TERMALL: each pass
    terminated on its own (MQ or, under BYPASS, raw). Returns (the bit-planes
    P, [each pass's bytes])."""
    h, w = len(mag), len(mag[0])
    top = max(max(r) for r in mag)
    if top == 0:
        return 0, []
    nbits = top.bit_length()
    fw = w + 2
    flags = [0] * (fw * (h + 2))
    zc = J2K_ZC[orient]
    vsc = style & 8
    mq = J2kMq()
    passes = []

    def setsig(x, y, g, sgn):
        flags[g] |= _KSIG
        flags[g - 1] |= _KE | (_KENEG if sgn else 0)
        flags[g + 1] |= _KW | (_KWNEG if sgn else 0)
        if not (vsc and y % 4 == 0):
            flags[g - fw] |= _KS | (_KSNEG if sgn else 0)
            flags[g - fw - 1] |= _KSE
            flags[g - fw + 1] |= _KSW
        flags[g + fw] |= _KN | (_KNNEG if sgn else 0)
        flags[g + fw - 1] |= _KNE
        flags[g + fw + 1] |= _KNW

    def sign_mq(g, sgn):
        f = flags[g]
        m = (f & 15) | ((f >> 4) & 0xF0)
        mq.encode(sgn ^ J2K_SX[m], J2K_SC[m])

    order = [(x, y) for k in range(0, h, 4) for x in range(w)
             for y in range(k, min(k + 4, h))]
    passtype, plane, npass = 2, nbits - 1, 0
    while plane >= 0:
        raw = (style & 1) and npass >= 10 and passtype < 2
        bits = []
        if not raw:
            mq.start()
        if passtype == 0:
            for x, y in order:
                g = (y + 1) * fw + x + 1
                f = flags[g]
                if f & _KSIG or not f & 0xFF:
                    continue
                bit = (mag[y][x] >> plane) & 1
                if raw:
                    bits.append(bit)
                    if bit:
                        bits.append(neg[y][x])
                        setsig(x, y, g, neg[y][x])
                else:
                    mq.encode(bit, zc[f & 0xFF])
                    if bit:
                        sign_mq(g, neg[y][x])
                        setsig(x, y, g, neg[y][x])
                flags[g] |= _KVISIT
        elif passtype == 1:
            for x, y in order:
                g = (y + 1) * fw + x + 1
                f = flags[g]
                if f & (_KSIG | _KVISIT) != _KSIG:
                    continue
                bit = (mag[y][x] >> plane) & 1
                if raw:
                    bits.append(bit)
                else:
                    mq.encode(bit, 16 if f & _KREF else 15 if f & 0xFF else 14)
                flags[g] |= _KREF
        else:
            busy = _KSIG | _KVISIT | 0xFF
            for k in range(0, h, 4):
                for x in range(w):
                    y = k
                    if k + 4 <= h and not any(
                            flags[(k + j + 1) * fw + x + 1] & busy
                            for j in range(4)):
                        run = next((j for j in range(4)
                                    if (mag[k + j][x] >> plane) & 1), 4)
                        if run == 4:
                            mq.encode(0, 17)
                            continue
                        mq.encode(1, 17)
                        mq.encode(run >> 1, 18)
                        mq.encode(run & 1, 18)
                        y = k + run
                        g = (y + 1) * fw + x + 1
                        sign_mq(g, neg[y][x])
                        setsig(x, y, g, neg[y][x])
                        y += 1
                    for y in range(y, min(k + 4, h)):
                        g = (y + 1) * fw + x + 1
                        f = flags[g]
                        if f & (_KSIG | _KVISIT):
                            continue
                        bit = (mag[y][x] >> plane) & 1
                        mq.encode(bit, zc[f & 0xFF])
                        if bit:
                            sign_mq(g, neg[y][x])
                            setsig(x, y, g, neg[y][x])
            for i in range(len(flags)):
                flags[i] &= ~_KVISIT
            if style & 32:
                for j in range(3, -1, -1):
                    mq.encode((segsym_value >> j) & 1, 18)
        passes.append(j2k_raw_bytes(bits) if raw else mq.flush())
        if style & 2 and not raw:
            mq.reset_contexts()
        npass += 1
        passtype += 1
        if passtype == 3:
            passtype = 0
            plane -= 1
    return nbits, passes


J2K_K, J2K_TWO_INV_K = 1.230174105, 1.625732422


def _j2k_lift97(x):
    """The forward 9/7 of each row of ``x`` (float64 [n, m], m > 1): the
    lifting steps with symmetric extension, then lows / K and highs / the
    decoder's 2 / K. Returns (lows, highs)."""
    import numpy as np
    a, b, g, d = -1.586134342, -0.052980118, 0.882911075, 0.443506852
    e, o = x[:, 0::2].copy(), x[:, 1::2].copy()
    ne, no = e.shape[1], o.shape[1]

    def odd(c):
        nxt = np.concatenate([e[:, 1:], e[:, -1:]], 1)[:, :no] if ne == no \
            else e[:, 1:no + 1]
        o[:] += c * (e[:, :no] + nxt)

    def even(c):
        prev = np.concatenate([o[:, :1], o], 1)[:, :ne]
        cur = o if ne == no else np.concatenate([o, o[:, -1:]], 1)
        e[:] += c * (prev + cur)
    odd(a)
    even(b)
    odd(g)
    even(d)
    return e / J2K_K, o / J2K_TWO_INV_K


def j2k_fdwt97(x, levels):
    """``levels`` forward 9/7 decompositions of ``x`` (float64 [h, w]) in
    place, each level's LL at the top left, HL right of it, LH below, HH
    below right."""
    h, w = x.shape
    for _ in range(levels):
        if w > 1:
            lo, hi = _j2k_lift97(x[:h, :w])
            x[:h, :lo.shape[1]], x[:h, lo.shape[1]:w] = lo, hi
        if h > 1:
            lo, hi = _j2k_lift97(x[:h, :w].T.copy())
            x[:lo.shape[1], :w], x[lo.shape[1]:h, :w] = lo.T, hi.T
        h, w = (h + 1) // 2, (w + 1) // 2
    return x


class _J2kTagTree:
    """opj_tgt for the encoder: leaves' values, each node the least of its
    children, opj_tgt_encode's low/known state kept across layers."""

    def __init__(self, w, h, values):
        self.parent, self.value = [], []
        sizes = [(w, h)]
        while sizes[-1][0] * sizes[-1][1] > 1:
            sw, sh = sizes[-1]
            sizes.append(((sw + 1) // 2, (sh + 1) // 2))
        base = 0
        for li, (sw, sh) in enumerate(sizes):
            nxt = base + sw * sh
            for j in range(sh):
                for i in range(sw):
                    self.parent.append(
                        nxt + (j // 2) * sizes[li + 1][0] + i // 2
                        if li + 1 < len(sizes) else -1)
            base = nxt
        self.value = [10 ** 6] * len(self.parent)
        for k, v in enumerate(values):
            n = k
            while n >= 0:
                self.value[n] = min(self.value[n], v)
                n = self.parent[n]
        self.low = [0] * len(self.parent)
        self.known = [False] * len(self.parent)

    def encode(self, bits, leaf, threshold):
        stk, node = [], leaf
        while self.parent[node] >= 0:
            stk.append(node)
            node = self.parent[node]
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold:
                if low >= self.value[node]:
                    if not self.known[node]:
                        bits.append(1)
                        self.known[node] = True
                    break
                bits.append(0)
                low += 1
            self.low[node] = low
            if not stk:
                break
            node = stk.pop()


def _j2k_bio(bits):
    """A packet header's bytes: 7 bits in a byte after 0xFF, zeros to the
    end, and a byte more after a last 0xFF (opj_bio_flush)."""
    out, cur, ct = bytearray(), 0, 8
    for b in bits:
        if ct == 0:
            out.append(cur)
            ct, cur = (7 if cur == 0xFF else 8), 0
        ct -= 1
        cur |= b << ct
    out.append(cur)
    if cur == 0xFF:
        out.append(0)
    return bytes(out)


def _j2k_numpasses(bits, n):
    for v, k in ((0, 1) if n == 1 else (2, 2) if n == 2 else
                 (0xC | (n - 3), 4) if n <= 5 else (0x1E0 | (n - 6), 9)
                 if n <= 36 else (0xFF80 | (n - 37), 16),):
        bits.extend((v >> i) & 1 for i in range(k - 1, -1, -1))


def j2k_poc_order(entries, layers, levels, ncomp):
    """The (layer, resolution, component) of each packet OpenJPEG reads
    under POC ``entries`` in a tile of one precinct a resolution (every
    position progression then visits its one position once): each entry's
    order over layers [0, LYEpoc), resolutions [RSpoc, REpoc) and
    components [CSpoc, CEpoc), a packet read once."""
    seen, out = set(), []
    for r0, c0, l1, r1, c1, prg in entries:
        l1, r1, c1 = min(l1, layers), min(r1, levels + 1), min(c1, ncomp)
        loops = {0: "lrc", 1: "rlc", 2: "rcl", 3: "crl", 4: "crl"}.get(prg)
        if c0 >= ncomp or loops is None:
            continue
        span = {"l": range(l1), "r": range(r0, r1), "c": range(c0, c1)}
        for i in span[loops[0]]:
            for j in span[loops[1]]:
                for k in span[loops[2]]:
                    key = dict(zip(loops, (i, j, k)))
                    p = (key["l"], key["r"], key["c"])
                    if p not in seen:
                        seen.add(p)
                        out.append(p)
    return out


def j2k_bytes(img, levels=5, style=63, segsym_value=0b1010, mct=True):
    """A raw JPEG 2000 codestream of an RGB uint8 image: 9/7 with the ICT
    (``mct``; without it each channel is coded as it is),
    ``levels`` decompositions, every band quantised with a step of 1, 64 x
    64 code-blocks of ``style`` (TERMALL always: each pass its own
    segment), the passes of each code-block split over three quality
    layers, one tile of one tile-part, one precinct a resolution, a POC of
    three entries in the main header that reorders the packets, and every
    packet header in PPT markers of the tile-part header; cleanup passes
    end with the segmentation symbol ``segsym_value`` under SEGSYM."""
    import numpy as np
    h, w, nc = img.shape
    layers = 3
    style |= 4  # every pass is terminated on its own
    x = img.astype(np.float64) - 128
    r, g, b_ = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    comps = [0.299 * r + 0.587 * g + 0.114 * b_,
             -0.16875 * r - 0.33126 * g + 0.5 * b_,
             0.5 * r - 0.41869 * g - 0.08131 * b_] if mct else [
                 x[:, :, c].copy() for c in range(nc)]
    for c in comps:
        j2k_fdwt97(c, levels)
    # the bands of each resolution: (decomposition level, bandno, x0, y0,
    # w, h) in the transformed array, in the decoder's order
    dims = [(h, w)]
    for _ in range(levels):
        dims.append(((dims[-1][0] + 1) // 2, (dims[-1][1] + 1) // 2))
    bands = [[(levels, 0, 0, 0, dims[levels][1], dims[levels][0])]]
    for d in range(levels, 0, -1):
        (lh, lw), (fh, fw) = dims[d], dims[d - 1]
        bands.append([(d, 1, lw, 0, fw - lw, lh), (d, 2, 0, lh, lw, fh - lh),
                      (d, 3, lw, lh, fw - lw, fh - lh)])
    # scalar expounded quantisation of step (1 + mant / 2048) 2^(8 - expn)
    # (the 9/7 decoder's gain is 0 in every band): mant 0 and expn 8, a
    # step of 1, and 2 guard bits leave 9 magnitude bit-planes
    qcd, mb = [8 << 11] * (3 * levels + 1), 9
    # tier 1: every code-block's passes, (c, r) -> [(cw, ch, [(P, passes)
    # of each code-block]) of each band]
    blocks = {}
    for r, res in enumerate(bands):
        for _, bandno, bx, by, bw, bh in res:
            cw, ch = -(-bw // 64), -(-bh // 64)
            for c in range(nc):
                q = np.trunc(comps[c][by:by + bh, bx:bx + bw]).astype(np.int64)
                assert np.abs(q).max(initial=0) < 2 ** mb
                mag, neg = np.abs(q), (q < 0).astype(np.int64)
                cbs = []
                for j in range(ch):
                    for i in range(cw):
                        m = mag[j * 64:(j + 1) * 64, i * 64:(i + 1) * 64]
                        s = neg[j * 64:(j + 1) * 64, i * 64:(i + 1) * 64]
                        cbs.append(j2k_t1_encode(m.tolist(), s.tolist(),
                                                 bandno, style, segsym_value))
                blocks.setdefault((c, r), []).append((cw, ch, cbs))
    # tier 2: each packet's header and body, the tag trees of each
    # precinct kept over its layers
    state = {}
    for key, bl in blocks.items():
        st = []
        for cw, ch, cbs in bl:
            cuts = [[len(passes) * l // layers for l in range(layers + 1)]
                    for _, passes in cbs]
            first = [next((l for l in range(layers) if cu[l + 1] > cu[l]),
                          layers) for cu in cuts]
            st.append(dict(cbs=cbs, cuts=cuts, lenbits=[3] * len(cbs),
                           incl=_J2kTagTree(cw, ch, first), first=first,
                           imsb=_J2kTagTree(cw, ch, [mb - p for p, _ in cbs])))
        state[key] = st

    def packet(l, r, c):
        bits, body = [], bytearray()
        any_data = any(s["cuts"][i][l + 1] > s["cuts"][i][l]
                       for s in state[(c, r)] for i in range(len(s["cbs"])))
        if not any_data:
            return _j2k_bio([0]), b""
        bits.append(1)
        for s in state[(c, r)]:
            for i, (_, passes) in enumerate(s["cbs"]):
                a, z = s["cuts"][i][l], s["cuts"][i][l + 1]
                if s["first"][i] >= l:
                    s["incl"].encode(bits, i, l + 1)
                else:
                    bits.append(1 if z > a else 0)
                if z == a:
                    continue
                if s["first"][i] == l:
                    s["imsb"].encode(bits, i, 999)
                _j2k_numpasses(bits, z - a)
                lens = [len(p) for p in passes[a:z]]
                need = max(v.bit_length() for v in lens)
                inc = max(0, need - s["lenbits"][i])
                bits.extend([1] * inc + [0])
                s["lenbits"][i] += inc
                for v in lens:
                    bits.extend((v >> t) & 1
                                for t in range(s["lenbits"][i] - 1, -1, -1))
                body += b"".join(passes[a:z])
        return _j2k_bio(bits), bytes(body)

    entries = [(0, 0, layers, 1, nc, 1), (1, 0, 1, levels + 1, nc, 4),
               (0, 0, layers, levels + 1, nc, 0)]
    heads, data = bytearray(), bytearray()
    for l, r, c in j2k_poc_order(entries, layers, levels, nc):
        hd, bd = packet(l, r, c)
        heads += hd
        data += bd

    def seg(m, body):
        return struct.pack(">HH", m, len(body) + 2) + body
    siz = struct.pack(">HIIIIIIIIH", 0, w, h, 0, 0, w, h, 0, 0, nc) + bytes(
        [7, 1, 1] * nc)
    cod = struct.pack(">BBHBBBBBB", 0, 0, layers, int(mct), levels, 4, 4,
                      style, 0)
    main = (b"\xff\x4f" + seg(0xFF51, siz) + seg(0xFF52, cod)
            + seg(0xFF5C, bytes([2 << 5 | 2]) + struct.pack(
                f">{len(qcd)}H", *qcd))
            + seg(0xFF5F, b"".join(struct.pack(">BBHBBB", *e)
                                   for e in entries)))
    ppt = b"".join(seg(0xFF61, bytes([z]) + bytes(heads[i:i + 65000]))
                   for z, i in enumerate(range(0, len(heads), 65000)))
    psot = 12 + len(ppt) + 2 + len(data)
    return (main + struct.pack(">HHHIBB", 0xFF90, 10, 0, psot, 0, 1) + ppt
            + b"\xff\x93" + bytes(data) + b"\xff\xd9")


def jp2_file(codestream, h, w, nc, boxes=b"", enumcs=16):
    """A JP2 file around a raw ``codestream`` of ``nc`` 8-bit components:
    the signature and ftyp boxes, jp2h (ihdr, a colr box of ``enumcs``,
    then ``boxes``, whole header boxes), jp2c."""
    def box(kind, body):
        return struct.pack(">I4s", 8 + len(body), kind) + body
    head = (box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, 7, 7, 0, 0))
            + box(b"colr", struct.pack(">BBBI", 1, 0, 0, enumcs)) + boxes)
    return (box(b"jP  ", b"\r\n\x87\n") + box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + box(b"jp2h", head) + box(b"jp2c", codestream))


def j2k_colour_built():
    """(the RGB source, the file) of phase 13's built JPEG 2000 colour-box
    file: j2k_source turned to full-range BT.601 YCbCr (sYCC's own
    matrix), stored Y, Cr, Cb and coded by j2k_bytes without the ICT, in a
    JP2 file of an sYCC colr box whose cdef moves channels 1 and 2 back to
    Y, Cb, Cr."""
    import numpy as np
    img = j2k_source()
    rgb = img.astype(np.float64)
    r, g, b = rgb[:, :, 0], rgb[:, :, 1], rgb[:, :, 2]
    ycc = np.stack([0.299 * r + 0.587 * g + 0.114 * b,
                    0.5 * r - 0.418688 * g - 0.081312 * b + 128,
                    -0.168736 * r - 0.331264 * g + 0.5 * b + 128], -1)
    stored = np.clip(np.rint(ycc), 0, 255).astype(np.uint8)
    h, w, _ = img.shape
    cdef = struct.pack(">H9H", 3, 0, 0, 1, 1, 0, 3, 2, 0, 2)
    return img, jp2_file(j2k_bytes(stored, mct=False), h, w, 3,
                         struct.pack(">I4s", 8 + len(cdef), b"cdef") + cdef,
                         enumcs=18)


def tiff_mode_bytes(kind, h, w, rng, work):
    """A TIFF of ``kind`` (TIFF_MODES_FILES) of ``h`` x ``w`` pixels, its
    samples drawn from ``rng``: little-endian uncompressed strips of 5 rows
    (I;16S at orientation 6, big-endian I;32S, F, I;12), F deflate strips
    of BUILT_TIFF_ROWS rows with the floating-point predictor (its bytes
    split into planes, most significant first, each row differenced byte
    by byte), or old-style JPEG of an RGB image through the port's JPEG
    writer (in ``work``)."""
    import zlib
    import numpy as np
    y, x = np.mgrid[:h, :w]
    if kind.startswith("ojpeg"):
        from tsr_tpu_torch import native
        img = np.stack([(x * 5 + y * 3) % 256, (y * 7 + 40) % 256,
                        (x * y + rng.integers(0, 32, (h, w))) % 256],
                       -1).astype(np.uint8)
        path = work / f"{kind}_{h}x{w}.jpg"
        native.write_images([str(path)], [img])
        return ojpeg_bytes(path.read_bytes(), h, w, kind[6:])
    ramp = (x * 37 + y * 23) % 600 - 150 + rng.integers(-20, 20, (h, w))
    rows = 5 if kind != "f_pred3" else BUILT_TIFF_ROWS
    tags = {256: (4, [w]), 257: (4, [h]), 259: (3, [1]), 262: (3, [1]),
            273: (4, None), 277: (3, [1]), 278: (4, [rows])}
    big = kind == "i32s_be"
    if kind == "i12":
        v = (ramp * 7) % 4096
        tags[258] = (3, [12])
        packed = pack_i12(v)
        strips = [b"".join(packed[r:r + rows]) for r in range(0, h, rows)]
    else:
        fmt, sf = {"i16s": ("<i2", 2), "i32s_be": (">i4", 2), "f": ("<f4", 3),
                   "f_pred3": ("<f4", 3)}[kind]
        v = ramp.astype(np.float64)
        if kind == "i32s_be":
            v = v * 40000
        elif kind.startswith("f"):
            v = v + rng.random((h, w)) * 2 - 0.5
            v.flat[:4] = [np.nan, np.inf, -np.inf, 255.5]
        a = v.astype(fmt)
        tags.update({258: (3, [8 * a.itemsize]), 339: (3, [sf])})
        if kind == "i16s":
            tags[274] = (3, [6])
        strips = []
        for r in range(0, h, rows):
            block = a[r:r + rows]
            if kind != "f_pred3":
                strips.append(block.tobytes())
                continue
            strips.append(zlib.compress(fp_predictor_bytes(block)))
        if kind == "f_pred3":
            tags.update({259: (3, [8]), 317: (3, [3])})
    tags[279] = (4, [len(b) for b in strips])
    return tiff_layout(tags, strips, big=big)


def tiff_modes_files(root):
    """{name: path} of phase 13's TIFF part 2c-iii files in ``root``
    (TIFF_MODES_FILES), from one seeded stream."""
    import numpy as np
    rng = np.random.default_rng(TIFF_MODES_SEED)
    root.mkdir(parents=True, exist_ok=True)
    out = {}
    for name, (kind, h, w) in TIFF_MODES_FILES.items():
        out[name] = root / name
        out[name].write_bytes(tiff_mode_bytes(kind, h, w, rng, root))
    return out


def built_tiff_modes_checks(work):
    """Pillow's I, F and I;12 modes and old-style JPEG on files built here
    (tiff_modes_files; the card's machine has no cv2 or PIL): each decoded
    to its TIFF_MODES_DIGESTS digest of PIL's pixels, probed at that size
    by the reader paths' probe and (0, 0) by cv2's; the host decode rates
    of the rate_modes_ files (BUILT_TIFF_DECODES decodes on one thread,
    best of JPEG_DECODE_REPS passes). Returns (the tiff_modes_ files'
    paths, the numbers for phase 13's line)."""
    import hashlib
    from tsr_tpu_torch import native
    t0 = time.perf_counter()
    files = tiff_modes_files(work / "built_tiff_modes")
    out = {"write_s": time.perf_counter() - t0}
    check(sorted(files) == sorted(TIFF_MODES_DIGESTS),
          f"TIFF mode files {sorted(files)}")
    for name, p in files.items():
        img = native.decode(str(p))
        check(hashlib.sha256(img.tobytes()).hexdigest()
              == TIFF_MODES_DIGESTS[name], f"{name} decodes unlike PIL")
        check(native.probe([str(p)]).tolist() == [list(img.shape[:2])],
              f"{name}: probe('port')")
        check(native.probe([str(p)], reader="cv2").tolist() == [[0, 0]],
              f"{name}: probe('cv2') reads what cv2 refuses")
        if not name.startswith("rate_modes_"):
            continue
        h, w = img.shape[:2]
        best = math.inf
        for _ in range(JPEG_DECODE_REPS):
            t0 = time.perf_counter()
            for _ in range(BUILT_TIFF_DECODES):
                native.decode(str(p))
            best = min(best, time.perf_counter() - t0)
        out[name] = {"bytes": p.stat().st_size, "images_per_sec":
                     BUILT_TIFF_DECODES / best, "megapixels_per_sec":
                     BUILT_TIFF_DECODES * h * w / best / 1e6}
    return [p for n, p in files.items() if n.startswith("tiff_modes_")], out


def webp_fixture_checks(root, n_pil, digests=None, min_cases=40):
    """The WebP fixtures of ``root`` (the card's machine has no cv2 or PIL;
    ``min_cases`` of them at least):
    each top-level fixture decoded equal to its expected.npz (those named
    in ``digests`` to the SHA-256 of cv2's pixels given there) and probed
    at that size by both probes; each skip/ file (0, 0) by the cv2 probe,
    decoded as PIL where PIL reads it (``n_pil`` of them, probed at their
    size), raising "failed to decode" otherwise. Returns (the fixtures cv2
    reads, the skip/ files, those PIL reads)."""
    import hashlib
    import numpy as np
    from tsr_tpu_torch import native
    digests = digests or {}
    want = np.load(root / "expected.npz")
    cases = sorted(p for p in root.iterdir() if p.suffix in IMAGE_SUFFIXES)
    skips = sorted((root / "skip").iterdir())
    check(len(cases) == int(want["generate_tree_written"]) >= min_cases,
          f"{len(cases)} fixtures in {root.name}")
    for p in cases:
        img = native.decode(str(p))
        if p.name in digests:
            check(hashlib.sha256(img.tobytes()).hexdigest()
                  == digests[p.name], f"{p.name} decodes unlike cv2.imread "
                  "(its digest)")
        else:
            check(np.array_equal(img, want[f"decoded__{p.name}"]),
                  f"fixture {p.name} decodes unlike cv2.imread")
        for reader in ("cv2", "port"):
            check(native.probe([str(p)], reader=reader).tolist()
                  == [list(img.shape[:2])], f"{p.name}: probe {reader}")
    pil_read = []
    for p in skips:
        check(native.probe([str(p)], reader="cv2").tolist() == [[0, 0]],
              f"skip/{p.name}: probe(reader='cv2') reads what cv2 refuses")
        key = f"decoded_skip__{p.name}"
        if key in want.files:
            img = native.decode(str(p))
            check(np.array_equal(img, want[key])
                  and native.probe([str(p)]).tolist()
                  == [list(img.shape[:2])], f"skip/{p.name} reads unlike PIL")
            pil_read.append(p)
            continue
        try:
            native.decode(str(p))
        except RuntimeError as e:
            check("failed to decode" in str(e), f"skip/{p.name}: {e}")
        else:
            check(False, f"skip/{p.name} decoded; cv2 and PIL refuse it")
    check(len(pil_read) == n_pil, f"{root.name} files PIL reads: {pil_read}")
    return cases, skips, pil_read


def decode_rate(path, h, w):
    """The host decode rate of one ``h`` x ``w`` file: WEBP_BUILT_DECODES
    decodes on one thread, best of JPEG_DECODE_REPS passes."""
    from tsr_tpu_torch import native
    best = math.inf
    for _ in range(JPEG_DECODE_REPS):
        t0 = time.perf_counter()
        for _ in range(WEBP_BUILT_DECODES):
            native.decode(str(path))
        best = min(best, time.perf_counter() - t0)
    return {"bytes": path.stat().st_size, "images_per_sec":
            WEBP_BUILT_DECODES / best, "megapixels_per_sec":
            WEBP_BUILT_DECODES * h * w / best / 1e6}


def webp_checks(work):
    """WebP part 1 in phase 13: the fixtures of tests/data/webp
    (webp_fixture_checks; the 28-byte file the one PIL reads), the file
    webp_built makes (in ``work``) decoded equal to its source and probed
    at its size, and its decode_rate. Returns (the fixtures cv2 reads, the
    skip/ files, those PIL reads, the numbers for phase 13's line)."""
    import numpy as np
    from tsr_tpu_torch import native
    cases, skips, pil_read = webp_fixture_checks(WEBP_FIXTURES, 1)
    t0 = time.perf_counter()
    img, data = webp_built()
    out = {"cv2_reads": len(cases), "skip": len(skips),
           "skip_pil_reads": len(pil_read),
           "write_s": time.perf_counter() - t0}
    path = work / "built_webp" / "webp_built.png"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(data)
    check(np.array_equal(native.decode(str(path)), img),
          "the built WebP decodes unlike its source")
    for reader in ("cv2", "port"):
        check(native.probe([str(path)], reader=reader).tolist()
              == [list(WEBP_BUILT_SIZE)], f"built WebP: probe {reader}")
    out["built"] = decode_rate(path, *WEBP_BUILT_SIZE)
    return cases, skips, pil_read, out


def webp_lossy_checks():
    """WebP part 2 in phase 13: the lossy fixtures of tests/data/webp_lossy
    (webp_fixture_checks; the 640 x 480 file, WEBP_LOSSY_BIG, held to
    WEBP_LOSSY_BIG_DIGEST; the three ALPH files PIL's demux reads past),
    and the big file's decode_rate. Returns (the fixtures cv2 reads, the
    skip/ files, those PIL reads, the numbers for phase 13's line)."""
    cases, skips, pil_read = webp_fixture_checks(
        WEBP_LOSSY_FIXTURES, 3, {WEBP_LOSSY_BIG: WEBP_LOSSY_BIG_DIGEST})
    return cases, skips, pil_read, {
        "cv2_reads": len(cases), "skip": len(skips),
        "skip_pil_reads": len(pil_read), "big": decode_rate(
            WEBP_LOSSY_FIXTURES / WEBP_LOSSY_BIG, *WEBP_LOSSY_BIG_SIZE)}


def jpeg2000_checks():
    """JPEG 2000 in phase 13: the fixtures of tests/data/jpeg2000
    (webp_fixture_checks: the JP2 file and the raw codestream, 5/3 and 9/7,
    layers, the five progression orders, precincts, tiles and tile-parts,
    SOP and EPH, 1-4 components of 8 to 16 bits; part 2's j2k2_ files of
    code-block styles, POC, PPM, PPT and RGN; each equal to cv2's pixels;
    the 13 skip/ files PIL reads, an image offset, precisions under 8,
    signed samples and raw gray codestreams of part 2's features among
    them; the damaged ones refused; the 640 x 480 9/7 file, JPEG2000_BIG,
    held to JPEG2000_BIG_DIGEST), and the big file's decode_rate. Returns
    (the fixtures cv2 reads, the skip/ files, those PIL reads, the numbers
    for phase 13's line)."""
    cases, skips, pil_read = webp_fixture_checks(
        JPEG2000_FIXTURES, 13, {JPEG2000_BIG: JPEG2000_BIG_DIGEST})
    return cases, skips, pil_read, {
        "cv2_reads": len(cases), "skip": len(skips),
        "skip_pil_reads": len(pil_read), "big": decode_rate(
            JPEG2000_FIXTURES / JPEG2000_BIG, *JPEG2000_BIG_SIZE)}


def j2k_source():
    """JPEG2000_BIG's source image: JPEG2000_BIG_SIZE of gradients with
    grain of -3 to 3 from JPEG2000_SOURCE_SEED."""
    import numpy as np
    rng = np.random.default_rng(JPEG2000_SOURCE_SEED)
    h, w = JPEG2000_BIG_SIZE
    y, x = np.mgrid[:h, :w]
    img = np.stack([x * 255 // (w - 1), y * 255 // (h - 1),
                    (x + y) * 255 // (h + w - 2)], -1).astype(int)
    img += rng.integers(-3, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def j2k_built():
    """(the RGB source, the file) of phase 13's built JPEG 2000 file: the
    raw codestream j2k_bytes writes of j2k_source (9/7, style 63, three
    layers, a POC, PPT)."""
    img = j2k_source()
    return img, j2k_bytes(img)


def jpeg2000_part2_checks(work, cases, skips, pil_read):
    """JPEG 2000 part 2 in phase 13: the counts of its fixtures among
    jpeg2000_checks' (``cases``, ``skips``, ``pil_read``), and the file
    j2k_built makes (in ``work``) held to JPEG2000_BUILT_DIGEST, probed at
    its size by both probes, within 3 LSB RMS of its source, and its
    decode_rate. Returns the numbers for phase 13's line."""
    import hashlib
    import numpy as np
    from tsr_tpu_torch import native
    out = {key: sum(p.name.startswith("j2k2_") for p in files)
           for key, files in (("cv2_reads", cases), ("skip", skips),
                              ("skip_pil_reads", pil_read))}
    check(out["cv2_reads"] >= 15 and out["skip_pil_reads"] == 3,
          f"JPEG 2000 part 2 fixtures: {out}")
    t0 = time.perf_counter()
    img, data = j2k_built()
    out["write_s"] = time.perf_counter() - t0
    out["bytes"] = len(data)
    path = work / "built_jpeg2000" / JPEG2000_BUILT
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(data)
    got = native.decode(str(path))
    check(hashlib.sha256(got.tobytes()).hexdigest() == JPEG2000_BUILT_DIGEST,
          "the built JPEG 2000 file decodes unlike cv2.imread (its digest)")
    out["rms_to_source"] = float(np.sqrt(np.mean(
        (got.astype(np.float64) - img) ** 2)))
    check(out["rms_to_source"] < 3.0, f"the built JPEG 2000 file: {out}")
    for reader in ("cv2", "port"):
        check(native.probe([str(path)], reader=reader).tolist()
              == [list(JPEG2000_BIG_SIZE)], f"built JPEG 2000: probe {reader}")
    out["built"] = decode_rate(path, *JPEG2000_BIG_SIZE)
    return out


def jpeg2000_colour_checks(work):
    """JPEG 2000 part 3 in phase 13: the j2k3_ fixtures of
    tests/data/jpeg2000_colour (webp_fixture_checks: sYCC, ICC, CIELab, a
    gray colr on 3 components, cdef boxes that move channels, palettes
    with and without their cmap, each equal to cv2's pixels; CMYK, a
    palette and sYCC PIL reads; boxes both refuse), and the file
    j2k_colour_built makes (in ``work``) held to JPEG2000_COLOUR_DIGEST,
    probed at its size by both probes, with its decode_rate. Returns (the
    fixtures cv2 reads, the skip/ files, those PIL reads, the numbers for
    phase 13's line)."""
    import hashlib
    from tsr_tpu_torch import native
    cases, skips, pil_read = webp_fixture_checks(
        JPEG2000_COLOUR_FIXTURES, JPEG2000_COLOUR_PIL_READS, min_cases=10)
    out = {"cv2_reads": len(cases), "skip": len(skips),
           "skip_pil_reads": len(pil_read)}
    t0 = time.perf_counter()
    _, data = j2k_colour_built()
    out["write_s"] = time.perf_counter() - t0
    path = work / "built_jpeg2000" / JPEG2000_COLOUR_BUILT
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(data)
    got = native.decode(str(path))
    check(hashlib.sha256(got.tobytes()).hexdigest() == JPEG2000_COLOUR_DIGEST,
          "the built sYCC JPEG 2000 file decodes unlike cv2.imread (its "
          "digest)")
    for reader in ("cv2", "port"):
        check(native.probe([str(path)], reader=reader).tolist()
              == [list(JPEG2000_BIG_SIZE)], f"built sYCC file: probe {reader}")
    out["built"] = decode_rate(path, *JPEG2000_BIG_SIZE)
    return cases, skips, pil_read, out


def jpeg2000_ht_checks():
    """JPEG 2000 part 4 (HTJ2K) in phase 13: the j2k4_ fixtures of
    tests/data/jpeg2000_ht (webp_fixture_checks: HT code-blocks of the 5/3
    and 9/7, RCT and ICT, gray of 12 bits, code-blocks of 64 x 64, 16 x 64
    and 4 x 1024, tiles, layers, RPCL and CPRL, SOP and EPH, SigProp and
    MagRef passes, a cdef box, CAP and CPF on a part 1 file, each equal to
    cv2's pixels; the signed, offset and raw gray files PIL reads; RGN with
    HT, the mixed style, 4 passes and an Scup of 4080 refused; the 640 x
    480 file JPEG2000_HT_BIG held to JPEG2000_HT_DIGEST), and the big
    file's decode_rate beside JPEG2000_BIG's, timed in turn. Returns (the
    fixtures cv2 reads, the skip/ files, those PIL reads, the numbers for
    phase 13's line)."""
    cases, skips, pil_read = webp_fixture_checks(
        JPEG2000_HT_FIXTURES, JPEG2000_HT_PIL_READS,
        {JPEG2000_HT_BIG: JPEG2000_HT_DIGEST}, min_cases=10)
    return cases, skips, pil_read, {
        "cv2_reads": len(cases), "skip": len(skips),
        "skip_pil_reads": len(pil_read),
        "big": decode_rate(JPEG2000_HT_FIXTURES / JPEG2000_HT_BIG,
                           *JPEG2000_BIG_SIZE),
        "part1_big": decode_rate(JPEG2000_FIXTURES / JPEG2000_BIG,
                                 *JPEG2000_BIG_SIZE)}


def jpeg2000_mct_checks():
    """JPEG 2000 part 5 (Part 2's multi-component markers) in phase 13: the
    j2k5_ fixtures of tests/data/jpeg2000_mct (webp_fixture_checks: MCO
    stages over offset arrays of int16, int32, float32 and float64, MCO of
    no stage, two stages or an unknown one, the MCC segments OpenJPEG only
    warns about, decorrelation matrices never applied, an MCO in one
    tile's tile-part header, CBD at depths 8, 12 and 16, OpenJPEG's own
    opj_set_MCT output, each equal to cv2's pixels; a CBD of depth 6, a
    signed CBD and a raw gray codestream PIL reads; a CBD of the wrong
    count, an MCC naming a missing array, a matrix and an offset array of
    the wrong size refused). Returns (the fixtures cv2 reads, the skip/
    files, those PIL reads, the numbers for phase 13's line)."""
    cases, skips, pil_read = webp_fixture_checks(
        JPEG2000_MCT_FIXTURES, JPEG2000_MCT_PIL_READS, min_cases=20)
    return cases, skips, pil_read, {
        "cv2_reads": len(cases), "skip": len(skips),
        "skip_pil_reads": len(pil_read)}


def built_tiff_checks(work):
    """TIFF parts 2a and 2b on files built here: a little-endian BigTIFF of
    deflate strips and a big-endian tiled file (16 x 16 deflate tiles, edge
    tiles at the right and bottom) of BUILT_TIFF_SIZE RGB pixels, each
    decoded equal to the array it was built from, and a JPEG-compressed
    YCbCr file whose strips are whole 4:2:0 streams of the port's own JPEG
    writer (cv2.imwrite's bytes), decoded equal to the port's decode of
    each stream, stacked (libtiff hands libjpeg the stream and lets it turn
    YCbCr into RGB); each probed at its size; their host decode rates
    (BUILT_TIFF_DECODES decodes on one thread, best of JPEG_DECODE_REPS
    passes), the JPEG file's beside the plain decodes of its streams.
    Returns the numbers for phase 13's line."""
    import numpy as np
    from tsr_tpu_torch import native
    root = work / "built_tiff"
    root.mkdir(parents=True, exist_ok=True)
    h, w = BUILT_TIFF_SIZE
    y, x = np.mgrid[:h, :w]
    img = np.stack([(x * 3 + y) % 256, (y * 5) % 256, (x ^ y) % 256],
                   -1).astype(np.uint8)
    # the JPEG streams of the YCbCr file's strips, and their plain decodes
    rows = range(0, h, BUILT_TIFF_ROWS)
    streams = [root / f"strip_{y:04d}.jpg" for y in rows]
    native.write_images([str(q) for q in streams],
                        [img[y:y + BUILT_TIFF_ROWS] for y in rows])
    stacked = np.concatenate([native.decode(str(q)) for q in streams])
    out = {}
    for name, kw in (("bigtiff_strips.png", {"bigtiff": True}),
                     ("tiles_big_endian.ppm", {"tile": (16, 16), "big": True}),
                     ("jpeg_ycbcr_420.bmp", {"jpeg": [q.read_bytes()
                                                      for q in streams]})):
        p = root / name
        p.write_bytes(tiff_bytes(img, **kw))
        got = native.decode(str(p))
        want = stacked if "jpeg" in kw else img
        check(got.shape == img.shape and np.array_equal(got, want),
              f"{name} decodes unlike "
              + ("its streams' decodes" if "jpeg" in kw
                 else "the array it was built from"))
        for reader in ("port", "cv2"):
            check(native.probe([str(p)], reader=reader).tolist() == [[h, w]],
                  f"{name}: probe({reader!r})")
        best = math.inf
        for _ in range(JPEG_DECODE_REPS):
            t0 = time.perf_counter()
            for _ in range(BUILT_TIFF_DECODES):
                native.decode(str(p))
            best = min(best, time.perf_counter() - t0)
        out[name] = {"bytes": p.stat().st_size, "images_per_sec":
                     BUILT_TIFF_DECODES / best, "megapixels_per_sec":
                     BUILT_TIFF_DECODES * h * w / best / 1e6}
    best = math.inf
    for _ in range(JPEG_DECODE_REPS):
        t0 = time.perf_counter()
        for _ in range(BUILT_TIFF_DECODES):
            for q in streams:
                native.decode(str(q))
        best = min(best, time.perf_counter() - t0)
    out["jpeg_streams_plain"] = {
        "streams": len(streams), "images_per_sec": BUILT_TIFF_DECODES / best,
        "megapixels_per_sec": BUILT_TIFF_DECODES * h * w / best / 1e6}
    return out


def image_size_checks(dev, work):
    """C9 and C10 on files built here (the card's machine has no cv2): a
    BIG_PNG_SIDE-square gray PNG probes at its size by both readers, is
    kept by generate_tree's cv2 probe, decodes equal to its pixels and
    loads resized; each RAISING_HEADERS file is marked by
    probe(reader="cv2", raises=True), makes decode raise, and makes
    generate_tree over a tree that holds it raise a RuntimeError naming it
    before anything is written. Returns the numbers for phase 13's line."""
    import numpy as np
    from tsr_tpu_torch import native, offline
    root = work / "image_sizes"
    root.mkdir(parents=True, exist_ok=True)
    side = BIG_PNG_SIDE
    x = np.arange(side, dtype=np.uint32)
    pixels = ((x[None, :] * 7 + x[:, None] * 3) % 251).astype(np.uint8)
    big = root / "big.png"
    t0 = time.perf_counter()
    big.write_bytes(gray_png(side, side, pixels))
    write_s = time.perf_counter() - t0
    for reader in ("port", "cv2"):
        got = native.probe([str(big)], reader=reader).tolist()
        check(got == [[side, side]], f"{side}-square PNG: probe({reader!r})"
              f" gives {got}")
    dims, raised = native.probe([str(big)], reader="cv2", raises=True)
    check(dims.tolist() == [[side, side]] and not raised.any(),
          "generate_tree's cv2 probe keeps the big PNG")
    t0 = time.perf_counter()
    img = native.decode(str(big))
    decode_s = time.perf_counter() - t0
    check(img.shape == (side, side, 3) and all(
        np.array_equal(img[:, :, c], pixels) for c in range(3)),
        f"{side}-square PNG decodes unlike its pixels: {img.shape}")
    del img
    batch = native.load_batch([str(big)], SIZE)
    check(batch.shape == (1, SIZE, SIZE, 3), "load_batch of the big PNG")
    out = {"big_png": {"side": side, "bytes": big.stat().st_size,
                       "write_s": write_s, "decode_s": decode_s}}
    for name, (w, h) in RAISING_HEADERS.items():
        src = root / name.split(".")[0] / "src"
        bad = src / "00000" / name
        ok = src / "00001" / "ok.png"
        for d in (bad.parent, ok.parent):
            d.mkdir(parents=True, exist_ok=True)
        bad.write_bytes(gray_png(w, h) if name.startswith("png")
                        else tiff_header(w, h))
        native.write_images([str(ok)], [np.zeros((20, 24, 3), np.uint8)])
        dims, raised = native.probe([str(bad)], reader="cv2", raises=True)
        check(raised.tolist() == [True] and dims.tolist() == [[0, 0]],
              f"{name}: the cv2 probe does not mark cv2's raise")
        try:
            native.decode(str(bad))
        except RuntimeError as e:
            check("cv2.imread raises on it" in str(e), f"{name}: {e}")
        else:
            check(False, f"{name} decoded; cv2.imread raises on it")
        dst = src.parent / "dst"
        try:
            offline.generate_tree(str(src), str(dst), "blur",
                                  log=lambda line: None, device=dev)
        except RuntimeError as e:
            check(name in str(e) and not dst.exists(),
                  f"generate_tree over {name}: {e}")
        else:
            check(False, f"generate_tree wrote a tree holding {name}")
        out[name] = {"w": w, "h": h, "probe_marks_raise": True,
                     "decode_raises": True, "generate_tree_raises": True}
    return out


def image_formats_phase(dev, resunet, judge, rows, work):
    """Phase 13: the PNG, PNM, PAM, BMP, GIF, Sun raster, PFM, Radiance
    HDR, TIFF, WebP (lossless and lossy) and JPEG 2000 files cv2 reads and
    the port once refused (C5, C6, C7), and the damaged ones cv2 gives None
    for
    (C4), from the committed fixtures (the card's machine has neither cv2
    nor PIL), in ``work``: each top-level fixture decoded equal to
    ``expected.npz`` and probed as cv2 reads it; each skip/ file probed
    (0, 0) as cv2 refuses it, decoded as PIL where PIL reads it (the gray
    PFM, the TIFFs of orientation 5 to 8 and of 2 and 4-bit gray among
    them), raising otherwise (naming AVIF, JPEG 2000 of a feature the port
    leaves out and ZSTD TIFF data); the WebP fixtures and the built VP8L
    file (webp_checks), the lossy WebP fixtures with the 640 x 480 file
    (webp_lossy_checks) and the JPEG 2000 fixtures with theirs
    (jpeg2000_checks, jpeg2000_colour_checks, jpeg2000_ht_checks: HTJ2K's
    640 x 480 file timed beside part 1's), which join the trees below,
    and part 2's built file (jpeg2000_part2_checks); host decode rates by
    group (TIFF by layout, CCITT among them, lossless and lossy WebP, JPEG
    2000); the
    whole-file probe's cost on phase 5's .ppm and phase 11's .png trees;
    generate_tree on the fixture tree for IMAGE_KINDS (launch counts zeroed
    just before and read just after each call, the written count the
    reference's), B3/B2 held at its buckets; restore_tree and
    evaluate_directory over the readable files in both resize modes; then
    C9 and C10 (image_size_checks) and the TIFFs built at run time
    (built_tiff_checks, built_ccitt_checks; built_tiff_2c_checks' files
    join the trees cv2 reads, built_tiff_modes_checks' the walks' tree, as
    PIL reads them, and generate_tree's, which skips them). Returns the
    kernels'
    launches."""
    import numpy as np
    import torch
    from tsr_tpu_torch import eval as teval
    from tsr_tpu_torch import infer, native, offline
    from tsr_tpu_torch.kernels import _build
    quiet = lambda line: None  # noqa: E731
    t_phase = time.perf_counter()
    result = {"card": card_line(), "host_cpus": os.cpu_count()}
    want = np.load(IMAGE_FIXTURES / "expected.npz")
    cases = sorted(p for p in IMAGE_FIXTURES.iterdir()
                   if p.suffix in IMAGE_SUFFIXES)
    skips = sorted((IMAGE_FIXTURES / "skip").iterdir())
    check(len(cases) == int(want["generate_tree_written"]) >= 20,
          f"{len(cases)} image fixtures")
    for p in cases:
        img = native.decode(str(p))
        check(np.array_equal(img, want[f"decoded__{p.name}"]),
              f"fixture {p.name} decodes unlike cv2.imread")
        check(native.probe([str(p)], reader="cv2").tolist()
              == [list(img.shape[:2])], f"fixture {p.name}: cv2 probe")
    pil_read = []
    for p in skips:
        check(native.probe([str(p)], reader="cv2").tolist() == [[0, 0]],
              f"skip/{p.name}: probe(reader='cv2') reads what cv2 refuses")
        key = f"decoded_skip__{p.name}"
        if key in want.files:
            check(np.array_equal(native.decode(str(p)), want[key]),
                  f"skip/{p.name} decodes unlike PIL")
            pil_read.append(p)
            continue
        try:
            native.decode(str(p))
        except RuntimeError as e:
            fmt = IMAGE_FOREIGN.get(p.name)
            check((f"holds {fmt} data" if fmt else "failed to decode")
                  in str(e), f"skip/{p.name}: {e}")
        else:
            check(False, f"skip/{p.name} decoded; cv2 and PIL refuse it")
    t0 = time.perf_counter()
    webp_cases, webp_skips, webp_pil, result["webp"] = webp_checks(work)
    result["webp"]["seconds"] = time.perf_counter() - t0
    print("WebP (the RIFF container, lossless VP8L): "
          + json.dumps(result["webp"]) + ": fixtures equal to their "
          "expected.npz, skip/ files refused by the cv2 probe, decoded as "
          f"PIL or failing; the built {WEBP_BUILT_SIZE[1]} x "
          f"{WEBP_BUILT_SIZE[0]} VP8L file equal to its source, its decode "
          f"rate on one host thread beside {result['card']}")
    t0 = time.perf_counter()
    lossy_cases, lossy_skips, lossy_pil, result["webp_lossy"] = (
        webp_lossy_checks())
    result["webp_lossy"]["seconds"] = time.perf_counter() - t0
    print("lossy WebP (VP8 with its ALPH chunk): "
          + json.dumps(result["webp_lossy"]) + ": fixtures equal to their "
          "expected.npz, skip/ files refused by the cv2 probe, decoded as "
          f"PIL or failing; the {WEBP_LOSSY_BIG_SIZE[1]} x "
          f"{WEBP_LOSSY_BIG_SIZE[0]} quality-75 file equal to cv2's digest, "
          f"its decode rate on one host thread beside {result['card']}")
    t0 = time.perf_counter()
    j2k_cases, j2k_skips, j2k_pil, result["jpeg2000"] = jpeg2000_checks()
    result["jpeg2000"]["seconds"] = time.perf_counter() - t0
    print("JPEG 2000 (the JP2 file and the raw codestream): "
          + json.dumps(result["jpeg2000"]) + ": fixtures equal to their "
          "expected.npz, skip/ files refused by the cv2 probe, decoded as "
          f"PIL or failing; the {JPEG2000_BIG_SIZE[1]} x "
          f"{JPEG2000_BIG_SIZE[0]} lossy 9/7 file equal to cv2's digest, its "
          f"decode rate on one host thread beside {result['card']}")
    t0 = time.perf_counter()
    result["jpeg2000_part2"] = jpeg2000_part2_checks(work, j2k_cases,
                                                     j2k_skips, j2k_pil)
    result["jpeg2000_part2"]["seconds"] = time.perf_counter() - t0
    print("JPEG 2000 part 2 (code-block styles, POC, PPM/PPT, RGN): "
          + json.dumps(result["jpeg2000_part2"]) + ": the j2k2_ fixtures "
          f"among those above; the built {JPEG2000_BIG_SIZE[1]} x "
          f"{JPEG2000_BIG_SIZE[0]} 9/7 file of style 63 with a POC and PPT "
          "equal to cv2's digest, its decode rate "
          f"({result['jpeg2000_part2']['built']['megapixels_per_sec']:.2f} "
          f"MP/s) on one host thread beside {result['card']}")
    t0 = time.perf_counter()
    j2k3_cases, j2k3_skips, j2k3_pil, result["jpeg2000_colour"] = (
        jpeg2000_colour_checks(work))
    result["jpeg2000_colour"]["seconds"] = time.perf_counter() - t0
    print("JPEG 2000 part 3 (the colour boxes: sYCC, ICC, CIELab, CMYK, "
          "pclr/cmap, cdef): " + json.dumps(result["jpeg2000_colour"])
          + ": the j2k3_ fixtures equal to their expected.npz, skip/ files "
          "refused by the cv2 probe, decoded as PIL or failing; the built "
          f"{JPEG2000_BIG_SIZE[1]} x {JPEG2000_BIG_SIZE[0]} 9/7 file of an "
          "sYCC colr box and a cdef that moves channels equal to cv2's "
          "digest, its decode rate "
          f"({result['jpeg2000_colour']['built']['megapixels_per_sec']:.2f} "
          f"MP/s) on one host thread beside {result['card']}")
    t0 = time.perf_counter()
    j2k4_cases, j2k4_skips, j2k4_pil, result["jpeg2000_ht"] = (
        jpeg2000_ht_checks())
    result["jpeg2000_ht"]["seconds"] = time.perf_counter() - t0
    print("JPEG 2000 part 4 (HTJ2K: HT code-blocks, CAP and CPF): "
          + json.dumps(result["jpeg2000_ht"]) + ": the j2k4_ fixtures equal "
          "to their expected.npz, skip/ files refused by the cv2 probe, "
          f"decoded as PIL or failing; the {JPEG2000_BIG_SIZE[1]} x "
          f"{JPEG2000_BIG_SIZE[0]} 9/7 HTJ2K file equal to cv2's digest, its "
          "decode rate "
          f"({result['jpeg2000_ht']['big']['megapixels_per_sec']:.2f} MP/s) "
          "beside the part 1 9/7 file's "
          f"({result['jpeg2000_ht']['part1_big']['megapixels_per_sec']:.2f} "
          f"MP/s) on one host thread, beside {result['card']}")
    t0 = time.perf_counter()
    j2k5_cases, j2k5_skips, j2k5_pil, result["jpeg2000_mct"] = (
        jpeg2000_mct_checks())
    result["jpeg2000_mct"]["seconds"] = time.perf_counter() - t0
    print("JPEG 2000 part 5 (Part 2's CBD, MCT, MCC and MCO markers): "
          + json.dumps(result["jpeg2000_mct"]) + ": the j2k5_ fixtures equal "
          "to their expected.npz, skip/ files refused by the cv2 probe, "
          "decoded as PIL or failing")
    cases = (cases + webp_cases + lossy_cases + j2k_cases + j2k3_cases
             + j2k4_cases + j2k5_cases)
    skips = (skips + webp_skips + lossy_skips + j2k_skips + j2k3_skips
             + j2k4_skips + j2k5_skips)
    pil_read += (webp_pil + lossy_pil + j2k_pil + j2k3_pil + j2k4_pil
                 + j2k5_pil)
    result["fixtures"] = {
        "cv2_reads": len(cases), "skip": len(skips),
        "skip_pil_reads": len(pil_read), "foreign": len(IMAGE_FOREIGN)}
    for name, prefixes in IMAGE_SLICES.items():
        for key, files in (("cv2_reads", cases), ("skip", skips),
                           ("skip_pil_reads", pil_read)):
            result["fixtures"][f"{name}_{key}"] = sum(
                p.name.startswith(prefixes) for p in files)
    check(result["fixtures"]["pfm_hdr_skip_pil_reads"] >= 1,
          "the gray PFM PIL reads is among the skip/ files")
    check(result["fixtures"]["tiff_cv2_reads"] >= 71
          and result["fixtures"]["tiff_skip_pil_reads"] >= 14,
          f"TIFF fixtures: {result['fixtures']}")
    check(sum(p.name.startswith(IMAGE_GROUPS["tiff_ccitt"]) for p in cases)
          == 5, "the CCITT fixtures (group 4, group 3 1-D and 2-D, RLE, "
          "RLE/W) are among the files cv2 reads")
    print("image formats: " + json.dumps(result["fixtures"]) + ": fixtures "
          "equal to expected.npz, skip/ files refused by the cv2 probe, "
          "decoded as PIL or raising (AVIF, JPEG 2000, TIFF named)")
    t0 = time.perf_counter()
    built_2c, result["built_tiff_2c"] = built_tiff_2c_checks(work)
    result["built_tiff_2c"]["seconds"] = time.perf_counter() - t0
    print(f"built ThunderScan and SGILog TIFFs ({len(built_2c)} for the "
          f"tree, each equal to cv2.imread's digest; decode rates of "
          f"{BUILT_TIFF_SIZE[1]} x {BUILT_TIFF_SIZE[0]} ThunderScan and "
          f"LogLuv32 on one host thread, beside {result['card']}): "
          + json.dumps(result["built_tiff_2c"]))
    t0 = time.perf_counter()
    built_modes, result["built_tiff_modes"] = built_tiff_modes_checks(work)
    result["built_tiff_modes"]["seconds"] = time.perf_counter() - t0
    print(f"built TIFFs of Pillow's I, F and I;12 modes and old-style JPEG "
          f"({len(built_modes)} for the tree, each equal to PIL's digest, "
          f"refused by the cv2 probe; decode rates of "
          f"{BUILT_TIFF_SIZE[1]} x {BUILT_TIFF_SIZE[0]} F deflate with the "
          f"floating-point predictor and old-style JPEG on one host thread, "
          f"beside {result['card']}): "
          + json.dumps(result["built_tiff_modes"]))
    groups = {g: [str(p) for p in cases + built_2c + built_modes
                  if p.name.startswith(prefixes)
                  and p.name not in (WEBP_LOSSY_BIG, JPEG2000_BIG,
                                     JPEG2000_HT_BIG)]
              for g, prefixes in IMAGE_GROUPS.items()}
    layouts = {q for g, paths in groups.items() if g.startswith("tiff_")
              for q in paths}
    groups["tiff"] = [q for q in groups["tiff"] if q not in layouts]
    groups["webp"] = [q for q in groups["webp"]
                      if q not in groups["webp_lossy"]]
    rates = group_decode_rates(groups)
    result["host_decode"] = rates
    print(f"host decode by format (one thread of {result['host_cpus']} CPUs,"
          f" best of {JPEG_DECODE_REPS} passes of {JPEG_FEATURE_DECODES} "
          f"decodes, beside {result['card']}): " + ", ".join(
              f"{g} {v['images_per_sec']:.0f} images/s "
              f"({v['megapixels_per_sec']:.2f} MP/s)"
              for g, v in rates.items()))

    # generate_tree's skip rule reads whole files now: its cost on the
    # trees of phases 5 (.ppm) and 11 (.png twin)
    probes = {}
    for name, root in (("phase 5 .ppm", work / "clean"),
                       ("phase 11 .png", work / "jpeg_png" / "clean")):
        paths = [str(p) for p in offline.tree_files(str(root))]
        check(len(paths) == TREE_IMAGES, f"{name} tree")
        probes[name] = probe_seconds(paths)
    result["probe_tree_seconds"] = probes
    print(f"probe of {TREE_IMAGES}-file trees (8 threads, best of "
          f"{JPEG_DECODE_REPS}, beside {result['card']}): " + ", ".join(
              f"{k}: headers {v['port']:.4f} s, as cv2 reads "
              f"{v['cv2']:.4f} s" for k, v in probes.items()))

    root = work / "image_formats"
    readable, mixed = root / "readable", root / "mixed"
    readable_files = cases + built_2c
    for k, p in enumerate(readable_files + built_modes
                          + [q for q in skips if q.name not in IMAGE_FOREIGN]):
        for tree in ((readable, mixed) if p in readable_files else (mixed,)):
            out = tree / f"c{k % 3}" / p.name
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_bytes(p.read_bytes())
    for k, p in enumerate(pil_read + built_modes):  # read by PIL's fallback
        out = readable / f"c{k % 3}" / p.name
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(p.read_bytes())
    written = int(want["generate_tree_written"]) + len(built_2c) + len(
        webp_cases) + len(lossy_cases) + len(j2k_cases) + len(j2k3_cases) + (
        len(j2k4_cases)) + len(j2k5_cases)
    mixed_files = offline.tree_files(str(mixed))
    dims = native.probe([str(p) for p in mixed_files], reader="cv2")
    kept = [p for p, d in zip(mixed_files, dims.tolist()) if d[0] > 0]
    check(len(kept) == written, f"probe(reader='cv2') reads {len(kept)} "
          f"files; the reference reads {written}")
    sides = [tuple(d) for d in dims.tolist() if d[0] > 0]
    built_sides = [tuple(TIFF_2C_FILES[p.name][1:3]) for p in built_2c]
    for kind in IMAGE_KINDS:  # the built files bring no bucket of their own
        halo = offline.HALO.get(kind, 0)
        rest = list(sides)
        for side in built_sides:
            rest.remove(side)
        check(set(tree_buckets(built_sides, halo)) <= set(
            tree_buckets(rest, halo)), f"TIFF 2c files add a {kind} bucket")
    launches = {"blur_sparse": 0, "blur_dense": 0, "fog_noise": 0}
    gen = {}
    for kind in IMAGE_KINDS:
        buckets = tree_buckets(sides, offline.HALO.get(kind, 0))
        n_batches = sum(-(-n // TREE_BATCH) for n in buckets.values())
        lines = []
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        n = offline.generate_tree(str(mixed), str(root / kind), kind,
                                  seed=SEED, batch_size=TREE_BATCH,
                                  log=lines.append, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = _build.launch_counts()
        want_counts = {
            "blur_dense": n_batches if kind in ("blur", "compound") else 0,
            "blur_sparse": n_batches if kind == "blur_rand" else 0,
            "fog_noise": 0}
        skipped = len(mixed_files) - written
        check(n == written, f"generate_tree {kind} wrote {n}; the "
              f"reference writes {written}")
        check(f"Skipped {skipped} unreadable files" in lines,
              f"generate_tree {kind} log: {lines}")
        check(counts == want_counts, f"generate_tree {kind} launched "
              f"{counts}, expected {want_counts}")
        outs = list((root / kind).glob("*/*"))
        check(len(outs) == written, f"generate_tree {kind}: {len(outs)} files")
        for k, v in counts.items():
            launches[k] += v
        # each slice's files written, and those of its files the reference
        # skips
        by_slice = {}
        for name, prefixes in IMAGE_SLICES.items():
            mine = sum(p.name.startswith(prefixes) for p in mixed_files)
            out_n = sum(p.name.startswith(prefixes) for p in outs)
            want_n = sum(p.name.startswith(prefixes) for p in kept)
            check(out_n == want_n, f"generate_tree {kind} wrote {out_n} "
                  f"{name} files; the reference writes {want_n}")
            by_slice[name] = {"written": out_n, "skipped": mine - out_n}
        gen[kind] = dict(images_per_sec=n / dt, seconds=dt, written=n,
                         skipped=skipped, batches=n_batches,
                         buckets=len(buckets), launches=counts,
                         by_slice=by_slice)
        print(f"generate_tree {kind} on the image fixtures: {n} written, "
              f"{skipped} skipped as the reference skips them, "
              f"{n / dt:.1f} images/s, {n_batches} batches, B2 "
              f"{counts['blur_sparse']} / B3 {counts['blur_dense']} "
              "launches; by slice " + json.dumps(by_slice))
    result["generate_tree"] = gen
    check(launches["blur_sparse"] > 0 and launches["blur_dense"] > 0,
          "B2 and B3 launched on the image formats path")
    # the buckets only each slice's files bring, each with its images and
    # the launches of its batches (B3 for blur and compound, B2 for
    # blur_rand: one a batch of TREE_BATCH, counted in all above): B3 and
    # B2 are held at the first batch of every bucket below, these among
    # them
    result["slice_buckets"] = {}
    for name, prefixes in IMAGE_SLICES.items():
        this_slice = [p.name.startswith(prefixes)
                      for p, d in zip(mixed_files, dims.tolist()) if d[0] > 0]
        result["slice_buckets"][name] = {}
        for kind in IMAGE_KINDS:
            halo = offline.HALO.get(kind, 0)
            mine = tree_buckets([s for s, m in zip(sides, this_slice) if m],
                                halo)
            rest = tree_buckets([s for s, m in zip(sides, this_slice)
                                 if not m], halo)
            result["slice_buckets"][name][kind] = [
                [list(b), mine[b], -(-mine[b] // TREE_BATCH)]
                for b in sorted(set(mine) - set(rest))]
    print("buckets only each slice's files bring ([bucket, images, B3 "
          "launches for blur and compound, B2 for blur_rand]): "
          + json.dumps(result["slice_buckets"]))
    check_blur_at_buckets(dev, kept, rows, key="image_format_times")

    n_readable = len(readable_files) + len(pil_read) + len(built_modes)
    walks, evals = {}, {}
    _build.reset_launch_counts()
    for resize in ("device", "host"):
        res = infer.restore_tree(resunet, str(readable),
                                 str(root / f"restored_{resize}"),
                                 clean_dir=str(readable), batch_size=BATCH,
                                 size=SIZE, resize=resize, log=quiet,
                                 device=dev)
        check(res["images"] == n_readable and math.isfinite(res["psnr"])
              and 0 <= res["ssim"] <= 1, f"restore_tree {resize}: {res}")
        ev = teval.evaluate_directory(judge, str(readable), batch_size=BATCH,
                                      size=SIZE, restorer=resunet,
                                      resize=resize, device=dev)
        check(ev["n"] == n_readable and 0 <= ev["top1"] <= 1
              and math.isfinite(ev["confidence"]),
              f"evaluate_directory {resize}: {ev}")
        walks[resize] = {k: res[k] for k in ("images_per_sec", "psnr",
                                             "ssim", "batches")}
        evals[resize] = {k: ev[k] for k in ("n", "top1", "confidence",
                                            "images_per_sec")}
        print(f"restore_tree / evaluate_directory, resize={resize}: "
              f"{res['images']} images, PSNR {res['psnr']:.4f} dB, SSIM "
              f"{res['ssim']:.5f}; top-1 {ev['top1']:.4f}, confidence "
              f"{ev['confidence']:.6f}")
    check(sum(_build.launch_counts().values()) == 0,
          "the walks launch no blur or B1 kernel")
    result["restore_tree"] = walks
    result["evaluate_directory"] = evals
    t0 = time.perf_counter()
    result["image_sizes"] = image_size_checks(dev, work)
    result["image_sizes"]["seconds"] = time.perf_counter() - t0
    print("image sizes (C9, C10): " + json.dumps(result["image_sizes"]))
    t0 = time.perf_counter()
    result["built_tiff"] = built_tiff_checks(work)
    result["built_tiff"]["seconds"] = time.perf_counter() - t0
    print(f"built TIFFs (BigTIFF strips, big-endian tiles, JPEG YCbCr "
          f"4:2:0 beside a plain decode of its streams, "
          f"{BUILT_TIFF_SIZE[1]} x {BUILT_TIFF_SIZE[0]} RGB, beside "
          f"{result['card']}): " + json.dumps(result["built_tiff"]))
    t0 = time.perf_counter()
    result["built_ccitt"] = built_ccitt_checks(work)
    result["built_ccitt"]["seconds"] = time.perf_counter() - t0
    print(f"built fax page ({FAX_PAGE[1]} x {FAX_PAGE[0]}, group 4 and "
          f"group 3 2-D, equal to its bitmap, one host thread, beside "
          f"{result['card']}): " + json.dumps(result["built_ccitt"]))
    t0 = time.perf_counter()
    result["tiff_scanline"], scanline = tiff_scanline_checks(
        dev, resunet, judge, rows, work)
    result["tiff_scanline"]["seconds"] = time.perf_counter() - t0
    for k, v in scanline.items():
        launches[k] += v
    print(f"TIFF scanline branch ({TIFF_SCANLINE_SIZE[1]} x "
          f"{TIFF_SCANLINE_SIZE[0]} single deflate strips, MINISWHITE and "
          f"orientation 3 equal to cv2.imread's digests, the half stream "
          f"refused; decode on one host thread, peak RSS of a child that "
          f"only decodes, beside {result['card']}): "
          + json.dumps(result["tiff_scanline"]))
    result["launches"] = launches
    result["phase_seconds"] = time.perf_counter() - t_phase
    print("image_formats: " + json.dumps(result))
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        import tsr_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    # a bare "cuda", as the entry points default to it
    run(torch.device("cuda"))
    return 0


def run(dev) -> None:
    import torch
    from tsr_tpu_torch import configs
    from tsr_tpu_torch import eval as teval
    from tsr_tpu_torch import pipeline
    from tsr_tpu_torch.kernels import _build
    from tsr_tpu_torch.models import ResUNet, VGG16
    from tsr_tpu_torch.ops import distortions

    # fp32 comparisons must not run in TF32 (cuDNN's default for convs)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; TF32 off for cuDNN and matmul")

    # -- 1. build every kernel of the slice, in parallel ------------------
    t0 = time.perf_counter()
    report = _build.build(sorted({k.source for k in _build.KERNELS}))
    print(f"kernel build: {time.perf_counter() - t0:.1f} s wall for "
          f"{len(report)} sources ({_build.BUILD_DIR})")
    for src, info in report.items():
        lines = [ln.strip() for ln in info["ptxas"].splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"  {src}: {info['seconds']:.1f} s; " + " | ".join(lines))

    # -- 2. kernel checks at the slice's shapes -----------------------------
    rows = kernel_checks(dev)

    # -- 3. the slice at full width ------------------------------------------
    torch.manual_seed(SEED)
    with torch.device(dev):
        resunet = ResUNet((64, 128, 256), 512, dtype="bf16")
        judge = VGG16(num_classes=configs.NUM_CLASSES, fc_width=4096,
                      input_size=SIZE, dtype="bf16")
    resunet = resunet.to(memory_format=torch.channels_last)
    judge = judge.to(memory_format=torch.channels_last)
    n_params = sum(p.numel() for m in (resunet, judge)
                   for p in m.parameters())
    step = teval.make_fused_eval_step(resunet, judge, device=dev)
    judge_only = teval.make_fused_eval_step(None, judge, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    batch = configs.EvalConfig().batch_size
    cleans = [torch.randint(0, 256, (batch, SIZE, SIZE, 3),
                            dtype=torch.uint8, device=dev, generator=g)
              for _ in range(N_BATCHES)]
    labels = [torch.randint(0, configs.NUM_CLASSES, (batch,), device=dev,
                            generator=g) for _ in range(N_BATCHES)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launch_counts()
    t_slice = time.perf_counter()
    # the mix's metric: one synchronised window over the steady batches
    bads = [distortions.apply_random_distortions(cleans[0], g, device=dev)]
    torch.cuda.synchronize()
    marks = [time.perf_counter()]
    for clean in cleans[1:]:
        bads.append(distortions.apply_random_distortions(clean, g,
                                                         device=dev))
        marks.append(time.perf_counter())  # host return, no synchronise
    torch.cuda.synchronize()
    mix_window_ms = (time.perf_counter() - marks[0]) * 1e3 / (N_BATCHES - 1)
    mix_enqueue_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    # diagnostic: each batch timed alone, to show the spread and stalls
    mix_ms = []
    for clean in cleans[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        distortions.apply_random_distortions(clean, g, device=dev)
        torch.cuda.synchronize()
        mix_ms.append((time.perf_counter() - t0) * 1e3)
    restored = teval.evaluate_batches(step, list(zip(bads, labels)),
                                      device=dev)
    distorted = teval.evaluate_batches(judge_only, list(zip(bads, labels)),
                                       device=dev)
    demo = pipeline.unified_demo(cleans[0], resunet, judge, g, device=dev)
    torch.cuda.synchronize()
    slice_s = time.perf_counter() - t_slice
    counts = _build.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30

    for bad in bads:
        check(bad.shape == cleans[0].shape and bad.dtype == torch.uint8,
              "random mix output shape/dtype")
    for res in (restored, distorted):
        check(res["n"] == N_BATCHES * batch, "every image evaluated")
        check(0.0 <= res["top1"] <= 1.0 and math.isfinite(res["confidence"]),
              "top-1 in [0, 1] and finite confidence")
    for name, r in demo["judge"].items():
        check(all(math.isfinite(c) for c in r["confidence"].tolist()),
              f"demo {name} confidence finite")
    check(demo["restored_u8"].shape == tuple(cleans[0].shape),
          "demo restored shape")
    check(counts["fog_noise"] > 0, "B1 launched on the main path")
    check(counts["blur_sparse"] > 0, "B2 launched on the main path")
    check(counts["blur_dense"] > 0, "B3 launched by unified_demo")
    summary = {
        "slice": "random mix -> ResUNet -> VGG16 judge", "batch": batch,
        "size": SIZE, "dtype": "bf16", "params": n_params,
        "steady_batches": N_BATCHES - 1,
        "mix_ms_per_batch": mix_window_ms,
        "mix_window_host_ms_each": mix_enqueue_ms,
        "mix_ms_each_synced_median": sorted(mix_ms)[len(mix_ms) // 2],
        "mix_ms_each_synced": mix_ms,
        "fused_images_per_sec": restored["images_per_sec"],
        "judge_only_images_per_sec": distorted["images_per_sec"],
        "top1_restored": restored["top1"],
        "top1_distorted": distorted["top1"],
        "confidence_restored": restored["confidence"],
        "demo_confidence": {k: float(v["confidence"].mean())
                            for k, v in demo["judge"].items()},
        "peak_memory_gib": peak_gib, "slice_seconds": slice_s,
        "launches": counts}
    print("slice: " + json.dumps(summary))

    # where the device time goes, per layer (diagnostic only)
    for label, fn in (
            ("random mix", lambda: distortions.apply_random_distortions(
                cleans[1], g, device=dev)),
            ("fused step", lambda: step(bads[1], labels[1]))):
        breakdown = device_breakdown(fn)
        if breakdown is None:
            break
        prof_rows, busy, n_kernels, wall, _ = breakdown
        print(f"profile of one {label} batch: device busy {busy:.3f} ms "
              f"over {wall:.3f} ms wall; {n_kernels} device kernels")
        if label == "random mix":
            print(f"kernels per random-mix batch: {n_kernels}")
        for kname, ms, n in prof_rows:
            print(f"  {ms:8.3f} ms {n:4d}x  {kname[:110]}")

    small_reference_check(dev)

    # -- 4. the unified trainer at full width --------------------------------
    train_counts = train_phase(dev, judge)
    small_train_check(dev)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # -- 5. the file-tree pipeline at full width -------------------------
        tree_counts, tree_shapes = trees_phase(
            dev, resunet, judge, rows, restored["images_per_sec"], Path(tmp))
        # -- 6. the SimpleUNet restorers and the cascade ---------------------
        cascade_counts = cascade_phase(dev, judge, rows, Path(tmp))
        # -- 7. the judge's trainers and the interpretability arm ------------
        judge_counts = judge_phase(dev, Path(tmp))
        # -- 8. int8 serving and the streamed trainers -----------------------
        int8_counts = int8_phase(dev, resunet, judge, Path(tmp))
        # -- 9. the CLI on the card ------------------------------------------
        cli_counts = cli_phase(dev, Path(tmp))
        # -- 10. multi-device, ranks sharing the card ------------------------
        mesh_counts = mesh_phase(dev, Path(tmp))
        # -- 11. the port's JPEG codec through the tree pipeline -------------
        jpeg_counts = jpeg_phase(dev, resunet, judge, Path(tmp))
        # -- 12. the JPEG data cv2 reads with a warning, or rarely ----------
        feature_counts = jpeg_features_phase(dev, resunet, judge, Path(tmp))
        # -- 13. PNG / PNM / PAM / BMP as cv2 reads them, damaged ones too --
        format_counts = image_formats_phase(dev, resunet, judge, rows,
                                            Path(tmp))

    for row in rows:
        key = {"B1": "fog_noise", "B2": "blur_sparse",
               "B3": "blur_dense"}[row["name"][:2]]
        row["launches"] = counts[key]
        row["launches_train"] = train_counts[key]
        row["launches_trees"] = tree_counts[key]
        row["tree_shapes"] = tree_shapes.get(key, [])
        row["launches_cascade"] = cascade_counts[key]
        row["launches_judge"] = judge_counts[key]
        row["launches_int8"] = int8_counts[key]
        row["launches_cli"] = cli_counts.get(key, 0)
        row["launches_mesh"] = mesh_counts.get(key, 0)
        row["launches_jpeg"] = jpeg_counts[key]
        row["launches_jpeg_features"] = feature_counts[key]
        row["launches_image_formats"] = format_counts[key]
        row.setdefault("launches_tiff_scanline", 0)
        row.setdefault("cascade_shapes", [])
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
