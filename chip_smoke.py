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
9. One JSON line of the kernels (with ``launches_trees``, ``tree_shapes``,
   ``launches_cascade``, ``cascade_shapes``, ``launches_judge`` and
   ``launches_int8``), the card's line, and the final ``{"ok": true,
   ...}`` line.

Any failed check raises, so the script exits non-zero and prints no
result line. It also exits non-zero without CUDA or outside a checkout.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
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
INT8_BENCH_BATCH, INT8_BENCH_CHUNKS, INT8_BENCH_REPS = 512, 8, 3
UNIFIED_CKPT_EPOCHS = 2
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, published peak
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


def check_blur_at_buckets(dev, clean_dir, rows):
    """B3 (blur's shared K=12, compound's shared K=10) and B2 (blur_rand's
    per-sample K=15) on the first padded batch of each of their buckets,
    against filter2d_plain on the same batch: max error < 1e-3, and the
    uint8 after cvRound/saturate compared value by value. Three shapes a
    kind are timed beside their bound and their plain version: the batch
    with the most pixels, the smallest canvas and the largest. Adds
    ``tree_times`` to the B2 and B3 rows."""
    import torch
    from tsr_tpu_torch import offline
    from tsr_tpu_torch.kernels import blur as kblur
    from tsr_tpu_torch.ops import blur as tblur
    from tsr_tpu_torch.ops import distortions
    files = offline.tree_files(str(clean_dir))
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    rows[1]["tree_times"], rows[2]["tree_times"] = {}, {}
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
            row["tree_times"][f"{kind} {b}x{h}x{w}x{c} K={k}"] = dict(
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

    check_blur_at_buckets(dev, clean, rows)
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
        row.setdefault("cascade_shapes", [])
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
