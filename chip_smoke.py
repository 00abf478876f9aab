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
6. One JSON line of the kernels (with ``launches_trees`` and
   ``tree_shapes``), the card's line, and the final ``{"ok": true, ...}``
   line.

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
import time

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
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, published peak
FP32_FLOPS = 67e12           # H100 SXM non-tensor fp32, published peak


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
                                   "wgrad", "cutlass", "sm90_")),
         ("batch norm and its statistics", ("batchnorm", "batch_norm",
                                            "bn_", "Welford")),
         ("optimizer (multi-tensor)", ("multi_tensor", "Adam")),
         ("reductions", ("reduce_kernel",)),
         ("casts and copies", ("copy", "cat_")),
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


def trees_phase(dev, resunet, judge, rows, fused_ips):
    """Phase 5: the file-tree pipeline at full width. A seeded clean tree;
    generate_tree for each of the seven kinds (B3 for blur and compound, B2
    for blur_rand, launch counts zeroed just before each call and read just
    after); the blur kernels held at every bucket shape; the blur tree on
    the card against the CPU; restore_tree (device and host resize) and
    evaluate_directory (host and device) on the compound tree; the device
    resize alone; where the walk's time goes. Returns the B2/B3 launches of
    the generate_tree runs and the buckets each ran at."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch
    from tsr_tpu_torch import eval as teval
    from tsr_tpu_torch import infer, native, offline
    from tsr_tpu_torch.kernels import _build
    quiet = lambda line: None  # noqa: E731
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trees_") as tmp:
        work = Path(tmp)
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

    # -- 5. the file-tree pipeline at full width -----------------------------
    tree_counts, tree_shapes = trees_phase(dev, resunet, judge, rows,
                                           restored["images_per_sec"])

    for row in rows:
        key = {"B1": "fog_noise", "B2": "blur_sparse",
               "B3": "blur_dense"}[row["name"][:2]]
        row["launches"] = counts[key]
        row["launches_train"] = train_counts[key]
        row["launches_trees"] = tree_counts[key]
        row["tree_shapes"] = tree_shapes.get(key, [])
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
