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
4. One JSON line of the kernels, the card's line, and the final
   ``{"ok": true, ...}`` line.

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
    wall time measured inside the profiled window; returns (rows of (name,
    ms, launches), busy_ms, n_kernels, wall_ms), or None if the profiler
    cannot start or be read. A failure of ``fn`` itself always propagates."""
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
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
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
                  key=lambda r: -r[1])[:top]
    return rows, busy, len(events), wall_ms


def kernel_checks(dev):
    """Phase 2: each kernel against its plain version, then timed."""
    import torch
    import torch.nn.functional as F
    from tsr_tpu_torch import configs
    from tsr_tpu_torch.kernels import blur as kblur
    from tsr_tpu_torch.kernels import distort as kdistort
    from tsr_tpu_torch.ops import blur as tblur
    from tsr_tpu_torch.ops import distortions
    g = torch.Generator(device=dev).manual_seed(SEED)
    clean = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), dtype=torch.uint8,
                          device=dev, generator=g)
    draws = distortions.draw_random_mix(BATCH, g, configs.RandomMixConfig())
    gate_fog = draws.gate_fog.to(torch.int32)
    ones = torch.ones(BATCH, dtype=torch.int32, device=dev)
    zeros = torch.zeros(BATCH, device=dev)
    rows = []

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
    z = (f_n - f).reshape(BATCH, -1) / draws.sigma.reshape(-1, 1)
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
    print(f"B1 fog_noise: f max err {b1_err:.3g} (tol 1e-6), pre_blur "
          f"mismatches {pre_mismatch}; noise z = (f - fogged)/sigma, worst "
          f"sample: " + ", ".join(
              f"{stat} off by {err:.4g} ({err / se:.2f} SE)"
              for stat, (err, se) in stats.items())
          + f" (tol {NOISE_SE} SE)")

    n = clean.numel()
    args = (clean, draws.seed, gate_fog, draws.t, ones, draws.sigma)
    b1_ms = cuda_ms(lambda: kdistort.fused_fog_noise(*args))
    g_plain = torch.Generator(device=dev).manual_seed(SEED)
    b1_plain = cuda_ms(lambda: kdistort.fog_noise_plain(
        clean, gate_fog, draws.t, ones, draws.sigma, generator=g_plain))
    t_b, by = bound(n * 1 + 2 * n * 4 + BATCH * 16 + 8, 10 * n)
    rows.append(dict(
        name="B1 fog_noise", route="cuda",
        source="tsr_tpu_torch/kernels/csrc/fog_noise.cu",
        replaces="tsr_tpu/kernels/distort.py:131", max_abs_err=b1_err,
        tol=1e-6, ms=b1_ms, plain_ms=b1_plain, bound_ms=t_b, bound_by=by,
        library_ms=None))

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

    # B2 with the random mix's epilogue in its store, on B1's outputs
    gate = draws.gate_blur
    got = kblur.filter2d_sparse(x, kerns, f=f_n, gate_blur=gate)
    ref = kblur.random_mix_epilogue_plain(kblur.filter2d_plain(x, kerns),
                                          f_n, gate)
    torch.cuda.synchronize()
    diff = (got.int() - ref.int()).abs()
    lsb, n_diff = int(diff.max()), int((diff != 0).sum())
    check(lsb <= 1, f"B2+epilogue differs by {lsb} LSB")
    ms = cuda_ms(lambda: kblur.filter2d_sparse(x, kerns, f=f_n,
                                               gate_blur=gate))
    plain = cuda_ms(lambda: kblur.random_mix_epilogue_plain(
        kblur.filter2d_plain(x, kerns), f_n, gate))
    n_on = int(gate.sum())
    # gate on: the blur input is read; gate off: f is read; uint8 written
    t_b, by = bound(pix * 4 + pix + b * K * K * 4,
                    2 * int((kerns[gate] != 0).sum()) * h * w * c)
    epilogue = dict(name="B2+epilogue blur_sparse", max_lsb=lsb,
                    n_differ=n_diff, ms=ms, plain_ms=plain, bound_ms=t_b,
                    bound_by=by, gates_on=n_on)
    print(f"B2+epilogue: max {lsb} LSB (tol 1), {n_diff} of {pix} values "
          f"differ; {ms:.4f} ms, bound {t_b:.4f} ms ({by}, {n_on} of {b} "
          f"gates on), plain {plain:.4f} ms")
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
        prof_rows, busy, n_kernels, wall = breakdown
        print(f"profile of one {label} batch: device busy {busy:.3f} ms "
              f"over {wall:.3f} ms wall; {n_kernels} device kernels")
        if label == "random mix":
            print(f"kernels per random-mix batch: {n_kernels}")
        for kname, ms, n in prof_rows:
            print(f"  {ms:8.3f} ms {n:4d}x  {kname[:110]}")

    small_reference_check(dev)

    for row in rows:
        key = {"B1": "fog_noise", "B2": "blur_sparse",
               "B3": "blur_dense"}[row["name"][:2]]
        row["launches"] = counts[key]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
