#!/usr/bin/env python3
"""Time variants of the blur kernels' source on one NVIDIA GPU.

A tuning aid for ``tsr_tpu_torch/kernels/csrc/blur_taps.cu`` (kernels B2
and B3). Each variant is the source with regular-expression substitutions
applied in order; ``"base": []`` is the source as it is, and a path in
place of the list names another version of the source. Every variant is
built with the port's nvcc flags into ``build/blur_variants/`` (all in
parallel), run once at the random mix's shapes (64x224x224x3, K=15, the
same seeded inputs as ``chip_smoke.py``) and compared with the plain
version, then timed with ``chip_smoke.cuda_ms`` twice, variants taken in
turn. Two entry points appended to each variant time the pre-pass and the
main kernel alone. A variant that drops work on purpose (no taps, no halo
loads) reports its error instead of failing.

    python3 blur_variants.py            # the ablations below
    python3 blur_variants.py '{"base": [], "no-taps": [["const int nruns = meta\\\\[0\\\\];", "const int nruns = 0;"]]}'
    python3 blur_variants.py @variants.json

Prints each variant's registers per C=3 instantiation (ptxas), then one
JSON line per variant: ``{case: [ms, ms], case + "_err": max abs err}``.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

_NO_HALO = [r"__pipeline_memcpy_async\(drow",
            "if (bd.ksize < 0) __pipeline_memcpy_async(drow"]
_NO_STORES = [r"for \(int r = warp; r < vh; r \+= kWarps\) \{",
              "for (int r = warp; r < (bd.ksize < 0 ? vh : 0); r += kWarps) {"]
# What B2/B3 spend their time on: the kernel without its taps, without its
# halo copies, without halo copies and stores, and at five and three CTAs
# an SM (96 registers; shared memory padded to 72000 bytes).
ABLATIONS = {
    "base": [],
    "no-taps": [[r"const int nruns = meta\[0\];", "const int nruns = 0;"]],
    "no-halo-copies": [_NO_HALO],
    "no-halo-copies-no-stores": [_NO_HALO, _NO_STORES],
    "five-ctas-96-registers": [[r"__launch_bounds__\(kThreads, 4\)",
                                "__launch_bounds__(kThreads, 5)"]],
    "three-ctas": [["const size_t smem = ", "const size_t smem = 72000 + 0 * "]],
}

ENTRY_POINTS = r'''
extern "C" int tsr_prep_only(const void* kernels, int64_t kstride, void* runs,
                             int batch, int ksize, int dense, void* stream) {
  const size_t smem = sizeof(float) * ksize * ksize + sizeof(int) * 3 * ksize;
  build_runs_kernel<<<batch, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(kernels), kstride, ksize, dense,
      static_cast<float*>(runs));
  return cudaGetLastError();
}
extern "C" int tsr_main_only(const void* x, const void* runs, int batch,
                             int height, int width, int ksize, void* out,
                             void* stream) {
  return launch_k<3>(static_cast<const float*>(x),
                     static_cast<const float*>(runs), nullptr, nullptr, batch,
                     height, width, ksize, static_cast<float*>(out), nullptr,
                     static_cast<cudaStream_t>(stream));
}
'''


def build_variants(variants):
    from tsr_tpu_torch.kernels import _build
    src0 = (_build.CSRC / "blur_taps.cu").read_text()
    out = _build.BUILD_DIR.parent / "blur_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in variants.items():
        src = src0
        if isinstance(subs, str):  # another version of the source, as it is
            src, subs = Path(subs).read_text(), []
        for pattern, repl in subs:
            new = re.sub(pattern, repl, src)
            if new == src:
                raise ValueError(f"variant {name}: {pattern!r} matches nothing")
            src = new
        src = src.replace("}  // namespace", "}  // namespace\n" + ENTRY_POINTS)
        cu = out / f"{name}.cu"
        cu.write_text(src)
        so = out / f"{name}.so"
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        regs, fn, frame = [], None, ""
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            fn = m.group(1) if m else fn
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
            frame = f"stack {m.group(1)} B, spills {m.group(2)} B" if m else frame
            m = re.search(r"Used (\d+) registers", line)
            if m and fn and "ILi3E" in fn:
                k = re.search(r"ILi3ELi(\d+)E", fn).group(1)
                regs.append(f"<3,{k}>: {m.group(1)} registers, {frame}")
        print(f"{name}: " + "; ".join(regs))
        libs[name] = ctypes.CDLL(str(so))
    return libs


def entry_points(lib, name):
    from tsr_tpu_torch.kernels import _build
    from tsr_tpu_torch.kernels import blur as kblur
    kernels = []
    for symbol, base in (("tsr_blur_sparse", kblur.BLUR_SPARSE),
                         ("tsr_blur_dense", kblur.BLUR_DENSE)):
        k = _build.Kernel(f"{name}:{symbol}", base.source, symbol,
                          base.argtypes)
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = base.argtypes, ctypes.c_int
        err = lib.tsr_error_string
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        k._fn, k._err_str = fn, err
        kernels.append(k)
    prep, main = lib.tsr_prep_only, lib.tsr_main_only
    prep.argtypes = ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
                     + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    main.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p] * 2
    for fn in (prep, main):
        fn.restype = ctypes.c_int
    return kernels, prep, main


def run(variants) -> None:
    import torch
    import chip_smoke as cs
    from tsr_tpu_torch import configs
    from tsr_tpu_torch.kernels import blur as kblur
    from tsr_tpu_torch.kernels import distort as kdistort
    from tsr_tpu_torch.ops import blur as tblur
    from tsr_tpu_torch.ops import distortions

    libs = build_variants(variants)
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    b, size, k = cs.BATCH, cs.SIZE, cs.K
    clean = torch.randint(0, 256, (b, size, size, 3), dtype=torch.uint8,
                          device=dev, generator=g)
    draws = distortions.draw_random_mix(b, g, configs.RandomMixConfig())
    ones = torch.ones(b, dtype=torch.int32, device=dev)
    f, x = kdistort.fused_fog_noise(clean, draws.seed,
                                    draws.gate_fog.to(torch.int32), draws.t,
                                    ones, draws.sigma)
    kerns = tblur.motion_blur_kernels(draws.degrees, draws.angles, k)
    k10 = tblur.motion_blur_kernel(10, 45.0, max_degree=10,
                                   device=dev).expand(b, 10, 10)
    box = torch.full((b, k, k), 1.0 / (k * k), device=dev)
    gate = draws.gate_blur
    ref = kblur.filter2d_plain(x, kerns)
    refs = {"B2": ref, "B3": ref, "mainB2": ref, "mainB3": ref,
            "B2u8": kblur.random_mix_epilogue_plain(ref, f, gate),
            "B3k10": kblur.filter2d_plain(x, k10),
            "B2box": kblur.filter2d_plain(x, box), "prep": None}
    print(f"copy of the batch (x.clone()): {cs.cuda_ms(lambda: x.clone())} ms;"
          f" {int(gate.sum())} of {b} blur gates on")
    words = kblur.run_words(k)
    stream = torch.cuda.current_stream().cuda_stream
    results = {name: {} for name in libs}
    points = {name: entry_points(lib, name) for name, lib in libs.items()}
    for rep in range(2):
        for name in libs:
            (sparse, dense), prep, main = points[name]
            runs_s = torch.empty(b * words, device=dev)
            runs_d = torch.empty(b * words, device=dev)
            out = torch.empty_like(x)
            for runs, is_dense in ((runs_s, 0), (runs_d, 1)):
                prep(kerns.data_ptr(), k * k, runs.data_ptr(), b, k, is_dense,
                     stream)

            def main_only(runs):
                main(x.data_ptr(), runs.data_ptr(), b, size, size, k,
                     out.data_ptr(), stream)
                return out

            cases = {
                "B2": lambda: kblur._launch(sparse, x, kerns, None, None),
                "B3": lambda: kblur._launch(dense, x, kerns, None, None),
                "B2u8": lambda: kblur._launch(sparse, x, kerns, f, gate),
                "B3k10": lambda: kblur._launch(dense, x, k10, None, None),
                "B2box": lambda: kblur._launch(sparse, x, box, None, None),
                "prep": lambda: prep(kerns.data_ptr(), k * k,
                                     runs_s.data_ptr(), b, k, 0, stream),
                "mainB2": lambda: main_only(runs_s),
                "mainB3": lambda: main_only(runs_d),
            }
            for case, fn in cases.items():
                got = fn()
                torch.cuda.synchronize()
                if rep == 0 and refs[case] is not None:
                    results[name][case + "_err"] = (
                        got.float() - refs[case].float()).abs().max().item()
                results[name].setdefault(case, []).append(cs.cuda_ms(fn))
    for name, res in results.items():
        print(f"{name} {json.dumps(res)}")


def main() -> int:
    if len(sys.argv) > 2:
        print(__doc__, file=sys.stderr)
        return 2
    arg = sys.argv[1] if len(sys.argv) == 2 else None
    if arg is None:
        variants = ABLATIONS
    elif arg.startswith("@"):
        variants = json.loads(Path(arg[1:]).read_text())
    else:
        variants = json.loads(arg)
    import torch
    if not torch.cuda.is_available():
        print("blur_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    run(variants)
    return 0


if __name__ == "__main__":
    sys.exit(main())
