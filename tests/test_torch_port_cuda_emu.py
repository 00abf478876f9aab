"""The port's CUDA sources, compiled with g++ against a CPU stand-in for
the CUDA runtime (tests/torch_port_cuda_emu.h) and run through the real
wrappers' CUDA branches.

The CUDA kernels run on the card only in ``chip_smoke.py``; these tests
check their index math, tap offsets, reflect-101 halo, Philox stream and
the wrappers' argument packing and launch counts on the CPU, against the
same plain PyTorch versions the card is held to. Small shapes: every CUDA
thread is an OS thread here.
"""

import ctypes
import dataclasses
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from tsr_tpu_torch.kernels import _build
from tsr_tpu_torch.kernels import blur as kblur
from tsr_tpu_torch.kernels import distort as kdistort
from tsr_tpu_torch.ops import blur as tblur
from tsr_tpu_torch.ops import distortions

torch.set_num_threads(2)
SHIM = Path(__file__).resolve().parent / "torch_port_cuda_emu.h"
LAUNCH = re.compile(r"([\w:]+(?:<[\w\s,:]*>)?)<<<(.*?)>>>\((.*?)\);", re.S)
SHARED = re.compile(r"extern __shared__ (?:__align__\(\d+\) )?float smem\[\];")


def _translate(source: str) -> str:
    """A .cu source as C++ for the CPU stand-in."""
    src = (_build.CSRC / source).read_text()
    src = src.replace("#include <cuda_runtime.h>", f'#include "{SHIM}"')
    src = src.replace("#include <cuda_pipeline_primitives.h>", "")
    src = SHARED.sub("float* smem = emu_shared;", src)

    def launch(m):
        grid, block, smem, _stream = (p.strip() for p in m.group(2).split(","))
        return (f"emu_launch({grid}, dim3({block}), {smem}, "
                f"[&] {{ {m.group(1)}({m.group(3)}); }});")
    return LAUNCH.sub(launch, src)


def _compile(tmp, name, src, shared=True):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the CPU")
    cpp = tmp / f"{name}.cpp"
    cpp.write_text(src)
    out = tmp / (f"lib{name}.so" if shared else name)
    cmd = [gxx, "-std=c++20", "-O1", "-pthread", "-w", "-o", str(out),
           str(cpp)]
    if shared:
        cmd[1:1] = ["-shared", "-fPIC"]
    subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    return out


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cuda_emu")
    return {src: ctypes.CDLL(str(_compile(tmp, Path(src).stem,
                                          _translate(src))))
            for src in ("fog_noise.cu", "blur_taps.cu")}


@pytest.fixture
def on_emulated_card(emulated, monkeypatch):
    """Route the wrappers' CUDA branch to the emulated libraries for CPU
    tensors; the launch counts start at 0."""
    class _Stream:
        cuda_stream = None

    monkeypatch.setattr(_build, "on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "load", lambda source: emulated[source])
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    for k in _build.KERNELS:
        monkeypatch.setattr(k, "_fn", None)
        monkeypatch.setattr(k, "launches", 0)


def test_philox_known_answers(tmp_path):
    """B1's hand-written Philox4x32-10 gives Random123's known answers."""
    src = _translate("fog_noise.cu") + r'''
#include <cstdio>
int main() {
  const uint4 c[3] = {{0u, 0u, 0u, 0u}, {~0u, ~0u, ~0u, ~0u},
                      {0x243f6a88u, 0x85a308d3u, 0x13198a2eu, 0x03707344u}};
  const uint2 k[3] = {{0u, 0u}, {~0u, ~0u}, {0xa4093822u, 0x299f31d0u}};
  for (int i = 0; i < 3; ++i) {
    const uint4 r = philox4x32_10(c[i], k[i]);
    std::printf("%08x %08x %08x %08x\n", r.x, r.y, r.z, r.w);
  }
}
'''
    exe = _compile(tmp_path, "kat", src, shared=False)
    out = subprocess.run([str(exe)], capture_output=True, text=True,
                         check=True, timeout=60).stdout.split("\n")
    assert out[:3] == ["6627e8d5 e169c58d bc57ac4c 9b00dbd8",
                       "408f276d 41c83b0e a20bc7c6 6d5451fd",
                       "d16cfe09 94fdcceb 5001e420 24126ea1"]


@pytest.mark.parametrize("shape", [(3, 8, 8, 3), (2, 5, 7, 3)],
                         ids=["vector", "scalar-tail"])
def test_fog_noise_kernel_matches_plain(on_emulated_card, shape):
    """B1 through its wrapper: the deterministic half (sigma=0) equals the
    plain version bit for bit; one launch counted per call."""
    g = torch.Generator().manual_seed(1)
    clean = torch.randint(0, 256, shape, dtype=torch.uint8, generator=g)
    b = shape[0]
    gate_fog = torch.tensor([1, 0, 1][:b], dtype=torch.int32)
    t = torch.rand(b, generator=g) * 0.5 + 0.4
    ones = torch.ones(b, dtype=torch.int32)
    sigma = torch.zeros(b)
    f, pre = kdistort.fused_fog_noise(clean, 5, gate_fog, t, ones, sigma)
    f_ref, pre_ref = kdistort.fog_noise_plain(
        clean, gate_fog, t, ones, sigma, noise=torch.zeros(shape))
    assert torch.equal(f, f_ref) and torch.equal(pre, pre_ref)
    assert kdistort.FOG_NOISE.launches == 1
    with pytest.raises(ValueError, match="draws its own noise"):
        kdistort.fused_fog_noise(clean, 5, gate_fog, t, ones, sigma,
                                 noise=torch.zeros(shape))


def test_fog_noise_kernel_noise_statistics(on_emulated_card):
    """B1's Philox + Box-Muller field: per-sample mean and std within 0.02
    of 0 and sigma; another seed gives another field."""
    clean = torch.full((2, 48, 48, 3), 128, dtype=torch.uint8)
    args = (torch.zeros(2, dtype=torch.int32), torch.ones(2),
            torch.ones(2, dtype=torch.int32), torch.tensor([0.1, 0.2]))
    f, _ = kdistort.fused_fog_noise(clean, 7, *args)
    f2, _ = kdistort.fused_fog_noise(clean, 8, *args)
    assert not torch.equal(f, f2)
    d = f - clean.to(torch.float32) * (1.0 / 255.0)
    for i, s in enumerate((0.1, 0.2)):
        assert abs(d[i].mean().item()) < 0.02
        assert abs(d[i].std().item() - s) < 0.02


def _blur_kernels(kind, b, k, g):
    """Motion kernels, or one box kernel per sample, or motion kernels with
    sample 0 all zeros."""
    if kind == "box":
        return torch.full((b, k, k), 1.0 / (k * k))
    kerns = tblur.motion_blur_kernels(
        torch.randint(max(2, k // 3), k + 1, (b,), generator=g),
        torch.randint(0, 361, (b,), generator=g).to(torch.float32), k)
    if kind == "zero-sample":
        kerns[0] = 0.0
    return kerns


# ragged steps and bands (56-wide bands, 16-row steps, 7 steps a CTA, so
# 130 rows take two CTAs down a band), C = 1 and 3, compile-time K (15, 10)
# and run-time K (5)
_SHAPES = [(2, 20, 37, 3, 15), (1, 9, 9, 1, 5), (2, 16, 16, 3, 10),
           (1, 70, 60, 1, 15), (2, 18, 60, 3, 5), (1, 130, 20, 1, 15)]


@pytest.mark.parametrize("b,h,w,c,k,kind", [
    pytest.param(*shape, kind, id="-".join(
        map(str, shape + ((kind,) if kind != "motion" else ()))))
    for kind in ("motion", "box", "zero-sample") for shape in _SHAPES])
@pytest.mark.parametrize("variant", ["sparse", "dense"])
def test_blur_taps_kernel_matches_plain(on_emulated_card, variant, kind, b,
                                        h, w, c, k):
    """B2/B3 through their wrappers: within 1e-3 of the plain version on
    inputs in 0..255, for motion kernels, box kernels (every tap equal) and
    a sample whose kernel is all zeros; one launch counted per call."""
    g = torch.Generator().manual_seed(2)
    x = torch.randint(0, 256, (b, h, w, c), generator=g).to(torch.float32)
    kerns = _blur_kernels(kind, b, k, g)
    fn = kblur.filter2d_sparse if variant == "sparse" else kblur.filter2d_dense
    got = fn(x, kerns)
    ref = kblur.filter2d_plain(x, kerns)
    assert (got - ref).abs().max().item() < 1e-3
    assert _build.launch_counts()[f"blur_{variant}"] == 1


@pytest.mark.parametrize("b,h,w,c,k", [(2, 32, 48, 3, 12), (2, 48, 96, 3, 12)],
                         ids=["32x48-K12", "48x96-K12"])
@pytest.mark.parametrize("variant", ["sparse", "dense"])
def test_blur_taps_kernel_at_offline_bucket_shapes(on_emulated_card, variant,
                                                   b, h, w, c, k):
    """B2/B3 at offline bucket shapes (one partial 48-wide band; a band of
    56 and one of 40) with the offline blur's shared K=12 kernel, which
    takes the run-time-K instance: within 1e-3 of the plain version, and
    the same uint8 after cvRound/saturate."""
    g = torch.Generator().manual_seed(5)
    x = torch.randint(0, 256, (b, h, w, c), generator=g).to(torch.float32)
    kerns = tblur.motion_blur_kernel(k, 45.0, max_degree=k).expand(b, k, k)
    fn = kblur.filter2d_sparse if variant == "sparse" else kblur.filter2d_dense
    got = fn(x, kerns)
    ref = kblur.filter2d_plain(x, kerns)
    assert (got - ref).abs().max().item() < 1e-3
    assert torch.equal(torch.round(got).clamp(0, 255),
                       torch.round(ref).clamp(0, 255))
    assert _build.launch_counts()[f"blur_{variant}"] == 1


@pytest.mark.parametrize("b,h,w,c,k", [(4, 20, 60, 3, 15), (4, 18, 37, 3, 5)],
                         ids=["vector-rows", "scalar-rows"])
@pytest.mark.parametrize("variant", ["sparse", "dense"])
def test_blur_kernel_epilogue_matches_plain(on_emulated_card, variant, b, h,
                                            w, c, k):
    """The random mix's epilogue in the blur's store, gates mixed on and
    off: a gate-off sample equals random_mix_epilogue_plain exactly (the
    same float32 steps on f, clipping included); a gate-on sample within
    1 LSB (the blur's cvRound can flip where float32 sums differ in order).
    Rows of 60 x 3 floats go out four at a time, rows of 37 x 3 one by one."""
    g = torch.Generator().manual_seed(4)
    x = torch.randint(0, 256, (b, h, w, c), generator=g).to(torch.float32)
    f = torch.rand((b, h, w, c), generator=g) * 1.2 - 0.1
    f[1, 0, :5, 0] = torch.arange(5) / 255.0  # exact uint8 levels: the snap
    kerns = _blur_kernels("motion", b, k, g)
    gate = torch.tensor([True, False, True, False])
    fn = kblur.filter2d_sparse if variant == "sparse" else kblur.filter2d_dense
    got = fn(x, kerns, f=f, gate_blur=gate)
    ref = kblur.random_mix_epilogue_plain(kblur.filter2d_plain(x, kerns), f,
                                          gate)
    assert got.dtype == torch.uint8 and got.shape == ref.shape
    assert torch.equal(got[~gate], ref[~gate])
    assert (got[gate].int() - ref[gate].int()).abs().max().item() <= 1
    assert _build.launch_counts()[f"blur_{variant}"] == 1
    with pytest.raises(ValueError, match="reflect-101"):
        fn(x[:, :k // 2, :k // 2], kerns)
    with pytest.raises(ValueError, match="gate_blur must be bool"):
        fn(x, kerns, f=f, gate_blur=gate.to(torch.int32))


def test_random_mix_on_kernels_matches_plain_path(on_emulated_card,
                                                  monkeypatch):
    """The random mix through B1 -> B2 with its epilogue equals the plain path
    within 1 LSB with the noise gates off (the Philox field has no CPU
    twin); a bad launch surfaces as an error, not a silent result."""
    g = torch.Generator().manual_seed(3)
    clean = torch.randint(0, 256, (3, 16, 16, 3), dtype=torch.uint8,
                          generator=g)
    draws = distortions.draw_random_mix(3, g)
    draws = dataclasses.replace(draws,
                                gate_noise=torch.zeros(3, dtype=torch.bool),
                                gate_blur=torch.ones(3, dtype=torch.bool))
    got = distortions.random_mix_from_draws(clean, draws)
    counts = _build.launch_counts()
    assert counts["fog_noise"] == 1 and counts["blur_sparse"] == 1
    monkeypatch.setattr(_build, "on_cuda", lambda t: False)
    ref = distortions.random_mix_from_draws(clean, draws)
    diff = (got.to(torch.int32) - ref.to(torch.int32)).abs().max().item()
    assert diff <= 1
    with pytest.raises(RuntimeError, match="invalid argument"):
        kblur.BLUR_DENSE.launch(0, 0, 0, 0, 0, 0, 0, 1, 4, 4, 3, 3, 0, 0,
                                None)
