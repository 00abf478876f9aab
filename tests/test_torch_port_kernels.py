"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper takes its kernel's plain PyTorch version, so these
tests hold the plain versions (and the tap selection, padding and layout
around them) against the Pallas kernels run in interpret mode. The CUDA
kernels themselves are held against these plain versions on the card by
``chip_smoke.py``.
"""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsr_tpu.kernels import blur_pallas, distort
from tsr_tpu.ops import blur as jblur
from tsr_tpu_torch.kernels import _build
from tsr_tpu_torch.kernels import blur as kblur
from tsr_tpu_torch.kernels import distort as kdistort
from tsr_tpu_torch.ops import blur as tblur

torch.set_num_threads(2)


def _motion_kernels(degs, angs, k=15):
    return np.array(jax.vmap(
        lambda d, a: jblur.motion_blur_kernel(d, a, max_degree=k))(
            jnp.asarray(degs), jnp.asarray(angs, jnp.float32)))


# ------------------------------------------------------------------- B1

def test_fog_noise_plain_matches_pallas_interpret(rng):
    """B1 plain version vs the interpreted Pallas kernel. The interpreter's
    PRNG gives zero bits, so its noise is exactly 0: the port gets a zero
    field. Tolerance: f within 1e-6 (same float32 ops), pre_blur exact."""
    imgs = rng.integers(0, 256, (3, 16, 16, 3), dtype=np.uint8)
    gate_fog = np.asarray([1, 1, 0], np.int32)
    t = np.asarray([0.6, 0.8, 1.0], np.float32)
    gate_noise = np.asarray([1, 0, 1], np.int32)
    sigma = np.asarray([0.1, 0.2, 0.15], np.float32)
    f_ref, pre_ref = distort.fused_fog_noise(
        imgs, 123, gate_fog=gate_fog, t=t, gate_noise=gate_noise,
        sigma=sigma, interpret=True)
    f, pre = kdistort.fused_fog_noise(
        torch.from_numpy(imgs), 123, torch.from_numpy(gate_fog),
        torch.from_numpy(t), torch.from_numpy(gate_noise),
        torch.from_numpy(sigma), noise=torch.zeros(imgs.shape))
    assert np.abs(f.numpy() - np.asarray(f_ref)).max() <= 1e-6
    assert np.array_equal(pre.numpy(), np.asarray(pre_ref))


def test_fog_noise_cpu_draws_from_seed():
    """Without a noise field the plain version draws N(0, sigma) from a
    generator seeded by ``seed``: same seed, same field; per-sample std
    within 0.02 of sigma (the statistics check of tests/test_kernels.py)."""
    imgs = torch.full((2, 32, 32, 3), 128, dtype=torch.uint8)
    args = (torch.zeros(2, dtype=torch.int32), torch.ones(2),
            torch.ones(2, dtype=torch.int32), torch.tensor([0.1, 0.2]))
    f1, _ = kdistort.fused_fog_noise(imgs, 7, *args)
    f2, _ = kdistort.fused_fog_noise(imgs, 7, *args)
    f3, _ = kdistort.fused_fog_noise(imgs, 8, *args)
    assert torch.equal(f1, f2) and not torch.equal(f1, f3)
    d = f1 - 128.0 / 255.0
    for i, s in enumerate((0.1, 0.2)):
        assert abs(d[i].mean().item()) < 0.02
        assert abs(d[i].std().item() - s) < 0.02


# ---------------------------------------------------------------- B2 / B3

@pytest.mark.parametrize("variant", ["sparse", "dense"])
def test_blur_plain_matches_pallas_interpret(rng, variant):
    """B2 (every nonzero tap) and B3 (all K*K taps) plain versions vs the
    interpreted Pallas kernels (B2's TPU kernel keeps the top 3K taps, which
    cover a motion kernel's nonzeros) at 2x32x32x3, K=15, inputs in 0..255.
    Tolerance 1e-3: float32 sums in another order (tests/test_kernels.py)."""
    imgs = rng.uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
    kerns = _motion_kernels([5, 15], [30.0, 275.0])
    if variant == "sparse":
        ref = blur_pallas.filter2d_pallas_sparse(imgs, kerns, interpret=True)
        got = kblur.filter2d_sparse(torch.from_numpy(imgs),
                                    torch.from_numpy(kerns))
    else:
        ref = blur_pallas.filter2d_pallas(imgs, jnp.asarray(kerns),
                                          interpret=True)
        got = kblur.filter2d_dense(torch.from_numpy(imgs),
                                   torch.from_numpy(kerns))
    assert np.abs(got.numpy() - np.asarray(ref)).max() < 1e-3


def test_sparse_budget_covers_every_motion_kernel():
    """The 3K tap budget is exact for the random mix's kernels: over
    degrees 5-15 and all 361 angles at K=15, no kernel has more nonzeros,
    so the masked kernel equals the full one."""
    degs = torch.arange(5, 16).repeat_interleave(361)
    angs = torch.arange(361).repeat(11).to(torch.float32)
    kerns = tblur.motion_blur_kernels(degs, angs, 15)
    assert int((kerns > 0).sum(dim=(1, 2)).max()) <= 45
    assert torch.equal(kblur.sparse_kernels(kerns, 45), kerns)


@pytest.mark.parametrize("kind", ["box", "dense"])
def test_filter2d_matches_jax_for_any_kernel(rng, kind):
    """Per-sample kernels with far more than 3K nonzero taps (a 15x15 box,
    225 equal taps; random dense weights) through the port's filter2d vs
    tsr_tpu's exact grouped convolution at 2x16x16x3, within 1e-3. A top-3K
    tap list missed this by up to 14.86."""
    imgs = rng.integers(0, 256, (2, 16, 16, 3)).astype(np.float32)
    if kind == "box":
        kerns = np.full((2, 15, 15), 1.0 / 225, np.float32)
    else:
        kerns = rng.uniform(0, 1, (2, 15, 15)).astype(np.float32)
        kerns /= kerns.sum(axis=(1, 2), keepdims=True)
    ref = np.asarray(jblur.filter2d(jnp.asarray(imgs), jnp.asarray(kerns)))
    for backend in ("sparse", "dense"):
        tblur.set_backend(backend)
        try:
            got = tblur.filter2d(torch.from_numpy(imgs),
                                 torch.from_numpy(kerns)).numpy()
        finally:
            tblur.set_backend("sparse")
        assert np.abs(got - ref).max() < 1e-3, backend


def test_sparse_taps_ties_match_lax_top_k():
    """On tied weights (a 15x15 box, budget 45) sparse_taps keeps the taps
    lax.top_k keeps, the lowest flat indices, and so does sparse_kernels."""
    kerns = np.full((2, 15, 15), 1.0 / 225, np.float32)
    kerns[1, 3, 4] = 0.5  # one larger tap goes first
    ref_w, ref_i = jax.lax.top_k(jnp.asarray(kerns.reshape(2, -1)), 45)
    w, idx = kblur.sparse_taps(torch.from_numpy(kerns), 45)
    assert np.array_equal(idx.numpy(), np.asarray(ref_i))
    assert np.array_equal(w.numpy(), np.asarray(ref_w))
    masked = kblur.sparse_kernels(torch.from_numpy(kerns), 45).numpy()
    assert (masked.reshape(2, -1)[0, :45] > 0).all()
    assert (masked.reshape(2, -1)[0, 45:] == 0).all()


def test_filter2d_shared_k10_matches_jax(rng):
    """A shared even-sized kernel (the compound chain's K=10: reflect pad 5
    before, 4 after) through the port's filter2d vs tsr_tpu's; also the
    kernel itself. Tolerances: kernel 1e-6, blur 1e-3."""
    imgs = rng.integers(0, 256, (2, 24, 24, 3)).astype(np.float32)
    kern_ref = np.asarray(jblur.motion_blur_kernel(10, 45.0, max_degree=10))
    kern = tblur.motion_blur_kernel(10, 45.0, max_degree=10)
    assert np.abs(kern.numpy() - kern_ref).max() <= 1e-6
    ref = np.asarray(jblur.filter2d(jnp.asarray(imgs), jnp.asarray(kern_ref)))
    got = tblur.filter2d(torch.from_numpy(imgs), kern).numpy()
    assert np.abs(got - ref).max() < 1e-3


@pytest.mark.parametrize("degree", [5, 10, 15])
def test_motion_blur_kernels_match_jax(degree):
    """Batched closed-form kernels vs tsr_tpu's vmapped ones, centered in
    the K=15 buffer, within 1e-6."""
    angles = [0.0, 30.0, 45.0, 90.0, 137.0, 180.0, 275.0, 360.0]
    degs = [degree] * len(angles)
    got = tblur.motion_blur_kernels(torch.tensor(degs), torch.tensor(angles),
                                    15).numpy()
    assert np.abs(got - _motion_kernels(degs, angles)).max() <= 1e-6


def test_backends_agree_on_motion_kernels(rng):
    """filter2d's sparse (default) and dense backends give the same blur
    for motion kernels within 1e-3 (their sums run in another order)."""
    imgs = torch.from_numpy(rng.uniform(0, 255, (3, 20, 20, 3)).astype(
        np.float32))
    kerns = tblur.motion_blur_kernels(torch.tensor([5, 9, 15]),
                                      torch.tensor([10.0, 200.0, 333.0]), 15)
    assert tblur._BACKEND == "sparse"
    sparse = tblur.filter2d(imgs, kerns)
    tblur.set_backend("dense")
    try:
        dense = tblur.filter2d(imgs, kerns)
    finally:
        tblur.set_backend("sparse")
    assert (sparse - dense).abs().max() < 1e-3
    with pytest.raises(ValueError):
        tblur.set_backend("xla")


# ------------------------------------------------------- wrappers and build

def test_cpu_tensors_launch_no_kernel(rng):
    """A CPU tensor takes the plain version and leaves every launch count
    at 0; the counts exist for B1, B2 and B3."""
    _build.reset_launch_counts()
    imgs = torch.from_numpy(rng.uniform(0, 255, (2, 16, 16, 3)).astype(
        np.float32))
    kerns = tblur.motion_blur_kernels(torch.tensor([7, 11]),
                                      torch.tensor([20.0, 70.0]), 15)
    kblur.filter2d_sparse(imgs, kerns)
    kblur.filter2d_dense(imgs, kerns)
    kdistort.fused_fog_noise(imgs.to(torch.uint8), 1,
                             torch.ones(2, dtype=torch.int32), torch.ones(2),
                             torch.ones(2, dtype=torch.int32), torch.ones(2))
    assert _build.launch_counts() == {"fog_noise": 0, "blur_sparse": 0,
                                      "blur_dense": 0}


@pytest.mark.parametrize("kernel", [kdistort.FOG_NOISE, kblur.BLUR_SPARSE],
                         ids=lambda k: k.name)
def test_ctypes_signature_matches_source(kernel):
    """Each bound C entry point exists in its source with as many
    parameters as its ctypes argtypes, all of them pointer-, int- or
    float-sized as declared, and returns int (the cudaGetLastError code)."""
    src = (_build.CSRC / kernel.source).read_text()
    m = re.search(r'extern "C" int %s\(([^)]*)\)' % kernel.symbol, src)
    assert m, kernel.symbol
    params = [p.strip() for p in m.group(1).split(",")]
    assert len(params) == len(kernel.argtypes)
    for p, ty in zip(params, kernel.argtypes):
        if "*" in p:
            assert ty is ctypes.c_void_p, p
        elif p.startswith("int64_t"):
            assert ty is ctypes.c_int64, p
        elif p.startswith("int"):
            assert ty is ctypes.c_int, p
        else:
            assert p.startswith("float") and ty is ctypes.c_float, p
    assert 'extern "C" const char* tsr_error_string(int' in src
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
