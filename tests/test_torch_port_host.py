"""The port's host pieces against the JAX package on the CPU: host PSNR and
SSIM, the "pil" resize backend against PIL itself, the synthetic signs,
the report strings, the profiling helpers and ``download_gtsrb``.

Small sizes throughout; images are made from a seed with numpy.
"""

import json
import os
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from tsr_tpu.data import gtsrb as jgtsrb
from tsr_tpu.data import synthetic as jsynthetic
from tsr_tpu.ops import image_host as jimage_host
from tsr_tpu.utils import reporting as jreporting
from tsr_tpu_torch import native
from tsr_tpu_torch.data import gtsrb, synthetic
from tsr_tpu_torch.ops import image_host
from tsr_tpu_torch.utils import profiling, reporting

torch.set_num_threads(2)


def _pair(rng, shape):
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-40, 41, shape), 0,
                255).astype(np.uint8)
    return a, b


# ------------------------------------------------------------ PSNR / SSIM

@pytest.mark.parametrize("shape", [(3, 32, 32, 3), (2, 224, 224, 3),
                                   (2, 41, 57, 1), (1, 7, 9, 3)])
def test_host_psnr_ssim_match_reference(rng, shape):
    """psnr equal to tsr_tpu.ops.image_host's; ssim within 1e-6 (measured:
    0 at every shape here, the float64 window sums landing on cv2's
    float32 values)."""
    a, b = _pair(rng, shape)
    assert np.array_equal(image_host.psnr(a, b), jimage_host.psnr(a, b))
    got, ref = image_host.ssim(a, b), jimage_host.ssim(a, b)
    assert got.dtype == ref.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-6
    same = image_host.psnr(a, a)
    assert np.isinf(same).all()


def test_uniform_valid_matches_cv2_box_filter(rng):
    """The box filter behind ssim against cv2.boxFilter + the valid crop."""
    x = rng.uniform(0, 255 ** 2, (40, 33, 3)).astype(np.float32)
    for win in (3, 7):
        got = image_host._uniform_valid(x, win)
        ref = jimage_host._uniform_valid(x, win)
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


# ---------------------------------------------------------- the PIL resize

@pytest.mark.parametrize("hw,out", [((25, 31), 224), ((250, 260), 224),
                                    ((300, 90), 224), ((224, 224), 224),
                                    ((37, 41), 53), ((60, 60), 32),
                                    ((224, 100), 224), ((1000, 17), 64)])
def test_pil_backend_byte_equal_to_pil(tmp_path, rng, hw, out):
    """The "pil" resize of the IO library equals PIL's Image.resize(...,
    BILINEAR) byte for byte, at upscales, downscales, a one-axis resize
    and the same size."""
    img = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
    path = str(tmp_path / "img.ppm")
    native.write_images([path], [img])
    ref = np.asarray(Image.fromarray(img).resize((out, out),
                                                 Image.BILINEAR))
    got = native.load_batch([path], out, resize="pil")[0]
    assert np.array_equal(got, ref)


def test_resize_backend_switch(tmp_path, rng):
    """set_resize_backend picks the loader's resize: "pil" matches the
    reference's "pil" backend, "cv2" stays within 1 LSB of cv2."""
    img = rng.integers(0, 256, (250, 230, 3), dtype=np.uint8)
    path = str(tmp_path / "big.ppm")
    native.write_images([path], [img])
    try:
        for backend in ("pil", "cv2"):
            gtsrb.set_resize_backend(backend)
            jgtsrb.set_resize_backend(backend)
            got = gtsrb._decode_resize_batch([path, path], 224)
            ref = jgtsrb._decode_resize(path, 224)
            lsb = np.abs(got.astype(int) - ref.astype(int)).max()
            assert lsb == 0 if backend == "pil" else lsb <= 1
            assert np.array_equal(gtsrb._decode_resize(path, 224), got[0])
        with pytest.raises(ValueError, match="unknown resize backend"):
            gtsrb.set_resize_backend("nearest")
        with pytest.raises(ValueError, match="unknown resize"):
            native.load_batch([path], 8, resize="nearest")
    finally:
        gtsrb.set_resize_backend("cv2")
        jgtsrb.set_resize_backend("cv2")


# ------------------------------------------------------ the synthetic signs

@pytest.mark.parametrize("class_id,size", [(0, 48), (5, 33), (13, 64)])
def test_make_sign_equals_reference(class_id, size):
    got = synthetic.make_sign(class_id, size, np.random.default_rng(3))
    ref = jsynthetic.make_sign(class_id, size, np.random.default_rng(3))
    assert got.dtype == np.uint8 and np.array_equal(got, ref)
    got = synthetic.make_sign(class_id, size, np.random.default_rng(4),
                              gain_u=0.25)
    ref = jsynthetic.make_sign(class_id, size, np.random.default_rng(4),
                               gain_u=0.25)
    assert np.array_equal(got, ref)


def test_make_dataset_equals_reference():
    got = synthetic.make_dataset(num_classes=4, per_class=3, size=32, seed=1)
    ref = jsynthetic.make_dataset(num_classes=4, per_class=3, size=32,
                                  seed=1)
    assert np.array_equal(got[0], ref[0])
    assert np.array_equal(got[1], ref[1]) and got[1].dtype == np.int32
    assert synthetic.CALIB == jsynthetic.CALIB
    assert (synthetic.TREE_SIZE, synthetic.TREE_JITTER) == (
        jsynthetic.TREE_SIZE, jsynthetic.TREE_JITTER)


# ---------------------------------------------------------- report strings

def test_reporting_strings_equal_reference():
    acc = {"Clean (Original)": 0.98765, "Noise (Restored, fused)": 0.5,
           "Foggy": 0.0}
    title = "Final Test Report (Restoration)"
    assert (reporting.accuracy_report(acc, title)
            == jreporting.accuracy_report(acc, title))
    metrics = {"Noise": {"psnr": 24.5, "ssim": 0.81234},
               "Blur": {"psnr": 21.0}}
    assert (reporting.metric_report(metrics, "PSNR/SSIM")
            == jreporting.metric_report(metrics, "PSNR/SSIM"))
    th = reporting.Throughput(warmup_batches=1)
    assert np.isnan(th.images_per_sec)
    for _ in range(3):
        th.tick(32)
    assert th.n_images == 64 and th.images_per_sec > 0


# ------------------------------------------------------------- profiling

def test_profiler_trace_and_device_time(tmp_path):
    """The twin of tests/test_e2e.py's profiling test: trace writes a
    Chrome trace, device_time returns positive seconds."""
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir) as d:
        assert d == logdir
        _ = torch.ones(64, 64).mul(2.0).sum()
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(logdir, files[0])) as f:
        assert "traceEvents" in json.load(f)
    calls = []

    def f(x):
        calls.append(1)
        return {"y": x * 2.0}

    dt = profiling.device_time(f, torch.ones(128, 128), reps=2)
    assert dt > 0 and len(calls) == 3  # warm-up + 2 reps
    assert profiling.device_time(f, torch.ones(4), reps=2,
                                 reduce="mean") > 0


# ------------------------------------------------------------ the download

def test_download_gtsrb_offline_message(tmp_path, monkeypatch):
    """With urlopen failing, both packages raise the same message; an
    existing tree returns at once, with no network call."""
    def offline(*args, **kwargs):
        raise OSError("network unreachable")

    monkeypatch.setattr(urllib.request, "urlopen", offline)
    root = str(tmp_path / "data")
    with pytest.raises(RuntimeError) as got:
        gtsrb.download_gtsrb(root)
    with pytest.raises(RuntimeError) as ref:
        jgtsrb.download_gtsrb(root)
    assert str(got.value) == str(ref.value)
    assert "Could not download GTSRB" in str(got.value)
    assert gtsrb.GTSRB_URL == jgtsrb.GTSRB_URL
    assert gtsrb.DEFAULT_ROOT == jgtsrb.DEFAULT_ROOT

    target = tmp_path / "data" / "gtsrb" / "GTSRB" / "Training"
    target.mkdir(parents=True)
    assert gtsrb.download_gtsrb(root) == str(target)
