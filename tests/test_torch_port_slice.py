"""The port's serving slice against the JAX package on the CPU:
random mix -> fused restore/classify step -> unified demo, plus the
image ops, the import boundary and the CUDA-only entry points.

Inputs and the JAX reference's random draws are made with numpy / jax and
handed to both sides, so the comparisons are exact up to float32 order.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsr_tpu import configs as jconfigs
from tsr_tpu import eval as jeval
from tsr_tpu import pipeline as jpipeline
from tsr_tpu.models import ResUNet as JResUNet
from tsr_tpu.models import VGG16 as JVGG16
from tsr_tpu.ops import distortions as jdist
from tsr_tpu.ops import image as jimage
from tsr_tpu_torch import checkpoint, configs
from tsr_tpu_torch import eval as teval
from tsr_tpu_torch import infer as tinfer
from tsr_tpu_torch import offline as toffline
from tsr_tpu_torch import pipeline as tpipeline
from tsr_tpu_torch.device import resolve_device
from tsr_tpu_torch.models import ResUNet, VGG16
from tsr_tpu_torch.ops import distortions as tdist
from tsr_tpu_torch.ops import image as timage
from tsr_tpu_torch.train import common as tcommon
from tsr_tpu_torch.train import loops as tloops

torch.set_num_threads(2)
HI = jax.lax.Precision.HIGHEST
SMALL_CFG = (8, 8, "M", 16, "M", 16, "M")


def _lsb(a, b):
    return int(np.abs(np.asarray(a).astype(int)
                      - np.asarray(b).astype(int)).max())


# ------------------------------------------------------------ distortions

def _reference_draws(key, b, cfg):
    """tsr_tpu's apply_random_distortions draws, replicated from its key
    splits (ops/distortions.py:203-232), as the port's MixDraws plus the
    N(0,1) noise field."""
    keys = jax.random.split(key, 8)
    shp = (b, 1, 1, 1)
    gate_fog = jax.random.uniform(keys[0], shp) < cfg.prob_fog
    intensity = jax.random.uniform(keys[1], shp, jnp.float32,
                                   *cfg.fog_intensity)
    t = 1.0 - intensity * jax.random.uniform(keys[2], shp, jnp.float32,
                                             *cfg.fog_t_jitter)
    gate_noise = jax.random.uniform(keys[3], shp) < cfg.prob_noise
    var = jax.random.uniform(keys[4], shp, jnp.float32, *cfg.noise_var)
    gate_blur = jax.random.uniform(keys[6], (b,)) < cfg.prob_blur
    kb = jax.random.split(keys[7], 2)
    degrees = jax.random.randint(kb[0], (b,), cfg.blur_degree[0],
                                 cfg.blur_degree[1] + 1)
    angles = jax.random.randint(kb[1], (b,), cfg.blur_angle[0],
                                cfg.blur_angle[1] + 1).astype(jnp.float32)

    def t_(x, dtype=None):
        return torch.from_numpy(np.array(x).reshape(-1)).to(dtype)

    draws = tdist.MixDraws(
        gate_fog=t_(gate_fog), t=t_(t), gate_noise=t_(gate_noise),
        sigma=torch.sqrt(t_(var)), gate_blur=t_(gate_blur),
        degrees=t_(degrees), angles=t_(angles),
        seed=torch.zeros(1, dtype=torch.int64),
        atmosphere=cfg.fog_atmosphere)
    return draws, draws.gate_fog, draws.gate_noise, draws.gate_blur


@pytest.mark.parametrize("seed", [42, 7])
def test_random_mix_from_draws_matches_jax(seed):
    """random_mix_from_draws with the reference's draws and normal field vs
    tsr_tpu's apply_random_distortions: within 1 LSB (the blur's cvRound can
    flip where float32 sums differ in order)."""
    b = 8
    img = np.random.default_rng(seed).integers(0, 256, (b, 24, 24, 3),
                                               dtype=np.uint8)
    key = jax.random.PRNGKey(seed)
    cfg = jconfigs.RandomMixConfig()
    draws, gf, gn, gb = _reference_draws(key, b, cfg)
    # every branch of the mix is exercised by at least one sample
    assert gf.any() and (~gf).any() and gn.any() and gb.any() and (~gb).any()
    noise = np.array(jax.random.normal(jax.random.split(key, 8)[5],
                                       img.shape, jnp.float32))
    ref = np.asarray(jdist.apply_random_distortions(img, key, cfg))
    got = tdist.random_mix_from_draws(torch.from_numpy(img), draws,
                                      noise=torch.from_numpy(noise))
    assert got.dtype == torch.uint8
    assert _lsb(got.numpy(), ref) <= 1


def test_apply_random_distortions_cpu_is_seeded():
    """The entry point on the CPU: same generator seed, same batch; a
    single image is promoted and squeezed back."""
    img = torch.randint(0, 256, (4, 16, 16, 3), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(0))
    outs = [tdist.apply_random_distortions(
        img, torch.Generator().manual_seed(s), device="cpu")
        for s in (3, 3, 4)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0],
                                                             outs[2])
    one = tdist.apply_random_distortions(img[0], torch.Generator(),
                                         device="cpu")
    assert one.shape == (16, 16, 3) and one.dtype == torch.uint8


def test_make_compound_distortion_matches_jax():
    """The demo's compound chain with the reference's normal field: within
    1 LSB of tsr_tpu's make_compound_distortion (K=10 shared blur)."""
    img = np.random.default_rng(3).integers(0, 256, (3, 24, 24, 3),
                                            dtype=np.uint8)
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.normal(key, img.shape, jnp.float32))
    ref = np.asarray(jdist.make_compound_distortion(img, key))
    got = tdist.make_compound_distortion(
        img, device="cpu", noise=torch.from_numpy(noise))
    assert _lsb(got.numpy(), ref) <= 1


# ---------------------------------------------------------------- image ops

def test_image_ops_match_jax(rng):
    """Casts and round-trips exact; PSNR within 1e-4 dB, SSIM within 1e-4,
    normalization within 1e-6."""
    x = rng.uniform(-300, 300, (2, 16, 16, 3)).astype(np.float32)
    x[0, 0, 0] = [2.5, 3.5, -0.5]  # round-half-even cases
    tx = torch.from_numpy(x)
    assert np.array_equal(timage.numpy_uint8_cast(tx).numpy(),
                          np.asarray(jimage.numpy_uint8_cast(x)))
    for rnd in (False, True):
        assert np.array_equal(timage.saturate_uint8(tx, round=rnd).numpy(),
                              np.asarray(jimage.saturate_uint8(x, round=rnd)))
    u8 = rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    f01 = timage.to_float01(torch.from_numpy(u8))
    assert np.array_equal(timage.clip01_to_uint8(f01).numpy(), u8)
    y01 = rng.uniform(-0.2, 1.2, (2, 16, 16, 3)).astype(np.float32)
    assert np.array_equal(
        timage.clip01_to_uint8(torch.from_numpy(y01)).numpy(),
        np.asarray(jimage.clip01_to_uint8(y01)))
    assert np.abs(timage.imagenet_normalize(torch.from_numpy(y01)).numpy()
                  - np.asarray(jimage.imagenet_normalize(y01))).max() <= 1e-6
    v8 = np.clip(u8.astype(int) + rng.integers(-30, 30, u8.shape), 0,
                 255).astype(np.uint8)
    a, b = torch.from_numpy(u8), torch.from_numpy(v8)
    assert np.abs(timage.psnr(a, b).numpy()
                  - np.asarray(jimage.psnr(u8, v8))).max() <= 1e-4
    assert np.abs(timage.ssim(a, b).numpy()
                  - np.asarray(jimage.ssim(u8, v8))).max() <= 1e-4


# ------------------------------------------------------------- the slice

@pytest.fixture(scope="module")
def shared_models():
    """A small ResUNet + VGG16 judge in both frameworks, shared weights."""
    rng = np.random.default_rng(11)
    jr = JResUNet(widths=(8, 16, 32), bottleneck_width=64, precision=HI)
    jrv = jax.tree.map(np.array, jr.init(jax.random.PRNGKey(2),
                                         jnp.zeros((1, 32, 32, 3))))
    for stats in jrv["batch_stats"].values():
        for bn in stats.values():
            bn["mean"] = rng.normal(0, 0.05, bn["mean"].shape).astype(
                np.float32)
    jj = JVGG16(num_classes=5, cfg=SMALL_CFG, fc_width=32, precision=HI)
    jjv = jj.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)))
    tr = ResUNet(widths=(8, 16, 32), bottleneck_width=64)
    tr.load_state_dict(checkpoint.resunet_from_jax(jrv))
    tj = VGG16(num_classes=5, cfg=SMALL_CFG, fc_width=32, input_size=32)
    tj.load_state_dict(checkpoint.vgg16_from_jax(jjv))
    return (jr, jrv, jj, jjv), (tr.eval(), tj.eval())


def test_fused_eval_step_matches_jax(shared_models):
    """Port make_fused_eval_step vs tsr_tpu's on shared weights: pred and
    correct equal; confidence within 1e-4; PSNR within 1e-3 dB and SSIM
    within 1e-4 (the trunc-quantize may move a pixel one level where the
    restorer's float32 sums differ)."""
    (jr, jrv, jj, jjv), (tr, tj) = shared_models
    rng = np.random.default_rng(4)
    clean = rng.integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    bad = np.asarray(jdist.apply_random_distortions(
        clean, jax.random.PRNGKey(9)))
    labels = rng.integers(0, 5, 6)
    jstep = jeval.make_fused_eval_step(
        lambda v, x: jr.apply(v, x, train=False),
        lambda v, x, train=False: jj.apply(v, x, train=train),
        with_metrics=True)
    ref = jax.tree.map(np.asarray, jstep(jrv, jjv, bad, labels, clean))
    tstep = teval.make_fused_eval_step(tr, tj, with_metrics=True,
                                       device="cpu")
    got = {k: v.numpy() for k, v in tstep(bad, labels, clean).items()}
    assert np.array_equal(got["pred"], ref["pred"])
    assert int(got["correct"]) == int(ref["correct"])
    assert np.abs(got["confidence"] - ref["confidence"]).max() <= 1e-4
    assert np.abs(got["psnr"] - ref["psnr"]).max() <= 1e-3
    assert np.abs(got["ssim"] - ref["ssim"]).max() <= 1e-4

    # classify-only (restorer=None) agrees too
    jonly = jeval.make_fused_eval_step(
        None, lambda v, x, train=False: jj.apply(v, x, train=train))
    tonly = teval.make_fused_eval_step(None, tj, device="cpu")
    assert np.array_equal(tonly(bad, labels)["pred"].numpy(),
                          np.asarray(jonly(None, jjv, bad, labels)["pred"]))


def test_evaluate_batches_matches_jax(shared_models):
    """The harness aggregates top-1, confidence, PSNR and SSIM over batches
    like tsr_tpu's (same tolerances as the step)."""
    (jr, jrv, jj, jjv), (tr, tj) = shared_models
    rng = np.random.default_rng(8)
    batches = [(rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8),
                rng.integers(0, 5, 4),
                rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8))
               for _ in range(3)]
    jstep = jeval.make_fused_eval_step(
        lambda v, x: jr.apply(v, x, train=False),
        lambda v, x, train=False: jj.apply(v, x, train=train),
        with_metrics=True)
    ref = jeval.evaluate_batches(jstep, jrv, jjv, batches, with_metrics=True)
    tstep = teval.make_fused_eval_step(tr, tj, with_metrics=True,
                                       device="cpu")
    got = teval.evaluate_batches(tstep, batches, with_metrics=True,
                                 device="cpu")
    assert got["n"] == ref["n"] == 12 and got["top1"] == ref["top1"]
    assert got["images_per_sec"] > 0
    for k, tol in (("confidence", 1e-4), ("psnr", 1e-3), ("ssim", 1e-4)):
        assert abs(got[k] - ref[k]) <= tol, k


def test_unified_demo_matches_jax(shared_models):
    """Port unified_demo vs tsr_tpu's with the same bad_u8: preds equal on
    clean/bad/restored, confidences within 1e-4, restored uint8 within
    1 LSB. Without bad_u8 the port draws the compound chain itself."""
    (jr, jrv, jj, jjv), (tr, tj) = shared_models
    clean = np.random.default_rng(6).integers(0, 256, (4, 32, 32, 3),
                                              dtype=np.uint8)
    bad = np.asarray(jdist.make_compound_distortion(clean,
                                                    jax.random.PRNGKey(1)))
    ref = jpipeline.unified_demo(
        clean, jr.apply, jrv,
        lambda v, x, train=False: jj.apply(v, x, train=train), jjv,
        jax.random.PRNGKey(0), bad_u8=bad)
    got = tpipeline.unified_demo(clean, tr, tj, bad_u8=bad, device="cpu")
    assert np.array_equal(got["bad_u8"], bad)
    assert _lsb(got["restored_u8"], ref["restored_u8"]) <= 1
    for name in ("clean", "bad", "restored"):
        assert np.array_equal(got["judge"][name]["pred"],
                              ref["judge"][name]["pred"]), name
        assert np.abs(got["judge"][name]["confidence"]
                      - ref["judge"][name]["confidence"]).max() <= 1e-4
    drawn = tpipeline.unified_demo(clean, tr, tj,
                                   torch.Generator().manual_seed(0),
                                   device="cpu")
    assert drawn["bad_u8"].shape == clean.shape
    assert np.isfinite(drawn["judge"]["restored"]["confidence"]).all()


# ------------------------------------------------------ package boundary

def test_import_pulls_in_no_jax():
    """Importing every module of the port loads neither jax nor tsr_tpu,
    nor cv2 or PIL (the port's codec is its own IO library)."""
    code = (
        "import sys\n"
        "import tsr_tpu_torch, tsr_tpu_torch.eval, tsr_tpu_torch.pipeline\n"
        "import tsr_tpu_torch.checkpoint, tsr_tpu_torch.ops.distortions\n"
        "import tsr_tpu_torch.models, tsr_tpu_torch.kernels._build\n"
        "import tsr_tpu_torch.losses, tsr_tpu_torch.train.common\n"
        "import tsr_tpu_torch.train.loops, tsr_tpu_torch.native\n"
        "import tsr_tpu_torch.data.gtsrb, tsr_tpu_torch.offline\n"
        "import tsr_tpu_torch.infer\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'tsr_tpu', 'cv2', 'PIL')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def _entry_points():
    img = np.zeros((2, 32, 32, 3), np.uint8)
    tr = ResUNet(widths=(8, 16, 32), bottleneck_width=64)
    tj = VGG16(num_classes=5, cfg=SMALL_CFG, fc_width=32, input_size=32)
    train_cfg = configs.UnifiedTrainConfig(batch_size=2, epochs=1)
    return {
        "apply_random_distortions": lambda: tdist.apply_random_distortions(
            img, torch.Generator()),
        "make_fused_eval_step": lambda: teval.make_fused_eval_step(tr, tj),
        "evaluate_batches": lambda: teval.evaluate_batches(
            lambda *a: None, [(img, np.zeros(2))]),
        "unified_demo": lambda: tpipeline.unified_demo(img, tr, tj),
        "make_training_pair": lambda: tdist.make_training_pair(
            img, torch.Generator()),
        "train_unified_on_device": lambda: tloops.train_unified_on_device(
            tcommon.create_unified_state(tr, train_cfg, 1), img,
            np.arange(2), np.arange(2), train_cfg),
        "generate_tree": lambda: toffline.generate_tree("a", "b", "blur"),
        "restore_tree": lambda: tinfer.restore_tree(tr, "a", "b"),
        "evaluate_directory": lambda: teval.evaluate_directory(tj, "a"),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_cuda_and_raise_without_it(name):
    """Without device='cpu' an entry point asks for CUDA; on a machine
    without it, it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device works")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        _entry_points()[name]()


def test_default_cuda_device_names_the_current_card(monkeypatch):
    """A bare "cuda" resolves to "cuda:<current>", the device CUDA tensors
    report, so as_tensor accepts a batch already on the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device() == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")


def test_configs_match_jax():
    """The port's own copy of the configuration carries the same values."""
    assert configs.IMAGE_SIZE == jconfigs.IMAGE_SIZE
    assert configs.NUM_CLASSES == jconfigs.NUM_CLASSES
    assert configs.IMAGENET_MEAN == jconfigs.IMAGENET_MEAN
    assert configs.IMAGENET_STD == jconfigs.IMAGENET_STD
    assert configs.EvalConfig().batch_size == jconfigs.EvalConfig().batch_size
    for ours, ref in ((configs.NoiseConfig(), jconfigs.NoiseConfig()),
                      (configs.BlurConfig(), jconfigs.BlurConfig()),
                      (configs.FogConfig(), jconfigs.FogConfig()),
                      (configs.CompoundConfig(), jconfigs.CompoundConfig()),
                      (configs.RandomMixConfig(),
                       jconfigs.RandomMixConfig()),
                      (configs.UnifiedTrainConfig(),
                       jconfigs.UnifiedTrainConfig()),
                      (configs.UnifiedTrainConfig().mix,
                       jconfigs.UnifiedTrainConfig().mix)):
        for k, v in vars(ours).items():
            if k != "mix":  # compared field by field as its own pair
                assert getattr(ref, k) == v, k
    assert configs.UnifiedTrainConfig().mix.apply_scales == (40, 56, 80, 112)
