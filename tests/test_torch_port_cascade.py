"""The port's SimpleUNet family against the JAX package on the CPU: the
model and its weight bridge, the mild distortions, the paired tree loader
and split, the restorer train and eval steps with their Adam optimizers,
the device-resident restorer trainer with checkpoints and resume, the zoo,
the cascade variant label and the cascade stress test.

Small sizes: SimpleUNet widths (8, 16), a narrow VGG judge whose
``features`` reach the perceptual tap 15, 32x32 inputs. Inputs and the
reference's random draws are made with numpy / jax and handed to both
sides. JAX runs in float32 at ``precision=HIGHEST``.
"""

import itertools
import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_port_train import _capture_grads
from tsr_tpu import checkpoint as jcheckpoint
from tsr_tpu import configs as jconfigs
from tsr_tpu import pipeline as jpipeline
from tsr_tpu.data import gtsrb as jgtsrb
from tsr_tpu.models import SimpleUNet as JSimpleUNet
from tsr_tpu.models import VGG16 as JVGG16
from tsr_tpu.models import vgg as jvgg
from tsr_tpu.ops import blur as jblur
from tsr_tpu.ops import distortions as jdist
from tsr_tpu.train import common as jcommon
from tsr_tpu_torch import checkpoint, configs, losses, pipeline, zoo
from tsr_tpu_torch.data import gtsrb
from tsr_tpu_torch.models import SimpleUNet, VGG16
from tsr_tpu_torch.ops import distortions as tdist
from tsr_tpu_torch.train import common, loops

torch.set_num_threads(2)
HI = jax.lax.Precision.HIGHEST
WIDTHS = (8, 16)
VGG_CFG = (16, 16, "M", 32, 32, "M", 32, 32, 32, "M")  # reaches tap 15
SIZE = 32


def _t(x):
    return torch.from_numpy(np.array(x))


def _nchw(x):
    return _t(np.asarray(x).transpose(0, 3, 1, 2))


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


def _lsb(a, b):
    return int(np.abs(np.asarray(a).astype(int)
                      - np.asarray(b).astype(int)).max())


def _jax_unet(seed, input_minmax=False, widths=WIDTHS):
    jm = JSimpleUNet(widths=widths, precision=HI, input_minmax=input_minmax)
    v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, SIZE, SIZE, 3)))
    return jm, jax.tree.map(np.array, v)


def _port_unet(jv, input_minmax=False, widths=WIDTHS):
    m = SimpleUNet(widths=widths, input_minmax=input_minmax)
    m.load_state_dict(checkpoint.simple_unet_from_jax(jv))
    return m


@pytest.fixture(scope="module")
def judges():
    """A narrow VGG judge in both frameworks, shared weights."""
    jj = JVGG16(num_classes=5, cfg=VGG_CFG, fc_width=32, precision=HI)
    jjv = jax.tree.map(np.array, jj.init(jax.random.PRNGKey(2),
                                         jnp.zeros((1, SIZE, SIZE, 3))))
    tj = VGG16(num_classes=5, cfg=VGG_CFG, fc_width=32, input_size=SIZE)
    tj.load_state_dict(checkpoint.vgg16_from_jax(jjv))
    return jj, jjv, tj.eval()


# ------------------------------------------------------------------ model

@pytest.mark.parametrize("input_minmax", [False, True],
                         ids=["plain", "input_minmax"])
def test_simple_unet_matches_jax(input_minmax):
    """SimpleUNet on shared weights (simple_unet_from_jax) vs tsr_tpu's,
    fp32: within 1e-5, with and without the per-image min-max stretch
    (inputs of a narrow range, so the stretch changes them); the state
    dict carries the reference's torch names and the output the input's
    dtype."""
    jm, jv = _jax_unet(0, input_minmax)
    tm = _port_unet(jv, input_minmax)
    assert {"enc1.0.weight", "enc1.2.weight", "bottleneck.2.bias",
            "up2.weight", "up1.bias", "dec1.0.bias",
            "final.weight"} <= set(tm.state_dict())
    x = np.random.default_rng(1).uniform(0.3, 0.6, (2, SIZE, SIZE, 3))
    x = x.astype(np.float32)
    ref = np.asarray(jm.apply(jv, x))
    with torch.no_grad():
        got = tm(_nchw(x))
    assert got.dtype == torch.float32
    assert np.abs(_nhwc(got) - ref).max() <= 1e-5
    with pytest.raises(ValueError, match="divisible by 4"):
        tm(torch.zeros(1, 3, 30, 32))


def test_reference_state_dict_loads_by_load_state_dict(tmp_path):
    """A state dict written by tsr_tpu.checkpoint.simple_unet_to_state_dict
    and save_pth loads into the port by load_state_dict with no mapping;
    at the reference's widths (64, 128) it loads through zoo.load_model as
    a ``.pth``, and, with input_minmax, as the ``model`` of a checkpoint
    directory beside the JAX checkpoint's config.json (the README's
    migration); each gives the JAX model's output within 1e-5."""
    x = np.random.default_rng(2).uniform(0.2, 0.7, (1, SIZE, SIZE, 3))
    x = x.astype(np.float32)
    for widths, minmax in ((WIDTHS, False), ((64, 128), False),
                           ((64, 128), True)):
        jm, jv = _jax_unet(3, minmax, widths=widths)
        sd = jcheckpoint.simple_unet_to_state_dict(jv)
        if minmax:
            (tmp_path / "fog").mkdir()
            jcheckpoint.save_pth(str(tmp_path / "fog" / "model"), sd)
            (tmp_path / "fog" / "config.json").write_text(json.dumps(
                {"input_minmax": True, "identity_frac": 0.0}))
            tm = zoo.load_model("simple_unet", str(tmp_path / "fog"),
                                device="cpu")
            assert tm.input_minmax
        else:
            path = str(tmp_path / f"restoration_{widths[0]}.pth")
            jcheckpoint.save_pth(path, sd)
            if widths == WIDTHS:
                tm = SimpleUNet(widths=widths)
                tm.load_state_dict(torch.load(path, weights_only=True))
            else:
                tm = zoo.load_model("simple_unet", path, device="cpu")
        with torch.no_grad():
            got = _nhwc(tm(_nchw(x)))
        assert np.abs(got - np.asarray(jm.apply(jv, x))).max() <= 1e-5


# ------------------------------------------------------------ distortions

@pytest.mark.parametrize("seed,shape", [(0, (3, 29, 37, 3)),
                                        (1, (2, 3, 17, 3)),
                                        (2, (40, 30, 3))],
                         ids=["ragged", "3px-side", "single-image"])
def test_mild_distortions_match_jax(seed, shape):
    """mild_noise (the reference's normal field injected) and mild_fog
    uint8-equal to tsr_tpu's; mild_blur (one shared K=5 kernel) uint8-equal
    wherever the reference's float32 blur is not within 1e-4 of a
    cvRound tie, and within 1 LSB at such a tie, where float32 sums in
    another order may round the other way (1 of 9,657 values of the ragged
    batch: 115.49999 against 115.5)."""
    img = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
    key = jax.random.PRNGKey(seed)
    batch = img if img.ndim == 4 else img[None]
    noise = np.array(jax.random.normal(key, batch.shape, jnp.float32))
    got = tdist.mild_noise(img, device="cpu",
                           noise=_t(noise.reshape(img.shape)))
    assert got.shape == img.shape and got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), np.asarray(jdist.mild_noise(img, key)))
    assert np.array_equal(tdist.mild_fog(img, device="cpu").numpy(),
                          np.asarray(jdist.mild_fog(img)))
    got = tdist.mild_blur(img, device="cpu").numpy()
    ref = np.asarray(jdist.mild_blur(img))
    mild = jconfigs.MildConfig()
    kernel = jblur.motion_blur_kernel(mild.blur_degree, mild.blur_angle,
                                      max_degree=mild.blur_degree)
    ref_f = np.asarray(jblur.filter2d(jnp.asarray(batch, jnp.float32),
                                      kernel)).reshape(img.shape)
    ties = np.abs(ref_f - np.floor(ref_f) - 0.5) < 1e-4
    assert np.array_equal(got[~ties], ref[~ties])
    assert ties.sum() <= 1e-3 * ties.size
    if ties.any():
        assert _lsb(got[ties], ref[ties]) <= 1


# ------------------------------------------------------------------- data

def _paired_tree(tmp_path):
    """A cv2-written clean tree of .ppm files, and a distorted twin whose
    files are .ppm, .png (the fallback) or missing."""
    rng = np.random.default_rng(4)
    clean, bad = tmp_path / "clean", tmp_path / "bad"
    for k in range(9):
        h, w = 20 + 3 * k, 41 - 2 * k
        rel = f"c{k % 3}/img{k:02d}"
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        (clean / rel).parent.mkdir(parents=True, exist_ok=True)
        (bad / rel).parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(clean / f"{rel}.ppm"), img)
        if k != 4:
            ext = ".png" if k % 3 == 1 else ".ppm"
            cv2.imwrite(str(bad / f"{rel}{ext}"), 255 - img)
    return str(clean), str(bad)


def test_paired_folder_and_split_match_jax(tmp_path):
    """PairedFolder pairs (relative path, .png fallback, a missing
    distorted file skipped) equal tsr_tpu's, and load_batch's pixels are
    the same (load's within 1 LSB of tsr_tpu's cv2 decode, and equal to
    load_batch's); train_val_split is tsr_tpu's index for index."""
    clean, bad = _paired_tree(tmp_path)
    ours = gtsrb.PairedFolder(clean, bad, size=SIZE)
    ref = jgtsrb.PairedFolder(clean, bad, size=SIZE)
    assert ours.pairs == ref.pairs and len(ours) == 8
    assert sum(p.endswith(".png") for p, _ in ours.pairs) == 2
    idx = [5, 0, 7]
    for a, b in zip(ours.load_batch(idx), ref.load_batch(idx)):
        assert a.shape == (3, SIZE, SIZE, 3) and np.array_equal(a, b)
    # tsr_tpu decodes a single image through cv2, which the IO library
    # matches within 1 LSB (tests/test_torch_port_trees.py)
    for a, b, c in zip(ours.load(2), ref.load(2), ours.load_batch([2])):
        assert _lsb(a, b) <= 1 and np.array_equal(a, c[0])
    for n, frac, seed in ((10, 0.9, 0), (1344, 0.9, 0), (37, 0.5, 3)):
        for a, b in zip(gtsrb.train_val_split(n, frac, seed),
                        jgtsrb.train_val_split(n, frac, seed)):
            assert a.tolist() == b.tolist()


# ------------------------------------------------------------ train steps

class _CaptureGrads(torch.optim.SGD):
    """Leaves the parameters as they are and keeps each step's gradients."""

    def __init__(self, params):
        super().__init__(params, lr=0.0)
        self.grads = None

    def step(self, closure=None):
        self.grads = [p.grad.clone() for g in self.param_groups
                      for p in g["params"]]


def _perceptual(judges):
    jj, jjv, tj = judges
    jva = lambda x: jj.apply(  # noqa: E731
        jjv, x, train=False, tap_layer=jj.tap_index(jvgg.PERCEPTUAL_TAP))
    return jva, losses.perceptual_features(tj)


def _pairs(seed, n=4):
    rng = np.random.default_rng(seed)
    clean = rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)
    bad = np.clip(clean.astype(int) + rng.integers(-40, 41, clean.shape),
                  0, 255).astype(np.uint8)
    return bad, clean


def _l1_tie_correction(tm, jm, jv, bad01, clean01):
    """Where the prediction equals its target exactly (a dead-ReLU pixel
    whose output is the final bias, 0 at init, over a 0 target), the
    subgradient of |x| at 0 is 0 in torch (the reference's nn.L1Loss) and
    1 in JAX. Returns the gradient of the L1 term's tie elements under
    JAX's choice, ``sum(pred[ties]) / N``: the port's gradient plus it is
    JAX's. Both sides must find the same ties."""
    x = _nchw(bad01)
    pred = tm(x).permute(0, 2, 3, 1)
    ties = (pred == _t(clean01)).detach()
    jties = np.asarray(jm.apply(jv, bad01)) == clean01
    assert np.array_equal(ties.numpy(), jties)
    return torch.autograd.grad(pred[ties].sum() / ties.numel(),
                               list(tm.parameters()))


@pytest.mark.parametrize("pixel,perceptual", [("mse", False), ("l1", True)],
                         ids=["specialized-mse", "advanced-l1-perceptual"])
def test_restoration_step_matches_jax(judges, pixel, perceptual):
    """make_restoration_train_step vs tsr_tpu's jitted step on the same
    weights, on uint8 pairs (MSE) and on float01 pairs (L1 + perceptual):
    loss, pixel and perceptual losses within 1e-5
    relative; every parameter's gradient within 1e-4 of its tensor's
    largest plus 1e-6 of the model's largest (float32 sums in another
    order; for L1, once _l1_tie_correction puts JAX's subgradient at the
    exact ties); the eval step's aux within 1e-5 relative of tsr_tpu's."""
    jm, jv = _jax_unet(5)
    tm = _port_unet(jv)
    jva, tva = _perceptual(judges) if perceptual else (None, None)
    bad, clean = _pairs(6)
    if pixel == "l1":
        # float01 batches, made once for both sides: L1's gradient is
        # sign(pred - clean), and a clean value one float32 step off (the
        # jitted reference divides uint8 by 255 as a multiply by 1/255)
        # would move the ties _l1_tie_correction finds
        bad, clean = (a.astype(np.float32) / np.float32(255)
                      for a in (bad, clean))
    jstep = jcommon.make_restoration_train_step(pixel, 0.1, jva, jit=False)
    jstate = jcommon.TrainState.create(jm.apply, jv, _capture_grads())
    new_jstate, jaux = jax.jit(jstep)(jstate, bad, clean)
    ref_sd = checkpoint.simple_unet_from_jax(
        jax.device_get({"params": new_jstate.opt_state}))

    opt = _CaptureGrads(tm.parameters())
    state = common.TrainState(
        tm, opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda c: 1.0))
    aux = common.make_restoration_train_step(pixel, 0.1, tva)(
        state, _t(bad), _t(clean))
    assert state.step == 1 and set(aux) == set(jaux)
    for k in jaux:
        assert abs(aux[k].item() - float(jaux[k])) <= 1e-5 * abs(
            float(jaux[k])), k
    names = [n for n, _ in tm.named_parameters()]
    grads = opt.grads
    if pixel == "l1":
        grads = [g + c for g, c in zip(grads, _l1_tie_correction(
            tm, jm, jv, bad, clean))]
    top = max(ref_sd[n].abs().max().item() for n in names)
    for name, g in zip(names, grads):
        ref = ref_sd[name]
        err = (g - ref).abs().max().item()
        assert err <= 1e-4 * ref.abs().max().item() + 1e-6 * top, (name, err)

    jeval_aux = jcommon.make_restoration_eval_step(pixel, 0.1, jva)(
        jstate, bad, clean)
    tm.train()
    taux = common.make_restoration_eval_step(pixel, 0.1, tva)(
        state, _t(bad), _t(clean))
    assert tm.training  # the mode is restored
    for k in jeval_aux:
        assert abs(taux[k].item() - float(jeval_aux[k])) <= 1e-5 * abs(
            float(jeval_aux[k])), k


@pytest.mark.parametrize("which", ["restoration", "advanced"])
def test_restorer_optimizers_match_optax(which):
    """restoration_optimizer (Adam 1e-3) and advanced_optimizer (Adam 2e-4)
    vs tsr_tpu's (optax.adam) over 3 steps on the same gradients: the rate
    stays constant, parameters within 1e-6 (float32 rounding of updates of
    about lr on values of about 1)."""
    jcfg, cfg = ((jconfigs.RestorationTrainConfig(),
                  configs.RestorationTrainConfig()) if which == "restoration"
                 else (jconfigs.AdvancedTrainConfig(),
                       configs.AdvancedTrainConfig()))
    rng = np.random.default_rng(8)
    params = {"w": rng.normal(0, 1, (4, 5)).astype(np.float32),
              "b": rng.normal(0, 1, (5,)).astype(np.float32)}
    grads = [{k: rng.normal(0, 1, v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    tx = getattr(jcommon, f"{which}_optimizer")(jcfg)
    jp, jstate = dict(params), tx.init(params)
    tp = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    opt, schedule = getattr(common, f"{which}_optimizer")(list(tp.values()),
                                                          cfg)
    for g in grads:
        assert opt.param_groups[0]["lr"] == cfg.learning_rate
        updates, jstate = tx.update(g, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = _t(g[k])
        opt.step()
        schedule.step()
    for k, p in tp.items():
        assert np.abs(p.detach().numpy() - np.asarray(jp[k])).max() <= 1e-6


# ---------------------------------------------------------------- trainer

def _train(save_path=None, epochs=1, seed=3, state=None, **kw):
    """The restorer trainer on 10 uint8 pairs: 9 training images at batch
    4 (2 steps, 1 dropped), 3 validation images wrapped to one batch."""
    if state is None:
        torch.manual_seed(0)
        state = common.create_restoration_state(
            SimpleUNet(widths=WIDTHS), configs.RestorationTrainConfig())
    bad, clean = _pairs(9, n=12)
    lines = []
    state, history = loops.train_restorer_on_device(
        state, bad, clean, np.arange(9), np.arange(9, 12), epochs, 4,
        save_path=save_path, log=lines.append, seed=seed, device="cpu", **kw)
    return state, history, lines


def test_train_restorer_epoch_matches_a_hand_loop():
    """One epoch of train_restorer_on_device equals a loop of
    make_restoration_train_step over the same permutation (a host
    generator seeded with ``seed``, the remainder dropped): the same step
    losses and weights exactly; the validation loss is the eval step's
    loss on the 3 validation images within 1e-6 relative."""
    state, history, lines = _train()
    assert state.step == 2 and len(history) == 1 and len(lines) == 2
    torch.manual_seed(0)
    ref = common.create_restoration_state(SimpleUNet(widths=WIDTHS),
                                          configs.RestorationTrainConfig())
    bad, clean = (_t(a) for a in _pairs(9, n=12))
    perm = torch.randperm(9, generator=torch.Generator().manual_seed(3))
    step = common.make_restoration_train_step("mse")
    losses_ = [step(ref, bad[b], clean[b])["loss"].item()
               for b in perm[:8].reshape(2, 4)]
    assert history[0]["step_loss"] == losses_
    for (n, a), (_, b) in zip(state.model.state_dict().items(),
                              ref.model.state_dict().items()):
        assert torch.equal(a, b), n
    val = common.make_restoration_eval_step("mse")(ref, bad[9:], clean[9:])
    assert history[0]["val_loss"] == pytest.approx(val["loss"].item(),
                                                   rel=1e-6)
    with pytest.raises(ValueError, match="fewer than one batch"):
        loops.train_restorer_on_device(state, bad, clean, np.arange(3),
                                       np.arange(3, 6), 1, 4, device="cpu")


def test_train_restorer_checkpoints_and_resume(tmp_path):
    """checkpoint_every writes the state each epoch with the caller's
    config; save_best writes, once at the end, the state of the epoch with
    the lowest validation loss (a run stopped at that epoch reproduces
    it); load_train_state restores weights, Adam's moments and the step
    count, and training on from it equals training on from the original
    state."""
    every = tmp_path / "every"
    state, history, _ = _train(str(every), epochs=2, checkpoint_every=1,
                               ckpt_config={"identity_frac": 0.0})
    assert json.loads((every / "config.json").read_text()) == {
        "identity_frac": 0.0}
    assert torch.load(every / "train", weights_only=True)["step"] == 4

    best = tmp_path / "best"
    _, hist3, lines = _train(str(best), epochs=3, save_best=True)
    vals = [r["val_loss"] for r in hist3]
    best_epoch = 1 + int(np.argmin(vals))
    assert sum("new best" in ln for ln in lines) >= 1
    ref, _, _ = _train(epochs=best_epoch)
    saved = torch.load(best / "model", weights_only=True)
    for n, v in ref.model.state_dict().items():
        assert torch.equal(saved[n], v), n

    torch.manual_seed(1)
    fresh = common.create_restoration_state(SimpleUNet(widths=WIDTHS),
                                            configs.RestorationTrainConfig())
    resumed = zoo.load_train_state(str(every), fresh)
    assert resumed.step == state.step == 4
    for a, b in zip(state.optimizer.state.values(),
                    resumed.optimizer.state.values()):
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
    on, _, _ = _train(state=state)
    on_resumed, _, _ = _train(state=resumed)
    assert on.step == on_resumed.step == 6
    for (n, a), (_, b) in zip(on.model.state_dict().items(),
                              on_resumed.model.state_dict().items()):
        assert torch.equal(a, b), n


# -------------------------------------------------------------------- zoo

def test_zoo_checkpoint_round_trip(tmp_path):
    """save_checkpoint -> load_model: a reference-width SimpleUNet's
    ``input_minmax`` and a judge's ``cfg``/``fc_width``/``num_classes``
    come back from config.json and the outputs are equal; the ``model``
    file is a plain state dict that reference torch code loads; an
    unknown kind raises."""
    torch.manual_seed(2)
    unet = zoo.build_simple_unet(input_minmax=True, device="cpu")
    state = common.create_restoration_state(unet,
                                            configs.RestorationTrainConfig())
    base = tmp_path / "restoration_fog"
    zoo.save_checkpoint(str(base), state, {"input_minmax": True,
                                           "severity": "reference"})
    assert zoo.checkpoint_config(str(base))["severity"] == "reference"
    loaded = zoo.load_model("simple_unet", str(base), device="cpu")
    assert loaded.input_minmax and not loaded.training
    x = torch.rand(1, 3, SIZE, SIZE,
                   generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        assert torch.equal(loaded(x), unet.eval()(x))
    plain = SimpleUNet()
    plain.load_state_dict(torch.load(base / "model", weights_only=True))

    judge = VGG16(num_classes=7, cfg=VGG_CFG, fc_width=24, input_size=SIZE)
    jstate = common.TrainState(judge, *common.restoration_optimizer(
        judge.parameters(), configs.RestorationTrainConfig()))
    zoo.save_checkpoint(str(tmp_path / "judge"), jstate,
                        {"num_classes": 7, "cfg": list(VGG_CFG),
                         "fc_width": 24, "use_batchnorm": False})
    got = zoo.load_model("vgg16", str(tmp_path / "judge" / "model"),
                         size=SIZE, device="cpu")
    with torch.no_grad():
        assert torch.equal(got(x), judge.eval()(x))
    with pytest.raises(ValueError, match="unknown model kind"):
        zoo.load_model("unet3", None, device="cpu")


# ---------------------------------------------------------------- cascade

_SEVERITY = (None, "reference", "jittered")
_IDENTITY = (None, 0.0, 0.25)
_MINMAX = (None, True)


def _provenance(severity, identity, minmax):
    cfg = {}
    for key, v in (("severity", severity), ("identity_frac", identity),
                   ("input_minmax", minmax)):
        if v is not None:
            cfg[key] = v
    return cfg


@pytest.mark.parametrize("severity,identity,minmax", list(itertools.product(
    _SEVERITY, _IDENTITY, _MINMAX)))
def test_cascade_variant_matches_jax(severity, identity, minmax):
    """cascade_variant equals tsr_tpu's for a checkpoint config with each
    combination of the provenance keys (each absent or set), given to
    each restorer alone, to all three, and beside restorers with no
    config or an empty one."""
    cfg = _provenance(severity, identity, minmax)
    cases = [{t: cfg} for t in pipeline.RESTORATION_ORDER]
    cases += [{t: cfg for t in pipeline.RESTORATION_ORDER}, {},
              {"noise": None, "fog": cfg, "blur": {}}]
    for case in cases:
        assert pipeline.cascade_variant(case) == \
            jpipeline.cascade_variant(case), case
    assert pipeline.VARIANT_TABLE == jpipeline.VARIANT_TABLE
    assert pipeline.RESTORATION_ORDER == jpipeline.RESTORATION_ORDER
    assert pipeline.DISTORTION_ORDER == jpipeline.DISTORTION_ORDER


@pytest.fixture(scope="module")
def restorers():
    """Three small SimpleUNets in both frameworks, the fog one with
    input_minmax."""
    out = {}
    for seed, task in enumerate(pipeline.RESTORATION_ORDER):
        minmax = task == "fog"
        jm, jv = _jax_unet(10 + seed, minmax)
        out[task] = (jm, jv, _port_unet(jv, minmax).eval())
    return out


def test_cascade_stress_matches_jax(judges, restorers):
    """cascade_stress with per-task restorers (the fog one with
    input_minmax) vs tsr_tpu's on the same precomputed stages: preds equal
    at all 7 stages, confidences within 1e-5, the restored stages within
    1e-5; the four distorted stages stay uint8 and the restored ones are
    float01. Without precomputed stages, with the reference's normal field
    injected, the distorted stages are tsr_tpu's (uint8, mild_blur within
    1 LSB) and the preds equal."""
    jj, jjv, tj = judges
    japply = {t: m.apply for t, (m, _, _) in restorers.items()}
    jvars = {t: v for t, (_, v, _) in restorers.items()}
    ours = {t: m for t, (_, _, m) in restorers.items()}
    judge_apply = lambda v, x, train=False: jj.apply(  # noqa: E731
        v, x, train=train)
    clean = np.random.default_rng(12).integers(0, 256, (4, SIZE, SIZE, 3),
                                               dtype=np.uint8)
    key = jax.random.PRNGKey(4)
    ref = jpipeline.cascade_stress(clean, japply, jvars, judge_apply, jjv,
                                   key)
    got = pipeline.cascade_stress(clean, ours, tj,
                                  precomputed_stages=ref["stages"][:4],
                                  device="cpu")
    assert [n for n, _ in got["stages"]] == [n for n, _ in ref["stages"]]
    for k, ((_, a), (_, b)) in enumerate(zip(got["stages"], ref["stages"])):
        assert a.dtype == (np.uint8 if k < 4 else np.float32)
        assert np.abs(a.astype(np.float32) - np.asarray(b)).max() <= 1e-5
    for k in range(7):
        assert np.array_equal(got["preds"][k], ref["preds"][k]), k
        assert np.abs(got["confidences"][k]
                      - ref["confidences"][k]).max() <= 1e-5, k
    for k, v in ref["mean_confidence"].items():
        assert abs(got["mean_confidence"][k] - v) <= 1e-5, k

    noise = np.array(jax.random.normal(key, clean.shape, jnp.float32))
    drawn = pipeline.cascade_stress(clean, ours, tj, noise=_t(noise),
                                    device="cpu")
    for (_, a), (_, b) in zip(drawn["stages"][:4], ref["stages"][:4]):
        assert a.dtype == np.uint8 and _lsb(a, b) <= 1
    assert np.array_equal(drawn["preds"][0], ref["preds"][0])
    with pytest.raises(ValueError, match="expect Clean"):
        pipeline.cascade_stress(clean, ours, tj, device="cpu",
                                precomputed_stages=ref["stages"][:3])
