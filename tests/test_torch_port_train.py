"""The port's unified train step and trainer against the JAX package on the
CPU: the antialiased resize, the multiscale random mix and the training
pair, the training-mode batch norm, the losses, the step's loss,
gradients and batch statistics, AdamW with its cosine schedule, remat, and
the device-resident trainer.

Small widths: ResUNet (8, 16, 32) / 64 and a VGG whose ``features`` reach
the perceptual tap 15. Inputs and the reference's draws are made with
numpy / jax and handed to both sides; JAX runs in float32 at
``precision=HIGHEST``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from test_torch_port_slice import _reference_draws
from tsr_tpu import configs as jconfigs
from tsr_tpu import losses as jlosses
from tsr_tpu.models import ResUNet as JResUNet
from tsr_tpu.models import VGG16 as JVGG16
from tsr_tpu.models import vgg as jvgg
from tsr_tpu.ops import distortions as jdist
from tsr_tpu.train import common as jcommon
from tsr_tpu.train import loops as jloops
from tsr_tpu_torch import checkpoint, configs, losses
from tsr_tpu_torch.models import ResUNet, VGG16
from tsr_tpu_torch.models import vgg as tvgg
from tsr_tpu_torch.models.layers import BatchNorm2d, batchnorm_fed_biases
from tsr_tpu_torch.ops import distortions as tdist
from tsr_tpu_torch.ops import image as timage
from tsr_tpu_torch.train import common, loops

torch.set_num_threads(2)
HI = jax.lax.Precision.HIGHEST
WIDTHS, BOTTLENECK = (8, 16, 32), 64
VGG_CFG = (16, 16, "M", 32, 32, "M", 32, 32, 32, "M")  # reaches tap 15
SCALES = (16, 24)


def _t(x):
    return torch.from_numpy(np.array(x))


def _nchw(x):
    return _t(np.asarray(x).transpose(0, 3, 1, 2))


def _lsb(a, b):
    return int(np.abs(np.asarray(a).astype(int)
                      - np.asarray(b).astype(int)).max())


# ------------------------------------------------------------------ resize

@pytest.mark.parametrize("src,dst", [(32, 16), (32, 24), (224, 40),
                                     (16, 32), (40, 224)])
def test_resize_linear_matches_jax(src, dst):
    """resize_linear vs jax.image.resize(..., "linear"), down and up: within
    5e-6 (float32 sums of up to 12 taps in another order). Downsampling
    without antialiasing misses by more than 0.05: the trap ROADMAP
    section C records."""
    x = np.random.default_rng(src + dst).uniform(0, 1, (2, src, src, 3))
    x = x.astype(np.float32)
    ref = np.asarray(jax.image.resize(x, (2, dst, dst, 3), "linear"))
    got = timage.resize_linear(_t(x), dst)
    assert got.shape == (2, dst, dst, 3)
    assert np.abs(got.numpy() - ref).max() <= 5e-6
    if dst < src:
        plain = F.interpolate(_t(x).permute(0, 3, 1, 2), size=(dst, dst),
                              mode="bilinear", align_corners=False)
        assert np.abs(plain.permute(0, 2, 3, 1).numpy() - ref).max() > 0.05


# ------------------------------------------------------------- batch norm

@pytest.mark.parametrize("shape,dtype", [
    ((2, 4, 4, 6), "fp32"), ((1, 8, 8, 6), "fp32"), ((4, 16, 16, 3), "fp32"),
    ((1, 8, 8, 6), "bf16")], ids=["n32", "n64", "n1024", "n64-bf16"])
def test_batchnorm_train_matches_flax(shape, dtype):
    """Train-mode BatchNorm2d vs flax BatchNorm(use_running_average=False,
    momentum=0.9): output within 1e-5 in float32 (one bf16 step, 1/64 at
    magnitudes 2-4, in bf16), running mean and variance within 1e-6. The
    unbiased running-variance update (F.batch_norm's own) misses Flax's
    by over 100x that at n = 64 values per channel. The eval branch is
    unchanged: F.batch_norm in float32 on the running statistics."""
    rng = np.random.default_rng(sum(shape))
    c = shape[-1]
    x = rng.normal(0.3, 2.0, shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 0.1, c).astype(np.float32)
    mean = rng.normal(0, 0.1, c).astype(np.float32)
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    jdtype = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdtype = torch.bfloat16 if dtype == "bf16" else torch.float32
    xj = jnp.asarray(x, jdtype)
    ref, upd = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                             epsilon=1e-5, dtype=jdtype).apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean, "var": var}},
        xj, mutable=["batch_stats"])
    bn = BatchNorm2d(c)
    bn.load_state_dict({"weight": _t(scale), "bias": _t(bias),
                        "running_mean": _t(mean), "running_var": _t(var),
                        "num_batches_tracked": torch.tensor(0)})
    bn.train()
    xt = _nchw(np.asarray(xj.astype(jnp.float32))).to(tdtype)
    got = bn(xt)
    assert got.dtype == tdtype
    tol = 1.0 / 64 if dtype == "bf16" else 1e-5
    assert np.abs(got.float().detach().numpy()
                  - np.asarray(ref.astype(jnp.float32)).transpose(
                      0, 3, 1, 2)).max() <= tol
    new = upd["batch_stats"]
    assert np.abs(bn.running_mean.numpy() - new["mean"]).max() <= 1e-6
    assert np.abs(bn.running_var.numpy() - new["var"]).max() <= 1e-6
    if shape == (1, 8, 8, 6):
        rm, rv = _t(mean), _t(var)
        F.batch_norm(xt.float(), rm, rv, None, None, True, 0.1, 1e-5)
        assert np.abs(rv.numpy() - new["var"]).max() > 1e-4
    bn.eval()
    plain = F.batch_norm(xt.float(), bn.running_mean, bn.running_var,
                         bn.weight, bn.bias, False, 0.0, bn.eps).to(tdtype)
    assert torch.equal(bn(xt), plain)


# ------------------------------------------------------ multiscale mix

def _reference_group_draws(key, batch, cfg):
    """The per-group draws and N(0,1) fields tsr_tpu's multiscale mix takes
    from ``key`` (ops/distortions.py:309-325), as one port MixDraws for the
    batch (one seed per scale) and one noise field per scale."""
    keys = jax.random.split(key, len(cfg.apply_scales))
    draws, noise = [], [None] * len(cfg.apply_scales)
    for i, start, stop, s in tdist.scale_groups(batch, cfg.apply_scales):
        d, *_ = _reference_draws(keys[i], stop - start, cfg)
        draws.append(d)
        noise[i] = _t(jax.random.normal(jax.random.split(keys[i], 8)[5],
                                        (stop - start, s, s, 3), jnp.float32))
    fields = {f.name: torch.cat([getattr(d, f.name) for d in draws])
              for f in dataclasses.fields(tdist.MixDraws)
              if f.name not in ("seed", "atmosphere")}
    return tdist.MixDraws(**fields, seed=torch.zeros(len(cfg.apply_scales),
                                                     dtype=torch.int64),
                          atmosphere=cfg.fog_atmosphere), noise


@pytest.mark.parametrize("seed,batch,scales", [
    (0, 8, SCALES), (5, 7, SCALES), (2, 3, (16, 20, 24, 28))],
    ids=["even", "remainder", "empty-groups"])
def test_multiscale_mix_and_training_pair_match_jax(seed, batch, scales):
    """random_mix_multiscale_from_draws with the reference's per-group draws
    and noise vs tsr_tpu's apply_random_distortions_multiscale: within 1
    LSB (a float32 rounding in the resizes or the blur's cvRound may move a
    value one level); the training pair is that / 255, and its clean side
    within 1.2e-7 (jitted JAX divides by 255 as a multiply by 1/255).
    Batch 7 leaves the last group the remainder (3 + 4); batch 3 of four
    scales leaves only the last group, keyed by the last scale's key."""
    cfg = jconfigs.RandomMixConfig(apply_scales=scales)
    img = np.random.default_rng(seed).integers(0, 256, (batch, 32, 32, 3),
                                               dtype=np.uint8)
    key = jax.random.PRNGKey(seed)
    draws, noise = _reference_group_draws(key, batch, cfg)
    ref = np.asarray(jdist.apply_random_distortions_multiscale(img, key, cfg))
    got = tdist.random_mix_multiscale_from_draws(_t(img), draws, scales,
                                                 noise)
    assert got.dtype == torch.uint8 and got.shape == img.shape
    assert _lsb(got.numpy(), ref) <= 1
    jbad, jclean = jdist.make_training_pair(img, key, cfg)
    assert np.abs(timage.to_float01(got).numpy()
                  - np.asarray(jbad)).max() <= 1 / 255 + 1e-6
    assert np.abs(timage.to_float01(_t(img)).numpy()
                  - np.asarray(jclean)).max() <= 1.2e-7


@pytest.mark.parametrize("scales", [SCALES, (40, 56), ()],
                         ids=["multiscale", "at-or-above-size", "single"])
def test_make_training_pair_draws_then_mixes(scales):
    """make_training_pair on the CPU is the from-draws mix on draws taken
    from its generator (one noise seed per scale), then / 255; scales at
    or above the batch's size distort in place, and no scales is the
    single-scale mix."""
    cfg = configs.RandomMixConfig(apply_scales=scales)
    img = torch.randint(0, 256, (6, 32, 32, 3), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(1))
    bad, clean = tdist.make_training_pair(
        img, torch.Generator().manual_seed(4), cfg, device="cpu")
    g = torch.Generator().manual_seed(4)
    if scales:
        draws = tdist.draw_random_mix(6, g, cfg, n_seeds=len(scales))
        ref = tdist.random_mix_multiscale_from_draws(img, draws, scales)
    else:
        ref = tdist.random_mix_from_draws(img, tdist.draw_random_mix(6, g,
                                                                     cfg))
    assert torch.equal(bad, timage.to_float01(ref))
    assert torch.equal(clean, timage.to_float01(img))
    assert bad.shape == clean.shape == (6, 32, 32, 3)


# ------------------------------------------------------------- models

def _randomize(variables, rng):
    """Non-trivial BN statistics and affine parameters (a fresh Flax init
    has mean 0, var 1, scale 1)."""
    v = jax.tree.map(np.array, jax.device_get(variables))

    def walk(p, s):
        for k in p:
            if isinstance(p[k], dict) and "scale" in p[k]:
                shape = p[k]["scale"].shape
                p[k]["scale"] = rng.uniform(0.5, 1.5, shape).astype(
                    np.float32)
                p[k]["bias"] = rng.normal(0, 0.1, shape).astype(np.float32)
                s[k]["mean"] = rng.normal(0, 0.1, shape).astype(np.float32)
                s[k]["var"] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
            elif isinstance(p[k], dict):
                walk(p[k], s.get(k, {}))
    walk(v["params"], v.get("batch_stats", {}))
    return v


@pytest.fixture(scope="module")
def jax_models():
    rng = np.random.default_rng(21)
    jr = JResUNet(widths=WIDTHS, bottleneck_width=BOTTLENECK, precision=HI)
    jrv = _randomize(jr.init(jax.random.PRNGKey(1),
                             jnp.zeros((1, 32, 32, 3))), rng)
    jj = JVGG16(num_classes=5, cfg=VGG_CFG, fc_width=32, precision=HI)
    jjv = jax.tree.map(np.array, jj.init(jax.random.PRNGKey(2),
                                         jnp.zeros((1, 32, 32, 3))))
    return jr, jrv, jj, jjv


def _port_models(jax_models):
    _, jrv, _, jjv = jax_models
    tr = ResUNet(widths=WIDTHS, bottleneck_width=BOTTLENECK)
    tr.load_state_dict(checkpoint.resunet_from_jax(jrv))
    tj = VGG16(num_classes=5, cfg=VGG_CFG, fc_width=32, input_size=32)
    tj.load_state_dict(checkpoint.vgg16_from_jax(jjv))
    return tr.train(), tj


@pytest.mark.parametrize("use_batchnorm", [False, True])
def test_feature_slice_apply_matches_jax(use_batchnorm):
    """feature_slice_apply (features[:16], the batch-norm variant's index
    translated by tap_index) vs tsr_tpu's, within 5e-5 (float32
    convolutions summed in another order)."""
    assert tvgg.PERCEPTUAL_TAP == jvgg.PERCEPTUAL_TAP == 15
    kw = dict(num_classes=5, cfg=VGG_CFG, fc_width=32,
              use_batchnorm=use_batchnorm)
    jm = JVGG16(precision=HI, **kw)
    jv = _randomize(jm.init(jax.random.PRNGKey(3),
                            jnp.zeros((1, 32, 32, 3))),
                    np.random.default_rng(3))
    tm = VGG16(input_size=32, **kw)
    tm.load_state_dict(checkpoint.vgg16_from_jax(jv))
    tm.eval()
    x = np.random.default_rng(4).uniform(0, 1, (2, 32, 32, 3)).astype(
        np.float32)
    ref = np.asarray(jvgg.feature_slice_apply(jm, jv, x, 16))
    with torch.no_grad():
        got = tvgg.feature_slice_apply(tm, _nchw(x), 16)
    assert got.shape[1] == VGG_CFG[-2]
    assert np.abs(got.numpy() - ref.transpose(0, 3, 1, 2)).max() <= 5e-5


# ----------------------------------------------------------------- losses

def test_losses_match_jax(jax_models):
    """l1, mse, the perceptual loss (frozen VGG, un-normalized [0,1] input)
    and restoration_loss's value and aux, pixel l1 and mse, vs tsr_tpu's:
    within 1e-6 relative (float32 means in another order), 1e-5 where the
    VGG's features enter (convolutions summed in another order, then
    differenced); the frozen VGG's parameters take no gradient."""
    _, _, jj, jjv = jax_models
    _, tj = _port_models(jax_models)
    rng = np.random.default_rng(5)
    pred = rng.uniform(-0.1, 1.1, (3, 32, 32, 3)).astype(np.float32)
    target = rng.uniform(0, 1, (3, 32, 32, 3)).astype(np.float32)
    tp, tt = _nchw(pred), _nchw(target)

    def close(a, b, rtol=1e-6):
        a, b = float(a), float(b)
        assert abs(a - b) <= rtol * abs(b), (a, b)

    close(losses.l1_loss(tp, tt), jlosses.l1_loss(pred, target))
    close(losses.mse_loss(tp, tt), jlosses.mse_loss(pred, target))
    jperc = jlosses.make_perceptual_loss(jj, jjv, upto=16)
    tperc = losses.make_perceptual_loss(tj, upto=16)
    assert not any(p.requires_grad for p in tj.parameters())
    close(tperc(tp, tt), jperc(pred, target), 1e-5)
    for pixel in ("l1", "mse"):
        for jp, tpc, rtol in ((None, None, 1e-6), (jperc, tperc, 1e-5)):
            jl, jaux = jlosses.restoration_loss(pred, target, jp, 0.1, pixel)
            tl, taux = losses.restoration_loss(tp, tt, tpc, 0.1, pixel)
            assert set(taux) == set(jaux)
            close(tl, jl, rtol)
            for k in jaux:
                close(taux[k], jaux[k], rtol)


def test_per_sample_restoration_loss_matches_jax(jax_models):
    """The validation's [B] per-sample loss vs tsr_tpu's, pixel l1 and mse
    with the perceptual term: within 1e-6 relative."""
    _, _, jj, jjv = jax_models
    _, tj = _port_models(jax_models)
    rng = np.random.default_rng(6)
    pred = rng.uniform(0, 1, (3, 32, 32, 3)).astype(np.float32)
    clean = rng.uniform(0, 1, (3, 32, 32, 3)).astype(np.float32)
    jva = lambda x: jvgg.feature_slice_apply(jj, jjv, x, 16)  # noqa: E731
    tva = losses.perceptual_features(tj)
    for pixel in ("l1", "mse"):
        ref = np.asarray(jloops._per_sample_restoration_loss(
            pred, clean, pixel, 0.1, jva))
        with torch.no_grad():
            got = loops._per_sample_restoration_loss(
                _nchw(pred), _nchw(clean), pixel, 0.1, tva).numpy()
        assert got.shape == (3,)
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


# ------------------------------------------------------------ train step

def _capture_grads():
    """An optax transformation that leaves the parameters as they are and
    keeps the step's gradients as its state, so the jitted reference step
    hands them back exactly."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree.map(jnp.zeros_like, grads), grads))


def _assert_grads_match(model, ref_sd, rtol):
    """Each gradient within ``rtol`` of its tensor's largest plus ``rtol``
    / 100 of the model's largest gradient (a sum that cancels, such as a
    PReLU slope's, keeps the rounding of its terms). A convolution bias
    that feeds a batch norm has an exact gradient of 0 (the norm subtracts
    it out again): both sides must be below ``rtol`` / 10 of the model's
    largest gradient."""
    params = dict(model.named_parameters())
    top = max(np.abs(ref_sd[n].numpy()).max() for n in params)
    fed = batchnorm_fed_biases(model)
    assert fed and fed <= set(params)
    for name, p in params.items():
        ref, got = ref_sd[name].numpy(), p.grad.numpy()
        if name in fed:
            assert max(np.abs(ref).max(), np.abs(got).max()) <= (
                rtol / 10 * top), name
            continue
        err = np.abs(got - ref).max()
        assert err <= rtol * np.abs(ref).max() + rtol / 100 * top, (name,
                                                                    err)


def test_unified_step_matches_jax(jax_models):
    """The unified step on the reference's own training pair: loss, pixel
    and perceptual losses within 1e-5 relative of tsr_tpu's jitted step;
    every parameter's gradient as _assert_grads_match holds it at 1e-4
    (float32 sums over a deep net in another order, through batch
    statistics; the worst tensor measured 5e-5); the batch norms' running
    statistics after the step within 1e-5 of the layer's largest (and at
    least 1: statistics of activations that already differ in their last
    bits, which Flax takes as E[x^2] - E[x]^2)."""
    jr, jrv, jj, jjv = jax_models
    tr, tj = _port_models(jax_models)
    cfg = jconfigs.RandomMixConfig(apply_scales=SCALES)
    clean = np.random.default_rng(7).integers(0, 256, (8, 32, 32, 3),
                                              dtype=np.uint8)
    key = jax.random.PRNGKey(7)
    jva = lambda x: jj.apply(jjv, x, train=False,  # noqa: E731
                             tap_layer=jj.tap_index(jvgg.PERCEPTUAL_TAP))
    jstep = jcommon.make_unified_train_step(cfg, 0.1, jva, jit=False)
    state = jcommon.TrainState.create(jr.apply, jrv, _capture_grads())
    new_state, jaux = jax.jit(jstep)(state, clean, key)
    ref_sd = checkpoint.resunet_from_jax(jax.device_get(
        {"params": new_state.opt_state,
         "batch_stats": new_state.batch_stats}))

    bad01, clean01 = jdist.make_training_pair(clean, key, cfg)
    loss, aux = common.unified_loss(tr, _t(bad01), _t(clean01), 0.1,
                                    losses.perceptual_features(tj))
    loss.backward()
    for k in ("loss", "pixel_loss", "perceptual_loss"):
        assert abs(aux[k].item() - float(jaux[k])) <= 1e-5 * abs(
            float(jaux[k])), k
    _assert_grads_match(tr, ref_sd, 1e-4)
    for name, buf in tr.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            ref = ref_sd[name].numpy()
            assert np.abs(buf.numpy() - ref).max() <= 1e-5 * max(
                1.0, np.abs(ref).max()), name
    assert not any(p.grad is not None for p in tj.parameters())


def test_unified_optimizer_matches_optax():
    """AdamW with its per-step cosine schedule vs tsr_tpu's
    unified_optimizer (optax.adamw on cosine_decay_schedule) over 3 steps
    on the same gradients: learning rates within 1e-7 relative (optax
    evaluates the cosine in float32), parameters within 5e-7 (float32
    rounding of updates of about 2e-4 on values of about 1)."""
    kw = dict(cosine_t_max=2)  # decays over 2 x 2 steps: 3 steps walk it
    rng = np.random.default_rng(8)
    params = {"w": rng.normal(0, 1, (4, 5)).astype(np.float32),
              "b": rng.normal(0, 1, (5,)).astype(np.float32)}
    grads = [{k: rng.normal(0, 1, v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    tx = jcommon.unified_optimizer(jconfigs.UnifiedTrainConfig(**kw), 2)
    sched = optax.cosine_decay_schedule(2e-4, 4)
    jp, jstate = dict(params), None
    jstate = tx.init(jp)
    tp = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    opt, schedule = common.unified_optimizer(
        list(tp.values()), configs.UnifiedTrainConfig(**kw), 2)
    for count, g in enumerate(grads):
        lr = opt.param_groups[0]["lr"]
        assert abs(lr - float(sched(count))) <= 1e-7 * 2e-4
        updates, jstate = tx.update(g, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = _t(g[k])
        opt.step()
        schedule.step()
    for k, p in tp.items():
        assert np.abs(p.detach().numpy() - np.asarray(jp[k])).max() <= 5e-7


@pytest.mark.parametrize("remat", [True, "vgg"])
def test_remat_gives_the_same_gradients(jax_models, remat):
    """remat=True (the ResUNet checkpointed) and "vgg" (the perceptual VGG
    checkpointed) give remat=False's loss and gradients exactly (the
    recomputed forward is the same arithmetic), and the running statistics
    move once, not again in the recomputation."""
    cfg = jconfigs.RandomMixConfig(apply_scales=SCALES)
    clean = np.random.default_rng(9).integers(0, 256, (4, 32, 32, 3),
                                              dtype=np.uint8)
    bad01, clean01 = (_t(a) for a in jdist.make_training_pair(
        clean, jax.random.PRNGKey(9), cfg))
    runs = []
    for r in (False, remat):
        tr, tj = _port_models(jax_models)
        loss, _ = common.unified_loss(tr, bad01, clean01, 0.1,
                                      losses.perceptual_features(tj), r)
        loss.backward()
        runs.append((tr, loss.item()))
    (ref, ref_loss), (got, got_loss) = runs
    assert got_loss == ref_loss
    for (n, a), (_, b) in zip(ref.named_parameters(),
                              got.named_parameters()):
        assert torch.equal(a.grad, b.grad), n
    for (n, a), (_, b) in zip(ref.named_buffers(), got.named_buffers()):
        assert torch.equal(a, b), n


def test_train_step_updates_the_state():
    """make_unified_train_step on the CPU: one AdamW update of every
    parameter, running statistics moved, the schedule advanced, finite
    losses returned detached."""
    torch.manual_seed(0)
    model = ResUNet(widths=WIDTHS, bottleneck_width=BOTTLENECK)
    vgg = VGG16(num_classes=5, cfg=VGG_CFG, fc_width=32, input_size=32)
    cfg = configs.UnifiedTrainConfig(
        cosine_t_max=1, mix=configs.RandomMixConfig(apply_scales=SCALES))
    state = common.create_unified_state(model, cfg, 2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = common.make_unified_train_step(cfg.mix, 0.1,
                                          losses.perceptual_features(vgg))
    clean = torch.randint(0, 256, (4, 32, 32, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(2))
    aux = step(state, clean, torch.Generator().manual_seed(3))
    assert state.step == 1
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(1e-4)
    assert set(aux) == {"loss", "pixel_loss", "perceptual_loss"}
    assert all(torch.isfinite(v) and not v.requires_grad
               for v in aux.values())
    after = model.state_dict()
    for k, v in before.items():
        if not k.endswith("num_batches_tracked"):
            assert not torch.equal(v, after[k]), k
    assert all(p.grad is None for p in model.parameters())


# ---------------------------------------------------------------- trainer

def _train(seed, epochs=2):
    torch.manual_seed(0)
    model = ResUNet(widths=WIDTHS, bottleneck_width=BOTTLENECK)
    vgg = VGG16(num_classes=5, cfg=VGG_CFG, fc_width=32, input_size=32)
    cfg = configs.UnifiedTrainConfig(
        batch_size=4, epochs=epochs, seed=seed,
        mix=configs.RandomMixConfig(apply_scales=SCALES))
    state = common.create_unified_state(model, cfg, 2)
    clean = np.random.default_rng(0).integers(0, 256, (11, 32, 32, 3),
                                              dtype=np.uint8)
    lines = []
    state, history = loops.train_unified_on_device(
        state, clean, np.arange(8), np.arange(8, 11), cfg,
        losses.perceptual_features(vgg), log=lines.append, device="cpu")
    return state, history, lines


def test_train_unified_on_device_is_seeded_and_reproducible():
    """Two tiny epochs on the CPU (8 training images at batch 4, 3
    validation images padded to one batch of 4): 2 steps an epoch, finite
    losses, a log line per epoch and its validation; the same seed gives
    the same losses and weights, another seed other ones."""
    state, history, lines = _train(seed=1)
    assert state.step == 4 and len(history) == 2 and len(lines) == 4
    for rec in history:
        assert len(rec["step_loss"]) == len(rec["perceptual_loss"]) == 2
        assert np.isfinite(rec["step_loss"]).all()
        assert np.isfinite(rec["val_loss"]) and rec["images_per_sec"] > 0
        assert rec["train_loss"] == pytest.approx(np.mean(rec["step_loss"]))
    again, history2, _ = _train(seed=1)
    other, history3, _ = _train(seed=2)
    for k in ("step_loss", "val_loss"):
        assert [r[k] for r in history2] == [r[k] for r in history]
        assert [r[k] for r in history3] != [r[k] for r in history]
    for (n, a), (_, b) in zip(state.model.state_dict().items(),
                              again.model.state_dict().items()):
        assert torch.equal(a, b), n


def test_trainer_picks_remat_and_checks_its_sets():
    """remat is "vgg" above batch 64 with a perceptual term, else off (as
    tsr_tpu's trainer picks it); the padded, masked validation indices are
    tsr_tpu's, the pad larger than the set included (1 image at batch 4,
    5 at batch 16); a training set under one batch and an empty validation
    set are refused."""
    vgg_apply = object()
    big = configs.UnifiedTrainConfig(batch_size=128)
    assert loops.auto_remat(big, vgg_apply) == "vgg"
    assert loops.auto_remat(big, None) is False
    assert loops.auto_remat(configs.UnifiedTrainConfig(), vgg_apply) is False
    for n, bs in ((3, 4), (1, 4), (8, 4), (9, 4), (5, 16)):
        va = np.arange(100, 100 + n)
        (pad, mask), (jpad, jmask) = (m._val_wrap_pad(va, bs)
                                      for m in (loops, jloops))
        assert pad.tolist() == jpad.tolist(), (n, bs)
        assert mask.tolist() == jmask.tolist(), (n, bs)
    model = ResUNet(widths=WIDTHS, bottleneck_width=BOTTLENECK)
    cfg = configs.UnifiedTrainConfig(batch_size=4)
    state = common.create_unified_state(model, cfg, 1)
    clean = np.zeros((6, 32, 32, 3), np.uint8)
    with pytest.raises(ValueError, match="fewer than one batch"):
        loops.train_unified_on_device(state, clean, np.arange(3),
                                      np.arange(3, 6), cfg, device="cpu")
    with pytest.raises(ValueError, match="empty validation set"):
        loops.train_unified_on_device(state, clean, np.arange(6),
                                      np.arange(0), cfg, device="cpu")
