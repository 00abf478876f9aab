"""The port's judge training against the JAX package on the CPU: the
cross-entropy loss, both judge optimizers (SGD with momentum; AdamW on a
linear warmup behind global-norm clipping), the train and eval steps (plain
and batch-norm judges), the device-resident and the host-streamed judge
loops with their checkpoints.

Small sizes: a narrow VGG (``cfg=(8, "M", 16, "M")``, FC 32, 5 classes) at
32x32, dropout off on both sides where values are compared (the dropout
streams differ by design). Inputs are made with numpy and handed to both
sides; JAX runs in float32 at ``precision=HIGHEST``.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_port_cascade import _CaptureGrads
from test_torch_port_train import _capture_grads
from tsr_tpu import configs as jconfigs
from tsr_tpu import losses as jlosses
from tsr_tpu.models import VGG16 as JVGG16
from tsr_tpu.train import common as jcommon
from tsr_tpu.train import loops as jloops
from tsr_tpu_torch import checkpoint, configs, losses, zoo
from tsr_tpu_torch.data import gtsrb
from tsr_tpu_torch.models import VGG16
from tsr_tpu_torch.models.layers import batchnorm_fed_biases
from tsr_tpu_torch.train import common, loops

torch.set_num_threads(2)
HI = jax.lax.Precision.HIGHEST
CFG = (8, "M", 16, "M")
FC, NCLS, SIZE = 32, 5, 32


def _t(x):
    return torch.from_numpy(np.array(x))


def _judges(use_batchnorm=False, dropout_rate=0.0, seed=0):
    """The narrow judge in both frameworks on shared weights
    (``vgg16_from_jax``)."""
    jm = JVGG16(num_classes=NCLS, cfg=CFG, fc_width=FC, precision=HI,
                use_batchnorm=use_batchnorm, dropout_rate=dropout_rate)
    jv = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(seed),
                                        jnp.zeros((1, SIZE, SIZE, 3))))
    tm = VGG16(num_classes=NCLS, cfg=CFG, fc_width=FC, input_size=SIZE,
               use_batchnorm=use_batchnorm, dropout_rate=dropout_rate)
    tm.load_state_dict(checkpoint.vgg16_from_jax(jv))
    return jm, jv, tm


def _data(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8),
            rng.integers(0, NCLS, n).astype(np.int32))


def _ckpt_config(use_batchnorm):
    """Script 05's config, with the narrow architecture for load_model."""
    return {"kind": "vgg16", "num_classes": NCLS,
            "use_batchnorm": use_batchnorm, "cfg": list(CFG),
            "fc_width": FC}


# ------------------------------------------------------------------- loss

@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_optax(smoothing):
    """cross_entropy_loss vs tsr_tpu's (optax's integer-label CE, or
    ``smooth_labels`` + softmax CE) on logits with a wide range: within
    1e-6."""
    rng = np.random.default_rng(1)
    logits = (rng.normal(0, 4, (7, NCLS))).astype(np.float32)
    labels = rng.integers(0, NCLS, 7).astype(np.int32)
    ref = float(jlosses.cross_entropy_loss(logits, labels, smoothing))
    got = losses.cross_entropy_loss(_t(logits), _t(labels), smoothing)
    assert abs(got.item() - ref) <= 1e-6


# -------------------------------------------------------------- optimizer

@pytest.mark.parametrize("which", ["sgd", "adamw"])
def test_judge_optimizer_matches_optax(which):
    """judge_optimizer vs tsr_tpu's over 3 steps on the same gradients,
    whose global norms straddle the clip at 1 (0.5, 3, 1.5): SGD with
    momentum 0.9 at a constant rate; AdamW with warmup 2 (rate 0 at count
    0, half at 1, full after) behind clip_by_global_norm(1.0). Rates
    within 1e-7 of the peak, parameters within 5e-7."""
    kw = dict(optimizer=which, warmup_steps=2, learning_rate=1e-2)
    rng = np.random.default_rng(8)
    params = {"w": rng.normal(0, 1, (4, 5)).astype(np.float32),
              "b": rng.normal(0, 1, (5,)).astype(np.float32)}
    grads = []
    for norm in (0.5, 3.0, 1.5):
        g = {k: rng.normal(0, 1, v.shape) for k, v in params.items()}
        total = np.sqrt(sum((a ** 2).sum() for a in g.values()))
        grads.append({k: (a * norm / total).astype(np.float32)
                      for k, a in g.items()})
    tx = jcommon.judge_optimizer(jconfigs.JudgeTrainConfig(**kw))
    sched = (optax.linear_schedule(0.0, 1e-2, 2) if which == "adamw"
             else (lambda count: 1e-2))
    jp, jstate = dict(params), tx.init(params)
    tp = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    opt, schedule = common.judge_optimizer(list(tp.values()),
                                           configs.JudgeTrainConfig(**kw))
    for count, g in enumerate(grads):
        lr = opt.param_groups[0]["lr"]
        assert abs(lr - float(sched(count))) <= 1e-7 * 1e-2, count
        updates, jstate = tx.update(g, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = _t(g[k])
        opt.step()
        schedule.step()
    for k, p in tp.items():
        assert np.abs(p.detach().numpy() - np.asarray(jp[k])).max() <= 5e-7
    with pytest.raises(ValueError, match="unknown judge optimizer"):
        common.judge_optimizer(list(tp.values()),
                               configs.JudgeTrainConfig(optimizer="adam"))


def test_judge_optimizer_first_adamw_update_is_zero_but_moves_moments():
    """At warmup count 0 the AdamW rate is 0: the parameters keep their
    values (weight decay included), Adam's moments take the gradient; with
    ``warmup_steps=0`` the rate is constant from the start."""
    p = torch.nn.Parameter(torch.ones(3))
    opt, _ = common.judge_optimizer(
        [p], configs.JudgeTrainConfig(optimizer="adamw"))
    p.grad = torch.full((3,), 0.25)
    opt.step()
    assert torch.equal(p.detach(), torch.ones(3))
    assert torch.equal(opt.state[p]["exp_avg"], torch.full((3,), 0.025))
    opt, _ = common.judge_optimizer(
        [p], configs.JudgeTrainConfig(optimizer="adamw", warmup_steps=0))
    assert opt.param_groups[0]["lr"] == 1e-3


# ------------------------------------------------------------------ steps

def _assert_grads_match(model, ref_sd, rtol):
    """Each gradient within ``rtol`` of its tensor's largest plus ``rtol``
    / 100 of the model's largest; a conv bias that feeds a batch norm
    (exact gradient 0) below ``rtol`` / 10 of the model's largest on both
    sides."""
    params = dict(model.named_parameters())
    top = max(ref_sd[n].abs().max().item() for n in params)
    fed = batchnorm_fed_biases(model)
    for name, p in params.items():
        ref, got = ref_sd[name], p.grad
        if name in fed:
            assert max(ref.abs().max().item(), got.abs().max().item()) <= (
                rtol / 10 * top), name
            continue
        err = (got - ref).abs().max().item()
        assert err <= rtol * ref.abs().max().item() + rtol / 100 * top, (
            name, err)


@pytest.mark.parametrize("use_batchnorm,smoothing",
                         [(False, 0.0), (True, 0.1)], ids=["plain", "bn"])
def test_judge_train_step_matches_jax(use_batchnorm, smoothing):
    """make_judge_train_step vs tsr_tpu's jitted step from shared weights,
    dropout off, on a uint8 batch: loss and accuracy within 1e-5, every
    gradient within 1e-4 (as _assert_grads_match holds it), and for the
    batch-norm judge the running statistics after the step within 1e-5 of
    the layer's largest (and at least 1); the state counts one step."""
    jm, jv, tm = _judges(use_batchnorm)
    images, labels = _data(3, 6)
    jstep = jcommon.make_judge_train_step(smoothing, jit=False)
    jstate = jcommon.TrainState.create(jm.apply, jv, _capture_grads())
    new_jstate, jmetrics = jax.jit(jstep)(jstate, images, labels,
                                          jax.random.PRNGKey(0))
    ref = {"params": new_jstate.opt_state}
    if use_batchnorm:
        ref["batch_stats"] = new_jstate.batch_stats
    ref_sd = checkpoint.vgg16_from_jax(jax.device_get(ref))

    opt = _CaptureGrads(tm.parameters())
    state = common.TrainState(
        tm, opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda c: 1.0))
    metrics = common.make_judge_train_step(smoothing)(state, _t(images),
                                                      _t(labels))
    assert state.step == 1 and set(metrics) == {"loss", "accuracy"}
    for k in metrics:
        assert abs(metrics[k].item() - float(jmetrics[k])) <= 1e-5, k
    for p, g in zip(tm.parameters(), opt.grads):
        p.grad = g
    _assert_grads_match(tm, ref_sd, 1e-4)
    if use_batchnorm:
        n_stats = 0
        for name, buf in tm.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                r = ref_sd[name]
                assert (buf - r).abs().max().item() <= 1e-5 * max(
                    1.0, r.abs().max().item()), name
                n_stats += 1
        assert n_stats == 4


@pytest.mark.parametrize("use_batchnorm", [False, True], ids=["plain", "bn"])
def test_judge_eval_step_matches_jax(use_batchnorm):
    """make_judge_eval_step vs tsr_tpu's: the same correct count, logits
    within 1e-5, in eval mode (running statistics), and the judge's mode
    restored after."""
    jm, jv, tm = _judges(use_batchnorm, dropout_rate=0.5, seed=4)
    images, labels = _data(5, 9)
    jstate = jcommon.TrainState.create(jm.apply, jv, _capture_grads())
    jcount, jlogits = jcommon.make_judge_eval_step()(jstate, images, labels)
    state = common.create_judge_state(tm.train(), configs.JudgeTrainConfig())
    count, logits = common.make_judge_eval_step()(state, _t(images),
                                                  _t(labels))
    assert tm.training
    assert count.item() == int(jcount)
    assert np.abs(logits.numpy() - np.asarray(jlogits)).max() <= 1e-5


# ------------------------------------------------------------------ loops

def _log_numbers(lines, key):
    """The first value after ``key`` (at the start of a word) in each log
    line that has one, in order."""
    return [float(m.group(1)) for ln in lines
            for m in [re.search(rf"(?:^|\s){key} ([-\d.]+)", ln)] if m]


@pytest.mark.parametrize("use_batchnorm", [False, True], ids=["plain", "bn"])
def test_train_judge_on_device_matches_jax(use_batchnorm):
    """Two epochs of train_judge_on_device vs tsr_tpu's, SGD 0.05 with
    momentum, dropout off, with ``len(tr_idx) == batch_size``: each
    epoch's one batch is the whole train set whatever the permutation, so
    the logged losses, train and val accuracies (4 decimals) are within
    1e-4, best_acc too, and the final weights within 1e-4 of the largest
    of their tensor; the log lines have the reference's form."""
    jm, jv, tm = _judges(use_batchnorm, seed=6)
    images, labels = _data(7, 13)
    tr_idx, va_idx = np.arange(3, 11), np.array([0, 1, 2, 11, 12])
    kw = dict(batch_size=8, epochs=2, learning_rate=0.05)
    jcfg, cfg = jconfigs.JudgeTrainConfig(**kw), configs.JudgeTrainConfig(
        **kw)
    jlines, lines = [], []
    jstate = jcommon.TrainState.create(jm.apply, jv,
                                       jcommon.judge_optimizer(jcfg))
    jstate, jbest = jloops.train_judge_on_device(
        jstate, images, labels, tr_idx, va_idx, jcfg, log=jlines.append)
    state = common.create_judge_state(tm, cfg)
    state, best = loops.train_judge_on_device(
        state, images, labels, tr_idx, va_idx, cfg, log=lines.append,
        device="cpu")
    assert state.step == 2 and len(lines) == len(jlines) == 4
    for a, b in zip(lines, jlines):
        assert re.sub(r"[-\d.]+", "#", a) == re.sub(r"[-\d.]+", "#", b)
    for key in ("train loss", "acc", "val acc"):
        got, ref = _log_numbers(lines, key), _log_numbers(jlines, key)
        assert len(got) == len(ref) == 2 * (1 + (key == "acc"))
        assert np.abs(np.subtract(got, ref)).max() <= 1e-4 + 1e-9, key
    assert abs(best - jbest) <= 1e-4
    ref_sd = checkpoint.vgg16_from_jax(jax.device_get(jstate.variables))
    for name, v in tm.state_dict().items():
        r = ref_sd[name]
        assert (v - r).abs().max().item() <= 1e-4 * max(
            r.abs().max().item(), 1e-3), name


def test_train_judge_on_device_keeps_the_latest_tie_once(tmp_path,
                                                         monkeypatch):
    """At learning rate 0 every epoch's val accuracy ties: with ``>=`` the
    latest state is the best, snapshotted each epoch and written once at
    the end (step 3 of 3, script 05's config); without ``save_path``
    nothing is written and the best accuracy is still returned. A train
    set smaller than a batch raises."""
    _, _, tm = _judges(seed=8)
    images, labels = _data(9, 12)
    cfg = configs.JudgeTrainConfig(batch_size=4, epochs=3,
                                   learning_rate=0.0)
    writes = []
    save = zoo.save_checkpoint
    monkeypatch.setattr(zoo, "save_checkpoint",
                        lambda *a, **k: writes.append(a[0]) or save(*a, **k))
    lines = []
    state, best = loops.train_judge_on_device(
        common.create_judge_state(tm, cfg), images, labels, np.arange(8),
        np.arange(8, 12), cfg, save_path=str(tmp_path / "judge"),
        log=lines.append, ckpt_config=_ckpt_config(False), device="cpu")
    vals = _log_numbers(lines, "val acc")
    assert len(set(vals)) == 1 and best == vals[0]
    assert sum("new best" in ln for ln in lines) == 3
    assert writes == [str(tmp_path / "judge")]
    assert lines[-1] == f"saved best checkpoint (val acc {best:.4f})"
    assert torch.load(tmp_path / "judge" / "train",
                      weights_only=True)["step"] == state.step == 6
    assert json.loads((tmp_path / "judge" / "config.json").read_text()) == \
        _ckpt_config(False)
    loaded = zoo.load_model("vgg16", str(tmp_path / "judge"), size=SIZE,
                            device="cpu")
    for n, v in tm.state_dict().items():
        assert torch.equal(loaded.state_dict()[n], v), n

    _, best2 = loops.train_judge_on_device(
        common.create_judge_state(tm, cfg), images, labels, np.arange(8),
        np.arange(8, 12), cfg, log=lambda ln: None, device="cpu")
    assert best2 == best and len(writes) == 1
    with pytest.raises(ValueError, match="fewer than one batch"):
        loops.train_judge_on_device(
            common.create_judge_state(tm, cfg), images, labels,
            np.arange(3), np.arange(8, 12), cfg, device="cpu")


class _Folder:
    """An in-memory stand-in for ImageFolder: ``load_batch(indices)``."""

    def __init__(self, images, labels):
        self.images, self.labels = images, labels

    def __len__(self):
        return len(self.labels)

    def load_batch(self, indices):
        idx = np.asarray(indices)
        return self.images[idx], self.labels[idx]


def _streams(folder, tr_idx, va_idx, bs, shuffle=True, seed=0):
    """Script 05's batch makers over ``data.gtsrb.batches``."""
    return (lambda ep: gtsrb.batches(folder, tr_idx, bs, shuffle=shuffle,
                                     seed=seed + ep),
            lambda: gtsrb.batches(folder, va_idx, bs, shuffle=False,
                                  drop_remainder=False))


def test_train_judge_matches_jax_and_saves_only_when_better(tmp_path):
    """train_judge (host-streamed, ``data.gtsrb.batches`` in a fixed order,
    dropout off, SGD 0.05) vs tsr_tpu's over 2 epochs of 2 steps: the
    logged losses and accuracies within 1e-4; without ``save_path`` both
    return 0.0. Then at learning rate 0, on val labels that are the
    judge's own predictions (val accuracy 1.0 every epoch), the state is
    saved only at the first epoch (``>``), step 2 of 6."""
    jm, jv, tm = _judges(seed=10)
    images, labels = _data(11, 14)
    tr_idx, va_idx = np.arange(8), np.arange(8, 14)
    kw = dict(batch_size=4, epochs=2, learning_rate=0.05)
    jcfg, cfg = jconfigs.JudgeTrainConfig(**kw), configs.JudgeTrainConfig(
        **kw)
    train_b, val_b = _streams(_Folder(images, labels), tr_idx, va_idx, 4,
                              shuffle=False)
    jlines, lines = [], []
    _, jbest = jloops.train_judge(
        jcommon.TrainState.create(jm.apply, jv, jcommon.judge_optimizer(
            jcfg)), train_b, val_b, jcfg, log=jlines.append)
    state, best = loops.train_judge(common.create_judge_state(tm, cfg),
                                    train_b, val_b, cfg, log=lines.append,
                                    device="cpu")
    assert jbest == best == 0.0 and state.step == 4
    for a, b in zip(lines, jlines):
        assert re.sub(r"[-\d.]+", "#", a) == re.sub(r"[-\d.]+", "#", b)
    for key in ("train loss", "acc"):
        got, ref = _log_numbers(lines, key), _log_numbers(jlines, key)
        assert len(got) == len(ref) and got
        assert np.abs(np.subtract(got, ref)).max() <= 1e-4 + 1e-9, key

    tm.eval()
    with torch.no_grad():
        own = tm(common.judge_input(_t(images))).argmax(-1).numpy()
    labels = np.where(np.isin(np.arange(14), va_idx), own, labels)
    cfg = configs.JudgeTrainConfig(batch_size=4, epochs=3, learning_rate=0.0)
    train_b, val_b = _streams(_Folder(images, labels.astype(np.int32)),
                              tr_idx, va_idx, 4)
    lines = []
    state, best = loops.train_judge(
        common.create_judge_state(tm, cfg), train_b, val_b, cfg,
        save_path=str(tmp_path / "judge"), log=lines.append,
        ckpt_config=_ckpt_config(False), device="cpu")
    assert best == 1.0 and _log_numbers(lines, "val acc") == [1.0] * 3
    assert sum("saved best" in ln for ln in lines) == 1
    assert state.step == 6
    assert torch.load(tmp_path / "judge" / "train",
                      weights_only=True)["step"] == 2


def test_train_judge_is_seeded_and_reproducible():
    """With dropout on, train_judge from one init and ``cfg.seed`` gives
    the same weights twice and other weights under another seed, and
    leaves the caller's torch generator as it was."""
    images, labels = _data(12, 12)
    folder = _Folder(images, labels)

    def run(seed):
        torch.manual_seed(3)
        tm = VGG16(num_classes=NCLS, cfg=CFG, fc_width=FC, input_size=SIZE)
        cfg = configs.JudgeTrainConfig(batch_size=4, epochs=2,
                                       learning_rate=0.05, seed=seed)
        train_b, val_b = _streams(folder, np.arange(8), np.arange(8, 12), 4,
                                  seed=seed)
        before = torch.get_rng_state()
        state, _ = loops.train_judge(common.create_judge_state(tm, cfg),
                                     train_b, val_b, cfg,
                                     log=lambda ln: None, device="cpu")
        assert torch.equal(torch.get_rng_state(), before)
        return state.model.state_dict()

    a, b, c = run(0), run(0), run(1)
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not all(torch.equal(a[n], c[n]) for n in a)
