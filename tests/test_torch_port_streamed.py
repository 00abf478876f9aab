"""The port's host-streamed restorer and unified trainers, and the unified
trainer's checkpoints, against the JAX package's loops on the CPU:
``train_restorer`` (scripts 07 / 07adv ``--host-stream``), ``train_unified``
(script 14 ``--host-stream``) and ``train_unified_on_device(save_path=)``.

Per-step losses are held against the reference loops on shared weights
(SimpleUNet (8, 16); ResUNet (8, 16, 24) / 32 with its mix at scales 16 and
24 on 32x32 images, the reference's own training pairs injected into the
port's mix). The checkpoint schedules are held against the reference loops
with stub steps and scripted validation losses, every write recorded on
both sides; resume goes through ``zoo.load_train_state``.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import core

from tsr_tpu import configs as jconfigs
from tsr_tpu.models import ResUNet as JResUNet
from tsr_tpu.models import SimpleUNet as JSimpleUNet
from tsr_tpu.ops import distortions as jdist
from tsr_tpu.train import common as jcommon
from tsr_tpu.train import loops as jloops
from tsr_tpu_torch import checkpoint, configs, zoo
from tsr_tpu_torch.models import ResUNet, SimpleUNet
from tsr_tpu_torch.ops import distortions as tdist
from tsr_tpu_torch.train import common, loops

torch.set_num_threads(2)
SIZE = 32
SCALES = (16, 24)


def _t(x):
    return torch.from_numpy(np.array(x))


def _pairs(seed, n):
    rng = np.random.default_rng(seed)
    clean = rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)
    bad = np.clip(clean.astype(int) + rng.integers(-40, 41, clean.shape),
                  0, 255).astype(np.uint8)
    return bad, clean


def _shape(lines):
    """Log lines with every number replaced, to compare their form."""
    return [re.sub(r"[-\d.]+(e[-+]\d+)?", "#", ln) for ln in lines]


def _jit_init(jm, **kw):
    init = jax.jit(lambda key: jm.init(key, jnp.zeros((1, SIZE, SIZE, 3)),
                                       **kw))
    return jax.tree.map(np.array, init(jax.random.PRNGKey(0)))


# ------------------------------------------------------- per-step losses

@pytest.mark.parametrize("batch_to_float", [False, True],
                         ids=["uint8", "batch_to_float"])
def test_train_restorer_matches_jax(batch_to_float):
    """train_restorer (MSE, Adam 1e-3) vs tsr_tpu's over 2 epochs of 2
    steps in a fixed order, on uint8 batches converted on the device or
    (batch_to_float) on the host: every step's loss within 2e-5 relative
    (float32 sums in another order, compounded by Adam over 4 updates),
    each epoch's validation loss within 2e-5 relative, the log lines of
    the reference's form, and the final weights within 1e-4 of each
    tensor's largest."""
    jm = JSimpleUNet(widths=(8, 16))
    jv = _jit_init(jm)
    tm = SimpleUNet((8, 16))
    tm.load_state_dict(checkpoint.simple_unet_from_jax(jv))
    bad, clean = _pairs(1, 11)
    train = [(bad[i:i + 4], clean[i:i + 4]) for i in (0, 4)]
    val = [(bad[8:], clean[8:])]
    jcfg = jconfigs.RestorationTrainConfig()
    jstep = jcommon.make_restoration_train_step("mse")
    jlosses = []

    def jstep_rec(st, b, c):
        st, aux = jstep(st, b, c)
        jlosses.append(float(aux["loss"]))
        return st, aux

    jlines, lines = [], []
    jstate = jloops.train_restorer(
        jcommon.TrainState.create(jm.apply, jv,
                                  jcommon.restoration_optimizer(jcfg)),
        lambda ep: train, lambda: val, 2, jstep_rec,
        jcommon.make_restoration_eval_step("mse"), log=jlines.append,
        batch_to_float=batch_to_float)
    state, history = loops.train_restorer(
        common.create_restoration_state(tm, configs.RestorationTrainConfig()),
        lambda ep: train, lambda: val, 2,
        common.make_restoration_train_step("mse"),
        common.make_restoration_eval_step("mse"), log=lines.append,
        batch_to_float=batch_to_float, device="cpu")
    got = [v for rec in history for v in rec["step_loss"]]
    assert state.step == 4 and len(got) == len(jlosses) == 4
    assert np.allclose(got, jlosses, rtol=2e-5, atol=0)
    jval = [float(m.group(1)) for ln in jlines
            for m in [re.search(r"val loss (\S+)", ln)] if m]
    assert np.allclose([r["val_loss"] for r in history], jval, rtol=2e-5)
    assert _shape(lines) == _shape(jlines) and len(lines) == 4
    ref_sd = checkpoint.simple_unet_from_jax(jax.device_get(
        {"params": jstate.params}))
    for name, v in tm.state_dict().items():
        r = ref_sd[name]
        assert (v - r).abs().max().item() <= 1e-4 * r.abs().max().item(), \
            name


def _reference_keys(seed):
    """The keys tsr_tpu's train_unified hands to its mix, in order: one
    split of one running key per train or validation batch."""
    rng = jax.random.PRNGKey(seed)
    while True:
        rng, k = jax.random.split(rng)
        yield k


def test_train_unified_matches_jax(monkeypatch):
    """train_unified (L1, AdamW with its cosine schedule, no perceptual
    net) vs tsr_tpu's over 2 epochs of 2 steps and one validation batch an
    epoch. The port's mix is replaced by the reference's own training pair
    for the key the reference loop uses at that batch (the two generators
    differ by design; the mix itself is held in test_torch_port_train), so
    both train on the same pairs: every step's loss within 2e-5 relative
    (batch statistics and AdamW over 4 updates in float32) and the log
    lines of the reference's form. The states then part more than the
    losses: each of Adam's first updates moves a parameter by about the
    learning rate whatever its gradient's size, so where a gradient is
    float32 noise (the biases that feed a batch norm have an exact
    gradient of 0) the two sides may step opposite ways. So every
    parameter is held within 2 x 4 x 2e-4 (two sides, 4 updates at the
    peak rate; measured 8.8e-4), the running statistics within 1e-3 of
    max(1, their largest) (measured 5.1e-4) and the validation losses,
    which run on those statistics in eval mode, within 2e-3 relative
    (measured 6.2e-4).
    """
    jm = JResUNet(widths=(8, 16, 24), bottleneck_width=32)
    jv = _jit_init(jm, train=True)
    tm = ResUNet((8, 16, 24), 32)
    tm.load_state_dict(checkpoint.resunet_from_jax(jv))
    kw = dict(batch_size=4, epochs=2, seed=5, cosine_t_max=2)
    jcfg = jconfigs.UnifiedTrainConfig(
        **kw, mix=jconfigs.RandomMixConfig(apply_scales=SCALES))
    cfg = configs.UnifiedTrainConfig(
        **kw, mix=configs.RandomMixConfig(apply_scales=SCALES))
    clean = np.random.default_rng(2).integers(0, 256, (11, SIZE, SIZE, 3),
                                              dtype=np.uint8)
    train = [(clean[:4],), (clean[4:8],)]
    val = [(clean[8:],)]
    jpair = jax.jit(jdist.make_training_pair, static_argnums=2)
    keys = enumerate(_reference_keys(cfg.seed))

    def reference_pair(clean_u8, generator, mix_cfg, device):
        # as the reference makes it: inside its jitted step for each of an
        # epoch's 2 train batches, eagerly for its validation batch
        i, key = next(keys)
        make = jpair if i % 3 < 2 else jdist.make_training_pair
        bad01, clean01 = make(clean_u8.numpy(), key, jcfg.mix)
        return _t(bad01), _t(clean01)

    monkeypatch.setattr(tdist, "make_training_pair", reference_pair)
    jstep = jcommon.make_unified_train_step(jcfg.mix, jcfg.perceptual_weight)
    jlosses = []

    def jstep_rec(st, c, k):
        st, aux = jstep(st, c, k)
        jlosses.append(float(aux["loss"]))
        return st, aux

    monkeypatch.setattr(jcommon, "make_unified_train_step",
                        lambda *a, **k: jstep_rec)
    jlines, lines = [], []
    jstate = jloops.train_unified(
        jcommon.TrainState.create(jm.apply, jv,
                                  jcommon.unified_optimizer(jcfg, 2)),
        lambda ep: train, lambda: val, jcfg, log=jlines.append)
    state, history = loops.train_unified(
        common.create_unified_state(tm, cfg, 2), lambda ep: train,
        lambda: val, cfg, log=lines.append, device="cpu")
    got = [v for rec in history for v in rec["step_loss"]]
    assert state.step == 4 and len(got) == len(jlosses) == 4
    assert np.allclose(got, jlosses, rtol=2e-5, atol=0)
    jval = [float(m.group(1)) for ln in jlines
            for m in [re.search(r"val loss (\S+)", ln)] if m]
    assert np.allclose([r["val_loss"] for r in history], jval, rtol=2e-3)
    assert _shape(lines) == _shape(jlines) and len(lines) == 4
    ref_sd = checkpoint.resunet_from_jax(jax.device_get(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    for name, v in tm.named_parameters():
        assert (v - ref_sd[name]).abs().max().item() <= 2 * 4 * 2e-4, name
    for name, v in tm.named_buffers():
        if "running" in name:
            r = ref_sd[name]
            assert (v - r).abs().max().item() <= 1e-3 * max(
                r.abs().max().item(), 1.0), name


# --------------------------------------------------- checkpoint schedules

def _port_stub_state():
    """A real TrainState on a 1x1 convolution (so a checkpoint has a model,
    an optimizer and a step), for stub steps that only count."""
    model = torch.nn.Conv2d(3, 3, 1)
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    return common.TrainState(
        model, opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda c: 1.0))


def _port_writes(monkeypatch):
    """Record the step count of every state the port writes."""
    writes = []
    monkeypatch.setattr(zoo, "save_checkpoint", lambda path, st, cfg=None:
                        writes.append(st["step"] if isinstance(st, dict)
                                      else st.step))
    return writes


def _reference_writes(monkeypatch):
    writes = []
    monkeypatch.setattr(jloops, "_save_ckpt", lambda path, st, cfg=None:
                        writes.append(int(st["step"] if isinstance(st, dict)
                                          else st.step)))
    return writes


VAL_LOSSES = (3.0, 1.0, 2.0)


@pytest.mark.parametrize("save_best", [False, True],
                         ids=["no-best", "save-best"])
@pytest.mark.parametrize("checkpoint_every", [0, 2],
                         ids=["no-periodic", "every-2"])
def test_train_restorer_saves_on_the_reference_schedule(
        monkeypatch, save_best, checkpoint_every):
    """train_restorer and tsr_tpu's train_restorer with stub steps (one
    step an epoch, counting) and validation losses 3, 1, 2 over 3 epochs:
    the same writes of the same steps in the same order, and the same log
    lines, for each of save_best x checkpoint_every. (Without save_best
    the final state is written; with both, the best copy is written last;
    with save_best alone, nothing after the epochs.)"""
    vals = iter(VAL_LOSSES * 2)
    jwrites, writes = _reference_writes(monkeypatch), _port_writes(
        monkeypatch)
    batch = (np.zeros((1, 4, 4, 3), np.uint8),) * 2
    jlines, lines = [], []
    jloops.train_restorer(
        {"step": jnp.int32(0)}, lambda ep: [batch], lambda: [batch], 3,
        lambda st, b, c: ({"step": st["step"] + 1}, {"loss": 0.0}),
        lambda st, b, c: {"loss": next(vals)}, save_path="ckpt",
        checkpoint_every=checkpoint_every, save_best=save_best,
        log=jlines.append)
    vals = iter(VAL_LOSSES)

    def step(st, b, c):
        st.step += 1
        return {"loss": torch.tensor(0.0), "pixel_loss": torch.tensor(0.0)}

    state, history = loops.train_restorer(
        _port_stub_state(), lambda ep: [batch], lambda: [batch], 3, step,
        lambda st, b, c: {"loss": torch.tensor(next(vals))},
        save_path="ckpt", checkpoint_every=checkpoint_every,
        save_best=save_best, log=lines.append, device="cpu")
    assert writes == jwrites and writes
    assert _shape(lines) == _shape(jlines)
    assert [r["val_loss"] for r in history] == list(VAL_LOSSES)
    expected = {(False, 0): [3], (False, 2): [2, 3], (True, 0): [1, 2],
                (True, 2): [1, 2, 2, 2]}[(save_best, checkpoint_every)]
    assert writes == expected


def test_train_unified_saves_at_each_better_epoch(monkeypatch):
    """train_unified and tsr_tpu's train_unified with stub steps, stub
    evaluation and validation losses 3, 1, 2, 0.5 over 4 epochs: both
    write the live state at epochs 1, 2 and 4 (each better validation
    loss, no final write) and log the same lines; without save_path
    neither writes."""
    scripted = (3.0, 1.0, 2.0, 0.5)
    jwrites, writes = _reference_writes(monkeypatch), _port_writes(
        monkeypatch)
    clean = (np.zeros((2, 8, 8, 3), np.uint8),)
    jvals = iter(scripted)
    monkeypatch.setattr(jdist, "make_training_pair",
                        lambda c, k, cfg: (c, c))
    monkeypatch.setattr(
        jcommon, "make_unified_train_step", lambda *a, **k:
        lambda st, c, key: ({"step": st["step"] + 1}, {"loss": 0.0}))
    monkeypatch.setattr(jcommon, "make_restoration_eval_step",
                        lambda **k: lambda st, b, c: {"loss": next(jvals)})
    jcfg = jconfigs.UnifiedTrainConfig(epochs=4)
    jlines, lines = [], []
    jloops.train_unified({"step": jnp.int32(0)}, lambda ep: [clean],
                         lambda: [clean], jcfg, save_path="ckpt",
                         log=jlines.append)
    vals = iter(scripted * 2)

    def step(st, c, generator):
        st.step += 1
        return {"loss": torch.tensor(0.0), "pixel_loss": torch.tensor(0.0)}

    monkeypatch.setattr(tdist, "make_training_pair",
                        lambda c, g, cfg, device: (c, c))
    monkeypatch.setattr(common, "make_unified_train_step",
                        lambda *a, **k: step)
    monkeypatch.setattr(common, "make_restoration_eval_step",
                        lambda **k: lambda st, b, c: {
                            "loss": torch.tensor(next(vals))})
    cfg = configs.UnifiedTrainConfig(epochs=4)
    loops.train_unified(_port_stub_state(), lambda ep: [clean],
                        lambda: [clean], cfg, save_path="ckpt",
                        log=lines.append, device="cpu")
    assert writes == jwrites == [1, 2, 4]
    assert _shape(lines) == _shape(jlines)
    loops.train_unified(_port_stub_state(), lambda ep: [clean],
                        lambda: [clean], cfg, log=lambda ln: None,
                        device="cpu")
    assert writes == [1, 2, 4]


def test_train_unified_on_device_saves_the_best_once(monkeypatch):
    """train_unified_on_device and tsr_tpu's with stub steps (2 an epoch,
    counting) and validation losses 3, 1, 2 scripted through the
    per-sample loss: both snapshot at each better epoch ("new best") and
    write once at the end the state of epoch 2 (step 4), and log the same
    lines; without save_path neither writes."""
    table = jnp.asarray(VAL_LOSSES)
    jwrites, writes = _reference_writes(monkeypatch), _port_writes(
        monkeypatch)

    def jstep(st, cb, k):
        return st.replace(step=st.step + 1, params=core.freeze(
            {"c": st.params["c"] + 1.0})), {"loss": jnp.float32(0.0)}

    monkeypatch.setattr(jcommon, "make_unified_train_step",
                        lambda *a, **k: jstep)
    monkeypatch.setattr(jloops, "_per_sample_restoration_loss",
                        lambda pred, clean, *a: pred.mean(axis=(1, 2, 3)))

    def japply(variables, x, train=False):
        epoch = (variables["params"]["c"] / 2).astype(jnp.int32) - 1
        return jnp.zeros_like(x) + table[epoch]

    kw = dict(batch_size=2, epochs=3,
              mix=jconfigs.RandomMixConfig(apply_scales=()))
    clean = np.random.default_rng(0).integers(0, 256, (7, 8, 8, 3),
                                              dtype=np.uint8)
    jlines, lines = [], []
    jloops.train_unified_on_device(
        jcommon.TrainState.create(japply, {"params": {"c": jnp.float32(0)}},
                                  optax.sgd(0.0)),
        clean, np.arange(4), np.arange(4, 7), jconfigs.UnifiedTrainConfig(
            **kw), save_path="ckpt", log=jlines.append)

    state = _port_stub_state()

    def step(st, cb, generator):
        st.step += 1
        return {"loss": torch.tensor(0.0), "pixel_loss": torch.tensor(0.0)}

    monkeypatch.setattr(common, "make_unified_train_step",
                        lambda *a, **k: step)
    monkeypatch.setattr(loops, "_per_sample_restoration_loss",
                        lambda pred, *a: torch.full(
                            (len(pred),), VAL_LOSSES[state.step // 2 - 1]))
    cfg = configs.UnifiedTrainConfig(
        **dict(kw, mix=configs.RandomMixConfig(apply_scales=())))
    _, history = loops.train_unified_on_device(
        state, clean, np.arange(4), np.arange(4, 7), cfg, save_path="ckpt",
        log=lines.append, device="cpu")
    assert [r["val_loss"] for r in history] == list(VAL_LOSSES)
    assert writes == jwrites == [4]
    # the port's epoch line says its rate covers the train steps only
    assert _shape(ln.replace(", train steps only", "") for ln in lines) \
        == _shape(jlines)
    assert sum("new best" in ln for ln in lines) == 2
    assert lines[-1] == "saved best checkpoint (val loss 1.00000)"
    state = _port_stub_state()
    loops.train_unified_on_device(state, clean, np.arange(4),
                                  np.arange(4, 7), cfg, log=lambda ln: None,
                                  device="cpu")
    assert writes == [4]


# ----------------------------------------------------------------- resume

def _unified(epochs, save_path=None, state=None, **kw):
    """train_unified_on_device on a small ResUNet (8 training images at
    batch 4, 3 validation images), L1 only."""
    cfg = configs.UnifiedTrainConfig(
        batch_size=4, epochs=epochs, seed=3,
        mix=configs.RandomMixConfig(apply_scales=SCALES))
    if state is None:
        torch.manual_seed(0)
        state = common.create_unified_state(ResUNet((8, 16, 24), 32), cfg, 2)
    clean = np.random.default_rng(4).integers(0, 256, (11, SIZE, SIZE, 3),
                                              dtype=np.uint8)
    return loops.train_unified_on_device(
        state, clean, np.arange(8), np.arange(8, 11), cfg,
        save_path=save_path, log=lambda ln: None, device="cpu", **kw)


def test_unified_checkpoint_holds_the_best_epoch_and_resumes(tmp_path):
    """A 3-epoch train_unified_on_device run with save_path writes the
    state of its lowest-validation epoch once, with the caller's config; a
    run stopped at that epoch reproduces the written weights exactly (the
    trainer is seeded); zoo.load_train_state restores weights, AdamW's
    moments, the schedule and the step count, from which training
    continues the count."""
    ckpt = tmp_path / "unified"
    _, history = _unified(3, str(ckpt), ckpt_config={"kind": "resunet"})
    best = 1 + int(np.argmin([r["val_loss"] for r in history]))
    assert (ckpt / "config.json").read_text().count("resunet") == 1
    saved = torch.load(ckpt / "train", weights_only=True)
    assert saved["step"] == 2 * best
    ref, _ = _unified(best)
    model_file = torch.load(ckpt / "model", weights_only=True)
    for n, v in ref.model.state_dict().items():
        assert torch.equal(model_file[n], v), n
    torch.manual_seed(1)
    fresh = common.create_unified_state(
        ResUNet((8, 16, 24), 32), configs.UnifiedTrainConfig(), 2)
    resumed = zoo.load_train_state(str(ckpt), fresh)
    assert resumed.step == 2 * best
    assert resumed.schedule.last_epoch == ref.schedule.last_epoch
    for a, b in zip(ref.optimizer.state.values(),
                    resumed.optimizer.state.values()):
        assert torch.equal(a["exp_avg"], b["exp_avg"])
    on, _ = _unified(1, state=resumed)
    assert on.step == 2 * best + 2
