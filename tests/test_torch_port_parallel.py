"""The port's multi-device layer (``tsr_tpu_torch.parallel``) on the CPU,
over gloo, against ``tsr_tpu`` and against the port's own one-process
runs.

The mesh programs run on ranks that this file starts through the port's
launcher (``parallel.launch.spawn``; each rank a fresh interpreter that
imports only the port, one CPU thread each): one launch of four ranks runs
every program of ``parallel.checks`` in turn, each on its own mesh, and
the tests read its results. The JAX references are computed here, in
process. Small widths: ResUNet (8, 16, 32) / 64 and the VGG of the train
slice's tests at 32 px; a judge of ``cfg=(8, "M", 16, "M")`` at 16 px.
"""

import math
import operator

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_train import (BOTTLENECK, HI, SCALES, VGG_CFG, WIDTHS,
                                   _capture_grads, _randomize,
                                   _reference_group_draws)
from tsr_tpu import configs as jconfigs
from tsr_tpu.models import ResUNet as JResUNet
from tsr_tpu.models import VGG16 as JVGG16
from tsr_tpu.models import vgg as jvgg
from tsr_tpu.ops import distortions as jdist
from tsr_tpu.parallel import distributed as jdistributed
from tsr_tpu.parallel import mesh as jmesh
from tsr_tpu.train import common as jcommon
from tsr_tpu_torch import checkpoint, configs, zoo
from tsr_tpu_torch import eval as teval
from tsr_tpu_torch.data import synthetic
from tsr_tpu_torch.kernels import distort as kdistort
from tsr_tpu_torch.models import ResUNet, SimpleUNet, VGG16
from tsr_tpu_torch.models.layers import batchnorm_fed_biases
from tsr_tpu_torch.ops import distortions as tdist
from tsr_tpu_torch.parallel import checks, distributed, launch
from tsr_tpu_torch.parallel import mesh as pmesh
from tsr_tpu_torch.train import common, loops

torch.set_num_threads(2)
JUDGE = dict(num_classes=8, cfg=(8, "M", 16, "M"), fc_width=128,
             input_size=16)
LOOP_JUDGE = dict(num_classes=4, cfg=(8, "M", 16, "M"), fc_width=64,
                  input_size=16)
UNET = dict(widths=(4, 8))
LOOP_MIX = configs.RandomMixConfig(apply_scales=(16, 24, 16, 24))


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------ specs, helpers

@pytest.mark.parametrize("spec", [None, "", "8", "data=4,model=2", "data=2",
                                  "model=2", "data=-1,model=2",
                                  " data=3 , model=1", "1"])
def test_parse_mesh_spec_matches_reference(spec):
    assert pmesh.parse_mesh_spec(spec) == jmesh.parse_mesh_spec(spec)


@pytest.mark.parametrize("spec", ["rows=3", "data=x", "data",
                                  "data=4,model=2,seq=2", "data=2;model=2"])
def test_parse_mesh_spec_refuses_as_reference(spec):
    with pytest.raises(ValueError) as ref:
        jmesh.parse_mesh_spec(spec)
    with pytest.raises(ValueError) as got:
        pmesh.parse_mesh_spec(spec)
    assert str(got.value) == str(ref.value)


def test_distributed_helpers_single_process(monkeypatch):
    """In one process (no torchrun variables) initialize is a no-op and
    process_shard the identity, as the reference's helpers; the config
    carries the reference's fields and defaults."""
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize(device="cpu") is None
    assert not torch.distributed.is_initialized()
    for idx in (np.arange(10), np.arange(3, 17)):
        assert np.array_equal(distributed.process_shard(idx),
                              jdistributed.process_shard(idx))
    assert (distributed.process_count(), distributed.process_index()) == (1,
                                                                          0)
    assert configs.MeshConfig() .__dict__ == jconfigs.MeshConfig().__dict__
    with pytest.raises(RuntimeError, match="initialized process group"):
        pmesh.make_mesh(2, 1)


def test_no_device_is_taken_by_default(monkeypatch):
    """Without a recorded device the rank's device is an error, not the
    CPU; ``initialize`` on a group that a caller already made records the
    device it is asked for; ``launch.spawn`` has no default device."""
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK",
              "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    distributed.shutdown()
    with pytest.raises(RuntimeError, match="no device recorded"):
        distributed.rank_device()
    with pytest.raises(TypeError, match="device"):
        launch.spawn(operator.truediv, 1, (1, 1))
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{launch.free_port()}",
        world_size=1, rank=0)
    try:
        assert distributed.initialize(device="cpu") == "gloo"
        assert distributed.rank_device() == torch.device("cpu")
        mesh = pmesh.make_mesh(1, 1)
        assert mesh.device == torch.device("cpu") and mesh.backend == "gloo"
    finally:
        distributed.shutdown()
    with pytest.raises(RuntimeError, match="no device recorded"):
        distributed.rank_device()


def test_shard_batch_or_replicate_rows():
    """Rows of the data index of an even batch; the whole uneven tail."""

    class M:
        data, data_rank = 4, 2

    x = np.arange(16 * 3).reshape(16, 3)
    rows, split = pmesh.shard_batch_or_replicate((x, x[:, 0]), M)
    assert split and np.array_equal(rows[0], x[8:12])
    assert np.array_equal(rows[1], x[8:12, 0])
    tail, split = pmesh.shard_batch_or_replicate((x[:13],), M)
    assert not split and tail[0] is not None and len(tail[0]) == 13


# --------------------------------------------- the mix on a rank's rows

@pytest.mark.parametrize("batch,data,scales", [
    (16, 2, (16, 24, 16, 24)), (16, 8, (16, 24, 16, 24)), (12, 3, SCALES),
    (10, 5, (16, 20, 24, 28))],
    ids=["whole-groups", "half-groups", "cut-groups", "remainder"])
def test_mix_on_rank_rows_equals_rows_of_the_batch(batch, data, scales):
    """random_mix_multiscale_from_draws on a rank's rows (``row0``) with the
    reference's draws and injected noise is uint8-equal to those rows of
    the unsharded mix, also where a rank's rows cut a scale group in two;
    and make_training_pair with ``rows`` (B1's noise drawn from its seed,
    the group's field sliced) equals the rows of the whole pair."""
    cfg = jconfigs.RandomMixConfig(apply_scales=scales)
    img = _t(np.random.default_rng(batch).integers(
        0, 256, (batch, 32, 32, 3), dtype=np.uint8))
    draws, noise = _reference_group_draws(jax.random.PRNGKey(batch), batch,
                                          cfg)
    whole = tdist.random_mix_multiscale_from_draws(img, draws, scales, noise)
    pcfg = configs.RandomMixConfig(apply_scales=scales)
    whole_pair = tdist.make_training_pair(
        img, torch.Generator().manual_seed(9), pcfg, device="cpu")[0]
    n = batch // data
    for r in range(data):
        rows = slice(r * n, (r + 1) * n)
        got = tdist.random_mix_multiscale_from_draws(img[rows], draws, scales,
                                                     noise, row0=r * n)
        assert torch.equal(got, whole[rows]), r
        pair = tdist.make_training_pair(
            img[rows], torch.Generator().manual_seed(9), pcfg, device="cpu",
            rows=(r * n, batch))[0]
        assert torch.equal(pair, whole_pair[rows]), r


def test_b1_split_calls_equal_the_whole_call_on_cpu():
    """B1's plain version with ``row0``: calls on rows 0:16, 16:40 and
    40:64 of a group of 64 give that group's output rows, f and pre_blur
    alike; a ``noise`` field too short for the rows is refused."""
    g = torch.Generator().manual_seed(3)
    clean = torch.randint(0, 256, (64, 8, 8, 3), dtype=torch.uint8,
                          generator=g)
    gates = (torch.rand(64, generator=g) < 0.5).to(torch.int32)
    t = torch.rand(64, generator=g)
    sigma = torch.rand(64, generator=g) * 0.2
    args = (gates, t, 1 - gates, sigma)
    f, pre = kdistort.fused_fog_noise(clean, 11, *args)
    for a, b in ((0, 16), (16, 40), (40, 64)):
        fs, ps = kdistort.fused_fog_noise(
            clean[a:b], 11, *(v[a:b] for v in args), row0=a, group_rows=64)
        assert torch.equal(fs, f[a:b]) and torch.equal(ps, pre[a:b])
    with pytest.raises(ValueError, match="rows"):
        kdistort.fused_fog_noise(clean[16:40], 11, *(v[16:40] for v in args),
                                 noise=torch.zeros(24, 8, 8, 3), row0=16)


# ------------------------------------------- the four-rank launch

@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(21)
    jr = JResUNet(widths=WIDTHS, bottleneck_width=BOTTLENECK, precision=HI)
    jrv = _randomize(jr.init(jax.random.PRNGKey(1),
                             jnp.zeros((1, 32, 32, 3))), rng)
    jj = JVGG16(num_classes=5, cfg=VGG_CFG, fc_width=32, precision=HI)
    jjv = jax.tree.map(np.array, jj.init(jax.random.PRNGKey(2),
                                         jnp.zeros((1, 32, 32, 3))))
    judge = JVGG16(num_classes=JUDGE["num_classes"], cfg=JUDGE["cfg"],
                   fc_width=JUDGE["fc_width"], precision=HI)
    judge_v = jax.tree.map(np.array, judge.init(
        jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 3))))
    torch.manual_seed(4)
    loop_judge = VGG16(**LOOP_JUDGE)
    unet = SimpleUNet(**UNET)
    loop_net = ResUNet(WIDTHS, BOTTLENECK)
    return {"jr": jr, "jrv": jrv, "jj": jj, "jjv": jjv, "judge": judge,
            "judge_v": judge_v,
            "resunet_sd": checkpoint.resunet_from_jax(jrv),
            "vgg_sd": checkpoint.vgg16_from_jax(jjv),
            "judge_sd": checkpoint.vgg16_from_jax(judge_v),
            "loop_judge_sd": loop_judge.state_dict(),
            "unet_sd": unet.state_dict(),
            "loop_net_sd": loop_net.state_dict()}


RESUNET_ARCH = dict(widths=WIDTHS, bottleneck_width=BOTTLENECK)
VGG_ARCH = dict(num_classes=5, cfg=VGG_CFG, fc_width=32, input_size=32)
CLIP_CFG = dict(optimizer="adamw", learning_rate=1e-4, warmup_steps=0,
                seed=5)


def _inputs():
    rng = np.random.default_rng(7)
    clean = rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    x = np.linspace(0, 1, 8 * 3 * 16 * 16, dtype=np.float32).reshape(
        8, 3, 16, 16)
    imgs, labels = synthetic.make_dataset(8, 2, 16, seed=2)
    loop_imgs = rng.integers(0, 256, (43, 32, 32, 3), dtype=np.uint8)
    judge_imgs, judge_labels = synthetic.make_dataset(4, 7, 16, seed=3)
    pairs = rng.integers(0, 256, (2, 29, 16, 16, 3), dtype=np.uint8)
    return {"clean": clean, "key": jax.random.PRNGKey(7), "x": x,
            "images": imgs, "labels": labels.astype(np.int64),
            "loop_imgs": loop_imgs, "judge_imgs": judge_imgs,
            "judge_labels": judge_labels.astype(np.int64), "pairs": pairs}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tree")
    synthetic.write_image_tree(str(root / "t"), num_classes=3, per_class=7,
                               size=16)  # 21 images: an uneven tail
    return root


@pytest.fixture(scope="module")
def launched(models, inputs, tree):
    """Every mesh program, in one launch of four gloo ranks on the CPU;
    ``{name: rank 0's result}`` and the judge loop's every-rank log."""
    cfg = jconfigs.RandomMixConfig(apply_scales=SCALES)
    bad01, clean01 = (np.asarray(a) for a in jdist.make_training_pair(
        inputs["clean"], inputs["key"], cfg))
    step = dict(resunet_sd=models["resunet_sd"], resunet_arch=RESUNET_ARCH,
                vgg_sd=models["vgg_sd"], vgg_arch=VGG_ARCH, bad01=bad01,
                clean01=clean01)
    judge = dict(vgg_sd=models["judge_sd"], vgg_arch=dict(JUDGE))
    judge0 = dict(vgg_sd=models["judge_sd"],
                  vgg_arch=dict(JUDGE, dropout_rate=0.0))
    programs = [
        ("dp2", "unified_step", dict(step, data=2)),
        ("dp4", "unified_step", dict(step, data=4)),
        ("tp22", "unified_step", dict(step, data=2, model=2)),
        ("fwd22", "judge_forward", dict(judge, x_nchw=inputs["x"], data=2,
                                        model=2)),
        ("fwd14", "judge_forward", dict(judge, x_nchw=inputs["x"], data=1,
                                        model=4)),
        ("clip22", "judge_train_step", dict(
            judge0, cfg_kw=CLIP_CFG, images_u8=inputs["images"],
            labels=inputs["labels"], data=2, model=2, steps=2)),
        ("unified_loop", "unified_loop", dict(
            resunet_sd=models["loop_net_sd"], resunet_arch=RESUNET_ARCH,
            train_u8=inputs["loop_imgs"][:32], val_u8=inputs["loop_imgs"][32:],
            cfg_kw=dict(batch_size=16, epochs=2, seed=3, mix=LOOP_MIX),
            data=2)),
        ("restorer_loop", "restorer_loop", dict(
            unet_sd=models["unet_sd"], unet_arch=UNET,
            bad_u8=inputs["pairs"][0], clean_u8=inputs["pairs"][1], batch=8,
            val_rows=5, epochs=2, data=2)),
        ("judge_loop", "judge_loop", dict(
            vgg_sd=models["loop_judge_sd"], vgg_arch=LOOP_JUDGE,
            cfg_kw=dict(batch_size=8, epochs=1, seed=1),
            images_u8=inputs["judge_imgs"], labels=inputs["judge_labels"],
            val_rows=12, data=2, model=2,
            save_path=str(tree / "judge_ckpt"))),
        ("eval", "eval_directory", dict(
            vgg_sd=models["loop_judge_sd"], vgg_arch=dict(LOOP_JUDGE,
                                                          num_classes=3),
            data_dir=str(tree / "t"), batch=16, size=16, data=2)),
    ]
    models["eval_judge_sd"] = {
        k: (v[:3] if k.startswith("classifier.6") else v)
        for k, v in models["loop_judge_sd"].items()}
    programs[-1][2]["vgg_sd"] = models["eval_judge_sd"]
    per_rank = launch.spawn(checks.run, 4,
                            ([(p, kw) for _, p, kw in programs],),
                            device="cpu", threads=1, timeout=600)
    out = {name: per_rank[0][i] for i, (name, _, _) in enumerate(programs)}
    out["per_rank"] = {name: [r[i] for r in per_rank]
                       for i, (name, _, _) in enumerate(programs)}
    return out


def _jax_unified_step(models, inputs):
    jr, jrv, jj, jjv = (models[k] for k in ("jr", "jrv", "jj", "jjv"))
    cfg = jconfigs.RandomMixConfig(apply_scales=SCALES)
    jva = lambda x: jj.apply(jjv, x, train=False,  # noqa: E731
                             tap_layer=jj.tap_index(jvgg.PERCEPTUAL_TAP))
    jstep = jcommon.make_unified_train_step(cfg, 0.1, jva, jit=False)
    state = jcommon.TrainState.create(jr.apply, jrv, _capture_grads())
    new_state, jaux = jax.jit(jstep)(state, inputs["clean"], inputs["key"])
    ref_sd = checkpoint.resunet_from_jax(jax.device_get(
        {"params": new_state.opt_state,
         "batch_stats": new_state.batch_stats}))
    return jaux, ref_sd


@pytest.mark.parametrize("run", ["dp2", "dp4"])
def test_data_parallel_unified_step_matches_jax(run, launched, models,
                                                inputs):
    """The unified step on 2 and 4 data ranks, each on its rows of
    tsr_tpu's training pair, against tsr_tpu's full-batch jitted step at
    test_unified_step_matches_jax's bounds: the global loss, pixel and
    perceptual losses within 1e-5 relative; the all-reduced gradients as
    _assert_grads_match holds them at 1e-4 (a BN-fed bias's exact
    gradient is 0: both below 1e-5 of the largest); the synced running
    statistics within 1e-5 of the layer's largest (and at least 1)."""
    jaux, ref_sd = _jax_unified_step(models, inputs)
    got = launched[run]
    for k in ("loss", "pixel_loss", "perceptual_loss"):
        assert abs(got["aux"][k] - float(jaux[k])) <= 1e-5 * abs(
            float(jaux[k])), k
    fed = batchnorm_fed_biases(ResUNet(WIDTHS, BOTTLENECK))
    top = max(np.abs(ref_sd[n].numpy()).max() for n in got["grads"])
    assert set(got["grads"]) == {n for n, _ in ResUNet(
        WIDTHS, BOTTLENECK).named_parameters()}
    for name, g in got["grads"].items():
        ref = ref_sd[name].numpy()
        if name in fed:
            assert max(np.abs(ref).max(), np.abs(g).max()) <= 1e-5 * top
            continue
        err = np.abs(g - ref).max()
        assert err <= 1e-4 * np.abs(ref).max() + 1e-6 * top, (name, err)
    for name, buf in got["buffers"].items():
        ref = ref_sd[name].numpy()
        assert np.abs(buf - ref).max() <= 1e-5 * max(
            1.0, np.abs(ref).max()), name
    ranks = launched["per_rank"][run]
    n_ranks = 2 if run == "dp2" else 4
    assert all(r["aux"] == got["aux"] for r in ranks[:n_ranks])
    assert all(r is None for r in ranks[n_ranks:])


def test_model_parallel_unified_step_matches_one_process(launched, models,
                                                         inputs):
    """The unified step at (data=2, model=2) with RESTORER_TP_RULES: its
    loss within 1e-4 relative of the port's one-process step on the same
    pair (and tsr_tpu's), each split bottleneck weight and its AdamW
    moments holding half the output channels, the gathered gradients as
    the one-process ones."""
    jaux, ref_sd = _jax_unified_step(models, inputs)
    got = launched["tp22"]
    net = ResUNet(WIDTHS, BOTTLENECK)
    net.load_state_dict(models["resunet_sd"])
    vgg = VGG16(**VGG_ARCH)
    vgg.load_state_dict(models["vgg_sd"])
    cfg = jconfigs.RandomMixConfig(apply_scales=SCALES)
    bad01, clean01 = jdist.make_training_pair(inputs["clean"], inputs["key"],
                                              cfg)
    from tsr_tpu_torch import losses
    loss, _ = common.unified_loss(net.train(), _t(bad01), _t(clean01), 0.1,
                                  losses.perceptual_features(vgg.eval()))
    assert math.isclose(got["aux"]["loss"], loss.item(), rel_tol=1e-4)
    assert math.isclose(got["aux"]["loss"], float(jaux["loss"]),
                        rel_tol=1e-4)
    half = (BOTTLENECK // 2, WIDTHS[-1], 3, 3)
    assert got["bottleneck_weight"] == half
    assert got["bottleneck_moments"] == (half, half)
    loss.backward()
    top = max(p.grad.abs().max().item() for p in net.parameters())
    for name, p in net.named_parameters():
        err = np.abs(got["grads"][name] - p.grad.numpy()).max()
        assert err <= 1e-4 * top, (name, err)


@pytest.mark.parametrize("run,model", [("fwd22", 2), ("fwd14", 4)])
def test_model_parallel_judge_forward(run, model, launched, models, inputs):
    """The judge's forward with VGG_TP_RULES at (data=2, model=2) and
    (data=1, model=4) equals the replicated forward and tsr_tpu's within
    1e-4; each model rank holds fc/M rows of classifier.0 and fc/M
    columns of classifier.3."""
    got = launched[run]
    fc = JUDGE["fc_width"]
    in0 = 16 * (16 // 4) ** 2
    assert got["classifier.0"] == (fc // model, in0)
    assert got["classifier.3"] == (fc, fc // model)
    judge = VGG16(**JUDGE).eval()
    judge.load_state_dict(models["judge_sd"])
    with torch.no_grad():
        rep = judge(_t(inputs["x"])).numpy()
    ref = np.asarray(models["judge"].apply(
        models["judge_v"], jnp.asarray(inputs["x"].transpose(0, 2, 3, 1))))
    assert np.abs(got["logits"] - rep).max() <= 1e-4
    assert np.abs(got["logits"] - ref).max() <= 1e-4


def test_model_parallel_clipped_judge_step(launched, models, inputs):
    """Two judge train steps at (data=2, model=2), dropout at rate 0,
    ClippedAdamW with the gradient's global norm above 1 (so the clip
    acts, its norm summed over the split FC shards): the losses within
    1e-5 relative of one process's and the updated parameters within
    1e-5."""
    judge = VGG16(**dict(JUDGE, dropout_rate=0.0))
    judge.load_state_dict(models["judge_sd"])
    cfg = configs.JudgeTrainConfig(**CLIP_CFG)
    x, y = _t(inputs["images"]), _t(inputs["labels"])
    probe = VGG16(**dict(JUDGE, dropout_rate=0.0))
    probe.load_state_dict(models["judge_sd"])
    from tsr_tpu_torch import losses
    losses.cross_entropy_loss(probe(common.judge_input(x)), y).backward()
    norm = math.sqrt(sum(p.grad.pow(2).sum().item()
                         for p in probe.parameters()))
    assert norm > 1.0, norm
    state = common.create_judge_state(judge, cfg)
    step = common.make_judge_train_step()
    ref = [step(state, x, y)["loss"].item() for _ in range(2)]
    got = launched["clip22"]
    for a, b in zip(got["losses"], ref):
        assert math.isclose(a, b, rel_tol=1e-5), (got["losses"], ref)
    for k, v in judge.state_dict().items():
        assert np.abs(got["params"][k] - v.numpy()).max() <= 1e-5, k


def _no_mesh_unified_loop(models, inputs):
    cfg = configs.UnifiedTrainConfig(batch_size=16, epochs=2, seed=3,
                                     mix=LOOP_MIX)
    net = ResUNet(WIDTHS, BOTTLENECK)
    net.load_state_dict(models["loop_net_sd"])
    state = common.create_unified_state(net, cfg, 2)
    imgs = inputs["loop_imgs"]
    return loops.train_unified(
        state, lambda ep: iter([(imgs[:16],), (imgs[16:32],)]),
        lambda: iter([(imgs[32:],)]), cfg, log=lambda s: None,
        device="cpu")[1]


def _losses(history):
    return [x for r in history for x in r["step_loss"] + [r["val_loss"]]]


def test_train_unified_on_a_mesh_matches_the_loop(launched, models, inputs):
    """train_unified(mesh=data 2) over two epochs of two batches of 16 and
    an uneven validation batch of 11 (computed whole on each rank): every
    step's and epoch's loss within the reference's rtol=2e-3 of the
    no-mesh loop; images counted for the global batch."""
    got = launched["unified_loop"]
    want = _no_mesh_unified_loop(models, inputs)
    np.testing.assert_allclose(_losses(got), _losses(want), rtol=2e-3)
    assert len(got) == 2 and all(len(r["step_loss"]) == 2 for r in got)


def test_train_restorer_on_a_mesh_matches_the_loop(launched, models,
                                                   inputs):
    """train_restorer(mesh=data 2), MSE and Adam, two epochs of three
    batches of 8 and an uneven validation batch of 5: every step's and
    epoch's loss within rtol=2e-3 of the no-mesh loop."""
    bad, clean = inputs["pairs"]
    net = SimpleUNet(**UNET)
    net.load_state_dict(models["unet_sd"])
    state = common.create_restoration_state(
        net, configs.RestorationTrainConfig())
    _, want = loops.train_restorer(
        state, checks._fixed_batches([bad[:24], clean[:24]], 8),
        checks._fixed_batches([bad[24:], clean[24:]], 5), 2,
        common.make_restoration_train_step("mse"),
        common.make_restoration_eval_step("mse"), log=lambda s: None,
        device="cpu")
    got = launched["restorer_loop"]
    np.testing.assert_allclose(_losses(got), _losses(want), rtol=2e-3)


def test_train_judge_on_a_mesh_writes_one_device_checkpoint(launched,
                                                            models, tree):
    """train_judge(mesh=(2, 2)) runs with the FC layers split (fc/2 rows of
    classifier.0 and columns of classifier.3 on each rank), only the
    first rank logs, and its checkpoint, written by the first rank from
    the gathered parameters, loads through zoo.load_model in this one
    process equal to them; a train batch that does not divide by the data
    axis is refused with the reference's message."""
    got = launched["judge_loop"]
    fc = LOOP_JUDGE["fc_width"]
    assert got["classifier.0"][0] == fc // 2
    assert got["classifier.3"][1] == fc // 2
    assert 0.0 < got["best_acc"] <= 1.0
    assert any("val acc" in ln for ln in got["log"])
    assert all(r["log"] == [] for r in launched["per_rank"]["judge_loop"][1:])
    loaded = zoo.load_model("vgg16", str(tree / "judge_ckpt"), size=16,
                            device="cpu")
    sd = loaded.state_dict()
    assert sd.keys() == got["params"].keys()
    for k, v in sd.items():
        assert np.array_equal(v.numpy(), got["params"][k]), k
    with pytest.raises(ValueError, match="global batch 7 not divisible by "
                                         "mesh data axis 2"):
        loops._train_rows((np.zeros((7, 2)),), type("M", (), {"data": 2}))


def test_evaluate_directory_on_a_mesh(launched, models, tree):
    """evaluate_directory(mesh=data 2) over a 21-image tree at batch 16
    (the tail of 5 computed whole on each rank and counted once): the
    same n, top-1 and mean confidence as the call without a mesh."""
    judge = VGG16(**dict(LOOP_JUDGE, num_classes=3))
    judge.load_state_dict(models["eval_judge_sd"])
    want = teval.evaluate_directory(judge, str(tree / "t"), batch_size=16,
                                    size=16, device="cpu")
    got = launched["eval"]
    assert got["n"] == want["n"] == 21
    assert got["top1"] == want["top1"]
    assert math.isclose(got["confidence"], want["confidence"],
                        rel_tol=1e-6)


def test_dryrun_multichip_small():
    """dryrun_multichip(4) at small widths: the flagship step on (data=2,
    model=2), then on the sub-mesh of 2 ranks (data=1, model=2), each
    within its own rtol=1e-3 of one process, the TP weights split."""
    from tsr_tpu_torch.parallel.dryrun import dryrun_multichip

    records = dryrun_multichip(
        4, size=32, widths=(4, 8, 16), bottleneck=16, judge_cfg=VGG_CFG,
        fc_width=64, device="cpu", timeout=300)
    assert [r["n"] for r in records] == [4, 2]
    assert [r["mesh"] for r in records] == [{"data": 2, "model": 2},
                                            {"data": 1, "model": 2}]
    for r in records:
        assert math.isclose(r["loss"], r["single_process_loss"],
                            rel_tol=1e-3)
        assert r["tp_shapes"]["bottleneck.0.conv_block.0.weight"][0] == 8
        assert r["tp_shapes"]["classifier.0.weight"][0] == 32
