"""Rank programs that run the mesh's paths for a caller to hold against one
process.

Each program runs on every rank of a ``parallel.launch.spawn`` (or of a
group joined over ``env://``), builds its mesh over the first ranks of the
world (every rank takes part in making the groups; a rank outside the mesh
returns None) and returns host values (numpy, floats) that the caller
compares with the one-process result: the CPU tests with ``tsr_tpu``'s and
``chip_smoke.py`` with the port's own on the card. :func:`run` runs
several in one launch.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tsr_tpu_torch import configs, losses
from tsr_tpu_torch.models import ResUNet, SimpleUNet, VGG16
from tsr_tpu_torch.parallel import mesh as pmesh
from tsr_tpu_torch.train import common


def _mesh(data: int, model: int) -> Optional[pmesh.Mesh]:
    return pmesh.make_mesh(data, model, ranks=list(range(data * model)))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _module(cls, state_dict, arch: dict, device) -> torch.nn.Module:
    with torch.device(device):
        m = cls(**arch)
    m.load_state_dict(state_dict)
    return m


def _gathered_grads(model, mesh) -> Dict[str, np.ndarray]:
    return {n: _np(pmesh.gather_tensor(p.grad, getattr(p, "tp_dim", None),
                                       mesh))
            for n, p in model.named_parameters() if p.grad is not None}


def unified_step(resunet_sd, resunet_arch: dict, vgg_sd, vgg_arch: dict,
                 bad01: np.ndarray, clean01: np.ndarray, data: int,
                 model: int = 1, perceptual_weight: float = 0.1
                 ) -> Optional[Dict]:
    """The unified step on a given training pair on a ``(data, model)``
    mesh: each rank's rows through ``common.unified_loss`` (the ResUNet in
    train mode, synced batch statistics, perceptual features of the frozen
    VGG), backward, the gradients averaged over the data axis, then one
    AdamW update (``unified_optimizer``). Returns the global losses, every
    gradient (split ones gathered whole), the running statistics after
    the step, and the local shapes of the first bottleneck convolution's
    weight and of its AdamW moments."""
    mesh = _mesh(data, model)
    if mesh is None:
        return None
    dev = mesh.device
    net = _module(ResUNet, resunet_sd, resunet_arch, dev).train()
    vgg = _module(VGG16, vgg_sd, vgg_arch, dev).eval()
    state = common.create_unified_state(net, configs.UnifiedTrainConfig(), 1)
    pmesh.shard_state(state, mesh,
                      pmesh.RESTORER_TP_RULES if model > 1 else ())
    bad, clean = (pmesh.shard_batch(torch.from_numpy(a).to(dev), mesh)
                  for a in (bad01, clean01))
    loss, aux = common.unified_loss(net, bad, clean, perceptual_weight,
                                    losses.perceptual_features(vgg))
    loss.backward()
    common._average_gradients(net, mesh)
    grads = _gathered_grads(net, mesh)
    state.optimizer.step()
    w = net.bottleneck[0].conv_block[0].weight
    return {"aux": {k: float(v) for k, v in
                    common.global_metrics(state, aux).items()},
            "grads": grads,
            "buffers": {n: _np(b) for n, b in net.named_buffers()
                        if n.endswith(("running_mean", "running_var"))},
            "bottleneck_weight": tuple(w.shape),
            "bottleneck_moments": tuple(
                tuple(v.shape) for k, v in sorted(state.optimizer.state[w]
                                                  .items())
                if k.startswith("exp_avg"))}


def judge_forward(vgg_sd, vgg_arch: dict, x_nchw: np.ndarray, data: int,
                  model: int) -> Optional[Dict]:
    """The judge's forward in eval mode on a ``(data, model)`` mesh with
    ``VGG_TP_RULES``: the logits of the whole batch (each data rank's rows
    gathered) and the local shapes of ``classifier.0`` and ``.3``."""
    from tsr_tpu_torch.parallel.collectives import all_gather_cat

    mesh = _mesh(data, model)
    if mesh is None:
        return None
    vgg = _module(VGG16, vgg_sd, vgg_arch, mesh.device).eval()
    pmesh.shard_variables(vgg, mesh, pmesh.VGG_TP_RULES)
    x = pmesh.shard_batch(torch.from_numpy(x_nchw).to(mesh.device), mesh)
    with torch.no_grad():
        logits = all_gather_cat(vgg(x), 0, mesh.data_group)
    return {"logits": _np(logits),
            "classifier.0": tuple(vgg.classifier[0].weight.shape),
            "classifier.3": tuple(vgg.classifier[3].weight.shape)}


def judge_train_step(vgg_sd, vgg_arch: dict, cfg_kw: dict,
                     images_u8: np.ndarray, labels: np.ndarray, data: int,
                     model: int, steps: int = 1) -> Optional[Dict]:
    """``steps`` judge train steps (``common.make_judge_train_step``, the
    optimizer of ``configs.JudgeTrainConfig(**cfg_kw)``) on a ``(data,
    model)`` mesh with ``VGG_TP_RULES``; dropout from generators seeded
    with the config's seed. Returns the global losses and the parameters
    after the steps, gathered whole."""
    mesh = _mesh(data, model)
    if mesh is None:
        return None
    cfg = configs.JudgeTrainConfig(**cfg_kw)
    vgg = _module(VGG16, vgg_sd, vgg_arch, mesh.device)
    state = common.create_judge_state(vgg, cfg)
    pmesh.shard_state(state, mesh, pmesh.VGG_TP_RULES)
    step = common.make_judge_train_step(cfg.label_smoothing)
    x, y = pmesh.shard_batch(tuple(torch.from_numpy(a).to(mesh.device)
                                   for a in (images_u8, labels)), mesh)
    torch.manual_seed(cfg.seed)
    out = [float(step(state, x, y)["loss"]) for _ in range(steps)]
    return {"losses": out,
            "params": {k: _np(v) for k, v in
                       pmesh.gathered_state_dict(vgg, mesh).items()}}


def restoration_two_process(weights: str, seed: int = 0) -> float:
    """Two processes over ``env://`` (``parallel.distributed.initialize``
    from the environment), the counterpart of the JAX package's
    two-process test: each rank decodes only its half of a seeded global
    batch (``process_shard``), the halves become one batch sharded over
    the data axis (``make_global_batch``), and one MSE restoration step of
    a SimpleUNet(widths=(4, 8)) with Adam (``restoration_optimizer``) runs
    on it from the ``weights`` state dict. Returns the global loss."""
    from tsr_tpu_torch.parallel import distributed

    distributed.initialize(device="cpu")
    try:
        rng = np.random.default_rng(seed)
        bad = rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
        clean = rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
        mesh = pmesh.make_mesh(data=-1, model=1)
        local = distributed.process_shard(np.arange(8), mesh)
        gbad = distributed.make_global_batch(bad[local], mesh)
        gclean = distributed.make_global_batch(clean[local], mesh)
        if (tuple(gbad.shape) != (8, 32, 32, 3)
                or gbad.to_local().shape[0] != 8 // mesh.data):
            raise RuntimeError(f"global batch {tuple(gbad.shape)}, rows "
                               f"{tuple(gbad.to_local().shape)}")
        net = _module(SimpleUNet, torch.load(weights, weights_only=True),
                      {"widths": (4, 8)}, mesh.device)
        state = common.create_restoration_state(
            net, configs.RestorationTrainConfig())
        pmesh.shard_state(state, mesh)
        aux = common.make_restoration_train_step("mse")(state, gbad, gclean)
        return float(aux["loss"])
    finally:
        distributed.shutdown()


def _fixed_batches(arrays: Sequence[np.ndarray], batch: int):
    """``() -> iterator`` over consecutive global batches of ``arrays``
    (the last one the remainder)."""
    n = len(arrays[0])
    return lambda *_: iter([tuple(a[i:i + batch] for a in arrays)
                            for i in range(0, n, batch)])


def unified_loop(resunet_sd, resunet_arch: dict, train_u8: np.ndarray,
                 val_u8: np.ndarray, cfg_kw: dict, data: int, model: int = 1
                 ) -> Optional[List[Dict]]:
    """``train.loops.train_unified`` on a mesh (L1 only), every epoch over
    the same global batches of ``train_u8`` and one validation batch of
    ``val_u8``. Returns the history."""
    from tsr_tpu_torch.train import loops

    mesh = _mesh(data, model)
    if mesh is None:
        return None
    cfg = configs.UnifiedTrainConfig(**cfg_kw)
    net = _module(ResUNet, resunet_sd, resunet_arch, mesh.device)
    state = common.create_unified_state(net, cfg, len(train_u8)
                                        // cfg.batch_size)
    _, history = loops.train_unified(
        state, _fixed_batches([train_u8], cfg.batch_size),
        _fixed_batches([val_u8], len(val_u8)), cfg, log=lambda s: None,
        mesh=mesh)
    return history


def restorer_loop(unet_sd, unet_arch: dict, bad_u8: np.ndarray,
                  clean_u8: np.ndarray, batch: int, val_rows: int,
                  epochs: int, data: int) -> Optional[List[Dict]]:
    """``train.loops.train_restorer`` (MSE, Adam) on a mesh over fixed
    global batches, the last ``val_rows`` pairs for validation. Returns
    the history."""
    from tsr_tpu_torch.train import loops

    mesh = _mesh(data, 1)
    if mesh is None:
        return None
    net = _module(SimpleUNet, unet_sd, unet_arch, mesh.device)
    state = common.create_restoration_state(
        net, configs.RestorationTrainConfig())
    n = len(bad_u8) - val_rows
    _, history = loops.train_restorer(
        state, _fixed_batches([bad_u8[:n], clean_u8[:n]], batch),
        _fixed_batches([bad_u8[n:], clean_u8[n:]], val_rows), epochs,
        common.make_restoration_train_step("mse"),
        common.make_restoration_eval_step("mse"), log=lambda s: None,
        mesh=mesh)
    return history


def judge_loop(vgg_sd, vgg_arch: dict, cfg_kw: dict, images_u8, labels,
               val_rows: int, data: int, model: int,
               save_path: str) -> Optional[Dict]:
    """``train.loops.train_judge`` on a mesh with a checkpoint at
    ``save_path``. Returns the best accuracy, the local FC shapes, the
    log, and the parameters gathered whole."""
    from tsr_tpu_torch.train import loops

    mesh = _mesh(data, model)
    if mesh is None:
        return None
    cfg = configs.JudgeTrainConfig(**cfg_kw)
    vgg = _module(VGG16, vgg_sd, vgg_arch, mesh.device)
    state = common.create_judge_state(vgg, cfg)
    n = len(labels) - val_rows
    logs = []
    _, acc = loops.train_judge(
        state, _fixed_batches([images_u8[:n], labels[:n]], cfg.batch_size),
        _fixed_batches([images_u8[n:], labels[n:]], val_rows), cfg,
        save_path=save_path, log=logs.append, mesh=mesh,
        ckpt_config={"kind": "vgg16", "num_classes": vgg_arch["num_classes"],
                     "cfg": list(vgg_arch["cfg"]),
                     "fc_width": vgg_arch["fc_width"]})
    return {"best_acc": acc, "log": logs,
            "classifier.0": tuple(vgg.classifier[0].weight.shape),
            "classifier.3": tuple(vgg.classifier[3].weight.shape),
            "params": {k: _np(v) for k, v in
                       pmesh.gathered_state_dict(vgg, mesh).items()}}


def eval_directory(vgg_sd, vgg_arch: dict, data_dir: str, batch: int,
                   size: int, data: int) -> Optional[Dict]:
    """``eval.evaluate_directory`` on a mesh (host resize)."""
    from tsr_tpu_torch import eval as teval

    mesh = _mesh(data, 1)
    if mesh is None:
        return None
    vgg = _module(VGG16, vgg_sd, vgg_arch, mesh.device)
    return teval.evaluate_directory(vgg, data_dir, batch_size=batch,
                                    size=size, mesh=mesh)


@contextlib.contextmanager
def _tf32_off():
    """TF32 off for cuDNN and matmul inside, the flags restored after."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def unified_train_steps(arch: dict, judge_arch: dict, seed: int,
                        clean_u8: np.ndarray, gen_seeds: Sequence[int],
                        data: Optional[int] = None, device="cuda"
                        ) -> Optional[Dict]:
    """The unified train step (``common.make_unified_train_step``:
    ``UnifiedTrainConfig``'s multiscale mix on kernels B1/B2, L1 + 0.1 x
    perceptual on a frozen VGG16, AdamW) once per generator seed on one
    global batch, from weights drawn from ``seed`` on the device: on a
    data mesh of ``data`` ranks, or in this process alone on ``device``
    (``data=None``), with TF32 off (the flags are restored after). Returns
    the per-step global losses, the global images/s over the steps after
    the first (the warm-up), the peak memory, the kernels' launches over
    all steps (zeroed just before them), the backend and the device."""
    from tsr_tpu_torch.kernels import _build

    mesh = _mesh(data, 1) if data is not None else None
    if data is not None and mesh is None:
        return None
    dev = mesh.device if mesh is not None else torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with _tf32_off():
        torch.manual_seed(seed)
        with torch.device(dev):
            net = ResUNet(**arch)
            judge = VGG16(**judge_arch).eval()
        cfg = configs.UnifiedTrainConfig(batch_size=len(clean_u8))
        state = common.create_unified_state(net, cfg, len(gen_seeds))
        x = torch.from_numpy(np.ascontiguousarray(clean_u8)).to(dev)
        if mesh is not None:
            pmesh.shard_state(state, mesh)
            x = pmesh.shard_batch(x, mesh)
        step = common.make_unified_train_step(
            cfg.mix, cfg.perceptual_weight, losses.perceptual_features(judge))
        sync()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launch_counts()
        out = []
        for i, s in enumerate(gen_seeds):
            if i == 1:
                sync()
                t0 = time.perf_counter()
            out.append(step(state, x, torch.Generator(dev).manual_seed(s))
                       ["loss"])
        sync()
    dt = time.perf_counter() - t0
    return {"losses": [float(v) for v in out],
            "images_per_sec": (len(gen_seeds) - 1) * len(clean_u8) / dt,
            "peak_memory_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                                if dev.type == "cuda" else None),
            "launches": _build.launch_counts(),
            "backend": mesh.backend if mesh is not None else None,
            "device": str(dev)}


PROGRAMS = {"unified_step": unified_step, "judge_forward": judge_forward,
            "judge_train_step": judge_train_step,
            "unified_loop": unified_loop, "restorer_loop": restorer_loop,
            "judge_loop": judge_loop, "eval_directory": eval_directory,
            "unified_train_steps": unified_train_steps}


def run(programs: Sequence[Tuple[str, dict]]) -> List:
    """Run each ``(name, kwargs)`` of :data:`PROGRAMS` in order on this
    rank; returns their results (None where the rank is outside that
    program's mesh)."""
    return [PROGRAMS[name](**kw) for name, kw in programs]
