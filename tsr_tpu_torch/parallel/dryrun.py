"""The flagship unified train step on a mesh, held against one process.

Port of ``__graft_entry__.py::dryrun_multichip``: the production ResUNet
(widths 64/128/256, bottleneck 512) at 224 px with the random mix on the
device, L1 + 0.1 x perceptual against VGG16-D's ``features[:16]``, AdamW
(``configs.UnifiedTrainConfig``), on ``n`` ranks with a model axis of 2
when ``n`` is even (the real TP rules: the bottleneck's channels and the
judge's FC layers split) and one image per rank. Its loss must be the
one-process step's within ``rtol=1e-3``; then the same runs on the {4, 2}
sub-meshes below ``n``. Sizes and widths are arguments only so that a
test can run it small.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tsr_tpu_torch.models.vgg import VGG16_CFG

RTOL = 1e-3


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _dryrun_one(n: int, size: int, widths, bottleneck: int, judge_cfg,
                fc_width: int) -> Optional[Dict]:
    """One flagship step on a mesh over ranks ``0..n-1`` and the same step
    in one process; None on a rank outside the mesh."""
    from tsr_tpu_torch import configs, losses
    from tsr_tpu_torch.data import synthetic
    from tsr_tpu_torch.models import ResUNet, VGG16
    from tsr_tpu_torch.parallel import mesh as pmesh
    from tsr_tpu_torch.train import common

    model_par = 2 if n % 2 == 0 and n >= 2 else 1
    mesh = pmesh.make_mesh(data=-1, model=model_par, ranks=list(range(n)))
    if mesh is None:
        return None
    dev = mesh.device
    batch = n  # 1 image per rank: the tree and the collectives, cheaply
    cfg = configs.UnifiedTrainConfig(batch_size=batch)
    torch.manual_seed(0)
    with torch.device(dev):
        resunet = ResUNet(tuple(widths), bottleneck)
        judge = VGG16(num_classes=configs.NUM_CLASSES, cfg=tuple(judge_cfg),
                      fc_width=fc_width, input_size=size).eval()
    imgs, _ = synthetic.make_dataset(num_classes=4,
                                     per_class=(batch + 3) // 4, size=size)
    clean = torch.from_numpy(np.ascontiguousarray(imgs[:batch])).to(dev)

    def step_fn():
        return common.make_unified_train_step(
            cfg.mix, cfg.perceptual_weight, losses.perceptual_features(judge))

    # the identical step, same weights and batch, in this process alone,
    # on copies (the mesh's state is placed in place)
    state1 = common.create_unified_state(copy.deepcopy(resunet), cfg, 1)
    loss1 = float(step_fn()(state1, clean,
                            torch.Generator(dev).manual_seed(2))["loss"])
    del state1

    state = common.create_unified_state(resunet, cfg, 1)
    pmesh.shard_state(state, mesh, pmesh.RESTORER_TP_RULES)
    pmesh.shard_variables(judge, mesh, pmesh.VGG_TP_RULES)
    rows = pmesh.shard_batch(clean, mesh)
    # the batch really splits over the data axis
    _check(rows.shape[0] == batch // mesh.data,
           f"{tuple(rows.shape)} rows on a rank of {mesh.shape}")
    loss = float(step_fn()(state, rows,
                           torch.Generator(dev).manual_seed(2))["loss"])
    _check(bool(np.isclose(loss, loss1, rtol=RTOL)),
           f"mesh loss {loss} vs one process {loss1} (rtol {RTOL})")
    tp = {"bottleneck.0.conv_block.0.weight": tuple(
              state.model.bottleneck[0].conv_block[0].weight.shape),
          "classifier.0.weight": tuple(judge.classifier[0].weight.shape),
          "classifier.3.weight": tuple(judge.classifier[3].weight.shape)}
    if model_par > 1:
        # the TP rules hit the flagship tree: halved on the split dims
        _check(tp["bottleneck.0.conv_block.0.weight"][0] == bottleneck // 2
               and tp["classifier.0.weight"][0] == fc_width // 2
               and tp["classifier.3.weight"][1] == fc_width // 2,
               f"TP shapes {tp}")
    return {"n": n, "mesh": mesh.shape, "size": size, "batch": batch,
            "per_rank": rows.shape[0], "loss": loss,
            "single_process_loss": loss1, "tp_shapes": tp,
            "backend": mesh.backend, "device": str(dev),
            "peak_memory_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                                if dev.type == "cuda" else None)}


def _dryrun_rank(n_devices: int, size: int, widths, bottleneck: int,
                 judge_cfg, fc_width: int) -> List[Optional[Dict]]:
    return [_dryrun_one(n, size, widths, bottleneck, judge_cfg, fc_width)
            for n in [n_devices] + [k for k in (4, 2) if k < n_devices]]


def dryrun_multichip(n_devices: int, size: int = 224,
                     widths: Sequence[int] = (64, 128, 256),
                     bottleneck: int = 512, judge_cfg=VGG16_CFG,
                     fc_width: int = 4096, device: str = "cuda",
                     timeout: float = 1200.0) -> List[Dict]:
    """Start ``n_devices`` ranks on ``device`` (``parallel.launch``; ranks
    that share a card run gloo), run the flagship step on the mesh of all
    of them and then on the {4, 2} sub-meshes below, each against the
    one-process step. Prints one line per mesh and returns the first
    rank's records; raises when a loss misses ``rtol=1e-3`` or a TP
    parameter is not split."""
    from tsr_tpu_torch.parallel import launch

    results = launch.spawn(
        _dryrun_rank, n_devices,
        (n_devices, size, tuple(widths), bottleneck, tuple(judge_cfg),
         fc_width), device=device, timeout=timeout)
    records = results[0]
    for r in records:
        print(f"dryrun_multichip({r['n']}): mesh={r['mesh']} size={size} "
              f"batch={r['batch']} per_rank={r['per_rank']} "
              f"loss={r['loss']:.6f} "
              f"single_process_loss={r['single_process_loss']:.6f} "
              f"parity=OK(rtol={RTOL:g}) backend={r['backend']}")
    return records
