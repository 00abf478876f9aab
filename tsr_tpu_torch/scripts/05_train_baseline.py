"""Fine-tune the VGG16 judge on the clean tree (ref:05): SGD(1e-3, 0.9),
CE loss, 10 epochs, BS 64, 80/20 split, best-val-acc checkpoint.

Deviation: ImageNet pretrained weights are unobtainable offline, so the
judge trains from scratch; pass --batchnorm (vgg16_bn variant) for a
trainable-from-scratch configuration, or --init-pth to start from a
torchvision-format .pth if you have one.
"""

import functools
import os

import numpy as np
import torch

from tsr_tpu_torch import configs, zoo
from tsr_tpu_torch.data import gtsrb
from tsr_tpu_torch.scripts._common import (base_parser, ensure_clean_tree,
                                           judge_ckpt_path, mesh_from_args,
                                           parse)
from tsr_tpu_torch.train import common, loops


def load_init_pth(judge, path: str, num_classes: int, head_seed: int = 0):
    """Load a torchvision-format VGG16 state dict into ``judge``. A head of
    another width (the 1000-class ImageNet one) is re-initialized at
    ``num_classes`` (ref:05:54's ``classifier[6]`` swap) with torch's
    Linear default bounds, drawn as the JAX package's
    ``checkpoint.vgg16_from_pth`` draws them."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    w = sd["classifier.6.weight"]
    if w.shape[0] != num_classes:
        fan_in = w.shape[1]
        bound = 1.0 / np.sqrt(fan_in)
        rng = np.random.default_rng(head_seed)
        kernel = rng.uniform(-bound, bound, (fan_in, num_classes))
        bias = rng.uniform(-bound, bound, num_classes)
        sd["classifier.6.weight"] = torch.from_numpy(
            kernel.astype(np.float32).T.copy())
        sd["classifier.6.bias"] = torch.from_numpy(bias.astype(np.float32))
    judge.load_state_dict(sd)


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--optimizer", choices=("sgd", "adamw"), default="sgd",
                   help="sgd = reference recipe (ref:05:60, assumes "
                        "ImageNet init); adamw = from-scratch alternative")
    p.add_argument("--batchnorm", action="store_true")
    p.add_argument("--label-smoothing", type=float, default=0.0,
                   help="CE label smoothing: a from-scratch judge that "
                        "memorizes a small corpus is overconfident; the "
                        "reference's ImageNet-initialized one is not "
                        "(ref:13). Argmax metrics are unaffected in "
                        "expectation.")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (params stay f32)")
    p.add_argument("--host-stream", action="store_true",
                   help="stream batches from host per step instead of the "
                        "device-resident loop (automatic for datasets too "
                        "big for device memory or when --mesh is set)")
    p.add_argument("--init-pth", default=None,
                   help="torchvision-format VGG16 .pth to start from")
    p.add_argument("--save", default=None)
    p.add_argument("--resume", action="store_true",
                   help="resume from --save (params+opt state+step)")
    p.add_argument("--workers", type=int, default=8,
                   help="native decode threads of the host-streamed loader")
    args = parse(p, argv, mesh_script=__file__)
    args.save = args.save or judge_ckpt_path(args)
    cfg = configs.JudgeTrainConfig(
        batch_size=args.batch_size, epochs=args.epochs,
        learning_rate=args.lr, optimizer=args.optimizer, seed=args.seed,
        label_smoothing=args.label_smoothing)

    root = ensure_clean_tree(args)
    ds = gtsrb.ImageFolder(root, size=args.image_size, threads=args.workers)
    print(f"Training set: {len(ds)} images, {len(ds.classes)} classes")
    tr_idx, va_idx = gtsrb.train_val_split(len(ds), cfg.train_split,
                                           cfg.seed)

    judge = zoo.build_judge(
        num_classes=len(ds.classes), use_batchnorm=args.batchnorm,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        size=args.image_size, device=args.device)
    if args.init_pth:
        load_init_pth(judge, args.init_pth, len(ds.classes))
    state = common.create_judge_state(judge, cfg)
    if args.resume and os.path.exists(os.path.join(args.save, "train")):
        state = zoo.load_train_state(args.save, state)
        print(f"Resumed from {args.save} at step {int(state.step)}")

    ckpt_config = {"kind": "vgg16", "num_classes": len(ds.classes),
                   "use_batchnorm": args.batchnorm}
    mesh = mesh_from_args(args)
    # device-resident when the uint8 tree fits comfortably in memory
    fits = len(ds) * args.image_size ** 2 * 3 < 8e9
    if fits and mesh is None and not args.host_stream:
        images, labels = ds.load_batch(range(len(ds)))
        loops.train_judge_on_device(
            state, images, labels, tr_idx, va_idx, cfg,
            save_path=args.save, ckpt_config=ckpt_config,
            device=args.device)
    else:
        mk = functools.partial(gtsrb.batches, ds, batch_size=cfg.batch_size)
        loops.train_judge(
            state,
            train_batches=lambda ep: mk(indices=tr_idx, seed=cfg.seed + ep),
            val_batches=lambda: mk(indices=va_idx, shuffle=False,
                                   drop_remainder=False),
            cfg=cfg, save_path=args.save, ckpt_config=ckpt_config,
            device=args.device, mesh=mesh)
    print(f"Done. Checkpoint at {args.save}")


if __name__ == "__main__":
    main()
