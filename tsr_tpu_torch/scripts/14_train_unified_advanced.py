"""Train the unified ResUNet on dynamic mixed distortions (ref:14):
AdamW(2e-4, wd=1e-4) + cosine schedule, L1 + 0.1*perceptual, 25 epochs,
BS 16, 95/5 split, best-val checkpoint.

The random-mix distortion runs on the device inside each train step
(kernels B1 and B2 on the card, ``ops.distortions``): the host only
streams clean batches, replacing the reference's 8-worker CPU generation
(ref:14:213)."""

import functools
import os

import torch

from tsr_tpu_torch import configs, losses, zoo
from tsr_tpu_torch.data import gtsrb
from tsr_tpu_torch.scripts._common import (CHECKPOINT_HELP, base_parser,
                                           ensure_clean_tree, judge_ckpt_path,
                                           mesh_from_args, num_classes, parse,
                                           unified_ckpt_path)
from tsr_tpu_torch.train import common, loops


class _CleanOnly:
    """Adapter: ImageFolder -> clean-image-only samples."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def load_batch(self, indices):
        imgs, _ = self.ds.load_batch(indices)
        return (imgs,)


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--epochs", type=int, default=25)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--judge", default=None, help=CHECKPOINT_HELP)
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--save", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (params stay f32)")
    p.add_argument("--host-stream", action="store_true",
                   help="stream clean batches from host per step instead "
                        "of the device-resident loop (automatic with --mesh)")
    p.add_argument("--workers", type=int, default=8,
                   help="native decode threads of the host-streamed loader")
    args = parse(p, argv, mesh_script=__file__)
    if args.judge is None:
        args.judge = judge_ckpt_path(args)
    args.save = args.save or unified_ckpt_path(args)
    cfg = configs.UnifiedTrainConfig(
        batch_size=args.batch_size, epochs=args.epochs,
        learning_rate=args.lr, seed=args.seed)
    dtype = torch.bfloat16 if args.bf16 else torch.float32

    clean = ensure_clean_tree(args)
    ds = _CleanOnly(gtsrb.ImageFolder(clean, size=args.image_size,
                                      threads=args.workers))
    print(f"Training data: {len(ds)} images")
    tr_idx, va_idx = gtsrb.train_val_split(len(ds), cfg.train_split,
                                           cfg.seed)

    vgg_apply = None
    if args.judge != "none":
        if os.path.exists(args.judge):
            judge = zoo.load_model(
                "vgg16", args.judge, args.image_size,
                num_classes=num_classes(args, clean), dtype=dtype,
                device=args.device)
            vgg_apply = losses.perceptual_features(judge)
        else:
            print(f"Judge checkpoint {args.judge} missing; "
                  "training with L1 only")

    resunet = zoo.build_resunet(dtype=dtype, device=args.device)
    steps_per_epoch = max(1, int(len(ds) * cfg.train_split)
                          // cfg.batch_size)
    state = common.create_unified_state(resunet, cfg, steps_per_epoch)
    if args.resume and os.path.exists(os.path.join(args.save, "train")):
        state = zoo.load_train_state(args.save, state)
        print(f"Resumed from {args.save} at step {int(state.step)}")

    mesh = mesh_from_args(args)
    fits = len(ds) * args.image_size ** 2 * 3 < 8e9
    if fits and mesh is None and not args.host_stream:
        (clean_arr,) = ds.load_batch(range(len(ds)))
        loops.train_unified_on_device(
            state, clean_arr, tr_idx, va_idx, cfg, vgg_apply=vgg_apply,
            save_path=args.save, device=args.device)
    else:
        mk = functools.partial(gtsrb.batches, ds, batch_size=cfg.batch_size)
        loops.train_unified(
            state,
            clean_batches=lambda ep: mk(indices=tr_idx, seed=cfg.seed + ep),
            val_clean_batches=lambda: mk(indices=va_idx, shuffle=False,
                                         drop_remainder=False),
            cfg=cfg, vgg_apply=vgg_apply, save_path=args.save,
            device=args.device, mesh=mesh)
    print(f"Done. Checkpoint at {args.save}")


if __name__ == "__main__":
    main()
