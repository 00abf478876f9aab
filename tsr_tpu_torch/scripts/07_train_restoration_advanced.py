"""Train the advanced (perceptual-loss) SimpleUNet (ref:07adv): loss = L1 +
0.1*VGG-perceptual on UN-normalized inputs (reference quirk, ref:07adv:150),
Adam(2e-4). Default task: blur.

The perceptual VGG uses the trained judge's features (--judge), since
ImageNet weights are unobtainable offline (documented deviation)."""

import functools

import torch

from tsr_tpu_torch import configs, losses, zoo
from tsr_tpu_torch.data import gtsrb
from tsr_tpu_torch.scripts._common import (ANCHOR_WARNING, CHECKPOINT_HELP,
                                           PROCESSED, base_parser,
                                           ensure_clean_tree, identity_anchor,
                                           judge_ckpt_path, mesh_from_args,
                                           num_classes, parse,
                                           restorer_ckpt_path,
                                           restorer_provenance)
from tsr_tpu_torch.train import common, loops

def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--task", default="blur")
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--perceptual-weight", type=float, default=0.1)
    p.add_argument("--judge", default=None,
                   help="judge checkpoint for perceptual features ("
                        + CHECKPOINT_HELP + "); 'none' disables the "
                        "perceptual term")
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--distorted-dir", default=None)
    p.add_argument("--save", default=None)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (params stay f32)")
    p.add_argument("--host-stream", action="store_true",
                   help="stream batches from host per step instead of the "
                        "device-resident loop (automatic with --mesh)")
    p.add_argument("--workers", type=int, default=8,
                   help="native decode threads of the host-streamed loader")
    p.add_argument("--identity-frac", type=float, default=0.0,
                   help="fraction of extra clean->clean training pairs "
                        "(identity anchor; see script 07). 0 reproduces "
                        "the reference recipe exactly.")
    p.add_argument("--input-minmax", action="store_true",
                   help="per-image min-max stretch in front of the UNet "
                        "(see script 07; recommended for --task fog)")
    args = parse(p, argv, mesh_script=__file__)
    if args.judge is None:
        args.judge = judge_ckpt_path(args)
    cfg = configs.AdvancedTrainConfig(
        task=args.task, batch_size=args.batch_size, epochs=args.epochs,
        learning_rate=args.lr, perceptual_weight=args.perceptual_weight,
        seed=args.seed)
    dtype = torch.bfloat16 if args.bf16 else torch.float32

    clean = ensure_clean_tree(args)
    distorted = args.distorted_dir or f"{PROCESSED}/{args.task.capitalize()}"
    save = args.save or restorer_ckpt_path(args.task, args)

    ds = gtsrb.PairedFolder(clean, distorted, size=args.image_size,
                            threads=args.workers)
    print(f"Matched pairs: {len(ds)}")
    tr_idx, va_idx = gtsrb.train_val_split(len(ds), cfg.train_split,
                                           cfg.seed)

    vgg_apply = None
    if args.judge != "none":
        # frozen features[:16] of the judge, un-normalized input
        judge = zoo.load_model("vgg16", args.judge, args.image_size,
                               num_classes=num_classes(args, clean),
                               dtype=dtype, device=args.device)
        vgg_apply = losses.perceptual_features(judge)

    unet = zoo.build_simple_unet(dtype=dtype,
                                 input_minmax=args.input_minmax,
                                 device=args.device)
    state = common.create_restoration_state(unet, cfg)
    ckpt_config = restorer_provenance(distorted, args.identity_frac,
                                      args.input_minmax)

    # resident size includes the identity anchor's duplicates (see 07)
    n_eff = len(ds) * (1.0 + args.identity_frac * cfg.train_split)
    fits = 2 * n_eff * args.image_size ** 2 * 3 < 8e9
    mesh = mesh_from_args(args)
    resident = fits and mesh is None and not args.host_stream
    if args.identity_frac > 0 and not resident:
        print(ANCHOR_WARNING)
    if resident:
        bad, clean_arr = ds.load_batch(range(len(ds)))
        if args.identity_frac > 0:
            bad, clean_arr, tr_idx = identity_anchor(
                bad, clean_arr, tr_idx, args.identity_frac, cfg.seed)
        loops.train_restorer_on_device(
            state, bad, clean_arr, tr_idx, va_idx, epochs=cfg.epochs,
            batch_size=cfg.batch_size, pixel="l1",
            perceptual_weight=cfg.perceptual_weight, vgg_apply=vgg_apply,
            save_path=save, ckpt_config=ckpt_config, seed=cfg.seed,
            device=args.device)
    else:
        step = common.make_restoration_train_step(
            pixel="l1", perceptual_weight=cfg.perceptual_weight,
            vgg_apply=vgg_apply)
        evalf = common.make_restoration_eval_step(
            pixel="l1", perceptual_weight=cfg.perceptual_weight,
            vgg_apply=vgg_apply)
        mk = functools.partial(gtsrb.batches, ds, batch_size=cfg.batch_size)
        loops.train_restorer(
            state,
            train_batches=lambda ep: mk(indices=tr_idx, seed=cfg.seed + ep),
            val_batches=lambda: mk(indices=va_idx, shuffle=False,
                                   drop_remainder=False),
            epochs=cfg.epochs, step_fn=step, eval_fn=evalf, save_path=save,
            ckpt_config=ckpt_config, device=args.device, mesh=mesh)
    print(f"Done. Checkpoint at {save}")


if __name__ == "__main__":
    main()
