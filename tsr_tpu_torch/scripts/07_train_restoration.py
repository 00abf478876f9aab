"""Train a specialized SimpleUNet restorer per task (ref:07): MSE + Adam
(1e-3), 15 epochs, BS 32, 90/10 split, checkpoint every 5 epochs.

Unlike the reference's edit-TASK_NAME-and-rerun pattern (ref:07:13-15), the
task is a flag: --task noise|blur|fog.
"""

import functools
import os

import torch

from tsr_tpu_torch import configs, zoo
from tsr_tpu_torch.data import gtsrb
from tsr_tpu_torch.scripts._common import (ANCHOR_WARNING, PROCESSED,
                                           base_parser, ensure_clean_tree,
                                           identity_anchor, mesh_from_args,
                                           parse,
                                           restorer_ckpt_path,
                                           restorer_provenance)
from tsr_tpu_torch.train import common, loops

def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--task", default="noise",
                   choices=["noise", "blur", "fog", "compound"])
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--distorted-dir", default=None)
    p.add_argument("--save", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (params stay f32)")
    p.add_argument("--host-stream", action="store_true",
                   help="stream batches from host per step instead of the "
                        "device-resident loop (automatic with --mesh)")
    p.add_argument("--workers", type=int, default=8,
                   help="native decode threads of the host-streamed loader")
    p.add_argument("--identity-frac", type=float, default=0.0,
                   help="fraction of extra clean->clean training pairs "
                        "(identity anchor): trained on the fixed-severity "
                        "tree alone (ref:07:122-135) the inverse is "
                        "unconditional and over-corrects mild inputs; 0 "
                        "reproduces the reference recipe exactly. "
                        "Device-resident loop only.")
    p.add_argument("--input-minmax", action="store_true",
                   help="per-image min-max stretch in front of the UNet "
                        "(recorded in the checkpoint, applied by every "
                        "load path); recommended for --task fog, a global "
                        "affine map the UNet's receptive field cannot "
                        "estimate")
    args = parse(p, argv, mesh_script=__file__)
    cfg = configs.RestorationTrainConfig(
        task=args.task, batch_size=args.batch_size, epochs=args.epochs,
        learning_rate=args.lr, seed=args.seed)

    clean = ensure_clean_tree(args)
    distorted = args.distorted_dir or f"{PROCESSED}/{args.task.capitalize()}"
    ckpt_config = restorer_provenance(distorted, args.identity_frac,
                                      args.input_minmax)
    save = args.save or restorer_ckpt_path(args.task, args)

    ds = gtsrb.PairedFolder(clean, distorted, size=args.image_size,
                            threads=args.workers)
    print(f"Matched pairs: {len(ds)}")
    tr_idx, va_idx = gtsrb.train_val_split(len(ds), cfg.train_split,
                                           cfg.seed)

    unet = zoo.build_simple_unet(
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        input_minmax=args.input_minmax, device=args.device)
    state = common.create_restoration_state(unet, cfg)
    if args.resume and os.path.exists(os.path.join(save, "train")):
        state = zoo.load_train_state(save, state)
        print(f"Resumed from {save} at step {int(state.step)}")

    # both trees resident, plus the identity anchor's duplicates
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
            batch_size=cfg.batch_size, pixel="mse", perceptual_weight=0.0,
            save_path=save, checkpoint_every=cfg.checkpoint_every,
            ckpt_config=ckpt_config, seed=cfg.seed, device=args.device)
    else:
        step = common.make_restoration_train_step(pixel="mse")
        evalf = common.make_restoration_eval_step(pixel="mse")
        mk = functools.partial(gtsrb.batches, ds, batch_size=cfg.batch_size)
        loops.train_restorer(
            state,
            train_batches=lambda ep: mk(indices=tr_idx, seed=cfg.seed + ep),
            val_batches=lambda: mk(indices=va_idx, shuffle=False,
                                   drop_remainder=False),
            epochs=cfg.epochs, step_fn=step, eval_fn=evalf, save_path=save,
            checkpoint_every=cfg.checkpoint_every, ckpt_config=ckpt_config,
            device=args.device, mesh=mesh)
    print(f"Done. Checkpoint at {save}")


if __name__ == "__main__":
    main()
