"""Batched unified ResUNet restoration of the Compound tree (ref:17)."""

from tsr_tpu_torch import infer, zoo
from tsr_tpu_torch.scripts._common import (CHECKPOINT_HELP, PROCESSED,
                                           RESTORED, base_parser,
                                           ensure_clean_tree, parse,
                                           unified_ckpt_path)


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--model", default=None, help=CHECKPOINT_HELP)
    p.add_argument("--distorted-dir", default=f"{PROCESSED}/Compound")
    p.add_argument("--restored-dir", default=f"{RESTORED}/Compound")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--resize", default="device",
                   choices=["device", "host"],
                   help="see script 08 — device is the default")
    p.add_argument("--metrics", action="store_true",
                   help="also compute PSNR/SSIM vs the clean tree "
                        "(ref:17 computes none)")
    args = parse(p, argv)
    args.model = args.model or unified_ckpt_path(args)
    resunet = zoo.load_model("resunet", args.model, args.image_size,
                             device=args.device)
    clean = ensure_clean_tree(args) if args.metrics else None
    infer.restore_tree(
        resunet, distorted_dir=args.distorted_dir,
        restored_dir=args.restored_dir, clean_dir=clean,
        batch_size=args.batch_size, size=args.image_size,
        compute_metrics=args.metrics, resize=args.resize, device=args.device)


if __name__ == "__main__":
    main()
