"""Restore the specialized task trees and report PSNR/SSIM (ref:08) —
batched on the device instead of the reference's per-image batch-1 loop."""

import os

from tsr_tpu_torch import infer, zoo
from tsr_tpu_torch.scripts._common import (PROCESSED, RESTORED, base_parser,
                                           ensure_clean_tree, parse,
                                           restorer_ckpt_path)


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--tasks", nargs="+", default=["noise", "blur", "fog"])
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--resize", default="device",
                   choices=["device", "host"],
                   help="resize natives on the device (<=1 LSB vs cv2) or "
                        "on the host (exact reference semantics)")
    args = parse(p, argv)
    clean = ensure_clean_tree(args)

    for task in args.tasks:
        model_path = restorer_ckpt_path(task, args)
        if not os.path.exists(model_path):
            print(f"Warning: model {model_path} not found, skipping {task}.")
            continue
        print(f"\n=== Task: {task} ===")
        unet = zoo.load_model("simple_unet", model_path, args.image_size,
                              device=args.device)
        infer.restore_tree(
            unet,
            distorted_dir=f"{PROCESSED}/{task.capitalize()}",
            restored_dir=f"{RESTORED}/{task.capitalize()}",
            clean_dir=clean, batch_size=args.batch_size,
            size=args.image_size, resize=args.resize, device=args.device)


if __name__ == "__main__":
    main()
