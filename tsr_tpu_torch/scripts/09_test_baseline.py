"""Judge accuracy over clean + 3 distorted + 3 restored trees (ref:09),
plus a fully-fused on-device variant: with ``--fused``, each task's
Restored row restores the Distorted tree inside the eval step with the
specialized SimpleUNet checkpoint — no ``data/restored`` disk round-trip
(the reference re-reads restored PNGs, ref:09:15-26)."""

import os

from tsr_tpu_torch import eval as tsr_eval
from tsr_tpu_torch import zoo
from tsr_tpu_torch.scripts._common import (CHECKPOINT_HELP, PROCESSED,
                                           RESTORED, add_int8_flag,
                                           add_resize_flag, base_parser,
                                           ensure_clean_tree, judge_ckpt_path,
                                           maybe_int8_judge,
                                           maybe_int8_restorer, mesh_from_args,
                                           num_classes, parse,
                                           restorer_ckpt_path)
from tsr_tpu_torch.utils import reporting


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--model", default=None, help=CHECKPOINT_HELP)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--fused", action="store_true",
                   help="restore on the fly inside the eval step from "
                        "the specialized checkpoints instead of reading "
                        "data/restored from disk")
    add_int8_flag(p)
    add_resize_flag(p)
    args = parse(p, argv, mesh_script=__file__)
    args.model = args.model or judge_ckpt_path(args)
    clean = ensure_clean_tree(args)

    judge = zoo.load_model("vgg16", args.model, args.image_size,
                           num_classes=num_classes(args, clean),
                           device=args.device)
    judge = maybe_int8_judge(args, judge)
    results = {}

    def score(name, path, restorer=None):
        if not os.path.exists(path):
            print(f"Skipping {name}: {path} not found")
            return
        r = tsr_eval.evaluate_directory(
            judge, path, batch_size=args.batch_size, size=args.image_size,
            restorer=restorer, resize=args.resize, device=args.device,
            mesh=mesh_from_args(args))
        results[name] = r["top1"]
        print(f"Result [{name}] Accuracy: {r['top1'] * 100:.2f}% "
              f"({r['images_per_sec']} img/s)")

    score("Clean (Original)", clean)
    for task in ("Noise", "Blur", "Fog"):
        score(f"{task} (Distorted)", f"{PROCESSED}/{task}")
        if args.fused:
            ckpt = restorer_ckpt_path(task, args)
            if not os.path.exists(ckpt):
                print(f"Skipping {task} (Restored, fused): {ckpt} "
                      "not found")
                continue
            unet = zoo.load_model("simple_unet", ckpt, args.image_size,
                                  device=args.device)
            score(f"{task} (Restored, fused)", f"{PROCESSED}/{task}",
                  restorer=maybe_int8_restorer(args, unet))
        else:
            score(f"{task} (Restored)", f"{RESTORED}/{task}")
    print(reporting.accuracy_report(
        results, "Final Test Report (Restoration)"))


if __name__ == "__main__":
    main()
