"""Judge accuracy over {clean, compound, unified-restored} (ref:18), plus
the fully-fused on-device variant (no restored tree on disk needed)."""

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
                                           unified_ckpt_path)
from tsr_tpu_torch.utils import reporting


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--model", default=None, help=CHECKPOINT_HELP)
    p.add_argument("--unified", default=None, help=CHECKPOINT_HELP)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--fused", action="store_true",
                   help="restore on the fly inside the eval step instead "
                        "of reading data/restored from disk")
    add_int8_flag(p)
    add_resize_flag(p)
    args = parse(p, argv, mesh_script=__file__)
    args.model = args.model or judge_ckpt_path(args)
    args.unified = args.unified or unified_ckpt_path(args)
    clean = ensure_clean_tree(args)

    judge = zoo.load_model("vgg16", args.model, args.image_size,
                           num_classes=num_classes(args, clean),
                           device=args.device)
    judge = maybe_int8_judge(args, judge)

    def evaluate(path, restorer=None):
        return tsr_eval.evaluate_directory(
            judge, path, batch_size=args.batch_size, size=args.image_size,
            restorer=restorer, resize=args.resize, device=args.device,
            mesh=mesh_from_args(args))

    results = {}
    for name, path in (("Clean", clean),
                       ("Compound (Bad)", f"{PROCESSED}/Compound")):
        if not os.path.exists(path):
            print(f"Skipping {name}: {path} not found")
            continue
        r = evaluate(path)
        results[name] = r["top1"]
        print(f"Result [{name}] Accuracy: {r['top1'] * 100:.2f}% "
              f"({r['images_per_sec']} img/s)")

    if args.fused:
        resunet = zoo.load_model("resunet", args.unified, args.image_size,
                                 device=args.device)
        r = evaluate(f"{PROCESSED}/Compound",
                     restorer=maybe_int8_restorer(args, resunet))
        results["Unified Restored (fused)"] = r["top1"]
        print(f"Result [Unified Restored (fused)] Accuracy: "
              f"{r['top1'] * 100:.2f}%")
    elif os.path.exists(f"{RESTORED}/Compound"):
        r = evaluate(f"{RESTORED}/Compound")
        results["Unified Restored"] = r["top1"]
        print(f"Result [Unified Restored] Accuracy: {r['top1'] * 100:.2f}%")

    print(reporting.accuracy_report(
        results, "Final Test Report (Unified Model)"))


if __name__ == "__main__":
    main()
