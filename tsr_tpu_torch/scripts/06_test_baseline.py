"""Judge accuracy over {clean, noisy, blurred, foggy} trees (ref:06)."""

import os

from tsr_tpu_torch import eval as tsr_eval
from tsr_tpu_torch import zoo
from tsr_tpu_torch.scripts._common import (CHECKPOINT_HELP, PROCESSED,
                                           add_int8_flag, add_resize_flag,
                                           base_parser, ensure_clean_tree,
                                           judge_ckpt_path, maybe_int8_judge,
                                           mesh_from_args, num_classes, parse)
from tsr_tpu_torch.utils import reporting


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--model", default=None, help=CHECKPOINT_HELP)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--batchnorm", action="store_true")
    add_int8_flag(p)
    add_resize_flag(p)
    args = parse(p, argv, mesh_script=__file__)
    args.model = args.model or judge_ckpt_path(args)
    clean = ensure_clean_tree(args)

    judge = zoo.load_model("vgg16", args.model, args.image_size,
                           num_classes=num_classes(args, clean),
                           use_batchnorm=args.batchnorm, device=args.device)
    judge = maybe_int8_judge(args, judge)
    test_dirs = {
        "Clean (Original)": clean,
        "Noisy": f"{PROCESSED}/Noise",
        "Blurred": f"{PROCESSED}/Blur",
        "Foggy": f"{PROCESSED}/Fog",
    }
    results = {}
    for name, path in test_dirs.items():
        if not os.path.exists(path):
            print(f"Skipping {name}: {path} not found")
            continue
        r = tsr_eval.evaluate_directory(
            judge, path, batch_size=args.batch_size, size=args.image_size,
            resize=args.resize, device=args.device,
            mesh=mesh_from_args(args))
        results[name] = r["top1"]
        print(f"Result [{name}] Accuracy: {r['top1'] * 100:.2f}% "
              f"({r['images_per_sec']} img/s)")
    print(reporting.accuracy_report(results, "Final Test Report (Baseline 1)"))


if __name__ == "__main__":
    main()
