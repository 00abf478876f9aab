"""VGG hidden-state heatmaps (ref:11): tap layer 2 (relu1_2), channel-mean
+ min-max, 3 tasks x {input, clean, bad, restored} grid (needs
matplotlib).

Deviation: the reference taps an ImageNet-pretrained VGG (ref:11:59-62);
offline we tap the trained judge instead (--model)."""

from pathlib import Path

import numpy as np

from tsr_tpu_torch import interpret, viz, zoo
from tsr_tpu_torch.data import gtsrb
from tsr_tpu_torch.models.vgg import HIDDEN_STATE_TAP
from tsr_tpu_torch.scripts._common import (CHECKPOINT_HELP, PROCESSED,
                                           RESTORED, base_parser,
                                           ensure_clean_tree, judge_ckpt_path,
                                           num_classes, parse)


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--model", default=None, help=CHECKPOINT_HELP)
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--sample", default=None,
                   help="relative path of the sample image "
                        "(default: first found)")
    p.add_argument("--layer", type=int, default=HIDDEN_STATE_TAP,
                   help="feature tap in plain-vgg16 (reference) indexing; "
                        "translated automatically for a batchnorm judge")
    p.add_argument("--out", default="hidden_state_visualization.png")
    args = parse(p, argv)
    args.model = args.model or judge_ckpt_path(args)
    clean_root = Path(ensure_clean_tree(args))

    judge = zoo.load_model("vgg16", args.model, args.image_size,
                           num_classes=num_classes(args, clean_root),
                           device=args.device)
    tap = interpret.make_tap_fn(judge, tap_layer=judge.tap_index(args.layer))

    if args.sample:
        rel = Path(args.sample)
    else:
        files = sorted(f for f in clean_root.glob("*/*")
                       if f.suffix.lower() in gtsrb.IMG_EXTENSIONS)
        rel = files[0].relative_to(clean_root)
    print(f"Sample: {rel}, tap layer {args.layer}")

    def load(p):
        return gtsrb._decode_resize(str(p), args.image_size)

    rows, names = [], []
    for task in ("Noise", "Blur", "Fog"):
        bad = Path(PROCESSED) / task / rel
        if not bad.exists():
            bad = bad.with_suffix(".png")
        res = (Path(RESTORED) / task / rel).with_suffix(".png")
        if not (bad.exists() and res.exists()):
            print(f"Skipping {task}: missing {bad} or {res}")
            continue
        imgs = np.stack([load(clean_root / rel), load(bad), load(res)])
        hms = interpret.heatmap(tap(imgs))
        rows.append({"input": imgs[2], "clean": hms[0], "bad": hms[1],
                     "restored": hms[2]})
        names.append(task)
    if rows:
        viz.hidden_state_grid(rows, args.out, names)
        print(f"Saved {args.out}")
    else:
        print("Nothing to visualize — generate + restore the trees first.")


if __name__ == "__main__":
    main()
