"""Unified single-image demo (ref:15): compound distort (Fog->Noise->Blur),
blind ResUNet restore, VGG confidence on clean/bad/restored, 1x3 figure
(needs matplotlib)."""

import random
from pathlib import Path

import torch

from tsr_tpu_torch import native, pipeline, viz, zoo
from tsr_tpu_torch.data import gtsrb
from tsr_tpu_torch.ops import distortions
from tsr_tpu_torch.ops import image as image_ops
from tsr_tpu_torch.scripts._common import (CHECKPOINT_HELP, base_parser,
                                           ensure_clean_tree, judge_ckpt_path,
                                           num_classes, parse,
                                           unified_ckpt_path)


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--model", default=None, help=CHECKPOINT_HELP)
    p.add_argument("--unified", default=None, help=CHECKPOINT_HELP)
    p.add_argument("--sample", default=None,
                   help="relative path of the sample inside the clean tree "
                        "(the reference hardcodes its demo sample, "
                        "ref:15:20)")
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--out", default="unified_test_result.png")
    args = parse(p, argv)
    args.model = args.model or judge_ckpt_path(args)
    args.unified = args.unified or unified_ckpt_path(args)
    clean_root = Path(ensure_clean_tree(args))
    dev, size = args.device, args.image_size

    judge = zoo.load_model("vgg16", args.model, size,
                           num_classes=num_classes(args, clean_root),
                           device=dev)
    resunet = zoo.load_model("resunet", args.unified, size, device=dev)

    files = sorted(f for f in clean_root.glob("*/*")
                   if f.suffix.lower() in gtsrb.IMG_EXTENSIONS)
    if args.sample:
        pick = clean_root / args.sample
        if not pick.exists():
            raise SystemExit(f"--sample {args.sample}: {pick} not found")
    else:
        random.seed(args.seed)
        pick = random.choice(files)
    print(f"Sample: {pick.relative_to(clean_root)}")
    clean = gtsrb._decode_resize(str(pick), size)[None]

    # the compound distortion applies at native resolution (ref:15:170-174
    # distorts the raw image; only the tensor path resizes to 224), then
    # the device resizes it (the cv2 INTER_LINEAR convention)
    native_img = torch.from_numpy(native.decode(str(pick))).to(dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    bad_native = distortions.make_compound_distortion(native_img, gen,
                                                      device=dev)
    bad = image_ops.resize_from_padded(
        bad_native[None], torch.tensor([native_img.shape[:2]], device=dev),
        size)

    out = pipeline.unified_demo(clean, resunet, judge, gen, bad_u8=bad,
                                device=dev)
    j = out["judge"]
    caps = [
        f"Clean — pred {int(j['clean']['pred'][0])} "
        f"({float(j['clean']['confidence'][0]):.2f})",
        f"Compound Distorted — pred {int(j['bad']['pred'][0])} "
        f"({float(j['bad']['confidence'][0]):.2f})",
        f"Unified Restored — pred {int(j['restored']['pred'][0])} "
        f"({float(j['restored']['confidence'][0]):.2f})",
    ]
    viz.demo_figure(clean[0], out["bad_u8"][0], out["restored_u8"][0],
                    caps, args.out)
    for c in caps:
        print(c)
    print(f"Saved {args.out}")


if __name__ == "__main__":
    main()
