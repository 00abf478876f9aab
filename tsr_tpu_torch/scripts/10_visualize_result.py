"""3x3 clean/distorted/restored comparison grid (ref:10), saved to
result_visualization.png (needs matplotlib)."""

import random
from pathlib import Path

from tsr_tpu_torch import native, viz
from tsr_tpu_torch.data import gtsrb
from tsr_tpu_torch.scripts._common import (PROCESSED, RESTORED, base_parser,
                                           ensure_clean_tree, parse)


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--out", default="result_visualization.png")
    args = parse(p, argv)
    clean_root = Path(ensure_clean_tree(args))

    files = sorted(clean_root.glob("*/*"))
    files = [f for f in files if f.suffix.lower() in gtsrb.IMG_EXTENSIONS]
    random.seed(args.seed)
    target = random.choice(files)
    rel = target.relative_to(clean_root)
    print(f"Visualizing: {rel}")

    clean = native.decode(str(target))
    distorted, restored = {}, {}
    for task in ("Noise", "Blur", "Fog"):
        bad = Path(PROCESSED) / task / rel
        if not bad.exists():
            bad = bad.with_suffix(".png")
        res = (Path(RESTORED) / task / rel).with_suffix(".png")
        if bad.exists():
            distorted[task] = native.decode(str(bad))
        if res.exists():
            restored[task] = native.decode(str(res))
    viz.comparison_grid(clean, distorted, restored, args.out)
    print(f"Saved {args.out}")


if __name__ == "__main__":
    main()
