"""Generate the motion-blur dataset (ref:03): degree=12 angle=45 kernel +
min-max renormalize, batched on the device (kernel B3 on the card; B2 with
--strength-jitter), into ./data/processed/Blur."""

from tsr_tpu_torch import offline
from tsr_tpu_torch.scripts._common import (PROCESSED, base_parser,
                                           ensure_clean_tree, parse)


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--dst", default=f"{PROCESSED}/Blur")
    p.add_argument("--strength-jitter", action="store_true",
                   help="draw degree/angle per image (degree U{4..15}, "
                        "angle U[0,360), no min-max epilogue) instead of "
                        "the fixed 12/45 (severity-robust restorer "
                        "training for the ref:13 cascade)")
    args = parse(p, argv)
    kind = "blur_rand" if args.strength_jitter else "blur"
    offline.generate_tree(ensure_clean_tree(args), args.dst, kind,
                          seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
