"""Generate the fog dataset (ref:04): I = J*t + A*(1-t), intensity 0.8,
per-image t jitter, batched on the device, into ./data/processed/Fog."""

from tsr_tpu_torch import offline
from tsr_tpu_torch.scripts._common import (PROCESSED, base_parser,
                                           ensure_clean_tree, parse)


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--dst", default=f"{PROCESSED}/Fog")
    p.add_argument("--strength-jitter", action="store_true",
                   help="draw intensity per image from U[0.05,0.85] "
                        "(t = 1 - i) instead of the fixed 0.8 — covers the "
                        "mild cascade point t=0.9 (ref:13:51) the fixed "
                        "tree never shows the restorer")
    args = parse(p, argv)
    kind = "fog_rand" if args.strength_jitter else "fog"
    offline.generate_tree(ensure_clean_tree(args), args.dst, kind,
                          seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
