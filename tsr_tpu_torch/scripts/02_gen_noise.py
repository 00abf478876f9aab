"""Generate the AWGN dataset (ref:02): sigma^2=0.02 noise at native
resolution, batched on the device, into ./data/processed/Noise."""

from tsr_tpu_torch import offline
from tsr_tpu_torch.scripts._common import (PROCESSED, base_parser,
                                           ensure_clean_tree, parse)


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--dst", default=f"{PROCESSED}/Noise")
    p.add_argument("--strength-jitter", action="store_true",
                   help="draw var per image from U[0.005,0.03] instead of "
                        "the fixed 0.02 (severity-robust restorer training; "
                        "ref:13 deploys severe-trained restorers on mild "
                        "inputs)")
    args = parse(p, argv)
    kind = "noise_rand" if args.strength_jitter else "noise"
    offline.generate_tree(ensure_clean_tree(args), args.dst, kind,
                          seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
