"""Generate the compound dataset (ref:16): Blur(10,45) -> Fog(0.5) ->
Noise(0.02), saved as .png, into ./data/processed/Compound (the blur on
kernel B3 on the card)."""

from tsr_tpu_torch import offline
from tsr_tpu_torch.scripts._common import (PROCESSED, base_parser,
                                           ensure_clean_tree, parse)


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--dst", default=f"{PROCESSED}/Compound")
    args = parse(p, argv)
    offline.generate_tree(ensure_clean_tree(args), args.dst, "compound",
                          seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
