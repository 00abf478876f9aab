"""Fetch the GTSRB training split (ref:01:5-18), or build a synthetic tree
with --synthetic without a network."""

from tsr_tpu_torch.scripts._common import base_parser, ensure_clean_tree, parse


def main(argv=None):
    args = parse(base_parser(__doc__), argv)
    if args.synthetic:
        path = ensure_clean_tree(args)
    else:
        from tsr_tpu_torch.data import gtsrb

        path = gtsrb.download_gtsrb("./data")
    print(f"Data ready at: {path}")


if __name__ == "__main__":
    main()
