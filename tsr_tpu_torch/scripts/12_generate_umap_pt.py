"""GAP embeddings over 7 modes + 2-D projection export (ref:12).

Samples N same-named images per mode, extracts VGG features.30 -> GAP 512-d
vectors, projects to 2-D with the port's UMAP (tsr_tpu_torch.umap_lite;
reference parameters, ref:12:131-139), and saves the reference-schema dict
{embeddings, labels, original_features} to umap_embeddings.pt, plus a
scatter figure where matplotlib is installed."""

import importlib.util
import random
from pathlib import Path

import numpy as np

from tsr_tpu_torch import interpret, viz, zoo
from tsr_tpu_torch.data import gtsrb
from tsr_tpu_torch.models.vgg import GAP_TAP
from tsr_tpu_torch.scripts._common import (CHECKPOINT_HELP, PROCESSED,
                                           RESTORED, base_parser,
                                           ensure_clean_tree, judge_ckpt_path,
                                           num_classes, parse)


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--model", default=None, help=CHECKPOINT_HELP)
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--samples-per-mode", type=int, default=100)
    p.add_argument("--method", default="umap",
                   choices=["umap", "tsne", "pca"])
    p.add_argument("--out-pt", default="umap_embeddings.pt")
    p.add_argument("--out-img", default="umap_visualization.png")
    args = parse(p, argv)
    args.model = args.model or judge_ckpt_path(args)
    clean_root = Path(ensure_clean_tree(args))

    judge = zoo.load_model("vgg16", args.model, args.image_size,
                           num_classes=num_classes(args, clean_root),
                           device=args.device)

    modes = {
        "Clean": clean_root,
        "Noise (Bad)": Path(PROCESSED) / "Noise",
        "Noise (Restored)": Path(RESTORED) / "Noise",
        "Blur (Bad)": Path(PROCESSED) / "Blur",
        "Blur (Restored)": Path(RESTORED) / "Blur",
        "Fog (Bad)": Path(PROCESSED) / "Fog",
        "Fog (Restored)": Path(RESTORED) / "Fog",
    }

    files = sorted(f for f in clean_root.glob("*/*")
                   if f.suffix.lower() in gtsrb.IMG_EXTENSIONS)
    random.seed(42)  # ref:12 fixes seeds
    if len(files) > args.samples_per_mode:
        files = random.sample(files, args.samples_per_mode)

    mode_batches = {}
    for mode, root in modes.items():
        paths = []
        for f in files:
            rel = f.relative_to(clean_root)
            target = f if mode == "Clean" else root / rel
            if not target.exists():
                target = target.with_suffix(".png")
            if target.exists():
                paths.append(str(target))
        if paths:
            mode_batches[mode] = gtsrb._decode_resize_batch(
                paths, args.image_size)
        else:
            print(f"Skipping mode '{mode}': no files")

    feats = interpret.collect_mode_embeddings(
        judge, mode_batches, tap_layer=judge.tap_index(GAP_TAP))
    all_feats = np.concatenate([feats[m] for m in mode_batches])
    all_labels = sum(([m] * len(feats[m]) for m in mode_batches), [])
    print(f"Features: {all_feats.shape}")

    emb = interpret.project_2d(all_feats, method=args.method, seed=42)
    interpret.export_embeddings_pt(args.out_pt, emb, all_labels, all_feats)
    if importlib.util.find_spec("matplotlib") is None:
        print(f"Saved {args.out_pt}; {args.out_img} not drawn: matplotlib "
              "is not installed")
        return
    viz.embedding_scatter(emb, all_labels, args.out_img)
    print(f"Saved {args.out_pt} and {args.out_img}")


if __name__ == "__main__":
    main()
