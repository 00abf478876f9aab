"""Cascade stress test (ref:13): N random clean images, step-by-step
Blur->Fog->Noise distortion (mild params), chained Noise->Fog->Blur
restoration through the three specialized U-Nets (raw tensor between
stages), VGG confidence at all 7 stages, per-image 2x4 figure (needs
matplotlib) + mean confidence report."""

import random
from pathlib import Path

import torch

from tsr_tpu_torch import configs, native, pipeline, viz, zoo
from tsr_tpu_torch.data import gtsrb
from tsr_tpu_torch.ops import distortions
from tsr_tpu_torch.ops import image as image_ops
from tsr_tpu_torch.scripts._common import (CHECKPOINT_HELP, base_parser,
                                           ensure_clean_tree, judge_ckpt_path,
                                           num_classes, parse,
                                           restorer_ckpt_path)


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--num-samples", type=int, default=10)
    p.add_argument("--model", default=None, help=CHECKPOINT_HELP)
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--out-dir", default="pipeline_results")
    args = parse(p, argv)
    args.model = args.model or judge_ckpt_path(args)
    clean_root = Path(ensure_clean_tree(args))
    dev, size = args.device, args.image_size

    judge = zoo.load_model("vgg16", args.model, size,
                           num_classes=num_classes(args, clean_root),
                           device=dev)
    # per-task modules: each checkpoint's config may change the
    # architecture (e.g. the fog restorer's input_minmax stretch)
    restorers, task_cfgs = {}, {}
    for task in ("noise", "fog", "blur"):
        path = restorer_ckpt_path(task, args)
        restorers[task] = zoo.load_model("simple_unet", path, size,
                                         device=dev)
        task_cfgs[task] = zoo.checkpoint_config(path)
    variant, variant_desc = pipeline.cascade_variant(task_cfgs)

    files = sorted(f for f in clean_root.glob("*/*")
                   if f.suffix.lower() in gtsrb.IMG_EXTENSIONS)
    random.seed(args.seed)
    picks = random.sample(files, min(args.num_samples, len(files)))

    # Phase-1 distortions apply at NATIVE resolution (ref:13:147-169 works
    # on the raw image; only the restoration tensor path resizes to 224,
    # ref:13:176) — then every stage is resized on the device (the cv2
    # INTER_LINEAR convention, ops.image.resize_from_padded)
    mild = configs.MildConfig()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    stage_imgs = {name: [] for name in
                  ("Clean", "+ Blur", "+ Fog", "+ Noise (final bad)")}
    for f in picks:
        x = torch.from_numpy(native.decode(str(f))).to(dev)
        hw = torch.tensor([x.shape[:2]], device=dev)
        blur = distortions.mild_blur(x, mild, device=dev)
        fog = distortions.mild_fog(blur, mild, device=dev)
        noise = distortions.mild_noise(fog, gen, mild, device=dev)
        for name, img in zip(stage_imgs, (x, blur, fog, noise)):
            stage_imgs[name].append(
                image_ops.resize_from_padded(img[None], hw, size))
    stages = [(name, torch.cat(imgs)) for name, imgs in stage_imgs.items()]
    batch = stages[0][1]

    out = pipeline.cascade_stress(batch, restorers, judge, gen,
                                  precomputed_stages=stages, device=dev)

    outdir = Path(args.out_dir)
    outdir.mkdir(exist_ok=True)
    for i in range(len(batch)):
        per_image = [(name, imgs[i]) for name, imgs in out["stages"]]
        annot = [f"pred {int(out['preds'][k][i])} "
                 f"conf {float(out['confidences'][k][i]):.2f}"
                 for k in range(len(per_image))]
        viz.cascade_figure(
            per_image, annot, str(outdir / f"pipeline_sample_{i + 1}.png"),
            caption=f"cascade restorer variant {variant}: {variant_desc}")

    mc = out["mean_confidence"]
    print("=" * 40)
    print("Mean confidence report")
    print("=" * 40)
    print(f"Clean:     {mc['clean']:.4f}")
    print(f"Distorted: {mc['distorted']:.4f}")
    print(f"Restored:  {mc['restored']:.4f}")
    print(f"Restorer variant: {variant} ({variant_desc})")
    print("Measured net-confidence delta by variant "
          "(RESULTS.md cascade section; ref:13 = +0.103): "
          + ", ".join(f"{k} {d:+.3f}"
                      for k, (_, d) in pipeline.VARIANT_TABLE.items()))
    print(f"Figures in {outdir}/")


if __name__ == "__main__":
    main()
