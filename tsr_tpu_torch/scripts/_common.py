"""Shared plumbing for the port's numbered scripts.

Port of the reference package's ``scripts/_common.py``: each script mirrors
one reference script's behaviour and default paths (SURVEY.md §2) as a thin
wrapper over ``tsr_tpu_torch``, with argparse flags instead of
edit-the-constants (ref:07:13-15). ``--synthetic`` builds a synthetic sign
tree first, so every script runs without a network.

Two flags differ from the JAX package's scripts:

- ``--device`` (default ``cuda``) picks the device through
  ``device.resolve_device``, which raises where CUDA is asked for and
  absent: no script falls back to the CPU on its own;
- ``--mesh`` is accepted but refused: the port has no multi-device path
  yet (ROADMAP queue A item 10).

Checkpoints: the scripts write the port's checkpoint directories
(``zoo.save_checkpoint``) and read those and reference-format ``.pth``
files; orbax directories written by the JAX package's scripts are refused
(``zoo.load_model`` says how to migrate them).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from pathlib import Path

from tsr_tpu_torch.device import resolve_device

DATA_ROOT = "./data"
CLEAN_DIR = "./data/gtsrb/GTSRB/Training"
PROCESSED = "./data/processed"
RESTORED = "./data/restored"

CKPT_DIR = "./checkpoints"

CHECKPOINT_HELP = ("a checkpoint directory written by the port's scripts "
                   "(zoo.save_checkpoint) or a reference-format .pth file; "
                   "orbax directories of the JAX package are not read")


def base_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--clean-dir", default=os.environ.get(
        "TSR_GTSRB_DIR", CLEAN_DIR))
    p.add_argument("--synthetic", action="store_true",
                   help="generate a synthetic sign tree at --clean-dir "
                        "if it does not exist")
    p.add_argument("--synthetic-classes", type=int, default=10)
    p.add_argument("--synthetic-per-class", type=int, default=40)
    p.add_argument("--image-size", type=int, default=224,
                   help="model input resolution (reference: 224)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt-dir", default=os.environ.get(
        "TSR_CKPT_DIR", CKPT_DIR))
    p.add_argument("--resize-backend", default="cv2",
                   choices=["cv2", "pil"],
                   help="host decode-resize backend; 'pil' gives bit "
                        "parity with the reference's torchvision "
                        "Resize (matters only for >image-size sources; "
                        "see PARITY.md 'Resize parity')")
    p.add_argument("--mesh", default=None, metavar="SPEC",
                   help="device mesh for sharding, e.g. 'data=8'; not "
                        "supported by the port yet (ROADMAP queue A item "
                        "10): any value exits with an error")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'; the port never falls "
                        "back to the CPU on its own")
    return p


def parse(p: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
    """Parse ``argv`` (None: the command line), refuse ``--mesh`` and
    resolve ``--device`` into a ``torch.device`` (raises where CUDA is
    asked for and absent)."""
    args = p.parse_args(argv)
    if args.mesh:
        raise SystemExit(
            f"--mesh {args.mesh}: the PyTorch port has no multi-device path "
            "yet (ROADMAP queue A item 10, parallel/ and the mesh= "
            "arguments); run on one device without --mesh")
    args.device = resolve_device(args.device)
    return args


def add_resize_flag(p):
    """--resize for the eval harnesses (scripts 06/09/18). Default host =
    the reference's exact input semantics (the accuracy-parity mode);
    'device' uploads native-resolution pixels and resizes on the card
    (<=1 LSB vs cv2, PARITY.md) — the serving-throughput mode."""
    p.add_argument("--resize", default="host", choices=["host", "device"])
    return p


def add_int8_flag(p):
    """--int8 for the accuracy/serving harnesses (scripts 06/09/18)."""
    p.add_argument("--int8", action="store_true",
                   help="quantize the judge to int8 (per-channel weights, "
                        "dynamic activations) and classify on the int8 "
                        "matrix path — serving mode; see "
                        "tsr_tpu_torch/quant.py")
    return p


def maybe_int8_judge(args, judge):
    """The judge module honoring ``--int8``."""
    if getattr(args, "int8", False):
        from tsr_tpu_torch import quant

        return quant.quantized_judge(judge)
    return judge


def maybe_int8_restorer(args, model):
    """The restorer module honoring ``--int8`` (the fp modules are loaded
    in eval mode already)."""
    if getattr(args, "int8", False):
        from tsr_tpu_torch import quant

        return quant.quantized_restorer(model)
    return model


def ensure_clean_tree(args) -> str:
    if getattr(args, "resize_backend", "cv2") != "cv2":
        from tsr_tpu_torch.data import gtsrb

        gtsrb.set_resize_backend(args.resize_backend)
    root = Path(args.clean_dir)
    if args.synthetic and root.exists() and (root / ".synthetic").exists():
        # a previous --synthetic run was interrupted mid-write: the marker
        # is written before the images, so the image count is the ground
        # truth. Rebuild on mismatch. Trees without the marker (real
        # GTSRB) are never touched.
        meta = json.loads((root / ".synthetic").read_text())
        n = len(list(root.glob("*/*")))
        if n != meta["num_classes"] * meta["per_class"]:
            print(f"Synthetic tree at {root} incomplete "
                  f"({n}/{meta['num_classes'] * meta['per_class']}); "
                  "rebuilding.")
            shutil.rmtree(root)
    if not Path(args.clean_dir).exists():
        if args.synthetic:
            from tsr_tpu_torch.data import synthetic

            print(f"Generating synthetic tree at {args.clean_dir} ...")
            # the shipped native-size spread (TREE_SIZE/TREE_JITTER) and
            # the CALIB photometrics: the calibrated configuration
            synthetic.write_image_tree(
                args.clean_dir, num_classes=args.synthetic_classes,
                per_class=args.synthetic_per_class,
                size=synthetic.TREE_SIZE, seed=args.seed,
                size_jitter=synthetic.TREE_JITTER)
        else:
            raise SystemExit(
                f"{args.clean_dir} not found. Run python -m tsr_tpu_torch "
                "download or pass --synthetic.")
    return args.clean_dir


def num_classes(args, clean) -> int:
    """``--num-classes``, else the clean tree's class count."""
    from tsr_tpu_torch.data import gtsrb

    return args.num_classes or len(gtsrb.ImageFolder(clean).classes)


def restorer_provenance(distorted_dir: str, identity_frac: float,
                        input_minmax: bool) -> dict:
    """Checkpoint config for a specialized restorer: architecture options
    plus training provenance (identity-anchor fraction and whether the
    distorted tree was reference-exact or strength-jittered, read from the
    tree's ``.distortion`` marker). pipeline and script 13 derive the
    cascade variant label (RESULTS.md A/B/B'/C) from these keys."""
    cfg: dict = {"identity_frac": float(identity_frac)}
    if input_minmax:
        cfg["input_minmax"] = True
    marker = Path(distorted_dir) / ".distortion"
    if marker.exists():
        try:
            kind = json.loads(marker.read_text()).get("kind", "")
            cfg["severity"] = ("jittered" if kind.endswith("_rand")
                               else "reference")
        except (ValueError, OSError):
            pass
    return cfg


ANCHOR_WARNING = (
    "WARNING: --identity-frac only applies to the device-resident loop; "
    "this run streams from host (doesn't fit device memory, or "
    "--host-stream) and trains WITHOUT the identity anchor.")


def identity_anchor(bad, clean, tr_idx, frac: float, seed: int):
    """Append ``round(len(tr_idx) * frac)`` clean->clean pairs picked from
    the train split (``default_rng(seed)``) to both arrays and to
    ``tr_idx``; the val split stays severe-only. Returns ``(bad, clean,
    tr_idx)``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_id = int(round(len(tr_idx) * frac))
    pick = rng.choice(tr_idx, n_id, replace=False)
    n0 = len(bad)
    bad = np.concatenate([bad, clean[pick]])
    clean = np.concatenate([clean, clean[pick]])
    tr_idx = np.concatenate(
        [tr_idx, np.arange(n0, n0 + n_id, dtype=tr_idx.dtype)])
    print(f"Identity anchor: +{n_id} clean->clean train pairs "
          f"({frac:.0%})")
    return bad, clean, tr_idx


def judge_ckpt_path(args=None) -> str:
    d = getattr(args, "ckpt_dir", None) or os.environ.get(
        "TSR_CKPT_DIR", CKPT_DIR)
    return os.path.join(d, "vgg16_baseline")


def restorer_ckpt_path(task: str, args=None) -> str:
    d = getattr(args, "ckpt_dir", None) or os.environ.get(
        "TSR_CKPT_DIR", CKPT_DIR)
    return os.path.join(d, f"restoration_{task.lower()}")


def unified_ckpt_path(args=None) -> str:
    d = getattr(args, "ckpt_dir", None) or os.environ.get(
        "TSR_CKPT_DIR", CKPT_DIR)
    return os.path.join(d, "restoration_unified_resnet")
