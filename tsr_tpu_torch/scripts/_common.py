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
- ``--mesh`` (scripts 05, 06, 07, 07adv, 09, 14 and 18, as in the
  reference; the others refuse it) runs the command on ``data x model``
  ranks, one device each (``parallel.mesh``). Under torchrun the ranks
  join its group, and its world size must be ``data x model``; otherwise
  the command starts the ranks itself (``parallel.launch``, the spawn
  method). Backend: NCCL when every rank has a card of its own, gloo on
  the CPU and when ranks share a card; the ``Mesh:`` line names the
  backend and every rank's device. Only the first rank prints.

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
import sys
from pathlib import Path

from tsr_tpu_torch.device import resolve_device

MESH_COMMANDS = ("train-judge", "eval-baseline", "train-restorer",
                 "train-restorer-advanced", "eval-restoration",
                 "train-unified", "eval-unified")

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
                   help="run on data x model ranks, e.g. 'data=8' or "
                        "'data=4,model=2' (under torchrun: its ranks; "
                        "else started here); only the commands "
                        + ", ".join(MESH_COMMANDS) + " take it")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'; the port never falls "
                        "back to the CPU on its own")
    return p


def parse(p: argparse.ArgumentParser, argv=None,
          mesh_script=None) -> argparse.Namespace:
    """Parse ``argv`` (None: the command line) and resolve ``--device``
    into a ``torch.device`` (raises where CUDA is asked for and absent).

    ``--mesh`` is taken only by a script that passes its own path as
    ``mesh_script``, and refused by the others. In a rank (under
    torchrun, or started here) it joins the group: ``args.mesh`` is the
    rank's ``parallel.mesh.Mesh`` and ``args.device`` its device.
    Otherwise this process starts the ranks, each running the script's
    ``main(argv)``, and exits with their status. ``args.mesh`` is None
    without ``--mesh``. Torch's generators are seeded from ``--seed``, so
    a command's fresh weights are the same from run to run (the reference
    initializes from a fixed key), with or without ``--mesh``."""
    import torch

    args = p.parse_args(argv)
    torch.manual_seed(args.seed)
    if args.mesh and mesh_script is None:
        raise SystemExit(
            f"--mesh {args.mesh}: this command has no multi-device path; "
            "the commands that take --mesh are " + ", ".join(MESH_COMMANDS))
    if args.mesh:
        args.mesh = _join_mesh(args, sys.argv[1:] if argv is None
                               else list(argv), mesh_script)
        args.device = args.mesh.device
    else:
        args.mesh = None
        args.device = resolve_device(args.device)
    return args


def _mesh_axes(spec: str, world=None) -> tuple:
    """``(data, model)`` of a ``--mesh`` spec; ``data=-1`` takes ``world``
    (the torchrun world, else the visible cards)."""
    import torch

    from tsr_tpu_torch.parallel import mesh as pmesh

    try:
        axes = pmesh.parse_mesh_spec(spec)
    except ValueError as e:
        raise SystemExit(f"--mesh: {e}") from None
    data, model = axes["data"], axes["model"]
    if data == -1:
        if world is None:
            world = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
        if not world or world % model:
            raise SystemExit(
                f"--mesh {spec}: data=-1 needs a world (torchrun's "
                f"WORLD_SIZE, or the visible cards: {world}) that divides "
                f"by model={model}")
        data = world // model
    if data < 1 or model < 1:
        raise SystemExit(f"--mesh {spec}: axis sizes must be positive")
    return data, model


def _join_mesh(args, argv, script):
    """The rank's mesh (joining its group), or, outside a rank, start the
    ranks and exit with their status."""
    import torch
    import torch.distributed as dist

    from tsr_tpu_torch.parallel import distributed, launch
    from tsr_tpu_torch.parallel import mesh as pmesh

    device_type = torch.device(args.device).type
    if not launch.in_torchrun_env():
        data, model = _mesh_axes(args.mesh)
        distributed.rank_placement(device_type, 0, data * model)  # checks
        print(f"--mesh {args.mesh}: starting {data * model} ranks on "
              f"{device_type} (torch.multiprocessing, spawn)", flush=True)
        raise SystemExit(launch.run_script(script, argv, data * model,
                                           device_type))
    world = int(os.environ["WORLD_SIZE"])
    data, model = _mesh_axes(args.mesh, world)
    if data * model != world:
        raise SystemExit(
            f"--mesh {args.mesh} needs data x model = {data} x {model} = "
            f"{data * model} ranks, but the world has WORLD_SIZE={world}")
    backend = distributed.initialize(device=device_type)
    mesh = pmesh.mesh_from_spec(args.mesh)
    devices = [None] * world
    dist.all_gather_object(devices, str(mesh.device))
    if mesh.is_main:
        print(f"Mesh: {mesh.shape} over {world} ranks, backend {backend}, "
              f"devices {devices}", flush=True)
    else:
        sys.stdout = open(os.devnull, "w")
    return mesh


def mesh_from_args(args):
    """The rank's ``parallel.mesh.Mesh`` requested by ``--mesh`` (joined by
    :func:`parse`), or None."""
    return getattr(args, "mesh", None)


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
    """The clean tree's path, written first with ``--synthetic`` when it
    is missing or incomplete. On a mesh the first rank checks and writes
    it while the others wait."""
    if getattr(args, "resize_backend", "cv2") != "cv2":
        from tsr_tpu_torch.data import gtsrb

        gtsrb.set_resize_backend(args.resize_backend)
    mesh = getattr(args, "mesh", None)
    if mesh is not None and not mesh.is_main:
        mesh.barrier()
        return args.clean_dir
    _write_clean_tree(args)
    if mesh is not None:
        mesh.barrier()
    return args.clean_dir


def _write_clean_tree(args) -> None:
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
    "this run streams from host (doesn't fit device memory, --mesh, or "
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
