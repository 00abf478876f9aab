"""Figure generation matching the reference's visual artifacts, drawn on
the host.

- :func:`comparison_grid` — 3x3 clean / distorted / restored grid
  (ref:10:12-67, saved as result_visualization.png).
- :func:`hidden_state_grid` — 3 tasks x {input, clean-feat, bad-feat,
  restored-feat} viridis heatmaps (ref:11:83-147).
- :func:`cascade_figure` — 2x4 annotated per-image stage grid
  (ref:13:208-218).
- :func:`demo_figure` — 1x3 clean/bad/restored with confidence annotations
  (ref:15:202-228).
- :func:`embedding_scatter` — 2-D embedding scatter colored by mode
  (ref:12:157-171).

The port's own copy of ``tsr_tpu/viz.py``. Each function imports
matplotlib (Agg backend) when it is called, not when the module is
imported, so the port imports on a machine without matplotlib; the
figures take numpy arrays (move tensors to the host first).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def comparison_grid(clean, distorted: Dict[str, np.ndarray],
                    restored: Dict[str, np.ndarray], path: str):
    """3x3 grid: clean on top, distorted row, restored row (ref:10:12-67)."""
    plt = _pyplot()
    tasks = list(distorted)
    plt.figure(figsize=(15, 10))
    plt.subplot(3, 3, 2)
    plt.title("Original Clean Image")
    plt.imshow(clean)
    plt.axis("off")
    for idx, task in enumerate(tasks):
        plt.subplot(3, 3, 4 + idx)
        plt.title(f"{task} (Distorted)")
        plt.imshow(distorted[task])
        plt.axis("off")
        if task in restored:
            plt.subplot(3, 3, 7 + idx)
            plt.title(f"{task} (Restored)")
            plt.imshow(restored[task])
            plt.axis("off")
    plt.tight_layout()
    plt.savefig(path)
    plt.close()
    return path


def hidden_state_grid(rows: List[Dict[str, np.ndarray]], path: str,
                      row_names: Sequence[str]):
    """Each row: {'input': rgb, 'clean': hm, 'bad': hm, 'restored': hm}
    (ref:11:83-147)."""
    plt = _pyplot()
    n = len(rows)
    fig, axes = plt.subplots(n, 4, figsize=(16, 4 * n), squeeze=False)
    cols = ["Input Image (Bad/Restored)", "Clean Features",
            "Distorted Features", "Restored Features"]
    for ax, col in zip(axes[0], cols):
        ax.set_title(col, fontsize=14, fontweight="bold")
    for i, (row, name) in enumerate(zip(rows, row_names)):
        axes[i, 0].imshow(row["input"])
        axes[i, 0].set_ylabel(name, fontsize=14, fontweight="bold")
        axes[i, 0].set_xticks([])
        axes[i, 0].set_yticks([])
        for j, kind in enumerate(("clean", "bad", "restored")):
            axes[i, 1 + j].imshow(row[kind], cmap="viridis")
            axes[i, 1 + j].axis("off")
    plt.tight_layout()
    plt.savefig(path)
    plt.close()
    return path


def cascade_figure(stage_images: Sequence[Tuple[str, np.ndarray]],
                   annotations: Sequence[str], path: str,
                   caption: str = None):
    """2x4 grid of the 7 cascade stages + blank (ref:13:208-218).
    ``caption`` (e.g. the restorer variant, RESULTS.md cascade table)
    renders as the figure suptitle so saved artifacts state which measured
    configuration produced them."""
    plt = _pyplot()
    fig, axes = plt.subplots(2, 4, figsize=(18, 9))
    for k, ax in enumerate(axes.flat):
        if k < len(stage_images):
            name, img = stage_images[k]
            ax.imshow(img if img.dtype == np.uint8
                      else np.clip(img, 0, 1))
            ax.set_title(f"{name}\n{annotations[k]}", fontsize=10)
        ax.axis("off")
    if caption:
        fig.suptitle(caption, fontsize=11)
    plt.tight_layout()
    plt.savefig(path)
    plt.close()
    return path


def demo_figure(clean, bad, restored, captions: Sequence[str], path: str):
    """1x3 annotated clean/bad/restored (ref:15:202-228)."""
    plt = _pyplot()
    fig, axes = plt.subplots(1, 3, figsize=(15, 6))
    for ax, img, cap in zip(axes, (clean, bad, restored), captions):
        ax.imshow(img if img.dtype == np.uint8 else np.clip(img, 0, 1))
        ax.set_title(cap, fontsize=11)
        ax.axis("off")
    plt.tight_layout()
    plt.savefig(path)
    plt.close()
    return path


def embedding_scatter(embeddings: np.ndarray, labels: Sequence[str],
                      path: str,
                      title: str = ("Projection of VGG16 Features "
                                    "(Layer: features.30)")):
    """2-D scatter colored by mode label (ref:12:157-171; seaborn replaced
    by matplotlib with a tab10 palette)."""
    plt = _pyplot()
    plt.figure(figsize=(12, 10))
    uniq = list(dict.fromkeys(labels))
    cmap = plt.get_cmap("tab10")
    labels_arr = np.asarray(labels)
    for i, mode in enumerate(uniq):
        m = labels_arr == mode
        plt.scatter(embeddings[m, 0], embeddings[m, 1], s=60, alpha=0.7,
                    color=cmap(i % 10), label=mode)
    plt.title(title, fontsize=15)
    plt.xlabel("Dimension 1")
    plt.ylabel("Dimension 2")
    plt.legend(bbox_to_anchor=(1.05, 1), loc=2, borderaxespad=0.0)
    plt.tight_layout()
    plt.savefig(path)
    plt.close()
    return path
