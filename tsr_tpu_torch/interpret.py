"""Interpretability: VGG feature taps, heatmaps, GAP embeddings, 2-D
projection export.

Port of ``tsr_tpu/interpret.py``, the reference's interpretability arm:

- hidden-state heatmaps: tap ``features[:k+1]`` output, channel-mean,
  min-max normalize (ref:11:31-56; TARGET_LAYER=2 at ref:11:93),
- GAP embeddings: full ``features`` output ``[B, 512, 7, 7]`` -> global
  average pool -> ``[B, 512]`` (ref:12:37-58),
- 2-D projection + ``umap_embeddings.pt``-schema export: dict with
  ``embeddings [N, 2]``, ``labels`` (list of mode names), and
  ``original_features [N, 512]`` (ref:12:145-150).

The taps run on the judge's device; features come back NCHW (the port's
layout), and the heatmaps, GAP vectors and projections are numpy on the
host. ``project_2d(method="umap")`` (the default, matching ref:12) runs
the port's in-house UMAP (:mod:`tsr_tpu_torch.umap_lite`) with the
reference's parameters; ``"pca"`` is the port's exact numpy PCA and
``"tsne"`` imports sklearn when called.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from tsr_tpu_torch import umap_lite
from tsr_tpu_torch.device import as_tensor
from tsr_tpu_torch.models import vgg as vgg_mod
from tsr_tpu_torch.ops import image as image_ops


def make_tap_fn(judge: vgg_mod.VGG16, tap_layer: int,
                normalize: bool = True) -> Callable:
    """``tap(images_u8) -> features``: a uint8 ``[B, H, W, 3]`` batch
    (numpy, or a tensor on the CPU or the judge's device) uploaded to the
    judge's device, scaled to [0, 1], ImageNet-normalized (the reference
    normalizes interpretability inputs, ref:11:73-78, ref:12:66-70) and run
    through ``features[:tap_layer + 1]`` under ``torch.inference_mode``
    with the judge in eval mode (its mode is restored after).

    The features are an NCHW ``[B, C, h, w]`` float tensor on the judge's
    device (``tsr_tpu``'s tap returns NHWC)."""
    device = next(judge.parameters()).device

    @torch.inference_mode()
    def tap(images_u8) -> torch.Tensor:
        x01 = image_ops.to_float01(as_tensor(images_u8, device))
        if normalize:
            x01 = image_ops.imagenet_normalize(x01)
        was_training = judge.training
        judge.eval()
        try:
            return judge(x01.permute(0, 3, 1, 2), tap_layer=tap_layer)
        finally:
            judge.train(was_training)

    return tap


def heatmap(features_nchw) -> np.ndarray:
    """Channel-mean + per-image min-max -> ``[B, h, w]`` in [0, 1]
    (ref:11:46-56), computed where the features lie."""
    h = torch.as_tensor(features_nchw).mean(dim=1)
    lo = h.amin(dim=(1, 2), keepdim=True)
    hi = h.amax(dim=(1, 2), keepdim=True)
    return ((h - lo) / (hi - lo).clamp_min(1e-12)).cpu().numpy()


def gap_features(features_nchw) -> np.ndarray:
    """Global average pool ``[B, C, h, w]`` -> ``[B, C]`` (ref:12:46-58)."""
    return torch.as_tensor(features_nchw).mean(dim=(2, 3)).cpu().numpy()


def project_2d(features: np.ndarray, method: str = "umap",
               seed: int = 42) -> np.ndarray:
    """2-D embedding of ``[N, D]`` features as float32.

    ``umap`` (default): the port's UMAP with the reference's parameters,
    UMAP(n_neighbors=15, min_dist=0.1, metric='cosine', random_state=42)
    (ref:12:131-139). ``pca``: the exact numpy PCA of
    :func:`umap_lite.pca` (sklearn's ``PCA`` up to its randomized
    solver's error). Any other method: sklearn TSNE(cosine), as the
    reference.
    """
    if method == "umap":
        return umap_lite.umap_embed(features, n_neighbors=15, min_dist=0.1,
                                    n_components=2, metric="cosine",
                                    random_state=seed)
    if method == "pca":
        return umap_lite.pca(features, 2).astype(np.float32)
    from sklearn.manifold import TSNE

    n = len(features)
    return TSNE(
        n_components=2, metric="cosine", random_state=seed,
        perplexity=min(30.0, max(2.0, (n - 1) / 3.0)), init="pca",
    ).fit_transform(features)


def export_embeddings_pt(
    path: str,
    embeddings: np.ndarray,
    labels: Sequence[str],
    original_features: np.ndarray,
) -> None:
    """Write the ``umap_embeddings.pt``-schema dict (ref:12:145-150):
    float32 ``embeddings`` and ``original_features`` tensors and a list of
    str ``labels``."""
    torch.save(
        {
            "embeddings": torch.tensor(np.asarray(embeddings, np.float32)),
            "labels": [str(label) for label in labels],
            "original_features": torch.tensor(
                np.asarray(original_features, np.float32)),
        },
        path,
    )


def collect_mode_embeddings(
    judge: vgg_mod.VGG16,
    mode_batches: Dict[str, np.ndarray],
    batch_size: int = 64,
    tap_layer: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """GAP-embed a dict of mode-name -> uint8 image stacks (the 7 modes of
    ref:12:21-29) on the judge's device and return mode -> ``[n, 512]``
    features (``[0, 512]`` for an empty mode).

    ``tap_layer`` defaults to the plain-vgg16 final pool (``GAP_TAP``);
    batch-norm judges must pass ``judge.tap_index(GAP_TAP)``."""
    if tap_layer is None:
        tap_layer = vgg_mod.GAP_TAP
    tap = make_tap_fn(judge, tap_layer=tap_layer)
    out: Dict[str, np.ndarray] = {}
    for mode, imgs in mode_batches.items():
        feats: List[np.ndarray] = []
        for s in range(0, len(imgs), batch_size):
            feats.append(gap_features(tap(imgs[s:s + batch_size])))
        out[mode] = np.concatenate(feats) if feats else np.zeros((0, 512))
    return out
