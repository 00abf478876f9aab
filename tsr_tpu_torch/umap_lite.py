"""Minimal in-house UMAP (fuzzy simplicial set + negative-sampling SGD).

Implements the UMAP algorithm (McInnes, Healy & Melville 2018) well enough
to serve the reference's embedding-visualization use case
(``umap.UMAP(n_neighbors=15, min_dist=0.1, n_components=2, metric='cosine',
random_state=42)``, ref:12:131-139) in an environment where umap-learn is
unavailable. Deterministic for a fixed ``random_state``.

The port's own copy of ``tsr_tpu/umap_lite.py``. It needs no sklearn for
the reference's call: the kNN for ``metric="cosine"`` and ``"euclidean"``
is brute force in numpy float64, and the PCA is an exact SVD (sklearn is
imported, lazily, only for another metric). On the reference's 700 x 512
fixture the cosine kNN gives sklearn's neighbour indices, and distances
within 1e-15; the PCA gives sklearn's randomized PCA within 1e-8.

Pipeline (paper sections in parens):
1. kNN graph under the chosen metric (brute force, self included).
2. Smooth-kNN calibration (3.1): per-point ``rho`` (distance to nearest
   neighbor) and ``sigma`` solved by bisection so that
   ``sum_j exp(-(d_ij - rho_i)/sigma_i) = log2(k)``.
3. Fuzzy-union symmetrization ``W + W^T - W o W^T`` (probabilistic t-conorm).
4. Output-space curve ``1/(1 + a d^{2b})`` with (a, b) least-squares fit to
   ``min_dist``/``spread`` (same construction as umap-learn's
   ``find_ab_params``).
5. Spectral initialization from the symmetric normalized Laplacian
   (PCA fallback), then SGD with edge-weight-proportional sampling and
   ``negative_sample_rate`` uniform negatives, per-component gradient
   clipping to [-4, 4], and linearly annealed learning rate.

The SGD is vectorized per epoch with ``np.add.at`` scatter-adds (all edges
due this epoch step from the same snapshot). umap-learn's numba kernel
races over stale reads in parallel mode anyway, so within-epoch staleness
is consistent with the algorithm's tolerance; results are qualitatively
identical and exactly reproducible here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

SMOOTH_K_TOLERANCE = 1e-5
MIN_K_DIST_SCALE = 1e-3


def _knn(data: np.ndarray, n_neighbors: int, metric: str
         ) -> Tuple[np.ndarray, np.ndarray]:
    """k nearest neighbors of each row (self included as neighbor 0).

    ``cosine``: ``1 - <x, y> / (|x| |y|)`` clipped to [0, 2] (a zero row is
    at distance 1 from everything, as in sklearn); ``euclidean``: the
    neighbours picked on ``|x|^2 + |y|^2 - 2 <x, y>``, their distances then
    taken directly. Both sort each row stably, so ties go to the lower
    index. Any other metric goes through sklearn's ``NearestNeighbors``.
    """
    x = np.asarray(data, np.float64)
    if metric == "cosine":
        norm = np.linalg.norm(x, axis=1, keepdims=True)
        xn = x / np.where(norm > 0.0, norm, 1.0)
        dist = np.clip(1.0 - xn @ xn.T, 0.0, 2.0)
    elif metric == "euclidean":
        sq = np.einsum("ij,ij->i", x, x)
        dist = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    else:
        from sklearn.neighbors import NearestNeighbors

        nn = NearestNeighbors(n_neighbors=n_neighbors, metric=metric)
        nn.fit(data)
        dists, idx = nn.kneighbors(data)
        return idx.astype(np.int64), dists.astype(np.float64)
    idx = np.argsort(dist, axis=1, kind="stable")[:, :n_neighbors]
    if metric == "euclidean":
        dists = np.linalg.norm(x[:, None, :] - x[idx], axis=2)
    else:
        dists = np.take_along_axis(dist, idx, axis=1)
    return idx.astype(np.int64), dists


def pca(data: np.ndarray, n_components: int) -> np.ndarray:
    """``[N, D]`` data projected on its first ``n_components`` principal
    axes, in float64: an exact SVD of the centred data, each axis signed
    so that its largest-magnitude loading is positive (sklearn's
    ``svd_flip`` on ``Vt``, which ``PCA`` uses)."""
    x = np.asarray(data, np.float64)
    xc = x - x.mean(axis=0)
    _, _, vt = np.linalg.svd(xc, full_matrices=False)
    vt = vt[:n_components]
    top = np.argmax(np.abs(vt), axis=1)
    vt = vt * np.sign(vt[np.arange(len(vt)), top])[:, None]
    return xc @ vt.T


def smooth_knn_dist(distances: np.ndarray, k: float, n_iter: int = 64,
                    bandwidth: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row (sigma, rho) by bisection (UMAP paper alg. 3)."""
    target = np.log2(k) * bandwidth
    n = distances.shape[0]
    rho = np.zeros(n)
    sigma = np.ones(n)
    mean_all = distances.mean()
    for i in range(n):
        pos = distances[i][distances[i] > 0.0]
        rho[i] = pos[0] if pos.size else 0.0
        lo, hi, mid = 0.0, np.inf, 1.0
        for _ in range(n_iter):
            d = distances[i, 1:] - rho[i]
            psum = np.exp(-np.maximum(d, 0.0) / mid).sum()
            if abs(psum - target) < SMOOTH_K_TOLERANCE:
                break
            if psum > target:
                hi = mid
                mid = (lo + hi) / 2.0
            else:
                lo = mid
                mid = mid * 2.0 if hi == np.inf else (lo + hi) / 2.0
        sigma[i] = mid
        # umap-learn floors sigma against degenerate all-equal rows.
        mean_i = distances[i].mean()
        floor = (MIN_K_DIST_SCALE * mean_i if rho[i] > 0.0
                 else MIN_K_DIST_SCALE * mean_all)
        if sigma[i] < floor:
            sigma[i] = floor
    return sigma, rho


def fuzzy_simplicial_set(idx: np.ndarray, dists: np.ndarray):
    """Symmetrized fuzzy graph as a scipy COO matrix."""
    import scipy.sparse as sp

    n, k = idx.shape
    sigma, rho = smooth_knn_dist(dists, float(k))
    rows = np.repeat(np.arange(n), k)
    cols = idx.ravel()
    d = dists.ravel() - rho[rows]
    vals = np.exp(-np.maximum(d, 0.0) / sigma[rows])
    vals[cols == rows] = 0.0  # no self-edges
    w = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    wt = w.T.tocsr()
    sym = w + wt - w.multiply(wt)
    return sym.tocoo()


def find_ab_params(spread: float = 1.0, min_dist: float = 0.1
                   ) -> Tuple[float, float]:
    """Fit (a, b) of ``1/(1+a d^{2b})`` to the min_dist/spread target curve."""
    from scipy.optimize import curve_fit

    xv = np.linspace(0.0, spread * 3.0, 300)
    yv = np.where(xv < min_dist, 1.0, np.exp(-(xv - min_dist) / spread))

    def curve(x, a, b):
        return 1.0 / (1.0 + a * x ** (2.0 * b))

    (a, b), _ = curve_fit(curve, xv, yv, p0=(1.0, 1.0), maxfev=10000)
    return float(a), float(b)


def _spectral_init(graph, n_components: int, rng: np.random.RandomState
                   ) -> np.ndarray:
    """Eigenvectors 1..n_components of the symmetric normalized Laplacian."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl

    n = graph.shape[0]
    deg = np.asarray(graph.sum(axis=1)).ravel()
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    lap = sp.identity(n) - sp.diags(dinv) @ graph @ sp.diags(dinv)
    k = n_components + 1
    v0 = rng.uniform(-1, 1, n)  # fixed start vector keeps eigsh deterministic
    _, vecs = spl.eigsh(lap.tocsc(), k=k, sigma=0.0, which="LM", v0=v0)
    return vecs[:, 1:k][:, ::-1].astype(np.float64)


def _initial_embedding(graph, data: np.ndarray, n_components: int,
                       init: str, rng: np.random.RandomState) -> np.ndarray:
    if init == "spectral":
        try:
            emb = _spectral_init(graph, n_components, rng)
        except Exception:
            init = "pca"
    if init == "pca":
        emb = pca(data, n_components)
    # Scale to a +-10 box and jitter (umap-learn does the same).
    emb = emb / max(np.abs(emb).max(), 1e-12) * 10.0
    emb += rng.normal(scale=1e-4, size=emb.shape)
    return np.ascontiguousarray(emb)


def _optimize_layout(emb: np.ndarray, heads: np.ndarray, tails: np.ndarray,
                     weights: np.ndarray, n_epochs: int, a: float, b: float,
                     rng: np.random.RandomState,
                     negative_sample_rate: int = 5,
                     initial_alpha: float = 1.0) -> np.ndarray:
    n = emb.shape[0]
    # Edge i fires every epochs_per_sample[i] epochs (weight-proportional).
    eps = n_epochs * (weights / weights.max())
    epochs_per_sample = np.where(
        eps > 0, float(n_epochs) / np.maximum(eps, 1e-12), np.inf)
    epoch_of_next = epochs_per_sample.copy()

    for epoch in range(n_epochs):
        alpha = initial_alpha * (1.0 - epoch / float(n_epochs))
        active = epoch_of_next <= epoch + 1.0
        if not active.any():
            continue
        epoch_of_next[active] += epochs_per_sample[active]
        h = heads[active]
        t = tails[active]

        # Attractive updates.
        diff = emb[h] - emb[t]
        d2 = np.einsum("ij,ij->i", diff, diff)
        g = np.zeros_like(d2)
        nz = d2 > 0.0
        pd = d2[nz] ** b
        g[nz] = (-2.0 * a * b * pd) / (d2[nz] * (a * pd + 1.0))
        grad = np.clip(g[:, None] * diff, -4.0, 4.0) * alpha
        np.add.at(emb, h, grad)
        np.add.at(emb, t, -grad)

        # Repulsive updates from uniform negatives (head moves only).
        m = h.shape[0]
        neg = rng.randint(0, n, size=(m, negative_sample_rate))
        hh = np.repeat(h, negative_sample_rate)
        tt = neg.ravel()
        diff = emb[hh] - emb[tt]
        d2 = np.einsum("ij,ij->i", diff, diff)
        g = (2.0 * b) / ((0.001 + d2) * (a * d2 ** b + 1.0))
        g[hh == tt] = 0.0
        grad = np.clip(g[:, None] * diff, -4.0, 4.0)
        # umap-learn pushes with +4 when points coincide (zero distance).
        grad[(d2 == 0.0) & (hh != tt)] = 4.0
        np.add.at(emb, hh, grad * alpha)
    return emb


def umap_embed(data: np.ndarray, n_neighbors: int = 15,
               min_dist: float = 0.1, n_components: int = 2,
               metric: str = "cosine", random_state: int = 42,
               n_epochs: Optional[int] = None, spread: float = 1.0,
               init: str = "spectral",
               negative_sample_rate: int = 5) -> np.ndarray:
    """2-D (or n-D) UMAP embedding of [N, D] ``data``.

    Defaults mirror the reference call (ref:12:131-139). Deterministic for
    fixed ``random_state``.
    """
    data = np.asarray(data, dtype=np.float64)
    n = data.shape[0]
    if n <= n_components + 1:
        return np.zeros((n, n_components))
    k = min(n_neighbors, n - 1)
    idx, dists = _knn(data, k + 1, metric)  # +1: self is neighbor 0
    graph = fuzzy_simplicial_set(idx, dists)
    if n_epochs is None:
        n_epochs = 500 if n <= 10000 else 200
    # Drop edges too weak to ever fire (umap-learn does the same pruning).
    keep = graph.data >= graph.data.max() / float(n_epochs)
    heads = graph.row[keep].astype(np.int64)
    tails = graph.col[keep].astype(np.int64)
    weights = graph.data[keep]

    rng = np.random.RandomState(random_state)
    emb = _initial_embedding(graph.tocsr(), data, n_components, init, rng)
    a, b = find_ab_params(spread, min_dist)
    return _optimize_layout(emb, heads, tails, weights, n_epochs, a, b, rng,
                            negative_sample_rate=negative_sample_rate
                            ).astype(np.float32)
