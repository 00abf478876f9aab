"""The port's interpretability arm against the JAX package on the CPU: the
VGG taps, heatmaps and GAP features (plain and batch-norm judges), the
per-mode GAP embeddings, the in-house UMAP (kNN, smooth kNN, fuzzy
simplicial set, (a, b) fit, the layout with the same kNN on both sides, and
the end-to-end result by its silhouette), the PCA, the
``umap_embeddings.pt`` export and the figures.

The taps run on a VGG of VGG16-D's depth (13 convs, 5 pools, so taps 2, 15
and 30 exist) at width 8 on 32x32 inputs; JAX runs in float32 at
``precision=HIGHEST``. The UMAP tests use the reference's shipped fixture
``pic/umap_embeddings.pt`` (700 GAP vectors of 512 over 7 modes).
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import matplotlib.image
import numpy as np
import pytest
import torch
from sklearn.decomposition import PCA
from sklearn.metrics import silhouette_score

from tsr_tpu import interpret as jinterpret
from tsr_tpu import umap_lite as jumap
from tsr_tpu import viz as jviz
from tsr_tpu.models import VGG16 as JVGG16
from tsr_tpu_torch import checkpoint, interpret, umap_lite, viz
from tsr_tpu_torch.models import VGG16
from tsr_tpu_torch.models import vgg as tvgg

torch.set_num_threads(2)
HI = jax.lax.Precision.HIGHEST
DEEP_CFG = (8, 8, "M", 8, 8, "M", 8, 8, 8, "M", 8, 8, 8, "M", 8, 8, 8, "M")
SIZE = 32
FIXTURE = Path(__file__).resolve().parents[1] / "pic" / "umap_embeddings.pt"


@pytest.fixture(scope="module")
def fixture():
    """The fixture's features (float64), mode labels and mode indices."""
    d = torch.load(FIXTURE, weights_only=False)
    x = np.asarray(d["original_features"], np.float64)
    modes = sorted(set(d["labels"]))
    return x, d["labels"], np.array([modes.index(m) for m in d["labels"]])


def _deep_judges(use_batchnorm):
    jm = JVGG16(num_classes=4, cfg=DEEP_CFG, fc_width=16, precision=HI,
                use_batchnorm=use_batchnorm)
    jv = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(1),
                                        jnp.zeros((1, SIZE, SIZE, 3))))
    if use_batchnorm:  # running statistics away from (0, 1)
        rng = np.random.default_rng(2)
        for stats in jv["batch_stats"].values():
            n = stats["mean"].shape
            stats["mean"] = rng.uniform(-0.1, 0.1, n).astype(np.float32)
            stats["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    tm = VGG16(num_classes=4, cfg=DEEP_CFG, fc_width=16, input_size=SIZE,
               use_batchnorm=use_batchnorm)
    tm.load_state_dict(checkpoint.vgg16_from_jax(jv))
    return jm, jv, tm


def _images(seed, n):
    return np.random.default_rng(seed).integers(0, 256, (n, SIZE, SIZE, 3),
                                                dtype=np.uint8)


# ------------------------------------------------------------------- taps

@pytest.mark.parametrize("use_batchnorm", [False, True], ids=["plain", "bn"])
@pytest.mark.parametrize("tap", [tvgg.HIDDEN_STATE_TAP,
                                 tvgg.PERCEPTUAL_TAP, tvgg.GAP_TAP])
def test_taps_heatmaps_and_gap_match_jax(use_batchnorm, tap):
    """make_tap_fn at the plain tap translated by ``tap_index`` vs
    tsr_tpu's (NHWC there, NCHW here): features, heatmaps and GAP vectors
    within 1e-5; the heatmaps lie in [0, 1] with each image's min 0 and
    max 1; the judge runs in eval mode and its mode is restored."""
    jm, jv, tm = _deep_judges(use_batchnorm)
    imgs = _images(3, 3)
    idx = tm.tap_index(tap)
    assert idx == jm.tap_index(tap)
    ref = np.asarray(jinterpret.make_tap_fn(jm.apply, idx)(jv, imgs))
    tm.train()
    got = interpret.make_tap_fn(tm, idx)(imgs)
    assert tm.training and got.dtype == torch.float32
    assert np.abs(got.numpy().transpose(0, 2, 3, 1) - ref).max() <= 1e-5 * \
        max(1.0, np.abs(ref).max())
    hm = interpret.heatmap(got)
    assert hm.shape == ref.shape[:3]
    assert np.abs(hm - jinterpret.heatmap(ref)).max() <= 1e-5
    if ref.shape[1] > 1:
        assert hm.min(axis=(1, 2)).max() == 0.0
        assert np.allclose(hm.max(axis=(1, 2)), 1.0, atol=1e-6)
    gap = interpret.gap_features(got)
    assert gap.shape == (3, ref.shape[-1])
    assert np.abs(gap - jinterpret.gap_features(ref)).max() <= 1e-5 * \
        max(1.0, np.abs(ref).max())


def test_heatmap_of_a_flat_map_is_zero():
    """A feature map that is constant per image gives zeros (the 1e-12
    floor), not NaN, as the reference's."""
    feats = np.full((2, 4, 5, 6), 3.0, np.float32)
    ref = jinterpret.heatmap(feats.transpose(0, 2, 3, 1))
    got = interpret.heatmap(torch.from_numpy(feats))
    assert np.array_equal(got, ref) and not got.any()


def test_collect_mode_embeddings_matches_jax():
    """Three modes (batch 4 over 7 images, 2 images, none) through both
    sides at the default GAP tap: the same modes, GAP vectors within
    1e-5, ``zeros((0, 512))`` for the empty mode; a batch-norm judge with
    ``tap_index(GAP_TAP)`` likewise."""
    modes = {"Clean": _images(4, 7), "Noise (Bad)": _images(5, 2),
             "Fog (Bad)": np.zeros((0, SIZE, SIZE, 3), np.uint8)}
    for use_batchnorm in (False, True):
        jm, jv, tm = _deep_judges(use_batchnorm)
        kw = ({} if not use_batchnorm
              else {"tap_layer": tm.tap_index(tvgg.GAP_TAP)})
        ref = jinterpret.collect_mode_embeddings(jm.apply, jv, modes, 4,
                                                 **kw)
        got = interpret.collect_mode_embeddings(tm, modes, 4, **kw)
        assert list(got) == list(ref)
        for m in modes:
            assert got[m].shape == ref[m].shape
            assert np.abs(got[m] - ref[m]).max(initial=0.0) <= 1e-5
        assert got["Fog (Bad)"].shape == (0, 512)


# ------------------------------------------------------------------- UMAP

def test_knn_matches_reference_on_fixture(fixture):
    """The port's brute-force cosine kNN vs tsr_tpu's (sklearn
    NearestNeighbors) on the fixture's 700 x 512 features: the same 16
    neighbour indices for every row (self first), distances within 1e-12.
    The euclidean kNN: the same indices, distances to the other points
    within 1e-12; each point's distance to itself is 0 here, while
    sklearn's expanded formula leaves up to 1e-6 of rounding there."""
    x, _, _ = fixture
    for metric in ("cosine", "euclidean"):
        ridx, rdist = jumap._knn(x, 16, metric)
        idx, dist = umap_lite._knn(x, 16, metric)
        assert np.array_equal(idx, ridx), metric
        assert np.array_equal(idx[:, 0], np.arange(len(x)))
        assert np.abs(dist[:, 1:] - rdist[:, 1:]).max() <= 1e-12, metric
        if metric == "cosine":
            assert np.abs(dist[:, 0] - rdist[:, 0]).max() <= 1e-12
        else:
            assert not dist[:, 0].any() and rdist[:, 0].max() <= 1e-6


def test_umap_graph_steps_match_reference(fixture):
    """On the fixture's kNN: smooth_knn_dist, fuzzy_simplicial_set and
    find_ab_params equal to tsr_tpu's (the same numpy code)."""
    x, _, _ = fixture
    idx, dist = jumap._knn(x, 16, "cosine")
    for a, b in zip(umap_lite.smooth_knn_dist(dist, 16.0),
                    jumap.smooth_knn_dist(dist, 16.0)):
        assert np.array_equal(a, b)
    g, rg = (m.fuzzy_simplicial_set(idx, dist) for m in (umap_lite, jumap))
    assert (g.tocsr() != rg.tocsr()).nnz == 0
    assert umap_lite.find_ab_params(1.0, 0.1) == jumap.find_ab_params(1.0,
                                                                      0.1)


def test_umap_embed_with_shared_knn_matches_reference(fixture, monkeypatch):
    """With the same kNN arrays swapped into both modules, umap_embed at 50
    epochs gives tsr_tpu's embedding within 1e-6 (the rest is the same
    arithmetic; the SGD amplifies the kNN's last bits, so the kNN is held
    on its own above)."""
    x, _, _ = fixture
    shared = jumap._knn(x, 16, "cosine")
    for mod in (jumap, umap_lite):
        monkeypatch.setattr(mod, "_knn", lambda *a: shared)
    ref = jumap.umap_embed(x, random_state=42, n_epochs=50)
    got = umap_lite.umap_embed(x, random_state=42, n_epochs=50)
    assert got.dtype == np.float32 and got.shape == (len(x), 2)
    assert np.abs(got - ref).max() <= 1e-6


def test_umap_end_to_end_silhouette_matches_reference(fixture):
    """project_2d("umap") (the reference's parameters, 500 epochs) on the
    fixture, each side with its own kNN: the silhouette by mode within
    0.02 of tsr_tpu's; finite float32 [700, 2]."""
    x, _, modes = fixture
    ref = jinterpret.project_2d(x, "umap", seed=42)
    got = interpret.project_2d(x, "umap", seed=42)
    assert got.dtype == np.float32 and got.shape == (len(x), 2)
    assert np.isfinite(got).all()
    s_ref, s_got = (silhouette_score(e, modes) for e in (ref, got))
    assert abs(s_got - s_ref) <= 0.02, (s_got, s_ref)


def test_pca_matches_sklearn(fixture):
    """umap_lite.pca (exact SVD, axes signed as sklearn's svd_flip on Vt)
    vs sklearn's PCA(random_state=0) (its randomized solver) on the
    fixture in float64: within 1e-6; project_2d("pca") on the float32
    features vs tsr_tpu's within 1e-5 of the largest value; umap_embed
    with ``init="pca"`` runs."""
    x, _, _ = fixture
    ref = PCA(n_components=2, random_state=0).fit_transform(x)
    assert np.abs(umap_lite.pca(x, 2) - ref).max() <= 1e-6
    x32 = x.astype(np.float32)
    ref = jinterpret.project_2d(x32, "pca")
    got = interpret.project_2d(x32, "pca")
    assert got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    e = umap_lite.umap_embed(x[:60], init="pca", n_epochs=10)
    assert e.shape == (60, 2) and np.isfinite(e).all()


def test_export_embeddings_matches_fixture_schema(tmp_path, fixture):
    """export_embeddings_pt reloads with the fixture's keys, dtypes and
    shapes (float32 tensors, a list of str) and tsr_tpu's values, from
    float64 inputs too."""
    x, labels, _ = fixture
    emb = np.random.default_rng(0).normal(size=(len(x), 2))
    interpret.export_embeddings_pt(str(tmp_path / "port.pt"), emb, labels, x)
    jinterpret.export_embeddings_pt(str(tmp_path / "ref.pt"), emb, labels, x)
    got = torch.load(tmp_path / "port.pt", weights_only=False)
    ref = torch.load(tmp_path / "ref.pt", weights_only=False)
    shipped = torch.load(FIXTURE, weights_only=False)
    assert list(got) == list(shipped)
    for k in ("embeddings", "original_features"):
        assert got[k].dtype == shipped[k].dtype == torch.float32
        assert got[k].shape == shipped[k].shape
        assert torch.equal(got[k], ref[k].float())
    assert got["labels"] == shipped["labels"] == ref["labels"]
    assert all(type(s) is str for s in got["labels"])


# ---------------------------------------------------------------- figures

def _figure_inputs():
    rng = np.random.default_rng(9)
    img = lambda: rng.integers(0, 256, (24, 24, 3), dtype=np.uint8)  # noqa
    hm = lambda: rng.uniform(0, 1, (24, 24)).astype(np.float32)  # noqa
    tasks = ("Noise", "Blur", "Fog")
    labels = [m for m in ("Clean", "Noise (Bad)", "Fog (Restored)")
              for _ in range(10)]
    return {
        "comparison_grid": lambda m, p: m.comparison_grid(
            img(), {t: img() for t in tasks},
            {t: img() for t in tasks[:2]}, p),
        "hidden_state_grid": lambda m, p: m.hidden_state_grid(
            [{"input": img(), "clean": hm(), "bad": hm(), "restored": hm()}
             for _ in tasks[:2]], p, tasks[:2]),
        "cascade_figure": lambda m, p: m.cascade_figure(
            [(f"stage {k}", img() if k % 2 else hm()[..., None].repeat(3, 2))
             for k in range(7)], [f"conf {k}" for k in range(7)], p,
            caption="variant"),
        "demo_figure": lambda m, p: m.demo_figure(
            img(), img(), rng.uniform(-0.2, 1.2, (24, 24, 3)),
            ["clean", "bad", "restored"], p),
        "embedding_scatter": lambda m, p: m.embedding_scatter(
            rng.normal(size=(len(labels), 2)), labels, p),
    }


@pytest.mark.parametrize("name", list(_figure_inputs()))
def test_figures_match_reference(tmp_path, name):
    """Each figure from the same input arrays (drawn again from one seed
    for each side) writes a PNG whose pixels equal tsr_tpu.viz's."""
    paths = []
    for mod in (viz, jviz):
        path = str(tmp_path / f"{mod.__name__}.png")
        assert _figure_inputs()[name](mod, path) == path
        paths.append(path)
    got, ref = (matplotlib.image.imread(p) for p in paths)
    assert got.shape == ref.shape and np.array_equal(got, ref)


# ------------------------------------------------------ package boundary

def test_import_pulls_in_no_jax_sklearn_or_matplotlib():
    """Importing the slice's modules loads neither jax nor tsr_tpu, nor
    sklearn or matplotlib (neither is on the card's machine)."""
    code = (
        "import sys\n"
        "import tsr_tpu_torch.interpret, tsr_tpu_torch.umap_lite\n"
        "import tsr_tpu_torch.viz, tsr_tpu_torch.train.loops\n"
        "import tsr_tpu_torch.losses, tsr_tpu_torch.configs\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'tsr_tpu', 'sklearn', 'matplotlib')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
