"""Synthetic GTSRB-like fixture data, calibrated to GTSRB's distortion-
vulnerability profile.

The real GTSRB download needs network access (ref:01), unavailable in
air-gapped environments. This module procedurally generates traffic-sign
images whose *failure modes under distortion* match the reference's
published profile (reference README.md:92-110): the judge should crater
under AWGN (26.8% there), degrade moderately under motion blur (55.6%) and
fog (61.1%), and collapse under the compound chain (5.8%).

How the calibration works (v2 — v1 coded class identity in hue, which
inverted the profile: fog killed it, noise didn't):

* **Template groups.** Classes share GTSRB-like templates — red-ring
  "speed" circles, red-border warning triangles, blue mandatory discs —
  and differ only by a two-digit glyph from a shared 3x5 font. Class
  identity therefore lives in ~2px strokes (at the ~30-60px native sizes
  GTSRB ships), exactly the high-frequency content that AWGN and a
  12px motion blur destroy. A handful of "unique" classes (stop / yield /
  priority analogues) keep distinctive shape+color and stay easy, as in
  GTSRB.
* **Fog survives.** Fog (I = J*t + A*(1-t), ref:04:28) is a per-image
  linear contrast compression: spatial detail is preserved, so a judge
  trained on the wide illumination spread below can still read glyphs.
* **Noise is catastrophic.** Illumination gain follows a dark-heavy
  distribution (GTSRB is full of dusk/underexposed captures). On dark
  images, sigma^2=0.02 noise both swamps the glyph contrast *and*
  triggers the reference's uint8 wrap quirk (ref:02:21-26: lower clip
  bound -1 then np.uint8 cast wraps negatives to bright values),
  producing salt-noise chaos.

Knobs are collected in ``CALIB`` so the profile can be tuned empirically
(see benchmarks/calibrate_standin.py).

The port's own copy of ``tsr_tpu/data/synthetic.py``: pure numpy on
``np.random.default_rng`` with the same draws in the same order, so a
seed gives the same pixels in both packages. :func:`write_image_tree`
writes its ``.ppm`` files through the port's IO library
(``tsr_tpu_torch.native``) instead of cv2.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np

# Shipped native-size distribution for calibrated stand-in trees: every
# consumer building a "real" tree (script 01 via ensure_clean_tree,
# demo_run.sh) uses these, so the calibration winner ships from ONE place.
# GTSRB crops span ~25-110 px and distortions apply at native resolution,
# so this pair is a calibration lever like the CALIB knobs below.
TREE_SIZE = 64
TREE_JITTER = 0.45

# ---------------------------------------------------------------------------
# Calibration knobs (empirically tuned against reference README.md:92-110)
# ---------------------------------------------------------------------------
CALIB = {
    # illumination gain: g = dark_lo + (dark_hi-dark_lo)*u^dark_pow
    # (pow>1 pushes mass toward dark)
    "gain_lo": 0.20,
    "gain_hi": 1.15,
    "gain_pow": 1.7,
    # glyph/fill reflectances (pre-gain)
    "fill_hi": 0.92,
    "glyph_dark": 0.16,
    # sensor noise on "clean" images (std, in [0,1])
    "sensor_noise": 0.008,
    # probability/strength of capture blur on a clean image (GTSRB is shot
    # from a moving car: motion softness is endemic in the training set,
    # which is why the reference's blurred accuracy only halves)
    "p_capture_blur": 0.50,
    "capture_blur_hi": 1.0,
    # directional motion smear on clean captures (the same moving-car
    # physics, stronger tail). This is the blur-band analog of the veil:
    # it overlaps the 12 px blur distortion's low end, so blur tolerance
    # becomes a property of the data instead of a training lottery —
    # without it the blur band swings 25-52% across runs (calib5 vs 11).
    "p_motion_smear": 0.25,
    "smear_len": (1.5, 4.5),   # pixels at native resolution
    # natural atmospheric veil (overcast/hazy capture) on clean images:
    # probability and transmittance range. The low end overlaps the fog
    # distortion's t in [0.1, 0.36] (ref:04:28 with intensity 0.8) so the
    # trained judge, like the reference's ImageNet-initialized one, treats
    # heavy contrast compression as in-distribution.
    "p_veil": 0.10,
    # r3 calibration: lower bound 0.22 -> 0.30 moved fog from 81.5% into
    # the reference band (56.0%, target [50,70]) with every other band
    # holding (config B2, docs/CALIBRATION.md r3 sweep)
    "veil_t": (0.30, 0.85),
    # small-native tail: GTSRB's crop-size distribution is heavily
    # bottom-skewed (most crops are 25-50 px), which the symmetric
    # size_jitter draw misses. Without it the compound band has a
    # structural floor (docs/CALIBRATION.md r3 finding 8): blur-10 at
    # >40 px natives never destroys the sign *template*, so group-level
    # reading keeps compound accuracy at 14-16% vs the reference's 5.8%.
    # size_small_frac routes that fraction of tree images to a uniform
    # draw over size_small_range native pixels (see write_image_tree).
    "size_small_frac": 0.3,
    "size_small_range": (26.0, 40.0),
    # sign diameter as a fraction of the frame
    "diam_lo": 0.66,
    "diam_hi": 0.92,
    # glyph box scale: <1 shrinks the digit glyph (thinner strokes =>
    # additive noise bites harder while template/shape cues stay)
    "glyph_scale": 0.9,
    # photographic-degradation strength (0 = off, shipped): surface
    # texture + isotropic optical softening applied at native resolution
    # before the photometric pipeline. Purpose (docs/CALIBRATION.md r4
    # decision 2 -> r5 A/B): the stand-in's compound floor of ~16% is
    # carried by vector-crisp silhouettes — the 4 unique-shape classes
    # survive the blur-10 chain at 42% because a rendered octagon at
    # 26-40 px is still an octagon, while GTSRB's *photographic* crops
    # lose the template itself. This knob breaks silhouette identity the
    # way photography does (print texture, focus softness) so the causal
    # claim becomes a measured sweep instead of an argument.
    "photo_degrade": 0.0,
    # anti-correlation between native size and illumination gain (0 = off).
    # GTSRB's large crops skew to close-up dusk/shade captures; here the
    # knob decouples the blur and compound difficulty bands: a large dark
    # sign survives motion blur (the offline blur tree's per-image min-max
    # renormalize, ref:03:29, re-stretches a dark image's range) but dies
    # in the compound chain, where fog's contrast compression happens
    # before noise and nothing re-stretches.
    "size_gain_anticorr": 0.0,
}

# ---------------------------------------------------------------------------
# 3x5 digit font (shared strokes => digits are mutually confusable under
# degradation, like real numerals)
# ---------------------------------------------------------------------------
_FONT = {
    0: ["111", "101", "101", "101", "111"],
    1: ["010", "110", "010", "010", "111"],
    2: ["111", "001", "111", "100", "111"],
    3: ["111", "001", "111", "001", "111"],
    4: ["101", "101", "111", "001", "001"],
    5: ["111", "100", "111", "001", "111"],
    6: ["111", "100", "111", "101", "111"],
    7: ["111", "001", "010", "010", "010"],
    8: ["111", "101", "111", "101", "111"],
    9: ["111", "101", "111", "001", "111"],
}
_FONT_ARR = np.zeros((10, 5, 3), np.bool_)
for _d, _rows in _FONT.items():
    for _r, _row in enumerate(_rows):
        for _c, _ch in enumerate(_row):
            _FONT_ARR[_d, _r, _c] = _ch == "1"

# Interleaved group assignment so tiny test datasets (num_classes<=8) still
# span several templates. Over 43 classes: 13 speed / 17 warn / 9 blue /
# 4 unique — close to GTSRB's real proportions.
_KIND_SEQ = ("speed", "warn", "blue", "speed", "warn",
             "unique", "speed", "warn", "blue", "warn")

# Distinct two-digit codes per group, GTSRB-flavored for the speed group.
_SPEED_CODES = [(2, 0), (3, 0), (5, 0), (6, 0), (7, 0), (8, 0), (9, 0),
                (1, 0), (1, 2), (4, 0), (2, 5), (3, 5), (6, 5), (7, 5),
                (8, 5), (9, 5), (4, 5), (1, 5)]


def _class_spec(class_id: int):
    """-> (kind, code) for any class id; deterministic, in-group unique."""
    kind = _KIND_SEQ[class_id % len(_KIND_SEQ)]
    idx = sum(1 for c in range(class_id)
              if _KIND_SEQ[c % len(_KIND_SEQ)] == kind)
    if kind == "speed":
        code = _SPEED_CODES[idx % len(_SPEED_CODES)]
    elif kind == "unique":
        code = (idx % 6, 0)  # selects the unique shape variant
    else:
        # distinct digit pairs, skipping repeats like (k,k) for legibility
        a, b = (idx * 3 + 1) % 10, (idx * 7 + idx // 10 + 2) % 10
        code = (a, b if b != a else (b + 1) % 10)
    return kind, code


SS = 4  # supersampling factor


def _digit_mask(u, v, code, width, height):
    """Boolean mask of the two-digit glyph ``code`` centered at (0,0) in the
    rotated sign frame. ``u``/``v`` are float coordinate grids; the glyph box
    is ``width`` x ``height`` (7 cols x 5 rows: 3+gap+3)."""
    cw, ch = width / 7.0, height / 5.0
    col = np.floor((u + width / 2) / cw).astype(np.int32)
    row = np.floor((v + height / 2) / ch).astype(np.int32)
    valid = (col >= 0) & (col < 7) & (row >= 0) & (row < 5) & (col != 3)
    d = np.where(col < 3, code[0], code[1])
    dcol = np.where(col < 3, col, col - 4)
    lut = _FONT_ARR[np.clip(d, 0, 9),
                    np.clip(row, 0, 4),
                    np.clip(dcol, 0, 2)]
    return valid & lut


def _coarse_noise(rng, size, cells, lo, hi):
    """Low-frequency clutter: random coarse grid, bilinearly upscaled."""
    g = rng.uniform(lo, hi, (cells, cells, 3)).astype(np.float32)
    idx = np.linspace(0, cells - 1, size)
    i0 = np.floor(idx).astype(int)
    i1 = np.minimum(i0 + 1, cells - 1)
    f = (idx - i0)[:, None, None]
    rows = g[i0] * (1 - f) + g[i1] * f
    f2 = (idx - i0)[None, :, None]
    return rows[:, i0] * (1 - f2) + rows[:, i1] * f2


def make_sign(class_id: int, size: int = 48,
              rng: np.random.Generator | None = None,
              gain_u: float | None = None) -> np.ndarray:
    """Render one sign image for ``class_id`` (uint8 HWC RGB).

    Rendered at 4x supersampling on float [0,1], box-downscaled (photographic
    softness), then pushed through a GTSRB-like photometric pipeline
    (dark-heavy gain, gamma, color cast, sensor noise). ``gain_u``
    overrides the illumination-gain quantile in [0, 1] (1 = brightest);
    used by :func:`write_image_tree` for the size-gain anti-correlation."""
    rng = rng or np.random.default_rng(0)
    kind, code = _class_spec(class_id)
    S = size * SS
    C = CALIB

    # --- background: gradient + low-frequency clutter -----------------
    top = rng.uniform(0.25, 0.7, 3)
    bot = top * rng.uniform(0.4, 0.9) + rng.uniform(-0.08, 0.08, 3)
    t = np.linspace(0, 1, S, dtype=np.float32)[:, None, None]
    img = (top * (1 - t) + np.clip(bot, 0.02, 1.0) * t
           ).astype(np.float32) * np.ones((S, S, 3), np.float32)
    img = 0.78 * img + 0.22 * _coarse_noise(rng, S, rng.integers(3, 7),
                                            0.1, 0.8)

    # --- sign geometry (rotated coordinate frame) ----------------------
    cx = S / 2 + rng.uniform(-0.07, 0.07) * S
    cy = S / 2 + rng.uniform(-0.07, 0.07) * S
    r = S * rng.uniform(C["diam_lo"], C["diam_hi"]) / 2
    th = np.deg2rad(rng.uniform(-6, 6))
    yy, xx = np.mgrid[0:S, 0:S].astype(np.float32)
    u = (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)
    v = -(xx - cx) * np.sin(th) + (yy - cy) * np.cos(th)

    fill = C["fill_hi"] + rng.uniform(-0.06, 0.06)
    dark = C["glyph_dark"] + rng.uniform(0.0, 0.10)
    red = np.array([0.72, 0.09, 0.11]) * rng.uniform(0.85, 1.1)
    blue = np.array([0.09, 0.22, 0.62]) * rng.uniform(0.85, 1.1)
    white = np.array([fill, fill, fill * 0.97])
    black = np.array([dark, dark, dark])

    def put(mask, color):
        img[mask] = np.asarray(color, np.float32)

    absu, absv = np.abs(u), np.abs(v)
    rad2 = u * u + v * v
    gs = C.get("glyph_scale", 1.0)
    if kind == "speed":
        put(rad2 <= r * r, red)
        put(rad2 <= (0.78 * r) ** 2, white)
        put((rad2 <= (0.78 * r) ** 2)
            & _digit_mask(u, v, code, gs * 1.30 * r, gs * 1.10 * r), black)
    elif kind == "warn":
        # upward triangle (apex top) with red border, cream interior,
        # glyph in the wide lower half
        def tri(scale):
            return ((v >= -0.62 * r * scale)
                    & (absu * 1.9 <= (0.62 * r * scale + v) * 1.12))
        put(tri(1.45), red)
        put(tri(1.05), white)
        put(tri(1.05) & _digit_mask(u, v - 0.22 * r, code,
                                    gs * 0.95 * r, gs * 0.80 * r), black)
    elif kind == "blue":
        put(rad2 <= r * r, blue)
        put((rad2 <= (0.9 * r) ** 2)
            & _digit_mask(u, v, code, gs * 1.25 * r, gs * 1.05 * r), white)
    else:  # unique, code[0] selects the variant
        var = code[0]
        if var == 0:  # stop-like red octagon with white band
            oct_m = (np.maximum(absu, absv) + 0.41 * (absu + absv)) <= 1.3 * r
            put(oct_m, red)
            put(oct_m & (absv <= 0.22 * r), white)
        elif var == 1:  # yield-like inverted triangle (apex bottom)
            m = (v <= 0.62 * r) & (absu * 1.9 <= (0.62 * r - v) * 1.12)
            put(m, red)
            put((v <= 0.40 * r) & (absu * 1.9 <= (0.40 * r - v) * 1.12),
                white)
        elif var == 2:  # priority-like yellow diamond
            put((absu + absv) <= 1.25 * r, white)
            put((absu + absv) <= 0.95 * r, [0.85, 0.7, 0.1])
        elif var == 3:  # end-of-limits: white disc + gray diagonal stripes
            put(rad2 <= r * r, white)
            stripe = (np.mod(u + v, 0.5 * r) < 0.14 * r) & (rad2 <= r * r)
            put(stripe, [0.45, 0.45, 0.45])
        elif var == 4:  # blue square with white disc
            put(np.maximum(absu, absv) <= r, blue)
            put(rad2 <= (0.5 * r) ** 2, white)
        else:  # black-bordered white hexagon
            hexm = (absv + 0.58 * absu) <= 1.1 * r
            put(hexm & (absu <= 0.95 * r), black)
            put((absv + 0.58 * absu <= 0.85 * r) & (absu <= 0.72 * r), white)

    # optional directional motion smear (see CALIB["p_motion_smear"]):
    # uniform average along a random-angle segment, done at supersampled
    # resolution so sub-pixel lengths resolve
    if rng.uniform() < C.get("p_motion_smear", 0.0):
        ln = rng.uniform(*C["smear_len"]) * SS
        thm = rng.uniform(0, np.pi)
        k = max(2, int(ln))
        acc = np.zeros_like(img)
        for t in range(k):
            off = (t - (k - 1) / 2) / max(k - 1, 1) * ln
            dy = int(round(off * np.sin(thm)))
            dx = int(round(off * np.cos(thm)))
            acc += np.roll(np.roll(img, dy, 0), dx, 1)
        img = acc / k

    # --- downscale (box filter over SS x SS) ---------------------------
    small = img.reshape(size, SS, size, SS, 3).mean((1, 3))

    # photographic degradation (CALIB["photo_degrade"], r5 compound A/B):
    # multiplicative coarse surface texture (print/paint irregularity
    # breaking the flat vector fills) + repeated 4-neighbor optical
    # softening (focus/demosaic loss eroding silhouette edges at native
    # resolution). Both scale with the knob; 0 is a strict no-op.
    pd = C.get("photo_degrade", 0.0)
    if pd > 0:
        tex = _coarse_noise(rng, size, int(rng.integers(5, 10)),
                            -1.0, 1.0)
        small = np.clip(small * (1.0 + 0.15 * pd * tex), 0.0, 1.0)
        k = pd * rng.uniform(0.6, 1.0)
        for _ in range(2):
            n4 = (np.roll(small, 1, 0) + np.roll(small, -1, 0)
                  + np.roll(small, 1, 1) + np.roll(small, -1, 1)) / 4.0
            small = small * (1 - k / 2) + n4 * (k / 2)

    # optional capture blur (GTSRB has plenty of soft captures): average
    # with a shifted copy along a random axis, strength up to a full pixel
    if rng.uniform() < C["p_capture_blur"]:
        k = rng.uniform(0.3, C["capture_blur_hi"])
        ax = rng.integers(0, 2)
        sh = np.roll(small, 1, axis=ax)
        sh2 = np.roll(small, -1, axis=ax)
        small = small * (1 - k / 2) + sh * (k / 3) + sh2 * (k / 6)

    # --- photometric pipeline: gain, gamma, cast, veil, sensor noise ---
    u = rng.uniform() if gain_u is None else float(gain_u)
    g = C["gain_lo"] + (C["gain_hi"] - C["gain_lo"]) * u ** C["gain_pow"]
    gamma = rng.uniform(0.8, 1.25)
    cast = rng.uniform(0.88, 1.12, 3)
    out = np.clip(small, 0, 1) ** gamma
    out = out * g * cast
    if rng.uniform() < C["p_veil"]:
        # natural atmospheric veil: overcast/hazy captures, which GTSRB's
        # training set contains plenty of. This is what teaches the judge
        # the contrast-invariance that lets it survive the synthetic fog
        # distortion (ref README.md:97: foggy = 61%, a *moderate* drop) —
        # fog is an info-preserving linear squeeze, and a judge that has
        # seen washed-out captures can still read signs through it.
        tv = rng.uniform(*C["veil_t"])
        out = out * tv + rng.uniform(0.65, 0.95) * (1 - tv)
    out = out + rng.normal(0, C["sensor_noise"] * rng.uniform(0.3, 1.5),
                           out.shape)
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)


def make_dataset(num_classes: int = 43, per_class: int = 20,
                 size: int = 64, seed: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Return (images [N,size,size,3] uint8, labels [N] int32)."""
    rng = np.random.default_rng(seed)
    imgs, labels = [], []
    for cid in range(num_classes):
        for _ in range(per_class):
            imgs.append(make_sign(cid, size, rng))
            labels.append(cid)
    return np.stack(imgs), np.asarray(labels, np.int32)


def write_image_tree(root: str, num_classes: int = 8, per_class: int = 6,
                     size: int = 64, seed: int = 0,
                     size_jitter: float = 0.0) -> str:
    """Materialize a GTSRB-layout directory tree of synthetic signs
    (``<root>/<class_id:05d>/<i:05d>.ppm``) for file-based pipeline tests.

    ``size_jitter`` > 0 varies the native resolution per image in
    ``[size*(1-j), size*(1+j)]`` — GTSRB ships crops from ~25 to ~110 px,
    and distortion severity is relative to native pixels (ref:02/03/04
    distort before any resize), so a spread of native sizes is part of the
    difficulty profile."""
    from tsr_tpu_torch import native

    rng = np.random.default_rng(seed)
    root_p = Path(root)
    # marker first, images second: consumers detect an interrupted build
    # as marker-present + count-mismatch (scripts._common.ensure_clean_tree
    # rebuilds those; trees without the marker — real data — are never
    # touched)
    import json as _json

    root_p.mkdir(parents=True, exist_ok=True)
    (root_p / ".synthetic").write_text(_json.dumps({
        "num_classes": num_classes, "per_class": per_class, "size": size,
        "seed": seed, "size_jitter": size_jitter}))
    for cid in range(num_classes):
        d = root_p / f"{cid:05d}"
        d.mkdir(parents=True, exist_ok=True)
        paths, imgs = [], []
        for i in range(per_class):
            gain_u = None
            if size_jitter > 0:
                sq = rng.uniform()  # size quantile, 1 = largest
                frac = CALIB.get("size_small_frac", 0.0)
                if frac > 0 and rng.uniform() < frac:
                    lo, hi = CALIB.get("size_small_range", (26.0, 40.0))
                    s = int(round(rng.uniform(lo, hi)))
                    sq = 0.0  # smallest quantile for the anticorr blend
                else:
                    s = int(round(size * (1 + size_jitter * (2 * sq - 1))))
                s = max(s, 24)
                a = CALIB.get("size_gain_anticorr", 0.0)
                if a > 0:
                    # blend the gain quantile toward (1 - size quantile):
                    # large signs skew dark (see CALIB comment)
                    gain_u = (1 - a) * rng.uniform() + a * (1 - sq)
            else:
                s = size
            imgs.append(make_sign(cid, s, rng, gain_u=gain_u))
            paths.append(str(d / f"{i:05d}.ppm"))
        native.write_images(paths, imgs)  # binary P6, RGB
    return str(root_p)
