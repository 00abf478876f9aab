"""The port's file-tree pipeline against the JAX package on the CPU: the
IO library, the tree loader, the device resize, the offline distortions
and tree generator, the native-upload batches, the tree walk and the
directory harness.

Small sizes throughout: trees of at most 24 images, ResUNet (8, 16, 32) /
64 and a small VGG at size 32. Trees are written with cv2 (the reference's
codec); inputs and the reference's random draws are made with numpy / jax
and handed to both sides. JAX runs in float32 at ``precision=HIGHEST``.
"""

import json
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tsr_tpu import eval as jeval
from tsr_tpu import infer as jinfer
from tsr_tpu import native as jnative
from tsr_tpu import offline as joffline
from tsr_tpu.data import gtsrb as jgtsrb
from tsr_tpu.models import ResUNet as JResUNet
from tsr_tpu.models import VGG16 as JVGG16
from tsr_tpu.ops import blur as jblur
from tsr_tpu.ops import distortions as jdist
from tsr_tpu.ops import image as jimage
from tsr_tpu_torch import checkpoint, native, offline
from tsr_tpu_torch import eval as teval
from tsr_tpu_torch import infer as tinfer
from tsr_tpu_torch.data import gtsrb
from tsr_tpu_torch.models import ResUNet, VGG16
from tsr_tpu_torch.ops import distortions as tdist
from tsr_tpu_torch.ops import image as timage

torch.set_num_threads(2)
HI = jax.lax.Precision.HIGHEST
SIZE = 32
SMALL_CFG = (8, 8, "M", 16, "M", 16, "M")


def _diff(a, b):
    return np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))


def _smooth(rng, h, w):
    """A smooth random RGB image (a coarse field upsampled, plus grain), so
    blur and restore see structure and not only noise."""
    coarse = rng.integers(0, 256, (max(h // 6, 2), max(w // 6, 2), 3))
    img = cv2.resize(coarse.astype(np.uint8), (w, h),
                     interpolation=cv2.INTER_LINEAR).astype(int)
    return np.clip(img + rng.integers(-12, 13, img.shape), 0,
                   255).astype(np.uint8)


def _write_tree(root: Path, sizes, seed, png_every=0):
    """Class folders c0, c1, c2 of images at ``sizes`` (h, w), written by
    cv2 as .ppm (every ``png_every``-th as .png)."""
    rng = np.random.default_rng(seed)
    for k, (h, w) in enumerate(sizes):
        ext = ".png" if png_every and k % png_every == 0 else ".ppm"
        p = root / f"c{k % 3}" / f"img{k:02d}{ext}"
        p.parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(p), _smooth(rng, h, w)[:, :, ::-1])
    return root


# natives spread over several offline buckets, non-square, one 7-px side
TREE_SIZES = [(26, 31), (40, 22), (33, 57), (18, 18), (61, 45), (29, 70),
              (50, 50), (7, 40), (35, 28), (44, 63), (24, 37), (58, 30)]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _write_tree(tmp_path_factory.mktemp("clean"), TREE_SIZES, 0,
                       png_every=4)


# ------------------------------------------------------------------ codec

def _png_variants(tmp, rng):
    """(path, cv2-written or PIL-written PNG) of color types 0/2/3/4/6, and
    a PPM; cv2 chooses its filters adaptively per row."""
    ramp = (np.arange(21)[:, None, None] * 5 + np.arange(30)[None, :, None]
            * 3 + np.arange(3)[None, None, :] * 7).astype(np.uint8)
    noise = rng.integers(0, 256, (21, 30, 3), dtype=np.uint8)
    out = []
    for name, img in (("ramp", ramp), ("noise", noise)):
        for level in (1, 9):
            p = str(tmp / f"rgb_{name}_{level}.png")
            cv2.imwrite(p, img[:, :, ::-1], [cv2.IMWRITE_PNG_COMPRESSION,
                                             level])
            out.append(("2", p))
        p = str(tmp / f"gray_{name}.png")
        cv2.imwrite(p, img[:, :, 0])
        out.append(("0", p))
        p = str(tmp / f"rgba_{name}.png")
        cv2.imwrite(p, np.dstack([img[:, :, ::-1], img[:, :, 1]]))
        out.append(("6", p))
        p = str(tmp / f"pal_{name}.png")
        Image.fromarray(img).convert("P", palette=Image.ADAPTIVE,
                                     colors=64).save(p)
        out.append(("3", p))
        p = str(tmp / f"la_{name}.png")
        Image.fromarray(np.dstack([img[:, :, 0], img[:, :, 2]]),
                        "LA").save(p)
        out.append(("4", p))
        p = str(tmp / f"{name}.ppm")
        cv2.imwrite(p, img[:, :, ::-1])
        out.append(("ppm", p))
    return out


def test_decode_matches_cv2(tmp_path):
    """native.decode equals cv2.imread (BGR -> RGB) on PNGs of color types
    0/2/3/4/6 and on PPMs, exactly."""
    cases = _png_variants(tmp_path, np.random.default_rng(3))
    assert {k for k, _ in cases} == {"0", "2", "3", "4", "6", "ppm"}
    for _, p in cases:
        np.testing.assert_array_equal(native.decode(p),
                                      cv2.imread(p)[:, :, ::-1], err_msg=p)


def test_writers_read_back_exactly_through_cv2(tmp_path):
    """The port's PNG and PPM writers, images of several sizes in one call,
    read back through cv2 exactly; a path it cannot write raises."""
    rng = np.random.default_rng(4)
    imgs = [rng.integers(0, 256, s, dtype=np.uint8)
            for s in ((5, 7, 3), (31, 17, 3), (64, 48, 3))]
    for fmt, write in (("png", native.write_png_batch),
                       ("ppm", native.write_images)):
        paths = [str(tmp_path / f"{k}.{fmt}") for k in range(3)]
        write(paths, imgs)
        for p, img in zip(paths, imgs):
            np.testing.assert_array_equal(cv2.imread(p)[:, :, ::-1], img)
    mixed = [str(tmp_path / "m.png"), str(tmp_path / "m.ppm")]
    native.write_images(mixed, imgs[:2])
    for p, img in zip(mixed, imgs):
        np.testing.assert_array_equal(cv2.imread(p)[:, :, ::-1], img)
    with pytest.raises(RuntimeError, match="wrote 0/1"):
        native.write_png_batch([str(tmp_path / "no" / "x.png")], imgs[:1])
    with pytest.raises(ValueError, match=r"\.png, \.ppm only"):
        native.write_images([str(tmp_path / "x.gif")], imgs[:1])


def test_load_batch_matches_cv2_and_reference(tree):
    """load_batch's bilinear resize (up and down) is within 1 LSB of
    cv2.resize(INTER_LINEAR), whose coefficients are fixed-point, and of
    tsr_tpu.native.load_batch."""
    paths = [str(p) for p in offline.tree_files(str(tree))]
    for size in (SIZE, 48):
        ours = native.load_batch(paths, size, threads=3)
        ref = jnative.load_batch(paths, size, threads=3)
        assert _diff(ours, ref).max() <= 1
        for p, got in zip(paths, ours):
            want = cv2.resize(cv2.imread(p), (size, size),
                              interpolation=cv2.INTER_LINEAR)[:, :, ::-1]
            assert _diff(got, want).max() <= 1, p


def test_probe_and_load_canvas(tree, tmp_path):
    """probe reads each image's (h, w) from its header; load_canvas puts
    each image at the top-left of its slot with the rest zeros, or with
    reflect exactly offline._pad_reflect (the reference's padding, tiled
    past a 7-px side), or resized (within 1 LSB of cv2) where a side
    reaches resize_to; an image larger than its slot, or a file that does
    not decode, raises."""
    files = [str(p) for p in offline.tree_files(str(tree))]
    imgs = [native.decode(p) for p in files]
    assert native.probe(files).tolist() == [list(i.shape[:2]) for i in imgs]
    canvas = np.empty((len(files), 64, 96, 3), np.uint8)
    dims = native.load_canvas(files, canvas, reflect=True)
    zeros = np.empty_like(canvas)
    assert (native.load_canvas(files, zeros) == dims).all()
    for img, pad, zero, (h, w) in zip(imgs, canvas, zeros, dims):
        assert (h, w) == img.shape[:2]
        np.testing.assert_array_equal(pad,
                                      joffline._pad_reflect(img, 64, 96))
        np.testing.assert_array_equal(zero[:h, :w], img)
        assert not zero[h:].any() and not zero[:, w:].any()
    big = np.empty((len(files), SIZE, SIZE, 3), np.uint8)
    dims = native.load_canvas(files, big, resize_to=SIZE)
    for p, img, out, (h, w) in zip(files, imgs, big, dims):
        if max(img.shape[:2]) >= SIZE:
            assert (h, w) == (SIZE, SIZE)
            want = cv2.resize(cv2.imread(p), (SIZE, SIZE),
                              interpolation=cv2.INTER_LINEAR)[:, :, ::-1]
            assert _diff(out, want).max() <= 1
        else:
            np.testing.assert_array_equal(out[:h, :w], img)
    with pytest.raises(RuntimeError, match="slots"):
        native.load_canvas(files, np.empty((len(files), 48, 48, 3),
                                           np.uint8))
    with pytest.raises(RuntimeError, match="probed 0/1"):
        native.probe([str(tmp_path / "missing.png")])


def test_decode_failures_raise(tmp_path, tree):
    """A missing or unreadable file raises; nothing falls back."""
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\n not a png")
    for p in (str(tmp_path / "missing.ppm"), str(bad)):
        with pytest.raises(RuntimeError, match="decode"):
            native.decode(p)
        with pytest.raises(RuntimeError, match="decoded 0/1"):
            native.load_batch([p], SIZE)


def test_image_folder_and_batches_match_reference(tree):
    """ImageFolder's classes and samples equal tsr_tpu's; batches yields the
    same labels and images within 1 LSB, and a producer error re-raises in
    the consumer."""
    ours = gtsrb.ImageFolder(str(tree), size=SIZE)
    ref = jgtsrb.ImageFolder(str(tree), size=SIZE)
    assert ours.classes == ref.classes and ours.samples == ref.samples
    got = list(gtsrb.batches(ours, batch_size=5, shuffle=False,
                             drop_remainder=False))
    want = list(jgtsrb.batches(ref, batch_size=5, shuffle=False,
                               drop_remainder=False))
    assert len(got) == len(want) == 3
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gl, wl)
        assert _diff(gi, wi).max() <= 1

    def boom(item):
        raise RuntimeError("boom in producer")

    with pytest.raises(RuntimeError, match="boom in producer"):
        next(gtsrb.batches(ours, batch_size=4, transform=boom))


# ---------------------------------------------------------------- image ops

@pytest.mark.parametrize("canvas", [64, 128, 192])
def test_resize_from_padded_matches_jax(canvas):
    """resize_from_padded vs tsr_tpu.ops.image.resize_from_padded (float32
    one-hot contractions on the CPU) on non-square natives, up and down,
    with a 1x1 filler row: within 1 LSB, values that differ under 0.1 %
    (the gather-and-lerp and the dot product round their products alike;
    the dot may fuse a multiply-add). A native size equal to the output
    size is an exact copy."""
    rng = np.random.default_rng(canvas)
    out = 160
    natives = [(17, 23), (canvas, canvas // 2 + 3), (9, canvas - 1), (1, 1),
               (canvas // 3, canvas)]
    padded = np.zeros((len(natives), canvas, canvas, 3), np.uint8)
    padded[:] = rng.integers(0, 256, padded.shape, dtype=np.uint8)
    sizes = np.asarray(natives, np.int32)
    want = np.asarray(jimage.resize_from_padded(jnp.asarray(padded),
                                                jnp.asarray(sizes), out))
    got = timage.resize_from_padded(torch.from_numpy(padded),
                                    torch.from_numpy(sizes), out).numpy()
    d = _diff(got, want)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())
    # the filler row resizes one pixel: a constant image
    assert (got[3] == padded[3, 0, 0]).all()
    # native == out: an exact identity
    same = rng.integers(0, 256, (2, out, out, 3), dtype=np.uint8)
    ident = timage.resize_from_padded(
        torch.from_numpy(same), torch.full((2, 2), out, dtype=torch.int32),
        out)
    np.testing.assert_array_equal(ident.numpy(), same)


def test_minmax_normalize_u8_matches_jax(rng):
    """Per-image joint min/max to [0, 255] with cvRound: exact, a constant
    image included (it becomes 0)."""
    x = rng.integers(40, 200, (3, 9, 11, 3)).astype(np.float32)
    x[1] = 77.0
    want = np.asarray(jimage.minmax_normalize_u8(x))
    got = timage.minmax_normalize_u8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[1] == 0).all()


# ------------------------------------------------------------- distortions

def _batch(seed, shape=(4, 32, 48, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def test_add_gaussian_noise_matches_jax():
    """AWGN from the reference's normal field: exact, including the
    per-image -1 low clip and the uint8 wrap of negatives (image 0 is dark,
    so it goes negative and wraps; image 1 is bright and clips at 0), with
    a scalar and a per-image variance."""
    x = _batch(1)
    x[0] = x[0] // 16
    x[1] = 200 + x[1] // 8
    key = jax.random.PRNGKey(3)
    normal = np.array(jax.random.normal(key, x.shape, jnp.float32))
    outs = []
    for var in (0.02, np.asarray([0.005, 0.01, 0.02, 0.03], np.float32)):
        jvar = var if np.isscalar(var) else jnp.asarray(var).reshape(
            -1, 1, 1, 1)
        want = np.asarray(jdist.add_gaussian_noise(x, key, var=jvar))
        got = tdist.add_gaussian_noise(
            x, var=var if np.isscalar(var) else torch.from_numpy(var),
            device="cpu", noise=torch.from_numpy(normal)).numpy()
        np.testing.assert_array_equal(got, want)
        outs.append(got)
    f = x[0] / 255.0 + np.sqrt(0.02) * normal[0]
    wrapped = (f < -0.01) & (f > -0.3)  # trunc(f * 255) + 256 in 180..253
    assert wrapped.any() and (outs[0][0][wrapped] >= 180).all()
    g = x[1] / 255.0 + np.sqrt(0.02) * normal[1]
    assert (g > 1.01).any() and (outs[0][1][g > 1.01] == 255).all()


@pytest.mark.parametrize("minmax", [False, True])
def test_apply_motion_blur_matches_jax(minmax):
    """The offline blur (degree 12, angle 45: a shared K=12 kernel, B3's
    run-time-K instance on the card) vs the reference: within 1 LSB, at
    cvRound ties only (under 0.1 % of values), with min-max off and on."""
    x = _batch(2)
    want = np.asarray(jdist.apply_motion_blur(x, 12, 45.0,
                                              minmax_normalize=minmax))
    got = tdist.apply_motion_blur(x, 12, 45.0, minmax_normalize=minmax,
                                  device="cpu").numpy()
    d = _diff(got, want)
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


def test_add_fog_matches_jax():
    """Fog from the reference's jitter draw (exact), and with t_jitter=None
    and a per-image intensity (the fog_rand kind's form), exact."""
    x = _batch(3)
    key = jax.random.PRNGKey(5)
    jitter = np.array(jax.random.uniform(key, (4, 1, 1, 1), jnp.float32,
                                         0.8, 1.2))
    want = np.asarray(jdist.add_fog(x, key, fog_intensity=0.8))
    got = tdist.add_fog(x, fog_intensity=0.8, device="cpu",
                        jitter=torch.from_numpy(jitter.reshape(-1)))
    np.testing.assert_array_equal(got.numpy(), want)
    inten = np.asarray([0.05, 0.3, 0.6, 0.85], np.float32)
    want = np.asarray(jdist.add_fog(x, None, fog_intensity=jnp.asarray(
        inten).reshape(-1, 1, 1, 1), t_jitter=None))
    got = tdist.add_fog(x, fog_intensity=torch.from_numpy(inten),
                        t_jitter=None, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_apply_compound_distortion_matches_jax():
    """The offline compound chain (shared K=10 blur -> fixed fog -> AWGN)
    from the reference's normal field: within 1 LSB (the blur's cvRound
    ties), under 0.1 % of values."""
    x = _batch(4)
    key = jax.random.PRNGKey(7)
    normal = np.array(jax.random.normal(key, x.shape, jnp.float32))
    want = np.asarray(jdist.apply_compound_distortion(x, key))
    got = tdist.apply_compound_distortion(
        x, device="cpu", noise=torch.from_numpy(normal)).numpy()
    d = _diff(got, want)
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


# ----------------------------------------------------------------- offline

def test_bucket_and_pad_reflect_match_reference():
    """_bucket over 1..300 and _pad_reflect (tiled reflect-101, the 1xN
    edge-pad guard) equal the reference's."""
    assert [offline._bucket(n) for n in range(1, 301)] == [
        joffline._bucket(n) for n in range(1, 301)]
    rng = np.random.default_rng(5)
    for (h, w), (bh, bw) in (((1, 5), (32, 32)), ((5, 1), (32, 48)),
                             ((1, 1), (32, 32)), ((3, 40), (32, 48)),
                             ((26, 31), (32, 32)), ((40, 22), (48, 32)),
                             ((64, 64), (64, 64)), ((7, 9), (96, 160))):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        np.testing.assert_array_equal(offline._pad_reflect(img, bh, bw),
                                      joffline._pad_reflect(img, bh, bw))


def test_bucket_with_room():
    """A blurring kind's bucket pads a side by 0 or by at least the
    kernel's bottom/right halo; otherwise it is the reference's bucket."""
    assert offline.HALO == {"blur": 5, "compound": 4, "blur_rand": 7}
    for halo in (0, 4, 5, 7):
        for n in range(1, 300):
            b = offline._bucket_with_room(n, halo)
            assert b == n or b - n >= halo
            if offline._bucket(n) - n in range(halo, 300) or halo == 0:
                assert b == offline._bucket(n)
    assert offline._bucket_with_room(31, 5) == 48
    assert offline._bucket_with_room(58, 7) == 96


@pytest.mark.parametrize("kind", ["blur", "compound", "blur_rand"])
def test_bucketed_blur_equals_native_blur(tree, kind):
    """A blurring kind on the bucket-padded batch, cropped, equals its blur
    at native size (for "blur" min-max normalized per image after the
    crop): the reflect-101 pad composes with filter2d's reflect-101 border
    on every image, the 1- to 4-pixel pads of the reference's buckets
    included. Within 1 LSB at cvRound ties (under 0.1 % of values); the
    random kinds with their noise off (compound) or fixed kernels."""
    n = 0
    for _, chunk, batch in offline.bucketed_batches(
            offline.tree_files(str(tree)), 256, offline.HALO[kind]):
        x = torch.from_numpy(batch)
        b = x.shape[0]
        if kind == "blur":
            out = offline.KINDS["blur"][0](x, None)
        elif kind == "compound":
            out = offline.KINDS["compound"][0](x, None,
                                               noise=torch.zeros(x.shape))
        else:
            out = offline.KINDS["blur_rand"][0](
                x, None, degrees=torch.arange(b) % 12 + 4,
                angles=torch.arange(b) * 37.0)
        for j, ((path, (h, w)), o) in enumerate(zip(chunk, out.numpy())):
            img = native.decode(str(path))
            one = torch.from_numpy(img[None])
            if kind == "blur":
                got = offline._minmax_u8_host(o[:h, :w])
                want = tdist.apply_motion_blur(img, 12, 45.0, device="cpu")
            elif kind == "compound":
                got = o[:h, :w]
                want = offline.KINDS["compound"][0](
                    one, None, noise=torch.zeros(one.shape))[0]
            else:  # tsr_tpu's filter2d reflects past a 7-px side; ours not
                got = o[:h, :w]
                kern = jblur.motion_blur_kernels(
                    jnp.asarray([j % 12 + 4]), jnp.asarray([j * 37.0]), 15)
                want = jimage.saturate_uint8(jblur.filter2d(
                    jnp.asarray(img[None], jnp.float32), kern), round=True)[0]
            d = _diff(got, np.asarray(want))
            assert d.max() <= 1 and (d > 0).mean() < 1e-3, (img.shape, d.max())
            n += 1
    assert n == len(TREE_SIZES)


def _tree_images(root: Path):
    return {str(p.relative_to(root)): cv2.imread(str(p))[:, :, ::-1]
            for p in sorted(root.glob("*/*"))}


def test_generate_tree_blur_matches_reference(tree, tmp_path):
    """generate_tree("blur") vs tsr_tpu: every file equals the reference's
    blur at native size (``apply_motion_blur`` with its min-max), and the
    file tsr_tpu.offline.generate_tree("blur") writes wherever its bucket
    pads the image by 0 or by at least the K=12 kernel's halo of 5 (where
    the pad is 1-4 the reference's file departs from native-size blur:
    ROADMAP section C). Within 1 LSB at cvRound ties, under 0.1 % of
    values. The marker JSON is the reference's."""
    ours, ref = tmp_path / "ours", tmp_path / "ref"
    assert offline.generate_tree(str(tree), str(ours), "blur",
                                 log=lambda s: None, device="cpu") == 12
    joffline.generate_tree(str(tree), str(ref), "blur", log=lambda s: None)
    got, want = _tree_images(ours), _tree_images(ref)
    assert sorted(got) == sorted(want)
    roomy, departs = 0, []
    for k in want:
        img = cv2.imread(str(tree / k))[:, :, ::-1]
        native_blur = np.asarray(jdist.apply_motion_blur(img, 12, 45.0))
        d = _diff(got[k], native_blur)
        assert d.max() <= 1 and (d > 0).mean() < 1e-3, k
        if _diff(want[k], native_blur).max() > 1:
            departs.append(k)
        if all(joffline._bucket(n) - n in (0,) + tuple(range(5, 300))
               for n in img.shape[:2]):
            roomy += 1
            d = _diff(got[k], want[k])
            assert d.max() <= 1 and (d > 0).mean() < 1e-3, k
            assert k not in departs
    assert 0 < roomy < len(want)
    # the reference departs from native-size blur on some of the files
    # whose pad is 1-4 px, and on no other
    assert departs
    assert (json.loads((ours / ".distortion").read_text())
            == json.loads((ref / ".distortion").read_text()))


def _reference_kind_draws(kind, key, shape):
    """The draws tsr_tpu.offline's KINDS function takes from ``key``
    (offline.py:63-131), as keyword arguments of the port's."""
    b = shape[0]

    def t(x):
        return torch.from_numpy(np.array(x))

    if kind in ("noise", "compound"):
        return {"noise": t(jax.random.normal(key, shape, jnp.float32))}
    if kind == "fog":
        return {"jitter": t(jax.random.uniform(key, (b, 1, 1, 1),
                                               jnp.float32, 0.8, 1.2))}
    if kind == "noise_rand":
        kv, kn = jax.random.split(key)
        return {"var": t(jax.random.uniform(kv, (b, 1, 1, 1), jnp.float32,
                                            0.005, 0.03)),
                "noise": t(jax.random.normal(kn, shape, jnp.float32))}
    if kind == "fog_rand":
        return {"intensity": t(jax.random.uniform(
            key, (b, 1, 1, 1), jnp.float32, 0.05, 0.85))}
    kd, ka = jax.random.split(key)
    return {"degrees": t(jax.random.randint(kd, (b,), 4, 16)),
            "angles": t(jax.random.uniform(ka, (b,), jnp.float32, 0.0,
                                           360.0))}


@pytest.mark.parametrize("kind", ["noise", "fog", "compound", "noise_rand",
                                  "fog_rand", "blur_rand"])
def test_random_kind_matches_reference_with_its_draws(kind):
    """Each random kind's KINDS function, given the reference's draws for
    its key, against tsr_tpu.offline.KINDS on the same padded batch:
    within 1 LSB (the blur's cvRound ties), under 0.1 % of values."""
    x = _batch(6, (5, 32, 48, 3))
    key = jax.random.PRNGKey(11)
    want = np.asarray(joffline.KINDS[kind][0](x, key))
    got = offline.KINDS[kind][0](
        torch.from_numpy(x), None,
        **_reference_kind_draws(kind, key, x.shape)).numpy()
    d = _diff(got, want)
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("kind", ["noise", "fog", "compound", "noise_rand",
                                  "fog_rand", "blur_rand"])
def test_generate_tree_random_kind_is_seeded(tmp_path, kind):
    """A random kind's tree is reproducible from its seed and changes with
    it; it mirrors the reference's file names (compound writes .png) and
    its marker JSON."""
    src = _write_tree(tmp_path / "src", [(20, 25), (28, 24), (22, 26),
                                         (40, 45), (38, 47), (45, 40)], 5)
    trees = {}
    for name, seed in (("a", 3), ("b", 3), ("c", 4)):
        dst = tmp_path / name
        assert offline.generate_tree(str(src), str(dst), kind, seed=seed,
                                     batch_size=2, log=lambda s: None,
                                     device="cpu") == 6
        trees[name] = _tree_images(dst)
    ref = tmp_path / "ref"
    joffline.generate_tree(str(src), str(ref), kind, seed=3,
                           log=lambda s: None)
    assert sorted(trees["a"]) == sorted(_tree_images(ref))
    for k in trees["a"]:
        np.testing.assert_array_equal(trees["a"][k], trees["b"][k])
    assert any(not np.array_equal(trees["a"][k], trees["c"][k])
               for k in trees["a"])
    assert (json.loads((tmp_path / "a" / ".distortion").read_text())
            == json.loads((ref / ".distortion").read_text()))


# ---------------------------------------------------------- native batches

@pytest.fixture(scope="module")
def walk_trees(tmp_path_factory):
    """A clean tree and its distorted twin of 24 images whose natives
    straddle SIZE (some device-resized, some host-resized), plus a second
    tree for native_batches with natives across the 64 canvas."""
    root = tmp_path_factory.mktemp("walk")
    rng = np.random.default_rng(8)
    sizes = [(int(h), int(w)) for h, w in rng.integers(12, 46, (24, 2))]
    clean = _write_tree(root / "clean", sizes, 1)
    dist = root / "distorted"
    for p in clean.glob("*/*.ppm"):
        img = cv2.imread(str(p)).astype(int)
        out = dist / p.relative_to(clean)
        out.parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(out), np.clip(img + rng.integers(-25, 26, img.shape),
                                      0, 255).astype(np.uint8))
    sizes = [(int(h), int(w)) for h, w in rng.integers(10, 100, (14, 2))]
    wide = _write_tree(root / "wide", sizes, 2)
    return clean, dist, wide


@pytest.mark.parametrize("pad_batch", [True, False])
def test_native_batches_match_reference(walk_trees, pad_batch):
    """native_batches vs tsr_tpu.infer.native_batches (out size 80, so the
    64 canvas and the 80 bucket both fill): the same batches in the same
    order, the same item indices, sizes and aux (the port's ``aux_fn``
    takes a batch's indices, the reference's one index); canvases equal,
    except rows resized on the host (a side >= 80), within 1 LSB of
    cv2."""
    paths = [str(p) for p in offline.tree_files(str(walk_trees[2]))]

    got = list(tinfer.native_batches(
        paths, 80, 4, aux_fn=lambda idxs: [i * 10 for i in idxs],
        pad_batch=pad_batch, device="cpu"))
    want = list(jinfer.native_batches(paths, 80, 4, aux_fn=lambda i: i * 10,
                                      pad_batch=pad_batch))
    assert len(got) == len(want) > 3
    for (gp, gs, ga, gi), (wp, ws, wa, wi) in zip(got, want):
        assert gi == wi and ga == wa
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
        host_resized = np.asarray(ws)[:, 0] == 80
        d = _diff(gp.numpy(), np.asarray(wp))
        assert (d[~host_resized] == 0).all() and d.max() <= 1


def test_native_batches_producer_error_reraises(walk_trees, tmp_path):
    """A missing file (its header cannot be read) or a truncated one (its
    pixels cannot) fails the walk in the consumer."""
    paths = [str(p) for p in offline.tree_files(str(walk_trees[0]))][:5]
    paths[3] = str(tmp_path / "missing.ppm")
    with pytest.raises(RuntimeError, match="probed 4/5"):
        list(tinfer.native_batches(paths, SIZE, 2, device="cpu"))
    short = tmp_path / "short.ppm"
    short.write_bytes(b"P6\n20 20\n255\n" + bytes(100))
    paths[3] = str(short)
    with pytest.raises(RuntimeError, match="loaded 1/2"):
        list(tinfer.native_batches(paths, SIZE, 2, device="cpu"))


# ------------------------------------------------------ restore and judge

@pytest.fixture(scope="module")
def models():
    """A small ResUNet and VGG16 judge at SIZE in both frameworks, shared
    weights."""
    rng = np.random.default_rng(12)
    jr = JResUNet(widths=(8, 16, 32), bottleneck_width=64, precision=HI)
    jrv = jax.tree.map(np.array, jr.init(jax.random.PRNGKey(2),
                                         jnp.zeros((1, SIZE, SIZE, 3))))
    for stats in jrv["batch_stats"].values():
        for bn in stats.values():
            bn["mean"] = rng.normal(0, 0.05, bn["mean"].shape).astype(
                np.float32)
    jj = JVGG16(num_classes=3, cfg=SMALL_CFG, fc_width=32, precision=HI)
    jjv = jj.init(jax.random.PRNGKey(3), jnp.zeros((1, SIZE, SIZE, 3)))
    tr = ResUNet(widths=(8, 16, 32), bottleneck_width=64)
    tr.load_state_dict(checkpoint.resunet_from_jax(jrv))
    tj = VGG16(num_classes=3, cfg=SMALL_CFG, fc_width=32, input_size=SIZE)
    tj.load_state_dict(checkpoint.vgg16_from_jax(jjv))
    return (jr, jrv, jj, jjv), (tr.eval(), tj.eval())


def _judge_apply(jj):
    return lambda v, x, train=False: jj.apply(v, x, train=train)


def test_fused_eval_step_native_size_matches_jax(models):
    """make_fused_eval_step(native_size=) on a bucket-padded native batch vs
    the JAX step on shared weights: pred equal, confidence within 1e-4."""
    (jr, jrv, jj, jjv), (tr, tj) = models
    rng = np.random.default_rng(9)
    natives = np.asarray([(20, 27), (31, 12), (64, 40), (1, 1), (45, 64)],
                         np.int32)
    padded = rng.integers(0, 256, (5, 64, 64, 3), dtype=np.uint8)
    labels = rng.integers(0, 3, 5)
    jstep = jeval.make_fused_eval_step(
        lambda v, x: jr.apply(v, x, train=False), _judge_apply(jj),
        native_size=SIZE)
    want = jstep(jrv, jjv, (padded, natives), labels)
    tstep = teval.make_fused_eval_step(tr, tj, native_size=SIZE,
                                       device="cpu")
    got = tstep((padded, natives), labels)
    np.testing.assert_array_equal(got["pred"].numpy(),
                                  np.asarray(want["pred"]))
    assert np.abs(got["confidence"].numpy()
                  - np.asarray(want["confidence"])).max() <= 1e-4


def _restored(root: Path):
    return {str(p.relative_to(root)): cv2.imread(str(p))[:, :, ::-1]
            for p in sorted(root.glob("*/*.png"))}


@pytest.mark.parametrize("resize", ["device", "host"])
def test_restore_tree_matches_reference(models, walk_trees, tmp_path,
                                        resize):
    """restore_tree vs tsr_tpu.infer.restore_tree on shared weights: the
    same relative .png files; pixels within 2 LSB, under 1 % of values
    differing (float32 sums in another order move a trunc-quantized pixel
    by one level, and the device resize's ties a level at the input);
    PSNR within 0.05 dB and SSIM within 1e-3 (the reference scores on the
    host, the port on the device, with the same formulas)."""
    (jr, jrv, _, _), (tr, _) = models
    clean, dist, _ = walk_trees
    kw = dict(clean_dir=str(clean), batch_size=5, size=SIZE, resize=resize,
              log=lambda s: None)
    got = tinfer.restore_tree(tr, str(dist), str(tmp_path / "ours"),
                              device="cpu", **kw)
    want = jinfer.restore_tree(jr.apply, jrv, str(dist),
                               str(tmp_path / "ref"), has_batch_stats=True,
                               **kw)
    assert got["images"] == want["images"] == 24
    assert got["batches"] >= 5
    ours, ref = _restored(tmp_path / "ours"), _restored(tmp_path / "ref")
    assert sorted(ours) == sorted(ref) and len(ours) == 24
    d = np.stack([_diff(ours[k], ref[k]) for k in ref])
    assert d.max() <= 2 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())
    assert abs(got["psnr"] - want["psnr"]) < 0.05
    assert abs(got["ssim"] - want["ssim"]) < 1e-3
    assert set(got["host_seconds"]) >= {"decode", "upload", "dispatch",
                                        "download", "write"}


def test_restore_tree_missing_clean(models, walk_trees, tmp_path):
    """Without clean twins the walk writes every file and reports no
    metrics, as the reference does."""
    _, (tr, _) = models
    _, dist, _ = walk_trees
    for resize in ("device", "host"):
        res = tinfer.restore_tree(
            tr, str(dist), str(tmp_path / resize),
            clean_dir=str(tmp_path / "nonexistent"), batch_size=8,
            size=SIZE, resize=resize, log=lambda s: None, device="cpu")
        assert res["images"] == 24 and "psnr" not in res
        assert len(_restored(tmp_path / resize)) == 24


@pytest.mark.parametrize("resize", ["host", "device"])
def test_evaluate_directory_matches_reference(models, walk_trees, resize):
    """evaluate_directory with a restorer vs tsr_tpu's on shared weights:
    n and top-1 equal, mean confidence within 1e-4."""
    (jr, jrv, jj, jjv), (tr, tj) = models
    clean = walk_trees[0]
    got = teval.evaluate_directory(tj, str(clean), batch_size=5, size=SIZE,
                                   restorer=tr, resize=resize, device="cpu")
    want = jeval.evaluate_directory(
        _judge_apply(jj), jjv, str(clean), batch_size=5, size=SIZE,
        restorer_apply=lambda v, x: jr.apply(v, x, train=False),
        restorer_vars=jrv, resize=resize)
    assert got["n"] == want["n"] == 24
    assert got["top1"] == want["top1"]
    assert abs(got["confidence"] - want["confidence"]) <= 1e-4
