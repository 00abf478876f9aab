"""The JPEG data that cv2 reads (or PIL, where the reference falls back to
it) and the port once refused, against cv2, PIL and tsr_tpu on the CPU:

- the PIL resize backend keeps restore_tree and evaluate_directory on the
  host path, as the reference does;
- generate_tree skips exactly the files cv2.imread does not read;
- scans cut short (at every SOS, inside each scan, before EOI) and corrupt
  scans (bad Huffman codes, overwritten bytes, wrong or missing restart
  markers), with libjpeg-turbo's block smoothing of incomplete
  progressive data, decode equal to cv2.imread;
- CMYK and YCCK, equal to cv2.imread;
- lossless JPEG: predictors 1-7, point transform, restart intervals, 1, 3
  and 4 components, subsampling; equal to cv2.imread, and gray (which cv2
  refuses) equal to PIL's convert("RGB");
- arithmetic coding, sequential and progressive, with DAC conditioning and
  restarts, equal to cv2.imread.

Files are written by cv2 and PIL, or by tests/data/jpeg/jpeg_writers.py
(lossless and arithmetic coding, which neither writes); images are 20x28
to 96x120.
"""

import importlib.util
import io
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tsr_tpu import checkpoint as jckpt
from tsr_tpu import eval as jeval
from tsr_tpu import infer as jinfer
from tsr_tpu import offline as joffline
from tsr_tpu.data import gtsrb as jgtsrb
from tsr_tpu.models import ResUNet as JResUNet
from tsr_tpu.models import VGG16 as JVGG16
from tsr_tpu_torch import eval as teval
from tsr_tpu_torch import infer as tinfer
from tsr_tpu_torch import native, offline, parity
from tsr_tpu_torch.data import gtsrb
from tsr_tpu_torch.models import ResUNet, VGG16

FIXTURES = Path(__file__).resolve().parent / "data" / "jpeg"


def _load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  FIXTURES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


make_fixtures = _load("make_fixtures")
jw = _load("jpeg_writers")
smooth = make_fixtures.smooth
SAMPLING = make_fixtures.SAMPLING

torch.set_num_threads(2)
HI = jax.lax.Precision.HIGHEST
SIZE = 32
SMALL_CFG = (8, 8, "M", 16, "M", 16, "M")
quiet = lambda s: None  # noqa: E731


def _sos_offsets(data: bytes):
    return make_fixtures.sos_offsets(data)


def _encode(img, sampling, progressive, rst, quality=75):
    ok, enc = cv2.imencode(".jpg", img[:, :, ::-1], [
        cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
        cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
        cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
    assert ok
    return enc.tobytes()


def _reads_as(path, want):
    """decode equals ``want`` (RGB) exactly and load_batch reads the file,
    or both raise where want is None."""
    if want is None:
        with pytest.raises(RuntimeError):
            native.decode(str(path))
        with pytest.raises(RuntimeError, match="decoded 0/1"):
            native.load_batch([str(path)], 24)
        return
    got = native.decode(str(path))
    np.testing.assert_array_equal(got, want, err_msg=str(path))
    assert native.load_batch([str(path)], 24).shape == (1, 24, 24, 3)


def _cv2_rgb(path):
    img = cv2.imread(str(path))
    return None if img is None else img[:, :, ::-1]


def _pil_rgb(path):
    try:
        return np.asarray(Image.open(path).convert("RGB"))
    except Exception:
        return None


# ------------------------------------------------------------------- C1

@pytest.fixture(scope="module")
def pass_through_models():
    """A pass-through ResUNet (its input plus parity.OFFSET: the restored
    files show every input pixel) and a spread VGG judge, in both
    packages from the same reference-format state dicts."""
    torch.manual_seed(5)
    tr = parity.pass_through(ResUNet(widths=(8, 16, 32),
                                     bottleneck_width=64)).eval()
    tj = VGG16(num_classes=3, cfg=SMALL_CFG, fc_width=32,
               input_size=SIZE).eval()
    with torch.no_grad():
        for m in tj.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                torch.nn.init.normal_(m.weight, 0.0, 0.2)
                torch.nn.init.normal_(m.bias, 0.0, 0.2)
    jr = JResUNet(widths=(8, 16, 32), bottleneck_width=64, precision=HI)
    jrv = jckpt.resunet_from_pth({k: v.numpy() for k, v in
                                  tr.state_dict().items()})
    jj = JVGG16(num_classes=3, cfg=SMALL_CFG, fc_width=32, precision=HI)
    jjv = jckpt.vgg16_from_pth({k: v.numpy() for k, v in
                                tj.state_dict().items()}, num_classes=3)
    return (jr, jrv, jj, jjv), (tr, tj)


@pytest.fixture(scope="module")
def sign_tree(tmp_path_factory):
    """Two .jpg class trees (clean and noisy) of 9 images under 224 px, at
    sides around SIZE (PIL's resize antialiases the downscales)."""
    root = tmp_path_factory.mktemp("c1")
    rng = np.random.default_rng(40)
    for k in range(9):
        h, w = (int(v) for v in rng.integers(14, 60, 2))
        img = smooth(rng, h, w)
        for tree, im in (("clean", img), ("noisy", np.clip(
                img.astype(int) + rng.integers(-30, 31, img.shape), 0,
                255).astype(np.uint8))):
            p = root / tree / f"c{k % 3}" / f"{k}.jpg"
            p.parent.mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(p), im[:, :, ::-1])
    return root


def test_pil_backend_keeps_to_the_host_path_as_reference(
        pass_through_models, sign_tree, tmp_path):
    """C1: with set_resize_backend("pil") in both packages, restore_tree
    and evaluate_directory asked for resize="device" take the host path
    (PIL's resize) as tsr_tpu does: the restored files equal tsr_tpu's
    pixel for pixel (a pass-through restorer shows every input pixel) and
    the port's own host-resize run byte for byte; the PSNR/SSIM and the
    judge's top-1 equal tsr_tpu's, its confidence within 1e-4."""
    (jr, jrv, jj, jjv), (tr, tj) = pass_through_models
    old = (gtsrb.RESIZE_BACKEND, jgtsrb.RESIZE_BACKEND)
    try:
        gtsrb.set_resize_backend("pil")
        jgtsrb.set_resize_backend("pil")
        kw = dict(clean_dir=str(sign_tree / "clean"), batch_size=4,
                  size=SIZE, log=quiet)
        outs = {}
        for resize in ("device", "host"):
            outs[resize] = tinfer.restore_tree(
                tr, str(sign_tree / "noisy"), str(tmp_path / resize),
                resize=resize, device="cpu", **kw)
        ref = jinfer.restore_tree(jr.apply, jrv, str(sign_tree / "noisy"),
                                  str(tmp_path / "ref"), resize="device",
                                  has_batch_stats=True, **kw)
        files = sorted((tmp_path / "ref").glob("*/*.png"))
        assert len(files) == 9 and outs["device"]["images"] == 9
        for p in files:
            rel = p.relative_to(tmp_path / "ref")
            mine = tmp_path / "device" / rel
            assert mine.read_bytes() == (tmp_path / "host" / rel
                                         ).read_bytes(), rel
            np.testing.assert_array_equal(cv2.imread(str(mine)),
                                          cv2.imread(str(p)), err_msg=rel)
        assert outs["device"]["psnr"] == pytest.approx(ref["psnr"],
                                                       abs=1e-4)
        assert outs["device"]["ssim"] == pytest.approx(ref["ssim"],
                                                       abs=1e-5)
        res = teval.evaluate_directory(tj, str(sign_tree / "clean"),
                                       batch_size=4, size=SIZE,
                                       restorer=tr, resize="device",
                                       device="cpu")
        jres = jeval.evaluate_directory(
            lambda v, x, train=False: jj.apply(v, x, train=train), jjv,
            str(sign_tree / "clean"), batch_size=4, size=SIZE,
            restorer_apply=lambda v, x: jr.apply(v, x, train=False),
            restorer_vars=jrv, resize="device")
        assert res["n"] == jres["n"] == 9
        assert res["top1"] == jres["top1"]
        assert abs(res["confidence"] - jres["confidence"]) <= 1e-4
    finally:
        gtsrb.set_resize_backend(old[0])
        jgtsrb.set_resize_backend(old[1])


# ------------------------------------------------------------------- C2

def _fixture_tree(root: Path) -> Path:
    """The FEATURE_CASES and SKIP_CASES fixtures as a three-class tree."""
    files = [FIXTURES / f"{n}.jpg" for n, _ in make_fixtures.FEATURE_CASES]
    files += [FIXTURES / "skip" / f"{n}.jpg" for n in
              make_fixtures.SKIP_CASES]
    for k, p in enumerate(files):
        out = root / f"c{k % 3}" / p.name
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(p.read_bytes())
    return root


def test_generate_tree_skips_what_cv2_does_not_read(tmp_path):
    """C2: on a tree of every feature fixture plus one file of each skip
    class (12-bit, hierarchical, two components, a cut in the headers,
    lossless YCbCr and arithmetic) and the lossless gray file (cv2 gives
    None; PIL reads it), generate_tree("noise") writes what tsr_tpu's
    writes: the same count (make_fixtures' record), the same file names,
    and the log's Skipped line counts the rest; every written file decodes
    to the source's size."""
    src = _fixture_tree(tmp_path / "src")
    lines = []
    n = offline.generate_tree(str(src), str(tmp_path / "ours"), "noise",
                              log=lines.append, device="cpu")
    m = joffline.generate_tree(str(src), str(tmp_path / "ref"), "noise",
                               log=quiet)
    want = int(np.load(FIXTURES / "expected.npz")["generate_tree_written"])
    total = len(list(src.glob("*/*.jpg")))
    assert n == m == want and total - want == len(
        make_fixtures.SKIP_CASES) + 1
    assert f"Skipped {total - want} unreadable files" in lines
    ours = sorted(str(p.relative_to(tmp_path / "ours"))
                  for p in (tmp_path / "ours").glob("*/*"))
    ref = sorted(str(p.relative_to(tmp_path / "ref"))
                 for p in (tmp_path / "ref").glob("*/*"))
    assert ours == ref and len(ours) == want
    for rel in ours:
        assert (native.decode(str(tmp_path / "ours" / rel)).shape
                == cv2.imread(str(src / rel)).shape)


@pytest.mark.parametrize("name", make_fixtures.SKIP_CASES)
def test_skip_classes_raise_on_the_reader_paths(name):
    """A file that neither cv2 nor PIL reads raises on the reader paths
    (decode, load_batch, load_canvas), naming its feature where it has
    one; probe(reader="cv2") gives it (0, 0)."""
    p = str(FIXTURES / "skip" / f"{name}.jpg")
    assert cv2.imread(p) is None and _pil_rgb(p) is None
    match = {"precision12": "sample precision", "hierarchical":
             "hierarchical", "two_components": "component count",
             "cut_in_header": "failed to decode", "lossless_ycc":
             "lossless JPEG in YCbCr", "lossless_arith":
             "lossless arithmetic"}[name]
    with pytest.raises(RuntimeError, match=match):
        native.decode(p)
    with pytest.raises(RuntimeError, match="decoded 0/1"):
        native.load_batch([p], SIZE)
    with pytest.raises(RuntimeError, match="loaded 0/1"):
        native.load_canvas([p], np.zeros((1, 64, 64, 3), np.uint8))
    assert native.probe([p], reader="cv2").tolist() == [[0, 0]]


# ------------------------------------------------------- C3 and 13a: cuts

def _cut_cases():
    """(id, file bytes, cut) over cv2's encodes at four samplings,
    baseline and progressive, restart intervals 0 and 2: cut at every
    SOS, at a quarter, half and three quarters of each scan, and just
    before EOI."""
    rng = np.random.default_rng(60)
    img = smooth(rng, 40, 56)
    cases = []
    for sampling in ("444", "422", "420", "440"):
        for prog in (0, 1):
            for rst in (0, 2):
                data = _encode(img, sampling, prog, rst)
                sos = _sos_offsets(data)
                for k, o in enumerate(sos):
                    end = sos[k + 1] if k + 1 < len(sos) else len(data) - 2
                    head = o + 2 + (data[o + 2] << 8 | data[o + 3])
                    for frac in ("sos", 0.25, 0.5, 0.75):
                        cut = o if frac == "sos" else head + int(
                            (end - head) * frac)
                        cases.append((f"s{sampling}-p{prog}-r{rst}-scan{k}"
                                      f"-{frac}", data, cut))
                cases.append((f"s{sampling}-p{prog}-r{rst}-eoi", data,
                              len(data) - 2))
    return cases


CUT_CASES = _cut_cases()


@pytest.mark.parametrize("case", range(len(CUT_CASES)),
                         ids=[c[0] for c in CUT_CASES])
def test_cut_scan_reads_as_cv2(tmp_path, case):
    """C3 / 13a: a file cut short reads as cv2.imread reads it, max diff 0:
    the data after the cut is fake EOI markers, the scan in progress gets
    zero bits and then its MCUs are left alone (grey where nothing came
    before), and progressive data whose coefficients are left incomplete
    is block-smoothed (libjpeg-turbo's 5x5 DC window, coef_bits latched at
    each scan's start); a cut at the first SOS gives None and raises."""
    _, data, cut = CUT_CASES[case]
    p = tmp_path / "cut.jpg"
    p.write_bytes(data[:cut])
    want = _cv2_rgb(p)
    _reads_as(p, want)
    assert native.probe([str(p)], reader="cv2").tolist() == (
        [[0, 0]] if want is None else [list(want.shape[:2])])


def _corrupt_cases():
    """(id, file bytes): junk scan data, bytes of the scan overwritten,
    restart markers replaced or dropped."""
    rng = np.random.default_rng(61)
    cases = []
    for sampling in ("444", "420", "440"):
        for prog in (0, 1):
            img = smooth(rng, 40, 56)
            data = _encode(img, sampling, prog, 0)
            sos = _sos_offsets(data)[0]
            head = sos + 2 + (data[sos + 2] << 8 | data[sos + 3])
            cases.append((f"s{sampling}-p{prog}-ff00", data[:head] + bytes(
                [0xFF, 0x00]) * 400 + b"\xff\xd9"))
            for t in range(3):
                b = bytearray(data)
                for _ in range(2 * t + 1):
                    i = int(rng.integers(head, len(b) - 2))
                    if b[i] != 0xFF and b[i - 1] != 0xFF:
                        b[i] = int(rng.integers(0, 255))
                cases.append((f"s{sampling}-p{prog}-bytes{t}", bytes(b)))
            data = _encode(img, sampling, prog, 1)
            first = _sos_offsets(data)[0]
            rsts = [i for i in range(first, len(data) - 1)
                    if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]
            for j, new in ((1, 0xD3), (2, 0xD0), (3, 0xD7), (2, None),
                           (4, 0x01)):
                b = bytearray(data)
                i = rsts[j]
                if new is None:
                    del b[i:i + 2]
                else:
                    b[i + 1] = new
                cases.append((f"s{sampling}-p{prog}-rst{j}-"
                              f"{'drop' if new is None else hex(new)}",
                              bytes(b)))
    return cases


CORRUPT_CASES = _corrupt_cases()


@pytest.mark.parametrize("case", range(len(CORRUPT_CASES)),
                         ids=[c[0] for c in CORRUPT_CASES])
def test_corrupt_scan_reads_as_cv2(tmp_path, case):
    """C3 / 13a: corrupt entropy data reads as cv2.imread reads it (a bad
    Huffman code is 0; a wrong or missing RSTn goes through
    jpeg_resync_to_restart), or raises where cv2 gives None."""
    p = tmp_path / "bad.jpg"
    p.write_bytes(CORRUPT_CASES[case][1])
    _reads_as(p, _cv2_rgb(p))


# ------------------------------------------------------- 13b: CMYK / YCCK

@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("transform", ["adobe0", "ycck", "none", "adobe1"])
def test_cmyk_and_ycck_read_as_cv2(tmp_path, subsampling, transform):
    """13b: PIL's 4-component JPEG (Adobe transform 0: CMYK), relabelled
    to transform 2 (YCCK, which jdcolor.c turns into CMYK) or 1 (YCCK too,
    with libjpeg's warning), or with its APP14 dropped (plain CMYK),
    equals cv2.imread, whose own CMYK -> BGR step the port copies."""
    rng = np.random.default_rng(62 + subsampling)
    buf = io.BytesIO()
    Image.fromarray(smooth(rng, 37, 53)).convert("CMYK").save(
        buf, "JPEG", quality=85, subsampling=subsampling)
    data = buf.getvalue()
    i = data.index(b"Adobe")
    if transform in ("ycck", "adobe1"):
        flag = 2 if transform == "ycck" else 1
        data = data[:i + 11] + bytes([flag]) + data[i + 12:]
    elif transform == "none":
        start = i - 4
        data = data[:start] + data[start + 2 + (data[start + 2] << 8
                                                | data[start + 3]):]
        assert b"Adobe" not in data
    p = tmp_path / "cmyk.jpg"
    p.write_bytes(data)
    want = _cv2_rgb(p)
    assert want is not None
    _reads_as(p, want)


# ------------------------------------------------------- 13c: lossless

@pytest.mark.parametrize("psv", range(1, 8))
@pytest.mark.parametrize("pt,restart", [(0, 0), (2, 2), (1, 1)])
def test_lossless_gray_reads_as_pil(tmp_path, psv, pt, restart):
    """13c: a gray lossless JPEG (cv2.imread gives None, and the reference
    falls back to PIL) equals PIL's convert("RGB"), which is the source's
    samples shifted by the point transform; generate_tree's probe skips
    it, as cv2 refuses it; cut short it raises, as PIL does."""
    img = smooth(np.random.default_rng(70 + psv), 21, 29)[:, :, 0]
    data = jw.lossless([img], psv=psv, pt=pt, restart=restart)
    p = tmp_path / "gray.jpg"
    p.write_bytes(data)
    assert cv2.imread(str(p)) is None
    want = _pil_rgb(p)
    np.testing.assert_array_equal(want[:, :, 0], (img >> pt) << pt)
    _reads_as(p, want)
    assert native.probe([str(p)]).tolist() == [[21, 29]]
    assert native.probe([str(p)], reader="cv2").tolist() == [[0, 0]]
    p.write_bytes(data[:len(data) * 2 // 3])
    assert _pil_rgb(p) is None
    _reads_as(p, None)


LOSSLESS_COLOR = (
    ("rgb-ids123", dict(ids=(1, 2, 3))),
    ("rgb-idsRGB-psv4", dict(ids=(82, 71, 66), psv=4)),
    ("adobe0-restart", dict(adobe=0, restart=2, psv=5)),
    ("non-interleaved", dict(interleaved=False, psv=6, pt=1, restart=3)),
    ("420", dict(sub=(2, 2), psv=7)),
    ("422-restart", dict(sub=(2, 1), psv=3, restart=1)),
    ("420-odd", dict(sub=(2, 2), psv=2, odd=True)),
    ("cmyk", dict(four=True, psv=4)),
    ("cmyk-adobe0", dict(four=True, adobe=0, psv=1)),
)


@pytest.mark.parametrize("case", [c for c, _ in LOSSLESS_COLOR])
def test_lossless_color_reads_as_cv2(tmp_path, case):
    """13c: a lossless JPEG of 3 components (RGB: libjpeg-turbo reads
    every lossless file without JFIF or an Adobe transform as RGB) or 4
    (CMYK), interleaved or not, subsampled (plain replication: lossless
    has no fancy upsampling), with restarts, equals cv2.imread (and PIL's
    convert("RGB") for 3 components)."""
    how = dict(LOSSLESS_COLOR)[case]
    rng = np.random.default_rng(80)
    h, w = (23, 31) if how.get("odd") else (20, 28)
    img = smooth(rng, h, w)
    planes = [img[:, :, k] for k in range(3)]
    sampling = None
    if "sub" in how:
        hs, vs = how["sub"]
        planes = [planes[0]] + [
            np.ascontiguousarray(q[::vs, ::hs]) for q in planes[1:]]
        sampling = [(hs, vs), (1, 1), (1, 1)]
    ids = how.get("ids", (1, 2, 3))
    if how.get("four"):
        planes.append(img[:, :, 1] // 2 + 60)
        ids = (1, 2, 3, 4)
    data = jw.lossless(planes, psv=how.get("psv", 1), pt=how.get("pt", 0),
                       restart=how.get("restart", 0), ids=ids,
                       sampling=sampling,
                       interleaved=how.get("interleaved", True),
                       adobe=how.get("adobe"))
    p = tmp_path / "color.jpg"
    p.write_bytes(data)
    want = _cv2_rgb(p)
    assert want is not None
    if not how.get("four"):
        np.testing.assert_array_equal(want, _pil_rgb(p))
    _reads_as(p, want)
    assert native.probe([str(p)], reader="cv2").tolist() == [[h, w]]


# ------------------------------------------------------- 13d: arithmetic

ARITH_CASES = [
    (f"p{int(prog)}-{s[0][0]}{s[0][1]}-r{rst}", prog, s, rst, None)
    for prog in (False, True)
    for s in (((1, 1),) * 3, ((2, 2), (1, 1), (1, 1)),
              ((2, 1), (1, 1), (1, 1)), ((1, 2), (1, 1), (1, 1)))
    for rst in (0, 3)] + [
    ("dac-sequential", False, ((2, 2), (1, 1), (1, 1)), 0,
     [(0, 0x31), (1, 0x20), (16, 2), (17, 9)]),
    ("dac-progressive", True, ((2, 2), (1, 1), (1, 1)), 2,
     [(0, 0x52), (16, 12)])]


@pytest.mark.parametrize("case", range(len(ARITH_CASES)),
                         ids=[c[0] for c in ARITH_CASES])
def test_arithmetic_reads_as_cv2(tmp_path, case):
    """13d: arithmetic-coded JPEG, sequential (SOF9) and progressive
    (SOF10, libjpeg's simple progression), at four samplings, with restart
    intervals and DAC conditioning, equals cv2.imread; and cut in its
    third scan (progressive: block-smoothed) too."""
    _, prog, sampling, rst, dac = ARITH_CASES[case]
    img = smooth(np.random.default_rng(90 + case), 37, 53)
    data = jw.arithmetic(img, progressive=prog, restart=rst,
                         sampling=sampling, dac=dac)
    p = tmp_path / "arith.jpg"
    p.write_bytes(data)
    want = _cv2_rgb(p)
    assert want is not None and np.abs(want.astype(int) - img).mean() < 20
    _reads_as(p, want)
    sos = _sos_offsets(data)
    if len(sos) > 3:
        p.write_bytes(data[:(sos[2] + sos[3]) // 2])
        _reads_as(p, _cv2_rgb(p))


def test_relabelled_baseline_reads_as_cv2_as_arithmetic(tmp_path):
    """13d: a baseline stream whose SOF0 is relabelled SOF9 decodes in cv2
    (its Huffman bits read as arithmetic code, with a corrupt-data
    warning); the port reads it equally."""
    rng = np.random.default_rng(95)
    for h, w in ((20, 28), (40, 56)):
        data = make_fixtures.relabel_sof(
            _encode(smooth(rng, h, w), "420", 0, 0), 0xC9)
        p = tmp_path / "sof9.jpg"
        p.write_bytes(data)
        want = _cv2_rgb(p)
        assert want is not None and want.shape == (h, w, 3)
        _reads_as(p, want)


# ------------------------------------------- what libjpeg reads besides

def _reference_read(path):
    """The reference's reader: cv2.imread, else PIL's convert("RGB")."""
    want = _cv2_rgb(path)
    return want if want is not None else _pil_rgb(path)


@pytest.mark.parametrize("table", range(4))
def test_missing_huffman_table_reads_as_cv2(tmp_path, table):
    """A sequential file without one of its four DHT tables reads as cv2
    reads it: libjpeg's Huffman decoder gives tables 0 and 1 that are
    still undefined at the first scan Annex K's (motion JPEG frames leave
    them out); a progressive file without one is refused by both."""
    img = smooth(np.random.default_rng(100 + table), 24, 32)
    for prog in (0, 1):
        data = _encode(img, "420", prog, 0)
        at = [i for i in range(len(data) - 1)
              if data[i] == 0xFF and data[i + 1] == 0xC4][table]
        length = data[at + 2] << 8 | data[at + 3]
        p = tmp_path / f"p{prog}.jpg"
        p.write_bytes(data[:at] + data[at + 2 + length:])
        want = _cv2_rgb(p)
        assert (want is None) == bool(prog)
        _reads_as(p, want)


@pytest.mark.parametrize("marker", [0xE3, 0xFE, 0xC1, 0xCD, 0xF5, 0xDA])
def test_lossless_gray_with_a_marker_in_its_scan_reads_as_pil(tmp_path,
                                                               marker):
    """A gray lossless file whose scan a marker cuts short reads as PIL
    reads it: zeros for the rest of the scan (grey rows); then libjpeg
    reads on to EOI, where an APPn or COM segment running past the file's
    end only suspends (PIL reads the file) and a second SOF, an
    unsupported or reserved marker or a second scan is an error (PIL
    raises)."""
    img = smooth(np.random.default_rng(110), 24, 32)[:, :, 2]
    data = jw.lossless([img], psv=1)
    cut = _sos_offsets(data)[0] + 10 + len(data) // 3
    p = tmp_path / "gray.jpg"
    p.write_bytes(data[:cut] + bytes([0xFF, marker, 0x40, 0x00])
                  + data[cut:])
    want = _pil_rgb(p)
    assert (want is None) == (marker not in (0xE3, 0xFE))
    _reads_as(p, want)


@pytest.mark.parametrize("mark", [b"MM", b"II", b"M\xec", b"IM", b"\x00I",
                                  b"xx"])
@pytest.mark.parametrize("fixture", ["exif8_be", "exif6_le"])
def test_exif_byte_order_mark_as_cv2(tmp_path, fixture, mark):
    """cv2 reads a TIFF byte-order mark of "II" as little-endian and any
    other as big-endian (then a wrong order fails the 42 check: no
    orientation); the port orients each file as cv2 does."""
    data = bytearray((FIXTURES / f"{fixture}.jpg").read_bytes())
    at = data.index(b"Exif\0\0") + 6
    data[at:at + 2] = mark
    p = tmp_path / "exif.jpg"
    p.write_bytes(bytes(data))
    _reads_as(p, _cv2_rgb(p))


@pytest.mark.parametrize("seed", range(8))
def test_mutated_files_read_as_reference(tmp_path, seed):
    """60 files a seed, each a committed fixture with bytes overwritten,
    flipped, cut, deleted or set to 0xFF / 0x00, or a marker inserted:
    where the reference reads one (cv2.imread, else PIL), the port
    decodes it equal; where the reference refuses it, the port raises."""
    rng = np.random.default_rng(1000 + seed)
    seeds = [p.read_bytes() for p in sorted(FIXTURES.glob("*.jpg"))]
    p = tmp_path / "m.jpg"
    for _ in range(60):
        data = bytearray(seeds[int(rng.integers(len(seeds)))])
        kind = int(rng.integers(6))
        for _ in range(int(rng.integers(1, 6))):
            i = int(rng.integers(2, len(data)))
            if kind == 0:
                data[i] = int(rng.integers(256))
            elif kind == 1:
                data = data[:max(i, 8)]
            elif kind == 2:
                data[i] ^= 1 << int(rng.integers(8))
            elif kind == 3:
                data[i:i] = bytes([0xFF, 0xC0 + int(rng.integers(64))])
            elif kind == 4:
                del data[i:i + 1 + int(rng.integers(16))]
            else:
                data[i] = 0xFF if rng.integers(2) else 0x00
        p.write_bytes(bytes(data))
        _reads_as(p, _reference_read(p))
