"""TIFF part 2c, ThunderScan (32809), SGILog (34676, 34677) and NeXT
(32766), read by the port as the reference reads them (cv2.imread, else
PIL's convert("RGB"), else refused as both refuse), max diff 0.

- ThunderScan: libtiff's decoder (tif_thunder.c) takes 4-bit samples
  alone, in strips (a tile is left as it was: "ThunderScan tile decoding
  is not implemented"). cv2 reads it with a palette; PIL reads 4-bit gray
  (L;4, MINISWHITE's L;4I) and palettes where cv2 gives None. The files
  are seeded code words of this module's encoder (runs of the last pixel,
  odd starts and runs of 0 among them, 2-bit and 3-bit deltas with their
  skip codes, raw values) over odd and even widths, several RowsPerStrip,
  FillOrder 1 and 2, orientations 1-8 of square and non-square images, a
  Predictor tag (which the codec ignores), and tiles.
- SGILog: cv2 reads LogL (Photometric 32844, 34676 alone) and LogLuv
  (32845, 34676 or 34677) through libtiff's RGBA reader, which sets the
  8-bit data format (L16toGry, Luv32toRGB, Luv24toRGB); Pillow has no mode
  for either. The files are cv2.imwrite's own (float images with 0,
  negative and past-1 values) and this module's byte planes (runs and
  literal strings) and 24-bit words: L at 0, negative and past Y = 1, uv
  indices past the table, strips and tiles, planar configuration 2, a
  sweep of BitsPerSample, SampleFormat, SamplesPerPixel, Photometric and
  Compression, orientations 1-8.
- Refused by both: NeXT at every depth (its decoder takes 2-bit samples,
  which cv2's header refuses and Pillow does not know), ThunderScan of
  other than 4 bits, SGILog under a photometric other than LogL or
  LogLuv; the port raises without naming TIFF and probes (0, 0).
- Damage: cut points and seeded mutations of ThunderScan and SGILog
  strips, rows that run over or fall short.
- chip_smoke.py's built files (phase 13) decode to the digests it holds
  of cv2.imread's pixels; generate_tree through both packages over a tree
  of these files writes the same files.
"""

import hashlib
import importlib.util
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from tsr_tpu import offline as joffline
from tsr_tpu_torch import native, offline

torch.set_num_threads(2)
HERE = Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location(
    "image_writers", HERE / "data" / "image_writers.py")
writers = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(writers)
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", HERE.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
quiet = lambda s: None  # noqa: E731

# 2-bit and 3-bit deltas by code (2 and 4 are the skip codes)
TWO = {0: 0, 1: 1, 3: -1}
THREE = {0: 0, 1: 1, 2: 2, 3: 3, 5: -3, 6: -2, 7: -1}


def _reads_as_reference(path):
    """probe(reader="cv2") is cv2's (h, w), (0, 0) where cv2 gives None;
    decode equals cv2, else PIL, max diff 0, else raises without naming
    TIFF. Returns the reader."""
    want = cv2.imread(str(path))
    reader = "cv2"
    if want is None:
        try:
            want, reader = np.asarray(Image.open(path).convert("RGB")), "pil"
        except Exception:
            reader = "none"
    else:
        want = want[:, :, ::-1]
    dims = native.probe([str(path)], reader="cv2").tolist()
    assert dims == ([list(want.shape[:2])] if reader == "cv2" else [[0, 0]])
    try:
        got = native.decode(str(path))
    except RuntimeError as e:
        assert "holds TIFF data" not in str(e), path
        got = None
    if reader == "none":
        assert got is None, path
    else:
        assert got is not None, (reader, path)
        np.testing.assert_array_equal(got, want, err_msg=str(path))
    return reader


# ------------------------------------------------------------ ThunderScan

def thunder_row(rng, row):
    """ThunderScan code words of one row of 4-bit pixels, each drawn from
    those that hold the next pixels: a run of the last pixel (from an odd
    pixel too), a run of 0, three 2-bit or two 3-bit deltas (some of them
    skip codes; past the row's end, skips), or a raw value."""
    out, last, i, n = bytearray(), 0, 0, len(row)

    def deltas(table, slots, skip):
        nonlocal last, i
        codes = []
        for _ in range(slots):
            d = (int(row[i]) - last + 8) % 16 - 8 if i < n else None
            pick = [c for c, v in table.items() if v == d]
            if i < n and pick and rng.random() < 0.85:
                codes.append(pick[0])
                last, i = int(row[i]), i + 1
            else:
                codes.append(skip)
        return codes

    while i < n:
        j = i
        while j < n and row[j] == last and j - i < 63:
            j += 1
        r = rng.random()
        if j > i and r < 0.6:
            out.append(j - i)
            i = j
        elif r < 0.05:
            out.append(0)
        elif r < 0.35:
            a, b, c = deltas(TWO, 3, 2)
            out.append(0x40 | a << 4 | b << 2 | c)
        elif r < 0.65:
            a, b = deltas(THREE, 2, 4)
            out.append(0x80 | a << 3 | b)
        else:
            last = int(row[i])
            out.append(0xC0 | last)
            i += 1
    return bytes(out)


def thunder_strips(rng, img, rps):
    """The strips of ``rps`` rows of 4-bit ``img``, coded row by row."""
    return [b"".join(thunder_row(rng, r) for r in img[y:y + rps])
            for y in range(0, img.shape[0], rps)]


def thunder_file(rng, img, photometric=3, rps=None, cmap=None, bits=4,
                 fillorder=1, strips=None, **kw):
    """A ThunderScan TIFF of 4-bit ``img`` (the strips of thunder_strips,
    bits reversed for FillOrder 2, or ``strips``)."""
    rps = rps or img.shape[0]
    strips = strips or thunder_strips(rng, img, rps)
    if fillorder == 2:
        strips = [writers.reverse_bits(s) for s in strips]
    if photometric == 3 and cmap is None:
        cmap = rng.integers(0, 65536, 3 << bits)
    return writers.tiff_file(img, bits=bits, photometric=photometric,
                             cmap=cmap, compression=32809, rps=rps,
                             strips=strips, fillorder=fillorder, **kw)


def _thunder_matrix(photometric):
    """Seeded ThunderScan layouts of ``photometric``: {name: (4-bit image,
    ColorMap, orientation, bytes)}."""
    rng = np.random.default_rng(700 + photometric)
    out = {}
    for k in range(32):
        square = k % 3 == 0
        h = int(rng.integers(1, 24))
        w = h if square else int(rng.integers(1, 40))
        img = (writers.gray(writers.smooth(rng, h, w)) >> 4
               ^ rng.integers(0, 2, (h, w))).astype(np.uint8)
        if k % 4 == 1:
            img[:, ::7] = rng.integers(0, 16)
        cmap = rng.integers(0, 65536, 48)
        kw = {"orientation": k % 8 + 1, "fillorder": 2 if k % 2 else 1,
              "rps": int(rng.integers(1, h + 1)) if k % 5 else None}
        if k % 6 == 5:
            kw["tags"] = {317: (3, [2])}
        out[f"{k}_{h}x{w}"] = (img, cmap, k % 8 + 1,
                               thunder_file(rng, img, photometric,
                                            cmap=cmap, **kw))
    return out


@pytest.mark.parametrize("photometric", [3, 1, 0])
def test_thunderscan_matrix_reads_as_reference(tmp_path, photometric):
    """4-bit palette (cv2), MINISBLACK and MINISWHITE (PIL) ThunderScan
    files over the seeded matrix (widths, RowsPerStrip, FillOrder,
    orientations 1-8, square or not, a Predictor tag): the reference's
    pixels, max diff 0; an upright file is the 4-bit image it was coded
    from, through the palette's high bytes or as gray times 17."""
    p = tmp_path / "t.png"
    readers = set()
    for img, cmap, orientation, data in _thunder_matrix(photometric).values():
        p.write_bytes(data)
        readers.add(_reads_as_reference(p))
        if orientation != 1:
            continue
        if photometric == 3:
            want = (cmap.reshape(3, 16) >> 8).T[img]
        else:
            want = np.repeat((img * 17 if photometric == 1
                              else 255 - img * 17)[:, :, None], 3, axis=2)
        np.testing.assert_array_equal(native.decode(str(p)), want)
    assert readers == ({"cv2", "pil"} if photometric == 3 else {"pil"})


def test_thunderscan_codes_decode_to_their_pixels(tmp_path):
    """Every code (runs from even and odd pixels and of 0, each 2-bit and
    3-bit delta and skip code, raw values) over rows of each width 1-17:
    cv2 reads the palette file as the 4-bit image it was coded from, and
    the port decodes it to cv2's pixels."""
    rng = np.random.default_rng(710)
    p = tmp_path / "c.png"
    seen = set()
    for w in range(1, 18):
        h = 6
        img = rng.integers(0, 16, (h, w)).astype(np.uint8)
        img[1] = img[1, 0]
        img[2] = (np.arange(w) % 5 + img[2, 0]) % 16
        img[3] = (img[3, 0] - np.arange(w) * 3) % 16
        strips = thunder_strips(rng, img, 3)
        for s in strips:
            for b in s:
                seen.add(b >> 6 if b >> 6 != 0 else ("run", b > 0))
                if b >> 6 == 1:
                    seen.update(("2", b >> k & 3) for k in (0, 2, 4))
                if b >> 6 == 2:
                    seen.update(("3", b >> k & 7) for k in (0, 3))
        cmap = np.arange(48) * 1000 + 500
        p.write_bytes(thunder_file(rng, img, 3, rps=3, cmap=cmap,
                                   strips=strips))
        assert _reads_as_reference(p) == "cv2"
        pal = (cmap.reshape(3, 16) >> 8).T
        np.testing.assert_array_equal(native.decode(str(p)), pal[img])
    assert {1, 2, 3, ("run", True), ("run", False)} <= seen
    assert {("2", c) for c in range(4)} <= seen
    assert {("3", c) for c in range(8)} <= seen


def test_thunderscan_tiles_and_depths_read_as_reference(tmp_path):
    """Tiles (libtiff leaves each as it was: cv2 reads zeros through the
    palette, PIL refuses), and ThunderScan of 1, 2, 8 and 16 bits, which
    libtiff's setup refuses ("Thunder decoder only supports 4bits per
    sample"): the reference's result, no file named TIFF."""
    rng = np.random.default_rng(720)
    p = tmp_path / "t.png"
    for photometric in (3, 1):
        for h, w, tile in ((16, 16, (16, 16)), (20, 40, (16, 32))):
            img = rng.integers(0, 16, (h, w)).astype(np.uint8)
            tiles = [thunder_row(rng, rng.integers(0, 16, w))
                     for _ in range(-(-h // tile[1]) * -(-w // tile[0]))]
            p.write_bytes(thunder_file(rng, img, photometric, tile=tile,
                                       strips=tiles))
            assert _reads_as_reference(p) == ("cv2" if photometric == 3
                                              else "none")
    img = rng.integers(0, 2, (6, 10)).astype(np.uint8)
    for bits in (1, 2, 8, 16):
        for photometric in (1, 3):
            if photometric == 3 and bits == 16:
                continue
            p.write_bytes(thunder_file(
                rng, img.astype(np.uint16 if bits == 16 else np.uint8),
                photometric, bits=bits,
                cmap=rng.integers(0, 65536, 3 << bits) if photometric == 3
                else None))
            assert _reads_as_reference(p) == "none", (bits, photometric)


def test_thunderscan_damage_reads_as_reference(tmp_path):
    """Cut points and seeded mutations of a one-strip and a many-strip
    file, and rows that run over ("Too much data": a run past the row's
    end) or fall short ("Not enough data"): the chunk keeps what it
    decoded before the error for cv2, and PIL refuses the file."""
    rng = np.random.default_rng(730)
    p = tmp_path / "d.png"
    readers = []
    for photometric in (3, 1):
        img = np.minimum(writers.gray(writers.smooth(rng, 14, 21)) >> 4,
                         15).astype(np.uint8)
        sources = [thunder_file(rng, img, photometric),
                   thunder_file(rng, img, photometric, rps=4, fillorder=2)]
        for data in sources:
            for cut in sorted(set(rng.integers(8, len(data), 12).tolist())):
                p.write_bytes(data[:cut])
                readers.append(_reads_as_reference(p))
            for _ in range(24):
                d = bytearray(data)
                for _ in range(int(rng.integers(1, 4))):
                    i = int(rng.integers(8, len(d)))
                    d[i] = (int(rng.integers(0, 256)) if rng.random() < 0.5
                            else d[i] ^ (1 << int(rng.integers(0, 8))))
                p.write_bytes(bytes(d))
                readers.append(_reads_as_reference(p))
        row = bytes([0xC5, 30])  # a run past a row of 21
        for strip in (row + thunder_row(rng, img[0]),
                      thunder_row(rng, img[0])[:-1],
                      bytes([0xC1, 0xC2, 0xC3])):
            p.write_bytes(thunder_file(rng, img[:1], photometric,
                                       strips=[strip]))
            readers.append(_reads_as_reference(p))
    assert {"cv2", "pil", "none"} <= set(readers)


# ----------------------------------------------------------------- SGILog

def sgilog_planes(rng, values, planes):
    """One row of SGILog ``values`` as byte planes, the high one first,
    each a seeded mix of runs (2-129 copies of a byte), literal strings
    (1-127 bytes) and empty strings."""
    out = bytearray()
    for k in range(planes - 1, -1, -1):
        b = [int(v) >> 8 * k & 255 for v in values]
        i = 0
        while i < len(b):
            j = i
            while j < len(b) and b[j] == b[i] and j - i < 129:
                j += 1
            if j - i >= 2 and rng.random() < 0.8:
                out += bytes([j - i + 126, b[i]])
                i = j
                continue
            n = min(int(rng.integers(1, 128)), len(b) - i)
            out += bytes([n]) + bytes(b[i:i + n])
            i += n
            if rng.random() < 0.05:
                out.append(0)
    return bytes(out)


def luv24_words(values):
    """One row of LogLuv24 values, 3 bytes each, the high one first."""
    return b"".join(int(v).to_bytes(3, "big") for v in values)


def sgilog_values(rng, kind, n):
    """``n`` seeded pixels of ``kind`` ("L": sign and 15-bit log, 0,
    negative and past Y = 1 among them; "32": that and 8-bit u, v; "24":
    10-bit log and 14-bit uv indices, some past the table's 16289)."""
    if kind == "24":
        L = np.where(rng.random(n) < 0.6, rng.integers(600, 800, n),
                     rng.integers(0, 1024, n))
        C = np.where(rng.random(n) < 0.1, rng.integers(16280, 16384, n),
                     rng.integers(0, 16289, n))
        return L << 14 | C
    L = np.where(rng.random(n) < 0.6, rng.integers(14000, 16700, n),
                 rng.integers(0, 1 << 16, n))
    L[rng.random(n) < 0.1] = 0
    return L if kind == "L" else L << 16 | rng.integers(0, 1 << 16, n)


def sgilog_file(rng, kind, h, w, rps=None, tile=None, tags=None, cut=None,
                **kw):
    """A TIFF of seeded SGILog ``kind`` data ("L": LogL under 34676, "32":
    LogLuv under 34676, "24": LogLuv under 34677) as cv2 writes it (16-bit
    signed samples) unless ``tags`` say otherwise; strips of ``rps`` rows
    or ``tile`` tiles, every row coded on its own; ``cut``: each chunk cut
    to a seeded length."""
    spp = 1 if kind == "L" else 3
    chunks = []
    if tile is None:
        rps = rps or h
        shape = [(min(rps, h - y), w) for y in range(0, h, rps)]
    else:
        shape = [(tile[1], tile[0])] * (-(-h // tile[1]) * -(-w // tile[0]))
    for rows, cols in shape * (spp if kw.get("planar") == 2 else 1):
        data = b"".join(
            luv24_words(sgilog_values(rng, kind, cols)) if kind == "24"
            else sgilog_planes(rng, sgilog_values(rng, kind, cols),
                               2 if kind == "L" else 4)
            for _ in range(rows))
        if cut:
            data = data[:int(rng.integers(0, len(data) + 1))] or b"\0"
        chunks.append(data)
    all_tags = {258: (3, [16] * spp), 339: (3, [2] * spp)}
    all_tags.update(tags or {})
    img = np.zeros((h, w, spp) if spp > 1 else (h, w), np.uint8)
    return writers.tiff_file(
        img, photometric=32844 if kind == "L" else 32845,
        compression=34677 if kind == "24" else 34676, rps=rps, tile=tile,
        strips=chunks, tags=all_tags, **kw)


@pytest.mark.parametrize("kind", ["L", "32", "24"])
def test_sgilog_written_by_cv2_reads_as_cv2(tmp_path, kind):
    """cv2.imwrite's own SGILog files (a gray float image as LogL under
    34676, RGB as LogLuv under 34676 or 34677), with zeros, negative
    values and values past 1: cv2.imread reads each through libtiff's
    8-bit conversion, and the port gives its pixels and size; Pillow
    cannot identify them."""
    rng = np.random.default_rng(800 + ["L", "32", "24"].index(kind))
    p = tmp_path / "w.tif"
    for k in range(10):
        h, w = int(rng.integers(1, 30)), int(rng.integers(1, 30))
        scale = (0.02, 0.4, 1.0, 4.0, 300.0)[k % 5]
        img = (rng.random((h, w) if kind == "L" else (h, w, 3))
               * scale).astype(np.float32)
        img.flat[::7] = 0
        img.flat[3::11] = -0.25
        compression = 34677 if kind == "24" else 34676
        assert cv2.imwrite(str(p), img, [cv2.IMWRITE_TIFF_COMPRESSION,
                                         compression])
        assert _reads_as_reference(p) == "cv2"
        with pytest.raises(Exception):
            Image.open(p).convert("RGB")
    assert native.probe([str(p)]).tolist() == [[h, w]]


@pytest.mark.parametrize("kind", ["L", "32", "24"])
def test_sgilog_matrix_reads_as_reference(tmp_path, kind):
    """Each SGILog kind over strips of several RowsPerStrip, tiles (edge
    tiles too), orientations 1-8 of square and non-square images, both
    byte orders, FillOrder 2 and planar configuration 2 (which libtiff's
    RGBA reader refuses for LogLuv, and LogL of one sample reads as
    contiguous): the reference's pixels, max diff 0."""
    rng = np.random.default_rng(810 + ["L", "32", "24"].index(kind))
    p = tmp_path / "m.tif"
    readers = []
    for k in range(24):
        h = int(rng.integers(1, 24))
        w = h if k % 3 == 0 else int(rng.integers(1, 40))
        kw = {"orientation": k % 8 + 1}
        if k % 4 == 1:
            kw["tile"] = (16, 16 * int(rng.integers(1, 3)))
        else:
            kw["rps"] = int(rng.integers(1, h + 1))
        if k % 5 == 2:
            kw["big"] = True
        if k % 7 == 3:
            kw["fillorder"] = 2
        if k % 9 == 4:
            kw["planar"] = 2
        p.write_bytes(sgilog_file(rng, kind, h, w, **kw))
        readers.append(_reads_as_reference(p))
    assert readers.count("cv2") >= 12


def test_sgilog_tags_read_as_reference(tmp_path):
    """The tags cv2's header, TIFFRGBAImageOK and the codec's setup read,
    swept over LogL and LogLuv data: BitsPerSample 1-64 and SampleFormat
    1-6 (LogLuv passes cv2's header whatever they are; the RGBA reader
    takes 1, 2, 4, 8 or 16 bits of no float format and reads them at 8),
    SamplesPerPixel 1-4, Photometric MINISBLACK, RGB, LogL and LogLuv
    under either compression ("Inappropriate photometric interpretation",
    "LogL data must have Compression=34676"): the reference's result."""
    rng = np.random.default_rng(820)
    p = tmp_path / "s.tif"
    readers = []
    for kind in ("L", "32", "24"):
        for bits in (1, 2, 4, 8, 12, 16, 32, 64):
            for sf in (1, 2, 3, 4, 5, 6):
                spp = 1 if kind == "L" else 3
                p.write_bytes(sgilog_file(rng, kind, 5, 9, tags={
                    258: (3, [bits] * spp), 339: (3, [sf] * spp)}))
                readers.append(_reads_as_reference(p))
        for photometric in (1, 2, 32844, 32845):
            for compression in (34676, 34677):
                for spp in (1, 2, 3, 4):
                    p.write_bytes(sgilog_file(rng, kind, 4, 6, tags={
                        262: (3, [photometric]), 259: (3, [compression]),
                        277: (3, [spp]), 258: (3, [16] * spp),
                        339: (3, [2] * spp)}))
                    readers.append(_reads_as_reference(p))
    assert "cv2" in readers and "none" in readers and "pil" not in readers


def test_sgilog_damage_reads_as_reference(tmp_path):
    """Cut points and seeded mutations of a LogL, a LogLuv32 and a
    LogLuv24 file of several strips, and chunks cut short ("Not enough
    data at row": the row and the rest of the chunk stay 0 for cv2): the
    reference's pixels, max diff 0, or a raise where both refuse."""
    rng = np.random.default_rng(830)
    p = tmp_path / "d.tif"
    readers = []
    for kind in ("L", "32", "24"):
        data = sgilog_file(rng, kind, 12, 17, rps=5)
        for cut in sorted(set(rng.integers(8, len(data), 12).tolist())):
            p.write_bytes(data[:cut])
            readers.append(_reads_as_reference(p))
        for _ in range(30):
            d = bytearray(data)
            for _ in range(int(rng.integers(1, 4))):
                i = int(rng.integers(8, len(d)))
                d[i] = (int(rng.integers(0, 256)) if rng.random() < 0.5
                        else d[i] ^ (1 << int(rng.integers(0, 8))))
            p.write_bytes(bytes(d))
            readers.append(_reads_as_reference(p))
        for _ in range(4):
            p.write_bytes(sgilog_file(rng, kind, 9, 13, rps=4, cut=True))
            readers.append(_reads_as_reference(p))
    assert {"cv2", "none"} <= set(readers)


# ------------------------------------------------------------ NeXT, sweep

@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16])
def test_next_reads_as_unreadable(tmp_path, bits):
    """NeXT (32766) of gray, palette and RGB samples: libtiff's decoder
    takes 2-bit samples alone, which cv2's header refuses, and Pillow does
    not know the codec: both refuse, the cv2 probe gives (0, 0) and the
    port raises without naming TIFF."""
    rng = np.random.default_rng(840 + bits)
    p = tmp_path / "n.tif"
    dtype = np.uint16 if bits == 16 else np.uint8
    for photometric, spp in ((1, 1), (0, 1), (3, 1), (2, 3)):
        if photometric == 3 and bits == 16:
            continue
        shape = (5, 8, spp) if spp > 1 else (5, 8)
        img = rng.integers(0, 1 << min(bits, 8), shape).astype(dtype)
        p.write_bytes(writers.tiff_file(
            img, bits=bits, photometric=photometric, compression=32766,
            cmap=rng.integers(0, 65536, 3 << bits) if photometric == 3
            else None,
            strips=[bytes(rng.integers(0, 256, 64, dtype=np.uint8))]))
        assert _reads_as_reference(p) == "none"


# ----------------------------------------------- chip_smoke's built files

def test_chip_smoke_built_files_match_their_digests(tmp_path):
    """chip_smoke.py's phase 13 files (ThunderScan palette, LogL,
    LogLuv32 and LogLuv24 of sides 8-16, and ThunderScan and LogLuv32 of
    its decode rates' size, built by its own writers): cv2.imread's RGB
    pixels of each hash to the digest the script holds, and the port
    decodes each to them."""
    files = chip_smoke.tiff_2c_files(tmp_path)
    assert sorted(files) == sorted(chip_smoke.TIFF_2C_DIGESTS)
    for name, p in files.items():
        want = cv2.imread(str(p))[:, :, ::-1]
        if name.startswith("tiff_2c_"):
            assert 8 <= min(want.shape[:2]) and max(want.shape[:2]) <= 16
        else:
            assert want.shape[:2] == chip_smoke.BUILT_TIFF_SIZE
        digest = hashlib.sha256(np.ascontiguousarray(want).tobytes())
        assert digest.hexdigest() == chip_smoke.TIFF_2C_DIGESTS[name], name
        np.testing.assert_array_equal(native.decode(str(p)), want)


def test_generate_tree_writes_what_the_reference_writes(tmp_path):
    """generate_tree("noise") through both packages over a tree of
    ThunderScan (palette: cv2; gray: PIL alone, which generate_tree's
    cv2.imread skips; 8-bit: neither), SGILog (cv2's own and built; LogLuv
    in planes: neither) and NeXT files: the same count and file names, the
    files cv2 gives None for skipped."""
    rng = np.random.default_rng(850)
    root = tmp_path / "src"
    img = rng.integers(0, 16, (12, 14)).astype(np.uint8)
    flt = (rng.random((10, 11, 3)) * 2).astype(np.float32)
    files = {
        "thunder_palette.png": thunder_file(rng, img, 3),
        "thunder_gray.png": thunder_file(rng, img, 1, rps=5),
        "thunder_8bit.png": thunder_file(rng, img, 1, bits=8),
        "logl.png": sgilog_file(rng, "L", 9, 12),
        "luv32_tiles.png": sgilog_file(rng, "32", 20, 18, tile=(16, 16)),
        "luv24.png": sgilog_file(rng, "24", 13, 10, rps=3),
        "luv_planar.png": sgilog_file(rng, "32", 9, 9, planar=2),
        "next.png": writers.tiff_file(img, bits=8, compression=32766)}
    written = tmp_path / "cv2_luv.tif"
    cv2.imwrite(str(written), flt, [cv2.IMWRITE_TIFF_COMPRESSION, 34677])
    files["cv2_luv.png"] = written.read_bytes()
    for k, (name, data) in enumerate(sorted(files.items())):
        out = root / f"c{k % 3}" / name
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(data)
    lines = []
    n = offline.generate_tree(str(root), str(tmp_path / "ours"), "noise",
                              log=lines.append, device="cpu")
    m = joffline.generate_tree(str(root), str(tmp_path / "ref"), "noise",
                               log=quiet)
    assert n == m == 5
    assert "Skipped 4 unreadable files" in lines
    ours = sorted(str(p.relative_to(tmp_path / "ours"))
                  for p in (tmp_path / "ours").glob("*/*"))
    ref = sorted(str(p.relative_to(tmp_path / "ref"))
                 for p in (tmp_path / "ref").glob("*/*"))
    assert ours == ref and len(ours) == n
