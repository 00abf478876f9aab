"""TIFF part 2d: single-strip TIFFs whose RGBA buffer (4 bytes a pixel)
reaches 1020054732 bytes, 95 % of 1 GiB, which cv2.imread reads through
its scanline branch (TiffDecoder::readData, TIFFReadScanline a row at a
time), read by the port as cv2 reads them: the cv2 probe's shape, or (0,
0) where cv2 gives None, and decode's pixels with max diff 0.

- The branch: one strip of the whole image (RowsPerStrip absent,
  0xFFFFFFFF or the height), 1, 3 or 4 samples of 8 or 16 bits,
  MINISWHITE, MINISBLACK or RGB, contiguous; 4 samples only with one
  ExtraSamples value, associated alpha (without the tag cv2 gives None).
  The bound counts 4 bytes a pixel whatever the samples' size, and is
  taken at ``>=``: 825287 x 309 pixels (exactly 1020054732 bytes) read
  through the branch, 256553 x 994 (4 bytes fewer) through the RGBA
  reader. Palette, separate planes, 1-bit samples, unassociated alpha, a
  RowsPerStrip past the height, 2 samples and 4 of gray stay on the RGBA
  reader (read, where its buffer stays under 1 GiB, as before).
- The reading: the rows as stored, MINISWHITE not inverted, no
  orientation (a square image of 5-8 transposed afterwards by imread, a
  non-square one None), a 16-bit sample's high byte (either byte order,
  signed too), gray to three channels, 3 samples as RGB whatever the
  photometric, alpha dropped; the horizontal predictor a row at a time,
  FillOrder 2; none, PackBits (a run that crosses a row's end is cut
  there and the rest of it dropped), LZW, deflate and JPEG.
- Failures: any row that fails gives None (a deflate stream cut short,
  corrupt, a row short or a bad Adler-32 after the last row; LZW cut
  short; uncompressed data one byte short or a byte count past the end of
  the file; a Compression that names no codec or one OpenCV's build
  leaves out; RowsPerStrip 0); data after the last row is not read.
- Sizes that refused today: 16384 x 16400 gray 8 and 16-bit, 20000 x 15000
  and 20000 x 17100 RGB (stand-ins for the 32768-wide gray files, which
  are the same branch at more rows); two strips of 32768 x 8200 and a
  16384 x 16400 palette strip stay refused as cv2 refuses them.
- The reader paths: where cv2 gives None here, Pillow's decompression-bomb
  rule refuses the file too (every such image passes 2 x 89,478,485
  pixels), so the reference's _decode_resize raises and native.decode
  raises "failed to decode".
- Memory: a child process that only decodes the largest file here (20000
  x 17100 RGB) grows by at most twice the output plus the file plus 64 MiB
  (no 4-byte-a-pixel buffer, no whole decompressed strip).
- chip_smoke.py's files (phase 13's tiff_scanline group) match the
  digests it holds of cv2.imread's pixels; generate_tree through both
  packages over a tree of a small image and the half-deflate file writes
  the same files.

The files are built at test time (chip_smoke.scanline_tiff: deflate
strips whose 256-row blocks are compressed once, so each is a few hundred
KB to a few MB), read by cv2 and the port side by side, and compared a
band of rows at a time.
"""

import hashlib
import importlib.util
import io
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from tsr_tpu import offline as joffline
from tsr_tpu.data import gtsrb as jgtsrb
from tsr_tpu_torch import native, offline

torch.set_num_threads(2)
HERE = Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", HERE.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
quiet = lambda s: None  # noqa: E731

H, W = chip_smoke.TIFF_SCANLINE_SIZE  # 4 H W = 1.03e9: the branch
BELOW = 15000                         # 4 H W = 0.98e9: the RGBA reader
rows = chip_smoke.scanline_rows
tiff = chip_smoke.scanline_tiff


def deflate(h, block_of):
    return chip_smoke.scanline_deflate(h, block_of)


def plain(w, spp=1, bits=8, big=False):
    """scanline_rows' bytes of rows [y0, y1)."""
    return lambda y0, y1: rows(w, y0, y1, spp, bits, big).tobytes()


def predicted(w, spp=1, bits=8, big=False):
    """scanline_rows of rows [y0, y1) differenced along each row, sample by
    sample (the horizontal predictor), in the file's byte order."""
    def block(y0, y1):
        v = rows(w, y0, y1, spp, bits).astype(np.int64)
        v[:, 1:] -= v[:, :-1].copy()
        v &= (1 << bits) - 1
        return v.astype((">u2" if big else "<u2") if bits == 16
                        else np.uint8).tobytes()
    return block


def reversed_bits(data):
    table = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))
    return data.translate(table)


def packbits_across_rows(data):
    """PackBits literal runs of 128 bytes over the whole strip, which
    cross the ends of rows of a width that is no multiple of 128."""
    a = np.frombuffer(data, np.uint8)
    n = len(a) // 128 * 128
    body = np.concatenate([np.full((n // 128, 1), 127, np.uint8),
                           a[:n].reshape(-1, 128)], 1).tobytes()
    rest = a[n:].tobytes()
    return body + (bytes([len(rest) - 1]) + rest if rest else b"")


def jpeg_strip():
    """Pillow's one-strip JPEG TIFF (libtiff's codec) of scanline_rows'
    gray samples."""
    buf = io.BytesIO()
    Image.fromarray(rows(W, 0, H)[..., 0]).save(
        buf, "TIFF", compression="jpeg", strip_size=1 << 40)
    return buf.getvalue()


def lzw_codes(data):
    """(code, width) of TIFF LZW over ``data`` from a Clear code, as
    image_writers.lzw writes them (one code early wider, a Clear where the
    table fills), without the EOI code, and the width the next code
    takes."""
    table = {bytes([i]): i for i in range(256)}
    codes, nxt, width, w = [(256, 9)], 258, 9, b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        codes.append((table[w], width))
        table[wc] = nxt
        nxt += 1
        if nxt == 4094:
            codes.append((256, width))
            table = {bytes([i]): i for i in range(256)}
            nxt, width = 258, 9
        elif nxt >= 1 << width:
            width += 1
        w = bytes([c])
    codes.append((table[w], width))
    return codes, width


def msb_first(codes):
    acc = bits = 0
    for code, width in codes:
        acc = (acc << width) | code
        bits += width
    pad = -bits % 8
    return ((acc << pad).to_bytes((bits + pad) // 8, "big"))


def lzw_rows(y0, y1):
    """Gray rows of (7 x + 32 y) mod 256, which repeat every 8 rows."""
    x = (7 * np.arange(W)) & 255
    return np.stack([(x + 32 * y) & 255 for y in range(y0, y1)]).astype(
        np.uint8)


def lzw_strip(h=H, period=8):
    """One LZW strip of lzw_rows: the codes of each ``period`` rows from a
    Clear code, closed by Clear codes (the first at the width the next code
    takes, the rest at 9 bits) to a whole byte, so that one block's bytes
    stand for each; the last rows then EOI."""
    codes, width = lzw_codes(lzw_rows(0, period).tobytes())
    bits = sum(n for _, n in codes) + width
    codes.append((256, width))
    while bits % 8:
        codes.append((256, 9))
        bits += 9
    tail, width = lzw_codes(lzw_rows(0, h % period).tobytes())
    return msb_first(codes) * (h // period) + msb_first(
        tail + [(257, width)])


def planar_rgb():
    """RGB in three planes, one strip a plane."""
    strips = [deflate(H, lambda y0, y1, k=k: np.ascontiguousarray(
        rows(W, y0, y1, 3)[..., k]).tobytes()) for k in range(3)]
    return chip_smoke.tiff_layout(
        {256: (4, [W]), 257: (4, [H]), 258: (3, [8, 8, 8]), 259: (3, [8]),
         262: (3, [2]), 273: (4, None), 277: (3, [3]), 278: (4, [H]),
         279: (4, [len(s) for s in strips]), 284: (3, [2])}, strips)


def two_strips():
    """Gray 32768 x 16400 in two strips of 8200 rows."""
    strip = deflate(8200, plain(32768))
    return chip_smoke.tiff_layout(
        {256: (4, [32768]), 257: (4, [16400]), 258: (3, [8]),
         259: (3, [8]), 262: (3, [1]), 273: (4, None), 277: (3, [1]),
         278: (4, [8200]), 279: (4, [len(strip)] * 2)}, [strip, strip])


def palette():
    ramp = np.arange(256)
    cmap = np.concatenate([ramp, 255 - ramp, (ramp * 7) & 255]) * 257
    return {320: (3, cmap.tolist())}


def half(data):
    return data[:len(data) // 2]


# files cv2 reads: {name: builder}
READS = {
    # ISSUE's table
    "gray8_deflate_data_past_last_row": lambda: tiff(
        W, H, data=deflate(H + 5, plain(W)) + b"\x12\x34" * 64),
    "gray8_uncompressed_orientation2": lambda: tiff(
        W, H, compression=1, tags={274: (3, [2])}),
    "gray8_below_miniswhite_orientation3": lambda: tiff(
        W, BELOW, photometric=0, tags={274: (3, [3])}),
    "gray8_below_half_deflate": lambda: tiff(
        W, BELOW, data=half(deflate(BELOW, plain(W)))),
    "gray16_big_endian_predictor": lambda: tiff(
        W, H, bits=16, big=True, tags={317: (3, [2])},
        data=deflate(H, predicted(W, 1, 16, True))),
    "rgba_unassociated": lambda: tiff(W, H, 4, photometric=2,
                                      tags={338: (3, [2])}),
    "rgba_associated_orientation4": lambda: tiff(
        W, H, 4, photometric=2, tags={338: (3, [1]), 274: (3, [4])}),
    "palette": lambda: tiff(W, H, photometric=3, tags=palette()),
    "gray8_16384x16400_fillorder2_no_rows_per_strip": lambda: tiff(
        W, 16400, tags={266: (3, [2]), 278: None},
        data=reversed_bits(deflate(16400, plain(W)))),
    "miniswhite16_signed_16384x16400": lambda: tiff(
        W, 16400, bits=16, photometric=0, tags={339: (3, [2])}),
    "rgb8_20000x15000_predictor": lambda: tiff(
        20000, 15000, 3, photometric=2, tags={317: (3, [2])},
        data=deflate(15000, predicted(20000, 3))),
    "rgb8_20000x17100": lambda: tiff(20000, 17100, 3, photometric=2),
    # the bound, one pixel either side: 4 w h = 1020054732 and 4 fewer
    "bound_at_miniswhite": lambda: tiff(825287, 309, photometric=0),
    "bound_below_miniswhite": lambda: tiff(256553, 994, photometric=0),
    # the branch's other settings
    "gray_3_samples_rows_per_strip_ffffffff": lambda: tiff(
        W, H, 3, tags={278: (4, [0xFFFFFFFF])}),
    "rows_per_strip_past_height_miniswhite": lambda: tiff(
        W, H, photometric=0, tags={278: (4, [H + 1])}),
    "separate_planes_rgb": planar_rgb,
    "gray1": lambda: tiff(W, H, bits=1, data=deflate(H, lambda y0, y1: (
        np.packbits(rows(W, y0, y1)[..., 0] & 1, axis=1).tobytes()))),
    "square_orientation5": lambda: tiff(16000, 16000, tags={274: (3, [5])}),
    "square_orientation6": lambda: tiff(16000, 16000, tags={274: (3, [6])}),
    "packbits_runs_across_rows": lambda: tiff(
        16383, H, compression=32773,
        data=packbits_across_rows(rows(16383, 0, H).tobytes())),
    "lzw": lambda: tiff(W, H, compression=5, data=lzw_strip()),
    "jpeg": jpeg_strip,
}


def _deflate_cut(edit):
    return lambda: tiff(W, H, data=edit(deflate(H, plain(W))))


# files cv2 gives None for: {name: builder}
REFUSES = {
    "rgba_without_extrasamples": lambda: tiff(W, H, 4, photometric=2),
    "rows_per_strip_0": lambda: tiff(W, H, tags={278: (4, [0])}),
    "gray4": lambda: tiff(W, H, bits=4, data=deflate(H, lambda y0, y1: (
        np.packbits(np.unpackbits(rows(W, y0, y1)[..., 0], axis=1)
                    .reshape(y1 - y0, W, 8)[:, :, 4:].reshape(y1 - y0, -1),
                    axis=1).tobytes()))),
    **{f"compression_{c}": (lambda c=c: tiff(
        W, H, compression=c, data=deflate(H, plain(W))))
       for c in (3, 6, 99, 34925)},
    "deflate_bad_adler32": _deflate_cut(
        lambda d: d[:-1] + bytes([d[-1] ^ 1])),
    "deflate_corrupt_middle": _deflate_cut(
        lambda d: d[:len(d) // 2] + bytes([d[len(d) // 2] ^ 0x55])
        + d[len(d) // 2 + 1:]),
    "deflate_one_row_short": lambda: tiff(W, H, data=deflate(
        H - 1, plain(W))),
    "uncompressed_one_byte_short": lambda: tiff(
        W, H, compression=1,
        data=b"".join(rows(W, y, min(H, y + 256)).tobytes()
                      for y in range(0, H, 256))[:-1]),
    "uncompressed_count_past_end": lambda: tiff(W, H, compression=1)[:-1],
    "lzw_cut": lambda: tiff(W, H, compression=5,
                            data=lzw_strip()[:-4096]),
    "orientation6_not_square": lambda: tiff(W, H, tags={274: (3, [6])}),
    "two_strips_32768x16400": two_strips,
    "palette_16384x16400": lambda: tiff(W, 16400, photometric=3,
                                        tags=palette()),
}


def read_both(path, side_by_side=True):
    """cv2.imread (RGB) beside the port's decode (its RuntimeError where it
    raises) and cv2 probe, all three side by side, or the port's decode
    before cv2's where three images of the size would pass 3 GB."""
    def port():
        try:
            return native.decode(str(path))
        except RuntimeError as e:
            return e
    with ThreadPoolExecutor(2) as pool:
        dims = pool.submit(native.probe, [str(path)], reader="cv2")
        if side_by_side:
            ref = pool.submit(cv2.imread, str(path))
            got = port()
            ref = ref.result()
        else:
            got = port()
            ref = cv2.imread(str(path))
        dims = dims.result().tolist()
    return None if ref is None else ref[:, :, ::-1], got, dims


def assert_equal_bands(got, ref, band=1024):
    assert got.shape == ref.shape
    for y in range(0, ref.shape[0], band):
        a, b = got[y:y + band], ref[y:y + band]
        if not np.array_equal(a, b):
            diff = int(np.abs(a.astype(np.int16) - b).max())
            bad = np.nonzero((a != b).any(axis=(1, 2)))[0]
            pytest.fail(f"rows {y + bad[0]}..: max diff {diff} from cv2")


@pytest.mark.parametrize("name", sorted(READS))
def test_reads_as_cv2(name, tmp_path):
    p = tmp_path / f"{name}.tif"
    p.write_bytes(READS[name]())
    ref, got, dims = read_both(p, side_by_side=not name.startswith("rgb8_2"))
    p.unlink()
    assert ref is not None, f"cv2 gives None for {name}"
    assert not isinstance(got, RuntimeError), got
    assert dims == [list(ref.shape[:2])]
    assert_equal_bands(got, ref)


@pytest.mark.parametrize("name", sorted(REFUSES))
def test_refuses_as_cv2(name, tmp_path):
    p = tmp_path / f"{name}.tif"
    p.write_bytes(REFUSES[name]())
    ref, got, dims = read_both(p)
    p.unlink()
    assert ref is None, f"cv2 reads {name}"
    assert dims == [[0, 0]]
    assert isinstance(got, RuntimeError) and "failed to decode" in str(got)


def test_chip_smoke_files_match_cv2(tmp_path):
    """chip_smoke.py's tiff_scanline files: the MINISWHITE and
    orientation-3 ones (as stored: once inverted and flipped, off by 255
    and 242) equal to their TIFF_SCANLINE_DIGESTS, which are cv2.imread's
    pixels, and the port's; the half-deflate one (once read with zeros
    past the break) refused by both."""
    files = chip_smoke.tiff_scanline_files(tmp_path)
    assert sorted(files) == sorted(chip_smoke.TIFF_SCANLINE_FILES)
    for name, p in sorted(files.items()):
        ref, got, dims = read_both(p)
        if name not in chip_smoke.TIFF_SCANLINE_DIGESTS:
            assert ref is None and dims == [[0, 0]]
            assert isinstance(got, RuntimeError)
            continue
        digest = chip_smoke.TIFF_SCANLINE_DIGESTS[name]
        assert hashlib.sha256(
            np.ascontiguousarray(ref).tobytes()).hexdigest() == digest
        assert dims == [[H, W]]
        assert hashlib.sha256(got.tobytes()).hexdigest() == digest
        stored = rows(W, 0, H)[..., 0]
        assert np.array_equal(got[:64, :, 0], stored[:64])
        assert np.array_equal(got[-64:, :, 2], stored[-64:])


def test_reader_paths_raise_as_the_reference_does(tmp_path):
    """The half-deflate file: cv2 gives None, Pillow's bomb rule refuses
    its 257 M pixels, so the reference's _decode_resize raises
    DecompressionBombError; the port's decode, load_batch and load_canvas
    raise, its cv2 probe gives (0, 0) without the raise mark."""
    p = tmp_path / "c" / "half.png"
    p.parent.mkdir()
    p.write_bytes(tiff(W, H, data=half(deflate(H, plain(W)))))
    assert H * W > 2 * Image.MAX_IMAGE_PIXELS
    assert cv2.imread(str(p)) is None
    with pytest.raises(Image.DecompressionBombError):
        jgtsrb._decode_resize(str(p), 32)
    dims, raised = native.probe([str(p)], reader="cv2", raises=True)
    assert dims.tolist() == [[0, 0]] and raised.tolist() == [False]
    with pytest.raises(RuntimeError, match="failed to decode"):
        native.decode(str(p))
    with pytest.raises(RuntimeError, match="failed to decode"):
        native.load_batch([str(p)], 32)
    with pytest.raises(RuntimeError, match="loaded 0/1 images"):
        native.load_canvas([str(p)], np.zeros((1, 32, 32, 3), np.uint8),
                           resize_to=32)


def test_decode_holds_no_rgba_buffer(tmp_path):
    """A child that only imports the native library and decodes the
    largest file here (20000 x 17100 RGB, 1.03 GB out) grows its peak RSS
    (VmHWM) by at most twice the output (decode copies the C image into
    its array) plus the file plus 64 MiB: no 4-byte-a-pixel buffer and no
    whole decompressed strip (the RGBA reader's would need about 11 bytes
    a pixel)."""
    p = tmp_path / "rgb.tif"
    p.write_bytes(tiff(20000, 17100, 3, photometric=2))
    proc = subprocess.run([sys.executable, "-c", chip_smoke.SCANLINE_RSS_CHILD,
                           str(p)], capture_output=True, text=True,
                          cwd=str(HERE.parent), timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rss = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rss["output_bytes"] == 17100 * 20000 * 3
    grown = rss["peak_rss"] - rss["rss_after_import"]
    assert grown <= 2 * rss["output_bytes"] + p.stat().st_size + 64 * 2**20


def test_generate_tree_writes_what_the_reference_writes(tmp_path):
    """generate_tree("noise") through both packages over a tree of a small
    gray TIFF and the half-deflate file (which the port once wrote): the
    same files, the half-deflate one skipped."""
    root = tmp_path / "src"
    (root / "c0").mkdir(parents=True)
    (root / "c0" / "small.png").write_bytes(tiff(24, 20))
    (root / "c0" / "half.png").write_bytes(
        tiff(W, H, data=half(deflate(H, plain(W)))))
    lines = []
    n = offline.generate_tree(str(root), str(tmp_path / "ours"), "noise",
                              log=lines.append, device="cpu")
    m = joffline.generate_tree(str(root), str(tmp_path / "ref"), "noise",
                               log=quiet)
    assert n == m == 1
    assert "Skipped 1 unreadable files" in lines
    ours = sorted(str(p.relative_to(tmp_path / "ours"))
                  for p in (tmp_path / "ours").glob("*/*"))
    ref = sorted(str(p.relative_to(tmp_path / "ref"))
                 for p in (tmp_path / "ref").glob("*/*"))
    assert ours == ref == ["c0/small.png"]
