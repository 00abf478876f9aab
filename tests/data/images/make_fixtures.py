"""Writes the PNG, PNM, PAM, BMP, GIF, Sun raster, PFM, Radiance HDR and TIFF
fixtures of ``tests/test_torch_port_image_formats.py`` and of
``chip_smoke.py``'s image formats phase into this directory, with cv2, PIL
and the byte writers below (neither library writes ASCII PNM, PAM, RLE or
bitfield BMP, GIF's every variant, any Sun raster but raw 24-bit, a
big-endian PFM, a PFM scale other than -1 or an HDR header other than
cv2's, as needed):

- ``<case>``: CASES, files cv2.imread reads: the PNM family outside P5/P6
  (ASCII P1-P3, bitmap P4, PAM P7 of every TUPLTYPE), the BMP variants
  (16-bit, BI_BITFIELDS, the OS/2 core header, RLE8, RLE4), PNGs that
  libpng reads with a warning (a bad ancillary CRC, a split zlib stream,
  bytes after IEND), GIFs (``gif_*.png``: interlaced, local and global
  colour tables, transparency, a frame inside a larger screen, two frames,
  LZW code sizes 2 and 8, clear codes mid-stream, a full code table, a gray
  palette, extensions), Sun rasters (``sun_*.ppm``: 1, 8, 24 and 32
  bits, colour maps, RT_OLD, an odd width), PFM (``pfm*``: cv2's writer,
  big endian, scales 0.5 and 3, samples past 255, negative, NaN and
  infinite, ties, odd header whitespace) and Radiance HDR (``hdr_*.png``:
  cv2's run-length and flat writers, the ``#?RGBE`` signature, EXPOSURE
  and other header lines, a width under 8, zero exponents, values past 1,
  runs and literals of every length, a scanline that falls back to flat)
  and TIFF (``tiff_*``: see ``tiff_cases``);
- ``skip/<case>``: SKIP_CASES, files cv2.imread gives None for (cut,
  corrupt, a refused variant), some of which PIL reads (a GIF without its
  trailer, a Sun raster of type RT_BYTE_ENCODED or RT_FORMAT_RGB, which
  OpenCV 5 refuses, a gray PFM, which cv2 refuses under IMREAD_COLOR, TIFFs
  of orientation 5 and 6); and FOREIGN, AVIF, JPEG 2000 and WebP data under
  .png and .jpg names and a 16-bit TIFF (what cv2 reads and the port does
  not decode);
- ``expected.npz``: ``decoded__<case>`` = what the reference's readers give
  for each CASES file as RGB (``cv2.imread``; the pixels cv2 leaves
  unwritten, see ``cv2_written``, set to 0), ``decoded_skip__<case>`` =
  PIL's ``convert("RGB")`` of each SKIP_CASES file PIL reads, and
  ``generate_tree_written`` = how many files of the CASES + SKIP_CASES
  tree the reference's ``generate_tree`` writes (those cv2 reads; FOREIGN
  files stay out of it, as the port does not decode them).

Run from the root of the checkout: ``python tests/data/images/make_fixtures.py``.
The tests check that the committed files still equal what cv2 and PIL give.
"""

import io
import re
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
SEED = 12
GIF_SEED = 14  # the GIF and Sun raster files draw from their own stream
PFM_HDR_SEED = 15  # and the PFM and Radiance HDR files from theirs
TIFF_SEED = 16  # and the TIFF files from theirs


def smooth(rng, h, w):
    """A smooth random RGB image (a coarse field upsampled, plus grain)."""
    coarse = rng.integers(0, 256, (h // 6 + 2, w // 6 + 2, 3))
    img = cv2.resize(coarse.astype(np.float32), (w, h),
                     interpolation=cv2.INTER_CUBIC)
    return np.clip(img + rng.normal(0, 10, img.shape), 0,
                   255).astype(np.uint8)


def gray(img):
    return img.mean(axis=2).astype(np.uint8)


# ------------------------------------------------------------- writers

def pnm_ascii(kind, samples, maxval=None, comment=b"", per_line=12,
              sep=b" ", tail=b"\n"):
    """P1/P2/P3 text: ``samples`` [h, w] or [h, w, 3] integers."""
    h, w = samples.shape[:2]
    head = b"P%d\n" % kind + comment + b"%d %d\n" % (w, h)
    if maxval is not None:
        head += b"%d\n" % maxval
    vals = [b"%d" % v for v in samples.reshape(-1).tolist()]
    lines = [sep.join(vals[i:i + per_line])
             for i in range(0, len(vals), per_line)]
    return head + b"\n".join(lines) + tail


def pam(samples, maxval, tupltype, comment=b""):
    """P7: ``samples`` [h, w, depth]."""
    h, w, depth = samples.shape
    head = (b"P7\n" + comment + b"WIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\n"
            % (w, h, depth, maxval))
    if tupltype is not None:
        head += b"TUPLTYPE " + tupltype + b"\n"
    dtype = ">u2" if maxval > 255 else np.uint8
    return head + b"ENDHDR\n" + samples.astype(dtype).tobytes()


def bmp(info, pixels, extra=b""):
    """A BMP of the info header ``info``, then ``extra`` (masks, palette),
    then ``pixels``; the data offset points past ``extra``."""
    off = 14 + len(info) + len(extra)
    return (b"BM" + struct.pack("<IHHI", off + len(pixels), 0, 0, off)
            + info + extra + pixels)


def info40(w, h, bpp, comp, nbytes, used=0, size=40, masks=()):
    """BITMAPINFOHEADER, or a V2-V5 header of ``size`` bytes with
    ``masks`` (R, G, B[, A]) in it."""
    head = struct.pack("<IiiHHIIiiII", size, w, h, 1, bpp, comp, nbytes,
                       2835, 2835, used, 0)
    if size > 40:
        head += struct.pack(f"<{len(masks)}I", *masks)
        if size >= 108:
            head += b"BGRs"
        head += bytes(size - len(head))
    return head


def rows_bgr(img, bpp):
    """Bottom-up rows of RGB ``img`` as 24/32-bit BGR, padded to 4."""
    h, w = img.shape[:2]
    px = img[::-1, :, ::-1]
    if bpp == 32:
        px = np.concatenate([px, np.full((h, w, 1), 255, np.uint8)], 2)
    stride = (w * bpp // 8 + 3) & ~3
    out = np.zeros((h, stride), np.uint8)
    out[:, :w * bpp // 8] = px.reshape(h, -1)
    return out.tobytes()


def rows16(img, layout):
    """Bottom-up 16-bit rows: 5-5-5 or 5-6-5 of RGB ``img``."""
    h, w = img.shape[:2]
    r, g, b = (img[::-1, :, c].astype(np.uint16) for c in range(3))
    if layout == 565:
        v = (r >> 3) << 11 | (g >> 2) << 5 | b >> 3
    else:
        v = (r >> 3) << 10 | (g >> 3) << 5 | b >> 3
    stride = (2 * w + 3) & ~3
    out = np.zeros((h, stride), np.uint8)
    out[:, :2 * w] = v.astype("<u2").view(np.uint8).reshape(h, -1)
    return out.tobytes()


def palette_of(img, colors):
    """(indices [h, w], palette [colors, 3] RGB): PIL's quantize."""
    q = Image.fromarray(img).quantize(colors=colors)
    pal = np.array(q.getpalette()[:3 * colors], np.uint8).reshape(-1, 3)
    return np.array(q), pal


def rle_row(row, rle4):
    """One row's RLE8/RLE4 codes: runs of 3 or more, absolute runs of 3 or
    more others, single pixels as runs of 1."""
    out, x, w = bytearray(), 0, len(row)
    while x < w:
        run = 1
        while x + run < w and run < 254 and row[x + run] == row[x]:
            run += 1
        if run >= 3 or w - x < 3:
            out += bytes([run, row[x] * 17 if rle4 else row[x]])
            x += run
            continue
        j = x
        while j < w and j - x < 254 and not (
                j + 2 < w and row[j] == row[j + 1] == row[j + 2]):
            j += 1
        if j - x < 3:
            out += bytes([1, row[x] * 17 if rle4 else row[x]])
            x += 1
            continue
        vals = row[x:j]
        if rle4:
            nib = list(vals) + [0] * (len(vals) % 2)
            data = bytes(nib[i] << 4 | nib[i + 1] for i in range(0, len(nib), 2))
        else:
            data = bytes(vals)
        out += bytes([0, j - x]) + data + b"\0" * (len(data) % 2)
        x = j
    return out


def rle(idx, rle4, delta=None, short_rows=()):
    """The RLE stream of bottom-up ``idx`` rows, each ending in EOL and the
    last in EOB. ``delta`` = (row, dy): in that stream row a delta of (3,
    dy) after 5 pixels, the stream resumed after the jump (cv2's RLE4 reads
    no dy); each row of ``short_rows`` ends 4 pixels early (its EOL fills
    with entry 0)."""
    rows = idx[::-1]
    out, y = bytearray(), 0
    while y < len(rows):
        row = rows[y]
        if delta is not None and y == delta[0]:
            dy = delta[1]
            out += rle_row(row[:5], rle4) + bytes([0, 2, 3, dy])
            out += rle_row(rows[y + dy][8:], rle4) + b"\0\0"
            y += 1 + dy
            continue
        out += rle_row(row[:-4] if y in short_rows else row, rle4) + b"\0\0"
        y += 1
    return bytes(out[:-2]) + b"\0\1"


def lzw_codes(idx, bits, clear_at=(), clear_when_full=True):
    """GIF's LZW codes [(code, width)] of the indices ``idx`` at minimum
    code size ``bits``: a clear code first, one before each position of
    ``clear_at``, and, where ``clear_when_full``, one when the 4096-entry
    table fills (else the table stays full), then the end code."""
    clear = 1 << bits
    size, nxt = bits + 1, clear + 2
    table = {(i,): i for i in range(clear)}
    codes, word = [(clear, size)], ()
    for pos, k in enumerate(int(v) for v in idx):
        if pos in clear_at and word:
            codes += [(table[word], size), (clear, size)]
            table = {(i,): i for i in range(clear)}
            size, nxt, word = bits + 1, clear + 2, ()
        if word + (k,) in table:
            word += (k,)
            continue
        codes.append((table[word], size))
        if nxt < 4096:
            table[word + (k,)] = nxt
            nxt += 1
            if nxt > 1 << size and size < 12:
                size += 1
        elif clear_when_full:
            codes.append((clear, size))
            table = {(i,): i for i in range(clear)}
            size, nxt = bits + 1, clear + 2
        word = (k,)
    return codes + [(table[word], size), (clear + 1, size)]


def pack_codes(codes):
    """LSB-first bit packing of [(code, width)]."""
    out, acc, nbits = bytearray(), 0, 0
    for code, width in codes:
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
    return bytes(out) + (bytes([acc]) if nbits else b"")


def sub_blocks(data, size=255):
    """``data`` in GIF sub-blocks, then the block terminator."""
    return b"".join(bytes([len(data[i:i + size])]) + data[i:i + size]
                    for i in range(0, len(data), size)) + b"\0"


def colour_table(pal, bits):
    """A GIF colour table of 2**bits entries from RGB rows ``pal``."""
    table = np.zeros((1 << bits, 3), np.uint8)
    table[:len(pal)] = pal[:1 << bits]
    return table.tobytes()


def gce(transparent=None, disposal=0):
    """A graphic control extension."""
    flags = disposal << 2 | (transparent is not None)
    return b"!\xf9\x04" + struct.pack("<BHB", flags, 0, transparent or 0) + b"\0"


def gif_frame(idx, x=0, y=0, lct=None, interlace=False, bits=None, pre=b"",
              **lzw):
    """An image descriptor (with ``pre``, its extensions, before it) and the
    LZW data of indices ``idx`` [h, w]."""
    h, w = idx.shape
    bits = bits or max(2, int(idx.max()).bit_length())
    rows = (list(range(0, h, 8)) + list(range(4, h, 8)) + list(range(2, h, 4))
            + list(range(1, h, 2))) if interlace else range(h)
    flags, table = 0x40 * interlace, b""
    if lct is not None:
        tbits = max(1, (len(lct) - 1).bit_length())
        flags |= 0x80 | (tbits - 1)
        table = colour_table(lct, tbits)
    data = pack_codes(lzw_codes(np.concatenate([idx[r] for r in rows]), bits,
                                **lzw))
    return (pre + b"," + struct.pack("<HHHHB", x, y, w, h, flags) + table
            + bytes([bits]) + sub_blocks(data))


def gif(w, h, frames, gct=None, bg=0, version=b"GIF89a", ext=b"",
        trailer=True):
    """A GIF of logical screen ``w`` x ``h``: the global colour table
    ``gct`` (RGB rows) and background index ``bg``, extensions ``ext``,
    then ``frames``."""
    flags, table = 0, b""
    if gct is not None:
        tbits = max(1, (len(gct) - 1).bit_length())
        flags = 0xF0 | (tbits - 1)
        table = colour_table(gct, tbits)
    return (version + struct.pack("<HHBBB", w, h, flags, bg, 0) + table + ext
            + b"".join(frames) + b";" * trailer)


def sun_rle(data):
    """RT_BYTE_ENCODED: runs of 3 or more (and any 0x80) as 0x80, count - 1,
    value; 0x80 alone as 0x80, 0."""
    out, i = bytearray(), 0
    while i < len(data):
        run = 1
        while i + run < len(data) and data[i + run] == data[i] and run < 256:
            run += 1
        if data[i] == 0x80 and run == 1:
            out += b"\x80\0"
        elif run >= 3 or data[i] == 0x80:
            out += bytes([0x80, run - 1, data[i]])
        else:
            out.append(data[i])
            run = 1
        i += run
    return bytes(out)


def sun(rows, w, depth, ras_type=1, cmap=None):
    """A Sun raster of ``rows`` (uint8 [h, row bytes]) at ``depth`` bits,
    type ``ras_type`` (0 RT_OLD, 1 RT_STANDARD, 2 RT_BYTE_ENCODED over the
    padded rows, 3 RT_FORMAT_RGB) and an RMT_EQUAL_RGB map ``cmap`` (RGB
    rows, stored as three planes)."""
    rows = np.asarray(rows, np.uint8)
    pitch = (w * depth + 15) // 16 * 2
    body = np.pad(rows, ((0, 0), (0, pitch - rows.shape[1]))).tobytes()
    if ras_type == 2:
        body = sun_rle(body)
    cm = b"" if cmap is None else np.asarray(cmap, np.uint8).T.tobytes()
    length = 0 if ras_type == 0 else len(body)
    return (struct.pack(">8I", 0x59A66A95, w, len(rows), depth, length,
                        ras_type, int(cmap is not None), len(cm)) + cm + body)


def pfm(samples, scale=b"-1.0", seps=(b"\n", b" ", b"\n", b"\n")):
    """A PFM of float ``samples`` ([h, w, 3]: "PF"; [h, w]: "Pf"): the
    magic, width, height and scale each followed by its byte of ``seps``,
    then the rows bottom to top, big endian unless ``scale`` is
    negative."""
    h, w = samples.shape[:2]
    big = not scale.startswith(b"-")
    body = np.ascontiguousarray(samples[::-1]).astype(">f4" if big else "<f4")
    return ((b"PF" if samples.ndim == 3 else b"Pf") + seps[0] + b"%d" % w
            + seps[1] + b"%d" % h + seps[2] + scale + seps[3]
            + body.tobytes())


def rgbe(img):
    """Radiance's float2rgbe of float RGB ``img`` [h, w, 3] -> uint8 [h, w,
    4]: the mantissas of the largest channel's exponent, and the exponent
    + 128 (0 for a pixel below 1e-32)."""
    v = img.max(axis=2)
    m, e = np.frexp(v)
    keep = v >= 1e-32
    out = np.zeros(img.shape[:2] + (4,), np.uint8)
    scale = np.where(keep, m * 256.0 / np.where(keep, v, 1), 0)
    out[..., :3] = (img * scale[..., None]).astype(np.uint8)
    out[..., 3] = np.where(keep, e + 128, 0)
    return out


def hdr_channel(vals):
    """One channel of a new-style RLE scanline: runs of 3 or more as 128 +
    count (at most 127) and the byte, the rest as literal pieces of at
    most 128 bytes."""
    out, i, n = bytearray(), 0, len(vals)
    while i < n:
        run = 1
        while i + run < n and vals[i + run] == vals[i] and run < 127:
            run += 1
        if run >= 3:
            out += bytes([128 + run, vals[i]])
            i += run
            continue
        j = i + 1
        while j < n and j - i < 128 and not (
                j + 2 < n and vals[j] == vals[j + 1] == vals[j + 2]):
            j += 1
        out += bytes([j - i]) + bytes(vals[i:j])
        i = j
    return bytes(out)


def hdr(px, head=b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n", res=None,
        rle_rows=None):
    """A Radiance HDR of RGBE pixels ``px`` (uint8 [h, w, 4]): ``head``,
    the resolution line ``res`` (default "-Y h +X w"), then the first
    ``rle_rows`` scanlines (default all) run-length encoded and the rest
    flat."""
    h, w = px.shape[:2]
    rle_rows = h if rle_rows is None else rle_rows
    body = b"".join(bytes([2, 2, w >> 8, w & 255]) + b"".join(
        hdr_channel(px[y, :, c].tobytes()) for c in range(4))
        for y in range(rle_rows))
    return (head + (res or b"-Y %d +X %d\n" % (h, w)) + body
            + px[rle_rows:].tobytes())


def bmp_palette(pal, size=4):
    """BGR(0) entries of an RGB palette."""
    ent = np.zeros((len(pal), size), np.uint8)
    ent[:, :3] = pal[:, ::-1]
    return ent.tobytes()


def chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def png_chunks(data):
    """[(tag, data)] of a PNG file."""
    out, pos = [], 8
    while pos + 12 <= len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        out.append((data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]))
        pos += 12 + n
    return out


def png_encode(img):
    ok, enc = cv2.imencode(".png", img[:, :, ::-1])
    assert ok
    return enc.tobytes()


def png_with(img, edit):
    """cv2's PNG of ``img`` with its chunks passed through ``edit``."""
    chunks = png_chunks(png_encode(img))
    return b"\x89PNG\r\n\x1a\n" + b"".join(edit(chunks))


def flip_crc(blob):
    return blob[:-1] + bytes([blob[-1] ^ 1])


def idat_stream(img):
    return zlib.decompress(b"".join(d for t, d in png_chunks(png_encode(img))
                                    if t == b"IDAT"))


# ---------------------------------------------------------------- cases

def cases(rng):
    """{name: bytes} of the files cv2.imread reads."""
    out = {}
    img = smooth(rng, 28, 20)
    out["p1_ascii.ppm"] = pnm_ascii(1, (gray(img) < 128).astype(int),
                                    comment=b"# a bitmap\n", per_line=35)
    img = smooth(rng, 24, 33)
    out["p1_packed.ppm"] = pnm_ascii(1, (gray(img) < 110).astype(int),
                                     per_line=70, sep=b"")
    img = smooth(rng, 30, 26)
    out["p2_max15.ppm"] = pnm_ascii(2, gray(img) >> 4, 15)
    img = smooth(rng, 22, 31)
    out["p2_comments.ppm"] = pnm_ascii(
        2, gray(img), 255, comment=b"# made by hand\n# two lines\n",
        per_line=9, sep=b" \t ")
    img = smooth(rng, 25, 28)
    out["p3_max1000.ppm"] = pnm_ascii(3, img.astype(int) * 1000 // 255, 1000)
    img = smooth(rng, 20, 29)
    out["p3_max255.ppm"] = pnm_ascii(3, img, 255, per_line=17)
    img = smooth(rng, 27, 37)
    bits = (gray(img) < 128).astype(np.uint8)
    out["p4_bitmap.ppm"] = (b"P4\n37 27\n"
                            + np.packbits(bits, axis=1).tobytes())
    img = smooth(rng, 21, 30)
    out["p5_max15.ppm"] = b"P5\n30 21\n15\n" + (gray(img) >> 4).tobytes()
    img = smooth(rng, 23, 24).astype(np.uint16) * 257
    out["p6_max65535.ppm"] = (b"P6\n24 23\n65535\n"
                              + img.astype(">u2").tobytes())

    img = smooth(rng, 26, 34)
    out["pam_rgb.ppm"] = pam(img, 255, b"RGB", comment=b"# netpbm\n")
    img = smooth(rng, 29, 23)
    out["pam_gray.ppm"] = pam(gray(img)[:, :, None], 255, b"GRAYSCALE")
    img = smooth(rng, 20, 40)
    out["pam_bw.ppm"] = pam((gray(img) < 128).astype(np.uint8)[:, :, None],
                            1, b"BLACKANDWHITE")
    img = smooth(rng, 24, 28)
    ga = np.concatenate([gray(img)[:, :, None],
                         np.full((24, 28, 1), 200, np.uint8)], 2)
    out["pam_gray_alpha.ppm"] = pam(ga, 255, b"GRAYSCALE_ALPHA")
    img = smooth(rng, 22, 36)
    rgba = np.concatenate([img, np.full((22, 36, 1), 255, np.uint8)], 2)
    out["pam_rgb_alpha.ppm"] = pam(rgba, 255, b"RGB_ALPHA")
    img = smooth(rng, 21, 27).astype(np.uint16) * 257 + 3
    out["pam_rgb16.ppm"] = pam(img, 65535, b"RGB")
    img = smooth(rng, 28, 25)
    out["pam_no_tupltype.ppm"] = pam(img, 255, None)

    img = smooth(rng, 24, 31)
    out["bmp16_555.bmp"] = bmp(info40(31, 24, 16, 0, 0), rows16(img, 555))
    img = smooth(rng, 27, 22)
    out["bmp16_565_bitfields.bmp"] = bmp(
        info40(22, 27, 16, 3, 0), rows16(img, 565),
        struct.pack("<III", 0xF800, 0x07E0, 0x001F))
    img = smooth(rng, 30, 33)
    out["bmp32_bitfields_v5.bmp"] = bmp(  # GIMP's RGBA layout
        info40(33, 30, 32, 3, 0, size=124,
               masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)), rows_bgr(img, 32))
    img = smooth(rng, 25, 26)
    idx, pal = palette_of(img, 200)
    px = np.zeros((25, 28), np.uint8)
    px[:, :26] = idx[::-1]
    out["bmp_core_8bit.bmp"] = bmp(struct.pack("<IHHHH", 12, 26, 25, 1, 8),
                                   px.tobytes(),
                                   bmp_palette(np.pad(pal, ((0, 56), (0, 0))),
                                               3))
    img = smooth(rng, 21, 23)
    out["bmp_core_24bit.bmp"] = bmp(struct.pack("<IHHHH", 12, 23, 21, 1, 24),
                                    rows_bgr(img, 24))
    img = smooth(rng, 32, 40)
    idx, pal = palette_of(img, 24)
    data = rle(idx, False, delta=(6, 1), short_rows=(3, 11))
    out["bmp_rle8.bmp"] = bmp(info40(40, 32, 8, 1, len(data), 24), data,
                              bmp_palette(pal))
    img = smooth(rng, 26, 38)
    idx, pal = palette_of(img, 16)
    data = rle(idx, True, delta=(9, 0), short_rows=(2,))
    out["bmp_rle4.bmp"] = bmp(info40(38, 26, 4, 2, len(data), 16), data,
                              bmp_palette(pal))
    img = smooth(rng, 24, 30)
    idx, pal = palette_of(img, 40)
    data = rle(idx[::-1], False)
    out["bmp_rle8_topdown.bmp"] = bmp(info40(30, -24, 8, 1, len(data), 40),
                                      data, bmp_palette(pal))

    img = smooth(rng, 28, 32)
    out["png_text_bad_crc.png"] = png_with(img, lambda c: [
        chunk(*c[0]), flip_crc(chunk(b"tEXt", b"Comment\0cv2 ignores me"))]
        + [chunk(*x) for x in c[1:]])
    img = smooth(rng, 34, 27)
    out["png_after_iend.png"] = png_encode(img) + b"trailing bytes"
    img = smooth(rng, 26, 30)
    comp = zlib.compress(idat_stream(img), 9)
    out["png_split_idat.png"] = png_with(img, lambda c: [chunk(*c[0])] + [
        chunk(b"IDAT", comp[:40]), chunk(b"IDAT", comp[40:-4]),
        chunk(b"IDAT", comp[-4:]), chunk(b"IEND", b"")])
    img = smooth(rng, 23, 29)
    comp = zlib.compress(idat_stream(img) + bytes(50))
    out["png_extra_zlib_data.png"] = png_with(img, lambda c: [
        chunk(*c[0]), chunk(b"IDAT", comp), flip_crc(chunk(b"IEND", b""))])
    return out


def skip_cases(rng):
    """{name: bytes} of files cv2.imread gives None for."""
    out = {}
    png = png_encode(smooth(rng, 30, 36))
    out["png_cut.png"] = png[:len(png) * 6 // 10]
    out["png_cut_in_iend.png"] = png[:-2]
    out["png_no_iend.png"] = png[:-12]
    img = smooth(rng, 27, 25)
    out["png_idat_crc.png"] = png_with(img, lambda c: [
        flip_crc(chunk(*x)) if x[0] == b"IDAT" else chunk(*x) for x in c])
    out["png_ihdr_crc.png"] = png_with(img, lambda c: [
        flip_crc(chunk(*x)) if x[0] == b"IHDR" else chunk(*x) for x in c])
    raw = bytearray(idat_stream(img))
    raw[(25 * 3 + 1) * 7] = 5
    out["png_bad_filter.png"] = png_with(img, lambda c: [
        chunk(b"IDAT", zlib.compress(bytes(raw))) if x[0] == b"IDAT"
        else chunk(*x) for x in c])
    comp = bytearray(zlib.compress(idat_stream(img)))
    comp[-1] ^= 1
    out["png_bad_adler.png"] = png_with(img, lambda c: [
        chunk(b"IDAT", bytes(comp)) if x[0] == b"IDAT" else chunk(*x)
        for x in c])
    out["png_unknown_critical.png"] = png_with(img, lambda c: [
        chunk(*c[0]), chunk(b"ABCD", b"not a chunk libpng knows")]
        + [chunk(*x) for x in c[1:]])

    img = smooth(rng, 24, 28)
    p6 = b"P6\n28 24\n255\n" + img.tobytes()
    out["p6_cut.ppm"] = p6[:len(p6) // 2]
    p2 = pnm_ascii(2, gray(img), 255)
    out["p2_cut.ppm"] = p2[:len(p2) * 6 // 10]
    out["p2_no_final_newline.ppm"] = p2[:-1]
    out["p2_glued_comment.ppm"] = p2.replace(b"\n", b"# note\n", 3).replace(
        b"P2# note", b"P2", 1)
    out["pam_cut.ppm"] = pam(img, 255, b"RGB")[:300]
    out["pam_unknown_tupltype.ppm"] = pam(img, 255, b"RGB_PLUS")
    out["p1_bad_digit.ppm"] = pnm_ascii(1, (gray(img) < 128).astype(int)
                                        ).replace(b"0 ", b"x ", 1)

    img = smooth(rng, 26, 30)
    b24 = bmp(info40(30, 26, 24, 0, 0), rows_bgr(img, 24))
    out["bmp_cut.bmp"] = b24[:len(b24) * 9 // 10]
    idx, pal = palette_of(img, 24)
    data = rle(idx, False)
    out["bmp_rle8_cut.bmp"] = bmp(info40(30, 26, 8, 1, len(data), 24),
                                  data[:len(data) // 2], bmp_palette(pal))
    out["bmp16_565_v5.bmp"] = bmp(
        info40(30, 26, 16, 3, 0, size=124,
               masks=(0xF800, 0x07E0, 0x001F, 0)), rows16(img, 565))
    idx, pal = palette_of(img, 16)
    data = rle(idx, True)[:-2]  # no end code: RLE4 needs one after a row
    out["bmp_rle4_no_end.bmp"] = bmp(info40(30, 26, 4, 2, len(data), 16),
                                     bytes(data), bmp_palette(pal))
    return out


def gif_sun_cases(rng):
    """{name: bytes} of the GIF and Sun raster files cv2.imread reads."""
    out = {}
    img, pal = palette_of(smooth(rng, 24, 30), 64)
    buf = io.BytesIO()
    Image.fromarray(smooth(rng, 24, 30)).save(buf, "GIF")  # PIL's writer
    out["gif_pil.png"] = buf.getvalue()
    out["gif_interlaced.png"] = gif(30, 24, [gif_frame(img, interlace=True)],
                                    pal)
    idx, lpal = palette_of(smooth(rng, 22, 27), 32)
    out["gif_local_table.png"] = gif(27, 22, [gif_frame(idx, lct=lpal)],
                                     pal[:8], version=b"GIF87a")
    idx, tpal = palette_of(smooth(rng, 20, 26), 16)
    idx[3:9, 4:12] = 5
    out["gif_transparent.png"] = gif(26, 20, [gif_frame(idx, pre=gce(5))],
                                     tpal, bg=9)
    idx, opal = palette_of(smooth(rng, 14, 17), 16)
    out["gif_frame_offset.png"] = gif(  # cv2 paints the rest background
        31, 25, [gif_frame(idx, x=9, y=6, pre=gce(2, disposal=1))], opal,
        bg=11)
    idx2, _ = palette_of(smooth(rng, 10, 12), 16)
    out["gif_two_frames.png"] = gif(24, 21, [
        gif_frame(palette_of(smooth(rng, 21, 24), 16)[0], pre=gce()),
        gif_frame(idx2, x=5, y=4, pre=gce(3, disposal=2))], opal)
    idx, cpal = palette_of(smooth(rng, 23, 29), 4)
    out["gif_code2.png"] = gif(29, 23, [gif_frame(idx, bits=2)], cpal)
    noise = rng.integers(0, 256, (48, 64))
    out["gif_code8.png"] = gif(64, 48, [gif_frame(noise)],
                               rng.integers(0, 256, (256, 3)))
    noise = rng.integers(0, 256, (45, 80))
    out["gif_full_table.png"] = gif(  # the table stays full (no clear)
        80, 45, [gif_frame(noise, clear_when_full=False)],
        rng.integers(0, 256, (256, 3)))
    idx, mpal = palette_of(smooth(rng, 26, 33), 32)
    out["gif_mid_clear.png"] = gif(33, 26, [gif_frame(
        idx, clear_at=(100, 101, 500))], mpal)
    ramp = np.repeat(np.arange(0, 256, 4, dtype=np.uint8)[:, None], 3, 1)
    out["gif_gray.png"] = gif(28, 21, [gif_frame(
        gray(smooth(rng, 21, 28)) >> 2, interlace=True)], ramp)
    idx, epal = palette_of(smooth(rng, 19, 25), 16)
    out["gif_extensions.png"] = gif(25, 19, [gif_frame(
        idx, pre=b"!\xfe\x0ea comment here\0" + gce(7))], epal, ext=(
        b"!\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\0"
        b"!\x01\x0c" + bytes(12) + b"\x04text\0"))

    img = smooth(rng, 22, 29)
    bits = np.packbits(gray(img) < 128, axis=1)
    out["sun_1bit.ppm"] = sun(bits, 29, 1)
    out["sun_1bit_map.ppm"] = sun(bits, 29, 1,
                                  cmap=[[20, 40, 200], [250, 230, 10]])
    img = smooth(rng, 21, 27)
    out["sun_8bit_gray.ppm"] = sun(gray(img), 27, 8)
    idx, spal = palette_of(smooth(rng, 24, 31), 200)
    out["sun_8bit_map.ppm"] = sun(idx, 31, 8,
                                  cmap=spal)
    img = smooth(rng, 23, 25)  # an odd width: rows padded to 16 bits
    out["sun_24bit.ppm"] = sun(img[:, :, ::-1].reshape(23, -1), 25, 24)
    img = smooth(rng, 20, 26)
    out["sun_24bit_old.ppm"] = sun(img[:, :, ::-1].reshape(20, -1), 26, 24,
                                   ras_type=0)
    xbgr = np.concatenate([np.full((22, 21, 1), 255, np.uint8),
                           smooth(rng, 22, 21)[:, :, ::-1]], 2)
    out["sun_32bit.ppm"] = sun(xbgr.reshape(22, -1), 21, 32)
    return out


def gif_sun_skip_cases(rng):
    """{name: bytes} of GIF and Sun raster files cv2.imread gives None
    for."""
    out = {}
    idx, pal = palette_of(smooth(rng, 22, 28), 32)
    whole = gif(28, 22, [gif_frame(idx)], pal)
    out["gif_cut.png"] = whole[:len(whole) * 6 // 10]
    out["gif_no_trailer.png"] = whole[:-1]  # PIL reads it
    codes = lzw_codes(idx.reshape(-1), 5)
    head = b"," + struct.pack("<HHHHB", 0, 0, 28, 22, 0) + b"\x05"
    out["gif_bad_lzw.png"] = gif(28, 22, [head + sub_blocks(pack_codes(
        codes[:10] + [(63, codes[10][1])] + codes[10:]))], pal)  # past the table
    half = len(codes) // 2
    out["gif_early_end.png"] = gif(28, 22, [head + sub_blocks(pack_codes(
        codes[:half] + [(33, codes[half][1])]))], pal)
    out["gif_frame_outside.png"] = gif(20, 16, [gif_frame(idx)], pal)
    out["gif_disposal7.png"] = gif(28, 22, [gif_frame(idx, pre=gce(
        disposal=7))], pal)

    img = smooth(rng, 20, 23)
    raw = sun(img[:, :, ::-1].reshape(20, -1), 23, 24)
    out["sun_cut.ppm"] = raw[:len(raw) // 2]
    runs = np.repeat(gray(smooth(rng, 21, 8)), 4, axis=1)
    rle = sun(runs, 32, 8, ras_type=2)
    out["sun_rle8.ppm"] = rle  # RT_BYTE_ENCODED: PIL reads it
    out["sun_rle_cut.ppm"] = rle[:len(rle) * 7 // 10]
    out["sun_rle8_map.ppm"] = sun(runs, 32, 8, ras_type=2,
                                  cmap=palette_of(smooth(rng, 8, 8), 100)[1])
    img = smooth(rng, 19, 24)
    out["sun_rgb24.ppm"] = sun(img.reshape(19, -1), 24, 24, ras_type=3)
    return out


def pfm_hdr_cases(rng):
    """{name: bytes} of the PFM and Radiance HDR files cv2.imread reads."""
    out = {}
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    ok, enc = cv2.imencode(".pfm", f32(smooth(rng, 24, 30))[:, :, ::-1])
    assert ok
    out["pfm.png"] = enc.tobytes()  # cv2's writer: little endian, -1
    out["pfm_big_endian.ppm"] = pfm(f32(smooth(rng, 16, 21)), b"1.0")
    out["pfm_scale_half.png"] = pfm(f32(smooth(rng, 15, 19)) / 2, b"-0.5")
    out["pfm_scale_3.ppm"] = pfm(f32(smooth(rng, 17, 18)) * 3, b"3")
    img = f32(smooth(rng, 12, 14))
    img[::2] = img[::2] * 40 + 256  # past 255, up to past 2^31
    img[1, :4, 1] = [2.1e9, 2.2e9, 3e9, 1e30]
    out["pfm_above_255.png"] = pfm(img)
    img = f32(smooth(rng, 12, 13)) - 128
    img[0, :4, 0] = [-0.5, -1e-30, -3e9, -0.0]
    out["pfm_negative.png"] = pfm(img)
    img = f32(smooth(rng, 11, 13))
    img[::3, ::2] = np.nan
    img[1::3, ::2] = np.inf
    img[2::3, ::2] = -np.inf
    out["pfm_nan_inf.png"] = pfm(img, b"1")
    img = np.floor(f32(smooth(rng, 10, 16))) + 0.5  # ties: half to even
    out["pfm_ties.png"] = pfm(img)
    out["pfm_odd_header.png"] = pfm(  # any whitespace ends a field
        f32(smooth(rng, 13, 15)), b"-1e0", (b"\n", b"\t", b"\r", b"\x0b"))

    x = f32(smooth(rng, 24, 32)) / 255 * 1.5
    ok, enc = cv2.imencode(".hdr", x[:, :, ::-1])  # run-length encoded
    assert ok
    out["hdr_rle.png"] = enc.tobytes()
    x = f32(smooth(rng, 20, 26)) / 255
    ok, enc = cv2.imencode(".hdr", x[:, :, ::-1], [
        cv2.IMWRITE_HDR_COMPRESSION, cv2.IMWRITE_HDR_COMPRESSION_NONE])
    assert ok
    out["hdr_flat.png"] = enc.tobytes()
    out["hdr_rgbe_signature.png"] = hdr(
        rgbe(smooth(rng, 18, 24) / 255), b"#?RGBE\nFORMAT=32-bit_rle_rgbe\n\n")
    out["hdr_exposure.png"] = hdr(rgbe(smooth(rng, 16, 20) / 255), (
        b"#?RADIANCE\n# made by hand\nGAMMA=2.2\nFORMAT=32-bit_rle_rgbe\n"
        b"EXPOSURE=2.0\nPRIMARIES=0.64 0.33 0.3 0.6 0.15 0.06 0.3 0.33\n\n"))
    out["hdr_narrow.png"] = hdr(rgbe(smooth(rng, 21, 6) / 255))  # flat
    px = rgbe(smooth(rng, 14, 18) / 255)
    px[3:9, 2:12, 3] = 0  # a zero exponent reads black whatever R, G, B
    out["hdr_zero_exponent.png"] = hdr(px)
    px = rgbe(smooth(rng, 14, 16) / 255 * 4)  # past 1: 255
    px[::3, :, 3] = 152  # R, G or B past 128: past 2^31 after x 255, so 0
    px[1::3, :8, 3] = 143
    out["hdr_above_1.png"] = hdr(px)
    px = rgbe(smooth(rng, 12, 20) / 255)
    out["hdr_flat_fallback.png"] = hdr(px, rle_rows=5)
    px = np.repeat(rgbe(smooth(rng, 4, 400) / 255)[:, ::3], 3, axis=1)[:, :400]
    px[:, 60:200] = rgbe(smooth(rng, 4, 140) / 255)  # a 128-byte literal
    px[:, 200:] = px[:, 200:201]  # a run of 127
    out["hdr_runs.png"] = hdr(px)
    return out


def pfm_hdr_skip_cases(rng):
    """{name: bytes} of PFM and Radiance HDR files cv2.imread gives None
    for."""
    out = {}
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    img = f32(smooth(rng, 18, 22))
    out["pfm_gray.png"] = pfm(gray(img).astype(np.float32)
                              + 0.7)  # PIL reads it: truncated
    g = f32(smooth(rng, 17, 15))[:, :, 0] * 1.2 - 20  # < 0 and > 255
    g[2, :5] = [np.nan, np.inf, -np.inf, 254.99, 0.5]
    out["pfm_gray_big_endian.ppm"] = pfm(g, b"2")
    whole = pfm(f32(smooth(rng, 16, 20))[:, :, 0])
    out["pfm_gray_cut.png"] = whole[:len(whole) * 2 // 3]
    whole = pfm(f32(smooth(rng, 15, 18)))
    out["pfm_cut.png"] = whole[:len(whole) * 2 // 3]
    out["pfm_scale_zero.png"] = pfm(f32(smooth(rng, 14, 16)), b"0")
    out["pfm_no_line_feed.png"] = pfm(f32(smooth(rng, 12, 14)), b"-1",
                                      (b" ", b" ", b"\n", b"\n"))

    px = rgbe(smooth(rng, 16, 22) / 255)
    whole = hdr(px)
    out["hdr_cut.png"] = whole[:len(whole) * 2 // 3]
    out["hdr_plus_y.png"] = hdr(px, res=b"+Y 16 +X 22\n")
    out["hdr_x_first.png"] = hdr(px, res=b"+X 22 -Y 16\n")
    out["hdr_xyze.png"] = hdr(px, b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n")
    line = bytearray(hdr(px[:1], head=b"", res=b"\n")[1:])
    line[4:6] = bytes([128 + 30, line[5]])  # a run past the channel's end
    out["hdr_overrun.png"] = (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
                              b"-Y 16 +X 22\n" + bytes(line)
                              + hdr(px[1:], head=b"", res=b"\n")[1:])
    out["hdr_wrong_width.png"] = hdr(px, res=b"-Y 16 +X 21\n")
    return out


# ----------------------------------------------------------------- TIFF

def packbits(row):
    """PackBits of one row's bytes: runs of 2-128 equal bytes, literals of
    1-128 others."""
    out, i, n = bytearray(), 0, len(row)
    while i < n:
        j = i
        while j + 1 < n and row[j + 1] == row[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), row[i]])
            i = j + 1
            continue
        j = i
        while (j + 1 < n and j - i < 127
               and (j + 2 >= n or row[j + 1] != row[j + 2])):
            j += 1
        out += bytes([j - i]) + bytes(row[i:j + 1])
        i = j + 1
    return bytes(out)


def lzw(data, old=False):
    """TIFF LZW of ``data``: MSB-first codes that widen one code early (as
    libtiff writes them), or, with ``old``, the old-style LSB-first codes
    that widen on time."""
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
        elif nxt >= (1 << width) + (1 if old else 0):
            width += 1
        w = bytes([c])
    if w:
        codes.append((table[w], width))
    codes.append((257, width))
    out, acc, bits = bytearray(), 0, 0
    for code, width in codes:
        if old:
            acc |= code << bits
            bits += width
            while bits >= 8:
                out.append(acc & 255)
                acc >>= 8
                bits -= 8
        else:
            acc = (acc << width) | code
            bits += width
            while bits >= 8:
                out.append((acc >> (bits - 8)) & 255)
                bits -= 8
    if bits:
        out.append(acc & 255 if old else (acc << (8 - bits)) & 255)
    return bytes(out)


def tiff_file(img, photometric=None, compression=1, rps=None, predictor=1,
              cmap=None, orientation=None, big=False, ifd_first=True,
              tags=None, drop=(), strips=None):
    """A classic TIFF of uint8 ``img`` ([h, w] gray or palette indices, or
    [h, w, 3] RGB): one IFD of SHORT and LONG tags in ascending order, its
    values after it, the strips of ``rps`` rows compressed with
    ``compression`` (1, 5 LZW, 8 or 32946 deflate, 32773 PackBits) after
    the header and IFD (``ifd_first``) or before them; ``tags`` {tag:
    (type, values)} added or replaced, ``drop`` tags left out,
    ``strips`` the strips' bytes in place of the encoded ones."""
    e = ">" if big else "<"
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    spp = 1 if img.ndim == 2 else img.shape[2]
    rps = h if rps is None else rps
    rows = img.reshape(h, w * spp)
    if strips is None:
        strips = []
        for y in range(0, h, rps):
            s = rows[y:y + rps]
            if predictor == 2:
                s = s.reshape(len(s), w, spp).astype(np.int16)
                s[:, 1:] -= s[:, :-1].copy()
                s = (s & 255).astype(np.uint8).reshape(len(s), -1)
            raw = s.tobytes()
            strips.append(
                raw if compression == 1 else
                b"".join(packbits(r.tobytes()) for r in s)
                if compression == 32773 else
                lzw(raw) if compression == 5 else zlib.compress(raw))
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * spp),
               259: (3, [compression]),
               262: (3, [(1 if spp == 1 else 2) if photometric is None
                         else photometric]),
               273: (4, [0] * len(strips)), 277: (3, [spp]), 278: (4, [rps]),
               279: (4, [len(s) for s in strips])}
    if predictor != 1:
        entries[317] = (3, [predictor])
    if cmap is not None:
        entries[320] = (3, list(cmap))
    if orientation is not None:
        entries[274] = (3, [orientation])
    entries.update(tags or {})
    for t in drop:
        entries.pop(t, None)

    def ifd(at, strip_at):
        ents = sorted(entries.items())
        values_at = at + 2 + 12 * len(ents) + 4
        body, values = bytearray(struct.pack(e + "H", len(ents))), bytearray()
        offsets = list(np.cumsum([strip_at] + [len(s) for s in strips]))
        for tag, (typ, v) in ents:
            if tag == 273:
                v = [int(o) for o in offsets[:len(v)]]
            raw = struct.pack(e + ("H" if typ == 3 else "I") * len(v), *v)
            if len(raw) <= 4:
                body += struct.pack(e + "HHI", tag, typ, len(v)) + raw.ljust(4, b"\0")
            else:
                body += struct.pack(e + "HHII", tag, typ, len(v),
                                    values_at + len(values))
                values += raw + b"\0" * (len(raw) % 2)
        return bytes(body + struct.pack(e + "I", 0) + values)

    head = b"MM\0*" if big else b"II*\0"
    data = b"".join(strips)
    if ifd_first:
        size = len(ifd(8, 0))
        return head + struct.pack(e + "I", 8) + ifd(8, 8 + size) + data
    at = 8 + len(data) + len(data) % 2
    return (head + struct.pack(e + "I", at) + data + b"\0" * (len(data) % 2)
            + ifd(at, 8))


def pil_tiff(img, mode, **kw):
    """Pillow's TIFF of RGB ``img`` converted to ``mode``."""
    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, "TIFF", **kw)
    return buf.getvalue()


def tiff_cases(rng):
    """{name: bytes} of TIFF files cv2.imread reads: Pillow's writer (no
    compression, PackBits, LZW, deflate both ways; RGB, L, P; one strip or
    many), cv2's (LZW with predictor 2), and files built here where
    neither writer gives one (big endian, the IFD first, an 8-bit
    ColorMap, old-style LZW codes, orientation 3, no StripByteCounts, an
    LZW strip that breaks off, a wide strip image in a bucket of its
    own)."""
    out = {}
    for comp, mode, ss in (("raw", "RGB", 200), ("packbits", "L", None),
                           ("tiff_lzw", "P", None),
                           ("tiff_adobe_deflate", "RGB", None),
                           ("tiff_deflate", "L", 100), ("raw", "P", None),
                           ("packbits", "RGB", 150), ("tiff_lzw", "RGB", 64)):
        kw = {"compression": comp}
        if ss:
            kw["strip_size"] = ss
        name = f"tiff_pil_{comp.replace('tiff_', '')}_{mode.lower()}"
        out[name + ("_strips" if ss else "") + ".png"] = pil_tiff(
            smooth(rng, 14 + len(out) % 4, 18), mode, **kw)
    ok, enc = cv2.imencode(".tif", smooth(rng, 15, 19)[:, :, ::-1])
    assert ok and enc[:4].tobytes() == b"II*\0"
    out["tiff_cv2_lzw_predictor.ppm"] = enc.tobytes()
    ok, enc = cv2.imencode(".tif", gray(smooth(rng, 13, 17)))
    out["tiff_cv2_gray.ppm"] = enc.tobytes()
    cmap = rng.integers(0, 65536, 768)
    out["tiff_be_raw_rgb.bmp"] = tiff_file(smooth(rng, 14, 17), rps=4,
                                           big=True)
    out["tiff_be_lzw_gray_predictor.bmp"] = tiff_file(
        gray(smooth(rng, 13, 16)), compression=5, predictor=2, rps=5,
        big=True)
    out["tiff_be_deflate_palette.bmp"] = tiff_file(
        gray(smooth(rng, 12, 18)), photometric=3, cmap=cmap, compression=8,
        rps=7, big=True, ifd_first=False)
    out["tiff_ifd_first_packbits_rgb.png"] = tiff_file(
        smooth(rng, 13, 19), compression=32773, rps=3)
    out["tiff_ifd_first_deflate_predictor_rgb.png"] = tiff_file(
        smooth(rng, 12, 15), compression=32946, predictor=2, rps=5)
    out["tiff_colormap_8bit.png"] = tiff_file(  # no entry past 255
        gray(smooth(rng, 14, 15)), photometric=3,
        cmap=rng.integers(0, 256, 768), rps=6)
    img = smooth(rng, 13, 17)
    out["tiff_old_style_lzw.png"] = tiff_file(
        img, compression=5, strips=[lzw(img.tobytes(), old=True)])
    out["tiff_orientation_3.png"] = tiff_file(smooth(rng, 12, 16),
                                              orientation=3, rps=5)
    out["tiff_no_byte_counts.png"] = tiff_file(smooth(rng, 11, 14),
                                               drop=(279,))
    out["tiff_wide_lzw_gray_predictor.ppm"] = tiff_file(  # its own bucket
        gray(smooth(rng, 22, 150)), compression=5, predictor=2, rps=8)
    img = gray(smooth(rng, 14, 16))
    broken = bytearray(lzw(img.tobytes()))
    broken[len(broken) // 2:] = bytes(len(broken) - len(broken) // 2)
    out["tiff_lzw_broken_strip.png"] = tiff_file(  # cv2 keeps what decoded
        img, compression=5, strips=[bytes(broken)])
    return out


def tiff_skip_cases(rng):
    """{name: bytes} of TIFF files cv2.imread gives None for: orientation
    6 and 5 (PIL reads them rotated; a gray image of one uncompressed strip
    PIL maps at the rotated size first), a strip byte count of 0 (PIL
    reads the strips whole whatever their counts), a file cut in its
    strips, predictor 3 on 8-bit samples."""
    out = {}
    out["tiff_orientation_6.png"] = tiff_file(smooth(rng, 12, 17),
                                              orientation=6, rps=4)
    out["tiff_orientation_5_gray.png"] = tiff_file(gray(smooth(rng, 11, 14)),
                                                   orientation=5)
    img = smooth(rng, 13, 15)
    out["tiff_byte_count_0.png"] = tiff_file(img, rps=5,
                                             tags={279: (4, [225, 0, 135])})
    whole = tiff_file(smooth(rng, 14, 16), compression=32773, rps=4)
    out["tiff_cut.png"] = whole[:len(whole) * 2 // 3]
    out["tiff_predictor_3.png"] = tiff_file(smooth(rng, 12, 13),
                                            compression=5, predictor=3)
    return out


def foreign(rng):
    """AVIF, JPEG 2000 and WebP data under .png and .jpg names, and a
    16-bit gray TIFF (a TIFF layout the port does not decode)."""
    out = {}
    img = np.asarray(Image.fromarray(smooth(np.random.default_rng(
        TIFF_SEED + 1), 18, 21)).convert("L"), np.uint16) * 257
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "TIFF")  # mode I;16
    out["tiff16_gray.png"] = buf.getvalue()
    for name, fmt, h, w in (("avif.png", "AVIF", 24, 30),
                            ("jp2.jpg", "JPEG2000", 28, 22),
                            ("webp.png", "WEBP", 26, 32)):
        img = smooth(rng, h, w)
        if fmt == "AVIF":  # cv2's writer
            ok, enc = cv2.imencode(".avif", img[:, :, ::-1])
            assert ok
            out[name] = enc.tobytes()
            continue
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, fmt)
        out[name] = buf.getvalue()
    return out


def cv2_written(data, shape):
    """[h, w] bool: the pixels cv2.imread writes when it reads ``data``.
    OpenCV's PAM decoder converts a row of 2 or 4 samples a pixel
    (GRAYSCALE_ALPHA, RGB_ALPHA) pixel by pixel over the row's first
    ``width`` samples only, and leaves the rest of its image
    uninitialised; every other file is written whole."""
    h, w = shape
    mask = np.ones((h, w), bool)
    if data.startswith(b"P7"):
        head = data[:data.find(b"ENDHDR")].decode("latin-1")
        depth = re.search(r"DEPTH[ \t\v\f]+(\d+)", head)
        if depth and int(depth[1]) in (2, 4):
            mask[:] = np.arange(w) * int(depth[1]) < w
    return mask


def reference_read(path):
    """What the reference's readers give for ``path`` as RGB:
    ``cv2.imread``, else PIL's ``convert("RGB")``; None where both
    refuse."""
    img = cv2.imread(str(path))
    if img is not None:
        return img[:, :, ::-1].copy()
    try:
        return np.asarray(Image.open(path).convert("RGB"))
    except Exception:
        return None


def make(out: Path = HERE) -> dict:
    """Writes the fixtures into ``out``; returns the npz's arrays."""
    rng = np.random.default_rng(SEED)
    arrays = {}
    (out / "skip").mkdir(parents=True, exist_ok=True)
    written = 0
    gif_rng = np.random.default_rng(GIF_SEED)
    pfm_rng = np.random.default_rng(PFM_HDR_SEED)
    tiff_rng = np.random.default_rng(TIFF_SEED)
    for name, data in {**cases(rng), **gif_sun_cases(gif_rng),
                       **pfm_hdr_cases(pfm_rng),
                       **tiff_cases(tiff_rng)}.items():
        p = out / name
        p.write_bytes(data)
        img = cv2.imread(str(p))
        assert img is not None, name
        img = img[:, :, ::-1].copy()
        img[~cv2_written(data, img.shape[:2])] = 0
        arrays[f"decoded__{name}"] = img
        written += 1
    for name, data in {**skip_cases(rng), **foreign(rng),
                       **gif_sun_skip_cases(gif_rng),
                       **pfm_hdr_skip_cases(pfm_rng),
                       **tiff_skip_cases(tiff_rng)}.items():
        p = out / "skip" / name
        p.write_bytes(data)
        assert cv2.imread(str(p)) is None or name in FOREIGN, name
        img = None if name in FOREIGN else reference_read(p)
        if img is not None:
            arrays[f"decoded_skip__{name}"] = img
    arrays["generate_tree_written"] = np.array(written)
    np.savez_compressed(out / "expected.npz", **arrays)
    return arrays


def _names():
    rng = np.random.default_rng(SEED)
    gif_rng = np.random.default_rng(GIF_SEED)
    pfm_rng = np.random.default_rng(PFM_HDR_SEED)
    tiff_rng = np.random.default_rng(TIFF_SEED)
    found = (tuple(cases(rng)) + tuple(gif_sun_cases(gif_rng))
             + tuple(pfm_hdr_cases(pfm_rng)) + tuple(tiff_cases(tiff_rng)))
    return found, (tuple(skip_cases(rng)) + tuple(gif_sun_skip_cases(gif_rng))
                   + tuple(pfm_hdr_skip_cases(pfm_rng))
                   + tuple(tiff_skip_cases(tiff_rng)))


CASES, SKIP_CASES = _names()
FOREIGN = ("avif.png", "jp2.jpg", "tiff16_gray.png", "webp.png")

if __name__ == "__main__":
    make()
