"""Byte writers for the image fixtures (``images/make_fixtures.py``) and
the tests that build files of their own: PNM, PAM, BMP, GIF, Sun raster,
PFM, Radiance HDR, PNG chunks and TIFF (classic and BigTIFF, strips or
tiles, 1 to 16 bits a sample, either planar configuration, every
compression the port decodes), where neither cv2 nor PIL writes the file
needed; a smooth random image to fill them."""

import io
import struct
import zlib
from fractions import Fraction

import cv2
import numpy as np
from PIL import Image

__all__ = ['smooth', 'gray', 'pnm_ascii', 'pam', 'bmp', 'info40', 'rows_bgr', 'rows16', 'palette_of', 'rle_row', 'rle', 'lzw_codes', 'pack_codes', 'sub_blocks', 'colour_table', 'gce', 'gif_frame', 'gif', 'sun_rle', 'sun', 'pfm', 'rgbe', 'hdr_channel', 'hdr', 'bmp_palette', 'chunk', 'png_chunks', 'png_encode', 'png_with', 'flip_crc', 'idat_stream', 'packbits', 'lzw', 'pack_rows', 'reverse_bits', 'ycc_blocks', 'jpeg_stream', 'tiff_file', 'pil_tiff']


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


def pack_rows(rows, bits, e="<"):
    """The bytes of sample rows ``rows`` ([n, m] integers) at ``bits`` a
    sample: 1, 2 or 4 packed from the high bit down, each row padded to a
    byte; 8 as bytes; 16 as words in the byte order ``e``."""
    rows = np.asarray(rows)
    if bits == 8:
        return [r.astype(np.uint8).tobytes() for r in rows]
    if bits == 16:
        return [r.astype(e + "u2").tobytes() for r in rows]
    per = 8 // bits
    out = []
    for r in rows:
        v = np.concatenate([r, np.zeros(-len(r) % per, r.dtype)])
        v = v.reshape(-1, per).astype(np.int64)
        out.append(sum(v[:, k] << (8 - bits * (k + 1))
                       for k in range(per)).astype(np.uint8).tobytes())
    return out


def reverse_bits(data):
    """Each byte of ``data`` with its bits in the other order (FillOrder
    2)."""
    table = bytes(int(f"{b:08b}"[::-1], 2) for b in range(256))
    return bytes(data).translate(table)


def ycc_blocks(block, hs, vs):
    """libtiff's packed YCbCr of ``block`` ([n, cols, 3] Y, Cb, Cr): for
    each hs x vs block, left to right then down, its Y samples row by row,
    then the Cb and Cr of its top-left sample; rows and columns past the
    block's repeat its last ones."""
    n, cols = block.shape[:2]
    rows = -(-n // vs) * vs
    width = -(-cols // hs) * hs
    idx_r = np.minimum(np.arange(rows), n - 1)
    idx_c = np.minimum(np.arange(width), cols - 1)
    b = block[idx_r][:, idx_c].astype(np.uint8)
    y = b[:, :, 0].reshape(rows // vs, vs, width // hs, hs).transpose(0, 2, 1, 3)
    y = y.reshape(rows // vs, width // hs, vs * hs)
    c = b[::vs, ::hs, 1:]
    return np.concatenate([y, c], axis=2).tobytes()


def jpeg_stream(block, sampling=(2, 2), quality=95):
    """cv2's JPEG of ``block`` ([n, cols, 3] RGB, or [n, cols] gray) with the
    given luma sampling (cv2's IMWRITE_JPEG_SAMPLING_FACTOR); of [n, cols,
    4] CMYK, Pillow's; whole from SOI to EOI."""
    if block.ndim == 3 and block.shape[2] == 4:  # Pillow's CMYK, as stored
        buf = io.BytesIO()
        Image.frombytes("CMYK", block.shape[1::-1],
                        np.ascontiguousarray(block, np.uint8).tobytes()).save(
            buf, "JPEG", quality=quality)
        return buf.getvalue()
    if block.ndim == 2 or block.shape[2] == 1:
        ok, enc = cv2.imencode(".jpg", block.reshape(block.shape[:2]),
                               [cv2.IMWRITE_JPEG_QUALITY, quality])
        return enc.tobytes()
    factor = {(1, 1): cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
              (2, 1): cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
              (2, 2): cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
              (1, 2): cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
              (4, 1): cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}[sampling]
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor]
    ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(block[:, :, ::-1]),
                           params)
    return enc.tobytes()


def tiff_file(img, photometric=None, compression=1, rps=None, predictor=1,
              cmap=None, orientation=None, big=False, ifd_first=True,
              tags=None, drop=(), strips=None, bits=8, planar=1, tile=None,
              bigtiff=False, fillorder=1, extra=None, ycc=None, jpeg=None):
    """A TIFF of ``img`` ([h, w] gray or palette indices, or [h, w, spp]
    samples; uint16 for ``bits=16``): one IFD of SHORT and LONG tags in
    ascending order (LONG8 offsets and counts in a ``bigtiff``), its values
    after it, the strips of ``rps`` rows, or the ``tile`` = (width, length)
    tiles (edge tiles padded with zeros), of each plane (``planar`` 2: one
    plane a sample), at ``bits`` a sample (``pack_rows``), with the
    horizontal ``predictor`` (8 and 16 bits), compressed with
    ``compression`` (1, 5 LZW, 8 or 32946 deflate, 32773 PackBits a row),
    bits reversed for ``fillorder`` 2, after the header and IFD
    (``ifd_first``) or before them; ``big`` a big-endian file, ``extra``
    the ExtraSamples values, ``tags`` {tag: (type, values)} added or
    replaced, ``drop`` tags left out, ``strips`` the strips' or tiles'
    bytes in place of the encoded ones. ``ycc`` = (hs, vs): ``img`` holds
    Y, Cb, Cr, packed in sampling blocks (``ycc_blocks``) with photometric
    6 and the YCbCrSubsampling tag. ``jpeg``: a function of each strip's
    or tile's block that gives its JPEG stream (compression 7)."""
    e = ">" if big else "<"
    img = np.asarray(img).astype(np.uint16 if bits == 16 else np.uint8)
    h, w = img.shape[:2]
    spp = 1 if img.ndim == 2 else img.shape[2]
    rps = h if rps is None else rps
    samples = img.reshape(h, w, spp)
    planes = [samples] if planar == 1 else [samples[:, :, k:k + 1]
                                            for k in range(spp)]

    def encode(block):  # [n, cols, c] -> the chunk's bytes
        n, cols, c = block.shape
        if predictor == 2:
            d = block.astype(np.int64)
            d[:, 1:] -= d[:, :-1].copy()
            block = d & ((1 << bits) - 1)
        if jpeg is not None:
            return jpeg(block)
        rows = pack_rows(block.reshape(n, cols * c), bits, e)
        raw = b"".join(rows)
        if ycc is not None:
            raw = ycc_blocks(block, *ycc)
            rows = [raw]
        data = (raw if compression == 1 else
                b"".join(packbits(r) for r in rows) if compression == 32773
                else lzw(raw) if compression == 5 else zlib.compress(raw))
        return reverse_bits(data) if fillorder == 2 else data

    if strips is None:
        strips = []
        for plane in planes:
            if tile is None:
                strips += [encode(plane[y:y + rps]) for y in range(0, h, rps)]
                continue
            tw, th = tile
            for y in range(0, h, th):
                for x in range(0, w, tw):
                    block = np.zeros((th, tw, plane.shape[2]), plane.dtype)
                    part = plane[y:y + th, x:x + tw]
                    block[:part.shape[0], :part.shape[1]] = part
                    strips.append(encode(block))
    wide = 16 if bigtiff else 4
    offsets_tag, counts_tag = (273, 279) if tile is None else (324, 325)
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp),
               259: (3, [compression]),
               262: (3, [(1 if spp == 1 else 2) if photometric is None
                         else photometric]),
               offsets_tag: (wide, [0] * len(strips)), 277: (3, [spp]),
               counts_tag: (wide, [len(s) for s in strips])}
    if tile is None:
        entries[278] = (4, [rps])
    else:
        entries[322], entries[323] = (3, [tile[0]]), (3, [tile[1]])
    if predictor != 1:
        entries[317] = (3, [predictor])
    if cmap is not None:
        entries[320] = (3, list(cmap))
    if orientation is not None:
        entries[274] = (3, [orientation])
    if planar != 1:
        entries[284] = (3, [planar])
    if fillorder != 1:
        entries[266] = (3, [fillorder])
    if extra is not None:
        entries[338] = (3, list(extra))
    if ycc is not None:
        entries[262], entries[530] = (3, [6]), (3, list(ycc))
    if jpeg is not None:
        entries[259] = (3, [7])
    entries.update(tags or {})
    for t in drop:
        entries.pop(t, None)
    count, inline, head_size = ("Q", 8, 16) if bigtiff else ("H", 4, 8)
    word = "Q" if bigtiff else "I"
    chars = {1: "B", 3: "H", 4: "I", 16: "Q", 5: "II", 10: "ii", 11: "f",
             12: "d", 7: "B"}

    def numbers(typ, v):  # rationals as (numerator, denominator) pairs
        if typ not in (5, 10):
            return list(v)
        out = []
        for x in v:
            f = x if isinstance(x, tuple) else Fraction(x).limit_denominator(1 << 16)
            out += list(f) if isinstance(f, tuple) else [f.numerator, f.denominator]
        return out

    def ifd(at, strip_at):
        ents = sorted(entries.items())
        values_at = (at + struct.calcsize(e + count)
                     + (4 + 2 * inline) * len(ents) + inline)
        body, values = bytearray(struct.pack(e + count, len(ents))), bytearray()
        offsets = list(np.cumsum([strip_at] + [len(s) for s in strips]))
        for tag, (typ, v) in ents:
            if tag == offsets_tag:
                v = [int(o) for o in offsets[:len(v)]]
            raw = struct.pack(e + chars[typ] * len(v), *numbers(typ, v))
            if len(raw) <= inline:
                body += (struct.pack(e + "HH" + word, tag, typ, len(v))
                         + raw.ljust(inline, b"\0"))
            else:
                body += struct.pack(e + "HH" + word + word, tag, typ, len(v),
                                    values_at + len(values))
                values += raw + b"\0" * (len(raw) % 2)
        return bytes(body + struct.pack(e + word, 0) + values)

    if bigtiff:
        head = (b"MM\0+" if big else b"II+\0") + struct.pack(e + "HH", 8, 0)
    else:
        head = b"MM\0*" if big else b"II*\0"
    data = b"".join(strips)
    if ifd_first:
        size = len(ifd(head_size, 0))
        return (head + struct.pack(e + word, head_size)
                + ifd(head_size, head_size + size) + data)
    at = head_size + len(data) + len(data) % 2
    return (head + struct.pack(e + word, at) + data + b"\0" * (len(data) % 2)
            + ifd(at, head_size))


def pil_tiff(img, mode, **kw):
    """Pillow's TIFF of RGB ``img`` converted to ``mode``."""
    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, "TIFF", **kw)
    return buf.getvalue()
