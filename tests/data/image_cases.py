"""The cases of ``tests/data/images/make_fixtures.py`` (which writes them
and their ``expected.npz``): each function gives ``{name: bytes}`` from
the seeded stream it is handed (``cases`` and ``skip_cases`` from
make_fixtures' SEED, the others from their own). They live beside the byte writers, out of the fixture directory,
whose size a test bounds.

What they hold: the PNM family outside P5/P6 (ASCII P1-P3, bitmap P4, PAM
P7 of every TUPLTYPE), the BMP variants (16-bit, BI_BITFIELDS, the OS/2
core header, RLE8, RLE4), PNGs that libpng reads with a warning (a bad
ancillary CRC, a split zlib stream, bytes after IEND), GIFs (``gif_*.png``:
interlaced, local and global colour tables, transparency, a frame inside a
larger screen, two frames, LZW code sizes 2 and 8, clear codes mid-stream,
a full code table, a gray palette, extensions), Sun rasters
(``sun_*.ppm``: 1, 8, 24 and 32 bits, colour maps, RT_OLD, an odd width),
PFM (``pfm*``: cv2's writer, big endian, scales 0.5 and 3, samples past
255, negative, NaN and infinite, ties, odd header whitespace), Radiance HDR
(``hdr_*.png``: cv2's run-length and flat writers, the ``#?RGBE``
signature, EXPOSURE and other header lines, a width under 8, zero
exponents, values past 1, runs and literals of every length, a scanline
that falls back to flat) and TIFF (``tiff_*``: parts 1, 2a and 2b, and
the CCITT codecs of part 2c) and WebP (``webp_*``, written into
tests/data/webp by its own make_fixtures.py: cv2's and Pillow's lossless
files, few-colour and meta-code content, animations, EXIF orientations,
extra chunks, and streams chip_smoke.vp8l_bytes writes with each VP8L
feature); the
skip cases are what cv2 refuses, some of which PIL reads (a GIF without its
trailer, a Sun raster of type RT_BYTE_ENCODED or RT_FORMAT_RGB, which
OpenCV 5 refuses, a gray PFM, which cv2 refuses under IMREAD_COLOR, TIFFs
of orientations 5 to 8).
"""

import ctypes
import importlib.util
import io
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

GIF_SEED = 14  # the GIF and Sun raster files draw from their own stream
PFM_HDR_SEED = 15  # and the PFM and Radiance HDR files from theirs
TIFF_SEED = 16  # and the TIFF files from theirs
TIFF2_SEED = 17  # and the TIFF part 2a files from theirs
TIFF2B_SEED = 19  # and the TIFF part 2b files from theirs
TIFF2C_SEED = 20  # and the CCITT files from theirs
WEBP_SEED = 21  # and the WebP files from theirs

_spec = importlib.util.spec_from_file_location(
    "image_writers", Path(__file__).resolve().parent / "image_writers.py")
writers = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(writers)
globals().update({name: getattr(writers, name) for name in writers.__all__})
# the VP8L writer phase 13 of chip_smoke.py runs on the card
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[2] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

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


def tiff2_cases(rng):
    """{name: bytes} of the TIFF part 2a files cv2.imread reads: Pillow's
    writer (modes 1, LA, RGBA, I;16), cv2's (16-bit RGB, RGBA), and files
    built here: 1, 4 (palette) and 16-bit samples, MINISWHITE, SampleFormat
    2, ExtraSamples 0, 1 and 2 and two extra samples, planar configuration
    2, FillOrder 2, tiles (edge tiles, sizes that are no multiple of 16, a
    tile larger than the image, 16-bit gray edge tiles that libtiff reads
    askew), BigTIFF of both byte orders, and a square image of
    orientation 6 (cv2 rotates it; one of any other shape gives None)."""
    out = {}
    img = np.asarray(Image.fromarray(smooth(np.random.default_rng(
        TIFF_SEED + 1), 18, 21)).convert("L"), np.uint16) * 257
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "TIFF")  # mode I;16
    out["tiff16_gray.png"] = buf.getvalue()
    for name, mode in (("tiff_pil_1bit.png", "1"), ("tiff_pil_la.ppm", "LA")):
        out[name] = pil_tiff(smooth(rng, 5, 6), mode)
    buf = io.BytesIO()  # RGBA: unassociated alpha, which cv2 premultiplies
    Image.fromarray(np.dstack([smooth(rng, 5, 6), rng.integers(
        0, 256, (5, 6), np.uint8)]), "RGBA").save(buf, "TIFF")
    out["tiff_pil_rgba.png"] = buf.getvalue()
    wide = (smooth(rng, 5, 6).astype(np.uint16) * 257
            + rng.integers(0, 257, (5, 6, 3))).astype(np.uint16)
    ok, enc = cv2.imencode(".tif", wide[:, :, ::-1])  # LZW, predictor 2
    assert ok
    out["tiff_cv2_rgb16.ppm"] = enc.tobytes()
    rgba = np.dstack([smooth(rng, 5, 6), rng.integers(0, 256, (5, 6), np.uint8)])
    ok, enc = cv2.imencode(".tif", rgba[:, :, [2, 1, 0, 3]])  # no ExtraSamples
    out["tiff_cv2_rgba.jpeg"] = enc.tobytes()
    bits = (gray(smooth(rng, 6, 11)) > 128).astype(np.uint8)
    out["tiff_1bit_miniswhite_packbits.bmp"] = tiff_file(
        bits, bits=1, photometric=0, compression=32773, rps=4, big=True)
    out["tiff_1bit_palette_lzw.png"] = tiff_file(
        bits, bits=1, photometric=3, cmap=rng.integers(0, 65536, 6),
        compression=5, fillorder=2)
    out["tiff_4bit_palette.png"] = tiff_file(
        gray(smooth(rng, 5, 7)) >> 4, bits=4, photometric=3,
        cmap=rng.integers(0, 65536, 48), compression=8)
    out["tiff_miniswhite_sampleformat_2.png"] = tiff_file(
        gray(smooth(rng, 5, 6)), photometric=0, compression=8, predictor=2,
        tags={339: (3, [2])})
    out["tiff_miniswhite_16bit.bmp"] = tiff_file(
        wide[:, :, 0], bits=16, photometric=0, big=True)
    out["tiff_extra_0.png"] = tiff_file(
        np.dstack([smooth(rng, 5, 6), rng.integers(0, 256, (5, 6))]),
        extra=[0], compression=32773)
    out["tiff_extra_1_16bit.png"] = tiff_file(
        np.dstack([wide, wide[:, :, 1]]), bits=16, extra=[1],
        compression=5, predictor=2)
    out["tiff_extra_2_16bit.bmp"] = tiff_file(
        np.dstack([wide, wide[:, :, 2]]), bits=16, extra=[2], big=True)
    out["tiff_gray_two_extra.png"] = tiff_file(
        np.dstack([gray(smooth(rng, 5, 6))] + [rng.integers(0, 256, (5, 6))] * 2),
        photometric=1, extra=[2, 0])
    out["tiff_planar2_gray.png"] = tiff_file(gray(smooth(rng, 5, 6)), planar=2)
    out["tiff_planar2_rgba_tiles.png"] = tiff_file(
        np.dstack([smooth(rng, 5, 17), rng.integers(0, 256, (5, 17))]),
        planar=2, extra=[2], tile=(16, 8), compression=5, predictor=2)
    out["tiff_fillorder2_gray.png"] = tiff_file(gray(smooth(rng, 5, 6)),
                                                fillorder=2)
    out["tiff_tiles_odd_width.png"] = tiff_file(
        gray(smooth(rng, 9, 13)), tile=(10, 6), compression=8)
    out["tiff_tile_larger_than_image.ppm"] = tiff_file(
        smooth(rng, 5, 6), tile=(32, 16), compression=8)
    out["tiff_tiles_16bit_gray.png"] = tiff_file(  # libtiff's edge skew
        (gray(smooth(rng, 5, 19)).astype(np.uint16) * 251), bits=16,
        tile=(16, 8), compression=8)
    out["tiff_bigtiff_lzw.png"] = tiff_file(
        smooth(rng, 5, 6), bigtiff=True, compression=5, rps=3)
    out["tiff_bigtiff_be_tiles.bmp"] = tiff_file(
        gray(smooth(rng, 5, 17)), bigtiff=True, big=True, tile=(16, 8),
        compression=32773)
    out["tiff_orientation_6_square.png"] = tiff_file(
        smooth(rng, 5, 5), orientation=6, tile=(16, 16), compression=8)
    return out


def tiff2_skip_cases(rng):
    """{name: bytes} of TIFF part 2a files cv2.imread gives None for: 2 and
    4-bit gray and 2-bit palette samples (PIL reads them), unassociated
    alpha of orientation 6 (PIL reads it rotated, alpha dropped), FillOrder
    2 on uncompressed tiles (libtiff refuses a raw buffer of another size
    than the tile), a TileByteCounts shorter than the tiles (PIL reads
    every tile whole), a BigTIFF of orientation 5 and planar 16-bit gray of
    orientation 8."""
    out = {}
    out["tiff_2bit_gray.png"] = tiff_file(gray(smooth(rng, 5, 6)) >> 6, bits=2)
    out["tiff_4bit_gray_fillorder2.png"] = tiff_file(
        gray(smooth(rng, 5, 6)) >> 4, bits=4, fillorder=2, compression=5)
    out["tiff_2bit_palette.png"] = tiff_file(
        gray(smooth(rng, 5, 6)) >> 6, bits=2, photometric=3,
        cmap=rng.integers(0, 65536, 12))
    out["tiff_orientation_6_rgba.png"] = tiff_file(
        np.dstack([smooth(rng, 5, 6), rng.integers(0, 256, (5, 6))]),
        extra=[2], orientation=6)
    out["tiff_fillorder2_raw_tiles.png"] = tiff_file(
        gray(smooth(rng, 5, 17)), tile=(16, 8), fillorder=2)
    out["tiff_tiles_short_byte_counts.png"] = tiff_file(
        gray(smooth(rng, 5, 17)), tile=(16, 8), tags={325: (4, [128])})
    out["tiff_bigtiff_orientation_5.png"] = tiff_file(
        smooth(rng, 5, 6), bigtiff=True, orientation=5, compression=8)
    out["tiff_planar2_16bit_orientation_8.png"] = tiff_file(
        gray(smooth(rng, 5, 6)).astype(np.uint16) * 300, bits=16, planar=2,
        orientation=8, compression=32773)
    return out


def tiff2b_cases(rng):
    """TIFF part 2b, each read by cv2: CMYK (Pillow's, and 4 separate
    planes with K), YCbCr (Pillow's, and libtiff's packed blocks at every
    subsampling its reader puts: 2 x 1, 2 x 2, 4 x 1, 4 x 2, 4 x 4 on a
    width of odd blocks, 1 x 2; tiles with ReferenceBlackWhite and Rec. 709
    coefficients; separate planes), JPEG (Pillow's RGB, gray, YCbCr and
    tiled CMYK with JPEGTables; whole cv2 streams at 4:2:0 in strips, 4:2:2
    in tiles, and 4:4:4 without the subsampling tag), an unknown
    compression (zeros), and CIELAB of 8 and 16 bits (Pillow's LAB writer
    goes through LittleCMS, whose bytes differ from run to run)."""
    out = {}
    out["tiff_cmyk_pil_lzw.png"] = pil_tiff(smooth(rng, 6, 7), "CMYK",
                                            compression="tiff_lzw")
    out["tiff_cmyk_k_planar.bmp"] = tiff_file(
        rng.integers(0, 256, (5, 6, 4)), photometric=5, planar=2,
        compression=32773)
    out["tiff_ycbcr_pil.png"] = pil_tiff(smooth(rng, 5, 6), "YCbCr")
    for name, size, kw in (
            ("21.png", (7, 9), {"ycc": (2, 1), "rps": 3}),
            ("22_lzw.ppm", (9, 11), {"ycc": (2, 2), "rps": 4, "compression": 5}),
            ("41_deflate.png", (6, 13), {"ycc": (4, 1), "compression": 8}),
            ("42.bmp", (7, 10), {"ycc": (4, 2), "rps": 4}),
            ("44_odd.png", (9, 9), {"ycc": (4, 4), "rps": 8}),
            ("12_packbits.png", (7, 6), {"ycc": (1, 2), "compression": 32773}),
            ("tiles_refbw.png", (16, 20), {
                "ycc": (2, 2), "tile": (16, 16), "compression": 8,
                "tags": {532: (5, [16, 235, 128, 240, 128, 240]),
                         529: (5, [0.2126, 0.7152, 0.0722])}}),
            ("planar.png", (5, 7), {"photometric": 6, "planar": 2,
                                    "tags": {530: (3, [1, 1])}})):
        out["tiff_ycbcr_" + name] = tiff_file(
            rng.integers(0, 256, size + (3,)), **kw)
    out["tiff_jpeg.png"] = pil_tiff(smooth(np.random.default_rng(
        TIFF2_SEED + 1), 16, 16), "RGB", compression="jpeg")
    out["tiff_jpeg_pil_gray.ppm"] = pil_tiff(smooth(rng, 8, 16), "L",
                                             compression="jpeg")
    out["tiff_jpeg_pil_ycbcr.png"] = pil_tiff(smooth(rng, 16, 16), "YCbCr",
                                              compression="jpeg")
    out["tiff_jpeg_cmyk_tile.bmp"] = tiff_file(
        np.dstack([smooth(rng, 16, 16), smooth(rng, 16, 16)[:, :, :1]]),
        photometric=5, tile=(16, 16), jpeg=jpeg_stream)
    out["tiff_jpeg_420.png"] = tiff_file(
        smooth(rng, 20, 16), photometric=6, rps=16,
        jpeg=lambda b: jpeg_stream(b, (2, 2)), tags={530: (3, [2, 2])})
    out["tiff_jpeg_422_tiles.png"] = tiff_file(
        smooth(rng, 16, 20), photometric=6, tile=(16, 16),
        jpeg=lambda b: jpeg_stream(b, (2, 1)), tags={530: (3, [2, 1])})
    out["tiff_jpeg_444_no_tag.ppm"] = tiff_file(
        smooth(rng, 10, 12), photometric=6,
        jpeg=lambda b: jpeg_stream(b, (1, 1)))
    out["tiff_unknown_compression.png"] = tiff_file(
        smooth(rng, 4, 5), tags={259: (3, [99])})
    out["tiff_cielab.png"] = tiff_file(rng.integers(0, 256, (6, 7, 3)),
                                       photometric=8, compression=5)
    out["tiff_cielab16.bmp"] = tiff_file(rng.integers(0, 65536, (4, 5, 3)),
                                         photometric=8, bits=16)
    return out


def tiff2b_skip_cases(rng):
    """TIFF part 2b files cv2.imread gives None for: orientations 6, 5 and
    7 of a non-square image (PIL reads LZW YCbCr through libtiff's RGBA
    reader, a raw CMYK strip mapped at the rotated size, JPEG YCbCr as
    RGB); a 4:2:0 stream under photometric RGB and a 2 x 4 subsampling,
    which neither reads."""
    out = {}
    out["tiff_ycbcr_lzw_orientation_6.png"] = tiff_file(
        rng.integers(0, 256, (6, 9, 3)), ycc=(2, 2), compression=5,
        orientation=6)
    out["tiff_cmyk_orientation_5.png"] = tiff_file(
        rng.integers(0, 256, (6, 8, 4)), photometric=5, orientation=5)
    out["tiff_jpeg_orientation_7.png"] = tiff_file(
        smooth(rng, 16, 24), photometric=6, orientation=7,
        jpeg=lambda b: jpeg_stream(b, (2, 2)), tags={530: (3, [2, 2])})
    out["tiff_jpeg_rgb_420.png"] = tiff_file(
        smooth(rng, 16, 16), photometric=2,
        jpeg=lambda b: jpeg_stream(b, (2, 2)))
    out["tiff_ycbcr_24.png"] = tiff_file(rng.integers(0, 256, (8, 6, 3)),
                                         ycc=(2, 4))
    return out


def tiff2c_cases(rng):
    """The CCITT codecs of TIFF part 2c, each read by cv2: Pillow's group 4
    (the file that stood for C7's TIFF data under skip/, its bytes kept),
    group 3 1-D and 2-D (Group3Options 1), CCITT RLE and RLE/W (which
    libtiff's own decoder reads damaged, as cv2 and PIL do), these four of
    8 x 8 dithered pixels."""
    out = {"tiff_group4.png": pil_tiff(smooth(np.random.default_rng(
        TIFF2B_SEED + 1), 16, 16), "1", compression="group4")}
    for name, kw in (("g3_1d.png", {"compression": "group3"}),
                     ("g3_2d.ppm", {"compression": "group3",
                                    "tiffinfo": {292: 1}}),
                     ("rle.bmp", {"compression": "tiff_ccitt"}),
                     ("rlew.png", {"compression": "tiff_raw_16"})):
        out["tiff_ccitt_" + name] = pil_tiff(smooth(rng, 8, 8), "1", **kw)
    return out


# ------------------------------------------------------------------ WebP

def webp_pil(img, **kw):
    """Pillow's lossless WebP (VP8L) of ``img`` (RGB or RGBA)."""
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", lossless=True, **kw)
    return buf.getvalue()


def webp_cv2(img):
    """cv2.imwrite's WebP of an RGB image at its defaults (VP8L)."""
    ok, enc = cv2.imencode(".webp", np.ascontiguousarray(img[:, :, ::-1]))
    assert ok
    return enc.tobytes()


def webp_chunks(data):
    """[(fourcc, payload)] of a RIFF WEBP file's chunks."""
    out, i = [], 12
    while i + 8 <= len(data):
        n = struct.unpack("<I", data[i + 4:i + 8])[0]
        out.append((data[i:i + 4], data[i + 8:i + 8 + n]))
        i += 8 + n + (n & 1)
    return out


def vp8x(w, h, flags, size=10):
    """A VP8X chunk: ``flags`` (0x02 animation, 0x04 XMP, 0x08 EXIF, 0x10
    alpha, 0x20 ICC), a ``w`` x ``h`` canvas, ``size`` - 10 bytes more."""
    return (b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little")
            + (h - 1).to_bytes(3, "little") + bytes(size - 10))


def anmf(x, y, w, h, chunks, flags=0):
    """An ANMF chunk: the frame at (``x``, ``y``) (even), its ``w`` x
    ``h``, then ``chunks`` ([(fourcc, payload)]), each padded."""
    inner = chip_smoke.webp_riff(chunks)[12:]
    return (b"ANMF", (x // 2).to_bytes(3, "little")
            + (y // 2).to_bytes(3, "little") + (w - 1).to_bytes(3, "little")
            + (h - 1).to_bytes(3, "little") + (100).to_bytes(3, "little")
            + bytes([flags]) + inner)


def exif_tiff(orientation, big=False):
    """An EXIF chunk's TIFF stream: IFD0 with the Orientation tag alone."""
    e = ">" if big else "<"
    return ((b"MM\0*" if big else b"II*\0") + struct.pack(e + "IH", 8, 1)
            + struct.pack(e + "HHIHH", 0x112, 3, 1, orientation, 0)
            + bytes(4))


def with_riff_size(data, delta):
    """``data`` with its RIFF size off by ``delta``."""
    n = struct.unpack("<I", data[4:8])[0]
    return data[:4] + struct.pack("<I", n + delta) + data[8:]


def webp_palette_image(rng, k, h, w):
    """``k`` random colours, each used, over ``h`` x ``w`` pixels."""
    pal = rng.integers(0, 256, (k, 3))
    idx = rng.integers(0, k, (h, w))
    idx.flat[:k] = np.arange(k)
    return pal[idx].astype(np.uint8)


def webp_writer_cases(rng):
    """{name: VP8L payload} of chip_smoke.vp8l_bytes, one VP8L feature or
    more each: every predictor mode (0-13, and 14 and 15, which predict
    black), cross-colour, subtract-green, colour indexing at 8, 4, 2 and 1
    pixels a byte, colour caches of 1 and 11 bits, meta prefix codes (with
    unused groups between), simple codes of one and two symbols, normal
    codes with the code-length count, plain and distance-map distances and
    overlapping copies."""
    vb = chip_smoke.vp8l_bytes
    out = {}
    img = smooth(rng, 16, 16)
    out["predictor_modes"] = vb(img, [("predictor", 2, np.arange(16).reshape(
        4, 4))])
    out["cross_colour"] = vb(smooth(rng, 16, 20), [(
        "cross", 2, rng.integers(-128, 128, (4, 5, 3)))])
    out["subtract_green"] = vb(smooth(rng, 14, 18), [("green",)])
    out["three_transforms"] = vb(smooth(rng, 20, 20), [
        ("green",), ("predictor", 3, rng.integers(0, 14, (3, 3))),
        ("cross", 3, rng.integers(-128, 128, (3, 3, 3)))])
    for k, w in ((2, 20), (3, 18), (5, 19), (17, 16)):
        out[f"palette_{k}"] = vb(webp_palette_image(rng, k, 12, w),
                                 [("palette",)])
    out["palette_predictor"] = vb(webp_palette_image(rng, 5, 16, 16), [
        ("palette",), ("predictor", 2, rng.integers(0, 14, (4, 2)))],
        sub_cache_bits=2)
    rgba = np.concatenate([webp_palette_image(rng, 12, 16, 16),
                           rng.integers(0, 2, (16, 16, 1)).astype(
                               np.uint8) * 255], 2)
    out["cache_1"] = vb(rgba, cache_bits=1)
    out["cache_11"] = vb(smooth(rng, 16, 16), cache_bits=11)
    out["meta_codes"] = vb(smooth(rng, 20, 20), meta_bits=2, meta_groups=3,
                           cache_bits=3)
    out["simple_1"] = vb(np.full((12, 12, 3), (200, 100, 50), np.uint8))
    out["simple_2"] = vb(webp_palette_image(rng, 2, 10, 14), lz77=False)
    out["normal_codes"] = vb(smooth(rng, 12, 12), simple=False,
                             max_symbol=True)
    tile = smooth(rng, 6, 7)
    out["plain_distances"] = vb(np.tile(tile, (3, 3, 1)), dist_mode="plain")
    out["map_distances"] = vb(np.tile(tile, (3, 3, 1)), dist_mode="map")
    rows = np.repeat(rng.integers(0, 256, (16, 1, 3)), 20, 1).astype(
        np.uint8)
    out["overlapping_copies"] = vb(rows, dist_mode="both")
    return out


def webp_cases(rng):
    """{name: bytes} of the WebP files cv2.imread reads (each lossless, so
    cv2 and PIL give the same pixels but for the EXIF orientation, which
    cv2 applies and PIL does not)."""
    out = {"webp_cv2_smooth.png": webp_cv2(smooth(rng, 20, 24)),
           "webp_cv2_noise.jpg": webp_cv2(rng.integers(0, 256, (12, 16, 3)
                                                       ).astype(np.uint8)),
           "webp_pil_rgb.png": webp_pil(smooth(rng, 18, 22))}
    rgba = np.concatenate([smooth(rng, 16, 20), rng.integers(
        0, 256, (16, 20, 1)).astype(np.uint8)], 2)
    rgba[::3, :, 3] = 0
    out["webp_pil_rgba.png"] = webp_pil(rgba)
    out["webp_pil_rgba_exact.jpeg"] = webp_pil(rgba, exact=True)
    for k in (2, 4, 16, 256):
        out[f"webp_colours_{k}.png"] = webp_pil(webp_palette_image(
            rng, k, 20, 24))
    # large enough for Pillow's encoder to use meta prefix codes
    img = cv2.resize(rng.integers(0, 256, (8, 8, 3)).astype(np.uint8),
                     (48, 48), interpolation=cv2.INTER_NEAREST)
    img[:24] = smooth(rng, 24, 48)
    out["webp_meta_codes.png"] = webp_pil(img, method=6, quality=100)
    frames = [Image.fromarray(smooth(rng, 12, 14)) for _ in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                   lossless=True)
    out["webp_anim_3_frames.png"] = buf.getvalue()
    frame = chip_smoke.vp8l_bytes(smooth(rng, 10, 12))
    out["webp_anim_offset.png"] = chip_smoke.webp_riff([
        vp8x(20, 16, 0x02), (b"ANIM", b"\x00\x00\xff\xff\x00\x00"),
        anmf(4, 2, 12, 10, [(b"VP8L", frame)]),
        anmf(0, 0, 6, 4, [(b"VP8L", chip_smoke.vp8l_bytes(
            smooth(rng, 4, 6)))])])
    still = chip_smoke.vp8l_bytes(smooth(rng, 10, 12))
    for o in range(2, 9):
        out[f"webp_exif_{o}.png"] = chip_smoke.webp_riff([
            vp8x(12, 10, 0x08), (b"VP8L", still),
            (b"EXIF", exif_tiff(o, big=o % 2 == 1))])
    out["webp_iccp_unknown.png"] = chip_smoke.webp_riff([
        vp8x(12, 10, 0x20), (b"ICCP", bytes(range(13))), (b"VP8L", still),
        (b"ABCD", b"xyz")])
    out["webp_trailing_bytes.png"] = webp_cv2(smooth(rng, 11, 13)) + bytes(7)
    # an EXIF chunk whose size runs past the file (WebPDemux refuses it:
    # cv2 reads the pixels unrotated), a reserved VP8X flag (the same)
    f = chip_smoke.webp_riff([vp8x(12, 10, 0x08), (b"VP8L", still),
                              (b"EXIF", exif_tiff(6))])
    i = f.index(b"EXIF")
    out["webp_exif_past_end.png"] = f[:i + 7] + b"\x01" + f[i + 8:]
    out["webp_reserved_flag.png"] = chip_smoke.webp_riff([
        vp8x(12, 10, 0x88), (b"VP8L", still),
        (b"EXIF", exif_tiff(6))])
    for name, payload in webp_writer_cases(rng).items():
        out[f"webp_vp8l_{name}.png"] = chip_smoke.webp_riff([
            (b"VP8L", payload)])
    return out


def webp_skip_cases(rng):
    """{name: bytes} of the WebP files cv2.imread gives None for: a valid
    1 x 1 file of 28 bytes (cv2 wants 32; PIL reads it), and layouts and
    streams both readers refuse: a cut file, a canvas other than the
    image's, a frame past its canvas, RIFF sizes too large and too small, a
    later frame that is no image, a VP8L stream whose data ends early, of
    version 1, with a prefix code incomplete or over-subscribed, a
    distance before the first pixel, a copy past the last, a transform
    twice, and a colour cache of 12 bits."""
    vb = chip_smoke.vp8l_bytes
    riff = chip_smoke.webp_riff
    out = {"webp_tiny_28_bytes.png": riff([(b"VP8L", vb(np.array(
        [[[1, 1, 0, 1]]], np.uint8)))])}
    assert len(out["webp_tiny_28_bytes.png"]) == 28
    f = webp_cv2(smooth(rng, 12, 14))
    out["webp_cut.png"] = f[:len(f) * 2 // 3]
    still = vb(smooth(rng, 10, 12))
    out["webp_canvas_14x10.png"] = riff([vp8x(14, 10, 0), (b"VP8L", still)])
    out["webp_canvas_12x11.png"] = riff([vp8x(12, 11, 0), (b"VP8L", still)])
    out["webp_frame_overflow.png"] = riff([
        vp8x(20, 16, 0x02), (b"ANIM", bytes(6)),
        anmf(10, 8, 12, 10, [(b"VP8L", still)])])
    plain = riff([(b"VP8L", still)])
    out["webp_riff_plus_8.png"] = with_riff_size(plain, 8)
    out["webp_riff_minus_2.png"] = with_riff_size(plain, -2)
    broken = bytearray(vb(smooth(rng, 4, 6)))
    broken[0] = 0x2e
    out["webp_bad_later_frame.png"] = riff([
        vp8x(12, 10, 0x02), (b"ANIM", bytes(6)),
        anmf(0, 0, 12, 10, [(b"VP8L", still)]),
        anmf(0, 0, 6, 4, [(b"VP8L", bytes(broken))])])
    out["webp_data_short.png"] = riff([(b"VP8L", still[:len(still) // 2])])
    v1 = bytearray(still)
    v1[4] |= 0x20
    out["webp_version_1.png"] = riff([(b"VP8L", bytes(v1))])
    px = np.array([[[0, 0, 0, 255], [0, 1, 0, 255], [0, 2, 0, 255]]],
                  np.uint8)
    out["webp_code_incomplete.png"] = riff([(b"VP8L", vb(
        px[:, :2], lz77=False, code_lens={0: [1, 2] + [0] * 278}))])
    out["webp_code_oversubscribed.png"] = riff([(b"VP8L", vb(
        px, lz77=False, code_lens={0: [1, 1, 1] + [0] * 277}))])
    lit = [("lit", 0xff000000 | k << 8) for k in range(4)]
    out["webp_distance_before_start.png"] = riff([(b"VP8L", vb(
        np.zeros((1, 8, 3), np.uint8), tokens=lit[:2] + [("copy", 4, 124)]
        + lit[:2]))])
    out["webp_copy_past_end.png"] = riff([(b"VP8L", vb(
        np.zeros((1, 8, 3), np.uint8), tokens=lit + [("copy", 6, 122)]))])
    out["webp_transform_twice.png"] = riff([(b"VP8L", vb(
        smooth(rng, 8, 8), [("green",), ("green",)]))])
    out["webp_cache_12_bits.png"] = riff([(b"VP8L", vb(
        smooth(rng, 8, 8), cache_bits=12))])
    return out


# ------------------------------------------------------------- lossy WebP

WEBP_LOSSY_SEED = 23  # the lossy WebP files draw from their own stream


def _vp8_tables():
    """{name: list} of vp8.cpp's probability tables (RFC 6386's, in
    libwebp's order of the 4x4 modes), read from the source: the VP8
    writer codes with them, and cv2 judges what it writes."""
    import re
    src = (Path(__file__).resolve().parents[2] / "tsr_tpu_torch" / "native"
           / "vp8.cpp").read_text()
    out = {}
    for name in ("kBModesProba", "kCoeffsProba0", "kCoeffsUpdateProba"):
        body = re.search(name + r"\[[^]]*\] = \{([^}]*)\}", src).group(1)
        out[name] = [int(v) for v in re.findall(r"\d+", body)]
    return out


class BoolWriter:
    """RFC 6386's boolean encoder (section 7.3)."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.bit_count = 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, prob, bit):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xffffffff
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def value(self, v, bits):
        for k in range(bits - 1, -1, -1):
            self.put(128, (v >> k) & 1)

    def signed(self, v, bits):
        self.value(abs(v), bits)
        self.put(128, int(v < 0))

    def flush(self):
        for _ in range(32):  # libvpx's padding: any decoder reads past it
            self.put(128, 0)
        return bytes(self.out)


VP8_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
VP8_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
VP8_CATS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
            (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))


def _vp8_large(bw, p, v):
    """GetLargeValue's tree for a level v >= 2."""
    if v <= 4:
        bw.put(p[3], 0)
        bw.put(p[4], int(v > 2))
        if v > 2:
            bw.put(p[5], v - 3)
        return
    bw.put(p[3], 1)
    if v <= 10:
        bw.put(p[6], 0)
        bw.put(p[7], int(v > 6))
        if v <= 6:
            bw.put(159, v - 5)
        else:
            bw.put(165, (v - 7) >> 1)
            bw.put(145, (v - 7) & 1)
        return
    bw.put(p[6], 1)
    cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
    bw.put(p[8], cat >> 1)
    bw.put(p[9 + (cat >> 1)], cat & 1)
    extra = v - (3 + (8 << cat))
    tab = VP8_CATS[cat]
    for k, prob in enumerate(tab):
        bw.put(prob, (extra >> (len(tab) - 1 - k)) & 1)


def _vp8_tokens(bw, proba, ctx, levels, first):
    """One block's levels (zigzag order) from coefficient ``first``, as
    GetCoeffs reads them; True where one is non-zero."""
    nonzero = [n for n in range(first, 16) if levels[n]]
    last = nonzero[-1] if nonzero else -1
    n, p = first, proba[VP8_BANDS[first]][ctx]
    while n < 16:
        if n > last:
            bw.put(p[0], 0)
            break
        bw.put(p[0], 1)
        while not levels[n]:
            bw.put(p[1], 0)
            n += 1
            p = proba[VP8_BANDS[n]][0]
        bw.put(p[1], 1)
        v = abs(int(levels[n]))
        if v == 1:
            bw.put(p[2], 0)
            nxt = proba[VP8_BANDS[n + 1]][1]
        else:
            bw.put(p[2], 1)
            _vp8_large(bw, p, v)
            nxt = proba[VP8_BANDS[n + 1]][2]
        bw.put(128, int(levels[n] < 0))
        n, p = n + 1, nxt
    return last >= 0


def vp8_bytes(w, h, mbs, profile=0, colorspace=0, clamp=0, scale=(0, 0),
              segments=None, simple=False, level=20, sharpness=0,
              lf_delta=None, partitions=0, q=(40, 0, 0, 0, 0, 0),
              skip_prob=None, empty_last=False):
    """A VP8 key frame (RFC 6386) of ``w`` x ``h`` pixels whose macroblocks
    (raster order) are ``mbs``: dicts of ``ymode`` (0 DC, 1 TM, 2 V, 3 H,
    or "B" with ``bmodes``, 16 of libwebp's 4x4 modes 0-9), ``uvmode``,
    ``segment``, ``skip`` and ``levels`` ({"y2": 16, "y": 16 x 16, "u",
    "v": 4 x 16}, quantised and in zigzag order; missing blocks zero). The
    header's ``profile`` (0-7), colour-space and clamping bits, the sides'
    2-bit ``scale``; ``segments`` a dict of ``update_map``, ``data``
    (None, or (absolute, 4 quantizers, 4 filter levels)) and ``probs``;
    the filter's type, level and sharpness and ``lf_delta`` (4 ref and 4
    mode deltas, None for none); 2^``partitions`` token partitions (the
    last written empty with ``empty_last``); ``q`` the base index and its
    five deltas; ``skip_prob`` the skip flag's probability (None: no skip
    flags). Tokens are coded on the default probabilities, the modes on
    RFC 6386's key-frame trees."""
    t = _vp8_tables()
    coeff = np.array(t["kCoeffsProba0"]).reshape(4, 8, 3, 11)
    bmodes_p = np.array(t["kBModesProba"]).reshape(10, 10, 9)
    mb_w, mb_h = (w + 15) // 16, (h + 15) // 16
    assert len(mbs) == mb_w * mb_h
    hdr = BoolWriter()
    hdr.put(128, colorspace)
    hdr.put(128, clamp)
    hdr.put(128, int(segments is not None))
    seg_probs = (255, 255, 255)
    if segments is not None:
        hdr.put(128, int(segments["update_map"]))
        data = segments.get("data")
        hdr.put(128, int(data is not None))
        if data is not None:
            absolute, quants, filters = data
            hdr.put(128, int(absolute))
            for v, bits in [(v, 7) for v in quants] + [(v, 6) for v in filters]:
                hdr.put(128, int(v != 0))
                if v:
                    hdr.signed(v, bits)
        if segments["update_map"]:
            seg_probs = segments.get("probs", (128, 128, 128))
            for p in seg_probs:
                hdr.put(128, int(p != 255))
                if p != 255:
                    hdr.value(p, 8)
    hdr.put(128, int(simple))
    hdr.value(level, 6)
    hdr.value(sharpness, 3)
    hdr.put(128, int(lf_delta is not None))
    if lf_delta is not None:
        hdr.put(128, 1)
        for v in list(lf_delta[0]) + list(lf_delta[1]):
            hdr.put(128, 1)
            hdr.signed(v, 6)
    hdr.value(partitions, 2)
    hdr.value(q[0], 7)
    for d in q[1:]:
        hdr.put(128, int(d != 0))
        if d:
            hdr.signed(d, 4)
    hdr.put(128, 0)  # refresh_entropy_probs
    for p in t["kCoeffsUpdateProba"]:
        hdr.put(p, 0)  # no coefficient probability updated
    hdr.put(128, int(skip_prob is not None))
    if skip_prob is not None:
        hdr.value(skip_prob, 8)
    parts = [BoolWriter() for _ in range(1 << partitions)]
    intra_t = [0] * (4 * mb_w)
    top_nz = [[0] * 9 for _ in range(mb_w)]  # 4 y, 2 u, 2 v, y2
    for my in range(mb_h):
        intra_l = [0] * 4
        left_nz = [0] * 9
        tok = parts[my % len(parts)]
        for mx in range(mb_w):
            mb = mbs[my * mb_w + mx]
            seg = mb.get("segment", 0)
            if segments is not None and segments["update_map"]:
                hdr.put(seg_probs[0], seg >> 1)
                hdr.put(seg_probs[1 + (seg >> 1)], seg & 1)
            skip = bool(mb.get("skip")) and skip_prob is not None
            if skip_prob is not None:
                hdr.put(skip_prob, int(skip))
            i4 = mb["ymode"] == "B"
            hdr.put(145, int(not i4))
            top = intra_t[4 * mx:4 * mx + 4]
            if not i4:
                m = mb["ymode"]
                hdr.put(156, int(m in (1, 3)))
                hdr.put(128 if m in (1, 3) else 163, int(m in (1, 2)))
                top, intra_l = [m] * 4, [m] * 4
            else:
                modes = mb["bmodes"]
                for y in range(4):
                    for x in range(4):
                        m = modes[4 * y + x]
                        p = bmodes_p[top[x], intra_l[y]]
                        # the tree: DC | TM | VE | (HE | (RD | VR)) |
                        # (LD | (VL | (HD | HU)))
                        path = {0: [(0, 0)], 1: [(0, 1), (1, 0)],
                                2: [(0, 1), (1, 1), (2, 0)],
                                3: [(0, 1), (1, 1), (2, 1), (3, 0), (4, 0)],
                                4: [(0, 1), (1, 1), (2, 1), (3, 0), (4, 1),
                                    (5, 0)],
                                5: [(0, 1), (1, 1), (2, 1), (3, 0), (4, 1),
                                    (5, 1)],
                                6: [(0, 1), (1, 1), (2, 1), (3, 1), (6, 0)],
                                7: [(0, 1), (1, 1), (2, 1), (3, 1), (6, 1),
                                    (7, 0)],
                                8: [(0, 1), (1, 1), (2, 1), (3, 1), (6, 1),
                                    (7, 1), (8, 0)],
                                9: [(0, 1), (1, 1), (2, 1), (3, 1), (6, 1),
                                    (7, 1), (8, 1)]}[m]
                        for node, bit in path:
                            hdr.put(int(p[node]), bit)
                        top[x] = intra_l[y] = m
            intra_t[4 * mx:4 * mx + 4] = top
            uv = mb.get("uvmode", 0)
            hdr.put(142, int(uv != 0))
            if uv:
                hdr.put(114, int(uv != 2))
                if uv != 2:
                    hdr.put(183, int(uv == 1))
            tnz = top_nz[mx]
            if skip:
                for k in range(8):
                    tnz[k] = left_nz[k] = 0
                if not i4:
                    tnz[8] = left_nz[8] = 0
                continue
            lv = mb.get("levels", {})
            zero = [0] * 16
            first, ytype = 0, 3
            if not i4:
                nz = _vp8_tokens(tok, coeff[1], tnz[8] + left_nz[8],
                                 lv.get("y2", zero), 0)
                tnz[8] = left_nz[8] = int(nz)
                first, ytype = 1, 0
            ys = lv.get("y", [zero] * 16)
            for y in range(4):
                for x in range(4):
                    nz = _vp8_tokens(tok, coeff[ytype], tnz[x] + left_nz[y],
                                     ys[4 * y + x], first)
                    tnz[x] = left_nz[y] = int(nz)
            for c, base in (("u", 4), ("v", 6)):
                blocks = lv.get(c, [zero] * 4)
                for y in range(2):
                    for x in range(2):
                        nz = _vp8_tokens(tok, coeff[2],
                                         tnz[base + x] + left_nz[base + y],
                                         blocks[2 * y + x], 0)
                        tnz[base + x] = left_nz[base + y] = int(nz)
    first_part = hdr.flush()
    datas = [p.flush() for p in parts]
    if empty_last:
        datas[-1] = b""
    sizes = b"".join(len(d).to_bytes(3, "little") for d in datas[:-1])
    tag = (profile << 1) | (1 << 4) | (len(first_part) << 5)
    return (tag.to_bytes(3, "little") + b"\x9d\x01\x2a"
            + (w | scale[0] << 14).to_bytes(2, "little")
            + (h | scale[1] << 14).to_bytes(2, "little") + first_part + sizes
            + b"".join(datas))


def vp8_random_mbs(rng, w, h, i4_share=0.5, segments=1, skip_share=0.0,
                   amp=3):
    """Macroblocks for vp8_bytes: 16x16 or 4x4 prediction in random modes,
    random segments, skip flags and small random levels (most zero)."""
    out = []
    for _ in range(((w + 15) // 16) * ((h + 15) // 16)):
        def blk(n):
            v = rng.integers(-amp, amp + 1, (n, 16))
            v[rng.random((n, 16)) < 0.7] = 0
            v[:, 6:] = np.where(rng.random((n, 10)) < 0.8, 0, v[:, 6:])
            return v.tolist()
        mb = {"uvmode": int(rng.integers(4)),
              "segment": int(rng.integers(segments)),
              "skip": bool(rng.random() < skip_share),
              "levels": {"y2": blk(1)[0], "y": blk(16), "u": blk(4),
                         "v": blk(4)}}
        if rng.random() < i4_share:
            mb["ymode"] = "B"
            mb["bmodes"] = rng.integers(0, 10, 16).tolist()
        else:
            mb["ymode"] = int(rng.integers(4))
        out.append(mb)
    return out



def _libwebp():
    """Pillow's bundled libwebp (the encoder and decoder the readers use)
    through ctypes."""
    import PIL
    libs = Path(PIL.__file__).resolve().parent.parent / "pillow.libs"
    ctypes.CDLL(str(next(libs.glob("libsharpyuv*"))), mode=ctypes.RTLD_GLOBAL)
    return ctypes.CDLL(str(next(libs.glob("libwebp-*"))))


class WebPConfig(ctypes.Structure):
    """libwebp's WebPConfig (encode.h)."""
    _fields_ = [(n, ctypes.c_float if n in ("quality", "target_PSNR")
                 else ctypes.c_int) for n in (
        "lossless quality method image_hint target_size target_PSNR segments "
        "sns_strength filter_strength filter_sharpness filter_type autofilter "
        "alpha_compression alpha_filtering alpha_quality pass show_compressed "
        "preprocessing partitions partition_limit emulate_jpeg_size "
        "thread_level low_memory near_lossless exact use_delta_palette "
        "use_sharp_yuv qmin qmax").split()]


class WebPPicture(ctypes.Structure):
    """libwebp's WebPPicture (encode.h)."""
    _p, _i, _u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    _fields_ = [("use_argb", _i), ("colorspace", _i), ("width", _i),
                ("height", _i), ("y", _p), ("u", _p), ("v", _p),
                ("y_stride", _i), ("uv_stride", _i), ("a", _p),
                ("a_stride", _i), ("pad1", _u * 2), ("argb", _p),
                ("argb_stride", _i), ("pad2", _u * 3), ("writer", _p),
                ("custom_ptr", _p), ("extra_info_type", _i),
                ("extra_info", _p), ("stats", _p), ("error_code", _i),
                ("progress_hook", _p), ("user_data", _p), ("pad3", _u * 3),
                ("pad4", _p), ("pad5", _p), ("pad6", _u * 8),
                ("memory_", _p), ("memory_argb_", _p), ("pad7", _p * 2)]


class WebPMemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32)]


ENCODER_ABI = 0x020f  # any 2.x: libwebp checks the major version alone


def libwebp_encode(img, quality=75.0, **options):
    """libwebp's WebPEncode of an RGB or RGBA image with WebPConfig's
    ``options`` (segments, filter_type, filter_sharpness, filter_strength,
    autofilter, partitions, alpha_compression, alpha_filtering,
    alpha_quality, ...) over its default preset: a lossy RIFF file."""
    lib = _libwebp()
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    cfg = WebPConfig()
    assert lib.WebPConfigInitInternal(ctypes.byref(cfg), 0,
                                      ctypes.c_float(quality), ENCODER_ABI)
    for k, v in options.items():
        setattr(cfg, k, v)
    assert lib.WebPValidateConfig(ctypes.byref(cfg)), options
    pic = WebPPicture()
    assert lib.WebPPictureInitInternal(ctypes.byref(pic), ENCODER_ABI)
    pic.width, pic.height = w, h
    importer = lib.WebPPictureImportRGBA if c == 4 else lib.WebPPictureImportRGB
    assert importer(ctypes.byref(pic), img.ctypes.data_as(ctypes.c_void_p),
                    w * c)
    mem = WebPMemoryWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(mem))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p)
    pic.custom_ptr = ctypes.cast(ctypes.byref(mem), ctypes.c_void_p)
    ok = lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic))
    out = ctypes.string_at(mem.mem, mem.size)
    lib.WebPPictureFree(ctypes.byref(pic))
    lib.WebPMemoryWriterClear(ctypes.byref(mem))
    assert ok, pic.error_code
    return out


def webp_lossy_cv2(img, quality):
    """cv2.imwrite's WebP of an RGB image at ``quality`` (<= 100: lossy)."""
    ok, enc = cv2.imencode(".webp", np.ascontiguousarray(img[:, :, ::-1]),
                           [cv2.IMWRITE_WEBP_QUALITY, quality])
    assert ok
    return enc.tobytes()


def webp_lossy_pil(img, **kw):
    """Pillow's WebP of ``img`` (RGB or RGBA) at its defaults (lossy)."""
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", **kw)
    return buf.getvalue()


def grain(rng, h, w, amp=10):
    """Gradients with grain of +-``amp`` and a flat box: content that uses
    every kind of macroblock."""
    y, x = np.mgrid[:h, :w]
    img = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                    (x * 3 + y * 5) % 256], -1)
    img = img + rng.integers(-amp, amp + 1, (h, w, 3))
    img[h // 4:h // 2, w // 3:w // 2] = rng.integers(0, 256, 3)
    return img.clip(0, 255).astype(np.uint8)


def with_alpha_header(data, byte):
    """``data`` (a RIFF file with an ALPH chunk) with the chunk's header
    byte set to ``byte``."""
    i = data.index(b"ALPH") + 8
    return data[:i] + bytes([byte]) + data[i + 1:]


def vp8_payload(data):
    return dict(webp_chunks(data))[b"VP8 "]


def webp_lossy_cases(rng):
    """{name: bytes} of the lossy WebP files cv2.imread reads: cv2's and
    Pillow's writers at odd sizes and qualities 5-100, libwebp's encoder
    with 1-4 segments, simple and normal filters, sharpness 0-7, filter
    strength 0 and 1, 2, 4 or 8 partitions, RGBA with ALPH methods 0 and
    1, filters 0-3 and pre-processing (one whose VP8X has no alpha flag:
    cv2 decodes the ALPH chunk, PIL does not), an animation's lossy first
    frame at an offset, EXIF orientations 2-8, trailing bytes, a raw VP8
    stream whose first partition ends inside 32 bytes, and frames the VP8
    writer makes with what libwebp's encoder never writes (loop-filter
    deltas, profile 3, the colour-space, clamping and scale bits, a
    segment map without segment data, 8 partitions, skip flags)."""
    riff = chip_smoke.webp_riff
    out = {}
    for (h, w), q in zip([(1, 1), (1, 37), (29, 1), (17, 33), (37, 51),
                          (24, 40)], (5, 25, 50, 75, 90, 100)):
        out[f"webp_lossy_cv2_{h}x{w}_q{q}.png"] = webp_lossy_cv2(
            grain(rng, h, w), q)
    out["webp_lossy_pil_rgb.jpg"] = webp_lossy_pil(grain(rng, 30, 44))
    rgba = np.concatenate([grain(rng, 26, 34), rng.integers(
        0, 256, (26, 34, 1)).astype(np.uint8)], 2)
    rgba[::4, :, 3] = 255
    out["webp_lossy_pil_rgba.png"] = webp_lossy_pil(rgba)
    img = grain(rng, 32, 48)
    for name, kw in (("segments_1", {"segments": 1}),
                     ("segments_2", {"segments": 2}),
                     ("segments_3", {"segments": 3}),
                     ("segments_4_sharp_7", {"segments": 4,
                                             "filter_sharpness": 7}),
                     ("simple_filter", {"filter_type": 0,
                                        "filter_strength": 70}),
                     ("simple_sharp_3", {"filter_type": 0,
                                         "filter_strength": 40,
                                         "filter_sharpness": 3}),
                     ("normal_sharp_5", {"filter_type": 1,
                                         "filter_strength": 90,
                                         "filter_sharpness": 5}),
                     ("filter_off", {"filter_strength": 0, "autofilter": 0}),
                     # (libwebp writes one partition where it buffers
                     # tokens: methods 1-6 without low_memory)
                     ("partitions_2", {"partitions": 1, "method": 0}),
                     ("partitions_4", {"partitions": 2, "low_memory": 1}),
                     ("partitions_8", {"partitions": 3, "method": 0,
                                       "segments": 4})):
        out[f"webp_lossy_enc_{name}.png"] = libwebp_encode(img, 60, **kw)
    alpha = np.concatenate([grain(rng, 20, 26), (rng.integers(
        0, 4, (20, 26, 1)) * 85).astype(np.uint8)], 2)
    for name, kw in (("raw", {"alpha_compression": 0}),
                     ("lossless", {"alpha_compression": 1,
                                   "alpha_filtering": 0}),
                     ("filter_fast", {"alpha_filtering": 1}),
                     ("filter_best", {"alpha_filtering": 2}),
                     ("levels", {"alpha_quality": 30})):
        out[f"webp_lossy_alpha_{name}.png"] = libwebp_encode(alpha, 70, **kw)
    base = libwebp_encode(alpha, 70, alpha_compression=0)
    for f in range(4):  # each filter bit pattern (the alpha is dropped)
        out[f"webp_lossy_alpha_filter_{f}.png"] = with_alpha_header(
            base, f << 2)
    chunks = dict(webp_chunks(base))
    out["webp_lossy_alpha_no_flag.png"] = riff([
        vp8x(26, 20, 0), (b"ALPH", chunks[b"ALPH"]), (b"VP8 ",
                                                      chunks[b"VP8 "])])
    frame = libwebp_encode(alpha, 50, alpha_compression=1)
    fch = dict(webp_chunks(frame))
    out["webp_lossy_anim_offset.png"] = riff([
        vp8x(40, 30, 0x12), (b"ANIM", bytes(6)),
        anmf(6, 4, 26, 20, [(b"ALPH", fch[b"ALPH"]), (b"VP8 ", fch[b"VP8 "])]),
        anmf(0, 0, 8, 8, [(b"VP8 ", vp8_payload(libwebp_encode(
            grain(rng, 8, 8), 50)))])])
    frames = [Image.fromarray(grain(rng, 12, 16)) for _ in range(2)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:])
    out["webp_lossy_anim_pil.jpg"] = buf.getvalue()
    still = vp8_payload(libwebp_encode(grain(rng, 14, 18), 60))
    for o in range(2, 9):
        out[f"webp_lossy_exif_{o}.png"] = riff([
            vp8x(18, 14, 0x08), (b"VP8 ", still),
            (b"EXIF", exif_tiff(o, big=o % 2 == 1))])
    out["webp_lossy_trailing_bytes.png"] = webp_lossy_cv2(
        grain(rng, 15, 21), 70) + bytes(9)
    flat = vp8_payload(libwebp_encode(np.full((64, 64, 3), (90, 140, 200),
                                              np.uint8), 75))
    assert (int.from_bytes(flat[:3], "little") >> 5) < 32 <= len(flat)
    out["webp_lossy_raw_vp8.png"] = flat
    wr = [("deltas", {"lf_delta": ((4, -3, 2, 1), (9, -4, 3, 2)),
                      "level": 24, "sharpness": 2}),
          ("deltas_simple", {"lf_delta": ((-6, 0, 0, 0), (12, 0, 0, 0)),
                             "simple": True, "level": 30}),
          ("profile_3", {"profile": 3, "level": 0}),
          ("header_bits", {"profile": 1, "colorspace": 1, "clamp": 1,
                           "scale": (2, 3)}),
          ("map_without_data", {"segments": {"update_map": True,
                                             "probs": (90, 160, 30)},
                                "seg": 4}),
          ("segment_data", {"segments": {
              "update_map": True, "probs": (120, 255, 60),
              "data": (False, (6, -12, 24, 40), (5, -8, 12, 30))},
              "seg": 4}),
          ("partitions_8", {"partitions": 3, "skip_prob": 90, "skip": 0.3}),
          ("quant_deltas", {"q": (20, 4, -6, 8, -9, 5), "level": 40,
                            "sharpness": 6})]
    for name, kw in wr:
        kw = dict(kw)
        mbs = vp8_random_mbs(rng, 40, 36, segments=kw.pop("seg", 1),
                             skip_share=kw.pop("skip", 0.0))
        out[f"webp_lossy_writer_{name}.png"] = riff([(b"VP8 ", vp8_bytes(
            40, 36, mbs, **kw))])
    return out


def webp_lossy_skip_cases(rng):
    """{name: bytes} of the lossy WebP files cv2.imread gives None for:
    those PIL reads (an ALPH chunk cv2's WebPDecode refuses in a VP8X
    without the alpha flag, which WebPDemux drops: a reserved bit, method
    3, pre-processing 2) and those both refuse: a raw VP8 stream under 32
    bytes, one whose first partition does not end inside 32 bytes, a
    cut file, a first partition or token partition cut short, an empty last
    partition, a partition length past the chunk, a non-key frame, a
    hidden frame, profile 4, a bad start code, a frame of another size
    than its canvas, ALPH damage in a frame both read (a reserved bit, a
    raw plane too short, a VP8L stream cut short or of a bad code)."""
    riff = chip_smoke.webp_riff
    out = {}
    alpha = np.concatenate([grain(rng, 20, 26), (rng.integers(
        0, 4, (20, 26, 1)) * 85).astype(np.uint8)], 2)
    base = libwebp_encode(alpha, 70, alpha_compression=0)
    ch = dict(webp_chunks(base))
    vp8, alph = ch[b"VP8 "], ch[b"ALPH"]
    for name, byte in (("reserved", 0x40), ("method_3", 0x03),
                       ("preprocessing_2", 0x20)):
        out[f"webp_lossy_alpha_{name}_no_flag.png"] = riff([
            vp8x(26, 20, 0), (b"ALPH", bytes([byte]) + alph[1:]),
            (b"VP8 ", vp8)])
        out[f"webp_lossy_alpha_{name}.png"] = riff([
            vp8x(26, 20, 0x10), (b"ALPH", bytes([byte]) + alph[1:]),
            (b"VP8 ", vp8)])
    out["webp_lossy_alpha_raw_short.png"] = riff([
        vp8x(26, 20, 0x10), (b"ALPH", alph[:-1]), (b"VP8 ", vp8)])
    lossless = chip_smoke.vp8l_bytes(np.stack([
        np.zeros((20, 26), np.uint8), alpha[..., 3], np.zeros(
            (20, 26), np.uint8)], -1))[5:]
    out["webp_lossy_alpha_vp8l_cut.png"] = riff([
        vp8x(26, 20, 0x10), (b"ALPH", b"\x01" + lossless[:len(lossless) // 2]),
        (b"VP8 ", vp8)])
    out["webp_lossy_alpha_vp8l_bad_code.png"] = riff([
        vp8x(26, 20, 0x10), (b"ALPH", b"\x01\xff\xff\xff\xff" + lossless),
        (b"VP8 ", vp8)])
    tiny = vp8_payload(libwebp_encode(np.full((8, 8, 3), 77, np.uint8), 75))
    assert len(tiny) < 32
    out["webp_lossy_raw_under_32_bytes.png"] = tiny
    big = vp8_payload(libwebp_encode(grain(rng, 48, 64), 75))
    assert int.from_bytes(big[:3], "little") >> 5 >= 32
    out["webp_lossy_raw_vp8_long_partition.png"] = big
    f = webp_lossy_cv2(grain(rng, 24, 30), 80)
    out["webp_lossy_cut.png"] = f[:len(f) * 3 // 4]
    body = vp8_payload(f)
    first = int.from_bytes(body[:3], "little") >> 5
    out["webp_lossy_first_partition_cut.png"] = riff([
        (b"VP8 ", body[:10 + first // 2])])
    out["webp_lossy_tokens_cut.png"] = riff([
        (b"VP8 ", body[:10 + first + (len(body) - 10 - first) // 3])])
    mbs = vp8_random_mbs(rng, 40, 36)
    out["webp_lossy_empty_last_partition.png"] = riff([(b"VP8 ", vp8_bytes(
        40, 36, mbs, partitions=2, empty_last=True))])
    tag = int.from_bytes(body[:3], "little")
    for name, new in (("partition_past_chunk", (tag & 31) | (len(body) << 5)),
                      ("inter_frame", tag | 1), ("hidden", tag & ~16),
                      ("profile_4", (tag & ~14) | (4 << 1))):
        out[f"webp_lossy_{name}.png"] = riff([
            (b"VP8 ", new.to_bytes(3, "little") + body[3:])])
    out["webp_lossy_start_code.png"] = riff([
        (b"VP8 ", body[:3] + b"\x9d\x01\x2b" + body[6:])])
    out["webp_lossy_canvas_other.png"] = riff([
        vp8x(31, 24, 0), (b"VP8 ", body)])
    return out
