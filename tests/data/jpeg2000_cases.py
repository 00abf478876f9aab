"""The JPEG 2000 cases of ``tests/data/jpeg2000/make_fixtures.py`` and of
``tests/test_torch_port_jpeg2000.py``, and the writers they are made with:

- cv2's writer (``cv2.imencode(".jp2")``: a JP2 file, LRCP, one layer, 5
  levels, 64 x 64 code-blocks, the reversible 5/3, lossy through its rate
  unless IMWRITE_JPEG2000_COMPRESSION_X1000 is 1000);
- Pillow's (``Image.save(..., "JPEG2000", ...)``: every option it has);
- OpenJPEG's own encoder, the libopenjp2 Pillow bundles, through ctypes
  (``opj_encode``: SOP and EPH markers, code-block styles, progression
  orders, layers, tiles, a region of interest), and its
  decoder (``opj_components``: the components before either reader
  converts them);
- byte edits of a codestream (``add_sop``, ``split_tile_parts``,
  ``insert_poc``, ``set_byte``, ``to_ppt``, ``to_ppm``,
  ``to_tile_headers``, ``reorder_poc``, ...).

Each ``*_cases`` function gives ``{name: bytes}`` from the seeded stream it
is handed: ``cases`` the files cv2.imread reads, ``skip_cases`` those it
gives None for (some of which PIL reads), ``part2_cases`` and
``part2_skip_cases`` the same for part 2's features (code-block styles,
POC, PPM and PPT, RGN), ``colour_cases`` and ``colour_skip_cases`` for
part 3's colour boxes, ``ht_cases`` and ``ht_skip_cases`` for part 4's
HTJ2K (written by ``tests/data/htj2k_encode.py``), ``mct_cases`` and
``mct_skip_cases`` for part 5's multi-component markers (CBD, MCT, MCC,
MCO), ``unsupported_cases`` files of the feature the port leaves out.
"""

import ctypes
import glob
import importlib.util
import io
import os
import random
import struct
import tempfile
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

# the JPEG 2000 writer phase 13 of chip_smoke.py runs on the card, and the
# POC packet order it shares with reorder_poc
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[2] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
# the HTJ2K writer of the part 4 cases
_spec = importlib.util.spec_from_file_location(
    "htj2k_encode", Path(__file__).resolve().parent / "htj2k_encode.py")
ht = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ht)

JPEG2000_SEED = 24  # the JPEG 2000 files draw from their own stream
BIG_SIZE = (480, 640)  # the file phase 13 of chip_smoke.py times


# ------------------------------------------------------------ the writers

def smooth(rng, h, w, amp=3):
    """A gradient with grain: what a lossy coder meets in a photograph."""
    y, x = np.mgrid[:h, :w]
    img = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                    (x + y) * 255 // max(h + w - 2, 1)], -1).astype(int)
    img += rng.integers(-amp, amp + 1, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def cv2_j2k(img, x1000=None):
    """cv2's JP2 of an RGB (or gray, or uint16) image."""
    arr = img[:, :, ::-1] if img.ndim == 3 and img.shape[2] >= 3 else img
    if arr.ndim == 3 and arr.shape[2] == 4:
        arr = img[:, :, [2, 1, 0, 3]]
    params = [] if x1000 is None else [
        cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, x1000]
    ok, enc = cv2.imencode(".jp2", np.ascontiguousarray(arr), params)
    assert ok
    return enc.tobytes()


def pil_j2k(img, mode=None, **kw):
    """Pillow's JPEG 2000 of ``img`` (converted to ``mode``)."""
    im = Image.fromarray(img)
    if mode is not None:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, "JPEG2000", **kw)
    return buf.getvalue()


def libopenjp2():
    """The libopenjp2 Pillow bundles (its Python module loaded first, so
    the library's own dependencies resolve)."""
    import PIL
    from PIL import _imaging  # noqa: F401
    libs = glob.glob(str(Path(PIL.__file__).resolve().parents[1]
                         / "pillow.libs" / "libopenjp2-*.so*"))
    assert libs, "Pillow bundles no libopenjp2"
    lib = ctypes.CDLL(libs[0])
    lib.opj_create_decompress.restype = ctypes.c_void_p
    lib.opj_create_compress.restype = ctypes.c_void_p
    lib.opj_stream_create_default_file_stream.restype = ctypes.c_void_p
    lib.opj_stream_create_default_file_stream.argtypes = [ctypes.c_char_p,
                                                          ctypes.c_int]
    for f in ("opj_setup_decoder", "opj_read_header", "opj_decode",
              "opj_setup_encoder", "opj_start_compress", "opj_encode",
              "opj_end_compress"):
        getattr(lib, f).restype = ctypes.c_int
    lib.opj_setup_decoder.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.opj_read_header.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.POINTER(_Image))]
    lib.opj_decode.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.POINTER(_Image)]
    lib.opj_image_create.restype = ctypes.POINTER(_Image)
    lib.opj_image_create.argtypes = [ctypes.c_uint32,
                                     ctypes.POINTER(_CompParam), ctypes.c_int]
    lib.opj_setup_encoder.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.POINTER(_Image)]
    lib.opj_start_compress.argtypes = [ctypes.c_void_p, ctypes.POINTER(_Image),
                                       ctypes.c_void_p]
    lib.opj_encode.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.opj_end_compress.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.opj_set_MCT.restype = ctypes.c_int
    lib.opj_set_MCT.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                ctypes.POINTER(ctypes.c_int32), ctypes.c_uint32]
    lib.opj_image_destroy.argtypes = [ctypes.POINTER(_Image)]
    lib.opj_stream_destroy.argtypes = [ctypes.c_void_p]
    lib.opj_destroy_codec.argtypes = [ctypes.c_void_p]
    lib.opj_set_default_decoder_parameters.argtypes = [ctypes.c_void_p]
    lib.opj_set_default_encoder_parameters.argtypes = [ctypes.c_void_p]
    return lib


class _Comp(ctypes.Structure):  # opj_image_comp_t
    _fields_ = [(n, ctypes.c_uint32) for n in (
        "dx dy w h x0 y0 prec bpp sgnd resno_decoded factor".split())] + [
        ("data", ctypes.POINTER(ctypes.c_int32)), ("alpha", ctypes.c_uint16)]


class _Image(ctypes.Structure):  # opj_image_t
    _fields_ = [(n, ctypes.c_uint32) for n in "x0 y0 x1 y1 numcomps".split()] \
        + [("color_space", ctypes.c_int), ("comps", ctypes.POINTER(_Comp)),
           ("icc", ctypes.c_void_p), ("icc_len", ctypes.c_uint32)]


class _CompParam(ctypes.Structure):  # opj_image_cmptparm_t
    _fields_ = [(n, ctypes.c_uint32) for n in "dx dy w h x0 y0 prec bpp sgnd"
                .split()]


# byte offsets into opj_cparameters_t (OpenJPEG 2.5, x86-64)
_CPARAM = dict(tile_size_on=0, cp_tdx=12, cp_disto_alloc=20, csty=48,
               prog_order=52, tcp_numlayers=4796, tcp_rates=4800,
               numresolution=5600, cblockw_init=5604, cblockh_init=5608,
               mode=5612, irreversible=5616, roi_compno=5620, roi_shift=5624)


def _temp(suffix):
    fd, path = tempfile.mkstemp(suffix=suffix)
    os.close(fd)
    return path


def opj_encode(img, numres=3, csty=0, mode=0, prog=0, irreversible=0,
               rates=(), cblk=None, tile=None, roi=None, mct=None):
    """OpenJPEG's raw codestream of a uint8 image (gray or RGB): csty 2
    writes SOP markers, 4 EPH markers; mode the code-block style; prog the
    progression order (0 LRCP ... 4 CPRL); rates one compression ratio a
    layer; tile (w, h) tiles; roi (component, shift) a max-shift region of
    interest over the whole component, written as an RGN marker in the
    main header; mct (matrix, DC shifts) opj_set_MCT's array-based
    transform (the 9/7, CBD, MCT, MCC and MCO markers, COD's MCT byte 2,
    which decoders refuse)."""
    lib = libopenjp2()
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, nc = img.shape
    parms = (_CompParam * nc)(*[_CompParam(1, 1, w, h, 0, 0, 8, 8, 0)
                                 for _ in range(nc)])
    im = lib.opj_image_create(nc, parms, 1 if nc >= 3 else 2)
    c = im.contents
    c.x0, c.y0, c.x1, c.y1 = 0, 0, w, h
    for k in range(nc):
        np.ctypeslib.as_array(c.comps[k].data, (h, w))[:] = img[:, :, k]
    p = ctypes.create_string_buffer(1 << 16)
    lib.opj_set_default_encoder_parameters(p)
    for name, v in (("csty", csty), ("mode", mode), ("prog_order", prog),
                    ("irreversible", irreversible),
                    ("numresolution", numres)):
        struct.pack_into("<i", p, _CPARAM[name], v)
    if cblk is not None:
        struct.pack_into("<ii", p, _CPARAM["cblockw_init"], *cblk)
    if rates:
        struct.pack_into("<i", p, _CPARAM["tcp_numlayers"], len(rates))
        struct.pack_into(f"<{len(rates)}f", p, _CPARAM["tcp_rates"], *rates)
        struct.pack_into("<i", p, _CPARAM["cp_disto_alloc"], 1)
    if tile is not None:
        struct.pack_into("<i", p, _CPARAM["tile_size_on"], 1)
        struct.pack_into("<ii", p, _CPARAM["cp_tdx"], *tile)
    if roi is not None:
        struct.pack_into("<ii", p, _CPARAM["roi_compno"], *roi)
    if mct is not None:
        matrix, shifts = mct
        assert lib.opj_set_MCT(p, (ctypes.c_float * (nc * nc))(*matrix),
                               (ctypes.c_int32 * nc)(*shifts), nc)
    codec = lib.opj_create_compress(0)
    path = _temp(".j2k")
    try:
        assert lib.opj_setup_encoder(codec, p, im)
        stream = lib.opj_stream_create_default_file_stream(path.encode(), 0)
        ok = (lib.opj_start_compress(codec, im, stream)
              and lib.opj_encode(codec, stream)
              and lib.opj_end_compress(codec, stream))
        lib.opj_stream_destroy(stream)
        assert ok
        return Path(path).read_bytes()
    finally:
        lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(im)
        os.unlink(path)


_MESSAGE = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_void_p)


def opj_components(data, messages=None):
    """What opj_decode gives for ``data`` (strict, OpenJPEG 2.5's default):
    ``(x0, y0, [int32 [h, w] per component])``, or None where it fails;
    OpenJPEG's error and warning messages appended to ``messages`` (a
    list) if one is given."""
    lib = libopenjp2()
    path = _temp(".jp2")
    Path(path).write_bytes(data)
    jp2 = data[:4] == b"\0\0\0\x0c"
    codec = lib.opj_create_decompress(2 if jp2 else 0)
    if messages is not None:
        handler = _MESSAGE(lambda m, _: messages.append(
            m.decode("latin-1").strip()))
        for f in ("opj_set_error_handler", "opj_set_warning_handler"):
            getattr(lib, f).argtypes = [ctypes.c_void_p, _MESSAGE,
                                        ctypes.c_void_p]
            getattr(lib, f)(codec, handler, None)
    p = ctypes.create_string_buffer(1 << 16)
    lib.opj_set_default_decoder_parameters(p)
    lib.opj_setup_decoder(codec, p)
    stream = lib.opj_stream_create_default_file_stream(path.encode(), 1)
    img = ctypes.POINTER(_Image)()
    try:
        if not (lib.opj_read_header(stream, codec, ctypes.byref(img))
                and lib.opj_decode(codec, stream, img)):
            return None
        c = img.contents
        return c.x0, c.y0, [
            np.ctypeslib.as_array(c.comps[k].data,
                                  (c.comps[k].h, c.comps[k].w)).copy()
            for k in range(c.numcomps)]
    finally:
        if img:
            lib.opj_image_destroy(img)
        lib.opj_stream_destroy(stream)
        lib.opj_destroy_codec(codec)
        os.unlink(path)


# ----------------------------------------------------------- byte edits

def codestream_at(data):
    """Where the codestream starts (SOC)."""
    return data.find(b"\xff\x4f\xff\x51")


def main_markers(data):
    """[(offset, marker, segment body)] of the main header."""
    p = codestream_at(data) + 2
    out = []
    while True:
        m, n = struct.unpack(">HH", data[p:p + 4])
        if m == 0xFF90:
            return out
        out.append((p, m, data[p + 4:p + 2 + n]))
        p += 2 + n


def parse(cs):
    """A raw codestream: (main header, [[Isot, TPsot, TNsot, [(marker,
    body)], data]], what follows the last tile-part)."""
    p = 2
    while struct.unpack(">H", cs[p:p + 2])[0] != 0xFF90:
        p += 2 + struct.unpack(">H", cs[p + 2:p + 4])[0]
    main, parts = cs[:p], []
    while cs[p:p + 2] == b"\xff\x90":
        isot, psot, tp, tn = struct.unpack(">HIBB", cs[p + 4:p + 12])
        end = p + psot if psot else len(cs) - 2
        q, marks = p + 12, []
        while cs[q:q + 2] != b"\xff\x93":
            m, n = struct.unpack(">HH", cs[q:q + 4])
            marks.append((m, cs[q + 4:q + 2 + n]))
            q += 2 + n
        parts.append([isot, tp, tn, marks, cs[q + 2:end]])
        p = end
    return main, parts, cs[p:]


def emit(main, parts, tail, psot_zero_last=False):
    out = bytearray(main)
    for i, (isot, tp, tn, marks, data) in enumerate(parts):
        body = b"".join(struct.pack(">HH", m, len(b) + 2) + b
                        for m, b in marks)
        psot = 0 if psot_zero_last and i == len(parts) - 1 else (
            14 + len(body) + len(data))
        out += struct.pack(">HHHIBB", 0xFF90, 10, isot, psot, tp, tn)
        out += body + b"\xff\x93" + data
    return bytes(out + tail)


def split_tile_parts(cs, rng, parts=3, tnsot=True, interleave=True,
                     psot_zero_last=False):
    """Each tile's data cut into up to ``parts`` tile-parts at random bytes
    (OpenJPEG joins them before it decodes), TNsot given or 0, the tiles'
    tile-parts interleaved, the last one's Psot 0 if asked."""
    main, old, tail = parse(cs)
    queues = {}
    for isot, _, _, marks, data in old:
        q = queues.setdefault(isot, [[], b""])
        q[0] += [m for m in marks if m[0] != 0xFF58]  # PLT is dropped
        q[1] += data
    pending = {}
    for t, (marks, data) in queues.items():
        k = min(parts, len(data))
        cuts = sorted(rng.choice(np.arange(1, len(data)), k - 1,
                                 replace=False).tolist()) if k > 1 else []
        pieces = [data[a:b] for a, b in zip([0] + cuts, cuts + [len(data)])]
        pending[t] = [[t, i, len(pieces) if tnsot else 0,
                       marks if i == 0 else [], pc]
                      for i, pc in enumerate(pieces)]
    out = []
    while any(pending.values()):
        ready = sorted(t for t in pending if pending[t])
        t = ready[int(rng.integers(len(ready)))] if interleave else ready[0]
        out.append(pending[t].pop(0))
    return emit(main, out, tail, psot_zero_last)


def add_sop(cs):
    """SOP markers before each packet (their lengths from the PLT markers
    Pillow's ``plt=True`` writes, which are dropped) and COD's SOP bit."""
    main, parts, tail = parse(cs)
    main = bytearray(main)
    at = main.find(b"\xff\x52")
    main[at + 4] |= 2
    n, new = 0, []
    for isot, tp, tn, marks, data in parts:
        lens, v = [], 0
        for m, b in marks:
            if m == 0xFF58:
                for x in b[1:]:
                    v = v << 7 | x & 0x7F
                    if not x & 0x80:
                        lens.append(v)
                        v = 0
        out, p = bytearray(), 0
        for length in lens:
            out += struct.pack(">HHH", 0xFF91, 4, n & 0xFFFF)
            out += data[p:p + length]
            p += length
            n += 1
        new.append([isot, tp, tn, [mb for mb in marks if mb[0] != 0xFF58],
                    bytes(out + data[p:])])
    return emit(bytes(main), new, tail)


def insert_main(data, marker, body):
    """A marker segment added to the main header, after COD."""
    p, body_cod = next((p, b) for p, m, b in main_markers(data)
                       if m == 0xFF52)
    at = p + 4 + len(body_cod)
    seg = struct.pack(">HH", marker, len(body) + 2) + body
    return data[:at] + seg + data[at:]


def cod_fields(data):
    """(Scod, progression, layers, MCT, levels, cblk w, cblk h, style,
    transform) of the main COD."""
    body = next(b for p, m, b in main_markers(data) if m == 0xFF52)
    return struct.unpack(">BBHBBBBBB", body[:10])


def poc_body(entries):
    """A POC marker's body of (RSpoc, CSpoc, LYEpoc, REpoc, CEpoc, Ppoc)
    entries (fewer than 257 components: one byte a component index)."""
    return b"".join(struct.pack(">BBHBBB", *e) for e in entries)


def insert_poc(data, entries):
    """A POC marker of ``entries`` in the main header."""
    return insert_main(data, 0xFF5F, poc_body(entries))


_SOT = b"\xff\x90\x00\x0a"  # ends a main header for main_markers


def to_tile_headers(cs, marker):
    """A raw codestream with the main header's ``marker`` segments copied
    into every tile's first tile-part header and dropped from the main
    header."""
    main, parts, tail = parse(cs)
    segs = [b for _, m, b in main_markers(main + _SOT) if m == marker]
    main = b"".join([main[:2]] + [
        struct.pack(">HH", m, len(b) + 2) + b
        for _, m, b in main_markers(main + _SOT) if m != marker])
    seen = set()
    for part in parts:
        if part[0] not in seen:
            seen.add(part[0])
            part[3] = part[3] + [(marker, b) for b in segs]
    return emit(main, parts, tail)


def packets(data):
    """The packets of a tile's data in a stream with SOP and EPH markers:
    [(SOP, header up to and with its EPH, body)] (FF 91 and FF 92 appear
    nowhere else: a header or code-block byte after 0xFF stays under
    0x90)."""
    starts = [i for i in range(len(data) - 1)
              if data[i] == 0xFF and data[i + 1] == 0x91]
    out = []
    for a, b in zip(starts, starts[1:] + [len(data)]):
        e = data.index(b"\xff\x92", a + 6) + 2
        out.append((data[a:a + 6], data[a + 6:e], data[e:b]))
    return out


def _headers_out(cs, sop=True):
    """(main header, parts, tail, [headers of each tile-part]): a SOP and
    EPH stream's packet headers (each with its EPH) taken out of the
    tile-part data, SOP markers kept or dropped with COD's SOP bit."""
    main, parts, tail = parse(cs)
    main = bytearray(main)
    if not sop:
        main[main.find(b"\xff\x52") + 4] &= ~2
    heads = []
    for part in parts:
        pk = packets(part[4])
        heads.append([h for _, h, _ in pk])
        part[4] = b"".join((s if sop else b"") + body for s, _, body in pk)
    return bytes(main), parts, tail, heads


def _chunks(data, size):
    return [data[i:i + size] for i in range(0, len(data), size)] or [b""]


def to_ppt(cs, size=65000, sop=True, order=None):
    """The packet headers of each tile-part (SOP and EPH stream) moved into
    PPT markers of at most ``size`` bytes in its header, Zppt counting on
    over a tile's tile-parts; ``order`` permutes where each tile-part's
    markers stand in its header (OpenJPEG reads them by Zppt)."""
    main, parts, tail, heads = _headers_out(cs, sop)
    z = {}
    for part, hs in zip(parts, heads):
        marks = []
        for chunk in _chunks(b"".join(hs), size):
            k = z.get(part[0], 0)
            z[part[0]] = k + 1
            marks.append((0xFF61, bytes([k]) + chunk))
        if order is not None:
            marks = [marks[i % len(marks)] for i in order(len(marks))]
        part[3] = part[3] + marks
    return emit(main, parts, tail)


def to_ppm(cs, size=65000, sop=True, nppm=None, split_nppm=False):
    """The packet headers of every tile-part (SOP and EPH stream) moved
    into PPM markers of the main header: Nppm then the headers, tile-part
    after tile-part, cut into markers of at most ``size`` bytes (the
    headers of an Nppm may run on into the next marker; an Nppm field
    itself only with ``split_nppm``, which OpenJPEG refuses); ``nppm``
    rewrites the counts (OpenJPEG joins the headers and drops them)."""
    main, parts, tail, heads = _headers_out(cs, sop)
    runs = [b"".join(hs) for hs in heads]
    counts = nppm(runs) if nppm else [len(r) for r in runs]
    body = b"".join(struct.pack(">I", n) + r for n, r in zip(counts, runs))
    fields, at = [], 0
    for r in runs:
        fields.append(at)
        at += 4 + len(r)
    chunks, at = [], 0
    while at < len(body):
        end = min(at + size, len(body))
        if not split_nppm:
            end = next((f for f in fields if at < f < end < f + 4), end)
        chunks.append(body[at:end])
        at = end
    main = main + _SOT
    for z, chunk in reversed(list(enumerate(chunks or [b""]))):
        main = insert_main(main, 0xFF60, bytes([z]) + chunk)
    return emit(main[:-len(_SOT)], parts, tail)


def reorder_poc(cs, entries, where="main"):
    """A raw LRCP codestream of one tile, one tile-part and one precinct a
    resolution, with SOP and EPH markers, given a POC of ``entries`` (in
    the main header or the tile-part header) and its packets moved into
    the order the POC reads them: packets no entry reaches are dropped."""
    scod, prog, layers, mct, levels, *_ = cod_fields(cs)
    ncomp = struct.unpack(">H", next(
        b for p, m, b in main_markers(cs) if m == 0xFF51)[34:36])[0]
    assert prog == 0
    main, parts, tail = parse(cs)
    assert len(parts) == 1
    pk = packets(parts[0][4])
    lrc = [(l, r, c) for l in range(layers) for r in range(levels + 1)
           for c in range(ncomp)]
    assert len(pk) == len(lrc)
    by = dict(zip(lrc, pk))
    parts[0][4] = b"".join(b"".join(by[k]) for k in chip_smoke.j2k_poc_order(
        entries, layers, levels, ncomp))
    if where == "tile":
        parts[0][3] = parts[0][3] + [(0xFF5F, poc_body(entries))]
        return emit(main, parts, tail)
    return emit(insert_poc(main + _SOT, entries)[:-len(_SOT)], parts, tail)


def set_byte(data, offset, value):
    out = bytearray(data)
    out[offset] = value
    return bytes(out)


def siz_component(data, comp):
    """The offset of a component's Ssiz byte."""
    return codestream_at(data) + 4 + 2 + 2 + 32 + 2 + 3 * comp


def with_box(data, box, after=b"jp2h"):
    """A JP2 file with ``box`` (its bytes) inside the jp2h box, last."""
    at = data.find(after) - 4
    n = struct.unpack(">I", data[at:at + 4])[0]
    head = data[:at] + struct.pack(">I", n + len(box)) + data[at + 4:at + n]
    return head + box + data[at + n:]


def box(kind, body):
    return struct.pack(">I4s", 8 + len(body), kind) + body


def set_colr(data, enumcs, meth=1):
    """The JP2 colr box's method and enumerated colour space."""
    at = data.find(b"colr") + 4
    out = bytearray(data)
    out[at] = meth
    out[at + 3:at + 7] = struct.pack(">I", enumcs)
    return bytes(out)


def with_colr(data, body):
    """A JP2 file with its colr box's body replaced by ``body``."""
    at = data.find(b"colr") - 4
    n = struct.unpack(">I", data[at:at + 4])[0]
    h = data.find(b"jp2h") - 4
    hn = struct.unpack(">I", data[h:h + 4])[0]
    new = box(b"colr", body)
    out = data[:at] + new + data[at + n:]
    return out[:h] + struct.pack(">I", hn - n + len(new)) + out[h + 4:]


def pclr_box(entries, bits=None, ne=None):
    """A pclr box of ``entries`` (rows of one value a palette column),
    ``bits`` each column's Bi as stored (its precision - 1, bit 7 the
    sign; 7 by default), each value written in the (precision + 7) // 8
    bytes (at most 4) OpenJPEG reads; ``ne`` the NE field (the row count by
    default)."""
    entries = [list(e) for e in entries]
    npc = len(entries[0]) if entries else len(bits)
    bits = [7] * npc if bits is None else list(bits)
    body = struct.pack(">HB", len(entries) if ne is None else ne, npc)
    body += bytes(bits)
    for row in entries:
        for b, v in zip(bits, row):
            body += int(v).to_bytes(min(((b & 0x7F) + 8) >> 3, 4), "big")
    return box(b"pclr", body)


def cmap_box(entries):
    """A cmap box of (CMP, MTYP, PCOL) entries."""
    return box(b"cmap", b"".join(struct.pack(">HBB", *e) for e in entries))


def cdef_box(entries):
    """A cdef box of (Cn, Typ, Asoc) entries."""
    return box(b"cdef", struct.pack(">H", len(entries)) + b"".join(
        struct.pack(">HHH", *e) for e in entries))


def with_precision(data, bits, signed=False):
    """Every component's Ssiz set to ``bits`` (and the sign), the samples
    left as coded."""
    at = codestream_at(data)
    n = struct.unpack(">H", data[at + 40:at + 42])[0]
    for c in range(n):
        data = set_byte(data, siz_component(data, c),
                        (0x80 if signed else 0) | (bits - 1))
    return data


def without_box(data, kind):
    """A JP2 file with a box inside jp2h dropped."""
    at = data.find(kind) - 4
    n = struct.unpack(">I", data[at:at + 4])[0]
    h = data.find(b"jp2h") - 4
    hn = struct.unpack(">I", data[h:h + 4])[0]
    out = data[:h] + struct.pack(">I", hn - n) + data[h + 4:at] + data[at + n:]
    return out


# --------------------------------------------------------------- the cases

def cases(rng):
    """The files cv2.imread reads: every writer option of part 1."""
    img = smooth(rng, 33, 41)  # cv2 writes 5 levels: 32 pixels or more a side
    out = {
        "j2k_cv2_default.jpg": cv2_j2k(img),
        "j2k_cv2_lossless.png": cv2_j2k(img, 1000),
        "j2k_cv2_x100.jpg": cv2_j2k(img, 100),
        "j2k_cv2_gray.png": cv2_j2k(img[:, :, 1]),
        "j2k_cv2_rgba.png": cv2_j2k(np.dstack([img, img[:, :, :1]])),
        "j2k_cv2_u16.png": cv2_j2k(img.astype(np.uint16) * 201),
        "j2k_cv2_gray_u16.png": cv2_j2k(img[:, :, 0].astype(np.uint16) * 257),
    }
    img = img[:19, :23]  # the other writers' files are smaller
    out.update({
        "j2k_pil_lossless.png": pil_j2k(img),
        "j2k_pil_97.jpg": pil_j2k(img, irreversible=True,
                                  quality_mode="rates", quality_layers=[12]),
        "j2k_pil_97_lossless_rate.jpg": pil_j2k(img, irreversible=True),
        "j2k_pil_rates_2_layers.jpg": pil_j2k(img, quality_mode="rates",
                                              quality_layers=[30, 8]),
        "j2k_pil_db_2_layers.jpg": pil_j2k(img, quality_mode="dB",
                                           quality_layers=[28, 40]),
        "j2k_pil_tiles_16.png": pil_j2k(img, tile_size=(16, 16)),
        "j2k_pil_tiles_97.jpg": pil_j2k(img, tile_size=(20, 12),
                                        tile_offset=(0, 0), irreversible=True,
                                        quality_mode="rates",
                                        quality_layers=[10]),
        "j2k_pil_cblk_8x32.png": pil_j2k(img, codeblock_size=(8, 32)),
        "j2k_pil_cblk_4x4.png": pil_j2k(img, codeblock_size=(4, 4)),
        "j2k_pil_cblk_64x4.jpg": pil_j2k(img, codeblock_size=(64, 4),
                                         irreversible=True),
        "j2k_pil_mct_1.png": pil_j2k(img, mct=1),
        "j2k_pil_plt_comment.png": pil_j2k(img, plt=True, comment="a comment"),
        "j2k_pil_gray.png": pil_j2k(img, "L"),
        "j2k_pil_la.png": pil_j2k(img, "LA"),
        "j2k_pil_rgba.png": pil_j2k(img, "RGBA"),
        "j2k_pil_raw.jpg": pil_j2k(img, no_jp2=True),
        "j2k_pil_i16.png": pil_j2k(img[:, :, 0].astype(np.uint16) * 257 + 3,
                                   "I;16"),
        "j2k_pil_1x1.png": pil_j2k(img[:1, :1]),
        "j2k_pil_1x13.png": pil_j2k(img[:1, :13], num_resolutions=1),
        "j2k_pil_13x1.jpg": pil_j2k(img[:13, :1], irreversible=True),
        "j2k_pil_5x3_97.jpg": pil_j2k(img[:5, :3], irreversible=True,
                                      num_resolutions=2),
    })
    for order in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
        out[f"j2k_pil_{order.lower()}_precincts_16.png"] = pil_j2k(
            img, mct=1, progression=order, precinct_size=(16, 16),
            num_resolutions=3, quality_mode="rates", quality_layers=[20, 4])
    out["j2k_pil_precincts_32x8.jpg"] = pil_j2k(
        img, progression="RPCL", precinct_size=(32, 8), num_resolutions=3,
        irreversible=True)
    raw = pil_j2k(img, no_jp2=True, plt=True, tile_size=(12, 8),
                  quality_mode="rates", quality_layers=[10, 3])
    out["j2k_sop_from_plt.png"] = add_sop(raw)
    out["j2k_tile_parts.png"] = split_tile_parts(raw, rng)
    out["j2k_tile_parts_tnsot_0.png"] = split_tile_parts(raw, rng, tnsot=False)
    out["j2k_tile_parts_psot_0.png"] = split_tile_parts(
        raw, rng, interleave=False, psot_zero_last=True)
    out["j2k_opj_sop_eph.png"] = opj_encode(img, csty=6, prog=1,
                                            rates=(20, 4))
    out["j2k_opj_eph_97.jpg"] = opj_encode(img, csty=4, prog=3, irreversible=1,
                                           numres=4)
    out["j2k_opj_sop_cprl.png"] = opj_encode(img, csty=2, prog=4,
                                             cblk=(16, 8))
    lossless = out["j2k_pil_lossless.png"]
    out["j2k_precision_12.png"] = set_byte(
        set_byte(set_byte(lossless, siz_component(lossless, 0), 11),
                 siz_component(lossless, 1), 11), siz_component(lossless, 2), 11)
    out["j2k_levels_9.png"] = set_byte(
        lossless, next(p for p, m, b in main_markers(lossless)
                       if m == 0xFF52) + 4 + 5, 9)
    out["j2k_trailing_bytes.jpg"] = out["j2k_cv2_default.jpg"] + b"\0" * 9
    # a gray 9/7 file in generate_tree buckets no other format's file
    # brings (phase 13 holds B2 and B3 there)
    wide = smooth(rng, 70, 200, amp=2)[:, :, 1]
    out["j2k_pil_gray_97_70x200.jpg"] = pil_j2k(
        wide, irreversible=True, quality_mode="rates", quality_layers=[25])
    out["j2k_no_colr_rgb.png"] = without_box(out["j2k_pil_lossless.png"],
                                             b"colr")
    return out


def skip_cases(rng):
    """The files cv2.imread gives None for: those PIL reads (an image
    offset, a raw codestream of 1 or 2 components, precisions under 8,
    signed samples, a gray JP2 without its colr box) and the damaged
    files both refuse."""
    img = smooth(rng, 15, 19)
    lossless = pil_j2k(img)
    lossy = pil_j2k(img, irreversible=True, quality_mode="rates",
                    quality_layers=[8])
    out = {
        "j2k_offset_tiles.png": pil_j2k(img, offset=(5, 7), tile_size=(8, 8)),
        "j2k_offset.jpg": pil_j2k(img, offset=(3, 1), tile_size=(30, 20),
                                  irreversible=True),
        "j2k_raw_gray.png": pil_j2k(img, "L", no_jp2=True),
        "j2k_raw_la.png": pil_j2k(img, "LA", no_jp2=True),
        "j2k_raw_i16.png": pil_j2k(img[:, :, 0].astype(np.uint16) * 300,
                                   "I;16", no_jp2=True),
        "j2k_signed.png": pil_j2k(img, signed=True),
        "j2k_no_colr_gray.png": without_box(pil_j2k(img, "L"), b"colr"),
        "j2k_cut_half.jpg": lossy[:len(lossy) // 2],
        "j2k_cut_2.jpg": lossy[:-2],
        "j2k_cut_40.jpg": lossy[:-40],
        "j2k_eph_flag_without_markers.png": set_byte(
            lossless, next(p for p, m, b in main_markers(lossless)
                           if m == 0xFF52) + 4, 4),
        "j2k_ihdr_height.png": set_byte(lossless, lossless.find(b"ihdr") + 7,
                                        22),
        "j2k_tile_part_index.png": _wrong_tile_part(pil_j2k(img, no_jp2=True)),
    }
    for bits in (1, 4, 7):
        data = lossless
        for c in range(3):
            data = set_byte(data, siz_component(data, c), bits - 1)
        out[f"j2k_precision_{bits}.png"] = data
    return out


def _wrong_tile_part(cs):
    """A tile-part whose TPsot is 1 where 0 is due."""
    main, parts, tail = parse(cs)
    parts[0][1] = 1
    parts[0][2] = 2
    return emit(main, parts, tail)


def _entries(layers, levels, ncomp):
    """Three POC entries that change the order and cover every packet:
    resolution 0 of every layer (RLCP), layer 0 of the rest by component
    (CPRL), then what remains (LRCP)."""
    return [(0, 0, layers, 1, ncomp, 1), (1, 0, 1, levels + 1, ncomp, 4),
            (0, 0, layers, levels + 1, ncomp, 0)]


def part2_cases(rng):
    """Part 2's files cv2.imread reads: code-block styles alone and
    together over layers, POC in the main and a tile-part header (several
    entries, packets no entry reaches), PPM over tile-parts and markers,
    PPT over tiles, RGN in the main and tile-part headers, and a 9/7 file
    of every part 2 feature in a generate_tree bucket no other fixture
    brings."""
    img = smooth(rng, 19, 23)
    out = {
        "j2k2_style_63_97_3_layers.jpg": opj_encode(
            img, mode=63, irreversible=1, rates=(40, 20, 10)),
        "j2k2_style_5_2_layers.png": opj_encode(img, mode=5, rates=(20, 5)),
        "j2k2_bypass_sop_eph_3_layers.png": opj_encode(
            img, mode=1, csty=6, rates=(30, 10, 3), numres=2),
        "j2k2_termall_97_3_layers.jpg": opj_encode(
            img, mode=4, irreversible=1, rates=(30, 10, 3)),
        "j2k2_reset_vsc_segsym.png": opj_encode(img, mode=42, cblk=(8, 8)),
        "j2k2_pterm_cprl.png": opj_encode(img, mode=16, prog=4,
                                          rates=(12, 4)),
    }
    sop = opj_encode(img, csty=6, rates=(30, 10, 3))
    out["j2k2_poc_main_3_entries.png"] = reorder_poc(sop, _entries(3, 2, 3))
    out["j2k2_poc_tile_uncovered.png"] = reorder_poc(
        sop, [(0, 0, 3, 2, 3, 1), (0, 1, 3, 2, 3, 4)], "tile")
    lossy = opj_encode(img, csty=6, irreversible=1, rates=(30, 10, 3))
    out["j2k2_poc_tile_97.jpg"] = reorder_poc(lossy, _entries(3, 2, 3),
                                              "tile")
    tiled = opj_encode(img, csty=6, rates=(20, 6), tile=(12, 8))
    out["j2k2_ppm_tile_parts.png"] = split_tile_parts(
        to_ppm(tiled, size=60), rng, interleave=False)
    out["j2k2_ppt_tiles_97.jpg"] = to_ppt(
        opj_encode(img, csty=6, irreversible=1, rates=(25,), tile=(16, 12),
                   mode=63), size=24, order=lambda n: range(n - 1, -1, -1))
    out["j2k2_ppt_no_sop.png"] = to_ppt(sop, sop=False)
    out["j2k2_rgn_roi.png"] = opj_encode(img, roi=(0, 5))
    out["j2k2_rgn_tiles_97.jpg"] = to_tile_headers(opj_encode(
        img, roi=(2, 3), irreversible=1, tile=(16, 8), rates=(15,)), 0xFF5E)
    wide = smooth(rng, 70, 100, amp=1)
    big = opj_encode(wide, csty=6, mode=63, irreversible=1, rates=(60, 30, 20),
                     numres=3)
    out["j2k2_all_features_70x100.jpg"] = to_ppt(
        reorder_poc(big, _entries(3, 2, 3), "tile"), size=200)
    return out


def part2_skip_cases(rng):
    """Part 2's files cv2.imread gives None for: raw gray codestreams of
    its features, which PIL reads, and damaged ones both readers refuse (a
    PPT beside a PPM, a Zppt or Zppm twice, an Nppm past its headers, 32
    POC entries, a POC of a broken length, an RGN shift past 30 bit-planes
    or of a component past the last, an Nppm field cut across two PPM
    markers)."""
    img = smooth(rng, 15, 19)
    gray = img[:, :, 1]
    sop = opj_encode(img, csty=6, rates=(20, 5))
    ppt = to_ppt(sop, size=30)
    main, parts, tail = parse(ppt)
    twice = [list(p) for p in parts]
    twice[0][3] = twice[0][3] + [twice[0][3][-1]]
    entries = [(0, 0, 2, 3, 3, 0)] * 32
    out = {
        "j2k2_raw_gray_style_63.png": opj_encode(gray, mode=63, rates=(8, 2)),
        "j2k2_raw_gray_poc_uncovered.png": reorder_poc(
            opj_encode(gray, csty=6, rates=(8, 2)), [(0, 0, 2, 2, 1, 1)]),
        "j2k2_raw_gray_ppm_rgn.png": to_ppm(
            opj_encode(gray, csty=6, roi=(0, 4), rates=(6,)), size=20),
        "j2k2_ppt_beside_ppm.png": insert_main(ppt, 0xFF60,
                                               b"\0\0\0\0\0"),
        "j2k2_zppt_twice.png": emit(main, twice, tail),
        "j2k2_zppm_twice.png": insert_main(to_ppm(sop), 0xFF60,
                                           b"\0\0\0\0\0"),
        "j2k2_nppm_past_headers.png": to_ppm(
            sop, nppm=lambda runs: [len(runs[0]) + 7]),
        "j2k2_nppm_across_markers.png": to_ppm(
            opj_encode(img, csty=6, tile=(8, 8), rates=(10,)), size=23,
            split_nppm=True),
        "j2k2_poc_32_entries.png": insert_poc(sop, entries),
        "j2k2_poc_length.png": insert_main(sop, 0xFF5F,
                                           poc_body(entries[:1]) + b"\0"),
        "j2k2_rgn_shift_31.png": insert_main(sop, 0xFF5E, b"\0\0\x1f"),
        "j2k2_rgn_component_3.png": insert_main(sop, 0xFF5E, b"\3\0\2"),
    }
    return out


def colour_cases(rng):
    """Part 3's files cv2.imread reads: the colour boxes. sYCC (9/7, and
    12-bit samples, which cv2 shifts to 8 bits before its YUV matrix), an
    ICC profile and CIELab (taken for sRGB), a gray colr on 3 components,
    cdef boxes that move channels (reversed; comp 0 an opacity channel,
    which OpenJPEG's swap loop leaves last), a pclr box without its cmap
    (dropped), palettes with their cmap (indices past NE clamped, MTYP 0
    and 1 mixed, a gray colr that copies palette column 0), and a 10 x 180
    palette image in a generate_tree bucket no other fixture brings."""
    img = smooth(rng, 9, 11, amp=1)
    gray = pil_j2k(img, "L")
    ramp = np.tile(np.arange(11, dtype=np.uint8) * 23, (9, 1))
    index = pil_j2k(ramp, "L")
    pal = [(k * 17 % 256, 255 - k * 9, k * 61 % 256) for k in range(9)]
    out = {
        "j2k3_sycc_97.jpg": set_colr(pil_j2k(img, irreversible=True), 18),
        "j2k3_sycc_12bit.png": set_colr(with_precision(pil_j2k(img), 12),
                                        18),
        "j2k3_icc.png": with_colr(pil_j2k(img), b"\x02\0\0" + bytes(40)),
        "j2k3_cielab_35.png": with_colr(pil_j2k(img), b"\x01\0\0\0\0\0\x0e"
                                        + bytes(28)),
        "j2k3_gray_colr_rgb.png": set_colr(pil_j2k(img), 17),
        "j2k3_cdef_reverse.png": with_box(pil_j2k(img), cdef_box(
            [(0, 0, 3), (1, 0, 2), (2, 0, 1)])),
        "j2k3_cdef_alpha_first.png": with_box(pil_j2k(img), cdef_box(
            [(0, 1, 0), (1, 0, 1), (2, 0, 2)])),
        "j2k3_pclr_no_cmap_gray.png": with_box(gray, pclr_box(pal)),
        "j2k3_cmap_gray.png": with_box(with_box(index, pclr_box(pal)),
                                       cmap_box([(0, 1, i) for i in range(3)])),
        "j2k3_cmap_mixed_mtyp.png": with_box(with_box(
            set_colr(index, 16), pclr_box(pal, bits=[3, 7, 7])),
            cmap_box([(0, 0, 0), (0, 1, 1), (0, 1, 2)])),
    }
    wide = np.tile(np.arange(180, dtype=np.uint8) // 12, (10, 1))
    out["j2k3_pclr_10x180.png"] = with_box(with_box(
        set_colr(pil_j2k(wide, "L"), 16), pclr_box(pal[:5] * 4)),
        cmap_box([(0, 1, i) for i in range(3)]))
    return out


def colour_skip_cases(rng):
    """Part 3's files cv2.imread gives None for: CMYK, a pclr box without
    its cmap under sRGB (cv2 finds one component; PIL reads mode P through
    its own palette), sYCC with an image offset (PIL's sYCC conversion);
    and boxes both readers refuse: a pclr of no entries, a cmap past the
    palette's columns."""
    img = smooth(rng, 9, 11, amp=1)
    gray = pil_j2k(img, "L")
    pal = [(k * 29 % 256, k * 7, 255 - k * 13) for k in range(12)]
    return {
        "j2k3_cmyk.png": set_colr(pil_j2k(np.dstack(
            [img, img[:, :, :1]]), "RGBA"), 12),
        "j2k3_pclr_no_cmap_srgb.png": with_box(set_colr(gray, 16),
                                               pclr_box(pal)),
        "j2k3_sycc_offset.jpg": set_colr(pil_j2k(
            img, offset=(3, 1), tile_size=(20, 20), irreversible=True), 18),
        "j2k3_pclr_ne_0.png": with_box(gray, pclr_box([], bits=[7] * 3)),
        "j2k3_cmap_past_palette.png": with_box(with_box(gray, pclr_box(pal)),
                                               cmap_box([(0, 1, 0), (0, 1, 1),
                                                         (0, 1, 3)])),
    }


# Part 2's multi-component markers: CBD of 3 components of depth 8 each
# (the file's own), MCO of no stage
CBD_BODY = b"\x00\x03\x07\x07\x07"
MCO_BODY = b"\x00"
CBD, MCT, MCC, MCO = 0xFF78, 0xFF74, 0xFF75, 0xFF77
ELEMENTS = {"int16": (0, ">h"), "int32": (1, ">i"), "float32": (2, ">f"),
            "float64": (3, ">d")}  # an MCT array's element types


def cbd_body(depths, signed=False, count=None):
    """A CBD marker's body: Ncbd (the depths' count unless ``count``),
    then each component's depth - 1, bit 7 the sign."""
    return struct.pack(">H", len(depths) if count is None else count) + bytes(
        (0x80 if signed else 0) | (d - 1) for d in depths)


def mct_body(index, values, element="int16", array=2, zmct=0, ymct=0):
    """An MCT marker's body: Zmct, Imct (``index``, the array type: 1
    decorrelation, 2 offset; the element type), Ymct, ``values`` packed as
    ``element`` (or raw bytes)."""
    code, fmt = ELEMENTS[element]
    data = values if isinstance(values, bytes) else b"".join(
        struct.pack(fmt, v) for v in values)
    return struct.pack(">HHH", zmct, index | array << 8 | code << 10,
                       ymct) + data


def mcc_body(index, ncomp, deco=0, offset=0, zmcc=0, ymcc=0, collections=1,
             xmcc=1, wide=False, order=None, wcount=None, extra=b""):
    """An MCC marker's body of one array-based collection over components
    0 .. ncomp - 1 (``order`` other indices, ``wcount`` another output
    count, ``wide`` 2-byte indices), Tmcc naming the decorrelation and
    offset arrays (0: none), ``extra`` bytes after it; ``collections`` is
    Qmcc as written (0 writes no collection)."""
    body = struct.pack(">HBHH", zmcc, index, ymcc, collections)
    if collections == 0:
        return body + extra
    order = list(range(ncomp)) if order is None else list(order)
    wcount = ncomp if wcount is None else wcount
    flag, fmt = (0x8000, ">H") if wide else (0, ">B")
    body += struct.pack(">BH", xmcc, flag | ncomp) + b"".join(
        struct.pack(fmt, i) for i in order)
    body += struct.pack(">H", flag | wcount) + b"".join(
        struct.pack(fmt, i) for i in range(wcount))
    return body + (deco | offset << 8 | 1 << 16).to_bytes(3, "big") + extra


def mco_body(*stages):
    """An MCO marker's body: the stage count, then each stage's MCC
    index."""
    return bytes([len(stages)]) + bytes(stages)


def with_segments(data, segments):
    """``segments`` ([(marker, body)]) added to the main header after COD,
    in their order."""
    for marker, body in reversed(segments):
        data = insert_main(data, marker, body)
    return data


def in_tile_part(cs, tile, segments):
    """A raw codestream with ``segments`` ([(marker, body)]) added to the
    first tile-part header of tile ``tile``."""
    main, parts, tail = parse(cs)
    part = next(p for p in parts if p[0] == tile)
    part[3] = part[3] + list(segments)
    return emit(main, parts, tail)


def subsampled(data, comp=1):
    """A file whose component ``comp`` is sub-sampled 2 x horizontally in
    SIZ (the data left as coded)."""
    return set_byte(data, siz_component(data, comp) + 1, 2)


def unsupported_cases(rng):
    """{name: (bytes, feature)}: valid files of the feature the port
    leaves out, each of which raises naming JPEG 2000: sub-sampled
    components in a raw codestream and in a JP2 file with an sYCC colr
    (8d)."""
    img = smooth(rng, 21, 26)
    jp2 = pil_j2k(img)
    raw = pil_j2k(img, no_jp2=True)
    return {"subsampled.png": (subsampled(raw), "sub-sampled components"),
            "subsampled_sycc.png": (set_colr(subsampled(jp2), 18),
                                    "sub-sampled components")}


def _offsets(base, element, values, ncomp=3):
    """``base`` with an offset array of ``values`` (index 1), a collection
    of every component naming it (index 2) and an MCO of that stage."""
    return with_segments(base, [(MCT, mct_body(1, values, element)),
                                (MCC, mcc_body(2, ncomp, offset=1)),
                                (MCO, mco_body(2))])


def _matrix(base, diagonal):
    """``base`` with a float32 decorrelation matrix of ``diagonal``
    (index 1), int16 offsets of 128 (index 2), their collection (index
    3) and an MCO of it."""
    m = [diagonal[i] if i == j else 0.0 for i in range(3) for j in range(3)]
    return with_segments(base, [
        (MCT, mct_body(1, m, "float32", array=1)),
        (MCT, mct_body(2, [128] * 3)), (MCC, mcc_body(3, 3, 1, 2)),
        (MCO, mco_body(3))])


def _warned(base, **kw):
    """``base`` with int16 offsets (index 1), an MCC of index 2 that
    OpenJPEG only warns about (``kw`` to mcc_body) and an MCO naming it:
    the collection is not kept, so the stage zeroes the DC level shift."""
    return with_segments(base, [(MCT, mct_body(1, [3, 4, 5])),
                                (MCC, mcc_body(2, 3, offset=1, **kw)),
                                (MCO, mco_body(2))])


def mct_cases(rng):
    """Part 2's multi-component files cv2.imread reads: MCO stages over
    offset arrays of each element type (int16, read unsigned; int32;
    float32 and float64, truncated) in raw codestreams and JP2 files, 5/3
    and 9/7; an MCO of no stage, of two stages (ignored), of an unknown
    stage; each MCC OpenJPEG only warns about, an MCC over 2 of 3
    components, an MCT of Zmct 1; identity and diag(2, 1, 1) matrices
    (never applied); a tiled file with an MCO in one tile's tile-part
    header and one whose tiles name the main header's collection; CBD at
    depths 8, 12 (on the 9/7, whose steps it scales) and 16; OpenJPEG's
    own opj_set_MCT output with COD's MCT byte set to 1 and to 0; and a
    100 x 14 file in generate_tree buckets no other fixture brings."""
    img = smooth(rng, 17, 21, amp=6)
    raw = pil_j2k(img, no_jp2=True)
    raw97 = pil_j2k(img, no_jp2=True, irreversible=True)
    jp2 = pil_j2k(img)
    jp2_97 = pil_j2k(img, irreversible=True)
    small = pil_j2k(img[:9, :11], no_jp2=True)
    tiled = pil_j2k(img, no_jp2=True, tile_size=(12, 12))
    out = {
        "j2k5_mco_no_stage.png": with_segments(raw, [(MCO, mco_body())]),
        "j2k5_jp2_mco_no_stage_97.jpg": with_segments(jp2_97,
                                                      [(MCO, mco_body())]),
        "j2k5_offsets_int16.png": _offsets(raw, "int16", [5, 6, 7]),
        "j2k5_offsets_int16_negative.png": _offsets(raw, "int16",
                                                    [-5, 120, 0]),
        "j2k5_offsets_int32_jp2.png": _offsets(jp2, "int32", [140, -3, 100]),
        "j2k5_offsets_float32_97.jpg": _offsets(raw97, "float32",
                                                [10.5, -20.25, 30.0]),
        "j2k5_offsets_float64_jp2_97.jpg": _offsets(jp2_97, "float64",
                                                    [127.9, 128.5, -0.75]),
        "j2k5_mco_two_stages.png": with_segments(raw, [
            (MCO, mco_body(1, 2))]),
        "j2k5_mco_unknown_stage.png": with_segments(raw, [
            (MCT, mct_body(1, [5, 6, 7])), (MCC, mcc_body(2, 3, offset=1)),
            (MCO, mco_body(9))]),
        "j2k5_mcc_zmcc.png": _warned(small, zmcc=1),
        "j2k5_mcc_ymcc.png": _warned(small, ymcc=1),
        "j2k5_mcc_two_collections.png": _warned(small, collections=2),
        "j2k5_mcc_xmcc_0.png": _warned(small, xmcc=0),
        "j2k5_mcc_counts_differ.png": _warned(small, wcount=2),
        "j2k5_mcc_shuffled.png": _warned(small, order=[0, 2, 1]),
        "j2k5_mcc_2_of_3.png": with_segments(small, [
            (MCT, mct_body(1, [3, 4])), (MCC, mcc_body(2, 2, offset=1)),
            (MCO, mco_body(2))]),
        "j2k5_mct_zmct_then_mco.png": with_segments(small, [
            (MCT, mct_body(1, [3, 4, 5], zmct=1)), (MCO, mco_body())]),
        "j2k5_matrix_identity.png": _matrix(small, (1.0, 1.0, 1.0)),
        "j2k5_matrix_diag_2_1_1.png": _matrix(small, (2.0, 1.0, 1.0)),
        "j2k5_tile_part_mco.png": in_tile_part(tiled, 0,
                                               [(MCO, mco_body())]),
        "j2k5_tiles_name_main_collection.png": in_tile_part(
            in_tile_part(with_segments(tiled, [
                (MCT, mct_body(1, [100, 110, 120], "int32")),
                (MCC, mcc_body(2, 3, offset=1))]), 1, [(MCO, mco_body(2))]),
            3, [(MCT, mct_body(1, [60, 70, 80])), (MCO, mco_body(2))]),
        "j2k5_cbd_8.png": with_segments(raw, [(CBD, cbd_body([8] * 3))]),
        "j2k5_cbd_12_97.jpg": with_segments(raw97,
                                            [(CBD, cbd_body([12] * 3))]),
        "j2k5_cbd_16_jp2.png": with_segments(jp2, [(CBD, cbd_body([16] * 3))]),
    }
    mct = ([1, 0, 0, 0, 1, 0, 0, 0, 1], [128, 128, 128])
    opj = opj_encode(img, mct=mct)
    cod = next(p for p, m, b in main_markers(opj) if m == 0xFF52) + 8
    out["j2k5_opj_set_mct_1.jpg"] = set_byte(opj, cod, 1)
    out["j2k5_opj_set_mct_0.jpg"] = set_byte(opj, cod, 0)
    tall = smooth(rng, 100, 14, amp=4)
    out["j2k5_100x14_offsets_97.jpg"] = _offsets(
        pil_j2k(tall, irreversible=True, quality_mode="rates",
                quality_layers=[8]), "float64", [120.25, 140.0, 128.0])
    return out


def mct_skip_cases(rng):
    """Part 2's multi-component files cv2.imread gives None for: a CBD of
    depth 6 and a signed CBD, and a raw gray codestream with an offset
    array, which PIL reads; files both readers refuse: a CBD of the wrong
    count, an MCC naming an array no MCT holds, a decorrelation matrix and
    an offset array of the wrong size."""
    img = smooth(rng, 11, 13, amp=6)
    raw = pil_j2k(img, no_jp2=True)
    return {
        "j2k5_cbd_6.png": with_segments(raw, [(CBD, cbd_body([6] * 3))]),
        "j2k5_cbd_signed.png": with_segments(raw, [
            (CBD, cbd_body([8] * 3, signed=True))]),
        "j2k5_raw_gray_offsets.png": _offsets(
            pil_j2k(img[:, :, 1], no_jp2=True), "int16", [90], ncomp=1),
        "j2k5_cbd_count.png": with_segments(raw, [
            (CBD, cbd_body([8] * 3, count=2))]),
        "j2k5_mcc_missing_array.png": with_segments(raw, [
            (MCT, mct_body(1, [3, 4, 5])), (MCC, mcc_body(2, 3, offset=4)),
            (MCO, mco_body(2))]),
        "j2k5_matrix_size.png": with_segments(raw, [
            (MCT, mct_body(1, [1.0] * 8, "float32", array=1)),
            (MCC, mcc_body(2, 3, deco=1)), (MCO, mco_body(2))]),
        "j2k5_offset_size.png": _offsets(raw, "int32", [1, 2]),
    }


HT_BIG_STEP = 1.0  # the 9/7 step of the 640 x 480 HTJ2K file


def ht_big():
    """The 640 x 480 HTJ2K file phase 13 of chip_smoke.py times: JPEG2000_
    BIG's source (chip_smoke.j2k_source) in a JP2 file, the 9/7 of 5 levels
    and step HT_BIG_STEP, the ICT, 64 x 64 code-blocks, CAP."""
    return ht.encode(chip_smoke.j2k_source(), levels=5, reversible=False,
                     step=HT_BIG_STEP, cblk=(64, 64), jp2=True)


def with_scup(data, scup):
    """A code-block's cleanup segment with its Scup field set."""
    d = bytearray(data)
    d[-1] = (scup >> 4) & 0xFF
    d[-2] = (d[-2] & 0xF0) | (scup & 0xF)
    return bytes(d)


def ht_cases(rng):
    """Part 4's files cv2.imread reads: HTJ2K of the test encoder (5/3 and
    RCT, 9/7 and ICT, gray of 12 bits, code-blocks of 64 x 64, 16 x 64 and
    4 x 1024, tiles and 3 layers in RPCL and CPRL, SOP and EPH, the raw
    codestream and JP2 with a cdef box, SigProp and MagRef passes of random
    bytes under VSC), CAP and CPF markers on Pillow's part 1 file, and a
    150 x 12 file in generate_tree buckets no other fixture brings."""
    img = smooth(rng, 19, 23)
    gray12 = (smooth(rng, 17, 21)[:, :, 0].astype(np.uint16) * 16
              + rng.integers(0, 16, (17, 21)))
    r = random.Random(int(rng.integers(1 << 30)))
    out = {
        "j2k4_53_rct.png": ht.encode(img, levels=2, jp2=True),
        "j2k4_97_ict.jpg": ht.encode(img, levels=3, reversible=False,
                                     step=0.75, jp2=True),
        "j2k4_gray_12bit.png": ht.encode(gray12, levels=2, precision=12,
                                         jp2=True),
        "j2k4_cblk_16x64_tiles_rpcl.png": ht.encode(
            img, levels=1, cblk=(16, 64), tile=(16, 12), layers=3,
            progression="RPCL", jp2=True),
        "j2k4_cblk_4x1024_cprl.jpg": ht.encode(
            img, levels=2, reversible=False, step=1.5, cblk=(4, 1024),
            progression="CPRL", layers=2, jp2=True),
        "j2k4_raw_sop_eph.jpg": ht.encode(img, levels=2, reversible=False,
                                          step=1.0, sop=True, eph=True),
        "j2k4_cdef_swap.png": with_box(ht.encode(img, levels=1, jp2=True),
                                       cdef_box([(0, 0, 3), (1, 0, 2),
                                                 (2, 0, 1)])),
        "j2k4_refine_sigprop.png": ht.encode(
            img, levels=1, plane=1, refine=ht.random_refine((1,), (2, 9)),
            rng=r, jp2=True),
        "j2k4_refine_magref_vsc.png": ht.encode(
            img, levels=1, plane=1, style=8, refine=ht.random_refine(
                (2,), (2, 9)), rng=r, jp2=True),
        "j2k4_cap_cpf_part1.png": insert_main(insert_main(
            pil_j2k(img), 0xFF59, b"\x00\x01"), 0xFF50, ht.CAP_BODY),
        "j2k4_150x12_97.jpg": ht.encode(smooth(rng, 150, 12, amp=6),
                                        levels=2, reversible=False, step=2.0,
                                        cblk=(16, 16), jp2=True),
    }
    return out


def ht_skip_cases(rng):
    """Part 4's files cv2.imread gives None for: HTJ2K that PIL reads
    (signed samples, an image offset, a raw gray codestream) and files both
    readers refuse (an RGN marker with HT code-blocks, the mixed HT style,
    4 passes in a code-block, an Scup of 4080)."""
    img = smooth(rng, 15, 18)
    gray = img[:, :, 1]
    r = random.Random(int(rng.integers(1 << 30)))
    raw = ht.encode(img, levels=1)
    cod = next(p for p, m, b in main_markers(raw) if m == 0xFF52) + 4
    return {
        "j2k4_signed.png": ht.encode(img, levels=1, signed=True, jp2=True),
        "j2k4_offset_tiles.jpg": ht.encode(img, levels=1, offset=(5, 3),
                                           tile=(12, 10), reversible=False,
                                           jp2=True),
        "j2k4_raw_gray.png": ht.encode(gray, levels=2),
        "j2k4_rgn.png": insert_main(raw, 0xFF5E, b"\0\0\x02"),
        "j2k4_mixed_style.png": set_byte(raw, cod + 8, 0xC0),
        "j2k4_4_passes.png": ht.encode(img, levels=1, plane=1, refine=(
            ht.random_refine((3,), (3, 6))), rng=r),
        "j2k4_scup_4080.png": ht.encode(img, levels=1, mutate=lambda k, d: (
            with_scup(d, 4080))),
    }


def build_big(rng):
    """The 640 x 480 gradient-and-grain image and Pillow's lossy 9/7 JP2 of
    it at a 40:1 rate."""
    h, w = BIG_SIZE
    img = smooth(rng, h, w, amp=3)
    return img, pil_j2k(img, irreversible=True, quality_mode="rates",
                        quality_layers=[40])
