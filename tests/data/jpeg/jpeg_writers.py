"""JPEG streams that neither cv2 nor PIL writes, made by hand in numpy for
the codec tests and ``make_fixtures.py``:

- :func:`lossless`: lossless JPEG (SOF3, T.81 Annex H): predictors 1-7, a
  point transform, restart intervals, 1 or 3 components, any sampling;
- :func:`arithmetic`: DCT JPEG with arithmetic coding (SOF9 sequential or
  SOF10 progressive, T.81 Annex D's QM coder with the F.1.4 and G.1.3
  models, libjpeg's jcarith.c), with DAC conditioning and restarts;
- :func:`two_components`: a valid baseline file of two components.

Each returns the file's bytes. The DCT files quantise a float DCT of the
image (any coefficients will do: the decoders under test are held to each
other, not to the image).
"""

import struct

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63])
STD_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13,
    16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56,
    68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92, 49, 64, 78, 87, 103,
    121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
STD_CHROMA = np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66] +
                      [99] * 4 + [24, 26, 56] + [99] * 5 + [47, 66]
                      + [99] * 38)
# libjpeg's jpeg_simple_progression for three components (Ss, Se, Ah, Al
# and the components of each scan)
SIMPLE_PROGRESSION = (
    ((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
    ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
    ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
    ((0,), 1, 63, 1, 0))


def segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def sof(marker, h, w, comps):
    """``comps``: (id, h, v, table) per component."""
    body = struct.pack(">BHHB", 8, h, w, len(comps))
    for cid, hs, vs, tq in comps:
        body += bytes([cid, hs << 4 | vs, tq])
    return segment(marker, body)


def dqt(index: int, table) -> bytes:
    return segment(0xDB, bytes([index]) + bytes(
        int(v) for v in np.asarray(table)[ZIGZAG]))


def dht(index: int, counts, vals) -> bytes:
    return segment(0xC4, bytes([index]) + bytes(counts) + bytes(vals))


def sos(comps, ss, se, ah, al):
    """``comps``: (id, dc table, ac table) per component."""
    body = bytes([len(comps)])
    for cid, td, ta in comps:
        body += bytes([cid, td << 4 | ta])
    return segment(0xDA, body + bytes([ss, se, ah << 4 | al]))


class BitWriter:
    """Huffman-coded bits, 0xFF stuffed, padded with 1s."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, bits: int, k: int):
        self.acc = (self.acc << k) | (bits & ((1 << k) - 1))
        self.n += k
        while self.n >= 8:
            b = (self.acc >> (self.n - 8)) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
            self.n -= 8

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def huffman_codes(counts, vals):
    code, k, table = 0, 0, {}
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            table[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return table


def category(v: int) -> int:
    return int(abs(v)).bit_length()


# the standard luma DC table of Annex K.3, extended to the 17 difference
# categories of lossless JPEG (lengths 10-14 for categories 12-16)
LOSSLESS_COUNTS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0]
LOSSLESS_VALS = list(range(17))


def _predict(psv, ra, rb, rc):
    return {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv]


def _differences(plane, psv, pt, reset_rows):
    """T.81 H.1.2.1's differences of one component plane (uint8 [h, w]),
    the first-line predictor on the rows of ``reset_rows``; mod 2^16 into
    [-32767, 32768]."""
    x = plane.astype(np.int64) >> pt
    h, w = x.shape
    d = np.zeros((h, w), np.int64)
    for r in range(h):
        for c in range(w):
            if r in reset_rows:
                p = (1 << (8 - pt - 1)) if c == 0 else x[r, c - 1]
            elif c == 0:
                p = x[r - 1, 0]
            else:
                p = _predict(psv, int(x[r, c - 1]), int(x[r - 1, c]),
                             int(x[r - 1, c - 1]))
            v = (int(x[r, c]) - int(p)) & 0xFFFF
            d[r, c] = v - 65536 if v > 32768 else v
    return d


def lossless(planes, psv=1, pt=0, restart=0, ids=(1, 2, 3),
             sampling=None, interleaved=True, adobe=None) -> bytes:
    """A lossless JPEG of ``planes`` (one uint8 [h, w] per component; the
    first at the largest sampling, so at full size, the others at theirs).
    ``sampling``: (h, v) per component, 1 x 1 by default. ``restart``: the
    restart interval in MCU rows (0: none). With ``interleaved`` False each
    component gets a scan of its own. ``adobe``: an APP14 transform flag."""
    n = len(planes)
    sampling = sampling or [(1, 1)] * n
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    H, W = planes[0].shape
    codes = huffman_codes(LOSSLESS_COUNTS, LOSSLESS_VALS)
    out = b"\xff\xd8"
    if adobe is not None:
        out += segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, adobe]))
    out += sof(0xC3, H, W, [(ids[i], sampling[i][0], sampling[i][1], 0)
                            for i in range(n)])
    out += dht(0x00, LOSSLESS_COUNTS, LOSSLESS_VALS)
    mcux, mcuy = -(-W // hmax), -(-H // vmax)

    def encode_scan(comp_idx):
        single = len(comp_idx) == 1
        diffs, grids = [], []
        for i in comp_idx:
            hs, vs = (1, 1) if single else sampling[i]
            rows_per_mcu = sampling[i][1] if not single else 1
            n_mcu_rows = planes[i].shape[0] if single else mcuy
            resets = {0}
            if restart:
                resets |= {m * rows_per_mcu
                           for m in range(0, n_mcu_rows, restart)}
            d = _differences(planes[i], psv, pt, resets)
            gh = planes[i].shape[0] if single else mcuy * sampling[i][1]
            gw = planes[i].shape[1] if single else mcux * sampling[i][0]
            g = np.zeros((gh, gw), np.int64)
            g[:d.shape[0], :d.shape[1]] = d
            diffs.append(g)
            grids.append((hs, vs))
        cols = planes[comp_idx[0]].shape[1] if single else mcux
        rows = planes[comp_idx[0]].shape[0] if single else mcuy
        data = b""
        bw = BitWriter()
        rst = 0
        for mr in range(rows):
            if restart and mr and mr % restart == 0:
                data += bw.flush() + bytes([0xFF, 0xD0 + rst])
                rst = (rst + 1) & 7
                bw = BitWriter()
            for mc in range(cols):
                for g, (hs, vs) in zip(diffs, grids):
                    for y in range(vs):
                        for x in range(hs):
                            v = int(g[mr * vs + y, mc * hs + x])
                            s = 16 if v == 32768 else category(v)
                            bw.put(*codes[s])
                            if 0 < s < 16:
                                bw.put(v if v > 0 else v - 1, s)
        return data + bw.flush()

    if restart:
        per_row = mcux if interleaved else None
        out += segment(0xDD, struct.pack(">H", restart * (per_row or 1)))
    if interleaved:
        out += sos([(ids[i], 0, 0) for i in range(n)], psv, 0, 0, pt)
        out += encode_scan(list(range(n)))
    else:
        for i in range(n):
            if restart:
                out += segment(0xDD, struct.pack(">H",
                                                 restart * planes[i].shape[1]))
            out += sos([(ids[i], 0, 0)], psv, 0, 0, pt)
            out += encode_scan([i])
    return out + b"\xff\xd9"


# ------------------------------------------------------------ DCT files

def _dct_matrix():
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) / 2
    m[0] /= np.sqrt(2)
    return m


def coefficients(plane, qtable, gh, gw):
    """Quantised DCT blocks of a uint8 plane padded (edge) to gh x gw
    blocks: int [gh, gw, 64], natural order."""
    h, w = plane.shape
    p = np.pad(plane.astype(np.float64) - 128,
               ((0, gh * 8 - h), (0, gw * 8 - w)), mode="edge")
    m = _dct_matrix()
    blocks = p.reshape(gh, 8, gw, 8).transpose(0, 2, 1, 3)
    c = m @ blocks @ m.T
    return np.rint(c.reshape(gh, gw, 64) / qtable).astype(np.int64)


def ycc_planes(rgb, sampling):
    """YCbCr planes of an RGB image (JFIF's matrix), each component's plane
    averaged down to its sampling."""
    x = rgb.astype(np.float64)
    y = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    cb = 128 - 0.168736 * x[..., 0] - 0.331264 * x[..., 1] + 0.5 * x[..., 2]
    cr = 128 + 0.5 * x[..., 0] - 0.418688 * x[..., 1] - 0.081312 * x[..., 2]
    H, W = y.shape
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    planes = []
    for p, (hs, vs) in zip((y, cb, cr), sampling):
        fy, fx = vmax // vs, hmax // hs
        ph, pw = -(-H // fy) * fy, -(-W // fx) * fx
        p = np.pad(p, ((0, ph - H), (0, pw - W)), mode="edge")
        p = p.reshape(ph // fy, fy, pw // fx, fx).mean(axis=(1, 3))
        planes.append(np.clip(np.rint(p), 0, 255).astype(np.uint8))
    return planes


class QMEncoder:
    """T.81 Annex D's arithmetic encoder as jcarith.c writes it."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct = 0, 0x10000, 0, 0, 11
        self.buffer = -1

    def _emit(self, b):
        self.out.append(b)

    def _emit_pending(self, b):
        while self.zc:
            self._emit(0)
            self.zc -= 1
        self._emit(b)

    def encode(self, stats, idx, val):
        sv = stats[idx]
        qe, nlps, nmps, switch = QE[sv & 0x7F]
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            stats[idx] = (sv & 0x80) ^ (nlps | (switch << 7))
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            stats[idx] = (sv & 0x80) ^ nmps
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._emit_pending(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._emit_pending(self.buffer)
                    if self.sc:
                        while self.zc:
                            self._emit(0)
                            self.zc -= 1
                        for _ in range(self.sc):
                            self._emit(0xFF)
                            self._emit(0)
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._emit_pending(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._emit_pending(self.buffer)
            if self.sc:
                while self.zc:
                    self._emit(0)
                    self.zc -= 1
                for _ in range(self.sc):
                    self._emit(0xFF)
                    self._emit(0)
                self.sc = 0
        if self.c & 0x7FFF800:
            while self.zc:
                self._emit(0)
                self.zc -= 1
            self._emit((self.c >> 19) & 0xFF)
            if ((self.c >> 19) & 0xFF) == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if ((self.c >> 11) & 0xFF) == 0xFF:
                    self._emit(0)
        return bytes(self.out)


# T.81 Table D.2: (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS), then
# jaricom.c's fixed 0.5 estimate (entry 113)
QE = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
    (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
    (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
    (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
    (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
    (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
    (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
    (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
    (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
    (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
    (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
    (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]


class ArithScan:
    """jcarith.c's models for one scan (F.1.4 sequential, G.1.3
    progressive) over a QMEncoder."""

    def __init__(self, dc_l, dc_u, ac_k):
        self.dc_l, self.dc_u, self.ac_k = dc_l, dc_u, ac_k
        self.reset()

    def reset(self):
        self.qm = QMEncoder()
        self.dc_stats = {t: [0] * 64 for t in range(4)}
        self.ac_stats = {t: [0] * 256 for t in range(4)}
        self.fixed = [113]
        self.last_dc = [0] * 4
        self.dc_ctx = [0] * 4

    def _magnitude(self, stats, st, v, x2):
        """F.8 and F.9 for |v| - 1 = v, from bin st (SP/SN, or X1 of DC)."""
        enc = self.qm.encode
        m = 0
        if v:
            enc(stats, st, 1)
            m = 1
            v2 = v
            if x2 is None:  # DC: X1 = 20 and on
                st = 20
                while v2 >> 1:
                    v2 >>= 1
                    enc(stats, st, 1)
                    m <<= 1
                    st += 1
            else:
                v2 >>= 1
                if v2:
                    enc(stats, st, 1)
                    m <<= 1
                    st = x2
                    while v2 >> 1:
                        v2 >>= 1
                        enc(stats, st, 1)
                        m <<= 1
                        st += 1
        enc(stats, st, 0)
        st += 14
        mm = m
        while mm >> 1:
            mm >>= 1
            enc(stats, st, 1 if mm & v else 0)
        return m

    def dc(self, ci, tbl, value):
        enc = self.qm.encode
        stats = self.dc_stats[tbl]
        st = self.dc_ctx[ci]
        v = value - self.last_dc[ci]
        if v == 0:
            enc(stats, st, 0)
            self.dc_ctx[ci] = 0
            return
        self.last_dc[ci] = value
        enc(stats, st, 1)
        if v > 0:
            enc(stats, st + 1, 0)
            st += 2
            self.dc_ctx[ci] = 4
        else:
            v = -v
            enc(stats, st + 1, 1)
            st += 3
            self.dc_ctx[ci] = 8
        m = self._magnitude(stats, st, v - 1, None)
        if m < (1 << self.dc_l[tbl]) >> 1:
            self.dc_ctx[ci] = 0
        elif m > (1 << self.dc_u[tbl]) >> 1:
            self.dc_ctx[ci] += 8

    def ac(self, tbl, block, ss, se, al):
        """AC coefficients ss..se (zigzag) of a natural-order block after
        the point transform al (magnitudes shifted, toward zero)."""
        enc = self.qm.encode
        stats = self.ac_stats[tbl]
        zz = [int(block[ZIGZAG[k]]) for k in range(64)]
        t = [(abs(v) >> al) * (1 if v >= 0 else -1) for v in zz]
        ke = se
        while ke > 0 and t[ke] == 0:
            ke -= 1
        k = ss
        while k <= ke:
            st = 3 * (k - 1)
            enc(stats, st, 0)
            while t[k] == 0:
                enc(stats, st + 1, 0)
                st += 3
                k += 1
            enc(stats, st + 1, 1)
            v = t[k]
            enc(self.fixed, 0, 0 if v > 0 else 1)
            self._magnitude(stats, st + 2, abs(v) - 1,
                            189 if k <= self.ac_k[tbl] else 217)
            k += 1
        if k <= se:
            enc(stats, 3 * (k - 1), 1)

    def ac_refine(self, tbl, block, ss, se, ah, al):
        enc = self.qm.encode
        stats = self.ac_stats[tbl]
        zz = [abs(int(block[ZIGZAG[k]])) for k in range(64)]
        sign = [int(block[ZIGZAG[k]]) < 0 for k in range(64)]
        ke = se
        while ke > 0 and (zz[ke] >> al) == 0:
            ke -= 1
        kex = ke
        while kex > 0 and (zz[kex] >> ah) == 0:
            kex -= 1
        k = ss
        while k <= ke:
            st = 3 * (k - 1)
            if k > kex:
                enc(stats, st, 0)
            while True:
                v = zz[k] >> al
                if v:
                    if v >> 1:
                        enc(stats, st + 2, v & 1)
                    else:
                        enc(stats, st + 1, 1)
                        enc(self.fixed, 0, 1 if sign[k] else 0)
                    break
                enc(stats, st + 1, 0)
                st += 3
                k += 1
            k += 1
        if k <= se:
            enc(stats, 3 * (k - 1), 1)


def arithmetic(rgb, progressive=False, restart=0,
               sampling=((2, 2), (1, 1), (1, 1)), dac=None) -> bytes:
    """An arithmetic-coded JPEG (SOF9, or SOF10 with libjpeg's simple
    progression) of an RGB image; ``restart`` in MCUs; ``dac``: a list of
    (index, value) DAC entries (index < 16: DC table L | U << 4; 16 + t:
    AC table t's K)."""
    H, W = rgb.shape[:2]
    planes = ycc_planes(rgb, sampling)
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    qt = [STD_LUMA, STD_CHROMA]
    coef = []
    for i, p in enumerate(planes):
        hs, vs = sampling[i]
        coef.append(coefficients(p, qt[min(i, 1)], mcuy * vs, mcux * hs))
    dims = [(-(-p.shape[0] // 8), -(-p.shape[1] // 8)) for p in planes]
    dc_l, dc_u, ac_k = [0] * 16, [1] * 16, [5] * 16
    for index, value in dac or ():
        if index < 16:
            dc_l[index], dc_u[index] = value & 15, value >> 4
        else:
            ac_k[index - 16] = value
    out = b"\xff\xd8" + segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    out += dqt(0, qt[0]) + dqt(1, qt[1])
    out += sof(0xCA if progressive else 0xC9, H, W,
               [(i + 1, sampling[i][0], sampling[i][1], min(i, 1))
                for i in range(3)])
    if dac:
        out += segment(0xCC, b"".join(bytes([i, v]) for i, v in dac))
    if restart:
        out += segment(0xDD, struct.pack(">H", restart))
    scans = (SIMPLE_PROGRESSION if progressive
             else (((0, 1, 2), 0, 63, 0, 0),))
    for comps, ss, se, ah, al in scans:
        tables = [min(i, 1) for i in comps]
        out += sos([(i + 1, t, t) for i, t in zip(comps, tables)],
                   ss, se, ah, al)
        coder = ArithScan(dc_l, dc_u, ac_k)
        single = len(comps) == 1
        if single:
            units = [(r, c) for r in range(dims[comps[0]][0])
                     for c in range(dims[comps[0]][1])]
        else:
            units = [(r, c) for r in range(mcuy) for c in range(mcux)]
        data, rst = b"", 0
        for n, (r, c) in enumerate(units):
            if restart and n and n % restart == 0:
                data += coder.qm.finish() + bytes([0xFF, 0xD0 + rst])
                rst = (rst + 1) & 7
                coder.reset()
            for slot, i in enumerate(comps):
                hs, vs = (1, 1) if single else sampling[i]
                for y in range(vs):
                    for x in range(hs):
                        blk = coef[i][r * vs + y, c * hs + x]
                        t = tables[slot]
                        if not progressive:
                            coder.dc(slot, t, int(blk[0]))
                            coder.ac(t, blk, 1, 63, 0)
                        elif ss == 0 and ah == 0:
                            coder.dc(slot, t, int(blk[0]) >> al)
                        elif ss == 0:
                            coder.qm.encode(coder.fixed, 0,
                                            (int(blk[0]) >> al) & 1)
                        elif ah == 0:
                            coder.ac(t, blk, ss, se, al)
                        else:
                            coder.ac_refine(t, blk, ss, se, ah, al)
        out += data + coder.qm.finish()
    return out + b"\xff\xd9"


def two_components(h=16, w=24, seed=0) -> bytes:
    """A valid baseline JPEG of two 1x1-sampled components, DC only."""
    rng = np.random.default_rng(seed)
    dc_counts = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
    ac_counts = [0, 1] + [0] * 14  # one code: EOB
    dc_codes = huffman_codes(dc_counts, list(range(12)))
    out = b"\xff\xd8" + dqt(0, np.full(64, 8))
    out += sof(0xC0, h, w, [(1, 1, 1, 0), (2, 1, 1, 0)])
    out += dht(0x00, dc_counts, list(range(12))) + dht(0x10, ac_counts, [0])
    out += sos([(1, 0, 0), (2, 0, 0)], 0, 63, 0, 0)
    bw = BitWriter()
    for _ in range(-(-h // 8) * -(-w // 8)):
        for _ in range(2):
            v = int(rng.integers(-20, 21))
            s = category(v)
            bw.put(*dc_codes[s])
            if s:
                bw.put(v if v > 0 else v - 1, s)
            bw.put(0, 2)  # EOB: the one AC code, '00'
    return out + bw.flush() + b"\xff\xd9"
