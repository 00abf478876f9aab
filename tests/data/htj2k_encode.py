"""A small HTJ2K encoder (ITU-T T.814 | ISO/IEC 15444-15) for the tests of
the port's JPEG 2000 decoder, on numpy alone.

It writes a raw codestream or a JP2 file of a gray, gray and alpha, RGB or
RGBA image of 1 to 16 bits: the forward 5/3 (integers, lossless) or 9/7
(floats, scalar expounded steps), RCT or ICT on 3 components or more, any
number of decomposition levels, code-blocks of any size the standard allows,
tiles (from the grid's origin, the image at an offset if asked), quality
layers that take each code-block in a layer of its own, the five
progression orders, one precinct a resolution, and the markers SIZ, CAP,
CPF (if asked), COD (code-block style bit 6: HT), QCD, SOT, SOD and EOC.

Each code-block is one HT cleanup pass (MEL, the context VLC codewords by
inverting OpenJPEG's decode tables ``vlc_tbl0`` / ``vlc_tbl1``, UVLC and
MagSgn; no rate control), optionally at a bit-plane above the last
(``plane``), and optionally followed by SigProp and MagRef bytes that the
caller makes up (``refine``): the encoder codes no refinement pass itself.
Packet headers follow OpenJPEG's reading of HT segments (its
opj_t2_read_packet_header: the first segment takes the cleanup pass alone,
the next every pass left), so that what a caller asks for is what OpenJPEG
reads.

``encode`` is the entry point; ``vlc_tables`` reads the tables from the
port's ``ht_tables.h``.
"""

import functools
import random
import re
import struct
from pathlib import Path

import numpy as np

HT_TABLES = (Path(__file__).resolve().parents[2] / "tsr_tpu_torch" / "native"
             / "ht_tables.h")
PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")
# CAP's body for Part 15 (Pcap bit 17, Ccap15 0) and the Rsiz bit it sets
CAP_BODY = b"\x00\x02\x00\x00\x00\x00"
RSIZ_CAP = 0x4000


# ----------------------------------------------------------- the tables

@functools.lru_cache(maxsize=None)
def vlc_tables():
    """(vlc_tbl0, vlc_tbl1): 1024 uint16 each, from ht_tables.h."""
    text = HT_TABLES.read_text()
    out = []
    for name in ("kHtVlc0", "kHtVlc1"):
        body = text.split(f"{name}[1024] = {{", 1)[1].split("};", 1)[0]
        out.append(np.array([int(v, 16) for v in re.findall(
            r"0x[0-9a-f]+", body)], np.uint16))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def codewords():
    """For each table, {(context, rho, u_off): [(codeword, length, e_k,
    e_1)]}: each codeword once."""
    out = []
    for table in vlc_tables():
        words, seen = {}, set()
        for i, e in enumerate(table.tolist()):
            c, length = i >> 7, e & 7
            code = (i & 127) & ((1 << length) - 1)
            if (c, code, length) in seen:
                continue
            seen.add((c, code, length))
            words.setdefault((c, (e >> 4) & 15, (e >> 3) & 1), []).append(
                (code, length, (e >> 12) & 15, (e >> 8) & 15))
        out.append(words)
    return tuple(out)


# ------------------------------------------------- the cleanup pass's streams

class _Mel:
    """The MEL encoder: runs of zero events, MSB first, a bit stuffed after
    0xFF."""
    EXP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5)

    def __init__(self):
        self.buf, self.remaining, self.tmp = bytearray(), 8, 0
        self.run, self.k, self.threshold = 0, 0, 1

    def _bit(self, v):
        self.tmp = (self.tmp << 1) + v
        self.remaining -= 1
        if self.remaining == 0:
            self.buf.append(self.tmp)
            self.remaining = 7 if self.tmp == 0xFF else 8
            self.tmp = 0

    def event(self, bit):
        if not bit:
            self.run += 1
            if self.run >= self.threshold:
                self._bit(1)
                self.run = 0
                self.k = min(12, self.k + 1)
                self.threshold = 1 << self.EXP[self.k]
        else:
            self._bit(0)
            t = self.EXP[self.k]
            while t > 0:
                t -= 1
                self._bit((self.run >> t) & 1)
            self.run = 0
            self.k = max(0, self.k - 1)
            self.threshold = 1 << self.EXP[self.k]


class _Vlc:
    """The VLC stream, written backward from the segment's end (its last
    byte kept for Scup, its low nibble before that too), LSB first; after a
    byte above 0x8F a byte's MSB is a stuffed 0 where its 7 low bits are all
    set."""

    def __init__(self):
        self.out = bytearray([0xFF])  # reversed: out[0] is the last byte
        self.used, self.tmp, self.last_gt_8f = 4, 0xF, True

    def put(self, cwd, n):
        while n > 0:
            avail = 8 - self.last_gt_8f - self.used
            t = min(avail, n)
            self.tmp |= (cwd & ((1 << t) - 1)) << self.used
            self.used += t
            avail -= t
            n -= t
            cwd >>= t
            if avail == 0:
                if self.last_gt_8f and self.tmp != 0x7F:
                    self.last_gt_8f = False
                    continue
                self.out.append(self.tmp)
                self.last_gt_8f = self.tmp > 0x8F
                self.tmp, self.used = 0, 0


class _MagSgn:
    """The MagSgn stream, forward, LSB first; after 0xFF a byte holds 7
    bits."""

    def __init__(self):
        self.buf, self.max_bits, self.used, self.tmp = bytearray(), 8, 0, 0

    def put(self, cwd, n):
        while n > 0:
            t = min(self.max_bits - self.used, n)
            self.tmp |= (cwd & ((1 << t) - 1)) << self.used
            self.used += t
            cwd >>= t
            n -= t
            if self.used >= self.max_bits:
                self.buf.append(self.tmp)
                self.max_bits = 7 if self.tmp == 0xFF else 8
                self.tmp, self.used = 0, 0

    def terminate(self):
        if self.used:
            t = self.max_bits - self.used
            self.tmp |= (0xFF & ((1 << t) - 1)) << self.used
            if self.tmp != 0xFF:
                self.buf.append(self.tmp)
        elif self.max_bits == 7:
            self.buf.pop()


def _terminate(mel, vlc):
    """The MEL stream's last byte and the VLC stream's first, fused where
    their bits allow."""
    if mel.run > 0:
        mel._bit(1)
    mel.tmp <<= mel.remaining
    mel_mask = (0xFF << mel.remaining) & 0xFF
    vlc_mask = 0xFF >> (8 - vlc.used)
    if (mel_mask | vlc_mask) == 0:
        return
    fuse = mel.tmp | vlc.tmp
    if ((((fuse ^ mel.tmp) & mel_mask) | ((fuse ^ vlc.tmp) & vlc_mask)) == 0
            and fuse != 0xFF and len(vlc.out) > 1):
        mel.buf.append(fuse)
    else:
        mel.buf.append(mel.tmp)
        vlc.out.append(vlc.tmp)


def _uvlc(u):
    """(prefix bits, prefix length, suffix, suffix length) of u >= 1."""
    if u == 1:
        return 1, 1, 0, 0
    if u == 2:
        return 2, 2, 0, 0
    if u <= 4:
        return 4, 3, u - 3, 1
    assert u <= 36, u
    return 0, 3, u - 5, 5


def cleanup_pass(q, plane=0, rng=None, used=None):
    """The HT cleanup segment of a code-block's quantised coefficients ``q``
    (int array, rows by columns) at bit-plane ``plane``: magnitudes
    ``|q| >> plane``. ``rng`` (a random.Random) picks among the codewords
    that fit each quad (those not in ``used`` first) instead of the one of
    most e_k bits; ``used`` (a set) collects the (table, context, codeword,
    length) written."""
    q = np.asarray(q, np.int64)
    h, w = q.shape
    mag = (np.abs(q) >> plane).tolist()
    neg = (q < 0).tolist()
    mel, vlc, ms = _Mel(), _Vlc(), _MagSgn()
    cws = codewords()
    # the line state: sigma and E of the row above's samples, by column
    above_sig = [0] * (w + 3)
    above_e = [0] * (w + 3)

    def sample(x, y):
        if x >= w or y >= h or mag[y][x] == 0:
            return 0, 0, 0
        mu = mag[y][x]
        return 1, (2 * mu - 1).bit_length(), 2 * (mu - 1) + neg[y][x]

    for y in range(0, h, 2):
        initial = y == 0
        row_sig, row_e = [0] * (w + 3), [0] * (w + 3)
        c_q = 0
        for x in range(0, w, 4):
            quads = []
            for qd in range(2):
                cx = x + 2 * qd
                if qd == 1 and cx >= w:
                    quads.append(None)
                    continue
                ss = [sample(cx, y), sample(cx, y + 1), sample(cx + 1, y),
                      sample(cx + 1, y + 1)]
                rho = sum(s[0] << k for k, s in enumerate(ss))
                quads.append((cx, ss, rho))
            info = []
            for qd, quad in enumerate(quads):
                if quad is None:
                    info.append(None)
                    continue
                cx, ss, rho = quad
                if not initial:
                    nw_n = above_sig[cx - 1] | above_sig[cx] if cx else \
                        above_sig[cx]
                    ne_nf = above_sig[cx + 1] | above_sig[cx + 2]
                    c_q |= nw_n | (ne_nf << 2)
                e_max = max(s[1] for s in ss)
                kappa = 1
                if not initial and bin(rho).count("1") >= 2:
                    e_nb = max(above_e[cx - 1] if cx else 0, above_e[cx],
                               above_e[cx + 1], above_e[cx + 2])
                    kappa = max(e_nb - 1, 1)
                uq = max(e_max, kappa)
                u = uq - kappa
                emb = sum((s[1] == uq) << k for k, s in enumerate(ss)) if u \
                    else 0
                if c_q == 0:
                    mel.event(1 if rho else 0)
                entry = None
                if c_q != 0 or rho:
                    table = 0 if initial else 1
                    fits = [e for e in cws[table][(c_q, rho, 1 if u else 0)]
                            if (e[3] == (emb & e[2]) if u else True)]
                    assert fits, (c_q, rho, u, emb)
                    if rng is not None:  # one not written yet, if any
                        fresh = [e for e in fits if used is None or (
                            table, c_q, e[0], e[1]) not in used]
                        entry = rng.choice(fresh or fits)
                    else:
                        best = max(bin(e[2]).count("1") for e in fits)
                        entry = [e for e in fits
                                 if bin(e[2]).count("1") == best][-1]
                    vlc.put(entry[0], entry[1])
                    if used is not None:
                        used.add((table, c_q, entry[0], entry[1]))
                info.append((cx, ss, rho, uq, u, entry[2] if entry else 0))
                c_q = ((rho & 1) | (rho >> 1 & 1) | (rho >> 2 & 1) << 1
                       | (rho >> 3) << 2) if initial else (
                    (rho >> 2 & 1) | (rho >> 3 & 1)) << 1
            # the pair's u: UVLC (the first row pair: a MEL event where
            # both quads have u, and its one-bit rule)
            us = [i[4] if i else 0 for i in info]
            if initial and us[0] and us[1]:
                both = min(us) > 2
                mel.event(1 if both else 0)
                if both:
                    p0, l0, s0, n0 = _uvlc(us[0] - 2)
                    p1, l1, s1, n1 = _uvlc(us[1] - 2)
                    vlc.put(p0, l0)
                    vlc.put(p1, l1)
                    vlc.put(s0, n0)
                    vlc.put(s1, n1)
                elif us[0] > 2:
                    p0, l0, s0, n0 = _uvlc(us[0])
                    vlc.put(p0, l0)
                    vlc.put(us[1] - 1, 1)
                    vlc.put(s0, n0)
                else:
                    p0, l0, s0, n0 = _uvlc(us[0])
                    p1, l1, s1, n1 = _uvlc(us[1])
                    vlc.put(p0, l0)
                    vlc.put(p1, l1)
                    vlc.put(s0, n0)
                    vlc.put(s1, n1)
            elif us[0] and us[1]:
                p0, l0, s0, n0 = _uvlc(us[0])
                p1, l1, s1, n1 = _uvlc(us[1])
                vlc.put(p0, l0)
                vlc.put(p1, l1)
                vlc.put(s0, n0)
                vlc.put(s1, n1)
            else:
                for v in us:
                    if v:
                        p0, l0, s0, n0 = _uvlc(v)
                        vlc.put(p0, l0)
                        vlc.put(s0, n0)
            # MagSgn: m_n bits of each significant sample, e_k saving one
            for i in info:
                if not i:
                    continue
                cx, ss, rho, uq, u, ek = i
                for k, (sig, _, v) in enumerate(ss):
                    if sig:
                        m = uq - (ek >> k & 1)
                        assert m >= 1 and v < (1 << (m + (ek >> k & 1)))
                        ms.put(v & ((1 << m) - 1), m)
                for k in (1, 3):
                    col = cx + (k >> 1)
                    row_sig[col], row_e[col] = ss[k][0], ss[k][1]
        above_sig, above_e = row_sig, row_e
    _terminate(mel, vlc)
    ms.terminate()
    scup = len(mel.buf) + len(vlc.out)
    assert 2 <= scup <= 4079, scup
    out = bytearray(ms.buf) + mel.buf + bytes(reversed(vlc.out))
    out[-1] = scup >> 4
    out[-2] = (out[-2] & 0xF0) | (scup & 0xF)
    return bytes(out)


# ------------------------------------------------------------- transforms

def _neighbours(x, first, n):
    """The sums x[i - 1] + x[i + 1] (mirrored at the ends) over the rows of
    ``x`` for every i from ``first`` in steps of 2 (axis 0 is the line)."""
    idx = np.arange(first, n, 2)
    left, right = np.abs(idx - 1), idx + 1
    right = np.where(right >= n, 2 * n - 2 - right, right)
    return idx, x[left] + x[right]


def _fwd53(x, cas):
    """The forward 5/3 of the lines of ``x`` (axis 0) in place, the first
    sample's parity ``cas``: the highs predicted, then the lows updated."""
    n = len(x)
    if n == 1:
        if cas:
            x *= 2
        return
    idx, s = _neighbours(x, 1 - cas, n)
    x[idx] -= s >> 1
    idx, s = _neighbours(x, cas, n)
    x[idx] += (s + 2) >> 2


_ALPHA, _BETA = -1.586134342, -0.052980118
_GAMMA, _DELTA = 0.882911075, 0.443506852
_K, _TWO_INV_K = 1.230174105, 1.625732422


def _fwd97(x, cas):
    """The forward 9/7 of the lines of ``x`` in place: the inverse of the
    decoder's four lifting steps and scaling."""
    n = len(x)
    if n == 1:
        return
    for first, c in ((1 - cas, _ALPHA), (cas, _BETA), (1 - cas, _GAMMA),
                     (cas, _DELTA)):
        idx, s = _neighbours(x, first, n)
        x[idx] += c * s
    x[cas::2] /= _K
    x[1 - cas::2] /= _TWO_INV_K


def _ceil(a, b):
    return -(-a // b)


def _resolutions(tx0, ty0, tx1, ty1, levels):
    """[(x0, y0, x1, y1)] of resolutions 0..levels of a tile-component."""
    return [(_ceil(tx0, 1 << (levels - r)), _ceil(ty0, 1 << (levels - r)),
             _ceil(tx1, 1 << (levels - r)), _ceil(ty1, 1 << (levels - r)))
            for r in range(levels + 1)]


def forward_dwt(a, rect, levels, reversible):
    """The forward transform of a tile-component ``a`` (its rect x0, y0, x1,
    y1 on the grid) in place: each level's vertical pass, then horizontal,
    lows first, as the decoder's inverse takes them apart."""
    res = _resolutions(*rect, levels)
    line = _fwd53 if reversible else _fwd97
    for r in range(levels, 0, -1):
        x0, y0, x1, y1 = res[r]
        lx0, ly0, lx1, ly1 = res[r - 1]
        rw, rh, snh, snv = x1 - x0, y1 - y0, lx1 - lx0, ly1 - ly0
        cash, casv = x0 & 1, y0 & 1
        cols = a[:rh, :rw].copy()
        line(cols, casv)
        assert len(cols[casv::2]) == snv
        a[:rh, :rw] = np.concatenate([cols[casv::2], cols[1 - casv::2]])
        rows = a[:rh, :rw].T.copy()
        line(rows, cash)
        assert len(rows[cash::2]) == snh
        a[:rh, :rw] = np.concatenate([rows[cash::2], rows[1 - cash::2]]).T
    return res


def bands(res):
    """[(r, bandno, x0, y0, x1, y1, ax, ay)] of each band in the decoder's
    order: its rect in band coordinates and its place (ax, ay) in the
    transformed tile-component."""
    out = [(0, 0) + tuple(res[0]) + (0, 0)]
    levels = len(res) - 1
    for r in range(1, levels + 1):
        lvl = levels - r
        lo = res[r - 1]
        for b in (1, 2, 3):
            xob, yob = b & 1, b >> 1
            tx0, ty0 = res[levels][0], res[levels][1]
            tx1, ty1 = res[levels][2], res[levels][3]
            bx0 = _ceil(tx0 - (xob << lvl), 1 << (lvl + 1))
            by0 = _ceil(ty0 - (yob << lvl), 1 << (lvl + 1))
            bx1 = _ceil(tx1 - (xob << lvl), 1 << (lvl + 1))
            by1 = _ceil(ty1 - (yob << lvl), 1 << (lvl + 1))
            out.append((r, b, bx0, by0, bx1, by1,
                        (lo[2] - lo[0]) if xob else 0,
                        (lo[3] - lo[1]) if yob else 0))
    return out


# ------------------------------------------------------------ tier 2

class _Bits:
    """A packet header's bits: after 0xFF a byte holds 7 (opj_bio)."""

    def __init__(self):
        self.bits = []

    def put(self, v, n=1):
        self.bits.extend((v >> i) & 1 for i in range(n - 1, -1, -1))

    def bytes(self):
        out, cur, ct = bytearray(), 0, 8
        for b in self.bits:
            if ct == 0:
                out.append(cur)
                ct, cur = (7 if cur == 0xFF else 8), 0
            ct -= 1
            cur |= b << ct
        out.append(cur)
        if cur == 0xFF:
            out.append(0)
        return bytes(out)


class _TagTree:
    def __init__(self, w, h, values):
        self.parent = []
        sizes = [(w, h)]
        while sizes[-1][0] * sizes[-1][1] > 1:
            sw, sh = sizes[-1]
            sizes.append(((sw + 1) // 2, (sh + 1) // 2))
        base = 0
        for li, (sw, sh) in enumerate(sizes):
            nxt = base + sw * sh
            for j in range(sh):
                for i in range(sw):
                    self.parent.append(
                        nxt + (j // 2) * sizes[li + 1][0] + i // 2
                        if li + 1 < len(sizes) else -1)
            base = nxt
        self.value = [1 << 30] * len(self.parent)
        for k, v in enumerate(values):
            n = k
            while n >= 0:
                self.value[n] = min(self.value[n], v)
                n = self.parent[n]
        self.low = [0] * len(self.parent)
        self.known = [False] * len(self.parent)

    def encode(self, bits, leaf, threshold):
        stk, node = [], leaf
        while self.parent[node] >= 0:
            stk.append(node)
            node = self.parent[node]
        low = 0
        while True:
            low = max(low, self.low[node])
            while low < threshold:
                if low >= self.value[node]:
                    if not self.known[node]:
                        bits.put(1)
                        self.known[node] = True
                    break
                bits.put(0)
                low += 1
            self.low[node] = low
            if not stk:
                break
            node = stk.pop()


def _numpasses(bits, n):
    if n == 1:
        bits.put(0, 1)
    elif n == 2:
        bits.put(2, 2)
    elif n <= 5:
        bits.put(0xC | (n - 3), 4)
    elif n <= 36:
        bits.put(0x1E0 | (n - 6), 9)
    else:
        bits.put(0xFF80 | (n - 37), 16)


class _Segments:
    """OpenJPEG's segments of one code-block (opj_t2_init_seg and the HT
    branch of opj_t2_read_packet_header): where a packet's passes go."""

    def __init__(self, style):
        self.style, self.segs = style, []  # [numpasses, maxpasses]

    def _init(self, first):
        if self.style & 4:
            mx = 1
        elif self.style & 1:
            prev = self.segs[-1][1] if self.segs else 0
            mx = 10 if first else (2 if prev in (1, 10) else 1)
        else:
            mx = 109
        self.segs.append([0, mx])

    def split(self, n):
        """[(segment index, passes)] of a packet's n new passes."""
        if not self.segs:
            self._init(True)
            segno = 0
        else:
            segno = len(self.segs) - 1
            if self.segs[segno][0] == self.segs[segno][1]:
                self._init(False)
                segno += 1
        out = []
        while n > 0:
            k = 1 if segno == 0 else n
            out.append((segno, k))
            self.segs[segno][0] += k
            n -= k
            if n > 0:
                self._init(False)
                segno += 1
        return out


# ------------------------------------------------------------- encode

def _quant_97(step, prec):
    """(expn, mant, the step the decoder applies) of a wanted step."""
    e = int(np.floor(np.log2(step)))
    mant = min(2047, max(0, int(round((step / 2.0 ** e - 1) * 2048))))
    return prec - e, mant, (1 + mant / 2048) * 2.0 ** e


def encode(img, *, levels=2, reversible=True, mct=None, cblk=(64, 64),
           tile=None, offset=(0, 0), layers=1, progression="LRCP",
           precision=8, signed=False, step=1.0, guard=2, plane=0, style=0,
           jp2=False, enumcs=None, cap=True, cpf=None, sop=False, eph=False,
           layer_of=None, refine=None, rng=None, used=None,
           include_empty=False, mutate=None, zero_planes=None):
    """The HTJ2K file of ``img`` (uint8 / uint16, 2-D or H x W x C).

    ``levels`` decompositions of the 5/3 (``reversible``) or the 9/7 of
    steps ``step`` (a number, or a function of (resolution, band) giving
    one) with ``guard`` guard bits; ``mct`` RCT or ICT on 3 components or
    more (default where there are 3 or more); ``cblk`` (w, h); ``tile``
    (w, h) from the grid's origin; ``offset`` (x0, y0) of the image on the
    grid; ``progression`` by name; ``precision`` bits, ``signed`` samples
    (the image's values taken as two's complement in ``precision`` bits);
    ``plane``: the cleanup pass's bit-plane (0: every bit); ``style``: the
    code-block style's other bits (bit 6 is always set); ``jp2``: a JP2
    file (a colr box of ``enumcs``, sRGB or gray by default); ``cap``,
    ``cpf`` (its Pcpf, None for none) the markers; ``sop`` / ``eph``
    markers; ``layers`` quality layers, ``layer_of(block)`` the layer of
    each code-block's cleanup pass (by its index in packet order within
    its precinct and band: (tile, component, resolution, band, index);
    round robin by default); ``refine(block, rng)`` -> None or (passes,
    bytes, later): SigProp and MagRef bytes of 1 or 2 passes added after
    the cleanup pass, in its layer or (``later``) the next; ``rng`` (a
    random.Random) picks codewords at random and ``used`` collects them
    (cleanup_pass); ``include_empty``: code-blocks of no significant
    sample are included too; ``mutate(block, bytes)`` -> bytes rewrites a
    code-block's cleanup segment; ``zero_planes(block, z)`` -> z changes
    the zero bit-planes its packet header gives."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, nc = img.shape
    ox, oy = offset
    x1, y1 = ox + w, oy + h
    tdx, tdy = tile if tile else (x1, y1)
    mct = (nc >= 3) if mct is None else mct
    style |= 0x40
    xcb, ycb = cblk[0].bit_length() - 1, cblk[1].bit_length() - 1
    assert 1 << xcb == cblk[0] and 1 << ycb == cblk[1]
    assert 2 <= xcb <= 10 and 2 <= ycb <= 10 and xcb + ycb <= 12
    prog = PROGRESSIONS.index(progression)
    comps = img.astype(np.int64)
    if signed:
        comps = np.where(comps >= 1 << (precision - 1),
                         comps - (1 << precision), comps)
    else:
        comps = comps - (1 << (precision - 1))
    if mct and nc >= 3:
        r, g, b = comps[:, :, 0], comps[:, :, 1], comps[:, :, 2]
        if reversible:
            first = [(r + 2 * g + b) >> 2, b - g, r - g]
        else:
            r, g, b = r.astype(float), g.astype(float), b.astype(float)
            first = [0.299 * r + 0.587 * g + 0.114 * b,
                     -0.16875 * r - 0.33126 * g + 0.5 * b,
                     0.5 * r - 0.41869 * g - 0.08131 * b]
        planes = first + [comps[:, :, c] for c in range(3, nc)]
    else:
        planes = [comps[:, :, c] for c in range(nc)]
    nbands = 3 * levels + 1
    step_of = step if callable(step) else (lambda r, b: step)
    qcd = []
    applied = []
    if not reversible:
        for r in range(levels + 1):
            for b in ((0,) if r == 0 else (1, 2, 3)):
                expn, mant, st = _quant_97(step_of(r, b), precision)
                qcd.append((expn, mant))
                applied.append(st)
    # every tile's code-blocks: their coded bytes and zero bit-planes
    ntx, nty = _ceil(x1, tdx), _ceil(y1, tdy)
    tiles = []
    coefs = {}
    for ty in range(nty):
        for tx in range(ntx):
            rect = (max(tx * tdx, ox), max(ty * tdy, oy),
                    min((tx + 1) * tdx, x1), min((ty + 1) * tdy, y1))
            if rect[0] >= rect[2] or rect[1] >= rect[3]:
                continue
            tw, th = rect[2] - rect[0], rect[3] - rect[1]
            tc = []
            for c in range(nc):
                part = planes[c][rect[1] - oy:rect[3] - oy,
                                 rect[0] - ox:rect[2] - ox]
                a = np.array(part, dtype=np.int64 if reversible else float)
                res = forward_dwt(a, rect, levels, reversible)
                for rr in res:
                    assert rr[2] > rr[0] and rr[3] > rr[1], (
                        "every resolution of every tile must be non-empty")
                tc.append((a, res))
            tiles.append((ty * ntx + tx, rect, tc))
            coefs[ty * ntx + tx] = tc
    # the quantised bands and the largest magnitude of each band index
    qbands = {}
    maxbits = [0] * nbands
    for tno, rect, tc in tiles:
        for c, (a, res) in enumerate(tc):
            for k, (r, b, bx0, by0, bx1, by1, ax, ay) in enumerate(bands(res)):
                blk = a[ay:ay + by1 - by0, ax:ax + bx1 - bx0]
                if reversible:
                    q = blk.astype(np.int64)
                else:
                    q = (np.floor(np.abs(blk) / applied[k]).astype(np.int64)
                         * np.where(blk < 0, -1, 1))
                qbands[tno, c, k] = q
                m = int(np.abs(q).max(initial=0)) >> plane
                maxbits[k] = max(maxbits[k], m.bit_length())
    if reversible:
        expns = [max(max(mb, 1) + plane + 1 - guard, 0) for mb in maxbits]
        qcd = [(e, 0) for e in expns]
    mbs = [e + guard - 1 for e, _ in qcd]
    # the zero bit-planes the packet headers give (Mb - 1 - plane):
    # OpenJPEG's HT decoder puts the cleanup pass's bit-plane at Mb - 1 -
    # that, and takes every U_q up to Mb - plane + 1
    for k, mb in enumerate(mbs):
        assert max(maxbits[k], 1) + plane <= mb <= 30, (k, maxbits[k], mb)
    # tier 1 and the code-blocks of each precinct (one a resolution)
    prec_blocks = {}
    rnd = rng
    for tno, rect, tc in tiles:
        for c, (a, res) in enumerate(tc):
            for k, (r, b, bx0, by0, bx1, by1, ax, ay) in enumerate(bands(res)):
                cbw = min(xcb, 15 if r == 0 else 14)
                cbh = min(ycb, 15 if r == 0 else 14)
                q = qbands[tno, c, k]
                if bx1 <= bx0 or by1 <= by0:  # an empty band: no packet part
                    prec_blocks[tno, c, r, b] = (0, 0, [])
                    continue
                gx0, gy0 = (bx0 >> cbw) << cbw, (by0 >> cbh) << cbh
                cw = _ceil(bx1, 1 << cbw) - (bx0 >> cbw)
                ch = _ceil(by1, 1 << cbh) - (by0 >> cbh)
                blocks = []
                for j in range(ch):
                    for i in range(cw):
                        cx0 = max(gx0 + (i << cbw), bx0)
                        cy0 = max(gy0 + (j << cbh), by0)
                        cx1 = min(gx0 + ((i + 1) << cbw), bx1)
                        cy1 = min(gy0 + ((j + 1) << cbh), by1)
                        part = q[cy0 - by0:cy1 - by0, cx0 - bx0:cx1 - bx0]
                        key = (tno, c, r, b, len(blocks))
                        if not include_empty and not (
                                np.abs(part) >> plane).any():
                            blocks.append(None)
                            continue
                        data = cleanup_pass(part, plane, rnd, used)
                        if mutate:
                            data = mutate(key, data)
                        extra = refine(key, rnd) if refine else None
                        layer = (layer_of(key) if layer_of else
                                 len(blocks) % layers)
                        z = mbs[k] - 1 - plane
                        blocks.append(dict(cleanup=data, extra=extra,
                                           layer=layer, z=zero_planes(key, z)
                                           if zero_planes else z))
                prec_blocks[tno, c, r, b] = (cw, ch, blocks)

    def body(m, data):
        return struct.pack(">HH", m, len(data) + 2) + data

    # tier 2: the packets of each tile in its progression
    out_tiles = []
    for tno, rect, tc in tiles:
        state = {}
        for c in range(nc):
            for r in range(levels + 1):
                for b in ((0,) if r == 0 else (1, 2, 3)):
                    cw, ch, blocks = prec_blocks[tno, c, r, b]
                    if not blocks:
                        continue
                    first = [bl["layer"] if bl else layers for bl in blocks]
                    state[c, r, b] = dict(
                        blocks=blocks, cw=cw, ch=ch,
                        incl=_TagTree(cw, ch, first),
                        imsb=_TagTree(cw, ch, [bl["z"] if bl else 0
                                               for bl in blocks]),
                        lenbits=[3] * len(blocks), first=first,
                        segs=[_Segments(style) for _ in blocks])

        def contribution(bl, layer):
            """(passes, [bytes of each segment piece]) a block brings to
            ``layer``."""
            pieces = []
            if bl["layer"] == layer:
                pieces.append((1, bl["cleanup"]))
            ex = bl["extra"]
            if ex and (bl["layer"] + (1 if ex[2] else 0)) == layer:
                pieces.append((ex[0], ex[1]))
            return pieces

        def packet(layer, r, c):
            bits = _Bits()
            bodies = bytearray()
            bkeys = [(c, r, b) for b in ((0,) if r == 0 else (1, 2, 3))
                     if (c, r, b) in state]
            any_data = any(contribution(bl, layer)
                           for key in bkeys for bl in state[key]["blocks"]
                           if bl)
            if not any_data:
                bits.put(0)
            else:
                bits.put(1)
                for key in bkeys:
                    st = state[key]
                    for i, bl in enumerate(st["blocks"]):
                        pieces = contribution(bl, layer) if bl else []
                        if st["first"][i] >= layer:
                            st["incl"].encode(bits, i, layer + 1)
                        else:
                            bits.put(1 if pieces else 0)
                        if not pieces:
                            continue
                        if st["first"][i] == layer:
                            st["imsb"].encode(bits, i, 1 << 20)
                        n = sum(p for p, _ in pieces)
                        _numpasses(bits, n)
                        split = st["segs"][i].split(n)
                        # the bytes of each OpenJPEG segment: the cleanup
                        # pass alone where it is in this packet, then the
                        # refinement bytes; where OpenJPEG gives the
                        # cleanup's segment one more pass in a later packet
                        # that piece is empty, unless it is the only one
                        chunks = [d for _, d in pieces]
                        if len(split) > len(chunks):
                            chunks = [b""] * (len(split) - len(chunks)) + chunks
                        lens, data = [], bytearray()
                        for (segno, k), piece in zip(split, chunks):
                            lens.append((len(piece), k))
                            data += piece
                        assert len(chunks) == len(split), (split, len(pieces))
                        need = max(max(0, ln.bit_length()
                                       - (k.bit_length() - 1))
                                   for ln, k in lens)
                        inc = max(0, need - st["lenbits"][i])
                        bits.put((1 << (inc + 1)) - 2, inc + 1)
                        st["lenbits"][i] += inc
                        for ln, k in lens:
                            bits.put(ln, st["lenbits"][i] + k.bit_length()
                                     - 1)
                        bodies += data
            head = bits.bytes()
            if eph:
                head += b"\xff\x92"
            return head, bytes(bodies)

        order = {"LRCP": [(l, r, c) for l in range(layers)
                          for r in range(levels + 1) for c in range(nc)],
                 "RLCP": [(l, r, c) for r in range(levels + 1)
                          for l in range(layers) for c in range(nc)],
                 "RPCL": [(l, r, c) for r in range(levels + 1)
                          for c in range(nc) for l in range(layers)],
                 "PCRL": [(l, r, c) for c in range(nc)
                          for r in range(levels + 1) for l in range(layers)],
                 "CPRL": [(l, r, c) for c in range(nc)
                          for r in range(levels + 1) for l in range(layers)]}
        data = bytearray()
        for n, (l, r, c) in enumerate(order[progression]):
            head, bd = packet(l, r, c)
            if sop:
                data += struct.pack(">HHH", 0xFF91, 4, n & 0xFFFF)
            data += head + bd
        out_tiles.append((tno, bytes(data)))
    # the main header
    rsiz = RSIZ_CAP if cap else 0
    siz = struct.pack(">HIIIIIIIIH", rsiz, x1, y1, ox, oy, tdx, tdy, 0, 0,
                      nc) + bytes([(0x80 if signed else 0) | (precision - 1),
                                   1, 1] * nc)
    scod = (2 if sop else 0) | (4 if eph else 0)
    cod = struct.pack(">BBHBBBBBB", scod, prog, layers, int(mct and nc >= 3),
                      levels, xcb - 2, ycb - 2, style, int(reversible))
    if reversible:
        qbody = bytes([guard << 5]) + bytes(e << 3 for e, _ in qcd)
    else:
        qbody = bytes([guard << 5 | 2]) + b"".join(
            struct.pack(">H", e << 11 | m) for e, m in qcd)
    main = b"\xff\x4f" + body(0xFF51, siz)
    if cap:
        main += body(0xFF50, CAP_BODY)
    main += body(0xFF52, cod) + body(0xFF5C, qbody)
    if cpf is not None:
        main += body(0xFF59, struct.pack(">H", cpf))
    cs = bytearray(main)
    for tno, data in out_tiles:
        cs += struct.pack(">HHHIBB", 0xFF90, 10, tno, 14 + len(data), 0, 1)
        cs += b"\xff\x93" + data
    cs += b"\xff\xd9"
    if not jp2:
        return bytes(cs)
    if enumcs is None:
        enumcs = 17 if nc <= 2 else 16

    def box(kind, payload):
        return struct.pack(">I4s", 8 + len(payload), kind) + payload
    bpc = (0x80 if signed else 0) | (precision - 1)
    head = (box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))
            + box(b"colr", struct.pack(">BBBI", 1, 0, 0, enumcs)))
    return (box(b"jP  ", b"\r\n\x87\n") + box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + box(b"jp2h", head) + box(b"jp2c", bytes(cs)))


def random_refine(passes=(1, 2), length=(1, 12), later=0.0):
    """A ``refine`` for encode: 1 or 2 SigProp / MagRef passes of seeded
    random bytes for every code-block, in the cleanup's layer or (with
    probability ``later``) the next."""
    def refine(key, rng):
        r = rng or random.Random(hash(key))
        n = r.randint(*length)
        return (r.choice(passes), bytes(r.randrange(256) for _ in range(n)),
                r.random() < later)
    return refine
