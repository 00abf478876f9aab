// jpeg.cpp — the port's JPEG codec, with no codec library behind it.
//
// Decode follows libjpeg-turbo's default decompression, which is what
// cv2.imread runs: baseline, extended and progressive Huffman scans
// (jdhuff.c, jdphuff.c) with restart intervals, the islow integer IDCT
// (jidctint.c), fancy upsampling (jdsample.c: the h2v1, h1v2 and h2v2
// triangle filters, plain replication for other integral factors) and
// the fixed-point YCbCr->RGB tables (jdcolor.c); one component is gray
// replicated to RGB; an Adobe APP14 transform flag 0 means RGB. EXIF
// orientation from the first APP1 is applied as cv2.imread applies it.
// Arithmetic coding, other precisions than 8 bits, lossless and
// hierarchical JPEG, 4-component CMYK/YCCK and incomplete progressive data
// (which libjpeg block-smooths) return a Status that names the feature; a
// truncated or corrupt stream returns kUnreadable.
//
// Encode writes what cv2.imwrite writes at its defaults, which are
// libjpeg-turbo's jpeg_set_defaults + jpeg_set_quality(95): a JFIF APP0,
// the Annex K tables scaled to quality 95, 4:2:0 (h2v2_downsample's
// alternating bias after edge replication, jcsample.c / jcprepct.c),
// fixed-point RGB->YCbCr (jccolor.c), the islow FDCT (jfdctint.c),
// quantisation by libjpeg-turbo's reciprocals (jcdctmgr.c), the standard
// Huffman tables, dummy blocks at the right and bottom edges as
// jccoefct.c makes them, 0xFF stuffing and 1-bit padding, then EOI.

#include <algorithm>
#include <cstring>

#include "codec.h"

namespace tsrio {
namespace {

// Zigzag position -> natural (row-major) index, with 16 guard entries so
// that a corrupt run past 63 lands on 63 (libjpeg's jpeg_natural_order).
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

inline int clamp255(int64_t v) {
  return v < 0 ? 0 : (v > 255 ? 255 : static_cast<int>(v));
}

inline uint16_t be16(const uint8_t* p) {
  return static_cast<uint16_t>((p[0] << 8) | p[1]);
}

// ------------------------------------------------------------- EXIF

}  // namespace

int tiff_orientation(const uint8_t* t, size_t n) {
  if (n < 8) return 1;
  bool le;
  if (t[0] == 'I' && t[1] == 'I') le = true;
  else if (t[0] == 'M' && t[1] == 'M') le = false;
  else return 1;
  auto u16 = [&](size_t o) -> uint32_t {
    return le ? (t[o] | (t[o + 1] << 8)) : ((t[o] << 8) | t[o + 1]);
  };
  auto u32 = [&](size_t o) -> uint32_t {
    return le ? (t[o] | (t[o + 1] << 8) | (t[o + 2] << 16) |
                 (static_cast<uint32_t>(t[o + 3]) << 24))
              : ((static_cast<uint32_t>(t[o]) << 24) | (t[o + 1] << 16) |
                 (t[o + 2] << 8) | t[o + 3]);
  };
  if (u16(2) != 42) return 1;
  const size_t ifd = u32(4);
  if (ifd + 2 > n) return 1;
  const size_t count = u16(ifd);
  for (size_t i = 0; i < count; i++) {
    const size_t e = ifd + 2 + 12 * i;
    if (e + 12 > n) break;
    if (u16(e) == 0x0112) {
      const int v = static_cast<int>(u16(e + 8));
      return v >= 1 && v <= 8 ? v : 1;
    }
  }
  return 1;
}

// cv2's ApplyExifOrientation: 2 flips the columns, 3 both axes, 4 the
// rows; 5-8 transpose first, then 6 flips the columns, 7 both, 8 the rows.
void apply_orientation(Image& img, int o) {
  if (o <= 1 || o > 8) return;
  const bool transpose = o >= 5;
  const bool flip_x = o == 2 || o == 3 || o == 6 || o == 7;
  const bool flip_y = o == 3 || o == 4 || o == 7 || o == 8;
  const int oh = transpose ? img.w : img.h, ow = transpose ? img.h : img.w;
  std::vector<uint8_t> out(img.rgb.size());
  for (int y = 0; y < oh; y++) {
    const int ty = flip_y ? oh - 1 - y : y;
    for (int x = 0; x < ow; x++) {
      const int tx = flip_x ? ow - 1 - x : x;
      const int sy = transpose ? tx : ty, sx = transpose ? ty : tx;
      std::memcpy(&out[(static_cast<size_t>(y) * ow + x) * 3],
                  &img.rgb[(static_cast<size_t>(sy) * img.w + sx) * 3], 3);
    }
  }
  img.rgb.swap(out);
  img.w = ow;
  img.h = oh;
}

namespace {

// ------------------------------------------------------------ decode

struct Huffman {
  bool defined = false;
  // codes of up to kFast bits: length (0 = longer) and symbol by prefix
  static constexpr int kFast = 9;
  uint8_t fast_len[1 << kFast];
  uint8_t fast_sym[1 << kFast];
  int32_t maxcode[18];    // largest code of each length, -1 for none
  int32_t valoffset[18];  // symbol index of a code of each length, - code
  uint8_t vals[256];
};

// Builds the decode tables of a DHT's counts and symbols (jdhuff.c's
// jpeg_make_d_derived_tbl); false where the counts overflow a length, as
// libjpeg refuses them.
bool build_huffman(const uint8_t* counts, const uint8_t* vals, int nvals,
                   Huffman& t) {
  std::memset(t.fast_len, 0, sizeof(t.fast_len));
  std::memcpy(t.vals, vals, nvals);
  int code = 0, k = 0;
  for (int len = 1; len <= 16; len++) {
    // no code may be all ones, so a length's codes end below 2^len
    if (counts[len - 1] && code + counts[len - 1] >= (1 << len)) return false;
    t.valoffset[len] = k - code;
    for (int i = 0; i < counts[len - 1]; i++, k++, code++) {
      if (len <= Huffman::kFast) {
        const int shift = Huffman::kFast - len;
        for (int f = 0; f < (1 << shift); f++) {
          t.fast_len[(code << shift) | f] = static_cast<uint8_t>(len);
          t.fast_sym[(code << shift) | f] = vals[k];
        }
      }
    }
    t.maxcode[len] = counts[len - 1] ? code - 1 : -1;
    code <<= 1;
  }
  t.maxcode[17] = 0x7fffffff;
  t.defined = true;
  return true;
}

// The entropy-coded bits of a scan: 0xFF00 unstuffed; at a marker or the
// end of the data it feeds zeros, as libjpeg does, and counts them, so a
// decode that consumed any of them was truncated.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;  // bits at the top
  int n = 0;         // bits held
  int fake = 0;      // of those, zeros fed past the data (the last ones)
  bool at_marker = false;

  void fill() {
    while (n <= 56) {
      uint64_t b = 0;
      if (!at_marker && p < end) {
        if (*p == 0xFF) {
          if (p + 1 < end && p[1] == 0) {
            b = 0xFF;
            p += 2;
          } else {
            at_marker = true;  // p stays on the marker's 0xFF
            fake += 8;
          }
        } else {
          b = *p++;
        }
      } else {
        fake += 8;
      }
      acc |= b << (56 - n);
      n += 8;
    }
  }
  int get(int k) {
    if (k == 0) return 0;
    if (n < k) fill();
    const int v = static_cast<int>(acc >> (64 - k));
    acc <<= k;
    n -= k;
    return v;
  }
  int decode(const Huffman& t) {
    if (n < 16) fill();
    const uint32_t peek = static_cast<uint32_t>(acc >> 48);
    const uint32_t f = peek >> (16 - Huffman::kFast);
    int len = t.fast_len[f];
    int sym;
    if (len) {
      sym = t.fast_sym[f];
    } else {
      len = Huffman::kFast + 1;
      while (len <= 16 &&
             static_cast<int32_t>(peek >> (16 - len)) > t.maxcode[len])
        len++;
      if (len > 16) return -1;  // no code: corrupt data
      sym = t.vals[(peek >> (16 - len)) + t.valoffset[len]];
    }
    acc <<= len;
    n -= len;
    return sym;
  }
  bool overrun() const { return n < fake; }
  // Drops the bits held and steps onto the next marker; returns its code
  // (0 where the data ends first) and leaves p after it.
  int next_marker() {
    acc = 0;
    n = fake = 0;
    at_marker = false;
    while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0 && p[1] != 0xFF)) p++;
    if (p + 1 >= end) return 0;
    const int m = p[1];
    p += 2;
    return m;
  }
};

// The feature a frame or table marker names that this decoder does not
// implement, kOk for the rest.
int marker_feature(int m) {
  if (m == 0xC3) return kLossless;
  if (m == 0xC5 || m == 0xC6 || m == 0xC7 || m == 0xDE || m == 0xDF)
    return kHierarchical;
  if (m >= 0xC9 && m <= 0xCF) return kArithmetic;  // SOF9-15 and DAC
  return kOk;
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;     // the current scan's DC and AC tables
  int gw = 0, gh = 0;     // blocks of the MCU grid
  int wib = 0, hib = 0;   // blocks holding image data (width_in_blocks)
  int dw = 0, dh = 0;     // samples of image data (downsampled_width)
  bool latched = false;   // quantisation table copied at its first scan
  uint16_t q[64];         // natural order
  int bits[64];           // progressive: lowest bit known, -1 none yet
  std::vector<int16_t> coef;  // [gh][gw][64]
};

struct Decoder {
  const uint8_t* data;
  size_t size;
  size_t pos = 2;
  uint16_t qt[4][64];
  bool qt_defined[4] = {};
  Huffman dc[4], ac[4];
  Component comp[4];
  int ncomp = 0, width = 0, height = 0, maxh = 1, maxv = 1;
  int mcux = 0, mcuy = 0;
  bool progressive = false, have_frame = false;
  int restart = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  int orientation = 1;
  bool saw_app1 = false;

  // marker segment at pos (after the marker code): its payload
  bool segment(const uint8_t*& seg, size_t& len) {
    if (pos + 2 > size) return false;
    const size_t l = be16(data + pos);
    if (l < 2 || pos + l > size) return false;
    seg = data + pos + 2;
    len = l - 2;
    pos += l;
    return true;
  }

  int read_dqt(const uint8_t* s, size_t len) {
    size_t o = 0;
    while (o < len) {
      const int pq = s[o] >> 4, tq = s[o] & 15;
      if (tq > 3 || pq > 1) return kUnreadable;
      const size_t need = 1 + 64 * (pq + 1);
      if (o + need > len) return kUnreadable;
      for (int k = 0; k < 64; k++)
        qt[tq][kNatural[k]] = pq ? be16(s + o + 1 + 2 * k) : s[o + 1 + k];
      qt_defined[tq] = true;
      o += need;
    }
    return kOk;
  }

  int read_dht(const uint8_t* s, size_t len) {
    size_t o = 0;
    while (o < len) {
      if (o + 17 > len) return kUnreadable;
      const int tc = s[o] >> 4, th = s[o] & 15;
      if (tc > 1 || th > 3) return kUnreadable;
      int nvals = 0;
      for (int i = 0; i < 16; i++) nvals += s[o + 1 + i];
      if (nvals > 256 || o + 17 + nvals > len) return kUnreadable;
      Huffman& t = tc ? ac[th] : dc[th];
      if (!build_huffman(s + o + 1, s + o + 17, nvals, t))
        return kUnreadable;
      o += 17 + nvals;
    }
    return kOk;
  }

  int read_sof(const uint8_t* s, size_t len) {
    if (have_frame || len < 6) return kUnreadable;
    if (s[0] != 8) return kPrecision;
    height = be16(s + 1);
    width = be16(s + 3);
    ncomp = s[5];
    if (ncomp == 4) return kCmyk;
    if (ncomp != 1 && ncomp != 3) return kComponents;
    if (len < 6 + 3 * static_cast<size_t>(ncomp) || width == 0 ||
        height == 0 || static_cast<int64_t>(width) * height > (64LL << 20))
      return kUnreadable;  // height 0 needs DNL, which libjpeg refuses
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        return kUnreadable;
      maxh = std::max(maxh, c.h);
      maxv = std::max(maxv, c.v);
    }
    mcux = (width + 8 * maxh - 1) / (8 * maxh);
    mcuy = (height + 8 * maxv - 1) / (8 * maxv);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      if (maxh % c.h || maxv % c.v) return kUnreadable;  // fractional
      c.dw = (width * c.h + maxh - 1) / maxh;
      c.dh = (height * c.v + maxv - 1) / maxv;
      c.wib = (c.dw + 7) / 8;
      c.hib = (c.dh + 7) / 8;
      c.gw = mcux * c.h;
      c.gh = mcuy * c.v;
      c.coef.assign(static_cast<size_t>(c.gw) * c.gh * 64, 0);
      for (int& b : c.bits) b = -1;
    }
    have_frame = true;
    return kOk;
  }

  void read_app(int marker, const uint8_t* s, size_t len) {
    if (marker == 0xE0 && len >= 14 && !std::memcmp(s, "JFIF\0", 5)) {
      jfif = true;
    } else if (marker == 0xEE && len >= 12 && !std::memcmp(s, "Adobe", 5)) {
      adobe = true;
      adobe_transform = s[11];
    } else if (marker == 0xE1 && !saw_app1) {
      // cv2 reads the first APP1 only, EXIF or not
      saw_app1 = true;
      if (len >= 6 && !std::memcmp(s, "Exif\0\0", 6))
        orientation = tiff_orientation(s + 6, len - 6);
    }
  }

  // Reads markers up to the first SOS (its code left unread) or EOI.
  // Returns kOk at an SOS, a Status otherwise.
  int read_headers() {
    while (true) {
      // extraneous bytes before a marker are skipped, as libjpeg does
      while (pos < size && data[pos] != 0xFF) pos++;
      while (pos < size && data[pos] == 0xFF) pos++;  // fill bytes
      if (pos >= size) return kUnreadable;
      const int m = data[pos++];
      if (m == 0xDA) return have_frame ? kOk : kUnreadable;
      if (m == 0xD9) return kUnreadable;  // EOI before any scan
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      const uint8_t* s;
      size_t len;
      if (marker_feature(m) != kOk) return marker_feature(m);
      if (!segment(s, len)) return kUnreadable;
      int st = kOk;
      switch (m) {
        case 0xC0: case 0xC1: st = read_sof(s, len); break;
        case 0xC2: progressive = true; st = read_sof(s, len); break;
        case 0xC4: st = read_dht(s, len); break;
        case 0xDB: st = read_dqt(s, len); break;
        case 0xDD:
          if (len < 2) return kUnreadable;
          restart = be16(s);
          break;
        default:
          if (m >= 0xE0 && m <= 0xEF) read_app(m, s, len);
          break;  // COM and the rest: skipped
      }
      if (st != kOk) return st;
    }
  }

  // ---- one scan

  struct Scan {
    int n = 0;
    Component* c[4];
    int ss = 0, se = 63, ah = 0, al = 0;
  };

  int read_sos(Scan& sc) {
    const uint8_t* s;
    size_t len;
    if (!segment(s, len) || len < 1) return kUnreadable;
    sc.n = s[0];
    if (sc.n < 1 || sc.n > ncomp || len < 4 + 2 * static_cast<size_t>(sc.n))
      return kUnreadable;
    for (int i = 0; i < sc.n; i++) {
      const int id = s[1 + 2 * i];
      Component* found = nullptr;
      for (int k = 0; k < ncomp; k++)
        if (comp[k].id == id) found = &comp[k];
      if (!found) return kUnreadable;
      found->td = s[2 + 2 * i] >> 4;
      found->ta = s[2 + 2 * i] & 15;
      if (found->td > 3 || found->ta > 3) return kUnreadable;
      sc.c[i] = found;
    }
    const uint8_t* t = s + 1 + 2 * sc.n;
    sc.ss = t[0];
    sc.se = t[1];
    sc.ah = t[2] >> 4;
    sc.al = t[2] & 15;
    int blocks = 0;
    for (int i = 0; i < sc.n; i++) blocks += sc.c[i]->h * sc.c[i]->v;
    if (sc.n > 1 && blocks > 10) return kUnreadable;
    if (progressive) {
      if (sc.ss == 0 ? sc.se != 0 : (sc.se < sc.ss || sc.se > 63 ||
                                     sc.n != 1))
        return kUnreadable;
      if (sc.al > 13 || (sc.ah && sc.ah != sc.al + 1)) return kUnreadable;
    } else if (sc.ss != 0 || sc.ah != 0 || sc.al != 0 || sc.se != 63) {
      return kUnreadable;
    }
    for (int i = 0; i < sc.n; i++) {
      Component& c = *sc.c[i];
      if (!c.latched) {  // jdinput.c latch_quant_tables
        if (!qt_defined[c.tq]) return kUnreadable;
        std::memcpy(c.q, qt[c.tq], sizeof(c.q));
        c.latched = true;
      }
      const bool dc_first = !progressive || (sc.ss == 0 && sc.ah == 0);
      if (dc_first && !dc[c.td].defined) return kUnreadable;
      if ((!progressive || sc.ss > 0) && !ac[c.ta].defined)
        return kUnreadable;
    }
    return kOk;
  }

  // libjpeg's coef_bits: the lowest bit each coefficient has so far; an
  // incomplete set after the last scan means block smoothing.
  static void note_bits(const Scan& sc) {
    for (int i = 0; i < sc.n; i++)
      for (int k = sc.ss; k <= sc.se; k++) sc.c[i]->bits[k] = sc.al;
  }

  int decode_scan(const Scan& sc) {
    BitReader br;
    br.p = data + pos;
    br.end = data + size;
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    const bool single = sc.n == 1;
    const int cols = single ? sc.c[0]->wib : mcux;
    const int rows = single ? sc.c[0]->hib : mcuy;
    const long total = static_cast<long>(cols) * rows;
    int left = restart;
    for (long m = 0; m < total; m++) {
      if (restart && left == 0) {
        if (br.overrun()) return kUnreadable;
        const int mk = br.next_marker();
        if (mk < 0xD0 || mk > 0xD7) return kUnreadable;
        std::memset(pred, 0, sizeof(pred));
        eobrun = 0;
        left = restart;
      }
      left--;
      const int mr = static_cast<int>(m / cols), mc = static_cast<int>(m % cols);
      for (int i = 0; i < sc.n; i++) {
        Component& c = *sc.c[i];
        const int bh = single ? 1 : c.v, bw = single ? 1 : c.h;
        for (int by = 0; by < bh; by++)
          for (int bx = 0; bx < bw; bx++) {
            const int row = single ? mr : mr * c.v + by;
            const int col = single ? mc : mc * c.h + bx;
            int16_t* blk = c.coef.data() +
                           (static_cast<size_t>(row) * c.gw + col) * 64;
            int st;
            if (!progressive)
              st = block_sequential(br, blk, c, pred[i]);
            else if (sc.ss == 0)
              st = sc.ah == 0 ? dc_first(br, blk, c, pred[i], sc.al)
                              : dc_refine(br, blk, sc.al);
            else
              st = sc.ah == 0 ? ac_first(br, blk, c, sc, eobrun)
                              : ac_refine(br, blk, c, sc, eobrun);
            if (st != kOk) return st;
          }
      }
    }
    if (br.overrun()) return kUnreadable;  // truncated: out of scope
    // leave pos on the marker after the scan's data, or at the end of a
    // file that stops there without its EOI (libjpeg supplies one)
    pos = br.next_marker() ? static_cast<size_t>(br.p - data) - 2 : size;
    return kOk;
  }

  int block_sequential(BitReader& br, int16_t* blk, const Component& c,
                       int& pred) {
    int s = br.decode(dc[c.td]);
    if (s < 0 || s > 15) return kUnreadable;
    if (s) s = extend(br.get(s), s);
    pred += s;
    blk[0] = static_cast<int16_t>(pred);
    const Huffman& t = ac[c.ta];
    for (int k = 1; k < 64; k++) {
      const int rs = br.decode(t);
      if (rs < 0) return kUnreadable;
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    return kOk;
  }

  int dc_first(BitReader& br, int16_t* blk, const Component& c, int& pred,
               int al) {
    int s = br.decode(dc[c.td]);
    if (s < 0 || s > 15) return kUnreadable;
    if (s) s = extend(br.get(s), s);
    pred += s;
    blk[0] = static_cast<int16_t>(static_cast<unsigned>(pred) << al);
    return kOk;
  }

  int dc_refine(BitReader& br, int16_t* blk, int al) {
    if (br.get(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
    return kOk;
  }

  int ac_first(BitReader& br, int16_t* blk, const Component& c,
               const Scan& sc, int& eobrun) {
    if (eobrun > 0) {
      eobrun--;
      return kOk;
    }
    const Huffman& t = ac[c.ta];
    for (int k = sc.ss; k <= sc.se; k++) {
      const int rs = br.decode(t);
      if (rs < 0) return kUnreadable;
      int r = rs >> 4;
      const int s = rs & 15;
      if (s) {
        k += r;
        const int v = extend(br.get(s), s);
        blk[kNatural[k]] =
            static_cast<int16_t>(static_cast<unsigned>(v) << sc.al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.get(r);
        eobrun--;
        break;
      }
    }
    return kOk;
  }

  int ac_refine(BitReader& br, int16_t* blk, const Component& c,
                const Scan& sc, int& eobrun) {
    const int p1 = 1 << sc.al, m1 = -1 * (1 << sc.al);
    int k = sc.ss;
    const Huffman& t = ac[c.ta];
    auto correct = [&](int16_t& coef) {
      if (br.get(1) && (coef & p1) == 0)
        coef = static_cast<int16_t>(coef >= 0 ? coef + p1 : coef + m1);
    };
    if (eobrun == 0) {
      for (; k <= sc.se; k++) {
        const int rs = br.decode(t);
        if (rs < 0) return kUnreadable;
        int r = rs >> 4;
        int s = rs & 15;
        if (s) {
          if (s != 1) return kUnreadable;
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t& coef = blk[kNatural[k]];
          if (coef != 0) {
            correct(coef);
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= sc.se);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= sc.se; k++) {
        int16_t& coef = blk[kNatural[k]];
        if (coef != 0) correct(coef);
      }
      eobrun--;
    }
    return kOk;
  }

  int decode_all() {
    int st = read_headers();
    if (st != kOk) return st;
    while (true) {
      Scan sc;
      st = read_sos(sc);
      if (st != kOk) return st;
      if (progressive) note_bits(sc);
      st = decode_scan(sc);
      if (st != kOk) return st;
      // markers between scans, up to the next SOS or EOI (or the end)
      while (true) {
        while (pos < size && data[pos] != 0xFF) pos++;
        while (pos < size && data[pos] == 0xFF) pos++;
        if (pos >= size) return finish_check();
        const int m = data[pos++];
        if (m == 0xD9) return finish_check();
        if (m == 0xDA) break;
        if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
        const uint8_t* s;
        size_t len;
        if (!segment(s, len)) return kUnreadable;
        if (m == 0xC4) st = read_dht(s, len);
        else if (m == 0xDB) st = read_dqt(s, len);
        else if (m == 0xDD && len >= 2) restart = be16(s);
        else if (marker_feature(m) != kOk) return marker_feature(m);
        else if ((m >= 0xC0 && m <= 0xCF) || m == 0xDE || m == 0xDF)
          return kUnreadable;  // a second frame
        if (st != kOk) return st;
      }
    }
  }

  // After EOI: every component must have had a scan; a progressive file
  // whose DC or first nine ACs (SAVED_COEFS) still lack bits would be
  // block-smoothed by libjpeg (jdcoefct.c smoothing_ok).
  int finish_check() {
    for (int i = 0; i < ncomp; i++) {
      if (!comp[i].latched) return kUnreadable;
      if (!progressive) continue;
      if (comp[i].bits[0] < 0) return kUnreadable;
      for (int k = 1; k < 10; k++)
        if (comp[i].bits[k] != 0) return kSmoothing;
    }
    return kOk;
  }
};

// ---- islow IDCT (jidctint.c), one block into an 8x8 window of a plane

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433,
                  F0_765 = 6270, F0_899 = 7373, F1_175 = 9633,
                  F1_501 = 12299, F1_847 = 15137, F1_961 = 16069,
                  F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t{1} << (n - 1))) >> n;
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                size_t stride) {
  int64_t ws[64];  // libjpeg's JLONG arithmetic, no overflow
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int64_t* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
        !ip[56]) {
      const int64_t dc = int64_t{ip[0]} * qp[0] * (1 << kPass1Bits);
      for (int r = 0; r < 8; r++) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t{ip[16]} * qp[16], z3 = int64_t{ip[48]} * qp[48];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    z2 = int64_t{ip[0]} * qp[0];
    z3 = int64_t{ip[32]} * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t{ip[56]} * qp[56];
    tmp1 = int64_t{ip[40]} * qp[40];
    tmp2 = int64_t{ip[24]} * qp[24];
    tmp3 = int64_t{ip[8]} * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    wp[0] = descale(tmp10 + tmp3, sh);
    wp[56] = descale(tmp10 - tmp3, sh);
    wp[8] = descale(tmp11 + tmp2, sh);
    wp[48] = descale(tmp11 - tmp2, sh);
    wp[16] = descale(tmp12 + tmp1, sh);
    wp[40] = descale(tmp12 - tmp1, sh);
    wp[24] = descale(tmp13 + tmp0, sh);
    wp[32] = descale(tmp13 - tmp0, sh);
  }
  // libjpeg-turbo's SIMD IDCT saturates where jidctint.c's range_limit
  // table wraps; on data a real encoder writes the two agree
  for (int r = 0; r < 8; r++) {
    const int64_t* wp = ws + 8 * r;
    uint8_t* op = out + stride * r;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      const uint8_t v = static_cast<uint8_t>(
          clamp255(descale(wp[0], kPass1Bits + 3) + 128));
      std::memset(op, v, 8);
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    int64_t tmp0 = (wp[0] + wp[4]) * (1 << kConstBits);
    int64_t tmp1 = (wp[0] - wp[4]) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits + kPass1Bits + 3;
    op[0] = static_cast<uint8_t>(clamp255(descale(tmp10 + tmp3, sh) + 128));
    op[7] = static_cast<uint8_t>(clamp255(descale(tmp10 - tmp3, sh) + 128));
    op[1] = static_cast<uint8_t>(clamp255(descale(tmp11 + tmp2, sh) + 128));
    op[6] = static_cast<uint8_t>(clamp255(descale(tmp11 - tmp2, sh) + 128));
    op[2] = static_cast<uint8_t>(clamp255(descale(tmp12 + tmp1, sh) + 128));
    op[5] = static_cast<uint8_t>(clamp255(descale(tmp12 - tmp1, sh) + 128));
    op[3] = static_cast<uint8_t>(clamp255(descale(tmp13 + tmp0, sh) + 128));
    op[4] = static_cast<uint8_t>(clamp255(descale(tmp13 - tmp0, sh) + 128));
  }
}

// ---- upsampling (jdsample.c) of one component to the full-size plane

// `src` holds the component's samples with row stride `ss`; its data are
// c.dw x c.dh. Rows and columns past the data repeat the last ones, as
// jdmainct.c's context pointers and the filters' edge cases do.
void upsample(const Component& c, const uint8_t* src, size_t ss, int maxh,
              int maxv, int width, int height, uint8_t* dst) {
  const int hf = maxh / c.h, vf = maxv / c.v;
  const int dw = c.dw, dh = c.dh;
  auto at = [&](int r, int x) -> int {
    r = r < 0 ? 0 : (r >= dh ? dh - 1 : r);
    x = x < 0 ? 0 : (x >= dw ? dw - 1 : x);
    return src[ss * r + x];
  };
  if (hf == 2 && vf == 2 && dw > 2) {  // h2v2_fancy_upsample
    std::vector<int> cs(dw);
    for (int y = 0; y < height; y++) {
      const int r = y / 2, rn = (y & 1) ? r + 1 : r - 1;
      for (int j = 0; j < dw; j++) cs[j] = 3 * at(r, j) + at(rn, j);
      uint8_t* o = dst + static_cast<size_t>(y) * width;
      for (int x = 0; x < width; x++) {
        const int j = x / 2;
        if (x & 1) {
          const int jn = j + 1 < dw ? j + 1 : dw - 1;
          o[x] = static_cast<uint8_t>((3 * cs[j] + cs[jn] + 7) >> 4);
        } else {
          const int jn = j > 0 ? j - 1 : 0;
          o[x] = static_cast<uint8_t>((3 * cs[j] + cs[jn] + 8) >> 4);
        }
      }
    }
  } else if (hf == 2 && vf == 1 && dw > 2) {  // h2v1_fancy_upsample
    for (int y = 0; y < height; y++) {
      uint8_t* o = dst + static_cast<size_t>(y) * width;
      for (int x = 0; x < width; x++) {
        const int j = x / 2, s = 3 * at(y, j);
        o[x] = static_cast<uint8_t>(
            (x & 1) ? (s + at(y, j + 1) + 2) >> 2 : (s + at(y, j - 1) + 1) >> 2);
      }
    }
  } else if (hf == 1 && vf == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < height; y++) {
      const int r = y / 2;
      uint8_t* o = dst + static_cast<size_t>(y) * width;
      for (int x = 0; x < width; x++) {
        const int s = 3 * at(r, x);
        o[x] = static_cast<uint8_t>(
            (y & 1) ? (s + at(r + 1, x) + 2) >> 2 : (s + at(r - 1, x) + 1) >> 2);
      }
    }
  } else {  // fullsize, h2v1 / h2v2 on narrow data, int_upsample
    for (int y = 0; y < height; y++) {
      uint8_t* o = dst + static_cast<size_t>(y) * width;
      const uint8_t* row = src + ss * static_cast<size_t>(y / vf);
      for (int x = 0; x < width; x++) o[x] = row[x / hf];
    }
  }
}

struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {  // jdcolor.c build_ycc_rgb_table
    auto fix = [](double x) {
      return static_cast<int32_t>(x * 65536.0 + 0.5);
    };
    for (int i = 0; i < 256; i++) {
      const int32_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + 32768) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + 32768) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + 32768;
    }
  }
};

int decode_into(const uint8_t* data, size_t n, Image& img) {
  Decoder d;
  d.data = data;
  d.size = n;
  const int st = d.decode_all();
  if (st != kOk) return st;
  const int W = d.width, H = d.height;
  // each component: IDCT into its block grid's plane, then upsample
  std::vector<std::vector<uint8_t>> full(d.ncomp);
  for (int i = 0; i < d.ncomp; i++) {
    const Component& c = d.comp[i];
    const size_t stride = static_cast<size_t>(c.gw) * 8;
    std::vector<uint8_t> plane(stride * c.hib * 8);
    for (int by = 0; by < c.hib; by++)
      for (int bx = 0; bx < c.wib; bx++)
        idct_islow(c.coef.data() + (static_cast<size_t>(by) * c.gw + bx) * 64,
                   c.q, plane.data() + stride * by * 8 + bx * 8, stride);
    full[i].resize(static_cast<size_t>(W) * H);
    upsample(c, plane.data(), stride, d.maxh, d.maxv, W, H, full[i].data());
  }
  img.w = W;
  img.h = H;
  img.rgb.resize(static_cast<size_t>(W) * H * 3);
  const size_t npx = static_cast<size_t>(W) * H;
  uint8_t* o = img.rgb.data();
  if (d.ncomp == 1) {
    for (size_t k = 0; k < npx; k++) o[3 * k] = o[3 * k + 1] = o[3 * k + 2] =
        full[0][k];
  } else {
    // jdapimin.c default_decompress_parms: JFIF means YCbCr; else an
    // Adobe marker's transform (0 = RGB); else component ids 'R','G','B'
    bool ycc = true;
    if (!d.jfif) {
      if (d.adobe) ycc = d.adobe_transform != 0;
      else ycc = !(d.comp[0].id == 82 && d.comp[1].id == 71 &&
                   d.comp[2].id == 66);
    }
    if (!ycc) {
      for (size_t k = 0; k < npx; k++)
        for (int ch = 0; ch < 3; ch++) o[3 * k + ch] = full[ch][k];
    } else {
      static const YccTables t;
      for (size_t k = 0; k < npx; k++) {
        const int y = full[0][k], cb = full[1][k], cr = full[2][k];
        o[3 * k] = static_cast<uint8_t>(clamp255(y + t.cr_r[cr]));
        o[3 * k + 1] = static_cast<uint8_t>(
            clamp255(y + ((t.cb_g[cb] + t.cr_g[cr]) >> 16)));
        o[3 * k + 2] = static_cast<uint8_t>(clamp255(y + t.cb_b[cb]));
      }
    }
  }
  apply_orientation(img, d.orientation);
  return kOk;
}

// ------------------------------------------------------------ encode

const uint8_t kStdLuma[64] = {  // Annex K.1, natural order
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3 (jstdhuff.c): counts of code lengths 1-16, then symbols
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcLumaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcChromaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

constexpr int kQuality = 95;

struct HuffCodes {
  uint16_t code[256];
  uint8_t size[256];
  HuffCodes(const uint8_t* bits, const uint8_t* vals) {
    std::memset(size, 0, sizeof(size));
    int c = 0, k = 0;
    for (int len = 1; len <= 16; len++) {
      for (int i = 0; i < bits[len - 1]; i++, k++) {
        code[vals[k]] = static_cast<uint16_t>(c++);
        size[vals[k]] = static_cast<uint8_t>(len);
      }
      c <<= 1;
    }
  }
};

// libjpeg-turbo's quantisation by reciprocal (jcdctmgr.c
// compute_reciprocal and quantize) for a divisor of 8 x the table entry:
// the islow FDCT leaves its output scaled by 8.
struct Divisor {
  uint32_t recip, corr;
  int shift;
  explicit Divisor(uint32_t divisor = 8) {
    int b = 0;
    while ((divisor >> (b + 1)) != 0) b++;  // flss(divisor) - 1
    int r = 16 + b;
    uint64_t fq = (uint64_t{1} << r) / divisor;
    const uint64_t fr = (uint64_t{1} << r) % divisor;
    uint32_t c = divisor / 2;
    if (fr == 0) {
      fq >>= 1;
      r--;
    } else if (fr <= divisor / 2) {
      c++;
    } else {
      fq++;
    }
    recip = static_cast<uint32_t>(fq);
    corr = c;
    shift = r;
  }
  int apply(int v) const {
    const uint32_t a = static_cast<uint32_t>(v < 0 ? -v : v);
    const int q = static_cast<int>(
        (static_cast<uint64_t>(a + corr) * recip) >> shift);
    return v < 0 ? -q : q;
  }
};

// jfdctint.c: 8x8 in place, output scaled by 8
void fdct_islow(int32_t* d) {
  for (int pass = 0; pass < 2; pass++) {
    const int step = pass == 0 ? 1 : 8, stride = pass == 0 ? 8 : 1;
    for (int i = 0; i < 8; i++) {
      int32_t* p = d + i * stride;
      auto at = [&](int k) -> int32_t& { return p[k * step]; };
      int32_t tmp0 = at(0) + at(7), tmp7 = at(0) - at(7);
      int32_t tmp1 = at(1) + at(6), tmp6 = at(1) - at(6);
      int32_t tmp2 = at(2) + at(5), tmp5 = at(2) - at(5);
      int32_t tmp3 = at(3) + at(4), tmp4 = at(3) - at(4);
      const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      const int sh = pass == 0 ? kConstBits - kPass1Bits
                               : kConstBits + kPass1Bits;
      if (pass == 0) {
        at(0) = (tmp10 + tmp11) * (1 << kPass1Bits);
        at(4) = (tmp10 - tmp11) * (1 << kPass1Bits);
      } else {
        at(0) = descale(tmp10 + tmp11, kPass1Bits);
        at(4) = descale(tmp10 - tmp11, kPass1Bits);
      }
      int32_t z1 = (tmp12 + tmp13) * F0_541;
      at(2) = descale(z1 + tmp13 * F0_765, sh);
      at(6) = descale(z1 + tmp12 * -F1_847, sh);
      z1 = tmp4 + tmp7;
      int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      const int32_t z5 = (z3 + z4) * F1_175;
      tmp4 *= F0_298;
      tmp5 *= F2_053;
      tmp6 *= F3_072;
      tmp7 *= F1_501;
      z1 *= -F0_899;
      z2 *= -F2_562;
      z3 *= -F1_961;
      z4 *= -F0_390;
      z3 += z5;
      z4 += z5;
      at(7) = descale(tmp4 + z1 + z3, sh);
      at(5) = descale(tmp5 + z2 + z4, sh);
      at(3) = descale(tmp6 + z2 + z3, sh);
      at(1) = descale(tmp7 + z1 + z4, sh);
    }
  }
}

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int n = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t bits, int k) {
    acc = (acc << k) | (bits & ((1u << k) - 1));
    n += k;
    while (n >= 8) {
      const uint8_t b = static_cast<uint8_t>(acc >> (n - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      n -= 8;
    }
  }
  // pads the last byte with 1 bits (jchuff.c flush_bits)
  void flush() {
    if (n) put((1u << (8 - n)) - 1, 8 - n);
  }
};

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(static_cast<uint8_t>(v >> 8));
  o.push_back(static_cast<uint8_t>(v & 0xFF));
}

void put_dqt(std::vector<uint8_t>& o, int index, const uint16_t* q) {
  o.insert(o.end(), {0xFF, 0xDB});
  put16(o, 67);
  o.push_back(static_cast<uint8_t>(index));
  for (int k = 0; k < 64; k++) o.push_back(static_cast<uint8_t>(q[kNatural[k]]));
}

void put_dht(std::vector<uint8_t>& o, int index, const uint8_t* bits,
             const uint8_t* vals) {
  int n = 0;
  for (int i = 0; i < 16; i++) n += bits[i];
  o.insert(o.end(), {0xFF, 0xC4});
  put16(o, 2 + 1 + 16 + n);
  o.push_back(static_cast<uint8_t>(index));
  o.insert(o.end(), bits, bits + 16);
  o.insert(o.end(), vals, vals + n);
}

void encode_block(BitWriter& bw, const int* blk, int& last_dc,
                  const HuffCodes& dc, const HuffCodes& ac) {
  auto nbits = [](int a) {
    int k = 0;
    while (a) {
      k++;
      a >>= 1;
    }
    return k;
  };
  int diff = blk[0] - last_dc;
  last_dc = blk[0];
  int t = diff < 0 ? -diff : diff, t2 = diff < 0 ? diff - 1 : diff;
  int k = nbits(t);
  bw.put(dc.code[k], dc.size[k]);
  if (k) bw.put(static_cast<uint32_t>(t2), k);
  int run = 0;
  for (int z = 1; z < 64; z++) {
    const int v = blk[kNatural[z]];
    if (v == 0) {
      run++;
      continue;
    }
    while (run > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    t = v < 0 ? -v : v;
    t2 = v < 0 ? v - 1 : v;
    k = nbits(t);
    const int sym = (run << 4) + k;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put(static_cast<uint32_t>(t2), k);
    run = 0;
  }
  if (run > 0) bw.put(ac.code[0], ac.size[0]);
}

}  // namespace

bool is_jpeg(const uint8_t* data, size_t n) {
  return n >= 3 && data[0] == 0xFF && data[1] == 0xD8 && data[2] == 0xFF;
}

int decode_jpeg(const uint8_t* data, size_t n, Image& img) {
  if (!is_jpeg(data, n)) return kUnreadable;
  return decode_into(data, n, img);
}

int probe_jpeg(FILE* f, int* dims) {
  uint8_t b[4];
  if (std::fseek(f, 0, SEEK_SET) != 0 || std::fread(b, 1, 3, f) != 3 ||
      !is_jpeg(b, 3))
    return kUnreadable;
  std::fseek(f, 2, SEEK_SET);
  int h = 0, w = 0, orientation = 1;
  bool saw_app1 = false, have_frame = false;
  std::vector<uint8_t> seg;
  while (true) {
    int c = std::fgetc(f);
    while (c != EOF && c != 0xFF) c = std::fgetc(f);  // stray bytes
    while (c == 0xFF) c = std::fgetc(f);
    if (c == EOF) return kUnreadable;
    const int m = c;
    if (m == 0xDA) break;
    if (m == 0xD9) return kUnreadable;
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
    if (std::fread(b, 1, 2, f) != 2) return kUnreadable;
    const int len = be16(b) - 2;
    if (len < 0) return kUnreadable;
    if (marker_feature(m) != kOk) return marker_feature(m);
    const bool sof = m == 0xC0 || m == 0xC1 || m == 0xC2;
    if (sof || (m == 0xE1 && !saw_app1)) {
      seg.resize(static_cast<size_t>(len));
      if (len && std::fread(seg.data(), 1, seg.size(), f) != seg.size())
        return kUnreadable;
      if (sof) {
        if (have_frame || len < 6) return kUnreadable;
        if (seg[0] != 8) return kPrecision;
        h = be16(&seg[1]);
        w = be16(&seg[3]);
        const int nc = seg[5];
        if (nc == 4) return kCmyk;
        if (nc != 1 && nc != 3) return kComponents;
        have_frame = true;
      } else {
        saw_app1 = true;
        if (len >= 6 && !std::memcmp(seg.data(), "Exif\0\0", 6))
          orientation = tiff_orientation(seg.data() + 6, len - 6);
      }
    } else if (std::fseek(f, len, SEEK_CUR) != 0) {
      return kUnreadable;
    }
  }
  if (!have_frame || h <= 0 || w <= 0) return kUnreadable;
  const bool swap = orientation >= 5;
  dims[0] = swap ? w : h;
  dims[1] = swap ? h : w;
  return kOk;
}

void encode_jpeg(const uint8_t* rgb, int w, int h, std::vector<uint8_t>& out) {
  // jpeg_quality_scaling + jpeg_add_quant_table(force_baseline)
  const int scale = kQuality < 50 ? 5000 / kQuality : 200 - 2 * kQuality;
  uint16_t qt[2][64];
  Divisor div[2][64];
  for (int t = 0; t < 2; t++)
    for (int i = 0; i < 64; i++) {
      long v = ((t ? kStdChroma : kStdLuma)[i] * static_cast<long>(scale) +
                50) / 100;
      v = v < 1 ? 1 : (v > 255 ? 255 : v);
      qt[t][i] = static_cast<uint16_t>(v);
      div[t][i] = Divisor(static_cast<uint32_t>(v) << 3);
    }
  static const HuffCodes dc_l(kDcLumaBits, kDcLumaVals),
      ac_l(kAcLumaBits, kAcLumaVals), dc_c(kDcChromaBits, kDcChromaVals),
      ac_c(kAcChromaBits, kAcChromaVals);

  // jccolor.c rgb_ycc_convert into planes padded as jcprepct.c and
  // jcsample.c pad them: columns to whole MCUs and rows to whole MCUs by
  // repeating the last, chroma h2v2-downsampled from the padded planes
  const int mcux = (w + 15) / 16, mcuy = (h + 15) / 16;
  const int pw = mcux * 16, ph = mcuy * 16;
  std::vector<uint8_t> Y(static_cast<size_t>(pw) * ph),
      Cb(static_cast<size_t>(pw) * ph), Cr(static_cast<size_t>(pw) * ph);
  auto fix = [](double x) { return static_cast<int32_t>(x * 65536.0 + 0.5); };
  const int32_t ry = fix(0.29900), gy = fix(0.58700), by = fix(0.11400);
  const int32_t rcb = fix(0.16874), gcb = fix(0.33126), half = fix(0.5);
  const int32_t gcr = fix(0.41869), bcr = fix(0.08131);
  const int32_t off = (128 << 16) + 32768 - 1;
  for (int y = 0; y < ph; y++) {
    const int sy = y < h ? y : h - 1;
    for (int x = 0; x < pw; x++) {
      const int sx = x < w ? x : w - 1;
      const uint8_t* p = rgb + (static_cast<size_t>(sy) * w + sx) * 3;
      const int32_t r = p[0], g = p[1], b = p[2];
      const size_t k = static_cast<size_t>(y) * pw + x;
      Y[k] = static_cast<uint8_t>((ry * r + gy * g + by * b + 32768) >> 16);
      Cb[k] = static_cast<uint8_t>((-rcb * r - gcb * g + half * b + off) >> 16);
      Cr[k] = static_cast<uint8_t>((half * r - gcr * g - bcr * b + off) >> 16);
    }
  }
  // h2v2_downsample: bias 1, 2, 1, 2, ... along each output row. The
  // rows past the image's last pair repeat the last downsampled row.
  const int cw = pw / 2, chh = ph / 2, crows = (h + 1) / 2;
  std::vector<uint8_t> dcb(static_cast<size_t>(cw) * chh),
      dcr(static_cast<size_t>(cw) * chh);
  for (int y = 0; y < chh; y++) {
    const int sy = std::min(y, crows - 1);
    for (int x = 0; x < cw; x++) {
      const int bias = (x & 1) ? 2 : 1;
      const size_t a = static_cast<size_t>(2 * sy) * pw + 2 * x, c = a + pw;
      dcb[static_cast<size_t>(y) * cw + x] = static_cast<uint8_t>(
          (Cb[a] + Cb[a + 1] + Cb[c] + Cb[c + 1] + bias) >> 2);
      dcr[static_cast<size_t>(y) * cw + x] = static_cast<uint8_t>(
          (Cr[a] + Cr[a + 1] + Cr[c] + Cr[c + 1] + bias) >> 2);
    }
  }

  out.clear();
  out.insert(out.end(), {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I',
                         'F', 0x00, 0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01,
                         0x00, 0x00});
  put_dqt(out, 0, qt[0]);
  put_dqt(out, 1, qt[1]);
  out.insert(out.end(), {0xFF, 0xC0});
  put16(out, 17);
  out.push_back(8);
  put16(out, h);
  put16(out, w);
  out.insert(out.end(), {3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1});
  put_dht(out, 0x00, kDcLumaBits, kDcLumaVals);
  put_dht(out, 0x10, kAcLumaBits, kAcLumaVals);
  put_dht(out, 0x01, kDcChromaBits, kDcChromaVals);
  put_dht(out, 0x11, kAcChromaBits, kAcChromaVals);
  out.insert(out.end(), {0xFF, 0xDA});
  put16(out, 12);
  out.insert(out.end(), {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0});

  // jccoefct.c compress_data: luma blocks past width_in_blocks or
  // height_in_blocks are dummies, all zero but the DC, which repeats the
  // block to the left (right edge) or the MCU's previous block (bottom)
  const int wib = (w + 7) / 8, hib = (h + 7) / 8;
  auto fdct_block = [](const uint8_t* plane, size_t stride, int x0, int y0,
                       const Divisor* dv, int* blk) {
    int32_t d[64];
    for (int r = 0; r < 8; r++)
      for (int c = 0; c < 8; c++)
        d[8 * r + c] = plane[stride * (y0 + r) + x0 + c] - 128;
    fdct_islow(d);
    for (int i = 0; i < 64; i++) blk[i] = dv[i].apply(d[i]);
  };
  BitWriter bw(out);
  int last[3] = {0, 0, 0};
  int blocks[6][64];
  for (int my = 0; my < mcuy; my++)
    for (int mx = 0; mx < mcux; mx++) {
      for (int v = 0; v < 2; v++)
        for (int u = 0; u < 2; u++) {
          int* blk = blocks[2 * v + u];
          const int bx = 2 * mx + u, byk = 2 * my + v;
          if (byk >= hib) {
            std::memset(blk, 0, 64 * sizeof(int));
            blk[0] = blocks[2 * v - 1][0];
          } else if (bx >= wib) {
            std::memset(blk, 0, 64 * sizeof(int));
            blk[0] = blocks[2 * v + u - 1][0];
          } else {
            fdct_block(Y.data(), pw, bx * 8, byk * 8, div[0], blk);
          }
        }
      fdct_block(dcb.data(), cw, mx * 8, my * 8, div[1], blocks[4]);
      fdct_block(dcr.data(), cw, mx * 8, my * 8, div[1], blocks[5]);
      for (int i = 0; i < 4; i++) encode_block(bw, blocks[i], last[0], dc_l, ac_l);
      encode_block(bw, blocks[4], last[1], dc_c, ac_c);
      encode_block(bw, blocks[5], last[2], dc_c, ac_c);
    }
  bw.flush();
  out.insert(out.end(), {0xFF, 0xD9});
}

}  // namespace tsrio
