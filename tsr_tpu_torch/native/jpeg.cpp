// jpeg.cpp — the port's JPEG codec, with no codec library behind it.
//
// Decode follows libjpeg-turbo 3.1's default decompression, which is what
// cv2.imread runs: baseline, extended and progressive scans, Huffman
// (jdhuff.c, jdphuff.c) or arithmetic coded (jdarith.c, with DAC
// conditioning), restart intervals, the islow integer IDCT (jidctint.c),
// fancy upsampling (jdsample.c: the h2v1, h1v2 and h2v2 triangle filters,
// plain replication for other integral factors) and the fixed-point
// YCbCr->RGB tables (jdcolor.c); one component is gray replicated to RGB;
// an Adobe APP14 transform flag 0 means RGB; four components are CMYK, or
// YCCK under an Adobe transform other than 0, turned to RGB as cv2.imread
// turns them. EXIF orientation from the first APP1 is applied as
// cv2.imread applies it. TiffJpeg (codec.h) decodes the streams of a
// JPEG-compressed TIFF as libtiff drives libjpeg: a JPEGTables stream read
// as tables only, the quantisation and Huffman tables kept from stream to
// stream, each stream's components as stored or YCbCr turned to RGB, no
// EXIF orientation, reading on to EOI after a one-pass decode.
//
// Sequential Huffman data without restart intervals is read as
// libjpeg-turbo reads it: an MCU goes through its fast pass
// (decode_mcu_fast) wherever the source's buffer holds 512 bytes a block of
// it and no marker is unread; that pass takes FF then any byte but 00 (FF
// too) for a marker, and the MCU is decoded again by the slow pass, which
// reads FF FF 00 as one FF data byte, over the fast pass's coefficients.
// The buffer is cv2.imread's stdio source, refilled 4096 bytes at a time,
// or, in a TIFF, the whole strip or tile.
//
// Damaged data reads as libjpeg reads it, with its warnings and without
// failing: the file is followed by fake EOI markers (jdatasrc.c), a scan
// cut short is fed zero bits and its later MCUs are left as they are
// (grey where nothing came before), a bad Huffman code decodes as 0, a
// wrong or missing RSTn goes through jpeg_resync_to_restart's actions,
// and progressive data whose coefficients are incomplete is block-smoothed
// (jdcoefct.c, libjpeg-turbo >= 2.1's 5x5 window). Lossless JPEG (SOF3:
// predictors 1-7, point transform, restart intervals, 1 or 3 components;
// jdlhuff.c, jddiffct.c, jdlossls.c) is decoded as libjpeg-turbo decodes
// it for PIL, which is where the reference reads such a file (cv2.imread
// gives None for it). Still refused, each with a Status that names it:
// sample precisions other than 8 bits, hierarchical JPEG, component
// counts other than 1, 3 and 4, lossless arithmetic coding (SOF11) and
// 4-component lossless JPEG.
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
#include <climits>
#include <cstring>
#include <memory>

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
  // cv2 reads "II" as little-endian and any other mark as big-endian
  const bool le = t[0] == 'I' && t[1] == 'I';
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

// The bytes libjpeg's stdio source manager hands the decoder: the file,
// then a fake EOI (FF D9) for every read past its end (jdatasrc.c
// fill_input_buffer), so a file cut short ends at an EOI wherever it stops.
// `chunk` is the size of the source's refills: the stdio source's 4096
// (a file), or 0 for data held whole in memory (libtiff's source over a
// strip or tile). `bounds`, where set, are the ends of the refills in
// place of `chunk`'s (libtiff's old-style JPEG codec hands libjpeg each
// marker segment it writes, then the file 2048 bytes at a time); `dry`,
// where set, is where the data runs out with an error in place of the fake
// EOI (the codec's "Premature end of JPEG data"): a read there sets
// `failed` (as the codec's error on a wrong restart marker does).
struct Source {
  const uint8_t* data = nullptr;
  size_t size = 0, pos = 0, chunk = 0;
  const std::vector<size_t>* bounds = nullptr;
  size_t dry = SIZE_MAX;
  mutable bool failed = false;
  int at(size_t i) const {
    if (i < size) return data[i];
    if (i >= dry) failed = true;
    return (i - size) & 1 ? 0xD9 : 0xFF;
  }
  int byte() { return at(pos++); }
  // bytes_in_buffer: what the last refill holds past pos (a refill comes
  // when a byte is wanted and the buffer is empty; the fake EOI's 2 bytes
  // count as none)
  size_t left() const {
    if (pos >= size) return 0;
    if (bounds) {
      const auto it = std::upper_bound(bounds->begin(), bounds->end(), pos);
      return (it == bounds->end() ? size : std::min(*it, size)) - pos;
    }
    if (!chunk) return size - pos;
    return std::min(size, (pos + chunk - 1) / chunk * chunk) - pos;
  }
  int u16() {
    const int hi = byte();
    return (hi << 8) | byte();
  }
  // jdmarker.c next_marker: skips to the next marker (past FF00 pairs and
  // fill bytes) and returns its code.
  int next_marker() {
    for (;;) {
      int c = byte();
      while (c != 0xFF) c = byte();
      do c = byte(); while (c == 0xFF);
      if (c != 0) return c;
    }
  }
};

// A DHT table as defined. Its decode tables are derived when a scan uses
// it (jdhuff.c jpeg_make_d_derived_tbl), so a bad table no scan uses is no
// error, as in libjpeg.
struct HuffSpec {
  bool defined = false;
  uint8_t counts[16];
  uint8_t vals[256];
};

struct Huffman {
  static constexpr int kLook = 8;  // HUFF_LOOKAHEAD
  uint8_t look_len[1 << kLook];    // 0: the code is longer
  uint8_t look_sym[1 << kLook];
  int32_t maxcode[18];             // largest code of each length, -1 none
  int32_t valoffset[18];
  uint8_t vals[256];
};

// jpeg_make_d_derived_tbl: false where libjpeg refuses the table (counts
// that overflow a length; a DC symbol above max_dc, 15 or 16 lossless).
bool derive_huffman(const HuffSpec& s, int max_dc, Huffman& t) {
  if (!s.defined) return false;
  int nvals = 0;
  for (int i = 0; i < 16; i++) nvals += s.counts[i];
  if (nvals > 256) return false;
  for (int i = 0; max_dc >= 0 && i < nvals; i++)
    if (s.vals[i] > max_dc) return false;
  std::memset(t.look_len, 0, sizeof(t.look_len));
  std::memcpy(t.vals, s.vals, sizeof(t.vals));
  int code = 0, k = 0;
  for (int len = 1; len <= 16; len++) {
    const int n = s.counts[len - 1];
    // no code may be all ones, so a length's codes end below 2^len
    if (n && code + n >= (1 << len)) return false;
    t.valoffset[len] = k - code;
    for (int i = 0; i < n; i++, k++, code++) {
      if (len <= Huffman::kLook) {
        const int shift = Huffman::kLook - len;
        for (int f = 0; f < (1 << shift); f++) {
          t.look_len[(code << shift) | f] = static_cast<uint8_t>(len);
          t.look_sym[(code << shift) | f] = s.vals[k];
        }
      }
    }
    t.maxcode[len] = n ? code - 1 : -1;
    code <<= 1;
  }
  t.maxcode[17] = 0xFFFFF;  // sentinel: a bad code stops at 17 bits
  return true;
}

// The entropy-coded bits of a Huffman scan (jdhuff.c's bit buffer, its
// slow path jpeg_fill_bit_buffer): FF00 is an FF data byte, and FF then
// more FFs are fill; at a marker (recorded in *unread, as libjpeg's
// unread_marker) it feeds zero bits and counts them, so overrun() says the
// decode has read past the data: libjpeg's insufficient_data. It fills
// where libjpeg does (to 57 bits or more: for a code where fewer than 8
// bits are held, HUFF_LOOKAHEAD, or a longer code needs more; for a value
// where fewer than its size are), so it has read libjpeg's bytes.
struct BitReader {
  Source* src = nullptr;
  int* unread = nullptr;
  uint64_t acc = 0;  // bits at the top
  int n = 0;         // bits held
  int fake = 0;      // of those, zeros fed past the data (the last ones)

  void reset() {
    acc = 0;
    n = fake = 0;
  }
  void fill() {
    while (n <= 56) {
      int c = -1;
      if (!*unread) {
        c = src->byte();
        if (c == 0xFF) {
          do c = src->byte(); while (c == 0xFF);
          if (c == 0) {
            c = 0xFF;
          } else {
            *unread = c;
            c = -1;
          }
        }
      }
      if (c < 0) {
        fake += 8;
        c = 0;
      }
      acc |= static_cast<uint64_t>(c) << (56 - n);
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
  // HUFF_DECODE / jpeg_huff_decode: a code that is none decodes as 0 after
  // 17 bits, with libjpeg's "bad Huffman code" warning
  int decode(const Huffman& t) {
    if (n < Huffman::kLook) fill();
    const int look = static_cast<int>(acc >> (64 - Huffman::kLook));
    int len = t.look_len[look];
    if (len) {
      acc <<= len;
      n -= len;
      return t.look_sym[look];
    }
    // jpeg_huff_decode: 9 bits at once, then one at a time
    len = Huffman::kLook + 1;
    int32_t code = get(len);
    while (code > t.maxcode[len]) {
      code = (code << 1) | get(1);
      len++;
    }
    if (len > 16) return 0;
    return t.vals[(code + t.valoffset[len]) & 0xFF];
  }
  bool overrun() const { return n < fake; }
};

// decode_mcu_fast's bit buffer (jdhuff.c), which libjpeg-turbo takes for an
// MCU of a sequential scan with no restart interval where no marker is
// unread and its source's buffer holds at least 512 bytes a block of the
// MCU. It fills 6 bytes at once where 16 bits or fewer are held, reading
// FF00 as FF; FF then any other byte (another FF too) is a marker: it
// feeds a zero byte and stays at the FF. An MCU that met a marker is
// decoded again by the slow path from the state before it, over the
// coefficients the fast one wrote (those the slow one does not write
// stay).
struct FastReader {
  const Source* src;
  size_t pos;
  uint64_t acc;
  int n;
  bool marker = false;

  void fill() {  // FILL_BIT_BUFFER_FAST
    if (n > 16) return;
    for (int i = 0; i < 6; i++) {  // FILL_BYTE
      int c = src->at(pos++);
      if (c == 0xFF) {
        if (src->at(pos) == 0) {
          pos++;
        } else {
          marker = true;
          pos--;
          c = 0;
        }
      }
      acc |= static_cast<uint64_t>(c) << (56 - n);
      n += 8;
    }
  }
  int get(int k) {
    if (k == 0) return 0;
    fill();
    const int v = static_cast<int>(acc >> (64 - k));
    acc <<= k;
    n -= k;
    return v;
  }
  int decode(const Huffman& t) {  // HUFF_DECODE_FAST
    fill();
    const int look = static_cast<int>(acc >> (64 - Huffman::kLook));
    int len = t.look_len[look];
    if (len) {
      acc <<= len;
      n -= len;
      return t.look_sym[look];
    }
    len = Huffman::kLook + 1;
    int32_t code = static_cast<int32_t>(acc >> (64 - len));
    while (len <= 16 && code > t.maxcode[len]) {
      len++;
      code = static_cast<int32_t>(acc >> (64 - len));
    }
    acc <<= len;
    n -= len;
    if (len > 16) return 0;
    return t.vals[(code + t.valoffset[len]) & 0xFF];
  }
};

// jaricom.c: Table D.2 of T.81, each entry Qe << 16 | Next_Index_MPS << 8
// | Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed 0.5 estimate.
#define QM(qe, nlps, nmps, sw) \
  ((static_cast<int32_t>(qe) << 16) | ((nmps) << 8) | ((sw) << 7) | (nlps))
const int32_t kQm[114] = {
    QM(0x5a1d, 1, 1, 1),     QM(0x2586, 14, 2, 0),    QM(0x1114, 16, 3, 0),
    QM(0x080b, 18, 4, 0),    QM(0x03d8, 20, 5, 0),    QM(0x01da, 23, 6, 0),
    QM(0x00e5, 25, 7, 0),    QM(0x006f, 28, 8, 0),    QM(0x0036, 30, 9, 0),
    QM(0x001a, 33, 10, 0),   QM(0x000d, 35, 11, 0),   QM(0x0006, 9, 12, 0),
    QM(0x0003, 10, 13, 0),   QM(0x0001, 12, 13, 0),   QM(0x5a7f, 15, 15, 1),
    QM(0x3f25, 36, 16, 0),   QM(0x2cf2, 38, 17, 0),   QM(0x207c, 39, 18, 0),
    QM(0x17b9, 40, 19, 0),   QM(0x1182, 42, 20, 0),   QM(0x0cef, 43, 21, 0),
    QM(0x09a1, 45, 22, 0),   QM(0x072f, 46, 23, 0),   QM(0x055c, 48, 24, 0),
    QM(0x0406, 49, 25, 0),   QM(0x0303, 51, 26, 0),   QM(0x0240, 52, 27, 0),
    QM(0x01b1, 54, 28, 0),   QM(0x0144, 56, 29, 0),   QM(0x00f5, 57, 30, 0),
    QM(0x00b7, 59, 31, 0),   QM(0x008a, 60, 32, 0),   QM(0x0068, 62, 33, 0),
    QM(0x004e, 63, 34, 0),   QM(0x003b, 32, 35, 0),   QM(0x002c, 33, 9, 0),
    QM(0x5ae1, 37, 37, 1),   QM(0x484c, 64, 38, 0),   QM(0x3a0d, 65, 39, 0),
    QM(0x2ef1, 67, 40, 0),   QM(0x261f, 68, 41, 0),   QM(0x1f33, 69, 42, 0),
    QM(0x19a8, 70, 43, 0),   QM(0x1518, 72, 44, 0),   QM(0x1177, 73, 45, 0),
    QM(0x0e74, 74, 46, 0),   QM(0x0bfb, 75, 47, 0),   QM(0x09f8, 77, 48, 0),
    QM(0x0861, 78, 49, 0),   QM(0x0706, 79, 50, 0),   QM(0x05cd, 48, 51, 0),
    QM(0x04de, 50, 52, 0),   QM(0x040f, 50, 53, 0),   QM(0x0363, 51, 54, 0),
    QM(0x02d4, 52, 55, 0),   QM(0x025c, 53, 56, 0),   QM(0x01f8, 54, 57, 0),
    QM(0x01a4, 55, 58, 0),   QM(0x0160, 56, 59, 0),   QM(0x0125, 57, 60, 0),
    QM(0x00f6, 58, 61, 0),   QM(0x00cb, 59, 62, 0),   QM(0x00ab, 61, 63, 0),
    QM(0x008f, 61, 32, 0),   QM(0x5b12, 65, 65, 1),   QM(0x4d04, 80, 66, 0),
    QM(0x412c, 81, 67, 0),   QM(0x37d8, 82, 68, 0),   QM(0x2fe8, 83, 69, 0),
    QM(0x293c, 84, 70, 0),   QM(0x2379, 86, 71, 0),   QM(0x1edf, 87, 72, 0),
    QM(0x1aa9, 87, 73, 0),   QM(0x174e, 72, 74, 0),   QM(0x1424, 72, 75, 0),
    QM(0x119c, 74, 76, 0),   QM(0x0f6b, 74, 77, 0),   QM(0x0d51, 75, 78, 0),
    QM(0x0bb6, 77, 79, 0),   QM(0x0a40, 77, 48, 0),   QM(0x5832, 80, 81, 1),
    QM(0x4d1c, 88, 82, 0),   QM(0x438e, 89, 83, 0),   QM(0x3bdd, 90, 84, 0),
    QM(0x34ee, 91, 85, 0),   QM(0x2eae, 92, 86, 0),   QM(0x299a, 93, 87, 0),
    QM(0x2516, 86, 71, 0),   QM(0x5570, 88, 89, 1),   QM(0x4ca9, 95, 90, 0),
    QM(0x44d9, 96, 91, 0),   QM(0x3e22, 97, 92, 0),   QM(0x3824, 99, 93, 0),
    QM(0x32b4, 99, 94, 0),   QM(0x2e17, 93, 86, 0),   QM(0x56a8, 95, 96, 1),
    QM(0x4f46, 101, 97, 0),  QM(0x47e5, 102, 98, 0),  QM(0x41cf, 103, 99, 0),
    QM(0x3c3d, 104, 100, 0), QM(0x375e, 99, 93, 0),   QM(0x5231, 105, 102, 0),
    QM(0x4c0f, 106, 103, 0), QM(0x4639, 107, 104, 0), QM(0x415e, 103, 99, 0),
    QM(0x5627, 105, 106, 1), QM(0x50e7, 108, 107, 0), QM(0x4b85, 109, 103, 0),
    QM(0x5597, 110, 109, 0), QM(0x504f, 111, 107, 0), QM(0x5a10, 110, 111, 1),
    QM(0x5522, 112, 109, 0), QM(0x59eb, 112, 111, 1), QM(0x5a1d, 113, 113, 0)};
#undef QM

// jdarith.c's QM decoder. A marker in the data feeds zeros from then on,
// which is legal in arithmetic coding; ct == -1 marks a decode error, after
// which a scan's blocks are left as they are (with libjpeg's warning).
struct ArithReader {
  Source* src = nullptr;
  int* unread = nullptr;
  int64_t c = 0, a = 0;
  int ct = -16;
  uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed = 113;

  void reset() {
    c = a = 0;
    ct = -16;  // read two bytes into C first
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {  // renormalise, D.2.6
      if (--ct < 0) {
        int d = 0;
        if (!*unread) {
          d = src->byte();
          if (d == 0xFF) {
            do d = src->byte(); while (d == 0xFF);
            if (d == 0) {
              d = 0xFF;
            } else {
              *unread = d;
              d = 0;
            }
          }
        }
        c = (c << 8) | d;
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // the first two bytes
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kQm[sv & 0x7F];
    const int nl = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    const int nm = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional exchange: MPS
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {  // conditional exchange: LPS
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

// The feature a marker names that the decoder refuses, kOk for the rest:
// the differential (hierarchical) SOFs, DHP and EXP.
int marker_feature(int m) {
  if (m == 0xC5 || m == 0xC6 || m == 0xC7 || m == 0xCD || m == 0xCE ||
      m == 0xCF || m == 0xDE || m == 0xDF)
    return kHierarchical;
  return kOk;
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;     // the current scan's DC and AC tables
  int gw = 0, gh = 0;     // blocks (lossless: samples) of the MCU grid
  int wib = 0, hib = 0;   // those holding image data (width_in_blocks)
  int dw = 0, dh = 0;     // samples of image data (downsampled_width)
  bool latched = false;   // quantisation table copied at its first scan
  uint16_t q[64] = {};    // natural order
  int bits[64];           // progressive coef_bits: lowest bit known, -1 none
  int prev_bits[10];      // coef_bits[0..9] as the last scan began
  std::vector<int16_t> coef;     // [gh][gw][64]
  std::vector<uint8_t> samples;  // lossless: [gh][gw]
};

// What a decode leaves for the output stage (jdcoefct.c, jdsample.c,
// jdcolor.c): the coefficients or samples of each component and what the
// marker segments said.
struct Decoder {
  Source src;
  int unread = 0;  // libjpeg's unread_marker
  uint16_t qt[4][64];
  bool qt_defined[4] = {};
  HuffSpec dc_spec[4], ac_spec[4];
  Huffman dc[4], ac[4];
  uint8_t arith_l[16], arith_u[16], arith_k[16];
  Component comp[4];
  int ncomp = 0, width = 0, height = 0, maxh = 1, maxv = 1, bs = 8;
  int mcux = 0, mcuy = 0;
  bool progressive = false, lossless = false, arith = false;
  bool have_frame = false, multi_scan = false;
  int restart = 0, next_rst = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  int orientation = 1;
  bool saw_app1 = false;
  int scans = 0;           // input_scan_number
  int last_good_row = 0;   // master->last_good_iMCU_row
  bool insufficient = false;
  bool cv2_reader = false;  // refuse what cv2.imread refuses (gray lossless)
  // libtiff's old-style JPEG codec: its resync_to_restart is an error, as
  // is a read past the source's `dry` end; `fail_mcu` is the MCU of the
  // scan that met either (the decode stops there), else -1
  bool strict_restart = false;
  long fail_mcu = -1;

  static constexpr int kSos = 2, kEoi = 3;

  Decoder() {
    for (int i = 0; i < 16; i++) {  // get_soi's defaults
      arith_l[i] = 0;
      arith_u[i] = 1;
      arith_k[i] = 5;
    }
  }

  int read_dqt() {
    int len = src.u16() - 2;
    while (len > 0) {
      const int t = src.byte();
      const int pq = t >> 4, tq = t & 15;
      if (tq > 3) return kUnreadable;
      for (int k = 0; k < 64; k++)
        qt[tq][kNatural[k]] =
            static_cast<uint16_t>(pq ? src.u16() : src.byte());
      qt_defined[tq] = true;
      len -= 65 + (pq ? 64 : 0);
    }
    return len == 0 ? kOk : kUnreadable;
  }

  int read_dht() {
    int len = src.u16() - 2;
    while (len > 16) {
      int index = src.byte();
      uint8_t counts[16];
      int count = 0;
      for (int i = 0; i < 16; i++) {
        counts[i] = static_cast<uint8_t>(src.byte());
        count += counts[i];
      }
      len -= 17;
      if (count > 256 || count > len) return kUnreadable;
      uint8_t vals[256] = {};
      for (int i = 0; i < count; i++)
        vals[i] = static_cast<uint8_t>(src.byte());
      len -= count;
      const bool is_ac = index & 0x10;
      if (is_ac) index -= 0x10;
      if (index < 0 || index > 3) return kUnreadable;
      HuffSpec& s = is_ac ? ac_spec[index] : dc_spec[index];
      std::memcpy(s.counts, counts, 16);
      std::memcpy(s.vals, vals, 256);
      s.defined = true;
    }
    return len == 0 ? kOk : kUnreadable;
  }

  int read_dac() {
    int len = src.u16() - 2;
    while (len > 0) {
      const int index = src.byte(), val = src.byte();
      len -= 2;
      if (index >= 32) return kUnreadable;
      if (index >= 16) {
        arith_k[index - 16] = static_cast<uint8_t>(val);
      } else {
        arith_l[index] = static_cast<uint8_t>(val & 15);
        arith_u[index] = static_cast<uint8_t>(val >> 4);
        if (arith_l[index] > arith_u[index]) return kUnreadable;
      }
    }
    return len == 0 ? kOk : kUnreadable;
  }

  int read_sof(bool prog, bool lossl, bool ari) {
    if (have_frame) return kUnreadable;
    progressive = prog;
    lossless = lossl;
    arith = ari;
    const int len = src.u16();
    const int precision = src.byte();
    height = src.u16();
    width = src.u16();
    ncomp = src.byte();
    if (height <= 0 || width <= 0 || ncomp <= 0 || len - 8 != 3 * ncomp)
      return kUnreadable;  // height 0 needs DNL, which libjpeg refuses
    if (precision != 8) return kPrecision;
    if (ncomp != 1 && ncomp != 3 && ncomp != 4) return kComponents;
    if (lossless && ari) return kLosslessArithmetic;
    if (width > 65500 || height > 65500) return kUnreadable;  // libjpeg's
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = src.byte();
      const int hv = src.byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = src.byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) return kUnreadable;
      maxh = std::max(maxh, c.h);
      maxv = std::max(maxv, c.v);
    }
    bs = lossless ? 1 : 8;
    mcux = (width + bs * maxh - 1) / (bs * maxh);
    mcuy = (height + bs * maxv - 1) / (bs * maxv);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      // jdsample.c upsamples integral factors only
      if (maxh % c.h || maxv % c.v) return kUnreadable;
      c.dw = (width * c.h + maxh - 1) / maxh;
      c.dh = (height * c.v + maxv - 1) / maxv;
      c.wib = (c.dw + bs - 1) / bs;
      c.hib = (c.dh + bs - 1) / bs;
      c.gw = mcux * c.h;
      c.gh = mcuy * c.v;
      for (int& b : c.bits) b = -1;
      for (int& b : c.prev_bits) b = -1;
    }
    have_frame = true;
    return kOk;
  }

  // APPn segments: the JFIF and Adobe markers as libjpeg reads them, and
  // the first APP1 as cv2 reads it for EXIF orientation
  void read_app(int marker) {
    const int len = src.u16() - 2;
    if (len < 0) return;
    std::vector<uint8_t> s(static_cast<size_t>(len));
    for (auto& b : s) b = static_cast<uint8_t>(src.byte());
    if (marker == 0xE0 && len >= 14 && !std::memcmp(s.data(), "JFIF\0", 5)) {
      jfif = true;
    } else if (marker == 0xEE && len >= 12 &&
               !std::memcmp(s.data(), "Adobe", 5)) {
      adobe = true;
      adobe_transform = s[11];
    } else if (marker == 0xE1 && !saw_app1) {
      saw_app1 = true;
      if (len >= 6 && !std::memcmp(s.data(), "Exif\0\0", 6))
        orientation = tiff_orientation(s.data() + 6, len - 6);
    }
  }

  void skip_segment() {
    const int len = src.u16() - 2;
    if (len > 0) src.pos += static_cast<size_t>(len);
  }

  // jdmarker.c read_markers: kSos (its segment unread) or kEoi, else the
  // Status of the marker that stops the decode.
  int read_markers() {
    for (;;) {
      if (!unread) unread = src.next_marker();
      const int m = unread;
      unread = 0;
      int st = kOk;
      switch (m) {
        case 0xC0: case 0xC1: st = read_sof(false, false, false); break;
        case 0xC2: st = read_sof(true, false, false); break;
        case 0xC3: st = read_sof(false, true, false); break;
        case 0xC9: st = read_sof(false, false, true); break;
        case 0xCA: st = read_sof(true, false, true); break;
        case 0xCB: st = read_sof(false, true, true); break;
        case 0xDA: return kSos;
        case 0xD9: return kEoi;
        case 0xC4: st = read_dht(); break;
        case 0xCC: st = read_dac(); break;
        case 0xDB: st = read_dqt(); break;
        case 0xDD:
          if (src.u16() != 4) return kUnreadable;
          restart = src.u16();
          break;
        case 0xDC: case 0xFE: skip_segment(); break;  // DNL, COM
        case 0x01: case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4:
        case 0xD5: case 0xD6: case 0xD7:
          break;  // parameterless
        default:
          if (m >= 0xE0 && m <= 0xEF) {
            read_app(m);
            break;
          }
          if (marker_feature(m) != kOk) return marker_feature(m);
          return kUnreadable;  // SOI again, JPG, JPGn, RESn
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

  // get_sos, then the checks of jdinput.c and the entropy decoder's
  // start_pass
  int read_sos(Scan& sc) {
    const int st = get_sos(sc);
    return st == kOk ? start_scan(sc) : st;
  }

  // jdmarker.c get_sos: the SOS segment
  int get_sos(Scan& sc) {
    if (!have_frame) return kUnreadable;
    const int len = src.u16();
    sc.n = src.byte();
    if (len != 2 * sc.n + 6 || sc.n < 1 || sc.n > 4) return kUnreadable;
    for (int i = 0; i < sc.n; i++) {
      const int id = src.byte(), t = src.byte();
      Component* found = nullptr;
      for (int k = 0; k < ncomp && !found; k++)
        if (comp[k].id == id) found = &comp[k];
      if (!found) return kUnreadable;
      for (int j = 0; j < i; j++)
        if (sc.c[j] == found) return kUnreadable;
      found->td = t >> 4;
      found->ta = t & 15;
      sc.c[i] = found;
    }
    sc.ss = src.byte();
    sc.se = src.byte();
    const int a = src.byte();
    sc.ah = a >> 4;
    sc.al = a & 15;
    scans++;
    next_rst = 0;
    if (scans == 1) multi_scan = sc.n < ncomp || progressive;
    return kOk;
  }

  // the scan's checks when its decode starts (jdinput.c, the entropy
  // decoder's start_pass)
  int start_scan(Scan& sc) {
    int blocks = 0;
    for (int i = 0; i < sc.n; i++) blocks += sc.c[i]->h * sc.c[i]->v;
    if (sc.n > 1 && blocks > 10) return kUnreadable;
    if (lossless) {
      if (sc.ss < 1 || sc.ss > 7 || sc.se != 0 || sc.ah != 0 || sc.al > 7)
        return kUnreadable;
    } else {
      for (int i = 0; i < sc.n; i++) {
        Component& c = *sc.c[i];
        if (!c.latched) {  // jdinput.c latch_quant_tables
          if (c.tq > 3 || !qt_defined[c.tq]) return kUnreadable;
          std::memcpy(c.q, qt[c.tq], sizeof(c.q));
          c.latched = true;
        }
      }
    }
    if (progressive) {  // bad parameters are errors; the rest warns
      if (sc.ss == 0 ? sc.se != 0
                     : (sc.se < sc.ss || sc.se > 63 || sc.n != 1))
        return kUnreadable;
      if ((sc.ah && sc.ah - 1 != sc.al) || sc.al > 13) return kUnreadable;
      for (int i = 0; i < sc.n; i++) {
        Component& c = *sc.c[i];
        for (int k = std::min(sc.ss, 1); k <= std::max(sc.se, 9); k++)
          if (k < 10) c.prev_bits[k] = scans > 1 ? c.bits[k] : 0;
        for (int k = sc.ss; k <= sc.se; k++) c.bits[k] = sc.al;
      }
    }
    for (int i = 0; i < sc.n; i++) {
      const Component& c = *sc.c[i];
      const bool needs_dc = !progressive || (sc.ss == 0 && sc.ah == 0);
      const bool needs_ac = !lossless && (!progressive || sc.ss > 0);
      if (arith) {
        if ((needs_dc && c.td > 15) || (needs_ac && c.ta > 15))
          return kUnreadable;
        continue;
      }
      if (needs_dc &&
          (c.td > 3 || !derive_huffman(dc_spec[c.td], lossless ? 16 : 15,
                                       dc[c.td])))
        return kUnreadable;
      if (needs_ac && (c.ta > 3 || !derive_huffman(ac_spec[c.ta], -1,
                                                   ac[c.ta])))
        return kUnreadable;
    }
    if (lossless && restart) {  // jdlossls.c: whole MCU rows only
      const int per_row = sc.n == 1 ? sc.c[0]->wib : mcux;
      if (restart % per_row) return kUnreadable;
    }
    return kOk;
  }

  // jdmarker.c read_restart_marker and jpeg_resync_to_restart's default
  // actions for a missing or wrong RSTn
  void read_restart_marker() {
    if (!unread) unread = src.next_marker();
    const int desired = next_rst;
    next_rst = (next_rst + 1) & 7;
    if (unread == 0xD0 + desired) {
      unread = 0;
      return;
    }
    if (strict_restart) {
      src.failed = true;  // the decode stops at this MCU
      return;
    }
    for (;;) {
      const int m = unread;
      int action = 1;
      if (m < 0xC0) action = 2;  // invalid marker
      else if (m < 0xD0 || m > 0xD7) action = 3;  // valid non-RSTn
      else if (m == 0xD0 + ((desired + 1) & 7) ||
               m == 0xD0 + ((desired + 2) & 7))
        action = 3;  // one of the next two: an empty segment
      else if (m == 0xD0 + ((desired - 1) & 7) ||
               m == 0xD0 + ((desired - 2) & 7))
        action = 2;  // a prior one: advance
      if (action == 1) {
        unread = 0;
        return;
      }
      if (action == 3) return;
      unread = src.next_marker();
    }
  }

  int decode_scan(const Scan& sc) {
    if (lossless) return decode_lossless(sc);
    BitReader br;
    br.src = &src;
    br.unread = &unread;
    ArithReader ar;
    ar.src = &src;
    ar.unread = &unread;
    const bool dc_scan = !progressive || (sc.ss == 0 && sc.ah == 0);
    const bool ac_scan = !progressive || sc.ss > 0;
    auto reset_stats = [&]() {
      for (int i = 0; i < sc.n; i++) {
        if (dc_scan) std::memset(ar.dc_stats[sc.c[i]->td], 0, 64);
        if (ac_scan) std::memset(ar.ac_stats[sc.c[i]->ta], 0, 256);
      }
    };
    if (arith) reset_stats();
    insufficient = false;
    int pred[4] = {0, 0, 0, 0}, dc_ctx[4] = {0, 0, 0, 0};
    int eobrun = 0;
    const bool single = sc.n == 1;
    const int cols = single ? sc.c[0]->wib : mcux;
    const int rows = single ? sc.c[0]->hib : mcuy;
    const long total = static_cast<long>(cols) * rows;
    int left = restart;
    // decode_mcu's fast path: sequential Huffman data, no restart interval
    const bool fast = !arith && !progressive && !restart;
    int blocks = 0;  // blocks_in_MCU
    for (int i = 0; i < sc.n; i++) blocks += single ? 1 : sc.c[i]->h * sc.c[i]->v;
    auto for_blocks = [&](int mr, int mc, auto&& f) {
      for (int i = 0; i < sc.n; i++) {
        Component& c = *sc.c[i];
        const int bh = single ? 1 : c.v, bw = single ? 1 : c.h;
        for (int by = 0; by < bh; by++)
          for (int bx = 0; bx < bw; bx++) {
            const int row = single ? mr : mr * c.v + by;
            const int col = single ? mc : mc * c.h + bx;
            f(c, i, c.coef.data() + (static_cast<size_t>(row) * c.gw + col) * 64);
          }
      }
    };
    for (long m = 0; m < total; m++) {
      const int mr = static_cast<int>(m / cols);
      const int mc = static_cast<int>(m % cols);
      if (!insufficient) last_good_row = single ? mr / sc.c[0]->v : mr;
      if (restart) {
        if (left == 0) {  // process_restart
          if (arith) {
            read_restart_marker();
            reset_stats();
            ar.reset();
          } else {
            br.reset();
            read_restart_marker();
            if (!unread) insufficient = false;
          }
          std::memset(pred, 0, sizeof(pred));
          std::memset(dc_ctx, 0, sizeof(dc_ctx));
          eobrun = 0;
          left = restart;
        }
        left--;
      }
      if (strict_restart && src.failed) {
        fail_mcu = m;
        return kOk;
      }
      if (insufficient) continue;  // leave the MCU as it is
      if (fast && !unread && src.left() >= 512 * static_cast<size_t>(blocks)) {
        FastReader fr{&src, src.pos, br.acc, br.n};
        int fpred[4] = {pred[0], pred[1], pred[2], pred[3]};
        for_blocks(mr, mc, [&](Component& c, int i, int16_t* blk) {
          block_sequential(fr, blk, c, fpred[i]);
        });
        if (!fr.marker) {
          src.pos = fr.pos;
          br.acc = fr.acc;
          br.n = fr.n;
          std::memcpy(pred, fpred, sizeof(pred));
          continue;
        }
      }
      int st = kOk;
      for_blocks(mr, mc, [&](Component& c, int i, int16_t* blk) {
        if (st != kOk) return;
        if (arith)
          st = arith_block(ar, sc, c, blk, pred[i], dc_ctx[i]);
        else if (!progressive)
          block_sequential(br, blk, c, pred[i]);
        else if (sc.ss == 0)
          st = sc.ah == 0 ? dc_first(br, blk, c, pred[i], sc.al)
                          : (dc_refine(br, blk, sc.al), kOk);
        else if (sc.ah == 0)
          ac_first(br, blk, c, sc, eobrun);
        else
          ac_refine(br, blk, c, sc, eobrun);
      });
      if (st != kOk) return st;
      if (strict_restart && src.failed) {
        fail_mcu = m;
        return kOk;
      }
      if (!arith && br.overrun()) insufficient = true;
    }
    return kOk;
  }

  template <class Reader>
  void block_sequential(Reader& br, int16_t* blk, const Component& c,
                        int& pred) {
    int s = br.decode(dc[c.td]);
    if (s) s = extend(br.get(s), s);
    pred = static_cast<int>(static_cast<unsigned>(pred) + s);
    blk[0] = static_cast<int16_t>(pred);
    const Huffman& t = ac[c.ta];
    for (int k = 1; k < 64; k++) {
      const int rs = br.decode(t);
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
  }

  int dc_first(BitReader& br, int16_t* blk, const Component& c, int& pred,
               int al) {
    int s = br.decode(dc[c.td]);
    if (s) s = extend(br.get(s), s);
    const int64_t sum = static_cast<int64_t>(pred) + s;
    if (sum > INT32_MAX || sum < INT32_MIN) return kUnreadable;
    pred = static_cast<int>(sum);
    blk[0] = static_cast<int16_t>(static_cast<unsigned>(pred) << al);
    return kOk;
  }

  void dc_refine(BitReader& br, int16_t* blk, int al) {
    if (br.get(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
  }

  void ac_first(BitReader& br, int16_t* blk, const Component& c,
                const Scan& sc, int& eobrun) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    const Huffman& t = ac[c.ta];
    for (int k = sc.ss; k <= sc.se; k++) {
      const int rs = br.decode(t);
      const int r = rs >> 4, s = rs & 15;
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
  }

  void ac_refine(BitReader& br, int16_t* blk, const Component& c,
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
        int r = rs >> 4;
        int s = rs & 15;
        if (s) {  // a size other than 1 only warns
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
  }

  // jdarith.c: Figures F.21-F.24, the magnitude and sign of a nonzero
  // value; st points at its S0 + 2 + sign (DC) or SE + 2 (AC) bin, x2 at
  // the first magnitude bin past X1. False on a magnitude overflow.
  static bool arith_value(ArithReader& ar, uint8_t* st, uint8_t* x2,
                          int sign, bool ac, int& v_out, int& m_out) {
    int m = ar.decode(st);
    if (m && (!ac || ar.decode(st))) {
      if (ac) m <<= 1;
      st = x2;
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        st += 1;
      }
    }
    m_out = m;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    v_out = sign ? -v : v;
    return true;
  }

  int arith_block(ArithReader& ar, const Scan& sc, const Component& c,
                  int16_t* blk, int& pred, int& dc_ctx) {
    const bool dc_part = !progressive || sc.ss == 0;
    if (dc_part && progressive && sc.ah) {  // DC refinement: fixed 0.5
      if (ar.decode(&ar.fixed))
        blk[0] = static_cast<int16_t>(blk[0] | (1 << sc.al));
      return kOk;
    }
    if (ar.ct == -1) return kOk;  // after an error: left as it is
    if (dc_part) {  // F.1.4.4.1
      uint8_t* base = ar.dc_stats[c.td];
      uint8_t* st = base + dc_ctx;
      if (ar.decode(st) == 0) {
        dc_ctx = 0;
      } else {
        const int sign = ar.decode(st + 1);
        int v = 0, m = 0;
        if (!arith_value(ar, st + 2 + sign, base + 20, sign, false, v, m)) {
          ar.ct = -1;  // magnitude overflow
          return kOk;
        }
        if (m < ((1 << arith_l[c.td]) >> 1))
          dc_ctx = 0;
        else if (m > ((1 << arith_u[c.td]) >> 1))
          dc_ctx = 12 + sign * 4;
        else
          dc_ctx = 4 + sign * 4;
        pred = static_cast<int>(static_cast<unsigned>(pred) + v);
      }
      blk[0] = static_cast<int16_t>(progressive
                                        ? static_cast<unsigned>(pred) << sc.al
                                        : static_cast<unsigned>(pred));
      if (progressive) return kOk;
    }
    const int ss = progressive ? sc.ss : 1, se = progressive ? sc.se : 63;
    uint8_t* ast = ar.ac_stats[c.ta];
    if (progressive && sc.ah) {  // AC refinement
      const int p1 = 1 << sc.al, m1 = -1 * (1 << sc.al);
      int kex = se;
      for (; kex > 0; kex--)
        if (blk[kNatural[kex]]) break;
      for (int k = ss; k <= se; k++) {
        uint8_t* st = ast + 3 * (k - 1);
        if (k > kex && ar.decode(st)) break;  // EOB
        for (;;) {
          int16_t& coef = blk[kNatural[k]];
          if (coef) {
            if (ar.decode(st + 2))
              coef = static_cast<int16_t>(coef < 0 ? coef + m1 : coef + p1);
            break;
          }
          if (ar.decode(st + 1)) {
            coef = static_cast<int16_t>(ar.decode(&ar.fixed) ? m1 : p1);
            break;
          }
          st += 3;
          k++;
          if (k > se) {
            ar.ct = -1;  // spectral overflow
            return kOk;
          }
        }
      }
      return kOk;
    }
    for (int k = ss; k <= se; k++) {  // F.1.4.4.2
      uint8_t* st = ast + 3 * (k - 1);
      if (ar.decode(st)) break;  // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        k++;
        if (k > se) {
          ar.ct = -1;  // spectral overflow
          return kOk;
        }
      }
      const int sign = ar.decode(&ar.fixed);
      int v = 0, m = 0;
      if (!arith_value(ar, st + 2, ast + (k <= arith_k[c.ta] ? 189 : 217),
                       sign, true, v, m)) {
        ar.ct = -1;  // magnitude overflow
        return kOk;
      }
      blk[kNatural[k]] = static_cast<int16_t>(
          progressive ? static_cast<unsigned>(v) << sc.al
                      : static_cast<unsigned>(v));
    }
    return kOk;
  }

  // ---- lossless (T.81 Annex H; jdlhuff.c, jddiffct.c, jdlossls.c)

  int decode_lossless(const Scan& sc) {
    BitReader br;
    br.src = &src;
    br.unread = &unread;
    insufficient = false;
    const bool single = sc.n == 1;
    const int cols = single ? sc.c[0]->wib : mcux;
    const int rows = single ? sc.c[0]->hib : mcuy;
    const int restart_rows = restart ? restart / cols : 0;
    // differences of the whole scan, then each component's rows
    // undifferenced; reset[r]: iMCU row r starts with the first-row
    // predictor (scan start, a restart, or data run out)
    std::vector<std::vector<int>> diff(sc.n);
    for (int i = 0; i < sc.n; i++)
      diff[i].assign(static_cast<size_t>(sc.c[i]->gw) * sc.c[i]->gh, 0);
    std::vector<uint8_t> reset(static_cast<size_t>(mcuy) + 1, 0);
    reset[0] = 1;
    int rows_left = restart_rows;
    for (int mr = 0; mr < rows; mr++) {
      const int imcu = single ? mr / sc.c[0]->v : mr;
      if (restart) {
        if (rows_left == 0) {
          br.reset();
          read_restart_marker();
          if (!unread) insufficient = false;
          reset[imcu] = 1;
          rows_left = restart_rows;
        }
        rows_left--;
      }
      if (insufficient) {  // zeros, and the predictor starts over
        reset[imcu] = 1;
        continue;
      }
      for (int mc = 0; mc < cols; mc++)
        for (int i = 0; i < sc.n; i++) {
          Component& c = *sc.c[i];
          const int bh = single ? 1 : c.v, bw = single ? 1 : c.h;
          for (int by = 0; by < bh; by++)
            for (int bx = 0; bx < bw; bx++) {
              const int row = single ? mr : mr * c.v + by;
              const int col = single ? mc : mc * c.h + bx;
              int s = br.decode(dc[c.td]);
              if (s == 16) {
                s = 32768;
              } else if (s) {
                s = extend(br.get(s), s);
              }
              diff[i][static_cast<size_t>(row) * c.gw + col] = s;
            }
        }
      if (br.overrun()) insufficient = true;
    }
    const int psv = sc.ss, pt = sc.al;
    for (int i = 0; i < sc.n; i++) {
      Component& c = *sc.c[i];
      std::vector<int> prev(c.wib), cur(c.wib);
      for (int r = 0; r < c.hib; r++) {
        const int* d = diff[i].data() + static_cast<size_t>(r) * c.gw;
        const bool first = r % c.v == 0 && reset[r / c.v];
        if (first) {
          int ra = (d[0] + (1 << (8 - pt - 1))) & 0xFFFF;
          cur[0] = ra;
          for (int x = 1; x < c.wib; x++) cur[x] = ra = (d[x] + ra) & 0xFFFF;
        } else {
          int rb = prev[0];
          int ra = (d[0] + rb) & 0xFFFF;
          cur[0] = ra;
          for (int x = 1; x < c.wib; x++) {
            const int rc = rb;
            rb = prev[x];
            int p;
            switch (psv) {
              case 1: p = ra; break;
              case 2: p = rb; break;
              case 3: p = rc; break;
              case 4: p = ra + rb - rc; break;
              case 5: p = ra + ((rb - rc) >> 1); break;
              case 6: p = rb + ((ra - rc) >> 1); break;
              default: p = (ra + rb) >> 1; break;
            }
            cur[x] = ra = (d[x] + p) & 0xFFFF;
          }
        }
        uint8_t* out = c.samples.data() + static_cast<size_t>(r) * c.gw;
        for (int x = 0; x < c.wib; x++)
          out[x] = static_cast<uint8_t>(cur[x] << pt);
        prev.swap(cur);
      }
    }
    return kOk;
  }

  enum Color { kGray, kRgb, kYcc, kCmyk, kYcck };

  // jdapimin.c default_decompress_parms: one component is gray; three are
  // YCbCr under JFIF, else as an Adobe marker's transform says (0 = RGB),
  // else RGB for ids 'R','G','B' and YCbCr for the rest, but RGB for every
  // lossless file; four are YCCK behind an Adobe transform other than 0,
  // else CMYK.
  Color color() const {
    if (ncomp == 1) return kGray;
    if (ncomp == 4) return adobe && adobe_transform != 0 ? kYcck : kCmyk;
    if (jfif) return kYcc;
    if (adobe) return adobe_transform != 0 ? kYcc : kRgb;
    if (comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66)
      return kRgb;
    return lossless ? kRgb : kYcc;
  }

  // jdhuff.c jinit_huff_decoder: tables 0 and 1 still undefined at the
  // first scan are Annex K's (motion JPEG frames leave them out)
  void std_tables() {
    if (progressive || lossless || arith) return;
    const uint8_t* std[4][2] = {
        {kDcLumaBits, kDcLumaVals}, {kAcLumaBits, kAcLumaVals},
        {kDcChromaBits, kDcChromaVals}, {kAcChromaBits, kAcChromaVals}};
    for (int t = 0; t < 4; t++) {
      HuffSpec& spec = t & 1 ? ac_spec[t >> 1] : dc_spec[t >> 1];
      if (spec.defined) continue;
      int n = 0;
      for (int i = 0; i < 16; i++) n += std[t][0][i];
      std::memcpy(spec.counts, std[t][0], 16);
      std::memset(spec.vals, 0, sizeof(spec.vals));
      std::memcpy(spec.vals, std[t][1], n);
      spec.defined = true;
    }
  }

  // jpeg_read_header: SOI, the markers, the first SOS segment
  int header(Scan& first) {
    if (src.byte() != 0xFF || src.byte() != 0xD8) return kUnreadable;
    const int st = read_markers();
    if (st == kEoi) return kUnreadable;  // no image
    if (st != kSos) return st;
    return get_sos(first);
  }

  int decode_all() {
    Scan first;
    const int st = header(first);
    if (st != kOk) return st;
    std_tables();
    // jpeg_read_header ends with the first SOS segment; then imread's
    // validateInputImageSize raises
    if (!cv2_size_ok(width, height)) return kRaises;
    if (lossless) {
      // libjpeg-turbo refuses a color conversion that is not lossless; and
      // cv2.imread asks gray for BGR, so it gives None where PIL reads it
      const Color cs = color();
      if (cs == kYcc || cs == kYcck) return kLosslessColor;
      if (cv2_reader && cs == kGray) return kUnreadable;
    }
    return read_scans(first, false);
  }

  // Every scan from the first (jpeg_start_decompress); `stream_only`: a
  // JPEG-in-TIFF stream, which libjpeg decodes as any other (not PIL's
  // rule for a gray lossless file).
  int read_scans(Scan first, bool stream_only) {
    // the coefficient (lossless: sample) buffers, which libjpeg allocates
    // in jpeg_start_decompress, past the header's checks
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      if (lossless)
        c.samples.assign(static_cast<size_t>(c.gw) * c.gh, 0);
      else
        c.coef.assign(static_cast<size_t>(c.gw) * c.gh * 64, 0);
    }
    for (bool is_first = true;; is_first = false) {
      Scan sc;
      int st;
      if (is_first) {
        sc = first;
        st = start_scan(sc);
      } else {
        st = read_sos(sc);
      }
      if (st != kOk) return st;
      st = decode_scan(sc);
      if (st != kOk) return st;
      // a gray lossless file is read by PIL, through a source that
      // suspends at the file's end: a scan whose data runs past it is
      // "image file is truncated"
      if (lossless && ncomp == 1 && !stream_only) {
        if (src.pos > src.size) return kUnreadable;
        // jpeg_finish_decompress reads on to EOI: an error there fails
        // PIL's read, a suspension at the file's end does not
        st = read_markers();
        if (st == kSos) {  // libjpeg: "EOI expected"
          Scan extra;
          read_sos(extra);
          st = kUnreadable;
        }
        return st == kEoi || src.pos > src.size ? kOk : kUnreadable;
      }
      // a single scan of every component: libjpeg's one-pass decode,
      // which outputs the image before it reads on
      if (!multi_scan) return kOk;
      st = read_markers();
      if (st == kEoi) return kOk;
      if (st != kSos) return st;
    }
  }

  // jpeg_finish_decompress after a one-pass decode: the markers on to EOI
  // (another SOS is "EOI expected", an error)
  void finish() {
    if (!multi_scan) read_markers();
  }
};

// ---- islow IDCT, one block into an 8x8 window of a plane

// libjpeg-turbo's SIMD islow IDCT (jidctint-avx2.asm / -sse2.asm), which is
// the one cv2.imread runs: jidctint.c's arithmetic rearranged into pmaddwd
// pairs, with 16-bit lanes where the C code has wide integers. On data a
// real encoder writes the two agree; on a block that damaged data fills
// with large values (a scan cut short feeds zero bits) the lanes wrap and
// saturate, and these pixels are the SIMD code's: the dequantisation, the
// sums in0 +- in4, in7 + in3 and in5 + in1 wrap to 16 bits; each pass's
// output saturates to 16 bits and the pixel to 8 (packssdw, packsswb).
// Where every AC row of a block is zero, the first pass is the DC alone,
// shifted in 16 bits.

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433,
                  F0_765 = 6270, F0_899 = 7373, F1_175 = 9633,
                  F1_501 = 12299, F1_847 = 15137, F1_961 = 16069,
                  F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t{1} << (n - 1))) >> n;
}

inline int32_t wrap16(int32_t x) { return static_cast<int16_t>(x); }
inline int32_t sat16(int64_t x) {
  return static_cast<int32_t>(x < -32768 ? -32768 : (x > 32767 ? 32767 : x));
}

// One 1-D pass over in[0..7] (16-bit values) -> out[0..7] before the
// descale, as the SIMD code computes it.
void idct_pass(const int32_t* in, int64_t* out) {
  const int64_t z2 = in[2], z3 = in[6];
  const int64_t tmp3 = z2 * 10703 + z3 * 4433;   // PW_F130_F054
  const int64_t tmp2 = z2 * 4433 + z3 * -10704;  // PW_F054_MF130
  const int64_t tmp0 = int64_t{wrap16(in[0] + in[4])} * (1 << kConstBits);
  const int64_t tmp1 = int64_t{wrap16(in[0] - in[4])} * (1 << kConstBits);
  const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  const int64_t i7 = in[7], i5 = in[5], i3 = in[3], i1 = in[1];
  const int64_t z3o = wrap16(in[7] + in[3]), z4o = wrap16(in[5] + in[1]);
  const int64_t z3p = z3o * -6436 + z4o * 9633;  // PW_MF078_F117
  const int64_t z4p = z3o * 9633 + z4o * 6437;   // PW_F117_F078
  const int64_t o0 = i7 * -4927 + i1 * -7373 + z3p;
  const int64_t o3 = i7 * -7373 + i1 * 4926 + z4p;
  const int64_t o1 = i5 * -4176 + i3 * -20995 + z4p;
  const int64_t o2 = i5 * -20995 + i3 * 4177 + z3p;
  out[0] = tmp10 + o3;
  out[7] = tmp10 - o3;
  out[1] = tmp11 + o2;
  out[6] = tmp11 - o2;
  out[2] = tmp12 + o1;
  out[5] = tmp12 - o1;
  out[3] = tmp13 + o0;
  out[4] = tmp13 - o0;
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                size_t stride) {
  int32_t ws[64];  // the first pass's 16-bit output, [row][column]
  bool ac = false;
  for (int k = 8; k < 64 && !ac; k++) ac = in[k] != 0;
  if (!ac) {
    for (int c = 0; c < 8; c++) {
      const int32_t v = wrap16(wrap16(in[c] * static_cast<int16_t>(q[c])) *
                               (1 << kPass1Bits));
      for (int r = 0; r < 8; r++) ws[8 * r + c] = v;
    }
  } else {
    for (int c = 0; c < 8; c++) {
      int32_t col[8];
      int64_t o[8];
      for (int r = 0; r < 8; r++)
        col[r] = wrap16(in[8 * r + c] * static_cast<int16_t>(q[8 * r + c]));
      idct_pass(col, o);
      const int sh = kConstBits - kPass1Bits;
      for (int r = 0; r < 8; r++)
        ws[8 * r + c] = sat16((o[r] + (int64_t{1} << (sh - 1))) >> sh);
    }
  }
  for (int r = 0; r < 8; r++) {
    int64_t o[8];
    idct_pass(ws + 8 * r, o);
    const int sh = kConstBits + kPass1Bits + 3;
    uint8_t* op = out + stride * r;
    for (int c = 0; c < 8; c++) {
      const int32_t v = sat16((o[c] + (int64_t{1} << (sh - 1))) >> sh);
      op[c] = static_cast<uint8_t>((v < -128 ? -128 : (v > 127 ? 127 : v)) +
                                   128);
    }
  }
}

// ---- upsampling (jdsample.c) of one component to the full-size plane

// `src` holds the component's samples with row stride `ss`; its data are
// c.dw x c.dh. Rows and columns past the data repeat the last ones, as
// jdmainct.c's context pointers and the filters' edge cases do.
void upsample(const Component& c, const uint8_t* src, size_t ss, int maxh,
              int maxv, int width, int height, bool fancy, uint8_t* dst) {
  const int hf = maxh / c.h, vf = maxv / c.v;
  const int dw = c.dw, dh = c.dh;
  auto at = [&](int r, int x) -> int {
    r = r < 0 ? 0 : (r >= dh ? dh - 1 : r);
    x = x < 0 ? 0 : (x >= dw ? dw - 1 : x);
    return src[ss * r + x];
  };
  if (fancy && hf == 2 && vf == 2 && dw > 2) {  // h2v2_fancy_upsample
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
  } else if (fancy && hf == 2 && vf == 1 && dw > 2) {  // h2v1_fancy_upsample
    for (int y = 0; y < height; y++) {
      uint8_t* o = dst + static_cast<size_t>(y) * width;
      for (int x = 0; x < width; x++) {
        const int j = x / 2, s = 3 * at(y, j);
        o[x] = static_cast<uint8_t>(
            (x & 1) ? (s + at(y, j + 1) + 2) >> 2 : (s + at(y, j - 1) + 1) >> 2);
      }
    }
  } else if (fancy && hf == 1 && vf == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < height; y++) {
      const int r = y / 2;
      uint8_t* o = dst + static_cast<size_t>(y) * width;
      for (int x = 0; x < width; x++) {
        const int s = 3 * at(r, x);
        o[x] = static_cast<uint8_t>(
            (y & 1) ? (s + at(r + 1, x) + 2) >> 2 : (s + at(r - 1, x) + 1) >> 2);
      }
    }
  } else {  // fullsize, replication (lossless; narrow data), int_upsample
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


// ---- block smoothing (jdcoefct.c smoothing_ok, decompress_smooth_data)

// libjpeg-turbo >= 2.1 block-smooths progressive data whose DC or first
// nine AC coefficients (SAVED_COEFS = 10) are not all complete, from
// coef_bits as latched at each scan's start: latch[c] now, prev[c] as
// the component's last scan began (used for the iMCU rows past the last
// one decoded before the data ran out). False where it does not smooth.
bool smoothing_ok(const Decoder& d, int latch[4][10], int prev[4][10]) {
  if (!d.progressive) return false;
  bool useful = false;
  for (int i = 0; i < d.ncomp; i++) {
    const Component& c = d.comp[i];
    if (!c.latched) return false;
    for (const int k : {0, 1, 8, 16, 9, 2, 3, 10, 17, 24})
      if (c.q[k] == 0) return false;  // a zero divide
    if (c.bits[0] < 0) return false;
    latch[i][0] = c.bits[0];
    for (int k = 1; k < 10; k++) {
      prev[i][k] = d.scans > 1 ? c.prev_bits[k] : -1;
      latch[i][k] = c.bits[k];
      if (c.bits[k] != 0) useful = true;
    }
  }
  return useful;
}

// An estimate of a coefficient still zero from the DC values around it:
// num / (q << 8) rounded, capped below 2^al when al > 0.
inline int smooth_pred(int64_t num, int64_t q, int al) {
  int pred = static_cast<int>(((q << 7) + (num >= 0 ? num : -num)) /
                              (q << 8));
  if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  return num >= 0 ? pred : -pred;
}

// IDCT of component c's blocks, each smoothed first as
// decompress_smooth_data does: a 5x5 window of DC values (edges repeated;
// its rows picked by libjpeg's iMCU-row arithmetic, last row included)
// estimates AC01-AC02 (and, where no AC of the first nine is known yet,
// AC03-AC30 and the DC itself, "DC interpolation").
void idct_smoothed(const Decoder& d, const Component& c, const int* latch,
                   const int* prev, uint8_t* plane, size_t stride) {
  const int T = d.mcuy;
  const int64_t Q00 = c.q[0], Q01 = c.q[1], Q10 = c.q[8], Q20 = c.q[16],
                Q11 = c.q[9], Q02 = c.q[2], Q03 = c.q[3], Q12 = c.q[10],
                Q21 = c.q[17], Q30 = c.q[24];
  const int last_col = c.wib - 1;
  auto dc_at = [&](int row, int col) -> int {
    col = col < 0 ? 0 : (col > last_col ? last_col : col);
    return c.coef[(static_cast<size_t>(row) * c.gw + col) * 64];
  };
  for (int r = 0; r < T; r++) {
    int block_rows = c.v;
    if (r == T - 1 && c.hib % c.v) block_rows = c.hib % c.v;
    const int image_rows = block_rows * T;
    const int* bits = r > d.last_good_row ? prev : latch;
    bool change_dc = true;
    for (int k = 1; k < 10; k++) change_dc = change_dc && bits[k] == -1;
    for (int b = 0; b < block_rows; b++) {
      const int ibr = r * block_rows + b, row = r * c.v + b;
      const int up = ibr > 0 ? row - 1 : row;
      const int up2 = ibr > 1 ? row - 2 : up;
      const int down = ibr < image_rows - 1 ? row + 1 : row;
      const int down2 = ibr < image_rows - 2 ? row + 2 : down;
      const int rows5[5] = {up2, up, row, down, down2};
      for (int bx = 0; bx < c.wib; bx++) {
        int D[26];  // D[1..25]: libjpeg's DC01..DC25, row by row
        for (int i = 0; i < 5; i++)
          for (int j = 0; j < 5; j++)
            D[1 + 5 * i + j] = dc_at(rows5[i], bx - 2 + j);
        int16_t ws[64];
        std::memcpy(ws, c.coef.data() +
                            (static_cast<size_t>(row) * c.gw + bx) * 64,
                    sizeof(ws));
        int al;
        if ((al = bits[1]) != 0 && ws[1] == 0)
          ws[1] = static_cast<int16_t>(smooth_pred(
              Q00 * (change_dc
                         ? (-D[1] - D[2] + D[4] + D[5] - 3 * D[6] +
                            13 * D[7] - 13 * D[9] + 3 * D[10] - 3 * D[11] +
                            38 * D[12] - 38 * D[14] + 3 * D[15] - 3 * D[16] +
                            13 * D[17] - 13 * D[19] + 3 * D[20] - D[21] -
                            D[22] + D[24] + D[25])
                         : (-7 * D[11] + 50 * D[12] - 50 * D[14] +
                            7 * D[15])),
              Q01, al));
        if ((al = bits[2]) != 0 && ws[8] == 0)
          ws[8] = static_cast<int16_t>(smooth_pred(
              Q00 * (change_dc
                         ? (-D[1] - 3 * D[2] - 3 * D[3] - 3 * D[4] - D[5] -
                            D[6] + 13 * D[7] + 38 * D[8] + 13 * D[9] -
                            D[10] + D[16] - 13 * D[17] - 38 * D[18] -
                            13 * D[19] + D[20] + D[21] + 3 * D[22] +
                            3 * D[23] + 3 * D[24] + D[25])
                         : (-7 * D[3] + 50 * D[8] - 50 * D[18] + 7 * D[23])),
              Q10, al));
        if ((al = bits[3]) != 0 && ws[16] == 0)
          ws[16] = static_cast<int16_t>(smooth_pred(
              Q00 * (change_dc
                         ? (D[3] + 2 * D[7] + 7 * D[8] + 2 * D[9] -
                            5 * D[12] - 14 * D[13] - 5 * D[14] + 2 * D[17] +
                            7 * D[18] + 2 * D[19] + D[23])
                         : (-D[3] + 13 * D[8] - 24 * D[13] + 13 * D[18] -
                            D[23])),
              Q20, al));
        if ((al = bits[4]) != 0 && ws[9] == 0)
          ws[9] = static_cast<int16_t>(smooth_pred(
              Q00 * (change_dc
                         ? (-D[1] + D[5] + 9 * D[7] - 9 * D[9] - 9 * D[17] +
                            9 * D[19] + D[21] - D[25])
                         : (D[10] + D[16] - 10 * D[17] + 10 * D[19] - D[2] -
                            D[20] + D[22] - D[24] + D[4] - D[6] +
                            10 * D[7] - 10 * D[9])),
              Q11, al));
        if ((al = bits[5]) != 0 && ws[2] == 0)
          ws[2] = static_cast<int16_t>(smooth_pred(
              Q00 * (change_dc
                         ? (2 * D[7] - 5 * D[8] + 2 * D[9] + D[11] +
                            7 * D[12] - 14 * D[13] + 7 * D[14] + D[15] +
                            2 * D[17] - 5 * D[18] + 2 * D[19])
                         : (-D[11] + 13 * D[12] - 24 * D[13] + 13 * D[14] -
                            D[15])),
              Q02, al));
        if (change_dc) {
          if ((al = bits[6]) != 0 && ws[3] == 0)
            ws[3] = static_cast<int16_t>(smooth_pred(
                Q00 * (D[7] - D[9] + 2 * D[12] - 2 * D[14] + D[17] - D[19]),
                Q03, al));
          if ((al = bits[7]) != 0 && ws[10] == 0)
            ws[10] = static_cast<int16_t>(smooth_pred(
                Q00 * (D[7] - 3 * D[8] + D[9] - D[17] + 3 * D[18] - D[19]),
                Q12, al));
          if ((al = bits[8]) != 0 && ws[17] == 0)
            ws[17] = static_cast<int16_t>(smooth_pred(
                Q00 * (D[7] - D[9] - 3 * D[12] + 3 * D[14] + D[17] - D[19]),
                Q21, al));
          if ((al = bits[9]) != 0 && ws[24] == 0)
            ws[24] = static_cast<int16_t>(smooth_pred(
                Q00 * (D[7] + 2 * D[8] + D[9] - D[17] - 2 * D[18] - D[19]),
                Q30, al));
          ws[0] = static_cast<int16_t>(smooth_pred(
              Q00 * (-2 * D[1] - 6 * D[2] - 8 * D[3] - 6 * D[4] - 2 * D[5] -
                     6 * D[6] + 6 * D[7] + 42 * D[8] + 6 * D[9] - 6 * D[10] -
                     8 * D[11] + 42 * D[12] + 152 * D[13] + 42 * D[14] -
                     8 * D[15] - 6 * D[16] + 6 * D[17] + 42 * D[18] +
                     6 * D[19] - 6 * D[20] - 2 * D[21] - 6 * D[22] -
                     8 * D[23] - 6 * D[24] - 2 * D[25]),
              Q00, 0));
        }
        idct_islow(ws, c.q, plane + stride * row * 8 + bx * 8, stride);
      }
    }
  }
}

// The output stage up to color conversion: each component IDCT'd (or its
// lossless samples, block-smoothed where libjpeg smooths) and upsampled to
// the frame's width x height.
void full_planes(const Decoder& d, std::vector<std::vector<uint8_t>>& full) {
  const int W = d.width, H = d.height;
  int latch[4][10], prev[4][10];
  const bool smooth = smoothing_ok(d, latch, prev);
  full.assign(d.ncomp, {});
  for (int i = 0; i < d.ncomp; i++) {
    const Component& c = d.comp[i];
    full[i].resize(static_cast<size_t>(W) * H);
    if (d.lossless) {
      upsample(c, c.samples.data(), c.gw, d.maxh, d.maxv, W, H, false,
               full[i].data());
      continue;
    }
    const size_t stride = static_cast<size_t>(c.gw) * 8;
    std::vector<uint8_t> plane(stride * c.gh * 8);
    if (smooth) {
      idct_smoothed(d, c, latch[i], prev[i], plane.data(), stride);
    } else {
      for (int by = 0; by < c.hib; by++)
        for (int bx = 0; bx < c.wib; bx++)
          idct_islow(
              c.coef.data() + (static_cast<size_t>(by) * c.gw + bx) * 64,
              c.q, plane.data() + stride * by * 8 + bx * 8, stride);
    }
    upsample(c, plane.data(), stride, d.maxh, d.maxv, W, H, true,
             full[i].data());
  }
}

int decode_into(const uint8_t* data, size_t n, Image& img) {
  Decoder d;
  d.src.data = data;
  d.src.size = n;
  d.src.chunk = 4096;  // cv2.imread's stdio source (jdatasrc.c)
  const int st = d.decode_all();
  if (st != kOk) return st;
  const int W = d.width, H = d.height;
  std::vector<std::vector<uint8_t>> full;
  full_planes(d, full);
  img.w = W;
  img.h = H;
  img.rgb.resize(static_cast<size_t>(W) * H * 3);
  const size_t npx = static_cast<size_t>(W) * H;
  uint8_t* o = img.rgb.data();
  static const YccTables t;
  const Decoder::Color cs = d.color();
  if (cs == Decoder::kGray) {
    for (size_t k = 0; k < npx; k++) o[3 * k] = o[3 * k + 1] = o[3 * k + 2] =
        full[0][k];
  } else if (cs == Decoder::kCmyk || cs == Decoder::kYcck) {
    // jdcolor.c ycck_cmyk_convert turns YCCK into CMYK (K kept); cv2.imread
    // then turns the (Adobe-inverted) CMYK into BGR with its own integer
    // formula, which these pixels hold to exactly:
    // R = K - ((255 - C) * K >> 8), G and B the same from M and Y.
    for (size_t k = 0; k < npx; k++) {
      int cmy[3] = {full[0][k], full[1][k], full[2][k]};
      const int kk = full[3][k];
      if (cs == Decoder::kYcck) {
        const int y = cmy[0], cb = cmy[1], cr = cmy[2];
        cmy[0] = clamp255(255 - (y + t.cr_r[cr]));
        cmy[1] = clamp255(255 - (y + ((t.cb_g[cb] + t.cr_g[cr]) >> 16)));
        cmy[2] = clamp255(255 - (y + t.cb_b[cb]));
      }
      for (int ch = 0; ch < 3; ch++)
        o[3 * k + ch] =
            static_cast<uint8_t>(kk - (((255 - cmy[ch]) * kk) >> 8));
    }
  } else if (cs == Decoder::kRgb) {
    for (size_t k = 0; k < npx; k++)
      for (int ch = 0; ch < 3; ch++) o[3 * k + ch] = full[ch][k];
  } else {
    for (size_t k = 0; k < npx; k++) {
      const int y = full[0][k], cb = full[1][k], cr = full[2][k];
      o[3 * k] = static_cast<uint8_t>(clamp255(y + t.cr_r[cr]));
      o[3 * k + 1] = static_cast<uint8_t>(
          clamp255(y + ((t.cb_g[cb] + t.cr_g[cr]) >> 16)));
      o[3 * k + 2] = static_cast<uint8_t>(clamp255(y + t.cb_b[cb]));
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

int check_jpeg(const uint8_t* data, size_t n, int* dims) {
  if (!is_jpeg(data, n)) return kUnreadable;
  Decoder d;
  d.src.data = data;
  d.src.size = n;
  d.cv2_reader = true;
  const int st = d.decode_all();
  if (st != kOk) return st;
  const bool swap = d.orientation >= 5;
  dims[0] = swap ? d.width : d.height;
  dims[1] = swap ? d.height : d.width;
  return kOk;
}

int probe_jpeg(FILE* f, int* dims) {
  uint8_t b[4];
  if (std::fseek(f, 0, SEEK_SET) != 0 || std::fread(b, 1, 3, f) != 3 ||
      !is_jpeg(b, 3))
    return kUnreadable;
  std::fseek(f, 2, SEEK_SET);
  int h = 0, w = 0, orientation = 1;
  bool saw_app1 = false, have_frame = false;
  Decoder d;  // the header fields the lossless color rule reads
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
    const int feature = marker_feature(m);
    if (feature != kOk) return feature;
    const bool sof = (m >= 0xC0 && m <= 0xC3) || (m >= 0xC9 && m <= 0xCB);
    if (sof || m == 0xE0 || m == 0xEE || (m == 0xE1 && !saw_app1)) {
      seg.resize(static_cast<size_t>(len));
      if (len && std::fread(seg.data(), 1, seg.size(), f) != seg.size())
        return kUnreadable;
      if (sof) {
        if (have_frame || len < 6) return kUnreadable;
        if (seg[0] != 8) return kPrecision;
        h = be16(&seg[1]);
        w = be16(&seg[3]);
        d.ncomp = seg[5];
        if (d.ncomp != 1 && d.ncomp != 3 && d.ncomp != 4) return kComponents;
        if (m == 0xCB) return kLosslessArithmetic;
        d.lossless = m == 0xC3;
        for (int i = 0; i < d.ncomp && 6 + 3 * i < len; i++)
          d.comp[i].id = seg[6 + 3 * i];
        have_frame = true;
      } else if (m == 0xE0) {
        d.jfif = d.jfif ||
                 (len >= 14 && !std::memcmp(seg.data(), "JFIF\0", 5));
      } else if (m == 0xEE) {
        if (len >= 12 && !std::memcmp(seg.data(), "Adobe", 5)) {
          d.adobe = true;
          d.adobe_transform = seg[11];
        }
      } else {
        saw_app1 = true;
        if (len >= 6 && !std::memcmp(seg.data(), "Exif\0\0", 6))
          orientation = tiff_orientation(seg.data() + 6, len - 6);
      }
    } else if (std::fseek(f, len, SEEK_CUR) != 0) {
      return kUnreadable;
    }
  }
  if (!have_frame || h <= 0 || w <= 0 || h > 65500 || w > 65500)
    return kUnreadable;
  if (!cv2_size_ok(w, h)) return kRaises;
  if (d.lossless && (d.color() == Decoder::kYcc ||
                     d.color() == Decoder::kYcck))
    return kLosslessColor;
  const bool swap = orientation >= 5;
  dims[0] = swap ? w : h;
  dims[1] = swap ? h : w;
  return kOk;
}

// ---- JPEG-in-TIFF

// What one libjpeg decompressor keeps from stream to stream (the
// quantisation and Huffman tables: jpeg_abort and SOI reset the rest), and
// the stream being read.
struct TiffJpeg::Impl {
  uint16_t qt[4][64];
  bool qt_defined[4] = {};
  HuffSpec dc[4], ac[4];
  std::unique_ptr<Decoder> d;
  Decoder::Scan first;
  void load(Decoder& x) const {
    std::memcpy(x.qt, qt, sizeof(qt));
    std::memcpy(x.qt_defined, qt_defined, sizeof(qt_defined));
    for (int i = 0; i < 4; i++) x.dc_spec[i] = dc[i], x.ac_spec[i] = ac[i];
  }
  void save(const Decoder& x) {
    std::memcpy(qt, x.qt, sizeof(qt));
    std::memcpy(qt_defined, x.qt_defined, sizeof(qt_defined));
    for (int i = 0; i < 4; i++) dc[i] = x.dc_spec[i], ac[i] = x.ac_spec[i];
  }
  Decoder& start(const uint8_t* data, size_t n) {
    d = std::make_unique<Decoder>();
    load(*d);
    d->src.data = data;
    d->src.size = n;
    return *d;
  }
};

TiffJpeg::TiffJpeg() : p_(new Impl) {}
TiffJpeg::~TiffJpeg() { delete p_; }

bool TiffJpeg::tables(const uint8_t* data, size_t n) {
  Decoder& d = p_->start(data, n);
  // jpeg_read_header(FALSE): SOI, then markers to EOI (a frame without a
  // scan is an error); a scan makes it no tables-only stream
  const bool ok = d.src.byte() == 0xFF && d.src.byte() == 0xD8 &&
                  d.read_markers() == Decoder::kEoi && !d.have_frame;
  p_->save(d);
  p_->d.reset();
  return ok;
}

bool TiffJpeg::header(const uint8_t* data, size_t n, Frame& f) {
  Decoder& d = p_->start(data, n);
  const int st = d.header(p_->first);
  p_->save(d);
  if (st != kOk) {
    p_->d.reset();
    return false;
  }
  f.w = d.width;
  f.h = d.height;
  f.ncomp = d.ncomp;
  for (int i = 0; i < d.ncomp; i++) {
    f.hs[i] = d.comp[i].h;
    f.vs[i] = d.comp[i].v;
  }
  return true;
}

bool TiffJpeg::decode(bool rgb, std::vector<uint8_t>& out) {
  if (!p_->d) return false;
  Decoder& d = *p_->d;
  d.std_tables();
  // libjpeg-turbo converts no lossless data, and YCbCr needs 3 components
  int st = (rgb && (d.lossless || d.ncomp != 3)) ? kUnreadable : kOk;
  if (st == kOk) st = d.read_scans(p_->first, true);
  p_->save(d);
  if (st != kOk) return false;
  std::vector<std::vector<uint8_t>> full;
  full_planes(d, full);
  const size_t npx = static_cast<size_t>(d.width) * d.height;
  const int nc = d.ncomp;
  out.resize(npx * nc);
  uint8_t* o = out.data();
  if (rgb) {
    static const YccTables t;
    for (size_t k = 0; k < npx; k++) {
      const int y = full[0][k], cb = full[1][k], cr = full[2][k];
      o[3 * k] = static_cast<uint8_t>(clamp255(y + t.cr_r[cr]));
      o[3 * k + 1] = static_cast<uint8_t>(
          clamp255(y + ((t.cb_g[cb] + t.cr_g[cr]) >> 16)));
      o[3 * k + 2] = static_cast<uint8_t>(clamp255(y + t.cb_b[cb]));
    }
  } else {
    for (size_t k = 0; k < npx; k++)
      for (int c = 0; c < nc; c++) o[nc * k + c] = full[c][k];
  }
  return true;
}

void TiffJpeg::finish() {
  if (!p_->d) return;
  p_->d->finish();
  p_->save(*p_->d);
}

int ojpeg_decode(const uint8_t* data, size_t n, const std::vector<size_t>& bounds,
                 bool dry, bool raw, OjpegImage& out) {
  Decoder d;
  d.src.data = data;
  d.src.size = n;
  d.src.bounds = &bounds;
  if (dry) d.src.dry = n;
  d.strict_restart = true;
  Decoder::Scan first;
  if (d.header(first) != kOk) return -1;  // jpeg_read_header
  d.std_tables();
  // jpeg_start_decompress (raw data of a lossless frame is not taken),
  // then the scan
  if (d.lossless || d.read_scans(first, true) != kOk) return -1;
  out.w = d.width;
  out.h = d.height;
  out.ncomp = d.ncomp;
  out.maxh = d.maxh;
  out.maxv = d.maxv;
  out.imcu_rows = d.mcuy;
  const int cols = d.ncomp == 1 ? d.comp[0].wib : d.mcux;
  out.fail_row = d.fail_mcu < 0 ? -1 : static_cast<int>(d.fail_mcu / cols);
  out.planes.assign(d.ncomp, {});
  if (!raw) {
    std::vector<std::vector<uint8_t>> full;
    full_planes(d, full);
    const size_t npx = static_cast<size_t>(d.width) * d.height;
    out.stride = d.width * d.ncomp;
    out.planes[0].resize(npx * d.ncomp);
    for (size_t k = 0; k < npx; k++)
      for (int c = 0; c < d.ncomp; c++) out.planes[0][d.ncomp * k + c] = full[c][k];
    return 1;
  }
  // jpeg_read_raw_data's planes: each block of image data through the IDCT
  // (the MCUs' dummy blocks left as the buffer held them, zeros), the rows
  // past the data in the last iMCU row still those of the row before
  out.widths.assign(d.ncomp, 0);
  for (int i = 0; i < d.ncomp; i++) {
    const Component& c = d.comp[i];
    const size_t stride = static_cast<size_t>(c.gw) * 8;
    std::vector<uint8_t>& plane = out.planes[i];
    plane.assign(stride * c.gh * 8, 0);
    for (int by = 0; by < c.hib; by++)
      for (int bx = 0; bx < c.wib; bx++)
        idct_islow(c.coef.data() + (static_cast<size_t>(by) * c.gw + bx) * 64, c.q,
                   plane.data() + stride * by * 8 + bx * 8, stride);
    const size_t imcu = static_cast<size_t>(c.v) * 8;
    for (size_t r = static_cast<size_t>(c.hib) * 8; r < static_cast<size_t>(c.gh) * 8; r++)
      if (r >= imcu)
        std::memcpy(&plane[r * stride], &plane[(r - imcu) * stride], stride);
    out.widths[i] = static_cast<int>(stride);
  }
  return 1;
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
