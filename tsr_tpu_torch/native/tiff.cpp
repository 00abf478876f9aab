// tiff.cpp — TIFF read as the reference reads it: cv2.imread first, else
// PIL's Image.open(path).convert("RGB").
//
// Classic TIFF (either byte order), the first IFD, strips of 8-bit samples:
// MINISBLACK gray, RGB and PALETTE (a 16-bit ColorMap), uncompressed,
// PackBits, LZW (old-style codes too) or deflate, with or without the
// horizontal predictor. Two readers, each a copy of what its library does:
//   - tiff_cv2: OpenCV 5's TiffDecoder over libtiff 4.7. The directory is
//     read by libtiff's rules (TIFFReadDirectory: the first of duplicate
//     tags wins, a bad required tag refuses the file, a bad optional one is
//     dropped, a palette without a usable ColorMap becomes gray, a missing
//     or implausible StripByteCounts is estimated; OpenCV's build does not
//     chop a large strip into smaller ones); OpenCV then needs the
//     Photometric tag, 8-bit samples of format 1 or 2 and what libtiff's
//     RGBA reader accepts, and reads each strip through TIFFReadRGBAStrip.
//     That reader refuses the whole image where a strip's byte count is 0
//     or runs past the end of the file, but keeps what a damaged strip
//     decoded before its error (the rest of the strip 0, the predictor not
//     applied). Orientations 2-4 flip the image; 5-8 make imread give None.
//     A ColorMap with no entry past 255 is taken as 8-bit.
//   - tiff_pil: Pillow 12's TiffImagePlugin and convert("RGB"), for the
//     files cv2 refuses: its own IFD parser (the last of duplicate tags
//     wins; a tag whose data lies past the end of the file ends the IFD),
//     its own reader of uncompressed strips (every strip whole, bytes
//     counts ignored) and libtiff for compressed ones (every strip must
//     decode without error), orientation applied as ImageOps.exif_transpose
//     applies it, a ColorMap always 16-bit.
// Any other layout that the reader would accept (tiles, 1-bit or 16-bit
// samples, MINISWHITE, CMYK, YCbCr, extra samples, planar configuration 2,
// another compression or fill order, a sample format other than 1) gives
// kTiff: the port does not decode it. Each runs on a whole file in memory,
// or, for the header probe, on an open file read where its IFD points.

#include <zlib.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include "codec.h"

namespace tsrio {
namespace {

enum Tag : uint16_t {
  kWidth = 256, kLength = 257, kBps = 258, kCompression = 259,
  kPhotometric = 262, kFillOrder = 266, kStripOffsets = 273,
  kOrientation = 274, kSpp = 277, kRps = 278, kStripByteCounts = 279,
  kMinSample = 280, kMaxSample = 281, kPlanar = 284, kTransfer = 301,
  kPredictor = 317, kColorMap = 320, kTileWidth = 322, kTileLength = 323,
  kTileOffsets = 324, kTileByteCounts = 325, kExtraSamples = 338,
  kSampleFormat = 339, kSMinSample = 340, kSMaxSample = 341,
  kDataType = 32996, kImageDepth = 32997, kTileDepth = 32998,
};

// The compressions the port decodes
bool part1_compression(int c) {
  return c == 1 || c == 5 || c == 8 || c == 32773 || c == 32946;
}

// ------------------------------------------------------------- the file

// A file in memory, or an open FILE read on demand (the header probe).
struct Src {
  const uint8_t* d = nullptr;
  FILE* f = nullptr;
  uint64_t n = 0;
  bool be = false;  // "MM": big endian
  bool read(uint64_t off, uint64_t len, uint8_t* out) const {
    if (off > n || len > n - off) return false;
    if (!len) return true;
    if (d) {
      std::memcpy(out, d + off, len);
      return true;
    }
    return fseeko(f, static_cast<off_t>(off), SEEK_SET) == 0 &&
           std::fread(out, 1, len, f) == len;
  }
  uint16_t u16(const uint8_t* p) const {
    return be ? (p[0] << 8) | p[1] : p[0] | (p[1] << 8);
  }
  uint32_t u32(const uint8_t* p) const {
    return be ? (uint32_t{p[0]} << 24) | (p[1] << 16) | (p[2] << 8) | p[3]
              : p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t{p[3]} << 24);
  }
  uint64_t u64(const uint8_t* p) const {
    const uint64_t a = u32(p), b = u32(p + 4);
    return be ? (a << 32) | b : (b << 32) | a;
  }
};

struct Entry {
  uint16_t tag = 0, type = 0;
  uint32_t count = 0;
  uint8_t raw[4] = {0, 0, 0, 0};
  bool ignore = false;
};

// TIFFDataWidth (type 0 counts one byte; an unknown type none)
int type_width(int t) {
  switch (t) {
    case 0: case 1: case 2: case 6: case 7: return 1;
    case 3: case 8: return 2;
    case 4: case 9: case 11: case 13: return 4;
    case 5: case 10: case 12: case 16: case 17: case 18: return 8;
    default: return 0;
  }
}

// The first `count` values of the entry's data: inline where all of it
// fits in 4 bytes, else at its offset.
bool entry_bytes(const Src& s, const Entry& e, uint64_t count,
                 std::vector<uint8_t>& out) {
  const uint64_t size = count * type_width(e.type);
  if (uint64_t{e.count} * type_width(e.type) <= 4) {
    out.assign(e.raw, e.raw + size);
    return true;
  }
  const uint64_t off = s.u32(e.raw);
  if (off > s.n || size > s.n - off) return false;  // before allocating
  out.resize(size);
  return s.read(off, size, out.data());
}

// ------------------------------------------------- libtiff's directory

enum Err { kErrOk, kErrCount, kErrType, kErrIo, kErrRange, kErrPsdif };

// Element i of an integer entry's data, with libtiff's range rules for
// an unsigned target of `max`; kErrType for a type that is no integer.
Err int_at(const Src& s, int type, const uint8_t* p, uint64_t max,
           uint64_t& v) {
  int64_t sv;
  switch (type) {
    case 1: v = p[0]; break;
    case 3: v = s.u16(p); break;
    case 4: case 13: v = s.u32(p); break;
    case 16: case 18: v = s.u64(p); break;
    case 6: sv = static_cast<int8_t>(p[0]); goto is_signed;
    case 8: sv = static_cast<int16_t>(s.u16(p)); goto is_signed;
    case 9: sv = static_cast<int32_t>(s.u32(p)); goto is_signed;
    case 17: sv = static_cast<int64_t>(s.u64(p)); goto is_signed;
    default: return kErrType;
  }
  return v > max ? kErrRange : kErrOk;
is_signed:
  if (sv < 0) return kErrRange;
  v = static_cast<uint64_t>(sv);
  return v > max ? kErrRange : kErrOk;
}

bool int_type(int t, bool ifd) {
  return t == 1 || t == 3 || t == 4 || t == 6 || t == 8 || t == 9 ||
         t == 16 || t == 17 || (ifd && (t == 13 || t == 18));
}

// TIFFReadDirEntryShort / Long: one value.
Err read_one(const Src& s, const Entry& e, uint64_t max, uint64_t& v,
             bool ifd = false) {
  if (e.count != 1) return kErrCount;
  if (!int_type(e.type, ifd)) return kErrType;
  std::vector<uint8_t> b;
  if (!entry_bytes(s, e, 1, b)) return kErrIo;
  return int_at(s, e.type, b.data(), max, v);
}

// TIFFReadDirEntryShortArray / Long8Array: up to `limit` values.
Err read_array(const Src& s, const Entry& e, uint64_t max,
               std::vector<uint64_t>& v, uint64_t limit = UINT64_MAX,
               bool ifd = false) {
  v.clear();
  if (!int_type(e.type, ifd)) return kErrType;
  if (e.count == 0) return kErrOk;
  const uint64_t count = std::min<uint64_t>(e.count, limit);
  std::vector<uint8_t> b;
  if (!entry_bytes(s, e, count, b)) return kErrIo;
  v.resize(count);
  const int w = type_width(e.type);
  for (uint64_t i = 0; i < count; i++) {
    const Err err = int_at(s, e.type, b.data() + i * w, max, v[i]);
    if (err != kErrOk) return err;
  }
  return kErrOk;
}

struct Dir {
  Src src;
  std::vector<Entry> entries;
  uint32_t w = 0, h = 0, rps = 0xFFFFFFFFu;
  bool dims_set = false, rps_set = false, tiled = false, photo_set = false;
  bool cmap_set = false;
  uint16_t spp = 1, bps = 1, compression = 1, photometric = 0, planar = 1;
  uint16_t orientation = 1, predictor = 1, fillorder = 1, sampleformat = 1;
  uint16_t extrasamples = 0;
  std::vector<uint16_t> cmap;  // 3 x 256 for 8-bit samples
  uint32_t nstrips = 0;
  std::vector<uint64_t> offsets, counts;
  uint64_t scanline = 0;
};

uint32_t howmany32(uint32_t x, uint32_t y) {
  return x < 0xFFFFFFFFu - (y - 1) ? (x + y - 1) / y : 0;
}

// TIFFFetchStripThing: `nstrips` values, zeros past the entry's count
// (none without an entry); false where the entry does not read, which
// fails the directory.
bool strip_thing(const Dir& t, const Entry* e, std::vector<uint64_t>& v) {
  v.clear();
  if (e && read_array(t.src, *e, UINT64_MAX, v, t.nstrips, true) != kErrOk)
    return false;
  // a short array is padded only up to 1,000,000 strips
  if (e && e->count < t.nstrips && t.nstrips > 1000000) return false;
  if (e) v.resize(t.nstrips, 0);
  return true;
}

uint64_t file_scanline(const Dir& t) {
  const uint64_t samples = uint64_t{t.w} * (t.planar == 2 ? 1 : t.spp);
  return (samples * t.bps + 7) / 8;
}

int color_channels(int photometric) {
  switch (photometric) {
    case 0: case 1: case 3: return 1;
    case 2: case 6: case 8: case 9: case 10: case 32845: return 3;
    case 5: case 4: return 4;
    default: return 0;
  }
}

// TIFFClientOpen + TIFFReadDirectory: false where libtiff refuses the file.
bool read_dir(Dir& t) {
  const Src& s = t.src;
  uint8_t hd[8];
  if (!s.read(0, 8, hd) || s.u16(hd + 2) != 42) return false;
  const uint64_t off = s.u32(hd + 4);
  uint8_t c2[2];
  if (!s.read(off, 2, c2)) return false;
  const uint16_t n = s.u16(c2);
  if (n == 0 || n > 4096) return false;
  std::vector<uint8_t> raw(12 * size_t{n});
  if (!s.read(off + 2, raw.size(), raw.data())) return false;
  t.entries.resize(n);
  for (int i = 0; i < n; i++) {
    Entry& e = t.entries[i];
    const uint8_t* p = &raw[12 * i];
    e.tag = s.u16(p);
    e.type = s.u16(p + 2);
    e.count = s.u32(p + 4);
    std::memcpy(e.raw, p + 8, 4);
    for (int k = 0; k < i && !e.ignore; k++)
      e.ignore = t.entries[k].tag == e.tag;  // the first of duplicates
  }
  auto find = [&](uint16_t tag) -> Entry* {
    for (Entry& e : t.entries)
      if (e.tag == tag && !e.ignore) return &e;
    return nullptr;
  };
  uint64_t v;
  if (Entry* e = find(kSpp)) {
    if (read_one(s, *e, 0xFFFF, v) != kErrOk || v == 0) return false;
    t.spp = static_cast<uint16_t>(v);
    e->ignore = true;
  }
  // Compression: one value, or one a sample (all equal)
  auto short_or_persample = [&](const Entry& e, uint64_t& out) {
    Err err = read_one(s, e, 0xFFFF, out);
    if (err != kErrCount) return err;
    if (e.count < t.spp) return kErrCount;
    std::vector<uint64_t> a;
    err = read_array(s, e, 0xFFFF, a);
    if (err != kErrOk) return err;
    out = a[0];
    for (int i = 1; i < t.spp; i++)
      if (a[i] != out) return kErrPsdif;
    return kErrOk;
  };
  if (Entry* e = find(kCompression)) {
    if (short_or_persample(*e, v) != kErrOk) return false;
    t.compression = static_cast<uint16_t>(v);
    e->ignore = true;
  }
  const bool predictor_codec = t.compression == 5 || t.compression == 8 ||
                               t.compression == 32946;
  bool offsets_set = false, counts_set = false;
  Entry *offsets_e = nullptr, *counts_e = nullptr;
  // first pass: the fields that size the image
  for (Entry& e : t.entries) {
    if (e.ignore) continue;
    switch (e.tag) {
      case kStripOffsets: case kTileOffsets:
        offsets_set = true;
        break;
      case kStripByteCounts: case kTileByteCounts:
        counts_set = true;
        break;
      case kWidth: case kLength: case kRps: case kTileWidth:
      case kTileLength: case kImageDepth: case kTileDepth:
        if (read_one(s, e, 0xFFFFFFFFu, v) != kErrOk) return false;
        if (e.tag == kWidth || e.tag == kLength) {
          (e.tag == kWidth ? t.w : t.h) = static_cast<uint32_t>(v);
          t.dims_set = true;
        } else if (e.tag == kRps) {
          if (v == 0) return false;
          t.rps = static_cast<uint32_t>(v);
          t.rps_set = true;
        } else if (e.tag == kTileWidth || e.tag == kTileLength) {
          t.tiled = true;
        }
        e.ignore = true;
        break;
      case kPlanar:
        if (read_one(s, e, 0xFFFF, v) != kErrOk || (v != 1 && v != 2))
          return false;
        t.planar = static_cast<uint16_t>(v);
        e.ignore = true;
        break;
      case kExtraSamples: {
        std::vector<uint64_t> a;
        if (read_array(s, e, 0xFFFF, a) != kErrOk || a.size() > t.spp)
          return false;
        for (uint64_t x : a)
          if (x > 2 && x != 999) return false;
        t.extrasamples = static_cast<uint16_t>(a.size());
        e.ignore = true;
        break;
      }
      case kPredictor:
        if (!predictor_codec) e.ignore = true;
        break;
      default:
        break;
    }
  }
  if (!t.dims_set) return false;
  if (t.tiled) return true;  // classified by the caller: tiles are not decoded
  t.nstrips = t.rps == 0xFFFFFFFFu ? 1 : howmany32(t.h, t.rps);
  if (t.planar == 2) t.nstrips *= t.spp;
  if (t.nstrips == 0 || !offsets_set) return false;
  // second pass: the rest, in the IFD's order
  bool bps_read = false;
  for (Entry& e : t.entries) {
    if (e.ignore) continue;
    switch (e.tag) {
      case kBps: case kSampleFormat: case kMinSample: case kMaxSample:
      case kDataType:
        if (short_or_persample(e, v) != kErrOk) return false;
        if (e.tag == kBps) {
          t.bps = static_cast<uint16_t>(v);
          bps_read = true;
        } else if (e.tag == kSampleFormat) {
          if (v < 1 || v > 6) return false;
          t.sampleformat = static_cast<uint16_t>(v);
        }
        break;
      case kSMinSample: case kSMaxSample: {
        // doubles, exactly one a sample, of any numeric type
        if (e.count != t.spp || e.type < 1 || e.type > 18 || e.type == 2 ||
            e.type == 7 || e.type == 14 || e.type == 15)
          return false;
        std::vector<uint8_t> b;
        if (!entry_bytes(s, e, e.count, b)) return false;
        break;
      }
      case kStripOffsets: case kTileOffsets:
        offsets_e = &e;
        break;
      case kStripByteCounts: case kTileByteCounts:
        counts_e = &e;
        break;
      case kColorMap: case kTransfer: {
        if (!bps_read || t.bps > 24) break;
        const uint64_t per = uint64_t{1} << t.bps;
        const uint64_t want =
            e.tag == kTransfer && e.count == per ? per : 3 * per;
        std::vector<uint64_t> a;
        if (e.count != want || read_array(s, e, 0xFFFF, a) != kErrOk) break;
        if (e.tag == kColorMap) {
          t.cmap.assign(a.begin(), a.end());
          t.cmap_set = true;
        }
        break;
      }
      case kPhotometric:
        if (read_one(s, e, 0xFFFF, v) == kErrOk) {
          t.photometric = static_cast<uint16_t>(v);
          t.photo_set = true;
        }
        break;
      case kOrientation:
        if (read_one(s, e, 0xFFFF, v) == kErrOk && v >= 1 && v <= 8) {
          t.orientation = static_cast<uint16_t>(v);
        }
        break;
      case kFillOrder:
        if (read_one(s, e, 0xFFFF, v) == kErrOk && (v == 1 || v == 2))
          t.fillorder = static_cast<uint16_t>(v);
        break;
      case kPredictor:
        if (read_one(s, e, 0xFFFF, v) == kErrOk)
          t.predictor = static_cast<uint16_t>(v);
        break;
      default:
        break;
    }
  }
  // non-color channels are extra samples
  const int cc = color_channels(t.photometric);
  if (cc && t.spp - t.extrasamples > cc) t.extrasamples = t.spp - cc;
  // a palette without a usable ColorMap
  if (t.photometric == 3 && !t.cmap_set) {
    if (t.bps >= 8 && t.spp == 3) t.photometric = 2;
    else if (t.bps >= 8) t.photometric = 1;
    else return false;
  }
  if (!strip_thing(t, offsets_e, t.offsets) ||
      !strip_thing(t, counts_e, t.counts))
    return false;
  auto offset = [&](uint32_t i) { return t.offsets.empty() ? 0 : t.offsets[i]; };
  auto count = [&](uint32_t i) { return t.counts.empty() ? 0 : t.counts[i]; };
  t.scanline = file_scanline(t);
  const uint64_t filesize = s.n;
  // EstimateStripByteCounts
  auto estimate = [&]() {
    std::vector<uint64_t> est(t.nstrips);
    if (t.compression != 1) {
      uint64_t space = 8 + 2 + 12 * uint64_t{n} + 4;
      for (const Entry& e : t.entries) {
        const int tw = type_width(e.type);
        if (!tw) return false;
        const uint64_t size = uint64_t{e.count} * tw;
        space += size <= 4 ? 0 : size;
      }
      space = filesize < space ? filesize : filesize - space;
      if (t.planar == 2) space /= t.spp;
      std::fill(est.begin(), est.end(), space);
      const uint32_t last = t.nstrips - 1;
      if (offset(last) + est[last] > filesize)
        est[last] = offset(last) >= filesize ? 0 : filesize - offset(last);
    } else {
      const uint32_t per_image = t.planar == 2 ? t.nstrips / t.spp : t.nstrips;
      const uint64_t rows = per_image ? t.h / per_image : 0;
      std::fill(est.begin(), est.end(), t.scanline * rows);
    }
    if (t.offsets.empty()) t.offsets.assign(t.nstrips, 0);
    t.counts = est;
    if (!t.rps_set) t.rps = t.h;
    return true;
  };
  if (!counts_set) {
    if ((t.planar == 1 && t.nstrips > 1) ||
        (t.planar == 2 && t.nstrips != t.spp))
      return false;
    if (!estimate()) return false;
  } else if (t.nstrips == 1 && [&] {  // ByteCountLooksBad
               const uint64_t bc = count(0), of = offset(0);
               if (of == 0) return false;
               if (bc == 0) return true;
               if (t.compression != 1) return false;
               if (of <= filesize && bc > filesize - of) return true;
               return bc < t.scanline * t.h;
             }()) {
    if (!estimate()) return false;
  } else if (t.planar == 1 && t.nstrips > 2 && t.compression == 1 &&
             count(0) != count(1) && count(0) && count(1)) {
    if (!estimate()) return false;
  }
  if (t.offsets.empty()) t.offsets.assign(t.nstrips, 0);
  if (t.counts.empty()) t.counts.assign(t.nstrips, 0);
  // "Cannot handle zero scanline size", "... zero strip size" (a strip
  // past INT64_MAX bytes reads as size 0 too)
  const uint64_t strip_rows = std::min<uint64_t>(t.rps, t.h);
  if (t.scanline == 0 || t.h == 0 ||
      t.scanline > static_cast<uint64_t>(INT64_MAX) / strip_rows)
    return false;
  return true;
}

// ------------------------------------------------------------ decoders

// PackBitsDecode over a whole strip: false on its error (the bytes written
// before it stay, the rest 0).
bool packbits(const uint8_t* in, size_t cc, uint8_t* op, size_t occ) {
  while (cc > 0 && occ > 0) {
    long n = static_cast<int8_t>(*in++);
    cc--;
    if (n < 0) {
      if (n == -128) continue;
      n = -n + 1;
      if (occ < static_cast<size_t>(n)) n = static_cast<long>(occ);
      if (cc == 0) break;
      occ -= n;
      const uint8_t b = *in++;
      cc--;
      std::memset(op, b, n);
      op += n;
    } else {
      if (occ < static_cast<size_t>(n + 1)) n = static_cast<long>(occ) - 1;
      if (cc < static_cast<size_t>(n + 1)) break;
      ++n;
      std::memcpy(op, in, n);
      op += n;
      occ -= n;
      in += n;
      cc -= n;
    }
  }
  return occ == 0;
}

// libtiff's LZW decoders over a whole strip: MSB-first codes with the
// early width change, or, with `compat`, old-style LSB-first codes. False
// on an error; the bytes written before it stay, the rest 0.
bool lzw(const uint8_t* in, size_t cc, uint8_t* op, size_t occ, bool compat) {
  constexpr int kClear = 256, kEoi = 257, kFirst = 258, kSize = 4096;
  struct Code {
    int next;  // -1: none
    uint16_t length;
    uint8_t value, firstchar;
  };
  std::vector<Code> tab(kSize);
  for (int i = 0; i < 256; i++) tab[i] = {-1, 1, static_cast<uint8_t>(i),
                                          static_cast<uint8_t>(i)};
  int nbits = 9;
  uint64_t bitsleft = uint64_t{cc} * 8;
  uint64_t data = 0;
  int have = 0;
  size_t pos = 0;
  // the next code, or -1 where the data ends first
  auto next = [&]() -> int {
    if (bitsleft < static_cast<uint64_t>(nbits)) return -1;
    bitsleft -= nbits;
    while (have < nbits) {
      if (compat) data |= uint64_t{in[pos++]} << have;
      else data = (data << 8) | in[pos++];
      have += 8;
    }
    int code;
    if (compat) {
      code = static_cast<int>(data & ((1u << nbits) - 1));
      data >>= nbits;
    } else {
      code = static_cast<int>((data >> (have - nbits)) & ((1u << nbits) - 1));
    }
    have -= nbits;
    return code;
  };
  // the width grows when the next entry passes maxcode (one entry later in
  // the old-style decoder, once a clear code has set it); until the first
  // clear code there is no table (-1): any other code is an error
  const int bump = compat ? 0 : 1;
  int free_ent = -1, maxcode = (1 << nbits) - 2;
  int old = 0;  // the previous code's entry (entry 0 at the start)
  auto put_string = [&](int code) {
    const Code& c = tab[code];
    if (c.length > occ) {  // the part that fits
      int k = code;
      while (tab[k].length > occ) k = tab[k].next;
      for (size_t i = occ; i-- > 0;) {
        op[i] = tab[k].value;
        k = tab[k].next;
      }
      occ = 0;
      return;
    }
    int k = code;
    for (size_t i = c.length; i-- > 0 && k >= 0;) {
      op[i] = tab[k].value;
      k = tab[k].next;
    }
    op += c.length;
    occ -= c.length;
  };
  while (occ > 0) {
    int code = next();
    if (code < 0) return false;  // the data ends before an EOI code
    if (code == kEoi) break;
    if (code == kClear) {
      free_ent = kFirst;
      nbits = 9;
      maxcode = (1 << nbits) - 1 - bump;
      do {
        code = next();
        if (code < 0) return false;
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kEoi) return false;
      *op++ = static_cast<uint8_t>(code);
      occ--;
      old = code;
      continue;
    }
    if (free_ent < 0 || free_ent >= kSize) return false;  // the table is full
    if (code >= kFirst && code > free_ent) return false;  // not yet in it
    Code& e = tab[free_ent];
    e.next = old;
    e.firstchar = tab[old].firstchar;
    e.length = static_cast<uint16_t>(tab[old].length + 1);
    e.value = code < free_ent ? tab[code].firstchar : tab[old].firstchar;
    if (++free_ent > maxcode) {
      if (++nbits > 12) nbits = 12;
      maxcode = (1 << nbits) - 1 - bump;
      if (free_ent >= kSize && !compat) free_ent = -1;
    }
    old = code;
    if (code >= 256) {
      if (tab[code].length == 0) return false;
      put_string(code);
    } else {
      *op++ = static_cast<uint8_t>(code);
      occ--;
    }
  }
  return occ == 0;
}

// ZIPDecode: inflate with Z_PARTIAL_FLUSH until the strip is full.
bool deflate_strip(const uint8_t* in, size_t cc, uint8_t* op, size_t occ) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<uint8_t*>(in);
  zs.next_out = op;
  bool ok = true;
  do {
    zs.avail_in = static_cast<uInt>(std::min<size_t>(cc, 0xFFFFFFFFu));
    zs.avail_out = static_cast<uInt>(std::min<size_t>(occ, 0xFFFFFFFEu));
    const uInt in0 = zs.avail_in, out0 = zs.avail_out;
    const int st = inflate(&zs, Z_PARTIAL_FLUSH);
    cc -= in0 - zs.avail_in;
    occ -= out0 - zs.avail_out;
    if (st == Z_STREAM_END) break;
    if (st != Z_OK) {
      ok = false;
      break;
    }
  } while (occ > 0);
  inflateEnd(&zs);
  return ok && occ == 0;
}

// libtiff picks its LZW decoder once, at the first strip it reads (strip
// 0): the old-style one where that strip starts 0x00 then an odd byte.
bool lzw_compat(const Dir& t) {
  uint8_t b[2];
  return t.compression == 5 && t.nstrips && t.counts[0] >= 2 &&
         t.src.read(t.offsets[0], 2, b) && b[0] == 0 && (b[1] & 1);
}

// One strip's bytes as libtiff's decodestrip gives them: false on a
// decoder error (what it wrote stays), the predictor applied on success.
bool decode_strip(const Dir& t, const uint8_t* in, size_t cc, uint8_t* out,
                  size_t occ, bool compat) {
  bool ok;
  switch (t.compression) {
    case 1:  // DumpModeDecode: all or nothing
      ok = cc >= occ;
      if (ok) std::memcpy(out, in, occ);
      break;
    case 32773: ok = packbits(in, cc, out, occ); break;
    case 5: ok = lzw(in, cc, out, occ, compat); break;
    default: ok = deflate_strip(in, cc, out, occ); break;
  }
  if (ok && t.predictor == 2 && t.compression != 1 && t.compression != 32773) {
    const size_t row = t.scanline, stride = t.spp;
    for (size_t r = 0; r + row <= occ; r += row)
      for (size_t i = stride; i < row; i++)
        out[r + i] = static_cast<uint8_t>(out[r + i] + out[r + i - stride]);
  }
  return ok;
}

// TIFFFillStrip and the decoder's setup: the strip's place in the file
// (offset, byte count), or false where libtiff refuses to read it.
bool strip_at(const Dir& t, uint32_t strip, uint64_t& off, uint64_t& bc) {
  if (strip >= t.nstrips) return false;
  bc = t.counts[strip];
  if (bc == 0 || bc > uint64_t{INT64_MAX}) return false;
  if (bc > 1024 * 1024) {  // "Too large strip byte count"
    const uint64_t rps = std::min<uint64_t>(t.rps, t.h);
    const uint64_t size = rps * t.scanline;
    if (size && (bc - 4096) / 10 > size) bc = size * 10 + 4096;
  }
  off = t.offsets[strip];
  if (bc > t.src.n || off > t.src.n - bc) return false;
  // the codec's setup: a predictor other than none or horizontal fails
  return t.compression == 1 || t.compression == 32773 || t.predictor == 1 ||
         t.predictor == 2;
}

// The strip's raw bytes, or false where libtiff refuses to read it.
bool strip_bytes(const Dir& t, uint32_t strip, std::vector<uint8_t>& raw) {
  uint64_t off, bc;
  if (!strip_at(t, strip, off, bc)) return false;
  raw.resize(bc);
  return t.src.read(off, bc, raw.data());
}

// An RGB image, row-major, or nothing where only the check runs.
void set_image(Image* img, int w, int h) {
  if (!img) return;
  img->w = w;
  img->h = h;
  img->rgb.assign(static_cast<size_t>(w) * h * 3, 0);
}

// The samples of rows [y0, y0 + rows) into img as RGB: gray, RGB or palette
// indices through `pal` (3 x 256 8-bit values).
void put_rows(const Dir& t, const uint8_t* buf, uint32_t y0, uint32_t rows,
              const uint8_t* pal, Image& img) {
  for (uint32_t r = 0; r < rows; r++) {
    const uint8_t* p = buf + r * t.scanline;
    uint8_t* o = &img.rgb[(size_t{y0 + r} * t.w) * 3];
    for (uint32_t x = 0; x < t.w; x++, o += 3) {
      if (t.photometric == 2) {
        std::memcpy(o, p + size_t{x} * 3, 3);
      } else if (t.photometric == 3) {
        const uint8_t v = p[x];
        o[0] = pal[v];
        o[1] = pal[256 + v];
        o[2] = pal[512 + v];
      } else {
        o[0] = o[1] = o[2] = p[x];
      }
    }
  }
}

// True where the directory holds what the port decodes.
bool part1(const Dir& t) {
  const bool layout = (t.photometric == 1 && t.spp == 1) ||
                      (t.photometric == 2 && t.spp == 3) ||
                      (t.photometric == 3 && t.spp == 1);
  return !t.tiled && t.bps == 8 && layout && t.extrasamples == 0 &&
         t.planar == 1 && t.fillorder == 1 && t.sampleformat == 1 &&
         part1_compression(t.compression);
}

// ------------------------------------------------------------------ cv2

int cv2_impl(const Src& src, Image* img, int* dims, bool head) {
  Dir t;
  t.src = src;
  if (!read_dir(t)) return kUnreadable;
  // readHeader: Photometric required; the samples' bits and format
  if (!t.photo_set) return kUnreadable;
  const int b = t.bps;
  if (b != 1 && b != 8 && b != 10 && b != 12 && b != 14 && b != 16 &&
      b != 32 && b != 64)
    return kUnreadable;
  if ((b == 1 || b == 8) && t.sampleformat != 1 && t.sampleformat != 2)
    return kUnreadable;
  if (t.spp > 4) return kUnreadable;  // normalizeChannelsNumber
  if (!cv2_size_ok(t.w, t.h)) return kRaises;  // validateInputImageSize
  // readData
  if (t.tiled) return kTiff;
  const uint64_t tile_h = !t.rps_set || t.rps == 0xFFFFFFFFu ? t.h : t.rps;
  if (tile_h > (1u << 24) || tile_h == 0) return kUnreadable;
  // TIFFRGBAImageOK and TIFFRGBAImageBegin
  if (b != 1 && b != 8 && b != 16) return kUnreadable;
  if (t.sampleformat == 3) return kUnreadable;
  const int colors = t.spp - t.extrasamples;
  switch (t.photometric) {
    case 0: case 1: case 3:
      if (t.planar == 1 && t.spp != 1 && b < 8) return kUnreadable;
      break;
    case 2:
      if (colors < 3) return kUnreadable;
      break;
    case 6: break;
    case 5:
      if (t.spp < 4) return kUnreadable;
      break;
    case 8:
      if (t.spp != 3 || colors != 3) return kUnreadable;
      break;
    default:
      return kUnreadable;
  }
  if (4 * tile_h * t.w >= (uint64_t{1} << 30)) return kUnreadable;
  if (!part1(t)) return kTiff;
  if (t.orientation >= 5) return kUnreadable;
  dims[0] = static_cast<int>(t.h);
  dims[1] = static_cast<int>(t.w);
  if (head) return kOk;
  // the palette as libtiff's RGBA reader maps it
  uint8_t pal[768] = {};
  if (t.photometric == 3) {
    const bool wide = std::any_of(t.cmap.begin(), t.cmap.end(),
                                  [](uint16_t c) { return c >= 256; });
    for (int i = 0; i < 768; i++)
      pal[i] = static_cast<uint8_t>(wide ? t.cmap[i] >> 8 : t.cmap[i] & 0xff);
  }
  // TIFFReadRGBAStrip for each strip: any strip libtiff refuses to read
  // refuses the image (checked before the image is allocated)
  uint64_t off, bc;
  for (uint64_t y = 0; y < t.h; y += tile_h)
    if (!strip_at(t, static_cast<uint32_t>(y / t.rps), off, bc))
      return kUnreadable;
  if (!img) return kOk;
  set_image(img, static_cast<int>(t.w), static_cast<int>(t.h));
  const uint32_t rps = static_cast<uint32_t>(std::min<uint64_t>(t.rps, t.h));
  std::vector<uint8_t> raw, buf;
  const bool compat = lzw_compat(t);
  for (uint64_t y = 0; y < t.h; y += tile_h) {
    strip_bytes(t, static_cast<uint32_t>(y / t.rps), raw);
    const uint32_t rows =
        static_cast<uint32_t>(std::min<uint64_t>(rps, t.h - y));
    buf.assign(size_t{rps} * t.scanline, 0);
    decode_strip(t, raw.data(), raw.size(), buf.data(), rows * t.scanline,
                 compat);
    put_rows(t, buf.data(), static_cast<uint32_t>(y), rows, pal, *img);
  }
  apply_orientation(*img, t.orientation);  // 1-4: flips
  return kOk;
}

// ------------------------------------------------------------------ PIL

// A value of Pillow's IFD: the integers of an integer type, or a kind that
// no integer check accepts (bytes, text, rationals, floats).
struct PilTag {
  bool present = false, ints = false;
  std::vector<int64_t> v;  // ints, or the bytes of a BYTE/UNDEFINED tag
  int type = 0;
};

// Pillow's ImageFileDirectory_v2 of the first IFD: its tags in the order
// first seen, each with the value last seen.
struct Pil {
  bool be = false;
  uint64_t ifd = 0;
  std::vector<std::pair<uint16_t, PilTag>> tags;  // the last of duplicates
  const PilTag* get(uint16_t tag) const {
    for (const auto& t : tags)
      if (t.first == tag) return &t.second;
    return nullptr;
  }
};

int pil_unit(int type) {
  switch (type) {
    case 1: case 2: case 6: case 7: return 1;
    case 3: case 8: return 2;
    case 4: case 9: case 11: case 13: return 4;
    case 5: case 10: case 12: case 16: return 8;
    default: return 0;  // not loaded
  }
}

// ImageFileDirectory_v2.load: false where TiffImageFile._open raises.
bool pil_open(const Src& s, Pil& p) {
  uint8_t hd[8];
  if (!s.read(0, 8, hd)) return false;
  p.be = hd[0] == 'M';
  p.ifd = s.u32(hd + 4);
  if (p.ifd == 0) return false;  // "no more images in TIFF file"
  uint8_t c2[2];
  if (!s.read(p.ifd, 2, c2)) return true;  // a warning: no tags
  const uint16_t n = s.u16(c2);
  for (uint32_t i = 0; i < n; i++) {
    uint8_t e[12];
    if (!s.read(p.ifd + 2 + 12 * i, 12, e)) return true;
    const uint16_t tag = s.u16(e), type = s.u16(e + 2);
    const uint32_t count = s.u32(e + 4);
    const int unit = pil_unit(type);
    if (!unit) continue;  // an unsupported type
    const uint64_t size = uint64_t{count} * unit;
    std::vector<uint8_t> data;
    if (size > 4) {
      const uint64_t off = s.u32(e + 8);
      if (off > s.n || size > s.n - off) return true;  // the IFD ends here
      data.resize(size);
      s.read(off, size, data.data());
    } else {
      data.assign(e + 8, e + 8 + size);
    }
    if (size == 0) continue;
    PilTag t;
    t.present = true;
    t.type = type;
    t.ints = type == 3 || type == 4 || type == 6 || type == 8 || type == 9 ||
             type == 13 || type == 16;
    if (t.ints) {
      for (uint32_t k = 0; k < count; k++) {
        const uint8_t* q = &data[size_t{k} * unit];
        int64_t v;
        switch (type) {
          case 3: v = s.u16(q); break;
          case 4: case 13: v = s.u32(q); break;
          case 16: v = static_cast<int64_t>(s.u64(q)); break;
          case 6: v = static_cast<int8_t>(q[0]); break;
          case 8: v = static_cast<int16_t>(s.u16(q)); break;
          default: v = static_cast<int32_t>(s.u32(q)); break;
        }
        t.v.push_back(v);
      }
    } else if (type == 1 || type == 7) {
      t.v.assign(data.begin(), data.end());
    }
    bool replaced = false;
    for (auto& old : p.tags)
      if (old.first == tag) {
        old.second = t;
        replaced = true;
      }
    if (!replaced) p.tags.emplace_back(tag, t);
  }
  return true;
}

// A single-valued tag as an int (its first value), or false.
bool pil_int(const Pil& p, uint16_t tag, int64_t& v) {
  const PilTag* t = p.get(tag);
  if (!t || !t->ints) return false;
  v = t->v[0];
  return true;
}

int pil_impl(const Src& src, Image* img, int* dims, bool head) {
  Pil p;
  if (!pil_open(src, p)) return kUnreadable;
  if (p.get(0xBC01)) return kUnreadable;
  // COMPRESSION_INFO
  int64_t comp = 1;
  if (const PilTag* t = p.get(kCompression)) {
    if (!t->ints) return kUnreadable;
    comp = t->v[0];
    static const int64_t known[] = {1, 2, 3, 4, 5, 6, 7, 8, 32771, 32773,
                                    32809, 32946, 34676, 34677, 34925,
                                    50000, 50001};
    if (std::find(std::begin(known), std::end(known), comp) ==
        std::end(known))
      return kUnreadable;
  }
  int64_t planar = 1, photo = 0, fillorder = 1, w, h, orientation = 0;
  const PilTag* tp;
  if ((tp = p.get(kPlanar)) && tp->ints) planar = tp->v[0];
  // a value of no integer type makes a key of no mode
  if ((tp = p.get(kPhotometric))) {
    if (!tp->ints) return kUnreadable;
    photo = tp->v[0];
  }
  if (comp == 6) photo = 6;
  if ((tp = p.get(kFillOrder))) {
    if (!tp->ints) return kUnreadable;
    fillorder = tp->v[0];
  }
  if (!pil_int(p, kWidth, w) || !pil_int(p, kLength, h)) return kUnreadable;
  if (p.get(kOrientation) && !pil_int(p, kOrientation, orientation))
    orientation = 0;
  const bool swap = orientation >= 5 && orientation <= 8;
  // sample format, bits, extra samples, samples a pixel
  std::vector<int64_t> sf = {1}, bps = {1}, extra;
  if ((tp = p.get(kSampleFormat))) {
    if (!tp->ints) return kUnreadable;
    sf = tp->v;
    if (sf.size() > 1 && *std::max_element(sf.begin(), sf.end()) == 1 &&
        *std::min_element(sf.begin(), sf.end()) == 1)
      sf = {1};
  }
  if ((tp = p.get(kBps))) {
    if (!tp->ints) return kUnreadable;
    bps = tp->v;
  }
  if ((tp = p.get(kExtraSamples))) {
    if (!tp->ints) return kUnreadable;
    extra = tp->v;
  }
  int64_t spp = 1;
  if ((tp = p.get(kSpp))) {
    if (!tp->ints) return kUnreadable;
    spp = tp->v[0];
  } else if (comp == 6 && (photo == 2 || photo == 6)) {
    spp = 3;
  }
  if (spp > 6) return kUnreadable;  // MAX_SAMPLESPERPIXEL
  if (spp < static_cast<int64_t>(bps.size())) bps.resize(std::max<int64_t>(spp, 0));
  else if (spp > static_cast<int64_t>(bps.size()) && bps.size() == 1)
    bps.assign(spp, bps[0]);
  if (static_cast<int64_t>(bps.size()) != spp) return kUnreadable;
  // OPEN_INFO: the modes the port decodes
  int mode;  // 0 L, 1 RGB, 2 P
  const bool fo = fillorder == 1 && extra.empty();
  if (fo && photo == 1 && bps == std::vector<int64_t>{8} &&
      (sf == std::vector<int64_t>{1} || sf == std::vector<int64_t>{2}))
    mode = 0;
  else if (fo && photo == 2 && bps == std::vector<int64_t>{8, 8, 8} &&
           sf == std::vector<int64_t>{1})
    mode = 1;
  else if (fo && photo == 3 && bps == std::vector<int64_t>{8} &&
           sf == std::vector<int64_t>{1})
    mode = 2;
  else
    return kTiff;  // another mode, or none: the port does not decode it
  const bool raw = comp == 1;
  if (!raw && !part1_compression(static_cast<int>(comp))) return kTiff;
  if (planar != 1) return kTiff;
  // tiles, strips
  const PilTag* offs = p.get(kStripOffsets);
  if (p.get(kTileOffsets) && !offs) return kTiff;
  if (raw && !offs) return kUnreadable;  // "unknown data organization"
  // the palette: every value // 256
  std::vector<uint8_t> pal;
  if (mode == 2) {
    const PilTag* cm = p.get(kColorMap);
    if (!cm || (!cm->ints && cm->type != 1 && cm->type != 7))
      return kUnreadable;
    for (int64_t v : cm->v) pal.push_back(static_cast<uint8_t>((v >> 8) & 255));
  }
  if (w <= 0 || h <= 0 || w > INT32_MAX || h > INT32_MAX) return kUnreadable;
  if (!pil_size_ok(w, h)) return kUnreadable;  // DecompressionBombError
  // the single strip of a gray or palette image is memory mapped, at the
  // size as oriented: 5-8 read its bytes as an image of w rows of h
  // (the bytes of a BYTE entry iterate as integers)
  const bool offs_ok = offs && (offs->ints || offs->type == 1);
  const std::vector<int64_t> offsets = offs_ok ? offs->v : std::vector<int64_t>{};
  int64_t rps = h;
  if ((tp = p.get(kRps))) {
    if (!tp->ints || tp->v[0] < 0) return kUnreadable;
    rps = tp->v[0];
  }
  const bool one_tile = raw && (offsets.size() == 1 || rps == h);
  const bool mapped = one_tile && mode != 1;
  const bool remap = mapped && swap;
  dims[0] = static_cast<int>(swap && !remap ? w : h);
  dims[1] = static_cast<int>(swap && !remap ? h : w);
  if (head) return kOk;
  const size_t row = static_cast<size_t>(w) * (mode == 1 ? 3 : 1);
  std::vector<uint8_t> samples;  // allocated once the data is known to be there
  if (raw) {
    if (!offs_ok) return kUnreadable;
    if (mapped) {
      const int64_t off = offsets.back();
      if (off < 0 || static_cast<uint64_t>(off) > src.n ||
          row * h > src.n - off)
        return kUnreadable;  // "buffer is not large enough"
      samples.resize(row * h);
      src.read(off, samples.size(), samples.data());
    } else {
      // one tile a strip: sorted by offset, consecutive ones of the same
      // rows the last; each decoded whole from its offset
      struct Tile { int64_t off, y0, y1; };
      std::vector<Tile> tiles;
      int64_t y = 0;
      // every tile the whole image: the last offset alone
      const std::vector<int64_t> used =
          rps == h ? std::vector<int64_t>{offsets.back()} : offsets;
      for (int64_t o : used) {
        tiles.push_back({o, y, std::min(y + rps, h)});
        y += rps;
        if (y >= h) y = 0;
      }
      std::stable_sort(tiles.begin(), tiles.end(),
                       [](const Tile& a, const Tile& b) { return a.off < b.off; });
      std::vector<Tile> kept;
      for (const Tile& t : tiles) {
        if (!kept.empty() && kept.back().y0 == t.y0 && kept.back().y1 == t.y1)
          kept.back() = t;
        else
          kept.push_back(t);
      }
      for (const Tile& t : kept) {
        // "tile cannot extend outside image", "image file is truncated"
        if (t.off < 0 || t.y1 <= t.y0 || static_cast<uint64_t>(t.off) > src.n ||
            (t.y1 - t.y0) * row > src.n - t.off)
          return kUnreadable;
      }
      samples.assign(row * h, 0);
      for (const Tile& t : kept)
        src.read(t.off, (t.y1 - t.y0) * row, &samples[t.y0 * row]);
    }
  } else {
    // libtiff: its directory, then every strip decoded without an error
    Dir t;
    t.src = src;
    // (libtiff's own Photometric and sample layout do not matter: Pillow
    // unpacks the rows it decodes in its own mode)
    if (!read_dir(t) || t.tiled || t.w != w || t.h != h ||
        !part1_compression(t.compression) || t.scanline < row)
      return kUnreadable;
    const uint32_t prps = t.rps_set && t.rps != 0xFFFFFFFFu ? t.rps
                                                            : static_cast<uint32_t>(h);
    // RowsPerStrip as a signed int (a negative one is no strip buffer)
    if (prps > INT32_MAX) return kUnreadable;
    uint64_t off, bc;
    for (uint64_t y = 0; y < static_cast<uint64_t>(h); y += prps)
      if (!strip_at(t, static_cast<uint32_t>(y / t.rps), off, bc))
        return kUnreadable;
    samples.assign(row * h, 0);
    std::vector<uint8_t> raw_bytes, buf;
    const bool compat = lzw_compat(t);
    for (uint64_t y = 0; y < static_cast<uint64_t>(h); y += prps) {
      const uint32_t strip = static_cast<uint32_t>(y / t.rps);
      strip_bytes(t, strip, raw_bytes);
      const uint64_t rows = std::min<uint64_t>(std::min<uint64_t>(t.rps, t.h),
                                               t.h - strip * uint64_t{t.rps});
      buf.assign(rows * t.scanline, 0);
      if (!decode_strip(t, raw_bytes.data(), raw_bytes.size(), buf.data(),
                        buf.size(), compat))
        return kUnreadable;  // "decoder error -2"
      const uint64_t n = std::min<uint64_t>(prps, h - y);
      for (uint64_t r = 0; r < n && r < rows; r++)
        std::memcpy(&samples[(y + r) * row], &buf[r * t.scanline], row);
    }
  }
  if (!img) return kOk;
  // the image as Pillow holds it (mapped and swapped for 5-8), to RGB
  const int iw = static_cast<int>(remap ? h : w), ih = static_cast<int>(remap ? w : h);
  set_image(img, iw, ih);
  for (size_t i = 0; i < size_t{static_cast<size_t>(iw)} * ih; i++) {
    uint8_t* o = &img->rgb[3 * i];
    if (mode == 1) {
      std::memcpy(o, &samples[3 * i], 3);
    } else if (mode == 2) {
      const size_t v = samples[i], n = pal.size() / 3;
      if (v < n) {
        o[0] = pal[v];
        o[1] = pal[n + v];
        o[2] = pal[2 * n + v];
      }
    } else {
      o[0] = o[1] = o[2] = samples[i];
    }
  }
  if (orientation >= 2 && orientation <= 8) apply_orientation(*img, static_cast<int>(orientation));
  return kOk;
}

}  // namespace

bool is_tiff_data(const uint8_t* d, size_t n) {
  return n >= 4 && (!std::memcmp(d, "II*\0", 4) || !std::memcmp(d, "MM\0*", 4));
}

int tiff_cv2(const uint8_t* d, size_t n, Image* img, int* dims, bool head) {
  if (!is_tiff_data(d, n)) return kUnreadable;
  Src s;
  s.d = d;
  s.n = n;
  s.be = d[0] == 'M';
  return cv2_impl(s, img, dims, head);
}

int tiff_pil(const uint8_t* d, size_t n, Image* img, int* dims, bool head) {
  if (!is_tiff_data(d, n)) return kUnreadable;
  Src s;
  s.d = d;
  s.n = n;
  s.be = d[0] == 'M';
  return pil_impl(s, img, dims, head);
}

int probe_tiff(FILE* f, int* dims) {
  Src s;
  s.f = f;
  uint8_t sig[4];
  if (fseeko(f, 0, SEEK_END) != 0) return kUnreadable;
  s.n = static_cast<uint64_t>(ftello(f));
  if (!s.read(0, 4, sig) || !is_tiff_data(sig, 4)) return kUnreadable;
  s.be = sig[0] == 'M';
  const int st = cv2_impl(s, nullptr, dims, true);
  if (st == kOk || st == kRaises || st == kTiff) return st;
  const int pil = pil_impl(s, nullptr, dims, true);
  return pil == kOk || pil == kTiff ? pil : kUnreadable;
}

}  // namespace tsrio
