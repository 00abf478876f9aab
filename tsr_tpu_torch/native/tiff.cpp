// tiff.cpp — TIFF read as the reference reads it: cv2.imread first, else
// PIL's Image.open(path).convert("RGB").
//
// Classic TIFF and BigTIFF (either byte order), the first IFD, strips or
// tiles of gray (MINISBLACK or MINISWHITE), RGB, palette, CMYK, YCbCr or
// CIELAB samples with any extra samples, of either planar configuration
// and fill order, or Pillow's 16-bit signed, 32-bit integer, float and
// 12-bit gray modes, uncompressed, PackBits, LZW (old-style codes too),
// deflate, CCITT (RLE, group 3 1-D and 2-D, group 4, RLE/W), JPEG,
// old-style JPEG or ThunderScan, with or without the horizontal or the
// floating-point predictor, SGILog's LogL and LogLuv, or with a
// Compression number that names no codec. Two readers, each a copy of what
// its library does:
//   - tiff_cv2: OpenCV 5's TiffDecoder over libtiff 4.7. The directory is
//     read by libtiff's rules (TIFFReadDirectory: the first of duplicate
//     tags wins, a bad required tag refuses the file, a bad optional one is
//     dropped, a palette without a usable ColorMap becomes gray, a missing
//     or implausible strip or tile byte count is estimated, packed YCbCr
//     sizes its strips and tiles in sampling blocks, JPEG's YCbCr takes its
//     subsampling from the first frame where the tag is missing; OpenCV's
//     build does not chop a large strip into smaller ones); OpenCV then
//     needs the Photometric tag, samples of 1, 8 or 16 bits (4 of a
//     palette) and at most 4 a pixel, and reads the image in one of two
//     ways. Its scanline branch (scanline_branch, read_scanlines) takes
//     the image where the RGBA buffer of a strip, 4 bytes a pixel, reaches
//     1020054732 bytes (95 % of 1 GiB: about 255 M pixels, whatever the
//     samples' size) and that strip is the whole image, of 1, 3 or 4
//     samples (4: one ExtraSamples value, associated alpha; without the
//     tag, None) of 8 or 16 bits, MINISWHITE, MINISBLACK or RGB,
//     contiguous: TIFFReadScanline a row at a time (none, PackBits, LZW
//     and deflate streamed with the predictor per row, JPEG a whole frame),
//     the rows as stored (MINISWHITE not inverted, no orientation but
//     imread's turn of a square 5-8, a 16-bit sample's high byte, gray to
//     three channels, alpha dropped), and any row that fails gives None.
//     Everything else needs a codec its build has, what libtiff's RGBA
//     reader accepts and an RGBA buffer under 1 GiB, and reads each strip
//     or tile through TIFFReadRGBAStrip / TIFFReadRGBATile (CCITT through
//     libtiff's fax decoders, FaxDecoder, their no-EOL mode kept from chunk
//     to chunk in the reader's order; SGILog at the 8-bit data format the
//     reader sets, LogL as gray and LogLuv as RGB, whatever samples cv2's
//     header sees of LogLuv). The reader's put routines are copied with
//     their pointer arithmetic (gray and palette rows skip bytes where RGB
//     rows skip pixels, which reads the edge tiles of some layouts askew)
//     and tables: a 16-bit gray sample's high byte, an RGB one's
//     (v + 128) / 257, unassociated alpha premultiplied (v x a + 127) / 255,
//     separate gray planes read as RGB (MINISWHITE not inverted), CMYK as k
//     (255 - C) / 255 with k = 255 - K, YCbCr through TIFFYCbCrToRGBInit's
//     fixed-point tables block by block, CIELAB through libtiff's float
//     conversion to XYZ and its sRGB display's gamma table. JPEG strips and
//     tiles go through libtiff's JPEG codec (jpeg_chunk, with jpeg.cpp's
//     TiffJpeg): contiguous YCbCr turned to RGB by libjpeg, everything else
//     as stored. The RGBA path refuses the image where the first plane's
//     chunk cannot be read (a byte count of 0, past the end of the file, an
//     uncompressed tile of the wrong size, a JPEG stream libtiff's checks
//     refuse), but
//     keeps what a damaged chunk decoded before its error (the rest 0, the
//     predictor not applied, the bytes unswapped); a number that names no
//     codec decodes nothing, so reads as zeros. Orientations 2-4 flip the
//     image as the reader and OpenCV flip it (tiles each on their own); 5-8
//     make imread give None but for a square image, which it transposes.
//   - tiff_pil: Pillow 12's TiffImagePlugin and convert("RGB"), for the
//     files cv2 refuses: its own IFD parser (the last of duplicate tags
//     wins; a tag whose data lies past the end of the file ends the IFD; a
//     big-endian BigTIFF read as classic), OPEN_INFO's modes and rawmodes,
//     its own reader of uncompressed strips and tiles (one layer a plane,
//     every tile whole from its offset, byte counts ignored, one tile of a
//     mode it maps from the file mapped at the size as oriented) and
//     libtiff for compressed ones (every chunk must decode without error,
//     Pillow's checks of libtiff's sizes; YCbCr but contiguous JPEG through
//     libtiff's RGBA reader a strip or a row of tiles at a time; a JPEG
//     frame that leaves part of Pillow's unzeroed buffer unwritten is
//     refused, as its pixels there are whatever memory held; libtiff
//     hands 16, 32 and 64-bit samples over in the host's order, which the
//     rawmodes of big-endian I and F read swapped), old-style JPEG through
//     libtiff's own codec (tif_ojpeg.c, which OpenCV's build leaves out:
//     its header reader over the JPEGInterchangeFormat stream and the
//     strips, the tables from tags, the stream it writes for libjpeg, raw
//     YCbCr blocks into the RGBA reader), CMYK by Pillow's cmyk2rgb, I
//     clipped and F truncated and clipped by convert("RGB"), orientation
//     applied as ImageOps.exif_transpose applies it.
// A layout the codec's setup refuses (NeXT, whose 2-bit samples neither
// reader passes on; ThunderScan of other than 4 bits; SGILog of other than
// LogL or LogLuv data, and so all of Pillow's; WebP, which Pillow's
// libtiff has no codec for) fails as libtiff fails it: unreadable. Any
// other layout that PIL would read (what is left of TIFF part 2c: Pillow's
// LZMA and ZSTD, its LAB mode) gives kTiff: the port does not decode it.
// Each runs on a whole file in memory, or, for the header probe, on an
// open file read where its IFD points.

#include <zlib.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <optional>
#include <string>
#include <vector>

#include "codec.h"

namespace tsrio {
namespace {

enum Tag : uint16_t {
  kWidth = 256, kLength = 257, kBps = 258, kCompression = 259,
  kPhotometric = 262, kFillOrder = 266, kStripOffsets = 273,
  kOrientation = 274, kSpp = 277, kRps = 278, kStripByteCounts = 279,
  kMinSample = 280, kMaxSample = 281, kPlanar = 284, kTransfer = 301,
  kPredictor = 317, kWhitePoint = 318, kColorMap = 320, kTileWidth = 322,
  kTileLength = 323, kTileOffsets = 324, kTileByteCounts = 325,
  kGroup3Options = 292, kInkSet = 332, kExtraSamples = 338,
  kSampleFormat = 339,
  kSMinSample = 340, kSMaxSample = 341, kJpegTables = 347,
  kYccCoefficients = 529, kYccSubsampling = 530, kRefBlackWhite = 532,
  kDataType = 32996, kImageDepth = 32997, kTileDepth = 32998,
};

// The compressions of TIFF part 1: none, LZW, deflate, PackBits
bool part1_compression(int c) {
  return c == 1 || c == 5 || c == 8 || c == 32773 || c == 32946;
}

// libtiff's codecs, as a sweep of the Compression tag over 0-65535 on one
// small uncompressed RGB file in cv2.imread sorted them: the ones OpenCV's
// build leaves out, which TIFFRGBAImageOK refuses ("requested compression
// method is not configured": old-style JPEG, PixarLog, JBIG, LERC, LZMA,
// ZSTD, WebP). Every other number but part 1's, CCITT's (2, 3, 4, 32771),
// JPEG (7), NeXT (32766), ThunderScan (32809) and SGILog's (34676, 34677)
// names no codec: libtiff opens the file, its strips decode to nothing
// ("decoding is not implemented") and the image reads as zeros through the
// RGBA reader (None through the scanline branch, whose row reads fail).
bool not_configured(int c) {
  return c == 6 || c == 32909 || c == 34661 || c == 34887 || c == 34925 ||
         c == 50000 || c == 50001;
}

// ------------------------------------------------------------- the file

// A file in memory, or an open FILE read on demand (the header probe).
struct Src {
  const uint8_t* d = nullptr;
  FILE* f = nullptr;
  uint64_t n = 0;
  bool be = false;   // "MM": big endian
  bool big = false;  // BigTIFF: 8-byte offsets and counts
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
  uint64_t count = 0;
  uint8_t raw[8] = {};  // the value or offset field (4 bytes in classic TIFF)
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
  const int tw = type_width(e.type);
  if (!tw || e.count <= (s.big ? 8u : 4u) / tw) {
    out.assign(e.raw, e.raw + count * tw);
    return true;
  }
  if (count > s.n) return false;  // more bytes than the file holds
  const uint64_t size = count * tw;
  const uint64_t off = s.big ? s.u64(e.raw) : s.u32(e.raw);
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
    case 4: v = s.u32(p); break;
    case 16: v = s.u64(p); break;
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

// The integer types libtiff's readers take (not IFD or IFD8).
bool int_type(int t) {
  return t == 1 || t == 3 || t == 4 || t == 6 || t == 8 || t == 9 ||
         t == 16 || t == 17;
}

// TIFFReadDirEntryShort / Long: one value.
Err read_one(const Src& s, const Entry& e, uint64_t max, uint64_t& v) {
  if (e.count != 1) return kErrCount;
  if (!int_type(e.type)) return kErrType;
  std::vector<uint8_t> b;
  if (!entry_bytes(s, e, 1, b)) return kErrIo;
  return int_at(s, e.type, b.data(), max, v);
}

// TIFFReadDirEntryShortArray / Long8Array: up to `limit` values.
Err read_array(const Src& s, const Entry& e, uint64_t max,
               std::vector<uint64_t>& v, uint64_t limit = UINT64_MAX) {
  v.clear();
  if (!int_type(e.type)) return kErrType;
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
  uint32_t tw = 0, th = 0;  // TileWidth, TileLength
  bool dims_set = false, rps_set = false, tiled = false, photo_set = false;
  bool cmap_set = false;
  uint16_t spp = 1, bps = 1, compression = 1, photometric = 0, planar = 1;
  uint16_t orientation = 1, predictor = 1, fillorder = 1, sampleformat = 1;
  uint16_t extrasamples = 0, sampleinfo0 = 0;  // the first ExtraSamples value
  bool extra_set = false;  // the ExtraSamples tag read (FIELD_EXTRASAMPLES)
  uint16_t inkset = 1;
  uint32_t group3 = 0;  // Group3Options (Compression 3 only)
  // YCbCrSubsampling (2, 2 without the tag; JPEG's fixup may set it from
  // the first strip's frame), YCbCrCoefficients, ReferenceBlackWhite
  // (unset: libtiff's default for the photometric), WhitePoint (D50)
  uint16_t sub[2] = {2, 2};
  bool sub_set = false;
  float luma[3] = {0.299f, 0.587f, 0.114f};
  float refbw[6] = {};
  bool refbw_set = false;
  float white[2] = {96.4250f / (96.4250f + 100.0f + 82.4680f),
                    100.0f / (96.4250f + 100.0f + 82.4680f)};
  std::vector<uint8_t> jpegtables;  // JPEGTables, where set (JPEG only)
  bool tables_set = false;
  // JPEGCOLORMODE_RGB: libjpeg turns contiguous YCbCr JPEG data into RGB,
  // and libtiff's sizes count it upsampled
  bool up = false;
  // SGILog data read at SGILOGDATAFMT_8BIT: its Photometric (LogL or
  // LogLuv), now 8-bit gray or RGB
  uint16_t sgilog = 0;
  std::vector<uint16_t> cmap;  // 3 x 2^bps
  // old-style JPEG (6): JPEGInterchangeFormat and its length, the restart
  // interval, the tables' offsets (JPEGQTables, JPEGDCTables,
  // JPEGACTables); `ojpeg`: the codec is built (Pillow's libtiff, not
  // OpenCV's), and YCbCrSubsampling reads the sampling its first frame
  // holds (oj_sub, oj_force: ojpeg_correct)
  bool ojpeg = false;
  uint64_t jif = 0, jif_len = 0;
  uint16_t jpeg_ri = 0;
  std::vector<uint64_t> jq, jdc, jac;
  uint8_t oj_sub[2] = {2, 2};
  bool oj_force = false;
  uint32_t nstrips = 0;        // strips or tiles, of all planes
  uint32_t per_plane = 0;      // strips or tiles of one plane
  std::vector<uint64_t> offsets, counts;
  uint64_t scanline = 0;    // bytes of an image row (of one plane, planar 2)
  uint64_t chunk_row = 0;   // bytes of a strip's or a tile's row
  uint64_t chunk_size = 0;  // TIFFStripSize or TIFFTileSize
};

uint32_t howmany32(uint32_t x, uint32_t y) {
  return x < 0xFFFFFFFFu - (y - 1) ? (x + y - 1) / y : 0;
}

// TIFFFetchStripThing: `nstrips` values, zeros past the entry's count
// (none without an entry); false where the entry does not read, which
// fails the directory.
bool strip_thing(const Dir& t, const Entry* e, std::vector<uint64_t>& v) {
  v.clear();
  if (e && read_array(t.src, *e, UINT64_MAX, v, t.nstrips) != kErrOk)
    return false;
  // a short array is padded only up to 1,000,000 strips
  if (e && e->count < t.nstrips && t.nstrips > 1000000) return false;
  if (e) v.resize(t.nstrips, 0);
  return true;
}

// Packed YCbCr (contiguous, not upsampled): one Cb and one Cr for every
// sub[0] x sub[1] block of Y samples. libtiff's sizes take 1, 2 and 4
// alone.
bool ycc_packed(const Dir& t) {
  return t.planar == 1 && t.photometric == 6 && !t.up;
}
bool sub_ok(const Dir& t) {
  auto ok = [](int v) { return v == 1 || v == 2 || v == 4; };
  return ok(t.sub[0]) && ok(t.sub[1]);
}

// The bytes of one row of sampling blocks across `width` samples.
uint64_t ycc_row(const Dir& t, uint64_t width) {
  const uint64_t blocks = (width + t.sub[0] - 1) / t.sub[0];
  return (blocks * (t.sub[0] * t.sub[1] + 2) * t.bps + 7) / 8;
}

// TIFFScanlineSize64 (0 where the product overflows or libtiff refuses
// the subsampling)
uint64_t file_scanline(const Dir& t) {
  if (ycc_packed(t) && t.spp == 3)
    return sub_ok(t) ? ycc_row(t, t.w) / t.sub[1] : 0;
  const uint64_t samples = uint64_t{t.w} * (t.planar == 2 ? 1 : t.spp);
  if (t.bps && samples > UINT64_MAX / t.bps) return 0;
  return (samples * t.bps + 7) / 8;
}

// TIFFVStripSize64: the bytes of a strip of `rows` rows (0 as libtiff's)
uint64_t strip_size(const Dir& t, uint64_t rows) {
  if (ycc_packed(t)) {
    if (t.spp != 3 || !sub_ok(t)) return 0;
    return ycc_row(t, t.w) * ((rows + t.sub[1] - 1) / t.sub[1]);
  }
  const uint64_t line = file_scanline(t);
  return line && rows > UINT64_MAX / line ? 0 : line * rows;
}

// TIFFTileRowSize64, TIFFVTileSize64 (0 where the product overflows)
uint64_t tile_row(const Dir& t) {
  const uint64_t samples = t.planar == 2 ? 1 : t.spp;
  const uint64_t bits = uint64_t{t.bps} * t.tw;
  const uint64_t row_bits =
      samples && bits > UINT64_MAX / samples ? 0 : bits * samples;
  return (row_bits + 7) / 8;
}
uint64_t tile_size(const Dir& t, uint64_t rows) {
  if (!t.tw || !t.th) return 0;
  if (ycc_packed(t) && t.spp == 3) {
    if (!sub_ok(t)) return 0;
    return ycc_row(t, t.tw) * ((rows + t.sub[1] - 1) / t.sub[1]);
  }
  const uint64_t row = tile_row(t);
  return row && rows > UINT64_MAX / row ? 0 : row * rows;
}

// The sizes libtiff caches: a row of the image, of a strip or a tile, and
// a whole strip (TIFFStripSize) or tile.
void set_sizes(Dir& t) {
  t.scanline = file_scanline(t);
  if (t.tiled) {
    t.chunk_row = tile_row(t);
    t.chunk_size = tile_size(t, t.th);
  } else {
    t.chunk_row = t.scanline;
    t.chunk_size = strip_size(t, std::min<uint64_t>(t.rps, t.h));
  }
}

// TIFFReadDirEntryFloatArray of exactly `want` values (TIFFFetchNormalTag's
// arrays of a fixed count): false where libtiff drops the tag.
bool read_floats(const Src& s, const Entry& e, uint64_t want, float* out) {
  if (e.count != want) return false;
  const int tw = type_width(e.type);
  if (e.type == 2 || e.type == 7 || e.type == 13 || e.type == 18 || !tw)
    return false;
  std::vector<uint8_t> b;
  if (!entry_bytes(s, e, want, b)) return false;
  for (uint64_t i = 0; i < want; i++) {
    const uint8_t* p = &b[i * tw];
    switch (e.type) {
      case 1: out[i] = p[0]; break;
      case 6: out[i] = static_cast<int8_t>(p[0]); break;
      case 3: out[i] = s.u16(p); break;
      case 8: out[i] = static_cast<int16_t>(s.u16(p)); break;
      case 4: out[i] = static_cast<float>(s.u32(p)); break;
      case 9: out[i] = static_cast<float>(static_cast<int32_t>(s.u32(p))); break;
      case 16: out[i] = static_cast<float>(s.u64(p)); break;
      case 17: out[i] = static_cast<float>(static_cast<int64_t>(s.u64(p))); break;
      case 5: case 10: {  // a denominator of 0 reads 0
        const uint32_t den = s.u32(p + 4);
        const float num = e.type == 5 ? static_cast<float>(s.u32(p))
                                      : static_cast<float>(static_cast<int32_t>(s.u32(p)));
        out[i] = den == 0 ? 0.0f : num / static_cast<float>(den);
        break;
      }
      case 11: {
        const uint32_t u = s.u32(p);
        std::memcpy(&out[i], &u, 4);
        break;
      }
      default: {  // a double, clamped to the floats
        const uint64_t u = s.u64(p);
        double x;
        std::memcpy(&x, &u, 8);
        out[i] = x > 3.4028234663852886e38 ? 3.4028234663852886e38f
                 : x < -3.4028234663852886e38 ? -3.4028234663852886e38f
                                              : static_cast<float>(x);
        break;
      }
    }
  }
  return true;
}

// TIFFReadDirEntryByteArray: bytes, or integers of 0 to 255.
bool read_byte_array(const Src& s, const Entry& e, std::vector<uint8_t>& out) {
  out.clear();
  if (e.type == 1 || e.type == 2 || e.type == 7) {
    return entry_bytes(s, e, e.count, out);
  }
  std::vector<uint64_t> v;
  if (e.type == 6) {
    std::vector<uint8_t> b;
    if (!entry_bytes(s, e, e.count, b)) return false;
    for (uint8_t x : b)
      if (x & 0x80) return false;
    out = b;
    return true;
  }
  if (read_array(s, e, 255, v) != kErrOk) return false;
  out.assign(v.begin(), v.end());
  return true;
}

int color_channels(int photometric) {
  switch (photometric) {
    case 0: case 1: case 3: return 1;
    case 2: case 6: case 8: case 9: case 10: case 32845: return 3;
    case 5: case 4: return 4;
    default: return 0;
  }
}

// JPEGFixupTagsSubsampling: the markers of chunk 0 (its byte count of the
// file, read through a buffer of 2048 bytes that must each lie in the
// file) up to its frame, whose first component's sampling factors become
// YCbCrSubsampling where every other component's are 1 x 1 and both are 1,
// 2 or 4.
void jpeg_fixup(Dir& t) {
  const Src& s = t.src;
  uint64_t off = t.offsets[0], left = t.counts[0];
  if (off == 0) return;
  uint8_t buf[2048];
  uint64_t have = 0, at = 0;  // bytes in the buffer, the next one's index
  auto byte = [&](uint8_t& b) {
    if (!have) {
      if (!left) return false;
      const uint64_t m = std::min<uint64_t>(2048, left);
      if (!s.read(off, m, buf)) return false;
      have = m;
      at = 0;
      off += m;
      left -= m;
    }
    b = buf[at++];
    have--;
    return true;
  };
  auto word = [&](uint16_t& w) {
    uint8_t a, b;
    if (!byte(a) || !byte(b)) return false;
    w = static_cast<uint16_t>(a << 8 | b);
    return true;
  };
  auto skip = [&](uint64_t n) {
    if (n <= have) {
      at += n;
      have -= n;
      return;
    }
    const uint64_t m = n - have;
    have = 0;
    if (m <= left) {
      off += m;
      left -= m;
    } else {
      left = 0;
    }
  };
  for (;;) {
    uint8_t m;
    do {
      if (!byte(m)) return;
    } while (m != 255);
    do {
      if (!byte(m)) return;
    } while (m == 255);
    if (m == 0xD8) continue;
    if (m == 0xFE || (m >= 0xE0 && m <= 0xEF) || m == 0xDB || m == 0xDA ||
        m == 0xC4 || m == 0xDD) {
      uint16_t n;
      if (!word(n) || n < 2) return;
      skip(n - 2);
      continue;
    }
    if (m != 0xC0 && m != 0xC1 && m != 0xC2 && m != 0xC9 && m != 0xCA) return;
    uint16_t n;
    uint8_t p;
    if (!word(n) || n != 8 + t.spp * 3) return;
    skip(7);
    if (!byte(p)) return;
    const int ph = p >> 4, pv = p & 15;
    skip(1);
    for (int o = 1; o < t.spp; o++) {
      skip(1);
      if (!byte(p)) return;
      if (p != 0x11) return;
      skip(1);
    }
    auto ok = [](int v) { return v == 1 || v == 2 || v == 4; };
    if (!ok(ph) || !ok(pv)) return;
    t.sub[0] = static_cast<uint16_t>(ph);
    t.sub[1] = static_cast<uint16_t>(pv);
    return;
  }
}

// ------------------------------------------- old-style JPEG (6), input

// tif_ojpeg.c's input: the JPEGInterchangeFormat stream (its length cut to
// the file), then every strip or tile in turn (one of offset 0 or past the
// file skipped, a byte count of 0 read to the file's end, one past it cut
// there), read as one run of bytes through a buffer that the file fills
// 2048 bytes of one piece at a time; a skip past the buffer moves on in
// the file, and stops at the end of the piece. Pieces are copied from the
// file as the reads reach them (`load`). `strile[i]`: piece i's strip or
// tile, -1 for the stream.
struct OjIn {
  const Src& s;
  struct Piece {
    uint64_t off, len;
    int64_t strile;
  };
  std::vector<Piece> pieces;
  std::vector<uint8_t> bytes;  // the pieces loaded so far
  std::vector<size_t> ends;
  std::vector<int64_t> strile;
  size_t pos = 0, buf_end = 0;  // the buffer holds [pos, buf_end)
  explicit OjIn(const Dir& t) : s(t.src) {
    if (t.jif && t.jif_len) pieces.push_back({t.jif, t.jif_len, -1});
    for (uint32_t k = 0; k < t.nstrips; k++) {
      const uint64_t off = k < t.offsets.size() ? t.offsets[k] : 0;
      if (off == 0 || off >= s.n) continue;
      const uint64_t bc = k < t.counts.size() ? t.counts[k] : 0;
      pieces.push_back({off, bc == 0 || bc > s.n - off ? s.n - off : bc, k});
    }
  }
  // the next piece appended to `bytes`: false where none is left
  bool load() {
    if (ends.size() == pieces.size()) return false;
    const Piece& p = pieces[ends.size()];
    const size_t at = bytes.size();
    bytes.resize(at + p.len);
    s.read(p.off, p.len, &bytes[at]);
    ends.push_back(bytes.size());
    strile.push_back(p.strile);
    return true;
  }
  void load_all() {
    while (load()) {
    }
  }
  size_t piece_end(size_t at) const {
    return *std::upper_bound(ends.begin(), ends.end(), at);
  }
  bool peek(uint8_t& b) {
    while (pos >= bytes.size())
      if (!load()) return false;
    if (pos >= buf_end) buf_end = std::min(pos + 2048, piece_end(pos));
    b = bytes[pos];
    return true;
  }
  bool byte(uint8_t& b) {
    if (!peek(b)) return false;
    pos++;
    return true;
  }
  bool word(uint16_t& w) {
    uint8_t a, b;
    if (!byte(a) || !byte(b)) return false;
    w = static_cast<uint16_t>(a << 8 | b);
    return true;
  }
  bool block(size_t n, uint8_t* out) {
    for (size_t k = 0; k < n; k++)
      if (!byte(out[k])) return false;
    return true;
  }
  void skip(size_t n) {
    const size_t held = buf_end > pos ? buf_end - pos : 0;
    if (n <= held) {
      pos += n;
      return;
    }
    // the buffer's piece: the one its last byte read lies in
    const size_t end = pos ? *std::lower_bound(ends.begin(), ends.end(), pos) : 0;
    pos = std::max(pos, std::min(pos + n, end));
    buf_end = pos;
  }
};

// What OJPEGReadHeaderInfoSec reads: the marker segments it keeps to write
// again (DQT and DHT whole, by table), the frame's and the scan's fields,
// the restart interval; or, where the data starts with no marker, the
// tables from the tags' offsets.
struct OjHead {
  std::vector<uint8_t> qt[4], dc[4], ac[4];
  bool sof = false;
  uint8_t sof_id = 0xC0, sof_c[3] = {0, 0, 0}, sof_hv[3] = {0, 0, 0},
          sof_tq[3] = {0, 0, 0}, sos_cs[3] = {0, 0, 0}, sos_tda[3] = {0, 0, 0};
  uint32_t sof_x = 0, sof_y = 0;
  uint16_t restart = 0;
  uint8_t hor = 2, ver = 2;
  bool force = false;
  // where the entropy-coded data starts in OjIn, and the end of the buffer
  // that holds it where the frame came from the data (0: from the tags)
  size_t sos_end = 0, buf_end = 0;
};

// The codec's frame of the file: strip or tile width, length and the
// rows of all strips or tile rows; samples a pixel, a plane.
struct OjFrame {
  uint32_t w = 0, len = 0, total = 0;
  uint8_t spp = 1, per_plane = 1;
};

OjFrame oj_frame(const Dir& t) {
  OjFrame f;
  if (t.tiled) {
    f.w = t.tw;
    f.len = t.th;
    f.total = t.th ? (t.h + t.th - 1) / t.th * t.th : 0;
  } else {
    f.w = t.w;
    f.len = t.rps == 0xFFFFFFFFu ? t.h : t.rps;
    f.total = t.h;
  }
  f.spp = t.spp == 1 ? 1 : 3;
  f.per_plane = t.spp == 1 || t.planar == 2 ? 1 : 3;
  return f;
}

// OJPEGReadHeaderInfoSec: false where it fails. `correct`: the subsampling
// correction's pass, which stops at the frame (or the scan) and keeps only
// the first component's sampling (`force` where it has no TIFF equivalent).
bool oj_read_sec(OjIn& in, const Dir& t, const OjFrame& f, bool correct,
                 OjHead& h) {
  const Src& s = t.src;
  uint8_t m;
  uint16_t n;
  for (;;) {
    if (!in.peek(m)) return false;
    if (m != 255) break;
    in.pos++;
    do {
      if (!in.byte(m)) return false;
    } while (m == 255);
    if (m == 0xD8) continue;
    if (m == 0xFE || (m >= 0xE0 && m <= 0xEF)) {
      if (!in.word(n) || n < 2) return false;
      if (n > 2) in.skip(n - 2);
      continue;
    }
    switch (m) {
      case 0xDD:  // DRI
        if (!in.word(n) || n != 4 || !in.word(n)) return false;
        h.restart = n;
        break;
      case 0xDB: {  // DQT: each 65-byte table kept as a segment of its own
        if (!in.word(n) || n <= 2) return false;
        if (correct) {
          in.skip(n - 2);
          break;
        }
        for (int left = n - 2; left > 0; left -= 65) {
          if (left < 65) return false;
          std::vector<uint8_t> seg = {0xFF, 0xDB, 0, 67};
          seg.resize(4 + 65);
          if (!in.block(65, &seg[4])) return false;
          const int o = seg[4] & 15;
          if (o > 3) return false;
          h.qt[o] = std::move(seg);
        }
        break;
      }
      case 0xC4: {  // DHT: the segment kept whole, by its first table
        if (!in.word(n) || n <= 2) return false;
        if (correct) {
          in.skip(n - 2);
          break;
        }
        std::vector<uint8_t> seg = {0xFF, 0xC4, static_cast<uint8_t>(n >> 8),
                                    static_cast<uint8_t>(n)};
        seg.resize(2 + n);
        if (!in.block(n - 2, &seg[4])) return false;
        const int o = seg[4];
        if ((o & 0xF0) != 0 && (o & 0xF0) != 16) return false;
        if ((o & 15) > 3) return false;
        ((o & 0xF0) ? h.ac : h.dc)[o & 15] = std::move(seg);
        break;
      }
      case 0xC0: case 0xC1: case 0xC3: {  // SOF
        if (h.sof) return false;
        if (!correct) h.sof_id = m;
        if (!in.word(n) || n < 11 || (n - 8) % 3) return false;
        const int comps = (n - 8) / 3;
        if (!correct && comps != f.spp) return false;
        uint8_t o;
        if (!in.byte(o) || o != 8) return false;
        if (correct) {
          in.skip(4);
        } else {
          uint16_t y, x;
          if (!in.word(y)) return false;
          if (y < t.h && y < f.total) return false;
          h.sof_y = y;
          if (!in.word(x)) return false;
          if ((x < t.w && x < f.w) || x > f.w) return false;
          h.sof_x = x;
        }
        if (!in.byte(o) || o != comps) return false;
        for (int q = 0; q < comps; q++) {
          if (!in.byte(o)) return false;
          if (!correct) h.sof_c[q] = o;
          if (!in.byte(o)) return false;
          if (correct) {
            auto ok = [](int v) { return v == 1 || v == 2 || v == 4; };
            if (q == 0) {
              h.hor = o >> 4;
              h.ver = o & 15;
              if (!ok(h.hor) || !ok(h.ver)) h.force = true;
            } else if (o != 17) {
              h.force = true;
            }
          } else {
            h.sof_hv[q] = o;
            if (!h.force &&
                (q == 0 ? o != (h.hor << 4 | h.ver) : o != 17))
              return false;  // "unexpected subsampling values"
          }
          if (!in.byte(o)) return false;
          if (!correct) h.sof_tq[q] = o;
        }
        if (correct) return true;
        h.sof = true;
        break;
      }
      case 0xDA: {  // SOS
        if (correct) return true;
        uint8_t o;
        if (!h.sof || !in.word(n) || n != 6 + f.per_plane * 2 ||
            !in.byte(o) || o != f.per_plane)
          return false;
        for (int q = 0; q < f.per_plane; q++)
          if (!in.byte(h.sos_cs[q]) || !in.byte(h.sos_tda[q])) return false;
        in.skip(3);  // Ss, Se, Ah and Al, unchecked
        h.sos_end = in.pos;
        h.buf_end = in.buf_end;
        return true;
      }
      default:
        return false;  // "Unknown marker type"
    }
  }
  if (correct) return true;
  h.sos_end = in.pos;
  if (h.sof) return true;
  // the frame and scan from the tags: OJPEGReadHeaderInfoSecTables*
  auto table = [&](const std::vector<uint64_t>& offs, int kind) {
    auto off = [&](int k) { return k < static_cast<int>(offs.size()) ? offs[k] : 0; };
    if (off(0) == 0) return false;  // "Missing JPEG tables"
    for (int k = 0; k < f.spp; k++) {
      if (off(k) != 0 && (k == 0 || off(k) != off(k - 1))) {
        for (int j = 0; j < k - 1; j++)
          if (off(k) == off(j)) return false;  // "Corrupt ... tag value"
        std::vector<uint8_t> seg;
        if (kind == 0) {
          seg = {0xFF, 0xDB, 0, 67, static_cast<uint8_t>(k)};
          seg.resize(5 + 64);
          if (!s.read(off(k), 64, &seg[5])) return false;
          h.qt[k] = std::move(seg);
          h.sof_tq[k] = static_cast<uint8_t>(k);
        } else {
          uint8_t counts[16];
          if (!s.read(off(k), 16, counts)) return false;
          int q = 0;
          for (uint8_t c : counts) q += c;
          seg = {0xFF, 0xC4, static_cast<uint8_t>((19 + q) >> 8),
                 static_cast<uint8_t>(19 + q),
                 static_cast<uint8_t>(kind == 1 ? k : 16 | k)};
          seg.insert(seg.end(), counts, counts + 16);
          seg.resize(seg.size() + q);
          if (!s.read(off(k) + 16, q, &seg[21])) return false;
          (kind == 1 ? h.dc : h.ac)[k] = std::move(seg);
          h.sos_tda[k] = static_cast<uint8_t>(kind == 1 ? k << 4 : h.sos_tda[k] | k);
        }
      } else if (kind == 0) {
        h.sof_tq[k] = h.sof_tq[k - 1];
      } else {
        h.sos_tda[k] = static_cast<uint8_t>(
            kind == 1 ? h.sos_tda[k - 1] : h.sos_tda[k] | (h.sos_tda[k - 1] & 15));
      }
    }
    return true;
  };
  if (!table(t.jq, 0)) return false;
  h.sof_id = 0xC0;
  for (int k = 0; k < f.spp; k++) {
    h.sof_c[k] = static_cast<uint8_t>(k);
    h.sof_hv[k] = k ? 17 : static_cast<uint8_t>(h.hor << 4 | h.ver);
  }
  h.sof_x = f.w;
  h.sof_y = f.total;
  h.sof = true;
  if (!table(t.jdc, 1) || !table(t.jac, 2)) return false;
  for (int k = 1; k < f.spp; k++) h.sos_cs[k] = static_cast<uint8_t>(k);
  return true;
}

// OJPEGSubsamplingCorrect: YCbCr of 3 samples takes the first frame's
// sampling (that of YCbCrSubsampling, else 2 x 2, where the frame cannot
// be read before it); sampling with no TIFF equivalent is upsampled by
// libjpeg (`force`, read as 1 x 1); anything else is 1 x 1. First the
// JPEGInterchangeFormat stream as the codec takes it: an offset past the
// file drops it, a length of 0 or past the file runs to its end.
void ojpeg_correct(Dir& t) {
  if (t.jif >= t.src.n) {
    t.jif = t.jif_len = 0;
  } else if (t.jif_len == 0 || t.jif_len > t.src.n - t.jif) {
    t.jif_len = t.src.n - t.jif;
  }
  t.oj_sub[0] = t.sub_set ? static_cast<uint8_t>(t.sub[0]) : 2;
  t.oj_sub[1] = t.sub_set ? static_cast<uint8_t>(t.sub[1]) : 2;
  t.oj_force = false;
  if (t.spp != 3 || (t.photometric != 6 && t.photometric != 10)) {
    t.oj_sub[0] = t.oj_sub[1] = 1;
    return;
  }
  OjHead h;
  h.hor = t.oj_sub[0];
  h.ver = t.oj_sub[1];
  OjIn in(t);
  oj_read_sec(in, t, oj_frame(t), true, h);
  t.oj_sub[0] = h.force ? 1 : h.hor;
  t.oj_sub[1] = h.force ? 1 : h.ver;
  t.oj_force = h.force;
}

// TIFFClientOpen + TIFFReadDirectory: false where libtiff refuses the file.
bool read_dir(Dir& t) {
  const Src& s = t.src;
  // the header: classic, or BigTIFF's (offset size 8, then 0)
  uint8_t hd[16];
  if (!s.read(0, 8, hd)) return false;
  uint64_t off;
  if (s.big) {
    if (!s.read(8, 8, hd + 8) || s.u16(hd + 4) != 8 || s.u16(hd + 6) != 0)
      return false;
    off = s.u64(hd + 8);
  } else {
    off = s.u32(hd + 4);
  }
  // the entry count (4096 at most), then entries of 12 or 20 bytes
  const int count_size = s.big ? 8 : 2, entry_size = s.big ? 20 : 12;
  uint8_t cb[8];
  if (!s.read(off, count_size, cb)) return false;
  const uint64_t n64 = s.big ? s.u64(cb) : s.u16(cb);
  if (n64 == 0 || n64 > 4096) return false;
  const int n = static_cast<int>(n64);
  std::vector<uint8_t> raw(size_t{static_cast<size_t>(entry_size)} * n);
  if (!s.read(off + count_size, raw.size(), raw.data())) return false;
  t.entries.resize(n);
  for (int i = 0; i < n; i++) {
    Entry& e = t.entries[i];
    const uint8_t* p = &raw[size_t{static_cast<size_t>(entry_size)} * i];
    e.tag = s.u16(p);
    e.type = s.u16(p + 2);
    e.count = s.big ? s.u64(p + 4) : s.u32(p + 4);
    std::memcpy(e.raw, p + (s.big ? 12 : 8), s.big ? 8 : 4);
    for (int k = 0; k < i && !e.ignore; k++)
      e.ignore = t.entries[k].tag == e.tag;  // the first of duplicates
  }
  auto find = [&](uint16_t tag) -> Entry* {
    for (Entry& e : t.entries)
      if (e.tag == tag && !e.ignore) return &e;
    return nullptr;
  };
  uint64_t v;
  bool spp_set = false;
  if (Entry* e = find(kSpp)) {
    if (read_one(s, *e, 0xFFFF, v) != kErrOk || v == 0) return false;
    t.spp = static_cast<uint16_t>(v);
    spp_set = true;
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
          if (!t.tiled) {  // a tile of the strip, until a tile tag comes
            t.th = t.rps;
            t.tw = t.w;
          }
        } else if (e.tag == kTileWidth || e.tag == kTileLength) {
          (e.tag == kTileWidth ? t.tw : t.th) = static_cast<uint32_t>(v);
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
        t.sampleinfo0 = a.empty() ? 0 : a[0] == 999 ? 2 : static_cast<uint16_t>(a[0]);
        t.extra_set = true;
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
  // old-style JPEG in separate planes with one strip offset and one byte
  // count is taken as contiguous
  if (t.compression == 6 && t.planar == 2) {
    const Entry* so = find(kStripOffsets);
    const Entry* sc = find(kStripByteCounts);
    if (so && so->count == 1 && sc && sc->count == 1) t.planar = 1;
  }
  // TIFFNumberOfStrips or TIFFNumberOfTiles (0 where the product overflows)
  auto mul32 = [](uint64_t a, uint64_t b) {
    return a * b > 0xFFFFFFFFu ? uint32_t{0} : static_cast<uint32_t>(a * b);
  };
  if (t.tiled) {
    const uint32_t dx = t.tw == 0xFFFFFFFFu ? t.w : t.tw;
    const uint32_t dy = t.th == 0xFFFFFFFFu ? t.h : t.th;
    t.per_plane = dx == 0 || dy == 0
                      ? 0 : mul32(howmany32(t.w, dx), howmany32(t.h, dy));
  } else {
    t.per_plane = t.rps == 0xFFFFFFFFu ? 1 : howmany32(t.h, t.rps);
  }
  t.nstrips = t.planar == 2 ? mul32(t.per_plane, t.spp) : t.per_plane;
  // old-style JPEG of one strip may leave its offsets to the
  // JPEGInterchangeFormat stream
  if (t.nstrips == 0 ||
      (!offsets_set && !(t.compression == 6 && !t.tiled && t.nstrips == 1)))
    return false;
  t.per_plane = t.planar == 2 ? t.nstrips / t.spp : t.nstrips;
  // second pass: the rest, in the IFD's order
  bool bps_read = false;
  uint64_t datasize_read = 0;
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
      case kStripByteCounts: case kTileByteCounts: {
        (e.tag == kStripOffsets || e.tag == kTileOffsets ? offsets_e : counts_e) = &e;
        // EvaluateIFDdatasizeReading: a BigTIFF count whose size overflows
        const uint64_t tw = type_width(e.type);
        if (tw && e.count > UINT64_MAX / tw) return false;
        const uint64_t size = e.count * tw;
        if (size > (s.big ? 8u : 4u)) {
          if (size > UINT64_MAX - datasize_read) return false;
          datasize_read += size;
        }
        break;
      }
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
      case kInkSet:
        if (read_one(s, e, 0xFFFF, v) == kErrOk)
          t.inkset = static_cast<uint16_t>(v);
        break;
      case kGroup3Options:  // a field of the group 3 codec alone
        if (t.compression == 3 && read_one(s, e, 0xFFFFFFFFu, v) == kErrOk)
          t.group3 = static_cast<uint32_t>(v);
        break;
      case kYccSubsampling: {
        std::vector<uint64_t> a;
        if (e.count == 2 && read_array(s, e, 0xFFFF, a) == kErrOk) {
          t.sub[0] = static_cast<uint16_t>(a[0]);
          t.sub[1] = static_cast<uint16_t>(a[1]);
          t.sub_set = true;
        }
        break;
      }
      case kYccCoefficients: {
        float f[3];
        if (read_floats(s, e, 3, f)) std::copy(f, f + 3, t.luma);
        break;
      }
      case kRefBlackWhite:
        if (read_floats(s, e, 6, t.refbw)) t.refbw_set = true;
        break;
      case kWhitePoint: {
        float f[2];
        if (read_floats(s, e, 2, f)) std::copy(f, f + 2, t.white);
        break;
      }
      case 513: case 514:  // fields of the old-style JPEG codec alone
        if (t.compression == 6 && read_one(s, e, UINT64_MAX, v) == kErrOk)
          (e.tag == 513 ? t.jif : t.jif_len) = v;
        break;
      case 515:
        if (t.compression == 6 && read_one(s, e, 0xFFFF, v) == kErrOk)
          t.jpeg_ri = static_cast<uint16_t>(v);
        break;
      case 519: case 520: case 521: {  // at most 3 offsets, else dropped
        std::vector<uint64_t> a;
        if (t.compression == 6 && read_array(s, e, UINT64_MAX, a) == kErrOk &&
            !a.empty() && a.size() <= 3)
          (e.tag == 519 ? t.jq : e.tag == 520 ? t.jdc : t.jac) = a;
        break;
      }
      case kJpegTables:  // a field of the JPEG codec alone
        if (t.compression == 7 && e.count <= 0xFFFFFFFFu && e.count > 0 &&
            read_byte_array(s, e, t.jpegtables))
          t.tables_set = true;
        break;
      default:
        break;
    }
  }
  // old-style JPEG's guesses: YCbCr where the Photometric tag is missing
  // or says RGB, 8 bits where BitsPerSample is missing, and without
  // SamplesPerPixel 3 samples of YCbCr, 1 of gray
  if (t.compression == 6) {
    if (!t.photo_set || t.photometric == 2) t.photometric = 6;
    t.photo_set = true;
    if (!bps_read) t.bps = 8;
    if (!spp_set && (t.photometric == 6 || t.photometric <= 1))
      t.spp = t.photometric == 6 ? 3 : 1;
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
  set_sizes(t);
  const uint64_t filesize = s.n;
  // EstimateStripByteCounts
  auto estimate = [&]() {
    std::vector<uint64_t> est(t.nstrips);
    if (t.compression != 1) {
      uint64_t space = s.big ? 16 + 8 + 20 * uint64_t{static_cast<uint64_t>(n)} + 8
                             : 8 + 2 + 12 * uint64_t{static_cast<uint64_t>(n)} + 4;
      for (const Entry& e : t.entries) {
        const int tw = type_width(e.type);
        if (!tw || e.count > UINT64_MAX / tw) return false;
        const uint64_t size = e.count * tw;
        if (size > (s.big ? 8u : 4u) && space > UINT64_MAX - size) return false;
        space += size <= (s.big ? 8u : 4u) ? 0 : size;
      }
      space = filesize < space ? filesize : filesize - space;
      if (t.planar == 2) space /= t.spp;
      std::fill(est.begin(), est.end(), space);
      const uint32_t last = t.nstrips - 1;
      if (offset(last) > UINT64_MAX - est[last]) return false;
      if (offset(last) + est[last] > filesize)
        est[last] = offset(last) >= filesize ? 0 : filesize - offset(last);
    } else if (t.tiled) {
      std::fill(est.begin(), est.end(), t.chunk_size);
    } else {
      const uint64_t rows = t.h / t.per_plane;
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
  } else if (t.nstrips == 1 && !t.tiled && [&] {  // ByteCountLooksBad
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
  // JPEGFixupTags: contiguous 3-sample YCbCr JPEG without the subsampling
  // tag takes it from the first strip's or tile's frame
  if (t.compression == 7 && t.photometric == 6 && t.planar == 1 &&
      t.spp == 3 && !t.sub_set)
    jpeg_fixup(t);
  // old-style JPEG: the sizes read YCbCrSubsampling through the codec,
  // which takes it from the first frame
  if (t.ojpeg && t.compression == 6) {
    ojpeg_correct(t);
    t.sub[0] = t.oj_sub[0];
    t.sub[1] = t.oj_sub[1];
  }
  // "Cannot handle zero scanline size", "... zero tile size", "... zero
  // strip size" (a strip or tile past INT64_MAX bytes reads as size 0 too)
  set_sizes(t);
  if (t.scanline == 0 || (!t.tiled && t.h == 0)) return false;
  return t.chunk_size && t.chunk_size <= static_cast<uint64_t>(INT64_MAX);
}

// ------------------------------------------------------------ decoders

// PackBitsDecode: `occ` bytes at op from the cc bytes at `in` (both
// advanced past what it reads), as libtiff decodes a strip, or one of its
// rows where it is read by scanlines: a run longer than what is left of the
// call is cut short and the rest of it dropped, a header byte with nothing
// after it ends the call. False where the call falls short (the bytes
// written stay, the rest as they were).
bool packbits(const uint8_t*& in, size_t& cc, uint8_t* op, size_t occ) {
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

// libtiff's LZW decoders (LZWDecode, LZWDecodeCompat): MSB-first codes with
// the early width change, or, with `compat`, old-style LSB-first codes. The
// state lasts from call to call, as it does from row to row of a strip
// read by scanlines: a string that does not fit in one call is finished by
// the next. A call fails on an error, or where the data ends before it is
// full (the bytes written before it stay, the rest as they were).
class Lzw {
 public:
  Lzw(const uint8_t* in, size_t cc, bool compat)
      : in_(in), bitsleft_(uint64_t{cc} * 8), compat_(compat),
        bump_(compat ? 0 : 1), tab_(kSize) {
    for (int i = 0; i < 256; i++)
      tab_[i] = {-1, 1, static_cast<uint8_t>(i), static_cast<uint8_t>(i)};
  }

  bool decode(uint8_t* op, size_t occ) {
    if (pending_ >= 0) {  // the rest of the last call's string
      const size_t len = tab_[pending_].length;
      if (len - done_ > occ) {
        put(pending_, done_, done_ + occ, op);
        done_ += occ;
        return true;
      }
      put(pending_, done_, len, op);
      op += len - done_;
      occ -= len - done_;
      pending_ = -1;
    }
    while (occ > 0) {
      int code = next();
      if (code < 0) return false;  // the data ends before an EOI code
      if (code == kEoi) break;
      if (code == kClear) {
        free_ent_ = kFirst;
        nbits_ = 9;
        maxcode_ = (1 << nbits_) - 1 - bump_;
        do {
          code = next();
          if (code < 0) return false;
        } while (code == kClear);
        if (code == kEoi) break;
        if (code > kEoi) return false;
        *op++ = static_cast<uint8_t>(code);
        occ--;
        old_ = code;
        continue;
      }
      // the table is full, or the code not yet in it
      if (free_ent_ < 0 || free_ent_ >= kSize) return false;
      if (code >= kFirst && code > free_ent_) return false;
      Code& e = tab_[free_ent_];
      e.next = old_;
      e.firstchar = tab_[old_].firstchar;
      e.length = static_cast<uint16_t>(tab_[old_].length + 1);
      e.value = code < free_ent_ ? tab_[code].firstchar : tab_[old_].firstchar;
      if (++free_ent_ > maxcode_) {
        if (++nbits_ > 12) nbits_ = 12;
        maxcode_ = (1 << nbits_) - 1 - bump_;
        if (free_ent_ >= kSize && !compat_) free_ent_ = -1;
      }
      old_ = code;
      if (code < 256) {
        *op++ = static_cast<uint8_t>(code);
        occ--;
        continue;
      }
      const size_t len = tab_[code].length;
      if (len == 0) return false;
      if (len > occ) {  // the part that fits; the next call finishes it
        put(code, 0, occ, op);
        pending_ = code;
        done_ = occ;
        return true;
      }
      put(code, 0, len, op);
      op += len;
      occ -= len;
    }
    return occ == 0;
  }

 private:
  static constexpr int kClear = 256, kEoi = 257, kFirst = 258, kSize = 4096;
  struct Code {
    int next;  // -1: none
    uint16_t length;
    uint8_t value, firstchar;
  };

  // the next code, or -1 where the data ends first
  int next() {
    if (bitsleft_ < static_cast<uint64_t>(nbits_)) return -1;
    bitsleft_ -= nbits_;
    while (have_ < nbits_) {
      if (compat_) data_ |= uint64_t{in_[pos_++]} << have_;
      else data_ = (data_ << 8) | in_[pos_++];
      have_ += 8;
    }
    int code;
    if (compat_) {
      code = static_cast<int>(data_ & ((1u << nbits_) - 1));
      data_ >>= nbits_;
    } else {
      code = static_cast<int>((data_ >> (have_ - nbits_)) & ((1u << nbits_) - 1));
    }
    have_ -= nbits_;
    return code;
  }

  // bytes [a, b) of `code`'s string at op
  void put(int code, size_t a, size_t b, uint8_t* op) const {
    int k = code;
    for (size_t i = tab_[code].length; i > b; i--) k = tab_[k].next;
    for (size_t i = b; i-- > a && k >= 0;) {
      op[i - a] = tab_[k].value;
      k = tab_[k].next;
    }
  }

  const uint8_t* in_;
  uint64_t bitsleft_;
  const bool compat_;
  // the width grows when the next entry passes maxcode (one entry later in
  // the old-style decoder, once a clear code has set it); until the first
  // clear code there is no table (-1): any other code is an error
  const int bump_;
  std::vector<Code> tab_;
  int nbits_ = 9, free_ent_ = -1, maxcode_ = (1 << 9) - 2;
  int old_ = 0;  // the previous code's entry (entry 0 at the start)
  uint64_t data_ = 0;
  int have_ = 0;
  size_t pos_ = 0;
  int pending_ = -1;  // a string the last call cut short, and its bytes out
  size_t done_ = 0;
};

// ZIPDecode: inflate with Z_PARTIAL_FLUSH until `occ` bytes are out. The
// stream lasts from call to call, as it does from row to row of a strip
// read by scanlines; inflate goes on through what needs no output once the
// call is full (a block's end, the next block's header, the Adler-32 check),
// and fails the call where that data is bad.
class Inflate {
 public:
  Inflate(const uint8_t* in, size_t cc) : cc_(cc) {
    std::memset(&zs_, 0, sizeof(zs_));
    init_ = inflateInit(&zs_) == Z_OK;
    zs_.next_in = const_cast<uint8_t*>(in);
  }
  ~Inflate() {
    if (init_) inflateEnd(&zs_);
  }
  Inflate(const Inflate&) = delete;
  Inflate& operator=(const Inflate&) = delete;

  bool decode(uint8_t* op, size_t occ) {
    if (!init_) return false;
    zs_.next_out = op;
    do {
      zs_.avail_in = static_cast<uInt>(std::min<size_t>(cc_, 0xFFFFFFFFu));
      zs_.avail_out = static_cast<uInt>(std::min<size_t>(occ, 0xFFFFFFFEu));
      const uInt in0 = zs_.avail_in, out0 = zs_.avail_out;
      const int st = inflate(&zs_, Z_PARTIAL_FLUSH);
      cc_ -= in0 - zs_.avail_in;
      occ -= out0 - zs_.avail_out;
      if (st == Z_STREAM_END) break;
      if (st != Z_OK) return false;
    } while (occ > 0);
    return occ == 0;
  }

 private:
  z_stream zs_;
  size_t cc_;
  bool init_ = false;
};

uint8_t reversed(uint8_t b) {
  b = static_cast<uint8_t>((b & 0xF0) >> 4 | (b & 0x0F) << 4);
  b = static_cast<uint8_t>((b & 0xCC) >> 2 | (b & 0x33) << 2);
  return static_cast<uint8_t>((b & 0xAA) >> 1 | (b & 0x55) << 1);
}

// ------------------------------------------------ CCITT (2, 3, 4, 32771)

// The run-length codes of ITU-T T.4 (Tables 2 and 3: the terminating codes
// of runs 0-63 and the make-up codes of 64-1728, white and black; Table 4:
// the extended make-up codes of 1792-2560, shared), bits in the order they
// are sent.
struct FaxCode {
  uint16_t run;
  const char* bits;
};
const FaxCode kWhiteCodes[] = {
    {0, "00110101"}, {1, "000111"}, {2, "0111"}, {3, "1000"}, {4, "1011"},
    {5, "1100"}, {6, "1110"}, {7, "1111"}, {8, "10011"}, {9, "10100"},
    {10, "00111"}, {11, "01000"}, {12, "001000"}, {13, "000011"},
    {14, "110100"}, {15, "110101"}, {16, "101010"}, {17, "101011"},
    {18, "0100111"}, {19, "0001100"}, {20, "0001000"}, {21, "0010111"},
    {22, "0000011"}, {23, "0000100"}, {24, "0101000"}, {25, "0101011"},
    {26, "0010011"}, {27, "0100100"}, {28, "0011000"}, {29, "00000010"},
    {30, "00000011"}, {31, "00011010"}, {32, "00011011"}, {33, "00010010"},
    {34, "00010011"}, {35, "00010100"}, {36, "00010101"}, {37, "00010110"},
    {38, "00010111"}, {39, "00101000"}, {40, "00101001"}, {41, "00101010"},
    {42, "00101011"}, {43, "00101100"}, {44, "00101101"}, {45, "00000100"},
    {46, "00000101"}, {47, "00001010"}, {48, "00001011"}, {49, "01010010"},
    {50, "01010011"}, {51, "01010100"}, {52, "01010101"}, {53, "00100100"},
    {54, "00100101"}, {55, "01011000"}, {56, "01011001"}, {57, "01011010"},
    {58, "01011011"}, {59, "01001010"}, {60, "01001011"}, {61, "00110010"},
    {62, "00110011"}, {63, "00110100"}, {64, "11011"}, {128, "10010"},
    {192, "010111"}, {256, "0110111"}, {320, "00110110"}, {384, "00110111"},
    {448, "01100100"}, {512, "01100101"}, {576, "01101000"},
    {640, "01100111"}, {704, "011001100"}, {768, "011001101"},
    {832, "011010010"}, {896, "011010011"}, {960, "011010100"},
    {1024, "011010101"}, {1088, "011010110"}, {1152, "011010111"},
    {1216, "011011000"}, {1280, "011011001"}, {1344, "011011010"},
    {1408, "011011011"}, {1472, "010011000"}, {1536, "010011001"},
    {1600, "010011010"}, {1664, "011000"}, {1728, "010011011"}};
const FaxCode kBlackCodes[] = {
    {0, "0000110111"}, {1, "010"}, {2, "11"}, {3, "10"}, {4, "011"},
    {5, "0011"}, {6, "0010"}, {7, "00011"}, {8, "000101"}, {9, "000100"},
    {10, "0000100"}, {11, "0000101"}, {12, "0000111"}, {13, "00000100"},
    {14, "00000111"}, {15, "000011000"}, {16, "0000010111"},
    {17, "0000011000"}, {18, "0000001000"}, {19, "00001100111"},
    {20, "00001101000"}, {21, "00001101100"}, {22, "00000110111"},
    {23, "00000101000"}, {24, "00000010111"}, {25, "00000011000"},
    {26, "000011001010"}, {27, "000011001011"}, {28, "000011001100"},
    {29, "000011001101"}, {30, "000001101000"}, {31, "000001101001"},
    {32, "000001101010"}, {33, "000001101011"}, {34, "000011010010"},
    {35, "000011010011"}, {36, "000011010100"}, {37, "000011010101"},
    {38, "000011010110"}, {39, "000011010111"}, {40, "000001101100"},
    {41, "000001101101"}, {42, "000011011010"}, {43, "000011011011"},
    {44, "000001010100"}, {45, "000001010101"}, {46, "000001010110"},
    {47, "000001010111"}, {48, "000001100100"}, {49, "000001100101"},
    {50, "000001010010"}, {51, "000001010011"}, {52, "000000100100"},
    {53, "000000110111"}, {54, "000000111000"}, {55, "000000100111"},
    {56, "000000101000"}, {57, "000001011000"}, {58, "000001011001"},
    {59, "000000101011"}, {60, "000000101100"}, {61, "000001011010"},
    {62, "000001100110"}, {63, "000001100111"}, {64, "0000001111"},
    {128, "000011001000"}, {192, "000011001001"}, {256, "000001011011"},
    {320, "000000110011"}, {384, "000000110100"}, {448, "000000110101"},
    {512, "0000001101100"}, {576, "0000001101101"}, {640, "0000001001010"},
    {704, "0000001001011"}, {768, "0000001001100"}, {832, "0000001001101"},
    {896, "0000001110010"}, {960, "0000001110011"}, {1024, "0000001110100"},
    {1088, "0000001110101"}, {1152, "0000001110110"},
    {1216, "0000001110111"}, {1280, "0000001010010"},
    {1344, "0000001010011"}, {1408, "0000001010100"},
    {1472, "0000001010101"}, {1536, "0000001011010"},
    {1600, "0000001011011"}, {1664, "0000001100100"},
    {1728, "0000001100101"}};
const FaxCode kExtendedCodes[] = {
    {1792, "00000001000"}, {1856, "00000001100"}, {1920, "00000001101"},
    {1984, "000000010010"}, {2048, "000000010011"}, {2112, "000000010100"},
    {2176, "000000010101"}, {2240, "000000010110"}, {2304, "000000010111"},
    {2368, "000000011100"}, {2432, "000000011101"}, {2496, "000000011110"},
    {2560, "000000011111"}};

// tif_fax3.h's decoding states, and its tables (tif_fax3sm.c) built as
// libtiff's mkg3states builds them: a code, read first bit lowest, fills
// every entry whose low `width` bits it is (state, width, run or V
// offset); the rest are S_Null of width 0. The 2-D modes' table reads 7
// bits (an EOL's first 7 zeros), the white one 12 and the black one 13
// (an EOL's first 11 zeros).
enum FaxState : uint8_t {
  kNull, kPass, kHoriz, kV0, kVR, kVL, kExt, kTermW, kTermB, kMakeUpW,
  kMakeUpB, kMakeUp, kEol
};
struct FaxEnt {
  uint8_t state = kNull, width = 0;
  uint32_t param = 0;
};
struct FaxTables {
  FaxEnt main[1 << 7], white[1 << 12], black[1 << 13];
  static void put(FaxEnt* t, int size, const char* bits, uint32_t param,
                  FaxState state) {
    const int width = static_cast<int>(std::strlen(bits));
    int code = 0;
    for (int i = 0; i < width; i++) code |= (bits[i] == '1') << i;
    for (int c = code; c < (1 << size); c += 1 << width)
      t[c] = {state, static_cast<uint8_t>(width), param};
  }
  FaxTables() {
    put(main, 7, "0001", 0, kPass);
    put(main, 7, "001", 0, kHoriz);
    put(main, 7, "1", 0, kV0);
    put(main, 7, "011", 1, kVR);
    put(main, 7, "000011", 2, kVR);
    put(main, 7, "0000011", 3, kVR);
    put(main, 7, "010", 1, kVL);
    put(main, 7, "000010", 2, kVL);
    put(main, 7, "0000010", 3, kVL);
    put(main, 7, "0000001", 0, kExt);
    put(main, 7, "0000000", 0, kEol);
    for (const FaxCode& c : kWhiteCodes)
      put(white, 12, c.bits, c.run, c.run < 64 ? kTermW : kMakeUpW);
    for (const FaxCode& c : kBlackCodes)
      put(black, 13, c.bits, c.run, c.run < 64 ? kTermB : kMakeUpB);
    for (const FaxCode& c : kExtendedCodes) {
      put(white, 12, c.bits, c.run, kMakeUp);
      put(black, 13, c.bits, c.run, kMakeUp);
    }
    put(white, 12, "00000000000", 0, kEol);
    put(black, 13, "00000000000", 0, kEol);
  }
};

bool fax_codec(int c) { return (c >= 2 && c <= 4) || c == 32771; }

// What libtiff's fax codec keeps from chunk to chunk of one file: the run
// arrays (allocated and zeroed at its setup; a damaged row's reference
// line can read past its runs into what earlier rows and chunks left) and
// FAXMODE_NOEOL, which group 3 sets for good once it reads without EOLs.
struct FaxCodec {
  std::vector<uint32_t> runs;
  bool noeol = false;
};

// libtiff's CCITT decoders (tif_fax3.c, tif_fax3.h) over one strip or tile:
// Fax3DecodeRLE (Compression 2, rows byte-aligned; 32771, rows aligned to
// 16-bit words of the file's mapping), Fax3Decode1D and Fax3Decode2D
// (Compression 3, 2-D where Group3Options has bit 0; each row after an
// EOL, fill before it skipped), Fax4Decode (4, ended by EOFB). Damage
// reads as libtiff recovers it: a bad code ends the row, which
// CLEANUP_RUNS pads or cuts to the row's width, a group 3 row starts at
// the next EOL, the last bits are padded with zeros, and data that runs
// out fills the row it is in and ends the chunk. Bits are read through
// the fill order's bit-reversal table (TIFF_NOBITREV). Each row is put
// as _TIFFFax3fillruns puts it: white runs 0, black 1, MSB first. Returns
// the decoder's result: 1, or -1 where the data ran out (group 4: before
// one row was done) or the run arrays would overflow.
struct FaxDecoder {
  static const FaxTables& tables() {
    static const FaxTables t;
    return t;
  }
  const uint8_t* cp;
  const uint8_t* ep;
  uint8_t bitmap[256];
  uint32_t acc = 0;  // BitAcc
  int avail = 0;     // BitsAvail
  int eolcnt = 0;
  int lastx;
  uint32_t nruns;
  uint32_t *thisrun, *pa, *pb, *curruns, *refruns;
  int a0 = 0, b1 = 0, run_length = 0;
  size_t written = 0;  // rows put
  bool* noeol;

  bool need8(int n) {  // NeedBits8: false for eoflab
    if (avail < n) {
      if (cp >= ep) {
        if (avail == 0) return false;
        avail = n;
      } else {
        acc |= static_cast<uint32_t>(bitmap[*cp++]) << avail;
        avail += 8;
      }
    }
    return true;
  }
  bool need16(int n) {  // NeedBits16
    if (avail < n) {
      if (cp >= ep) {
        if (avail == 0) return false;
        avail = n;
      } else {
        acc |= static_cast<uint32_t>(bitmap[*cp++]) << avail;
        if ((avail += 8) < n) {
          if (cp >= ep) {
            avail = n;
          } else {
            acc |= static_cast<uint32_t>(bitmap[*cp++]) << avail;
            avail += 8;
          }
        }
      }
    }
    return true;
  }
  uint32_t bits(int n) const { return acc & ((1u << n) - 1); }
  void clear(int n) {
    avail -= n;
    acc >>= n;
  }
  // LOOKUP8 / LOOKUP16: null where the data ran out
  const FaxEnt* lookup(int wide, const FaxEnt* table, bool sixteen) {
    if (!(sixteen ? need16(wide) : need8(wide))) return nullptr;
    const FaxEnt* e = table + bits(wide);
    clear(e->width);
    return e;
  }
  static int add(int a, uint32_t b) {
    return static_cast<int>(static_cast<uint32_t>(a) + b);
  }
  bool setvalue(uint32_t x) {  // SETVALUE, false on overflow
    if (pa >= thisrun + nruns) return false;
    *pa++ = static_cast<uint32_t>(run_length) + x;
    a0 = add(a0, x);
    run_length = 0;
    return true;
  }
  bool cleanup() {  // CLEANUP_RUNS
    if (run_length && !setvalue(0)) return false;
    if (a0 != lastx) {
      while (a0 > lastx && pa > thisrun) a0 = add(a0, 0u - *--pa);
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if (((pa - thisrun) & 1) && !setvalue(0)) return false;
        if (!setvalue(static_cast<uint32_t>(lastx - a0))) return false;
      } else if (a0 > lastx) {
        if (!setvalue(static_cast<uint32_t>(lastx)) || !setvalue(0))
          return false;
      }
    }
    return true;
  }
  // how a step ends: done, the data ran out (eoflab), a bad code, no EOL
  // before the data ran out (group 3's retry), the run arrays full
  enum { kDone, kEof, kBad, kRetry, kOverflow };
  // one run of a colour: make-up codes, then a terminating one (kBad: a
  // code that is none, or, where `eol_ends`, the EOL that ends a 1-D row)
  int run(bool black, bool eol_ends) {
    const FaxTables& t = tables();
    for (;;) {
      const FaxEnt* e = black ? lookup(13, t.black, true)
                              : lookup(12, t.white, true);
      if (!e) return kEof;
      if (e->state == (black ? kTermB : kTermW))
        return setvalue(e->param) ? kDone : kOverflow;
      if (e->state == (black ? kMakeUpB : kMakeUpW) || e->state == kMakeUp) {
        a0 = add(a0, e->param);
        run_length = add(run_length, e->param);
        continue;
      }
      if (eol_ends && e->state == kEol) eolcnt = 1;
      return kBad;  // "Bad code word"
    }
  }
  int expand1d() {  // EXPAND1D
    for (bool black = false;; black = !black) {
      const int r = run(black, true);
      if (r == kEof) goto eof;
      if (r == kOverflow) return kOverflow;
      if (r == kBad || a0 >= lastx) break;
      if (black && *(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;
    }
    return cleanup() ? kDone : kOverflow;
  eof:  // "Premature EOF"
    return cleanup() ? kEof : kOverflow;
  }
  bool check_b1() {  // CHECK_b1
    if (pa != thisrun)
      while (b1 <= a0 && b1 < lastx) {
        if (pb + 1 >= refruns + nruns) return false;
        b1 = add(b1, pb[0] + pb[1]);
        pb += 2;
      }
    return true;
  }
  int expand2d() {  // EXPAND2D
    const FaxTables& t = tables();
    while (a0 < lastx) {
      if (pa >= thisrun + nruns) return kOverflow;
      const FaxEnt* e = lookup(7, t.main, false);
      if (!e) goto eof;
      switch (e->state) {
        case kPass:
          if (!check_b1() || pb + 1 >= refruns + nruns) return kOverflow;
          b1 = add(b1, *pb++);
          run_length = add(run_length, static_cast<uint32_t>(b1 - a0));
          a0 = b1;
          b1 = add(b1, *pb++);
          break;
        case kHoriz: {
          const bool black_first = (pa - thisrun) & 1;
          for (int k = 0; k < 2; k++) {
            const int r = run(black_first != (k == 1), false);
            if (r == kEof) goto eof;
            if (r == kOverflow) return kOverflow;
            if (r == kBad) goto eol;
          }
          if (!check_b1()) return kOverflow;
          break;
        }
        case kV0:
        case kVR:
          if (!check_b1() ||
              !setvalue(static_cast<uint32_t>(b1 - a0) + e->param) ||
              pb >= refruns + nruns)
            return kOverflow;
          b1 = add(b1, *pb++);
          break;
        case kVL:
          if (!check_b1()) return kOverflow;
          if (b1 < add(a0, e->param)) goto eol;  // "Bad code word"
          if (!setvalue(static_cast<uint32_t>(b1 - a0) - e->param))
            return kOverflow;
          b1 = add(b1, 0u - *--pb);
          break;
        case kExt:  // uncompressed mode: not decoded, the row ends
          *pa++ = static_cast<uint32_t>(lastx - a0);
          goto eol;
        case kEol:
          *pa++ = static_cast<uint32_t>(lastx - a0);
          if (!need8(4)) goto eof;
          clear(4);
          eolcnt = 1;
          goto eol;
        default:  // "Bad code word"
          goto eol;
      }
    }
    if (run_length) {
      if (add(run_length, static_cast<uint32_t>(a0)) < lastx) {  // a final V0
        if (!need8(1)) goto eof;
        if (!bits(1)) goto eol;
        clear(1);
      }
      if (!setvalue(0)) return kOverflow;
    }
  eol:
    return cleanup() ? kDone : kOverflow;
  eof:  // "Premature EOF"
    return cleanup() ? kEof : kOverflow;
  }
  // SYNC_EOL: kDone at the row's first bit, kRetry where the data ran out
  // before an EOL's last bit (retrywithouteol); nothing once the reader
  // has taken the data to have no EOLs (FAXMODE_NOEOL)
  int sync_eol() {
    if (*noeol) return kDone;
    if (eolcnt == 0)
      for (;;) {
        if (!need16(11)) return kRetry;
        if (bits(11) == 0) break;
        clear(1);
      }
    for (;;) {
      if (!need8(8)) return kRetry;
      if (bits(8)) break;
      clear(8);
    }
    while (bits(1) == 0) clear(1);
    clear(1);
    eolcnt = 0;
    return kDone;
  }
  // _TIFFFax3fillruns: white runs clear their bits, black ones set them,
  // each clamped to the row
  void fill(uint8_t* buf) {
    written++;
    uint32_t* erun = pa;
    if ((erun - thisrun) & 1) *erun++ = 0;
    uint32_t x = 0;
    const uint32_t w = static_cast<uint32_t>(lastx);
    for (uint32_t* r = thisrun; r < erun; r++) {
      uint32_t n = *r;
      if (x + n > w || n > w) n = *r = w - x;
      const bool black = (r - thisrun) & 1;
      for (uint32_t i = x; i < x + n; i++) {
        if ((i & 7) == 0 && i + 8 <= x + n) {
          buf[i >> 3] = black ? 0xFF : 0x00;
          i += 7;
          continue;
        }
        const uint8_t bit = static_cast<uint8_t>(0x80 >> (i & 7));
        buf[i >> 3] = static_cast<uint8_t>(black ? buf[i >> 3] | bit
                                                 : buf[i >> 3] & ~bit);
      }
      x += n;
    }
  }

  int decode(const Dir& t, const uint8_t* in, size_t cc, bool odd,
             FaxCodec& state, uint8_t* buf, size_t occ) {
    noeol = &state.noeol;
    // Fax3SetupState, Fax3PreDecode
    const size_t rowbytes = t.chunk_row;
    lastx = static_cast<int>(t.tiled ? t.tw : t.w);
    const bool two_d = t.compression == 4 ||
                       (t.compression == 3 && (t.group3 & 1));
    nruns = (static_cast<uint32_t>(lastx) + 1 + 31) / 32 * 32 * (two_d ? 2 : 1);
    if (state.runs.empty()) state.runs.assign(size_t{nruns} * 2 + 2, 0);
    curruns = state.runs.data();
    refruns = state.runs.data() + nruns;
    refruns[0] = static_cast<uint32_t>(lastx);
    refruns[1] = 0;
    for (int b = 0; b < 256; b++)
      bitmap[b] = t.fillorder == 2 ? static_cast<uint8_t>(b)
                                   : reversed(static_cast<uint8_t>(b));
    cp = in;
    ep = in + cc;
    if (!rowbytes || occ % rowbytes) return -1;  // "Fractional scanlines"
    int line = 0;
    thisrun = curruns;
    while (occ > 0) {
      a0 = run_length = 0;
      if (t.compression == 4 || (t.compression == 3 && two_d)) {
        pa = thisrun = curruns;
        pb = refruns;
        b1 = static_cast<int>(*pb++);
      } else {
        pa = thisrun;
      }
      int r = kDone;
      if (t.compression == 3) {
        const int sync = sync_eol();
        if (sync == kRetry) {
          // "Try to decode (read) fax Group 3 data without EOL": the row
          // again, from the chunk's first byte
          *noeol = true;
          cp = in;
          acc = 0;
          avail = 0;
          continue;
        }
        bool is1d = true;
        if (two_d) {
          if (!need8(1)) {
            if (!cleanup()) return -1;
            fill(buf);
            return -1;
          }
          is1d = bits(1);
          clear(1);
        }
        r = is1d ? expand1d() : expand2d();
      } else if (t.compression == 4) {
        r = expand2d();
      } else {
        r = expand1d();
      }
      if (r == kOverflow) return -1;
      if (t.compression == 4 && (r == kEof || eolcnt)) {
        need16(13);  // EOFB (or what is left)
        clear(13);
        fill(buf);
        return line ? 1 : -1;  // a badly ended strip is no error
      }
      fill(buf);
      if (r == kEof) return -1;
      if (two_d) {  // an imaginary change past the row, for the next
        if (t.compression == 4 || pa < thisrun + nruns)
          if (!setvalue(0)) return -1;
        std::swap(curruns, refruns);
      }
      if (t.compression == 2) {  // byte-aligned rows
        clear(avail - (avail & ~7));
      } else if (t.compression == 32771) {  // word-aligned rows
        clear(avail - (avail & ~15));
        if (avail == 0 && ((cp - in) & 1) != odd) cp++;
      }
      occ -= rowbytes;
      buf += rowbytes;
      line++;
    }
    return 1;
  }
};

// ------------------------------------------------- ThunderScan (32809)

// libtiff's ThunderScan decoder (tif_thunder.c), ThunderDecodeRow over one
// strip ("Fractional scanlines cannot be read" where it is no whole number
// of rows): each row decoded by ThunderDecode from where the last one
// stopped into the image's width of 4-bit samples, from pixel 0 and a last
// pixel of 0. Each byte's top two bits are its code: a run of the last
// pixel (the low 6 bits its length), three 2-bit or two 3-bit deltas from
// it (each with a skip code), or a raw 4-bit value. A row that decodes to
// fewer or more pixels than its width ("Not enough" or "Too much" data)
// zeroes what lies past the decoder's position in it and fails the chunk,
// whose later rows stay as they were. Every row that succeeds is written
// whole.
bool thunder_chunk(const Dir& t, const uint8_t* in, size_t cc, uint8_t* out,
                   size_t occ) {
  static const int kTwo[4] = {0, 1, 0, -1};
  static const int kThree[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  const size_t line = t.scanline;
  if (!line || occ % line) return false;
  const int64_t maxpixels = t.w;
  for (uint8_t* row = out; occ > 0; occ -= line, row += line) {
    uint8_t* op = row;
    unsigned last = 0;
    int64_t npixels = 0;
    auto set = [&](int v) {  // SETPIXEL
      last = static_cast<unsigned>(v) & 0xf;
      if (npixels < maxpixels) {
        if (npixels++ & 1) *op++ |= static_cast<uint8_t>(last);
        else op[0] = static_cast<uint8_t>(last << 4);
      }
    };
    while (cc > 0 && npixels < maxpixels) {
      int n = *in++;
      cc--;
      switch (n & 0xc0) {
        case 0x00:  // THUNDER_RUN
          n &= 0x3f;
          if (npixels & 1) {
            op[0] |= static_cast<uint8_t>(last);
            last = *op++;
            npixels++;
            n--;
          } else {
            last |= last << 4;
          }
          npixels += n;
          if (npixels <= maxpixels)
            for (; n > 0; n -= 2) *op++ = static_cast<uint8_t>(last);
          if (n == -1) *--op &= 0xf0;
          last &= 0xf;
          break;
        case 0x40:  // THUNDER_2BITDELTAS, 2 the skip code
          for (int shift = 4; shift >= 0; shift -= 2) {
            const int d = n >> shift & 3;
            if (d != 2) set(static_cast<int>(last) + kTwo[d]);
          }
          break;
        case 0x80:  // THUNDER_3BITDELTAS, 4 the skip code
          for (int shift = 3; shift >= 0; shift -= 3) {
            const int d = n >> shift & 7;
            if (d != 4) set(static_cast<int>(last) + kThree[d]);
          }
          break;
        default:  // THUNDER_RAW
          set(n);
          break;
      }
    }
    if (npixels != maxpixels) {
      uint8_t* end = row + (maxpixels + 1) / 2;
      if (op < end) std::memset(op, 0, static_cast<size_t>(end - op));
      return false;
    }
  }
  return true;
}

// ---------------------------------------------- SGILog (34676, 34677)

// uvcode.h's table of libtiff's LogLuv24 colour index: for each of the
// 163 rows of (u', v') cells of UV_SQSIZ, from v' = UV_VSTART up, the u'
// of its first cell, its number of cells and the cells below it.
struct UvRow {
  float ustart;
  int16_t nus, ncum;
};
constexpr int kUvRows = 163, kUvCells = 16289;
constexpr float kUvSize = 0.003500f, kUvStart = 0.016940f;
const UvRow kUvRow[kUvRows] = {
    {0.247663f, 4, 0}, {0.243779f, 6, 4}, {0.241684f, 7, 10},
    {0.237874f, 9, 17}, {0.235906f, 10, 26}, {0.232153f, 12, 36},
    {0.228352f, 14, 48}, {0.226259f, 15, 62}, {0.222371f, 17, 77},
    {0.22041f, 18, 94}, {0.21471f, 21, 112}, {0.212714f, 22, 133},
    {0.210721f, 23, 155}, {0.204976f, 26, 178}, {0.202986f, 27, 204},
    {0.199245f, 29, 231}, {0.195525f, 31, 260}, {0.19356f, 32, 291},
    {0.189878f, 34, 323}, {0.186216f, 36, 357}, {0.186216f, 36, 393},
    {0.182592f, 38, 429}, {0.179003f, 40, 467}, {0.175466f, 42, 507},
    {0.172001f, 44, 549}, {0.172001f, 44, 593}, {0.168612f, 46, 637},
    {0.168612f, 46, 683}, {0.163575f, 49, 729}, {0.158642f, 52, 778},
    {0.158642f, 52, 830}, {0.158642f, 52, 882}, {0.153815f, 55, 934},
    {0.153815f, 55, 989}, {0.149097f, 58, 1044}, {0.149097f, 58, 1102},
    {0.142746f, 62, 1160}, {0.142746f, 62, 1222}, {0.142746f, 62, 1284},
    {0.13827f, 65, 1346}, {0.13827f, 65, 1411}, {0.13827f, 65, 1476},
    {0.132166f, 69, 1541}, {0.132166f, 69, 1610}, {0.126204f, 73, 1679},
    {0.126204f, 73, 1752}, {0.126204f, 73, 1825}, {0.120381f, 77, 1898},
    {0.120381f, 77, 1975}, {0.120381f, 77, 2052}, {0.120381f, 77, 2129},
    {0.112962f, 82, 2206}, {0.112962f, 82, 2288}, {0.112962f, 82, 2370},
    {0.10745f, 86, 2452}, {0.10745f, 86, 2538}, {0.10745f, 86, 2624},
    {0.10745f, 86, 2710}, {0.100343f, 91, 2796}, {0.100343f, 91, 2887},
    {0.100343f, 91, 2978}, {0.095126f, 95, 3069}, {0.095126f, 95, 3164},
    {0.095126f, 95, 3259}, {0.095126f, 95, 3354}, {0.088276f, 100, 3449},
    {0.088276f, 100, 3549}, {0.088276f, 100, 3649}, {0.088276f, 100, 3749},
    {0.081523f, 105, 3849}, {0.081523f, 105, 3954}, {0.081523f, 105, 4059},
    {0.081523f, 105, 4164}, {0.074861f, 110, 4269}, {0.074861f, 110, 4379},
    {0.074861f, 110, 4489}, {0.074861f, 110, 4599}, {0.06829f, 115, 4709},
    {0.06829f, 115, 4824}, {0.06829f, 115, 4939}, {0.06829f, 115, 5054},
    {0.063573f, 119, 5169}, {0.063573f, 119, 5288}, {0.063573f, 119, 5407},
    {0.063573f, 119, 5526}, {0.057219f, 124, 5645}, {0.057219f, 124, 5769},
    {0.057219f, 124, 5893}, {0.057219f, 124, 6017}, {0.050985f, 129, 6141},
    {0.050985f, 129, 6270}, {0.050985f, 129, 6399}, {0.050985f, 129, 6528},
    {0.050985f, 129, 6657}, {0.044859f, 134, 6786}, {0.044859f, 134, 6920},
    {0.044859f, 134, 7054}, {0.044859f, 134, 7188}, {0.040571f, 138, 7322},
    {0.040571f, 138, 7460}, {0.040571f, 138, 7598}, {0.040571f, 138, 7736},
    {0.036339f, 142, 7874}, {0.036339f, 142, 8016}, {0.036339f, 142, 8158},
    {0.036339f, 142, 8300}, {0.032139f, 146, 8442}, {0.032139f, 146, 8588},
    {0.032139f, 146, 8734}, {0.032139f, 146, 8880}, {0.027947f, 150, 9026},
    {0.027947f, 150, 9176}, {0.027947f, 150, 9326}, {0.023739f, 154, 9476},
    {0.023739f, 154, 9630}, {0.023739f, 154, 9784}, {0.023739f, 154, 9938},
    {0.019504f, 158, 10092}, {0.019504f, 158, 10250},
    {0.019504f, 158, 10408}, {0.016976f, 161, 10566},
    {0.016976f, 161, 10727}, {0.016976f, 161, 10888},
    {0.016976f, 161, 11049}, {0.012639f, 165, 11210},
    {0.012639f, 165, 11375}, {0.012639f, 165, 11540},
    {0.009991f, 168, 11705}, {0.009991f, 168, 11873},
    {0.009991f, 168, 12041}, {0.009016f, 170, 12209},
    {0.009016f, 170, 12379}, {0.009016f, 170, 12549},
    {0.006217f, 173, 12719}, {0.006217f, 173, 12892},
    {0.005097f, 175, 13065}, {0.005097f, 175, 13240},
    {0.005097f, 175, 13415}, {0.003909f, 177, 13590},
    {0.003909f, 177, 13767}, {0.00234f, 177, 13944}, {0.002389f, 170, 14121},
    {0.001068f, 164, 14291}, {0.001653f, 157, 14455},
    {0.000717f, 150, 14612}, {0.001614f, 143, 14762}, {0.00027f, 136, 14905},
    {0.000484f, 129, 15041}, {0.001103f, 123, 15170},
    {0.001242f, 115, 15293}, {0.001188f, 109, 15408},
    {0.001011f, 103, 15517}, {0.000709f, 97, 15620}, {0.000301f, 89, 15717},
    {0.002416f, 82, 15806}, {0.003251f, 76, 15888}, {0.003246f, 69, 15964},
    {0.004141f, 62, 16033}, {0.005963f, 55, 16095}, {0.008839f, 47, 16150},
    {0.01049f, 40, 16197}, {0.016994f, 31, 16237}, {0.023659f, 21, 16268}
};

constexpr double kLn2 = 0.69314718055994530942;  // libtiff's M_LN2

// LogL16toY, LogL10toY: luminance from a 16-bit (sign, 15-bit log) or
// 10-bit log code
double log_l16(int p16) {
  const int le = p16 & 0x7fff;
  if (!le) return 0.;
  const double y = std::exp(kLn2 / 256. * (le + .5) - kLn2 * 64.);
  return !(p16 & 0x8000) ? y : -y;
}
double log_l10(int p10) {
  if (p10 == 0) return 0.;
  return std::exp(kLn2 / 64. * (p10 + .5) - kLn2 * 12.);
}

// uv_decode: the centre of colour cell c (a binary search of the rows), or
// false past the table
bool uv_decode(double& u, double& v, int c) {
  if (c < 0 || c >= kUvCells) return false;
  int lower = 0, upper = kUvRows, ui, vi;
  while (upper - lower > 1) {
    vi = (lower + upper) >> 1;
    ui = c - kUvRow[vi].ncum;
    if (ui > 0) {
      lower = vi;
    } else if (ui < 0) {
      upper = vi;
    } else {
      lower = vi;
      break;
    }
  }
  vi = lower;
  ui = c - kUvRow[vi].ncum;
  u = kUvRow[vi].ustart + (ui + .5) * kUvSize;
  v = kUvStart + (vi + .5) * kUvSize;
  return true;
}

// XYZ of luminance l and chromaticity (u', v'), in floats
void luv_to_xyz(double l, double u, double v, float* xyz) {
  const double s = 1. / (6. * u - 16. * v + 12.);
  const double x = 9. * u * s;
  const double y = 4. * v * s;
  xyz[0] = static_cast<float>(x / y * l);
  xyz[1] = static_cast<float>(l);
  xyz[2] = static_cast<float>((1. - x - y) / y * l);
}

// LogLuv32toXYZ, LogLuv24toXYZ (an index past the table: the neutral
// colour)
void luv32_xyz(uint32_t p, float* xyz) {
  const double l = log_l16(static_cast<int32_t>(p) >> 16);
  if (l <= 0.) {
    xyz[0] = xyz[1] = xyz[2] = 0.f;
    return;
  }
  constexpr double kUvScale = 410.;
  luv_to_xyz(l, 1. / kUvScale * ((p >> 8 & 0xff) + .5),
             1. / kUvScale * ((p & 0xff) + .5), xyz);
}
void luv24_xyz(uint32_t p, float* xyz) {
  const double l = log_l10(static_cast<int>(p >> 14 & 0x3ff));
  if (l <= 0.) {
    xyz[0] = xyz[1] = xyz[2] = 0.f;
    return;
  }
  double u, v;
  if (!uv_decode(u, v, static_cast<int>(p & 0x3fff))) {
    u = 0.210526316;  // U_NEU, V_NEU
    v = 0.473684211;
  }
  luv_to_xyz(l, u, v, xyz);
}

// sqrt's 2.0 gamma of a linear value to 8 bits, 0 and 1 clamped
uint8_t gamma8(double c) {
  return static_cast<uint8_t>(c <= 0. ? 0 : c >= 1. ? 255
                                                    : static_cast<int>(256. * std::sqrt(c)));
}

// XYZtoRGB24: CCIR-709 primaries
void xyz_to_rgb24(const float* xyz, uint8_t* rgb) {
  const double r = 2.690 * xyz[0] + -1.276 * xyz[1] + -0.414 * xyz[2];
  const double g = -1.022 * xyz[0] + 1.978 * xyz[1] + 0.044 * xyz[2];
  const double b = 0.061 * xyz[0] + -0.224 * xyz[1] + 1.163 * xyz[2];
  rgb[0] = gamma8(r);
  rgb[1] = gamma8(g);
  rgb[2] = gamma8(b);
}

// libtiff's SGILog decoders (tif_luv.c) at SGILOGDATAFMT_8BIT, the data
// format TIFFRGBAImageBegin sets, over one strip or tile: LogLuvDecodeStrip
// / LogLuvDecodeTile, a row of the scanline (of the tile's row) at a time
// from where the last one stopped, until a row fails ("Not enough data at
// row"), which leaves it and the rest as they were. LogL16Decode (LogL, a
// high and a low byte plane) and LogLuvDecode32 (LogLuv under 34676, four
// planes) read each plane as runs (a byte past 127: 126 less than it
// copies of the next byte) and literal strings (a byte of 0-127: that many
// bytes, a string cut where the row fills, its rest read as codes);
// LogLuvDecode24 (LogLuv under 34677) 3 bytes a pixel. A row that decodes
// is turned to 8 bits by L16toGry (256 sqrt(Y)) or Luv32toRGB /
// Luv24toRGB (XYZ, then XYZtoRGB24).
bool sgilog_chunk(const Dir& t, const uint8_t* in, size_t cc, uint8_t* out,
                  size_t occ) {
  const size_t rowlen = t.tiled ? t.chunk_row : t.scanline;
  if (!rowlen || occ % rowlen) return false;
  const bool gray = t.sgilog == 32844;
  const size_t npixels = rowlen / (gray ? 1 : 3);
  std::vector<uint32_t> tp(npixels);
  const uint8_t* bp = in;
  for (uint8_t* op = out; occ; op += rowlen, occ -= rowlen) {
    size_t i = 0;
    if (!gray && t.compression == 34677) {  // LogLuvDecode24
      for (; i < npixels && cc >= 3; i++, bp += 3, cc -= 3)
        tp[i] = uint32_t{bp[0]} << 16 | bp[1] << 8 | bp[2];
      if (i != npixels) return false;
    } else {  // LogL16Decode, LogLuvDecode32: byte planes, high first
      std::fill(tp.begin(), tp.end(), 0u);
      for (int shft = gray ? 8 : 24; shft >= 0; shft -= 8) {
        for (i = 0; i < npixels && cc > 0;) {
          if (*bp >= 128) {  // a run
            if (cc < 2) break;
            int rc = *bp++ + (2 - 128);
            const uint32_t b = uint32_t{*bp++} << shft;
            cc -= 2;
            while (rc-- && i < npixels) tp[i++] |= b;
          } else {  // a literal string (0 reads nothing)
            int rc = *bp++;
            while (--cc && rc-- && i < npixels) tp[i++] |= uint32_t{*bp++} << shft;
          }
        }
        if (i != npixels) return false;
      }
    }
    for (i = 0; i < npixels; i++) {
      if (gray) {  // the 16 bits as LogL16Decode's int16_t
        op[i] = gamma8(log_l16(static_cast<int16_t>(tp[i])));
        continue;
      }
      float xyz[3];
      if (t.compression == 34677) luv24_xyz(tp[i], xyz);
      else luv32_xyz(tp[i], xyz);
      xyz_to_rgb24(xyz, op + 3 * i);
    }
  }
  return true;
}

// libtiff picks its LZW decoder once, at the first strip or tile it reads
// (chunk 0): the old-style one where that chunk's bytes (bits reversed for
// FillOrder 2) start 0x00 then an odd byte.
bool lzw_compat(const Dir& t) {
  uint8_t b[2];
  if (t.compression != 5 || !t.nstrips || t.counts[0] < 2 ||
      !t.src.read(t.offsets[0], 2, b))
    return false;
  if (t.fillorder == 2) b[0] = reversed(b[0]), b[1] = reversed(b[1]);
  return b[0] == 0 && (b[1] & 1);
}

// The horizontal predictor over each whole row of `row` bytes: every
// sample (in the host's order) plus the one `stride` samples before it.
template <typename T>
void hor_acc(uint8_t* out, size_t occ, size_t row, size_t stride) {
  const size_t n = row / sizeof(T);
  for (size_t r = 0; r + row <= occ; r += row) {
    uint8_t* p = out + r;
    for (size_t i = stride; i < n; i++) {
      T a, b;
      std::memcpy(&a, p + sizeof(T) * i, sizeof(T));
      std::memcpy(&b, p + sizeof(T) * (i - stride), sizeof(T));
      a = static_cast<T>(a + b);
      std::memcpy(p + sizeof(T) * i, &a, sizeof(T));
    }
  }
}

// What libtiff does to the rows a decoder gives (tif_postdecode and the
// predictor's decodepfunc): 16, 32 and 64-bit samples of a big-endian file
// swapped to the host's order and the horizontal predictor applied row by
// row, or the floating-point predictor (which gives the host's order
// itself); uncompressed and PackBits data take no predictor.
void postdecode(const Dir& t, uint8_t* out, size_t occ) {
  const bool predicted = t.compression != 1 && t.compression != 32773;
  const size_t row = t.chunk_row, stride = t.planar == 2 ? 1 : t.spp;
  if (predicted && t.predictor == 3) {
    // fpAcc: each row's bytes accumulated `stride` apart, then its byte
    // planes (most significant first) gathered into samples of the
    // host's order; no swap follows
    const size_t bytes = t.bps / 8;
    std::vector<uint8_t> tmp(row);
    for (size_t r = 0; r + row <= occ; r += row) {
      uint8_t* p = out + r;
      for (size_t i = stride; i < row; i++)
        p[i] = static_cast<uint8_t>(p[i] + p[i - stride]);
      std::memcpy(tmp.data(), p, row);
      const size_t count = row / bytes;
      for (size_t k = 0; k < count; k++)
        for (size_t b = 0; b < bytes; b++)
          p[bytes * k + b] = tmp[(bytes - b - 1) * count + k];
    }
    return;
  }
  // samples of a big-endian file swapped to the host's order
  if (t.src.be && (t.bps == 16 || t.bps == 32 || t.bps == 64)) {
    const size_t unit = t.bps / 8;
    for (size_t i = 0; i + unit <= occ; i += unit) std::reverse(out + i, out + i + unit);
  }
  if (predicted && t.predictor == 2) {
    switch (t.bps) {  // horAcc8 / 16 / 32 / 64
      case 8: hor_acc<uint8_t>(out, occ, row, stride); break;
      case 16: hor_acc<uint16_t>(out, occ, row, stride); break;
      case 32: hor_acc<uint32_t>(out, occ, row, stride); break;
      default: hor_acc<uint64_t>(out, occ, row, stride); break;
    }
  }
}

// One strip's or tile's bytes as libtiff's decoder gives them: false on a
// decoder error (what it wrote stays, unswapped; PackBits, LZW and deflate
// zero the rest, an uncompressed chunk too short or a number that names no
// codec leave the buffer as it was), else postdecode's.
bool decode_chunk(const Dir& t, const uint8_t* in, size_t cc, uint8_t* out,
                  size_t occ, bool compat, bool odd = false,
                  FaxCodec* state = nullptr) {
  bool ok;
  switch (t.compression) {
    case 2: case 3: case 4: case 32771: {  // CCITT: rows of 1-bit samples
      FaxCodec own;
      FaxDecoder fax;
      const int r = fax.decode(t, in, cc, odd, state ? *state : own, out, occ);
      // the decoder's result (TIFFReadEncodedTile takes its -1 for
      // success), and every row written: a group 4 strip may end early
      // and succeed, which leaves Pillow's unzeroed buffer unwritten there
      ok = (r > 0 || t.tiled) && fax.written * t.chunk_row == occ;
      break;
    }
    case 1:  // DumpModeDecode: all or nothing
      ok = cc >= occ;
      if (ok) std::memcpy(out, in, occ);
      break;
    // the others zero what they leave undecoded
    case 32773: {
      std::memset(out, 0, occ);
      const uint8_t* p = in;
      ok = packbits(p, cc, out, occ);
      break;
    }
    case 5:
      std::memset(out, 0, occ);
      ok = Lzw(in, cc, compat).decode(out, occ);
      break;
    case 8: case 32946:
      std::memset(out, 0, occ);
      ok = Inflate(in, cc).decode(out, occ);
      break;
    case 32809:  // strips alone ("ThunderScan tile decoding is not
                 // implemented": a tile is left as it was)
      ok = !t.tiled && thunder_chunk(t, in, cc, out, occ);
      break;
    case 34676: case 34677:
      ok = sgilog_chunk(t, in, cc, out, occ);
      break;
    default: ok = false; break;  // no codec: "decoding is not implemented"
  }
  if (!ok) return false;
  postdecode(t, out, occ);
  return true;
}

// TIFFFillStrip / TIFFFillTile and the decoder's setup: the chunk's place
// in the file (offset, byte count), or false where libtiff refuses to
// read it.
bool chunk_at(const Dir& t, uint32_t chunk, uint64_t& off, uint64_t& bc) {
  if (chunk >= t.nstrips) return false;
  bc = t.counts[chunk];
  if (bc == 0 || bc > uint64_t{INT64_MAX}) return false;
  if (bc > 1024 * 1024) {  // "Too large strip (tile) byte count"
    const uint64_t size = t.chunk_size;
    if (size && (bc - 4096) / 10 > size) bc = size * 10 + 4096;
  }
  off = t.offsets[chunk];
  if (bc > t.src.n || off > t.src.n - bc) return false;
  // the codec's setup: CCITT takes 1-bit samples, one a pixel or in
  // separate planes (Fax3SetupState); ThunderScan 4-bit samples
  // (ThunderSetupDecode); NeXT 2-bit ones (NeXTPreDecode), which neither
  // reader's header checks pass on; SGILog LogL data of one sample or
  // contiguous LogLuv data ("Inappropriate photometric interpretation"
  // else), which only TIFFRGBAImageBegin's data format reads here; the
  // horizontal predictor works on 8, 16, 32 or 64 bits, the floating-point
  // one on floats of 16, 24, 32 or 64 bits (PredictorSetup); any other
  // predictor fails
  switch (t.compression) {
    case 2: case 3: case 4: case 32771:
      return t.bps == 1 && (t.spp == 1 || t.planar == 2);
    case 32809: return t.bps == 4;
    case 32766: return false;
    case 34676: case 34677:
      return t.sgilog == 32844 ? t.spp == 1
                               : t.sgilog == 32845 && t.planar == 1;
    default: break;
  }
  const bool bytes = t.bps == 16 || t.bps == 32 || t.bps == 64;
  return t.compression == 1 || t.compression == 32773 || t.predictor == 1 ||
         (t.predictor == 2 && (t.bps == 8 || bytes)) ||
         (t.predictor == 3 && t.sampleformat == 3 && (t.bps == 24 || bytes));
}

// FillOrder 2 reverses the raw bytes' bits, but for JPEG and CCITT
// (TIFF_NOBITREV: the fax decoders read through their own table).
bool bits_reversed(const Dir& t) {
  return t.fillorder == 2 && t.compression != 7 && !fax_codec(t.compression);
}

// The chunk's raw bytes (bits reversed for FillOrder 2), or false where
// libtiff refuses to read it.
bool chunk_bytes(const Dir& t, uint32_t chunk, std::vector<uint8_t>& raw) {
  uint64_t off, bc;
  if (!chunk_at(t, chunk, off, bc)) return false;
  raw.resize(bc);
  if (!t.src.read(off, bc, raw.data())) return false;
  if (bits_reversed(t))
    for (uint8_t& b : raw) b = reversed(b);
  return true;
}

// An RGB image, row-major, or nothing where only the check runs.
void set_image(Image* img, int w, int h) {
  if (!img) return;
  img->w = w;
  img->h = h;
  img->rgb.assign(static_cast<size_t>(w) * h * 3, 0);
}

// ------------------------------------------------------------ JPEG (7)

// libtiff's JPEG codec over one chunk (tif_jpeg.c: JPEGSetupDecode once
// the JPEGTables stream reads, JPEGPreDecode, JPEGDecode) into `out`, occ
// bytes, zeroed: -1 where libtiff fails before decoding (the tables; the
// stream's header; a frame larger than the strip or tile, its component
// count, precision or sampling factors; libjpeg's start), else 1 (libjpeg
// recovers damaged data, and the JPEG decoder fails on nothing after its
// start). `frame`, where given, gets the stream's width and height.
struct JpegCodec {
  TiffJpeg jpeg;
  bool setup = false;
};

int jpeg_chunk(JpegCodec& jc, const Dir& t, uint32_t chunk,
               const uint8_t* in, size_t cc, uint8_t* out, size_t occ,
               int* frame = nullptr) {
  if (!jc.setup) {
    if (t.tables_set &&
        !jc.jpeg.tables(t.jpegtables.data(), t.jpegtables.size()))
      return -1;  // "Bogus JPEGTables field"
    jc.setup = true;
  }
  TiffJpeg::Frame f;
  if (!jc.jpeg.header(in, cc, f)) return -1;
  // the strip's or tile's size (planes past the first of separate YCbCr
  // planes subsampled)
  const uint32_t plane = chunk / t.per_plane;
  const uint64_t hsamp = t.photometric == 6 ? t.sub[0] : 1;
  const uint64_t vsamp = t.photometric == 6 ? t.sub[1] : 1;
  uint64_t sw = t.tiled ? t.tw : t.w, sh = t.th, row = 0;
  if (!t.tiled) {
    row = uint64_t{chunk % t.per_plane} * t.rps;
    sh = std::min<uint64_t>(t.h - row, t.rps);
  }
  if (t.planar == 2 && plane > 0) {
    if (!hsamp || !vsamp) return -1;
    sw = (sw + hsamp - 1) / hsamp;
    sh = (sh + vsamp - 1) / vsamp;
  }
  // a last strip whose frame runs past the image passes
  const bool long_last = uint64_t{static_cast<uint32_t>(f.w)} == sw &&
                         static_cast<uint64_t>(f.h) > sh && row + sh == t.h &&
                         !t.tiled;
  if (!long_last && (static_cast<uint64_t>(f.w) > sw ||
                     static_cast<uint64_t>(f.h) > sh))
    return -1;
  if (f.ncomp != (t.planar == 1 ? t.spp : 1)) return -1;
  if (t.bps != 8) return -1;  // "Improper JPEG data precision"
  if (t.planar == 1) {
    if (static_cast<uint64_t>(f.hs[0]) != hsamp ||
        static_cast<uint64_t>(f.vs[0]) != vsamp)
      return -1;  // "Improper JPEG sampling factors"
    for (int c = 1; c < f.ncomp; c++)
      if (f.hs[c] != 1 || f.vs[c] != 1) return -1;
  } else if (f.hs[0] != 1 || f.vs[0] != 1) {
    return -1;
  }
  std::vector<uint8_t> px;
  if (!jc.jpeg.decode(t.up, px)) return -1;
  // JPEGDecode: whole rows of the strip's or tile's row size, at most the
  // frame's
  const uint64_t line = t.tiled ? t.chunk_row : t.scanline;
  if (!line) return 0;
  const uint64_t rows = std::min<uint64_t>(occ / line, f.h);
  const size_t width = static_cast<size_t>(f.w) * (t.up ? 3 : f.ncomp);
  for (uint64_t r = 0; r < rows; r++)
    std::memcpy(out + r * line, &px[r * width], width);
  if (frame) {
    frame[0] = f.w;
    frame[1] = f.h;
  }
  // jpeg_finish_decompress reads on to EOI once every row is out; libtiff
  // counts its failure (CALLJPEG's -1) as success
  if (rows == static_cast<uint64_t>(f.h)) jc.jpeg.finish();
  return 1;
}

// ------------------------------------------------- old-style JPEG (6)

// tif_ojpeg.c over one file: one libjpeg session across every strip or
// tile (its restart interval one strip's or tile's MCUs where there are
// several), fed the stream the codec writes (SOI, the kept tables, DRI,
// SOF, SOS, then the data from the scan's start on, an RSTn after each
// strip or tile but the last, then EOI; data that runs out before the
// last strip or tile fails), read a strip or tile at a time: raw data of
// YCbCr in packed sampling blocks (jpeg_read_raw_data: 8 rows of blocks an
// iMCU row, no upsampling, rows past the frame left as the last), or the
// scanlines of gray. Once a read fails (a wrong restart marker, data run
// out) every later read fails too.
struct Ojpeg {
  int setup = 0;  // OJPEGPreDecode's first call: 1 passed, -1 failed
  OjFrame f;
  uint8_t hor = 1, ver = 1;
  bool raw = false;
  OjpegImage img;
  size_t bpl = 0, lines = 0;  // bytes_per_line, lines_per_strile
  uint32_t curstrile = 0;     // write_curstrile
  int64_t read = 0;           // iMCU rows (raw) or scanlines read
  int64_t cur = 0;            // the iMCU row the raw buffers hold
  uint32_t state = 0;         // the raw buffers' next row of blocks
  bool broken = false;
};

// OJPEGReadHeaderInfo and OJPEGWriteHeaderInfo: false where either fails.
bool oj_setup(Ojpeg& oj, const Dir& t) {
  oj.f = oj_frame(t);
  const OjFrame& f = oj.f;
  OjHead h;
  h.hor = t.spp == 1 ? 1 : t.oj_sub[0];
  h.ver = t.spp == 1 ? 1 : t.oj_sub[1];
  h.force = t.oj_force;
  h.restart = t.jpeg_ri;
  if (t.spp != 1 && t.spp != 3) return false;
  // separate planes read each plane's own scan (not decoded here)
  if (f.per_plane != f.spp) return false;
  if (f.len < t.h) {
    auto ok = [](int v) { return v == 1 || v == 2 || v == 4; };
    if (!ok(h.hor) || !ok(h.ver) || f.len % (h.ver * 8)) return false;
    h.restart = static_cast<uint16_t>((f.w + h.hor * 8 - 1) / (h.hor * 8) *
                                      (f.len / (h.ver * 8)));
  }
  OjIn in(t);
  if (!oj_read_sec(in, t, f, false, h)) return false;
  oj.hor = h.hor;
  oj.ver = h.ver;
  // the stream libjpeg reads, each marker segment and each of the codec's
  // reads of the file (2048 bytes of a piece at most) a buffer of its own
  std::vector<uint8_t> js;
  std::vector<size_t> bounds;
  auto put = [&](const std::vector<uint8_t>& seg) {
    if (seg.empty()) return;
    js.insert(js.end(), seg.begin(), seg.end());
    bounds.push_back(js.size());
  };
  put({0xFF, 0xD8});
  for (const auto* tables : {h.qt, h.dc, h.ac})
    for (int k = 0; k < 4; k++) put(tables[k]);
  if (h.restart)
    put({0xFF, 0xDD, 0, 4, static_cast<uint8_t>(h.restart >> 8),
         static_cast<uint8_t>(h.restart)});
  std::vector<uint8_t> sof = {0xFF, h.sof_id, 0, static_cast<uint8_t>(8 + 3 * f.per_plane), 8,
                              static_cast<uint8_t>(h.sof_y >> 8), static_cast<uint8_t>(h.sof_y),
                              static_cast<uint8_t>(h.sof_x >> 8), static_cast<uint8_t>(h.sof_x),
                              f.per_plane};
  std::vector<uint8_t> sos = {0xFF, 0xDA, 0, static_cast<uint8_t>(6 + 2 * f.per_plane),
                              f.per_plane};
  for (int k = 0; k < f.per_plane; k++) {
    sof.insert(sof.end(), {h.sof_c[k], h.sof_hv[k], h.sof_tq[k]});
    sos.insert(sos.end(), {h.sos_cs[k], h.sos_tda[k]});
  }
  sos.insert(sos.end(), {0, 63, 0});
  put(sof);
  put(sos);
  // the data: from the scan's start to the end of its piece, then each
  // piece whole; the reads of the piece that holds the scan's start keep
  // the grid of the header's reads where the frame came from the data, and
  // start at the scan where it came from the tags
  in.load_all();
  bool done = false;
  uint8_t rst = 0;
  const size_t first = static_cast<size_t>(
      std::upper_bound(in.ends.begin(), in.ends.end(), h.sos_end) - in.ends.begin());
  for (size_t j = first; j < in.ends.size() && !done; j++) {
    const size_t from = j == first ? h.sos_end : in.ends[j - 1];
    size_t next = j == first && h.buf_end > from ? h.buf_end : from + 2048;
    for (size_t at = from; at < in.ends[j]; next = at + 2048) {
      next = std::min(next, in.ends[j]);
      js.insert(js.end(), in.bytes.begin() + at, in.bytes.begin() + next);
      bounds.push_back(js.size());
      at = next;
    }
    if (in.strile[j] < 0) continue;
    if (in.strile[j] + 1 < t.nstrips) {
      put({0xFF, static_cast<uint8_t>(0xD0 + rst)});
      rst = (rst + 1) & 7;
    } else {
      done = true;  // then EOI for every read
    }
  }
  oj.raw = !t.oj_force && f.per_plane > 1;
  if (ojpeg_decode(js.data(), js.size(), bounds, !done, oj.raw, oj.img) < 0)
    return false;
  // jpeg_start_decompress's frame against the codec's
  if (oj.img.w != static_cast<int>(f.w) || oj.img.maxh != oj.hor ||
      oj.img.maxv != oj.ver)
    return false;
  if (oj.raw) {
    const size_t blocks = (f.w + oj.hor - 1) / oj.hor;
    oj.bpl = blocks * (oj.hor * oj.ver + 2);
    oj.lines = (f.len + oj.ver - 1) / oj.ver;
  } else {
    oj.bpl = size_t{f.per_plane} * f.w;
    oj.lines = f.len;
  }
  return true;
}

// One iMCU row of raw data into the buffers, or one scanline into `line`
// (a read past the frame leaves them as they were): false where the
// session has failed.
bool oj_next(Ojpeg& oj, uint8_t* line) {
  const int64_t k = oj.read++;
  const int64_t rows = oj.raw ? oj.img.imcu_rows : oj.img.h;
  const int64_t fail = oj.img.fail_row < 0 ? INT64_MAX
                       : oj.raw ? oj.img.fail_row
                                : int64_t{oj.img.fail_row} * oj.img.maxv * 8;
  if (oj.broken || (k >= fail && k < rows)) {
    oj.broken = true;
    return false;
  }
  if (k >= rows) return true;
  if (oj.raw) {
    oj.cur = k;
  } else if (line) {
    std::memcpy(line, &oj.img.planes[0][static_cast<size_t>(k) * oj.img.stride], oj.img.stride);
  }
  return true;
}

// One row of packed YCbCr blocks from the raw buffers (OJPEGDecodeRaw).
void oj_block_row(const Ojpeg& oj, uint8_t* out) {
  const OjpegImage& m = oj.img;
  const size_t yrow = (static_cast<size_t>(oj.cur) * 8 + oj.state) * oj.ver;
  const size_t crow = static_cast<size_t>(oj.cur) * 8 + oj.state;
  const size_t blocks = (oj.f.w + oj.hor - 1) / oj.hor;
  for (size_t q = 0; q < blocks; q++) {
    for (int sy = 0; sy < oj.ver; sy++)
      for (int sx = 0; sx < oj.hor; sx++)
        *out++ = m.planes[0][(yrow + sy) * m.widths[0] + q * oj.hor + sx];
    *out++ = m.planes[1][crow * m.widths[1] + q];
    *out++ = m.planes[2][crow * m.widths[2] + q];
  }
}

// TIFFReadEncodedStrip / TIFFReadTile of chunk `chunk`, `occ` bytes, into
// `out`: -1 where OJPEGPreDecode fails (the header, libjpeg's start, or
// reading on to this chunk after a failed one), 0 where OJPEGDecode fails
// (the rows it wrote before kept), else 1.
int ojpeg_chunk(Ojpeg& oj, const Dir& t, uint32_t chunk, uint8_t* out, size_t occ) {
  if (!oj.setup) oj.setup = oj_setup(oj, t) ? 1 : -1;
  if (oj.setup < 0) return -1;
  if (chunk < oj.curstrile) {  // a new session, from the first chunk
    oj.curstrile = 0;
    oj.read = oj.cur = 0;
    oj.broken = false;
  }
  oj.state = 0;
  for (; oj.curstrile < chunk; oj.curstrile++) {  // skipped
    if (!oj.raw) {
      for (size_t k = 0; k < oj.lines; k++)
        if (!oj_next(oj, nullptr)) return -1;
      continue;
    }
    size_t m = oj.lines;
    for (; m >= 8; m -= 8)
      if (!oj_next(oj, nullptr)) return -1;
    if (m > 0) {
      if (!oj_next(oj, nullptr)) return -1;
      oj.state = static_cast<uint32_t>(m);
    }
  }
  if (!occ || occ % oj.bpl || oj.broken) return 0;  // "Fractional scanline"
  for (size_t at = 0; at < occ; at += oj.bpl) {
    if (!oj.raw) {
      if (!oj_next(oj, out + at)) return 0;
      continue;
    }
    if (oj.state == 0 && !oj_next(oj, nullptr)) return 0;
    oj_block_row(oj, out + at);
    oj.state = (oj.state + 1) % 8;
  }
  oj.curstrile++;  // OJPEGPostDecode
  return 1;
}

// ------------------------------------------------- libtiff's RGBA reader

// TIFFRGBAImage's routines that put a chunk's samples into its raster, by
// the samples' bits: contiguous gray (8 bits, with or without alpha; 16
// bits, the high byte) or bilevel (1 bit), palette (8, 4 or 1 bits), RGB (8
// or 16 bits), and separate planes of RGB (gray read as R = G = B); RGB's
// unassociated alpha premultiplied; 8-bit CMYK (contiguous, or 4 separate
// planes), 8-bit YCbCr (contiguous in sampling blocks of 1, 2 or 4 x 1, 2
// or 4, or separate 1 x 1), CIELAB of 8 or 16 bits.
enum Put { kPutNone, kGrey, kBw, kCmap, kRgb, kSepRgb, kCmyk, kSepCmyk,
           kYcc, kSepYcc, kLab };

// TIFFYCbCrToRGBInit's tables (tif_color.c) and TIFFYCbCrtoRGB.
struct YccToRgb {
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256], y[256];
  uint32_t pack(unsigned yy, unsigned cb, unsigned cr) const {
    const int32_t yv = y[yy];
    auto clamp = [](int32_t v) { return static_cast<uint32_t>(v < 0 ? 0 : v > 255 ? 255 : v); };
    const uint32_t r = clamp(yv + cr_r[cr]);
    const uint32_t g = clamp(yv + ((cb_g[cb] + cr_g[cr]) >> 16));
    const uint32_t b = clamp(yv + cb_b[cb]);
    return r | g << 8 | b << 16;
  }
};

// initYCbCrConversion: false where it refuses the coefficients (NaN, a
// green of 0) or ReferenceBlackWhite (NaN, or past the int range).
bool init_ycc(const Dir& t, YccToRgb& c) {
  const float* luma = t.luma;
  float rbw[6] = {0.0f, 255.0f, 128.0f, 255.0f, 128.0f, 255.0f};
  if (t.refbw_set) std::copy(t.refbw, t.refbw + 6, rbw);
  if (std::isnan(luma[0]) || std::isnan(luma[1]) || luma[1] == 0.0f ||
      std::isnan(luma[2]))
    return false;
  for (float f : rbw)
    if (!(f > static_cast<float>(-0x7FFFFFFF + 128) &&
          f < static_cast<float>(0x7FFFFFFF)))
      return false;
  auto clampf = [](float f, float lo, float hi) {
    return !(f >= lo) ? lo : f > hi ? hi : f;
  };
  auto fix = [](float x) {
    return static_cast<int32_t>(x * static_cast<float>(1L << 16) + 0.5);
  };
  const float f1 = 2 - 2 * luma[0];
  const int32_t d1 = fix(clampf(f1, 0.0f, 2.0f));
  const float f2 = luma[0] * f1 / luma[1];
  const int32_t d2 = -fix(clampf(f2, 0.0f, 2.0f));
  const float f3 = 2 - 2 * luma[2];
  const int32_t d3 = fix(clampf(f3, 0.0f, 2.0f));
  const float f4 = luma[2] * f3 / luma[1];
  const int32_t d4 = -fix(clampf(f4, 0.0f, 2.0f));
  // Code2V, then clamped to +-4096
  auto code2v = [](int32_t v, float rb, float rw, float cr) {
    const float range = rw - rb != 0 ? rw - rb : 1;
    return static_cast<float>(v - static_cast<int32_t>(rb)) * cr / range;
  };
  auto clampw = [](float f) {
    return static_cast<int32_t>(f < -4096.0f ? -4096.0f : f > 4096.0f ? 4096.0f : f);
  };
  for (int i = 0, x = -128; i < 256; i++, x++) {
    const int32_t cr = clampw(code2v(x, rbw[4] - 128.0f, rbw[5] - 128.0f, 127));
    const int32_t cb = clampw(code2v(x, rbw[2] - 128.0f, rbw[3] - 128.0f, 127));
    c.cr_r[i] = (d1 * cr + (1 << 15)) >> 16;
    c.cb_b[i] = (d3 * cb + (1 << 15)) >> 16;
    c.cr_g[i] = d2 * cr;
    c.cb_g[i] = d4 * cb + (1 << 15);
    c.y[i] = clampw(code2v(x + 128, rbw[0], rbw[1], 255));
  }
  return true;
}

// TIFFCIELabToRGBInit for the reader's display (sRGB, gamma 2.4) and the
// file's white point, TIFFCIELab16ToXYZ and TIFFXYZToRGB, in floats.
struct LabToRgb {
  static constexpr int kRange = 1500;
  float x0, y0, z0, step;
  float table[kRange + 1];
  // false where the white point's Y is 0
  bool init(const float* white) {
    if (white[1] == 0.0f) return false;
    y0 = 100.0f;
    x0 = white[0] / white[1] * y0;
    z0 = (1.0f - white[0] - white[1]) / white[1] * y0;
    step = (100.0f - 1.0f) / kRange;
    const double gamma = 1.0 / 2.4f;
    for (int i = 0; i <= kRange; i++)
      table[i] = 255u * static_cast<float>(
                            std::pow(static_cast<double>(i) / kRange, gamma));
    return true;
  }
  uint32_t pack(uint32_t l16, int32_t a16, int32_t b16) const {
    const float l = static_cast<float>(l16) * 100.0f / 65535.0f;
    float cby, x, y, z;
    if (l < 8.856f) {
      y = (l * y0) / 903.292f;
      cby = 7.787f * (y / y0) + 16.0f / 116.0f;
    } else {
      cby = (l + 16.0f) / 116.0f;
      y = y0 * cby * cby * cby;
    }
    float tmp = static_cast<float>(a16) / 256.0f / 500.0f + cby;
    x = tmp < 0.2069f ? x0 * (tmp - 0.13793f) / 7.787f : x0 * tmp * tmp * tmp;
    tmp = cby - static_cast<float>(b16) / 256.0f / 200.0f;
    z = tmp < 0.2069f ? z0 * (tmp - 0.13793f) / 7.787f : z0 * tmp * tmp * tmp;
    static const float m[9] = {3.2410f, -1.5374f, -0.4986f, -0.9692f, 1.8760f,
                               0.0416f, 0.0556f, -0.2040f, 1.0570f};
    uint32_t out = 0;
    for (int k = 0; k < 3; k++) {
      float v = m[3 * k] * x + m[3 * k + 1] * y + m[3 * k + 2] * z;
      v = std::max(v, 1.0f);
      v = std::min(v, 100.0f);
      int i = static_cast<int>((v - 1.0f) / step);
      i = std::min(kRange, i);
      const float f = table[i];
      uint32_t c = static_cast<uint32_t>(f > 0 ? f + 0.5 : f - 0.5);
      c = std::min<uint32_t>(c, 255);
      out |= c << (8 * k);
    }
    return out;
  }
};

// The reader's state over one file: its routine and tables, as
// TIFFRGBAImageBegin sets them up, the raw buffer libtiff keeps, and the
// JPEG codec.
struct Rgba {
  const Dir& t;
  Put put = kPutNone;
  bool premultiply = false;  // unassociated alpha (RGB)
  bool alpha = false;        // an alpha plane to read (separate planes)
  int colors = 3;            // planes of colour (separate planes)
  uint8_t grey[256];         // BWmap of 8/16-bit gray (MINISWHITE inverted)
  uint8_t bw[2];             // of 1-bit gray
  uint8_t pal[3][256];       // the palette as 8-bit values
  int hs = 1, vs = 1;        // a YCbCr sampling block
  YccToRgb ycc;
  LabToRgb lab;
  bool compat = false;
  FaxCodec fax;              // the fax codec's state over the file
  uint64_t rawdatasize = 0;  // tif_rawdatasize, for uncompressed tiles
  bool two_pass = true;      // OpenCV's reads: checked, then decoded
  JpegCodec jpeg;
  Ojpeg ojpeg;
  // each JPEG chunk as the checking pass decoded it, for the decoding pass
  struct Chunk {
    int st;
    std::vector<uint8_t> bytes;
  };
  std::vector<Chunk> decoded;
  size_t next = 0;
  explicit Rgba(const Dir& dir) : t(dir) {}
};

uint8_t to8(unsigned v) { return static_cast<uint8_t>((v + 128) / 257); }
uint8_t premul(unsigned v, unsigned a) {
  return static_cast<uint8_t>((v * a + 127) / 255);
}

// TIFFRGBAImageOK's and TIFFRGBAImageBegin's choice (PickContigCase,
// PickSeparateCase): false where libtiff "can not handle image". Contiguous
// YCbCr JPEG data is read as RGB (libjpeg converts it).
bool pick(Rgba& g) {
  const Dir& t = g.t;
  // the alpha: ExtraSamples' first value (unspecified is associated alpha
  // past 3 samples)
  int alpha = 0;
  if (t.extrasamples >= 1)
    alpha = t.sampleinfo0 == 0 ? (t.spp > 3 ? 1 : 0) : t.sampleinfo0;
  const int b = t.bps;
  for (int x = 0; x < 256; x++)
    g.grey[x] = static_cast<uint8_t>(t.photometric == 0 ? 255 - x : x);
  g.bw[0] = t.photometric == 0 ? 255 : 0;
  g.bw[1] = t.photometric == 0 ? 0 : 255;
  const int photometric = t.up ? 2 : t.photometric;
  if (t.planar == 2 && t.spp > 1) {
    if (photometric == 5) {
      if (b == 8 && t.spp == 4) {
        g.put = kSepCmyk;
        g.alpha = true;  // K read as the fourth plane
      }
      return g.put != kPutNone;
    }
    if (photometric == 6) {
      if (b == 8 && t.spp == 3 && init_ycc(t, g.ycc) && t.sub[0] == 1 &&
          t.sub[1] == 1)
        g.put = kSepYcc;
      return g.put != kPutNone;
    }
    if (photometric > 2 || (b != 8 && b != 16)) return false;
    g.put = kSepRgb;
    g.colors = photometric == 2 ? 3 : 1;
    g.alpha = alpha != 0;
    g.premultiply = alpha == 2;
    return true;
  }
  switch (photometric) {
    case 2:
      if ((b == 8 || b == 16) && t.spp >= 3) g.put = kRgb;
      g.premultiply = alpha == 2 && t.spp >= 4;
      break;
    case 3: {
      if (b != 8 && b != 4 && b != 1) break;
      // checkcmap: a map with no entry past 255 is taken as 8-bit
      const size_t n = size_t{1} << b;
      bool wide = false;
      for (int c = 0; c < 3; c++)
        for (size_t i = 0; i < n; i++) wide |= t.cmap[c * n + i] >= 256;
      for (int c = 0; c < 3; c++)
        for (size_t i = 0; i < n; i++)
          g.pal[c][i] = static_cast<uint8_t>(wide ? t.cmap[c * n + i] >> 8
                                                  : t.cmap[c * n + i] & 0xff);
      g.put = kCmap;
      break;
    }
    case 0: case 1:
      g.put = b == 16 || b == 8 ? kGrey : b == 1 ? kBw : kPutNone;
      break;
    case 5:
      if (t.spp >= 4 && b == 8) g.put = kCmyk;
      break;
    case 6: {
      if (b != 8 || t.spp != 3 || !init_ycc(t, g.ycc)) break;
      const int key = t.sub[0] << 4 | t.sub[1];
      if (key == 0x44 || key == 0x42 || key == 0x41 || key == 0x22 ||
          key == 0x21 || key == 0x12 || key == 0x11) {
        g.put = kYcc;
        g.hs = t.sub[0];
        g.vs = t.sub[1];
      }
      break;
    }
    case 8:
      if (t.spp == 3 && (b == 8 || b == 16) && g.lab.init(t.white))
        g.put = kLab;
      break;
    default:
      break;
  }
  return g.put != kPutNone;
}

// The YCbCr routines (putcontig8bitYCbCr44tile ... 11tile): blocks of hs x
// vs Y samples, then Cb and Cr; a block at the right or bottom edge puts
// the pixels that lie in the image. After each row of blocks the chunk
// skips (fromskew / hs) blocks, of 4 x 2 + 2 bytes in the 4 x 4 routine
// (libtiff's own slip, which skews clipped tiles).
void put_ycc(const Rgba& g, std::vector<uint32_t>& raster, int64_t ci,
             uint32_t w, uint32_t h, int64_t fromskew, int64_t toskew,
             const uint8_t* pp) {
  const int hs = g.hs, vs = g.vs, block = hs * vs + 2;
  const int64_t skip = fromskew / hs * (hs == 4 && vs == 4 ? 10 : block);
  const int64_t line = int64_t{w} + toskew;
  for (uint32_t y = 0; y < h; y += vs) {
    const uint32_t rows = std::min<uint32_t>(vs, h - y);
    for (uint32_t x = 0; x < w; x += hs, pp += block) {
      const uint32_t cols = std::min<uint32_t>(hs, w - x);
      const unsigned cb = pp[hs * vs], cr = pp[hs * vs + 1];
      for (uint32_t dy = 0; dy < rows; dy++)
        for (uint32_t dx = 0; dx < cols; dx++)
          raster[ci + (int64_t{y} + dy) * line + x + dx] =
              g.ycc.pack(pp[dy * hs + dx], cb, cr);
    }
    pp += skip;
  }
}

// The routine over a chunk's bytes (planes p[0..3] for separate planes), w
// x h pixels into the raster from index ci, each row then skipping
// `fromskew` pixels of the chunk and `toskew` of the raster, with libtiff's
// own pointer arithmetic (its gray and palette routines skip `fromskew`
// bytes, not pixels; its 1 and 4-bit ones a whole number of bytes).
void put_chunk(const Rgba& g, std::vector<uint32_t>& raster, int64_t ci,
               uint32_t w, uint32_t h, int64_t fromskew, int64_t toskew,
               const uint8_t* const* p) {
  const Dir& t = g.t;
  const int64_t spp = t.spp;
  const bool wide = t.bps == 16;
  auto pack = [](unsigned r, unsigned gg, unsigned b) {
    return r | gg << 8 | b << 16;
  };
  auto word = [](const uint8_t* q) { return unsigned(q[0] | q[1] << 8); };
  auto raw = [&](const uint8_t* q, int k) {
    return wide ? word(q + 2 * k) : unsigned{q[k]};
  };
  const uint8_t* pp = p[0];
  int64_t pi = 0;  // into pp (into each plane, for separate planes)
  if (g.put == kYcc) {
    put_ycc(g, raster, ci, w, h, fromskew, toskew, pp);
    return;
  }
  if ((g.put == kBw || g.put == kCmap) && t.bps < 8) {
    const int bits = t.bps, per = 8 / bits;
    fromskew /= per;
    for (; h > 0; --h) {
      for (uint32_t x = 0; x < w;) {
        const uint8_t byte = pp[pi++];
        for (int k = 0; k < per && x < w; k++, x++) {
          const int v = byte >> (8 - bits * (k + 1)) & ((1 << bits) - 1);
          raster[ci++] = g.put == kBw ? pack(g.bw[v], g.bw[v], g.bw[v])
                                      : pack(g.pal[0][v], g.pal[1][v], g.pal[2][v]);
        }
      }
      ci += toskew;
      pi += fromskew;
    }
    return;
  }
  if (g.put == kGrey || g.put == kCmap) {
    for (; h > 0; --h) {
      for (uint32_t x = 0; x < w; x++, pi += wide ? 2 * spp : spp) {
        const unsigned v = wide ? word(pp + pi) >> 8 : pp[pi];
        raster[ci++] = g.put == kGrey ? pack(g.grey[v], g.grey[v], g.grey[v])
                                      : pack(g.pal[0][v], g.pal[1][v], g.pal[2][v]);
      }
      ci += toskew;
      pi += fromskew;
    }
    return;
  }
  // RGB, CMYK, CIELAB: contiguous samples `spp` apart; separate RGB, CMYK
  // and YCbCr: one a plane
  const bool contig = g.put == kRgb || g.put == kCmyk || g.put == kLab;
  const int64_t step = contig ? spp : 1;
  const int64_t unit = wide ? 2 : 1;
  const int n = g.put == kCmyk || g.put == kSepCmyk || g.premultiply ? 4 : 3;
  fromskew *= step;
  for (; h > 0; --h) {
    for (uint32_t x = 0; x < w; x++, pi += step * unit) {
      unsigned v[4];
      for (int k = 0; k < n; k++)
        v[k] = contig ? raw(pp + pi, k) : raw(p[k] + pi, 0);
      uint32_t px;
      switch (g.put) {
        case kCmyk: case kSepCmyk: {  // k = 255 - K, r = k (255 - C) / 255
          const unsigned k = 255 - v[3];
          px = pack(k * (255 - v[0]) / 255, k * (255 - v[1]) / 255,
                    k * (255 - v[2]) / 255);
          break;
        }
        case kSepYcc:
          px = g.ycc.pack(v[0], v[1], v[2]);
          break;
        case kLab:  // a* and b* signed; 8-bit values scaled to 16 bits
          px = wide ? g.lab.pack(v[0], static_cast<int16_t>(v[1]),
                                 static_cast<int16_t>(v[2]))
                    : g.lab.pack(v[0] * 257, static_cast<int8_t>(v[1]) * 256,
                                 static_cast<int8_t>(v[2]) * 256);
          break;
        default:
          if (wide)
            for (int k = 0; k < n; k++) v[k] = to8(v[k]);
          if (g.premultiply)
            for (int k = 0; k < 3; k++) v[k] = premul(v[k], v[3]);
          px = pack(v[0], v[1], v[2]);
          break;
      }
      raster[ci++] = px;
    }
    ci += toskew;
    pi += fromskew * unit;
  }
}

// One chunk read into `buf` (zeroed, of the chunk's size) as the reader
// reads it: -1 where it is refused before its bytes are read (libtiff's
// TIFFFillStrip / TIFFFillTile fail, an uncompressed tile of the wrong
// size in the first plane's read, the JPEG codec's setup or start), else
// 0, what the decoder wrote kept. The checking pass (`decode` false)
// decodes JPEG chunks and keeps them for the decoding pass.
int read_chunk(Rgba& g, uint32_t chunk, bool first, uint8_t* buf,
               size_t occ, bool decode) {
  const Dir& t = g.t;
  if (decode && t.compression == 7 && g.two_pass) {
    const Rgba::Chunk& c = g.decoded[g.next++];
    std::memcpy(buf, c.bytes.data(), std::min(occ, c.bytes.size()));
    return c.st < 0 ? -1 : 0;
  }
  auto fill = [&]() {  // TIFFFillStrip / TIFFFillTile
    uint64_t off, bc;
    if (!chunk_at(t, chunk, off, bc)) return false;
    // the raw buffer: the file's mapping, or one grown to a multiple of
    // 1 KiB where the bits are reversed
    if (bits_reversed(t)) {
      if (bc > g.rawdatasize) g.rawdatasize = (bc + 1023) / 1024 * 1024;
    } else {
      g.rawdatasize = bc;
    }
    if (first && t.tiled) {
      if (t.compression == 1 && g.rawdatasize != t.chunk_size)
        return false;  // "Invalid tile byte count"
      // a buffer past 100 MB for data under a thousandth of the tile
      const uint64_t buffer = t.chunk_size * (t.planar == 2 && t.spp > 1
                                                  ? (g.alpha ? 4 : 3) : 1);
      if (t.compression != 1 && buffer > 100000000 &&
          g.rawdatasize < t.chunk_size / 1000)
        return false;
    }
    return true;
  };
  std::vector<uint8_t> raw;
  if (t.compression == 6)  // the codec reads the file itself
    return ojpeg_chunk(g.ojpeg, t, chunk, buf, occ) < 0 ? -1 : 0;
  if (t.compression == 7) {
    Rgba::Chunk c{-1, {}};
    if (fill()) {
      chunk_bytes(t, chunk, raw);
      c.bytes.assign(occ, 0);
      c.st = jpeg_chunk(g.jpeg, t, chunk, raw.data(), raw.size(),
                        c.bytes.data(), occ);
    }
    const int st = c.st < 0 ? -1 : 0;
    if (!g.two_pass) {  // Pillow's reads: straight into buf
      if (st == 0) std::memcpy(buf, c.bytes.data(), occ);
    } else {
      g.decoded.push_back(std::move(c));
    }
    return st;
  }
  if (!fill()) return -1;
  if (!decode) return 0;
  chunk_bytes(t, chunk, raw);
  decode_chunk(t, raw.data(), raw.size(), buf, occ, g.compat,
               t.offsets[chunk] & 1, &g.fax);
  return 0;
}

// TIFFReadRGBAStrip(y0) or TIFFReadRGBATile(x0, y0) as OpenCV calls it, and
// OpenCV's copy of its raster into img (orientations 3 and 4 upside down):
// false where the call fails. Without `img`, the chunks' checks alone.
bool read_rgba(Rgba& g, uint32_t x0, uint32_t y0, Image* img) {
  const Dir& t = g.t;
  const bool decode = img != nullptr;
  const uint32_t cw = t.tiled ? t.tw : t.w;
  const uint32_t ch = t.tiled ? t.th : std::min(t.rps, t.h);
  const uint32_t w = std::min<uint64_t>(cw, t.w - x0);
  const uint32_t h = std::min<uint64_t>(t.tiled ? t.th : t.rps, t.h - y0);
  // the chunk's index in each plane
  const uint32_t across = t.tiled ? howmany32(t.w, t.tw) : 1;
  const uint32_t index = t.tiled ? y0 / t.th * across + x0 / t.tw : y0 / t.rps;
  const bool contig = !(t.planar == 2 && t.spp > 1);
  // gtStripContig reads whole rows of the (default) YCbCr sampling, which
  // must not be 0; a strip's bytes (the last strip's fewer rows)
  if (contig && !t.tiled && t.sub[1] == 0) return false;
  size_t occ;
  if (t.tiled) {
    occ = t.chunk_size;
  } else {
    const uint64_t rows = std::min<uint64_t>(ch, t.h - uint64_t{index} * ch);
    const uint64_t rows_read = contig ? (h + t.sub[1] - 1) / t.sub[1] * t.sub[1] : h;
    occ = std::min<uint64_t>(strip_size(t, rows),
                             rows_read > UINT64_MAX / std::max<uint64_t>(t.scanline, 1)
                                 ? UINT64_MAX : rows_read * t.scanline);
  }
  const size_t size = t.chunk_size;
  const int planes = contig ? 1 : g.colors + (g.alpha ? 1 : 0);
  std::vector<uint8_t> buf(decode ? size * (contig ? 1 : (g.alpha ? 4 : 3)) + 16 : 0);
  const uint8_t* p[4];
  for (int k = 0; k < planes; k++) {
    // planes 0..colors-1, then alpha at sample `colors`; gray: R = G = B
    uint8_t* dst = decode ? buf.data() + size * (contig || g.colors == 1 ? (k == 0 ? 0 : 3) : k) : nullptr;
    const uint32_t sample = static_cast<uint32_t>(k);
    const uint32_t chunk = index + sample * t.per_plane;
    const int st = read_chunk(g, chunk, k == 0, dst, occ, decode);
    if (st < 0 && k == 0) return false;
  }
  if (!decode) return true;
  if (contig) {
    p[0] = buf.data();
  } else {
    p[0] = buf.data();
    p[1] = g.colors == 1 ? p[0] : p[0] + size;
    p[2] = g.colors == 1 ? p[0] : p[0] + 2 * size;
    p[3] = p[0] + 3 * size;
  }
  // setorientation against the reader's bottom-left origin (5-8 as 1-4)
  const int o = t.orientation > 4 ? t.orientation - 4 : t.orientation;
  const bool flip_v = o == 1 || o == 2;
  const bool flip_h = o == 2 || o == 3;
  std::vector<uint32_t> raster(size_t{w} * h);
  const int64_t toskew = flip_v ? -2 * int64_t{w} : 0;
  put_chunk(g, raster, flip_v ? int64_t{h - 1} * w : 0, w, h,
            int64_t{cw} - w, toskew, p);
  if (flip_h)
    for (uint32_t r = 0; r < h; r++)
      std::reverse(raster.begin() + size_t{r} * w, raster.begin() + size_t{r + 1} * w);
  // OpenCV: raster row i is image row y + h - 1 - i
  const bool vert = o == 3 || o == 4;
  const uint32_t img_y = vert ? t.h - y0 - h : y0;
  for (uint32_t i = 0; i < h; i++) {
    uint8_t* out = &img->rgb[(size_t{img_y + h - 1 - i} * t.w + x0) * 3];
    for (uint32_t x = 0; x < w; x++) {
      const uint32_t v = raster[size_t{i} * w + x];
      out[3 * x] = static_cast<uint8_t>(v);
      out[3 * x + 1] = static_cast<uint8_t>(v >> 8);
      out[3 * x + 2] = static_cast<uint8_t>(v >> 16);
    }
  }
  return true;
}

// Pillow's _decodeAsRGBA, one block of rows: TIFFRGBAImageGet of rows
// [y0, y0 + h) at full width, as stored (Pillow's exif_transpose applies
// the orientation afterwards), through gtStripContig or gtStripSeparate
// over one strip, or gtTileContig or gtTileSeparate over a row of tiles,
// which share one buffer (a tile that fails to decode puts what the buffer
// holds past what it decoded), into the RGBA bytes of rows [y0, y0 + h):
// false where the block's first read fails.
bool read_band(Rgba& g, uint32_t y0, uint32_t h, std::vector<uint8_t>& rgba) {
  const Dir& t = g.t;
  const uint32_t W = t.w, cw = t.tiled ? t.tw : t.w;
  const bool contig = !(t.planar == 2 && t.spp > 1);
  if (contig && !t.tiled && t.sub[1] == 0) return false;
  size_t occ = t.chunk_size;
  if (!t.tiled) {
    const uint64_t rows = std::min<uint64_t>(std::min(t.rps, t.h), t.h - y0);
    const uint64_t rows_read = contig ? (h + t.sub[1] - 1) / t.sub[1] * t.sub[1] : h;
    occ = std::min<uint64_t>(strip_size(t, rows), rows_read * t.scanline);
  }
  const size_t size = t.chunk_size;
  const int planes = contig ? 1 : g.colors + (g.alpha ? 1 : 0);
  std::vector<uint8_t> buf;
  std::vector<uint32_t> raster(size_t{W} * h);
  const uint32_t across = t.tiled ? howmany32(t.w, t.tw) : 1;
  for (uint32_t x0 = 0; x0 < W; x0 += cw) {
    const uint32_t w = std::min(cw, W - x0);
    const uint32_t index = t.tiled ? y0 / t.th * across + x0 / t.tw : y0 / t.rps;
    for (int k = 0; k < planes; k++) {
      if (buf.empty()) {  // allocated once the first chunk's bytes read
        std::vector<uint8_t> probe(occ + 16, 0);
        if (read_chunk(g, index + k * t.per_plane, k == 0, probe.data(), occ, true) < 0)
          return false;
        buf.assign(size * (contig ? 1 : (g.alpha ? 4 : 3)) + 16, 0);
        std::memcpy(buf.data(), probe.data(), occ);
        continue;
      }
      // a chunk that fails to read zeroes what was asked of it
      uint8_t* dst = buf.data() + size * (contig || g.colors == 1 ? (k == 0 ? 0 : 3) : k);
      if (read_chunk(g, index + k * t.per_plane, k == 0, dst, occ, true) < 0)
        std::memset(dst, 0, occ);
    }
    const uint8_t* p[4] = {buf.data(), buf.data(), buf.data(), buf.data() + 3 * size};
    if (!contig && g.colors != 1) {
      p[1] = buf.data() + size;
      p[2] = buf.data() + 2 * size;
    }
    put_chunk(g, raster, x0, w, h, int64_t{cw} - w, int64_t{W} - w, p);
  }
  for (size_t i = 0; i < raster.size(); i++)  // PACK's opaque alpha
    for (int k = 0; k < 4; k++)
      rgba[(size_t{y0} * W + i) * 4 + k] =
          static_cast<uint8_t>(k == 3 ? 255 : raster[i] >> (8 * k));
  return true;
}

// Every strip or tile through the RGBA reader, checked first (a chunk
// libtiff refuses refuses the image before it is allocated), into img (or
// the checks alone): false where a call fails.
bool read_all(Rgba& g, uint64_t tile_w, uint64_t tile_h, Image* img) {
  const Dir& t = g.t;
  for (int pass = 0; pass < (img ? 2 : 1); pass++) {
    g.rawdatasize = 0;
    g.next = 0;
    if (pass) {
      set_image(img, static_cast<int>(t.w), static_cast<int>(t.h));
      g.compat = lzw_compat(t);
    }
    for (uint64_t y = 0; y < t.h; y += tile_h)
      for (uint64_t x = 0; x < t.w; x += tile_w)
        if (!read_rgba(g, static_cast<uint32_t>(x), static_cast<uint32_t>(y),
                       pass ? img : nullptr))
          return false;
  }
  return true;
}

// ------------------------------------------- OpenCV's scanline branch

// TiffDecoder::readData's test for its scanline branch, made before
// TIFFRGBAImageOK where the RGBA buffer of a strip or tile, 4 bytes a
// pixel, reaches 95 % of 1 GiB (1020054732 bytes, whatever the samples'
// size): one strip of the whole image (RowsPerStrip absent, 0xFFFFFFFF or
// the height, not more), 1, 3 or 4 samples of 8 or 16 bits, MINISWHITE,
// MINISBLACK or RGB, contiguous, and 4 samples only with one ExtraSamples
// value, associated alpha. 1: the branch; 0: the RGBA reader; -1: None (4
// samples without the ExtraSamples tag: TIFFGetField fails, whatever
// libtiff made of the samples).
int scanline_branch(const Dir& t, uint64_t tile_w, uint64_t tile_h) {
  if (4 * tile_w * tile_h < uint64_t{1020054732}) return 0;
  if (t.tiled || (t.spp != 1 && t.spp != 3 && t.spp != 4)) return 0;
  if ((t.bps != 8 && t.bps != 16) || tile_h != t.h) return 0;
  if (t.photometric > 2 || t.planar == 2) return 0;
  if (t.spp != 4) return 1;
  if (!t.extra_set) return -1;
  return t.extrasamples == 1 && t.sampleinfo0 == 1 ? 1 : 0;
}

// The branch's reading: TIFFReadScanline of each row in turn into one
// row's buffer, then OpenCV's copy of it into row y of img (gray to three
// channels, the first three samples else; a 16-bit sample's high byte): no
// orientation, MINISWHITE as stored, alpha dropped. The strip is filled
// once (TIFFFillStrip: the byte count's checks, the file's own bytes or a
// copy with the bits reversed), then decoded a row at a time, each row's
// bytes swapped and predicted on their own (postdecode). A row that fails
// fails the image; what follows the last row is read only as far as the
// codec reads past a full row (inflate's block ends and check). JPEG goes
// through the whole frame at once (jpeg_chunk), and fails where the frame
// is shorter than the image (a narrower frame's rows end in zeros here, in
// whatever OpenCV's row buffer held there). Without img the rows are
// decoded and dropped.
bool read_scanlines(const Dir& t, Image* img) {
  uint64_t off, bc;
  if (!chunk_at(t, 0, off, bc)) return false;
  std::vector<uint8_t> copy;
  const uint8_t* in = t.src.d ? t.src.d + off : nullptr;
  if (!in || bits_reversed(t)) {
    if (!chunk_bytes(t, 0, copy)) return false;
    in = copy.data();
  }
  size_t cc = bc;
  const size_t line = t.scanline, spp = t.spp;
  std::vector<uint8_t> row(line), frame;
  JpegCodec jc;
  std::optional<Lzw> lzw;
  std::optional<Inflate> zip;
  switch (t.compression) {
    case 1: case 32773: break;
    case 5: lzw.emplace(in, cc, lzw_compat(t)); break;
    case 8: case 32946: zip.emplace(in, cc); break;
    case 7: {
      int dims[2] = {0, 0};
      frame.assign(t.h * line, 0);
      if (jpeg_chunk(jc, t, 0, in, cc, frame.data(), frame.size(), dims) < 0 ||
          static_cast<uint64_t>(dims[1]) < t.h)
        return false;
      break;
    }
    default: return false;  // no codec, or one OpenCV's build leaves out
  }
  set_image(img, static_cast<int>(t.w), static_cast<int>(t.h));
  for (uint64_t y = 0; y < t.h; y++) {
    uint8_t* r = row.data();
    switch (t.compression) {
      case 1:  // DumpModeDecode: the whole row or a failure
        if (cc < line) return false;
        r = const_cast<uint8_t*>(in);
        in += line;
        cc -= line;
        break;
      case 32773:
        if (!packbits(in, cc, r, line)) return false;
        break;
      case 5:
        if (!lzw->decode(r, line)) return false;
        break;
      case 7:
        r = frame.data() + y * line;
        break;
      default:
        if (!zip->decode(r, line)) return false;
        break;
    }
    if (!img) continue;
    if (r != row.data()) {
      std::memcpy(row.data(), r, line);
      r = row.data();
    }
    postdecode(t, r, line);
    uint8_t* out = &img->rgb[y * t.w * 3];
    if (t.bps == 16) {  // each sample's high byte, in place
      for (size_t k = 0; k < t.w * spp; k++) {
        uint16_t v;
        std::memcpy(&v, r + 2 * k, 2);
        r[k] = static_cast<uint8_t>(v >> 8);
      }
    }
    if (spp == 3) {
      std::memcpy(out, r, t.w * 3);
    } else {
      for (size_t x = 0; x < t.w; x++) {
        const uint8_t* s = r + x * spp;
        out[3 * x] = s[0];
        out[3 * x + 1] = spp == 1 ? s[0] : s[1];
        out[3 * x + 2] = spp == 1 ? s[0] : s[2];
      }
    }
  }
  return true;
}

// ------------------------------------------------------------------ cv2

// imread's turn of a square image of orientation 5-8 after the decoder:
// transposed (5, 7) or anti-transposed (6, 8), in place.
void transpose(Image& img, int orientation) {
  const size_t n = static_cast<size_t>(img.w);
  uint8_t* p = img.rgb.data();
  for (size_t y = 0; y < n; y++)
    for (size_t x = orientation % 2 ? y + 1 : 0; x < n; x++) {
      const size_t a = y * n + x;
      const size_t b = orientation % 2 ? x * n + y : (n - 1 - x) * n + (n - 1 - y);
      if (orientation % 2 == 0 && b <= a) continue;
      for (int c = 0; c < 3; c++) std::swap(p[3 * a + c], p[3 * b + c]);
    }
}

int cv2_impl(const Src& src, Image* img, int* dims, bool head) {
  Dir t;
  t.src = src;
  if (!read_dir(t)) return kUnreadable;
  // readHeader: Photometric required; LogLuv taken as float RGB whatever
  // its samples, anything else by the samples' bits and format
  if (!t.photo_set) return kUnreadable;
  const int b = t.bps;
  if (t.photometric != 32845) {
    if (b != 1 && b != 8 && b != 10 && b != 12 && b != 14 && b != 16 &&
        b != 32 && b != 64 && !(b == 4 && t.photometric == 3))
      return kUnreadable;
    if (b <= 16 && t.sampleformat != 1 && t.sampleformat != 2)
      return kUnreadable;
    if (t.spp > 4) return kUnreadable;  // normalizeChannelsNumber
  }
  if (!cv2_size_ok(t.w, t.h)) return kRaises;  // validateInputImageSize
  // readData: the strip's or tile's size
  uint64_t tile_w = t.tiled ? t.tw : t.w;
  uint64_t tile_h = t.tiled ? t.th : (!t.rps_set || t.rps == 0xFFFFFFFFu ? t.h : t.rps);
  if (tile_w == 0) tile_w = t.w;
  if (tile_h == 0) tile_h = t.h;
  if (tile_w > (1u << 24) || tile_h > (1u << 24)) return kUnreadable;
  const int branch = scanline_branch(t, tile_w, tile_h);
  if (branch < 0) return kUnreadable;
  if (branch) {
    if (t.orientation >= 5 && t.w != t.h) return kUnreadable;
    dims[0] = static_cast<int>(t.h);
    dims[1] = static_cast<int>(t.w);
    if (head) return kOk;
    if (!read_scanlines(t, img)) return kUnreadable;
    if (img && t.orientation >= 5) transpose(*img, t.orientation);
    return kOk;
  }
  // TIFFRGBAImageOK and TIFFRGBAImageBegin
  if (not_configured(t.compression)) return kUnreadable;
  if (b != 1 && b != 2 && b != 4 && b != 8 && b != 16) return kUnreadable;
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
      if (t.inkset != 1 || t.spp < 4) return kUnreadable;
      break;
    case 8:
      if (t.spp != 3 || colors != 3 || (b != 8 && b != 16)) return kUnreadable;
      break;
    case 32844:  // LogL: "LogL data must have Compression=34676"
      if (t.compression != 34676) return kUnreadable;
      break;
    case 32845:  // LogLuv: either SGILog, contiguous, 3 colour samples
      if ((t.compression != 34676 && t.compression != 34677) ||
          t.planar != 1 || t.spp != 3 || colors != 3)
        return kUnreadable;
      break;
    default:
      return kUnreadable;
  }
  if (4 * tile_h * tile_w >= (uint64_t{1} << 30)) return kUnreadable;
  // TIFFRGBAImageBegin: libjpeg turns contiguous YCbCr JPEG into RGB;
  // SGILog data is read at SGILOGDATAFMT_8BIT, which rewrites the
  // directory's BitsPerSample and SampleFormat (LogLuvVSetField): LogL as
  // 8-bit gray, LogLuv as 8-bit RGB
  if (t.compression == 7 && t.photometric == 6 && t.planar == 1) {
    t.up = true;
    set_sizes(t);
  }
  if (t.photometric == 32844 || t.photometric == 32845) {
    t.sgilog = t.photometric;
    t.photometric = t.photometric == 32844 ? 1 : 2;
    t.bps = 8;
    t.sampleformat = 1;
    set_sizes(t);
  }
  Rgba g(t);
  if (!pick(g)) return kUnreadable;
  // 5-8: imread transposes what the decoder gives, which fails but for a
  // square image
  if (t.orientation >= 5 && t.w != t.h) return kUnreadable;
  dims[0] = static_cast<int>(t.h);
  dims[1] = static_cast<int>(t.w);
  if (head) return kOk;
  if (!read_all(g, tile_w, tile_h, img)) return kUnreadable;
  if (img && t.orientation >= 5) transpose(*img, t.orientation);
  return kOk;
}

// ------------------------------------------------------------------ PIL

// A value of Pillow's IFD: the integers of an integer type, or a kind that
// no integer check accepts (bytes, text, rationals, floats).
struct PilTag {
  bool present = false, ints = false;
  std::vector<int64_t> v;  // ints, or the bytes of a BYTE/UNDEFINED tag
  int type = 0;
  // a number of any numeric type (integer, rational, float), as the
  // integer it equals in Python, or kNoInt: keys and comparisons take it
  std::vector<int64_t> num;
  std::vector<std::pair<int64_t, int64_t>> rat;  // a rational's terms
};

constexpr int64_t kNoInt = INT64_MIN;

// The integer a double equals, or kNoInt.
int64_t as_int(double x) {
  return std::isfinite(x) && x == std::trunc(x) && std::fabs(x) < 9.2e18
             ? static_cast<int64_t>(x) : kNoInt;
}

// Pillow's ImageFileDirectory_v2 of the first IFD: its tags in the order
// first seen, each with the value last seen. Only a little-endian BigTIFF
// is one to Pillow: it reads "MM\0+" as classic TIFF.
struct Pil {
  bool be = false, big = false;
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
  uint8_t hd[16];
  if (!s.read(0, 8, hd)) return false;
  p.be = hd[0] == 'M';
  p.big = hd[2] == 43;
  if (p.big && !s.read(8, 8, hd + 8)) return false;
  p.ifd = p.big ? s.u64(hd + 8) : s.u32(hd + 4);
  // "no more images in TIFF file", "Unable to seek to frame"
  if (p.ifd == 0 || p.ifd >= (uint64_t{1} << 63)) return false;
  const int count_size = p.big ? 8 : 2, entry_size = p.big ? 20 : 12;
  const uint64_t inline_size = p.big ? 8 : 4;
  uint8_t cb[8];
  if (!s.read(p.ifd, count_size, cb)) return true;  // a warning: no tags
  const uint64_t n = p.big ? s.u64(cb) : s.u16(cb);
  for (uint64_t i = 0; i < n; i++) {
    uint8_t e[20];
    if (p.ifd + count_size + entry_size * (i + 1) > s.n ||
        !s.read(p.ifd + count_size + entry_size * i, entry_size, e))
      return true;
    const uint16_t tag = s.u16(e), type = s.u16(e + 2);
    const uint64_t count = p.big ? s.u64(e + 4) : s.u32(e + 4);
    const uint8_t* field = e + (p.big ? 12 : 8);
    const int unit = pil_unit(type);
    if (!unit) continue;  // an unsupported type
    if (count > s.n) return true;  // its data cannot be in the file
    const uint64_t size = count * unit;
    std::vector<uint8_t> data;
    if (size > inline_size) {
      const uint64_t off = p.big ? s.u64(field) : s.u32(field);
      if (off > s.n || size > s.n - off) return true;  // the IFD ends here
      data.resize(size);
      s.read(off, size, data.data());
    } else {
      data.assign(field, field + size);
    }
    if (size == 0) continue;
    PilTag t;
    t.present = true;
    t.type = type;
    t.ints = type == 3 || type == 4 || type == 6 || type == 8 || type == 9 ||
             type == 13 || type == 16;
    if (t.ints) {
      for (uint64_t k = 0; k < count; k++) {
        const uint8_t* q = &data[k * unit];
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
    if (t.ints) {
      t.num = t.v;
    } else if (type == 5 || type == 10 || type == 11 || type == 12) {
      for (uint64_t k = 0; k < count; k++) {
        const uint8_t* q = &data[k * unit];
        double x;
        if (type == 11 || type == 12) {
          if (type == 11) {
            const uint32_t u = s.u32(q);
            float f;
            std::memcpy(&f, &u, 4);
            x = f;
          } else {
            const uint64_t u = s.u64(q);
            std::memcpy(&x, &u, 8);
          }
        } else {  // IFDRational: nan over a denominator of 0
          const int64_t n = type == 5 ? int64_t{s.u32(q)} : static_cast<int32_t>(s.u32(q));
          const int64_t d = type == 5 ? int64_t{s.u32(q + 4)} : static_cast<int32_t>(s.u32(q + 4));
          t.rat.emplace_back(n, d);
          x = d == 0 ? NAN : static_cast<double>(n) / static_cast<double>(d);
        }
        t.num.push_back(as_int(x));
      }
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

// A tag's values as the numbers Python compares (kNoInt for a number that
// equals no integer), or false where it holds no number (bytes, text).
bool pil_nums(const Pil& p, uint16_t tag, std::vector<int64_t>& v) {
  const PilTag* t = p.get(tag);
  if (!t || t->num.empty()) return false;
  v = t->num;
  return true;
}

// Pillow's OPEN_INFO: (byte orders: 1 "II", 2 "MM", 3 both; Photometric,
// SampleFormat, FillOrder, BitsPerSample, ExtraSamples) -> (mode,
// rawmode).
struct OpenInfo {
  int prefix, photo, sf, fill;
  std::vector<int64_t> bps, extra;
  const char* mode;
  const char* raw;
};

const std::vector<OpenInfo>& open_info() {
  static const std::vector<OpenInfo> table = {
    {3, 0, 1, 1, {1}, {}, "1", "1;I"},
    {3, 0, 1, 2, {1}, {}, "1", "1;IR"},
    {3, 0, 1, 1, {2}, {}, "L", "L;2I"},
    {3, 0, 1, 2, {2}, {}, "L", "L;2IR"},
    {3, 0, 1, 1, {4}, {}, "L", "L;4I"},
    {3, 0, 1, 2, {4}, {}, "L", "L;4IR"},
    {3, 0, 1, 1, {8}, {}, "L", "L;I"},
    {3, 0, 1, 2, {8}, {}, "L", "L;IR"},
    {1, 0, 1, 1, {16}, {}, "I;16", "I;16"},
    {1, 0, 3, 1, {32}, {}, "F", "F;32F"},
    {2, 0, 3, 1, {32}, {}, "F", "F;32BF"},
    {3, 1, 1, 1, {1}, {}, "1", "1"},
    {3, 1, 1, 2, {1}, {}, "1", "1;R"},
    {3, 1, 1, 1, {2}, {}, "L", "L;2"},
    {3, 1, 1, 2, {2}, {}, "L", "L;2R"},
    {3, 1, 1, 1, {4}, {}, "L", "L;4"},
    {3, 1, 1, 2, {4}, {}, "L", "L;4R"},
    {3, 1, 1, 1, {8}, {}, "L", "L"},
    {3, 1, 1, 2, {8}, {}, "L", "L;R"},
    {3, 1, 2, 1, {8}, {}, "L", "L"},
    {3, 1, 1, 1, {8, 8}, {2}, "LA", "LA"},
    {1, 1, 1, 1, {12}, {}, "I;16", "I;12"},
    {1, 1, 1, 1, {16}, {}, "I;16", "I;16"},
    {2, 1, 1, 1, {16}, {}, "I;16B", "I;16B"},
    {1, 1, 1, 2, {16}, {}, "I;16", "I;16R"},
    {1, 1, 2, 1, {16}, {}, "I", "I;16S"},
    {2, 1, 2, 1, {16}, {}, "I", "I;16BS"},
    {1, 1, 1, 1, {32}, {}, "I", "I;32N"},
    {1, 1, 2, 1, {32}, {}, "I", "I;32S"},
    {2, 1, 2, 1, {32}, {}, "I", "I;32BS"},
    {1, 1, 3, 1, {32}, {}, "F", "F;32F"},
    {2, 1, 3, 1, {32}, {}, "F", "F;32BF"},
    {3, 2, 1, 1, {8, 8, 8}, {}, "RGB", "RGB"},
    {3, 2, 1, 2, {8, 8, 8}, {}, "RGB", "RGB;R"},
    {3, 2, 1, 1, {8, 8, 8, 8}, {}, "RGBA", "RGBA"},
    {3, 2, 1, 1, {8, 8, 8, 8}, {0}, "RGB", "RGBX"},
    {3, 2, 1, 1, {8, 8, 8, 8}, {1}, "RGBA", "RGBa"},
    {3, 2, 1, 1, {8, 8, 8, 8}, {2}, "RGBA", "RGBA"},
    {3, 2, 1, 1, {8, 8, 8, 8}, {999}, "RGBA", "RGBA"},
    {3, 2, 1, 1, {8, 8, 8, 8, 8}, {0, 0}, "RGB", "RGBXX"},
    {3, 2, 1, 1, {8, 8, 8, 8, 8}, {1, 0}, "RGBA", "RGBaX"},
    {3, 2, 1, 1, {8, 8, 8, 8, 8}, {2, 0}, "RGBA", "RGBAX"},
    {3, 2, 1, 1, {8, 8, 8, 8, 8, 8}, {0, 0, 0}, "RGB", "RGBXXX"},
    {3, 2, 1, 1, {8, 8, 8, 8, 8, 8}, {1, 0, 0}, "RGBA", "RGBaXX"},
    {3, 2, 1, 1, {8, 8, 8, 8, 8, 8}, {2, 0, 0}, "RGBA", "RGBAXX"},
    {1, 2, 1, 1, {16, 16, 16}, {}, "RGB", "RGB;16L"},
    {2, 2, 1, 1, {16, 16, 16}, {}, "RGB", "RGB;16B"},
    {1, 2, 1, 1, {16, 16, 16, 16}, {}, "RGBA", "RGBA;16L"},
    {2, 2, 1, 1, {16, 16, 16, 16}, {}, "RGBA", "RGBA;16B"},
    {1, 2, 1, 1, {16, 16, 16, 16}, {0}, "RGB", "RGBX;16L"},
    {2, 2, 1, 1, {16, 16, 16, 16}, {0}, "RGB", "RGBX;16B"},
    {1, 2, 1, 1, {16, 16, 16, 16}, {1}, "RGBA", "RGBa;16L"},
    {2, 2, 1, 1, {16, 16, 16, 16}, {1}, "RGBA", "RGBa;16B"},
    {1, 2, 1, 1, {16, 16, 16, 16}, {2}, "RGBA", "RGBA;16L"},
    {2, 2, 1, 1, {16, 16, 16, 16}, {2}, "RGBA", "RGBA;16B"},
    {3, 3, 1, 1, {1}, {}, "P", "P;1"},
    {3, 3, 1, 2, {1}, {}, "P", "P;1R"},
    {3, 3, 1, 1, {2}, {}, "P", "P;2"},
    {3, 3, 1, 2, {2}, {}, "P", "P;2R"},
    {3, 3, 1, 1, {4}, {}, "P", "P;4"},
    {3, 3, 1, 2, {4}, {}, "P", "P;4R"},
    {3, 3, 1, 1, {8}, {}, "P", "P"},
    {3, 3, 1, 2, {8}, {}, "P", "P;R"},
    {3, 3, 1, 1, {8, 8}, {0}, "P", "PX"},
    {3, 3, 1, 1, {8, 8}, {2}, "PA", "PA"},
    {3, 5, 1, 1, {8, 8, 8, 8}, {}, "CMYK", "CMYK"},
    {3, 5, 1, 1, {8, 8, 8, 8, 8}, {0}, "CMYK", "CMYKX"},
    {3, 5, 1, 1, {8, 8, 8, 8, 8, 8}, {0, 0}, "CMYK", "CMYKXX"},
    {1, 5, 1, 1, {16, 16, 16, 16}, {}, "CMYK", "CMYK;16L"},
    {2, 5, 1, 1, {16, 16, 16, 16}, {}, "CMYK", "CMYK;16B"},
    {3, 6, 1, 1, {8}, {}, "L", "L"},
    {3, 6, 1, 1, {8, 8, 8}, {}, "RGB", "RGBX"},
    {3, 8, 1, 1, {8, 8, 8}, {}, "LAB", "LAB"},
  };
  return table;
}

// The modes the port decodes (not "LAB", whose convert("RGB") is
// LittleCMS's transform).
bool decoded_mode(const std::string& mode) {
  return mode == "1" || mode == "L" || mode == "LA" || mode == "P" ||
         mode == "PA" || mode == "I;16" || mode == "I;16B" || mode == "I" ||
         mode == "F" || mode == "RGB" || mode == "RGBA" || mode == "CMYK";
}

// The bits a pixel of one of Pillow's unpackers (rawmodes) reads, or 0
// where Pillow has no such unpacker for the mode.
int raw_bits(const std::string& mode, const std::string& raw) {
  static const std::pair<const char*, int> known[] = {
      {"1", 1}, {"1;I", 1}, {"1;R", 1}, {"1;IR", 1}, {"L;2", 2}, {"L;2I", 2},
      {"L;2R", 2}, {"L;2IR", 2}, {"L;4", 4}, {"L;4I", 4}, {"L;4R", 4},
      {"L;4IR", 4}, {"L", 8}, {"L;I", 8}, {"L;R", 8}, {"LA", 16},
      {"I;16", 16}, {"I;16B", 16}, {"I;16R", 16}, {"I;16N", 16},
      {"I;12", 12}, {"I;16S", 16}, {"I;16BS", 16}, {"I;32N", 32},
      {"I;32S", 32}, {"I;32BS", 32}, {"F;32F", 32}, {"F;32BF", 32},
      {"P;1", 1}, {"P;2", 2}, {"P;4", 4}, {"P", 8}, {"P;R", 8}, {"PX", 16},
      {"PA", 16}, {"RGB", 24}, {"RGB;R", 24}, {"RGBX", 32}, {"RGBXX", 40},
      {"RGBXXX", 48}, {"RGBA", 32}, {"RGBAX", 40}, {"RGBAXX", 48},
      {"RGBa", 32}, {"RGBaX", 40}, {"RGBaXX", 48}, {"RGB;16L", 48},
      {"RGB;16B", 48}, {"RGB;16N", 48}, {"RGBA;16L", 64}, {"RGBA;16B", 64},
      {"RGBA;16N", 64}, {"RGBX;16L", 64}, {"RGBX;16B", 64},
      {"RGBX;16N", 64}, {"RGBa;16L", 64}, {"RGBa;16B", 64},
      {"RGBa;16N", 64}, {"R", 8}, {"G", 8}, {"B", 8}, {"A", 8},
      {"R;16N", 16}, {"G;16N", 16}, {"B;16N", 16}, {"A;16N", 16},
      {"CMYK", 32}, {"CMYKX", 40}, {"CMYKXX", 48}, {"CMYK;16L", 64},
      {"CMYK;16B", 64}, {"CMYK;16N", 64}, {"C", 8}, {"M", 8}, {"Y", 8},
      {"K", 8}};
  // one band: the planes of planar files (8 or 16 bits of an RGB(A) band),
  // or a whole one-band mode
  const bool band16 = raw.size() == 5 && raw.compare(1, 4, ";16N") == 0 &&
                      std::string("RGBA").find(raw[0]) != std::string::npos;
  if (raw.size() == 1 || band16) {
    const char c = raw[0];
    if ((c == 'R' || c == 'G' || c == 'B') && (mode == "RGB" || mode == "RGBA"))
      return raw.size() == 1 ? 8 : 16;
    if (raw.size() == 1 && mode == "CMYK" &&
        std::string("CMYK").find(c) != std::string::npos)
      return 8;
    if (c == 'A' && mode == "RGBA") return raw.size() == 1 ? 8 : 16;
    if (raw != mode) return 0;
  }
  for (const auto& k : known)
    if (raw == k.first) return k.second;
  return 0;
}

// A pixel of Pillow's image in the mode: bands 0-3 (an I;16 value in band
// 0, a palette index in band 0), or the value of an "I" or "F" pixel.
struct Px {
  uint16_t v[4] = {0, 0, 0, 0};
  int32_t i = 0;
  float f = 0.0f;
};

uint8_t unpremul(unsigned c, unsigned a) {
  return a == 0 ? 0 : static_cast<uint8_t>(std::min(255u, c * 255 / a));
}

// Pillow's unpacker `raw` over n pixels of `in` into px.
void unpack(const std::string& raw, const uint8_t* in, size_t n, Px* px) {
  const bool rev = raw.size() > 1 && raw.back() == 'R' && raw != "I;16R";
  const bool inv = raw.find('I') != std::string::npos && raw[0] != 'I' &&
                   raw != "1" && raw.find("I;") == std::string::npos;
  auto byte = [&](size_t i) { return rev ? reversed(in[i]) : in[i]; };
  if (raw[0] == '1' || (raw.size() > 2 && (raw[0] == 'L' || raw[0] == 'P') &&
                        raw[1] == ';' && raw[2] >= '1' && raw[2] <= '4')) {
    const int bits = raw[0] == '1' ? 1 : raw[2] - '0';
    const int per = 8 / bits, max = (1 << bits) - 1;
    for (size_t x = 0; x < n; x++) {
      const int v = byte(x / per) >> (8 - bits * (x % per + 1)) & max;
      if (raw[0] == 'P') {
        px[x].v[0] = static_cast<uint16_t>(v);
      } else {
        const int l = v * (255 / max);
        px[x].v[0] = static_cast<uint16_t>(inv ? 255 - l : l);
      }
    }
    return;
  }
  if (raw == "L" || raw == "L;I" || raw == "L;R" || raw == "P" || raw == "P;R") {
    for (size_t x = 0; x < n; x++)
      px[x].v[0] = static_cast<uint16_t>(inv ? 255 - byte(x) : byte(x));
    return;
  }
  if (raw == "LA" || raw == "PA" || raw == "PX") {
    for (size_t x = 0; x < n; x++) {
      px[x].v[0] = in[2 * x];
      if (raw != "PX") px[x].v[3] = in[2 * x + 1];
    }
    return;
  }
  if (raw == "I;12") {  // unpackI12_I16: pairs of 12-bit values in 3 bytes
    for (size_t x = 0; x < n; x++) {
      const uint8_t* q = in + x / 2 * 3;
      px[x].v[0] = static_cast<uint16_t>(x % 2 ? (q[1] & 15) << 8 | q[2]
                                               : q[0] << 4 | q[1] >> 4);
    }
    return;
  }
  if (raw[0] == 'I' || raw[0] == 'F') {
    // "I" and "F": 16-bit signed, 32-bit integer (I;32N unsigned, read as
    // a signed INT32) or float, in either byte order
    const bool be = raw.find('B') != std::string::npos;
    const size_t unit = raw.find(";32") != std::string::npos ? 4 : 2;
    if (unit == 4 || raw.back() == 'S') {
      for (size_t x = 0; x < n; x++) {
        const uint8_t* q = in + unit * x;
        uint32_t u = 0;
        for (size_t k = 0; k < unit; k++) u |= uint32_t{q[be ? unit - 1 - k : k]} << (8 * k);
        if (raw[0] == 'F')
          std::memcpy(&px[x].f, &u, 4);
        else
          px[x].i = unit == 4 ? static_cast<int32_t>(u) : static_cast<int16_t>(u);
      }
      return;
    }
  }
  if (raw.rfind("I;16", 0) == 0) {
    for (size_t x = 0; x < n; x++) {
      const uint8_t a = in[2 * x], b = in[2 * x + 1];
      px[x].v[0] = static_cast<uint16_t>(raw == "I;16B" ? a << 8 | b
                                         : raw == "I;16R" ? reversed(a) | reversed(b) << 8
                                                          : a | b << 8);
    }
    return;
  }
  if (raw.size() == 1 || (raw.size() == 5 && raw.compare(1, 4, ";16N") == 0)) {
    // one band, 8 or 16 bits
    const char c = raw[0];
    const int band = c == 'R' || c == 'L' || c == 'P' || c == '1' || c == 'C'
                         ? 0 : c == 'G' || c == 'M' ? 1
                         : c == 'B' || c == 'Y' ? 2 : 3;
    for (size_t x = 0; x < n; x++)
      px[x].v[band] = raw.size() == 1 ? in[x] : in[2 * x + 1];
    return;
  }
  // RGB, RGBA and CMYK, 8 or 16 bits (the high byte), X samples skipped
  const bool wide = raw.find(";16") != std::string::npos;
  if (raw.rfind("CMYK", 0) == 0) {
    const size_t step = (wide ? 2 : 1) * raw.substr(0, raw.find(';')).size();
    const bool big = raw.back() == 'B';
    for (size_t x = 0; x < n; x++) {
      const uint8_t* q = in + x * step;
      for (int k = 0; k < 4; k++) px[x].v[k] = wide ? q[2 * k + (big ? 0 : 1)] : q[k];
    }
    return;
  }
  const bool big = raw.back() == 'B';
  const std::string base = raw.substr(0, raw.find(';'));
  const size_t step = (wide ? 2 : 1) * base.size();
  const bool alpha = base.size() > 3 && (base[3] == 'A' || base[3] == 'a');
  for (size_t x = 0; x < n; x++) {
    const uint8_t* q = in + x * step;
    for (int k = 0; k < (alpha ? 4 : 3); k++)
      px[x].v[k] = wide ? q[2 * k + (big ? 0 : 1)] : rev ? reversed(q[k]) : q[k];
    if (base.size() > 3 && base[3] == 'a')
      for (int k = 0; k < 3; k++) px[x].v[k] = unpremul(px[x].v[k], px[x].v[3]);
  }
}

// Image.convert("RGB") of a pixel of `mode`.
void to_rgb(const std::string& mode, const Px& px, const std::vector<uint8_t>& pal,
            uint8_t* o) {
  if (mode == "P" || mode == "PA") {
    const size_t n = pal.size() / 3, v = px.v[0];
    if (v < n) {
      o[0] = pal[v];
      o[1] = pal[n + v];
      o[2] = pal[2 * n + v];
    } else {
      o[0] = o[1] = o[2] = 0;
    }
  } else if (mode == "RGB" || mode == "RGBA") {
    for (int k = 0; k < 3; k++) o[k] = static_cast<uint8_t>(px.v[k]);
  } else if (mode == "CMYK") {
    cmyk_to_rgb(px.v[0], px.v[1], px.v[2], px.v[3], o);
  } else if (mode == "I") {  // clipped
    o[0] = o[1] = o[2] = static_cast<uint8_t>(std::clamp(px.i, 0, 255));
  } else if (mode == "F") {  // clipped, truncated; NaN gives 0
    const float f = px.f;
    o[0] = o[1] = o[2] = !(f > 0.0f) ? 0 : f >= 255.0f ? 255 : static_cast<uint8_t>(f);
  } else {  // 1, L, LA, I;16 (clipped)
    o[0] = o[1] = o[2] = static_cast<uint8_t>(std::min<unsigned>(px.v[0], 255));
  }
}

int pil_impl(const Src& src, Image* img, int* dims, bool head) {
  Pil p;
  if (!pil_open(src, p)) return kUnreadable;
  if (p.get(0xBC01)) return kUnreadable;
  // COMPRESSION_INFO (a dict: any number equal to a key finds it)
  int64_t comp = 1;
  std::vector<int64_t> n;
  if (p.get(kCompression)) {
    if (!pil_nums(p, kCompression, n)) return kUnreadable;
    comp = n[0];
    static const int64_t known[] = {1, 2, 3, 4, 5, 6, 7, 8, 32771, 32773,
                                    32809, 32946, 34676, 34677, 34925,
                                    50000, 50001};
    if (std::find(std::begin(known), std::end(known), comp) ==
        std::end(known))
      return kUnreadable;
    // WebP: Pillow's libtiff has no codec for it, so every strip and tile
    // fails to decode ("WEBP compression support is not configured")
    if (comp == 50001) return kUnreadable;
  }
  int64_t planar = 1, photo = 0, fillorder = 1, w, h, orientation = 0;
  const PilTag* tp;
  if (pil_nums(p, kPlanar, n)) planar = n[0];
  // a value of no number makes a key of no mode
  if (p.get(kPhotometric)) {
    if (!pil_nums(p, kPhotometric, n)) return kUnreadable;
    photo = n[0];
  }
  if (comp == 6) photo = 6;
  if (p.get(kFillOrder)) {
    if (!pil_nums(p, kFillOrder, n)) return kUnreadable;
    fillorder = n[0];
  }
  if (!pil_int(p, kWidth, w) || !pil_int(p, kLength, h)) return kUnreadable;
  if (pil_nums(p, kOrientation, n)) orientation = n[0];
  const bool swap = orientation >= 5 && orientation <= 8;
  // sample format, bits, extra samples, samples a pixel
  std::vector<int64_t> sf = {1}, bps = {1}, extra;
  if (p.get(kSampleFormat)) {
    if (!pil_nums(p, kSampleFormat, sf)) return kUnreadable;
    if (sf.size() > 1 && std::all_of(sf.begin(), sf.end(),
                                     [](int64_t x) { return x == 1; }))
      sf = {1};
  }
  if (p.get(kBps) && !pil_nums(p, kBps, bps)) return kUnreadable;
  if (p.get(kExtraSamples) && !pil_nums(p, kExtraSamples, extra))
    return kUnreadable;
  int64_t spp = 1;
  if ((tp = p.get(kSpp))) {
    if (!pil_nums(p, kSpp, n)) return kUnreadable;
    spp = n[0];
    // a number of no integer type slices or repeats no tuple
    if (!tp->ints && spp != static_cast<int64_t>(bps.size()))
      return kUnreadable;
  } else if (comp == 6 && (photo == 2 || photo == 6)) {
    spp = 3;
  }
  if (spp == kNoInt) return kUnreadable;
  if (spp > 6) return kUnreadable;  // MAX_SAMPLESPERPIXEL
  if (spp < static_cast<int64_t>(bps.size())) bps.resize(std::max<int64_t>(spp, 0));
  else if (spp > static_cast<int64_t>(bps.size()) && bps.size() == 1)
    bps.assign(spp, bps[0]);
  if (static_cast<int64_t>(bps.size()) != spp) return kUnreadable;
  // OPEN_INFO: (mode, rawmode), or "unknown pixel mode"
  auto lookup = [&](int64_t fill) -> const OpenInfo* {
    if (sf.size() != 1) return nullptr;
    for (const OpenInfo& e : open_info())
      if ((e.prefix & (p.be ? 2 : 1)) && e.photo == photo && e.sf == sf[0] &&
          e.fill == fill && e.bps == bps && e.extra == extra)
        return &e;
    return nullptr;
  };
  const OpenInfo* info = lookup(fillorder);
  if (!info) return kUnreadable;
  const std::string mode = info->mode;
  // ThunderScan and SGILog data go through libtiff, whose codec setup
  // takes 4-bit ThunderScan samples alone and SGILog data of none of the
  // photometrics Pillow has a mode for
  if (comp == 32809 || comp == 34676 || comp == 34677) {
    Dir t;
    t.src = src;
    if (!read_dir(t) ||
        (t.compression == comp && (comp != 32809 || t.bps != 4)))
      return kUnreadable;
  }
  // a mode or codec the port does not decode, past Image.open's
  // DecompressionBombError, which comes first
  const int not_decoded = pil_size_ok(w, h) ? kTiff : kUnreadable;
  if (!decoded_mode(mode)) return not_decoded;
  const bool raw = comp == 1;
  if (!raw && !part1_compression(static_cast<int>(comp)) && comp != 6 &&
      comp != 7 && !fax_codec(static_cast<int>(comp)) && comp != 32809)
    return not_decoded;
  const int bps_count = (photo == 2 || photo == 6 || photo == 8 ? 3 : photo == 5 ? 4 : 1) +
                        static_cast<int>(extra.size());
  int64_t bps_sum = 0;
  for (int64_t b : bps) bps_sum += b;
  // the tiles Pillow's own reader decodes: strips or tiles, one layer a
  // plane (planar configuration 2), each (offset, extent, rawmode, stride)
  struct Tile {
    int64_t off, x0, y0, x1, y1;
    std::string raw;
    int64_t stride;
  };
  std::vector<Tile> tiles;
  const PilTag* offs = p.get(kStripOffsets);
  const bool strips = offs != nullptr;
  if (!offs) offs = p.get(kTileOffsets);
  if (raw && !offs) return kUnreadable;  // "unknown data organization"
  if (raw) {
    // the bytes of a BYTE entry iterate as integers
    if (!offs->ints && offs->type != 1) return kUnreadable;
    int64_t tw = w, th = h;
    if (strips) {
      if ((tp = p.get(kRps))) {
        if (!tp->ints || tp->v[0] < 0) return kUnreadable;
        th = tp->v[0];
      }
    } else {  // "Invalid tile dimensions"
      if (!pil_int(p, kTileWidth, tw) || !pil_int(p, kTileLength, th))
        return kUnreadable;
    }
    std::vector<int64_t> offsets = offs->v;
    if (tw == w && th == h && planar != 2) offsets = {offsets.back()};
    int64_t x = 0, y = 0;
    size_t layer = 0;
    for (int64_t o : offsets) {
      double stride = x + tw > w ? tw * static_cast<double>(bps_sum) / 8 : 0;
      std::string r = info->raw;
      if (planar == 2) {
        if (layer >= r.size()) return kUnreadable;  // IndexError
        r = r.substr(layer, 1);
        stride /= bps_count;
      }
      tiles.push_back({o, x, y, std::min(x + tw, w), std::min(y + th, h), r,
                       static_cast<int64_t>(stride)});
      x += tw;
      if (x >= w) {
        x = 0;
        y += th;
        if (y >= h) {
          y = 0;
          layer++;
        }
      }
    }
  }
  // the palette: every value // 256 (floored; bytes, the integers and
  // rationals take it, UNDEFINED data and floats raise)
  std::vector<uint8_t> pal;
  if (mode == "P" || mode == "PA") {
    const PilTag* cm = p.get(kColorMap);
    if (!cm || !(cm->ints || cm->type == 1 || !cm->rat.empty()))
      return kUnreadable;
    for (int64_t v : cm->v) pal.push_back(static_cast<uint8_t>((v >> 8) & 255));
    for (auto [num, den] : cm->rat) {
      if (den == 0) return kUnreadable;
      const int64_t q = num * (den < 0 ? -1 : 1), d = 256 * std::abs(den);
      pal.push_back(static_cast<uint8_t>((q >= 0 ? q / d : -((-q + d - 1) / d)) & 255));
    }
  }
  if (w <= 0 || h <= 0 || w > INT32_MAX || h > INT32_MAX) return kUnreadable;
  if (!pil_size_ok(w, h)) return kUnreadable;  // DecompressionBombError
  // one raw tile of a mode Pillow maps from the file is mapped at the size
  // as oriented: 5-8 read its bytes as an image of w rows of h
  const bool mappable =
      raw && tiles.size() == 1 && tiles[0].raw == mode &&
      (mode == "L" || mode == "P" || mode == "RGBA" || mode == "CMYK" ||
       mode == "I;16" || mode == "I;16B");
  const int64_t sw = swap ? h : w, sh = swap ? w : h;
  const bool mapped =
      mappable && !(tiles[0].off + sh * tiles[0].stride > static_cast<int64_t>(src.n));
  const bool remap = mapped && swap;
  dims[0] = static_cast<int>(swap && !remap ? w : h);
  dims[1] = static_cast<int>(swap && !remap ? h : w);
  if (head) return kOk;
  // load's putpalette: at most 256 entries ("invalid palette size")
  if (pal.size() / 3 > 256) return kUnreadable;
  // the image in its mode, at the size Pillow allocates
  const int64_t iw = mapped ? sw : w, ih = mapped ? sh : h;
  std::vector<Px> px(static_cast<size_t>(iw * ih));
  if (mapped) {
    const Tile& t = tiles[0];
    const int64_t unit = mode == "L" || mode == "P" ? 1
                         : mode == "RGBA" || mode == "CMYK" ? 4 : 2;
    const int64_t stride = t.stride > 0 ? t.stride : iw * unit;
    // "buffer is not large enough"
    if (t.off < 0 || t.off > static_cast<int64_t>(src.n) ||
        stride * ih > static_cast<int64_t>(src.n) - t.off)
      return kUnreadable;
    // rows `stride` apart, each of iw pixels (past the file's end, the
    // mapping's zeros)
    std::vector<uint8_t> row(static_cast<size_t>(iw * unit));
    for (int64_t r = 0; r < ih; r++) {
      const uint64_t at = t.off + r * stride;
      std::fill(row.begin(), row.end(), 0);
      src.read(at, std::min<uint64_t>(row.size(), src.n - at), row.data());
      unpack(mode, row.data(), static_cast<size_t>(iw), &px[r * iw]);
    }
  } else if (raw) {
    // sorted by offset, consecutive ones of the same extent and rawmode the
    // last; each decoded from its offset, every row in the file
    std::stable_sort(tiles.begin(), tiles.end(),
                     [](const Tile& a, const Tile& b) { return a.off < b.off; });
    std::vector<Tile> kept;
    for (const Tile& t : tiles) {
      if (!kept.empty() && kept.back().x0 == t.x0 && kept.back().y0 == t.y0 &&
          kept.back().x1 == t.x1 && kept.back().y1 == t.y1 &&
          kept.back().raw == t.raw && kept.back().stride == t.stride)
        kept.back() = t;
      else
        kept.push_back(t);
    }
    // ImageFile.load: a tile whose stride is shorter than its rows is a
    // decoder error that only the last tile's raises (each tile's error
    // code replaces the one before); the others raise at once
    std::vector<bool> decoded(kept.size(), true);
    for (Tile& t : kept)
      if (t.x0 == 0 && t.x1 == 0) {  // setimage: the whole image
        t.x1 = iw;
        t.y0 = 0;
        t.y1 = ih;
      }
    for (size_t i = 0; i < kept.size(); i++) {
      const Tile& t = kept[i];
      const int bits = raw_bits(mode, t.raw);
      if (!bits) return kUnreadable;  // "unknown raw mode"
      // "tile cannot extend outside image"
      if (t.x1 <= t.x0 || t.y1 <= t.y0 || t.off < 0) return kUnreadable;
      const int64_t xs = t.x1 - t.x0, ys = t.y1 - t.y0;
      const int64_t bytes = (xs * bits + 7) / 8;
      const int64_t skip = t.stride ? t.stride - bytes : 0;
      const int64_t left = static_cast<int64_t>(src.n) - t.off;
      if (left <= 0) return kUnreadable;  // "image file is truncated"
      if (skip < 0) {
        if (i + 1 == kept.size()) return kUnreadable;
        decoded[i] = false;
        continue;
      }
      if (ys * bytes + (ys - 1) * skip > left) return kUnreadable;
    }
    std::vector<uint8_t> row;
    for (size_t i = 0; i < kept.size(); i++) {
      if (!decoded[i]) continue;
      const Tile& t = kept[i];
      const int64_t xs = t.x1 - t.x0, ys = t.y1 - t.y0;
      const int64_t bytes = (xs * raw_bits(mode, t.raw) + 7) / 8;
      const int64_t pitch = t.stride ? t.stride : bytes;
      row.resize(static_cast<size_t>(bytes));
      for (int64_t r = 0; r < ys; r++) {
        src.read(t.off + r * pitch, bytes, row.data());
        unpack(t.raw, row.data(), static_cast<size_t>(xs), &px[(t.y0 + r) * iw + t.x0]);
      }
    }
  } else {
    // libtiff: its directory, then every strip or tile decoded without an
    // error, unpacked in Pillow's rawmode (native 16-bit words, bits in
    // order: libtiff reverses them for FillOrder 2)
    Dir t;
    t.src = src;
    t.ojpeg = true;
    if (!read_dir(t) || t.w != w || t.h != h ||
        !(part1_compression(t.compression) || t.compression == 6 ||
          t.compression == 7 || fax_codec(t.compression) || t.compression == 32809))
      return kUnreadable;
    if (t.photometric == 6 && !(t.compression == 7 && t.planar == 1)) {
      // _decodeAsRGBA: libtiff's RGBA reader, a strip or a row of tiles at
      // a time, with a top-left origin
      if (t.bps != 1 && t.bps != 2 && t.bps != 4 && t.bps != 8 && t.bps != 16)
        return kUnreadable;
      if (t.sampleformat == 3) return kUnreadable;
      Rgba g(t);
      g.two_pass = false;
      if (!pick(g)) return kUnreadable;
      g.compat = lzw_compat(t);
      const uint32_t block = t.tiled ? t.th : t.rps == 0xFFFFFFFFu ? t.h : t.rps;
      // a block's RGBA buffer past INT_MAX bytes is IMAGING_CODEC_MEMORY
      if (INT32_MAX / 4 < t.w || INT32_MAX / (t.w * 4) < block) return kUnreadable;
      std::vector<uint8_t> rgba(size_t{t.w} * t.h * 4);
      for (uint32_t y = 0; y < t.h; y += block)
        if (!read_band(g, y, std::min(block, t.h - y), rgba)) return kUnreadable;
      // each row's RGBA bytes through Pillow's unpacker (RGBX; L takes
      // them byte by byte)
      for (int64_t y = 0; y < h; y++)
        unpack(info->raw, &rgba[size_t(y * w) * 4], static_cast<size_t>(w), &px[y * w]);
    } else {
    // YCbCr JPEG in one plane: libjpeg gives RGB (JPEGCOLORMODE_RGB)
    if (t.photometric == 6) {
      t.up = true;
      set_sizes(t);
    }
    std::string r = fillorder == 2 ? lookup(1)->raw : info->raw;
    if (photo == 6 && comp == 7 && planar == 1) {
      if (mode != "RGB") return kUnreadable;  // no RGB unpacker of mode L
      r = "RGB";
    }
    if (r == "I;16") r = "I;16N";
    else if (r.size() > 4 && (r.substr(r.size() - 4) == ";16B" || r.substr(r.size() - 4) == ";16L"))
      r = r.substr(0, r.size() - 1) + "N";
    const int bits = raw_bits(mode, r);
    if (!bits) return kUnreadable;
    const int bands = mode == "RGB" ? 3 : mode == "RGBA" || mode == "CMYK" ? 4
                  : mode == "LA" || mode == "PA" ? 2 : 1;
    const bool separate = t.planar == 2 && bands > 1;
    if (separate && t.bps != 8 && t.bps != 16) return kUnreadable;
    const int planes = separate ? bands : 1;
    auto unpacker = [&](int plane) {
      if (!separate) return r;
      const std::string band(1, "RGBA"[plane]);
      return t.bps == 16 ? band + ";16N" : band;
    };
    std::vector<uint8_t> buf, raw_bytes;
    const bool compat = lzw_compat(t);
    FaxCodec fax;  // the fax codec's state, kept from chunk to chunk
    Ojpeg ojpeg;
    // TIFFReadEncodedStrip / TIFFReadTile: the chunk whole, or an error
    // (zeros past the chunk: an unpacker that reads more bytes a row than
    // libtiff's row holds reads on into them)
    const size_t pad = (static_cast<size_t>(std::max<int64_t>(w, t.tw)) * 64 + 7) / 8;
    JpegCodec jpeg;
    // a chunk, of which Pillow unpacks `cols` x `rows` pixels
    auto read = [&](uint32_t chunk, size_t size, int64_t cols, int64_t rows) {
      if (t.compression == 6) {  // the codec reads the file itself
        buf.assign(size + pad, 0);
        return ojpeg_chunk(ojpeg, t, chunk, buf.data(), size) == 1;
      }
      if (!chunk_bytes(t, chunk, raw_bytes)) return false;
      buf.assign(size + pad, 0);
      // Pillow's strip or tile buffer is not zeroed: where a JPEG frame
      // or a CCITT chunk that ends early leaves pixels it unpacks
      // unwritten, Pillow's pixels are whatever memory held (refused)
      int frame[2] = {0, 0};
      if (t.compression == 7)
        return jpeg_chunk(jpeg, t, chunk, raw_bytes.data(), raw_bytes.size(),
                          buf.data(), size, frame) == 1 &&
               frame[0] >= cols && frame[1] >= rows;
      return decode_chunk(t, raw_bytes.data(), raw_bytes.size(), buf.data(), size, compat,
                          t.offsets[chunk] & 1, &fax);
    };
    if (!t.tiled) {
      const int64_t prps = t.rps_set && t.rps != 0xFFFFFFFFu ? t.rps : h;
      if (prps > INT32_MAX) return kUnreadable;
      const int64_t row = static_cast<int64_t>(t.scanline);
      // Pillow's checks: libtiff's row as long as the unpacker's, libtiff's
      // strip (TIFFStripSize) no larger than the unpacker's rows (a 32-bit
      // unsigned product in Pillow)
      const int64_t unpacked = (w * bits / planes + 7) / 8;
      const int64_t strip_size = row * std::min<int64_t>(t.rps, h);
      if (row <= 0 || row < unpacked ||
          strip_size > static_cast<uint32_t>(static_cast<uint32_t>(unpacked) *
                                             static_cast<uint32_t>(prps)))
        return kUnreadable;
      const uint64_t srps = std::min<uint64_t>(t.rps, t.h);
      for (int64_t y = 0; y < h; y += prps)
        for (int plane = 0; plane < planes; plane++) {
          const uint32_t strip = static_cast<uint32_t>(y / t.rps) +
                                 (t.planar == 2 ? plane * t.per_plane : 0);
          if (strip >= t.nstrips) return kUnreadable;
          const uint64_t in_plane = strip % t.per_plane;
          const uint64_t rows = std::min<uint64_t>(srps, t.h - in_plane * srps);
          if (!read(strip, std::min<uint64_t>(rows, prps) * row, w,
                    std::min<int64_t>(prps, h - y)))
            return kUnreadable;  // "decoder error -2"
          buf.resize(std::max<size_t>(buf.size(), strip_size + pad), 0);
          const std::string u = unpacker(plane);
          for (int64_t k = 0; k < std::min<int64_t>(prps, h - y); k++)
            unpack(u, &buf[k * row], static_cast<size_t>(w), &px[(y + k) * w]);
        }
    } else {
      const int64_t tw = t.tw, th = t.th, row = static_cast<int64_t>(t.chunk_row);
      // Pillow's checks (the first with the tile's length where its
      // width belongs)
      if (tw > INT32_MAX || th > INT32_MAX || !t.chunk_size ||
          t.chunk_size > static_cast<uint32_t>(
              (static_cast<uint32_t>(th) * bits / planes + 7) / 8 *
              static_cast<uint32_t>(tw)) ||
          !row || row > static_cast<int64_t>(t.chunk_size) ||
          t.chunk_size > INT32_MAX - 1)
        return kUnreadable;
      const uint32_t across = howmany32(t.w, t.tw);
      for (int64_t y = 0; y < h; y += th)
        for (int plane = 0; plane < planes; plane++)
          for (int64_t x = 0; x < w; x += tw) {
            if (t.planar == 2 && plane >= t.spp) return kUnreadable;
            const uint32_t tile = static_cast<uint32_t>(y / th * across + x / tw) +
                                  (t.planar == 2 ? plane * t.per_plane : 0);
            const int64_t cw = std::min(tw, w - x), cl = std::min(th, h - y);
            if (tile >= t.nstrips || !read(tile, t.chunk_size, cw, cl))
              return kUnreadable;
            const std::string u = unpacker(plane);
            for (int64_t k = 0; k < cl; k++)
              unpack(u, &buf[k * row], static_cast<size_t>(cw), &px[(y + k) * w + x]);
          }
    }
    // separate RGBA planes of associated or unspecified alpha: RGBa
    if (planes > 3 && mode == "RGBA" && t.extrasamples >= 1 &&
        (t.sampleinfo0 == 0 || t.sampleinfo0 == 1))
      for (Px& q : px)
        for (int k = 0; k < 3; k++) q.v[k] = unpremul(q.v[k], q.v[3]);
    }
  }
  // the image as Pillow holds it (mapped and swapped for 5-8), to RGB
  Image local;
  Image& out = img ? *img : local;
  out.w = static_cast<int>(iw);
  out.h = static_cast<int>(ih);
  out.rgb.assign(static_cast<size_t>(iw * ih) * 3, 0);
  for (size_t i = 0; i < px.size(); i++) to_rgb(mode, px[i], pal, &out.rgb[3 * i]);
  if (img && orientation >= 2 && orientation <= 8)
    apply_orientation(*img, static_cast<int>(orientation));
  return kOk;
}

}  // namespace

bool is_tiff_data(const uint8_t* d, size_t n) {
  return n >= 4 && (!std::memcmp(d, "II*\0", 4) || !std::memcmp(d, "MM\0*", 4) ||
                    !std::memcmp(d, "II+\0", 4) || !std::memcmp(d, "MM\0+", 4));
}

namespace {

Src memory_src(const uint8_t* d, size_t n) {
  Src s;
  s.d = d;
  s.n = n;
  s.be = d[0] == 'M';
  s.big = d[2] == '+' || d[3] == '+';
  return s;
}

}  // namespace

int tiff_cv2(const uint8_t* d, size_t n, Image* img, int* dims, bool head) {
  if (!is_tiff_data(d, n)) return kUnreadable;
  return cv2_impl(memory_src(d, n), img, dims, head);
}

int tiff_pil(const uint8_t* d, size_t n, Image* img, int* dims, bool head) {
  if (!is_tiff_data(d, n)) return kUnreadable;
  return pil_impl(memory_src(d, n), img, dims, head);
}

int probe_tiff(FILE* f, int* dims) {
  Src s;
  s.f = f;
  uint8_t sig[4];
  if (fseeko(f, 0, SEEK_END) != 0) return kUnreadable;
  s.n = static_cast<uint64_t>(ftello(f));
  if (!s.read(0, 4, sig) || !is_tiff_data(sig, 4)) return kUnreadable;
  s.be = sig[0] == 'M';
  s.big = sig[2] == '+' || sig[3] == '+';
  const int st = cv2_impl(s, nullptr, dims, true);
  if (st == kOk || st == kRaises || st == kTiff) return st;
  const int pil = pil_impl(s, nullptr, dims, true);
  return pil == kOk || pil == kTiff ? pil : kUnreadable;
}

}  // namespace tsrio
