// tsrio — the port's image IO: decode, bilinear resize, threaded batch
// assembly, and threaded PNG/PPM/JPEG/BMP encode + write.
//
// The port's own copy of tsr_tpu/native/tsrio.cpp, grown to read every
// file the reference's paths read, with the same pixels: cv2.imread's,
// else PIL's convert("RGB") where cv2 gives None and PIL reads the file
// (the reference's fallback); and to write every file they write through
// cv2.imwrite, with the same bytes. It is the port's only codec: no module
// of the port imports cv2 or PIL, and it links nothing but zlib. Decoded:
//   - PNG, PNM (P1-P6, ASCII and binary), PFM, PAM (P7), BMP (palette,
//     16/24/32-bit, BI_BITFIELDS, RLE8/RLE4, the OS/2 core header) and Sun
//     raster: formats.cpp; GIF (the first frame): gif.cpp; Radiance HDR:
//     hdr.cpp; TIFF: tiff.cpp; WebP (a still image or an animation's first
//     frame, lossless or lossy): webp.cpp and vp8.cpp; JPEG 2000 (the JP2
//     file and the raw codestream, part 1): jpeg2000.cpp; each with cv2's
//     reader and PIL's copied (PIL reads no HDR), damaged files included;
//   - JPEG: jpeg.cpp (baseline, progressive and arithmetic coded, CMYK and
//     YCCK, damaged data as libjpeg recovers it, EXIF orientation; lossless
//     JPEG as PIL reads it, where the reference falls back to PIL).
// A file of a format cv2 reads and the port does not decode (TIFF of
// another layout, JPEG 2000 beyond part 1, AVIF) fails with a Status naming it
// (codec.h), and one on which cv2.imread raises with kRaises.
// Encoded, with cv2.imwrite's bytes where cv2 writes the format: PNG
// (8-bit RGB, zlib level 1, filter 0; lossless, so pixel-equal to cv2's
// by construction), PPM (P6), BMP (cv2's 24-bit layout) and JPEG
// (jpeg.cpp: cv2's defaults, quality 95 and 4:2:0).
//
// Exposed C ABI (used via ctypes from tsr_tpu_torch.native):
//   tsrio_load_batch(paths, n, size, out, threads, mode) -> images loaded
//     paths: '\n'-joined file paths; out: uint8[n, size, size, 3]
//     mode 0 resizes as cv2.INTER_LINEAR, mode 1 as PIL's BILINEAR.
//     Failed decodes leave their slot zeroed and are counted out.
//   tsrio_decode(path, dims, handle, pixels) -> 1 on success, else a
//     Status (codec.h: 0 unreadable or out of memory, 2 cv2.imread raises,
//     negative an unimplemented feature or a foreign format); the
//     image's (w, h) into dims, its pixels handed over at *pixels until
//     tsrio_release(*handle)
//   tsrio_probe(paths, n, dims, threads, reader) -> files probed
//     (h, w) of each image as it decodes (EXIF orientation applied) into
//     dims[n, 2]; a file that fails gets (0, its Status). Reader 0 reads
//     the header alone (cv2's header, else PIL's); reader 1 reads the
//     whole file as cv2.imread would (short of its pixels), so it fails
//     exactly where cv2.imread gives None, and with kRaises where it
//     raises.
//   tsrio_load_canvas(paths, n, ch, cw, resize_to, reflect, out, dims,
//                     threads) -> images loaded
//     Each image at native size into the top-left of its [ch, cw, 3] slot
//     of out, the rest zeros or (reflect) its reflect-101 continuation,
//     tiled; an image with a side >= resize_to > 0 is resized to fill a
//     resize_to x resize_to slot. (h, w) into dims[n, 2]. One call loads a
//     whole batch on native threads: the bucketed batches of the offline
//     generator (reflect) and of the native-upload walk (zeros).
//   tsrio_write_batch(paths, n, dims, data, format, threads) -> written
//     Threaded encode+write of n uint8 RGB images, image i of dims[2i] rows
//     and dims[2i+1] columns at data[i]; format 0 is PNG, 1 PPM, 2 JPEG,
//     3 BMP.
//   tsrio_webp_lossy_planes(data, n, flags, out, cap, dims) -> 1 or 0
//     For tests: a lossy WebP still image's decode, step by step
//     (codec.h's webp_lossy_planes; flags 1 the loop filter, 2 RGB, 4 the
//     fancy upsampler).
//   tsrio_jpeg2000_planes(data, n, out, cap, info) -> 1 or 0
//     For tests: a JPEG 2000 file's components as OpenJPEG's opj_decode
//     gives them, before either reader converts them (codec.h's
//     jpeg2000_planes).
//
// Resize matches cv2.INTER_LINEAR (half-pixel centers, clamped edges), or
// bit for bit PIL's Image.resize(..., BILINEAR) (resize_pil).

#include <zlib.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <new>
#include <string>
#include <thread>
#include <vector>

#include "codec.h"

namespace {

using tsrio::Image;

// The whole file, or its first `limit` bytes when limit > 0.
bool read_file(const char* path, std::vector<uint8_t>& buf, long limit = 0) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n <= 0) { std::fclose(f); return false; }
  if (limit > 0 && n > limit) n = limit;
  buf.resize(static_cast<size_t>(n));
  size_t got = std::fread(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  return got == buf.size();
}

// cv2.INTER_LINEAR-compatible bilinear resize (half-pixel centers).
// Separable two-pass: the horizontal interpolation of each needed source
// row is computed once into a float row cache, and the vertical pass is a
// contiguous lerp over size*3 floats the compiler auto-vectorizes — vs the
// naive per-output-pixel 4-gather loop this is ~4-6x on upscales (the
// pipeline's case: 26-104 px natives -> 224 model input).
void resize_bilinear(const Image& src, int size, uint8_t* dst) {
  const float sx = static_cast<float>(src.w) / size;
  const float sy = static_cast<float>(src.h) / size;
  const int row_elems = size * 3;

  // per-x source columns + weight (identical for every output row)
  std::vector<int> x0s(size), x1s(size);
  std::vector<float> wxs(size);
  for (int x = 0; x < size; x++) {
    float fx = (x + 0.5f) * sx - 0.5f;
    int x0 = static_cast<int>(std::floor(fx));
    wxs[x] = fx - x0;
    x0s[x] = x0 < 0 ? 0 : (x0 >= src.w ? src.w - 1 : x0);
    x1s[x] = x0 + 1 < 0 ? 0 : (x0 + 1 >= src.w ? src.w - 1 : x0 + 1);
  }

  // two-slot row cache: consecutive output rows share source rows
  float hrow[2 * 3 * 4096];  // supports size <= 4096
  std::vector<float> hrow_big;
  float* slots[2] = {hrow, hrow + row_elems};
  if (size > 4096) {
    hrow_big.resize(2 * static_cast<size_t>(row_elems));
    slots[0] = hrow_big.data();
    slots[1] = slots[0] + row_elems;
  }
  int slot_row[2] = {-1, -1};

  auto hpass = [&](int sy_row) -> const float* {
    for (int s = 0; s < 2; s++)
      if (slot_row[s] == sy_row) return slots[s];
    int s = slot_row[0] < slot_row[1] ? 0 : 1;  // evict the older row
    const uint8_t* r = src.rgb.data() + static_cast<size_t>(sy_row) *
                                            src.w * 3;
    float* o = slots[s];
    for (int x = 0; x < size; x++) {
      const uint8_t* p0 = r + x0s[x] * 3;
      const uint8_t* p1 = r + x1s[x] * 3;
      const float wx = wxs[x], iwx = 1.0f - wx;
      o[x * 3 + 0] = iwx * p0[0] + wx * p1[0];
      o[x * 3 + 1] = iwx * p0[1] + wx * p1[1];
      o[x * 3 + 2] = iwx * p0[2] + wx * p1[2];
    }
    slot_row[s] = sy_row;
    return o;
  };

  for (int y = 0; y < size; y++) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    const float wy = fy - y0, iwy = 1.0f - wy;
    int y0c = y0 < 0 ? 0 : (y0 >= src.h ? src.h - 1 : y0);
    int y1c = y0 + 1 < 0 ? 0 : (y0 + 1 >= src.h ? src.h - 1 : y0 + 1);
    const float* h0 = hpass(y0c);
    const float* h1 = y1c == y0c ? h0 : hpass(y1c);
    uint8_t* out = dst + static_cast<size_t>(y) * row_elems;
    for (int i = 0; i < row_elems; i++)
      out[i] = static_cast<uint8_t>(iwy * h0[i] + wy * h1[i] + 0.5f);
  }
}

// PIL's Image.resize(..., BILINEAR) on 8-bit RGB, bit for bit: the
// two-pass fixed-point resampler of Pillow's src/libImaging/Resample.c.
// Per axis, output i takes the input taps [xmin, xmin + n) around
// center = (i + 0.5) * scale with triangle weights widened by the scale on
// a downscale (antialiasing), normalised in double and rounded half away
// from zero to PRECISION_BITS of fixed point. The horizontal pass runs
// over the rows the vertical pass reads, into a temporary image; each pass
// accumulates in int32 from 1 << (PRECISION_BITS - 1) and clips
// acc >> PRECISION_BITS to [0, 255]. An axis of equal size is not
// resampled; a same-size resize is a copy.
constexpr int kPrecisionBits = 32 - 8 - 2;

struct PilCoeffs {
  int ksize = 0;
  std::vector<int> bounds;  // (xmin, n) per output
  std::vector<int32_t> k;   // [out, ksize]
};

PilCoeffs pil_coeffs(int in_size, int out_size) {
  PilCoeffs c;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;  // the bilinear filter's support
  c.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.bounds.resize(2 * static_cast<size_t>(out_size));
  c.k.assign(static_cast<size_t>(out_size) * c.ksize, 0);
  std::vector<double> w(c.ksize);
  const double ss = 1.0 / filterscale;
  for (int xx = 0; xx < out_size; xx++) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double ww = 0.0;
    for (int x = 0; x < xmax; x++) {
      double t = (x + xmin - center + 0.5) * ss;
      if (t < 0.0) t = -t;
      w[x] = t < 1.0 ? 1.0 - t : 0.0;
      ww += w[x];
    }
    int32_t* k = c.k.data() + static_cast<size_t>(xx) * c.ksize;
    for (int x = 0; x < xmax; x++) {
      const double v = ww != 0.0 ? w[x] / ww : w[x];
      k[x] = static_cast<int32_t>(v < 0 ? -0.5 + v * (1 << kPrecisionBits)
                                        : 0.5 + v * (1 << kPrecisionBits));
    }
    c.bounds[2 * xx] = xmin;
    c.bounds[2 * xx + 1] = xmax;
  }
  return c;
}

inline uint8_t pil_clip8(int32_t in) {
  if (in >= (1 << kPrecisionBits << 8)) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> kPrecisionBits);
}

void resize_pil(const Image& src, int size, uint8_t* dst) {
  const size_t row_out = static_cast<size_t>(size) * 3;
  if (src.w == size && src.h == size) {
    std::memcpy(dst, src.rgb.data(), row_out * size);
    return;
  }
  const PilCoeffs ch = pil_coeffs(src.w, size);
  PilCoeffs cv = pil_coeffs(src.h, size);
  // rows of the source the vertical pass reads
  const int y_first = cv.bounds[0];
  const int y_last = cv.bounds[2 * size - 2] + cv.bounds[2 * size - 1];
  const uint8_t* tmp = src.rgb.data();
  int tmp_w = src.w;
  std::vector<uint8_t> hbuf;
  if (src.w != size) {
    const int rows = y_last - y_first;
    hbuf.resize(static_cast<size_t>(rows) * row_out);
    for (int y = 0; y < rows; y++) {
      const uint8_t* in = src.rgb.data() +
                          static_cast<size_t>(y + y_first) * src.w * 3;
      uint8_t* out = hbuf.data() + static_cast<size_t>(y) * row_out;
      for (int xx = 0; xx < size; xx++) {
        const int xmin = ch.bounds[2 * xx], n = ch.bounds[2 * xx + 1];
        const int32_t* k = ch.k.data() + static_cast<size_t>(xx) * ch.ksize;
        int32_t s0 = 1 << (kPrecisionBits - 1), s1 = s0, s2 = s0;
        for (int x = 0; x < n; x++) {
          const uint8_t* p = in + (x + xmin) * 3;
          s0 += p[0] * k[x];
          s1 += p[1] * k[x];
          s2 += p[2] * k[x];
        }
        out[xx * 3 + 0] = pil_clip8(s0);
        out[xx * 3 + 1] = pil_clip8(s1);
        out[xx * 3 + 2] = pil_clip8(s2);
      }
    }
    for (int i = 0; i < size; i++) cv.bounds[2 * i] -= y_first;
    tmp = hbuf.data();
    tmp_w = size;
  }
  const size_t row_tmp = static_cast<size_t>(tmp_w) * 3;
  if (src.h == size) {  // no vertical pass: the horizontal one's rows
    std::memcpy(dst, tmp, row_out * size);
    return;
  }
  for (int yy = 0; yy < size; yy++) {
    const int ymin = cv.bounds[2 * yy], n = cv.bounds[2 * yy + 1];
    const int32_t* k = cv.k.data() + static_cast<size_t>(yy) * cv.ksize;
    uint8_t* out = dst + static_cast<size_t>(yy) * row_out;
    for (size_t i = 0; i < row_out; i++) {
      int32_t s = 1 << (kPrecisionBits - 1);
      for (int y = 0; y < n; y++) s += tmp[(y + ymin) * row_tmp + i] * k[y];
      out[i] = pil_clip8(s);
    }
  }
}

// --- PNG encode (8-bit RGB, color type 2, filter 0 scanlines) ---
void put_be32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back((x >> 24) & 0xff);
  v.push_back((x >> 16) & 0xff);
  v.push_back((x >> 8) & 0xff);
  v.push_back(x & 0xff);
}

void png_chunk(std::vector<uint8_t>& out, const char tag[4],
               const uint8_t* data, size_t n) {
  put_be32(out, static_cast<uint32_t>(n));
  size_t start = out.size();
  out.insert(out.end(), tag, tag + 4);
  if (n) out.insert(out.end(), data, data + n);
  uint32_t crc = static_cast<uint32_t>(
      crc32(0L, out.data() + start, static_cast<uInt>(4 + n)));
  put_be32(out, crc);
}

bool encode_png(const uint8_t* rgb, int w, int h,
                std::vector<uint8_t>& out) {
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  out.assign(sig, sig + 8);

  uint8_t ihdr[13];
  ihdr[0] = (w >> 24) & 0xff; ihdr[1] = (w >> 16) & 0xff;
  ihdr[2] = (w >> 8) & 0xff;  ihdr[3] = w & 0xff;
  ihdr[4] = (h >> 24) & 0xff; ihdr[5] = (h >> 16) & 0xff;
  ihdr[6] = (h >> 8) & 0xff;  ihdr[7] = h & 0xff;
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // truecolor RGB
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  png_chunk(out, "IHDR", ihdr, 13);

  // filter byte 0 per scanline
  const size_t row = static_cast<size_t>(w) * 3;
  std::vector<uint8_t> raw((row + 1) * h);
  for (int y = 0; y < h; y++) {
    raw[(row + 1) * y] = 0;
    std::memcpy(raw.data() + (row + 1) * y + 1, rgb + row * y, row);
  }
  // Z_RLE strategy: run-length-limited matches deflate ~3x faster than
  // the default strategy at level 1 with a few % larger files — the right
  // trade for a throughput-bound writer thread (PNG stays lossless by
  // construction regardless of strategy).
  uLongf clen = compressBound(static_cast<uLong>(raw.size()));
  std::vector<uint8_t> comp(clen);
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (deflateInit2(&zs, 1, Z_DEFLATED, 15, 8, Z_RLE) != Z_OK) return false;
  zs.next_in = raw.data();
  zs.avail_in = static_cast<uInt>(raw.size());
  zs.next_out = comp.data();
  zs.avail_out = static_cast<uInt>(clen);
  const int rc = deflate(&zs, Z_FINISH);
  clen = zs.total_out;
  deflateEnd(&zs);
  if (rc != Z_STREAM_END) return false;
  png_chunk(out, "IDAT", comp.data(), clen);
  png_chunk(out, "IEND", nullptr, 0);
  return true;
}

// --- PPM encode (P6, 8-bit; cv2.imwrite's header layout) ---
void encode_ppm(const uint8_t* rgb, int w, int h, std::vector<uint8_t>& out) {
  char header[64];
  const int n = std::snprintf(header, sizeof(header), "P6\n%d %d\n255\n", w, h);
  out.assign(header, header + n);
  out.insert(out.end(), rgb, rgb + static_cast<size_t>(w) * h * 3);
}

// --- BMP encode (cv2.imwrite's layout: BITMAPINFOHEADER, 24-bit BGR,
// bottom-up rows padded to 4 bytes, no palette) ---
void encode_bmp(const uint8_t* rgb, int w, int h, std::vector<uint8_t>& out) {
  const size_t row = static_cast<size_t>(w) * 3;
  const size_t stride = (row + 3) & ~static_cast<size_t>(3);
  const uint32_t size = static_cast<uint32_t>(54 + stride * h);
  out.assign(54, 0);
  auto put32 = [&](size_t o, uint32_t v) {
    for (int i = 0; i < 4; i++) out[o + i] = static_cast<uint8_t>(v >> (8 * i));
  };
  out[0] = 'B';
  out[1] = 'M';
  put32(2, size);
  put32(10, 54);
  put32(14, 40);
  put32(18, static_cast<uint32_t>(w));
  put32(22, static_cast<uint32_t>(h));
  out[26] = 1;   // planes
  out[28] = 24;  // bits per pixel; compression and the rest stay 0
  out.resize(size, 0);
  for (int y = 0; y < h; y++) {
    const uint8_t* in = rgb + row * (h - 1 - y);
    uint8_t* o = out.data() + 54 + stride * y;
    for (int x = 0; x < w; x++) {
      o[3 * x] = in[3 * x + 2];
      o[3 * x + 1] = in[3 * x + 1];
      o[3 * x + 2] = in[3 * x];
    }
  }
}

bool write_one(const char* path, const uint8_t* rgb, int w, int h, int format) {
  // cv2 writes no empty image, and JPEG holds sides up to 65535
  if (w <= 0 || h <= 0 || (format == 2 && (w > 65535 || h > 65535)))
    return false;
  std::vector<uint8_t> out;
  switch (format) {
    case 0:
      if (!encode_png(rgb, w, h, out)) return false;
      break;
    case 1: encode_ppm(rgb, w, h, out); break;
    case 2: tsrio::encode_jpeg(rgb, w, h, out); break;
    case 3: encode_bmp(rgb, w, h, out); break;
    default: return false;
  }
  FILE* f = std::fopen(path, "wb");
  if (!f) return false;
  size_t put = std::fwrite(out.data(), 1, out.size(), f);
  std::fclose(f);
  return put == out.size();
}

uint32_t be32(const uint8_t* p) {
  return (static_cast<uint32_t>(p[0]) << 24) | (static_cast<uint32_t>(p[1]) << 16) |
         (static_cast<uint32_t>(p[2]) << 8) | p[3];
}

// The signature and the chunks before the first IDAT of an open PNG, the
// data of each read only for IHDR and eXIf (the rest skipped): what its
// header probe needs, however far an eXIf lies into the file.
std::vector<uint8_t> png_head(FILE* f) {
  std::vector<uint8_t> head(8);
  if (std::fseek(f, 0, SEEK_SET) != 0 ||
      std::fread(head.data(), 1, 8, f) != 8)
    return {};
  uint8_t hdr[8];
  while (std::fread(hdr, 1, 8, f) == 8) {
    const uint32_t len = be32(hdr);
    if (!std::memcmp(hdr + 4, "IDAT", 4) || !std::memcmp(hdr + 4, "IEND", 4))
      break;
    if (std::memcmp(hdr + 4, "IHDR", 4) && std::memcmp(hdr + 4, "eXIf", 4)) {
      if (len > (1u << 31) || std::fseek(f, len + 4, SEEK_CUR) != 0) break;
      continue;
    }
    if (len > (1u << 24)) break;
    const size_t at = head.size();
    head.resize(at + 12 + len);
    std::memcpy(&head[at], hdr, 8);
    if (std::fread(&head[at + 8], 1, len + 4, f) != len + 4) {
      head.resize(at);
      break;
    }
  }
  return head;
}

// 1 (kOk) on success, else a Status: kUnreadable (an allocation that fails
// too), kRaises (cv2.imread raises: no fallback to PIL), the unimplemented
// JPEG feature the file uses, or the format it holds that the port does
// not decode. The reference's reader: cv2.imread, else PIL.
int decode_file(const char* path, Image& img) {
  try {  // an allocation that fails must not unwind into ctypes
    std::vector<uint8_t> buf;
    if (!read_file(path, buf)) return tsrio::kUnreadable;
    const uint8_t* d = buf.data();
    const size_t n = buf.size();
    if (tsrio::is_jpeg(d, n)) return tsrio::decode_jpeg(d, n, img);
    // kOk, kRaises, or a layout cv2 reads and the port does not decode
    const int cv2 = tsrio::read_cv2(d, n, &img, nullptr, false);
    if (cv2 != tsrio::kUnreadable) return cv2;
    const int pil = tsrio::read_pil(d, n, &img, nullptr, false);
    if (pil != tsrio::kUnreadable) return pil;
    return tsrio::foreign_format(d, n);
  } catch (const std::exception&) {
    return tsrio::kUnreadable;
  }
}

// (h, w) as the file decodes. By header: a JPEG's markers up to its first
// scan (however long its APP segments), PNG's IHDR and any eXIf before
// IDAT, a TIFF's IFD or a WebP's chunks wherever they lie, a JPEG 2000
// file's ihdr and SIZ (the whole file where they lie past the first 64
// KiB), or the PNM/PAM/BMP header as cv2 parses it (else as PIL does).
// With cv2_reader, from the whole file as cv2.imread reads it, short of
// the pixels (check_jpeg, read_cv2). A failure writes (0, its Status).
int probe_one(const char* path, int* dims, bool cv2_reader) {
  dims[0] = 0;
  dims[1] = tsrio::kUnreadable;
  FILE* f = std::fopen(path, "rb");
  if (!f) return tsrio::kUnreadable;
  std::vector<uint8_t> buf(65536);
  buf.resize(std::fread(buf.data(), 1, buf.size(), f));
  int st = tsrio::kUnreadable, h = 0, w = 0;
  int hw[2] = {0, 0};
  if (tsrio::is_jpeg(buf.data(), buf.size())) {
    if (cv2_reader) {
      std::vector<uint8_t> whole;
      st = read_file(path, whole)
               ? tsrio::check_jpeg(whole.data(), whole.size(), hw)
               : tsrio::kUnreadable;
    } else {
      st = tsrio::probe_jpeg(f, hw);
    }
  } else if (cv2_reader) {
    std::vector<uint8_t> whole;
    if (read_file(path, whole)) {
      st = tsrio::read_cv2(whole.data(), whole.size(), nullptr, hw, false);
      if (st == tsrio::kUnreadable)
        st = tsrio::foreign_format(whole.data(), whole.size());
    }
  } else if (tsrio::is_tiff_data(buf.data(), buf.size())) {
    st = tsrio::probe_tiff(f, hw);  // its IFD may lie anywhere
  } else if (tsrio::is_webp_data(buf.data(), buf.size()) &&
             (st = tsrio::probe_webp(f, hw)) != tsrio::kUnreadable) {
    // its EXIF chunk (cv2's orientation) may follow the image data
  } else {
    static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
    const bool png = buf.size() >= 8 && !std::memcmp(buf.data(), sig, 8);
    std::vector<uint8_t> head = png ? png_head(f) : buf;
    st = tsrio::read_cv2(head.data(), head.size(), nullptr, hw, true);
    if (st == tsrio::kUnreadable)
      st = tsrio::read_pil(head.data(), head.size(), nullptr, hw, true);
    if (st == tsrio::kUnreadable && buf.size() == 65536 &&
        tsrio::is_jpeg2000_data(buf.data(), buf.size()) &&
        read_file(path, head)) {
      // JP2 boxes or a main header that run past the first 64 KiB
      st = tsrio::read_cv2(head.data(), head.size(), nullptr, hw, true);
      if (st == tsrio::kUnreadable)
        st = tsrio::read_pil(head.data(), head.size(), nullptr, hw, true);
    }
    if (st == tsrio::kUnreadable)
      st = tsrio::foreign_format(buf.data(), buf.size());
  }
  h = hw[0];
  w = hw[1];
  std::fclose(f);
  if (st != tsrio::kOk) {
    dims[1] = st;
    return st;
  }
  if (w <= 0 || h <= 0) return tsrio::kUnreadable;
  dims[0] = h;
  dims[1] = w;
  return tsrio::kOk;
}

// Reflect-101 source index of j >= 0 on a side of n: periodic with period
// 2(n-1), the reflection tiled; a side of 1 repeats its one pixel.
inline int reflect101_index(int j, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  const int m = j % period;
  return m < n ? m : period - m;
}

// One image into its [ch, cw, 3] canvas slot at the top-left, the rest
// zeros or (reflect) its reflect-101 continuation; an image with a side
// >= resize_to > 0 is resized to resize_to x resize_to, the whole slot.
bool load_canvas_one(const char* path, int ch, int cw, int resize_to,
                     int reflect, uint8_t* slot, int* dims) {
  Image img;
  const int st = decode_file(path, img);
  if (st != tsrio::kOk) {
    dims[0] = 0;
    dims[1] = st;
    return false;
  }
  if (resize_to > 0 && (img.h >= resize_to || img.w >= resize_to)) {
    if (ch != resize_to || cw != resize_to) return false;
    resize_bilinear(img, resize_to, slot);
    dims[0] = dims[1] = resize_to;
    return true;
  }
  if (img.h > ch || img.w > cw) return false;
  const size_t row = static_cast<size_t>(cw) * 3;
  const size_t irow = static_cast<size_t>(img.w) * 3;
  for (int y = 0; y < ch; y++) {
    uint8_t* o = slot + row * y;
    if (y >= img.h && !reflect) {
      std::memset(o, 0, row);
      continue;
    }
    const uint8_t* src = img.rgb.data() + irow * reflect101_index(y, img.h);
    std::memcpy(o, src, irow);
    if (!reflect) {
      std::memset(o + irow, 0, row - irow);
      continue;
    }
    for (int x = img.w; x < cw; x++)
      std::memcpy(o + 3 * x, src + 3 * reflect101_index(x, img.w), 3);
  }
  dims[0] = img.h;
  dims[1] = img.w;
  return true;
}

std::vector<std::string> split_paths(const char* joined, int n) {
  std::vector<std::string> paths;
  paths.reserve(n);
  const char* p = joined;
  for (int i = 0; i < n; i++) {
    const char* nl = std::strchr(p, '\n');
    if (!nl) {
      paths.emplace_back(p);
      break;
    }
    paths.emplace_back(p, nl - p);
    p = nl + 1;
  }
  return paths;
}

// Runs ok_i = fn(i) for i < n on up to `threads` threads; returns how many
// returned true.
template <typename Fn>
int parallel_count(int n, int threads, Fn fn) {
  std::atomic<int> next(0), ok(0);
  auto work = [&]() {
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      if (fn(i)) ok.fetch_add(1);
    }
  };
  if (threads <= 1 || n <= 1) {
    work();
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < threads && t < n; t++) pool.emplace_back(work);
    for (auto& th : pool) th.join();
  }
  return ok.load();
}

}  // namespace

extern "C" {

// Decode + resize n images into out[n, size, size, 3], mode 0 as
// cv2.INTER_LINEAR, mode 1 as PIL's BILINEAR; a failed slot is zeroed.
// Returns the number of successfully loaded images.
int tsrio_load_batch(const char* joined_paths, int n, int size,
                     uint8_t* out, int threads, int mode) {
  const auto paths = split_paths(joined_paths, n);
  const size_t per = static_cast<size_t>(size) * size * 3;
  return parallel_count(static_cast<int>(paths.size()), threads, [&](int i) {
    Image img;
    if (decode_file(paths[i].c_str(), img) == tsrio::kOk) {
      if (mode == 1)
        resize_pil(img, size, out + per * i);
      else
        resize_bilinear(img, size, out + per * i);
      return true;
    }
    std::memset(out + per * i, 0, per);
    return false;
  });
}

// (h, w) of n images from their headers (reader 1: a JPEG as cv2.imread
// decodes it) into dims[n, 2]. Returns the number of files probed.
int tsrio_probe(const char* joined_paths, int n, int* dims, int threads,
                int reader) {
  const auto paths = split_paths(joined_paths, n);
  return parallel_count(static_cast<int>(paths.size()), threads, [&](int i) {
    try {
      return probe_one(paths[i].c_str(), dims + 2 * i, reader == 1) ==
             tsrio::kOk;
    } catch (const std::exception&) {
      return false;
    }
  });
}

// n images at native size into out[n, ch, cw, 3], each at the top-left of
// its slot (see load_canvas_one), their (h, w) into dims[n, 2]. Returns the
// number of images loaded.
int tsrio_load_canvas(const char* joined_paths, int n, int ch, int cw,
                      int resize_to, int reflect, uint8_t* out, int* dims,
                      int threads) {
  const auto paths = split_paths(joined_paths, n);
  const size_t per = static_cast<size_t>(ch) * cw * 3;
  return parallel_count(static_cast<int>(paths.size()), threads, [&](int i) {
    return load_canvas_one(paths[i].c_str(), ch, cw, resize_to, reflect,
                           out + per * i, dims + 2 * i);
  });
}

// Threaded encode+write of n uint8 RGB images: image i has dims[2i] rows
// and dims[2i+1] columns at data[i]; format 0 PNG, 1 PPM.
// Returns the number of images successfully written.
int tsrio_write_batch(const char* joined_paths, int n, const int* dims,
                      const uint8_t* const* data, int format, int threads) {
  const auto paths = split_paths(joined_paths, n);
  return parallel_count(static_cast<int>(paths.size()), threads, [&](int i) {
    try {
      return write_one(paths[i].c_str(), data[i], dims[2 * i + 1],
                       dims[2 * i], format);
    } catch (const std::exception&) {
      return false;
    }
  });
}

// Decode a single image without resize; returns 1 on success, writes (w,
// h) to dims and hands over the decoded image: *handle (free it with
// tsrio_release) holding w * h * 3 bytes at *pixels; else the Status of
// the failure and a null handle.
int tsrio_decode(const char* path, int* dims, void** handle,
                 const uint8_t** pixels) {
  *handle = nullptr;
  *pixels = nullptr;
  Image* img = new (std::nothrow) Image;
  if (!img) return tsrio::kUnreadable;
  const int st = decode_file(path, *img);
  if (st != tsrio::kOk) {
    delete img;
    return st;
  }
  dims[0] = img->w;
  dims[1] = img->h;
  *handle = img;
  *pixels = img->rgb.data();
  return 1;
}

// Frees an image tsrio_decode handed over.
void tsrio_release(void* handle) { delete static_cast<Image*>(handle); }

// A lossy WebP still image's planes or RGB (codec.h's webp_lossy_planes)
// into out (cap bytes), its (h, w) into dims; 1 on success, else 0.
int tsrio_webp_lossy_planes(const uint8_t* data, size_t n, int flags,
                            uint8_t* out, size_t cap, int* dims) {
  try {
    return tsrio::webp_lossy_planes(data, n, flags & 1, flags & 2, flags & 4,
                                    out, cap, dims);
  } catch (const std::exception&) {
    return 0;
  }
}

// A JPEG 2000 file's components (codec.h's jpeg2000_planes) into out
// (cap int32 values), (components, h, w, x0, y0) into info; 1 on success.
int tsrio_jpeg2000_planes(const uint8_t* data, size_t n, int32_t* out,
                          size_t cap, int* info) {
  try {
    return tsrio::jpeg2000_planes(data, n, out, cap, info);
  } catch (const std::exception&) {
    return 0;
  }
}

}  // extern "C"
