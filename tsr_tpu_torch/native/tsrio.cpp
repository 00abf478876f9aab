// tsrio — the port's image IO: PNG/PPM(P6)/BMP decode, bilinear resize,
// threaded batch assembly, and threaded PNG/PPM encode + write.
//
// The port's own copy of tsr_tpu/native/tsrio.cpp, with a writer that
// takes images of different sizes and writes PPM as well as PNG. It is
// the port's only codec: no module of the port imports cv2 or PIL. GTSRB
// ships as P6 .ppm files, which need no external codec; the distorted and
// restored trees are .png (ref:16:55 writes compound trees with
// cv2.imwrite, and every restored-tree consumer re-reads PNGs,
// ref:09:15-26), decoded here with zlib inflate + scanline unfilter
// (8-bit depth, color types 0/2/3/4/6, non-interlaced: everything cv2/PIL
// write in this pipeline).
//
// Exposed C ABI (used via ctypes from tsr_tpu_torch.native):
//   tsrio_load_batch(paths, n, size, out, threads) -> images loaded
//     paths: '\n'-joined file paths; out: uint8[n, size, size, 3]
//     Failed decodes leave their slot zeroed and are counted out.
//   tsrio_decode(path, out, cap, dims) -> 1 on success
//   tsrio_probe(paths, n, dims, threads) -> files probed
//     (h, w) of each image from its header alone, into dims[n, 2].
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
//     and dims[2i+1] columns at data[i]; format 0 is PNG (8-bit RGB, zlib
//     level 1, filter 0), format 1 is PPM (P6). Both are lossless, so
//     pixel parity with cv2's encoder is exact by construction.
//
// Resize matches cv2.INTER_LINEAR (half-pixel centers, clamped edges).

#include <zlib.h>

#include <atomic>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int w = 0, h = 0;
  std::vector<uint8_t> rgb;  // HWC
};

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

// --- PPM (P6, 8-bit) ---
// Parses "P6 <w> <h> <maxval>" (comments allowed) and leaves `pos` at the
// first pixel byte.
bool ppm_header(const std::vector<uint8_t>& buf, int& w, int& h, size_t& pos) {
  if (buf.size() < 10 || buf[0] != 'P' || buf[1] != '6') return false;
  pos = 2;
  auto next_int = [&](int& out) -> bool {
    // skip whitespace + comments
    while (pos < buf.size()) {
      if (std::isspace(buf[pos])) { pos++; continue; }
      if (buf[pos] == '#') {
        while (pos < buf.size() && buf[pos] != '\n') pos++;
        continue;
      }
      break;
    }
    if (pos >= buf.size() || !std::isdigit(buf[pos])) return false;
    long v = 0;
    while (pos < buf.size() && std::isdigit(buf[pos])) {
      v = v * 10 + (buf[pos] - '0');
      pos++;
    }
    out = static_cast<int>(v);
    return true;
  };
  int maxv;
  if (!next_int(w) || !next_int(h) || !next_int(maxv)) return false;
  if (maxv != 255 || w <= 0 || h <= 0) return false;
  pos++;  // single whitespace after maxval
  return true;
}

bool decode_ppm(const std::vector<uint8_t>& buf, Image& img) {
  int w, h;
  size_t pos;
  if (!ppm_header(buf, w, h, pos)) return false;
  size_t need = static_cast<size_t>(w) * h * 3;
  if (pos > buf.size() || buf.size() - pos < need) return false;
  img.w = w;
  img.h = h;
  img.rgb.assign(buf.begin() + pos, buf.begin() + pos + need);
  return true;
}

// --- BMP (24/32-bit uncompressed, bottom-up or top-down) ---
bool decode_bmp(const std::vector<uint8_t>& buf, Image& img) {
  if (buf.size() < 54 || buf[0] != 'B' || buf[1] != 'M') return false;
  auto rd32 = [&](size_t o) {
    return static_cast<int32_t>(buf[o] | (buf[o + 1] << 8) |
                                (buf[o + 2] << 16) | (buf[o + 3] << 24));
  };
  auto rd16 = [&](size_t o) { return buf[o] | (buf[o + 1] << 8); };
  int32_t data_off = rd32(10);
  int32_t w = rd32(18), h_raw = rd32(22);
  int bpp = rd16(28);
  int32_t comp = rd32(30);
  // h_raw == 0 would pass the buffer-size check with an empty pixel
  // buffer and send h=0 into resize_bilinear (reads at src.h-1 == -1);
  // INT32_MIN can't be negated. Reject both along with bad offsets.
  if (comp != 0 || (bpp != 24 && bpp != 32) || w <= 0 || h_raw == 0 ||
      h_raw == INT32_MIN || data_off < 54)
    return false;
  bool bottom_up = h_raw > 0;
  int h = bottom_up ? h_raw : -h_raw;
  int stride = ((w * (bpp / 8)) + 3) & ~3;
  if (buf.size() < static_cast<size_t>(data_off) +
                       static_cast<size_t>(stride) * h)
    return false;
  img.w = w;
  img.h = h;
  img.rgb.resize(static_cast<size_t>(w) * h * 3);
  for (int y = 0; y < h; y++) {
    int sy = bottom_up ? (h - 1 - y) : y;
    const uint8_t* row = buf.data() + data_off + sy * stride;
    uint8_t* out = img.rgb.data() + static_cast<size_t>(y) * w * 3;
    for (int x = 0; x < w; x++) {
      const uint8_t* px = row + x * (bpp / 8);
      out[x * 3 + 0] = px[2];  // BGR -> RGB
      out[x * 3 + 1] = px[1];
      out[x * 3 + 2] = px[0];
    }
  }
  return true;
}

// --- PNG (8-bit depth, color types 0/2/3/4/6, interlace 0) ---
// zlib-inflate the IDAT stream, reverse the per-scanline filters (spec
// 4.5.2: None/Sub/Up/Average/Paeth), expand to RGB. This covers every PNG
// cv2.imwrite/PIL produce for this pipeline; 16-bit depth, interlacing and
// sub-byte palettes fail, and the caller raises.
bool decode_png(const std::vector<uint8_t>& buf, Image& img) {
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (buf.size() < 57 || std::memcmp(buf.data(), sig, 8) != 0) return false;
  auto rd32 = [&](size_t o) {
    return (static_cast<uint32_t>(buf[o]) << 24) |
           (static_cast<uint32_t>(buf[o + 1]) << 16) |
           (static_cast<uint32_t>(buf[o + 2]) << 8) | buf[o + 3];
  };
  int w = 0, h = 0, depth = 0, ctype = 0;
  std::vector<uint8_t> idat, plte;
  bool have_ihdr = false;
  size_t pos = 8;
  while (pos + 12 <= buf.size()) {
    uint32_t len = rd32(pos);
    if (len > buf.size() || pos + 12 + len > buf.size()) return false;
    const uint8_t* tag = buf.data() + pos + 4;
    const uint8_t* data = buf.data() + pos + 8;
    if (!std::memcmp(tag, "IHDR", 4)) {
      if (len != 13) return false;
      w = static_cast<int>(rd32(pos + 8));
      h = static_cast<int>(rd32(pos + 12));
      depth = data[8];
      ctype = data[9];
      if (data[10] != 0 || data[11] != 0 || data[12] != 0)
        return false;  // non-default compression/filter or interlaced
      have_ihdr = true;
    } else if (!std::memcmp(tag, "PLTE", 4)) {
      plte.assign(data, data + len);
    } else if (!std::memcmp(tag, "IDAT", 4)) {
      idat.insert(idat.end(), data, data + len);
    } else if (!std::memcmp(tag, "IEND", 4)) {
      break;
    }
    pos += 12 + len;
  }
  if (!have_ihdr || w <= 0 || h <= 0 || depth != 8 || idat.empty())
    return false;
  if (static_cast<int64_t>(w) * h > (64LL << 20)) return false;
  int ch;
  switch (ctype) {
    case 0: ch = 1; break;  // gray
    case 2: ch = 3; break;  // RGB
    case 3: ch = 1; break;  // palette index
    case 4: ch = 2; break;  // gray+alpha
    case 6: ch = 4; break;  // RGBA
    default: return false;
  }
  if (ctype == 3 && plte.size() < 3) return false;

  const size_t stride = static_cast<size_t>(w) * ch;
  std::vector<uint8_t> raw((stride + 1) * h);
  uLongf rawlen = static_cast<uLongf>(raw.size());
  if (uncompress(raw.data(), &rawlen, idat.data(),
                 static_cast<uLong>(idat.size())) != Z_OK ||
      rawlen != raw.size())
    return false;

  std::vector<uint8_t> pix(stride * h);
  const std::vector<uint8_t> zero_row(stride, 0);
  const size_t uch = static_cast<size_t>(ch);
  for (int y = 0; y < h; y++) {
    const uint8_t f = raw[(stride + 1) * y];
    if (f > 4) return false;
    const uint8_t* src = raw.data() + (stride + 1) * y + 1;
    uint8_t* cur = pix.data() + stride * y;
    const uint8_t* up = y ? pix.data() + stride * (y - 1) : zero_row.data();
    switch (f) {  // one filter per scanline: specialize the hot loops
      case 0:
        std::memcpy(cur, src, stride);
        break;
      case 1:  // Sub
        for (size_t x = 0; x < uch && x < stride; x++) cur[x] = src[x];
        for (size_t x = uch; x < stride; x++)
          cur[x] = static_cast<uint8_t>(src[x] + cur[x - uch]);
        break;
      case 2:  // Up
        for (size_t x = 0; x < stride; x++)
          cur[x] = static_cast<uint8_t>(src[x] + up[x]);
        break;
      case 3:  // Average
        for (size_t x = 0; x < uch && x < stride; x++)
          cur[x] = static_cast<uint8_t>(src[x] + (up[x] >> 1));
        for (size_t x = uch; x < stride; x++)
          cur[x] = static_cast<uint8_t>(src[x] +
                                        ((cur[x - uch] + up[x]) >> 1));
        break;
      case 4:  // Paeth
        for (size_t x = 0; x < uch && x < stride; x++)
          cur[x] = static_cast<uint8_t>(src[x] + up[x]);  // a=c=0 -> b
        for (size_t x = uch; x < stride; x++) {
          const int a = cur[x - uch], b = up[x], c = up[x - uch];
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          cur[x] = static_cast<uint8_t>(
              src[x] + ((pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c)));
        }
        break;
    }
  }

  img.w = w;
  img.h = h;
  img.rgb.resize(static_cast<size_t>(w) * h * 3);
  const size_t n = static_cast<size_t>(w) * h;
  switch (ctype) {
    case 0:
      for (size_t i = 0; i < n; i++)
        img.rgb[i * 3] = img.rgb[i * 3 + 1] = img.rgb[i * 3 + 2] = pix[i];
      break;
    case 2:
      img.rgb.assign(pix.begin(), pix.end());
      break;
    case 3: {
      const size_t ncolors = plte.size() / 3;
      for (size_t i = 0; i < n; i++) {
        const size_t idx = pix[i] < ncolors ? pix[i] : 0;
        std::memcpy(&img.rgb[i * 3], &plte[idx * 3], 3);
      }
      break;
    }
    case 4:
      for (size_t i = 0; i < n; i++)
        img.rgb[i * 3] = img.rgb[i * 3 + 1] = img.rgb[i * 3 + 2] =
            pix[i * 2];
      break;
    case 6:
      for (size_t i = 0; i < n; i++)
        std::memcpy(&img.rgb[i * 3], &pix[i * 4], 3);
      break;
  }
  return true;
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

bool write_one(const char* path, const uint8_t* rgb, int w, int h, int format) {
  std::vector<uint8_t> out;
  if (format == 0) {
    if (!encode_png(rgb, w, h, out)) return false;
  } else if (format == 1) {
    encode_ppm(rgb, w, h, out);
  } else {
    return false;
  }
  FILE* f = std::fopen(path, "wb");
  if (!f) return false;
  size_t put = std::fwrite(out.data(), 1, out.size(), f);
  std::fclose(f);
  return put == out.size();
}

bool decode_file(const char* path, Image& img) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return false;
  return decode_png(buf, img) || decode_ppm(buf, img) || decode_bmp(buf, img);
}

// (h, w) from the file's header alone: PNG's IHDR (the first chunk), the
// PPM header, or the BMP info header.
bool probe_one(const char* path, int* dims) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf, 4096)) return false;
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  int w = 0, h = 0;
  size_t pos;
  if (buf.size() >= 24 && std::memcmp(buf.data(), sig, 8) == 0 &&
      std::memcmp(buf.data() + 12, "IHDR", 4) == 0) {
    auto rd32 = [&](size_t o) {
      return static_cast<int>((static_cast<uint32_t>(buf[o]) << 24) |
                              (static_cast<uint32_t>(buf[o + 1]) << 16) |
                              (static_cast<uint32_t>(buf[o + 2]) << 8) |
                              buf[o + 3]);
    };
    w = rd32(16);
    h = rd32(20);
  } else if (!ppm_header(buf, w, h, pos)) {
    if (buf.size() < 26 || buf[0] != 'B' || buf[1] != 'M') return false;
    auto rd32 = [&](size_t o) {
      return static_cast<int32_t>(buf[o] | (buf[o + 1] << 8) |
                                  (buf[o + 2] << 16) | (buf[o + 3] << 24));
    };
    w = rd32(18);
    const int32_t hr = rd32(22);
    if (hr == INT32_MIN) return false;
    h = hr < 0 ? -hr : hr;
  }
  if (w <= 0 || h <= 0) return false;
  dims[0] = h;
  dims[1] = w;
  return true;
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
  if (!decode_file(path, img)) return false;
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

// Decode + resize n images into out[n, size, size, 3]; a failed slot is
// zeroed. Returns the number of successfully loaded images.
int tsrio_load_batch(const char* joined_paths, int n, int size,
                     uint8_t* out, int threads) {
  const auto paths = split_paths(joined_paths, n);
  const size_t per = static_cast<size_t>(size) * size * 3;
  return parallel_count(static_cast<int>(paths.size()), threads, [&](int i) {
    Image img;
    if (decode_file(paths[i].c_str(), img)) {
      resize_bilinear(img, size, out + per * i);
      return true;
    }
    std::memset(out + per * i, 0, per);
    return false;
  });
}

// (h, w) of n images from their headers into dims[n, 2]. Returns the
// number of files probed.
int tsrio_probe(const char* joined_paths, int n, int* dims, int threads) {
  const auto paths = split_paths(joined_paths, n);
  return parallel_count(static_cast<int>(paths.size()), threads, [&](int i) {
    return probe_one(paths[i].c_str(), dims + 2 * i);
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
    return write_one(paths[i].c_str(), data[i], dims[2 * i + 1], dims[2 * i],
                     format);
  });
}

// Decode a single image without resize; returns 1 on success and writes
// (w, h) to dims. Caller passes a buffer of cap bytes; fails if too small.
int tsrio_decode(const char* path, uint8_t* out, long cap, int* dims) {
  Image img;
  if (!decode_file(path, img)) return 0;
  long need = static_cast<long>(img.rgb.size());
  if (need > cap) return 0;
  std::memcpy(out, img.rgb.data(), img.rgb.size());
  dims[0] = img.w;
  dims[1] = img.h;
  return 1;
}

}  // extern "C"
