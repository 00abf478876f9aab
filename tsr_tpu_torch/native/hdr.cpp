// hdr.cpp — Radiance RGBE (.hdr) read as the reference reads it: cv2.imread
// (OpenCV 5's HdrDecoder over its rgbe.cpp). PIL reads no Radiance HDR, so
// a file cv2 refuses is refused.
//
//   - the header, read with fgets into 128 bytes (a longer line reads as
//     several): the signature's line is skipped; then, up to a line that
//     starts with a line feed, a line that starts with '#' is a comment,
//     one line must be exactly "FORMAT=32-bit_rle_rgbe\n", and any other
//     (EXPOSURE=, GAMMA=, a line of a NUL) is ignored, so changes no pixel;
//     the next line must scan as "-Y %d +X %d" with both sides > 0 (rows
//     top to bottom, left to right: any other orientation is refused);
//   - the pixels, from the byte after that line: flat RGBE where the width
//     is under 8 or past 32767, else each scanline new-style run-length
//     encoded (2, 2, the width's high and low bytes, then each of the four
//     channels in pieces: a count past 128 repeats the next byte count - 128
//     times, any other count is followed by that many literal bytes; a count
//     of 0 or one past the channel's end, or a scanline width other than the
//     header's, refuses the file); a scanline that does not start as RLE
//     (bytes other than 2, 2, or bit 7 set in the third) is the first pixel
//     of a flat rest of the image; a file cut anywhere is refused, bytes
//     after the last pixel are ignored;
//   - rgbe2float (each of R, G, B times (float)ldexp(1, e - 136), 0 where e
//     is 0) in OpenCV's BGR order, then convertTo's x 255 and cvRound to 8
//     bits (half to even; NaN, infinities and values past the int range
//     read 0).
// Each runs on a whole file in memory; without an output image it checks
// the file and gives its (h, w), short of storing pixels.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "codec.h"

namespace tsrio {
namespace {

// A FILE* over the bytes: fgets and fread.
struct File {
  const uint8_t* d;
  size_t n, pos;
  // fgets(buf, 128, fp): false at the end of the file with nothing read;
  // `line` is the C string read (up to a NUL).
  bool gets(std::string& line) {
    if (pos >= n) return false;
    const size_t start = pos;
    while (pos - start < 127 && pos < n)
      if (d[pos++] == '\n') break;
    const char* p = reinterpret_cast<const char*>(d + start);
    line.assign(p, strnlen(p, pos - start));
    return true;
  }
  // fread(p, k, 1, fp) == 1
  const uint8_t* read(size_t k) {
    if (n - pos < k) {
      pos = n;
      return nullptr;
    }
    pos += k;
    return d + pos - k;
  }
};

// RGBE_ReadHeader(fp, &w, &h, NULL), then HdrDecoder::readHeader's sides
bool read_header(File& f, int& w, int& h) {
  std::string line;
  if (!f.gets(line)) return false;
  bool format = false;
  while (true) {
    if (!f.gets(line)) return false;  // "RGBE read error"
    if (!line.empty() && line[0] == '\n') break;
    if (!line.empty() && line[0] == '#') continue;
    if (line == "FORMAT=32-bit_rle_rgbe\n") format = true;
  }
  if (!format || !f.gets(line)) return false;  // "missing FORMAT specifier"
  if (std::sscanf(line.c_str(), "-Y %d +X %d", &h, &w) < 2) return false;
  return w > 0 && h > 0;
}

// Pixel `p` of the raster from its R, G, B and exponent bytes.
inline void put(Image* img, size_t p, uint8_t r, uint8_t g, uint8_t b,
                uint8_t e) {
  if (!img) return;
  uint8_t* o = img->rgb.data() + p * 3;
  if (!e) {
    o[0] = o[1] = o[2] = 0;
    return;
  }
  const float f = static_cast<float>(std::ldexp(1.0, e - 136));
  o[0] = cv2_u8(r * f * 255.0f);
  o[1] = cv2_u8(g * f * 255.0f);
  o[2] = cv2_u8(b * f * 255.0f);
}

// RGBE_ReadPixels: `count` flat pixels from pixel `p` on
bool read_flat(File& f, Image* img, size_t p, size_t count) {
  for (; count > 0; count--, p++) {
    const uint8_t* q = f.read(4);
    if (!q) return false;
    put(img, p, q[0], q[1], q[2], q[3]);
  }
  return true;
}

}  // namespace

bool is_hdr_data(const uint8_t* d, size_t n) {
  return (n >= 6 && !std::memcmp(d, "#?RGBE", 6)) ||
         (n >= 10 && !std::memcmp(d, "#?RADIANCE", 10));
}

int hdr_cv2(const uint8_t* d, size_t n, Image* img, int* dims, bool head) {
  File f{d, n, 0};
  int w = 0, h = 0;
  if (!is_hdr_data(d, n) || !read_header(f, w, h)) return kUnreadable;
  if (!cv2_size_ok(w, h)) return kRaises;
  dims[0] = h;
  dims[1] = w;
  if (head) return kOk;
  if (img) {
    img->w = w;
    img->h = h;
    img->rgb.assign(static_cast<size_t>(w) * h * 3, 0);
  }
  // RGBE_ReadPixels_RLE
  if (w < 8 || w > 0x7fff)
    return read_flat(f, img, 0, static_cast<size_t>(w) * h) ? kOk
                                                            : kUnreadable;
  std::vector<uint8_t> line(static_cast<size_t>(w) * 4);
  size_t p = 0;
  for (int left = h; left > 0; left--) {
    const uint8_t* q = f.read(4);
    if (!q) return kUnreadable;
    if (q[0] != 2 || q[1] != 2 || (q[2] & 0x80)) {  // not run-length coded
      put(img, p, q[0], q[1], q[2], q[3]);
      return read_flat(f, img, p + 1, static_cast<size_t>(w) * left - 1)
                 ? kOk : kUnreadable;
    }
    if (((q[2] << 8) | q[3]) != w)
      return kUnreadable;  // "wrong scanline width"
    for (int c = 0; c < 4; c++) {
      size_t at = static_cast<size_t>(c) * w;
      const size_t end = at + w;
      while (at < end) {
        const uint8_t* b = f.read(2);
        if (!b) return kUnreadable;
        const size_t count = b[0] > 128 ? b[0] - 128 : b[0];
        if (count == 0 || count > end - at)
          return kUnreadable;  // "bad scanline data"
        if (b[0] > 128) {
          std::memset(&line[at], b[1], count);
        } else {
          line[at] = b[1];
          if (count > 1) {
            const uint8_t* lit = f.read(count - 1);
            if (!lit) return kUnreadable;
            std::memcpy(&line[at + 1], lit, count - 1);
          }
        }
        at += count;
      }
    }
    for (int x = 0; x < w; x++, p++)
      put(img, p, line[x], line[x + w], line[x + 2 * w], line[x + 3 * w]);
  }
  return kOk;
}

}  // namespace tsrio
