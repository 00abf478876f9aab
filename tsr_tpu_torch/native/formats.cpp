// formats.cpp — PNG, PNM (P1-P6), PFM, PAM (P7), BMP and Sun raster, read as
// the reference reads them: cv2.imread first, else PIL's
// Image.open(path).convert("RGB"). GIF's readers are in gif.cpp, Radiance
// HDR's in hdr.cpp.
//
// Two readers of each format, each a copy of what its library does:
//   - read_cv2: OpenCV 5's decoders (libpng 1.6 for PNG; OpenCV's own PxM,
//     PFM, PAM, BMP and Sun raster code), with the images they accept and the
//     pixels they give, quirks included: an ASCII PNM sample is rescaled to
//     8 bits and a binary one is not, a cut ASCII body or an RLE stream
//     that stops short of the last row refuses the file, a 16-bit BMP keeps
//     5 bits << 3, a 32-bit BI_BITFIELDS BMP takes its masks from a V3-V5
//     header only, a PNG with a bad CRC on IHDR, PLTE (palette images) or
//     IDAT, a damaged zlib stream, a missing or cut IEND refuses the file,
//     a Sun raster of type RT_BYTE_ENCODED or RT_FORMAT_RGB is refused, a
//     PFM is divided by its scale's magnitude and a gray one refused;
//   - read_pil: Pillow 12's plugins (PngImagePlugin with its zlib row
//     decoder, PpmImagePlugin, BmpImagePlugin, SunImagePlugin) and
//     convert("RGB"), for the files cv2 refuses: a PNG whose IDAT CRC is
//     wrong, a P2 without its last newline, a 16-bit BMP with a V2-V5
//     header (5-bit samples scaled by 255/31), a run-length encoded Sun
//     raster, a gray PFM ... PIL applies no EXIF orientation there.
// Each runs on a whole file in memory; without an output image it checks
// the file and gives its (h, w), short of storing pixels (the probe of
// generate_tree's skip rule).
//
// Where cv2 leaves pixels unwritten (a PAM of 2 or 4 samples a pixel:
// OpenCV converts the pixels of the row's first `width` samples and leaves
// the rest of its image uninitialised), they are 0 here.

#include <zlib.h>

#include <algorithm>
#include <cctype>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "codec.h"

namespace tsrio {
namespace {

inline bool c_space(int c) { return c == ' ' || (c >= 9 && c <= 13); }
inline bool c_digit(int c) { return c >= '0' && c <= '9'; }

uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
uint32_t le32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<uint32_t>(p[3]) << 24);
}
uint32_t be32(const uint8_t* p) {
  return (static_cast<uint32_t>(p[0]) << 24) | (p[1] << 16) | (p[2] << 8) | p[3];
}

// The output image, or nothing where only the check runs.
struct Out {
  Image* img = nullptr;
  int w = 0, h = 0;
  bool init(Image* im, int64_t w_, int64_t h_) {
    // both readers' size rules (cv2_size_ok, pil_size_ok) lie within this
    if (w_ <= 0 || h_ <= 0 || w_ * h_ > (int64_t{1} << 30)) return false;
    img = im;
    w = static_cast<int>(w_);
    h = static_cast<int>(h_);
    if (img) {
      img->w = w;
      img->h = h;
      img->rgb.assign(static_cast<size_t>(w) * h * 3, 0);
    }
    return true;
  }
  void put(int x, int y, uint8_t r, uint8_t g, uint8_t b) {
    if (!img) return;
    uint8_t* p = img->rgb.data() + (static_cast<size_t>(y) * w + x) * 3;
    p[0] = r;
    p[1] = g;
    p[2] = b;
  }
};

// OpenCV's RLByteStream over the file: reading past its end throws.
struct Eof {};
struct Stream {
  const uint8_t* d;
  size_t n, pos;
  int byte() {
    if (pos >= n) throw Eof();
    return d[pos++];
  }
  const uint8_t* bytes(size_t k) {
    if (pos > n || k > n - pos) throw Eof();
    const uint8_t* p = d + pos;
    pos += k;
    return p;
  }
  uint32_t word() {
    const uint8_t* p = bytes(2);
    return le16(p);
  }
};

// ------------------------------------------------------------------ PNM
// cv2: OpenCV's PxM decoder (signature 'P', '1'-'6', whitespace).

// OpenCV's ReadNumber: whitespace and '#' comments (to CR or LF) up to a
// digit, then up to maxdigits digits (0: all of them, and the byte after
// them is consumed); false on any other byte or past INT_MAX.
bool cv2_number(Stream& s, int maxdigits, int& out) {
  int c = s.byte();
  while (!c_digit(c)) {
    if (c == '#') {
      do c = s.byte(); while (c != '\n' && c != '\r');
      c = s.byte();
    } else if (c_space(c)) {
      while (c_space(c)) c = s.byte();
    } else {
      return false;
    }
  }
  int64_t v = 0;
  int digits = 0;
  do {
    v = v * 10 + (c - '0');
    if (v > INT_MAX) return false;
    if (maxdigits && ++digits >= maxdigits) break;
    c = s.byte();
  } while (c_digit(c));
  out = static_cast<int>(v);
  return true;
}

bool is_cv2_pnm(const uint8_t* d, size_t n) {
  return n >= 3 && d[0] == 'P' && d[1] >= '1' && d[1] <= '6' && c_space(d[2]);
}

struct PnmHead {
  int kind = 0, w = 0, h = 0, maxval = 0;
};

bool cv2_pnm_head(Stream& s, PnmHead& hd) {
  s.pos = 1;
  hd.kind = s.byte() - '0';
  if (!cv2_number(s, 0, hd.w) || !cv2_number(s, 0, hd.h)) return false;
  hd.maxval = 1;
  if (hd.kind != 1 && hd.kind != 4 && !cv2_number(s, 0, hd.maxval))
    return false;
  return hd.maxval <= 65535 && hd.w > 0 && hd.h > 0 && hd.maxval > 0;
}

int cv2_pnm(const uint8_t* d, size_t n, Image* img, int* dims, bool head) {
  Stream s{d, n, 0};
  PnmHead hd;
  if (!cv2_pnm_head(s, hd)) return kUnreadable;
  if (!cv2_size_ok(hd.w, hd.h)) return kRaises;
  dims[0] = hd.h;
  dims[1] = hd.w;
  if (head) return kOk;
  Out out;
  if (!out.init(img, hd.w, hd.h)) return kUnreadable;
  const int w = hd.w, h = hd.h;
  const bool ascii = hd.kind <= 3;
  if (hd.kind == 1 || hd.kind == 4) {  // bitmaps: 1 is black
    const size_t pitch = (static_cast<size_t>(w) + 7) / 8;
    for (int y = 0; y < h; y++) {
      const uint8_t* row = ascii ? nullptr : s.bytes(pitch);
      for (int x = 0; x < w; x++) {
        int bit;
        if (ascii) {
          if (!cv2_number(s, 1, bit)) return kUnreadable;
        } else {
          bit = (row[x >> 3] >> (7 - (x & 7))) & 1;
        }
        const uint8_t v = bit ? 0 : 255;
        out.put(x, y, v, v, v);
      }
    }
  } else {
    const int ch = hd.kind == 3 || hd.kind == 6 ? 3 : 1;
    const bool wide = hd.maxval > 255;  // 16-bit samples: the high byte
    uint8_t lut[256] = {};
    if (!wide)
      for (int i = 0; i <= hd.maxval; i++) lut[i] = i * 255 / hd.maxval;
    const size_t elems = static_cast<size_t>(w) * ch;
    std::vector<uint8_t> samples(elems);
    for (int y = 0; y < h; y++) {
      if (ascii) {  // rescaled to 8 bits (16-bit: the high byte)
        for (size_t i = 0; i < elems; i++) {
          int v;
          if (!cv2_number(s, 0, v)) return kUnreadable;
          if (static_cast<unsigned>(v) > static_cast<unsigned>(hd.maxval))
            v = hd.maxval;
          samples[i] = wide ? static_cast<uint8_t>(v >> 8) : lut[v];
        }
      } else {  // as stored
        const uint8_t* row = s.bytes(elems * (wide ? 2 : 1));
        for (size_t i = 0; i < elems; i++) samples[i] = row[wide ? 2 * i : i];
      }
      for (int x = 0; x < w; x++) {
        const uint8_t* p = &samples[static_cast<size_t>(x) * ch];
        out.put(x, y, p[0], p[ch == 3 ? 1 : 0], p[ch == 3 ? 2 : 0]);
      }
    }
  }
  return kOk;
}

// ------------------------------------------------------------------ PFM
// cv2: OpenCV's PFMDecoder (signature "PF" or "Pf", then whitespace). Its
// header is "P", "F" or "f", a line feed, then width, height and scale,
// each field the bytes up to one whitespace byte (that byte consumed, no
// other skipped; a byte past 127 refuses the file) read by atoi, atoi and
// atof. Rows are stored bottom to top, big endian where the scale is >= 0;
// the samples are multiplied by (float)(1.0 / |scale|) (a scale of 0 or NaN
// refuses the file after its body is read), then rounded to 8 bits as
// cv::saturate_cast<uchar>(float) rounds. Under IMREAD_COLOR a gray "Pf"
// file fails imread's check that readData wrote into its 3-channel image,
// so cv2 reads "PF" alone. A header that parses with a side <= 0 or past
// 2^20 makes imread raise (kRaises), not give None.

bool is_pfm(const uint8_t* d, size_t n) {
  return n >= 3 && d[0] == 'P' && (d[1] == 'F' || d[1] == 'f') && c_space(d[2]);
}

// read_number: at most 2048 bytes up to a whitespace byte; the field is
// the C string of the bytes before it (up to a NUL).
bool cv2_pfm_field(Stream& s, std::string& out) {
  out.clear();
  bool nul = false;
  for (int i = 0; i < 2048; i++) {
    const int c = s.byte();
    if (c >= 128) return false;  // CV_Assert(intc >= -128 && intc < 128)
    if (c_space(c)) break;
    nul = nul || c == 0;
    if (!nul) out += static_cast<char>(c);
  }
  return true;
}

inline float pfm_sample(const uint8_t* p, bool big) {
  const uint32_t u = big ? be32(p) : le32(p);
  float v;
  std::memcpy(&v, &u, 4);
  return v;
}

int cv2_pfm(const uint8_t* d, size_t n, Image* img, int* dims, bool head) {
  if (d[2] != '\n') return kUnreadable;
  Stream s{d, n, 3};
  std::string field;
  if (!cv2_pfm_field(s, field)) return kUnreadable;
  const int w = static_cast<int>(std::strtol(field.c_str(), nullptr, 10));
  if (!cv2_pfm_field(s, field)) return kUnreadable;
  const int h = static_cast<int>(std::strtol(field.c_str(), nullptr, 10));
  if (!cv2_pfm_field(s, field)) return kUnreadable;
  const double scale = std::strtod(field.c_str(), nullptr);
  // validateInputImageSize, between readHeader and readData, raises
  if (!cv2_size_ok(w, h)) return kRaises;
  if (d[1] == 'f' || !(std::fabs(scale) > 0.0)) return kUnreadable;
  dims[0] = h;
  dims[1] = w;
  if (head) return kOk;
  const size_t pitch = static_cast<size_t>(w) * 12;
  if ((n - s.pos) / pitch < static_cast<size_t>(h)) return kUnreadable;
  Out out;
  if (!out.init(img, w, h)) return kUnreadable;
  if (!img) return kOk;
  const bool big = scale >= 0.0;
  const float mul = static_cast<float>(1.0 / std::fabs(scale));
  for (int y = 0; y < h; y++) {
    const uint8_t* row = d + s.pos + pitch * (h - 1 - y);
    for (int x = 0; x < w; x++, row += 12)
      out.put(x, y, cv2_u8(pfm_sample(row, big) * mul),
              cv2_u8(pfm_sample(row + 4, big) * mul),
              cv2_u8(pfm_sample(row + 8, big) * mul));
  }
  return kOk;
}

// PIL: PpmImagePlugin reads gray "Pf" alone (mode F; "PF" is no PPM magic):
// the scale a Python float, nonzero and finite, its sign the byte order
// (negative: little endian), its magnitude unused; rows bottom to top; the
// body whole. convert("RGB") goes through L: a sample <= 0 (and NaN) reads
// 0, >= 255 reads 255, any other is truncated.

// Python's float() of an ASCII token: a sign, then "inf", "infinity" or
// "nan" in any case, or a decimal with single underscores between digits.
bool py_float(const std::string& t, double& v) {
  size_t i = t.empty() || (t[0] != '+' && t[0] != '-') ? 0 : 1;
  std::string word;
  for (size_t k = i; k < t.size(); k++)
    word += static_cast<char>(std::tolower(static_cast<uint8_t>(t[k])));
  if (word == "inf" || word == "infinity" || word == "nan") {
    v = word == "nan" ? NAN : INFINITY;
    if (i && t[0] == '-') v = -v;
    return true;
  }
  std::string clean = t.substr(0, i);
  auto digits = [&](bool& any) {  // digits with single underscores between
    any = false;
    while (i < t.size() && (c_digit(t[i]) || t[i] == '_')) {
      if (t[i] == '_' &&
          (!any || i + 1 >= t.size() || !c_digit(t[i + 1])))
        return false;
      if (t[i] != '_') {
        clean += t[i];
        any = true;
      }
      i++;
    }
    return true;
  };
  bool whole, frac = false;
  if (!digits(whole)) return false;
  if (i < t.size() && t[i] == '.') {
    clean += t[i++];
    if (!digits(frac)) return false;
  }
  if (!whole && !frac) return false;
  if (i < t.size() && (t[i] == 'e' || t[i] == 'E')) {
    clean += t[i++];
    if (i < t.size() && (t[i] == '+' || t[i] == '-')) clean += t[i++];
    bool exp;
    if (!digits(exp) || !exp) return false;
  }
  if (i != t.size()) return false;
  v = std::strtod(clean.c_str(), nullptr);
  return true;
}

// F -> L (Convert.c's f2l)
inline uint8_t pil_f2l(float v) {
  if (v <= 0.0f) return 0;
  if (v >= 255.0f) return 255;
  return v == v ? static_cast<uint8_t>(v) : 0;
}

// ------------------------------------------------------------ PNM (PIL)
// PIL: PpmImagePlugin (magic "P1"-"P6" or "Pf" up to whitespace, tokens of
// at most 10 bytes, '#' comments; samples scaled to 8 bits by round(v /
// maxval * 255) unless maxval is 255; gray past 255 is mode "I", clipped
// by convert; "Pf" as the PFM section says).

// Python's int() of an ASCII token: a sign, digits, single underscores
// between digits.
bool py_int(const std::string& t, int64_t& v) {
  size_t i = 0;
  bool neg = false;
  if (i < t.size() && (t[i] == '+' || t[i] == '-')) neg = t[i++] == '-';
  if (i >= t.size() || !c_digit(t[i])) return false;
  v = 0;
  for (; i < t.size(); i++) {
    if (t[i] == '_') {
      if (i + 1 >= t.size() || !c_digit(t[i + 1])) return false;
      continue;
    }
    if (!c_digit(t[i])) return false;
    if (v > (INT64_MAX - 9) / 10) return false;
    v = v * 10 + (t[i] - '0');
  }
  if (neg) v = -v;
  return true;
}

struct PilPnm {
  int kind = 0;  // 1-6, or 0 for "Pf"
  int64_t w = 0, h = 0, maxval = 1;
  bool little = false;  // "Pf": a negative scale
  size_t data = 0;
};

// PpmImageFile._open: false where it raises.
bool pil_pnm_head(const uint8_t* d, size_t n, PilPnm& hd) {
  size_t pos = 0;
  std::string magic;
  for (int i = 0; i < 6; i++) {
    if (pos >= n) break;
    const int c = d[pos++];
    if (c_space(c)) break;
    magic += static_cast<char>(c);
  }
  if (magic != "Pf" && (magic.size() != 2 || magic[0] != 'P' ||
                        magic[1] < '1' || magic[1] > '6'))
    return false;
  hd.kind = magic == "Pf" ? 0 : magic[1] - '0';
  auto token = [&](std::string& t) {
    t.clear();
    while (t.size() <= 10) {
      if (pos >= n) break;
      const int c = d[pos++];
      if (c_space(c)) {
        if (t.empty()) continue;
        break;
      }
      if (c == '#') {
        while (pos < n) {
          const int e = d[pos++];
          if (e == '\r' || e == '\n') break;
        }
        continue;
      }
      t += static_cast<char>(c);
    }
    return !t.empty() && t.size() <= 10;
  };
  std::string t;
  if (!token(t) || !py_int(t, hd.w) || !token(t) || !py_int(t, hd.h))
    return false;
  if (hd.kind == 0) {
    double scale;
    if (!token(t) || !py_float(t, scale) || scale == 0.0 ||
        !std::isfinite(scale))
      return false;
    hd.little = scale < 0.0;
  } else if (hd.kind != 1 && hd.kind != 4) {
    if (!token(t) || !py_int(t, hd.maxval) || hd.maxval <= 0 ||
        hd.maxval >= 65536)
      return false;
  }
  hd.data = pos;
  return hd.w > 0 && hd.h > 0;
}

// Python's round(value / maxval * out_max): half to even.
inline int64_t py_scale(int64_t value, int64_t maxval, int64_t out_max) {
  return static_cast<int64_t>(std::nearbyint(
      static_cast<double>(value) / static_cast<double>(maxval) *
      static_cast<double>(out_max)));
}

constexpr size_t kSafeBlock = 1024 * 1024;  // ImageFile.SAFEBLOCK

// PpmPlainDecoder's comment stripping of one block (state carried in
// `spans` across blocks).
std::string strip_comments(std::string block, bool& spans,
                           const uint8_t* d, size_t n, size_t& pos) {
  auto comment_end = [](const std::string& b, size_t start) -> long {
    const size_t a = b.find('\n', start), r = b.find('\r', start);
    const long la = a == std::string::npos ? -1 : static_cast<long>(a);
    const long lr = r == std::string::npos ? -1 : static_cast<long>(r);
    return la * lr > 0 ? std::min(la, lr) : std::max(la, lr);
  };
  if (spans) {
    while (!block.empty()) {
      const long e = comment_end(block, 0);
      if (e != -1) {
        block = block.substr(e + 1);
        break;
      }
      const size_t k = std::min(kSafeBlock, n - pos);
      block.assign(reinterpret_cast<const char*>(d + pos), k);
      pos += k;
    }
  }
  spans = false;
  while (true) {
    const size_t start = block.find('#');
    if (start == std::string::npos) break;
    const long e = comment_end(block, start);
    if (e != -1) {
      block = block.substr(0, start) + block.substr(e + 1);
    } else {
      block = block.substr(0, start);
      spans = true;
      break;
    }
  }
  return block;
}

int pil_pnm(const uint8_t* d, size_t n, Image* img, int* dims, bool head) {
  PilPnm hd;
  if (!pil_pnm_head(d, n, hd) || !pil_size_ok(hd.w, hd.h)) return kUnreadable;
  Out out;
  if (!out.init(head ? nullptr : img, hd.w, hd.h)) return kUnreadable;
  dims[0] = out.h;
  dims[1] = out.w;
  if (head) return kOk;
  const int w = out.w, h = out.h;
  if (hd.kind == 0) {  // raw "F;32F" or "F;32BF", rows bottom to top
    const size_t pitch = static_cast<size_t>(w) * 4;
    if (hd.data > n || (n - hd.data) / pitch < static_cast<size_t>(h))
      return kUnreadable;
    for (int y = 0; y < h; y++) {
      const uint8_t* row = d + hd.data + pitch * (h - 1 - y);
      for (int x = 0; x < w; x++) {
        const uint8_t v = pil_f2l(pfm_sample(row + 4 * x, !hd.little));
        out.put(x, y, v, v, v);
      }
    }
    return kOk;
  }
  const bool plain = hd.kind <= 3;
  const int bands = hd.kind == 3 || hd.kind == 6 ? 3 : 1;
  const bool bitmap = hd.kind == 1 || hd.kind == 4;
  // mode "I" (gray past 255) scales to 65535, then convert clips at 255
  const bool mode_i = bands == 1 && !bitmap && hd.maxval > 255;
  const int64_t out_max = mode_i ? 65535 : 255;
  const size_t total = static_cast<size_t>(w) * h * bands;
  std::vector<uint8_t> data;  // 8-bit samples, row-major
  data.reserve(total);
  size_t pos = hd.data;
  auto push = [&](int64_t v) {
    data.push_back(static_cast<uint8_t>(std::min<int64_t>(v, 255)));
  };
  if (plain && bitmap) {  // _decode_bitonal
    bool spans = false;
    while (data.size() != total) {
      if (pos >= n) break;
      const size_t k = std::min(kSafeBlock, n - pos);
      std::string block(reinterpret_cast<const char*>(d + pos), k);
      pos += k;
      block = strip_comments(block, spans, d, n, pos);
      std::string tokens;
      for (char c : block)
        if (!c_space(static_cast<uint8_t>(c))) tokens += c;
      for (char c : tokens)
        if (c != '0' && c != '1') return kUnreadable;
      for (char c : tokens) {
        if (data.size() == total) break;
        data.push_back(c == '0' ? 255 : 0);
      }
    }
  } else if (plain) {  // _decode_blocks
    bool spans = false;
    std::string half;
    while (data.size() != total) {
      std::string block;
      if (pos >= n) {
        if (half.empty()) break;
        block = " ";
      } else {
        const size_t k = std::min(kSafeBlock, n - pos);
        block.assign(reinterpret_cast<const char*>(d + pos), k);
        pos += k;
      }
      block = strip_comments(block, spans, d, n, pos);
      if (!half.empty()) {
        block = half + block;
        half.clear();
      }
      std::vector<std::string> tokens;
      std::string t;
      for (char c : block) {
        if (c_space(static_cast<uint8_t>(c))) {
          if (!t.empty()) tokens.push_back(t);
          t.clear();
        } else {
          t += c;
        }
      }
      if (!t.empty()) tokens.push_back(t);
      if (!block.empty() && !c_space(static_cast<uint8_t>(block.back()))) {
        half = tokens.back();
        tokens.pop_back();
        if (half.size() > 10) return kUnreadable;
      }
      for (const std::string& tok : tokens) {
        int64_t v;
        if (tok.size() > 10 || !py_int(tok, v) || v < 0 || v > hd.maxval)
          return kUnreadable;
        push(py_scale(v, hd.maxval, out_max));
        if (data.size() == total) break;
      }
    }
  } else if (bitmap) {  // raw "1;I"
    const size_t pitch = (static_cast<size_t>(w) + 7) / 8;
    if (pos > n || (n - pos) / pitch < static_cast<size_t>(h))
      return kUnreadable;
    for (int y = 0; y < h; y++)
      for (int x = 0; x < w; x++)
        data.push_back(((d[pos + y * pitch + (x >> 3)] >> (7 - (x & 7))) & 1)
                           ? 0 : 255);
  } else if (hd.maxval == 255) {  // raw
    if (pos > n || n - pos < total) return kUnreadable;
    data.assign(d + pos, d + pos + total);
  } else if (mode_i && hd.maxval == 65535) {  // raw "I;16B"
    if (pos > n || (n - pos) / 2 < total) return kUnreadable;
    for (size_t i = 0; i < total; i++)
      push((d[pos + 2 * i] << 8) | d[pos + 2 * i + 1]);
  } else {  // PpmDecoder
    const size_t in_bytes = hd.maxval < 256 ? 1 : 2;
    while (data.size() < total) {
      if (pos > n || n - pos < in_bytes * bands) break;
      for (int b = 0; b < bands; b++) {
        const int64_t v = in_bytes == 1 ? d[pos + b]
                                        : (d[pos + 2 * b] << 8) | d[pos + 2 * b + 1];
        push(std::min(out_max, py_scale(v, hd.maxval, out_max)));
      }
      pos += in_bytes * bands;
    }
  }
  if (data.size() < total) return kUnreadable;  // "not enough image data"
  for (int y = 0; y < h; y++)
    for (int x = 0; x < w; x++) {
      const uint8_t* p = &data[(static_cast<size_t>(y) * w + x) * bands];
      out.put(x, y, p[0], p[bands == 3 ? 1 : 0], p[bands == 3 ? 2 : 0]);
    }
  return kOk;
}

// ------------------------------------------------------------------ PAM
// cv2: OpenCV's PAM decoder ("P7" then CR or LF, "<FIELD> <value>" lines,
// ENDHDR). PIL does not read PAM.

enum PamFmt { kPamNull, kPamBw, kPamGray, kPamGrayAlpha, kPamRgb, kPamRgbAlpha };

struct PamHead {
  int w = 0, h = 0, depth = 0, maxval = 0, fmt = kPamNull;
};

bool cv2_pam_head(Stream& s, PamHead& hd) {
  s.pos = 2;
  const int c0 = s.byte();
  if (c0 != '\n' && c0 != '\r') return false;
  static const char* kFields[] = {"ENDHDR", "HEIGHT", "WIDTH", "DEPTH",
                                  "MAXVAL", "TUPLTYPE"};
  static const char* kFormats[] = {"", "BLACKANDWHITE", "GRAYSCALE",
                                   "GRAYSCALE_ALPHA", "RGB", "RGB_ALPHA"};
  // OpenCV's ParseInt: an optional '-', digits, then nothing
  auto parse_int = [](const std::string& v, int& out) {
    size_t i = 0;
    bool neg = false;
    if (!v.empty() && v[0] == '-') {
      neg = true;
      i = 1;
      if (i >= v.size() || !c_digit(v[i])) return false;
    }
    uint64_t num = 0;
    for (; i < v.size() && c_digit(v[i]); i++) {
      num = num * 10 + (v[i] - '0');
      if (num >= INT_MAX) return false;
    }
    if (i < v.size() && v[i] != 0) return false;
    out = neg ? -static_cast<int>(num) : static_cast<int>(num);
    return true;
  };
  bool seen[6] = {};
  while (true) {
    int c;
    do c = s.byte(); while (c_space(c));
    if (c == '#') {
      do c = s.byte(); while (c != '\n' && c != '\r');
      continue;
    }
    std::string ident;
    for (int k = 0; k < 8; k++) {
      if (c_space(c)) break;
      ident += static_cast<char>(c);
      c = s.byte();
    }
    if (!c_space(c)) return false;
    ident.resize(std::min(ident.size(), ident.find('\0')));  // a C string
    int field = -1;
    for (int k = 0; k < 6; k++)
      if (ident == kFields[k]) field = k;
    if (field < 0) return false;
    std::string value;
    if (c != '\n' && c != '\r') {
      do c = s.byte(); while (c_space(c));
      for (int k = 0; k < 255; k++) {
        if (c == '\n' || c == '\r') break;
        value += static_cast<char>(c);
        c = s.byte();
      }
      if (c != '\n' && c != '\r') return false;
      while (!value.empty() && c_space(static_cast<uint8_t>(value.back())))
        value.pop_back();
    }
    // a value holding a NUL ends there, as OpenCV's char buffer does
    const size_t nul = value.find('\0');
    if (nul != std::string::npos) value.resize(nul);
    if (field == 0) {
      seen[0] = true;
      break;
    }
    if (field == 5) {
      int f = -1;
      for (int k = 0; k < 6; k++)
        if (value == kFormats[k]) f = k;
      if (f < 0) return false;
      hd.fmt = f;
      continue;
    }
    if (seen[field]) return false;
    seen[field] = true;
    int v;
    if (!parse_int(value, v)) return false;
    if (field == 1) hd.h = v;
    if (field == 2) hd.w = v;
    if (field == 3) hd.depth = v;
    if (field == 4) {
      if (v > 65535) return false;
      hd.maxval = v;
    }
  }
  if (!(seen[1] && seen[2] && seen[3] && seen[4])) return false;
  if (hd.fmt == kPamNull) {
    if (hd.depth == 1 && hd.maxval == 1) hd.fmt = kPamBw;
    else if (hd.depth == 1 && hd.maxval < 256) hd.fmt = kPamGray;
    else if (hd.depth == 3 && hd.maxval < 256) hd.fmt = kPamRgb;
    else return false;
  }
  // the TUPLTYPE's samples a pixel must be DEPTH
  static const int kDepth[] = {0, 1, 1, 2, 3, 4};
  return hd.depth == kDepth[hd.fmt];
}

int cv2_pam(const uint8_t* d, size_t n, Image* img, int* dims, bool head) {
  Stream s{d, n, 0};
  PamHead hd;
  if (!cv2_pam_head(s, hd)) return kUnreadable;
  if (!cv2_size_ok(hd.w, hd.h)) return kRaises;  // a side of 0 too
  dims[0] = hd.h;
  dims[1] = hd.w;
  if (head) return kOk;
  Out out;
  if (!out.init(img, hd.w, hd.h)) return kUnreadable;
  const int w = hd.w, h = hd.h, ch = hd.depth;
  const bool bits = hd.maxval == 1, wide = hd.maxval > 255;
  const size_t elems = static_cast<size_t>(w) * ch;
  for (int y = 0; y < h; y++) {
    const uint8_t* row = s.bytes(elems * (wide ? 2 : 1));
    auto p = [&](size_t i) { return row[wide ? 2 * i : i]; };
    if (bits) {  // one bit a pixel, MSB first, from the row's bytes
      for (int x = 0; x < w; x++) {
        const uint8_t v = ((row[x >> 3] >> (7 - (x & 7))) & 1) ? 255 : 0;
        out.put(x, y, v, v, v);
      }
    } else if (ch == 3) {  // copied into cv2's BGR image as stored
      for (int x = 0; x < w; x++)
        out.put(x, y, p(3 * x + 2), p(3 * x + 1), p(3 * x));
    } else {  // one pixel of every `ch` samples, up to `w` samples
      for (int x = 0; x * ch < w; x++) {
        const size_t i = static_cast<size_t>(x) * ch;
        if (ch == 4) out.put(x, y, p(i), p(i + 1), p(i + 2));
        else out.put(x, y, p(i), p(i), p(i));
      }
    }
  }
  return kOk;
}

// ------------------------------------------------------------------ BMP

struct Rgb {
  uint8_t r = 0, g = 0, b = 0;
};

// cv2: OpenCV's BMP decoder ("BM" or "BA"; 1/4/8/24/32-bit, 16-bit 5-5-5
// or, as BI_BITFIELDS with its masks after the header, 5-6-5; RLE8/RLE4;
// the OS/2 core header). Pixels an RLE stream skips take palette entry 0.
int cv2_bmp(const uint8_t* d, size_t n, Image* img, int* dims, bool head) {
  if (n < 2 || d[0] != 'B' || (d[1] != 'M' && d[1] != 'A')) return kUnreadable;
  try {
    Stream s{d, n, 10};
    const int32_t offset = static_cast<int32_t>(le32(s.bytes(4)));
    const int32_t size = static_cast<int32_t>(le32(s.bytes(4)));
    if (size <= 0) return kUnreadable;
    int64_t w, hh;
    int bpp, comp = 0;
    Rgb pal[256];
    // a 32-bit BI_BITFIELDS file with a V3-V5 header: its R, G, B masks
    // (else the bytes are B, G, R, A)
    uint32_t mask[3] = {0, 0, 0};
    bool masked = false;
    if (size >= 36) {
      w = static_cast<int32_t>(le32(s.bytes(4)));
      hh = static_cast<int32_t>(le32(s.bytes(4)));
      bpp = le32(s.bytes(4)) >> 16;
      comp = static_cast<int32_t>(le32(s.bytes(4)));
      if (comp < 0 || comp > 3) return kUnreadable;
      s.bytes(12);
      const int32_t used = static_cast<int32_t>(le32(s.bytes(4)));
      s.pos += static_cast<size_t>(size) - 36;
      const bool ok =
          w > 0 && hh != 0 &&
          (((bpp == 1 || bpp == 4 || bpp == 8 || bpp == 24 || bpp == 32) &&
            comp == 0) ||
           ((bpp == 16 || bpp == 32) && (comp == 0 || comp == 3)) ||
           (bpp == 4 && comp == 2) || (bpp == 8 && comp == 1));
      if (!ok) return kUnreadable;
      if (bpp <= 8) {
        if (used < 0 || used > 256) return kUnreadable;
        const int k = used == 0 ? 1 << bpp : used;
        const uint8_t* p = s.bytes(static_cast<size_t>(k) * 4);
        for (int i = 0; i < k; i++) pal[i] = {p[4 * i + 2], p[4 * i + 1], p[4 * i]};
      } else if (bpp == 16 && comp == 3) {
        const uint32_t r = le32(s.bytes(4)), g = le32(s.bytes(4)),
                       b = le32(s.bytes(4));
        if (b == 0x1f && g == 0x3e0 && r == 0x7c00) bpp = 15;
        else if (!(b == 0x1f && g == 0x7e0 && r == 0xf800)) return kUnreadable;
      } else if (bpp == 16) {
        bpp = 15;
      } else if (bpp == 32 && comp == 3 && size >= 56) {
        Stream m{d, n, 54};
        for (uint32_t& k : mask) k = le32(m.bytes(4));
        masked = mask[0] && mask[1] && mask[2];
      }
    } else if (size == 12) {
      w = le16(s.bytes(2));
      hh = le16(s.bytes(2));
      bpp = le32(s.bytes(4)) >> 16;
      if (!(w > 0 && hh != 0 &&
            (bpp == 1 || bpp == 4 || bpp == 8 || bpp == 24 || bpp == 32)))
        return kUnreadable;
      if (bpp <= 8) {
        const uint8_t* p = s.bytes((size_t{1} << bpp) * 3);
        for (int i = 0; i < (1 << bpp); i++)
          pal[i] = {p[3 * i + 2], p[3 * i + 1], p[3 * i]};
      }
    } else {
      return kUnreadable;
    }
    const bool bottom_up = hh > 0;
    const int64_t h = hh < 0 ? -hh : hh;
    if (!cv2_size_ok(w, h)) return kRaises;
    if (offset < 0) return kUnreadable;
    dims[0] = static_cast<int>(h);
    dims[1] = static_cast<int>(w);
    if (head) return kOk;
    Out out;
    if (!out.init(img, w, h)) return kUnreadable;
    const int W = out.w, H = out.h;
    // row y of the stream lands on image row Y(y)
    auto Y = [&](int y) { return bottom_up ? H - 1 - y : y; };
    auto put = [&](int x, int y, const Rgb& c) { out.put(x, Y(y), c.r, c.g, c.b); };
    s.pos = static_cast<size_t>(offset);
    if (comp == 1 || comp == 2) {
      int x = 0, y = 0;
      // FillUniColor: `count` pixels of c from (x, y), wrapping rows
      auto fill = [&](int64_t count, const Rgb& c) {
        do {
          const int64_t end = std::min<int64_t>(x + count, W);
          count -= end - x;
          for (; x < end; x++) put(x, y, c);
          if (x >= W) {
            x = 0;
            if (++y >= H) break;
          }
        } while (count > 0);
      };
      if (comp == 1) {  // RLE8
        bool line_end = false;
        for (;;) {
          const uint32_t word = s.word();
          const int len = word & 255, code = word >> 8;
          if (len) {
            const int prev = y;
            if (x + len > W) return kUnreadable;
            fill(len, pal[code]);
            line_end = y != prev;
            if (y >= H) break;
          } else if (code > 2) {
            if (x + code > W) return kUnreadable;
            const uint8_t* p = s.bytes((code + 1) & ~1);
            for (int i = 0; i < code; i++) put(x + i, y, pal[p[i]]);
            x += code;
            line_end = false;
          } else {
            int64_t dx = W - x, dy = H - y;
            if (code || !line_end || dx < W) {
              if (code == 2) {
                dx = s.byte();
                dy = s.byte();
              }
              if (code) dx += dy * W;
              if (y >= H) break;
              fill(dx, pal[0]);
              if (y >= H) break;
            }
            line_end = false;
            if (y >= H) break;
          }
        }
      } else {  // RLE4: end of bitmap ends the row alone; delta's dy unread
        for (;;) {
          const uint32_t word = s.word();
          const int len = word & 255, code = word >> 8;
          if (len) {
            if (x + len > W) return kUnreadable;
            const Rgb c[2] = {pal[code >> 4], pal[code & 15]};
            for (int t = 0; t < len; t++) put(x + t, y, c[t & 1]);
            x += len;
          } else if (code > 2) {
            if (x + code > W) return kUnreadable;
            const uint8_t* p = s.bytes((((code + 1) >> 1) + 1) & ~1);
            for (int i = 0; i < code; i++)
              put(x + i, y, pal[i & 1 ? p[i >> 1] & 15 : p[i >> 1] >> 4]);
            x += code;
          } else {
            int64_t dx = W - x;
            if (code == 2) {
              dx = s.byte();
              s.byte();
            }
            fill(dx, pal[0]);
            if (y >= H) break;
          }
        }
      }
    } else {
      const size_t pitch =
          ((static_cast<size_t>(W) * (bpp == 15 ? 16 : bpp) + 7) / 8 + 3) & ~size_t{3};
      for (int y = 0; y < H; y++) {
        const uint8_t* row = s.bytes(pitch);
        for (int x = 0; x < W; x++) {
          switch (bpp) {
            case 1: put(x, y, pal[(row[x >> 3] >> (7 - (x & 7))) & 1]); break;
            case 4: put(x, y, pal[x & 1 ? row[x >> 1] & 15 : row[x >> 1] >> 4]); break;
            case 8: put(x, y, pal[row[x]]); break;
            case 15: {
              const uint32_t t = le16(row + 2 * x);
              put(x, y, {static_cast<uint8_t>((t >> 7) & 0xf8),
                         static_cast<uint8_t>((t >> 2) & 0xf8),
                         static_cast<uint8_t>((t << 3) & 0xf8)});
              break;
            }
            case 16: {
              const uint32_t t = le16(row + 2 * x);
              put(x, y, {static_cast<uint8_t>((t >> 8) & 0xf8),
                         static_cast<uint8_t>((t >> 3) & 0xfc),
                         static_cast<uint8_t>((t << 3) & 0xf8)});
              break;
            }
            default: {  // 24, 32: B, G, R (and a fourth byte)
              const uint8_t* px = row + static_cast<size_t>(x) * (bpp / 8);
              if (!masked) {
                put(x, y, {px[2], px[1], px[0]});
                break;
              }
              // each channel's field scaled by 255 / its largest value, in
              // float, truncated
              const uint32_t v = le32(px);
              uint8_t c[3];
              for (int k = 0; k < 3; k++) {
                int shift = 0;
                while (!((mask[k] >> shift) & 1)) shift++;
                const float scale = 255.0f / static_cast<float>(mask[k] >> shift);
                c[k] = static_cast<uint8_t>(
                    static_cast<float>((v & mask[k]) >> shift) * scale);
              }
              put(x, y, {c[0], c[1], c[2]});
            }
          }
        }
      }
    }
    return kOk;
  } catch (const Eof&) {
    return kUnreadable;
  }
}

// PIL: BmpImagePlugin ("BM"; core, 40/52/56/64/108/124-byte headers;
// BI_BITFIELDS of the mask layouts it lists, 16-bit samples scaled by
// 255/31 and 255/63; its own RLE decoder).
int pil_bmp(const uint8_t* d, size_t n, Image* img, int* dims, bool head) {
  if (n < 14 || d[0] != 'B' || d[1] != 'M') return kUnreadable;
  size_t offset = le32(d + 10);
  if (n < 18) return kUnreadable;
  const uint32_t hsize = le32(d + 14);
  if (hsize > n - 18 + 4) return kUnreadable;  // _safe_read
  const uint8_t* hd = d + 18;
  size_t pos = 18 + (hsize >= 4 ? hsize - 4 : 0);
  uint64_t w, h;
  int bits, comp = 0, pad;
  bool flip = false;
  uint64_t colors = 0;
  uint32_t mask[4] = {0, 0, 0, 0};
  if (hsize == 12) {
    w = le16(hd);
    h = le16(hd + 2);
    bits = le16(hd + 6);
    pad = 3;
  } else if (hsize == 40 || hsize == 52 || hsize == 56 || hsize == 64 ||
             hsize == 108 || hsize == 124) {
    flip = hd[7] == 0xFF;
    w = le32(hd);
    h = flip ? (uint64_t{1} << 32) - le32(hd + 4) : le32(hd + 4);
    bits = le16(hd + 10);
    comp = static_cast<int>(le32(hd + 12));
    colors = le32(hd + 28);
    pad = 4;
    if (comp == 3) {
      if (hsize - 4 >= 48) {
        for (int k = 0; k < (hsize - 4 >= 52 ? 4 : 3); k++)
          mask[k] = le32(hd + 36 + 4 * k);
      } else {
        for (int k = 0; k < 3; k++) {
          if (pos + 4 > n) return kUnreadable;  // i32 of a short read
          mask[k] = le32(d + pos);
          pos += 4;
        }
      }
    }
  } else {
    return kUnreadable;
  }
  if (!colors) colors = uint64_t{1} << std::min(bits, 63);
  if (offset == 14 + hsize && bits <= 8) offset += 4 * colors;
  if (bits != 1 && bits != 4 && bits != 8 && bits != 16 && bits != 24 &&
      bits != 32)
    return kUnreadable;
  // byte index of each of R, G, B in a 32/24-bit pixel, or a 16-bit layout
  int ri = 2, gi = 1, bi = 0;
  bool rgb565 = false, rle = false;
  if (comp == 3) {
    const uint32_t r = mask[0], g = mask[1], b = mask[2], a = mask[3];
    if (bits == 32) {
      static const uint32_t kOk32[8][4] = {
          {0xFF0000, 0xFF00, 0xFF, 0}, {0xFF000000, 0xFF0000, 0xFF00, 0},
          {0xFF000000, 0xFF00, 0xFF, 0}, {0xFF000000, 0xFF0000, 0xFF00, 0xFF},
          {0xFF, 0xFF00, 0xFF0000, 0xFF000000},
          {0xFF0000, 0xFF00, 0xFF, 0xFF000000},
          {0xFF000000, 0xFF00, 0xFF, 0xFF0000}, {0, 0, 0, 0}};
      bool found = false;
      for (const auto& m : kOk32)
        found |= m[0] == r && m[1] == g && m[2] == b && m[3] == a;
      if (!found) return kUnreadable;
      if (r | g | b) {
        auto idx = [](uint32_t m) { int i = 0; while (!(m & 0xFF)) { m >>= 8; i++; } return i; };
        ri = idx(r);
        gi = idx(g);
        bi = idx(b);
      }
    } else if (bits == 24) {
      if (!(r == 0xFF0000 && g == 0xFF00 && b == 0xFF)) return kUnreadable;
    } else if (bits == 16) {
      if (r == 0xF800 && g == 0x7E0 && b == 0x1F) rgb565 = true;
      else if (!(r == 0x7C00 && g == 0x3E0 && b == 0x1F)) return kUnreadable;
    } else {
      return kUnreadable;
    }
  } else if (comp == 1 || comp == 2) {
    rle = true;
  } else if (comp != 0) {
    return kUnreadable;
  }
  Rgb pal[256];
  // mode "1" (2 colors, black and white) or "L" (entry i is gray i): the
  // raw decoder then reads bits, or bytes as gray levels
  bool mode_1 = false, mode_l = false;
  if (bits <= 8) {
    if (colors == 0 || colors > 65536) return kUnreadable;
    // read(padding * colors): up to the end of the file
    const size_t bytes = std::min<size_t>(pad * colors, pos < n ? n - pos : 0);
    const size_t got = bytes / pad;  // whole entries read
    for (size_t i = 0; i < std::min<size_t>(got, 256); i++)
      pal[i] = {d[pos + pad * i + 2], d[pos + pad * i + 1], d[pos + pad * i]};
    bool gray = got >= colors;
    for (size_t i = 0; gray && i < colors; i++) {
      const uint8_t v = colors == 2 ? (i ? 255 : 0) : static_cast<uint8_t>(i);
      gray = d[pos + pad * i] == v && d[pos + pad * i + 1] == v &&
             d[pos + pad * i + 2] == v;
    }
    mode_1 = gray && colors == 2;
    mode_l = gray && colors != 2;
    // a "P" image takes at most 256 entries (putpalette's size check)
    if (!gray && bytes / pad > 256) return kUnreadable;
    if (mode_1 && rle) return kUnreadable;               // raw "P" into "1"
    if (mode_l && bits != 8) return kUnreadable;         // "L" of 1 or 4 bits
    if (offset == 0) offset = std::min(n, pos + pad * static_cast<size_t>(colors));
  } else if (rle) {
    return kUnreadable;  // an RLE decode into an RGB image
  } else if (offset == 0) {
    offset = std::min(n, pos);
  }
  Out out;
  if (w == 0 || h == 0 || w > (1u << 20) || h > (1u << 20) ||
      !pil_size_ok(static_cast<int64_t>(w), static_cast<int64_t>(h)) ||
      !out.init(head ? nullptr : img, static_cast<int64_t>(w),
                static_cast<int64_t>(h)))
    return kUnreadable;
  dims[0] = out.h;
  dims[1] = out.w;
  if (head) return kOk;
  auto index = [&](int i) {  // a palette index's color in the image's mode
    if (mode_l) return Rgb{static_cast<uint8_t>(i), static_cast<uint8_t>(i),
                           static_cast<uint8_t>(i)};
    return pal[i];
  };
  const int W = out.w, H = out.h;
  auto Y = [&](int y) { return flip ? y : H - 1 - y; };  // direction
  if (rle) {  // BmpRleDecoder: indices, skipped pixels index 0
    const bool rle4 = comp == 2;
    const size_t total = static_cast<size_t>(W) * H;
    std::vector<uint8_t> data;
    size_t p = offset;
    int64_t x = 0;
    auto rd = [&](size_t k) {  // fp.read(k): as many bytes as there are
      const size_t got = p < n ? std::min(k, n - p) : 0;
      const uint8_t* q = d + std::min(p, n);
      p += got;
      return std::make_pair(q, got);
    };
    while (data.size() < total) {
      auto a = rd(1);
      auto b = rd(1);
      if (!a.second || !b.second) break;
      int64_t num = a.first[0];
      const int byte = b.first[0];
      if (num) {
        if (x + num > W) num = std::max<int64_t>(0, W - x);
        for (int64_t i = 0; i < num; i++)
          data.push_back(rle4 ? (i % 2 == 0 ? byte >> 4 : byte & 15) : byte);
        x += num;
      } else if (byte == 0) {
        while (data.size() % W) data.push_back(0);
        x = 0;
      } else if (byte == 1) {
        break;
      } else if (byte == 2) {
        if (rd(2).second < 2) break;
        auto q = rd(2);
        if (q.second < 2) return kUnreadable;  // unpacking a short read
        data.insert(data.end(), q.first[0] + static_cast<size_t>(q.first[1]) * W, 0);
        x = data.size() % W;
      } else {
        const size_t count = rle4 ? byte / 2 : byte;
        auto q = rd(count);
        for (size_t i = 0; i < q.second; i++) {
          if (rle4) {
            data.push_back(q.first[i] >> 4);
            data.push_back(q.first[i] & 15);
          } else {
            data.push_back(q.first[i]);
          }
        }
        if (q.second < count) break;
        x += byte;
        if (p % 2) p++;
      }
    }
    if (data.size() < total) return kUnreadable;  // "not enough image data"
    for (int y = 0; y < H; y++)
      for (int xx = 0; xx < W; xx++) {
        const Rgb c = index(data[static_cast<size_t>(y) * W + xx]);
        out.put(xx, Y(y), c.r, c.g, c.b);
      }
    return kOk;
  }
  // the raw decoder skips each row's padding after the row: the last row
  // needs no padding
  const size_t stride = ((static_cast<size_t>(W) * bits + 31) >> 3) & ~size_t{3};
  const size_t row_bytes = (static_cast<size_t>(W) * bits + 7) / 8;
  if (offset > n || n - offset < stride * (H - 1) + row_bytes)
    return kUnreadable;  // "image file is truncated"
  for (int y = 0; y < H; y++) {
    const uint8_t* row = d + offset + stride * y;
    for (int x = 0; x < W; x++) {
      Rgb c;
      if (mode_1) {  // "1": one bit a pixel from each row, whatever bits
        const uint8_t v = ((row[x >> 3] >> (7 - (x & 7))) & 1) ? 255 : 0;
        out.put(x, Y(y), v, v, v);
        continue;
      }
      switch (bits) {
        case 1: c = pal[(row[x >> 3] >> (7 - (x & 7))) & 1]; break;
        case 4: c = pal[x & 1 ? row[x >> 1] & 15 : row[x >> 1] >> 4]; break;
        case 8: c = index(row[x]); break;
        case 16: {
          const uint32_t t = le16(row + 2 * x);
          if (rgb565)
            c = {static_cast<uint8_t>(((t >> 11) & 31) * 255 / 31),
                 static_cast<uint8_t>(((t >> 5) & 63) * 255 / 63),
                 static_cast<uint8_t>((t & 31) * 255 / 31)};
          else
            c = {static_cast<uint8_t>(((t >> 10) & 31) * 255 / 31),
                 static_cast<uint8_t>(((t >> 5) & 31) * 255 / 31),
                 static_cast<uint8_t>((t & 31) * 255 / 31)};
          break;
        }
        default: {
          const uint8_t* px = row + static_cast<size_t>(x) * (bits / 8);
          c = {px[ri], px[gi], px[bi]};
        }
      }
      out.put(x, Y(y), c.r, c.g, c.b);
    }
  }
  return kOk;
}

// ----------------------------------------------------------- Sun raster

bool is_sun(const uint8_t* d, size_t n) {
  return n >= 4 && be32(d) == 0x59a66a95u;
}

// cv2: OpenCV's SunRasterDecoder. It reads types RT_OLD and RT_STANDARD only
// (its header check compares RT_BYTE_ENCODED and RT_FORMAT_RGB with the
// image's Mat type instead of the file's type, so it refuses both) at 1, 8,
// 24 or 32 bits: no colour map, or an RMT_EQUAL_RGB map of at most 2^depth
// entries (1 and 8 bits); rows padded to 16 bits, every one present. A
// 1-bit file without a map reads 1 as white; a 32-bit pixel's bytes 1-3
// are its B, G and R; map entries past the map's length read black.
int cv2_sun(const uint8_t* d, size_t n, Image* img, int* dims, bool head) {
  if (!is_sun(d, n) || n < 32) return kUnreadable;
  const int32_t w = static_cast<int32_t>(be32(d + 4)),
                h = static_cast<int32_t>(be32(d + 8));
  const uint32_t bpp = be32(d + 12), type = be32(d + 20),
                 maptype = be32(d + 24);
  const int32_t maplength = static_cast<int32_t>(be32(d + 28));
  const int32_t palsize = bpp - 1 < 8 ? 3 << bpp : 0;
  if (type > 1 || maptype > 1 || w <= 0 || h <= 0 ||
      (bpp != 1 && bpp != 8 && bpp != 24 && bpp != 32))
    return kUnreadable;
  if (maptype == 0 ? maplength != 0
                   : maplength <= 0 || maplength > palsize || bpp > 8 ||
                         n - 32 < static_cast<size_t>(maplength))
    return kUnreadable;
  if (!cv2_size_ok(w, h)) return kRaises;
  dims[0] = h;
  dims[1] = w;
  if (head) return kOk;
  const size_t pitch = ((static_cast<size_t>(w) * bpp + 7) / 8 + 1) & ~size_t{1};
  const size_t body = 32 + static_cast<size_t>(maplength);
  if ((n - body) / pitch < static_cast<size_t>(h)) return kUnreadable;
  Out out;
  if (!out.init(img, w, h)) return kUnreadable;
  if (!img) return kOk;
  Rgb pal[256];
  if (maplength) {
    const int k = maplength / 3;
    for (int i = 0; i < k; i++)
      pal[i] = {d[32 + i], d[32 + i + k], d[32 + i + 2 * k]};
  } else if (bpp == 1) {
    pal[1] = {255, 255, 255};
  } else {
    for (int i = 0; i < 256; i++)
      pal[i] = {static_cast<uint8_t>(i), static_cast<uint8_t>(i), static_cast<uint8_t>(i)};
  }
  for (int y = 0; y < h; y++) {
    const uint8_t* row = d + body + pitch * y;
    for (int x = 0; x < w; x++) {
      if (bpp == 1 || bpp == 8) {
        const Rgb& c = pal[bpp == 1 ? (row[x >> 3] >> (7 - (x & 7))) & 1 : row[x]];
        out.put(x, y, c.r, c.g, c.b);
      } else {
        const uint8_t* px = row + static_cast<size_t>(x) * (bpp / 8) + (bpp == 32);
        out.put(x, y, px[2], px[1], px[0]);
      }
    }
  }
  return kOk;
}

// PIL: SunImagePlugin and convert("RGB"): types 0-5 but RT_BYTE_ENCODED read
// raw, RT_BYTE_ENCODED through its run decoder (SunRleDecode.c: rows not
// padded, a run may span rows); 1-bit (0 white), 4-bit (gray * 17, or a
// palette index) and 8-bit gray, or palette indices where a map is given
// (its type must be 1, at most 768 bytes); 24/32-bit BGR(X), RGB(X) for type
// 3; raw rows padded to 16 bits, the last row's padding not needed.
int pil_sun(const uint8_t* d, size_t n, Image* img, int* dims, bool head) {
  if (!is_sun(d, n) || n < 32) return kUnreadable;
  const uint32_t w = be32(d + 4), h = be32(d + 8), depth = be32(d + 12),
                 type = be32(d + 20), ptype = be32(d + 24), plen = be32(d + 28);
  if (depth != 1 && depth != 4 && depth != 8 && depth != 24 && depth != 32)
    return kUnreadable;
  const size_t pal_bytes = std::min<size_t>(plen, n - 32);
  // a palette on a 1, 24 or 32-bit image: putpalette's "wrong mode"; past
  // 256 entries: "invalid palette size"
  if (plen && (plen > 1024 || ptype != 1 || depth > 8 || depth == 1 ||
               pal_bytes / 3 > 256))
    return kUnreadable;
  if (type > 5 || !pil_size_ok(w, h)) return kUnreadable;
  dims[0] = static_cast<int>(h);
  dims[1] = static_cast<int>(w);
  if (head) return kOk;
  const size_t row_bytes = (static_cast<size_t>(w) * depth + 7) / 8;
  const size_t stride = (static_cast<size_t>(w) * depth + 15) / 16 * 2;
  const size_t offset = 32 + static_cast<size_t>(plen);
  std::vector<uint8_t> rows(row_bytes * h);
  if (type != 2) {  // raw
    if (offset > n || (n - offset) < stride * (h - 1) + row_bytes) return kUnreadable;
    for (uint32_t y = 0; y < h; y++)
      std::memcpy(&rows[row_bytes * y], d + offset + stride * y, row_bytes);
  } else {  // sun_rle
    size_t pos = offset, x = 0, y = 0;
    uint8_t* line = rows.data();
    auto advance = [&](size_t k) {  // k bytes written at x; false when done
      x += k;
      if (x >= row_bytes) {
        x = 0;
        if (++y >= h) return false;
        line += row_bytes;
      }
      return true;
    };
    for (bool more = true; more;) {
      if (pos >= n) return kUnreadable;  // "image file is truncated"
      if (d[pos] != 0x80) {
        line[x] = d[pos++];
        more = advance(1);
        continue;
      }
      if (n - pos < 2) return kUnreadable;
      if (d[pos + 1] == 0) {
        line[x] = 0x80;
        pos += 2;
        more = advance(1);
        continue;
      }
      if (n - pos < 3) return kUnreadable;
      size_t run = d[pos + 1] + 1;
      const uint8_t v = d[pos + 2];
      pos += 3;
      while (run && more) {  // a run spanning rows fills each in turn
        const size_t k = std::min(run, row_bytes - x);
        std::memset(line + x, v, k);
        run -= k;
        more = advance(k);
      }
    }
  }
  Out out;
  if (!out.init(img, w, h)) return kUnreadable;
  Rgb pal[256];
  const size_t k = pal_bytes / 3;
  for (size_t i = 0; i < k; i++)
    pal[i] = {d[32 + i], d[32 + i + k], d[32 + i + 2 * k]};
  for (uint32_t y = 0; y < h; y++) {
    const uint8_t* row = &rows[row_bytes * y];
    for (uint32_t x = 0; x < w; x++) {
      Rgb c;
      if (depth == 24 || depth == 32) {
        const uint8_t* px = row + static_cast<size_t>(x) * (depth / 8);
        c = type == 3 ? Rgb{px[0], px[1], px[2]} : Rgb{px[2], px[1], px[0]};
      } else {
        int v = depth == 1 ? (row[x >> 3] >> (7 - (x & 7))) & 1
                : depth == 4 ? (row[x >> 1] >> (x & 1 ? 0 : 4)) & 15
                             : row[x];
        if (plen) {
          c = pal[v];
        } else {
          v = depth == 1 ? (v ? 0 : 255) : depth == 4 ? v * 17 : v;
          c = {static_cast<uint8_t>(v), static_cast<uint8_t>(v), static_cast<uint8_t>(v)};
        }
      }
      out.put(x, y, c.r, c.g, c.b);
    }
  }
  return kOk;
}

// ------------------------------------------------------------------ PNG

const uint8_t kPngSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};

int png_channels(int ctype, int depth) {
  switch (ctype) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 ||
                   depth == 16 ? 1 : 0;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8
                   ? 1 : 0;
    case 2: return depth == 8 || depth == 16 ? 3 : 0;
    case 4: return depth == 8 || depth == 16 ? 2 : 0;
    case 6: return depth == 8 || depth == 16 ? 4 : 0;
    default: return 0;
  }
}

struct Chunk {
  uint32_t len;
  const uint8_t* type;
  const uint8_t* data;
  bool crc_ok;
};

// The rows of an image's IDAT stream, filtered as stored: Adam7's passes
// (empty ones left out) or the whole image. Rows are fed by inflating one
// row (filter byte and samples) at a time, as libpng and Pillow do.
struct Rows {
  int w, h, bits;  // bits a pixel
  bool interlace;
  struct Pass { int x0, y0, dx, dy, pw, ph; size_t bytes; };
  std::vector<Pass> passes;
  std::vector<uint8_t> raw;  // unfiltered rows of every pass, in order
  size_t pass = 0, row = 0, fill = 0;  // the row being filled
  std::vector<uint8_t> cur, prev;

  void init(int w_, int h_, int bits_, bool il) {
    w = w_;
    h = h_;
    bits = bits_;
    interlace = il;
    static const int adam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                                    {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                                    {0, 1, 1, 2}};
    for (int p = 0; p < (il ? 7 : 1); p++) {
      const int x0 = il ? adam7[p][0] : 0, y0 = il ? adam7[p][1] : 0;
      const int dx = il ? adam7[p][2] : 1, dy = il ? adam7[p][3] : 1;
      const int pw = (w - x0 + dx - 1) / dx, ph = (h - y0 + dy - 1) / dy;
      if (pw > 0 && ph > 0)
        passes.push_back({x0, y0, dx, dy, pw, ph,
                          (static_cast<size_t>(pw) * bits + 7) / 8});
    }
    begin_pass();
  }
  void begin_pass() {
    if (pass >= passes.size()) return;
    cur.assign(passes[pass].bytes + 1, 0);
    prev.assign(passes[pass].bytes + 1, 0);
  }
  bool done() const { return pass >= passes.size(); }
  size_t need() const { return cur.size() - fill; }
  // Unfilters the full row in `cur`; false on a filter type past 4.
  bool finish_row(bool keep) {
    const size_t stride = cur.size() - 1;
    const size_t uch = bits < 8 ? 1 : bits / 8;
    uint8_t* c = cur.data() + 1;
    const uint8_t* up = prev.data() + 1;
    switch (cur[0]) {
      case 0: break;
      case 1: for (size_t x = uch; x < stride; x++) c[x] += c[x - uch]; break;
      case 2: for (size_t x = 0; x < stride; x++) c[x] += up[x]; break;
      case 3:
        for (size_t x = 0; x < stride; x++)
          c[x] += ((x >= uch ? c[x - uch] : 0) + up[x]) >> 1;
        break;
      case 4:
        for (size_t x = 0; x < stride; x++) {
          const int a = x >= uch ? c[x - uch] : 0, b = up[x],
                    cc = x >= uch ? up[x - uch] : 0;
          const int p = a + b - cc, pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - cc);
          c[x] += (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : cc);
        }
        break;
      default: return false;
    }
    if (keep) raw.insert(raw.end(), c, c + stride);
    std::swap(cur, prev);
    fill = 0;
    if (++row >= static_cast<size_t>(passes[pass].ph)) {
      row = 0;
      pass++;
      begin_pass();
    }
    return true;
  }
};

struct PngHead {
  int w = 0, h = 0, depth = 0, ctype = 0, interlace = 0, orientation = 1;
};

// RGB from the unfiltered rows: 16 bits keep the high byte (PIL clips
// 16-bit gray at 255 instead), 1/2/4-bit gray is scaled to 8 bits, palette
// indices past the palette read black, alpha is dropped.
void expand_png(const PngHead& hd, const Rows& rows,
                const std::vector<uint8_t>& plte, bool pil, Out& out) {
  const int ch = png_channels(hd.ctype, hd.depth), depth = hd.depth;
  const size_t ncolors = plte.size() / 3;
  const int gray_scale = depth < 8 ? 255 / ((1 << depth) - 1) : 1;
  const size_t step = depth == 16 ? 2 : 1;
  const uint8_t* src = rows.raw.data();
  const uint8_t* end = src + rows.raw.size();
  for (const Rows::Pass& p : rows.passes) {
    for (int r = 0; r < p.ph; r++, src += p.bytes) {
      if (src + p.bytes > end) return;  // rows a stream left out stay black
      const int y = p.y0 + r * p.dy;
      for (int i = 0; i < p.pw; i++) {
        const int x = p.x0 + i * p.dx;
        if (depth < 8) {
          const size_t bit = static_cast<size_t>(i) * depth;
          const int v = (src[bit / 8] >> (8 - depth - bit % 8)) & ((1 << depth) - 1);
          if (hd.ctype == 3) {
            if (static_cast<size_t>(v) < ncolors)
              out.put(x, y, plte[3 * v], plte[3 * v + 1], plte[3 * v + 2]);
          } else {
            const uint8_t g = static_cast<uint8_t>(v * gray_scale);
            out.put(x, y, g, g, g);
          }
          continue;
        }
        const uint8_t* px = src + static_cast<size_t>(i) * ch * step;
        switch (hd.ctype) {
          case 3:
            if (px[0] < ncolors)
              out.put(x, y, plte[3 * px[0]], plte[3 * px[0] + 1], plte[3 * px[0] + 2]);
            break;
          case 0:
          case 4: {
            const uint8_t g = pil && depth == 16 && hd.ctype == 0
                                  ? (px[0] ? 255 : px[1]) : px[0];
            out.put(x, y, g, g, g);
            break;
          }
          default:
            out.put(x, y, px[0], px[step], px[2 * step]);
        }
      }
    }
  }
}

bool png_letters(const uint8_t* t) {
  for (int i = 0; i < 4; i++)
    if (!((t[i] >= 'A' && t[i] <= 'Z') || (t[i] >= 'a' && t[i] <= 'z')))
      return false;
  return true;
}

bool is_type(const uint8_t* t, const char* name) { return !std::memcmp(t, name, 4); }

// The chunk at `pos`, whole (header, data and CRC in the file), or false.
bool chunk_at(const uint8_t* d, size_t n, size_t pos, Chunk& c) {
  if (pos > n || n - pos < 8) return false;
  c.len = be32(d + pos);
  if (c.len > 0x7fffffffu || n - pos - 8 < static_cast<size_t>(c.len) + 4)
    return false;
  c.type = d + pos + 4;
  c.data = d + pos + 8;
  c.crc_ok = static_cast<uint32_t>(crc32(0L, c.type, 4 + c.len)) ==
             be32(d + pos + 8 + c.len);
  return true;
}

bool ihdr_fields(const uint8_t* s, PngHead& hd) {
  hd.w = static_cast<int>(be32(s));
  hd.h = static_cast<int>(be32(s + 4));
  hd.depth = s[8];
  hd.ctype = s[9];
  hd.interlace = s[12];
  return png_channels(hd.ctype, hd.depth) != 0;
}

// The orientation of an eXIf chunk before the first IDAT (1 without one).
int png_orientation(const uint8_t* d, size_t n) {
  Chunk c;
  for (size_t pos = 33; chunk_at(d, n, pos, c);
       pos += 12 + static_cast<size_t>(c.len)) {
    if (is_type(c.type, "IDAT") || is_type(c.type, "IEND")) break;
    if (is_type(c.type, "eXIf")) return tiff_orientation(c.data, c.len);
  }
  return 1;
}

// cv2: libpng through OpenCV's decoder. `head` reads IHDR and the eXIf
// orientation alone (of a file or of its chunks before IDAT).
int cv2_png(const uint8_t* d, size_t n, Image* img, int* dims, bool head) {
  if (n < 8 || std::memcmp(d, kPngSig, 8)) return kUnreadable;
  Chunk c;
  if (!chunk_at(d, n, 8, c) || !is_type(c.type, "IHDR") || c.len != 13 ||
      !c.crc_ok)
    return kUnreadable;
  PngHead hd;
  if (!ihdr_fields(c.data, hd) || hd.w <= 0 || hd.h <= 0 ||
      hd.w > 1000000 || hd.h > 1000000 || c.data[10] != 0 ||
      c.data[11] != 0 || hd.interlace > 1)
    return kUnreadable;  // libpng's own limits: 1,000,000 a side
  hd.orientation = png_orientation(d, n);
  const bool swap = hd.orientation >= 5;
  dims[0] = swap ? hd.w : hd.h;
  dims[1] = swap ? hd.h : hd.w;
  const bool size_ok = cv2_size_ok(hd.w, hd.h);
  if (head) return size_ok ? kOk : kRaises;
  Rows rows;
  rows.init(hd.w, hd.h, png_channels(hd.ctype, hd.depth) * hd.depth,
            hd.interlace == 1);
  std::vector<uint8_t> plte;
  bool have_plte = false, have_idat = false, after_idat = false, ended = false;
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return kUnreadable;
  struct End { z_stream* z; ~End() { inflateEnd(z); } } end{&zs};
  for (size_t pos = 8 + 12 + c.len;;) {
    // names of letters, the third upper case (the reserved bit clear)
    if (!chunk_at(d, n, pos, c) || !png_letters(c.type) || (c.type[2] & 0x20))
      return kUnreadable;
    pos += 12 + static_cast<size_t>(c.len);
    const bool critical = !(c.type[0] & 0x20);
    if (have_idat && !is_type(c.type, "IDAT")) {
      if (!ended) return kUnreadable;  // "Not enough compressed data"
      after_idat = true;
    }
    if (is_type(c.type, "IEND")) {
      if (!have_idat || !rows.done()) return kUnreadable;
      break;
    }
    if (is_type(c.type, "IHDR")) return kUnreadable;
    if (is_type(c.type, "PLTE")) {
      if (have_plte || have_idat) return kUnreadable;
      have_plte = true;
      if (hd.ctype == 3) {
        if (!c.crc_ok || c.len == 0 || c.len % 3 || c.len > 768)
          return kUnreadable;
        plte.assign(c.data, c.data + c.len);
      }
      continue;
    }
    if (is_type(c.type, "IDAT")) {
      if (hd.ctype == 3 && !have_plte) return kUnreadable;
      // readHeader ends at the first whole IDAT (its CRC unchecked), then
      // validateInputImageSize raises
      if (!size_ok) return kRaises;
      have_idat = true;
      if (!c.crc_ok) return kUnreadable;
      if (after_idat || ended) continue;  // extra data: warnings
      zs.next_in = const_cast<uint8_t*>(c.data);
      zs.avail_in = c.len;
      while (zs.avail_in > 0 && !ended) {
        const bool rows_done = rows.done();
        std::vector<uint8_t> sink(rows_done ? 4096 : 0);
        zs.next_out = rows_done ? sink.data() : rows.cur.data() + rows.fill;
        zs.avail_out = static_cast<uInt>(rows_done ? sink.size() : rows.need());
        const uInt before = zs.avail_out;
        const int ret = inflate(&zs, Z_SYNC_FLUSH);
        if (ret != Z_OK && ret != Z_STREAM_END) {
          if (!rows_done) return kUnreadable;
          ended = true;
          break;
        }
        if (zs.avail_out != before) {
          if (rows_done) {  // "Extra compressed data"
            ended = true;
            break;
          }
          rows.fill += before - zs.avail_out;
          if (rows.need() == 0 && !rows.finish_row(img != nullptr))
            return kUnreadable;
        }
        if (ret == Z_STREAM_END) ended = true;
      }
      continue;
    }
    if (critical) return kUnreadable;  // an unknown critical chunk
  }
  Out out;
  if (!out.init(img, hd.w, hd.h)) return kUnreadable;
  if (img) {
    expand_png(hd, rows, plte, false, out);
    apply_orientation(*img, hd.orientation);
  }
  return kOk;
}

// PIL: PngImagePlugin and its zlib row decoder (ZipDecode).
int pil_png(const uint8_t* d, size_t n, Image* img, int* dims) {
  if (n < 8 || std::memcmp(d, kPngSig, 8)) return kUnreadable;
  auto is_cid = [](const uint8_t* t) {
    for (int i = 0; i < 4; i++)
      if (!(c_digit(t[i]) || t[i] == '_' || (t[i] >= 'A' && t[i] <= 'Z') ||
            (t[i] >= 'a' && t[i] <= 'z')))
        return false;
    return true;
  };
  // A known chunk handler's checks of its data; false where it raises.
  int mode_ctype = -1;
  auto handler_ok = [&](const uint8_t* t, const uint8_t* s, uint32_t len) {
    if (is_type(t, "IHDR")) return len >= 13 && s[11] == 0;
    if (is_type(t, "gAMA")) return len >= 4;
    if (is_type(t, "cHRM")) return len % 4 == 0;
    if (is_type(t, "sRGB")) return len >= 1;
    if (is_type(t, "pHYs")) return len >= 9;
    if (is_type(t, "acTL")) return len >= 8;
    if (is_type(t, "fcTL") || is_type(t, "fdAT")) return false;
    if (is_type(t, "zTXt")) {
      const uint8_t* z = static_cast<const uint8_t*>(std::memchr(s, 0, len));
      return !z || z + 1 >= s + len || z[1] == 0;
    }
    if (is_type(t, "iCCP")) {
      const uint8_t* z = static_cast<const uint8_t*>(std::memchr(s, 0, len));
      const size_t i = z ? z - s + 1 : 0;
      return i < len && s[i] == 0;
    }
    if (is_type(t, "tRNS"))  // one gray or RGB sample, i16 each
      return mode_ctype == 0 ? len >= 2 : mode_ctype == 2 ? len >= 6 : true;
    return true;
  };
  auto known = [](const uint8_t* t) {
    static const char* kKnown[] = {"iCCP", "IHDR", "IDAT", "IEND", "PLTE",
                                   "tRNS", "gAMA", "cHRM", "sRGB", "pHYs",
                                   "tEXt", "zTXt", "iTXt", "eXIf", "acTL",
                                   "fcTL", "fdAT"};
    for (const char* k : kKnown)
      if (is_type(t, k)) return true;
    return false;
  };
  PngHead hd;
  bool have_ihdr = false;
  std::vector<uint8_t> plte;
  size_t pos = 8, idat_pos = 0;
  uint32_t idat_len = 0;
  while (true) {  // _open: the chunks up to the first IDAT, CRCs checked
    if (pos > n || n - pos < 8) return kUnreadable;
    const uint8_t* t = d + pos + 4;
    const uint32_t len = be32(d + pos);
    pos += 8;
    if (!is_cid(t)) return kUnreadable;
    if (is_type(t, "IDAT")) {
      idat_pos = pos;
      idat_len = len;
      break;
    }
    if (is_type(t, "IEND")) return kUnreadable;  // no image data
    if (len > n - pos) return kUnreadable;       // _safe_read
    const uint8_t* s = d + pos;
    if (known(t) && !handler_ok(t, s, len)) return kUnreadable;
    if (is_type(t, "IHDR")) {
      have_ihdr = ihdr_fields(s, hd);
      mode_ctype = have_ihdr ? hd.ctype : -1;
      if (!have_ihdr) return kUnreadable;  // not a mode PIL knows
    }
    if (is_type(t, "PLTE") && mode_ctype == 3) plte.assign(s, s + (len / 3) * 3);
    pos += len;
    if (n - pos < 4 || static_cast<uint32_t>(crc32(0L, t, 4 + len)) != be32(d + pos))
      return kUnreadable;
    pos += 4;
  }
  if (!have_ihdr || !pil_size_ok(hd.w, hd.h)) return kUnreadable;
  Rows rows;
  rows.init(hd.w, hd.h, png_channels(hd.ctype, hd.depth) * hd.depth,
            hd.interlace != 0);
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return kUnreadable;
  struct End { z_stream* z; ~End() { inflateEnd(z); } } end{&zs};
  // load: pieces of at most 65536 bytes of consecutive IDAT chunks
  size_t at = idat_pos;
  uint32_t left = idat_len;
  bool finished = false;
  while (!finished) {
    while (left == 0) {  // load_read: the CRC, then the next chunk
      at += 4;
      if (at > n || n - at < 8) return kUnreadable;  // "truncated"
      const uint8_t* t = d + at + 4;
      if (!is_cid(t) || !is_type(t, "IDAT")) return kUnreadable;
      left = be32(d + at);
      at += 8;
    }
    const size_t want = std::min<size_t>(left, 65536);
    const size_t got = at < n ? std::min(want, n - at) : 0;
    left -= static_cast<uint32_t>(want);
    if (got == 0) return kUnreadable;  // "image file is truncated"
    zs.next_in = const_cast<uint8_t*>(d + at);
    zs.avail_in = static_cast<uInt>(got);
    at += want;
    while (zs.avail_in > 0) {
      zs.next_out = rows.cur.data() + rows.fill;
      zs.avail_out = static_cast<uInt>(rows.need());
      const int err = inflate(&zs, Z_NO_FLUSH);
      if (err < 0) return kUnreadable;
      rows.fill = rows.cur.size() - zs.avail_out;
      if (rows.need() > 0) break;  // more input
      if (!rows.finish_row(true)) return kUnreadable;
      if (rows.done() || err == Z_STREAM_END) {
        finished = true;
        break;
      }
    }
  }
  // load_end: the rest of the IDAT, then chunks up to IEND, leniently
  at += left;
  while (true) {
    at += 4;  // CRC, unchecked
    if (at > n || n - at < 8) break;  // struct.error / a short type
    const uint8_t* t = d + at + 4;
    const uint32_t len = be32(d + at);
    at += 8;
    if (!is_cid(t) || is_type(t, "IEND")) break;
    if (len > n - at) return kUnreadable;  // _safe_read: truncated
    if (known(t) && !is_type(t, "IDAT") && !handler_ok(t, d + at, len))
      return kUnreadable;
    at += len;
  }
  Out out;
  out.init(img, hd.w, hd.h);
  expand_png(hd, rows, plte, true, out);
  dims[0] = hd.h;
  dims[1] = hd.w;
  return kOk;
}

// ----------------------------------------------------------------- C7

// SpiderImagePlugin.isSpiderHeader over the first 27 floats (big or
// little endian): header values 1, 2, 5, 12, 13, 22 and 23 integers, an
// iform of 1, 3, -11, -12, -21 or -22, and labbyt = labrec x lenbyt.
bool spider_header(const uint8_t* d, size_t n, bool big) {
  if (n < 27 * 4) return false;
  double h[28];
  for (int i = 0; i < 27; i++) {
    uint32_t u = 0;
    for (int k = 0; k < 4; k++)
      u |= uint32_t{d[4 * i + (big ? k : 3 - k)]} << (24 - 8 * k);
    float f;
    std::memcpy(&f, &u, 4);
    h[i + 1] = f;
  }
  for (int i : {1, 2, 5, 12, 13, 22, 23})
    if (!std::isfinite(h[i]) || h[i] != std::trunc(h[i])) return false;
  const double iform = h[5];
  if (iform != 1 && iform != 3 && iform != -11 && iform != -12 &&
      iform != -21 && iform != -22)
    return false;
  // int() of the values, compared as Python's unbounded integers
  return h[22] == h[13] * h[23] && h[22] != 0;
}

// A format cv2.imread reads that the port does not decode, or one only PIL
// reads, by its first bytes.
int foreign(const uint8_t* d, size_t n) {
  auto at = [&](size_t o, const char* s, size_t k) {
    return n >= o + k && !std::memcmp(d + o, s, k);
  };
  if (at(4, "ftyp", 4) && (at(8, "avif", 4) || at(8, "avis", 4)))
    return kAvif;
  // Pillow's _accept checks (IM and SPIDER: the header checks of _open)
  if (n >= 2 && d[0] == 10 && (d[1] == 0 || d[1] == 2 || d[1] == 3 || d[1] == 5))
    return kPcx;
  if (n >= 2 && d[0] == 0x01 && d[1] == 0xDA) return kSgi;
  // (ICO and CUR: with at least one entry, or Pillow tries on)
  if ((at(0, "\0\0\1\0", 4) || at(0, "\0\0\2\0", 4)) && n >= 6 &&
      (d[4] | d[5] << 8) != 0)
    return kIco;
  if (at(0, "DDS ", 4)) return kDds;
  if (at(0, "qoif", 4)) return kQoi;
  if (at(0, "icns", 4)) return kIcns;
  if (at(0, "DanM", 4) || at(0, "LinS", 4)) return kMsp;
  if (at(0, "Image type:", 11) &&
      std::memchr(d, '\n', std::min<size_t>(n, 100)) != nullptr)
    return kIm;
  if (spider_header(d, n, true) || spider_header(d, n, false)) return kSpider;
  return kUnreadable;
}

}  // namespace

int read_cv2(const uint8_t* d, size_t n, Image* img, int* dims, bool head) {
  int hw[2];
  int* out = dims ? dims : hw;
  try {
    if (n >= 8 && !std::memcmp(d, kPngSig, 8))
      return cv2_png(d, n, img, out, head);
    if (n >= 2 && d[0] == 'B' && (d[1] == 'M' || d[1] == 'A'))
      return cv2_bmp(d, n, img, out, head);
    if (is_cv2_pnm(d, n)) return cv2_pnm(d, n, img, out, head);
    if (is_pfm(d, n)) return cv2_pfm(d, n, img, out, head);
    if (n >= 3 && d[0] == 'P' && d[1] == '7' && c_space(d[2]))
      return cv2_pam(d, n, img, out, head);
    if (is_sun(d, n)) return cv2_sun(d, n, img, out, head);
    if (is_gif_data(d, n)) return gif_cv2(d, n, img, out, head);
    if (is_hdr_data(d, n)) return hdr_cv2(d, n, img, out, head);
    if (is_tiff_data(d, n)) return tiff_cv2(d, n, img, out, head);
    if (is_webp_data(d, n)) return webp_cv2(d, n, img, out, head);
    if (is_jpeg2000_data(d, n)) return jpeg2000_cv2(d, n, img, out, head);
  } catch (const Eof&) {
  }
  return kUnreadable;
}

int read_pil(const uint8_t* d, size_t n, Image* img, int* dims, bool head) {
  int hw[2];
  int* out = dims ? dims : hw;
  if (n >= 8 && !std::memcmp(d, kPngSig, 8))
    return head ? kUnreadable : pil_png(d, n, img, out);
  if (n >= 2 && d[0] == 'B' && d[1] == 'M') return pil_bmp(d, n, img, out, head);
  if (n >= 2 && d[0] == 'P') return pil_pnm(d, n, img, out, head);
  if (is_sun(d, n)) return pil_sun(d, n, img, out, head);
  if (is_gif_data(d, n)) return gif_pil(d, n, img, out, head);
  if (is_tiff_data(d, n)) return tiff_pil(d, n, img, out, head);
  if (is_webp_data(d, n)) return webp_pil(d, n, img, out, head);
  if (is_jpeg2000_data(d, n)) return jpeg2000_pil(d, n, img, out, head);
  return kUnreadable;
}

int foreign_format(const uint8_t* d, size_t n) { return foreign(d, n); }

}  // namespace tsrio
