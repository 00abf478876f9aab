// gif.cpp — GIF read as the reference reads it: cv2.imread first, else
// PIL's Image.open(path).convert("RGB").
//
// Two readers, each a copy of what its library does with the first frame:
//   - gif_cv2: OpenCV 5's own GifDecoder. readHeader walks the whole file to
//     count its frames (so any cut, and any byte between blocks other than
//     '!', ',' or the trailer ';', refuses the file; a 3-byte sub-block of
//     an application extension without a NETSCAPE2.0 block before it is
//     skipped as 2 bytes), then readData parses the first frame: a graphic
//     control extension must have a 4-byte block and a disposal method of
//     0-3, the frame must lie inside the logical screen, the LZW stream is
//     decoded with its quirks (an end code resets the table like a clear
//     code; a data code after the last pixel is accepted only where the
//     block ends there and the terminator follows; a string past the last
//     pixel refuses the file) and every index must fall in the local table,
//     else the global one (with neither, index 1 reads white and any other
//     index i reads gray i). The canvas is the background colour of the
//     global table (black without one), and a transparent pixel keeps it.
//   - gif_pil: Pillow 12's GifImagePlugin and its C decoder (GifDecode.c)
//     for the files cv2 refuses: mode P (L where no palette is needed), the
//     size grown to the first frame's extent, the canvas palette index 0 or
//     the transparent index, a frame that ends early or breaks its LZW
//     stream refused, data after the last pixel ignored.
// Each runs on a whole file in memory; without an output image it checks the
// file and gives its (h, w), short of storing pixels.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#include "codec.h"

namespace tsrio {
namespace {

bool is_gif(const uint8_t* d, size_t n) {
  return n >= 6 && (!std::memcmp(d, "GIF87a", 6) || !std::memcmp(d, "GIF89a", 6));
}

// OpenCV's RLByteStream over the file: reading past its end throws, a skip
// only moves the position.
struct Eof {};
struct Reader {
  const uint8_t* d;
  size_t n, pos;
  int byte() {
    if (pos >= n) throw Eof();
    return d[pos++];
  }
  int word() {
    const int lo = byte();
    return lo | (byte() << 8);
  }
  void skip(size_t k) { pos = k > n - std::min(pos, n) ? n + 1 : pos + k; }
};

// An RGB canvas, or nothing where only the check runs.
struct Canvas {
  Image* img = nullptr;
  int w = 0;
  void init(Image* im, int w_, int h_, const uint8_t* rgb) {
    img = im;
    w = w_;
    if (!img) return;
    img->w = w_;
    img->h = h_;
    img->rgb.resize(static_cast<size_t>(w_) * h_ * 3);
    for (size_t i = 0; i < img->rgb.size(); i += 3)
      std::memcpy(&img->rgb[i], rgb, 3);
  }
  void put(int x, int y, const uint8_t* rgb) {
    if (img) std::memcpy(&img->rgb[(static_cast<size_t>(y) * w + x) * 3], rgb, 3);
  }
};

// The first frame's rows in the order its pixels are stored.
std::vector<int> row_order(int h, bool interlaced) {
  std::vector<int> rows;
  if (!interlaced) {
    for (int y = 0; y < h; y++) rows.push_back(y);
    return rows;
  }
  static const int kStart[4] = {0, 4, 2, 1}, kStep[4] = {8, 8, 4, 2};
  for (int p = 0; p < 4; p++)
    for (int y = kStart[p]; y < h; y += kStep[p]) rows.push_back(y);
  return rows;
}

// ------------------------------------------------------------------ cv2

// getFrameCount_: the blocks after the global table, up to the trailer.
void cv2_walk(Reader& s) {
  for (int b = s.byte(); b != ';'; b = s.byte()) {
    if (b == ',') {
      s.skip(8);
      const int flags = s.byte();
      if (flags & 0x80) s.skip(static_cast<size_t>(3) << ((flags & 7) + 1));
      s.skip(1);  // the LZW minimum code size
    } else if (b == '!') {
      const int label = s.byte();
      if (label == 0xff) {  // the NETSCAPE2.0 loop count
        bool netscape = false;
        for (int len = s.byte(); len; len = s.byte()) {
          if (len == 11) {
            char id[11];
            for (char& c : id) c = static_cast<char>(s.byte());
            netscape = !std::memcmp(id, "NETSCAPE2.0", 11);
          } else if (len == 3) {
            if (netscape && s.byte() == 1)
              s.word();
            else
              s.skip(2);  // without NETSCAPE2.0 before it: 2 of 3 bytes
          } else {
            s.skip(len);
          }
        }
        continue;
      }
      if (label == 0xf9) {
        for (int len = s.byte(); len; len = s.byte()) s.skip(len);
        continue;
      }
    } else {
      throw Eof();  // CV_Assert(false)
    }
    for (int len = s.byte(); len; len = s.byte()) s.skip(len);
  }
}

// lzwDecode: `total` indices of the frame into `out`; false where cv2's
// decoder gives false (or throws).
bool cv2_lzw(Reader& s, size_t total, std::vector<uint8_t>& out) {
  const int min_size = s.byte();
  if (min_size < 2 || min_size > 11) return false;
  const int clear = 1 << min_size, exit_code = clear + 1;
  // entry k's string: that of `link` (or the literal `link` where
  // `literal`), then `suffix`; `length` counts it
  struct Entry {
    int link, length;
    uint8_t suffix, first;
    bool literal;
  };
  std::vector<Entry> table(4097);
  std::vector<uint8_t> str;
  size_t idx = 0;
  int code_size = min_size + 1, table_size = exit_code, left = 0;
  uint32_t src = 0;
  int block = s.byte();
  if (!block) return idx == total;
  auto reset = [&] {
    code_size = min_size + 1;
    table_size = exit_code;
  };
  enum { kRead, kDecode, kCheckBlock, kContinue } at = kRead;
  for (;;) {
    switch (at) {
      case kRead:
        src |= static_cast<uint32_t>(s.byte()) << left;
        left += 8;
        block--;
        if (left >= code_size) {
          at = kDecode;
          break;
        }
        if (!block) {
          block = s.byte();
          if (!block) return idx == total;
        }
        break;
      case kCheckBlock:
        if (!block) {
          block = s.byte();
          if (!block) return idx == total;
        }
        at = kContinue;
        break;
      case kContinue:
        at = code_size <= left ? kDecode : kRead;
        break;
      case kDecode: {
        const int code = src & ((1u << code_size) - 1);
        src >>= code_size;
        left -= code_size;
        if (code == clear) {
          reset();
          at = code_size <= left ? kDecode : kCheckBlock;
          break;
        }
        if (code == exit_code) {
          reset();
          at = kCheckBlock;
          break;
        }
        if (idx >= total) return idx == total && !block && s.byte() == 0;
        const bool full = table_size > 4095;
        if (code < clear) {
          if (!full) {
            table[table_size].suffix = static_cast<uint8_t>(code);
            Entry& e = table[++table_size];
            e = {code, 2, 0, static_cast<uint8_t>(code), true};
          }
          out[idx++] = static_cast<uint8_t>(code);
        } else {
          if (!full) {
            if (code > table_size) return false;
            table[table_size].suffix = table[code].first;
            Entry& e = table[++table_size];
            e = {code, table[code].length + 1, 0, table[code].first, false};
          }
          const Entry& c = table[code];
          if (idx + c.length > total) return false;  // "Too long LZW length"
          str.resize(c.length);
          int k = code, i = c.length;
          while (!table[k].literal) {
            str[--i] = table[k].suffix;
            k = table[k].link;
          }
          str[--i] = table[k].suffix;
          str[--i] = static_cast<uint8_t>(table[k].link);
          std::memcpy(&out[idx], str.data(), str.size());
          idx += str.size();
        }
        if (table_size == (1 << code_size) && code_size <= 11) code_size++;
        at = code_size > left ? kCheckBlock : kDecode;
        break;
      }
    }
  }
}

int gif_cv2_impl(const uint8_t* d, size_t n, Image* img, int* dims, bool head) {
  if (!is_gif(d, n)) return kUnreadable;
  Reader s{d, n, 6};
  const int sw = s.word(), sh = s.word();
  if (sw <= 0 || sh <= 0) return kUnreadable;
  const int flags = s.byte(), bg = s.byte();
  s.skip(1);
  int gsize = 0;
  uint8_t gct[768];
  if (flags & 0x80) {
    gsize = 1 << ((flags & 7) + 1);
    for (int i = 0; i < 3 * gsize; i++) gct[i] = static_cast<uint8_t>(s.byte());
    if (bg >= gsize) return kUnreadable;
  }
  dims[0] = sh;
  dims[1] = sw;
  if (head) return cv2_size_ok(sw, sh) ? kOk : kRaises;
  const size_t frames = s.pos;
  cv2_walk(s);  // readHeader; then validateInputImageSize raises
  if (!cv2_size_ok(sw, sh)) return kRaises;
  s.pos = frames;
  // readExtensions: the graphic control extension of the first frame
  bool transparent = false;
  int transparent_index = 0;
  for (;;) {
    if (s.byte() != '!') {
      s.pos--;
      break;
    }
    if (s.byte() == 0xf9) {
      transparent = false;
      if (s.byte() != 4) return kUnreadable;
      const int gce = s.byte();
      if (gce & 0x10) return kUnreadable;  // disposal method past 3
      transparent = gce & 1;
      s.word();
      transparent_index = s.byte();
    }
    for (int len = s.byte(); len; len = s.byte()) s.skip(len);
  }
  if (s.byte() != ',') return kUnreadable;
  const int x0 = s.word(), y0 = s.word(), fw = s.word(), fh = s.word();
  if (fw <= 0 || fh <= 0 || x0 + fw > sw || y0 + fh > sh) return kUnreadable;
  const int fflags = s.byte();
  int lsize = 0;
  uint8_t lct[768];
  if (fflags & 0x80) {
    lsize = 1 << ((fflags & 7) + 1);
    for (int i = 0; i < 3 * lsize; i++) lct[i] = static_cast<uint8_t>(s.byte());
  }
  std::vector<uint8_t> index(static_cast<size_t>(fw) * fh);
  if (!cv2_lzw(s, index.size(), index)) return kUnreadable;
  Canvas out;
  const uint8_t black[3] = {0, 0, 0};
  out.init(img, sw, sh, gsize ? gct + 3 * bg : black);
  size_t k = 0;
  for (const int y : row_order(fh, fflags & 0x40)) {
    for (int x = 0; x < fw; x++) {
      const int c = index[k++];
      if (transparent && c == transparent_index) continue;
      if (c < lsize) {
        out.put(x0 + x, y0 + y, lct + 3 * c);
      } else if (c < gsize) {
        out.put(x0 + x, y0 + y, gct + 3 * c);
      } else if (lsize | gsize) {
        return kUnreadable;  // an index past both tables
      } else {
        const uint8_t v = c == 1 ? 255 : static_cast<uint8_t>(c), g[3] = {v, v, v};
        out.put(x0 + x, y0 + y, g);
      }
    }
  }
  return kOk;
}

// ------------------------------------------------------------------ PIL

// GifImageFile.data(): a sub-block (its length byte, then up to that many
// bytes): how many bytes it read, -1 (None) where the length is 0 or the
// file ends; `at` is where they start.
int pil_data(const uint8_t* d, size_t n, size_t& pos, size_t* at = nullptr) {
  if (pos >= n || d[pos] == 0) {
    pos = std::min(pos + 1, n);
    return -1;
  }
  const size_t want = d[pos++];
  if (at) *at = pos;
  const size_t got = std::min(want, n - pos);
  pos += got;
  return static_cast<int>(got);
}

// A palette PIL keeps: not the identity ramp (_is_palette_needed); false
// (and `bad`) where its length is not a multiple of 3 (an IndexError).
bool palette_needed(const uint8_t* p, size_t len, bool& bad) {
  if (len % 3) {
    bad = true;
    return false;
  }
  for (size_t i = 0; i < len; i += 3)
    if (!(i / 3 == p[i] && p[i] == p[i + 1] && p[i + 1] == p[i + 2])) return true;
  return false;
}

// GifDecode.c over the first frame's region: the indices of a `rw` x `rh`
// region from the LZW data at `pos` (its minimum code size `bits`), as
// ImageFile.load feeds it 65536-byte reads of the file; false where PIL
// raises (the data ends or an end code comes before the last pixel, a
// broken code).
bool pil_lzw(const uint8_t* d, size_t n, size_t pos, int bits, int rw, int rh,
             bool interlaced, std::vector<uint8_t>& out) {
  if (bits > 12) return false;  // IMAGING_CODEC_CONFIG
  constexpr int kTable = 4096;
  const size_t start = pos;
  size_t loaded = std::min(n, start + 65536);
  auto load_more = [&] {  // ImageFile.load's next read; false at EOF
    if (loaded >= n) return false;
    loaded = std::min(n, loaded + 65536);
    return true;
  };
  const int clear = 1 << bits, end = clear + 1;
  std::vector<uint8_t> buffer(kTable), data(kTable);
  std::vector<uint16_t> link(kTable);
  int state = 1, next = 0, codesize = 0, codemask = 0, bufferindex = kTable;
  int lastcode = 0, lastdata = 0, bitcount = 0, blocksize = 0;
  uint32_t bitbuffer = 0;
  int x = 0, y = 0, step = interlaced ? 8 : 1, pass = interlaced ? 1 : 0;
  // NEWLINE; false once the region is full (the decoder's return -1)
  auto newline = [&] {
    x = 0;
    y += step;
    while (y >= rh) {
      switch (pass) {
        case 1: y = 4; pass = 2; break;
        case 2: step = 4; y = 2; pass = 3; break;
        case 3: step = 2; y = 1; pass = 0; break;
        default: return false;
      }
    }
    return true;
  };
  for (;;) {
    if (state == 1) {
      next = clear + 2;
      codesize = bits + 1;
      codemask = (1 << codesize) - 1;
      bufferindex = kTable;
      state = 2;
    }
    const uint8_t* p;
    int count;
    uint8_t single;
    if (bufferindex < kTable) {
      count = kTable - bufferindex;
      p = &buffer[bufferindex];
      bufferindex = kTable;
    } else {
      while (bitcount < codesize) {
        if (blocksize > 0) {
          bitbuffer |= static_cast<uint32_t>(d[pos++]) << bitcount;
          bitcount += 8;
          blocksize--;
        } else {  // a new block, decoded once it is whole
          while (pos + 1 > loaded || pos + 1 + d[pos] > loaded)
            if (!load_more()) return false;  // "image file is truncated"
          blocksize = d[pos++];
        }
      }
      int c = static_cast<int>(bitbuffer & static_cast<uint32_t>(codemask));
      bitbuffer >>= codesize;
      bitcount -= codesize;
      if (c == clear) {
        if (state != 2) state = 1;
        continue;
      }
      if (c == end) {  // load reads on, the decoder resumes after it
        if (!load_more()) return false;
        continue;
      }
      count = 1;
      if (state == 2) {
        if (c > clear) return false;  // "broken data stream"
        lastdata = lastcode = c;
        state = 3;
      } else {
        const int thiscode = c;
        if (c > next) return false;
        if (c == next) {
          if (bufferindex <= 0) return false;
          buffer[--bufferindex] = static_cast<uint8_t>(lastdata);
          c = lastcode;
        }
        while (c >= clear) {
          if (bufferindex <= 0 || c >= kTable) return false;
          buffer[--bufferindex] = data[c];
          c = link[c];
        }
        lastdata = c;
        if (next < kTable) {
          data[next] = static_cast<uint8_t>(c);
          link[next] = static_cast<uint16_t>(lastcode);
          if (next == codemask && codesize < 12) {
            codesize++;
            codemask = (1 << codesize) - 1;
          }
          next++;
        }
        lastcode = thiscode;
      }
      // the string's first index now, the rest (in the buffer) next pass
      single = static_cast<uint8_t>(lastdata);
      p = &single;
    }
    for (int i = 0; i < count; i++) {
      out[static_cast<size_t>(y) * rw + x] = p[i];
      if (++x >= rw && !newline()) return true;
    }
  }
}

struct PilGif {
  int w = 0, h = 0;           // the image's size
  int x0 = 0, y0 = 0, fw = 0, fh = 0, bits = 0;
  bool interlaced = false;
  int transparency = -1;
  size_t offset = 0;          // the LZW data after the code size byte
  const uint8_t* palette = nullptr;  // mode P's palette, else mode L
  size_t palette_len = 0;
};

// GifImageFile._open and _seek(0): false where Image.open raises.
bool pil_open(const uint8_t* d, size_t n, PilGif& g) {
  if (n < 13 || !is_gif(d, n)) return false;
  g.w = d[6] | (d[7] << 8);
  g.h = d[8] | (d[9] << 8);
  const int flags = d[10];
  size_t pos = 13;
  const uint8_t* global = nullptr;
  size_t global_len = 0;
  if (flags & 128) {
    const size_t want = static_cast<size_t>(3) << ((flags & 7) + 1);
    global_len = std::min(want, n - pos);
    bool bad = false;
    if (palette_needed(d + pos, global_len, bad)) global = d + pos;
    if (bad) return false;
    pos += global_len;
  }
  if (pos >= n || d[pos] == ';') return false;  // "no more images"
  int transparency = -1;
  int s = d[pos++];
  for (;;) {
    if (s < 0) {
      if (pos >= n) return false;
      s = d[pos++];
    }
    if (s == ';') return false;  // "image not found in GIF frame"
    if (s == '!') {
      if (pos >= n) return false;  // s[0] of an empty read
      const int label = d[pos++];
      size_t at = 0;
      const int len = pil_data(d, n, pos, &at);
      if (label == 249 && len >= 0) {
        if (len < 3 || ((d[at] & 1) && len < 4)) return false;  // block[3], i16
        if (d[at] & 1) transparency = d[at + 3];
      } else if (label == 254) {
        if (len > 0)
          while (pil_data(d, n, pos) > 0) {
          }
        s = -1;
        continue;
      } else if (label == 255 && len >= 11 &&
                 !std::memcmp(d + at, "NETSCAPE2.0", 11)) {
        pil_data(d, n, pos);
      }
      while (pil_data(d, n, pos) > 0) {
      }
    } else if (s == ',') {
      if (n - pos < 9) return false;
      const uint8_t* q = d + pos;
      pos += 9;
      g.x0 = q[0] | (q[1] << 8);
      g.y0 = q[2] | (q[3] << 8);
      g.fw = q[4] | (q[5] << 8);
      g.fh = q[6] | (q[7] << 8);
      g.w = std::max(g.w, g.x0 + g.fw);
      g.h = std::max(g.h, g.y0 + g.fh);
      g.interlaced = q[8] & 64;
      g.palette = global;
      g.palette_len = global_len;
      if (q[8] & 128) {
        const size_t want = static_cast<size_t>(3) << ((q[8] & 7) + 1);
        const size_t len = std::min(want, n - pos);
        bool bad = false;
        const bool needed = palette_needed(d + pos, len, bad);
        if (bad) return false;
        g.palette = needed ? d + pos : nullptr;
        g.palette_len = needed ? len : 0;
        pos += len;
      }
      if (pos >= n) return false;
      g.bits = d[pos++];
      g.offset = pos;
      g.transparency = transparency;
      return true;
    }
    s = -1;
  }
}

int gif_pil_impl(const uint8_t* d, size_t n, Image* img, int* dims, bool head) {
  PilGif g;
  if (!pil_open(d, n, g) || !pil_size_ok(g.w, g.h)) return kUnreadable;
  dims[0] = g.h;
  dims[1] = g.w;
  if (head) return kOk;
  // decoder.setimage: an extent of x0 == x1 == 0 is the whole image
  int rx = g.x0, ry = g.y0, rw = g.fw, rh = g.fh;
  if (g.x0 == 0 && g.fw == 0) {
    rx = ry = 0;
    rw = g.w;
    rh = g.h;
  }
  if (rw <= 0 || rh <= 0) return kUnreadable;  // "tile cannot extend outside image"
  std::vector<uint8_t> region(static_cast<size_t>(rw) * rh);
  if (!pil_lzw(d, n, g.offset, g.bits, rw, rh, g.interlaced, region))
    return kUnreadable;
  if (!img) return kOk;
  // the canvas: palette index 0, or the transparent index
  std::vector<uint8_t> index(static_cast<size_t>(g.w) * g.h,
                             g.transparency >= 0 ? g.transparency : 0);
  for (int y = 0; y < rh; y++)
    std::memcpy(&index[static_cast<size_t>(ry + y) * g.w + rx],
                &region[static_cast<size_t>(y) * rw], rw);
  img->w = g.w;
  img->h = g.h;
  img->rgb.resize(index.size() * 3);
  for (size_t i = 0; i < index.size(); i++) {
    const size_t v = index[i];
    uint8_t* px = &img->rgb[3 * i];
    if (!g.palette) {
      px[0] = px[1] = px[2] = static_cast<uint8_t>(v);
    } else if (3 * v + 3 <= g.palette_len) {
      std::memcpy(px, g.palette + 3 * v, 3);
    } else {
      px[0] = px[1] = px[2] = 0;
    }
  }
  return kOk;
}

}  // namespace

bool is_gif_data(const uint8_t* d, size_t n) { return is_gif(d, n); }

int gif_cv2(const uint8_t* d, size_t n, Image* img, int* dims, bool head) {
  try {
    return gif_cv2_impl(d, n, img, dims, head);
  } catch (const Eof&) {
    return kUnreadable;
  }
}

int gif_pil(const uint8_t* d, size_t n, Image* img, int* dims, bool head) {
  return gif_pil_impl(d, n, img, dims, head);
}

}  // namespace tsrio
