// webp.cpp — WebP's RIFF container, its lossless image (VP8L) and the
// alpha of its lossy one (ALPH) as cv2.imread and PIL's
// Image.open(...).convert("RGB") read them; the lossy image itself (VP8)
// is vp8.cpp's.
//
// Both readers sit on libwebp 1.6 (OpenCV 5's build and Pillow 12's
// bundle), and this file copies the parts of it they reach:
//   - the container: webp_dec.c's header parse (ParseRIFF, ParseVP8X,
//     ParseOptionalChunks, ParseVP8Header: WebPGetFeatures and the parse
//     WebPDecode makes before it decodes) and demux.c's (WebPDemux: the
//     chunk walk and IsValidSimpleFormat / IsValidExtendedFormat, which
//     refuse a file that is wrong anywhere, a later frame included);
//   - an animation's first frame as anim_decode.c composes it: the frame
//     at its offset on a zeroed canvas (the ANIM background unused);
//   - VP8L as vp8l_dec.c, huffman_utils.c and lossless.c decode it: the
//     transforms (predictor in its 14 modes, cross-colour, subtract-green,
//     colour-indexing with 1, 2, 4 or 8 pixels a byte), the colour cache,
//     meta prefix codes, simple and normal prefix codes (refused where
//     BuildHuffmanTable refuses them), backward references over the
//     120-entry distance map, and the bit reader's end-of-stream rule (a
//     decode fails once it has read past its buffer; a buffer under 8
//     bytes reads as zeros up to 64 bits);
//   - a lossy image's ALPH chunk as alpha_dec.c decodes it, its alpha then
//     dropped: the header byte's checks, the raw size, or a VP8L image
//     stream at the frame's size (whose end-of-stream rule is looser on
//     the 8-bit path libwebp takes for a palette of alpha levels); the
//     last ALPH chunk before "VP8 " in WebPDecode's parse, the one a frame
//     holds in WebPDemux's (a still image's only where the VP8X flag says
//     so).
// cv2 (OpenCV 5's WebPDecoder): a file of 32 bytes or more whose first 32
// bytes WebPGetFeatures accepts (a RIFF WEBP file, a raw VP8L stream, a raw
// VP8 stream whose first partition ends inside them),
// of at most 64 MiB; a still image through WebPDecode over the whole file
// (the VP8L data may run on past its chunk), an animation (the VP8X flag)
// through WebPAnimDecoder; imread's size rule on the first 32 bytes'
// canvas (kRaises), then the EXIF chunk's orientation where WebPDemux
// accepts the file and stores the chunk (the VP8X EXIF flag).
// PIL (WebPImagePlugin): a RIFF WEBP file whose first chunk is "VP8 ",
// "VP8L" or "VP8X", any size, through WebPAnimDecoder; no orientation;
// Pillow's size rule on the canvas. Both drop alpha.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <new>
#include <vector>

#include "codec.h"

namespace tsrio {
namespace {

// ------------------------------------------------------------ bytes

struct Short {};  // a read past the data (the parsers check sizes first)

// The data a parser walks: the whole file in memory, or an open file read
// by seeking (the header probe).
class Src {
 public:
  explicit Src(uint64_t n) : n_(n) {}
  virtual ~Src() = default;
  uint64_t size() const { return n_; }
  virtual void get(uint64_t off, size_t len, uint8_t* out) const = 0;
  uint32_t le(uint64_t off, int k) const {
    uint8_t b[4];
    get(off, k, b);
    uint32_t v = 0;
    for (int i = k - 1; i >= 0; i--) v = v << 8 | b[i];
    return v;
  }
  bool tag(uint64_t off, const char* t) const {
    uint8_t b[4];
    get(off, 4, b);
    return !std::memcmp(b, t, 4);
  }

 private:
  uint64_t n_;
};

class MemSrc : public Src {
 public:
  MemSrc(const uint8_t* d, size_t n) : Src(n), d_(d) {}
  void get(uint64_t off, size_t len, uint8_t* out) const override {
    if (off > size() || len > size() - off) throw Short();
    std::memcpy(out, d_ + off, len);
  }

 private:
  const uint8_t* d_;
};

class FileSrc : public Src {
 public:
  FileSrc(FILE* f, uint64_t n) : Src(n), f_(f) {}
  void get(uint64_t off, size_t len, uint8_t* out) const override {
    if (off > size() || len > size() - off) throw Short();
    if (fseeko(f_, static_cast<off_t>(off), SEEK_SET) != 0 ||
        std::fread(out, 1, len, f_) != len)
      throw Short();
  }

 private:
  FILE* f_;
};

constexpr uint32_t kTagSize = 4, kChunkHeader = 8, kRiffHeader = 12;
constexpr uint32_t kVp8xChunk = 10, kAnmfChunk = 16, kAnimChunk = 6;
constexpr uint32_t kMaxChunkPayload = ~0u - kChunkHeader - 1;
constexpr uint64_t kMaxImageArea = uint64_t{1} << 32;
constexpr uint32_t kAnimationFlag = 0x02, kXmpFlag = 0x04, kExifFlag = 0x08,
                   kAlphaFlag = 0x10, kIccpFlag = 0x20,
                   kAllValidFlags = 0x3e;
// OpenCV's WEBP_HEADER_SIZE and OPENCV_IMGCODECS_WEBP_MAX_FILE_SIZE
constexpr size_t kCv2Header = 32;
constexpr uint64_t kCv2MaxFile = uint64_t{64} << 20;

// ------------------------------------------------- webp_dec.c's parse

enum Vp8Status { kVpOk, kVpNotEnough, kVpBitstream, kVpUnsupported };

struct Features {
  int w = 0, h = 0, animation = 0;
};

// What WebPParseHeaders hands the decoder.
struct Headers {
  uint64_t offset = 0;  // the VP8/VP8L payload, from the data's start
  bool lossless = false;
  bool alpha = false;  // an ALPH chunk: its payload's place and size
  uint64_t alpha_off = 0, alpha_size = 0;
};

// VP8LGetInfo on `left` bytes at `p` (at least VP8L_FRAME_HEADER_SIZE):
// the signature, version 0 and the 14-bit sides.
bool vp8l_info(const Src& s, uint64_t p, uint64_t left, int* w, int* h) {
  if (left < 5) return false;
  uint8_t b[5];
  s.get(p, 5, b);
  if (b[0] != 0x2f || (b[4] >> 5) != 0) return false;
  const uint32_t bits = b[1] | b[2] << 8 | b[3] << 16 |
                        static_cast<uint32_t>(b[4]) << 24;
  *w = static_cast<int>(bits & 0x3fff) + 1;
  *h = static_cast<int>((bits >> 14) & 0x3fff) + 1;
  return true;
}

// VP8GetInfo: a lossy key frame's header (VP8_FRAME_HEADER_SIZE bytes).
bool vp8_info(const Src& s, uint64_t p, uint64_t left, uint64_t chunk_size,
              int* w, int* h) {
  if (left < 10) return false;
  uint8_t b[10];
  s.get(p, 10, b);
  if (b[3] != 0x9d || b[4] != 0x01 || b[5] != 0x2a) return false;
  const uint32_t bits = b[0] | b[1] << 8 | b[2] << 16;
  if (bits & 1) return false;  // not a key frame
  if (((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) || (bits >> 5) >= chunk_size)
    return false;
  *w = ((b[7] << 8) | b[6]) & 0x3fff;
  *h = ((b[9] << 8) | b[8]) & 0x3fff;
  return *w != 0 && *h != 0;
}

// ParseHeadersInternal over the `size` bytes at `p`: WebPGetFeatures
// (hd null: the features alone, not all the data at hand) or the parse
// WebPDecode makes (hd set: all the data at hand, the payload's place).
int parse_headers(const Src& s, uint64_t p, uint64_t size, Features* ft,
                  Headers* hd) {
  const bool have_all = hd != nullptr;
  const uint64_t start = p;
  uint64_t left = size, riff_size = 0;
  if (left < kRiffHeader) return kVpNotEnough;
  // ParseRIFF
  if (s.tag(p, "RIFF")) {
    if (!s.tag(p + 8, "WEBP")) return kVpBitstream;
    const uint32_t riff = s.le(p + 4, 4);
    if (riff < kTagSize + kChunkHeader || riff > kMaxChunkPayload)
      return kVpBitstream;
    if (have_all && riff > left - kChunkHeader) return kVpNotEnough;
    riff_size = riff;
    p += kRiffHeader;
    left -= kRiffHeader;
  }
  const bool found_riff = riff_size > 0;
  // ParseVP8X
  bool found_vp8x = false;
  uint32_t flags = 0;
  int canvas_w = 0, canvas_h = 0;
  if (left < kChunkHeader) return kVpNotEnough;
  if (s.tag(p, "VP8X")) {
    if (s.le(p + 4, 4) != kVp8xChunk) return kVpBitstream;
    if (left < kChunkHeader + kVp8xChunk) return kVpNotEnough;
    flags = s.le(p + 8, 4);
    const uint64_t w = 1 + uint64_t{s.le(p + 12, 3)};
    const uint64_t h = 1 + uint64_t{s.le(p + 15, 3)};
    if (w * h >= kMaxImageArea) return kVpBitstream;
    canvas_w = static_cast<int>(w);
    canvas_h = static_cast<int>(h);
    p += kChunkHeader + kVp8xChunk;
    left -= kChunkHeader + kVp8xChunk;
    found_vp8x = true;
  }
  const int animation = !!(flags & kAnimationFlag);
  if (!found_riff && found_vp8x) return kVpBitstream;
  int image_w = canvas_w, image_h = canvas_h;
  auto features = [&](int st) {
    if (st == kVpOk || (st == kVpNotEnough && found_vp8x && !hd)) {
      if (ft) *ft = {image_w, image_h, animation};
      return static_cast<int>(kVpOk);
    }
    return st;
  };
  if (found_vp8x && animation && !hd) return features(kVpOk);
  if (left < kTagSize) return features(kVpNotEnough);
  // ParseOptionalChunks
  if ((found_riff && found_vp8x) ||
      (!found_riff && !found_vp8x && s.tag(p, "ALPH"))) {
    uint32_t total = kTagSize + kChunkHeader + kVp8xChunk;
    while (true) {
      if (left < kChunkHeader) return features(kVpNotEnough);
      const uint32_t chunk = s.le(p + 4, 4);
      if (chunk > kMaxChunkPayload) return features(kVpBitstream);
      const uint32_t disk = (kChunkHeader + chunk + 1) & ~1u;
      total += disk;
      if (riff_size > 0 && total > riff_size) return features(kVpBitstream);
      if (s.tag(p, "VP8 ") || s.tag(p, "VP8L")) break;
      if (left < disk) return features(kVpNotEnough);
      if (hd && s.tag(p, "ALPH")) {  // the last one before the image wins
        hd->alpha = true;
        hd->alpha_off = p + kChunkHeader;
        hd->alpha_size = chunk;
      }
      p += disk;
      left -= disk;
    }
  }
  // ParseVP8Header
  if (left < kChunkHeader) return features(kVpNotEnough);
  const bool is_vp8 = s.tag(p, "VP8 "), is_vp8l = s.tag(p, "VP8L");
  uint64_t compressed;
  bool lossless;
  if (is_vp8 || is_vp8l) {
    const uint32_t chunk = s.le(p + 4, 4);
    const uint32_t minimal = kTagSize + kChunkHeader;
    if (riff_size >= minimal && chunk > riff_size - minimal)
      return features(kVpBitstream);
    if (have_all && chunk > left - kChunkHeader)
      return features(kVpNotEnough);
    compressed = chunk;
    p += kChunkHeader;
    left -= kChunkHeader;
    lossless = is_vp8l;
  } else {  // a raw VP8/VP8L stream
    uint8_t b[5] = {};
    if (left >= 5) s.get(p, 5, b);
    lossless = left >= 5 && b[0] == 0x2f && (b[4] >> 5) == 0;
    compressed = left;
  }
  if (compressed > kMaxChunkPayload) return kVpBitstream;
  if (!lossless) {
    if (left < 10) return features(kVpNotEnough);
    if (!vp8_info(s, p, left, compressed, &image_w, &image_h))
      return kVpBitstream;
  } else {
    if (left < 5) return features(kVpNotEnough);
    if (!vp8l_info(s, p, left, &image_w, &image_h)) return kVpBitstream;
  }
  if (found_vp8x && (canvas_w != image_w || canvas_h != image_h))
    return kVpBitstream;
  if (hd) {
    hd->offset = p - start;
    hd->lossless = lossless;
    if (animation) return kVpUnsupported;  // WebPParseHeaders
  }
  return features(kVpOk);
}

// ----------------------------------------------------- demux.c's parse

enum Parse { kParseOk, kParseMore, kParseError };
enum DemuxState { kParsingHeader, kParsedHeader, kDemuxDone };

struct Frame {
  int x = 0, y = 0, w = 0, h = 0, frame_num = 0;
  bool complete = false;
  uint64_t img_off = 0, img_size = 0, alpha_off = 0, alpha_size = 0;
};

struct Chunk {
  uint64_t off, size;  // the header's place; header and unpadded payload
};

// WebPDemux (no partial data) over a whole file.
class Demux {
 public:
  explicit Demux(const Src& s) : s_(s) {}
  bool parse();
  int canvas_w = -1, canvas_h = -1;
  uint32_t flags = 0;
  std::vector<Frame> frames;
  std::vector<Chunk> chunks;

 private:
  uint64_t data_size() const { return end_ - start_; }
  bool size_invalid(uint64_t n) const { return n > riff_end_ - start_; }
  uint32_t read(int k) {
    const uint32_t v = s_.le(start_, k);
    start_ += k;
    return v;
  }
  bool add_frame(const Frame& f) {
    if (!frames.empty() && !frames.back().complete) return false;
    frames.push_back(f);
    return true;
  }
  int store_frame(int frame_num, uint32_t min_size, Frame& f);
  int parse_single_image();
  int parse_animation_frame(uint32_t frame_chunk_size);
  int parse_vp8x_chunks();
  int parse_vp8x();
  bool valid_simple() const;
  bool valid_extended() const;

  const Src& s_;
  uint64_t start_ = 0, end_ = 0, riff_end_ = 0;
  int state_ = kParsingHeader;
  bool is_ext_ = false;
  int num_frames_ = 0;
};

int Demux::store_frame(int frame_num, uint32_t min_size, Frame& f) {
  int alpha_chunks = 0, image_chunks = 0;
  bool done = data_size() < kChunkHeader || data_size() < min_size;
  int status = kParseOk;
  if (done) return kParseMore;
  do {
    const uint64_t chunk_start = start_;
    uint8_t fourcc[4];
    s_.get(start_, 4, fourcc);
    start_ += 4;
    const uint32_t payload = read(4);
    if (payload > kMaxChunkPayload) return kParseError;
    const uint32_t padded = payload + (payload & 1);
    const uint64_t available = std::min<uint64_t>(padded, data_size());
    const uint64_t chunk_size = kChunkHeader + available;
    if (size_invalid(padded)) return kParseError;
    if (padded > data_size()) status = kParseMore;
    const bool alph = !std::memcmp(fourcc, "ALPH", 4);
    const bool vp8l = !std::memcmp(fourcc, "VP8L", 4);
    const bool vp8 = !std::memcmp(fourcc, "VP8 ", 4);
    if (vp8l && alpha_chunks > 0) return kParseError;  // VP8L has its own
    if (alph && alpha_chunks == 0) {
      ++alpha_chunks;
      f.alpha_off = chunk_start;
      f.alpha_size = chunk_size;
      f.frame_num = frame_num;
      start_ += available;
    } else if ((vp8l || vp8) && image_chunks == 0) {
      // the bitstream's features, tolerating data cut short
      Features ft;
      const int vs = parse_headers(s_, chunk_start, chunk_size, &ft, nullptr);
      if (status == kParseMore && vs == kVpNotEnough) return kParseMore;
      if (vs != kVpOk) return kParseError;
      ++image_chunks;
      f.img_off = chunk_start;
      f.img_size = chunk_size;
      f.w = ft.w;
      f.h = ft.h;
      f.frame_num = frame_num;
      f.complete = status == kParseOk;
      start_ += available;
    } else {
      start_ -= kChunkHeader;  // up one level
      done = true;
    }
    if (start_ == riff_end_) {
      done = true;
    } else if (data_size() < kChunkHeader) {
      status = kParseMore;
    }
  } while (!done && status == kParseOk);
  return status;
}

int Demux::parse_single_image() {
  if (!frames.empty()) return kParseError;
  if (size_invalid(kChunkHeader)) return kParseError;
  if (data_size() < kChunkHeader) return kParseMore;
  Frame f;
  const int status = store_frame(1, 0, f);
  if (status == kParseError) return status;
  if (!(flags & kAlphaFlag) && f.alpha_size > 0) {
    f.alpha_off = 0;
    f.alpha_size = 0;
  }
  if (!is_ext_ && f.w > 0 && f.h > 0) {
    state_ = kParsedHeader;
    canvas_w = f.w;
    canvas_h = f.h;
  }
  if (!add_frame(f)) return kParseError;
  num_frames_ = 1;
  return status;
}

int Demux::parse_animation_frame(uint32_t frame_chunk_size) {
  const bool animation = flags & kAnimationFlag;
  const uint32_t anmf_payload = frame_chunk_size - kAnmfChunk;
  // NewFrame
  if (size_invalid(kAnmfChunk)) return kParseError;
  if (frame_chunk_size < kAnmfChunk) return kParseError;
  if (data_size() < kAnmfChunk) return kParseMore;
  Frame f;
  f.x = 2 * static_cast<int>(read(3));
  f.y = 2 * static_cast<int>(read(3));
  f.w = 1 + static_cast<int>(read(3));
  f.h = 1 + static_cast<int>(read(3));
  read(3);  // duration
  read(1);  // dispose and blend methods
  if (uint64_t(f.w) * uint64_t(f.h) >= kMaxImageArea) return kParseError;
  const uint64_t start = start_;
  int status = store_frame(num_frames_ + 1, anmf_payload, f);
  if (status != kParseError && start_ - start > anmf_payload)
    status = kParseError;
  if (status != kParseError && animation && f.frame_num > 0) {
    if (add_frame(f)) {
      ++num_frames_;
    } else {
      status = kParseError;
    }
  }
  return status;
}

int Demux::parse_vp8x_chunks() {
  const bool animation = flags & kAnimationFlag;
  int anim_chunks = 0, status = kParseOk;
  do {
    bool store = true;
    const uint64_t chunk_start = start_;
    uint8_t fourcc[4];
    s_.get(start_, 4, fourcc);
    start_ += 4;
    const uint32_t chunk_size = read(4);
    if (chunk_size > kMaxChunkPayload) return kParseError;
    const uint32_t padded = chunk_size + (chunk_size & 1);
    if (size_invalid(padded)) return kParseError;
    auto is = [&](const char* t) { return !std::memcmp(fourcc, t, 4); };
    bool skip = true;
    if (is("VP8X")) {
      return kParseError;
    } else if (is("ALPH") || is("VP8 ") || is("VP8L")) {
      if (anim_chunks > 0 || animation) return kParseError;
      start_ -= kChunkHeader;
      status = parse_single_image();
      skip = false;
    } else if (is("ANIM")) {
      if (padded < kAnimChunk) return kParseError;
      if (data_size() < padded) {
        status = kParseMore;
        skip = false;
      } else if (anim_chunks == 0) {
        ++anim_chunks;
        start_ += padded;  // background colour and loop count: unused here
        skip = false;
      } else {
        store = false;
      }
    } else if (is("ANMF")) {
      if (anim_chunks == 0) return kParseError;
      status = parse_animation_frame(padded);
      skip = false;
    } else if (is("ICCP")) {
      store = flags & kIccpFlag;
    } else if (is("EXIF")) {
      store = flags & kExifFlag;
    } else if (is("XMP ")) {
      store = flags & kXmpFlag;
    }
    if (skip) {
      if (padded <= data_size()) {
        if (store) chunks.push_back({chunk_start, kChunkHeader + chunk_size});
        start_ += padded;
      } else {
        status = kParseMore;
      }
    }
    if (start_ == riff_end_) break;
    if (data_size() < kChunkHeader) status = kParseMore;
  } while (status == kParseOk);
  return status;
}

int Demux::parse_vp8x() {
  if (data_size() < kChunkHeader) return kParseMore;
  is_ext_ = true;
  start_ += kTagSize;
  uint32_t vp8x_size = read(4);
  if (vp8x_size > kMaxChunkPayload) return kParseError;
  if (vp8x_size < kVp8xChunk) return kParseError;
  vp8x_size += vp8x_size & 1;
  if (size_invalid(vp8x_size)) return kParseError;
  if (data_size() < vp8x_size) return kParseMore;
  flags = read(1);
  start_ += 3;  // reserved
  canvas_w = 1 + static_cast<int>(read(3));
  canvas_h = 1 + static_cast<int>(read(3));
  if (uint64_t(canvas_w) * uint64_t(canvas_h) >= kMaxImageArea)
    return kParseError;
  start_ += vp8x_size - kVp8xChunk;
  state_ = kParsedHeader;
  if (size_invalid(kChunkHeader)) return kParseError;
  if (data_size() < kChunkHeader) return kParseMore;
  return parse_vp8x_chunks();
}

bool Demux::valid_simple() const {
  if (state_ == kParsingHeader) return true;
  if (canvas_w <= 0 || canvas_h <= 0) return false;
  if (state_ == kDemuxDone && frames.empty()) return false;
  return frames[0].w > 0 && frames[0].h > 0;
}

bool Demux::valid_extended() const {
  const bool animation = flags & kAnimationFlag;
  if (state_ == kParsingHeader) return true;
  if (canvas_w <= 0 || canvas_h <= 0) return false;
  if (state_ == kDemuxDone && frames.empty()) return false;
  if (flags & ~kAllValidFlags) return false;
  for (size_t i = 0; i < frames.size(); i++) {
    const Frame& f = frames[i];
    if (!animation && f.frame_num > 1) return false;
    if (f.complete) {
      if (f.alpha_size == 0 && f.img_size == 0) return false;
      if (f.alpha_size > 0 && f.alpha_off > f.img_off) return false;
      if (f.w <= 0 || f.h <= 0) return false;
    } else {
      if (state_ == kDemuxDone) return false;
      if (f.alpha_size > 0 && f.img_size > 0 && f.alpha_off > f.img_off)
        return false;
      if (i + 1 < frames.size()) return false;
    }
    if (f.w > 0 && f.h > 0) {
      if (!animation) {
        if (f.x != 0 || f.y != 0 || f.w != canvas_w || f.h != canvas_h)
          return false;
      } else if (f.x < 0 || f.y < 0 || f.w + f.x > canvas_w ||
                 f.h + f.y > canvas_h) {
        return false;
      }
    }
  }
  return true;
}

bool Demux::parse() {
  // ReadHeader (a raw VP8/VP8L stream, which WebPDemux also takes, holds
  // no frame offset and no metadata: no reader here asks it for either)
  const uint64_t n = s_.size();
  if (n == 0 || n < kRiffHeader + kChunkHeader) return false;
  if (!s_.tag(0, "RIFF") || !s_.tag(8, "WEBP")) return false;
  const uint32_t riff_size = s_.le(4, 4);
  if (riff_size < kChunkHeader || riff_size > kMaxChunkPayload) return false;
  riff_end_ = uint64_t{riff_size} + kChunkHeader;
  end_ = std::min(n, riff_end_);
  if (end_ < riff_end_) return false;  // partial data
  start_ = kRiffHeader;
  int status = kParseError;
  if (s_.tag(start_, "VP8 ") || s_.tag(start_, "VP8L")) {
    status = parse_single_image();
    if (status == kParseOk) state_ = kDemuxDone;
    if (status == kParseMore) status = kParseError;
    if (status != kParseError && !valid_simple()) status = kParseError;
  } else if (s_.tag(start_, "VP8X")) {
    status = parse_vp8x();
    if (status == kParseOk) state_ = kDemuxDone;
    if (status == kParseMore) status = kParseError;
    if (status != kParseError && !valid_extended()) status = kParseError;
  }
  return status != kParseError;
}

// The frame payload WebPDemuxGetFrame hands over: the image chunk, from
// its ALPH chunk where it has one.
void frame_payload(const Frame& f, uint64_t* off, uint64_t* size) {
  *off = f.img_off;
  *size = f.img_size;
  if (f.alpha_size > 0) {
    const uint64_t inter =
        f.img_off > 0 ? f.img_off - (f.alpha_off + f.alpha_size) : 0;
    *off = f.alpha_off;
    *size += f.alpha_size + inter;
  }
}

// --------------------------------------------------------------- VP8L

// The VP8L bit reader: bits least significant first, zeros past the
// buffer; the decode fails once it has read more than the buffer's bits
// (VP8LIsEndOfStream: past the last of 64 loaded bits where the buffer is
// shorter).
class Bits {
 public:
  Bits(const uint8_t* d, size_t n)
      : d_(d), n_(n), limit_(std::max<uint64_t>(uint64_t{n} * 8, 64)) {}
  uint32_t peek(int k) const {
    const uint64_t i = pos_ >> 3;
    uint64_t v = 0;
    if (i + 8 <= n_) {
      std::memcpy(&v, d_ + i, 8);  // little-endian hosts
    } else {
      for (uint64_t j = i; j < n_ && j < i + 8; j++)
        v |= uint64_t{d_[j]} << 8 * (j - i);
    }
    return static_cast<uint32_t>((v >> (pos_ & 7)) &
                                 ((uint64_t{1} << k) - 1));
  }
  uint32_t read(int k) {
    const uint32_t v = peek(k);
    pos_ += k;
    return v;
  }
  void skip(int k) { pos_ += k; }
  bool eos() const { return pos_ > limit_; }

 private:
  const uint8_t* d_;
  uint64_t n_, limit_, pos_ = 0;
};

struct HCode {
  uint8_t bits;
  uint16_t value;
};
using HTable = std::vector<HCode>;

constexpr int kMaxCodeLength = 15;

uint32_t next_key(uint32_t key, int len) {
  uint32_t step = 1u << (len - 1);
  while (key & step) step >>= 1;
  return step ? (key & (step - 1)) + step : key;
}

void replicate(HCode* table, int step, int end, HCode code) {
  do {
    end -= step;
    table[end] = code;
  } while (end > 0);
}

// huffman_utils.c's BuildHuffmanTable: the table (root_bits wide, then
// second-level tables) of the canonical code of `lens`, its size; 0 where
// the lengths are all 0, over-subscribed or incomplete (one symbol of any
// length is a 0-bit code). `t` null: the check alone.
int build_table(HTable* t, int root_bits, const int* lens, int n) {
  int count[kMaxCodeLength + 1] = {};
  int offset[kMaxCodeLength + 1];
  for (int s = 0; s < n; s++) {
    if (lens[s] > kMaxCodeLength) return 0;
    ++count[lens[s]];
  }
  if (count[0] == n) return 0;
  offset[1] = 0;
  for (int len = 1; len < kMaxCodeLength; ++len) {
    if (count[len] > (1 << len)) return 0;
    offset[len + 1] = offset[len] + count[len];
  }
  std::vector<uint16_t> sorted(n);
  for (int s = 0; s < n; s++)
    if (lens[s] > 0) sorted[offset[lens[s]]++] = static_cast<uint16_t>(s);
  int total_size = 1 << root_bits;
  if (offset[kMaxCodeLength] == 1) {
    if (t) {
      t->assign(total_size, HCode{0, sorted[0]});
    }
    return total_size;
  }
  // the check and the size first (no table), then the table
  for (int pass = 1; pass >= (t ? 0 : 1); pass--) {
    const bool fill = pass == 0;
    int cnt[kMaxCodeLength + 1];
    std::memcpy(cnt, count, sizeof cnt);
    HCode* table = nullptr;
    if (fill) {
      t->assign(total_size, HCode{0, 0});
      table = t->data();
    }
    int total = 1 << root_bits;
    uint32_t low = 0xffffffffu, key = 0;
    const uint32_t mask = (1u << root_bits) - 1;
    int num_nodes = 1, num_open = 1, table_bits = root_bits;
    int table_size = 1 << table_bits, symbol = 0;
    size_t table_at = 0;
    int step = 2;
    for (int len = 1; len <= root_bits; ++len, step <<= 1) {
      num_open <<= 1;
      num_nodes += num_open;
      num_open -= cnt[len];
      if (num_open < 0) return 0;
      if (!fill) continue;
      for (; cnt[len] > 0; --cnt[len]) {
        replicate(table + key, step, table_size,
                  HCode{static_cast<uint8_t>(len), sorted[symbol++]});
        key = next_key(key, len);
      }
    }
    step = 2;
    for (int len = root_bits + 1; len <= kMaxCodeLength; ++len, step <<= 1) {
      num_open <<= 1;
      num_nodes += num_open;
      num_open -= cnt[len];
      if (num_open < 0) return 0;
      for (; cnt[len] > 0; --cnt[len]) {
        if ((key & mask) != low) {
          table_at += table_size;
          table_bits = len - root_bits;  // NextTableBitSize
          {
            int left = 1 << table_bits, l = len;
            while (l < kMaxCodeLength) {
              left -= cnt[l];
              if (left <= 0) break;
              ++l;
              left <<= 1;
            }
            table_bits = l - root_bits;
          }
          table_size = 1 << table_bits;
          total += table_size;
          low = key & mask;
          if (fill) {
            t->resize(total);
            table = t->data();
            (*t)[low].bits = static_cast<uint8_t>(table_bits + root_bits);
            (*t)[low].value = static_cast<uint16_t>(table_at - low);
          }
        }
        if (fill)
          replicate(table + table_at + (key >> root_bits), step, table_size,
                    HCode{static_cast<uint8_t>(len - root_bits),
                          sorted[symbol++]});
        key = next_key(key, len);
      }
    }
    if (num_nodes != 2 * offset[kMaxCodeLength] - 1) return 0;
    total_size = total;
  }
  return total_size;
}

// ReadSymbol over a table of `root_bits` root entries.
inline int read_symbol(const HCode* t, Bits& br, int root_bits = 8) {
  uint32_t val = br.peek(root_bits + 7);
  const HCode* e = t + (val & ((1u << root_bits) - 1));
  const int nbits = e->bits - root_bits;
  if (nbits > 0) {
    br.skip(root_bits);
    val = br.peek(nbits);
    e += e->value + (val & ((1u << nbits) - 1));
  }
  br.skip(e->bits);
  return e->value;
}

constexpr int kNumLiteral = 256, kNumLength = 24, kNumDistance = 40;
constexpr int kAlphabet[5] = {kNumLiteral + kNumLength, kNumLiteral,
                              kNumLiteral, kNumLiteral, kNumDistance};
constexpr int kMaxCacheBits = 11;
constexpr int kCodeLengthOrder[19] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                      7,  8,  9, 10, 11, 12, 13, 14, 15};

// The distance map: (dx, dy) of the first 120 distance codes, as the
// spec lists them (dx + dy * width, at least 1).
constexpr int8_t kPlane[120][2] = {
    {0, 1},  {1, 0},  {1, 1},  {-1, 1}, {0, 2},  {2, 0},  {1, 2},  {-1, 2},
    {2, 1},  {-2, 1}, {2, 2},  {-2, 2}, {0, 3},  {3, 0},  {1, 3},  {-1, 3},
    {3, 1},  {-3, 1}, {2, 3},  {-2, 3}, {3, 2},  {-3, 2}, {0, 4},  {4, 0},
    {1, 4},  {-1, 4}, {4, 1},  {-4, 1}, {3, 3},  {-3, 3}, {2, 4},  {-2, 4},
    {4, 2},  {-4, 2}, {0, 5},  {3, 4},  {-3, 4}, {4, 3},  {-4, 3}, {5, 0},
    {1, 5},  {-1, 5}, {5, 1},  {-5, 1}, {2, 5},  {-2, 5}, {5, 2},  {-5, 2},
    {4, 4},  {-4, 4}, {3, 5},  {-3, 5}, {5, 3},  {-5, 3}, {0, 6},  {6, 0},
    {1, 6},  {-1, 6}, {6, 1},  {-6, 1}, {2, 6},  {-2, 6}, {6, 2},  {-6, 2},
    {4, 5},  {-4, 5}, {5, 4},  {-5, 4}, {3, 6},  {-3, 6}, {6, 3},  {-6, 3},
    {0, 7},  {7, 0},  {1, 7},  {-1, 7}, {5, 5},  {-5, 5}, {7, 1},  {-7, 1},
    {4, 6},  {-4, 6}, {6, 4},  {-6, 4}, {2, 7},  {-2, 7}, {7, 2},  {-7, 2},
    {3, 7},  {-3, 7}, {7, 3},  {-7, 3}, {5, 6},  {-5, 6}, {6, 5},  {-6, 5},
    {8, 0},  {4, 7},  {-4, 7}, {7, 4},  {-7, 4}, {8, 1},  {8, 2},  {6, 6},
    {-6, 6}, {8, 3},  {5, 7},  {-5, 7}, {7, 5},  {-7, 5}, {8, 4},  {6, 7},
    {-6, 7}, {7, 6},  {-7, 6}, {8, 5},  {7, 7},  {-7, 7}, {8, 6},  {8, 7}};

inline int subsample(int size, int bits) {
  return (size + (1 << bits) - 1) >> bits;
}

struct Group {
  std::array<HTable, 5> t;
};

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }

inline uint32_t add_sub_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int sh = 0; sh < 32; sh += 8) {
    const int a = (c0 >> sh) & 0xff, b = (c1 >> sh) & 0xff,
              c = (c2 >> sh) & 0xff;
    out |= (clip255(static_cast<uint32_t>(a + b - c)) & 0xff) << sh;
  }
  return out;
}

inline uint32_t add_sub_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int sh = 0; sh < 32; sh += 8) {
    const int a = (ave >> sh) & 0xff, b = (c2 >> sh) & 0xff;
    out |= (clip255(static_cast<uint32_t>(a + (a - b) / 2)) & 0xff) << sh;
  }
  return out;
}

inline int sub3(int a, int b, int c) {
  const int pb = b - c, pa = a - c;
  return std::abs(pb) - std::abs(pa);
}

inline uint32_t select(uint32_t a, uint32_t b, uint32_t c) {
  int s = 0;
  for (int sh = 0; sh < 32; sh += 8)
    s += sub3((a >> sh) & 0xff, (b >> sh) & 0xff, (c >> sh) & 0xff);
  return s <= 0 ? a : b;
}

// lossless.c's predictors 0-13 (14 and 15 as 0): `top` points at the pixel
// above, so top[1] of a row's last pixel is the row's first.
inline uint32_t predict(int mode, uint32_t left, const uint32_t* top) {
  switch (mode) {
    case 1: return left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(left, top[1]), top[0]);
    case 6: return average2(left, top[-1]);
    case 7: return average2(left, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(left, top[-1]), average2(top[0], top[1]));
    case 11: return select(top[0], left, top[-1]);
    case 12: return add_sub_full(left, top[0], top[-1]);
    case 13: return add_sub_half(left, top[0], top[-1]);
    default: return 0xff000000u;
  }
}

inline int color_delta(int8_t pred, int8_t color) {
  return (static_cast<int>(pred) * color) >> 5;
}

class Vp8l {
 public:
  Vp8l(const uint8_t* d, size_t n) : br_(d, n) {}
  // The image's sides and ARGB pixels; false where libwebp fails.
  bool decode(int* w, int* h, std::vector<uint32_t>& argb);
  // An ALPH chunk's image stream (no header) of w x h pixels; false where
  // libwebp fails (VP8LDecodeAlphaHeader, VP8LDecodeAlphaImageStream).
  bool decode_alpha(int w, int h);

 private:
  bool stream(int xsize, int ysize, bool level0, std::vector<uint32_t>* out);
  bool read_transform(int* xsize, int ysize);
  bool read_code(int alphabet, HTable* t);
  bool read_code_lengths(const int* cl, int num_symbols);
  bool data(uint32_t* px, int w, int h, int cache_bits,
            const std::vector<Group>& groups, int meta_bits,
            const std::vector<uint32_t>& meta, bool alpha8);
  void inverse(const Transform& t, const uint32_t* in, uint32_t* out) const;

  Bits br_;
  std::vector<Transform> transforms_;
  unsigned seen_ = 0;
  bool alpha_ = false;
  std::vector<int> lens_ = std::vector<int>(kNumLiteral + kNumLength +
                                            (1 << kMaxCacheBits));
};

bool Vp8l::read_code_lengths(const int* cl, int num_symbols) {
  HTable t;
  if (!build_table(&t, 7, cl, 19)) return false;
  int max_symbol = num_symbols;
  if (br_.read(1)) {
    const int nbits = 2 + 2 * static_cast<int>(br_.read(3));
    max_symbol = 2 + static_cast<int>(br_.read(nbits));
    if (max_symbol > num_symbols) return false;
  }
  int symbol = 0, prev = 8;
  while (symbol < num_symbols) {
    if (max_symbol-- == 0) break;
    const int len = read_symbol(t.data(), br_, 7);
    if (len < 16) {
      lens_[symbol++] = len;
      if (len != 0) prev = len;
    } else {
      static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
      const int slot = len - 16;
      int repeat = static_cast<int>(br_.read(kExtra[slot])) + kOffset[slot];
      if (symbol + repeat > num_symbols) return false;
      const int v = len == 16 ? prev : 0;
      while (repeat-- > 0) lens_[symbol++] = v;
    }
    if (br_.eos()) return false;
  }
  return true;
}

bool Vp8l::read_code(int alphabet, HTable* t) {
  std::fill(lens_.begin(), lens_.begin() + alphabet, 0);
  bool ok;
  if (br_.read(1)) {  // simple: 1 or 2 symbols, each of length 1
    const int num = static_cast<int>(br_.read(1)) + 1;
    const int first8 = static_cast<int>(br_.read(1));
    lens_[br_.read(first8 ? 8 : 1)] = 1;
    if (num == 2) lens_[br_.read(8)] = 1;
    ok = true;
  } else {
    int cl[19] = {};
    const int num = static_cast<int>(br_.read(4)) + 4;
    for (int i = 0; i < num; i++) cl[kCodeLengthOrder[i]] = br_.read(3);
    ok = read_code_lengths(cl, alphabet);
  }
  return ok && !br_.eos() && build_table(t, 8, lens_.data(), alphabet) != 0;
}

bool Vp8l::read_transform(int* xsize, int ysize) {
  Transform t;
  t.type = static_cast<int>(br_.read(2));
  if (seen_ & (1u << t.type)) return false;
  seen_ |= 1u << t.type;
  t.xsize = *xsize;
  t.ysize = ysize;
  bool ok = true;
  if (t.type == 0 || t.type == 1) {  // predictor, cross-colour
    t.bits = 2 + static_cast<int>(br_.read(3));
    ok = stream(subsample(t.xsize, t.bits), subsample(t.ysize, t.bits), false,
                &t.data);
  } else if (t.type == 3) {  // colour indexing
    const int num = static_cast<int>(br_.read(8)) + 1;
    t.bits = num > 16 ? 0 : num > 4 ? 1 : num > 2 ? 2 : 3;
    *xsize = subsample(t.xsize, t.bits);
    ok = stream(num, 1, false, &t.data);
    if (ok) {  // ExpandColorMap: the deltas summed, the rest 0
      std::vector<uint32_t> map(size_t{1} << (8 >> t.bits), 0);
      map[0] = t.data[0];
      for (int i = 1; i < num; i++) map[i] = add_pixels(t.data[i], map[i - 1]);
      t.data.swap(map);
    }
  }
  transforms_.push_back(std::move(t));
  return ok;
}

// The entropy-coded pixels. `alpha8`: DecodeAlphaData's rule, which fails
// on a read past the data only before the last pixel (DecodeImageData's
// fails on any).
bool Vp8l::data(uint32_t* px, int w, int h, int cache_bits,
                const std::vector<Group>& groups, int meta_bits,
                const std::vector<uint32_t>& meta, bool alpha8) {
  const int64_t n = int64_t{w} * h;
  std::vector<uint32_t> cache(cache_bits ? size_t{1} << cache_bits : 0, 0);
  const int shift = 32 - cache_bits;
  const int meta_xsize = meta_bits ? subsample(w, meta_bits) : 0;
  int64_t pos = 0, cached = 0;
  int x = 0, y = 0;
  while (pos < n) {
    const Group& g =
        meta_bits ? groups[meta[size_t(y >> meta_bits) * meta_xsize +
                                (x >> meta_bits)]]
                  : groups[0];
    const int code = read_symbol(g.t[0].data(), br_);
    if (br_.eos() && !alpha8) return false;
    if (code < kNumLiteral) {
      const uint32_t r = read_symbol(g.t[1].data(), br_);
      const uint32_t b = read_symbol(g.t[2].data(), br_);
      const uint32_t a = read_symbol(g.t[3].data(), br_);
      if (br_.eos() && (!alpha8 || pos + 1 < n)) return false;
      px[pos++] = a << 24 | r << 16 | uint32_t(code) << 8 | b;
      if (++x >= w) {
        x = 0;
        ++y;
      }
    } else if (code < kNumLiteral + kNumLength) {
      auto copy_value = [&](int sym) {  // GetCopyDistance / GetCopyLength
        if (sym < 4) return sym + 1;
        const int extra = (sym - 2) >> 1;
        const int offset = (2 + (sym & 1)) << extra;
        return offset + static_cast<int>(br_.read(extra)) + 1;
      };
      const int length = copy_value(code - kNumLiteral);
      const int dist_code = copy_value(read_symbol(g.t[4].data(), br_));
      int64_t dist;
      if (dist_code > 120) {
        dist = dist_code - 120;
      } else {
        dist = int64_t{kPlane[dist_code - 1][1]} * w + kPlane[dist_code - 1][0];
        if (dist < 1) dist = 1;
      }
      if (br_.eos() && !alpha8) return false;
      if (pos < dist || n - pos < length) return false;
      for (int i = 0; i < length; i++) px[pos + i] = px[pos + i - dist];
      pos += length;
      if (br_.eos() && pos < n) return false;
      x += length;
      while (x >= w) {
        x -= w;
        ++y;
      }
    } else {  // colour cache: every pixel before this one inserted
      for (; cached < pos; ++cached)
        cache[(px[cached] * 0x1e35a7bdu) >> shift] = px[cached];
      px[pos++] = cache[code - kNumLiteral - kNumLength];
      if (++x >= w) {
        x = 0;
        ++y;
      }
    }
  }
  return alpha8 || !br_.eos();
}

// DecodeImageStream: `level0` reads the transforms and may read meta codes;
// the sub-images (transform data, entropy image, palette) do neither.
bool Vp8l::stream(int xsize, int ysize, bool level0,
                  std::vector<uint32_t>* out) {
  int txsize = xsize;
  if (level0) {
    while (br_.read(1)) {
      if (br_.eos() || !read_transform(&txsize, ysize)) return false;
    }
  }
  int cache_bits = 0;
  if (br_.read(1)) {
    cache_bits = static_cast<int>(br_.read(4));
    if (cache_bits < 1 || cache_bits > kMaxCacheBits) return false;
  }
  // ReadHuffmanCodes
  int meta_bits = 0, max_groups = 1;
  std::vector<uint32_t> meta;
  if (level0 && br_.read(1)) {
    const int bits = 2 + static_cast<int>(br_.read(3));
    if (!stream(subsample(txsize, bits), subsample(ysize, bits), false, &meta))
      return false;
    meta_bits = bits;
    for (uint32_t& v : meta) {
      v = (v >> 8) & 0xffff;
      max_groups = std::max<int>(max_groups, v + 1);
    }
  }
  if (br_.eos()) return false;
  // the groups the entropy image uses, in order of first use; the others
  // are read and checked, not kept
  std::vector<int> map(max_groups, -1);
  int num_groups = 0;
  if (meta.empty()) {
    map[0] = num_groups++;
  } else {
    for (uint32_t& v : meta) {
      if (map[v] < 0) map[v] = num_groups++;
      v = map[v];
    }
  }
  std::vector<Group> groups(num_groups);
  for (int i = 0; i < max_groups; i++) {
    for (int j = 0; j < 5; j++) {
      const int alphabet =
          kAlphabet[j] + (j == 0 && cache_bits ? 1 << cache_bits : 0);
      if (!read_code(alphabet, map[i] >= 0 ? &groups[map[i]].t[j] : nullptr))
        return false;
    }
  }
  const size_t total = size_t(txsize) * ysize;
  std::unique_ptr<uint32_t[]> px(new (std::nothrow) uint32_t[total]);
  if (!px) return false;
  // Is8bOptimizable: an alpha stream of colour indexing alone, no cache and
  // one symbol in each red, blue and alpha code
  bool alpha8 = alpha_ && level0 && transforms_.size() == 1 &&
                transforms_[0].type == 3 && cache_bits == 0;
  for (const Group& g : groups)
    for (int j : {1, 2, 3}) alpha8 = alpha8 && g.t[j][0].bits == 0;
  if (!data(px.get(), txsize, ysize, cache_bits, groups, meta_bits, meta,
            alpha8))
    return false;
  if (!level0) {
    out->assign(px.get(), px.get() + total);
    return true;
  }
  // the inverse transforms, last read first
  std::unique_ptr<uint32_t[]> cur = std::move(px);
  for (size_t k = transforms_.size(); k-- > 0;) {
    const Transform& t = transforms_[k];
    if (t.type == 2 || t.type == 1) {  // in place
      inverse(t, cur.get(), cur.get());
      continue;
    }
    std::unique_ptr<uint32_t[]> next(
        new (std::nothrow) uint32_t[size_t(t.xsize) * t.ysize]);
    if (!next) return false;
    inverse(t, cur.get(), next.get());
    cur = std::move(next);
  }
  out->assign(cur.get(), cur.get() + size_t(xsize) * ysize);
  return true;
}

void Vp8l::inverse(const Transform& t, const uint32_t* in,
                   uint32_t* out) const {
  const int w = t.xsize, h = t.ysize;
  if (t.type == 2) {  // subtract green
    for (size_t i = 0, n = size_t(w) * h; i < n; i++) {
      const uint32_t argb = in[i], g = (argb >> 8) & 0xff;
      const uint32_t rb = ((argb & 0x00ff00ffu) + (g << 16 | g)) & 0x00ff00ffu;
      out[i] = (argb & 0xff00ff00u) | rb;
    }
  } else if (t.type == 0) {  // predictor
    const int tiles = subsample(w, t.bits);
    out[0] = add_pixels(in[0], 0xff000000u);
    for (int x = 1; x < w; x++) out[x] = add_pixels(in[x], out[x - 1]);
    for (int y = 1; y < h; y++) {
      const uint32_t* modes = t.data.data() + size_t(y >> t.bits) * tiles;
      uint32_t* o = out + size_t(y) * w;
      const uint32_t* i = in + size_t(y) * w;
      o[0] = add_pixels(i[0], o[-w]);
      for (int x = 1; x < w; x++) {
        const int mode = (modes[x >> t.bits] >> 8) & 0xf;
        o[x] = add_pixels(i[x], predict(mode, o[x - 1], o + x - w));
      }
    }
  } else if (t.type == 1) {  // cross colour
    const int tiles = subsample(w, t.bits);
    for (int y = 0; y < h; y++) {
      const uint32_t* codes = t.data.data() + size_t(y >> t.bits) * tiles;
      for (int x = 0; x < w; x++) {
        const uint32_t c = codes[x >> t.bits];
        const int8_t g2r = static_cast<int8_t>(c & 0xff);
        const int8_t g2b = static_cast<int8_t>((c >> 8) & 0xff);
        const int8_t r2b = static_cast<int8_t>((c >> 16) & 0xff);
        const size_t i = size_t(y) * w + x;
        const uint32_t argb = in[i];
        const int8_t green = static_cast<int8_t>(argb >> 8);
        int red = (argb >> 16) & 0xff, blue = argb & 0xff;
        red = (red + color_delta(g2r, green)) & 0xff;
        blue += color_delta(g2b, green);
        blue += color_delta(r2b, static_cast<int8_t>(red));
        blue &= 0xff;
        out[i] = (argb & 0xff00ff00u) | uint32_t(red) << 16 | uint32_t(blue);
      }
    }
  } else {  // colour indexing: `in` at the bundled width
    const int bits = t.bits, bpp = 8 >> bits, packed_w = subsample(w, bits);
    const uint32_t count_mask = (1u << bits) - 1, bit_mask = (1u << bpp) - 1;
    for (int y = 0; y < h; y++) {
      const uint32_t* src = in + size_t(y) * packed_w;
      uint32_t* dst = out + size_t(y) * w;
      uint32_t packed = 0;
      for (int x = 0; x < w; x++) {
        if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
        dst[x] = t.data[packed & bit_mask];
        packed >>= bpp;
      }
    }
  }
}

bool Vp8l::decode_alpha(int w, int h) {
  alpha_ = true;
  std::vector<uint32_t> argb;
  return stream(w, h, true, &argb);
}

bool Vp8l::decode(int* w, int* h, std::vector<uint32_t>& argb) {
  if (br_.read(8) != 0x2f) return false;
  *w = static_cast<int>(br_.read(14)) + 1;
  *h = static_cast<int>(br_.read(14)) + 1;
  br_.read(1);  // alpha_is_used: a hint
  if (br_.read(3) != 0 || br_.eos()) return false;
  return stream(*w, *h, true, &argb);
}

// ------------------------------------------------------------ readers

// Where a reader finds the image it decodes.
struct Layout {
  int canvas_w = 0, canvas_h = 0;  // the image, or an animation's canvas
  int x = 0, y = 0, w = 0, h = 0;  // the first frame on the canvas
  uint64_t payload = 0, length = 0;  // the decoder's data
  bool lossless = true;
  bool alpha = false;  // a lossy image's ALPH payload
  uint64_t alpha_off = 0, alpha_size = 0;
  int orientation = 1;
};

// The headers' findings for the decoder of the data at `off` onwards.
void take_headers(const Headers& hd, uint64_t off, uint64_t size, Layout& l) {
  l.payload = off + hd.offset;
  l.length = size - hd.offset;
  l.lossless = hd.lossless;
  l.alpha = hd.alpha;
  l.alpha_off = hd.alpha_off;
  l.alpha_size = hd.alpha_size;
}

// WebPDecode of the frame payload at `off` (WebPAnimDecoderGetNext): the
// features (data short of them refused), then the headers.
bool frame_decode_layout(const Src& s, uint64_t off, uint64_t size,
                         Layout& l) {
  Features ft;
  if (parse_headers(s, off, size, &ft, nullptr) != kVpOk) return false;
  Headers hd;
  if (parse_headers(s, off, size, nullptr, &hd) != kVpOk) return false;
  take_headers(hd, off, size, l);
  return true;
}

// WebPAnimDecoderNew (the features, then WebPDemux): false where it fails;
// else the canvas.
bool anim_new(const Src& s, Demux& dm, Layout& l) {
  Features ft;
  if (parse_headers(s, 0, s.size(), &ft, nullptr) != kVpOk) return false;
  if (!dm.parse() || dm.frames.empty()) return false;
  l.canvas_w = dm.canvas_w;
  l.canvas_h = dm.canvas_h;
  return true;
}

// WebPAnimDecoderGetNext's first frame: its place on the canvas and its
// payload's headers (the pixels are not read here); false where they fail.
bool first_frame(const Src& s, const Demux& dm, Layout& l) {
  const Frame& f = dm.frames[0];
  l.x = f.x;
  l.y = f.y;
  l.w = f.w;
  l.h = f.h;
  uint64_t off, size;
  frame_payload(f, &off, &size);
  return frame_decode_layout(s, off, size, l);
}

// EXIF orientation as OpenCV reads it: the first EXIF chunk WebPDemux
// stores (the VP8X flag set), a TIFF stream; 1 where the demux refuses.
int exif_orientation(const Src& s, Demux& dm, bool parsed) {
  if (!parsed && !dm.parse()) return 1;
  for (const Chunk& c : dm.chunks) {
    if (!s.tag(c.off, "EXIF")) continue;
    std::vector<uint8_t> exif(c.size - kChunkHeader);
    if (!exif.empty()) s.get(c.off + kChunkHeader, exif.size(), exif.data());
    return tiff_orientation(exif.data(), exif.size());
  }
  return 1;
}

// cv2.imread's WebPDecoder: kOk with the layout, kUnreadable where it
// gives None, kRaises where imread raises (its size rule).
int cv2_layout(const Src& s, Layout& l) {
  const uint64_t n = s.size();
  if (n < kCv2Header) return kUnreadable;
  Features ft;
  uint8_t head[kCv2Header];
  s.get(0, kCv2Header, head);
  const MemSrc h32(head, kCv2Header);
  if (parse_headers(h32, 0, kCv2Header, &ft, nullptr) != kVpOk)
    return kUnreadable;  // not WebP to cv2's signature check
  if (n > kCv2MaxFile) return kUnreadable;
  Demux dm(s);
  if (ft.animation && !anim_new(s, dm, l)) return kUnreadable;  // readHeader
  if (!cv2_size_ok(ft.w, ft.h)) return kRaises;
  if (ft.animation) {  // readData
    if (!first_frame(s, dm, l)) return kUnreadable;
  } else {
    Headers hd;
    if (parse_headers(s, 0, n, nullptr, &hd) != kVpOk) return kUnreadable;
    l.canvas_w = l.w = ft.w;
    l.canvas_h = l.h = ft.h;
    take_headers(hd, 0, n, l);
  }
  l.orientation = exif_orientation(s, dm, ft.animation);
  return kOk;
}

// PIL's WebPImagePlugin (its _accept, then WebPAnimDecoder): kOk with the
// layout, or kUnreadable.
int pil_layout(const Src& s, Layout& l) {
  if (s.size() < 16 || !s.tag(0, "RIFF") || !s.tag(8, "WEBP") ||
      !(s.tag(12, "VP8 ") || s.tag(12, "VP8L") || s.tag(12, "VP8X")))
    return kUnreadable;
  Demux dm(s);
  if (!anim_new(s, dm, l) || !pil_size_ok(l.canvas_w, l.canvas_h) ||
      !first_frame(s, dm, l))
    return kUnreadable;
  return kOk;
}

// alpha_dec.c's ALPHInit and ALPHDecode on an ALPH payload of a w x h
// frame: true where they succeed (the alpha itself is dropped).
bool alpha_decodes(const uint8_t* a, uint64_t n, int w, int h) {
  if (n <= 1) return false;
  const int method = a[0] & 3, pre_processing = (a[0] >> 4) & 3;
  if (method > 1 || pre_processing > 1 || (a[0] >> 6) != 0) return false;
  if (method == 0) return n - 1 >= uint64_t(w) * h;
  return Vp8l(a + 1, n - 1).decode_alpha(w, h);
}

// The first frame on its zeroed canvas as RGB, oriented.
int render(const uint8_t* d, const Layout& l, Image& img) {
  if (!l.lossless) {
    Vp8Planes f;
    if (!vp8_decode(d + l.payload, l.length, true, f) || f.w != l.w ||
        f.h != l.h)
      return kUnreadable;
    if (l.alpha && !alpha_decodes(d + l.alpha_off, l.alpha_size, f.w, f.h))
      return kUnreadable;
    img.w = l.canvas_w;
    img.h = l.canvas_h;
    img.rgb.assign(size_t(img.w) * img.h * 3, 0);
    vp8_rgb(f, true, &img.rgb[(size_t(l.y) * img.w + l.x) * 3],
            size_t(img.w) * 3);
    apply_orientation(img, l.orientation);
    return kOk;
  }
  int w, h;
  std::vector<uint32_t> argb;
  Vp8l dec(d + l.payload, l.length);
  if (!dec.decode(&w, &h, argb) || w != l.w || h != l.h) return kUnreadable;
  img.w = l.canvas_w;
  img.h = l.canvas_h;
  img.rgb.assign(size_t(img.w) * img.h * 3, 0);
  for (int y = 0; y < h; y++) {
    uint8_t* o = &img.rgb[(size_t(l.y + y) * img.w + l.x) * 3];
    const uint32_t* p = &argb[size_t(y) * w];
    for (int x = 0; x < w; x++) {
      o[3 * x] = (p[x] >> 16) & 0xff;
      o[3 * x + 1] = (p[x] >> 8) & 0xff;
      o[3 * x + 2] = p[x] & 0xff;
    }
  }
  apply_orientation(img, l.orientation);
  return kOk;
}

void oriented_dims(const Layout& l, int* dims) {
  const bool t = l.orientation >= 5;
  dims[0] = t ? l.canvas_w : l.canvas_h;
  dims[1] = t ? l.canvas_h : l.canvas_w;
}

// A reader's Status; kOk with the (h, w) it gives and, with `img`, the
// pixels (`head`: the headers alone; the cv2 probe decodes, keeping none).
int finish(const uint8_t* d, int st, const Layout& l, Image* img, int* dims,
           bool head) {
  if (st != kOk) return st;
  if (!head) {
    Image tmp;
    if (render(d, l, img ? *img : tmp) != kOk) return kUnreadable;
  }
  oriented_dims(l, dims);
  return kOk;
}

}  // namespace

bool is_webp_data(const uint8_t* d, size_t n) {
  if ((n >= 12 && !std::memcmp(d, "RIFF", 4) &&
       !std::memcmp(d + 8, "WEBP", 4)) ||
      (n >= 5 && d[0] == 0x2f && (d[4] >> 5) == 0))
    return true;
  // cv2's signature check: WebPGetFeatures on the first 32 bytes
  if (n < kCv2Header) return false;
  try {
    const MemSrc h32(d, kCv2Header);
    Features ft;
    return parse_headers(h32, 0, kCv2Header, &ft, nullptr) == kVpOk;
  } catch (const Short&) {
    return false;
  }
}

int webp_cv2(const uint8_t* d, size_t n, Image* img, int* dims, bool head) {
  try {
    const MemSrc s(d, n);
    Layout l;
    return finish(d, cv2_layout(s, l), l, img, dims, head);
  } catch (const Short&) {
    return kUnreadable;
  }
}

int webp_pil(const uint8_t* d, size_t n, Image* img, int* dims, bool head) {
  try {
    const MemSrc s(d, n);
    Layout l;
    return finish(d, pil_layout(s, l), l, img, dims, head);
  } catch (const Short&) {
    return kUnreadable;
  }
}

bool webp_lossy_planes(const uint8_t* d, size_t n, bool filter, bool rgb,
                       bool fancy, uint8_t* out, size_t cap, int* dims) {
  try {
    const MemSrc s(d, n);
    Layout l;
    if (cv2_layout(s, l) != kOk || l.lossless || l.w != l.canvas_w)
      return false;
    Vp8Planes f;
    if (!vp8_decode(d + l.payload, l.length, filter, f)) return false;
    const size_t w = f.w, h = f.h, uw = (w + 1) / 2, uh = (h + 1) / 2;
    dims[0] = f.h;
    dims[1] = f.w;
    if (rgb) {
      if (cap < w * h * 3) return false;
      vp8_rgb(f, fancy, out, w * 3);
      return true;
    }
    if (cap < w * h + 2 * uw * uh) return false;
    for (size_t y = 0; y < h; y++)
      std::memcpy(out + y * w, &f.y[y * f.y_stride], w);
    for (size_t y = 0; y < uh; y++) {
      std::memcpy(out + w * h + y * uw, &f.u[y * f.uv_stride], uw);
      std::memcpy(out + w * h + uw * uh + y * uw, &f.v[y * f.uv_stride], uw);
    }
    return true;
  } catch (const Short&) {
    return false;
  }
}

int probe_webp(FILE* f, int* dims) {
  try {
    if (fseeko(f, 0, SEEK_END) != 0) return kUnreadable;
    const off_t n = ftello(f);
    if (n < 0) return kUnreadable;
    const FileSrc s(f, static_cast<uint64_t>(n));
    Layout l;
    int st = cv2_layout(s, l);
    if (st == kUnreadable) {
      l = Layout();
      st = pil_layout(s, l);
    }
    if (st == kOk) oriented_dims(l, dims);
    return st;
  } catch (const Short&) {
    return kUnreadable;
  }
}

}  // namespace tsrio
