// codec.h — what tsrio.cpp, jpeg.cpp, formats.cpp, gif.cpp, hdr.cpp,
// tiff.cpp, webp.cpp, vp8.cpp and jpeg2000.cpp share: the decoded image,
// the image-size rules, the status codes a decode or a header probe returns, the JPEG
// codec's entry points, the PNG/PNM/PFM/PAM/BMP/Sun raster, GIF, Radiance
// HDR, TIFF, WebP and JPEG 2000 readers, the VP8 decoder and the EXIF
// orientation JPEG, PNG, TIFF and WebP carry.
#pragma once

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <vector>

namespace tsrio {

struct Image {
  int w = 0, h = 0;
  std::vector<uint8_t> rgb;  // HWC
};

// imread's validateInputImageSize: each side 1 to 2^20 and at most 2^30
// pixels. It runs once the format's own header parser has accepted the
// numbers; past it cv2.imread raises (kRaises), it does not give None.
inline bool cv2_size_ok(int64_t w, int64_t h) {
  return w > 0 && h > 0 && w <= (1 << 20) && h <= (1 << 20) &&
         w * h <= (int64_t{1} << 30);
}

// Pillow's Image.open raises DecompressionBombError past 2 x
// Image.MAX_IMAGE_PIXELS (89,478,485): the PIL readers refuse such images.
constexpr int64_t kPilMaxPixels = 2 * 89478485LL;
inline bool pil_size_ok(int64_t w, int64_t h) {
  return w > 0 && h > 0 && w * h <= kPilMaxPixels;
}

// cv::saturate_cast<uchar>(float), cvRound's half to even then clamped;
// NaN, infinities and values past the int range convert to INT_MIN, so
// read 0 (PFM and Radiance HDR samples on their way to 8 bits).
inline uint8_t cv2_u8(float v) {
  if (!(v > -2147483648.0f && v < 2147483648.0f)) return 0;
  const float r = std::nearbyint(v);
  return r <= 0.0f ? 0 : r >= 255.0f ? 255 : static_cast<uint8_t>(r);
}

// Pillow's cmyk2rgb (Convert.c), which convert("RGB") of a CMYK image
// runs: nk - round(v nk / 255) for each of C, M, Y, with nk = 255 - K.
inline void cmyk_to_rgb(int c, int m, int y, int k, uint8_t* o) {
  const int nk = 255 - k, v[3] = {c, m, y};
  for (int i = 0; i < 3; i++) {
    const int tmp = v[i] * nk + 128;
    o[i] = static_cast<uint8_t>(std::clamp(nk - (((tmp >> 8) + tmp) >> 8), 0, 255));
  }
}

// A decode's or a probe's outcome. kOk and kUnreadable (not an image the
// library knows, or data that neither cv2.imread nor PIL reads) are the
// first two; kRaises marks a file on which cv2.imread raises (a header
// whose size imread's validateInputImageSize refuses): the reference reads
// no pixels of it and does not fall back to PIL. Each negative code down to
// kLosslessColor names a feature of
// a valid JPEG that the library does not implement (neither cv2.imread nor
// PIL reads any of them), each below it down to kAvif a format, told by its
// signature, that cv2.imread reads and the library does not decode, and
// each below that one that only PIL reads.
// tsr_tpu_torch/native/__init__.py mirrors the negative codes in FEATURES
// and FORMATS, in this order.
enum Status : int {
  kRaises = 2,  // cv2.imread raises: the reference reads no pixels
  kOk = 1,
  kUnreadable = 0,
  kPrecision = -1,           // JPEG sample precision other than 8 bits
  kHierarchical = -2,        // hierarchical JPEG (SOF5-7, SOF13-15, DHP, EXP)
  kComponents = -3,          // a JPEG of 2 or more than 4 components
  kLosslessArithmetic = -4,  // lossless JPEG, arithmetic coded (SOF11)
  kLosslessColor = -5,       // lossless JPEG in YCbCr or YCCK
  kTiff = -6,
  kJpeg2000 = -7,
  kAvif = -8,
  // formats only PIL reads, which the library does not decode (told by
  // Pillow's own checks of their first bytes)
  kPcx = -9,
  kSgi = -10,
  kIco = -11,  // ICO or CUR
  kDds = -12,
  kQoi = -13,
  kIcns = -14,
  kMsp = -15,
  kIm = -16,
  kSpider = -17,
};

// True where `data` starts as a JPEG file does (SOI, then a marker).
bool is_jpeg(const uint8_t* data, size_t n);

// Decodes a whole JPEG file to RGB as libjpeg-turbo's default integer path
// does for cv2.imread (islow IDCT, fancy upsampling, fixed-point
// YCbCr->RGB, damaged data recovered as libjpeg recovers it), with EXIF
// orientation applied as cv2.imread applies it; a gray lossless JPEG as
// libjpeg-turbo decodes it for PIL, where cv2.imread refuses it.
int decode_jpeg(const uint8_t* data, size_t n, Image& img);

// What cv2.imread makes of a JPEG file: kOk where it reads it, with the
// image's (h, w) in dims, else the Status decode_jpeg gives (kUnreadable
// for a gray lossless file, which only PIL reads). The markers and the
// entropy data are decoded (libjpeg's errors come from both); the IDCT,
// upsampling and color conversion are skipped.
int check_jpeg(const uint8_t* data, size_t n, int* dims);

// (h, w) of a JPEG as decode_jpeg returns it (EXIF orientation applied),
// from the markers before the first scan; reads the file from its start.
int probe_jpeg(FILE* f, int* dims);

// cv2.imwrite(path, bgr)'s bytes for an RGB image: baseline JFIF at
// quality 95, 4:2:0, standard Huffman tables (libjpeg-turbo's defaults).
void encode_jpeg(const uint8_t* rgb, int w, int h, std::vector<uint8_t>& out);

// JPEG-in-TIFF as libtiff's JPEG codec drives libjpeg-turbo (tif_jpeg.c):
// one decompressor a file, whose quantisation and Huffman tables carry from
// stream to stream. Each stream decodes as decode_jpeg decodes a file (no
// EXIF orientation), its components as stored, or YCbCr turned to RGB.
class TiffJpeg {
 public:
  struct Frame {
    int w = 0, h = 0, ncomp = 0;
    int hs[4] = {}, vs[4] = {};  // each component's sampling factors
  };
  TiffJpeg();
  ~TiffJpeg();
  TiffJpeg(const TiffJpeg&) = delete;
  TiffJpeg& operator=(const TiffJpeg&) = delete;
  // The JPEGTables stream (jpeg_read_header(FALSE)): false where it is no
  // tables-only stream ("Bogus JPEGTables field").
  bool tables(const uint8_t* data, size_t n);
  // A strip's or tile's stream up to its first scan (jpeg_read_header(TRUE));
  // false where libjpeg fails.
  bool header(const uint8_t* data, size_t n, Frame& f);
  // jpeg_start_decompress and every row of the stream whose header was
  // read: the frame's samples, interleaved (RGB from YCbCr where `rgb`);
  // false where libjpeg fails first.
  bool decode(bool rgb, std::vector<uint8_t>& out);
  // jpeg_finish_decompress: reads on to EOI (tables it meets are kept; an
  // error there, which libtiff ignores, stops it).
  void finish();

 private:
  struct Impl;
  Impl* p_;
};

// Old-style JPEG in TIFF as libtiff's codec (tif_ojpeg.c) drives
// libjpeg-turbo over the stream it writes itself from the file's tables
// and data (`bounds`: the ends of the buffers it hands libjpeg; `dry`: the
// data runs out with an error, not an EOI): -1 where jpeg_read_header or
// jpeg_start_decompress fail, else 1 with the frame's sizes and samples.
// `raw` (jpeg_read_raw_data): each component's plane through the IDCT, not
// upsampled (`widths[c]` bytes a row, the MCU grid's rows), as libjpeg's
// raw buffers hold them; else (jpeg_read_scanlines, no colour conversion)
// the components upsampled and interleaved in planes[0]. `fail_row` is the
// first iMCU row a wrong restart marker or a read past the data stopped
// (-1: none).
struct OjpegImage {
  int w = 0, h = 0, ncomp = 0, maxh = 1, maxv = 1, imcu_rows = 0;
  int fail_row = -1, stride = 0;
  std::vector<int> widths;
  std::vector<std::vector<uint8_t>> planes;
};
int ojpeg_decode(const uint8_t* data, size_t n, const std::vector<size_t>& bounds,
                 bool dry, bool raw, OjpegImage& out);
// PNG, PNM (P1-P6), PFM, PAM (P7), BMP, Sun raster, GIF, Radiance HDR,
// TIFF and WebP as cv2.imread reads them (formats.cpp, gif.cpp, hdr.cpp,
// tiff.cpp, webp.cpp): kOk with the (h, w) it gives in dims (EXIF
// orientation applied) and, with img, its pixels as RGB; kUnreadable where
// cv2.imread gives None, kRaises where it raises (the reference's readers
// then raise too, so PIL is not tried), kTiff for a TIFF layout cv2 reads
// and the port does not decode. `head` reads the header alone.
int read_cv2(const uint8_t* data, size_t n, Image* img, int* dims, bool head);

// The same formats as PIL's Image.open(path).convert("RGB") reads them
// (no EXIF orientation but a TIFF's; of PFM the gray "Pf" alone; no
// Radiance HDR): kOk, kUnreadable where PIL raises (past Pillow's size
// limit too), kTiff for a TIFF layout PIL may read and the port does not
// decode. `head` reads the header alone (not of a PNG).
int read_pil(const uint8_t* data, size_t n, Image* img, int* dims, bool head);

// GIF's first frame as cv2.imread reads it (OpenCV's own decoder) and as
// PIL's GifImagePlugin and convert("RGB") read it (gif.cpp); the arguments
// and results of read_cv2 and read_pil. is_gif_data: a GIF87a/GIF89a
// signature.
bool is_gif_data(const uint8_t* data, size_t n);
int gif_cv2(const uint8_t* data, size_t n, Image* img, int* dims, bool head);
int gif_pil(const uint8_t* data, size_t n, Image* img, int* dims, bool head);

// Radiance RGBE as cv2.imread reads it (OpenCV's HdrDecoder and rgbe.cpp,
// hdr.cpp); the arguments and results of read_cv2. PIL reads no Radiance
// HDR. is_hdr_data: a "#?RGBE" or "#?RADIANCE" signature.
bool is_hdr_data(const uint8_t* data, size_t n);
int hdr_cv2(const uint8_t* data, size_t n, Image* img, int* dims, bool head);

// TIFF (classic or BigTIFF, either byte order, the first IFD; strips or
// tiles of gray, RGB or palette samples of 1 to 16 bits, any extra samples,
// CMYK, YCbCr and CIELAB, either planar configuration and fill order,
// uncompressed, PackBits, LZW, deflate, CCITT, JPEG or ThunderScan, SGILog,
// or a number that names no codec) as cv2.imread reads it (OpenCV's
// TiffDecoder over libtiff's RGBA reader, tiff.cpp) and as PIL's
// TiffImagePlugin and convert("RGB") read it; the arguments and results of
// read_cv2 and read_pil. A TIFF of a layout only PIL reads and the port
// does not decode (what is left of TIFF part 2c) gives kTiff. is_tiff_data: an "II*\0", "MM\0*", "II+\0"
// or "MM\0+" signature. probe_tiff: (h, w) from an open file's header and
// first IFD, wherever it lies (cv2's rules, else PIL's), or a Status.
bool is_tiff_data(const uint8_t* data, size_t n);
int tiff_cv2(const uint8_t* data, size_t n, Image* img, int* dims, bool head);
int tiff_pil(const uint8_t* data, size_t n, Image* img, int* dims, bool head);
int probe_tiff(FILE* f, int* dims);

// WebP (the RIFF container: a still image, an animation's first frame on
// its zeroed canvas; lossless VP8L data, or lossy VP8 data with its ALPH
// chunk) as cv2.imread reads it (OpenCV's WebPDecoder over libwebp: 32
// bytes or more, a raw VP8L or VP8 stream too, the EXIF chunk's
// orientation) and as PIL's WebPImagePlugin and convert("RGB") read it
// (WebPAnimDecoder, no orientation), webp.cpp; the arguments and results
// of read_cv2 and read_pil. is_webp_data: a RIFF "WEBP" signature, a VP8L
// stream's first byte and version, or 32 bytes libwebp's WebPGetFeatures
// accepts (cv2's signature check: a raw VP8 stream among them).
// probe_webp: (h, w) of an open file, its chunks walked by seeking (cv2's
// rules, else PIL's), or a Status. webp_lossy_planes (for tests): the
// lossy image of a file cv2 decodes as a still image, through libwebp's
// steps one by one (`filter`: the loop filter, else bypass_filtering;
// `rgb`: RGB with the fancy upsampler or, without `fancy`, point-sampled
// chroma, else the Y, U and V planes one after another, cropped), into
// `out` of `cap` bytes; its (h, w) into dims; false where it fails.
bool is_webp_data(const uint8_t* data, size_t n);
int webp_cv2(const uint8_t* data, size_t n, Image* img, int* dims, bool head);
int webp_pil(const uint8_t* data, size_t n, Image* img, int* dims, bool head);
int probe_webp(FILE* f, int* dims);
bool webp_lossy_planes(const uint8_t* data, size_t n, bool filter, bool rgb,
                       bool fancy, uint8_t* out, size_t cap, int* dims);

// A VP8 key frame (lossy WebP) as libwebp decodes it (vp8.cpp): the YUV
// 4:2:0 planes, each padded to whole macroblocks (y_stride 16 and
// uv_stride 8 pixels a macroblock column), the picture w x h at their
// top-left. vp8_decode: `data` from the frame tag to the end of the data
// libwebp hands the decoder; `filter` false skips the loop filter (its
// bypass_filtering); false where libwebp fails. vp8_rgb: the picture as
// RGB (`stride` bytes a row) through libwebp's fancy upsampler, or with
// each chroma sample on its 2 x 2 pixels (`fancy` false).
struct Vp8Planes {
  int w = 0, h = 0, y_stride = 0, uv_stride = 0;
  std::vector<uint8_t> y, u, v;
};
bool vp8_decode(const uint8_t* data, size_t n, bool filter, Vp8Planes& out);
void vp8_rgb(const Vp8Planes& f, bool fancy, uint8_t* rgb, size_t stride);

// JPEG 2000 (a JP2 file or a raw codestream), part 1 of the format with its
// JP2 colour boxes, HTJ2K's HT code-blocks and Part 2's multi-component
// markers, as cv2.imread reads it (OpenCV 5's Jpeg2KOpjDecoder over
// OpenJPEG 2.5) and as PIL's Jpeg2KImagePlugin and convert("RGB") read it
// (jpeg2000.cpp); the arguments and results of read_cv2 and read_pil,
// kJpeg2000 for a feature the port leaves out (sub-sampled components).
// is_jpeg2000_data: the JP2 signature box or SOC + SIZ.
bool is_jpeg2000_data(const uint8_t* data, size_t n);
int jpeg2000_cv2(const uint8_t* data, size_t n, Image* img, int* dims, bool head);
int jpeg2000_pil(const uint8_t* data, size_t n, Image* img, int* dims, bool head);
// For tests: the components opj_decode gives, the JP2 colour boxes applied
// (each (h, w) int32 plane one after another into `out` of `cap` values;
// info: components, h, w, and the image offset x0, y0); false where
// OpenJPEG fails or the port stops.
bool jpeg2000_planes(const uint8_t* data, size_t n, int32_t* out, size_t cap,
                     int* info);

// The Status of a format cv2.imread reads and the library does not decode
// (kAvif; kJpeg2000 comes from jpeg2000.cpp), or of one only PIL reads (kPcx ... kSpider), from the
// file's first bytes; kUnreadable for any other.
int foreign_format(const uint8_t* data, size_t n);

// Orientation (1-8, 1 where there is none or it does not parse) of a TIFF
// stream: the IFD0 tag 0x0112 of an EXIF block.
int tiff_orientation(const uint8_t* tiff, size_t n);

// Applies an EXIF orientation as cv2.imread does (flips and a transpose).
void apply_orientation(Image& img, int orientation);

}  // namespace tsrio
