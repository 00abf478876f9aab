// codec.h — what tsrio.cpp and jpeg.cpp share: the decoded image, the
// status codes a decode or a header probe returns, the JPEG codec's entry
// points and the EXIF orientation both JPEG and PNG carry.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <vector>

namespace tsrio {

struct Image {
  int w = 0, h = 0;
  std::vector<uint8_t> rgb;  // HWC
};

// A decode's or a probe's outcome. kOk and kUnreadable (not an image the
// library knows, or data libjpeg refuses) are the first two; each negative
// code names a feature of a valid file that the library does not
// implement (neither cv2.imread nor PIL reads any of them).
// tsr_tpu_torch/native/__init__.py mirrors the negative codes in FEATURES,
// in this order.
enum Status : int {
  kOk = 1,
  kUnreadable = 0,
  kPrecision = -1,           // JPEG sample precision other than 8 bits
  kHierarchical = -2,        // hierarchical JPEG (SOF5-7, SOF13-15, DHP, EXP)
  kComponents = -3,          // a JPEG of 2 or more than 4 components
  kLosslessArithmetic = -4,  // lossless JPEG, arithmetic coded (SOF11)
  kLosslessColor = -5,       // lossless JPEG in YCbCr or YCCK
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

// Orientation (1-8, 1 where there is none or it does not parse) of a TIFF
// stream: the IFD0 tag 0x0112 of an EXIF block.
int tiff_orientation(const uint8_t* tiff, size_t n);

// Applies an EXIF orientation as cv2.imread does (flips and a transpose).
void apply_orientation(Image& img, int orientation);

}  // namespace tsrio
