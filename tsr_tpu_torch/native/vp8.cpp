// vp8.cpp — lossy WebP: a VP8 key frame (RFC 6386) decoded as libwebp 1.6
// decodes it for cv2.imread and PIL's WebPImagePlugin, then turned to RGB.
//
// It copies the parts of libwebp the two readers reach:
//   - the frame header and the first partition (vp8_dec.c's VP8GetHeaders:
//     the frame tag, the start code and 14-bit sides whose scale bits are
//     read and not applied, the colour-space and clamping bits, the segment
//     header, the filter header with its ref/mode deltas, 1, 2, 4 or 8 token
//     partitions (the last runs to the end of the data; one that starts at
//     the end refuses the frame), quant_dec.c's dequantisation tables and
//     tree_dec.c's coefficient probability updates and skip probability);
//   - the boolean decoder of bit_reader_utils (x86-64's 56-bit loads, one
//     zero byte fed past the end, then eof): a decode fails once a mode row
//     or a macroblock's tokens leave eof set;
//   - the intra modes (tree_dec.c: the 16x16, chroma and 4x4 trees, the 4x4
//     contexts by the above and left modes, the segment map, the skip
//     flag), the residuals (the token tree by band and context, non-zero
//     contexts carried left and above, the zigzag, the Y2 path through the
//     Walsh-Hadamard transform) and frame_dec.c's reconstruction (dec.c's
//     predictors with the frame-edge values 127 above and 129 to the left,
//     the 4x4 top-right rule; the inverse DCT as dec_sse2.c's Transform
//     computes it, in 16-bit lanes, and the DC-only and AC3 shortcuts as
//     dec.c's C versions);
//   - the loop filter (PrecomputeFilterStrengths and DoFilter: simple and
//     normal, per segment and with deltas, the inner edges skipped for a
//     macroblock without coefficients that is not 4x4-predicted; level 0
//     filters nothing);
//   - the output (io_dec.c's EmitFancyRGB over upsampling.c's fancy
//     upsampler, or EmitSampledRGB, and yuv.h's 14-bit fixed-point
//     YUV->RGB), dithering off as in both readers.
// The ALPH chunk, the container and the readers' rules are webp.cpp's.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "codec.h"

namespace tsrio {
namespace {

// ------------------------------------------------------------- tables
// (RFC 6386's, in libwebp's order of the 4x4 modes: DC, TM, VE, HE, RD, VR,
// LD, VL, HD, HU)

constexpr uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
constexpr uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
constexpr uint8_t kBModesProba[10 * 10 * 9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148, 72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24,
};
constexpr uint8_t kCoeffsProba0[4 * 8 * 3 * 11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
constexpr uint8_t kCoeffsUpdateProba[4 * 8 * 3 * 11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

constexpr uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11,
                                 14, 15};
// coefficient index -> band (the 17th entry a sentinel for the index past
// the last)
constexpr uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6,
                                7, 0};
constexpr uint8_t kCat3[] = {173, 148, 140, 0};
constexpr uint8_t kCat4[] = {176, 155, 140, 135, 0};
constexpr uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
constexpr uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153,
                             140, 133, 130, 129, 0};
constexpr const uint8_t* kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};

enum {
  kBDc = 0, kBTm, kBVe, kBHe, kBRd, kBVr, kBLd, kBVl, kBHd, kBHu,
  kDcNoTop = 4, kDcNoLeft = 5, kDcNoTopLeft = 6,  // 16x16 and chroma DC
};

// the work buffer's stride and layout (frame_dec.c's yuv_b_: BPS, Y_OFF,
// U_OFF, V_OFF)
constexpr int kBps = 32;
constexpr int kYOff = kBps + 8, kUOff = kYOff + kBps * 16 + kBps,
              kVOff = kUOff + 16, kYuvSize = kBps * 17 + kBps * 9;

// ------------------------------------------------------ boolean decoder

// bit_reader_utils: `value_` holds bits_ + 8 bits, `range_` is the range
// less 1; 7 bytes a load while 8 remain, then one at a time, then one
// zero byte with eof set.
class BoolReader {
 public:
  void init(const uint8_t* start, size_t size) {
    range_ = 255 - 1;
    value_ = 0;
    bits_ = -8;
    eof_ = false;
    buf_ = start;
    end_ = start + size;
    max_ = size >= 8 ? start + size - 8 + 1 : start;
    load();
  }
  bool eof() const { return eof_; }

  int bit(int prob) {
    uint32_t range = range_;
    if (bits_ < 0) load();
    const int pos = bits_;
    const uint32_t split = (range * static_cast<uint32_t>(prob)) >> 8;
    const uint32_t value = static_cast<uint32_t>(value_ >> pos);
    const int b = value > split;
    if (b) {
      range -= split;
      value_ -= static_cast<uint64_t>(split + 1) << pos;
    } else {
      range = split + 1;
    }
    const int shift = 7 ^ (31 - __builtin_clz(range));
    range <<= shift;
    bits_ -= shift;
    range_ = range - 1;
    return b;
  }

  // VP8GetSigned: v with the sign of one bit at probability 1/2
  int sign(int v) {
    if (bits_ < 0) load();
    const int pos = bits_;
    const uint32_t split = range_ >> 1;
    const uint32_t value = static_cast<uint32_t>(value_ >> pos);
    const int32_t mask = static_cast<int32_t>(split - value) >> 31;
    bits_ -= 1;
    range_ += static_cast<uint32_t>(mask);
    range_ |= 1;
    value_ -= static_cast<uint64_t>((split + 1) & static_cast<uint32_t>(mask))
              << pos;
    return (v ^ mask) - mask;
  }

  uint32_t value(int bits) {
    uint32_t v = 0;
    while (bits-- > 0) v |= static_cast<uint32_t>(bit(0x80)) << bits;
    return v;
  }
  int signed_value(int bits) {
    const int v = static_cast<int>(value(bits));
    return value(1) ? -v : v;
  }

 private:
  void load() {
    if (buf_ < max_) {
      uint64_t in;
      std::memcpy(&in, buf_, 8);
      buf_ += 7;
      value_ = (__builtin_bswap64(in) >> 8) | (value_ << 56);
      bits_ += 56;
    } else if (buf_ < end_) {
      bits_ += 8;
      value_ = uint64_t{*buf_++} | (value_ << 8);
    } else if (!eof_) {
      value_ <<= 8;
      bits_ += 8;
      eof_ = true;
    } else {
      bits_ = 0;
    }
  }

  uint64_t value_ = 0;
  uint32_t range_ = 0;
  int bits_ = 0;
  bool eof_ = false;
  const uint8_t *buf_ = nullptr, *end_ = nullptr, *max_ = nullptr;
};

// --------------------------------------------------------- transforms

inline uint8_t clip8(int v) {
  return !(v & ~0xff) ? static_cast<uint8_t>(v) : v < 0 ? 0 : 255;
}

// dec_sse2.c's Transform of one 4x4 block: 16-bit lanes that wrap, the
// constants 20091 and 35468 - 65536 through _mm_mulhi_epi16, the sum with
// the prediction saturated (equal to dec.c's TransformOne where nothing
// wraps).
inline int16_t w16(int v) { return static_cast<int16_t>(v); }
inline int16_t mulhi(int16_t a, int k) { return w16((a * k) >> 16); }

void transform_one(const int16_t* in, uint8_t* dst) {
  int16_t tmp[4][4];  // [output row of the first pass][column]
  for (int i = 0; i < 4; i++) {
    const int16_t i0 = in[i], i1 = in[4 + i], i2 = in[8 + i], i3 = in[12 + i];
    const int16_t a = w16(i0 + i2), b = w16(i0 - i2);
    const int16_t c = w16(w16(i1 - i3) + w16(mulhi(i1, -30068) -
                                            mulhi(i3, 20091)));
    const int16_t d = w16(w16(i1 + i3) + w16(mulhi(i1, 20091) +
                                            mulhi(i3, -30068)));
    tmp[0][i] = w16(a + d);
    tmp[1][i] = w16(b + c);
    tmp[2][i] = w16(b - c);
    tmp[3][i] = w16(a - d);
  }
  for (int r = 0; r < 4; r++) {
    const int16_t t0 = tmp[r][0], t1 = tmp[r][1], t2 = tmp[r][2],
                  t3 = tmp[r][3];
    const int16_t dc = w16(t0 + 4);
    const int16_t a = w16(dc + t2), b = w16(dc - t2);
    const int16_t c = w16(w16(t1 - t3) + w16(mulhi(t1, -30068) -
                                            mulhi(t3, 20091)));
    const int16_t d = w16(w16(t1 + t3) + w16(mulhi(t1, 20091) +
                                            mulhi(t3, -30068)));
    const int16_t out[4] = {w16(a + d), w16(b + c), w16(b - c), w16(a - d)};
    uint8_t* row = dst + r * kBps;
    for (int x = 0; x < 4; x++) {
      const int v = w16(row[x] + (out[x] >> 3));
      row[x] = v < 0 ? 0 : v > 255 ? 255 : static_cast<uint8_t>(v);
    }
  }
}

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// dec.c's TransformAC3_C: coefficients 0, 1 and 4 alone
void transform_ac3(const int16_t* in, uint8_t* dst) {
  const int a = in[0] + 4;
  const int c4 = mul2(in[4]), d4 = mul1(in[4]);
  const int c1 = mul2(in[1]), d1 = mul1(in[1]);
  const int dcs[4] = {a + d4, a + c4, a - c4, a - d4};
  for (int y = 0; y < 4; y++) {
    uint8_t* row = dst + y * kBps;
    const int dc = dcs[y];
    row[0] = clip8(row[0] + ((dc + d1) >> 3));
    row[1] = clip8(row[1] + ((dc + c1) >> 3));
    row[2] = clip8(row[2] + ((dc - c1) >> 3));
    row[3] = clip8(row[3] + ((dc - d1) >> 3));
  }
}

void transform_dc(const int16_t* in, uint8_t* dst) {
  const int dc = in[0] + 4;
  for (int y = 0; y < 4; y++)
    for (int x = 0; x < 4; x++)
      dst[x + y * kBps] = clip8(dst[x + y * kBps] + (dc >> 3));
}

// frame_dec.c's DoTransform: two bits a block (3 all, 2 the first three
// coefficients, 1 the DC alone, 0 none)
void do_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  switch (bits >> 30) {
    case 3: transform_one(src, dst); break;
    case 2: transform_ac3(src, dst); break;
    case 1: transform_dc(src, dst); break;
    default: break;
  }
}

void do_uv_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  if (!(bits & 0xff)) return;
  const int offs[4] = {0, 4, 4 * kBps, 4 * kBps + 4};
  for (int k = 0; k < 4; k++) {
    if (bits & 0xaa)
      transform_one(src + 16 * k, dst + offs[k]);
    else
      transform_dc(src + 16 * k, dst + offs[k]);
  }
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; i++) {
    const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; i++) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = w16((a0 + a1) >> 3);
    out[16] = w16((a3 + a2) >> 3);
    out[32] = w16((a0 - a1) >> 3);
    out[48] = w16((a3 - a2) >> 3);
    out += 64;
  }
}

// --------------------------------------------------------- predictors

inline uint8_t avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline uint8_t avg2(int a, int b) { return (a + b + 1) >> 1; }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - kBps;
  for (int y = 0; y < size; y++) {
    for (int x = 0; x < size; x++)
      dst[x] = clip8(top[x] + dst[-1] - top[-1]);
    dst += kBps;
  }
}

void fill(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; y++) std::memset(dst + y * kBps, v, size);
}

// 16x16 (size 16) and chroma (size 8) modes, CheckMode's DC variants
void predict_block(uint8_t* dst, int size, int mode) {
  const int shift = size == 16 ? 4 : 3;
  int dc;
  switch (mode) {
    case kBDc:
      dc = size;
      for (int j = 0; j < size; j++) dc += dst[-1 + j * kBps] + dst[j - kBps];
      fill(dst, size, dc >> (shift + 1));
      break;
    case kBTm:
      true_motion(dst, size);
      break;
    case kBVe:
      for (int j = 0; j < size; j++)
        std::memcpy(dst + j * kBps, dst - kBps, size);
      break;
    case kBHe:
      for (int j = 0; j < size; j++)
        std::memset(dst + j * kBps, dst[j * kBps - 1], size);
      break;
    case kDcNoTop:
      dc = size >> 1;
      for (int j = 0; j < size; j++) dc += dst[-1 + j * kBps];
      fill(dst, size, dc >> shift);
      break;
    case kDcNoLeft:
      dc = size >> 1;
      for (int j = 0; j < size; j++) dc += dst[j - kBps];
      fill(dst, size, dc >> shift);
      break;
    default:  // kDcNoTopLeft
      fill(dst, size, 0x80);
      break;
  }
}

#define DST(x, y) dst[(x) + (y) * kBps]

void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - kBps;
  const int I = dst[-1], J = dst[-1 + kBps], K = dst[-1 + 2 * kBps],
            L = dst[-1 + 3 * kBps], X = top[-1];
  const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4],
            F = top[5], G = top[6], H = top[7];
  switch (mode) {
    case kBDc: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; i++) dc += top[i] + dst[-1 + i * kBps];
      dc >>= 3;
      for (int i = 0; i < 4; i++) std::memset(dst + i * kBps, dc, 4);
      break;
    }
    case kBTm:
      true_motion(dst, 4);
      break;
    case kBVe: {
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D),
                            avg3(C, D, E)};
      for (int i = 0; i < 4; i++) std::memcpy(dst + i * kBps, v, 4);
      break;
    }
    case kBHe: {
      const int v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L),
                        avg3(K, L, L)};
      for (int i = 0; i < 4; i++) std::memset(dst + i * kBps, v[i], 4);
      break;
    }
    case kBRd:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case kBLd:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case kBVr:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case kBVl:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case kBHd:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default:  // kBHu
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) =
          static_cast<uint8_t>(L);
      break;
  }
}

#undef DST

inline int check_mode(int mb_x, int mb_y, int mode) {
  if (mode != kBDc) return mode;
  if (mb_x == 0) return mb_y == 0 ? kDcNoTopLeft : kDcNoLeft;
  return mb_y == 0 ? kDcNoTop : kBDc;
}

// -------------------------------------------------------- loop filter

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7,
            a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
         std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// FilterLoop26 (macroblock edges, `mb`) or FilterLoop24 (inner edges) of
// `size` pixels across an edge: `hstride` crosses it, `vstride` runs along
void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh,
                 int ithresh, int hev_thresh, bool mb) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh))
        filter2(p, hstride);
      else if (mb)
        filter6(p, hstride);
      else
        filter4(p, hstride);
    }
    p += vstride;
  }
}

void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; i++)
    if (needs_filter(p + i * vstride, hstride, thresh2))
      filter2(p + i * vstride, hstride);
}

struct FInfo {
  uint8_t limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

// ------------------------------------------------------------ decoder

struct MbData {
  int16_t coeffs[384];
  uint8_t is_i4x4 = 0, uvmode = 0, segment = 0, skip = 0;
  uint8_t imodes[16] = {};
  uint32_t non_zero_y = 0, non_zero_uv = 0;
};

struct Quant {
  int y1[2], y2[2], uv[2];
};

struct Nz {
  uint8_t nz = 0, nz_dc = 0;  // VP8MB: the non-zero bits carried on
};

class Decoder {
 public:
  bool decode(const uint8_t* d, size_t n, bool filter, Vp8Planes& out);

 private:
  bool headers(const uint8_t* d, size_t n);
  void parse_intra_mode(int mb_x);
  bool decode_mb(int mb_x, int mb_y, BoolReader& tokens);
  bool parse_residuals(int mb_x, BoolReader& tokens);
  int get_coeffs(BoolReader& br, int type, int ctx, const int* dq, int n,
                 int16_t* out);
  int large_value(BoolReader& br, const uint8_t* p);
  void reconstruct_row(int mb_y);
  void filter_frame();

  int w_ = 0, h_ = 0, mb_w_ = 0, mb_h_ = 0;
  BoolReader br_;
  std::vector<BoolReader> parts_;
  // segment header
  bool use_segment_ = false, update_map_ = false, absolute_delta_ = true;
  int quantizer_[4] = {}, filter_strength_[4] = {};
  uint8_t segment_proba_[3] = {255, 255, 255};
  // filter header
  bool simple_ = false, use_lf_delta_ = false;
  int level_ = 0, sharpness_ = 0, filter_type_ = 0;
  int ref_lf_delta_[4] = {}, mode_lf_delta_[4] = {};
  Quant dqm_[4];
  uint8_t proba_[4][8][3][11];
  bool use_skip_proba_ = false;
  int skip_p_ = 0;
  FInfo fstrengths_[4][2];
  // per row and column
  std::vector<uint8_t> intra_t_;
  uint8_t intra_l_[4] = {};
  std::vector<Nz> nz_;  // [0] is the left macroblock, [1 + x] the top
  std::vector<MbData> mb_data_;
  std::vector<FInfo> finfo_;  // every macroblock of the frame
  std::vector<uint8_t> top_y_, top_u_, top_v_;
  uint8_t yuv_b_[kYuvSize] = {};
  Vp8Planes* out_ = nullptr;
};

bool Decoder::headers(const uint8_t* buf, size_t size) {
  if (size < 4) return false;
  const uint32_t bits = buf[0] | buf[1] << 8 | buf[2] << 16;
  const bool key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7, show = (bits >> 4) & 1;
  const uint32_t partition_length = bits >> 5;
  if (profile > 3 || !show) return false;
  buf += 3;
  size -= 3;
  if (!key_frame) return false;  // (VP8GetInfo refuses it first)
  if (size < 7) return false;
  if (buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a) return false;
  w_ = ((buf[4] << 8) | buf[3]) & 0x3fff;  // the scale bits are not applied
  h_ = ((buf[6] << 8) | buf[5]) & 0x3fff;
  if (w_ == 0 || h_ == 0) return false;
  buf += 7;
  size -= 7;
  mb_w_ = (w_ + 15) >> 4;
  mb_h_ = (h_ + 15) >> 4;
  if (partition_length > size) return false;
  br_.init(buf, partition_length);
  buf += partition_length;
  size -= partition_length;
  br_.value(1);  // colour space
  br_.value(1);  // clamping type
  // ParseSegmentHeader
  use_segment_ = br_.value(1);
  if (use_segment_) {
    update_map_ = br_.value(1);
    if (br_.value(1)) {  // update data
      absolute_delta_ = br_.value(1);
      for (int& q : quantizer_) q = br_.value(1) ? br_.signed_value(7) : 0;
      for (int& f : filter_strength_) f = br_.value(1) ? br_.signed_value(6) : 0;
    }
    if (update_map_)
      for (uint8_t& p : segment_proba_) p = br_.value(1) ? br_.value(8) : 255;
  }
  if (br_.eof()) return false;
  // ParseFilterHeader
  simple_ = br_.value(1);
  level_ = br_.value(6);
  sharpness_ = br_.value(3);
  use_lf_delta_ = br_.value(1);
  if (use_lf_delta_ && br_.value(1)) {
    for (int& d : ref_lf_delta_)
      if (br_.value(1)) d = br_.signed_value(6);
    for (int& d : mode_lf_delta_)
      if (br_.value(1)) d = br_.signed_value(6);
  }
  filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
  if (br_.eof()) return false;
  // ParsePartitions: the last runs to the end of the data; one that starts
  // at the end is data cut short
  const size_t last = (size_t{1} << br_.value(2)) - 1;
  if (size < 3 * last) return false;
  const uint8_t* sz = buf;
  const uint8_t* start = buf + 3 * last;
  size_t left = size - 3 * last;
  parts_.assign(last + 1, BoolReader());
  for (size_t p = 0; p < last; p++, sz += 3) {
    size_t psize = sz[0] | sz[1] << 8 | sz[2] << 16;
    if (psize > left) psize = left;
    parts_[p].init(start, psize);
    start += psize;
    left -= psize;
  }
  parts_[last].init(start, left);
  if (start >= buf + size) return false;
  // VP8ParseQuant
  const int base_q0 = br_.value(7);
  int dq[5];
  for (int& v : dq) v = br_.value(1) ? br_.signed_value(4) : 0;
  const int dqy1_dc = dq[0], dqy2_dc = dq[1], dqy2_ac = dq[2],
            dquv_dc = dq[3], dquv_ac = dq[4];
  auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  for (int i = 0; i < 4; i++) {
    int q;
    if (use_segment_) {
      q = quantizer_[i] + (absolute_delta_ ? 0 : base_q0);
    } else if (i > 0) {
      dqm_[i] = dqm_[0];
      continue;
    } else {
      q = base_q0;
    }
    Quant& m = dqm_[i];
    m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
    m.y1[1] = kAcTable[clip(q, 127)];
    m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
    m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
  }
  br_.value(1);  // update_proba: ignored
  // VP8ParseProba
  for (int t = 0; t < 4; t++)
    for (int b = 0; b < 8; b++)
      for (int c = 0; c < 3; c++)
        for (int p = 0; p < 11; p++) {
          const int i = ((t * 8 + b) * 3 + c) * 11 + p;
          proba_[t][b][c][p] = br_.bit(kCoeffsUpdateProba[i])
                                   ? br_.value(8)
                                   : kCoeffsProba0[i];
        }
  use_skip_proba_ = br_.value(1);
  if (use_skip_proba_) skip_p_ = br_.value(8);
  return true;
}

void Decoder::parse_intra_mode(int mb_x) {
  uint8_t* const top = &intra_t_[4 * mb_x];
  uint8_t* const left = intra_l_;
  MbData& block = mb_data_[mb_x];
  if (update_map_) {
    block.segment = !br_.bit(segment_proba_[0])
                        ? br_.bit(segment_proba_[1])
                        : br_.bit(segment_proba_[2]) + 2;
  } else {
    block.segment = 0;
  }
  if (use_skip_proba_) block.skip = br_.bit(skip_p_);
  block.is_i4x4 = !br_.bit(145);
  if (!block.is_i4x4) {
    const int ymode = br_.bit(156) ? (br_.bit(128) ? kBTm : kBHe)
                                   : (br_.bit(163) ? kBVe : kBDc);
    block.imodes[0] = ymode;
    std::memset(top, ymode, 4);
    std::memset(left, ymode, 4);
  } else {
    uint8_t* modes = block.imodes;
    for (int y = 0; y < 4; y++) {
      int ymode = left[y];
      for (int x = 0; x < 4; x++) {
        const uint8_t* prob = &kBModesProba[(top[x] * 10 + ymode) * 9];
        ymode = !br_.bit(prob[0])   ? kBDc
                : !br_.bit(prob[1]) ? kBTm
                : !br_.bit(prob[2]) ? kBVe
                : !br_.bit(prob[3])
                    ? (!br_.bit(prob[4]) ? kBHe
                                         : (!br_.bit(prob[5]) ? kBRd : kBVr))
                    : (!br_.bit(prob[6])
                           ? kBLd
                           : (!br_.bit(prob[7])
                                  ? kBVl
                                  : (!br_.bit(prob[8]) ? kBHd : kBHu)));
        top[x] = static_cast<uint8_t>(ymode);
      }
      std::memcpy(modes, top, 4);
      modes += 4;
      left[y] = static_cast<uint8_t>(ymode);
    }
  }
  block.uvmode = !br_.bit(142)   ? kBDc
                 : !br_.bit(114) ? kBVe
                 : br_.bit(183)  ? kBTm
                                 : kBHe;
}

int Decoder::large_value(BoolReader& br, const uint8_t* p) {
  int v;
  if (!br.bit(p[3])) {
    v = !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
  } else if (!br.bit(p[6])) {
    if (!br.bit(p[7])) {
      v = 5 + br.bit(159);
    } else {
      v = 7 + 2 * br.bit(165);
      v += br.bit(145);
    }
  } else {
    const int bit1 = br.bit(p[8]);
    const int bit0 = br.bit(p[9 + bit1]);
    const int cat = 2 * bit1 + bit0;
    v = 0;
    for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
    v += 3 + (8 << cat);
  }
  return v;
}

// GetCoeffs: the tokens of one block from coefficient `n`; returns the
// index past the last non-zero one (16 where a run of zeros reaches the
// end)
int Decoder::get_coeffs(BoolReader& br, int type, int ctx, const int* dq,
                        int n, int16_t* out) {
  const uint8_t* p = proba_[type][kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.bit(p[0])) return n;
    while (!br.bit(p[1])) {
      p = proba_[type][kBands[++n]][0];
      if (n == 16) return 16;
    }
    const uint8_t(*p_ctx)[11] = proba_[type][kBands[n + 1]];
    int v;
    if (!br.bit(p[2])) {
      v = 1;
      p = p_ctx[1];
    } else {
      v = large_value(br, p);
      p = p_ctx[2];
    }
    out[kZigzag[n]] = w16(br.sign(v) * dq[n > 0]);
  }
  return 16;
}

inline uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= nz > 3 ? 3 : nz > 1 ? 2 : dc_nz;
  return nz_coeffs;
}

// ParseResiduals: true where the macroblock has no non-zero coefficient
bool Decoder::parse_residuals(int mb_x, BoolReader& tokens) {
  MbData& block = mb_data_[mb_x];
  const Quant& q = dqm_[block.segment];
  int16_t* dst = block.coeffs;
  Nz& mb = nz_[1 + mb_x];
  Nz& left_mb = nz_[0];
  std::memset(dst, 0, sizeof(block.coeffs));
  int first, ac_type;
  if (!block.is_i4x4) {
    int16_t dc[16] = {};
    const int ctx = mb.nz_dc + left_mb.nz_dc;
    const int nz = get_coeffs(tokens, 1, ctx, q.y2, 0, dc);
    mb.nz_dc = left_mb.nz_dc = nz > 0;
    if (nz > 1) {
      transform_wht(dc, dst);
    } else {
      const int16_t dc0 = w16((dc[0] + 3) >> 3);
      for (int i = 0; i < 16 * 16; i += 16) dst[i] = dc0;
    }
    first = 1;
    ac_type = 0;
  } else {
    first = 0;
    ac_type = 3;
  }
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  uint8_t tnz = mb.nz & 0x0f, lnz = left_mb.nz & 0x0f;
  for (int y = 0; y < 4; y++) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; x++) {
      const int ctx = l + (tnz & 1);
      const int nz = get_coeffs(tokens, ac_type, ctx, q.y1, first, dst);
      l = nz > first;
      tnz = static_cast<uint8_t>((tnz >> 1) | (l << 7));
      nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = static_cast<uint8_t>((lnz >> 1) | (l << 7));
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nz_coeffs = 0;
    tnz = mb.nz >> (4 + ch);
    lnz = left_mb.nz >> (4 + ch);
    for (int y = 0; y < 2; y++) {
      int l = lnz & 1;
      for (int x = 0; x < 2; x++) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(tokens, 2, ctx, q.uv, 0, dst);
        l = nz > 0;
        tnz = static_cast<uint8_t>((tnz >> 1) | (l << 3));
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = static_cast<uint8_t>((lnz >> 1) | (l << 5));
    }
    non_zero_uv |= nz_coeffs << (4 * ch);
    out_t_nz |= (tnz << 4) << ch;
    out_l_nz |= (lnz & 0xf0) << ch;
  }
  mb.nz = static_cast<uint8_t>(out_t_nz);
  left_mb.nz = static_cast<uint8_t>(out_l_nz);
  block.non_zero_y = non_zero_y;
  block.non_zero_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

// VP8DecodeMB: false where the token partition ran out (eof)
bool Decoder::decode_mb(int mb_x, int mb_y, BoolReader& tokens) {
  MbData& block = mb_data_[mb_x];
  bool skip = use_skip_proba_ ? block.skip : false;
  if (!skip) {
    skip = parse_residuals(mb_x, tokens);
  } else {
    nz_[0].nz = nz_[1 + mb_x].nz = 0;
    if (!block.is_i4x4) nz_[0].nz_dc = nz_[1 + mb_x].nz_dc = 0;
    block.non_zero_y = 0;
    block.non_zero_uv = 0;
  }
  if (filter_type_ > 0) {
    FInfo& f = finfo_[size_t(mb_y) * mb_w_ + mb_x];
    f = fstrengths_[block.segment][block.is_i4x4];
    f.inner |= !skip;
  }
  return !tokens.eof();
}

// ReconstructRow: each macroblock predicted in the work buffer from the
// unfiltered samples above (saved per column) and to the left, its
// residuals added, then copied into the frame's planes
void Decoder::reconstruct_row(int mb_y) {
  uint8_t* const y_dst = yuv_b_ + kYOff;
  uint8_t* const u_dst = yuv_b_ + kUOff;
  uint8_t* const v_dst = yuv_b_ + kVOff;
  for (int j = 0; j < 16; j++) y_dst[j * kBps - 1] = 129;
  for (int j = 0; j < 8; j++) u_dst[j * kBps - 1] = v_dst[j * kBps - 1] = 129;
  if (mb_y > 0) {
    y_dst[-1 - kBps] = u_dst[-1 - kBps] = v_dst[-1 - kBps] = 129;
  } else {
    std::memset(y_dst - kBps - 1, 127, 16 + 4 + 1);
    std::memset(u_dst - kBps - 1, 127, 8 + 1);
    std::memset(v_dst - kBps - 1, 127, 8 + 1);
  }
  Vp8Planes& o = *out_;
  for (int mb_x = 0; mb_x < mb_w_; mb_x++) {
    const MbData& block = mb_data_[mb_x];
    if (mb_x > 0) {  // the left samples: the previous block's last columns
      for (int j = -1; j < 16; j++)
        std::memcpy(&y_dst[j * kBps - 4], &y_dst[j * kBps + 12], 4);
      for (int j = -1; j < 8; j++) {
        std::memcpy(&u_dst[j * kBps - 4], &u_dst[j * kBps + 4], 4);
        std::memcpy(&v_dst[j * kBps - 4], &v_dst[j * kBps + 4], 4);
      }
    }
    uint8_t* const top_y = &top_y_[16 * mb_x];
    uint8_t* const top_u = &top_u_[8 * mb_x];
    uint8_t* const top_v = &top_v_[8 * mb_x];
    if (mb_y > 0) {
      std::memcpy(y_dst - kBps, top_y, 16);
      std::memcpy(u_dst - kBps, top_u, 8);
      std::memcpy(v_dst - kBps, top_v, 8);
    }
    uint32_t bits = block.non_zero_y;
    if (block.is_i4x4) {
      uint8_t* const top_right = y_dst - kBps + 16;
      if (mb_y > 0) {
        if (mb_x >= mb_w_ - 1)
          std::memset(top_right, top_y[15], 4);
        else
          std::memcpy(top_right, top_y + 16, 4);
      }
      // the top-right pixels replicated for the sub-block rows below
      for (int k = 1; k < 4; k++)
        std::memcpy(top_right + 4 * k * kBps, top_right, 4);
      for (int n = 0; n < 16; n++, bits <<= 2) {
        uint8_t* const dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * kBps;
        predict4(dst, block.imodes[n]);
        do_transform(bits, block.coeffs + n * 16, dst);
      }
    } else {
      predict_block(y_dst, 16, check_mode(mb_x, mb_y, block.imodes[0]));
      if (bits != 0)
        for (int n = 0; n < 16; n++, bits <<= 2)
          do_transform(bits, block.coeffs + n * 16,
                       y_dst + (n & 3) * 4 + (n >> 2) * 4 * kBps);
    }
    const int uv_mode = check_mode(mb_x, mb_y, block.uvmode);
    predict_block(u_dst, 8, uv_mode);
    predict_block(v_dst, 8, uv_mode);
    do_uv_transform(block.non_zero_uv >> 0, block.coeffs + 16 * 16, u_dst);
    do_uv_transform(block.non_zero_uv >> 8, block.coeffs + 20 * 16, v_dst);
    if (mb_y < mb_h_ - 1) {
      std::memcpy(top_y, y_dst + 15 * kBps, 16);
      std::memcpy(top_u, u_dst + 7 * kBps, 8);
      std::memcpy(top_v, v_dst + 7 * kBps, 8);
    }
    for (int j = 0; j < 16; j++)
      std::memcpy(&o.y[(size_t(mb_y) * 16 + j) * o.y_stride + mb_x * 16],
                  y_dst + j * kBps, 16);
    for (int j = 0; j < 8; j++) {
      const size_t at = (size_t(mb_y) * 8 + j) * o.uv_stride + mb_x * 8;
      std::memcpy(&o.u[at], u_dst + j * kBps, 8);
      std::memcpy(&o.v[at], v_dst + j * kBps, 8);
    }
  }
}

// DoFilter over every macroblock in raster order, in place (equal to
// libwebp's filtering a row behind the reconstruction, which predicts from
// unfiltered samples)
void Decoder::filter_frame() {
  Vp8Planes& o = *out_;
  const int ys = o.y_stride, uvs = o.uv_stride;
  for (int mb_y = 0; mb_y < mb_h_; mb_y++) {
    for (int mb_x = 0; mb_x < mb_w_; mb_x++) {
      const FInfo& f = finfo_[size_t(mb_y) * mb_w_ + mb_x];
      const int limit = f.limit, ilevel = f.ilevel;
      if (limit == 0) continue;
      uint8_t* const y = &o.y[size_t(mb_y) * 16 * ys + mb_x * 16];
      if (filter_type_ == 1) {  // simple: luma alone
        if (mb_x > 0) simple_filter(y, 1, ys, limit + 4);
        if (f.inner)
          for (int k = 4; k < 16; k += 4) simple_filter(y + k, 1, ys, limit);
        if (mb_y > 0) simple_filter(y, ys, 1, limit + 4);
        if (f.inner)
          for (int k = 4; k < 16; k += 4)
            simple_filter(y + k * ys, ys, 1, limit);
        continue;
      }
      uint8_t* const u = &o.u[size_t(mb_y) * 8 * uvs + mb_x * 8];
      uint8_t* const v = &o.v[size_t(mb_y) * 8 * uvs + mb_x * 8];
      const int hev_t = f.hev_thresh;
      if (mb_x > 0) {
        filter_loop(y, 1, ys, 16, limit + 4, ilevel, hev_t, true);
        filter_loop(u, 1, uvs, 8, limit + 4, ilevel, hev_t, true);
        filter_loop(v, 1, uvs, 8, limit + 4, ilevel, hev_t, true);
      }
      if (f.inner) {
        for (int k = 4; k < 16; k += 4)
          filter_loop(y + k, 1, ys, 16, limit, ilevel, hev_t, false);
        filter_loop(u + 4, 1, uvs, 8, limit, ilevel, hev_t, false);
        filter_loop(v + 4, 1, uvs, 8, limit, ilevel, hev_t, false);
      }
      if (mb_y > 0) {
        filter_loop(y, ys, 1, 16, limit + 4, ilevel, hev_t, true);
        filter_loop(u, uvs, 1, 8, limit + 4, ilevel, hev_t, true);
        filter_loop(v, uvs, 1, 8, limit + 4, ilevel, hev_t, true);
      }
      if (f.inner) {
        for (int k = 4; k < 16; k += 4)
          filter_loop(y + k * ys, ys, 1, 16, limit, ilevel, hev_t, false);
        filter_loop(u + 4 * uvs, uvs, 1, 8, limit, ilevel, hev_t, false);
        filter_loop(v + 4 * uvs, uvs, 1, 8, limit, ilevel, hev_t, false);
      }
    }
  }
}

bool Decoder::decode(const uint8_t* d, size_t n, bool filter,
                     Vp8Planes& out) {
  if (!headers(d, n)) return false;
  if (!filter) filter_type_ = 0;  // the bypass_filtering option
  // PrecomputeFilterStrengths
  if (filter_type_ > 0) {
    for (int s = 0; s < 4; s++) {
      int base = level_;
      if (use_segment_)
        base = filter_strength_[s] + (absolute_delta_ ? 0 : level_);
      for (int i4x4 = 0; i4x4 <= 1; i4x4++) {
        FInfo& info = fstrengths_[s][i4x4];
        int level = base;
        if (use_lf_delta_) {
          level += ref_lf_delta_[0];
          if (i4x4) level += mode_lf_delta_[0];
        }
        level = level < 0 ? 0 : level > 63 ? 63 : level;
        info = FInfo();
        if (level > 0) {
          int ilevel = level;
          if (sharpness_ > 0) {
            ilevel >>= sharpness_ > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = static_cast<uint8_t>(ilevel);
          info.limit = static_cast<uint8_t>(2 * level + ilevel);
          info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
        }
        info.inner = static_cast<uint8_t>(i4x4);
      }
    }
    finfo_.assign(size_t(mb_w_) * mb_h_, FInfo());
  }
  out.w = w_;
  out.h = h_;
  out.y_stride = mb_w_ * 16;
  out.uv_stride = mb_w_ * 8;
  out.y.assign(size_t(out.y_stride) * mb_h_ * 16, 0);
  out.u.assign(size_t(out.uv_stride) * mb_h_ * 8, 0);
  out.v.assign(out.u.size(), 0);
  out_ = &out;
  intra_t_.assign(size_t(4) * mb_w_, kBDc);
  nz_.assign(size_t(mb_w_) + 1, Nz());
  mb_data_.assign(mb_w_, MbData());
  top_y_.assign(size_t(16) * mb_w_, 0);
  top_u_.assign(size_t(8) * mb_w_, 0);
  top_v_.assign(size_t(8) * mb_w_, 0);
  for (int mb_y = 0; mb_y < mb_h_; mb_y++) {
    BoolReader& tokens = parts_[mb_y & (parts_.size() - 1)];
    for (int mb_x = 0; mb_x < mb_w_; mb_x++) parse_intra_mode(mb_x);
    if (br_.eof()) return false;  // "Premature end-of-partition0"
    for (int mb_x = 0; mb_x < mb_w_; mb_x++)
      if (!decode_mb(mb_x, mb_y, tokens)) return false;  // "end-of-file"
    // VP8InitScanline
    nz_[0] = Nz();
    std::memset(intra_l_, kBDc, sizeof intra_l_);
    reconstruct_row(mb_y);
  }
  if (filter_type_ > 0) filter_frame();
  return true;
}

// ------------------------------------------------------------- output

// yuv.h: 14-bit fixed point (YUV_FIX2 = 6), MultHi as _mm_mulhi_epu16
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) {
  return (v & ~16383) == 0 ? static_cast<uint8_t>(v >> 6) : v < 0 ? 0 : 255;
}
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  const int yy = mult_hi(y, 19077);
  rgb[0] = yuv_clip8(yy + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip8(yy - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = yuv_clip8(yy + mult_hi(u, 33050) - 17685);
}

// upsampling.c's UpsampleRgbLinePair: one row (`bottom` false: the upper of
// the pair) of `len` pixels from luma `y` and the chroma rows `top` and
// `cur` ((u, v) pairs interleaved in two arrays), its U and V interpolated
// by the two-step approximation of the 9-3-3-1 filter
void upsample_row(const uint8_t* y, const uint8_t* top_u,
                  const uint8_t* top_v, const uint8_t* cur_u,
                  const uint8_t* cur_v, bool bottom, int len, uint8_t* dst) {
  const int last_pair = (len - 1) >> 1;
  int tl_u = top_u[0], tl_v = top_v[0], l_u = cur_u[0], l_v = cur_v[0];
  auto edge = [&](int x, int a_u, int a_v, int b_u, int b_v) {
    // (3 * a + b + 2) >> 2 with `a` the near row
    yuv_to_rgb(y[x], (3 * a_u + b_u + 2) >> 2, (3 * a_v + b_v + 2) >> 2,
               dst + 3 * x);
  };
  if (bottom)
    edge(0, l_u, l_v, tl_u, tl_v);
  else
    edge(0, tl_u, tl_v, l_u, l_v);
  for (int x = 1; x <= last_pair; x++) {
    const int t_u = top_u[x], t_v = top_v[x], u = cur_u[x], v = cur_v[x];
    const int avg_u = tl_u + t_u + l_u + u + 8, avg_v = tl_v + t_v + l_v + v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3;
    const int d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + u)) >> 3;
    const int d03_v = (avg_v + 2 * (tl_v + v)) >> 3;
    if (!bottom) {
      yuv_to_rgb(y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1,
                 dst + 3 * (2 * x - 1));
      yuv_to_rgb(y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1,
                 dst + 3 * (2 * x));
    } else {
      yuv_to_rgb(y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1,
                 dst + 3 * (2 * x - 1));
      yuv_to_rgb(y[2 * x], (d12_u + u) >> 1, (d12_v + v) >> 1,
                 dst + 3 * (2 * x));
    }
    tl_u = t_u;
    tl_v = t_v;
    l_u = u;
    l_v = v;
  }
  if (!(len & 1)) {
    if (bottom)
      edge(len - 1, l_u, l_v, tl_u, tl_v);
    else
      edge(len - 1, tl_u, tl_v, l_u, l_v);
  }
}

}  // namespace

bool vp8_decode(const uint8_t* data, size_t n, bool filter, Vp8Planes& out) {
  Decoder dec;
  return dec.decode(data, n, filter, out);
}

void vp8_rgb(const Vp8Planes& f, bool fancy, uint8_t* rgb, size_t stride) {
  const int w = f.w, h = f.h;
  for (int r = 0; r < h; r++) {
    const uint8_t* y = &f.y[size_t(r) * f.y_stride];
    uint8_t* dst = rgb + size_t(r) * stride;
    if (!fancy) {  // EmitSampledRGB: each chroma sample on its 2 x 2 pixels
      const uint8_t* u = &f.u[size_t(r >> 1) * f.uv_stride];
      const uint8_t* v = &f.v[size_t(r >> 1) * f.uv_stride];
      for (int x = 0; x < w; x++) yuv_to_rgb(y[x], u[x >> 1], v[x >> 1],
                                             dst + 3 * x);
      continue;
    }
    // EmitFancyRGB: row 0 and an even height's last row from one chroma
    // row; rows 2k - 1 (upper) and 2k (lower) from chroma rows k - 1 and k
    const int k = (r + 1) >> 1;
    const bool mirror = r == 0 || k >= (h + 1) >> 1;
    const int top = mirror ? (r == 0 ? 0 : k - 1) : k - 1;
    const int cur = mirror ? top : k;
    upsample_row(y, &f.u[size_t(top) * f.uv_stride],
                 &f.v[size_t(top) * f.uv_stride],
                 &f.u[size_t(cur) * f.uv_stride],
                 &f.v[size_t(cur) * f.uv_stride], !mirror && !(r & 1), w,
                 dst);
  }
}

}  // namespace tsrio
