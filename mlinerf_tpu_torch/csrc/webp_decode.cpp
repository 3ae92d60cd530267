// The WebP codecs on the host, decoding to the RGBA that Pillow 12.1 reads
// through libwebp 1.6.0's WebPAnimDecoder (MODE_RGBA, fancy upsampling, no
// dithering):
//
// - VP8 key frames (RFC 6386, as libwebp's src/dec/vp8_dec.c, tree_dec.c,
//   quant_dec.c, frame_dec.c and src/dsp/dec.c compute them): the boolean
//   decoder, with libwebp's end-of-data rule; segments, loop-filter deltas,
//   1 to 8 token partitions, coefficient-probability updates and the skip
//   probability; the 16x16, 4x4 (all ten modes) and chroma intra predictions
//   with libwebp's edge samples (127 above, 129 to the left, the top-right
//   samples of the last macroblock column repeated); dequantisation, the WHT
//   and the inverse DCT; the simple and the normal loop filters, run over
//   the unfiltered frame in macroblock order; the output through libwebp's
//   fancy upsampler (src/dsp/upsampling.c, its diag_12/diag_03 rounding,
//   which is not the spec's (9a+3b+3c+d+8)>>4) and VP8YUVToR/G/B's 14-bit
//   fixed point (src/dsp/yuv.h).
// - VP8L (src/dec/vp8l_dec.c, src/dsp/lossless.c): simple and normal
//   Huffman codes, meta (entropy-image) codes, the colour cache, LZ77
//   references through the 120-entry distance map, and the predictor (all
//   14 modes), cross-colour, subtract-green and colour-indexing transforms.
// - ALPH (src/dec/alpha_dec.c, src/dsp/filters.c): raw or VP8L-coded in the
//   green channel, then the horizontal, vertical or gradient unfilter.
//
// The RIFF container, the canvas of an animation and the mode Pillow gives
// are Python in utils/image_webp.py. Host library with a plain C
// interface, built with g++ into build/libwebp_decode.so and loaded with
// ctypes by utils/image_webp.py.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

[[noreturn]] void fail(const std::string& what) { throw std::runtime_error(what); }

// ---------------------------------------------------------------------------
// VP8 tables (RFC 6386: 14.1 quantizer lookup, 13.5 default token
// probabilities, 13.4 their update probabilities, 11.5 key-frame subblock
// mode probabilities, in libwebp's order of the ten 4x4 modes)
// ---------------------------------------------------------------------------

const uint8_t kDcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  10,  11,  12,  13,  14,  15,  16,  17,  17,  18,  19,  20,  20,  21,  21,
    22,  22,  23,  23,  24,  25,  25,  26,  27,  28,  29,  30,  31,  32,  33,  34,  35,  36,  37,  37,  38,  39,
    40,  41,  42,  43,  44,  45,  46,  46,  47,  48,  49,  50,  51,  52,  53,  54,  55,  56,  57,  58,  59,  60,
    61,  62,  63,  64,  65,  66,  67,  68,  69,  70,  71,  72,  73,  74,  75,  76,  76,  77,  78,  79,  80,  81,
    82,  83,  84,  85,  86,  87,  88,  89,  91,  93,  95,  96,  98,  100, 101, 102, 104, 106, 108, 110, 112, 114,
    116, 118, 122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};

const uint16_t kAcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  11,  12,  13,  14,  15,  16,  17,  18,  19,  20,  21,  22,  23,  24,  25,
    26,  27,  28,  29,  30,  31,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,  42,  43,  44,  45,  46,  47,
    48,  49,  50,  51,  52,  53,  54,  55,  56,  57,  58,  60,  62,  64,  66,  68,  70,  72,  74,  76,  78,  80,
    82,  84,  86,  88,  90,  92,  94,  96,  98,  100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128,
    131, 134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201,
    205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};

static const uint8_t kCoeffsProba0[4][8][3][11] = {
 {
  {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
  {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128}, {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128}, {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
  {{1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128}, {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128}, {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
  {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128}, {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128}, {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
  {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128}, {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128}, {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
  {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128}, {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128}, {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
  {{1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128}, {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128}, {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
  {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
 {
  {{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62}, {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1}, {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
  {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128}, {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128}, {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
  {{1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128}, {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128}, {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
  {{1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128}, {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128}, {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
  {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128}, {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128}, {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
  {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128}, {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128}, {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
  {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128}, {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128}, {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
  {{1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128}, {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128}, {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}}},
 {
  {{253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128}, {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128}, {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
  {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128}, {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128}, {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
  {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128}, {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128}, {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
  {{1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128}, {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128}, {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
  {{1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128}, {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128}, {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
  {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
  {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128}, {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128}, {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
  {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
 {
  {{202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255}, {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128}, {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
  {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128}, {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128}, {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
  {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128}, {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128}, {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
  {{1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128}, {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128}, {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
  {{1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128}, {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128}, {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
  {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128}, {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128}, {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
  {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128}, {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128}, {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
  {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}}}};

static const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
 {
  {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255}, {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255}, {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255}, {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
 {
  {{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255}, {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
  {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
 {
  {{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255}, {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255}, {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
  {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
  {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
 {
  {{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255}, {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
  {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255}, {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}}};

static const uint8_t kBModesProba[10][10][9] = {
 {{231, 120, 48, 89, 115, 113, 120, 152, 112}, {152, 179, 64, 126, 170, 118, 46, 70, 95}, {175, 69, 143, 80, 85, 82, 72, 155, 103}, {56, 58, 10, 171, 218, 189, 17, 13, 152}, {114, 26, 17, 163, 44, 195, 21, 10, 173}, {121, 24, 80, 195, 26, 62, 44, 64, 85}, {144, 71, 10, 38, 171, 213, 144, 34, 26}, {170, 46, 55, 19, 136, 160, 33, 206, 71}, {63, 20, 8, 114, 114, 208, 12, 9, 226}, {81, 40, 11, 96, 182, 84, 29, 16, 36}},
 {{134, 183, 89, 137, 98, 101, 106, 165, 148}, {72, 187, 100, 130, 157, 111, 32, 75, 80}, {66, 102, 167, 99, 74, 62, 40, 234, 128}, {41, 53, 9, 178, 241, 141, 26, 8, 107}, {74, 43, 26, 146, 73, 166, 49, 23, 157}, {65, 38, 105, 160, 51, 52, 31, 115, 128}, {104, 79, 12, 27, 217, 255, 87, 17, 7}, {87, 68, 71, 44, 114, 51, 15, 186, 23}, {47, 41, 14, 110, 182, 183, 21, 17, 194}, {66, 45, 25, 102, 197, 189, 23, 18, 22}},
 {{88, 88, 147, 150, 42, 46, 45, 196, 205}, {43, 97, 183, 117, 85, 38, 35, 179, 61}, {39, 53, 200, 87, 26, 21, 43, 232, 171}, {56, 34, 51, 104, 114, 102, 29, 93, 77}, {39, 28, 85, 171, 58, 165, 90, 98, 64}, {34, 22, 116, 206, 23, 34, 43, 166, 73}, {107, 54, 32, 26, 51, 1, 81, 43, 31}, {68, 25, 106, 22, 64, 171, 36, 225, 114}, {34, 19, 21, 102, 132, 188, 16, 76, 124}, {62, 18, 78, 95, 85, 57, 50, 48, 51}},
 {{193, 101, 35, 159, 215, 111, 89, 46, 111}, {60, 148, 31, 172, 219, 228, 21, 18, 111}, {112, 113, 77, 85, 179, 255, 38, 120, 114}, {40, 42, 1, 196, 245, 209, 10, 25, 109}, {88, 43, 29, 140, 166, 213, 37, 43, 154}, {61, 63, 30, 155, 67, 45, 68, 1, 209}, {100, 80, 8, 43, 154, 1, 51, 26, 71}, {142, 78, 78, 16, 255, 128, 34, 197, 171}, {41, 40, 5, 102, 211, 183, 4, 1, 221}, {51, 50, 17, 168, 209, 192, 23, 25, 82}},
 {{138, 31, 36, 171, 27, 166, 38, 44, 229}, {67, 87, 58, 169, 82, 115, 26, 59, 179}, {63, 59, 90, 180, 59, 166, 93, 73, 154}, {40, 40, 21, 116, 143, 209, 34, 39, 175}, {47, 15, 16, 183, 34, 223, 49, 45, 183}, {46, 17, 33, 183, 6, 98, 15, 32, 183}, {57, 46, 22, 24, 128, 1, 54, 17, 37}, {65, 32, 73, 115, 28, 128, 23, 128, 205}, {40, 3, 9, 115, 51, 192, 18, 6, 223}, {87, 37, 9, 115, 59, 77, 64, 21, 47}},
 {{104, 55, 44, 218, 9, 54, 53, 130, 226}, {64, 90, 70, 205, 40, 41, 23, 26, 57}, {54, 57, 112, 184, 5, 41, 38, 166, 213}, {30, 34, 26, 133, 152, 116, 10, 32, 134}, {39, 19, 53, 221, 26, 114, 32, 73, 255}, {31, 9, 65, 234, 2, 15, 1, 118, 73}, {75, 32, 12, 51, 192, 255, 160, 43, 51}, {88, 31, 35, 67, 102, 85, 55, 186, 85}, {56, 21, 23, 111, 59, 205, 45, 37, 192}, {55, 38, 70, 124, 73, 102, 1, 34, 98}},
 {{125, 98, 42, 88, 104, 85, 117, 175, 82}, {95, 84, 53, 89, 128, 100, 113, 101, 45}, {75, 79, 123, 47, 51, 128, 81, 171, 1}, {57, 17, 5, 71, 102, 57, 53, 41, 49}, {38, 33, 13, 121, 57, 73, 26, 1, 85}, {41, 10, 67, 138, 77, 110, 90, 47, 114}, {115, 21, 2, 10, 102, 255, 166, 23, 6}, {101, 29, 16, 10, 85, 128, 101, 196, 26}, {57, 18, 10, 102, 102, 213, 34, 20, 43}, {117, 20, 15, 36, 163, 128, 68, 1, 26}},
 {{102, 61, 71, 37, 34, 53, 31, 243, 192}, {69, 60, 71, 38, 73, 119, 28, 222, 37}, {68, 45, 128, 34, 1, 47, 11, 245, 171}, {62, 17, 19, 70, 146, 85, 55, 62, 70}, {37, 43, 37, 154, 100, 163, 85, 160, 1}, {63, 9, 92, 136, 28, 64, 32, 201, 85}, {75, 15, 9, 9, 64, 255, 184, 119, 16}, {86, 6, 28, 5, 64, 255, 25, 248, 1}, {56, 8, 17, 132, 137, 255, 55, 116, 128}, {58, 15, 20, 82, 135, 57, 26, 121, 40}},
 {{164, 50, 31, 137, 154, 133, 25, 35, 218}, {51, 103, 44, 131, 131, 123, 31, 6, 158}, {86, 40, 64, 135, 148, 224, 45, 183, 128}, {22, 26, 17, 131, 240, 154, 14, 1, 209}, {45, 16, 21, 91, 64, 222, 7, 1, 197}, {56, 21, 39, 155, 60, 138, 23, 102, 213}, {83, 12, 13, 54, 192, 255, 68, 47, 28}, {85, 26, 85, 85, 128, 128, 32, 146, 171}, {18, 11, 7, 63, 144, 171, 4, 4, 246}, {35, 27, 10, 146, 174, 171, 12, 26, 128}},
 {{190, 80, 35, 99, 180, 80, 126, 54, 45}, {85, 126, 47, 87, 176, 51, 41, 20, 32}, {101, 75, 128, 139, 118, 146, 116, 128, 85}, {56, 41, 15, 176, 236, 85, 37, 9, 62}, {71, 30, 17, 119, 118, 255, 17, 18, 138}, {101, 38, 60, 138, 55, 70, 43, 26, 142}, {146, 36, 19, 30, 171, 255, 97, 27, 20}, {138, 45, 61, 62, 219, 1, 81, 188, 64}, {32, 41, 20, 117, 151, 142, 20, 21, 163}, {112, 19, 12, 61, 195, 128, 48, 4, 24}}};

// Modes in libwebp's numbering: the ten 4x4 modes, of which the first four
// double as the 16x16 and chroma modes (DC, TM, V, H).
enum { B_DC = 0, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };

// The 4x4 mode tree: a node i reads prob[i]; a leaf is -mode.
const int8_t kYModesIntra4[18] = {-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5,
                                  -B_RD, -B_VR, -B_LD, 7, -B_VL, 8, -B_HD, -B_HU};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

inline int clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

// ---------------------------------------------------------------------------
// The boolean decoder (RFC 6386 section 7) in libwebp's form: range kept
// less one, one byte loaded at a time. Past the end it reads zeros and sets
// eof the first time a bit needs a byte that is not there, which is where
// libwebp's VP8LoadFinalBytes sets it: the frame then fails.
// ---------------------------------------------------------------------------

struct BoolDecoder {
  const uint8_t* buf = nullptr;
  size_t size = 0, pos = 0;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 254;
  bool eof = false;

  void init(const uint8_t* data, size_t n) {
    buf = data;
    size = n;
    pos = 0;
    value = 0;
    bits = -8;
    range = 254;
    eof = false;
  }
  void load() {
    if (pos < size) {
      value = (value << 8) | buf[pos++];
    } else {
      value <<= 8;
      eof = true;
    }
    bits += 8;
  }
  int bit(int prob) {
    if (bits < 0) load();
    uint32_t r = range;
    const uint32_t split = (r * static_cast<uint32_t>(prob)) >> 8;
    const uint32_t v = static_cast<uint32_t>(value >> bits);
    int b;
    if (v > split) {
      r -= split;
      value -= static_cast<uint64_t>(split + 1) << bits;
      b = 1;
    } else {
      r = split + 1;
      b = 0;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return b;
  }
  // VP8GetSigned: libwebp's shortcut for a coefficient's sign, a bit at
  // probability 1/2 that always shifts by one. From range 254 a 0 leaves
  // 255, where VP8GetBit would renormalise to 127 without a shift; the
  // bits after it then split differently, so it is kept as libwebp has it.
  int sign(int v) {
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t val = static_cast<uint32_t>(value >> pos);
    const int32_t mask = static_cast<int32_t>(split - val) >> 31;  // -1 or 0
    bits -= 1;
    range += static_cast<uint32_t>(mask);
    range |= 1;
    value -= static_cast<uint64_t>((split + 1) & static_cast<uint32_t>(mask)) << pos;
    return (v ^ mask) - mask;
  }
  uint32_t value_bits(int n) {
    uint32_t v = 0;
    while (n-- > 0) v |= static_cast<uint32_t>(bit(0x80)) << n;
    return v;
  }
  int signed_value(int n) {
    const int v = static_cast<int>(value_bits(n));
    return bit(0x80) ? -v : v;
  }
};

// ---------------------------------------------------------------------------
// VP8 key frames
// ---------------------------------------------------------------------------

constexpr int BPS = 32;  // the stride of libwebp's work buffer
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;

struct QuantMatrix {
  int y1[2], y2[2], uv[2];
};

struct MBData {
  int16_t coeffs[384];
  uint8_t is_i4x4, uvmode, segment, skip;
  uint8_t imodes[16];
  uint32_t non_zero_y, non_zero_uv;
};

struct FInfo {
  uint8_t limit, ilevel, inner, hev_thresh;
};

struct TopSamples {
  uint8_t y[16], u[8], v[8];
};

#define DST(x, y) dst[(x) + (y) * BPS]
#define AVG3(a, b, c) (static_cast<uint8_t>(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) (((a) + (b) + 1) >> 1)

void TrueMotion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int left = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = static_cast<uint8_t>(clip8(top[x] + left - tl));
    dst += BPS;
  }
}

void Fill(uint8_t* dst, int v, int size) {
  for (int j = 0; j < size; ++j) memset(dst + j * BPS, v, size);
}

void VE4(uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  const uint8_t vals[4] = {AVG3(top[-1], top[0], top[1]), AVG3(top[0], top[1], top[2]),
                           AVG3(top[1], top[2], top[3]), AVG3(top[2], top[3], top[4])};
  for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
}

void HE4(uint8_t* dst) {
  const int A = dst[-1 - BPS], B = dst[-1], C = dst[-1 + BPS], D = dst[-1 + 2 * BPS], E = dst[-1 + 3 * BPS];
  memset(dst + 0 * BPS, AVG3(A, B, C), 4);
  memset(dst + 1 * BPS, AVG3(B, C, D), 4);
  memset(dst + 2 * BPS, AVG3(C, D, E), 4);
  memset(dst + 3 * BPS, AVG3(D, E, E), 4);
}

void DC4(uint8_t* dst) {
  uint32_t dc = 4;
  for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
  Fill(dst, dc >> 3, 4);
}

void RD4(uint8_t* dst) {
  const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  const int X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS];
  DST(0, 3) = AVG3(J, K, L);
  DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
  DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
  DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
  DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
  DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
  DST(3, 0) = AVG3(D, C, B);
}

void LD4(uint8_t* dst) {
  const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS];
  const int E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
  DST(0, 0) = AVG3(A, B, C);
  DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
  DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
  DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
  DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
  DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
  DST(3, 3) = AVG3(G, H, H);
}

void VR4(uint8_t* dst) {
  const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS];
  const int X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS];
  DST(0, 0) = DST(1, 2) = AVG2(X, A);
  DST(1, 0) = DST(2, 2) = AVG2(A, B);
  DST(2, 0) = DST(3, 2) = AVG2(B, C);
  DST(3, 0) = AVG2(C, D);
  DST(0, 3) = AVG3(K, J, I);
  DST(0, 2) = AVG3(J, I, X);
  DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
  DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
  DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
  DST(3, 1) = AVG3(B, C, D);
}

void VL4(uint8_t* dst) {
  const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS];
  const int E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
  DST(0, 0) = AVG2(A, B);
  DST(1, 0) = DST(0, 2) = AVG2(B, C);
  DST(2, 0) = DST(1, 2) = AVG2(C, D);
  DST(3, 0) = DST(2, 2) = AVG2(D, E);
  DST(0, 1) = AVG3(A, B, C);
  DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
  DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
  DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
  DST(3, 2) = AVG3(E, F, G);
  DST(3, 3) = AVG3(F, G, H);
}

void HU4(uint8_t* dst) {
  const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  DST(0, 0) = AVG2(I, J);
  DST(2, 0) = DST(0, 1) = AVG2(J, K);
  DST(2, 1) = DST(0, 2) = AVG2(K, L);
  DST(1, 0) = AVG3(I, J, K);
  DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
  DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
  DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
}

void HD4(uint8_t* dst) {
  const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  const int X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS];
  DST(0, 0) = DST(2, 1) = AVG2(I, X);
  DST(0, 1) = DST(2, 2) = AVG2(J, I);
  DST(0, 2) = DST(2, 3) = AVG2(K, J);
  DST(0, 3) = AVG2(L, K);
  DST(3, 0) = AVG3(A, B, C);
  DST(2, 0) = AVG3(X, A, B);
  DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
  DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
  DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
  DST(1, 3) = AVG3(L, K, J);
}

void PredLuma4(int mode, uint8_t* dst) {
  switch (mode) {
    case B_DC: DC4(dst); break;
    case B_TM: TrueMotion(dst, 4); break;
    case B_VE: VE4(dst); break;
    case B_HE: HE4(dst); break;
    case B_RD: RD4(dst); break;
    case B_VR: VR4(dst); break;
    case B_LD: LD4(dst); break;
    case B_VL: VL4(dst); break;
    case B_HD: HD4(dst); break;
    default: HU4(dst); break;
  }
}

// 16x16 luma (size 16) or 8x8 chroma (size 8); DC takes only the edges
// inside the frame (libwebp's CheckMode), 0x80 at its top-left macroblock.
void PredBlock(int mode, uint8_t* dst, int size, int mb_x, int mb_y) {
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case B_TM: TrueMotion(dst, size); return;
    case B_VE:
      for (int j = 0; j < size; ++j) memcpy(dst + j * BPS, dst - BPS, size);
      return;
    case B_HE:
      for (int j = 0; j < size; ++j) memset(dst + j * BPS, dst[j * BPS - 1], size);
      return;
    default: break;
  }
  int dc;
  if (mb_x > 0 && mb_y > 0) {
    dc = size;
    for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
    dc >>= shift + 1;
  } else if (mb_y > 0) {  // no left
    dc = size / 2;
    for (int j = 0; j < size; ++j) dc += dst[j - BPS];
    dc >>= shift;
  } else if (mb_x > 0) {  // no top
    dc = size / 2;
    for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
    dc >>= shift;
  } else {
    dc = 0x80;
  }
  Fill(dst, dc, size);
}

inline int Mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int Mul2(int a) { return (a * 35468) >> 16; }

inline void Store(uint8_t* dst, int x, int y, int v) { dst[x + y * BPS] = static_cast<uint8_t>(clip8(dst[x + y * BPS] + (v >> 3))); }

void TransformOne(const int16_t* in, uint8_t* dst) {
  int C[16], *tmp = C;
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = Mul2(in[4]) - Mul1(in[12]);
    const int d = Mul1(in[4]) + Mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = Mul2(tmp[4]) - Mul1(tmp[12]);
    const int d = Mul1(tmp[4]) + Mul2(tmp[12]);
    Store(dst, 0, 0, a + d);
    Store(dst, 1, 0, b + c);
    Store(dst, 2, 0, b - c);
    Store(dst, 3, 0, a - d);
    tmp++;
    dst += BPS;
  }
}

// libwebp's Transform_SSE2 (src/dsp/dec_sse2.c), which Pillow's builds run
// where a block has more than three coefficients (DoTransform) and on all
// four blocks of a chroma plane with any AC coefficient (DoUVTransform):
// TransformOne's arithmetic in 16-bit lanes, every sum wrapping. No valid
// stream's coefficients reach a wrap; a damaged stream's can, so the
// damaged frame reads as libwebp reads it.
void TransformSSE2(const int16_t* in, uint8_t* dst) {
  auto w = [](int v) { return static_cast<int16_t>(static_cast<uint16_t>(v)); };
  auto mulhi = [](int16_t x, int k) { return static_cast<int16_t>((static_cast<int32_t>(x) * k) >> 16); };
  auto pass = [&](const int16_t x[4], int16_t out[4], int bias) {
    const int16_t x0 = w(x[0] + bias);
    const int16_t a = w(x0 + x[2]), b = w(x0 - x[2]);
    const int16_t c = w(w(x[1] - x[3]) + w(mulhi(x[1], -30068) - mulhi(x[3], 20091)));
    const int16_t d = w(w(x[1] + x[3]) + w(mulhi(x[1], 20091) + mulhi(x[3], -30068)));
    out[0] = w(a + d);
    out[1] = w(b + c);
    out[2] = w(b - c);
    out[3] = w(a - d);
  };
  int16_t col[4][4];  // col[i][r]: the vertical pass's output r of column i
  for (int i = 0; i < 4; ++i) {
    const int16_t x[4] = {in[i], in[4 + i], in[8 + i], in[12 + i]};
    pass(x, col[i], 0);
  }
  for (int r = 0; r < 4; ++r) {
    const int16_t x[4] = {col[0][r], col[1][r], col[2][r], col[3][r]};
    int16_t out[4];
    pass(x, out, 4);
    for (int c = 0; c < 4; ++c) dst[c + r * BPS] = static_cast<uint8_t>(clip8(dst[c + r * BPS] + (out[c] >> 3)));
  }
}

// DoTransform: a block's nonzero-coefficient code (3: more than three,
// 2: up to three, 1: the DC alone) picks the SSE2 transform or the C ones
// (TransformAC3, TransformDC), which TransformOne equals on such blocks.
inline void DoTransform(uint32_t code, const int16_t* in, uint8_t* dst) {
  if (code == 3) TransformSSE2(in, dst);
  else if (code) TransformOne(in, dst);
}

void TransformWHT(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    out += 64;
  }
}

// The loop filters (src/dsp/dec.c), on 8-bit samples p with the edge
// between p[-step] and p[0].
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // [-1020, 1020] -> [-128, 127]
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // [-112, 112] -> [-16, 15]

inline void DoFilter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = static_cast<uint8_t>(clip8(p0 + a2));
  p[0] = static_cast<uint8_t>(clip8(q0 - a1));
}

inline void DoFilter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = static_cast<uint8_t>(clip8(p1 + a3));
  p[-step] = static_cast<uint8_t>(clip8(p0 + a2));
  p[0] = static_cast<uint8_t>(clip8(q0 - a1));
  p[step] = static_cast<uint8_t>(clip8(q1 - a3));
}

inline void DoFilter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = static_cast<uint8_t>(clip8(p2 + a3));
  p[-2 * step] = static_cast<uint8_t>(clip8(p1 + a2));
  p[-step] = static_cast<uint8_t>(clip8(p0 + a1));
  p[0] = static_cast<uint8_t>(clip8(q0 - a1));
  p[step] = static_cast<uint8_t>(clip8(q1 - a2));
  p[2 * step] = static_cast<uint8_t>(clip8(q2 - a3));
}

inline bool Hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool NeedsFilter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool NeedsFilter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

void SimpleFilter16(uint8_t* p, int hstride, int vstride, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i)
    if (NeedsFilter(p + i * vstride, hstride, thresh2)) DoFilter2(p + i * vstride, hstride);
}

// hstride crosses the edge, vstride walks along it; six taps on a
// macroblock edge, four on an inner one.
void FilterLoop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh, int hev_thresh, bool mb_edge) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (NeedsFilter2(p, hstride, thresh2, ithresh)) {
      if (Hev(p, hstride, hev_thresh)) {
        DoFilter2(p, hstride);
      } else if (mb_edge) {
        DoFilter6(p, hstride);
      } else {
        DoFilter4(p, hstride);
      }
    }
    p += vstride;
  }
}

class VP8Decoder {
 public:
  VP8Decoder(const uint8_t* data, size_t size) { ParseHeaders(data, size); }

  int width = 0, height = 0;

  // Decodes the frame into RGBA rows of `stride` bytes at `out`, its
  // alpha from `alpha` (ALPH's payload) or 0xff without one.
  void Decode(const uint8_t* alpha, size_t alpha_size, uint8_t* out, int64_t stride);

 private:
  int mb_w = 0, mb_h = 0;
  BoolDecoder br;
  BoolDecoder parts[8];
  int num_parts_minus_one = 0;
  // segment header
  int use_segment = 0, update_map = 0, absolute_delta = 1;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  uint8_t segments_proba[3] = {255, 255, 255};
  // filter header
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  int filter_type = 0;
  QuantMatrix dqm[4];
  uint8_t proba[4][8][3][11];
  int use_skip_proba = 0, skip_p = 0;
  FInfo fstrengths[4][2];

  void ParseHeaders(const uint8_t* data, size_t size);
  void ParseQuant();
  void PrecomputeFilterStrengths();
  void ParseIntraMode(MBData* block, uint8_t* top, uint8_t* left);
  int GetCoeffs(BoolDecoder& tb, int type, int ctx, const int* dq, int n, int16_t* out);
  int GetLargeValue(BoolDecoder& tb, const uint8_t* p);
  bool ParseResiduals(BoolDecoder& tb, MBData* block, uint8_t* mb_nz, uint8_t* mb_nz_dc, uint8_t* left_nz,
                      uint8_t* left_nz_dc);
};

void VP8Decoder::ParseHeaders(const uint8_t* buf, size_t buf_size) {
  if (buf_size < 4) fail("VP8: truncated header");
  const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
  const bool key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7;
  const int show = (bits >> 4) & 1;
  const uint32_t partition_length = bits >> 5;
  if (profile > 3) fail("VP8: profile " + std::to_string(profile) + " (incorrect keyframe parameters)");
  if (!show) fail("VP8: frame not displayable");
  buf += 3;
  buf_size -= 3;
  if (!key_frame) fail("VP8: an interframe, not a key frame");
  if (buf_size < 7) fail("VP8: cannot parse picture header");
  if (!(buf[0] == 0x9d && buf[1] == 0x01 && buf[2] == 0x2a)) fail("VP8: bad start code");
  width = ((buf[4] << 8) | buf[3]) & 0x3fff;
  height = ((buf[6] << 8) | buf[5]) & 0x3fff;
  buf += 7;
  buf_size -= 7;
  mb_w = (width + 15) >> 4;
  mb_h = (height + 15) >> 4;
  memcpy(proba, kCoeffsProba0, sizeof(proba));
  if (partition_length > buf_size) fail("VP8: bad partition length");
  br.init(buf, partition_length);
  buf += partition_length;
  buf_size -= partition_length;
  br.value_bits(1);  // colour space
  br.value_bits(1);  // clamping type
  // segment header
  use_segment = br.value_bits(1);
  if (use_segment) {
    update_map = br.value_bits(1);
    if (br.value_bits(1)) {
      absolute_delta = br.value_bits(1);
      for (int s = 0; s < 4; ++s) quantizer[s] = br.value_bits(1) ? br.signed_value(7) : 0;
      for (int s = 0; s < 4; ++s) filter_strength[s] = br.value_bits(1) ? br.signed_value(6) : 0;
    }
    if (update_map)
      for (int s = 0; s < 3; ++s) segments_proba[s] = br.value_bits(1) ? static_cast<uint8_t>(br.value_bits(8)) : 255;
  } else {
    update_map = 0;
  }
  if (br.eof) fail("VP8: cannot parse segment header");
  // filter header
  simple = br.value_bits(1);
  level = br.value_bits(6);
  sharpness = br.value_bits(3);
  use_lf_delta = br.value_bits(1);
  if (use_lf_delta && br.value_bits(1)) {
    for (int i = 0; i < 4; ++i)
      if (br.value_bits(1)) ref_lf_delta[i] = br.signed_value(6);
    for (int i = 0; i < 4; ++i)
      if (br.value_bits(1)) mode_lf_delta[i] = br.signed_value(6);
  }
  filter_type = level == 0 ? 0 : simple ? 1 : 2;
  if (br.eof) fail("VP8: cannot parse filter header");
  // partitions: sizes of all but the last in three bytes each, the last
  // taking what is left (each size clipped to what is left)
  num_parts_minus_one = (1 << br.value_bits(2)) - 1;
  const size_t last_part = num_parts_minus_one;
  if (buf_size < 3 * last_part) fail("VP8: cannot parse partitions");
  const uint8_t* sz = buf;
  const uint8_t* part_start = buf + last_part * 3;
  size_t size_left = buf_size - last_part * 3;
  for (size_t p = 0; p < last_part; ++p) {
    size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > size_left) psize = size_left;
    parts[p].init(part_start, psize);
    part_start += psize;
    size_left -= psize;
    sz += 3;
  }
  parts[last_part].init(part_start, size_left);
  if (!(part_start < buf + buf_size)) fail("VP8: cannot parse partitions (the last one is empty)");
  ParseQuant();
  br.value_bits(1);  // refresh entropy probabilities: ignored, as libwebp does
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          if (br.bit(kCoeffsUpdateProba[t][b][c][p])) proba[t][b][c][p] = static_cast<uint8_t>(br.value_bits(8));
  use_skip_proba = br.value_bits(1);
  if (use_skip_proba) skip_p = br.value_bits(8);
}

void VP8Decoder::ParseQuant() {
  const int base_q0 = br.value_bits(7);
  const int dqy1_dc = br.value_bits(1) ? br.signed_value(4) : 0;
  const int dqy2_dc = br.value_bits(1) ? br.signed_value(4) : 0;
  const int dqy2_ac = br.value_bits(1) ? br.signed_value(4) : 0;
  const int dquv_dc = br.value_bits(1) ? br.signed_value(4) : 0;
  const int dquv_ac = br.value_bits(1) ? br.signed_value(4) : 0;
  auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  for (int i = 0; i < 4; ++i) {
    int q;
    if (use_segment) {
      q = quantizer[i];
      if (!absolute_delta) q += base_q0;
    } else {
      if (i > 0) {
        dqm[i] = dqm[0];
        continue;
      }
      q = base_q0;
    }
    QuantMatrix& m = dqm[i];
    m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
    m.y1[1] = kAcTable[clip(q, 127)];
    m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    // x * 155 / 100 as libwebp computes it
    m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
    m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
  }
}

void VP8Decoder::PrecomputeFilterStrengths() {
  if (filter_type == 0) return;
  for (int s = 0; s < 4; ++s) {
    int base_level;
    if (use_segment) {
      base_level = filter_strength[s];
      if (!absolute_delta) base_level += level;
    } else {
      base_level = level;
    }
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FInfo& info = fstrengths[s][i4x4];
      int lvl = base_level;
      if (use_lf_delta) {
        lvl += ref_lf_delta[0];
        if (i4x4) lvl += mode_lf_delta[0];
      }
      lvl = lvl < 0 ? 0 : lvl > 63 ? 63 : lvl;
      if (lvl > 0) {
        int ilevel = lvl;
        if (sharpness > 0) {
          ilevel >>= sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        info.ilevel = static_cast<uint8_t>(ilevel);
        info.limit = static_cast<uint8_t>(2 * lvl + ilevel);
        info.hev_thresh = lvl >= 40 ? 2 : lvl >= 15 ? 1 : 0;
      } else {
        info.limit = 0;
        info.ilevel = 0;
        info.hev_thresh = 0;
      }
      info.inner = static_cast<uint8_t>(i4x4);
    }
  }
}

void VP8Decoder::ParseIntraMode(MBData* block, uint8_t* top, uint8_t* left) {
  if (update_map) {
    block->segment = !br.bit(segments_proba[0]) ? br.bit(segments_proba[1]) : br.bit(segments_proba[2]) + 2;
  } else {
    block->segment = 0;
  }
  block->skip = use_skip_proba ? br.bit(skip_p) : 0;
  block->is_i4x4 = !br.bit(145);
  if (!block->is_i4x4) {
    const int ymode = br.bit(156) ? (br.bit(128) ? B_TM : B_HE) : (br.bit(163) ? B_VE : B_DC);
    block->imodes[0] = static_cast<uint8_t>(ymode);
    memset(top, ymode, 4);
    memset(left, ymode, 4);
  } else {
    uint8_t* modes = block->imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* prob = kBModesProba[top[x]][ymode];
        int i = kYModesIntra4[br.bit(prob[0])];
        while (i > 0) i = kYModesIntra4[2 * i + br.bit(prob[i])];
        ymode = -i;
        top[x] = static_cast<uint8_t>(ymode);
      }
      memcpy(modes, top, 4);
      modes += 4;
      left[y] = static_cast<uint8_t>(ymode);
    }
  }
  block->uvmode = !br.bit(142) ? B_DC : !br.bit(114) ? B_VE : br.bit(183) ? B_TM : B_HE;
}

int VP8Decoder::GetLargeValue(BoolDecoder& tb, const uint8_t* p) {
  int v;
  if (!tb.bit(p[3])) {
    if (!tb.bit(p[4])) {
      v = 2;
    } else {
      v = 3 + tb.bit(p[5]);
    }
  } else {
    if (!tb.bit(p[6])) {
      if (!tb.bit(p[7])) {
        v = 5 + tb.bit(159);
      } else {
        v = 7 + 2 * tb.bit(165);
        v += tb.bit(145);
      }
    } else {
      const int bit1 = tb.bit(p[8]);
      const int bit0 = tb.bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + tb.bit(*tab);
      v += 3 + (8 << cat);
    }
  }
  return v;
}

// The coefficients of one 4x4 block from position n on, dequantised into
// out in raster order; returns the index after the last non-zero one.
int VP8Decoder::GetCoeffs(BoolDecoder& tb, int type, int ctx, const int* dq, int n, int16_t* out) {
  const uint8_t* p = proba[type][kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!tb.bit(p[0])) return n;  // end of block
    while (!tb.bit(p[1])) {       // a zero
      p = proba[type][kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    if (!tb.bit(p[2])) {
      v = 1;
      p = proba[type][kBands[n + 1]][1];
    } else {
      v = GetLargeValue(tb, p);
      p = proba[type][kBands[n + 1]][2];
    }
    out[kZigzag[n]] = static_cast<int16_t>(tb.sign(v) * dq[n > 0]);
  }
  return 16;
}

inline uint32_t NzCodeBits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
  return nz_coeffs;
}

// Returns true when every coefficient of the macroblock is zero.
bool VP8Decoder::ParseResiduals(BoolDecoder& tb, MBData* block, uint8_t* mb_nz, uint8_t* mb_nz_dc, uint8_t* left_nz,
                                uint8_t* left_nz_dc) {
  const QuantMatrix& q = dqm[block->segment];
  int16_t* dst = block->coeffs;
  memset(dst, 0, 384 * sizeof(*dst));
  int first, ac_type;
  if (!block->is_i4x4) {  // the DCs of the 16 blocks, through the WHT
    int16_t dc[16] = {0};
    const int ctx = *mb_nz_dc + *left_nz_dc;
    const int nz = GetCoeffs(tb, 1, ctx, q.y2, 0, dc);
    *mb_nz_dc = *left_nz_dc = (nz > 0);
    if (nz > 1) {
      TransformWHT(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 16 * 16; i += 16) dst[i] = static_cast<int16_t>(dc0);
    }
    first = 1;
    ac_type = 0;
  } else {
    first = 0;
    ac_type = 3;
  }
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  uint8_t tnz = *mb_nz & 0x0f;
  uint8_t lnz = *left_nz & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int nz = GetCoeffs(tb, ac_type, ctx, q.y1, first, dst);
      l = (nz > first);
      tnz = static_cast<uint8_t>((tnz >> 1) | (l << 7));
      nz_coeffs = NzCodeBits(nz_coeffs, nz, dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = static_cast<uint8_t>((lnz >> 1) | (l << 7));
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  uint32_t out_t_nz = tnz;
  uint32_t out_l_nz = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nz_coeffs = 0;
    tnz = static_cast<uint8_t>(*mb_nz >> (4 + ch));
    lnz = static_cast<uint8_t>(*left_nz >> (4 + ch));
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = GetCoeffs(tb, 2, ctx, q.uv, 0, dst);
        l = (nz > 0);
        tnz = static_cast<uint8_t>((tnz >> 1) | (l << 3));
        nz_coeffs = NzCodeBits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = static_cast<uint8_t>((lnz >> 1) | (l << 5));
    }
    non_zero_uv |= nz_coeffs << (4 * ch);
    out_t_nz |= (tnz << 4) << ch;
    out_l_nz |= (lnz & 0xf0) << ch;
  }
  *mb_nz = static_cast<uint8_t>(out_t_nz);
  *left_nz = static_cast<uint8_t>(out_l_nz);
  block->non_zero_y = non_zero_y;
  block->non_zero_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

// libwebp's fancy upsampler of one pair of output rows (UPSAMPLE_FUNC in
// src/dsp/upsampling.c) with u and v packed in the two halves of a word,
// as it computes them; bottom_y may be null.
inline int MultHi(int v, int coeff) { return (v * coeff) >> 8; }
inline int YuvClip8(int v) { return ((v & ~16383) == 0) ? (v >> 6) : (v < 0) ? 0 : 255; }

inline void YuvToRgba(int y, int u, int v, uint8_t* rgba) {
  rgba[0] = static_cast<uint8_t>(YuvClip8(MultHi(y, 19077) + MultHi(v, 26149) - 14234));
  rgba[1] = static_cast<uint8_t>(YuvClip8(MultHi(y, 19077) - MultHi(u, 6419) - MultHi(v, 13320) + 8708));
  rgba[2] = static_cast<uint8_t>(YuvClip8(MultHi(y, 19077) + MultHi(u, 33050) - 17685));
}

inline uint32_t LoadUV(uint8_t u, uint8_t v) { return u | (static_cast<uint32_t>(v) << 16); }

void UpsampleRgbaLinePair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u, const uint8_t* top_v,
                          const uint8_t* cur_u, const uint8_t* cur_v, uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  const int last_pixel_pair = (len - 1) >> 1;
  uint32_t tl_uv = LoadUV(top_u[0], top_v[0]);
  uint32_t l_uv = LoadUV(cur_u[0], cur_v[0]);
  {
    const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
    YuvToRgba(top_y[0], uv0 & 0xff, uv0 >> 16, top_dst);
  }
  if (bottom_y != nullptr) {
    const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
    YuvToRgba(bottom_y[0], uv0 & 0xff, uv0 >> 16, bottom_dst);
  }
  for (int x = 1; x <= last_pixel_pair; ++x) {
    const uint32_t t_uv = LoadUV(top_u[x], top_v[x]);
    const uint32_t uv = LoadUV(cur_u[x], cur_v[x]);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    {
      const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
      const uint32_t uv1 = (diag_03 + t_uv) >> 1;
      YuvToRgba(top_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, top_dst + (2 * x - 1) * 4);
      YuvToRgba(top_y[2 * x - 0], uv1 & 0xff, uv1 >> 16, top_dst + (2 * x - 0) * 4);
    }
    if (bottom_y != nullptr) {
      const uint32_t uv0 = (diag_03 + l_uv) >> 1;
      const uint32_t uv1 = (diag_12 + uv) >> 1;
      YuvToRgba(bottom_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (2 * x - 1) * 4);
      YuvToRgba(bottom_y[2 * x + 0], uv1 & 0xff, uv1 >> 16, bottom_dst + (2 * x + 0) * 4);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    {
      const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
      YuvToRgba(top_y[len - 1], uv0 & 0xff, uv0 >> 16, top_dst + (len - 1) * 4);
    }
    if (bottom_y != nullptr) {
      const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
      YuvToRgba(bottom_y[len - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (len - 1) * 4);
    }
  }
}

void DecodeAlphaPlane(const uint8_t* data, size_t size, int width, int height, uint8_t* plane);

void VP8Decoder::Decode(const uint8_t* alpha, size_t alpha_size, uint8_t* out, int64_t stride) {
  PrecomputeFilterStrengths();
  const int y_stride = mb_w * 16, uv_stride = mb_w * 8;
  std::vector<uint8_t> Y(static_cast<size_t>(y_stride) * mb_h * 16), U(static_cast<size_t>(uv_stride) * mb_h * 8),
      V(static_cast<size_t>(uv_stride) * mb_h * 8);
  std::vector<FInfo> finfo(static_cast<size_t>(mb_w) * mb_h);
  std::vector<MBData> row(mb_w);
  std::vector<uint8_t> intra_t(4 * mb_w, B_DC);
  std::vector<uint8_t> nz(mb_w + 1, 0), nz_dc(mb_w + 1, 0);  // [0] is the left macroblock
  std::vector<TopSamples> yuv_t(mb_w);
  uint8_t yuv_b[YUV_SIZE];
  memset(yuv_b, 0, sizeof(yuv_b));
  uint8_t* const y_dst = yuv_b + Y_OFF;
  uint8_t* const u_dst = yuv_b + U_OFF;
  uint8_t* const v_dst = yuv_b + V_OFF;

  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    BoolDecoder& tb = parts[mb_y & num_parts_minus_one];
    uint8_t intra_l[4];
    memset(intra_l, B_DC, 4);
    nz[0] = nz_dc[0] = 0;
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) ParseIntraMode(&row[mb_x], &intra_t[4 * mb_x], intra_l);
    if (br.eof) fail("VP8: premature end of partition 0");
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MBData* block = &row[mb_x];
      bool skip = use_skip_proba ? block->skip : false;
      if (!skip) {
        skip = ParseResiduals(tb, block, &nz[mb_x + 1], &nz_dc[mb_x + 1], &nz[0], &nz_dc[0]);
      } else {
        nz[0] = nz[mb_x + 1] = 0;
        if (!block->is_i4x4) nz_dc[0] = nz_dc[mb_x + 1] = 0;
        block->non_zero_y = block->non_zero_uv = 0;
      }
      if (filter_type > 0) {
        FInfo f = fstrengths[block->segment][block->is_i4x4];
        f.inner |= !skip;
        finfo[static_cast<size_t>(mb_y) * mb_w + mb_x] = f;
      }
      if (tb.eof) fail("VP8: premature end of a token partition");
    }
    // Reconstruct the row (libwebp's ReconstructRow), from unfiltered samples.
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      memset(u_dst - BPS - 1, 127, 8 + 1);
      memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const MBData* block = &row[mb_x];
      if (mb_x > 0) {
        for (int j = -1; j < 16; ++j) memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
        for (int j = -1; j < 8; ++j) {
          memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
          memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
        }
      }
      TopSamples* top_yuv = &yuv_t[mb_x];
      const int16_t* coeffs = block->coeffs;
      uint32_t bits = block->non_zero_y;
      if (mb_y > 0) {
        memcpy(y_dst - BPS, top_yuv[0].y, 16);
        memcpy(u_dst - BPS, top_yuv[0].u, 8);
        memcpy(v_dst - BPS, top_yuv[0].v, 8);
      }
      if (block->is_i4x4) {
        uint8_t* top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w - 1) {
            memset(top_right, top_yuv[0].y[15], 4);
          } else {
            memcpy(top_right, top_yuv[1].y, 4);
          }
        }
        // the samples above-right of the 4x4 blocks of the last column
        for (int r = 1; r <= 3; ++r) memcpy(top_right + r * 4 * BPS, top_right, 4);
        static const int kScan[16] = {0 + 0 * BPS,  4 + 0 * BPS,  8 + 0 * BPS,  12 + 0 * BPS,
                                      0 + 4 * BPS,  4 + 4 * BPS,  8 + 4 * BPS,  12 + 4 * BPS,
                                      0 + 8 * BPS,  4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS,
                                      0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};
        for (int n = 0; n < 16; ++n, bits <<= 2) {
          uint8_t* dst = y_dst + kScan[n];
          PredLuma4(block->imodes[n], dst);
          DoTransform(bits >> 30, coeffs + n * 16, dst);
        }
      } else {
        PredBlock(block->imodes[0], y_dst, 16, mb_x, mb_y);
        for (int n = 0; n < 16; ++n, bits <<= 2)
          DoTransform(bits >> 30, coeffs + n * 16, y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
      }
      PredBlock(block->uvmode, u_dst, 8, mb_x, mb_y);
      PredBlock(block->uvmode, v_dst, 8, mb_x, mb_y);
      for (int ch = 0; ch < 2; ++ch) {  // DoUVTransform
        uint8_t* dst = ch ? v_dst : u_dst;
        const int16_t* c = coeffs + (16 + 4 * ch) * 16;
        // A skipped macroblock's coefficients are those of the one above
        // it: its codes, not its coefficients, say whether to transform.
        const uint32_t uv_bits = (block->non_zero_uv >> (8 * ch)) & 0xff;
        for (int n = 0; n < 4 && uv_bits; ++n) {
          uint8_t* d = dst + (n & 1) * 4 + (n >> 1) * 4 * BPS;
          if (uv_bits & 0xaa) TransformSSE2(c + n * 16, d);  // TransformUV
          else if (c[n * 16]) TransformOne(c + n * 16, d);     // TransformDCUV
        }
      }
      if (mb_y < mb_h - 1) {
        memcpy(top_yuv[0].y, y_dst + 15 * BPS, 16);
        memcpy(top_yuv[0].u, u_dst + 7 * BPS, 8);
        memcpy(top_yuv[0].v, v_dst + 7 * BPS, 8);
      }
      for (int j = 0; j < 16; ++j)
        memcpy(&Y[static_cast<size_t>(mb_y * 16 + j) * y_stride + mb_x * 16], y_dst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        memcpy(&U[static_cast<size_t>(mb_y * 8 + j) * uv_stride + mb_x * 8], u_dst + j * BPS, 8);
        memcpy(&V[static_cast<size_t>(mb_y * 8 + j) * uv_stride + mb_x * 8], v_dst + j * BPS, 8);
      }
    }
  }
  // The loop filter over the frame, macroblock by macroblock (DoFilter).
  if (filter_type > 0) {
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        const FInfo& f = finfo[static_cast<size_t>(mb_y) * mb_w + mb_x];
        const int limit = f.limit;
        if (limit == 0) continue;
        uint8_t* yp = &Y[static_cast<size_t>(mb_y * 16) * y_stride + mb_x * 16];
        if (filter_type == 1) {
          if (mb_x > 0) SimpleFilter16(yp, 1, y_stride, limit + 4);
          if (f.inner)
            for (int k = 1; k <= 3; ++k) SimpleFilter16(yp + 4 * k, 1, y_stride, limit);
          if (mb_y > 0) SimpleFilter16(yp, y_stride, 1, limit + 4);
          if (f.inner)
            for (int k = 1; k <= 3; ++k) SimpleFilter16(yp + 4 * k * y_stride, y_stride, 1, limit);
        } else {
          uint8_t* up = &U[static_cast<size_t>(mb_y * 8) * uv_stride + mb_x * 8];
          uint8_t* vp = &V[static_cast<size_t>(mb_y * 8) * uv_stride + mb_x * 8];
          const int il = f.ilevel, hev = f.hev_thresh;
          if (mb_x > 0) {
            FilterLoop(yp, 1, y_stride, 16, limit + 4, il, hev, true);
            FilterLoop(up, 1, uv_stride, 8, limit + 4, il, hev, true);
            FilterLoop(vp, 1, uv_stride, 8, limit + 4, il, hev, true);
          }
          if (f.inner) {
            for (int k = 1; k <= 3; ++k) FilterLoop(yp + 4 * k, 1, y_stride, 16, limit, il, hev, false);
            FilterLoop(up + 4, 1, uv_stride, 8, limit, il, hev, false);
            FilterLoop(vp + 4, 1, uv_stride, 8, limit, il, hev, false);
          }
          if (mb_y > 0) {
            FilterLoop(yp, y_stride, 1, 16, limit + 4, il, hev, true);
            FilterLoop(up, uv_stride, 1, 8, limit + 4, il, hev, true);
            FilterLoop(vp, uv_stride, 1, 8, limit + 4, il, hev, true);
          }
          if (f.inner) {
            for (int k = 1; k <= 3; ++k) FilterLoop(yp + 4 * k * y_stride, y_stride, 1, 16, limit, il, hev, false);
            FilterLoop(up + 4 * uv_stride, uv_stride, 1, 8, limit, il, hev, false);
            FilterLoop(vp + 4 * uv_stride, uv_stride, 1, 8, limit, il, hev, false);
          }
        }
      }
    }
  }
  // RGBA through the fancy upsampler (EmitFancyRGB), cropped to the frame.
  const int w = width, h = height;
  auto yrow = [&](int y) { return &Y[static_cast<size_t>(y) * y_stride]; };
  auto urow = [&](int y) { return &U[static_cast<size_t>(y) * uv_stride]; };
  auto vrow = [&](int y) { return &V[static_cast<size_t>(y) * uv_stride]; };
  auto orow = [&](int y) { return out + static_cast<int64_t>(y) * stride; };
  UpsampleRgbaLinePair(yrow(0), nullptr, urow(0), vrow(0), urow(0), vrow(0), orow(0), nullptr, w);
  int y = 0;
  for (; y + 2 < h; y += 2)
    UpsampleRgbaLinePair(yrow(y + 1), yrow(y + 2), urow(y / 2), vrow(y / 2), urow(y / 2 + 1), vrow(y / 2 + 1),
                         orow(y + 1), orow(y + 2), w);
  if (!(h & 1))
    UpsampleRgbaLinePair(yrow(y + 1), nullptr, urow(y / 2), vrow(y / 2), urow(y / 2), vrow(y / 2), orow(y + 1),
                         nullptr, w);
  if (alpha != nullptr) {
    std::vector<uint8_t> plane(static_cast<size_t>(w) * h);
    DecodeAlphaPlane(alpha, alpha_size, w, h, plane.data());
    for (int yy = 0; yy < h; ++yy)
      for (int x = 0; x < w; ++x) orow(yy)[4 * x + 3] = plane[static_cast<size_t>(yy) * w + x];
  } else {
    for (int yy = 0; yy < h; ++yy)
      for (int x = 0; x < w; ++x) orow(yy)[4 * x + 3] = 0xff;
  }
}

// ---------------------------------------------------------------------------
// VP8L
// ---------------------------------------------------------------------------

// Bits least significant first. libwebp's reader keeps the last 8 bytes in
// a 64-bit window and marks the end of the stream once more bits were taken
// than the window and the data held; a read past it gives 0.
struct BitReader {
  const uint8_t* buf;
  size_t size;
  uint64_t consumed = 0;  // bits
  bool eos = false;

  BitReader(const uint8_t* data, size_t n) : buf(data), size(n) {}

  uint32_t peek(int n) const {
    const uint64_t byte = consumed >> 3;
    const int off = static_cast<int>(consumed & 7);
    uint64_t v = 0;
    if (byte + 8 <= size) {
      memcpy(&v, buf + byte, 8);  // little-endian host
    } else {
      for (uint64_t i = 0; i < 8 && byte + i < size; ++i) v |= static_cast<uint64_t>(buf[byte + i]) << (8 * i);
    }
    return static_cast<uint32_t>((v >> off) & ((1ull << n) - 1));
  }
  void skip(int n) {
    consumed += n;
    if (consumed > std::max<uint64_t>(64, 8 * static_cast<uint64_t>(size))) eos = true;
  }
  uint32_t read(int n) {
    if (eos) return 0;
    const uint32_t v = peek(n);
    skip(n);
    return v;
  }
};

constexpr int kMaxCodeLength = 15;
constexpr int kTableBits = 8;

// A canonical prefix code, read first bit first as its most significant;
// codes of up to kTableBits bits through a table, longer ones bit by bit.
struct HuffmanCode {
  int single = -1;  // the symbol of a one-symbol code, which reads no bits
  uint16_t table[1 << kTableBits];  // symbol << 4 | length, 0 for a longer code
  int count[kMaxCodeLength + 1];
  int first[kMaxCodeLength + 1];   // first canonical code of each length
  int offset[kMaxCodeLength + 1];  // its index in `sorted`
  std::vector<uint16_t> sorted;

  int read(BitReader& br) const {
    if (single >= 0) return single;
    const uint32_t bits = br.peek(kMaxCodeLength);
    const uint16_t e = table[bits & ((1 << kTableBits) - 1)];
    if (e) {
      br.skip(e & 15);
      return e >> 4;
    }
    int code = 0;
    for (int len = 1; len <= kMaxCodeLength; ++len) {
      code = (code << 1) | ((bits >> (len - 1)) & 1);
      if (code - first[len] < count[len]) {
        br.skip(len);
        return sorted[offset[len] + code - first[len]];
      }
    }
    fail("VP8L: invalid prefix code");
  }
};

// False for what libwebp's BuildHuffmanTable refuses: no symbol, or an
// over- or under-subscribed code of more than one symbol.
bool BuildCode(const int* lengths, int n, HuffmanCode* code) {
  int count[kMaxCodeLength + 1] = {0};
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > kMaxCodeLength) return false;
    ++count[lengths[s]];
  }
  if (count[0] == n) return false;
  if (n - count[0] == 1) {
    if (code != nullptr)
      for (int s = 0; s < n; ++s)
        if (lengths[s]) code->single = s;
    return true;
  }
  int open = 1;
  for (int len = 1; len <= kMaxCodeLength; ++len) {
    open = 2 * open - count[len];
    if (open < 0) return false;
  }
  if (open != 0) return false;
  if (code == nullptr) return true;
  code->single = -1;
  memcpy(code->count, count, sizeof(count));
  code->count[0] = 0;
  int next = 0, idx = 0;
  for (int len = 1; len <= kMaxCodeLength; ++len) {
    code->first[len] = next;
    code->offset[len] = idx;
    idx += count[len];
    next = (next + count[len]) << 1;
  }
  code->sorted.assign(idx, 0);
  int fill[kMaxCodeLength + 1];
  memcpy(fill, code->offset, sizeof(fill));
  memset(code->table, 0, sizeof(code->table));
  for (int s = 0; s < n; ++s) {
    const int len = lengths[s];
    if (!len) continue;
    const int k = fill[len]++;
    code->sorted[k] = static_cast<uint16_t>(s);
    if (len <= kTableBits) {
      const int c = code->first[len] + (k - code->offset[len]);
      int rev = 0;
      for (int i = 0; i < len; ++i) rev |= ((c >> (len - 1 - i)) & 1) << i;
      for (int f = rev; f < (1 << kTableBits); f += 1 << len) code->table[f] = static_cast<uint16_t>(s << 4 | len);
    }
  }
  return true;
}

const int kAlphabetSize[5] = {256 + 24, 256, 256, 256, 40};
const uint8_t kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
// The 120 short distance codes: (dx, dy) of the pixel referred to, as in
// the lossless format's distance map.
const int8_t kDistanceMap[120][2] = {
    {0, 1},  {1, 0},  {1, 1},  {-1, 1}, {0, 2},  {2, 0},  {1, 2},  {-1, 2}, {2, 1},  {-2, 1}, {2, 2},  {-2, 2},
    {0, 3},  {3, 0},  {1, 3},  {-1, 3}, {3, 1},  {-3, 1}, {2, 3},  {-2, 3}, {3, 2},  {-3, 2}, {0, 4},  {4, 0},
    {1, 4},  {-1, 4}, {4, 1},  {-4, 1}, {3, 3},  {-3, 3}, {2, 4},  {-2, 4}, {4, 2},  {-4, 2}, {0, 5},  {3, 4},
    {-3, 4}, {4, 3},  {-4, 3}, {5, 0},  {1, 5},  {-1, 5}, {5, 1},  {-5, 1}, {2, 5},  {-2, 5}, {5, 2},  {-5, 2},
    {4, 4},  {-4, 4}, {3, 5},  {-3, 5}, {5, 3},  {-5, 3}, {0, 6},  {6, 0},  {1, 6},  {-1, 6}, {6, 1},  {-6, 1},
    {2, 6},  {-2, 6}, {6, 2},  {-6, 2}, {4, 5},  {-4, 5}, {5, 4},  {-5, 4}, {3, 6},  {-3, 6}, {6, 3},  {-6, 3},
    {0, 7},  {7, 0},  {1, 7},  {-1, 7}, {5, 5},  {-5, 5}, {7, 1},  {-7, 1}, {4, 6},  {-4, 6}, {6, 4},  {-6, 4},
    {2, 7},  {-2, 7}, {7, 2},  {-7, 2}, {3, 7},  {-3, 7}, {7, 3},  {-7, 3}, {5, 6},  {-5, 6}, {6, 5},  {-6, 5},
    {8, 0},  {4, 7},  {-4, 7}, {7, 4},  {-7, 4}, {8, 1},  {8, 2},  {6, 6},  {-6, 6}, {8, 3},  {5, 7},  {-5, 7},
    {7, 5},  {-7, 5}, {8, 4},  {6, 7},  {-6, 7}, {7, 6},  {-7, 6}, {8, 5},  {7, 7},  {-7, 7}, {8, 6},  {8, 7}};

enum { PREDICTOR = 0, CROSS_COLOR = 1, SUBTRACT_GREEN = 2, COLOR_INDEXING = 3 };

struct Transform {
  int type, bits, xsize, ysize;
  std::vector<uint32_t> data;
};

struct Group {
  HuffmanCode codes[5];  // green (with lengths and cache), red, blue, alpha, distance
};

inline int SubSampleSize(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

class VP8LDecoder {
 public:
  explicit VP8LDecoder(BitReader& reader) : br(reader) {}

  // The ARGB pixels of an image stream of xsize x ysize: at level 0 (the
  // main image, or the alpha plane's) with its transforms and meta codes.
  std::vector<uint32_t> DecodeImageStream(int xsize, int ysize, bool is_level0, bool alpha_8b_rule = false);

 private:
  BitReader& br;
  std::vector<Transform> transforms;
  unsigned transforms_seen = 0;

  void ReadTransform(int* xsize, int ysize);
  void ReadHuffmanCode(int alphabet_size, HuffmanCode* code);
  void ReadCodeLengths(const int* code_length_code_lengths, int num_symbols, int* lengths);
  std::vector<uint32_t> DecodeImageData(int width, int height, const std::vector<Group>& groups,
                                        const std::vector<uint32_t>& meta, int meta_bits, int cache_bits,
                                        bool alpha_8b_rule);
};

void VP8LDecoder::ReadCodeLengths(const int* code_length_code_lengths, int num_symbols, int* lengths) {
  HuffmanCode lengths_code;
  if (!BuildCode(code_length_code_lengths, 19, &lengths_code)) fail("VP8L: invalid code-length code");
  int max_symbol;
  if (br.read(1)) {
    const int length_nbits = 2 + 2 * static_cast<int>(br.read(3));
    max_symbol = 2 + static_cast<int>(br.read(length_nbits));
    if (max_symbol > num_symbols) fail("VP8L: code lengths past the alphabet");
  } else {
    max_symbol = num_symbols;
  }
  int prev_code_len = 8;
  int symbol = 0;
  while (symbol < num_symbols) {
    if (max_symbol-- == 0) break;
    const int code_len = lengths_code.read(br);
    if (code_len < 16) {
      lengths[symbol++] = code_len;
      if (code_len != 0) prev_code_len = code_len;
    } else {
      static const int kExtraBits[3] = {2, 3, 7};
      static const int kRepeatOffsets[3] = {3, 3, 11};
      const int slot = code_len - 16;
      int repeat = static_cast<int>(br.read(kExtraBits[slot])) + kRepeatOffsets[slot];
      if (symbol + repeat > num_symbols) fail("VP8L: a code-length repeat past the alphabet");
      const int length = code_len == 16 ? prev_code_len : 0;
      while (repeat-- > 0) lengths[symbol++] = length;
    }
  }
}

void VP8LDecoder::ReadHuffmanCode(int alphabet_size, HuffmanCode* code) {
  // A simple code may name a symbol up to 255 past a smaller alphabet; its
  // length lands outside what the code is built from, as in libwebp.
  std::vector<int> lengths(std::max(alphabet_size, 256), 0);
  if (br.read(1)) {  // simple code: one or two symbols
    const int num_symbols = static_cast<int>(br.read(1)) + 1;
    const int first_symbol_len_code = static_cast<int>(br.read(1));
    int symbol = static_cast<int>(br.read(first_symbol_len_code == 0 ? 1 : 8));
    lengths[symbol] = 1;
    if (num_symbols == 2) {
      symbol = static_cast<int>(br.read(8));
      lengths[symbol] = 1;
    }
  } else {
    int code_length_code_lengths[19] = {0};
    const int num_codes = static_cast<int>(br.read(4)) + 4;
    for (int i = 0; i < num_codes; ++i) code_length_code_lengths[kCodeLengthCodeOrder[i]] = static_cast<int>(br.read(3));
    ReadCodeLengths(code_length_code_lengths, alphabet_size, lengths.data());
  }
  if (br.eos) fail("VP8L: truncated prefix code");
  if (!BuildCode(lengths.data(), alphabet_size, code)) fail("VP8L: invalid prefix code");
}

void VP8LDecoder::ReadTransform(int* xsize, int ysize) {
  const int type = static_cast<int>(br.read(2));
  if (transforms_seen & (1u << type)) fail("VP8L: transform " + std::to_string(type) + " used twice");
  transforms_seen |= 1u << type;
  Transform t;
  t.type = type;
  t.xsize = *xsize;
  t.ysize = ysize;
  t.bits = 0;
  switch (type) {
    case PREDICTOR:
    case CROSS_COLOR:
      t.bits = static_cast<int>(br.read(3)) + 2;
      t.data = DecodeImageStream(SubSampleSize(t.xsize, t.bits), SubSampleSize(t.ysize, t.bits), false);
      break;
    case COLOR_INDEXING: {
      const int num_colors = static_cast<int>(br.read(8)) + 1;
      const int bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
      *xsize = SubSampleSize(t.xsize, bits);
      t.bits = bits;
      std::vector<uint32_t> map = DecodeImageStream(num_colors, 1, false);
      // ExpandColorMap: entries are deltas byte by byte; past the colours
      // of the map, transparent black.
      const int final_num_colors = 1 << (8 >> bits);
      t.data.assign(final_num_colors, 0);
      uint32_t prev = 0;
      for (int i = 0; i < num_colors; ++i) {
        uint32_t c = 0;
        for (int k = 0; k < 32; k += 8) c |= ((((map[i] >> k) & 0xff) + ((prev >> k) & 0xff)) & 0xff) << k;
        t.data[i] = prev = c;
      }
      break;
    }
    default:
      break;
  }
  transforms.push_back(std::move(t));
}

std::vector<uint32_t> VP8LDecoder::DecodeImageStream(int xsize, int ysize, bool is_level0, bool alpha_8b_rule) {
  int transform_xsize = xsize;
  if (is_level0)
    while (br.read(1)) ReadTransform(&transform_xsize, ysize);
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = static_cast<int>(br.read(4));
    if (cache_bits < 1 || cache_bits > 11) fail("VP8L: colour cache of " + std::to_string(cache_bits) + " bits");
  }
  // Prefix codes, one group of five for each value of the meta image.
  std::vector<uint32_t> meta;
  int meta_bits = 0, num_groups = 1;
  if (is_level0 && br.read(1)) {
    meta_bits = static_cast<int>(br.read(3)) + 2;
    meta = DecodeImageStream(SubSampleSize(transform_xsize, meta_bits), SubSampleSize(ysize, meta_bits), false);
    for (uint32_t& m : meta) {
      m = (m >> 8) & 0xffff;
      num_groups = std::max(num_groups, static_cast<int>(m) + 1);
    }
  }
  if (br.eos) fail("VP8L: truncated stream");
  // libwebp keeps the groups the meta image uses when they are many (over
  // 1000, or more than the pixels); the others are read and checked only.
  const bool mapped = !meta.empty() && (num_groups > 1000 || num_groups > transform_xsize * ysize);
  std::vector<char> used(num_groups, mapped ? 0 : 1);
  for (uint32_t m : meta) used[m] = 1;
  std::vector<Group> groups(num_groups);
  HuffmanCode scratch;
  for (int g = 0; g < num_groups; ++g)
    for (int j = 0; j < 5; ++j)
      ReadHuffmanCode(kAlphabetSize[j] + (j == 0 && cache_bits > 0 ? 1 << cache_bits : 0),
                      used[g] ? &groups[g].codes[j] : &scratch);
  // libwebp decodes an alpha plane through its 8-bit path when the one
  // transform is colour indexing, there is no cache and no group codes red,
  // blue or alpha with more than one symbol.
  bool alpha_8b = alpha_8b_rule && is_level0 && transforms.size() == 1 && transforms[0].type == COLOR_INDEXING &&
                  cache_bits == 0;
  for (int g = 0; g < num_groups && alpha_8b; ++g)
    if (used[g])
      for (int j = 1; j <= 3; ++j) alpha_8b = alpha_8b && groups[g].codes[j].single >= 0;
  std::vector<uint32_t> data = DecodeImageData(transform_xsize, ysize, groups, meta, meta_bits, cache_bits, alpha_8b);
  if (!is_level0) return data;
  // The inverse transforms, the last read first.
  for (int n = static_cast<int>(transforms.size()) - 1; n >= 0; --n) {
    const Transform& t = transforms[n];
    const int width = t.xsize, height = t.ysize;
    switch (t.type) {
      case SUBTRACT_GREEN:
        for (uint32_t& p : data) {
          const uint32_t green = (p >> 8) & 0xff;
          uint32_t red_blue = p & 0x00ff00ffu;
          red_blue += (green << 16) | green;
          red_blue &= 0x00ff00ffu;
          p = (p & 0xff00ff00u) | red_blue;
        }
        break;
      case PREDICTOR: {
        auto add = [](uint32_t a, uint32_t b) {
          return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
                 (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
        };
        auto avg2 = [](uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); };
        auto clip255 = [](uint32_t a) -> uint32_t { return a < 256 ? a : (~a >> 24); };
        auto select = [](uint32_t a, uint32_t b, uint32_t c) {
          int pa_minus_pb = 0;
          for (int k = 0; k < 32; k += 8) {
            const int ak = (a >> k) & 0xff, bk = (b >> k) & 0xff, ck = (c >> k) & 0xff;
            pa_minus_pb += std::abs(bk - ck) - std::abs(ak - ck);
          }
          return pa_minus_pb <= 0 ? a : b;
        };
        std::vector<uint32_t> out(data.size());
        const int tiles_per_row = SubSampleSize(width, t.bits);
        for (int y = 0; y < height; ++y) {
          const uint32_t* in = &data[static_cast<size_t>(y) * width];
          uint32_t* o = &out[static_cast<size_t>(y) * width];
          const uint32_t* top = o - width;
          for (int x = 0; x < width; ++x) {
            uint32_t pred;
            int mode;
            if (y == 0) {
              mode = x == 0 ? 0 : 1;
            } else if (x == 0) {
              mode = 2;
            } else {
              mode = (t.data[static_cast<size_t>(y >> t.bits) * tiles_per_row + (x >> t.bits)] >> 8) & 0xf;
            }
            const uint32_t L = x > 0 ? o[x - 1] : 0;
            switch (mode) {
              case 1: pred = L; break;
              case 2: pred = top[x]; break;
              case 3: pred = top[x + 1]; break;
              case 4: pred = top[x - 1]; break;
              case 5: pred = avg2(avg2(L, top[x + 1]), top[x]); break;
              case 6: pred = avg2(L, top[x - 1]); break;
              case 7: pred = avg2(L, top[x]); break;
              case 8: pred = avg2(top[x - 1], top[x]); break;
              case 9: pred = avg2(top[x], top[x + 1]); break;
              case 10: pred = avg2(avg2(L, top[x - 1]), avg2(top[x], top[x + 1])); break;
              case 11: pred = select(top[x], L, top[x - 1]); break;
              case 12: {
                pred = 0;
                for (int k = 0; k < 32; k += 8)
                  pred |= clip255(((L >> k) & 0xff) + ((top[x] >> k) & 0xff) - ((top[x - 1] >> k) & 0xff)) << k;
                break;
              }
              case 13: {
                const uint32_t ave = avg2(L, top[x]);
                pred = 0;
                for (int k = 0; k < 32; k += 8) {
                  const int a = (ave >> k) & 0xff, b = (top[x - 1] >> k) & 0xff;
                  pred |= clip255(static_cast<uint32_t>(a + (a - b) / 2)) << k;
                }
                break;
              }
              default: pred = 0xff000000u; break;  // 0, and 14 and 15 as libwebp reads them
            }
            o[x] = add(in[x], pred);
          }
        }
        data.swap(out);
        break;
      }
      case CROSS_COLOR: {
        const int tiles_per_row = SubSampleSize(width, t.bits);
        auto delta = [](int8_t pred, int8_t color) { return (static_cast<int>(pred) * color) >> 5; };
        for (int y = 0; y < height; ++y) {
          for (int x = 0; x < width; ++x) {
            const uint32_t code = t.data[static_cast<size_t>(y >> t.bits) * tiles_per_row + (x >> t.bits)];
            const int8_t g2r = static_cast<int8_t>(code & 0xff), g2b = static_cast<int8_t>((code >> 8) & 0xff),
                         r2b = static_cast<int8_t>((code >> 16) & 0xff);
            uint32_t& p = data[static_cast<size_t>(y) * width + x];
            const int8_t green = static_cast<int8_t>(p >> 8);
            int new_red = (p >> 16) & 0xff;
            int new_blue = p & 0xff;
            new_red += delta(g2r, green);
            new_red &= 0xff;
            new_blue += delta(g2b, green);
            new_blue += delta(r2b, static_cast<int8_t>(new_red));
            new_blue &= 0xff;
            p = (p & 0xff00ff00u) | (static_cast<uint32_t>(new_red) << 16) | static_cast<uint32_t>(new_blue);
          }
        }
        break;
      }
      case COLOR_INDEXING: {
        const int bits_per_pixel = 8 >> t.bits;
        const int count_mask = (1 << t.bits) - 1;
        const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
        const int in_width = SubSampleSize(width, t.bits);
        std::vector<uint32_t> out(static_cast<size_t>(width) * height);
        for (int y = 0; y < height; ++y) {
          const uint32_t* src = &data[static_cast<size_t>(y) * in_width];
          uint32_t packed = 0;
          for (int x = 0; x < width; ++x) {
            if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
            out[static_cast<size_t>(y) * width + x] = t.data[packed & bit_mask];
            packed >>= bits_per_pixel;
          }
        }
        data.swap(out);
        break;
      }
    }
  }
  return data;
}

std::vector<uint32_t> VP8LDecoder::DecodeImageData(int width, int height, const std::vector<Group>& groups,
                                                   const std::vector<uint32_t>& meta, int meta_bits, int cache_bits,
                                                   bool alpha_8b_rule) {
  const size_t total = static_cast<size_t>(width) * height;
  std::vector<uint32_t> data(total);
  std::vector<uint32_t> cache(cache_bits > 0 ? 1u << cache_bits : 0);
  const int meta_xsize = meta_bits ? SubSampleSize(width, meta_bits) : 0;
  size_t pos = 0, cached = 0;
  int col = 0, row = 0;
  auto insert_cached = [&]() {
    for (; cached < pos; ++cached) cache[(0x1e35a7bdu * data[cached]) >> (32 - cache_bits)] = data[cached];
  };
  while (pos < total) {
    const Group& g =
        groups[meta_bits ? meta[static_cast<size_t>(row >> meta_bits) * meta_xsize + (col >> meta_bits)] : 0];
    const int code = g.codes[0].read(br);
    if (br.eos) break;
    if (code < 256) {  // literal
      const int red = g.codes[1].read(br);
      const int blue = g.codes[2].read(br);
      const int alpha = g.codes[3].read(br);
      if (br.eos) break;
      data[pos++] = (static_cast<uint32_t>(alpha) << 24) | (red << 16) | (code << 8) | blue;
      if (++col >= width) {
        col = 0;
        ++row;
      }
    } else if (code < 256 + 24) {  // backward reference
      auto prefix_value = [&](int symbol) {
        if (symbol < 4) return symbol + 1;
        const int extra_bits = (symbol - 2) >> 1;
        const int offset = (2 + (symbol & 1)) << extra_bits;
        return offset + static_cast<int>(br.read(extra_bits)) + 1;
      };
      const int length = prefix_value(code - 256);
      const int dist_symbol = g.codes[4].read(br);
      const int dist_code = prefix_value(dist_symbol);
      int dist;
      if (dist_code > 120) {
        dist = dist_code - 120;
      } else {
        dist = kDistanceMap[dist_code - 1][1] * width + kDistanceMap[dist_code - 1][0];
        if (dist < 1) dist = 1;
      }
      if (br.eos) break;
      if (pos < static_cast<size_t>(dist) || total - pos < static_cast<size_t>(length))
        fail("VP8L: a backward reference outside the image");
      for (int i = 0; i < length; ++i, ++pos) data[pos] = data[pos - dist];
      col += length;
      while (col >= width) {
        col -= width;
        ++row;
      }
    } else {  // colour cache
      if (cache_bits == 0) fail("VP8L: a colour-cache code without a cache");
      insert_cached();
      data[pos++] = cache[code - 280];
      if (++col >= width) {
        col = 0;
        ++row;
      }
    }
    if (cache_bits > 0) insert_cached();
  }
  // An alpha plane that libwebp decodes through its 8-bit path fails at the
  // end of the stream only when pixels are missing; any other image fails.
  if (br.eos && !(alpha_8b_rule && pos >= total)) fail("VP8L: truncated image data");
  return data;
}

void UnfilterAlpha(int filter, uint8_t* plane, int width, int height) {
  auto gradient = [](int a, int b, int c) {
    const int g = a + b - c;
    return ((g & ~0xff) == 0) ? g : (g < 0) ? 0 : 255;
  };
  for (int y = 0; y < height; ++y) {
    uint8_t* out = plane + static_cast<size_t>(y) * width;
    const uint8_t* prev = y > 0 ? out - width : nullptr;
    if (filter == 0) continue;
    if (filter == 1 || prev == nullptr) {  // horizontal; the first row of the others
      uint8_t pred = prev == nullptr ? 0 : prev[0];
      for (int i = 0; i < width; ++i) {
        out[i] = static_cast<uint8_t>(pred + out[i]);
        pred = out[i];
      }
    } else if (filter == 2) {
      for (int i = 0; i < width; ++i) out[i] = static_cast<uint8_t>(prev[i] + out[i]);
    } else {
      uint8_t top = prev[0], top_left = top, left = top;
      for (int i = 0; i < width; ++i) {
        top = prev[i];
        left = static_cast<uint8_t>(out[i] + gradient(left, top, top_left));
        top_left = top;
        out[i] = left;
      }
    }
  }
}

void DecodeAlphaPlane(const uint8_t* data, size_t size, int width, int height, uint8_t* plane) {
  if (size <= 1) fail("ALPH: no data");
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3, pre_processing = (data[0] >> 4) & 3,
            reserved = (data[0] >> 6) & 3;
  if (method > 1 || pre_processing > 1 || reserved != 0)
    fail("ALPH: header byte " + std::to_string(data[0]) + " (compression " + std::to_string(method) +
         ", pre-processing " + std::to_string(pre_processing) + ", reserved bits " + std::to_string(reserved) + ")");
  const size_t n = static_cast<size_t>(width) * height;
  if (method == 0) {
    if (size - 1 < n) fail("ALPH: raw alpha shorter than the image");
    memcpy(plane, data + 1, n);
  } else {
    BitReader br(data + 1, size - 1);
    VP8LDecoder dec(br);
    const std::vector<uint32_t> argb = dec.DecodeImageStream(width, height, true, true);
    for (size_t i = 0; i < n; ++i) plane[i] = static_cast<uint8_t>(argb[i] >> 8);
  }
  UnfilterAlpha(filter, plane, width, height);
}

void Report(const std::exception& e, char* err, int64_t err_len) {
  if (err != nullptr && err_len > 0) snprintf(err, static_cast<size_t>(err_len), "%s", e.what());
}

}  // namespace

extern "C" {

// A VP8 key frame (the payload of a "VP8 " chunk, with what follows it in
// its chunk) of width x height into RGBA rows of `stride` bytes at `out`;
// `alpha` is an ALPH chunk's payload or null. 0 on success, else 1 with
// the reason in err.
int64_t webp_decode_vp8(const uint8_t* data, int64_t size, const uint8_t* alpha, int64_t alpha_size, int64_t width,
                        int64_t height, uint8_t* out, int64_t stride, char* err, int64_t err_len) {
  try {
    VP8Decoder dec(data, static_cast<size_t>(size));
    if (dec.width != width || dec.height != height) fail("VP8: frame size differs from its header's");
    dec.Decode(alpha, static_cast<size_t>(alpha_size), out, stride);
    return 0;
  } catch (const std::exception& e) {
    Report(e, err, err_len);
    return 1;
  }
}

// A VP8L image (the payload of a "VP8L" chunk, header included) into RGBA
// rows of `stride` bytes at `out`. 0 on success, else 1 with the reason.
int64_t webp_decode_vp8l(const uint8_t* data, int64_t size, int64_t width, int64_t height, uint8_t* out,
                         int64_t stride, char* err, int64_t err_len) {
  try {
    BitReader br(data, static_cast<size_t>(size));
    if (br.read(8) != 0x2f) fail("VP8L: bad signature");
    const int w = static_cast<int>(br.read(14)) + 1, h = static_cast<int>(br.read(14)) + 1;
    br.read(1);  // alpha is used
    if (br.read(3) != 0) fail("VP8L: version bits not 0");
    if (br.eos) fail("VP8L: truncated header");
    if (w != width || h != height) fail("VP8L: frame size differs from its header's");
    VP8LDecoder dec(br);
    const std::vector<uint32_t> argb = dec.DecodeImageStream(w, h, true);
    for (int y = 0; y < h; ++y) {
      uint8_t* o = out + y * stride;
      for (int x = 0; x < w; ++x) {
        const uint32_t p = argb[static_cast<size_t>(y) * w + x];
        o[4 * x + 0] = static_cast<uint8_t>(p >> 16);
        o[4 * x + 1] = static_cast<uint8_t>(p >> 8);
        o[4 * x + 2] = static_cast<uint8_t>(p);
        o[4 * x + 3] = static_cast<uint8_t>(p >> 24);
      }
    }
    return 0;
  } catch (const std::exception& e) {
    Report(e, err, err_len);
    return 1;
  }
}

}  // extern "C"

extern "C" {

// The VP8 tables the fixtures' encoder codes with: the default token
// probabilities, their update probabilities and the key-frame 4x4 mode
// probabilities into `probas` (1056 + 1056 + 900 bytes), the DC and AC
// quantizer steps into `steps` (128 + 128).
void webp_vp8_tables(uint8_t* probas, uint16_t* steps) {
  memcpy(probas, kCoeffsProba0, sizeof(kCoeffsProba0));
  memcpy(probas + sizeof(kCoeffsProba0), kCoeffsUpdateProba, sizeof(kCoeffsUpdateProba));
  memcpy(probas + sizeof(kCoeffsProba0) + sizeof(kCoeffsUpdateProba), kBModesProba, sizeof(kBModesProba));
  for (int i = 0; i < 128; ++i) {
    steps[i] = kDcTable[i];
    steps[128 + i] = kAcTable[i];
  }
}

}  // extern "C"
