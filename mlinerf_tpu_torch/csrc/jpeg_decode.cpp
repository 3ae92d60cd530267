// JPEG decoding (ITU-T T.81) on the host: baseline, extended-sequential and
// progressive Huffman-coded DCT images of 8-bit precision, decoded to the
// samples that libjpeg's default decompression gives (its islow integer
// IDCT, its "fancy" triangle upsampling and its fixed-point YCbCr -> RGB
// tables), so that a frame reads the same here as through Pillow.
//
// Covered: SOI, SOF0/SOF1/SOF2, DHT, DQT (8- and 16-bit tables), DRI with
// RST0-7, SOS, APP0 (JFIF), APP14 (Adobe's transform flag), COM and the
// other APPn (skipped), EOI; interleaved and single-component scans; DC
// first/refine and AC first/refine progressive scans with EOB runs and
// correction bits. Refused, each by an error that names it: lossless
// (SOF3), hierarchical (SOF5-7, SOF13-15) and arithmetic-coded (SOF9-11)
// frames, precisions other than 8 bits, component counts other than 1, 3
// and 4, fractional sampling factors, and a progressive image whose scans
// leave low AC coefficients incomplete (libjpeg would smooth its blocks).
// Corrupt entropy data raises where libjpeg warns and carries on.
//
// Output: [H][W][C] bytes with C = 1 (grey), 3 (RGB) or 4 (CMYK, inverted
// as Adobe's CMYK is, the way Pillow unpacks it). EXIF orientation is not
// applied.
//
// Host library with a plain C interface, built with g++ into
// build/libjpeg_decode.so and loaded with ctypes by utils/image_io.py.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// Zigzag position -> natural (row-major) position; the 16 extra entries
// keep a corrupt run inside the block, as libjpeg's table does.
const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,
    6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31,
    39, 46, 53, 60, 61, 54, 47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// The standard tables of T.81 Annex K.3, used for a slot no DHT defined
// (Motion-JPEG frames omit them), as libjpeg-turbo does.
const uint8_t kStdBits[4][17] = {
    {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},           // DC luminance
    {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0},           // DC chrominance
    {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},        // AC luminance
    {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};       // AC chrominance
const uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71,
    0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37,
    0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kStdAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22,
    0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36,
    0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

constexpr int kLookBits = 9;

// A decoding table in libjpeg's derived form (jdhuff.c), with a direct
// lookup of every code up to kLookBits long.
struct Huffman {
  bool defined = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t huffval[256];
  uint8_t look_len[1 << kLookBits];  // 0: the code is longer
  uint8_t look_sym[1 << kLookBits];

  void build(const uint8_t bits[17], const uint8_t* vals, bool is_dc) {
    uint8_t size[257];
    uint32_t code_of[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (p + bits[l] > 256) throw Error("bad Huffman table (more than 256 codes)");
      for (int i = 0; i < bits[l]; ++i) size[p++] = static_cast<uint8_t>(l);
    }
    size[p] = 0;
    const int count = p;
    uint32_t code = 0;
    int si = count ? size[0] : 0;
    p = 0;
    while (size[p]) {
      while (size[p] == si) code_of[p++] = code++;
      if (code >= (1u << si)) throw Error("bad Huffman table (code space overflows)");
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoffset[l] = p - static_cast<int32_t>(code_of[p]);
        p += bits[l];
        maxcode[l] = static_cast<int32_t>(code_of[p - 1]);
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    std::memset(huffval, 0, sizeof(huffval));
    std::memcpy(huffval, vals, count);
    std::memset(look_len, 0, sizeof(look_len));
    p = 0;
    for (int l = 1; l <= kLookBits; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++p) {
        const uint32_t first = code_of[p] << (kLookBits - l);
        for (uint32_t k = 0; k < (1u << (kLookBits - l)); ++k) {
          look_len[first + k] = static_cast<uint8_t>(l);
          look_sym[first + k] = vals[p];
        }
      }
    }
    if (is_dc) {
      for (int i = 0; i < count; ++i)
        if (vals[i] > 15) throw Error("bad Huffman table (DC symbol above 15)");
    }
    defined = true;
  }
};

// The entropy-coded segment's bits, 0xFF00 unstuffed. At a marker it
// appends zero bits, as libjpeg does; taking any of those raises.
struct BitReader {
  const uint8_t* data = nullptr;
  size_t n = 0;
  size_t pos = 0;
  uint64_t buf = 0;
  int bits = 0;
  int fake = 0;  // zero bits appended after a marker, at the buffer's end
  bool at_marker = false;

  void reset(size_t at) {
    pos = at;
    buf = 0;
    bits = 0;
    fake = 0;
    at_marker = false;
  }

  void fill() {
    while (bits <= 56) {
      uint64_t byte = 0;
      if (!at_marker) {
        if (pos >= n) throw Error("truncated (the data ends inside an entropy-coded segment)");
        byte = data[pos];
        if (byte == 0xFF) {
          size_t q = pos + 1;
          while (q < n && data[q] == 0xFF) ++q;
          if (q >= n) throw Error("truncated (the data ends inside an entropy-coded segment)");
          if (data[q] == 0) {
            pos = q + 1;
          } else {
            at_marker = true;  // pos stays on the marker's first 0xFF
            byte = 0;
          }
        } else {
          ++pos;
        }
      }
      if (at_marker) fake += 8;
      buf |= byte << (56 - bits);
      bits += 8;
    }
  }

  void consumed() {
    if (bits < fake) throw Error("corrupt data (an entropy-coded segment ends early)");
  }

  int get(int s) {
    if (s == 0) return 0;
    if (bits < s) fill();
    const int v = static_cast<int>(buf >> (64 - s));
    buf <<= s;
    bits -= s;
    consumed();
    return v;
  }

  int decode(const Huffman& t) {
    if (bits < 16) fill();
    const uint32_t peek = static_cast<uint32_t>(buf >> 48);
    const uint32_t look = peek >> (16 - kLookBits);
    int len = t.look_len[look];
    int sym;
    if (len) {
      sym = t.look_sym[look];
    } else {
      len = kLookBits + 1;
      int32_t code = static_cast<int32_t>(peek >> (16 - len));
      while (len <= 16 && code > t.maxcode[len]) {
        ++len;
        code = static_cast<int32_t>(peek >> (16 - len));
      }
      if (len > 16) throw Error("corrupt data (bad Huffman code)");
      sym = t.huffval[(code + t.valoffset[len]) & 0xFF];
    }
    buf <<= len;
    bits -= len;
    consumed();
    return sym;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v + static_cast<int>((~0u) << s) + 1 : v; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int wib = 0, hib = 0;  // libjpeg's width_in_blocks, height_in_blocks
  int bw = 0, bh = 0;    // blocks stored per row and column (whole MCUs)
  int dsw = 0, dsh = 0;  // downsampled_width, downsampled_height
  int td = 0, ta = 0;    // the current scan's Huffman tables
  int dc_pred = 0;
  bool seen = false;  // in a scan yet: its quantisation table is latched
  int16_t q[64];      // that table as the IDCT's 16-bit multipliers
  int coef_bits[64];
  std::vector<int16_t> coef;
};

// libjpeg's IDCT range limit (jdmaster.c prepare_range_limit_table): a
// descaled value x is output as table[x & 1023], x + 128 clamped to 0-255
// for |x| < 512 and wrapped beyond.
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      if (i < 128) t[i] = static_cast<uint8_t>(i + 128);
      else if (i < 512) t[i] = 255;
      else if (i < 896) t[i] = 0;
      else t[i] = static_cast<uint8_t>(i - 896);
    }
  }
};
const RangeLimit kRange;

// jidctint.c's jpeg_idct_islow: the 8x8 block `in` (natural order)
// dequantised by `q`, into 8 rows of `out`, `stride` apart.
void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  constexpr int kConst = 13, kPass1 = 2;
  constexpr int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270, F0_899 = 7373, F1_175 = 9633,
                    F1_501 = 12299, F1_847 = 15137, F1_961 = 16069, F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const int16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      const int dc = static_cast<int>(static_cast<int64_t>(ip[0]) * qp[0] * (1 << kPass1));
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = static_cast<int64_t>(ip[16]) * qp[16];
    int64_t z3 = static_cast<int64_t>(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    z2 = static_cast<int64_t>(ip[0]) * qp[0];
    z3 = static_cast<int64_t>(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConst);
    int64_t tmp1 = (z2 - z3) * (1 << kConst);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = static_cast<int64_t>(ip[56]) * qp[56];
    tmp1 = static_cast<int64_t>(ip[40]) * qp[40];
    tmp2 = static_cast<int64_t>(ip[24]) * qp[24];
    tmp3 = static_cast<int64_t>(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConst - kPass1;
    constexpr int64_t half = int64_t(1) << (s - 1);
    wp[0] = static_cast<int>((tmp10 + tmp3 + half) >> s);
    wp[56] = static_cast<int>((tmp10 - tmp3 + half) >> s);
    wp[8] = static_cast<int>((tmp11 + tmp2 + half) >> s);
    wp[48] = static_cast<int>((tmp11 - tmp2 + half) >> s);
    wp[16] = static_cast<int>((tmp12 + tmp1 + half) >> s);
    wp[40] = static_cast<int>((tmp12 - tmp1 + half) >> s);
    wp[24] = static_cast<int>((tmp13 + tmp0 + half) >> s);
    wp[32] = static_cast<int>((tmp13 - tmp0 + half) >> s);
  }
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + static_cast<size_t>(r) * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 && wp[7] == 0) {
      const uint8_t v = kRange.t[((static_cast<int64_t>(wp[0]) + (1 << (kPass1 + 2))) >> (kPass1 + 3)) & 1023];
      std::memset(op, v, 8);
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    int64_t tmp0 = (static_cast<int64_t>(wp[0]) + wp[4]) * (1 << kConst);
    int64_t tmp1 = (static_cast<int64_t>(wp[0]) - wp[4]) * (1 << kConst);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConst + kPass1 + 3;
    constexpr int64_t half = int64_t(1) << (s - 1);
    op[0] = kRange.t[((tmp10 + tmp3 + half) >> s) & 1023];
    op[7] = kRange.t[((tmp10 - tmp3 + half) >> s) & 1023];
    op[1] = kRange.t[((tmp11 + tmp2 + half) >> s) & 1023];
    op[6] = kRange.t[((tmp11 - tmp2 + half) >> s) & 1023];
    op[2] = kRange.t[((tmp12 + tmp1 + half) >> s) & 1023];
    op[5] = kRange.t[((tmp12 - tmp1 + half) >> s) & 1023];
    op[3] = kRange.t[((tmp13 + tmp0 + half) >> s) & 1023];
    op[4] = kRange.t[((tmp13 - tmp0 + half) >> s) & 1023];
  }
}

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t n) : data_(data), n_(n) {}

  // Reads the markers up to the frame header: fills H, W and C.
  void header(int64_t* dims) {
    start();
    while (!frame_)
      if (next_segment()) throw Error("no frame header (SOF) before EOI");
    dims[0] = height_;
    dims[1] = width_;
    dims[2] = static_cast<int64_t>(comps_.size());
  }

  void decode(uint8_t* out, int64_t cap) {
    start();
    bool eoi = false;
    while (!eoi) eoi = next_segment();
    if (!frame_) throw Error("no frame header (SOF) before EOI");
    if (scans_ == 0) throw Error("no scan (SOS) before EOI");
    const int64_t need = static_cast<int64_t>(height_) * width_ * static_cast<int64_t>(comps_.size());
    if (cap < need) throw Error("output buffer too small");
    if (progressive_) check_no_smoothing();
    output(out);
  }

 private:
  const uint8_t* data_;
  size_t n_;
  size_t pos_ = 0;
  bool frame_ = false, progressive_ = false;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = 0;
  int width_ = 0, height_ = 0, max_h_ = 1, max_v_ = 1;
  int restart_interval_ = 0;
  int scans_ = 0;
  std::vector<Component> comps_;
  int16_t qtables_[4][64];
  bool qdefined_[4] = {false, false, false, false};
  Huffman dc_[4], ac_[4];
  BitReader br_;

  uint8_t byte() {
    if (pos_ >= n_) throw Error("truncated (the data ends inside a marker segment)");
    return data_[pos_++];
  }
  int u16() {
    const int hi = byte();
    return (hi << 8) | byte();
  }

  void start() {
    pos_ = 0;
    if (n_ < 2 || data_[0] != 0xFF || data_[1] != 0xD8) throw Error("not a JPEG file (no SOI)");
    pos_ = 2;
  }

  // libjpeg's next_marker: skips anything that is not 0xFF, the fill bytes
  // and stuffed zeros; returns the marker code.
  int next_marker() {
    for (;;) {
      uint8_t c = byte();
      while (c != 0xFF) c = byte();
      do c = byte();
      while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  // One marker segment; returns true at EOI.
  bool next_segment() {
    const int m = next_marker();
    switch (m) {
      case 0xC0:
      case 0xC1:
      case 0xC2:
        read_frame(m == 0xC2);
        return false;
      case 0xC3:
        throw Error("lossless JPEG (SOF3) is not supported");
      case 0xC5:
      case 0xC6:
      case 0xC7:
      case 0xCD:
      case 0xCE:
      case 0xCF:
        throw Error("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) + ") is not supported");
      case 0xC9:
      case 0xCA:
      case 0xCB:
        throw Error("arithmetic-coded JPEG (SOF" + std::to_string(m - 0xC0) + ") is not supported");
      case 0xC4:
        read_dht();
        return false;
      case 0xDB:
        read_dqt();
        return false;
      case 0xDD: {
        const int len = u16();
        if (len != 4) throw Error("bad DRI length");
        restart_interval_ = u16();
        return false;
      }
      case 0xDA:
        read_scan();
        return false;
      case 0xD9:
        return true;
      case 0xD8:
        throw Error("a second SOI marker");
      case 0xE0:
      case 0xEE:
        read_app(m);
        return false;
      case 0x01:  // TEM
      case 0xD0:
      case 0xD1:
      case 0xD2:
      case 0xD3:
      case 0xD4:
      case 0xD5:
      case 0xD6:
      case 0xD7:
        return false;  // no parameters; libjpeg ignores a stray RST
      default:
        if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE || m == 0xCC || m == 0xDC || m == 0xDE || m == 0xDF) {
          skip_segment();
          return false;
        }
        char buf[64];
        std::snprintf(buf, sizeof(buf), "unsupported marker 0xFF%02X", m);
        throw Error(buf);
    }
  }

  void skip_segment() {
    const int len = u16();
    if (len < 2 || pos_ + (len - 2) > n_) throw Error("truncated (a marker segment runs past the data)");
    pos_ += len - 2;
  }

  void read_app(int m) {
    const int len = u16();
    if (len < 2 || pos_ + (len - 2) > n_) throw Error("truncated (a marker segment runs past the data)");
    const uint8_t* d = data_ + pos_;
    const int dlen = len - 2;
    if (m == 0xE0 && dlen >= 14 && std::memcmp(d, "JFIF\0", 5) == 0) jfif_ = true;
    if (m == 0xEE && dlen >= 12 && std::memcmp(d, "Adobe", 5) == 0) {
      adobe_ = true;
      adobe_transform_ = d[11];
    }
    pos_ += dlen;
  }

  void read_frame(bool progressive) {
    if (frame_) throw Error("a second frame header (SOF)");
    const int len = u16();
    const int precision = byte();
    height_ = u16();
    width_ = u16();
    const int nc = byte();
    if (precision != 8) throw Error(std::to_string(precision) + "-bit sample precision is not supported");
    if (height_ == 0 || width_ == 0) throw Error("empty image (zero width or height; DNL is not supported)");
    if (nc != 1 && nc != 3 && nc != 4)
      throw Error(std::to_string(nc) + "-component images are not supported (1, 3 or 4 components)");
    if (len != 8 + 3 * nc) throw Error("bad SOF length");
    comps_.resize(nc);
    for (auto& c : comps_) {
      c.id = byte();
      const int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) throw Error("bad sampling factors");
      if (c.tq > 3) throw Error("bad quantisation table number");
      max_h_ = std::max(max_h_, c.h);
      max_v_ = std::max(max_v_, c.v);
    }
    const int mcux = (width_ + 8 * max_h_ - 1) / (8 * max_h_);
    const int mcuy = (height_ + 8 * max_v_ - 1) / (8 * max_v_);
    for (auto& c : comps_) {
      if (max_h_ % c.h || max_v_ % c.v) throw Error("fractional sampling factors are not supported");
      c.dsw = static_cast<int>((static_cast<int64_t>(width_) * c.h + max_h_ - 1) / max_h_);
      c.dsh = static_cast<int>((static_cast<int64_t>(height_) * c.v + max_v_ - 1) / max_v_);
      c.wib = (c.dsw + 7) / 8;
      c.hib = (c.dsh + 7) / 8;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
    }
    progressive_ = progressive;
    frame_ = true;
  }

  void read_dht() {
    int len = u16() - 2;
    while (len > 0) {
      const int tc_th = byte();
      const int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) throw Error("bad Huffman table class or number");
      uint8_t bits[17] = {0};
      int count = 0;
      for (int l = 1; l <= 16; ++l) {
        bits[l] = byte();
        count += bits[l];
      }
      if (count > 256 || 17 + count > len) throw Error("bad DHT length");
      uint8_t vals[256] = {0};
      for (int i = 0; i < count; ++i) vals[i] = byte();
      (tc == 0 ? dc_[th] : ac_[th]).build(bits, vals, tc == 0);
      len -= 17 + count;
    }
    if (len != 0) throw Error("bad DHT length");
  }

  void read_dqt() {
    int len = u16() - 2;
    while (len > 0) {
      const int pq_tq = byte();
      const int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) throw Error("bad quantisation table");
      for (int k = 0; k < 64; ++k) {
        const int v = pq ? u16() : byte();
        // libjpeg's islow multipliers are 16-bit: a value above 32767 wraps.
        qtables_[tq][kNaturalOrder[k]] = static_cast<int16_t>(static_cast<uint16_t>(v));
      }
      qdefined_[tq] = true;
      len -= 1 + (pq ? 128 : 64);
    }
    if (len != 0) throw Error("bad DQT length");
  }

  void default_huffman(int slot, bool is_dc) {
    Huffman& t = is_dc ? dc_[slot] : ac_[slot];
    if (t.defined) return;
    if (slot > 1) throw Error("a scan uses an undefined Huffman table");
    if (is_dc) t.build(kStdBits[slot], kStdDcVals, true);
    else t.build(kStdBits[2 + slot], slot ? kStdAcChromVals : kStdAcLumVals, false);
  }

  void read_scan() {
    if (!frame_) throw Error("a scan (SOS) before the frame header (SOF)");
    const int len = u16();
    const int ns = byte();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) throw Error("bad SOS length");
    std::vector<Component*> sc;
    int blocks_per_mcu = 0;
    for (int i = 0; i < ns; ++i) {
      const int id = byte();
      const int t = byte();
      Component* c = nullptr;
      for (auto& cc : comps_)
        if (cc.id == id) c = &cc;
      if (!c || std::find(sc.begin(), sc.end(), c) != sc.end()) throw Error("bad component in SOS");
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3) throw Error("bad Huffman table number in SOS");
      sc.push_back(c);
      blocks_per_mcu += c->h * c->v;
    }
    const int ss = byte(), se = byte(), a = byte();
    const int ah = a >> 4, al = a & 15;
    if (ns > 1 && blocks_per_mcu > 10) throw Error("more than 10 blocks per MCU");
    for (auto* c : sc) {
      if (!c->seen) {
        if (!qdefined_[c->tq]) throw Error("a component's quantisation table is undefined");
        std::memcpy(c->q, qtables_[c->tq], sizeof(c->q));
        c->seen = true;
        c->coef.assign(static_cast<size_t>(c->bw) * c->bh * 64, 0);
      }
    }
    int mode;  // 0 sequential, 1 DC first, 2 DC refine, 3 AC first, 4 AC refine
    if (!progressive_) {
      mode = 0;
      for (auto* c : sc) {
        default_huffman(c->td, true);
        default_huffman(c->ta, false);
      }
    } else {
      const bool dc = ss == 0;
      bool bad = dc ? se != 0 : (ss > se || se > 63 || ns != 1);
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) throw Error("bad progressive scan parameters");
      for (auto* c : sc) {
        for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
        if (dc && ah == 0) default_huffman(c->td, true);
        if (!dc) default_huffman(c->ta, false);
      }
      mode = dc ? (ah == 0 ? 1 : 2) : (ah == 0 ? 3 : 4);
    }
    br_.data = data_;
    br_.n = n_;
    br_.reset(pos_);
    decode_scan(sc, mode, ss, se, al);
    pos_ = br_.pos;  // on the next marker (or what follows the scan's last byte)
    ++scans_;
  }

  void restart(int& expected) {
    // Drop the bits left, then read the RSTn marker (skipping anything
    // before it, as libjpeg's next_marker does).
    size_t p = br_.pos;
    for (;;) {
      if (p >= n_) throw Error("truncated (a restart marker is missing)");
      if (data_[p] != 0xFF) {
        ++p;
        continue;
      }
      size_t q = p + 1;
      while (q < n_ && data_[q] == 0xFF) ++q;
      if (q >= n_) throw Error("truncated (a restart marker is missing)");
      if (data_[q] == 0) {
        p = q + 1;
        continue;
      }
      if (data_[q] != 0xD0 + expected) throw Error("corrupt data (a restart marker is missing or out of order)");
      br_.reset(q + 1);
      break;
    }
    expected = (expected + 1) & 7;
  }

  void decode_scan(const std::vector<Component*>& sc, int mode, int ss, int se, int al) {
    for (auto* c : sc) c->dc_pred = 0;
    int eobrun = 0;
    int mcux, mcuy;
    if (sc.size() == 1) {
      mcux = sc[0]->wib;
      mcuy = sc[0]->hib;
    } else {
      mcux = (width_ + 8 * max_h_ - 1) / (8 * max_h_);
      mcuy = (height_ + 8 * max_v_ - 1) / (8 * max_v_);
    }
    int to_go = restart_interval_, expected = 0;
    const int ri = restart_interval_;
    for (int my = 0; my < mcuy; ++my) {
      for (int mx = 0; mx < mcux; ++mx) {
        if (ri) {
          if (to_go == 0) {
            restart(expected);
            for (auto* c : sc) c->dc_pred = 0;
            eobrun = 0;
            to_go = ri;
          }
          --to_go;
        }
        if (sc.size() == 1) {
          Component* c = sc[0];
          decode_block(*c, block(*c, mx, my), mode, ss, se, al, eobrun);
        } else {
          for (auto* c : sc)
            for (int v = 0; v < c->v; ++v)
              for (int h = 0; h < c->h; ++h)
                decode_block(*c, block(*c, mx * c->h + h, my * c->v + v), mode, ss, se, al, eobrun);
        }
      }
    }
  }

  static int16_t* block(Component& c, int bx, int by) {
    return c.coef.data() + (static_cast<size_t>(by) * c.bw + bx) * 64;
  }

  void decode_block(Component& c, int16_t* blk, int mode, int ss, int se, int al, int& eobrun) {
    switch (mode) {
      case 0: {
        int s = br_.decode(dc_[c.td]);
        if (s) s = extend(br_.get(s), s);
        c.dc_pred += s;
        blk[0] = static_cast<int16_t>(c.dc_pred);
        const Huffman& t = ac_[c.ta];
        for (int k = 1; k < 64; ++k) {
          int rs = br_.decode(t);
          const int r = rs >> 4;
          s = rs & 15;
          if (s) {
            k += r;
            blk[kNaturalOrder[k]] = static_cast<int16_t>(extend(br_.get(s), s));
          } else {
            if (r != 15) break;
            k += 15;
          }
        }
        return;
      }
      case 1: {
        int s = br_.decode(dc_[c.td]);
        if (s) s = extend(br_.get(s), s);
        c.dc_pred += s;
        blk[0] = static_cast<int16_t>(static_cast<uint32_t>(c.dc_pred) << al);
        return;
      }
      case 2:
        if (br_.get(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
        return;
      case 3: {
        if (eobrun > 0) {
          --eobrun;
          return;
        }
        const Huffman& t = ac_[c.ta];
        for (int k = ss; k <= se; ++k) {
          const int rs = br_.decode(t);
          int r = rs >> 4;
          const int s = rs & 15;
          if (s) {
            k += r;
            const int v = extend(br_.get(s), s);
            blk[kNaturalOrder[k]] = static_cast<int16_t>(static_cast<uint32_t>(v) << al);
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun = 1 << r;
            if (r) eobrun += br_.get(r);
            --eobrun;
            break;
          }
        }
        return;
      }
      default:
        ac_refine(c, blk, ss, se, al, eobrun);
    }
  }

  // jdphuff.c's decode_mcu_AC_refine for one block.
  void ac_refine(Component& c, int16_t* blk, int ss, int se, int al, int& eobrun) {
    const int p1 = 1 << al;
    const int m1 = -1 * (1 << al);
    int k = ss;
    if (eobrun == 0) {
      const Huffman& t = ac_[c.ta];
      for (; k <= se; ++k) {
        const int rs = br_.decode(t);
        int r = rs >> 4;
        int s = rs & 15;
        if (s) {
          s = br_.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br_.get(r);
          break;
        }
        do {
          int16_t* coef = blk + kNaturalOrder[k];
          if (*coef != 0) {
            if (br_.get(1) && (*coef & p1) == 0) *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNaturalOrder[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = blk + kNaturalOrder[k];
        if (*coef != 0 && br_.get(1) && (*coef & p1) == 0)
          *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
      }
      --eobrun;
    }
  }

  // libjpeg smooths the blocks of a progressive image (jdcoefct.c
  // decompress_smooth_data) when its scans left any of the first nine AC
  // coefficients incomplete and the DC known; that path is not here.
  void check_no_smoothing() {
    static const int kPos[9] = {1, 8, 16, 9, 2, 3, 10, 17, 24};  // Q01 Q10 Q20 Q11 Q02 Q03 Q12 Q21 Q30
    bool useful = false;
    for (const auto& c : comps_) {
      if (!c.seen) return;
      if (c.q[0] == 0) return;
      for (int p : kPos)
        if (c.q[p] == 0) return;
      if (c.coef_bits[0] < 0) return;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    if (useful)
      throw Error("a progressive JPEG whose scans leave low AC coefficients incomplete (libjpeg's block "
                  "smoothing) is not supported");
  }

  // Component samples, IDCT'd block by block: wib*8 x hib*8.
  std::vector<uint8_t> samples(const Component& c) const {
    const int stride = c.wib * 8;
    std::vector<uint8_t> plane(static_cast<size_t>(stride) * c.hib * 8, 0);
    if (!c.seen) {  // in no scan: libjpeg's zero multipliers give 128
      std::fill(plane.begin(), plane.end(), 128);
      return plane;
    }
    for (int by = 0; by < c.hib; ++by)
      for (int bx = 0; bx < c.wib; ++bx)
        idct_islow(c.coef.data() + (static_cast<size_t>(by) * c.bw + bx) * 64, c.q,
                   plane.data() + static_cast<size_t>(by) * 8 * stride + bx * 8, stride);
    return plane;
  }

  // jdsample.c: the component at full size (width_ x height_), by the
  // method libjpeg picks for its sampling factors.
  void upsample(const Component& c, const std::vector<uint8_t>& plane, uint8_t* out) const {
    const int stride = c.wib * 8;
    const int W = width_, H = height_;
    auto in = [&](int y, int x) -> int { return plane[static_cast<size_t>(y) * stride + x]; };
    if (c.h == max_h_ && c.v == max_v_) {
      for (int y = 0; y < H; ++y) std::memcpy(out + static_cast<size_t>(y) * W, &plane[static_cast<size_t>(y) * stride], W);
    } else if (2 * c.h == max_h_ && c.v == max_v_ && c.dsw > 2) {  // h2v1_fancy_upsample
      for (int y = 0; y < H; ++y) {
        uint8_t* o = out + static_cast<size_t>(y) * W;
        for (int x = 0; x < W; ++x) {
          const int i = x >> 1;
          const int nb = (x & 1) ? std::min(i + 1, c.dsw - 1) : std::max(i - 1, 0);
          o[x] = static_cast<uint8_t>((3 * in(y, i) + in(y, nb) + ((x & 1) ? 2 : 1)) >> 2);
        }
      }
    } else if (c.h == max_h_ && 2 * c.v == max_v_) {  // h1v2_fancy_upsample
      for (int y = 0; y < H; ++y) {
        const int i = y >> 1;
        const int nb = (y & 1) ? std::min(i + 1, c.dsh - 1) : std::max(i - 1, 0);
        const int bias = (y & 1) ? 2 : 1;
        uint8_t* o = out + static_cast<size_t>(y) * W;
        for (int x = 0; x < W; ++x) o[x] = static_cast<uint8_t>((3 * in(i, x) + in(nb, x) + bias) >> 2);
      }
    } else if (2 * c.h == max_h_ && 2 * c.v == max_v_ && c.dsw > 2) {  // h2v2_fancy_upsample
      std::vector<int> sum(c.dsw);
      for (int y = 0; y < H; ++y) {
        const int i = y >> 1;
        const int nb = (y & 1) ? std::min(i + 1, c.dsh - 1) : std::max(i - 1, 0);
        for (int j = 0; j < c.dsw; ++j) sum[j] = 3 * in(i, j) + in(nb, j);
        uint8_t* o = out + static_cast<size_t>(y) * W;
        for (int x = 0; x < W; ++x) {
          const int j = x >> 1;
          if (x & 1) o[x] = static_cast<uint8_t>((3 * sum[j] + sum[std::min(j + 1, c.dsw - 1)] + 7) >> 4);
          else o[x] = static_cast<uint8_t>((3 * sum[j] + sum[std::max(j - 1, 0)] + 8) >> 4);
        }
      }
    } else {  // int_upsample (and h2v1/h2v2_upsample): replication
      const int he = max_h_ / c.h, ve = max_v_ / c.v;
      for (int y = 0; y < H; ++y) {
        uint8_t* o = out + static_cast<size_t>(y) * W;
        for (int x = 0; x < W; ++x) o[x] = static_cast<uint8_t>(in(y / ve, x / he));
      }
    }
  }

  void output(uint8_t* out) const {
    const size_t npix = static_cast<size_t>(width_) * height_;
    const int nc = static_cast<int>(comps_.size());
    std::vector<std::vector<uint8_t>> full(nc);
    for (int ci = 0; ci < nc; ++ci) {
      full[ci].resize(npix);
      upsample(comps_[ci], samples(comps_[ci]), full[ci].data());
    }
    if (nc == 1) {
      std::memcpy(out, full[0].data(), npix);
      return;
    }
    // jdapimin.c default_decompress_parms: the colour space of the file.
    bool ycc;
    if (nc == 3) {
      if (jfif_) ycc = true;
      else if (adobe_) ycc = adobe_transform_ != 0;
      else ycc = !(comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66);  // 'R' 'G' 'B'
    } else {
      ycc = adobe_ && adobe_transform_ != 0;  // YCCK; else plain CMYK
    }
    // jdcolor.c build_ycc_rgb_table: 16-bit fixed point.
    constexpr int kScale = 16;
    constexpr int64_t kHalf = int64_t(1) << (kScale - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * (1 << kScale) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
    const uint8_t* c0 = full[0].data();
    const uint8_t* c1 = full[1].data();
    const uint8_t* c2 = full[2].data();
    if (nc == 3) {
      for (size_t p = 0; p < npix; ++p) {
        uint8_t* o = out + 3 * p;
        if (!ycc) {
          o[0] = c0[p];
          o[1] = c1[p];
          o[2] = c2[p];
          continue;
        }
        const int y = c0[p], cb = c1[p], cr = c2[p];
        o[0] = clamp255(y + cr_r[cr]);
        o[1] = clamp255(y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> kScale));
        o[2] = clamp255(y + cb_b[cb]);
      }
      return;
    }
    // Four components: CMYK, or YCCK -> CMYK (jdcolor.c ycck_cmyk_convert);
    // then inverted, as Pillow unpacks Adobe's CMYK ("CMYK;I").
    const uint8_t* c3 = full[3].data();
    for (size_t p = 0; p < npix; ++p) {
      uint8_t* o = out + 4 * p;
      if (ycc) {
        const int y = c0[p], cb = c1[p], cr = c2[p];
        o[0] = static_cast<uint8_t>(255 - clamp255(255 - (y + cr_r[cr])));
        o[1] = static_cast<uint8_t>(255 - clamp255(255 - (y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> kScale))));
        o[2] = static_cast<uint8_t>(255 - clamp255(255 - (y + cb_b[cb])));
      } else {
        o[0] = static_cast<uint8_t>(255 - c0[p]);
        o[1] = static_cast<uint8_t>(255 - c1[p]);
        o[2] = static_cast<uint8_t>(255 - c2[p]);
      }
      o[3] = static_cast<uint8_t>(255 - c3[p]);
    }
  }
};

void set_error(char* err, int64_t cap, const char* msg) {
  if (err && cap > 0) {
    std::strncpy(err, msg, static_cast<size_t>(cap - 1));
    err[cap - 1] = '\0';
  }
}

}  // namespace

extern "C" {

// With out == nullptr: reads the markers up to the frame header and writes
// (H, W, C) into dims. Otherwise decodes the whole file into out (H*W*C
// bytes, row-major, C interleaved). Returns 0, or -1 with a message in err.
int64_t jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t out_cap, int64_t* dims, char* err,
                    int64_t err_cap) {
  try {
    Decoder d(data, static_cast<size_t>(n));
    if (out == nullptr) d.header(dims);
    else d.decode(out, out_cap);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, err_cap, e.what());
    return -1;
  }
}

}  // extern "C"
