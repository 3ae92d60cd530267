// JPEG decoding (ITU-T T.81) on the host, to the samples that libjpeg-turbo
// 3.1's default decompression gives (its islow integer IDCT as its SIMD
// code computes it, its "fancy" triangle upsampling, its fixed-point YCbCr
// -> RGB tables and its block smoothing of incomplete progressive images),
// so that a frame reads the same here as through Pillow.
//
// Covered: SOI, SOF0/SOF1/SOF2 (Huffman-coded DCT), SOF9/SOF10
// (arithmetic-coded DCT, sequential and progressive, jdarith.c), SOF3
// (Huffman-coded lossless, jdlhuff.c/jdlossls.c/jddiffct.c: the seven
// predictors, point transforms, no colour transform, replicated
// upsampling), DHT, DAC, DQT (8- and 16-bit tables), DRI with RST0-7, SOS,
// APP0 (JFIF), APP14 (Adobe's transform flag), COM and the other APPn
// (skipped), EOI; interleaved and single-component scans; DC first/refine
// and AC first/refine progressive scans with EOB runs and correction bits;
// jdcoefct.c's block smoothing where a progressive image's scans leave any
// of the first nine AC coefficients incomplete. Refused, each by an error
// that names it, as libjpeg-turbo (through Pillow) refuses them:
// hierarchical (SOF5-7, SOF13-15) and arithmetic-coded lossless (SOF11)
// frames, precisions other than 8 bits, component counts other than 1, 3
// and 4, fractional sampling factors, lossless YCbCr or YCCK (libjpeg does
// no lossy colour conversion in lossless mode), a lossless restart interval
// that is not a whole number of MCU rows, a lossless component in no scan,
// an arithmetic-coded scan that reads past the read blocks Pillow had
// handed libjpeg before it started (kPastReadBlock), DHP, EXP, JPGn and
// RESn markers, a file that ends inside a scan with no marker after it.
// Damaged entropy-coded data reads as libjpeg-turbo reads it: a Huffman
// segment that meets a marker reads zero bits and leaves the rest of the
// segment's MCUs untouched (JWRN_HIT_MARKER), a bad code is symbol 0
// (JWRN_HUFF_BAD_CODE), a restart marker out of place is resynchronised
// (jpeg_resync_to_restart), an arithmetic-coded magnitude or run that
// overflows ends decoding until the next restart (JWRN_ARITH_BAD_CODE),
// and a progressive image past the last iMCU row its last scan began whole
// is smoothed with the coefficient bits from before that scan. A file read
// as one sequential scan has every row once that scan is done: what
// follows it is read as Pillow's jpeg_finish_decompress reads it, no
// further than the data goes.
//
// Output: [H][W][C] bytes with C = 1 (grey), 3 (RGB) or 4 (CMYK, inverted
// as Adobe's CMYK is, the way Pillow unpacks it). EXIF orientation is not
// applied. A second entry (jpeg_tiff_decode) decodes a strip or tile of a
// JPEG-compressed TIFF as libtiff's tif_jpeg.c hands it to libjpeg: its
// JPEGTables in front, the colour space the TIFF names rather than the one
// libjpeg would guess, and past its end the fake EOI markers tif_jpeg.c
// hands libjpeg. A third (jpeg_raw_decode) gives each component's
// samples as libjpeg's raw_data_out does (no upsampling, no colour
// conversion), which libtiff's tif_ojpeg.c asks for in an old-style JPEG
// TIFF, through tif_ojpeg.c's source, which fails a skip or a resync.
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

constexpr int kLookBits = 8;  // libjpeg's HUFF_LOOKAHEAD

// Where the data comes from once it ends: Pillow has nothing more to give
// libjpeg, which suspends, and Pillow refuses the file (kEndRefuses); libtiff's
// tif_jpeg.c hands libjpeg a fake EOI marker each time it asks for more
// (kEndIsEoi).
constexpr int kEndRefuses = 0, kEndIsEoi = 1;

// What reading past the end raises where the data ends for good.
struct Truncated : std::runtime_error {
  Truncated() : std::runtime_error("truncated (the data ends inside an entropy-coded segment)") {}
};

// The byte at `pos` (advancing it), or past the end what the source gives.
inline int source_byte(const uint8_t* data, size_t n, int end, size_t& pos) {
  if (pos < n) return data[pos++];
  if (end == kEndRefuses) throw Truncated();
  return (pos++ - n) % 2 ? 0xD9 : 0xFF;
}

// A decoding table in libjpeg's derived form (jdhuff.c), with a direct
// lookup of every code up to kLookBits long. DHT stores the counts and
// symbols; the table is derived, and checked, when a scan first uses it
// (jpeg_make_d_derived_tbl), so a bad table no scan uses is no error.
struct Huffman {
  bool defined = false, built = false;
  uint8_t bits[17];
  uint8_t vals[256];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t look_len[1 << kLookBits];  // 0: the code is longer
  uint8_t look_sym[1 << kLookBits];
  int max_sym = 0;  // a DC table's symbols stop at 15 (16 in a lossless frame), checked per scan

  void define(const uint8_t b[17], const uint8_t* v) {
    std::memcpy(bits, b, 17);
    std::memset(vals, 0, sizeof(vals));
    int count = 0;
    for (int l = 1; l <= 16; ++l) count += b[l];
    std::memcpy(vals, v, std::min(count, 256));
    defined = true;
    built = false;
  }

  void build() {
    if (built) return;
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
    max_sym = 0;
    for (int i = 0; i < count; ++i) max_sym = std::max(max_sym, static_cast<int>(vals[i]));
    built = true;
  }
};

// The entropy-coded segment's bits as jdhuff.c reads them
// (jpeg_fill_bit_buffer, HUFF_DECODE, jpeg_huff_decode): 0xFF00 unstuffed,
// a fill only when a request needs more bits than are buffered, up to 57
// bits. At a marker the reader stops (unread_marker, pos past the marker's
// code); a request for more bits than are left then gets zeros and marks
// the segment short (JWRN_HIT_MARKER: `insufficient`, after which libjpeg
// leaves the rest of the segment's MCUs untouched). A bad code gives
// symbol 0 (JWRN_HUFF_BAD_CODE). libjpeg-turbo's fast path
// (decode_mcu_fast) gives the same values and hands an MCU that meets a
// marker back to this one.
struct BitReader {
  const uint8_t* data = nullptr;
  size_t n = 0;
  int end = kEndRefuses;
  size_t pos = 0;
  uint64_t buf = 0;  // `bits` valid bits at the top, zeros below
  int bits = 0;
  int unread_marker = 0;
  bool insufficient = false;
  int64_t hit_marker = 0, bad_code = 0;  // libjpeg's JWRN_HIT_MARKER and JWRN_HUFF_BAD_CODE, counted

  void reset(size_t at, int marker) {
    pos = at;
    buf = 0;
    bits = 0;
    unread_marker = marker;
  }

  void fill(int nbits) {
    if (!unread_marker) {
      while (bits < 57) {
        int c = source_byte(data, n, end, pos);
        if (c == 0xFF) {
          do c = source_byte(data, n, end, pos);
          while (c == 0xFF);
          if (c == 0) {
            c = 0xFF;
          } else {
            unread_marker = c;
            break;
          }
        }
        buf |= static_cast<uint64_t>(c) << (56 - bits);
        bits += 8;
      }
      if (!unread_marker) return;
    }
    if (nbits > bits) {  // zeros from here on
      if (!insufficient) ++hit_marker;
      insufficient = true;
      bits = 57;
    }
  }

  int get(int s) {
    if (s == 0) return 0;
    if (bits < s) fill(s);
    const int v = static_cast<int>(buf >> (64 - s));
    buf <<= s;
    bits -= s;
    return v;
  }

  int decode(const Huffman& t) {
    int l = 1;
    if (bits < kLookBits) fill(0);
    if (bits >= kLookBits) {
      const uint32_t look = static_cast<uint32_t>(buf >> (64 - kLookBits));
      if (t.look_len[look]) {
        buf <<= t.look_len[look];
        bits -= t.look_len[look];
        return t.look_sym[look];
      }
      l = kLookBits + 1;
      if (bits < 17) fill(0);
      if (bits >= 17) {  // the bits jpeg_huff_decode reads one at a time, all buffered: read at once
        const uint32_t peek = static_cast<uint32_t>(buf >> (64 - 17));
        int32_t code = static_cast<int32_t>(peek >> (17 - l));
        while (code > t.maxcode[l]) code = static_cast<int32_t>(peek >> (17 - ++l));
        buf <<= l;
        bits -= l;
        if (l > 16) {  // JWRN_HUFF_BAD_CODE
          ++bad_code;
          return 0;
        }
        return t.vals[(code + t.valoffset[l]) & 0xFF];
      }
    }
    int32_t code = get(l);
    while (code > t.maxcode[l]) {
      code = (code << 1) | get(1);
      ++l;
    }
    if (l > 16) {  // JWRN_HUFF_BAD_CODE
      ++bad_code;
      return 0;
    }
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v + static_cast<int>((~0u) << s) + 1 : v; }

// T.81 Table D.2, the QM coder's probability estimation: Qe, the next
// state after an LPS, after an MPS, and whether an LPS switches the MPS;
// the last entry is T.851's fixed estimate of 0.5. Packed as jaricom.c
// packs it: Qe << 16 | next MPS << 8 | switch << 7 | next LPS.
struct ArithTable {
  int64_t t[114];
  ArithTable() {
    static const uint16_t kQe[114] = {
        0x5a1d, 0x2586, 0x1114, 0x080b, 0x03d8, 0x01da, 0x00e5, 0x006f, 0x0036, 0x001a, 0x000d, 0x0006, 0x0003,
        0x0001, 0x5a7f, 0x3f25, 0x2cf2, 0x207c, 0x17b9, 0x1182, 0x0cef, 0x09a1, 0x072f, 0x055c, 0x0406, 0x0303,
        0x0240, 0x01b1, 0x0144, 0x00f5, 0x00b7, 0x008a, 0x0068, 0x004e, 0x003b, 0x002c, 0x5ae1, 0x484c, 0x3a0d,
        0x2ef1, 0x261f, 0x1f33, 0x19a8, 0x1518, 0x1177, 0x0e74, 0x0bfb, 0x09f8, 0x0861, 0x0706, 0x05cd, 0x04de,
        0x040f, 0x0363, 0x02d4, 0x025c, 0x01f8, 0x01a4, 0x0160, 0x0125, 0x00f6, 0x00cb, 0x00ab, 0x008f, 0x5b12,
        0x4d04, 0x412c, 0x37d8, 0x2fe8, 0x293c, 0x2379, 0x1edf, 0x1aa9, 0x174e, 0x1424, 0x119c, 0x0f6b, 0x0d51,
        0x0bb6, 0x0a40, 0x5832, 0x4d1c, 0x438e, 0x3bdd, 0x34ee, 0x2eae, 0x299a, 0x2516, 0x5570, 0x4ca9, 0x44d9,
        0x3e22, 0x3824, 0x32b4, 0x2e17, 0x56a8, 0x4f46, 0x47e5, 0x41cf, 0x3c3d, 0x375e, 0x5231, 0x4c0f, 0x4639,
        0x415e, 0x5627, 0x50e7, 0x4b85, 0x5597, 0x504f, 0x5a10, 0x5522, 0x59eb, 0x5a1d};
    static const uint8_t kLps[114] = {
        1,  14, 16, 18, 20, 23, 25, 28, 30, 33, 35, 9,  10, 12, 15, 36, 38, 39, 40, 42, 43, 45, 46,
        48, 49, 51, 52, 54, 56, 57, 59, 60, 62, 63, 32, 33, 37, 64, 65, 67, 68, 69, 70, 72, 73, 74,
        75, 77, 78, 79, 48, 50, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 61, 61, 65, 80, 81, 82, 83,
        84, 86, 87, 87, 72, 72, 74, 74, 75, 77, 77, 80, 88, 89, 90, 91, 92, 93, 86, 88, 95, 96, 97,
        99, 99, 93, 95, 101, 102, 103, 104, 99, 105, 106, 107, 103, 105, 108, 109, 110, 111, 110, 112, 112, 113};
    static const uint8_t kMps[114] = {
        1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 13, 15, 16, 17, 18, 19, 20, 21, 22, 23,
        24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 9,  37, 38, 39, 40, 41, 42, 43, 44, 45, 46,
        47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 32, 65, 66, 67, 68, 69,
        70, 71, 72, 73, 74, 75, 76, 77, 78, 79, 48, 81, 82, 83, 84, 85, 86, 87, 71, 89, 90, 91, 92,
        93, 94, 86, 96, 97, 98, 99, 100, 93, 102, 103, 104, 99, 106, 107, 103, 109, 107, 111, 109, 111, 113};
    for (int i = 0; i < 114; ++i) {
      const int sw = (i == 0 || i == 14 || i == 36 || i == 64 || i == 80 || i == 88 || i == 95 || i == 105 ||
                      i == 110 || i == 112);
      t[i] = (static_cast<int64_t>(kQe[i]) << 16) | (kMps[i] << 8) | (sw << 7) | kLps[i];
    }
  }
};
const ArithTable kArith;
constexpr uint8_t kFixedBin = 113;

// What Pillow refuses of an arithmetic-coded file: Pillow hands libjpeg
// the file a read block at a time, taking the next block only when libjpeg
// suspends, and libjpeg's arithmetic decoder cannot suspend
// (JERR_CANT_SUSPEND), so a scan whose decoding reads a byte past the last
// block read before it started raises.
const char kPastReadBlock[] =
    "an arithmetic-coded scan reads past Pillow's %lld-byte read block (libjpeg's arithmetic decoder cannot wait "
    "for the next block: JERR_CANT_SUSPEND, so Pillow refuses the file)";

// An arithmetic-coded segment's decoder (T.81 D.2; jdarith.c's get_byte
// and arith_decode): once it meets a marker (unread_marker, pos past the
// marker's code) it reads zeros, as T.81 defines, and leaves the marker to
// the restart or segment reader. A read at or past `limit` raises
// (kPastReadBlock); so does a read past the data's end where Pillow feeds
// libjpeg (libjpeg's arithmetic decoder cannot suspend).
struct ArithDecoder {
  const uint8_t* data = nullptr;
  size_t n = 0;
  int end = kEndRefuses;
  size_t pos = 0;
  size_t limit = SIZE_MAX, block = 0;
  int64_t c = 0, a = 0;
  int ct = 0;  // -16 at the start: the first two bytes fill C; -1 after JWRN_ARITH_BAD_CODE
  int unread_marker = 0;

  void reset(size_t at, int marker) {
    pos = at;
    c = 0;
    a = 0;
    ct = -16;
    unread_marker = marker;
  }

  // Raises if the byte at `at` lies past the read block.
  void need(size_t at) const {
    if (at < limit) return;
    char buf[256];
    std::snprintf(buf, sizeof(buf), kPastReadBlock, static_cast<long long>(block));
    throw Error(buf);
  }

  int byte() {
    if (unread_marker) return 0;
    need(pos);
    int d = source_byte(data, n, end, pos);
    if (d != 0xFF) return d;
    do {
      need(pos);
      d = source_byte(data, n, end, pos);
    } while (d == 0xFF);
    if (d == 0) return 0xFF;
    unread_marker = d;
    return 0;
  }

  // One decision with the estimate *st, which it updates.
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // the two initial bytes are in
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kArith.t[sv & 0x7F];
    const int nl = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    const int nm = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional exchange: the MPS
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {  // conditional exchange: the LPS
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

// The end of the decoding that libjpeg does before Pillow has every row:
// thrown once a file read as one sequential scan has had that scan and
// Pillow's jpeg_finish_decompress stops (suspends at the data's end, or
// meets the next scan, which libjpeg only sets up).
struct Finished {};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int wib = 0, hib = 0;  // libjpeg's width_in_blocks, height_in_blocks (samples, in a lossless frame)
  int bw = 0, bh = 0;    // blocks stored per row and column (whole MCUs)
  int dsw = 0, dsh = 0;  // downsampled_width, downsampled_height
  int td = 0, ta = 0;    // the current scan's Huffman or conditioning tables
  int dc_pred = 0;
  int dc_ctx = 0;     // the arithmetic DC's conditioning context
  bool seen = false;  // in a scan yet: its quantisation table is latched
  int16_t q[64];      // that table as the IDCT's 16-bit multipliers
  int coef_bits[64];
  int prev_coef_bits[10] = {-1, -1, -1, -1, -1, -1, -1, -1, -1, -1};  // coef_bits[0..9] before its last scan
  std::vector<int16_t> coef;
  std::vector<uint8_t> plane;  // a lossless frame's samples, dsw x dsh
};

// libjpeg-turbo's islow IDCT as its SIMD code computes it (jidctint-sse2
// and -avx2, which Pillow's builds run; equal to jidctint.c's
// jpeg_idct_islow wherever no value overflows): the dequantisation, the
// even part's first sum and difference and the odd part's z3 and z4 in 16
// bits (wrapping), the products and the other sums in 32 bits, each pass's
// output saturated to 16 bits, the samples to 0-255. A block whose AC
// coefficients are all zero takes the first pass's shortcut: its
// dequantised DC times 4, in 16 bits.
namespace islow {

constexpr int kConst = 13, kPass1 = 2;
constexpr int32_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270, F0_899 = 7373, F1_175 = 9633,
                  F1_501 = 12299, F1_847 = 15137, F1_961 = 16069, F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;

inline int16_t wrap16(int32_t v) { return static_cast<int16_t>(static_cast<uint16_t>(v)); }
inline int16_t sat16(int32_t v) { return static_cast<int16_t>(v > 32767 ? 32767 : (v < -32768 ? -32768 : v)); }
inline int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
inline int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
// pmaddwd: two 16-bit products summed in 32 bits.
inline int32_t madd(int16_t a, int32_t ca, int16_t b, int32_t cb) { return add32(a * ca, b * cb); }
inline int32_t shifted(int16_t v) { return static_cast<int32_t>(static_cast<uint32_t>(v) << kConst); }

// One 8-point pass over x[0..7], each output descaled by `shift` with
// rounding and saturated to 16 bits.
inline void pass(const int16_t* x, int shift, int16_t* o) {
  const int32_t tmp3 = madd(x[2], F0_541 + F0_765, x[6], F0_541);
  const int32_t tmp2 = madd(x[2], F0_541, x[6], F0_541 - F1_847);
  const int32_t tmp0 = shifted(wrap16(x[0] + x[4])), tmp1 = shifted(wrap16(x[0] - x[4]));
  const int32_t tmp10 = add32(tmp0, tmp3), tmp13 = sub32(tmp0, tmp3);
  const int32_t tmp11 = add32(tmp1, tmp2), tmp12 = sub32(tmp1, tmp2);
  const int16_t t0 = x[7], t1 = x[5], t2 = x[3], t3 = x[1];
  const int16_t z3 = wrap16(t0 + t2), z4 = wrap16(t1 + t3);
  const int32_t Z3 = madd(z3, F1_175 - F1_961, z4, F1_175);
  const int32_t Z4 = madd(z3, F1_175, z4, F1_175 - F0_390);
  const int32_t o0 = add32(madd(t0, F0_298 - F0_899, t3, -F0_899), Z3);
  const int32_t o3 = add32(madd(t0, -F0_899, t3, F1_501 - F0_899), Z4);
  const int32_t o1 = add32(madd(t1, F2_053 - F2_562, t2, -F2_562), Z4);
  const int32_t o2 = add32(madd(t1, -F2_562, t2, F3_072 - F2_562), Z3);
  const int32_t half = 1 << (shift - 1);
  auto descale = [&](int32_t v) { return sat16(add32(v, half) >> shift); };
  o[0] = descale(add32(tmp10, o3));
  o[7] = descale(sub32(tmp10, o3));
  o[1] = descale(add32(tmp11, o2));
  o[6] = descale(sub32(tmp11, o2));
  o[2] = descale(add32(tmp12, o1));
  o[5] = descale(sub32(tmp12, o1));
  o[3] = descale(add32(tmp13, o0));
  o[4] = descale(sub32(tmp13, o0));
}

}  // namespace islow

// The 8x8 block `in` (natural order) dequantised by `q`, into 8 rows of
// `out`, `stride` apart.
void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  using namespace islow;
  int16_t ws[64];  // the first pass's output, column by column
  bool ac_zero = true;
  for (int i = 8; i < 64 && ac_zero; ++i) ac_zero = in[i] == 0;
  for (int c = 0; c < 8; ++c) {
    if (ac_zero) {
      const int16_t dc = wrap16(wrap16(in[c] * q[c]) * (1 << kPass1));
      for (int r = 0; r < 8; ++r) ws[8 * c + r] = dc;
      continue;
    }
    int16_t x[8];
    bool zero = true;  // then the pass gives the DC times 4, saturated
    for (int r = 0; r < 8; ++r) {
      x[r] = wrap16(in[8 * r + c] * q[8 * r + c]);
      if (r) zero = zero && x[r] == 0;
    }
    if (zero) {
      const int16_t dc = sat16(x[0] * (1 << kPass1));
      for (int r = 0; r < 8; ++r) ws[8 * c + r] = dc;
    } else {
      pass(x, kConst - kPass1, ws + 8 * c);
    }
  }
  for (int r = 0; r < 8; ++r) {
    int16_t x[8], y[8];
    bool zero = true;  // then the pass gives (DC + 16) >> 5
    for (int c = 0; c < 8; ++c) {
      x[c] = ws[8 * c + r];
      if (c) zero = zero && x[c] == 0;
    }
    uint8_t* op = out + static_cast<size_t>(r) * stride;
    if (zero) {
      std::memset(op, std::min(std::max((x[0] + 16) >> 5, -128), 127) + 128, 8);
      continue;
    }
    pass(x, kConst + kPass1 + 3, y);
    for (int c = 0; c < 8; ++c) op[c] = static_cast<uint8_t>(std::min(std::max(static_cast<int>(y[c]), -128), 127) + 128);
  }
}

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

constexpr int kColourAuto = 0, kColourNone = 1, kColourYcc = 2;

class Decoder {
 public:
  // `read_block`: the bytes Pillow reads at a time (see kPastReadBlock).
  Decoder(const uint8_t* data, size_t n, size_t read_block, int end = kEndRefuses)
      : data_(data), n_(n), read_block_(read_block), end_(end) {
    std::fill(dc_L_, dc_L_ + 16, 0);
    std::fill(dc_U_, dc_U_ + 16, 1);
    std::fill(ac_K_, ac_K_ + 16, 5);
  }

  // Reads the markers up to the frame header: fills H, W and C, then each
  // component's sampling factors (h, v) after them.
  void header(int64_t* dims) {
    start();
    while (!frame_)
      if (next_segment()) throw Error("no frame header (SOF) before EOI");
    dims[0] = height_;
    dims[1] = width_;
    dims[2] = static_cast<int64_t>(comps_.size());
    for (size_t ci = 0; ci < comps_.size(); ++ci) {
      dims[3 + 2 * ci] = comps_[ci].h;
      dims[4 + 2 * ci] = comps_[ci].v;
    }
  }

  // libtiff's codecs read a sequential file's rows and stop: nothing after
  // its one scan is read.
  void stop_after_scan() { stop_after_scan_ = true; }

  // The output colour space as a caller that knows it sets it (libtiff's
  // JPEG codec): kColourAuto (libjpeg's guess from the markers, as
  // Pillow's JPEG reader leaves it), kColourNone (JCS_UNKNOWN: the
  // components as coded) or kColourYcc (three components, YCbCr -> RGB).
  void set_colour(int mode) { colour_ = mode; }

  // libjpeg's raw_data_out: each component's IDCT samples, neither
  // upsampled nor converted, wib*8 x hib*8 each, one after another. With
  // out == nullptr only the frame is read; dims gets H, W, C, then each
  // component's h, v, plane width and plane height.
  void decode_raw(uint8_t* out, int64_t cap, int64_t* dims) {
    start();
    bool eoi = false;
    while (!frame_ && !eoi) eoi = next_segment();
    if (!frame_) throw Error("no frame header (SOF) before EOI");
    if (lossless_) throw Error("raw samples of a lossless frame");
    stop_after_scan_ = true;  // libtiff reads the rows and no more
    strict_source_ = true;    // tif_ojpeg.c's source manager fails a skip or a resync
    dims[0] = height_;
    dims[1] = width_;
    dims[2] = static_cast<int64_t>(comps_.size());
    int64_t need = 0;
    for (size_t ci = 0; ci < comps_.size(); ++ci) {
      const Component& c = comps_[ci];
      dims[3 + 4 * ci] = c.h;
      dims[4 + 4 * ci] = c.v;
      dims[5 + 4 * ci] = c.wib * 8;
      dims[6 + 4 * ci] = c.hib * 8;
      need += static_cast<int64_t>(c.wib) * 8 * c.hib * 8;
    }
    dims[3 + 4 * comps_.size()] = -1;
    if (out == nullptr) return;
    if (!eoi) read_all();
    if (scans_ == 0 && failed_mcu_row_ < 0) throw Error("no scan (SOS) before EOI");
    if (cap < need) throw Error("output buffer too small");
    // The iMCU row whose restart marker tif_ojpeg.c's source could not find
    // (-1: none); the caller keeps the rows above it.
    dims[3 + 4 * comps_.size()] = failed_mcu_row_;
    const bool smooth = smoothing_ok();
    for (const auto& c : comps_) {
      int stride = 0;
      const std::vector<uint8_t> plane = samples(c, smooth, &stride);
      std::memcpy(out, plane.data(), plane.size());
      out += plane.size();
    }
  }

  // libjpeg's warnings so far: JWRN_HIT_MARKER (once a segment),
  // JWRN_HUFF_BAD_CODE, JWRN_MUST_RESYNC and JWRN_ARITH_BAD_CODE.
  void warnings(int64_t* out) const {
    out[0] = br_.hit_marker;
    out[1] = br_.bad_code;
    out[2] = resyncs_;
    out[3] = arith_bad_codes_;
  }

  void decode(uint8_t* out, int64_t cap) {
    start();
    read_all();
    if (!frame_) throw Error("no frame header (SOF) before EOI");
    if (scans_ == 0) throw Error("no scan (SOS) before EOI");
    const int64_t need = static_cast<int64_t>(height_) * width_ * static_cast<int64_t>(comps_.size());
    if (cap < need) throw Error("output buffer too small");
    output(out);
  }

 private:
  const uint8_t* data_;
  size_t n_;
  size_t read_block_;
  int end_;
  int colour_ = 0;
  size_t pos_ = 0;
  int unread_marker_ = 0;  // a marker the entropy decoder met, its code read
  // A file whose first scan is sequential and holds every component is read
  // as it is decoded (libjpeg's single-scan mode): once that scan is done,
  // Pillow has every row and jpeg_finish_decompress reads on only until it
  // suspends (finishing_); libtiff stops there (stop_after_scan_).
  bool single_scan_ = false, finishing_ = false, stop_after_scan_ = false;
  bool strict_source_ = false;  // tif_ojpeg.c's source: skip_input_data and resync_to_restart fail
  int last_good_imcu_ = 0;  // jdcoefct.c's last_good_iMCU_row
  int64_t resyncs_ = 0, arith_bad_codes_ = 0;  // JWRN_MUST_RESYNC, JWRN_ARITH_BAD_CODE
  bool frame_ = false, progressive_ = false, arith_ = false, lossless_ = false;
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
  // Arithmetic coding: the DAC conditioning (defaults L 0, U 1, Kx 5), the
  // statistics areas of each table and the fixed 0.5 estimate.
  uint8_t dc_L_[16], dc_U_[16], ac_K_[16];
  uint8_t dc_stats_[16][64], ac_stats_[16][256];
  uint8_t fixed_bin_ = kFixedBin;
  ArithDecoder ad_;

  uint8_t byte() {
    if (pos_ >= n_ && finishing_) throw Finished();
    if (pos_ >= n_ && end_ == kEndRefuses) throw Error("truncated (the data ends inside a marker segment)");
    return static_cast<uint8_t>(source_byte(data_, n_, end_, pos_));
  }

  void read_all() {
    try {
      while (!next_segment()) {
      }
    } catch (const Finished&) {
    }
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

  // The marker the entropy decoder left unread, else libjpeg's
  // next_marker: skips anything that is not 0xFF, the fill bytes and
  // stuffed zeros (JWRN_EXTRANEOUS_DATA); returns the marker code.
  int next_marker() {
    if (unread_marker_) {
      const int m = unread_marker_;
      unread_marker_ = 0;
      return m;
    }
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
      case 0xC3:
      case 0xC9:
      case 0xCA:
        read_frame(m);
        return false;
      case 0xC5:
      case 0xC6:
      case 0xC7:
      case 0xCD:
      case 0xCE:
      case 0xCF:
        throw Error("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) + ") is not supported");
      case 0xCB:
        throw Error("arithmetic-coded lossless JPEG (SOF11) is not supported (libjpeg-turbo refuses it too)");
      case 0xC4:
        read_dht();
        return false;
      case 0xCC:
        read_dac();
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
        if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE || m == 0xDC) {
          skip_segment();
          return false;
        }
        char buf[96];  // DHP, EXP, JPGn and RESn: libjpeg's JERR_UNKNOWN_MARKER
        std::snprintf(buf, sizeof(buf), "unsupported marker 0xFF%02X", m);
        throw Error(buf);
    }
  }

  void skip_segment() {
    if (strict_source_)
      throw Error("a marker segment to skip (libtiff's old-style JPEG source cannot skip data: \"Unexpected error\")");
    const int len = u16();
    if (len < 2 || pos_ + (len - 2) > n_) overrun();
    pos_ += len - 2;
  }

  // A segment that runs past the data: once a single-scan file's rows are
  // out, Pillow's jpeg_finish_decompress just suspends there.
  [[noreturn]] void overrun() {
    if (finishing_) throw Finished();
    throw Error("truncated (a marker segment runs past the data)");
  }

  void read_app(int m) {
    const int len = u16();
    if (len < 2 || pos_ + (len - 2) > n_) overrun();
    const uint8_t* d = data_ + pos_;
    const int dlen = len - 2;
    if (m == 0xE0 && dlen >= 14 && std::memcmp(d, "JFIF\0", 5) == 0) jfif_ = true;
    if (m == 0xEE && dlen >= 12 && std::memcmp(d, "Adobe", 5) == 0) {
      adobe_ = true;
      adobe_transform_ = d[11];
    }
    pos_ += dlen;
  }

  void read_frame(int marker) {
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
      max_h_ = std::max(max_h_, c.h);
      max_v_ = std::max(max_v_, c.v);
    }
    progressive_ = marker == 0xC2 || marker == 0xCA;
    arith_ = marker == 0xC9 || marker == 0xCA;
    lossless_ = marker == 0xC3;
    const int unit = lossless_ ? 1 : 8;  // a lossless data unit is one sample
    const int mcux = (width_ + unit * max_h_ - 1) / (unit * max_h_);
    const int mcuy = (height_ + unit * max_v_ - 1) / (unit * max_v_);
    for (auto& c : comps_) {
      if (max_h_ % c.h || max_v_ % c.v) throw Error("fractional sampling factors are not supported");
      c.dsw = static_cast<int>((static_cast<int64_t>(width_) * c.h + max_h_ - 1) / max_h_);
      c.dsh = static_cast<int>((static_cast<int64_t>(height_) * c.v + max_v_ - 1) / max_v_);
      c.wib = (c.dsw + unit - 1) / unit;
      c.hib = (c.dsh + unit - 1) / unit;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
    }
    frame_ = true;
  }

  // jdmarker.c get_dht: the tables are checked when a scan uses them.
  void read_dht() {
    int len = u16() - 2;
    while (len > 16) {
      const int index = byte();
      uint8_t bits[17] = {0};
      int count = 0;
      for (int l = 1; l <= 16; ++l) {
        bits[l] = byte();
        count += bits[l];
      }
      len -= 17;
      if (count > 256 || count > len) throw Error("bad Huffman table (bad DHT counts)");
      uint8_t vals[256] = {0};
      for (int i = 0; i < count; ++i) vals[i] = byte();
      len -= count;
      const int th = index & 0x10 ? index - 0x10 : index;
      if (th > 3) throw Error("bad Huffman table class or number");
      (index & 0x10 ? ac_[th] : dc_[th]).define(bits, vals);
    }
    if (len != 0) throw Error("bad DHT length");
  }

  // jdmarker.c get_dac: each entry sets a DC table's L and U or an AC
  // table's Kx.
  void read_dac() {
    int len = u16() - 2;
    while (len > 0) {
      const int index = byte(), val = byte();
      len -= 2;
      if (index >= 32) throw Error("bad DAC table index");
      if (index >= 16) {
        ac_K_[index - 16] = static_cast<uint8_t>(val);
      } else {
        dc_L_[index] = static_cast<uint8_t>(val & 15);
        dc_U_[index] = static_cast<uint8_t>(val >> 4);
        if (dc_L_[index] > dc_U_[index]) throw Error("bad DAC value (a DC table's L above its U)");
      }
    }
    if (len != 0) throw Error("bad DAC length");
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
    // The table number is checked where a scan uses it, and only the
    // sequential Huffman decoder (jinit_huff_decoder's std_huff_tables)
    // falls back to T.81's standard tables.
    if (slot > 3) throw Error("bad Huffman table number in SOS");
    Huffman& t = is_dc ? dc_[slot] : ac_[slot];
    if (!t.defined) {
      if (slot > 1 || progressive_ || lossless_) throw Error("a scan uses an undefined Huffman table");
      if (is_dc) t.define(kStdBits[slot], kStdDcVals);
      else t.define(kStdBits[2 + slot], slot ? kStdAcChromVals : kStdAcLumVals);
    }
    t.build();
    if (is_dc && t.max_sym > (lossless_ ? 16 : 15))
      throw Error(std::string("bad Huffman table (DC symbol above ") + (lossless_ ? "16)" : "15)"));
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
      sc.push_back(c);
      blocks_per_mcu += c->h * c->v;
    }
    const int ss = byte(), se = byte(), a = byte();
    const int ah = a >> 4, al = a & 15;
    if (ns > 1 && blocks_per_mcu > 10) throw Error("more than 10 blocks per MCU");
    if (scans_ == 0) single_scan_ = !progressive_ && ns == static_cast<int>(comps_.size());
    br_.data = data_;
    br_.n = n_;
    br_.end = end_;
    br_.reset(pos_, 0);
    br_.insufficient = false;
    if (lossless_) {
      // jdlossls.c: Ss is the predictor, Al the point transform.
      if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al > 7) throw Error("bad lossless scan parameters");
      for (auto* c : sc) default_huffman(c->td, true);
      if (finishing_) throw Finished();  // libjpeg sets the scan up and suspends
      for (auto* c : sc) {
        if (!c->seen) c->plane.assign(static_cast<size_t>(c->dsw) * c->dsh, 0);
        c->seen = true;
      }
      decode_lossless(sc, ss, al);
      end_scan(br_.pos, br_.unread_marker);
      return;
    }
    for (auto* c : sc) {
      if (!c->seen) {
        if (c->tq > 3 || !qdefined_[c->tq]) throw Error("a component's quantisation table is undefined");
        std::memcpy(c->q, qtables_[c->tq], sizeof(c->q));
        c->seen = true;
        c->coef.assign(static_cast<size_t>(c->bw) * c->bh * 64, 0);
      }
    }
    int mode;  // 0 sequential, 1 DC first, 2 DC refine, 3 AC first, 4 AC refine
    if (!progressive_) {
      mode = 0;
      if (!arith_)
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
        for (int k = std::min(ss, 1); k <= std::max(se, 9) && k < 10; ++k)
          c->prev_coef_bits[k] = scans_ > 0 ? c->coef_bits[k] : 0;
        for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
        if (arith_) continue;
        if (dc && ah == 0) default_huffman(c->td, true);
        if (!dc) default_huffman(c->ta, false);
      }
      mode = dc ? (ah == 0 ? 1 : 2) : (ah == 0 ? 3 : 4);
    }
    if (finishing_) throw Finished();  // libjpeg sets the scan up and suspends
    if (arith_) {
      ad_.data = data_;
      ad_.n = n_;
      ad_.end = end_;
      ad_.reset(pos_, 0);
      // Pillow has read the blocks up to the scan's first byte, and no more.
      ad_.block = read_block_;
      ad_.limit = read_block_ ? (pos_ + read_block_ - 1) / read_block_ * read_block_ : SIZE_MAX;
    }
    decode_scan(sc, mode, ss, se, al);
    if (arith_) end_scan(ad_.pos, ad_.unread_marker);
    else end_scan(br_.pos, br_.unread_marker);
  }

  // After a scan: the segment reader goes on from where the entropy decoder
  // stopped, with the marker it met. A single-scan file has every row now.
  void end_scan(size_t pos, int marker) {
    pos_ = pos;
    unread_marker_ = marker;
    ++scans_;
    if (single_scan_ && scans_ == 1) {
      if (stop_after_scan_) throw Finished();
      finishing_ = true;
    }
  }

  // libjpeg's next_marker from `pos` (past the marker's code after it).
  int marker_at(size_t& pos) {
    for (;;) {
      int c = source_byte(data_, n_, end_, pos);
      while (c != 0xFF) c = source_byte(data_, n_, end_, pos);
      do c = source_byte(data_, n_, end_, pos);
      while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  // jdmarker.c read_restart_marker and jpeg_resync_to_restart: the RSTn
  // expected next, or else the recovery libjpeg picks by the marker met: a
  // marker before SOF0 or a restart two or one behind, scan on to the next
  // marker; a marker that is not a restart, or a restart one or two ahead,
  // stays unread (the segment then reads as empty); any other restart is
  // taken as the expected one. Returns the marker left unread (0 if none).
  int read_restart_marker(size_t& pos, int marker, int& expected) {
    if (!marker) marker = marker_at(pos);
    if (marker != 0xD0 + expected) {
      if (strict_source_)
        throw Error("a restart marker out of place (libtiff's old-style JPEG source cannot resynchronise: "
                    "\"Unexpected error\")");
      ++resyncs_;
      for (;;) {
        int action;
        if (marker < 0xC0) action = 2;
        else if (marker < 0xD0 || marker > 0xD7) action = 3;
        else if (marker == 0xD0 + ((expected + 1) & 7) || marker == 0xD0 + ((expected + 2) & 7)) action = 3;
        else if (marker == 0xD0 + ((expected - 1) & 7) || marker == 0xD0 + ((expected - 2) & 7)) action = 2;
        else action = 1;
        if (action == 1) break;
        if (action == 3) {
          expected = (expected + 1) & 7;
          return marker;
        }
        marker = marker_at(pos);
      }
    }
    expected = (expected + 1) & 7;
    return 0;
  }

  // jdarith.c start_pass and process_restart: the statistics of the
  // scan's tables and its DC predictions start from zero (the DC ones
  // unless this is a DC refinement or an AC scan, the AC ones unless this
  // is a DC scan).
  void arith_reset(const std::vector<Component*>& sc, int mode) {
    for (auto* c : sc) {
      if (mode == 0 || mode == 1) {
        std::memset(dc_stats_[c->td], 0, sizeof(dc_stats_[0]));
        c->dc_pred = 0;
        c->dc_ctx = 0;
      }
      if (mode == 0 || mode >= 3) std::memset(ac_stats_[c->ta], 0, sizeof(ac_stats_[0]));
    }
  }

  int64_t failed_mcu_row_ = -1;

  void decode_scan(const std::vector<Component*>& sc, int mode, int ss, int se, int al) {
    for (auto* c : sc) c->dc_pred = 0;
    if (arith_) arith_reset(sc, mode);
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
        if (ri && to_go == 0) {  // process_restart
          if (arith_) {
            size_t pos = ad_.pos;
            const int marker = read_restart_marker(pos, ad_.unread_marker, expected);
            ad_.reset(pos, marker);
            arith_reset(sc, mode);
          } else {
            size_t pos = br_.pos;
            int marker;
            try {
              marker = read_restart_marker(pos, br_.unread_marker, expected);
            } catch (const Error&) {
              // tif_ojpeg.c's source fails the resync: libjpeg gives the
              // rows before this iMCU row and no more (OJPEGDecodeRaw).
              if (!strict_source_ || sc.size() == 1) throw;
              failed_mcu_row_ = my;
              throw Finished();
            }
            br_.reset(pos, marker);
            if (!marker) br_.insufficient = false;
          }
          for (auto* c : sc) c->dc_pred = 0;
          eobrun = 0;
          to_go = ri;
        }
        if (ri) --to_go;
        // jdcoefct.c: the last iMCU row begun with the segment's data whole.
        if (arith_ || !br_.insufficient) last_good_imcu_ = sc.size() == 1 ? my / sc[0]->v : my;
        // A Huffman segment that ran short leaves its MCUs untouched (a DC
        // refinement would read zeros, which change nothing); an arithmetic
        // one after JWRN_ARITH_BAD_CODE too.
        if (arith_ ? ad_.ct == -1 : br_.insufficient) continue;
        if (sc.size() == 1) {
          Component* c = sc[0];
          decode_block(*c, block(*c, mx, my), mode, ss, se, al, eobrun);
        } else {
          for (auto* c : sc)
            for (int v = 0; v < c->v; ++v)
              for (int h = 0; h < c->h; ++h) {
                decode_block(*c, block(*c, mx * c->h + h, my * c->v + v), mode, ss, se, al, eobrun);
                if (arith_ && ad_.ct == -1) goto mcu_done;
              }
        }
      mcu_done:;
      }
    }
  }

  static int16_t* block(Component& c, int bx, int by) {
    return c.coef.data() + (static_cast<size_t>(by) * c.bw + bx) * 64;
  }

  void decode_block(Component& c, int16_t* blk, int mode, int ss, int se, int al, int& eobrun) {
    if (arith_) {
      arith_block(c, blk, mode, ss, se, al);
      return;
    }
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

  // JWRN_ARITH_BAD_CODE: libjpeg decodes nothing more until the next
  // restart (ct = -1).
  void arith_bad_code() {
    ad_.ct = -1;
    ++arith_bad_codes_;
  }

  // jdarith.c: a DC difference (F.1.4.4.1) into *diff, updating the
  // component's conditioning context from the previous difference against L
  // and U; false where its magnitude overflows (JWRN_ARITH_BAD_CODE).
  bool arith_dc_diff(Component& c, int* diff) {
    const int tbl = c.td;
    uint8_t* st = dc_stats_[tbl] + c.dc_ctx;
    *diff = 0;
    if (ad_.decode(st) == 0) {
      c.dc_ctx = 0;
      return true;
    }
    const int sign = ad_.decode(st + 1);
    st += 2 + sign;
    int m = ad_.decode(st);
    if (m != 0) {
      st = dc_stats_[tbl] + 20;  // X1
      while (ad_.decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        ++st;
      }
    }
    if (m < static_cast<int>((1L << dc_L_[tbl]) >> 1)) c.dc_ctx = 0;
    else if (m > static_cast<int>((1L << dc_U_[tbl]) >> 1)) c.dc_ctx = 12 + sign * 4;
    else c.dc_ctx = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ad_.decode(st)) v |= m;
    v += 1;
    *diff = sign ? -v : v;
    return true;
  }

  // jdarith.c: a nonzero AC value at zigzag position k, `st` on its
  // statistics bin S0 (F.1.4.4.2); false where its magnitude overflows.
  bool arith_ac_value(int tbl, uint8_t* st, int k, int* value) {
    const int sign = ad_.decode(&fixed_bin_);
    st += 2;
    int m = ad_.decode(st);
    if (m != 0 && ad_.decode(st)) {
      m <<= 1;
      st = ac_stats_[tbl] + (k <= ac_K_[tbl] ? 189 : 217);
      while (ad_.decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        ++st;
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ad_.decode(st)) v |= m;
    v += 1;
    *value = sign ? -v : v;
    return true;
  }

  // jdarith.c's decode_mcu (mode 0), decode_mcu_DC_first, _DC_refine,
  // _AC_first and _AC_refine for one block. A magnitude or run that
  // overflows (JWRN_ARITH_BAD_CODE) ends the block where it stands and
  // sets ct = -1.
  void arith_block(Component& c, int16_t* blk, int mode, int ss, int se, int al) {
    if (mode == 0) al = 0;  // a sequential scan's Ss, Se and Al are not read
    if (mode == 0 || mode == 1) {
      int diff;
      if (!arith_dc_diff(c, &diff)) return arith_bad_code();
      c.dc_pred = static_cast<int>(static_cast<uint32_t>(c.dc_pred) + static_cast<uint32_t>(diff));
      blk[0] = static_cast<int16_t>(static_cast<uint32_t>(c.dc_pred) << al);
      if (mode == 1) return;
      ss = 1;
      se = 63;
    } else if (mode == 2) {
      if (ad_.decode(&fixed_bin_)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
      return;
    }
    const int tbl = c.ta;
    if (mode != 4) {
      for (int k = ss; k <= se; ++k) {
        uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
        if (ad_.decode(st)) break;  // end of block
        while (ad_.decode(st + 1) == 0) {
          st += 3;
          if (++k > se) return arith_bad_code();
        }
        int v;
        if (!arith_ac_value(tbl, st, k, &v)) return arith_bad_code();
        blk[kNaturalOrder[k]] = static_cast<int16_t>(static_cast<uint32_t>(v) << al);
      }
      return;
    }
    const int p1 = 1 << al;
    const int m1 = -1 * (1 << al);
    int kex = se;  // the previous stage's end of block
    for (; kex > 0; --kex)
      if (blk[kNaturalOrder[kex]]) break;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
      if (k > kex && ad_.decode(st)) break;  // end of block
      for (;;) {
        int16_t* coef = blk + kNaturalOrder[k];
        if (*coef) {  // previously nonzero: a correction bit
          if (ad_.decode(st + 2)) *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1 : p1));
          break;
        }
        if (ad_.decode(st + 1)) {  // newly nonzero
          *coef = static_cast<int16_t>(ad_.decode(&fixed_bin_) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) return arith_bad_code();
      }
    }
  }

  // A lossless scan (jddiffct.c decompress_data with jdlhuff.c and
  // jdlossls.c): each iMCU row's differences are decoded MCU row by MCU
  // row, restarts between MCU rows, then undifferenced row by row over the
  // component's own width. A restart sets every component's next
  // undifferenced row to the first-row rule, and libjpeg undifferences
  // only after the whole iMCU row: a restart inside a non-interleaved
  // iMCU row of several rows applies the rule to that iMCU row's first
  // row. Output: the value shifted left by the point transform, cut to 8
  // bits.
  void decode_lossless(const std::vector<Component*>& sc, int psv, int pt) {
    const bool inter = sc.size() > 1;
    const int mcus_per_row = inter ? (width_ + max_h_ - 1) / max_h_ : sc[0]->dsw;
    const int ri = restart_interval_;
    if (ri % mcus_per_row) {
      throw Error("a lossless restart interval of " + std::to_string(ri) + " MCUs is not a whole number of MCU rows (" +
                  std::to_string(mcus_per_row) + " MCUs)");
    }
    const int total_imcu = (height_ + max_v_ - 1) / max_v_;
    const int initial = 1 << (8 - pt - 1);
    const size_t ncs = sc.size();
    std::vector<std::vector<int>> diff(ncs), prev(ncs), cur(ncs);
    std::vector<int> cols(ncs);
    std::vector<bool> first(ncs, true);
    for (size_t i = 0; i < ncs; ++i) {
      const Component* c = sc[i];
      cols[i] = inter ? mcus_per_row * c->h : c->dsw;
      diff[i].assign(static_cast<size_t>(c->v) * cols[i], 0);
      prev[i].assign(c->dsw, 0);
      cur[i].assign(c->dsw, 0);
    }
    int rows_to_go = ri / mcus_per_row, expected = 0;
    for (int imcu = 0; imcu < total_imcu; ++imcu) {
      const bool last = imcu == total_imcu - 1;
      auto last_rows = [&](const Component* c) { return c->dsh % c->v ? c->dsh % c->v : c->v; };
      const int mcu_rows = inter ? 1 : (last ? last_rows(sc[0]) : sc[0]->v);
      for (int yoff = 0; yoff < mcu_rows; ++yoff) {
        if (ri) {
          if (rows_to_go == 0) {
            size_t pos = br_.pos;
            const int marker = read_restart_marker(pos, br_.unread_marker, expected);
            br_.reset(pos, marker);
            if (!marker) br_.insufficient = false;
            std::fill(first.begin(), first.end(), true);
            rows_to_go = ri / mcus_per_row;
          }
        }
        if (br_.insufficient) {
          // jdlhuff.c: a segment that ran short gives zero differences
          // and restarts the undifferencer (the first-row rule).
          for (size_t i = 0; i < ncs; ++i) {
            const Component* c = sc[i];
            const int rows = inter ? c->v : 1;
            for (int y = 0; y < rows; ++y)
              std::fill_n(diff[i].begin() + static_cast<size_t>(inter ? y : yoff) * cols[i], cols[i], 0);
          }
          std::fill(first.begin(), first.end(), true);
          if (ri) --rows_to_go;
          continue;
        }
        for (int mx = 0; mx < mcus_per_row; ++mx) {
          if (inter) {
            for (size_t i = 0; i < ncs; ++i) {
              const Component* c = sc[i];
              for (int y = 0; y < c->v; ++y)
                for (int x = 0; x < c->h; ++x)
                  diff[i][static_cast<size_t>(y) * cols[i] + mx * c->h + x] = lossless_diff(*c);
            }
          } else {
            diff[0][static_cast<size_t>(yoff) * cols[0] + mx] = lossless_diff(*sc[0]);
          }
        }
        if (ri) --rows_to_go;
      }
      for (size_t i = 0; i < ncs; ++i) {
        Component* c = sc[i];
        const int rows = std::min(last ? last_rows(c) : c->v, c->dsh - imcu * c->v);
        for (int row = 0; row < rows; ++row) {
          undifference(diff[i].data() + static_cast<size_t>(row) * cols[i], prev[i].data(), cur[i].data(), c->dsw, psv,
                       first[i], initial);
          first[i] = false;
          uint8_t* o = c->plane.data() + static_cast<size_t>(imcu * c->v + row) * c->dsw;
          for (int x = 0; x < c->dsw; ++x) o[x] = static_cast<uint8_t>(cur[i][x] << pt);
          std::swap(prev[i], cur[i]);
        }
      }
    }
  }

  // jdlhuff.c: one difference; category 16 stands for 32768 with no bits.
  int lossless_diff(const Component& c) {
    const int s = br_.decode(dc_[c.td]);
    if (s == 16) return 32768;
    return s ? extend(br_.get(s), s) : 0;
  }

  // jdlossls.c: the first row of a scan or restart interval from the
  // initial prediction 2^(P-Pt-1) and then the left neighbour; any other
  // row's first sample from the one above, the rest by predictor psv.
  // Values are kept modulo 2^16.
  static void undifference(const int* diff, const int* prev, int* out, int width, int psv, bool first, int initial) {
    if (first) {
      int ra = (diff[0] + initial) & 0xFFFF;
      out[0] = ra;
      for (int x = 1; x < width; ++x) out[x] = ra = (diff[x] + ra) & 0xFFFF;
      return;
    }
    int rb = prev[0];
    int ra = (diff[0] + rb) & 0xFFFF;
    out[0] = ra;
    for (int x = 1; x < width; ++x) {
      const int rc = rb;
      rb = prev[x];
      int pred;
      switch (psv) {
        case 1: pred = ra; break;
        case 2: pred = rb; break;
        case 3: pred = rc; break;
        case 4: pred = ra + rb - rc; break;
        case 5: pred = ra + ((rb - rc) >> 1); break;
        case 6: pred = rb + ((ra - rc) >> 1); break;
        default: pred = (ra + rb) >> 1; break;
      }
      out[x] = ra = (diff[x] + pred) & 0xFFFF;
    }
  }

  // jdcoefct.c smoothing_ok (libjpeg-turbo 2.1 on): libjpeg smooths every
  // component's blocks when each component's quantisation table is
  // latched with nonzero DC and first nine AC entries, each DC is at least
  // partly known, and some component's first nine AC coefficients are not
  // all complete.
  bool smoothing_ok() const {
    if (!progressive_) return false;
    static const int kPos[9] = {1, 8, 16, 9, 2, 3, 10, 17, 24};  // Q01 Q10 Q20 Q11 Q02 Q03 Q12 Q21 Q30
    bool useful = false;
    for (const auto& c : comps_) {
      if (!c.seen || c.q[0] == 0) return false;
      for (int p : kPos)
        if (c.q[p] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  // jdcoefct.c decompress_smooth_data for one component (libjpeg-turbo
  // 2.1 on, the whole file read): each block's first AC coefficients that
  // are still zero and not known exactly are estimated from the DC values
  // of the 5x5 blocks around it (and the DC itself replaced) when no AC
  // coefficient has been sent at all, else from the row and column through
  // it; an estimate stays within what the coefficient's missing low bits
  // can hold. Neighbours past the edges repeat the nearest row or column,
  // by libjpeg's own indexing of the last iMCU row.
  void smooth_samples(const Component& c, uint8_t* plane, int stride) const {
    // libjpeg-turbo 2.1 on: an iMCU row past the last one the last scan
    // began with its data whole takes the coefficient bits from before
    // each component's last scan (-1 after a single scan).
    int prev_bits[10];
    for (int k = 0; k < 10; ++k) prev_bits[k] = scans_ > 1 ? c.prev_coef_bits[k] : -1;
    const int* bits = c.coef_bits;
    bool change_dc = true;
    auto q = [&](int pos) { return static_cast<int64_t>(static_cast<uint16_t>(c.q[pos])); };
    const int64_t Q00 = q(0), Q01 = q(1), Q10 = q(8), Q20 = q(16), Q11 = q(9), Q02 = q(2);
    const int64_t Q03 = q(3), Q12 = q(10), Q21 = q(17), Q30 = q(24);
    const int total_imcu = (height_ + 8 * max_v_ - 1) / (8 * max_v_);
    const int last_col = c.wib - 1;
    int16_t ws[64];
    auto estimate = [&](int al, int64_t num, int64_t qk) {
      int pred;
      if (num >= 0) {
        pred = static_cast<int>(((qk << 7) + num) / (qk << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      } else {
        pred = static_cast<int>(((qk << 7) - num) / (qk << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
        pred = -pred;
      }
      return static_cast<int16_t>(pred);
    };
    for (int imcu = 0; imcu < total_imcu; ++imcu) {
      bits = imcu > last_good_imcu_ ? prev_bits : c.coef_bits;
      change_dc = true;
      for (int k = 1; k < 10; ++k)
        if (bits[k] != -1) change_dc = false;
      int block_rows = c.v;
      if (imcu == total_imcu - 1) {
        block_rows = c.hib % c.v;
        if (block_rows == 0) block_rows = c.v;
      }
      const int image_block_rows = block_rows * total_imcu;
      for (int br = 0; br < block_rows; ++br) {
        const int row = imcu * c.v + br;  // in the stored blocks
        const int ibr = imcu * block_rows + br;
        const int r_prev = ibr > 0 ? row - 1 : row;
        const int r_pp = ibr > 1 ? row - 2 : r_prev;
        const int r_next = ibr < image_block_rows - 1 ? row + 1 : row;
        const int r_nn = ibr < image_block_rows - 2 ? row + 2 : r_next;
        const int rows5[5] = {r_pp, r_prev, row, r_next, r_nn};
        auto dc = [&](int r, int bx) {
          return static_cast<int>(c.coef[(static_cast<size_t>(rows5[r]) * c.bw + bx) * 64]);
        };
        for (int bx = 0; bx < c.wib; ++bx) {
          const int16_t* blk = c.coef.data() + (static_cast<size_t>(row) * c.bw + bx) * 64;
          std::memcpy(ws, blk, sizeof(ws));
          int DC[5][5];  // DC[r][k]: DC01-05, DC06-10, DC11-15, DC16-20, DC21-25
          for (int r = 0; r < 5; ++r)
            for (int k = 0; k < 5; ++k) DC[r][k] = dc(r, std::min(std::max(bx + k - 2, 0), last_col));
          const int DC01 = DC[0][0], DC02 = DC[0][1], DC03 = DC[0][2], DC04 = DC[0][3], DC05 = DC[0][4];
          const int DC06 = DC[1][0], DC07 = DC[1][1], DC08 = DC[1][2], DC09 = DC[1][3], DC10 = DC[1][4];
          const int DC11 = DC[2][0], DC12 = DC[2][1], DC13 = DC[2][2], DC14 = DC[2][3], DC15 = DC[2][4];
          const int DC16 = DC[3][0], DC17 = DC[3][1], DC18 = DC[3][2], DC19 = DC[3][3], DC20 = DC[3][4];
          const int DC21 = DC[4][0], DC22 = DC[4][1], DC23 = DC[4][2], DC24 = DC[4][3], DC25 = DC[4][4];
          int al;
          if ((al = bits[1]) != 0 && ws[1] == 0) {  // AC01
            const int64_t num = Q00 * (change_dc ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 +
                                                    3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 -
                                                    3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 - DC21 - DC22 +
                                                    DC24 + DC25)
                                                 : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
            ws[1] = estimate(al, num, Q01);
          }
          if ((al = bits[2]) != 0 && ws[8] == 0) {  // AC10
            const int64_t num = Q00 * (change_dc ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
                                                    13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 - 13 * DC17 -
                                                    38 * DC18 - 13 * DC19 + DC20 + DC21 + 3 * DC22 + 3 * DC23 +
                                                    3 * DC24 + DC25)
                                                 : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
            ws[8] = estimate(al, num, Q10);
          }
          if ((al = bits[3]) != 0 && ws[16] == 0) {  // AC20
            const int64_t num = Q00 * (change_dc ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 -
                                                    5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 + DC23)
                                                 : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
            ws[16] = estimate(al, num, Q20);
          }
          if ((al = bits[4]) != 0 && ws[9] == 0) {  // AC11
            const int64_t num = Q00 * (change_dc ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 +
                                                    DC21 - DC25)
                                                 : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 -
                                                    DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09));
            ws[9] = estimate(al, num, Q11);
          }
          if ((al = bits[5]) != 0 && ws[2] == 0) {  // AC02
            const int64_t num = Q00 * (change_dc ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 +
                                                    7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19)
                                                 : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
            ws[2] = estimate(al, num, Q02);
          }
          if (change_dc) {
            if ((al = bits[6]) != 0 && ws[3] == 0)  // AC03
              ws[3] = estimate(al, Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19), Q03);
            if ((al = bits[7]) != 0 && ws[10] == 0)  // AC12
              ws[10] = estimate(al, Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19), Q12);
            if ((al = bits[8]) != 0 && ws[17] == 0)  // AC21
              ws[17] = estimate(al, Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19), Q21);
            if ((al = bits[9]) != 0 && ws[24] == 0)  // AC30
              ws[24] = estimate(al, Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19), Q30);
            const int64_t num = Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 + 6 * DC07 +
                                       42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 + 152 * DC13 +
                                       42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 -
                                       6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
            ws[0] = estimate(0, num, Q00);
          }
          idct_islow(ws, c.q, plane + static_cast<size_t>(row) * 8 * stride + bx * 8, stride);
        }
      }
    }
  }

  // Component samples: a DCT component IDCT'd block by block (wib*8 x
  // hib*8, smoothed if `smooth`), a lossless one as decoded (dsw x dsh).
  std::vector<uint8_t> samples(const Component& c, bool smooth, int* stride) const {
    if (lossless_) {
      *stride = c.dsw;
      return c.plane;
    }
    *stride = c.wib * 8;
    std::vector<uint8_t> plane(static_cast<size_t>(*stride) * c.hib * 8, 0);
    if (!c.seen) {  // in no scan: libjpeg's zero multipliers give 128
      std::fill(plane.begin(), plane.end(), 128);
      return plane;
    }
    if (smooth) {
      smooth_samples(c, plane.data(), *stride);
      return plane;
    }
    for (int by = 0; by < c.hib; ++by)
      for (int bx = 0; bx < c.wib; ++bx)
        idct_islow(c.coef.data() + (static_cast<size_t>(by) * c.bw + bx) * 64, c.q,
                   plane.data() + static_cast<size_t>(by) * 8 * *stride + bx * 8, *stride);
    return plane;
  }

  // jdsample.c: the component at full size (width_ x height_), by the
  // method libjpeg picks for its sampling factors (no fancy upsampling in
  // a lossless frame, whose DCT scaled size is 1).
  void upsample(const Component& c, const std::vector<uint8_t>& plane, int stride, uint8_t* out) const {
    const int W = width_, H = height_;
    const bool fancy = !lossless_;
    auto in = [&](int y, int x) -> int { return plane[static_cast<size_t>(y) * stride + x]; };
    if (c.h == max_h_ && c.v == max_v_) {
      for (int y = 0; y < H; ++y) std::memcpy(out + static_cast<size_t>(y) * W, &plane[static_cast<size_t>(y) * stride], W);
    } else if (fancy && 2 * c.h == max_h_ && c.v == max_v_ && c.dsw > 2) {  // h2v1_fancy_upsample
      for (int y = 0; y < H; ++y) {
        uint8_t* o = out + static_cast<size_t>(y) * W;
        for (int x = 0; x < W; ++x) {
          const int i = x >> 1;
          const int nb = (x & 1) ? std::min(i + 1, c.dsw - 1) : std::max(i - 1, 0);
          o[x] = static_cast<uint8_t>((3 * in(y, i) + in(y, nb) + ((x & 1) ? 2 : 1)) >> 2);
        }
      }
    } else if (fancy && c.h == max_h_ && 2 * c.v == max_v_) {  // h1v2_fancy_upsample
      for (int y = 0; y < H; ++y) {
        const int i = y >> 1;
        const int nb = (y & 1) ? std::min(i + 1, c.dsh - 1) : std::max(i - 1, 0);
        const int bias = (y & 1) ? 2 : 1;
        uint8_t* o = out + static_cast<size_t>(y) * W;
        for (int x = 0; x < W; ++x) o[x] = static_cast<uint8_t>((3 * in(i, x) + in(nb, x) + bias) >> 2);
      }
    } else if (fancy && 2 * c.h == max_h_ && 2 * c.v == max_v_ && c.dsw > 2) {  // h2v2_fancy_upsample
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
    // jdapimin.c default_decompress_parms: the colour space of the file (a
    // lossless frame with neither marker is RGB whatever its ids).
    bool ycc = false;
    if (nc == 3) {
      if (jfif_) ycc = true;
      else if (adobe_) ycc = adobe_transform_ != 0;
      else if (lossless_) ycc = false;
      else ycc = !(comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66);  // 'R' 'G' 'B'
    } else if (nc == 4) {
      ycc = adobe_ && adobe_transform_ != 0;  // YCCK; else plain CMYK
    }
    if (lossless_) {
      if (ycc)
        throw Error(std::string("lossless JPEG in ") + (nc == 3 ? "YCbCr" : "YCCK") +
                    " is not supported (libjpeg does no lossy colour conversion in lossless mode)");
      for (const auto& c : comps_)
        if (!c.seen) throw Error("a lossless JPEG component in no scan is not supported");
    }
    if (colour_ == kColourNone) ycc = false;
    if (colour_ == kColourYcc) {
      if (nc != 3) throw Error("YCbCr to RGB asked of " + std::to_string(nc) + " components");
      ycc = true;
    }
    const bool smooth = !lossless_ && smoothing_ok();
    std::vector<std::vector<uint8_t>> full(nc);
    for (int ci = 0; ci < nc; ++ci) {
      full[ci].resize(npix);
      int stride = 0;
      const std::vector<uint8_t> plane = samples(comps_[ci], smooth, &stride);
      upsample(comps_[ci], plane, stride, full[ci].data());
    }
    if (nc == 1) {
      std::memcpy(out, full[0].data(), npix);
      return;
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
    if (colour_ == kColourNone) {  // four components as coded
      for (size_t p = 0; p < npix; ++p)
        for (int ci = 0; ci < 4; ++ci) out[4 * p + ci] = full[ci][p];
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
// bytes, row-major, C interleaved) and writes libjpeg's warnings into
// dims[11..14] (see Decoder::warnings). `read_block` > 0: the bytes Pillow
// reads at a time (an arithmetic-coded scan that reads past the blocks
// read before it raises, as in Pillow). Returns 0, or -1 with a message in
// err.
int64_t jpeg_decode(const uint8_t* data, int64_t n, int64_t read_block, uint8_t* out, int64_t out_cap, int64_t* dims,
                    char* err, int64_t err_cap) {
  try {
    Decoder d(data, static_cast<size_t>(n), static_cast<size_t>(read_block));
    if (out == nullptr) {
      d.header(dims);
    } else {
      d.decode(out, out_cap);
      d.warnings(dims + 11);
    }
    return 0;
  } catch (const std::exception& e) {
    set_error(err, err_cap, e.what());
    return -1;
  }
}

// A strip or tile of a JPEG-compressed TIFF (compression 7), as libtiff's
// tif_jpeg.c hands it to libjpeg: an abbreviated stream whose missing
// tables come from the JPEGTables field (`tables`, a tables-only stream,
// or ntables = 0), decoded in the colour space the TIFF names (`colour`:
// 1 as coded, for photometric RGB, MinIsBlack and the planes of a planar
// file; 2 YCbCr -> RGB, for photometric YCbCr), the whole stream in memory.
// With out == nullptr: writes H, W, C and each component's (h, v) into
// dims (3 + 2 * 4 entries). Returns 0, or -1 with a message in err.
int64_t jpeg_tiff_decode(const uint8_t* tables, int64_t ntables, const uint8_t* data, int64_t n, int64_t colour,
                         uint8_t* out, int64_t out_cap, int64_t* dims, char* err, int64_t err_cap) {
  try {
    std::vector<uint8_t> stream;
    if (ntables >= 4 && n >= 2 && data[0] == 0xFF && data[1] == 0xD8) {
      // The tables' segments (between their SOI and EOI) go in front of
      // the strip's own, which may replace them.
      stream.reserve(static_cast<size_t>(n + ntables));
      stream.insert(stream.end(), data, data + 2);
      stream.insert(stream.end(), tables + 2, tables + ntables - 2);
      stream.insert(stream.end(), data + 2, data + n);
    } else {
      stream.assign(data, data + n);
    }
    Decoder d(stream.data(), stream.size(), 0, kEndIsEoi);
    d.set_colour(static_cast<int>(colour));
    d.stop_after_scan();
    if (out == nullptr) d.header(dims);
    else d.decode(out, out_cap);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, err_cap, e.what());
    return -1;
  }
}

// A whole JPEG stream's components as libjpeg's raw_data_out gives them
// (see Decoder::decode_raw): dims gets H, W, C and each component's h, v,
// plane width and height (3 + 4 * 4 entries); with out == nullptr only
// the frame is read. Returns 0, or -1 with a message in err.
int64_t jpeg_raw_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t out_cap, int64_t* dims, char* err,
                        int64_t err_cap) {
  try {
    Decoder d(data, static_cast<size_t>(n), 0);
    d.decode_raw(out, out_cap, dims);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, err_cap, e.what());
    return -1;
  }
}

}  // extern "C"
