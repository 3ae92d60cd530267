// The codecs of TIFF and BMP files on the host, decoding to the bytes that
// Pillow 12.1 reads from them: TIFF's LZW (compression 5, libtiff 4.7's
// tif_lzw.c, both the standard MSB-first coding with its early change of
// code width and the old LSB-first coding that libtiff still reads),
// PackBits (32773, tif_packbits.c), libtiff's undoing of the horizontal
// (predictor 2, tif_predict.c horAcc8/16/32/64) and floating-point
// (predictor 3, fpAcc) predictors, the CCITT codings of tif_fax3.c (RLE 2,
// RLEW 32771, Group 3 1D and 2D 3, Group 4 4: libtiff's lookup tables,
// EOL synchronisation, its repair of bad lines and its errors), the
// ThunderScan 4-bit coding (32809, tif_thunder.c), and BMP's RLE8 and
// RLE4 run-length coding as Pillow's BmpRleDecoder (BmpImagePlugin.py)
// decodes it, its quirks included: a delta reads four bytes and takes the
// last two, an absolute run in RLE4 takes n / 2 bytes, and runs align to
// even offsets in the file. Deflate and LZMA go through Python's zlib and
// lzma, Zstandard through csrc/zstd_decode.cpp; the TIFF directory, the
// unpacking of samples into Pillow's modes and BMP's headers are numpy in
// utils/image_containers.py.
//
// Host library with a plain C interface, built with g++ into
// build/libcontainer_decode.so and loaded with ctypes by
// utils/image_containers.py.

#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

constexpr int kClear = 256;
constexpr int kEoi = 257;
constexpr int kMaxBits = 12;
// libtiff keeps 1024 entries past the 4096 that 12-bit codes reach, for
// coders that send their clear code late.
constexpr int kTableSize = (1 << kMaxBits) + 1024;

struct Entry {
  int prefix;  // code of the string without its last byte, -1 for a root
  uint8_t last;
  uint8_t first;
  int length;
};

// Reads codes of `nbits` from `in`, MSB first (standard) or LSB first (old).
struct BitReader {
  const uint8_t* in;
  int64_t n;
  int64_t pos = 0;
  uint64_t acc = 0;
  int have = 0;
  bool lsb;

  // The next code, or -1 once fewer than nbits bits are left.
  int next(int nbits) {
    while (have < nbits) {
      if (pos >= n) return -1;
      if (lsb)
        acc |= static_cast<uint64_t>(in[pos++]) << have;
      else
        acc = (acc << 8) | in[pos++];
      have += 8;
    }
    int code;
    if (lsb) {
      code = static_cast<int>(acc & ((1u << nbits) - 1));
      acc >>= nbits;
    } else {
      code = static_cast<int>((acc >> (have - nbits)) & ((1u << nbits) - 1));
    }
    have -= nbits;
    return code;
  }
};


// ---------------------------------------------------------------------------
// CCITT (tif_fax3.c, tif_fax3.h and the tables mkg3states.c writes)
// ---------------------------------------------------------------------------

enum FaxState : uint8_t {
  S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB, S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL
};

struct FaxEntry {
  uint8_t state = S_Null;
  uint8_t width = 0;
  uint32_t param = 0;
};

struct FaxCode {
  const char* bits;  // as T.4 writes it, first bit first
  uint32_t param;
};

const FaxCode kWhiteTerm[] = {
    {"00110101", 0},  {"000111", 1},    {"0111", 2},      {"1000", 3},      {"1011", 4},      {"1100", 5},
    {"1110", 6},      {"1111", 7},      {"10011", 8},     {"10100", 9},     {"00111", 10},    {"01000", 11},
    {"001000", 12},   {"000011", 13},   {"110100", 14},   {"110101", 15},   {"101010", 16},   {"101011", 17},
    {"0100111", 18},  {"0001100", 19},  {"0001000", 20},  {"0010111", 21},  {"0000011", 22},  {"0000100", 23},
    {"0101000", 24},  {"0101011", 25},  {"0010011", 26},  {"0100100", 27},  {"0011000", 28},  {"00000010", 29},
    {"00000011", 30}, {"00011010", 31}, {"00011011", 32}, {"00010010", 33}, {"00010011", 34}, {"00010100", 35},
    {"00010101", 36}, {"00010110", 37}, {"00010111", 38}, {"00101000", 39}, {"00101001", 40}, {"00101010", 41},
    {"00101011", 42}, {"00101100", 43}, {"00101101", 44}, {"00000100", 45}, {"00000101", 46}, {"00001010", 47},
    {"00001011", 48}, {"01010010", 49}, {"01010011", 50}, {"01010100", 51}, {"01010101", 52}, {"00100100", 53},
    {"00100101", 54}, {"01011000", 55}, {"01011001", 56}, {"01011010", 57}, {"01011011", 58}, {"01001010", 59},
    {"01001011", 60}, {"00110010", 61}, {"00110011", 62}, {"00110100", 63}};
const FaxCode kWhiteMakeUp[] = {
    {"11011", 64},       {"10010", 128},      {"010111", 192},     {"0110111", 256},    {"00110110", 320},
    {"00110111", 384},   {"01100100", 448},   {"01100101", 512},   {"01101000", 576},   {"01100111", 640},
    {"011001100", 704},  {"011001101", 768},  {"011010010", 832},  {"011010011", 896},  {"011010100", 960},
    {"011010101", 1024}, {"011010110", 1088}, {"011010111", 1152}, {"011011000", 1216}, {"011011001", 1280},
    {"011011010", 1344}, {"011011011", 1408}, {"010011000", 1472}, {"010011001", 1536}, {"010011010", 1600},
    {"011000", 1664},    {"010011011", 1728}};
const FaxCode kBlackTerm[] = {
    {"0000110111", 0},   {"010", 1},          {"11", 2},           {"10", 3},           {"011", 4},
    {"0011", 5},         {"0010", 6},         {"00011", 7},        {"000101", 8},       {"000100", 9},
    {"0000100", 10},     {"0000101", 11},     {"0000111", 12},     {"00000100", 13},    {"00000111", 14},
    {"000011000", 15},   {"0000010111", 16},  {"0000011000", 17},  {"0000001000", 18},  {"00001100111", 19},
    {"00001101000", 20}, {"00001101100", 21}, {"00000110111", 22}, {"00000101000", 23}, {"00000010111", 24},
    {"00000011000", 25}, {"000011001010", 26}, {"000011001011", 27}, {"000011001100", 28}, {"000011001101", 29},
    {"000001101000", 30}, {"000001101001", 31}, {"000001101010", 32}, {"000001101011", 33}, {"000011010010", 34},
    {"000011010011", 35}, {"000011010100", 36}, {"000011010101", 37}, {"000011010110", 38}, {"000011010111", 39},
    {"000001101100", 40}, {"000001101101", 41}, {"000011011010", 42}, {"000011011011", 43}, {"000001010100", 44},
    {"000001010101", 45}, {"000001010110", 46}, {"000001010111", 47}, {"000001100100", 48}, {"000001100101", 49},
    {"000001010010", 50}, {"000001010011", 51}, {"000000100100", 52}, {"000000110111", 53}, {"000000111000", 54},
    {"000000100111", 55}, {"000000101000", 56}, {"000001011000", 57}, {"000001011001", 58}, {"000000101011", 59},
    {"000000101100", 60}, {"000001011010", 61}, {"000001100110", 62}, {"000001100111", 63}};
const FaxCode kBlackMakeUp[] = {
    {"0000001111", 64},     {"000011001000", 128},  {"000011001001", 192},  {"000001011011", 256},
    {"000000110011", 320},  {"000000110100", 384},  {"000000110101", 448},  {"0000001101100", 512},
    {"0000001101101", 576}, {"0000001001010", 640}, {"0000001001011", 704}, {"0000001001100", 768},
    {"0000001001101", 832}, {"0000001110010", 896}, {"0000001110011", 960}, {"0000001110100", 1024},
    {"0000001110101", 1088}, {"0000001110110", 1152}, {"0000001110111", 1216}, {"0000001010010", 1280},
    {"0000001010011", 1344}, {"0000001010100", 1408}, {"0000001010101", 1472}, {"0000001011010", 1536},
    {"0000001011011", 1600}, {"0000001100100", 1664}, {"0000001100101", 1728}};
// The extended make-up codes both colours share.
const FaxCode kMakeUp[] = {
    {"00000001000", 1792},  {"00000001100", 1856},  {"00000001101", 1920},  {"000000010010", 1984},
    {"000000010011", 2048}, {"000000010100", 2112}, {"000000010101", 2176}, {"000000010110", 2240},
    {"000000010111", 2304}, {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560}};
// Two-dimensional modes: pass, horizontal, the vertical ones with their
// offset, the extension (uncompressed mode) and the EOL's first 7 zeros.
const FaxCode kPass[] = {{"0001", 0}};
const FaxCode kHoriz[] = {{"001", 0}};
const FaxCode kV0[] = {{"1", 0}};
const FaxCode kVR[] = {{"011", 1}, {"000011", 2}, {"0000011", 3}};
const FaxCode kVL[] = {{"010", 1}, {"000010", 2}, {"0000010", 3}};
const FaxCode kExt[] = {{"0000001", 0}};
const FaxCode kEOLV[] = {{"0000000", 0}};
// libtiff's EOL entries take 11 zero bits; the 12th, the 1, is skipped at
// the next row's synchronisation.
const FaxCode kEOLH[] = {{"00000000000", 0}};

// mkg3states.c's tables: indexed by the next `bits` bits, first bit in the
// least significant place; patterns no code matches stay S_Null, width 0.
struct FaxTables {
  FaxEntry main[128], white[4096], black[8192];

  template <size_t N>
  static void fill(FaxEntry* t, int bits, const FaxCode (&codes)[N], FaxState state) {
    for (const FaxCode& c : codes) {
      const int w = static_cast<int>(std::strlen(c.bits));
      uint32_t rev = 0;
      for (int i = 0; i < w; ++i)
        if (c.bits[i] == '1') rev |= 1u << i;
      for (uint32_t hi = 0; hi < (1u << (bits - w)); ++hi)
        t[rev | (hi << w)] = FaxEntry{state, static_cast<uint8_t>(w), c.param};
    }
  }

  FaxTables() {
    fill(main, 7, kPass, S_Pass);
    fill(main, 7, kHoriz, S_Horiz);
    fill(main, 7, kV0, S_V0);
    fill(main, 7, kVR, S_VR);
    fill(main, 7, kVL, S_VL);
    fill(main, 7, kExt, S_Ext);
    fill(main, 7, kEOLV, S_EOL);
    fill(white, 12, kWhiteMakeUp, S_MakeUpW);
    fill(white, 12, kMakeUp, S_MakeUp);
    fill(white, 12, kWhiteTerm, S_TermW);
    fill(white, 12, kEOLH, S_EOL);
    fill(black, 13, kBlackMakeUp, S_MakeUpB);
    fill(black, 13, kMakeUp, S_MakeUp);
    fill(black, 13, kBlackTerm, S_TermB);
    fill(black, 13, kEOLH, S_EOL);
  }
};

const FaxTables& fax_tables() {
  static const FaxTables tables;
  return tables;
}

// _TIFFFax3fillruns: white runs clear bits, black runs set them, each run
// clipped to the row (which changes it in `runs`, the next row's
// reference); bits past lastx are left as they were.
void fax_fill_runs(uint8_t* buf, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
  static const uint8_t kFillMasks[] = {0x00, 0x80, 0xc0, 0xe0, 0xf0, 0xf8, 0xfc, 0xfe, 0xff};
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  for (; runs < erun; runs += 2) {
    for (int colour = 0; colour < 2; ++colour) {
      uint32_t run = runs[colour];
      if (x + run > lastx || run > lastx) run = runs[colour] = lastx - x;
      if (!run) continue;
      uint8_t* cp = buf + (x >> 3);
      const uint32_t bx = x & 7;
      if (run > 8 - bx) {
        if (bx) {
          if (colour) *cp++ |= static_cast<uint8_t>(0xff >> bx);
          else *cp++ &= static_cast<uint8_t>(0xff << (8 - bx));
          run -= 8 - bx;
        }
        const uint32_t n = run >> 3;
        if (n) {
          std::memset(cp, colour ? 0xff : 0x00, n);
          cp += n;
          run &= 7;
        }
        if (run) {
          if (colour) cp[0] = static_cast<uint8_t>((cp[0] | (0xff00 >> run)) & 0xff);
          else cp[0] &= static_cast<uint8_t>(0xff >> run);
        }
      } else {
        if (colour) cp[0] |= static_cast<uint8_t>(kFillMasks[run] >> bx);
        else cp[0] &= static_cast<uint8_t>(~(kFillMasks[run] >> bx));
      }
      x += runs[colour];
    }
  }
}

// The decoders' return values.
constexpr int64_t kFaxOk = 1;
constexpr int64_t kFaxError = -1;       // libtiff fails the strip: an RLE row cut short, a run buffer overflow
// Group 3 or 4 data that ends (or meets an EOFB) in row r: -2 - r. libtiff
// fills that row from the runs decoded so far and stops; it fails the strip
// where r is 0 and takes it otherwise, the rows after r left as its caller's
// buffer held them. Group 3 data that ends inside a row, past its EOL,
// fails the strip (kFaxError).
constexpr int64_t kFaxEndedEarly = -2;

// The state of tif_fax3.h's macros: bits in the accumulator least
// significant first (each byte reversed for fill order 1, which the caller
// has already turned into this order), the run arrays and the row.
struct FaxDecoder {
  const FaxTables& t = fax_tables();
  const uint8_t* start;
  const uint8_t* cp;
  const uint8_t* ep;
  int64_t base;  // file offset of the strip: RLEW aligns to words of the file
  uint32_t acc = 0;
  int avail = 0;
  int eolcnt = 0;
  bool noeol = false;  // FAXMODE_NOEOL: the codec's, kept from strip to strip
  int lastx;
  int64_t rowbytes;
  uint32_t nruns;
  std::vector<uint32_t> runs;
  uint32_t* curruns;
  uint32_t* refruns;

  // `kept`: the run arrays libtiff allocates once for the file (2 *
  // nruns entries, or nullptr for fresh zeroed ones): a strip starts from
  // what the last one left there, its reference line but its first run
  // reset to white (Fax3PreDecode), and a row that reads past its
  // reference's end reads those runs.
  FaxDecoder(const uint8_t* in, int64_t n, int64_t base_offset, int width, bool two_d, uint32_t* kept)
      : start(in), cp(in), ep(in + n), base(base_offset), lastx(width), rowbytes((width + 7) / 8) {
    nruns = run_count(width, two_d);
    uint32_t* base_runs = kept;
    if (!kept) {
      runs.assign(2 * static_cast<size_t>(nruns), 0);
      base_runs = runs.data();
    }
    curruns = base_runs;
    refruns = two_d ? base_runs + nruns : nullptr;
    if (refruns) {  // the reference line starts white
      refruns[0] = static_cast<uint32_t>(width);
      refruns[1] = 0;
    }
  }
  static uint32_t run_count(int width, bool two_d) {
    const uint32_t n = ((static_cast<uint32_t>(width) + 1 + 31) / 32) * 32;
    return two_d ? 2 * n : n;
  }
  // Group 3 without EOLs from here on, from the strip's first bit.
  void rewind() {
    noeol = true;
    cp = start;
    acc = 0;
    avail = 0;
    eolcnt = 0;
  }
};

#define FAX_EOD() (d.cp >= d.ep)
#define FAX_NEED8(n, eoflab)                                   \
  do {                                                         \
    if (d.avail < (n)) {                                       \
      if (FAX_EOD()) {                                         \
        if (d.avail == 0) goto eoflab;                         \
        d.avail = (n);                                         \
      } else {                                                 \
        d.acc |= static_cast<uint32_t>(kRev[*d.cp++]) << d.avail; \
        d.avail += 8;                                          \
      }                                                        \
    }                                                          \
  } while (0)
#define FAX_NEED16(n, eoflab)                                      \
  do {                                                             \
    if (d.avail < (n)) {                                           \
      if (FAX_EOD()) {                                             \
        if (d.avail == 0) goto eoflab;                             \
        d.avail = (n);                                             \
      } else {                                                     \
        d.acc |= static_cast<uint32_t>(kRev[*d.cp++]) << d.avail;  \
        if ((d.avail += 8) < (n)) {                                \
          if (FAX_EOD()) {                                         \
            d.avail = (n);                                         \
          } else {                                                 \
            d.acc |= static_cast<uint32_t>(kRev[*d.cp++]) << d.avail; \
            d.avail += 8;                                          \
          }                                                        \
        }                                                          \
      }                                                            \
    }                                                              \
  } while (0)
#define FAX_GET(n) (d.acc & ((1u << (n)) - 1))
#define FAX_CLR(n)     \
  do {                 \
    d.avail -= (n);    \
    d.acc >>= (n);     \
  } while (0)
#define FAX_LOOKUP8(wid, tab, eoflab) \
  do {                                \
    FAX_NEED8(wid, eoflab);           \
    te = &(tab)[FAX_GET(wid)];        \
    FAX_CLR(te->width);               \
  } while (0)
#define FAX_LOOKUP16(wid, tab, eoflab) \
  do {                                 \
    FAX_NEED16(wid, eoflab);           \
    te = &(tab)[FAX_GET(wid)];         \
    FAX_CLR(te->width);                \
  } while (0)
#define FAX_SETVALUE(x)                                        \
  do {                                                         \
    if (pa >= thisrun + d.nruns) return kFaxError;             \
    *pa++ = static_cast<uint32_t>(runlength + (x));            \
    a0 += (x);                                                 \
    runlength = 0;                                             \
  } while (0)
#define FAX_CLEANUP_RUNS()                                      \
  do {                                                          \
    if (runlength) FAX_SETVALUE(0);                             \
    if (a0 != lastx) {                                          \
      while (a0 > lastx && pa > thisrun) a0 -= *--pa;           \
      if (a0 < lastx) {                                         \
        if (a0 < 0) a0 = 0;                                     \
        if ((pa - thisrun) & 1) FAX_SETVALUE(0);                \
        FAX_SETVALUE(lastx - a0);                               \
      } else if (a0 > lastx) {                                  \
        FAX_SETVALUE(lastx);                                    \
        FAX_SETVALUE(0);                                        \
      }                                                         \
    }                                                           \
  } while (0)
// Skips to the bit after the next EOL (the 11-zero search is skipped when
// the last row ended on an EOL's zeros). Data that ends while the EOL's
// zeros are skipped goes to `retrylab`: libtiff 4.7 then decodes the strip
// again from its start without EOLs (FAXMODE_NOEOL, "Try to decode (read)
// fax Group 3 data without EOL"), from the row it was at.
#define FAX_SYNC_EOL(eoflab, retrylab)       \
  do {                                       \
    if (d.eolcnt == 0) {                     \
      for (;;) {                             \
        FAX_NEED16(11, eoflab);              \
        if (FAX_GET(11) == 0) break;         \
        FAX_CLR(1);                          \
      }                                      \
    }                                        \
    for (;;) {                               \
      FAX_NEED8(8, retrylab);                \
      if (FAX_GET(8)) break;                 \
      FAX_CLR(8);                            \
    }                                        \
    while (FAX_GET(1) == 0) FAX_CLR(1);      \
    FAX_CLR(1);                              \
    d.eolcnt = 0;                            \
  } while (0)
// A row of white/black runs (EXPAND1D): a bad code word ends the row, which
// CLEANUP_RUNS then repairs, as libtiff does after its error message.
#define FAX_EXPAND1D(eoflab)                                  \
  do {                                                        \
    for (;;) {                                                \
      for (;;) {                                              \
        FAX_LOOKUP16(12, d.t.white, eof1d);                   \
        switch (te->state) {                                  \
          case S_EOL:                                         \
            d.eolcnt = 1;                                     \
            goto done1d;                                      \
          case S_TermW:                                       \
            FAX_SETVALUE(te->param);                          \
            goto doneWhite1d;                                 \
          case S_MakeUpW:                                     \
          case S_MakeUp:                                      \
            a0 += te->param;                                  \
            runlength += te->param;                           \
            break;                                            \
          default:                                            \
            goto done1d;                                      \
        }                                                     \
      }                                                       \
    doneWhite1d:                                              \
      if (a0 >= lastx) goto done1d;                           \
      for (;;) {                                              \
        FAX_LOOKUP16(13, d.t.black, eof1d);                   \
        switch (te->state) {                                  \
          case S_EOL:                                         \
            d.eolcnt = 1;                                     \
            goto done1d;                                      \
          case S_TermB:                                       \
            FAX_SETVALUE(te->param);                          \
            goto doneBlack1d;                                 \
          case S_MakeUpB:                                     \
          case S_MakeUp:                                      \
            a0 += te->param;                                  \
            runlength += te->param;                           \
            break;                                            \
          default:                                            \
            goto done1d;                                      \
        }                                                     \
      }                                                       \
    doneBlack1d:                                              \
      if (a0 >= lastx) goto done1d;                           \
      if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;          \
    }                                                         \
  eof1d:                                                      \
    FAX_CLEANUP_RUNS();                                       \
    goto eoflab;                                              \
  done1d:                                                     \
    FAX_CLEANUP_RUNS();                                       \
  } while (0)
#define FAX_CHECK_B1                                                   \
  do {                                                                 \
    if (pa != thisrun)                                                 \
      while (b1 <= a0 && b1 < lastx) {                                 \
        if (pb + 1 >= d.refruns + d.nruns) return kFaxError;           \
        b1 += pb[0] + pb[1];                                           \
        pb += 2;                                                       \
      }                                                                \
  } while (0)
// A row against the reference row (EXPAND2D). Uncompressed mode (the
// extension code) ends the row, as libtiff, which does not support it,
// ends it after its error message.
#define FAX_EXPAND2D(eoflab)                                          \
  do {                                                                \
    while (a0 < lastx) {                                              \
      if (pa >= thisrun + d.nruns) return kFaxError;                  \
      FAX_LOOKUP8(7, d.t.main, eof2d);                                \
      switch (te->state) {                                            \
        case S_Pass:                                                  \
          FAX_CHECK_B1;                                               \
          if (pb + 1 >= d.refruns + d.nruns) return kFaxError;        \
          b1 += *pb++;                                                \
          runlength += b1 - a0;                                       \
          a0 = b1;                                                    \
          b1 += *pb++;                                                \
          break;                                                      \
        case S_Horiz:                                                 \
          if ((pa - thisrun) & 1) {                                   \
            for (;;) {                                                \
              FAX_LOOKUP16(13, d.t.black, eof2d);                     \
              switch (te->state) {                                    \
                case S_TermB:                                         \
                  FAX_SETVALUE(te->param);                            \
                  goto doneWhite2da;                                  \
                case S_MakeUpB:                                       \
                case S_MakeUp:                                        \
                  a0 += te->param;                                    \
                  runlength += te->param;                             \
                  break;                                              \
                default:                                              \
                  goto eol2d;                                         \
              }                                                       \
            }                                                         \
          doneWhite2da:;                                              \
            for (;;) {                                                \
              FAX_LOOKUP16(12, d.t.white, eof2d);                     \
              switch (te->state) {                                    \
                case S_TermW:                                         \
                  FAX_SETVALUE(te->param);                            \
                  goto doneBlack2da;                                  \
                case S_MakeUpW:                                       \
                case S_MakeUp:                                        \
                  a0 += te->param;                                    \
                  runlength += te->param;                             \
                  break;                                              \
                default:                                              \
                  goto eol2d;                                         \
              }                                                       \
            }                                                         \
          doneBlack2da:;                                              \
          } else {                                                    \
            for (;;) {                                                \
              FAX_LOOKUP16(12, d.t.white, eof2d);                     \
              switch (te->state) {                                    \
                case S_TermW:                                         \
                  FAX_SETVALUE(te->param);                            \
                  goto doneWhite2db;                                  \
                case S_MakeUpW:                                       \
                case S_MakeUp:                                        \
                  a0 += te->param;                                    \
                  runlength += te->param;                             \
                  break;                                              \
                default:                                              \
                  goto eol2d;                                         \
              }                                                       \
            }                                                         \
          doneWhite2db:;                                              \
            for (;;) {                                                \
              FAX_LOOKUP16(13, d.t.black, eof2d);                     \
              switch (te->state) {                                    \
                case S_TermB:                                         \
                  FAX_SETVALUE(te->param);                            \
                  goto doneBlack2db;                                  \
                case S_MakeUpB:                                       \
                case S_MakeUp:                                        \
                  a0 += te->param;                                    \
                  runlength += te->param;                             \
                  break;                                              \
                default:                                              \
                  goto eol2d;                                         \
              }                                                       \
            }                                                         \
          doneBlack2db:;                                              \
          }                                                           \
          FAX_CHECK_B1;                                               \
          break;                                                      \
        case S_V0:                                                    \
          FAX_CHECK_B1;                                               \
          FAX_SETVALUE(b1 - a0);                                      \
          if (pb >= d.refruns + d.nruns) return kFaxError;            \
          b1 += *pb++;                                                \
          break;                                                      \
        case S_VR:                                                    \
          FAX_CHECK_B1;                                               \
          FAX_SETVALUE(b1 - a0 + static_cast<int>(te->param));        \
          if (pb >= d.refruns + d.nruns) return kFaxError;            \
          b1 += *pb++;                                                \
          break;                                                      \
        case S_VL:                                                    \
          FAX_CHECK_B1;                                               \
          if (b1 < a0 + static_cast<int>(te->param)) goto eol2d;      \
          FAX_SETVALUE(b1 - a0 - static_cast<int>(te->param));        \
          b1 -= *--pb;                                                \
          break;                                                      \
        case S_Ext:                                                   \
          *pa++ = static_cast<uint32_t>(lastx - a0);                  \
          goto eol2d;                                                 \
        case S_EOL:                                                   \
          *pa++ = static_cast<uint32_t>(lastx - a0);                  \
          FAX_NEED8(4, eof2d);                                        \
          FAX_CLR(4);                                                 \
          d.eolcnt = 1;                                               \
          goto eol2d;                                                 \
        default:                                                      \
          goto eol2d;                                                 \
      }                                                               \
    }                                                                 \
    if (runlength) {                                                  \
      if (runlength + a0 < lastx) {                                   \
        FAX_NEED8(1, eof2d);                                          \
        if (!FAX_GET(1)) goto eol2d;                                  \
        FAX_CLR(1);                                                   \
      }                                                               \
      FAX_SETVALUE(0);                                                \
    }                                                                 \
    goto eol2d;                                                       \
  eof2d:                                                              \
    FAX_CLEANUP_RUNS();                                               \
    goto eoflab;                                                      \
  eol2d:                                                              \
    FAX_CLEANUP_RUNS();                                               \
  } while (0)

// The byte-reversal table of tif_swab.c (libtiff's decoder reads bits
// least significant first; the caller has put the strip in fill order 1).
struct RevTable {
  uint8_t v[256];
  RevTable() {
    for (int i = 0; i < 256; ++i) {
      int r = 0;
      for (int b = 0; b < 8; ++b)
        if (i & (1 << b)) r |= 0x80 >> b;
      v[i] = static_cast<uint8_t>(r);
    }
  }
};
const RevTable kRevTable;
const uint8_t* const kRev = kRevTable.v;

// Fax3DecodeRLE: rows of 1D runs with no EOLs, each row ending on a byte
// (RLE) or on a 16-bit word of the file (RLEW: libtiff tests the address
// of its memory map of the file).
int64_t fax_decode_rle(FaxDecoder& d, uint8_t* buf, int64_t rows, bool word_align) {
  const FaxEntry* te;
  int a0, runlength, drop;
  const int lastx = d.lastx;
  uint32_t *pa, *thisrun = d.curruns;
  for (int64_t row = 0; row < rows; ++row) {
    a0 = 0;
    runlength = 0;
    pa = thisrun;
    FAX_EXPAND1D(EOFRLE);
    fax_fill_runs(buf, thisrun, pa, static_cast<uint32_t>(lastx));
    drop = d.avail & (word_align ? 15 : 7);
    FAX_CLR(drop);
    if (word_align && d.avail == 0 && ((d.base + (d.cp - d.start)) & 1)) ++d.cp;
    buf += d.rowbytes;
    continue;
  EOFRLE:
    fax_fill_runs(buf, thisrun, pa, static_cast<uint32_t>(lastx));
    return kFaxError;
  }
  return kFaxOk;
}

// Fax3Decode1D: each row after an EOL, in 1D runs.
int64_t fax_decode_g3_1d(FaxDecoder& d, uint8_t* buf, int64_t rows) {
  const FaxEntry* te;
  int a0, runlength;
  const int lastx = d.lastx;
  uint32_t *pa, *thisrun = d.curruns;
  for (int64_t row = 0; row < rows; ++row) {
    a0 = 0;
    runlength = 0;
    pa = thisrun;
    if (!d.noeol) FAX_SYNC_EOL(EOF1D, RETRY1D);
  synced1d:
    FAX_EXPAND1D(EOF1Da);
    fax_fill_runs(buf, thisrun, pa, static_cast<uint32_t>(lastx));
    buf += d.rowbytes;
    continue;
  RETRY1D:
    d.rewind();
    goto synced1d;
  EOF1D:
    FAX_CLEANUP_RUNS();
    fax_fill_runs(buf, thisrun, pa, static_cast<uint32_t>(lastx));
    return kFaxEndedEarly - row;
  EOF1Da:  // the data ends inside a row: libtiff fails the strip
    return kFaxError;
  }
  return kFaxOk;
}

// Fax3Decode2D: each row after an EOL and its tag bit, 1 for a 1D row, 0
// for a row coded against the one before.
int64_t fax_decode_g3_2d(FaxDecoder& d, uint8_t* buf, int64_t rows) {
  const FaxEntry* te;
  int a0, runlength, b1, is1d;
  const int lastx = d.lastx;
  uint32_t *pa, *thisrun, *pb;
  for (int64_t row = 0; row < rows; ++row) {
    a0 = 0;
    runlength = 0;
    pa = thisrun = d.curruns;
    if (!d.noeol) FAX_SYNC_EOL(EOF2D, RETRY2D);
  synced2d:
    FAX_NEED8(1, EOF2D);
    is1d = FAX_GET(1);
    FAX_CLR(1);
    pb = d.refruns;
    b1 = static_cast<int>(*pb++);
    if (is1d) FAX_EXPAND1D(EOF2Da);
    else FAX_EXPAND2D(EOF2Da);
    fax_fill_runs(buf, thisrun, pa, static_cast<uint32_t>(lastx));
    if (pa < thisrun + d.nruns) FAX_SETVALUE(0);  // imaginary change for the reference
    std::swap(d.curruns, d.refruns);
    buf += d.rowbytes;
    continue;
  RETRY2D:
    d.rewind();
    goto synced2d;
  EOF2D:
    FAX_CLEANUP_RUNS();
    fax_fill_runs(buf, thisrun, pa, static_cast<uint32_t>(lastx));
    return kFaxEndedEarly - row;
  EOF2Da:  // the data ends inside a row: libtiff fails the strip
    return kFaxError;
  }
  return kFaxOk;
}

// Fax4Decode: every row against the one before, no EOLs; an EOFB or the
// data's end ends the strip (see kFaxEndedEarly).
int64_t fax_decode_g4(FaxDecoder& d, uint8_t* buf, int64_t rows) {
  const FaxEntry* te;
  int a0, runlength, b1;
  const int lastx = d.lastx;
  uint32_t *pa, *thisrun, *pb;
  for (int64_t row = 0; row < rows; ++row) {
    a0 = 0;
    runlength = 0;
    pa = thisrun = d.curruns;
    pb = d.refruns;
    b1 = static_cast<int>(*pb++);
    FAX_EXPAND2D(EOFG4);
    if (d.eolcnt) goto EOFG4;
    fax_fill_runs(buf, thisrun, pa, static_cast<uint32_t>(lastx));
    FAX_SETVALUE(0);  // imaginary change for the reference
    std::swap(d.curruns, d.refruns);
    buf += d.rowbytes;
    continue;
  EOFG4:
    fax_fill_runs(buf, thisrun, pa, static_cast<uint32_t>(lastx));
    return kFaxEndedEarly - row;
  }
  return kFaxOk;
}

#undef FAX_EOD
#undef FAX_NEED8
#undef FAX_NEED16
#undef FAX_GET
#undef FAX_CLR
#undef FAX_LOOKUP8
#undef FAX_LOOKUP16
#undef FAX_SETVALUE
#undef FAX_CLEANUP_RUNS
#undef FAX_SYNC_EOL
#undef FAX_EXPAND1D
#undef FAX_CHECK_B1
#undef FAX_EXPAND2D

// ---------------------------------------------------------------------------
// ThunderScan (tif_thunder.c)
// ---------------------------------------------------------------------------

// ThunderDecode for one row of `maxpixels` 4-bit pixels: runs of the last
// pixel, 2- and 3-bit deltas and raw values, quirks included. Returns 1,
// or 0 where libtiff fails ("Not enough data" / "Too much data").
int thunder_decode_row(const uint8_t*& bp, int64_t& cc, uint8_t* op0, int64_t maxpixels) {
  static const int kTwoBit[4] = {0, 1, 0, -1};
  static const int kThreeBit[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  unsigned int lastpixel = 0;
  int64_t npixels = 0;
  uint8_t* op = op0;
  auto setpixel = [&](unsigned int v) {
    lastpixel = v & 0xf;
    if (npixels < maxpixels) {
      if (npixels++ & 1) *op++ |= static_cast<uint8_t>(lastpixel);
      else op[0] = static_cast<uint8_t>(lastpixel << 4);
    }
  };
  while (cc > 0 && npixels < maxpixels) {
    int n = *bp++, delta;
    cc--;
    switch (n & 0xc0) {
      case 0x00:  // a run of the last pixel, n times
        if (npixels & 1) {
          op[0] |= static_cast<uint8_t>(lastpixel);
          lastpixel = *op++;
          npixels++;
          n--;
        } else {
          lastpixel |= lastpixel << 4;
        }
        npixels += n;
        if (npixels < maxpixels)
          for (; n > 0; n -= 2) *op++ = static_cast<uint8_t>(lastpixel);
        if (n == -1) *--op &= 0xf0;
        lastpixel &= 0xf;
        break;
      case 0x40:  // three 2-bit deltas, 2 skips
        if ((delta = (n >> 4) & 3) != 2) setpixel(static_cast<unsigned>(static_cast<int>(lastpixel) + kTwoBit[delta]));
        if ((delta = (n >> 2) & 3) != 2) setpixel(static_cast<unsigned>(static_cast<int>(lastpixel) + kTwoBit[delta]));
        if ((delta = n & 3) != 2) setpixel(static_cast<unsigned>(static_cast<int>(lastpixel) + kTwoBit[delta]));
        break;
      case 0x80:  // two 3-bit deltas, 4 skips
        if ((delta = (n >> 3) & 7) != 4)
          setpixel(static_cast<unsigned>(static_cast<int>(lastpixel) + kThreeBit[delta]));
        if ((delta = n & 7) != 4) setpixel(static_cast<unsigned>(static_cast<int>(lastpixel) + kThreeBit[delta]));
        break;
      default:  // a raw pixel
        setpixel(static_cast<unsigned>(n));
        break;
    }
  }
  if (npixels != maxpixels) {
    uint8_t* op_end = op0 + (maxpixels + 1) / 2;
    if (op < op_end) std::memset(op, 0, static_cast<size_t>(op_end - op));
    return 0;
  }
  return 1;
}

}  // namespace

extern "C" {

// LZW-decodes `in` into `out`, stopping when out_size bytes are written
// (the rest of a string that runs past the end is dropped, as libtiff drops
// it at the end of a strip), at the end-of-information code or when the
// input runs out (which libtiff treats as the end, with a warning).
// Returns the bytes written, or -1 for a corrupt table (a code past the
// next free one, a table past its 5120 entries, or a first code that is not
// a clear).
int64_t lzw_decode(const uint8_t* in, int64_t n, uint8_t* out, int64_t out_size) {
  // libtiff reads the old coding where the data starts 0x00 followed by a
  // byte with its low bit set (tif_lzw.c LZWPreDecode).
  const bool old = n >= 2 && in[0] == 0 && (in[1] & 1);
  BitReader bits{in, n, 0, 0, 0, old};
  std::vector<Entry> table(kTableSize);
  for (int i = 0; i < 256; ++i) table[i] = Entry{-1, static_cast<uint8_t>(i), static_cast<uint8_t>(i), 1};
  std::vector<uint8_t> scratch(kTableSize + 1);
  int nbits = 9;
  int free_ent = 258;
  int old_code = -1;
  int64_t written = 0;
  // The standard coding widens one code early: at 511, 1023, 2047 free.
  const int early = old ? 0 : 1;
  auto emit = [&](int code) {
    const int len = table[code].length;
    int c = code;
    for (int i = len - 1; i >= 0; --i) {
      scratch[i] = table[c].last;
      c = table[c].prefix;
    }
    const int64_t take = len < out_size - written ? len : out_size - written;
    std::memcpy(out + written, scratch.data(), take);
    written += take;
  };
  while (written < out_size) {
    int code = bits.next(nbits);
    if (code < 0 || code == kEoi) break;
    if (code == kClear) {
      nbits = 9;
      free_ent = 258;
      do {
        code = bits.next(nbits);
      } while (code == kClear);
      if (code < 0 || code == kEoi) break;
      if (code > kClear) return -1;
      emit(code);
      old_code = code;
      continue;
    }
    if (old_code < 0 || code > free_ent || free_ent >= kTableSize) return -1;
    const uint8_t first = code == free_ent ? table[old_code].first : table[code].first;
    table[free_ent] = Entry{old_code, first, table[old_code].first, table[old_code].length + 1};
    ++free_ent;
    emit(code);
    old_code = code;
    if (free_ent + early >= (1 << nbits) && nbits < kMaxBits) ++nbits;
  }
  return written;
}

// PackBits-decodes `in` into `out` (tif_packbits.c): a run that would
// overflow `out` is cut to fit, a header with no data after it ends the
// decoding. Returns the bytes written.
int64_t packbits_decode(const uint8_t* in, int64_t n, uint8_t* out, int64_t out_size) {
  int64_t cc = n, occ = out_size;
  const uint8_t* bp = in;
  uint8_t* op = out;
  while (cc > 0 && occ > 0) {
    int64_t k = *bp++;
    --cc;
    if (k >= 128) k -= 256;
    if (k < 0) {
      if (k == -128) continue;  // no-op
      k = -k + 1;
      if (occ < k) k = occ;
      if (cc == 0) break;
      const uint8_t b = *bp++;
      --cc;
      std::memset(op, b, k);
      op += k;
      occ -= k;
    } else {
      if (occ < k + 1) k = occ - 1;
      if (cc < k + 1) break;
      ++k;
      std::memcpy(op, bp, k);
      op += k;
      occ -= k;
      bp += k;
      cc -= k;
    }
  }
  return op - out;
}

// Undoes a TIFF predictor in place on `rows` rows of `row_bytes` bytes whose
// samples are already in the host's (little-endian) order: predictor 2 adds
// each sample to the one `stride` samples before it, modulo 2^(8 * size),
// for samples of `size` = 1, 2, 4 or 8 bytes; predictor 3 (floating point)
// adds each byte to the one `stride` bytes before it, then regathers each
// sample from the row's byte planes, most significant plane first.
// Returns 0, or -1 for a combination libtiff refuses.
int64_t predictor_undo(uint8_t* buf, int64_t rows, int64_t row_bytes, int64_t stride, int64_t size,
                       int64_t predictor) {
  if (stride <= 0 || row_bytes % (stride * size) != 0) return -1;
  if (predictor == 2) {
    for (int64_t r = 0; r < rows; ++r) {
      uint8_t* row = buf + r * row_bytes;
      const int64_t count = row_bytes / size;
      switch (size) {
        case 1:
          for (int64_t i = stride; i < count; ++i) row[i] = static_cast<uint8_t>(row[i] + row[i - stride]);
          break;
        case 2: {
          auto* w = reinterpret_cast<uint16_t*>(row);
          for (int64_t i = stride; i < count; ++i) w[i] = static_cast<uint16_t>(w[i] + w[i - stride]);
          break;
        }
        case 4: {
          auto* w = reinterpret_cast<uint32_t*>(row);
          for (int64_t i = stride; i < count; ++i) w[i] += w[i - stride];
          break;
        }
        case 8: {
          auto* w = reinterpret_cast<uint64_t*>(row);
          for (int64_t i = stride; i < count; ++i) w[i] += w[i - stride];
          break;
        }
        default:
          return -1;
      }
    }
    return 0;
  }
  if (predictor == 3) {
    std::vector<uint8_t> tmp(row_bytes);
    const int64_t words = row_bytes / size;
    for (int64_t r = 0; r < rows; ++r) {
      uint8_t* row = buf + r * row_bytes;
      for (int64_t i = stride; i < row_bytes; ++i) row[i] = static_cast<uint8_t>(row[i] + row[i - stride]);
      std::memcpy(tmp.data(), row, row_bytes);
      for (int64_t w = 0; w < words; ++w)
        for (int64_t b = 0; b < size; ++b) row[size * w + b] = tmp[(size - b - 1) * words + w];
    }
    return 0;
  }
  return -1;
}

// Decodes BMP RLE8 (rle4 = 0) or RLE4 (rle4 = 1) data as Pillow's
// BmpRleDecoder: `file` is the whole file and decoding starts at `start`;
// one index byte per pixel goes to `out`, rows of `width` pixels in the
// file's order, until `out_size` (width x height) bytes are reached or the
// data ends. Writes at most out_cap bytes (Pillow may overshoot a row).
// Returns the bytes produced, -2 where Pillow fails on a delta cut short.
int64_t bmp_rle_decode(const uint8_t* file, int64_t n, int64_t start, int64_t width, int64_t out_size, int64_t rle4,
                       uint8_t* out, int64_t out_cap) {
  int64_t pos = start, len = 0, x = 0;
  auto put = [&](uint8_t v) {
    if (len < out_cap) out[len] = v;
    ++len;
  };
  while (len < out_size) {
    if (pos + 2 > n) break;
    int64_t pixels = file[pos];
    const uint8_t byte = file[pos + 1];
    pos += 2;
    if (pixels) {  // encoded run
      if (x + pixels > width) pixels = width - x > 0 ? width - x : 0;
      for (int64_t i = 0; i < pixels; ++i) put(rle4 ? ((i % 2 == 0) ? byte >> 4 : byte & 0x0F) : byte);
      x += pixels;
    } else if (byte == 0) {  // end of line
      while (len % width != 0) put(0);
      x = 0;
    } else if (byte == 1) {  // end of bitmap
      break;
    } else if (byte == 2) {  // delta: Pillow reads two bytes, then takes the next two
      if (pos + 2 > n) break;
      pos += 2;
      if (pos + 2 > n) return -2;
      const int64_t right = file[pos], up = file[pos + 1];
      pos += 2;
      for (int64_t i = 0; i < right + up * width; ++i) put(0);
      x = len % width;
    } else {  // absolute run
      const int64_t count = rle4 ? byte / 2 : byte;
      const int64_t avail = n - pos < count ? n - pos : count;
      for (int64_t i = 0; i < avail; ++i) {
        const uint8_t v = file[pos + i];
        if (rle4) {
          put(v >> 4);
          put(v & 0x0F);
        } else {
          put(v);
        }
      }
      pos += avail;
      if (avail < count) break;
      x += byte;
      if (pos % 2 != 0) ++pos;
    }
  }
  return len;
}

// Decodes one CCITT strip or tile of `rows` rows of `width` 1-bit pixels
// into `out` (rows of (width + 7) / 8 bytes) as libtiff's Fax3/Fax4 decoders
// do: compression 2 (RLE), 32771 (RLEW), 3 (Group 3, 2D when `two_d`, the
// T4Options bit) or 4 (Group 4). `in` is in fill order 1; `file_offset` is
// where it starts in the file; `noeol` carries libtiff's FAXMODE_NOEOL
// from one strip to the next (in and out), and `runs` (runs_len entries,
// zeroed for the file's first strip) its run arrays. Returns 1, -1 where libtiff
// fails the strip, or -2 - r where Group 3 or 4 data ends in row r (see
// kFaxEndedEarly).
int64_t fax_decode(const uint8_t* in, int64_t n, int64_t file_offset, int64_t compression, int64_t two_d,
                   int64_t width, int64_t rows, uint8_t* out, int64_t* noeol, uint32_t* runs, int64_t runs_len) {
  if (width <= 0 || width > (1 << 28)) return -1;
  const bool refline = compression == 4 || (compression == 3 && two_d);
  const int64_t need = 2 * static_cast<int64_t>(FaxDecoder::run_count(static_cast<int>(width), refline));
  FaxDecoder d(in, n, file_offset, static_cast<int>(width), refline, runs_len >= need ? runs : nullptr);
  d.noeol = *noeol != 0;
  int64_t status;
  switch (compression) {
    case 2: status = fax_decode_rle(d, out, rows, false); break;
    case 32771: status = fax_decode_rle(d, out, rows, true); break;
    case 3: status = two_d ? fax_decode_g3_2d(d, out, rows) : fax_decode_g3_1d(d, out, rows); break;
    case 4: status = fax_decode_g4(d, out, rows); break;
    default: return -1;
  }
  *noeol = d.noeol;
  return status;
}

// Decodes a ThunderScan strip or tile of `rows` rows of `width` 4-bit
// pixels into `out` (rows of (width + 1) / 2 bytes), each row from where
// the last one stopped. Returns 1, or 0 where libtiff fails the strip.
int64_t thunder_decode(const uint8_t* in, int64_t n, int64_t width, int64_t rows, uint8_t* out) {
  const uint8_t* bp = in;
  int64_t cc = n;
  const int64_t row_bytes = (width + 1) / 2;
  for (int64_t r = 0; r < rows; ++r)
    if (!thunder_decode_row(bp, cc, out + r * row_bytes, width)) return 0;
  return 1;
}

}  // extern "C"
