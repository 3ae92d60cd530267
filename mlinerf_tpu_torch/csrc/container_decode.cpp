// The codecs of TIFF and BMP files on the host, decoding to the bytes that
// Pillow 12.1 reads from them: TIFF's LZW (compression 5, libtiff 4.7's
// tif_lzw.c, both the standard MSB-first coding with its early change of
// code width and the old LSB-first coding that libtiff still reads),
// PackBits (32773, tif_packbits.c), libtiff's undoing of the horizontal
// (predictor 2, tif_predict.c horAcc8/16/32/64) and floating-point
// (predictor 3, fpAcc) predictors, and BMP's RLE8 and RLE4 run-length
// coding as Pillow's BmpRleDecoder (BmpImagePlugin.py) decodes it, its
// quirks included: a delta reads four bytes and takes the last two, an
// absolute run in RLE4 takes n / 2 bytes, and runs align to even offsets in
// the file. Deflate goes through Python's zlib; the TIFF directory, the
// unpacking of samples into Pillow's modes and BMP's headers are numpy in
// utils/image_containers.py.
//
// Host library with a plain C interface, built with g++ into
// build/libcontainer_decode.so and loaded with ctypes by
// utils/image_containers.py.

#include <cstdint>
#include <cstring>
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

}  // extern "C"
