// Deflate (zlib) and XZ strips decoded on the host as libtiff 4.7's
// ZIPDecode and LZMADecode get them through zlib's inflate and liblzma's
// stream decoder: the whole strip in, at most the strip's size out, the
// call repeated until the output is full, the stream ends or the codec
// reports an error. What matters for a damaged strip is what the codec had
// written when it stopped, and whether libtiff counts the strip as read; an
// undamaged strip reads the same through any inflater, and utils/
// stream_codecs.py reads those through Python's zlib and lzma first.
//
// Inflate mirrors zlib's inflate.c state machine: the zlib header checks,
// stored, fixed and dynamic blocks, inflate_table's rules (an over-subscribed
// set fails, an incomplete one too except a single code of length 1, an
// empty code-length set decodes every symbol as 0 from one bit), its error
// for each bad field, and what it does once the output is full: it goes on
// decoding the next code and fails on a bad one (the Adler-32 at the
// stream's end included), stopping at the first literal or copy it cannot
// write. libtiff fails the strip on any data error, and where the input runs
// out or the stream ends before the strip is full.
//
// XZ mirrors liblzma's stream decoder with no flags: the stream header, block
// headers (CRC32, flags, sizes, LZMA2 alone or after a delta filter, as
// libtiff writes it; other filter chains are not ported and raise), LZMA2's control bytes, dictionary and state resets
// and properties, uncompressed chunks, the LZMA decoder (range decoder
// normalised before each bit, the first byte of each chunk's range coder 0,
// a distance past the dictionary's content fails, a match cut by the
// chunk's end fails, the range decoder must end at 0 with the chunk's
// compressed size used exactly), block padding and the CRC32 or CRC64 check.
// libtiff counts the strip as read once the output is full, whatever the
// decoder reports in that call, and fails it otherwise.
//
// Host library with a plain C interface, built with g++ into
// build/libstream_decode.so and loaded with ctypes by utils/stream_codecs.py.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

// Raised for a stream this decoder does not read (the caller raises, with
// or without a strip to go on from).
struct NotPorted : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// How a decode stopped.
enum Stop { kFull, kExhausted, kError, kEnd };

struct Result {
  Stop stop;
  std::string message;  // the codec's message for kError
};

void set_error(char* err, int64_t cap, const std::string& msg) {
  if (err == nullptr || cap <= 0) return;
  size_t n = std::min(msg.size(), static_cast<size_t>(cap - 1));
  std::memcpy(err, msg.data(), n);
  err[n] = '\0';
}

// ---------------------------------------------------------------------------
// Inflate
// ---------------------------------------------------------------------------

constexpr int kMaxBits = 15;
const uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
                               31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const uint16_t kDistBase[30] = {1,   2,   3,   4,   5,   7,    9,    13,   17,   25,   33,   49,   65,    97,    129,
                                193, 257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
const uint8_t kCodeLengthOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};

// A canonical Huffman code, decoded a bit at a time. `max` is the longest
// code's length; a code read past it matches no symbol.
struct Huffman {
  std::array<uint16_t, kMaxBits + 1> count{};
  std::vector<uint16_t> symbol;
  int max = 0;
};

enum TableType { kCodes, kLens, kDists };

// inflate_table's acceptance of a set of code lengths: false where zlib
// reports it invalid.
bool build_huffman(const uint8_t* lens, int n, TableType type, Huffman* h) {
  h->count.fill(0);
  for (int i = 0; i < n; ++i) h->count[lens[i]]++;
  h->max = 0;
  for (int len = kMaxBits; len >= 1; --len) {
    if (h->count[len]) {
      h->max = len;
      break;
    }
  }
  h->symbol.assign(n, 0);
  if (h->max == 0) return true;  // no symbols: decoding reports the error (or, for kCodes, reads zeros)
  int left = 1;
  for (int len = 1; len <= kMaxBits; ++len) {
    left <<= 1;
    left -= h->count[len];
    if (left < 0) return false;  // over-subscribed
  }
  if (left > 0 && (type == kCodes || h->max != 1)) return false;  // incomplete
  std::array<uint16_t, kMaxBits + 2> offs{};
  for (int len = 1; len < kMaxBits; ++len) offs[len + 1] = offs[len] + h->count[len];
  for (int i = 0; i < n; ++i)
    if (lens[i]) h->symbol[offs[lens[i]]++] = static_cast<uint16_t>(i);
  return true;
}

class Inflater {
 public:
  Inflater(const uint8_t* in, size_t n, uint8_t* out, size_t cap) : in_(in), n_(n), out_(out), cap_(cap) {}

  size_t written() const { return put_; }

  Result run() {
    // The zlib header.
    if (!need(16)) return {kExhausted, ""};
    uint32_t cmf = bits(8), flg = (hold_ >> 8) & 0xFF;
    if (((cmf << 8) + flg) % 31) return {kError, "incorrect header check"};
    if ((cmf & 15) != 8) return {kError, "unknown compression method"};
    if ((cmf >> 4) + 8 > 15) return {kError, "invalid window size"};
    drop(16);
    if (flg & 0x20) {
      if (!need(32)) return {kExhausted, ""};
      return {kError, "need dictionary"};
    }
    bool last = false;
    while (true) {
      if (last) {
        drop(bitcount_ & 7);
        if (!need(32)) return {kExhausted, ""};
        uint32_t check = static_cast<uint32_t>(hold_);
        check = (check >> 24) | ((check >> 8) & 0xFF00) | ((check << 8) & 0xFF0000) | (check << 24);
        drop(32);
        if (check != adler32()) return {kError, "incorrect data check"};
        return {kEnd, ""};
      }
      if (!need(3)) return {kExhausted, ""};
      last = bits(1);
      uint32_t type = (hold_ >> 1) & 3;
      if (type == 3) return {kError, "invalid block type"};
      drop(3);
      Result r{kEnd, ""};
      if (type == 0) {
        r = stored();
      } else {
        if (type == 1) {
          fixed();
        } else {
          r = dynamic();
          if (r.stop != kEnd) return r;
        }
        r = codes();
      }
      if (r.stop != kEnd) return r;
    }
  }

 private:
  bool need(int n) {
    while (bitcount_ < n) {
      if (pos_ >= n_) return false;
      hold_ |= static_cast<uint64_t>(in_[pos_++]) << bitcount_;
      bitcount_ += 8;
    }
    return true;
  }
  uint32_t bits(int n) const { return static_cast<uint32_t>(hold_ & ((uint64_t(1) << n) - 1)); }
  void drop(int n) {
    hold_ >>= n;
    bitcount_ -= n;
  }

  // Decodes one symbol: 0 and the symbol, 1 where the input runs out, 2
  // where the bits match no code.
  int decode(const Huffman& h, int* sym, bool zero_if_empty = false) {
    if (h.max == 0) {
      if (!need(1)) return 1;
      if (zero_if_empty) {  // inflate_table's table for an empty code-length set: symbol 0, one bit
        drop(1);
        *sym = 0;
        return 0;
      }
      return 2;
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= h.max; ++len) {
      if (!need(len)) return 1;
      code |= (hold_ >> (len - 1)) & 1;
      int count = h.count[len];
      if (code - count < first) {
        drop(len);
        *sym = h.symbol[index + (code - first)];
        return 0;
      }
      index += count;
      first += count;
      first <<= 1;
      code <<= 1;
    }
    return 2;
  }

  Result stored() {
    drop(bitcount_ & 7);
    if (!need(32)) return {kExhausted, ""};
    uint32_t len = hold_ & 0xFFFF, nlen = (hold_ >> 16) & 0xFFFF;
    if (len != (nlen ^ 0xFFFF)) return {kError, "invalid stored block lengths"};
    drop(32);  // the bit buffer is empty now: the block's bytes follow
    while (len > 0) {
      if (put_ == cap_) return {kFull, ""};
      if (pos_ >= n_) return {kExhausted, ""};
      size_t copy = std::min<size_t>({len, n_ - pos_, cap_ - put_});
      std::memcpy(out_ + put_, in_ + pos_, copy);
      put_ += copy;
      pos_ += copy;
      len -= static_cast<uint32_t>(copy);
    }
    return {kEnd, ""};
  }

  void fixed() {
    uint8_t lens[320];
    int i = 0;
    for (; i < 144; ++i) lens[i] = 8;
    for (; i < 256; ++i) lens[i] = 9;
    for (; i < 280; ++i) lens[i] = 7;
    for (; i < 288; ++i) lens[i] = 8;
    build_huffman(lens, 288, kLens, &lit_);
    for (i = 0; i < 32; ++i) lens[i] = 5;
    build_huffman(lens, 32, kDists, &dist_);
  }

  Result dynamic() {
    if (!need(14)) return {kExhausted, ""};
    int nlen = bits(5) + 257, ndist = ((hold_ >> 5) & 31) + 1, ncode = ((hold_ >> 10) & 15) + 4;
    drop(14);
    if (nlen > 286 || ndist > 30) return {kError, "too many length or distance symbols"};
    uint8_t lens[320] = {0};
    for (int i = 0; i < ncode; ++i) {
      if (!need(3)) return {kExhausted, ""};
      lens[kCodeLengthOrder[i]] = bits(3);
      drop(3);
    }
    Huffman codes;
    if (!build_huffman(lens, 19, kCodes, &codes)) return {kError, "invalid code lengths set"};
    int have = 0;
    std::memset(lens, 0, sizeof(lens));
    while (have < nlen + ndist) {
      int sym = 0, st = decode(codes, &sym, true);
      if (st == 1) return {kExhausted, ""};
      if (sym < 16) {
        lens[have++] = static_cast<uint8_t>(sym);
        continue;
      }
      int len = 0, copy = 0;
      if (sym == 16) {
        if (!need(2)) return {kExhausted, ""};
        if (have == 0) return {kError, "invalid bit length repeat"};
        len = lens[have - 1];
        copy = 3 + bits(2);
        drop(2);
      } else if (sym == 17) {
        if (!need(3)) return {kExhausted, ""};
        copy = 3 + bits(3);
        drop(3);
      } else {
        if (!need(7)) return {kExhausted, ""};
        copy = 11 + bits(7);
        drop(7);
      }
      if (have + copy > nlen + ndist) return {kError, "invalid bit length repeat"};
      while (copy--) lens[have++] = static_cast<uint8_t>(len);
    }
    if (lens[256] == 0) return {kError, "invalid code -- missing end-of-block"};
    if (!build_huffman(lens, nlen, kLens, &lit_)) return {kError, "invalid literal/lengths set"};
    if (!build_huffman(lens + nlen, ndist, kDists, &dist_)) return {kError, "invalid distances set"};
    return {kEnd, ""};
  }

  // One block's codes, to its end-of-block code.
  Result codes() {
    while (true) {
      int sym = 0, st = decode(lit_, &sym);
      if (st == 1) return {kExhausted, ""};
      if (st == 2 || sym > 285) return {kError, "invalid literal/length code"};
      if (sym < 256) {
        if (put_ == cap_) return {kFull, ""};
        out_[put_++] = static_cast<uint8_t>(sym);
        continue;
      }
      if (sym == 256) return {kEnd, ""};
      sym -= 257;
      if (!need(kLenExtra[sym])) return {kExhausted, ""};
      size_t len = kLenBase[sym] + bits(kLenExtra[sym]);
      drop(kLenExtra[sym]);
      int dsym = 0;
      st = decode(dist_, &dsym);
      if (st == 1) return {kExhausted, ""};
      if (st == 2 || dsym > 29) return {kError, "invalid distance code"};
      if (!need(kDistExtra[dsym])) return {kExhausted, ""};
      size_t dist = kDistBase[dsym] + bits(kDistExtra[dsym]);
      drop(kDistExtra[dsym]);
      if (put_ == cap_) return {kFull, ""};
      if (dist > put_) return {kError, "invalid distance too far back"};
      size_t copy = std::min(len, cap_ - put_);
      for (size_t i = 0; i < copy; ++i, ++put_) out_[put_] = out_[put_ - dist];
      if (copy < len) return {kFull, ""};
    }
  }

  uint32_t adler32() const {
    uint32_t a = 1, b = 0;
    for (size_t i = 0; i < put_;) {
      size_t end = std::min(put_, i + 5552);
      for (; i < end; ++i) {
        a += out_[i];
        b += a;
      }
      a %= 65521;
      b %= 65521;
    }
    return (b << 16) | a;
  }

  const uint8_t* in_;
  size_t n_, pos_ = 0;
  uint8_t* out_;
  size_t cap_, put_ = 0;
  uint64_t hold_ = 0;
  int bitcount_ = 0;
  Huffman lit_, dist_;
};

// ---------------------------------------------------------------------------
// XZ: stream, blocks, LZMA2, LZMA
// ---------------------------------------------------------------------------

uint32_t crc32(const uint8_t* p, size_t n) {
  static uint32_t table[256];
  static bool ready = [] {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    return true;
  }();
  (void)ready;
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

uint64_t crc64(const uint8_t* p, size_t n) {
  static uint64_t table[256];
  static bool ready = [] {
    for (uint64_t i = 0; i < 256; ++i) {
      uint64_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xC96C5795D7870F42ull ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    return true;
  }();
  (void)ready;
  uint64_t c = ~uint64_t(0);
  for (size_t i = 0; i < n; ++i) c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return ~c;
}

uint32_t le32(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24); }

constexpr uint64_t kUnknown = ~uint64_t(0);
constexpr uint32_t kTop = 1u << 24;
constexpr int kLiteralSize = 0x300;

class XzDecoder {
 public:
  XzDecoder(const uint8_t* in, size_t n, uint8_t* out, size_t cap)
      : in_(in), n_(n), out_(out), cap_(cap), buf_(cap) {}

  size_t written() const { return put_; }

  // The stream decoded, each block's bytes put through its delta filter as
  // far as they go.
  Result run() {
    Result r = stream();
    filter();
    return r;
  }

 private:
  Result stream() {
    static const uint8_t kMagic[6] = {0xFD, '7', 'z', 'X', 'Z', 0x00};
    if (n_ < 12) return {kExhausted, ""};
    if (std::memcmp(in_, kMagic, 6) != 0) return {kError, "file format not recognized"};
    if (crc32(in_ + 6, 2) != le32(in_ + 8)) return {kError, "compressed data is corrupt"};
    if (in_[6] != 0 || (in_[7] & 0xF0)) return {kError, "unsupported options"};
    check_id_ = in_[7] & 0x0F;
    pos_ = 12;
    while (true) {
      if (put_ == cap_) return {kFull, ""};
      if (pos_ >= n_) return {kExhausted, ""};
      // Past the last block the index follows; the strip is not full.
      if (in_[pos_] == 0) return {kEnd, ""};
      Result r = block();
      if (r.stop != kEnd) return r;
    }
  }

  // liblzma's delta decoder over the bytes LZMA2 has written since the last
  // call: each byte plus the one `delta_` bytes before it in the block (0
  // before the block's start).
  void filter() {
    for (; filtered_ < put_; ++filtered_) {
      uint8_t prev = delta_ && filtered_ >= block_start_ + delta_ ? out_[filtered_ - delta_] : 0;
      out_[filtered_] = static_cast<uint8_t>(buf_[filtered_] + prev);
    }
  }
  // A VLI within [*p, end): false where liblzma's lzma_vli_decode fails.
  static bool vli(const uint8_t* end, const uint8_t** p, uint64_t* v) {
    *v = 0;
    for (int i = 0; i < 9; ++i) {
      if (*p >= end) return false;
      uint8_t b = *(*p)++;
      *v |= uint64_t(b & 0x7F) << (7 * i);
      if (!(b & 0x80)) return !(b == 0 && i > 0);
    }
    return false;
  }

  Result block() {
    size_t hsize = (size_t(in_[pos_]) + 1) * 4;
    if (n_ - pos_ < hsize) return {kExhausted, ""};
    const uint8_t* h = in_ + pos_;
    if (crc32(h, hsize - 4) != le32(h + hsize - 4)) return {kError, "compressed data is corrupt"};
    uint8_t flags = h[1];
    if (flags & 0x3C) return {kError, "unsupported options"};
    const uint8_t *p = h + 2, *end = h + hsize - 4;
    uint64_t csize = kUnknown, usize = kUnknown;
    if (flags & 0x40) {
      if (!vli(end, &p, &csize) || csize == 0) return {kError, "compressed data is corrupt"};
    }
    if ((flags & 0x80) && !vli(end, &p, &usize)) return {kError, "compressed data is corrupt"};
    int filters = (flags & 3) + 1;
    uint64_t ids[4] = {0};
    uint8_t dict_byte = 0;
    size_t delta = 0;
    for (int i = 0; i < filters; ++i) {
      uint64_t props = 0;
      if (!vli(end, &p, &ids[i]) || !vli(end, &p, &props) || props > uint64_t(end - p))
        return {kError, "compressed data is corrupt"};
      if (ids[i] == 0x21) {
        if (props != 1 || (p[0] & 0xC0) || p[0] > 40) return {kError, "unsupported options"};
        dict_byte = p[0];
      } else if (ids[i] == 0x03) {
        if (props != 1) return {kError, "unsupported options"};
        delta = size_t(p[0]) + 1;
      }
      p += props;
    }
    while (p < end)
      if (*p++ != 0) return {kError, "unsupported options"};
    if (ids[filters - 1] != 0x21) return {kError, "unsupported options"};
    if (filters > 2 || (filters == 2 && ids[0] != 0x03))
      throw NotPorted("an XZ filter chain other than LZMA2 alone or after delta");
    delta_ = filters == 2 ? delta : 0;
    block_start_ = put_;
    pos_ += hsize;
    uint32_t dict = dict_byte == 40 ? 0xFFFFFFFFu : (2u | (dict_byte & 1)) << (dict_byte / 2 + 11);
    dict_cap_ = (std::max<uint64_t>(dict, 4096) + 15) & ~uint64_t(15);
    size_t data_start = pos_, out_start = put_;
    in_limit_ = csize == kUnknown || csize > n_ - pos_ ? n_ : pos_ + csize;
    out_limit_ = usize == kUnknown || usize > cap_ - put_ ? cap_ : put_ + usize;
    Result r = lzma2();
    if (r.stop != kEnd) return r;
    filter();  // the check covers the filtered bytes
    uint64_t used_in = pos_ - data_start, used_out = put_ - out_start;
    if ((csize != kUnknown && csize != used_in) || (usize != kUnknown && usize != used_out))
      return {kError, "compressed data is corrupt"};
    for (; used_in & 3; ++used_in) {
      if (pos_ >= n_) return {kExhausted, ""};
      if (in_[pos_++] != 0) return {kError, "compressed data is corrupt"};
    }
    static const int kCheckSize[16] = {0, 4, 4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 32, 64, 64, 64};
    size_t check = kCheckSize[check_id_];
    if (n_ - pos_ < check) return {kExhausted, ""};
    if (check_id_ == 1 && crc32(out_ + out_start, used_out) != le32(in_ + pos_))
      return {kError, "compressed data is corrupt"};
    if (check_id_ == 4) {
      uint64_t want = uint64_t(le32(in_ + pos_)) | (uint64_t(le32(in_ + pos_ + 4)) << 32);
      if (crc64(out_ + out_start, used_out) != want) return {kError, "compressed data is corrupt"};
    }
    if (check_id_ == 10) throw NotPorted("an XZ block's SHA-256 check");
    pos_ += check;
    return {kEnd, ""};
  }

  // A block's LZMA2 chunks, to the end marker.
  Result lzma2() {
    bool need_dict_reset = true, need_props = true;
    while (true) {
      if (put_ == cap_) return {kFull, ""};
      if (pos_ >= in_limit_) return {kExhausted, ""};
      uint32_t control = in_[pos_++];
      if (control == 0) return {kEnd, ""};
      if (control >= 0xE0 || control == 1) {
        need_props = true;
        need_dict_reset = true;
      } else if (need_dict_reset) {
        return {kError, "compressed data is corrupt"};
      }
      bool props = false, state_reset = false;
      if (control >= 0x80) {
        if (control >= 0xC0) {
          need_props = false;
          props = true;
        } else if (need_props) {
          return {kError, "compressed data is corrupt"};
        } else {
          state_reset = control >= 0xA0;
        }
      } else if (control > 2) {
        return {kError, "compressed data is corrupt"};
      }
      if (need_dict_reset) {
        need_dict_reset = false;
        dict_start_ = put_;
      }
      if (control >= 0x80) {
        if (in_limit_ - pos_ < 4) return {kExhausted, ""};
        size_t usize = (size_t(control & 0x1F) << 16) + (size_t(in_[pos_]) << 8) + in_[pos_ + 1] + 1;
        size_t csize = (size_t(in_[pos_ + 2]) << 8) + in_[pos_ + 3] + 1;
        pos_ += 4;
        if (props) {
          if (pos_ >= in_limit_) return {kExhausted, ""};
          uint32_t b = in_[pos_++];
          if (b > (4 * 5 + 4) * 9 + 8) return {kError, "compressed data is corrupt"};
          lc_ = b % 9;
          b /= 9;
          lp_ = b % 5;
          pb_ = b / 5;
          if (lc_ + lp_ > 4) return {kError, "compressed data is corrupt"};
          state_reset = true;
        }
        if (state_reset) reset_state();
        Result r = lzma_chunk(usize, csize);
        if (r.stop != kEnd) return r;
      } else {
        if (in_limit_ - pos_ < 2) return {kExhausted, ""};
        size_t size = (size_t(in_[pos_]) << 8) + in_[pos_ + 1] + 1;
        pos_ += 2;
        while (size > 0) {
          if (put_ == out_limit_) return out_full();
          if (pos_ >= in_limit_) return {kExhausted, ""};
          size_t copy = std::min({size, in_limit_ - pos_, out_limit_ - put_});
          std::memcpy(buf_.data() + put_, in_ + pos_, copy);
          put_ += copy;
          pos_ += copy;
          size -= copy;
        }
      }
    }
  }

  // The output limit reached: the strip is full, or a block header's
  // uncompressed size is used up before the block ends.
  Result out_full() const {
    if (put_ == cap_) return {kFull, ""};
    return {kError, "compressed data is corrupt"};
  }

  // Every probability to one half.
  template <class T>
  static void half(T& probs) {
    uint16_t* p = reinterpret_cast<uint16_t*>(&probs);
    std::fill(p, p + sizeof(T) / sizeof(uint16_t), 1024);
  }

  void reset_state() {
    state_ = 0;
    reps_[0] = reps_[1] = reps_[2] = reps_[3] = 0;
    half(is_match_);
    half(is_rep_);
    half(is_rep0_);
    half(is_rep1_);
    half(is_rep2_);
    half(is_rep0_long_);
    half(slot_);
    half(special_);
    half(align_);
    half(len_);
    half(rep_len_);
    literal_.assign(size_t(kLiteralSize) << (lc_ + lp_), 1024);
  }

  // The range decoder: normalised before each bit, as liblzma's rc_bit.
  bool normalize() {
    if (range_ < kTop) {
      if (pos_ >= in_limit_) return false;
      range_ <<= 8;
      code_ = (code_ << 8) | in_[pos_++];
    }
    return true;
  }
  bool bit(uint16_t* p, uint32_t* b) {
    if (!normalize()) return false;
    uint32_t bound = (range_ >> 11) * *p;
    if (code_ < bound) {
      range_ = bound;
      *p += (2048 - *p) >> 5;
      *b = 0;
    } else {
      range_ -= bound;
      code_ -= bound;
      *p -= *p >> 5;
      *b = 1;
    }
    return true;
  }
  bool tree(uint16_t* probs, int nbits, uint32_t* sym) {
    uint32_t m = 1, b = 0;
    for (int i = 0; i < nbits; ++i) {
      if (!bit(&probs[m], &b)) return false;
      m = (m << 1) | b;
    }
    *sym = m - (1u << nbits);
    return true;
  }
  bool reverse_tree(uint16_t* probs, int nbits, uint32_t* sym) {
    uint32_t m = 1, b = 0, s = 0;
    for (int i = 0; i < nbits; ++i) {
      if (!bit(&probs[m], &b)) return false;
      m = (m << 1) | b;
      s |= b << i;
    }
    *sym = s;
    return true;
  }
  bool direct(int nbits, uint32_t* sym) {
    uint32_t s = 0;
    for (int i = 0; i < nbits; ++i) {
      if (!normalize()) return false;
      range_ >>= 1;
      code_ -= range_;
      uint32_t t = 0u - (code_ >> 31);
      code_ += range_ & t;
      s = (s << 1) + (t + 1);
    }
    *sym = s;
    return true;
  }

  struct Len {
    uint16_t choice, choice2, low[16][8], mid[16][8], high[256];
  };
  bool length(Len* l, uint32_t pos_state, uint32_t* len) {
    uint32_t b = 0, s = 0;
    if (!bit(&l->choice, &b)) return false;
    if (!b) {
      if (!tree(l->low[pos_state], 3, &s)) return false;
      *len = s;
      return true;
    }
    if (!bit(&l->choice2, &b)) return false;
    if (!b) {
      if (!tree(l->mid[pos_state], 3, &s)) return false;
      *len = 8 + s;
      return true;
    }
    if (!tree(l->high, 8, &s)) return false;
    *len = 16 + s;
    return true;
  }

  // How much of the dictionary a distance may reach back into.
  uint64_t dict_full() const { return std::min<uint64_t>(put_ - dict_start_, dict_cap_); }

  // One LZMA chunk of `usize` bytes out from `csize` bytes in.
  Result lzma_chunk(size_t usize, size_t csize) {
    size_t chunk_start = pos_, chunk_end = put_ + usize;
    // The range coder's five bytes, the first of them 0.
    range_ = 0xFFFFFFFFu;
    code_ = 0;
    for (int i = 0; i < 5; ++i) {
      if (pos_ >= in_limit_) return {kExhausted, ""};
      if (i == 0 && in_[pos_] != 0) return {kError, "compressed data is corrupt"};
      code_ = (code_ << 8) | in_[pos_++];
    }
    size_t limit = std::min(chunk_end, out_limit_);
    uint32_t pb_mask = (1u << pb_) - 1, lp_mask = (1u << lp_) - 1;
    uint32_t b = 0;
    while (true) {
      if (put_ == limit) {
        if (limit != chunk_end) return out_full();
        if (!normalize()) return {kExhausted, ""};
        if (code_ != 0 || pos_ - chunk_start != csize) return {kError, "compressed data is corrupt"};
        return {kEnd, ""};
      }
      uint32_t at = static_cast<uint32_t>(put_ - dict_start_);
      uint32_t pos_state = at & pb_mask;
      if (!bit(&is_match_[(state_ << 4) + pos_state], &b)) return {kExhausted, ""};
      if (!b) {
        uint32_t prev = put_ > dict_start_ ? buf_[put_ - 1] : 0;
        uint16_t* probs = &literal_[size_t(kLiteralSize) * (((at & lp_mask) << lc_) + (prev >> (8 - lc_)))];
        uint32_t sym = 1;
        if (state_ >= 7) {
          uint32_t match = buf_[put_ - reps_[0] - 1];
          do {
            uint32_t match_bit = (match >> 7) & 1;
            match <<= 1;
            if (!bit(&probs[((1 + match_bit) << 8) + sym], &b)) return {kExhausted, ""};
            sym = (sym << 1) | b;
            if (match_bit != b) break;
          } while (sym < 0x100);
        }
        while (sym < 0x100) {
          if (!bit(&probs[sym], &b)) return {kExhausted, ""};
          sym = (sym << 1) | b;
        }
        buf_[put_++] = static_cast<uint8_t>(sym);
        state_ = state_ < 4 ? 0 : state_ < 10 ? state_ - 3 : state_ - 6;
        continue;
      }
      uint32_t len = 0;
      if (!bit(&is_rep_[state_], &b)) return {kExhausted, ""};
      if (b) {
        if (dict_full() == 0) return {kError, "compressed data is corrupt"};
        if (!bit(&is_rep0_[state_], &b)) return {kExhausted, ""};
        if (!b) {
          if (!bit(&is_rep0_long_[(state_ << 4) + pos_state], &b)) return {kExhausted, ""};
          if (!b) {
            state_ = state_ < 7 ? 9 : 11;
            buf_[put_] = buf_[put_ - reps_[0] - 1];
            ++put_;
            continue;
          }
        } else {
          uint32_t dist;
          if (!bit(&is_rep1_[state_], &b)) return {kExhausted, ""};
          if (!b) {
            dist = reps_[1];
          } else {
            if (!bit(&is_rep2_[state_], &b)) return {kExhausted, ""};
            if (!b) {
              dist = reps_[2];
            } else {
              dist = reps_[3];
              reps_[3] = reps_[2];
            }
            reps_[2] = reps_[1];
          }
          reps_[1] = reps_[0];
          reps_[0] = dist;
        }
        if (!length(&rep_len_, pos_state, &len)) return {kExhausted, ""};
        state_ = state_ < 7 ? 8 : 11;
      } else {
        reps_[3] = reps_[2];
        reps_[2] = reps_[1];
        reps_[1] = reps_[0];
        if (!length(&len_, pos_state, &len)) return {kExhausted, ""};
        state_ = state_ < 7 ? 7 : 10;
        uint32_t slot = 0;
        if (!tree(slot_[std::min<uint32_t>(len, 3)], 6, &slot)) return {kExhausted, ""};
        uint32_t dist = slot;
        if (slot >= 4) {
          int nbits = static_cast<int>(slot >> 1) - 1;
          dist = (2u | (slot & 1)) << nbits;
          uint32_t extra = 0;
          if (slot < 14) {
            if (!reverse_tree(&special_[dist - slot], nbits, &extra)) return {kExhausted, ""};
            dist += extra;
          } else {
            if (!direct(nbits - 4, &extra)) return {kExhausted, ""};
            dist += extra << 4;
            if (!reverse_tree(align_, 4, &extra)) return {kExhausted, ""};
            dist += extra;
          }
        }
        reps_[0] = dist;
        if (uint64_t(dist) >= dict_full()) return {kError, "compressed data is corrupt"};
      }
      len += 2;
      size_t copy = std::min<size_t>(len, limit - put_);
      for (size_t i = 0; i < copy; ++i, ++put_) buf_[put_] = buf_[put_ - reps_[0] - 1];
      if (copy < len) {
        if (limit != chunk_end) return out_full();
        return {kError, "compressed data is corrupt"};  // a match past the chunk's end
      }
    }
  }

  const uint8_t* in_;
  size_t n_, pos_ = 0, in_limit_ = 0;
  uint8_t* out_;
  size_t cap_, put_ = 0, out_limit_ = 0, dict_start_ = 0, filtered_ = 0, block_start_ = 0, delta_ = 0;
  std::vector<uint8_t> buf_;  // LZMA2's output, before the delta filter
  uint64_t dict_cap_ = 0;
  int check_id_ = 0;
  uint32_t lc_ = 0, lp_ = 0, pb_ = 0, state_ = 0, reps_[4] = {0, 0, 0, 0};
  uint32_t range_ = 0, code_ = 0;
  uint16_t is_match_[12 << 4], is_rep_[12], is_rep0_[12], is_rep1_[12], is_rep2_[12], is_rep0_long_[12 << 4];
  uint16_t slot_[4][64], special_[115], align_[16];
  std::vector<uint16_t> literal_;
  Len len_{}, rep_len_{};
};

// The libtiff outcome of a stop: an empty message where the strip is read.
std::string tiff_outcome(const Result& r, size_t written, size_t cap, const char* codec) {
  if (written == cap && (r.stop != kError || std::strcmp(codec, "xz") == 0)) return "";
  if (r.stop == kError) return r.message;
  return "not enough data (short " + std::to_string(cap - written) + " bytes)";
}

template <class Decoder>
int64_t decode(const char* codec, const uint8_t* in, int64_t n, uint8_t* out, int64_t cap, char* err,
               int64_t err_cap) {
  try {
    Decoder d(in, static_cast<size_t>(n), out, static_cast<size_t>(cap));
    Result r = d.run();
    set_error(err, err_cap, tiff_outcome(r, d.written(), static_cast<size_t>(cap), codec));
    return static_cast<int64_t>(d.written());
  } catch (const std::exception& e) {
    set_error(err, err_cap, e.what());
    return -2;
  }
}

}  // namespace

extern "C" {

// Inflates the zlib stream `in` into `out` (at most `cap` bytes) as
// libtiff's ZIPDecode does. Returns the bytes written; `err` is empty where
// libtiff counts the strip as read and holds zlib's message (or "not enough
// data") where it fails it.
int64_t inflate_strip(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap, char* err, int64_t err_cap) {
  return decode<Inflater>("zlib", in, n, out, cap, err, err_cap);
}

// Decodes the .xz stream `in` into `out` as libtiff's LZMADecode does, with
// the same return and `err` as inflate_strip; -2, with the reason in `err`,
// for a stream this decoder does not read.
int64_t xz_strip(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap, char* err, int64_t err_cap) {
  return decode<XzDecoder>("xz", in, n, out, cap, err, err_cap);
}

}  // extern "C"
