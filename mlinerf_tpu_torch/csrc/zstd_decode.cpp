// Zstandard (RFC 8878) decoding on the host, as libtiff 4.7's tif_zstd.c
// ZSTDDecode reads a strip through libzstd 1.5's ZSTD_decompressStream: the
// strip's bytes in, at most the strip's size out, one call after another
// until the frame ends, the input runs out or the output is full.
//
// Covered: frame headers (window descriptor, frame content size absent or
// in 1, 2, 4 or 8 bytes, single segment, dictionary ID present but 0),
// skippable frames, raw, RLE and compressed blocks, literals raw, RLE,
// Huffman-compressed or treeless in 1 or 4 streams with weights sent
// directly or FSE-compressed, sequences with predefined, RLE, FSE-compressed
// or repeated tables, the three repeat offsets, and the XXH64 content
// checksum. libzstd's behaviour around the output's end is mirrored: a frame
// with its content size known, whole in the input and no larger than the
// space left is decoded in one pass (any error in it fails), any other
// block by block, each block decoded whole before its bytes are flushed
// (a raw block the input cuts short copied as far as it goes), the stream
// stopping where the output fills with a block left unflushed and going on
// to the next unit where it fills exactly. ZSTD_decompressStream
// returns at the end of a frame, and libtiff then stops: a strip whose
// first frame ends before the strip is full (a skippable frame first, or
// several frames) is short. A corrupt frame fails where libzstd does: bad
// headers and block types, bitstreams not consumed exactly, weights or
// distributions that do not sum, an offset before the frame's start, a
// repeat table before any table, literals or a block over its maximum,
// a content size or checksum that does not match.
//
// Each call counts which of these paths it reached (zstd_paths), so that
// a test can show what a corpus covers.
//
// Host library with a plain C interface, built with g++ into
// build/libzstd_decode.so and loaded with ctypes by utils/zstd.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// The paths zstd_decode counts, in the order zstd_paths lists them.
enum Path {
  kFrameContentSize, kFrameNoContentSize, kSingleSegment, kWindowDescriptor, kChecksum, kSkippable,
  kOnePass, kStreaming, kBlockRaw, kBlockRle, kBlockCompressed, kLitRaw, kLitRle, kLitHuffman1, kLitHuffman4,
  kLitTreeless, kWeightsDirect, kWeightsFse, kSeqNone, kSeqPredefined, kSeqRle, kSeqFse, kSeqRepeat,
  kRepeatOffset, kLitHuffmanFast, kNumPaths
};
const char* const kPathNames =
    "frame_content_size,frame_no_content_size,single_segment,window_descriptor,checksum,skippable,one_pass,"
    "streaming,block_raw,block_rle,block_compressed,literals_raw,literals_rle,literals_huffman_1_stream,"
    "literals_huffman_4_streams,literals_treeless,weights_direct,weights_fse,sequences_none,"
    "sequences_predefined,sequences_rle,sequences_fse,sequences_repeat,repeat_offset,literals_huffman_fast";

constexpr size_t kBlockSizeMax = 128 * 1024;
constexpr uint64_t kMaxStreamingWindow = (uint64_t(1) << 27) + 1;  // ZSTD_d_windowLogMax's default
constexpr int kHufTableLogMax = 12;

inline uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }
inline uint32_t le32(const uint8_t* p) { return le24(p) | (static_cast<uint32_t>(p[3]) << 24); }
inline uint64_t le64(const uint8_t* p) { return le32(p) | (static_cast<uint64_t>(le32(p + 4)) << 32); }
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ---------------------------------------------------------------------------
// XXH64
// ---------------------------------------------------------------------------

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL, P3 = 1609587929392839161ULL,
                   P4 = 9650029242287828579ULL, P5 = 2870177450012600261ULL;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xxh_round(uint64_t acc, uint64_t v) { return rotl(acc + v * P2, 31) * P1; }
inline uint64_t xxh_merge(uint64_t acc, uint64_t v) { return (acc ^ xxh_round(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t len) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xxh_round(v1, le64(p));
      v2 = xxh_round(v2, le64(p + 8));
      v3 = xxh_round(v3, le64(p + 16));
      v4 = xxh_round(v4, le64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxh_merge(xxh_merge(xxh_merge(xxh_merge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += len;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xxh_round(0, le64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (static_cast<uint64_t>(le32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------------------
// Bitstreams
// ---------------------------------------------------------------------------

// libzstd's BIT_DStream_t: a stream read backward from its last byte's
// highest set bit, 64 bits held at a time.
struct BackBits {
  enum Status { kUnfinished = 0, kEndOfBuffer = 1, kCompleted = 2, kOverflow = 3 };
  const uint8_t* start = nullptr;
  const uint8_t* ptr = nullptr;
  uint64_t container = 0;
  unsigned consumed = 0;

  void init(const uint8_t* src, size_t size) {
    if (size < 1) throw Error("empty bitstream");
    start = src;
    const uint8_t last = src[size - 1];
    if (!last) throw Error("corrupt bitstream (no end mark)");
    if (size >= 8) {
      ptr = src + size - 8;
      container = le64(ptr);
      consumed = 8 - highbit(last);
    } else {
      ptr = src;
      container = 0;
      for (size_t i = 0; i < size; ++i) container |= static_cast<uint64_t>(src[i]) << (8 * i);
      consumed = 8 - highbit(last) + static_cast<unsigned>(8 - size) * 8;
    }
  }
  uint64_t look(unsigned n) const {
    return n == 0 ? 0 : ((container << (consumed & 63)) >> 1) >> (63 - n);
  }
  uint64_t read(unsigned n) {
    const uint64_t v = look(n);
    consumed += n;
    return v;
  }
  Status reload() {
    if (consumed > 64) return kOverflow;
    if (ptr >= start + 8) {
      ptr -= consumed >> 3;
      consumed &= 7;
      container = le64(ptr);
      return kUnfinished;
    }
    if (ptr == start) return consumed < 64 ? kEndOfBuffer : kCompleted;
    unsigned nb = consumed >> 3;
    Status result = kUnfinished;
    if (ptr - nb < start) {
      nb = static_cast<unsigned>(ptr - start);
      result = kEndOfBuffer;
    }
    ptr -= nb;
    consumed -= nb * 8;
    container = le64(ptr);
    return result;
  }
  bool ended() const { return ptr == start && consumed == 64; }
};

// FSE_readNCount: a distribution of probabilities (-1 for "less than 1")
// over symbols 0..max_symbol, its accuracy log; returns the bytes read.
size_t read_distribution(const uint8_t* src, size_t size, int max_symbol, int max_log, std::vector<int>* norm,
                         int* table_log) {
  uint8_t buf[8] = {0};
  const uint8_t* in = src;
  size_t avail = size;
  if (size < 8) {  // libzstd decodes a short description from a zero-padded copy
    std::memcpy(buf, src, size);
    in = buf;
    avail = 8;
  }
  uint64_t bitpos = 0;
  auto bits = [&](int n) -> uint32_t {
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) {
      const uint64_t b = bitpos + i;
      if (b / 8 < avail && ((in[b / 8] >> (b % 8)) & 1)) v |= 1u << i;
    }
    return v;
  };
  const int log = static_cast<int>(bits(4)) + 5;
  bitpos += 4;
  if (log > 15) throw Error("FSE table log too large");
  if (log > max_log) throw Error("FSE table log over its maximum");
  norm->assign(max_symbol + 1, 0);
  int remaining = (1 << log) + 1;
  int threshold = 1 << log;
  int nbits = log + 1;
  int symbol = 0;
  bool previous0 = false;
  for (;;) {
    if (previous0) {
      int n0 = symbol;
      for (;;) {
        const uint32_t r = bits(2);
        bitpos += 2;
        n0 += static_cast<int>(r);
        if (r != 3) break;
      }
      if (n0 > max_symbol + 1) throw Error("FSE distribution past its last symbol");
      symbol = n0;
      if (symbol >= max_symbol + 1) break;
    }
    const int max = (2 * threshold - 1) - remaining;
    int count;
    const uint32_t low = bits(nbits - 1);
    if (static_cast<int>(low) < max) {
      count = static_cast<int>(low);
      bitpos += nbits - 1;
    } else {
      count = static_cast<int>(bits(nbits));
      if (count >= threshold) count -= max;
      bitpos += nbits;
    }
    count--;
    remaining -= count < 0 ? -count : count;
    (*norm)[symbol++] = count;
    previous0 = count == 0;
    if (remaining < threshold) {
      if (remaining <= 1) break;
      nbits = highbit(static_cast<uint32_t>(remaining)) + 1;
      threshold = 1 << (nbits - 1);
    }
    if (symbol >= max_symbol + 1) break;
  }
  if (remaining != 1) throw Error("corrupt FSE distribution (its probabilities do not sum)");
  const size_t used = (bitpos + 7) / 8;
  if (used > size) throw Error("FSE distribution past its input");
  *table_log = log;
  return used;
}

// An FSE decoding table: for each state its symbol, the bits to read and
// the base of the next state; plus, for a sequence code, its baseline and
// extra bits.
struct FseEntry {
  uint16_t symbol;
  uint8_t nbits;
  uint16_t base;
};
struct FseTable {
  int log = 0;
  std::vector<FseEntry> e;
};

FseTable build_fse(const std::vector<int>& norm, int log) {
  const int size = 1 << log;
  FseTable t;
  t.log = log;
  t.e.assign(size, FseEntry{0, 0, 0});
  std::vector<int> next(norm.size());
  int high = size - 1;
  for (size_t s = 0; s < norm.size(); ++s) {
    if (norm[s] == -1) {
      t.e[high--].symbol = static_cast<uint16_t>(s);
      next[s] = 1;
    } else {
      next[s] = norm[s];
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (size_t s = 0; s < norm.size(); ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t.e[pos].symbol = static_cast<uint16_t>(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  if (pos != 0) throw Error("corrupt FSE distribution (its cells do not spread)");
  for (int u = 0; u < size; ++u) {
    const int sym = t.e[u].symbol;
    const uint32_t ns = static_cast<uint32_t>(next[sym]++);
    const int nb = log - highbit(ns);
    t.e[u].nbits = static_cast<uint8_t>(nb);
    t.e[u].base = static_cast<uint16_t>((ns << nb) - size);
  }
  return t;
}

// ---------------------------------------------------------------------------
// Huffman literals
// ---------------------------------------------------------------------------

struct HufTable {
  int log = 0;
  std::vector<uint8_t> symbol, nbits;
};

// HUF_readStats and the table it implies; returns the bytes read.
size_t read_huffman(const uint8_t* src, size_t size, HufTable* t, int64_t* counters) {
  if (size < 1) throw Error("truncated Huffman tree description");
  uint8_t weights[256] = {0};
  size_t n = 0, used;
  const int header = src[0];
  if (header >= 128) {
    ++counters[kWeightsDirect];
    n = header - 127;
    const size_t bytes = (n + 1) / 2;
    if (bytes + 1 > size) throw Error("truncated Huffman weights");
    for (size_t i = 0; i < n; i += 2) {
      weights[i] = src[1 + i / 2] >> 4;
      weights[i + 1] = src[1 + i / 2] & 15;
    }
    used = bytes + 1;
  } else {
    ++counters[kWeightsFse];
    const size_t csize = header;
    if (csize + 1 > size) throw Error("truncated Huffman weights");
    std::vector<int> norm;
    int log;
    const size_t head = read_distribution(src + 1, csize, 255, 6, &norm, &log);
    const FseTable ft = build_fse(norm, log);
    BackBits b;
    b.init(src + 1 + head, csize - head);
    uint32_t s1 = static_cast<uint32_t>(b.read(log));
    b.reload();
    uint32_t s2 = static_cast<uint32_t>(b.read(log));
    b.reload();
    auto symbol = [&](uint32_t& st) {
      const FseEntry& e = ft.e[st];
      st = e.base + static_cast<uint32_t>(b.read(e.nbits));
      return static_cast<uint8_t>(e.symbol);
    };
    const size_t omax = 255;
    // FSE_decompress_usingDTable_generic: four at a time while the stream
    // is far from its start, then one by one until a state's read overflows.
    while (b.reload() == BackBits::kUnfinished && n < omax - 3) {
      weights[n++] = symbol(s1);
      weights[n++] = symbol(s2);
      weights[n++] = symbol(s1);
      weights[n++] = symbol(s2);
    }
    for (;;) {
      if (n > omax - 2) throw Error("too many Huffman weights");
      weights[n++] = symbol(s1);
      if (b.reload() == BackBits::kOverflow) {
        weights[n++] = symbol(s2);
        break;
      }
      if (n > omax - 2) throw Error("too many Huffman weights");
      weights[n++] = symbol(s2);
      if (b.reload() == BackBits::kOverflow) {
        weights[n++] = symbol(s1);
        break;
      }
    }
    used = csize + 1;
  }
  int rank[kHufTableLogMax + 2] = {0};
  uint32_t total = 0;
  for (size_t i = 0; i < n; ++i) {
    if (weights[i] > kHufTableLogMax) throw Error("corrupt Huffman weight");
    rank[weights[i]]++;
    total += (1u << weights[i]) >> 1;
  }
  if (total == 0) throw Error("corrupt Huffman weights (all zero)");
  const int log = highbit(total) + 1;
  if (log > kHufTableLogMax) throw Error("Huffman table log too large");
  const uint32_t rest = (1u << log) - total;
  if ((1u << highbit(rest)) != rest) throw Error("corrupt Huffman weights (the last is not a power of 2)");
  weights[n] = static_cast<uint8_t>(highbit(rest) + 1);
  rank[weights[n]]++;
  ++n;
  if (rank[1] < 2 || (rank[1] & 1)) throw Error("corrupt Huffman weights (an odd count of the longest codes)");
  t->log = log;
  t->symbol.assign(size_t(1) << log, 0);
  t->nbits.assign(size_t(1) << log, 0);
  uint32_t pos = 0;
  for (int w = 1; w <= log; ++w)
    for (size_t s = 0; s < n; ++s)
      if (weights[s] == w) {
        const uint32_t len = 1u << (w - 1);
        for (uint32_t i = 0; i < len; ++i) {
          t->symbol[pos + i] = static_cast<uint8_t>(s);
          t->nbits[pos + i] = static_cast<uint8_t>(log + 1 - w);
        }
        pos += len;
      }
  return used;
}

void huffman_stream(const HufTable& t, const uint8_t* src, size_t size, uint8_t* out, size_t count) {
  BackBits b;
  b.init(src, size);
  for (size_t i = 0; i < count; ++i) {
    if (b.consumed <= 64) b.reload();
    const uint32_t v = static_cast<uint32_t>(b.look(t.log));
    out[i] = t.symbol[v];
    b.consumed += t.nbits[v];
  }
  if (b.consumed <= 64) b.reload();
  if (!b.ended()) throw Error("corrupt Huffman stream (not consumed exactly)");
}

// HUF_decodeStreamX1 with the bit stream as libzstd leaves it: four
// symbols after each reload that leaves it unfinished, then the rest with
// no reload, the table indexed by its top `log` bits of 11.
void huffman_finish(const HufTable& t, BackBits& b, uint8_t* p, uint8_t* end) {
  auto symbol = [&]() {
    const uint32_t v = static_cast<uint32_t>(b.look(11)) >> (11 - t.log);
    b.consumed += t.nbits[v];
    return t.symbol[v];
  };
  if (end - p > 3) {
    for (;;) {
      const bool unfinished = b.reload() == BackBits::kUnfinished;
      if (!(unfinished && p < end - 3)) break;
      for (int k = 0; k < 4; ++k) *p++ = symbol();
    }
  } else {
    b.reload();
  }
  while (p < end) *p++ = symbol();
}

// libzstd 1.5's fast path for four Huffman streams
// (HUF_decompress4X1_usingDTable_internal_fast with its C loop, which the
// assembly loop matches), taken where each stream holds at least 8 bytes
// and the table log is at most 11 (libzstd's single-symbol table is
// rescaled to 11): five symbols per stream per round from 64-bit
// containers read backward, marked by a low 1 bit, as long as stream 0's
// bytes allow and no stream's position passes the one before it; then
// each stream finished by HUF_decodeStreamX1 reading down to the jump
// table. The streams' ends are not checked, only that none read more
// than 8 bytes into the stream before it. Returns false where libzstd
// takes the slow path.
bool huffman_fast4(const HufTable& t, const uint8_t* src, size_t size, uint8_t* dst, size_t count) {
  if (t.log > 11 || count == 0) return false;
  const size_t l1 = le16(src), l2 = le16(src + 2), l3 = le16(src + 4);
  const size_t l4 = size - (l1 + l2 + l3 + 6);
  const uint8_t* iend[4] = {src + 6, src + 6 + l1, src + 6 + l1 + l2, src + 6 + l1 + l2 + l3};
  if (l1 < 8 || l2 < 8 || l3 < 8 || l4 < 8) return false;
  const size_t seg = (count + 3) / 4;
  uint8_t* const oend = dst + count;
  uint8_t* op[4] = {dst, dst + seg, dst + 2 * seg, dst + 3 * seg};
  if (op[3] >= oend) return false;
  const uint8_t* ip[4] = {iend[1] - 8, iend[2] - 8, iend[3] - 8, src + size - 8};
  uint64_t bits[4];
  for (int s = 0; s < 4; ++s) {
    const uint8_t last = ip[s][7];
    bits[s] = (le64(ip[s]) | 1) << (last ? 8 - highbit(last) : 0);
  }
  const uint8_t* const ilowest = src;
  for (;;) {
    const size_t oiters = static_cast<size_t>(oend - op[3]) / 5;
    const size_t iiters = static_cast<size_t>(ip[0] - ilowest) / 7;
    uint8_t* const olimit = op[3] + std::min(oiters, iiters) * 5;
    if (op[3] == olimit) break;
    bool crossed = false;
    for (int s = 1; s < 4; ++s) crossed = crossed || ip[s] < ip[s - 1];
    if (crossed) break;
    do {
      for (int k = 0; k < 5; ++k)
        for (int s = 0; s < 4; ++s) {
          const uint32_t v = static_cast<uint32_t>(bits[s] >> 53) >> (11 - t.log);
          bits[s] <<= t.nbits[v];
          op[s][k] = t.symbol[v];
        }
      for (int s = 0; s < 4; ++s) {
        const int ctz = __builtin_ctzll(bits[s]);
        op[s] += 5;
        ip[s] -= ctz >> 3;
        bits[s] = (le64(ip[s]) | 1) << (ctz & 7);
      }
    } while (op[3] < olimit);
  }
  uint8_t* seg_end = dst;
  for (int s = 0; s < 4; ++s) {
    seg_end = static_cast<size_t>(oend - seg_end) >= seg ? seg_end + seg : oend;
    if (op[s] > seg_end || ip[s] < iend[s] - 8) throw Error("corrupt Huffman stream (read past its start)");
    BackBits b;
    b.start = ilowest;
    b.ptr = ip[s];
    b.container = le64(ip[s]);
    b.consumed = static_cast<unsigned>(__builtin_ctzll(bits[s]));
    huffman_finish(t, b, op[s], seg_end);
  }
  return true;
}

// ---------------------------------------------------------------------------
// Sequences
// ---------------------------------------------------------------------------

const int kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1,
                            1, 1, 1, 1, -1, -1, -1, -1};
const int kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {0,  1,  2,  3,  4,  5,  6,  7,  8,   9,   10,  11,   12,   13,   14,   15,    16,    18,
                              20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,  16,   17,   18,   19,    20,
                              21, 22, 23, 24, 25, 26, 27, 28, 29, 30,  31,  32,  33,  34,   35,   37,   39,    41,
                              43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct SeqTable {
  FseTable fse;
  bool set = false;
};

// ZSTD_buildSeqTable for one of the three codes; returns the bytes read.
size_t read_seq_table(int mode, const uint8_t* src, size_t size, int max_symbol, int max_log, const int* defaults,
                      int default_count, int default_log, SeqTable* t, bool repeat_ok, int64_t* counters) {
  switch (mode) {
    case 0: {
      ++counters[kSeqPredefined];
      t->fse = build_fse(std::vector<int>(defaults, defaults + default_count), default_log);
      t->set = true;
      return 0;
    }
    case 1: {
      ++counters[kSeqRle];
      if (size < 1) throw Error("truncated RLE sequence table");
      if (src[0] > max_symbol) throw Error("RLE sequence code past its maximum");
      t->fse.log = 0;
      t->fse.e.assign(1, FseEntry{src[0], 0, 0});
      t->set = true;
      return 1;
    }
    case 2: {
      ++counters[kSeqFse];
      std::vector<int> norm;
      int log;
      const size_t used = read_distribution(src, size, max_symbol, max_log, &norm, &log);
      t->fse = build_fse(norm, log);
      t->set = true;
      return used;
    }
    default:
      ++counters[kSeqRepeat];
      if (!repeat_ok || !t->set) throw Error("repeat sequence table with no table before it");
      return 0;
  }
}

// The decoding state of a frame: its output, the tables and offsets that
// carry from block to block.
struct Frame {
  std::vector<uint8_t> out;
  HufTable huf;
  bool huf_set = false;
  SeqTable ll, of, ml;
  bool tables_set = false;
  uint64_t rep[3] = {1, 4, 8};
  size_t block_max = kBlockSizeMax;
};

void decode_compressed_block(Frame& f, const uint8_t* src, size_t size, int64_t* counters) {
  if (size > f.block_max) throw Error("compressed block over the block maximum");
  if (size < 2) throw Error("compressed block too small");
  // Literals section.
  std::vector<uint8_t> lit;
  const int type = src[0] & 3, sf = (src[0] >> 2) & 3;
  size_t pos;
  if (type == 0 || type == 1) {
    size_t lh, count;
    if (sf == 1) {
      lh = 2;
      if (type == 1 && size < 3) throw Error("truncated literals header");
      count = le16(src) >> 4;
    } else if (sf == 3) {
      lh = 3;
      if (size < (type == 1 ? 4u : 3u)) throw Error("truncated literals header");
      count = le24(src) >> 4;
    } else {
      lh = 1;
      count = src[0] >> 3;
    }
    if (count > f.block_max) throw Error("literals over the block maximum");
    if (type == 0) {
      ++counters[kLitRaw];
      if (lh + count > size) throw Error("raw literals past the block");
      lit.assign(src + lh, src + lh + count);
      pos = lh + count;
    } else {
      ++counters[kLitRle];
      if (lh + 1 > size) throw Error("RLE literals past the block");
      lit.assign(count, src[lh]);
      pos = lh + 1;
    }
  } else {
    if (type == 3 && !f.huf_set) throw Error("treeless literals with no Huffman table before them");
    if (size < 5) throw Error("truncated compressed literals header");
    const uint32_t lhc = le32(src);
    size_t lh, count, csize;
    bool single = false;
    if (sf <= 1) {
      single = sf == 0;
      lh = 3;
      count = (lhc >> 4) & 0x3FF;
      csize = (lhc >> 14) & 0x3FF;
    } else if (sf == 2) {
      lh = 4;
      count = (lhc >> 4) & 0x3FFF;
      csize = lhc >> 18;
    } else {
      lh = 5;
      count = (lhc >> 4) & 0x3FFFF;
      csize = (lhc >> 22) + (static_cast<size_t>(src[4]) << 10);
    }
    if (count > f.block_max) throw Error("literals over the block maximum");
    if (!single && count < 6) throw Error("too few literals for 4 streams");
    if (csize + lh > size) throw Error("compressed literals past the block");
    const uint8_t* p = src + lh;
    size_t psize = csize;
    if (type == 2) {
      const size_t used = read_huffman(p, psize, &f.huf, counters);
      f.huf_set = true;
      p += used;
      psize -= used;
    } else {
      ++counters[kLitTreeless];
    }
    lit.resize(count);
    if (single) {
      ++counters[kLitHuffman1];
      huffman_stream(f.huf, p, psize, lit.data(), count);
    } else {
      ++counters[kLitHuffman4];
      if (psize < 10) throw Error("4 Huffman streams in fewer than 10 bytes");
      const size_t l1 = le16(p), l2 = le16(p + 2), l3 = le16(p + 4);
      if (l1 + l2 + l3 + 6 > psize) throw Error("Huffman jump table past the literals");
      const size_t l4 = psize - (l1 + l2 + l3 + 6);
      const size_t seg = (count + 3) / 4;
      if (3 * seg > count) throw Error("too few literals for 4 streams");
      const uint8_t* s = p + 6;
      if (huffman_fast4(f.huf, p, psize, lit.data(), count)) {
        ++counters[kLitHuffmanFast];
      } else {
      huffman_stream(f.huf, s, l1, lit.data(), seg);
      huffman_stream(f.huf, s + l1, l2, lit.data() + seg, seg);
      huffman_stream(f.huf, s + l1 + l2, l3, lit.data() + 2 * seg, seg);
      huffman_stream(f.huf, s + l1 + l2 + l3, l4, lit.data() + 3 * seg, count - 3 * seg);
      }
    }
    pos = lh + csize;
  }
  // Sequences section.
  const uint8_t* ip = src + pos;
  const uint8_t* iend = src + size;
  if (ip >= iend) throw Error("no sequences section");
  size_t nseq = *ip++;
  if (nseq > 0x7F) {
    if (nseq == 0xFF) {
      if (ip + 2 > iend) throw Error("truncated sequence count");
      nseq = le16(ip) + 0x7F00;
      ip += 2;
    } else {
      if (ip >= iend) throw Error("truncated sequence count");
      nseq = ((nseq - 0x80) << 8) + *ip++;
    }
  }
  const size_t start = f.out.size();
  if (nseq == 0) {
    ++counters[kSeqNone];
    if (ip != iend) throw Error("data after an empty sequences section");
    if (lit.size() > f.block_max) throw Error("block over the block maximum");
    f.out.insert(f.out.end(), lit.begin(), lit.end());
    return;
  }
  if (ip + 1 > iend) throw Error("truncated sequence modes");
  if (*ip & 3) throw Error("reserved bits set in the sequence modes");
  const int llm = *ip >> 6, ofm = (*ip >> 4) & 3, mlm = (*ip >> 2) & 3;
  ip++;
  ip += read_seq_table(llm, ip, iend - ip, 35, 9, kLLDefault, 36, 6, &f.ll, f.tables_set, counters);
  ip += read_seq_table(ofm, ip, iend - ip, 31, 8, kOFDefault, 29, 5, &f.of, f.tables_set, counters);
  ip += read_seq_table(mlm, ip, iend - ip, 52, 9, kMLDefault, 53, 6, &f.ml, f.tables_set, counters);
  f.tables_set = true;
  if (ip >= iend) throw Error("no sequence bitstream");
  BackBits b;
  b.init(ip, iend - ip);
  uint32_t sll = static_cast<uint32_t>(b.read(f.ll.fse.log));
  b.reload();
  uint32_t sof = static_cast<uint32_t>(b.read(f.of.fse.log));
  b.reload();
  uint32_t sml = static_cast<uint32_t>(b.read(f.ml.fse.log));
  b.reload();
  size_t litpos = 0;
  for (size_t i = 0; i < nseq; ++i) {
    const int llc = f.ll.fse.e[sll].symbol, ofc = f.of.fse.e[sof].symbol, mlc = f.ml.fse.e[sml].symbol;
    if (ofc > 31) throw Error("offset code past its maximum");
    uint64_t offset;
    const bool ll0 = llc == 0;
    if (ofc > 1) {
      offset = (uint64_t(1) << ofc) + b.read(ofc) - 3;
      f.rep[2] = f.rep[1];
      f.rep[1] = f.rep[0];
      f.rep[0] = offset;
    } else {
      ++counters[kRepeatOffset];
      if (ofc == 0) {
        offset = f.rep[ll0 ? 1 : 0];
        f.rep[1] = f.rep[ll0 ? 0 : 1];
        f.rep[0] = offset;
      } else {
        const uint64_t idx = 1 + (ll0 ? 1 : 0) + b.read(1);
        uint64_t temp = idx == 3 ? f.rep[0] - 1 : f.rep[idx];
        if (temp == 0) throw Error("repeat offset of 0");
        if (idx != 1) f.rep[2] = f.rep[1];
        f.rep[1] = f.rep[0];
        f.rep[0] = offset = temp;
      }
    }
    const uint64_t ml = kMLBase[mlc] + b.read(kMLBits[mlc]);
    if (b.consumed <= 64) b.reload();
    const uint64_t ll = kLLBase[llc] + b.read(kLLBits[llc]);
    if (i + 1 < nseq) {
      const FseEntry &el = f.ll.fse.e[sll], &em = f.ml.fse.e[sml], &eo = f.of.fse.e[sof];
      sll = el.base + static_cast<uint32_t>(b.read(el.nbits));
      sml = em.base + static_cast<uint32_t>(b.read(em.nbits));
      sof = eo.base + static_cast<uint32_t>(b.read(eo.nbits));
      if (b.consumed <= 64) b.reload();
    }
    if (litpos + ll > lit.size()) throw Error("a sequence reads past the literals");
    if (f.out.size() - start + ll + ml > f.block_max) throw Error("block over the block maximum");
    f.out.insert(f.out.end(), lit.begin() + litpos, lit.begin() + litpos + ll);
    litpos += ll;
    if (offset > f.out.size()) throw Error("a match before the frame's start");
    const size_t from = f.out.size() - offset;
    for (uint64_t k = 0; k < ml; ++k) f.out.push_back(f.out[from + k]);
  }
  if (b.consumed <= 64) b.reload();
  if (!b.ended()) throw Error("corrupt sequence bitstream (not consumed exactly)");
  if (f.out.size() - start + lit.size() - litpos > f.block_max) throw Error("block over the block maximum");
  f.out.insert(f.out.end(), lit.begin() + litpos, lit.end());
}

struct FrameHeader {
  size_t size = 0;
  bool skippable = false;
  uint64_t skip = 0;
  bool has_fcs = false, checksum = false;
  uint64_t fcs = 0, window = 0;
};

// ZSTD_getFrameHeader: false where the input holds less than the header.
bool frame_header(const uint8_t* p, size_t n, FrameHeader* h, int64_t* counters) {
  if (n < 4) return false;
  const uint32_t magic = le32(p);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
    if (n < 8) return false;
    h->skippable = true;
    h->skip = le32(p + 4);
    h->size = 8;
    ++counters[kSkippable];
    return true;
  }
  if (magic != 0xFD2FB528u) throw Error("unknown frame descriptor (not a Zstandard frame)");
  if (n < 5) return false;
  const int fhd = p[4];
  const int fcs_id = fhd >> 6, single = (fhd >> 5) & 1, dict_id = fhd & 3;
  const size_t dict_sizes[4] = {0, 1, 2, 4}, fcs_sizes[4] = {0, 2, 4, 8};
  const size_t fcs_size = fcs_id == 0 ? (single ? 1 : 0) : fcs_sizes[fcs_id];
  h->size = 5 + !single + dict_sizes[dict_id] + fcs_size;
  if (n < h->size) return false;
  if (fhd & 0x08) throw Error("reserved bit set in the frame header");
  size_t pos = 5;
  if (!single) {
    ++counters[kWindowDescriptor];
    const int wd = p[pos++];
    const int wlog = 10 + (wd >> 3);
    if (wlog > 31) throw Error("window too large");
    const uint64_t base = uint64_t(1) << wlog;
    h->window = base + (base / 8) * (wd & 7);
  } else {
    ++counters[kSingleSegment];
  }
  uint64_t dict = 0;
  for (size_t i = 0; i < dict_sizes[dict_id]; ++i) dict |= static_cast<uint64_t>(p[pos + i]) << (8 * i);
  pos += dict_sizes[dict_id];
  if (dict) throw Error("frame needs a dictionary (dictionary ID " + std::to_string(dict) + ")");
  h->has_fcs = fcs_size > 0;
  if (fcs_size == 1) h->fcs = p[pos];
  else if (fcs_size == 2) h->fcs = le16(p + pos) + 256;
  else if (fcs_size == 4) h->fcs = le32(p + pos);
  else if (fcs_size == 8) h->fcs = le64(p + pos);
  if (single) h->window = h->fcs;
  ++counters[h->has_fcs ? kFrameContentSize : kFrameNoContentSize];
  h->checksum = (fhd >> 2) & 1;
  return true;
}

// ZSTD_findFrameCompressedSize: the frame's bytes, or 0 where its blocks do
// not fit the input (or a block type is reserved).
size_t frame_compressed_size(const uint8_t* p, size_t n, const FrameHeader& h) {
  size_t pos = h.size;
  for (;;) {
    if (pos + 3 > n) return 0;
    const uint32_t bh = le24(p + pos);
    const int type = (bh >> 1) & 3;
    if (type == 3) return 0;
    const size_t csize = type == 1 ? 1 : bh >> 3;
    pos += 3 + csize;
    if (pos > n) return 0;
    if (bh & 1) break;
  }
  if (h.checksum) {
    if (pos + 4 > n) return 0;
    pos += 4;
  }
  return pos;
}

// One block (header at p) decoded into f.out; returns its bytes and sets
// *last, and *complete where the input held all of it. A raw block the
// input cuts short streams through as far as it goes (libzstd's stream
// decoder copies a raw block as its input arrives).
size_t decode_block(Frame& f, const uint8_t* p, size_t avail, bool* last, bool* complete, int64_t* counters) {
  *complete = false;
  if (avail < 3) return 0;
  const uint32_t bh = le24(p);
  *last = bh & 1;
  const int type = (bh >> 1) & 3;
  const size_t bsize = bh >> 3;
  if (type == 3) throw Error("reserved block type");
  const size_t csize = type == 1 ? 1 : bsize;
  if (type != 1 && csize > f.block_max) throw Error("block over the block maximum");
  if (3 + csize > avail) {
    if (type == 0) {
      ++counters[kBlockRaw];
      f.out.insert(f.out.end(), p + 3, p + avail);
    }
    return avail;
  }
  const uint8_t* src = p + 3;
  if (type == 0) {
    ++counters[kBlockRaw];
    f.out.insert(f.out.end(), src, src + bsize);
  } else if (type == 1) {
    ++counters[kBlockRle];
    if (bsize > f.block_max) throw Error("RLE block over the block maximum");
    f.out.insert(f.out.end(), bsize, src[0]);
  } else {
    ++counters[kBlockCompressed];
    decode_compressed_block(f, src, bsize, counters);
  }
  *complete = true;
  return 3 + csize;
}

void check_content(const Frame& f, const FrameHeader& h, const uint8_t* checksum) {
  if (h.has_fcs && f.out.size() != h.fcs) throw Error("frame content size does not match");
  if (checksum && static_cast<uint32_t>(xxh64(f.out.data(), f.out.size())) != le32(checksum))
    throw Error("content checksum does not match");
}

// tif_zstd.c ZSTDDecode: returns the bytes written to out.
int64_t decode_strip(const uint8_t* in, size_t n, uint8_t* out, size_t occ, int64_t* counters) {
  FrameHeader h;
  if (!frame_header(in, n, &h, counters)) return 0;
  if (h.skippable) return 0;  // ZSTD_decompressStream returns at its end, and libtiff stops
  Frame f;
  f.block_max = static_cast<size_t>(h.window < kBlockSizeMax ? h.window : kBlockSizeMax);
  if (h.has_fcs && h.fcs <= occ) {
    const size_t csize = frame_compressed_size(in, n, h);
    if (csize) {  // the one-pass shortcut
      ++counters[kOnePass];
      size_t pos = h.size;
      bool last = false, complete;
      while (!last) pos += decode_block(f, in + pos, n - pos, &last, &complete, counters);
      if (h.checksum) ++counters[kChecksum];
      check_content(f, h, h.checksum ? in + pos : nullptr);
      std::memcpy(out, f.out.data(), f.out.size());
      return static_cast<int64_t>(f.out.size());
    }
  }
  ++counters[kStreaming];
  if (h.window > kMaxStreamingWindow) throw Error("window too large for the stream decoder");
  size_t pos = h.size, written = 0;
  bool last = false;
  while (!last) {
    const size_t before = f.out.size();
    bool complete;
    const size_t used = decode_block(f, in + pos, n - pos, &last, &complete, counters);
    pos += used;
    if (!complete) {  // the input ends inside the unit: what a raw block had goes out, then the stream waits
      const size_t take = std::min(f.out.size() - before, occ - written);
      std::memcpy(out + written, f.out.data() + before, take);
      written += take;
      break;
    }
    if (last && h.has_fcs && f.out.size() != h.fcs) throw Error("frame content size does not match");
    const size_t produced = f.out.size() - before;
    const size_t take = produced < occ - written ? produced : occ - written;
    std::memcpy(out + written, f.out.data() + before, take);
    written += take;
    if (take < produced) return static_cast<int64_t>(written);  // the flush cannot complete
    if (last && h.checksum) {
      if (pos + 4 > n) break;
      ++counters[kChecksum];
      check_content(f, h, in + pos);
    }
    if (written == occ && !last) {
      // ZSTD_decompressStream goes on with the next block while it can,
      // decodes it, and stops where its flush finds no room.
      bool next_last, next_complete;
      decode_block(f, in + pos, n - pos, &next_last, &next_complete, counters);
      if (next_complete && next_last && h.has_fcs && f.out.size() != h.fcs)
        throw Error("frame content size does not match");
      return static_cast<int64_t>(written);
    }
  }
  return static_cast<int64_t>(written);
}

void set_error(char* err, int64_t cap, const char* msg) {
  if (err && cap > 0) {
    std::strncpy(err, msg, static_cast<size_t>(cap - 1));
    err[cap - 1] = '\0';
  }
}

}  // namespace

extern "C" {

// Decodes a ZSTD-compressed strip or tile `in` into `out` (at most out_size
// bytes) as libtiff's ZSTDDecode does, adding to counters[i] (zstd_paths
// entries) each time path i is reached. Returns the bytes written (less
// than out_size where the data runs short: libtiff fails the strip), or -1
// with a message in err where libzstd reports an error.
int64_t zstd_decode(const uint8_t* in, int64_t n, uint8_t* out, int64_t out_size, int64_t* counters, char* err,
                    int64_t err_cap) {
  try {
    return decode_strip(in, static_cast<size_t>(n), out, static_cast<size_t>(out_size), counters);
  } catch (const std::exception& e) {
    set_error(err, err_cap, e.what());
    return -1;
  }
}

// The names of the paths zstd_decode counts, comma-separated, in order.
const char* zstd_paths() { return kPathNames; }

}  // extern "C"
