// JPEG 2000 codestreams (ITU-T T.800, and the part-two syntax openjpeg 2.5
// reads) decoded on the host to the component samples that openjpeg 2.5's
// opj_decode_tile_data gives Pillow,
// following openjpeg's structure: j2k.c (markers), pi.c (the five
// progression orders), t2.c (packet headers: tag trees, Lblock, pass
// counts), t1.c with mqc.c (the MQ decoder and the three coding passes),
// tcd.c (tile, resolution, band, precinct and code-block geometry, step
// sizes), dwt.c (inverse 5/3 in integers, inverse 9/7 in float32 in
// opj_v8dwt_decode's order of scaling and lifting steps, with its
// two_invK) and mct.c (inverse RCT, and ICT as opj_mct_decode_real), then
// the DC level shift and clamp of opj_tcd_dc_level_shift_decode with
// opj_lrintf's round-half-to-even.
//
// Covered: SIZ (subsampled components included), COD, COC, QCD, QCC (no,
// scalar derived and scalar expounded quantisation), RGN (the max-shift),
// POC (in the main and tile-part headers, several changes a marker, run as
// pi.c runs them), PPM and PPT (packet headers read from the merged marker
// data), COM, TLM, PLM, PLT, CRG (skipped), SOT, SOD, EOC; SOP and EPH
// where Scod sets them (a missing EPH fails, as in openjpeg 2.5); a marker
// openjpeg does not know in the main header, skipped as opj_j2k_read_unk
// skips it (to the next known marker, two bytes at a time); several
// tiles, tile parts, quality layers and precincts; every code-block style
// of part one with openjpeg's segment rules (opj_t2_init_seg). Refused,
// each naming the feature: HTJ2K (a CAP marker, Rsiz bit 14 or code-block
// style bit 0x40; mixed HT, 0x80, as openjpeg refuses it), multiple
// component transforms other than 0 and 1 (their CPF, MCT, MCC, MCO and
// CBD markers), arbitrary wavelets, an unknown marker in a tile-part
// header, and a codestream whose data ends before its last packet
// (truncated).
//
// The float path is bitwise with openjpeg only when compiled without
// floating-point contraction (-ffp-contract=off, see ops/cuda_build.py).
//
// Output: the tile buffers openjpeg's opj_decode_tile_data hands Pillow, in
// its decoding order: each component's samples at its highest decoded
// resolution, after the level shift and clamp, in 1, 2 or 4 bytes.
// Host library with a plain C interface, built with g++ into
// build/libjpeg2000_decode.so and loaded with ctypes by
// utils/image_jpeg2000.py.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void part_two(const std::string& what) {
  throw Error(what + " is not ported yet (JPEG 2000 part two)");
}

// Which paths a call reached (j2k_counts): the tests read them to show
// what the corpus covers. Atomic: datasets decode frames on several
// threads.
enum Count {
  kLRCP, kRLCP, kRPCL, kPCRL, kCPRL, kLayers, kTiles, kTileParts, kPrecincts, kSOP, kEPH, kPLT, kTLM, kCOM,
  kWavelet53, kWavelet97, kRCT, kICT, kCOC, kQCC, kSigned, kOffset, kDerived, kPOC, kSubsampled, kStyleBypass,
  kStyleReset, kStyleTermAll, kStyleCausal, kStylePterm, kStyleSegSym, kRGN, kPPM, kPPT, kCountN
};
std::atomic<int64_t> g_counts[kCountN];

inline int64_t ceildivpow2(int64_t a, int b) { return (a + (int64_t(1) << b) - 1) >> b; }
inline int64_t floordivpow2(int64_t a, int b) { return a >> b; }
inline int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// Coding parameters (j2k.c)
// ---------------------------------------------------------------------------

struct StepSize {
  int expn = 0, mant = 0;
};

struct Tccp {  // one component's coding style and quantisation
  int numres = 6, cblkw = 6, cblkh = 6, cblksty = 0, qmfbid = 1;
  int qntsty = 0, numgbits = 2, roishift = 0;
  int prcw[33], prch[33];
  StepSize steps[3 * 32 + 1];
  Tccp() {
    std::fill(prcw, prcw + 33, 15);
    std::fill(prch, prch + 33, 15);
  }
};

struct Poc {  // one progression order change (opj_poc_t as j2k.c reads it)
  int resno0 = 0, compno0 = 0, layno1 = 0, resno1 = 0, compno1 = 0, prg = 0;
};

struct Tcp {  // a tile's coding parameters
  int csty = 0, prg = 0, numlayers = 1, mct = 0;
  std::vector<Tccp> tccps;
  bool cod = false;
  std::vector<Poc> pocs;  // openjpeg appends a tile's POC to the main header's
  std::vector<std::vector<uint8_t>> ppt;  // PPT data by Zppt (empty: none)
  bool has_ppt = false;
};

struct CompInfo {
  int prec = 8, dx = 1, dy = 1;
  bool sgnd = false;
};

// ---------------------------------------------------------------------------
// The MQ decoder (mqc.c): Table C.2, the software conventions of Annex C
// with openjpeg's artificial 0xFF 0xFF after the data.
// ---------------------------------------------------------------------------

struct MqState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

const MqState kMq[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},
    {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0},
    {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0}, {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0}, {0x1C01, 25, 22, 0},
    {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0},
    {0x02A1, 36, 33, 0}, {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

// The contexts of t1.c: 9 zero coding, 5 sign, 3 magnitude refinement, the
// run-length and the uniform context.
constexpr int kCtxSC = 9, kCtxMag = 14, kCtxAgg = 17, kCtxUni = 18, kNumCtx = 19;

struct Mq {
  const uint8_t* bp = nullptr;
  uint32_t a = 0, c = 0;
  int ct = 0;
  uint8_t idx[kNumCtx], mps[kNumCtx];

  void reset_states() {
    std::memset(idx, 0, sizeof(idx));
    std::memset(mps, 0, sizeof(mps));
    idx[kCtxUni] = 46;
    idx[kCtxAgg] = 3;
    idx[0] = 4;
  }
  // `data` (len bytes) is followed by 0xFF 0xFF.
  void init(const uint8_t* data, size_t len) {
    bp = data;
    c = len == 0 ? 0xFFu << 16 : static_cast<uint32_t>(*bp) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void bytein() {
    if (*bp == 0xFF) {
      if (bp[1] > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        ++bp;
        c += static_cast<uint32_t>(*bp) << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += static_cast<uint32_t>(*bp) << 8;
      ct = 8;
    }
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (a < 0x8000);
  }
  int decode(int cx) {
    const MqState& s = kMq[idx[cx]];
    int d;
    a -= s.qe;
    if ((c >> 16) < s.qe) {
      if (a < s.qe) {
        d = mps[cx];
        idx[cx] = s.nmps;
      } else {
        d = 1 - mps[cx];
        if (s.sw) mps[cx] = static_cast<uint8_t>(1 - mps[cx]);
        idx[cx] = s.nlps;
      }
      a = s.qe;
      renorm();
    } else {
      c -= static_cast<uint32_t>(s.qe) << 16;
      if ((a & 0x8000) == 0) {
        if (a < s.qe) {
          d = 1 - mps[cx];
          if (s.sw) mps[cx] = static_cast<uint8_t>(1 - mps[cx]);
          idx[cx] = s.nlps;
        } else {
          d = mps[cx];
          idx[cx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
};

// ---------------------------------------------------------------------------
// Tier 1 (t1.c): openjpeg's reconstruction (a sample turns significant at
// 1.5 times its bit plane, each refinement moves it a quarter; values carry
// one extra bit, halved afterwards), with every code-block style of part
// one: selective arithmetic-coding bypass (raw passes), context reset after
// each pass, termination at each pass (a segment a pass), vertically causal
// contexts, predictable termination (checked by openjpeg with warnings
// only, so not here) and segmentation symbols.
// ---------------------------------------------------------------------------

// Zero-coding context by orientation (t1_init_ctxno_zc, with openjpeg's
// swap of bands 1 and 2), h and v the significant horizontal and vertical
// neighbours, d the diagonal ones.
int zc_context(int orient, int h, int v, int d) {
  if (orient == 1) std::swap(h, v);  // HL: vertical neighbours first
  if (orient != 3) {
    if (!h) {
      if (!v) return d == 0 ? 0 : (d == 1 ? 1 : 2);
      return v == 1 ? 3 : 4;
    }
    if (h == 1) {
      if (!v) return d == 0 ? 5 : 6;
      return 7;
    }
    return 8;
  }
  const int hv = h + v;
  if (!d) return hv == 0 ? 0 : (hv == 1 ? 1 : 2);
  if (d == 1) return hv == 0 ? 3 : (hv == 1 ? 4 : 5);
  if (d == 2) return hv == 0 ? 6 : 7;
  return 8;
}

struct ZcLut {
  uint8_t t[4][3][3][5];
  ZcLut() {
    for (int o = 0; o < 4; ++o)
      for (int h = 0; h < 3; ++h)
        for (int v = 0; v < 3; ++v)
          for (int d = 0; d < 5; ++d) t[o][h][v][d] = static_cast<uint8_t>(zc_context(o, h, v, d));
  }
};
const ZcLut kZc;

constexpr uint8_t kSig = 1, kNeg = 2, kVisit = 4, kRefined = 8;
// Code-block style bits (SPcod/SPcoc).
constexpr int kLazy = 0x01, kReset = 0x02, kTermAll = 0x04, kVsc = 0x08, kSegSym = 0x20;

// A code-block's codeword segment: its bytes and its coding passes.
struct Seg {
  size_t len = 0;
  int passes = 0, maxpasses = 0, newpasses = 0;
  uint32_t newlen = 0;
};

// The raw (bypass) bit reader of mqc.c (opj_mqc_raw_decode); `data` is
// followed by 0xFF 0xFF.
struct Raw {
  const uint8_t* bp = nullptr;
  uint32_t c = 0;
  int ct = 0;
  void init(const uint8_t* data) {
    bp = data;
    c = 0;
    ct = 0;
  }
  int decode() {
    if (ct == 0) {
      if (c == 0xFF) {
        if (*bp > 0x8F) {
          c = 0xFF;
          ct = 8;
        } else {
          c = *bp++;
          ct = 7;
        }
      } else {
        c = *bp++;
        ct = 8;
      }
    }
    --ct;
    return (c >> ct) & 1;
  }
};

class T1 {
 public:
  // Decodes a w x h code-block's segments (their bytes one after another
  // in `data`) into `out` (w*h, openjpeg's doubled values), as
  // opj_t1_decode_cblk does: the bit planes start at roishift + numbps.
  void decode(const uint8_t* data, const std::vector<Seg>& segs, int nsegs, int w, int h, int orient, int numbps,
              int roishift, int cblksty, int32_t* out) {
    w_ = w;
    h_ = h;
    orient_ = orient;
    data_ = out;
    vsc_ = (cblksty & kVsc) != 0;
    std::fill(out, out + static_cast<size_t>(w) * h, 0);
    int bpno = roishift + numbps;  // openjpeg's bpno_plus_one
    if (bpno >= 31) throw Error("code-block with too many bit planes (31 or more)");
    if (w <= 0 || h <= 0 || nsegs == 0) return;
    flags_.assign(static_cast<size_t>(w + 2) * (h + 2), 0);
    mq_.reset_states();
    int passtype = 2;
    size_t at = 0;
    for (int s = 0; s < nsegs; ++s) {
      const Seg& seg = segs[s];
      const bool raw = bpno <= numbps - 4 && passtype < 2 && (cblksty & kLazy);
      // openjpeg's artificial 0xFF 0xFF after the segment's bytes.
      buf_.assign(data + at, data + at + seg.len);
      buf_.push_back(0xFF);
      buf_.push_back(0xFF);
      at += seg.len;
      if (raw) {
        raw_.init(buf_.data());
      } else {
        mq_.init(buf_.data(), seg.len);
      }
      for (int p = 0; p < seg.passes && bpno >= 1; ++p) {
        if (passtype == 0) sigpass(bpno, raw);
        else if (passtype == 1) refpass(bpno, raw);
        else clnpass(bpno, cblksty & kSegSym);
        if ((cblksty & kReset) && !raw) mq_.reset_states();
        if (++passtype == 3) {
          passtype = 0;
          --bpno;
        }
      }
    }
    // opj_t1_clbl_decode_processor: the ROI max-shift, on the doubled values.
    if (roishift) {
      const int32_t thresh = int32_t(1) << roishift;
      for (size_t i = 0; i < static_cast<size_t>(w) * h; ++i) {
        const int32_t v = out[i];
        int32_t mag = v < 0 ? -v : v;
        if (mag >= thresh) {
          mag >>= roishift;
          out[i] = v < 0 ? -mag : mag;
        }
      }
    }
  }

 private:
  int w_ = 0, h_ = 0, orient_ = 0;
  bool vsc_ = false;
  int32_t* data_ = nullptr;
  std::vector<uint8_t> flags_, buf_;
  Mq mq_;
  Raw raw_;

  uint8_t& f(int x, int y) { return flags_[static_cast<size_t>(y + 1) * (w_ + 2) + (x + 1)]; }
  int sig(int x, int y) { return f(x, y) & kSig; }
  // Vertically causal contexts: the last row of a stripe does not see the
  // next stripe's first row (openjpeg leaves its flags unset).
  bool south_hidden(int y) const { return vsc_ && (y & 3) == 3; }
  bool any_neighbour(int x, int y) {
    const int north = sig(x - 1, y - 1) | sig(x, y - 1) | sig(x + 1, y - 1) | sig(x - 1, y) | sig(x + 1, y);
    if (south_hidden(y)) return north;
    return north | sig(x - 1, y + 1) | sig(x, y + 1) | sig(x + 1, y + 1);
  }
  int zc(int x, int y) {
    const bool s = !south_hidden(y);
    const int h = sig(x - 1, y) + sig(x + 1, y);
    const int v = sig(x, y - 1) + (s ? sig(x, y + 1) : 0);
    const int d = sig(x - 1, y - 1) + sig(x + 1, y - 1) + (s ? sig(x - 1, y + 1) + sig(x + 1, y + 1) : 0);
    return kZc.t[orient_][h][v][d];
  }
  // The neighbour's contribution: 1 positive, -1 negative, 0 insignificant.
  int contribution(int x, int y) {
    const uint8_t g = f(x, y);
    return (g & kSig) ? ((g & kNeg) ? -1 : 1) : 0;
  }
  void set(int x, int y, int32_t value, int neg) {
    data_[static_cast<size_t>(y) * w_ + x] = neg ? -value : value;
    f(x, y) |= static_cast<uint8_t>(kSig | (neg ? kNeg : 0));
  }
  void decode_sign(int x, int y, int32_t value) {
    const int cw = contribution(x - 1, y), ce = contribution(x + 1, y);
    const int cn = contribution(x, y - 1), cs = south_hidden(y) ? 0 : contribution(x, y + 1);
    const int hp = (cw > 0) + (ce > 0), hn = (cw < 0) + (ce < 0);
    const int vp = (cn > 0) + (cs > 0), vn = (cn < 0) + (cs < 0);
    int hc = std::min(hp, 1) - std::min(hn, 1), vc = std::min(vp, 1) - std::min(vn, 1);
    const int spb = (!hc && !vc) ? 0 : !(hc > 0 || (!hc && vc > 0));
    if (hc < 0) {
      hc = -hc;
      vc = -vc;
    }
    int n;
    if (!hc) n = vc == 0 ? 0 : 1;
    else n = vc == -1 ? 2 : (vc == 0 ? 3 : 4);
    set(x, y, value, mq_.decode(kCtxSC + n) ^ spb);
  }
  void sigpass(int bpno, bool raw) {
    const int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
    for (int k = 0; k < h_; k += 4)
      for (int x = 0; x < w_; ++x)
        for (int y = k; y < std::min(k + 4, h_); ++y) {
          if ((f(x, y) & (kSig | kVisit)) || !any_neighbour(x, y)) continue;
          if (raw) {
            if (raw_.decode()) set(x, y, oneplushalf, raw_.decode());
          } else if (mq_.decode(zc(x, y))) {
            decode_sign(x, y, oneplushalf);
          }
          f(x, y) |= kVisit;
        }
  }
  void refpass(int bpno, bool raw) {
    const int32_t poshalf = (1 << bpno) >> 1;
    for (int k = 0; k < h_; k += 4)
      for (int x = 0; x < w_; ++x)
        for (int y = k; y < std::min(k + 4, h_); ++y) {
          uint8_t& g = f(x, y);
          if ((g & (kSig | kVisit)) != kSig) continue;
          int v;
          if (raw) {
            v = raw_.decode();
          } else {
            const int ctx = (g & kRefined) ? kCtxMag + 2 : (any_neighbour(x, y) ? kCtxMag + 1 : kCtxMag);
            v = mq_.decode(ctx);
          }
          int32_t& d = data_[static_cast<size_t>(y) * w_ + x];
          d += (v ^ (d < 0)) ? poshalf : -poshalf;
          g |= kRefined;
        }
  }
  void clnpass(int bpno, bool segsym) {
    const int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
    for (int k = 0; k < h_; k += 4)
      for (int x = 0; x < w_; ++x) {
        int start = k;
        if (k + 3 < h_) {
          bool run = true;
          for (int y = k; y < k + 4 && run; ++y)
            if ((f(x, y) & (kSig | kVisit)) || any_neighbour(x, y)) run = false;
          if (run) {
            if (!mq_.decode(kCtxAgg)) continue;
            int runlen = mq_.decode(kCtxUni) << 1;
            runlen |= mq_.decode(kCtxUni);
            start = k + runlen;
            decode_sign(x, start, oneplushalf);
            ++start;
          }
        }
        for (int y = start; y < std::min(k + 4, h_); ++y) {
          if (f(x, y) & (kSig | kVisit)) continue;
          if (mq_.decode(zc(x, y))) decode_sign(x, y, oneplushalf);
        }
      }
    for (int y = 0; y < h_; ++y)
      for (int x = 0; x < w_; ++x) f(x, y) &= static_cast<uint8_t>(~kVisit);
    if (segsym) {  // opj_t1_dec_clnpass_check_segsym: four symbols, not checked
      for (int i = 0; i < 4; ++i) mq_.decode(kCtxUni);
    }
  }
};

// ---------------------------------------------------------------------------
// Tier 2 (t2.c, tgt.c, bio.c)
// ---------------------------------------------------------------------------

struct Bio {  // packet header bits, with the bit stuffed after each 0xFF
  const uint8_t *start, *bp, *end;
  uint32_t buf = 0;
  int ct = 0;
  Bio(const uint8_t* b, const uint8_t* e) : start(b), bp(b), end(e) {}
  void bytein() {
    buf = (buf << 8) & 0xFFFF;
    ct = buf == 0xFF00 ? 7 : 8;
    if (bp < end) buf |= *bp++;
  }
  int bit() {
    if (ct == 0) bytein();
    --ct;
    return (buf >> ct) & 1;
  }
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; --i) v |= static_cast<uint32_t>(bit()) << i;
    return v;
  }
  void inalign() {
    if ((buf & 0xFF) == 0xFF) bytein();
    ct = 0;
  }
  size_t numbytes() const { return static_cast<size_t>(bp - start); }
};

struct TagTree {
  struct Node {
    int parent, value, low;
  };
  std::vector<Node> nodes;
  void init(int w, int h) {
    nodes.clear();
    if (w <= 0 || h <= 0) return;
    std::vector<int> lw{w}, lh{h}, first{0};
    int total = w * h;
    while (lw.back() * lh.back() > 1) {
      lw.push_back((lw.back() + 1) / 2);
      lh.push_back((lh.back() + 1) / 2);
      first.push_back(total);
      total += lw.back() * lh.back();
    }
    nodes.assign(total, Node{-1, 999, 0});
    for (size_t l = 0; l + 1 < lw.size(); ++l)
      for (int y = 0; y < lh[l]; ++y)
        for (int x = 0; x < lw[l]; ++x)
          nodes[first[l] + y * lw[l] + x].parent = first[l + 1] + (y / 2) * lw[l + 1] + x / 2;
  }
  // opj_tgt_decode: 1 if the leaf's value is below `threshold`.
  int decode(Bio& bio, int leaf, int threshold) {
    int stk[64], n = 0;
    int node = leaf;
    while (nodes[node].parent >= 0) {
      stk[n++] = node;
      node = nodes[node].parent;
    }
    int low = 0;
    for (;;) {
      Node& nd = nodes[node];
      if (low > nd.low) nd.low = low;
      else low = nd.low;
      while (low < threshold && low < nd.value) {
        if (bio.bit()) nd.value = low;
        else ++low;
      }
      nd.low = low;
      if (n == 0) break;
      node = stk[--n];
    }
    return nodes[node].value < threshold ? 1 : 0;
  }
};

struct Cblk {
  int x0, y0, x1, y1;
  int numbps = 0, numlenbits = 0, numsegs = 0, newpasses = 0;
  std::vector<Seg> segs;
  std::vector<uint8_t> data;
};

struct Precinct {
  int x0, y0, x1, y1, cw = 0, ch = 0;
  std::vector<Cblk> cblks;
  TagTree incl, imsb;
};

struct Band {
  int bandno = 0;
  int64_t x0, y0, x1, y1;
  float stepsize = 0;
  int numbps = 0;
  std::vector<Precinct> precincts;
  bool empty() const { return x0 >= x1 || y0 >= y1; }
};

struct Resolution {
  int64_t x0, y0, x1, y1;
  int pw = 0, ph = 0, pdx = 15, pdy = 15;
  std::vector<Band> bands;
};

struct TileComp {
  int64_t x0, y0, x1, y1;
  int numres = 0;
  std::vector<Resolution> res;
  std::vector<int32_t> data;  // float32 bits for an irreversible component
};

// ---------------------------------------------------------------------------
// Inverse wavelets (dwt.c)
// ---------------------------------------------------------------------------

// opj_idwt53_h / _v on one line: n samples, the first low-pass one at
// parity `cas` (0: even), lows first in `in` (sn of them), then highs.
void idwt53_line(const int32_t* in, int n, int sn, int cas, int32_t* x) {
  const int dn = n - sn;
  for (int i = 0; i < sn; ++i) x[2 * i + cas] = in[i];
  for (int i = 0; i < dn; ++i) x[2 * i + 1 - cas] = in[sn + i];
  if (cas == 0) {
    if (!(dn > 0 || sn > 1)) return;
  } else {
    if (sn == 0 && dn == 1) {
      x[0] /= 2;
      return;
    }
  }
  auto at = [&](int i) { return x[i < 0 ? -i : (i >= n ? 2 * (n - 1) - i : i)]; };
  for (int i = cas; i < n; i += 2) x[i] -= (at(i - 1) + at(i + 1) + 2) >> 2;
  for (int i = 1 - cas; i < n; i += 2) x[i] += (at(i - 1) + at(i + 1)) >> 1;
}

// opj_v8dwt_decode on one line (float32; every lane of openjpeg's SIMD
// does these operations in this order).
void idwt97_line(const float* in, int n, int sn, int cas, float* x) {
  const int dn = n - sn;
  for (int i = 0; i < sn; ++i) x[2 * i + cas] = in[i];
  for (int i = 0; i < dn; ++i) x[2 * i + 1 - cas] = in[sn + i];
  if (cas == 0) {
    if (!(dn > 0 || sn > 1)) return;
  } else {
    if (!(sn > 0 || dn > 1)) return;
  }
  const float kK = 1.230174105f, kTwoInvK = 1.625732422f;
  const float kAlpha = -1.586134342f, kBeta = -0.052980118f, kGamma = 0.882911075f, kDelta = 0.443506852f;
  for (int i = cas; i < n; i += 2) x[i] = x[i] * kK;
  for (int i = 1 - cas; i < n; i += 2) x[i] = x[i] * kTwoInvK;
  // Each step updates one parity from its two neighbours of the other; at
  // an edge the one neighbour counts twice (openjpeg: l * (c + c)).
  auto step = [&](int parity, float c) {
    for (int i = parity; i < n; i += 2) {
      const bool has_l = i - 1 >= 0, has_r = i + 1 < n;
      if (has_l && has_r) x[i] = x[i] + ((x[i - 1] + x[i + 1]) * c);
      else if (has_l) x[i] = x[i] + (x[i - 1] * (c + c));
      else if (has_r) x[i] = x[i] + ((x[i + 1] + x[i + 1]) * c);
    }
  };
  step(cas, -kDelta);
  step(1 - cas, -kGamma);
  step(cas, -kBeta);
  step(1 - cas, -kAlpha);
}

// The first `nres` resolutions of a tile-component, in place (row stride
// the component's width).
template <typename T, typename F>
void idwt_2d(TileComp& tc, T* data, int nres, F line) {
  const int64_t w = tc.x1 - tc.x0;
  std::vector<T> in, out;
  for (int r = 1; r < nres; ++r) {
    const Resolution& lo = tc.res[r - 1];
    const Resolution& res = tc.res[r];
    const int rw = static_cast<int>(res.x1 - res.x0), rh = static_cast<int>(res.y1 - res.y0);
    const int sw = static_cast<int>(lo.x1 - lo.x0), sh = static_cast<int>(lo.y1 - lo.y0);
    in.resize(std::max(rw, rh));
    out.resize(std::max(rw, rh));
    const int hcas = static_cast<int>(res.x0 & 1), vcas = static_cast<int>(res.y0 & 1);
    for (int y = 0; y < rh; ++y) {
      T* row = data + y * w;
      std::copy(row, row + rw, in.begin());
      line(in.data(), rw, sw, hcas, out.data());
      std::copy(out.begin(), out.begin() + rw, row);
    }
    for (int x = 0; x < rw; ++x) {
      for (int y = 0; y < rh; ++y) in[y] = data[y * w + x];
      line(in.data(), rh, sh, vcas, out.data());
      for (int y = 0; y < rh; ++y) data[y * w + x] = out[y];
    }
  }
}

// ---------------------------------------------------------------------------
// The codestream (j2k.c) and a tile's decoding (tcd.c)
// ---------------------------------------------------------------------------

class Decoder {
 public:
  // `counting`: this pass adds to the path counters (the decoding one, not
  // the header read before it).
  Decoder(const uint8_t* d, size_t n, bool counting) : d_(d), n_(n), counting_(counting) {}

  void header() {
    if (n_ < 4 || u16at(0) != 0xFF4F || u16at(2) != 0xFF51) throw Error("not a JPEG 2000 codestream (no SOC, SIZ)");
    pos_ = 2;
    while (true) {
      const int m = marker();
      if (m == 0xFF90) {
        pos_ -= 2;
        break;
      }
      segment(m, nullptr, -1);
    }
    if (!siz_) throw Error("no SIZ marker");
    if (!def_.cod) throw Error("no COD marker in the main header");
    if (!qcd_) throw Error("no QCD marker in the main header");
    if (has_ppm_) merge_ppm();
  }

  int components() const { return static_cast<int>(comps_.size()); }

  // W, H, C, XOsiz, YOsiz, the tile count, the bytes every tile's buffer
  // may take together, then each component's precision, signedness, XRsiz
  // and YRsiz.
  void dims(int64_t* out) const {
    out[0] = x1_ - x0_;
    out[1] = y1_ - y0_;
    out[2] = static_cast<int64_t>(comps_.size());
    out[3] = x0_;
    out[4] = y0_;
    out[5] = static_cast<int64_t>(tw_) * th_;
    out[6] = 0;
    for (int t = 0; t < tw_ * th_; ++t) {
      const int p = t % tw_, q = t / tw_;
      const int64_t tx0 = std::max(tx0_ + p * tdx_, x0_), ty0 = std::max(ty0_ + q * tdy_, y0_);
      const int64_t tx1 = std::min(tx0_ + (p + 1) * tdx_, x1_), ty1 = std::min(ty0_ + (q + 1) * tdy_, y1_);
      for (const auto& c : comps_)
        out[6] += (c.prec <= 8 ? 1 : (c.prec <= 16 ? 2 : 4)) * (ceildiv(tx1, c.dx) - ceildiv(tx0, c.dx)) *
                  (ceildiv(ty1, c.dy) - ceildiv(ty0, c.dy));
    }
    for (size_t c = 0; c < comps_.size(); ++c) {
      out[7 + 4 * c] = comps_[c].prec;
      out[8 + 4 * c] = comps_[c].sgnd;
      out[9 + 4 * c] = comps_[c].dx;
      out[10 + 4 * c] = comps_[c].dy;
    }
  }

  // Decodes every tile, in the order openjpeg hands them to Pillow (a tile
  // as its last tile-part is read, where SOT gives the count; the others
  // after EOC, by index), into `out`; table gets each tile's x0, y0, x1,
  // y1, its buffer's offset in out and its size. Returns the tile count.
  int decode(uint8_t* out, int64_t* table) {
    const int ntiles = tw_ * th_;
    tcps_.assign(ntiles, Tcp());
    std::vector<std::vector<uint8_t>> tile_data(ntiles);
    std::vector<int> parts(ntiles, 0), nparts(ntiles, 0);
    std::vector<bool> started(ntiles, false);
    std::vector<int> order;
    bool eoc = false;
    while (pos_ + 2 <= n_) {
      const int m = u16at(pos_);
      if (m == 0xFFD9) {
        eoc = true;
        break;
      }
      if (m != 0xFF90) throw Error("expected SOT, found marker " + hex(m));
      const size_t sot = pos_;
      pos_ += 2;
      const size_t len = seglen();
      if (len != 10) throw Error("bad SOT length");
      const int isot = u16at(pos_ + 2);
      const uint32_t psot = u32at(pos_ + 4);
      const int tpsot = u8at(pos_ + 8), tnsot = u8at(pos_ + 9);
      pos_ += len;
      if (isot >= ntiles) throw Error("tile index " + std::to_string(isot) + " out of range");
      // opj_j2k_read_sot: tile-parts in order, within their count; Psot 0 or
      // at least 14.
      if (tpsot != parts[isot] || (nparts[isot] && tpsot >= nparts[isot]) || (tnsot && tpsot >= tnsot))
        throw Error("invalid tile-part index " + std::to_string(tpsot) + " for tile " + std::to_string(isot));
      if (tnsot) nparts[isot] = tnsot;
      if (psot != 0 && psot < 14) throw Error("bad Psot " + std::to_string(psot));
      const size_t end = psot == 0 ? (n_ >= 2 && u16at(n_ - 2) == 0xFFD9 ? n_ - 2 : n_) : sot + psot;
      if (end > n_) throw Error("truncated codestream: a tile-part ends past the end of the data");
      Tcp& tcp = tcps_[isot];
      if (!started[isot]) {
        tcp = def_;
        tcp.cod = false;
        started[isot] = true;
      }
      ++parts[isot];
      while (true) {
        if (pos_ + 2 > end) throw Error("truncated codestream: no SOD in a tile-part header");
        const int mk = u16at(pos_);
        pos_ += 2;
        if (mk == 0xFF93) break;
        segment(mk, &tcp, parts[isot] == 1 ? 1 : 0);
      }
      tile_data[isot].insert(tile_data[isot].end(), d_ + pos_, d_ + end);
      pos_ = end;
      if (nparts[isot] && parts[isot] == nparts[isot]) order.push_back(isot);
    }
    if (!eoc && pos_ < n_) throw Error("truncated codestream");
    if (ntiles > 1) count(kTiles);
    for (int t = 0; t < ntiles; ++t)
      if (parts[t] > 1) count(kTileParts);
    if (x0_ || y0_ || tx0_ || ty0_) count(kOffset);
    for (const auto& c : comps_) {
      if (c.sgnd) count(kSigned);
      if (c.dx != 1 || c.dy != 1) count(kSubsampled);
    }
    // A tile with no tile-part is not decoded: openjpeg reaches EOC and
    // Pillow leaves its pixels as they were (0).
    for (int t = 0; t < ntiles; ++t)
      if (started[t] && std::find(order.begin(), order.end(), t) == order.end()) order.push_back(t);
    int64_t offset = 0;
    for (size_t i = 0; i < order.size(); ++i) {
      int64_t* row = table + 6 * i;
      row[4] = offset;
      decode_tile(order[i], tile_data[order[i]], out, row);
      offset += row[5];
    }
    return static_cast<int>(order.size());
  }

 private:
  const uint8_t* d_;
  size_t n_;
  bool counting_;
  size_t pos_ = 0;
  bool siz_ = false, qcd_ = false;
  int64_t x0_ = 0, y0_ = 0, x1_ = 0, y1_ = 0, tx0_ = 0, ty0_ = 0, tdx_ = 0, tdy_ = 0;
  int tw_ = 0, th_ = 0;
  std::vector<CompInfo> comps_;
  Tcp def_;
  std::vector<Tcp> tcps_;
  // PPM: the segments by Zppm, then (merged) their packet headers, read
  // from ppm_at_ on by every tile in decoding order.
  std::vector<std::vector<uint8_t>> ppm_;
  std::vector<uint8_t> ppm_data_;
  size_t ppm_at_ = 0;
  bool has_ppm_ = false;
  std::vector<int> resno_decoded_;  // per component, over the tiles so far (opj_image_comp_t's)

  void count(int k) {
    if (counting_) ++g_counts[k];
  }
  static std::string hex(int m) {
    char b[8];
    std::snprintf(b, sizeof(b), "%04X", m);
    return b;
  }
  int u8at(size_t p) const {
    if (p >= n_) throw Error("truncated codestream");
    return d_[p];
  }
  int u16at(size_t p) const { return (u8at(p) << 8) | u8at(p + 1); }
  uint32_t u32at(size_t p) const {
    return (static_cast<uint32_t>(u16at(p)) << 16) | static_cast<uint32_t>(u16at(p + 2));
  }
  int marker() {
    const int m = u16at(pos_);
    pos_ += 2;
    return m;
  }
  size_t seglen() {
    const size_t len = static_cast<size_t>(u16at(pos_));
    if (len < 2 || pos_ + len > n_) throw Error("truncated codestream: a marker segment ends past the data");
    return len;
  }

  // The markers openjpeg knows (j2k.c's marker handler table), by where
  // they may stand: 1 main header, 2 tile-part header, 3 both.
  static int marker_places(int m) {
    switch (m) {
      case 0xFF52: case 0xFF53: case 0xFF5C: case 0xFF5D: case 0xFF5E: case 0xFF5F: case 0xFF64: case 0xFF74:
      case 0xFF75: case 0xFF77:
        return 3;
      case 0xFF50: case 0xFF55: case 0xFF57: case 0xFF59: case 0xFF60: case 0xFF63: case 0xFF78: case 0xFF90:
        return 1;
      case 0xFF58: case 0xFF61:
        return 2;
      case 0xFF51: case 0xFF91:
        return 0;  // SIZ only right after SOC, SOP only in packet data
      default:
        return -1;  // unknown to openjpeg
    }
  }

  // One marker segment of the main header (tcp == nullptr) or of a tile
  // part's (first: 1 in the tile's first part).
  void segment(int m, Tcp* tcp, int first) {
    if (m < 0xFF00) throw Error("a marker was expected, found " + hex(m));
    const int place = tcp ? 2 : 1;
    if (m != 0xFF51 || tcp) {
      const int where = marker_places(m);
      if (where < 0 && !tcp) {
        // opj_j2k_read_unk: the next marker openjpeg knows, read two bytes
        // at a time from the unknown marker's length field on.
        size_t p = pos_;
        for (;; p += 2) {
          const int w = u16at(p);
          if (w < 0xFF00 || marker_places(w) < 0) continue;
          if (!(marker_places(w) & place)) throw Error("marker " + hex(w) + " is out of place in the main header");
          break;
        }
        pos_ = p;
        return;
      }
      if (where < 0) throw Error("an unknown marker (" + hex(m) + ") in a tile-part header");
      if (!(where & place))
        throw Error("marker " + hex(m) + " is out of place in the " + (tcp ? "tile-part" : "main") + " header");
    }
    const size_t len = seglen();
    const size_t p = pos_ + 2, end = pos_ + len;
    Tcp& t = tcp ? *tcp : def_;
    switch (m) {
      case 0xFF51:
        if (siz_) throw Error("a second SIZ marker");
        read_siz(p, end);
        break;
      case 0xFF52:
        if (tcp && !first) throw Error("COD in a tile's later part");
        read_cod(t, p, end);
        break;
      case 0xFF53:
        count(kCOC);
        read_coc(t, p, end);
        break;
      case 0xFF5C:
        read_qcx(t, p, end, -1);
        if (!tcp) qcd_ = true;
        break;
      case 0xFF5D: {
        count(kQCC);
        const int c = comps_.size() <= 256 ? u8at(p) : u16at(p);
        read_qcx(t, p + (comps_.size() <= 256 ? 1 : 2), end, c);
        break;
      }
      case 0xFF5E:
        count(kRGN);
        read_rgn(t, p, end);
        break;
      case 0xFF5F:
        count(kPOC);
        read_poc(t, p, end, tcp == nullptr && !def_.cod);
        break;
      case 0xFF60:  // opj_j2k_read_ppm: Zppm, then Nppm and Ippm, merged after the main header
        count(kPPM);
        if (end - p < 2) throw Error("error reading the PPM marker (too short)");
        if (ppm_.size() <= static_cast<size_t>(u8at(p))) ppm_.resize(u8at(p) + 1);
        if (!ppm_[u8at(p)].empty()) throw Error("Zppm " + std::to_string(u8at(p)) + " already read");
        ppm_[u8at(p)].assign(d_ + p + 1, d_ + end);
        has_ppm_ = true;
        break;
      case 0xFF61:  // opj_j2k_read_ppt: Zppt, then Ippt, merged in Zppt's order
        count(kPPT);
        if (end - p < 2) throw Error("error reading the PPT marker (too short)");
        if (has_ppm_) throw Error("a PPT marker after a PPM marker in the main header");
        if (t.ppt.size() <= static_cast<size_t>(u8at(p))) t.ppt.resize(u8at(p) + 1);
        if (!t.ppt[u8at(p)].empty()) throw Error("Zppt " + std::to_string(u8at(p)) + " already read");
        t.ppt[u8at(p)].assign(d_ + p + 1, d_ + end);
        t.has_ppt = true;
        break;
      case 0xFF50:
        part_two("the CAP marker (HTJ2K, part 15)");
      case 0xFF59: case 0xFF74: case 0xFF75: case 0xFF77: case 0xFF78:
        part_two("marker " + hex(m) + " (CPF, MCT, MCC, MCO or CBD: multiple component transforms)");
      case 0xFF64:
        count(kCOM);
        break;
      case 0xFF55:
        count(kTLM);
        break;
      case 0xFF58:  // opj_j2k_read_plt: Zplt, then packet lengths, the last one complete
        count(kPLT);
        if (p >= end || (end - p > 1 && (u8at(end - 1) & 0x80))) throw Error("malformed PLT marker segment");
        break;
      default:  // PLM and CRG, which openjpeg reads and decoding does not use
        break;
    }
    pos_ = end;
  }

  void read_siz(size_t p, size_t end) {
    if (end - p < 36) throw Error("SIZ too short");
    const int rsiz = u16at(p);
    if (rsiz & 0x4000) part_two("HTJ2K (Rsiz bit 14, part 15)");
    x1_ = u32at(p + 2);
    y1_ = u32at(p + 6);
    x0_ = u32at(p + 10);
    y0_ = u32at(p + 14);
    tdx_ = u32at(p + 18);
    tdy_ = u32at(p + 22);
    tx0_ = u32at(p + 26);
    ty0_ = u32at(p + 30);
    const int nc = u16at(p + 34);
    if (nc < 1 || nc > 16384 || end - p != static_cast<size_t>(36 + 3 * nc)) throw Error("bad SIZ marker size");
    if (x0_ >= x1_ || y0_ >= y1_) throw Error("empty image area in SIZ");
    if (tdx_ == 0 || tdy_ == 0) throw Error("zero tile size in SIZ");
    if (tx0_ > x0_ || ty0_ > y0_ || tx0_ + tdx_ <= x0_ || ty0_ + tdy_ <= y0_)
      throw Error("bad tile origin in SIZ");
    comps_.resize(nc);
    for (int c = 0; c < nc; ++c) {
      const int s = u8at(p + 36 + 3 * c);
      comps_[c].prec = (s & 0x7F) + 1;
      comps_[c].sgnd = (s >> 7) != 0;
      comps_[c].dx = u8at(p + 37 + 3 * c);
      comps_[c].dy = u8at(p + 38 + 3 * c);
      if (comps_[c].prec > 31) throw Error("precision above 31 bits");
      if (comps_[c].dx < 1 || comps_[c].dy < 1)
        throw Error("invalid XRsiz or YRsiz for component " + std::to_string(c) + " (between 1 and 255)");
    }
    tw_ = static_cast<int>(ceildiv(x1_ - tx0_, tdx_));
    th_ = static_cast<int>(ceildiv(y1_ - ty0_, tdy_));
    if (static_cast<int64_t>(tw_) * th_ > 65535) throw Error("too many tiles");
    def_.tccps.assign(nc, Tccp());
    resno_decoded_.assign(nc, 0);
    siz_ = true;
  }

  // SPcod / SPcoc into one component's style.
  size_t read_spcod(Tccp& c, size_t p, size_t end, bool precincts) {
    if (p + 5 > end) throw Error("COD/COC too short");
    c.numres = u8at(p) + 1;
    if (c.numres > 33) throw Error("more than 32 decomposition levels");
    c.cblkw = u8at(p + 1) + 2;
    c.cblkh = u8at(p + 2) + 2;
    if (c.cblkw > 10 || c.cblkh > 10 || c.cblkw + c.cblkh > 12) throw Error("bad code-block size");
    c.cblksty = u8at(p + 3);
    if (c.cblksty & 0x80) throw Error("code-block style 0x80 (mixed HT), which openjpeg refuses");
    if (c.cblksty & 0x40) part_two("HTJ2K code-blocks (code-block style bit 0x40, part 15)");
    c.qmfbid = u8at(p + 4);
    if (c.qmfbid > 1) part_two("an arbitrary wavelet transform");
    p += 5;
    if (end - p != static_cast<size_t>(precincts ? c.numres : 0)) throw Error("bad COD/COC marker size");
    for (int r = 0; r < c.numres; ++r) {
      if (precincts) {
        if (p >= end) throw Error("COD/COC too short for its precinct sizes");
        const int v = u8at(p++);
        c.prcw[r] = v & 0xF;
        c.prch[r] = v >> 4;
        if (r && (c.prcw[r] == 0 || c.prch[r] == 0)) throw Error("invalid precinct size");
      } else {
        c.prcw[r] = c.prch[r] = 15;
      }
    }
    return p;
  }

  void read_cod(Tcp& t, size_t p, size_t end) {
    if (end - p < 5) throw Error("COD too short");
    t.csty = u8at(p);
    if (t.csty & ~7) throw Error("unknown Scod value in COD marker");
    t.prg = u8at(p + 1);  // openjpeg keeps an unknown order and fails where it is used (not under POC)
    t.numlayers = u16at(p + 2);
    if (t.numlayers == 0) throw Error("zero layers");
    t.mct = u8at(p + 4);
    if (t.mct > 1) part_two("a multiple component transform other than RCT/ICT");
    Tccp c = t.tccps[0];
    read_spcod(c, p + 5, end, t.csty & 1);
    for (auto& tc : t.tccps) {  // openjpeg copies the style to every component
      tc.numres = c.numres;
      tc.cblkw = c.cblkw;
      tc.cblkh = c.cblkh;
      tc.cblksty = c.cblksty;
      tc.qmfbid = c.qmfbid;
      std::copy(c.prcw, c.prcw + 33, tc.prcw);
      std::copy(c.prch, c.prch + 33, tc.prch);
    }
    t.cod = true;
  }

  void read_coc(Tcp& t, size_t p, size_t end) {
    const bool wide = comps_.size() > 256;
    const int c = wide ? u16at(p) : u8at(p);
    if (c >= static_cast<int>(comps_.size())) throw Error("COC for a missing component");
    p += wide ? 2 : 1;
    const int scoc = u8at(p);
    if (scoc & ~1) throw Error("unknown Scoc value in COC marker");
    read_spcod(t.tccps[c], p + 1, end, scoc & 1);
  }

  // opj_j2k_read_rgn: Crgn, Srgn (not checked), SPrgn into the component's
  // ROI shift.
  void read_rgn(Tcp& t, size_t p, size_t end) {
    const bool wide = comps_.size() > 256;
    if (end - p != static_cast<size_t>(wide ? 4 : 3)) throw Error("error reading the RGN marker (bad size)");
    const int c = wide ? u16at(p) : u8at(p);
    if (c >= static_cast<int>(comps_.size())) throw Error("bad component number in RGN");
    t.tccps[c].roishift = u8at(end - 1);
  }

  // opj_j2k_read_poc: RSpoc, CSpoc, LYEpoc (at most the layers known then:
  // none before the main header's COD), REpoc, CEpoc (at most the
  // components), Ppoc; at most 31 changes a tile.
  void read_poc(Tcp& t, size_t p, size_t end, bool before_cod) {
    const int room = comps_.size() > 256 ? 2 : 1;
    const size_t chunk = 5 + 2 * room;
    if (end == p || (end - p) % chunk) throw Error("error reading the POC marker (bad size)");
    if (t.pocs.size() + (end - p) / chunk >= 32) throw Error("too many progression order changes (32 or more)");
    for (; p < end; p += chunk) {
      Poc c;
      c.resno0 = u8at(p);
      c.compno0 = room == 1 ? u8at(p + 1) : u16at(p + 1);
      c.layno1 = std::min(u16at(p + 1 + room), before_cod ? 0 : t.numlayers);
      c.resno1 = u8at(p + 3 + room);
      c.compno1 = std::min(room == 1 ? u8at(p + 4 + room) : u16at(p + 4 + room), static_cast<int>(comps_.size()));
      c.prg = u8at(p + 4 + 2 * room);
      t.pocs.push_back(c);
    }
  }

  // opj_j2k_merge_ppm: the Ippm bytes of every PPM segment in Zppm's order,
  // the Nppm fields taken out (a tile-part's headers may run on into the
  // next segment).
  void merge_ppm() {
    size_t remaining = 0;
    for (const auto& seg : ppm_) {
      if (seg.empty()) continue;
      size_t i = 0, n = seg.size();
      if (remaining >= n) {
        ppm_data_.insert(ppm_data_.end(), seg.begin(), seg.end());
        remaining -= n;
        continue;
      }
      ppm_data_.insert(ppm_data_.end(), seg.begin(), seg.begin() + remaining);
      i = remaining;
      remaining = 0;
      while (i < n) {
        if (n - i < 4) throw Error("not enough bytes to read Nppm");
        const size_t nppm = (size_t(seg[i]) << 24) | (size_t(seg[i + 1]) << 16) | (size_t(seg[i + 2]) << 8) | seg[i + 3];
        i += 4;
        const size_t take = std::min(nppm, n - i);
        ppm_data_.insert(ppm_data_.end(), seg.begin() + i, seg.begin() + i + take);
        i += take;
        remaining = nppm - take;
      }
    }
    if (remaining) throw Error("corrupted PPM markers (Nppm runs past the last one)");
  }

  void read_qcx(Tcp& t, size_t p, size_t end, int comp) {
    if (comp >= static_cast<int>(comps_.size())) throw Error("QCC for a missing component");
    // opj_j2k_read_SQcd_SQcc reads into the component (the first for QCD,
    // then copied to every one): step sizes the marker does not give stay.
    Tccp& q = t.tccps[comp < 0 ? 0 : comp];
    const int s = u8at(p);
    q.qntsty = s & 0x1F;
    q.numgbits = s >> 5;
    ++p;
    int n;
    if (q.qntsty == 0) {
      n = static_cast<int>(end - p);
      for (int i = 0; i < n && i < 97; ++i) q.steps[i] = StepSize{u8at(p + i) >> 3, 0};
    } else {  // openjpeg reads every other style as expounded
      n = q.qntsty == 1 ? 1 : static_cast<int>((end - p) / 2);
      if (n < 1 || end - p != static_cast<size_t>(2 * n)) throw Error("bad QCD/QCC marker size");
      for (int i = 0; i < n && i < 97; ++i) {
        const int v = u16at(p + 2 * i);
        q.steps[i] = StepSize{v >> 11, v & 0x7FF};
      }
      if (q.qntsty == 1) {
        count(kDerived);
        for (int b = 1; b < 97; ++b)
          q.steps[b] = StepSize{std::max(q.steps[0].expn - (b - 1) / 3, 0), q.steps[0].mant};
      }
    }
    if (comp < 0) {
      for (auto& tc : t.tccps) {
        tc.qntsty = q.qntsty;
        tc.numgbits = q.numgbits;
        std::copy(q.steps, q.steps + 97, tc.steps);
      }
    }
  }

  // opj_tcd_init_tile: the geometry of each component's resolutions,
  // bands, precincts and code-blocks, and each band's step size.
  void init_tile(int t, const Tcp& tcp, std::vector<TileComp>& tcs) {
    const int p = t % tw_, q = t / tw_;
    const int64_t tx0 = std::max(tx0_ + p * tdx_, x0_), ty0 = std::max(ty0_ + q * tdy_, y0_);
    const int64_t tx1 = std::min(tx0_ + (p + 1) * tdx_, x1_), ty1 = std::min(ty0_ + (q + 1) * tdy_, y1_);
    tcs.resize(comps_.size());
    for (size_t ci = 0; ci < comps_.size(); ++ci) {
      const Tccp& cp = tcp.tccps[ci];
      TileComp& tc = tcs[ci];
      tc.x0 = ceildiv(tx0, comps_[ci].dx);
      tc.y0 = ceildiv(ty0, comps_[ci].dy);
      tc.x1 = ceildiv(tx1, comps_[ci].dx);
      tc.y1 = ceildiv(ty1, comps_[ci].dy);
      tc.numres = cp.numres;
      tc.res.assign(cp.numres, Resolution());
      tc.data.assign(static_cast<size_t>((tc.x1 - tc.x0) * (tc.y1 - tc.y0)), 0);
      for (int r = 0; r < cp.numres; ++r) {
        Resolution& res = tc.res[r];
        const int level = cp.numres - 1 - r;
        res.x0 = ceildivpow2(tc.x0, level);
        res.y0 = ceildivpow2(tc.y0, level);
        res.x1 = ceildivpow2(tc.x1, level);
        res.y1 = ceildivpow2(tc.y1, level);
        res.pdx = cp.prcw[r];
        res.pdy = cp.prch[r];
        const int64_t px0 = floordivpow2(res.x0, res.pdx) << res.pdx, py0 = floordivpow2(res.y0, res.pdy) << res.pdy;
        const int64_t px1 = ceildivpow2(res.x1, res.pdx) << res.pdx, py1 = ceildivpow2(res.y1, res.pdy) << res.pdy;
        res.pw = res.x0 == res.x1 ? 0 : static_cast<int>((px1 - px0) >> res.pdx);
        res.ph = res.y0 == res.y1 ? 0 : static_cast<int>((py1 - py0) >> res.pdy);
        if (res.pw * res.ph > 1) count(kPrecincts);
        int64_t cbgx0, cbgy0;
        int cbgw, cbgh;
        if (r == 0) {
          cbgx0 = px0;
          cbgy0 = py0;
          cbgw = res.pdx;
          cbgh = res.pdy;
        } else {
          cbgx0 = ceildivpow2(px0, 1);
          cbgy0 = ceildivpow2(py0, 1);
          cbgw = res.pdx - 1;
          cbgh = res.pdy - 1;
        }
        const int cbw = std::min(cp.cblkw, cbgw), cbh = std::min(cp.cblkh, cbgh);
        const int nbands = r == 0 ? 1 : 3;
        res.bands.resize(nbands);
        for (int b = 0; b < nbands; ++b) {
          Band& band = res.bands[b];
          band.bandno = r == 0 ? 0 : b + 1;
          if (r == 0) {
            band.x0 = ceildivpow2(tc.x0, level);
            band.y0 = ceildivpow2(tc.y0, level);
            band.x1 = ceildivpow2(tc.x1, level);
            band.y1 = ceildivpow2(tc.y1, level);
          } else {
            const int64_t xb = band.bandno & 1, yb = band.bandno >> 1;
            band.x0 = ceildivpow2(tc.x0 - (xb << level), level + 1);
            band.y0 = ceildivpow2(tc.y0 - (yb << level), level + 1);
            band.x1 = ceildivpow2(tc.x1 - (xb << level), level + 1);
            band.y1 = ceildivpow2(tc.y1 - (yb << level), level + 1);
          }
          const StepSize& ss = cp.steps[r == 0 ? 0 : 3 * (r - 1) + b + 1];
          // BUG_WEIRD_TWO_INVK: openjpeg decodes 9/7 bands with gain 0.
          const int gain = cp.qmfbid == 0 ? 0 : (band.bandno == 0 ? 0 : (band.bandno == 3 ? 2 : 1));
          const int rb = comps_[ci].prec + gain;
          band.stepsize = static_cast<float>((1.0 + ss.mant / 2048.0) * std::pow(2.0, rb - ss.expn));
          band.numbps = ss.expn + cp.numgbits - 1;
          band.precincts.assign(static_cast<size_t>(res.pw) * res.ph, Precinct());
          for (int pn = 0; pn < res.pw * res.ph; ++pn) {
            Precinct& pr = band.precincts[pn];
            const int64_t sx = cbgx0 + static_cast<int64_t>(pn % res.pw) * (int64_t(1) << cbgw);
            const int64_t sy = cbgy0 + static_cast<int64_t>(pn / res.pw) * (int64_t(1) << cbgh);
            pr.x0 = static_cast<int>(std::max(sx, band.x0));
            pr.y0 = static_cast<int>(std::max(sy, band.y0));
            pr.x1 = static_cast<int>(std::min(sx + (int64_t(1) << cbgw), band.x1));
            pr.y1 = static_cast<int>(std::min(sy + (int64_t(1) << cbgh), band.y1));
            const int64_t bx0 = floordivpow2(pr.x0, cbw) << cbw, by0 = floordivpow2(pr.y0, cbh) << cbh;
            const int64_t bx1 = ceildivpow2(pr.x1, cbw) << cbw, by1 = ceildivpow2(pr.y1, cbh) << cbh;
            pr.cw = static_cast<int>(std::max<int64_t>((bx1 - bx0) >> cbw, 0));
            pr.ch = static_cast<int>(std::max<int64_t>((by1 - by0) >> cbh, 0));
            pr.cblks.assign(static_cast<size_t>(pr.cw) * pr.ch, Cblk());
            for (int k = 0; k < pr.cw * pr.ch; ++k) {
              Cblk& cb = pr.cblks[k];
              const int64_t cx = bx0 + static_cast<int64_t>(k % pr.cw) * (int64_t(1) << cbw);
              const int64_t cy = by0 + static_cast<int64_t>(k / pr.cw) * (int64_t(1) << cbh);
              cb.x0 = static_cast<int>(std::max<int64_t>(cx, pr.x0));
              cb.y0 = static_cast<int>(std::max<int64_t>(cy, pr.y0));
              cb.x1 = static_cast<int>(std::min<int64_t>(cx + (int64_t(1) << cbw), pr.x1));
              cb.y1 = static_cast<int>(std::min<int64_t>(cy + (int64_t(1) << cbh), pr.y1));
            }
            pr.incl.init(pr.cw, pr.ch);
            pr.imsb.init(pr.cw, pr.ch);
          }
        }
      }
    }
  }

  struct Packet {
    int layer, res, comp, prec, prog;  // prog: which progression (POC change) gave it
  };

  // pi.c: the packets of a tile, each once (openjpeg's include array,
  // shared by every progression): the tile's progression order over every
  // layer, resolution and component, or each of its progression order
  // changes in turn over its ranges (opj_pi_update_decode_poc: layers from
  // 0 to LYEpoc, at most the tile's). A change whose first component is
  // out of range, or whose order is not one of the five, gives no packets.
  std::vector<Packet> packets(const Tcp& tcp, const std::vector<TileComp>& tcs, int64_t tx0, int64_t ty0,
                              int64_t tx1, int64_t ty1) {
    const int nc = static_cast<int>(tcs.size());
    int maxres = 0;
    for (const auto& tc : tcs) maxres = std::max(maxres, tc.numres);
    std::vector<std::vector<std::vector<uint8_t>>> seen(nc);
    for (int c = 0; c < nc; ++c) {
      seen[c].resize(tcs[c].numres);
      for (int r = 0; r < tcs[c].numres; ++r)
        seen[c][r].assign(static_cast<size_t>(tcs[c].res[r].pw) * tcs[c].res[r].ph * tcp.numlayers, 0);
    }
    std::vector<Packet> out;
    std::vector<Poc> progs = tcp.pocs;
    if (progs.empty()) {
      if (tcp.prg > 4) throw Error("unknown progression order " + std::to_string(tcp.prg) + " in COD");
      Poc all;
      all.resno1 = maxres;
      all.compno1 = nc;
      all.layno1 = tcp.numlayers;
      all.prg = tcp.prg;
      progs.push_back(all);
    }
    for (size_t i = 0; i < progs.size(); ++i)
      progression(progs[i], static_cast<int>(i), std::min(progs[i].layno1, tcp.numlayers), tcp.numlayers, tcs, seen,
                  tx0, ty0, tx1, ty1, out);
    return out;
  }

  // The minimum precinct step, in reference grid units, over components
  // [c0, c1) (opj_pi_next_rpcl's dx and dy); 0 where none fits 32 bits.
  void steps(const std::vector<TileComp>& tcs, int c0, int c1, int64_t& dx, int64_t& dy) {
    dx = dy = 0;
    for (int c = c0; c < c1; ++c)
      for (int r = 0; r < tcs[c].numres; ++r) {
        const int level = tcs[c].numres - 1 - r;
        const Resolution& res = tcs[c].res[r];
        const int sx = res.pdx + level, sy = res.pdy + level;
        if (sx < 32 && comps_[c].dx <= (int64_t(UINT32_MAX) >> sx)) {
          const int64_t v = int64_t(comps_[c].dx) << sx;
          dx = dx ? std::min(dx, v) : v;
        }
        if (sy < 32 && comps_[c].dy <= (int64_t(UINT32_MAX) >> sy)) {
          const int64_t v = int64_t(comps_[c].dy) << sy;
          dy = dy ? std::min(dy, v) : v;
        }
      }
  }

  void progression(const Poc& poc, int prog, int layno1, int numlayers, const std::vector<TileComp>& tcs,
                   std::vector<std::vector<std::vector<uint8_t>>>& seen, int64_t tx0, int64_t ty0, int64_t tx1,
                   int64_t ty1, std::vector<Packet>& out) {
    const int nc = static_cast<int>(tcs.size());
    if (poc.compno0 >= nc || poc.prg > 4) return;
    const int c0 = poc.compno0, c1 = poc.compno1;
    auto emit = [&](int l, int r, int c, int pn) {
      uint8_t& s = seen[c][r][static_cast<size_t>(pn) * numlayers + l];
      if (!s) {
        s = 1;
        out.push_back(Packet{l, r, c, pn, prog});
      }
    };
    if (poc.prg == 0 || poc.prg == 1) {  // LRCP, RLCP
      const bool lrcp = poc.prg == 0;
      for (int a = lrcp ? 0 : poc.resno0; a < (lrcp ? layno1 : poc.resno1); ++a)
        for (int b = lrcp ? poc.resno0 : 0; b < (lrcp ? poc.resno1 : layno1); ++b)
          for (int c = c0; c < c1; ++c) {
            const int l = lrcp ? a : b, r = lrcp ? b : a;
            if (r >= tcs[c].numres) continue;
            const Resolution& res = tcs[c].res[r];
            for (int pn = 0; pn < res.pw * res.ph; ++pn) emit(l, r, c, pn);
          }
      return;
    }
    // One (resolution, component) at position (x, y): its precinct there,
    // if a precinct starts there (opj_pi_next_rpcl's tests).
    auto at = [&](int r, int c, int64_t x, int64_t y, int& pn) -> bool {
      const TileComp& tc = tcs[c];
      if (r >= tc.numres) return false;
      const Resolution& res = tc.res[r];
      const int level = tc.numres - 1 - r;
      const int64_t cdx = int64_t(comps_[c].dx) << level, cdy = int64_t(comps_[c].dy) << level;
      if (cdx > UINT32_MAX || cdy > UINT32_MAX) return false;
      const int64_t trx0 = ceildiv(tx0, cdx), try0 = ceildiv(ty0, cdy);
      const int64_t trx1 = ceildiv(tx1, cdx), try1 = ceildiv(ty1, cdy);
      const int rpx = res.pdx + level, rpy = res.pdy + level;  // at most 15 + 32: 64-bit arithmetic
      if (!((y % (int64_t(comps_[c].dy) << rpy) == 0) || (y == ty0 && ((try0 << level) % (int64_t(1) << rpy)))))
        return false;
      if (!((x % (int64_t(comps_[c].dx) << rpx) == 0) || (x == tx0 && ((trx0 << level) % (int64_t(1) << rpx)))))
        return false;
      if (res.pw == 0 || res.ph == 0) return false;
      if (trx0 == trx1 || try0 == try1) return false;
      const int64_t prci = floordivpow2(ceildiv(x, cdx), res.pdx) - floordivpow2(trx0, res.pdx);
      const int64_t prcj = floordivpow2(ceildiv(y, cdy), res.pdy) - floordivpow2(try0, res.pdy);
      pn = static_cast<int>(prci + prcj * res.pw);
      return pn >= 0 && pn < res.pw * res.ph;
    };
    auto layers = [&](int r, int c, int pn) {
      for (int l = 0; l < layno1; ++l) emit(l, r, c, pn);
    };
    int pn;
    int64_t dx = 0, dy = 0;
    auto ys = [&](auto body) {
      for (int64_t y = ty0; y < ty1; y += dy - (y % dy)) body(y);
    };
    auto xs = [&](auto body) {
      for (int64_t x = tx0; x < tx1; x += dx - (x % dx)) body(x);
    };
    if (poc.prg == 2 || poc.prg == 3) {
      steps(tcs, 0, nc, dx, dy);
      if (!dx || !dy) return;
    }
    if (poc.prg == 2) {  // RPCL
      for (int r = poc.resno0; r < poc.resno1; ++r)
        ys([&](int64_t y) {
          xs([&](int64_t x) {
            for (int c = c0; c < c1; ++c)
              if (at(r, c, x, y, pn)) layers(r, c, pn);
          });
        });
    } else if (poc.prg == 3) {  // PCRL
      ys([&](int64_t y) {
        xs([&](int64_t x) {
          for (int c = c0; c < c1; ++c)
            for (int r = poc.resno0; r < std::min(poc.resno1, tcs[c].numres); ++r)
              if (at(r, c, x, y, pn)) layers(r, c, pn);
        });
      });
    } else {  // CPRL: the step of each component alone
      for (int c = c0; c < c1; ++c) {
        steps(tcs, c, c + 1, dx, dy);
        if (!dx || !dy) return;
        ys([&](int64_t y) {
          xs([&](int64_t x) {
            for (int r = poc.resno0; r < std::min(poc.resno1, tcs[c].numres); ++r)
              if (at(r, c, x, y, pn)) layers(r, c, pn);
          });
        });
      }
    }
  }

  // opj_t2_init_seg: a code-block's segment `index`, empty, with the passes
  // it may hold under the code-block style.
  static void init_seg(Cblk& cb, int index, int sty, bool first) {
    if (static_cast<int>(cb.segs.size()) <= index) cb.segs.resize(index + 1);
    Seg& seg = cb.segs[index];
    seg = Seg();
    if (sty & kTermAll) seg.maxpasses = 1;
    else if (sty & kLazy) seg.maxpasses = first ? 10 : ((cb.segs[index - 1].maxpasses == 1 ||
                                                        cb.segs[index - 1].maxpasses == 10) ? 2 : 1);
    else seg.maxpasses = 109;
  }

  // Where a tile's packet headers are read: the bit stream itself, the PPM
  // data (every tile's, in turn) or the tile's PPT data.
  struct Headers {
    const uint8_t* base;
    size_t n;
    size_t* at;
    bool packed;
  };

  // opj_t2_read_packet_header and opj_t2_read_packet_data.
  void read_packet(const Tcp& tcp, TileComp& tc, const Packet& pk, const std::vector<uint8_t>& data, size_t& at,
                   const Headers& hs) {
    const uint8_t* base = data.data();
    const size_t n = data.size();
    if (tcp.csty & 2) {  // SOP, in the bit stream
      if (at + 6 <= n && base[at] == 0xFF && base[at + 1] == 0x91) at += 6;
    }
    const int sty = tcp.tccps[pk.comp].cblksty;
    Resolution& res = tc.res[pk.res];
    size_t& hat = hs.packed ? *hs.at : at;
    const uint8_t* hbase = hs.packed ? hs.base : base;
    const size_t hn = hs.packed ? hs.n : n;
    Bio bio(hbase + std::min(hat, hn), hbase + hn);
    const int present = bio.bit();
    if (present) {
      for (auto& band : res.bands) {
        if (band.empty()) continue;
        Precinct& pr = band.precincts[pk.prec];
        for (int k = 0; k < pr.cw * pr.ch; ++k) {
          Cblk& cb = pr.cblks[k];
          int included;
          if (!cb.numsegs) included = pr.incl.decode(bio, k, pk.layer + 1);
          else included = bio.bit();
          if (!included) {
            cb.newpasses = 0;
            continue;
          }
          if (!cb.numsegs) {
            int i = 0;
            while (!pr.imsb.decode(bio, k, i)) ++i;
            cb.numbps = band.numbps + 1 - i;
            cb.numlenbits = 3;
          }
          int np;
          if (!bio.bit()) np = 1;
          else if (!bio.bit()) np = 2;
          else {
            const int v = static_cast<int>(bio.read(2));
            if (v != 3) np = 3 + v;
            else {
              const int w = static_cast<int>(bio.read(5));
              np = w != 31 ? 6 + w : 37 + static_cast<int>(bio.read(7));
            }
          }
          int inc = 0;
          while (bio.bit()) ++inc;
          cb.numlenbits += inc;
          int segno = 0;
          if (!cb.numsegs) {
            init_seg(cb, 0, sty, true);
          } else {
            segno = cb.numsegs - 1;
            if (cb.segs[segno].passes == cb.segs[segno].maxpasses) init_seg(cb, ++segno, sty, false);
          }
          for (int left = np;;) {
            Seg& seg = cb.segs[segno];
            seg.newpasses = std::min(seg.maxpasses - seg.passes, left);
            int bits = cb.numlenbits;
            for (int v = seg.newpasses; v > 1; v >>= 1) ++bits;
            if (bits > 32) throw Error("bad code-block length bits");
            seg.newlen = bio.read(bits);
            left -= seg.newpasses;
            if (left <= 0) break;
            init_seg(cb, ++segno, sty, false);
          }
          cb.newpasses = np;
        }
      }
    }
    bio.inalign();
    hat = std::min(hat, hn) + bio.numbytes();
    if (tcp.csty & 4) {  // EPH, where the header is; openjpeg 2.5 fails without it
      if (hat + 2 > hn) throw Error("not enough space for the required EPH marker");
      if (hbase[hat] != 0xFF || hbase[hat + 1] != 0x92) throw Error("expected an EPH marker after a packet header");
      hat += 2;
    }
    if (!present) return;
    for (auto& band : res.bands) {
      if (band.empty()) continue;
      Precinct& pr = band.precincts[pk.prec];
      for (auto& cb : pr.cblks) {
        if (!cb.newpasses) continue;
        int segno = 0;
        if (!cb.numsegs) {
          cb.numsegs = 1;
        } else {
          segno = cb.numsegs - 1;
          if (cb.segs[segno].passes == cb.segs[segno].maxpasses) {
            ++segno;
            ++cb.numsegs;
          }
        }
        while (true) {
          Seg& seg = cb.segs[segno];
          if (seg.newlen > n - std::min(at, n))
            throw Error("truncated codestream: a code-block's data ends past its tile's data");
          cb.data.insert(cb.data.end(), base + at, base + at + seg.newlen);
          at += seg.newlen;
          seg.len += seg.newlen;
          seg.passes += seg.newpasses;
          cb.newpasses -= seg.newpasses;
          if (cb.newpasses <= 0) break;
          ++segno;
          ++cb.numsegs;
        }
      }
    }
  }

  void decode_tile(int t, const std::vector<uint8_t>& data, uint8_t* out, int64_t* table) {
    const Tcp& tcp = tcps_[t];
    std::vector<TileComp> tcs;
    init_tile(t, tcp, tcs);
    const int p = t % tw_, q = t / tw_;
    const int64_t tx0 = std::max(tx0_ + p * tdx_, x0_), ty0 = std::max(ty0_ + q * tdy_, y0_);
    const int64_t tx1 = std::min(tx0_ + (p + 1) * tdx_, x1_), ty1 = std::min(ty0_ + (q + 1) * tdy_, y1_);
    if (tcp.pocs.empty()) count(kLRCP + tcp.prg);
    if (tcp.numlayers > 1) count(kLayers);
    if (tcp.csty & 2) count(kSOP);
    if (tcp.csty & 4) count(kEPH);
    // opj_j2k_merge_ppt: the tile's PPT data in Zppt's order.
    std::vector<uint8_t> ppt;
    for (const auto& seg : tcp.ppt) ppt.insert(ppt.end(), seg.begin(), seg.end());
    size_t ppt_at = 0;
    Headers hs{nullptr, 0, nullptr, false};
    if (has_ppm_) hs = Headers{ppm_data_.data(), ppm_data_.size(), &ppm_at_, true};
    else if (tcp.has_ppt) hs = Headers{ppt.data(), ppt.size(), &ppt_at, true};
    // opj_t2_decode_packets: a packet none of whose precincts holds a sample
    // is skipped (read, not decoded), and a component whose packets of a
    // progression have all been skipped so far, with none decoded before,
    // counts as decoded to its last resolution (first_pass_failed).
    size_t at = 0;
    std::vector<uint8_t> first_pass_failed;
    int prog = -1;
    for (const Packet& pk : packets(tcp, tcs, tx0, ty0, tx1, ty1)) {
      if (pk.prog != prog) {
        first_pass_failed.assign(tcs.size(), 1);
        prog = pk.prog;
      }
      read_packet(tcp, tcs[pk.comp], pk, data, at, hs);
      bool skip = true;
      for (const auto& band : tcs[pk.comp].res[pk.res].bands) {
        const Precinct& pr = band.precincts[pk.prec];
        if (pr.x0 < pr.x1 && pr.y0 < pr.y1) skip = false;
      }
      int& rd = resno_decoded_[pk.comp];
      if (!skip) {
        first_pass_failed[pk.comp] = 0;
        rd = std::max(rd, pk.res);
      }
      if (first_pass_failed[pk.comp] && rd == 0) rd = tcs[pk.comp].numres - 1;
    }
    // Tier 1 into each component's tile, then dequantisation.
    T1 t1;
    std::vector<int32_t> blk;
    std::vector<int> nres(tcs.size());
    for (size_t ci = 0; ci < tcs.size(); ++ci) {
      TileComp& tc = tcs[ci];
      const Tccp& cp = tcp.tccps[ci];
      const int64_t w = tc.x1 - tc.x0;
      count(cp.qmfbid == 1 ? kWavelet53 : kWavelet97);
      for (int b = 0; b < 6; ++b)
        if (cp.cblksty & (1 << b)) count(kStyleBypass + b);
      for (int r = 0; r < tc.numres; ++r)
        for (auto& band : tc.res[r].bands) {
          if (band.empty()) continue;
          for (auto& pr : band.precincts)
            for (auto& cb : pr.cblks) {
              const int cw = cb.x1 - cb.x0, ch = cb.y1 - cb.y0;
              if (cw <= 0 || ch <= 0) continue;
              blk.resize(static_cast<size_t>(cw) * ch);
              t1.decode(cb.data.data(), cb.segs, cb.numsegs, cw, ch, band.bandno, cb.numbps, cp.roishift, cp.cblksty,
                        blk.data());
              int64_t x = cb.x0 - band.x0, y = cb.y0 - band.y0;
              if (band.bandno & 1) x += tc.res[r - 1].x1 - tc.res[r - 1].x0;
              if (band.bandno & 2) y += tc.res[r - 1].y1 - tc.res[r - 1].y0;
              const float step = 0.5f * band.stepsize;
              for (int j = 0; j < ch; ++j) {
                int32_t* dst = tc.data.data() + (y + j) * w + x;
                const int32_t* src = blk.data() + static_cast<size_t>(j) * cw;
                if (cp.qmfbid == 1) {
                  for (int i = 0; i < cw; ++i) dst[i] = src[i] / 2;
                } else {
                  for (int i = 0; i < cw; ++i) {
                    const float v = static_cast<float>(src[i]) * step;
                    std::memcpy(&dst[i], &v, sizeof(v));
                  }
                }
              }
            }
        }
      // opj_tcd_dwt_decode: the resolutions up to the highest one decoded.
      nres[ci] = std::min(resno_decoded_[ci], tc.numres - 1) + 1;
      if (cp.qmfbid == 1) {
        idwt_2d(tc, tc.data.data(), nres[ci], idwt53_line);
      } else {
        idwt_2d(tc, reinterpret_cast<float*>(tc.data.data()), nres[ci], idwt97_line);
      }
    }
    // Multiple component transform (opj_tcd_mct_decode), over the first
    // component's samples.
    if (tcp.mct == 1 && tcs.size() >= 3) {
      const size_t n = tcs[0].data.size();
      if (tcs[1].data.size() != n || tcs[2].data.size() != n || tcs[0].numres != tcs[1].numres ||
          tcs[0].numres != tcs[2].numres || nres[0] != nres[1] || nres[0] != nres[2])
        throw Error("components of different sizes under a multiple component transform");
      if (tcp.tccps[0].qmfbid == 1) {
        count(kRCT);
        int32_t *c0 = tcs[0].data.data(), *c1 = tcs[1].data.data(), *c2 = tcs[2].data.data();
        for (size_t i = 0; i < n; ++i) {
          const int32_t y = c0[i], u = c1[i], v = c2[i];
          const int32_t g = y - ((u + v) >> 2);
          c0[i] = v + g;
          c1[i] = g;
          c2[i] = u + g;
        }
      } else {
        count(kICT);
        float* c0 = reinterpret_cast<float*>(tcs[0].data.data());
        float* c1 = reinterpret_cast<float*>(tcs[1].data.data());
        float* c2 = reinterpret_cast<float*>(tcs[2].data.data());
        for (size_t i = 0; i < n; ++i) {
          const float y = c0[i], u = c1[i], v = c2[i];
          const float r = y + (v * 1.402f);
          const float g = y - (u * 0.34413f) - (v * 0.71414f);
          const float b = y + (u * 1.772f);
          c0[i] = r;
          c1[i] = g;
          c2[i] = b;
        }
      }
    }
    // DC level shift and clamp (opj_tcd_dc_level_shift_decode) over the
    // decoded resolution, into the tile's buffer as opj_tcd_update_tile_data
    // writes it for Pillow: each component in turn, its samples in 1, 2 or
    // 4 bytes (little-endian).
    uint8_t* dst = out + table[4];
    for (size_t ci = 0; ci < tcs.size(); ++ci) {
      const TileComp& tc = tcs[ci];
      const CompInfo& ic = comps_[ci];
      const Resolution& rr = tc.res[nres[ci] - 1];
      const int64_t lo = ic.sgnd ? -(int64_t(1) << (ic.prec - 1)) : 0;
      const int64_t hi = ic.sgnd ? (int64_t(1) << (ic.prec - 1)) - 1 : (int64_t(1) << ic.prec) - 1;
      const int64_t shift = ic.sgnd ? 0 : int64_t(1) << (ic.prec - 1);
      const int64_t stride = tc.x1 - tc.x0, w = rr.x1 - rr.x0, h = rr.y1 - rr.y0;
      const int csiz = ic.prec <= 8 ? 1 : (ic.prec <= 16 ? 2 : 4);
      const bool real = tcp.tccps[ci].qmfbid == 0;
      for (int64_t y = 0; y < h; ++y) {
        const int32_t* src = tc.data.data() + y * stride;
        for (int64_t i = 0; i < w; ++i) {
          int64_t v;
          if (real) {
            float f;
            std::memcpy(&f, &src[i], sizeof(f));
            if (f > static_cast<float>(INT32_MAX)) v = hi;
            else if (f < static_cast<float>(INT32_MIN)) v = lo;
            else v = std::min(std::max(static_cast<int64_t>(std::lrintf(f)) + shift, lo), hi);
          } else {
            v = std::min(std::max(static_cast<int64_t>(src[i]) + shift, lo), hi);
          }
          const uint32_t u = static_cast<uint32_t>(static_cast<int32_t>(v));
          for (int b = 0; b < csiz; ++b) *dst++ = static_cast<uint8_t>(u >> (8 * b));
        }
      }
    }
    table[0] = tx0;
    table[1] = ty0;
    table[2] = tx1;
    table[3] = ty1;
    table[5] = (dst - out) - table[4];
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

// A codestream (SOC ... EOC). With out == nullptr: reads the main header
// and writes Decoder::dims into dims (7 + 4 * C entries; C at most
// (dims_cap - 7) / 4). Otherwise decodes every tile into out (out_cap
// bytes, at least dims[6]) and table (6 entries a tile, dims[5] tiles), as
// Decoder::decode. Returns the tile count (0 for the header alone), or -1
// with a message in err.
int64_t j2k_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t out_cap, int64_t* table, int64_t* dims,
                   int64_t dims_cap, char* err, int64_t err_cap) {
  try {
    Decoder d(data, static_cast<size_t>(n), out != nullptr);
    d.header();
    if (dims_cap < 7 + 4 * d.components()) throw Error("too many components");
    d.dims(dims);
    if (out == nullptr) return 0;
    if (out_cap < dims[6]) throw Error("output buffer too small");
    return d.decode(out, table);
  } catch (const std::exception& e) {
    set_error(err, err_cap, e.what());
    return -1;
  }
}

// The path counters (kCountN of them) since the last reset; reset != 0
// zeroes them after copying.
int64_t j2k_counts(int64_t* out, int64_t reset) {
  for (int i = 0; i < kCountN; ++i) out[i] = reset ? g_counts[i].exchange(0) : g_counts[i].load();
  return kCountN;
}

}  // extern "C"
