// The fixtures' JPEG 2000 encoder, its two inner loops (data/jpeg2000_encode.py
// writes the rest): the forward reversible 5/3 wavelet (T.800 Annex F, the
// exact inverse of the lifting that openjpeg's decoder runs, columns then
// rows at each level) and tier 1 (the MQ coder of Annex C and the
// significance, refinement and cleanup passes of Annex D with the run mode)
// in every code-block style of part one, every pass down to bit plane 0: a
// lossless code-block.
//
// Host library with a plain C interface, built with g++ into
// build/libjpeg2000_encode.so and loaded with ctypes. It writes test
// frames only; no loader reads through it.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

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

constexpr int kCtxSC = 9, kCtxMag = 14, kCtxAgg = 17, kCtxUni = 18, kNumCtx = 19;

// The MQ encoder of Annex C (ENCODE, RENORME, BYTEOUT, FLUSH), and the
// raw (bypass) coder of openjpeg's opj_mqc_bypass_enc.
struct MqEncoder {
  std::vector<uint8_t> out{0};  // out[0] is the byte before the first
  uint32_t a = 0x8000, c = 0;
  int ct = 12;
  uint8_t idx[kNumCtx], mps[kNumCtx];
  MqEncoder() { reset_states(); }
  void reset_states() {
    std::memset(idx, 0, sizeof(idx));
    std::memset(mps, 0, sizeof(mps));
    idx[kCtxUni] = 46;
    idx[kCtxAgg] = 3;
    idx[0] = 4;
  }
  // A new codeword segment: the coder starts over, the contexts stay.
  void restart() {
    out.assign(1, 0);
    a = 0x8000;
    c = 0;
    ct = 12;
  }
  void byteout() {
    if (out.back() == 0xFF) {
      out.push_back(static_cast<uint8_t>(c >> 20));
      c &= 0xFFFFF;
      ct = 7;
    } else if (c < 0x8000000) {
      out.push_back(static_cast<uint8_t>(c >> 19));
      c &= 0x7FFFF;
      ct = 8;
    } else {
      ++out.back();
      if (out.back() == 0xFF) {
        c &= 0x7FFFFFF;
        out.push_back(static_cast<uint8_t>(c >> 20));
        c &= 0xFFFFF;
        ct = 7;
      } else {
        out.push_back(static_cast<uint8_t>(c >> 19));
        c &= 0x7FFFF;
        ct = 8;
      }
    }
  }
  void renorm() {
    do {
      a <<= 1;
      c <<= 1;
      if (--ct == 0) byteout();
    } while ((a & 0x8000) == 0);
  }
  void encode(int cx, int d) {
    const MqState& s = kMq[idx[cx]];
    if (d == mps[cx]) {
      a -= s.qe;
      if ((a & 0x8000) == 0) {
        if (a < s.qe) a = s.qe;
        else c += s.qe;
        idx[cx] = s.nmps;
        renorm();
      } else {
        c += s.qe;
      }
    } else {
      a -= s.qe;
      if (a < s.qe) c += s.qe;
      else a = s.qe;
      if (s.sw) mps[cx] = static_cast<uint8_t>(1 - mps[cx]);
      idx[cx] = s.nlps;
      renorm();
    }
  }
  // FLUSH (Figure C.11) with SETBITS, or with `pterm` the predictable
  // termination of opj_mqc_erterm_enc; a final 0xFF is dropped.
  std::vector<uint8_t> flush(bool pterm) {
    if (pterm) {  // the byte opj_mqc_erterm_enc writes after these is not counted
      int k = 11 - ct + 1;
      while (k > 0) {
        c <<= ct;
        ct = 0;
        byteout();
        k -= ct;
      }
    } else {
      const uint32_t t = c + a;
      c |= 0xFFFF;
      if (c >= t) c -= 0x8000;
      c <<= ct;
      byteout();
      c <<= ct;
      byteout();
    }
    std::vector<uint8_t> data(out.begin() + 1, out.end());
    if (!data.empty() && data.back() == 0xFF) data.pop_back();
    return data;
  }
  // Raw bits: MSB first, seven bits in a byte after 0xFF.
  void raw(int d) {
    --ct;
    c += static_cast<uint32_t>(d) << ct;
    if (ct == 0) {
      out.push_back(static_cast<uint8_t>(c));
      ct = out.back() == 0xFF ? 7 : 8;
      c = 0;
    }
  }
  void raw_start() {
    out.assign(1, 0);
    c = 0;
    ct = 8;
  }
  // opj_mqc_bypass_flush_enc: the last byte's free bits 0, 1, 0, ...; a
  // last 0xFF with nothing after it is dropped (the decoder reads 1s there).
  std::vector<uint8_t> raw_flush(bool pterm) {
    if (ct < 7 || (ct == 7 && (pterm || out.back() != 0xFF))) {
      int bit = 0;
      while (ct > 0) {
        --ct;
        c += static_cast<uint32_t>(bit) << ct;
        bit = 1 - bit;
      }
      out.push_back(static_cast<uint8_t>(c));
    } else if (ct == 7 && out.back() == 0xFF) {
      out.pop_back();
    }
    return std::vector<uint8_t>(out.begin() + 1, out.end());
  }
};

int zc_context(int orient, int h, int v, int d) {
  if (orient == 1) std::swap(h, v);
  if (orient != 3) {
    if (!h) {
      if (!v) return d == 0 ? 0 : (d == 1 ? 1 : 2);
      return v == 1 ? 3 : 4;
    }
    if (h == 1) return v ? 7 : (d == 0 ? 5 : 6);
    return 8;
  }
  const int hv = h + v;
  if (!d) return hv == 0 ? 0 : (hv == 1 ? 1 : 2);
  if (d == 1) return hv == 0 ? 3 : (hv == 1 ? 4 : 5);
  if (d == 2) return hv == 0 ? 6 : 7;
  return 8;
}

constexpr uint8_t kSig = 1, kNeg = 2, kVisit = 4, kRefined = 8;
// Code-block style bits (SPcod/SPcoc).
constexpr int kLazy = 0x01, kReset = 0x02, kTermAll = 0x04, kVsc = 0x08, kPterm = 0x10, kSegSym = 0x20;

class T1Encoder {
 public:
  T1Encoder(const int32_t* band, int stride, int w, int h, int orient, int sty)
      : w_(w), h_(h), orient_(orient), sty_(sty) {
    mag_.resize(static_cast<size_t>(w) * h);
    flags_.assign(static_cast<size_t>(w + 2) * (h + 2), 0);
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const int32_t v = band[static_cast<size_t>(y) * stride + x];
        mag_[static_cast<size_t>(y) * w + x] = static_cast<uint32_t>(std::abs(v));
        if (v < 0) f(x, y) |= kNeg;
      }
  }
  // Codes every pass down to bit plane 0 in the codeword segments
  // openjpeg's decoder expects under the style (opj_t2_init_seg: one
  // segment; 10, then 2 raw and 1 arithmetic passes with bypass; one a
  // pass with termination at each pass), a segment raw where
  // opj_t1_decode_cblk reads it raw: its first pass a significance or
  // refinement pass at or below numbps - 4, numbps the decoder's (the bit
  // planes less the ROI shift `roishift`). Returns the bytes of the
  // segments one after another; bits = the magnitudes' bit length, segs
  // each segment's (bytes, passes).
  std::vector<uint8_t> encode(int roishift, int* bits, std::vector<std::pair<int, int>>* segs) {
    uint32_t mx = 0;
    for (uint32_t m : mag_) mx = std::max(mx, m);
    int k = 0;
    while (k < 32 && (mx >> k)) ++k;
    *bits = k;
    const int passes = k ? 3 * k - 2 : 0;
    std::vector<uint8_t> data;
    if (!passes) return data;
    const int numbps = k - roishift;
    int pass = 0, maxpasses = 0;
    while (pass < passes) {
      maxpasses = (sty_ & kTermAll) ? 1 : (sty_ & kLazy) ? (maxpasses == 0 ? 10 : (maxpasses == 2 ? 1 : 2)) : 109;
      const int n = std::min(maxpasses, passes - pass);
      const int passtype = pass == 0 ? 2 : (pass - 1) % 3, plane = k - 1 - (pass + 2) / 3;
      const bool raw = (sty_ & kLazy) && passtype < 2 && plane + 1 <= numbps - 4;
      if (raw) mq_.raw_start();
      else mq_.restart();
      for (int i = pass; i < pass + n; ++i) {
        const int t = i == 0 ? 2 : (i - 1) % 3, p = k - 1 - (i + 2) / 3;
        if (t == 0) sigpass(p, raw);
        else if (t == 1) refpass(p, raw);
        else clnpass(p);
        if ((sty_ & kReset) && !raw) mq_.reset_states();
      }
      const std::vector<uint8_t> seg = raw ? mq_.raw_flush(sty_ & kPterm) : mq_.flush(sty_ & kPterm);
      data.insert(data.end(), seg.begin(), seg.end());
      segs->emplace_back(static_cast<int>(seg.size()), n);
      pass += n;
    }
    return data;
  }

 private:
  int w_, h_, orient_, sty_;
  std::vector<uint32_t> mag_;
  std::vector<uint8_t> flags_;
  MqEncoder mq_;

  uint8_t& f(int x, int y) { return flags_[static_cast<size_t>(y + 1) * (w_ + 2) + (x + 1)]; }
  int sig(int x, int y) { return f(x, y) & kSig; }
  int bit(int x, int y, int p) { return (mag_[static_cast<size_t>(y) * w_ + x] >> p) & 1; }
  // Vertically causal contexts: a stripe's last row does not see the next.
  bool south_hidden(int y) const { return (sty_ & kVsc) && (y & 3) == 3; }
  bool any_neighbour(int x, int y) {
    const int north = sig(x - 1, y - 1) | sig(x, y - 1) | sig(x + 1, y - 1) | sig(x - 1, y) | sig(x + 1, y);
    if (south_hidden(y)) return north;
    return north | sig(x - 1, y + 1) | sig(x, y + 1) | sig(x + 1, y + 1);
  }
  int zc(int x, int y) {
    const bool s = !south_hidden(y);
    return zc_context(orient_, sig(x - 1, y) + sig(x + 1, y), sig(x, y - 1) + (s ? sig(x, y + 1) : 0),
                      sig(x - 1, y - 1) + sig(x + 1, y - 1) + (s ? sig(x - 1, y + 1) + sig(x + 1, y + 1) : 0));
  }
  int contribution(int x, int y) {
    const uint8_t g = f(x, y);
    return (g & kSig) ? ((g & kNeg) ? -1 : 1) : 0;
  }
  void encode_sign(int x, int y) {
    const int cw = contribution(x - 1, y), ce = contribution(x + 1, y);
    const int cn = contribution(x, y - 1), cs = south_hidden(y) ? 0 : contribution(x, y + 1);
    int hc = std::min((cw > 0) + (ce > 0), 1) - std::min((cw < 0) + (ce < 0), 1);
    int vc = std::min((cn > 0) + (cs > 0), 1) - std::min((cn < 0) + (cs < 0), 1);
    const int spb = (!hc && !vc) ? 0 : !(hc > 0 || (!hc && vc > 0));
    if (hc < 0) {
      hc = -hc;
      vc = -vc;
    }
    const int n = !hc ? (vc == 0 ? 0 : 1) : (vc == -1 ? 2 : (vc == 0 ? 3 : 4));
    mq_.encode(kCtxSC + n, ((f(x, y) & kNeg) ? 1 : 0) ^ spb);
    f(x, y) |= kSig;
  }
  void sigpass(int p, bool raw) {
    for (int k = 0; k < h_; k += 4)
      for (int x = 0; x < w_; ++x)
        for (int y = k; y < std::min(k + 4, h_); ++y) {
          if ((f(x, y) & (kSig | kVisit)) || !any_neighbour(x, y)) continue;
          const int b = bit(x, y, p);
          if (raw) {
            mq_.raw(b);
            if (b) {
              mq_.raw((f(x, y) & kNeg) ? 1 : 0);
              f(x, y) |= kSig;
            }
          } else {
            mq_.encode(zc(x, y), b);
            if (b) encode_sign(x, y);
          }
          f(x, y) |= kVisit;
        }
  }
  void refpass(int p, bool raw) {
    for (int k = 0; k < h_; k += 4)
      for (int x = 0; x < w_; ++x)
        for (int y = k; y < std::min(k + 4, h_); ++y) {
          uint8_t& g = f(x, y);
          if ((g & (kSig | kVisit)) != kSig) continue;
          if (raw) {
            mq_.raw(bit(x, y, p));
          } else {
            const int ctx = (g & kRefined) ? kCtxMag + 2 : (any_neighbour(x, y) ? kCtxMag + 1 : kCtxMag);
            mq_.encode(ctx, bit(x, y, p));
          }
          g |= kRefined;
        }
  }
  void clnpass(int p) {
    for (int k = 0; k < h_; k += 4)
      for (int x = 0; x < w_; ++x) {
        int start = k;
        if (k + 3 < h_) {
          bool run = true;
          for (int y = k; y < k + 4 && run; ++y)
            if ((f(x, y) & (kSig | kVisit)) || any_neighbour(x, y)) run = false;
          if (run) {
            int first = 4;
            for (int j = 0; j < 4; ++j)
              if (bit(x, k + j, p)) {
                first = j;
                break;
              }
            mq_.encode(kCtxAgg, first < 4);
            if (first == 4) continue;
            mq_.encode(kCtxUni, first >> 1);
            mq_.encode(kCtxUni, first & 1);
            start = k + first;
            encode_sign(x, start);
            ++start;
          }
        }
        for (int y = start; y < std::min(k + 4, h_); ++y) {
          if (f(x, y) & (kSig | kVisit)) continue;
          const int b = bit(x, y, p);
          mq_.encode(zc(x, y), b);
          if (b) encode_sign(x, y);
        }
      }
    for (int y = 0; y < h_; ++y)
      for (int x = 0; x < w_; ++x) f(x, y) &= static_cast<uint8_t>(~kVisit);
    if (sty_ & kSegSym)  // the segmentation symbol 1010 in the uniform context
      for (int b : {1, 0, 1, 0}) mq_.encode(kCtxUni, b);
  }
};

// One forward 5/3 line: n samples (the first at an even position) into
// lows then highs.
void fdwt53_line(int32_t* x, int n, std::vector<int32_t>& tmp) {
  if (n < 2) return;
  auto at = [&](int i) { return x[i < 0 ? -i : (i >= n ? 2 * (n - 1) - i : i)]; };
  for (int i = 1; i < n; i += 2) x[i] -= (at(i - 1) + at(i + 1)) >> 1;
  for (int i = 0; i < n; i += 2) x[i] += (at(i - 1) + at(i + 1) + 2) >> 2;
  tmp.resize(n);
  const int sn = (n + 1) / 2;
  for (int i = 0; i < n; ++i) tmp[(i & 1) ? sn + i / 2 : i / 2] = x[i];
  std::copy(tmp.begin(), tmp.end(), x);
}

}  // namespace

extern "C" {

// The forward 5/3 of a w x h component whose origin is (0, 0), `levels`
// levels in place (the Mallat layout openjpeg's decoder reads).
void j2k_fdwt53(int32_t* data, int64_t w, int64_t h, int64_t levels) {
  std::vector<int32_t> line, tmp;
  int64_t cw = w, ch = h;
  for (int64_t l = 0; l < levels; ++l) {
    line.resize(static_cast<size_t>(std::max(cw, ch)));
    for (int64_t x = 0; x < cw; ++x) {
      for (int64_t y = 0; y < ch; ++y) line[y] = data[y * w + x];
      fdwt53_line(line.data(), static_cast<int>(ch), tmp);
      for (int64_t y = 0; y < ch; ++y) data[y * w + x] = line[y];
    }
    for (int64_t y = 0; y < ch; ++y) fdwt53_line(data + y * w, static_cast<int>(cw), tmp);
    cw = (cw + 1) / 2;
    ch = (ch + 1) / 2;
  }
}

// Tier 1 of one code-block (w x h samples from `band`, rows `stride`
// apart) of band orientation `orient` (0 LL, 1 HL, 2 LH, 3 HH) in
// code-block style `sty`, its magnitudes shifted up by `roishift` where
// they lie in the region of interest (the caller's): writes up to `cap`
// bytes into out, info = (bit length of the largest magnitude, passes,
// segments) and each segment's (bytes, passes) into segs (2 * seg_cap
// entries); returns the byte count, or -1 if cap or seg_cap is too small.
int64_t j2k_t1_encode(const int32_t* band, int64_t stride, int64_t w, int64_t h, int64_t orient, int64_t sty,
                      int64_t roishift, uint8_t* out, int64_t cap, int64_t* info, int64_t* segs, int64_t seg_cap) {
  T1Encoder enc(band, static_cast<int>(stride), static_cast<int>(w), static_cast<int>(h), static_cast<int>(orient),
                static_cast<int>(sty));
  int bits = 0;
  std::vector<std::pair<int, int>> parts;
  const std::vector<uint8_t> data = enc.encode(static_cast<int>(roishift), &bits, &parts);
  info[0] = bits;
  info[1] = bits ? 3 * bits - 2 : 0;
  info[2] = static_cast<int64_t>(parts.size());
  if (static_cast<int64_t>(data.size()) > cap || static_cast<int64_t>(parts.size()) > seg_cap) return -1;
  for (size_t i = 0; i < parts.size(); ++i) {
    segs[2 * i] = parts[i].first;
    segs[2 * i + 1] = parts[i].second;
  }
  std::memcpy(out, data.data(), data.size());
  return static_cast<int64_t>(data.size());
}

}  // extern "C"
