// A baseline JPEG decoder that reproduces libjpeg's output bit for bit,
// the image loaders' decoder on every device (the card's machine has no
// libjpeg).
//
// The JAX package decodes with libjpeg (`native/keystone_io.cpp:303-418`:
// JCS_RGB to float32 HWC, libjpeg's defaults: the integer "islow" IDCT
// and fancy upsampling). The card's machine has no libjpeg, and nvJPEG's
// IDCT and chroma upsampling round differently. This decoder follows
// libjpeg's arithmetic step by step, so its pixels equal libjpeg's:
//
//   - markers: SOI, DQT (8 and 16 bit), SOF0/SOF1 (8-bit Huffman) with
//     one scan holding every component, SOF2 (8-bit progressive Huffman)
//     with its scans, DHT, DRI, SOS, RSTn, APPn/COM skipped, EOI.
//     Arithmetic-coded, 12-bit, multi-scan sequential, lossless, CMYK
//     and Adobe-RGB files are refused (status 3; the loaders skip them,
//     as a corrupt entry, and as the JAX package's libjpeg route skips
//     CMYK);
//   - Huffman decode of each 8x8 block (`jdhuff.c`; a progressive
//     image's DC and AC bands, first scans and refinements, into a
//     coefficient buffer, `jdphuff.c`), dequantization and
//     `jidctint.c::jpeg_idct_islow` (CONST_BITS 13, PASS1_BITS 2) with
//     libjpeg's range-limit table;
//   - `jdsample.c` fancy upsampling for 4:2:0 (h2v2) and 4:2:2 (h2v1),
//     the last real chroma row and column repeated at the edges (a
//     chroma plane at most 2 samples wide replicated, as libjpeg does),
//     and `jdcolor.c` YCbCr to RGB with libjpeg's fixed-point tables;
//     grayscale repeats Y in R, G and B.
//
// The output is uint8 RGB, (H, W, 3). A batch decodes on a pool of
// threads, one image at a time each. Built by `ops/_build.py`'s host
// route (no library linked).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

enum Status { kOk = 0, kBad = 1, kOverflow = 2, kUnsupported = 3 };

struct Huff {
  bool present = false;
  int32_t mincode[17];
  int32_t maxcode[18];
  int32_t valptr[17];
  uint8_t vals[256];
};

struct Comp {
  int id, h, v, tq, td = 0, ta = 0;
  int bw, bh;          // blocks across and down, padded to whole MCUs
  int dw, dh;          // downsampled width and height (real samples)
  std::vector<uint8_t> plane;  // bw*8 x bh*8 samples
  int pred = 0;
};

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  uint32_t bits = 0;
  int nbits = 0;
  bool marker = false;  // hit a marker: further bits are zeros

  void fill() {
    while (nbits <= 24) {
      uint32_t byte = 0;
      if (!marker && p < end) {
        byte = *p;
        if (byte == 0xFF) {
          const uint8_t next = p + 1 < end ? p[1] : 0;
          if (next == 0x00) {
            p += 2;
          } else {
            marker = true;  // libjpeg inserts zeros from here
            byte = 0;
          }
        } else {
          ++p;
        }
      }
      bits |= byte << (24 - nbits);
      nbits += 8;
    }
  }
  int get(int n) {  // n in 1..16
    if (nbits < n) fill();
    const int v = (int)(bits >> (32 - n));
    bits <<= n;
    nbits -= n;
    return v;
  }
  void reset() {  // at a restart: drop the partial byte, resume at RSTn
    bits = 0;
    nbits = 0;
    marker = false;
  }
};

void build_huff(Huff& h, const uint8_t* counts, const uint8_t* vals,
                int nvals) {
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    h.valptr[l] = k;
    h.mincode[l] = code;
    code += counts[l - 1];
    k += counts[l - 1];
    h.maxcode[l] = counts[l - 1] ? code - 1 : -1;
    code <<= 1;
  }
  h.maxcode[17] = 0x7FFFFFFF;
  memcpy(h.vals, vals, nvals);
  h.present = true;
}

// One Huffman symbol, or -1 for a code no table holds.
int decode_sym(Reader& r, const Huff& h) {
  int code = 0;
  for (int l = 1; l <= 16; ++l) {
    code = (code << 1) | r.get(1);
    if (h.maxcode[l] >= 0 && code <= h.maxcode[l] && code >= h.mincode[l])
      return h.vals[h.valptr[l] + code - h.mincode[l]];
  }
  return -1;
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// libjpeg's post-IDCT range limit (`jdmaster.c::prepare_range_limit_table`)
// indexed by the descaled value masked to 10 bits.
inline uint8_t range_limit(int x) {
  const int m = x & 1023;
  if (m < 128) return (uint8_t)(128 + m);
  if (m < 512) return 255;
  if (m < 896) return 0;
  return (uint8_t)(m - 896);
}

// `jidctint.c::jpeg_idct_islow`: coef (natural order, dequantized) to an
// 8x8 block of samples at out (row stride `stride`).
void idct_islow(const int32_t* coef, uint8_t* out, int stride) {
  const int CB = 13, P1 = 2;
  const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int32_t* in = coef + c;
    int64_t z2 = in[16], z3 = in[48];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * (-F1847);
    int64_t tmp3 = z1 + z2 * F0765;
    z2 = in[0];
    z3 = in[32];
    int64_t tmp0 = (z2 + z3) * (1 << CB);
    int64_t tmp1 = (z2 - z3) * (1 << CB);
    const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
    const int64_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    tmp0 = in[56];
    tmp1 = in[40];
    tmp2 = in[24];
    tmp3 = in[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CB - P1;
    const int64_t rnd = (int64_t)1 << (sh - 1);
    ws[c + 0] = (int32_t)((t10 + tmp3 + rnd) >> sh);
    ws[c + 56] = (int32_t)((t10 - tmp3 + rnd) >> sh);
    ws[c + 8] = (int32_t)((t11 + tmp2 + rnd) >> sh);
    ws[c + 48] = (int32_t)((t11 - tmp2 + rnd) >> sh);
    ws[c + 16] = (int32_t)((t12 + tmp1 + rnd) >> sh);
    ws[c + 40] = (int32_t)((t12 - tmp1 + rnd) >> sh);
    ws[c + 24] = (int32_t)((t13 + tmp0 + rnd) >> sh);
    ws[c + 32] = (int32_t)((t13 - tmp0 + rnd) >> sh);
  }
  for (int rr = 0; rr < 8; ++rr) {
    const int32_t* w = ws + rr * 8;
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * (-F1847);
    int64_t tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << CB);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << CB);
    const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
    const int64_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CB + P1 + 3;
    const int64_t rnd = (int64_t)1 << (sh - 1);
    uint8_t* o = out + rr * stride;
    o[0] = range_limit((int)((t10 + tmp3 + rnd) >> sh));
    o[7] = range_limit((int)((t10 - tmp3 + rnd) >> sh));
    o[1] = range_limit((int)((t11 + tmp2 + rnd) >> sh));
    o[6] = range_limit((int)((t11 - tmp2 + rnd) >> sh));
    o[2] = range_limit((int)((t12 + tmp1 + rnd) >> sh));
    o[5] = range_limit((int)((t12 - tmp1 + rnd) >> sh));
    o[3] = range_limit((int)((t13 + tmp0 + rnd) >> sh));
    o[4] = range_limit((int)((t13 - tmp0 + rnd) >> sh));
  }
}

struct Header {
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int restart = 0;
  bool progressive = false;
  Comp comp[3];
  uint16_t q[4][64];  // natural order
  Huff dc[4], ac[4];
  const uint8_t* scan = nullptr;  // first byte of the entropy data
  int ns = 0;                     // components in the scan
  int order[3];                   // scan order -> component index
  int ss = 0, se = 63, ah = 0, al = 0;  // a progressive scan's band
  int64_t pos = 0;  // where the marker walk goes on after this scan
  bool adobe_rgb = false, have_frame = false;
};

inline int be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

int parse_segments(const uint8_t* d, int64_t len, Header& hd, bool need_scan,
                   bool after_scan);

// Parse up to the first scan's data. Returns a Status.
int parse(const uint8_t* d, int64_t len, Header& hd, bool need_scan) {
  if (len < 4 || d[0] != 0xFF || d[1] != 0xD8) return kBad;
  hd.pos = 2;
  return parse_segments(d, len, hd, need_scan, false);
}

// The marker walk from `hd.pos` to the next scan's data (`hd.scan`, and
// `hd.pos` past its header) or, after a scan, to the end of the image
// (`hd.scan` null). Returns a Status.
int parse_segments(const uint8_t* d, int64_t len, Header& hd, bool need_scan,
                   bool after_scan) {
  int64_t pos = hd.pos;
  bool& adobe_rgb = hd.adobe_rgb;
  bool& have_frame = hd.have_frame;
  hd.scan = nullptr;
  while (pos + 4 <= len) {
    if (d[pos] != 0xFF) return kBad;
    int m = d[pos + 1];
    if (m == 0xFF) {  // fill byte
      ++pos;
      continue;
    }
    pos += 2;
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
    if (m == 0xD9) return after_scan ? kOk : kBad;  // EOI
    const int seg = be16(d + pos);
    if (seg < 2 || pos + seg > len) return kBad;
    const uint8_t* s = d + pos + 2;
    const int n = seg - 2;
    if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
      if (n < 6 || s[0] != 8) return kUnsupported;
      if (have_frame) return kBad;
      hd.progressive = m == 0xC2;
      hd.height = be16(s + 1);
      hd.width = be16(s + 3);
      hd.ncomp = s[5];
      if (hd.width <= 0 || hd.height <= 0) return kBad;
      if (hd.ncomp != 1 && hd.ncomp != 3) return kUnsupported;
      if (n < 6 + 3 * hd.ncomp) return kBad;
      for (int i = 0; i < hd.ncomp; ++i) {
        Comp& c = hd.comp[i];
        c.id = s[6 + 3 * i];
        c.h = s[7 + 3 * i] >> 4;
        c.v = s[7 + 3 * i] & 15;
        c.tq = s[8 + 3 * i];
        if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) return kBad;
        hd.hmax = std::max(hd.hmax, c.h);
        hd.vmax = std::max(hd.vmax, c.v);
      }
      if (hd.ncomp == 3 && hd.comp[0].id == 'R' && hd.comp[1].id == 'G' &&
          hd.comp[2].id == 'B')
        return kUnsupported;  // an RGB JPEG
      have_frame = true;
      if (!need_scan) return kOk;
    } else if (m >= 0xC2 && m <= 0xCF && m != 0xC4 && m != 0xC8 &&
               m != 0xCC) {
      return kUnsupported;  // lossless, hierarchical or arithmetic
    } else if (m == 0xDB) {
      int i = 0;
      while (i < n) {
        const int pq = s[i] >> 4, tq = s[i] & 15;
        if (tq > 3) return kBad;
        ++i;
        for (int k = 0; k < 64; ++k) {
          if (i + (pq ? 2 : 1) > n) return kBad;
          hd.q[tq][kZigzag[k]] = pq ? be16(s + i) : s[i];
          i += pq ? 2 : 1;
        }
      }
    } else if (m == 0xC4) {
      int i = 0;
      while (i + 17 <= n) {
        const int tc = s[i] >> 4, th = s[i] & 15;
        if (tc > 1 || th > 3) return kBad;
        int total = 0;
        for (int k = 0; k < 16; ++k) total += s[i + 1 + k];
        if (total > 256 || i + 17 + total > n) return kBad;
        build_huff(tc ? hd.ac[th] : hd.dc[th], s + i + 1, s + i + 17, total);
        i += 17 + total;
      }
    } else if (m == 0xDD) {
      if (n < 2) return kBad;
      hd.restart = be16(s);
    } else if (m == 0xEE) {
      if (n >= 12 && memcmp(s, "Adobe", 5) == 0 && s[11] == 0)
        adobe_rgb = true;
    } else if (m == 0xDA) {
      if (!have_frame) return kBad;
      if (adobe_rgb && hd.ncomp == 3) return kUnsupported;
      const int ns = s[0];
      if (ns < 1 || ns > hd.ncomp || n < 1 + 2 * ns + 3) return kBad;
      if (!hd.progressive && ns != hd.ncomp) return kUnsupported;
      for (int k = 0; k < ns; ++k) {
        const int id = s[1 + 2 * k];
        int ci = -1;
        for (int j = 0; j < hd.ncomp; ++j)
          if (hd.comp[j].id == id) ci = j;
        if (ci < 0) return kBad;
        hd.order[k] = ci;
        hd.comp[ci].td = s[2 + 2 * k] >> 4;
        hd.comp[ci].ta = s[2 + 2 * k] & 15;
        if (hd.comp[ci].td > 3 || hd.comp[ci].ta > 3) return kBad;
      }
      hd.ns = ns;
      hd.ss = s[1 + 2 * ns];
      hd.se = s[2 + 2 * ns];
      hd.ah = s[3 + 2 * ns] >> 4;
      hd.al = s[3 + 2 * ns] & 15;
      hd.scan = s + n;
      hd.pos = pos + seg;
      return kOk;
    }
    pos += seg;
  }
  return after_scan ? kOk : kBad;  // an image cut short ends here
}

// Each component's sample and block dimensions and its zeroed plane.
void set_dims(Header& hd) {
  const int mcux = (hd.width + 8 * hd.hmax - 1) / (8 * hd.hmax);
  const int mcuy = (hd.height + 8 * hd.vmax - 1) / (8 * hd.vmax);
  for (int i = 0; i < hd.ncomp; ++i) {
    Comp& c = hd.comp[i];
    c.dw = (hd.width * c.h + hd.hmax - 1) / hd.hmax;
    c.dh = (hd.height * c.v + hd.vmax - 1) / hd.vmax;
    if (hd.ncomp == 1) {  // a non-interleaved scan: blocks cover the samples
      c.bw = (c.dw + 7) / 8;
      c.bh = (c.dh + 7) / 8;
    } else {
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
    }
    c.plane.assign((size_t)c.bw * 8 * c.bh * 8, 0);
    c.pred = 0;
  }
}

int decode_scan(Header& hd, const uint8_t* end) {
  const int mcux = (hd.width + 8 * hd.hmax - 1) / (8 * hd.hmax);
  const int mcuy = (hd.height + 8 * hd.vmax - 1) / (8 * hd.vmax);
  const bool single = hd.ncomp == 1;
  set_dims(hd);
  for (int i = 0; i < hd.ncomp; ++i) {
    const Comp& c = hd.comp[i];
    if (!hd.dc[c.td].present || !hd.ac[c.ta].present) return kBad;
  }
  Reader r{hd.scan, end};
  int32_t coef[64];
  auto block = [&](Comp& c, int bx, int by) -> bool {
    const Huff& dc = hd.dc[c.td];
    const Huff& ac = hd.ac[c.ta];
    int32_t raw[64] = {0};
    int s = decode_sym(r, dc);
    if (s < 0 || s > 15) return false;
    int diff = s ? extend(r.get(s), s) : 0;
    c.pred += diff;
    raw[0] = c.pred;
    for (int k = 1; k < 64;) {
      const int rs = decode_sym(r, ac);
      if (rs < 0) return false;
      const int run = rs >> 4, sz = rs & 15;
      if (sz) {
        k += run;
        if (k > 63) return false;
        raw[kZigzag[k]] = extend(r.get(sz), sz);
        ++k;
      } else if (run == 15) {
        k += 16;
      } else {
        break;
      }
    }
    const uint16_t* q = hd.q[c.tq];
    for (int k = 0; k < 64; ++k) coef[k] = raw[k] * (int32_t)q[k];
    const int stride = c.bw * 8;
    idct_islow(coef, c.plane.data() + (size_t)by * 8 * stride + bx * 8,
               stride);
    return true;
  };
  const int units = single ? hd.comp[0].bw * hd.comp[0].bh : mcux * mcuy;
  int next_rst = 0;
  for (int u = 0; u < units; ++u) {
    if (hd.restart && u > 0 && u % hd.restart == 0) {
      // skip to the restart marker, then resume with fresh predictions
      const uint8_t* p = r.p;
      while (p + 1 < end && !(p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7))
        ++p;
      if (p + 1 >= end) return kBad;
      if (p[1] != 0xD0 + next_rst) return kBad;
      next_rst = (next_rst + 1) & 7;
      r.p = p + 2;
      r.reset();
      for (int i = 0; i < hd.ncomp; ++i) hd.comp[i].pred = 0;
    }
    if (single) {
      Comp& c = hd.comp[0];
      if (!block(c, u % c.bw, u / c.bw)) return kBad;
      continue;
    }
    const int mx = u % mcux, my = u / mcux;
    for (int k = 0; k < hd.ncomp; ++k) {
      Comp& c = hd.comp[hd.order[k]];
      for (int yy = 0; yy < c.v; ++yy)
        for (int xx = 0; xx < c.h; ++xx)
          if (!block(c, mx * c.h + xx, my * c.v + yy)) return kBad;
    }
  }
  return kOk;
}

// A progressive image (`jdphuff.c`): every scan's band of coefficients
// is decoded into one coefficient buffer a component (blocks padded to
// whole MCUs, natural order), then each block is dequantized with the
// table its component had at its first scan (`jdinput.c`'s latch) and
// run through the IDCT into the component's plane, as `decode_scan`
// does for a baseline image. `data`/`len` is the whole file; `hd` holds
// the first scan's header.
int decode_progressive(Header& hd, const uint8_t* data, int64_t len) {
  const uint8_t* end = data + len;
  const int mcux = (hd.width + 8 * hd.hmax - 1) / (8 * hd.hmax);
  const int mcuy = (hd.height + 8 * hd.vmax - 1) / (8 * hd.vmax);
  set_dims(hd);
  std::vector<int32_t> coefs[3];
  int bwp[3];
  bool latched[3] = {false, false, false};
  uint16_t cq[3][64];
  for (int i = 0; i < hd.ncomp; ++i) {
    const Comp& c = hd.comp[i];
    bwp[i] = mcux * c.h;
    coefs[i].assign((size_t)bwp[i] * mcuy * c.v * 64, 0);
    memcpy(cq[i], hd.q[c.tq], sizeof(cq[i]));
  }
  while (hd.scan) {
    const int ss = hd.ss, se = hd.se, ah = hd.ah, al = hd.al;
    if (ss == 0 ? se != 0 : (hd.ns != 1 || se < ss || se > 63)) return kBad;
    if (al > 13) return kBad;
    for (int k = 0; k < hd.ns; ++k) {
      const int ci = hd.order[k];
      const Comp& c = hd.comp[ci];
      if (!latched[ci]) {
        memcpy(cq[ci], hd.q[c.tq], sizeof(cq[ci]));
        latched[ci] = true;
      }
      if (ss == 0 && ah == 0 && !hd.dc[c.td].present) return kBad;
      if (ss > 0 && !hd.ac[c.ta].present) return kBad;
      hd.comp[ci].pred = 0;
    }
    Reader r{hd.scan, end};
    int eobrun = 0;
    const int p1 = 1 << al, m1 = -(1 << al);
    auto refine = [&](int32_t& v) {  // a correction bit of a nonzero one
      if (r.get(1) && (v & p1) == 0) v += v >= 0 ? p1 : m1;
    };
    auto block = [&](int ci, int bx, int by) -> bool {
      Comp& c = hd.comp[ci];
      int32_t* b = coefs[ci].data() + ((size_t)by * bwp[ci] + bx) * 64;
      if (ss == 0) {
        if (ah) {
          if (r.get(1)) b[0] |= p1;
          return true;
        }
        const int t = decode_sym(r, hd.dc[c.td]);
        if (t < 0 || t > 15) return false;
        c.pred += t ? extend(r.get(t), t) : 0;
        b[0] = c.pred * (1 << al);
        return true;
      }
      const Huff& ac = hd.ac[c.ta];
      int k = ss;
      if (ah == 0) {
        if (eobrun > 0) {
          --eobrun;
          return true;
        }
        for (; k <= se; ++k) {
          const int rs = decode_sym(r, ac);
          if (rs < 0) return false;
          const int run = rs >> 4, sz = rs & 15;
          if (sz) {
            k += run;
            if (k > 63) return false;
            b[kZigzag[k]] = extend(r.get(sz), sz) * (1 << al);
          } else if (run == 15) {
            k += 15;
          } else {
            eobrun = (1 << run) - 1;
            if (run) eobrun += r.get(run);
            break;
          }
        }
        return true;
      }
      if (eobrun == 0) {
        for (; k <= se; ++k) {
          const int rs = decode_sym(r, ac);
          if (rs < 0) return false;
          int run = rs >> 4, val = 0;
          if (rs & 15) {
            val = r.get(1) ? p1 : m1;
          } else if (run != 15) {
            eobrun = 1 << run;
            if (run) eobrun += r.get(run);
            break;
          }
          do {
            int32_t& v = b[kZigzag[k]];
            if (v != 0) {
              refine(v);
            } else if (--run < 0) {
              break;
            }
            ++k;
          } while (k <= se);
          if (val) {
            if (k > 63) return false;
            b[kZigzag[k]] = val;
          }
        }
      }
      if (eobrun > 0) {
        for (; k <= se; ++k) {
          int32_t& v = b[kZigzag[k]];
          if (v != 0) refine(v);
        }
        --eobrun;
      }
      return true;
    };
    const Comp& c0 = hd.comp[hd.order[0]];
    const int bw1 = (c0.dw + 7) / 8, bh1 = (c0.dh + 7) / 8;
    const int units = hd.ns == 1 ? bw1 * bh1 : mcux * mcuy;
    int next_rst = 0;
    for (int u = 0; u < units; ++u) {
      if (hd.restart && u > 0 && u % hd.restart == 0) {
        const uint8_t* p = r.p;
        while (p + 1 < end &&
               !(p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7))
          ++p;
        if (p + 1 >= end || p[1] != 0xD0 + next_rst) return kBad;
        next_rst = (next_rst + 1) & 7;
        r.p = p + 2;
        r.reset();
        eobrun = 0;
        for (int i = 0; i < hd.ncomp; ++i) hd.comp[i].pred = 0;
      }
      if (hd.ns == 1) {
        if (!block(hd.order[0], u % bw1, u / bw1)) return kBad;
        continue;
      }
      const int mx = u % mcux, my = u / mcux;
      for (int k = 0; k < hd.ns; ++k) {
        const Comp& c = hd.comp[hd.order[k]];
        for (int yy = 0; yy < c.v; ++yy)
          for (int xx = 0; xx < c.h; ++xx)
            if (!block(hd.order[k], mx * c.h + xx, my * c.v + yy))
              return kBad;
      }
    }
    // the next marker after this scan's data, where the walk goes on
    const uint8_t* p = r.p;
    while (p + 1 < end &&
           !(p[0] == 0xFF && p[1] != 0 && !(p[1] >= 0xD0 && p[1] <= 0xD7)))
      ++p;
    hd.pos = p - data;
    const int rc = parse_segments(data, len, hd, true, true);
    if (rc != kOk) return rc;
  }
  int32_t coef[64];
  for (int i = 0; i < hd.ncomp; ++i) {
    Comp& c = hd.comp[i];
    const int stride = c.bw * 8;
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx) {
        const int32_t* b = coefs[i].data() + ((size_t)by * bwp[i] + bx) * 64;
        for (int k = 0; k < 64; ++k) coef[k] = b[k] * (int32_t)cq[i][k];
        idct_islow(coef, c.plane.data() + (size_t)by * 8 * stride + bx * 8,
                   stride);
      }
  }
  return kOk;
}

// `jdsample.c` fancy upsampling of one chroma plane to the luma grid:
// out is (2*dh or dh) x (2*dw) samples, row stride ow. As libjpeg, a
// plane at most 2 samples wide is replicated instead (`h2v1_upsample`,
// `h2v2_upsample`).
void upsample(const Comp& c, int hs, int vs, std::vector<uint8_t>& out,
              int& ow) {
  const int stride = c.bw * 8, dw = c.dw, dh = c.dh;
  ow = dw * hs;
  out.assign((size_t)ow * dh * vs, 0);
  auto at = [&](int y, int x) -> int {
    return c.plane[(size_t)y * stride + x];
  };
  if (dw <= 2) {
    for (int y = 0; y < dh * vs; ++y)
      for (int x = 0; x < ow; ++x)
        out[(size_t)y * ow + x] = (uint8_t)at(y / vs, x / hs);
    return;
  }
  if (hs == 2 && vs == 2) {
    for (int y = 0; y < dh; ++y) {
      for (int v = 0; v < 2; ++v) {
        const int y1 = v == 0 ? std::max(y - 1, 0) : std::min(y + 1, dh - 1);
        uint8_t* o = out.data() + (size_t)(2 * y + v) * ow;
        auto colsum = [&](int x) { return at(y, x) * 3 + at(y1, x); };
        int this_s = colsum(0);
        int next_s = colsum(std::min(1, stride - 1));
        o[0] = (uint8_t)((this_s * 4 + 8) >> 4);
        o[1] = (uint8_t)((this_s * 3 + next_s + 7) >> 4);
        int last_s = this_s;
        this_s = next_s;
        for (int x = 1; x < dw - 1; ++x) {
          next_s = colsum(x + 1);
          o[2 * x] = (uint8_t)((this_s * 3 + last_s + 8) >> 4);
          o[2 * x + 1] = (uint8_t)((this_s * 3 + next_s + 7) >> 4);
          last_s = this_s;
          this_s = next_s;
        }
        if (dw > 1) {
          o[2 * dw - 2] = (uint8_t)((this_s * 3 + last_s + 8) >> 4);
          o[2 * dw - 1] = (uint8_t)((this_s * 4 + 7) >> 4);
        }
      }
    }
  } else {  // h2v1
    for (int y = 0; y < dh; ++y) {
      uint8_t* o = out.data() + (size_t)y * ow;
      int in0 = at(y, 0);
      o[0] = (uint8_t)in0;
      o[1] = (uint8_t)((in0 * 3 + at(y, std::min(1, stride - 1)) + 2) >> 2);
      for (int x = 1; x < dw - 1; ++x) {
        const int v3 = at(y, x) * 3;
        o[2 * x] = (uint8_t)((v3 + at(y, x - 1) + 1) >> 2);
        o[2 * x + 1] = (uint8_t)((v3 + at(y, x + 1) + 2) >> 2);
      }
      if (dw > 1) {
        const int last = at(y, dw - 1);
        o[2 * dw - 2] = (uint8_t)((last * 3 + at(y, dw - 2) + 1) >> 2);
        o[2 * dw - 1] = (uint8_t)last;
      }
    }
  }
}

struct ColorTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  ColorTables() {
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + 32768) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + 32768) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + 32768;
    }
  }
};

const ColorTables& tables() {
  static const ColorTables t;
  return t;
}

inline uint8_t clamp255(int v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

int decode_one(const uint8_t* data, int64_t len, uint8_t* out,
               int64_t out_cap, int32_t* h, int32_t* w) {
  Header hd;
  int rc = parse(data, len, hd, true);
  if (rc != kOk) return rc;
  *h = hd.height;
  *w = hd.width;
  if ((int64_t)hd.height * hd.width * 3 > out_cap) return kOverflow;
  rc = hd.progressive ? decode_progressive(hd, data, len)
                      : decode_scan(hd, data + len);
  if (rc != kOk) return rc;
  const int W = hd.width, H = hd.height;
  const Comp& Y = hd.comp[0];
  const int ys = Y.bw * 8;
  if (hd.ncomp == 1) {
    for (int y = 0; y < H; ++y)
      for (int x = 0; x < W; ++x) {
        const uint8_t v = Y.plane[(size_t)y * ys + x];
        uint8_t* o = out + ((size_t)y * W + x) * 3;
        o[0] = o[1] = o[2] = v;
      }
    return kOk;
  }
  // chroma: the same sampling in both, a factor of 1 or 2 under luma's
  if (Y.h != hd.hmax || Y.v != hd.vmax) return kUnsupported;
  const Comp &Cb = hd.comp[1], &Cr = hd.comp[2];
  if (Cb.h != Cr.h || Cb.v != Cr.v) return kUnsupported;
  const int hs = hd.hmax / Cb.h, vs = hd.vmax / Cb.v;
  if (hd.hmax % Cb.h || hd.vmax % Cb.v) return kUnsupported;
  const bool same = hs == 1 && vs == 1;
  if (!same && !(hs == 2 && vs == 2) && !(hs == 2 && vs == 1))
    return kUnsupported;
  std::vector<uint8_t> ub, ur;
  int ubw = Cb.bw * 8, urw = Cr.bw * 8;
  const uint8_t* pb = Cb.plane.data();
  const uint8_t* pr = Cr.plane.data();
  if (!same) {
    upsample(Cb, hs, vs, ub, ubw);
    upsample(Cr, hs, vs, ur, urw);
    pb = ub.data();
    pr = ur.data();
  }
  const ColorTables& t = tables();
  for (int y = 0; y < H; ++y) {
    const uint8_t* yr = Y.plane.data() + (size_t)y * ys;
    const uint8_t* br = pb + (size_t)y * ubw;
    const uint8_t* rr = pr + (size_t)y * urw;
    uint8_t* o = out + (size_t)y * W * 3;
    for (int x = 0; x < W; ++x) {
      const int yy = yr[x], cb = br[x], cr = rr[x];
      o[3 * x] = clamp255(yy + t.cr_r[cr]);
      o[3 * x + 1] = clamp255(yy + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16));
      o[3 * x + 2] = clamp255(yy + t.cb_b[cb]);
    }
  }
  return kOk;
}

}  // namespace

extern "C" {

// Frame size of one JPEG from its header: 0 on success, else a Status.
int ks_jpegdec_dims(const uint8_t* data, int64_t len, int32_t* h,
                    int32_t* w) {
  Header hd;
  const int rc = parse(data, len, hd, false);
  if (rc != kOk) return rc;
  *h = hd.height;
  *w = hd.width;
  return 0;
}

// Decode image i (buf[offsets[i] : offsets[i] + sizes[i]]) into
// out[out_offsets[i] : out_offsets[i] + out_caps[i]] as uint8 RGB HWC on
// `num_threads` threads. Per-image status (0 ok, 1 bad JPEG, 2 too large
// for its slice, 3 a JPEG this decoder does not read) and dims (h, w, 3).
// Returns the count decoded.
int64_t ks_jpegdec_decode_batch(const uint8_t* buf, const int64_t* offsets,
                                const int64_t* sizes, int64_t n, uint8_t* out,
                                const int64_t* out_offsets,
                                const int64_t* out_caps, int32_t* out_dims,
                                int32_t* out_status, int num_threads) {
  if (!buf || !offsets || !sizes || !out || n < 0) return -1;
  std::atomic<int64_t> next(0), ok(0);
  auto worker = [&]() {
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= n) return;
      int32_t h = 0, w = 0;
      const int rc = decode_one(buf + offsets[i], sizes[i],
                                out + out_offsets[i], out_caps[i], &h, &w);
      out_dims[3 * i] = h;
      out_dims[3 * i + 1] = w;
      out_dims[3 * i + 2] = 3;
      out_status[i] = rc;
      if (rc == 0) ok.fetch_add(1);
    }
  };
  const int t = (int)std::min<int64_t>(std::max(num_threads, 1), n);
  if (t <= 1) {
    worker();
  } else {
    std::vector<std::thread> ts;
    for (int k = 0; k < t; ++k) ts.emplace_back(worker);
    for (auto& th : ts) th.join();
  }
  return ok.load();
}

}  // extern "C"
