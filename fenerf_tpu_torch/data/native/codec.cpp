// Host image codec of the port's data path: a baseline sequential JPEG
// decoder and the PNG scanline unfilter, with a plain C interface bound by
// ctypes (data/native_loader.py). It links no library: no libjpeg, no
// libpng, no zlib (PNG inflate stays in Python's zlib).
//
// The JPEG decoder reproduces libjpeg's default decode (what PIL returns):
//   * the "islow" integer IDCT of jidctint.c (CONST_BITS 13, PASS1_BITS 2)
//     with its post-IDCT range-limit table;
//   * the "fancy" triangle upsampling of jdsample.c (h2v1, h1v2, h2v2; edge
//     rows replicated as jdmainct.c's context pointers do), box upsampling
//     where libjpeg takes it, integral ratios otherwise;
//   * the fixed-point YCbCr -> RGB of jdcolor.c (16 fraction bits).
// It decodes SOF0 / SOF1, 8-bit precision, Huffman coding, 1 or 3
// components, sampling factors 1-2, interleaved or single-component scans
// and restart intervals. Progressive (SOF2), lossless, arithmetic-coded and
// 12-bit images are refused with a message naming what is missing.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Error{msg}; }

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries for a corrupt run past the end (jpeg_natural_order)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  // canonical code tables (jdhuff.c's maxcode / valoffset)
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  // 9-bit lookahead: (length << 8) | value, 0 where the code is longer
  uint16_t look[512];
};

void build_huffman(Huffman& h, const uint8_t* counts, const uint8_t* vals,
                   int nvals) {
  int huffsize[257];
  unsigned huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < counts[l - 1]; ++i) huffsize[p++] = l;
  huffsize[p] = 0;
  if (p != nvals) fail("bad Huffman table");
  unsigned code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1u << si)) fail("bad Huffman table");
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (counts[l - 1]) {
      h.valoffset[l] = p - (int32_t)huffcode[p];
      p += counts[l - 1];
      h.maxcode[l] = (int32_t)huffcode[p - 1];
    } else {
      h.maxcode[l] = -1;
    }
  }
  h.maxcode[17] = 0x7FFFFFFF;
  memcpy(h.vals, vals, nvals);
  memset(h.look, 0, sizeof(h.look));
  p = 0;
  for (int l = 1; l <= 9; ++l) {
    for (int i = 0; i < counts[l - 1]; ++i, ++p) {
      int lookbits = (int)(huffcode[p] << (9 - l));
      for (int c = 0; c < (1 << (9 - l)); ++c)
        h.look[lookbits + c] = (uint16_t)((l << 8) | vals[p]);
    }
  }
  h.defined = true;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int bw = 0, bh = 0;          // coefficient grid in blocks (MCU padded)
  int dw = 0, dh = 0;          // downsampled width / height in samples
  std::vector<int16_t> coef;   // bw * bh * 64, natural order
  std::vector<uint8_t> plane;  // (bh * 8) x (bw * 8) samples
  int pred = 0;
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  std::vector<Component> comps;
  int width = 0, height = 0, hmax = 1, vmax = 1;
  int restart = 0;
  bool have_frame = false;
  bool adobe = false;
  int adobe_transform = -1;
  // bit reader
  uint32_t bitbuf = 0;
  int bitcnt = 0;
  bool hit_marker = false;

  Decoder(const uint8_t* data, size_t size) : d(data), n(size) {}

  int byte() {
    if (pos >= n) fail("truncated JPEG");
    return d[pos++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  // -------------------------------------------------------------- bits
  void fill() {
    while (bitcnt <= 24) {
      int c = 0;
      if (!hit_marker && pos < n) {
        c = d[pos];
        if (c == 0xFF) {
          int c2 = pos + 1 < n ? d[pos + 1] : 0xD9;
          if (c2 == 0x00) {
            pos += 2;
          } else {
            // a marker: libjpeg feeds zeros from here on
            hit_marker = true;
            c = 0;
          }
        } else {
          ++pos;
        }
      }
      bitbuf |= (uint32_t)c << (24 - bitcnt);
      bitcnt += 8;
    }
  }
  int bits(int k) {
    if (k == 0) return 0;
    if (bitcnt < k) fill();
    int v = (int)(bitbuf >> (32 - k));
    bitbuf <<= k;
    bitcnt -= k;
    return v;
  }
  int decode(const Huffman& h) {
    if (bitcnt < 16) fill();
    int look = (int)(bitbuf >> (32 - 9));
    int e = h.look[look];
    if (e) {
      int l = e >> 8;
      bitbuf <<= l;
      bitcnt -= l;
      return e & 0xFF;
    }
    int l = 10;
    int32_t code = (int32_t)(bitbuf >> (32 - l));
    while (l <= 16 && code > h.maxcode[l]) {
      ++l;
      code = (int32_t)(bitbuf >> (32 - l));
    }
    if (l > 16) {
      // libjpeg warns and returns 0 for a code it cannot decode
      bitbuf <<= 16;
      bitcnt -= 16;
      return 0;
    }
    bitbuf <<= l;
    bitcnt -= l;
    return h.vals[(code + h.valoffset[l]) & 0xFF];
  }
  static int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }

  void reset_bits() {
    bitbuf = 0;
    bitcnt = 0;
  }

  // read the RSTn marker that ends a restart interval
  void restart_marker() {
    reset_bits();
    if (hit_marker) {
      hit_marker = false;
    }
    // skip to the next marker
    while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] >= 0xD0 &&
                            d[pos + 1] <= 0xD7)) {
      if (d[pos] == 0xFF && d[pos + 1] != 0x00 && d[pos + 1] != 0xFF) break;
      ++pos;
    }
    if (pos + 1 < n && d[pos] == 0xFF && d[pos + 1] >= 0xD0 &&
        d[pos + 1] <= 0xD7)
      pos += 2;
    for (auto& c : comps) c.pred = 0;
  }

  // -------------------------------------------------------------- markers
  void read_dqt() {
    int len = word() - 2;
    while (len > 0) {
      int pq_tq = byte();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3) fail("bad DQT table index");
      for (int i = 0; i < 64; ++i)
        qt[tq][kNatural[i]] = (uint16_t)(pq ? word() : byte());
      qt_defined[tq] = true;
      len -= 1 + 64 * (pq ? 2 : 1);
    }
  }
  void read_dht() {
    int len = word() - 2;
    while (len > 0) {
      int tc_th = byte();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("bad DHT table index");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = (uint8_t)byte();
      if (total > 256) fail("bad Huffman table");
      uint8_t vals[256];
      for (int i = 0; i < total; ++i) vals[i] = (uint8_t)byte();
      build_huffman(tc ? ac[th] : dc[th], counts, vals, total);
      len -= 17 + total;
    }
  }
  void read_sof() {
    int len = word();
    int precision = byte();
    if (precision != 8)
      fail("12-bit (or other non-8-bit) JPEG precision is not supported: "
           "only 8-bit baseline JPEG is decoded");
    height = word();
    width = word();
    int nc = byte();
    if (height <= 0 || width <= 0) fail("JPEG without image size");
    if (nc != 1 && nc != 3)
      fail("JPEG with " + std::to_string(nc) +
           " components is not supported (1 or 3)");
    if (len != 8 + 3 * nc) fail("bad SOF length");
    comps.resize(nc);
    for (auto& c : comps) {
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 2 || c.v < 1 || c.v > 2)
        fail("JPEG sampling factors above 2 are not supported");
      if (c.tq > 3) fail("bad quantization table index");
      if (c.h > hmax) hmax = c.h;
      if (c.v > vmax) vmax = c.v;
    }
    int mcux = (width + 8 * hmax - 1) / (8 * hmax);
    int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      if (nc == 1) {
        // a lone component is coded non-interleaved at full size
        c.h = c.v = 1;
      }
      c.bw = (nc == 1) ? (width + 7) / 8 : mcux * c.h;
      c.bh = (nc == 1) ? (height + 7) / 8 : mcuy * c.v;
      c.dw = (int)(((long)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((long)height * c.v + vmax - 1) / vmax);
      if (nc == 1) {
        c.dw = width;
        c.dh = height;
      }
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }
    if (nc == 1) hmax = vmax = 1;
    have_frame = true;
  }

  void decode_block(Component& c, int16_t* blk) {
    const Huffman& hd = dc[c.dc_tbl];
    const Huffman& ha = ac[c.ac_tbl];
    int s = decode(hd);
    int diff = s ? extend(bits(s), s) : 0;
    c.pred += diff;
    blk[0] = (int16_t)c.pred;
    for (int k = 1; k < 64; ++k) {
      int rs = decode(ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        int v = extend(bits(s), s);
        blk[kNatural[k]] = (int16_t)v;
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void read_sos() {
    if (!have_frame) fail("SOS before SOF");
    int len = word();
    int ns = byte();
    if (len != 6 + 2 * ns || ns < 1 || ns > (int)comps.size())
      fail("bad SOS");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      int id = byte();
      int t = byte();
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == id) found = &c;
      if (!found) fail("SOS names an unknown component");
      found->dc_tbl = t >> 4;
      found->ac_tbl = t & 15;
      if (found->dc_tbl > 3 || found->ac_tbl > 3) fail("bad SOS table");
      if (!dc[found->dc_tbl].defined || !ac[found->ac_tbl].defined)
        fail("SOS uses an undefined Huffman table");
      sc.push_back(found);
    }
    int ss = byte(), se = byte(), ahal = byte();
    if (ss != 0 || se != 63 || ahal != 0)
      fail("progressive JPEG is not supported: only baseline sequential "
           "JPEG is decoded");
    for (auto* c : sc) c->pred = 0;
    reset_bits();
    hit_marker = false;
    int left = restart;
    if (ns == 1) {
      Component& c = *sc[0];
      int cw = (c.dw + 7) / 8, ch = (c.dh + 7) / 8;
      for (int by = 0; by < ch; ++by)
        for (int bx = 0; bx < cw; ++bx) {
          if (restart) {
            if (left == 0) {
              restart_marker();
              left = restart;
            }
            --left;
          }
          decode_block(c, &c.coef[((size_t)by * c.bw + bx) * 64]);
        }
    } else {
      int mcux = (width + 8 * hmax - 1) / (8 * hmax);
      int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx) {
          if (restart) {
            if (left == 0) {
              restart_marker();
              left = restart;
            }
            --left;
          }
          for (auto* cp : sc) {
            Component& c = *cp;
            for (int v = 0; v < c.v; ++v)
              for (int h = 0; h < c.h; ++h) {
                size_t bx = (size_t)mx * c.h + h, by = (size_t)my * c.v + v;
                decode_block(c, &c.coef[(by * c.bw + bx) * 64]);
              }
          }
        }
    }
    // leave the reader at the next marker
    reset_bits();
    hit_marker = false;
    while (pos + 1 < n &&
           !(d[pos] == 0xFF && d[pos + 1] != 0x00 &&
             !(d[pos + 1] >= 0xD0 && d[pos + 1] <= 0xD7)))
      ++pos;
  }

  void parse() {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file");
    pos = 2;
    bool scanned = false;
    for (;;) {
      // next marker (skipping fill bytes)
      int c = byte();
      if (c != 0xFF) {
        if (scanned) break;  // garbage after the data: stop, as at EOI
        fail("bad JPEG marker");
      }
      int m;
      do {
        m = byte();
      } while (m == 0xFF);
      if (m == 0xD9) break;  // EOI
      if (m >= 0xD0 && m <= 0xD7) continue;
      switch (m) {
        case 0xC0:
        case 0xC1:
          read_sof();
          break;
        case 0xC2:
        case 0xC6:
        case 0xCA:
        case 0xCE:
          fail("progressive JPEG is not supported: only baseline "
               "sequential JPEG is decoded");
        case 0xC3:
        case 0xC7:
        case 0xCB:
        case 0xCF:
          fail("lossless JPEG is not supported: only baseline sequential "
               "JPEG is decoded");
        case 0xC5:
          fail("hierarchical JPEG is not supported: only baseline "
               "sequential JPEG is decoded");
        case 0xC9:
          fail("arithmetic-coded JPEG is not supported: only Huffman-coded "
               "baseline JPEG is decoded");
        case 0xCC:
          fail("arithmetic-coded JPEG is not supported (DAC marker): only "
               "Huffman-coded baseline JPEG is decoded");
        case 0xC4:
          read_dht();
          break;
        case 0xDB:
          read_dqt();
          break;
        case 0xDD:
          if (word() != 4) fail("bad DRI");
          restart = word();
          break;
        case 0xDA:
          read_sos();
          scanned = true;
          break;
        case 0xEE: {  // APP14: Adobe's colour transform flag
          int len = word();
          size_t start = pos;
          if (len >= 14 && pos + 12 <= n && memcmp(d + pos, "Adobe", 5) == 0) {
            adobe = true;
            adobe_transform = d[pos + 11];
          }
          pos = start + len - 2;
          break;
        }
        default: {
          int len = word();
          if (len < 2) fail("bad marker length");
          pos += len - 2;
          if (pos > n) fail("truncated JPEG");
        }
      }
    }
    if (!scanned) fail("JPEG without image data");
  }

  // -------------------------------------------------------------- IDCT
  static uint8_t range_table[1024];

  static void init_range() {
    // jdmaster.c's post-IDCT table, indexed by (x & 1023) with x the
    // IDCT output before the +128 shift
    for (int i = 0; i < 1024; ++i) {
      int v;
      if (i < 128) v = i + 128;
      else if (i < 512) v = 255;
      else if (i < 896) v = 0;
      else v = i - 896;
      range_table[i] = (uint8_t)v;
    }
  }

  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                         int stride) {
    typedef int64_t JLONG;
    const int CONST_BITS = 13, PASS1_BITS = 2;
    const JLONG F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
    auto descale = [](JLONG x, int nb) -> JLONG {
      return (x + ((JLONG)1 << (nb - 1))) >> nb;
    };
    int ws[64];
    for (int col = 0; col < 8; ++col) {
      const int16_t* ip = in + col;
      const uint16_t* qp = q + col;
      int* wp = ws + col;
      if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
          ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
        int dcval = (int)((JLONG)ip[0] * qp[0] * (1 << PASS1_BITS));
        for (int r = 0; r < 8; ++r) wp[8 * r] = dcval;
        continue;
      }
      JLONG z2 = (JLONG)ip[16] * qp[16];
      JLONG z3 = (JLONG)ip[48] * qp[48];
      JLONG z1 = (z2 + z3) * F0541;
      JLONG tmp2 = z1 + z3 * (-F1847);
      JLONG tmp3 = z1 + z2 * F0765;
      z2 = (JLONG)ip[0] * qp[0];
      z3 = (JLONG)ip[32] * qp[32];
      JLONG tmp0 = (z2 + z3) * (1 << CONST_BITS);
      JLONG tmp1 = (z2 - z3) * (1 << CONST_BITS);
      JLONG tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      JLONG tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = (JLONG)ip[56] * qp[56];
      tmp1 = (JLONG)ip[40] * qp[40];
      tmp2 = (JLONG)ip[24] * qp[24];
      tmp3 = (JLONG)ip[8] * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      JLONG z4 = tmp1 + tmp3;
      JLONG z5 = (z3 + z4) * F1175;
      tmp0 = tmp0 * F0298;
      tmp1 = tmp1 * F2053;
      tmp2 = tmp2 * F3072;
      tmp3 = tmp3 * F1501;
      z1 = z1 * (-F0899);
      z2 = z2 * (-F2562);
      z3 = z3 * (-F1961);
      z4 = z4 * (-F0390);
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = CONST_BITS - PASS1_BITS;
      wp[0] = (int)descale(tmp10 + tmp3, sh);
      wp[56] = (int)descale(tmp10 - tmp3, sh);
      wp[8] = (int)descale(tmp11 + tmp2, sh);
      wp[48] = (int)descale(tmp11 - tmp2, sh);
      wp[16] = (int)descale(tmp12 + tmp1, sh);
      wp[40] = (int)descale(tmp12 - tmp1, sh);
      wp[24] = (int)descale(tmp13 + tmp0, sh);
      wp[32] = (int)descale(tmp13 - tmp0, sh);
    }
    const int sh2 = CONST_BITS + PASS1_BITS + 3;
    for (int row = 0; row < 8; ++row) {
      const int* wp = ws + 8 * row;
      uint8_t* op = out + (size_t)row * stride;
      if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 &&
          wp[5] == 0 && wp[6] == 0 && wp[7] == 0) {
        uint8_t v = range_table[(int)descale((JLONG)wp[0], PASS1_BITS + 3) &
                                1023];
        for (int i = 0; i < 8; ++i) op[i] = v;
        continue;
      }
      JLONG z2 = wp[2], z3 = wp[6];
      JLONG z1 = (z2 + z3) * F0541;
      JLONG tmp2 = z1 + z3 * (-F1847);
      JLONG tmp3 = z1 + z2 * F0765;
      JLONG tmp0 = ((JLONG)wp[0] + (JLONG)wp[4]) * (1 << CONST_BITS);
      JLONG tmp1 = ((JLONG)wp[0] - (JLONG)wp[4]) * (1 << CONST_BITS);
      JLONG tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      JLONG tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = wp[7];
      tmp1 = wp[5];
      tmp2 = wp[3];
      tmp3 = wp[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      JLONG z4 = tmp1 + tmp3;
      JLONG z5 = (z3 + z4) * F1175;
      tmp0 = tmp0 * F0298;
      tmp1 = tmp1 * F2053;
      tmp2 = tmp2 * F3072;
      tmp3 = tmp3 * F1501;
      z1 = z1 * (-F0899);
      z2 = z2 * (-F2562);
      z3 = z3 * (-F1961);
      z4 = z4 * (-F0390);
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      op[0] = range_table[(int)descale(tmp10 + tmp3, sh2) & 1023];
      op[7] = range_table[(int)descale(tmp10 - tmp3, sh2) & 1023];
      op[1] = range_table[(int)descale(tmp11 + tmp2, sh2) & 1023];
      op[6] = range_table[(int)descale(tmp11 - tmp2, sh2) & 1023];
      op[2] = range_table[(int)descale(tmp12 + tmp1, sh2) & 1023];
      op[5] = range_table[(int)descale(tmp12 - tmp1, sh2) & 1023];
      op[3] = range_table[(int)descale(tmp13 + tmp0, sh2) & 1023];
      op[4] = range_table[(int)descale(tmp13 - tmp0, sh2) & 1023];
    }
  }

  void idct_all() {
    for (auto& c : comps) {
      if (!qt_defined[c.tq]) fail("JPEG uses an undefined quantization table");
      size_t stride = (size_t)c.bw * 8;
      c.plane.assign(stride * c.bh * 8, 0);
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], qt[c.tq],
                     &c.plane[(size_t)by * 8 * stride + (size_t)bx * 8],
                     (int)stride);
      std::vector<int16_t>().swap(c.coef);
    }
  }

  // -------------------------------------------------------------- upsample
  // -> width x height samples of component c at full resolution
  std::vector<uint8_t> upsample(const Component& c) {
    const int W = width, H = height;
    const size_t stride = (size_t)c.bw * 8;
    const int dw = c.dw, dh = c.dh;
    std::vector<uint8_t> out((size_t)W * H);
    auto src = [&](int y, int x) -> int {
      return c.plane[(size_t)y * stride + x];
    };
    // context rows: above row 0 is row 0, below the last real row is
    // the last real row (jdmainct.c)
    auto row_of = [&](int y) { return y < 0 ? 0 : (y >= dh ? dh - 1 : y); };
    const int hx = hmax / c.h, vy = vmax / c.v;
    if (hx == 1 && vy == 1) {
      for (int y = 0; y < H; ++y)
        memcpy(&out[(size_t)y * W], &c.plane[(size_t)y * stride], W);
      return out;
    }
    std::vector<uint8_t> row(2 * (size_t)dw + 2);
    if (hx == 2 && vy == 1) {
      bool fancy = dw > 2;
      for (int y = 0; y < H; ++y) {
        if (fancy) {
          int in0 = src(y, 0);
          row[0] = (uint8_t)in0;
          row[1] = (uint8_t)((in0 * 3 + src(y, 1) + 2) >> 2);
          for (int x = 1; x < dw - 1; ++x) {
            int v = src(y, x) * 3;
            row[2 * x] = (uint8_t)((v + src(y, x - 1) + 1) >> 2);
            row[2 * x + 1] = (uint8_t)((v + src(y, x + 1) + 2) >> 2);
          }
          int last = src(y, dw - 1);
          row[2 * dw - 2] = (uint8_t)((last * 3 + src(y, dw - 2) + 1) >> 2);
          row[2 * dw - 1] = (uint8_t)last;
        } else {
          for (int x = 0; x < dw; ++x)
            row[2 * x] = row[2 * x + 1] = (uint8_t)src(y, x);
        }
        memcpy(&out[(size_t)y * W], row.data(), W);
      }
      return out;
    }
    if (hx == 1 && vy == 2) {
      // h1v2 fancy (libjpeg-turbo): always fancy
      for (int y = 0; y < H; ++y) {
        int r = y >> 1;
        int other = row_of((y & 1) ? r + 1 : r - 1);
        int bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < W; ++x)
          out[(size_t)y * W + x] =
              (uint8_t)((src(r, x) * 3 + src(other, x) + bias) >> 2);
      }
      return out;
    }
    if (hx == 2 && vy == 2) {
      bool fancy = dw > 2;
      for (int y = 0; y < H; ++y) {
        int r = y >> 1;
        if (fancy) {
          int o = row_of((y & 1) ? r + 1 : r - 1);
          auto colsum = [&](int x) { return src(r, x) * 3 + src(o, x); };
          int thiscol = colsum(0), nextcol = colsum(1), lastcol;
          row[0] = (uint8_t)((thiscol * 4 + 8) >> 4);
          row[1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
          lastcol = thiscol;
          thiscol = nextcol;
          for (int x = 1; x < dw - 1; ++x) {
            nextcol = colsum(x + 1);
            row[2 * x] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
            row[2 * x + 1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
            lastcol = thiscol;
            thiscol = nextcol;
          }
          row[2 * dw - 2] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
          row[2 * dw - 1] = (uint8_t)((thiscol * 4 + 7) >> 4);
        } else {
          for (int x = 0; x < dw; ++x)
            row[2 * x] = row[2 * x + 1] = (uint8_t)src(r, x);
        }
        memcpy(&out[(size_t)y * W], row.data(), W);
      }
      return out;
    }
    fail("unsupported JPEG sampling factors");
  }

  void to_rgb(uint8_t* out) {
    const int W = width, H = height;
    if (comps.size() == 1) {
      const Component& c = comps[0];
      for (int y = 0; y < H; ++y)
        memcpy(out + (size_t)y * W, &c.plane[(size_t)y * c.bw * 8], W);
      return;
    }
    std::vector<uint8_t> p0 = upsample(comps[0]);
    std::vector<uint8_t> p1 = upsample(comps[1]);
    std::vector<uint8_t> p2 = upsample(comps[2]);
    bool rgb = adobe && adobe_transform == 0;
    if (!adobe && comps[0].id == 'R' && comps[1].id == 'G' &&
        comps[2].id == 'B')
      rgb = true;
    size_t npix = (size_t)W * H;
    if (rgb) {
      for (size_t i = 0; i < npix; ++i) {
        out[3 * i] = p0[i];
        out[3 * i + 1] = p1[i];
        out[3 * i + 2] = p2[i];
      }
      return;
    }
    // jdcolor.c: ycc_rgb_convert's tables
    const int SCALEBITS = 16;
    const int64_t ONE_HALF = (int64_t)1 << (SCALEBITS - 1);
    auto FIX = [](double x) -> int64_t {
      return (int64_t)(x * (1L << 16) + 0.5);
    };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = (-FIX(0.71414)) * x;
      cb_g[i] = (-FIX(0.34414)) * x + ONE_HALF;
    }
    auto clamp = [](int v) -> uint8_t {
      return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
    };
    for (size_t i = 0; i < npix; ++i) {
      int y = p0[i], cb = p1[i], cr = p2[i];
      out[3 * i] = clamp(y + cr_r[cr]);
      out[3 * i + 1] =
          clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
      out[3 * i + 2] = clamp(y + cb_b[cb]);
    }
  }
};

uint8_t Decoder::range_table[1024];

struct RangeInit {
  RangeInit() { Decoder::init_range(); }
} range_init;

void set_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    snprintf(err, (size_t)errlen, "%s", msg.c_str());
  }
}

}  // namespace

extern "C" {

// Size and channel count (1 grey, 3 colour) of a JPEG. 0 on success, -1
// with a message in err otherwise.
int fenerf_jpeg_info(const uint8_t* data, size_t size, int* width,
                     int* height, int* channels, char* err, int errlen) {
  try {
    Decoder dec(data, size);
    // parse markers up to the frame header only
    if (size < 4 || data[0] != 0xFF || data[1] != 0xD8)
      fail("not a JPEG file");
    dec.pos = 2;
    for (;;) {
      int c = dec.byte();
      if (c != 0xFF) fail("bad JPEG marker");
      int m;
      do {
        m = dec.byte();
      } while (m == 0xFF);
      if (m == 0xC0 || m == 0xC1) {
        dec.read_sof();
        break;
      }
      if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE)
        fail("progressive JPEG is not supported: only baseline sequential "
             "JPEG is decoded");
      if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF)
        fail("lossless JPEG is not supported: only baseline sequential "
             "JPEG is decoded");
      if (m == 0xC5) fail("hierarchical JPEG is not supported");
      if (m == 0xC9 || m == 0xCC)
        fail("arithmetic-coded JPEG is not supported: only Huffman-coded "
             "baseline JPEG is decoded");
      if (m == 0xD9 || m == 0xDA) fail("JPEG without a frame header");
      if (m >= 0xD0 && m <= 0xD7) continue;
      int len = dec.word();
      dec.pos += len - 2;
    }
    *width = dec.width;
    *height = dec.height;
    *channels = (int)dec.comps.size();
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return -1;
  } catch (...) {
    set_err(err, errlen, "JPEG decode failed");
    return -1;
  }
}

// Decode a JPEG into out: (height, width) grey or (height, width, 3) RGB
// uint8, as fenerf_jpeg_info reported. 0 on success, -1 with a message.
int fenerf_jpeg_decode(const uint8_t* data, size_t size, uint8_t* out,
                       char* err, int errlen) {
  try {
    Decoder dec(data, size);
    dec.parse();
    dec.idct_all();
    dec.to_rgb(out);
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return -1;
  } catch (...) {
    set_err(err, errlen, "JPEG decode failed");
    return -1;
  }
}

// PNG scanline unfilter: raw holds `rows` lines of 1 filter byte + stride
// bytes; out gets rows x stride reconstructed bytes; bpp = bytes per
// complete pixel. 0 on success, -(row + 1) for an unknown filter type.
int fenerf_png_unfilter(const uint8_t* raw, int rows, int stride, int bpp,
                        uint8_t* out) {
  std::vector<uint8_t> zero((size_t)stride, 0);
  for (int y = 0; y < rows; ++y) {
    const uint8_t* line = raw + (size_t)y * (stride + 1);
    int kind = line[0];
    ++line;
    uint8_t* cur = out + (size_t)y * stride;
    const uint8_t* prior = y ? out + (size_t)(y - 1) * stride : zero.data();
    switch (kind) {
      case 0:
        memcpy(cur, line, (size_t)stride);
        break;
      case 1:
        for (int i = 0; i < stride; ++i)
          cur[i] = (uint8_t)(line[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < stride; ++i) cur[i] = (uint8_t)(line[i] + prior[i]);
        break;
      case 3:
        for (int i = 0; i < stride; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          cur[i] = (uint8_t)(line[i] + ((a + prior[i]) >> 1));
        }
        break;
      case 4:
        for (int i = 0; i < stride; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          int b = prior[i];
          int c = i >= bpp ? prior[i - bpp] : 0;
          int p = a + b - c;
          int pa = p > a ? p - a : a - p;
          int pb = p > b ? p - b : b - p;
          int pc = p > c ? p - c : c - p;
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = (uint8_t)(line[i] + pred);
        }
        break;
      default:
        return -(y + 1);
    }
  }
  return 0;
}

}  // extern "C"
