// Host image decoding for the port's datasets: baseline JPEG and PNG row
// unfiltering, built with the host C++ compiler and loaded with ctypes
// (mm_distillnet_torch/data/decode.py is the Python side).
//
// The JAX package reads its frames with cv2.imread, which decodes JPEG with
// libjpeg-turbo. This file repeats libjpeg's arithmetic so that its output
// is bit-equal to cv2.imread's:
//   - the `islow` inverse DCT (jidctint.c: CONST_BITS 13, PASS1_BITS 2,
//     the post-IDCT range-limit table indexed with RANGE_MASK);
//   - "fancy" chroma upsampling (jdsample.c: h2v1 and h1v2 triangle
//     filters with +1/+2 biases, h2v2 with alternating +8/+7 biases, the
//     edge rows and columns replicated from the downsampled plane);
//   - YCbCr -> RGB through the fixed-point tables of jdcolor.c
//     (SCALEBITS 16), and RGB -> grey through those of jccolor.c;
//   - a grey read of a colour file returns the Y plane, as libjpeg's
//     JCS_GRAYSCALE output does.
// Only sequential Huffman-coded 8-bit files (SOF0, SOF1) are decoded; the
// other modes raise with their name. Nothing here touches Python objects,
// so ctypes releases the interpreter lock for the whole call and the
// loader's threads decode in parallel.
//
// PNG: the zlib stream is inflated by Python's zlib; png_unfilter undoes the
// five row filters (Paeth is sequential along a row, hence here).
//
// Resampling (data/imgproc.py, data/transforms.py): filter_cols and
// filter_rows apply a few taps per output column or row in float32, the
// products summed in tap order, one rounding each (built without FMA
// contraction, so a 2-tap pass rounds as cv2's INTER_LINEAR loop and numpy
// do). The loader's threads run them without the interpreter lock.
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct DecodeError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw DecodeError{msg}; }

// zigzag index -> natural index; 16 extra entries absorb a corrupt run
// length past the end of the block, as libjpeg's jpeg_natural_order does.
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t look_len[1 << kLookBits];  // 0: code longer than kLookBits
  uint8_t look_val[1 << kLookBits];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int bw = 0, bh = 0;  // blocks stored (whole MCUs)
  int dw = 0, dh = 0;  // samples in the downsampled plane
  int pred = 0;
  std::vector<int16_t> coef;  // bh * bw blocks of 64, natural order
};

enum ColorSpace { kGrey = 0, kYCbCr = 1, kRGB = 2 };

struct Jpeg {
  const uint8_t* data = nullptr;
  size_t size = 0;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0;
  bool frame = false;
  int scans = 0;
  Component comp[4];
  uint16_t quant[4][64];  // natural order
  bool quant_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int64_t exif_offset = -1, exif_size = 0;
  int max_h = 1, max_v = 1, mcus_x = 0, mcus_y = 0;
};

uint8_t byte_at(const Jpeg& j, size_t p) {
  if (p >= j.size) fail("truncated JPEG data");
  return j.data[p];
}

int u16_at(const Jpeg& j, size_t p) {
  return (byte_at(j, p) << 8) | byte_at(j, p + 1);
}

void build_huffman(Huffman& h, const uint8_t counts[16], const uint8_t* vals,
                   int nvals) {
  h.defined = true;
  std::memset(h.look_len, 0, sizeof(h.look_len));
  std::memcpy(h.vals, vals, nvals);
  int code = 0, k = 0;
  for (int len = 1; len <= 16; len++) {
    int n = counts[len - 1];
    h.valoffset[len] = k - code;
    for (int i = 0; i < n; i++, k++, code++) {
      if (len <= kLookBits) {
        int shift = kLookBits - len;
        for (int f = 0; f < (1 << shift); f++) {
          h.look_len[(code << shift) | f] = (uint8_t)len;
          h.look_val[(code << shift) | f] = vals[k];
        }
      }
    }
    h.maxcode[len] = n ? code - 1 : -1;
    if (code > (1 << len)) fail("corrupt JPEG Huffman table");
    code <<= 1;
  }
}

void read_sof(Jpeg& j, size_t p, int len) {
  if (j.frame) fail("JPEG with two frame headers");
  int precision = byte_at(j, p);
  if (precision != 8)
    fail("JPEG with " + std::to_string(precision) +
         "-bit samples is not supported (8-bit baseline only)");
  j.height = u16_at(j, p + 1);
  j.width = u16_at(j, p + 3);
  j.ncomp = byte_at(j, p + 5);
  if (j.height == 0)
    fail("JPEG whose height comes in a DNL marker is not supported");
  if (j.width == 0) fail("JPEG of width 0");
  if (j.ncomp != 1 && j.ncomp != 3)
    fail("JPEG with " + std::to_string(j.ncomp) +
         " components is not supported (1 or 3)");
  if (len != 8 + 3 * j.ncomp) fail("corrupt JPEG frame header");
  for (int c = 0; c < j.ncomp; c++) {
    Component& cp = j.comp[c];
    cp.id = byte_at(j, p + 6 + 3 * c);
    int hv = byte_at(j, p + 7 + 3 * c);
    cp.h = hv >> 4;
    cp.v = hv & 15;
    cp.tq = byte_at(j, p + 8 + 3 * c);
    if (cp.h < 1 || cp.h > 4 || cp.v < 1 || cp.v > 4 || cp.tq > 3)
      fail("corrupt JPEG frame header");
    j.max_h = std::max(j.max_h, cp.h);
    j.max_v = std::max(j.max_v, cp.v);
  }
  j.mcus_x = (j.width + 8 * j.max_h - 1) / (8 * j.max_h);
  j.mcus_y = (j.height + 8 * j.max_v - 1) / (8 * j.max_v);
  for (int c = 0; c < j.ncomp; c++) {
    Component& cp = j.comp[c];
    cp.dw = (int)(((int64_t)j.width * cp.h + j.max_h - 1) / j.max_h);
    cp.dh = (int)(((int64_t)j.height * cp.v + j.max_v - 1) / j.max_v);
    cp.bw = j.mcus_x * cp.h;
    cp.bh = j.mcus_y * cp.v;
  }
  j.frame = true;
}

void read_dht(Jpeg& j, size_t p, size_t end) {
  while (p < end) {
    int tc_th = byte_at(j, p);
    int tc = tc_th >> 4, th = tc_th & 15;
    if (tc > 1 || th > 3) fail("corrupt JPEG Huffman table");
    uint8_t counts[16];
    int total = 0;
    for (int i = 0; i < 16; i++) {
      counts[i] = byte_at(j, p + 1 + i);
      total += counts[i];
    }
    if (total > 256 || p + 17 + total > end)
      fail("corrupt JPEG Huffman table");
    build_huffman(tc ? j.ac[th] : j.dc[th], counts, j.data + p + 17, total);
    p += 17 + total;
  }
}

void read_dqt(Jpeg& j, size_t p, size_t end) {
  while (p < end) {
    int pq_tq = byte_at(j, p);
    int pq = pq_tq >> 4, tq = pq_tq & 15;
    if (pq > 1 || tq > 3) fail("corrupt JPEG quantization table");
    for (int i = 0; i < 64; i++) {
      int v = pq ? u16_at(j, p + 1 + 2 * i) : byte_at(j, p + 1 + i);
      j.quant[tq][kNatural[i]] = (uint16_t)v;
    }
    j.quant_defined[tq] = true;
    p += 1 + (pq ? 128 : 64);
  }
}

// Entropy-coded data: bytes into a 64-bit buffer, FF 00 unstuffed; at a
// marker the reader stops and feeds zeros, as libjpeg does.
struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t pos;
  uint64_t buf = 0;
  int count = 0;
  bool at_marker = false;

  void fill() {
    while (count <= 56) {
      uint64_t b = 0;
      if (!at_marker && pos < size) {
        b = data[pos];
        if (b == 0xFF) {
          uint8_t next = pos + 1 < size ? data[pos + 1] : 0xD9;
          if (next == 0x00) {
            pos += 2;
          } else {
            at_marker = true;
            b = 0;
          }
        } else {
          pos++;
        }
      }
      buf |= b << (56 - count);
      count += 8;
    }
  }
  uint32_t bits(int k) {
    if (count < k) fill();
    uint32_t v = (uint32_t)(buf >> (64 - k));
    buf <<= k;
    count -= k;
    return v;
  }
  // the marker that ends an interval or the scan: skips to it
  void reset() {
    buf = 0;
    count = 0;
    at_marker = false;
  }
};

inline int decode_symbol(BitReader& br, const Huffman& h) {
  if (br.count < 16) br.fill();
  uint32_t look = (uint32_t)(br.buf >> (64 - kLookBits));
  int len = h.look_len[look];
  if (len) {
    br.buf <<= len;
    br.count -= len;
    return h.look_val[look];
  }
  uint32_t code16 = (uint32_t)(br.buf >> 48);
  for (len = kLookBits + 1; len <= 16; len++) {
    int32_t code = (int32_t)(code16 >> (16 - len));
    if (code <= h.maxcode[len]) {
      br.buf <<= len;
      br.count -= len;
      return h.vals[h.valoffset[len] + code];
    }
  }
  fail("corrupt JPEG data: bad Huffman code");
}

inline int extend(uint32_t v, int s) {
  return v < (1u << (s - 1)) ? (int)v - (1 << s) + 1 : (int)v;
}

inline void decode_block(BitReader& br, Component& cp, const Huffman& dc,
                         const Huffman& ac, int16_t* block) {
  int s = decode_symbol(br, dc);
  if (s > 16) fail("corrupt JPEG data: DC magnitude");
  int diff = s ? extend(br.bits(s), s) : 0;
  cp.pred += diff;
  block[0] = (int16_t)cp.pred;
  for (int k = 1; k < 64; k++) {
    int rs = decode_symbol(br, ac);
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      block[kNatural[k]] = (int16_t)extend(br.bits(s), s);
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

// Skip past the marker the reader stopped at; returns its code.
int next_marker(Jpeg& j) {
  while (j.pos < j.size) {
    if (j.data[j.pos] != 0xFF) {
      j.pos++;
      continue;
    }
    size_t q = j.pos + 1;
    while (q < j.size && j.data[q] == 0xFF) q++;
    if (q >= j.size) break;
    int m = j.data[q];
    if (m == 0x00) {
      j.pos = q + 1;
      continue;
    }
    j.pos = q + 1;
    return m;
  }
  fail("truncated JPEG data: no end-of-image marker");
}

void read_scan(Jpeg& j, size_t p, int len) {
  if (!j.frame) fail("JPEG scan before the frame header");
  int ns = byte_at(j, p);
  if (ns < 1 || ns > j.ncomp || len != 6 + 2 * ns)
    fail("corrupt JPEG scan header");
  Component* cs[4];
  for (int i = 0; i < ns; i++) {
    int id = byte_at(j, p + 1 + 2 * i);
    int t = byte_at(j, p + 2 + 2 * i);
    cs[i] = nullptr;
    for (int c = 0; c < j.ncomp; c++)
      if (j.comp[c].id == id) cs[i] = &j.comp[c];
    if (!cs[i]) fail("corrupt JPEG scan header: unknown component");
    cs[i]->td = t >> 4;
    cs[i]->ta = t & 15;
    if (cs[i]->td > 3 || cs[i]->ta > 3 || !j.dc[cs[i]->td].defined ||
        !j.ac[cs[i]->ta].defined)
      fail("JPEG scan uses an undefined Huffman table");
    if (!j.quant_defined[cs[i]->tq])
      fail("JPEG component uses an undefined quantization table");
    if (cs[i]->coef.empty())
      cs[i]->coef.assign((size_t)cs[i]->bw * cs[i]->bh * 64, 0);
  }
  int ss = byte_at(j, p + 1 + 2 * ns), se = byte_at(j, p + 2 + 2 * ns);
  int ah_al = byte_at(j, p + 3 + 2 * ns);
  if (ss != 0 || se != 63 || ah_al != 0)
    fail("corrupt JPEG scan header for a sequential frame");
  j.pos = p + len - 2;

  BitReader br{j.data, j.size, j.pos};
  for (int i = 0; i < ns; i++) cs[i]->pred = 0;
  int units_x, units_y;
  if (ns == 1) {  // non-interleaved: one block per MCU, the plane's blocks
    units_x = (cs[0]->dw + 7) / 8;
    units_y = (cs[0]->dh + 7) / 8;
  } else {
    units_x = j.mcus_x;
    units_y = j.mcus_y;
  }
  int64_t total = (int64_t)units_x * units_y, done = 0;
  int expected_rst = 0;
  for (int uy = 0; uy < units_y; uy++) {
    for (int ux = 0; ux < units_x; ux++, done++) {
      if (j.restart_interval && done && done % j.restart_interval == 0) {
        j.pos = br.pos;
        int m = next_marker(j);
        if (m != 0xD0 + expected_rst)
          fail("corrupt JPEG data: missing restart marker");
        expected_rst = (expected_rst + 1) & 7;
        br.pos = j.pos;
        br.reset();
        for (int i = 0; i < ns; i++) cs[i]->pred = 0;
      }
      if (ns == 1) {
        Component& cp = *cs[0];
        int16_t* block = &cp.coef[((size_t)uy * cp.bw + ux) * 64];
        decode_block(br, cp, j.dc[cp.td], j.ac[cp.ta], block);
      } else {
        for (int i = 0; i < ns; i++) {
          Component& cp = *cs[i];
          for (int by = 0; by < cp.v; by++)
            for (int bx = 0; bx < cp.h; bx++) {
              size_t row = (size_t)uy * cp.v + by, col = (size_t)ux * cp.h + bx;
              decode_block(br, cp, j.dc[cp.td], j.ac[cp.ta],
                           &cp.coef[(row * cp.bw + col) * 64]);
            }
        }
      }
    }
  }
  (void)total;
  j.pos = br.pos;
  j.scans++;
}

void parse(Jpeg& j, bool headers_only) {
  if (j.size < 4 || j.data[0] != 0xFF || j.data[1] != 0xD8)
    fail("not a JPEG file");
  j.pos = 2;
  for (;;) {
    int m = next_marker(j);
    if (m == 0xD9) {  // EOI
      if (!j.frame || (!headers_only && j.scans == 0))
        fail("JPEG without image data");
      return;
    }
    if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;  // TEM, stray RSTn
    int len = u16_at(j, j.pos);
    if (len < 2) fail("corrupt JPEG marker length");
    size_t p = j.pos + 2, end = j.pos + len;
    if (end > j.size) fail("truncated JPEG data");
    switch (m) {
      case 0xC0:
      case 0xC1:
        read_sof(j, p, len);
        break;
      case 0xC2:
        fail("progressive JPEG (SOF2) is not supported");
      case 0xC3:
        fail("lossless JPEG (SOF3) is not supported");
      case 0xC5:
      case 0xC6:
      case 0xC7:
        fail("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) +
             ") is not supported");
      case 0xC9:
      case 0xCA:
      case 0xCB:
      case 0xCD:
      case 0xCE:
      case 0xCF:
        fail("arithmetic-coded JPEG (SOF" + std::to_string(m - 0xC0) +
             ") is not supported");
      case 0xCC:
        fail("arithmetic-coded JPEG (DAC) is not supported");
      case 0xC4:
        read_dht(j, p, end);
        break;
      case 0xDB:
        read_dqt(j, p, end);
        break;
      case 0xDD:
        j.restart_interval = u16_at(j, p);
        break;
      case 0xDC:
        fail("JPEG with a DNL marker is not supported");
      case 0xE0:
        if (len >= 7 && std::memcmp(j.data + p, "JFIF\0", 5) == 0)
          j.jfif = true;
        break;
      case 0xE1:
        if (len >= 8 && std::memcmp(j.data + p, "Exif\0\0", 6) == 0 &&
            j.exif_offset < 0) {
          j.exif_offset = (int64_t)(p + 6);
          j.exif_size = (int64_t)(end - p - 6);
        }
        break;
      case 0xEE:
        if (len >= 14 && std::memcmp(j.data + p, "Adobe", 5) == 0) {
          j.adobe = true;
          j.adobe_transform = j.data[p + 11];
        }
        break;
      case 0xDA:
        if (headers_only) return;
        read_scan(j, p, len);
        continue;  // j.pos is where the entropy-coded data ended
      default:
        break;  // APPn, COM and the rest: skipped
    }
    j.pos = end;
  }
}

ColorSpace color_space(const Jpeg& j) {
  if (j.ncomp == 1) return kGrey;
  // jdapimin.c default_decompress_parms
  if (j.jfif) return kYCbCr;
  if (j.adobe) return j.adobe_transform == 0 ? kRGB : kYCbCr;
  int c0 = j.comp[0].id, c1 = j.comp[1].id, c2 = j.comp[2].id;
  if (c0 == 82 && c1 == 71 && c2 == 66) return kRGB;  // 'R', 'G', 'B'
  return kYCbCr;
}

// ---- islow inverse DCT (jidctint.c) ----
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + ((int64_t)1 << (n - 1))) >> n;
}

// post-IDCT range limit: idct_limit[x & 1023] (jdmaster.c
// prepare_range_limit_table, offset by CENTERJSAMPLE)
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; i++) {
      int x = i < 512 ? i : i - 1024;  // the signed value i stands for
      int y;
      if (x >= -128 && x < 128) y = x + 128;
      else if (x >= 128) y = 255;   // 128..511
      else y = 0;                   // -512..-129
      t[i] = (uint8_t)y;
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
        !ip[56]) {
      int dc = (int)(ip[0] * qp[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; r++) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int n = kConstBits - kPass1Bits;
    wp[0] = (int)descale(tmp10 + tmp3, n);
    wp[56] = (int)descale(tmp10 - tmp3, n);
    wp[8] = (int)descale(tmp11 + tmp2, n);
    wp[48] = (int)descale(tmp11 - tmp2, n);
    wp[16] = (int)descale(tmp12 + tmp1, n);
    wp[40] = (int)descale(tmp12 - tmp1, n);
    wp[24] = (int)descale(tmp13 + tmp0, n);
    wp[32] = (int)descale(tmp13 - tmp0, n);
  }
  for (int r = 0; r < 8; r++) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + (size_t)r * stride;
    constexpr int n = kConstBits + kPass1Bits + 3;
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << kConstBits);
    int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = kRange.t[descale(tmp10 + tmp3, n) & 1023];
    op[7] = kRange.t[descale(tmp10 - tmp3, n) & 1023];
    op[1] = kRange.t[descale(tmp11 + tmp2, n) & 1023];
    op[6] = kRange.t[descale(tmp11 - tmp2, n) & 1023];
    op[2] = kRange.t[descale(tmp12 + tmp1, n) & 1023];
    op[5] = kRange.t[descale(tmp12 - tmp1, n) & 1023];
    op[3] = kRange.t[descale(tmp13 + tmp0, n) & 1023];
    op[4] = kRange.t[descale(tmp13 - tmp0, n) & 1023];
  }
}

// The component's samples, (bh * 8) x (bw * 8), row stride bw * 8.
std::vector<uint8_t> component_plane(const Jpeg& j, const Component& cp) {
  size_t stride = (size_t)cp.bw * 8;
  std::vector<uint8_t> plane(stride * cp.bh * 8);
  // the blocks that hold samples of the plane
  int need_x = (cp.dw + 7) / 8, need_y = (cp.dh + 7) / 8;
  for (int by = 0; by < need_y; by++)
    for (int bx = 0; bx < need_x; bx++)
      idct_islow(&cp.coef[((size_t)by * cp.bw + bx) * 64], j.quant[cp.tq],
                 &plane[(size_t)by * 8 * stride + (size_t)bx * 8], (int)stride);
  return plane;
}

// Upsample a downsampled plane to max_h / max_v (jdsample.c); the result
// is (dh * fv) x (dw * fh) with row stride out_stride. Rows past dh and
// columns past dw are never read: the edges replicate the last real ones.
std::vector<uint8_t> upsample(const Jpeg& j, const Component& cp,
                              const std::vector<uint8_t>& plane,
                              size_t& out_stride) {
  size_t in_stride = (size_t)cp.bw * 8;
  int fh = j.max_h / cp.h, fv = j.max_v / cp.v;
  if (j.max_h % cp.h || j.max_v % cp.v)
    fail("JPEG with a non-integral sampling ratio is not supported");
  if (fh == 1 && fv == 1) {
    out_stride = in_stride;
    return plane;
  }
  int dw = cp.dw, dh = cp.dh;
  out_stride = (size_t)dw * fh;
  std::vector<uint8_t> out(out_stride * (size_t)dh * fv);
  auto row = [&](int y) {  // context rows replicate at the top and bottom
    y = std::min(std::max(y, 0), dh - 1);
    return &plane[(size_t)y * in_stride];
  };
  if (fh == 2 && fv == 1 && dw > 2) {  // h2v1_fancy_upsample
    for (int y = 0; y < dh; y++) {
      const uint8_t* in = row(y);
      uint8_t* o = &out[(size_t)y * out_stride];
      o[0] = in[0];
      o[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; x++) {
        int v = in[x] * 3;
        o[2 * x] = (uint8_t)((v + in[x - 1] + 1) >> 2);
        o[2 * x + 1] = (uint8_t)((v + in[x + 1] + 2) >> 2);
      }
      o[2 * dw - 2] = (uint8_t)((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
      o[2 * dw - 1] = in[dw - 1];
    }
    return out;
  }
  if (fh == 1 && fv == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < dh; y++)
      for (int v = 0; v < 2; v++) {
        const uint8_t* in0 = row(y);
        const uint8_t* in1 = row(v == 0 ? y - 1 : y + 1);
        int bias = v == 0 ? 1 : 2;
        uint8_t* o = &out[(size_t)(2 * y + v) * out_stride];
        for (int x = 0; x < dw; x++)
          o[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
      }
    return out;
  }
  if (fh == 2 && fv == 2 && dw > 2) {  // h2v2_fancy_upsample
    for (int y = 0; y < dh; y++)
      for (int v = 0; v < 2; v++) {
        const uint8_t* in0 = row(y);
        const uint8_t* in1 = row(v == 0 ? y - 1 : y + 1);
        uint8_t* o = &out[(size_t)(2 * y + v) * out_stride];
        int this_sum = in0[0] * 3 + in1[0];
        int next_sum = in0[1] * 3 + in1[1];
        o[0] = (uint8_t)((this_sum * 4 + 8) >> 4);
        o[1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
        int last_sum = this_sum;
        this_sum = next_sum;
        for (int x = 1; x < dw - 1; x++) {
          next_sum = in0[x + 1] * 3 + in1[x + 1];
          o[2 * x] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
          o[2 * x + 1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
          last_sum = this_sum;
          this_sum = next_sum;
        }
        o[2 * dw - 2] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
        o[2 * dw - 1] = (uint8_t)((this_sum * 4 + 7) >> 4);
      }
    return out;
  }
  // int_upsample / h2v1_upsample / h2v2_upsample: box replication
  for (int y = 0; y < dh; y++) {
    const uint8_t* in = row(y);
    for (int v = 0; v < fv; v++) {
      uint8_t* o = &out[(size_t)(y * fv + v) * out_stride];
      for (int x = 0; x < dw; x++)
        for (int h = 0; h < fh; h++) o[x * fh + h] = in[x];
    }
  }
  return out;
}

// ---- colour conversion (jdcolor.c, jccolor.c) ----
constexpr int kScaleBits = 16;
constexpr int64_t kOneHalf = (int64_t)1 << (kScaleBits - 1);
inline int64_t fix(double x) { return (int64_t)(x * (1L << kScaleBits) + 0.5); }

struct ColorTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  int64_t r_y[256], g_y[256], b_y[256];
  ColorTables() {
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = (int)((fix(1.40200) * x + kOneHalf) >> kScaleBits);
      cb_b[i] = (int)((fix(1.77200) * x + kOneHalf) >> kScaleBits);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kOneHalf;
      r_y[i] = fix(0.29900) * i;
      g_y[i] = fix(0.58700) * i;
      b_y[i] = fix(0.11400) * i + kOneHalf;
    }
  }
};
const ColorTables kColor;

inline uint8_t clamp255(int v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// out: height x width x (grey ? 1 : 3), BGR order for colour.
void decode_jpeg(const uint8_t* data, size_t size, bool grey, uint8_t* out) {
  Jpeg j;
  j.data = data;
  j.size = size;
  parse(j, false);
  ColorSpace cs = color_space(j);
  const int W = j.width, H = j.height;
  int planes = (cs == kGrey || (grey && cs == kYCbCr)) ? 1 : 3;
  std::vector<uint8_t> up[3];
  size_t stride[3];
  for (int c = 0; c < planes; c++) {
    const Component& cp = j.comp[c];
    if (cp.coef.empty()) fail("JPEG component missing from every scan");
    up[c] = upsample(j, cp, component_plane(j, cp), stride[c]);
  }
  if (planes == 1) {  // grey file, or the Y plane of a colour one
    for (int y = 0; y < H; y++) {
      const uint8_t* s = &up[0][(size_t)y * stride[0]];
      if (grey) {
        std::memcpy(out + (size_t)y * W, s, W);
      } else {
        uint8_t* o = out + (size_t)y * W * 3;
        for (int x = 0; x < W; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = s[x];
      }
    }
    return;
  }
  for (int y = 0; y < H; y++) {
    const uint8_t* p0 = &up[0][(size_t)y * stride[0]];
    const uint8_t* p1 = &up[1][(size_t)y * stride[1]];
    const uint8_t* p2 = &up[2][(size_t)y * stride[2]];
    if (cs == kRGB) {
      if (grey) {  // rgb_gray_convert
        uint8_t* o = out + (size_t)y * W;
        for (int x = 0; x < W; x++)
          o[x] = (uint8_t)((kColor.r_y[p0[x]] + kColor.g_y[p1[x]] +
                            kColor.b_y[p2[x]]) >> kScaleBits);
      } else {
        uint8_t* o = out + (size_t)y * W * 3;
        for (int x = 0; x < W; x++) {
          o[3 * x] = p2[x];
          o[3 * x + 1] = p1[x];
          o[3 * x + 2] = p0[x];
        }
      }
      continue;
    }
    uint8_t* o = out + (size_t)y * W * 3;  // ycc_rgb_convert, BGR out
    for (int x = 0; x < W; x++) {
      int yy = p0[x], cb = p1[x], cr = p2[x];
      o[3 * x + 2] = clamp255(yy + kColor.cr_r[cr]);
      o[3 * x + 1] = clamp255(
          yy + (int)((kColor.cb_g[cb] + kColor.cr_g[cr]) >> kScaleBits));
      o[3 * x] = clamp255(yy + kColor.cb_b[cb]);
    }
  }
}

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    std::snprintf(err, (size_t)errlen, "%s", msg.c_str());
  }
}

}  // namespace

extern "C" {

// info: width, height, components, colour space (0 grey, 1 YCbCr, 2 RGB),
// then the offset and size of an APP1 Exif payload (-1, 0 when none).
int mmdt_jpeg_info(const uint8_t* data, int64_t size, int64_t* info,
                   char* err, int errlen) {
  try {
    Jpeg j;
    j.data = data;
    j.size = (size_t)size;
    parse(j, true);
    if (!j.frame) fail("JPEG without a frame header");
    info[0] = j.width;
    info[1] = j.height;
    info[2] = j.ncomp;
    info[3] = color_space(j);
    info[4] = j.exif_offset;
    info[5] = j.exif_size;
    return 0;
  } catch (const DecodeError& e) {
    set_error(err, errlen, e.msg);
    return 1;
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory decoding a JPEG file");
    return 1;
  }
}

// grey != 0: height x width (the Y plane of a colour file); else
// height x width x 3 in BGR order. out holds exactly that many bytes.
int mmdt_jpeg_decode(const uint8_t* data, int64_t size, int grey,
                     uint8_t* out, char* err, int errlen) {
  try {
    decode_jpeg(data, (size_t)size, grey != 0, out);
    return 0;
  } catch (const DecodeError& e) {
    set_error(err, errlen, e.msg);
    return 1;
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory decoding a JPEG file");
    return 1;
  }
}

// raw: height rows of (1 filter byte + rowbytes); out: height x rowbytes.
// bpp: bytes per complete pixel (at least 1).
int mmdt_png_unfilter(const uint8_t* raw, int64_t raw_size, uint8_t* out,
                      int64_t height, int64_t rowbytes, int64_t bpp,
                      char* err, int errlen) {
  if (raw_size < height * (rowbytes + 1)) {
    set_error(err, errlen, "truncated PNG image data");
    return 1;
  }
  for (int64_t y = 0; y < height; y++) {
    const uint8_t* src = raw + y * (rowbytes + 1);
    int filter = *src++;
    uint8_t* dst = out + y * rowbytes;
    const uint8_t* up = y ? dst - rowbytes : nullptr;
    switch (filter) {
      case 0:
        std::memcpy(dst, src, (size_t)rowbytes);
        break;
      case 1:
        for (int64_t i = 0; i < rowbytes; i++)
          dst[i] = (uint8_t)(src[i] + (i >= bpp ? dst[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < rowbytes; i++)
          dst[i] = (uint8_t)(src[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < rowbytes; i++) {
          int left = i >= bpp ? dst[i - bpp] : 0, above = up ? up[i] : 0;
          dst[i] = (uint8_t)(src[i] + ((left + above) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < rowbytes; i++) {
          int a = i >= bpp ? dst[i - bpp] : 0, b = up ? up[i] : 0;
          int c = (i >= bpp && up) ? up[i - bpp] : 0;
          int p = a + b - c;
          int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          dst[i] = (uint8_t)(src[i] + pred);
        }
        break;
      default:
        set_error(err, errlen,
                  "corrupt PNG data: row filter " + std::to_string(filter));
        return 1;
    }
  }
  return 0;
}

// out[y, x, c] = sum_t w[x, t] * in[y, idx[x, t], c]; in: rows x cols_in x
// channels, out: rows x cols_out x channels, float32.
void mmdt_filter_cols(const float* in, float* out, int64_t rows,
                      int64_t cols_in, int64_t cols_out, int64_t channels,
                      int64_t taps, const int64_t* idx, const float* w) {
  for (int64_t y = 0; y < rows; y++) {
    const float* src = in + y * cols_in * channels;
    float* dst = out + y * cols_out * channels;
    for (int64_t x = 0; x < cols_out; x++) {
      const int64_t* ix = idx + x * taps;
      const float* wx = w + x * taps;
      for (int64_t c = 0; c < channels; c++) {
        float acc = src[ix[0] * channels + c] * wx[0];
        for (int64_t t = 1; t < taps; t++)
          acc += src[ix[t] * channels + c] * wx[t];
        dst[x * channels + c] = acc;
      }
    }
  }
}

// out[r, :] = sum_t w[r, t] * in[idx[r, t], :]; rows of row_len float32.
void mmdt_filter_rows(const float* in, float* out, int64_t rows_out,
                      int64_t row_len, int64_t taps, const int64_t* idx,
                      const float* w) {
  for (int64_t r = 0; r < rows_out; r++) {
    float* dst = out + r * row_len;
    const float* s0 = in + idx[r * taps] * row_len;
    float w0 = w[r * taps];
    for (int64_t i = 0; i < row_len; i++) dst[i] = s0[i] * w0;
    for (int64_t t = 1; t < taps; t++) {
      const float* st = in + idx[r * taps + t] * row_len;
      float wt = w[r * taps + t];
      for (int64_t i = 0; i < row_len; i++) dst[i] += st[i] * wt;
    }
  }
}

}  // extern "C"
