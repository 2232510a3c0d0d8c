// int8 x int8 -> int32 2-D convolution for Hopper (sm_90a), the card route of
// the int8 post-training-quantized forward (mm_distillnet_torch/quant.py),
// and the same convolution fused with the quantize prologue and the
// dequantize epilogue around it.
//
// Replaces no Pallas kernel: the JAX package computes this convolution with
// XLA (mm_distillnet_tpu/quant.py:209-223, lax.conv_general_dilated with
// preferred_element_type=int32) and fuses the fp32 rescale and bias into it.
// It takes every quantized conv that the 'int_mm' route (the 1x1 stride-1
// ungrouped convs: int8_gemm.cuh's fused s8 GEMM, torch._int_mm for the
// plain version's sums) does not: at D2@768 batch 8, 103 depthwise 3x3 /
// 5x5 convs at stride 1 and 2 over 16-2,112 channels and 8x8-386x386
// maps, and the 3x3 stride-2 stem (8 -> 32 channels).
//
// Two entry points over the same tile loops:
//   int8_conv2d       int8 NHWC input, int32 NHWC output (exact sums);
//   quantized_conv2d  bf16, fp16 or fp32 NHWC input x, quantized as it is
//                     loaded (clamp(rint(x / ascale), -127, 127), IEEE
//                     division as torch's division by a 0-dim CUDA tensor),
//                     and the int32 sums dequantized before the store:
//                     ((float)acc * (ascale * wscale[o])) [+ bias[o]],
//                     rounded through the compute dtype (bf16, fp16 or
//                     fp32), written in x's dtype. Each rounding is an _rn
//                     intrinsic or cvt.rn, so nvcc cannot contract it into
//                     an FMA and the result is torch's unfused sequence bit
//                     for bit.
//
// What bounds it on an H100: bytes. A depthwise output is 9 or 25
// multiply-adds of one channel, so there is no reduction dimension for the
// tensor cores (wgmma) and dp4a's sum runs across bytes; the input is read
// and the output written once at 3.35 TB/s, and the int32 output (or the
// 16-bit input and output of the fused kernel) is most of those bytes.
//
// The design (the launch plan, one function: ops/int8_conv.py launch_plan):
// - Depthwise (groups == Cin == Cout, Cin % 4 == 0, 3x3 or 5x5, stride 1
//   or 2). One CTA per (image, tile of th x tw outputs, block of cb
//   channels). The tile's input halo, (th-1)*s+k rows x (tw-1)*s+k columns
//   x cb channels, is loaded once into shared memory as int8, zero outside
//   the input (padding, ragged tiles), laid out as [row][column group]
//   [channel] words: a word holds one channel at 4 consecutive columns.
//   Each thread loads a column group as 4 vector loads of 4-16 channels
//   (16 bytes where the channel count allows it), in flight together, and
//   transposes them with byte permutes (int8) or quantizes them in
//   registers (the fused kernel). The block's taps are contiguous in OIHW
//   (Cin/g = 1) and are copied as words. Each thread owns 4 consecutive
//   channels and a strip of 8 outputs along W for rpt rows: per row of
//   taps it reads the strip's words of its 4 channels (16-byte reads), and
//   each output's window of taps along W is one funnel shift of two words,
//   so one __dp4a sums 3 taps (a 3x3 row; the fourth tap byte is zero) or
//   two sum 5 (a 5x5 row). Each 4-channel result goes out as one 16-byte
//   (int32, fp32) or 8-byte (bf16, fp16) store, coalesced along the
//   channels.
//   The slot pitch is padded so a quarter-warp's reads hit distinct banks.
// - Stem (dense, kh*kw*ceil(Cin/4) <= 64 words, Cout % 8 == 0): the halo
//   as 4-channel words (zero-padded channels), the weights read as words
//   and repacked into shared memory as [tap][word][Cout] words, each
//   thread 8 output channels of one output pixel for rpt rows with
//   __dp4a, two 16-byte stores an output.
// - General (everything else): one thread per output, the taps in an
//   int32 loop, 32-bit index arithmetic.
// Index arithmetic is 32-bit inside an image (the wrapper checks that an
// image has fewer than 2^31 elements); no division sits in a loop over
// taps. The sums are exact in int32 (|acc| <= 127^2 K, the wrapper checks
// K), so any order gives the same bits. No CTA walks a second tile, so
// nothing is double-buffered: several CTAs per SM overlap one's loads and
// prologue with another's sums. On an H100 this beat persistent CTAs that
// split into producer warps (the quantize) and consumer warps (the sums):
// the quantize costs more issue slots than the sums, so fixed groups leave
// one of them idle.
// The quantize of a halo: value by value (quant1) on 3x3 stride-1 tiles,
// as one branch-free group a slot (quant_words) on the others, whichever
// measured faster on the card for the class.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <type_traits>

#include "int8_common.cuh"

namespace {

using namespace int8q;

// The launch's fields, in the order of ops/int8_conv.py ARGS.
struct Args {
  int B, H, W, cin, ho, wo, cout, kh, kw, sh, sw, pt, pl, groups;  // the conv
  int path, threads, gx, gy, gz, smem;                               // launch
  int cb, vec, th, tw, spw, rpt, halo_h, halo_w, pitch, cblocks;     // tiles
  int in_dtype, bias_dtype, compute_dtype;                           // fused
};
constexpr int kNumArgs = 33;
static_assert(sizeof(Args) == kNumArgs * sizeof(int), "Args is ints only");

enum Path { kDepthwise = 0, kStem = 1, kGeneral = 2 };
constexpr int kSpw = 8;              // outputs per thread along W (depthwise)
constexpr int kSmemLimit = 232448;   // shared memory a CTA may opt in to
constexpr int kMaxThreads = 512;     // the tile kernels' CTA (<= 128 regs)
constexpr int kStemRows = 4;         // the stem's most output rows a thread

struct Ptrs {
  const void* x;
  const int8_t* w;
  void* out;
  const float* ascale;  // () fp32, the fused kernel only
  const float* wscale;  // (Cout,) fp32
  const void* bias;     // (Cout,) in bias_dtype, or null
};

template <int N> struct Raw;
template <> struct Raw<4> { using T = int; };
template <> struct Raw<8> { using T = int2; };
template <> struct Raw<16> { using T = int4; };

// VEC consecutive channels, as loaded, and quantized 4 to a word
template <int VEC, class In>
union Vec {
  typename Raw<VEC * sizeof(In)>::T v;
  In e[VEC];
  int w[VEC * sizeof(In) / 4];
};
template <int VEC, class In>
__device__ __forceinline__ void quant_vec(const Vec<VEC, In>& u, Scale sc,
                                          int* q) {
  if constexpr (std::is_same<In, int8_t>::value) {
    memcpy(q, &u.v, VEC);  // already int8
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i)
      q[i] = pack4(quant1(u.e[4 * i], sc), quant1(u.e[4 * i + 1], sc),
                   quant1(u.e[4 * i + 2], sc), quant1(u.e[4 * i + 3], sc));
  }
}

// The tile's input halo into shared memory: halo_h x halo_w positions of
// a.cb channels from channel c0, a.pitch bytes a position, as int8; zero
// outside the input and past Cin. Vectors of VEC channels, kUnroll loads
// in flight a thread; with Cin % VEC != 0 (the stem at Cin = 3) element by
// element.
constexpr int kUnroll = 4;
template <int VEC, class In>
__device__ void load_halo_v(int8_t* halo, const In* __restrict__ x,
                            const Args& a, int iy0, int ix0, int c0,
                            Scale sc) {
  if constexpr (VEC * sizeof(In) <= 16) {
    using R = typename Raw<VEC * sizeof(In)>::T;
    const int nv = a.cb / VEC;  // vectors a position; threads % nv == 0
    const int v = threadIdx.x % nv;
    const int step = a.threads / nv;
    const int npos = a.halo_h * a.halo_w;
    const int dr = step / a.halo_w, dc = step - dr * a.halo_w;
    int pos = threadIdx.x / nv;
    int r = pos / a.halo_w, col = pos - r * a.halo_w;
    const int c = c0 + v * VEC;
    const bool aligned = a.cin % VEC == 0;
    while (pos < npos) {
      Vec<VEC, In> u[kUnroll];
      int at[kUnroll];
      bool ok[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {  // the loads first
        const int iy = iy0 + r, ix = ix0 + col;
        at[k] = pos;
        ok[k] = pos < npos && (unsigned)iy < (unsigned)a.H &&
                (unsigned)ix < (unsigned)a.W && c < a.cin;
        const In* src = x + (iy * a.W + ix) * a.cin + c;
        if (ok[k] && aligned) {
          u[k].v = __ldg(reinterpret_cast<const R*>(src));
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            u[k].e[e] = ok[k] && c + e < a.cin ? src[e] : In{};
        }
        pos += step;
        col += dc;
        r += dr;
        if (col >= a.halo_w) {
          col -= a.halo_w;
          ++r;
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (at[k] < npos) {
          int q[VEC / 4];
          quant_vec(u[k], sc, q);
          int* dst = reinterpret_cast<int*>(halo + at[k] * a.pitch + v * VEC);
#pragma unroll
          for (int i = 0; i < VEC / 4; ++i) dst[i] = q[i];
        }
      }
    }
  }
}

// 4x4 byte transpose: a..d hold 4 channels' bytes of one column each;
// out[ch] holds channel ch's bytes of the 4 columns
__device__ __forceinline__ void transpose4(unsigned a, unsigned b,
                                           unsigned c, unsigned d, int* out) {
  const unsigned t0 = __byte_perm(a, b, 0x5140), t1 = __byte_perm(c, d, 0x5140);
  const unsigned t2 = __byte_perm(a, b, 0x7362), t3 = __byte_perm(c, d, 0x7362);
  out[0] = (int)__byte_perm(t0, t1, 0x5410);
  out[1] = (int)__byte_perm(t0, t1, 0x7632);
  out[2] = (int)__byte_perm(t2, t3, 0x5410);
  out[3] = (int)__byte_perm(t2, t3, 0x7632);
}

// VEC channels' values at 4 columns (u[k] column k) quantized into VEC
// words, a word a channel's 4 columns: kGroup, the fast path for all and
// the exact one where any value needs it (quant_words: no branch), else
// value by value (quant1). Measured on an H100 per class: the
// group form is faster for 5x5 and stride-2 tiles, value by value for 3x3
// stride 1.
template <bool kGroup, int VEC, class In>
__device__ __forceinline__ void quant_vec_cols(int (&w)[VEC],
                                               const Vec<VEC, In> (&u)[4],
                                               Scale sc) {
  if constexpr (kGroup) {
    quant_words(w, sc, [&](int ch, int k) { return u[k].e[ch]; });
  } else {
#pragma unroll
    for (int ch = 0; ch < VEC; ++ch)
      w[ch] = pack4(quant1(u[0].e[ch], sc), quant1(u[1].e[ch], sc),
                    quant1(u[2].e[ch], sc), quant1(u[3].e[ch], sc));
  }
}

// The depthwise tile's halo in shared memory as [row][column group]
// [channel] words: a word holds one channel's int8 values at 4
// consecutive columns, a.pitch bytes a (row, column group) slot, zero
// outside the input. Each thread loads the 4 columns of a group as 4
// vectors of VEC channels (in flight together) and transposes them (int8)
// or quantizes them into place.
template <bool kGroup, int VEC, class In>
__device__ void load_halo_cols_v(int* halo, const In* __restrict__ x,
                                 const Args& a, int iy0, int ix0, int c0,
                                 Scale sc) {
  if constexpr (VEC * sizeof(In) <= 16) {
    using R = typename Raw<VEC * sizeof(In)>::T;
    const int ncg = (a.halo_w + 3) >> 2;
    const int cbp = a.pitch >> 2;
    const int nv = a.cb / VEC;  // vectors a slot; threads % nv == 0
    const int v = threadIdx.x % nv;
    const int step = a.threads / nv;
    const int nslots = a.halo_h * ncg;
    const int dr = step / ncg, dg = step - dr * ncg;
    int pos = threadIdx.x / nv;
    int r = pos / ncg, g = pos - r * ncg;
    const int c = c0 + v * VEC;
    for (; pos < nslots; pos += step) {
      const int iy = iy0 + r;
      const bool rok = c < a.cin && (unsigned)iy < (unsigned)a.H;
      Vec<VEC, In> u[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int ix = ix0 + 4 * g + k;
        if (rok && (unsigned)ix < (unsigned)a.W)
          u[k].v = __ldg(
              reinterpret_cast<const R*>(x + (iy * a.W + ix) * a.cin + c));
        else
          u[k].v = R{};
      }
      int w[VEC];
      if constexpr (std::is_same<In, int8_t>::value) {
#pragma unroll
        for (int cg = 0; cg < VEC / 4; ++cg)
          transpose4(u[0].w[cg], u[1].w[cg], u[2].w[cg], u[3].w[cg],
                     w + 4 * cg);
      } else {
        quant_vec_cols<kGroup>(w, u, sc);
      }
      int4* dst = reinterpret_cast<int4*>(halo + pos * cbp + v * VEC);
#pragma unroll
      for (int i = 0; i < VEC / 4; ++i)
        dst[i] = make_int4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
      g += dg;
      r += dr;
      if (g >= ncg) {
        g -= ncg;
        ++r;
      }
    }
  }
}

template <bool kGroup, class In>
__device__ __forceinline__ void load_halo_cols(int* halo,
                                               const In* __restrict__ x,
                                               const Args& a, int iy0,
                                               int ix0, int c0, Scale sc) {
  if (a.vec == 16)
    load_halo_cols_v<kGroup, 16>(halo, x, a, iy0, ix0, c0, sc);
  else if (a.vec == 8)
    load_halo_cols_v<kGroup, 8>(halo, x, a, iy0, ix0, c0, sc);
  else
    load_halo_cols_v<kGroup, 4>(halo, x, a, iy0, ix0, c0, sc);
}

template <class In>
__device__ __forceinline__ void load_halo(int8_t* halo,
                                          const In* __restrict__ x,
                                          const Args& a, int iy0, int ix0,
                                          int c0, Scale sc) {
  if (a.vec == 16)
    load_halo_v<16>(halo, x, a, iy0, ix0, c0, sc);
  else if (a.vec == 8)
    load_halo_v<8>(halo, x, a, iy0, ix0, c0, sc);
  else
    load_halo_v<4>(halo, x, a, iy0, ix0, c0, sc);
}

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

// float(acc) for |acc| < 2^22 (the tile kernels' sums: at most 256 taps),
// exact and without a conversion instruction
__device__ __forceinline__ float small_int_to_float(int acc) {
  return __int_as_float(kMagicBits + acc) - kMagic;
}

template <class Out>
__device__ __forceinline__ Epilogue epilogue(const Ptrs& p, const Args& a,
                                             float ascale, int o) {
  Epilogue e{1.f, 0.f, false, kFp32};
  if constexpr (!std::is_same<Out, int32_t>::value) {
    e.s = __fmul_rn(ascale, __ldg(p.wscale + o));
    e.bias = p.bias != nullptr;
    if (e.bias) e.b = bias_at(p.bias, a.bias_dtype, o);
    e.round = a.compute_dtype;
  }
  return e;
}

// 4 consecutive channels of one output of a tile kernel (|acc| < 2^22)
template <bool kTwice>
__device__ __forceinline__ void store4(int32_t* p, const int* acc,
                                       const Epilogue*) {
  *reinterpret_cast<int4*>(p) = make_int4(acc[0], acc[1], acc[2], acc[3]);
}
// 4 dequantized values rounded to x's dtype and stored
__device__ __forceinline__ void put4(float* p, const float* y) {
  *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
}
__device__ __forceinline__ void put4(Bf16* p, const float* y) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(bf16x2(y[0], y[1]), bf16x2(y[2], y[3]));
}
__device__ __forceinline__ void put4(F16* p, const float* y) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(f16x2(y[0], y[1]), f16x2(y[2], y[3]));
}
// kTwice: round through the compute dtype (e.round) before x's
template <bool kTwice, class Out>
__device__ __forceinline__ void store4(Out* p, const int* acc,
                                       const Epilogue* e) {
  float y[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) y[k] = e[k](small_int_to_float(acc[k]));
  if constexpr (kTwice) {
#pragma unroll
    for (int k = 0; k < 4; ++k) y[k] = round_to(y[k], e[0].round);
  }
  put4(p, y);
}
// one output element of the general kernel (any int32 sum)
template <bool kTwice>
__device__ __forceinline__ void store1(int32_t* p, int acc,
                                       const Epilogue&) {
  *p = acc;
}
template <bool kTwice, class Out>
__device__ __forceinline__ void store1(Out* p, int acc, const Epilogue& e) {
  float y = e(__int2float_rn(acc));
  if constexpr (kTwice) y = round_to(y, e.round);
  if constexpr (std::is_same<Out, float>::value)
    *p = y;
  else
    p->bits = (unsigned short)(std::is_same<Out, Bf16>::value
                                   ? bf16x2(y, 0.f)
                                   : f16x2(y, 0.f));
}

template <class In>
__device__ __forceinline__ Scale act_scale(const Ptrs& p) {
  if constexpr (std::is_same<In, int8_t>::value) {
    return Scale{1.f, 1.f};
  } else {
    return load_scale(p.ascale);
  }
}

// ---- depthwise: halo tile, 4 channels x 8 outputs a thread ----

// channel ch's int8 values at columns col..col+3 of a strip's row, from
// its words xw (4 columns each); words past the row are zero (they meet
// only zero taps)
template <int NW>
__device__ __forceinline__ int window(const int (&xw)[NW][4], int col,
                                      int ch) {
  const int w = col >> 2, sh = col & 3;
  const int lo = xw[w][ch];
  const int hi = w + 1 < NW ? xw[w + 1][ch] : 0;
  return sh ? (int)__funnelshift_r((unsigned)lo, (unsigned)hi, 8 * sh) : lo;
}

// The sums of a depthwise tile from its halo words and taps in shared
// memory, and their stores: this thread's 4 channels from c = c0 + 4q, a
// strip of 8 outputs from (oy0 + sy rpt, ox0 + 8 sxi), rpt rows of it.
template <int K, int S, class Out, bool kTwice>
__device__ __forceinline__ void dw_tile(const int* halo, const int* taps,
                                        const Ptrs& p, const Args& a,
                                        const Epilogue* e, int b, int c,
                                        int q, int sy, int sxi, int oy0,
                                        int ox0) {
  constexpr int kNw = ((kSpw - 1) * S + K + 3) / 4;  // words of a strip row
  constexpr int kTapWords = K == 5 ? 2 : 1;  // words of a row of taps
  const int ncg = (a.halo_w + 3) >> 2;
  const int cbp = a.pitch >> 2;
  // a row of taps of a channel as words of 4 (K = 3: the fourth zero;
  // K = 5: taps 0-3 and tap 4)
  int tw[4][K][kTapWords];
  const unsigned char* tb = reinterpret_cast<const unsigned char*>(taps);
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
      const unsigned char* r = tb + (4 * q + ch) * (K * K) + dy * K;
      tw[ch][dy][0] = (int)(r[0] | (r[1] << 8) | (r[2] << 16) |
                            (K == 5 ? (unsigned)r[3] << 24 : 0u));
      if constexpr (K == 5) tw[ch][dy][1] = r[4];
    }
  }

  Out* out = static_cast<Out*>(p.out) + (size_t)b * a.ho * a.wo * a.cout;
  const int ox = ox0 + sxi * kSpw;
  const int* base = halo + sxi * 2 * S * cbp + 4 * q;  // 8S columns a strip
  const int row_words = ncg * cbp;
  for (int i = 0; i < a.rpt; ++i) {
    const int ly = sy * a.rpt + i, oy = oy0 + ly;
    if (oy >= a.ho) break;
    int acc[kSpw][4];
#pragma unroll
    for (int j = 0; j < kSpw; ++j)
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) acc[j][ch] = 0;
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
      const int* rp = base + (ly * S + dy) * row_words;
      int xw[kNw][4];
#pragma unroll
      for (int k = 0; k < kNw; ++k) {
        const int4 v = *reinterpret_cast<const int4*>(rp + k * cbp);
        xw[k][0] = v.x;
        xw[k][1] = v.y;
        xw[k][2] = v.z;
        xw[k][3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < kSpw; ++j) {
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
          acc[j][ch] = __dp4a(window(xw, j * S, ch), tw[ch][dy][0],
                              acc[j][ch]);
          if constexpr (K == 5)
            acc[j][ch] = __dp4a(window(xw, j * S + 4, ch), tw[ch][dy][1],
                                acc[j][ch]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kSpw; ++j)
      if (ox + j < a.wo)
        store4<kTwice>(out + (oy * a.wo + ox + j) * a.cout + c, acc[j], e);
  }
}

template <int K, int S, class In, class Out, bool kTwice>
__global__ void __launch_bounds__(kMaxThreads)
    dw_kernel(const Ptrs p, const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ncg = (a.halo_w + 3) >> 2;
  int* halo = reinterpret_cast<int*>(smem);
  int* taps = reinterpret_cast<int*>(smem + round16(a.halo_h * ncg * a.pitch));
  const int t = threadIdx.x;
  const int b = blockIdx.z / a.cblocks;
  const int c0 = (blockIdx.z - b * a.cblocks) * a.cb;
  const int oy0 = blockIdx.y * a.th, ox0 = blockIdx.x * a.tw;
  const In* x = static_cast<const In*>(p.x) + (size_t)b * a.H * a.W * a.cin;
  const Scale sc = act_scale<In>(p);
  const int nq = a.cb >> 2;
  const int q = t % nq, strip = t / nq;
  const int nsx = a.tw / kSpw;
  const int sy = strip / nsx, sxi = strip - sy * nsx;
  const int c = c0 + 4 * q;
  Epilogue e[4];  // its loads in flight with the taps' and the halo's
#pragma unroll
  for (int ch = 0; ch < 4; ++ch)
    e[ch] = epilogue<Out>(p, a, sc.s, min(c + ch, a.cin - 1));

  // the block's taps as they lie in OIHW ([channel][tap] bytes), copied as
  // words; the first words are in flight with the halo's loads
  const int nw = K * K * a.cb / 4;
  const int nvalid = K * K * min(a.cb, a.cin - c0) / 4;
  const int* wsrc = reinterpret_cast<const int*>(p.w + c0 * (K * K));
  const int w0 = t < nvalid ? __ldg(wsrc + t) : 0;
  load_halo_cols<!(K == 3 && S == 1)>(halo, x, a, oy0 * S - a.pt,
                                      ox0 * S - a.pl, c0, sc);
  for (int i = t; i < nw; i += a.threads)
    taps[i] = i == t ? w0 : i < nvalid ? __ldg(wsrc + i) : 0;
  __syncthreads();
  // threads past the strips only loaded (small maps: more loads in flight)
  if (c >= a.cin || sy * a.rpt >= a.th) return;
  dw_tile<K, S, Out, kTwice>(halo, taps, p, a, e, b, c, q, sy, sxi, oy0, ox0);
}

// ---- stem: small dense conv, dp4a over 4-channel words ----
template <class In, class Out, bool kTwice>
__global__ void __launch_bounds__(kMaxThreads)
    stem_kernel(const Ptrs p, const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cw = a.pitch >> 2;  // words a position
  int* halo = reinterpret_cast<int*>(smem);
  int* wsm = reinterpret_cast<int*>(smem + round16(a.halo_h * a.halo_w * a.pitch));
  const int t = threadIdx.x;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * a.th, ox0 = blockIdx.x * a.tw;
  const In* x = static_cast<const In*>(p.x) + (size_t)b * a.H * a.W * a.cin;
  const Scale sc = act_scale<In>(p);
  const int kk = a.kh * a.kw;
  const int groups = a.cout >> 3;
  const int og = t % groups, pix = t / groups;
  const int ty = pix / a.tw, px = pix - ty * a.tw;
  const int ox = ox0 + px;
  const int o = og * 8;
  Epilogue e[8];  // its loads in flight with the weights' and the halo's
#pragma unroll
  for (int k = 0; k < 8; ++k) e[k] = epilogue<Out>(p, a, sc.s, o + k);

  // weights OIHW, read as words (coalesced), to [tap][word][o]: 4 input
  // channels a word, zero past Cin; the first word is in flight with the
  // halo's loads
  int8_t* wb = reinterpret_cast<int8_t*>(wsm);
  if (a.cin % 4) {
    for (int i = t; i < kk * cw * a.cout; i += a.threads) wsm[i] = 0;
    __syncthreads();
  }
  const int* wsrc = reinterpret_cast<const int*>(p.w);
  const int nw = a.cout * a.cin * kk / 4;
  const int w0 = t < nw ? __ldg(wsrc + t) : 0;
  load_halo(reinterpret_cast<int8_t*>(halo), x, a, oy0 * a.sh - a.pt,
            ox0 * a.sw - a.pl, 0, sc);
  for (int i = t; i < nw; i += a.threads) {
    const int word = i == t ? w0 : __ldg(wsrc + i);
    const int oc = 4 * i / kk;
    int tap = 4 * i - oc * kk, o = oc / a.cin, c = oc - o * a.cin;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      wb[((tap * cw + (c >> 2)) * a.cout + o) * 4 + (c & 3)] =
          (int8_t)(word >> (8 * e));
      if (++tap == kk) {
        tap = 0;
        if (++c == a.cin) {
          c = 0;
          ++o;
        }
      }
    }
  }
  __syncthreads();

  if (ox >= a.wo) return;
  Out* img = static_cast<Out*>(p.out) + (size_t)b * a.ho * a.wo * a.cout;
  // each (tap, word)'s 8 weight words are read once for the thread's rows
  int acc[kStemRows][8];
#pragma unroll
  for (int i = 0; i < kStemRows; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[i][k] = 0;
  const int row_words = a.sh * a.halo_w * cw;  // one output row down
  for (int dy = 0; dy < a.kh; ++dy) {
    for (int dx = 0; dx < a.kw; ++dx) {
      const int* xr =
          halo + ((ty * a.rpt * a.sh + dy) * a.halo_w + px * a.sw + dx) * cw;
      const int* wr = wsm + ((dy * a.kw + dx) * cw) * a.cout + o;
      for (int wd = 0; wd < cw; ++wd) {
        const int4* wv = reinterpret_cast<const int4*>(wr + wd * a.cout);
        const int4 lo = wv[0], hi = wv[1];
#pragma unroll
        for (int i = 0; i < kStemRows; ++i) {
          if (i < a.rpt) {
            const int xw = xr[i * row_words + wd];
            acc[i][0] = __dp4a(xw, lo.x, acc[i][0]);
            acc[i][1] = __dp4a(xw, lo.y, acc[i][1]);
            acc[i][2] = __dp4a(xw, lo.z, acc[i][2]);
            acc[i][3] = __dp4a(xw, lo.w, acc[i][3]);
            acc[i][4] = __dp4a(xw, hi.x, acc[i][4]);
            acc[i][5] = __dp4a(xw, hi.y, acc[i][5]);
            acc[i][6] = __dp4a(xw, hi.z, acc[i][6]);
            acc[i][7] = __dp4a(xw, hi.w, acc[i][7]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kStemRows; ++i) {
    const int oy = oy0 + ty * a.rpt + i;
    if (i < a.rpt && oy < a.ho) {
      Out* dst = img + (oy * a.wo + ox) * a.cout + o;
      store4<kTwice>(dst, acc[i], e);
      store4<kTwice>(dst + 4, acc[i] + 4, e + 4);
    }
  }
}

// ---- general: one thread per output ----
template <class In, class Out, bool kTwice>
__global__ void general_kernel(const Ptrs p, const Args a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // over wo * cout
  if (i >= a.wo * a.cout) return;
  const int ow = i / a.cout, o = i - ow * a.cout;
  const int oh = blockIdx.y, b = blockIdx.z;
  const int cin_g = a.cin / a.groups, cout_g = a.cout / a.groups;
  const int c0 = (o / cout_g) * cin_g;
  const In* x = static_cast<const In*>(p.x) + (size_t)b * a.H * a.W * a.cin;
  const Scale sc = act_scale<In>(p);
  const int kk = a.kh * a.kw;
  const int8_t* wo_ptr = p.w + o * cin_g * kk;  // OIHW: w[o][c][dy][dx]
  int acc = 0;
  for (int dy = 0; dy < a.kh; ++dy) {
    const int iy = oh * a.sh - a.pt + dy;
    if ((unsigned)iy >= (unsigned)a.H) continue;
    for (int dx = 0; dx < a.kw; ++dx) {
      const int ix = ow * a.sw - a.pl + dx;
      if ((unsigned)ix >= (unsigned)a.W) continue;
      const In* xp = x + (iy * a.W + ix) * a.cin + c0;
      const int8_t* wp = wo_ptr + dy * a.kw + dx;
      for (int c = 0; c < cin_g; ++c)
        acc += (int)(int8_t)quant1(xp[c], sc) * (int)wp[c * kk];
    }
  }
  store1<kTwice>(static_cast<Out*>(p.out) + (size_t)b * a.ho * a.wo * a.cout +
             oh * a.wo * a.cout + i,
         acc, epilogue<Out>(p, a, sc.s, o));
}

using Kernel = void (*)(Ptrs, Args);

int run(Kernel k, const Ptrs& p, const Args& a, cudaStream_t st) {
  if (a.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (e != cudaSuccess) return (int)e;
  }
  k<<<dim3(a.gx, a.gy, a.gz), a.threads, a.smem, st>>>(p, a);
  return (int)cudaGetLastError();
}

template <class In, class Out, bool kTwice = false>
int launch(const Ptrs& p, const Args& a, cudaStream_t st) {
  switch (a.path) {
    case kDepthwise: {
      if (a.spw != kSpw || a.kh != a.kw || a.sh != a.sw ||
          a.groups != a.cin || a.cout != a.cin || a.cin % 4 || a.cb % 4 ||
          a.cb % a.vec || a.tw % kSpw || a.pitch % 16 || a.pitch < 4 * a.cb ||
          a.threads > kMaxThreads || a.th % a.rpt ||
          a.threads < (a.cb / 4) * (a.tw / kSpw) * (a.th / a.rpt) ||
          a.threads % (a.cb / a.vec) || a.gz != a.B * a.cblocks)
        return (int)cudaErrorInvalidValue;
      const int ks = a.kh * 10 + a.sh;
      Kernel k = ks == 31   ? dw_kernel<3, 1, In, Out, kTwice>
                 : ks == 32 ? dw_kernel<3, 2, In, Out, kTwice>
                 : ks == 51 ? dw_kernel<5, 1, In, Out, kTwice>
                 : ks == 52 ? dw_kernel<5, 2, In, Out, kTwice>
                            : nullptr;
      if (!k) return (int)cudaErrorInvalidValue;
      return run(k, p, a, st);
    }
    case kStem:
      if (a.groups != 1 || a.cout % 8 || a.pitch != a.cb || a.cb % 4 ||
          a.vec != 4 || a.threads > kMaxThreads ||
          a.threads % (a.cb / 4) || a.rpt < 1 || a.rpt > kStemRows ||
          a.th % a.rpt ||
          a.threads != (a.cout / 8) * (a.th / a.rpt) * a.tw ||
          a.gz != a.B)
        return (int)cudaErrorInvalidValue;
      return run(stem_kernel<In, Out, kTwice>, p, a, st);
    case kGeneral:
      if (a.gy != a.ho || a.gz != a.B ||
          (long long)a.gx * a.threads < (long long)a.wo * a.cout)
        return (int)cudaErrorInvalidValue;
      return run(general_kernel<In, Out, kTwice>, p, a, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The fused kernels of x's dtype T: with the compute dtype's rounding
// before the store's where it is neither T nor fp32 (rounding to one dtype
// twice is rounding once), a template argument so that the common case
// (compute dtype = x's) carries no code for it.
template <class T>
int launch_fused(const Ptrs& p, const Args& a, cudaStream_t st) {
  return a.compute_dtype != kFp32 && a.compute_dtype != OutDtype<T>::value
             ? launch<T, T, true>(p, a, st)
             : launch<T, T, false>(p, a, st);
}

bool read_args(const int* v, int n, Args* a) {
  if (n != kNumArgs) return false;
  memcpy(a, v, sizeof(Args));
  return a->B >= 1 && a->H >= 1 && a->W >= 1 && a->ho >= 1 && a->wo >= 1 &&
         a->kh >= 1 && a->kw >= 1 && a->sh >= 1 && a->sw >= 1 &&
         a->groups >= 1 && a->cin % a->groups == 0 &&
         a->cout % a->groups == 0 && a->threads >= 1 && a->threads <= 1024 &&
         a->smem >= 0 && a->smem <= kSmemLimit && a->gy <= 65535 &&
         a->gz <= 65535;
}

}  // namespace

extern "C" {

// x (B, H, W, cin) int8 NHWC, w (cout, cin/groups, kh, kw) int8 OIHW, out
// (B, ho, wo, cout) int32 NHWC; `args` the kNumArgs ints of Args (the
// shapes and the launch plan). Returns the launch's CUDA error (0 when it
// was accepted).
int int8_conv2d(const void* x, const void* w, void* out, const int* args,
                int n, void* stream) {
  Args a;
  if (!read_args(args, n, &a) || a.in_dtype != kInt8)
    return (int)cudaErrorInvalidValue;
  const Ptrs p{x, static_cast<const int8_t*>(w), out, nullptr, nullptr,
               nullptr};
  return launch<int8_t, int32_t>(p, a, static_cast<cudaStream_t>(stream));
}

// x (B, H, W, cin) bf16, fp16 or fp32 NHWC (in_dtype), ascale () fp32,
// wscale (cout,) fp32, bias (cout,) in bias_dtype or null, out (B, ho, wo,
// cout) in x's dtype, rounded through compute_dtype (kBf16, kFp32 or
// kFp16); the rest as int8_conv2d.
int quantized_conv2d(const void* x, const void* w, const void* ascale,
                     const void* wscale, const void* bias, void* out,
                     const int* args, int n, void* stream) {
  Args a;
  if (!read_args(args, n, &a) || (bias != nullptr) != (a.bias_dtype != 0) ||
      a.bias_dtype < 0 || a.bias_dtype > kFp16 || a.compute_dtype < kBf16 ||
      a.compute_dtype > kFp16)
    return (int)cudaErrorInvalidValue;
  const Ptrs p{x,
               static_cast<const int8_t*>(w),
               out,
               static_cast<const float*>(ascale),
               static_cast<const float*>(wscale),
               bias};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.in_dtype == kBf16) return launch_fused<Bf16>(p, a, st);
  if (a.in_dtype == kFp32) return launch_fused<float>(p, a, st);
  if (a.in_dtype == kFp16) return launch_fused<F16>(p, a, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
