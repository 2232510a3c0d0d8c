// Device helpers shared by the int8 kernels (int8_conv.cu, int8_gemm.cuh):
// the quantize prologue and the dequantize epilogue of the fused kernels,
// each bit-equal to the unfused torch sequence of ops/int8_conv.py
// (`_quantize`, `_dequantize`) on the card.
#pragma once

#include <stdint.h>

#include <type_traits>

namespace int8q {

// dtype codes, as ops/int8_conv.py DTYPES (0 is also "no bias")
enum Dtype { kInt8 = 0, kBf16 = 1, kFp32 = 2, kFp16 = 3 };

struct Bf16 {  // bf16 storage
  unsigned short bits;
};
struct F16 {  // fp16 storage
  unsigned short bits;
};

__device__ __forceinline__ float to_float(Bf16 v) {
  return __uint_as_float((unsigned)v.bits << 16);
}
__device__ __forceinline__ float to_float(F16 v) {  // exact, subnormals too
  float f;
  asm("cvt.f32.f16 %0, %1;" : "=f"(f) : "h"(v.bits));
  return f;
}

constexpr float kMagic = 12582912.f;  // 1.5 * 2^23: x + kMagic rounds x
constexpr int kMagicBits = 0x4B400000;  // to an integer in the low bits

// The activation scale: s = ascale, r ~ 1 / s (rcp.approx: within 1 ulp).
struct Scale {
  float s, r;
};
__device__ __forceinline__ Scale load_scale(const float* ascale) {
  const float s = __ldg(ascale);
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(s));
  return Scale{s, r};
}

// One input element quantized: clamp(rint(fl(v / s)), -127, 127), the
// result in the low byte. Where |v / s| < 128, q = v * r is within 2^-15
// of fl(v / s) (r's ulp, the product's and the quotient's rounding), so
// rint(q) can differ from rint(fl(v / s)) only within 2^-14 of a
// half-integer; there the exact division decides. Past the clamp no
// rounding matters (every value beyond 126.5 + 2^-14 gives 127), so q is
// clamped first and only the half-integers up to 126.5 are checked.
// kMagic rounds half to even as rint does, and with no conversion
// instruction.
//
// quant_fast is the rounding of clamped q, with `exact` set where the
// division must decide instead (quant_exact); it has no branch, so that a
// group of values quantizes with its instructions interleaved and takes
// the exact path once for the whole group where any value needs it
// (quant_words).
__device__ __forceinline__ int quant_fast(float v, Scale sc, bool& exact) {
  const float q = fminf(fmaxf(v * sc.r, -127.f), 127.f);
  const float t = q + kMagic;
  exact |= fabsf(q - (t - kMagic)) > 0.49993896484375f;  // 0.5 - 2^-14
  return __float_as_int(t);
}
__device__ __forceinline__ int quant_exact(float v, Scale sc) {
  return __float_as_int(fminf(fmaxf(__fdiv_rn(v, sc.s), -127.f), 127.f) +
                        kMagic);
}
__device__ __forceinline__ int quant1(float v, Scale sc) {
  bool exact = false;
  const int t = quant_fast(v, sc, exact);
  return exact ? quant_exact(v, sc) : t;
}
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ int quant1(Bf16 v, Scale sc) {
  return quant1(to_float(v), sc);
}
__device__ __forceinline__ int quant1(F16 v, Scale sc) {
  return quant1(to_float(v), sc);
}
__device__ __forceinline__ int quant1(int8_t v, Scale) { return v; }

// four low bytes into a word
__device__ __forceinline__ int pack4(int a, int b, int c, int d) {
  return (int)__byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                          0x5410);
}

// N words of 4 values each, quantized 4 to a word (value k of word i from
// get(i, k), any of float / Bf16 / F16, the first in the low byte): the
// fast path for all, then the exact one for all where any value needs it
template <int N, class Get>
__device__ __forceinline__ void quant_words(int (&w)[N], Scale sc, Get get) {
  bool exact = false;
#pragma unroll
  for (int i = 0; i < N; ++i)
    w[i] = pack4(quant_fast(to_float(get(i, 0)), sc, exact),
                 quant_fast(to_float(get(i, 1)), sc, exact),
                 quant_fast(to_float(get(i, 2)), sc, exact),
                 quant_fast(to_float(get(i, 3)), sc, exact));
  if (exact) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      w[i] = pack4(quant_exact(to_float(get(i, 0)), sc),
                   quant_exact(to_float(get(i, 1)), sc),
                   quant_exact(to_float(get(i, 2)), sc),
                   quant_exact(to_float(get(i, 3)), sc));
  }
}

// two floats rounded to bf16 or fp16 (nearest even, subnormals kept, as
// torch's float -> bf16 / fp16 on the card), lo in the low half
__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  unsigned d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}
__device__ __forceinline__ unsigned f16x2(float lo, float hi) {
  unsigned d;
  asm("cvt.rn.f16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// y rounded to the dtype `d` (kBf16, kFp16; else unchanged), as a float
__device__ __forceinline__ float round_to(float y, int d) {
  if (d == kBf16) return __uint_as_float(bf16x2(y, 0.f) << 16);
  if (d == kFp16) return to_float(F16{(unsigned short)f16x2(y, 0.f)});
  return y;
}

template <class Out> struct OutDtype;
template <> struct OutDtype<float> { static constexpr int value = kFp32; };
template <> struct OutDtype<Bf16> { static constexpr int value = kBf16; };
template <> struct OutDtype<F16> { static constexpr int value = kFp16; };

// A bias value of dtype `d` (kBf16, kFp16, kFp32) as a float, exactly.
__device__ __forceinline__ float bias_at(const void* bias, int d, int o) {
  return d == kBf16  ? to_float(static_cast<const Bf16*>(bias)[o])
         : d == kFp16 ? to_float(static_cast<const F16*>(bias)[o])
                      : __ldg(static_cast<const float*>(bias) + o);
}

// The epilogue of an output channel: the dequantized value of an int32
// sum, rounded as torch's unfused sequence rounds it: fl(fl(acc * s) + b),
// then through the compute dtype and to x's (the store rounds).
struct Epilogue {
  float s;    // ascale * wscale[o]
  float b;    // bias[o]
  bool bias;  // add b
  int round;  // the compute dtype (kBf16, kFp16, kFp32)

  __device__ __forceinline__ float operator()(float accf) const {
    const float y = __fmul_rn(accf, s);
    return bias ? __fadd_rn(y, b) : y;
  }
};

// two dequantized values rounded to x's dtype and stored, lo first
__device__ __forceinline__ void put2(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}
__device__ __forceinline__ void put2(Bf16* p, float lo, float hi) {
  *reinterpret_cast<unsigned*>(p) = bf16x2(lo, hi);
}
__device__ __forceinline__ void put2(F16* p, float lo, float hi) {
  *reinterpret_cast<unsigned*>(p) = f16x2(lo, hi);
}

}  // namespace int8q
