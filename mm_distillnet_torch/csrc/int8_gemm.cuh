// The int8 post-training-quantized forward's 1x1 convs (the 'int_mm' route
// of ops/int8_conv.py) as one kernel for Hopper (sm_90a): the quantize
// prologue, the s8 x s8 -> s32 GEMM on the tensor cores (wgmma) and the
// dequantize epilogue, with the quantized activations never written to
// device memory.
//
// Replaces no Pallas kernel: the JAX package computes a quantized conv with
// XLA, which fuses the quantize, the s8 conv, the fp32 rescale and the bias
// into one program (mm_distillnet_tpu/quant.py:209-223). Before this kernel
// the port ran each 1x1 as torch's prologue (float, divide, round, clamp,
// to int8), torch._int_mm (cuBLASLt's s8 GEMM) and torch's epilogue
// (float, two multiplies, the bias, two casts): a dozen launches, each a
// pass over the activations in fp32.
//
// Contract, bit for bit that unfused sequence: x (M, K) bf16, fp16 or fp32
// (NHWC, M = B*H*W); q = clamp(rint(fl(x / ascale)), -127, 127); the int32
// sums of q against the int8 weights, exact; out (M, N) in x's dtype =
// fl(fl((float)acc * fl(ascale * wscale[o])) + bias[o]), rounded through
// the compute dtype. The prologue and the epilogue are int8_common.cuh's
// (quant_fast / quant_exact, Epilogue), shared with int8_conv.cu's fused
// kernel.
//
// What bounds it on an H100: bytes. K and N are 16-2,112 and the int8
// tensor cores would take 1,979 TOPS; x is read and out written once at
// 3.35 TB/s (0.745 ms per D2@768 batch-8 forward, 120 calls), and the
// prologue's arithmetic (about 8 fp32 operations an input value) is what
// could make it slower. The design, after the bf16 project kernel
// (mbconv_project.cu):
//
//   * Warp-specialised. One producer warp issues every copy through the
//     copy engine (TMA) onto a ring of 2-6 stages (`full` / `empty`
//     mbarriers): x as 64-row x 128-byte boxes of a 2-D tensor map with the
//     128-byte swizzle (rows past M and channels past K come as zeros,
//     which quantize to 0), and the K-block of this CTA's weight columns as
//     one box of a 3-D tensor map over the repacked weights.
//   * The weights are repacked once per pack (ops/int8_gemm.py
//     pack_weights) into the core-matrix order wgmma reads, K padded to 16:
//     [N/8][K/16][8 rows][16 bytes]. A box of that order lands in shared
//     memory as a K-major operand without swizzle, whatever the CTA's
//     columns (past N and past K: zeros).
//   * Consumer warpgroups (64 rows each) read their rows' x values from the
//     stage, quantize them in registers (int8_common.cuh quant_fast: a
//     stage's values, up to 64 a thread, without a branch, the exact
//     division only where a value needs it) and pack four to a word:
//     the m16n8k32 s8 A fragment, so A goes to wgmma m64nNk32.s32.s8.s8
//     from registers and the quantized tile is never stored anywhere. The
//     fragments of step t + 1 are made while the wgmma of step t runs.
//   * The accumulator is exact int32 (|acc| <= 127^2 K < 2^31). A finished
//     tile is dequantized from the registers (the per-column scales and
//     biases of the CTA in shared memory), rounded and stored from there:
//     no staging, no barrier (a staged, 16-byte copy-out was slower: its
//     two warp barriers and shared-memory round trip sat on every tile's
//     path).
//   * A persistent grid walks the row tiles (blockIdx.x, + gridDim.x, ...),
//     the ring running across tiles, so the next tile's loads are in
//     flight during this one's epilogue. Where the row tiles do not fill
//     the SMs the output columns are split over blockIdx.y (down to 16 a
//     CTA); each CTA quantizes its rows again.
//
// Layouts: x (M, K); w_pack as above; out (M, N); wscale (N,) fp32; ascale
// () fp32; bias (N,) in bf16, fp16 or fp32, or null. The kernel and its
// launcher live here; int8_gemm_{bf16,fp16,fp32}.cu instantiate them for
// one input dtype each, three libraries that nvcc builds in parallel.

#pragma once

#include <cuda.h>

#include <cstring>

#include "int8_common.cuh"
#include "mbconv_common.cuh"

namespace int8gemm {

using namespace mbconv;
using namespace int8q;

constexpr int BM = 64;                  // rows per warpgroup
constexpr int BOX_BYTES = BM * 128;     // one 64-row x 128-byte box of x
constexpr int MAX_STAGES = 6;
constexpr int HEADER = 128 + 2 * 256 * 4;  // barriers, column scales, biases

// The launch's fields, in the order of ops/int8_gemm.py ARGS.
struct Args {
  int M, K, N;                                  // the GEMM
  int in_dtype, bias_dtype, compute_dtype;      // Dtype codes
  int nt, nwg, cols, row_ctas, col_ctas, stages, smem;  // the plan
};
constexpr int kNumArgs = 13;
static_assert(sizeof(Args) == kNumArgs * sizeof(int), "Args is ints only");

// K values a stage: two 128-byte boxes of x
__host__ __device__ constexpr int block_k(int e) { return 256 / e; }
// A stage: per warpgroup two boxes of x, and an NT x BK piece of weights
__host__ __device__ constexpr int stage_bytes(int nt, int nwg, int e) {
  return round_up(nwg * 2 * BOX_BYTES + nt * block_k(e), 1024);
}
__host__ __device__ constexpr int gemm_smem(int nt, int nwg, int e,
                                            int stages) {
  return HEADER + 1024 + stages * stage_bytes(nt, nwg, e);
}
// CTAs an SM: two for one consumer warpgroup with an accumulator of at
// most 128 columns (its registers allow it), so that small maps keep more
// tiles in flight; else one
__host__ __device__ constexpr int ctas_per_sm(int nt, int nwg) {
  return nwg == 1 && nt <= 128 ? 2 : 1;
}

struct Cursor {
  int ti, kb, stage, phase;
};

// 4 consecutive x values of one row in shared memory, as loaded (8 bytes
// of a 16-bit dtype, 16 of fp32)
template <class In>
struct Quad {
  using Raw = typename std::conditional<std::is_same<In, float>::value, uint4,
                                        uint2>::type;
  Raw r;
  __device__ __forceinline__ void load(const unsigned char* p) {
    r = *reinterpret_cast<const Raw*>(p);
  }
  // value k (0-3)
  __device__ __forceinline__ float at(int k) const {
    if constexpr (std::is_same<In, float>::value) {
      const unsigned w[4] = {r.x, r.y, r.z, r.w};
      return __uint_as_float(w[k]);
    } else {
      const unsigned w = k < 2 ? r.x : r.y;
      return to_float(In{(unsigned short)(k & 1 ? w >> 16 : w)});
    }
  }
};

// The A fragments of a stage's first NS k32 steps (of KS), quantized: this
// thread's rows g and g + 8 of its warp's 16, values 4q..4q+3 and
// 16+4q..16+4q+3 of each step, from the stage's 128-byte-swizzled boxes of
// x at `st` (row g's first byte; row g + 8 is 8 * 128 bytes on, at the
// same swizzle phase g). In a box a row is 128 bytes and its 16-byte chunk
// c lies at chunk c ^ (row & 7). The loads come first, then the quantize
// without a branch (int8_common.cuh quant_fast), and the exact division
// for the whole stage only where a value needs it. NS and HALF are
// template arguments so that the work of steps past K is not done (a
// branch-free quantize under a run-time condition is computed and thrown
// away); HALF: K = 16 (the 384x384 maps' 1x1s), whose one step's upper 16
// values are zeros, left out.
template <class In, int KS, int NS, bool HALF>
__device__ __forceinline__ void prep_stage(uint32_t (&frag)[KS][4],
                                           const unsigned char* st, int g,
                                           int q, Scale sc) {
  constexpr int E = sizeof(In);
  constexpr int PARTS = HALF ? 2 : 4;
  Quad<In> x[NS][4];
#pragma unroll
  for (int ks = 0; ks < NS; ++ks) {
    const int box = ks * 32 * E / 128;
    const int lo = (ks * 32 * E) % 128 + 4 * q * E;
    const int hi = lo + 16 * E;
    const int off[4] = {
        box * BOX_BYTES + (((lo >> 4) ^ g) << 4) + (lo & 15), 0,
        box * BOX_BYTES + (((hi >> 4) ^ g) << 4) + (hi & 15), 0};
#pragma unroll
    for (int i = 0; i < PARTS; ++i)
      x[ks][i].load(st + off[i & 2] + (i & 1) * 8 * 128);
  }
  bool exact = false;
#pragma unroll
  for (int ks = 0; ks < NS; ++ks)
#pragma unroll
    for (int i = 0; i < PARTS; ++i)
      frag[ks][i] = (uint32_t)pack4(quant_fast(x[ks][i].at(0), sc, exact),
                                    quant_fast(x[ks][i].at(1), sc, exact),
                                    quant_fast(x[ks][i].at(2), sc, exact),
                                    quant_fast(x[ks][i].at(3), sc, exact));
  if (HALF) frag[0][2] = frag[0][3] = 0u;
  if (exact) {
#pragma unroll
    for (int ks = 0; ks < NS; ++ks)
#pragma unroll
      for (int i = 0; i < PARTS; ++i)
        frag[ks][i] = (uint32_t)pack4(quant_exact(x[ks][i].at(0), sc),
                                      quant_exact(x[ks][i].at(1), sc),
                                      quant_exact(x[ks][i].at(2), sc),
                                      quant_exact(x[ks][i].at(3), sc));
  }
}

// An instantiation's constants. Class members, not the kernel's local
// constexprs: cicc (CUDA 12.9) crashed on local constexprs read inside the
// kernel's lambdas.
template <class In, int NT, int NWG>
struct Geometry {
  static constexpr int E = sizeof(In);
  static constexpr int BK = block_k(E);
  static constexpr int KS = BK / 32;  // k32 steps a stage
  static constexpr int CONSUMERS = 128 * NWG;
  static constexpr int BMT = BM * NWG;  // rows per tile
};

// One CTA = NWG consumer warpgroups, each with 64 rows of a tile of 64 NWG
// rows and sharing the weight piece of a stage, and a producer warpgroup
// whose first warp issues every copy. A step is one K-block of one tile.
template <class In, int NT, int NWG>
__global__ void __launch_bounds__(128 * NWG + 128, ctas_per_sm(NT, NWG))
conv1x1_kernel(const __grid_constant__ CUtensorMap x_map,
               const __grid_constant__ CUtensorMap w_map,
               const float* __restrict__ ascale,
               const float* __restrict__ wscale,
               const void* __restrict__ bias, In* __restrict__ out,
               const Args a) {
  using G = Geometry<In, NT, NWG>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int n0 = blockIdx.y * a.cols;
  const int ncols = min(a.cols, a.N - n0);
  const int kpad = round_up(a.K, 32);
  const int nkb = (kpad + G::BK - 1) / G::BK;
  const int stage_b = stage_bytes(NT, NWG, G::E);
  const int b_off = NWG * 2 * BOX_BYTES;  // the weight piece in a stage
  const int row_tiles = (a.M + G::BMT - 1) / G::BMT;
  const int my_tiles = (row_tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                       (int)gridDim.x;
  const uint32_t full0 = smem_addr(smem);          // stage filled
  const uint32_t empty0 = full0 + 8 * MAX_STAGES;  // stage released
  float* s_scale = reinterpret_cast<float*>(smem + 128);
  float* s_bias = s_scale + NT;
  // the swizzled boxes want the ring on a 1024-byte boundary
  unsigned char* ring =
      smem + HEADER + ((1024 - ((full0 + HEADER) & 1023)) & 1023);

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);          // the producer's expect_tx
      mbar_init(empty0 + 8 * s, 4 * NWG);   // one lane of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  auto advance = [&](Cursor& c) {
    if (++c.kb == nkb) {
      c.kb = 0;
      ++c.ti;
    }
    if (++c.stage == a.stages) {
      c.stage = 0;
      c.phase ^= 1;
    }
  };
  auto tile_row0 = [&](const Cursor& c) {
    return (int)(blockIdx.x + c.ti * gridDim.x) * G::BMT;
  };

  // the warpgroup's index by a shuffle, so that the compiler knows it to be
  // the same in all lanes: a wgmma under a branch that it takes for divergent
  // is serialised
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (wg == NWG) {
    // the producer warpgroup gives its registers to the consumers; only its
    // first warp works. Lane 0 announces the bytes and brings the K-block
    // of the CTA's weight columns; lanes 1.. bring the boxes of x (two per
    // warpgroup, one where the K-block ends in the first).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid >= G::CONSUMERS + 32) return;
    Cursor c{0, 0, 0, 0};
    for (int n = 0; c.ti < my_tiles; ++n, advance(c)) {
      if (n >= a.stages) mbar_wait(empty0 + 8 * c.stage, c.phase ^ 1);
      const int m0 = tile_row0(c);
      const int k0 = c.kb * G::BK;
      const int boxes = min(G::BK, kpad - k0) * G::E > 128 ? 2 : 1;
      const uint32_t bar = full0 + 8 * c.stage;
      const uint32_t dst = smem_addr(ring + c.stage * stage_b);
      if (lane == 0) {
        mbar_expect_tx(bar, NT * G::BK + NWG * boxes * BOX_BYTES);
        tma_load_3d(dst + b_off, &w_map, 0, k0 / 16, n0 / 8, bar);
      } else if (lane <= NWG * 2) {
        const int box = lane - 1;  // warpgroup * 2 + half
        if ((box & 1) < boxes)
          tma_load_2d(dst + box * BOX_BYTES, &x_map,
                      k0 + (box & 1) * (128 / G::E), m0 + (box >> 1) * BM, bar);
      }
    }
    return;
  }

  // ---- consumer warpgroups
  // the registers the producer gave up: 65,536 an SM, the producer
  // warpgroup at 40 a thread
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      ctas_per_sm(NT, NWG) == 2 ? 216 : NWG == 1 ? 240 : 232));
  const Scale sc = load_scale(ascale);
  const bool has_bias = bias != nullptr;
  for (int c = tid; c < NT; c += G::CONSUMERS) {
    const bool in = c < ncols;
    s_scale[c] = in ? __fmul_rn(sc.s, __ldg(wscale + n0 + c)) : 0.f;
    s_bias[c] = in && has_bias ? bias_at(bias, a.bias_dtype, n0 + c) : 0.f;
  }
  named_barrier(1, G::CONSUMERS);

  const int warp = (tid >> 5) & 3;  // within the warpgroup
  const int g = lane >> 2;
  const int q = lane & 3;
  // this thread's rows g and g + 8 of its warp's 16 (both at swizzle phase
  // g), in its warpgroup's boxes of a stage
  const int a_row = wg * 2 * BOX_BYTES + (warp * 16 + g) * 128;

  // A fragments of a stage (prep_stage), by its count of k32 steps; K = 16
  // (one step, its upper half zeros) apart
  const bool half_k = a.K <= 16;
  auto prep = [&](const Cursor& c, uint32_t (&frag)[G::KS][4]) {
    const int nks = min(G::BK, kpad - c.kb * G::BK) / 32;
    mbar_wait(full0 + 8 * c.stage, c.phase);
    const unsigned char* st = ring + c.stage * stage_b + a_row;
    if (nks == G::KS)
      prep_stage<In, G::KS, G::KS, false>(frag, st, g, q, sc);
    else if (half_k)
      prep_stage<In, G::KS, 1, true>(frag, st, g, q, sc);
    else if (nks == 1)
      prep_stage<In, G::KS, 1, false>(frag, st, g, q, sc);
    else if (nks == 2)
      prep_stage<In, G::KS, (G::KS > 2 ? 2 : 1), false>(frag, st, g, q, sc);
    else
      prep_stage<In, G::KS, (G::KS > 3 ? 3 : 1), false>(frag, st, g, q, sc);
  };

  int acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0;

  // a finished tile: the int32 sums dequantized in registers, rounded to
  // x's dtype and stored from there, two columns (4 or 8 bytes) a row and
  // column group: no staging and no barrier, so a warp's epilogue is a
  // short chain of independent stores (rows past M and column groups past
  // the CTA's columns are not written)
  const bool twice =
      a.compute_dtype != kFp32 && a.compute_dtype != OutDtype<In>::value;
  const int groups = ncols / 8;
  auto frag_out = [&](int m0, auto kTwice) {
    const int r = m0 + wg * BM + warp * 16 + g;
    In* lo = out + (size_t)r * a.N + n0 + 2 * q;
    In* hi = lo + (size_t)8 * a.N;
    const bool lo_ok = r < a.M, hi_ok = r + 8 < a.M;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const int col = 8 * j + 2 * q;
      const float2 s = *reinterpret_cast<const float2*>(s_scale + col);
      const float2 b = *reinterpret_cast<const float2*>(s_bias + col);
      const Epilogue e0{s.x, b.x, has_bias, a.compute_dtype};
      const Epilogue e1{s.y, b.y, has_bias, a.compute_dtype};
      float y[4] = {e0(__int2float_rn(acc[4 * j])),
                    e1(__int2float_rn(acc[4 * j + 1])),
                    e0(__int2float_rn(acc[4 * j + 2])),
                    e1(__int2float_rn(acc[4 * j + 3]))};
      if constexpr (decltype(kTwice)::value) {
#pragma unroll
        for (int k = 0; k < 4; ++k) y[k] = round_to(y[k], a.compute_dtype);
      }
      if (j < groups) {
        if (lo_ok) put2(lo + 8 * j, y[0], y[1]);
        if (hi_ok) put2(hi + 8 * j, y[2], y[3]);
      }
    }
  };
  auto epilogue = [&](int m0) {
    if (twice)
      frag_out(m0, std::true_type{});
    else
      frag_out(m0, std::false_type{});
  };

  Cursor pc{0, 0, 0, 0};  // to prepare
  Cursor mc{0, 0, 0, 0};  // to multiply

  // one step: the wgmma of this step runs while the A fragments of the next
  // are made; then the stage goes back to the producer and a finished tile
  // is written
  auto step = [&](uint32_t (&cur)[G::KS][4], uint32_t (&nxt)[G::KS][4]) {
    const int nks = min(G::BK, kpad - mc.kb * G::BK) / 32;
    const uint64_t db = wgmma_desc(
        smem_addr(ring + mc.stage * stage_b + b_off), 128, 8 * G::BK);
    wgmma_fence();
    if (nks == G::KS) {
#pragma unroll
      for (int ks = 0; ks < G::KS; ++ks)
        wgmma_s8_rs<NT>(acc, cur[ks], db + ks * 16, mc.kb | ks);
    } else {
#pragma unroll
      for (int ks = 0; ks < G::KS; ++ks)
        if (ks < nks) wgmma_s8_rs<NT>(acc, cur[ks], db + ks * 16, mc.kb | ks);
    }
    wgmma_commit();
    if (pc.ti < my_tiles) {
      prep(pc, nxt);
      advance(pc);
    }
    wgmma_wait();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * mc.stage);
    if (mc.kb == nkb - 1) epilogue(tile_row0(mc));
    advance(mc);
  };

  const int nsteps = my_tiles * nkb;
  uint32_t a0[G::KS][4], a1[G::KS][4];
  if (nsteps > 0) {
    prep(pc, a0);
    advance(pc);
  }
  for (int t = 0; t < nsteps; t += 2) {
    step(a0, a1);
    if (t + 1 < nsteps) step(a1, a0);
  }
}

template <class In> struct MapType;
template <> struct MapType<Bf16> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <> struct MapType<F16> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};
template <> struct MapType<float> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

template <class In, int NT, int NWG>
inline int launch(const Args& a, const void* x, const void* w_pack,
           const float* ascale, const float* wscale, const void* bias,
           void* out, cudaStream_t st) {
  constexpr int E = sizeof(In);
  if (a.smem != gemm_smem(NT, NWG, E, a.stages) || a.smem > MAX_SMEM ||
      encode_tiled() == nullptr)
    return (int)cudaErrorInvalidValue;
  // x as a 2-D tensor (K fastest, then M), read in 64-row x 128-byte boxes
  CUtensorMap x_map, w_map;
  const cuuint64_t x_dims[2] = {(cuuint64_t)a.K, (cuuint64_t)a.M};
  const cuuint64_t x_strides[1] = {(cuuint64_t)a.K * E};
  const cuuint32_t x_box[2] = {128 / E, BM};
  const cuuint32_t ones[3] = {1, 1, 1};
  if (encode_tiled()(&x_map, MapType<In>::value, 2, const_cast<void*>(x),
                     x_dims, x_strides, x_box, ones,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  // the repacked weights as [N/8][K16/16][128 bytes], read in boxes of
  // NT/8 groups x BK/16 core matrices
  const int k16 = round_up(a.K, 16);
  const cuuint64_t w_dims[3] = {128, (cuuint64_t)k16 / 16,
                                (cuuint64_t)a.N / 8};
  const cuuint64_t w_strides[2] = {128, (cuuint64_t)k16 * 8};
  const cuuint32_t w_box[3] = {128, (cuuint32_t)block_k(E) / 16, NT / 8};
  if (encode_tiled()(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                     const_cast<void*>(w_pack), w_dims, w_strides, w_box, ones,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  auto kern = conv1x1_kernel<In, NT, NWG>;
  // this instantiation's dynamic shared memory limit, per device
  static int allowed[MAX_DEVICES] = {};
  const cudaError_t err = allow_dynamic_smem(kern, allowed, a.smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(a.row_ctas, a.col_ctas), 128 * NWG + 128, a.smem, st>>>(
      x_map, w_map, ascale, wscale, bias, static_cast<In*>(out), a);
  return (int)cudaGetLastError();
}

template <class In>
inline int launch_nt(const Args& a, const void* x, const void* w_pack,
              const float* ascale, const float* wscale, const void* bias,
              void* out, cudaStream_t st) {
#define INT8_GEMM_NT(NT)                                                     \
  case NT:                                                                   \
    return a.nwg == 1                                                        \
               ? launch<In, NT, 1>(a, x, w_pack, ascale, wscale, bias, out,  \
                                   st)                                       \
               : launch<In, NT, 2>(a, x, w_pack, ascale, wscale, bias, out,  \
                                   st);
  switch (a.nt) {
    INT8_GEMM_NT(16)
    INT8_GEMM_NT(32)
    INT8_GEMM_NT(64)
    INT8_GEMM_NT(96)
    INT8_GEMM_NT(128)
    INT8_GEMM_NT(192)
    INT8_GEMM_NT(256)
  }
#undef INT8_GEMM_NT
  return (int)cudaErrorInvalidValue;
}

// The entry point of the three sources int8_gemm_{bf16,fp16,fp32}.cu, one
// per input dtype In (so that nvcc builds their kernels in parallel): x (M,
// K) in In (in_dtype), w_pack the repacked int8 weights, ascale () and
// wscale (N,) fp32, bias (N,) in bias_dtype or null, out (M, N) in x's
// dtype, rounded through compute_dtype; `args` the kNumArgs ints of Args
// (the shapes and the launch plan). Returns the launch's CUDA error (0
// when it was accepted).
template <class In>
int quantized_conv1x1(const void* x, const void* w_pack, const void* ascale,
                      const void* wscale, const void* bias, void* out,
                      const int* args, int n, void* stream) {
  if (n != kNumArgs) return (int)cudaErrorInvalidValue;
  Args a;
  memcpy(&a, args, sizeof(Args));
  if (a.M < 1 || a.K < 1 || a.N < 8 || a.K % 8 || a.N % 8 || a.cols % 8 ||
      a.cols < 8 || a.cols > a.nt || a.col_ctas != (a.N + a.cols - 1) / a.cols ||
      a.col_ctas > 65535 || a.row_ctas < 1 || a.stages < 2 ||
      a.stages > MAX_STAGES || a.nwg < 1 || a.nwg > 2 ||
      (bias != nullptr) != (a.bias_dtype != 0) || a.bias_dtype < 0 ||
      a.bias_dtype > kFp16 || a.compute_dtype < kBf16 ||
      a.compute_dtype > kFp16 || a.in_dtype != OutDtype<In>::value)
    return (int)cudaErrorInvalidValue;
  return launch_nt<In>(a, x, w_pack, static_cast<const float*>(ascale),
                       static_cast<const float*>(wscale), bias, out,
                       static_cast<cudaStream_t>(stream));
}

}  // namespace int8gemm
