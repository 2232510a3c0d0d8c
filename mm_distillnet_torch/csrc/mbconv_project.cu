// Kernel (c) of the eval-mode MBConv block (see mbconv.cu for the block as a
// whole): out = bf16(d * gate) @ w_prj + b_prj (+ skip), for Hopper
// (sm_90a). Replaces the last part of
// mm_distillnet_tpu/ops/pallas_mbconv.py::_mbconv_kernel.
//
// What bounds it on an H100. By bytes (d read once, out written once) it
// could run in 0.30 ms per D2@768 forward at batch 8; the GEMM itself is
// 10-50x below the tensor cores' rate. Blocks 0-8 (K = CeP <= 288, 74-590k
// rows) are streaming passes; blocks 9-22 (K up to 2112, 4.6-18k rows) are
// chains of 5-17 K-blocks. What a CTA really waits for is how fast its SM
// takes d in: 16-byte cp.async copies go through the load/store unit, whose
// outstanding misses cap an SM near 14 bytes a clock (measured: six cp.async
// a thread and K-block took 900 clocks), and the address arithmetic of those
// copies sat on every warp's critical path. The design:
//
//   * Warp-specialised. One producer warp (of a producer warpgroup that hands
//     its registers to the consumers by setmaxnreg, so that their fragment
//     loads of a whole K-block can be in flight at once) issues every copy
//     through the copy engine (TMA) onto the stage's `full` mbarrier: the d tile as 64 x 64
//     boxes of a 2-D tensor map over (M, CeP) with the 128-byte swizzle (rows
//     past M and channels past CeP come as zeros), the gates of the tile's
//     images and this CTA's columns of the K-block of w_prj as bulk copies of
//     one piece each (fold time stores w_prj K-major in the core-matrix order
//     wgmma reads). The consumer warpgroups compute no load address; they
//     hand a stage back through its `empty` mbarrier.
//   * A ring of 2-6 stages of (64 rows x 128 of d per warpgroup, gates, 128 x
//     N of w_prj) runs across row tiles and K-blocks alike: a CTA walks over
//     the tiles blockIdx.x, blockIdx.x + gridDim.x, ..., and the next tile's
//     loads are in flight while this one finishes, which is what a streaming
//     block (one K-block per tile) needs.
//   * A tile is 64 rows per warpgroup and up to 256 output channels in one
//     wgmma accumulator, so d is read once (Co <= 256) or twice (Co = 352 as
//     2 x 176). Where the row tiles alone do not fill 132 SMs (the 24x24
//     maps) the output channels are split in two over blockIdx.y; both halves
//     read the same d tile, the second from L2. A K split would need a second
//     pass over fp32 partial sums.
//   * A comes from registers: ldmatrix of the swizzled d tile, times the row's
//     fp32 gate, rounded to bf16 (the rounding point bf16(d * gate) of the
//     plain version), then wgmma m64nNk16 with B from shared memory. The
//     gated tile is never written anywhere. The fragments of step t + 1 are
//     made while the wgmma of step t runs. The gate is chosen per row, so a
//     tile may straddle two images.
//   * Epilogue: fp32 sums staged in shared memory (over the idle ring where
//     a CTA has one tile), then bias + bf16 skip added in fp32 and out
//     written 16 bytes a thread.
//
// Layouts: d (M, CeP) bf16 with M = B * Ho * Wo; gate (B, CeP) f32; w_pack
// as ops/fused_mbconv.py `pack_project` writes it; out, skip (M, Co) bf16.

#include <cuda.h>

#include <type_traits>

#include "mbconv_common.cuh"

namespace {

using namespace mbconv;

constexpr int BM = 64;        // rows per warpgroup
constexpr int BK = 128;       // K per stage: two 64-wide boxes of d
constexpr int BOX_BYTES = BM * 128;          // one 64 x 64 bf16 box
constexpr int MAX_STAGES = 6;
constexpr int HEADER = 2048;  // barriers, and room to align the ring to 1024

__host__ __device__ constexpr int out_stride(int nt) {  // floats; = 8 mod 32
  return nt + (40 - nt % 32) % 32;
}
// A stage holds kmax = min(BK, CeP) values of K: per warpgroup a d tile (one
// box per 64 of them) and the gates of two images, and one w_prj piece;
// rounded so that every stage starts on a 1024-byte boundary.
__host__ __device__ constexpr int a_bytes(int kmax) {
  return (kmax + 63) / 64 * BOX_BYTES;
}
__host__ __device__ constexpr int stage_bytes(int nt, int nwg, int kmax) {
  return round_up(nwg * (a_bytes(kmax) + 2 * kmax * 4) + nt * kmax * 2, 1024);
}
// the fp32 output tile lies behind the ring, or over it where a CTA has one
// tile only (alias_out)
__host__ __device__ constexpr int project_smem(int nt, int nwg, int kmax,
                                               int stages, bool alias_out) {
  const int ring = stages * stage_bytes(nt, nwg, kmax);
  const int out = nwg * BM * out_stride(nt) * 4;
  return HEADER + (alias_out ? (ring > out ? ring : out) : ring + out);
}

// One CTA = NWG consumer warpgroups, each with 64 rows of a tile of 64 NWG
// rows and sharing the w_prj piece of a stage, and a producer warpgroup whose
// first warp issues every copy. The CTA walks over the row tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... and, within a tile, over the K-blocks; a step is
// one K-block of one tile, and the ring runs across tiles and K-blocks alike.
// Cursors count the steps up by hand: a division per step and thread would
// cost more than the step's own work.
struct Cursor {
  int ti, kb, stage, phase;
};

// KS is the most 16-wide K-steps a stage can hold: 8, or 2 for a block of
// K <= 32 (a streaming pass: a tile is one short step). That variant keeps
// few registers and leaves them be, so that several CTAs share an SM and
// hide each other's per-tile chain; the other takes the producer
// warpgroup's registers.
template <int NT, int NWG, int KS>
__global__ void __launch_bounds__(128 * NWG + 128, KS == 2 ? 2 : 1)
project_kernel(const __grid_constant__ CUtensorMap d_map,
               const float* __restrict__ gate,
               const unsigned char* __restrict__ w_pack,
               const float* __restrict__ b_prj,
               const __nv_bfloat16* __restrict__ skip,
               __nv_bfloat16* __restrict__ out, int M, int hw, int cep, int co,
               int cols_per_cta, int stages, int alias_out) {
  constexpr int CONSUMERS = 128 * NWG;
  constexpr int BMT = BM * NWG;  // rows per tile
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int n0 = blockIdx.y * cols_per_cta;
  const int ncols = min(cols_per_cta, co - n0);
  const int nkb = (cep + BK - 1) / BK;
  const int kmax = min(BK, cep);
  const int a_b = a_bytes(kmax);                // a warpgroup's d tile
  const int g_off = NWG * a_b;                  // gates in a stage
  const int b_off = g_off + NWG * 2 * kmax * 4;  // w_prj piece in a stage
  const int stage_b = stage_bytes(NT, NWG, kmax);
  const int row_tiles = (M + BMT - 1) / BMT;
  const int my_tiles = (row_tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                       (int)gridDim.x;
  const uint32_t full0 = smem_addr(smem);       // stage filled
  const uint32_t empty0 = full0 + 8 * MAX_STAGES;  // stage released
  // the swizzled boxes want the ring on a 1024-byte boundary
  unsigned char* ring = smem + 128 + ((1024 - ((full0 + 128) & 1023)) & 1023);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);           // the producer's expect_tx
      mbar_init(empty0 + 8 * s, 4 * NWG);    // one lane of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  auto advance = [&](Cursor& c) {
    if (++c.kb == nkb) {
      c.kb = 0;
      ++c.ti;
    }
    if (++c.stage == stages) {
      c.stage = 0;
      c.phase ^= 1;
    }
  };
  auto tile_row0 = [&](const Cursor& c) {
    return (int)(blockIdx.x + c.ti * gridDim.x) * BMT;
  };

  // the warpgroup's index by a shuffle, so that the compiler knows it to be
  // the same in all lanes: a wgmma under a branch that it takes for divergent
  // is serialised
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (wg == NWG) {
    // the producer warpgroup gives its registers to the consumers; only its
    // first warp works
    if (KS > 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid >= CONSUMERS + 32) return;
    // ---- producer warp: every copy goes through the copy engine onto the
    // stage's `full` barrier. Lane 0 announces the bytes and brings this
    // CTA's columns of the K-block of w_prj in one piece; lanes 1.. bring the
    // boxes of d (two per warpgroup, one if the K-block ends in the first)
    // and the gates of each warpgroup's (at most two) images.
    Cursor c{0, 0, 0, 0};
    for (int n = 0; c.ti < my_tiles; ++n, advance(c)) {
      if (n >= stages) mbar_wait(empty0 + 8 * c.stage, c.phase ^ 1);
      const int m0 = tile_row0(c);
      const int k0 = c.kb * BK;
      const int bk = min(BK, cep - k0);
      const int halves = bk > 64 ? 2 : 1;
      const uint32_t bar = full0 + 8 * c.stage;
      const uint32_t dst = smem_addr(ring + c.stage * stage_b);
      if (lane == 0) {
        const uint32_t w_bytes = NT * bk * 2;
        mbar_expect_tx(bar, w_bytes + NWG * halves * BOX_BYTES +
                                NWG * 2 * bk * 4);
        bulk_load(dst + b_off,
                  w_pack + ((size_t)k0 * co + (size_t)n0 * bk) * 2, w_bytes,
                  bar);
      } else if (lane <= NWG * 2) {
        const int box = lane - 1;  // warpgroup * 2 + half
        if ((box & 1) < halves)
          tma_load_2d(dst + (box >> 1) * a_b + (box & 1) * BOX_BYTES, &d_map,
                      k0 + (box & 1) * 64, m0 + (box >> 1) * BM, bar);
      } else if (lane <= NWG * 4) {
        const int sel = lane - 1 - NWG * 2;  // warpgroup * 2 + which image
        const int img = min(min(m0 + (sel >> 1) * BM, M - 1) / hw + (sel & 1),
                            M / hw - 1);
        bulk_load(dst + g_off + sel * (kmax * 4),
                  gate + (size_t)img * cep + k0, bk * 4, bar);
      }
    }
    return;
  }

  // ---- consumer warpgroups
  if (KS > 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(NWG == 1 ? 240
                                                                       : 232));
  const int warp = (tid >> 5) & 3;  // within the warpgroup
  const int g = lane >> 2;
  const int q = lane & 3;
  constexpr int OS = out_stride(NT);
  float* so = reinterpret_cast<float*>(
      alias_out ? ring : ring + stages * stage_b);

  // ldmatrix: lanes 0-7 address rows 0-7 of matrix 0 (rows 0-7, k 0-7),
  // 8-15 matrix 1 (rows 8-15, k 0-7), 16-23 matrix 2 (rows 0-7, k 8-15),
  // 24-31 matrix 3 (rows 8-15, k 8-15). In a box a row is 128 bytes and its
  // 16-byte chunk c lies at chunk c ^ (row & 7) (the 128-byte swizzle).
  const int lm_row = wg * a_b +
                     (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * 128;
  const int lm_hi = lane >> 4;   // second 8 of the 16 k of a step
  const int lm_x = lane & 7;     // row & 7
  // this thread's rows g and g + 8 of its warp's 16: where in a stage the
  // gates of each row's image lie (of the tile being prepared)
  int g_lo = 0, g_hi = 0;

  // A fragments of a step: ldmatrix of the d tile, times the row's gate in
  // fp32, rounded to bf16. `full` says that the K-block has all BK values:
  // then the loop has no branch and the loads of all its steps overlap.
  auto prep_steps = [&](const Cursor& c, uint32_t (&a)[KS][4], int nks,
                        auto full) {
    const unsigned char* stage = ring + c.stage * stage_b;
    const uint32_t a_src = smem_addr(stage) + lm_row;
    const float* gl = reinterpret_cast<const float*>(stage + g_lo);
    const float* gh = reinterpret_cast<const float*>(stage + g_hi);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (decltype(full)::value || ks < nks) {
        ldmatrix_x4(a[ks], a_src + (ks >> 2) * BOX_BYTES +
                               ((((2 * ks + lm_hi) & 7) ^ lm_x) << 4));
        const float2 gl0 = *reinterpret_cast<const float2*>(gl + ks * 16);
        const float2 gl1 = *reinterpret_cast<const float2*>(gl + ks * 16 + 8);
        const float2 gh0 = *reinterpret_cast<const float2*>(gh + ks * 16);
        const float2 gh1 = *reinterpret_cast<const float2*>(gh + ks * 16 + 8);
        float2 v = unpack_bf16(a[ks][0]);
        a[ks][0] = pack_bf16(v.x * gl0.x, v.y * gl0.y);
        v = unpack_bf16(a[ks][1]);
        a[ks][1] = pack_bf16(v.x * gh0.x, v.y * gh0.y);
        v = unpack_bf16(a[ks][2]);
        a[ks][2] = pack_bf16(v.x * gl1.x, v.y * gl1.y);
        v = unpack_bf16(a[ks][3]);
        a[ks][3] = pack_bf16(v.x * gh1.x, v.y * gh1.y);
      }
    }
  };
  auto prep = [&](const Cursor& c, uint32_t (&a)[KS][4]) {
    if (c.kb == 0) {
      // the warpgroup's rows lie in image m0 / hw or the next one
      const int m0 = tile_row0(c) + wg * BM;
      const int next_img = (min(m0, M - 1) / hw + 1) * hw;  // its first row
      const int r = m0 + warp * 16 + g;
      g_lo = g_off + (wg * 2 + (min(r, M - 1) >= next_img)) * kmax * 4 + q * 8;
      g_hi =
          g_off + (wg * 2 + (min(r + 8, M - 1) >= next_img)) * kmax * 4 + q * 8;
    }
    const int nks = min(BK, cep - c.kb * BK) / 16;
    mbar_wait(full0 + 8 * c.stage, c.phase);
    if (nks == KS)
      prep_steps(c, a, nks, std::true_type{});
    else
      prep_steps(c, a, nks, std::false_type{});
  };

  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;

  // a finished tile: fp32 sums -> shared memory -> + bias + skip -> out, 16
  // bytes a thread. A thread keeps one group of 8 columns (nvq = the next
  // power of two of the groups) and walks down the rows.
  auto stage_out = [&]() {
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      float* p = so + (wg * BM + warp * 16 + g) * OS + j * 8 + 2 * q;
      *reinterpret_cast<float2*>(p) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(p + 8 * OS) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
  };
  const int nv = ncols / 8;
  int nvq_log = 0;
  while ((1 << nvq_log) < nv) ++nvq_log;
  const int my_v = tid & ((1 << nvq_log) - 1);
  float bias[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (my_v < nv) {
#pragma unroll
    for (int t = 0; t < 8; ++t) bias[t] = __ldg(b_prj + n0 + my_v * 8 + t);
  }
  // the skip of this thread's first two rows of a tile is fetched before the
  // tile's last wgmma is awaited (a streaming tile has no more than two)
  const bool with_skip = skip != nullptr;
  uint4 skip_early[2];
  auto fetch_skip = [&](int m0) {
    if (!with_skip || my_v >= nv) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + (tid >> nvq_log) + i * (CONSUMERS >> nvq_log);
      if (m < min(M, m0 + BMT))
        skip_early[i] = *reinterpret_cast<const uint4*>(
            skip + (size_t)m * co + n0 + my_v * 8);
    }
  };
  auto write_out = [&](int m0) {
    if (my_v >= nv) return;
    int pass = 0;
    for (int row = tid >> nvq_log; row < BMT;
         row += CONSUMERS >> nvq_log, ++pass) {
      const int m = m0 + row;
      if (m >= M) break;
      const float4 s0 =
          *reinterpret_cast<const float4*>(so + row * OS + my_v * 8);
      const float4 s1 =
          *reinterpret_cast<const float4*>(so + row * OS + my_v * 8 + 4);
      float r[8] = {s0.x + bias[0], s0.y + bias[1], s0.z + bias[2],
                    s0.w + bias[3], s1.x + bias[4], s1.y + bias[5],
                    s1.z + bias[6], s1.w + bias[7]};
      const size_t o = (size_t)m * co + n0 + my_v * 8;
      if (with_skip) {
        const uint4 sk = pass == 0   ? skip_early[0]
                         : pass == 1 ? skip_early[1]
                                     : *reinterpret_cast<const uint4*>(skip + o);
        const uint32_t w[4] = {sk.x, sk.y, sk.z, sk.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float2 f = unpack_bf16(w[t]);
          r[2 * t] += f.x;
          r[2 * t + 1] += f.y;
        }
      }
      *reinterpret_cast<uint4*>(out + o) =
          make_uint4(pack_bf16(r[0], r[1]), pack_bf16(r[2], r[3]),
                     pack_bf16(r[4], r[5]), pack_bf16(r[6], r[7]));
    }
  };

  Cursor pc{0, 0, 0, 0};  // to prepare
  Cursor mc{0, 0, 0, 0};  // to multiply

  // one step: the wgmma of this step runs while the A fragments of the next
  // are made; then the stage goes back to the producer
  auto step = [&](uint32_t (&cur)[KS][4], uint32_t (&nxt)[KS][4]) {
    const int nks = min(BK, cep - mc.kb * BK) / 16;
    const uint64_t db = wgmma_desc(
        smem_addr(ring + mc.stage * stage_b + b_off), 128, nks * 256);
    wgmma_fence();
    if (nks == KS) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wgmma_rs<NT>(acc, cur[ks], db + ks * 16);
    } else {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        if (ks < nks) wgmma_rs<NT>(acc, cur[ks], db + ks * 16);
    }
    wgmma_commit();
    const bool tile_done = mc.kb == nkb - 1;
    if (tile_done) fetch_skip(tile_row0(mc));
    if (pc.ti < my_tiles) {
      prep(pc, nxt);
      advance(pc);
    }
    wgmma_wait();
    if (tile_done) {
      // with alias_out this is the CTA's last step: the output tile is
      // staged over the ring once every warp is done with it
      if (alias_out) named_barrier(1, CONSUMERS);
      stage_out();
      named_barrier(1, CONSUMERS);
      write_out(tile_row0(mc));
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * mc.stage);
    if (tile_done && !alias_out) named_barrier(1, CONSUMERS);
    advance(mc);
  };

  const int nsteps = my_tiles * nkb;
  uint32_t a0[KS][4], a1[KS][4];
  prep(pc, a0);
  advance(pc);
  for (int t = 0; t < nsteps; t += 2) {
    step(a0, a1);
    if (t + 1 < nsteps) step(a1, a0);
  }
}

template <int NT, int NWG, int KS>
cudaError_t launch_project(cudaStream_t stream, const __nv_bfloat16* d,
                           const float* gate, const unsigned char* w_pack,
                           const float* b_prj, const __nv_bfloat16* skip,
                           __nv_bfloat16* out, int M, int hw, int cep, int co,
                           int cols_per_cta, int row_ctas, int stages) {
  const int row_tiles = (M + BM * NWG - 1) / (BM * NWG);
  const bool alias_out = row_ctas >= row_tiles;
  const int smem =
      project_smem(NT, NWG, cep < BK ? cep : BK, stages, alias_out);
  if (smem > MAX_SMEM || encode_tiled() == nullptr)
    return cudaErrorInvalidValue;
  // d as a 2-D tensor (CeP fastest, then M), read in 64 x 64 boxes
  CUtensorMap d_map;
  const cuuint64_t dims[2] = {(cuuint64_t)cep, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)cep * 2};
  const cuuint32_t box[2] = {64, BM};
  const cuuint32_t elem[2] = {1, 1};
  if (encode_tiled()(&d_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                     const_cast<__nv_bfloat16*>(d), dims, strides, box, elem,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  auto kern = project_kernel<NT, NWG, KS>;
  // this instantiation's dynamic shared memory limit, per device
  static int allowed[MAX_DEVICES] = {};
  const cudaError_t err = allow_dynamic_smem(kern, allowed, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(row_ctas, (co + cols_per_cta - 1) / cols_per_cta);
  kern<<<grid, 128 * NWG + 128, smem, stream>>>(d_map, gate, w_pack, b_prj, skip,
                                               out, M, hw, cep, co,
                                               cols_per_cta, stages, alias_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// (c). skip is NULL when the block has no identity skip. row_ctas CTAs of nwg
// (1 or 2) consumer warpgroups share the tiles of 64 nwg rows through a ring
// of `stages` (2 to 6) stages; with one tile per CTA the output tile is
// staged over the idle ring. hw (pixels per image) is at least 64, so that a
// warpgroup's rows touch two images at most. A CTA computes cols_per_cta
// output channels (a multiple of 8, at most 256), in the smallest accumulator
// width of {16, 32, 64, 96, 128, 192, 256} that holds them; w_pack carries
// that much slack behind its last value.
int mbconv_project(const void* d, const void* gate, const void* w_pack,
                   const void* b_prj, const void* skip, void* out, int M,
                   int hw, int cep, int co, int cols_per_cta, int row_ctas,
                   int nwg, int stages, void* stream) {
  if (cep % 16 != 0 || co % 8 != 0 || cols_per_cta % 8 != 0 ||
      cols_per_cta < 8 || cols_per_cta > 256 || hw < BM || M % hw != 0 ||
      row_ctas < 1 || stages < 2 || stages > MAX_STAGES || nwg < 1 || nwg > 2)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto dp = static_cast<const __nv_bfloat16*>(d);
  auto gp = static_cast<const float*>(gate);
  auto wp = static_cast<const unsigned char*>(w_pack);
  auto bp = static_cast<const float*>(b_prj);
  auto sp = static_cast<const __nv_bfloat16*>(skip);
  auto op = static_cast<__nv_bfloat16*>(out);
  const int c = cols_per_cta;
  // the streaming variant exists for the two narrowest accumulators
  const bool streaming = cep <= 32 && c <= 32;
#define MBCONV_LAUNCH(NT, NWG, KS)                                            \
  launch_project<NT, NWG, KS>(st, dp, gp, wp, bp, sp, op, M, hw, cep, co, c, \
                              row_ctas, stages)
#define MBCONV_PROJECT(NT)                                                    \
  if (c <= NT)                                                                \
    return (int)(nwg == 1 ? MBCONV_LAUNCH(NT, 1, 8) : MBCONV_LAUNCH(NT, 2, 8));
  if (streaming && c <= 16)
    return (int)(nwg == 1 ? MBCONV_LAUNCH(16, 1, 2) : MBCONV_LAUNCH(16, 2, 2));
  if (streaming)
    return (int)(nwg == 1 ? MBCONV_LAUNCH(32, 1, 2) : MBCONV_LAUNCH(32, 2, 2));
  MBCONV_PROJECT(16)
  MBCONV_PROJECT(32)
  MBCONV_PROJECT(64)
  MBCONV_PROJECT(96)
  MBCONV_PROJECT(128)
  MBCONV_PROJECT(192)
  MBCONV_PROJECT(256)
#undef MBCONV_PROJECT
#undef MBCONV_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
