// Kernel (a) of the eval-mode MBConv block (see mbconv.cu for the block as a
// whole): expand 1x1 + bias + swish -> bf16 -> depthwise kxk (stride s) +
// bias + swish, for Hopper (sm_90a). Replaces the first half of
// mm_distillnet_tpu/ops/pallas_mbconv.py::_mbconv_kernel.
//
// What bounds it on an H100. By bytes the kernel could run in 0.33 ms per
// D2@768 forward at batch 8; what it really pays for is on-chip work that
// the byte count does not see: the expand is recomputed on every tile's
// halo so that the expanded activation never goes to device memory, every
// expanded value costs an exponential and a division (the special-function
// unit does 16 a clock per SM), and every depthwise tap is an fp32 FMA fed
// from shared memory. The design spends each of these once and overlaps
// them:
//
//   * One CTA (512 threads, four warpgroups) owns a spatial output tile
//     (16x8 at stride 1, 8x8 at stride 2 and on the 24x24 maps) of one image
//     and walks over chunks of NC = 48 expanded channels (Ce = 6 Cin is a
//     multiple of 48 for every EfficientNet width: no channel padding). The
//     input halo comes into shared memory once per CTA by 16-byte cp.async
//     (zero filled outside the image), straight into the core-matrix order
//     that wgmma reads.
//   * The weights arrive ready to use: at fold time w_exp is cut into
//     48-channel chunks, transposed to K-major core-matrix order and padded
//     in K, with its bias behind it; w_dw and b_dw are cut the same way. Each
//     chunk is one contiguous record that the copy engine brings in
//     (cp.async.bulk onto an mbarrier), two stages deep, one iteration ahead.
//   * Expand on wgmma m64n48k16: M = halo pixels in groups of 64 dealt over
//     the four warpgroups, bf16 operands from shared memory, fp32 sums in
//     registers. The wgmma of chunk i+1 is issued, then the same warps run
//     the depthwise of chunk i while the tensor cores work, then they wait,
//     apply bias + swish (zero outside the image: TF-SAME pads the *expanded*
//     activation) and write chunk i+1 as bf16 into the other of two tile
//     buffers. One __syncthreads per chunk.
//   * Depthwise: a thread owns two neighbouring channels (one bf16x2 word)
//     of a strip of 8 output pixels. For each tap row it loads the 7s + k
//     words of the strip's window once and reuses them from registers for
//     all k taps of all 8 outputs; fp32 from the bias. The tile buffer's
//     pixel stride (112 bytes) and row stride are chosen so that both the
//     wgmma epilogue's stores and the depthwise's loads hit 32 banks.
//   * Output: the chunk's bf16 tile is staged in shared memory and written
//     16 bytes a thread; the un-rounded fp32 channel sums of the tile are
//     reduced over its strips in a fixed order (no atomics) for kernel (b).
//   * Where tiles x images do not fill 132 SMs (24x24 maps), the chunks of a
//     tile are split over blockIdx.y; each CTA then loads the halo once for
//     its share of the chunks.
//
// A block without expand (expand_ratio 1, the first stage) has no GEMM: its
// variant streams the input tile through the same depthwise.
//
// Layouts: x (B, H, W, Cin) bf16; d (B, Ho, Wo, CeP) bf16; psum (B, T, CeP)
// f32 with T the number of tiles; wexp_pack, dw_pack as ops/fused_mbconv.py
// `pack_expand` writes them.

#include <type_traits>

#include "mbconv_common.cuh"

namespace {

using namespace mbconv;

constexpr int NC = 48;            // expanded channels per chunk
constexpr int THREADS = 512;      // four warpgroups
constexpr int NWG = THREADS / 128;
constexpr int EPX = NC * 2 + 16;  // bytes per pixel of the expanded tile
constexpr int DW_THREADS = 256;   // the variant without expand

// row stride of the expanded tile: consecutive strips of a warp lie s rows
// apart; s * stride = 96 (mod 128) puts their loads on disjoint banks
__host__ __device__ constexpr int tile_row_stride(int min_bytes, int s) {
  int r = round_up(min_bytes, 16);
  while ((s * r) % 128 != 96) r += 16;
  return r;
}

template <int K, int S, int TH, int TW>
struct Geom {
  static constexpr int HPH = (TH - 1) * S + K;   // halo rows
  static constexpr int HPW = (TW - 1) * S + K;   // halo columns
  static constexpr int NP = HPH * HPW;           // halo pixels
  static constexpr int MG = (NP + 63) / 64;      // 64-row groups of the GEMM
  static constexpr int GPW = (MG + NWG - 1) / NWG;
  static constexpr int RS = tile_row_stride(HPW * EPX, S);
  static constexpr int E_BYTES = round_up(HPH * RS, 128);
  // a strip is SW output pixels of a row: 8 in a 16x8 tile, 4 in an 8x8
  // one, so that either tile has 384 strips x channel pairs for 512 threads
  // (k5 s2 keeps 8: its 19x19 halo leaves no room for 16 strips' sums)
  static constexpr int SW = TH * TW >= 128 || (K == 5 && S == 2) ? 8 : 4;
  static constexpr int NSTRIP = TH * (TW / SW);
  static_assert(NSTRIP % 4 == 0, "the strip sums are reduced in quarters");
  static constexpr int NITEMS = NSTRIP * (NC / 2);
  static constexpr int STG_BYTES = TH * TW * NC * 2;
  static constexpr int RED_BYTES = NSTRIP * NC * 4;
  static constexpr int DREC = (K * K + 1) * NC * 4;  // w_dw + b_dw of a chunk

  __host__ __device__ static constexpr int wrec(int kpad) {
    return NC * kpad * 2 + NC * 4;               // w_exp + b_exp of a chunk
  }
  __host__ __device__ static constexpr int stage_bytes(int kpad) {
    return round_up(wrec(kpad) + DREC, 128);
  }
  __host__ __device__ static constexpr int xs_bytes(int kpad) {
    return MG * 64 * kpad * 2;
  }
  __host__ __device__ static constexpr int smem_bytes(int kpad) {
    return 128 + xs_bytes(kpad) + 2 * stage_bytes(kpad) + 2 * E_BYTES +
           2 * STG_BYTES + 2 * RED_BYTES;
  }
};

// The depthwise of one strip: SW output pixels of two channels. `row0` points
// at the strip's first window word in the tile (pixel stride `px` bytes, row
// stride `rs`), `w` at the two channels' taps (tap stride `wstride` floats).
template <int K, int S, int SW>
__device__ __forceinline__ void depthwise_strip(const unsigned char* row0,
                                                int px, int rs, const float* w,
                                                int wstride, float2 bias,
                                                float2 (&acc)[SW]) {
  constexpr int WN = (SW - 1) * S + K;
#pragma unroll
  for (int j = 0; j < SW; ++j) acc[j] = bias;
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
    float2 win[WN];
#pragma unroll
    for (int i = 0; i < WN; ++i)
      win[i] = unpack_bf16(
          *reinterpret_cast<const uint32_t*>(row0 + dy * rs + i * px));
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
      const float2 t =
          *reinterpret_cast<const float2*>(w + (dy * K + dx) * wstride);
#pragma unroll
      for (int j = 0; j < SW; ++j) {
        acc[j].x = fmaf(win[j * S + dx].x, t.x, acc[j].x);
        acc[j].y = fmaf(win[j * S + dx].y, t.y, acc[j].y);
      }
    }
  }
}

// swish of a strip, staged as bf16 (pixel stride `px` bytes) and summed
// un-rounded over the pixels inside the image
template <int SW>
__device__ __forceinline__ float2 finish_strip(const float2 (&acc)[SW],
                                               unsigned char* stg, int px,
                                               bool row_ok, int ox0, int wo) {
  float2 sum = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int j = 0; j < SW; ++j) {
    const float v0 = swish_f(acc[j].x);
    const float v1 = swish_f(acc[j].y);
    if (row_ok && ox0 + j < wo) {
      sum.x += v0;
      sum.y += v1;
    }
    *reinterpret_cast<uint32_t*>(stg + j * px) = pack_bf16(v0, v1);
  }
  return sum;
}

template <int K, int S, int TH, int TW>
__global__ void __launch_bounds__(THREADS, 1)
expand_dw_kernel(const __nv_bfloat16* __restrict__ x,
                 const unsigned char* __restrict__ wexp_pack,
                 const unsigned char* __restrict__ dw_pack,
                 __nv_bfloat16* __restrict__ d, float* __restrict__ psum,
                 int H, int W, int cin, int kpad, int cep, int ho, int wo,
                 int pad_t, int pad_l, int tiles_x, int chunks_per_cta) {
  using G = Geom<K, S, TH, TW>;
  extern __shared__ __align__(128) unsigned char smem[];
  // kernel (b) may come up beside this grid's last CTAs: it stages its
  // weights and then waits for the whole of this grid
  griddep_launch_dependents();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // the warpgroup's index by a shuffle, so that the compiler knows it to be
  // the same in all lanes: a wgmma under a branch that it takes for divergent
  // is serialised
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int tile = blockIdx.x;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const int b = blockIdx.z;
  const int nchunk = cep / NC;
  const int c_begin = blockIdx.y * chunks_per_cta;
  const int n = min(chunks_per_cta, nchunk - c_begin);
  if (n <= 0) return;
  const int iy0 = ty * TH * S - pad_t;
  const int ix0 = tx * TW * S - pad_l;
  const int oy0 = ty * TH;
  const int ox0 = tx * TW;

  const int wrec = G::wrec(kpad);
  const int stage_bytes = G::stage_bytes(kpad);
  unsigned char* xs = smem + 128;
  unsigned char* stages = xs + G::xs_bytes(kpad);
  unsigned char* ebuf = stages + 2 * stage_bytes;
  unsigned char* stg = ebuf + 2 * G::E_BYTES;
  float* red = reinterpret_cast<float*>(stg + 2 * G::STG_BYTES);
  const uint32_t bar0 = smem_addr(smem);

  // record j holds w_exp/b_exp of chunk j (used by the GEMM one iteration
  // ahead) and w_dw/b_dw of chunk j - 1; it lives in stage j & 1
  auto issue_record = [&](int j) {
    if (j > n) return;
    const uint32_t bar = bar0 + 8 * (j & 1);
    const uint32_t dst = smem_addr(stages + (j & 1) * stage_bytes);
    const uint32_t bytes = (j < n ? wrec : 0) + (j >= 1 ? G::DREC : 0);
    fence_async_proxy();
    mbar_expect_tx(bar, bytes);
    if (j < n)
      bulk_load(dst, wexp_pack + (size_t)(c_begin + j) * wrec, wrec, bar);
    if (j >= 1)
      bulk_load(dst + wrec, dw_pack + (size_t)(c_begin + j - 1) * G::DREC,
                G::DREC, bar);
  };

  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    issue_record(0);
    issue_record(1);
  }

  // the input halo, once: pixel p, channels 8v..8v+7 -> core-matrix order
  {
    const int kv = kpad / 8;
    const __nv_bfloat16* xb = x + (size_t)b * H * W * cin;
    const uint32_t xs_a = smem_addr(xs);
    for (int i = tid; i < G::MG * 64 * kv; i += THREADS) {
      const int p = i / kv;
      const int v = i - p * kv;
      const int hy = p / G::HPW;
      const int iy = iy0 + hy;
      const int ix = ix0 + (p - hy * G::HPW);
      const bool valid = p < G::NP && v * 8 < cin && iy >= 0 && iy < H &&
                         ix >= 0 && ix < W;
      const __nv_bfloat16* src =
          valid ? xb + ((size_t)iy * W + ix) * cin + v * 8 : xb;
      cp_async16(xs_a + core_offset(p, v * 8, kpad), src, valid);
    }
    cp_async_commit();
    cp_async_wait<0>();
    fence_async_proxy();
  }
  __syncthreads();

  float acc[G::GPW][NC / 2];
  const uint32_t xs_a = smem_addr(xs);

  // expand GEMM of chunk j (its w_exp lies in stage j & 1): this
  // warpgroup's 64-row groups, all of K
  auto issue_gemm = [&](int j) {
    const uint32_t wb = smem_addr(stages + (j & 1) * stage_bytes);
    wgmma_fence();
#pragma unroll
    for (int gi = 0; gi < G::GPW; ++gi) {
      const int mg = wg + NWG * gi;
      if (mg < G::MG) {
        const uint64_t da = wgmma_desc(xs_a + mg * 64 * kpad * 2, 128, kpad * 16);
        const uint64_t db = wgmma_desc(wb, 128, kpad * 16);
        for (int ks = 0; ks < kpad / 16; ++ks)
          wgmma_ss_n48(acc[gi], da + ks * 16, db + ks * 16, ks > 0);
      }
    }
    wgmma_commit();
  };

  // bias + swish + zero outside the image -> bf16 tile buffer j & 1
  auto epilogue = [&](int j) {
    const float* be = reinterpret_cast<const float*>(
        stages + (j & 1) * stage_bytes + NC * kpad * 2);
    unsigned char* e = ebuf + (j & 1) * G::E_BYTES;
    const int g = lane >> 2;
    const int q = lane & 3;
    const int wrow = ((tid >> 5) & 3) * 16;
#pragma unroll
    for (int gi = 0; gi < G::GPW; ++gi) {
      const int mg = wg + NWG * gi;
      if (mg >= G::MG) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = mg * 64 + wrow + g + 8 * h;
        if (p >= G::NP) continue;
        const int hy = p / G::HPW;
        const int hx = p - hy * G::HPW;
        const int iy = iy0 + hy;
        const int ix = ix0 + hx;
        const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W;
        unsigned char* dst = e + hy * G::RS + hx * EPX + q * 4;
#pragma unroll
        for (int jn = 0; jn < NC / 8; ++jn) {
          uint32_t v = 0u;
          if (inside) {
            const float2 bias =
                *reinterpret_cast<const float2*>(be + jn * 8 + 2 * q);
            v = pack_bf16(swish_f(acc[gi][4 * jn + 2 * h] + bias.x),
                          swish_f(acc[gi][4 * jn + 2 * h + 1] + bias.y));
          }
          *reinterpret_cast<uint32_t*>(dst + jn * 16) = v;
        }
      }
    }
  };

  // the staged bf16 tile of chunk i -> d, 16 bytes a thread; the strips'
  // sums -> psum in a fixed order
  auto copy_out = [&](int i) {
    const unsigned char* s = stg + (i & 1) * G::STG_BYTES;
    const int c0 = (c_begin + i) * NC;
    constexpr int VPP = NC * 2 / 16;  // 16-byte vectors per pixel
    for (int idx = tid; idx < TH * TW * VPP; idx += THREADS) {
      const int p = idx / VPP;
      const int v = idx - p * VPP;
      const int oy = oy0 + p / TW;
      const int ox = ox0 + p % TW;
      if (oy < ho && ox < wo)
        *reinterpret_cast<uint4*>(d + (((size_t)b * ho + oy) * wo + ox) * cep +
                                  c0 + v * 8) =
            *reinterpret_cast<const uint4*>(s + idx * 16);
    }
    // four lanes a channel, each a quarter of the strips in order, then the
    // quarters pairwise: one fixed association, the same in every run
    if (tid < NC * 4) {
      const float* r = red + (i & 1) * (G::RED_BYTES / 4);
      const int c = tid >> 2;
      const int part = tid & 3;
      float sum = 0.0f;
#pragma unroll
      for (int st = 0; st < G::NSTRIP / 4; ++st)
        sum += r[(part * (G::NSTRIP / 4) + st) * NC + c];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0)
        psum[((size_t)b * gridDim.x + tile) * cep + c0 + c] = sum;
    }
  };

  // prologue: chunk 0 expanded into tile buffer 0
  mbar_wait(bar0, 0);
  issue_gemm(0);
  wgmma_wait();
  epilogue(0);
  __syncthreads();
  if (tid == 0) issue_record(2);

  // One iteration; `more` (a compile-time flag, so that no wgmma sits under
  // a run-time branch) says that a next chunk's GEMM runs beside it.
  auto iteration = [&](int i, auto more) {
    constexpr bool MORE = decltype(more)::value;
    const int j = i + 1;  // the record this iteration reads
    mbar_wait(bar0 + 8 * (j & 1), (j >> 1) & 1);
    if constexpr (MORE) issue_gemm(j);
    if (i > 0) copy_out(i - 1);

    const unsigned char* e = ebuf + (i & 1) * G::E_BYTES;
    const float* wd = reinterpret_cast<const float*>(
        stages + (j & 1) * stage_bytes + wrec);
    unsigned char* so = stg + (i & 1) * G::STG_BYTES;
    float* r = red + (i & 1) * (G::RED_BYTES / 4);
    // the strips go first to the warpgroups with the fewest 64-row groups to
    // expand (those from MG % NWG on), so that no warpgroup has the most of
    // both kinds of work
    for (int item = (tid + THREADS - 128 * (G::MG % NWG)) % THREADS;
         item < G::NITEMS; item += THREADS) {
      const int strip = item / (NC / 2);
      const int pair = item - strip * (NC / 2);
      constexpr int SW = G::SW;
      const int oy = strip / (TW / SW);
      const int sx = strip - oy * (TW / SW);
      float2 dacc[SW];
      depthwise_strip<K, S, SW>(
          e + oy * S * G::RS + sx * SW * S * EPX + pair * 4, EPX, G::RS,
          wd + pair * 2, NC,
          *reinterpret_cast<const float2*>(wd + K * K * NC + pair * 2), dacc);
      const float2 sum =
          finish_strip<SW>(dacc, so + (oy * TW + sx * SW) * NC * 2 + pair * 4,
                           NC * 2, oy0 + oy < ho, ox0 + sx * SW, wo);
      *reinterpret_cast<float2*>(r + strip * NC + pair * 2) = sum;
    }

    if constexpr (MORE) {
      wgmma_wait();
      epilogue(j);
    }
    __syncthreads();
    if (tid == 0) issue_record(i + 3);
  };
  for (int i = 0; i + 1 < n; ++i) iteration(i, std::true_type{});
  iteration(n - 1, std::false_type{});
  copy_out(n - 1);
}

// A block without expand: the depthwise streams the input tile itself.
// cep channels (cin of them real) in one pass; w_dw (k, k, cep), b_dw (cep).
template <int K, int S>
__global__ void __launch_bounds__(DW_THREADS)
dw_only_kernel(const __nv_bfloat16* __restrict__ x,
               const float* __restrict__ w_dw, const float* __restrict__ b_dw,
               __nv_bfloat16* __restrict__ d, float* __restrict__ psum, int H,
               int W, int cin, int cep, int ho, int wo, int pad_t, int pad_l,
               int tiles_x) {
  constexpr int TH = 16, TW = 8;
  constexpr int HPH = (TH - 1) * S + K;
  constexpr int HPW = (TW - 1) * S + K;
  constexpr int NSTRIP = TH * (TW / 8);
  extern __shared__ __align__(128) unsigned char smem[];
  griddep_launch_dependents();  // as in expand_dw_kernel
  const int px = cep * 2 + 16;  // bytes per pixel of the input tile
  unsigned char* e = smem;
  unsigned char* stg = e + round_up(HPH * HPW * px, 128);
  float* red = reinterpret_cast<float*>(stg + TH * TW * cep * 2);
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const int b = blockIdx.z;
  const int iy0 = ty * TH * S - pad_t;
  const int ix0 = tx * TW * S - pad_l;
  const int oy0 = ty * TH;
  const int ox0 = tx * TW;
  const int vpp = cep / 8;  // 16-byte vectors per pixel

  const __nv_bfloat16* xb = x + (size_t)b * H * W * cin;
  const uint32_t e_a = smem_addr(e);
  for (int i = tid; i < HPH * HPW * vpp; i += DW_THREADS) {
    const int p = i / vpp;
    const int v = i - p * vpp;
    const int hy = p / HPW;
    const int iy = iy0 + hy;
    const int ix = ix0 + (p - hy * HPW);
    const bool valid =
        v * 8 < cin && iy >= 0 && iy < H && ix >= 0 && ix < W;
    const __nv_bfloat16* src =
        valid ? xb + ((size_t)iy * W + ix) * cin + v * 8 : xb;
    cp_async16(e_a + p * px + v * 16, src, valid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int pairs = cep / 2;
  for (int item = tid; item < NSTRIP * pairs; item += DW_THREADS) {
    const int strip = item / pairs;
    const int pair = item - strip * pairs;
    const int oy = strip / (TW / 8);
    const int sx = strip - oy * (TW / 8);
    float2 dacc[8];
    depthwise_strip<K, S, 8>(
        e + (oy * S * HPW + sx * 8 * S) * px + pair * 4, px, HPW * px,
        w_dw + pair * 2, cep,
        *reinterpret_cast<const float2*>(b_dw + pair * 2), dacc);
    const float2 sum =
        finish_strip<8>(dacc, stg + (oy * TW + sx * 8) * cep * 2 + pair * 4,
                     cep * 2, oy0 + oy < ho, ox0 + sx * 8, wo);
    *reinterpret_cast<float2*>(red + strip * cep + pair * 2) = sum;
  }
  __syncthreads();

  for (int idx = tid; idx < TH * TW * vpp; idx += DW_THREADS) {
    const int p = idx / vpp;
    const int v = idx - p * vpp;
    const int oy = oy0 + p / TW;
    const int ox = ox0 + p % TW;
    if (oy < ho && ox < wo)
      *reinterpret_cast<uint4*>(d + (((size_t)b * ho + oy) * wo + ox) * cep +
                                v * 8) =
          *reinterpret_cast<const uint4*>(stg + idx * 16);
  }
  for (int c = tid; c < cep; c += DW_THREADS) {
    float sum = 0.0f;
#pragma unroll 4
    for (int st = 0; st < NSTRIP; ++st) sum += red[st * cep + c];
    psum[((size_t)b * gridDim.x + tile) * cep + c] = sum;
  }
}

struct Shape {
  int B, H, W, cin, kpad, cep, ho, wo, pad_t, pad_l, th, tw, nsplit;
};

template <int K, int S, int TH, int TW>
cudaError_t launch_expand(const Shape& s, cudaStream_t stream,
                          const __nv_bfloat16* x, const unsigned char* wexp,
                          const unsigned char* dw, __nv_bfloat16* d,
                          float* psum) {
  using G = Geom<K, S, TH, TW>;
  const int smem = G::smem_bytes(s.kpad);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  auto kern = expand_dw_kernel<K, S, TH, TW>;
  // this instantiation's dynamic shared memory limit, per device
  static int allowed[MAX_DEVICES] = {};
  const cudaError_t err = allow_dynamic_smem(kern, allowed, smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (s.wo + TW - 1) / TW;
  const int tiles_y = (s.ho + TH - 1) / TH;
  const int nchunk = s.cep / NC;
  const int per_cta = (nchunk + s.nsplit - 1) / s.nsplit;
  const dim3 grid(tiles_x * tiles_y, s.nsplit, s.B);
  kern<<<grid, THREADS, smem, stream>>>(x, wexp, dw, d, psum, s.H, s.W, s.cin,
                                        s.kpad, s.cep, s.ho, s.wo, s.pad_t,
                                        s.pad_l, tiles_x, per_cta);
  return cudaGetLastError();
}

template <int K, int S>
cudaError_t launch_dw_only(const Shape& s, cudaStream_t stream,
                           const __nv_bfloat16* x, const float* w_dw,
                           const float* b_dw, __nv_bfloat16* d, float* psum) {
  constexpr int TH = 16, TW = 8;
  constexpr int NPIX = ((TH - 1) * S + K) * ((TW - 1) * S + K);
  const int smem = round_up(NPIX * (s.cep * 2 + 16), 128) +
                   TH * TW * s.cep * 2 + TH * (TW / 8) * s.cep * 4;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  auto kern = dw_only_kernel<K, S>;
  // this instantiation's dynamic shared memory limit, per device
  static int allowed[MAX_DEVICES] = {};
  const cudaError_t err = allow_dynamic_smem(kern, allowed, smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (s.wo + TW - 1) / TW;
  const int tiles_y = (s.ho + TH - 1) / TH;
  const dim3 grid(tiles_x * tiles_y, 1, s.B);
  kern<<<grid, DW_THREADS, smem, stream>>>(x, w_dw, b_dw, d, psum, s.H, s.W,
                                        s.cin, s.cep, s.ho, s.wo, s.pad_t,
                                        s.pad_l, tiles_x);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// (a). With an expand, wexp_pack and dw_pack are the chunk records and the
// tile (th x tw) and the chunk split come from the wrapper's tile plan;
// without (wexp_pack NULL), w_dw and b_dw are the plain fp32 arrays and the
// tile is 16x8. psum has one row per tile of that plan.
int mbconv_expand_dw(const void* x, const void* wexp_pack, const void* dw_pack,
                     const void* w_dw, const void* b_dw, void* d, void* psum,
                     int B, int H, int W, int cin, int kpad, int cep, int k,
                     int s, int pad_t, int pad_l, int th, int tw, int nsplit,
                     void* stream) {
  const Shape sh{B, H, W, cin, kpad, cep, H / s, W / s, pad_t, pad_l, th, tw,
                 nsplit};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const __nv_bfloat16*>(x);
  auto dp = static_cast<__nv_bfloat16*>(d);
  auto ps = static_cast<float*>(psum);
  cudaError_t err = cudaErrorInvalidValue;
  if (cin % 8 != 0) return (int)err;
  if (wexp_pack == nullptr) {
    auto wd = static_cast<const float*>(w_dw);
    auto bd = static_cast<const float*>(b_dw);
    if (cep % 8 != 0 || th != 16 || tw != 8) return (int)err;
    if (k == 3 && s == 1) err = launch_dw_only<3, 1>(sh, st, xp, wd, bd, dp, ps);
    if (k == 3 && s == 2) err = launch_dw_only<3, 2>(sh, st, xp, wd, bd, dp, ps);
    if (k == 5 && s == 1) err = launch_dw_only<5, 1>(sh, st, xp, wd, bd, dp, ps);
    if (k == 5 && s == 2) err = launch_dw_only<5, 2>(sh, st, xp, wd, bd, dp, ps);
    return (int)err;
  }
  auto we = static_cast<const unsigned char*>(wexp_pack);
  auto dw = static_cast<const unsigned char*>(dw_pack);
  if (cep % NC != 0 || kpad % 16 != 0 || kpad < cin || nsplit < 1)
    return (int)err;
  const bool big = th == 16 && tw == 8;
  const bool small = th == 8 && tw == 8;
  if (k == 3 && s == 1 && big)
    err = launch_expand<3, 1, 16, 8>(sh, st, xp, we, dw, dp, ps);
  if (k == 5 && s == 1 && big)
    err = launch_expand<5, 1, 16, 8>(sh, st, xp, we, dw, dp, ps);
  if (k == 3 && s == 1 && small)
    err = launch_expand<3, 1, 8, 8>(sh, st, xp, we, dw, dp, ps);
  if (k == 5 && s == 1 && small)
    err = launch_expand<5, 1, 8, 8>(sh, st, xp, we, dw, dp, ps);
  if (k == 3 && s == 2 && small)
    err = launch_expand<3, 2, 8, 8>(sh, st, xp, we, dw, dp, ps);
  if (k == 5 && s == 2 && small)
    err = launch_expand<5, 2, 8, 8>(sh, st, xp, we, dw, dp, ps);
  return (int)err;
}

}  // extern "C"
