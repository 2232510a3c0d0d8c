// Eval-mode EfficientNet MBConv block with BN folded into the weights, as
// three CUDA kernels for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces mm_distillnet_tpu/ops/pallas_mbconv.py::_mbconv_kernel (launched
// by mbconv_fused). That TPU kernel keeps one whole image's block in VMEM;
// an H100 SM has 227 KB of shared memory, so the block is split:
//
//   (a) mbconv_expand_dw: per 8x8 output tile and 32 expanded channels,
//       expand 1x1 + bias + swish on the tile's input halo (recomputed, so
//       the expanded activation never goes to device memory; out-of-image
//       halo pixels are ZERO in the expanded domain, as TF-SAME pads the
//       depthwise input), rounded to bf16, then depthwise kxk (stride s) in
//       fp32 from the bias + swish. Writes the depthwise output in bf16 and
//       per-tile fp32 channel sums of the un-rounded output (no atomics: the
//       sums are reduced in a fixed order by (b)).
//   (b) mbconv_se: per image, reduce the tile sums to the mean and run the
//       two SE GEMVs -> fp32 gate per (image, channel).
//   (c) mbconv_project: tiled GEMM, A = bf16(depthwise out * gate) formed
//       as it is loaded, B = w_prj (bf16), fp32 accumulation; the epilogue
//       adds the bias and the bf16 identity skip in fp32, writes bf16.
//
// Rounding points are the TPU kernel's (pallas_mbconv.py:160-226).
//
// What bounds it: at D2@768 every block moves little data per FLOP of its
// 1x1 GEMMs (the byte bound is 10-50x the tensor-core bound). Both GEMMs
// run on the tensor cores with mma.sync m16n8k16 (bf16 operands from
// shared memory, fp32 accumulation); the depthwise and SE stay fp32 FMAs.
// wgmma/TMA and a persistent schedule are later work. The design keeps the
// expanded activation out of device memory, which is the point of the TPU
// kernel, at the price of recomputing the expand on the (k-1)-wide halo
// (1.1x-2.3x of the expand FLOPs). bf16 tiles in shared memory have row
// strides of 4 (mod 8) 32-bit words, so the fragment loads of a warp hit 32
// distinct banks.
//
// Layouts (all row-major, NHWC activations):
//   x      (B, H, W, Cin)   bf16       w_exp (Cin, CeP) bf16, b_exp (CeP) f32
//   w_dw   (k, k, CeP) f32             b_dw  (CeP) f32
//   d      (B, Ho, Wo, CeP) bf16       psum  (B, T, CeP) f32, T = 8x8 tiles
//   w_se1  (Cs, CeP) f32, b_se1 (Cs)   w_se2 (Cs, CeP) f32, b_se2 (CeP)
//   gate   (B, CeP) f32
//   w_prj  (CeP, Co) bf16, b_prj (Co)  out   (B, Ho, Wo, Co) bf16
// CeP is a multiple of 32; padded channels carry zero weights and stay 0.
// Ho = H / s (the wrapper refuses odd H or W at stride 2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 8;      // output tile side (pixels)
constexpr int CC = 32;       // expanded channels per block of (a)
constexpr int ES = CC + 8;   // (a): floats per halo pixel of the expanded tile
constexpr int THREADS = 256; // 8 warps: (a) maps warp -> output row
constexpr int KPAD = 8;      // bf16 padding of a shared-memory row (see above)
constexpr int SE_THREADS = 1024;  // (b): one block per image

constexpr int BM = 64;       // (c): rows (pixels) per block
constexpr int BN = 32;       // (c): output channels per block
constexpr int BK = 32;       // (c): K step
constexpr int LDT = BK + KPAD;

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}
__device__ __forceinline__ float swish_f(float v) { return v * sigmoid_f(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a * b for one 16x8x16 tile: a row-major, b column-major, fp32 sums.
__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__host__ __device__ constexpr int halo(int k, int s) {
  return (TILE - 1) * s + k;
}
__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}
// (a): bf16 row length of the input halo and of the transposed w_exp chunk
__host__ __device__ constexpr int expand_ld(int cin) {
  return round_up(cin, 16) + KPAD;
}

size_t expand_dw_smem(int k, int s, int cin, bool has_expand) {
  const size_t np = (size_t)halo(k, s) * halo(k, s);
  size_t bytes = (np * ES + (size_t)k * k * CC + 2 * CC + 8 * CC) * 4;
  if (has_expand) bytes += (CC + np) * (size_t)expand_ld(cin) * 2;
  return bytes;
}

// EXPAND false: a block without expand (Ce == Cin); a template argument, so
// that variant does not carry the expand's registers.
template <int K, int S, bool EXPAND>
__global__ void __launch_bounds__(THREADS)
expand_dw_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w_exp,
                 const float* __restrict__ b_exp,
                 const float* __restrict__ w_dw,
                 const float* __restrict__ b_dw,
                 __nv_bfloat16* __restrict__ d, float* __restrict__ psum,
                 int H, int W, int cin, int cep, int ho, int wo, int pad_t,
                 int pad_l, int tiles_x) {
  constexpr int HP = halo(K, S);
  constexpr int NP = HP * HP;
  extern __shared__ __align__(16) unsigned char smem[];
  float* es = reinterpret_cast<float*>(smem);   // NP x ES, bf16 values
  float* wd = es + NP * ES;                     // K*K x CC
  float* bd = wd + K * K * CC;                  // CC
  float* be = bd + CC;                          // CC
  float* red = be + CC;                         // 8 x CC
  // expand only: w_exp chunk transposed (CC x ld), input halo (NP x ld)
  const int ld = EXPAND ? expand_ld(cin) : 0;
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(red + 8 * CC);
  __nv_bfloat16* xs = wt + CC * ld;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const int c0 = blockIdx.y * CC;
  const int b = blockIdx.z;
  const int iy0 = ty * TILE * S - pad_t;
  const int ix0 = tx * TILE * S - pad_l;
  const __nv_bfloat16* xb = x + (size_t)b * H * W * cin;

  for (int i = tid; i < K * K * CC; i += THREADS)
    wd[i] = w_dw[(size_t)(i / CC) * cep + c0 + (i % CC)];
  if (tid < CC) {
    bd[tid] = b_dw[c0 + tid];
    be[tid] = EXPAND ? b_exp[c0 + tid] : 0.0f;
  }

  if (EXPAND) {
    const int kp = round_up(cin, 16);
    for (int i = tid; i < kp * CC; i += THREADS) {
      const int ci = i / CC;
      const int n = i - ci * CC;
      wt[n * ld + ci] = ci < cin ? w_exp[(size_t)ci * cep + c0 + n]
                                 : __float2bfloat16(0.0f);
    }
    // the halo, 16 bytes at a time (cin is a multiple of 8), zero outside
    // the image and past cin
    const int vec = ld / 8;
    for (int i = tid; i < NP * vec; i += THREADS) {
      const int p = i / vec;
      const int c8 = (i - p * vec) * 8;
      const int iy = iy0 + p / HP;
      const int ix = ix0 + p % HP;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (c8 < cin && iy >= 0 && iy < H && ix >= 0 && ix < W)
        v = *reinterpret_cast<const uint4*>(xb + ((size_t)iy * W + ix) * cin +
                                            c8);
      *reinterpret_cast<uint4*>(xs + p * ld + c8) = v;
    }
    __syncthreads();
    // expand 1x1 on the tensor cores: a warp takes 16 halo pixels x 32
    // channels at a time; rows past the halo repeat its last pixel and are
    // dropped
    const int g = lane >> 2;
    const int q = lane & 3;
    for (int p0 = warp * 16; p0 < NP; p0 += 16 * (THREADS / 32)) {
      float acc[CC / 8][4] = {};
      const __nv_bfloat16* a_lo = xs + min(p0 + g, NP - 1) * ld + 2 * q;
      const __nv_bfloat16* a_hi = xs + min(p0 + g + 8, NP - 1) * ld + 2 * q;
      const __nv_bfloat16* bq = wt + g * ld + 2 * q;
      for (int k0 = 0; k0 < kp; k0 += 16) {
        const uint32_t a0 = ld32(a_lo + k0);
        const uint32_t a1 = ld32(a_hi + k0);
        const uint32_t a2 = ld32(a_lo + k0 + 8);
        const uint32_t a3 = ld32(a_hi + k0 + 8);
#pragma unroll
        for (int nt = 0; nt < CC / 8; ++nt) {
          const __nv_bfloat16* bp = bq + nt * 8 * ld + k0;
          mma_bf16(acc[nt], a0, a1, a2, a3, ld32(bp), ld32(bp + 8));
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + g + 8 * h;
        if (p < NP) {
          const int iy = iy0 + p / HP;
          const int ix = ix0 + p % HP;
          const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W;
#pragma unroll
          for (int nt = 0; nt < CC / 8; ++nt) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int n = nt * 8 + 2 * q + j;
              es[p * ES + n] =
                  inside ? round_bf16(swish_f(acc[nt][2 * h + j] + be[n]))
                         : 0.0f;
            }
          }
        }
      }
    }
  } else {
    // no expand (expand_ratio 1): the input itself, zero past cin
    for (int i = tid; i < NP * CC; i += THREADS) {
      const int p = i / CC;
      const int c = i - p * CC;
      const int iy = iy0 + p / HP;
      const int ix = ix0 + p % HP;
      float v = 0.0f;
      if (c0 + c < cin && iy >= 0 && iy < H && ix >= 0 && ix < W)
        v = __bfloat162float(xb[((size_t)iy * W + ix) * cin + c0 + c]);
      es[p * ES + c] = v;
    }
  }
  __syncthreads();

  // depthwise: warp = output row of the tile, lane = channel, 8 columns
  float acc[TILE];
#pragma unroll
  for (int j = 0; j < TILE; ++j) acc[j] = bd[lane];
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
    const float* row = es + (warp * S + dy) * HP * ES + lane;
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
      const float w = wd[(dy * K + dx) * CC + lane];
#pragma unroll
      for (int j = 0; j < TILE; ++j)
        acc[j] = fmaf(row[(j * S + dx) * ES], w, acc[j]);
    }
  }
  float lsum = 0.0f;
  const int oy = ty * TILE + warp;
#pragma unroll
  for (int j = 0; j < TILE; ++j) {
    const int ox = tx * TILE + j;
    if (oy < ho && ox < wo) {
      const float v = swish_f(acc[j]);
      lsum += v;
      d[(((size_t)b * ho + oy) * wo + ox) * cep + c0 + lane] =
          __float2bfloat16(v);
    }
  }
  red[warp * CC + lane] = lsum;
  __syncthreads();
  if (tid < CC) {
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < THREADS / 32; ++r) s += red[r * CC + tid];
    psum[((size_t)b * gridDim.x + tile) * cep + c0 + tid] = s;
  }
}

__global__ void __launch_bounds__(SE_THREADS)
se_kernel(const float* __restrict__ psum, const float* __restrict__ w_se1,
          const float* __restrict__ b_se1, const float* __restrict__ w_se2,
          const float* __restrict__ b_se2, float* __restrict__ gate,
          int n_tiles, int cep, int cs, int hw) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nslice = max(1, SE_THREADS / cep);
  float* red = reinterpret_cast<float*>(smem);  // nslice x cep
  float* m = red + nslice * cep;                // cep
  float* s1 = m + cep;                          // cs
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* pb = psum + (size_t)b * n_tiles * cep;

  // tile sums -> channel sums, in a fixed order (deterministic); four
  // independent partial sums keep four loads in flight per thread
  for (int i = tid; i < nslice * cep; i += SE_THREADS) {
    const int sl = i / cep;
    const int c = i - sl * cep;
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int t = sl;
    for (; t + 3 * nslice < n_tiles; t += 4 * nslice) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        s[u] += pb[(size_t)(t + u * nslice) * cep + c];
    }
    for (; t < n_tiles; t += nslice) s[0] += pb[(size_t)t * cep + c];
    red[i] = (s[0] + s[1]) + (s[2] + s[3]);
  }
  __syncthreads();
  for (int c = tid; c < cep; c += SE_THREADS) {
    float s = 0.0f;
    for (int sl = 0; sl < nslice; ++sl) s += red[sl * cep + c];
    m[c] = s / (float)hw;
  }
  __syncthreads();

  // reduce GEMV: one warp per squeezed channel
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int j = warp; j < cs; j += SE_THREADS / 32) {
    float s = 0.0f;
    for (int c = lane; c < cep; c += 32)
      s = fmaf(m[c], w_se1[(size_t)j * cep + c], s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) s1[j] = swish_f(s + b_se1[j]);
  }
  __syncthreads();

  // expand GEMV + sigmoid: one thread per expanded channel
  for (int c = tid; c < cep; c += SE_THREADS) {
    float g = 0.0f;
    for (int j = 0; j < cs; ++j) g = fmaf(s1[j], w_se2[(size_t)j * cep + c], g);
    gate[(size_t)b * cep + c] = sigmoid_f(g + b_se2[c]);
  }
}

__global__ void __launch_bounds__(THREADS)
project_kernel(const __nv_bfloat16* __restrict__ d,
               const float* __restrict__ gate,
               const __nv_bfloat16* __restrict__ w_prj,
               const float* __restrict__ b_prj,
               const __nv_bfloat16* __restrict__ skip,
               __nv_bfloat16* __restrict__ out, int M, int hw, int cep,
               int co) {
  __shared__ __align__(16) __nv_bfloat16 As[BM * LDT];  // [m][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[BN * LDT];  // [n][k]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int wm = (warp & 3) * 16;   // a warp's tile: 16 rows x 16 columns
  const int wn = (warp >> 2) * 16;

  // A loader: 64 rows x 32 k, 8 consecutive k (16 bytes) per thread
  const int a_row = tid >> 2;
  const int a_col = (tid & 3) * 8;
  const int a_m = m0 + a_row;
  const __nv_bfloat16* a_src = d + (size_t)a_m * cep + a_col;
  const float* g_src = gate + (size_t)(a_m / hw) * cep + a_col;
  // B loader: 32 k x 32 n, 4 consecutive n per thread, stored transposed
  const int b_k = tid >> 3;
  const int b_n = (tid & 7) * 4;

  float acc[2][4] = {};
  for (int k0 = 0; k0 < cep; k0 += BK) {
    uint4 a_pack = make_uint4(0u, 0u, 0u, 0u);
    if (a_m < M) {
      const uint4 raw = *reinterpret_cast<const uint4*>(a_src + k0);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
      __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&a_pack);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        o[j] = __float2bfloat16(__bfloat162float(e[j]) * g_src[k0 + j]);
    }
    *reinterpret_cast<uint4*>(As + a_row * LDT + a_col) = a_pack;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + b_n + j;
      Bs[(b_n + j) * LDT + b_k] = n < co ? w_prj[(size_t)(k0 + b_k) * co + n]
                                         : __float2bfloat16(0.0f);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      const __nv_bfloat16* ap = As + (wm + g) * LDT + ks + 2 * q;
      const uint32_t a0 = ld32(ap);
      const uint32_t a1 = ld32(ap + 8 * LDT);
      const uint32_t a2 = ld32(ap + 8);
      const uint32_t a3 = ld32(ap + 8 * LDT + 8);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const __nv_bfloat16* bp = Bs + (wn + nt * 8 + g) * LDT + ks + 2 * q;
        mma_bf16(acc[nt], a0, a1, a2, a3, ld32(bp), ld32(bp + 8));
      }
    }
    __syncthreads();
  }

  // epilogue: two neighbouring channels per thread (co is even)
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int n = n0 + wn + nt * 8 + 2 * q;
    if (n >= co) continue;
    const float bias0 = b_prj[n];
    const float bias1 = b_prj[n + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + g + 8 * h;
      if (m >= M) continue;
      float v0 = acc[nt][2 * h] + bias0;
      float v1 = acc[nt][2 * h + 1] + bias1;
      if (skip != nullptr) {
        const __nv_bfloat162 sk =
            *reinterpret_cast<const __nv_bfloat162*>(skip + (size_t)m * co + n);
        v0 += __low2float(sk);
        v1 += __high2float(sk);
      }
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * co + n) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

template <int K, int S>
cudaError_t launch_expand_dw(dim3 grid, size_t smem, cudaStream_t stream,
                             const __nv_bfloat16* x,
                             const __nv_bfloat16* w_exp, const float* b_exp,
                             const float* w_dw, const float* b_dw,
                             __nv_bfloat16* d, float* psum, int H, int W,
                             int cin, int cep, int ho, int wo, int pad_t,
                             int pad_l, int tiles_x) {
  auto kern = w_exp != nullptr ? expand_dw_kernel<K, S, true>
                                : expand_dw_kernel<K, S, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, THREADS, smem, stream>>>(x, w_exp, b_exp, w_dw, b_dw, d, psum,
                                        H, W, cin, cep, ho, wo, pad_t, pad_l,
                                        tiles_x);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// (a). w_exp/b_exp are NULL for a block without expand (Ce == Cin). The
// wrapper checks expand_dw_smem (mirrored in ops/fused_mbconv.py) against
// the 227 KB a block may use; cudaFuncSetAttribute refuses more.
int mbconv_expand_dw(const void* x, const void* w_exp, const void* b_exp,
                     const void* w_dw, const void* b_dw, void* d, void* psum,
                     int B, int H, int W, int cin, int cep, int k, int s,
                     int pad_t, int pad_l, void* stream) {
  if (cep % CC != 0 || (w_exp != nullptr && cin % 8 != 0))
    return (int)cudaErrorInvalidValue;
  const int ho = H / s;
  const int wo = W / s;
  const int tiles_y = (ho + TILE - 1) / TILE;
  const int tiles_x = (wo + TILE - 1) / TILE;
  const dim3 grid(tiles_y * tiles_x, cep / CC, B);
  const size_t smem = expand_dw_smem(k, s, cin, w_exp != nullptr);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const __nv_bfloat16*>(x);
  auto we = static_cast<const __nv_bfloat16*>(w_exp);
  auto be = static_cast<const float*>(b_exp);
  auto wd = static_cast<const float*>(w_dw);
  auto bd = static_cast<const float*>(b_dw);
  auto dp = static_cast<__nv_bfloat16*>(d);
  auto ps = static_cast<float*>(psum);
  cudaError_t err;
  if (k == 3 && s == 1)
    err = launch_expand_dw<3, 1>(grid, smem, st, xp, we, be, wd, bd, dp, ps, H,
                                 W, cin, cep, ho, wo, pad_t, pad_l, tiles_x);
  else if (k == 3 && s == 2)
    err = launch_expand_dw<3, 2>(grid, smem, st, xp, we, be, wd, bd, dp, ps, H,
                                 W, cin, cep, ho, wo, pad_t, pad_l, tiles_x);
  else if (k == 5 && s == 1)
    err = launch_expand_dw<5, 1>(grid, smem, st, xp, we, be, wd, bd, dp, ps, H,
                                 W, cin, cep, ho, wo, pad_t, pad_l, tiles_x);
  else if (k == 5 && s == 2)
    err = launch_expand_dw<5, 2>(grid, smem, st, xp, we, be, wd, bd, dp, ps, H,
                                 W, cin, cep, ho, wo, pad_t, pad_l, tiles_x);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// (b)
int mbconv_se(const void* psum, const void* w_se1, const void* b_se1,
              const void* w_se2, const void* b_se2, void* gate, int B,
              int n_tiles, int cep, int cs, int hw, void* stream) {
  const int nslice = SE_THREADS / cep > 1 ? SE_THREADS / cep : 1;
  const size_t smem = ((size_t)nslice * cep + cep + cs) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        se_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  se_kernel<<<B, SE_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(psum), static_cast<const float*>(w_se1),
      static_cast<const float*>(b_se1), static_cast<const float*>(w_se2),
      static_cast<const float*>(b_se2), static_cast<float*>(gate), n_tiles,
      cep, cs, hw);
  return (int)cudaGetLastError();
}

// (c). skip is NULL when the block has no identity skip.
int mbconv_project(const void* d, const void* gate, const void* w_prj,
                   const void* b_prj, const void* skip, void* out, int M,
                   int hw, int cep, int co, void* stream) {
  if (cep % BK != 0 || co % 2 != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + BM - 1) / BM, (co + BN - 1) / BN);
  project_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(d), static_cast<const float*>(gate),
      static_cast<const __nv_bfloat16*>(w_prj),
      static_cast<const float*>(b_prj),
      static_cast<const __nv_bfloat16*>(skip),
      static_cast<__nv_bfloat16*>(out), M, hw, cep, co);
  return (int)cudaGetLastError();
}

}  // extern "C"
