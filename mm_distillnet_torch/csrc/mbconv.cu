// Eval-mode EfficientNet MBConv block with BN folded into the weights, as
// three CUDA kernels for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces mm_distillnet_tpu/ops/pallas_mbconv.py::_mbconv_kernel (launched
// by mbconv_fused). That TPU kernel keeps one whole image's block in VMEM;
// an H100 SM has 227 KB of shared memory and the SE mean crosses the whole
// image, so the block is split where the mean forces it:
//
//   (a) mbconv_expand_dw (mbconv_expand_dw.cu): per spatial tile, expand 1x1
//       on wgmma + bias + swish on the tile's input halo (recomputed, so the
//       expanded activation never goes to device memory; out-of-image halo
//       pixels are ZERO in the expanded domain, as TF-SAME pads the depthwise
//       input), rounded to bf16, then depthwise kxk (stride s) in fp32 from
//       the bias + swish. Writes the depthwise output in bf16 and per-tile
//       fp32 channel sums of the un-rounded output (no atomics).
//   (b) mbconv_se (this file): per image, reduce the tile sums in a fixed
//       order to the mean and run the two SE GEMVs -> fp32 gate per (image,
//       channel). Bound by latency: 8 CTAs, a few KB each.
//   (c) mbconv_project (mbconv_project.cu): pipelined wgmma GEMM, A =
//       bf16(depthwise out * gate) formed in registers, B = w_prj, fp32
//       sums; the epilogue adds the bias and the bf16 identity skip in fp32.
//
// Rounding points are the TPU kernel's (pallas_mbconv.py:160-226). What
// bounds (a) and (c) on this card and what their designs do about it is
// noted at the top of their files; mbconv_common.cuh holds the PTX wrappers.
//
// Layouts of (b): psum (B, T, CeP) f32, T = tiles of (a)'s plan;
//   w_se1 (Cs, CeP) f32, b_se1 (Cs); w_se2 (Cs, CeP) f32, b_se2 (CeP);
//   gate (B, CeP) f32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SE_THREADS = 1024;  // one block per image

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}
__device__ __forceinline__ float swish_f(float v) { return v * sigmoid_f(v); }

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

}  // namespace

extern "C" {

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

}  // extern "C"
