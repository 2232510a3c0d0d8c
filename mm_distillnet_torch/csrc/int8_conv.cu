// int8 x int8 -> int32 2-D convolution for Hopper (sm_90a), the card route of
// the int8 post-training-quantized forward (mm_distillnet_torch/quant.py).
// Replaces no Pallas kernel: the JAX package computes this convolution with
// XLA (mm_distillnet_tpu/quant.py:209-223, lax.conv_general_dilated with
// preferred_element_type=int32), and PyTorch has no int8 convolution on CUDA.
// It takes every quantized conv that the s8 GEMM route (torch._int_mm, for
// the 1x1 stride-1 ungrouped convs) does not: the depthwise 3x3 and 5x5 at
// stride 1 and 2, the 3x3 stride-2 stem, the BiFPN and head depthwise convs,
// and any 1x1 the GEMM refuses.
//
// What bounds it on an H100. By bytes (the int8 input read once, the int32
// output written once) a D2@768 forward's depthwise convs could run in a few
// tenths of a millisecond; the int8 tensor-core rate (1,979 TOPS) is never
// the limit at these depths (9 or 25 taps a channel). This first version is
// simple on purpose: one thread per output element (b, oh, ow, o) in a grid-
// stride loop, consecutive threads on consecutive output channels (so the
// NHWC input and output are read and written in contiguous runs), an int32
// loop over the taps x Cin/groups in the order (dy, dx, c). Padding comes as
// the amounts before the first row and column (int8 zero is the quantized
// zero, so a tap outside the input adds nothing). The sums are exact in int32
// (|acc| <= 127^2 K, the wrapper checks K), so any order gives the same bits.
// Faster designs (dp4a or wgmma s8 tiles, a fused quantize prologue) are
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void int8_conv2d_kernel(const int8_t* __restrict__ x,
                                   const int8_t* __restrict__ w,
                                   int32_t* __restrict__ out, int B, int H,
                                   int W, int cin, int ho, int wo, int cout,
                                   int kh, int kw, int sh, int sw, int pt,
                                   int pl, int groups) {
  const long long total = (long long)B * ho * wo * cout;
  const int cin_g = cin / groups;
  const int cout_g = cout / groups;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int o = (int)(i % cout);
    long long p = i / cout;
    const int ow = (int)(p % wo);
    p /= wo;
    const int oh = (int)(p % ho);
    const int b = (int)(p / ho);
    const int c0 = (o / cout_g) * cin_g;
    // OIHW: w[o][c][dy][dx]
    const int8_t* wo_ptr = w + (long long)o * cin_g * kh * kw;
    int acc = 0;
    for (int dy = 0; dy < kh; ++dy) {
      const int iy = oh * sh - pt + dy;
      if (iy < 0 || iy >= H) continue;
      for (int dx = 0; dx < kw; ++dx) {
        const int ix = ow * sw - pl + dx;
        if (ix < 0 || ix >= W) continue;
        const int8_t* xp = x + (((long long)b * H + iy) * W + ix) * cin + c0;
        const int8_t* wp = wo_ptr + dy * kw + dx;
        for (int c = 0; c < cin_g; ++c)
          acc += (int)xp[c] * (int)wp[c * kh * kw];
      }
    }
    out[i] = acc;
  }
}

}  // namespace

extern "C" {

// x (B, H, W, cin) int8 NHWC, w (cout, cin/groups, kh, kw) int8 OIHW, out
// (B, ho, wo, cout) int32 NHWC; pt / pl rows and columns of zeros before the
// input. Returns the launch's CUDA error (0 when it was accepted).
int int8_conv2d(const void* x, const void* w, void* out, int B, int H, int W,
                int cin, int ho, int wo, int cout, int kh, int kw, int sh,
                int sw, int pt, int pl, int groups, void* stream) {
  if (B < 1 || H < 1 || W < 1 || ho < 1 || wo < 1 || kh < 1 || kw < 1 ||
      sh < 1 || sw < 1 || groups < 1 || cin % groups != 0 ||
      cout % groups != 0)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * ho * wo * cout;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;  // the grid-stride loop covers the rest
  int8_conv2d_kernel<<<(unsigned)blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(out), B, H, W, cin, ho, wo, cout, kh, kw, sh, sw,
      pt, pl, groups);
  return (int)cudaGetLastError();
}

}  // extern "C"
