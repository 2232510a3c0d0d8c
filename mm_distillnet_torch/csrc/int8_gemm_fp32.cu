// The fused 1x1 quantized conv of int8_gemm.cuh for fp32 input: one
// library per input dtype, so that nvcc builds the three in parallel.
#include "int8_gemm.cuh"

extern "C" int quantized_conv1x1(const void* x, const void* w_pack,
                                 const void* ascale, const void* wscale,
                                 const void* bias, void* out, const int* args,
                                 int n, void* stream) {
  return int8gemm::quantized_conv1x1<float>(x, w_pack, ascale, wscale, bias, out,
                                          args, n, stream);
}
