// Device helpers shared by the Hopper (sm_90a) kernels: mbarrier and
// named barriers, bulk and 16-byte asynchronous copies, cluster barriers and
// distributed shared memory, programmatic dependent launch, ldmatrix, and
// wgmma (bf16, and s8 for the int8 GEMM) with its shared-memory
// descriptors. Thin wrappers of PTX; no policy
// here. Host helpers: the per-device dynamic shared memory limit, and the
// driver's tensor-map encoder for the TMA copies.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mbconv {

constexpr int MAX_SMEM = 232448;  // dynamic shared memory one block may use
constexpr int MAX_DEVICES = 64;   // cards one process may launch on

// Raises `kern`'s dynamic shared memory limit on the current device to
// `smem` where `allowed` (the launcher's record, one entry per device) says
// it is lower: cudaFuncSetAttribute holds for the current device only.
template <typename Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kern, int (&allowed)[MAX_DEVICES],
                                      int smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem > allowed[dev]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed[dev] = smem;
  }
  return cudaSuccess;
}

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// swish with the fast exponential and division: their error (a few fp32
// ulp) is far below the bf16 rounding that follows every use here
__device__ __forceinline__ float swish_f(float v) {
  return v * __fdividef(1.0f, 1.0f + __expf(-v));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier -------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// barrier `id` (1-15) among `threads` threads of the block
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// The spin is inside the asm: a loop the compiler sees would make what
// follows a divergent path to it, and it serialises wgmma there.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// ---- asynchronous copies --------------------------------------------------
// `bytes` contiguous bytes global -> shared by the copy engine; completion
// is counted on the mbarrier. Addresses and size are multiples of 16.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// 16 bytes global -> shared; with valid == false the 16 bytes are zeros and
// nothing is read
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// makes shared-memory writes of ordinary stores and cp.async visible to the
// asynchronous proxy (wgmma operands, bulk copies)
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- the tensor memory accelerator (TMA) ----------------------------------
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime so that the library
// needs no -lcuda; null where the driver lacks it
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A box of a 2- or 3-D tensor map at the coordinates given (innermost
// first; out of bounds reads as zeros) into shared memory at `dst`,
// completion counted on the mbarrier `bar` by its bytes.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// ---- thread-block clusters ------------------------------------------------
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_nctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
// The cluster's barrier, split in two: every thread of every CTA arrives and
// later waits. Stores made before the arrive, into any CTA's shared memory,
// are visible to every thread after its wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the address of this CTA's shared-memory location `addr` in CTA `rank` of
// the cluster (distributed shared memory)
__device__ __forceinline__ uint32_t map_shared_rank(uint32_t addr,
                                                    uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void st_shared_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

// ---- programmatic dependent launch ----------------------------------------
// In a kernel launched with programmatic stream serialization: waits until
// the kernel before it in the stream has ended and its stores are visible.
// Without that attribute it returns at once.
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
// Lets the next kernel in the stream, if it was launched with programmatic
// stream serialization, start once every CTA of this grid has come here or
// ended; what it runs before its own griddep_wait overlaps this grid.
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// ---- ldmatrix -------------------------------------------------------------
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// ---- wgmma ----------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Descriptor of a K-major bf16 operand without swizzle: 8 rows x 8 values
// (16 bytes a row) form one contiguous 128-byte core matrix; `k_stride` is
// the byte distance between core matrices that are neighbours along K,
// `mn_stride` between neighbours along M (or N).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t k_stride,
                                               uint32_t mn_stride) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(k_stride >> 4) << 16) |
         ((uint64_t)(mn_stride >> 4) << 32);
}
// byte offset of value (row, k) in such an operand whose core matrices lie
// K-fastest: k_stride = 128, mn_stride = kpad * 16
__host__ __device__ constexpr int core_offset(int row, int k, int kpad) {
  return (row / 8) * kpad * 16 + (k / 8) * 128 + (row % 8) * 16 + (k % 8) * 2;
}

// D[64 x 48] (+)= A[64 x 16] * B[16 x 48], A and B from shared memory
// (K-major descriptors), fp32 sums in c[24]; scale_d = 0 starts a new sum.
__device__ __forceinline__ void wgmma_ss_n48(float (&c)[24], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]),
        "+f"(c[4]), "+f"(c[5]), "+f"(c[6]), "+f"(c[7]),
        "+f"(c[8]), "+f"(c[9]), "+f"(c[10]), "+f"(c[11]),
        "+f"(c[12]), "+f"(c[13]), "+f"(c[14]), "+f"(c[15]),
        "+f"(c[16]), "+f"(c[17]), "+f"(c[18]), "+f"(c[19]),
        "+f"(c[20]), "+f"(c[21]), "+f"(c[22]), "+f"(c[23])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x N] += A[64 x 16] * B[16 x N], A from registers (the m16n8k16 A
// fragment of each warp), B from shared memory, fp32 sums in c[N / 2].
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&c)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&c)[8], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      :
        "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]),
        "+f"(c[4]), "+f"(c[5]), "+f"(c[6]), "+f"(c[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&c)[16], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      :
        "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]),
        "+f"(c[4]), "+f"(c[5]), "+f"(c[6]), "+f"(c[7]),
        "+f"(c[8]), "+f"(c[9]), "+f"(c[10]), "+f"(c[11]),
        "+f"(c[12]), "+f"(c[13]), "+f"(c[14]), "+f"(c[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&c)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      :
        "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]),
        "+f"(c[4]), "+f"(c[5]), "+f"(c[6]), "+f"(c[7]),
        "+f"(c[8]), "+f"(c[9]), "+f"(c[10]), "+f"(c[11]),
        "+f"(c[12]), "+f"(c[13]), "+f"(c[14]), "+f"(c[15]),
        "+f"(c[16]), "+f"(c[17]), "+f"(c[18]), "+f"(c[19]),
        "+f"(c[20]), "+f"(c[21]), "+f"(c[22]), "+f"(c[23]),
        "+f"(c[24]), "+f"(c[25]), "+f"(c[26]), "+f"(c[27]),
        "+f"(c[28]), "+f"(c[29]), "+f"(c[30]), "+f"(c[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&c)[48], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      :
        "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]),
        "+f"(c[4]), "+f"(c[5]), "+f"(c[6]), "+f"(c[7]),
        "+f"(c[8]), "+f"(c[9]), "+f"(c[10]), "+f"(c[11]),
        "+f"(c[12]), "+f"(c[13]), "+f"(c[14]), "+f"(c[15]),
        "+f"(c[16]), "+f"(c[17]), "+f"(c[18]), "+f"(c[19]),
        "+f"(c[20]), "+f"(c[21]), "+f"(c[22]), "+f"(c[23]),
        "+f"(c[24]), "+f"(c[25]), "+f"(c[26]), "+f"(c[27]),
        "+f"(c[28]), "+f"(c[29]), "+f"(c[30]), "+f"(c[31]),
        "+f"(c[32]), "+f"(c[33]), "+f"(c[34]), "+f"(c[35]),
        "+f"(c[36]), "+f"(c[37]), "+f"(c[38]), "+f"(c[39]),
        "+f"(c[40]), "+f"(c[41]), "+f"(c[42]), "+f"(c[43]),
        "+f"(c[44]), "+f"(c[45]), "+f"(c[46]), "+f"(c[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&c)[64], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      :
        "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]),
        "+f"(c[4]), "+f"(c[5]), "+f"(c[6]), "+f"(c[7]),
        "+f"(c[8]), "+f"(c[9]), "+f"(c[10]), "+f"(c[11]),
        "+f"(c[12]), "+f"(c[13]), "+f"(c[14]), "+f"(c[15]),
        "+f"(c[16]), "+f"(c[17]), "+f"(c[18]), "+f"(c[19]),
        "+f"(c[20]), "+f"(c[21]), "+f"(c[22]), "+f"(c[23]),
        "+f"(c[24]), "+f"(c[25]), "+f"(c[26]), "+f"(c[27]),
        "+f"(c[28]), "+f"(c[29]), "+f"(c[30]), "+f"(c[31]),
        "+f"(c[32]), "+f"(c[33]), "+f"(c[34]), "+f"(c[35]),
        "+f"(c[36]), "+f"(c[37]), "+f"(c[38]), "+f"(c[39]),
        "+f"(c[40]), "+f"(c[41]), "+f"(c[42]), "+f"(c[43]),
        "+f"(c[44]), "+f"(c[45]), "+f"(c[46]), "+f"(c[47]),
        "+f"(c[48]), "+f"(c[49]), "+f"(c[50]), "+f"(c[51]),
        "+f"(c[52]), "+f"(c[53]), "+f"(c[54]), "+f"(c[55]),
        "+f"(c[56]), "+f"(c[57]), "+f"(c[58]), "+f"(c[59]),
        "+f"(c[60]), "+f"(c[61]), "+f"(c[62]), "+f"(c[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&c)[96], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      :
        "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]),
        "+f"(c[4]), "+f"(c[5]), "+f"(c[6]), "+f"(c[7]),
        "+f"(c[8]), "+f"(c[9]), "+f"(c[10]), "+f"(c[11]),
        "+f"(c[12]), "+f"(c[13]), "+f"(c[14]), "+f"(c[15]),
        "+f"(c[16]), "+f"(c[17]), "+f"(c[18]), "+f"(c[19]),
        "+f"(c[20]), "+f"(c[21]), "+f"(c[22]), "+f"(c[23]),
        "+f"(c[24]), "+f"(c[25]), "+f"(c[26]), "+f"(c[27]),
        "+f"(c[28]), "+f"(c[29]), "+f"(c[30]), "+f"(c[31]),
        "+f"(c[32]), "+f"(c[33]), "+f"(c[34]), "+f"(c[35]),
        "+f"(c[36]), "+f"(c[37]), "+f"(c[38]), "+f"(c[39]),
        "+f"(c[40]), "+f"(c[41]), "+f"(c[42]), "+f"(c[43]),
        "+f"(c[44]), "+f"(c[45]), "+f"(c[46]), "+f"(c[47]),
        "+f"(c[48]), "+f"(c[49]), "+f"(c[50]), "+f"(c[51]),
        "+f"(c[52]), "+f"(c[53]), "+f"(c[54]), "+f"(c[55]),
        "+f"(c[56]), "+f"(c[57]), "+f"(c[58]), "+f"(c[59]),
        "+f"(c[60]), "+f"(c[61]), "+f"(c[62]), "+f"(c[63]),
        "+f"(c[64]), "+f"(c[65]), "+f"(c[66]), "+f"(c[67]),
        "+f"(c[68]), "+f"(c[69]), "+f"(c[70]), "+f"(c[71]),
        "+f"(c[72]), "+f"(c[73]), "+f"(c[74]), "+f"(c[75]),
        "+f"(c[76]), "+f"(c[77]), "+f"(c[78]), "+f"(c[79]),
        "+f"(c[80]), "+f"(c[81]), "+f"(c[82]), "+f"(c[83]),
        "+f"(c[84]), "+f"(c[85]), "+f"(c[86]), "+f"(c[87]),
        "+f"(c[88]), "+f"(c[89]), "+f"(c[90]), "+f"(c[91]),
        "+f"(c[92]), "+f"(c[93]), "+f"(c[94]), "+f"(c[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&c)[128], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      :
        "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]),
        "+f"(c[4]), "+f"(c[5]), "+f"(c[6]), "+f"(c[7]),
        "+f"(c[8]), "+f"(c[9]), "+f"(c[10]), "+f"(c[11]),
        "+f"(c[12]), "+f"(c[13]), "+f"(c[14]), "+f"(c[15]),
        "+f"(c[16]), "+f"(c[17]), "+f"(c[18]), "+f"(c[19]),
        "+f"(c[20]), "+f"(c[21]), "+f"(c[22]), "+f"(c[23]),
        "+f"(c[24]), "+f"(c[25]), "+f"(c[26]), "+f"(c[27]),
        "+f"(c[28]), "+f"(c[29]), "+f"(c[30]), "+f"(c[31]),
        "+f"(c[32]), "+f"(c[33]), "+f"(c[34]), "+f"(c[35]),
        "+f"(c[36]), "+f"(c[37]), "+f"(c[38]), "+f"(c[39]),
        "+f"(c[40]), "+f"(c[41]), "+f"(c[42]), "+f"(c[43]),
        "+f"(c[44]), "+f"(c[45]), "+f"(c[46]), "+f"(c[47]),
        "+f"(c[48]), "+f"(c[49]), "+f"(c[50]), "+f"(c[51]),
        "+f"(c[52]), "+f"(c[53]), "+f"(c[54]), "+f"(c[55]),
        "+f"(c[56]), "+f"(c[57]), "+f"(c[58]), "+f"(c[59]),
        "+f"(c[60]), "+f"(c[61]), "+f"(c[62]), "+f"(c[63]),
        "+f"(c[64]), "+f"(c[65]), "+f"(c[66]), "+f"(c[67]),
        "+f"(c[68]), "+f"(c[69]), "+f"(c[70]), "+f"(c[71]),
        "+f"(c[72]), "+f"(c[73]), "+f"(c[74]), "+f"(c[75]),
        "+f"(c[76]), "+f"(c[77]), "+f"(c[78]), "+f"(c[79]),
        "+f"(c[80]), "+f"(c[81]), "+f"(c[82]), "+f"(c[83]),
        "+f"(c[84]), "+f"(c[85]), "+f"(c[86]), "+f"(c[87]),
        "+f"(c[88]), "+f"(c[89]), "+f"(c[90]), "+f"(c[91]),
        "+f"(c[92]), "+f"(c[93]), "+f"(c[94]), "+f"(c[95]),
        "+f"(c[96]), "+f"(c[97]), "+f"(c[98]), "+f"(c[99]),
        "+f"(c[100]), "+f"(c[101]), "+f"(c[102]), "+f"(c[103]),
        "+f"(c[104]), "+f"(c[105]), "+f"(c[106]), "+f"(c[107]),
        "+f"(c[108]), "+f"(c[109]), "+f"(c[110]), "+f"(c[111]),
        "+f"(c[112]), "+f"(c[113]), "+f"(c[114]), "+f"(c[115]),
        "+f"(c[116]), "+f"(c[117]), "+f"(c[118]), "+f"(c[119]),
        "+f"(c[120]), "+f"(c[121]), "+f"(c[122]), "+f"(c[123]),
        "+f"(c[124]), "+f"(c[125]), "+f"(c[126]), "+f"(c[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x N] (+)= A[64 x 32] * B[32 x N] in int8 with exact int32 sums, A
// from registers (each warp's 16 rows as the m16n8k32 s8 A fragment: a[0]
// row g bytes 4q-4q+3, a[1] row g + 8, a[2] and a[3] the same rows at k +
// 16), B K-major from shared memory (8 x 16-byte core matrices); sums in
// c[N / 2] in the fp32 accumulator layout. scale_d = 0 starts a new sum.
template <int N>
__device__ __forceinline__ void wgmma_s8_rs(int (&c)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8_rs<16>(int (&c)[8],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p;\n}\n"
      :
        "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3]),
        "+r"(c[4]), "+r"(c[5]), "+r"(c[6]), "+r"(c[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8_rs<32>(int (&c)[16],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n}\n"
      :
        "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3]),
        "+r"(c[4]), "+r"(c[5]), "+r"(c[6]), "+r"(c[7]),
        "+r"(c[8]), "+r"(c[9]), "+r"(c[10]), "+r"(c[11]),
        "+r"(c[12]), "+r"(c[13]), "+r"(c[14]), "+r"(c[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8_rs<64>(int (&c)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      :
        "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3]),
        "+r"(c[4]), "+r"(c[5]), "+r"(c[6]), "+r"(c[7]),
        "+r"(c[8]), "+r"(c[9]), "+r"(c[10]), "+r"(c[11]),
        "+r"(c[12]), "+r"(c[13]), "+r"(c[14]), "+r"(c[15]),
        "+r"(c[16]), "+r"(c[17]), "+r"(c[18]), "+r"(c[19]),
        "+r"(c[20]), "+r"(c[21]), "+r"(c[22]), "+r"(c[23]),
        "+r"(c[24]), "+r"(c[25]), "+r"(c[26]), "+r"(c[27]),
        "+r"(c[28]), "+r"(c[29]), "+r"(c[30]), "+r"(c[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8_rs<96>(int (&c)[48],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p;\n}\n"
      :
        "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3]),
        "+r"(c[4]), "+r"(c[5]), "+r"(c[6]), "+r"(c[7]),
        "+r"(c[8]), "+r"(c[9]), "+r"(c[10]), "+r"(c[11]),
        "+r"(c[12]), "+r"(c[13]), "+r"(c[14]), "+r"(c[15]),
        "+r"(c[16]), "+r"(c[17]), "+r"(c[18]), "+r"(c[19]),
        "+r"(c[20]), "+r"(c[21]), "+r"(c[22]), "+r"(c[23]),
        "+r"(c[24]), "+r"(c[25]), "+r"(c[26]), "+r"(c[27]),
        "+r"(c[28]), "+r"(c[29]), "+r"(c[30]), "+r"(c[31]),
        "+r"(c[32]), "+r"(c[33]), "+r"(c[34]), "+r"(c[35]),
        "+r"(c[36]), "+r"(c[37]), "+r"(c[38]), "+r"(c[39]),
        "+r"(c[40]), "+r"(c[41]), "+r"(c[42]), "+r"(c[43]),
        "+r"(c[44]), "+r"(c[45]), "+r"(c[46]), "+r"(c[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8_rs<128>(int (&c)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      :
        "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3]),
        "+r"(c[4]), "+r"(c[5]), "+r"(c[6]), "+r"(c[7]),
        "+r"(c[8]), "+r"(c[9]), "+r"(c[10]), "+r"(c[11]),
        "+r"(c[12]), "+r"(c[13]), "+r"(c[14]), "+r"(c[15]),
        "+r"(c[16]), "+r"(c[17]), "+r"(c[18]), "+r"(c[19]),
        "+r"(c[20]), "+r"(c[21]), "+r"(c[22]), "+r"(c[23]),
        "+r"(c[24]), "+r"(c[25]), "+r"(c[26]), "+r"(c[27]),
        "+r"(c[28]), "+r"(c[29]), "+r"(c[30]), "+r"(c[31]),
        "+r"(c[32]), "+r"(c[33]), "+r"(c[34]), "+r"(c[35]),
        "+r"(c[36]), "+r"(c[37]), "+r"(c[38]), "+r"(c[39]),
        "+r"(c[40]), "+r"(c[41]), "+r"(c[42]), "+r"(c[43]),
        "+r"(c[44]), "+r"(c[45]), "+r"(c[46]), "+r"(c[47]),
        "+r"(c[48]), "+r"(c[49]), "+r"(c[50]), "+r"(c[51]),
        "+r"(c[52]), "+r"(c[53]), "+r"(c[54]), "+r"(c[55]),
        "+r"(c[56]), "+r"(c[57]), "+r"(c[58]), "+r"(c[59]),
        "+r"(c[60]), "+r"(c[61]), "+r"(c[62]), "+r"(c[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8_rs<192>(int (&c)[96],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p;\n}\n"
      :
        "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3]),
        "+r"(c[4]), "+r"(c[5]), "+r"(c[6]), "+r"(c[7]),
        "+r"(c[8]), "+r"(c[9]), "+r"(c[10]), "+r"(c[11]),
        "+r"(c[12]), "+r"(c[13]), "+r"(c[14]), "+r"(c[15]),
        "+r"(c[16]), "+r"(c[17]), "+r"(c[18]), "+r"(c[19]),
        "+r"(c[20]), "+r"(c[21]), "+r"(c[22]), "+r"(c[23]),
        "+r"(c[24]), "+r"(c[25]), "+r"(c[26]), "+r"(c[27]),
        "+r"(c[28]), "+r"(c[29]), "+r"(c[30]), "+r"(c[31]),
        "+r"(c[32]), "+r"(c[33]), "+r"(c[34]), "+r"(c[35]),
        "+r"(c[36]), "+r"(c[37]), "+r"(c[38]), "+r"(c[39]),
        "+r"(c[40]), "+r"(c[41]), "+r"(c[42]), "+r"(c[43]),
        "+r"(c[44]), "+r"(c[45]), "+r"(c[46]), "+r"(c[47]),
        "+r"(c[48]), "+r"(c[49]), "+r"(c[50]), "+r"(c[51]),
        "+r"(c[52]), "+r"(c[53]), "+r"(c[54]), "+r"(c[55]),
        "+r"(c[56]), "+r"(c[57]), "+r"(c[58]), "+r"(c[59]),
        "+r"(c[60]), "+r"(c[61]), "+r"(c[62]), "+r"(c[63]),
        "+r"(c[64]), "+r"(c[65]), "+r"(c[66]), "+r"(c[67]),
        "+r"(c[68]), "+r"(c[69]), "+r"(c[70]), "+r"(c[71]),
        "+r"(c[72]), "+r"(c[73]), "+r"(c[74]), "+r"(c[75]),
        "+r"(c[76]), "+r"(c[77]), "+r"(c[78]), "+r"(c[79]),
        "+r"(c[80]), "+r"(c[81]), "+r"(c[82]), "+r"(c[83]),
        "+r"(c[84]), "+r"(c[85]), "+r"(c[86]), "+r"(c[87]),
        "+r"(c[88]), "+r"(c[89]), "+r"(c[90]), "+r"(c[91]),
        "+r"(c[92]), "+r"(c[93]), "+r"(c[94]), "+r"(c[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8_rs<256>(int (&c)[128],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p;\n}\n"
      :
        "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3]),
        "+r"(c[4]), "+r"(c[5]), "+r"(c[6]), "+r"(c[7]),
        "+r"(c[8]), "+r"(c[9]), "+r"(c[10]), "+r"(c[11]),
        "+r"(c[12]), "+r"(c[13]), "+r"(c[14]), "+r"(c[15]),
        "+r"(c[16]), "+r"(c[17]), "+r"(c[18]), "+r"(c[19]),
        "+r"(c[20]), "+r"(c[21]), "+r"(c[22]), "+r"(c[23]),
        "+r"(c[24]), "+r"(c[25]), "+r"(c[26]), "+r"(c[27]),
        "+r"(c[28]), "+r"(c[29]), "+r"(c[30]), "+r"(c[31]),
        "+r"(c[32]), "+r"(c[33]), "+r"(c[34]), "+r"(c[35]),
        "+r"(c[36]), "+r"(c[37]), "+r"(c[38]), "+r"(c[39]),
        "+r"(c[40]), "+r"(c[41]), "+r"(c[42]), "+r"(c[43]),
        "+r"(c[44]), "+r"(c[45]), "+r"(c[46]), "+r"(c[47]),
        "+r"(c[48]), "+r"(c[49]), "+r"(c[50]), "+r"(c[51]),
        "+r"(c[52]), "+r"(c[53]), "+r"(c[54]), "+r"(c[55]),
        "+r"(c[56]), "+r"(c[57]), "+r"(c[58]), "+r"(c[59]),
        "+r"(c[60]), "+r"(c[61]), "+r"(c[62]), "+r"(c[63]),
        "+r"(c[64]), "+r"(c[65]), "+r"(c[66]), "+r"(c[67]),
        "+r"(c[68]), "+r"(c[69]), "+r"(c[70]), "+r"(c[71]),
        "+r"(c[72]), "+r"(c[73]), "+r"(c[74]), "+r"(c[75]),
        "+r"(c[76]), "+r"(c[77]), "+r"(c[78]), "+r"(c[79]),
        "+r"(c[80]), "+r"(c[81]), "+r"(c[82]), "+r"(c[83]),
        "+r"(c[84]), "+r"(c[85]), "+r"(c[86]), "+r"(c[87]),
        "+r"(c[88]), "+r"(c[89]), "+r"(c[90]), "+r"(c[91]),
        "+r"(c[92]), "+r"(c[93]), "+r"(c[94]), "+r"(c[95]),
        "+r"(c[96]), "+r"(c[97]), "+r"(c[98]), "+r"(c[99]),
        "+r"(c[100]), "+r"(c[101]), "+r"(c[102]), "+r"(c[103]),
        "+r"(c[104]), "+r"(c[105]), "+r"(c[106]), "+r"(c[107]),
        "+r"(c[108]), "+r"(c[109]), "+r"(c[110]), "+r"(c[111]),
        "+r"(c[112]), "+r"(c[113]), "+r"(c[114]), "+r"(c[115]),
        "+r"(c[116]), "+r"(c[117]), "+r"(c[118]), "+r"(c[119]),
        "+r"(c[120]), "+r"(c[121]), "+r"(c[122]), "+r"(c[123]),
        "+r"(c[124]), "+r"(c[125]), "+r"(c[126]), "+r"(c[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

}  // namespace mbconv
