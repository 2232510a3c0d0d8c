// Fixed-shape greedy NMS, batched over images, as one CUDA kernel for Hopper
// (sm_90a), bound to Python through ctypes (ops/nms.py `nms_fixed`).
//
// Replaces no Pallas kernel: the JAX package writes the greedy suppression
// as a `lax.fori_loop` over the sorted rows (mm_distillnet_tpu/ops/nms.py
// `_greedy_suppress`, called by `nms_fixed`), which XLA compiles into the
// step. Run eagerly in torch that loop is three launches per candidate
// (1,578 launches a call at 512 candidates); here one launch does the whole
// of nms_fixed for every image of the batch: the stable sort of the masked
// scores, the gather of the boxes in that order, the IoU test, the greedy
// scan and the selection of the first `m` rows.
//
// What bounds it on an H100: one SM's issue and latency, not bytes (at most
// 1024 x 21 bytes in and 13 bytes out a row, an image). An image's work
// cannot spread across SMs without a trip through device memory: the K^2 / 2
// pair tests, then the greedy scan, a chain of K dependent steps, then the
// sorts. At K = 512 one call takes about 0.1 ms whatever the batch (one
// CTA an image, B <= 132 images at once), most of it in the pair tests and
// the scan's chain. The design keeps everything in shared memory and
// registers and shortens each of the three:
//
//   * One CTA per image, kThreads threads, K read from the input's shape
//     (at most kMaxK), shared memory sized from K at launch.
//   * Sorts as bitonic networks over 64-bit keys, (the order-preserving
//     bits of the negated score) << 32 | index, one key a thread in a
//     register: strides below 32 by warp shuffles, wider ones through
//     shared memory (10 barriers a sort at K = 512). The keys are distinct,
//     so any correct sort gives the stable order, ties toward the lower
//     index as torch.sort(stable=True) gives them. -0.0 counts as +0.0 and
//     NaN sorts last, as in torch.sort.
//   * The suppression matrix as bits: word w of row i holds "row i
//     suppresses row j" for j in [64w, 64w + 64), j > i, IoU(i, j) > thr;
//     a warp tests one row i against 32 rows j at once (a ballot is half a
//     word), and rows are dealt to warps in turn, so the triangle's work is
//     shared evenly. Stored word-major with a row pitch of K + 1 words, so lanes that read
//     one row's words read different banks.
//   * The greedy scan in one warp, 64 rows at a time: lane w holds word w
//     of the removed set (starting at the invalid rows); lane c runs block
//     c's rows in order against its own word (row i kept if bit i is clear,
//     then its word ORed in: register work, the row words' loads
//     independent of it), then the later lanes OR in their words of the
//     rows kept, with independent loads.
//   * The output is the second stable sort of the nms_fixed sequence (kept
//     rows' masked scores, NEG_INF elsewhere), cut to its first m rows and
//     mapped through the first sort to input indices.
//
// Every number is the torch sequence's bit for bit: the IoU rounds where
// ops/boxes.py pairwise_iou_xyxy rounds (each sub, mul, add and sub an _rn
// intrinsic, so nvcc cannot contract them into an FMA; the IEEE division by
// max(union, eps)); max, min and the clamps carry NaN as torch's do; the
// threshold, eps and NEG_INF come in as fp32, as torch rounds a Python
// scalar against an fp32 tensor.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 1024;
constexpr unsigned kFull = 0xffffffffu;
// one thread a sorted position: the sorts keep a key a thread in registers
static_assert(kMaxK <= kThreads, "a CTA holds one key a thread");

using u64 = unsigned long long;

struct Params {
  const float* boxes;         // (B, K, 4) xyxy, strides in elements
  const float* scores;        // (B, K)
  const unsigned char* valid; // (B, K) bool
  int64_t* idx;               // (B, m) input indices
  float* kscores;             // (B, m)
  unsigned char* out_valid;   // (B, m) bool
  int k, m;
  long long sb_b, sb_k, sb_c, ss_b, ss_k, sv_b, sv_k;
  float thr, eps, neg_inf, half_neg_inf;
};

__host__ __device__ constexpr size_t align16(size_t v) {
  return (v + 15) / 16 * 16;
}

// The shared memory of one CTA, from K: the sorts' two exchange buffers (P,
// the next power of two), boxes in sorted order, the suppression bits, the
// valid / kept bits, the sorted rows' masked scores, input indices and
// areas.
struct Layout {
  int p, w, ld;
  size_t buf0, buf1, boxes, mask, bits, msc, order, area, bytes;
  __host__ __device__ explicit Layout(int k) {
    p = 1;
    while (p < k) p <<= 1;
    w = (k + 63) / 64;
    ld = k + 1;
    buf0 = 0;
    buf1 = align16(buf0 + (size_t)p * 8);
    boxes = align16(buf1 + (size_t)p * 8);
    mask = align16(boxes + (size_t)k * 16);
    bits = align16(mask + (size_t)w * ld * 8);
    msc = align16(bits + (size_t)w * 8);
    order = align16(msc + (size_t)k * 4);
    area = align16(order + (size_t)k * 4);
    bytes = align16(area + (size_t)k * 4);
  }
};

// Ascending unsigned order of x's value: -0.0 as +0.0, NaN last.
__device__ __forceinline__ unsigned ascending_bits(float x) {
  if (x != x) return 0xffffffffu;
  const unsigned u = __float_as_uint(x == 0.0f ? 0.0f : x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The sort key of descending x at `index`.
__device__ __forceinline__ u64 descending_key(float x, int index) {
  return ((u64)ascending_bits(-x) << 32) | (unsigned)index;
}

// torch.maximum / torch.minimum / clamp(min=lo): NaN in, NaN out.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a) ? a : (b != b) ? b : fmaxf(a, b);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a) ? a : (b != b) ? b : fminf(a, b);
}

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// pairwise_iou_xyxy(a, b) > thr as the torch sequence decides it, the
// boxes' areas given.
__device__ __forceinline__ bool suppresses(float4 a, float area_a, float4 b,
                                           float area_b, const Params& p) {
  const float w =
      max_nan(__fsub_rn(min_nan(a.z, b.z), max_nan(a.x, b.x)), 0.0f);
  const float h =
      max_nan(__fsub_rn(min_nan(a.w, b.w), max_nan(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, max_nan(uni, p.eps)) > p.thr;
}

// Ascending bitonic sort of P keys (P a power of two), thread t holding
// position t in x (threads from P on hold ~0 and take part): strides below
// 32 exchange by shuffles; wider ones through the two buffers in turn, one
// barrier a stage. Returns thread t's sorted key.
__device__ u64 bitonic_sort(u64 x, int p, u64* buf0, u64* buf1) {
  const int t = threadIdx.x;
  int wide = 0;
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      u64 y;
      if (stride >= 32) {
        u64* buf = (wide++ & 1) ? buf1 : buf0;
        if (t < p) buf[t] = x;
        __syncthreads();
        y = t < p ? buf[t ^ stride] : x;
      } else {
        y = __shfl_xor_sync(kFull, x, stride);
      }
      const bool keep_min = ((t & size) == 0) == ((t & stride) == 0);
      x = keep_min == (x < y) ? x : y;
    }
  }
  return x;
}

__global__ void __launch_bounds__(kThreads) nms_kernel(Params a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(a.k);
  u64* buf0 = reinterpret_cast<u64*>(smem + L.buf0);
  u64* buf1 = reinterpret_cast<u64*>(smem + L.buf1);
  float4* box = reinterpret_cast<float4*>(smem + L.boxes);
  u64* mask = reinterpret_cast<u64*>(smem + L.mask);
  u64* bits = reinterpret_cast<u64*>(smem + L.bits);
  float* msc = reinterpret_cast<float*>(smem + L.msc);
  int* order = reinterpret_cast<int*>(smem + L.order);
  float* area = reinterpret_cast<float*>(smem + L.area);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32, k = a.k;
  const float* boxes = a.boxes + blockIdx.x * a.sb_b;
  const float* scores = a.scores + blockIdx.x * a.ss_b;
  const unsigned char* valid = a.valid + blockIdx.x * a.sv_b;

  // 1. the masked scores' keys, sorted: thread q holds sorted position q
  u64 key = t < k ? descending_key(valid[t * a.sv_k] ? scores[t * a.ss_k]
                                                     : a.neg_inf,
                                   t)
                  : ~0ull;
  key = bitonic_sort(key, L.p, buf0, buf1);

  // 2. boxes, their areas, masked scores and valid bits in
  // sorted order; a warp's ballot is one 32-bit half of a word of bits
  bool v = false;
  if (t < k) {
    const int i = (int)(key & 0xffffffffu);
    v = valid[i * a.sv_k] != 0;
    const float* b = boxes + i * a.sb_k;
    const float4 bq =
        make_float4(b[0], b[a.sb_c], b[2 * a.sb_c], b[3 * a.sb_c]);
    order[t] = i;
    msc[t] = v ? scores[i * a.ss_k] : a.neg_inf;
    box[t] = bq;
    area[t] = area_of(bq);
  }
  const unsigned ballot = __ballot_sync(kFull, v);
  if (lane == 0 && warp < 2 * L.w) reinterpret_cast<unsigned*>(bits)[warp] =
      ballot;
  __syncthreads();

  // 3. the suppression bits: a warp takes row i, its lanes 32 rows j at a
  // time (one test each, one ballot a half-word); half-words wholly at or
  // below the diagonal are zero without a test
  unsigned* mask32 = reinterpret_cast<unsigned*>(mask);
  for (int i = warp; i < k; i += kWarps) {
    const float4 bi = box[i];
    const float ai = area[i];
    const int first = (i + 1) / 32;
    if (lane < first) mask32[2 * ((lane / 2) * L.ld + i) + lane % 2] = 0;
    for (int h = first; h < 2 * L.w; ++h) {
      const int j = 32 * h + lane;
      const bool over =
          j > i && j < k && suppresses(bi, ai, box[j], area[j], a);
      const unsigned hits = __ballot_sync(kFull, over);
      if (lane == 0) mask32[2 * ((h / 2) * L.ld + i) + h % 2] = hits;
    }
  }
  __syncthreads();

  // 4. the greedy scan in one warp, 64 rows at a time: lane c runs the rows
  // of block c against its own word of the removed set, then every later
  // lane ORs in its words of the rows block c kept; then bits hold the
  // kept rows
  if (warp == 0) {
    u64 removed = lane < L.w ? ~bits[lane] : ~0ull;
    for (int c = 0; c < L.w; ++c) {
      const int base = 64 * c, rows = min(64, k - base);
      if (lane == c) {
        const u64* own = mask + c * L.ld + base;
        u64 bit = 1;
#pragma unroll 16
        for (int r = 0; r < 64; ++r, bit <<= 1) {
          const u64 row = r < rows ? own[r] : 0ull;
          if (!(removed & bit)) removed |= row;
        }
      }
      const u64 kept = ~__shfl_sync(kFull, removed, c);
      if (lane > c && lane < L.w) {
        const u64* col = mask + lane * L.ld + base;
        u64 hit = 0, bit = 1;
#pragma unroll 16
        for (int r = 0; r < 64; ++r, bit <<= 1)
          if (kept & bit) hit |= col[r];
        removed |= hit;
      }
    }
    if (lane < L.w) bits[lane] = ~removed;
  }
  __syncthreads();

  // 5. the kept rows' scores (NEG_INF elsewhere), sorted again: thread r
  // holds output row r
  key = t < k ? descending_key(((bits[t / 64] >> (t % 64)) & 1ull) ? msc[t]
                                                                   : a.neg_inf,
                               t)
              : ~0ull;
  key = bitonic_sort(key, L.p, buf0, buf1);

  // 6. the first m rows
  if (t < a.m) {
    const int q = (int)(key & 0xffffffffu);
    const float ks = ((bits[q / 64] >> (q % 64)) & 1ull) ? msc[q] : a.neg_inf;
    const size_t out = (size_t)blockIdx.x * a.m + t;
    a.idx[out] = order[q];
    a.kscores[out] = ks;
    a.out_valid[out] = ks > a.half_neg_inf;
  }
}

}  // namespace

extern "C" {

// boxes (B, K, 4) fp32 xyxy, scores (B, K) fp32, valid (B, K) bool, each
// with the strides given in elements; idx (B, m) int64, kscores (B, m)
// fp32, out_valid (B, m) bool contiguous, m <= K <= kMaxK. Returns the
// launch's CUDA error (0 when it was accepted).
int nms_fixed(const void* boxes, const void* scores, const void* valid,
              void* idx, void* kscores, void* out_valid, int B, int K, int m,
              long long sb_b, long long sb_k, long long sb_c, long long ss_b,
              long long ss_k, long long sv_b, long long sv_k, float thr,
              float eps, float neg_inf, float half_neg_inf, void* stream) {
  if (B < 1 || K < 0 || K > kMaxK || m < 0 || m > K)
    return (int)cudaErrorInvalidValue;
  const Params p{static_cast<const float*>(boxes),
                 static_cast<const float*>(scores),
                 static_cast<const unsigned char*>(valid),
                 static_cast<int64_t*>(idx),
                 static_cast<float*>(kscores),
                 static_cast<unsigned char*>(out_valid),
                 K, m, sb_b, sb_k, sb_c, ss_b, ss_k, sv_b, sv_k,
                 thr, eps, neg_inf, half_neg_inf};
  const size_t smem = Layout(K).bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nms_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
