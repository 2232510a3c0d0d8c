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
//       channel).
//   (c) mbconv_project (mbconv_project.cu): pipelined wgmma GEMM, A =
//       bf16(depthwise out * gate) formed in registers, B = w_prj, fp32
//       sums; the epilogue adds the bias and the bf16 identity skip in fp32.
//
// Rounding points are the TPU kernel's (pallas_mbconv.py:160-226). What
// bounds (a) and (c) on this card and what their designs do about it is
// noted at the top of their files; mbconv_common.cuh holds the PTX wrappers.
//
// What bounds (b) on an H100: latency. Its bytes (tile sums of at most 221 KB
// an image, weights of at most 1.5 MB) would take 0.1-0.6 us at the card's
// memory rate; a kernel of one CTA per image spends 5-24 us on them, in a
// chain of dependent round trips to device memory (tile sums, then w_se1,
// then w_se2) through 8 of 132 SMs. The design shortens the chain and widens
// the path:
//
//   * A thread-block cluster per image (1, 2, 4 or 8 CTAs; `se_plan` in
//     ops/fused_mbconv.py chooses by shape). On wide blocks each CTA of the
//     cluster owns a slice of the channels: it reduces its slice of the tile
//     sums to the mean, forms its part of the Cs sums of the first GEMV, and
//     stores that part into the shared memory of every CTA of the cluster
//     (distributed shared memory). After the cluster's barrier every CTA adds
//     the parts in rank order, so all CTAs hold bit-equal s1 and two launches
//     give bit-equal gates; then it computes the gates of its own slice. On
//     narrow blocks with many tiles the tiles are split over the CTAs instead
//     and the CeP partial channel sums are exchanged the same way. A CTA reads
//     its share of the tile sums with every load in flight at once, and (on
//     wide blocks) 1/8 of the weights.
//   * Programmatic dependent launch. The kernel is launched with programmatic
//     stream serialization and (a) lets its dependents start early, so the
//     CTAs of (b) come up while (a) drains: before griddep_wait() a CTA
//     copies its slice of w_se1 and w_se2 into shared memory (one bulk copy
//     onto an mbarrier: fold time lays each CTA's columns out as one record,
//     because a copy per matrix row, 176 of them on the widest block, kept
//     the copy engine busy for longer than everything else took) and its
//     biases; after it only the tile sums are left
//     to read. The mbarrier is awaited just before the first GEMV.
//   * No CTA reads another's shared memory: parts are pushed before the
//     barrier, so a CTA may end as soon as it has passed it.
//
// Layouts of (b): psum (B, T, CeP) f32, T = tiles of (a)'s plan;
//   w_se1 (Cs, CeP) f32, b_se1 (Cs); w_se2 (Cs, CeP) f32, b_se2 (CeP);
//   gate (B, CeP) f32. CeP is a multiple of 16.

#include "mbconv_common.cuh"

namespace {

using namespace mbconv;

constexpr int SE_MAX_THREADS = 1024;

__device__ __forceinline__ float se_sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}
__device__ __forceinline__ float se_swish(float v) { return v * se_sigmoid(v); }

// Shared memory of one CTA, in floats; the same in every CTA of a launch, so
// that a CTA knows where its parts go in the others. Mirrored by
// ops/fused_mbconv.py `se_smem_bytes`.
struct SeLayout {
  int ldw;   // channels per staged weight row (also of m and b2)
  int pw;    // floats that a CTA sends to every CTA
  int w1, w2, red, part, m, b2, b1, s1, total;
};
__host__ __device__ inline SeLayout se_layout(int cep, int cs, int ranks,
                                              int split_tiles, int per_rank,
                                              int threads) {
  SeLayout l;
  l.ldw = split_tiles ? cep : per_rank;
  l.pw = split_tiles ? cep : cs;
  int at = 4;  // the mbarrier
  l.w1 = at;
  at += cs * l.ldw;
  l.w2 = at;
  at += cs * l.ldw;
  l.red = at;  // one float4 per thread
  at += threads * 4;
  l.part = at;
  at += round_up(ranks * l.pw, 4);
  l.m = at;
  at += l.ldw;
  l.b2 = at;
  at += l.ldw;
  l.b1 = at;
  at += round_up(cs, 4);
  l.s1 = at;
  at += round_up(cs, 4);
  l.total = at;
  return l;
}

// split_tiles == 0: CTA `rank` of an image's cluster owns the channels
// [rank * per_rank, ...) (per_rank a multiple of 4); split_tiles == 1: it
// owns the tiles [rank * per_rank, ...) for the reduction and an equal share
// of the channels for the gates. se_pack, where given (8 CTAs that split the
// channels), holds for each rank its columns of w_se1 and then of w_se2 as
// one contiguous record of 2 x Cs x per_rank floats, zero padded.
__global__ void __launch_bounds__(SE_MAX_THREADS)
se_kernel(const float* psum, const float* __restrict__ w_se1,
          const float* __restrict__ b_se1, const float* __restrict__ w_se2,
          const float* __restrict__ b_se2, const float* __restrict__ se_pack,
          float* __restrict__ gate, int n_tiles, int cep, int cs, int hw,
          int split_tiles, int per_rank) {
  extern __shared__ __align__(16) float sm[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarp = nt >> 5;
  const int ranks = (int)cluster_nctarank();
  const int rank = (int)cluster_ctarank();
  const int b = blockIdx.x / ranks;
  const SeLayout L = se_layout(cep, cs, ranks, split_tiles, per_rank, nt);
  float* w1s = sm + L.w1;
  float* w2s = sm + L.w2;
  float* red = sm + L.red;
  float* part = sm + L.part;
  float* m = sm + L.m;
  float* s1 = sm + L.s1;
  const uint32_t bar = smem_addr(sm);

  griddep_launch_dependents();
  cluster_arrive();  // "this CTA runs": awaited before the first remote store
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // the channels whose gates this CTA writes (c0, cn), whose weights it
  // stages (w0, wn) and whose tile sums it reduces (r0, rn); its tiles
  int c0, cn, w0, wn, r0, rn, t0, tn;
  if (split_tiles) {
    const int per = (cep + ranks - 1) / ranks;
    c0 = min(rank * per, cep);
    cn = min(per, cep - c0);
    w0 = 0;
    wn = cep;
    r0 = 0;
    rn = cep;
    t0 = min(rank * per_rank, n_tiles);
    tn = min(per_rank, n_tiles - t0);
  } else {
    c0 = min(rank * per_rank, cep);
    cn = min(per_rank, cep - c0);
    w0 = c0;
    wn = cn;
    r0 = c0;
    rn = cn;
    t0 = 0;
    tn = n_tiles;
  }
  const int woff = c0 - w0;  // of this CTA's first gate in a staged row

  // ---- before the tile sums exist: weights and biases
  if (warp == 0 && wn > 0) {
    const uint32_t row_bytes = (se_pack != nullptr ? per_rank : wn) * 4;
    if (lane == 0) mbar_expect_tx(bar, 2 * cs * row_bytes);
    __syncwarp();
    if (se_pack != nullptr) {  // this CTA's record of the fold-time pack
      if (lane == 0)
        bulk_load(smem_addr(w1s), se_pack + (size_t)rank * 2 * cs * per_rank,
                  2 * cs * row_bytes, bar);
    } else if (wn == cep) {  // whole matrices: one piece each
      if (lane < 2)
        bulk_load(smem_addr(lane ? w2s : w1s), lane ? w_se2 : w_se1,
                  cs * row_bytes, bar);
    } else {          // a slice of every row
      for (int r = lane; r < 2 * cs; r += 32) {
        const int j = r < cs ? r : r - cs;
        bulk_load(smem_addr((r < cs ? w1s : w2s) + j * L.ldw),
                  (r < cs ? w_se1 : w_se2) + (size_t)j * cep + w0, row_bytes,
                  bar);
      }
    }
  }
  for (int j = tid; j < cs; j += nt) sm[L.b1 + j] = b_se1[j];
  for (int c = tid; c < cn; c += nt) sm[L.b2 + c] = b_se2[c0 + c];

  griddep_wait();

  // ---- tile sums -> channel sums of this CTA's tiles and channels, in a
  // fixed order. Thread (g, v) adds the tiles g, g + G, ... of the four
  // channels 4v..4v+3, its loads all in flight (they bypass L1: the sums were
  // written while this CTA was already running).
  const int V = rn / 4;
  const int G = V > 0 ? max(1, min(tn, nt / V)) : 1;
  if (V > 0 && tid < G * V) {
    const int g = tid / V;
    const int v = tid - g * V;
    const int ld4 = cep / 4;
    const float4* src =
        reinterpret_cast<const float4*>(
            psum + ((size_t)b * n_tiles + t0) * cep + r0) + v;
    float4 a[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) a[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    int t = g;
    for (; t + 3 * G < tn; t += 4 * G) {
      float4 x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) x[u] = __ldcg(src + (size_t)(t + u * G) * ld4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a[u].x += x[u].x;
        a[u].y += x[u].y;
        a[u].z += x[u].z;
        a[u].w += x[u].w;
      }
    }
    float4 x[3];
#pragma unroll
    for (int u = 0; u < 3; ++u)
      x[u] = t + u * G < tn ? __ldcg(src + (size_t)(t + u * G) * ld4)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      if (t + u * G < tn) {
        a[0].x += x[u].x;
        a[0].y += x[u].y;
        a[0].z += x[u].z;
        a[0].w += x[u].w;
      }
    }
    reinterpret_cast<float4*>(red)[tid] =
        make_float4((a[0].x + a[1].x) + (a[2].x + a[3].x),
                    (a[0].y + a[1].y) + (a[2].y + a[3].y),
                    (a[0].z + a[1].z) + (a[2].z + a[3].z),
                    (a[0].w + a[1].w) + (a[2].w + a[3].w));
  }
  __syncthreads();

  // the G group sums of a channel -> one sum: P lanes each add every P-th
  // group in order, then a butterfly over the P lanes. `emit(c, sum)` runs in
  // the lane with p == 0.
  int P = 1;
  while (P < 32 && rn * P * 2 <= nt && P * 2 <= G) P *= 2;
  auto channel_sums = [&](auto emit) {
    for (int i = tid; i < round_up(rn * P, 32); i += nt) {
      const int c = i / P;
      const int p = i - c * P;
      float s = 0.0f;
      if (c < rn)
        for (int g = p; g < G; g += P) s += red[g * rn + c];
      for (int off = P >> 1; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (c < rn && p == 0) emit(c, s);
    }
  };
  // value `v` into slot `slot` of this CTA's row of `part` in every CTA
  const uint32_t part_a = smem_addr(part + rank * L.pw);
  auto push = [&](int slot, float v) {
    for (int q = 0; q < ranks; ++q)
      st_shared_cluster(map_shared_rank(part_a + slot * 4, q), v);
  };
  // s1 partials: the dot products of m[0..n) with the staged rows of w_se1,
  // a warp per squeezed channel, four of them at a time. `emit(j, dot)` runs
  // in lane 0.
  auto reduce_gemv = [&](int n, auto emit) {
    for (int jb = warp; jb < cs; jb += 4 * nwarp) {
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
      for (int c = lane; c < n; c += 32) {
        const float mv = m[c];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = jb + u * nwarp;
          if (j < cs) s[u] = fmaf(mv, w1s[j * L.ldw + c], s[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
        const int j = jb + u * nwarp;
        if (lane == 0 && j < cs) emit(j, s[u]);
      }
    }
  };

  if (split_tiles) {
    // exchange the CeP partial channel sums, then every CTA has the mean
    cluster_wait();
    channel_sums([&](int c, float s) { push(c, s); });
    cluster_arrive();
    cluster_wait();
    for (int c = tid; c < cep; c += nt) {
      float s = 0.0f;
      for (int q = 0; q < ranks; ++q) s += part[q * L.pw + c];
      m[c] = s / (float)hw;
    }
    __syncthreads();
    if (wn > 0) mbar_wait(bar, 0);
    reduce_gemv(cep, [&](int j, float s) {
      s1[j] = se_swish(s + sm[L.b1 + j]);
    });
  } else {
    // the mean of this CTA's channels, its parts of the Cs sums, exchanged
    channel_sums([&](int c, float s) { m[c] = s / (float)hw; });
    __syncthreads();
    if (wn > 0) mbar_wait(bar, 0);
    cluster_wait();
    reduce_gemv(rn, [&](int j, float s) { push(j, s); });
    cluster_arrive();
    cluster_wait();
    for (int j = tid; j < cs; j += nt) {
      float s = 0.0f;
      for (int q = 0; q < ranks; ++q) s += part[q * L.pw + j];
      s1[j] = se_swish(s + sm[L.b1 + j]);
    }
  }
  __syncthreads();

  // ---- expand GEMV + sigmoid for this CTA's channels: P2 lanes a channel,
  // each over every P2-th squeezed channel, then a butterfly
  int P2 = 1;
  while (P2 < 32 && cn * P2 * 2 <= nt && P2 * 2 <= cs) P2 *= 2;
  for (int i = tid; i < round_up(max(cn, 0) * P2, 32); i += nt) {
    const int c = i / P2;
    const int p = i - c * P2;
    // four sums side by side, so that the loads of a step do not wait for
    // the step before
    float g4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (c < cn) {
      const float* w = w2s + woff + c;
      int j = p;
      for (; j + 3 * P2 < cs; j += 4 * P2) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          g4[u] = fmaf(s1[j + u * P2], w[(j + u * P2) * L.ldw], g4[u]);
      }
      for (; j < cs; j += P2) g4[0] = fmaf(s1[j], w[j * L.ldw], g4[0]);
    }
    float g = (g4[0] + g4[1]) + (g4[2] + g4[3]);
    for (int off = P2 >> 1; off > 0; off >>= 1)
      g += __shfl_xor_sync(0xffffffffu, g, off);
    if (c < cn && p == 0)
      gate[(size_t)b * cep + c0 + c] = se_sigmoid(g + sm[L.b2 + c]);
  }
}

bool se_args_ok(int B, int n_tiles, int cep, int cs, int hw, int ranks,
                int split_tiles, int per_rank, int threads) {
  const bool pow2 = ranks == 1 || ranks == 2 || ranks == 4 || ranks == 8;
  if (B < 1 || n_tiles < 1 || cs < 1 || hw < 1 || cep < 16 || cep % 16 != 0 ||
      !pow2 || per_rank < 1 || threads < 32 || threads % 32 != 0 ||
      threads > SE_MAX_THREADS)
    return false;
  // every tile or channel has its CTA; a thread has at most one float4 column
  if (split_tiles)
    return (long long)per_rank * ranks >= n_tiles && cep / 4 <= threads;
  return per_rank % 4 == 0 && (long long)per_rank * ranks >= cep &&
         per_rank <= cep && per_rank / 4 <= threads &&
         2LL * cs * per_rank * 4 < (1 << 20);  // an mbarrier's byte count
}

struct SeLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[2];
};

// the launch of B clusters of `ranks` CTAs, as a dependent of the kernel
// before it in the stream
cudaError_t se_launch_config(SeLaunch& l, int B, int cep, int cs, int ranks,
                             int split_tiles, int per_rank, int threads,
                             cudaStream_t stream) {
  const size_t smem =
      (size_t)se_layout(cep, cs, ranks, split_tiles, per_rank, threads).total *
      sizeof(float);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  static int allowed[MAX_DEVICES] = {};  // the limit set, per device
  cudaError_t err = allow_dynamic_smem(se_kernel, allowed, (int)smem);
  if (err != cudaSuccess) return err;
  l.cfg = cudaLaunchConfig_t{};
  l.cfg.gridDim = dim3(B * ranks);
  l.cfg.blockDim = dim3(threads);
  l.cfg.dynamicSmemBytes = smem;
  l.cfg.stream = stream;
  l.attrs[0].id = cudaLaunchAttributeClusterDimension;
  l.attrs[0].val.clusterDim.x = ranks;
  l.attrs[0].val.clusterDim.y = 1;
  l.attrs[0].val.clusterDim.z = 1;
  l.attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  l.attrs[1].val.programmaticStreamSerializationAllowed = 1;
  l.cfg.attrs = l.attrs;
  l.cfg.numAttrs = 2;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// (b). `ranks` CTAs (1, 2, 4 or 8) of `threads` threads form the cluster of
// an image; with split_tiles == 0 each owns per_rank channels (a multiple of
// 4), with split_tiles == 1 per_rank tiles. se_pack (or NULL) is `pack_se`
// of ops/fused_mbconv.py; it serves 8 CTAs that split the channels.
int mbconv_se(const void* psum, const void* w_se1, const void* b_se1,
              const void* w_se2, const void* b_se2, const void* se_pack,
              void* gate, int B,
              int n_tiles, int cep, int cs, int hw, int ranks, int split_tiles,
              int per_rank, int threads, void* stream) {
  if (!se_args_ok(B, n_tiles, cep, cs, hw, ranks, split_tiles, per_rank,
                  threads) ||
      (se_pack != nullptr &&
       (split_tiles || ranks != 8 || per_rank != round_up((cep + 7) / 8, 4))))
    return (int)cudaErrorInvalidValue;
  SeLaunch l;
  cudaError_t err =
      se_launch_config(l, B, cep, cs, ranks, split_tiles, per_rank, threads,
                       static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(
      &l.cfg, se_kernel, static_cast<const float*>(psum),
      static_cast<const float*>(w_se1), static_cast<const float*>(b_se1),
      static_cast<const float*>(w_se2), static_cast<const float*>(b_se2),
      static_cast<const float*>(se_pack), static_cast<float*>(gate), n_tiles, cep, cs, hw, split_tiles, per_rank);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// How many clusters of this launch the card can hold at once; 0 means the
// launch would fail, a negative value is minus a CUDA error.
int mbconv_se_max_clusters(int B, int cep, int cs, int ranks, int split_tiles,
                           int per_rank, int threads) {
  if (!se_args_ok(B, 1, cep, cs, 1, ranks, split_tiles,
                  split_tiles ? 1 << 20 : per_rank, threads))
    return -(int)cudaErrorInvalidValue;
  SeLaunch l;
  cudaError_t err = se_launch_config(l, B, cep, cs, ranks, split_tiles,
                                     per_rank, threads, nullptr);
  if (err != cudaSuccess) return -(int)err;
  l.cfg.numAttrs = 1;  // the cluster's shape only
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, se_kernel, &l.cfg);
  return err != cudaSuccess ? -(int)err : n;
}

}  // extern "C"
