// Decayed-InfoNCE negatives for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernels of mscl_tpu/ops/decayed_infonce.py:
//   l_neg_kernel replaces _fwd_kernel (via _pallas_l_neg):
//       l_neg (B,K) = q (B,C) @ (queue (C,K) * decay (K,))
//   dq_partial_kernel + dq_reduce_kernel replace _bwd_kernel (via _pallas_dq):
//       dq (B,C) = g (B,K) @ (queue * decay)^T
// All tensors are float32, contiguous, row-major, and every operation is a
// float32 one on the CUDA cores (no TF32, no bf16).
//
// What bounds them on an H100: bytes. At the flagship shapes (B=32, C=128,
// K=65536) each call must move 42.2 MB, the 33.5 MB queue once and the
// 8.4 MB l_neg written (forward) or g read (backward): 12.6 us at 3.35 TB/s,
// against 0.545 GFLOP of float32 FMAs (8.1 us at 67 TFLOP/s). The FMAs fit
// under the bytes only if the loads overlap them and few instructions feed
// each one, so the design is about bytes in flight, overlap and loads per FMA:
//   * An async-copy ring. Each tile's queue rows (and, in the backward, its
//     g and decay columns) stream through a ring of 3 stages in shared
//     memory, filled by 16-byte cp.async (zero-filled past a ragged edge;
//     4-byte copies where K is not a multiple of 4) and waited for with
//     cp.async.wait_group, two stages in flight while one is read: about
//     64 KB an SM in the forward and 80 KB in the backward, not bounded by
//     registers. (Deeper rings measured slower on an H100 at 700 W.)
//   * Register micro-tiles. Forward: a thread owns 4 consecutive columns x
//     8 rows, so for each channel one LDS.128 of the queue and two broadcast
//     LDS.128 of q feed 32 FMAs. Backward: a thread owns 4 rows x 4
//     channels over 4 consecutive k, so 8 LDS.128 feed 64 FMAs; staged rows
//     are padded by 4 floats, so the channels a warp reads at one k lie in
//     different banks.
//   * The decay leaves the K loop. decay[k] does not depend on the channel,
//     so the forward multiplies each output's sum by it once (one float4
//     load for 4 columns: B x K multiplies, not C x K), and the backward
//     scales each staged g tile by it once (B x K, not C x K). The decayed
//     queue never reaches device memory, as in the TPU kernel's fusion.
//   * Forward grid: a block of 8 warps takes two 128-column K-tiles, one a
//     group of 4 warps with its own ring and barrier, and the two share one
//     copy of q in shared memory; at K=65536 its 256 blocks are all resident
//     at once, 2 blocks (16 warps) an SM. l_neg is written with streaming
//     stores.
//   * Backward: split-K over a fixed number of slabs (the wrapper's
//     DQ_SLABS, 256: 2 blocks of 8 warps an SM), each a run of whole
//     128-column tiles, into partial (B,C) sums; a second launch sums them
//     in a fixed order. The slab count depends on K only, not on the card,
//     so the bits of dq are the same on any card, and no float atomics are
//     used.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// columns of a K-tile: what a forward group takes, a backward slab's unit
constexpr int kTile = 128;

constexpr int kFwdGroups = 2;           // K-tiles a forward block takes at once
// a tile's group: 32 column groups of 4 x 4 row groups of 8
constexpr int kGroupThreads = 128;
constexpr int kFwdThreads = kFwdGroups * kGroupThreads;
constexpr int kFwdRows = 32;            // rows of q per pass
constexpr int kFwdCC = 16;              // channels per forward stage
constexpr int kFwdStages = 3;           // depth of a forward ring
constexpr int kQStride = kFwdRows + 4;  // padded c-major row of q_s

constexpr int kBwdRows = 32;            // rows of g per pass: 8 row groups x 4
constexpr int kBwdGroups = kBwdRows / 4;
constexpr int kBwdBK = 32;              // columns per backward stage
constexpr int kBwdStages = 3;           // depth of the backward ring
constexpr int kBwdStride = kBwdBK + 4;  // padded row of a backward stage
constexpr int kBwdMaxThreads = 512;     // 8 row groups x 64 channel groups

constexpr int kRedWarps = 8;            // dq_reduce: warps per 32 outputs

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Async copy global -> shared of 16 (Vec) or 4 bytes; zero-fills if !valid.
template <bool Vec>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  if (Vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Forward stage: channels [c0, c0 + kFwdCC) of a tile's columns
// [k0, k0 + width) into stage[kFwdCC][kTile], by the tile's group (t is the
// thread's index in it); zero past C and width.
template <bool Vec>
__device__ __forceinline__ void fwd_load(float* stage, const float* queue,
                                         int C, int K, int c0, int k0,
                                         int width, int t) {
  constexpr int kStep = Vec ? 4 : 1;
  constexpr int kPerRow = kTile / kStep;
  for (int i = t; i < kFwdCC * kPerRow; i += kGroupThreads) {
    const int r = i / kPerRow, col = kStep * (i % kPerRow);
    const bool ok = c0 + r < C && col < width;
    cp_async<Vec>(stage + r * kTile + col,
                  ok ? queue + (size_t)(c0 + r) * K + k0 + col : queue, ok);
  }
}

// Barrier of one tile's group of kGroupThreads threads (ids 1.., 0 is
// __syncthreads).
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "n"(kGroupThreads)
               : "memory");
}

// Block x takes the K-tiles kFwdGroups*x + group, one a group of 4 warps,
// each streaming its tile through its own ring; the groups share one copy
// of q in shared memory, so q is read from L2 once a block. (With a block
// a tile, the 512 blocks reading the same 16 KB of q at once held back
// every block's first compute on an H100.)
template <bool Vec>
__global__ void __launch_bounds__(kFwdThreads)
    l_neg_kernel(const float* __restrict__ q, const float* __restrict__ queue,
                 const float* __restrict__ decay, float* __restrict__ out,
                 int B, int C, int K, int block_k) {
  extern __shared__ float4 smem4[];
  const int cpad = (C + kFwdCC - 1) / kFwdCC * kFwdCC;
  const int chunks = cpad / kFwdCC;
  const int group = threadIdx.x / kGroupThreads;
  const int t = threadIdx.x % kGroupThreads;
  float* q_s = reinterpret_cast<float*>(smem4);  // [cpad][kQStride], c-major
  float* ring = q_s + cpad * kQStride +          // [kFwdStages][kFwdCC][kTile]
                group * kFwdStages * kFwdCC * kTile;
  const int tile = blockIdx.x * kFwdGroups + group;
  const bool active = tile < K / block_k;
  const int k0 = tile * block_k;
  const int cg = t % 32, rg = t / 32;  // columns 4cg.., rows 8rg..
  for (int b0 = 0; b0 < B; b0 += kFwdRows) {
    const int nb = min(kFwdRows, B - b0);
    __syncthreads();  // the previous pass is done with q_s and the rings
    // q rows b0.. transposed into q_s by 4-byte async copies, coalesced
    // along C, zero past B and C: one group ahead of the rings'
    for (int j = 0; j < kFwdRows; ++j)
      for (int c = threadIdx.x; c < cpad; c += kFwdThreads) {
        const bool ok = j < nb && c < C;
        cp_async<false>(q_s + c * kQStride + j,
                        ok ? q + (size_t)(b0 + j) * C + c : q, ok);
      }
    cp_async_commit();
    for (int s = 0; s < kFwdStages - 1; ++s) {
      if (active && s < chunks)
        fwd_load<Vec>(ring + s * kFwdCC * kTile, queue, C, K, s * kFwdCC, k0,
                      block_k, t);
      cp_async_commit();
    }
    float acc[8][4] = {};
    for (int ch = 0; ch < chunks; ++ch) {
      // q's group and stage ch landed (kFwdStages - 2 later groups may pend)
      cp_async_wait<kFwdStages - 2>();
      // ... for the whole block (q_s) at first, then for the tile's group;
      // stage ch-1 is free
      if (ch == 0)
        __syncthreads();
      else
        group_sync(group);
      const int next = ch + kFwdStages - 1;
      if (active && next < chunks)
        fwd_load<Vec>(ring + (next % kFwdStages) * kFwdCC * kTile, queue, C,
                      K, next * kFwdCC, k0, block_k, t);
      cp_async_commit();
      if (!active) continue;
      const float* w_s = ring + (ch % kFwdStages) * kFwdCC * kTile + 4 * cg;
      const float* qc = q_s + ch * kFwdCC * kQStride + 8 * rg;
#pragma unroll
      for (int cc = 0; cc < kFwdCC; ++cc) {
        const float4 w = *reinterpret_cast<const float4*>(w_s + cc * kTile);
        const float4 a = *reinterpret_cast<const float4*>(qc + cc * kQStride);
        const float4 b =
            *reinterpret_cast<const float4*>(qc + cc * kQStride + 4);
        const float qv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[j][0] = fmaf(qv[j], w.x, acc[j][0]);
          acc[j][1] = fmaf(qv[j], w.y, acc[j][1]);
          acc[j][2] = fmaf(qv[j], w.z, acc[j][2]);
          acc[j][3] = fmaf(qv[j], w.w, acc[j][3]);
        }
      }
    }
    if (!active) continue;
    // epilogue: the decay, once per output; streaming stores, as nothing
    // here reads l_neg again
    const int col = 4 * cg, k = k0 + col;
    if (Vec) {
      if (col < block_k) {
        const float4 d = *reinterpret_cast<const float4*>(decay + k);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (8 * rg + j < nb)
            __stcs(reinterpret_cast<float4*>(out + (size_t)(b0 + 8 * rg + j) *
                                                       K + k),
                   make_float4(acc[j][0] * d.x, acc[j][1] * d.y,
                               acc[j][2] * d.z, acc[j][3] * d.w));
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (col + e >= block_k) break;
        const float d = decay[k + e];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (8 * rg + j < nb)
            __stcs(out + (size_t)(b0 + 8 * rg + j) * K + k + e,
                   acc[j][e] * d);
      }
    }
  }
}

// Backward stage, rows of kBwdStride floats: queue rows [0, cpad), then g
// rows [b0, b0 + kBwdRows), then one row of decay, each over the columns
// [k, k + kBwdBK); zero past C, B and ke.
template <bool Vec>
__device__ __forceinline__ void bwd_load(float* stage, const float* g,
                                         const float* queue,
                                         const float* decay, int B, int C,
                                         int K, int cpad, int b0, int k,
                                         int ke) {
  constexpr int kStep = Vec ? 4 : 1;
  constexpr int kPerRow = kBwdBK / kStep;
  const int rows = cpad + kBwdRows + 1;
  for (int i = threadIdx.x; i < rows * kPerRow; i += blockDim.x) {
    const int r = i / kPerRow, col = kStep * (i % kPerRow);
    bool ok = k + col < ke;
    const float* src = decay;
    if (r < cpad) {
      ok = ok && r < C;
      src = queue + (size_t)r * K;
    } else if (r < cpad + kBwdRows) {
      ok = ok && b0 + r - cpad < B;
      src = g + (size_t)(b0 + r - cpad) * K;
    }
    cp_async<Vec>(stage + r * kBwdStride + col, ok ? src + k + col : queue,
                  ok);
  }
}

// Block p reduces the columns of slab p into partial[p] (B,C). A thread owns
// channels cg + j*ncg and rows rg + 8i (i, j < 4) of each pass of 32 rows,
// cg = t % ncg, rg = t / ncg, ncg = ceil(C/4); threads past 8 row groups
// only load.
template <bool Vec>
__global__ void __launch_bounds__(kBwdMaxThreads)
    dq_partial_kernel(const float* __restrict__ g,
                      const float* __restrict__ queue,
                      const float* __restrict__ decay,
                      float* __restrict__ partial, int B, int C, int K,
                      int slabs) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const int ncg = (C + 3) / 4, cpad = 4 * ncg;
  const int stage_floats = (cpad + kBwdRows + 1) * kBwdStride;
  const int cg = threadIdx.x % ncg, rg = threadIdx.x / ncg;
  const bool computes = rg < kBwdGroups;
  const int tiles = (K + kTile - 1) / kTile;
  const int t0 = (int)((long long)blockIdx.x * tiles / slabs);
  const int t1 = (int)((long long)(blockIdx.x + 1) * tiles / slabs);
  const int kb = t0 * kTile, ke = min(t1 * kTile, K);
  const int chunks = (ke - kb + kBwdBK - 1) / kBwdBK;
  float* part = partial + (size_t)blockIdx.x * B * C;
  for (int b0 = 0; b0 < B; b0 += kBwdRows) {
    __syncthreads();  // the previous pass is done with the ring
    for (int s = 0; s < kBwdStages - 1; ++s) {
      if (s < chunks)
        bwd_load<Vec>(ring + s * stage_floats, g, queue, decay, B, C, K,
                      cpad, b0, kb + s * kBwdBK, ke);
      cp_async_commit();
    }
    float acc[4][4] = {};
    for (int ch = 0; ch < chunks; ++ch) {
      cp_async_wait<kBwdStages - 2>();  // stage ch landed
      __syncthreads();  // ... for all threads; stage ch-1 is free
      const int next = ch + kBwdStages - 1;
      if (next < chunks)
        bwd_load<Vec>(ring + (next % kBwdStages) * stage_floats, g, queue,
                      decay, B, C, K, cpad, b0, kb + next * kBwdBK, ke);
      cp_async_commit();
      float* st = ring + (ch % kBwdStages) * stage_floats;
      float* g_s = st + cpad * kBwdStride;
      const float* d_s = g_s + kBwdRows * kBwdStride;
      // the decay folded into the staged g tile: B x BK multiplies
      for (int i = threadIdx.x; i < kBwdRows * kBwdBK / 4; i += blockDim.x) {
        float4* p = reinterpret_cast<float4*>(
            g_s + (i / (kBwdBK / 4)) * kBwdStride + 4 * (i % (kBwdBK / 4)));
        const float4 d =
            *reinterpret_cast<const float4*>(d_s + 4 * (i % (kBwdBK / 4)));
        float4 v = *p;
        v.x *= d.x;
        v.y *= d.y;
        v.z *= d.z;
        v.w *= d.w;
        *p = v;
      }
      __syncthreads();
      if (computes) {
        const float* qb = st + cg * kBwdStride;
        const float* gb = g_s + rg * kBwdStride;
#pragma unroll
        for (int kk = 0; kk < kBwdBK; kk += 4) {
          float4 qv[4], gv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            qv[j] = *reinterpret_cast<const float4*>(
                qb + j * ncg * kBwdStride + kk);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            gv[i] = *reinterpret_cast<const float4*>(
                gb + i * kBwdGroups * kBwdStride + kk);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float a = acc[i][j];
              a = fmaf(gv[i].x, qv[j].x, a);
              a = fmaf(gv[i].y, qv[j].y, a);
              a = fmaf(gv[i].z, qv[j].z, a);
              a = fmaf(gv[i].w, qv[j].w, a);
              acc[i][j] = a;
            }
        }
      }
    }
    if (computes) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int b = b0 + rg + i * kBwdGroups;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = cg + j * ncg;
          if (b < B && c < C) part[(size_t)b * C + c] = acc[i][j];
        }
      }
    }
  }
}

// dq[o] = the sum over p of partial[p][o] in a fixed order: warp w adds the
// slabs [w*per, (w+1)*per) in increasing p, and the kRedWarps warp sums are
// added in increasing w. Block x owns outputs [32x, 32x + 32).
__global__ void __launch_bounds__(32 * kRedWarps)
    dq_reduce_kernel(const float* __restrict__ partial,
                     float* __restrict__ dq, int n, int slabs) {
  __shared__ float sums[kRedWarps][32];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int o = blockIdx.x * 32 + lane;
  const int per = (slabs + kRedWarps - 1) / kRedWarps;
  const int p1 = min(slabs, (w + 1) * per);
  float s = 0.f;
  if (o < n) {
#pragma unroll 8
    for (int p = w * per; p < p1; ++p) s += partial[(size_t)p * n + o];
  }
  sums[w][lane] = s;
  __syncthreads();
  if (w == 0 && o < n) {
    float t = sums[0][lane];
#pragma unroll
    for (int i = 1; i < kRedWarps; ++i) t += sums[i][lane];
    dq[o] = t;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

size_t fwd_smem(int C) {
  const int cpad = (C + kFwdCC - 1) / kFwdCC * kFwdCC;
  return sizeof(float) *
         (cpad * kQStride + kFwdGroups * kFwdStages * kFwdCC * kTile);
}

size_t bwd_smem(int C) {
  const int cpad = 4 * ((C + 3) / 4);
  return sizeof(float) * kBwdStages * (cpad + kBwdRows + 1) * kBwdStride;
}

int bwd_threads(int C) {
  return (kBwdGroups * ((C + 3) / 4) + 31) / 32 * 32;
}

// Both rings live in dynamic shared memory, above the 48 KB default at the
// flagship shapes: raise the kernel's limit, then launch.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int blocks, int threads, size_t smem,
           cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shapes are validated by the Python wrapper: 1 <= block_k <= 128,
// K % block_k == 0, C <= 256.
int decayed_infonce_l_neg(const float* q, const float* queue,
                          const float* decay, float* out, int B, int C,
                          int K, int block_k, cudaStream_t stream) {
  const bool vec = K % 4 == 0 && aligned16(queue) && aligned16(decay) &&
                   aligned16(out);
  auto kernel = vec ? l_neg_kernel<true> : l_neg_kernel<false>;
  const int tiles = K / block_k;
  return launch(kernel, (tiles + kFwdGroups - 1) / kFwdGroups, kFwdThreads,
                fwd_smem(C), stream, q, queue, decay, out, B, C, K, block_k);
}

// partial: scratch of slabs * B * C floats; slabs <= ceil(K / 128).
int decayed_infonce_dq(const float* g, const float* queue,
                       const float* decay, float* partial, float* dq, int B,
                       int C, int K, int slabs, cudaStream_t stream) {
  const bool vec =
      K % 4 == 0 && aligned16(g) && aligned16(queue) && aligned16(decay);
  auto kernel = vec ? dq_partial_kernel<true> : dq_partial_kernel<false>;
  const int err = launch(kernel, slabs, bwd_threads(C), bwd_smem(C), stream,
                         g, queue, decay, partial, B, C, K, slabs);
  if (err != 0) return err;
  const int n = B * C;
  dq_reduce_kernel<<<(n + 31) / 32, 32 * kRedWarps, 0, stream>>>(
      partial, dq, n, slabs);
  return (int)cudaGetLastError();
}

// Launch shape of the vectorised kernels at width C (backward != 0: the dq
// partial kernel): dynamic shared memory bytes, threads a block and blocks
// resident on one SM of the current device.
int decayed_infonce_launch_info(int C, int backward, int* smem, int* threads,
                                int* blocks_per_sm) {
  *smem = (int)(backward ? bwd_smem(C) : fwd_smem(C));
  *threads = backward ? bwd_threads(C) : kFwdThreads;
  const void* kernel =
      backward ? reinterpret_cast<const void*>(dq_partial_kernel<true>)
               : reinterpret_cast<const void*>(l_neg_kernel<true>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, *threads, (size_t)*smem);
}

}  // extern "C"
