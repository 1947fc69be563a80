// Decayed-InfoNCE negatives for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernels of mscl_tpu/ops/decayed_infonce.py:
//   forward  _fwd_kernel (via _pallas_l_neg):  l_neg (B,K) = q (B,C) @ (queue (C,K) * decay (K,))
//   backward _bwd_kernel (via _pallas_dq):     dq (B,C)   = g (B,K) @ (queue * decay)^T
// All tensors are float32, contiguous, row-major.
//
// What bounds them on an H100: bytes. At the flagship shapes (B=32, C=128,
// K=65536) each call must stream the 33.5 MB queue once; the forward also
// writes the 8.4 MB l_neg and the backward reads the 8.4 MB g, against
// 0.54 GFLOP of float32 FMA work (about 8 us at 67 TFLOP/s, below the
// ~12.6 us that 42 MB take at 3.35 TB/s).
//
// Design:
//   * The decay is applied to each queue element as it is loaded, so the
//     decayed (C,K) matrix never reaches device memory (the TPU kernel's
//     fusion).
//   * Forward: one block per K-tile of block_k columns (K=65536, block_k=128:
//     512 blocks over 132 SMs). The block holds up to 32 rows of q in shared
//     memory, c-major so each thread reads its 32 q values for one c as 8
//     broadcast float4 loads; each thread owns one queue column, streams it
//     along C with loads that are coalesced across the warp, and keeps the
//     32 partial dot products in registers.
//   * Backward: split-K. The TPU kernel carries the K-sum in its output over
//     a sequential grid; Hopper blocks run in parallel and in no order, so
//     each block reduces its own K-slab into a partial (B,C) in scratch, and a
//     second kernel sums the partials in a fixed order: the result is
//     deterministic, with no atomics.
#include <cuda_runtime.h>

namespace {

constexpr int kFwdThreads = 128;
constexpr int kRows = 32;      // forward: q rows held per pass
constexpr int kBwdRows = 16;   // backward: rows (outputs) per thread
constexpr int kTileK = 32;     // backward: K columns per shared-memory tile

__global__ void l_neg_kernel(const float* __restrict__ q,
                             const float* __restrict__ queue,
                             const float* __restrict__ decay,
                             float* __restrict__ out,
                             int B, int C, int K, int block_k) {
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [C][kRows], c-major
  const int k_begin = blockIdx.x * block_k;
  for (int b0 = 0; b0 < B; b0 += kRows) {
    const int nb = min(kRows, B - b0);
    __syncthreads();
    for (int i = threadIdx.x; i < C * kRows; i += blockDim.x) {
      const int c = i / kRows, j = i % kRows;
      q_s[i] = j < nb ? q[(size_t)(b0 + j) * C + c] : 0.f;
    }
    __syncthreads();
    for (int kk = threadIdx.x; kk < block_k; kk += blockDim.x) {
      const int k = k_begin + kk;
      const float d = decay[k];
      float acc[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[j] = 0.f;
#pragma unroll 8
      for (int c = 0; c < C; ++c) {
        const float w = queue[(size_t)c * K + k] * d;
        const float4* qc = reinterpret_cast<const float4*>(q_s + c * kRows);
#pragma unroll
        for (int j4 = 0; j4 < kRows / 4; ++j4) {
          const float4 v = qc[j4];
          acc[4 * j4 + 0] += v.x * w;
          acc[4 * j4 + 1] += v.y * w;
          acc[4 * j4 + 2] += v.z * w;
          acc[4 * j4 + 3] += v.w * w;
        }
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        if (j < nb) out[(size_t)(b0 + j) * K + k] = acc[j];
    }
  }
}

// Block p reduces columns [p*block_k, (p+1)*block_k) into partial[p] (B,C).
// Thread t owns channel c = t % C and rows g*16 .. g*16+15 of the current
// row chunk, g = t / C; a chunk covers (blockDim / C) * 16 rows.
__global__ void dq_partial_kernel(const float* __restrict__ g,
                                  const float* __restrict__ queue,
                                  const float* __restrict__ decay,
                                  float* __restrict__ partial,
                                  int B, int C, int K, int block_k) {
  extern __shared__ float4 smem4[];
  const int groups = blockDim.x / C;
  const int chunk = groups * kBwdRows;
  float* w_s = reinterpret_cast<float*>(smem4);  // [kTileK][C + 1]
  float* g_s = w_s + kTileK * (C + 1);           // [kTileK][chunk]
  const int c = threadIdx.x % C, grp = threadIdx.x / C;
  const int k_begin = blockIdx.x * block_k, k_end = k_begin + block_k;
  float* part = partial + (size_t)blockIdx.x * B * C;
  for (int b0 = 0; b0 < B; b0 += chunk) {
    float acc[kBwdRows];
#pragma unroll
    for (int j = 0; j < kBwdRows; ++j) acc[j] = 0.f;
    for (int k0 = k_begin; k0 < k_end; k0 += kTileK) {
      __syncthreads();
      for (int i = threadIdx.x; i < C * kTileK; i += blockDim.x) {
        const int cc = i / kTileK, kk = i % kTileK, k = k0 + kk;
        w_s[kk * (C + 1) + cc] = k < k_end ? queue[(size_t)cc * K + k] * decay[k] : 0.f;
      }
      for (int i = threadIdx.x; i < chunk * kTileK; i += blockDim.x) {
        const int bb = i / kTileK, kk = i % kTileK, k = k0 + kk, b = b0 + bb;
        g_s[kk * chunk + bb] = (k < k_end && b < B) ? g[(size_t)b * K + k] : 0.f;
      }
      __syncthreads();
      if (grp < groups) {
#pragma unroll 4
        for (int kk = 0; kk < kTileK; ++kk) {
          const float w = w_s[kk * (C + 1) + c];
          const float* gr = g_s + kk * chunk + grp * kBwdRows;
#pragma unroll
          for (int j = 0; j < kBwdRows; ++j) acc[j] += gr[j] * w;
        }
      }
    }
    if (grp < groups) {
#pragma unroll
      for (int j = 0; j < kBwdRows; ++j) {
        const int b = b0 + grp * kBwdRows + j;
        if (b < B) part[(size_t)b * C + c] = acc[j];
      }
    }
  }
}

// dq[o] = sum_p partial[p][o], summed in increasing p.
__global__ void dq_reduce_kernel(const float* __restrict__ partial,
                                 float* __restrict__ dq, int n, int parts) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += partial[(size_t)p * n + o];
  dq[o] = s;
}

}  // namespace

extern "C" {

// Shapes are validated by the Python wrapper: K % block_k == 0, C <= 256.
int decayed_infonce_l_neg(const float* q, const float* queue,
                          const float* decay, float* out, int B, int C,
                          int K, int block_k, cudaStream_t stream) {
  const size_t smem = sizeof(float) * C * kRows;
  l_neg_kernel<<<K / block_k, kFwdThreads, smem, stream>>>(
      q, queue, decay, out, B, C, K, block_k);
  return (int)cudaGetLastError();
}

// partial: scratch of (K / block_k) * B * C floats.
int decayed_infonce_dq(const float* g, const float* queue,
                       const float* decay, float* partial, float* dq, int B,
                       int C, int K, int block_k, cudaStream_t stream) {
  // Row groups of 16 per block: as many as 256 threads hold, no more than
  // B needs, and at most 8, so shared memory stays under the 48 KB default
  // (with C <= 256 the w and g tiles take at most about 35 KB).
  int groups = C >= 256 ? 1 : 256 / C;
  groups = min(groups, min((B + kBwdRows - 1) / kBwdRows, 8));
  const int threads = groups * C;
  const size_t smem =
      sizeof(float) * (kTileK * (C + 1) + kTileK * groups * kBwdRows);
  const int parts = K / block_k;
  dq_partial_kernel<<<parts, threads, smem, stream>>>(g, queue, decay,
                                                      partial, B, C, K,
                                                      block_k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = B * C;
  dq_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(partial, dq, n,
                                                        parts);
  return (int)cudaGetLastError();
}

}  // extern "C"
