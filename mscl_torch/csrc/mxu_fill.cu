// Matrix-unit fill probes for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the five Pallas TPU probes of tools/analysis/bench_mxu_fill.py:
//   make_probe         (:34)  tap_smem_acc_kernel<N, false>  mxu_fill_tap, pair = 0
//   make_probe_paircat (:195) tap_smem_acc_kernel<N, true>   mxu_fill_tap, pair = 1
//   make_probe_carry   (:72)  tap_carry_kernel<N, F>         mxu_fill_carry
//   make_probe_bigdot  (:117) kcat_gemm_kernel<N, false>     mxu_fill_kcat, build = 0
//   make_probe_imcat   (:151) kcat_gemm_kernel<N, true>      mxu_fill_kcat, build = 1
// Write S(o) for rows o .. o+M-1 of x. Operands are bf16, products accumulate
// in f32, and the (M, N) bf16 output is rounded once at the end:
//   probe, carry  out = sum_{i<inner} S((i%2)*8) @ w[i]       x (M+8,K), w (inner,K,N)
//   paircat       out = sum_{j<inner/2} [S((j%2)*8) | S(((j+1)%2)*8)] @ w[j]
//                                                             x (M+8,K), w (inner/2,2K,N)
//   imcat         out = X_cat @ w, column block t of X_cat is S(off(t)),
//                 off(t) = (((t>>1) + (t&1)) % 2) * 8 (paircat's pair order)
//                                                             x (M+8,K), w (inner*K,N)
//   bigdot        out = x @ w                                 x (M,K),   w (K,N)
// The TPU grid (steps,) runs the same program `steps` times, each writing the
// same output block. Here the grid is (M-tiles x steps) blocks and every block
// stores its tile, so a launch does `steps` passes of work and its result is
// one pass.
//
// What bounds them on an H100: operations. At the tool's r3d_18 layer1
// geometry (M=3248, 27 taps, K=N=64) one pass is 0.718 GFLOP (0.73 us at the
// 989 TFLOP/s dense bf16 peak) against 1.05 MB of operands read and written
// once (0.31 us at 3.35 TB/s); `steps` multiplies only the operations.
//
// Design. Tensor cores through mma.sync.m16n8k16 (bf16 in, f32 accumulate),
// fed by ldmatrix from shared memory whose rows are padded by 8 bf16, so the 8
// rows of each 8x8 matrix fall in different banks. The TPU probes kept every
// operand VMEM-resident. A block here has at most 232,448 B of shared memory,
// and all 27 taps of w take 221,184 B at K=N=64 and 1,769,472 B at K=256,
// N=128, so w stays L2-resident (50 MB) and is staged tap by tap (or in
// 64-deep chunks) through a shared-memory ring filled by cp.async. Each
// kernel keeps the accumulation structure that its TPU probe measured:
//   * tap_smem_acc_kernel (probe, paircat): a 64-row tile, 4 warps of
//     32 x N/2. The tile's x slab (72 rows: 64 and the 8-row halo) is loaded
//     once. For each tap (paircat: each pair), every warp computes its product
//     into fresh registers and then read-modify-writes the f32 accumulator
//     tile in shared memory, as Mosaic's lowering did (docs/benchmark.md:
//     591-596). paircat's concat is only addressing: the A fragments for depth
//     < K come from one offset and the rest from the other. Shared bytes:
//     72*(K+8)*2 + 2*TK*(N+8)*2 + 64*(N+8)*4, TK = K (probe) or 2K (paircat):
//     47,232 at K=N=64, 212,096 at K=256, N=128, 114,816 for paircat at
//     K=64, N=128.
//   * tap_carry_kernel (carry): one block per mt-row tile. Its warps own F m16
//     fragments each across all N columns, so the mt x N f32 accumulator stays
//     in registers across all taps: mt*N*4 B is 28,672 at mt=112, 118,784 at
//     464 and 415,744 at 1624. The last exceeds the SM's 262,144-byte register
//     file; under __launch_bounds__(1024) (64 registers a thread) the F=3
//     and F=4 instantiations (mt > 1024) spill by construction, as the TPU's
//     carry did (docs/benchmark.md:557-562); the ptxas report beside the
//     built library (build/mxu_fill-*.log) gives the bytes. The tile's
//     (mt+8)-row x slab does not fit a block at mt=1624 (417,792 B at K=128),
//     so each warp reads its A fragments from global memory (x is at most
//     1.7 MB and stays in L2); w is staged per tap (2*K*(N+8)*2 B: 18,432 at
//     K=N=64, 36,864 at K=128). mt need not be a multiple of 16 (1624 is
//     not): fragment rows past the tile read zeros and are not stored.
//   * kcat_gemm_kernel (bigdot, imcat): one GEMM over the concatenated depth,
//     chained through register accumulators in 64-deep chunks. bigdot: 64-row
//     tiles, 4 warps of 32 x N/2, A and w chunks through a 3-stage ring
//     (55,296 B at N=64, 79,872 at N=128). imcat: 32-row tiles, 4 warps of
//     16 x N/2. The tile's x slab (40 rows) is loaded, then the whole
//     K-concatenated patch slab (32 x inner*K) is built in shared memory by
//     shared-to-shared copies before the GEMM starts (chunk by chunk would be
//     bigdot, or an implicit GEMM), then w streams through a 2-stage ring:
//     115,200 + 5,760 + 18,432 = 139,392 B at inner*K = 1792, N=64 (155,776 at
//     N=128). A 64-row slab (230,400 B) would leave no room for w.
// M need not be a multiple of a tile (3248 = 16 * 203): the last tile
// zero-fills the rows past x's end and stores only rows < M.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kPad = 8;          // bf16 (16 B) of padding per shared row
constexpr int kHalo = 8;         // rows of x past a tile that a tap reads
constexpr int kThreads = 128;    // tap_smem_acc and kcat_gemm: 2 x 2 warps
constexpr int kTapRows = 64;     // tap_smem_acc tile rows
constexpr int kChunk = 64;       // kcat_gemm depth per ring stage
constexpr int kCarryMaxThreads = 1024;
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; zero-fills the 16 bytes when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cp.async a rows x cols bf16 tile (cols % 8 == 0) from source rows row0 ..
// row0+rows-1 of src (row stride ss elements) into dst (row stride ds);
// source rows >= limit are zero-filled.
__device__ __forceinline__ void load_tile(bf16* dst, int ds, const bf16* src,
                                          int ss, int row0, int rows,
                                          int cols, int limit) {
  const int chunks = cols / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    const int gr = row0 + r;
    const bool ok = gr < limit;
    cp_async16(dst + r * ds + c, src + (size_t)(ok ? gr : 0) * ss + c, ok);
  }
}

// acc[MF][NF] += A (16*MF rows at a, row stride sa) x B (depth rows at b,
// row stride sb, 8*NF columns), depth % 16 == 0, both in shared memory.
template <int MF, int NF>
__device__ __forceinline__ void warp_mma(float (&acc)[MF][NF][4],
                                         const bf16* a, int sa, const bf16* b,
                                         int sb, int depth) {
  const int lane = threadIdx.x & 31;
  const int lr = lane & 15, lc = (lane >> 4) * 8;
#pragma unroll 2
  for (int k = 0; k < depth; k += 16) {
    uint32_t af[MF][4];
#pragma unroll
    for (int i = 0; i < MF; ++i) ldmatrix_x4(af[i], a + (i * 16 + lr) * sa + k + lc);
#pragma unroll
    for (int j = 0; j < NF; j += 2) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, b + (k + lr) * sb + j * 8 + lc);
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        mma_bf16(acc[i][j], af[i], bf[0], bf[1]);
        mma_bf16(acc[i][j + 1], af[i], bf[2], bf[3]);
      }
    }
  }
}

template <int MF, int NF>
__device__ __forceinline__ void zero(float (&acc)[MF][NF][4]) {
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// The f32 element pair (row, col) .. (row, col+1) that a lane holds in
// fragment (i, j), half h (rows +8), of a warp tile at (r0, c0).
#define FRAG_ROW(r0, i, h) ((r0) + (i) * 16 + ((threadIdx.x & 31) >> 2) + (h) * 8)
#define FRAG_COL(c0, j) ((c0) + (j) * 8 + (threadIdx.x & 3) * 2)

// Round a warp tile to bf16 and store rows < row_limit of out (row stride n).
template <int MF, int NF>
__device__ __forceinline__ void store_tile(bf16* out, int n, int r0, int c0,
                                           int row_limit,
                                           const float (&acc)[MF][NF][4]) {
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = FRAG_ROW(r0, i, h);
      if (r >= row_limit) continue;
#pragma unroll
      for (int j = 0; j < NF; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * n +
                                           FRAG_COL(c0, j)) =
            __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    }
}

// probe (PAIR = false: `stages` = inner taps of depth K) and paircat (PAIR =
// true: `stages` = inner/2 pairs of depth 2K), accumulator in shared memory.
template <int N, bool PAIR>
__global__ void __launch_bounds__(kThreads)
tap_smem_acc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    bf16* __restrict__ out, int M, int K, int stages) {
  constexpr int MF = 2, NF = N / 16, WN = N / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tk = PAIR ? 2 * K : K;
  const int xs = K + kPad, ws = N + kPad, as = N + kPad;
  bf16* x_s = reinterpret_cast<bf16*>(smem);            // [72][K + 8]
  bf16* w_s = x_s + (kTapRows + kHalo) * xs;            // [2][tk][N + 8]
  float* acc_s = reinterpret_cast<float*>(w_s + 2 * tk * ws);  // [64][N + 8]
  const int tiles = (M + kTapRows - 1) / kTapRows;
  const int row0 = (blockIdx.x % tiles) * kTapRows;
  const int warp = threadIdx.x >> 5;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * WN;

  load_tile(x_s, xs, x, K, row0, kTapRows + kHalo, K, M + kHalo);
  load_tile(w_s, ws, w, N, 0, tk, N, tk);
  cp_async_commit();
  // each thread reads and writes only its own accumulator elements
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NF; ++j)
        *reinterpret_cast<float2*>(acc_s + FRAG_ROW(wr, i, h) * as +
                                   FRAG_COL(wc, j)) = make_float2(0.f, 0.f);

  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages)
      load_tile(w_s + ((s + 1) & 1) * tk * ws, ws,
                w + (size_t)(s + 1) * tk * N, N, 0, tk, N, tk);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float part[MF][NF][4];
    zero(part);
    const bf16* wb = w_s + (s & 1) * tk * ws + wc;
    warp_mma<MF, NF>(part, x_s + (wr + (s & 1) * kHalo) * xs, xs, wb, ws, K);
    if (PAIR)
      warp_mma<MF, NF>(part, x_s + (wr + ((s + 1) & 1) * kHalo) * xs, xs,
                       wb + K * ws, ws, K);
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          float2* p = reinterpret_cast<float2*>(
              acc_s + FRAG_ROW(wr, i, h) * as + FRAG_COL(wc, j));
          float2 v = *p;
          v.x += part[i][j][2 * h];
          v.y += part[i][j][2 * h + 1];
          *p = v;
        }
    __syncthreads();
  }
  float acc[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const float2 v = *reinterpret_cast<const float2*>(
            acc_s + FRAG_ROW(wr, i, h) * as + FRAG_COL(wc, j));
        acc[i][j][2 * h] = v.x;
        acc[i][j][2 * h + 1] = v.y;
      }
  store_tile(out, N, row0 + wr, wc, M, acc);
}

// One 32-bit A-fragment word (two bf16 of row r, columns col, col+1) of a
// tile whose rows start at xa; zero for rows past the tile (r >= mt).
__device__ __forceinline__ uint32_t a_word(const bf16* xa, int K, int r,
                                           int mt, int col) {
  return r < mt ? __ldg(reinterpret_cast<const unsigned int*>(
                      xa + (size_t)r * K + col))
                : 0u;
}

// carry: one block per mt-row tile; warp v owns m16 fragments v*F .. v*F+F-1
// of the tile, all N columns, with their accumulators in registers.
template <int N, int F>
__global__ void __launch_bounds__(kCarryMaxThreads)
tap_carry_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 bf16* __restrict__ out, int M, int mt, int K, int inner) {
  constexpr int NF = N / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* w_s = reinterpret_cast<bf16*>(smem);            // [2][K][N + 8]
  const int ws = N + kPad;
  const int tiles = M / mt;
  const int row0 = (blockIdx.x % tiles) * mt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lr = lane & 15, lc = (lane >> 4) * 8;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int frags = (mt + 15) / 16, f0 = warp * F;

  float acc[F][NF][4];
  zero(acc);
  load_tile(w_s, ws, w, N, 0, K, N, K);
  cp_async_commit();
  for (int i = 0; i < inner; ++i) {
    if (i + 1 < inner)
      load_tile(w_s + ((i + 1) & 1) * K * ws, ws, w + (size_t)(i + 1) * K * N,
                N, 0, K, N, K);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* wb = w_s + (i & 1) * K * ws;
    const bf16* xa = x + (size_t)(row0 + (i & 1) * kHalo) * K;
    for (int k = 0; k < K; k += 16) {
#pragma unroll
      for (int f = 0; f < F; ++f) {
        if (f0 + f >= frags) continue;                  // warp-uniform
        const int r = (f0 + f) * 16 + g;
        uint32_t a[4];
        a[0] = a_word(xa, K, r, mt, k + t2);
        a[1] = a_word(xa, K, r + 8, mt, k + t2);
        a[2] = a_word(xa, K, r, mt, k + t2 + 8);
        a[3] = a_word(xa, K, r + 8, mt, k + t2 + 8);
#pragma unroll
        for (int j = 0; j < NF; j += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, wb + (k + lr) * ws + j * 8 + lc);
          mma_bf16(acc[f][j], a, b[0], b[1]);
          mma_bf16(acc[f][j + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }
  store_tile(out, N, row0 + f0 * 16, 0, row0 + mt, acc);
}

// bigdot (BUILD = false: x (M,K), depth K) and imcat (BUILD = true: x
// (M+8,K), depth inner*K from the patch slab built first).
template <int N, bool BUILD>
__global__ void __launch_bounds__(kThreads)
kcat_gemm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 bf16* __restrict__ out, int M, int K, int inner) {
  constexpr int MF = BUILD ? 1 : 2, BM = 32 * MF, NF = N / 16, WN = N / 2;
  constexpr int kStages = BUILD ? 2 : 3;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kt = BUILD ? inner * K : K;
  const int as = (BUILD ? kt : kChunk) + kPad, ws = N + kPad, xs = K + kPad;
  // BUILD: the patch slab [BM][kt + 8]; else the A ring [kStages][BM][72]
  bf16* a_s = reinterpret_cast<bf16*>(smem);
  bf16* w_s = a_s + (BUILD ? 1 : kStages) * BM * as;    // [kStages][64][N + 8]
  bf16* x_s = w_s + kStages * kChunk * ws;              // BUILD: [BM + 8][K + 8]
  const int tiles = (M + BM - 1) / BM;
  const int row0 = (blockIdx.x % tiles) * BM;
  const int warp = threadIdx.x >> 5;
  const int wr = (warp >> 1) * 16 * MF, wc = (warp & 1) * WN;
  const int chunks = kt / kChunk;

  auto load_chunk = [&](int c) {
    const int b = c % kStages;
    load_tile(w_s + b * kChunk * ws, ws, w + (size_t)c * kChunk * N, N, 0,
              kChunk, N, kChunk);
    if (!BUILD)
      load_tile(a_s + b * BM * as, as, x + c * kChunk, K, row0, BM, kChunk, M);
  };

  if (BUILD) {
    load_tile(x_s, xs, x, K, row0, BM + kHalo, K, M + kHalo);
    cp_async_commit();
  }
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) load_chunk(c);
    cp_async_commit();
  }
  if (BUILD) {
    cp_async_wait<kStages - 1>();                       // the x slab
    __syncthreads();
    const int kc = K / 8;
    for (int i = threadIdx.x; i < inner * BM * kc; i += blockDim.x) {
      const int t = i / (BM * kc), rem = i - t * BM * kc;
      const int r = rem / kc, c = (rem - r * kc) * 8;
      const int off = (((t >> 1) + (t & 1)) & 1) * kHalo;
      *reinterpret_cast<uint4*>(a_s + r * as + t * K + c) =
          *reinterpret_cast<const uint4*>(x_s + (r + off) * xs + c);
    }
  }
  float acc[MF][NF][4];
  zero(acc);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (c + kStages - 1 < chunks) load_chunk(c + kStages - 1);
    cp_async_commit();
    const int b = c % kStages;
    const bf16* a = BUILD ? a_s + wr * as + c * kChunk : a_s + (b * BM + wr) * as;
    warp_mma<MF, NF>(acc, a, as, w_s + b * kChunk * ws + wc, ws, kChunk);
  }
  store_tile(out, N, row0 + wr, wc, M, acc);
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, long long blocks, int threads, size_t smem,
           cudaStream_t stream, Args... args) {
  if (blocks < 1 || blocks > INT_MAX || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shapes are validated by the Python wrappers (ops/mxu_fill.py): N is 64 or
// 128, K % 16 == 0 and the tap depth (K, or 2K with pair) <= 256.
int mxu_fill_tap(const void* x, const void* w, void* out, int M, int K, int N,
                 int inner, int pair, int steps, cudaStream_t stream) {
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* ob = static_cast<bf16*>(out);
  const int stages = pair ? inner / 2 : inner, tk = pair ? 2 * K : K;
  const size_t smem =
      sizeof(bf16) * ((kTapRows + kHalo) * (K + kPad) + 2 * tk * (N + kPad)) +
      sizeof(float) * kTapRows * (N + kPad);
  const long long blocks = (long long)((M + kTapRows - 1) / kTapRows) * steps;
  if (N == 64)
    return pair ? launch(tap_smem_acc_kernel<64, true>, blocks, kThreads, smem,
                         stream, xb, wb, ob, M, K, stages)
                : launch(tap_smem_acc_kernel<64, false>, blocks, kThreads,
                         smem, stream, xb, wb, ob, M, K, stages);
  if (N == 128)
    return pair ? launch(tap_smem_acc_kernel<128, true>, blocks, kThreads,
                         smem, stream, xb, wb, ob, M, K, stages)
                : launch(tap_smem_acc_kernel<128, false>, blocks, kThreads,
                         smem, stream, xb, wb, ob, M, K, stages);
  return (int)cudaErrorInvalidValue;
}

// M % mt == 0, mt <= 2048 (F = ceil(ceil(mt/16) / 32) <= 4), K % 16 == 0.
int mxu_fill_carry(const void* x, const void* w, void* out, int M, int mt,
                   int K, int N, int inner, int steps, cudaStream_t stream) {
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* ob = static_cast<bf16*>(out);
  const int frags = (mt + 15) / 16;
  const int f = (frags + 31) / 32;
  const int threads = (frags + f - 1) / f * 32;
  const size_t smem = sizeof(bf16) * 2 * K * (N + kPad);
  const long long blocks = (long long)(M / mt) * steps;
#define CARRY(n, ff)                                                          \
  if (N == n && f == ff)                                                      \
    return launch(tap_carry_kernel<n, ff>, blocks, threads, smem, stream, xb, \
                  wb, ob, M, mt, K, inner);
  CARRY(64, 1) CARRY(64, 2) CARRY(64, 3) CARRY(64, 4)
  CARRY(128, 1) CARRY(128, 2) CARRY(128, 3) CARRY(128, 4)
#undef CARRY
  return (int)cudaErrorInvalidValue;
}

// bigdot (build = 0): K % 64 == 0. imcat (build = 1): K % 64 == 0, K <= 256,
// inner even, inner * K <= 2048.
int mxu_fill_kcat(const void* x, const void* w, void* out, int M, int K,
                  int N, int inner, int build, int steps,
                  cudaStream_t stream) {
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* ob = static_cast<bf16*>(out);
  const int bm = build ? 32 : 64, stages = build ? 2 : 3;
  const size_t w_ring = (size_t)stages * kChunk * (N + kPad);
  const size_t smem =
      sizeof(bf16) *
      (build ? bm * (inner * K + kPad) + w_ring + (bm + kHalo) * (K + kPad)
             : stages * bm * (kChunk + kPad) + w_ring);
  const long long blocks = (long long)((M + bm - 1) / bm) * steps;
  if (N == 64)
    return build ? launch(kcat_gemm_kernel<64, true>, blocks, kThreads, smem,
                          stream, xb, wb, ob, M, K, inner)
                 : launch(kcat_gemm_kernel<64, false>, blocks, kThreads, smem,
                          stream, xb, wb, ob, M, K, inner);
  if (N == 128)
    return build ? launch(kcat_gemm_kernel<128, true>, blocks, kThreads, smem,
                          stream, xb, wb, ob, M, K, inner)
                 : launch(kcat_gemm_kernel<128, false>, blocks, kThreads,
                          smem, stream, xb, wb, ob, M, K, inner);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
