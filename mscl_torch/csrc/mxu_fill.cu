// Matrix-unit fill probes for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the five Pallas TPU probes of tools/analysis/bench_mxu_fill.py:
//   make_probe         (:34)  tap_smem_acc_kernel<N, false>  mxu_fill_tap, pair = 0
//   make_probe_paircat (:195) tap_smem_acc_kernel<N, true>   mxu_fill_tap, pair = 1
//   make_probe_carry   (:72)  tap_carry_kernel<N, F>         mxu_fill_carry
//   make_probe_bigdot  (:117) kcat_gemm_kernel<N, BM, false> mxu_fill_kcat, build = 0
//   make_probe_imcat   (:151) kcat_gemm_kernel<N, BM, true>  mxu_fill_kcat, build = 1
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
// same output block. Here every (step, M-tile) pair is computed and its tile
// stored (one block each for the tap kernels; a unit of a persistent block's
// walk for kcat), so a launch does `steps` passes of work and its result is
// one pass.
//
// What bounds them on an H100: operations. At the tool's r3d_18 layer1
// geometry (M=3248, 27 taps, K=N=64) one pass is 0.718 GFLOP (0.73 us at the
// 989 TFLOP/s dense bf16 peak) against 1.05 MB of operands read and written
// once (0.31 us at 3.35 TB/s); `steps` multiplies only the operations.
//
// Design. The TPU probes kept every operand VMEM-resident. A block here has
// at most 232,448 B of shared memory, and all 27 taps of w take 221,184 B at
// K=N=64 and 1,769,472 B at K=256, N=128, so w stays L2-resident (50 MB) and
// is staged tap by tap (or in 64-deep chunks) through a shared-memory ring.
// The tap kernels use mma.sync.m16n8k16 (bf16 in, f32 accumulate), fed by
// ldmatrix from shared memory whose rows are padded by 8 bf16, so the 8 rows
// of each 8x8 matrix fall in different banks, and fill their ring by
// cp.async; kcat uses wgmma and TMA. Each kernel keeps the accumulation
// structure that its TPU probe measured:
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
//   * kcat_gemm_kernel (bigdot, imcat): one GEMM over the concatenated depth
//     in 64-deep chunks, on Hopper's own machinery. What bounds it: the
//     tensor cores (2*M*depth*N operations a pass) only if they are fed.
//     At N=64 each unit re-reads its BM x depth rows of x from L2 for as
//     many operations as bytes x 64: a launch of bigdot at K=1792 moves
//     1.93 GB at BM=256, and the walk's order decides how fast L2 gives
//     it. wgmma reads A (64 x 16) and B (16 x N) from shared memory for
//     each m64nNk16, 4 KB for 131 kFLOP at N=64; imcat's build copies as
//     many bytes again. Design:
//       - warp specialisation, 384 threads: warpgroup 0 produces (thread 0
//         issues every TMA load, warps 1-3 build imcat's patch chunks),
//         warpgroups 1 and 2 consume, each with BM/2 rows x N f32
//         accumulators in registers (setmaxnreg gives them 232 registers,
//         the producers 40);
//       - a tile of BM = 128 or 256 rows x the whole N. A ring of 2-8 stages
//         of 64-deep chunks, each BM x 64 of A and 64 x N of w, one 128-byte
//         row per chunk row under the TMA's 128-byte swizzle, with full and
//         empty mbarriers; wgmma.m64nNk16 reads A K-major and w MN-major (its
//         transpose bit) through descriptors that match that swizzle;
//       - persistent blocks, as many as the SMs hold, so one unit's
//         epilogue overlaps the next unit's loads. The (step, M-tile)
//         units, tile after tile, are cut into equal slices, one for each
//         group of about 32 consecutive blocks (KcatWalk): a group's
//         blocks read one tile's rows of x together, which L2 serves far
//         faster than rows read apart (walked step after step, bigdot drew
//         about 8 TB/s from L2 and lost to cuBLAS), and they stay on that
//         tile however far they drift over a long launch (a stride walk
//         does not: over the probe tool's launches of tens of ms it fell
//         back to the step-after-step rate). The epilogue rounds to bf16
//         once and stores 16 bytes a lane after a quad transpose;
//       - bigdot: A chunks are TMA boxes of x (zero-filled past row M);
//       - imcat: the tile's x slab, (BM+8) rows x K, is loaded once a unit by
//         TMA under the same swizzle, and the patch matrix is a ring of BM x 64
//         chunks, no longer a slab held whole (at 32 x 1792 it took half the
//         SM's shared memory, forced 32-row tiles, below wgmma's 64, and was
//         built before the first product). Chunk c is columns 64c .. 64c+63
//         of X_cat: column block t = 64c / K at column 64c mod K, the window
//         S(off(t)). Rows r and r+8 share a phase of the swizzle, so the
//         build is a straight 16-byte copy from the slab, by the build
//         warps while wgmma consumes earlier chunks. (Pointing wgmma's A
//         descriptor at the slab 8 rows down would skip the copy: that is an
//         implicit GEMM, not this probe.)
//     The host's plan (kcat) takes BM = 256 where its slab and 3 stages fit,
//     then the deepest ring that fits, and groups of 32 blocks: the fastest
//     tile and ring at 132 steps among the variants timed on an H100
//     (PERF.md), and within 3 % of the best number of groups there. Over
//     the probe tool's launches one group (all blocks on one tile) is
//     faster still for bigdot at depth >= 896, N=64, but costs depth 448 a
//     fifth; no one walk is best for every shape.
// M need not be a multiple of a tile (3248 = 16 * 203): the last tile
// zero-fills the rows past x's end and stores only rows < M.
#include <cuda.h>  // CUtensorMap; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kPad = 8;          // bf16 (16 B) of padding per shared row
constexpr int kHalo = 8;         // rows of x past a tile that a tap reads
constexpr int kThreads = 128;    // tap_smem_acc: 2 x 2 warps
constexpr int kTapRows = 64;     // tap_smem_acc tile rows
constexpr int kCarryMaxThreads = 1024;
constexpr size_t kMaxSmem = 232448;
// kcat_gemm: a chunk is 64 bf16 deep, one 128-byte row of the TMA swizzle
constexpr int kChunk = 64;
constexpr int kRowBytes = 128;
constexpr int kKcatThreads = 384;   // producer warpgroup + 2 consumer ones
constexpr int kBuildThreads = 96;   // imcat: warps 1-3 of the producer
constexpr int kBuildBatch = 4;      // 16-byte copies in flight a thread
// registers a thread after setmaxnreg: 128 * 40 + 256 * 232 is the 384 * 168
// the block is launched with (a split that asked for more hung the block)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kMaxStages = 8;
constexpr int kGroupBlocks = 32;    // blocks that share a tile in the walk
constexpr size_t kKcatBarBytes = (2 * kMaxStages + 2) * sizeof(uint64_t);

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

// ---- kcat_gemm: wgmma, TMA and warp specialisation -------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.b32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of the given parity has completed (the phase before
// the first, parity 1, counts as completed).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// TMA: the box of `map` at (col, row) into shared memory at dst, completing
// its bytes on bar. Rows past the tensor's end arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// Shared-memory matrix descriptor of wgmma under the 128-byte swizzle:
// start, leading and stride byte offsets in 16-byte units, layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(Pending)
               : "memory");
}

#define KC_D8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x N, f32) = A (64 x 16, K-major) x B (16 x N, MN-major: the
// transpose bit) + (scale_d ? d : 0), both operands in shared memory.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : KC_D8(0), KC_D8(8), KC_D8(16), KC_D8(24)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "
        "1, 0, 1;\n}\n"
        : KC_D8(0), KC_D8(8), KC_D8(16), KC_D8(24), KC_D8(32), KC_D8(40),
          KC_D8(48), KC_D8(56)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
#undef KC_D8

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Round a consumer warp's 16 x N slice of an m64 accumulator to bf16 and
// store rows < M, 16 bytes a lane. In wgmma's layout lane l holds, for each
// 8-column block j, columns 8j + 2(l%4) .. +1 of rows l/4 and l/4 + 8; a
// transpose within each quad of lanes over 4 blocks gives lane q of the
// quad all 8 columns of block 4G + q.
template <int N>
__device__ __forceinline__ void store_m64(bf16* out, int row, int M,
                                          const float (&d)[N / 2]) {
  const int q = threadIdx.x & 3;
  const bool q0 = q & 1, q1 = q & 2;
  row += (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h, row += 8) {
#pragma unroll
    for (int G = 0; G < N / 32; ++G) {
      uint32_t a[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        a[j] = pack_bf16x2(d[(4 * G + j) * 4 + 2 * h],
                           d[(4 * G + j) * 4 + 2 * h + 1]);
      // keep the two blocks whose bit 1 is q's, swap the others with q ^ 2
      const uint32_t k0 = q1 ? a[2] : a[0], k1 = q1 ? a[3] : a[1];
      const uint32_t p0 = __shfl_xor_sync(~0u, q1 ? a[0] : a[2], 2);
      const uint32_t p1 = __shfl_xor_sync(~0u, q1 ? a[1] : a[3], 2);
      // then keep block q and swap the other with q ^ 1
      const uint32_t u0 = __shfl_xor_sync(~0u, q0 ? k0 : k1, 1);
      const uint32_t u1 = __shfl_xor_sync(~0u, q0 ? p0 : p1, 1);
      const uint32_t m0 = q0 ? k1 : k0, m1 = q0 ? p1 : p0;
      // the words of lanes q, q^1, q^2, q^3 are m0, u0, m1, u1
      const uint32_t e0 = q0 ? u0 : m0, e1 = q0 ? m0 : u0;
      const uint32_t f0 = q0 ? u1 : m1, f1 = q0 ? m1 : u1;
      const uint4 v = make_uint4(q1 ? f0 : e0, q1 ? f1 : e1, q1 ? e0 : f0,
                                 q1 ? e1 : f1);
      if (row < M)
        *reinterpret_cast<uint4*>(out + (size_t)row * N + (4 * G + q) * 8) = v;
    }
  }
}

// The (step, M-tile) units of this block, in order. The units, tile after
// tile (all steps of tile 0, then of tile 1, ...), are cut into `groups`
// equal slices, one for each of as many equal groups of consecutive blocks
// (groups <= blocks), whose blocks take their slice's units in turn: a
// group reads one tile's rows of x together, however far apart its blocks
// drift.
struct KcatWalk {
  long long v, end, n;
  int steps;
  __device__ __forceinline__ KcatWalk(int tiles, int steps_, int groups)
      : steps(steps_) {
    const long long b = blockIdx.x, grid = gridDim.x;
    const long long units = (long long)tiles * steps;
    const long long q = ((b + 1) * groups - 1) / grid;  // this block's group
    const long long first = q * grid / groups;
    n = (q + 1) * grid / groups - first;
    v = units * q / groups + (b - first);
    end = units * (q + 1) / groups;
  }
  __device__ __forceinline__ bool more() const { return v < end; }
  __device__ __forceinline__ int tile() const { return (int)(v / steps); }
  __device__ __forceinline__ void next() { v += n; }
};

// bigdot (BUILD = false): out = x @ w, x (M, K) through tm_x (box 64 x BM),
// depth K. imcat (BUILD = true): out = X_cat @ w, x (M+8, K) through tm_x
// (box 64 x BM) and tm_halo (box 64 x 8), depth inner*K. w (depth, N)
// through tm_w (box 64 x 64). Each block walks its units by KcatWalk.
template <int N, int BM, bool BUILD>
__global__ void __launch_bounds__(kKcatThreads, 1)
kcat_gemm_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_halo,
                 const __grid_constant__ CUtensorMap tm_w,
                 bf16* __restrict__ out, int M, int K, int chunks, int tiles,
                 int steps, int stages, int groups) {
  constexpr int MT = BM / 128;                 // m64 tiles a consumer
  constexpr uint32_t kA = BM * kRowBytes;      // A chunk bytes
  constexpr uint32_t kW = kChunk * N * 2;      // w chunk bytes
  constexpr uint32_t kStage = kA + kW;
  constexpr uint32_t kNBlock = kChunk * kRowBytes;  // one 64-column w box
  constexpr uint32_t kSlabBox = (BM + kHalo) * kRowBytes;
  extern __shared__ unsigned char kcat_smem[];
  // the 128-byte swizzle repeats every 1,024 bytes: align the ring to it
  const uint32_t ring = (smem_u32(kcat_smem) + 1023) & ~1023u;
  const uint32_t slab_bytes = BUILD ? (K / kChunk) * kSlabBox : 0;
  const uint32_t slab = ring + stages * kStage;      // imcat's x slab
  const uint32_t full = slab + slab_bytes;
  const uint32_t empty = full + kMaxStages * 8;
  const uint32_t slab_full = empty + kMaxStages * 8;
  const uint32_t slab_empty = slab_full + 8;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, BUILD ? 1 + kBuildThreads : 1);
      mbar_init(empty + 8 * s, 2);                 // one per consumer
    }
    mbar_init(slab_full, 1);
    mbar_init(slab_empty, kBuildThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer warpgroup -------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs)
                 : "memory");
    if (threadIdx.x == 0) {
      // TMA: imcat's slab once a unit, then w (and bigdot's A) a chunk
      int s = 0;
      uint32_t ph = 0;
      unsigned n = 0;                              // units of this block
      for (KcatWalk u(tiles, steps, groups); u.more(); u.next(), ++n) {
        const int row0 = u.tile() * BM;
        if (BUILD) {
          // once the build warps are done with the last unit's slab
          mbar_wait(slab_empty, (n & 1) ^ 1);
          mbar_arrive_tx(slab_full, slab_bytes);
          for (int kb = 0; kb < K / kChunk; ++kb) {
            tma_load(slab + kb * kSlabBox, &tm_x, slab_full, kb * kChunk,
                     row0);
            tma_load(slab + kb * kSlabBox + kA, &tm_halo, slab_full,
                     kb * kChunk, row0 + BM);
          }
        }
        for (int c = 0; c < chunks; ++c) {
          mbar_wait(empty + 8 * s, ph ^ 1);
          const uint32_t st = ring + s * kStage;
          mbar_arrive_tx(full + 8 * s, BUILD ? kW : kStage);
          if (!BUILD) tma_load(st, &tm_x, full + 8 * s, c * kChunk, row0);
#pragma unroll
          for (int nb = 0; nb < N / 64; ++nb)
            tma_load(st + kA + nb * kNBlock, &tm_w, full + 8 * s, nb * 64,
                     c * kChunk);
          if (++s == stages) s = 0, ph ^= 1;
        }
      }
    } else if (BUILD && threadIdx.x >= 32) {
      // build warps (1-3): chunk c of the patch matrix, columns 64c .. of
      // X_cat, is column block t = 64c / K, the window S(off(t)), at column
      // 64c mod K; rows r and r+8 share a phase of the swizzle, so it is
      // the slab's column box, off rows down, copied as it lies
      constexpr int kVecs = kA / 16;
      const int b = threadIdx.x - 32;
      const int kbs = K / kChunk;
      unsigned char* gring = kcat_smem + (ring - smem_u32(kcat_smem));
      int s = 0;
      uint32_t ph = 0;
      unsigned n = 0;
      for (KcatWalk u(tiles, steps, groups); u.more(); u.next(), ++n) {
        mbar_wait(slab_full, n & 1);
        for (int c = 0; c < chunks; ++c) {
          const int t = c / kbs;
          const int off = (((t >> 1) + (t & 1)) & 1) * kHalo;
          const uint4* src = reinterpret_cast<const uint4*>(
              gring + (slab - ring) + (c - t * kbs) * kSlabBox +
              off * kRowBytes);
          uint4* dst = reinterpret_cast<uint4*>(gring + s * kStage);
          mbar_wait(empty + 8 * s, ph ^ 1);
          // kBuildBatch loads in flight before their stores: src and dst
          // may alias as far as the compiler knows
          for (int i = b; i < kVecs; i += kBuildBatch * kBuildThreads) {
            uint4 v[kBuildBatch];
#pragma unroll
            for (int j = 0; j < kBuildBatch; ++j)
              if (i + j * kBuildThreads < kVecs) v[j] = src[i + j * kBuildThreads];
#pragma unroll
            for (int j = 0; j < kBuildBatch; ++j)
              if (i + j * kBuildThreads < kVecs) dst[i + j * kBuildThreads] = v[j];
          }
          // make the generic-proxy writes visible to wgmma's reads
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(full + 8 * s);
          if (++s == stages) s = 0, ph ^= 1;
        }
        mbar_arrive(slab_empty);
      }
    }
  } else {
    // ---- consumer warpgroups: rows g*BM/2 .. of each tile --------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs)
                 : "memory");
    const int g = wg - 1;
    const bool leader = threadIdx.x % 128 == 0;
    float acc[MT][N / 2];
    int s = 0, prev = 0;
    uint32_t ph = 0;
    for (KcatWalk u(tiles, steps, groups); u.more(); u.next()) {
      const int row0 = u.tile() * BM;
      for (int c = 0; c < chunks; ++c) {
        mbar_wait(full + 8 * s, ph);
        const uint32_t a0 = ring + s * kStage + g * (BM / 2) * kRowBytes;
        const uint32_t b0 = ring + s * kStage + kA;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk) {
          // A: 32 bytes further along each 128-byte row; w: 16 rows down
          const uint64_t db = sw128_desc(b0 + kk * 16 * kRowBytes, kNBlock,
                                         8 * kRowBytes);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            Wgmma<N>::mma(acc[mt],
                          sw128_desc(a0 + mt * 64 * kRowBytes + kk * 32, 16,
                                     8 * kRowBytes),
                          db, (c | kk) != 0);
        }
        wgmma_commit();
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
        // the previous chunk's products are done: release its stage
        wgmma_wait<1>();
        if (c > 0 && leader) mbar_arrive(empty + 8 * prev);
        prev = s;
        if (++s == stages) s = 0, ph ^= 1;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
      if (leader) mbar_arrive(empty + 8 * prev);
      const int row = row0 + g * (BM / 2) + (threadIdx.x % 128) / 32 * 16;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        store_m64<N>(out, row + mt * 64, M, acc[mt]);
    }
  }
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda: take it through the runtime's
// entry-point lookup, so the library needs no link to libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (rows, cols) row-major bf16 tensor, read in boxes of 64 columns (one
// 128-byte swizzle row) x box_rows rows; rows past `rows` read as zeros.
bool tensor_map(CUtensorMap* map, const bf16* p, int rows, int cols,
                int box_rows) {
  const EncodeTiled fn = encode_tiled();
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)kChunk, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn && fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                  const_cast<bf16*>(p), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

size_t kcat_smem_bytes(int bm, int stages, int K, int N, bool build) {
  return 1024 + (size_t)stages * (bm * kRowBytes + kChunk * N * 2) +
         (build ? (size_t)(K / kChunk) * (bm + kHalo) * kRowBytes : 0) +
         kKcatBarBytes;
}

struct Kcat {
  const bf16* x;
  const bf16* w;
  bf16* out;
  int M, K, N, inner, build, steps;
};

// How a kcat launch runs; mxu_fill_kcat_plan's info, in this order.
struct KcatPlan {
  int bm, stages, smem, blocks, per_sm, units, groups;
};

// The grid of kcat_gemm_kernel<N, BM, BUILD> with a ring of `stages` on the
// current device: persistent blocks, as many as the SMs hold, in groups of
// about kGroupBlocks (KcatWalk).
template <int N, int BM, bool BUILD>
int kcat_grid(const Kcat& a, int stages, KcatPlan* p) {
  const auto kernel = kcat_gemm_kernel<N, BM, BUILD>;
  const size_t smem = kcat_smem_bytes(BM, stages, a.K, N, BUILD);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kKcatThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int tiles = (a.M + BM - 1) / BM;
  const long long units = (long long)tiles * a.steps;
  if (units > INT_MAX) return (int)cudaErrorInvalidValue;
  const long long grid = units < (long long)sms * per_sm ? units
                                                         : (long long)sms * per_sm;
  const long long groups = grid / kGroupBlocks;
  *p = {BM, stages, (int)smem, (int)grid, per_sm, (int)units,
        groups > 1 ? (int)groups : 1};
  return 0;
}

template <int N, int BM, bool BUILD>
int kcat_launch(const Kcat& a, const KcatPlan& p, cudaStream_t stream) {
  const int depth = BUILD ? a.inner * a.K : a.K;
  CUtensorMap tx, th, tw;
  if (!tensor_map(&tx, a.x, BUILD ? a.M + kHalo : a.M, a.K, BM) ||
      !tensor_map(&tw, a.w, depth, N, kChunk))
    return (int)cudaErrorInvalidValue;
  // only imcat reads the 8 rows past a tile; bigdot's x has none
  if (!BUILD)
    th = tx;
  else if (!tensor_map(&th, a.x, a.M + kHalo, a.K, kHalo))
    return (int)cudaErrorInvalidValue;
  kcat_gemm_kernel<N, BM, BUILD><<<p.blocks, kKcatThreads, p.smem, stream>>>(
      tx, th, tw, a.out, a.M, a.K, depth / kChunk, (a.M + BM - 1) / BM,
      a.steps, p.stages, p.groups);
  return (int)cudaGetLastError();
}

// Plan and, with launch, run one kcat launch: BM = 256 wherever its slab
// and a ring of 3 stages fit (bigdot always), else 128; the deepest ring
// that fits.
int kcat(const Kcat& a, bool launch, cudaStream_t stream, KcatPlan* p) {
  const bool build = a.build != 0;
  if (a.steps < 1) return (int)cudaErrorInvalidValue;
  const int bm =
      kcat_smem_bytes(256, 3, a.K, a.N, build) <= kMaxSmem ? 256 : 128;
  int stages = kMaxStages;
  while (stages > 2 && kcat_smem_bytes(bm, stages, a.K, a.N, build) > kMaxSmem)
    --stages;
  if (kcat_smem_bytes(bm, stages, a.K, a.N, build) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
#define KCAT(n, tile, b)                                                \
  if (a.N == n && bm == tile && build == b) {                           \
    const int err = kcat_grid<n, tile, b>(a, stages, p);                \
    return err || !launch ? err : kcat_launch<n, tile, b>(a, *p, stream); \
  }
  KCAT(64, 256, false) KCAT(128, 256, false) KCAT(64, 128, true)
  KCAT(64, 256, true) KCAT(128, 128, true) KCAT(128, 256, true)
#undef KCAT
  return (int)cudaErrorInvalidValue;
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
// inner even. The plan picks the tile and the ring.
int mxu_fill_kcat(const void* x, const void* w, void* out, int M, int K,
                  int N, int inner, int build, int steps,
                  cudaStream_t stream) {
  KcatPlan p;
  return kcat({static_cast<const bf16*>(x), static_cast<const bf16*>(w),
               static_cast<bf16*>(out), M, K, N, inner, build, steps},
              true, stream, &p);
}

// The plan of a kcat launch without launching it: info[0..6] = BM, ring
// stages, dynamic shared memory bytes, persistent blocks, blocks an SM,
// (step, M-tile) units, groups of the walk.
int mxu_fill_kcat_plan(int M, int K, int N, int inner, int build, int steps,
                       int* info) {
  KcatPlan p;
  const int err = kcat({nullptr, nullptr, nullptr, M, K, N, inner, build,
                        steps},
                       false, nullptr, &p);
  if (err == 0) {
    const int vals[7] = {p.bm,     p.stages, p.smem, p.blocks,
                         p.per_sm, p.units,  p.groups};
    for (int i = 0; i < 7; ++i) info[i] = vals[i];
  }
  return err;
}

}  // extern "C"
