// Matrix-unit fill probes for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the five Pallas TPU probes of tools/analysis/bench_mxu_fill.py:
//   make_probe         (:34)  tap_wgmma_kernel<N, BM, true>   mxu_fill_tap, pair = 0
//   make_probe_paircat (:195) tap_wgmma_kernel<N, BM, true>   mxu_fill_tap, pair = 1
//   make_probe_carry   (:72)  tap_wgmma_kernel<N, BM, false>  mxu_fill_carry
//   make_probe_bigdot  (:117) kcat_gemm_kernel<N, BM, false>  mxu_fill_kcat, build = 0
//   make_probe_imcat   (:151) kcat_gemm_kernel<N, BM, true>   mxu_fill_kcat, build = 1
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
// same output block. Here every (step, tile) unit is computed and its tile
// stored by persistent blocks that walk the units, so a launch does `steps`
// passes of work and its result is one pass.
//
// What bounds them on an H100: operations. At the tool's r3d_18 layer1
// geometry (M=3248, 27 taps, K=N=64) one pass is 0.718 GFLOP (0.73 us at the
// 989 TFLOP/s dense bf16 peak) against 1.05 MB of operands read and written
// once (0.31 us at 3.35 TB/s); `steps` multiplies only the operations.
//
// Design. The TPU probes kept every operand VMEM-resident. A block here has
// at most 232,448 B of shared memory, and all 27 taps of w take 221,184 B at
// K=N=64 and 1,769,472 B at K=256, N=128, so w stays L2-resident (50 MB) and
// is streamed through a shared-memory ring in 64-deep chunks. Both kernels
// run on Hopper's own machinery. What bounds them: the tensor cores (2*M*
// depth*N operations a pass) only if they are fed. wgmma reads A (64 x 16)
// and B (16 x N) from shared memory for each m64nNk16, 4 KB for 131 kFLOP at
// N=64. Shared by both:
//   - warp specialisation, 384 threads: warpgroup 0 produces (thread 0
//     issues every TMA load; for imcat, warps 1-3 build its patch chunks),
//     warpgroups 1 and 2 consume, each with BM/2 rows x N f32 accumulators
//     in registers (setmaxnreg gives them 232 registers, the producers 40);
//   - a tile of BM = 128 or 256 rows x the whole N. A ring of 2-8 stages of
//     64-deep chunks of w (64 x N; kcat's also hold BM x 64 of A), one
//     128-byte row per chunk row under the TMA's 128-byte swizzle, with full
//     and empty mbarriers; wgmma.m64nNk16 reads A K-major and w MN-major
//     (its transpose bit) through descriptors that match that swizzle;
//   - persistent blocks, as many as the SMs hold, so one unit's epilogue
//     overlaps the next unit's loads. The (step, tile) units, tile after
//     tile, are cut into equal slices, one for each group of about 32
//     consecutive blocks (KcatWalk): a group's blocks read one tile's rows
//     of x together, which L2 serves far faster than rows read apart
//     (walked step after step, bigdot drew about 8 TB/s from L2 and lost to
//     cuBLAS), and they stay on that tile however far they drift over a
//     long launch (a stride walk does not: over the probe tool's launches
//     of tens of ms it fell back to the step-after-step rate). The epilogue
//     rounds to bf16 once and stores 16 bytes a lane after a quad transpose.
//   * kcat_gemm_kernel (bigdot, imcat): one GEMM over the concatenated depth.
//     At N=64 each unit re-reads its BM x depth rows of x from L2 for as
//     many operations as bytes x 64: a launch of bigdot at K=1792 moves
//     1.93 GB at BM=256, and the walk's order decides how fast L2 gives it.
//       - bigdot: A chunks are TMA boxes of x (zero-filled past row M);
//       - imcat: the tile's x slab, (BM+8) rows x K, is loaded once a unit by
//         TMA under the same swizzle, and the patch matrix is a ring of BM x 64
//         chunks, no longer a slab held whole (at 32 x 1792 it took half the
//         SM's shared memory, forced 32-row tiles, below wgmma's 64, and was
//         built before the first product). Chunk c is columns 64c .. 64c+63
//         of X_cat: column block t = 64c / K at column 64c mod K, the window
//         S(off(t)). Rows r and r+8 share a phase of the swizzle, so the
//         build is a straight 16-byte copy from the slab, by the build
//         warps while wgmma consumes earlier chunks; the copy is what this
//         probe measures (the tap kernel reads the slab in place).
//     The host's plan (kcat) takes BM = 256 where its slab and 3 stages fit,
//     then the deepest ring that fits, and groups of 32 blocks: the fastest
//     tile and ring at 132 steps among the variants timed on an H100
//     (PERF.md), and within 3 % of the best number of groups there. Over
//     the probe tool's launches one group (all blocks on one tile) is
//     faster still for bigdot at depth >= 896, N=64, but costs depth 448 a
//     fifth; no one walk is best for every shape.
//   * tap_wgmma_kernel (probe, paircat, carry): the tap loop is one GEMM over
//     depth inner*K, w viewed as (inner*K, N) (probe's and carry's (inner, K,
//     N) and paircat's (inner/2, 2K, N) are both that array), whose A is read
//     in place from the unit's x slab: (BM+8) rows x K, K/64 column boxes
//     under the same swizzle, loaded once a unit by TMA (a BM-row box and an
//     8-row halo box; double-buffered where shared memory allows, so the
//     next unit's slab arrives during this one). Chunk c is tap t = c / (K/64)
//     at column box c mod (K/64), the window S(off(t)): off(t) = (t&1)*8 for
//     probe and carry, paircat's pair order for paircat. Rows r and r+8
//     share a phase of the swizzle (8 rows of 128 B are its 1,024-byte
//     period), so wgmma's A descriptor starts off rows down the box and
//     nothing is copied: a unit reads its slab and w from L2, about 255 KB
//     at BM=256, K=N=64, against bigdot's 1.15 MB. What differs is where
//     the f32 sum lives between taps, the structure each TPU probe measured:
//       - carry (ACC in registers): a unit is one sub-tile of a (step, mt-row
//         tile): the mt rows are covered by ceil(mt/BM) sub-tiles of BM rows,
//         each with its sum in registers through all taps, as kcat's are.
//         Rows past the mt tile are computed from x's rows (zeros past M+8)
//         and not stored. mt no longer bounds the registers (an mt x N
//         accumulator held whole spills past mt of about 1,000), and no
//         longer decides where the sum lives: past 256 rows carry measures
//         sub-tiles of 128 or 256 rows, each accumulated in registers, and
//         the rows its last sub-tile recomputes, not an mt-row sum carried
//         across the taps as the TPU probe's was. At BM=128
//         a consumer has one m64 tile, so its k16 steps alternate between
//         two accumulators (two independent wgmma chains in flight, which
//         ran faster on an H100 than one), summed before the store;
//       - probe, paircat (ACC in shared memory): each tap's (paircat: each
//         pair's) product goes to fresh registers (scale_d = 0 at its first
//         k16) and each thread then adds it to its own elements of a BM x N
//         f32 tile in shared memory, laid out in fragment order: 16 bytes a
//         lane, the lanes of a warp on consecutive words, so no bank conflict
//         and no barrier between threads. Two register sets overlap the
//         read-modify-write with the tensor cores: tap i+1 is issued into
//         one while tap i's set is added (the first tap is stored, the last
//         is added in registers and rounded); ptxas, unable to tell that
//         the RMW reads only a set whose wgmma is done, serializes these
//         kernels' wgmma (its C7514 note). The RMW moves 8 B of shared
//         memory per output element a tap for 2K operations; against about
//         128 B/clk of shared memory and 4,000 bf16 operations/clk an SM it
//         caps probe at K=64 near a third to a half of the peak (depth 128
//         a RMW, paircat and K >= 128, far less). So at K = 64 the A
//         fragments of both windows are loaded from the slab into registers
//         once a unit (64 registers at BM=256) and wgmma takes A from them:
//         it then reads only w from shared memory, half its operand bytes.
//         (On an H100 that made probe and paircat at K=64 faster; at K >=
//         128 loading each chunk's A into registers ran slower than wgmma
//         reading it from shared memory, and so did carry, PERF.md.)
//     The host's plan (tap): carry takes the BM of 128 and 256 that computes
//     the fewest rows; probe and paircat BM = 256 where the slab, the
//     accumulator and 3 stages fit at N=64 (at N=128 two register sets of
//     BM/2 x 128 would not fit, so 128); two slabs where they fit beside 3
//     stages, then the deepest ring.
// M need not be a multiple of a tile (3248 = 16 * 203): the last tile
// zero-fills the rows past x's end and stores only rows < M.
#include <cuda.h>  // CUtensorMap; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <mutex>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kHalo = 8;         // rows of x past a tile that a tap reads
constexpr size_t kMaxSmem = 232448;
// a chunk is 64 bf16 deep, one 128-byte row of the TMA swizzle
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
constexpr int kMaxSlabs = 2;        // tap: x slabs in flight
constexpr size_t kTapBarBytes =
    (2 * kMaxStages + 2 * kMaxSlabs) * sizeof(uint64_t);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// The same with A (64 x 16) from registers: per warp of the warpgroup,
// its 16 rows as mma.m16n8k16's A fragment.
template <int N>
struct WgmmaRegA;

template <>
struct WgmmaRegA<64> {
  __device__ __forceinline__ static void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : KC_D8(0), KC_D8(8), KC_D8(16), KC_D8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaRegA<128> {
  __device__ __forceinline__ static void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, "
        "%67}, %68, p, 1, 1, 1;\n}\n"
        : KC_D8(0), KC_D8(8), KC_D8(16), KC_D8(24), KC_D8(32), KC_D8(40),
          KC_D8(48), KC_D8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
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

// ---- tap_wgmma: probe, paircat and carry -----------------------------------

constexpr uint32_t kAccLaneBytes = 16;             // one float4 a lane
constexpr uint32_t kAccStride = 128 * kAccLaneBytes;  // a warpgroup's float4s

__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, float x, float y,
                                       float z, float w) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(x), "f"(y), "f"(z), "f"(w)
               : "memory");
}

// The thread's own elements of the shared f32 accumulator, in fragment
// order: float4 q of m64 tile mt at acc + (mt * N/8 + q) * kAccStride.
// rmw: acc (+)= d, storing d where `first`; add: d += acc.
template <int N, int MT>
__device__ __forceinline__ void acc_rmw(uint32_t acc, float (&d)[MT][N / 2],
                                        bool first) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    fence_regs(d[mt]);
#pragma unroll
    for (int q = 0; q < N / 8; ++q) {
      const uint32_t a = acc + (mt * (N / 8) + q) * kAccStride;
      const float* v = d[mt] + 4 * q;
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
      if (!first) o = lds128(a);
      sts128(a, o.x + v[0], o.y + v[1], o.z + v[2], o.w + v[3]);
    }
  }
}

template <int N, int MT>
__device__ __forceinline__ void acc_add(uint32_t acc, float (&d)[MT][N / 2]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    fence_regs(d[mt]);
#pragma unroll
    for (int q = 0; q < N / 8; ++q) {
      const float4 o = lds128(acc + (mt * (N / 8) + q) * kAccStride);
      d[mt][4 * q] += o.x;
      d[mt][4 * q + 1] += o.y;
      d[mt][4 * q + 2] += o.z;
      d[mt][4 * q + 3] += o.w;
    }
  }
}

// A consumer warpgroup's side of the w ring: the stage it reads next, and
// the one it read last, released once the chunk after it is issued.
struct TapRing {
  uint32_t full, empty, ph;
  int stages, s, prev;
  bool leader;
  __device__ __forceinline__ TapRing(uint32_t full_, uint32_t empty_,
                                     int stages_, bool leader_)
      : full(full_), empty(empty_), ph(0), stages(stages_), s(0), prev(0),
        leader(leader_) {}
  __device__ __forceinline__ int wait() {
    mbar_wait(full + 8 * s, ph);
    return s;
  }
  // the chunk just issued stays in flight; the one before it is done
  __device__ __forceinline__ void next(bool release) {
    wgmma_wait<1>();
    if (release && leader) mbar_arrive(empty + 8 * prev);
    prev = s;
    if (++s == stages) s = 0, ph ^= 1;
  }
  __device__ __forceinline__ void drain() {
    wgmma_wait<0>();
    if (leader) mbar_arrive(empty + 8 * prev);
  }
};

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// wgmma's register A of the consumer's rows of one column box: a[mt][kk]
// for step kk of m64 tile mt, the rows starting at `rows`, the box's first
// row or 8 rows down (a 1,024-byte phase of the box). The 128-byte swizzle
// keeps 16-byte chunk c of row r at chunk c ^ (r % 8).
template <int MT>
__device__ __forceinline__ void load_a(uint32_t (&a)[MT][4][4],
                                       uint32_t rows) {
  const int lane = threadIdx.x & 31, q = lane >> 2;
  const uint32_t base = rows +
                        ((threadIdx.x % 128) / 32 * 16 + q) * kRowBytes +
                        (lane & 3) * 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[mt][kk][r] = lds32(base + (mt * 64 + (r & 1) * 8) * kRowBytes +
                             (((kk * 2 + (r >> 1)) ^ q) << 4));
}

// The k16 steps of one chunk into d, w at b0 and A from the slab: at a0,
// read in place through a descriptor, or with REG_A from the registers af;
// step kk goes to chain kk % CH of its m64 tile, and each chain's first step
// (first: the first chunk) overwrites it (scale_d = 0).
template <int N, int MT, int CH, bool REG_A>
__device__ __forceinline__ void tap_steps(float (&d)[MT * CH][N / 2],
                                          const uint32_t (&af)[MT][4][4],
                                          uint32_t a0, uint32_t b0,
                                          bool first) {
  constexpr uint32_t kNBlock = kChunk * kRowBytes;
#pragma unroll
  for (int kk = 0; kk < kChunk / 16; ++kk) {
    const uint64_t db = sw128_desc(b0 + kk * 16 * kRowBytes, kNBlock,
                                   8 * kRowBytes);
    const int scale = !first || kk >= CH;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if constexpr (REG_A)
        WgmmaRegA<N>::mma(d[mt * CH + kk % CH], af[mt][kk], db, scale);
      else
        Wgmma<N>::mma(d[mt * CH + kk % CH],
                      sw128_desc(a0 + mt * 64 * kRowBytes + kk * 32, 16,
                                 8 * kRowBytes),
                      db, scale);
    }
  }
}

// Chunk c of a unit into d (first: the first chunk of d): tap t = c / kbs
// at the slab's column box c mod kbs, the window off(t) rows down (slab: the
// consumer's first row of box 0). With REG_A (K = 64, so t = c) A comes from
// a, both windows' registers (load_a).
template <int N, int BM, int CH, bool REG_A>
__device__ __forceinline__ void tap_chunk(
    float (&d)[BM / 128 * CH][N / 2], TapRing& ring, uint32_t w_ring,
    uint32_t slab, const uint32_t (&a)[2][BM / 128][4][4], int c, bool first,
    int kbs, int pair) {
  constexpr int MT = BM / 128;
  constexpr uint32_t kW = kChunk * N * 2;
  constexpr uint32_t kSlabBox = (BM + kHalo) * kRowBytes;
  const int t = REG_A ? c : c / kbs;
  const int win = pair ? ((t >> 1) + (t & 1)) & 1 : t & 1;  // off(t) / 8
  const uint32_t a0 =
      slab + (c - t * kbs) * kSlabBox + win * kHalo * kRowBytes;
  const uint32_t b0 = w_ring + ring.wait() * kW;
#pragma unroll
  for (int m = 0; m < MT * CH; ++m) fence_regs(d[m]);
  wgmma_fence();
  if constexpr (REG_A) {
    // one copy of the steps for each window: a is indexed statically
#pragma unroll
    for (int w = 0; w < 2; ++w)
      if (w == win) tap_steps<N, MT, CH, true>(d, a[w], a0, b0, first);
  } else {
    tap_steps<N, MT, CH, false>(d, a[0], a0, b0, first);
  }
  wgmma_commit();
#pragma unroll
  for (int m = 0; m < MT * CH; ++m) fence_regs(d[m]);
  ring.next(c > 0);
}

// Chunks c0 .. c0+n-1 of a unit into d, with PAIRS two to an iteration of
// the loop (carry ran 3-7 % faster so on an H100; probe and paircat did
// not gain).
template <int N, int BM, int CH, bool REG_A, bool PAIRS>
__device__ __forceinline__ void tap_chunks(
    float (&d)[BM / 128 * CH][N / 2], TapRing& ring, uint32_t w_ring,
    uint32_t slab, const uint32_t (&a)[2][BM / 128][4][4], int c0, int n,
    int kbs, int pair) {
  for (int i = 0; i < n; i += PAIRS ? 2 : 1) {
    tap_chunk<N, BM, CH, REG_A>(d, ring, w_ring, slab, a, c0 + i, i == 0, kbs,
                                pair);
    if (PAIRS && i + 1 < n)
      tap_chunk<N, BM, CH, REG_A>(d, ring, w_ring, slab, a, c0 + i + 1, false,
                                  kbs, pair);
  }
}

// probe's and paircat's taps of a unit (paircat: its pairs), each of `group`
// chunks: tap j into p0 (j even) or p1, the set of tap j-1 added to the
// shared accumulator while tap j runs. Returns whether the last tap is in
// p1; it is still to be added (acc_store).
template <int N, int BM, bool REG_A>
__device__ __forceinline__ bool rmw_taps(
    float (&p0)[BM / 128][N / 2], float (&p1)[BM / 128][N / 2],
    TapRing& ring, uint32_t w_ring, uint32_t slab,
    const uint32_t (&a)[2][BM / 128][4][4], uint32_t acc, int taps,
    int group, int kbs, int pair) {
  constexpr int MT = BM / 128;
  for (int j = 0; j < taps; j += 2) {
    tap_chunks<N, BM, 1, REG_A, false>(p0, ring, w_ring, slab, a, j * group,
                                       group, kbs, pair);
    if (j > 0) acc_rmw<N, MT>(acc, p1, false);
    if (j + 1 < taps) {
      tap_chunks<N, BM, 1, REG_A, false>(p1, ring, w_ring, slab, a,
                                         (j + 1) * group, group, kbs, pair);
      acc_rmw<N, MT>(acc, p0, j == 0);
    }
  }
  return ((taps - 1) & 1) != 0;
}

// The last tap's set d plus the shared accumulator (none with one tap),
// rounded and stored: rows row + m*64 .. of the consumer, those < limit.
template <int N, int MT>
__device__ __forceinline__ void acc_store(bf16* out, uint32_t acc,
                                          float (&d)[MT][N / 2], bool add,
                                          int row, int limit) {
  if (add) acc_add<N, MT>(acc, d);
#pragma unroll
  for (int m = 0; m < MT; ++m) store_m64<N>(out, row + m * 64, limit, d[m]);
}

// probe (pair = 0) and paircat (pair = 1) with SMEM_ACC; carry without.
// x (M+8, K) through tm_x (box 64 x BM) and tm_halo (box 64 x 8); w viewed
// as (inner*K, N) through tm_w (box 64 x 64). Unit `tile` of the walk is
// rows row0 = (tile / subs) * mt + (tile % subs) * BM .. row0 + BM - 1, of
// which rows below (tile / subs) * mt + mt and M are stored; probe and
// paircat pass mt = BM and subs = 1.
template <int N, int BM, bool SMEM_ACC>
__global__ void __launch_bounds__(kKcatThreads, 1)
tap_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_halo,
                 const __grid_constant__ CUtensorMap tm_w,
                 bf16* __restrict__ out, int M, int K, int inner, int pair,
                 int mt, int subs, int tiles, int steps, int stages,
                 int slabs, int groups) {
  constexpr int MT = BM / 128;                 // m64 tiles a consumer
  constexpr uint32_t kW = kChunk * N * 2;      // w chunk bytes
  constexpr uint32_t kNBlock = kChunk * kRowBytes;  // one 64-column w box
  constexpr uint32_t kSlabBox = (BM + kHalo) * kRowBytes;
  constexpr uint32_t kAccBytes = SMEM_ACC ? BM * N * 4 : 0;
  extern __shared__ unsigned char tap_smem[];
  // the 128-byte swizzle repeats every 1,024 bytes: align the ring to it
  const uint32_t ring = (smem_u32(tap_smem) + 1023) & ~1023u;
  const int kbs = K / kChunk;
  const int chunks = inner * kbs;
  const uint32_t slab_bytes = kbs * kSlabBox;
  const uint32_t slab0 = ring + stages * kW;
  const uint32_t acc = slab0 + slabs * slab_bytes;
  const uint32_t full = acc + kAccBytes;
  const uint32_t empty = full + kMaxStages * 8;
  const uint32_t slab_full = empty + kMaxStages * 8;
  const uint32_t slab_empty = slab_full + kMaxSlabs * 8;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);                 // one per consumer
    }
    for (int b = 0; b < slabs; ++b) {
      mbar_init(slab_full + 8 * b, 1);
      mbar_init(slab_empty + 8 * b, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: thread 0 loads each unit's slab, then w a chunk ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs)
                 : "memory");
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t ph = 0;
      unsigned n = 0;                              // units of this block
      for (KcatWalk u(tiles, steps, groups); u.more(); u.next(), ++n) {
        const int t = u.tile();
        const int row0 = t / subs * mt + t % subs * BM;
        const unsigned b = n % slabs, use = n / slabs;
        const uint32_t slab = slab0 + b * slab_bytes;
        // once both consumers are done with this buffer's last slab
        mbar_wait(slab_empty + 8 * b, (use & 1) ^ 1);
        mbar_arrive_tx(slab_full + 8 * b, slab_bytes);
        for (int kb = 0; kb < kbs; ++kb) {
          tma_load(slab + kb * kSlabBox, &tm_x, slab_full + 8 * b,
                   kb * kChunk, row0);
          tma_load(slab + kb * kSlabBox + BM * kRowBytes, &tm_halo,
                   slab_full + 8 * b, kb * kChunk, row0 + BM);
        }
        for (int c = 0; c < chunks; ++c) {
          mbar_wait(empty + 8 * s, ph ^ 1);
          const uint32_t st = ring + s * kW;
          mbar_arrive_tx(full + 8 * s, kW);
#pragma unroll
          for (int nb = 0; nb < N / 64; ++nb)
            tma_load(st + nb * kNBlock, &tm_w, full + 8 * s, nb * 64,
                     c * kChunk);
          if (++s == stages) s = 0, ph ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroups: rows g*BM/2 .. of each unit ---------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs)
                 : "memory");
    const int g = wg - 1;
    const bool leader = threadIdx.x % 128 == 0;
    const uint32_t accp =
        acc + g * (kAccBytes / 2) + (threadIdx.x % 128) * kAccLaneBytes;
    TapRing wr(full, empty, stages, leader);
    // the tap (paircat: the pair) a shared-memory read-modify-write follows
    const int group = pair ? 2 * kbs : kbs, taps = chunks / group;
    unsigned n = 0;
    for (KcatWalk u(tiles, steps, groups); u.more(); u.next(), ++n) {
      const int t = u.tile();
      const int first = t / subs * mt;
      const int row0 = first + t % subs * BM;
      const int limit = first + mt < M ? first + mt : M;
      const int row = row0 + g * (BM / 2) + (threadIdx.x % 128) / 32 * 16;
      const unsigned b = n % slabs;
      mbar_wait(slab_full + 8 * b, (n / slabs) & 1);
      const uint32_t slab = slab0 + b * slab_bytes + g * (BM / 2) * kRowBytes;
      uint32_t a[2][MT][4][4];
      if constexpr (SMEM_ACC) {
        // at K = 64 both windows' A fragments stay in registers for the
        // unit, so wgmma reads only w from the shared memory that the
        // read-modify-write keeps busy
        float p0[MT][N / 2], p1[MT][N / 2];
        bool last_p1;
        if (kbs == 1) {
          load_a<MT>(a[0], slab);
          load_a<MT>(a[1], slab + kHalo * kRowBytes);
          last_p1 = rmw_taps<N, BM, true>(p0, p1, wr, ring, slab, a, accp,
                                          taps, group, kbs, pair);
        } else {
          last_p1 = rmw_taps<N, BM, false>(p0, p1, wr, ring, slab, a, accp,
                                           taps, group, kbs, pair);
        }
        wr.drain();
        if (leader) mbar_arrive(slab_empty + 8 * b);
        if (last_p1)
          acc_store<N, MT>(out, accp, p1, true, row, limit);
        else
          acc_store<N, MT>(out, accp, p0, taps > 1, row, limit);
      } else {
        // carry's 128-row tiles (one m64 tile a consumer) alternate their
        // k16 steps between two accumulators: two independent wgmma chains
        // in flight, summed before the store
        constexpr int CH = MT == 1 ? 2 : 1;
        float p0[MT * CH][N / 2];
        tap_chunks<N, BM, CH, false, true>(p0, wr, ring, slab, a, 0, chunks,
                                           kbs, pair);
        wr.drain();
        if (leader) mbar_arrive(slab_empty + 8 * b);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
#pragma unroll
          for (int h = 0; h < CH; ++h) fence_regs(p0[m * CH + h]);
#pragma unroll
          for (int h = 1; h < CH; ++h)
#pragma unroll
            for (int e = 0; e < N / 2; ++e)
              p0[m * CH][e] += p0[m * CH + h][e];
          store_m64<N>(out, row + m * 64, limit, p0[m * CH]);
        }
      }
    }
  }
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

size_t tap_smem_bytes(int bm, int stages, int slabs, int K, int N,
                      bool smem_acc) {
  return 1024 + (size_t)stages * kChunk * N * 2 +
         (size_t)slabs * (K / kChunk) * (bm + kHalo) * kRowBytes +
         (smem_acc ? (size_t)bm * N * 4 : 0) + kTapBarBytes;
}

// The kind codes of mxu_fill_plan (ops/mxu_fill.py's KINDS).
enum Kind { kProbe = 0, kCarry = 1, kBigdot = 2, kImcat = 3, kPaircat = 4 };

struct Kcat {
  const bf16* x;
  const bf16* w;
  bf16* out;
  int M, K, N, inner, build, steps;
};

// probe, paircat and carry: inner taps of depth K (paircat: inner/2 pairs
// of depth 2K); mt is carry's tile.
struct Tap {
  const bf16* x;
  const bf16* w;
  bf16* out;
  int kind, M, K, N, inner, mt, steps;
};

// How a launch runs; mxu_fill_plan's info, in this order.
struct Plan {
  int bm, stages, smem, blocks, per_sm, units, groups, slabs, subtiles;
};

// SMs and blocks an SM of a kernel at `smem` bytes of dynamic shared memory
// on the current device, asked of the runtime once for each kernel, size
// and device. The kernel's shared-memory attribute, a cap, is set to the
// most a block may have, so every size a plan takes is allowed.
template <typename Kernel>
cudaError_t occupancy(Kernel kernel, size_t smem, int* sms, int* per_sm) {
  struct Seen {
    Kernel kernel;
    int dev;
    size_t smem;
    int sms, per_sm;
  };
  static std::mutex mu;
  static Seen seen[64];
  static int n_seen = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].kernel == kernel && seen[i].dev == dev &&
        seen[i].smem == smem) {
      *sms = seen[i].sms;
      *per_sm = seen[i].per_sm;
      return cudaSuccess;
    }
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                        kKcatThreads, smem);
  if (err == cudaSuccess && n_seen < 64)
    seen[n_seen++] = {kernel, dev, smem, *sms, *per_sm};
  return err;
}

// The grid of a persistent kernel over `tiles` x steps units on the current
// device: as many blocks as the SMs hold, in groups of about kGroupBlocks
// (KcatWalk). Fills every field of p but slabs and subtiles.
template <typename Kernel>
int persistent_grid(Kernel kernel, size_t smem, long long tiles, int steps,
                    int bm, int stages, Plan* p) {
  int sms = 0, per_sm = 0;
  const cudaError_t err = occupancy(kernel, smem, &sms, &per_sm);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long units = tiles * steps;
  if (units > INT_MAX) return (int)cudaErrorInvalidValue;
  const long long grid = units < (long long)sms * per_sm ? units
                                                         : (long long)sms * per_sm;
  const long long groups = grid / kGroupBlocks;
  *p = {bm, stages, (int)smem, (int)grid, per_sm, (int)units,
        groups > 1 ? (int)groups : 1, 0, 1};
  return 0;
}

template <int N, int BM, bool BUILD>
int kcat_launch(const Kcat& a, const Plan& p, cudaStream_t stream) {
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
int kcat(const Kcat& a, bool launch, cudaStream_t stream, Plan* p) {
  const bool build = a.build != 0;
  if (a.steps < 1) return (int)cudaErrorInvalidValue;
  const int bm =
      kcat_smem_bytes(256, 3, a.K, a.N, build) <= kMaxSmem ? 256 : 128;
  int stages = kMaxStages;
  while (stages > 2 && kcat_smem_bytes(bm, stages, a.K, a.N, build) > kMaxSmem)
    --stages;
  const size_t smem = kcat_smem_bytes(bm, stages, a.K, a.N, build);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
#define KCAT(n, tile, b)                                                    \
  if (a.N == n && bm == tile && build == b) {                               \
    int err = persistent_grid(kcat_gemm_kernel<n, tile, b>, smem,           \
                              (a.M + tile - 1) / tile, a.steps, tile,       \
                              stages, p);                                   \
    p->slabs = b;                                                           \
    return err || !launch ? err : kcat_launch<n, tile, b>(a, *p, stream);   \
  }
  KCAT(64, 256, false) KCAT(128, 256, false) KCAT(64, 128, true)
  KCAT(64, 256, true) KCAT(128, 128, true) KCAT(128, 256, true)
#undef KCAT
  return (int)cudaErrorInvalidValue;
}

template <int N, int BM, bool SMEM_ACC>
int tap_launch(const Tap& a, const Plan& p, cudaStream_t stream) {
  const bool carry = a.kind == kCarry;
  CUtensorMap tx, th, tw;
  if (!tensor_map(&tx, a.x, a.M + kHalo, a.K, BM) ||
      !tensor_map(&th, a.x, a.M + kHalo, a.K, kHalo) ||
      !tensor_map(&tw, a.w, a.inner * a.K, N, kChunk))
    return (int)cudaErrorInvalidValue;
  tap_wgmma_kernel<N, BM, SMEM_ACC><<<p.blocks, kKcatThreads, p.smem,
                                      stream>>>(
      tx, th, tw, a.out, a.M, a.K, a.inner, (int)(a.kind == kPaircat),
      carry ? a.mt : BM, p.subtiles,
      p.units / a.steps, a.steps, p.stages, p.slabs, p.groups);
  return (int)cudaGetLastError();
}

// Plan and, with launch, run one tap launch. carry takes the tile of 128
// and 256 rows that computes the fewest rows of its mt-row tiles (256 on a
// tie); probe and paircat 256 where the slab, the shared accumulator and
// 3 stages fit at N=64, else 128 (at N=128 two register sets of 128 rows
// take all of a consumer's registers). Then two slabs where they fit beside
// 3 stages, and the deepest ring.
int tap(const Tap& a, bool launch, cudaStream_t stream, Plan* p) {
  const bool carry = a.kind == kCarry, smem_acc = !carry;
  if (a.steps < 1 || a.K < kChunk || a.K % kChunk || a.inner < 1 ||
      (a.kind == kPaircat && a.inner % 2) || (carry && (a.mt < 1 ||
                                                         a.M % a.mt)))
    return (int)cudaErrorInvalidValue;
  const auto fits = [&](int bm, int slabs, int stages) {
    return tap_smem_bytes(bm, stages, slabs, a.K, a.N, smem_acc) <= kMaxSmem;
  };
  int bm = 128;
  if (carry)
    bm = fits(256, 1, 3) && (a.mt + 255) / 256 * 2 <= (a.mt + 127) / 128
             ? 256 : 128;
  else if (a.N == 64 && fits(256, 1, 3))
    bm = 256;
  const int slabs = fits(bm, 2, 3) ? 2 : 1;
  int stages = kMaxStages;
  while (stages > 2 && !fits(bm, slabs, stages)) --stages;
  if (!fits(bm, slabs, stages)) return (int)cudaErrorInvalidValue;
  const size_t smem = tap_smem_bytes(bm, stages, slabs, a.K, a.N, smem_acc);
  const int subs = carry ? (a.mt + bm - 1) / bm : 1;
  const long long tiles =
      carry ? (long long)(a.M / a.mt) * subs : (a.M + bm - 1) / bm;
#define TAP(n, tile, acc)                                                   \
  if (a.N == n && bm == tile && smem_acc == acc) {                          \
    int err = persistent_grid(tap_wgmma_kernel<n, tile, acc>, smem, tiles,  \
                              a.steps, tile, stages, p);                    \
    p->slabs = slabs;                                                       \
    p->subtiles = subs;                                                     \
    return err || !launch ? err : tap_launch<n, tile, acc>(a, *p, stream);  \
  }
  TAP(64, 256, true) TAP(128, 128, true) TAP(64, 128, false)
  TAP(64, 256, false) TAP(128, 128, false) TAP(128, 256, false)
#undef TAP
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shapes are validated by the Python wrappers (ops/mxu_fill.py): N is 64 or
// 128, K % 64 == 0 and the tap depth (K, or 2K with pair) <= 256; inner is
// the number of taps (even with pair). The plan picks the tile and the ring.
int mxu_fill_tap(const void* x, const void* w, void* out, int M, int K, int N,
                 int inner, int pair, int steps, cudaStream_t stream) {
  Plan p;
  return tap({static_cast<const bf16*>(x), static_cast<const bf16*>(w),
              static_cast<bf16*>(out), pair ? kPaircat : kProbe, M, K, N,
              inner, 0, steps},
             true, stream, &p);
}

// M % mt == 0, K % 64 == 0, K <= 256.
int mxu_fill_carry(const void* x, const void* w, void* out, int M, int mt,
                   int K, int N, int inner, int steps, cudaStream_t stream) {
  Plan p;
  return tap({static_cast<const bf16*>(x), static_cast<const bf16*>(w),
              static_cast<bf16*>(out), kCarry, M, K, N, inner, mt, steps},
             true, stream, &p);
}

// bigdot (build = 0): K % 64 == 0. imcat (build = 1): K % 64 == 0, K <= 256,
// inner even. The plan picks the tile and the ring.
int mxu_fill_kcat(const void* x, const void* w, void* out, int M, int K,
                  int N, int inner, int build, int steps,
                  cudaStream_t stream) {
  Plan p;
  return kcat({static_cast<const bf16*>(x), static_cast<const bf16*>(w),
               static_cast<bf16*>(out), M, K, N, inner, build, steps},
              true, stream, &p);
}

// The plan of a launch of probe (kind 0), carry (1), bigdot (2), imcat (3)
// or paircat (4) without launching it: info[0..8] = BM, ring stages, dynamic
// shared memory bytes, persistent blocks, blocks an SM, (step, tile) units,
// groups of the walk, x slabs (0 for bigdot) and sub-tiles of a carry tile
// (1 for the others).
int mxu_fill_plan(int kind, int M, int K, int N, int inner, int mt, int steps,
                  int* info) {
  if (kind < kProbe || kind > kPaircat) return (int)cudaErrorInvalidValue;
  Plan p;
  const int err =
      kind == kBigdot || kind == kImcat
          ? kcat({nullptr, nullptr, nullptr, M, K, N, inner,
                  kind == kImcat, steps},
                 false, nullptr, &p)
          : tap({nullptr, nullptr, nullptr, kind, M, K, N, inner, mt, steps},
                false, nullptr, &p);
  if (err == 0) {
    const int vals[9] = {p.bm,    p.stages, p.smem,  p.blocks,  p.per_sm,
                         p.units, p.groups, p.slabs, p.subtiles};
    for (int i = 0; i < 9; ++i) info[i] = vals[i];
  }
  return err;
}

}  // extern "C"
