// RAFT correlation lookup for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernels of mscl_tpu/ops/corr_lookup.py, which
// compute one function:
//   _corr_kernel_v2 (via corr_lookup_pallas_v2, the TPU production path) and
//   _corr_kernel    (via corr_lookup_pallas, the v1 per-pixel lowering).
// For each query pixel p of image n and each pyramid level l, the
// (2r+1)^2 bilinear window (zero padding, align_corners=True) at
// coords[n,p] / 2^l of corr_l(q) = f1[n,p] . f2_l[n,q] / sqrt(C), where f2_l
// is f2 2x2-mean-pooled l times (odd last rows and columns dropped). The
// (HW)^2 correlation volume is never built.
//
// Layout (float32, contiguous): f1 (N,H,W,C); coords (N,H,W,2) as (x, y)
// pixels; pyramid: levels l = 0..L-1 of (N, H>>l, W>>l, C) back to back;
// out (N,H,W,L,(2r+1)^2), taps dy-major within a level.
//
// What bounds it on an H100. Counted once, the inputs and output are small
// (10.3 MB at RAFT's extraction shape, 16x22 N=8, C=256, L=4, r=4) and the
// in-range corners cost 2*C float32 operations each (up to 1.44 GFLOP at
// 55x128): 3-15 us. What a design moves on chip decides the time: a gather
// of each corner's C-float f2 row, once per (pixel, corner), moves 0.3 GB
// at 16x22 and 2 GB at 55x128 through L1/L2, though neighbouring windows
// overlap heavily. Staging each tile's window union once cuts that to
// 57-117 MB at 16x22; what is left is the product itself, float32 FMA
// over every (tile pixel, staged position) pair a warp cannot skip, fed by
// one broadcast shared load per 4 FMAs a lane.
//
// Design: one block of 8 warps per tile of kTileH x kTileW query pixels of
// one image; the block walks all L levels, so the tile's f1 rows are read
// once (into shared memory, zero-padded to whole kChunk-channel chunks).
//   * At each level the block takes the union box of its pixels' in-range
//     windows (window start floor(coords / 2^l) - r, clamped to +-65536 as
//     the plain version does; clipped to the level; tiles never cross
//     images). A window wholly off the level adds nothing; a level with no
//     in-range corner stages nothing and writes zeros.
//   * The box's positions, row-major, are cut into sets of 32, one position
//     a lane. A warp takes a set (and, where a level has fewer sets than
//     warps, a share of its channel chunks, so small levels still use every
//     warp) and stages it kChunk channels at a time into its own ring of
//     kStages slots in shared memory by 16-byte cp.async (the lanes copying
//     a position's chunk read contiguous bytes; rows XOR-swizzled by 16-byte
//     slot, so each lane reading its own row is free of bank conflicts).
//     Positions that lie in no pixel's window are not copied; a set with
//     none is skipped. A box of any size, up to the whole level, is walked
//     the same way: there is no second path.
//   * Position-major product: a lane reads its position's staged chunk
//     into registers once and dots it with the same chunk of each tile
//     pixel's f1 row (a broadcast shared load), four pixels at a time,
//     keeping one float32 sum a pixel across the chunks. A group of four
//     pixels none of whose windows holds a position of the warp is skipped
//     by the warp, so corners off the level and positions no window holds
//     cost no operations. Each (pixel, corner) sum is written once, into
//     the tile's corner table; the shares of a split set are added in a
//     fixed order after a barrier. Every sum is taken in an
//     order fixed by the inputs: two calls give the same bits.
//   * The lanes blend the (2r+1)^2 outputs of each pixel from four corner
//     sums each with fx, fy = frac(coords / 2^l).
// All arithmetic is float32 FMA (no TF32: the lookup is held to 1e-5).
#include <cuda_runtime.h>

#include <climits>
#include <mutex>

namespace {

constexpr int kTileH = 2, kTileW = 4;
constexpr int kPixels = kTileH * kTileW;     // query pixels a block
constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int kChunk = 8;                    // channels a stage
constexpr int kParts = kChunk / 4;           // 16-byte copies a row
constexpr int kStages = 4;                   // ring slots a warp
constexpr int kSlot = 32 * kChunk;           // floats: a row a lane
constexpr int kMaxC = 256, kMaxRadius = 8;

static_assert(kPixels % 4 == 0 && kPixels <= 32, "pixel groups and masks");
static_assert(kParts == 2 || kParts == 4 || kParts == 8, "row swizzle");
static_assert(kPixels * 32 <= kStages * kSlot, "shares fit the ring");

__host__ __device__ constexpr int chunk_pad(int C) {
  return (C + kChunk - 1) / kChunk * kChunk;
}

__host__ __device__ constexpr size_t smem_bytes(int C, int r) {
  return sizeof(float) * ((size_t)kWarps * kStages * kSlot +
                          (size_t)kPixels * chunk_pad(C) +
                          (size_t)kPixels * (2 * r + 2) * (2 * r + 2));
}

constexpr size_t kMaxSmem = smem_bytes(kMaxC, kMaxRadius);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; zero-fills if !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
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
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

__device__ __forceinline__ bool holds(int4 rc, int x, int y) {
  return x >= rc.x && x < rc.y && y >= rc.z && y < rc.w;
}

// Bit p set where (x, y) lies in pixel p's in-range window rect.
__device__ __forceinline__ uint32_t window_mask(const int4* rect, int x,
                                                int y) {
  uint32_t m = 0;
#pragma unroll
  for (int p = 0; p < kPixels; ++p) m |= (uint32_t)holds(rect[p], x, y) << p;
  return m;
}

// Float4 slot j of ring row q: XOR-swizzled by the row's place among the
// 8 / kParts rows that share 128 bytes, so the 8 lanes of a quarter warp
// reading slot j of 8 consecutive rows touch 8 distinct groups of 4 banks.
__device__ __forceinline__ int swizzle(int q, int j) {
  return q * kChunk + 4 * (j ^ (q / (8 / kParts) % kParts));
}

constexpr int kMinBlocks = 3;               // resident blocks an SM

__global__ void __launch_bounds__(kThreads, kMinBlocks)
corr_lookup_tile_kernel(const float* __restrict__ f1,
                 const float* __restrict__ pyramid,
                 const float* __restrict__ coords, float* __restrict__ out,
                 int N, int H, int W, int C, int L, int r) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // [warp][slot][32][kChunk]
  const int cpad = chunk_pad(C);
  float* f1s = ring + kWarps * kStages * kSlot;    // [P][cpad]
  float* corner = f1s + kPixels * cpad;            // [P][(2r+2)^2]
  __shared__ int4 rect[kPixels];     // in-range window: x0, x1, y0, y1
  __shared__ int2 start[kPixels];    // window start (ix, iy), unclipped
  __shared__ float2 frac[kPixels];   // fx, fy

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tiles = tiles_x * ((H + kTileH - 1) / kTileH);
  const int n = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int ty0 = tile / tiles_x * kTileH, tx0 = tile % tiles_x * kTileW;

  // warp w loads and blends pixels w, w + kWarps, ... of the tile; the
  // tile's f1 rows, zero past C and for pixels off the image
  for (int p = warp; p < kPixels; p += kWarps) {
    const int y = ty0 + p / kTileW, x = tx0 + p % kTileW;
    const float* row = f1 + (((size_t)n * H + y) * W + x) * C;
    for (int c = 4 * lane; c < cpad; c += 128) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (y < H && x < W && c < C)
        v = *reinterpret_cast<const float4*>(row + c);
      *reinterpret_cast<float4*>(f1s + p * cpad + c) = v;
    }
  }
  // thread p < kPixels keeps its pixel's coords for every level
  float2 cxy = make_float2(0.f, 0.f);
  const int my_y = ty0 + tid / kTileW, my_x = tx0 + tid % kTileW;
  const bool my_in = tid < kPixels && my_y < H && my_x < W;
  if (my_in) {
    const size_t pix = ((size_t)n * H + my_y) * W + my_x;
    cxy = make_float2(coords[2 * pix], coords[2 * pix + 1]);
  }

  const int kc = 2 * r + 2, k = 2 * r + 1, ncorner = kc * kc;
  // blending: lane (dy0, dx) takes taps (dy0 + rows j, dx) of a pixel
  const int rows = 32 / k, bdy = lane / k, bdx = lane % k;
  const int nchunk = cpad / kChunk;
  const float sqrt_c = sqrtf((float)C);
  float* my_ring = ring + warp * kStages * kSlot;
  // copies: lane (a, e) moves 16-byte part e of rows kRowStep i + a
  constexpr int kRowStep = 32 / kParts;
  const int ca = lane / kParts, ce = lane % kParts;
  const float* level = pyramid;

  for (int l = 0; l < L; ++l) {
    const int hl = H >> l, wl = W >> l;
    const float* f2 = level + (size_t)n * hl * wl * C;
    if (tid < kPixels) {
      int4 rc = make_int4(0, 0, 0, 0);
      int2 st = make_int2(0, 0);
      float2 fr = make_float2(0.f, 0.f);
      if (my_in) {
        const float scale = 1.f / (float)(1 << l);  // a power of two: exact
        const float cx = cxy.x * scale, cy = cxy.y * scale;
        const float x0 = floorf(cx), y0 = floorf(cy);
        fr = make_float2(cx - x0, cy - y0);
        // the clamp only keeps the conversion to int defined: a window
        // this far off the level holds no corner
        st.x = (int)fminf(fmaxf(x0, -65536.f), 65536.f) - r;
        st.y = (int)fminf(fmaxf(y0, -65536.f), 65536.f) - r;
        rc = make_int4(max(st.x, 0), min(st.x + kc, wl), max(st.y, 0),
                       min(st.y + kc, hl));
        if (rc.x >= rc.y || rc.z >= rc.w) rc = make_int4(0, 0, 0, 0);
      }
      rect[tid] = rc;
      start[tid] = st;
      frac[tid] = fr;
    }
    for (int i = tid; i < kPixels * ncorner; i += kThreads) corner[i] = 0.f;
    __syncthreads();

    // the union box of the in-range windows (every thread alike)
    int bx0 = INT_MAX, bx1 = INT_MIN, by0 = INT_MAX, by1 = INT_MIN;
#pragma unroll
    for (int p = 0; p < kPixels; ++p) {
      const int4 rc = rect[p];
      if (rc.x < rc.y) {
        bx0 = min(bx0, rc.x);
        bx1 = max(bx1, rc.y);
        by0 = min(by0, rc.z);
        by1 = max(by1, rc.w);
      }
    }
    const int bw = bx1 > bx0 ? bx1 - bx0 : 0;
    const int npos = bw > 0 ? bw * (by1 - by0) : 0;
    const int sets = (npos + 31) / 32;
    // split each set's chunks into `split` shares where the sets alone
    // would leave warps idle
    int split = 1;
    while (2 * split <= nchunk && 2 * split * sets <= kWarps) split *= 2;

    for (int item = warp; item < sets * split; item += kWarps) {
      const int set = item / split, share = item % split;
      const int ch0 = share * nchunk / split;
      const int ch1 = (share + 1) * nchunk / split;
      const int idx = set * 32 + lane;
      const bool in = idx < npos;
      const int qy = by0 + (in ? idx / bw : 0);
      const int qx = bx0 + (in ? idx % bw : 0);
      const int off = (qy * wl + qx) * C;
      const uint32_t mine = in ? window_mask(rect, qx, qy) : 0u;
      const uint32_t held = __ballot_sync(0xffffffffu, mine != 0);
      if (!held) continue;
      const uint32_t warp_mask = __reduce_or_sync(0xffffffffu, mine);
      // copy i moves row kRowStep * i + ca, the position of that lane
      int src[kParts];
#pragma unroll
      for (int i = 0; i < kParts; ++i)
        src[i] = __shfl_sync(0xffffffffu, off, kRowStep * i + ca);

      // one commit group a chunk, empty past the share's last
      auto issue = [&](int ch) {
        if (ch < ch1) {
          float* slot = my_ring + ((ch - ch0) % kStages) * kSlot;
          const int c = ch * kChunk + 4 * ce;
#pragma unroll
          for (int i = 0; i < kParts; ++i) {
            const int q = kRowStep * i + ca;
            if (held >> q & 1)
              cp_async16(slot + swizzle(q, ce),
                         c < C ? f2 + src[i] + c : f2, c < C);
          }
        }
        cp_async_commit();
      };

      float acc[kPixels];
#pragma unroll
      for (int p = 0; p < kPixels; ++p) acc[p] = 0.f;
#pragma unroll
      for (int i = 0; i < kStages - 1; ++i) issue(ch0 + i);
      for (int ch = ch0; ch < ch1; ++ch) {
        issue(ch + kStages - 1);
        cp_async_wait<kStages - 1>();
        __syncwarp();  // every lane's copies of this chunk have landed
        const float* slot = my_ring + ((ch - ch0) % kStages) * kSlot;
        float4 b[kParts];
#pragma unroll
        for (int j = 0; j < kParts; ++j)
          b[j] = *reinterpret_cast<const float4*>(slot + swizzle(lane, j));
        const float* a = f1s + ch * kChunk;
#pragma unroll
        for (int p0 = 0; p0 < kPixels; p0 += 4) {
          if (!(warp_mask >> p0 & 0xFu)) continue;
          float s[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll
          for (int j = 0; j < kParts; ++j) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float4 v = *reinterpret_cast<const float4*>(
                  a + (p0 + i) * cpad + 4 * j);
              s[i][0] = fmaf(v.x, b[j].x, s[i][0]);
              s[i][1] = fmaf(v.y, b[j].y, s[i][1]);
              s[i][0] = fmaf(v.z, b[j].z, s[i][0]);
              s[i][1] = fmaf(v.w, b[j].w, s[i][1]);
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[p0 + i] += s[i][0] + s[i][1];
        }
        __syncwarp();  // this slot is read before it is refilled
      }
      if (split == 1) {
#pragma unroll
        for (int p = 0; p < kPixels; ++p)
          if (mine >> p & 1) {
            const int2 st = start[p];
            corner[p * ncorner + (qy - st.y) * kc + (qx - st.x)] =
                acc[p] / sqrt_c;
          }
      } else {
        // the share's sums, [pixel][lane], in the warp's idle ring (only
        // empty commit groups are still open)
#pragma unroll
        for (int p = 0; p < kPixels; ++p) my_ring[p * 32 + lane] = acc[p];
      }
    }
    __syncthreads();  // every corner sum (or share) of the level is in

    if (split > 1) {
      // a set's shares came from warps set * split + share (one item a
      // warp); lane q adds its position's in share order
      for (int set = 0; set < sets; ++set) {
        const int idx = set * 32 + lane;
        if (idx >= npos) break;
        const int qy = by0 + idx / bw, qx = bx0 + idx % bw;
        for (int p = warp; p < kPixels; p += kWarps) {
          if (!holds(rect[p], qx, qy)) continue;
          float v = 0.f;
          for (int sh = 0; sh < split; ++sh)
            v += ring[(set * split + sh) * kStages * kSlot + p * 32 + lane];
          const int2 st = start[p];
          corner[p * ncorner + (qy - st.y) * kc + (qx - st.x)] = v / sqrt_c;
        }
      }
      __syncthreads();
    }

    for (int p = warp; p < kPixels; p += kWarps) {
      const int y = ty0 + p / kTileW, x = tx0 + p % kTileW;
      if (y >= H || x >= W || bdy >= rows) continue;
      const float fx = frac[p].x, fy = frac[p].y;
      float* o = out + ((((size_t)n * H + y) * W + x) * L + l) *
                           (size_t)(k * k);
      for (int dy = bdy; dy < k; dy += rows) {
        const float* c0 = corner + p * ncorner + dy * kc + bdx;
        o[dy * k + bdx] =
            (1.f - fy) * (1.f - fx) * c0[0] + (1.f - fy) * fx * c0[1] +
            fy * (1.f - fx) * c0[kc] + fy * fx * c0[kc + 1];
      }
    }
    __syncthreads();  // rect, start, frac, corner and rings are reused next
    level += (size_t)N * hl * wl * C;
  }
}

// The kernel's dynamic shared memory may exceed 48 KB: raise its cap to the
// most any (C, r) needs, once per device.
cudaError_t allow_smem() {
  static std::mutex mu;
  static unsigned long long done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (dev < 64 && (done >> dev & 1)) return cudaSuccess;
  err = cudaFuncSetAttribute(corr_lookup_tile_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMaxSmem);
  if (err == cudaSuccess && dev < 64) done |= 1ull << dev;
  return err;
}

}  // namespace

extern "C" {

// Shapes are validated by the Python wrapper: C % 4 == 0, 4 <= C <= 256,
// 0 <= r <= 8, 1 <= L <= 8, N*H*W >= 1; an image's f2 rows are indexed in
// 32 bits.
int corr_lookup(const float* f1, const float* pyramid, const float* coords,
                float* out, int N, int H, int W, int C, int L, int r,
                cudaStream_t stream) {
  if (C < 4 || C > kMaxC || C % 4 || r < 0 || r > kMaxRadius ||
      (long long)H * W * C > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)N * ((H + kTileH - 1) / kTileH) *
                           ((W + kTileW - 1) / kTileW);
  if (blocks < 1 || blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  corr_lookup_tile_kernel<<<(unsigned)blocks, kThreads, smem_bytes(C, r), stream>>>(
      f1, pyramid, coords, out, N, H, W, C, L, r);
  return (int)cudaGetLastError();
}

// The launch at width C and radius r on the current device: info[] gets
// dynamic shared memory bytes, threads a block, blocks resident on one SM,
// registers a thread, tile height and width, positions and channels a warp
// stages at once, and ring slots a warp.
int corr_lookup_launch_info(int C, int r, int* info) {
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, corr_lookup_tile_kernel);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, corr_lookup_tile_kernel, kThreads, smem_bytes(C, r));
  if (e != cudaSuccess) return (int)e;
  const int vals[] = {(int)smem_bytes(C, r), kThreads, per_sm, attr.numRegs,
                      kTileH, kTileW, 32, kChunk, kStages};
  for (int i = 0; i < 9; ++i) info[i] = vals[i];
  return 0;
}

}  // extern "C"
