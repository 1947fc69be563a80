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
// What bounds it on an H100: operations. Each in-range corner costs 2*C
// float32 FMA operations; at most (2r+2)^2 corners per pixel and level. At
// RAFT's 55x128 (440x1024 images), C=256, L=4, r=4 that is up to 1.44 GFLOP
// (21.5 us at 67 TFLOP/s) against 25.8 MB of inputs and output (7.7 us at
// 3.35 TB/s).
//
// Design. The TPU kernels build a (tile, H*W) correlation slab per level and
// select windows with one-hot matmuls, because Mosaic has no gather; here the
// lookup is a gather, as the reference's alt_cuda_corr is:
//   * one warp per (n, p, l); a block's 8 warps take 8 consecutive pixels at
//     one level, so their windows overlap and the f2 rows they read are
//     shared through L1 (all levels together are at most 9.5 MB at 440x1024,
//     so they stay in L2);
//   * the warp's 32 lanes form 4 groups of 8; group g takes corners g, g+4,
//     ... of the (2r+2)^2 integer corners around floor(coords/2^l) - r. Each
//     lane holds its share of the pixel's f1 row in registers (float4s at
//     channels 4*lane8 + 32j) and reads the same share of a corner's
//     contiguous f2 row only if the corner is in range, so a group reads 128
//     contiguous bytes per load; 3 shuffles sum the dot product;
//   * corner sums (0 off the level) go to the warp's slice of shared memory,
//     and the lanes blend the (2r+1)^2 outputs from four corners each with
//     fx, fy = frac(coords / 2^l).
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;        // query pixels (warps) per block
constexpr int kGroups = 4;       // corner groups per warp
constexpr int kGroupLanes = 32 / kGroups;

// J float4 chunks of 32 channels per lane cover C <= 32 * J; C % 4 == 0.
template <int J>
__global__ void __launch_bounds__(kWarps * 32)
corr_lookup_kernel(const float* __restrict__ f1,
                   const float* __restrict__ pyramid,
                   const float* __restrict__ coords,
                   float* __restrict__ out,
                   int N, int H, int W, int C, int L, int r) {
  extern __shared__ float corner_s[];  // [kWarps][(2r+2)^2]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long pixels = (long long)N * H * W;
  const long long pix = (long long)blockIdx.x * kWarps + warp;  // n*H*W + p
  if (pix >= pixels) return;
  const int l = blockIdx.y;
  const int n = (int)(pix / ((long long)H * W));
  const int kc = 2 * r + 2, k = 2 * r + 1, ncorner = kc * kc;
  float* corner = corner_s + warp * ncorner;

  size_t level_off = 0;
  for (int j = 0; j < l; ++j) level_off += (size_t)N * (H >> j) * (W >> j) * C;
  const int hl = H >> l, wl = W >> l;
  const float* f2 = pyramid + level_off + (size_t)n * hl * wl * C;

  const int g = lane / kGroupLanes, gl = lane % kGroupLanes;
  const float* f1p = f1 + pix * C;
  float4 a[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = 4 * gl + 32 * j;
    a[j] = c < C ? *reinterpret_cast<const float4*>(f1p + c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const float scale = 1.f / (float)(1 << l);  // a power of two: exact
  const float cx = coords[2 * pix] * scale, cy = coords[2 * pix + 1] * scale;
  const float x0 = floorf(cx), y0 = floorf(cy);
  const float fx = cx - x0, fy = cy - y0;
  // A window this far off the level reads nothing; the clamp only keeps the
  // conversion to int defined.
  const int ix = (int)fminf(fmaxf(x0, -65536.f), 65536.f) - r;
  const int iy = (int)fminf(fmaxf(y0, -65536.f), 65536.f) - r;
  const float sqrt_c = sqrtf((float)C);

  for (int q0 = 0; q0 < ncorner; q0 += kGroups) {
    const int q = q0 + g;
    const int yy = iy + q / kc, xx = ix + q % kc;
    const bool valid = q < ncorner && yy >= 0 && yy < hl && xx >= 0 && xx < wl;
    float s = 0.f;
    if (valid) {
      const float* row = f2 + ((size_t)yy * wl + xx) * C;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = 4 * gl + 32 * j;
        if (c < C) {
          const float4 b = __ldg(reinterpret_cast<const float4*>(row + c));
          s = fmaf(a[j].x, b.x, s);
          s = fmaf(a[j].y, b.y, s);
          s = fmaf(a[j].z, b.z, s);
          s = fmaf(a[j].w, b.w, s);
        }
      }
    }
    // the xor offsets stay inside the group of 8 lanes
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (gl == 0 && q < ncorner) corner[q] = valid ? s / sqrt_c : 0.f;
  }
  __syncwarp();

  float* o = out + ((size_t)pix * L + l) * (size_t)(k * k);
  for (int t = lane; t < k * k; t += 32) {
    const float* c0 = corner + (t / k) * kc + t % k;
    o[t] = (1.f - fy) * (1.f - fx) * c0[0] + (1.f - fy) * fx * c0[1] +
           fy * (1.f - fx) * c0[kc] + fy * fx * c0[kc + 1];
  }
}

template <int J>
int launch(const float* f1, const float* pyramid, const float* coords,
           float* out, int N, int H, int W, int C, int L, int r,
           cudaStream_t stream) {
  const long long pixels = (long long)N * H * W;
  const dim3 grid((unsigned)((pixels + kWarps - 1) / kWarps), (unsigned)L);
  const size_t smem = sizeof(float) * kWarps * (2 * r + 2) * (2 * r + 2);
  corr_lookup_kernel<J><<<grid, kWarps * 32, smem, stream>>>(
      f1, pyramid, coords, out, N, H, W, C, L, r);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shapes are validated by the Python wrapper: C % 4 == 0, 4 <= C <= 256,
// 0 <= r <= 8, 1 <= L, N*H*W >= 1.
int corr_lookup(const float* f1, const float* pyramid, const float* coords,
                float* out, int N, int H, int W, int C, int L, int r,
                cudaStream_t stream) {
  const int chunks = (C + 31) / 32;
  if (chunks <= 1) return launch<1>(f1, pyramid, coords, out, N, H, W, C, L, r, stream);
  if (chunks <= 2) return launch<2>(f1, pyramid, coords, out, N, H, W, C, L, r, stream);
  if (chunks <= 4) return launch<4>(f1, pyramid, coords, out, N, H, W, C, L, r, stream);
  if (chunks <= 8) return launch<8>(f1, pyramid, coords, out, N, H, W, C, L, r, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
