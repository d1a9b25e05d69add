// K1: fused LM moments of bilinear line samples (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel family behind make_banded_moments
// (highlyaccurate_tpu/ops/pallas/banded_warp.py:704; bodies
// _kernel_moments_fullmap_blocked_uwin :649, _kernel_moments_fullmap_blocked
// :359, _kernel_moments_fullmap :339, _kernel_moments :315).  Those are TPU
// schedules of one contract; this file ports the contract, not the schedule:
// no integer shear, no banded matmuls, no column blocks or u-windows.
//
// Contract, for each (batch b, ground row v) and sample u in [0, W):
//   x = ax + bx*u, y = ay + by*u         (row coefficients from
//                                         pack_row_coefs; ax = 1e9 marks a
//                                         row the validity guard zeroed)
//   keep = 0 <= x,y <= A-1 and floor(x) < A-1 and floor(y) < A-1
//          (the reference edge quirk: a sample on the last row or column
//          is dropped)
//   s, ds/dx, ds/dy = bilinear value and screen derivatives of the map
//          sat[b, y, x, :] (kernel axes; map in bf16 or fp32, math in fp32)
//   nine channel dots with the target row g = grd[b, v, u, :]:
//     ss, gg, sxx, sxy, syy, dxs, dys, dxg, dyg   (MOM_IDX lane order)
//   each times the ray mask mask[v, u], summed over u with weights 1, u, u^2
//   -> out[b, v, 3, 16], lanes 9..15 zero.
//
// What bounds it on the H100: bytes.  Per image and round the fp32 target
// rows are 2.1 / 4.2 / 8.4 MB at the flagship slots 0 / 1 / 2 and the bf16
// map at most as much again, against ~42 flop per (sample, channel): about
// 5 flop/byte, far below the card's ridge.  The design therefore reads every
// target element once and each map corner from L1/L2 directly (the four
// corners of neighbouring samples overlap), keeps all intermediate values in
// registers and writes 192 bytes per row.
//
// Design: one block owns one (b, v) row, so there are no atomics and the
// result is deterministic.  Each warp takes samples u = warp, warp + 8, ...;
// its lanes stride over channel pairs, reading the map as __nv_bfloat162
// (float2 for an fp32 map) and the target as float2.  Every lane keeps the 27
// u-weighted partial sums of its channels in registers across all its
// samples; one warp-shuffle reduction and one shared-memory pass over the 8
// warps finish the row.  Sample coordinates are computed with explicit
// round-to-nearest multiply and add (no FMA contraction), the same two
// roundings the plain PyTorch version performs, so both pick the same
// bilinear cell.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMoments = 9;
constexpr int kAcc = 3 * kMoments;
constexpr int kLanesOut = 16;
constexpr int kCoefs = 8;

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// One channel's bilinear value and derivatives, accumulated into the nine
// per-sample channel dots p[].
__device__ __forceinline__ void accumulate_channel(
    float a, float b, float c, float d, float g, float wxa, float wxb,
    float gya, float gyb, float* p) {
  const float s = gya * (wxa * a + wxb * b) + gyb * (wxa * c + wxb * d);
  const float dx = gya * (b - a) + gyb * (d - c);
  const float dy = wxa * (c - a) + wxb * (d - b);
  p[0] += s * s;
  p[2] += dx * dx;
  p[3] += dx * dy;
  p[4] += dy * dy;
  p[5] += dx * s;
  p[6] += dy * s;
  p[7] += dx * g;
  p[8] += dy * g;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
banded_moments_kernel(const float* __restrict__ coefs,
                      const T* __restrict__ sat,
                      const float* __restrict__ grd,
                      const float* __restrict__ mask,
                      float* __restrict__ out, int V, int W, int A, int C,
                      long long sat_sb, long long sat_sy, long long sat_sx,
                      long long grd_sb) {
  const int row = blockIdx.x;  // b * V + v
  const int b = row / V;
  const int v = row - b * V;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const float* cf = coefs + static_cast<long long>(row) * kCoefs;
  const float ax = cf[0], bx = cf[1], ay = cf[2], by = cf[3];
  const T* map = sat + b * sat_sb;
  const float* g_row = grd + b * grd_sb + static_cast<long long>(v) * W * C;
  const float* m_row = mask + static_cast<long long>(v) * W;
  const float lim = static_cast<float>(A - 1);
  const int C2 = C >> 1;

  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.f;

  for (int u = warp; u < W; u += kWarps) {
    const float uf = static_cast<float>(u);
    const float x = __fadd_rn(ax, __fmul_rn(bx, uf));
    const float y = __fadd_rn(ay, __fmul_rn(by, uf));
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    const bool keep = x >= 0.f && x <= lim && y >= 0.f && y <= lim &&
                      x0f < lim && y0f < lim;  // warp-uniform
    const float fx = x - x0f;
    const float fy = y - y0f;
    const float wxa = 1.f - fx, wxb = fx, gya = 1.f - fy, gyb = fy;

    float p[kMoments];
#pragma unroll
    for (int k = 0; k < kMoments; ++k) p[k] = 0.f;
    const float* g_px = g_row + static_cast<long long>(u) * C;
    if (keep) {
      const T* p00 = map + static_cast<long long>(y0f) * sat_sy +
                     static_cast<long long>(x0f) * sat_sx;
      const T* p01 = p00 + sat_sx;
      const T* p10 = p00 + sat_sy;
      const T* p11 = p10 + sat_sx;
      for (int c2 = lane; c2 < C2; c2 += 32) {
        const int c = 2 * c2;
        const float2 g = load_pair(g_px + c);
        const float2 a = load_pair(p00 + c), bb = load_pair(p01 + c);
        const float2 cc = load_pair(p10 + c), d = load_pair(p11 + c);
        p[1] += g.x * g.x + g.y * g.y;
        accumulate_channel(a.x, bb.x, cc.x, d.x, g.x, wxa, wxb, gya, gyb, p);
        accumulate_channel(a.y, bb.y, cc.y, d.y, g.y, wxa, wxb, gya, gyb, p);
      }
    } else {
      for (int c2 = lane; c2 < C2; c2 += 32) {
        const float2 g = load_pair(g_px + 2 * c2);
        p[1] += g.x * g.x + g.y * g.y;
      }
    }

    const float w0 = m_row[u];
    const float w1 = uf;
    const float w2 = uf * uf;
#pragma unroll
    for (int k = 0; k < kMoments; ++k) {
      const float q = p[k] * w0;
      acc[k] += q;
      acc[kMoments + k] += q * w1;
      acc[2 * kMoments + k] += q * w2;
    }
  }

#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    float s = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    acc[k] = s;
  }

  __shared__ float part[kWarps][kAcc];
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kAcc; ++k) part[warp][k] = acc[k];
  }
  __syncthreads();

  if (threadIdx.x < 3 * kLanesOut) {
    const int r = threadIdx.x / kLanesOut;  // 0: sum, 1: u-sum, 2: u^2-sum
    const int l = threadIdx.x - r * kLanesOut;
    float s = 0.f;
    if (l < kMoments) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += part[w][r * kMoments + l];
    }
    out[static_cast<long long>(row) * 3 * kLanesOut + threadIdx.x] = s;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Pointers are device pointers;
// strides are in elements.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises.
extern "C" int banded_moments_launch(const void* coefs, const void* sat,
                                     const void* grd, const void* mask,
                                     void* out, int B, int V, int W, int A,
                                     int C, long long sat_sb,
                                     long long sat_sy, long long sat_sx,
                                     long long grd_sb, int bf16_map,
                                     void* stream) {
  const dim3 grid(static_cast<unsigned>(B) * static_cast<unsigned>(V));
  const dim3 block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_map) {
    banded_moments_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const float*>(coefs),
        static_cast<const __nv_bfloat16*>(sat),
        static_cast<const float*>(grd), static_cast<const float*>(mask),
        static_cast<float*>(out), V, W, A, C, sat_sb, sat_sy, sat_sx,
        grd_sb);
  } else {
    banded_moments_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(coefs), static_cast<const float*>(sat),
        static_cast<const float*>(grd), static_cast<const float*>(mask),
        static_cast<float*>(out), V, W, A, C, sat_sb, sat_sy, sat_sx,
        grd_sb);
  }
  return static_cast<int>(cudaGetLastError());
}
