// K2 and K3: the differentiable banded line sampler (Hopper, sm_90a).
//
// K2 replaces the Pallas TPU kernel family behind _raw_forward
// (highlyaccurate_tpu/ops/pallas/banded_warp.py:1046; bodies
// _kernel_fullmap_blocked_uwin :623, _kernel_fullmap_blocked :381,
// _kernel_fullmap :206, the windowed _kernel :172).  K3 replaces
// _raw_backward (:1147; bodies _bwd_kernel :799, _bwd_kernel_uwin :891,
// helper _unshear_scatter4 :1014).  As with K1, the port keeps the contract
// and drops the TPU schedule: no integer shear, no banded matmuls, no
// column blocks or u-windows.
//
// Contract, for each (batch b, ground row v) and sample u in [0, W):
//   x = ax + bx*u, y = ay + by*u         (row coefficients from
//                                         pack_row_coefs; ax = 1e9 marks a
//                                         row the validity guard zeroed)
//   keep = 0 <= x,y <= A-1 and floor(x) < A-1 and floor(y) < A-1
//          (the reference edge quirk: a sample on the last row or column
//          is dropped)
//   with fx, fy the fractional parts and a, b, c, d the map corners
//   (y0,x0), (y0,x0+1), (y0+1,x0), (y0+1,x0+1) of sat[b, y, x, :] (kernel
//   axes; map in bf16 or fp32, math in fp32):
//     out = (1-fy)((1-fx)a + fx b) + fy((1-fx)c + fx d)
//     dx  = (1-fy)(b-a) + fy(d-c)
//     dy  = (1-fx)(c-a) + fx(d-b)
//     dxy = a - b - c + d
//   all four zero where keep is false -> out, dx, dy, dxy [B, V, W, C] fp32.
// K3 is the exact transpose of (out, dx, dy): the four corners of every kept
// sample receive g_o*d(out)/d(corner) + g_dx*d(dx)/d(corner)
// + g_dy*d(dy)/d(corner) -> grad [B, A, A, C] fp32 in kernel axes.  It never
// reads the map.
//
// What bounds them on the H100: bytes.  K2 writes 4 x B*V*W*C fp32 (67 /
// 134 / 268 MB per launch at the flagship slots 0 / 1 / 2, batch 8) against
// ~22 flop per (sample, channel); K3 reads three such arrays and writes the
// map gradient.  Both are far below the card's ridge point.
//
// Design.  Each thread owns one (row, u, channel pair): it computes the
// sample coordinates itself (a few flops, cheaper than sharing them), reads
// the four corners as __nv_bfloat162 (float2 for an fp32 map), and K2
// writes one float2 per output, so a warp writes 256 contiguous bytes of
// each output row.  Blocks of 256 threads tile each (b, v) row's W*C/2
// pairs, which gives thousands of blocks at every flagship shape (one block
// per row, as K1 has, would leave 128 blocks at slot 0 for 132 SMs).
// Sample coordinates use explicit round-to-nearest multiply and add (no FMA
// contraction), the same two roundings the plain PyTorch version performs,
// so both pick the same bilinear cell.
//
// K3 scatters with fp32 atomicAdd into a zeroed gradient.  One map cell
// collects the samples of consecutive u of one row when |bx| < 1, and of
// neighbouring ground rows at near range, in an order that changes from run
// to run.  Tolerance against the plain version: each cell's sum is
// reassociated, |err| <= 1e-5 x max|plain| + 1e-6 (a few fp32 ulps of the
// largest partial sums), checked in chip_smoke.py.  A deterministic
// row-owner scheme is later work (ROADMAP).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCoefs = 8;

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// The bilinear cell of sample u on the row with coefficients cf; returns
// whether the sample is kept (x0, y0 are valid only then).
__device__ __forceinline__ bool line_cell(const float* cf, int u, int A,
                                          int& x0, int& y0, float& fx,
                                          float& fy) {
  const float uf = static_cast<float>(u);
  const float x = __fadd_rn(cf[0], __fmul_rn(cf[1], uf));
  const float y = __fadd_rn(cf[2], __fmul_rn(cf[3], uf));
  const float lim = static_cast<float>(A - 1);
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  fx = x - x0f;
  fy = y - y0f;
  const bool keep = x >= 0.f && x <= lim && y >= 0.f && y <= lim &&
                    x0f < lim && y0f < lim;
  if (keep) {
    x0 = static_cast<int>(x0f);
    y0 = static_cast<int>(y0f);
  }
  return keep;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
banded_sample_kernel(const float* __restrict__ coefs,
                     const T* __restrict__ sat, float* __restrict__ out,
                     float* __restrict__ dx, float* __restrict__ dy,
                     float* __restrict__ dxy, int V, int W, int A, int C2,
                     int chunks, long long sat_sb, long long sat_sy,
                     long long sat_sx) {
  const int row = blockIdx.x / chunks;  // b * V + v
  const int e = (blockIdx.x - row * chunks) * kThreads + threadIdx.x;
  if (e >= W * C2) return;
  const int u = e / C2;
  const int c = 2 * (e - u * C2);
  const int b = row / V;

  int x0 = 0, y0 = 0;
  float fx, fy;
  const bool keep = line_cell(coefs + static_cast<long long>(row) * kCoefs,
                              u, A, x0, y0, fx, fy);
  float2 vo = make_float2(0.f, 0.f), vdx = vo, vdy = vo, vdxy = vo;
  if (keep) {
    const T* p00 = sat + b * sat_sb + y0 * sat_sy + x0 * sat_sx + c;
    const float2 a = load_pair(p00), bb = load_pair(p00 + sat_sx);
    const float2 cc = load_pair(p00 + sat_sy);
    const float2 d = load_pair(p00 + sat_sy + sat_sx);
    const float wxa = 1.f - fx, wxb = fx, gya = 1.f - fy, gyb = fy;
    vo.x = gya * (wxa * a.x + wxb * bb.x) + gyb * (wxa * cc.x + wxb * d.x);
    vo.y = gya * (wxa * a.y + wxb * bb.y) + gyb * (wxa * cc.y + wxb * d.y);
    vdx.x = gya * (bb.x - a.x) + gyb * (d.x - cc.x);
    vdx.y = gya * (bb.y - a.y) + gyb * (d.y - cc.y);
    vdy.x = wxa * (cc.x - a.x) + wxb * (d.x - bb.x);
    vdy.y = wxa * (cc.y - a.y) + wxb * (d.y - bb.y);
    vdxy.x = a.x - bb.x - cc.x + d.x;
    vdxy.y = a.y - bb.y - cc.y + d.y;
  }
  const long long o = (static_cast<long long>(row) * W + u) * (2 * C2) + c;
  *reinterpret_cast<float2*>(out + o) = vo;
  *reinterpret_cast<float2*>(dx + o) = vdx;
  *reinterpret_cast<float2*>(dy + o) = vdy;
  if (dxy != nullptr) *reinterpret_cast<float2*>(dxy + o) = vdxy;
}

__global__ void __launch_bounds__(kThreads)
banded_sample_backward_kernel(const float* __restrict__ coefs,
                              const float* __restrict__ g_o,
                              const float* __restrict__ g_dx,
                              const float* __restrict__ g_dy,
                              float* __restrict__ grad, int V, int W, int A,
                              int C2, int chunks) {
  const int row = blockIdx.x / chunks;
  const int e = (blockIdx.x - row * chunks) * kThreads + threadIdx.x;
  if (e >= W * C2) return;
  const int u = e / C2;
  const int c = 2 * (e - u * C2);
  const int b = row / V;

  int x0 = 0, y0 = 0;
  float fx, fy;
  if (!line_cell(coefs + static_cast<long long>(row) * kCoefs, u, A, x0, y0,
                 fx, fy))
    return;
  const long long o = (static_cast<long long>(row) * W + u) * (2 * C2) + c;
  const float2 go = load_pair(g_o + o);
  const float2 gx = load_pair(g_dx + o);
  const float2 gy = load_pair(g_dy + o);
  const float wxa = 1.f - fx, wxb = fx, gya = 1.f - fy, gyb = fy;
  const int C = 2 * C2;
  float* pa = grad + ((static_cast<long long>(b) * A + y0) * A + x0) * C + c;
  float* pb = pa + C;
  float* pc = pa + static_cast<long long>(A) * C;
  float* pd = pc + C;
  // d(out, dx, dy)/d(corner): a (gya*wxa, -gya, -wxa), b (gya*wxb, gya,
  // -wxb), c (gyb*wxa, -gyb, wxa), d (gyb*wxb, gyb, wxb)
  atomicAdd(pa, go.x * wxa * gya - gx.x * gya - gy.x * wxa);
  atomicAdd(pa + 1, go.y * wxa * gya - gx.y * gya - gy.y * wxa);
  atomicAdd(pb, go.x * wxb * gya + gx.x * gya - gy.x * wxb);
  atomicAdd(pb + 1, go.y * wxb * gya + gx.y * gya - gy.y * wxb);
  atomicAdd(pc, go.x * wxa * gyb - gx.x * gyb + gy.x * wxa);
  atomicAdd(pc + 1, go.y * wxa * gyb - gx.y * gyb + gy.y * wxa);
  atomicAdd(pd, go.x * wxb * gyb + gx.x * gyb + gy.x * wxb);
  atomicAdd(pd + 1, go.y * wxb * gyb + gx.y * gyb + gy.y * wxb);
}

unsigned grid_size(int B, int V, int W, int C, int* chunks) {
  *chunks = (W * (C / 2) + kThreads - 1) / kThreads;
  return static_cast<unsigned>(B) * static_cast<unsigned>(V) *
         static_cast<unsigned>(*chunks);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Pointers are device pointers;
// strides are in elements.  Each launches on `stream` and returns
// cudaGetLastError() (0 on success); neither synchronises.

// K2.  dxy may be null (the forward of an evaluation, which needs no
// coefficient gradient).  The map may be a strided view with unit channel
// stride; the outputs are contiguous [B, V, W, C].
extern "C" int banded_sample_launch(const void* coefs, const void* sat,
                                    void* out, void* dx, void* dy, void* dxy,
                                    int B, int V, int W, int A, int C,
                                    long long sat_sb, long long sat_sy,
                                    long long sat_sx, int bf16_map,
                                    void* stream) {
  int chunks;
  const dim3 grid(grid_size(B, V, W, C, &chunks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_map) {
    banded_sample_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(coefs),
        static_cast<const __nv_bfloat16*>(sat), static_cast<float*>(out),
        static_cast<float*>(dx), static_cast<float*>(dy),
        static_cast<float*>(dxy), V, W, A, C / 2, chunks, sat_sb, sat_sy,
        sat_sx);
  } else {
    banded_sample_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(coefs), static_cast<const float*>(sat),
        static_cast<float*>(out), static_cast<float*>(dx),
        static_cast<float*>(dy), static_cast<float*>(dxy), V, W, A, C / 2,
        chunks, sat_sb, sat_sy, sat_sx);
  }
  return static_cast<int>(cudaGetLastError());
}

// K3.  g_o, g_dx, g_dy are contiguous [B, V, W, C]; grad is a contiguous
// [B, A, A, C] that the caller has zeroed.
extern "C" int banded_sample_backward_launch(const void* coefs,
                                             const void* g_o,
                                             const void* g_dx,
                                             const void* g_dy, void* grad,
                                             int B, int V, int W, int A,
                                             int C, void* stream) {
  int chunks;
  const dim3 grid(grid_size(B, V, W, C, &chunks));
  banded_sample_backward_kernel<<<grid, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coefs), static_cast<const float*>(g_o),
      static_cast<const float*>(g_dx), static_cast<const float*>(g_dy),
      static_cast<float*>(grad), V, W, A, C / 2, chunks);
  return static_cast<int>(cudaGetLastError());
}
