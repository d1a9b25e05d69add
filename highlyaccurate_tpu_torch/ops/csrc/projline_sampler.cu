// K4, K5 and K6: the projective-line sampler of the G2SP direction, its map
// gradient, and the sampler fused with the per-pixel LM moments (Hopper,
// sm_90a).
//
// K4 replaces the Pallas TPU kernel family behind _raw_projline_forward
// (highlyaccurate_tpu/ops/pallas/banded_warp.py:1821; bodies
// _kernel_projline_blocked :1438 via _projline_blocked_scan :1473, the one
// the flagship runs, _kernel_projline_blocked_uwin :1587 and
// _kernel_projline_fullmap :1415; weights _weights_projline :1360).  K5
// replaces _raw_projline_backward (:1963; body _bwd_kernel_projline :1873,
// helpers _unshear_scatter4 :1014 and _bwd_col_blocks_rect :1945).  The port
// keeps the contract and drops the TPU schedule: no integer shear, no banded
// matmuls, no column blocks, y-windows, u-windows or channel-first layout.
//
// Contract, for each (batch b, line v = satellite column) and sample u in
// [0, W) (u = satellite row), with the first six lanes of the line's 16
// coefficients from pack_projline_coefs (nx0, dnx, ny0, dny, d0, dd; a line
// the validity guard rejected carries nx0 = 1e9, dnx = dd = 0, d0 = 1):
//   den = d0 + dd*u, infront = den > 1e-6, deni = 1 / (infront ? den : 1)
//   x = (nx0 + dnx*u) * deni, y = (ny0 + dny*u) * deni
//   keep = infront and 0 <= x <= AX-1 and 0 <= y <= AY-1
//          and floor(x) < AX-1 and floor(y) < AY-1   (the edge quirk)
//   with fx, fy the fractional parts and a, b, c, d the corners (y0,x0),
//   (y0,x0+1), (y0+1,x0), (y0+1,x0+1) of map[b, y, x, :] (ground map rows
//   y, columns x; bf16 or fp32, math in fp32):
//     out = (1-fy)((1-fx)a + fx b) + fy((1-fx)c + fx d)
//     dx  = (1-fy)(b-a) + fy(d-c),  dy = (1-fx)(c-a) + fx(d-b)
//     dxy = a - b - c + d
//   all zero where keep is false -> out, dx, dy (, dxy) [B, V, W, C] fp32.
// K5 is the exact transpose of (out, dx, dy): the four corners of every kept
// sample receive g_o*d(out)/d(corner) + g_dx*d(dx)/d(corner)
// + g_dy*d(dy)/d(corner) -> grad [B, AY, AX, C] fp32.  It never reads the
// map.
//
// Sample coordinates use explicit round-to-nearest multiply and add and an
// IEEE reciprocal (no FMA contraction, no fast reciprocal): the same
// roundings as the plain PyTorch version, so both pick the same bilinear
// cell.  An ulp of x can flip a cell, and fifteen LM rounds amplify that.
//
// What bounds them on the H100: bytes.  K4 writes 3 or 4 x B*V*W*C fp32 (29
// / 59 / 113 MB per array at the flagship G2SP levels, batch 8) against
// ~22 flop per kept (sample, channel); K5 reads three such arrays and writes
// the map gradient.  Both are far below the card's ridge point.
//
// Design, as K2 / K3 (banded_sampler.cu): each thread owns one (line, u,
// channel pair), computes its sample's coordinates itself, gathers the four
// corners as __nv_bfloat162 (float2 for an fp32 map) through the map's
// strides, and K4 writes one float2 per output, so a warp writes 256
// contiguous bytes of each output row.  Blocks of 256 threads tile each
// line's W*C/2 pairs.  K5 scatters with fp32 atomicAdd into a zeroed
// gradient.  G2SP lines converge toward the horizon, so the samples of many
// lines land in the same few ground-map rows and the atomics contend more
// than K3's; each map cell's sum is reassociated from run to run.
// Tolerance against the plain version: |err| <= 1e-5 x max|plain| + 1e-6
// (a few fp32 ulps of the largest partial sums), checked in chip_smoke.py.
//
// K6: K4's samples contracted over the channels into the per-pixel moments
// of the G2SP LM update (G2SP evaluation with g2sp_pixel_moments=1).  It
// replaces _raw_projline_pixmom (banded_warp.py:2190; bodies
// _kernel_projline_pixmom_blocked :2162 and _kernel_projline_pixmom_fullmap
// :2141, contraction _pixmom_from_accs :2117).  For each kept sample (b, v,
// u), with out, dx, dy as K4 computes them from a bf16 map and the target
// row tgt[b, v, u, :] (fp32):
//   r = out - tgt;  sxx = sum_c dx*dx, sxy = sum_c dx*dy, syy = sum_c dy*dy,
//   rx = sum_c dx*r, ry = sum_c dy*r   -> pm [B, V, W, 5] fp32
// (the TPU kernel's 16 lanes hold these five and zeros).  A sample the mask
// drops writes zeros and never reads tgt.  Its coordinates come from
// projline_cell, the function K4 uses, so the two paths sample the same
// cells and differ only in the order of the channel sums.
//
// What bounds K6 on the H100: bytes.  It reads the map corners and the
// target rows of the kept samples (23-27% at the flagship) and writes 20
// bytes per sample, against ~30 flop per kept (sample, channel), so it
// moves a fraction of the 3 x 113 MB K4 writes at slot 2.  Design: one warp
// per sample, 8 consecutive samples of one line per block.  Each lane walks
// the channel pairs lane, lane + 32, ... (bf16x2 corner loads and float2
// target loads, coalesced along the channels), keeps the five sums in
// registers, and the warp reduces them with __shfl_xor_sync; lanes 0-4
// write one moment each.  No atomics, no shared memory.  Tolerance against
// the plain version: |err| <= 1e-5 x max|plain lane| + 1e-6 per lane.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCoefs = 16;
constexpr int kPixmom = 5;                    // sxx sxy syy rx ry
constexpr int kPixmomSamples = kThreads / 32;  // one warp per sample

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// The bilinear cell of sample u on the line with coefficients cf; returns
// whether the sample is kept (x0, y0 are valid only then).
__device__ __forceinline__ bool projline_cell(const float* cf, int u, int AY,
                                              int AX, int& x0, int& y0,
                                              float& fx, float& fy) {
  const float uf = static_cast<float>(u);
  const float den = __fadd_rn(cf[4], __fmul_rn(cf[5], uf));
  const bool infront = den > 1e-6f;
  const float deni = __frcp_rn(infront ? den : 1.f);
  const float x = __fmul_rn(__fadd_rn(cf[0], __fmul_rn(cf[1], uf)), deni);
  const float y = __fmul_rn(__fadd_rn(cf[2], __fmul_rn(cf[3], uf)), deni);
  const float xl = static_cast<float>(AX - 1);
  const float yl = static_cast<float>(AY - 1);
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  fx = x - x0f;
  fy = y - y0f;
  const bool keep = infront && x >= 0.f && x <= xl && y >= 0.f && y <= yl &&
                    x0f < xl && y0f < yl;
  if (keep) {
    x0 = static_cast<int>(x0f);
    y0 = static_cast<int>(y0f);
  }
  return keep;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
projline_sample_kernel(const float* __restrict__ coefs,
                       const T* __restrict__ map, float* __restrict__ out,
                       float* __restrict__ dx, float* __restrict__ dy,
                       float* __restrict__ dxy, int V, int W, int AY, int AX,
                       int C2, int chunks, long long map_sb, long long map_sy,
                       long long map_sx) {
  const int row = blockIdx.x / chunks;  // b * V + v
  const int e = (blockIdx.x - row * chunks) * kThreads + threadIdx.x;
  if (e >= W * C2) return;
  const int u = e / C2;
  const int c = 2 * (e - u * C2);
  const int b = row / V;

  int x0 = 0, y0 = 0;
  float fx, fy;
  const bool keep = projline_cell(
      coefs + static_cast<long long>(row) * kCoefs, u, AY, AX, x0, y0, fx,
      fy);
  float2 vo = make_float2(0.f, 0.f), vdx = vo, vdy = vo, vdxy = vo;
  if (keep) {
    const T* p00 = map + b * map_sb + y0 * map_sy + x0 * map_sx + c;
    const float2 a = load_pair(p00), bb = load_pair(p00 + map_sx);
    const float2 cc = load_pair(p00 + map_sy);
    const float2 d = load_pair(p00 + map_sy + map_sx);
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
projline_sample_backward_kernel(const float* __restrict__ coefs,
                                const float* __restrict__ g_o,
                                const float* __restrict__ g_dx,
                                const float* __restrict__ g_dy,
                                float* __restrict__ grad, int V, int W,
                                int AY, int AX, int C2, int chunks) {
  const int row = blockIdx.x / chunks;
  const int e = (blockIdx.x - row * chunks) * kThreads + threadIdx.x;
  if (e >= W * C2) return;
  const int u = e / C2;
  const int c = 2 * (e - u * C2);
  const int b = row / V;

  int x0 = 0, y0 = 0;
  float fx, fy;
  if (!projline_cell(coefs + static_cast<long long>(row) * kCoefs, u, AY,
                     AX, x0, y0, fx, fy))
    return;
  const long long o = (static_cast<long long>(row) * W + u) * (2 * C2) + c;
  const float2 go = load_pair(g_o + o);
  const float2 gx = load_pair(g_dx + o);
  const float2 gy = load_pair(g_dy + o);
  const float wxa = 1.f - fx, wxb = fx, gya = 1.f - fy, gyb = fy;
  const int C = 2 * C2;
  float* pa = grad + ((static_cast<long long>(b) * AY + y0) * AX + x0) * C + c;
  float* pb = pa + C;
  float* pc = pa + static_cast<long long>(AX) * C;
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

__global__ void __launch_bounds__(kThreads)
projline_pixmom_kernel(const float* __restrict__ coefs,
                       const __nv_bfloat16* __restrict__ map,
                       const float* __restrict__ tgt, float* __restrict__ pm,
                       int V, int W, int AY, int AX, int C, int chunks,
                       long long map_sb, long long map_sy, long long map_sx,
                       long long tgt_sb, long long tgt_sv, long long tgt_su) {
  const int row = blockIdx.x / chunks;  // b * V + v
  const int u = (blockIdx.x - row * chunks) * kPixmomSamples +
                static_cast<int>(threadIdx.x >> 5);
  if (u >= W) return;  // the whole warp leaves together
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int b = row / V;
  const int v = row - b * V;

  int x0 = 0, y0 = 0;
  float fx, fy;
  const bool keep = projline_cell(
      coefs + static_cast<long long>(row) * kCoefs, u, AY, AX, x0, y0, fx,
      fy);
  float sxx = 0.f, sxy = 0.f, syy = 0.f, rx = 0.f, ry = 0.f;
  if (keep) {
    const __nv_bfloat16* p00 = map + b * map_sb + y0 * map_sy + x0 * map_sx;
    const float* t = tgt + b * tgt_sb + v * tgt_sv + u * tgt_su;
    const float wxa = 1.f - fx, wxb = fx, gya = 1.f - fy, gyb = fy;
    for (int c = 2 * lane; c < C; c += 64) {
      const float2 a = load_pair(p00 + c), bb = load_pair(p00 + map_sx + c);
      const float2 cc = load_pair(p00 + map_sy + c);
      const float2 d = load_pair(p00 + map_sy + map_sx + c);
      const float2 tg = load_pair(t + c);
      const float ox = gya * (wxa * a.x + wxb * bb.x) +
                       gyb * (wxa * cc.x + wxb * d.x);
      const float oy = gya * (wxa * a.y + wxb * bb.y) +
                       gyb * (wxa * cc.y + wxb * d.y);
      const float dxx = gya * (bb.x - a.x) + gyb * (d.x - cc.x);
      const float dxy = gya * (bb.y - a.y) + gyb * (d.y - cc.y);
      const float dyx = wxa * (cc.x - a.x) + wxb * (d.x - bb.x);
      const float dyy = wxa * (cc.y - a.y) + wxb * (d.y - bb.y);
      const float r0 = ox - tg.x, r1 = oy - tg.y;
      sxx += dxx * dxx + dxy * dxy;
      sxy += dxx * dyx + dxy * dyy;
      syy += dyx * dyx + dyy * dyy;
      rx += dxx * r0 + dxy * r1;
      ry += dyx * r0 + dyy * r1;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sxx += __shfl_xor_sync(0xffffffffu, sxx, off);
    sxy += __shfl_xor_sync(0xffffffffu, sxy, off);
    syy += __shfl_xor_sync(0xffffffffu, syy, off);
    rx += __shfl_xor_sync(0xffffffffu, rx, off);
    ry += __shfl_xor_sync(0xffffffffu, ry, off);
  }
  if (lane < kPixmom) {
    const float val = lane == 0   ? sxx
                      : lane == 1 ? sxy
                      : lane == 2 ? syy
                      : lane == 3 ? rx
                                  : ry;
    pm[(static_cast<long long>(row) * W + u) * kPixmom + lane] = val;
  }
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

// K4.  coefs is a contiguous [B, V, 16]; dxy may be null (the forward of an
// evaluation, or of a round whose coefficients need no gradient).  The map
// [B, AY, AX, C] may be a strided view with unit channel stride; the outputs
// are contiguous [B, V, W, C].
extern "C" int projline_sample_launch(const void* coefs, const void* map,
                                      void* out, void* dx, void* dy,
                                      void* dxy, int B, int V, int W, int AY,
                                      int AX, int C, long long map_sb,
                                      long long map_sy, long long map_sx,
                                      int bf16_map, void* stream) {
  int chunks;
  const dim3 grid(grid_size(B, V, W, C, &chunks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_map) {
    projline_sample_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(coefs),
        static_cast<const __nv_bfloat16*>(map), static_cast<float*>(out),
        static_cast<float*>(dx), static_cast<float*>(dy),
        static_cast<float*>(dxy), V, W, AY, AX, C / 2, chunks, map_sb,
        map_sy, map_sx);
  } else {
    projline_sample_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(coefs), static_cast<const float*>(map),
        static_cast<float*>(out), static_cast<float*>(dx),
        static_cast<float*>(dy), static_cast<float*>(dxy), V, W, AY, AX,
        C / 2, chunks, map_sb, map_sy, map_sx);
  }
  return static_cast<int>(cudaGetLastError());
}

// K5.  g_o, g_dx, g_dy are contiguous [B, V, W, C]; grad is a contiguous
// [B, AY, AX, C] that the caller has zeroed.
extern "C" int projline_sample_backward_launch(const void* coefs,
                                               const void* g_o,
                                               const void* g_dx,
                                               const void* g_dy, void* grad,
                                               int B, int V, int W, int AY,
                                               int AX, int C, void* stream) {
  int chunks;
  const dim3 grid(grid_size(B, V, W, C, &chunks));
  projline_sample_backward_kernel<<<grid, kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coefs), static_cast<const float*>(g_o),
      static_cast<const float*>(g_dx), static_cast<const float*>(g_dy),
      static_cast<float*>(grad), V, W, AY, AX, C / 2, chunks);
  return static_cast<int>(cudaGetLastError());
}

// K6.  coefs is a contiguous [B, V, 16]; the bf16 map [B, AY, AX, C] and
// the fp32 target rows [B, V, W, C] may be strided views with unit channel
// stride; pm is a contiguous [B, V, W, 5].
extern "C" int projline_pixmom_launch(const void* coefs, const void* map,
                                      const void* tgt, void* pm, int B, int V,
                                      int W, int AY, int AX, int C,
                                      long long map_sb, long long map_sy,
                                      long long map_sx, long long tgt_sb,
                                      long long tgt_sv, long long tgt_su,
                                      void* stream) {
  const int chunks = (W + kPixmomSamples - 1) / kPixmomSamples;
  const dim3 grid(static_cast<unsigned>(B) * static_cast<unsigned>(V) *
                  static_cast<unsigned>(chunks));
  projline_pixmom_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coefs),
      static_cast<const __nv_bfloat16*>(map), static_cast<const float*>(tgt),
      static_cast<float*>(pm), V, W, AY, AX, C, chunks, map_sb, map_sy,
      map_sx, tgt_sb, tgt_sv, tgt_su);
  return static_cast<int>(cudaGetLastError());
}
