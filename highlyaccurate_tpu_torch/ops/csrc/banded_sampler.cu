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
// ~22 flop per (sample, channel); K3 reads the kept samples' three
// cotangents and writes the whole map gradient (33.5 / 67 / 134 MB).  Both
// are far below the card's ridge point.
//
// K2.  Each thread owns one (row, u, channel pair): it computes the sample
// coordinates itself (a few flops, cheaper than sharing them), reads the
// four corners as __nv_bfloat162 (float2 for an fp32 map), and writes one
// float2 per output, so a warp writes 256 contiguous bytes of each output
// row.  Blocks of 256 threads tile each (b, v) row's W*C/2 pairs, which
// gives thousands of blocks at every flagship shape.  Sample coordinates
// use explicit round-to-nearest multiply and add (no FMA contraction), the
// same two roundings the plain PyTorch version performs, so both pick the
// same bilinear cell (line_cell, shared with K3).
//
// K3: a tile-owner gather, no atomics.  One block owns a tile of 8 map
// columns x 4 map rows x 64 channels of one image (grid ceil(A/8) *
// ceil(A/4) x ceil(C/64) x B: 4,096 / 8,192 / 16,384 blocks at slots 0 / 1
// / 2) and writes it once, from shared memory, 256 contiguous bytes per
// cell; tiles no sample touches write zeros, so the kernel writes every
// element of grad and nothing zero-fills it first.  Static shared memory
// 26.7 KB; ptxas: 64 registers, a few bytes of spill.
// * Finding the samples.  For each row the block bounds the u whose cell
//   (x0, y0) can have a corner in the tile, x0 in [tx0-1, tx0+7] and y0 in
//   [ty0-1, ty0+3], in double precision from (ax, bx, ay, by), widened by
//   1 + 1e-6 (|a| + 2|b| W) cells: more than the rounding of a + b*u in
//   fp32 can move x.  bx = 0 (or by = 0) is a constant coordinate, a tiny
//   |b| clamps to [0, W), guard rows (ax = 1e9) give an empty range.  Every
//   u in range then goes through line_cell, K2's own rounding, and is kept
//   only if its cell lies in that window: the kept set is K2's bit for bit,
//   whatever the bound's rounding.  The block compacts the kept samples into
//   a shared-memory list (up to 1,024 records of sample, cell, fx, fy) in
//   (v, u) order, with ballots and a prefix over the 8 warps.
// * Accumulating.  Warp w owns tile column w (the guard keeps |slope| <
//   0.95, so a line covers more columns than rows and columns share the
//   work better than rows); lane l owns channel pair l and the column's 4
//   cells, as float2 in shared memory that no other thread touches.  Each
//   warp walks the list, ballots the samples with a corner in its column,
//   loads the records and float2 cotangents of four of them before using
//   any, and adds each one's two corner terms (rows yr, yr + 1) to a
//   register pair that goes to shared memory when the rows change.  Every
//   (cell, channel) is summed by one thread in list order (v, then u),
//   grouped as the list dictates: two launches on the same inputs give the
//   same bits.
// * What bounds it now.  The samples crowd into a band (8-9 per touched
//   cell on average, dozens on some): most tiles are empty, and the most
//   crowded ones hold thousands of samples, which one block walks at four
//   loads in flight per warp; the kernel lasts about as long as that block
//   (tiles of 8 x 8 or 8 x 2 cells, and rows owned by warps, were slower
//   on the card).
// Against the plain version each cell's sum runs in another order:
// |err| <= 1e-5 x max|plain| + 1e-6, checked in chip_smoke.py.

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

// K3's tile: kTile columns (one warp each) x kTileY rows of map cells, one
// channel pair per lane (64 channels per block), and the candidate list's
// capacity.
constexpr int kTile = 8;
constexpr int kTileY = 4;
constexpr int kTileThreads = 32 * kTile;
constexpr int kChunkPairs = 32;
constexpr int kCap = 1024;
constexpr int kInFlight = 4;  // samples whose cotangents a warp loads at once

// One kept sample with a corner in the tile: its index v*W + u in the
// image, its cell relative to the tile (x0 - tx0 + 1, y0 - ty0 + 1 packed in
// two bytes), and its fractional coordinates.
struct __align__(16) Cand {
  int sample;
  int cell;
  float fx, fy;
};

// A conservative range [lo, hi] of the u in [0, W) whose coordinate
// fl(a + fl(b*u)), as line_cell rounds it, can lie in [vlo, vhi]; empty
// (lo > hi) when none can.  The fp32 rounding moves the coordinate by less
// than 2^-23 (|a| + 2|b| W); the margin is 1 cell plus 8 times that, and the
// bound is taken in double precision.
__device__ __forceinline__ void axis_range(float a, float b, float vlo,
                                           float vhi, int W, int& lo,
                                           int& hi) {
  const double m = 1.0 + 1e-6 * (fabs(static_cast<double>(a)) +
                                 2.0 * fabs(static_cast<double>(b)) * W);
  const double l = vlo - m - static_cast<double>(a);
  const double h = vhi + m - static_cast<double>(a);
  double ulo, uhi;
  if (b == 0.f) {  // the coordinate is a for every u
    ulo = (l <= 0.0 && h >= 0.0) ? 0.0 : 1.0;
    uhi = (l <= 0.0 && h >= 0.0) ? W - 1.0 : 0.0;
  } else {
    const double t1 = l / b, t2 = h / b;
    ulo = fmax(floor(fmin(t1, t2)), 0.0);
    uhi = fmin(ceil(fmax(t1, t2)), W - 1.0);
  }
  if (ulo <= uhi) {
    lo = static_cast<int>(ulo);
    hi = static_cast<int>(uhi);
  } else {
    lo = 0;
    hi = -1;
  }
}

// The number of u that axis_range leaves for row coefficients cf in the
// window x in [tx0 - 1, tx0 + kTile], y in [ty0 - 1, ty0 + kTileY], and the
// first of them.
__device__ __forceinline__ int row_range(const float* cf, int tx0, int ty0,
                                         int W, int& lo) {
  int xl, xh, yl, yh;
  axis_range(cf[0], cf[1], tx0 - 1.f, tx0 + static_cast<float>(kTile), W,
             xl, xh);
  axis_range(cf[2], cf[3], ty0 - 1.f, ty0 + static_cast<float>(kTileY), W,
             yl, yh);
  lo = max(xl, yl);
  return max(0, min(xh, yh) - lo + 1);
}

// Exclusive prefix of x over the block and the block's total (every thread
// of the block calls it).
__device__ __forceinline__ int block_exclusive_scan(int x, int* warp_total,
                                                    int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int s = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += t;
  }
  if (lane == 31) warp_total[warp] = s;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < kTile; ++w) {
    const int t = warp_total[w];
    before += w < warp ? t : 0;
    total += t;
  }
  __syncthreads();
  return before + s - x;
}

// Warp w adds the terms of the listed samples with a corner in tile column
// w to its column of acc, in list order.  A sample whose cell has xr = w
// gives its left corners (a on row yr, c on row yr + 1), one with xr + 1 = w
// its right corners (b, d).  Consecutive samples on the same cell rows are
// summed in registers first and added to shared memory when the rows
// change: the grouping follows the list, so the bits do not depend on the
// run.
__device__ __forceinline__ void drain(const Cand* cand, int n,
                                      float2 (*acc)[kTile][kChunkPairs],
                                      const float* __restrict__ g_o,
                                      const float* __restrict__ g_dx,
                                      const float* __restrict__ g_dy,
                                      long long first, int C, int c,
                                      bool pair_ok) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int cur = -2;  // the cell row yr of the terms held in top, bottom
  float2 top = make_float2(0.f, 0.f), bottom = top;
  for (int j0 = 0; j0 < n; j0 += 32) {
    bool mine = false;
    if (j0 + lane < n) {
      const int xr = (cand[j0 + lane].cell & 0xff) - 1;
      mine = xr == w || xr + 1 == w;
    }
    unsigned m = __ballot_sync(0xffffffffu, mine);
    while (m != 0u) {
      int k[kInFlight];
      Cand s[kInFlight];
      float2 go[kInFlight], gx[kInFlight], gy[kInFlight];
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
        k[q] = m != 0u ? j0 + __ffs(m) - 1 : -1;
        m &= m - 1u;
        s[q] = cand[k[q] >= 0 ? k[q] : j0];
      }
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
        go[q] = gx[q] = gy[q] = make_float2(0.f, 0.f);
        if (k[q] >= 0 && pair_ok) {
          const long long o = (first + s[q].sample) * C + c;
          go[q] = load_pair(g_o + o);
          gx[q] = load_pair(g_dx + o);
          gy[q] = load_pair(g_dy + o);
        }
      }
      // d(out, dx, dy)/d(corner): a (gya*wxa, -gya, -wxa), b (gya*wxb, gya,
      // -wxb), c (gyb*wxa, -gyb, wxa), d (gyb*wxb, gyb, wxb); with h =
      // g_o*wx -+ g_dx: top = gya*h - g_dy*wx, bottom = gyb*h + g_dy*wx
      float2 t[kInFlight], u[kInFlight];
      int yr[kInFlight];
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
        const bool left = (s[q].cell & 0xff) - 1 == w;
        const float wx = left ? 1.f - s[q].fx : s[q].fx;
        const float sg = left ? -1.f : 1.f;
        const float gya = 1.f - s[q].fy, gyb = s[q].fy;
        const float hx = go[q].x * wx + sg * gx[q].x;
        const float hy = go[q].y * wx + sg * gx[q].y;
        t[q] = make_float2(gya * hx - gy[q].x * wx, gya * hy - gy[q].y * wx);
        u[q] = make_float2(gyb * hx + gy[q].x * wx, gyb * hy + gy[q].y * wx);
        yr[q] = k[q] >= 0 ? (s[q].cell >> 8) - 1 : cur;
      }
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
        if (k[q] < 0) break;
        if (yr[q] != cur) {
          if (cur >= 0 && pair_ok) {
            acc[cur][w][lane].x += top.x;
            acc[cur][w][lane].y += top.y;
          }
          if (cur >= -1 && cur + 1 < kTileY && pair_ok) {
            acc[cur + 1][w][lane].x += bottom.x;
            acc[cur + 1][w][lane].y += bottom.y;
          }
          cur = yr[q];
          top = t[q];
          bottom = u[q];
        } else {
          top.x += t[q].x;
          top.y += t[q].y;
          bottom.x += u[q].x;
          bottom.y += u[q].y;
        }
      }
    }
  }
  if (cur >= 0 && pair_ok) {
    acc[cur][w][lane].x += top.x;
    acc[cur][w][lane].y += top.y;
  }
  if (cur >= -1 && cur + 1 < kTileY && pair_ok) {
    acc[cur + 1][w][lane].x += bottom.x;
    acc[cur + 1][w][lane].y += bottom.y;
  }
}

__global__ void __launch_bounds__(kTileThreads)
banded_sample_backward_kernel(const float* __restrict__ coefs,
                              const float* __restrict__ g_o,
                              const float* __restrict__ g_dx,
                              const float* __restrict__ g_dy,
                              float* __restrict__ grad, int V, int W, int A,
                              int C2) {
  __shared__ float2 acc[kTileY][kTile][kChunkPairs];
  __shared__ Cand cand[kCap];
  __shared__ int row_lo[kTileThreads];
  __shared__ int row_start[kTileThreads + 1];
  __shared__ int warp_n[kTile];

  const int lane = threadIdx.x & 31, r = threadIdx.x >> 5;  // warp r
  const int nt = (A + kTile - 1) / kTile;  // tiles along x
  const int ty0 = (blockIdx.x / nt) * kTileY;
  const int tx0 = (blockIdx.x - (blockIdx.x / nt) * nt) * kTile;
  const int p = blockIdx.y * kChunkPairs + lane;  // this lane's pair
  const bool pair_ok = p < C2;
  const int C = 2 * C2;
  const int b = blockIdx.z;
  const long long first = static_cast<long long>(b) * V * W;
  const float* cf_b = coefs + static_cast<long long>(b) * V * kCoefs;

#pragma unroll
  for (int y = 0; y < kTileY; ++y) acc[y][r][lane] = make_float2(0.f, 0.f);

  int n = 0;  // records in cand[], the same in every thread
  for (int v0 = 0; v0 < V; v0 += kTileThreads) {
    const int nv = min(kTileThreads, V - v0);
    int count = 0;
    if (static_cast<int>(threadIdx.x) < nv) {
      int lo;
      count = row_range(cf_b + static_cast<long long>(v0 + threadIdx.x) *
                                   kCoefs,
                        tx0, ty0, W, lo);
      row_lo[threadIdx.x] = lo;
    }
    int total;
    const int start = block_exclusive_scan(count, warp_n, total);
    if (static_cast<int>(threadIdx.x) < nv) row_start[threadIdx.x] = start;
    __syncthreads();

    for (int f0 = 0; f0 < total; f0 += kTileThreads) {
      const int f = f0 + threadIdx.x;
      bool take = false;
      Cand c;
      if (f < total) {
        int lo = 0, hi = nv - 1;  // the last row whose range starts <= f
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (row_start[mid] <= f) lo = mid; else hi = mid - 1;
        }
        const int v = v0 + lo;
        const int u = row_lo[lo] + f - row_start[lo];
        int x0, y0;
        float fx, fy;
        if (line_cell(cf_b + static_cast<long long>(v) * kCoefs, u, A, x0,
                      y0, fx, fy)) {
          const int xr = x0 - tx0, yr = y0 - ty0;
          take = xr >= -1 && xr < kTile && yr >= -1 && yr < kTileY;
          c.sample = v * W + u;
          c.cell = (xr + 1) | ((yr + 1) << 8);
          c.fx = fx;
          c.fy = fy;
        }
      }
      // ordered compaction: warps in order, lanes in order
      const unsigned m = __ballot_sync(0xffffffffu, take);
      if (lane == 0) warp_n[r] = __popc(m);
      __syncthreads();
      int before = n, added = 0;
      for (int w = 0; w < kTile; ++w) {
        const int t = warp_n[w];
        before += w < r ? t : 0;
        added += t;
      }
      if (take) cand[before + __popc(m & ((1u << lane) - 1u))] = c;
      n += added;
      __syncthreads();
      if (n > kCap - kTileThreads) {
        drain(cand, n, acc, g_o, g_dx, g_dy, first, C, 2 * p, pair_ok);
        __syncthreads();
        n = 0;
      }
    }
    __syncthreads();  // row_lo, row_start are rewritten by the next rows
  }
  drain(cand, n, acc, g_o, g_dx, g_dy, first, C, 2 * p, pair_ok);

  // warp r writes its own column: 256 contiguous bytes per cell
  const int x = tx0 + r;
  if (x < A && pair_ok) {
    float* col = grad + ((static_cast<long long>(b) * A + ty0) * A + x) * C +
                 2 * p;
#pragma unroll
    for (int y = 0; y < kTileY; ++y) {
      if (ty0 + y < A)
        *reinterpret_cast<float2*>(col + static_cast<long long>(y) * A * C) =
            acc[y][r][lane];
    }
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
// [B, A, A, C] that the kernel writes whole (it need not be zeroed).
extern "C" int banded_sample_backward_launch(const void* coefs,
                                             const void* g_o,
                                             const void* g_dx,
                                             const void* g_dy, void* grad,
                                             int B, int V, int W, int A,
                                             int C, void* stream) {
  const unsigned nt = static_cast<unsigned>((A + kTile - 1) / kTile);
  const unsigned nty = static_cast<unsigned>((A + kTileY - 1) / kTileY);
  const dim3 grid(nt * nty, (C / 2 + kChunkPairs - 1) / kChunkPairs, B);
  banded_sample_backward_kernel<<<grid, kTileThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coefs), static_cast<const float*>(g_o),
      static_cast<const float*>(g_dx), static_cast<const float*>(g_dy),
      static_cast<float*>(grad), V, W, A, C / 2);
  return static_cast<int>(cudaGetLastError());
}
