// K4, K5, K6 and K7: the projective-line sampler of the G2SP direction, its
// map gradient, the sampler fused with the per-pixel LM moments, and its
// samples contracted per line into the LM normal equations (Hopper, sm_90a).
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
// ~22 flop per kept (sample, channel); K5 reads the kept samples' three
// cotangents and writes the map gradient (33.5 / 67 / 134 MB).  Both are
// far below the card's ridge point.
//
// K4, as K2 (banded_sampler.cu): each thread owns one (line, u, channel
// pair), computes its sample's coordinates itself, gathers the four corners
// as __nv_bfloat162 (float2 for an fp32 map) through the map's strides, and
// writes one float2 per output, so a warp writes 256 contiguous bytes of
// each output row.  Blocks of 256 threads tile each line's W*C/2 pairs.
//
// K5: a tile-owner gather, no atomics, K3's design (banded_sampler.cu) on
// projective lines.  One block owns a tile of 8 map columns x 4 map rows x
// 64 channels of one image, 128 from C = 128 on (grid ceil(AX/8) *
// ceil(AY/4) x ceil(C/64 or C/128) x B: 2,048 / 4,096 / 16,384 blocks at
// the flagship G2SP levels), and writes it once, from shared memory, 256
// contiguous bytes per cell and 64 channels; tiles no sample touches write
// zeros, so the kernel writes every element of grad and nothing
// zero-fills it first.
// * Finding the samples.  Where den = d0 + dd*u > 0, x(u) and y(u) are
//   monotone, and "x in [qlo, qhi]" multiplied by den is two affine
//   inequalities in u; so is den > 1e-6.  For each line the block
//   intersects them over [0, W) in double precision (line_range), the
//   window widened by one cell and each inequality by 1e-6 (|terms|): more
//   than the fp32 roundings of den, of the numerators and of x = num *
//   (1/den) can move it.  The u in that interval then go through
//   projline_cell, K4's own rounding, and a sample is kept only if its cell
//   has a corner in the tile: the kept set is K4's bit for bit, however the
//   bound rounds.  Guard lines (nx0 = 1e9, dnx = dd = 0) give an empty
//   interval; dd = 0, a constant coordinate and a pole inside [0, W) need no
//   case of their own.  The kept samples go into a shared-memory list in
//   (v, u) order, with ballots and a prefix over the 8 warps.
// * Accumulating.  Warp w owns tile column w (the guard keeps |slope| <
//   0.95, so a line covers more columns than rows); lane l owns channel
//   pair l (and l + 32 with 128 channels) of the column's 4 cells in shared
//   memory.  Each warp walks the list, loads the cotangents of two of its
//   samples before using either, and adds each one's two corner terms.
//   Every (cell, channel) is summed by one thread in list order (v, then
//   u): two launches on the same inputs give the same bits.
// * What bounds it.  Only 2 samples meet on a touched cell on average (17
//   at most), and the busiest tile holds 100-200 samples, so the blocks
//   are short and latency-bound: registers are capped for 6 resident
//   blocks per SM (5 with 128 channels), which paid more than loads in
//   flight, and 128 channels per block halve how often slots 0 and 1 scan
//   their lines.
// Tolerance against the plain version (each map cell's sum in another
// order): |err| <= 1e-5 x max|plain| + 1e-6, checked in chip_smoke.py.
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
// target rows of the kept samples (19-23% at the flagship) and writes 20
// bytes per sample, against ~30 flop per kept (sample, channel), so it
// moves a fraction of the 3 x 113 MB K4 writes at slot 2.  Design: runs of
// 32 consecutive samples of one line.  Lane i of a warp finds the cell of
// sample u0 + i once (projline_cell), and the warp ballots the kept ones
// into a shared-memory list; a masked sample loads nothing and takes part
// in no shuffle.  The kept samples are dealt out to groups of G lanes, G
// the largest power of two up to min(32, C/8) (8 / 16 / 32 at C = 64 / 128
// / 256), each lane 8 channels at a time: one 16-byte load per corner (8
// bf16) and two of the fp32 target row.  A run has a team of G/4 warps
// (two at C = 64, four at 128, eight at 256), so that it always has eight
// groups: with one warp per run, the 896 runs of slot 0 filled fewer
// blocks than the card has SMs and each warp walked its kept samples one
// after another.  Registers are capped at 64 for four blocks per SM (two
// samples in flight per group needed more and were slower).  Each group reduces its five sums in log2(G)
// __shfl_xor_sync steps, one instruction for all the warp's groups.  The run's 32 x 5 moments,
// zeros for the masked samples, go out from shared memory as 640
// contiguous bytes.  No atomics: every sum has a fixed order, so the
// result is bit-repeatable.  The 16-byte loads need C % 8 == 0 and
// 16-byte-aligned rows (the wrapper checks and raises).  Tolerance against
// the plain version: |err| <= 1e-5 x max|plain lane| + 1e-6 per lane.
//
// K7: K4's samples contracted, line by line, into the sums of the G2SP LM
// normal equations (G2SP evaluation with g2sp_pixel_moments=0).  It
// replaces no TPU kernel: the JAX package leaves this contraction to XLA
// (pixel moments, the per-pixel Jacobian of g2sp_uv_jac and the outer
// products of lm_update_implicit_pixel).  For each line (b, v) and each
// sample u that K4 keeps (projline_cell on the same coefficients), with out,
// dx, dy read from K4's outputs and the target row tgt[b, v, u, :]:
//   r = out - tgt; sxx, sxy, syy, rx, ry the five channel sums of K6
//   h = h0 + u*dh (the line's image point under P), z = h_z
//   duv_k = (dh_k,x / z - x * dh_k,z / z, dh_k,y / z - y * dh_k,z / z),
//   (x, y) = h_xy / z, dh_k = dh0_k + u*ddh_k for the pose dims k = 0..2
//   (zero where z <= 1e-6, as g2sp_uv_jac masks them)
//   H += Du Du^T sxx + (Du Dv^T + Dv Du^T) sxy + Dv Dv^T syy,
//   g += Du rx + Dv ry   -> lm [B, V, 9]: H00 H01 H02 H11 H12 H22 g0 g1 g2
// The per-line Jacobian coefficients come as [B, V, 24]: (h0, dh) of P and
// of dP/dpose_k, k = 0..2, three floats each.  z is rounded as
// projline_cell rounds den, so a kept sample always has z > 1e-6.  A
// sample K4 masks is never read (its out, dx and dy are zeros there).
//
// What bounds K7 on the H100: bytes.  It reads the kept samples' out, dx,
// dy and target rows (4 x C x 4 bytes a kept sample; at most 4 x 1.81 GB a
// round at the finest flagship level, batch 128, 19-23% of it kept) against
// ~10 flop per (kept sample, channel), and writes 36 bytes a line.  Design:
// one warp per line, lines in blocks of eight.  The warp walks the line in
// runs of 32 samples: each lane tests its sample with projline_cell, the
// warp ballots the kept ones into a list in shared memory, and groups of G
// lanes (G as in K6: 8 / 16 / 32 at C = 64 / 128 / 256) take one kept
// sample each, 8 channels per lane per step in 16-byte loads, neighbouring
// lanes on neighbouring channels.  A group reduces its five sums with
// log2(G) __shfl_xor_sync steps, then every lane of the group forms the
// sample's duv and adds its terms to nine registers; at the end of the line
// the groups' sums meet in log2(32/G) more steps and lane 0 writes them.
// No atomics: every sum has a fixed order, so the result is bit-repeatable.
// The 16-byte loads need C % 8 == 0 and 16-byte-aligned rows (the wrapper
// checks and raises).  Tolerance against the plain version: |err| <= 1e-5 x
// max|plain lane| + 1e-6 per lane.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kCoefs = 16;
constexpr int kPixmom = 5;  // sxx sxy syy rx ry

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

// K5's tile: kTile columns (one warp each) x kTileY rows of map cells, the
// channel pairs of one lane's stride (32 lanes, 64 channels), the candidate
// list's capacity (the busiest flagship tile holds about 200), and the
// samples whose cotangents a warp loads at once.
constexpr int kTile = 8;
constexpr int kTileY = 4;
constexpr int kTileThreads = 32 * kTile;
constexpr int kChunkPairs = 32;
constexpr int kCap = 512;
constexpr int kInFlight = 2;
// The resident blocks per SM K5's registers are capped for, with P channel
// pairs per lane: 6 (40 registers) with one, 5 (48) with two.
__host__ __device__ constexpr int tile_blocks_per_sm(int P) {
  return P == 1 ? 6 : 5;
}
// Relative bound, with a 4x margin, on what projline_cell's fp32 roundings
// (num = nx0 + dnx*u and den = d0 + dd*u, two roundings each; x = num *
// (1/den), two more) move num - q*den: 2^-22 (|nx0| + |q||d0| + (|dnx| +
// |q||dd|) u).
constexpr double kRound = 1e-6;

// One kept sample with a corner in the tile: its index v*W + u in the
// image, its cell relative to the tile (x0 - tx0 + 1, y0 - ty0 + 1 packed in
// two bytes), and its fractional coordinates.
struct __align__(16) Cand {
  int sample;
  int cell;
  float fx, fy;
};

// Narrows [lo, hi] to the u with a + b*u >= 0 (empty, lo > hi, if none).
__device__ __forceinline__ void clip_affine(double a, double b, double& lo,
                                            double& hi) {
  if (b > 0.0) {
    lo = fmax(lo, -a / b);
  } else if (b < 0.0) {
    hi = fmin(hi, a / -b);
  } else if (!(a >= 0.0)) {
    hi = -1.0;
  }
}

// The two constraints a + b*u >= 0 that hold wherever q = (n0 + dn*u) /
// den, den = d0 + dd*u > 0, as projline_cell rounds it, can lie in [qlo,
// qhi]: q >= qlo is n - qlo*den >= 0 and q <= qhi is qhi*den - n >= 0,
// each widened by kRound.
__device__ __forceinline__ void ratio_constraints(double n0, double dn,
                                                  double d0, double dd,
                                                  double qlo, double qhi,
                                                  double* a, double* b) {
  const double an = fabs(n0), bn = fabs(dn), ad = fabs(d0), bd = fabs(dd);
  a[0] = n0 - qlo * d0 + kRound * (an + fabs(qlo) * ad);
  b[0] = dn - qlo * dd + kRound * (bn + fabs(qlo) * bd);
  a[1] = qhi * d0 - n0 + kRound * (an + fabs(qhi) * ad);
  b[1] = qhi * dd - dn + kRound * (bn + fabs(qhi) * bd);
}

// The number of u in [0, W) whose sample on the line with coefficients cf
// can have a cell with a corner in the tile at (tx0, ty0), x0 in [tx0 - 1,
// tx0 + kTile - 1] and y0 in [ty0 - 1, ty0 + kTileY - 1], and the first of
// them: one interval (den > 0 makes x and y monotone), bounded in double
// precision with a cell to spare on each side.  A line that fails one
// constraint at both u = 0 and u = W-1 fails it on all of [0, W) and costs
// no division: most lines miss most tiles.
__device__ __forceinline__ int line_range(const float* cf, int tx0, int ty0,
                                          int W, int& first) {
  const float4 c4 = *reinterpret_cast<const float4*>(cf);
  const float2 c2 = *reinterpret_cast<const float2*>(cf + 4);
  const double nx0 = c4.x, dnx = c4.y, ny0 = c4.z, dny = c4.w;
  const double d0 = c2.x, dd = c2.y;
  double a[5], b[5];
  // in front: fl(den) > 1e-6f
  a[0] = d0 - static_cast<double>(1e-6f) + kRound * fabs(d0);
  b[0] = dd + kRound * fabs(dd);
  ratio_constraints(nx0, dnx, d0, dd, tx0 - 2.0, tx0 + kTile + 1.0, a + 1,
                    b + 1);
  ratio_constraints(ny0, dny, d0, dd, ty0 - 2.0, ty0 + kTileY + 1.0, a + 3,
                    b + 3);
  double lo = 0.0, hi = W - 1.0;
  bool miss = false;
#pragma unroll
  for (int i = 0; i < 5; ++i) miss |= a[i] < 0.0 && a[i] + b[i] * hi < 0.0;
  if (!miss) {
#pragma unroll
    for (int i = 0; i < 5; ++i) clip_affine(a[i], b[i], lo, hi);
  }
  if (miss || !(lo <= hi)) {
    first = 0;
    return 0;
  }
  first = static_cast<int>(floor(lo));
  return static_cast<int>(ceil(hi)) - first + 1;
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
// w to its column of acc, in list order; the lane's P channel pairs start at
// channels c, c + 64, ....  A sample whose cell has xr = w gives its
// left corners (a on row yr, c on row yr + 1), one with xr + 1 = w its
// right corners (b, d).  Consecutive samples on the same cell rows are
// summed in registers first and added to shared memory when the rows
// change: the grouping follows the list, so the bits do not depend on the
// run.
template <int P>
__device__ __forceinline__ void drain(const Cand* cand, int n,
                                      float2 (*acc)[kTile][kChunkPairs * P],
                                      const float* __restrict__ g_o,
                                      const float* __restrict__ g_dx,
                                      const float* __restrict__ g_dy,
                                      long long first, int C, int c,
                                      const bool (&pair_ok)[P]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int cur = -2;  // the cell row yr of the terms held in top, bottom
  float2 top[P], bottom[P];
#pragma unroll
  for (int k = 0; k < P; ++k) top[k] = bottom[k] = make_float2(0.f, 0.f);
  auto flush = [&]() {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int i = lane + kChunkPairs * k;
      if (cur >= 0 && pair_ok[k]) {
        acc[cur][w][i].x += top[k].x;
        acc[cur][w][i].y += top[k].y;
      }
      if (cur >= -1 && cur + 1 < kTileY && pair_ok[k]) {
        acc[cur + 1][w][i].x += bottom[k].x;
        acc[cur + 1][w][i].y += bottom[k].y;
      }
      top[k] = bottom[k] = make_float2(0.f, 0.f);
    }
  };
  for (int j0 = 0; j0 < n; j0 += 32) {
    bool mine = false;
    if (j0 + lane < n) {
      const int xr = (cand[j0 + lane].cell & 0xff) - 1;
      mine = xr == w || xr + 1 == w;
    }
    unsigned m = __ballot_sync(0xffffffffu, mine);
    while (m != 0u) {
      int kq[kInFlight];
      Cand s[kInFlight];
      float2 go[kInFlight][P], gx[kInFlight][P], gy[kInFlight][P];
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
        kq[q] = m != 0u ? j0 + __ffs(m) - 1 : -1;
        m &= m - 1u;
        s[q] = cand[kq[q] >= 0 ? kq[q] : j0];
      }
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
#pragma unroll
        for (int k = 0; k < P; ++k) {
          go[q][k] = gx[q][k] = gy[q][k] = make_float2(0.f, 0.f);
          if (kq[q] >= 0 && pair_ok[k]) {
            const long long o =
                (first + s[q].sample) * C + c + 2 * kChunkPairs * k;
            go[q][k] = load_pair(g_o + o);
            gx[q][k] = load_pair(g_dx + o);
            gy[q][k] = load_pair(g_dy + o);
          }
        }
      }
      // d(out, dx, dy)/d(corner): a (gya*wxa, -gya, -wxa), b (gya*wxb, gya,
      // -wxb), c (gyb*wxa, -gyb, wxa), d (gyb*wxb, gyb, wxb); with h =
      // g_o*wx -+ g_dx: top = gya*h - g_dy*wx, bottom = gyb*h + g_dy*wx
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
        if (kq[q] < 0) break;
        const bool left = (s[q].cell & 0xff) - 1 == w;
        const float wx = left ? 1.f - s[q].fx : s[q].fx;
        const float sg = left ? -1.f : 1.f;
        const float gya = 1.f - s[q].fy, gyb = s[q].fy;
        const int yr = (s[q].cell >> 8) - 1;
        if (yr != cur) {
          flush();
          cur = yr;
        }
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const float hx = go[q][k].x * wx + sg * gx[q][k].x;
          const float hy = go[q][k].y * wx + sg * gx[q][k].y;
          const float2 t = make_float2(gya * hx - gy[q][k].x * wx,
                                       gya * hy - gy[q][k].y * wx);
          const float2 bt = make_float2(gyb * hx + gy[q][k].x * wx,
                                        gyb * hy + gy[q][k].y * wx);
          top[k].x += t.x;
          top[k].y += t.y;
          bottom[k].x += bt.x;
          bottom[k].y += bt.y;
        }
      }
    }
  }
  flush();
}
template <int P>
__global__ void __launch_bounds__(kTileThreads, tile_blocks_per_sm(P))
projline_sample_backward_kernel(const float* __restrict__ coefs,
                                const float* __restrict__ g_o,
                                const float* __restrict__ g_dx,
                                const float* __restrict__ g_dy,
                                float* __restrict__ grad, int V, int W,
                                int AY, int AX, int C2) {
  __shared__ float2 acc[kTileY][kTile][kChunkPairs * P];
  __shared__ Cand cand[kCap];
  __shared__ int line_lo[kTileThreads];
  __shared__ int line_start[kTileThreads + 1];
  __shared__ int warp_n[kTile];

  const int lane = threadIdx.x & 31, r = threadIdx.x >> 5;  // warp r
  const int nt = (AX + kTile - 1) / kTile;  // tiles along x
  const int ty0 = (blockIdx.x / nt) * kTileY;
  const int tx0 = (blockIdx.x - (blockIdx.x / nt) * nt) * kTile;
  const int p = blockIdx.y * kChunkPairs * P + lane;  // this lane's pairs:
  bool pair_ok[P];                                     // p, p + 32, ...
#pragma unroll
  for (int k = 0; k < P; ++k) pair_ok[k] = p + kChunkPairs * k < C2;
  const int C = 2 * C2;
  const int b = blockIdx.z;
  const long long first = static_cast<long long>(b) * V * W;
  const float* cf_b = coefs + static_cast<long long>(b) * V * kCoefs;

#pragma unroll
  for (int y = 0; y < kTileY; ++y)
#pragma unroll
    for (int k = 0; k < P; ++k)
      acc[y][r][lane + kChunkPairs * k] = make_float2(0.f, 0.f);

  int n = 0;  // records in cand[], the same in every thread
  for (int v0 = 0; v0 < V; v0 += kTileThreads) {
    const int nv = min(kTileThreads, V - v0);
    int count = 0;
    if (static_cast<int>(threadIdx.x) < nv) {
      int lo;
      count = line_range(cf_b + static_cast<long long>(v0 + threadIdx.x) *
                                    kCoefs,
                         tx0, ty0, W, lo);
      line_lo[threadIdx.x] = lo;
    }
    int total;
    const int start = block_exclusive_scan(count, warp_n, total);
    if (static_cast<int>(threadIdx.x) < nv) line_start[threadIdx.x] = start;
    __syncthreads();

    for (int f0 = 0; f0 < total; f0 += kTileThreads) {
      const int f = f0 + threadIdx.x;
      bool take = false;
      Cand c;
      if (f < total) {
        int lo = 0, hi = nv - 1;  // the last line whose range starts <= f
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (line_start[mid] <= f) lo = mid; else hi = mid - 1;
        }
        const int v = v0 + lo;
        const int u = line_lo[lo] + f - line_start[lo];
        int x0, y0;
        float fx, fy;
        if (projline_cell(cf_b + static_cast<long long>(v) * kCoefs, u, AY,
                          AX, x0, y0, fx, fy)) {
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
        drain<P>(cand, n, acc, g_o, g_dx, g_dy, first, C, 2 * p, pair_ok);
        __syncthreads();
        n = 0;
      }
    }
    __syncthreads();  // line_lo, line_start are rewritten by the next lines
  }
  drain<P>(cand, n, acc, g_o, g_dx, g_dy, first, C, 2 * p, pair_ok);

  // warp r writes its own column: 256 contiguous bytes per cell and pair
  const int x = tx0 + r;
  if (x < AX) {
    float* col = grad + ((static_cast<long long>(b) * AY + ty0) * AX + x) * C +
                 2 * p;
#pragma unroll
    for (int y = 0; y < kTileY; ++y) {
#pragma unroll
      for (int k = 0; k < P; ++k) {
        if (ty0 + y < AY && pair_ok[k])
          *reinterpret_cast<float2*>(col + static_cast<long long>(y) * AX * C +
                                     2 * kChunkPairs * k) =
              acc[y][r][lane + kChunkPairs * k];
      }
    }
  }
}

// K6's run of samples, and one kept sample of a run: its map cell (y0 * 32
// + its place in the run, and x0) and fractional coordinates.
constexpr int kRun = 32;
constexpr int kPixBlocksPerSM = 4;  // caps K6's registers at 64

struct __align__(16) Kept {
  int y0lane;
  int x0;
  float fx, fy;
};

// Warps per run for lane groups of G lanes: enough that every run has at
// least eight groups (two warps at C = 64, four at 128, eight at 256); with
// fewer, the levels with few samples would leave most SMs idle.
__host__ __device__ constexpr int pixmom_team(int G) {
  return G >= 4 ? G / 4 : 1;
}

// Eight bf16 channels as four float2 (a bf16 is the top half of its fp32).
__device__ __forceinline__ float2 unpack2(unsigned w) {
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}

__device__ __forceinline__ void unpack8(const uint4& q, float2 (&f)[4]) {
  f[0] = unpack2(q.x);
  f[1] = unpack2(q.y);
  f[2] = unpack2(q.z);
  f[3] = unpack2(q.w);
}

// The five moments of eight channels: corners a, b, c, d (bf16), the target
// t (fp32), and K4's arithmetic for out, dx, dy.
__device__ __forceinline__ void moments8(const uint4 (&q)[4],
                                         const float4 (&t)[2], float fx,
                                         float fy, float (&s)[kPixmom]) {
  float2 a[4], bb[4], cc[4], d[4];
  unpack8(q[0], a);
  unpack8(q[1], bb);
  unpack8(q[2], cc);
  unpack8(q[3], d);
  const float tg[8] = {t[0].x, t[0].y, t[0].z, t[0].w,
                       t[1].x, t[1].y, t[1].z, t[1].w};
  const float wxa = 1.f - fx, wxb = fx, gya = 1.f - fy, gyb = fy;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float av = i & 1 ? a[i >> 1].y : a[i >> 1].x;
    const float bv = i & 1 ? bb[i >> 1].y : bb[i >> 1].x;
    const float cv = i & 1 ? cc[i >> 1].y : cc[i >> 1].x;
    const float dv = i & 1 ? d[i >> 1].y : d[i >> 1].x;
    const float o = gya * (wxa * av + wxb * bv) + gyb * (wxa * cv + wxb * dv);
    const float ddx = gya * (bv - av) + gyb * (dv - cv);
    const float ddy = wxa * (cv - av) + wxb * (dv - bv);
    const float r = o - tg[i];
    s[0] += ddx * ddx;
    s[1] += ddx * ddy;
    s[2] += ddy * ddy;
    s[3] += ddx * r;
    s[4] += ddy * r;
  }
}

// K6 with groups of G lanes per kept sample (G a power of two, G <= C/8);
// a team of pixmom_team(G) warps owns each run.
template <int G>
__global__ void __launch_bounds__(kThreads, kPixBlocksPerSM)
projline_pixmom_kernel(const float* __restrict__ coefs,
                       const __nv_bfloat16* __restrict__ map,
                       const float* __restrict__ tgt, float* __restrict__ pm,
                       int V, int W, int AY, int AX, int C8, int runs,
                       long long n_runs, long long map_sb, long long map_sy,
                       long long map_sx, long long tgt_sb, long long tgt_sv,
                       long long tgt_su) {
  constexpr int kTeam = pixmom_team(G);         // warps per run
  constexpr int kRuns = kThreads / 32 / kTeam;  // runs per block
  constexpr int kGroups = kTeam * (32 / G);     // lane groups per run
  __shared__ Kept kept[kRuns][kRun];
  __shared__ float res[kRuns][kRun * kPixmom];
  __shared__ int n_kept[kRuns];

  const int lane = static_cast<int>(threadIdx.x & 31);
  const int w = static_cast<int>(threadIdx.x >> 5);
  const int r = w / kTeam, t = w - r * kTeam;  // the block's run, team rank
  const long long run = static_cast<long long>(blockIdx.x) * kRuns + r;
  const bool live_run = run < n_runs;
  const long long row = live_run ? run / runs : 0;  // b * V + v
  const int u0 = static_cast<int>(run - row * runs) * kRun;
  const int b = static_cast<int>(row / V);
  const int v = static_cast<int>(row - static_cast<long long>(b) * V);
  float* out = res[r];

  // the team's first warp finds the run's cells and lists the kept ones
  if (t == 0 && live_run) {
    const int u = u0 + lane;
    int x0 = 0, y0 = 0;
    float fx = 0.f, fy = 0.f;
    const bool keep = u < W && projline_cell(coefs + row * kCoefs, u, AY,
                                             AX, x0, y0, fx, fy);
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    if (keep) {
      Kept k;
      k.y0lane = y0 * kRun + lane;
      k.x0 = x0;
      k.fx = fx;
      k.fy = fy;
      kept[r][__popc(m & ((1u << lane) - 1u))] = k;
    }
#pragma unroll
    for (int q = 0; q < kPixmom; ++q) out[q * kRun + lane] = 0.f;
    if (lane == 0) n_kept[r] = __popc(m);
  }
  __syncthreads();

  if (live_run) {
    const int n = n_kept[r];
    const int g = t * (32 / G) + lane / G;  // the lane's group in the run
    const int j = lane & (G - 1);           // its place in the group
    const __nv_bfloat16* map_b = map + b * map_sb;
    const float* tgt_l = tgt + b * tgt_sb + v * tgt_sv;
    // group g takes the kept samples g, g + kGroups, ...; the loop count is
    // the same in every lane of the warp
    for (int i0 = 0; i0 < n; i0 += kGroups) {
      const int i = i0 + g;
      const bool live = i < n;
      const Kept s = kept[r][live ? i : 0];
      float acc[kPixmom] = {0.f, 0.f, 0.f, 0.f, 0.f};
      if (live) {
        const __nv_bfloat16* p00 = map_b + (s.y0lane / kRun) * map_sy +
                                   s.x0 * map_sx;
        const float* tp = tgt_l + (u0 + s.y0lane % kRun) * tgt_su;
        for (int c8 = j; c8 < C8; c8 += G) {
          const uint4 q[4] = {
              *reinterpret_cast<const uint4*>(p00 + 8 * c8),
              *reinterpret_cast<const uint4*>(p00 + map_sx + 8 * c8),
              *reinterpret_cast<const uint4*>(p00 + map_sy + 8 * c8),
              *reinterpret_cast<const uint4*>(p00 + map_sy + map_sx + 8 * c8)};
          const float4 tv[2] = {
              *reinterpret_cast<const float4*>(tp + 8 * c8),
              *reinterpret_cast<const float4*>(tp + 8 * c8 + 4)};
          moments8(q, tv, s.fx, s.fy, acc);
        }
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int q = 0; q < kPixmom; ++q)
          acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], off);
      }
      if (j == 0 && live) {
        float* o = out + (s.y0lane % kRun) * kPixmom;
#pragma unroll
        for (int q = 0; q < kPixmom; ++q) o[q] = acc[q];
      }
    }
  }
  __syncthreads();

  // the run's moments, 32 x 5 contiguous floats (fewer at the line's end)
  if (t == 0 && live_run) {
    float* dst = pm + (row * W + u0) * kPixmom;
    const int valid = min(kRun, W - u0) * kPixmom;
#pragma unroll
    for (int q = 0; q < kPixmom; ++q) {
      const int e = q * kRun + lane;
      if (e < valid) dst[e] = out[e];
    }
  }
}

// K7's lines per block (one warp each), Jacobian coefficients per line and
// sums per line.
constexpr int kLineWarps = kThreads / 32;
constexpr int kJac = 24;
constexpr int kLinemom = 9;  // H00 H01 H02 H11 H12 H22 g0 g1 g2

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The five moments of four channels: K4's out, dx, dy and the target.
__device__ __forceinline__ void moments4(const float4& o, const float4& x,
                                         const float4& y, const float4& t,
                                         float (&s)[kPixmom]) {
  const float ox[4] = {o.x, o.y, o.z, o.w}, xx[4] = {x.x, x.y, x.z, x.w};
  const float yy[4] = {y.x, y.y, y.z, y.w}, tt[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float r = ox[i] - tt[i];
    s[0] += xx[i] * xx[i];
    s[1] += xx[i] * yy[i];
    s[2] += yy[i] * yy[i];
    s[3] += xx[i] * r;
    s[4] += yy[i] * r;
  }
}

// Adds sample u's terms of H and g, from its five moments s and the line's
// Jacobian coefficients jc, to acc.
__device__ __forceinline__ void add_terms(const float (&jc)[kJac], int u,
                                          const float (&s)[kPixmom],
                                          float (&acc)[kLinemom]) {
  const float uf = static_cast<float>(u);
  // den's roundings in projline_cell: a kept sample has z > 1e-6
  const float z = __fadd_rn(jc[2], __fmul_rn(jc[5], uf));
  if (!(z > 1e-6f)) return;
  const float x = __fadd_rn(jc[0], __fmul_rn(jc[3], uf)) / z;
  const float y = __fadd_rn(jc[1], __fmul_rn(jc[4], uf)) / z;
  float du[3], dv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float* c = jc + 6 * (k + 1);
    const float ez = (c[2] + uf * c[5]) / z;
    du[k] = (c[0] + uf * c[3]) / z - x * ez;
    dv[k] = (c[1] + uf * c[4]) / z - y * ez;
  }
  const float sxx = s[0], sxy = s[1], syy = s[2];
  int q = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = a; b < 3; ++b) {
      acc[q++] += du[a] * du[b] * sxx + (du[a] * dv[b] + dv[a] * du[b]) * sxy +
                  dv[a] * dv[b] * syy;
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) acc[6 + a] += du[a] * s[3] + dv[a] * s[4];
}

// K7 with groups of G lanes per kept sample (G a power of two, G <= C/8).
template <int G>
__global__ void __launch_bounds__(kThreads)
projline_linemom_kernel(const float* __restrict__ coefs,
                        const float* __restrict__ jac,
                        const float* __restrict__ out,
                        const float* __restrict__ dx,
                        const float* __restrict__ dy,
                        const float* __restrict__ tgt, float* __restrict__ lm,
                        int V, int W, int AY, int AX, int C8,
                        long long n_lines, long long tgt_sb, long long tgt_sv,
                        long long tgt_su) {
  constexpr int kGroups = 32 / G;  // samples a warp takes at once
  __shared__ int kept[kLineWarps][32];

  const int lane = static_cast<int>(threadIdx.x & 31);
  const int w = static_cast<int>(threadIdx.x >> 5);
  const long long line = static_cast<long long>(blockIdx.x) * kLineWarps + w;
  if (line >= n_lines) return;  // the whole warp; no block barrier follows
  const int b = static_cast<int>(line / V);
  const int v = static_cast<int>(line - static_cast<long long>(b) * V);
  const float* cf = coefs + line * kCoefs;
  float jc[kJac];
#pragma unroll
  for (int i = 0; i < kJac; ++i) jc[i] = jac[line * kJac + i];
  const int g = lane / G;      // the lane's group
  const int j = lane & (G - 1);  // its place in the group
  const long long C = 8LL * C8;
  const float* tgt_l = tgt + b * tgt_sb + v * tgt_sv;

  float acc[kLinemom];
#pragma unroll
  for (int q = 0; q < kLinemom; ++q) acc[q] = 0.f;
  for (int u0 = 0; u0 < W; u0 += 32) {
    const int u = u0 + lane;
    int x0, y0;
    float fx, fy;
    const bool keep = u < W && projline_cell(cf, u, AY, AX, x0, y0, fx, fy);
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    if (keep) kept[w][__popc(m & ((1u << lane) - 1u))] = u;
    __syncwarp();
    const int n = __popc(m);
    for (int i0 = 0; i0 < n; i0 += kGroups) {
      const int i = i0 + g;
      const bool live = i < n;
      const int us = kept[w][live ? i : 0];
      float s[kPixmom] = {0.f, 0.f, 0.f, 0.f, 0.f};
      if (live) {
        const long long o = (line * W + us) * C;
        const float* tp = tgt_l + us * tgt_su;
        for (int c8 = j; c8 < C8; c8 += G) {
          const long long e = o + 8 * c8;
          const float4 o0 = load4(out + e), o1 = load4(out + e + 4);
          const float4 x0v = load4(dx + e), x1v = load4(dx + e + 4);
          const float4 y0v = load4(dy + e), y1v = load4(dy + e + 4);
          const float4 t0 = load4(tp + 8 * c8), t1 = load4(tp + 8 * c8 + 4);
          moments4(o0, x0v, y0v, t0, s);
          moments4(o1, x1v, y1v, t1, s);
        }
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int q = 0; q < kPixmom; ++q)
          s[q] += __shfl_xor_sync(0xffffffffu, s[q], off);
      }
      if (live) add_terms(jc, us, s, acc);
    }
    __syncwarp();  // the list is rewritten by the next run
  }
  // every lane of a group holds its group's sums: the groups meet
#pragma unroll
  for (int off = G; off < 32; off <<= 1) {
#pragma unroll
    for (int q = 0; q < kLinemom; ++q)
      acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], off);
  }
  if (lane < kLinemom) {
    float val = acc[0];
#pragma unroll
    for (int q = 1; q < kLinemom; ++q) val = lane == q ? acc[q] : val;
    lm[line * kLinemom + lane] = val;
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
// [B, AY, AX, C] that the kernel writes whole (it need not be zeroed).
extern "C" int projline_sample_backward_launch(const void* coefs,
                                               const void* g_o,
                                               const void* g_dx,
                                               const void* g_dy, void* grad,
                                               int B, int V, int W, int AY,
                                               int AX, int C, void* stream) {
  const unsigned nt = static_cast<unsigned>((AX + kTile - 1) / kTile);
  const unsigned nty = static_cast<unsigned>((AY + kTileY - 1) / kTileY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto pairs) {
    constexpr int P = decltype(pairs)::value;  // channel pairs per lane
    const dim3 grid(nt * nty,
                    (C / 2 + kChunkPairs * P - 1) / (kChunkPairs * P), B);
    projline_sample_backward_kernel<P><<<grid, kTileThreads, 0, s>>>(
        static_cast<const float*>(coefs), static_cast<const float*>(g_o),
        static_cast<const float*>(g_dx), static_cast<const float*>(g_dy),
        static_cast<float*>(grad), V, W, AY, AX, C / 2);
  };
  if (C >= 4 * kChunkPairs) {  // 128 channels per block from C = 128 on
    launch(std::integral_constant<int, 2>{});
  } else {
    launch(std::integral_constant<int, 1>{});
  }
  return static_cast<int>(cudaGetLastError());
}

// K6.  coefs is a contiguous [B, V, 16]; the bf16 map [B, AY, AX, C] and
// the fp32 target rows [B, V, W, C] may be strided views with unit channel
// stride, C % 8 == 0 and 16-byte-aligned rows (strides multiples of 8 map
// elements and 4 target elements, 16-byte-aligned pointers); pm is a
// contiguous [B, V, W, 5].
extern "C" int projline_pixmom_launch(const void* coefs, const void* map,
                                      const void* tgt, void* pm, int B, int V,
                                      int W, int AY, int AX, int C,
                                      long long map_sb, long long map_sy,
                                      long long map_sx, long long tgt_sb,
                                      long long tgt_sv, long long tgt_su,
                                      void* stream) {
  const int runs = (W + kRun - 1) / kRun;
  const long long n_runs = static_cast<long long>(B) * V * runs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int C8 = C / 8;
  const auto* cf = static_cast<const float*>(coefs);
  const auto* mp = static_cast<const __nv_bfloat16*>(map);
  const auto* tg = static_cast<const float*>(tgt);
  auto* out = static_cast<float*>(pm);
  auto launch = [&](auto group) {
    constexpr int G = decltype(group)::value;
    constexpr int runs_per_block = kThreads / 32 / pixmom_team(G);
    projline_pixmom_kernel<G><<<
        static_cast<unsigned>((n_runs + runs_per_block - 1) / runs_per_block),
        kThreads, 0, s>>>(cf, mp, tg, out, V, W, AY, AX, C8, runs, n_runs,
                          map_sb, map_sy, map_sx, tgt_sb, tgt_sv, tgt_su);
  };
  if (C8 >= 32) {
    launch(std::integral_constant<int, 32>{});
  } else if (C8 >= 16) {
    launch(std::integral_constant<int, 16>{});
  } else if (C8 >= 8) {
    launch(std::integral_constant<int, 8>{});
  } else if (C8 >= 4) {
    launch(std::integral_constant<int, 4>{});
  } else if (C8 >= 2) {
    launch(std::integral_constant<int, 2>{});
  } else {
    launch(std::integral_constant<int, 1>{});
  }
  return static_cast<int>(cudaGetLastError());
}

// K7.  coefs is a contiguous [B, V, 16], jac a contiguous [B, V, 24]; out,
// dx, dy are K4's contiguous [B, V, W, C]; the fp32 target rows [B, V, W, C]
// may be a strided view with unit channel stride; C % 8 == 0 and
// 16-byte-aligned rows (target strides multiples of 4 elements,
// 16-byte-aligned pointers); lm is a contiguous [B, V, 9].
extern "C" int projline_linemom_launch(const void* coefs, const void* jac,
                                       const void* out, const void* dx,
                                       const void* dy, const void* tgt,
                                       void* lm, int B, int V, int W, int AY,
                                       int AX, int C, long long tgt_sb,
                                       long long tgt_sv, long long tgt_su,
                                       void* stream) {
  const long long n_lines = static_cast<long long>(B) * V;
  const unsigned blocks =
      static_cast<unsigned>((n_lines + kLineWarps - 1) / kLineWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int C8 = C / 8;
  auto launch = [&](auto group) {
    constexpr int G = decltype(group)::value;
    projline_linemom_kernel<G><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(coefs), static_cast<const float*>(jac),
        static_cast<const float*>(out), static_cast<const float*>(dx),
        static_cast<const float*>(dy), static_cast<const float*>(tgt),
        static_cast<float*>(lm), V, W, AY, AX, C8, n_lines, tgt_sb, tgt_sv,
        tgt_su);
  };
  if (C8 >= 32) {
    launch(std::integral_constant<int, 32>{});
  } else if (C8 >= 16) {
    launch(std::integral_constant<int, 16>{});
  } else if (C8 >= 8) {
    launch(std::integral_constant<int, 8>{});
  } else if (C8 >= 4) {
    launch(std::integral_constant<int, 4>{});
  } else if (C8 >= 2) {
    launch(std::integral_constant<int, 2>{});
  } else {
    launch(std::integral_constant<int, 1>{});
  }
  return static_cast<int>(cudaGetLastError());
}
