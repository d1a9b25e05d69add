// Native host-side image warp kernels for the data pipeline.
//
// The reference's ground-truth synthesis runs 4 sequential PIL resampling
// passes per sample (rotate -> affine -> affine -> rotate; reference
// dataLoader/KITTI_dataset.py:128-152).  For training throughput this module
// provides a single-pass fused affine warp (the 4 affine maps compose into
// one 6-dof matrix on the Python side); eval keeps the PIL-exact chain for
// resampling parity (SURVEY.md §7.3-2).
//
// Bilinear semantics match PIL Image.transform(..., AFFINE, BILINEAR):
// output pixel (x, y) samples the source at
//   (a*(x+0.5) + b*(y+0.5) + c - 0.5,  d*(x+0.5) + e*(y+0.5) + f - 0.5)
// with zero fill outside the source.
//
// Built as a plain C shared object (no pybind11 in this image); loaded via
// ctypes from native/__init__.py.

#include <cstdint>
#include <cmath>
#include <algorithm>

extern "C" {

// uint8 HWC -> uint8 HWC single affine warp with bilinear filtering.
void affine_warp_u8(const uint8_t* src, int sh, int sw, int c,
                    uint8_t* dst, int dh, int dw,
                    double a, double b, double tx,
                    double d, double e, double ty) {
  for (int y = 0; y < dh; ++y) {
    const double yc = y + 0.5;
    for (int x = 0; x < dw; ++x) {
      const double xc = x + 0.5;
      const double sx = a * xc + b * yc + tx - 0.5;
      const double sy = d * xc + e * yc + ty - 0.5;
      uint8_t* out = dst + (static_cast<long>(y) * dw + x) * c;
      const double fx = std::floor(sx), fy = std::floor(sy);
      const int x0 = static_cast<int>(fx), y0 = static_cast<int>(fy);
      if (x0 < -1 || y0 < -1 || x0 >= sw || y0 >= sh) {
        for (int ch = 0; ch < c; ++ch) out[ch] = 0;
        continue;
      }
      const double wx1 = sx - fx, wy1 = sy - fy;
      const double wx0 = 1.0 - wx1, wy0 = 1.0 - wy1;
      const int x1 = x0 + 1, y1 = y0 + 1;
      const bool vx0 = x0 >= 0 && x0 < sw, vx1 = x1 >= 0 && x1 < sw;
      const bool vy0 = y0 >= 0 && y0 < sh, vy1 = y1 >= 0 && y1 < sh;
      const uint8_t* r0 = src + (static_cast<long>(std::max(y0, 0)) * sw) * c;
      const uint8_t* r1 = src + (static_cast<long>(std::min(y1, sh - 1)) * sw) * c;
      for (int ch = 0; ch < c; ++ch) {
        double acc = 0.0;
        if (vy0) {
          if (vx0) acc += wx0 * wy0 * r0[x0 * c + ch];
          if (vx1) acc += wx1 * wy0 * r0[x1 * c + ch];
        }
        if (vy1) {
          if (vx0) acc += wx0 * wy1 * r1[x0 * c + ch];
          if (vx1) acc += wx1 * wy1 * r1[x1 * c + ch];
        }
        out[ch] = static_cast<uint8_t>(
            std::min(255.0, std::max(0.0, acc + 0.5)));
      }
    }
  }
}

// float32 HWC variant (zero fill), same sampling convention.
void affine_warp_f32(const float* src, int sh, int sw, int c,
                     float* dst, int dh, int dw,
                     double a, double b, double tx,
                     double d, double e, double ty) {
  for (int y = 0; y < dh; ++y) {
    const double yc = y + 0.5;
    for (int x = 0; x < dw; ++x) {
      const double xc = x + 0.5;
      const double sx = a * xc + b * yc + tx - 0.5;
      const double sy = d * xc + e * yc + ty - 0.5;
      float* out = dst + (static_cast<long>(y) * dw + x) * c;
      const double fx = std::floor(sx), fy = std::floor(sy);
      const int x0 = static_cast<int>(fx), y0 = static_cast<int>(fy);
      if (x0 < -1 || y0 < -1 || x0 >= sw || y0 >= sh) {
        for (int ch = 0; ch < c; ++ch) out[ch] = 0.f;
        continue;
      }
      const double wx1 = sx - fx, wy1 = sy - fy;
      const double wx0 = 1.0 - wx1, wy0 = 1.0 - wy1;
      const int x1 = x0 + 1, y1 = y0 + 1;
      const bool vx0 = x0 >= 0 && x0 < sw, vx1 = x1 >= 0 && x1 < sw;
      const bool vy0 = y0 >= 0 && y0 < sh, vy1 = y1 >= 0 && y1 < sh;
      const float* r0 = src + (static_cast<long>(std::max(y0, 0)) * sw) * c;
      const float* r1 = src + (static_cast<long>(std::min(y1, sh - 1)) * sw) * c;
      for (int ch = 0; ch < c; ++ch) {
        double acc = 0.0;
        if (vy0) {
          if (vx0) acc += wx0 * wy0 * r0[x0 * c + ch];
          if (vx1) acc += wx1 * wy0 * r0[x1 * c + ch];
        }
        if (vy1) {
          if (vx0) acc += wx0 * wy1 * r1[x0 * c + ch];
          if (vx1) acc += wx1 * wy1 * r1[x1 * c + ch];
        }
        out[ch] = static_cast<float>(acc);
      }
    }
  }
}

// uint8 HWC -> float32 HWC warp + /255 normalize in one pass (fused decode
// of the pipeline's to-tensor step).
void affine_warp_u8_to_f32(const uint8_t* src, int sh, int sw, int c,
                           float* dst, int dh, int dw,
                           double a, double b, double tx,
                           double d, double e, double ty) {
  const double inv255 = 1.0 / 255.0;
  for (int y = 0; y < dh; ++y) {
    const double yc = y + 0.5;
    for (int x = 0; x < dw; ++x) {
      const double xc = x + 0.5;
      const double sx = a * xc + b * yc + tx - 0.5;
      const double sy = d * xc + e * yc + ty - 0.5;
      float* out = dst + (static_cast<long>(y) * dw + x) * c;
      const double fx = std::floor(sx), fy = std::floor(sy);
      const int x0 = static_cast<int>(fx), y0 = static_cast<int>(fy);
      if (x0 < -1 || y0 < -1 || x0 >= sw || y0 >= sh) {
        for (int ch = 0; ch < c; ++ch) out[ch] = 0.f;
        continue;
      }
      const double wx1 = sx - fx, wy1 = sy - fy;
      const double wx0 = 1.0 - wx1, wy0 = 1.0 - wy1;
      const int x1 = x0 + 1, y1 = y0 + 1;
      const bool vx0 = x0 >= 0 && x0 < sw, vx1 = x1 >= 0 && x1 < sw;
      const bool vy0 = y0 >= 0 && y0 < sh, vy1 = y1 >= 0 && y1 < sh;
      const uint8_t* r0 = src + (static_cast<long>(std::max(y0, 0)) * sw) * c;
      const uint8_t* r1 = src + (static_cast<long>(std::min(y1, sh - 1)) * sw) * c;
      for (int ch = 0; ch < c; ++ch) {
        double acc = 0.0;
        if (vy0) {
          if (vx0) acc += wx0 * wy0 * r0[x0 * c + ch];
          if (vx1) acc += wx1 * wy0 * r0[x1 * c + ch];
        }
        if (vy1) {
          if (vx0) acc += wx0 * wy1 * r1[x0 * c + ch];
          if (vx1) acc += wx1 * wy1 * r1[x1 * c + ch];
        }
        out[ch] = static_cast<float>(acc * inv255);
      }
    }
  }
}

}  // extern "C"
