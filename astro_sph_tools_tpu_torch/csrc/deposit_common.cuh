// Per-particle SPH footprint deposit shared by the 2D deposit kernels
// (deposit2d.cu: sorted engine; coherent.cu: coherent engine).
//
// Counterpart of the TPU's astro_sph_tools_tpu/ops/deposit_pallas.py::
// _chunk_contrib: one particle's contribution to a tile's (F*R, 128) f32
// extended accumulator,
//     acc[f*R + r][c] += val_f * W(r, c),
// over the K columns col0 + [0, K), col0 = floor(u - offset + 0.5) - K/2, in
// TILE-LOCAL pixel coordinates (u, v). Columns outside [0, 128) are masked,
// not clipped or wrapped.
//
//   kernel3d:    W = shape_q(sqrt(q2)) * norm_3d / h^3,   q = r / h
//   integrated:  W = clenshaw(2 clip(q2, 0, 1) - 1) * [q2 < 1] / h^2,
//                q = r / (S_f h)   (line-integrated column kernel)
//
// The TPU evaluates every particle's full R x K window and sums zeros
// outside the support; here the loops visit only the pixels inside a box
// that contains the support (widened by a pixel on each side), and the
// exact q2 test inside decides. The skipped pixels hold exact zeros, so the
// sums are the same. Particles with h <= 0 (pads) contribute exactly 0.
// Adds go to a shared-memory accumulator with float atomics.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

namespace ast {

constexpr int kLanes = 128;   // accumulator width S
constexpr int kMaxCheb = 64;  // Chebyshev coefficients held in shared memory
constexpr int kMaxFields = 5;

// Divide-free kernel shapes, ops as in kernels/splines.py (*_shape).
template <int KID>
__device__ __forceinline__ float shape_q(float q) {
  if constexpr (KID == 0) {  // M4 cubic spline
    float inner = 1.0f - 1.5f * q * q + 0.75f * q * q * q;
    float ob = 2.0f - q;
    float outer = 0.25f * ob * ob * ob;
    return q < 1.0f ? inner : (q < 2.0f ? outer : 0.0f);
  } else if constexpr (KID == 1) {  // Wendland C2
    float u = 0.5f * q;
    float om = fmaxf(1.0f - u, 0.0f);
    float p2 = om * om;
    return (p2 * p2) * (1.0f + 4.0f * u);
  } else if constexpr (KID == 2) {  // Wendland C4
    float u = 0.5f * q;
    float om = fmaxf(1.0f - u, 0.0f);
    float p2 = om * om;
    float p6 = p2 * p2 * p2;
    return p6 * (1.0f + 6.0f * u + (35.0f / 3.0f) * u * u);
  } else if constexpr (KID == 3) {  // Wendland C6
    float u = 0.5f * q;
    float om = fmaxf(1.0f - u, 0.0f);
    float p2 = om * om;
    float p8 = p2 * p2 * p2 * p2;
    return p8 * (1.0f + 8.0f * u + 25.0f * u * u + 32.0f * u * u * u);
  } else {  // M6 quintic spline
    float a = fmaxf(3.0f - q, 0.0f), b = fmaxf(2.0f - q, 0.0f), c = fmaxf(1.0f - q, 0.0f);
    float a2 = a * a, b2 = b * b, c2 = c * c;
    float w = a2 * a2 * a - 6.0f * (b2 * b2 * b) + 15.0f * (c2 * c2 * c);
    return q < 3.0f ? w : 0.0f;
  }
}

__device__ __forceinline__ float clenshaw(float x, const float* c, int n) {
  float b1 = 0.0f, b2 = 0.0f;
  for (int k = n - 1; k > 0; --k) {
    float t = 2.0f * x * b1 - b2 + c[k];
    b2 = b1;
    b1 = t;
  }
  return x * b1 - b2 + c[0];
}

// Geometry and kernel constants of one level's deposit.
struct Footprint {
  int K, R;        // column window, accumulator rows
  float offset;    // pixel sample offset (0.5: centres)
  float psx, psy;  // pixel size (world units)
  float norm3d;    // 3D kernel normalisation
  float inv_sf;    // 1 / support_factor
  float lim, lim2; // normalised support radius and its square
};

inline Footprint make_footprint(int K, int R, float offset, float psx, float psy,
                                float norm3d, float support_factor,
                                int integrated) {
  Footprint p;
  p.K = K;
  p.R = R;
  p.offset = offset;
  p.psx = psx;
  p.psy = psy;
  p.norm3d = norm3d;
  p.inv_sf = 1.0f / support_factor;
  // lim2: squared normalised support (q2 >= lim2 is an exact zero)
  p.lim2 = integrated ? 1.0f : support_factor * support_factor;
  p.lim = std::sqrt(p.lim2);
  return p;
}

// Deposit one particle (tile-local u, v; smoothing length h; f_n values at
// val[f * val_stride]) into acc, whose field planes are `plane` floats apart.
template <int KID, bool INTEG>
__device__ __forceinline__ void deposit_particle(
    float* acc, int plane, int f_n, const Footprint& p, const float* s_cheb,
    int n_cheb, float ul, float vl, float hi, const float* val,
    long long val_stride) {
  if (!(hi > 0.0f)) return;  // zero-h pads contribute exactly 0
  const float inv_h = 1.0f / hi;
  float inv_n, val_scale;
  if constexpr (INTEG) {
    inv_n = inv_h * p.inv_sf;
    val_scale = inv_h * inv_h;
  } else {
    inv_n = inv_h;
    val_scale = (p.norm3d * inv_h) * (inv_h * inv_h);
  }
  float ve[kMaxFields];
#pragma unroll
  for (int f = 0; f < kMaxFields; ++f)
    ve[f] = f < f_n ? val[f * val_stride] * val_scale : 0.0f;

  const float sy = p.psy * inv_n;
  const float sx = p.psx * inv_n;
  // Support radius in pixels, widened by one pixel on each side: the loop
  // bounds only need to contain every pixel with q2 < lim2, which the
  // exact test below then decides.
  const float ry = p.lim / sy, rx = p.lim / sx;
  const int K = p.K, R = p.R;
  const float offset = p.offset;
  const int col0 = (int)floorf(ul - offset + 0.5f) - K / 2;
  int r_lo = (int)fmaxf(floorf(vl - offset - ry) - 1.0f, 0.0f);
  int r_hi = (int)fminf(ceilf(vl - offset + ry) + 1.0f, (float)(R - 1));
  int c_lo = max(max(col0, 0), (int)fmaxf(floorf(ul - offset - rx) - 1.0f, -1.0f));
  int c_hi = min(min(col0 + K - 1, kLanes - 1),
                 (int)fminf(ceilf(ul - offset + rx) + 1.0f, (float)kLanes));

  for (int r = r_lo; r <= r_hi; ++r) {
    const float dyn = ((float)r + offset - vl) * sy;
    const float dy2n = dyn * dyn;
    if (dy2n >= p.lim2) continue;
    float* row = acc + r * kLanes;
    for (int c = c_lo; c <= c_hi; ++c) {
      const float dxn = ((float)c + offset - ul) * sx;
      const float q2 = dy2n + dxn * dxn;
      if (q2 >= p.lim2) continue;
      float w;
      if constexpr (INTEG) {
        w = clenshaw(2.0f * fminf(fmaxf(q2, 0.0f), 1.0f) - 1.0f, s_cheb, n_cheb);
      } else {
        w = shape_q<KID>(sqrtf(q2));
      }
#pragma unroll
      for (int f = 0; f < kMaxFields; ++f)
        if (f < f_n) atomicAdd(row + f * plane + c, w * ve[f]);
    }
  }
}

// Call launch(kid, integ) with the compile-time kernel id and projection:
// the integrated weight ignores the kernel id (its Chebyshev table carries
// the kernel), kernel3d switches over the five kernels.
template <typename Launch>
cudaError_t dispatch_footprint(int kernel_id, int integrated, Launch&& launch) {
  using I0 = std::integral_constant<int, 0>;
  if (integrated) return launch(I0{}, std::true_type{});
  switch (kernel_id) {
    case 0: return launch(I0{}, std::false_type{});
    case 1: return launch(std::integral_constant<int, 1>{}, std::false_type{});
    case 2: return launch(std::integral_constant<int, 2>{}, std::false_type{});
    case 3: return launch(std::integral_constant<int, 3>{}, std::false_type{});
    case 4: return launch(std::integral_constant<int, 4>{}, std::false_type{});
    default: return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory above the default 48 KiB needs an opt-in per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

inline cudaError_t smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

}  // namespace ast
