// Per-particle SPH footprint deposit shared by the 2D deposit kernels
// (deposit2d.cu: sorted engine; coherent.cu: coherent engine), and the
// thread-block-cluster split both use.
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
// outside the support; here the loops visit only a box that holds the
// support (its radius plus a rounding slack of 0.01 px + 1e-4 radius), and
// the exact q2 test, computed as the plain version computes it, decides
// every pixel. The skipped pixels hold exact zeros, so the sums are the
// same. Particles with h <= 0 or with every value 0 (pads) contribute
// exactly 0 and are skipped, as the plain version skips them. Adds go to a
// shared-memory accumulator with float atomics.
//
// The K = 8 and 16 levels' footprints of a few to ~200 pixels: a warp
// holds 32 particles, one a lane, and takes the (particle, box pixel) pairs
// of all 32 as one list, 32 a step (deposit_balanced), so that no lane
// idles while another walks a larger footprint; the sorted engine hands
// the lanes their particles spread over the block's share, loaded
// coalesced through shared memory (for_staged_spread). A tile's work is
// split over a cluster of C blocks (cluster_groups), each summing into its
// own shared accumulator; cluster_reduce_store then adds the C
// accumulators slice by slice through distributed shared memory and writes
// each slice once. The sorted engine's K >= 32 levels take particle_setup
// and footprint_weight from here and nothing of the accumulation: they sum
// output-stationary in registers (deposit2d.cu::deposit2d_register).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>
#include <utility>

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

// The particle's footprint: the values scaled by the kernel's
// normalisation, the pixel-to-normalised-distance factors and a loop box
// that holds every pixel the exact q2 test can pass. Returns false for a
// particle that adds exactly 0: h <= 0 (pads), or every value 0 (the pad
// slots of the shear and bucketed layouts).
struct Particle {
  float ul, vl;                // tile-local pixel coordinates
  float sx, sy;                // normalised distance per pixel in x and y
  float ve[kMaxFields];        // value * normalisation per field
  int r_lo, r_hi, c_lo, c_hi;  // loop box, inclusive
};

// The box's slack beyond the support radius, in pixels: the f32 test
// q2 < lim2 passes only pixels within the radius times (1 + ~1e-6), and
// the pixel coordinates carry ~1e-5 px of rounding at 128 px.
__device__ __forceinline__ float box_slack(float radius) {
  return 0.01f + 1e-4f * radius;
}

template <bool INTEG>
__device__ __forceinline__ bool particle_setup(const Footprint& p, int f_n, float ul,
                                               float vl, float hi, const float* val,
                                               long long val_stride, Particle& q) {
  if (!(hi > 0.0f)) return false;
  bool any = false;
#pragma unroll
  for (int f = 0; f < kMaxFields; ++f) {
    q.ve[f] = f < f_n ? val[f * val_stride] : 0.0f;
    any |= q.ve[f] != 0.0f;
  }
  if (!any) return false;
  const float inv_h = 1.0f / hi;
  float inv_n, val_scale;
  if constexpr (INTEG) {
    inv_n = inv_h * p.inv_sf;
    val_scale = inv_h * inv_h;
  } else {
    inv_n = inv_h;
    val_scale = (p.norm3d * inv_h) * (inv_h * inv_h);
  }
#pragma unroll
  for (int f = 0; f < kMaxFields; ++f) q.ve[f] *= val_scale;
  q.ul = ul;
  q.vl = vl;
  q.sy = p.psy * inv_n;
  q.sx = p.psx * inv_n;
  // the box needs only a radius within its slack: fast division
  const float ry = __fdividef(p.lim, q.sy);
  const float rx = __fdividef(p.lim, q.sx);
  const float ey = box_slack(ry), ex = box_slack(rx);
  const float cy = vl - p.offset, cx = ul - p.offset;
  const int col0 = (int)floorf(ul - p.offset + 0.5f) - p.K / 2;
  // clamp in float before the int conversion (a huge h must not overflow)
  q.r_lo = (int)ceilf(fmaxf(cy - ry - ey, -1.0f));
  q.r_hi = (int)floorf(fminf(cy + ry + ey, (float)p.R));
  q.c_lo = (int)ceilf(fmaxf(cx - rx - ex, -1.0f));
  q.c_hi = (int)floorf(fminf(cx + rx + ex, (float)kLanes));
  q.r_lo = max(q.r_lo, 0);
  q.r_hi = min(q.r_hi, p.R - 1);
  q.c_lo = max(max(q.c_lo, col0), 0);
  q.c_hi = min(min(q.c_hi, col0 + p.K - 1), kLanes - 1);
  return q.r_lo <= q.r_hi && q.c_lo <= q.c_hi;
}

template <int KID, bool INTEG>
__device__ __forceinline__ float footprint_weight(float q2, const float* s_cheb, int n_cheb) {
  if constexpr (INTEG) {
    return clenshaw(2.0f * fminf(fmaxf(q2, 0.0f), 1.0f) - 1.0f, s_cheb, n_cheb);
  } else {
    return shape_q<KID>(sqrtf(q2));
  }
}

// footprint_weight with the 3D kernel's root taken as q2 / sqrt(q2) by the
// reciprocal root: two instructions against the correctly rounded root's
// sequence and its branch, within 2 ulp of it. The output-stationary
// kernels take it (deposit2d.cu's register path, deposit_wide.cu). The
// argument is at least 1e-30, so the root needs no denormal scaling.
template <int KID, bool INTEG>
__device__ __forceinline__ float footprint_weight_rsqrt(float q2, const float* s_cheb, int n_cheb) {
  if constexpr (INTEG) {
    return footprint_weight<KID, INTEG>(q2, s_cheb, n_cheb);
  } else {
    float r;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(fmaxf(q2, 1e-30f)));
    return shape_q<KID>(q2 * r);
  }
}

// acc[f * plane + r * kLanes + c] += w * ve[f] where pixel (r, c) passes the
// exact test. The normalised offsets are computed as the plain torch
// version computes them ((r + offset - v) * sy), so the test picks the
// same pixels.
template <int KID, bool INTEG>
__device__ __forceinline__ void add_pixel(float* acc, int plane, int f_n, const Footprint& p,
                                          const float* s_cheb, int n_cheb, const Particle& q,
                                          int r, int c) {
  const float dyn = ((float)r + p.offset - q.vl) * q.sy;
  const float dxn = ((float)c + p.offset - q.ul) * q.sx;
  const float q2 = dyn * dyn + dxn * dxn;
  if (q2 >= p.lim2) return;
  const float w = footprint_weight<KID, INTEG>(q2, s_cheb, n_cheb);
  float* px = acc + r * kLanes + c;
#pragma unroll
  for (int f = 0; f < kMaxFields; ++f)
    if (f < f_n) atomicAdd(px + f * plane, w * q.ve[f]);
}

// A warp deposits its 32 lanes' particles together (the K = 8 and 16
// levels' footprints, which differ from lane to lane by up to ~30x in
// area): the (particle, box pixel) pairs of the 32 particles form one
// list, in lane order and row-major within a box, and the warp takes it 32
// pairs a step, lane k on pair base + k. A lane finds its pair's particle by
// a binary search over the warp's inclusive prefix of box sizes and reads
// that particle's constants from its lane by shuffles. So no lane idles
// while another walks a large footprint, and one step's adds go mostly to
// distinct pixels. Every lane of the warp calls this, with h = 0 where it
// has no particle.
template <int KID, bool INTEG>
__device__ __forceinline__ void deposit_balanced(float* acc, int plane, int f_n, const Footprint& p,
                                                 const float* s_cheb, int n_cheb, float ul, float vl,
                                                 float hi, const float* val, long long val_stride) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  Particle q{};  // a lane without a particle shuffles zeros, never read
  const bool live = particle_setup<INTEG>(p, f_n, ul, vl, hi, val, val_stride, q);
  const int nc = live ? q.c_hi - q.c_lo + 1 : 1;
  const int work = live ? (q.r_hi - q.r_lo + 1) * nc : 0;
  int incl = work;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kAll, incl, o);
    if (lane >= o) incl += t;
  }
  const int total = __shfl_sync(kAll, incl, 31);
  const float inv_nc = 1.0f / (float)nc;  // exact enough: off < 2^12, nc <= 128
  for (int base = 0; base < total; base += 32) {
    const int k = base + lane;
    // the pair's particle: the first lane whose inclusive prefix exceeds k
    int own = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1)
      if (__shfl_sync(kAll, incl, own + step - 1) <= k) own += step;
    Particle o;
    o.ul = __shfl_sync(kAll, q.ul, own);
    o.vl = __shfl_sync(kAll, q.vl, own);
    o.sx = __shfl_sync(kAll, q.sx, own);
    o.sy = __shfl_sync(kAll, q.sy, own);
#pragma unroll
    for (int f = 0; f < kMaxFields; ++f)
      o.ve[f] = f < f_n ? __shfl_sync(kAll, q.ve[f], own) : 0.0f;
    const int o_start = __shfl_sync(kAll, incl - work, own);
    const int o_nc = __shfl_sync(kAll, nc, own);
    const float o_inv_nc = __shfl_sync(kAll, inv_nc, own);
    const int o_rlo = __shfl_sync(kAll, q.r_lo, own);
    const int o_clo = __shfl_sync(kAll, q.c_lo, own);
    if (k < total) {
      const int off = k - o_start;
      const int rr = (int)(((float)off + 0.5f) * o_inv_nc);
      add_pixel<KID, INTEG>(acc, plane, f_n, p, s_cheb, n_cheb, o, o_rlo + rr, o_clo + (off - rr * o_nc));
    }
  }
}

// The cluster split of a tile's n items: the items form groups of `group`
// consecutive items (8 particles, one 32-byte sector an array, for the
// sorted engine; 1 candidate row for the coherent engine), and rank r of a
// C-block cluster takes groups r, r + C, r + 2 C, ...: an item at offset o
// in the tile belongs to rank (o / group) mod C, as
// ops/deposit_tiled.py::cluster_rank computes it. The ranks' shares differ
// by at most one group, and each covers the whole tile's area (a
// contiguous range of the tile's Morton-ordered items would cover 1/C of
// it and stack the block's adds there). Returns the rank's group count.
__device__ __forceinline__ int cluster_groups(int n, int group, int rank, int C) {
  const int n_groups = (n + group - 1) / group;
  return rank < n_groups ? (n_groups - rank + C - 1) / C : 0;
}

// Shared-memory staging of the sorted engine's lane-per-particle levels:
// kStage items a step, (3 + kMaxFields) floats each.
constexpr int kStage = 256;
constexpr int kStageFloats = kStage * (3 + kMaxFields);

// The lane-per-particle walk over a block's items, given as n_groups
// groups of 8 (items 8 g + [0, 8) of group g), run by all kStage = 256
// threads (8 warps) of the block. The groups form 32 segments of Lg =
// ceil(n_groups / 32) consecutive groups. Each step loads one group of
// every segment into shared memory (thread t loads item t % 8 of segment
// t / 8's group: a warp's load covers four full 32-byte sectors an array),
// prefetching the next step's into registers while the current one
// deposits; then lane l of warp w deposits item w of segment (l + 4 w) mod
// 32's group. So the 32 lanes of a warp hold items far apart in the input's
// (Morton) order, not neighbours that stack their adds on one pixel, the
// warps start on different segments, and the loads stay coalesced.
// load(g, o, u, v, h, vals) reads item o of group g or leaves h = 0 where
// there is none, which deposits nothing. Calls fn(u, v, h, vals,
// vals_stride) on each item slot, every lane of every warp together. Every
// thread must call this with the same n_groups (it synchronises the block).
template <typename Load, typename Fn>
__device__ __forceinline__ void for_staged_spread(int n_groups, int f_n, float* s_stage, Load&& load,
                                                  Fn&& fn) {
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int Lg = (n_groups + 31) / 32;
  const int seg = t >> 3, off = t & 7;
  float ru = 0.0f, rv = 0.0f, rh = 0.0f, rval[kMaxFields] = {};
  auto fetch = [&](int s) {
    const int g = seg * Lg + s;
    rh = 0.0f;
    if (g < n_groups) load(g, off, ru, rv, rh, rval);
  };
  fetch(0);
  const int k = ((lane + 4 * warp) & 31) * 8 + warp;
  for (int s = 0; s < Lg; ++s) {
    __syncthreads();  // the previous step's items are consumed
    s_stage[t] = ru;
    s_stage[kStage + t] = rv;
    s_stage[2 * kStage + t] = rh;
#pragma unroll
    for (int f = 0; f < kMaxFields; ++f)
      if (f < f_n) s_stage[(3 + f) * kStage + t] = rval[f];
    __syncthreads();
    if (s + 1 < Lg) fetch(s + 1);
    fn(s_stage[k], s_stage[kStage + k], s_stage[2 * kStage + k], s_stage + 3 * kStage + k, kStage);
  }
}

// The cluster's reduce-scatter: after every block of the C-block cluster
// has summed its share into its own shared accumulator `acc` (n_acc floats,
// a multiple of 4), block `rank` adds slice `rank` of the C accumulators in
// rank order through distributed shared memory and writes it to `dst`.
// The trailing sync keeps every block's shared memory alive until the
// cluster's reads are done.
__device__ __forceinline__ void cluster_reduce_store(float* acc, int n_acc, float* dst, int C) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int n4 = n_acc / 4;
  const int rank = (int)cluster.block_rank();
  const int lo = (int)(((long long)n4 * rank) / C);
  const int hi = (int)(((long long)n4 * (rank + 1)) / C);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    float4 s = reinterpret_cast<const float4*>(cluster.map_shared_rank(acc, 0))[i];
    for (int k = 1; k < C; ++k) {
      const float4 a = reinterpret_cast<const float4*>(cluster.map_shared_rank(acc, k))[i];
      s.x += a.x;
      s.y += a.y;
      s.z += a.z;
      s.w += a.w;
    }
    d4[i] = s;
  }
  cluster.sync();
}

// Launch `kern` over n_tiles clusters of C blocks (grid n_tiles * C, block
// t * C + r is rank r of tile t's cluster). A launch the card refuses
// (cluster too large for its shared memory, bad size) returns its error.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kern)(Params...), int n_tiles, int C, int threads,
                            size_t smem, cudaStream_t stream, Args&&... args) {
  if (C < 1 || C > 8) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n_tiles * (unsigned)C, 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, std::forward<Args>(args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
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
