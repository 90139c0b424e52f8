// The 3D deposit's oversize route, for Hopper: footprints wider than kernel
// #6's widest level (support radius past 7 voxels), summed
// output-stationary.
//
// Replaces no TPU kernel. The JAX package sends these footprints to XLA
// (astro_sph_tools_tpu/ops/grid3d.py's K = 32 stencil and its dense pass, a
// whole grid a particle); the port's plain torch route
// (ops/grid3d.py::deposit_3d) adds them with 32^3 windows and index_add_,
// or with a pass over every voxel of the cube a particle. Kernel #6 cannot
// take them: its K = 16 level's boxes hold s <= 7, and wider levels would
// stage every candidate in 125-729 regions of 8^3 voxels.
//
// Contract: for the particles i of one oversize segment, in GLOBAL f32
// voxel coordinates (u_i, v_i, w_i) (tile_particles_3d's sorted_u/v/w past
// its levels), h_i > 0 and values val_f(i),
//     out[f][z][y][x] += sum_i val_f(i) * norm_3d / h_i^3 * shape_q(q),
//     q^2 = ((x + offset - u) psx / h)^2 + ((y + offset - v) psy / h)^2
//           + ((z + offset - w) psz / h)^2  (< support_factor^2),
// the offsets taken per axis at the particle's nearest image on a periodic
// axis (as the dense pass takes them, supports wider than the grid
// included); shape_q is deposit_common.cuh's, the root by the reciprocal
// root.
//
// Bound on the card: FP32 operations. At the L0025 cube's oversize
// footprints (s = 7-15.4 voxels) a particle covers 1.4k-15k voxels, and the
// pairs inside the supports (~2.2e10 a product, 14 + 2F operations each)
// outweigh the bytes (each particle read once, each voxel read and written
// once) some 100x.
//
// Design, against that bound: output-stationary, no atomics.
//   1. Binning (torch, ops/grid3d_wide.py::tile_lists): each particle lists
//      the 16^3 output tiles its support's bounding box meets, in particle
//      order, and a stable sort by tile makes each tile's list (a tile's
//      entries in particle order, so the sums below are the same on every
//      run). The blocks run the tiles longest list first.
//   2. Deposit (wide3d_deposit_kernel): a block a tile, a thread an (x, y)
//      column of it. The block stages 256 entries at a time (u, v, w, the
//      normalised distance a voxel per axis and the scaled values) in
//      shared memory. For each, a thread whose column the support meets
//      (dx^2 + dy^2 < lim^2) walks only the voxels of its column inside the
//      support, the chord |z + offset - w| < sqrt(lim^2 - dx^2 - dy^2) / sz
//      (0.01 voxel of slack; the exact test q^2 < lim^2 decides each
//      voxel), and adds into the tile's F x 16^3 sums in shared memory:
//      each voxel is one thread's alone, and a warp's 32 columns fall on 32
//      banks whatever voxel of its column each lane is at. The block then
//      adds the tile into the cube once, with plain loads and stores (the
//      cube holds #6's levels already; nothing else writes the tile during
//      the launch).
// No K^3 window: a thread evaluates the voxels of its chord, so the pairs
// evaluated are those inside the supports; what is lost is the lanes of a
// warp whose chords are shorter than the longest, and the columns a
// support misses.

#include "deposit_common.cuh"

namespace {

constexpr int kT = 16;                // output tile side (voxels), every axis
constexpr int kThreads = kT * kT;     // a thread an (x, y) column of the tile
constexpr int kVox = kT * kT * kT;    // voxels of a tile
constexpr int kStage = kThreads;      // list entries staged at once
constexpr int kMaxFields3 = 4;
constexpr float kSlack = 0.01f;       // voxels a chord is widened by

// The cube and the kernel constants shared by every block.
struct Cube {
  int nx, ny, nz;             // the cube (voxels)
  int ntx, nty;               // tiles a row, tile rows a plane
  int per_x, per_y, per_z;    // minimum image per axis
  float offset;               // voxel sample offset (0.5: centres)
  float psx, psy, psz;        // voxel edges (world units)
  float norm3d, lim2;         // 3D kernel normalisation, squared support
};

// The periodic image of an offset d (voxels) on an axis of period L, as
// the dense pass takes it.
__device__ __forceinline__ float min_image(float d, float L, float inv_L) {
  return d - L * rintf(d * inv_L);
}

// sqrt from the hardware reciprocal square root (a few ulp: the weights
// keep ~1e-7 of their value), as kernel #6 takes it
__device__ __forceinline__ float fast_sqrt(float x) { return x > 0.0f ? x * rsqrtf(x) : 0.0f; }

// Add the particle's terms at voxel (kz, column) if q2 is inside the
// support; col points at the column's voxel 0 of field 0.
template <int KID, int F>
__device__ __forceinline__ void add_voxel(float* col, int kz, float q2, float lim2, const float* ve) {
  if (q2 < lim2) {
    const float wgt = ast::shape_q<KID>(fast_sqrt(q2));
    float* cell = col + kz * kThreads;
#pragma unroll
    for (int f = 0; f < F; ++f) cell[f * kVox] = fmaf(wgt, ve[f], cell[f * kVox]);
  }
}

// The deposit of each tile's list into out (F fields of nz x ny x nx,
// cube floats apart): block b takes tile order[b] (see the file's head).
template <int KID, int F>
__global__ void __launch_bounds__(kThreads)
wide3d_deposit_kernel(const float* __restrict__ u, const float* __restrict__ v,
                      const float* __restrict__ w, const float* __restrict__ h,
                      const float* __restrict__ vals, long long ld_vals,
                      const long long* __restrict__ starts, const int* __restrict__ lists,
                      const int* __restrict__ order, Cube g, float* __restrict__ out) {
  extern __shared__ float s_acc[];   // F x kT^3 sums: [f][z][y][x]
  __shared__ float4 s_pos[kStage];   // u, v, w, sz
  __shared__ float2 s_sxy[kStage];   // sx, sy
  __shared__ float s_val[F][kStage]; // values times the kernel's normalisation
  const int tile = order[blockIdx.x];
  const long long lo = starts[tile], hi = starts[tile + 1];
  if (lo == hi) return;
  const int tz = tile / (g.ntx * g.nty), rem = tile - tz * (g.ntx * g.nty);
  const int ty = rem / g.ntx, tx = rem - ty * g.ntx;
  const int t = threadIdx.x;
  const int x = tx * kT + (t % kT), y = ty * kT + t / kT, z0 = tz * kT;
  const bool mine = x < g.nx && y < g.ny;
  const int nzt = min(kT, g.nz - z0);
  const float xc = (float)x + g.offset, yc = (float)y + g.offset;
  const float Lx = (float)g.nx, Ly = (float)g.ny, Lz = (float)g.nz;
  const float inv_Lx = 1.0f / Lx, inv_Ly = 1.0f / Ly, inv_Lz = 1.0f / Lz;
  float* col = s_acc + t;
  for (int k = t; k < F * kVox; k += kThreads) s_acc[k] = 0.0f;

  for (long long c0 = lo; c0 < hi; c0 += kStage) {
    const int m = (int)min((long long)kStage, hi - c0);
    __syncthreads();  // the previous stage is consumed (and the sums zeroed)
    if (t < m) {
      const int p = lists[c0 + t];
      const float inv_h = 1.0f / h[p];  // h > 0: the binning lists no other
      const float scale = (g.norm3d * inv_h) * (inv_h * inv_h);
      s_pos[t] = make_float4(u[p], v[p], w[p], g.psz * inv_h);
      s_sxy[t] = make_float2(g.psx * inv_h, g.psy * inv_h);
#pragma unroll
      for (int f = 0; f < F; ++f) s_val[f][t] = vals[f * ld_vals + p] * scale;
    }
    __syncthreads();
    if (!mine) continue;
    for (int j = 0; j < m; ++j) {
      const float4 a = s_pos[j];
      const float2 sxy = s_sxy[j];
      float dx = xc - a.x;
      if (g.per_x) dx = min_image(dx, Lx, inv_Lx);
      float dy = yc - a.y;
      if (g.per_y) dy = min_image(dy, Ly, inv_Ly);
      const float dxn = dx * sxy.x, dyn = dy * sxy.y;
      const float dxy2 = dxn * dxn + dyn * dyn;
      if (!(dxy2 < g.lim2)) continue;
      float ve[F];
#pragma unroll
      for (int f = 0; f < F; ++f) ve[f] = s_val[f][j];
      // the chord's half length (voxels) and the sample index at the centre
      const float half = __fdividef(sqrtf(g.lim2 - dxy2), a.w) + kSlack;
      const float zc = a.z - g.offset;
      if (g.per_z && 2.0f * half >= Lz) {
        // the chord covers the axis: every voxel takes the nearest image
        for (int k = 0; k < nzt; ++k) {
          const float dz = min_image(((float)(z0 + k) + g.offset) - a.z, Lz, inv_Lz) * a.w;
          add_voxel<KID, F>(col, k, dxy2 + dz * dz, g.lim2, ve);
        }
        continue;
      }
      // the particle's images at w + shift (one on an open axis); their
      // chords are disjoint, as 2 half < nz
      const int n_img = g.per_z ? 3 : 1;
      for (int im = 0; im < n_img; ++im) {
        const int shift = g.per_z ? (im - 1) * g.nz : 0;
        const float c = zc + (float)shift;
        // clamped in float first: a far-off centre must not overflow the int
        const float flo = fminf(fmaxf(c - half, (float)(z0 - 1)), (float)(z0 + kT));
        const float fhi = fminf(fmaxf(c + half, (float)(z0 - 1)), (float)(z0 + kT));
        const int k_lo = max(z0, (int)ceilf(flo)), k_hi = min(z0 + nzt - 1, (int)floorf(fhi));
        for (int k = k_lo; k <= k_hi; ++k) {
          // the offset from the image, as the stencil engine takes it
          const float dz = (((float)(k - shift) + g.offset) - a.z) * a.w;
          add_voxel<KID, F>(col, k - z0, dxy2 + dz * dz, g.lim2, ve);
        }
      }
    }
  }
  __syncthreads();  // every column is summed
  if (!mine) return;
  const long long cube = (long long)g.nz * g.ny * g.nx;
  for (int k = 0; k < nzt; ++k) {
    const long long at = ((long long)(z0 + k) * g.ny + y) * g.nx + x;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float s = col[f * kVox + k * kThreads];
      if (s != 0.0f) out[f * cube + at] += s;
    }
  }
}

}  // namespace

extern "C" {

// The deposit of the tile lists (starts: n_tiles + 1 int64, lists: int32
// particle indices, order: the n_tiles tiles, longest list first) into out
// ((n_fields, nz, ny, nx) f32, added into). u, v, w, h are the segment's
// (n,) f32 global voxel coordinates and smoothing lengths, vals (n_fields,
// n) with row stride ld_vals. Returns the launch's cudaError_t; it is
// asynchronous on `stream`.
int wide3d_deposit_launch(const float* u, const float* v, const float* w, const float* h,
                          const float* vals, long long ld_vals, int n_fields,
                          const long long* starts, const int* lists, const int* order,
                          int nx, int ny, int nz, int per_x, int per_y, int per_z,
                          float offset, float psx, float psy, float psz, int kernel_id,
                          float norm3d, float support_factor, float* out, void* stream) {
  if (n_fields < 1 || n_fields > kMaxFields3 || nx <= 0 || ny <= 0 || nz <= 0)
    return cudaErrorInvalidValue;
  Cube g;
  g.nx = nx;
  g.ny = ny;
  g.nz = nz;
  g.ntx = (nx + kT - 1) / kT;
  g.nty = (ny + kT - 1) / kT;
  const long long n_tiles = (long long)g.ntx * g.nty * ((nz + kT - 1) / kT);
  if (n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  g.per_x = per_x;
  g.per_y = per_y;
  g.per_z = per_z;
  g.offset = offset;
  g.psx = psx;
  g.psy = psy;
  g.psz = psz;
  g.norm3d = norm3d;
  g.lim2 = support_factor * support_factor;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t acc_bytes = (size_t)n_fields * kVox * sizeof(float);
  return ast::dispatch_footprint(kernel_id, 0, [&](auto kid, auto) {
    constexpr int KID = decltype(kid)::value;
    auto go = [&](auto f) {
      auto kern = wide3d_deposit_kernel<KID, decltype(f)::value>;
      cudaError_t e = ast::allow_smem(kern, acc_bytes);
      if (e != cudaSuccess) return e;
      kern<<<(unsigned)n_tiles, kThreads, acc_bytes, s>>>(u, v, w, h, vals, ld_vals, starts, lists, order, g,
                                                         out);
      return cudaGetLastError();
    };
    switch (n_fields) {
      case 1: return go(std::integral_constant<int, 1>{});
      case 2: return go(std::integral_constant<int, 2>{});
      case 3: return go(std::integral_constant<int, 3>{});
      default: return go(std::integral_constant<int, 4>{});
    }
  });
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
