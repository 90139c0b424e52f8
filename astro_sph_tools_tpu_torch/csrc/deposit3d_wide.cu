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
//   2. Deposit (wide3d_deposit_kernel): a block a tile. The block stages
//      256 entries at a time (u, v, w, the normalised distance a voxel per
//      axis and the scaled values) in shared memory. Warp w owns an 8 x 4
//      patch of the tile's (x, y) columns through all 16 planes, lane l the
//      column (l % 8, l / 8) of it, and the warp alone writes the patch's
//      F x 512 sums in shared memory.
//      a. Patch test: lane l tests staged entry j + l, the support's disk
//         against the patch's rectangle (nearest images), and a ballot
//         leaves the entries that meet the patch, in list order; the lane
//         also takes the entry's image shift (b), which the warp reads back
//         for each entry it walks.
//      b. Chords: for such an entry each lane takes its column's chord
//         inside the tile, |z + offset - w'| < sqrt(lim^2 - dx^2 - dy^2) / sz
//         (0.01 voxel of slack; the exact test q^2 < lim^2 decides each
//         voxel), w' the particle's one image that can meet the tile (the
//         nearest, where 2 half + 16 < nz on a periodic axis). Where another
//         image could meet it too, or the chord covers the axis (grids
//         narrower than the supports), each lane walks its own column.
//      c. Flattened walk: an inclusive scan of the chord lengths numbers
//         the patch's voxels inside the chords 0..T-1, column after column,
//         and the warp takes them 32 a step, lane l index 32 s + l. The
//         walking columns are listed in a per-warp table in order; a step
//         finds each lane's column from the OR of the chord heads that fall
//         in its 32 indices and a popcount, and its dz from the column's
//         first voxel. A step's lanes hit distinct voxels of the warp's own
//         patch, so plain shared loads and stores add them, and each voxel
//         takes its entries in list order; the warp takes two steps at a
//         time, their loads ahead of their stores (latency bounds it). The
//         sums lie plane after plane, a plane the F fields' 256 columns
//         (warp w's lane l at 32 w + l) and 5 floats of padding: a
//         column's planes fall 5 banks apart, and a step's voxels share a
//         bank ~1.9-way on the cube cell's supports (3.5-way with no
//         padding; a sampling of the flattened walks on the CPU); with the
//         stores taken out the kernel took as long, so they do not bound it.
//      The block then adds the tile into the cube once, with plain loads
//      and stores (the cube holds #6's levels already; nothing else writes
//      the tile during the launch).
// No K^3 window: the lanes evaluate the voxels of the chords, so the pairs
// evaluated are those inside the supports up to the chords' ends; what is
// lost is the last step's idle lanes of each (entry, patch), ~11 % of the
// lane steps at the cube cell's supports of 7-15.4 voxels, where a thread a
// column walking its own chord lost ~55 % (a warp runs as long as its
// longest chord). While a profiler runs the wrapper passes two counters,
// the lane steps of the walks and the voxels added (walk_lanes,
// walk_pairs); the kernel adds to them once a block.

#include "deposit_common.cuh"

namespace {

constexpr int kT = 16;                // output tile side (voxels), every axis
constexpr int kThreads = kT * kT;     // 8 warps a block
constexpr int kStage = kThreads;      // list entries staged at once
constexpr int kMaxFields3 = 4;
constexpr float kSlack = 0.01f;       // voxels a chord is widened by
constexpr int kPatchX = 8, kPatchY = 4;  // a warp's columns: x = l % 8, y = l / 8
constexpr int kPad = 5;               // floats a plane of the sums is padded by
constexpr int kSeveral = -0x7fffffff - 1;  // an image shift: more than one image may meet the tile
constexpr unsigned kFull = 0xffffffffu;

// The cube and the kernel constants shared by every block.
struct Cube {
  int nx, ny, nz;             // the cube (voxels)
  int ntx, nty;               // tiles a row, tile rows a plane
  int per_x, per_y, per_z;    // minimum image per axis
  float offset;               // voxel sample offset (0.5: centres)
  float psx, psy, psz;        // voxel edges (world units)
  float norm3d, lim, lim2;    // 3D kernel normalisation, support (q), squared
};

// The periodic image of an offset d (voxels) on an axis of period L, as
// the dense pass takes it.
__device__ __forceinline__ float min_image(float d, float L, float inv_L) {
  return d - L * rintf(d * inv_L);
}

// sqrt from the hardware reciprocal square root (a few ulp: the weights
// keep ~1e-7 of their value), as kernel #6 takes it. The approximation
// flushes subnormal inputs: below FLT_MIN the root is taken as 0, where
// every kernel shape already reads its value at 0 in f32.
__device__ __forceinline__ float fast_sqrt(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return x >= 1.17549435e-38f ? x * r : 0.0f;
}

// Floats a tile plane of the F fields' sums takes: [plane][field][column],
// warp w's lane l at column 32 w + l, a plane kPad floats apart from the
// next (a column's planes then fall 5 banks apart).
__host__ __device__ constexpr int plane_floats(int n_fields) { return n_fields * kThreads + kPad; }

// The chord [k_lo, k_hi] (plane indices, cut to the tile's nzt planes from
// z0) of the image centred at sample index c, half length half.
__device__ __forceinline__ void chord(float c, float half, int z0, int nzt, int* k_lo, int* k_hi) {
  // clamped in float first: a far-off centre must not overflow the int
  *k_lo = __float2int_ru(fminf(fmaxf(c - half, (float)z0), (float)(z0 + kT)));
  *k_hi = __float2int_rd(fmaxf(fminf(c + half, (float)(z0 + nzt - 1)), (float)(z0 - 1)));
}

// Add the particle's terms at *cell (field 0; the others kThreads apart)
// if q2 is inside the support; 1 if it was.
template <int KID, int F>
__device__ __forceinline__ int add_voxel(float* cell, float q2, float lim2, const float* ve) {
  if (!(q2 < lim2)) return 0;
  const float wgt = ast::shape_q<KID>(fast_sqrt(q2));
#pragma unroll
  for (int f = 0; f < F; ++f) cell[f * kThreads] = fmaf(wgt, ve[f], cell[f * kThreads]);
  return 1;
}

// Steps s..s+U-1 of a warp's flattened walk (see the file's head): each
// lane's voxel of each step found in the walking columns' table, weighed
// and added, the U steps' loads before their stores (their voxels are
// distinct). before: the columns whose chords start before step s;
// returns those before step s + U.
template <int KID, int F, int U>
__device__ __forceinline__ int walk_steps(int s, int before, int total, int head_step, unsigned head_bit,
                                          unsigned le_mask, const int4* walk, float sz, float lim2,
                                          const float* ve, float* s_acc, int plane, unsigned* pairs) {
  const int lane = threadIdx.x & 31;
  unsigned heads[U];
  // the chords starting in a step's indices: lane l's column is the last
  // of those starting at or before its index
#pragma unroll
  for (int q = 0; q < U; ++q) heads[q] = __reduce_or_sync(kFull, head_step == s + q ? head_bit : 0u);
  bool in[U];
  float wgt[U], old[U][F];
  float* cell[U];
#pragma unroll
  for (int q = 0; q < U; ++q) {
    const int idx = 32 * (s + q) + lane;
    const int4 e = walk[before + __popc(heads[q] & le_mask) - 1];
    before += __popc(heads[q]);
    const int j = idx - e.x;  // the voxel's place in its column's chord
    const float dz = fmaf((float)j, sz, __int_as_float(e.z));
    const float q2 = fmaf(dz, dz, __int_as_float(e.w));
    in[q] = idx < total && q2 < lim2;
    wgt[q] = ast::shape_q<KID>(fast_sqrt(q2));
    cell[q] = s_acc + j * plane + e.y;
#pragma unroll
    for (int f = 0; f < F; ++f) old[q][f] = in[q] ? cell[q][f * kThreads] : 0.0f;
  }
#pragma unroll
  for (int q = 0; q < U; ++q) {
#pragma unroll
    for (int f = 0; f < F; ++f)
      if (in[q]) cell[q][f * kThreads] = fmaf(wgt[q], ve[f], old[q][f]);
    *pairs += in[q];
  }
  return before;
}

// The deposit of each tile's list into out (F fields of nz x ny x nx,
// cube floats apart): block b takes tile order[b] (see the file's head).
// stats, where not null, takes the walks' lane steps and voxels added.
template <int KID, int F>
__global__ void __launch_bounds__(kThreads)
wide3d_deposit_kernel(const float* __restrict__ u, const float* __restrict__ v,
                      const float* __restrict__ w, const float* __restrict__ h,
                      const float* __restrict__ vals, long long ld_vals,
                      const long long* __restrict__ starts, const int* __restrict__ lists,
                      const int* __restrict__ order, Cube g, float* __restrict__ out,
                      unsigned long long* __restrict__ stats) {
  extern __shared__ float s_acc[];   // F x kT^3 sums (plane_floats)
  __shared__ float4 s_pos[kStage];   // u, v, w, sz
  __shared__ float2 s_sxy[kStage];   // sx, sy
  __shared__ float s_val[F][kStage]; // values times the kernel's normalisation
  // a warp's walking columns, in lane order: the chord's first index, the
  // sums' offset of its first voxel, dz there and dxy2 (the last two f32)
  __shared__ int4 s_walk[kThreads / 32][32];
  __shared__ unsigned long long s_stats[2];
  const int tile = order[blockIdx.x];
  const long long lo = starts[tile], hi = starts[tile + 1];
  if (lo == hi) return;
  const int tz = tile / (g.ntx * g.nty), rem = tile - tz * (g.ntx * g.nty);
  const int ty = rem / g.ntx, tx = rem - ty * g.ntx;
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const int px0 = tx * kT + (wid % (kT / kPatchX)) * kPatchX, py0 = ty * kT + (wid / (kT / kPatchX)) * kPatchY;
  const int x = px0 + lane % kPatchX, y = py0 + lane / kPatchX, z0 = tz * kT;
  const bool mine = x < g.nx && y < g.ny;
  const int nzt = min(kT, g.nz - z0);
  const float xc = (float)x + g.offset, yc = (float)y + g.offset;
  // the patch's centre and half sides, as sample coordinates, with the slack
  const float pxc = ((float)px0 + 0.5f * (kPatchX - 1)) + g.offset;
  const float pyc = ((float)py0 + 0.5f * (kPatchY - 1)) + g.offset;
  const float phx = 0.5f * (kPatchX - 1) + kSlack, phy = 0.5f * (kPatchY - 1) + kSlack;
  const float zmid = (float)z0 + 0.5f * (float)(nzt - 1);
  const float Lx = (float)g.nx, Ly = (float)g.ny, Lz = (float)g.nz;
  const float inv_Lx = 1.0f / Lx, inv_Ly = 1.0f / Ly, inv_Lz = 1.0f / Lz;
  const unsigned lt_mask = (1u << lane) - 1u, le_mask = (2u << lane) - 1u;
  constexpr int kPlane = plane_floats(F);
  float* col = s_acc + t;  // this lane's column, at tile plane 0
  int4* walk = s_walk[wid];
  unsigned pairs = 0;       // this lane's voxels added
  long long walked = 0;     // this warp's lane steps / 32
  for (int k = t; k < kT * kPlane; k += kThreads) s_acc[k] = 0.0f;
  if (t < 2) s_stats[t] = 0;

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
    for (int j0 = 0; j0 < m; j0 += 32) {
      // a. the staged entries j0..j0+31 whose disks meet the patch, and
      // the shift of the one image of each that can meet the tile: the
      // nearest to its middle, where 2 half + 16 < nz on a periodic axis
      bool meets = false;
      int img = 0;
      if (j0 + lane < m) {
        const float4 a = s_pos[j0 + lane];
        const float2 sxy = s_sxy[j0 + lane];
        float dx = pxc - a.x;
        if (g.per_x) dx = min_image(dx, Lx, inv_Lx);
        float dy = pyc - a.y;
        if (g.per_y) dy = min_image(dy, Ly, inv_Ly);
        const float ex = fmaxf(fabsf(dx) - phx, 0.0f) * sxy.x, ey = fmaxf(fabsf(dy) - phy, 0.0f) * sxy.y;
        meets = ex * ex + ey * ey < g.lim2;
        if (g.per_z)
          img = 2.0f * (__fdividef(g.lim, a.w) + kSlack) + (float)kT >= Lz
                    ? kSeveral
                    : g.nz * (int)rintf((zmid - (a.z - g.offset)) * inv_Lz);
      }
      for (unsigned hits = __ballot_sync(kFull, meets); hits; hits &= hits - 1) {
        const int j = j0 + __ffs(hits) - 1;
        const float4 a = s_pos[j];
        const float2 sxy = s_sxy[j];
        float ve[F];
#pragma unroll
        for (int f = 0; f < F; ++f) ve[f] = s_val[f][j];
        float dx = xc - a.x;
        if (g.per_x) dx = min_image(dx, Lx, inv_Lx);
        float dy = yc - a.y;
        if (g.per_y) dy = min_image(dy, Ly, inv_Ly);
        const float dxn = dx * sxy.x, dyn = dy * sxy.y;
        const float dxy2 = dxn * dxn + dyn * dyn;
        const bool in = mine && dxy2 < g.lim2;
        // b. the column's chord's half length (voxels; the root's few ulp
        // lie far inside the slack); the sample index at the centre
        const float half = in ? __fdividef(fast_sqrt(g.lim2 - dxy2), a.w) + kSlack : 0.0f;
        const float zc = a.z - g.offset;
        const int shift = __shfl_sync(kFull, img, j - j0);
        if (shift == kSeveral) {
          // another image may meet the tile too: each lane walks its column
          int steps = 0;
          if (in && 2.0f * half >= Lz) {
            // the chord covers the axis: every voxel takes the nearest image
            for (int k = 0; k < nzt; ++k) {
              const float dz = min_image((float)(z0 + k) - zc, Lz, inv_Lz) * a.w;
              pairs += add_voxel<KID, F>(col + k * kPlane, dxy2 + dz * dz, g.lim2, ve);
            }
            steps = nzt;
          } else if (in) {
            // the images at w - nz, w, w + nz: their chords are disjoint, as 2 half < nz
            for (int im = -1; im <= 1; ++im) {
              int k_lo, k_hi;
              chord(zc + (float)(im * g.nz), half, z0, nzt, &k_lo, &k_hi);
              for (int k = k_lo; k <= k_hi; ++k) {
                const float dz = ((float)(k - im * g.nz) - zc) * a.w;  // the offset from the image
                pairs += add_voxel<KID, F>(col + (k - z0) * kPlane, dxy2 + dz * dz, g.lim2, ve);
              }
              steps += max(0, k_hi - k_lo + 1);
            }
          }
          walked += __reduce_max_sync(kFull, (unsigned)steps);
          continue;
        }
        int k_lo = 0, len = 0;
        if (in) {
          int k_hi;
          chord(zc + (float)shift, half, z0, nzt, &k_lo, &k_hi);
          len = max(0, k_hi - k_lo + 1);
        }
        // c. the flattened walk: the columns' chords numbered in lane order
        int incl = len;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int o = __shfl_up_sync(kFull, incl, d);
          if (lane >= d) incl += o;
        }
        const int total = __shfl_sync(kFull, incl, 31);
        if (total == 0) continue;
        const int first = incl - len;  // this column's first index
        const unsigned walking = __ballot_sync(kFull, len > 0);
        if (len > 0)
          walk[__popc(walking & lt_mask)] =
              make_int4(first, t + (k_lo - z0) * kPlane, __float_as_int(((float)(k_lo - shift) - zc) * a.w),
                        __float_as_int(dxy2));
        const int head_step = len > 0 ? first >> 5 : -1;
        const unsigned head_bit = 1u << (first & 31);
        const int n_steps = (total + 31) >> 5;
        __syncwarp();
        // two steps at a time, for their loads' latency
        int s = 0, before = 0;
        for (; s + 2 <= n_steps; s += 2)
          before = walk_steps<KID, F, 2>(s, before, total, head_step, head_bit, le_mask, walk, a.w, g.lim2, ve,
                                         s_acc, kPlane, &pairs);
        if (s < n_steps)
          walk_steps<KID, F, 1>(s, before, total, head_step, head_bit, le_mask, walk, a.w, g.lim2, ve, s_acc, kPlane,
                                &pairs);
        walked += n_steps;
        __syncwarp();  // the table is read before the next entry writes it
      }
    }
  }
  if (stats != nullptr) {
    unsigned long long p = pairs;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) p += __shfl_down_sync(kFull, p, d);
    if (lane == 0) {
      atomicAdd(&s_stats[0], 32ull * (unsigned long long)walked);
      atomicAdd(&s_stats[1], p);
    }
  }
  __syncthreads();  // every column is summed
  if (stats != nullptr && t == 0) {
    atomicAdd(&stats[0], s_stats[0]);
    atomicAdd(&stats[1], s_stats[1]);
  }
  // the write-back: thread t a column (t % 16, t / 16), a row of the cube a half warp
  const int xl = t % kT, yl = t / kT;
  const int gx = tx * kT + xl, gy = ty * kT + yl;
  if (gx >= g.nx || gy >= g.ny) return;
  const float* sums = s_acc + ((yl / kPatchY) * (kT / kPatchX) + xl / kPatchX) * 32 +
                      (yl % kPatchY) * kPatchX + xl % kPatchX;
  const long long cube = (long long)g.nz * g.ny * g.nx;
  for (int k = 0; k < nzt; ++k) {
    const long long at = ((long long)(z0 + k) * g.ny + gy) * g.nx + gx;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float s = sums[k * kPlane + f * kThreads];
      if (s != 0.0f) out[f * cube + at] += s;
    }
  }
}

// Apply launch(kernel) to the instantiation for kernel_id and n_fields.
template <class Launch>
cudaError_t dispatch(int kernel_id, int n_fields, Launch&& launch) {
  return ast::dispatch_footprint(kernel_id, 0, [&](auto kid, auto) {
    constexpr int KID = decltype(kid)::value;
    switch (n_fields) {
      case 1: return launch(wide3d_deposit_kernel<KID, 1>);
      case 2: return launch(wide3d_deposit_kernel<KID, 2>);
      case 3: return launch(wide3d_deposit_kernel<KID, 3>);
      default: return launch(wide3d_deposit_kernel<KID, 4>);
    }
  });
}

}  // namespace

extern "C" {

// The deposit of the tile lists (starts: n_tiles + 1 int64, lists: int32
// particle indices, order: the n_tiles tiles, longest list first) into out
// ((n_fields, nz, ny, nx) f32, added into). u, v, w, h are the segment's
// (n,) f32 global voxel coordinates and smoothing lengths, vals (n_fields,
// n) with row stride ld_vals. stats: null, or 2 uint64 on the device that
// take the walks' lane steps and voxels added. Returns the launch's
// cudaError_t; it is asynchronous on `stream`.
int wide3d_deposit_launch(const float* u, const float* v, const float* w, const float* h,
                          const float* vals, long long ld_vals, int n_fields,
                          const long long* starts, const int* lists, const int* order,
                          int nx, int ny, int nz, int per_x, int per_y, int per_z,
                          float offset, float psx, float psy, float psz, int kernel_id,
                          float norm3d, float support_factor, float* out, unsigned long long* stats,
                          void* stream) {
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
  g.lim = support_factor;
  g.lim2 = support_factor * support_factor;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t acc_bytes = (size_t)kT * plane_floats(n_fields) * sizeof(float);
  return dispatch(kernel_id, n_fields, [&](auto kern) {
    cudaError_t e = ast::allow_smem(kern, acc_bytes);
    if (e != cudaSuccess) return e;
    kern<<<(unsigned)n_tiles, kThreads, acc_bytes, s>>>(u, v, w, h, vals, ld_vals, starts, lists, order, g, out,
                                                       stats);
    return cudaGetLastError();
  });
}

// The deposit kernel's registers a thread, local (spill) bytes a thread and
// shared bytes a block (static and the n_fields sums) for kernel_id and
// n_fields, into attrs[0..2].
int wide3d_deposit_attributes(int kernel_id, int n_fields, int* attrs) {
  if (n_fields < 1 || n_fields > kMaxFields3) return cudaErrorInvalidValue;
  return dispatch(kernel_id, n_fields, [&](auto kern) {
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, kern);
    if (e != cudaSuccess) return e;
    attrs[0] = fa.numRegs;
    attrs[1] = (int)fa.localSizeBytes;
    attrs[2] = (int)(fa.sharedSizeBytes + (size_t)kT * plane_floats(n_fields) * sizeof(float));
    return cudaSuccess;
  });
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
