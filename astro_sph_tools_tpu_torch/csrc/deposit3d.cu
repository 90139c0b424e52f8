// Adaptive-h 3D SPH voxel deposit, for Hopper.
//
// Replaces the TPU kernel astro_sph_tools_tpu/ops/grid3d_pallas.py:129
// (_deposit3d_kernel) together with the 27-band overlap-add that followed it
// (_overlap_add_3d). Contract, for one footprint level K:
//     grid[f, z, y, x] += sum_i val_f(i) * norm_3d / h_i^3 * shape_q(|r_i| / h_i)
// over the voxel centres inside particle i's support (and inside its K^3
// window, col0 = floor(u - offset + 0.5) - K/2 per axis, and its tile's box).
// Particles are the level's tile-sorted particles in TILE-LOCAL voxel
// coordinates (u, v, w) relative to the box origin tile * T - K/2. Periodic
// axes wrap; open axes drop off-grid voxels (never clip them). h <= 0
// contributes nothing. Every precision string of the TPU engine (f32, bf16,
// bf16x2) becomes f32 FMA arithmetic here.
//
// Design. The TPU kernel walked a sequential work list, placed columns with
// one-hot MXU products and lane rolls into a 128-lane accumulator, and wrote
// a halo'd (TZ+K, TY+K, 128) stack per tile that XLA then overlap-added. At
// 512^3 that stack is tens of GiB. Here:
//   * one thread block per work item: a tile and a run of at most 256 of its
//     particles (built with torch from the per-tile counts), so a dense tile
//     is spread over several blocks;
//   * the block accumulates the tile's box, (TZ+K)(TY+K)(TX+K) voxels per
//     field, in shared memory (K = 16, 8^3 tiles: 24^3 * 4 B = 54 KiB a
//     field; fields run in passes when they do not fit);
//   * the item's particles are staged in shared memory, 128 at a time, with
//     their per-particle factors (1/h scales, weighted values, index ranges)
//     computed once;
//   * each thread owns whole (y, x) columns of the box (one thread per
//     column, up to 1024) and gathers: for every staged particle whose disc
//     covers its column, it walks the support's chord along z. No two
//     threads add to one voxel, so the adds are plain loads and stores, and
//     neighbouring threads hit neighbouring banks;
//   * the block then flushes its box into the cube with device atomics,
//     wrapping or dropping each voxel and skipping exact zeros, four x
//     voxels per vector atomic where the geometry keeps them aligned. The
//     flush takes the place of the overlap-add: peak memory stays near the
//     cube.
//
// Bound on the card. The arithmetic is small (about 12 + 2F FP32 operations
// per voxel inside a support) and the bytes are the particles and the cube,
// so both bounds are far below what this design reaches. A first version
// gave each warp a particle and added with shared-memory float atomics,
// which compile to compare-and-swap loops (ATOMS.CAST.SPIN in the SASS); at
// four fields those loops set its time. The gather has no such loops; what
// limits it is divergence (the lanes of a warp cover 32 neighbouring columns,
// of which a support's disc covers some, each for its own chord length) and,
// at four fields, one block per SM. The flush issues about (halo ratio) x F
// x voxels atomics, where the halo ratio of a K = 16 box over its 8^3 tile
// is (24/8)^3 = 27 at most and (8 + 2s)^3 / 8^3 for supports of radius s
// once zeros are skipped.

#include "deposit_common.cuh"

namespace {

using ast::kMaxFields;

constexpr int kThreads = 1024;  // the most threads a block may have
constexpr int kWarp = 32;
constexpr int kStage = 128;  // particles staged in shared memory at once
// words staged per particle besides its values: u v w sx sy sz, and its
// x, y, z index ranges packed as lo | hi << 16
constexpr int kStageWords = 9;

struct Box3 {
  int K, TZ, TY, TX;  // level window; tile output voxels per axis
  int BZ, BY, BX;     // box = tile + K per axis
  int ntx, nty;       // tiles per x row, per y column
  int nz, ny, nx;     // the cube
  int per_x, per_y, per_z;
  float offset;          // voxel sample offset (0.5: centres)
  float psx, psy, psz;   // voxel edges (world units)
  float norm3d;          // 3D kernel normalisation
  float lim, lim2;       // support_factor and its square
  int vec4;              // flush four x voxels per atomic (aligned groups)
};

// Float voxel bound -> int, clamped to [lo, hi] before the conversion so far
// off-extent particles cannot overflow it.
__device__ __forceinline__ int clamp_to_int(float x, int lo, int hi) {
  return (int)fminf(fmaxf(x, (float)lo), (float)hi);
}

// Index range of one axis that can hold support voxels: the K-window
// [j0, j0 + K) around the nearest sample, the box [0, B), and the support
// [c - offset - r, c - offset + r] widened by a voxel on each side.
__device__ __forceinline__ void axis_range(float c, float r, int K, int B,
                                           float offset, int* lo, int* hi) {
  const int j0 = clamp_to_int(floorf(c - offset + 0.5f), -2 * K - 4, B + 2 * K + 4) - K / 2;
  *lo = max(max(j0, 0), clamp_to_int(floorf(c - offset - r) - 1.0f, -1, B));
  *hi = min(min(j0 + K - 1, B - 1), clamp_to_int(ceilf(c - offset + r) + 1.0f, -1, B));
}

// Global index of box voxel j along an axis whose box starts at `origin`:
// wrapped on a periodic axis, -1 (dropped) off an open one.
__device__ __forceinline__ int to_grid(int origin, int j, int n, int per) {
  int g = origin + j;
  if (per) {
    g %= n;
    return g < 0 ? g + n : g;
  }
  return (g >= 0 && g < n) ? g : -1;
}

// out[0..3] += a, one vector atomic (sm_90); out is 16-byte aligned.
__device__ __forceinline__ void red_add_v4(float* out, float4 a) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "l"(out), "f"(a.x), "f"(a.y), "f"(a.z), "f"(a.w) : "memory");
}

template <int KID>
__global__ void __launch_bounds__(kThreads)
deposit3d_kernel(const float* __restrict__ u, const float* __restrict__ v,
                 const float* __restrict__ w, const float* __restrict__ h,
                 const float* __restrict__ vals, long long ld_vals, int f_lo,
                 int f_n, const int* __restrict__ item_tile,
                 const int* __restrict__ item_start,
                 const int* __restrict__ item_count, float* __restrict__ out,
                 Box3 p) {
  // f_n * BZ * BY * BX box floats, then the staged particles
  extern __shared__ float4 box4[];
  float* box = reinterpret_cast<float*>(box4);
  const int nplane = p.BY * p.BX;
  const int nbox = p.BZ * nplane;
  const int n_acc = f_n * nbox;
  float* s_f = box + n_acc;  // (kStage, 6 + f_n): u v w sx sy sz, weighted values
  int* s_r = reinterpret_cast<int*>(s_f + kStage * (6 + f_n));  // (kStage, 3)
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) box[i] = 0.0f;

  const int item = blockIdx.x;
  const int p0 = item_start[item];
  const int p1 = p0 + item_count[item];
  const float* val0 = vals + (long long)f_lo * ld_vals;
  for (int c0 = p0; c0 < p1; c0 += kStage) {
    const int nc = min(kStage, p1 - c0);
    __syncthreads();  // the box is zeroed / the previous chunk is consumed
    for (int j = threadIdx.x; j < nc; j += blockDim.x) {
      const int i = c0 + j;
      const float hi = h[i];
      const float ul = u[i], vl = v[i], wl = w[i];
      int xr = 0x0000ffff, yr = 0x0000ffff, zr = 0x0000ffff;  // lo > hi: empty
      float sx = 0.0f, sy = 0.0f, sz = 0.0f, vs = 0.0f;
      if (hi > 0.0f) {  // zero-h particles contribute exactly 0
        const float inv_h = 1.0f / hi;
        vs = (p.norm3d * inv_h) * (inv_h * inv_h);
        sx = p.psx * inv_h; sy = p.psy * inv_h; sz = p.psz * inv_h;
        int lo, hi_;
        axis_range(ul, p.lim / sx, p.K, p.BX, p.offset, &lo, &hi_);
        xr = (lo & 0xffff) | (hi_ << 16);
        axis_range(vl, p.lim / sy, p.K, p.BY, p.offset, &lo, &hi_);
        yr = (lo & 0xffff) | (hi_ << 16);
        axis_range(wl, p.lim / sz, p.K, p.BZ, p.offset, &lo, &hi_);
        zr = (lo & 0xffff) | (hi_ << 16);
      }
      float* row = s_f + j * (6 + f_n);
      row[0] = ul; row[1] = vl; row[2] = wl; row[3] = sx; row[4] = sy; row[5] = sz;
      for (int f = 0; f < f_n; ++f) row[6 + f] = val0[f * ld_vals + i] * vs;
      s_r[3 * j] = xr; s_r[3 * j + 1] = yr; s_r[3 * j + 2] = zr;
    }
    __syncthreads();
    // each thread owns whole (y, x) columns of the box: no two threads add
    // to one voxel, so the adds are plain loads and stores
    for (int c = threadIdx.x; c < nplane; c += blockDim.x) {
      const int y = c / p.BX, x = c - y * p.BX;
      for (int j = 0; j < nc; ++j) {
        const int xr = s_r[3 * j], yr = s_r[3 * j + 1];
        if (x < (xr & 0xffff) || x > (xr >> 16) || y < (yr & 0xffff) || y > (yr >> 16)) continue;
        const float* row = s_f + j * (6 + f_n);
        const float dxn = ((float)x + p.offset - row[0]) * row[3];
        const float dyn = ((float)y + p.offset - row[1]) * row[4];
        const float rho2 = dxn * dxn + dyn * dyn;
        if (rho2 >= p.lim2) continue;
        const int zr = s_r[3 * j + 2];
        const float wl = row[2], sz = row[5];
        float ve[kMaxFields];
#pragma unroll
        for (int f = 0; f < kMaxFields; ++f) ve[f] = f < f_n ? row[6 + f] : 0.0f;
        // the chord of the support through this column, widened by a voxel
        const float half = sqrtf(p.lim2 - rho2) / sz;
        const int z_lo = max(zr & 0xffff, clamp_to_int(floorf(wl - p.offset - half) - 1.0f, -1, p.BZ));
        const int z_hi = min(zr >> 16, clamp_to_int(ceilf(wl - p.offset + half) + 1.0f, -1, p.BZ));
        float* col = box + c;
        for (int z = z_lo; z <= z_hi; ++z) {
          const float dzn = ((float)z + p.offset - wl) * sz;
          const float q2 = rho2 + dzn * dzn;
          if (q2 >= p.lim2) continue;
          const float wgt = ast::shape_q<KID>(sqrtf(q2));
          float* cell = col + z * nplane;
          float a[kMaxFields];
#pragma unroll
          for (int f = 0; f < kMaxFields; ++f)
            if (f < f_n) a[f] = cell[f * nbox];
#pragma unroll
          for (int f = 0; f < kMaxFields; ++f)
            if (f < f_n) cell[f * nbox] = a[f] + wgt * ve[f];
        }
      }
    }
  }
  __syncthreads();

  // flush the box into the cube: box origin = tile * T - K/2 per axis
  const int t = item_tile[item];
  const int tz = t / (p.ntx * p.nty);
  const int rem = t - tz * p.ntx * p.nty;
  const int ty = rem / p.ntx;
  const int tx = rem - ty * p.ntx;
  const int oz = tz * p.TZ - p.K / 2, oy = ty * p.TY - p.K / 2,
            ox = tx * p.TX - p.K / 2;
  const long long cube = (long long)p.nz * p.ny * p.nx;
  float* out0 = out + (long long)f_lo * cube;
  if (p.vec4) {
    // groups of four x voxels: the box origin, the box width and nx are
    // multiples of 4, so a group never straddles the grid's edge or its wrap
    const int nxg = p.BX / 4;
    for (int i = threadIdx.x; i < p.BZ * p.BY * nxg; i += blockDim.x) {
      const int zy = i / nxg;
      const int z = zy / p.BY, y = zy - z * p.BY, x = 4 * (i - zy * nxg);
      const int gz = to_grid(oz, z, p.nz, p.per_z);
      const int gy = to_grid(oy, y, p.ny, p.per_y);
      const int gx = to_grid(ox, x, p.nx, p.per_x);
      if (gz < 0 || gy < 0 || gx < 0) continue;
      const long long g = ((long long)gz * p.ny + gy) * p.nx + gx;
      for (int f = 0; f < f_n; ++f) {
        const float4 a = box4[(f * nbox + zy * p.BX + x) / 4];
        if (a.x != 0.0f || a.y != 0.0f || a.z != 0.0f || a.w != 0.0f)
          red_add_v4(out0 + f * cube + g, a);
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < nbox; i += blockDim.x) {
    const int z = i / (p.BY * p.BX);
    const int r = i - z * p.BY * p.BX;
    const int y = r / p.BX;
    const int x = r - y * p.BX;
    const int gz = to_grid(oz, z, p.nz, p.per_z);
    const int gy = to_grid(oy, y, p.ny, p.per_y);
    const int gx = to_grid(ox, x, p.nx, p.per_x);
    if (gz < 0 || gy < 0 || gx < 0) continue;
    const long long g = ((long long)gz * p.ny + gy) * p.nx + gx;
    for (int f = 0; f < f_n; ++f) {
      const float a = box[f * nbox + i];
      if (a != 0.0f) atomicAdd(out0 + f * cube + g, a);
    }
  }
}

}  // namespace

extern "C" {

// Add one level's particles into the (n_fields, nz, ny, nx) cube `out`.
// Returns the cudaError_t of the first failing attribute call or launch
// (cudaSuccess = 0); launches are asynchronous on `stream`.
int deposit3d_launch(const float* u, const float* v, const float* w,
                     const float* h, const float* vals, long long ld_vals,
                     int n_fields, const int* item_tile, const int* item_start,
                     const int* item_count, int n_items, float* out, int K,
                     int TZ, int TY, int TX, int ntx, int nty, int nz, int ny,
                     int nx, int per_x, int per_y, int per_z, float offset,
                     float psx, float psy, float psz, int kernel_id,
                     float norm3d, float support_factor, void* stream) {
  if (n_items <= 0) return cudaSuccess;
  if (n_fields < 1 || n_fields > kMaxFields || K <= 0 || TZ <= 0 || TY <= 0 ||
      TX <= 0 || ntx <= 0 || nty <= 0 || nz <= 0 || ny <= 0 || nx <= 0)
    return cudaErrorInvalidValue;
  int smem_optin = 0;
  cudaError_t err = ast::smem_optin(&smem_optin);
  if (err != cudaSuccess) return err;
  Box3 p;
  p.K = K;
  p.TZ = TZ;
  p.TY = TY;
  p.TX = TX;
  p.BZ = TZ + K;
  p.BY = TY + K;
  p.BX = TX + K;
  p.ntx = ntx;
  p.nty = nty;
  p.nz = nz;
  p.ny = ny;
  p.nx = nx;
  p.per_x = per_x;
  p.per_y = per_y;
  p.per_z = per_z;
  p.offset = offset;
  p.psx = psx;
  p.psy = psy;
  p.psz = psz;
  p.norm3d = norm3d;
  p.lim = support_factor;
  p.lim2 = support_factor * support_factor;
  p.vec4 = TX % 4 == 0 && (K / 2) % 4 == 0 && nx % 4 == 0 &&
           reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const size_t field_bytes = (size_t)p.BZ * p.BY * p.BX * sizeof(float);
  const size_t stage_word_bytes = (size_t)kStage * sizeof(float);
  int group = (int)(((size_t)smem_optin - stage_word_bytes * kStageWords) /
                    (field_bytes + stage_word_bytes));
  if (group < 1) return cudaErrorInvalidConfiguration;
  if (group > n_fields) group = n_fields;
  cudaStream_t s = (cudaStream_t)stream;
  // one thread per (y, x) column of the box, up to kThreads
  const int threads = min(kThreads, (p.BY * p.BX + kWarp - 1) / kWarp * kWarp);
  for (int f_lo = 0; f_lo < n_fields; f_lo += group) {
    const int f_n = n_fields - f_lo < group ? n_fields - f_lo : group;
    const size_t smem = f_n * field_bytes + stage_word_bytes * (kStageWords + f_n);
    err = ast::dispatch_footprint(kernel_id, 0, [&](auto kid, auto) {
      auto kern = deposit3d_kernel<decltype(kid)::value>;
      cudaError_t e = ast::allow_smem(kern, smem);
      if (e != cudaSuccess) return e;
      kern<<<n_items, threads, smem, s>>>(u, v, w, h, vals, ld_vals, f_lo, f_n,
                                           item_tile, item_start, item_count,
                                           out, p);
      return cudaGetLastError();
    });
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
