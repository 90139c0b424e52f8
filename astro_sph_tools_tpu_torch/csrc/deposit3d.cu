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
// Design: owner computes. The TPU kernel wrote a halo'd (TZ+K, TY+K, 128)
// stack per tile that XLA then overlap-added. The first port of it pushed
// each tile's (T+K)^3 box, accumulated in shared memory, into the cube
// through global atomics; at K = 16 that box held one block per SM, and
// its column gather, not the flush, took 90 % of the time (PERF.md). Here
// every block, one warp, owns one output region, a layout tile's T voxels
// per axis, and pulls into it:
//   * its candidates are the particles of every (source tile, image) pair
//     whose box meets the region. The wrapper builds those pairs per axis
//     from the geometry (source tile, and the integer shift d that maps the
//     tile's box-local index j to the region-local index j + d), so a grid
//     that the tiles do not divide, or a box that folds over a small
//     periodic grid, needs nothing special here;
//   * the warp stages kStage candidates at a time in shared memory, each
//     clipped once per axis to the voxels it can reach inside the region
//     (its K window, its box and its support, shifted by d); those that
//     reach the region are kept in candidate order (a ballot);
//   * the region's F x T^3 sums live in shared memory. For one staged
//     candidate at a time the lanes take the voxels of its clipped box, so
//     no two lanes add to one voxel and no atomics are needed; voxel offsets
//     are computed from the box-local index (region index minus d), so each
//     weight is the plain version's arithmetic;
//   * the warp adds its sums into the cube once, with plain loads and stores
//     (the cube may hold earlier levels): no halo box, no atomic flush, and
//     the same bits on every run. A region whose candidates outnumber the
//     wrapper's split is shared by several blocks, each over a slice of the
//     candidates, and only those blocks add with atomics;
//   * blocks run the regions heaviest first (the wrapper's order), so the
//     densest regions start early instead of trailing the launch.
//
// Bound on the card. The arithmetic is small (about 12 + 2F FP32 operations
// per voxel inside a support) and the bytes are the particles and the cube.
// Left over above both: every candidate is staged by each of the ~27
// regions around its tile; the clipped boxes hold about twice the voxels of
// the supports; and each voxel evaluation is a chain of dependent steps
// (index, offsets, sqrt, kernel polynomial, shared-memory add) that about
// 16 resident warps per SM do not hide.

#include "deposit_common.cuh"

namespace {

constexpr int kStage = 64;         // candidates staged in shared memory at once
constexpr float kRound = 12582912.0f;  // 1.5 * 2^23: x + kRound - kRound = round(x)
constexpr int kMaxCombos = 512;    // (z, y, x) candidate pairs of one region
constexpr int kMaxFields3 = 4;

struct Pull3 {
  int K, TZ, TY, TX;  // level window; region (tile) voxels per axis
  int BZ, BY, BX;     // box = tile + K per axis
  int ntx, nty;       // tiles per x row, per y column
  int nz, ny, nx;     // the cube
  int wz, wy, wx;     // candidate pairs per region, table width per axis
  float offset;          // voxel sample offset (0.5: centres)
  float psx, psy, psz;   // voxel edges (world units)
  float norm3d;          // 3D kernel normalisation
  float lim, lim2;       // support_factor and its square
};

// Float voxel bound -> int, clamped to [lo, hi] before the conversion so far
// off-extent particles cannot overflow it.
__device__ __forceinline__ int clamp_to_int(float x, int lo, int hi) {
  return (int)fminf(fmaxf(x, (float)lo), (float)hi);
}

// Box-local index range of one axis that can hold support voxels: the
// K-window [j0, j0 + K) around the nearest sample, the box [0, B), and the
// support [c - offset - r, c - offset + r] rounded outwards. The exact test
// q^2 < lim^2 decides inside it; a voxel it could miss through rounding
// sits on the support's edge, where every kernel shape is 0.
__device__ __forceinline__ void axis_range(float c, float r, int K, int B,
                                           float offset, int* lo, int* hi) {
  const int j0 = clamp_to_int(floorf(c - offset + 0.5f), -2 * K - 4, B + 2 * K + 4) - K / 2;
  *lo = max(max(j0, 0), clamp_to_int(floorf(c - offset - r), -1, B));
  *hi = min(min(j0 + K - 1, B - 1), clamp_to_int(ceilf(c - offset + r), -1, B));
}

// The box-local range [lo, hi] shifted by d into the region [0, R), packed
// as lo | hi << 8 | d << 16 (an empty range has lo = 255 > hi).
__device__ __forceinline__ int pack_range(int lo, int hi, int d, int R) {
  lo = max(lo + d, 0);
  hi = min(hi + d, R - 1);
  if (lo > hi) { lo = 255; hi = 0; }
  return lo | (hi << 8) | (int)((unsigned)d << 16);
}

__device__ __forceinline__ int range_lo(int p) { return p & 0xff; }
__device__ __forceinline__ int range_hi(int p) { return (p >> 8) & 0xff; }
__device__ __forceinline__ int range_d(int p) { return p >> 16; }  // arithmetic shift

// sqrt from the hardware reciprocal square root (a few ulp: the weights
// keep ~1e-7 of their value)
__device__ __forceinline__ float fast_sqrt(float x) { return x > 0.0f ? x * rsqrtf(x) : 0.0f; }

// Candidate pair c of an axis table row: source tile index and shift.
__device__ __forceinline__ void pair_of(const int* row, int c, int* t, int* d) {
  *t = row[1 + 2 * c];
  *d = row[2 + 2 * c];
}

template <int KID, int F>
__global__ void __launch_bounds__(32)
deposit3d_pull_kernel(const float* __restrict__ u, const float* __restrict__ v,
                      const float* __restrict__ w, const float* __restrict__ h,
                      const float* __restrict__ vals, long long ld_vals,
                      const int* __restrict__ pstart, const int* __restrict__ pcount,
                      const int* __restrict__ tabz, const int* __restrict__ taby,
                      const int* __restrict__ tabx, const int* __restrict__ items,
                      float* __restrict__ out, Pull3 p) {
  // dynamic: the region's F x TZ x TY x TX sums, then the candidate
  // pairs' running particle counts (wz * wy * wx + 1)
  extern __shared__ float s_acc[];
  __shared__ int4 s_rng[kStage];      // packed x, y, z ranges, region-local
  __shared__ float4 s_pos[kStage];    // u, v, sx, sy
  __shared__ float2 s_zw[kStage];     // w, sz
  __shared__ float s_val[kStage][F];  // weighted values
  const int n_vox = p.TZ * p.TY * p.TX;
  int* s_prefix = reinterpret_cast<int*>(s_acc + F * n_vox);

  const int lane = threadIdx.x;
  const int* item = items + 4 * (long long)blockIdx.x;
  const int region = item[0], c_lo = item[1], c_hi = item[2], atomic = item[3];
  const int tz = region / (p.ntx * p.nty);
  const int rem = region - tz * p.ntx * p.nty;
  const int ty = rem / p.ntx;
  const int tx = rem - ty * p.ntx;
  const int rz0 = tz * p.TZ, ry0 = ty * p.TY, rx0 = tx * p.TX;
  const int RZ = min(p.TZ, p.nz - rz0), RY = min(p.TY, p.ny - ry0), RX = min(p.TX, p.nx - rx0);
  const int* rowz = tabz + tz * (1 + 2 * p.wz);
  const int* rowy = taby + ty * (1 + 2 * p.wy);
  const int* rowx = tabx + tx * (1 + 2 * p.wx);
  const int ncz = rowz[0], ncy = rowy[0], ncx = rowx[0];
  const int n_combo = ncz * ncy * ncx;  // <= kMaxCombos (checked by the launcher)

  // particles per candidate pair, then their running sum; the sums start at 0
  for (int c = lane; c < n_combo; c += 32) {
    const int cz = c / (ncy * ncx), cyx = c - cz * ncy * ncx;
    const int cy = cyx / ncx, cx = cyx - cy * ncx;
    int t_z, t_y, t_x, d;
    pair_of(rowz, cz, &t_z, &d);
    pair_of(rowy, cy, &t_y, &d);
    pair_of(rowx, cx, &t_x, &d);
    s_prefix[c + 1] = pcount[(t_z * p.nty + t_y) * p.ntx + t_x];
  }
  for (int k = lane; k < F * n_vox; k += 32) s_acc[k] = 0.0f;
  __syncwarp();
  if (lane == 0) {
    s_prefix[0] = 0;
    for (int c = 0; c < n_combo; ++c) s_prefix[c + 1] += s_prefix[c];
  }
  __syncwarp();

  for (int base = c_lo; base < c_hi;) {
    // stage: a candidate a lane, clipped to the region once; only those
    // that reach it are kept, in candidate order (ballot)
    int ns = 0;
    while (base < c_hi && ns <= kStage - 32) {
      const int idx = base + lane;
      bool keep = false;
      int4 r = make_int4(0, 0, 0, 0);
      float ul = 0.0f, vl = 0.0f, wl = 0.0f, sx = 0.0f, sy = 0.0f, sz = 0.0f, vs = 0.0f;
      int i = 0;
      if (idx < c_hi) {
        // the candidate pair holding idx: s_prefix[c] <= idx < s_prefix[c + 1]
        int lo = 0, hi = n_combo - 1;
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (s_prefix[mid] <= idx) lo = mid; else hi = mid - 1;
        }
        const int c = lo;
        const int cz = c / (ncy * ncx), cyx = c - cz * ncy * ncx;
        const int cy = cyx / ncx, cx = cyx - cy * ncx;
        int t_z, t_y, t_x, dz, dy, dx;
        pair_of(rowz, cz, &t_z, &dz);
        pair_of(rowy, cy, &t_y, &dy);
        pair_of(rowx, cx, &t_x, &dx);
        i = pstart[(t_z * p.nty + t_y) * p.ntx + t_x] + (idx - s_prefix[c]);
        const float hi_ = h[i];
        ul = u[i]; vl = v[i]; wl = w[i];
        if (hi_ > 0.0f) {  // zero-h particles contribute exactly 0
          const float inv_h = 1.0f / hi_;
          vs = (p.norm3d * inv_h) * (inv_h * inv_h);
          sx = p.psx * inv_h; sy = p.psy * inv_h; sz = p.psz * inv_h;
          int a, b;
          axis_range(ul, p.lim / sx, p.K, p.BX, p.offset, &a, &b);
          r.x = pack_range(a, b, dx, RX);
          axis_range(vl, p.lim / sy, p.K, p.BY, p.offset, &a, &b);
          r.y = pack_range(a, b, dy, RY);
          axis_range(wl, p.lim / sz, p.K, p.BZ, p.offset, &a, &b);
          r.z = pack_range(a, b, dz, RZ);
          keep = range_lo(r.x) <= range_hi(r.x) && range_lo(r.y) <= range_hi(r.y) &&
                 range_lo(r.z) <= range_hi(r.z);
        }
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      if (keep) {
        const int s = ns + __popc(ballot & ((1u << lane) - 1u));
        s_rng[s] = r;
        s_pos[s] = make_float4(ul, vl, sx, sy);
        s_zw[s] = make_float2(wl, sz);
#pragma unroll
        for (int f = 0; f < F; ++f) s_val[s][f] = vals[f * ld_vals + i] * vs;
      }
      ns += __popc(ballot);
      base += 32;
    }
    __syncwarp();
    // one staged candidate at a time: the lanes take the voxels of its
    // clipped box (x fastest), so no two lanes add to one voxel
    for (int j = 0; j < ns; ++j) {
      const int4 r = s_rng[j];
      const float4 a = s_pos[j];
      const float2 zw = s_zw[j];
      float ve[F];
#pragma unroll
      for (int f = 0; f < F; ++f) ve[f] = s_val[j][f];
      const int x0 = range_lo(r.x), y0 = range_lo(r.y), z0 = range_lo(r.z);
      const int bx = range_hi(r.x) - x0 + 1, bxy = bx * (range_hi(r.y) - y0 + 1);
      const int n_box = bxy * (range_hi(r.z) - z0 + 1);
      // the integer/float conversions of the voxel index are quarter-rate
      // on this card: the loop keeps k as a float too, splits it with
      // round-to-nearest by the 1.5 * 2^23 trick (exact for these small
      // integers: (k + 1/4) / b lies at least 1/(4b) from a half-integer),
      // and builds each box-local index as (float)(x0 - d) + xk, exactly
      const float fbx = (float)bx, fbxy = (float)bxy;
      const float inv_bx = 1.0f / fbx, inv_bxy = 1.0f / fbxy;
      const float jx0 = (float)(x0 - range_d(r.x)), jy0 = (float)(y0 - range_d(r.y)),
                  jz0 = (float)(z0 - range_d(r.z));
      const int cell0 = (z0 * p.TY + y0) * p.TX + x0;
      float kf = (float)lane;
      for (int k = lane; k < n_box; k += 32, kf += 32.0f) {
        const float tz = fmaf(kf + 0.25f, inv_bxy, -0.5f) + kRound;
        const float zk = tz - kRound;
        const float k2 = fmaf(-zk, fbxy, kf);
        const float ty_ = fmaf(k2 + 0.25f, inv_bx, -0.5f) + kRound;
        const float yk = ty_ - kRound;
        const float xk = fmaf(-yk, fbx, k2);
        // offsets from the box-local index: the plain version's arithmetic
        const float dxn = ((jx0 + xk) + p.offset - a.x) * a.z;
        const float dyn = ((jy0 + yk) + p.offset - a.y) * a.w;
        const float dzn = ((jz0 + zk) + p.offset - zw.x) * zw.y;
        const float q2 = (dxn * dxn + dyn * dyn) + dzn * dzn;
        if (q2 < p.lim2) {
          const float wgt = ast::shape_q<KID>(fast_sqrt(q2));
          const int zi = __float_as_int(tz) - __float_as_int(kRound);
          const int yi = __float_as_int(ty_) - __float_as_int(kRound);
          float* cell = s_acc + cell0 + (zi * p.TY + yi) * p.TX + (k - zi * bxy - yi * bx);
#pragma unroll
          for (int f = 0; f < F; ++f) cell[f * n_vox] = fmaf(wgt, ve[f], cell[f * n_vox]);
        }
      }
      __syncwarp();  // the next candidate's lanes may add to the same voxels
    }
  }

  // add the region's sums into the cube once: plain loads and stores (the
  // region is this block's alone) or, for a region shared by several
  // blocks, atomics
  const long long cube = (long long)p.nz * p.ny * p.nx;
  for (int k = lane; k < n_vox; k += 32) {
    const int z = k / (p.TY * p.TX), yx = k - z * p.TY * p.TX;
    const int y = yx / p.TX, x = yx - y * p.TX;
    if (z >= RZ || y >= RY || x >= RX) continue;
    const long long g = ((long long)(rz0 + z) * p.ny + (ry0 + y)) * p.nx + (rx0 + x);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float a = s_acc[f * n_vox + k];
      if (a == 0.0f) continue;
      float* cell = out + f * cube + g;
      if (atomic) atomicAdd(cell, a);
      else *cell += a;
    }
  }
}

}  // namespace

extern "C" {

// Add one level's particles into the (n_fields, nz, ny, nx) cube `out`.
// tab{z,y,x}: per region index along the axis, a row of 1 + 2 w{z,y,x} int32
// (pair count, then (source tile index, shift) pairs); items: (n_items, 4)
// int32 (region, first and end candidate, atomic flag). Returns the
// cudaError_t of the launch (cudaSuccess = 0); it is asynchronous on
// `stream`.
int deposit3d_launch(const float* u, const float* v, const float* w,
                     const float* h, const float* vals, long long ld_vals,
                     int n_fields, const int* pstart, const int* pcount,
                     const int* tabz, const int* taby, const int* tabx, int wz,
                     int wy, int wx, const int* items, int n_items, float* out,
                     int K, int TZ, int TY, int TX, int ntx, int nty, int nz,
                     int ny, int nx, float offset, float psx, float psy,
                     float psz, int kernel_id, float norm3d,
                     float support_factor, void* stream) {
  if (n_items <= 0) return cudaSuccess;
  if (n_fields < 1 || n_fields > kMaxFields3 || K <= 0 || TZ <= 0 || TZ > 255 ||
      TY <= 0 || TX <= 0 || TY > 255 || TX > 255 ||
      ntx <= 0 || nty <= 0 || nz <= 0 || ny <= 0 || nx <= 0 || wz <= 0 ||
      wy <= 0 || wx <= 0 || wz * wy * wx > kMaxCombos)
    return cudaErrorInvalidValue;
  Pull3 p;
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
  p.wz = wz;
  p.wy = wy;
  p.wx = wx;
  p.offset = offset;
  p.psx = psx;
  p.psy = psy;
  p.psz = psz;
  p.norm3d = norm3d;
  p.lim = support_factor;
  p.lim2 = support_factor * support_factor;
  cudaStream_t s = (cudaStream_t)stream;
  int smem_optin = 0;
  cudaError_t err = ast::smem_optin(&smem_optin);
  if (err != cudaSuccess) return err;
  // the region's sums and the candidate pairs' running counts; the stage is
  // static
  const size_t acc_bytes = (size_t)n_fields * TZ * TY * TX * sizeof(float) +
                           (size_t)(wz * wy * wx + 1) * sizeof(int);
  return ast::dispatch_footprint(kernel_id, 0, [&](auto kid, auto) {
    constexpr int KID = decltype(kid)::value;
    auto go = [&](auto f) {
      auto kern = deposit3d_pull_kernel<KID, decltype(f)::value>;
      cudaFuncAttributes attr;
      cudaError_t e = cudaFuncGetAttributes(&attr, kern);
      if (e != cudaSuccess) return e;
      if (acc_bytes + attr.sharedSizeBytes > (size_t)smem_optin) return cudaErrorInvalidConfiguration;
      e = ast::allow_smem(kern, acc_bytes);
      if (e != cudaSuccess) return e;
      kern<<<n_items, 32, acc_bytes, s>>>(u, v, w, h, vals, ld_vals, pstart, pcount, tabz, taby,
                                          tabx, items, out, p);
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
