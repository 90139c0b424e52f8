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
// Design: owner computes, output-stationary. The TPU kernel wrote a halo'd
// (TZ+K, TY+K, 128) stack per tile that XLA then overlap-added. The first
// port of it pushed each tile's (T+K)^3 box, accumulated in shared memory,
// into the cube through global atomics; the second gave each region to
// one warp that walked every staged candidate's clipped box across its
// lanes into shared-memory sums, a __syncwarp a candidate (PERF.md). Here
// every block owns one output region, a layout tile's T voxels per axis,
// and pulls into it:
//   * its candidates are the particles of every (source tile, image) pair
//     whose box meets the region. The wrapper builds those pairs per axis
//     from the geometry (source tile, and the integer shift d that maps the
//     tile's box-local index j to the region-local index j + d), so a grid
//     that the tiles do not divide, or a box that folds over a small
//     periodic grid, needs nothing special here;
//   * all warps of the block stage the candidates together, a candidate a
//     thread, each clipped once per axis to the voxels it can reach inside
//     the region (its K window, its box and its support, shifted by d);
//     those that reach the region are kept in candidate order (a ballot a
//     warp, the warps' counts through shared memory);
//   * a block has a thread for each (x, y) column of the region (64 at the
//     layout's 8^3 tiles), and the thread's F x TZ sums live in registers
//     (tiles up to kRegZ voxels deep; a deeper tile's in the thread's own
//     shared-memory column). For each staged candidate, a thread whose
//     column meets the support (dx^2 + dy^2 < lim^2) walks only the chord
//     |z + offset - w| < sqrt(lim^2 - dx^2 - dy^2) / sz (0.01 voxel of
//     slack) inside the candidate's clipped z range; the exact test
//     q^2 < lim^2 decides each voxel. Voxel offsets are computed from the
//     box-local index (region index minus d), so each weight is the plain
//     version's arithmetic. No two threads add to one voxel: no atomics,
//     and no synchronisation but a barrier a staged batch;
//   * each thread adds its column into the cube once, with plain loads and
//     stores (the cube may hold earlier levels): no halo box, no atomic
//     flush, and each voxel's candidates summed in candidate order, so the
//     same bits on every run. A region whose candidates outnumber the
//     wrapper's split is shared by several blocks, each over a slice of the
//     candidates, and only those blocks add with atomics;
//   * blocks run the regions heaviest first (the wrapper's order), so the
//     densest regions start early instead of trailing the launch.
//
// Bound on the card. The arithmetic is small (about 12 + 2F FP32 operations
// per voxel inside a support) and the bytes are the particles and the cube.
// Left over above both (PERF.md section 6, at the cube cell's levels): every
// candidate is staged, its particle read and clipped, by each of the ~27
// regions around its tile (the wrapper counts them: deposit_3d_tiles.
// candidates), a fifth of the time; a support of 3-7 voxels meets an 8^3
// region in a corner, so the warp's column test, chord and slot tests are
// paid per (candidate, warp) for a few short chords; and the walk waits on
// its own dependent steps, so occupancy sets the pace: the same code at 48
// registers runs the F <= 2 levels about 1.2x faster than at 64-77
// (kMinBlocks).

#include "deposit_common.cuh"

namespace {

constexpr int kMaxThreads = 256;  // a thread an (x, y) column: TY * TX <= 256
// Resident blocks of kMaxThreads the compiler must leave room for: with up
// to two fields 5 (48 registers), else 4 (64 registers: F = 4's 32 sums
// spill at 48). Occupancy sets the pace (PERF.md).
template <int F>
constexpr int kMinBlocks = F <= 2 ? 5 : 4;
constexpr int kRegZ = 8;          // tiles up to this deep keep their sums in registers
constexpr float kSlack = 0.01f;   // voxels a chord is widened by
constexpr int kMaxCombos = 512;   // (z, y, x) candidate pairs of one region
constexpr int kMaxFields3 = 4;

struct Pull3 {
  int K, TZ, TY, TX;  // level window; region (tile) voxels per axis
  int BZ, BY, BX;     // box = tile + K per axis
  int ntx, nty;       // tiles per x row, per y column
  int nz, ny, nx;     // the cube
  int wz, wy, wx;     // candidate pairs per region, table width per axis
  int stage;          // candidates staged in shared memory at once
  float offset;          // voxel sample offset (0.5: centres)
  float psx, psy, psz;   // voxel edges (world units)
  float norm3d;          // 3D kernel normalisation
  float lim2;            // support_factor squared
  float rx, ry, rz;      // support_factor / voxel edge per axis
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

// Whether region-local index i lies in the packed range.
__device__ __forceinline__ bool in_range(int i, int p) {
  return (unsigned)(i - range_lo(p)) <= (unsigned)(range_hi(p) - range_lo(p));
}

// sqrt from the hardware reciprocal square root (a few ulp: the weights
// keep ~1e-7 of their value). The approximation flushes subnormal inputs,
// which rsqrtf would rescale first: below FLT_MIN the root is taken as 0,
// where every kernel shape already reads its value at 0 in f32.
__device__ __forceinline__ float fast_sqrt(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return x >= 1.17549435e-38f ? x * r : 0.0f;
}

// Candidate pair c of an axis table row: source tile index and shift.
__device__ __forceinline__ void pair_of(const int* row, int c, int* t, int* d) {
  *t = row[1 + 2 * c];
  *d = row[2 + 2 * c];
}

// One region a block (see the file's head). kZ > 0: each thread's sums in
// registers, kZ >= TZ; kZ == 0: in the thread's own shared-memory column.
template <int KID, int F, int kZ>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks<F>)
deposit3d_pull_kernel(const float* __restrict__ u, const float* __restrict__ v,
                      const float* __restrict__ w, const float* __restrict__ h,
                      const float* __restrict__ vals, long long ld_vals,
                      const int* __restrict__ pstart, const int* __restrict__ pcount,
                      const int* __restrict__ tabz, const int* __restrict__ taby,
                      const int* __restrict__ tabx, const int* __restrict__ items,
                      float* __restrict__ out, Pull3 p) {
  // dynamic: the stage (u, v, sx, sy; w, sz, h / psz and -d + offset on z;
  // -d + offset on x and y and the clipped z range, region-local, as
  // floats; the packed x and y ranges, region-local; the weighted values
  // [f][slot]), the candidate pairs (first particle, z, y, x shifts;
  // wz * wy * wx) and their running particle counts (wz * wy * wx + 1), the
  // warps' kept counts (two rounds'), then for kZ == 0 the columns' sums
  // [f][z][thread]
  extern __shared__ float4 s_dyn[];
  const int S = p.stage;
  const int n_thr = blockDim.x, n_warps = n_thr >> 5;
  float4* s_xy = s_dyn;
  float4* s_z = s_dyn + S;
  float4* s_b = s_dyn + 2 * S;
  int4* s_pair = reinterpret_cast<int4*>(s_dyn + 3 * S);
  int2* s_rng = reinterpret_cast<int2*>(s_pair + p.wz * p.wy * p.wx);
  float* s_val = reinterpret_cast<float*>(s_rng + S);
  int* s_prefix = reinterpret_cast<int*>(s_val + F * S);
  int* s_cnt = s_prefix + p.wz * p.wy * p.wx + 1;
  float* s_col = reinterpret_cast<float*>(s_cnt + 2 * n_warps);

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
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
  // this thread's column of the region (none past TY x TX or the grid)
  const int xr = t % p.TX, yr = t / p.TX;
  const bool mine = yr < RY && xr < RX;
  const float xf = (float)xr, yf = (float)yr;

  // each candidate pair's first particle and shifts, and its particles,
  // then their running sum; the sums start at 0
  for (int c = t; c < n_combo; c += n_thr) {
    const int cz = c / (ncy * ncx), cyx = c - cz * ncy * ncx;
    const int cy = cyx / ncx, cx = cyx - cy * ncx;
    int t_z, t_y, t_x, dz, dy, dx;
    pair_of(rowz, cz, &t_z, &dz);
    pair_of(rowy, cy, &t_y, &dy);
    pair_of(rowx, cx, &t_x, &dx);
    const int tile = (t_z * p.nty + t_y) * p.ntx + t_x;
    s_pair[c] = make_int4(pstart[tile], dz, dy, dx);
    s_prefix[c + 1] = pcount[tile];
  }
  float acc[F][kZ > 0 ? kZ : 1];
#pragma unroll
  for (int f = 0; f < F; ++f)
#pragma unroll
    for (int z = 0; z < (kZ > 0 ? kZ : 1); ++z) acc[f][z] = 0.0f;
  if constexpr (kZ == 0) {
    for (int k = t; k < F * p.TZ * n_thr; k += n_thr) s_col[k] = 0.0f;
  }
  __syncthreads();
  if (t == 0) {
    s_prefix[0] = 0;
    for (int c = 0; c < n_combo; ++c) s_prefix[c + 1] += s_prefix[c];
  }
  __syncthreads();

  int round = 0;
  // the candidate pair holding this thread's candidate idx, s_prefix[pair]
  // <= idx < s_prefix[pair + 1]; idx only grows, so each round scans on
  // from the last (a binary search finds the first)
  int pair = 0;
  for (int hi = n_combo - 1; pair < hi;) {
    const int mid = (pair + hi + 1) >> 1;
    if (s_prefix[mid] <= c_lo + t) pair = mid; else hi = mid - 1;
  }
  for (int base = c_lo; base < c_hi;) {
    // stage: a candidate a thread, clipped to the region once; only those
    // that reach it are kept, in candidate order (a ballot a warp, then
    // the warps' counts, double-buffered by round)
    int ns = 0;
    while (base < c_hi && ns <= S - n_thr) {
      const int idx = base + t;
      bool keep = false;
      int4 r = make_int4(0, 0, 0, 0);
      float ul = 0.0f, vl = 0.0f, wl = 0.0f, sx = 0.0f, sy = 0.0f, sz = 0.0f, vs = 0.0f;
      int i = 0;
      if (idx < c_hi) {
        while (s_prefix[pair + 1] <= idx) ++pair;
        const int4 pr = s_pair[pair];
        const int dz = pr.y, dy = pr.z, dx = pr.w;
        i = pr.x + (idx - s_prefix[pair]);
        const float hi_ = h[i];
        ul = u[i]; vl = v[i]; wl = w[i];
        if (hi_ > 0.0f) {  // zero-h particles contribute exactly 0
          const float inv_h = 1.0f / hi_;
          vs = (p.norm3d * inv_h) * (inv_h * inv_h);
          sx = p.psx * inv_h; sy = p.psy * inv_h; sz = p.psz * inv_h;
          int a, b;
          axis_range(ul, hi_ * p.rx, p.K, p.BX, p.offset, &a, &b);
          r.x = pack_range(a, b, dx, RX);
          axis_range(vl, hi_ * p.ry, p.K, p.BY, p.offset, &a, &b);
          r.y = pack_range(a, b, dy, RY);
          axis_range(wl, hi_ * p.rz, p.K, p.BZ, p.offset, &a, &b);
          r.z = pack_range(a, b, dz, RZ);
          keep = range_lo(r.x) <= range_hi(r.x) && range_lo(r.y) <= range_hi(r.y) &&
                 range_lo(r.z) <= range_hi(r.z);
        }
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      int* cnt = s_cnt + (round & 1) * n_warps;
      if (lane == 0) cnt[warp] = __popc(ballot);
      __syncthreads();
      int before = ns;
      for (int k = 0; k < n_warps; ++k) {
        if (k < warp) before += cnt[k];
        ns += cnt[k];
      }
      if (keep) {
        // the walk takes each shift plus the sample offset (exact: the
        // offset is 0 or 1/2) and the z range as floats, and the chord's
        // scale h / psz, from here: no conversion per column
        const int s = before + __popc(ballot & ((1u << lane) - 1u));
        const int dz = range_d(r.z);
        s_xy[s] = make_float4(ul, vl, sx, sy);
        s_z[s] = make_float4(wl, sz, __frcp_rn(sz), (float)(-dz) + p.offset);
        s_b[s] = make_float4((float)(-range_d(r.x)) + p.offset, (float)(-range_d(r.y)) + p.offset,
                             (float)range_lo(r.z), (float)range_hi(r.z));
        s_rng[s] = make_int2(r.x, r.y);
#pragma unroll
        for (int f = 0; f < F; ++f) s_val[f * S + s] = vals[f * ld_vals + i] * vs;
      }
      base += n_thr;
      ++round;
    }
    __syncthreads();  // the stage is written
    // each staged candidate in turn: the thread walks its column's chord
    // of the support (none if the support misses the column)
    if (mine) {
      int2 r_next = s_rng[0];
      for (int j = 0; j < ns; ++j) {
        const int2 r = r_next;
        r_next = s_rng[min(j + 1, S - 1)];  // read ahead: the test waits on no load
        if (!in_range(xr, r.x) || !in_range(yr, r.y)) continue;
        const float4 a = s_xy[j];
        const float4 b = s_b[j];
        // offsets from the box-local index (the region index plus the
        // shift and the offset, exact in floats): the plain version's
        // arithmetic
        const float dxn = ((xf + b.x) - a.x) * a.z;
        const float dyn = ((yf + b.y) - a.y) * a.w;
        const float dxy2 = dxn * dxn + dyn * dyn;
        if (!(dxy2 < p.lim2)) continue;
        const float4 zw = s_z[j];
        // the chord: voxels z of the clipped z range (region-local) with
        // |z - d + offset - w| < sqrt(lim^2 - dxy2) / sz + slack; the
        // centre's region-local index rounds once, which the slack covers
        const float half = fast_sqrt(p.lim2 - dxy2) * zw.z + kSlack;
        const float zc = zw.x - zw.w;
        const float z_lo = fmaxf(zc - half, b.z), z_hi = fminf(zc + half, b.w);
        float ve[F];
#pragma unroll
        for (int f = 0; f < F; ++f) ve[f] = s_val[f * S + j];
        if constexpr (kZ > 0) {
#pragma unroll
          for (int z = 0; z < kZ; ++z) {
            if ((float)z < z_lo || (float)z > z_hi) continue;
            const float dzn = (((float)z + zw.w) - zw.x) * zw.y;
            const float q2 = dxy2 + dzn * dzn;
            if (q2 < p.lim2) {
              const float wgt = ast::shape_q<KID>(fast_sqrt(q2));
#pragma unroll
              for (int f = 0; f < F; ++f) acc[f][z] = fmaf(wgt, ve[f], acc[f][z]);
            }
          }
        } else {
          float zf = ceilf(z_lo);
          for (int z = (int)zf; zf <= z_hi; zf += 1.0f, ++z) {
            const float dzn = ((zf + zw.w) - zw.x) * zw.y;
            const float q2 = dxy2 + dzn * dzn;
            if (q2 < p.lim2) {
              const float wgt = ast::shape_q<KID>(fast_sqrt(q2));
              float* cell = s_col + z * n_thr + t;
#pragma unroll
              for (int f = 0; f < F; ++f) cell[f * p.TZ * n_thr] = fmaf(wgt, ve[f], cell[f * p.TZ * n_thr]);
            }
          }
        }
      }
    }
    __syncthreads();  // the stage is read
  }

  // add the column's sums into the cube once: plain loads and stores (the
  // region is this block's alone) or, for a region shared by several
  // blocks, atomics
  if (!mine) return;
  const long long cube = (long long)p.nz * p.ny * p.nx;
  const long long g0 = ((long long)rz0 * p.ny + (ry0 + yr)) * p.nx + (rx0 + xr);
  const long long plane = (long long)p.ny * p.nx;
  auto add = [&](float a, int z, int f) {
    if (a == 0.0f) return;
    float* cell = out + f * cube + g0 + z * plane;
    if (atomic) atomicAdd(cell, a);
    else *cell += a;
  };
  if constexpr (kZ > 0) {
#pragma unroll
    for (int z = 0; z < kZ; ++z) {
      if (z >= RZ) break;
#pragma unroll
      for (int f = 0; f < F; ++f) add(acc[f][z], z, f);
    }
  } else {
    for (int z = 0; z < RZ; ++z) {
#pragma unroll
      for (int f = 0; f < F; ++f) add(s_col[(f * p.TZ + z) * n_thr + t], z, f);
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
  // the walk adds the offset to integer shifts, exactly for these two
  if (offset != 0.0f && offset != 0.5f) return cudaErrorInvalidValue;
  if (n_fields < 1 || n_fields > kMaxFields3 || K <= 0 || TZ <= 0 || TZ > 255 ||
      TY <= 0 || TX <= 0 || TY * TX > kMaxThreads ||
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
  p.lim2 = support_factor * support_factor;
  p.rx = support_factor / psx;
  p.ry = support_factor / psy;
  p.rz = support_factor / psz;
  // a thread a column, whole warps; the stage holds two rounds of staging
  const int threads = (TY * TX + 31) / 32 * 32;
  p.stage = 2 * threads;
  const bool regs = TZ <= kRegZ;
  cudaStream_t s = (cudaStream_t)stream;
  int smem_optin = 0;
  cudaError_t err = ast::smem_optin(&smem_optin);
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)p.stage * (3 * sizeof(float4) + sizeof(int2) + n_fields * sizeof(float)) +
                      (size_t)wz * wy * wx * sizeof(int4) +
                      (size_t)(wz * wy * wx + 1 + 2 * threads / 32) * sizeof(int) +
                      (regs ? 0 : (size_t)n_fields * TZ * threads * sizeof(float));
  if (smem > (size_t)smem_optin) return cudaErrorInvalidConfiguration;
  return ast::dispatch_footprint(kernel_id, 0, [&](auto kid, auto) {
    constexpr int KID = decltype(kid)::value;
    auto go = [&](auto f, auto z) {
      auto kern = deposit3d_pull_kernel<KID, decltype(f)::value, decltype(z)::value>;
      cudaError_t e = ast::allow_smem(kern, smem);
      if (e != cudaSuccess) return e;
      kern<<<n_items, threads, smem, s>>>(u, v, w, h, vals, ld_vals, pstart, pcount, tabz, taby, tabx,
                                         items, out, p);
      return cudaGetLastError();
    };
    auto depth = [&](auto f) {
      return regs ? go(f, std::integral_constant<int, kRegZ>{}) : go(f, std::integral_constant<int, 0>{});
    };
    switch (n_fields) {
      case 1: return depth(std::integral_constant<int, 1>{});
      case 2: return depth(std::integral_constant<int, 2>{});
      case 3: return depth(std::integral_constant<int, 3>{});
      default: return depth(std::integral_constant<int, 4>{});
    }
  });
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
