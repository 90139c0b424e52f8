// The 2D deposit's oversize route, for Hopper: footprints wider than kernel
// #1's widest level (support radius past 31 px), summed output-stationary.
//
// Replaces no TPU kernel. The JAX package sends these footprints to XLA
// (astro_sph_tools_tpu/ops/deposit.py's dense pass, a whole map a
// particle); the port's plain torch route (ops/deposit.py::deposit_2d) adds
// them with K x K windows (K = 128-1024) and index_add_, about 170x slower
// per pair than kernel #1 on halo cutouts, where three particles in four
// are oversize. Kernel #1 cannot take them: its extended accumulator is one
// 128-lane shared-memory row, so no level holds K >= 128.
//
// Contract: for the particles i of one oversize segment, in GLOBAL f32
// pixel coordinates (u_i, v_i) (the layouts' sorted_u/sorted_v or the
// coherent tail's tu/tv), with normalised-distance-per-pixel factors
// (sx_i, sy_i) and value scales computed on the torch side
// (ops/deposit_wide.py::particle_geometry),
//     out[f][y][x] += sum_i val_f(i) * scale_i * w(q2_i(x, y)),
//     q2 = ((x + offset - u) sx)^2 + ((y + offset - v) sy)^2  (< lim2),
// with the minimum image per axis on a periodic map (as the dense pass
// has it, discs wider than the map included); w is deposit_common.cuh's
// footprint_weight_rsqrt: shape_q(sqrt(q2)) (kernel3d, the root by the
// reciprocal root) or footprint_weight's Chebyshev table (integrated).
//
// Bound on the card: FP32 operations. At halo-cutout footprints (60-2000 px
// across) a particle covers thousands of pixels, so the pairs inside the
// supports (~3.6e10 a three-halo product, 14 + 2F operations each) outweigh
// the bytes (each particle read once, each map pixel read and written
// once) some 400x.
//
// Design, against that bound: output-stationary, no atomics.
//   1. Binning (wide_bin_kernel, twice): a block per 32 x 32 output tile
//      tests every particle of the batch against the tile's rectangle of
//      sample points (a circle-rectangle test in normalised units, with
//      0.01 px of slack, so the corner tiles of a disc's bounding box drop
//      out); the first pass counts each tile's hits, torch scans them into
//      list starts (the lists' total is the one number the host reads), the
//      second pass writes each tile's particle indices in particle order
//      (ballots and a block prefix: no atomics, so the lists, and the sums
//      below, are the same on every run).
//   2. Deposit (wide_deposit_kernel): a tile's list is split into C
//      contiguous parts, one a block of a C-block cluster (the wrapper
//      takes C = 4, ops/deposit_wide.py::CLUSTER: a cutout's central tiles
//      hold several times the mean list, and a block a tile would walk
//      them alone at the launch's end). A block stages 256 entries at a
//      time (u, v, sx, sy and the scaled values) in shared memory; each
//      warp owns 4 rows of the tile and each lane a column, so a thread
//      keeps 4 pixels x F sums in registers, each staged chunk's terms
//      summed apart and then added to them (a central pixel takes ~1e5
//      terms, whose one f32 running sum drifts by several 1e-5). A row
//      outside a particle's support is skipped by the whole warp at once
//      (its dy is the same on every lane). The ranks' sums then meet in shared memory and rank r
//      adds its slice of rows, the C parts summed in rank order, into the
//      image once; nothing else writes the route's image during the
//      launch. F <= 5 per launch; more fields run in passes over groups of
//      five.
// No K^2 window (a 128 window spends 16,384 pixels on a disc of 3,217 at
// s = 32): a tile's evaluated pixels are the rows it shares with the disc.

#include "deposit_common.cuh"

namespace {

using ast::kMaxCheb;
using ast::kMaxFields;

constexpr int kTile = 32;                   // output tile side (px)
constexpr int kThreads = 256;               // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kTile / kWarps;       // rows a warp (and a thread) owns
constexpr int kChunk = kThreads;            // list entries staged a step
constexpr float kBinSlack = 0.01f;          // px the binning's gaps are shortened by

// The map and the support test shared by the kernels.
struct Grid {
  int nx, ny;       // map size (px)
  int ntx;          // tiles a row
  float offset;     // pixel sample offset (0.5: centres)
  int periodic;     // minimum image per axis
  float lim2;       // squared normalised support
};

// The gap along one axis between coordinate c and the sample points [a, b]
// of a tile (0 inside), on a periodic axis the least over c's images,
// shortened by the slack. Rounded operation by operation (no contraction),
// as ops/deposit_wide.py::_axis_gap computes it, so that both binnings
// give the same lists.
__device__ __forceinline__ float axis_gap(float c, float a, float b, float period, int periodic) {
  float g = fmaxf(fmaxf(__fsub_rn(a, c), __fsub_rn(c, b)), 0.0f);
  if (periodic) {
    const float lo = __fsub_rn(c, period), hi = __fadd_rn(c, period);
    g = fminf(g, fmaxf(fmaxf(__fsub_rn(a, lo), __fsub_rn(lo, b)), 0.0f));
    g = fminf(g, fmaxf(fmaxf(__fsub_rn(a, hi), __fsub_rn(hi, b)), 0.0f));
  }
  return fmaxf(__fsub_rn(g, kBinSlack), 0.0f);
}

// Whether particle (u, v, sx, sy) reaches a pixel of the tile whose sample
// points span [ax, bx] x [ay, by] (a superset: the deposit's exact test
// decides each pixel). A particle with h <= 0 carries NaN factors and
// reaches none.
__device__ __forceinline__ bool tile_hit(float4 p, float ax, float bx, float ay, float by, const Grid& g) {
  const float gx = __fmul_rn(axis_gap(p.x, ax, bx, (float)g.nx, g.periodic), p.z);
  const float gy = __fmul_rn(axis_gap(p.y, ay, by, (float)g.ny, g.periodic), p.w);
  return __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)) < g.lim2;
}

// The sample points [a, b] of tile index t along an axis of n pixels.
__device__ __forceinline__ void tile_span(int t, int n, float offset, float& a, float& b) {
  a = (float)(t * kTile) + offset;
  b = (float)(min(t * kTile + kTile, n) - 1) + offset;
}

// One pass of the binning over particles [0, n) of `geo` (u, v, sx, sy),
// a block per tile. COUNT: counts[tile] = the tile's hits. Else: the hits'
// indices, in particle order, at lists[starts[tile] ...].
template <bool COUNT>
__global__ void __launch_bounds__(kThreads)
wide_bin_kernel(const float4* __restrict__ geo, int n, Grid g, int* __restrict__ counts,
                const long long* __restrict__ starts, int* __restrict__ lists) {
  __shared__ int s_warp[kWarps];
  const int tile = blockIdx.x;
  const int tx = tile % g.ntx, ty = tile / g.ntx;
  float ax, bx, ay, by;
  tile_span(tx, g.nx, g.offset, ax, bx);
  tile_span(ty, g.ny, g.offset, ay, by);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long next = COUNT ? 0 : starts[tile];
  int total = 0;
  for (int i0 = 0; i0 < n; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    const bool hit = i < n && tile_hit(geo[i], ax, bx, ay, by, g);
    if constexpr (COUNT) {
      total += __syncthreads_count(hit);
    } else {
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) s_warp[warp] = __popc(ballot);
      __syncthreads();
      int before = 0, sum = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int c = s_warp[w];
        before += w < warp ? c : 0;
        sum += c;
      }
      if (hit) lists[next + before + __popc(ballot & ((1u << lane) - 1u))] = i;
      next += sum;
      __syncthreads();  // s_warp is rewritten next step
    }
  }
  if constexpr (COUNT) {
    if (threadIdx.x == 0) counts[tile] = total;
  }
}

// The periodic image of an offset d (px) on an axis of period L: d - L
// rint(d / L), as the dense pass takes it.
__device__ __forceinline__ float min_image(float d, float L, float inv_L) {
  return d - L * rintf(d * inv_L);
}

// The deposit of each tile's list into out (F fields of ny x nx, plane
// floats apart), a cluster of C blocks a tile: rank r sums the r-th of C
// contiguous parts of the list in registers (see the file's head), the
// ranks' sums meet in shared memory, and rank r adds rows [32 r / C,
// 32 (r + 1) / C) of the tile, the C parts summed in rank order, into out.
template <int KID, bool INTEG, int FN>
__global__ void __launch_bounds__(kThreads)
wide_deposit_kernel(const float4* __restrict__ geo, const float* __restrict__ scale,
                    const float* __restrict__ vals, long long ld_vals,
                    const long long* __restrict__ starts, const int* __restrict__ lists, Grid g,
                    float* __restrict__ out, long long plane, const float* __restrict__ cheb,
                    int n_cheb, int C) {
  namespace cg = cooperative_groups;
  __shared__ float4 s_geo[kChunk];
  __shared__ float s_val[FN][kChunk];
  __shared__ float s_cheb[kMaxCheb];
  __shared__ float s_sum[FN][kTile * kTile];
  const int tile = blockIdx.x / C, rank = blockIdx.x - tile * C;
  const long long t_lo = starts[tile], t_n = starts[tile + 1] - t_lo;
  if (t_n == 0) return;  // the whole cluster returns
  const long long lo = t_lo + t_n * rank / C, hi = t_lo + t_n * (rank + 1) / C;
  const int tx = tile % g.ntx, ty = tile / g.ntx;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = tx * kTile + lane;
  const int row0 = ty * kTile + warp * kRows;
  const float xc = (float)col + g.offset;
  float yr[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) yr[r] = (float)(row0 + r) + g.offset;
  const float Lx = (float)g.nx, Ly = (float)g.ny;
  const float inv_Lx = 1.0f / Lx, inv_Ly = 1.0f / Ly;
  if constexpr (INTEG) {
    for (int i = threadIdx.x; i < n_cheb; i += kThreads) s_cheb[i] = cheb[i];
  }
  float acc[kRows][FN];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int f = 0; f < FN; ++f) acc[r][f] = 0.0f;

  for (long long c0 = lo; c0 < hi; c0 += kChunk) {
    const int m = (int)min((long long)kChunk, hi - c0);
    __syncthreads();  // the previous chunk is consumed (and the table loaded)
    if (threadIdx.x < m) {
      const int p = lists[c0 + threadIdx.x];
      s_geo[threadIdx.x] = geo[p];
      const float sc = scale[p];
#pragma unroll
      for (int f = 0; f < FN; ++f) s_val[f][threadIdx.x] = vals[f * ld_vals + p] * sc;
    }
    __syncthreads();
    float part[kRows][FN] = {};  // this chunk's sums, added to acc once
    for (int j = 0; j < m; ++j) {
      const float4 q = s_geo[j];  // u, v, sx, sy
      float dx = xc - q.x;
      if (g.periodic) dx = min_image(dx, Lx, inv_Lx);
      const float dxn = dx * q.z;
      const float dx2 = dxn * dxn;
      float ve[FN];
#pragma unroll
      for (int f = 0; f < FN; ++f) ve[f] = s_val[f][j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float dy = yr[r] - q.y;
        if (g.periodic) dy = min_image(dy, Ly, inv_Ly);
        const float dyn = dy * q.w;
        const float dy2 = dyn * dyn;
        if (dy2 < g.lim2) {  // the same on every lane of the warp
          const float q2 = dx2 + dy2;
          float w = ast::footprint_weight_rsqrt<KID, INTEG>(q2, s_cheb, n_cheb);
          w = q2 < g.lim2 ? w : 0.0f;
#pragma unroll
          for (int f = 0; f < FN; ++f) part[r][f] = fmaf(w, ve[f], part[r][f]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int f = 0; f < FN; ++f) acc[r][f] += part[r][f];
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int f = 0; f < FN; ++f) s_sum[f][(warp * kRows + r) * kTile + lane] = acc[r][f];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int r_lo = kTile * rank / C, r_hi = kTile * (rank + 1) / C;
  for (int i = r_lo * kTile + threadIdx.x; i < r_hi * kTile; i += kThreads) {
    const int row = ty * kTile + i / kTile, c = tx * kTile + i % kTile;
    if (row >= g.ny || c >= g.nx) continue;
    float* px = out + (long long)row * g.nx + c;
#pragma unroll
    for (int f = 0; f < FN; ++f) {
      float s = 0.0f;
      for (int k = 0; k < C; ++k) s += cluster.map_shared_rank(&s_sum[f][0], k)[i];
      px[f * plane] += s;
    }
  }
  cluster.sync();  // keep every rank's sums alive until the cluster has read them
}

inline Grid make_grid(int nx, int ny, float offset, int periodic, float lim2) {
  Grid g;
  g.nx = nx;
  g.ny = ny;
  g.ntx = (nx + kTile - 1) / kTile;
  g.offset = offset;
  g.periodic = periodic;
  g.lim2 = lim2;
  return g;
}

inline long long n_tiles_of(const Grid& g) {
  return (long long)g.ntx * ((g.ny + kTile - 1) / kTile);
}

template <int FN>
cudaError_t launch_deposit(int kernel_id, int integrated, int n_tiles, int C, cudaStream_t s,
                           const float4* geo, const float* scale, const float* vals, long long ld_vals,
                           const long long* starts, const int* lists, const Grid& g, float* out,
                           long long plane, const float* cheb, int n_cheb) {
  return ast::dispatch_footprint(kernel_id, integrated, [&](auto kid, auto integ) {
    constexpr int KID = decltype(kid)::value;
    constexpr bool INTEG = decltype(integ)::value;
    return ast::launch_clusters(wide_deposit_kernel<KID, INTEG, FN>, n_tiles, C, kThreads, 0, s, geo, scale,
                                vals, ld_vals, starts, lists, g, out, plane, cheb, n_cheb, C);
  });
}

}  // namespace

extern "C" {

// One binning pass over the particles [0, n) of geo ((n, 4) f32: u, v, sx,
// sy). counts != NULL: the count pass (counts[tile], int32); else the fill
// pass, writing int32 indices into lists at the int64 starts. Returns the
// launch's cudaError_t.
int wide_bin_launch(const float* geo, int n, int nx, int ny, float offset, int periodic, float lim2,
                    int* counts, const long long* starts, int* lists, void* stream) {
  if (n < 0 || nx <= 0 || ny <= 0) return cudaErrorInvalidValue;
  const Grid g = make_grid(nx, ny, offset, periodic, lim2);
  const long long n_tiles = n_tiles_of(g);
  if (n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float4* p = reinterpret_cast<const float4*>(geo);
  if (counts)
    wide_bin_kernel<true><<<(unsigned)n_tiles, kThreads, 0, s>>>(p, n, g, counts, nullptr, nullptr);
  else
    wide_bin_kernel<false><<<(unsigned)n_tiles, kThreads, 0, s>>>(p, n, g, nullptr, starts, lists);
  return cudaGetLastError();
}

// The deposit of the tile lists (starts: n_tiles + 1 int64, lists: int32
// particle indices) into out ((n_fields, ny, nx) f32, added into), over
// clusters of C blocks a tile, in passes over groups of up to five fields.
// vals is (n_fields, n) with row stride ld_vals. Returns the first failing
// launch's cudaError_t.
int wide_deposit_launch(const float* geo, const float* scale, const float* vals, long long ld_vals,
                        int n_fields, const long long* starts, const int* lists, int nx, int ny,
                        float offset, int periodic, float lim2, float* out, int kernel_id,
                        int integrated, const float* cheb, int n_cheb, int C, void* stream) {
  if (n_fields < 1 || nx <= 0 || ny <= 0 || n_cheb > kMaxCheb || C < 1 || C > 8)
    return cudaErrorInvalidValue;
  const Grid g = make_grid(nx, ny, offset, periodic, lim2);
  const long long n_tiles = n_tiles_of(g);
  if (n_tiles * C > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int nt = (int)n_tiles;
  const long long plane = (long long)nx * ny;
  cudaStream_t s = (cudaStream_t)stream;
  const float4* p = reinterpret_cast<const float4*>(geo);
  for (int f_lo = 0; f_lo < n_fields; f_lo += kMaxFields) {
    const int f_n = n_fields - f_lo < kMaxFields ? n_fields - f_lo : kMaxFields;
    const float* v = vals + f_lo * ld_vals;
    float* o = out + f_lo * plane;
    cudaError_t err;
    switch (f_n) {
      case 1: err = launch_deposit<1>(kernel_id, integrated, nt, C, s, p, scale, v, ld_vals, starts, lists, g, o, plane, cheb, n_cheb); break;
      case 2: err = launch_deposit<2>(kernel_id, integrated, nt, C, s, p, scale, v, ld_vals, starts, lists, g, o, plane, cheb, n_cheb); break;
      case 3: err = launch_deposit<3>(kernel_id, integrated, nt, C, s, p, scale, v, ld_vals, starts, lists, g, o, plane, cheb, n_cheb); break;
      case 4: err = launch_deposit<4>(kernel_id, integrated, nt, C, s, p, scale, v, ld_vals, starts, lists, g, o, plane, cheb, n_cheb); break;
      default: err = launch_deposit<5>(kernel_id, integrated, nt, C, s, p, scale, v, ld_vals, starts, lists, g, o, plane, cheb, n_cheb); break;
    }
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
