// Adaptive-h 2D SPH deposit into extended tile accumulators, for Hopper.
//
// Replaces the TPU kernel astro_sph_tools_tpu/ops/deposit_pallas.py::
// _deposit_kernel + _chunk_contrib. Same contract: for every tile t of one
// footprint level, the (F*R, 128) f32 extended accumulator
//     acc[t][f*R + r][c] = sum_i val_f(i) * W_i(r, c)
// over the tile's particles i in [pstart[t], pstart[t] + pcount[t]) of the
// level's tile-sorted arrays, where R = TY + K rows, c is a lane of the
// 128-wide accumulator, and particle i's footprint covers the K columns
// col0_i + [0, K), col0_i = floor(u_i - offset + 0.5) - K/2, in TILE-LOCAL
// pixel coordinates (u, v). Columns outside [0, 128) are masked, not
// clipped or wrapped. The overlap-add that sums the extended tiles into the
// image stays in torch (ops/deposit_tiled.py::_overlap_add).
//
// The per-particle footprint math (kernel shapes, Clenshaw, the
// support-bounded box) lives in deposit_common.cuh, shared with the
// coherent engine's deposit kernel (coherent.cu). The TPU's sequential flat
// work list of (tile, 2048-particle chunk) steps, its packed schedule word
// and its channel-packed DMA blocks have no counterpart. A tile is taken
// by C blocks (C <= 8; the wrapper takes 2 at every level, never from
// counts: ops/deposit_tiled.py::_CLUSTER). Two designs, by the level's K:
//
// K = 8 and 16 (deposit2d_kernel), lane per particle, shared-memory
// atomics. Footprints of a few to ~200 pixels. The C blocks form a cluster
// and split the tile's particles in groups of 8: rank r takes groups r,
// r + C, ... (cluster_groups), so that each block's share covers the whole
// tile and each group is one 32-byte sector of every input array. Block
// rank r sums its share into its own shared-memory accumulator with shared
// float atomics: the share's groups are loaded 256 particles a step into
// shared memory, coalesced, and handed to the lanes spread over the share
// (for_staged_spread); each warp then enumerates the (particle, box pixel)
// pairs of its 32 particles and takes them 32 at a time (deposit_balanced),
// so that no lane idles while another walks a footprint ~30x larger. Then
// the cluster reduce-scatters: block r adds slice r of the C accumulators
// in rank order through distributed shared memory and writes it out, zeros
// included. A level whose accumulator exceeds the shared memory a block
// may use runs in passes over groups of fields. Bound on the card:
// device-memory bytes (each particle read once, the accumulators written
// once); held above it by the shared float adds, which compile to
// compare-and-swap loops (ATOMS.CAST.SPIN), one per pixel and field.
//
// K >= 32 (deposit2d_register), output-stationary in registers. Supports
// of 7-31 px; in the box maps these levels hold ~84 % of the pairs. Bound on
// the card: FP32 operations (one kernel evaluation and F multiply-adds a
// pair inside a support). Every particle of tile t lands only in tile t's
// accumulator, so the blocks of a tile hold the complete list of what
// touches its pixels, and each thread owns fixed pixels:
//   - the R rows form R/2 row pairs; pair p belongs to block rank p mod C
//     and, within it, to warp (p / C) mod W, so a rank owns every C-th pair
//     and a particle's rows spread over all W C warps (the tile's dense
//     middle rows do not pile onto one warp). A warp holds one pair at a
//     time and walks the tile's particles once a pair; W (at most 12) is
//     the fewest warps that take the pairs in the fewest walks: one walk
//     at K = 32 and two at K = 64 with C = 2, every warp busy in each;
//   - lane l of a warp takes row 2p + l / 16 of its pair and the columns
//     l mod 16 + 16 j, j = 0..7: a warp step covers 2 rows x 16 columns;
//     a thread keeps its 8 pixels' F sums over the staged chunk in
//     registers, and adds them to the pixels' totals in its own slots of
//     shared memory after each chunk (56 registers a thread: three blocks
//     of 12 warps an SM);
//   - the block stages the tile's particles a thread each in shared memory
//     (loaded coalesced), each once through particle_setup: its
//     coordinates, distance scales, scaled values, its loop box and the
//     16-column groups the box meets;
//   - a warp tests 32 staged particles at once, one a lane, against its
//     pair's rows, and takes those whose box meets them in staged order
//     (a ballot); for each it skips the column groups the box misses (the
//     same on every lane), and each lane runs add_pixel's exact test on
//     its pixel, the same ((r + offset - v) sy, (c + offset - u) sx)
//     arithmetic and q2 < lim2, then one multiply-add a field into its
//     registers; the weight is footprint_weight_rsqrt (the 3D kernel's
//     root by the reciprocal root, within 2 ulp), as in deposit_wide.cu;
//   - each thread writes each of its pixels once, zeros included;
//   - the wrapper hands the tiles over heaviest first (`order`), so that
//     a dense tile's blocks (up to ~2.5x the mean count) do not start last.
// No atomics, no accumulator shared between threads, no cluster reduce: the
// C blocks of a tile write disjoint rows. Lane efficiency (lane evaluations
// a pair inside a support; the 16-column groups and the square box around
// the disc): 2.3 at K = 32 (mean s ~10 px) and 1.75 at K = 64 (s ~21 px) in
// the box maps, against the warp-a-particle design's 1.3, which paid a
// shared-memory compare-and-swap loop a pair and field.
//
// Numerics: every precision the TPU engine offered (f32, bf16, bf16x2,
// bf16x3) becomes plain f32 FMA arithmetic here, at least as accurate as
// each limb split. At K = 8/16 the atomics make the summation order vary
// between runs, and the cluster adds its C partial sums in rank order. At
// K >= 32 each pixel's terms are added in the tile's particle order, each
// staged chunk's apart and then added to the pixel's sum, so the output has
// the same bits on every run. Each pixel is a sum of same-signed f32 terms
// for non-negative payloads, whose rounding error grows like
// sqrt(n) * 2^-24 relative to the pixel: at K >= 32 in the box maps one
// running sum a pixel read ~3e-6 of the max off the f64 sum, the chunked
// sums ~5e-7. PERF.md section 6 gives each level's time beside its bound.

#include <climits>

#include "deposit_common.cuh"

namespace {

using ast::Footprint;
using ast::kLanes;
using ast::kMaxCheb;
using ast::kMaxFields;

constexpr int kThreads = 256;
constexpr int kRegisterMinK = 32;  // levels from this K sum in registers
constexpr int kGroup = 8;          // particles a group of the cluster split (a 32-byte sector)
constexpr int kColGroup = 16;      // columns a half-warp takes in one step
constexpr int kColGroups = kLanes / kColGroup;
constexpr int kRegisterWarps = 12;  // most warps a block of the register path
constexpr int kRegisterThreads = 32 * kRegisterWarps;
constexpr int kRegisterBlocks = 3;  // register-path blocks an SM holds: at most 56 registers a thread

template <int KID, bool INTEG>
__global__ void __launch_bounds__(kThreads)
deposit2d_kernel(const float* __restrict__ u, const float* __restrict__ v,
                 const float* __restrict__ h, const float* __restrict__ vals,
                 long long ld_vals, int n_fields, int f_lo, int f_n,
                 const int* __restrict__ pstart, const int* __restrict__ pcount,
                 float* __restrict__ out, Footprint p,
                 const float* __restrict__ cheb, int n_cheb, int C) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_cheb = smem;             // kMaxCheb
  float* acc = smem + kMaxCheb;     // f_n * R * kLanes
  float* s_stage = acc + f_n * p.R * kLanes;  // kStageFloats
  const int t = blockIdx.x / C;
  const int rank = blockIdx.x - t * C;  // the cluster's block rank (1D clusters)
  const int plane = p.R * kLanes;
  const int n_acc = f_n * plane;

  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) acc[i] = 0.0f;
  if constexpr (INTEG) {
    for (int i = threadIdx.x; i < n_cheb; i += blockDim.x) s_cheb[i] = cheb[i];
  }
  __syncthreads();

  // this rank's particles: groups of kGroup, every C-th from group `rank`
  const int p0 = pstart[t], n = pcount[t];
  const int n_groups = ast::cluster_groups(n, kGroup, rank, C);
  const float* val0 = vals + (long long)f_lo * ld_vals;
  ast::for_staged_spread(
      n_groups, f_n, s_stage,
      [&](int g, int o, float& pu, float& pv, float& ph, float* pval) {
        const int j = (rank + g * C) * kGroup + o;
        if (j >= n) return;
        const int i = p0 + j;
        pu = u[i];
        pv = v[i];
        ph = h[i];
#pragma unroll
        for (int f = 0; f < kMaxFields; ++f)
          if (f < f_n) pval[f] = val0[f * ld_vals + i];
      },
      [&](float pu, float pv, float ph, const float* pval, int stride) {
        ast::deposit_balanced<KID, INTEG>(acc, plane, f_n, p, s_cheb, n_cheb, pu, pv, ph, pval, stride);
      });
  __syncthreads();
  ast::cluster_reduce_store(acc, n_acc, out + ((long long)t * n_fields + f_lo) * plane, C);
}

// The K >= 32 levels, output-stationary (see the file's head). Tile
// order[b / C] (heaviest first) goes to blocks b of the grid; its block
// rank r of C, of W warps, writes the row pairs p = r + C (w + W k) of out[t],
// warp w the k-th in the k-th walk over the tile's particles.
template <int KID, bool INTEG, int NF>
__global__ void __launch_bounds__(kRegisterThreads, kRegisterBlocks)
deposit2d_register(const float* __restrict__ u, const float* __restrict__ v,
                   const float* __restrict__ h, const float* __restrict__ vals,
                   long long ld_vals, const int* __restrict__ pstart,
                   const int* __restrict__ pcount, const int* __restrict__ order,
                   float* __restrict__ out, Footprint p, const float* __restrict__ cheb,
                   int n_cheb, int C) {
  __shared__ float4 s_geo[kRegisterThreads];     // ul, vl, sx, sy
  __shared__ int4 s_box[kRegisterThreads];       // r_lo, r_hi, c_lo, c_hi (rows empty: no deposit)
  __shared__ unsigned s_grp[kRegisterThreads];   // the 16-column groups the box meets
  __shared__ float s_val[NF][kRegisterThreads];  // values times the kernel's normalisation
  __shared__ float s_cheb[kMaxCheb];
  extern __shared__ float s_sum[];                // [8 NF][blockDim.x]: each thread's pixel sums
  const int tb = blockIdx.x / C, rank = blockIdx.x - tb * C;
  const int t = order[tb];
  const int n_stage = blockDim.x;  // particles staged at once: one a thread
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int half = lane >> 4, cl = lane & (kColGroup - 1);
  if constexpr (INTEG) {
    for (int i = threadIdx.x; i < n_cheb; i += n_stage) s_cheb[i] = cheb[i];
  }
  const int n_pairs = (p.R + 1) / 2;
  const int stride = (n_stage >> 5) * C;
  const int n_walks = (n_pairs + stride - 1) / stride;
  float cf[kColGroups];  // this lane's column sample points, as add_pixel computes them
#pragma unroll
  for (int j = 0; j < kColGroups; ++j) cf[j] = (float)(cl + kColGroup * j) + p.offset;
  const int p0 = pstart[t], n = pcount[t];

  for (int walk = 0; walk < n_walks; ++walk) {
    const int pair = warp * C + rank + walk * stride;
    const int r0 = pair < n_pairs ? 2 * pair : -2;  // the pair's first row (-2: none this walk)
    const float rf = (float)(r0 + half) + p.offset;  // this lane's row's sample point
    float part[kColGroups][NF];  // this chunk's sums
    float* sum = s_sum + threadIdx.x;  // the pixels' sums over the chunks, n_stage floats apart
    for (int c0 = 0; c0 < n; c0 += n_stage) {
      __syncthreads();  // the previous chunk is walked (and the table loaded)
      {
        const int i = c0 + threadIdx.x;
        float pval[NF];
#pragma unroll
        for (int f = 0; f < NF; ++f) pval[f] = i < n ? vals[f * ld_vals + p0 + i] : 0.0f;
        ast::Particle q{};
        const bool live = i < n && ast::particle_setup<INTEG>(p, NF, u[p0 + i], v[p0 + i], h[p0 + i], pval, 1, q);
        s_geo[threadIdx.x] = make_float4(q.ul, q.vl, q.sx, q.sy);
        s_box[threadIdx.x] = live ? make_int4(q.r_lo, q.r_hi, q.c_lo, q.c_hi) : make_int4(INT_MAX, -1, 0, -1);
        s_grp[threadIdx.x] = (0xffu >> (kColGroups - 1 - ((unsigned)q.c_hi >> 4))) & (0xffu << ((unsigned)q.c_lo >> 4));
#pragma unroll
        for (int f = 0; f < NF; ++f) s_val[f][threadIdx.x] = q.ve[f];
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kColGroups; ++j)
#pragma unroll
        for (int f = 0; f < NF; ++f) part[j][f] = 0.0f;
      const int m = min(n_stage, n - c0);
      for (int base = 0; base < m; base += 32) {
        // the next 32 staged particles, one a lane, tested against the
        // warp's pair; then the warp takes those that meet it, in order
        bool mine = false;
        if (base + lane < m) {
          const int4 b = s_box[base + lane];
          mine = r0 >= 0 && b.x <= r0 + 1 && b.y >= r0;
        }
        for (unsigned hits = __ballot_sync(0xffffffffu, mine); hits; hits &= hits - 1) {
          const int i = base + __ffs(hits) - 1;
          const int4 b = s_box[i];
          const float4 g = s_geo[i];
          const unsigned groups = s_grp[i];
          float ve[NF];
#pragma unroll
          for (int f = 0; f < NF; ++f) ve[f] = s_val[f][i];
          const float dyn = (rf - g.y) * g.w;
          const float dy2 = dyn * dyn;
#pragma unroll
          for (int j = 0; j < kColGroups; ++j) {
            if (!((groups >> j) & 1u)) continue;  // the same on every lane
            const int c = cl + kColGroup * j;
            const float dxn = (cf[j] - g.x) * g.z;
            const float q2 = dy2 + dxn * dxn;
            // rows past the box hold no pixel of the support; columns
            // past it may (the K-column window)
            const bool ok = c >= b.z && c <= b.w && q2 < p.lim2;
            float w = ast::footprint_weight_rsqrt<KID, INTEG>(q2, s_cheb, n_cheb);
            w = ok ? w : 0.0f;
#pragma unroll
            for (int f = 0; f < NF; ++f) part[j][f] = fmaf(w, ve[f], part[j][f]);
          }
        }
      }
      // each chunk's terms summed apart, then added to the pixel's sum (in
      // shared memory, the thread's own): one running sum over all the
      // tile's terms would drift (~3e-6 of the max in the box maps)
#pragma unroll
      for (int j = 0; j < kColGroups; ++j)
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          float* a = sum + (j * NF + f) * n_stage;
          *a = c0 == 0 ? part[j][f] : *a + part[j][f];
        }
    }
    // each owned pixel written once, zeros included
    const int r = r0 + half;
    if (r0 >= 0 && r < p.R) {
      float* row = out + ((long long)t * NF * p.R + r) * kLanes + cl;
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int j = 0; j < kColGroups; ++j)
          row[(long long)f * p.R * kLanes + kColGroup * j] = n > 0 ? sum[(j * NF + f) * n_stage] : 0.0f;
    }
  }
}

template <int NF>
cudaError_t launch_register(int kernel_id, int integrated, int n_tiles, int C, int threads, cudaStream_t s,
                            const float* u, const float* v, const float* h, const float* vals,
                            long long ld_vals, const int* pstart, const int* pcount, const int* order,
                            float* out, const Footprint& p, const float* cheb, int n_cheb) {
  return ast::dispatch_footprint(kernel_id, integrated, [&](auto kid, auto integ) {
    constexpr int KID = decltype(kid)::value;
    constexpr bool INTEG = decltype(integ)::value;
    auto kern = deposit2d_register<KID, INTEG, NF>;
    const size_t smem = (size_t)kColGroups * NF * threads * sizeof(float);
    cudaError_t e = ast::allow_smem(kern, smem);
    if (e != cudaSuccess) return e;
    kern<<<(unsigned)n_tiles * (unsigned)C, threads, smem, s>>>(u, v, h, vals, ld_vals, pstart, pcount, order,
                                                               out, p, cheb, n_cheb, C);
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// Deposit one level's tiles, C blocks a tile (a cluster at K < 32; from
// K = 32 the tiles go in the order `order` gives, heaviest first). Returns
// the cudaError_t of the first failing attribute call or launch
// (cudaSuccess = 0); launches are asynchronous on `stream` and are not
// synchronised here.
int deposit2d_launch(const float* u, const float* v, const float* h,
                     const float* vals, long long ld_vals, int n_fields,
                     const int* pstart, const int* pcount, int n_tiles,
                     float* out, int K, int R, float offset, float psx,
                     float psy, int kernel_id, int integrated, float norm3d,
                     float support_factor, const float* cheb, int n_cheb,
                     int C, const int* order, void* stream) {
  if (n_tiles <= 0) return cudaSuccess;
  if (n_fields < 1 || n_fields > kMaxFields || n_cheb > kMaxCheb || R <= 0 ||
      K <= 0 || C < 1 || C > 8 || (K >= kRegisterMinK && !order))
    return cudaErrorInvalidValue;
  const Footprint p = ast::make_footprint(K, R, offset, psx, psy, norm3d,
                                          support_factor, integrated);
  cudaStream_t s = (cudaStream_t)stream;
  if (K >= kRegisterMinK) {
    // W warps a block, W x C a walk's pairs: the fewest walks, then the
    // fewest warps that take them
    const int n_pairs = (R + 1) / 2;
    const int walks = (n_pairs + C * kRegisterWarps - 1) / (C * kRegisterWarps);
    const int threads = 32 * ((n_pairs + C * walks - 1) / (C * walks));
    switch (n_fields) {
      case 1: return launch_register<1>(kernel_id, integrated, n_tiles, C, threads, s, u, v, h, vals, ld_vals, pstart, pcount, order, out, p, cheb, n_cheb);
      case 2: return launch_register<2>(kernel_id, integrated, n_tiles, C, threads, s, u, v, h, vals, ld_vals, pstart, pcount, order, out, p, cheb, n_cheb);
      case 3: return launch_register<3>(kernel_id, integrated, n_tiles, C, threads, s, u, v, h, vals, ld_vals, pstart, pcount, order, out, p, cheb, n_cheb);
      case 4: return launch_register<4>(kernel_id, integrated, n_tiles, C, threads, s, u, v, h, vals, ld_vals, pstart, pcount, order, out, p, cheb, n_cheb);
      default: return launch_register<5>(kernel_id, integrated, n_tiles, C, threads, s, u, v, h, vals, ld_vals, pstart, pcount, order, out, p, cheb, n_cheb);
    }
  }
  int smem_optin = 0;
  cudaError_t err = ast::smem_optin(&smem_optin);
  if (err != cudaSuccess) return err;
  const size_t plane_bytes = (size_t)R * kLanes * sizeof(float);
  const size_t fixed = (kMaxCheb + ast::kStageFloats) * sizeof(float);
  int group = (int)(((size_t)smem_optin - fixed) / plane_bytes);
  if (group < 1) return cudaErrorInvalidConfiguration;
  if (group > n_fields) group = n_fields;
  for (int f_lo = 0; f_lo < n_fields; f_lo += group) {
    const int f_n = n_fields - f_lo < group ? n_fields - f_lo : group;
    const size_t smem = fixed + f_n * plane_bytes;
    err = ast::dispatch_footprint(kernel_id, integrated, [&](auto kid, auto integ) {
      constexpr int KID = decltype(kid)::value;
      constexpr bool INTEG = decltype(integ)::value;
      auto kern = deposit2d_kernel<KID, INTEG>;
      cudaError_t e = ast::allow_smem(kern, smem);
      if (e != cudaSuccess) return e;
      return ast::launch_clusters(kern, n_tiles, C, kThreads, smem, s, u, v, h, vals, ld_vals,
                                  n_fields, f_lo, f_n, pstart, pcount, out, p, cheb, n_cheb, C);
    });
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
