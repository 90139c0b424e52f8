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
// support-bounded loops) and the cluster split live in deposit_common.cuh,
// shared with the coherent engine's deposit kernel (coherent.cu).
//
// Design. The TPU's sequential flat work list of (tile, 2048-particle
// chunk) steps, its packed schedule word and its channel-packed DMA blocks
// have no counterpart. A tile's particles are split over a cluster of C
// blocks (C <= 8; the wrapper takes 2 at every level, never from counts:
// ops/deposit_tiled.py::_CLUSTER) in groups of 8: rank r takes groups
// r, r + C, ... (cluster_groups), so that each block's share covers the
// whole tile (a contiguous range of its Morton-ordered particles would
// cover 1/C of it and stack the block's adds there) and each group is one
// 32-byte sector of every input array. Block rank r sums its share into
// its own shared-memory accumulator with shared float atomics; then the
// cluster reduce-scatters: block r adds slice r of the C accumulators in
// rank order through distributed shared memory and writes it out, zeros
// included. No device-memory atomics, no memset, and the densest tile is
// walked by C blocks instead of one (on the clustered 2^26 main path the
// K = 8 level's fullest tile holds ~11x the mean count). More blocks a
// tile walk such a tile faster but make every block of a light map's
// tiles zero and sum a whole accumulator (PERF.md section 6 times 1, 2
// and 8). Within a block
// the mapping is a template on the level:
//   - K = 8 and 16, a lane per particle: the share's groups are loaded 256
//     particles a step into shared memory, coalesced, and handed to the
//     lanes spread over the share (for_staged_spread); each warp then
//     enumerates the (particle, box pixel) pairs of its 32 particles and
//     takes them 32 at a time (deposit_balanced), so that no lane idles
//     while another walks a footprint ~30x larger (lognormal h), and the
//     32 particles' setups run side by side;
//   - K >= 32, a warp per particle: the 32 lanes take consecutive pixels of
//     the box (up to ~4,200 at K = 64), adds to 32 distinct addresses; the
//     warp loads its next particle while the current one deposits.
// A level whose accumulator exceeds the shared memory a block may use
// (F = 5 at K = 64: 5 * 96 * 128 * 4 B = 240 KiB) runs in passes over
// groups of fields, each pass its own cluster launch.
//
// Numerics: every precision the TPU engine offered (f32, bf16, bf16x2,
// bf16x3) becomes plain f32 FMA arithmetic here, at least as accurate as
// each limb split. The atomics make the summation order vary between runs,
// and the cluster adds its C partial sums in rank order; each pixel is a
// sum of same-signed f32 terms for non-negative payloads, whose rounding
// error grows like sqrt(n) * 2^-24 relative to the pixel, far inside the
// 1e-5 * max budget the port is held to.
//
// Bound on the card: device-memory bytes (each particle's u, v, h and
// values read once, the accumulators written once) at K = 8 and for the
// sparse K >= 32 levels, whose output dominates; FP32 work for dense
// large footprints. What holds it above that bound: the shared float adds,
// which compile to compare-and-swap loops (ATOMS.CAST.SPIN), one per pixel
// and field, and the per-pixel kernel evaluation. PERF.md section 6 gives
// each level's time beside its bound.

#include "deposit_common.cuh"

namespace {

using ast::Footprint;
using ast::kLanes;
using ast::kMaxCheb;
using ast::kMaxFields;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpMinK = 32;  // levels from this K take a warp per particle
constexpr int kGroup = 8;      // particles a group of the cluster split (a 32-byte sector)

template <int KID, bool INTEG, bool WARP>
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
  float* s_stage = acc + f_n * p.R * kLanes;  // kStageFloats (thread per particle only)
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
  if constexpr (WARP) {
    // warp w walks the w-th of kWarps contiguous runs of the share, the
    // next particle's inputs loaded while the current one deposits
    // (the k-th particle of the rank's share is at p0 + item(k); only the
    // tile's last group may be short)
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int last = (n + kGroup - 1) / kGroup - 1;
    const int n_mine =
        n_groups * kGroup - (n_groups > 0 && last % C == rank ? (last + 1) * kGroup - n : 0);
    auto item = [&](int k) { return (rank + (k / kGroup) * C) * kGroup + k % kGroup; };
    const int i0 = (int)(((long long)n_mine * warp) / kWarps);
    const int i1 = (int)(((long long)n_mine * (warp + 1)) / kWarps);
    float nu = 0.0f, nv = 0.0f, nh = 0.0f, nval[kMaxFields] = {};
    auto fetch = [&](int k) {
      const int i = p0 + item(k);
      nu = u[i];
      nv = v[i];
      nh = h[i];
#pragma unroll
      for (int f = 0; f < kMaxFields; ++f)
        if (f < f_n) nval[f] = val0[f * ld_vals + i];
    };
    if (i0 < i1) fetch(i0);
    for (int i = i0; i < i1; ++i) {
      const float cu = nu, cv = nv, ch = nh;
      float cval[kMaxFields];
#pragma unroll
      for (int f = 0; f < kMaxFields; ++f) cval[f] = nval[f];
      if (i + 1 < i1) fetch(i + 1);
      ast::deposit_warp<KID, INTEG>(acc, plane, f_n, p, s_cheb, n_cheb, cu, cv, ch, cval, 1, lane);
    }
  } else {
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
  }
  __syncthreads();
  ast::cluster_reduce_store(acc, n_acc, out + ((long long)t * n_fields + f_lo) * plane, C);
}

}  // namespace

extern "C" {

// Deposit one level's tiles over clusters of C blocks a tile. Returns the
// cudaError_t of the first failing attribute call or launch (cudaSuccess =
// 0); launches are asynchronous on `stream` and are not synchronised here.
int deposit2d_launch(const float* u, const float* v, const float* h,
                     const float* vals, long long ld_vals, int n_fields,
                     const int* pstart, const int* pcount, int n_tiles,
                     float* out, int K, int R, float offset, float psx,
                     float psy, int kernel_id, int integrated, float norm3d,
                     float support_factor, const float* cheb, int n_cheb,
                     int C, void* stream) {
  if (n_tiles <= 0) return cudaSuccess;
  if (n_fields < 1 || n_fields > kMaxFields || n_cheb > kMaxCheb || R <= 0 ||
      K <= 0 || C < 1 || C > 8)
    return cudaErrorInvalidValue;
  int smem_optin = 0;
  cudaError_t err = ast::smem_optin(&smem_optin);
  if (err != cudaSuccess) return err;
  const size_t plane_bytes = (size_t)R * kLanes * sizeof(float);
  const bool warp = K >= kWarpMinK;
  const size_t fixed = (kMaxCheb + (warp ? 0 : ast::kStageFloats)) * sizeof(float);
  int group = (int)(((size_t)smem_optin - fixed) / plane_bytes);
  if (group < 1) return cudaErrorInvalidConfiguration;
  if (group > n_fields) group = n_fields;
  const Footprint p = ast::make_footprint(K, R, offset, psx, psy, norm3d,
                                          support_factor, integrated);
  cudaStream_t s = (cudaStream_t)stream;
  for (int f_lo = 0; f_lo < n_fields; f_lo += group) {
    const int f_n = n_fields - f_lo < group ? n_fields - f_lo : group;
    const size_t smem = fixed + f_n * plane_bytes;
    err = ast::dispatch_footprint(kernel_id, integrated, [&](auto kid, auto integ) {
      constexpr int KID = decltype(kid)::value;
      constexpr bool INTEG = decltype(integ)::value;
      auto kern = warp ? deposit2d_kernel<KID, INTEG, true> : deposit2d_kernel<KID, INTEG, false>;
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
