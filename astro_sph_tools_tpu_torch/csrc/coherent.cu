// The coherent-order engine's two kernels, for Hopper.
//
// 1. coherent_prep_kernel replaces the TPU kernel
//    astro_sph_tools_tpu/ops/coherent_prep_pallas.py::_prep_kernel. For each
//    2048-lane row of the particle arrays (one thread block per row, each of
//    256 threads owning 8 consecutive lanes):
//    - assignment: pixel coordinates, support radius in pixels, footprint
//      level, tile and tile-local coordinates, and the composite key
//      ckey = bases[level] + tile, bit for bit as the plain torch version
//      (ops/coherent_prep.py::prep_rows_plain, which runs the sorted
//      engine's _pixel_coords and _multi_level_assign) computes them on a
//      CUDA tensor: torch divides a CUDA tensor by a Python scalar as a
//      multiplication by the scalar's f32 reciprocal, subtracts as one
//      rounded operation, takes torch.remainder as fmod plus a conditional
//      add, and truncates in int casts. Here every operation is an
//      IEEE-rounded intrinsic (__fmul_rn, __fsub_rn, __fadd_rn) that nvcc
//      never contracts into an FMA.
//    - a stable two-sided partition: level-0 lanes ("heads", ckey <
//      bases[1]) move left to their head rank, the rest ("tails") to
//      C - n_tail + their tail rank, keeping lane order within each side.
//      The TPU routes the channels through 2 x 11 butterfly stages; here a
//      block-wide exclusive scan of the tail flag (warp shuffles + shared
//      memory) gives every lane its destination and the channels are written
//      there directly.
//    - the packed row (8, C): [u_loc, v_loc, h, val_0..val_{F-1}, ckey, 0..].
//    - the aux row (128 floats): the row's <= d_max smallest distinct head
//      keys (d_max rounds of a block-wide min; the pad key when the row runs
//      out), tail_eff, n_l0, heavy, the per-level lane counts of levels
//      1..n_levels (the last is oversize) and one K4 flag per candidate,
//      zeros after. A row with more than d_max distinct head keys is heavy:
//      tail_eff = C and its candidate keys are the pad key.
//    Bound on the card: device-memory traffic (each row reads 3 + F floats
//    and writes 8 + 0.0625 floats per lane) plus the 2 * d_max + 5 block
//    reductions per row; the block-per-row design has 2^15 independent
//    blocks at 2^26 particles, so the card is full.
//
// 2. coherent_deposit_kernel replaces the TPU kernel
//    astro_sph_tools_tpu/ops/deposit_coherent.py::_deposit_kernel_coherent.
//    Each level-0 tile t owns the slice [cstart[t], cend[t]) of the
//    tile-sorted candidate list (cand_row holds each candidate's packed
//    row). A cluster of C blocks shares the tile (C <= 8; the wrapper
//    takes 2, ops/deposit_tiled.py::_CLUSTER, never from counts):
//    rank r takes every C-th candidate row from the r-th (cluster_groups in
//    deposit_common.cuh), so that each block's rows spread over the whole
//    tile. Within a block a warp takes one (row, 256-lane chunk) item at a
//    time from a shared counter, so that the block's 8 warps deposit 8
//    parts of the tile at once and no barrier follows a row (the TPU's grid
//    walked the rows in order, one after another). For its chunk the warp
//    ballots the lanes whose f32 key channel equals t into its own list in
//    shared memory, reads their channels 32 at a time (mostly consecutive
//    lanes: coalesced) and deposits them with deposit_balanced: the warp's
//    (particle, pixel) pairs balanced over its lanes, adds into the block's
//    (F*R, 128) shared accumulator. The cluster then reduce-scatters: block
//    r adds slice r of the C accumulators in rank order through distributed
//    shared memory and writes it, zeros included (a tile without
//    candidates writes zeros). The TPU's packed schedule word (work, kclass,
//    tile, row bits) exists for its sequential grid and its scalar memory
//    and has no counterpart. Its K4 column loop (kclass) changes no value:
//    the support-bounded loop already skips the columns the TPU summed as
//    zeros, so the per-candidate K4 flags the layout carries are not read.
//    Bound on the card: device-memory bytes (each candidate row's key
//    channel, the u, v, h and value channels of its matching lanes, the
//    candidate arrays and the accumulators written once). The split keeps
//    a dense tile's rows (up to ~9x the mean on the clustered main path)
//    from serialising in one block.

#include <float.h>
#include <limits.h>

#include "deposit_common.cuh"

namespace {

using ast::Footprint;
using ast::kLanes;
using ast::kMaxCheb;

constexpr int kC = 2048;            // lanes per row
constexpr int kThreads = 256;
constexpr int kPer = kC / kThreads; // lanes per thread (prep)
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLevels = 4;
constexpr int kAuxW = 128;
constexpr int kMaxFields = 4;       // the key channel takes the 8th slot
constexpr int kMaxD = 60;           // 2 * d_max + 3 + n_levels <= kAuxW
constexpr int kChunkLanes = 256;    // lanes of a row a warp stages at once (deposit)

struct PrepParams {
  float x0, y0, inv_psx, inv_psy, nxf, nyf, sf, inv_minps;
  float bound[kMaxLevels], inv_tx[kMaxLevels], inv_ty[kMaxLevels];
  int periodic, n_levels, d_max;
  int ntx[kMaxLevels], nty[kMaxLevels], tx[kMaxLevels], ty[kMaxLevels],
      m[kMaxLevels];
  int base[kMaxLevels + 1];
};
constexpr int kPrepFloats = 8 + 3 * kMaxLevels;
constexpr int kPrepInts = 3 + 5 * kMaxLevels + kMaxLevels + 1;

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide min / sum of one int per thread; every thread gets the result.
// `red` holds kWarps + 1 ints; the trailing barrier lets it be reused.
__device__ __forceinline__ int block_min(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_min(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_min(lane < kWarps ? red[lane] : INT_MAX);
    if (lane == 0) red[kWarps] = v;
  }
  __syncthreads();
  v = red[kWarps];
  __syncthreads();
  return v;
}

__device__ __forceinline__ int block_sum(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_sum(lane < kWarps ? red[lane] : 0);
    if (lane == 0) red[kWarps] = v;
  }
  __syncthreads();
  v = red[kWarps];
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(kThreads)
coherent_prep_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     const float* __restrict__ h, const float* __restrict__ vals,
                     long long ld_vals, int n_fields,
                     float* __restrict__ packed, float* __restrict__ aux,
                     PrepParams P) {
  __shared__ int red[kWarps + 1];
  __shared__ int s_warp_tails[kWarps];
  __shared__ float s_aux[kAuxW];

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane_id = tid & 31, warp = tid >> 5;
  const long long rbase = (long long)row * kC;
  const int nl = P.n_levels;
  const int tail_base = P.base[1];
  const int pad_key = P.base[nl] + 1;

  // --- assignment, 8 consecutive lanes per thread ---
  float uloc[kPer], vloc[kPer], hh[kPer];
  int key[kPer], lev[kPer];
  bool big[kPer];
  int n_tail_mine = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const long long i = rbase + tid * kPer + j;
    const float hi = h[i];
    float u = __fmul_rn(__fsub_rn(x[i], P.x0), P.inv_psx);
    float v = __fmul_rn(__fsub_rn(y[i], P.y0), P.inv_psy);
    if (P.periodic) {
      // torch.remainder: fmod, then add the divisor to a negative result
      u = fmodf(u, P.nxf);
      if (u < 0.0f) u = __fadd_rn(u, P.nxf);
      v = fmodf(v, P.nyf);
      if (v < 0.0f) v = __fadd_rn(v, P.nyf);
    }
    const float s_pix = __fmul_rn(__fmul_rn(hi, P.sf), P.inv_minps);
    int level = nl;
    for (int li = nl - 1; li >= 0; --li)
      if (P.bound[li] >= 0.0f && s_pix <= P.bound[li]) level = li;
    int ck, tile = 0;
    float ul = u, vl = v;
    if (level < nl) {
      int txi = (int)__fmul_rn(u, P.inv_tx[level]);
      int tyi = (int)__fmul_rn(v, P.inv_ty[level]);
      txi = min(max(txi, 0), P.ntx[level] - 1);
      tyi = min(max(tyi, 0), P.nty[level] - 1);
      tile = tyi * P.ntx[level] + txi;
      ul = __fsub_rn(u, (float)(txi * P.tx[level] - P.m[level]));
      vl = __fsub_rn(v, (float)(tyi * P.ty[level] - P.m[level]));
      ck = P.base[level] + tile;
    } else {
      ck = P.base[nl];
    }
    uloc[j] = ul;
    vloc[j] = vl;
    hh[j] = hi;
    key[j] = ck;
    lev[j] = level;
    const bool is_tail = ck >= tail_base;
    big[j] = !is_tail && s_pix > 1.0f;  // _K4_MAX_S
    n_tail_mine += is_tail;
  }

  // --- exclusive scan of the tail counts over the block ---
  int incl = n_tail_mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane_id >= o) incl += t;
  }
  if (lane_id == 31) s_warp_tails[warp] = incl;
  __syncthreads();
  int warp_prefix = 0, n_tail = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_warp_tails[w];
    if (w < warp) warp_prefix += c;
    n_tail += c;
  }
  int tb = warp_prefix + incl - n_tail_mine;  // tails before my first lane

  // --- stable two-sided partition, written straight to the destination ---
  float* prow = packed + rbase * 8;
  const int key_ch = 3 + n_fields;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int lane = tid * kPer + j;
    const bool is_tail = key[j] >= tail_base;
    const int dest = is_tail ? kC - n_tail + tb : lane - tb;
    tb += is_tail;
    prow[dest] = uloc[j];
    prow[kC + dest] = vloc[j];
    prow[2 * kC + dest] = hh[j];
    for (int f = 0; f < n_fields; ++f)
      prow[(3 + f) * kC + dest] = vals[f * ld_vals + rbase + lane];
    prow[key_ch * kC + dest] = (float)key[j];
    for (int c = key_ch + 1; c < 8; ++c) prow[c * kC + lane] = 0.0f;
  }

  // --- candidates: d_max rounds of a block-wide min over the head keys ---
  int mk[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) mk[j] = key[j] >= tail_base ? pad_key : key[j];
  const int d_max = P.d_max;
  for (int d = 0; d < d_max; ++d) {
    int mine = INT_MAX;
#pragma unroll
    for (int j = 0; j < kPer; ++j) mine = min(mine, mk[j]);
    const int m = block_min(mine, red);
    int any_big = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      any_big |= (key[j] == m) & big[j];
      if (mk[j] == m) mk[j] = pad_key;
    }
    any_big = __syncthreads_or(any_big);
    if (tid == 0) {
      s_aux[d] = (float)m;
      s_aux[d_max + 3 + nl + d] = any_big ? 0.0f : 1.0f;
    }
  }
  int mine = INT_MAX;
#pragma unroll
  for (int j = 0; j < kPer; ++j) mine = min(mine, mk[j]);
  const bool heavy = block_min(mine, red) < tail_base;

  int lev_count[kMaxLevels];
  for (int li = 1; li <= nl; ++li) {
    int c = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) c += min(lev[j], nl) == li;
    lev_count[li - 1] = block_sum(c, red);
  }
  if (tid == 0) {
    if (heavy)
      for (int d = 0; d < d_max; ++d) s_aux[d] = (float)pad_key;
    s_aux[d_max] = heavy ? (float)kC : (float)n_tail;
    s_aux[d_max + 1] = (float)(kC - n_tail);
    s_aux[d_max + 2] = heavy ? 1.0f : 0.0f;
    for (int li = 0; li < nl; ++li) s_aux[d_max + 3 + li] = (float)lev_count[li];
  }
  __syncthreads();
  const int w_used = 2 * d_max + 3 + nl;
  if (tid < kAuxW) aux[(long long)row * kAuxW + tid] = tid < w_used ? s_aux[tid] : 0.0f;
}

template <int KID, bool INTEG>
__global__ void __launch_bounds__(kThreads)
coherent_deposit_kernel(const float* __restrict__ packed, int n_fields,
                        const int* __restrict__ cand_row,
                        const int* __restrict__ cstart,
                        const int* __restrict__ cend, float* __restrict__ out,
                        Footprint p, const float* __restrict__ cheb, int n_cheb, int C) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_cheb = smem;          // kMaxCheb
  float* acc = smem + kMaxCheb;  // n_fields * R * kLanes
  const int plane = p.R * kLanes;
  const int n_acc = n_fields * plane;
  // each warp's matching lanes of one 256-lane chunk of its row
  unsigned short* s_list = reinterpret_cast<unsigned short*>(acc + n_acc) + (threadIdx.x >> 5) * kChunkLanes;
  __shared__ int s_next;

  const int t = blockIdx.x / C;
  const int rank = blockIdx.x - t * C;  // the cluster's block rank (1D clusters)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  for (int i = tid; i < n_acc; i += blockDim.x) acc[i] = 0.0f;
  if constexpr (INTEG) {
    for (int i = tid; i < n_cheb; i += blockDim.x) s_cheb[i] = cheb[i];
  }
  if (tid == 0) s_next = 0;
  __syncthreads();
  // keys are integers < 2^24, exact in the f32 key channel
  const float tkey = (float)t;
  const int key_ch = 3 + n_fields;
  const unsigned lt_mask = (1u << lane) - 1u;
  // this rank's candidate rows: every C-th of the tile's, from `rank`; the
  // warps take their (row, 256-lane chunk) items one at a time from a
  // shared counter
  const int c0 = cstart[t];
  constexpr int kChunks = kC / kChunkLanes;
  const int n_items = ast::cluster_groups(cend[t] - c0, 1, rank, C) * kChunks;
  for (;;) {
    int i = 0;
    if (lane == 0) i = atomicAdd(&s_next, 1);
    i = __shfl_sync(0xffffffffu, i, 0);
    if (i >= n_items) break;
    const float* rowp = packed + (long long)cand_row[c0 + rank + (i / kChunks) * C] * 8 * kC;
    const float* keyp = rowp + key_ch * kC;
    {
      const int ch = (i % kChunks) * kChunkLanes;
      // the chunk's lanes whose key is this tile, in lane order
      int cnt = 0;
#pragma unroll
      for (int k = 0; k < kChunkLanes / 32; ++k) {
        const int ln = ch + k * 32 + lane;
        const bool match = keyp[ln] == tkey;
        const unsigned mask = __ballot_sync(0xffffffffu, match);
        if (match) s_list[cnt + __popc(mask & lt_mask)] = (unsigned short)ln;
        cnt += __popc(mask);
      }
      __syncwarp();
      // deposit them 32 at a time, the warp's pairs balanced over its lanes
      for (int g = 0; g < cnt; g += 32) {
        float pu = 0.0f, pv = 0.0f, ph = 0.0f, pval[ast::kMaxFields] = {};
        if (g + lane < cnt) {
          const int ln = s_list[g + lane];
          pu = rowp[ln];
          pv = rowp[kC + ln];
          ph = rowp[2 * kC + ln];
#pragma unroll
          for (int f = 0; f < kMaxFields; ++f)
            if (f < n_fields) pval[f] = rowp[(3 + f) * kC + ln];
        }
        ast::deposit_balanced<KID, INTEG>(acc, plane, n_fields, p, s_cheb, n_cheb, pu, pv, ph, pval, 1);
      }
      __syncwarp();  // s_list is reused by the next chunk
    }
  }
  __syncthreads();
  ast::cluster_reduce_store(acc, n_acc, out + (long long)t * n_acc, C);
}

}  // namespace

extern "C" {

// Row prep of n_rows 2048-lane rows. fparams (host, kPrepFloats floats):
// x0, y0, 1/psx, 1/psy, nx, ny, support_factor, 1/min(pixel size), then
// bound[4], 1/tx[4], 1/TY[4]. iparams (host, kPrepInts ints): periodic,
// n_levels, d_max, then n_tiles_x[4], n_tiles_y[4], tx[4], TY[4], M[4],
// bases[5]. Returns the launch's cudaError_t (cudaSuccess = 0).
int coherent_prep_launch(const float* x, const float* y, const float* h,
                         const float* vals, long long ld_vals, int n_fields,
                         int n_rows, float* packed, float* aux,
                         const float* fparams, const int* iparams,
                         void* stream) {
  if (n_rows <= 0) return cudaSuccess;
  PrepParams P;
  const float* f = fparams;
  P.x0 = f[0]; P.y0 = f[1]; P.inv_psx = f[2]; P.inv_psy = f[3];
  P.nxf = f[4]; P.nyf = f[5]; P.sf = f[6]; P.inv_minps = f[7];
  for (int li = 0; li < kMaxLevels; ++li) {
    P.bound[li] = f[8 + li];
    P.inv_tx[li] = f[8 + kMaxLevels + li];
    P.inv_ty[li] = f[8 + 2 * kMaxLevels + li];
  }
  const int* q = iparams;
  P.periodic = q[0]; P.n_levels = q[1]; P.d_max = q[2];
  for (int li = 0; li < kMaxLevels; ++li) {
    P.ntx[li] = q[3 + li];
    P.nty[li] = q[3 + kMaxLevels + li];
    P.tx[li] = q[3 + 2 * kMaxLevels + li];
    P.ty[li] = q[3 + 3 * kMaxLevels + li];
    P.m[li] = q[3 + 4 * kMaxLevels + li];
  }
  for (int li = 0; li <= kMaxLevels; ++li) P.base[li] = q[3 + 5 * kMaxLevels + li];
  if (n_fields < 1 || n_fields > kMaxFields || P.n_levels < 1 ||
      P.n_levels > kMaxLevels || P.d_max < 1 || P.d_max > kMaxD ||
      2 * P.d_max + 3 + P.n_levels > kAuxW)
    return cudaErrorInvalidValue;
  coherent_prep_kernel<<<n_rows, kThreads, 0, (cudaStream_t)stream>>>(
      x, y, h, vals, ld_vals, n_fields, packed, aux, P);
  return cudaGetLastError();
}

// Coherent deposit of n_tiles level-0 tiles from packed (n_rows, 8, 2048)
// rows over clusters of C blocks a tile; tile t reads candidates
// [cstart[t], cend[t]) of cand_row. Writes out (n_tiles, F*R, 128).
// Returns the cudaError_t of the first failing attribute call or launch.
int coherent_deposit_launch(const float* packed, int n_fields,
                            const int* cand_row, const int* cstart,
                            const int* cend, int n_tiles, float* out, int K,
                            int R, float offset, float psx, float psy,
                            int kernel_id, int integrated, float norm3d,
                            float support_factor, const float* cheb,
                            int n_cheb, int C, void* stream) {
  if (n_tiles <= 0) return cudaSuccess;
  if (n_fields < 1 || n_fields > kMaxFields || n_cheb > kMaxCheb || R <= 0 ||
      K <= 0 || C < 1 || C > 8)
    return cudaErrorInvalidValue;
  int optin = 0;
  cudaError_t err = ast::smem_optin(&optin);
  if (err != cudaSuccess) return err;
  const size_t smem = (kMaxCheb + (size_t)n_fields * R * kLanes) * sizeof(float) +
                      kWarps * kChunkLanes * sizeof(unsigned short);
  if (smem > (size_t)optin) return cudaErrorInvalidConfiguration;
  const Footprint p = ast::make_footprint(K, R, offset, psx, psy, norm3d,
                                          support_factor, integrated);
  cudaStream_t s = (cudaStream_t)stream;
  return ast::dispatch_footprint(kernel_id, integrated, [&](auto kid, auto integ) {
    auto kern = coherent_deposit_kernel<decltype(kid)::value, decltype(integ)::value>;
    cudaError_t e = ast::allow_smem(kern, smem);
    if (e != cudaSuccess) return e;
    return ast::launch_clusters(kern, n_tiles, C, kThreads, smem, s, packed, n_fields,
                                cand_row, cstart, cend, out, p, cheb, n_cheb, C);
  });
}

int coherent_prep_param_counts(int* n_floats, int* n_ints) {
  *n_floats = kPrepFloats;
  *n_ints = kPrepInts;
  return 0;
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
