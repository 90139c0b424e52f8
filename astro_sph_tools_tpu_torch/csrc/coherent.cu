// The coherent-order engine's two kernels, for Hopper.
//
// 1. coherent_prep_kernel replaces the TPU kernel
//    astro_sph_tools_tpu/ops/coherent_prep_pallas.py::_prep_kernel. One
//    thread block of 256 threads per 2048-lane row:
//    - loads: thread t of warp w owns two runs of 4 lanes, 256 w + 4 t and
//      the 4 lanes 128 after it (ops/coherent_prep.py::prep_lanes), each
//      read as one float4 from x, y, h and every value channel, so that
//      each load instruction of a warp reads 512 contiguous bytes. The
//      wrapper hands the kernel 16-byte aligned inputs.
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
//      warp scan of each thread's tail counts (both runs in one int) and
//      one barrier give every lane its destination, and the channels are
//      written there in a shared-memory image of the packed row (8, C)
//      f32, 64 KiB: [u_loc, v_loc, h, val_0..val_{F-1}, ckey, 0..]. The
//      image, zero channels included, then leaves as one contiguous
//      64-KiB run of `packed` by coalesced 16-byte stores (one
//      cp.async.bulk copy a row measured 4-5 % slower on the main path's
//      rows).
//    - candidates: round d takes the block-wide min of the head keys not
//      yet taken (warp minima by __reduce_min_sync, then one barrier; each
//      round's barrier also carries the K4 flag of the key the round
//      took, and the rounds alternate between two shared buffers, so that
//      no second barrier guards them). The first min and the per-level
//      lane counts ride on the scan's barrier, the first round on the
//      image's. The rounds stop, for the whole block at once, when a
//      round's min is the pad key: every later candidate slot is then the
//      pad key with K4 flag 1 and the row is not heavy, as the plain
//      version writes them. A row with more than d_max distinct head keys
//      is heavy: tail_eff = C and its candidate keys are the pad key.
//    - the aux row (128 floats), one slot a thread: the row's <= d_max
//      smallest distinct head keys, tail_eff, n_l0, heavy, the per-level
//      lane counts of levels 1..n_levels (the last is oversize) and one K4
//      flag per candidate, zeros after.
//    Bound on the card: device-memory traffic (each row reads 3 + F floats
//    and writes 8 + 0.0625 floats per lane). A row takes 2 to d_max + 1
//    barriers (about 45 in the kernel this one replaced); 64 KiB of shared
//    memory a block lets 3 blocks share an SM.
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
//
//    The window branch (WIN = true, coherent_launch with lane0) replaces the
//    TPU kernel's window-step mode (_deposit_kernel_coherent with wb_bits >
//    0: its window words and (1, 8, W) lane blocks). In window mode the row
//    sort leaves each candidate's lanes one contiguous segment, and the
//    layout gives each candidate the W-lane windows (wb0, nw) that cover
//    it; the layout expands the candidates into one window step each
//    (row, first lane) in tile order. The kernel is the whole-row kernel
//    with window steps in place of candidate rows: rank r of a tile's
//    cluster takes every C-th step, a warp one (step, chunk) item at a
//    time, a chunk being min(W, 256) lanes (W = 128: half a whole-row
//    chunk; W = 1024: four), and ballots only those lanes. The K4 class of
//    a window (k4n) changes no value here, as above, and is not read.
//    Bound: as the whole-row kernel, with the key channel of each window
//    step's W lanes in place of each candidate row's 2048.

#include <float.h>
#include <limits.h>

#include "deposit_common.cuh"

namespace {

using ast::Footprint;
using ast::kLanes;
using ast::kMaxCheb;

constexpr int kC = 2048;            // lanes per row
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 4;             // lanes of one float4 load (prep)
constexpr int kRunGap = 32 * kRun;  // a thread's second run starts 128 lanes after its first
constexpr int kPer = 2 * kRun;      // lanes per thread (prep)
constexpr int kMaxLevels = 4;
constexpr int kAuxW = 128;
constexpr int kMaxFields = 4;       // the key channel takes the 8th slot
constexpr int kMaxD = 60;           // 2 * d_max + 3 + n_levels <= kAuxW
constexpr int kChunkLanes = 256;    // lanes of a row a warp stages at once (deposit)
constexpr unsigned kImgBytes = 8 * kC * sizeof(float);  // one packed row, 64 KiB

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

__device__ __forceinline__ float f4_at(const float4& v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__global__ void __launch_bounds__(kThreads)
coherent_prep_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     const float* __restrict__ h, const float* __restrict__ vals,
                     long long ld_vals, int n_fields,
                     float* __restrict__ packed, float* __restrict__ aux,
                     PrepParams P) {
  extern __shared__ float4 s_img4[];  // the packed row (8, kC)
  float* img = reinterpret_cast<float*>(s_img4);
  // per warp: its tail counts (run 0 in the low 16 bits, run 1 in the
  // high), its least head key and its lanes of levels 1..n_levels
  __shared__ int s_scan[kWarps][2 + kMaxLevels];
  // per warp and round: the least head key left, and whether a lane of
  // the key the round took has s_pix > 1 (two buffers, rounds alternate)
  __shared__ int2 s_round[2][kWarps];

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane_id = tid & 31, warp = tid >> 5;
  const long long rbase = (long long)row * kC;
  const int nl = P.n_levels;
  const int tail_base = P.base[1];
  const int pad_key = P.base[nl] + 1;
  const int first = warp * (2 * kRunGap) + lane_id * kRun;  // run g: lanes first + g * kRunGap + [0, 4)

  float4 xv[2], yv[2], hv[2];
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const long long i = rbase + first + g * kRunGap;
    xv[g] = ld4(x + i);
    yv[g] = ld4(y + i);
    hv[g] = ld4(h + i);
  }

  // --- assignment, lane j of the thread = element j % 4 of run j / 4 ---
  float uloc[kPer], vloc[kPer], hh[kPer];
  int key[kPer], mk[kPer];
  unsigned big = 0u;  // bit j: lane j is a head with s_pix > 1 (_K4_MAX_S)
  int tails = 0;      // run 0's tail lanes + (run 1's << 16)
  int lev_cnt[kMaxLevels] = {};
  int mine = INT_MAX;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const float hi = f4_at(hv[j / kRun], j % kRun);
    float u = __fmul_rn(__fsub_rn(f4_at(xv[j / kRun], j % kRun), P.x0), P.inv_psx);
    float v = __fmul_rn(__fsub_rn(f4_at(yv[j / kRun], j % kRun), P.y0), P.inv_psy);
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
    int ck;
    float ul = u, vl = v;
    if (level < nl) {
      int txi = (int)__fmul_rn(u, P.inv_tx[level]);
      int tyi = (int)__fmul_rn(v, P.inv_ty[level]);
      txi = min(max(txi, 0), P.ntx[level] - 1);
      tyi = min(max(tyi, 0), P.nty[level] - 1);
      ul = __fsub_rn(u, (float)(txi * P.tx[level] - P.m[level]));
      vl = __fsub_rn(v, (float)(tyi * P.ty[level] - P.m[level]));
      ck = P.base[level] + tyi * P.ntx[level] + txi;
    } else {
      ck = P.base[nl];
    }
    uloc[j] = ul;
    vloc[j] = vl;
    hh[j] = hi;
    key[j] = ck;
    const bool is_tail = ck >= tail_base;
    if (!is_tail && s_pix > 1.0f) big |= 1u << j;
    tails += (int)is_tail << (16 * (j / kRun));
#pragma unroll
    for (int li = 1; li <= kMaxLevels; ++li) lev_cnt[li - 1] += level == li;
    mk[j] = is_tail ? pad_key : ck;
    mine = min(mine, mk[j]);
  }

  // --- the scan's barrier: tail counts, the first min, level counts ---
  int incl = tails;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane_id >= o) incl += t;
  }
  mine = __reduce_min_sync(0xffffffffu, mine);
#pragma unroll
  for (int li = 0; li < kMaxLevels; ++li) lev_cnt[li] = __reduce_add_sync(0xffffffffu, lev_cnt[li]);
  if (lane_id == 31) s_scan[warp][0] = incl;
  if (lane_id == 0) {
    s_scan[warp][1] = mine;
#pragma unroll
    for (int li = 0; li < kMaxLevels; ++li) s_scan[warp][2 + li] = lev_cnt[li];
  }
  __syncthreads();
  int before = 0, n_tail = 0, m = INT_MAX;  // tails in earlier warps; in the row
  int lev_total[kMaxLevels] = {};
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_scan[w][0];
    const int cw = (c & 0xffff) + (c >> 16);
    if (w < warp) before += cw;
    n_tail += cw;
    m = min(m, s_scan[w][1]);
#pragma unroll
    for (int li = 0; li < kMaxLevels; ++li) lev_total[li] += s_scan[w][2 + li];
  }
  const int excl = incl - tails;  // tails of this warp's earlier threads, both runs
  // tails before each run's first lane
  int tb[2] = {before + (excl & 0xffff), before + (s_scan[warp][0] & 0xffff) + (excl >> 16)};

  // --- the partition, into the row's image ---
  const int key_ch = 3 + n_fields;
  int dest[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int g = j / kRun;
    const bool is_tail = key[j] >= tail_base;
    dest[j] = is_tail ? kC - n_tail + tb[g] : first + g * kRunGap + j % kRun - tb[g];
    tb[g] += is_tail;
    img[dest[j]] = uloc[j];
    img[kC + dest[j]] = vloc[j];
    img[2 * kC + dest[j]] = hh[j];
    img[key_ch * kC + dest[j]] = (float)key[j];  // keys < 2^24: exact
  }
  for (int f = 0; f < n_fields; ++f) {
    const float* vf = vals + f * ld_vals + rbase + first;
    const float4 v0 = ld4(vf), v1 = ld4(vf + kRunGap);
#pragma unroll
    for (int j = 0; j < kPer; ++j) img[(3 + f) * kC + dest[j]] = f4_at(j < kRun ? v0 : v1, j % kRun);
  }
  for (int q = (key_ch + 1) * (kC / 4) + tid; q < 8 * (kC / 4); q += kThreads)
    s_img4[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // --- candidate rounds: round d takes m, the d-th key; its barrier
  //     brings the next min and m's K4 flag. Round 0's barrier also
  //     completes the image, which then leaves for `packed`. ---
  const int d_max = P.d_max;
  const int flag0 = d_max + 3 + nl;
  float slot = 0.0f;  // this thread's aux slot, where a round fills it
  int d = 0;
  for (;;) {
    if (tid == d) slot = (float)m;
    int any_big = 0;
    mine = INT_MAX;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      any_big |= (key[j] == m) & (int)((big >> j) & 1u);
      if (mk[j] == m) mk[j] = pad_key;
      mine = min(mine, mk[j]);
    }
    mine = __reduce_min_sync(0xffffffffu, mine);
    any_big = (int)__reduce_or_sync(0xffffffffu, (unsigned)any_big);
    if (lane_id == 0) s_round[d & 1][warp] = make_int2(mine, any_big);
    __syncthreads();
    if (d == 0) {
      float4* dst = reinterpret_cast<float4*>(packed + rbase * 8);
      for (int q = tid; q < 8 * (kC / 4); q += kThreads) dst[q] = s_img4[q];
    }
    m = INT_MAX;
    any_big = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      m = min(m, s_round[d & 1][w].x);
      any_big |= s_round[d & 1][w].y;
    }
    if (tid == flag0 + d) slot = any_big ? 0.0f : 1.0f;
    ++d;
    if (d == d_max || m == pad_key) break;  // block-uniform
  }
  // d rounds ran; m is the least head key left after them
  const bool heavy = d == d_max && m < tail_base;

  if (tid < kAuxW) {
    float a = 0.0f;
    if (tid < d_max) {
      a = heavy || tid >= d ? (float)pad_key : slot;
    } else if (tid == d_max) {
      a = heavy ? (float)kC : (float)n_tail;
    } else if (tid == d_max + 1) {
      a = (float)(kC - n_tail);
    } else if (tid == d_max + 2) {
      a = heavy ? 1.0f : 0.0f;
    } else if (tid < flag0) {
#pragma unroll
      for (int li = 0; li < kMaxLevels; ++li)
        if (tid - d_max - 3 == li) a = (float)lev_total[li];
    } else if (tid < flag0 + d_max) {
      a = tid - flag0 >= d ? 1.0f : slot;
    }
    aux[(long long)row * kAuxW + tid] = a;
  }
}

// WIN = false: the whole-row kernel. Item i of a rank is chunk i % 8 of
// its candidate i / 8: cand_row holds each candidate's packed row and
// [cstart[t], cend[t]) is tile t's slice of the candidates.
// WIN = true: the window branch. The list is one of window steps (the
// layout expands each candidate into its nw W-lane windows): cand_row holds
// each step's row, lane0 its first lane (wb0 + j) * W, and [cstart[t],
// cend[t]) tile t's slice of the steps. Item i of a rank is chunk i % nch of
// its step i / nch, nch = W / min(W, 256) chunks of min(W, 256) lanes.
template <int KID, bool INTEG, bool WIN>
__global__ void __launch_bounds__(kThreads)
coherent_deposit_kernel(const float* __restrict__ packed, int n_fields,
                        const int* __restrict__ cand_row,
                        const int* __restrict__ lane0,
                        const int* __restrict__ cstart,
                        const int* __restrict__ cend, float* __restrict__ out,
                        Footprint p, const float* __restrict__ cheb, int n_cheb, int C,
                        int window) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_cheb = smem;          // kMaxCheb
  float* acc = smem + kMaxCheb;  // n_fields * R * kLanes
  const int plane = p.R * kLanes;
  const int n_acc = n_fields * plane;
  // each warp's matching lanes of one chunk (<= 256 lanes) of its row
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
  // this rank's candidate rows (window steps): every C-th of the tile's,
  // from `rank`; the warps take their (row, chunk) items one at a time from
  // a shared counter
  const int c0 = cstart[t];
  const int chunk_lanes = WIN ? min(window, kChunkLanes) : kChunkLanes;
  const int n_chunks = WIN ? window / chunk_lanes : kC / kChunkLanes;
  const int n_items = ast::cluster_groups(cend[t] - c0, 1, rank, C) * n_chunks;
  for (;;) {
    int i = 0;
    if (lane == 0) i = atomicAdd(&s_next, 1);
    i = __shfl_sync(0xffffffffu, i, 0);
    if (i >= n_items) break;
    const int c = c0 + rank + (i / n_chunks) * C;
    const float* rowp = packed + (long long)cand_row[c] * 8 * kC;
    const float* keyp = rowp + key_ch * kC;
    {
      const int ch = (WIN ? lane0[c] : 0) + (i % n_chunks) * chunk_lanes;
      // the chunk's lanes whose key is this tile, in lane order
      int cnt = 0;
#pragma unroll
      for (int k = 0; k < kChunkLanes / 32; ++k) {
        if (WIN && k * 32 >= chunk_lanes) break;
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
// bases[5]. x, y, h and vals are 16-byte aligned and ld_vals is a multiple
// of 4. Returns the cudaError_t of the first failing attribute call or
// launch (cudaSuccess = 0).
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
  const uintptr_t align = (uintptr_t)x | (uintptr_t)y | (uintptr_t)h | (uintptr_t)vals;
  if (n_fields < 1 || n_fields > kMaxFields || P.n_levels < 1 ||
      P.n_levels > kMaxLevels || P.d_max < 1 || P.d_max > kMaxD ||
      2 * P.d_max + 3 + P.n_levels > kAuxW || (align & 15u) || (ld_vals & 3))
    return cudaErrorInvalidValue;
  cudaError_t e = ast::allow_smem(coherent_prep_kernel, kImgBytes);
  if (e != cudaSuccess) return e;
  coherent_prep_kernel<<<n_rows, kThreads, kImgBytes, (cudaStream_t)stream>>>(
      x, y, h, vals, ld_vals, n_fields, packed, aux, P);
  return cudaGetLastError();
}

// Kernel #2, both branches, over clusters of C blocks a tile; writes out
// (n_tiles, F*R, 128). Whole rows (lane0 == nullptr, window == 2048): tile
// t reads candidates [cstart[t], cend[t]) of cand_row. The window branch:
// tile t reads window steps [cstart[t], cend[t]) of (cand_row, lane0), each
// `window` lanes (a power of two in [128, 2048)) of row cand_row[j] from
// lane lane0[j]. Returns the cudaError_t of the first failing attribute
// call or launch.
int coherent_launch(const float* packed, int n_fields, const int* cand_row, const int* lane0,
                    const int* cstart, const int* cend, int n_tiles, int window, float* out, int K,
                    int R, float offset, float psx, float psy, int kernel_id, int integrated,
                    float norm3d, float support_factor, const float* cheb, int n_cheb, int C,
                    void* stream) {
  if (n_tiles <= 0) return cudaSuccess;
  const bool win = lane0 != nullptr;
  if (n_fields < 1 || n_fields > kMaxFields || n_cheb > kMaxCheb || R <= 0 ||
      K <= 0 || C < 1 || C > 8 ||
      (win && (window < 128 || window >= kC || (window & (window - 1)))) ||
      (!win && window != kC))
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
    auto run = [&](auto w) {
      auto kern = coherent_deposit_kernel<decltype(kid)::value, decltype(integ)::value, decltype(w)::value>;
      cudaError_t e = ast::allow_smem(kern, smem);
      if (e != cudaSuccess) return e;
      return ast::launch_clusters(kern, n_tiles, C, kThreads, smem, s, packed, n_fields,
                                  cand_row, lane0, cstart, cend, out, p, cheb, n_cheb, C, window);
    };
    return win ? run(std::true_type{}) : run(std::false_type{});
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
