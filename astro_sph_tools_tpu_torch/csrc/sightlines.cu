// Sightline columns and absorption spectra, for Hopper.
//
// Replaces two TPU kernels, on one particle layout (ops/sightlines_fused.py
// builds it):
//
//   columns_kernel  <- astro_sph_tools_tpu/ops/sightlines_pallas.py::
//                      _columns_kernel. Per ray r, the column totals
//                        out[f][r] = sum_i w(b2_ri, h_i) * v_f(i)
//                      over every level's particles i of the ray's 1-ring
//                      cells, with
//                        integrated: w = clenshaw(2 clip(tq, 0, 1) - 1) / h^2,
//                                    tq = b2 / (S h)^2 < 1
//                        kernel3d:   w = shape_q(b / h) * norm_3d / h^3, b < S h
//                      and b2 the periodic minimum-image squared impact
//                      parameter.
//   spectra_kernel  <- astro_sph_tools_tpu/ops/spectra_pallas.py::
//                      _spectra_kernel. For a block of B = 32 rays, the
//                      velocity-space optical depth
//                        out[k][r][j] = sum_i w_ri * N_i * phi(vc_j - v_i; b_i)
//                      with the integrated column weight w_ri above and phi a
//                      Gaussian or Voigt-Hjerting profile, summed over the
//                      periodic velocity images -n .. n.
//
// The particles are the (level, cell)-sorted channel rows of `packed`
// (row c at packed + c * stride): [x, y, h, v_0 .. v_4] for the columns,
// [x, y, h, N, v_eff, b_Doppler] for the spectra. Spectra block k reads its
// kSpans [lo, hi) spans (empty when lo >= hi) and its rays rx/ry[k * B + r].
//
// Design. The TPU walked a flat work-list of (span unit, 1024-particle
// chunk) steps on one core, carrying each block's accumulator across steps
// through a packed schedule word. Here:
//   * Columns: one warp per (level, ray, cell row) item, rays in cell order
//     per level, so that neighbouring warps read the same cells. A ray's
//     candidates at a level are the particles of its 3 x 3 cells; a row's
//     three cells are one contiguous span of the sorted particles (two
//     under a periodic x-wrap), read from the per-cell bounds table
//     (row_spans, mirrored by ops/sightlines_fused.py::ray_spans). A warp
//     loads 4 batches of 32 consecutive candidates at once (x, y, h,
//     coalesced); a lane tests one against the ray, as the plain version
//     does; the hits go to a queue in shared
//     memory, and every 32 queued hits the whole warp computes their
//     weights and reads their values at once, so that the Clenshaw sum
//     does not run for one lane while 31 wait. Particles with h <= 0 are
//     skipped outright (the TPU masked a multiply so that a pad's inf could
//     not leak NaN). Each item writes its F sums (a fixed shuffle tree);
//     a second pass adds each ray's items in (level, row) order and writes
//     the caller's ray order: the same bits every run, no float atomics.
//   * Spectra: a thread block owns one ray block and kSpecThreads velocity
//     bins (more bins: blockIdx.y); warp w the 32 contiguous bins from 32 w,
//     a thread one bin. A chunk of 256 particles is tested against the 32
//     rays (one bit per ray); the live ones (some ray hits them) are
//     compacted into shared memory (ballot + prefix) with their ray mask,
//     the column weights of the rays that hit them, and their line window
//     and velocity wrap (line_window, mirrored step for step by
//     ops/spectra_fused.py::line_windows). Then each warp, on its own, takes
//     the live particles 32 at a time:
//       a. the profile of each particle whose window reaches the warp's
//          bins, at each thread's bin, into the thread's own column of
//          shared memory (s_phi[particle][thread]: no barrier, no bank
//          conflict);
//          - Gaussian: the window holds every bin within 10.2 b of the line,
//            one bin of margin, folded over the periodic bins; a line wider
//            than half the box takes every bin and the images up to
//            (|k| - 1/2) v_box < 10.2 b. exp(-z^2) is exactly 0 in f32
//            outside it, so a warp skips a particle whose window misses its
//            bins, and a thread a bin outside it;
//          - Voigt: every bin and image, each term by its branch: the
//            Chebyshev core of corr(x) only where |x| <= 7, the series in
//            1/x^2 beyond, exp(-x^2) only where x^2 < 104; a line whose
//            every image but the principal one lies beyond |z| = 10.5 (all
//            but the widest) takes those images in one branch-free loop of
//            the series alone; contiguous bins put whole warps on one
//            branch of the principal image;
//          - the wrap of vc_j - v to the principal zone is taken once per
//            particle: the bin at which it steps by v_box, and two shifts;
//       b. tau[r][j] += w_r * phi(j) only for the rays r that hit the
//          particle: for each ray (an unrolled loop, so tau stays in
//          registers), the batch's particles it hits (a ballot of their mask
//          bits: the mask matrix transposed), in order.
//     Each bin's sum is taken in one thread in a fixed order: the same bits
//     every run and in any block order, no atomics. Thread blocks take
//     the ray blocks in the order the wrapper gives
//     (ops/spectra_fused.py::heaviest_first), so that no heavy block starts
//     last; each writes its own block's rows. The TPU's bf16 hi/lo matmul
//     splits are not carried over: the sums are plain f32 FMAs. The Voigt
//     wing's 1/x^2 is the hardware reciprocal (within an ulp of the plain
//     version's division).
//
// Bound on the card. Columns: device-memory reads of the particle
// channels (each particle is a candidate of the few rays whose 1-ring holds
// its cell, so reads repeat from L2) and the pair tests. Spectra: the FP32 pipe of the profile pass, (ray block, live
// particle) pairs x terms (a particle that rays of several blocks hit is
// evaluated once per block: 1.8 times at config 4), then the scan and the
// FMAs of the hits.

#include "deposit_common.cuh"

namespace {

using ast::kMaxCheb;
using ast::kMaxFields;

constexpr int kSpans = 10;       // [lo, hi) spans per spectra ray block
constexpr int kSpecRays = 32;    // rays per spectra block (one live bit each)
constexpr int kSpecThreads = 256;
constexpr int kSpecWarps = kSpecThreads / 32;
constexpr int kMaxImages = 3;    // velocity images a side (ops/spectra_fused.py::_MAX_IMAGES)
constexpr float kInvSqrtPi = 0.56418958354775628f;
// A Gaussian window's half-width in b (ops/spectra_fused.py::_GAUSS_Z_WIN):
// exp(-z^2) rounds to 0 in f32 once z^2 > 103.98.
constexpr float kGaussZWin = 10.2f;
constexpr float kExpX2 = 104.0f;    // expf(-x2) == 0 for x2 >= kExpX2
constexpr float kVoigtCoreX2 = 49.0f;  // the Chebyshev core: x^2 <= 49, |x| <= 7
constexpr float kVoigtFarZ = 10.5f;    // an image beyond this |z| everywhere: series alone

// Chebyshev fit of corr(x) = 2 - 4 x F(x) (F = Dawson's function) on [0, 7]
// in u = x / 3.5 - 1: ops/spectra.py::_VOIGT_CHEB.
__constant__ float kVoigtCheb[31] = {
    2.4881856318770293e-01f, -6.0099312693192697e-01f, 6.4361396302280671e-01f,
    -5.1737510766123362e-01f, 2.7006888736076384e-01f, -2.6368566685981337e-02f,
    -1.1440794112897615e-01f, 1.3403557615997266e-01f, -8.1168647269143177e-02f,
    1.9254729968325685e-02f, 1.5083805306240839e-02f, -1.9727259945187089e-02f,
    1.0291579640219038e-02f, -1.1424355634791525e-03f, -2.4686477108562285e-03f,
    2.0475510075201524e-03f, -6.2666180702336701e-04f, -1.7901753143482690e-04f,
    2.7790611865101666e-04f, -1.1578103569858545e-04f, -4.5046318466839111e-06f,
    3.0438481530514348e-05f, -1.4871741069277782e-05f, 6.4132269964071750e-07f,
    2.9411844272740243e-06f, -1.5233384164772555e-06f, 9.4266957856181097e-08f,
    2.6613322244869490e-07f, -1.3128921523181491e-07f, 9.9593625077359186e-09f,
    2.2027981792878860e-08f,
};

// Periodic minimum image, as the TPU kernels: d - round(d / L) * L with the
// division taken as a multiply by the f32 reciprocal.
__device__ __forceinline__ float min_image(float d, float L, float invL) {
  return d - rintf(d * invL) * L;
}

// H(a, x) = exp(-x^2) (1 + a^2 (1 - 2x^2)) - a / sqrt(pi) * corr(x):
// ops/spectra.py::voigt_hjerting. corr is the Chebyshev fit for |x| <= 7 and
// the asymptotic series in 1/x^2 beyond; the spectra kernel sums the two
// parts of H over images apart and combines them once a bin.
__device__ __forceinline__ float voigt_corr_core(float x) {
  const float u = x * (1.0f / 3.5f) - 1.0f;
  const float u2 = 2.0f * u;
  float b1 = 0.0f, b2 = 0.0f;
#pragma unroll
  for (int k = 30; k > 0; --k) {
    const float t = u2 * b1 - b2 + kVoigtCheb[k];
    b2 = b1;
    b1 = t;
  }
  return u * b1 - b2 + kVoigtCheb[0];
}

__device__ __forceinline__ float voigt_corr_series(float x2) {
  float t;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(t) : "f"(x2));
  float s = fmaf(t, 324.84375f, 59.0625f);
  s = fmaf(t, s, 13.125f);
  s = fmaf(t, s, 3.75f);
  s = fmaf(t, s, 1.5f);
  s = fmaf(t, s, 1.0f);
  return -t * s;
}

// One Voigt term at z = dv / b, by branch: g += the exp(-x^2) part (only
// where it is not 0), c += corr(x).
__device__ __forceinline__ void voigt_term(float z, float a2, float& g, float& c) {
  const float x2 = z * z;
  if (x2 <= kVoigtCoreX2) {
    c += voigt_corr_core(fabsf(z));
  } else {
    c += voigt_corr_series(x2);
  }
  if (x2 < kExpX2) g += expf(-x2) * fmaf(a2, fmaf(-2.0f, x2, 1.0f), 1.0f);
}

// ---------------------------------------------------------------------------
// TPU kernel #4: column totals
// ---------------------------------------------------------------------------

constexpr int kColRows = 3;       // cell rows of a ray's 1-ring: items per (ray, level)
constexpr int kColWarps = 4;      // items per thread block, a warp each
constexpr int kColThreads = 32 * kColWarps;
constexpr int kMaxColLevels = 6;  // ops/sightlines_fused.py::_MAX_LEVELS
constexpr int kHitQueue = 64;     // a warp's queue of hits: two batches of 32
constexpr int kColBatches = 4;    // batches of 32 candidates whose loads a warp issues at once

struct ColGrids {
  int n;  // levels
  int ncx[kMaxColLevels], ncy[kMaxColLevels], off[kMaxColLevels];
};

// The candidate spans [lo, hi) of cell row `row` (0..2) of the 1-ring of
// cell `cell` under an ncx x ncy grid whose bounds start at bounds + off:
// span 0 the row's ring cells, span 1 the cell an x-wrap takes to the row's
// other end (periodic). ops/sightlines_fused.py::ray_spans, step for step;
// a cell outside the grid has no candidates, and the bounds read are
// clamped to the n particles.
__device__ __forceinline__ void row_spans(const int* __restrict__ bounds, int off, int ncx, int ncy,
                                          int cell, int row, int periodic, int n,
                                          int lo[2], int hi[2]) {
  lo[0] = hi[0] = lo[1] = hi[1] = 0;
  if (cell < 0 || cell >= ncx * ncy) return;
  const int cx = cell % ncx, cy = cell / ncx;
  int wr = cy - 1 + row;
  if (periodic) {
    if (row >= min(kColRows, ncy)) return;
    wr = (wr + ncy) % ncy;
  } else if (wr < 0 || wr >= ncy) {
    return;
  }
  const int* b = bounds + off + wr * ncx;
  int a, e;
  if (periodic && ncx <= kColRows) {
    a = 0;
    e = ncx - 1;
  } else if (periodic) {
    a = cx - 1;
    e = cx + 1;
    if (a < 0) {
      lo[1] = b[ncx - 1];
      hi[1] = b[ncx];
    } else if (e >= ncx) {
      lo[1] = b[0];
      hi[1] = b[1];
    }
    a = max(a, 0);
    e = min(e, ncx - 1);
  } else {
    a = max(cx - 1, 0);
    e = min(cx + 1, ncx - 1);
  }
  lo[0] = b[a];
  hi[0] = b[e + 1];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    lo[s] = min(max(lo[s], 0), n);
    hi[s] = min(max(hi[s], lo[s]), n);
  }
}

template <int KID, bool INTEG>
__device__ __forceinline__ float column_weight(float b2, float inv_h, float norm3d, float inv_sf,
                                               const float* s_cheb, int n_cheb) {
  if constexpr (INTEG) {
    const float inv_sh = inv_h * inv_sf;
    const float tq = b2 * (inv_sh * inv_sh);
    return ast::clenshaw(2.0f * fminf(fmaxf(tq, 0.0f), 1.0f) - 1.0f, s_cheb, n_cheb) * (inv_h * inv_h);
  } else {
    return ast::shape_q<KID>(sqrtf(b2) * inv_h) * ((norm3d * inv_h) * (inv_h * inv_h));
  }
}

// Item (l, k, row), l-major: level l's k-th ray in cell order (rays[0][l][k]
// its caller index, rays[1][l][k] its cell), cell row `row` of its 1-ring.
// Writes part[ray][l * 3 + row][f].
template <int KID, bool INTEG, int F>
__global__ void __launch_bounds__(kColThreads)
columns_kernel(const float* __restrict__ packed, long long stride, int n,
               const int* __restrict__ bounds, const float* __restrict__ rx,
               const float* __restrict__ ry, const int* __restrict__ rays, int n_rays,
               ColGrids g, float* __restrict__ part, int periodic, float Lx, float Ly,
               float invLx, float invLy, float norm3d, float S, float inv_sf,
               const float* __restrict__ cheb, int n_cheb) {
  __shared__ float s_cheb[kMaxCheb];
  __shared__ float s_b2[kColWarps][kHitQueue], s_ih[kColWarps][kHitQueue];
  __shared__ int s_idx[kColWarps][kHitQueue];
  if constexpr (INTEG) {
    for (int k = threadIdx.x; k < n_cheb; k += blockDim.x) s_cheb[k] = cheb[k];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long per_level = (long long)n_rays * kColRows;
  const long long item = (long long)blockIdx.x * kColWarps + warp;
  if (item >= per_level * g.n) return;
  const int l = (int)(item / per_level);
  const long long rest = item - l * per_level;
  const int k = (int)(rest / kColRows);
  const int row = (int)(rest - (long long)k * kColRows);
  const int ray = rays[(long long)l * n_rays + k];
  if (ray < 0 || ray >= n_rays) return;
  int lo[2], hi[2];
  row_spans(bounds, g.off[l], g.ncx[l], g.ncy[l], rays[((long long)g.n + l) * n_rays + k], row,
            periodic, n, lo, hi);

  const float* px = packed;
  const float* py = packed + stride;
  const float* ph = packed + 2 * stride;
  const float* pv = packed + 3 * stride;
  const float rxr = rx[ray], ryr = ry[ray];
  float* q_b2 = s_b2[warp];
  float* q_ih = s_ih[warp];
  int* q_idx = s_idx[warp];
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
  // lane takes queued hit q: its weight and values
  auto take = [&](unsigned q) {
    q &= kHitQueue - 1;
    const int i = q_idx[q];
    const float w = column_weight<KID, INTEG>(q_b2[q], q_ih[q], norm3d, inv_sf, s_cheb, n_cheb);
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] += w * pv[f * stride + i];
  };
  unsigned queued = 0, done = 0;  // hits queued and taken by the warp so far
  const unsigned lt_mask = (1u << lane) - 1u;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    for (int base = lo[s]; base < hi[s]; base += 32 * kColBatches) {
      // the loads of kColBatches batches of 32 particles in flight at once
      float xs[kColBatches], ys[kColBatches], hs[kColBatches];
#pragma unroll
      for (int u = 0; u < kColBatches; ++u) {
        const int i = base + 32 * u + lane;
        const bool in = i < hi[s];
        hs[u] = in ? ph[i] : 0.0f;
        xs[u] = in ? px[i] : 0.0f;
        ys[u] = in ? py[i] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kColBatches; ++u) {
        bool hit = false;
        float b2 = 0.0f, inv_h = 0.0f;
        if (hs[u] > 0.0f) {  // zero-h particles (and lanes past the span) contribute nothing
          float dx = rxr - xs[u], dy = ryr - ys[u];
          if (periodic) {
            dx = min_image(dx, Lx, invLx);
            dy = min_image(dy, Ly, invLy);
          }
          b2 = dx * dx + dy * dy;
          inv_h = 1.0f / hs[u];
          if constexpr (INTEG) {
            const float inv_sh = inv_h * inv_sf;
            hit = b2 * (inv_sh * inv_sh) < 1.0f;
          } else {
            hit = sqrtf(b2) * inv_h < S;
          }
        }
        const unsigned mask = __ballot_sync(0xffffffffu, hit);
        if (hit) {
          const unsigned q = (queued + __popc(mask & lt_mask)) & (kHitQueue - 1);
          q_b2[q] = b2;
          q_ih[q] = inv_h;
          q_idx[q] = base + 32 * u + lane;
        }
        queued += __popc(mask);
        if (queued - done >= 32) {
          __syncwarp();
          take(done + lane);
          done += 32;
          __syncwarp();  // the next hits may reuse these slots
        }
      }
    }
  }
  __syncwarp();
  if (lane < (int)(queued - done)) take(done + lane);
#pragma unroll
  for (int f = 0; f < F; ++f) {
    float v = acc[f];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    acc[f] = v;
  }
  if (lane == 0) {
    float* o = part + (((long long)ray * g.n + l) * kColRows + row) * F;
#pragma unroll
    for (int f = 0; f < F; ++f) o[f] = acc[f];
  }
}

// out[f][r] = the sum of ray r's item sums part[r][0 .. n_parts)[f], in order.
__global__ void column_sums_kernel(const float* __restrict__ part, int n_rays, int n_parts, int n_fields,
                                   float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_fields * n_rays) return;
  const int f = (int)(t / n_rays);
  const int r = (int)(t - (long long)f * n_rays);
  const float* p = part + (long long)r * n_parts * n_fields + f;
  float s = 0.0f;
  for (int j = 0; j < n_parts; ++j) s += p[j * n_fields];
  out[t] = s;
}

// ---------------------------------------------------------------------------
// TPU kernel #5: velocity-space optical depth
// ---------------------------------------------------------------------------

// The uniform velocity grid: ops/spectra_fused.py::bin_grid (n >= 2 bins).
struct BinGrid {
  int n;
  float nf, vc0, inv_dvb, inv_n;
};

__device__ __forceinline__ BinGrid make_bin_grid(const float* __restrict__ vc, int n) {
  BinGrid g;
  g.n = n;
  g.nf = (float)n;
  g.vc0 = vc[0];
  g.inv_dvb = __fdiv_rn((float)(n - 1), __fsub_rn(vc[n - 1], vc[0]));
  g.inv_n = __fdiv_rn(1.0f, g.nf);
  return g;
}

// A particle's bins and velocity wrap: ops/spectra_fused.py::line_windows,
// step for step (the _rn intrinsics keep nvcc from fusing its roundings).
// Bin j is in the window when (j - first) mod n < len; images -img .. img;
// vc_j - v wraps by shift_lo below bin jw and by shift_hi from it on.
struct LineWindow {
  int first, len, img, jw;
  float shift_lo, shift_hi;
};

template <bool VOIGT>
__device__ __forceinline__ LineWindow line_window(float v, float b, const BinGrid& g, int wrap,
                                                  float v_box, int n_images) {
  LineWindow w;
  const float u = __fmul_rn(__fsub_rn(v, g.vc0), g.inv_dvb);
  const float half = __fmul_rn(__fmul_rn(b, kGaussZWin), g.inv_dvb);
  w.jw = g.n;
  w.shift_lo = w.shift_hi = 0.0f;
  if (wrap) {
    const float m0 = rintf(-__fmul_rn(u, g.inv_n));
    const float jw = ceilf(__fadd_rn(u, __fmul_rn(__fadd_rn(m0, 0.5f), g.nf)));
    w.jw = (int)fminf(fmaxf(jw, 0.0f), g.nf);
    w.shift_lo = __fmul_rn(m0, v_box);
    w.shift_hi = __fmul_rn(__fadd_rn(m0, 1.0f), v_box);
  }
  w.first = 0;
  w.len = g.n;
  w.img = wrap ? n_images : 0;
  if (VOIGT) return w;
  if (wrap) {
    if (__fadd_rn(half, 1.5f) < 0.5f * g.nf) {
      float uf = __fsub_rn(u, __fmul_rn(floorf(__fmul_rn(u, g.inv_n)), g.nf));
      uf = fminf(fmaxf(uf, 0.0f), g.nf);
      int first = (int)floorf(__fsub_rn(uf, half)) - 1;
      w.len = (int)floorf(__fadd_rn(uf, half)) + 2 - first;
      w.first = first < 0 ? first + g.n : (first >= g.n ? first - g.n : first);
      w.img = 0;
    } else {
      const float kp = floorf(__fadd_rn(__fmul_rn(__fadd_rn(half, 1.0f), g.inv_n), 0.5f));
      w.img = (int)fminf(kp, (float)n_images);
    }
  } else {
    const float lo = fmaxf(__fsub_rn(u, half), -2.0f);
    const float hi = fminf(__fadd_rn(u, half), g.nf + 2.0f);
    w.first = max((int)floorf(lo) - 1, 0);
    w.len = max(min((int)floorf(hi) + 2, g.n) - w.first, 0);
  }
  return w;
}

// The Voigt-Hjerting profile at one bin, summed over images -NI .. NI
// (kv[i + NI] = i v_box): image 0 by branch (voigt_term); the others the
// same, except that when every bin of an image lies beyond |z| = 10.5
// (0.5 v_box / b >= 10.5 for all of them: the common case) they take the
// series alone, a branch-free loop.
template <int NI>
__device__ __forceinline__ float voigt_profile(float dv, float ib, float a, float v_box,
                                               const float (&kv)[2 * NI + 1]) {
  const float a2 = a * a;
  float g = 0.0f, c = 0.0f;
  voigt_term(dv * ib, a2, g, c);
  if constexpr (NI > 0) {
    const float vb_ib = v_box * ib;
    if (0.5f * vb_ib >= kVoigtFarZ) {
#pragma unroll
      for (int i = 1; i <= NI; ++i) {
        const float zp = (dv + kv[NI + i]) * ib, zm = (dv + kv[NI - i]) * ib;
        c += voigt_corr_series(zp * zp);
        c += voigt_corr_series(zm * zm);
      }
    } else {
#pragma unroll
      for (int i = 1; i <= NI; ++i) {
        const bool far = ((float)i - 0.5f) * vb_ib >= kVoigtFarZ;
#pragma unroll
        for (int s = -1; s <= 1; s += 2) {
          const float z = (dv + kv[NI + s * i]) * ib;
          if (far) {
            c += voigt_corr_series(z * z);
          } else {
            voigt_term(z, a2, g, c);
          }
        }
      }
    }
  }
  return (g - a * kInvSqrtPi * c) * (kInvSqrtPi * ib);
}

// Dynamic shared memory of one spectra block: the live particles' column
// weights (kSpecThreads x (kSpecRays + 1), padded against bank conflicts)
// and each thread's column of profile values for a batch of 32 of them.
constexpr size_t kSpecSmemW = sizeof(float) * kSpecThreads * (kSpecRays + 1);
constexpr size_t kSpecSmem = kSpecSmemW + sizeof(float) * 32 * kSpecThreads;

// NI: velocity images a side (0 without a wrap). Three blocks an SM (as
// the shared memory allows): up to 85 registers, where ptxas alone chose 64
// and spilled for the Voigt.
template <bool VOIGT, int NI>
__global__ void __launch_bounds__(kSpecThreads, 3)
spectra_kernel(const float* __restrict__ packed, long long stride,
               const float* __restrict__ rx, const float* __restrict__ ry,
               const int* __restrict__ lo, const int* __restrict__ hi,
               const int* __restrict__ order, const float* __restrict__ v_centres,
               int n_bins, float* __restrict__ out, int periodic, float Lx, float Ly,
               float invLx, float invLy, float inv_sf,
               const float* __restrict__ cheb, int n_cheb, int wrap, float v_box,
               int n_images, float voigt_k) {
  extern __shared__ float s_dyn[];
  auto s_w = reinterpret_cast<float (*)[kSpecRays + 1]>(s_dyn);  // [slot][ray]
  auto s_phi = reinterpret_cast<float (*)[kSpecThreads]>(s_dyn + kSpecSmemW / sizeof(float));
  __shared__ float s_cheb[kMaxCheb];
  __shared__ float s_rx[kSpecRays], s_ry[kSpecRays];
  __shared__ unsigned s_mask[kSpecThreads];
  __shared__ float s_v[kSpecThreads], s_ib[kSpecThreads];
  __shared__ float s_shlo[kSpecThreads], s_shhi[kSpecThreads];
  __shared__ int s_first[kSpecThreads], s_len[kSpecThreads], s_img[kSpecThreads];
  __shared__ int s_jw[kSpecThreads];
  __shared__ int s_count[kSpecWarps];
  const int blk = order[blockIdx.x];  // the wrapper's launch order
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int k = t; k < n_cheb; k += blockDim.x) s_cheb[k] = cheb[k];
  if (t < kSpecRays) {
    s_rx[t] = rx[blk * kSpecRays + t];
    s_ry[t] = ry[blk * kSpecRays + t];
  }
  const BinGrid grid = make_bin_grid(v_centres, n_bins);
  const int warp_bin0 = blockIdx.y * kSpecThreads + warp * 32;  // the warp's 32 bins
  const int j = warp_bin0 + lane;                                // and this thread's
  const float vcj = j < n_bins ? v_centres[j] : 0.0f;
  float kv[2 * NI + 1];  // image offsets i * v_box
#pragma unroll
  for (int i = -NI; i <= NI; ++i) kv[i + NI] = (float)i * v_box;
  float acc[kSpecRays];
#pragma unroll
  for (int r = 0; r < kSpecRays; ++r) acc[r] = 0.0f;
  __syncthreads();

  const float* px = packed;
  const float* py = packed + stride;
  const float* ph = packed + 2 * stride;
  const float* pN = packed + 3 * stride;
  const float* pv = packed + 4 * stride;
  const float* pb = packed + 5 * stride;

  for (int u = 0; u < kSpans; ++u) {
    const int a = lo[blk * kSpans + u];
    const int b = hi[blk * kSpans + u];
    for (int base = a; base < b; base += kSpecThreads) {
      // 1. which rays reach this thread's particle (one bit per ray)
      const int i = base + t;
      unsigned mask = 0u;
      float xs = 0.0f, ys = 0.0f, inv_h = 0.0f;
      if (i < b) {
        const float hs = ph[i];
        if (hs > 0.0f) {
          xs = px[i];
          ys = py[i];
          inv_h = 1.0f / hs;
          const float inv_sh = inv_h * inv_sf;
          const float q = inv_sh * inv_sh;
#pragma unroll
          for (int r = 0; r < kSpecRays; ++r) {
            float dx = s_rx[r] - xs, dy = s_ry[r] - ys;
            if (periodic) {
              dx = min_image(dx, Lx, invLx);
              dy = min_image(dy, Ly, invLy);
            }
            if ((dx * dx + dy * dy) * q < 1.0f) mask |= 1u << r;
          }
        }
      }
      // 2. compact the live particles into shared memory: mask, the weights
      //    of the rays that hit, line window and wrap
      const unsigned ballot = __ballot_sync(0xffffffffu, mask != 0u);
      if (lane == 0) s_count[warp] = __popc(ballot);
      __syncthreads();
      int slot = 0, n_live = 0;
#pragma unroll
      for (int w = 0; w < kSpecWarps; ++w) {
        const int c = s_count[w];
        slot += w < warp ? c : 0;
        n_live += c;
      }
      if (mask) {
        slot += __popc(ballot & ((1u << lane) - 1u));
        const float inv_sh = inv_h * inv_sf;
        const float q = inv_sh * inv_sh;
        const float N = pN[i];
        for (unsigned mm = mask; mm; mm &= mm - 1u) {
          const int r = __ffs(mm) - 1;
          float dx = s_rx[r] - xs, dy = s_ry[r] - ys;
          if (periodic) {
            dx = min_image(dx, Lx, invLx);
            dy = min_image(dy, Ly, invLy);
          }
          const float tq = (dx * dx + dy * dy) * q;
          s_w[slot][r] = ast::clenshaw(2.0f * fminf(fmaxf(tq, 0.0f), 1.0f) - 1.0f, s_cheb, n_cheb) *
                         (inv_h * inv_h) * N;
        }
        const float v = pv[i], bd = pb[i];
        const LineWindow win = line_window<VOIGT>(v, bd, grid, wrap, v_box, n_images);
        s_mask[slot] = mask;
        s_v[slot] = v;
        s_ib[slot] = 1.0f / bd;
        s_first[slot] = win.first;
        s_len[slot] = win.len;
        s_img[slot] = win.img;
        s_jw[slot] = win.jw;
        s_shlo[slot] = win.shift_lo;
        s_shhi[slot] = win.shift_hi;
      }
      __syncthreads();
      // 3. tau[r][bin] += w[p][r] * phi_p(bin), 32 live particles at a time;
      //    each warp on its own (s_phi's column t is thread t's alone)
      for (int sub = 0; sub < n_live; sub += 32) {
        const int pl = sub + lane;  // lane l holds the batch's particle l
        const bool valid = pl < n_live;
        const unsigned pmask = valid ? s_mask[pl] : 0u;
        bool reach = valid;
        if constexpr (!VOIGT) {  // does its window reach this warp's bins?
          if (valid) {
            int d0 = warp_bin0 - s_first[pl];
            if (d0 < 0) d0 += n_bins;
            const int len = s_len[pl];
            reach = len > 0 && (d0 < len || d0 + 32 > n_bins);
          }
        }
        const unsigned touch = __ballot_sync(0xffffffffu, reach);
        // a. the profile of each particle that reaches the warp, at the bin
        for (unsigned tt = touch; tt; tt &= tt - 1u) {
          const int q = __ffs(tt) - 1;
          const int p = sub + q;
          const float ib = s_ib[p];
          const float dv = (vcj - s_v[p]) - (j >= s_jw[p] ? s_shhi[p] : s_shlo[p]);
          float phi = 0.0f;
          if constexpr (!VOIGT) {
            const int img = s_img[p];
            int d = j - s_first[p];
            if (d < 0) d += n_bins;
            if (d < s_len[p] && j < n_bins) {
              float s = 0.0f;
#pragma unroll
              for (int k = -NI; k <= NI; ++k) {
                if (k < -img || k > img) continue;
                const float z = (dv + kv[k + NI]) * ib;
                s += expf(-(z * z));
              }
              phi = s * (kInvSqrtPi * ib);
            }
          } else {
            if (j < n_bins) phi = voigt_profile<NI>(dv, ib, voigt_k * ib, v_box, kv);
          }
          s_phi[q][t] = phi;
        }
        // b. into tau, only for the rays that hit: per ray, the batch's
        //    particles it hits (the mask matrix transposed by ballots)
#pragma unroll
        for (int r = 0; r < kSpecRays; ++r) {
          for (unsigned hit = __ballot_sync(0xffffffffu, (pmask >> r) & 1u) & touch; hit;
               hit &= hit - 1u) {
            const int q = __ffs(hit) - 1;
            acc[r] = fmaf(s_w[sub + q][r], s_phi[q][t], acc[r]);
          }
        }
      }
      __syncthreads();  // the next chunk overwrites the slots and s_count
    }
  }

  if (j < n_bins) {
#pragma unroll
    for (int r = 0; r < kSpecRays; ++r) out[((long long)blk * kSpecRays + r) * n_bins + j] = acc[r];
  }
}

}  // namespace

extern "C" {

// Column totals of n_rays rays into out (n_fields, n_rays), the caller's
// ray order. packed: n particles' channel rows; bounds: every level's
// per-cell starts; rays (2, n_levels, n_rays): each level's rays in cell
// order and their cells; grids (host, n_levels x 3 ints): ncx, ncy and the
// level's offset into bounds; part: scratch of n_rays * n_levels * 3 *
// n_fields floats. Returns the cudaError_t of the first failing launch
// (cudaSuccess = 0); the launches are asynchronous on `stream` and are not
// synchronised here.
int sightline_columns_launch(const float* packed, long long stride, int n, int n_fields,
                             const int* bounds, const float* rx, const float* ry, const int* rays,
                             int n_rays, const int* grids, int n_levels, float* part, float* out,
                             int periodic, float Lx, float Ly, int kernel_id, int integrated,
                             float norm3d, float support_factor, const float* cheb, int n_cheb,
                             void* stream) {
  if (n_rays <= 0) return cudaSuccess;
  if (n_fields < 1 || n_fields > kMaxFields || n_cheb > kMaxCheb || n_levels < 1 ||
      n_levels > kMaxColLevels || n < 0)
    return cudaErrorInvalidValue;
  ColGrids g;
  g.n = n_levels;
  for (int l = 0; l < kMaxColLevels; ++l) {
    g.ncx[l] = l < n_levels ? grids[3 * l] : 1;
    g.ncy[l] = l < n_levels ? grids[3 * l + 1] : 1;
    g.off[l] = l < n_levels ? grids[3 * l + 2] : 0;
    if (g.ncx[l] < 1 || g.ncy[l] < 1 || g.off[l] < 0) return cudaErrorInvalidValue;
  }
  const long long n_items = (long long)n_rays * n_levels * kColRows;
  const long long n_blocks = (n_items + kColWarps - 1) / kColWarps;
  if (n_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const float invLx = (float)(1.0 / (double)Lx), invLy = (float)(1.0 / (double)Ly);
  const float inv_sf = (float)(1.0 / (double)support_factor);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = ast::dispatch_footprint(kernel_id, integrated, [&](auto kid, auto integ) {
    constexpr int KID = decltype(kid)::value;
    constexpr bool INTEG = decltype(integ)::value;
    auto run = [&](auto kern) {
      kern<<<(unsigned)n_blocks, kColThreads, 0, s>>>(packed, stride, n, bounds, rx, ry, rays, n_rays, g,
                                                      part, periodic, Lx, Ly, invLx, invLy, norm3d,
                                                      support_factor, inv_sf, cheb, n_cheb);
      return cudaGetLastError();
    };
    switch (n_fields) {
      case 1: return run(columns_kernel<KID, INTEG, 1>);
      case 2: return run(columns_kernel<KID, INTEG, 2>);
      case 3: return run(columns_kernel<KID, INTEG, 3>);
      case 4: return run(columns_kernel<KID, INTEG, 4>);
      default: return run(columns_kernel<KID, INTEG, 5>);
    }
  });
  if (err != cudaSuccess) return err;
  const long long n_out = (long long)n_fields * n_rays;
  column_sums_kernel<<<(unsigned)((n_out + 255) / 256), 256, 0, s>>>(part, n_rays, n_levels * kColRows,
                                                                       n_fields, out);
  return cudaGetLastError();
}

// Optical depth of n_blocks ray blocks into out (n_blocks, 32, n_bins), on
// n_bins >= 2 uniformly spaced bin centres (which tile one v_box when
// wrapping). The i-th thread block runs ray block order[i] (a permutation
// of the blocks). wrap != 0: velocities wrap over v_box and the profile sums
// images -n_images .. n_images (at most kMaxImages). voigt != 0:
// Voigt-Hjerting profile with a = voigt_k / b per particle, else Gaussian.
int sightline_spectra_launch(const float* packed, long long stride, const float* rx,
                             const float* ry, const int* lo, const int* hi, const int* order,
                             int n_blocks, const float* v_centres, int n_bins, float* out,
                             int periodic, float Lx, float Ly, float support_factor, const float* cheb,
                             int n_cheb, int wrap, float v_box, int n_images, int voigt,
                             float voigt_k, void* stream) {
  if (n_blocks <= 0 || n_bins <= 0) return cudaSuccess;
  if (n_bins < 2 || n_cheb > kMaxCheb || n_images < 0 ||
      (wrap && (!(v_box > 0.0f) || n_images > kMaxImages)))
    return cudaErrorInvalidValue;
  const float invLx = (float)(1.0 / (double)Lx), invLy = (float)(1.0 / (double)Ly);
  const float inv_sf = (float)(1.0 / (double)support_factor);
  const dim3 grid(n_blocks, (n_bins + kSpecThreads - 1) / kSpecThreads);
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  auto run = [&](auto kern) {
    cudaError_t e = ast::allow_smem(kern, kSpecSmem);
    if (e != cudaSuccess) return e;
    kern<<<grid, kSpecThreads, kSpecSmem, s>>>(packed, stride, rx, ry, lo, hi, order, v_centres,
                                               n_bins, out, periodic, Lx, Ly, invLx, invLy, inv_sf,
                                               cheb, n_cheb, wrap, v_box, n_images, voigt_k);
    return cudaGetLastError();
  };
  switch (wrap ? n_images : 0) {
    case 0: return voigt ? run(spectra_kernel<true, 0>) : run(spectra_kernel<false, 0>);
    case 1: return voigt ? run(spectra_kernel<true, 1>) : run(spectra_kernel<false, 1>);
    case 2: return voigt ? run(spectra_kernel<true, 2>) : run(spectra_kernel<false, 2>);
    default: return voigt ? run(spectra_kernel<true, 3>) : run(spectra_kernel<false, 3>);
  }
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
