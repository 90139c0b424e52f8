// Sightline columns and absorption spectra over ray blocks, for Hopper.
//
// Replaces two TPU kernels, on one particle layout and one ray schedule
// (ops/sightlines_fused.py builds both):
//
//   columns_kernel  <- astro_sph_tools_tpu/ops/sightlines_pallas.py::
//                      _columns_kernel. For a block of B = 8 rays, the
//                      per-ray column totals
//                        out[k][r][f] = sum_i w(b2_ri, h_i) * v_f(i)
//                      over the particles i of the block's spans, with
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
// [x, y, h, N, v_eff, b_Doppler] for the spectra. Block k reads its kSpans
// [lo, hi) spans (empty when lo >= hi) and its rays rx/ry[k * B + r].
//
// Design. The TPU walked a flat work-list of (span unit, 1024-particle
// chunk) steps on one core, carrying each block's accumulator across steps
// through a packed schedule word. Here one thread block per ray block walks
// its own spans, so there is no schedule, and blocks run in parallel.
//   * Columns: each thread takes particles in a strided loop and keeps all
//     B * F sums in registers; one warp-shuffle and shared-memory reduction
//     at the end. Particles with h <= 0 are skipped outright (the TPU
//     masked a multiply so that a pad's inf could not leak NaN).
//   * Spectra: a chunk of 256 particles is tested against the 32 rays (one
//     bit per ray); only the particles some ray reaches (the TPU measured
//     0.6 % of pair evaluations inside the support) are compacted into
//     shared memory (ballot + prefix) with their 32 column weights. Each
//     thread owns kBinsPerThread velocity bins: per live particle it
//     evaluates phi once per bin and does 32 FMAs into its tau registers.
//     The TPU's bf16 hi/lo matmul splits are not carried over: the sums are
//     plain f32 FMAs.
//
// Bound on the card. Columns: the pair tests (8 rays x candidate particles)
// and device-memory reads of each span, a few bytes per pair. Spectra: the
// FP32 and special-function pipes of the profile pass (bins x live particles
// x images, plus 32 FMAs per bin); the span scan is a small share. A simple
// first version; a wgmma tile for tau += w @ phi, TMA staging and per-ray
// live lists are later work.

#include "deposit_common.cuh"

namespace {

using ast::kMaxCheb;
using ast::kMaxFields;

constexpr int kSpans = 10;       // [lo, hi) spans per ray block
constexpr int kColRays = 8;      // rays per column block
constexpr int kColThreads = 256;
constexpr int kSpecRays = 32;    // rays per spectra block (one live bit each)
constexpr int kSpecThreads = 256;
constexpr int kBinsPerThread = 2;
constexpr int kBinsPerBlock = kSpecThreads * kBinsPerThread;
constexpr float kInvSqrtPi = 0.56418958354775628f;

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
// ops/spectra.py::voigt_hjerting. corr is the Chebyshev fit for x <= 7 and
// the asymptotic series in 1/x^2 beyond.
__device__ __forceinline__ float voigt_hjerting(float a, float z) {
  const float x = fabsf(z);
  const float x2 = x * x;
  float corr;
  if (x <= 7.0f) {
    const float u = x * (1.0f / 3.5f) - 1.0f;
    const float u2 = 2.0f * u;
    float b1 = 0.0f, b2 = 0.0f;
#pragma unroll
    for (int k = 30; k > 0; --k) {
      const float t = u2 * b1 - b2 + kVoigtCheb[k];
      b2 = b1;
      b1 = t;
    }
    corr = u * b1 - b2 + kVoigtCheb[0];
  } else {
    const float t = 1.0f / x2;
    corr = -t * (1.0f + t * (1.5f + t * (3.75f + t * (13.125f + t * (59.0625f + t * 324.84375f)))));
  }
  const float h0 = expf(-x2);
  return h0 * (1.0f + a * a * (1.0f - 2.0f * x2)) - a * kInvSqrtPi * corr;
}

// Line profile with unit velocity integral at velocity offset dv:
// ops/spectra.py::_profile_sum over images -n_images .. n_images.
template <bool VOIGT>
__device__ __forceinline__ float line_profile(float dv, float inv_b, float a, int wrap,
                                              float v_box, int n_images) {
  if (wrap) dv = dv - rintf(dv / v_box) * v_box;
  float phi = 0.0f;
  for (int k = -n_images; k <= n_images; ++k) {
    const float z = (dv + (float)k * v_box) * inv_b;
    if constexpr (VOIGT) {
      phi += voigt_hjerting(a, z);
    } else {
      phi += expf(-(z * z));
    }
  }
  return phi * (kInvSqrtPi * inv_b);
}

// ---------------------------------------------------------------------------
// TPU kernel #4: column totals
// ---------------------------------------------------------------------------

template <int KID, bool INTEG, int F>
__global__ void __launch_bounds__(kColThreads)
columns_kernel(const float* __restrict__ packed, long long stride,
               const float* __restrict__ rx, const float* __restrict__ ry,
               const int* __restrict__ lo, const int* __restrict__ hi,
               float* __restrict__ out, int periodic, float Lx, float Ly,
               float invLx, float invLy, float norm3d, float S, float inv_sf,
               const float* __restrict__ cheb, int n_cheb) {
  __shared__ float s_cheb[kMaxCheb];
  __shared__ float s_part[kColThreads / 32][kColRays * F];
  const int blk = blockIdx.x;
  if constexpr (INTEG) {
    for (int k = threadIdx.x; k < n_cheb; k += blockDim.x) s_cheb[k] = cheb[k];
  }
  float rxr[kColRays], ryr[kColRays];
#pragma unroll
  for (int r = 0; r < kColRays; ++r) {
    rxr[r] = rx[blk * kColRays + r];
    ryr[r] = ry[blk * kColRays + r];
  }
  __syncthreads();

  const float* px = packed;
  const float* py = packed + stride;
  const float* ph = packed + 2 * stride;
  const float* pv = packed + 3 * stride;
  float acc[kColRays * F];
#pragma unroll
  for (int j = 0; j < kColRays * F; ++j) acc[j] = 0.0f;

  for (int u = 0; u < kSpans; ++u) {
    const int a = lo[blk * kSpans + u];
    const int b = hi[blk * kSpans + u];
    for (int i = a + threadIdx.x; i < b; i += blockDim.x) {
      const float hs = ph[i];
      if (!(hs > 0.0f)) continue;  // zero-h particles contribute nothing
      const float xs = px[i], ys = py[i];
      const float inv_h = 1.0f / hs;
      float v[F];
#pragma unroll
      for (int f = 0; f < F; ++f) v[f] = pv[f * stride + i];
#pragma unroll
      for (int r = 0; r < kColRays; ++r) {
        float dx = rxr[r] - xs, dy = ryr[r] - ys;
        if (periodic) {
          dx = min_image(dx, Lx, invLx);
          dy = min_image(dy, Ly, invLy);
        }
        const float b2 = dx * dx + dy * dy;
        float w;
        if constexpr (INTEG) {
          const float inv_sh = inv_h * inv_sf;
          const float tq = b2 * (inv_sh * inv_sh);
          if (!(tq < 1.0f)) continue;
          w = ast::clenshaw(2.0f * fminf(fmaxf(tq, 0.0f), 1.0f) - 1.0f, s_cheb, n_cheb) *
              (inv_h * inv_h);
        } else {
          const float qn = sqrtf(b2) * inv_h;
          if (!(qn < S)) continue;
          w = ast::shape_q<KID>(qn) * ((norm3d * inv_h) * (inv_h * inv_h));
        }
#pragma unroll
        for (int f = 0; f < F; ++f) acc[r * F + f] += w * v[f];
      }
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kColRays * F; ++j) {
    float s = acc[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) s_part[warp][j] = s;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kColRays * F; j += blockDim.x) {
    float s = 0.0f;
    for (int w = 0; w < kColThreads / 32; ++w) s += s_part[w][j];
    out[(long long)blk * kColRays * F + j] = s;
  }
}

// ---------------------------------------------------------------------------
// TPU kernel #5: velocity-space optical depth
// ---------------------------------------------------------------------------

template <bool VOIGT>
__global__ void __launch_bounds__(kSpecThreads)
spectra_kernel(const float* __restrict__ packed, long long stride,
               const float* __restrict__ rx, const float* __restrict__ ry,
               const int* __restrict__ lo, const int* __restrict__ hi,
               const float* __restrict__ v_centres, int n_bins,
               float* __restrict__ out, int periodic, float Lx, float Ly,
               float invLx, float invLy, float inv_sf,
               const float* __restrict__ cheb, int n_cheb, int wrap, float v_box,
               int n_images, float voigt_k) {
  __shared__ float s_cheb[kMaxCheb];
  __shared__ float s_rx[kSpecRays], s_ry[kSpecRays];
  __shared__ float s_w[kSpecThreads][kSpecRays + 1];  // live particles' column weights
  __shared__ float s_v[kSpecThreads], s_ib[kSpecThreads];
  __shared__ int s_count[kSpecThreads / 32];
  const int blk = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int k = t; k < n_cheb; k += blockDim.x) s_cheb[k] = cheb[k];
  if (t < kSpecRays) {
    s_rx[t] = rx[blk * kSpecRays + t];
    s_ry[t] = ry[blk * kSpecRays + t];
  }
  float vc[kBinsPerThread];
#pragma unroll
  for (int k = 0; k < kBinsPerThread; ++k) {
    const int j = blockIdx.y * kBinsPerBlock + k * kSpecThreads + t;
    vc[k] = j < n_bins ? v_centres[j] : 0.0f;
  }
  float acc[kSpecRays][kBinsPerThread];
#pragma unroll
  for (int r = 0; r < kSpecRays; ++r)
#pragma unroll
    for (int k = 0; k < kBinsPerThread; ++k) acc[r][k] = 0.0f;
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
      // 2. compact the live particles into shared memory
      const unsigned ballot = __ballot_sync(0xffffffffu, mask != 0u);
      if (lane == 0) s_count[warp] = __popc(ballot);
      __syncthreads();
      int slot = 0, n_live = 0;
#pragma unroll
      for (int w = 0; w < kSpecThreads / 32; ++w) {
        const int c = s_count[w];
        slot += w < warp ? c : 0;
        n_live += c;
      }
      if (mask) {
        slot += __popc(ballot & ((1u << lane) - 1u));
        const float inv_sh = inv_h * inv_sf;
        const float q = inv_sh * inv_sh;
        const float N = pN[i];
        for (int r = 0; r < kSpecRays; ++r) {
          float w = 0.0f;
          if ((mask >> r) & 1u) {
            float dx = s_rx[r] - xs, dy = s_ry[r] - ys;
            if (periodic) {
              dx = min_image(dx, Lx, invLx);
              dy = min_image(dy, Ly, invLy);
            }
            const float tq = (dx * dx + dy * dy) * q;
            w = ast::clenshaw(2.0f * fminf(fmaxf(tq, 0.0f), 1.0f) - 1.0f, s_cheb, n_cheb) *
                (inv_h * inv_h) * N;
          }
          s_w[slot][r] = w;
        }
        s_v[slot] = pv[i];
        s_ib[slot] = 1.0f / pb[i];
      }
      __syncthreads();
      // 3. tau[r][bin] += w[p][r] * phi_p(bin) over the live particles
      for (int p = 0; p < n_live; ++p) {
        const float v = s_v[p], ib = s_ib[p];
        const float a_damp = voigt_k * ib;
        float phi[kBinsPerThread];
#pragma unroll
        for (int k = 0; k < kBinsPerThread; ++k)
          phi[k] = line_profile<VOIGT>(vc[k] - v, ib, a_damp, wrap, v_box, n_images);
#pragma unroll
        for (int r = 0; r < kSpecRays; ++r) {
          const float w = s_w[p][r];
#pragma unroll
          for (int k = 0; k < kBinsPerThread; ++k) acc[r][k] += w * phi[k];
        }
      }
      __syncthreads();  // the next chunk overwrites s_w and s_count
    }
  }

#pragma unroll
  for (int k = 0; k < kBinsPerThread; ++k) {
    const int j = blockIdx.y * kBinsPerBlock + k * kSpecThreads + t;
    if (j >= n_bins) continue;
#pragma unroll
    for (int r = 0; r < kSpecRays; ++r)
      out[((long long)blk * kSpecRays + r) * n_bins + j] = acc[r][k];
  }
}

}  // namespace

extern "C" {

// Column totals of n_blocks ray blocks into out (n_blocks, 8, n_fields).
// Returns the cudaError_t of the launch (cudaSuccess = 0); the launch is
// asynchronous on `stream` and is not synchronised here.
int sightline_columns_launch(const float* packed, long long stride, int n_fields,
                             const float* rx, const float* ry, const int* lo,
                             const int* hi, int n_blocks, float* out, int periodic,
                             float Lx, float Ly, int kernel_id, int integrated,
                             float norm3d, float support_factor, const float* cheb,
                             int n_cheb, void* stream) {
  if (n_blocks <= 0) return cudaSuccess;
  if (n_fields < 1 || n_fields > kMaxFields || n_cheb > kMaxCheb) return cudaErrorInvalidValue;
  const float invLx = (float)(1.0 / (double)Lx), invLy = (float)(1.0 / (double)Ly);
  const float inv_sf = (float)(1.0 / (double)support_factor);
  cudaStream_t s = (cudaStream_t)stream;
  return ast::dispatch_footprint(kernel_id, integrated, [&](auto kid, auto integ) {
    constexpr int KID = decltype(kid)::value;
    constexpr bool INTEG = decltype(integ)::value;
    auto run = [&](auto kern) {
      kern<<<n_blocks, kColThreads, 0, s>>>(packed, stride, rx, ry, lo, hi, out, periodic, Lx,
                                            Ly, invLx, invLy, norm3d, support_factor, inv_sf,
                                            cheb, n_cheb);
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
}

// Optical depth of n_blocks ray blocks into out (n_blocks, 32, n_bins).
// wrap != 0: velocities wrap over v_box and the profile sums images
// -n_images .. n_images. voigt != 0: Voigt-Hjerting profile with
// a = voigt_k / b per particle, else Gaussian.
int sightline_spectra_launch(const float* packed, long long stride, const float* rx,
                             const float* ry, const int* lo, const int* hi, int n_blocks,
                             const float* v_centres, int n_bins, float* out, int periodic,
                             float Lx, float Ly, float support_factor, const float* cheb,
                             int n_cheb, int wrap, float v_box, int n_images, int voigt,
                             float voigt_k, void* stream) {
  if (n_blocks <= 0 || n_bins <= 0) return cudaSuccess;
  if (n_cheb > kMaxCheb || n_images < 0 || (wrap && !(v_box > 0.0f))) return cudaErrorInvalidValue;
  const float invLx = (float)(1.0 / (double)Lx), invLy = (float)(1.0 / (double)Ly);
  const float inv_sf = (float)(1.0 / (double)support_factor);
  const dim3 grid(n_blocks, (n_bins + kBinsPerBlock - 1) / kBinsPerBlock);
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  auto run = [&](auto kern) {
    kern<<<grid, kSpecThreads, 0, s>>>(packed, stride, rx, ry, lo, hi, v_centres, n_bins, out,
                                       periodic, Lx, Ly, invLx, invLy, inv_sf, cheb, n_cheb,
                                       wrap, v_box, n_images, voigt_k);
    return cudaGetLastError();
  };
  return voigt ? run(spectra_kernel<true>) : run(spectra_kernel<false>);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
