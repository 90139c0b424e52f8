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
// support-bounded row/column loop) lives in deposit_common.cuh, shared with
// the coherent engine's deposit kernel (coherent.cu).
//
// Design: one thread block per tile (the TPU's sequential flat work-list of
// (tile, 2048-particle chunk) steps, its packed schedule word and its
// channel-packed DMA blocks have no counterpart: each block reads its own
// tile's range). The block zeroes an accumulator in shared memory, each
// thread takes particles of the tile in a strided loop, evaluates the kernel
// only at the pixels inside the particle's support (the TPU evaluates all
// R x K and sums zeros there; the pixels skipped here hold exact zeros) and
// adds the weighted values with shared-memory float atomics; then the block
// writes the whole accumulator out, zeros included, so the output needs no
// memset. A level whose accumulator exceeds the shared memory a block may
// use (F = 5 at K = 64: 5 * 96 * 128 * 4 B = 240 KiB) runs in passes over
// groups of fields.
//
// Numerics: every precision the TPU engine offered (f32, bf16, bf16x2,
// bf16x3) becomes plain f32 FMA arithmetic here, at least as accurate as
// each limb split. The atomics make the summation order vary between runs;
// each pixel is a sum of same-signed f32 terms for non-negative payloads,
// whose rounding error grows like sqrt(n) * 2^-24 relative to the pixel,
// far inside the 1e-5 * max budget the port is held to.
//
// Bound on the card. Expected: the FP32 pipe for the kernel evaluation at
// K >= 16 (up to (2 s + 1)^2 ~ 10^3 pixels per particle, 45 FMAs each for
// the Clenshaw fit), and device-memory reads of (u, v, h, F values) at
// K = 8, where a sub-pixel particle touches a handful of pixels. Measured
// on an H100 80GB HBM3 at 700 W (chip_smoke.py, 2^18 uniform particles per
// level): at K >= 16 the time grows 3-5x from F = 2 to F = 5 while the
// Clenshaw evaluation adds under 2x, so the shared-memory atomic adds (one
// per pixel per field) bound it there; on the clustered 2^26 main path the
// K = 8 level is bound by load imbalance (its densest tile holds ~11x the
// mean count, and one block serialises it), at ~2 % of the memory roofline.
// The design keeps the accumulator in shared memory (no device-memory
// atomics) and skips the zero pixels; splitting dense tiles over several
// blocks, staging particles through shared memory and reducing the atomics
// per field are later work.

#include "deposit_common.cuh"

namespace {

using ast::Footprint;
using ast::kLanes;
using ast::kMaxCheb;
using ast::kMaxFields;

constexpr int kThreads = 256;

template <int KID, bool INTEG>
__global__ void __launch_bounds__(kThreads)
deposit2d_kernel(const float* __restrict__ u, const float* __restrict__ v,
                 const float* __restrict__ h, const float* __restrict__ vals,
                 long long ld_vals, int n_fields, int f_lo, int f_n,
                 const int* __restrict__ pstart, const int* __restrict__ pcount,
                 float* __restrict__ out, Footprint p,
                 const float* __restrict__ cheb, int n_cheb) {
  extern __shared__ float smem[];
  float* s_cheb = smem;             // kMaxCheb
  float* acc = smem + kMaxCheb;     // f_n * R * kLanes
  const int t = blockIdx.x;
  const int plane = p.R * kLanes;
  const int n_acc = f_n * plane;

  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) acc[i] = 0.0f;
  if constexpr (INTEG) {
    for (int i = threadIdx.x; i < n_cheb; i += blockDim.x) s_cheb[i] = cheb[i];
  }
  __syncthreads();

  const int p0 = pstart[t];
  const int p1 = p0 + pcount[t];
  const float* val0 = vals + (long long)f_lo * ld_vals;
  for (int i = p0 + threadIdx.x; i < p1; i += blockDim.x) {
    ast::deposit_particle<KID, INTEG>(acc, plane, f_n, p, s_cheb, n_cheb, u[i],
                                      v[i], h[i], val0 + i, ld_vals);
  }
  __syncthreads();

  float* dst = out + ((long long)t * n_fields + f_lo) * plane;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) dst[i] = acc[i];
}

}  // namespace

extern "C" {

// Deposit one level's tiles. Returns the cudaError_t of the first failing
// attribute call or launch (cudaSuccess = 0); launches are asynchronous on
// `stream` and are not synchronised here.
int deposit2d_launch(const float* u, const float* v, const float* h,
                     const float* vals, long long ld_vals, int n_fields,
                     const int* pstart, const int* pcount, int n_tiles,
                     float* out, int K, int R, float offset, float psx,
                     float psy, int kernel_id, int integrated, float norm3d,
                     float support_factor, const float* cheb, int n_cheb,
                     void* stream) {
  if (n_tiles <= 0) return cudaSuccess;
  if (n_fields < 1 || n_fields > kMaxFields || n_cheb > kMaxCheb || R <= 0 ||
      K <= 0)
    return cudaErrorInvalidValue;
  int smem_optin = 0;
  cudaError_t err = ast::smem_optin(&smem_optin);
  if (err != cudaSuccess) return err;
  const size_t plane_bytes = (size_t)R * kLanes * sizeof(float);
  const size_t fixed = kMaxCheb * sizeof(float);
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
      auto kern = deposit2d_kernel<decltype(kid)::value, decltype(integ)::value>;
      cudaError_t e = ast::allow_smem(kern, smem);
      if (e != cudaSuccess) return e;
      kern<<<n_tiles, kThreads, smem, s>>>(u, v, h, vals, ld_vals, n_fields,
                                           f_lo, f_n, pstart, pcount, out, p,
                                           cheb, n_cheb);
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
