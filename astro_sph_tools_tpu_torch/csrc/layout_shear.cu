// Gang append of the random-order (shear) grouping, for Hopper.
//
// Replaces the TPU kernel astro_sph_tools_tpu/ops/layout_shear.py:198
// (_append_kernel). Contract: records are packed as gangs, a gang being 128
// consecutive records x C f32 channels = a contiguous (C, 128) slab. For
// every sub-run j of the schedule (src_gang, dst_gang, n_gangs),
//     dst[dst_gang + g] = src[src_gang + g]   for g < n_gangs (<= 16).
// The sub-runs tile the destination exactly, in destination order: a run
// of ngang gangs becomes ceil(ngang / 16) sub-runs, the last one short.
//
// Why exact-length sub-runs. On the TPU each sub-run DMA copied a full
// 16-gang slab; the overshoot into the next run's region was harmless only
// because the copies were chained (each waited on the previous one), so a
// later copy overwrote it. CUDA blocks run in no order, so copying the
// overshoot here would race with the next run's own copy and could leave
// foreign gangs in its head. With exact lengths the destinations of the
// blocks are disjoint and the result does not depend on their order; no
// gang past the last run is written.
//
// Design: one thread block per sub-run (at most 16 gangs x C x 512 B = 64
// KiB at C = 8), 16-byte (float4) loads and stores with neighbouring
// threads on neighbouring addresses, 64-bit element offsets (the gang array
// passes 2^31 floats from about 2^28 records). Each block reads its own
// schedule entry; nothing is staged.
//
// Bound on the card: bytes. The source gangs are read once and the
// destination written once, (G_src + n_gang) * C * 512 B over 3.35 TB/s
// (~2 * n_gang * C * 512 B, ~1.6 ms, for the coarse grouping of 2^27
// particles at C = 5), plus 12 B of schedule per sub-run. The runs of one
// band share their boundary gangs, so each such gang is read twice (the
// second time from L2 when the two runs sit close in the schedule); with
// many short runs n_gang outgrows G_src. There is no arithmetic to speak of.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGang = 128;  // records per gang
constexpr int kMaxChannels = 8;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    append_gangs_kernel(const float4* __restrict__ src, float4* __restrict__ dst,
                        const int* __restrict__ sched, int gang_vec) {
  const int* s = sched + 3 * (long long)blockIdx.x;
  const long long s0 = (long long)s[0] * gang_vec;
  const long long d0 = (long long)s[1] * gang_vec;
  const int n = s[2] * gang_vec;  // <= 16 * 8 * 32 float4s
  for (int i = threadIdx.x; i < n; i += kThreads) dst[d0 + i] = __ldg(src + s0 + i);
}

}  // namespace

extern "C" {

// Copy the n_sub scheduled sub-runs of (G, channels, 128) f32 gangs from
// `src` into `dst`. `sched` is (n_sub, 3) int32: source gang, destination
// gang, gang count (1..16). Pointers are 16-byte aligned. Returns the
// cudaError_t of the launch (cudaSuccess = 0); the launch is asynchronous
// on `stream`.
int append_gangs_launch(const float* src, float* dst, const int* sched, int n_sub,
                        int channels, void* stream) {
  if (n_sub <= 0) return cudaSuccess;
  if (channels < 1 || channels > kMaxChannels) return cudaErrorInvalidValue;
  const int gang_vec = channels * kGang / 4;  // float4s per gang
  append_gangs_kernel<<<n_sub, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(src), reinterpret_cast<float4*>(dst), sched,
      gang_vec);
  return cudaGetLastError();
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
