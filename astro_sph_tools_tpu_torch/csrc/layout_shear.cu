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
// Design: a team of warps per sub-run, eight warps to a block. A block per
// sub-run (the first version) left most of its 256 threads idle on short
// sub-runs: a one-gang sub-run at C = 3 is 96 float4s, and hundreds of
// thousands of such blocks were bound by block launch and retirement rather
// than bytes. One warp per sub-run fixes that but leaves a 16-gang sub-run
// (up to 4096 float4s) to 32 lanes that wait on each round trip in turn. So
// the wrapper sizes the team, 1 to 8 warps, from the schedule's mean
// sub-run length (the one number it has on the host). The team's lanes take
// neighbouring float4s (16-byte loads and stores, neighbouring lanes on
// neighbouring addresses), and each lane issues kUnroll loads before their
// stores so that several are in flight; 64-bit element offsets (the gang
// array passes 2^31 floats from about 2^28 records). Each warp reads its own
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
constexpr int kWarps = 8;  // warps (sub-runs) per block
constexpr int kUnroll = 4;  // float4 loads in flight per lane

__global__ void __launch_bounds__(kWarps * 32)
    append_gangs_kernel(const float4* __restrict__ src, float4* __restrict__ dst,
                        const int* __restrict__ sched, int n_sub, int gang_vec,
                        int team_log2) {
  const int gw = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int sub = gw >> team_log2;
  if (sub >= n_sub) return;
  const int stride = 32 << team_log2;  // lanes of the team
  const int t = ((gw - (sub << team_log2)) << 5) + (threadIdx.x & 31);
  const int* s = sched + 3 * (long long)sub;
  const long long s0 = (long long)s[0] * gang_vec;
  const long long d0 = (long long)s[1] * gang_vec;
  const int n = s[2] * gang_vec;  // <= 16 * 8 * 32 float4s
  for (int i = t; i < n; i += stride * kUnroll) {
    float4 a[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (i + stride * k < n) a[k] = __ldg(src + s0 + i + stride * k);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (i + stride * k < n) dst[d0 + i + stride * k] = a[k];
  }
}

}  // namespace

extern "C" {

// Copy the n_sub scheduled sub-runs of (G, channels, 128) f32 gangs from
// `src` into `dst`, with 2^team_log2 (<= 8) warps per sub-run. `sched` is
// (n_sub, 3) int32: source gang, destination gang, gang count (1..16).
// Pointers are 16-byte aligned. Returns the cudaError_t of the launch
// (cudaSuccess = 0); the launch is asynchronous on `stream`.
int append_gangs_launch(const float* src, float* dst, const int* sched, int n_sub,
                        int channels, int team_log2, void* stream) {
  if (n_sub <= 0) return cudaSuccess;
  if (channels < 1 || channels > kMaxChannels || team_log2 < 0 || team_log2 > 3)
    return cudaErrorInvalidValue;
  const int gang_vec = channels * kGang / 4;  // float4s per gang
  const long long warps = (long long)n_sub << team_log2;
  const int blocks = (int)((warps + kWarps - 1) / kWarps);
  append_gangs_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(src), reinterpret_cast<float4*>(dst), sched,
      n_sub, gang_vec, team_log2);
  return cudaGetLastError();
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
