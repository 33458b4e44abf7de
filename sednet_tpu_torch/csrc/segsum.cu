// Per-destination sums of entries sorted by destination: the A^T v of the
// matrix-free spectral LOBPCG (cluster/spectral.py, transpose_mode "pallas").
//
// Replaces the TPU kernel segsum_sorted_scan_pallas of
// sednet_tpu/ops/pallas_kernels.py (`_segsum_scan_kernel`, method "roll",
// and `_segsum_mxu_kernel`, method "mxu"). For every destination d < N and
// row r < m, with ends[-1] = 0:
//
//   out[d, r] = sum_{e in [ends[d-1], ends[d])} vals_t[r, e]
//
// and exactly 0 for an empty destination. Every partial sum is a plain
// pairwise add of entries: no prefix difference (the quirk affinity's
// coefficients span about 1e6, and a cumsum difference loses them), and no
// float atomics, so two launches give bit-identical results.
//
// Bound on the H100: bytes. It reads vals_t once (m * E floats: 236 MB at
// m = 36, 79 MB at m = 12, for N = 32768 and 50 neighbours, E = 1638400) and
// writes N * m floats: 0.07 / 0.03 ms at 3.35 TB/s.
//
// Design. The TPU kernel streamed tiles of entries through VMEM with a
// sequential carry across the grid; blocks here run in no order, so a block
// owns a destination instead, and no carry crosses blocks. The farthest
// quirk leaves most of the N destinations empty (260-850 have entries) and
// gives the rest up to thousands of entries each, so a thread per
// destination would serialise them; one block of 256 threads per
// destination, with an early exit (writing zeros) when it is empty, keeps
// the busy blocks balanced enough. A block takes its m rows four at a time:
// thread t adds the entries start + t, start + t + 256, ... of each of the
// four rows in ascending order (four independent loads in flight, read
// coalesced along E in JAX's (m, E) layout), then a fixed shuffle tree
// reduces each warp and warp 0 adds the eight warp sums in order. The order
// of every add is fixed by the segment's bounds alone. `nearest=True`
// graphs (about k entries at every destination) are right but leave most
// threads idle. `dest` is not read: the segment bounds come from `ends`.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RG = 4;  // rows per pass
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
segsum_kernel(const float* __restrict__ vals_t, const int* __restrict__ ends,
              int m, long long e_total, float* __restrict__ out) {
  __shared__ float part[RG][WARPS];
  const int d = blockIdx.x;
  const int t = threadIdx.x;
  const long long start = d == 0 ? 0 : ends[d - 1];
  const long long end = ends[d];
  float* o = out + (long long)d * m;
  if (start >= end) {
    for (int r = t; r < m; r += THREADS) o[r] = 0.0f;
    return;
  }
  const int lane = t & 31, warp = t >> 5;
  for (int r0 = 0; r0 < m; r0 += RG) {
    float acc[RG];
#pragma unroll
    for (int q = 0; q < RG; ++q) acc[q] = 0.0f;
    for (long long e = start + t; e < end; e += THREADS) {
      float v[RG];
#pragma unroll
      for (int q = 0; q < RG; ++q)
        v[q] = r0 + q < m ? __ldg(vals_t + (r0 + q) * e_total + e) : 0.0f;
#pragma unroll
      for (int q = 0; q < RG; ++q) acc[q] = acc[q] + v[q];
    }
#pragma unroll
    for (int q = 0; q < RG; ++q) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[q] = acc[q] + __shfl_down_sync(FULL, acc[q], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < RG; ++q) part[q][warp] = acc[q];
    }
    __syncthreads();
    if (t < RG && r0 + t < m) {
      float sum = part[t][0];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) sum = sum + part[t][w];
      o[r0 + t] = sum;
    }
    __syncthreads();
  }
}

}  // namespace

// vals_t: (m, E) float32; ends: (N,) int32 ascending cumulative counts,
// ends[N-1] <= E; out: (N, m) float32. One launch on `stream`, no
// synchronisation.
extern "C" int sednet_segsum_sorted(const void* vals_t, const void* ends,
                                    int m, long long e, int n, void* out,
                                    void* stream) {
  if (m < 1 || n < 1 || e < 0) return (int)cudaErrorInvalidValue;
  segsum_kernel<<<n, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)vals_t, (const int*)ends, m, e, (float*)out);
  return (int)cudaGetLastError();
}
