// Neighbour gather of a feature table, reduced over the K neighbours.
//
// Replaces the TPU kernel `_call` of scripts/probe_gather_pallas.py (the
// in-VMEM gather that never lowered on Mosaic; the JAX package computes the
// same thing with XLA's flat gather, sednet_tpu/ops/graph.py:118-121). For
// every shape b and row i, with j_k = clamp(idx[b, i, k], 0, N - 1):
//
//   s[b, i, :]  = sum_k a[b, j_k, :]           (k ascending)
//   sq[b, i, :] = sum_k a[b, j_k, :]^2
//   mx[b, i, :] = max_k a[b, j_k, :]           (from -inf)
//
// These are the three reductions of the factored edge convolution
// (ops/graph.py edge_conv_factored); the (B, N, K, C) gathered tensor of the
// plain version never exists.
//
// Bound on the H100: bytes. The unique traffic is the table (B*N*C floats),
// the int64 indices (B*N*K) and the three outputs: 123 MB at B=8, N=10000,
// K=64, C=64, 0.04 ms at 3.35 TB/s. The row reads themselves are K times
// the table (1.31 GB at C=64, 2.62 GB at C=128), but one shape's table is
// 2.56-5.12 MB and the whole batch's 20-41 MB fits the 50 MB L2, so they
// come from L2, not HBM: what the TPU design wanted from VMEM.
//
// Design: one warp per output row (b, i), 8 warps a block. Each lane owns
// CJ = C/32 consecutive channels (a float2 at C=64, a float4 at C=128), so
// one neighbour row is one coalesced 256- or 512-byte read by the warp. The
// row's K indices are loaded once (up to four per lane), clamped, and
// broadcast with __shfl_sync; the loop over k keeps the sum, the sum of
// squares and the max in registers. No shared memory, no atomics: every
// output is written once by the lane that owns it.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int WARPS = 8;             // output rows per block
constexpr int KMAX = 128;
constexpr int KSLOTS = KMAX / 32;    // indices per lane
constexpr unsigned FULL = 0xffffffffu;

template <int CJ>
__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         float (&v)[CJ]) {
  if constexpr (CJ % 4 == 0) {
#pragma unroll
    for (int u = 0; u < CJ / 4; ++u) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p) + u);
      v[4 * u] = t.x; v[4 * u + 1] = t.y; v[4 * u + 2] = t.z; v[4 * u + 3] = t.w;
    }
  } else if constexpr (CJ % 2 == 0) {
#pragma unroll
    for (int u = 0; u < CJ / 2; ++u) {
      const float2 t = __ldg(reinterpret_cast<const float2*>(p) + u);
      v[2 * u] = t.x; v[2 * u + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int u = 0; u < CJ; ++u) v[u] = __ldg(p + u);
  }
}

template <int CJ>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[CJ]) {
  if constexpr (CJ % 4 == 0) {
#pragma unroll
    for (int u = 0; u < CJ / 4; ++u)
      reinterpret_cast<float4*>(p)[u] =
          make_float4(v[4 * u], v[4 * u + 1], v[4 * u + 2], v[4 * u + 3]);
  } else if constexpr (CJ % 2 == 0) {
#pragma unroll
    for (int u = 0; u < CJ / 2; ++u)
      reinterpret_cast<float2*>(p)[u] = make_float2(v[2 * u], v[2 * u + 1]);
  } else {
#pragma unroll
    for (int u = 0; u < CJ; ++u) p[u] = v[u];
  }
}

template <int CJ>
__global__ void __launch_bounds__(32 * WARPS)
gather_reduce_kernel(const float* __restrict__ a,
                     const long long* __restrict__ idx, long long rows,
                     int n, int k, float* __restrict__ s_out,
                     float* __restrict__ sq_out, float* __restrict__ mx_out) {
  constexpr int C = 32 * CJ;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp shares its row
  const float* table = a + (row / n) * (long long)n * C + lane * CJ;
  const long long* ir = idx + row * k;

  long long mine[KSLOTS];
#pragma unroll
  for (int t = 0; t < KSLOTS; ++t) {
    const int kk = 32 * t + lane;
    long long j = kk < k ? ir[kk] : 0;
    mine[t] = j < 0 ? 0 : (j >= n ? n - 1 : j);
  }

  float s[CJ], sq[CJ], mx[CJ];
#pragma unroll
  for (int u = 0; u < CJ; ++u) {
    s[u] = 0.0f;
    sq[u] = 0.0f;
    mx[u] = -CUDART_INF_F;
  }
#pragma unroll
  for (int t = 0; t < KSLOTS; ++t) {
    const int count = min(32, k - 32 * t);  // warp-uniform
#pragma unroll 4
    for (int src = 0; src < count; ++src) {
      const long long j = __shfl_sync(FULL, mine[t], src);
      float v[CJ];
      load_vec<CJ>(table + j * C, v);
#pragma unroll
      for (int u = 0; u < CJ; ++u) {
        s[u] = s[u] + v[u];
        sq[u] = sq[u] + v[u] * v[u];
        mx[u] = fmaxf(mx[u], v[u]);
      }
    }
  }
  const long long o = row * C + lane * CJ;
  store_vec<CJ>(s_out + o, s);
  store_vec<CJ>(sq_out + o, sq);
  store_vec<CJ>(mx_out + o, mx);
}

template <int CJ>
int launch(const float* a, const long long* idx, int batch, int n, int k,
           float* s, float* sq, float* mx, cudaStream_t stream) {
  const long long rows = (long long)batch * n;
  const unsigned blocks = (unsigned)((rows + WARPS - 1) / WARPS);
  gather_reduce_kernel<CJ><<<blocks, 32 * WARPS, 0, stream>>>(
      a, idx, rows, n, k, s, sq, mx);
  return (int)cudaGetLastError();
}

}  // namespace

// a: (B, N, C) float32, C a multiple of 32 up to 256, 16-byte aligned;
// idx: (B, N, K) int64, 1 <= K <= 128 (out-of-range entries clamp into
// [0, N)); s, sq, mx: (B, N, C) float32. One launch on `stream`, no
// synchronisation.
extern "C" int sednet_gather_reduce(const void* a, const void* idx, int batch,
                                    int n, int c, int k, void* s, void* sq,
                                    void* mx, void* stream) {
  if (batch < 1 || n < 1 || k < 1 || k > KMAX || c < 32 || c > 256 ||
      c % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* af = (const float*)a;
  const long long* ix = (const long long*)idx;
  float* o[3] = {(float*)s, (float*)sq, (float*)mx};
  switch (c / 32) {
    case 1: return launch<1>(af, ix, batch, n, k, o[0], o[1], o[2], st);
    case 2: return launch<2>(af, ix, batch, n, k, o[0], o[1], o[2], st);
    case 3: return launch<3>(af, ix, batch, n, k, o[0], o[1], o[2], st);
    case 4: return launch<4>(af, ix, batch, n, k, o[0], o[1], o[2], st);
    case 5: return launch<5>(af, ix, batch, n, k, o[0], o[1], o[2], st);
    case 6: return launch<6>(af, ix, batch, n, k, o[0], o[1], o[2], st);
    case 7: return launch<7>(af, ix, batch, n, k, o[0], o[1], o[2], st);
    case 8: return launch<8>(af, ix, batch, n, k, o[0], o[1], o[2], st);
    default: return (int)cudaErrorInvalidValue;
  }
}
