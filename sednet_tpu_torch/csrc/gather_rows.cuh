// Sum, sum of squares and max of a feature table's rows over each row's K
// listed neighbours: the warp-a-row loop of K6 (gather_reduce.cu, int64
// indices), also K4's phase 2 (fused_edgeconv.cu, int32 indices from its
// selection). One warp per output row (b, i), 8 warps a block. Each lane
// owns CJ = C/32 consecutive channels (a float2 at C=64, a float4 at
// C=128), so one neighbour row is one coalesced 256- or 512-byte read by
// the warp. The row's K indices are loaded once (up to four per lane),
// clamped into [0, N), and broadcast with __shfl_sync; the loop over k
// keeps the sum, the sum of squares and the max in registers, each channel
// summed in k order. No shared memory, no atomics: every output is written
// once by the lane that owns it.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace gather_rows {
namespace {   // each source that includes this gets its own kernels

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

// s, sq, mx (B, N, C) over the rows idx[b, i, 0 .. k) of a (B, N, C),
// C = 32 CJ; and, where cnt is given, cnt[b, i] = k.
template <int CJ, class I>
__global__ void __launch_bounds__(32 * WARPS)
gather_reduce_kernel(const float* __restrict__ a, const I* __restrict__ idx,
                     long long rows, int n, int k, float* __restrict__ s_out,
                     float* __restrict__ sq_out, float* __restrict__ mx_out,
                     float* __restrict__ cnt_out) {
  constexpr int C = 32 * CJ;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp shares its row
  const float* table = a + (row / n) * (long long)n * C + lane * CJ;
  const I* ir = idx + row * k;

  I mine[KSLOTS];
#pragma unroll
  for (int t = 0; t < KSLOTS; ++t) {
    const int kk = 32 * t + lane;
    I j = kk < k ? ir[kk] : 0;
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
  if (cnt_out && lane == 0) cnt_out[row] = (float)k;
}

template <int CJ, class I>
int launch_cj(const float* a, const I* idx, int batch, int n, int k,
              float* s, float* sq, float* mx, float* cnt,
              cudaStream_t stream) {
  const long long rows = (long long)batch * n;
  const unsigned blocks = (unsigned)((rows + WARPS - 1) / WARPS);
  gather_reduce_kernel<CJ, I><<<blocks, 32 * WARPS, 0, stream>>>(
      a, idx, rows, n, k, s, sq, mx, cnt);
  return (int)cudaGetLastError();
}

// a: (B, N, C) float32, C a multiple of 32 up to 256, 16-byte aligned; idx:
// (B, N, k) of I, 1 <= k <= 128; s, sq, mx: (B, N, C); cnt: (B, N) or null.
// One launch on `stream`; returns a cudaError_t.
template <class I>
int launch(const float* a, const I* idx, int batch, int n, int c, int k,
           float* s, float* sq, float* mx, float* cnt, cudaStream_t stream) {
  switch (c / 32) {
    case 1: return launch_cj<1>(a, idx, batch, n, k, s, sq, mx, cnt, stream);
    case 2: return launch_cj<2>(a, idx, batch, n, k, s, sq, mx, cnt, stream);
    case 3: return launch_cj<3>(a, idx, batch, n, k, s, sq, mx, cnt, stream);
    case 4: return launch_cj<4>(a, idx, batch, n, k, s, sq, mx, cnt, stream);
    case 5: return launch_cj<5>(a, idx, batch, n, k, s, sq, mx, cnt, stream);
    case 6: return launch_cj<6>(a, idx, batch, n, k, s, sq, mx, cnt, stream);
    case 7: return launch_cj<7>(a, idx, batch, n, k, s, sq, mx, cnt, stream);
    case 8: return launch_cj<8>(a, idx, batch, n, k, s, sq, mx, cnt, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace gather_rows
