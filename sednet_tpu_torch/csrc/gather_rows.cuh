// Sum, sum of squares and max of a feature table's rows over each row's K
// listed neighbours: the loop of K6 (gather_reduce.cu, int64 indices), also
// K4's phase 2 (fused_edgeconv.cu, int32 indices from its selection).
//
// G lanes of a warp own one output row (b, i), each lane CJ consecutive
// channels (C = G CJ): a float4 a lane and 32 / G rows a warp at C = 32, 64
// and 128 (G = 8, 16, 32), one row a warp and C / 32 channels a lane at the
// other widths. The row's K indices are loaded once (K / G a lane), clamped
// into [0, N), kept as 32-bit offsets j C and broadcast within the group by
// __shfl_sync; eight neighbour rows (four above C = 128) are loaded ahead
// of their adds, and the sum, the sum of squares and the max stay in
// registers, each channel summed in k order. No shared memory, no atomics: every output is written
// once by the lane that owns it.
//
// Rows are taken along an order: a block owns a run of RUN consecutive
// positions of `order` (a permutation of each shape's rows, or the
// identity where it is null), so the rows in flight in a block are
// neighbours on the order. Along a Morton curve of the points neighbouring
// rows share most of their neighbours, and L1 serves the repeats. The
// arithmetic of a row does not depend on which block, warp or lanes compute
// it, so the outputs are the same bits under every order and at every
// width mapping.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace gather_rows {
namespace {   // each source that includes this gets its own kernels

constexpr int WARPS = 8;             // warps per block
constexpr int RUN = 32;              // positions of the order per block
constexpr int KMAX = 128;
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
// C = G CJ; and, where cnt is given, cnt[b, i] = k. Block x owns the
// positions [run * (x % runs), + run) of shape x / runs along `order`.
template <int G, int CJ, class I, int W>
__global__ void __launch_bounds__(32 * W)
gather_reduce_kernel(const float* __restrict__ a, const I* __restrict__ idx,
                     const int* __restrict__ order, int n, int runs, int run,
                     int k, float* __restrict__ s_out,
                     float* __restrict__ sq_out, float* __restrict__ mx_out,
                     float* __restrict__ cnt_out) {
  constexpr int C = G * CJ, RPW = 32 / G, SLOTS = KMAX / G;
  constexpr int UNR = CJ <= 4 ? 8 : 4;   // rows loaded ahead
  const int lane = threadIdx.x & 31;
  const int g = lane / G, gl = lane % G;  // row of the warp, lane of the row
  const int b = blockIdx.x / runs;
  const int p0 = (blockIdx.x - b * runs) * run;
  const int p1 = min(p0 + run, n);
  const long long base = (long long)b * n;
  const float* table = a + base * C + gl * CJ;
  for (int q = p0 + (threadIdx.x >> 5) * RPW; q < p1; q += W * RPW) {
    const int p = q + g;
    const bool live = p < p1;  // the whole group
    int i = live ? p : 0;
    if (live && order) {
      i = __ldg(order + base + p);
      i = i < 0 ? 0 : (i >= n ? n - 1 : i);
    }
    const long long row = base + i;
    const I* ir = idx + row * k;
    unsigned off[SLOTS];  // j * C of the lane's neighbours (N C < 2^32)
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) {
      const int kk = G * t + gl;
      const I j = live && kk < k ? ir[kk] : 0;
      off[t] = (unsigned)(j < 0 ? 0 : (j >= n ? n - 1 : (int)j)) * C;
    }
    float s[CJ], sq[CJ], mx[CJ];
#pragma unroll
    for (int u = 0; u < CJ; ++u) {
      s[u] = 0.0f;
      sq[u] = 0.0f;
      mx[u] = -CUDART_INF_F;
    }
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) {
      const int count = min(G, k - G * t);  // warp-uniform
      for (int s0 = 0; s0 < count; s0 += UNR) {
        // every load unconditional (past the row's K, its last neighbour
        // again, not added), so that the UNR loads are in flight together
        float v[UNR][CJ];
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
          const unsigned o =
              __shfl_sync(FULL, off[t], min(s0 + u, count - 1), G);
          load_vec<CJ>(table + o, v[u]);
        }
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
          if (s0 + u < count) {
#pragma unroll
            for (int c = 0; c < CJ; ++c) {
              s[c] = s[c] + v[u][c];
              sq[c] = sq[c] + v[u][c] * v[u][c];
              mx[c] = fmaxf(mx[c], v[u][c]);
            }
          }
        }
      }
    }
    if (live) {
      const long long o = row * C + gl * CJ;
      store_vec<CJ>(s_out + o, s);
      store_vec<CJ>(sq_out + o, sq);
      store_vec<CJ>(mx_out + o, mx);
      if (cnt_out && gl == 0) cnt_out[row] = (float)k;
    }
  }
}

// One launch for G lanes a row and CJ channels a lane, W warps a block and
// runs of `run` positions.
template <int G, int CJ, class I, int W = WARPS>
int launch_width(const float* a, const I* idx, const int* order, int batch,
                 int n, int k, int run, float* s, float* sq, float* mx,
                 float* cnt, cudaStream_t stream) {
  const int runs = (n + run - 1) / run;
  const long long blocks = (long long)batch * runs;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gather_reduce_kernel<G, CJ, I, W><<<(unsigned)blocks, 32 * W, 0, stream>>>(
      a, idx, order, n, runs, run, k, s, sq, mx, cnt);
  return (int)cudaGetLastError();
}

// a: (B, N, C) float32, C a multiple of 32 up to 256, N C < 2^32, 16-byte
// aligned; idx: (B, N, k) of I, 1 <= k <= 128; order: (B, N) int32, a
// permutation of each shape's rows, or null for the identity; s, sq, mx:
// (B, N, C); cnt: (B, N) or null. One launch on `stream`; returns a
// cudaError_t.
template <class I>
int launch(const float* a, const I* idx, const int* order, int batch, int n,
           int c, int k, float* s, float* sq, float* mx, float* cnt,
           cudaStream_t stream) {
  if ((long long)n * c > 0xffffffffLL) return (int)cudaErrorInvalidValue;
#define GATHER_ROWS_CASE(CW, G, CJ)                                        \
  case CW:                                                                 \
    return launch_width<G, CJ, I>(a, idx, order, batch, n, k, RUN, s, sq,  \
                                  mx, cnt, stream);
  switch (c) {
    GATHER_ROWS_CASE(32, 8, 4)
    GATHER_ROWS_CASE(64, 16, 4)
    GATHER_ROWS_CASE(96, 32, 3)
    GATHER_ROWS_CASE(128, 32, 4)
    GATHER_ROWS_CASE(160, 32, 5)
    GATHER_ROWS_CASE(192, 32, 6)
    GATHER_ROWS_CASE(224, 32, 7)
    GATHER_ROWS_CASE(256, 32, 8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef GATHER_ROWS_CASE
}

}  // namespace
}  // namespace gather_rows
