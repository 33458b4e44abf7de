// Backward of the neighbour gather-reduce (K6b).
//
// K6 (gather_reduce.cu) computes, for every shape b, row i and channel c,
// with j_k = clamp(idx[b, i, k], 0, N - 1), the sum s, the sum of squares
// sq and the max mx of a[b, j_k, c] over k. Given their cotangents gs, gsq
// and gmx (each B x N x C), this kernel computes the table's gradient
//
//   da[j, c] = sum over (i, k) with j_k = j of
//              gs[i, c] + 2 a[j, c] gsq[i, c]
//              + [a[j, c] == mx[i, c]] gmx[i, c] / cnt[i, c],
//   cnt[i, c] = #{k : a[j_k, c] == mx[i, c]},
//
// the max's cotangent split evenly over its ties, as JAX's reduce_max VJP
// and torch's amax backward split it. A neighbour listed twice in a row
// counts twice. mx is the forward's output, a copy of one of the gathered
// values, so the comparison is exact.
//
// It replaces no Pallas kernel: the JAX package differentiates XLA's flat
// gather (sednet_tpu/ops/graph.py:118-121) under jax.value_and_grad
// (sednet_tpu/train.py:128). Its plain PyTorch version is
// ops/graph.py gather_reduce_backward_plain.
//
// What bounds it on the H100. The unique traffic is a, mx, gs, gsq and gmx
// read once (B N C floats each), the int64 indices (B N K) and da written:
// 81.9 MB at B = 4, N = 10000, K = 64, C = 64, 0.024 ms at 3.35 TB/s. The
// work it cannot avoid in this design is B N K C scattered adds (164 M at
// C = 64) into a table that fits the 50 MB L2; they run as L2 atomics.
//
// Design: K6's loop (gather_rows.cuh) run twice over each row's K
// neighbours. G lanes own a row and CJ channels each (a float4 a lane at
// C = 32, 64 and 128), the neighbours are 32-bit offsets shuffled within the
// group, eight rows loaded ahead. Pass 1 counts the ties of the max per
// channel; pass 2 forms each position's term and adds it into da[j_k] with
// one vector atomic a lane (float4 on sm_90). The blocks walk runs of 32
// rows of the forward's Morton order, so that a block's adds land on rows
// its other rows also add to, while they are in L2. da must be zeroed
// first. Atomics add in no fixed order: the last bits of da vary from run
// to run, so the kernel is held to its plain version within a rounding
// bound, not bit for bit.
#include <cuda_runtime.h>

#include "gather_rows.cuh"

namespace {

using gather_rows::FULL;
using gather_rows::KMAX;
using gather_rows::load_vec;

template <int CJ>
__device__ __forceinline__ void atomic_add_vec(float* p, const float (&v)[CJ]) {
  if constexpr (CJ % 4 == 0) {
#pragma unroll
    for (int u = 0; u < CJ / 4; ++u)
      atomicAdd(reinterpret_cast<float4*>(p) + u,
                make_float4(v[4 * u], v[4 * u + 1], v[4 * u + 2], v[4 * u + 3]));
  } else if constexpr (CJ % 2 == 0) {
#pragma unroll
    for (int u = 0; u < CJ / 2; ++u)
      atomicAdd(reinterpret_cast<float2*>(p) + u,
                make_float2(v[2 * u], v[2 * u + 1]));
  } else {
#pragma unroll
    for (int u = 0; u < CJ; ++u) atomicAdd(p + u, v[u]);
  }
}

// da (B, N, C) += the terms of the rows idx[b, i, 0 .. k) of a (B, N, C),
// C = G CJ. Block x owns the positions [run * (x % runs), + run) of shape
// x / runs along `order`.
template <int G, int CJ, int W>
__global__ void __launch_bounds__(32 * W)
gather_reduce_bwd_kernel(const float* __restrict__ a,
                         const long long* __restrict__ idx,
                         const int* __restrict__ order,
                         const float* __restrict__ mx,
                         const float* __restrict__ gs,
                         const float* __restrict__ gsq,
                         const float* __restrict__ gmx, int n, int runs,
                         int run, int k, float* __restrict__ da) {
  constexpr int C = G * CJ, RPW = 32 / G, SLOTS = KMAX / G;
  constexpr int UNR = CJ <= 4 ? 8 : 4;   // rows loaded ahead
  const int lane = threadIdx.x & 31;
  const int g = lane / G, gl = lane % G;  // row of the warp, lane of the row
  const int b = blockIdx.x / runs;
  const int p0 = (blockIdx.x - b * runs) * run;
  const int p1 = min(p0 + run, n);
  const long long base = (long long)b * n;
  const float* table = a + base * C + gl * CJ;
  float* dtable = da + base * C + gl * CJ;
  for (int q = p0 + (threadIdx.x >> 5) * RPW; q < p1; q += W * RPW) {
    const int p = q + g;
    const bool live = p < p1;  // the whole group
    int i = live ? p : 0;
    if (live && order) {
      i = __ldg(order + base + p);
      i = i < 0 ? 0 : (i >= n ? n - 1 : i);
    }
    const long long row = base + i;
    const long long* ir = idx + row * k;
    unsigned off[SLOTS];  // j * C of the lane's neighbours (N C < 2^32)
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) {
      const int kk = G * t + gl;
      const long long j = live && kk < k ? ir[kk] : 0;
      off[t] = (unsigned)(j < 0 ? 0 : (j >= n ? n - 1 : (int)j)) * C;
    }
    const long long o = row * C + gl * CJ;
    float m[CJ], s[CJ], sq2[CJ], w[CJ], cnt[CJ];
    load_vec<CJ>(mx + o, m);
    load_vec<CJ>(gs + o, s);
    load_vec<CJ>(gsq + o, sq2);
    load_vec<CJ>(gmx + o, w);
#pragma unroll
    for (int c = 0; c < CJ; ++c) cnt[c] = 0.0f;

    // pass 1: ties of the max, per channel
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) {
      const int count = min(G, k - G * t);  // warp-uniform
      for (int s0 = 0; s0 < count; s0 += UNR) {
        float v[UNR][CJ];
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
          const unsigned oj =
              __shfl_sync(FULL, off[t], min(s0 + u, count - 1), G);
          load_vec<CJ>(table + oj, v[u]);
        }
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
          if (s0 + u < count) {
#pragma unroll
            for (int c = 0; c < CJ; ++c)
              cnt[c] = cnt[c] + (v[u][c] == m[c] ? 1.0f : 0.0f);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < CJ; ++c) w[c] = cnt[c] > 0.0f ? w[c] / cnt[c] : 0.0f;

    // pass 2: each position's term into da[j_k]
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) {
      const int count = min(G, k - G * t);
      for (int s0 = 0; s0 < count; s0 += UNR) {
        float v[UNR][CJ];
        unsigned oj[UNR];
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
          oj[u] = __shfl_sync(FULL, off[t], min(s0 + u, count - 1), G);
          load_vec<CJ>(table + oj[u], v[u]);
        }
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
          if (live && s0 + u < count) {
            float d[CJ];
#pragma unroll
            for (int c = 0; c < CJ; ++c) {
              d[c] = s[c] + 2.0f * v[u][c] * sq2[c];
              if (v[u][c] == m[c]) d[c] = d[c] + w[c];
            }
            atomic_add_vec<CJ>(dtable + oj[u], d);
          }
        }
      }
    }
  }
}

template <int G, int CJ, int W = gather_rows::WARPS>
int launch_width(const float* a, const long long* idx, const int* order,
                 const float* mx, const float* gs, const float* gsq,
                 const float* gmx, int batch, int n, int k, float* da,
                 cudaStream_t stream) {
  const int run = gather_rows::RUN;
  const int runs = (n + run - 1) / run;
  const long long blocks = (long long)batch * runs;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gather_reduce_bwd_kernel<G, CJ, W><<<(unsigned)blocks, 32 * W, 0, stream>>>(
      a, idx, order, mx, gs, gsq, gmx, n, runs, run, k, da);
  return (int)cudaGetLastError();
}

}  // namespace

// a, mx, gs, gsq, gmx: (B, N, C) float32, C a multiple of 32 up to 256,
// N C < 2^32, 16-byte aligned; idx: (B, N, K) int64, 1 <= K <= 128
// (out-of-range entries clamp into [0, N)); order: (B, N) int32, a
// permutation of each shape's rows, or null for the identity; da: (B, N, C)
// float32, zeroed by the caller, to which the gradient is added. One launch
// on `stream`, no synchronisation.
extern "C" int sednet_gather_reduce_backward(
    const void* a, const void* idx, const void* order, const void* mx,
    const void* gs, const void* gsq, const void* gmx, int batch, int n, int c,
    int k, void* da, void* stream) {
  if (batch < 1 || n < 1 || k < 1 || k > KMAX || c < 32 || c > 256 ||
      c % 32 != 0 || (long long)n * c > 0xffffffffLL)
    return (int)cudaErrorInvalidValue;
#define GATHER_BWD_CASE(CW, G, CJ)                                           \
  case CW:                                                                   \
    return launch_width<G, CJ>(                                              \
        (const float*)a, (const long long*)idx, (const int*)order,           \
        (const float*)mx, (const float*)gs, (const float*)gsq,               \
        (const float*)gmx, batch, n, k, (float*)da, (cudaStream_t)stream);
  switch (c) {
    GATHER_BWD_CASE(32, 8, 4)
    GATHER_BWD_CASE(64, 16, 4)
    GATHER_BWD_CASE(96, 32, 3)
    GATHER_BWD_CASE(128, 32, 4)
    GATHER_BWD_CASE(160, 32, 5)
    GATHER_BWD_CASE(192, 32, 6)
    GATHER_BWD_CASE(224, 32, 7)
    GATHER_BWD_CASE(256, 32, 8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef GATHER_BWD_CASE
}
