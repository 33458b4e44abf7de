// Exact k-nearest (or k-farthest) rows of p for every row of q, k <= 128.
//
// Replaces the TPU kernel `topk_pallas` of sednet_tpu/ops/flash_topk.py
// (`_make_kernel`, `_dist_tile`, `_fold_tile`). Two metrics, written with
// the same expansion as `_dist_tile`:
//
//   sqdist:          d = |q|^2 + |p|^2 - 2 q.p
//   points_normals:  d = (|q3|^2 + |p3|^2 - 2 q3.p3) * (1 + w (2 - 2 qn.pn))
//                    (q3: channels 0-2, qn: channels 3-5)
//
// `largest` selects the k largest distances by selecting the k smallest of
// -d. The result is ascending in the selected order (nearest first, or
// farthest first), ties broken by the lower column index.
//
// Bound on the H100: operations. A layer-2 graph at B=8, N=10000, D=64 is
// 2*B*N*N*D = 1.0e11 flops of distances on the float32 CUDA cores (the
// reference keeps them at HIGHEST precision), while its inputs and outputs
// are a few tens of MB.
//
// Design. A block owns 32 query rows of one shape and streams 64-column
// tiles of p through shared memory. Each of 256 threads computes a 2x4 piece
// of the 32x64 distance tile and writes it to shared memory. Then each warp
// takes 4 rows: the 32 lanes test two candidates each against the row's
// current k-th best value (the list is kept sorted in shared memory, so that
// value is one load), a ballot collects the candidates below it, and they
// are inserted one at a time, lowest column first, by the whole warp (each
// lane moves up to 4 list entries). A candidate equal to the k-th value is
// rejected: the entry already there has the lower index. This threshold
// test is the exactness argument of the TPU kernel's `k_lane` skip: once
// the list is full, most tiles insert nothing. Batched inputs are one
// launch with the batch on the grid's y axis.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int RB = 32;        // query rows per block
constexpr int CB = 64;        // columns per tile
constexpr int THREADS = 256;  // 16 x 16 for the distance tile, 8 warps to select
constexpr int KMAX = 128;
constexpr int DS = CB + 1;    // padded row stride of the distance tile

__host__ __device__ inline int tile_stride(int d) { return d | 1; }

__host__ inline int smem_bytes(int d) {
  const int s = tile_stride(d);
  return (RB * s + CB * s + RB + CB + RB * DS) * 4 + RB * KMAX * 8;
}

__global__ void __launch_bounds__(THREADS)
topk_kernel(const float* __restrict__ q, const float* __restrict__ p,
            long long q_bstride, long long p_bstride, int m, int n, int d,
            int k, int metric, float w, int largest,
            float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ float smem[];
  const int S = tile_stride(d);
  float* qs = smem;              // RB x S
  float* ps = qs + RB * S;       // CB x S
  float* qq = ps + CB * S;       // RB
  float* pp = qq + RB;           // CB
  float* dt = pp + CB;           // RB x DS
  float* lv = dt + RB * DS;      // RB x KMAX sorted best values
  int* li = (int*)(lv + RB * KMAX);  // RB x KMAX their columns

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * RB;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* qb = q + b * q_bstride;
  const float* pb = p + b * p_bstride;
  // channels entering the squared norms: all for sqdist, xyz for points_normals
  const int dn = metric == 0 ? d : 3;

  for (int i = tid; i < RB * d; i += THREADS) {
    const int r = i / d, e = i % d;
    qs[r * S + e] = r0 + r < m ? qb[(size_t)(r0 + r) * d + e] : 0.f;
  }
  for (int i = tid; i < RB * KMAX; i += THREADS) {
    lv[i] = CUDART_INF_F;
    li[i] = 0;
  }
  __syncthreads();
  if (tid < RB) {
    float acc = 0.f;
    for (int e = 0; e < dn; ++e) acc = fmaf(qs[tid * S + e], qs[tid * S + e], acc);
    qq[tid] = acc;
  }

  for (int c0 = 0; c0 < n; c0 += CB) {
    __syncthreads();  // previous tile's ps and dt are no longer read
    for (int i = tid; i < CB * d; i += THREADS) {
      const int c = i / d, e = i % d;
      ps[c * S + e] = c0 + c < n ? pb[(size_t)(c0 + c) * d + e] : 0.f;
    }
    __syncthreads();
    if (tid < CB) {
      float acc = 0.f;
      for (int e = 0; e < dn; ++e) acc = fmaf(ps[tid * S + e], ps[tid * S + e], acc);
      pp[tid] = acc;
    }
    __syncthreads();

    // distance tile: thread (ty, tx) owns rows ty, ty + 16 and columns tx + 16*j
    float s[2][4], sn[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = sn[i][j] = 0.f;
    if (metric == 0) {
      for (int e = 0; e < d; ++e) {
        float qv[2], pv[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) qv[i] = qs[(ty + 16 * i) * S + e];
#pragma unroll
        for (int j = 0; j < 4; ++j) pv[j] = ps[(tx + 16 * j) * S + e];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], pv[j], s[i][j]);
      }
    } else {
      for (int e = 0; e < 6; ++e) {
        float qv[2], pv[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) qv[i] = qs[(ty + 16 * i) * S + e];
#pragma unroll
        for (int j = 0; j < 4; ++j) pv[j] = ps[(tx + 16 * j) * S + e];
        if (e < 3) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], pv[j], s[i][j]);
        } else {
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sn[i][j] = fmaf(qv[i], pv[j], sn[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        float v = qq[r] + pp[c] - 2.f * s[i][j];
        if (metric != 0) v = v * (1.f + w * (2.f - 2.f * sn[i][j]));
        if (largest) v = -v;
        // columns past n never pass the strict test against the list
        dt[r * DS + c] = c0 + c < n ? v : CUDART_INF_F;
      }
    __syncthreads();

    // selection: warp `warp` owns rows 4*warp .. 4*warp + 3
    for (int rr = 0; rr < RB / 8; ++rr) {
      const int r = warp * (RB / 8) + rr;
      if (r0 + r >= m) break;  // warp-uniform
      float* bv = lv + r * KMAX;
      int* bi = li + r * KMAX;
      float thr = bv[k - 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float dv = dt[r * DS + lane + 32 * half];
        unsigned mask = __ballot_sync(0xffffffffu, dv < thr);
        while (mask) {
          const int src = __ffs(mask) - 1;
          mask &= mask - 1;
          const float v = __shfl_sync(0xffffffffu, dv, src);
          if (!(v < thr)) continue;  // the list moved since the ballot
          const int col = c0 + src + 32 * half;
          // insertion point = number of entries <= v (equal entries have
          // lower columns and stay in front)
          float keep_v[KMAX / 32], prev_v[KMAX / 32];
          int prev_i[KMAX / 32];
          int pos_ins = 0;
#pragma unroll
          for (int t = 0; t < KMAX / 32; ++t) {
            const int pos = lane + 32 * t;
            const bool in = pos < k;
            keep_v[t] = in ? bv[pos] : CUDART_INF_F;
            prev_v[t] = (in && pos > 0) ? bv[pos - 1] : CUDART_INF_F;
            prev_i[t] = (in && pos > 0) ? bi[pos - 1] : 0;
            pos_ins += __popc(__ballot_sync(0xffffffffu, in && keep_v[t] <= v));
          }
          __syncwarp();
#pragma unroll
          for (int t = 0; t < KMAX / 32; ++t) {
            const int pos = lane + 32 * t;
            if (pos < k && pos >= pos_ins) {
              bv[pos] = pos == pos_ins ? v : prev_v[t];
              bi[pos] = pos == pos_ins ? col : prev_i[t];
            }
          }
          __syncwarp();
          thr = bv[k - 1];
        }
      }
    }
  }
  __syncthreads();

  for (int rr = 0; rr < RB / 8; ++rr) {
    const int r = warp * (RB / 8) + rr;
    if (r0 + r >= m) break;
    const size_t o = ((size_t)b * m + r0 + r) * k;
    for (int pos = lane; pos < k; pos += 32) {
      const float v = lv[r * KMAX + pos];
      out_d[o + pos] = largest ? -v : v;
      out_i[o + pos] = li[r * KMAX + pos];
    }
  }
}

}  // namespace

// q: (B, M, D) with batch stride q_bstride elements; p: (B, N, D) with batch
// stride p_bstride (0 shares one point set); metric 0 = sqdist,
// 1 = points_normals (D >= 6). out_d: (B, M, k) float32, out_i: (B, M, k)
// int32.
extern "C" int sednet_topk(const void* q, const void* p, long long q_bstride,
                           long long p_bstride, int batch, int m, int n,
                           int d, int k, int metric, float w, int largest,
                           void* out_d, void* out_i, void* stream) {
  const int bytes = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + RB - 1) / RB, batch);
  topk_kernel<<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)p, q_bstride, p_bstride, m, n, d, k,
      metric, w, largest, (float*)out_d, (int*)out_i);
  return (int)cudaGetLastError();
}
