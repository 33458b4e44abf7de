// Index-free neighbour-set reductions of the fused DGCNN edge convolution.
//
// Replaces the TPU kernel `_make_fused_kernel` (fused_edge_reductions) of
// sednet_tpu/ops/fused_edgeconv.py. For every row i of geom (N, D) of one
// shape:
//
//   T_i  = the k-th smallest distance d(i, j) over j (self included), with
//          the expansion of `_dist_tile` (the same as K1, flash_topk.cu):
//            sqdist:          |q|^2 + |p|^2 - 2 q.p
//            points_normals:  (|q3|^2 + |p3|^2 - 2 q3.p3) * (1 + w (2 - 2 qn.pn))
//   S_i  = { j : d(i, j) <= T_i }   (every tie with the k-th distance joins)
//   mx_i = max_{j in S_i} a[j, :],  sm_i = sum a[j, :],  sq_i = sum a[j, :]^2,
//   cnt_i = |S_i|
//
// Bound on the H100: operations. Both phases form the full N x N distance
// matrix of every shape on the float32 CUDA cores (2 * 2*B*N*N*D flops:
// 2.0e11 at B=8, N=10000, D=64), while the inputs and outputs are a few
// tens of MB and the gathered rows of `a` (B*N*k*C floats) come from L2.
//
// Design. Two launches from this one source, both over blocks of 32 query
// rows of one shape that stream 64-column tiles of geom through shared
// memory, with the distance tile formed by the one device function
// `distance_tile` (256 threads, a 2x4 piece each, explicit fmaf under
// -fmad=false):
//
//   phase 1 (`threshold_kernel`): the value-only form of K1's selection. Each
//     row keeps its k smallest distances sorted in shared memory; a warp
//     ballots the candidates below the row's current k-th value and inserts
//     them one at a time. Output: T (B, N).
//   phase 2 (`reduce_kernel`): recomputes every distance tile with the same
//     arithmetic, so d(i, j) is bit-identical to the value phase 1 compared
//     and the mask d <= T_i is exact. A warp owns 4 rows; per row it ballots
//     the hits of the tile (about k of 10000 columns per row in all) and
//     gathers a[j, :] for each, the 32 lanes splitting the channels, into
//     register accumulators. The TPU kernel turned the mask into MXU
//     products and a 128-step lane loop for the max because it has no cheap
//     gather; the GPU does, so only the hits are read.
//
// Tiles are not skipped: without the Morton sort (`spatial_sort`, not ported)
// the 32 rows of a block have neighbours in nearly every tile.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int RB = 32;        // query rows per block
constexpr int CB = 64;        // columns per tile
constexpr int THREADS = 256;  // 16 x 16 for the distance tile, 8 warps after
constexpr int KMAX = 128;
constexpr int DS = CB + 1;    // padded row stride of the distance tile
constexpr int CJ_MAX = 8;     // channels per lane: C <= 256

__host__ __device__ inline int tile_stride(int d) { return d | 1; }

// Shared memory common to both phases: queries, a column tile, their squared
// norms and the distance tile.
__host__ inline int common_floats(int d) {
  const int s = tile_stride(d);
  return RB * s + CB * s + RB + CB + RB * DS;
}

struct Tiles {
  float* qs;  // RB x S queries
  float* ps;  // CB x S columns
  float* qq;  // RB
  float* pp;  // CB
  float* dt;  // RB x DS distances
  float* rest;
};

__device__ inline Tiles carve(float* smem, int d) {
  const int s = tile_stride(d);
  Tiles t;
  t.qs = smem;
  t.ps = t.qs + RB * s;
  t.qq = t.ps + CB * s;
  t.pp = t.qq + RB;
  t.dt = t.pp + CB;
  t.rest = t.dt + RB * DS;
  return t;
}

// Stage the block's queries and their squared norms (xyz only for
// points_normals). Ends with the norms written; the caller syncs.
__device__ void load_queries(const Tiles& t, const float* gb, int r0, int m,
                             int d, int metric) {
  const int S = tile_stride(d);
  const int tid = threadIdx.x;
  for (int i = tid; i < RB * d; i += THREADS) {
    const int r = i / d, e = i % d;
    t.qs[r * S + e] = r0 + r < m ? gb[(size_t)(r0 + r) * d + e] : 0.f;
  }
  __syncthreads();
  const int dn = metric == 0 ? d : 3;
  if (tid < RB) {
    float acc = 0.f;
    for (int e = 0; e < dn; ++e)
      acc = fmaf(t.qs[tid * S + e], t.qs[tid * S + e], acc);
    t.qq[tid] = acc;
  }
}

// Form the RB x CB distance tile of columns c0 .. c0 + CB - 1 in t.dt
// (columns past n read +inf). Both phases call this, so their distances are
// the same bits. Syncs on entry and on exit.
__device__ __forceinline__ void distance_tile(const Tiles& t, const float* gb,
                                              int c0, int n, int d,
                                              int metric, float w) {
  const int S = tile_stride(d);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  __syncthreads();  // the previous tile's ps and dt are no longer read
  for (int i = tid; i < CB * d; i += THREADS) {
    const int c = i / d, e = i % d;
    t.ps[c * S + e] = c0 + c < n ? gb[(size_t)(c0 + c) * d + e] : 0.f;
  }
  __syncthreads();
  const int dn = metric == 0 ? d : 3;
  if (tid < CB) {
    float acc = 0.f;
    for (int e = 0; e < dn; ++e)
      acc = fmaf(t.ps[tid * S + e], t.ps[tid * S + e], acc);
    t.pp[tid] = acc;
  }
  __syncthreads();

  // thread (ty, tx) owns rows ty, ty + 16 and columns tx + 16*j
  float s[2][4], sn[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = sn[i][j] = 0.f;
  if (metric == 0) {
    for (int e = 0; e < d; ++e) {
      float qv[2], pv[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) qv[i] = t.qs[(ty + 16 * i) * S + e];
#pragma unroll
      for (int j = 0; j < 4; ++j) pv[j] = t.ps[(tx + 16 * j) * S + e];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], pv[j], s[i][j]);
    }
  } else {
    for (int e = 0; e < 6; ++e) {
      float qv[2], pv[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) qv[i] = t.qs[(ty + 16 * i) * S + e];
#pragma unroll
      for (int j = 0; j < 4; ++j) pv[j] = t.ps[(tx + 16 * j) * S + e];
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
      float v = t.qq[r] + t.pp[c] - 2.f * s[i][j];
      if (metric != 0) v = v * (1.f + w * (2.f - 2.f * sn[i][j]));
      t.dt[r * DS + c] = c0 + c < n ? v : CUDART_INF_F;
    }
  __syncthreads();
}

// Phase 1: T[b, i] = the k-th smallest distance of row i.
__global__ void __launch_bounds__(THREADS)
threshold_kernel(const float* __restrict__ geom, int n, int d, int k,
                 int metric, float w, float* __restrict__ thresh) {
  extern __shared__ float smem[];
  const Tiles t = carve(smem, d);
  float* lv = t.rest;  // RB x KMAX sorted best values

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * RB;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* gb = geom + (size_t)b * n * d;

  for (int i = tid; i < RB * KMAX; i += THREADS) lv[i] = CUDART_INF_F;
  load_queries(t, gb, r0, n, d, metric);

  for (int c0 = 0; c0 < n; c0 += CB) {
    distance_tile(t, gb, c0, n, d, metric, w);
    // warp `warp` owns rows 4*warp .. 4*warp + 3
    for (int rr = 0; rr < RB / 8; ++rr) {
      const int r = warp * (RB / 8) + rr;
      if (r0 + r >= n) break;  // warp-uniform
      float* bv = lv + r * KMAX;
      float thr = bv[k - 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float dv = t.dt[r * DS + lane + 32 * half];
        unsigned mask = __ballot_sync(0xffffffffu, dv < thr);
        while (mask) {
          const int src = __ffs(mask) - 1;
          mask &= mask - 1;
          const float v = __shfl_sync(0xffffffffu, dv, src);
          if (!(v < thr)) continue;  // the list moved since the ballot
          // insertion point = number of entries <= v
          float prev_v[KMAX / 32];
          int pos_ins = 0;
#pragma unroll
          for (int u = 0; u < KMAX / 32; ++u) {
            const int pos = lane + 32 * u;
            const bool in = pos < k;
            const float keep = in ? bv[pos] : CUDART_INF_F;
            prev_v[u] = (in && pos > 0) ? bv[pos - 1] : CUDART_INF_F;
            pos_ins += __popc(__ballot_sync(0xffffffffu, in && keep <= v));
          }
          __syncwarp();
#pragma unroll
          for (int u = 0; u < KMAX / 32; ++u) {
            const int pos = lane + 32 * u;
            if (pos < k && pos >= pos_ins) bv[pos] = pos == pos_ins ? v : prev_v[u];
          }
          __syncwarp();
          thr = bv[k - 1];
        }
      }
    }
  }
  __syncthreads();
  if (tid < RB && r0 + tid < n)
    thresh[(size_t)b * n + r0 + tid] = lv[tid * KMAX + k - 1];
}

// Phase 2: max / sum / sum of squares of a[j, :] over d(i, j) <= T_i, and
// the count. a is (B, N, 32 * CJ).
template <int CJ>
__global__ void __launch_bounds__(THREADS)
reduce_kernel(const float* __restrict__ geom, const float* __restrict__ a,
              const float* __restrict__ thresh, int n, int d, int metric,
              float w, float* __restrict__ mx_out, float* __restrict__ sm_out,
              float* __restrict__ sq_out, float* __restrict__ cnt_out) {
  constexpr int C = 32 * CJ;
  constexpr int RW = RB / 8;  // rows per warp
  extern __shared__ float smem[];
  const Tiles t = carve(smem, d);
  float* tr = t.rest;  // RB thresholds

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * RB;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* gb = geom + (size_t)b * n * d;
  const float* ab = a + (size_t)b * n * C;

  if (tid < RB) tr[tid] = r0 + tid < n ? thresh[(size_t)b * n + r0 + tid] : -CUDART_INF_F;
  load_queries(t, gb, r0, n, d, metric);

  float mx[RW][CJ], sm[RW][CJ], sq[RW][CJ];
  int cnt[RW];
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    cnt[rr] = 0;
#pragma unroll
    for (int u = 0; u < CJ; ++u) {
      mx[rr][u] = -CUDART_INF_F;
      sm[rr][u] = 0.f;
      sq[rr][u] = 0.f;
    }
  }

  for (int c0 = 0; c0 < n; c0 += CB) {
    distance_tile(t, gb, c0, n, d, metric, w);
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const int r = warp * RW + rr;
      const float thr = tr[r];  // -inf past n: no hits
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        unsigned mask =
            __ballot_sync(0xffffffffu, t.dt[r * DS + lane + 32 * half] <= thr);
        cnt[rr] += __popc(mask);
        while (mask) {
          const int j = c0 + 32 * half + __ffs(mask) - 1;
          mask &= mask - 1;
          const float* row = ab + (size_t)j * C + lane;
#pragma unroll
          for (int u = 0; u < CJ; ++u) {
            const float v = row[32 * u];
            mx[rr][u] = fmaxf(mx[rr][u], v);
            sm[rr][u] = sm[rr][u] + v;
            sq[rr][u] = sq[rr][u] + v * v;
          }
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int row = r0 + warp * RW + rr;
    if (row >= n) continue;
    const size_t o = ((size_t)b * n + row) * C + lane;
#pragma unroll
    for (int u = 0; u < CJ; ++u) {
      mx_out[o + 32 * u] = mx[rr][u];
      sm_out[o + 32 * u] = sm[rr][u];
      sq_out[o + 32 * u] = sq[rr][u];
    }
    if (lane == 0) cnt_out[(size_t)b * n + row] = (float)cnt[rr];
  }
}

template <int CJ>
int launch_reduce(const float* geom, const float* a, const float* thresh,
                  int batch, int n, int d, int metric, float w, float* mx,
                  float* sm, float* sq, float* cnt, cudaStream_t stream) {
  const int bytes = (common_floats(d) + RB) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      reduce_kernel<CJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + RB - 1) / RB, batch);
  reduce_kernel<CJ><<<grid, THREADS, bytes, stream>>>(
      geom, a, thresh, n, d, metric, w, mx, sm, sq, cnt);
  return (int)cudaGetLastError();
}

}  // namespace

// geom: (B, N, D) float32, D <= 256 (>= 6 for points_normals); a: (B, N, C)
// float32 with C a multiple of 32 up to 256; metric 0 = sqdist,
// 1 = points_normals; 1 <= k <= min(128, N). thresh: (B, N) float32 scratch
// (phase 1's output); mx, sm, sq: (B, N, C) float32; cnt: (B, N) float32.
// Two launches on `stream`, no synchronisation.
extern "C" int sednet_fused_edge_reductions(const void* geom, const void* a,
                                            int batch, int n, int d, int c,
                                            int k, int metric, float w,
                                            void* thresh, void* mx, void* sm,
                                            void* sq, void* cnt,
                                            void* stream) {
  if (k < 1 || k > KMAX || k > n || c % 32 != 0 || c < 32 ||
      c > 32 * CJ_MAX || d < 1 || d > 256 || (metric == 1 && d < 6))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* g = (const float*)geom;
  const float* af = (const float*)a;
  float* tf = (float*)thresh;

  const int bytes1 = (common_floats(d) + RB * KMAX) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      threshold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes1);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + RB - 1) / RB, batch);
  threshold_kernel<<<grid, THREADS, bytes1, st>>>(g, n, d, k, metric, w, tf);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  float* o[4] = {(float*)mx, (float*)sm, (float*)sq, (float*)cnt};
  switch (c / 32) {
    case 1: return launch_reduce<1>(g, af, tf, batch, n, d, metric, w, o[0], o[1], o[2], o[3], st);
    case 2: return launch_reduce<2>(g, af, tf, batch, n, d, metric, w, o[0], o[1], o[2], o[3], st);
    case 3: return launch_reduce<3>(g, af, tf, batch, n, d, metric, w, o[0], o[1], o[2], o[3], st);
    case 4: return launch_reduce<4>(g, af, tf, batch, n, d, metric, w, o[0], o[1], o[2], o[3], st);
    case 5: return launch_reduce<5>(g, af, tf, batch, n, d, metric, w, o[0], o[1], o[2], o[3], st);
    case 6: return launch_reduce<6>(g, af, tf, batch, n, d, metric, w, o[0], o[1], o[2], o[3], st);
    case 7: return launch_reduce<7>(g, af, tf, batch, n, d, metric, w, o[0], o[1], o[2], o[3], st);
    case 8: return launch_reduce<8>(g, af, tf, batch, n, d, metric, w, o[0], o[1], o[2], o[3], st);
    default: return (int)cudaErrorInvalidValue;
  }
}
