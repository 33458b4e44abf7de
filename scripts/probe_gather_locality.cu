// Probe of designs for K6's loop (the gather-reduce of the factored edge
// convolution) along a row order, built and timed by
// scripts/bench_gather.py. Not part of the package.
//
//   design 0 ("l1"): the first design's loop (one warp a row, C / 32
//     channels a lane, four neighbours unrolled) at W warps a block and
//     runs of `run` positions of the order, with L1 given the SM's whole
//     on-chip memory (carveout 0) or the default split (carveout -1).
//   design 1 ("staged"): a block stages the distinct neighbour rows of its
//     run in shared memory once (a bitmap of the shape's N rows marks them,
//     a scan numbers them, cp.async copies up to `cap` of them; the rest
//     are read from global memory), then runs design 0's loop on them.
//   design 3 ("group"): the package's loop (sednet_tpu_torch/csrc/
//     gather_rows.cuh: C / 4 lanes a row at C = 64 and 128, a float4 each,
//     32-bit neighbour indices, rows loaded ahead) at W warps a block and
//     runs of `run` positions.
//
// All compute every row as the package does (its K indices in ascending
// order, one owner a channel, no atomics), so their outputs are the same
// bits.
#include <cuda_runtime.h>

#include "../sednet_tpu_torch/csrc/gather_rows.cuh"

namespace {

using gather_rows::FULL;

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src)
               : "memory");
}

template <int CJ>
__device__ __forceinline__ void load_any(const float* p, float (&v)[CJ]) {
  if constexpr (CJ % 4 == 0) {
#pragma unroll
    for (int u = 0; u < CJ / 4; ++u) {
      const float4 t = reinterpret_cast<const float4*>(p)[u];
      v[4 * u] = t.x; v[4 * u + 1] = t.y; v[4 * u + 2] = t.z; v[4 * u + 3] = t.w;
    }
  } else if constexpr (CJ % 2 == 0) {
#pragma unroll
    for (int u = 0; u < CJ / 2; ++u) {
      const float2 t = reinterpret_cast<const float2*>(p)[u];
      v[2 * u] = t.x; v[2 * u + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int u = 0; u < CJ; ++u) v[u] = p[u];
  }
}

constexpr int KSLOTS = gather_rows::KMAX / 32;  // indices a lane, a row a warp

// Design 0: one warp a row, CJ = C / 32 channels a lane.
template <int CJ, int W>
__global__ void __launch_bounds__(32 * W)
old_kernel(const float* __restrict__ a, const long long* __restrict__ idx,
           const int* __restrict__ order, int n, int runs, int run, int k,
           float* __restrict__ s_out, float* __restrict__ sq_out,
           float* __restrict__ mx_out) {
  constexpr int C = 32 * CJ;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x / runs;
  const int p0 = (blockIdx.x - b * runs) * run, p1 = min(p0 + run, n);
  const long long rb = (long long)b * n;
  const float* table = a + rb * C + lane * CJ;
  for (int p = p0 + (threadIdx.x >> 5); p < p1; p += W) {
    int i = order ? order[rb + p] : p;
    i = i < 0 ? 0 : (i >= n ? n - 1 : i);
    const long long row = rb + i;
    const long long* ir = idx + row * k;
    long long mine[KSLOTS];
#pragma unroll
    for (int t = 0; t < KSLOTS; ++t) {
      const int kk = 32 * t + lane;
      const long long j = kk < k ? ir[kk] : 0;
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
      const int count = min(32, k - 32 * t);
#pragma unroll 4
      for (int src = 0; src < count; ++src) {
        const long long j = __shfl_sync(FULL, mine[t], src);
        float v[CJ];
        gather_rows::load_vec<CJ>(table + j * C, v);
#pragma unroll
        for (int u = 0; u < CJ; ++u) {
          s[u] = s[u] + v[u];
          sq[u] = sq[u] + v[u] * v[u];
          mx[u] = fmaxf(mx[u], v[u]);
        }
      }
    }
    const long long o = row * C + lane * CJ;
    gather_rows::store_vec<CJ>(s_out + o, s);
    gather_rows::store_vec<CJ>(sq_out + o, sq);
    gather_rows::store_vec<CJ>(mx_out + o, mx);
  }
}

template <int CJ, int W>
__global__ void __launch_bounds__(32 * W)
staged_kernel(const float* __restrict__ a, const long long* __restrict__ idx,
              const int* __restrict__ order, int n, int runs, int run, int k,
              int cap, float* __restrict__ s_out, float* __restrict__ sq_out,
              float* __restrict__ mx_out) {
  constexpr int C = 32 * CJ, T = 32 * W;
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);                 // cap x C
  const int nw = (n + 31) >> 5;
  unsigned* bm = reinterpret_cast<unsigned*>(stage + (size_t)cap * C);
  int* base = reinterpret_cast<int*>(bm + nw);                    // nw
  int* uniq = base + nw;                                          // cap
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x / runs;
  const int p0 = (blockIdx.x - b * runs) * run, p1 = min(p0 + run, n);
  const long long rb = (long long)b * n;
  const float* table = a + rb * C;
  auto row_at = [&](int p) {
    int i = order ? order[rb + p] : p;
    return i < 0 ? 0 : (i >= n ? n - 1 : i);
  };
  auto clampj = [&](long long j) {
    return (int)(j < 0 ? 0 : (j >= n ? n - 1 : j));
  };

  for (int w = t; w < nw; w += T) bm[w] = 0u;
  __syncthreads();
  const int total = (p1 - p0) * k;
  for (int x = t; x < total; x += T) {
    const int q = x / k;
    const int j = clampj(idx[(rb + row_at(p0 + q)) * k + (x - q * k)]);
    atomicOr(&bm[j >> 5], 1u << (j & 31));
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the words' bit counts
    const int per = (nw + 31) / 32;
    const int w0 = min(lane * per, nw), w1 = min(w0 + per, nw);
    int local = 0;
    for (int w = w0; w < w1; ++w) local += __popc(bm[w]);
    int incl = local;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += y;
    }
    int acc = incl - local;
    for (int w = w0; w < w1; ++w) {
      base[w] = acc;
      acc += __popc(bm[w]);
    }
  }
  __syncthreads();
  for (int w = t; w < nw; w += T) {
    int u = base[w];
    for (unsigned bits = bm[w]; bits && u < cap; bits &= bits - 1, ++u)
      uniq[u] = 32 * w + __ffs(bits) - 1;
  }
  __syncthreads();
  const int nu = min(cap, base[nw - 1] + __popc(bm[nw - 1]));
  constexpr int Q = C / 4;
  for (int x = t; x < nu * Q; x += T) {
    const int u = x / Q, q = x - u * Q;
    cp16(stage + (size_t)u * C + 4 * q, table + (long long)uniq[u] * C + 4 * q);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  for (int p = p0 + warp; p < p1; p += W) {
    const long long row = rb + row_at(p);
    const long long* ir = idx + row * k;
    int mine[KSLOTS];
#pragma unroll
    for (int s = 0; s < KSLOTS; ++s) {
      const int kk = 32 * s + lane;
      const int j = clampj(kk < k ? ir[kk] : 0);
      const int slot = base[j >> 5] + __popc(bm[j >> 5] & ((1u << (j & 31)) - 1u));
      mine[s] = slot < cap ? slot : cap + j;  // staged slot, or cap + row
    }
    float s[CJ], sq[CJ], mx[CJ];
#pragma unroll
    for (int u = 0; u < CJ; ++u) {
      s[u] = 0.0f;
      sq[u] = 0.0f;
      mx[u] = -CUDART_INF_F;
    }
#pragma unroll
    for (int ts = 0; ts < KSLOTS; ++ts) {
      const int count = min(32, k - 32 * ts);
#pragma unroll 4
      for (int src = 0; src < count; ++src) {
        const int x = __shfl_sync(FULL, mine[ts], src);
        const float* ptr = x < cap ? stage + (size_t)x * C
                                   : table + (long long)(x - cap) * C;
        float v[CJ];
        load_any<CJ>(ptr + lane * CJ, v);
#pragma unroll
        for (int u = 0; u < CJ; ++u) {
          s[u] = s[u] + v[u];
          sq[u] = sq[u] + v[u] * v[u];
          mx[u] = fmaxf(mx[u], v[u]);
        }
      }
    }
    const long long o = row * C + lane * CJ;
    gather_rows::store_vec<CJ>(s_out + o, s);
    gather_rows::store_vec<CJ>(sq_out + o, sq);
    gather_rows::store_vec<CJ>(mx_out + o, mx);
  }
}

template <int CJ, int W>
int run_group(const float* a, const long long* idx, const int* order,
              int batch, int n, int k, int run, float* s, float* sq,
              float* mx, cudaStream_t st) {
  // C = 32 CJ = 4 G: a float4 a lane
  return gather_rows::launch_width<8 * CJ, 4, long long, W>(
      a, idx, order, batch, n, k, run, s, sq, mx, nullptr, st);
}

template <int CJ, int W>
int run_l1(const float* a, const long long* idx, const int* order, int batch,
           int n, int k, int run, int carveout, float* s, float* sq,
           float* mx, cudaStream_t st) {
  auto kern = old_kernel<CJ, W>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout,
      carveout < 0 ? (int)cudaSharedmemCarveoutDefault : carveout);
  if (e != cudaSuccess) return (int)e;
  const int runs = (n + run - 1) / run;
  kern<<<batch * runs, 32 * W, 0, st>>>(a, idx, order, n, runs, run, k, s, sq,
                                        mx);
  return (int)cudaGetLastError();
}

template <int CJ, int W>
int run_staged(const float* a, const long long* idx, const int* order,
               int batch, int n, int k, int run, int cap, float* s, float* sq,
               float* mx, cudaStream_t st) {
  auto kern = staged_kernel<CJ, W>;
  const int nw = (n + 31) / 32;
  const size_t bytes = (size_t)cap * 32 * CJ * 4 + (size_t)nw * 8 + cap * 4;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const int runs = (n + run - 1) / run;
  kern<<<batch * runs, 32 * W, bytes, st>>>(a, idx, order, n, runs, run, k,
                                            cap, s, sq, mx);
  return (int)cudaGetLastError();
}

template <int CJ>
int dispatch(int design, int warps, const float* a, const long long* idx,
             const int* order, int batch, int n, int k, int run, int param,
             float* s, float* sq, float* mx, cudaStream_t st) {
#define PROBE_W(W)                                                          \
  case W:                                                                   \
    return design == 0                                                      \
               ? run_l1<CJ, W>(a, idx, order, batch, n, k, run, param, s,   \
                               sq, mx, st)                                  \
           : design == 1                                                    \
               ? run_staged<CJ, W>(a, idx, order, batch, n, k, run, param,  \
                                   s, sq, mx, st)                           \
               : run_group<CJ, W>(a, idx, order, batch, n, k, run, s, sq,   \
                                  mx, st);
  switch (warps) {
    PROBE_W(4)
    PROBE_W(8)
    PROBE_W(16)
    PROBE_W(32)
    default: return (int)cudaErrorInvalidValue;
  }
#undef PROBE_W
}

}  // namespace

// design 0: param = carveout (-1 default, 0 most L1); design 1: param = cap
// (staged rows); design 3: the package's loop (param unused).
// C 64 or 128; warps 4, 8, 16 or 32.
extern "C" int probe_gather(int design, int warps, const void* a,
                            const void* idx, const void* order, int batch,
                            int n, int c, int k, int run, int param, void* s,
                            void* sq, void* mx, void* stream) {
  const auto st = (cudaStream_t)stream;
  const auto* ap = (const float*)a;
  const auto* ip = (const long long*)idx;
  const auto* op = (const int*)order;
  float *sp = (float*)s, *sqp = (float*)sq, *mp = (float*)mx;
  if (c == 64)
    return dispatch<2>(design, warps, ap, ip, op, batch, n, k, run, param, sp,
                       sqp, mp, st);
  if (c == 128)
    return dispatch<4>(design, warps, ap, ip, op, batch, n, k, run, param, sp,
                       sqp, mp, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* probe_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
