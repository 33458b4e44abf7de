// NMS column-max: for every row r of rows (R, E) against cols (C, E),
//
//   sim[r, c]    = rows[r] . cols[c]
//   scored[r, c] = gain * sim + bias[c]   if 2 - 2*sim < thresh, else -inf
//   best[r]      = max_c scored[r, c],  idx[r] = the lowest c attaining it
//
// A row that is -inf everywhere keeps (-inf, 0).
//
// Replaces the TPU kernel `_colmax_kernel` (colmax_pallas) of
// sednet_tpu/ops/pallas_kernels.py, which serves the three passes of
// sednet_tpu/cluster/mean_shift.py:nms.
//
// Bound on the H100: operations. 2*R*C*E flops on the float32 CUDA cores
// (2.56e10 at R = C = 10000, E = 128) against (R + C)*E*4 bytes read.
//
// Design: one block owns 64 rows and loops over every 64-column tile itself,
// so no reduction crosses blocks. Each of 256 threads scores a 4x4 piece of
// the tile and keeps a running (best, idx) per row over its own columns,
// which it visits in ascending order; the 16 threads of a row then merge
// with warp shuffles. Both merges take a new value when
// `val > best || (val == best && c < idx)`, the lowest-index rule of the
// TPU kernel's first argmax.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int E = 128;
constexpr int RB = 64;
constexpr int CB = 64;
constexpr int THREADS = 256;
constexpr int QS = E + 1;

constexpr int SMEM_BYTES = (RB * QS + CB * QS + CB) * 4;

__device__ __forceinline__ void take_better(float v, int c, float& best,
                                            int& idx) {
  if (v > best || (v == best && c < idx)) {
    best = v;
    idx = c;
  }
}

__global__ void __launch_bounds__(THREADS)
colmax_kernel(const float* __restrict__ rows, const float* __restrict__ cols,
              const float* __restrict__ bias, int nr, int nc, float thresh,
              float gain, float* __restrict__ best_out,
              int* __restrict__ idx_out) {
  extern __shared__ float smem[];
  float* rs = smem;              // RB x QS
  float* cs = rs + RB * QS;      // CB x QS
  float* bs = cs + CB * QS;      // CB

  const int r0 = blockIdx.x * RB;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  for (int i = tid; i < RB * E; i += THREADS) {
    const int r = i / E, e = i % E;
    const int gr = r0 + r;
    rs[r * QS + e] = gr < nr ? rows[(size_t)gr * E + e] : 0.f;
  }

  float best[4];
  int idx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best[i] = -CUDART_INF_F;
    idx[i] = 0;
  }

  for (int c0 = 0; c0 < nc; c0 += CB) {
    __syncthreads();
    for (int i = tid; i < CB * E; i += THREADS) {
      const int c = i / E, e = i % E;
      const int gc = c0 + c;
      cs[c * QS + e] = gc < nc ? cols[(size_t)gc * E + e] : 0.f;
    }
    if (tid < CB) bs[tid] = c0 + tid < nc ? bias[c0 + tid] : -CUDART_INF_F;
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int e = 0; e < E; ++e) {
      float rv[4], cv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) rv[i] = rs[(ty + 16 * i) * QS + e];
#pragma unroll
      for (int j = 0; j < 4; ++j) cv[j] = cs[(tx + 16 * j) * QS + e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(rv[i], cv[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // ascending column order per thread
      const int c = c0 + tx + 16 * j;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float sim = s[i][j];
        const float v = (c < nc && 2.f - 2.f * sim < thresh)
                            ? gain * sim + bs[tx + 16 * j]
                            : -CUDART_INF_F;
        take_better(v, c, best[i], idx[i]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, idx[i], off);
      take_better(ov, oi, best[i], idx[i]);
    }
    const int gr = r0 + ty + 16 * i;
    if (tx == 0 && gr < nr) {
      best_out[gr] = best[i];
      idx_out[gr] = idx[i];
    }
  }
}

}  // namespace

// rows: (R, 128), cols: (C, 128), bias: (C,) float32 contiguous;
// best: (R,) float32, idx: (R,) int32.
extern "C" int sednet_colmax(const void* rows, const void* cols,
                             const void* bias, int nr, int nc, float thresh,
                             float gain, void* best, void* idx, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      colmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nr + RB - 1) / RB);
  colmax_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const float*)rows, (const float*)cols, (const float*)bias, nr, nc,
      thresh, gain, (float*)best, (int*)idx);
  return (int)cudaGetLastError();
}
