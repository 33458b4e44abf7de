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
// Bound on the H100: operations. 2*R*C*E flops, run on the tensor cores by
// the three-term TF32 split of sim_tile.cuh (three TF32 products for each
// f32 one): 6*R*C*E flops over the dense TF32 peak of 495 TFLOP/s, 0.155 ms
// at R = C = 10000, E = 128 (0.17 at E = 140), against (R + C)*E*4 bytes
// read. The f32 CUDA cores' 67 TFLOP/s would allow no less than 0.39 ms.
//
// Design: a cluster of SPLIT = 4 blocks owns 64 rows; each block keeps them
// in shared memory and walks a quarter of the 32-column tiles (part,
// part + 4, ...), loaded by cp.async into two stages with the tile's bias
// (-inf past C). Each of 4 warps forms the 16 x 32 similarity
// tile of its 16 rows with mma.sync (both operands K-major, see
// sim_tile.cuh; the one product needs no transposed copy, so the same
// route as the mean-shift step's), scores it in registers, and keeps a
// running (best, idx) for each of its two rows over its own columns. Every
// merge, in a thread, across the 4 threads of a row (warp shuffles) and
// across the 4 blocks of a cluster (distributed shared memory, each block
// finishing 16 rows), takes a new value when
// `val > best || (val == best && c < idx)`: the result is the lowest index
// among the maxima whatever the order, the rule of the TPU kernel's first
// argmax. The kernel is a template on the row width E, a multiple of 32 up
// to 256 (the wrapper zero-pads narrower or odd widths). rows and cols
// must be 16-byte aligned, as every contiguous tensor from torch's
// allocator is.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "sim_tile.cuh"

namespace {

using namespace sim_tile;

template <int E>
constexpr int smem_bytes() {
  return ((RB + STAGES * CB) * stride<E>() + STAGES * CB + 2 * RB) * 4;
}

__device__ __forceinline__ void take_better(float v, int c, float& best,
                                            int& idx) {
  if (v > best || (v == best && c < idx)) {
    best = v;
    idx = c;
  }
}

template <int E>
__device__ __forceinline__ void load_stage(float* cs, float* bs,
                                           const float* cols,
                                           const float* bias, int c0,
                                           int nc) {
  load_rows<E>(cs, cols, c0, CB, nc);
  if (threadIdx.x < CB) {
    const int c = c0 + threadIdx.x;
    bs[threadIdx.x] = c < nc ? bias[c] : -CUDART_INF_F;
  }
}

template <int E>
__global__ void __cluster_dims__(SPLIT, 1, 1) __launch_bounds__(THREADS)
colmax_kernel(const float* __restrict__ rows, const float* __restrict__ cols,
              const float* __restrict__ bias, int nr, int nc, float thresh,
              float gain, float* __restrict__ best_out,
              int* __restrict__ idx_out) {
  constexpr int S = stride<E>();
  extern __shared__ __align__(16) float smem[];
  float* rs = smem;                          // RB x S
  float* cs = rs + RB * S;                   // STAGES x CB x S
  float* bs = cs + STAGES * CB * S;          // STAGES x CB
  float* pbest = bs + STAGES * CB;           // RB partial maxima
  int* pidx = reinterpret_cast<int*>(pbest + RB);   // RB their columns

  cg::cluster_group cluster = cg::this_cluster();
  const int part = (int)cluster.block_rank();
  const int r0 = (blockIdx.x / SPLIT) * RB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = (nc + CB - 1) / CB;
  const int mine = tiles > part ? (tiles - part + SPLIT - 1) / SPLIT : 0;

  load_rows<E>(rs, rows, r0, RB, nr);
  cp_async_commit();
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < mine)
      load_stage<E>(cs + s * CB * S, bs + s * CB, cols, bias,
                    (part + s * SPLIT) * CB, nc);
    cp_async_commit();
  }

  // rows g and g + 8 of this warp's 16
  float best[2] = {-CUDART_INF_F, -CUDART_INF_F};
  int idx[2] = {0, 0};
  const float* rw = rs + warp * 16 * S;

#pragma unroll 1
  for (int k = 0; k < mine; ++k) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile k is in; tile k - 1's stage is free
    const int nk = k + STAGES - 1;
    if (nk < mine)
      load_stage<E>(cs + (nk % STAGES) * CB * S, bs + (nk % STAGES) * CB,
                    cols, bias, (part + nk * SPLIT) * CB, nc);
    cp_async_commit();

    const int st = k % STAGES;
    const int c0 = (part + k * SPLIT) * CB;
    float sim[NT][4];
    similarity<E>(rw, cs + st * CB * S, g, t, sim);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int cl = 8 * j + 2 * t + (v & 1);
        const float s = sim[j][v];
        const float val = (c0 + cl < nc && 2.f - 2.f * s < thresh)
                              ? gain * s + bs[st * CB + cl]
                              : -CUDART_INF_F;
        take_better(val, c0 + cl, best[v >> 1], idx[v >> 1]);
      }
  }
  cp_async_wait<0>();
  __syncthreads();   // every copy into this block's shared memory has landed

#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best[h], off);
      const int oi = __shfl_xor_sync(0xffffffffu, idx[h], off);
      take_better(ov, oi, best[h], idx[h]);
    }
  }
  if (t == 0) {
    pbest[warp * 16 + g] = best[0];
    pidx[warp * 16 + g] = idx[0];
    pbest[warp * 16 + g + 8] = best[1];
    pidx[warp * 16 + g + 8] = idx[1];
  }
  cluster.sync();

  if (threadIdx.x < ROWS_OUT) {
    const int lr = part * ROWS_OUT + threadIdx.x;
    float b = -CUDART_INF_F;
    int i = 0;
#pragma unroll
    for (int p = 0; p < SPLIT; ++p)
      take_better(cluster.map_shared_rank(pbest, p)[lr],
                  cluster.map_shared_rank(pidx, p)[lr], b, i);
    if (r0 + lr < nr) {
      best_out[r0 + lr] = b;
      idx_out[r0 + lr] = i;
    }
  }
  cluster.sync();   // no block leaves while another reads its partials
}

template <int E>
int launch(const float* rows, const float* cols, const float* bias, int nr,
           int nc, float thresh, float gain, float* best, int* idx,
           cudaStream_t stream) {
  if (!aligned16(rows) || !aligned16(cols))
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err = cudaFuncSetAttribute(
      colmax_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<E>());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((nr + RB - 1) / RB) * SPLIT);
  colmax_kernel<E><<<grid, THREADS, smem_bytes<E>(), stream>>>(
      rows, cols, bias, nr, nc, thresh, gain, best, idx);
  return (int)cudaGetLastError();
}

}  // namespace

// rows: (R, E), cols: (C, E), bias: (C,) float32 contiguous, E a multiple
// of 32 up to 256; best: (R,) float32, idx: (R,) int32.
extern "C" int sednet_colmax(const void* rows, const void* cols,
                             const void* bias, int nr, int nc, int e,
                             float thresh, float gain, void* best, void* idx,
                             void* stream) {
  const float* r = (const float*)rows;
  const float* c = (const float*)cols;
  const float* b = (const float*)bias;
  float* bo = (float*)best;
  int* io = (int*)idx;
  cudaStream_t st = (cudaStream_t)stream;
  switch (e) {
    case 32: return launch<32>(r, c, b, nr, nc, thresh, gain, bo, io, st);
    case 64: return launch<64>(r, c, b, nr, nc, thresh, gain, bo, io, st);
    case 96: return launch<96>(r, c, b, nr, nc, thresh, gain, bo, io, st);
    case 128: return launch<128>(r, c, b, nr, nc, thresh, gain, bo, io, st);
    case 160: return launch<160>(r, c, b, nr, nc, thresh, gain, bo, io, st);
    case 192: return launch<192>(r, c, b, nr, nc, thresh, gain, bo, io, st);
    case 224: return launch<224>(r, c, b, nr, nc, thresh, gain, bo, io, st);
    case 256: return launch<256>(r, c, b, nr, nc, thresh, gain, bo, io, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
