// One gaussian mean-shift step on the unit sphere, for a batch of shapes.
//
// Replaces the TPU kernels `_ms_kernel` (mean_shift_step_pallas) and
// `_ms_kernel_batched` (mean_shift_step_pallas_batched) of
// sednet_tpu/ops/pallas_kernels.py. For every shape b and query row i:
//
//   k[i, c]  = exp(max((q_i . x_c - 1) * inv_b2[b], -75))     (c < n)
//   out[i]   = rownorm(sum_c k[i, c] x_c / max(sum_c k[i, c], 1e-30))
//
// with the row norm taken as sqrt(max(|v|^2, 1e-24)).
//
// Bound on the H100: operations. Per call it does 4*B*N*N*E flops (two
// products of N x N x E) and B*N*N exponentials on the float32 CUDA cores,
// while it reads only 2*B*N*E floats: at N=10000, E=128 that is 5.1e10 flops
// per shape against 10 MB of traffic, far above the card's ridge point.
//
// Design: flash-attention-like streaming. A block owns 64 query rows of one
// shape and keeps them in shared memory; it walks the 64-column tiles of x,
// forms the 64x64 similarity tile in registers (each of 256 threads holds a
// 4x4 piece), turns it into kernel weights, stages them in shared memory and
// accumulates num (64 x E, 4 * E / 16 values per thread) and den in
// registers. The kernel is a template on the row width E, a multiple of 32
// up to 256 (the wrapper zero-pads: the HPNet-enriched embedding is 140-d
// and runs at E = 160), so each width keeps its loops unrolled.
// The N x N matrix never reaches device memory. Shared-memory rows are
// padded to an odd stride so that the 16 column-threads of a half warp hit
// 16 different banks. Everything stays float32 (no TF32), as the reference's
// HIGHEST-precision matmuls do.
#include <cuda_runtime.h>

namespace {

constexpr int RB = 64;        // query rows per block
constexpr int CB = 64;        // columns per tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int KS = CB + 1;    // padded row stride of the weight tile

template <int E>
constexpr int smem_bytes() {
  return (RB * (E + 1) + CB * (E + 1) + RB * KS) * 4;
}

template <int E>
__global__ void __launch_bounds__(THREADS)
ms_step_kernel(const float* __restrict__ q, const float* __restrict__ x,
               const float* __restrict__ inv_b2, int n,
               float* __restrict__ out) {
  constexpr int QS = E + 1;     // padded row stride of the q and x tiles
  constexpr int EJ = E / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;               // RB x QS
  float* xs = qs + RB * QS;       // CB x QS
  float* ks = xs + CB * QS;       // RB x KS

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * RB;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t base = (size_t)b * n * E;
  const float ib2 = inv_b2[b];

  for (int i = tid; i < RB * E; i += THREADS) {
    const int r = i / E, e = i % E;
    const int gr = r0 + r;
    qs[r * QS + e] = gr < n ? q[base + (size_t)gr * E + e] : 0.f;
  }

  // thread (ty, tx) owns rows ty + 16*i and columns tx + 16*j
  float num[4][EJ];
  float den[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    den[i] = 0.f;
#pragma unroll
    for (int j = 0; j < EJ; ++j) num[i][j] = 0.f;
  }

  for (int c0 = 0; c0 < n; c0 += CB) {
    __syncthreads();  // the previous tile's xs and ks are no longer read
    for (int i = tid; i < CB * E; i += THREADS) {
      const int c = i / E, e = i % E;
      const int gc = c0 + c;
      xs[c * QS + e] = gc < n ? x[base + (size_t)gc * E + e] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int e = 0; e < E; ++e) {
      float qv[4], xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * QS + e];
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = xs[(tx + 16 * j) * QS + e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], xv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float kv =
            c0 + c < n ? expf(fmaxf((s[i][j] - 1.f) * ib2, -75.f)) : 0.f;
        ks[(ty + 16 * i) * KS + c] = kv;
        den[i] += kv;
      }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < CB; ++c) {
      float kv[4], xv[EJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) kv[i] = ks[(ty + 16 * i) * KS + c];
#pragma unroll
      for (int j = 0; j < EJ; ++j) xv[j] = xs[c * QS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < EJ; ++j) num[i][j] = fmaf(kv[i], xv[j], num[i][j]);
    }
  }

  // epilogue: the 16 threads of a row are 16 consecutive lanes of one warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float d = den[i];
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1)
      d += __shfl_xor_sync(0xffffffffu, d, off);
    d = fmaxf(d, 1e-30f);
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < EJ; ++j) {
      num[i][j] = num[i][j] / d;
      ss = fmaf(num[i][j], num[i][j], ss);
    }
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float nrm = sqrtf(fmaxf(ss, 1e-24f));
    const int gr = r0 + ty + 16 * i;
    if (gr < n) {
#pragma unroll
      for (int j = 0; j < EJ; ++j)
        out[base + (size_t)gr * E + tx + 16 * j] = num[i][j] / nrm;
    }
  }
}

template <int E>
int launch(const float* q, const float* x, const float* inv_b2, int batch,
           int n, float* out, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ms_step_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<E>());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + RB - 1) / RB, batch);
  ms_step_kernel<E><<<grid, THREADS, smem_bytes<E>(), stream>>>(
      q, x, inv_b2, n, out);
  return (int)cudaGetLastError();
}

}  // namespace

// q, x, out: (B, N, E) float32 contiguous, E a multiple of 32 up to 256;
// inv_b2: (B,) float32.
extern "C" int sednet_mean_shift_step(const void* q, const void* x,
                                      const void* inv_b2, int batch, int n,
                                      int e, void* out, void* stream) {
  const float* qf = (const float*)q;
  const float* xf = (const float*)x;
  const float* bf = (const float*)inv_b2;
  float* of = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (e) {
    case 32: return launch<32>(qf, xf, bf, batch, n, of, st);
    case 64: return launch<64>(qf, xf, bf, batch, n, of, st);
    case 96: return launch<96>(qf, xf, bf, batch, n, of, st);
    case 128: return launch<128>(qf, xf, bf, batch, n, of, st);
    case 160: return launch<160>(qf, xf, bf, batch, n, of, st);
    case 192: return launch<192>(qf, xf, bf, batch, n, of, st);
    case 224: return launch<224>(qf, xf, bf, batch, n, of, st);
    case 256: return launch<256>(qf, xf, bf, batch, n, of, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
